"""The paper's Big LSTM."""
