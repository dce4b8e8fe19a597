"""Models of the port: the paper's Big LSTM (``lstm.py``) and the Model API
of the decoder families (``model.py``; the SSM stack so far)."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
