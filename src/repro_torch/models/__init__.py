"""Models of the port: the paper's Big LSTM (``lstm.py``), the decoder
stacks (``transformer.py``: SSM and dense attention layers) and the Model
API over them (``model.py``)."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
