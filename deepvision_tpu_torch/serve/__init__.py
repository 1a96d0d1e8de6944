"""Serving: load a model, batch requests, answer them.

``python -m deepvision_tpu_torch.serve -m alexnet1`` runs the stdin-JSONL
server, and with ``--http PORT`` the HTTP one (``__main__.py``,
``http.py``).
"""

from deepvision_tpu_torch.serve.admission import ShedError
from deepvision_tpu_torch.serve.compile_cache import CompileCache
from deepvision_tpu_torch.serve.engine import InferenceEngine
from deepvision_tpu_torch.serve.models import ServedModel, load_served

__all__ = ["CompileCache", "InferenceEngine", "ServedModel", "ShedError",
           "load_served"]
