"""Serving: load a model, batch requests, answer them.

``python -m deepvision_tpu_torch.serve -m alexnet1`` runs the stdin-JSONL
server, and with ``--http PORT`` the HTTP one (``__main__.py``,
``http.py``); ``--artifact`` serves a ``torch.export`` artifact
(``models.from_exported``) and ``--store`` warms from an artifact store
(``artifact_store.py``). ``--pipelines FILE`` serves DAGs of the models
and glue (``pipeline.py``: detect -> crop -> pose) beside them.
``--fleet N`` puts a router (``router.py``) over N replica processes of
the same CLI (``replica.py``).
"""

from deepvision_tpu_torch.serve.admission import ShedError
from deepvision_tpu_torch.serve.artifact_store import ArtifactStore
from deepvision_tpu_torch.serve.compile_cache import CompileCache
from deepvision_tpu_torch.serve.engine import InferenceEngine
from deepvision_tpu_torch.serve.models import (
    ServedModel,
    from_exported,
    load_served,
)
from deepvision_tpu_torch.serve.pipeline import (
    ModelStage,
    Pipeline,
    PipelineError,
    PipelineSpec,
    load_pipeline_specs,
)
from deepvision_tpu_torch.serve.replica import (
    EngineReplica,
    ProcessReplica,
    ReplicaDeadError,
)
from deepvision_tpu_torch.serve.router import FleetRouter

__all__ = ["ArtifactStore", "CompileCache", "EngineReplica", "FleetRouter",
           "InferenceEngine", "ModelStage", "Pipeline", "PipelineError",
           "PipelineSpec", "ProcessReplica", "ReplicaDeadError",
           "ServedModel", "ShedError", "from_exported", "load_pipeline_specs",
           "load_served"]
