"""Serving: load a model, batch requests, answer them.

``python -m deepvision_tpu_torch.serve -m alexnet1`` runs the stdin-JSONL
server, and with ``--http PORT`` the HTTP one (``__main__.py``,
``http.py``); ``--artifact`` serves a ``torch.export`` artifact
(``models.from_exported``) and ``--store`` warms from an artifact store
(``artifact_store.py``). ``--pipelines FILE`` serves DAGs of the models
and glue (``pipeline.py``: detect -> crop -> pose) beside them.
``--fleet N`` puts a router (``router.py``) over N replica processes of
the same CLI (``replica.py``). ``--residency-mb``, ``--tenant-quota`` and
``--slo-class`` share the card among the models (``tenancy.py``: LRU
weight residency over the CUDA graphs, zero-drop hot swap, per-tenant
admission), and ``InferenceEngine.hot_swap`` swaps a model's weights
under load. ``--trace-spool DIR`` spools every process's spans (the
engine's ``device``, ``replica_queue``, ``stage:<node>`` and
``postprocess`` under each request's trace id) and installs the flight
recorder there; ``python -m deepvision_tpu_torch.obs.trace_merge DIR``
merges a fleet's spools into one trace.
"""

from deepvision_tpu_torch.serve.admission import (
    SLO_CLASSES,
    AdmissionController,
    ShedError,
)
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
from deepvision_tpu_torch.serve.tenancy import (
    TenancyManager,
    WeightsEdition,
    fingerprint_variables,
    tree_nbytes,
)

__all__ = ["AdmissionController", "ArtifactStore", "CompileCache",
           "EngineReplica", "FleetRouter", "InferenceEngine", "ModelStage",
           "Pipeline", "PipelineError", "PipelineSpec", "ProcessReplica",
           "ReplicaDeadError", "SLO_CLASSES", "ServedModel", "ShedError",
           "TenancyManager", "WeightsEdition", "fingerprint_variables",
           "from_exported", "load_pipeline_specs", "load_served",
           "tree_nbytes"]
