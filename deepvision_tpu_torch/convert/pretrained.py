"""Pretrained weights from a local file, checked by its digest, the twin
of ``deepvision_tpu/convert/pretrained.py``.

The reference downloads keras-applications weights and checks a hash;
here the file is local (no network is assumed): its sha256 (or md5) is
checked against the expected digest, then the matching importer reads
it: ``.pt``/``.pth`` through ``convert/torch_import.py``, ``.h5``/
``.hdf5`` through ``convert/keras_import.py``, into the port's state
dict.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

__all__ = ["file_digest", "verify_artifact", "load_pretrained"]


def file_digest(path: str | Path, algorithm: str = "sha256") -> str:
    with open(path, "rb") as fh:
        return hashlib.file_digest(fh, algorithm).hexdigest()


def verify_artifact(path: str | Path, expected_digest: str,
                    algorithm: str = "sha256") -> Path:
    """``path`` if its digest matches ``expected_digest``; raises
    ``ValueError`` otherwise."""
    path = Path(path)
    got = file_digest(path, algorithm)
    if got != expected_digest.lower():
        raise ValueError(f"{path} {algorithm} mismatch: got {got}, "
                         f"expected {expected_digest}")
    return path


def load_pretrained(path: str | Path, *, model: str | None = None,
                    expected_digest: str | None = None,
                    algorithm: str = "sha256", **model_kw) -> dict:
    """A verified pretrained file -> the state dict of the port's
    ``model`` (default ``resnet50`` for a torch file, ``resnet50v2`` for
    an HDF5 one; ``model_kw`` as for ``flax_to_torch``)."""
    path = Path(path)
    if expected_digest is not None:
        verify_artifact(path, expected_digest, algorithm)
    suffix = path.suffix.lower()
    if suffix in (".pt", ".pth"):
        from deepvision_tpu_torch.convert.torch_import import (
            convert_state_dict,
            load_torch_checkpoint,
        )

        return convert_state_dict(model or "resnet50",
                                  load_torch_checkpoint(path), **model_kw)
    if suffix in (".h5", ".hdf5"):
        from deepvision_tpu_torch.convert.keras_import import (
            keras_h5_to_port,
        )

        return keras_h5_to_port(path, model or "resnet50v2", **model_kw)
    raise ValueError(f"unrecognized checkpoint format: {path.name}")
