"""Publication of the final checkpoint to GCS, the twin of
``deepvision_tpu/train/publish.py``: upload a file or a checkpoint
directory (tarred) to ``gs://bucket/output_dir/`` and write the ``gs://``
URI to the handoff file (``$TMPDIR/output.txt`` unless given), the
reference's pipeline handoff. Without ``google-cloud-storage`` it prints
one line and returns None.
"""

from __future__ import annotations

import os
import tarfile
import tempfile
from pathlib import Path

__all__ = ["publish_to_gcs"]


def publish_to_gcs(
    model_path: str | Path,
    bucket_name: str,
    output_dir: str,
    *,
    handoff_file: str | Path | None = None,
) -> str | None:
    """Upload ``model_path`` to ``gs://bucket_name/output_dir/``; returns
    the URI, or None when the GCS client library is not installed."""
    try:
        from google.cloud import storage
    except ImportError:
        print("google-cloud-storage not installed; skipping upload")
        return None

    model_path = Path(model_path)
    with tempfile.TemporaryDirectory() as tmp:
        upload_path = model_path
        if model_path.is_dir():  # checkpoints are directories
            upload_path = Path(tmp) / f"{model_path.name}.tar.gz"
            with tarfile.open(upload_path, "w:gz") as tar:
                tar.add(model_path, arcname=model_path.name)
        client = storage.Client()
        bucket = client.bucket(bucket_name)
        blob_name = os.path.join(output_dir, upload_path.name)
        bucket.blob(blob_name).upload_from_filename(str(upload_path))
    uri = f"gs://{bucket_name}/{blob_name}"
    print(f"Uploaded model to {uri}")
    handoff = (Path(handoff_file) if handoff_file is not None
               else Path(tempfile.gettempdir()) / "output.txt")
    handoff.write_text(uri + "\n")
    return uri
