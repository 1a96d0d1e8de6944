"""The port's copy of the serving fields of ``train/configs.py``.

Only the entries this slice serves, and only the fields serving reads:
``input_size``, ``channels``, ``num_classes`` and ``augment`` (the pixel
convention the model was trained with: ``"pt"`` is torch-style
normalisation, ``"tf"`` Inception-style). The JAX table has no
``alexnet2_tf`` entry; its lookups fall back to the defaults written out
here.
"""

from __future__ import annotations

__all__ = ["TRAINING_CONFIG", "get_config"]

TRAINING_CONFIG: dict[str, dict] = {
    # ref: deepvision_tpu/train/configs.py "alexnet1"
    "alexnet1": {"input_size": 224, "channels": 3, "num_classes": 1000,
                 "augment": "pt"},
    # ref: deepvision_tpu/train/configs.py "alexnet2"
    "alexnet2": {"input_size": 224, "channels": 3, "num_classes": 1000,
                 "augment": "pt"},
    "alexnet2_tf": {"input_size": 224, "channels": 3, "num_classes": 1000,
                    "augment": "tf"},
}


def get_config(name: str) -> dict:
    try:
        return dict(TRAINING_CONFIG[name])
    except KeyError:
        raise KeyError(
            f"no serving config for {name!r}; known: "
            f"{sorted(TRAINING_CONFIG)}") from None
