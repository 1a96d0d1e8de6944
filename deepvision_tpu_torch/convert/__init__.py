"""Weight carriers into the port: the JAX package's flax variables
(``from_flax``), reference PyTorch checkpoints (``torch_import``), Keras
HDF5 files (``keras_import``), digest-checked local files
(``pretrained``), the activation differ (``diff``) and the converter CLI
(``python -m deepvision_tpu_torch.convert``)."""
