"""Training side of the port: configs, the train state and steps, the
optimizer and schedules, checkpoints, the Trainer and its CLI
(``python -m deepvision_tpu_torch.train``)."""
