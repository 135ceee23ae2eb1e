"""Launchers: ``python -m repro_torch.launch.train`` (the training loop
with checkpoints and auto-resume)."""
