"""Launchers: ``python -m repro_torch.launch.train`` (the training loop
with checkpoints, auto-resume and the sharded mesh), and the dry runs
``launch.dryrun`` / ``launch.sweep`` / ``launch.report`` (each rank's
state from the rule table, with the card's roofline terms) and
``launch.census_dryrun`` (the census's per-rank work at full size)."""
