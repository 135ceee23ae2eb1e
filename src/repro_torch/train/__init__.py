"""Training: AdamW, the train step, checkpoints, elasticity helpers.

Counterpart of :mod:`repro.train`, on one card or sharded on a device
mesh (DTensor parameters placed by :mod:`repro_torch.sharding.rules`).
Parameters are the module's own, updated in place; gradients and Adam
moments are dicts keyed by the module's parameter names, mapped to the
JAX package's keys and layouts by
:func:`repro_torch.models.convert.to_jax_params` (checkpoints) and
:func:`repro_torch.models.convert.jax_key_of` (the decay mask).
"""
from .checkpoint import CheckpointManager, restore_train_state, train_state
from .optimizer import OptState, adamw_init, adamw_update
from .train_step import make_grad_fn, make_loss_fn, make_train_step

__all__ = ["CheckpointManager", "OptState", "adamw_init", "adamw_update",
           "make_grad_fn", "make_loss_fn", "make_train_step",
           "restore_train_state", "train_state"]
