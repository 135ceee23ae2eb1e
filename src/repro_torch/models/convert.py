"""Build the port's :class:`~repro_torch.models.transformer.Transformer` from
a flat parameter dict with the JAX package's keys and shapes, and map the
module's parameters (or any tree keyed like them: gradients, Adam moments)
back to those keys and layouts (:func:`to_jax_params`, :func:`jax_key_of`,
:func:`from_jax_tree`)."""
from __future__ import annotations

import re
from typing import Mapping, Optional

import numpy as np
import torch

from ..config.base import ModelConfig, RunConfig
from ..core.graph import resolve_device
from ..sharding.rules import from_whole, is_dtensor, make_rules, placements
from .params import iter_init_params
from .transformer import Transformer, model_defs


def from_jax_params(cfg: ModelConfig,
                    params: "Mapping[str, np.ndarray | torch.Tensor]", *,
                    run: Optional[RunConfig] = None, device=None,
                    dtype: Optional[torch.dtype] = None,
                    trainable: bool = False, mesh=None,
                    rules=None) -> Transformer:
    """The port's module holding the weights of a JAX-layout flat dict.

    ``params`` has exactly the keys and shapes of ``model_defs(cfg)`` (as
    ``repro.models.transformer.init_model`` returns them, pulled to numpy,
    or as :func:`~repro_torch.models.transformer.init_model` makes them);
    anything else raises.  Each array is converted once to ``device``
    (``None`` means ``"cuda"``) and ``dtype`` (default
    ``run.param_dtype``); a tensor already there is used as it is.  Then:

    * ``embed`` (V, d) -> ``embed.weight`` (V, d), as it is;
    * ``unembed`` (d, V) -> ``unembed.weight`` (V, d), transposed;
    * ``final_ln`` (d,) -> ``final_ln``;
    * every ``layers/<name>`` stack (L, ...) is split along its first dim,
      slice i going to ``layers[i]``; every ``dense{i}/<name>`` leaf goes
      to ``dense[i]`` (deepseek-v2's leading dense block), every
      ``tail{t}/<name>`` leaf to ``tail[t]`` (the hybrid's tail Mamba
      blocks) and every ``shared/<name>`` leaf to ``shared``, the
      hybrid's one attention block (a single module, run at every site):
      - ``ln1``, ``ln2`` (d,) -> ``.ln1``, ``.ln2``; the Mamba blocks'
        ``ln`` -> ``.ln``;
      - 2-D weights (in, out) -> the ``nn.Linear`` of the same path, its
        ``.weight`` (out, in) transposed: ``attn/wq``, ``attn/wk``,
        ``attn/wv``, ``attn/wo``; MLA's ``attn/wq_a``, ``attn/wq_b``,
        ``attn/wkv_a``, ``attn/wk_b``, ``attn/wv_b``, ``attn/wo``;
        ``mlp/w_gate``, ``mlp/w_up``, ``mlp/w_down`` and the shared
        experts' ``moe/shared/w_gate`` ...;
      - ``attn/bq``, ``attn/bk``, ``attn/bv`` (out,) -> ``.attn.wq.bias``,
        ``.wk.bias``, ``.wv.bias``;
      - 1-D norms (``attn/q_norm``, ``attn/k_norm``, MLA's
        ``attn/kv_norm``) as they are;
      - ``moe/router`` (d, E) and the expert stacks ``moe/w_gate``,
        ``moe/w_up`` (E, d, f), ``moe/w_down`` (E, f, d) as they are, in
        the JAX layout;
      - Mamba2 (``layers/ssm/*``, 36 stacked at full width, and
        ``tail{t}/ssm/*``): ``ssm/wx``, ``wz``, ``wB``, ``wC``, ``wdt``,
        ``wo`` -> ``.ssm.<name>`` Linears, transposed; the depthwise conv
        taps ``ssm/conv_x``, ``conv_B``, ``conv_C`` (W, C) as they are
        (parameters in the JAX layout, not Linears, not transposed);
        ``ssm/A_log``, ``D``, ``dt_bias``, ``norm`` as they are;
      - RWKV6's one ``mix/`` table splits by name: the channel-mix's
        ``mix/*_cm`` go to ``.channel_mix`` (``wk_cm``, ``wv_cm``,
        ``wr_cm`` Linears transposed, ``mu_k_cm``, ``mu_r_cm`` as they
        are), the rest to ``.time_mix`` (``wr``, ``wk``, ``wv``, ``wg``,
        ``wo``, the decay LoRA's ``wA`` (d, lora) and ``wB`` (lora, d)
        Linears transposed; ``mu_*``, ``w0``, ``u``, ``ln_x`` as they
        are).

    The splits and transposes are views of the converted arrays: no weight
    is copied a second time (a full-width bf16 model takes its 8.8 GB
    once).  Returns the module in eval mode without gradients.

    ``trainable=True`` instead gives every parameter its own contiguous
    storage (a copy: never a view into a stacked or transposed tensor, nor
    the caller's own tensor, since the optimizer updates parameters in
    place), requiring grad, and returns the module in train mode.

    ``mesh`` (a ``DeviceMesh`` over the process group) places every
    parameter as a DTensor by ``rules`` (default ``make_rules(mesh)``):
    each rank copies its own block of the whole weight it was handed (the
    same on every rank, as a seeded init is) to ``device``, by the
    parameter's logical axes (:func:`param_logical`); the whole weight
    stays where it was handed.  The module's forward then runs under that
    mesh (:class:`~repro_torch.models.transformer.Transformer`).
    :func:`init_module` builds a seeded model so without the whole tree.
    """
    run = run or RunConfig()
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, run.param_dtype)
    defs = model_defs(cfg)
    if set(params) != set(defs):
        raise KeyError(f"params do not match model_defs({cfg.name}): missing "
                       f"{sorted(set(defs) - set(params))}, unexpected "
                       f"{sorted(set(params) - set(defs))}")

    def slices():
        for key in sorted(params):
            val = params[key]
            if tuple(val.shape) != tuple(defs[key].shape):
                raise ValueError(f"{key}: shape {tuple(val.shape)}, want "
                                 f"{defs[key].shape}")
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.array(val))
            # under a mesh each rank moves only its own blocks to ``dev``
            val = val.to(device=None if mesh is not None else dev,
                         dtype=dtype)
            if defs[key].logical[:1] == ("layers",):
                yield from ((key, i, val[i]) for i in range(val.shape[0]))
            else:
                yield key, None, val

    return _assemble(cfg, run, slices(), dev, trainable, mesh, rules)


def init_module(cfg: ModelConfig, generator: torch.Generator, *,
                run: Optional[RunConfig] = None,
                dtype: Optional[torch.dtype] = None, trainable: bool = False,
                mesh=None, rules=None) -> Transformer:
    """``from_jax_params(cfg, init_model(cfg, generator, dtype), ...)``,
    the same weights, without ever holding the whole tree: each slice of
    :func:`~repro_torch.models.params.iter_init_params` (a ``layers/``
    stack one layer at a time) is drawn on ``generator``'s device, taken
    into the module (under ``mesh``, each rank copying only its own block)
    and dropped before the next is drawn.  So a rank holds its own shards
    and one layer's slice of one key at most, whatever the model's size.
    ``dtype`` defaults to ``run.param_dtype``."""
    run = run or RunConfig()
    dtype = dtype or getattr(torch, run.param_dtype)
    return _assemble(cfg, run, iter_init_params(model_defs(cfg), generator,
                                                dtype),
                     generator.device, trainable, mesh, rules)


def _assemble(cfg: ModelConfig, run: RunConfig, slices, device,
              trainable: bool, mesh, rules) -> Transformer:
    """The module from ``(JAX key, stack index or None, tensor)`` slices
    (each slice to the parameter :func:`jax_slot` maps back to it,
    transposed for a Linear weight), every parameter covered once."""
    with torch.device("meta"):
        model = Transformer(cfg, run)
    names = {jax_slot(n)[:2]: n for n, _ in model.named_parameters()}
    if mesh is not None:
        rules = rules or make_rules(mesh)
        logical = param_logical(cfg)
    sd = {}
    for key, idx, val in slices:
        name = names[key, idx]
        val = val.T if jax_slot(name)[2] else val
        if mesh is not None:
            val = from_whole(val, mesh, placements(mesh, rules,
                                                   logical[name]),
                             device=device)
        elif trainable:  # its own storage: the optimizer updates in place
            val = val.clone(memory_format=torch.contiguous_format)
        sd[name] = val
    model.load_state_dict(sd, strict=True, assign=True)
    if mesh is not None:
        model.mesh, model.rules = mesh, rules
    if trainable:
        return model.requires_grad_(True).train()
    return model.requires_grad_(False).eval()


def jax_slot(name: str) -> "tuple[str, Optional[int], bool]":
    """(JAX key, index in its ``layers/`` stack or None, transposed) of the
    module parameter ``name``: the mapping :func:`from_jax_params` and
    :func:`init_module` apply, from the parameter's side."""
    if name in ("embed.weight", "final_ln"):
        return name.split(".")[0], None, False
    if name == "unembed.weight":
        return "unembed", None, True
    parts = name.split(".")
    head, idx = parts[0], None
    if head == "layers":
        idx, rest = int(parts[1]), parts[2:]
    elif head in ("dense", "tail"):
        head, rest = f"{head}{parts[1]}", parts[2:]
    elif head == "shared":
        rest = parts[1:]
    else:
        raise KeyError(f"{name!r} is not a parameter of the port's models")
    transposed = rest[-1] == "weight"
    if transposed:
        rest = rest[:-1]
    elif rest[-1] == "bias":  # attn.wq.bias -> attn/bq
        rest = rest[:-2] + ["b" + rest[-2][1:]]
    if rest[0] in ("time_mix", "channel_mix"):  # RWKV's one mix/ table
        rest[0] = "mix"
    return "/".join([head, *rest]), idx, transposed


def param_logical(cfg: ModelConfig) -> "dict[str, tuple]":
    """The logical axes of every parameter of the port's module for
    ``cfg``, keyed by parameter name: the JAX key's ``ParamDef.logical``
    through :func:`from_jax_params`'s mapping (a ``layers/`` slice drops
    the leading ``"layers"`` axis, a transposed Linear weight reverses
    its two axes).  ``layers/attn/wq`` ``("layers", "embed",
    "heads_flat")`` gives ``layers.{i}.attn.wq.weight`` ``("heads_flat",
    "embed")``."""
    defs = model_defs(cfg)
    with torch.device("meta"):
        names = [n for n, _ in
                 Transformer(cfg, RunConfig()).named_parameters()]
    out = {}
    for name in names:
        key, idx, transposed = jax_slot(name)
        logical = defs[key].logical[1 if idx is not None else 0:]
        out[name] = tuple(reversed(logical)) if transposed else logical
    return out


def jax_key_of(name: str) -> str:
    """The JAX key holding the module parameter ``name`` (for a
    ``layers.{i}.`` parameter, the stacked key it is slice i of):
    ``"layers.3.attn.wq.weight"`` -> ``"layers/attn/wq"``,
    ``"layers.0.time_mix.mu_r"`` -> ``"layers/mix/mu_r"``,
    ``"shared.attn.wq.bias"`` -> ``"shared/attn/bq"``."""
    return jax_slot(name)[0]


def to_jax_params(model: Transformer,
                  tree: "Optional[Mapping[str, torch.Tensor]]" = None, *,
                  device=None, keep: bool = True
                  ) -> "dict[str, torch.Tensor]":
    """The module's parameters, or ``tree`` (keyed by the module's
    parameter names: gradients, Adam moments), as a flat dict with the JAX
    keys and layouts: ``layers/`` slices restacked in order, Linear
    weights transposed back, every value contiguous (a new tensor, off the
    graph).  ``device`` (default: where the values are) is where each
    value is moved before it is restacked: ``"cpu"`` for a checkpoint
    keeps the restacked copy off the card.  On a sharded model each value
    is gathered whole (``full_tensor``, a collective every rank calls),
    one parameter at a time; ``keep=False`` takes part in the gathers and
    keeps nothing (returns ``{}``: a rank that does not write the
    checkpoint)."""
    if tree is None:
        tree = dict(model.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    if set(tree) != set(names):
        raise KeyError(f"tree does not match the module's parameters: "
                       f"missing {sorted(set(names) - set(tree))}, "
                       f"unexpected {sorted(set(tree) - set(names))}")
    defs = model_defs(model.cfg)
    out = {}
    for name in names:
        key, idx, transposed = jax_slot(name)
        val = tree[name].detach()
        if is_dtensor(val):  # a collective: every rank must call
            val = val.full_tensor()
        if not keep:
            continue
        if device is not None:
            val = val.to(device)
        val = val.T if transposed else val
        if idx is None:  # a copy even where .contiguous() would alias
            out[key] = val.clone(memory_format=torch.contiguous_format)
        else:
            if key not in out:
                out[key] = val.new_empty(defs[key].shape)
            out[key][idx] = val
    return out


def from_jax_tree(model: Transformer,
                  tree: "Mapping[str, np.ndarray | torch.Tensor]", *,
                  device=None, dtype: Optional[torch.dtype] = None
                  ) -> "dict[str, torch.Tensor]":
    """A JAX-keyed flat dict (params, gradients, Adam moments; numpy or
    torch) as a dict keyed by the module's parameter names, each value a
    contiguous tensor of the parameter's shape on ``device`` (default: the
    parameter's) in ``dtype`` (default: the value's own): the inverse of
    :func:`to_jax_params`.  Only what each value needs is read: a slice of
    a stack, and on a sharded model each rank's own block of it (a numpy
    array may map a checkpoint's file).

    On a sharded model each value is placed as its parameter.  A tree
    placed on the model's own mesh (:func:`~repro_torch.train.elastic.
    reshard_tree`, :meth:`~repro_torch.train.checkpoint.CheckpointManager.
    restore` with ``mesh``) gives each parameter its block straight from
    the key's local block (placed by the key's logical axes, the same
    split); a DTensor on another mesh is gathered whole first, one key at
    a time, a collective every rank of its mesh calls."""
    mesh, rules = model.mesh, model.rules
    defs = model_defs(model.cfg)
    params = dict(model.named_parameters())
    out, held = {}, {}
    for name in sorted(params, key=lambda n: (jax_slot(n)[0],
                                              jax_slot(n)[1] or 0)):
        p = params[name]
        key, idx, transposed = jax_slot(name)
        if key not in held:  # one key's gathered or local block at a time
            held.clear()
            val = tree[key]
            if is_dtensor(val):
                if is_dtensor(p) and val.device_mesh == mesh:
                    want = placements(mesh, rules, defs[key].logical)
                    if list(val.placements) != want:
                        val = val.redistribute(mesh, want)
                    val = ("local", val.to_local())
                else:  # a tree placed on another mesh
                    val = val.full_tensor()
            held[key] = val
        val = held[key]
        local = isinstance(val, tuple)
        val = val[1] if local else val
        val = val[idx] if idx is not None else val
        val = val.T if transposed else val
        want = tuple(p.to_local().shape if local else p.shape)
        if tuple(val.shape) != want:
            raise ValueError(f"{key}: shape {tuple(val.shape)} for {name} "
                             f"{want}")
        dev = device or p.device
        if is_dtensor(p) and not local:
            out[name] = from_whole(val, mesh, p.placements, device=dev,
                                   dtype=dtype)
            continue
        if not isinstance(val, torch.Tensor):
            val = torch.from_numpy(np.array(val))
        val = val.to(device=dev, dtype=dtype, copy=True,
                     memory_format=torch.contiguous_format)
        if local:
            from torch.distributed.tensor import DTensor

            val = DTensor.from_local(val, mesh, p.placements,
                                     run_check=False, shape=p.shape,
                                     stride=p.stride())
        out[name] = val
    return {n: out[n] for n in params}
