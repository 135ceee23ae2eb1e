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
from .transformer import Transformer, model_defs

_BIASES = {"attn/bq": "attn.wq.bias", "attn/bk": "attn.wk.bias",
           "attn/bv": "attn.wv.bias"}
#: 2-D per-block weights kept in the JAX layout (parameters, not Linears):
#: the MoE router and Mamba2's depthwise conv taps (W, C)
_AS_IS = ("moe/router", "ssm/conv_x", "ssm/conv_B", "ssm/conv_C")


def _block_key(name: str, per_block_ndim: int) -> "tuple[str, bool]":
    """Module key of one block's ``<name>`` (a ``layers/`` slice or a
    ``dense{i}/``, ``tail{t}/`` or ``shared/`` leaf), and whether it is
    transposed (a 2-D weight becomes an ``nn.Linear`` weight).  RWKV's one
    ``mix/`` table splits into ``channel_mix`` (the ``*_cm`` names) and
    ``time_mix``."""
    if name in _BIASES:
        return _BIASES[name], False
    if name.startswith("mix/"):
        name = ("channel_mix/" if name.endswith("_cm")
                else "time_mix/") + name[len("mix/"):]
    key = name.replace("/", ".")
    if per_block_ndim == 2 and name not in _AS_IS:
        return key + ".weight", True
    return key, False


def from_jax_params(cfg: ModelConfig,
                    params: "Mapping[str, np.ndarray | torch.Tensor]", *,
                    run: Optional[RunConfig] = None, device=None,
                    dtype: Optional[torch.dtype] = None,
                    trainable: bool = False) -> Transformer:
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
    """
    run = run or RunConfig()
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, run.param_dtype)
    defs = model_defs(cfg)
    if set(params) != set(defs):
        raise KeyError(f"params do not match model_defs({cfg.name}): missing "
                       f"{sorted(set(defs) - set(params))}, unexpected "
                       f"{sorted(set(params) - set(defs))}")
    t = {}
    for key, val in params.items():
        if tuple(val.shape) != tuple(defs[key].shape):
            raise ValueError(f"{key}: shape {tuple(val.shape)}, want "
                             f"{defs[key].shape}")
        if not isinstance(val, torch.Tensor):
            val = torch.from_numpy(np.array(val))
        t[key] = val.to(device=dev, dtype=dtype)

    own = ((lambda x: x.clone(memory_format=torch.contiguous_format))
           if trainable else (lambda x: x))
    sd = {"embed.weight": t["embed"], "final_ln": t["final_ln"]}
    if not cfg.tie_embeddings:
        sd["unembed.weight"] = t["unembed"].T
    for key, val in t.items():
        head, _, name = key.partition("/")
        if head == "layers":
            mod, transpose = _block_key(name, val.dim() - 1)
            for i in range(val.shape[0]):
                sd[f"layers.{i}.{mod}"] = val[i].T if transpose else val[i]
        elif name:  # dense{i}/ -> dense.{i}, tail{t}/ -> tail.{t}, shared/
            mod, transpose = _block_key(name, val.dim())
            prefix = re.sub(r"^(dense|tail)(\d+)$", r"\1.\2", head)
            sd[f"{prefix}.{mod}"] = val.T if transpose else val
    with torch.device("meta"):
        model = Transformer(cfg, run)
    model.load_state_dict({k: own(v) for k, v in sd.items()}, strict=True,
                          assign=True)
    if trainable:
        return model.requires_grad_(True).train()
    return model.requires_grad_(False).eval()


def _jax_slot(name: str) -> "tuple[str, Optional[int], bool]":
    """(JAX key, index in its ``layers/`` stack or None, transposed) of the
    module parameter ``name``: the inverse of :func:`from_jax_params`'s
    mapping."""
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


def jax_key_of(name: str) -> str:
    """The JAX key holding the module parameter ``name`` (for a
    ``layers.{i}.`` parameter, the stacked key it is slice i of):
    ``"layers.3.attn.wq.weight"`` -> ``"layers/attn/wq"``,
    ``"layers.0.time_mix.mu_r"`` -> ``"layers/mix/mu_r"``,
    ``"shared.attn.wq.bias"`` -> ``"shared/attn/bq"``."""
    return _jax_slot(name)[0]


def to_jax_params(model: Transformer,
                  tree: "Optional[Mapping[str, torch.Tensor]]" = None, *,
                  device=None) -> "dict[str, torch.Tensor]":
    """The module's parameters, or ``tree`` (keyed by the module's
    parameter names: gradients, Adam moments), as a flat dict with the JAX
    keys and layouts: ``layers/`` slices restacked in order, Linear
    weights transposed back, every value contiguous (a new tensor, off the
    graph).  ``device`` (default: where the values are) is where each
    value is moved before it is restacked: ``"cpu"`` for a checkpoint
    keeps the restacked copy off the card."""
    if tree is None:
        tree = dict(model.named_parameters())
    names = [n for n, _ in model.named_parameters()]
    if set(tree) != set(names):
        raise KeyError(f"tree does not match the module's parameters: "
                       f"missing {sorted(set(names) - set(tree))}, "
                       f"unexpected {sorted(set(tree) - set(names))}")
    stacks: dict = {}
    out = {}
    for name in names:
        key, idx, transposed = _jax_slot(name)
        val = tree[name].detach()
        if device is not None:
            val = val.to(device)
        val = val.T if transposed else val
        if idx is None:
            out[key] = val.contiguous()
        else:
            stacks.setdefault(key, {})[idx] = val
    for key, parts in stacks.items():
        out[key] = torch.stack([parts[i] for i in range(len(parts))])
    return out


def from_jax_tree(model: Transformer,
                  tree: "Mapping[str, np.ndarray | torch.Tensor]", *,
                  device=None, dtype: Optional[torch.dtype] = None
                  ) -> "dict[str, torch.Tensor]":
    """A JAX-keyed flat dict (params, gradients, Adam moments; numpy or
    torch) as a dict keyed by the module's parameter names, each value a
    contiguous tensor of the parameter's shape on ``device`` (default: the
    parameter's) in ``dtype`` (default: the value's own): the inverse of
    :func:`to_jax_params`."""
    out = {}
    for name, p in model.named_parameters():
        key, idx, transposed = _jax_slot(name)
        val = tree[key]
        if not isinstance(val, torch.Tensor):
            val = torch.from_numpy(np.array(val))
        val = val[idx] if idx is not None else val
        val = val.T if transposed else val
        if tuple(val.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {tuple(val.shape)} for {name} "
                             f"{tuple(p.shape)}")
        out[name] = val.to(device=device or p.device, dtype=dtype).clone(
            memory_format=torch.contiguous_format)
    return out
