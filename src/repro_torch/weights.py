"""Move parameters between the JAX package's layout and the port's.

The JAX package keeps per-layer weights stacked along dim 0 under
``params["layers"]`` (a pytree of arrays); the port keeps one `Block`
per layer.  `from_jax_params` takes that pytree as numpy arrays, keyed
by the JAX names, and unstacks it leaf by leaf, so both packages
compute with the same weights (an untied ``head``, (d_model, vocab),
the mamba layers' ``layers.mamba.*`` and ``layers.norm1.*``, the
hybrid's unstacked ``shared_block.*``, a MoE model's ``prefix``, a
list of dense layers, as ``prefix.<i>.*``, and an audio model's
encoder, ``enc_layers`` stacked as ``layers`` is, and ``enc_norm``,
included).  `jax_leaf_names` and `jax_leaves` give the port's
parameters in ``jax.tree.leaves`` order, the order of the data-parallel
gradient bucket (`repro_torch.core.grad_compress`): keys sorted, so
``embed``, ``enc_layers``, ``enc_norm``, ``final_norm``, ``head``,
``layers`` (an audio layer's ``norm_x`` and ``xattn`` after its
``norm2``), ``prefix`` (its items in turn), ``shared_block``.

The distributed trainer's tree is the JAX package's pipeline layout
(`to_pipeline_params`): ``layers`` zero-padded to K * lps layers and
reshaped to ``stages`` (K, lps, ...), lps = ceil(L / K) over the L
layers past the prefix (a MoE layer's expert stacks become 5-D, (K,
lps, E, d, ff)); the encoder stays stacked beside them.
`stage_state_dict` gives one pipeline stage its weights from it (every
stage of a hybrid holds the whole ``shared_block``, every stage of an
audio model the whole encoder, the first stage a MoE model's
``prefix``).

`jax_tree` goes the other way: any name -> tensor dict keyed by the
port's parameter names (the parameters, the AdamW moments) as the JAX
package's nested tree, the layers restacked; `to_jax_params` is it on a
model, the layout of a checkpoint's ``params`` (`repro_torch.checkpoint`)
and of ``launch.train --checkpoint``.  `from_jax_tree` unstacks a tree
back into the port's names.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Transformer

# the JAX trees' leaves stacked along dim 0, a layer a row
STACKED = ("layers", "enc_layers")


def _flatten(tree, prefix: str = "") -> dict:
    """{'a': {'b': x}, 'p': [{'c': y}]} -> {'a.b': x, 'p.0.c': y}."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _name_key(name: str) -> tuple:
    """A dotted name's sort key in ``jax.tree.leaves`` order: dict keys
    sorted, list items (numeric parts) in turn."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in name.split("."))


def from_jax_tree(tree: dict) -> dict:
    """A JAX params-shaped tree (tensors or numpy arrays; ``layers`` and
    ``enc_layers`` stacked along dim 0) as ``{port parameter name:
    leaf}``, each layer a view of its stacked leaf."""
    out = {}
    for name, leaf in _flatten(tree).items():
        top, _, rest = name.partition(".")
        if top in STACKED:
            for i in range(leaf.shape[0]):
                out[f"{top}.{i}.{rest}"] = leaf[i]
        else:
            out[name] = leaf
    return out


def from_jax_params(np_tree: dict, cfg: ModelConfig, *,
                    device="cpu") -> Transformer:
    """Build a `Transformer` holding the weights of a JAX params pytree
    (numpy arrays; ``layers`` stacked along dim 0)."""
    model = Transformer(cfg, device=device)
    for top, n in (("layers", cfg.n_trunk),
                   ("enc_layers", cfg.encoder_layers)):
        for name, arr in _flatten(np_tree.get(top, {})).items():
            if np.shape(arr)[0] != n:
                raise ValueError(f"{top}.{name}: {np.shape(arr)[0]} "
                                 f"stacked layers, config has {n}")
    state = {k: np.asarray(v) for k, v in from_jax_tree(np_tree).items()}
    own = model.state_dict()
    if set(state) != set(own):
        raise KeyError(f"params do not match the model: missing "
                       f"{sorted(set(own) - set(state))}, unexpected "
                       f"{sorted(set(state) - set(own))}")
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return model


def jax_leaf_names(names) -> list:
    """Group the port's parameter names into the JAX package's leaves,
    in ``jax.tree.leaves`` order (dict keys sorted at every level, a
    MoE model's ``prefix`` list in turn): ``[(jax_name, [port
    names])]``, where ``layers.<i>.<rest>`` for every i forms the one
    stacked leaf ``layers.<rest>``, layer-major (and so
    ``enc_layers.<i>.<rest>``)."""
    groups: dict = {}
    for name in names:
        parts = name.split(".")
        stacked = parts[0] in STACKED
        key = ".".join([parts[0]] + parts[2:]) if stacked else name
        groups.setdefault(key, []).append(
            (int(parts[1]) if stacked else 0, name))
    return [(k, [n for _, n in sorted(groups[k])])
            for k in sorted(groups, key=_name_key)]


def jax_leaves(params: dict) -> list:
    """``params`` (name -> tensor, as ``named_parameters`` gives them)
    as a tree in JAX leaf order: a tensor per top-level leaf and a list
    of per-layer tensors per stacked ``layers.*`` or ``enc_layers.*``
    leaf."""
    return [[params[n] for n in names] if key.split(".")[0] in STACKED
            else params[names[0]]
            for key, names in jax_leaf_names(params)]


def jax_tree(named: dict) -> dict:
    """``named`` (port parameter name -> tensor) as the JAX package's
    nested tree: dotted names nested (``prefix.<i>.<rest>`` as item i
    of the ``prefix`` list), ``layers.<i>.<rest>`` stacked along a new
    dim 0 (a new tensor on their device) under ``layers/<rest>``, and so
    ``enc_layers``; the other leaves are ``named``'s own tensors."""
    out: dict = {}
    for key, names in jax_leaf_names(named):
        parts = key.split(".")
        leaf = torch.stack([named[n] for n in names]) \
            if parts[0] in STACKED else named[names[0]]
        node = out
        for p, nxt in zip(parts[:-1], parts[1:]):
            empty = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                if int(p) == len(node):
                    node.append(empty)
                node = node[int(p)]
            else:
                node = node.setdefault(p, empty)
        node[parts[-1]] = leaf
    return out


@torch.no_grad()
def to_jax_params(model: Transformer) -> dict:
    """The inverse of `from_jax_params`: the model's weights as a JAX
    params tree of tensors, ``layers`` restacked along dim 0."""
    return jax_tree({n: p.detach() for n, p in model.named_parameters()})


def numpy_tree(tree):
    """A tree of tensors (nested dicts and lists, as `to_jax_params`
    gives) as numpy arrays on the host: a JAX params pytree to start a
    trainer from (``initial_params``)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


def load_jax_params(model: Transformer, np_tree: dict) -> Transformer:
    """Copy a JAX params pytree (numpy arrays) into an existing model,
    in place (the trainer's ``initial_params``)."""
    model.load_state_dict(from_jax_params(np_tree, model.cfg).state_dict())
    return model


def _layers_per_stage(cfg: ModelConfig, num_stages: int) -> int:
    return -(-cfg.n_trunk // num_stages)


def to_pipeline_params(np_tree: dict, cfg: ModelConfig,
                       num_stages: int) -> dict:
    """A JAX params pytree (numpy) in the pipeline layout: ``layers``
    becomes ``stages``, zero-padded to K * lps layers and reshaped to
    (K, lps, ...)."""
    lps = _layers_per_stage(cfg, num_stages)
    pad = num_stages * lps - cfg.n_trunk

    def stage(a):
        a = np.asarray(a)
        if pad:
            a = np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])
        return a.reshape(num_stages, lps, *a.shape[1:])

    out = {k: v for k, v in np_tree.items() if k != "layers"}
    out["stages"] = {name: stage(a)
                     for name, a in _flatten(np_tree["layers"]).items()}
    return out


def from_pipeline_params(np_tree: dict, cfg: ModelConfig,
                         num_stages: int) -> dict:
    """Inverse of `to_pipeline_params` (dead padded layers dropped);
    the ``layers`` leaves come back flat-keyed (``attn.wq``, ...)."""
    out = {k: v for k, v in np_tree.items() if k != "stages"}
    out["layers"] = {
        name: np.asarray(a).reshape(-1, *np.asarray(a).shape[2:])
        [:cfg.n_trunk] for name, a in _flatten(np_tree["stages"]).items()}
    return out


def stage_state_dict(np_pipe: dict, cfg: ModelConfig, num_stages: int,
                     stage: int, *, embed: bool, final_norm: bool,
                     head: bool = False, shared: bool = False,
                     prefix: bool = False, encoder: bool = False) -> dict:
    """One pipeline stage's weights from a pipeline-layout tree (numpy):
    ``layers.<l>.*`` for its live layers l = 0.. (trunk layer
    stage * lps + l), plus ``embed``, ``final_norm.scale``, the untied
    ``head``, the hybrid's ``shared_block.*``, an audio model's encoder
    (``enc_layers.<i>.*``, ``enc_norm.scale``) and a MoE model's dense
    ``prefix.<i>.*`` where the stage holds them.  Keys are the stage
    module's parameter names."""
    lps = _layers_per_stage(cfg, num_stages)
    out = {}
    flat = _flatten({k: v for k, v in np_pipe.items() if k != "stages"})
    if embed:
        out["embed"] = flat["embed"]
    if final_norm:
        out["final_norm.scale"] = flat["final_norm.scale"]
    if head:
        out["head"] = flat["head"]
    for part, want in (("shared_block.", shared), ("prefix.", prefix),
                       ("enc_norm.", encoder)):
        if want:
            out.update({k: v for k, v in flat.items() if k.startswith(part)})
    if encoder:
        out.update({k: np.asarray(v) for k, v in from_jax_tree(
            {"enc_layers": np_pipe["enc_layers"]}).items()})
    for name, a in _flatten(np_pipe["stages"]).items():
        for l in range(lps):
            if stage * lps + l < cfg.n_trunk:
                out[f"layers.{l}.{name}"] = np.asarray(a)[stage, l]
    return out
