"""Load the JAX package's parameters into the port's `Transformer`.

The JAX package keeps per-layer weights stacked along dim 0 under
``params["layers"]`` (a pytree of arrays); the port keeps one `Block`
per layer.  `from_jax_params` takes that pytree as numpy arrays, keyed
by the JAX names, and unstacks it leaf by leaf, so both packages
compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Transformer


def _flatten(tree: dict, prefix: str = "") -> dict:
    """{'a': {'b': x}} -> {'a.b': x}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def from_jax_params(np_tree: dict, cfg: ModelConfig, *,
                    device="cpu") -> Transformer:
    """Build a `Transformer` holding the weights of a JAX params pytree
    (numpy arrays; ``layers`` stacked along dim 0)."""
    model = Transformer(cfg, device=device)
    state = {}
    for name, arr in _flatten(
            {k: v for k, v in np_tree.items() if k != "layers"}).items():
        state[name] = np.asarray(arr)
    for name, arr in _flatten(np_tree["layers"]).items():
        arr = np.asarray(arr)
        if arr.shape[0] != cfg.num_layers:
            raise ValueError(f"layers.{name}: {arr.shape[0]} stacked "
                             f"layers, config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            state[f"layers.{i}.{name}"] = arr[i]
    own = model.state_dict()
    if set(state) != set(own):
        raise KeyError(f"params do not match the model: missing "
                       f"{sorted(set(own) - set(state))}, unexpected "
                       f"{sorted(set(state) - set(own))}")
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return model
