"""The port's four examples (examples/torch_*.py, the twins of JAX's
examples/quickstart.py, split_learning.py, finetune_aqsgd.py and
serve_batched.py) on the CPU, in this process, one torch thread.

The quickstart and split learning run at their own sizes and steps and
hold their JAX twins' assert (AQ-SGD's final loss below DirectQ's);
finetune_aqsgd runs at small flags and the JAX package's
`repro.checkpoint.restore` reads its checkpoint against the structure
of JAX's simulated state at the same flags; serve_batched runs
``--tiny`` with raw and 8-bit KV caches, every request DONE.  Each
example imports only `repro_torch`, and with no card and no
``--device cpu`` it raises.
"""
import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("torch_quickstart", "torch_split_learning",
            "torch_finetune_aqsgd", "torch_serve_batched")
FINETUNE = ["--dim", "64", "--layers", "2", "--stages", "2", "--steps", "8",
            "--pretrain-steps", "8", "--seq", "16"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _path(name):
    return os.path.join(ROOT, "examples", name + ".py")


def _example(name):
    spec = importlib.util.spec_from_file_location(name, _path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart(capsys):
    res = _example("torch_quickstart").main(["--device", "cpu"])
    assert res["aqsgd"] < res["directq"]
    assert np.isfinite(list(res.values())).all()
    assert "the paper's headline result" in capsys.readouterr().out


def test_split_learning(capsys):
    res = _example("torch_split_learning").main(["--device", "cpu"])
    assert res["aqsgd"] < res["directq"]
    out = capsys.readouterr().out
    assert "per-batch uplink: 262 KB -> 17 KB (15x less client bandwidth)" \
        in out


def test_finetune_checkpoint_reads_in_jax(tmp_path):
    import jax
    from repro.checkpoint import checkpoint as jck
    from repro.comm import CommConfig as JComm
    from repro.configs.base import get_config as jget
    from repro.core.aqsgd import CompressionConfig as JCC
    from repro.training import simulated as jsim
    out = str(tmp_path / "ft.npz")
    res = _example("torch_finetune_aqsgd").main(
        ["--device", "cpu", *FINETUNE, "--out", out])
    assert len(res["losses"]) == 8 and np.isfinite(res["losses"]).all()
    cfg = jget("gpt2-xl-paper", smoke=True).with_(
        num_layers=2, d_model=64, num_heads=1, num_kv_heads=1, head_dim=64,
        d_ff=256)
    tcfg = jsim.SimTrainConfig(num_stages=2, comm=JComm.from_legacy(
        JCC(mode="aqsgd", fw_bits=3, bw_bits=6)))
    state = jax.eval_shape(lambda: jsim.init_train_state(
        cfg, tcfg, 48, 16, jax.random.PRNGKey(0)))
    tree = jck.restore(out, {"params": state["params"],
                             "buffers": state["buffers"]})
    for leaf in jax.tree.leaves(tree):
        assert np.isfinite(np.asarray(leaf, np.float32)).all()
    assert np.asarray(tree["buffers"]["seen"]).any()


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_serve_batched_tiny(kv_bits, capsys):
    reqs = _example("torch_serve_batched").main(
        ["--tiny", "--device", "cpu", "--kv-bits", str(kv_bits)])
    assert len(reqs) == 4 and all(r.state == "DONE" for r in reqs)
    assert "over 2 slots OK" in capsys.readouterr().out


@pytest.mark.parametrize("name", EXAMPLES)
def test_imports_only_the_port(name):
    tree = ast.parse(open(_path(name)).read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names} | {n.module for n in ast.walk(tree)
                                 if isinstance(n, ast.ImportFrom)}
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" in tops and not tops & {"jax", "repro"}, tops


@pytest.mark.parametrize("name", EXAMPLES)
def test_raises_without_a_card_or_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
