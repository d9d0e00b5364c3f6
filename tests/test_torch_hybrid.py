"""The hybrid family (``zamba2-2.7b``: mamba2 layers in blocks of
``shared_attn_every``, each block followed by one shared attention +
FFN block) against the JAX package.

Every arch-bound test of tests/test_torch_ssm.py runs again here, on
zamba2's SMOKE config (4 layers in 2 blocks) as JAX has it (head_dim
64) and at ``head_dim=80``, zamba2's own, so the shared block's
attention runs at the head dim the card's B10 pads (`loss_fn` and every
gradient, remat, serving teacher-forced and greedy at 2 stage groups,
prefill then decode; at head_dim 64 alone, as their config fields do
not depend on it: the kv-bits rule, the simulated trainer's loss
stream, the weights' round trip and leaf order, the pipeline bucket).
Then:

* a block count that the stage groups do not divide is refused, as
  JAX refuses it, in the trunk and by the serve launcher;
* B10's plain version at head_dim 80 against JAX's oracle and the
  interpret-mode Pallas kernel (tests/test_torch_flash.py's sweep and
  tests/test_torch_train_attention.py's cases also hold hd 80; the
  card's padded kernel is in tests/test_torch_cuda.py).
The cross-package checkpoint and the distributed trainer are in
tests/test_torch_hybrid_dist.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import flash_attention_ref as jax_oracle
from repro.models import model as Mo
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from test_torch_ssm import arch_params, case_id
from test_torch_ssm import test_greedy_staged_stream_matches_jax  # noqa
from test_torch_ssm import test_kv_bits_follow_the_family_rules  # noqa
from test_torch_ssm import test_loss_and_grads_match_jax  # noqa
from test_torch_ssm import test_pipeline_bucket_matches_jax  # noqa
from test_torch_ssm import \
    test_prefill_then_decode_matches_full_forward  # noqa
from test_torch_ssm import test_remat_is_bit_equal  # noqa
from test_torch_ssm import test_serving_matches_jax_teacher_forced  # noqa
from test_torch_ssm import test_trainer_loss_stream_matches_jax  # noqa
from test_torch_ssm import test_weights_round_trip_and_leaf_order  # noqa

ARCH = "zamba2-2.7b"
ARCH_CASES = [(ARCH, {}), (ARCH, {"head_dim": 80})]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=ARCH_CASES, ids=case_id)
def arch(request):
    return arch_params(*request.param)


@pytest.fixture(scope="module", params=ARCH_CASES[:1], ids=case_id)
def arch0(request):
    return arch_params(*request.param)


def test_block_stages_are_refused_as_jax_refuses_them():
    """2 blocks do not split into 3 stage groups (nor 4 layers' worth):
    JAX's trunk asserts; the port's trunk, serving step and launcher
    (uniform or ``--continuous``) raise, naming the blocks; the
    continuous batcher serves at 2 stage groups."""
    jcfg, tcfg, params, np_params = arch_params(ARCH, {})
    batch = {k: jnp.zeros((1, 8), jnp.int32 if k != "mask" else jnp.float32)
             for k in ("tokens", "targets", "mask")}
    with pytest.raises(AssertionError):
        Mo.loss_fn(params, jcfg, batch, num_stages=4)
    model = TM.Transformer(tcfg)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="2 blocks of 2 layers"):
        TM.loss_fn(model, {"tokens": toks, "targets": toks,
                           "mask": torch.ones(1, 8)}, num_stages=4)
    with pytest.raises(ValueError, match="2 blocks of 2 layers"):
        model.forward_with_caches(toks, model.init_caches(1, 8),
                                  num_stages=4)
    with pytest.raises(ValueError, match="do not split into 3"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--stages", "3"])
    with pytest.raises(ValueError, match="whole blocks"):
        TM.Transformer(tcfg.with_(num_layers=3))
    with pytest.raises(ValueError, match="do not split into 3"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--continuous", "--stages", "3"])
    out = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--continuous", "--stages", "2", "--batch", "2",
                       "--prompt-len", "6", "--gen", "2"])
    assert [r.state for r in out["requests"]] == ["DONE"] * 4


@pytest.mark.parametrize("causal,window", [(True, 10 ** 9), (True, 9),
                                           (False, 10 ** 9)])
def test_b10_plain_version_at_head_dim_80_matches_jax(causal, window):
    rng = np.random.default_rng(80)
    q = rng.standard_normal((2, 4, 64, 80)).astype(np.float32)
    k, v = (rng.standard_normal((2, 4, 64, 80)).astype(np.float32)
            for _ in "kv")
    want = jax_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, block_q=32, block_k=16)
    got = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, window=window)
    for ref in (want, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
    assert fa.PADDED_HEAD_DIMS[80] in fa.HEAD_DIMS
    padded = fa.pad_head_dim(torch.from_numpy(q), 96)
    assert padded.shape[-1] == 96 and not padded[..., 80:].any()
    assert torch.equal(padded[..., :80], torch.from_numpy(q))
