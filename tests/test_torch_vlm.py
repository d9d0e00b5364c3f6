"""The vlm family (``pixtral-12b``: the dense decoder, GQA 4:2 and an
untied head at SMOKE, with 16 stub patch embeddings ahead of the text)
through the port's model, serving and simulated trainer, against the
JAX package at SMOKE shapes, one torch thread.  The arch-bound tests
are tests/test_torch_audio.py's, given ``pixtral-12b`` by this file's
``media`` fixture, with their tolerances: the weights and leaf order
(``head`` after ``final_norm``; no encoder leaves), the training
forward's logits (the patch rows dropped before the head) and
``loss_fn`` with every gradient at 1 and 2 stage groups, serving greedy
with raw caches and teacher-forced with 8-bit KV and the 4-bit hop
(the patches at positions 0..15 of the cache, their rows dropped from
the logits, the cache 16 rows longer), the simulated trainer's stream
on batches carrying patches (the buffers span the 16 + 16 trunk rows),
the serve launcher's bytes and cache length, and the training
launcher (text-only, as JAX's; ``--distributed`` refused).  The
distributed trainer is tests/test_torch_media_dist.py's.
"""
import pytest
import torch

from test_torch_audio import (  # noqa: F401  (the arch-bound tests)
    test_encoder_matches_jax, test_greedy_stream_raw_caches_matches_jax,
    test_loss_and_grads_match_jax, test_serve_entry_point_on_cpu,
    test_simulated_trainer_stream_matches_jax,
    test_teacher_forced_kv8_hop_matches_jax, test_train_launcher_refusals,
    test_training_logits_and_loss_match_jax,
    test_weights_round_trip_and_leaf_order)
from test_torch_ssm import arch_params

ARCH = "pixtral-12b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def media():
    return arch_params(ARCH, {})
