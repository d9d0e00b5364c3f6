"""Quickstart on the PyTorch port (`repro_torch`; the JAX twin is
examples/quickstart.py): fine-tune a small LM over a simulated slow
network with AQ-SGD activation compression (2-bit forward / 4-bit
backward), and see that it tracks uncompressed training where direct
quantization does not.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.comm import CommConfig
from repro_torch.configs.base import get_config
from repro_torch.core.aqsgd import CompressionConfig
from repro_torch.data.pipeline import Dataset, DatasetConfig
from repro_torch.launch.serve import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import simulated as sim
from repro_torch.weights import numpy_tree, to_jax_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch codec)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a 4-layer GPT-2-family model, cut into 4 pipeline stages (3
    # boundaries)
    cfg = get_config("gpt2-xl-paper", smoke=True).with_(num_layers=4)
    data = Dataset(DatasetConfig(num_samples=32, seq_len=32, vocab_size=512))

    print("pre-training a base model (fp32)...")
    base_tcfg = sim.SimTrainConfig(
        num_stages=1,
        comm=CommConfig.from_legacy(CompressionConfig(mode="fp32")),
        optimizer=AdamWConfig(lr=2e-3, warmup_steps=5, schedule="constant"))
    base_state, base_losses = sim.train(cfg, base_tcfg, data, num_steps=60,
                                        batch_size=8, device=dev)
    print(f"  base loss: {base_losses[0]:.2f} -> "
          f"{np.mean(base_losses[-5:]):.2f}")
    base_params = numpy_tree(to_jax_params(base_state["model"]))

    results = {}
    for mode in ("fp32", "aqsgd", "directq"):
        tcfg = sim.SimTrainConfig(
            num_stages=4,
            comm=CommConfig.from_legacy(
                CompressionConfig(mode=mode, fw_bits=2, bw_bits=4)),
            optimizer=AdamWConfig(lr=3e-4, warmup_steps=5,
                                  schedule="constant"))
        _, losses = sim.train(cfg, tcfg, data, num_steps=40, batch_size=8,
                              initial_params=base_params, device=dev)
        results[mode] = float(np.mean(losses[-8:]))
        print(f"fine-tune [{mode:8s}] fw2 bw4: final loss "
              f"{results[mode]:.4f}")

    print()
    print(f"AQ-SGD gap to FP32:  {results['aqsgd'] - results['fp32']:+.4f}")
    print(f"DirectQ gap to FP32: {results['directq'] - results['fp32']:+.4f}")
    assert results["aqsgd"] < results["directq"], "paper claim violated?!"
    print("AQ-SGD compresses the wire 16x (fp32 -> 2 bit) and still tracks "
          "FP32 - the paper's headline result.")
    return results


if __name__ == "__main__":
    main()
