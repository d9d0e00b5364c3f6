"""Split learning with AQ-SGD (paper §H.6) on the PyTorch port
(`repro_torch`; the JAX twin is examples/split_learning.py).

A client holds the input layers (private data side), the server holds
the middle of the network, and the client holds the head (private labels
side) — the model is cut twice and BOTH cuts exchange compressed
activations/gradients over the slow client<->server link.  AQ-SGD keeps
2-bit uplink traffic trainable where DirectQ degrades.

    PYTHONPATH=src python examples/torch_split_learning.py          # the card
    PYTHONPATH=src python examples/torch_split_learning.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.comm import CommConfig
from repro_torch.configs.base import get_config
from repro_torch.core.aqsgd import CompressionConfig
from repro_torch.core.quantization import wire_bytes
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

    # 3 stages = client-bottom | server | client-top  (two cut layers)
    cfg = get_config("gpt2-xl-paper", smoke=True).with_(num_layers=3)
    data = Dataset(DatasetConfig(num_samples=32, seq_len=32, vocab_size=512,
                                 seed=21))

    base_tcfg = sim.SimTrainConfig(
        num_stages=1,
        comm=CommConfig.from_legacy(CompressionConfig(mode="fp32")),
        optimizer=AdamWConfig(lr=2e-3, warmup_steps=5, schedule="constant"))
    base, _ = sim.train(cfg, base_tcfg, data, num_steps=60, batch_size=8,
                        device=dev)
    base_params = numpy_tree(to_jax_params(base["model"]))

    print("split learning: client | server | client, 2-bit uplink, "
          "8-bit downlink")
    final = {}
    for mode in ("fp32", "aqsgd", "directq"):
        tcfg = sim.SimTrainConfig(
            num_stages=3,
            comm=CommConfig.from_legacy(
                CompressionConfig(mode=mode, fw_bits=2, bw_bits=8)),
            optimizer=AdamWConfig(lr=3e-4, warmup_steps=5,
                                  schedule="constant"))
        _, losses = sim.train(cfg, tcfg, data, num_steps=40, batch_size=8,
                              initial_params=base_params, device=dev)
        final[mode] = float(np.mean(losses[-8:]))
        print(f"  [{mode:8s}] final loss {final[mode]:.4f}")

    raw = 8 * 32 * cfg.d_model * 4
    wire = wire_bytes((8 * 32, cfg.d_model), 2)
    print(f"\nper-batch uplink: {raw/1e3:.0f} KB -> {wire/1e3:.0f} KB "
          f"({raw/wire:.0f}x less client bandwidth)")
    assert final["aqsgd"] < final["directq"]
    print("AQ-SGD holds model quality at federated-client bandwidths (§H.6)")
    return final


if __name__ == "__main__":
    main()
