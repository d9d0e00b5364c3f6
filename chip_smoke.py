#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own line:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. ``[build]``: the nvcc builds of ``src/repro_torch/kernels/csrc/quant_pack.cu``
   and ``flash_attention.cu``, one nvcc each, side by side;
3. each of the nine codec kernels against its plain PyTorch version on
   the card, BIT-EXACT, at the main paths' shapes (the decode hop
   R=8, d=1600; KV rows R=8*25 per decode append, R=8*128*25 per
   prefill append, R=8*160*25 per store read, d=64; the DP gradient
   bucket R=877132, d=512), at bits 2/4/8, a ragged R, an odd d (the
   scalar path), the encoders at their tiling's edges past 256 values
   (d 260, 1600, 2048, 2560, 3584, 4608, 5120 and 8196, past the
   register cap; 1 and 5 rows; B2 at the hops of 3584, 4608 and 5120,
   and at mamba2's (8, 2048) and zamba2's (2, 2560)), stochastic cases
   with shared noise, a bf16 read, both
   ``pack`` variants, zero scale rows and n = 1/2/3/5 workers; then each
   kernel's median device time (CUDA events around a CUDA graph of
   back-to-back launches), its byte bound and the plain version's time;
   the activation codecs the training path runs are also checked
   bit-exact and timed at its shape (R=4*1024, d=1600), and checked
   at [train-zamba2]'s (R=4*1024, d=2560, with and without the noise;
   B5 and B6 at its 1,299,696-row bucket); the ring's
   three kernels (accumulate, sum pack and unpack) at every sum width
   (2/4/8/16/32 bits), ragged rows, the element path, the sums'
   unpacker past its last whole 512-byte segment and on a misaligned
   view, and the distributed path's shapes (a ring segment of 318554
   rows, the 637107-row bucket, d=512, 4 bits, n=2);
   ``[oncore-bit-exact]``: the three encoders with a seed (B11, their
   own Philox noise) against the plain versions fed
   ``ref.oncore_uniform_ref``, BIT-EXACT, at three seeds, bits 2/4/8,
   the serving and training shapes, the tiling's edges past 256 values
   and the DP bucket, a d % 4 != 0 and a misaligned view (the scalar
   path); ``[oncore-stats]``: their
   10k-trial unbiasedness (5 sigma, tests/test_grad_compress.py's
   harness); and their ``[kernel-time]`` rows at the training path's
   shapes, beside the noise-input path they replace (the kernel
   reading u, and the ``torch.rand`` that writes u);
   ``[legacy-bit-exact]``: the gradient wire's legacy pair (B9a
   ``quantize_pack_scaled``, B9b ``unpack_codes``, reached only through
   `core.boundary.encode_with_scale` / `decode_codes`) against their
   plain versions, BIT-EXACT, at bits 2/4/8, deterministic and
   stochastic, R 37 and 300, a d % 4 != 0, a misaligned view, zero
   scale and zero x rows, B9b with a tail past its last whole 512-byte
   segment, and the DP bucket at 4 bits; their
   ``[kernel-time]`` rows at the bucket (B9a 4-bit stochastic and
   deterministic, B9b 4 and 8 bits, where a widening cast is the
   library call); ``[legacy-dp-codec]``: tests/test_grad_compress.py's
   ``_codec`` chain at the bucket for two simulated workers sharing one
   scale (4 bits, stochastic, one u a worker), the legacy pair against
   the fused sender (B5 with ``pack``), bit-equal in packed bytes, codes
   and means, with both chains' device time a worker beside their byte
   bounds, the counters set to 0 just before the legacy chain and read
   just after; then the pair drawing u from a generator with
   ``ACSGD_ONCORE_PRNG=1`` and without: the same bytes, no seeded
   launch;
   ``[kv-pair-bit-exact]``: the KV plane's pair calls (B3's append of k
   and v in one launch, written in place into the layer stores at the
   write head; B4's read of both stores in one launch) against their
   plain versions and against two per-tensor kernel calls, BIT-EXACT,
   at both archs' KV shapes (the decode and prefill appends, the whole
   store read in f32 and bf16), bits 2/4/8, deterministic, with noise
   and seeded, a group_d of 32, rows wide enough for the two-pass path,
   a g % 4 != 0 and misaligned views, into stores of random bytes, so
   the rows outside the append must keep theirs;
   ``[kv-pair-row-heads-bit-exact]``: the pair append at per-row write
   heads (a (B,) int32 tensor on the card, the continuous batcher's
   pool: gpt2-xl's 8 slots with heads at 0, inside, at the last row and
   past the store, gemma2's 2 slots, a run of 2 rows a slot), bits
   2/4/8, deterministic, with noise and seeded, BIT-EXACT against its
   plain version (the clamp included) and against one scalar-head
   launch a slot at its clamped head; ``[launch-floor]``: an
   empty kernel through the same CUDA-graph timing harness, what a
   launch costs there; the pair launches' ``[kernel-time]`` rows at
   gpt2-xl's and gemma2's store read and decode append, the pool append
   at per-row heads beside the scalar-head pair at its shape, B3 and
   B4 per call at gemma2's shapes and B1 at gemma2's hop (2, 3584),
   each with its time over the launch floor;
   ``[flash-check]``: the attention kernel (B10) against its plain
   version within a tolerance: the sweep of tests/test_flash_kernel.py
   (shapes, GQA and MQA, bf16, windows 9 and 17, softcaps 4 and 30,
   non-causal) at rtol = atol = 2e-5 (f32) and 2e-2 (bf16), ragged
   Sq/Sk with a query offset, the continuous batcher's B = 1 prefills
   (1, 25, 25, Sq, 160, 64) at Sq 4, 77 and 128, Sq and Sk off the
   kernel's tiles at every head dim with q scaled by 16 under a softcap
   of 50, f32 k and v rows off 16-byte alignment, and the two paths'
   prefill calls (gpt2-xl;
   gemma2-9b on a local and a global layer) at 1e-4.  The f32 sweep is
   held to the plain version's formula evaluated in float64 (the f32
   plain version's own rounding of q k^T passes 2e-5 at hd 256 with q
   scaled by 16); the distance from the f32 plain version is printed
   beside it, and bf16 and the paths are held to the f32 plain
   version; and at the training paths' shapes (a ``[train]`` worker's
   (4, 25, 25, 1024, 1024, 64) causal, gemma2-9b's heads at 1024 tokens
   on a global and a local layer) with the rows' log-sum-exp, o and lse
   both held to the f32 plain version at 1e-4.  Then its
   ``[kernel-time]`` rows at those six calls (the training ones with
   ``return_lse``, their lse's bytes counted):
   device time, the bound on the f32 units (operations over the
   visible scores against q, k, v, o bytes) and on the tensor cores
   (``bound_tc_ms``: its 3 TF32 passes at 495 TFLOP/s), the plain
   version's time and, at gpt2-xl's shape (no softcap, MHA),
   ``scaled_dot_product_attention`` with the visibility mask (and at
   the gpt2-xl training shape, where it computes o alone);
   ``[flash-train-check]``: the training attention
   (`repro_torch.models.layers.flash_attention`: B10 with the lse, JAX's
   backward in PyTorch) at those three training shapes against its
   formula in float64: o within 2e-5, the lse within 2e-5 (rtol =
   atol), dq, dk and dv within 1e-4 of each one's largest |value|, B10's
   o bit-identical with and without the lse; then ``loss_fn`` and its
   gradients with remat off and on, bit-equal, on both archs' SMOKE
   models and gpt2-xl-paper at full width cut to 4 layers (B10 once a
   layer, twice with remat);
4. ``[serve]``: the serving path at full width and depth:
   ``gpt2-xl-paper`` (48 layers, d 1600), random weights from a seeded
   generator, batch 8, prompt 128, 32 greedy decode steps, ``--stages 2
   --mode aqsgd --fw-bits 4 --kv-bits 8``, through
   `repro_torch.launch.serve` — with the kernel launch counters set to
   0 just before and read just after (B10 once a layer of the prefill;
   B3 and B4 once a layer of every step, k and v in one launch each);
5. a reference check of serving on a small input: the SMOKE model on the
   card (kernels) against the same weights on the CPU (plain versions),
   teacher-forced, within the tolerances of tests/test_torch_slice.py;
   ``[serve-continuous]``: the launcher's ``--continuous`` run at
   gpt2-xl-paper full size (48 layers, d 1600, random weights from seed
   0): 16 requests of 7-125 tokens (the launcher's numpy draw, seed 1)
   over 8 slots of 160 rows, 32 greedy tokens each, the same comm flags;
   requests, ticks, tokens, tok/s, prefill and decode seconds, peak
   memory, the hop bytes against ``hop_bytes(8, 1600)`` x ticks and the
   pool's KV store bytes against the byte model, the counters set to 0
   just before and checked exactly just after (B10 48 x admissions, B3
   = B4 48 x (admissions + ticks), B1 = B2 ticks, the rest 0);
   ``[serve-continuous-isolation]``: its first and last requests each
   served alone in a pool of 8 slots, tokens equal to the mixed run's;
   ``[serve-continuous-guard]``: tests/test_faults.py's fault test on
   the card (gpt2-xl-paper at full width, 4 of 48 layers, 3 requests
   over 2 slots, ``2:kv:nan-scale``): the victim evicted with
   ``plane=kv`` and ``tick=2``, every survivor's tokens equal to the
   clean run's; ``[serve-continuous-reference-check]``: the batcher on
   the card against the CPU in lockstep, gpt2-xl-paper and gemma2-9b
   (window 4) SMOKE, 5 requests over 3 slots: each tick's logits within
   the decode tolerance while the streams agree, KV codes within one,
   a fork allowed only at a near tie (printed), one at most;
   ``[serve-gemma2]``: the slice's own path, ``gemma2-9b`` at full
   width, the first 4 of its 42 layers, two local and two global
   (`G_LAYERS`; all 42 until the FSDP slice, 10 until the distributed
   checkpoint's; d 3584, vocab 256000; local layers see 4096 keys,
   softcaps 50 and 30, 16 query heads on 8 kv heads of 256),
   batch 2, a prompt of 8160 into a cache of 8192, 32 greedy decode
   steps, the same comm flags, the counters set to 0 just before and
   checked exactly just after; the hop's bytes as the encoder emits
   them and the KV stores' bytes against the byte models; then
   ``[serve-gemma2-reference-check]``: its SMOKE model, prompt 40 (past
   the window of 16), 6 decode steps, card against CPU, and
   ``[serve-gemma2-build]``: the launcher's model build (weights drawn
   on the CPU from the seed) against a build drawn on the card;
   ``[serve-stablelm]``: ``stablelm-12b`` at full width (d 5120, 32
   query heads on 8 kv heads of 160, vocab 100352, an untied head), the
   first 4 of its 40 layers (`S_LAYERS`), batch 2, a prompt of 4064
   into a cache of its 4096-token context, 32 decode steps, and
   ``[serve-gemma2-27b]``: ``gemma2-27b`` at full width (d 4608, 32
   heads on 16 kv heads of 128, d_ff 36864) cut to the first 2 of its
   46 layers (``--layers``, `G27_LAYERS`; 28, the most the card holds,
   costs ~100 s more of host weight draws), batch 2, prompt 8160 into
   8192, 32 decode steps; both with the same comm flags and checks
   as ``[serve-gemma2]`` (launches exactly, hop and KV bytes against
   the byte models); then each one's SMOKE card-against-CPU check
   (``[serve-stablelm-12b-reference-check]``,
   ``[serve-gemma2-27b-reference-check]``), and both join
   ``[serve-continuous-reference-check]``;
6. ``[train]``: AQ-SGD fine-tuning with 4-bit DP gradients through
   `repro_torch.training.simulated.train`: ``gpt2-xl-paper`` at full
   width cut to 12 of its 48 layers (the full-depth training state does
   not fit one 80 GB card), 4 stage groups, aqsgd fw 4 / bw 8, DP 4-bit
   on the ``ring`` wire over 2 simulated workers, batch 8 x seq 1024,
   16 samples, 6 steps (3 epochs, so the delta path runs from step 3),
   seed 0 — the counters set to 0 just before and read just after (B10
   once a layer a worker);
   then ``[train-oncore]``: the same run with ``ACSGD_ONCORE_PRNG=1``,
   each stochastic encode drawing its noise in the kernel (B1 36, B3
   36, B5 12 seeded launches, none reading a noise tensor), its step
   time, peak memory and final loss against ``[train]``'s;
7. ``[train-reference-check]``: the SMOKE model, deterministic rounding
   on every plane, remat on, 4 steps on the card (kernels) against the
   CPU (plain versions) from the same weights; ``[train-full-depth]``:
   ``[train]``'s settings with ``remat`` at 40 of gpt2-xl-paper's 48
   layers, the most (in multiples of the 4 stage groups) the card holds
   (the step's peak sits in the DP wire, ~1.73 GiB a layer,
   tools/train_memory.py), 6 steps: step time, tokens/s, peak memory,
   B10 twice a layer a worker (forward and recompute);
8. ``[dist-train]``: the distributed GPipe trainer through
   `repro_torch.launch.train.run_distributed` (what ``--distributed``
   runs): ``gpt2-xl-paper`` at full width cut to 8 of its 48 layers, a
   2 x 2 (data x model) mesh of four processes sharing the card over
   gloo, 2 microbatches, batch 8 x seq 512, 16 samples, aqsgd fw 4 /
   bw 8 stochastic, the 4-bit ``ring`` DP wire, 4 steps (steps 1-2 the
   warm-up epoch, 3-4 compressed), lr 1e-3, the pipeline's remat
   defaults (nested, 64 loss chunks), the spec built from those flags by
   the launcher — each rank's launch counts
   set to 0 just before each step and read just after, summed over
   ranks and steps; the replica checks (each stage's ``m_in`` equals
   the upstream ``m_out``, the two copies of the tied embedding equal)
   after every step, and the bytes each rank sent against the byte
   models;
9. ``[dist-reference-check]``: the same 2 x 2 mesh at SMOKE width (4
   layers), deterministic rounding on every plane, remat nested, 3
   steps on the card (kernels) against the CPU (plain versions) from
   the same seed; ``[train-untied-reference-check]``: the untied head
   (``stablelm-12b`` SMOKE) through the simulated trainer and the
   distributed one, each on the card against the CPU as the two checks
   above (the distributed run's last stage holds ``head`` and no
   embedding copy);
10. the rest of the DP wires and the optimizer: ``[train-sharded]``:
   ``[train]``'s run with the ZeRO wire (``ring-sharded``: the ring's
   reduce-scatter half, AdamW on each worker's segment of the f32
   parameter bucket), its losses bit-equal to ``[train]``'s and its
   launches the same; ``[dist-train-sharded]``, ``[dist-train-fp16]``
   and ``[dist-train-adam8]``: ``[dist-train]``'s spec with
   ``--dp-wire ring-sharded`` (losses bit-equal to ``[dist-train]``'s,
   B8a/B8b 0 launches, the dp plane at 84,098,252 B a rank a step, the
   parameter all-gather one f32 segment of 652,398,592 B), with
   ``--dp-wire fp16`` (one f16 all-reduce of 652,397,568 B, B5-B8b 0
   launches) and with 8-bit AdamW moments (``state_bits`` 8, losses
   within `ADAM8_LOSS_RTOL` of ``[dist-train]``'s), all four run in
   turn by one spawn of the launcher's `run_distributed`; each one's
   per-rank peak memory and phase times; then the SMOKE card-against-
   CPU checks of the simulated trainer with ``ring-sharded`` and
   ``fp16`` and of the distributed one with ``ring-sharded``, ``fp16``
   and ``state_bits`` 8 (``[train-zero-reference-check]``,
   ``[dist-zero-reference-check]``);
11. fault tolerance, at full width with the depth cut to 2 layers
   (checkpoints of 2.94 GB under ``results/``, which git ignores; the
   free disk is checked against the reckoned bytes first, and the
   directory removed after): ``[train-resume]``: ``[train]``'s settings
   at 2 layers and 2 stage groups through `launch.runner` — an
   uninterrupted run of 6 steps, a fresh process (spawned as
   `launch.mesh.spawn` spawns) that checkpoints every 2 steps and
   hard-exits with 17 after step 4's loss, and a fresh process that
   resumes; the killed prefix and the resumed steps equal the
   uninterrupted losses bit for bit, launches per step exact, replayed
   step included, each save's and restore's bytes and seconds printed;
   ``[train-fault]``: the same run with the plan `FAULT_PLAN` (fw, dp
   and bw) and 3 retries: each guard line names the injected plane and
   step, each recovery is printed, the losses equal the clean run's bit
   for bit and the launches count every replayed step;
   ``[dist-train-resume]``: ``[dist-train]``'s spec at 2 layers, an
   uninterrupted run of 4 steps, one stopped after step 2 with a
   checkpoint in the JAX launcher's global layout (one state, written by
   rank (0, 0) from the parts the ranks send it on the ``ckpt`` plane,
   and read by it, which sends them their parts on the same plane,
   `training.pipeline_state`, with the ``torch_rows`` sidecar), and a
   resume, in one spawn: the resumed steps 2 and 3 equal the
   uninterrupted ones bit for bit on every rank, the replicas hold,
   launches per step exact; the ``ckpt`` plane's bytes a rank at the
   save and at the restore, the bytes on disk against the reckoned
   global state, save and restore seconds, and the manifest's
   fingerprint beside the port's structure's
   (`pipeline_state.global_structs`; the CPU tests hold that to JAX's);
   ``[train-resume-cli]``: ``python -m
   repro_torch.launch.train --smoke --device cuda`` with ``--kill-at
   7`` (exit 17) and then ``--resume``, whose loss lines (the loss bits
   in hex) equal an uninterrupted CLI run's;
12. ``[examples]``: the port's examples on the card, in this process:
   examples/torch_quickstart.py and torch_split_learning.py at their
   own sizes with their asserts (AQ-SGD's final loss below DirectQ's)
   and torch_serve_batched.py ``--tiny`` (every request DONE), their
   seconds and final losses.

B10 at head_dim 160 (stablelm-12b's) is in ``[flash-check]`` (ragged
sweep cases, the tile edges, an odd stride, and stablelm's prefill
(2, 32, 8, 4064, 4096, 160) and a ragged call at a query offset, held
to the float64 formula), its training shape (4, 32, 8, 1024, 1024,
160) with the lse, ``[flash-train-check]`` and the ``[kernel-time]``
rows, where SDPA (``enable_gqa``) is the library time of stablelm's
calls; gemma2-27b's prefill (2, 32, 16, 8160, 8192, 128), local and
global, is in ``[flash-check]`` and ``[kernel-time]``.

The ssm and hybrid families (since their slice): B10 at head_dim 80
(zamba2-2.7b's shared block; the wrapper zero-pads q, k and v to the
hd-96 instance) in ``[flash-check]`` (the sweep's small cases at 80, f32
and bf16, and zamba2's prefill (2, 32, 32, 4064, 4096, 80) held to the
float64 formula; its training shape (4, 32, 32, 1024, 1024, 80) with
the lse), ``[flash-train-check]`` and ``[kernel-time]`` (the bound at
hd 80, ``pad_ms`` the three copies timed apart, SDPA beside);
``[serve-mamba2]``: ``mamba2-1.3b`` at full size (48 layers, d 2048,
64 SSM heads of 64, state 128), batch 8, prompt 2048, 32 decode steps,
2 stage groups, ``--kv-bits 8`` passed through; ``[serve-zamba2]``:
``zamba2-2.7b`` at full width (54 layers in 9 blocks; since the
seeded distributed slice 18 of them, `Z_LAYERS`), batch 2, prompt
4064 into 4096, 32 decode steps, 3 stage groups, kv bits 0; both with
the launches checked exactly (B1 = B2 = steps x boundaries, B3 = B4 =
0, B10 a block for zamba2's prefill and 0 for mamba2), the hop bytes as sent,
the state bytes (ssm + conv) and zamba2's raw KV bytes against their
byte models; ``[serve-mamba2-reference-check]`` and
``[serve-zamba2-reference-check]`` (SMOKE, zamba2 at head_dim 80, card
against CPU, the final states held to PREFILL_ATOL scaled to each
state's magnitude); ``[train-zamba2]``:
the simulated trainer at full width, 12 of 54 layers (2 blocks), 2
stage groups, ``[train]``'s other settings, no remat (its peak, 42.7
GiB, fits: tools/train_memory.py); ``[train-mamba2-reference-check]``,
``[train-zamba2-reference-check]`` (simulated, zamba2 at head_dim 80)
and ``[dist-zamba2-reference-check]`` (the 2 x 2 mesh at SMOKE, the
shared block's copies bit-equal on every stage after every step).
The moe family: ``[serve-deepseek-moe]``
and ``[serve-mixtral]``, each at full width and cut in depth
(`DS_LAYERS`: the dense prefix and 2 MoE layers; `MX_LAYERS`), through
the launcher with ``[serve-gemma2]``'s flags and checks (the prefix's
KV raw); their SMOKE card-against-CPU checks at ``capacity_factor``
1.25 with the 8-bit KV cache, the routing compared past ROUTE_MARGIN
and the uniform decode step's drop case (``-routing``), the card's KV
codes carried on at rounding near-ties (`KVTap`);
``[serve-moe-continuous]``: the launcher's ``--continuous`` run on
deepseek-moe-16b at full width, `DS_LAYERS` deep, ``[serve-continuous]``'s
flags, launches and byte models (the KV pair on the 4 coded layers
alone); ``[serve-moe-continuous-reference-check]`` (SMOKE, raw caches,
streams token for token) and ``[serve-moe-continuous-kv8-reference-check]``
(SMOKE, `continuous_reference_check` with the KV carry);
``[train-moe]``: the simulated trainer at full width, 3 layers, one
worker; ``[train-moe-reference-check]``, ``[dist-moe-reference-check]``
and ``[dist-moe-ep-reference-check]`` (``zero3`` and
``expert_parallel``, the ``ep`` bytes against the byte model).
The audio and vlm families: B10's non-causal calls in
``[flash-check]`` (Sk 1500 off the 32-key tile, Sq past Sk at a query
offset) and ``[kernel-time]`` (whisper's encoder, decoder and cross
prefill calls and pixtral's, `FLASH_PATHS`, held to the float64
formula; whisper's training calls with the lse, `FLASH_TRAIN`);
``[serve-whisper]`` (whisper-small at full size, stub frames, the
encoder inside the timed prefill) and ``[serve-pixtral]`` (pixtral-12b
at full width, `P_LAYERS` of 40 layers, 1024 stub patches ahead of a
3040-token prompt) through the launcher (`media_serve_phase`: launches
exactly, hop, KV and raw cross-cache bytes against their byte models);
their SMOKE card-against-CPU checks with raw and with 8-bit KV (the
card's codes carried at near-ties), the cross caches compared;
``[train-whisper]``: the simulated trainer at full size, 448-token
batches with stub frames; ``[train-whisper-reference-check]``,
``[train-pixtral-reference-check]``, ``[dist-whisper-reference-check]``
(the encoder's copies bit-equal on every stage) and
``[dist-pixtral-reference-check]``.
Every distributed card-against-CPU check runs in one spawn a device
(`DIST_CHECKS`).
ZeRO-3 (since its slice): the distributed trainer shards every stage's
parameters and AdamW moments over its 2 data ranks and gathers each
unit's weights where it runs (`training.pipeline.StageFsdp`, the
``fsdp`` plane).  ``[dist-train]`` and its three variants assert each
rank's ``fsdp`` bytes a step against `training.pipeline.fsdp_gather_bytes`
and its resident parameter and moment bytes against
`training.pipeline.rank_param_bytes`, and print each rank's peak memory
and the step's ``fsdp_gather`` seconds (the gathers' part of the
pipeline phase); the SMOKE checks hold the ``fsdp`` bytes to the model
too; ``[dist-fsdp-check]`` runs `FSDP_CHECKS` (gpt2-xl-paper,
zamba2-2.7b, deepseek-moe-16b in ``zero3`` and ``expert_parallel``,
whisper-small) again on the card in the whole-stage layout in the same
spawn, losses bit for bit; ``[dist-train-resume]`` gathers the ranks'
shards into the one global checkpoint and holds its bytes on disk to
the reckoned global state's.  Since the seeded
distributed slice the gathers come in the JAX package's units (a
``zero3`` MoE layer's experts one at a time, the hybrid's shared block
once a stage call): the checks hold each rank's calls by unit to
`training.pipeline.fsdp_gathers` and ``[dist-fsdp-check]`` prints the
largest gathered buffer beside `fsdp_largest_gather`.  The on-core noise
knob in the distributed trainer: ``[dist-train-oncore]`` is
``[dist-train]``'s spec at `RESUME_LAYERS` (2) of 48 layers with
``ACSGD_ONCORE_PRNG=1``, in ``[dist-train-resume]``'s spawn, whose
uninterrupted run is the same spec without the knob: every B1, B3 and
B5 launch seeded (``oncore_uniform`` equal to their sum), the byte
models, the replicas and the final loss within
`DIST_ONCORE_FINAL_LOSS_RTOL`; ``[dist-seeded-check]`` (SMOKE, the same
spawn): under the knob the psum, ring and ring-sharded wires give
bit-equal losses, the chunked ring (``--dp-chunks 2``, the hop
deterministic) gives the same bits with and without the knob, and a run
stopped after step 2 and resumed gives the unbroken seeded run's
losses; ``[train-resume-oncore]`` is ``[train-resume]`` with the knob,
its children beside ``[train-resume]``'s, bit-equal to its own
unbroken seeded run.  Each phase's line ends with ``at``, its seconds
since the script started.

B9a and B9b launch 0 times on every path but ``[legacy-dp-codec]``:
no trainer or server runs the legacy pair, in the JAX package either.
Then one JSON line with every kernel's numbers (``launches``: the
count on the path its time was taken at, named by ``launches_path``;
each path's own count in ``launches_by_path``, ``serve_continuous``,
``serve_stablelm``, ``serve_gemma2_27b``, ``serve_mamba2``,
``serve_zamba2``, ``serve_deepseek_moe``, ``serve_mixtral``,
``serve_moe_continuous``, ``serve_whisper``, ``serve_pixtral``,
``train_zamba2``, ``train_moe``, ``train_whisper``, ``train_full_depth``,
``train_resume``, ``train_resume_oncore``, ``train_fault``,
``dist_resume`` and ``dist_oncore`` among them), the
card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero; with no CUDA device it exits 1
and prints no result.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
T_START = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12       # H100 SXM dense TF32 on the tensor cores
TF32_PASSES = 3               # B10's hi/lo split: 3 TF32 products a product
SOURCE = "src/repro_torch/kernels/csrc/quant_pack.cu"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = {
    "delta_quantize_pack": "src/repro/kernels/quant_pack.py:190",
    "dequant_unpack_accumulate": "src/repro/kernels/quant_pack.py:239",
    "quantize_pack": "src/repro/kernels/quant_pack.py:278",
    "unpack_dequant": "src/repro/kernels/quant_pack.py:320",
    "quantize_pack_scaled": "src/repro/kernels/quant_pack.py:363",
    "unpack_codes": "src/repro/kernels/quant_pack.py:399",
    "quantize_codes_scaled": "src/repro/kernels/quant_pack.py:480",
    "dequant_sum_mean": "src/repro/kernels/quant_pack.py:434",
    "unpack_accumulate": "src/repro/kernels/quant_pack.py:528",
    "pack_sums": "src/repro/kernels/quant_pack.py:579",
    "unpack_sums": "src/repro/kernels/quant_pack.py:620",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:81",
    "oncore_uniform": "src/repro/kernels/quant_pack.py:84",
}
# the ring's kernels do integer work only; their operations are counted
# against the int32 rate outside the tensor cores, half the f32 rate
# (64 int32 against 128 f32 lanes per SM and clock)
INT32_OPS_PER_S = F32_OPS_PER_S / 2
# float operations per element, counted from the kernels' source
OPS_PER_ELEMENT = {
    "delta_quantize_pack": 14,   # sub abs max | div add mul clip2 rint | pack2 | cvt mul fma
    "dequant_unpack_accumulate": 5,  # shift and cvt mul fma
    "quantize_pack": 10,         # abs max | div add mul clip2 rint | pack2
    "unpack_dequant": 5,         # shift and cvt mul mul
    "quantize_pack_scaled": 9,   # max | div add mul clip2 floor sub cmp add
    "unpack_codes": 2,           # shift and (int32)
    "quantize_codes_scaled": 9,  # max | div add mul clip2 floor sub cmp add
    "dequant_sum_mean": 4,       # cvt mul sub | mul mul
    "unpack_accumulate": 3,      # shift and add (int32)
    "pack_sums": 3,              # and shift or (int32)
    "unpack_sums": 2,            # shift and (int32)
}
INT_KERNELS = ("unpack_accumulate", "pack_sums", "unpack_sums",
               "unpack_codes")
# the seeded encoders' own noise (B11): one Philox4x32-10 call per 4
# elements (10 rounds of 2 mullo, 2 mulhi, 4 xor and, from the second,
# 2 key adds: 98 integer operations), then a shift and a convert a
# word: 26.5 integer operations per element, plus the f32 multiply
PHILOX_INT_OPS_PER_ELEMENT = (98 + 4 * 2) / 4
PHILOX_F32_OPS_PER_ELEMENT = 1
ONCORE_SEEDS = ((0, 0), (1, -2), (2 ** 31 - 1, -2 ** 31))
# the slice (gpt2-xl-paper serving, as the main path drives it)
BATCH, PROMPT, GEN = 8, 128, 32
D_MODEL, KV_HEADS, HEAD_DIM = 1600, 25, 64
CACHE_LEN = PROMPT + GEN
SERVE_ARGS = ["--arch", "gpt2-xl-paper", "--stages", "2", "--mode", "aqsgd",
              "--fw-bits", "4", "--kv-bits", "8", "--batch", str(BATCH),
              "--prompt-len", str(PROMPT), "--gen", str(GEN),
              "--device", "cuda", "--seed", "0"]
# small-input reference check (tests/test_torch_slice.py's tolerances)
PREFILL_ATOL, DECODE_ATOL, MAX_FLIP_FRACTION = 2e-5, 5e-3, 0.005
# the hop's messages (the 4-bit aqsgd hop's m, one row a slot or batch
# row) agree between the card and the CPU to ~4e-6 (their f32 sums run
# in other orders); past HOP_NOISE, a rounding near-tie put one code on
# the other side: one element whose values before rounding, the CPU's
# and the card's, lie within HOP_TIE of a code step of each other and
# round apart (`HopTap`)
HOP_NOISE, HOP_TIE, HOP_BITS = 1e-4, 1e-3, 4
# the 8-bit KV codes of a fresh row agree between the card and the CPU
# but where a rounding near-tie puts one on the other side: its values
# before rounding lie within KV_TIE of a code step of each other
# (`KVTap`, the moe checks, which carry the card's code on).  Fresh
# values of magnitude ~3 that agree within PREFILL_ATOL lie up to
# 255 x 2e-5 / 3 ~ 1.7e-3 of a code step apart before rounding (the
# CPU against itself at weights moved by 1e-8: 6.4e-4 over all codes)
KV_TIE = 5e-3
# the continuous batcher at gpt2-xl-paper full size: 2 x BATCH requests of
# 4-PROMPT tokens (the launcher's draw, numpy seed 1) over CONT_SLOTS
# slots of CACHE_LEN rows, GEN tokens each
CONT_SLOTS, CONT_REQUESTS = 8, 2 * BATCH
CONT_ARGS = ["--arch", "gpt2-xl-paper", "--stages", "2", "--mode", "aqsgd",
             "--fw-bits", "4", "--kv-bits", "8", "--continuous", "--slots",
             str(CONT_SLOTS), "--batch", str(BATCH), "--prompt-len",
             str(PROMPT), "--gen", str(GEN), "--device", "cuda", "--seed",
             "0"]
# its slot guard (tests/test_faults.py's fault test) at full width, cut
# to GUARD_LAYERS of 48 layers: 3 requests over 2 slots, 6 tokens each
GUARD_LAYERS, GUARD_PLAN = 4, "2:kv:nan-scale"
# its card-vs-CPU check: SMOKE models, 5 requests of 3-12 tokens over 3
# slots, 6 tokens each; gemma2 with a window of 4 (per-row windows bite)
CONT_CHECK_WINDOW = {"gpt2-xl-paper": None, "gemma2-9b": 4,
                     "stablelm-12b": None, "gemma2-27b": 4}
# the per-row write heads of gpt2-xl's pool append: at 0, inside, at the
# last row and past the store (clamped to CACHE_LEN - 1)
ROW_HEADS = (0, 5, 77, PROMPT, CACHE_LEN - 1, CACHE_LEN, CACHE_LEN + 40, 3)
# the gemma2-9b serving slice at full width: a prompt past the 4096-key
# window into a cache of the 8192-token context, the first 4 of its 42
# layers (2 local, 2 global): the FSDP slice cut it to 10 for its
# distributed phases (the host spent ~51 s drawing the other 32 at
# ~7.6 s a billion weights), the distributed checkpoint's slice to 4 for
# its one-writer save and [examples] (6 layers, ~1.2e9 weights)
G_BATCH, G_PROMPT, G_GEN = 2, 8160, 32
G_CACHE = G_PROMPT + G_GEN
G_LAYERS, G_D, G_VOCAB = 4, 3584, 256000
G_HEADS, G_KV_HEADS, G_HEAD_DIM, G_WINDOW, G_CAP = 16, 8, 256, 4096, 50.0
GEMMA_ARGS = ["--arch", "gemma2-9b", "--layers", str(G_LAYERS),
              "--stages", "2", "--mode", "aqsgd",
              "--fw-bits", "4", "--kv-bits", "8", "--batch", str(G_BATCH),
              "--prompt-len", str(G_PROMPT), "--gen", str(G_GEN),
              "--device", "cuda", "--seed", "0"]
# the gemma2 reference check: SMOKE, a prompt past its window of 16
G_CHECK_PROMPT, G_CHECK_STEPS = 40, 6
# stablelm-12b served at full width (d 5120, 32 heads on 8 kv heads of
# 160, vocab 100352, an untied head), the first 4 of its 40 layers (the
# run's time: the host draws ~0.3e9 weights a layer; 20 until the audio
# and vlm phases joined): a prompt of 4064 into a cache of its
# 4096-token context
S_BATCH, S_PROMPT, S_GEN = 2, 4064, 32
S_CACHE = S_PROMPT + S_GEN
S_LAYERS, S_D, S_VOCAB = 4, 5120, 100352
S_HEADS, S_KV_HEADS, S_HEAD_DIM = 32, 8, 160
STABLELM_ARGS = ["--arch", "stablelm-12b", "--layers", str(S_LAYERS),
                 "--stages", "2", "--mode",
                 "aqsgd", "--fw-bits", "4", "--kv-bits", "8", "--batch",
                 str(S_BATCH), "--prompt-len", str(S_PROMPT), "--gen",
                 str(S_GEN), "--device", "cuda", "--seed", "0"]
# gemma2-27b at full width (d 4608, 32 heads on 16 kv heads of 128,
# d_ff 36864, vocab 256000) cut to the first G27_LAYERS of its 46
# layers (local and global layers alternate, so an even count).  The
# most the card holds with 2 GiB of headroom is 28: serving it at batch
# 2, prompt 8160 into a cache of 8192 peaks at 17.371 GiB at 2 layers
# and 21.719 at 4 on the H100 (tools/serve_memory.py; 2.174 GiB a
# layer: 2.109 of weights, 0.064 of 8-bit KV stores), so 73.9 GiB at 28
# and 78.3 at 30 of the card's 79.18.  chip_smoke runs 2 (28 until the
# fault-tolerance phases joined, 8 until the audio and vlm phases did):
# the host draws ~0.57e9 weights a layer, and the whole run must stay
# inside its 1200 s
G27_LAYERS, G27_D = 2, 4608
G27_HEADS, G27_KV_HEADS, G27_HEAD_DIM = 32, 16, 128
G27_ARGS = ["--arch", "gemma2-27b", "--layers", str(G27_LAYERS), "--stages",
            "2", "--mode", "aqsgd", "--fw-bits", "4", "--kv-bits", "8",
            "--batch", str(G_BATCH), "--prompt-len", str(G_PROMPT), "--gen",
            str(G_GEN), "--device", "cuda", "--seed", "0"]


# the ssm and hybrid families at full size.  mamba2-1.3b (48 layers, d
# 2048, d_inner 4096, 64 SSM heads of 64, state 128, vocab 50280,
# 1.34e9 parameters): batch 8, a prompt of 2048 (the Mamba2 paper's
# training context), 32 decode steps, 2 stage groups, the 4-bit hop and
# --kv-bits 8, which passes through (no KV cache).  zamba2-2.7b (54
# layers in 9 blocks of 6, d 2560, the shared block's 32 heads of 80 and
# d_ff 10240, vocab 32000, 2.34e9): batch 2, a prompt of 4064 into a
# cache of 4096, 32 decode steps, 3 stage groups of 3 blocks (2 hop
# boundaries), kv bits 0 (JAX's rule for the shared block).  State
# bytes (ssm + conv, f32): 805,306,368 + 20,054,016 and 141,557,760 +
# 6,801,408, whatever the prompt's length.  Since the seeded
# distributed phases joined, zamba2 serves 18 of its 54 layers
# (`Z_LAYERS`: 3 blocks, one a stage group, as [serve-hybrid-continuous])
# so the run stays inside its 1200 s: the host drew 2.34e9 weights
# (20.3 s) for it
M_BATCH, M_PROMPT, M_GEN, M_STAGES = 8, 2048, 32, 2
Z_BATCH, Z_PROMPT, Z_GEN, Z_STAGES, Z_LAYERS = 2, 4064, 32, 3, 18
Z_CACHE = Z_PROMPT + Z_GEN
Z_HEADS, Z_HEAD_DIM = 32, 80
MAMBA_ARGS = ["--arch", "mamba2-1.3b", "--stages", str(M_STAGES), "--mode",
              "aqsgd", "--fw-bits", "4", "--kv-bits", "8", "--batch",
              str(M_BATCH), "--prompt-len", str(M_PROMPT), "--gen",
              str(M_GEN), "--device", "cuda", "--seed", "0"]
ZAMBA_ARGS = ["--arch", "zamba2-2.7b", "--layers", str(Z_LAYERS),
              "--stages", str(Z_STAGES), "--mode",
              "aqsgd", "--fw-bits", "4", "--kv-bits", "0", "--batch",
              str(Z_BATCH), "--prompt-len", str(Z_PROMPT), "--gen",
              str(Z_GEN), "--device", "cuda", "--seed", "0"]
# tag -> (arch, launcher args, batch, prompt, decode steps, stage groups,
# layers served or None for all)
SSM_CELLS = {
    "serve-mamba2": ("mamba2-1.3b", MAMBA_ARGS, M_BATCH, M_PROMPT, M_GEN,
                     M_STAGES, None),
    "serve-zamba2": ("zamba2-2.7b", ZAMBA_ARGS, Z_BATCH, Z_PROMPT, Z_GEN,
                     Z_STAGES, Z_LAYERS),
}
# their SMOKE card-vs-CPU checks: a prompt past SMOKE's chunk of 32, 6
# decode steps; zamba2 at head_dim 80, so the card's hd-80 B10 path runs
SSM_CHECK_PROMPT, SSM_CHECK_STEPS = 40, 6
SSM_CHECK_CFG = {"mamba2-1.3b": {}, "zamba2-2.7b": {"head_dim": Z_HEAD_DIM}}
# [train-zamba2]: the simulated trainer at full width, 12 of 54 layers (2
# blocks, 665e6 parameters), 2 stage groups, [train]'s other settings
TZ_LAYERS, TZ_STAGES = 12, 2
M_D, Z_D = 2048, 2560
# the hops the new serving paths send (a decode step's rows), and
# [train-zamba2]'s DP bucket (665,444,160 parameters in 512-wide rows)
SSM_HOPS = ((M_BATCH, M_D), (Z_BATCH, Z_D))
TZ_BUCKET = (1299696, 512)


def ssm_state_bytes(cfg, batch, conv_itemsize=4) -> tuple:
    """The byte model of an ssm or hybrid model's serving state: the
    ``ssm`` states (L, B, h, p, n) f32 and ``conv`` windows (L, B,
    width-1, d_inner + 2 g n), f32 (a uniform batch's) or bf16 (the
    batcher's pool: ``conv_itemsize`` 2)."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return (cfg.num_layers * batch * cfg.ssm_heads * cfg.ssm_headdim
            * cfg.ssm_state * 4,
            cfg.num_layers * batch * (cfg.ssm_conv_width - 1) * conv_dim
            * conv_itemsize)


def cell_launches(gen, layers, coded=None):
    """The launches of one uniform-batch serve at 2 stage groups: the
    hop once a decode step (B1, B2); B3 and B4 (k and v in one launch
    each) on every step of every layer whose KV is coded (``coded``, all
    ``layers`` by default; a MoE model's dense prefix keeps raw k and v);
    B10 on every layer of the prefill."""
    coded = layers if coded is None else coded
    return {"delta_quantize_pack": gen, "dequant_unpack_accumulate": gen,
            "quantize_pack": (1 + gen) * coded,
            "unpack_dequant": (1 + gen) * coded,
            "quantize_pack_scaled": 0, "unpack_codes": 0,
            "quantize_codes_scaled": 0, "dequant_sum_mean": 0,
            "unpack_accumulate": 0, "pack_sums": 0, "unpack_sums": 0,
            "flash_attention_fwd": layers, "oncore_uniform": 0}


# the full-size serving cells: tag -> (launcher args, batch, prompt,
# cache, decode steps, layers, d_model, vocab, kv heads, head_dim)
SERVE_CELLS = {
    "serve-gemma2": (GEMMA_ARGS, G_BATCH, G_PROMPT, G_CACHE, G_GEN, G_LAYERS,
                     G_D, G_VOCAB, G_KV_HEADS, G_HEAD_DIM),
    "serve-stablelm": (STABLELM_ARGS, S_BATCH, S_PROMPT, S_CACHE, S_GEN,
                       S_LAYERS, S_D, S_VOCAB, S_KV_HEADS, S_HEAD_DIM),
    "serve-gemma2-27b": (G27_ARGS, G_BATCH, G_PROMPT, G_CACHE, G_GEN,
                         G27_LAYERS, G27_D, G_VOCAB, G27_KV_HEADS,
                         G27_HEAD_DIM),
}
# each new arch's SMOKE card-vs-CPU serving check: prompt, decode steps
# (gemma2-27b's prompt past SMOKE's window of 16)
SERVE_CHECKS = {"stablelm-12b": (8, 6), "gemma2-27b": (G_CHECK_PROMPT,
                                                       G_CHECK_STEPS)}
# the moe family at full width, the depth cut (the host draws ~7 s a
# billion weights): deepseek-moe-16b (d 2048, 16 heads of 128, 64 routed
# experts of 1408 top-6 and 2 shared, the first layer dense, vocab
# 102400) at 3 of its 28 layers (the dense prefix and 2 MoE layers,
# 1.469e9 parameters; 5 until the audio and vlm phases joined), batch
# 2, a prompt of 4064 into 4096; mixtral-8x22b
# (d 6144, 48 heads on 8 kv heads of 128, 8 experts of 16384 top-2, a
# 4096-token window, an untied head, vocab 32768) at 2 of its 56 layers
# (5.41e9), batch 2, a prompt of 8160 into 8192, so the window cuts;
# both 32 decode steps in 2 stage groups over the MoE layers, the 4-bit
# hop and 8-bit KV (the dense prefix's k and v raw, JAX's rule)
DS_LAYERS, DS_D, DS_VOCAB, DS_HEADS = 3, 2048, 102400, 16
MX_LAYERS, MX_D, MX_VOCAB, MX_HEADS, MX_KV_HEADS = 2, 6144, 32768, 48, 8
MOE_HEAD_DIM, MX_WINDOW = 128, 4096
DEEPSEEK_ARGS = ["--arch", "deepseek-moe-16b", "--layers", str(DS_LAYERS),
                 "--stages", "2", "--mode", "aqsgd", "--fw-bits", "4",
                 "--kv-bits", "8", "--batch", str(S_BATCH), "--prompt-len",
                 str(S_PROMPT), "--gen", str(S_GEN), "--device", "cuda",
                 "--seed", "0"]
MIXTRAL_ARGS = ["--arch", "mixtral-8x22b", "--layers", str(MX_LAYERS),
                "--stages", "2", "--mode", "aqsgd", "--fw-bits", "4",
                "--kv-bits", "8", "--batch", str(G_BATCH), "--prompt-len",
                str(G_PROMPT), "--gen", str(G_GEN), "--device", "cuda",
                "--seed", "0"]
# the continuous batcher on deepseek-moe-16b at full width, DS_LAYERS
# deep, through the launcher as CONT_ARGS drives gpt2-xl: the pooled step
# dispatching a row at a time, the trunk's 8-bit KV, the prefix's raw
# pk/pv at per-row heads and the 4-bit hop
MOE_CONT_ARGS = ["--arch", "deepseek-moe-16b", "--layers", str(DS_LAYERS),
                 *CONT_ARGS[2:]]
SERVE_CELLS.update({
    "serve-deepseek-moe": (DEEPSEEK_ARGS, S_BATCH, S_PROMPT, S_CACHE, S_GEN,
                           DS_LAYERS, DS_D, DS_VOCAB, DS_HEADS,
                           MOE_HEAD_DIM),
    "serve-mixtral": (MIXTRAL_ARGS, G_BATCH, G_PROMPT, G_CACHE, G_GEN,
                      MX_LAYERS, MX_D, MX_VOCAB, MX_KV_HEADS, MOE_HEAD_DIM),
})
# their SMOKE card-vs-CPU checks at capacity_factor 1.25 (the full
# configs'; SMOKE's 8 never drops): a prompt of 8 (mixtral's: 40, past
# SMOKE's window of 16), 6 decode steps; the routing compared exactly
# wherever the CPU's k-th and (k+1)-th router probabilities lie more than
# ROUTE_MARGIN apart; then the uniform decode step's drop case, at 8
# experts (capacity ceil(2 k / 8 x 1.25) = 1 over the step's 2 rows)
MOE_CHECKS = {"deepseek-moe-16b": ("serve-deepseek-moe-reference-check", 8,
                                  6),
              "mixtral-8x22b": ("serve-mixtral-reference-check",
                                G_CHECK_PROMPT, G_CHECK_STEPS)}
ROUTE_MARGIN = 1e-5
# the audio and vlm families.  whisper-small at full size (12 encoder
# and 12 decoder layers, d 768, 12 heads of 64, d_ff 3072, vocab 51865,
# 2.38e8 parameters): batch 8, a prompt of 128 into a cache of 160, 32
# decode steps, 2 stage groups over the decoder, the 4-bit hop, 8-bit KV
# on the decoder's self-attention and the raw f32 cross caches of the
# 1500 stub frames.  B10 runs 36 times in the prefill: 12 encoder calls
# (8, 12, 12, 1500, 1500, 64) non-causal, 12 causal over the cache and
# 12 cross calls (8, 12, 12, 128, 1500, 64) non-causal.  pixtral-12b at
# full width (d 5120, 32 heads on 8 kv heads of 128, d_ff 14336, vocab
# 131072, RoPE theta 1e9, an untied head) cut to P_LAYERS of its 40
# layers (2.43e9 parameters; the host draws ~7 s a billion): batch 2,
# its 1024 stub patches and a prompt of 3040, a trunk of 4064 rows in a
# cache of 4096, 32 decode steps, 2 stage groups, 4-bit hop, 8-bit KV
W_BATCH, W_PROMPT, W_GEN, W_LAYERS, W_D, W_VOCAB = 8, 128, 32, 12, 768, \
    51865
W_HEADS, W_HEAD_DIM, W_FRAMES = 12, 64, 1500
W_CACHE = W_PROMPT + W_GEN
P_BATCH, P_PROMPT, P_GEN, P_LAYERS, P_PATCHES = 2, 3040, 32, 4, 1024
P_D, P_VOCAB, P_HEADS, P_KV_HEADS, P_HEAD_DIM = 5120, 131072, 32, 8, 128
P_TRUNK = P_PATCHES + P_PROMPT
P_CACHE = P_TRUNK + P_GEN
WHISPER_ARGS = ["--arch", "whisper-small", "--stages", "2", "--mode",
                "aqsgd", "--fw-bits", "4", "--kv-bits", "8", "--batch",
                str(W_BATCH), "--prompt-len", str(W_PROMPT), "--gen",
                str(W_GEN), "--device", "cuda", "--seed", "0"]
PIXTRAL_ARGS = ["--arch", "pixtral-12b", "--layers", str(P_LAYERS),
                "--stages", "2", "--mode", "aqsgd", "--fw-bits", "4",
                "--kv-bits", "8", "--batch", str(P_BATCH), "--prompt-len",
                str(P_PROMPT), "--gen", str(P_GEN), "--device", "cuda",
                "--seed", "0"]
# tag -> (arch, launcher args, batch, prompt, cache, decode steps, layers)
MEDIA_CELLS = {
    "serve-whisper": ("whisper-small", WHISPER_ARGS, W_BATCH, W_PROMPT,
                      W_CACHE, W_GEN, W_LAYERS),
    "serve-pixtral": ("pixtral-12b", PIXTRAL_ARGS, P_BATCH, P_PROMPT,
                      P_CACHE, P_GEN, P_LAYERS),
}
MEDIA_HOPS = ((W_BATCH, W_D), (P_BATCH, P_D))
# their SMOKE card-vs-CPU checks: a prompt of 8 (whisper's 32 stub frames,
# pixtral's 16 patches ahead of it), 6 decode steps, raw KV and 8-bit KV
# with the card's codes carried at near-ties
MEDIA_CHECK_PROMPT, MEDIA_CHECK_STEPS = 8, 6


def cont_args(arch, *, layers=0, stages=2, kv_bits=8) -> list:
    """The launcher's --continuous run of ``arch`` on `CONT_ARGS`'s
    stream: CONT_REQUESTS requests of 4-PROMPT tokens over CONT_SLOTS
    slots, GEN tokens each, ``stages`` stage groups with the 4-bit aqsgd
    hop, ``kv_bits``-bit KV, the first ``layers`` layers (0: all)."""
    return ["--arch", arch, *(["--layers", str(layers)] if layers else []),
            "--stages", str(stages), "--mode", "aqsgd", "--fw-bits", "4",
            "--kv-bits", str(kv_bits), "--continuous", "--slots",
            str(CONT_SLOTS), "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), "--device", "cuda", "--seed",
            "0"]


# the continuous batcher on the ssm, hybrid, audio and vlm families through
# the launcher's --continuous, [serve-continuous]'s stream: mamba2-1.3b at
# full size (--kv-bits 8 passes through: no KV); zamba2-2.7b at full width
# cut to ZC_LAYERS of its 54 layers (3 of 9 blocks, for the host's weight
# draw), 3 stage groups as [serve-zamba2], raw k and v (--kv-bits 0, JAX's
# rule); whisper-small at full size and pixtral-12b at P_LAYERS of 40, both
# 8-bit KV.  The JAX batcher passes no frames or patches, so whisper's cross
# caches stay zero and pixtral serves text in a cache num_patches rows
# longer; the pool's raw leaves (conv windows, the hybrid's k and v, the
# cross caches) are bf16, the launcher's dtype.  tag -> [(arch, args)]
ZC_LAYERS, ZC_STAGES = 18, 3
FAMILY_CONT = {
    "serve-ssm-continuous": [("mamba2-1.3b", cont_args("mamba2-1.3b"))],
    "serve-hybrid-continuous": [("zamba2-2.7b", cont_args(
        "zamba2-2.7b", layers=ZC_LAYERS, stages=ZC_STAGES, kv_bits=0))],
    "serve-media-continuous": [
        ("whisper-small", cont_args("whisper-small")),
        ("pixtral-12b", cont_args("pixtral-12b", layers=P_LAYERS))],
}
# their SMOKE card-vs-CPU checks: config fields replaced (zamba2 at
# head_dim 80, so the card's hd-80 B10 path reads the pool's bf16 k and v)
FAMILY_CONT_CHECKS = {"mamba2-1.3b": {},
                      "zamba2-2.7b": {"head_dim": Z_HEAD_DIM},
                      "whisper-small": {}, "pixtral-12b": {}}
# [train-whisper]: the simulated trainer at full size, batch 8 x 448
# tokens (whisper's decoder context) with stub frames (8, 1500, 768), 2
# stage groups over the decoder, [train]'s other settings (aqsgd fw 4 /
# bw 8 stochastic, the 4-bit ring over 2 workers, 6 steps); a worker's
# boundary rows and the DP bucket (238,060,800 parameters in 512-wide
# rows)
TW_SEQ, TW_STAGES = 448, 2
TW_ROWS = (4 * TW_SEQ, W_D)             # a worker's 4 of the 8 rows
TW_BUCKET = (464963, 512)
# B10 against its plain version: tests/test_flash_kernel.py's tolerances
# (rtol = atol) at the sweep's shapes; at the paths' shapes (up to 8192
# keys a row, a softmax summed in another order) a bound set before the
# first run on the card
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_PATH_TOL = 1e-4
# the training slice (gpt2-xl-paper at full width, 12 of 48 layers)
TRAIN_LAYERS, TRAIN_STAGES, TRAIN_WORKERS = 12, 4, 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_SAMPLES, TRAIN_STEPS = 8, 1024, 16, 6
DP_BUCKET = (877132, 512)      # 449,091,200 parameters in 512-wide rows
TRAIN_ROWS = (TRAIN_BATCH // TRAIN_WORKERS * TRAIN_SEQ, D_MODEL)  # a worker
TZ_ROWS = (TRAIN_ROWS[0], Z_D)          # a [train-zamba2] worker
# the hops the moe serving cells send (a decode step's rows), and
# [train-moe]: deepseek-moe-16b at full width, 3 of 28 layers (the dense
# prefix and 2 MoE layers, 1.47e9 parameters), 2 stage groups over the
# MoE layers, one worker and no DP plane ([train]'s other settings: at
# ~60 B a parameter the ring's copies would need ~82 GiB), so a boundary
# carries the whole batch's 8 x 1024 rows
MOE_HOPS = ((S_BATCH, DS_D), (G_BATCH, MX_D))
TM_LAYERS, TM_STAGES = 3, 2
TM_ROWS = (TRAIN_BATCH * TRAIN_SEQ, DS_D)
# the encoders' tiling edges past 256 values (quant_pack._encode_tiling: a
# block a row): the first width a block takes, the hops' (gpt2-xl's,
# mamba2-1.3b's and deepseek-moe-16b's, zamba2-2.7b's, gemma2-9b's,
# gemma2-27b's, stablelm-12b's and mixtral-8x22b's d_model), and the first width past the register cap
# (8192 values), which the block walks twice; 1 and 5 rows each
WIDE_ROWS = [(r, d) for d in (260, 1600, 2048, 2560, 3584, 4608, 5120, 6144,
                            8196)
             for r in (1, 5)]
# kernel launches per training step: 3 boundaries x 2 workers forward
# (sender) and backward (gradient round trip); per worker one DP sender
# and one n=1 decode for its carry, plus the n=2 mean; B10 once a layer
# a worker (`train_phase` doubles it with remat: once more a layer in
# the recompute)
TRAIN_LAUNCHES_PER_STEP = {"delta_quantize_pack": 6,
                           "dequant_unpack_accumulate": 0,
                           "quantize_pack": 6, "unpack_dequant": 6,
                           "quantize_pack_scaled": 0, "unpack_codes": 0,
                           "quantize_codes_scaled": 2,
                           "dequant_sum_mean": 3,
                           "flash_attention_fwd": TRAIN_LAYERS
                           * TRAIN_WORKERS}
# [train-full-depth]: [train]'s settings with remat, at the most layers
# (in multiples of the 4 stage groups) that the card holds: the step's
# peak sits in the DP wire, 5.14 + 1.725 GiB a layer (tools/
# train_memory.py on the H100), 74.1 GiB at 40 layers and 81.0 at 44
# against the card's 79.2
FULL_DEPTH_LAYERS = 40
DP_KERNELS = ("quantize_codes_scaled", "dequant_sum_mean")
# the gradient wire's legacy pair (B9a, B9b): on no path of either
# package but tests/test_grad_compress.py's chain, which [legacy-dp-codec]
# drives at the training path's bucket for two workers
LEGACY_KERNELS = ("quantize_pack_scaled", "unpack_codes")
LEGACY_WORKERS, LEGACY_BITS, LEGACY_SCALE = 2, 4, 1.3
# [train-oncore]: the [train] run with ACSGD_ONCORE_PRNG=1, where every
# stochastic encode (B1, B3, B5) draws its noise in the kernel; its
# final loss against [train]'s (other rounding noise, same weights and
# data), a bound set before the first run on the card
ONCORE_ENCODERS = ("delta_quantize_pack", "quantize_pack",
                   "quantize_codes_scaled")
ONCORE_FINAL_LOSS_RTOL = 2e-2
# 10k-trial unbiasedness (tests/test_grad_compress.py's 5 sigma harness)
STATS_TRIALS = 10_000
# training reference check (tests/test_torch_train.py's tolerances)
FIRST_STEP_RTOL, LATER_STEP_RTOL = 1e-5, 1e-3
# the distributed slice (gpt2-xl-paper at full width, 8 of 48 layers,
# a 2 x 2 mesh of processes on the one card)
DIST_LAYERS, DIST_DATA, DIST_STAGES, DIST_MICRO = 8, 2, 2, 2
DIST_BATCH, DIST_SEQ, DIST_SAMPLES, DIST_STEPS = 8, 512, 16, 4
DIST_BUCKET = (637107, 512)    # 326,198,400 parameters in 512-wide rows
DIST_SEG = 318554              # its ring segment over 2 data ranks
DIST_TIMEOUT = 600
# launches summed over the 4 ranks and 4 steps (2 warm-up, 2 compressed):
# per compressed step and data rank, each microbatch crosses the one
# boundary once forward (B1 at stage 0, B2 at stage 1) and once backward
# (B3 at stage 1, B4 at stage 0); per step every rank runs the ring:
# B5 (pack) once, B6 twice (carry n=1, mean n=2), B7 once (D-1 hops),
# B8a and B8b once.  B10: under the pipeline's nested remat a stage of
# n = 4 layers runs 3n - 1 = 11 attention forwards a microbatch (the
# forward; the stage's recompute, which stops once it has recomputed
# the last layer's input; each layer's own recompute), on every rank,
# microbatch and step
# the rest of the DP wires and the optimizer on [dist-train]'s spec (the
# model draws the same weights from the seed in each): the ZeRO wire's
# dp plane, ring_wire_bytes(DIST_BUCKET, 4, 2, sharded=True); its
# parameter all-gather, one f32 segment of DIST_SEG rows to the one peer;
# the fp16 wire's one f16 all-reduce of the bucket
DIST_SHARDED_BYTES = 84_098_252
DIST_GATHER_BYTES = DIST_SEG * 512 * 4          # 652,398,592
DIST_FP16_BYTES = DIST_BUCKET[0] * 512 * 2      # 652,397,568
# the variants' launcher flags and optimizer fields beside [dist-train]'s
DIST_VARIANTS = {"dist-train": ([], {}),
                 "dist-train-sharded": (["--dp-wire", "ring-sharded"], {}),
                 "dist-train-fp16": (["--dp-wire", "fp16"], {}),
                 "dist-train-adam8": ([], {"state_bits": 8})}
# [dist-train-adam8]'s losses against [dist-train]'s (8-bit moments move
# the updates from step 2 on; step 1 is before any update), a bound set
# before the first run on the card
ADAM8_LOSS_RTOL = 2e-2
DIST_LPS = DIST_LAYERS // DIST_STAGES
DIST_LAUNCHES = {"delta_quantize_pack": 8, "dequant_unpack_accumulate": 8,
                 "quantize_pack": 8, "unpack_dequant": 8,
                 "quantize_pack_scaled": 0, "unpack_codes": 0,
                 "quantize_codes_scaled": 16, "dequant_sum_mean": 32,
                 "unpack_accumulate": 16, "pack_sums": 16,
                 "unpack_sums": 16,
                 "flash_attention_fwd": DIST_DATA * DIST_STAGES
                 * DIST_STEPS * DIST_MICRO * (3 * DIST_LPS - 1)}
# fault tolerance: [train]'s and [dist-train]'s settings at full width,
# the depth cut to 2 layers in 2 stage groups (one boundary), so a
# checkpoint holds 141,859,200 parameters: 2.94 GB a simulated state,
# ~1.96 GB a distributed rank
RESUME_LAYERS, RESUME_STAGES, RESUME_STEPS = 2, 2, 6
RESUME_SAVE_EVERY, RESUME_KILL_AT, RESUME_KEEP = 2, 4, 2
FAULT_PLAN = "2:fw:drop-hop,3:dp:nan-scale,5:bw:corrupt-codes"
FAULT_RETRIES = 3
# the steps the fault run executes: 0, 1, 2 (fw trips, back to 2), 2,
# 3 (dp trips, back to 2), 2, 3, 4, 5 (bw trips, back to 4), 4, 5
FAULT_STEPS_RUN = 11
CKPT_ROOT = os.path.join(ROOT, "results", "chip_smoke_ckpt")
# [dist-train-oncore]'s final loss against the same spec without the
# knob (2 layers: [dist-train-resume]'s uninterrupted run), a bound set
# before the first run on the card, as [train-oncore]'s
DIST_ONCORE_FINAL_LOSS_RTOL = 2e-2
# [dist-seeded-check]: SMOKE runs of the 2 x 2 mesh under the knob, 2
# warm-up and 2 compressed steps, (tag, DP wire, chunks, knob, hop
# stochastic, checkpoint role)
SEEDED_STEPS = 4
SEEDED_RUNS = [("psum", "psum", 1, "1", True, None),
               ("ring", "ring", 1, "1", True, None),
               ("ring-sharded", "ring-sharded", 1, "1", True, None),
               ("chunks2-knob", "ring", 2, "1", False, None),
               ("chunks2", "ring", 2, "0", False, None),
               ("stop", "ring", 1, "1", True, "stop"),
               ("resume", "ring", 1, "1", True, "resume")]
# [train-resume-cli]: the launcher at SMOKE size on the card
CLI_ARGS = ["--smoke", "--device", "cuda", "--stages", "2", "--steps", "12",
            "--batch", "4", "--samples", "16", "--seq", "32", "--mode",
            "aqsgd", "--fw-bits", "4", "--bw-bits", "8", "--dp-grad-bits",
            "4", "--dp-wire", "ring"]


def phase(tag: str, **kv) -> None:
    """Print a phase's line, ``at`` its seconds since the script
    started."""
    kv["at"] = f"{time.perf_counter() - T_START:.1f}"
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(torch, name, rows, d, bits, *, seed, stochastic=False, n=1):
    """Positional arguments of one kernel call (``n``: workers summed
    into a dequant_sum_mean input)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    scale_rows = torch.logspace(-3, 2, rows, device="cuda")[:, None]

    def normal():
        return torch.randn(rows, d, generator=g, device="cuda") * scale_rows

    u = torch.rand(rows, d, generator=g, device="cuda") if stochastic \
        else None
    if name in ("quantize_codes_scaled", "quantize_pack_scaled"):
        x = normal()
        x[0] = 0.0
        s = x.abs().amax(-1, keepdim=True) \
            * (1.0 + torch.rand(rows, 1, generator=g, device="cuda"))
        s[min(1, rows - 1)] = 0.0                    # clamps to 1e-12
        return x, s, u
    if name == "dequant_sum_mean":
        hi = n * ((1 << bits) - 1) + 1
        total = torch.randint(0, hi, (rows, d), generator=g, device="cuda",
                              dtype=torch.int32)
        scale = torch.rand(rows, 1, generator=g, device="cuda") + 1e-3
        scale[min(1, rows - 1)] = 0.0
        return total, scale
    if name == "unpack_codes":
        return (torch.randint(0, 256, (rows, d * bits // 8), generator=g,
                              device="cuda", dtype=torch.uint8),)
    if name == "unpack_accumulate":
        packed = torch.randint(0, 256, (rows, d * bits // 8), generator=g,
                               device="cuda", dtype=torch.uint8)
        acc = torch.randint(0, 1 << 20, (rows, d), generator=g,
                            device="cuda", dtype=torch.int32)
        return packed, acc
    if name == "pack_sums":
        hi = min(n * ((1 << bits) - 1), 2 ** 31 - 2) + 1
        return (torch.randint(0, hi, (rows, d), generator=g, device="cuda",
                              dtype=torch.int32),)
    if name == "unpack_sums":
        from repro_torch.core import quantization as Q
        return (torch.randint(0, 256, (rows, Q.sum_packed_width(d, bits, n)),
                              generator=g, device="cuda",
                              dtype=torch.uint8),)
    if name == "delta_quantize_pack":
        m = normal()
        a = m + normal()
        a[0] = m[0]                                  # an all-zero delta row
        return a, m, u
    if name == "quantize_pack":
        x = normal()
        x[0] = 0.0
        return x, u
    packed = torch.randint(0, 256, (rows, d * bits // 8), generator=g,
                           device="cuda", dtype=torch.uint8)
    scale = torch.rand(rows, 1, generator=g, device="cuda") + 1e-3
    if name == "dequant_unpack_accumulate":
        return packed, scale, normal()
    return packed, scale


def _plain(ref, name):
    return {
        "delta_quantize_pack":
            lambda a, m, u=None, *, bits: ref.delta_quantize_pack_ref(
                a, m, bits, u),
        "dequant_unpack_accumulate":
            lambda p, s, m, *, bits: ref.dequant_unpack_accumulate_ref(
                p, s, m, bits),
        "quantize_pack":
            lambda x, u=None, *, bits: ref.quantize_pack_ref(x, bits, u),
        "unpack_dequant":
            lambda p, s, *, bits, **kw: ref.unpack_dequant_ref(p, s, bits,
                                                               **kw),
        "quantize_pack_scaled":
            lambda x, s, u=None, *, bits:
                ref.quantize_pack_scaled_ref(x, s, bits, u),
        "unpack_codes": lambda p, *, bits: ref.unpack_codes_ref(p, bits),
        "quantize_codes_scaled":
            lambda x, s, u=None, *, bits, pack=False:
                ref.quantize_codes_scaled_ref(x, s, bits, u, pack),
        "dequant_sum_mean":
            lambda t, s, *, bits, n: ref.dequant_sum_mean_ref(t, s, bits, n),
        "unpack_accumulate":
            lambda p, a, *, bits: ref.unpack_accumulate_ref(p, a, bits),
        "pack_sums": lambda t, *, bits, n: ref.pack_sums_ref(t, bits, n),
        "unpack_sums": lambda p, *, bits, n: ref.unpack_sums_ref(p, bits, n),
    }[name]


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def check_bit_exact(torch, qp, ref, name, rows, d, bits, **kw):
    """Kernel vs plain version on the same inputs (``offset``: the
    kernel gets misaligned copies of them, its scalar path); returns
    max |diff|."""
    stochastic = kw.pop("stochastic", False)
    offset = kw.pop("offset", False)
    args = _inputs(torch, name, rows, d, bits, seed=rows + d + bits,
                   stochastic=stochastic, n=kw.get("n", 1))
    call = [_misaligned(torch, t) for t in args] if offset else args
    got = _outs(getattr(qp, name)(*call, bits=bits, **kw))
    want = _outs(_plain(ref, name)(*args, bits=bits, **kw))
    torch.cuda.synchronize()
    err = 0.0
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and g_.dtype == w_.dtype, \
            (name, g_.shape, w_.shape, g_.dtype, w_.dtype)
        if not torch.equal(g_, w_):
            bad = (g_ != w_).sum().item()
            raise AssertionError(f"{name} rows={rows} d={d} bits={bits} "
                                 f"{kw} stochastic={stochastic} "
                                 f"offset={offset}: {bad} "
                                 f"elements differ from the plain version")
        err = max(err, (g_.double() - w_.double()).abs().max().item())
    return err


def _bytes(args, outs) -> int:
    return sum(t.numel() * t.element_size()
               for t in list(args) + list(outs) if t is not None)


def device_ms(torch, fn, arg_sets, launches: int = 40, reps: int = 5):
    """Median device time of one call: a CUDA graph of ``launches``
    back-to-back calls cycling over ``arg_sets`` (distinct inputs, so a
    large call reads from device memory, not L2), replayed ``reps``
    times between CUDA events.  The graph keeps every call's outputs,
    so callers pass fewer launches for calls of gigabytes."""
    for args in arg_sets:                       # warm-up, outside capture
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    keep = []
    with torch.cuda.graph(graph):
        for i in range(launches):
            keep.append(fn(*arg_sets[i % len(arg_sets)]))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph, keep
    return statistics.median(times)


def _library(torch, name, bits, n):
    """One PyTorch call that computes the kernel's function at these
    widths, or None.  At a sum width of 8 bits the sum packer is a
    narrowing cast and the unpacker a widening one; at 8 bits the code
    unpacker is that widening cast too."""
    from repro_torch.core import quantization as Q
    if name in ("pack_sums", "unpack_sums") \
            and Q.sum_wire_bits(bits, n) == 8:
        dtype = torch.uint8 if name == "pack_sums" else torch.int32
        return lambda x: x.to(dtype)
    if name == "unpack_codes" and bits == 8:
        return lambda x: x.to(torch.int32)
    return None


def time_kernel(torch, qp, ref, name, rows, d, bits, stochastic=False,
                **kw):
    """(ms, plain_ms, library_ms, bound_ms, bound_by, bytes) at one
    main-path shape (``kw``: the call's other keywords, as the main path
    passes them); library_ms is None where no one PyTorch call computes
    the same function (`_library`), whose result is checked equal to
    the kernel's before it is timed."""
    one = _inputs(torch, name, rows, d, bits, seed=1, stochastic=stochastic,
                  n=kw.get("n", 1))
    outs = _outs(getattr(qp, name)(*one, bits=bits, **kw))
    library = _library(torch, name, bits, kw.get("n", 1))
    if library is not None and not torch.equal(library(*one), outs[0]):
        raise AssertionError(f"{name}: the library call differs from the "
                             f"kernel")
    nbytes = _bytes(one, outs)
    n_sets = max(1, min(16, math.ceil(120e6 / nbytes)))   # > 50 MB of L2
    sets = [one] + [_inputs(torch, name, rows, d, bits, seed=2 + i,
                            stochastic=stochastic, n=kw.get("n", 1))
                    for i in range(n_sets - 1)]
    launches = 40 if nbytes < 1e9 else 4
    ms = device_ms(torch, lambda *a: getattr(qp, name)(*a, bits=bits, **kw),
                   sets, launches)
    plain = _plain(ref, name)
    plain_ms = device_ms(torch, lambda *a: plain(*a, bits=bits, **kw), sets,
                         launches)
    library_ms = None if library is None else \
        device_ms(torch, library, sets, launches)
    del sets, one, outs
    torch.cuda.empty_cache()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rate = INT32_OPS_PER_S if name in INT_KERNELS else F32_OPS_PER_S
    ops_ms = rows * d * OPS_PER_ELEMENT[name] / rate * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return ms, plain_ms, library_ms, max(bytes_ms, ops_ms), bound_by, nbytes


def kernel_phase(torch, qp, ref):
    hop, kv_append = (BATCH, D_MODEL), (BATCH * KV_HEADS, HEAD_DIM)
    kv_prefill = (BATCH * PROMPT * KV_HEADS, HEAD_DIM)
    kv_read = (BATCH * CACHE_LEN * KV_HEADS, HEAD_DIM)
    # main shapes, a ragged R, and a d that is not a multiple of 4 (the
    # scalar path; at 2 bits d must be a multiple of 4 codes per byte)
    cases = []
    for bits in (2, 4, 8):
        odd = 0 if bits == 2 else 2
        for name in ("delta_quantize_pack", "dequant_unpack_accumulate"):
            cases += [(name, *hop, bits, {}), (name, 5, D_MODEL, bits, {}),
                      (name, 3, 1600 + 4 - odd, bits, {})]
        for name in ("quantize_pack", "unpack_dequant"):
            cases += [(name, *kv_append, bits, {}),
                      (name, 37, 64 + 4 - odd, bits, {})]
    cases += [(n, *hop, b, {"stochastic": True})
              for n in ("delta_quantize_pack",) for b in (2, 4, 8)]
    cases += [(n, r, d, b, {"stochastic": st})
              for n in ("delta_quantize_pack", "quantize_pack")
              for r, d in WIDE_ROWS for b in (2, 4, 8) for st in (False, True)]
    # B2 at the wide hops (gemma2-9b's, gemma2-27b's, stablelm-12b's),
    # and at mamba2-1.3b's and zamba2-2.7b's as their decode steps send
    cases += [("dequant_unpack_accumulate", 2, d, b, {})
              for d in (3584, G27_D, S_D) for b in (2, 4, 8)]
    cases += [("dequant_unpack_accumulate", r, d, b, {})
              for r, d in SSM_HOPS + MOE_HOPS for b in (2, 4, 8)]
    cases += [("quantize_pack", *kv_append, b, {"stochastic": True})
              for b in (2, 4, 8)]
    cases += [("quantize_pack", *kv_prefill, 8, {}),
              ("unpack_dequant", *kv_read, 8, {}),
              ("unpack_dequant", *kv_read, 8,
               {"out_dtype": torch.bfloat16})]
    # the gradient wire: both pack variants, deterministic and
    # stochastic, a ragged R, the scalar path, n = 1/2/3/5, and the
    # bucket the training path sends (zero scale rows throughout)
    for bits in (2, 4, 8):
        odd = 512 if bits == 2 else 514
        for pack in (False, True):
            for st in (False, True):
                cases += [("quantize_codes_scaled", 37, 512, bits,
                           {"pack": pack, "stochastic": st}),
                          ("quantize_codes_scaled", 5, odd, bits,
                           {"pack": pack, "stochastic": st})]
        for n in (1, 2, 3, 5):
            cases += [("dequant_sum_mean", 37, 512, bits, {"n": n}),
                      ("dequant_sum_mean", 5, 514, bits, {"n": n})]
    cases += [("quantize_codes_scaled", *DP_BUCKET, 4, {"stochastic": True}),
              ("dequant_sum_mean", *DP_BUCKET, 4, {"n": 2})]
    # the activation codecs at the training path's shape: one worker's
    # boundary activations, 4-bit stochastic forward, 8-bit stochastic
    # backward round trip
    cases += [("delta_quantize_pack", *TRAIN_ROWS, 4, {"stochastic": True}),
              ("quantize_pack", *TRAIN_ROWS, 8, {"stochastic": True}),
              ("unpack_dequant", *TRAIN_ROWS, 8, {})]
    # and at [train-zamba2]'s (a worker's 4 x 1024 rows of d 2560, the
    # encoders with and without the noise; its 1,299,696-row DP bucket)
    cases += [(n, *TZ_ROWS, b, {"stochastic": st})
              for n, b in (("delta_quantize_pack", 4), ("quantize_pack", 8))
              for st in (False, True)]
    cases += [("unpack_dequant", *TZ_ROWS, 8, {}),
              ("quantize_codes_scaled", *TZ_BUCKET, 4, {"stochastic": True}),
              ("dequant_sum_mean", *TZ_BUCKET, 4, {"n": 2})]
    # and at [train-moe]'s boundary (one worker: 8 x 1024 rows of 2048)
    cases += [(n, *TM_ROWS, b, {"stochastic": st})
              for n, b in (("delta_quantize_pack", 4), ("quantize_pack", 8))
              for st in (False, True)]
    cases += [("unpack_dequant", *TM_ROWS, 8, {})]
    # the audio and vlm paths: B2 at whisper's and pixtral's decode hops,
    # and [train-whisper]'s boundary (a worker's 4 x 448 rows of 768)
    # and DP bucket
    cases += [("dequant_unpack_accumulate", r, d, b, {})
              for r, d in MEDIA_HOPS for b in (2, 4, 8)]
    cases += [(n, *TW_ROWS, b, {"stochastic": st})
              for n, b in (("delta_quantize_pack", 4), ("quantize_pack", 8))
              for st in (False, True)]
    cases += [("unpack_dequant", *TW_ROWS, 8, {}),
              ("quantize_codes_scaled", *TW_BUCKET, 4, {"stochastic": True}),
              ("dequant_sum_mean", *TW_BUCKET, 4, {"n": 2})]
    # the ring: accumulate at bits 2/4/8, sum packers at every sum width
    # (2, 4, 8, 16, 32 bits), ragged rows, the element path (an element
    # count that is not a multiple of 4), and the distributed path's
    # shapes: one ring segment (accumulate, pack) and the whole bucket
    # (unpack), 4 bits, n = 2
    for bits in (2, 4, 8):
        cases += [("unpack_accumulate", 37, 512, bits, {}),
                  ("unpack_accumulate", 3, 8 // bits * 3, bits, {})]
    from repro_torch.core import quantization as Q
    for bits, n in ((2, 1), (2, 3), (4, 2), (8, 2), (8, 300)):
        sw = Q.sum_wire_bits(bits, n)              # 2, 4, 8, 16, 32
        per_byte = 8 // sw if sw <= 8 else 1
        cases += [(name, r, dd, bits, {"n": n})
                  for name in ("pack_sums", "unpack_sums")
                  for r, dd in ((37, 512), (3, per_byte))]
    # the sums' unpacker past its last whole 16-byte group (128/SW
    # values), in the same launch, and on a misaligned view
    for bits, n in ((2, 1), (2, 3), (4, 2), (8, 2), (8, 300)):
        cases += [("unpack_sums", r, dd, bits, {"n": n, "offset": off})
                  for r, dd in ((5, 20), (3, 1604)) for off in (False, True)]
    cases += [("unpack_accumulate", DIST_SEG, 512, 4, {}),
              ("pack_sums", DIST_SEG, 512, 4, {"n": 2}),
              ("unpack_sums", *DIST_BUCKET, 4, {"n": 2})]
    errs = {}
    for name, rows, d, bits, kw in cases:
        e = check_bit_exact(torch, qp, ref, name, rows, d, bits, **dict(kw))
        errs[name] = max(errs.get(name, 0.0), e)
    phase("kernels-bit-exact", cases=len(cases),
          max_abs_err=json.dumps(errs))
    # each kernel at its main path's shape (the serving slice's for the
    # activation codecs; the DP bucket, stochastic, n=2 for the wire)
    main_shapes = {"delta_quantize_pack": (*hop, 4, {}),
                   "dequant_unpack_accumulate": (*hop, 4, {}),
                   "quantize_pack": (*kv_append, 8, {}),
                   "unpack_dequant": (*kv_read, 8, {}),
                   "quantize_codes_scaled": (*DP_BUCKET, 4,
                                             {"stochastic": True}),
                   "dequant_sum_mean": (*DP_BUCKET, 4, {"n": 2}),
                   "unpack_accumulate": (DIST_SEG, 512, 4, {}),
                   "pack_sums": (DIST_SEG, 512, 4, {"n": 2}),
                   "unpack_sums": (*DIST_BUCKET, 4, {"n": 2})}
    rows_out = {}
    for name, (rows, d, bits, kw) in main_shapes.items():
        ms, plain_ms, library_ms, bound_ms, bound_by, nbytes = time_kernel(
            torch, qp, ref, name, rows, d, bits, **kw)
        phase("kernel-time", name=name, rows=rows, d=d, bits=bits,
              bytes=nbytes, ms=f"{ms:.6f}", plain_ms=f"{plain_ms:.6f}",
              bound_ms=f"{bound_ms:.6f}", bound_by=bound_by,
              library_ms=None if library_ms is None
              else f"{library_ms:.6f}")
        rows_out[name] = {"name": name, "route": "cuda", "source": SOURCE,
                          "replaces": REPLACES[name], "launches": 0,
                          "max_abs_err": errs[name], "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "library_ms": library_ms,
                          "shape": [rows, d], "bits": bits}
    # the activation codecs also run on the training path, at its own
    # shape: one worker's boundary activations (4 x 1024 tokens, d 1600),
    # stochastic, 4-bit forward and 8-bit backward
    for name, bits, kw in (("delta_quantize_pack", 4, {"stochastic": True}),
                           ("quantize_pack", 8, {"stochastic": True}),
                           ("unpack_dequant", 8, {})):
        ms, plain_ms, _, bound_ms, bound_by, nbytes = time_kernel(
            torch, qp, ref, name, *TRAIN_ROWS, bits, **kw)
        phase("kernel-time", path="train", name=name, rows=TRAIN_ROWS[0],
              d=D_MODEL, bits=bits, bytes=nbytes, ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
              bound_by=bound_by, library_ms=None)
        rows_out[name]["train_shape"] = {
            "shape": list(TRAIN_ROWS), "bits": bits, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    return rows_out


# ---------------------------------------------------------------------------
# phase 3b: the seeded encoders (B11: the kernels' own Philox noise)
# ---------------------------------------------------------------------------

def _seed_tensor(torch, sd):
    return torch.tensor(sd, dtype=torch.int32, device="cuda")


def _misaligned(torch, t):
    """t's values one element past a 16-byte boundary: contiguous but
    misaligned, so the kernel takes its scalar path at d % 4 == 0."""
    if t is None:
        return None
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_seeded(torch, qp, ref, name, rows, d, bits, sd, *, offset=False,
                 **kw):
    """Seeded kernel vs the plain version fed `ref.oncore_uniform_ref`,
    bit for bit; returns max |diff| (0)."""
    args = _inputs(torch, name, rows, d, bits, seed=rows + d + bits)[:-1]
    seed = _seed_tensor(torch, sd)
    call = [_misaligned(torch, t) if offset and t.shape[-1] == d else t
            for t in args] if offset else args
    got = _outs(getattr(qp, name)(*call, bits=bits, seed=seed, **kw))
    u = ref.oncore_uniform_ref(seed, rows, d)
    want = _outs(_plain(ref, name)(*args, u, bits=bits, **kw))
    torch.cuda.synchronize()
    err = 0.0
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and g_.dtype == w_.dtype, name
        if not torch.equal(g_, w_):
            bad = (g_ != w_).sum().item()
            raise AssertionError(f"seeded {name} rows={rows} d={d} "
                                 f"bits={bits} seed={sd} offset={offset} "
                                 f"{kw}: {bad} elements differ from the "
                                 f"plain version")
        err = max(err, (g_.double() - w_.double()).abs().max().item())
    return err


def oncore_stats(torch, qp, ref):
    """[oncore-stats]: E[Q(x)] = x over 10k trials of the seeded kernels
    (one call over x tiled 10k times, each row its own noise), within
    5 sigma of the b-bit grid: B5 at 2 and 4 bits, B1 at 4, B3 at 8."""
    from repro_torch.core import quantization as Q
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 64, generator=g).cuda()
    m = torch.randn(4, 64, generator=g).cuda()
    xt, mt = x.repeat(STATS_TRIALS, 1), m.repeat(STATS_TRIALS, 1)
    st = torch.clamp(xt.abs().amax(-1, keepdim=True), min=Q._EPS)
    seed = _seed_tensor(torch, (6, 7))
    worst = {}
    for name, bits in (("quantize_codes_scaled", 2),
                       ("quantize_codes_scaled", 4),
                       ("delta_quantize_pack", 4), ("quantize_pack", 8)):
        if name == "quantize_codes_scaled":
            q = ref.dequant_sum_mean_ref(
                qp.quantize_codes_scaled(xt, st, bits=bits, seed=seed), st,
                bits, 1)
        elif name == "delta_quantize_pack":
            q = qp.delta_quantize_pack(mt + xt, mt, bits=bits,
                                       seed=seed)[2] - mt
        else:
            q = qp.unpack_dequant(*qp.quantize_pack(xt, bits=bits,
                                                    seed=seed), bits=bits)
        est = q.reshape(STATS_TRIALS, 4, 64).double().mean(0)
        cell = 2.0 * st[:4].double() / ((1 << bits) - 1)
        bound = 5.0 * cell / (2.0 * math.sqrt(STATS_TRIALS))
        worst[f"{name}/{bits}"] = ((est - x.double()).abs()
                                   / bound).max().item()
    phase("oncore-stats", trials=STATS_TRIALS,
          max_err_over_5_sigma=json.dumps(worst))
    assert all(v < 1.0 for v in worst.values()), worst


def time_seeded(torch, qp, ref, name, rows, d, bits):
    """A seeded encoder against the noise-input path the trainers ran
    before it, at one main-path shape: (ms, plain_ms, bound_ms,
    bound_by, bytes, input_ms, rand_ms, input_bound_ms).  ``input_ms``
    is the kernel reading a noise tensor u and ``rand_ms`` the
    ``torch.rand`` that writes u; the bounds count each input read once
    and each output written once (u too on the noise-input path)."""
    sets = []
    nbytes = 0
    while not sets or (len(sets) < 16 and nbytes * len(sets) < 120e6):
        args = _inputs(torch, name, rows, d, bits, seed=2 + len(sets))[:-1]
        sets.append((*args, _seed_tensor(torch, (len(sets), 1))))
        if not nbytes:
            outs = _outs(getattr(qp, name)(*args, bits=bits,
                                           seed=sets[0][-1]))
            nbytes = _bytes(sets[0], outs)
            del outs
    launches = 40 if nbytes < 1e9 else 4
    ms = device_ms(torch, lambda *a: getattr(qp, name)(
        *a[:-1], bits=bits, seed=a[-1]), sets, launches)
    plain = _plain(ref, name)
    plain_ms = device_ms(torch, lambda *a: plain(
        *a[:-1], ref.oncore_uniform_ref(a[-1], rows, d), bits=bits), sets,
        launches)
    noise = [(*a[:-1], torch.rand(rows, d, device="cuda")) for a in sets]
    input_ms = device_ms(torch, lambda *a: getattr(qp, name)(*a, bits=bits),
                         noise, launches)
    del noise
    rand_ms = device_ms(torch, lambda: torch.rand(rows, d, device="cuda"),
                        [()], launches)
    del sets
    torch.cuda.empty_cache()
    n = rows * d
    f32_ms = n * (OPS_PER_ELEMENT[name] + PHILOX_F32_OPS_PER_ELEMENT) \
        / F32_OPS_PER_S * 1e3
    int_ms = n * PHILOX_INT_OPS_PER_ELEMENT / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bytes_ms, f32_ms, int_ms)
    bound_by = "bytes" if bytes_ms >= max(f32_ms, int_ms) else "operations"
    input_bound_ms = max((nbytes + 4 * n) / HBM_BYTES_PER_S * 1e3,
                         n * OPS_PER_ELEMENT[name] / F32_OPS_PER_S * 1e3)
    return ms, plain_ms, bound_ms, bound_by, nbytes, input_ms, rand_ms, \
        input_bound_ms


def oncore_phase(torch, qp, ref):
    """[oncore-bit-exact], [oncore-stats] and the seeded encoders'
    [kernel-time] rows; returns B11's kernels row (numbers of seeded B5
    at the DP bucket, B1 and B3 at the training shape beside them)."""
    hop, kv_append = (BATCH, D_MODEL), (BATCH * KV_HEADS, HEAD_DIM)
    cases = []
    for bits in (2, 4, 8):
        odd = [] if bits == 2 else [(3, 1602), (37, 66)]  # d % 4 != 0
        for name, shapes in (("delta_quantize_pack",
                              [hop, TRAIN_ROWS] + WIDE_ROWS),
                             ("quantize_pack",
                              [kv_append, TRAIN_ROWS] + WIDE_ROWS)):
            cases += [(name, r, d, bits, {}) for r, d in shapes + odd]
            cases += [(name, 5, 1600, bits, {"offset": True})]
        for pack in (False, True):
            cases += [("quantize_codes_scaled", r, d, bits, {"pack": pack})
                      for r, d in [(37, 512)] + odd]
            cases += [("quantize_codes_scaled", 5, 512, bits,
                       {"pack": pack, "offset": True})]
    cases += [("quantize_codes_scaled", *DP_BUCKET, 4, {})]
    err = 0.0
    for sd in ONCORE_SEEDS:
        for name, rows, d, bits, kw in cases:
            err = max(err, check_seeded(torch, qp, ref, name, rows, d, bits,
                                        sd, **kw))
    phase("oncore-bit-exact", cases=len(cases) * len(ONCORE_SEEDS),
          seeds=json.dumps(ONCORE_SEEDS), max_abs_err=err)
    assert err == 0.0, err
    oncore_stats(torch, qp, ref)
    timed = {}
    for name, rows, d, bits in (("quantize_codes_scaled", *DP_BUCKET, 4),
                                ("delta_quantize_pack", *TRAIN_ROWS, 4),
                                ("quantize_pack", *TRAIN_ROWS, 8)):
        ms, plain_ms, bound_ms, bound_by, nbytes, input_ms, rand_ms, \
            input_bound_ms = time_seeded(torch, qp, ref, name, rows, d, bits)
        phase("kernel-time", name=f"{name}+oncore_uniform", rows=rows, d=d,
              bits=bits, bytes=nbytes, ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
              bound_by=bound_by, library_ms=None,
              noise_input_ms=f"{input_ms:.6f}", rand_ms=f"{rand_ms:.6f}",
              noise_input_bound_ms=f"{input_bound_ms:.6f}")
        timed[name] = {"shape": [rows, d], "bits": bits, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "noise_input_ms": input_ms,
                       "rand_ms": rand_ms,
                       "noise_input_bound_ms": input_bound_ms}
    row = {"name": "oncore_uniform", "route": "cuda", "source": SOURCE,
           "replaces": REPLACES["oncore_uniform"], "launches": 0,
           "max_abs_err": err, "library_ms": None,
           "inside": list(ONCORE_ENCODERS)}
    row.update({k: timed["quantize_codes_scaled"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "shape", "bits",
        "noise_input_ms", "rand_ms", "noise_input_bound_ms")})
    row["delta_quantize_pack"] = timed["delta_quantize_pack"]
    row["quantize_pack"] = timed["quantize_pack"]
    return row


# ---------------------------------------------------------------------------
# phase 3c: the gradient wire's legacy pair (B9a, B9b)
# ---------------------------------------------------------------------------

def _legacy_workers(torch):
    """[legacy-dp-codec]'s inputs at the DP bucket: each worker's
    gradient-like x and noise u, and the scale they share (1.3 x the
    larger row absmax, pmax-style; row 0 is zero for both, so its scale
    is 0 and clamps to 1e-12)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    rows, d = DP_BUCKET
    mags = torch.logspace(-6, 1, rows, device="cuda")[:, None]
    xs, us = [], []
    for _ in range(LEGACY_WORKERS):
        x = torch.randn(rows, d, generator=g, device="cuda") * mags
        x[0] = 0.0
        xs.append(x)
        us.append(torch.rand(rows, d, generator=g, device="cuda"))
    s = torch.stack([x.abs().amax(-1, keepdim=True) for x in xs]).amax(0) \
        * LEGACY_SCALE
    return xs, s, us


def legacy_dp_codec(torch, qp, env):
    """[legacy-dp-codec]: tests/test_grad_compress.py's chain at the DP
    bucket over two workers, the legacy pair against the fused sender,
    bit for bit; returns (the legacy chain's launches, the two chains'
    device ms a worker and their byte bounds)."""
    from repro_torch.core import boundary as B
    bits, d = LEGACY_BITS, DP_BUCKET[1]
    xs, s, us = _legacy_workers(torch)

    def legacy(x, s, u):
        packed = B.encode_with_scale(x, s, bits=bits, stochastic=True, u=u)
        return packed, B.decode_codes(packed, bits=bits, d=d)

    def fused(x, s, u):
        return B.encode_codes_with_scale(x, s, bits=bits, stochastic=True,
                                         u=u, pack=True)

    torch.cuda.synchronize()
    qp.reset_launches()
    chain = [legacy(x, s, u) for x, u in zip(xs, us)]
    total = sum(c for _, c in chain)
    mean = B.decode_sum_mean(total, s, bits=bits, n=LEGACY_WORKERS)
    torch.cuda.synchronize()
    launches = dict(qp.LAUNCHES)
    ref_chain = [fused(x, s, u) for x, u in zip(xs, us)]
    ref_mean = B.decode_sum_mean(sum(c for _, c in ref_chain), s, bits=bits,
                                 n=LEGACY_WORKERS)
    for (p, c), (fp, fc) in zip(chain, ref_chain):
        assert torch.equal(p, fp), "legacy packed bytes differ from B5's"
        assert torch.equal(c, fc), "legacy codes differ from B5's"
    assert torch.equal(mean, ref_mean), "legacy means differ from B5's"
    assert torch.isfinite(mean).all().item() and s[0].item() == 0.0
    del chain, total, mean, ref_chain, ref_mean
    # no seeded variant: the knob leaves the pair's noise to the generator
    packed_by_knob = {}
    for knob in ("1", None):
        if knob:
            os.environ[env.ONCORE_PRNG] = knob
        try:
            qp.reset_launches()
            packed_by_knob[knob] = B.encode_with_scale(
                xs[0], s, bits=bits, stochastic=True,
                generator=torch.Generator(device="cuda").manual_seed(23))
            torch.cuda.synchronize()
            assert qp.LAUNCHES["oncore_uniform"] == 0, qp.LAUNCHES
            assert qp.LAUNCHES["quantize_pack_scaled"] == 1, qp.LAUNCHES
        finally:
            os.environ.pop(env.ONCORE_PRNG, None)
    assert torch.equal(packed_by_knob["1"], packed_by_knob[None]), \
        "the on-core noise knob changed the legacy sender's bytes"
    del packed_by_knob
    # device time a worker: the pair (B9a then B9b) against B5 with pack
    sets = list(zip(xs, [s] * LEGACY_WORKERS, us))
    legacy_ms = device_ms(torch, lambda *a: legacy(*a)[1], sets, 4)
    fused_ms = device_ms(torch, fused, sets, 4)
    n = DP_BUCKET[0] * d
    xu, sb, pb, cb = 8 * n, 4 * DP_BUCKET[0], n * bits // 8, 4 * n
    legacy_bound = (xu + sb + 2 * pb + cb) / HBM_BYTES_PER_S * 1e3
    fused_bound = (xu + sb + pb + cb) / HBM_BYTES_PER_S * 1e3
    del xs, us, sets, s
    torch.cuda.empty_cache()
    phase("legacy-dp-codec", workers=LEGACY_WORKERS, rows=DP_BUCKET[0], d=d,
          bits=bits, bit_equal_to_fused=True, knob_changes_bytes=False,
          launches=json.dumps(launches),
          legacy_ms_per_worker=f"{legacy_ms:.6f}",
          legacy_bound_ms=f"{legacy_bound:.6f}",
          fused_ms_per_worker=f"{fused_ms:.6f}",
          fused_bound_ms=f"{fused_bound:.6f}")
    assert launches["quantize_pack_scaled"] == LEGACY_WORKERS, launches
    assert launches["unpack_codes"] == LEGACY_WORKERS, launches
    assert launches["dequant_sum_mean"] == 1, launches
    assert launches["quantize_codes_scaled"] == 0, launches
    return launches, {"legacy_ms": legacy_ms, "legacy_bound_ms": legacy_bound,
                      "fused_ms": fused_ms, "fused_bound_ms": fused_bound}


def legacy_phase(torch, qp, ref, env):
    """[legacy-bit-exact], the pair's [kernel-time] rows and
    [legacy-dp-codec]; returns (their kernels rows, the chain's
    launches)."""
    cases = []
    for bits in (2, 4, 8):
        odd = 512 if bits == 2 else 514            # 514 % 4 != 0
        for rows, d in ((37, 512), (300, 512), (5, odd)):
            cases += [("quantize_pack_scaled", rows, d, bits,
                       {"stochastic": st}) for st in (False, True)]
            cases += [("unpack_codes", rows, d, bits, {})]
        cases += [("quantize_pack_scaled", 5, 512, bits,
                   {"stochastic": True, "offset": True}),
                  ("unpack_codes", 5, 512, bits, {"offset": True}),
                  ("unpack_codes", 5, 20, bits, {}),   # a tail past 16 B
                  ("unpack_codes", 3, 1604, bits, {})]
    cases += [("quantize_pack_scaled", *DP_BUCKET, 4, {"stochastic": st})
              for st in (False, True)]
    cases += [("unpack_codes", *DP_BUCKET, b, {}) for b in (4, 8)]
    errs = {name: 0.0 for name in LEGACY_KERNELS}
    for name, rows, d, bits, kw in cases:
        errs[name] = max(errs[name], check_bit_exact(
            torch, qp, ref, name, rows, d, bits, **dict(kw)))
    phase("legacy-bit-exact", cases=len(cases), max_abs_err=json.dumps(errs))
    assert all(e == 0.0 for e in errs.values()), errs
    timed = {}
    for name, bits, kw, key in (
            ("quantize_pack_scaled", 4, {"stochastic": True}, "main"),
            ("quantize_pack_scaled", 4, {}, "deterministic"),
            ("unpack_codes", 4, {}, "main"),
            ("unpack_codes", 8, {}, "bits8")):
        ms, plain_ms, library_ms, bound_ms, bound_by, nbytes = time_kernel(
            torch, qp, ref, name, *DP_BUCKET, bits, **kw)
        phase("kernel-time", name=name, rows=DP_BUCKET[0], d=DP_BUCKET[1],
              bits=bits, stochastic=kw.get("stochastic", False),
              bytes=nbytes, ms=f"{ms:.6f}", plain_ms=f"{plain_ms:.6f}",
              bound_ms=f"{bound_ms:.6f}", bound_by=bound_by,
              library_ms=None if library_ms is None
              else f"{library_ms:.6f}")
        timed.setdefault(name, {})[key] = {
            "shape": list(DP_BUCKET), "bits": bits, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **kw}
    launches, chains = legacy_dp_codec(torch, qp, env)
    rows_out = {}
    for name in LEGACY_KERNELS:
        main = timed[name].pop("main")
        rows_out[name] = {"name": name, "route": "cuda", "source": SOURCE,
                          "replaces": REPLACES[name], "launches": 0,
                          "max_abs_err": errs[name], **main, **timed[name]}
    rows_out["quantize_pack_scaled"]["legacy_dp_codec"] = chains
    return rows_out, launches


# ---------------------------------------------------------------------------
# phase 3d: the KV plane's pair calls (B3 and B4 over k and v in one launch)
# ---------------------------------------------------------------------------

# (label, B, S, N, g, s, pos): each arch's layer store with its decode
# append (one row at the write head; gemma2's at the store's last row)
# and its prefill append, a group_d of 32 on a ragged row count, rows too
# wide for registers (the two-pass path) and a g % 4 != 0 (the scalar
# path; not at 2 bits, where g must be a multiple of 4)
KV_PAIR_CASES = [
    ("gpt2-xl decode", BATCH, CACHE_LEN, KV_HEADS, HEAD_DIM, 1, CACHE_LEN - 1),
    ("gpt2-xl prefill", BATCH, CACHE_LEN, KV_HEADS, HEAD_DIM, PROMPT, 0),
    ("gemma2 decode", G_BATCH, G_CACHE, G_KV_HEADS, G_HEAD_DIM, 1,
     G_CACHE - 1),
    ("gemma2 prefill", G_BATCH, G_CACHE, G_KV_HEADS, G_HEAD_DIM, G_PROMPT,
     0),
    ("stablelm decode", S_BATCH, S_CACHE, S_KV_HEADS, S_HEAD_DIM, 1,
     S_CACHE - 1),
    ("stablelm prefill", S_BATCH, S_CACHE, S_KV_HEADS, S_HEAD_DIM, S_PROMPT,
     0),
    ("gemma2-27b decode", G_BATCH, G_CACHE, G27_KV_HEADS, G27_HEAD_DIM, 1,
     G_CACHE - 1),
    ("deepseek-moe decode", S_BATCH, S_CACHE, DS_HEADS, MOE_HEAD_DIM, 1,
     S_CACHE - 1),
    ("mixtral decode", G_BATCH, G_CACHE, MX_KV_HEADS, MOE_HEAD_DIM, 1,
     G_CACHE - 1),
    ("mixtral prefill", G_BATCH, G_CACHE, MX_KV_HEADS, MOE_HEAD_DIM,
     G_PROMPT, 0),
    ("whisper decode", W_BATCH, W_CACHE, W_HEADS, W_HEAD_DIM, 1,
     W_CACHE - 1),
    ("whisper prefill", W_BATCH, W_CACHE, W_HEADS, W_HEAD_DIM, W_PROMPT, 0),
    ("pixtral decode", P_BATCH, P_CACHE, P_KV_HEADS, P_HEAD_DIM, 1,
     P_CACHE - 1),
    ("pixtral prefill", P_BATCH, P_CACHE, P_KV_HEADS, P_HEAD_DIM, P_TRUNK,
     0),
    ("group 32", 3, 7, 10, 32, 2, 5),
    ("wide rows", 1, 5, 3, 1600, 2, 1),
    ("g % 4 != 0", 2, 6, 5, 66, 3, 2)]


def _kv_pair_inputs(torch, b, cache, n, g, s, bits, seed):
    """Fresh k and v rows (B, s, N, g), and two stores (B, S, N, pw) u8
    and (B, S, N) f32 full of random bytes and scales."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = tuple(torch.randn(b, s, n, g, generator=gen, device="cuda") * 3
              for _ in range(2))
    x[0][0, 0, 0] = 0.0                                 # an all-zero row
    packed = tuple(torch.randint(0, 256, (b, cache, n, g * bits // 8),
                                 generator=gen, device="cuda",
                                 dtype=torch.uint8) for _ in range(2))
    scale = tuple(torch.rand(b, cache, n, generator=gen, device="cuda") + 0.5
                  for _ in range(2))
    return x, packed, scale


def check_kv_pair(torch, qp, ref, b, cache, n, g, s, pos, bits, noise,
                  misaligned):
    """The pair append into stores full of random bytes (so every row
    outside [pos, pos + s) must keep its own), then the pair read of what
    it wrote (f32 and bf16), each against its plain version and against
    two per-tensor kernel calls (plus the slice writes); ``noise``: none,
    "u" or "seed"; ``misaligned``: x, the stores and the read's codes one
    element past their alignment (the scalar paths).  Returns the number
    of elements that differ."""
    x, packed, scale = _kv_pair_inputs(torch, b, cache, n, g, s, bits,
                                       b + cache + n + g + s + bits)
    rows = b * s * n
    seeds = tuple(_seed_tensor(torch, sd) for sd in ONCORE_SEEDS[1:])
    u = tuple(torch.rand_like(t) for t in x) if noise == "u" \
        else (None, None)
    seed = seeds if noise == "seed" else (None, None)
    plain_u = tuple(ref.oncore_uniform_ref(sd, rows, g).reshape(x[0].shape)
                    for sd in seeds) if noise == "seed" else u
    want_p = tuple(p.clone() for p in packed)
    want_s = tuple(t.clone() for t in scale)
    ref.quantize_pack_into_ref(x, want_p, want_s, pos, bits, plain_u)
    move = (lambda t: _misaligned(torch, t)) if misaligned \
        else (lambda t: t.clone())
    got_p, got_s = tuple(map(move, packed)), tuple(map(move, scale))
    xx = tuple(map(move, x)) if misaligned else x
    qp.quantize_pack_into(xx, got_p, got_s, pos, u, seed, bits=bits)
    pairs = list(zip(got_p + got_s, want_p + want_s))
    for i in range(2):                      # two per-tensor kernel calls
        p1, s1 = qp.quantize_pack(
            x[i].reshape(-1, g), None if u[i] is None else u[i].reshape(-1, g),
            bits=bits, seed=seed[i])
        pairs += [(want_p[i][:, pos:pos + s], p1.reshape(b, s, n, -1)),
                  (want_s[i][:, pos:pos + s], s1.reshape(b, s, n))]
    codes = tuple(p.reshape(-1, p.shape[-1]) for p in want_p)
    scales = tuple(t.reshape(-1, 1) for t in want_s)
    read = tuple(map(move, codes)) if misaligned else codes
    for dt in (torch.float32, torch.bfloat16):
        got = qp.unpack_dequant_pair(read, scales, bits=bits, out_dtype=dt)
        pairs += list(zip(got, ref.unpack_dequant_pair_ref(codes, scales,
                                                           bits, dt)))
        pairs += list(zip(got, (qp.unpack_dequant(c, t, bits=bits,
                                                  out_dtype=dt)
                                for c, t in zip(codes, scales))))
    torch.cuda.synchronize()
    bad = 0
    for a, w in pairs:
        assert a.shape == w.shape and a.dtype == w.dtype, (a.shape, w.shape)
        bad += int((a != w).sum().item())
    return bad


def time_kv_pair(torch, qp, ref, what, b, cache, n, g, s, pos, bits=8):
    """One pair launch at a path's shape: ``what`` "read" (the store
    read of k and v, (B*S*N, pw) each, f32 out) or "append" ((B, s, N,
    g) fresh rows into rows [pos, pos + s) of each store).  Returns
    (ms, plain_ms, bound_ms, bound_by, bytes); the bound counts each
    input read once and each output written once, the append's stores
    only where it writes them."""
    pw = g * bits // 8
    if what == "read":
        rows = b * cache * n
        ops = 2 * rows * g * OPS_PER_ELEMENT["unpack_dequant"]
        nbytes = 2 * rows * (pw + 4 + 4 * g)
    else:
        rows = b * s * n
        ops = 2 * rows * g * OPS_PER_ELEMENT["quantize_pack"]
        nbytes = 2 * rows * (4 * g + pw + 4)
    sets = []
    while not sets or (len(sets) < 16 and nbytes * len(sets) < 120e6):
        x, packed, scale = _kv_pair_inputs(torch, b, cache, n, g, s, bits,
                                           len(sets))
        if what == "read":
            sets.append((tuple(p.reshape(-1, pw) for p in packed),
                         tuple(t.reshape(-1, 1) for t in scale)))
        else:
            sets.append((x, packed, scale))
        del x, packed, scale
    launches = 40 if nbytes < 1e9 else 4
    if what == "read":
        ms = device_ms(torch, lambda p, t: qp.unpack_dequant_pair(
            p, t, bits=bits), sets, launches)
        plain_ms = device_ms(torch, lambda p, t: ref.unpack_dequant_pair_ref(
            p, t, bits), sets, launches)
    else:
        ms = device_ms(torch, lambda x, p, t: qp.quantize_pack_into(
            x, p, t, pos, bits=bits), sets, launches)
        plain_ms = device_ms(torch, lambda x, p, t: ref.quantize_pack_into_ref(
            x, p, t, pos, bits), sets, launches)
    del sets
    torch.cuda.empty_cache()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return ms, plain_ms, max(bytes_ms, ops_ms), bound_by, nbytes


# (label, b, cache, n, g, s, heads): gpt2-xl's pool append, gemma2's
# (2 slots, one past the store), and a run of 2 rows a slot
KV_ROW_HEAD_CASES = [
    ("gpt2-xl pool", CONT_SLOTS, CACHE_LEN, KV_HEADS, HEAD_DIM, 1, ROW_HEADS),
    ("gemma2 pool", G_BATCH, G_CACHE, G_KV_HEADS, G_HEAD_DIM, 1,
     (G_CACHE - 1, G_CACHE + 7)),
    ("2 rows", 4, 12, 10, 32, 2, (0, 11, 5, 40))]


def check_kv_row_heads(torch, qp, ref, b, cache, n, g, s, heads, bits,
                       noise):
    """The pair append at per-row write heads (a (B,) int32 tensor on
    the card, clamped to [0, cache - s] in the kernel) into stores full
    of random bytes, against its plain version and against one
    scalar-head launch a batch entry at its clamped head.  Returns the
    number of elements that differ."""
    x, packed, scale = _kv_pair_inputs(torch, b, cache, n, g, s, bits,
                                       cache + n + g + bits)
    pos = torch.tensor(heads, dtype=torch.int32, device="cuda")
    seeds = tuple(_seed_tensor(torch, sd) for sd in ONCORE_SEEDS[1:])
    u = tuple(torch.rand_like(t) for t in x) if noise == "u" \
        else (None, None)
    seed = seeds if noise == "seed" else (None, None)
    plain_u = tuple(ref.oncore_uniform_ref(sd, b * s * n, g).reshape(
        x[0].shape) for sd in seeds) if noise == "seed" else u
    want_p = tuple(p.clone() for p in packed)
    want_s = tuple(t.clone() for t in scale)
    ref.quantize_pack_into_ref(x, want_p, want_s, pos, bits, plain_u)
    got_p = tuple(p.clone() for p in packed)
    got_s = tuple(t.clone() for t in scale)
    qp.quantize_pack_into(x, got_p, got_s, pos, u, seed, bits=bits)
    pairs = list(zip(got_p + got_s, want_p + want_s))
    if noise is None:
        for i, h in enumerate(heads):
            one_p = tuple(p[i:i + 1].clone() for p in packed)
            one_s = tuple(t[i:i + 1].clone() for t in scale)
            qp.quantize_pack_into(tuple(t[i:i + 1] for t in x), one_p, one_s,
                                  min(max(h, 0), cache - s), bits=bits)
            pairs += list(zip(one_p + one_s,
                              [t[i:i + 1] for t in got_p + got_s]))
    torch.cuda.synchronize()
    return sum(int((a != w).sum().item()) for a, w in pairs)


def launch_floor_ms(torch, build) -> float:
    """What one launch costs in `device_ms`'s harness: an empty kernel
    (one warp) captured 40 times back to back in a CUDA graph."""
    lib = build.load("quant_pack")

    def empty():
        rc = lib.rt_launch_floor(torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"rt_launch_floor: CUDA error {rc}")

    return device_ms(torch, empty, [()], 40)


def kv_pair_phase(torch, qp, ref, build, rows_out):
    """[kv-pair-bit-exact], [launch-floor] and the pair launches'
    [kernel-time] rows, beside B3 and B4 per call at gemma2's KV shapes.
    The kernels line's B3 and B4 rows take the pair's numbers at gpt2-xl's
    shapes (what the serving path launches); their per-call numbers move
    under ``per_call``, gemma2's under ``gemma2``."""
    bad = cases = 0
    for label, b, cache, n, g, s, pos in KV_PAIR_CASES:
        for bits in (2, 4, 8):
            if g % 4 and bits == 2:
                continue
            for noise in (None, "u", "seed"):
                for misaligned in (False, True):
                    bad += check_kv_pair(torch, qp, ref, b, cache, n, g, s,
                                         pos, bits, noise, misaligned)
                    cases += 1
    phase("kv-pair-bit-exact", cases=cases, mismatches=bad)
    assert bad == 0, bad
    bad = cases = 0
    for label, b, cache, n, g, s, heads in KV_ROW_HEAD_CASES:
        for bits in (2, 4, 8):
            for noise in (None, "u", "seed"):
                bad += check_kv_row_heads(torch, qp, ref, b, cache, n, g, s,
                                          heads, bits, noise)
                cases += 1
    phase("kv-pair-row-heads-bit-exact", cases=cases, mismatches=bad,
          heads=json.dumps(ROW_HEADS), cache=CACHE_LEN)
    assert bad == 0, bad
    floor = launch_floor_ms(torch, build)
    phase("launch-floor", ms=f"{floor:.6f}",
          what="an empty kernel, 40 captured back to back in a CUDA graph")
    timed = {}
    for name, what, arch, case in (
            ("unpack_dequant", "read", "gpt2-xl", KV_PAIR_CASES[0]),
            ("unpack_dequant", "read", "gemma2", KV_PAIR_CASES[2]),
            ("quantize_pack", "append", "gpt2-xl", KV_PAIR_CASES[0]),
            ("quantize_pack", "append", "gemma2", KV_PAIR_CASES[2])):
        _, b, cache, n, g, s, pos = case
        ms, plain_ms, bound_ms, bound_by, nbytes = time_kv_pair(
            torch, qp, ref, what, b, cache, n, g, s, pos)
        rows = b * n * (cache if what == "read" else s)
        phase("kernel-time", name=f"{name}_pair", path=arch, rows=rows, d=g,
              bits=8, tensors=2, bytes=nbytes, ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
              bound_by=bound_by, library_ms=None,
              ms_over_launch_floor=f"{ms / floor:.3f}")
        timed[(name, arch)] = {"shape": [2, rows, g], "bits": 8, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by, "library_ms": None}
    # the pool append at per-row heads, beside the scalar-head pair at the
    # same shape (timed above as the gpt2-xl decode append)
    _, b, cache, n, g, s, _ = KV_ROW_HEAD_CASES[0]
    heads = torch.tensor(ROW_HEADS, dtype=torch.int32, device="cuda")
    ms, plain_ms, bound_ms, bound_by, nbytes = time_kv_pair(
        torch, qp, ref, "append", b, cache, n, g, s, heads)
    scalar = timed[("quantize_pack", "gpt2-xl")]
    phase("kernel-time", name="quantize_pack_pair_row_heads",
          path="gpt2-xl pool", rows=b * s * n, d=g, bits=8, tensors=2,
          bytes=nbytes, ms=f"{ms:.6f}", plain_ms=f"{plain_ms:.6f}",
          bound_ms=f"{bound_ms:.6f}", bound_by=bound_by, library_ms=None,
          scalar_head_ms=f"{scalar['ms']:.6f}",
          ms_over_launch_floor=f"{ms / floor:.3f}")
    row_heads = {"shape": [2, b * s * n, g], "bits": 8, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "scalar_head_ms": scalar["ms"]}
    for name, rows in (("unpack_dequant", G_BATCH * G_CACHE * G_KV_HEADS),
                       ("quantize_pack", G_BATCH * G_KV_HEADS)):
        ms, plain_ms, library_ms, bound_ms, bound_by, nbytes = time_kernel(
            torch, qp, ref, name, rows, G_HEAD_DIM, 8)
        phase("kernel-time", name=name, path="gemma2", rows=rows,
              d=G_HEAD_DIM, bits=8, bytes=nbytes, ms=f"{ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
              bound_by=bound_by, library_ms=library_ms,
              ms_over_launch_floor=f"{ms / floor:.3f}")
        row = rows_out[name]
        per_call = {k: row[k] for k in ("shape", "bits", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}
        row.update(timed[(name, "gpt2-xl")])
        row["per_call"] = per_call
        row["gemma2"] = {
            "pair": timed[(name, "gemma2")],
            "per_call": {"shape": [rows, G_HEAD_DIM], "bits": 8, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms}}
        row["launch_floor_ms"] = floor
    rows_out["quantize_pack"]["row_heads"] = row_heads
    # B1 at gemma2-9b's decode hop, beside the launch floor
    ms, plain_ms, library_ms, bound_ms, bound_by, nbytes = time_kernel(
        torch, qp, ref, "delta_quantize_pack", G_BATCH, G_D, 4)
    phase("kernel-time", name="delta_quantize_pack", path="gemma2",
          rows=G_BATCH, d=G_D, bits=4, bytes=nbytes, ms=f"{ms:.6f}",
          plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
          bound_by=bound_by, library_ms=library_ms,
          launch_floor_ms=f"{floor:.6f}",
          ms_over_launch_floor=f"{ms / floor:.3f}")
    rows_out["delta_quantize_pack"]["gemma2"] = {
        "shape": [G_BATCH, G_D], "bits": 4, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    for name in ("delta_quantize_pack", "dequant_unpack_accumulate"):
        rows_out[name]["launch_floor_ms"] = floor
    return floor


# ---------------------------------------------------------------------------
# phase 4: the attention kernel (B10) against its plain version
# ---------------------------------------------------------------------------

# (label, b, h, hk, sq, sk, hd, q_offset, causal, window, softcap, dtype,
# q scale: 16 lets the scores reach the softcap)
FLASH_SWEEP = [
    *[(f"shape-{dt}", b, h, hk, s, s, hd, 0, True, 10 ** 9, 0.0, dt, 1.0)
      for b, h, hk, s, hd in ((1, 2, 2, 64, 32), (2, 4, 2, 128, 64),
                              (1, 8, 1, 64, 128), (1, 2, 2, 96, 32))
      for dt in ("float32", "bfloat16")],
    *[("mask", 1, 2, 2, 64, 64, 32, 0, c, w, cap, "float32", 1.0)
      for w, cap, c in ((9, 0.0, True), (10 ** 9, 30.0, True),
                        (17, 4.0, True), (10 ** 9, 0.0, False))],
    ("ragged", 2, 4, 2, 37, 53, 256, 9, True, 16, 50.0, "float32", 16.0),
    ("ragged", 2, 4, 2, 37, 53, 256, 9, True, 16, 50.0, "bfloat16", 16.0),
    ("ragged", 1, 16, 8, 300, 400, 256, 70, True, 128, 50.0, "float32",
     16.0),
    ("ragged", 2, 4, 1, 100, 230, 128, 130, False, 50, 30.0, "float32", 1.0),
    ("ragged", 1, 2, 2, 65, 129, 64, 64, True, 10 ** 9, 0.0, "float32", 1.0),
    # stablelm-12b's heads (32 on 8 kv heads of 160), and hd 160 under a
    # window and a softcap with q scaled by 16
    ("ragged", 2, 32, 8, 77, 300, 160, 150, True, 10 ** 9, 0.0, "float32",
     1.0),
    ("ragged", 2, 32, 8, 77, 300, 160, 150, True, 10 ** 9, 0.0, "bfloat16",
     1.0),
    ("ragged", 1, 4, 2, 100, 230, 160, 130, False, 50, 30.0, "float32",
     16.0),
    # Sq and Sk off the kernel's tiles (64 query rows; 64 keys at hd <=
    # 64, 32 at 128 and 256) at every head dim, q scaled by 16 under the
    # softcap of 50, f32 and bf16
    *[("edge", 2, 4, 2, 65, 97, hd, 32, True, 10 ** 9, 50.0, dt, 16.0)
      for hd in (32, 64, 128, 160, 256) for dt in ("float32", "bfloat16")],
    # zamba2's head_dim 80 (the wrapper pads it to the kernel's 96):
    # whole tiles, GQA, a window and a softcap with q scaled by 16 at a
    # query offset, and the tiles' edges; f32 and bf16
    *[("shape-hd80", 1, 2, 2, 64, 64, 80, 0, True, 10 ** 9, 0.0, dt, 1.0)
      for dt in ("float32", "bfloat16")],
    ("ragged", 2, 4, 2, 37, 53, 80, 9, True, 16, 50.0, "float32", 16.0),
    ("ragged", 2, 32, 32, 77, 300, 80, 150, True, 10 ** 9, 0.0, "float32",
     1.0),
    ("ragged", 1, 4, 2, 100, 230, 80, 130, False, 50, 30.0, "bfloat16",
     1.0),
    *[("edge", 2, 4, 2, 65, 97, 80, 32, True, 10 ** 9, 50.0, dt, 16.0)
      for dt in ("float32", "bfloat16")],
    # f32 k and v rows off 16-byte alignment: the register copy
    ("odd-stride", 1, 4, 2, 70, 100, 64, 30, True, 10 ** 9, 50.0,
     "float32", 1.0),
    ("odd-stride", 1, 4, 2, 70, 100, 256, 30, True, 40, 50.0, "float32",
     16.0),
    ("odd-stride", 1, 4, 2, 70, 100, 160, 30, True, 10 ** 9, 0.0,
     "float32", 1.0),
    ("odd-stride", 1, 4, 2, 70, 100, 80, 30, True, 10 ** 9, 0.0,
     "float32", 1.0),
    # non-causal calls where every row sees every key (the whisper
    # encoder's self-attention, cross attention): Sk off the 32-key tile
    # and Sq past Sk (at a query offset too), GQA, hd 64 and 128, f32
    # and bf16, through several query tiles walked latest first
    *[("cross", 2, 4, 4, 200, 75, 64, 0, False, 10 ** 9, 0.0, dt, 1.0)
      for dt in ("float32", "bfloat16")],
    ("cross", 1, 4, 2, 130, 37, 128, 50, False, 10 ** 9, 0.0, "float32",
     4.0),
    ("cross", 1, 12, 12, 448, 1500, 64, 0, False, 10 ** 9, 0.0, "float32",
     1.0),
    ("cross", 1, 12, 12, 1500, 1500, 64, 0, False, 10 ** 9, 0.0,
     "bfloat16", 1.0),
    # the continuous batcher's B = 1 prefills into a row cache of 160, as
    # the model passes them (transposed views)
    *[("path", 1, 25, KV_HEADS, sq, CACHE_LEN, HEAD_DIM, 0, True, CACHE_LEN,
       0.0, "float32", 1.0) for sq in (4, 77, PROMPT)],
]
# the paths' prefill calls: gpt2-xl-paper (window = its cache of 160),
# gemma2-9b and gemma2-27b on a local and a global layer, stablelm-12b
# (head_dim 160, window = its cache of 4096) and a ragged stablelm call
# at a query offset (1000 rows at positions 3000-3999)
FLASH_PATHS = {
    "gpt2-xl": ("path", BATCH, 25, KV_HEADS, PROMPT, CACHE_LEN, HEAD_DIM, 0,
                True, CACHE_LEN, 0.0, "float32", 1.0),
    "gemma2-local": ("path", G_BATCH, G_HEADS, G_KV_HEADS, G_PROMPT, G_CACHE,
                     G_HEAD_DIM, 0, True, G_WINDOW, G_CAP, "float32", 16.0),
    "gemma2-global": ("path", G_BATCH, G_HEADS, G_KV_HEADS, G_PROMPT,
                      G_CACHE, G_HEAD_DIM, 0, True, G_CACHE, G_CAP,
                      "float32", 16.0),
    "stablelm": ("path", S_BATCH, S_HEADS, S_KV_HEADS, S_PROMPT, S_CACHE,
                 S_HEAD_DIM, 0, True, S_CACHE, 0.0, "float32", 1.0),
    "stablelm-ragged": ("path", 1, S_HEADS, S_KV_HEADS, 1000, S_CACHE,
                        S_HEAD_DIM, 3000, True, S_CACHE, 0.0, "float32",
                        1.0),
    "gemma2-27b-local": ("path", G_BATCH, G27_HEADS, G27_KV_HEADS, G_PROMPT,
                         G_CACHE, G27_HEAD_DIM, 0, True, G_WINDOW, G_CAP,
                         "float32", 16.0),
    "gemma2-27b-global": ("path", G_BATCH, G27_HEADS, G27_KV_HEADS,
                          G_PROMPT, G_CACHE, G27_HEAD_DIM, 0, True, G_CACHE,
                          G_CAP, "float32", 16.0),
    # zamba2-2.7b's shared block at its prefill (32 heads of 80, window =
    # its cache of 4096)
    "zamba2": ("path", Z_BATCH, Z_HEADS, Z_HEADS, Z_PROMPT, Z_CACHE,
               Z_HEAD_DIM, 0, True, Z_CACHE, 0.0, "float32", 1.0),
    # the moe family's prefills: deepseek-moe-16b (16 heads of 128, causal
    # over its cache of 4096) and mixtral-8x22b (48 heads on 8 kv heads of
    # 128, GQA 6:1, its 4096-token window inside a cache of 8192)
    "deepseek-moe": ("path", S_BATCH, DS_HEADS, DS_HEADS, S_PROMPT, S_CACHE,
                     MOE_HEAD_DIM, 0, True, S_CACHE, 0.0, "float32", 1.0),
    "mixtral": ("path", G_BATCH, MX_HEADS, MX_KV_HEADS, G_PROMPT, G_CACHE,
                MOE_HEAD_DIM, 0, True, MX_WINDOW, 0.0, "float32", 1.0),
    # the audio and vlm prefills: whisper's encoder over its 1500 frames
    # (non-causal), its decoder's self-attention over its cache of 160
    # and its cross attention over the frames (non-causal); pixtral's
    # trunk of 4064 rows (1024 patches and 3040 text) over its cache of
    # 4096 (GQA 4:1)
    "whisper-encoder": ("path", W_BATCH, W_HEADS, W_HEADS, W_FRAMES,
                        W_FRAMES, W_HEAD_DIM, 0, False, 10 ** 9, 0.0,
                        "float32", 1.0),
    "whisper-self": ("path", W_BATCH, W_HEADS, W_HEADS, W_PROMPT, W_CACHE,
                     W_HEAD_DIM, 0, True, W_CACHE, 0.0, "float32", 1.0),
    "whisper-cross": ("path", W_BATCH, W_HEADS, W_HEADS, W_PROMPT,
                      W_FRAMES, W_HEAD_DIM, 0, False, 10 ** 9, 0.0,
                      "float32", 1.0),
    "pixtral": ("path", P_BATCH, P_HEADS, P_KV_HEADS, P_TRUNK, P_CACHE,
                P_HEAD_DIM, 0, True, P_CACHE, 0.0, "float32", 1.0),
}
# the hd-160 calls are held to the float64 formula (at the sweep's f32
# tolerance), the others to the f32 plain version at FLASH_PATH_TOL
FLASH_F64_PATHS = ("stablelm", "stablelm-ragged", "zamba2", "deepseek-moe",
                   "mixtral", "whisper-encoder", "whisper-self",
                   "whisper-cross", "pixtral")
# calls whose whole (B, H, Sq, Sk) score tensor would not fit beside
# its copies (mixtral's, 25.7 GB in f32): their float64 formula, plain
# version and library call run a batch row and kv head at a time
# (`_by_group`), the same function with 1 / (B Hk) of the temporaries
FLASH_GROUPED = ("mixtral", "pixtral")


# the training attention (B10 asked for its rows' log-sum-exp, and JAX's
# backward in PyTorch) at the trainers' shapes, as the model passes them
# (transposed (B, S, H, hd) views): a [train] worker's (4 x 1024, 25
# heads of 64, causal), and gemma2-9b's heads (16 on 8 kv heads of 256)
# at 1024 tokens on a global and a local layer (window 512), q scaled
# so scores reach the softcap of 50
FLASH_TRAIN = {
    "gpt2-xl-train": ("path", TRAIN_BATCH // TRAIN_WORKERS, 25, KV_HEADS,
                      TRAIN_SEQ, TRAIN_SEQ, HEAD_DIM, 0, True, TRAIN_SEQ,
                      0.0, "float32", 1.0),
    "gemma2-train-global": ("path", 1, G_HEADS, G_KV_HEADS, 1024, 1024,
                            G_HEAD_DIM, 0, True, G_WINDOW, G_CAP,
                            "float32", 16.0),
    "gemma2-train-local": ("path", 1, G_HEADS, G_KV_HEADS, 1024, 1024,
                           G_HEAD_DIM, 0, True, 512, G_CAP, "float32",
                           16.0),
    # stablelm-12b's heads (32 on 8 kv heads of 160) at 4 x 1024 tokens
    "stablelm-train": ("path", 4, S_HEADS, S_KV_HEADS, 1024, 1024,
                       S_HEAD_DIM, 0, True, 1024, 0.0, "float32", 1.0),
    # a [train-zamba2] worker's shared block (4 x 1024, 32 heads of 80)
    "zamba2-train": ("path", TRAIN_BATCH // TRAIN_WORKERS, Z_HEADS, Z_HEADS,
                     TRAIN_SEQ, TRAIN_SEQ, Z_HEAD_DIM, 0, True, TRAIN_SEQ,
                     0.0, "float32", 1.0),
    # a [train-whisper] worker's encoder (4 x 1500 frames, non-causal) and
    # cross attention (448 decoder rows over the 1500 frames)
    "whisper-train-encoder": ("path", 4, W_HEADS, W_HEADS, W_FRAMES,
                              W_FRAMES, W_HEAD_DIM, 0, False, 10 ** 9, 0.0,
                              "float32", 1.0),
    "whisper-train-cross": ("path", 4, W_HEADS, W_HEADS, TW_SEQ, W_FRAMES,
                            W_HEAD_DIM, 0, False, 10 ** 9, 0.0, "float32",
                            1.0),
}
# against the float64 formula: o at the sweep's f32 tolerance, the lse
# at rtol = atol = 2e-5, and each of dq, dk, dv within 1e-4 of its
# largest |value| (the backward's f32 products over 1024 keys); bounds
# set before the first run on the card
TRAIN_LSE_TOL = 2e-5
TRAIN_GRAD_TOL = 1e-4


def _flash_inputs(torch, case, seed):
    """Head-major q, k, v; a path's case gives the views its prefill
    passes: transposes of (B, S, H, hd) queries and (B, Sc, Hk, hd)
    cache rows, read in place; an odd-stride case gives views with rows
    hd + 1 apart."""
    label, b, h, hk, sq, sk, hd, *_, dt, qs = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, dt)

    def draw(n, heads, s=1.0):
        if label == "path":
            x = torch.randn(b, n, heads, hd, generator=g, device="cuda") * s
            return x.to(dtype).transpose(1, 2)
        if label == "odd-stride":
            x = torch.randn(b, heads, n, hd + 1, generator=g,
                            device="cuda") * s
            return x.to(dtype)[..., 1:]
        x = torch.randn(b, heads, n, hd, generator=g, device="cuda") * s
        return x.to(dtype)
    return draw(sq, h, qs), draw(sk, hk), draw(sk, hk)


def _flash_kw(case):
    off, causal, window, cap = case[7:11]
    return dict(q_offset=off, causal=causal, window=window, softcap=cap)


def flash_ref64(torch, ref, q, k, v, *, causal, window, softcap, q_offset):
    """`ref.flash_attention_ref`'s formula, line for line, in float64
    (returned in f32): the yardstick of the f32 sweep.  The plain version
    rounds q k^T in f32 as one FMA chain along hd, so at hd 256 with
    scores near the softcap its own distance from this reaches 2.5e-5
    of (1 + |o|), past the sweep's 2e-5; B10's three TF32 passes, summed
    in another order, are held to the float64 value instead."""
    b, h, sq, hd = q.shape
    hk, sk = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, hk, h // hk, sq, hd)
    s = torch.matmul(qg, k.double()[:, :, None].transpose(-1, -2)) \
        * (1.0 / math.sqrt(hd))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    key = torch.arange(sk, device=q.device)[None, :]
    vis = key > pos - window
    if causal:
        vis &= key <= pos
    p = torch.softmax(torch.where(vis, s, ref.NEG_INF), dim=-1)
    out = torch.matmul(p, v.double()[:, :, None])
    return out.reshape(b, h, sq, hd).float()


def _by_group(torch, fn):
    """``fn(q, k, v)`` a batch row and kv head (with the query heads that
    read it) at a time, the outputs put back in place: attention's
    function with 1 / (B Hk) of its temporaries."""
    def call(q, k, v):
        b, h, hk = q.shape[0], q.shape[1], k.shape[1]
        g = h // hk
        return torch.cat([torch.cat([
            fn(q[i:i + 1, j * g:(j + 1) * g], k[i:i + 1, j:j + 1],
               v[i:i + 1, j:j + 1]) for j in range(hk)], 1)
            for i in range(b)])
    return call


def check_flash(torch, fa, ref, case, tol, f64=False, lse=False,
                grouped=False):
    """Kernel vs plain version (rtol = atol = tol), or (f64) vs the plain
    version's formula in float64; returns (max |diff| from the yardstick,
    max |diff| from the f32 plain version, and with f64 the f32 plain
    version's own max |diff| from the float64 formula and its count of
    elements past the tolerance).  With ``lse`` the kernel also writes
    the rows' log-sum-exp, held to the plain version's at the same
    tolerance; its max |diff| is returned last.  ``grouped``: the plain
    version and the formula run by `_by_group`."""
    q, k, v = _flash_inputs(torch, case, seed=sum(case[1:7]))
    kw = _flash_kw(case)
    lse_err = None
    if lse:
        got, got_lse = fa.flash_attention_fwd(q, k, v, return_lse=True,
                                              **kw)
        plain, plain_lse = ref.flash_attention_ref(q, k, v,
                                                   return_lse=True, **kw)
        torch.testing.assert_close(got_lse, plain_lse, rtol=tol, atol=tol)
        lse_err = (got_lse - plain_lse).abs().max().item()
        del got_lse, plain_lse
    else:
        got = fa.flash_attention_fwd(q, k, v, **kw)
        plain_fn = lambda *a: ref.flash_attention_ref(*a, **kw)  # noqa: E731
        plain = (_by_group(torch, plain_fn) if grouped else plain_fn)(
            q, k, v)
    f64_fn = lambda *a: flash_ref64(torch, ref, *a, **kw)  # noqa: E731
    want = (_by_group(torch, f64_fn) if grouped else f64_fn)(q, k, v) \
        if f64 else plain
    torch.cuda.synchronize()
    assert got.shape == plain.shape and got.dtype == plain.dtype, case
    diff = (got.float() - want.float()).abs()
    bad = int((diff > tol + tol * want.float().abs()).sum())
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention_fwd {case}: {bad} elements "
                             f"past rtol = atol = {tol} (max |diff| "
                             f"{diff.max().item()})")
    err = diff.max().item()
    err_plain = (got.float() - plain.float()).abs().max().item()
    plain_off = (plain.float() - want.float()).abs()
    plain_err = plain_off.max().item()
    plain_bad = int((plain_off > tol + tol * want.float().abs()).sum())
    del q, k, v, got, want, plain, diff, plain_off
    torch.cuda.empty_cache()
    return err, err_plain, plain_err, plain_bad, lse_err


def visible_scores(torch, sq, sk, q_offset, causal, window) -> int:
    """Visible (query, key) pairs of one head: the work the kernel's
    data needs."""
    pos = torch.arange(sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(pos, max=sk - 1) if causal else \
        torch.full_like(pos, sk - 1)
    lo = torch.clamp(pos - window + 1, min=0)
    return int(torch.clamp(hi - lo + 1, min=0).sum())


def _sdpa(torch, case):
    """The one PyTorch call computing B10's function where one exists:
    no softcap, so scaled_dot_product_attention with the boolean
    visibility mask (GQA through ``enable_gqa``; the port never calls
    it)."""
    _, b, h, hk, sq, sk, hd, off, causal, window, cap, *_ = case
    if cap > 0:
        return None
    pos = torch.arange(sq, device="cuda")[:, None] + off
    key = torch.arange(sk, device="cuda")[None, :]
    vis = key > pos - window
    if causal:
        vis &= key <= pos
    return lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=vis, enable_gqa=h != hk)


def time_flash(torch, fa, ref, case, lse=False, grouped=False):
    """(ms, ms_head_major, plain_ms, library_ms, bound_ms, bound_by,
    bytes, ops, pad_ms) at one path shape, ms on the path's views and
    ms_head_major on contiguous copies of them; the library call is
    checked equal to the kernel (rtol = atol = FLASH_PATH_TOL) before it
    is timed.  With ``lse`` the kernel and the plain version also write
    the rows' log-sum-exp (its bytes counted); the library call computes
    the output alone.  The bound counts the call's own head dim, whatever
    width the kernel computes; ``pad_ms`` times a padded head dim's
    three copies apart (None at the kernel's own widths).  ``grouped``:
    the plain version and the library call run by `_by_group`, their
    times those of the whole loop."""
    _, b, h, hk, sq, sk, hd, off, causal, window, cap, *_ = case
    kw = dict(_flash_kw(case), **({"return_lse": True} if lse else {}))
    one = _flash_inputs(torch, case, seed=1)
    out = fa.flash_attention_fwd(*one, **kw)
    outs = list(out) if lse else [out]
    nbytes = _bytes(one, outs)
    library = _sdpa(torch, case)
    if grouped and library is not None:
        library = _by_group(torch, library)
    if library is not None:
        torch.testing.assert_close(library(*one), outs[0],
                                   rtol=FLASH_PATH_TOL, atol=FLASH_PATH_TOL)
    del out, outs
    n_sets = max(1, min(16, math.ceil(120e6 / nbytes)))  # > 50 MB of L2
    sets = [one] + [_flash_inputs(torch, case, seed=2 + i)
                    for i in range(n_sets - 1)]
    big = nbytes > 1e8
    launches, reps = (2, 3) if big else (40, 5)
    ms = device_ms(torch, lambda *a: fa.flash_attention_fwd(*a, **kw), sets,
                   launches, reps)
    # the same data laid out head-major and contiguous: what reading the
    # prefill's views in place costs or saves the kernel
    dense = [[t.contiguous() for t in one_set] for one_set in sets]
    ms_head_major = device_ms(
        torch, lambda *a: fa.flash_attention_fwd(*a, **kw), dense, launches,
        reps)
    del dense
    # a head dim the wrapper zero-pads (zamba2's 80 to 96): the three
    # copies, inside ms, timed apart
    width = fa.PADDED_HEAD_DIMS.get(hd)
    pad_ms = None if width is None else device_ms(
        torch, lambda *a: [fa.pad_head_dim(t, width) for t in a], sets,
        launches, reps)
    plain = lambda *a: ref.flash_attention_ref(*a, **kw)  # noqa: E731
    plain_ms = device_ms(torch, _by_group(torch, plain) if grouped
                         else plain, sets, launches, reps)
    library_ms = None if library is None else \
        device_ms(torch, library, sets, launches, reps)
    del sets, one
    torch.cuda.empty_cache()
    ops = 4 * b * h * hd * visible_scores(torch, sq, sk, off, causal,
                                              window)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return ms, ms_head_major, plain_ms, library_ms, max(bytes_ms, ops_ms), \
        bound_by, nbytes, ops, pad_ms


def tensor_core_bound_ms(ops, nbytes) -> float:
    """B10's bound on the tensor cores: its 3 TF32 passes over the
    visible scores' operations at the dense TF32 rate, or the bytes."""
    return max(TF32_PASSES * ops / TF32_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S) * 1e3


def flash_phase(torch, fa, ref):
    """[flash-check] and B10's [kernel-time] rows; returns its kernels
    row (numbers at the gpt2-xl prefill shape, the gemma2 layers'
    beside them)."""
    # f32 sweep against the float64 yardstick, bf16 and the paths against
    # the f32 plain version; the distance from the f32 plain version is
    # printed for every case
    errs = {"float32": 0.0, "bfloat16": 0.0}
    errs_plain = {"float32": 0.0, "bfloat16": 0.0}
    plain_f64, plain_past = 0.0, 0
    for case in FLASH_SWEEP:
        dt = case[11]
        e, e_plain, p_err, p_bad, _ = check_flash(
            torch, fa, ref, case, FLASH_TOL[dt], f64=dt == "float32")
        errs[dt] = max(errs[dt], e)
        errs_plain[dt] = max(errs_plain[dt], e_plain)
        if dt == "float32":
            plain_f64, plain_past = max(plain_f64, p_err), plain_past + p_bad
    path_errs, lse_errs = {}, {}
    for name, case in FLASH_PATHS.items():
        f64 = name in FLASH_F64_PATHS
        path_errs[name] = check_flash(
            torch, fa, ref, case, FLASH_TOL["float32"] if f64
            else FLASH_PATH_TOL, f64=f64, grouped=name in FLASH_GROUPED)[0]
    for name, case in FLASH_TRAIN.items():     # the kernel with its lse
        res = check_flash(torch, fa, ref, case, FLASH_PATH_TOL, lse=True)
        path_errs[name], lse_errs[name] = res[0], res[-1]
    phase("flash-check", cases=len(FLASH_SWEEP) + len(FLASH_PATHS)
          + len(FLASH_TRAIN),
          max_abs_err_sweep=json.dumps(errs),
          sweep_yardstick=json.dumps({"float32": "float64 formula",
                                      "bfloat16": "f32 plain version"}),
          max_abs_err_sweep_vs_f32_plain=json.dumps(errs_plain),
          f32_plain_vs_float64=plain_f64,
          f32_plain_elements_past_tol=plain_past,
          tolerance_sweep=json.dumps(FLASH_TOL),
          max_abs_err_paths=json.dumps(path_errs),
          max_abs_err_train_lse=json.dumps(lse_errs),
          tolerance_paths=FLASH_PATH_TOL,
          paths_vs_float64=json.dumps({n: FLASH_TOL["float32"]
                                       for n in FLASH_F64_PATHS}))
    timed = {}
    for name, case in [*FLASH_PATHS.items(), *FLASH_TRAIN.items()]:
        lse = name in FLASH_TRAIN
        ms, ms_head_major, plain_ms, library_ms, bound_ms, bound_by, \
            nbytes, ops, pad_ms = time_flash(torch, fa, ref, case, lse=lse,
                                             grouped=name in FLASH_GROUPED)
        bound_tc_ms = tensor_core_bound_ms(ops, nbytes)
        # bound_ms: the f32 units' rate; bound_tc_ms: the tensor cores'
        # (tflops: the visible scores' operations a second; tflops_tc:
        # the TF32 operations of the 3 passes a second, against 495)
        phase("kernel-time", name="flash_attention_fwd", path=name,
              return_lse=lse, shape=json.dumps(list(case[1:7])),
              window=case[9],
              softcap=case[10], bytes=nbytes, ops=ops, ms=f"{ms:.6f}",
              ms_head_major=f"{ms_head_major:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound_ms:.6f}",
              bound_by=bound_by, bound_tc_ms=f"{bound_tc_ms:.6f}",
              tc_peak_tflops=TF32_OPS_PER_S / 1e12,
              library_ms=None if library_ms is None
              else f"{library_ms:.6f}",
              tflops=f"{ops / ms / 1e9:.3f}",
              tflops_tc=f"{TF32_PASSES * ops / ms / 1e9:.3f}",
              pad_ms=None if pad_ms is None else f"{pad_ms:.6f}")
        timed[name] = {"shape": list(case[1:7]), "window": case[9],
                       "softcap": case[10], "ms": ms,
                       "ms_head_major": ms_head_major, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_tc_ms": bound_tc_ms,
                       "library_ms": library_ms, "pad_ms": pad_ms,
                       "max_abs_err": path_errs[name]}
        if lse:
            timed[name]["max_abs_err_lse"] = lse_errs[name]
    row = {"name": "flash_attention_fwd", "route": "cuda",
           "source": FLASH_SOURCE, "replaces": REPLACES["flash_attention_fwd"],
           "launches": 0, "max_abs_err": max(errs["float32"],
                                             *path_errs.values()),
           "max_abs_err_bf16": errs["bfloat16"],
           "max_abs_err_sweep_vs_f32_plain": errs_plain["float32"]}
    row.update({k: timed["gpt2-xl"][k] for k in (
        "ms", "ms_head_major", "plain_ms", "bound_ms", "bound_by",
        "bound_tc_ms", "library_ms", "shape")})
    # the other paths' calls, and with the rows' lse the training paths'
    for name in timed:
        if name != "gpt2-xl":
            row[name.replace("-", "_")] = timed[name]
    return row


def train_attn64(torch, ref, q, k, v, *, window, cap, causal=True):
    """The training attention's formula in float64, differentiable: (o
    (B, Sq, H, hd), lse (B, H, Sq)); q (B, Sq, H, hd), k and v (B, Sk,
    Hk, hd), query i and key j at positions i and j."""
    b, s, h, hd = q.shape
    grp = h // k.shape[2]
    kk, vv = (t.repeat_interleave(grp, dim=2) for t in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kk) * (1.0 / math.sqrt(hd))
    if cap > 0:
        sc = cap * torch.tanh(sc / cap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    sc = torch.where(((j <= i) | (not causal)) & (j > i - window), sc,
                     ref.NEG_INF)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), vv)
    return o, torch.logsumexp(sc, dim=-1)


def flash_train_phase(torch, fa, ref, qp):
    """[flash-train-check]: the training attention at the trainers'
    shapes against its formula in float64 (B10's o and lse; the
    Function's dq, dk, dv), B10's o bit-identical without the lse, and
    remat on and off bit-equal on the card."""
    from repro_torch.models import layers as L
    errs = {}
    for name, case in FLASH_TRAIN.items():
        causal, window, cap = case[8:11]
        q, k, v = _flash_inputs(torch, case, seed=sum(case[1:7]))
        kw = dict(causal=causal, window=window, softcap=cap)
        qp.reset_launches()
        o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        same = torch.equal(o, fa.flash_attention_fwd(q, k, v, **kw))
        assert qp.LAUNCHES["flash_attention_fwd"] == 2
        # the Function on the model's (B, S, H, hd) tensors
        leaves = [t.transpose(1, 2).clone().requires_grad_()
                  for t in (q, k, v)]
        g = torch.randn(leaves[0].shape, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(5))
        out = L.flash_attention(*leaves, window=window, attn_softcap=cap,
                                causal=causal)
        grads = torch.autograd.grad(out, leaves, g)
        same_fn = torch.equal(out.detach(), o.transpose(1, 2))
        ref64 = [t.detach().double().requires_grad_() for t in leaves]
        o64, lse64 = train_attn64(torch, ref, *ref64, window=window,
                                  cap=cap, causal=causal)
        grads64 = torch.autograd.grad(o64, ref64, g.double())
        torch.cuda.synchronize()
        tol = FLASH_TOL["float32"]
        o_err = (o.transpose(1, 2).double() - o64).abs()
        lse_err = (lse.double() - lse64).abs()
        e = {"o": o_err.max().item(), "lse": lse_err.max().item(),
             "o_bit_identical_without_lse": same,
             "function_o_is_b10": same_fn}
        bad_o = int((o_err > tol + tol * o64.abs()).sum())
        bad_lse = int((lse_err > TRAIN_LSE_TOL
                       + TRAIN_LSE_TOL * lse64.abs()).sum())
        for n, got, want in zip(("dq", "dk", "dv"), grads, grads64):
            e[n] = (got.double() - want).abs().max().item()
            e[n + "_over_max"] = e[n] / want.abs().max().item()
        errs[name] = e
        del q, k, v, o, lse, leaves, out, grads, ref64, o64, lse64, grads64
        torch.cuda.empty_cache()
        assert same and same_fn, (name, e)
        assert bad_o == 0 and bad_lse == 0, (name, bad_o, bad_lse, e)
        assert all(e[n + "_over_max"] <= TRAIN_GRAD_TOL
                   for n in ("dq", "dk", "dv")), (name, e)
    remat = remat_bit_equal(torch, qp)
    phase("flash-train-check", cases=json.dumps(list(FLASH_TRAIN)),
          errs=json.dumps(errs), remat=json.dumps(remat),
          tolerance=f"o rtol=atol={FLASH_TOL['float32']} lse rtol=atol="
                    f"{TRAIN_LSE_TOL} grads max|diff|/max|ref| <= "
                    f"{TRAIN_GRAD_TOL}; float64 formula")
    return errs


def remat_bit_equal(torch, qp):
    """`loss_fn` and its gradients with remat off and on, bit for bit:
    gpt2-xl-paper's, gemma2-9b's and stablelm-12b's (the untied head)
    SMOKE models (2 stage groups) and gpt2-xl-paper at full
    width cut to 4 layers (a [train] worker's 4 x 1024 tokens); B10
    launched once a layer, twice with remat."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as Mo
    out = {}
    for arch, smoke, layers, (b, s) in (
            ("gpt2-xl-paper", True, 2, (2, 40)),
            ("gemma2-9b", True, 2, (2, 40)),
            ("stablelm-12b", True, 2, (2, 40)),
            ("gpt2-xl-paper", False, 4, (TRAIN_BATCH // TRAIN_WORKERS,
                                         TRAIN_SEQ))):
        cfg = get_config(arch, smoke=smoke).with_(num_layers=layers)
        model = Mo.Transformer(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1].to("cuda"),
                 "targets": toks[:, 1:].to("cuda"),
                 "mask": torch.ones(b, s, device="cuda")}
        params = list(model.parameters())
        runs = []
        for remat in (False, True):
            qp.reset_launches()
            loss, _ = Mo.loss_fn(model, batch, num_stages=2, remat=remat)
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            runs.append((loss.detach(), grads,
                         qp.LAUNCHES["flash_attention_fwd"]))
        equal = torch.equal(runs[0][0], runs[1][0]) and all(
            torch.equal(x, y) for x, y in zip(runs[0][1], runs[1][1]))
        key = f"{arch}{'-smoke' if smoke else ''}-{layers}L"
        out[key] = {"bit_equal": equal,
                    "launches": [runs[0][2], runs[1][2]]}
        del model, runs, params
        torch.cuda.empty_cache()
        assert equal, key
        assert out[key]["launches"] == [layers, 2 * layers], out[key]
    return out


# ---------------------------------------------------------------------------
# phase 5: the port on the card against the port on the CPU
# ---------------------------------------------------------------------------

class HopTap:
    """The 4-bit aqsgd hop's decode crossing, tapped.  On the card it
    records each crossing's input h, the reference m before it and the
    message m_new (the receiver's output), on the CPU.  On the CPU, given
    the card's tap, it holds each crossing's rows (``rows()``, every row
    by default) against the card's record of the same crossing
    (`hop_sync`) and, where a rounding near-tie put one code on the
    other side, carries the card's message on in that row, so the row
    is compared to the end.  Stands in for the codec
    (``init_state``/``boundary_fn``)."""

    def __init__(self, hop, card=None, rows=None):
        self.hop, self.card, self.rows = hop, card, rows
        self.log, self.flips = [], []

    def init_state(self, *args, **kwargs):
        return self.hop.init_state(*args, **kwargs)

    def boundary_fn(self, *, prefill):
        return self.hop.prefill_boundary if prefill else self.decode

    def decode(self, state, h, idx):
        m = state["m"][idx].clone()
        state, out = self.hop.decode_boundary(state, h, idx)
        step = len(self.log)
        self.log.append((h.detach().cpu().clone(), m.cpu(),
                         out.detach().cpu().clone()))
        if self.card is None:
            return state, out
        hg, mg, ng = self.card.log[step]
        rows = range(h.shape[0]) if self.rows is None else self.rows()
        for r in rows:
            flip = hop_sync(h[r], m[r], out[r], hg[r], mg[r], ng[r])
            if flip is not None:
                out[r] = ng[r]
                state["m"][idx][r] = ng[r]
                self.flips.append(dict(flip, row=r, crossing=step))
        return state, out


def hop_sync(hc, mc, nc, hg, mg, ng):
    """One row of one hop crossing, the CPU's (input hc, reference mc,
    message nc) against the card's (hg, mg, ng), all (1, d) on the CPU.
    The card's message must be the plain encoder's on the card's own
    inputs, bit for bit (so its kernel rounded each element as the plain
    version does).  None when the two messages agree within HOP_NOISE.
    Else exactly one element differs, by one code, and its values before
    rounding, ``(delta / s + 1) * lv / 2`` from each side's own inputs
    and scale, lie within HOP_TIE (of a code step) of each other and
    round to neighbouring codes: a rounding near-tie, returned.
    Anything else fails."""
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ref

    replay = ref.delta_quantize_pack_ref(hg, mg, HOP_BITS)[2]
    assert replay.equal(ng), \
        ("the card's hop message is not the plain encoder's on its inputs",
         (replay - ng).abs().max().item())
    diff = (nc - ng).abs().flatten()
    if diff.max().item() <= HOP_NOISE:
        return None
    off = (diff > HOP_NOISE).nonzero().flatten().tolist()
    lv = Q.levels(HOP_BITS)

    def before_rounding(h, m):
        x = h.float() - m.float()
        y = (x / Q.absmax_scale(x) + 1.0) * (0.5 * lv)
        return y.flatten()[off[0]].item()

    yc, yg = before_rounding(hc, mc), before_rounding(hg, mg)
    flip = {"element": off[0], "moved": diff.max().item(), "y_cpu": yc,
            "y_card": yg}
    assert len(off) == 1, ("hop message off in more than one element",
                           off, flip)
    assert abs(yc - yg) <= HOP_TIE and abs(round(yc) - round(yg)) == 1, \
        ("hop message off where no rounding near-tie is", flip)
    return flip


class KVTap:
    """The 8-bit KV codec's appends, tapped (as `HopTap` taps the hop).
    On the card it records each append's fresh k and v values and the
    codes and scales it wrote, on the CPU.  On the CPU, given the card's
    tap, it holds each append's rows (``rows()``, every row by default;
    every row of a B = 1 prefill's row cache) against the card's record
    of the same append (`kv_sync`) and, where a rounding near-tie put a
    code on the other side, carries the card's codes and scale on in
    that group, so later steps read the card's store.  ``flips`` and
    ``codes`` count the codes that differed and those compared.
    Stands in for the codec (``append_pair``; the rest passes
    through)."""

    def __init__(self, kv, card=None, rows=None):
        assert kv.bits == 8 and not kv.stochastic, kv
        self.kv, self.card, self.rows = kv, card, rows
        self.log, self.flips, self.codes = [], [], 0

    def __getattr__(self, name):
        return getattr(self.kv, name)

    def append_pair(self, codes, scales, values, pos, *, generator=None):
        import torch
        from repro_torch.core.cache_rows import clamp_heads

        self.kv.append_pair(codes, scales, values, pos, generator=generator)
        b, cache = codes[0].shape[:2]
        n = values[0].shape[1]
        heads = clamp_heads(pos, cache, n).cpu() \
            if isinstance(pos, torch.Tensor) else torch.full((b,), pos)
        at = (heads[:, None] + torch.arange(n)).to(codes[0].device)
        rid = torch.arange(b, device=codes[0].device)[:, None]
        step = len(self.log)
        self.log.append(tuple(
            (v.detach().cpu().clone(), c[rid, at].cpu(), s[rid, at].cpu())
            for v, c, s in zip(values, codes, scales)))
        if self.card is None:
            return
        rows = range(b) if self.rows is None or b == 1 else self.rows()
        for j, ((vc, cc, sc), (vg, cg, sg)) in enumerate(
                zip(self.log[step], self.card.log[step])):
            for r in rows:
                sync = kv_sync(vc[r], cc[r], sc[r], vg[r], cg[r], sg[r])
                self.codes += cc[r].numel()
                if sync is None:
                    continue
                carry, gap = sync
                cr, sr = codes[j][r, at[r]], scales[j][r, at[r]]
                cr[carry] = cg[r][carry].to(cr.device)
                sr[carry] = sg[r][carry].to(sr.device)
                codes[j][r, at[r]], scales[j][r, at[r]] = cr, sr
                self.flips.append({"append": step, "kv": "kv"[j], "row": r,
                                   "codes": int((cc[r] != cg[r]).sum()),
                                   "gap": gap})


def kv_sync(vc, cc, sc, vg, cg, sg):
    """One row of one 8-bit KV append, the CPU's (fresh values vc (s, Hk,
    hd), codes cc (s, Hk, G, group), scales sc (s, Hk, G)) against the
    card's (vg, cg, sg), all on the CPU.  The card's codes and scales
    must be the plain encoder's on the card's own values, bit for bit.
    None when the codes agree.  Else each code that differs does so by
    one, and its values before rounding, ``(x / s + 1) * 255 / 2`` from
    each side's own values and scale, lie within KV_TIE (of a code step)
    of each other: a rounding near-tie.  Returns the groups (s, Hk, G)
    to carry and the largest such gap.  Anything else fails."""
    from repro_torch.serving import KVCodec

    want_c, want_s = KVCodec(bits=8).encode(vg)
    assert want_c.equal(cg) and want_s.equal(sg), \
        "the card's KV codes are not the plain encoder's on its inputs"
    off = cc != cg
    if not off.any():
        return None
    assert (cc.int() - cg.int()).abs().max().item() == 1, \
        "a KV code off by more than one"

    def before_rounding(v, s):
        return (v.float().reshape(cc.shape) / s[..., None] + 1.0) * 127.5

    gap = (before_rounding(vc, sc) - before_rounding(vg, sg)).abs()[off]
    gap = gap.max().item()
    assert gap <= KV_TIE, ("a KV code off where no rounding near-tie is",
                           gap)
    return off.any(-1), gap


def reference_check(torch, arch="gpt2-xl-paper", p=8, n=6,
                    tag="reference-check", kv_bits=None, carry_kv=False,
                    **cfg_kw):
    """The SMOKE model of ``arch`` (its config fields ``cfg_kw``
    replaced) served on the card (kernels) against the same weights,
    drawn on the CPU, served on the CPU (plain versions): prompt ``p``,
    then ``n`` teacher-forced decode steps, every row compared at every
    step.  The card runs first; where a rounding near-tie put one
    element of a row's hop message on the other side (`HopTap`,
    `hop_sync`), the CPU carries the card's message on in that row
    (printed).  The KV codec is 8-bit (the ssm family keeps no KV, and
    it passes through), or raw for the hybrid family (JAX's rule), or
    ``kv_bits`` where given.  With ``carry_kv`` every append's fresh KV
    codes are held against the card's as they are written, and where a
    rounding near-tie put a code on the other side the CPU carries the
    card's on (`KVTap`; the flips are counted there).  An
    ssm or hybrid model's final states, and an audio model's cross
    caches, are held to PREFILL_ATOL scaled to each one's largest
    magnitude.  An audio or vlm model's prefill takes stub frames or
    patches (`data.pipeline.with_stub_media`, seed 2), a vlm cache the
    patches' rows too."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import with_stub_media
    from repro_torch.models.model import Transformer
    from repro_torch.serving import DeltaHopCodec, KVCodec

    cfg = get_config(arch, smoke=True).with_(**cfg_kw)
    # one CPU generator seeds both: the weights do not depend on the device
    cpu, gpu = (Transformer(cfg, device=dev,
                            generator=torch.Generator().manual_seed(0))
                for dev in ("cpu", "cuda"))
    b = 2
    toks = torch.randint(0, cfg.vocab_size, (b, p + n),
                         generator=torch.Generator().manual_seed(1))
    kv = KVCodec(bits=(0 if cfg.family == "hybrid" else 8)
                 if kv_bits is None else kv_bits)
    hop = DeltaHopCodec(mode="aqsgd", bits=4)
    media = {k: torch.from_numpy(v) for k, v in with_stub_media(
        cfg, {"tokens": toks}, seed=2, step=0).items() if k != "tokens"}

    def run(model, dev, tap, kvc):
        c = model.init_caches(b, p + n + cfg.num_patches, torch.float32,
                              kv_codec=kvc)
        c["hop_m"] = tap.init_state(1, b, cfg.d_model, device=dev)["m"]
        t = toks.to(dev)
        logits = []
        for i, fn in enumerate([tap.boundary_fn(prefill=True)]
                               + [tap.boundary_fn(prefill=False)] * n):
            x = t[:, :p] if i == 0 else t[:, p + i - 1:p + i]
            extra = {k: v.to(dev) for k, v in media.items()} if i == 0 \
                else {}
            lg, c = model.forward_with_caches(x, c, logits_last_only=True,
                                              num_stages=2, boundary_fn=fn,
                                              kv_codec=kvc, **extra)
            logits.append(lg.cpu())
        return logits, c

    card = HopTap(hop)
    kv_card = KVTap(kv) if carry_kv else kv
    lg, cg = run(gpu, "cuda", card, kv_card)
    tap = HopTap(hop, card=card)
    kv_tap = KVTap(kv, card=kv_card) if carry_kv else kv
    lc, cc = run(cpu, "cpu", tap, kv_tap)
    assert len(tap.log) == len(card.log) == n
    pre = (lc[0] - lg[0]).abs().max().item()
    dec = max((lc[i] - lg[i]).abs().max().item() for i in range(1, n + 1))
    flips = total = 0
    for name in ("k_codes", "v_codes"):
        if name not in cc:
            continue
        diff = (cc[name].int() - cg[name].cpu().int()).abs()
        assert diff.max().item() <= 1, name
        flips += int((diff > 0).sum())
        total += diff.numel()
    if carry_kv:
        assert len(kv_tap.log) == len(kv_card.log) > 0
        flips = sum(f["codes"] for f in kv_tap.flips)
        total = kv_tap.codes
    # the final states, each held to PREFILL_ATOL scaled to its magnitude
    states = {name: (cc[name] - cg[name].cpu()).abs().max().item()
              for name in ("ssm", "conv", "k", "v", "xk", "xv")
              if name in cc}
    state_tol = {name: PREFILL_ATOL * max(1.0, cc[name].abs().max().item())
                 for name in states}
    phase(tag, arch=arch, kv_bits=kv.bits, media=json.dumps(
              {k: list(v.shape) for k, v in media.items()}),
          prompt=p, decode_steps=n, prefill_max_abs=pre,
          decode_max_abs=dec, kv_code_flips=f"{flips}/{total}",
          head_dim=cfg.head_dim, cache_max_abs=json.dumps(states),
          cache_tol=json.dumps(state_tol),
          hop_flips_carried=json.dumps(tap.flips),
          kv_flips_carried=json.dumps(kv_tap.flips) if carry_kv else None,
          tolerance=f"prefill {PREFILL_ATOL} decode {DECODE_ATOL} flips <= "
                    f"{MAX_FLIP_FRACTION}; hop near-tie {HOP_TIE} code"
                    + (f"; KV near-tie {KV_TIE} code" if carry_kv else ""))
    assert pre <= PREFILL_ATOL, pre
    assert dec <= DECODE_ATOL, dec
    assert flips <= MAX_FLIP_FRACTION * total, (flips, total)
    for name, err in states.items():
        assert err <= state_tol[name], (name, err, state_tol[name])


def serve_continuous_phase(torch, qp, serve):
    """[serve-continuous]: the launcher's --continuous run at gpt2-xl
    full size, its counters set to 0 just before and read just after;
    returns (its output, its launches)."""
    from repro_torch.serving import DeltaHopCodec, KVCodec, delta

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qp.reset_launches()
    delta.reset_sent()
    out = serve.main(CONT_ARGS)
    torch.cuda.synchronize()
    launches = dict(qp.LAUNCHES)
    sent = dict(delta.SENT)
    peak = torch.cuda.max_memory_allocated()
    reqs, ticks, adm = out["requests"], out["ticks"], out["admissions"]
    cfg = out["model"].cfg
    layers = cfg.num_layers
    hop_model = DeltaHopCodec(mode="aqsgd", bits=4).hop_bytes(
        CONT_SLOTS, cfg.d_model) * ticks
    kv_model = KVCodec(bits=8).stored_bytes(
        (CONT_SLOTS, CACHE_LEN, cfg.num_kv_heads, cfg.head_dim)) * 2 * layers
    phase("serve-continuous", layers=layers, d_model=cfg.d_model,
          slots=CONT_SLOTS,
          requests=len(reqs), prompt_lens=json.dumps([len(r.prompt)
                                                      for r in reqs]),
          cache=out["cache_len"], admissions=adm, ticks=ticks,
          tokens=out["tokens"], decode_tokens=out["decode_tokens"],
          wall_s=f"{out['wall_s']:.4f}", tok_s=f"{out['tok_s']:.2f}",
          prefill_s=f"{out['prefill_s']:.4f}",
          decode_s=f"{out['decode_s']:.4f}",
          decode_tok_s=f"{out['decode_tok_s']:.2f}",
          ms_per_tick=f"{out['decode_s'] / ticks * 1e3:.3f}",
          peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
          hops=sent["hops"], hop_bytes=sent["bytes"],
          hop_bytes_model=hop_model, kv_store_bytes=out["kv_store_bytes"],
          kv_store_bytes_model=kv_model)
    assert (layers, cfg.d_model) == (48, D_MODEL), (layers, cfg.d_model)
    assert len(reqs) == CONT_REQUESTS and adm == CONT_REQUESTS, (len(reqs),
                                                                 adm)
    for r in reqs:
        assert r.state == "DONE" and not r.error, (r.state, r.error)
        assert len(r.tokens) == GEN, len(r.tokens)
    assert out["tokens"] == CONT_REQUESTS * GEN
    assert out["cache_len"] == CACHE_LEN
    want = {name: 0 for name in launches}
    want.update(flash_attention_fwd=layers * adm,
                quantize_pack=layers * (adm + ticks),
                unpack_dequant=layers * (adm + ticks),
                delta_quantize_pack=ticks, dequant_unpack_accumulate=ticks)
    assert launches == want, (launches, want)
    assert sent == {"hops": ticks, "bytes": hop_model}, sent
    assert out["kv_store_bytes"] == kv_model, out["kv_store_bytes"]
    return out, launches


def _slice_batcher(model, num_slots, cache_len, **kw):
    """A batcher with the slice's codecs: the 4-bit aqsgd hop over 2
    stage groups and 8-bit KV (raw for the hybrid family, JAX's rule;
    the ssm family's passes through)."""
    from repro_torch.serving import ContinuousBatcher, DeltaHopCodec, KVCodec
    bits = 0 if model.cfg.family == "hybrid" else 8
    return ContinuousBatcher(model, num_slots=num_slots, cache_len=cache_len,
                             kv_codec=KVCodec(bits=bits),
                             hop_codec=DeltaHopCodec(mode="aqsgd", bits=4),
                             num_stages=2, **kw)


def serve_continuous_isolation(torch, out):
    """[serve-continuous-isolation]: the mixed run's first and last
    requests, each served alone in a pool of the same slots on the card
    (the same model): their tokens equal their streams in the mixed
    run."""
    model = out["model"]
    reqs = out["requests"]
    picked = (0, len(reqs) - 1)
    alone = []
    for i in picked:
        bat = _slice_batcher(model, CONT_SLOTS, CACHE_LEN)
        r = bat.submit(reqs[i].prompt, max_new_tokens=GEN)
        bat.run()
        alone.append(r.tokens)
    same = [a == reqs[i].tokens for a, i in zip(alone, picked)]
    phase("serve-continuous-isolation", requests=json.dumps(list(picked)),
          prompt_lens=json.dumps([len(reqs[i].prompt) for i in picked]),
          slots=CONT_SLOTS, equal=json.dumps(same))
    assert all(same), (alone, [reqs[i].tokens for i in picked])


def serve_continuous_guard(torch):
    """[serve-continuous-guard]: tests/test_faults.py's fault test on the
    card: gpt2-xl-paper at full width cut to GUARD_LAYERS of 48 layers,
    the slice's codecs, 3 requests over 2 slots, 6 tokens each, a clean
    run against one with ``2:kv:nan-scale``."""
    import numpy as np
    from repro_torch.comm import faults
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Transformer

    cfg = get_config("gpt2-xl-paper").with_(num_layers=GUARD_LAYERS)
    model = Transformer(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 5, 4)]

    def run(plan):
        bat = _slice_batcher(model, 2, 16, fault_plan=plan)
        for p in prompts:
            bat.submit(p, max_new_tokens=6)
        return bat.run()

    base = run(None)
    hit = run(faults.FaultPlan.parse(GUARD_PLAN))
    victim = hit[0]
    same = [h.tokens == b.tokens for b, h in zip(base[1:], hit[1:])]
    phase("serve-continuous-guard", layers=f"{GUARD_LAYERS}/48",
          d_model=cfg.d_model, plan=GUARD_PLAN, slots=2,
          victim_error=f"'{victim.error}'",
          victim_tokens=len(victim.tokens), survivors_equal=json.dumps(same))
    assert all(r.state == "DONE" and not r.error for r in base)
    assert victim.state == "DONE" and len(victim.tokens) < 6
    assert "plane=kv" in victim.error and "tick=2" in victim.error
    assert all(not h.error for h in hit[1:]) and all(same)
    del model
    torch.cuda.empty_cache()


def continuous_reference_check(torch, arch,
                               tag="serve-continuous-reference-check",
                               carry_kv=False, **cfg_kw):
    """[serve-continuous-reference-check]: the batcher on the card
    (kernels) against the same SMOKE weights on the CPU (plain versions),
    in lockstep (no EOS, so both fill and free the same slots at the same
    ticks): 5 requests of 3-12 tokens over 3 slots, 6 tokens each.  Each
    tick's logits within DECODE_ATOL for every request whose stream still
    agrees, and every KV code of its row within one code, flips <=
    MAX_FLIP_FRACTION.  The card steps first; where a rounding near-tie
    put one element of a live stream's hop message on the other side
    (`HopTap`, `hop_sync`), the CPU carries the card's message on in
    that slot (printed), and the stream is compared on.  A stream that
    forks at a near tie (the CPU's top two logits within DECODE_ATOL
    where it forks) stops being compared from that tick, and is
    printed; one may, a second, or a fork at a wider gap, fails.  With
    ``carry_kv`` (the moe family: ``tag`` names its check) every append's
    fresh KV codes of a live stream are held against the card's as they
    are written, and a code a rounding near-tie put on the other side is
    carried on (`KVTap`; the flips counted there); the raw stores (a
    MoE model's dense prefix's pk/pv) are f32 then, as `reference_check`'s
    (bf16 stores round near-ties apart as the codes do, uncarried).
    ``cfg_kw`` replaces config fields (zamba2 at head_dim 80).  The ssm
    and hybrid families keep no KV codes (`_slice_batcher`): their bf16
    pool's conv windows (and the hybrid's raw k and v) feed the logits
    compared."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Transformer
    from repro_torch.serving import DeltaHopCodec

    window = CONT_CHECK_WINDOW.get(arch)
    cfg = get_config(arch, smoke=True).with_(**cfg_kw)
    if window:
        cfg = cfg.with_(sliding_window=window)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 12, 7, 5, 9)]
    live = {}
    hop = DeltaHopCodec(mode="aqsgd", bits=4)
    card = HopTap(hop)
    taps = (card, HopTap(hop, card=card, rows=lambda: list(live.values())))
    bats = []
    for dev, tap in zip(("cuda", "cpu"), taps):
        model = Transformer(cfg, device=dev,
                            generator=torch.Generator().manual_seed(0))
        bat = _slice_batcher(model, 3, 24, **(
            {"dtype": torch.float32} if carry_kv else {}))
        bat.hop_codec = tap
        for p in prompts:
            bat.submit(p, max_new_tokens=6)
        bats.append(bat)
    gpu, cpu = bats
    if carry_kv:
        gpu.kv_codec = KVTap(gpu.kv_codec)
        cpu.kv_codec = KVTap(cpu.kv_codec, card=gpu.kv_codec,
                             rows=lambda: list(live.values()))

    def cpu_prefill_logits(prompt):
        # outside the KV tap: the card made no such append
        codec = cpu.kv_codec
        cpu.kv_codec = getattr(codec, "kv", codec)
        try:
            return cpu._prefill(prompt)[0][0]
        finally:
            cpu.kv_codec = codec

    def gap(logits):
        top = torch.topk(logits, 2).values
        return float(top[0] - top[1])

    forked, dec, flips, total, worst = {}, 0.0, 0, 0, 0

    def fork_check(j, logits):
        rc, rg = cpu.requests[j], gpu.requests[j]
        if j not in forked and rc.tokens != rg.tokens:
            forked[j] = {"at_token": len(rc.tokens) - 1, "cpu": rc.tokens,
                         "card": rg.tokens, "cpu_top2_gap": gap(logits())}

    while True:
        before = [r.state for r in cpu.requests]
        for bat in bats:
            bat._admit()
        for j, r in enumerate(cpu.requests):
            if before[j] == "PENDING" and r.state != "PENDING":
                fork_check(j, lambda: cpu_prefill_logits(r.prompt))
        if all(r.state == "DONE" for r in cpu.requests):
            break
        live.clear()
        live.update({j: r.slot for j, r in enumerate(cpu.requests)
                     if r.state == "ACTIVE" and j not in forked})
        assert live == {j: r.slot for j, r in enumerate(gpu.requests)
                        if r.state == "ACTIVE" and j not in forked}
        for bat in bats:
            bat.step()
        lc, lg = cpu.last_logits, gpu.last_logits.cpu()
        for j, i in live.items():
            dec = max(dec, (lc[i] - lg[i]).abs().max().item())
            for name in ("k_codes", "v_codes"):
                if name not in cpu.caches:
                    continue
                d = (cpu.caches[name][:, i].int()
                     - gpu.caches[name][:, i].cpu().int()).abs()
                worst = max(worst, d.max().item())
                flips += int((d > 0).sum())
                total += d.numel()
            fork_check(j, lambda: lc[i])
    if carry_kv:
        assert len(cpu.kv_codec.log) == len(gpu.kv_codec.log) > 0
        flips = sum(f["codes"] for f in cpu.kv_codec.flips)
        total = cpu.kv_codec.codes
    phase(tag, arch=arch, head_dim=cfg.head_dim,
          window=window, requests=len(prompts), slots=3,
          ticks=cpu._tick, streams_equal=len(prompts) - len(forked),
          forked_at_near_tie=json.dumps(forked),
          hop_flips_carried=json.dumps(taps[1].flips), decode_max_abs=dec,
          kv_code_max_diff=worst, kv_code_flips=f"{flips}/{total}",
          kv_flips_carried=json.dumps(cpu.kv_codec.flips)
          if carry_kv else None,
          tolerance=f"decode {DECODE_ATOL} flips <= {MAX_FLIP_FRACTION}; "
                    f"hop near-tie {HOP_TIE} code; forks <= 1"
                    + (f"; KV near-tie {KV_TIE} code" if carry_kv else ""))
    assert cpu._tick == gpu._tick == len(card.log) == len(taps[1].log)
    assert all(r.state == "DONE" and len(r.tokens) == 6
               for r in cpu.requests + gpu.requests)
    assert len(forked) <= 1, forked
    for f in forked.values():
        assert f["cpu_top2_gap"] <= DECODE_ATOL, f
    assert dec <= DECODE_ATOL, dec
    assert worst <= 1, worst
    assert flips <= MAX_FLIP_FRACTION * total, (flips, total)
    assert cfg.family != "ssm" or not any(
        n in bat.caches for bat in bats
        for n in ("k", "v", "k_codes", "v_codes")), "ssm KV store"


class RouteTap:
    """While active, records every MoE dispatch's routing
    (`repro_torch.models.moe.route`): its device, the router's
    probabilities, ``top_i`` and the keep mask, on the CPU."""

    def __enter__(self):
        from repro_torch.models import moe
        self.log, self._moe, self._route = [], moe, moe.route

        def tapped(p, xg, top_k, cap):
            r = self._route(p, xg, top_k, cap)
            self.log.append({"device": xg.device.type, **{
                k: r[k].detach().cpu() for k in ("probs", "top_i", "keep")}})
            return r
        moe.route = tapped
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def compare(self, torch, top_k) -> dict:
        """The card's dispatches against the CPU's, in order: ``top_i``
        (as each token's set of experts) equal for every token whose
        k-th and (k+1)-th CPU probabilities lie more than ROUTE_MARGIN
        apart, the keep mask equal for every dispatch all of whose
        tokens do; fails otherwise.  Returns the counts compared and
        the dropped slots."""
        cpu = [r for r in self.log if r["device"] == "cpu"]
        card = [r for r in self.log if r["device"] == "cuda"]
        assert len(cpu) == len(card) > 0, (len(cpu), len(card))
        out = {"dispatches": len(cpu), "tokens": 0, "tokens_clear": 0,
               "keep_compared": 0, "dropped": 0, "probs_max_abs": 0.0}
        for c, g in zip(cpu, card):
            top = torch.sort(c["probs"], dim=-1, descending=True).values
            clear = top[..., top_k - 1] - top[..., top_k] > ROUTE_MARGIN \
                if top.shape[-1] > top_k else torch.ones(top.shape[:-1],
                                                         dtype=torch.bool)
            same = (c["top_i"].sort(-1).values
                    == g["top_i"].sort(-1).values).all(-1)
            assert bool(same[clear].all()), "routing differs past the margin"
            out["tokens"] += clear.numel()
            out["tokens_clear"] += int(clear.sum())
            out["probs_max_abs"] = max(out["probs_max_abs"], (
                c["probs"] - g["probs"]).abs().max().item())
            for i in range(clear.shape[0]):
                if clear[i].all():
                    assert c["keep"][i].equal(g["keep"][i]), "keep differs"
                    out["keep_compared"] += 1
            out["dropped"] += int((~c["keep"]).sum())
        return out


def moe_reference_check(torch, arch, p, n, tag):
    """[serve-<arch>-reference-check] for the moe family: `reference_check`
    at ``capacity_factor`` 1.25 with the 8-bit KV cache, the card's KV
    codes carried on at rounding near-ties (``carry_kv``), and the routing
    compared (`RouteTap.compare`), then the uniform decode step's drop
    case: 8
    experts (capacity 1 over the step's 2 rows), two equal prompts of
    10, prefill and one decode step, raw caches, on the card and the
    CPU: the decode step's dispatches drop the second row's slots in
    both, its logits within DECODE_ATOL."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Transformer

    # the KV carry: at these SMOKE widths (4 heads of 64) one 8-bit KV
    # code flip, which the dense checks allow in 0.5% of the codes, moves
    # the next hop's input by ~3.8e-4 (on the CPU, weights moved by
    # 1e-6), past the hop comparison's HOP_NOISE
    with RouteTap() as tap:
        reference_check(torch, arch, p, n, tag=tag, carry_kv=True,
                        capacity_factor=1.25)
    cfg = get_config(arch, smoke=True)
    routing = tap.compare(torch, cfg.top_k)
    cfg = cfg.with_(capacity_factor=1.25, n_experts=8)
    prompt = torch.randint(0, cfg.vocab_size, (1, 10),
                           generator=torch.Generator().manual_seed(3))
    prompt = prompt.repeat(2, 1)
    logits = {}
    with RouteTap() as drop:
        for dev in ("cuda", "cpu"):
            model = Transformer(cfg, device=dev,
                                generator=torch.Generator().manual_seed(0))
            c = model.init_caches(2, 11, torch.float32)
            _, c = model.forward_with_caches(prompt.to(dev), c)
            lg, _ = model.forward_with_caches(prompt[:, -1:].to(dev), c)
            logits[dev] = lg.cpu()
    decode = [r for r in drop.log if r["top_i"].shape[1] == 2]
    dec = (logits["cpu"] - logits["cuda"]).abs().max().item()
    rows_apart = (logits["cpu"][0] - logits["cpu"][1]).abs().max().item()
    phase(tag + "-routing", arch=arch, capacity_factor=1.25,
          **routing, route_margin=ROUTE_MARGIN,
          drop_case_experts=cfg.n_experts,
          drop_case_decode_max_abs=dec,
          drop_case_rows_max_abs_apart=rows_apart,
          drop_case_keep=json.dumps([r["keep"].tolist() for r in decode]),
          tolerance=f"decode {DECODE_ATOL}")
    assert len(decode) == 2 * cfg.n_trunk, len(decode)
    drop.compare(torch, cfg.top_k)
    # the first MoE layer's dispatch (the card's, then the CPU's): both
    # rows pick the same k experts, each keeps one slot, the first row's
    for r in (decode[0], decode[cfg.n_trunk]):
        assert int(r["keep"].sum()) == cfg.top_k, r["keep"]
    assert dec <= DECODE_ATOL, dec
    assert rows_apart > DECODE_ATOL, rows_apart


def serve_moe_continuous_phase(torch, qp, serve):
    """[serve-moe-continuous]: the launcher's --continuous run on
    deepseek-moe-16b at full width, DS_LAYERS deep (`MOE_CONT_ARGS`), its
    counters set to 0 just before and checked exactly just after: B10
    on every layer of each admission's prefill, the KV pair on the coded
    trunk layers only (the dense prefix's pk/pv raw, in the batcher's
    bf16), the hop a tick; the hop's and the KV stores' bytes against
    their models.  Returns its launches."""
    from repro_torch.serving import DeltaHopCodec, KVCodec, delta

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qp.reset_launches()
    delta.reset_sent()
    out = serve.main(MOE_CONT_ARGS)
    torch.cuda.synchronize()
    launches = dict(qp.LAUNCHES)
    sent = dict(delta.SENT)
    peak = torch.cuda.max_memory_allocated()
    reqs, ticks, adm = out["requests"], out["ticks"], out["admissions"]
    cfg = out["model"].cfg
    layers, coded = cfg.num_layers, cfg.n_trunk
    hop_model = DeltaHopCodec(mode="aqsgd", bits=4).hop_bytes(
        CONT_SLOTS, cfg.d_model) * ticks
    # the trunk's 8-bit stores, and the prefix's raw pk/pv in the
    # batcher's bf16
    row = (CONT_SLOTS, CACHE_LEN, cfg.num_kv_heads, cfg.head_dim)
    kv_model = KVCodec(bits=8).stored_bytes(row) * 2 * coded \
        + math.prod(row) * torch.bfloat16.itemsize * 2 \
        * cfg.first_dense_layers
    phase("serve-moe-continuous", arch=cfg.name,
          layers=f"{layers}/28 ({cfg.first_dense_layers} dense + {coded} "
                 f"moe)", d_model=cfg.d_model, slots=CONT_SLOTS,
          requests=len(reqs), prompt_lens=json.dumps([len(r.prompt)
                                                      for r in reqs]),
          cache=out["cache_len"], admissions=adm, ticks=ticks,
          tokens=out["tokens"], decode_tokens=out["decode_tokens"],
          build_s=f"{out['build_s']:.3f}", wall_s=f"{out['wall_s']:.4f}",
          tok_s=f"{out['tok_s']:.2f}", prefill_s=f"{out['prefill_s']:.4f}",
          decode_s=f"{out['decode_s']:.4f}",
          decode_tok_s=f"{out['decode_tok_s']:.2f}",
          ms_per_tick=f"{out['decode_s'] / ticks * 1e3:.3f}",
          peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
          hops=sent["hops"], hop_bytes=sent["bytes"],
          hop_bytes_model=hop_model, kv_store_bytes=out["kv_store_bytes"],
          kv_store_bytes_model=kv_model)
    assert (layers, coded, cfg.d_model) == (DS_LAYERS, DS_LAYERS - 1,
                                            DS_D), (layers, cfg.d_model)
    assert len(reqs) == CONT_REQUESTS and adm == CONT_REQUESTS, (len(reqs),
                                                                 adm)
    for r in reqs:
        assert r.state == "DONE" and not r.error, (r.state, r.error)
        assert len(r.tokens) == GEN, len(r.tokens)
        assert all(0 <= t < DS_VOCAB for t in r.tokens), r.tokens
    assert out["tokens"] == CONT_REQUESTS * GEN
    assert out["cache_len"] == CACHE_LEN
    want = {name: 0 for name in launches}
    want.update(flash_attention_fwd=layers * adm,
                quantize_pack=coded * (adm + ticks),
                unpack_dequant=coded * (adm + ticks),
                delta_quantize_pack=ticks, dequant_unpack_accumulate=ticks)
    assert launches == want, (launches, want)
    assert sent == {"hops": ticks, "bytes": hop_model}, sent
    assert out["kv_store_bytes"] == kv_model, out["kv_store_bytes"]
    del out
    torch.cuda.empty_cache()
    return launches


def raw_continuous_check(torch, qp, arch, tag, **cfg_kw):
    """The continuous batcher on ``arch``'s SMOKE model (config fields
    ``cfg_kw`` replaced) with raw f32 caches and one stage on the card
    (kernels) against the same weights on the CPU: 5 requests of 3-12
    tokens over 3 slots, 6 tokens each, token for token.  Only B10 may
    launch (the admissions' prefills), and it must wherever the model
    attends (never in the ssm family).  Returns the card's launches."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Transformer
    from repro_torch.serving import ContinuousBatcher

    cfg = get_config(arch, smoke=True).with_(**cfg_kw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 12, 7, 5, 9)]
    streams = {}
    for dev in ("cuda", "cpu"):
        model = Transformer(cfg, device=dev,
                            generator=torch.Generator().manual_seed(0))
        bat = ContinuousBatcher(model, num_slots=3, cache_len=24,
                                dtype=torch.float32)
        for pr in prompts:
            bat.submit(pr, max_new_tokens=6)
        qp.reset_launches()
        streams[dev] = [r.tokens for r in bat.run()]
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(qp.LAUNCHES)
            ticks = bat._tick
    phase(tag, arch=cfg.name, head_dim=cfg.head_dim,
          requests=len(prompts), slots=3, ticks=ticks, kv="raw f32",
          streams_card=json.dumps(streams["cuda"]),
          streams_equal=streams["cuda"] == streams["cpu"],
          launches=json.dumps(launches))
    assert streams["cuda"] == streams["cpu"], streams
    assert all(len(t) == 6 for t in streams["cuda"])
    # raw caches and one stage: the prefills' attention alone
    assert (launches["flash_attention_fwd"] > 0) == (cfg.family != "ssm"), \
        launches
    assert all(v == 0 for k, v in launches.items()
               if k != "flash_attention_fwd"), launches
    return launches


def moe_continuous_check(torch, qp):
    """[serve-moe-continuous-reference-check]: `raw_continuous_check` on
    deepseek-moe-16b SMOKE (the pooled step dispatches a row at a time,
    as JAX's), then the 8-bit KV cache and the hop of
    `continuous_reference_check`, with the KV carry."""
    raw_continuous_check(torch, qp, "deepseek-moe-16b",
                         "serve-moe-continuous-reference-check")
    continuous_reference_check(
        torch, "deepseek-moe-16b",
        tag="serve-moe-continuous-kv8-reference-check", carry_kv=True)


def family_continuous_phase(torch, qp, serve, tag, arch, args):
    """[serve-ssm-continuous], [serve-hybrid-continuous] and
    [serve-media-continuous]: the launcher's --continuous run of
    ``args`` (`FAMILY_CONT`), its counters set to 0 just before and
    checked exactly just after: the hop's B1 and B2 once a tick a
    boundary; B3 and B4 (k and v in one launch each) on every coded
    layer of every admission and tick (whisper and pixtral; never on
    mamba2 or zamba2); B10 in each admission's prefill, once a shared
    block call (zamba2), twice a decoder layer (whisper: its
    self-attention and its cross attention over the zero cross caches,
    no encoder: no frames), once a layer (pixtral), never (mamba2).  The
    hop bytes as sent, the pool's state bytes (f32 ssm states, bf16 conv
    windows), KV bytes and bf16 cross caches against their byte models.
    Returns its launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving import DeltaHopCodec, KVCodec, delta

    full = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qp.reset_launches()
    delta.reset_sent()
    out = serve.main(args)
    torch.cuda.synchronize()
    launches = dict(qp.LAUNCHES)
    sent = dict(delta.SENT)
    peak = torch.cuda.max_memory_allocated()
    reqs, ticks, adm = out["requests"], out["ticks"], out["admissions"]
    cfg = out["model"].cfg
    fam, layers, slots, cache = cfg.family, cfg.num_layers, CONT_SLOTS, \
        out["cache_len"]
    hk, hd = cfg.num_kv_heads, cfg.head_dim
    bounds = int(args[args.index("--stages") + 1]) - 1
    hop_model = DeltaHopCodec(mode="aqsgd", bits=4).hop_bytes(
        slots, cfg.d_model) * ticks * bounds
    ssm_model, conv_model = ssm_state_bytes(cfg, slots, 2) \
        if fam in ("ssm", "hybrid") else (0, 0)
    coded = layers if fam in ("audio", "vlm") else 0
    kv_model = KVCodec(bits=8).stored_bytes((slots, cache, hk, hd)) * 2 \
        * coded if coded else 0
    if fam == "hybrid":
        kv_model = 2 * cfg.n_blocks * slots * cache * hk * hd \
            * torch.bfloat16.itemsize
    cross_model = 2 * layers * slots * cfg.encoder_seq * hk * hd \
        * torch.bfloat16.itemsize if fam == "audio" else 0
    b10 = adm * (cfg.n_blocks if fam == "hybrid" else
                 {"ssm": 0, "audio": 2 * layers, "vlm": layers}[fam])
    want = {name: 0 for name in launches}
    want.update(flash_attention_fwd=b10, quantize_pack=coded * (adm + ticks),
                unpack_dequant=coded * (adm + ticks),
                delta_quantize_pack=ticks * bounds,
                dequant_unpack_accumulate=ticks * bounds)
    phase(tag, arch=arch, family=fam,
          layers=f"{layers}/{full.num_layers}", d_model=cfg.d_model,
          params=cfg.params_count(), stages=bounds + 1, slots=slots,
          requests=len(reqs), prompt_lens=json.dumps([len(r.prompt)
                                                      for r in reqs]),
          cache=cache, admissions=adm, ticks=ticks, tokens=out["tokens"],
          decode_tokens=out["decode_tokens"],
          build_s=f"{out['build_s']:.3f}", wall_s=f"{out['wall_s']:.4f}",
          tok_s=f"{out['tok_s']:.2f}", prefill_s=f"{out['prefill_s']:.4f}",
          decode_s=f"{out['decode_s']:.4f}",
          decode_tok_s=f"{out['decode_tok_s']:.2f}",
          ms_per_tick=f"{out['decode_s'] / ticks * 1e3:.3f}",
          peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
          hops=sent["hops"], hop_bytes=sent["bytes"],
          hop_bytes_model=hop_model, state_bytes=out["state_bytes"],
          state_bytes_model=f"{ssm_model}+{conv_model}",
          kv_store_bytes=out["kv_store_bytes"], kv_store_bytes_model=kv_model,
          cross_cache_bytes=out["cross_bytes"],
          cross_cache_bytes_model=cross_model)
    assert cfg.d_model == full.d_model, (cfg.d_model, full.d_model)
    assert len(reqs) == CONT_REQUESTS and adm == CONT_REQUESTS, (len(reqs),
                                                                 adm)
    for r in reqs:
        assert r.state == "DONE" and not r.error, (r.state, r.error)
        assert len(r.tokens) == GEN, len(r.tokens)
        assert all(0 <= t < cfg.vocab_size for t in r.tokens), r.tokens
    assert out["tokens"] == CONT_REQUESTS * GEN
    assert cache == CACHE_LEN + cfg.num_patches, cache
    assert launches == want, (launches, want)
    assert sent == {"hops": ticks * bounds, "bytes": hop_model}, sent
    assert out["state_bytes"] == ssm_model + conv_model, out["state_bytes"]
    assert out["kv_store_bytes"] == kv_model, out["kv_store_bytes"]
    assert out["cross_bytes"] == cross_model, out["cross_bytes"]
    for name, n in want.items():
        if n:
            assert launches[name] > 0, \
                f"{name} was never launched on the {tag} path ({arch})"
    del out
    torch.cuda.empty_cache()
    return launches


def family_continuous_checks(torch, qp, arch, **cfg_kw):
    """The SMOKE card-vs-CPU checks of the batcher on ``arch``
    (`FAMILY_CONT_CHECKS`): raw f32 streams token for token
    (`raw_continuous_check`), then the bf16 pool with the 4-bit hop over
    2 stages in lockstep (`continuous_reference_check`), whisper's and
    pixtral's with 8-bit KV and the card's codes carried at rounding
    near-ties (`KVTap`)."""
    from repro_torch.configs.base import get_config

    short = arch.split("-")[0]
    raw_continuous_check(
        torch, qp, arch, f"serve-{short}-continuous-reference-check",
        **cfg_kw)
    media = get_config(arch, smoke=True).family in ("audio", "vlm")
    continuous_reference_check(
        torch, arch, tag=f"serve-{short}-continuous-"
                         f"{'kv8' if media else 'hop'}-reference-check",
        carry_kv=media, **cfg_kw)


def serve_cell_phase(torch, qp, serve, tag):
    """A full-size serving cell of `SERVE_CELLS` through the launcher
    (gemma2-9b, the slice's own; stablelm-12b; gemma2-27b at full width
    and `G27_LAYERS` deep; deepseek-moe-16b and mixtral-8x22b at full
    width, `DS_LAYERS` and `MX_LAYERS` deep), the counters set to 0 just
    before and checked exactly just after, the hop's bytes as the encoder
    emits them and the KV stores' bytes against the byte models (a MoE
    model's dense prefix raw); returns its launches and the model
    build's seconds."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving import DeltaHopCodec, KVCodec, delta

    args, batch, prompt, cache, gen, layers, d, vocab, kv_heads, hd = \
        SERVE_CELLS[tag]
    cfg = get_config(args[args.index("--arch") + 1]).with_(num_layers=layers)
    prefix = cfg.first_dense_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qp.reset_launches()
    delta.reset_sent()
    out = serve.main(args)
    torch.cuda.synchronize()
    launches = dict(qp.LAUNCHES)
    sent = dict(delta.SENT)
    peak = torch.cuda.max_memory_allocated()
    logits, tokens = out["logits"], out["tokens"]
    # the bytes on the wire: the decode hops the run sent, and the KV
    # stores it filled, against the byte models
    hop, kv = DeltaHopCodec(mode="aqsgd", bits=4), KVCodec(bits=8)
    hop_model = hop.hop_bytes(batch, d) * gen
    raw_row = kv_heads * hd * 4
    kv_model = kv.stored_bytes((batch, cache, kv_heads, hd)) * 2 \
        * cfg.n_trunk + 2 * prefix * batch * cache * raw_row
    want = cell_launches(gen, layers, cfg.n_trunk)
    # the hop shape kernel_phase checks B2 at
    assert not cfg.has_moe or (batch, d) in MOE_HOPS, (batch, d)
    moe = {} if not cfg.has_moe else dict(
        params=cfg.params_count(), active_params=cfg.active_params_count(),
        experts=f"{cfg.n_experts} top-{cfg.top_k} "
                f"+{cfg.n_shared_experts} shared",
        dense_prefix=prefix, hop_bytes_per_token=hop.hop_bytes(1, d),
        kv_bytes_per_token=kv.stored_bytes((1, 1, kv_heads, hd)) * 2
        * cfg.n_trunk + 2 * prefix * raw_row,
        kv_bytes_per_token_f32=2 * layers * raw_row)
    phase(tag, layers=layers, d_model=d, vocab=vocab, kv_heads=kv_heads,
          head_dim=hd, **moe, batch=batch, prompt=prompt,
          cache=out["cache_len"],
          build_s=f"{out['build_s']:.3f}",
          prefill_s=f"{out['prefill_s']:.4f}",
          decode_s=f"{out['decode_s']:.4f}",
          decode_tok_s=f"{out['decode_tok_s']:.2f}",
          peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
          hops=sent["hops"], hop_bytes=sent["bytes"],
          hop_bytes_model=hop_model,
          kv_store_bytes=out["kv_store_bytes"], kv_store_bytes_model=kv_model,
          decode_steps=gen)
    assert tokens.shape == (batch, gen), tokens.shape
    assert logits.shape == (batch, 1, vocab), logits.shape
    assert torch.isfinite(logits).all().item(), "non-finite logits"
    assert out["cache_len"] == cache == prompt + gen
    assert sent == {"hops": gen, "bytes": hop_model}, sent
    assert out["kv_store_bytes"] == kv_model, out["kv_store_bytes"]
    assert launches == want, (launches, want)
    for name, n in want.items():
        if n:
            assert launches[name] > 0, \
                f"{name} was never launched on the {tag} path"
    build_s = out["build_s"]
    del out, logits, tokens
    torch.cuda.empty_cache()
    return launches, build_s


def ssm_serve_phase(torch, qp, serve, tag):
    """A full-size ssm or hybrid serving cell of `SSM_CELLS` through the
    launcher, the counters set to 0 just before and checked exactly just
    after: the hop's B1 and B2 once a decode step a boundary, B3 and B4
    never (no KV codec: the ssm family keeps no KV, the hybrid raw k and
    v), B10 once a block in the prefill (hybrid, at head_dim 80) or
    never (ssm); the hop bytes as sent, the state bytes and the raw KV
    bytes against their byte models.  Returns its launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving import DeltaHopCodec, delta

    arch, args, batch, prompt, gen, stages, layers = SSM_CELLS[tag]
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_(num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qp.reset_launches()
    delta.reset_sent()
    out = serve.main(args)
    torch.cuda.synchronize()
    launches = dict(qp.LAUNCHES)
    sent = dict(delta.SENT)
    peak = torch.cuda.max_memory_allocated()
    logits, tokens = out["logits"], out["tokens"]
    bounds = stages - 1
    hop_model = DeltaHopCodec(mode="aqsgd", bits=4).hop_bytes(
        batch, cfg.d_model) * gen * bounds
    ssm_model, conv_model = ssm_state_bytes(cfg, batch)
    hybrid = cfg.family == "hybrid"
    kv_model = 2 * cfg.n_blocks * batch * out["cache_len"] \
        * cfg.num_kv_heads * cfg.head_dim * 4 if hybrid else 0
    want = dict(cell_launches(gen, 0), delta_quantize_pack=gen * bounds,
                dequant_unpack_accumulate=gen * bounds,
                flash_attention_fwd=cfg.n_blocks if hybrid else 0)
    phase(tag, layers=cfg.num_layers, d_model=cfg.d_model,
          d_inner=cfg.d_inner, ssm_heads=cfg.ssm_heads,
          ssm_state=cfg.ssm_state, vocab=cfg.vocab_size,
          params=cfg.params_count(), stages=stages,
          attn_heads=cfg.num_heads, head_dim=cfg.head_dim,
          batch=batch, prompt=prompt, cache=out["cache_len"],
          build_s=f"{out['build_s']:.3f}",
          prefill_s=f"{out['prefill_s']:.4f}",
          decode_s=f"{out['decode_s']:.4f}",
          decode_tok_s=f"{out['decode_tok_s']:.2f}",
          peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
          hops=sent["hops"], hop_bytes=sent["bytes"],
          hop_bytes_model=hop_model,
          hop_bytes_per_token_boundary=hop_model // (gen * bounds),
          hop_bytes_f32=batch * cfg.d_model * 4,
          state_bytes=out["state_bytes"],
          state_bytes_model=f"{ssm_model}+{conv_model}",
          kv_store_bytes=out["kv_store_bytes"], kv_store_bytes_model=kv_model,
          decode_steps=gen)
    assert tokens.shape == (batch, gen), tokens.shape
    assert logits.shape == (batch, 1, cfg.vocab_size), logits.shape
    assert torch.isfinite(logits).all().item(), "non-finite logits"
    assert sent == {"hops": gen * bounds, "bytes": hop_model}, sent
    assert out["state_bytes"] == ssm_model + conv_model, out["state_bytes"]
    assert out["kv_store_bytes"] == kv_model, out["kv_store_bytes"]
    assert launches == want, (launches, want)
    for name, n in want.items():
        if n:
            assert launches[name] > 0, \
                f"{name} was never launched on the {tag} path"
    # the hop shape kernel_phase checks B1 and B2 at
    assert (batch, cfg.d_model) in SSM_HOPS, (batch, cfg.d_model)
    del out, logits, tokens
    torch.cuda.empty_cache()
    return launches


def media_serve_phase(torch, qp, serve, tag):
    """A full-size audio or vlm serving cell of `MEDIA_CELLS` through the
    launcher (whisper-small; pixtral-12b at full width, `P_LAYERS`
    deep), the counters set to 0 just before and checked exactly just
    after: the hop's B1 and B2 once a decode step, B3 and B4 on every
    step of every decoder layer (k and v in one launch each), B10 in the
    prefill once a layer (pixtral) or three times (whisper: its encoder
    layer, its decoder layer's self-attention and cross attention); the
    hop bytes as sent, the 8-bit KV stores and whisper's raw f32 cross
    caches against their byte models.  Returns its launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving import DeltaHopCodec, KVCodec, delta

    arch, args, batch, prompt, cache, gen, layers = MEDIA_CELLS[tag]
    cfg = get_config(arch).with_(num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qp.reset_launches()
    delta.reset_sent()
    out = serve.main(args)
    torch.cuda.synchronize()
    launches = dict(qp.LAUNCHES)
    sent = dict(delta.SENT)
    peak = torch.cuda.max_memory_allocated()
    logits, tokens = out["logits"], out["tokens"]
    hk, hd, d = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    hop, kv = DeltaHopCodec(mode="aqsgd", bits=4), KVCodec(bits=8)
    hop_model = hop.hop_bytes(batch, d) * gen
    kv_model = kv.stored_bytes((batch, cache, hk, hd)) * 2 * layers
    cross_model = 2 * layers * batch * cfg.encoder_seq * hk * hd * 4
    b10 = cfg.encoder_layers + 2 * layers if cfg.cross_attention \
        else layers
    want = dict(cell_launches(gen, layers), flash_attention_fwd=b10)
    phase(tag, arch=arch, family=cfg.family,
          layers=f"{layers}/{get_config(arch).num_layers}",
          encoder_layers=cfg.encoder_layers or None,
          frames=cfg.encoder_seq or None, patches=cfg.num_patches or None,
          d_model=d, heads=cfg.num_heads, kv_heads=hk, head_dim=hd,
          vocab=cfg.vocab_size, params=cfg.params_count(), batch=batch,
          prompt=prompt, cache=out["cache_len"],
          build_s=f"{out['build_s']:.3f}",
          prefill_s=f"{out['prefill_s']:.4f}",
          decode_s=f"{out['decode_s']:.4f}",
          decode_tok_s=f"{out['decode_tok_s']:.2f}",
          peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
          hops=sent["hops"], hop_bytes=sent["bytes"],
          hop_bytes_model=hop_model,
          hop_bytes_per_token=hop.hop_bytes(1, d),
          kv_store_bytes=out["kv_store_bytes"], kv_store_bytes_model=kv_model,
          kv_bytes_per_token=kv.stored_bytes((1, 1, hk, hd)) * 2 * layers,
          kv_bytes_per_token_f32=2 * layers * hk * hd * 4,
          cross_cache_bytes=out["cross_bytes"],
          cross_cache_bytes_model=cross_model, decode_steps=gen)
    assert tokens.shape == (batch, gen), tokens.shape
    assert logits.shape == (batch, 1, cfg.vocab_size), logits.shape
    assert torch.isfinite(logits).all().item(), "non-finite logits"
    assert out["cache_len"] == cache == prompt + gen + cfg.num_patches
    assert sent == {"hops": gen, "bytes": hop_model}, sent
    assert out["kv_store_bytes"] == kv_model, out["kv_store_bytes"]
    assert out["cross_bytes"] == cross_model, out["cross_bytes"]
    assert launches == want, (launches, want)
    for name, n in want.items():
        if n:
            assert launches[name] > 0, \
                f"{name} was never launched on the {tag} path"
    assert (batch, d) in MEDIA_HOPS, (batch, d)
    del out, logits, tokens
    torch.cuda.empty_cache()
    return launches


def gemma2_device_draw_s(torch) -> float:
    """Seconds to build gemma2-9b (`G_LAYERS` deep, as `[serve-gemma2]`
    serves it) as the serving launcher did before its weights came from
    a CPU generator: every leaf drawn on the card from a CUDA generator
    (other numbers than the CPU's from one seed)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Transformer

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Transformer(
        get_config("gemma2-9b").with_(num_layers=G_LAYERS), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    return seconds


# ---------------------------------------------------------------------------
# phases 6 and 7: AQ-SGD training with compressed DP gradients
# ---------------------------------------------------------------------------

def _train_config(sim, comm_mod, adamw, *, stochastic, stages, steps,
                  remat=False, wire="ring", workers=TRAIN_WORKERS):
    """aqsgd fw 4 / bw 8 and the 4-bit DP ``wire`` over ``workers``
    simulated workers, or with ``workers`` 0 one worker and no DP
    plane."""
    plane = comm_mod.PlaneConfig
    kw = dict(stochastic=stochastic)
    comm = comm_mod.CommConfig(mode="aqsgd", fw=plane(bits=4, **kw),
                               bw=plane(bits=8, **kw),
                               dp=plane(bits=4 if workers else 0, wire=wire,
                                        **kw))
    # the train launcher's optimizer defaults: lr 1e-3, warm-up
    # max(steps // 20, 1), decay to 0 at the last step
    return sim.SimTrainConfig(
        num_stages=stages, comm=comm, dp_workers=max(workers, 1),
        remat=remat,
        optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=max(steps // 20,
                                                              1),
                                    total_steps=steps))


def train_launches_per_step(cfg, stages, remat,
                            workers=TRAIN_WORKERS) -> dict:
    """`TRAIN_LAUNCHES_PER_STEP` for ``cfg`` in ``stages`` groups over
    ``workers`` (0: one worker, no DP plane): each boundary once a
    worker forward (B1) and backward (B3, B4); the DP wire as there, or
    none; B10 once a worker per attention call (a dense or MoE layer, a
    MoE model's dense prefix, a hybrid's shared block, an audio model's
    encoder layer and its decoder layer's cross attention), twice with
    remat (the prefix, outside the checkpoints, once)."""
    calls = cfg.n_blocks if cfg.family == "hybrid" else \
        0 if cfg.family == "ssm" else cfg.num_layers
    recompute = cfg.n_blocks if cfg.family == "hybrid" else \
        0 if cfg.family == "ssm" else cfg.n_trunk
    if cfg.cross_attention:
        calls += cfg.num_layers + cfg.encoder_layers
        recompute += cfg.num_layers + cfg.encoder_layers
    n = max(workers, 1)
    per = (stages - 1) * n
    dp = {} if workers else {k: 0 for k in DP_KERNELS}
    return dict(TRAIN_LAUNCHES_PER_STEP, delta_quantize_pack=per,
                quantize_pack=per, unpack_dequant=per, **dp,
                flash_attention_fwd=(calls + (recompute if remat else 0))
                * n)


def train_phase(torch, qp, tag="train", layers=TRAIN_LAYERS, remat=False,
                wire="ring", arch="gpt2-xl-paper", stages=TRAIN_STAGES,
                workers=TRAIN_WORKERS, seq=TRAIN_SEQ):
    """The training main path of ``arch`` at full width, ``layers`` deep
    in ``stages`` groups, on the DP wire ``wire`` over ``workers`` (0:
    one worker, no DP plane), batches of ``seq`` tokens (an audio
    model's with `sim.train`'s stub frames); returns its
    launches, losses, median step time (steps 3-6) and peak memory.  The
    last step's ce and aux are printed beside the losses (a MoE model's
    loss is ce + 0.01 aux)."""
    from repro_torch.comm import config as comm_mod
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import Dataset, DatasetConfig
    from repro_torch.optim import adamw
    from repro_torch.training import simulated as sim

    full = get_config(arch)
    cfg = full.with_(num_layers=layers)
    tcfg = _train_config(sim, comm_mod, adamw, stochastic=True,
                         stages=stages, steps=TRAIN_STEPS,
                         remat=remat, wire=wire, workers=workers)
    ds = Dataset(DatasetConfig(num_samples=TRAIN_SAMPLES, seq_len=seq,
                               vocab_size=cfg.vocab_size, seed=0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qp.reset_launches()
    state, losses = sim.train(cfg, tcfg, ds, num_steps=TRAIN_STEPS,
                              batch_size=TRAIN_BATCH, seed=0, device="cuda")
    metrics = state["last_metrics"]
    torch.cuda.synchronize()
    launches = dict(qp.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(state["step_seconds"][2:])
    n_params = sum(p.numel() for p in state["model"].parameters())
    want = train_launches_per_step(cfg, stages, remat, workers)
    phase(tag, arch=arch, layers=f"{layers}/{full.num_layers}",
          stages=stages, remat=remat, dp_wire=wire if workers else None,
          dp_workers=workers, d_model=cfg.d_model, params=n_params,
          dp_bucket_rows=state["dp_error"].shape[1] if workers else None,
          losses=json.dumps([round(x, 6) for x in losses]),
          final_ce=f"{float(metrics['ce']):.6f}",
          final_aux=f"{float(metrics['aux']):.6f}",
          step_s=json.dumps([round(x, 4) for x in state["step_seconds"]]),
          median_step_s_3_6=f"{step_s:.4f}",
          seq=seq, frames=cfg.encoder_seq or None,
          tokens_per_s=f"{TRAIN_BATCH * seq / step_s:.1f}",
          peak_mem_gib=f"{peak / 2**30:.3f}",
          b10_launches_per_step=launches["flash_attention_fwd"]
          // TRAIN_STEPS, launches=json.dumps(launches))
    assert len(losses) == TRAIN_STEPS
    assert all(math.isfinite(x) for x in losses), losses
    rows = -(-n_params // DP_BUCKET[1])
    assert not workers or state["dp_error"].shape == (TRAIN_WORKERS, rows,
                                                      DP_BUCKET[1])
    assert arch != "gpt2-xl-paper" or layers != TRAIN_LAYERS \
        or rows == DP_BUCKET[0], rows
    # the shapes kernel_phase checks the new paths' kernels at
    assert arch != "zamba2-2.7b" or layers != TZ_LAYERS \
        or (rows, cfg.d_model) == (TZ_BUCKET[0], TZ_ROWS[1]), rows
    assert arch != "deepseek-moe-16b" or workers \
        or (TRAIN_BATCH * TRAIN_SEQ, cfg.d_model) == TM_ROWS
    assert arch != "whisper-small" or (
        rows, TRAIN_BATCH // TRAIN_WORKERS * seq, cfg.d_model) \
        == (TW_BUCKET[0], *TW_ROWS), rows
    assert not workers or torch.isfinite(state["dp_error"]).all().item(), \
        "carry not finite"
    assert math.isfinite(float(metrics["aux"])), metrics
    assert (float(metrics["aux"]) > 0) == (cfg.has_moe and not workers), \
        metrics
    assert state["buffers"]["seen"].all().item(), "a sample never seen"
    for name, per_step in want.items():
        assert launches[name] == per_step * TRAIN_STEPS, \
            (name, launches[name], per_step * TRAIN_STEPS)
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "peak_gib": peak / 2 ** 30}


def train_oncore_phase(torch, qp, env, base):
    """[train-oncore]: the [train] run with the on-core noise knob set,
    so every stochastic encode draws its noise in the kernel; against
    ``base``, the [train] run of this call.  Returns its launches."""
    os.environ[env.ONCORE_PRNG] = "1"
    try:
        run = train_phase(torch, qp, tag="train-oncore")
    finally:
        del os.environ[env.ONCORE_PRNG]
    launches = run["launches"]
    encodes = sum(launches[n] for n in ONCORE_ENCODERS)
    rel = abs(run["losses"][-1] - base["losses"][-1]) \
        / abs(base["losses"][-1])
    phase("train-oncore-vs-train", oncore_uniform=launches["oncore_uniform"],
          encodes=encodes, noise_input_encodes=encodes
          - launches["oncore_uniform"],
          final_loss=f"{run['losses'][-1]:.6f}",
          final_loss_train=f"{base['losses'][-1]:.6f}",
          final_loss_rel_diff=rel,
          tolerance=ONCORE_FINAL_LOSS_RTOL,
          median_step_s=f"{run['step_s']:.4f}",
          median_step_s_train=f"{base['step_s']:.4f}",
          peak_mem_gib=f"{run['peak_gib']:.3f}",
          peak_mem_gib_train=f"{base['peak_gib']:.3f}")
    assert launches["oncore_uniform"] == encodes == sum(
        TRAIN_LAUNCHES_PER_STEP[n] for n in ONCORE_ENCODERS) * TRAIN_STEPS, \
        launches
    assert base["launches"]["oncore_uniform"] == 0, base["launches"]
    assert rel <= ONCORE_FINAL_LOSS_RTOL, rel
    return launches


def train_sharded_phase(torch, qp, base):
    """[train-sharded]: the [train] run on the ZeRO wire; its losses bit
    for bit and its launches against ``base``, the [train] run of this
    call."""
    run = train_phase(torch, qp, tag="train-sharded", wire="ring-sharded")
    phase("train-sharded-vs-train", losses_bit_equal=run["losses"]
          == base["losses"], launches_equal=run["launches"]
          == base["launches"], median_step_s=f"{run['step_s']:.4f}",
          median_step_s_train=f"{base['step_s']:.4f}",
          peak_mem_gib=f"{run['peak_gib']:.3f}",
          peak_mem_gib_train=f"{base['peak_gib']:.3f}")
    assert run["losses"] == base["losses"], (run["losses"], base["losses"])
    assert run["launches"] == base["launches"], run["launches"]
    return run["launches"]


def train_reference_check(torch, arch="gpt2-xl-paper",
                          tag="train-reference-check", wire="ring",
                          **cfg_kw):
    """The SMOKE trainer of ``arch`` (its config fields ``cfg_kw``
    replaced) on the card (kernels) against the CPU (plain versions),
    deterministic rounding on every plane, same weights, on the DP wire
    ``wire``; an audio or vlm model's batches carry stub frames or
    patches (`data.pipeline.with_stub_media`, seed 3)."""
    from repro_torch.comm import config as comm_mod
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import (Dataset, DatasetConfig,
                                           with_stub_media)
    from repro_torch.optim import adamw
    from repro_torch.training import simulated as sim

    cfg = get_config(arch, smoke=True).with_(**cfg_kw)
    steps, samples, seq, batch = 4, 8, 32, 4
    tcfg = _train_config(sim, comm_mod, adamw, stochastic=False, stages=2,
                         steps=steps, remat=True, wire=wire)
    batches = [with_stub_media(cfg, b, seed=3, step=i)
               for i, b in enumerate(Dataset(DatasetConfig(
                   num_samples=samples, seq_len=seq,
                   vocab_size=cfg.vocab_size)).batches(batch, steps))]
    cpu, gpu = (sim.init_train_state(
        cfg, tcfg, samples, seq + cfg.num_patches, device=dev,
        generator=torch.Generator().manual_seed(0)) for dev in ("cpu", "cuda"))

    def run(state, dev):
        gen = torch.Generator(device=dev).manual_seed(1)
        losses, carry = [], None
        for b in batches:
            state, met = sim.train_step(state, sim.device_batch(b, dev), gen,
                                        mcfg=cfg, tcfg=tcfg)
            losses.append(float(met["loss"]))
            if carry is None:
                carry = state["dp_error"].cpu().clone()
        return losses, carry

    lc, ec = run(cpu, "cpu")
    lg, eg = run(gpu, "cuda")
    rel = [abs(a - b) / abs(a) for a, b in zip(lc, lg)]
    diff = (ec - eg).abs()
    # a DP code that flips moves the carry by a whole grid step (about
    # twice the row's largest carry); anything else is ulp-level
    flips = int((diff > 0.5 * ec.abs().amax(-1, keepdim=True)).sum())
    phase(tag, trainer="simulated", arch=arch, head_dim=cfg.head_dim,
          remat=tcfg.remat,
          dp_wire=wire, losses_cpu=json.dumps(lc),
          losses_card=json.dumps(lg), max_rel_loss_diff=max(rel),
          carry_max_abs_diff_step1=diff.max().item(),
          carry_flips_step1=f"{flips}/{diff.numel()}"
          + (" (f16 casts, not codes)" if wire == "fp16" else ""),
          tolerance=f"step1 {FIRST_STEP_RTOL} later {LATER_STEP_RTOL} "
                    f"flips <= {MAX_FLIP_FRACTION}")
    assert rel[0] <= FIRST_STEP_RTOL, rel
    assert max(rel[1:]) <= LATER_STEP_RTOL, rel
    # the bound is on DP codes; the fp16 wire has none (its carry is the
    # f16 cast error, a flip of which is one f16 ulp of its element)
    assert wire == "fp16" or flips <= MAX_FLIP_FRACTION * diff.numel(), \
        flips
    assert torch.isfinite(eg).all().item()


# ---------------------------------------------------------------------------
# phases 8 and 9: the distributed trainer
# ---------------------------------------------------------------------------

def _dist_spec(torch, flags, *, layers):
    """The spec ``python -m repro_torch.launch.train --distributed``
    builds from ``flags`` (the launcher's defaults otherwise: lr 1e-3,
    one warm-up epoch), with the depth cut to ``layers``."""
    from repro_torch.launch import train as launch_train
    args = launch_train.build_parser().parse_args(
        ["--arch", "gpt2-xl-paper", "--distributed",
         "--data-par", str(DIST_DATA), "--stages", str(DIST_STAGES),
         "--microbatches", str(DIST_MICRO), "--mode", "aqsgd",
         "--fw-bits", "4", "--bw-bits", "8", "--dp-grad-bits", "4",
         "--dp-wire", "ring", "--seed", "0", *flags])
    spec = launch_train.distributed_spec(args, torch.device(args.device))
    spec["num_layers"] = layers
    return spec


def dist_phases(torch):
    """The distributed main path at full width, [dist-train], and its
    three variants (`DIST_VARIANTS`), run in turn by one spawn of the
    launcher; returns each one's launches, by tag."""
    from repro_torch.comm import wires as W
    from repro_torch.core import collectives as C
    from repro_torch.core import quantization as Q
    from repro_torch.launch import train as launch_train
    from repro_torch.comm.config import CommConfig
    from repro_torch.configs.base import get_config
    from repro_torch.serving import DeltaHopCodec
    from repro_torch.training import pipeline as PL
    from repro_torch.training.pipeline import PipelineConfig

    flags = ["--device", "cuda", "--steps", str(DIST_STEPS), "--batch",
             str(DIST_BATCH), "--seq", str(DIST_SEQ), "--samples",
             str(DIST_SAMPLES)]
    specs = []
    for extra, opt in DIST_VARIANTS.values():
        specs.append(_dist_spec(torch, [*flags, *extra], layers=DIST_LAYERS))
        specs[-1]["optimizer"].update(opt)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = launch_train.run_distributed(specs, timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    d, mb = D_MODEL, DIST_BATCH // DIST_DATA // DIST_MICRO
    hop = DeltaHopCodec(mode="aqsgd", bits=4).hop_bytes(mb * DIST_SEQ, d)
    ring = C.ring_wire_bytes(DIST_BUCKET, 4, DIST_DATA)
    assert C.ring_wire_bytes(DIST_BUCKET, 4, DIST_DATA, sharded=True) \
        == DIST_SHARDED_BYTES
    assert C.param_gather_bytes(DIST_BUCKET, DIST_DATA) == DIST_GATHER_BYTES
    models = {"dist-train": (ring, 0), "dist-train-adam8": (ring, 0),
              "dist-train-sharded": (DIST_SHARDED_BYTES, DIST_GATHER_BYTES),
              "dist-train-fp16": (DIST_FP16_BYTES, 0)}
    manifests = {"dist-train-sharded": W.get_wire(
        "ring-sharded").expected_collectives(DIST_BUCKET, 4, DIST_DATA),
        "dist-train-fp16": [("all-reduce", "f16", DIST_FP16_BYTES, 1)]}
    wants = {"dist-train": DIST_LAUNCHES, "dist-train-adam8": DIST_LAUNCHES,
             "dist-train-sharded": dict(DIST_LAUNCHES, pack_sums=0,
                                        unpack_sums=0),
             "dist-train-fp16": dict(DIST_LAUNCHES, **{
                 k: 0 for k in ("quantize_codes_scaled", "dequant_sum_mean",
                                "unpack_accumulate", "pack_sums",
                                "unpack_sums")})}
    pcfg = PipelineConfig()                 # the spec sets none of these
    cfg = get_config("gpt2-xl-paper").with_(num_layers=DIST_LAYERS)
    lay = PL.stage_layout(cfg, DIST_STAGES)
    # ZeRO-3: the weight gathers a rank of each stage sends a step (the
    # same under every wire), and its resident parameter and moment bytes
    fsdp = [PL.fsdp_gather_bytes(cfg, pcfg, lay, k, DIST_DATA, DIST_MICRO)
            for k in range(DIST_STAGES)]
    base = runs[0][0]["losses"]
    out = {}
    for tag, spec, res in zip(DIST_VARIANTS, specs, runs):
        scfg = PipelineConfig(comm=CommConfig.from_json(spec["comm"]))
        resident = [PL.rank_param_bytes(cfg, scfg, lay, k, DIST_DATA,
                                        spec["optimizer"]["state_bits"])
                    for k in range(DIST_STAGES)]
        losses = res[0]["losses"]
        # a step lasts as long as its slowest rank
        step_s = [max(r["step_seconds"][i] for r in res)
                  for i in range(DIST_STEPS)]
        med = statistics.median(step_s[2:])
        launches = {name: sum(st[name] for r in res for st in r["launches"])
                    for name in DIST_LAUNCHES}
        dp, gather = models[tag]
        want = {"fw_warm": DIST_MICRO * mb * DIST_SEQ * d * 4,
                "fw": DIST_MICRO * hop,
                "bw": DIST_MICRO * Q.wire_bytes((mb, DIST_SEQ, d), 8),
                "dp": dp, "dp-gather": gather}
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
        phase(tag, mesh=f"{DIST_DATA}x{DIST_STAGES}",
              layers=DIST_LAYERS, remat=pcfg.remat,
              remat_mode=pcfg.remat_mode, loss_chunks=pcfg.loss_chunks,
              d_model=d, dp_wire=json.loads(spec["comm"])["dp"]["wire"],
              state_bits=spec["optimizer"]["state_bits"],
              dp_bucket=res[0]["dp_bucket"],
              losses=json.dumps([round(x, 6) for x in losses]),
              losses_exact=json.dumps(losses),
              rel_loss_diff_vs_dist_train=json.dumps(rel),
              step_s=json.dumps([round(x, 4) for x in step_s]),
              median_step_s_3_4=f"{med:.4f}",
              tokens_per_s=f"{DIST_BATCH * DIST_SEQ / med:.1f}",
              peak_mem_gib_by_rank=json.dumps(
                  [round(r["peak_mem_bytes"] / 2**30, 3) for r in res]),
              launches=json.dumps(launches),
              bytes_rank0_by_step=json.dumps(res[0]["bytes"]),
              bytes_rank1_by_step=json.dumps(res[1]["bytes"]),
              bytes_models=json.dumps(want),
              replicas_rank1=json.dumps(res[1]["replicas"]),
              phase_s_by_rank_step4=json.dumps(
                  [{k: round(v, 4) for k, v in
                    r["phase_seconds"][-1].items()} for r in res]),
              fsdp_gather_s_by_rank_step4=json.dumps(
                  [r["phase_seconds"][-1]["fsdp_gather"] for r in res]),
              fsdp_bytes_model_by_stage=json.dumps(fsdp),
              resident_bytes_by_rank=json.dumps(
                  [r["resident_bytes"] for r in res]),
              resident_bytes_model_by_stage=json.dumps(resident),
              wall_s_all_variants=f"{wall:.1f}")
        assert len(losses) == DIST_STEPS
        assert all(math.isfinite(x) for x in losses), losses
        assert all(r["losses"] == losses for r in res), "ranks disagree"
        assert res[0]["warm_steps"] == 2
        assert tuple(res[0]["dp_bucket"]) == DIST_BUCKET
        for r in res:
            for i, b in enumerate(r["bytes"]):
                warm = i < 2
                if r["model_rank"] == 0:
                    assert b["fw"] == (want["fw_warm"] if warm
                                       else want["fw"]), b
                else:
                    assert b["bw"] == (want["fw_warm"] if warm
                                       else want["bw"]), b
                assert b["dp"] == want["dp"], b
                assert b["dp-gather"] == want["dp-gather"], b
                assert b["fsdp"] == fsdp[r["model_rank"]], b
            assert r["resident_bytes"] == resident[r["model_rank"]], \
                (tag, r["resident_bytes"], resident)
            if tag in manifests:
                assert all(m == manifests[tag] for m in r["manifests"]), \
                    r["manifests"]
            for rep in r["replicas"]:
                if r["model_rank"] == DIST_STAGES - 1:
                    assert rep["m_in_equal"] is True, rep
                    assert rep["embed_equal"] is True, rep
        assert launches == wants[tag], (tag, launches, wants[tag])
        if tag == "dist-train-sharded":
            assert losses == base, (losses, base)
        if tag == "dist-train-adam8":
            assert max(rel) <= ADAM8_LOSS_RTOL, rel
        out[tag] = launches
    return out


# the distributed SMOKE checks, card against CPU, run in one spawn a
# device: (tag, arch, name of a `DIST_VARIANTS` entry, `PipelineConfig`
# fields the spec sets)
DIST_CHECKS = [
    ("dist-reference-check", "gpt2-xl-paper", "dist-train", {}),
    *[("dist-zero-reference-check", "gpt2-xl-paper", v, {})
      for v in ("dist-train-sharded", "dist-train-fp16", "dist-train-adam8")],
    # the untied head (stablelm-12b), the hybrid's shared block (zamba2)
    ("train-untied-reference-check", "stablelm-12b", "dist-train", {}),
    ("dist-zamba2-reference-check", "zamba2-2.7b", "dist-train", {}),
    # the moe family (deepseek-moe-16b: the dense prefix on the first
    # stage), each rank with its stage's experts and with expert
    # parallelism over the data group
    ("dist-moe-reference-check", "deepseek-moe-16b", "dist-train",
     {"moe_mode": "zero3"}),
    ("dist-moe-ep-reference-check", "deepseek-moe-16b", "dist-train",
     {"moe_mode": "expert_parallel"}),
    # the audio and vlm families on stub frames or patches (whisper's
    # encoder on every stage, pixtral's patches on the first)
    ("dist-whisper-reference-check", "whisper-small", "dist-train", {}),
    ("dist-pixtral-reference-check", "pixtral-12b", "dist-train", {}),
]
DIST_CHECK_LAYERS, DIST_CHECK_BATCH, DIST_CHECK_SEQ = 4, 4, 32
# [dist-fsdp-check]: the checks whose card runs (ZeRO-3 over the 2 data
# ranks) run again on the card in the whole-stage layout, in the same
# spawn, and must give their losses bit for bit
FSDP_CHECKS = ("dist-reference-check", "dist-zamba2-reference-check",
               "dist-moe-reference-check", "dist-moe-ep-reference-check",
               "dist-whisper-reference-check")


def dist_reference_checks(torch, checks=DIST_CHECKS):
    """The 2 x 2 mesh at SMOKE width (4 layers) on the card (kernels)
    against the CPU (plain versions), deterministic rounding, same
    seed, with the pipeline's remat and chunked loss (its defaults):
    every check of ``checks`` ((tag, arch, `DIST_VARIANTS` name,
    `PipelineConfig` fields)) run in turn by one spawn a device.  An
    untied model's last stage holds the head, so no embedding copy is
    checked; a hybrid's shared block copies must be bit-equal on every
    stage after every step; under expert parallelism each rank's ``ep``
    bytes equal `training.pipeline.ep_wire_bytes` at every step, and 0
    otherwise; each rank's ``fsdp`` bytes equal
    `training.pipeline.fsdp_gather_bytes` at every step.  Then
    [dist-fsdp-check]: the `FSDP_CHECKS` run on the card in the
    whole-stage layout too (the spec's private ``_whole_stage``), in the
    card's spawn, their losses bit-equal to the sharded runs'."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.training import pipeline as PL
    from repro_torch.training.pipeline import PipelineConfig

    losses, shared, ep = {}, {}, {}
    for dev in ("cpu", "cuda"):
        specs = []
        for _, arch, v, pipe in checks:
            extra, opt = DIST_VARIANTS[v]
            specs.append(_dist_spec(torch, [
                "--device", dev, "--smoke", "--no-stochastic", "--steps",
                "3", "--batch", str(DIST_CHECK_BATCH), "--seq",
                str(DIST_CHECK_SEQ), "--samples", "4",
                "--arch", arch, *extra], layers=DIST_CHECK_LAYERS))
            specs[-1]["optimizer"].update(opt)
            if pipe:
                specs[-1]["pipeline"] = dict(pipe)
        twins = [i for i, c in enumerate(checks) if c[0] in FSDP_CHECKS] \
            if dev == "cuda" else []
        specs += [dict(specs[i], _whole_stage=True) for i in twins]
        runs = launch_train.run_distributed(specs, timeout=DIST_TIMEOUT)
        runs, whole = runs[:len(checks)], runs[len(checks):]
        losses[dev] = [res[0]["losses"] for res in runs]
        for i, res in zip(twins, whole):
            sharded = [r["losses"] for r in runs[i]]
            small = get_config(checks[i][1], smoke=True).with_(
                num_layers=DIST_CHECK_LAYERS)
            lay = PL.stage_layout(small, DIST_STAGES)
            pcfg = PipelineConfig(microbatches=DIST_MICRO, **checks[i][3])
            largest = [PL.fsdp_largest_gather(small, pcfg, lay, k, DIST_DATA)
                       for k in range(DIST_STAGES)]
            experts = {u: w for u, (_, _, w) in PL.fsdp_gathers(
                small, pcfg, lay, 0, DIST_DATA).items()
                if u.startswith("experts.")}
            phase("dist-fsdp-check", arch=checks[i][1], check=checks[i][0],
                  moe_mode=checks[i][3].get("moe_mode"),
                  largest_gather_bytes_by_rank=json.dumps(
                      [r["largest_gather"][-1] for r in runs[i]]),
                  largest_gather_model_by_stage=json.dumps(largest),
                  expert_gather_bytes_stage0=json.dumps(experts),
                  fsdp_calls_rank0_step3=json.dumps(
                      runs[i][0]["fsdp_gathers"][-1]),
                  losses_sharded=json.dumps(sharded[0]),
                  losses_whole_stage=json.dumps(res[0]["losses"]),
                  bit_equal=sharded == [r["losses"] for r in res],
                  fsdp_bytes_sharded=json.dumps(
                      [r["bytes"][-1]["fsdp"] for r in runs[i]]),
                  resident_bytes_sharded=json.dumps(
                      [r["resident_bytes"] for r in runs[i]]),
                  resident_bytes_whole_stage=json.dumps(
                      [r["resident_bytes"] for r in res]))
            assert sharded == [r["losses"] for r in res], checks[i]
            assert all(b["fsdp"] == 0 for r in res for b in r["bytes"])
            for r in runs[i]:
                assert r["largest_gather"] == [largest[r["model_rank"]]] \
                    * len(r["largest_gather"]), (checks[i], r["largest_gather"])
        for i, ((_, arch, _, pipe), res) in enumerate(zip(checks, runs)):
            small = get_config(arch, smoke=True).with_(
                num_layers=DIST_CHECK_LAYERS)
            lay = PL.stage_layout(small, DIST_STAGES)
            pcfg = PipelineConfig(microbatches=DIST_MICRO, **pipe)
            for r in res:
                want = PL.fsdp_gather_bytes(small, pcfg, lay, r["model_rank"],
                                            DIST_DATA, DIST_MICRO)
                assert [b["fsdp"] for b in r["bytes"]] \
                    == [want] * len(r["bytes"]), (arch, pipe, want)
                calls = {u: DIST_MICRO * c for u, (c, _, _) in
                         PL.fsdp_gathers(small, pcfg, lay, r["model_rank"],
                                         DIST_DATA).items()}
                assert r["fsdp_gathers"] == [calls] * len(r["bytes"]), \
                    (arch, pipe, r["fsdp_gathers"], calls)
            cfg = get_config(arch)
            if cfg.has_moe:
                small = get_config(arch, smoke=True).with_(
                    num_layers=DIST_CHECK_LAYERS)
                lay = PL.stage_layout(small, DIST_STAGES)
                pcfg = PipelineConfig(microbatches=DIST_MICRO, **pipe)
                tokens = DIST_CHECK_BATCH // DIST_MICRO // DIST_DATA \
                    * DIST_CHECK_SEQ
                for r in res:
                    n = min(lay.lps, lay.n_layers - r["model_rank"]
                            * lay.lps)
                    want = PL.ep_wire_bytes(small, pcfg, n, tokens,
                                            DIST_DATA, DIST_MICRO) \
                        if pcfg.moe_mode == "expert_parallel" else 0
                    got = [b["ep"] for b in r["bytes"]]
                    assert got == [want] * len(got), (arch, pipe, got, want)
                    ep.setdefault(i, []).append(want)
            reps = [rep for r in res for rep in r["replicas"]]
            if not cfg.tie_embeddings:
                assert all(rep["embed_equal"] is None for rep in reps), arch
            flags = [rep["shared_equal"] for r in res for rep in
                     r["replicas"] if r["model_rank"] > 0]
            assert all(flags) if cfg.family == "hybrid" \
                else not any(flags), (arch, flags)
            enc = [rep["encoder_equal"] for r in res for rep in
                   r["replicas"] if r["model_rank"] > 0]
            assert all(enc) if cfg.family == "audio" \
                else not any(enc), (arch, enc)
            shared[i] = len(flags) if cfg.family == "hybrid" else len(enc)
    for i, (tag, arch, v, pipe) in enumerate(checks):
        pcfg = PipelineConfig(**pipe)
        lc, lg = losses["cpu"][i], losses["cuda"][i]
        rel = [abs(a - b) / abs(a) for a, b in zip(lc, lg)]
        hybrid = get_config(arch).family == "hybrid"
        phase(tag, trainer="distributed", arch=arch,
              variant=v, moe_mode=pcfg.moe_mode if get_config(
                  arch).has_moe else None,
              ep_bytes_per_step_by_rank=json.dumps(ep.get(i)),
              remat=pcfg.remat,
              remat_mode=pcfg.remat_mode, loss_chunks=pcfg.loss_chunks,
              losses_cpu=json.dumps(lc), losses_card=json.dumps(lg),
              rel_loss_diff=json.dumps(rel),
              shared_block_copies_equal=f"{shared[i]} checks" if hybrid
              else None,
              encoder_copies_equal=f"{shared[i]} checks"
              if get_config(arch).family == "audio" else None,
              tolerance=f"step1 {FIRST_STEP_RTOL} later {LATER_STEP_RTOL}")
        assert rel[0] <= FIRST_STEP_RTOL, (tag, v, rel)
        assert max(rel[1:]) <= LATER_STEP_RTOL, (tag, v, rel)


# ---------------------------------------------------------------------------
# phase 11: fault tolerance (checkpoints, kill and resume, fault recovery)
# ---------------------------------------------------------------------------

LOSS_LINE = r"^step\s+(\d+) loss \S+ \[(\S+)\]$"
CKPT_LINE = (r"^checkpoint: (saved|restored) step (\d+) "
             r"\((\d+) B, ([\d.]+) s\)$")


def _resume_config():
    """[train-resume]'s model, trainer config and dataset: [train]'s
    settings at `RESUME_LAYERS` layers in `RESUME_STAGES` stage groups."""
    from repro_torch.comm import config as comm_mod
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import Dataset, DatasetConfig
    from repro_torch.optim import adamw
    from repro_torch.training import simulated as sim

    cfg = get_config("gpt2-xl-paper").with_(num_layers=RESUME_LAYERS)
    tcfg = _train_config(sim, comm_mod, adamw, stochastic=True,
                         stages=RESUME_STAGES, steps=RESUME_STEPS)
    ds = Dataset(DatasetConfig(num_samples=TRAIN_SAMPLES, seq_len=TRAIN_SEQ,
                               vocab_size=cfg.vocab_size, seed=0))
    return cfg, tcfg, ds


def _resume_launches_per_step() -> dict:
    """[train]'s launches a step at one boundary and 2 layers."""
    nb = RESUME_STAGES - 1
    want = {k: v // (TRAIN_STAGES - 1) * nb if k in (
        "delta_quantize_pack", "quantize_pack", "unpack_dequant") else v
        for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    want["flash_attention_fwd"] = RESUME_LAYERS * TRAIN_WORKERS
    return want


def _block_params(cfg) -> int:
    from repro_torch.models.model import Block
    return sum(p.numel() for p in Block(cfg, device="meta").parameters())


def reckoned_sim_bytes(cfg) -> int:
    """A [train-resume] checkpoint's array bytes: params and the two
    moments in f32, the 2 workers' f32 carries over the 512-wide bucket,
    one boundary's f32 messages and seen flags, the noise state."""
    n = cfg.vocab_size * cfg.d_model + cfg.d_model \
        + cfg.num_layers * _block_params(cfg)
    rows = -(-n // DP_BUCKET[1])
    return (12 * n + TRAIN_WORKERS * rows * DP_BUCKET[1] * 4
            + (RESUME_STAGES - 1) * TRAIN_SAMPLES * (TRAIN_SEQ * cfg.d_model
                                                     * 4 + 1) + 16 + 8)


def reckoned_global_bytes(cfg) -> int:
    """A [dist-train-resume] checkpoint's array bytes as stored, its main
    step and its sidecar together: the whole model's parameters and two
    AdamW moments in f32 (2 layers over 2 stages: no dead layer), each
    data rank's f32 carry over the pipeline's whole bucket, the step
    (an int32), and every stage's m_out and m_in (bf16, stored as f32)
    of every rank's `DIST_SAMPLES` rows, ``DIST_SAMPLES // DIST_DATA``
    a data rank in the main step and the rest in the sidecar."""
    n_model = cfg.vocab_size * cfg.d_model + cfg.d_model \
        + cfg.num_layers * _block_params(cfg)
    rows = -(-n_model // DP_BUCKET[1])
    return (12 * n_model + DIST_DATA * rows * DP_BUCKET[1] * 4 + 4
            + 2 * DIST_STAGES * DIST_DATA * DIST_SAMPLES * DIST_SEQ
            * cfg.d_model * 4)


def _need_disk(path: str, nbytes: int, what: str) -> None:
    """Fail loudly unless the disk under ``path`` has ``nbytes`` free."""
    import shutil
    os.makedirs(path, exist_ok=True)
    free = shutil.disk_usage(path).free
    phase("ckpt-disk", what=what, free_bytes=free, need_bytes=nbytes)
    if free < nbytes:
        raise RuntimeError(f"{path}: {free} B free, {what} needs {nbytes}")


def resume_child(mode: str, ckpt_dir: str, log_path: str,
                 knob: str = "0") -> None:
    """A fresh process of [train-resume] (the spawn target): ``mode``
    "kill" checkpoints every `RESUME_SAVE_EVERY` steps and hard-exits
    with 17 after step `RESUME_KILL_AT`'s loss; "resume" resumes from
    the newest checkpoint; ``knob`` "1" sets the on-core noise knob
    ([train-resume-oncore]).  Every line the runner prints goes to
    ``log_path`` as JSON with the kernel launches so far, so the killed
    process leaves its record."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import env
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.launch import runner

    os.environ[env.ONCORE_PRNG] = knob
    tag = "train-resume-oncore" if knob == "1" else "train-resume"
    cfg, tcfg, ds = _resume_config()
    qp.reset_launches()
    with open(log_path, "w") as log:
        def emit(line: str) -> None:
            print(f"[{tag}-{mode}] {line}", flush=True)
            log.write(json.dumps({"line": line,
                                  "launches": dict(qp.LAUNCHES)}) + "\n")
            log.flush()

        runner.run_sim_training(
            cfg, tcfg, ds, num_steps=RESUME_STEPS, batch_size=TRAIN_BATCH,
            log_every=1, ckpt_dir=ckpt_dir, save_every=RESUME_SAVE_EVERY,
            keep=RESUME_KEEP, resume=mode == "resume",
            kill_at=RESUME_KILL_AT if mode == "kill" else None, seed=0,
            device="cuda", print_fn=emit)


def _parse_run(lines: list) -> dict:
    """Losses by step (from the hex), and the saves and restores."""
    import re
    out = {"losses": {}, "saved": [], "restored": []}
    for line in lines:
        m = re.match(LOSS_LINE, line)
        if m:
            out["losses"][int(m.group(1))] = float.fromhex(m.group(2))
        m = re.match(CKPT_LINE, line)
        if m:
            out[m.group(1)].append({"step": int(m.group(2)),
                                    "bytes": int(m.group(3)),
                                    "s": float(m.group(4))})
    return out


def _start_children(mode: str, dirs: dict) -> dict:
    """Start `resume_child` in fresh spawned processes side by side, one
    a (knob, checkpoint directory) of ``dirs``."""
    import multiprocessing as mp
    procs = {}
    for knob, ckpt_dir in dirs.items():
        log_path = os.path.join(CKPT_ROOT, f"{mode}-{knob}.jsonl")
        proc = mp.get_context("spawn").Process(
            target=resume_child, args=(mode, ckpt_dir, log_path, knob))
        proc.start()
        procs[knob] = (proc, log_path, time.perf_counter())
    return procs


def _join_children(mode: str, procs: dict) -> dict:
    """Wait for `_start_children`' processes: {knob: (exit code, its
    records, seconds from its start)}."""
    out = {}
    for knob, (proc, log_path, t0) in procs.items():
        proc.join(timeout=DIST_TIMEOUT)
        if proc.is_alive():
            proc.kill()
            proc.join()
            raise RuntimeError(f"[train-resume] {mode} child timed out")
        with open(log_path) as f:
            records = [json.loads(line) for line in f]
        out[knob] = (proc.exitcode, records, time.perf_counter() - t0)
    return out


def train_resume_phase(torch, qp, env) -> dict:
    """[train-resume], [train-resume-oncore] (the same with the on-core
    noise knob) and [train-fault]; the killed processes run beside the
    uninterrupted runs and the fault run, which this process makes;
    returns their launches."""
    import shutil
    from repro_torch.comm.faults import FaultPlan
    from repro_torch.launch import runner

    cfg, tcfg, ds = _resume_config()
    per_step = _resume_launches_per_step()
    reckoned = reckoned_sim_bytes(cfg)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    _need_disk(CKPT_ROOT, 3 * (RESUME_KEEP + 1) * reckoned, "train-resume")
    dirs = {knob: os.path.join(CKPT_ROOT, f"sim-{knob}") for knob in "01"}
    kill_procs = _start_children("kill", dirs)

    base, base_launches = {}, {}
    for knob in dirs:
        os.environ[env.ONCORE_PRNG] = knob
        try:
            torch.cuda.empty_cache()
            qp.reset_launches()
            _, base[knob] = runner.run_sim_training(
                cfg, tcfg, ds, num_steps=RESUME_STEPS,
                batch_size=TRAIN_BATCH, log_every=0, seed=0, device="cuda")
            torch.cuda.synchronize()
            base_launches[knob] = dict(qp.LAUNCHES)
        finally:
            del os.environ[env.ONCORE_PRNG]
    torch.cuda.empty_cache()

    # [train-fault]: the same run with a fault on fw, dp and bw
    lines = []
    qp.reset_launches()
    t0 = time.perf_counter()
    _, losses = runner.run_sim_training(
        cfg, tcfg, ds, num_steps=RESUME_STEPS, batch_size=TRAIN_BATCH,
        log_every=1, ckpt_dir=os.path.join(CKPT_ROOT, "fault"),
        save_every=RESUME_SAVE_EVERY, keep=RESUME_KEEP,
        max_retries=FAULT_RETRIES, fault_plan=FaultPlan.parse(FAULT_PLAN),
        seed=0, device="cuda", print_fn=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fault_launches = dict(qp.LAUNCHES)
    run = _parse_run(lines)
    tripped = [ln for ln in lines if ln.startswith("guard tripped")]
    recovered = [ln for ln in lines if ln.startswith("recovered from")]
    phase("train-fault", plan=FAULT_PLAN, max_retries=FAULT_RETRIES,
          guard_lines=json.dumps(tripped), recoveries=json.dumps(recovered),
          losses_exact=json.dumps(losses),
          losses_bit_equal=losses == base["0"],
          saves=json.dumps(run["saved"]),
          restores=json.dumps(run["restored"]), wall_s=f"{wall:.1f}",
          steps_run=FAULT_STEPS_RUN, launches=json.dumps(fault_launches))
    assert losses == base["0"], (losses, base["0"])
    want = [("fw", 2), ("dp", 3), ("bw", 5)]
    assert len(tripped) == len(want), tripped
    for line, (plane, step) in zip(tripped, want):
        wire = getattr(tcfg.comm, plane).wire
        assert f"plane={plane} wire={wire!r} step={step}" in line, line
    assert recovered == [f"recovered from checkpoint step {s} "
                         f"(retry {i + 1}/{FAULT_RETRIES})"
                         for i, s in enumerate((2, 2, 4))], recovered
    for name, n in per_step.items():
        assert fault_launches[name] == n * FAULT_STEPS_RUN, \
            (name, fault_launches)
    shutil.rmtree(os.path.join(CKPT_ROOT, "fault"))

    kills = _join_children("kill", kill_procs)
    resumes = _join_children("resume", _start_children("resume", dirs))
    both = {}
    for knob, tag in (("0", "train-resume"), ("1", "train-resume-oncore")):
        code, kill_rec, kill_s = kills[knob]
        code_r, res_rec, res_s = resumes[knob]
        killed = _parse_run([r["line"] for r in kill_rec])
        resumed = _parse_run([r["line"] for r in res_rec])
        kill_launches, res_launches = kill_rec[-1]["launches"], \
            res_rec[-1]["launches"]
        want = dict(per_step, oncore_uniform=sum(
            per_step[n] for n in ONCORE_ENCODERS) if knob == "1" else 0)
        phase(tag, layers=f"{RESUME_LAYERS}/48", d_model=cfg.d_model,
              vocab=cfg.vocab_size, steps=RESUME_STEPS,
              save_every=RESUME_SAVE_EVERY, kill_at=RESUME_KILL_AT,
              keep=RESUME_KEEP, reckoned_bytes=reckoned,
              losses_exact=json.dumps(base[knob]),
              killed_losses=json.dumps(killed["losses"]),
              resumed_losses=json.dumps(resumed["losses"]),
              kill_exit=code, resume_exit=code_r,
              saves=json.dumps(killed["saved"] + resumed["saved"]),
              restores=json.dumps(resumed["restored"]),
              kill_process_s=f"{kill_s:.1f}", resume_process_s=f"{res_s:.1f}",
              launches=json.dumps(base_launches[knob]),
              launches_killed=json.dumps(kill_launches),
              launches_resumed=json.dumps(res_launches))
        assert code == runner.KILL_EXIT_CODE == 17, code
        assert code_r == 0, code_r
        assert kill_rec[-1]["line"].startswith(
            f"killing at step {RESUME_KILL_AT}"), kill_rec[-1]
        assert [killed["losses"][i] for i in range(RESUME_KILL_AT + 1)] \
            == base[knob][:RESUME_KILL_AT + 1], (killed["losses"], base)
        assert sorted(resumed["losses"]) == list(range(RESUME_KILL_AT,
                                                       RESUME_STEPS))
        assert [resumed["losses"][i] for i in sorted(resumed["losses"])] \
            == base[knob][RESUME_KILL_AT:], (resumed["losses"], base)
        assert [c["step"] for c in killed["saved"]] == [0, 2, 4]
        assert [c["step"] for c in resumed["restored"]] == [RESUME_KILL_AT]
        for c in killed["saved"] + resumed["saved"] + resumed["restored"]:
            assert reckoned < c["bytes"] < reckoned + 2 ** 20, (c, reckoned)
        for name, n in want.items():
            assert base_launches[knob].get(name, 0) == n * RESUME_STEPS, \
                (name, base_launches[knob])
            assert kill_launches.get(name, 0) == n * (RESUME_KILL_AT + 1), \
                (name, kill_launches)
            assert res_launches.get(name, 0) \
                == n * (RESUME_STEPS - RESUME_KILL_AT), (name, res_launches)
        both[knob] = {k: kill_launches.get(k, 0) + res_launches.get(k, 0)
                      for k in base_launches[knob]}
    assert base["1"] != base["0"], "the knob changed no bit"
    shutil.rmtree(CKPT_ROOT)
    torch.cuda.empty_cache()
    return {"train_resume": both["0"], "train_resume_oncore": both["1"],
            "train_fault": fault_launches}


def knob_ranks(rank, world, runs):
    """`training.pipeline.train_rank` of each (knob, spec) of ``runs`` in
    turn in this process, the on-core noise knob set to ``knob`` ("1" or
    "0") for each (`run_dist_knobs`' spawn target)."""
    from repro_torch import env
    from repro_torch.training import pipeline as PL
    out = []
    for knob, spec in runs:
        os.environ[env.ONCORE_PRNG] = knob
        out.append(PL.train_rank(rank, world, spec))
    return out


def run_dist_knobs(runs) -> list:
    """`launch.train.run_distributed` of (knob, spec) pairs of one mesh
    on the card: the kernels built first, one spawn; each spec's results
    by rank."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn
    for name in build.SIGNATURES:
        build.build(name)
    world = runs[0][1]["data_par"] * runs[0][1]["stages"]
    out = spawn(knob_ranks, world, (runs,), timeout=DIST_TIMEOUT,
                threads=max(1, (os.cpu_count() or 1) // world))
    return [[r[i] for r in out] for i in range(len(runs))]


def _seeded_specs(torch, ckpt_dir) -> list:
    """[dist-seeded-check]'s (knob, spec) pairs (`SEEDED_RUNS`): SMOKE,
    `DIST_CHECK_LAYERS` layers, stochastic rounding on every plane or,
    where the hop is deterministic, on the DP wire alone."""
    import dataclasses
    from repro_torch.comm.config import CommConfig
    out = []
    for _, wire, chunks, knob, hop, role in SEEDED_RUNS:
        flags = ["--device", "cuda", "--smoke", "--steps", str(SEEDED_STEPS),
                 "--batch", str(DIST_CHECK_BATCH), "--seq",
                 str(DIST_CHECK_SEQ), "--samples", str(2 * DIST_CHECK_BATCH),
                 "--dp-wire", wire, "--dp-chunks", str(chunks)]
        if role == "stop":
            flags += ["--ckpt-dir", ckpt_dir, "--save-every", "2"]
        elif role == "resume":
            flags += ["--ckpt-dir", ckpt_dir, "--resume"]
        spec = _dist_spec(torch, flags, layers=DIST_CHECK_LAYERS)
        if role == "stop":
            spec["steps"] = 2          # the schedule stays SEEDED_STEPS
        if not hop:
            c = CommConfig.from_json(spec["comm"])
            spec["comm"] = dataclasses.replace(
                c, fw=c.fw.with_(stochastic=False),
                bw=c.bw.with_(stochastic=False)).to_json()
        out.append((knob, spec))
    return out


def dist_seeded_check(runs) -> dict:
    """[dist-seeded-check] on the results of `_seeded_specs`' runs (in
    `SEEDED_RUNS` order); returns the seeded ring's launches."""
    res = {tag: r for (tag, *_), r in zip(SEEDED_RUNS, runs)}
    losses = {tag: r[0]["losses"] for tag, r in res.items()}

    def launches(tag):
        return {k: sum(st[k] for r in res[tag] for st in r["launches"])
                for k in res[tag][0]["launches"][0]}

    seeded = {tag: {k: launches(tag)[k] for k in
                    (*ONCORE_ENCODERS, "oncore_uniform")} for tag in res}
    resumed = losses["stop"] + losses["resume"]
    phase("dist-seeded-check", layers=DIST_CHECK_LAYERS,
          steps=SEEDED_STEPS, losses=json.dumps(losses),
          psum_ring_sharded_bit_equal=losses["psum"] == losses["ring"]
          == losses["ring-sharded"],
          chunks2_knob_bit_equal=losses["chunks2-knob"] == losses["chunks2"],
          resumed_bit_equal=resumed == losses["ring"],
          resumed_from=res["resume"][0]["start"],
          launches=json.dumps(seeded))
    for tag, r in res.items():
        assert all(x["losses"] == r[0]["losses"] for x in r), tag
        assert all(math.isfinite(x) for x in r[0]["losses"]), tag
        got = seeded[tag]
        if tag.startswith("chunks2"):
            # deterministic hop, the chunked ring's noise tensor
            assert got["oncore_uniform"] == 0, (tag, got)
        else:
            assert got["oncore_uniform"] == sum(
                got[n] for n in ONCORE_ENCODERS) > 0, (tag, got)
    assert losses["psum"] == losses["ring"] == losses["ring-sharded"], \
        losses
    assert losses["chunks2-knob"] == losses["chunks2"], losses
    assert res["resume"][0]["start"] == 2
    assert resumed == losses["ring"], (resumed, losses["ring"])
    return launches("ring")


def dist_resume_phase(torch) -> dict:
    """[dist-train-resume]: [dist-train]'s spec at 2 layers, run
    uninterrupted, stopped after step 2 with a checkpoint in the JAX
    launcher's global layout, and resumed; [dist-train-oncore], the
    uninterrupted run's spec with the
    on-core noise knob; and [dist-seeded-check]'s SMOKE runs, all in one
    spawn.  Returns the stopped and resumed runs' launches summed over
    the ranks, [dist-train-oncore]'s, and the seeded SMOKE ring's."""
    import shutil
    from repro_torch.comm.config import CommConfig
    from repro_torch.configs.base import get_config
    from repro_torch.core import collectives as C
    from repro_torch.core import quantization as Q
    from repro_torch.checkpoint import tree_fingerprint
    from repro_torch.serving import DeltaHopCodec
    from repro_torch.training import pipeline as PL
    from repro_torch.training import pipeline_state as PS

    cfg = get_config("gpt2-xl-paper").with_(num_layers=RESUME_LAYERS)
    reckoned = reckoned_global_bytes(cfg)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    d = os.path.join(CKPT_ROOT, "dist")
    _need_disk(CKPT_ROOT, reckoned + 2 ** 30, "dist-train-resume")
    flags = ["--device", "cuda", "--steps", str(DIST_STEPS), "--batch",
             str(DIST_BATCH), "--seq", str(DIST_SEQ), "--samples",
             str(DIST_SAMPLES)]
    base = _dist_spec(torch, flags, layers=RESUME_LAYERS)
    stop = _dist_spec(torch, [*flags, "--ckpt-dir", d, "--save-every", "2"],
                      layers=RESUME_LAYERS)
    stop["steps"] = 2          # the optimizer's schedule stays 4 steps
    resume = _dist_spec(torch, [*flags, "--ckpt-dir", d, "--resume"],
                        layers=RESUME_LAYERS)
    seeded = _seeded_specs(torch, os.path.join(CKPT_ROOT, "seeded"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    b, st, rs, on, *smoke = run_dist_knobs(
        [("0", base), ("0", stop), ("0", resume), ("1", base), *seeded])
    wall = time.perf_counter() - t0
    with open(os.path.join(d, "step_%08d" % 2, "manifest.json")) as f:
        manifest_fp = json.load(f)["body"]["fingerprint"]
    struct_fp = tree_fingerprint(PS.global_structs(PS.spec_layout(stop)))
    # launches a step summed over the ranks: the DP ring on every rank
    # every step, B10 2 a microbatch a rank (3 x 1 - 1 under nested
    # remat), the hop kernels a microbatch a data rank once compressed
    warm = {"quantize_codes_scaled": 4, "dequant_sum_mean": 8,
            "unpack_accumulate": 4, "pack_sums": 4, "unpack_sums": 4,
            "flash_attention_fwd": DIST_DATA * DIST_STAGES * DIST_MICRO * 2}
    hop = DIST_DATA * DIST_MICRO
    comp = dict(warm, delta_quantize_pack=hop, dequant_unpack_accumulate=hop,
                quantize_pack=hop, unpack_dequant=hop)
    names = [*DIST_LAUNCHES, "oncore_uniform"]

    def summed(res, i):
        return {k: sum(r["launches"][i].get(k, 0) for r in res)
                for k in names}

    launches = {k: 0 for k in names}
    for res, steps in ((st, (0, 1)), (rs, (2, 3))):
        for i, step in enumerate(steps):
            got = summed(res, i)
            want = {k: (warm if step < 2 else comp).get(k, 0)
                    for k in names}
            assert got == want, (step, got, want)
            assert got == summed(b, step), (step, got)
            for k in launches:
                launches[k] += got[k]
    save = [r["ckpt"][0] for r in st]
    restore = [r["ckpt"][0] for r in rs]
    gb = save[0]["bytes"] / 1e9
    phase("dist-train-resume", mesh=f"{DIST_DATA}x{DIST_STAGES}",
          layers=RESUME_LAYERS, d_model=cfg.d_model, dp_wire="ring",
          reckoned_bytes=reckoned, bytes_on_disk=save[0]["bytes"],
          ckpt_plane_bytes_by_rank=json.dumps(
              [c["ckpt_plane_bytes"] for c in save]),
          restore_ckpt_plane_bytes_by_rank=json.dumps(
              [c["ckpt_plane_bytes"] for c in restore]),
          save_s_by_rank=json.dumps([round(c["seconds"], 3) for c in save]),
          restore_s_by_rank=json.dumps(
              [round(c["seconds"], 3) for c in restore]),
          save_s_per_gb=f"{save[0]['seconds'] / gb:.3f}",
          restore_s_per_gb=f"{max(c['seconds'] for c in restore) / gb:.3f}",
          manifest_fingerprint=manifest_fp, structure_fingerprint=struct_fp,
          losses_exact=json.dumps(b[0]["losses"]),
          stopped_losses=json.dumps(st[0]["losses"]),
          resumed_losses=json.dumps(rs[0]["losses"]),
          resumed_from=rs[0]["start"],
          replicas_last_stage=json.dumps(
              [rep for r in rs if r["model_rank"] == DIST_STAGES - 1
               for rep in r["replicas"]]),
          launches_stop_and_resume=json.dumps(launches),
          wall_s_all_runs=f"{wall:.1f}")
    assert manifest_fp == struct_fp, (manifest_fp, struct_fp)
    # one writer: rank (0, 0) wrote the state the others sent it
    assert reckoned < save[0]["bytes"] < reckoned + 2 ** 20, \
        (save[0], reckoned)
    assert save[0]["ckpt_plane_bytes"] == 0, save[0]
    for c in save[1:]:
        assert c["bytes"] == 0 and c["ckpt_plane_bytes"] > 0, c
    # one reader: rank (0, 0) read it and sent the others their slices
    assert restore[0]["bytes"] == save[0]["bytes"], restore[0]
    assert restore[0]["ckpt_plane_bytes"] > 0, restore[0]
    for c in restore[1:]:
        assert c["bytes"] == 0 and c["ckpt_plane_bytes"] == 0, c
    for c in restore:
        assert c["rows"] is True, c
    for r_b, r_s, r_r in zip(b, st, rs):
        assert r_s["losses"] == r_b["losses"][:2], (r_s["losses"],
                                                    r_b["losses"])
        assert r_r["start"] == 2 and r_r["losses"] == r_b["losses"][2:], \
            (r_r["losses"], r_b["losses"])
        assert [c["step"] for c in r_s["ckpt"]] == [2]
        assert [(c["op"], c["step"]) for c in r_r["ckpt"]] == [("restore",
                                                                2)]
        if r_r["model_rank"] == DIST_STAGES - 1:
            for rep in r_r["replicas"]:
                assert rep["m_in_equal"] is True, rep
                assert rep["embed_equal"] is True, rep

    # [dist-train-oncore]: every seeded encoder's noise drawn in the
    # kernel, the same bytes, replicas and launches otherwise
    oncore = {k: sum(summed(on, i)[k] for i in range(DIST_STEPS))
              for k in names}
    plain = {k: sum(summed(b, i)[k] for i in range(DIST_STEPS))
             for k in names}
    encodes = sum(oncore[n] for n in ONCORE_ENCODERS)
    lay = PL.stage_layout(cfg, DIST_STAGES)
    bucket = PL.PipelineBucket(cfg, lay, 512).shape
    mb = DIST_BATCH // DIST_DATA // DIST_MICRO
    pcfg = PL.PipelineConfig(comm=CommConfig.from_json(base["comm"]))
    want = {"fw_warm": DIST_MICRO * mb * DIST_SEQ * cfg.d_model * 4,
            "fw": DIST_MICRO * DeltaHopCodec(mode="aqsgd", bits=4).hop_bytes(
                mb * DIST_SEQ, cfg.d_model),
            "bw": DIST_MICRO * Q.wire_bytes((mb, DIST_SEQ, cfg.d_model), 8),
            "dp": C.ring_wire_bytes(bucket, 4, DIST_DATA),
            "fsdp": [PL.fsdp_gather_bytes(cfg, pcfg, lay, k, DIST_DATA,
                                          DIST_MICRO)
                     for k in range(DIST_STAGES)]}
    rel = abs(on[0]["losses"][-1] - b[0]["losses"][-1]) \
        / abs(b[0]["losses"][-1])
    phase("dist-train-oncore", mesh=f"{DIST_DATA}x{DIST_STAGES}",
          layers=f"{RESUME_LAYERS}/48", d_model=cfg.d_model, dp_wire="ring",
          dp_bucket=list(bucket), losses_exact=json.dumps(on[0]["losses"]),
          losses_without_knob=json.dumps(b[0]["losses"]),
          final_loss_rel_diff=rel, tolerance=DIST_ONCORE_FINAL_LOSS_RTOL,
          oncore_uniform=oncore["oncore_uniform"], encodes=encodes,
          noise_input_encodes=encodes - oncore["oncore_uniform"],
          launches=json.dumps(oncore), launches_without_knob=json.dumps(plain),
          bytes_rank0_by_step=json.dumps(on[0]["bytes"]),
          bytes_rank1_by_step=json.dumps(on[1]["bytes"]),
          bytes_models=json.dumps(want),
          replicas_rank1=json.dumps(on[1]["replicas"]),
          step_s_rank0=json.dumps([round(x, 4)
                                   for x in on[0]["step_seconds"]]),
          step_s_rank0_without_knob=json.dumps(
              [round(x, 4) for x in b[0]["step_seconds"]]),
          peak_mem_gib_by_rank=json.dumps(
              [round(r["peak_mem_bytes"] / 2**30, 3) for r in on]))
    assert all(r["losses"] == on[0]["losses"] for r in on), "ranks disagree"
    assert all(math.isfinite(x) for x in on[0]["losses"]), on[0]["losses"]
    assert oncore["oncore_uniform"] == encodes == sum(
        DIST_LAUNCHES[n] for n in ONCORE_ENCODERS), oncore
    assert plain["oncore_uniform"] == 0, plain
    assert {k: v for k, v in oncore.items() if k != "oncore_uniform"} \
        == {k: v for k, v in plain.items() if k != "oncore_uniform"}, oncore
    for r in on:
        for i, x in enumerate(r["bytes"]):
            if r["model_rank"] == 0:
                assert x["fw"] == want["fw_warm" if i < 2 else "fw"], x
            else:
                assert x["bw"] == want["fw_warm" if i < 2 else "bw"], x
            assert x["dp"] == want["dp"], x
            assert x["fsdp"] == want["fsdp"][r["model_rank"]], x
        if r["model_rank"] == DIST_STAGES - 1:
            for rep in r["replicas"]:
                assert rep["m_in_equal"] is True, rep
                assert rep["embed_equal"] is True, rep
    assert rel <= DIST_ONCORE_FINAL_LOSS_RTOL, rel
    seeded_launches = dist_seeded_check(smoke)
    shutil.rmtree(CKPT_ROOT)
    return {"dist_resume": launches, "dist_oncore": oncore,
            "dist_seeded_smoke": seeded_launches}


def train_resume_cli_phase() -> None:
    """[train-resume-cli]: the launcher killed at step 7 and resumed,
    each in its own process on the card, and uninterrupted in a third
    beside them."""
    import re
    import shutil

    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    d = os.path.join(CKPT_ROOT, "cli")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def start(extra):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGS,
             *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=ROOT)

    def finish(proc):
        out, err = proc.communicate(timeout=DIST_TIMEOUT)
        return subprocess.CompletedProcess(proc.args, proc.returncode, out,
                                           err)

    def loss_lines(out):
        return [ln for ln in out.splitlines()
                if re.match(r"(step\s+\d+ loss|final loss)", ln)]

    t0 = time.perf_counter()
    base = start([])            # beside the killed and resumed runs
    killed = finish(start(["--ckpt-dir", d, "--save-every", "3",
                           "--kill-at", "7"]))
    resumed = finish(start(["--ckpt-dir", d, "--save-every", "3",
                            "--resume"]))
    base = finish(base)
    wall = time.perf_counter() - t0
    for run in (base, killed, resumed):
        if run.returncode not in (0, 17):
            print(run.stdout, run.stderr[-4000:], file=sys.stderr)
    phase("train-resume-cli", args=f"'{' '.join(CLI_ARGS)}'",
          exit_codes=json.dumps([base.returncode, killed.returncode,
                                 resumed.returncode]),
          base_lines=json.dumps(loss_lines(base.stdout)),
          resumed_lines=json.dumps(loss_lines(resumed.stdout)),
          wall_s_three_runs=f"{wall:.1f}")
    assert base.returncode == 0 and resumed.returncode == 0
    assert killed.returncode == 17, killed.returncode
    assert "killing at step 7" in killed.stdout
    assert "resumed from step 6" in resumed.stdout
    want = [ln for ln in loss_lines(base.stdout)
            if not ln.startswith("step     0 ")]
    assert len(want) == 2 and loss_lines(resumed.stdout) == want, \
        (loss_lines(resumed.stdout), want)
    shutil.rmtree(CKPT_ROOT)


# ---------------------------------------------------------------------------
# phase 12: the examples
# ---------------------------------------------------------------------------

def run_example(name: str, argv: list) -> tuple:
    """examples/<name>.py's ``main(argv)`` in this process, its output
    kept apart: (its result, seconds, its output)."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = module.main(argv)
    return res, time.perf_counter() - t0, out.getvalue()


def examples_phase() -> None:
    """[examples]: the quickstart and split learning at their own sizes
    (their asserts hold inside), serve_batched ``--tiny``."""
    quick, quick_s, _ = run_example("torch_quickstart", ["--device", "cuda"])
    split, split_s, _ = run_example("torch_split_learning",
                                    ["--device", "cuda"])
    reqs, serve_s, log = run_example("torch_serve_batched",
                                     ["--tiny", "--device", "cuda"])
    phase("examples", quickstart_s=f"{quick_s:.1f}",
          split_learning_s=f"{split_s:.1f}",
          serve_batched_tiny_s=f"{serve_s:.1f}",
          total_s=f"{quick_s + split_s + serve_s:.1f}",
          quickstart_final_losses=json.dumps(quick),
          split_learning_final_losses=json.dumps(split),
          requests_done=sum(r.state == "DONE" for r in reqs),
          requests=len(reqs))
    assert quick["aqsgd"] < quick["directq"], quick
    assert split["aqsgd"] < split["directq"], split
    assert all(math.isfinite(x) for x in [*quick.values(), *split.values()])
    assert reqs and all(r.state == "DONE" for r in reqs), log


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch import env
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import ref
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("card", nvidia_smi=f"'{smi}'", torch_device=f"'{kind}'",
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    names = list(build.SIGNATURES)        # one nvcc a source, side by side
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build.build, names)))
    for name in names:
        build.load(name)
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          libraries=json.dumps({n: os.path.relpath(p, ROOT)
                                for n, p in libs.items()}))

    kernels = kernel_phase(torch, qp, ref)
    kernels["flash_attention_fwd"] = flash_phase(torch, fa, ref)
    kernels["flash_attention_fwd"]["train_check"] = flash_train_phase(
        torch, fa, ref, qp)
    kernels["oncore_uniform"] = oncore_phase(torch, qp, ref)
    legacy_rows, legacy_launches = legacy_phase(torch, qp, ref, env)
    kernels.update(legacy_rows)
    kv_pair_phase(torch, qp, ref, build, kernels)

    torch.cuda.reset_peak_memory_stats()
    qp.reset_launches()
    out = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = dict(qp.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    logits, tokens = out["logits"], out["tokens"]
    phase("serve", prefill_s=f"{out['prefill_s']:.4f}",
          decode_tok_s=f"{out['decode_tok_s']:.2f}",
          peak_mem_gib=f"{peak / 2**30:.3f}", launches=json.dumps(launches),
          decode_steps=GEN)
    assert tokens.shape == (BATCH, GEN), tokens.shape
    assert logits.shape == (BATCH, 1, 50257), logits.shape
    assert torch.isfinite(logits).all().item(), "non-finite logits"
    serve_launches = launches
    for name in ("delta_quantize_pack", "dequant_unpack_accumulate",
                 "quantize_pack", "unpack_dequant", "flash_attention_fwd"):
        assert launches[name] > 0, \
            f"{name} was never launched on the serving path"
    assert launches["flash_attention_fwd"] == 48, launches  # one a layer
    # the KV append and store read: k and v in one launch each, a layer
    # of the prefill and of every decode step
    for name in ("quantize_pack", "unpack_dequant"):
        assert launches[name] == (1 + GEN) * 48, (name, launches)
    for name in LEGACY_KERNELS:
        assert launches[name] == 0, launches
    reference_check(torch)
    cont, cont_launches = serve_continuous_phase(torch, qp, serve)
    for name in ("delta_quantize_pack", "dequant_unpack_accumulate",
                 "quantize_pack", "unpack_dequant", "flash_attention_fwd"):
        assert cont_launches[name] > 0, \
            f"{name} was never launched on the continuous serving path"
    serve_continuous_isolation(torch, cont)
    del cont
    torch.cuda.empty_cache()
    serve_continuous_guard(torch)
    for arch in CONT_CHECK_WINDOW:
        continuous_reference_check(torch, arch)
    gemma_launches, cpu_draw_s = serve_cell_phase(torch, qp, serve,
                                                  "serve-gemma2")
    phase("serve-gemma2-build", cpu_draw_s=f"{cpu_draw_s:.3f}",
          device_draw_s=f"{gemma2_device_draw_s(torch):.3f}")
    reference_check(torch, "gemma2-9b", G_CHECK_PROMPT, G_CHECK_STEPS,
                    tag="serve-gemma2-reference-check")
    # the remaining dense archs: stablelm-12b at full size (its untied
    # head, B10 at head_dim 160) and gemma2-27b at full width
    stablelm_launches, _ = serve_cell_phase(torch, qp, serve,
                                            "serve-stablelm")
    g27_launches, _ = serve_cell_phase(torch, qp, serve, "serve-gemma2-27b")
    for arch, (p, n) in SERVE_CHECKS.items():
        reference_check(torch, arch, p, n,
                        tag=f"serve-{arch}-reference-check")
    # the ssm and hybrid families at full size, and their SMOKE checks
    ssm_launches = {tag: ssm_serve_phase(torch, qp, serve, tag)
                    for tag in SSM_CELLS}
    for arch, kw in SSM_CHECK_CFG.items():
        reference_check(torch, arch, SSM_CHECK_PROMPT, SSM_CHECK_STEPS,
                        tag=f"serve-{arch.split('-')[0]}-reference-check",
                        **kw)
    # the moe family at full width (the depth cut), its SMOKE checks with
    # the routing compared, and the batcher
    moe_launches = {tag: serve_cell_phase(torch, qp, serve, tag)[0]
                    for tag in ("serve-deepseek-moe", "serve-mixtral")}
    for arch, (tag, p, n) in MOE_CHECKS.items():
        moe_reference_check(torch, arch, p, n, tag)
    moe_cont_launches = serve_moe_continuous_phase(torch, qp, serve)
    moe_continuous_check(torch, qp)
    # the audio and vlm families: whisper at full size, pixtral at full
    # width, and their SMOKE checks with raw and with 8-bit KV
    media_launches = {tag: media_serve_phase(torch, qp, serve, tag)
                      for tag in MEDIA_CELLS}
    for arch, *_ in MEDIA_CELLS.values():
        for kv_bits in (0, 8):
            reference_check(torch, arch, MEDIA_CHECK_PROMPT,
                            MEDIA_CHECK_STEPS, kv_bits=kv_bits,
                            carry_kv=kv_bits == 8,
                            tag=f"serve-{arch.split('-')[0]}-reference-check")
    # the continuous batcher on the ssm, hybrid, audio and vlm families
    # through the launcher, and its SMOKE checks on each arch
    family_cont = {arch: family_continuous_phase(torch, qp, serve, tag, arch,
                                                 args)
                   for tag, cells in FAMILY_CONT.items()
                   for arch, args in cells}
    for arch, kw in FAMILY_CONT_CHECKS.items():
        family_continuous_checks(torch, qp, arch, **kw)

    train_run = train_phase(torch, qp)
    train_launches = train_run["launches"]
    for name in TRAIN_LAUNCHES_PER_STEP:
        if TRAIN_LAUNCHES_PER_STEP[name]:
            assert train_launches[name] > 0, \
                f"{name} was never launched on the training path"
    oncore_launches = train_oncore_phase(torch, qp, env, train_run)
    assert oncore_launches["oncore_uniform"] > 0, \
        "the seeded encoders were never launched on the training path"
    sharded_launches = train_sharded_phase(torch, qp, train_run)
    train_reference_check(torch)
    for wire in ("ring-sharded", "fp16"):
        train_reference_check(torch, wire=wire,
                              tag="train-zero-reference-check")
    full = train_phase(torch, qp, tag="train-full-depth",
                       layers=FULL_DEPTH_LAYERS, remat=True)
    phase("train-full-depth-vs-train", layers=FULL_DEPTH_LAYERS,
          median_step_s=f"{full['step_s']:.4f}",
          tokens_per_s=f"{TRAIN_BATCH * TRAIN_SEQ / full['step_s']:.1f}",
          peak_mem_gib=f"{full['peak_gib']:.3f}",
          b10_launches=full["launches"]["flash_attention_fwd"],
          median_step_s_train=f"{train_run['step_s']:.4f}",
          peak_mem_gib_train=f"{train_run['peak_gib']:.3f}")
    zamba_train = train_phase(torch, qp, tag="train-zamba2",
                              layers=TZ_LAYERS, arch="zamba2-2.7b",
                              stages=TZ_STAGES)
    moe_train = train_phase(torch, qp, tag="train-moe", layers=TM_LAYERS,
                            arch="deepseek-moe-16b", stages=TM_STAGES,
                            workers=0)
    whisper_train = train_phase(torch, qp, tag="train-whisper",
                                layers=W_LAYERS, arch="whisper-small",
                                stages=TW_STAGES, seq=TW_SEQ)
    resume_launches = train_resume_phase(torch, qp, env)
    dist_runs = dist_phases(torch)
    dist_launches = dist_runs["dist-train"]
    for name in DIST_LAUNCHES:
        if DIST_LAUNCHES[name]:
            assert dist_launches[name] > 0, \
                f"{name} was never launched on the distributed path"
    for name in ("quantize_codes_scaled", "dequant_sum_mean",
                 "unpack_accumulate"):
        assert dist_runs["dist-train-sharded"][name] > 0, \
            f"{name} was never launched on the ZeRO wire's path"
    # the untied head (stablelm-12b SMOKE) and the ssm and hybrid
    # families (zamba2 at head_dim 80) through the simulated trainer, and
    # every distributed check in one spawn a device
    train_reference_check(torch, "stablelm-12b",
                          tag="train-untied-reference-check")
    for arch, kw in SSM_CHECK_CFG.items():
        train_reference_check(
            torch, arch, tag=f"train-{arch.split('-')[0]}-reference-check",
            **kw)
    train_reference_check(torch, "deepseek-moe-16b",
                          tag="train-moe-reference-check")
    for arch, *_ in MEDIA_CELLS.values():
        train_reference_check(
            torch, arch, tag=f"train-{arch.split('-')[0]}-reference-check")
    dist_reference_checks(torch)
    dist_resumes = dist_resume_phase(torch)
    assert dist_resumes["dist_oncore"]["oncore_uniform"] > 0, \
        "the seeded encoders were never launched on the distributed path"
    train_resume_cli_phase()
    examples_phase()
    # a row's launches are those of the path its time was taken at:
    # serving for the activation codecs and the attention kernel (gpt2-xl
    # prefill), training for the DP wire, the distributed path for the
    # ring's kernels, training with the on-core noise knob for B11, the
    # legacy chain for B9a and B9b (0 on every other path)
    by_path = {"serve": serve_launches, "serve_continuous": cont_launches,
               "serve_gemma2": gemma_launches,
               "serve_stablelm": stablelm_launches,
               "serve_gemma2_27b": g27_launches,
               "serve_mamba2": ssm_launches["serve-mamba2"],
               "serve_zamba2": ssm_launches["serve-zamba2"],
               "serve_deepseek_moe": moe_launches["serve-deepseek-moe"],
               "serve_mixtral": moe_launches["serve-mixtral"],
               "serve_moe_continuous": moe_cont_launches,
               **{f"serve_{arch.split('-')[0]}_continuous": launches
                  for arch, launches in family_cont.items()},
               "serve_whisper": media_launches["serve-whisper"],
               "serve_pixtral": media_launches["serve-pixtral"],
               "train_whisper": whisper_train["launches"],
               "train_zamba2": zamba_train["launches"],
               "train_moe": moe_train["launches"],
               "train": train_launches, "train_oncore": oncore_launches,
               "train_full_depth": full["launches"],
               "train_sharded": sharded_launches,
               "dist": dist_launches,
               "dist_sharded": dist_runs["dist-train-sharded"],
               "dist_fp16": dist_runs["dist-train-fp16"],
               "dist_adam8": dist_runs["dist-train-adam8"],
               "train_resume": resume_launches["train_resume"],
               "train_resume_oncore": resume_launches["train_resume_oncore"],
               "train_fault": resume_launches["train_fault"],
               **dist_resumes,
               "legacy_dp": legacy_launches}
    for name in LEGACY_KERNELS:
        assert all(by_path[p][name] == 0 for p in by_path
                   if p != "legacy_dp"), (name, by_path)
    for name, row in kernels.items():
        path = "legacy_dp" if name in LEGACY_KERNELS else \
            "dist" if name in INT_KERNELS else \
            "train" if name in DP_KERNELS else \
            "train_oncore" if name == "oncore_uniform" else "serve"
        row["launches"] = by_path[path][name]
        row["launches_path"] = path
        row["launches_by_path"] = {p: by_path[p].get(name, 0)
                                   for p in by_path}
    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
