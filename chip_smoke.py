#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; imports only ``repro_torch``, torch,
numpy and scipy. Phases (any failure exits non-zero and prints no result):

  1. build     — compile the kernels' ten sources from the repo, one
                 nvcc each, all started together; report the four
                 bsr_spgemm sources' ptxas lines and the ``tc``, ``warp``
                 and ``minplus`` routes' dynamic shared memory
  2. kernel    — the three bsr_spgemm routes against the plain PyTorch
                 version on the card: 3 semirings x bs in {16, 32, 64, 128}
                 through the wrapper (every semiring at bs 16/32 on the
                 ``warp`` route, plus_times and bool_or_and at bs 64/128 on
                 ``tc``, min_plus at bs 64/128 on ``minplus``; the first
                 kernel, ``simt``, on no route, directly beside each), runs
                 of 1-8 products, a seg_start offset and an empty schedule,
                 min-plus also with NaNs planted (its plain version on the
                 CPU); on ``warp`` and ``tc`` also odd integers in
                 2049-4093 (not TF32-exact; one nonzero per row and column,
                 runs of one product), inf / -inf / NaN / |x| >= 2^127
                 planted for plus_times and bool_or_and, products at
                 overflow magnitudes (nextafter(2^64, 0) squared and
                 negated, 2e19 squared, a pair whose product is FLT_MAX,
                 exact products under and over 2^126; one nonzero term an
                 output element), and for every semiring windows whose runs
                 leave gaps and whose nc runs past the last visited slot
                 (the output starts as NaN: every slot must be written) and
                 a window made only of pad products; on ``minplus`` (and
                 ``simt`` beside it) runs of 1-4 products and one of 80,
                 which the worker shares cut, +inf and NaN planted, gaps,
                 pads after the runs and pads only; integer-valued tiles
                 bitwise, float plus-times within rtol=1e-5, atol=1e-4
                 (summation order, the TF32 split), bool / min-plus bitwise
                 (a NaN matching any NaN), every launch on a route repeated
                 bitwise
  3. main path — laplacian_2d(1024) (1,048,576 rows) A·A through
                 ``SpGEMMSession(device="cuda").matmul(algorithm="1d",
                 nparts=8, bs=128)`` with chunk=None and chunk=2, held
                 bitwise against scipy; a repeat must be a cache hit with
                 no new executable builds, values x2 must repack to C x4;
                 every launch on the ``tc`` route. Then part 0's launch
                 timed on both routes: integer payloads, the same schedule
                 with every value x (1 + 2^-12) (not TF32-exact: up to four
                 passes), the ``simt`` kernel with its fill as
                 ``previous_ms``, and fp32 ``torch.bmm`` of the gathered
                 products as a yardstick that is not the same function
  4. semirings — banded_clustered(65536, 64, 16.0) with integer weights,
                 bool_or_and (``tc``) and min_plus (``minplus``) at bs=64
                 through the 1D ring (nparts=8, chunk=2), 2D SUMMA (grid
                 2) and Split-3D (grid 2, 2 layers), and min_plus at bs=128
                 through the 1D ring unchunked, each bitwise against the
                 port's host ``local_spgemm.spgemm``, each on its own rung;
                 each 1D call's largest launch timed beside the plain
                 version and, for min-plus, the ``simt`` kernel with its
                 fill (``previous_ms``; CUDA events, device time in 11)
  4a. minplus_main — |laplacian_2d(1024)| (a grid graph's edge weights)
                 A (x) A in min-plus, one path-doubling step, through the 1D
                 ring (nparts=8, bs=128, unchunked), every launch on
                 ``minplus``, bitwise against the host oracle; part 0's
                 launch (23,228 products) bitwise against the plain version
                 on the card, repeated, and timed beside it and ``simt``
  4b. default_bs — the session at its default bs (32) and BC's (16), all
                 on the ``warp`` route: laplacian_2d(1024)^2 through the 1D
                 ring with ``bs`` left out, chunk=None and chunk=2, and at
                 bs=16, chunk=None, cold then hit, bitwise against scipy,
                 the execute ms beside the bs-128 ring's; part 0's launch at
                 bs 32 and 16 timed as in phase 3 (``previous_ms``: the
                 ``simt`` kernel with its fill, which is also timed alone);
                 bool_or_and at bs 16 and min_plus at bs 32 on
                 banded_clustered through the ring (chunk=2), bitwise
                 against the host oracle, each call's largest launch timed
                 beside ``simt`` and the plain version
  5. summa     — the main path's laplacian_2d(1024)² through
                 ``SpGEMMSession(device="cuda").matmul(algorithm="2d",
                 grid=2, bs=128)`` and ``algorithm="3d", grid=2,
                 layers=2``: cold, hit and values x2 repack, bitwise
                 against scipy, no downgrade, every launch on ``tc``; per
                 call the peak device memory (the 2D call's must stay below
                 30 GB; the 3D call's below a whole (8, nc_max + 1) output
                 stack), the executable's time (CUDA events), the plan and
                 decode seconds, and the planned / padded bytes of the 1D
                 ring, 2D SUMMA and Split-3D side by side
  5'. ranks    — the same multiplies across processes, one part per rank,
                 through ``SpGEMMSession(group=WORLD)``, from the libraries
                 phase 1 built: (a) NCCL with one rank per visible card (a
                 world of one here: the NCCL setup and the rank's kernels,
                 no transfer), the 1D ring at nparts = world on
                 banded_clustered(65536, 64, 16.0) with phase 4's integer
                 weights at bs 128 (``tc``) and, with 16 NaNs planted, in
                 min-plus at bs 64 (``minplus``); (b) 8 gloo ranks
                 time-sharing cuda:0:
                 laplacian_2d(512)'s ring at nparts 8, bs 128 (``tc``) and 32
                 (``warp``), chunk None and 2, 2D SUMMA (grid 2: ranks 4-7
                 idle, receiving the result) and Split-3D (2x2x2) at bs
                 128, and min-plus with the NaNs through the ring (chunk 2)
                 and Split-3D at bs 64. Every rank's result bitwise-equal to
                 the one-process session's (the Laplacian's: to scipy's
                 A·A, exact in float32 for its integer values);
                 no fallback or downgrade; every member rank's launches on
                 the call's route, none on an idle rank; the transport's
                 bytes summed over ranks equal to ``comm_bytes_padded``
                 (ring) or the gather share D (grid - 1) (na + nb) tiles
                 (SUMMA). Per call: launches per rank, transport bytes by
                 kind, wall / plan-and-build / execute seconds per rank and
                 each rank's peak host RSS (sampled)
  5a. apps     — the paper's applications through ``repro_torch.apps``,
                 each on its own ``SpGEMMSession(device="cuda")`` at its
                 default bs, every launch on ``warp``, no profiler window:
                 (a) AMG ``galerkin_product`` of laplacian_2d(512) with
                 ``restriction_operator(a, 100)`` (8 parts, bs 32), cold
                 then two hits, bitwise against scipy's RᵀAR; (b) a
                 CountSketch stream (dim 256, A·Sᵀ) over four integer value
                 sets on the Laplacian's structure: one cold call and three
                 repacks, bitwise against scipy; (c) ``mcl`` of
                 block_diagonal_noise(131072, 2048, 8, 0.05) on the kernel
                 and again on the kernel's session (all hits, bitwise); (d)
                 ``bc_batch`` of a symmetrized block_diagonal_noise(131072,
                 512, 5, 0.3), 128 seeded sources, bs 16, on the kernel,
                 every backward call a hit with a repack; both graphs also
                 at 65,536 vertices on the kernel and on the plain version
                 (MCL: clusters and iterations equal, operators within rtol
                 1e-4, atol 1e-6; BC: depths and call counts equal, scores
                 within rtol 1e-5); (e) at 65,536 vertices, MCL killed by an
                 injected execute fault in its fourth iteration and BC by a
                 fault on its first backward call, each resumed from its
                 snapshots, bitwise. Per run: calls,
                 hits, repacks, wall, planning, repack, decode and app host
                 seconds, execute ms (CUDA events), launches by route, peak
                 device memory, the largest deviation from the reference
  5b. service  — the multi-tenant SpGEMM service: (a) the serving CLI,
                 ``launch.serve_spgemm.main(["--n", "65536", "--tenants",
                 "4", "--requests", "4", "--waves", "2"])`` on the card
                 (banded_clustered(65536, 1638, 6.0), integer values, bs 32:
                 every launch on ``warp``): a prefetch, then per wave one
                 coalesced group of the shared graph and one per tenant of
                 its reweighted twin; every group hits the prefetched plan,
                 every twin group repacks, every result bitwise against
                 scipy's A·A; (d) one tenant's 2D SUMMA request (grid 2, bs
                 128) through the same service, every launch on ``tc``,
                 bitwise; (b) on banded_clustered(16384, ...) graphs: a
                 tenant quota of 2 over three structures evicts only that
                 tenant, the survivors hit, and ``memory_allocated`` falls
                 across the eviction by at least the evicted entry's bytes;
                 a ``max_bytes`` of
                 one entry keeps only the newest; after every drain of the
                 phase ``bytes_cached == cached_bytes()`` == the bytes the
                 cached entries hold; (c) a tenant at bs 48
                 (refused at ingress) opens its breaker, is rejected at
                 admission while two others are served bitwise, and
                 recovers once the injectable clock passes the cooldown.
                 Per run: requests, groups, hits, repacks, evictions by
                 tenant, p50/p99 latency, planning, repack, decode and
                 execute (CUDA events) seconds, launches by route, peak GB
  6. build_lm  — load the flash_attention and moe_gemm libraries (for
                 flash_attention the CUDA-core source and the bf16 and
                 split-TF32 tensor-core ones; for moe_gemm the CUDA-core
                 source, the bf16 tensor-core one and the split-TF32 one);
                 ptxas's registers, spills and shared memory per kernel,
                 and the tensor-core kernels' dynamic shared memory
                 (flash_attention bf16 per padded head dim 64 / 128 / 192 /
                 256; float32 per padded head dim 32 ... 256 with its query
                 and key block, held against the host's ``fp32_config`` at
                 every head dim the route takes; moe_gemm float32's
                 blocking and shared memory, the same at every shape,
                 held against its host ``fp32_config``)
  7. flash_attention_vs_plain — both routes against ``mha_ref`` on the
                 card, causal, window in {0, 64}, softcap in {0, 50}, Hq = 8
                 with Hkv in {8, 2}: bfloat16 on the tensor-core route at D
                 in {16, 64, 96, 128, 160, 256} and S in {77, 128, 129,
                 1000, 2048}, within atol 2e-2 + rtol 1e-2 (one bf16 ulp of
                 the output); float32 on the split-TF32 route at D in {16,
                 64, 96, 128, 160, 192, 256} and S in {77, 128, 1000},
                 within atol 2e-5 + rtol 1e-4; each launch repeated,
                 bitwise; float32 at overflow magnitudes (C3's pairs:
                 nextafter(2^64, 0) squared and negated, 2e19 squared, a
                 pair whose product is FLT_MAX, exact products under and
                 over 2^126, and x·x - x·x a TF32 k-step apart) planted as
                 one q row's and one key's only nonzero at D 16 and 128,
                 causal and not: the plain version's NaN / inf pattern, the
                 rest within the float32 tolerance, every case's reading
                 printed before the check
  8. serve_smoke — ``python -m repro_torch.launch.serve --arch
                 qwen2-moe-a2.7b --smoke`` on the card in a process of its
                 own (float32, head dim 16): must exit 0
  9. moe_gemm_vs_plain — every route of the kernel against
                 ``moe_gemm_ref`` on the card: E in {1, 64}, cap in {8, 16,
                 96, 688} (bf16: the decode route up to 16, the prefill
                 route above; float32: the split-TF32 ``fp32`` route at
                 every cap), (d, f) in
                 {(2048, 1408), (1408, 2048), (640, 72), (200, 72)}; rows
                 None, all cap, all 0, random, and the 128-row tile edges
                 63-65 and 127-129; integer-valued float32 bitwise, float32
                 within atol 1e-4 + rtol 1e-4, bfloat16 within atol 2e-2 +
                 rtol 1e-2; inf, NaN and 3e38 planted in float32 x and w
                 must give the plain version's inf / NaN pattern, the
                 finite outputs within the float32 tolerance; every launch
                 repeated, bitwise (a NaN matching any NaN); C3's pairs at
                 overflow magnitudes (as in 7) planted one term an output
                 element at cap 8, 96 and 200, held the same way
  10. lm_serve — qwen2-moe-a2.7b at its full published size (24 layers, 64
                 padded experts, bf16 weights from a seeded generator)
                 through ``ServeEngine.generate``: four prompts of 2048,
                 1536, 1024 and 512 tokens, 32 new tokens, greedy,
                 sync_every=8. The launch counts must be exactly 24
                 flash_attention launches (one prefill, all on the bf16
                 tensor-core route) and 72 moe_gemm
                 launches per forward (the prefill's on the prefill route,
                 the decode steps' on the decode route); a second generate
                 must repeat the tokens; no logit may be NaN or inf. The
                 inputs (``rows`` included) of one
                 layer's attention call and of its grouped GEMMs, in prefill
                 and in a decode step, are captured by wrapping the model's
                 op references, and each kernel is held against its plain
                 version on them and timed beside the plain version, the
                 library call (SDPA, ``bmm``), the bound and the earlier
                 CUDA-core kernel on the same bf16 inputs (``previous_ms``;
                 grouped GEMMs as device time from torch.profiler); the
                 attention inputs cast to float32 time the fp32 route
                 beside SDPA in float32 and the CUDA-core kernel in float32
                 (``previous_ms``), its bound counted as three TF32 passes
                 at the tensor-core peak, the fp32 CUDA-core bound beside
                 it. A torch.profiler window over a
                 prefill-only and a 5-token generate splits device time by
                 kernel. A 512-token bf16 prefill through the plain versions
                 is compared with the kernels' logits (within 0.15 of the
                 largest logit), and the
                 model at full width cut to 2 layers in float32 must give
                 the same prefill and decode logits through the kernels as
                 through the plain versions, within 1e-3 of the largest
                 logit; that float32 run is the fp32 route's path (its
                 launches counted: 3 a MoE layer in the prefill and 3 in
                 the decode step; the prefill's up and down GEMMs and the
                 decode step's up GEMM timed, the bound counted as three
                 TF32 passes; at the decode GEMM also the CUDA-core kernel
                 on the live rows, ``cuda_core_rows_ms``)
  11. minplus_split — the three timed min-plus launches (phases 4 and 4a)
                 again from host copies of their inputs, under
                 torch.profiler: the product kernel's and the combine
                 pass's device time, and the ``simt`` kernel's with its
                 fill; after the LM phases, because profiler windows opened
                 before them made theirs drop kernel records, and before
                 the training phase, after which this process's profiler
                 recorded no kernel
  11a. mamba    — block kinds 'm' / 'M' (the SSD layer in plain torch, as
                 the reference's plain jnp): (a) mamba2-1.3b at its full
                 published size (48 layers, bf16 weights from a seeded
                 generator) through ``ServeEngine.generate`` on the four
                 prompts of phase 10, 32 new tokens: no kernel launch (the
                 model has no attention or MoE layer), a second generate
                 repeats the tokens, finite logits; the first decode step
                 after a prefill of the 512-token prompt's first 512 and
                 first 500 tokens (a chunk multiple and not one) against a
                 prefill over those tokens and the next, within 0.2 of the
                 largest logit, and the same step from the zero state (the
                 reference's prefill) above it;
                 (b) 4 AdamW steps of mamba2-1.3b at full size, S 4096, B
                 2, bf16 compute on float32 masters, remat "block", through
                 ``make_train_step`` / ``TrainLoopRunner``: every metric
                 finite, no kernel launch, step ms, tokens/s, peak memory;
                 (c) jamba-v0.1-52b at full width cut to one period (8 of
                 32 layers, m M m M a M m M) through ``generate`` on the
                 same prompts: exactly 1 flash_attention launch (the
                 prefill, ``tc``) and 12 moe_gemm launches a forward (the
                 prefill's on ``prefill``, the decode steps' on
                 ``decode``), repeated tokens, finite logits; the first
                 layer's captured GQA attention (32 heads over 8) and
                 grouped GEMMs (d 4096, f 14,336, 16 experts; prefill and
                 the first decode step) through the kernels against their
                 plain versions on the same inputs; the 512-token prefill
                 through the kernels against the plain versions, within
                 0.15 of the largest logit, and the first-decode-step
                 checks as in (a), at MoE capacity factor 16 (no token
                 dropped in either); (d) in a spawned process, one
                 mamba2-1.3b training step under torch.profiler, device
                 time by place (the SSD core, the layers, the cross
                 entropy, the optimizer, the backward) and its idle share
  11b. lm_ranks — the sharding rules executed across ranks, ``ep_dp`` on a
                 (1, P) mesh (``repro_torch.sharding``): (a) NCCL, a world
                 of one, qwen2-moe at full width cut to 2 layers, the four
                 prompts, a prefill and 2 decode steps; (b) 4 gloo ranks
                 sharing cuda:0 serving qwen2-moe-a2.7b at full size (each
                 rank draws every leaf whole from the seeded generator and
                 keeps its slice: a quarter of the embedding, 16 of the 64
                 experts a layer), one prompt a rank (the engine's
                 left-padded batch), a prefill and 32 greedy decode steps;
                 (c) 3 AdamW steps on 4 gloo ranks, full width, 2 layers,
                 global batch 4 x 2048, int8 compression, and a sharded
                 checkpoint of the parameters restored with
                 ``sharding_tree=``. Each rank's prefill and first decode
                 logits within the bf16 tolerance of the one-process port
                 on its slab (the parent computes them first, its grouped
                 GEMMs handed the ranks' P·cap rows, so it takes their
                 kernel route), the greedy tokens that agree counted, the
                 first decode step against the one-process step on its own
                 (``decode``) route within 0.05 of the largest logit unless
                 a router's top-k set differs between the two routes in
                 that step (each MoE layer's top-k under both routes
                 compared and reported), its first layer's kernels held
                 against the plain versions at its own shapes, its launches
                 counted by route (the experts' GEMMs see P·cap rows:
                 decode runs on the ``prefill`` route); the training run
                 (AdamW at lr 3e-4 from the first step) against
                 ``make_train_step(microbatches=4)`` on the global batch,
                 then one step each from the first state under remat
                 "none" and "dots" (losses within the first step's bound
                 of the oracle's; under "dots" the MoE dispatch's ``a2a``
                 and ``rows`` calls those of "none" and fewer than block's
                 first step):
                 the losses, the aux loss and the gradient norm within
                 their relative tolerances, every parameter within 2·Σlr
                 and their mean difference within 0.03·Σlr; per rank its
                 peak memory, the
                 all-to-all's bytes and seconds, prefill, decode-step and
                 step times
  11c. fsdp    — FSDP over ``data > 1`` in 4 spawned gloo ranks sharing the
                 card (each layer's parameter slices gathered in bf16
                 inside its checkpointed body, the gradients reduce-scattered
                 in float32): (a) musicgen-large at full size (3.22 B
                 parameters) under ``dp_only`` on a ``(4, 1)`` mesh, from
                 one float32 draw a rank: a 512-token prefill a rank and 2
                 greedy decode steps against the one-process port on each
                 rank's prompt (logits within ``TOL``, every greedy token
                 equal), then an AdamW step of one 2048-token sequence a
                 rank against the one-process ``make_train_step
                 (microbatches=4)`` (phase 11b's bounds), each rank holding
                 at most 26 % of the model's parameter and moment bytes;
                 (b) qwen2-moe-a2.7b at full width, 2 layers, under
                 ``ep_dp`` on ``(2, 2)`` (FSDP and expert parallelism
                 together), 2 steps of 4 x 2048 with int8 compression against
                 ``microbatches=4``. Exact launches (the forward and
                 remat's recompute) and exact ``fsdp`` bytes and calls per
                 rank (bf16 gathers, the float32 embedding, float32
                 reduce-scatters; one transfer a layer); per rank the state
                 held, peak memory, step, prefill and decode-step ms and
                 the transfers by kind
  11d. tp      — tensor and sequence parallelism on fsdp's 4 ranks: (a)
                 qwen3-8b at full size (7.57 B parameters) under
                 ``serve_tp`` on ``(1, 4)``: a 2 x 1024 prefill into a
                 cache split by sequence, 4 greedy decode steps, each rank's
                 logits within ``TOL`` of the one-process port computing
                 its products as the ranks do (bitwise on an H100), greedy
                 tokens equal (or apart only at a one-process top-2 margin
                 within twice ``TOL``), at most 26 % of the model's weights
                 and a quarter of its cache a rank; (b) qwen3-8b at full
                 width, 2 layers, under ``default`` on ``(2, 2)`` (FSDP and
                 TP): 2 AdamW steps against ``microbatches=2`` (phase 11b's
                 bounds); (c) qwen2-moe-a2.7b at full width, 2 layers,
                 under ``ep_sharded`` on ``(1, 4)``: a 2 x 1024 prefill (the
                 MoE split by sequence), 2 decode steps (the experts split),
                 an int8 step. Exact launches; per rank ms, peak memory and
                 the transfers by kind (``tp``, ``sp`` among them); (a)
                 also runs one more prefill into a cache of the prompt's
                 length (the dry-run's shape) and keeps its first decode
                 step's transfers alone
  11e. dryrun  — the H100 dry-run (``repro_torch.launch.dryrun``, fake
                 tensors on the host, no card) in a process started after
                 the build and read here: the reference test's cell,
                 musicgen-large ``decode_32k`` on ``16x16`` and
                 ``2x16x16`` (ok, 256 and 512 chips, flops, a dominant
                 term), and phase tp (a)'s prefill and decode step at
                 their shapes on a ``(1, 4)`` stand-in mesh: the bytes sent
                 and the calls of every kind (``tp``, ``sp``, ``vocab``)
                 equal what rank 0 measured; the dry-run's peak beside the
                 rank's peak allocation and its roofline terms beside the
                 measured ms, reported
  11f. examples — the examples' torch twins (``examples/torch/*.py``) on
                 the card at their default sizes (``train_lm --tiny
                 --steps 30``): each one's wall and launches by route;
                 the host twins launch nothing, MCL and the service on
                 ``warp`` (the service's bitwise oracle), ``moe_dispatch``
                 on the ``fp32`` grouped GEMM, ``train_lm``'s loss falling
                 on the ``fp32`` attention route
  12. train    — the training path (``repro_torch.train``): (a) each
                 autograd Function on the card against autograd through its
                 plain version on the card: ``multihead_attention`` (the
                 route's kernel forward, the plain chunked recompute
                 backward) at (2, 4096, 16, 128) bf16 causal, with 4 kv
                 heads, with a 1024 window and softcap 50, and at (1, 1024,
                 16, 128) float32; ``grouped_gemm`` (kernel forward, float32
                 einsum backward) at the step's (64, 640, 2048) x (64, 2048,
                 1408) and its down projection, bf16 and float32, ``rows``
                 below capacity in some experts: output and every input
                 gradient within the forward tolerances; (b) qwen2-moe-a2.7b
                 at full width cut to 4 layers (float32 masters and AdamW
                 moments, 43.7 GB; bf16 compute, remat "block"), S 4096, B
                 2, AdamW at its defaults through ``make_train_step`` and
                 ``TrainLoopRunner``: 6 steps, every metric finite, exactly
                 8 ``tc`` attention and 24 ``prefill`` GEMM launches a step
                 (forward and the backward's recompute), step ms (CUDA
                 events), tokens/s, peak memory; the same first step again
                 from the same state (bitwise?); the first 2 steps again
                 under remat "dots" (the same launches; losses and grad
                 norms against block's within phase 11b's bounds, bitwise
                 reported; step ms and peak memory beside block's); the first step through
                 the plain versions (loss within 2e-3, grad norm within
                 2e-2, relative); cut to 1 layer (a 4-layer checkpoint is
                 32.8 GB), a run killed by its batch function at step 4 and
                 resumed in a new runner from step 3's checkpoint (copied
                 into the state in place), bitwise against an
                 uninterrupted run when the step repeats bitwise; (c) the
                 model at full width, 2 layers, float32, S 1024: loss (1e-4
                 relative) and every leaf's gradient (1e-3 of its largest
                 magnitude) through the ``fp32`` routes against the plain
                 versions; (d) ``python -m repro_torch.launch.train --arch
                 qwen2-moe-a2.7b --smoke --steps 4 --compress-grads
                 --device cuda`` in a process of its own: exit 0, the
                 float32 routes' launches; (e) in a spawned process, one
                 step under torch.profiler, its device time split by where
                 each kernel ran (layers' forward and recompute,
                 cross entropy, attention backward, experts' backward,
                 optimizer, the rest) and by kind, and the idle share

Every main-path call must run on the kernel: ``fallbacks == 0``,
``last_call["engine"] == "cuda"`` and the kernel's launch count grows.
Bounds: max(bytes / HBM, operations / peak), the peak of the work's type:
fp32 FMA on the CUDA cores, TF32 or bf16 on the tensor cores.
Prints one JSON line per phase, then the ``{"kernels": [...]}`` line, the
card's name and power limit, and last ``{"ok": true, "device": ...}``.
"""

import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# published rates of the H100 variants (NVIDIA data sheets, dense, at the
# full power limit): fp32 on the CUDA cores (FMA = 2 FLOP), HBM bandwidth,
# bf16 and TF32 on the tensor cores
PEAKS = {
    "PCIe": (51.2e12, 2.0e12, 756e12, 378e12),
    "NVL": (60.0e12, 3.9e12, 835e12, 417.5e12),
    "SXM": (66.9e12, 3.35e12, 989.4e12, 494.7e12),
}
SEMIRINGS = ("plus_times", "bool_or_and", "min_plus")


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiled(fn, reps):
    """``torch.profiler``'s device events of ``reps`` calls of ``fn`` after
    one warm-up, summed by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps):
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls after
    one warm-up: the summed durations of the kernels it launched, from
    ``torch.profiler``. Unlike CUDA events around back-to-back launches, a
    host that enqueues more slowly than a short kernel runs does not
    inflate it. A profile that recorded no device time (one did on the
    card) is taken again; a second such profile gives way to CUDA events,
    as a line of its own says."""
    for _ in range(2):
        total = sum(ev.self_device_time_total for ev in profiled(fn, reps))
        if total > 0:
            return total / 1e3 / reps
    emit({"profiler": "recorded no device time twice",
          "timed_by": "cuda events"})
    return cuda_ms(fn, reps)


def kernel_ms(fn, reps):
    """Per kernel name, the mean device milliseconds of one launch and the
    launches the profiler recorded, over ``reps`` calls of ``fn``: a mean
    over the recorded launches, so a record the profiler drops (one did on
    the card) does not lower it."""
    return {ev.key: {"ms": ev.self_device_time_total / 1e3 / ev.count,
                     "recorded": ev.count}
            for ev in profiled(fn, reps) if ev.count}


def bitwise(x, y):
    return x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


def bitwise_or_nan(x, y):
    """Bitwise equal, a NaN matching any NaN (its sign and payload are not
    part of the result)."""
    nan = torch.isnan(y)
    return (x.shape == y.shape and torch.equal(torch.isnan(x), nan)
            and bitwise(x[~nan], y[~nan]))


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def phase_build():
    """Every kernel source built in parallel; the four bsr_spgemm
    libraries loaded."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg

    infos = cuda_lib.compile_sources([*kernel.SOURCES, *fa.SOURCES,
                                      *mg.SOURCES])
    kernel.build()
    smem = {kernel.TC_SOURCE: ("tc", kernel.TC_BS),
            kernel.WARP_SOURCE: ("warp", kernel.WARP_BS),
            kernel.MINPLUS_SOURCE: ("minplus", kernel.TC_BS)}
    for src in kernel.SOURCES:
        info = infos[src]
        extra = ({"dynamic_smem_bytes": {
            f"bs{bs}": kernel.smem_bytes(smem[src][0], bs)
            for bs in smem[src][1]}} if src in smem else {})
        emit({"phase": "build", "kernel": src.stem,
              "seconds": info["seconds"], "built": info["built"],
              "library": info["path"], "ptxas": ptxas_lines(info["log"]),
              **extra})
    return infos


def random_schedule(rng, na, nb, nruns, lens=None, nc=None):
    """A schedule sorted by output slot: ``nruns`` runs of 1-8 products
    (or of ``lens``), on slots 0..nruns-1 or, given ``nc``, on a sorted
    random subset of [0, nc - 1) that leaves gaps."""
    from repro_torch.core.blocksparse import flags_from_c_slot

    if lens is None:
        lens = rng.integers(1, 9, size=nruns)
    slots = (np.arange(nruns) if nc is None else
             np.sort(rng.choice(nc - 1, size=nruns, replace=False)))
    c_slot = np.repeat(slots, lens).astype(np.int32)
    a_slot = rng.integers(0, na, size=len(c_slot)).astype(np.int32)
    b_slot = rng.integers(0, nb, size=len(c_slot)).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)])
    return a_slot, b_slot, c_slot, flags_from_c_slot(c_slot), starts


def plant(rng, tiles, values):
    """Each tile with one element set to ``values[t % len(values)]``, at a
    random place."""
    tiles = tiles.copy()
    for t in range(len(tiles)):
        r, c = rng.integers(0, tiles.shape[1], size=2)
        tiles[t, r, c] = values[t % len(values)]
    return tiles


def odd_tiles(rng, n, bs):
    """One nonzero per row and column, odd integers in 2049..4093: not
    TF32-exact (lo = +-1, so the lo.lo pass is needed), and each exact
    product of two stays below 2**24."""
    vals = np.zeros((n, bs, bs), np.float32)
    for t in range(n):
        vals[t, np.arange(bs), rng.permutation(bs)] = \
            rng.integers(1024, 2047, size=bs) * 2 + 1
    return vals


# operand pairs at overflow magnitudes (C3): x = nextafter(2**64, 0), whose
# TF32 hi rounds up to 2**64, so the split's hi.hi overflows where x * x
# does not; 2e19 squared, past FLT_MAX either way; 2**63 times
# nextafter(2**65, 0) = FLT_MAX; exact products below 2**127 under and over
# the kernels' 2**126 pair bound
_X = float(np.nextafter(np.float32(2.0 ** 64), np.float32(0)))
OVERFLOW_PAIRS = [(_X, _X), (-_X, _X), (2e19, 2e19),
                  (2.0 ** 63, float(np.nextafter(np.float32(2.0 ** 65),
                                                 np.float32(0)))),
                  (2.0 ** 100, 2.0 ** 20), (3 * 2.0 ** 62, 2.0 ** 63)]


def overflow_tiles(rng, bs):
    """One diagonal A and B tile per pair of ``OVERFLOW_PAIRS``: small
    nonzero integers, the pair at one place (a different k-panel from tile
    to tile); product t is A tile t times B tile t, so every output element
    has one nonzero term."""
    n = len(OVERFLOW_PAIRS)
    a = np.zeros((n, bs, bs), np.float32)
    b = np.zeros((n, bs, bs), np.float32)
    for t, (x, y) in enumerate(OVERFLOW_PAIRS):
        d = (37 * t + 5) % bs
        for m in (a, b):
            m[t, np.arange(bs), np.arange(bs)] = rng.choice(
                [-3, -2, -1, 1, 2, 3], size=bs)
        a[t, d, d], b[t, d, d] = x, y
    return a, b


class RouteCheck:
    """Holds bsr_spgemm launches against the plain version, per route (and
    the first kernel, ``simt``, on no route): integer-valued and bool /
    min-plus results bitwise (a NaN matching any NaN), float plus-times
    within rtol=1e-5, atol=1e-4; a launch given ``repeat`` repeated must be
    bitwise equal."""

    def __init__(self):
        self.cases = {"tc": 0, "warp": 0, "minplus": 0, "simt": 0}
        self.max_err = dict.fromkeys(self.cases, 0.0)

    def __call__(self, name, got, want, exact, label, repeat=None):
        torch.cuda.synchronize()
        if exact:
            ok = bitwise_or_nan(got, want)
        else:
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-4)
            self.max_err[name] = max(self.max_err[name],
                                     float((got - want).abs().max()))
        check(ok, f"bsr_spgemm {name} != plain version: {label}")
        if repeat is not None:
            check(bitwise(repeat(), got),
                  f"a repeated bsr_spgemm {name} launch differs: {label}")
        self.cases[name] += 1


def phase_kernel(dev):
    """Every bsr_spgemm route against its plain version on the card."""
    from repro_torch.core.blocksparse import flags_from_c_slot
    from repro_torch.core.semiring import by_name
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    rng = np.random.default_rng(0)
    held = RouteCheck()
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def run(name, tiles, slots, rs, nprod, nc, bs, sr, seg_start=0,
            fill=None):
        """One launch of route ``name`` (through the wrapper when it is
        the route the wrapper picks) into an output prefilled with
        ``fill``."""
        out = torch.full((nc, bs, bs), float("nan") if fill is None
                         else fill, device=dev)
        if name == kernel.route(sr, bs):
            return kernel.bsr_spgemm(*tiles, *slots, rs, nprod=nprod, nc=nc,
                                     bs=bs, semiring=sr, seg_start=seg_start,
                                     out=out)
        kernel._launch(name, *tiles, *slots, rs, out, bs=bs, semiring=sr)
        return out

    for srname in SEMIRINGS:
        sr = by_name(srname)
        for bs in (16, 32, 64, 128):
            na, nb, nruns = 24, 24, 40
            a_slot, b_slot, c_slot, flags, starts = random_schedule(
                rng, na, nb, nruns)
            # windows: the whole schedule, one starting at run 5 (seg_start
            # offset) and ending 5 runs early, and an empty one
            windows = [(0, len(c_slot)),
                       (int(starts[5]), int(starts[nruns - 5] - starts[5])),
                       (int(starts[3]), 0)]
            slots = [put(a_slot), put(b_slot), put(c_slot)]
            routes = [kernel.route(sr, bs)]
            if routes[0] != "simt":
                routes.append("simt")    # the previous kernel, same inputs
            # min-plus also with a NaN planted in every third tile; its
            # plain version runs on the CPU, where torch.minimum and the
            # segment amin propagate NaN as the reference's jnp.minimum does
            kinds = ("int", "float") + (("nan",) if srname == "min_plus"
                                        else ())
            for kind in kinds:
                tiles = []
                for n in (na, nb):
                    vals = (rng.standard_normal((n, bs, bs))
                            if kind == "float" else
                            rng.integers(-3, 4, size=(n, bs, bs)))
                    vals = vals.astype(np.float32)
                    vals[rng.random((n, bs, bs)) < 0.5] = sr.zero
                    if kind == "nan":
                        vals = plant(rng, vals, [np.nan, 0.0, 1.0])
                    tiles.append(put(vals))
                for seg_start, nprod in windows:
                    rs = put(kernel.run_starts_from_flags(flags, seg_start,
                                                          nprod))
                    on = (lambda t: t.cpu()) if kind == "nan" else (
                        lambda t: t)
                    want = bsr_spgemm_ref(
                        *map(on, tiles), *map(on, slots), nc=nruns,
                        semiring=sr, seg_start=seg_start,
                        seg_len=nprod).to(dev)
                    if kind == "nan" and nprod:
                        check(bool(torch.isnan(want).any())
                              and bool(torch.isfinite(want).any()),
                              f"min-plus NaN case bs={bs} lacks NaN or "
                              f"finite outputs")
                    for name in routes if nprod else routes[:1]:
                        def launch(name=name):
                            if not nprod:
                                return kernel.bsr_spgemm(
                                    *tiles, *slots, rs, nprod=0, nc=nruns,
                                    bs=bs, semiring=sr, seg_start=seg_start)
                            return run(name, tiles, slots, rs, nprod, nruns,
                                       bs, sr, seg_start)
                        held(name, launch(), want,
                             kind != "float" or srname != "plus_times",
                             f"{srname} bs={bs} {kind} "
                             f"window=({seg_start}, {nprod})",
                             repeat=(launch if name != "simt" else None))

    # the tensor-core routes' own cases: warp at bs 16 and 32, tc at 64 and
    # 128
    for bs in (*kernel.WARP_BS, *kernel.TC_BS):
        name = kernel.route(by_name("plus_times"), bs)
        na = nb = 16
        # odd integers past 2048, runs of one product: exact only with the
        # lo.lo term
        a_slot, b_slot, c_slot, flags, _ = random_schedule(
            rng, na, nb, 24, lens=np.ones(24, np.int64))
        tiles = [put(odd_tiles(rng, na, bs)), put(odd_tiles(rng, nb, bs))]
        slots = [put(a_slot), put(b_slot), put(c_slot)]
        rs = put(kernel.run_starts_from_flags(flags, 0, len(c_slot)))
        want = bsr_spgemm_ref(*tiles, *slots, nc=24)
        check(float(want.max()) > 2049.0 ** 2, "odd-integer case too small")
        launch = lambda: run(name, tiles, slots, rs, len(c_slot), 24, bs,
                             by_name("plus_times"))
        held(name, launch(), want, True, f"odd integers bs={bs}",
             repeat=launch)
        # infinities and NaNs among odd integers past 2048 and among
        # integers, with |x| >= 2**127 in A (FLT_MAX's hi rounds to
        # infinity) against B in -1..1: the kernel sums such panels unsplit
        # on the CUDA cores. No product overflows (a fused multiply-add and
        # a rounded product disagree there), and runs of one product leave
        # each output element at most one huge finite term, so no sum
        # depends on its order. bool takes the same tiles (inf and NaN are
        # true, as x != 0 makes them)
        inf = np.float32(np.inf)
        for srname, kind in (("plus_times", "int"), ("plus_times", "odd"),
                             ("bool_or_and", "odd")):
            sr = by_name(srname)
            if kind == "odd":
                a, b = odd_tiles(rng, na, bs), odd_tiles(rng, nb, bs)
                a = plant(rng, a, [inf, -inf, np.nan])
            else:
                a, b = (rng.integers(lo, hi, size=(n, bs, bs)).astype(
                    np.float32) for lo, hi, n in ((-3, 4, na), (-1, 2, nb)))
                a = plant(rng, a, [inf, -inf, np.nan,
                                   np.finfo(np.float32).max,
                                   np.float32(-1.5 * 2.0 ** 127)])
            tiles = [put(a), put(plant(rng, b, [np.nan, inf, -inf]))]
            want = bsr_spgemm_ref(*tiles, *slots, nc=24, semiring=sr)
            for test in ((torch.isnan, torch.isposinf, torch.isneginf,
                          torch.isfinite) if srname == "plus_times" else ()):
                check(bool(test(want).any()), f"non-finite case lacks "
                      f"{test.__name__}")
            launch = lambda: run(name, tiles, slots, rs, len(c_slot), 24, bs,
                                 sr)
            held(name, launch(), want, True,
                 f"{srname}: inf / NaN / huge among {kind} integers bs={bs}",
                 repeat=launch)
        # products at overflow magnitudes (C3), runs of one product: where
        # the split's hi.hi overflows the kernel sums the panel unsplit, as
        # the plain version does; bool booleanizes first
        a, b = overflow_tiles(rng, bs)
        n = len(OVERFLOW_PAIRS)
        tiles = [put(a), put(b)]
        o_c = np.sort(rng.choice(n + 2, size=n, replace=False)).astype(
            np.int32)
        o_slots = [put(np.arange(n, dtype=np.int32)),
                   put(np.arange(n, dtype=np.int32)), put(o_c)]
        o_rs = put(kernel.run_starts_from_flags(flags_from_c_slot(o_c), 0, n))
        for srname in ("plus_times", "bool_or_and"):
            sr = by_name(srname)
            want = bsr_spgemm_ref(*tiles, *o_slots, nc=n + 3, semiring=sr)
            if srname == "plus_times":
                diag = want[:, torch.arange(bs), torch.arange(bs)]
                check(bool((diag == float(np.finfo(np.float32).max)).any())
                      and bool(torch.isposinf(diag).any()),
                      f"overflow case bs={bs} lacks FLT_MAX or inf")
            launch = lambda: run(name, tiles, o_slots, o_rs, n, n + 3, bs, sr)
            held(name, launch(), want, True,
                 f"{srname}: products at overflow magnitudes bs={bs}",
                 repeat=launch)
        # gapped windows and pad-only windows, every semiring on its route
        # (each kernel fills the identity itself)
        for srname in SEMIRINGS:
            sr = by_name(srname)
            name = kernel.route(sr, bs)
            # runs on a sorted subset of the slots, nc past the last one
            nruns, nc = 30, 3 * 30 + 7
            a_slot, b_slot, c_slot, flags, starts = random_schedule(
                rng, na, nb, nruns, nc=nc - 6)
            tiles = []
            for n in (na, nb):
                vals = rng.integers(-3, 4, size=(n, bs, bs)).astype(
                    np.float32)
                vals[rng.random((n, bs, bs)) < 0.5] = 0.0
                tiles.append(put(vals))
            slots = [put(a_slot), put(b_slot), put(c_slot)]
            for seg_start, nprod in ((0, len(c_slot)),
                                     (int(starts[4]),
                                      int(starts[20] - starts[4]))):
                rs = put(kernel.run_starts_from_flags(flags, seg_start,
                                                      nprod))
                want = bsr_spgemm_ref(*tiles, *slots, nc=nc, semiring=sr,
                                      seg_start=seg_start, seg_len=nprod)
                launch = lambda: run(name, tiles, slots, rs, nprod, nc, bs,
                                     sr, seg_start)
                held(name, launch(), want, True,
                     f"gapped {srname} bs={bs} window=({seg_start}, "
                     f"{nprod}) nc={nc}", repeat=launch)
            # pad products after the last run, into the garbage slot nc - 1,
            # run starts the ring's way (the pad run dropped): the whole
            # window, and a window made only of pads (no run: the kernel
            # fills every slot)
            npad = 5
            pad_c = np.concatenate([c_slot, np.full(npad, nc - 1, np.int32)])
            pad_slots = [put(np.concatenate([a_slot, a_slot[:npad]])),
                         put(np.concatenate([b_slot, b_slot[:npad]])),
                         put(pad_c)]
            pad_flags = flags_from_c_slot(pad_c)
            for seg_start, nprod in ((0, len(pad_c)), (len(c_slot), npad)):
                starts_np = kernel.run_starts_from_flags(pad_flags, seg_start,
                                                         nprod)
                if pad_c[starts_np[-2]] == nc - 1:
                    starts_np = starts_np[:-1]
                rs = put(starts_np)
                real = int(starts_np[-1] - seg_start)
                want = bsr_spgemm_ref(*tiles, *pad_slots, nc=nc, semiring=sr,
                                      seg_start=seg_start, seg_len=real)
                launch = lambda: run(name, tiles, pad_slots, rs, nprod, nc,
                                     bs, sr, seg_start)
                held(name, launch(), want, True,
                     f"pad products {srname} bs={bs} window=({seg_start}, "
                     f"{nprod}), {real} real", repeat=launch)
    phase_minplus_kernel(dev, rng, held, put, run)
    emit({"phase": "kernel_vs_plain", "cases": held.cases,
          "max_abs_err_float_plus_times": held.max_err,
          "tolerance": {"integer_bool_min_plus": "bitwise, NaN as any NaN",
                        "float_plus_times": {"rtol": 1e-5, "atol": 1e-4},
                        "repeat_routes": "bitwise"}})
    return held.max_err


def phase_minplus_kernel(dev, rng, held, put, run):
    """The ``minplus`` route's own cases at bs 64 and 128, ``simt`` beside
    it: runs of 1-4 products and one of 80, which the worker shares cut, on
    a sorted subset of the slots (gaps, nc past the last), integer tiles
    with +inf and a NaN planted in every third tile; the whole window, a
    seg_start offset, pad products after the runs and a window of pads only
    (every slot +inf); the output prefilled with NaN, each launch repeated
    bitwise, the plain version on the CPU (its NaN rules are the
    reference's)."""
    from repro_torch.core.blocksparse import flags_from_c_slot
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    na = nb = 24
    for bs in kernel.TC_BS:
        name = kernel.route(MIN_PLUS, bs)
        check(name == "minplus", f"min_plus at bs {bs} is routed to {name}")
        nruns, nc = 60, 3 * 60 + 7
        lens = rng.integers(1, 5, size=nruns)
        lens[17] = 80
        a_slot, b_slot, c_slot, flags, starts = random_schedule(
            rng, na, nb, nruns, lens=lens, nc=nc - 6)
        tiles = []
        for n in (na, nb):
            vals = rng.integers(-3, 4, size=(n, bs, bs)).astype(np.float32)
            vals[rng.random((n, bs, bs)) < 0.3] = np.inf
            vals[::3] = plant(rng, vals[::3], [np.nan])
            tiles.append(vals)
        npad = 5
        pad_c = np.concatenate([c_slot, np.full(npad, nc - 1, np.int32)])
        slots = [np.concatenate([a_slot, a_slot[:npad]]),
                 np.concatenate([b_slot, b_slot[:npad]]), pad_c]
        pad_flags = flags_from_c_slot(pad_c)
        on_card = [put(t) for t in tiles + slots]
        workers = kernel.minplus_workers(bs, dev)
        for label, seg_start, nprod, fl in (
                ("whole", 0, len(c_slot), flags),
                ("offset", int(starts[4]), int(starts[50] - starts[4]), flags),
                ("pads after", 0, len(pad_c), pad_flags),
                ("pads only", len(c_slot), npad, pad_flags)):
            rs_np = kernel.run_starts_from_flags(fl, seg_start, nprod)
            if pad_c[rs_np[-2]] == nc - 1:
                rs_np = rs_np[:-1]
            rs = put(rs_np)
            real = int(rs_np[-1] - seg_start)
            if real:
                want = bsr_spgemm_ref(
                    *map(torch.from_numpy, tiles + slots), nc=nc,
                    semiring=MIN_PLUS, seg_start=seg_start,
                    seg_len=real).to(dev)
            else:
                want = torch.full((nc, bs, bs), float("inf"), device=dev)
            cut = int((kernel.minplus_shares(rs_np, workers, bs)[1]
                       >= 0).sum())
            if label == "whole":
                check(cut > 0 and bool(torch.isnan(want).any())
                      and bool(torch.isfinite(want).any()),
                      f"minplus case bs={bs} cuts no run or lacks NaN or "
                      f"finite outputs")
            for route in (name, "simt"):
                launch = lambda route=route: run(route, on_card[:2],
                                                 on_card[2:], rs, nprod, nc,
                                                 bs, MIN_PLUS, seg_start)
                held(route, launch(), want, True,
                     f"min_plus {label} bs={bs} window=({seg_start}, "
                     f"{nprod}), {real} real, {cut} cut runs",
                     repeat=launch)


def session_call(sess, kernel, a, b, **kw):
    """One main-path call: must run on the kernel, with no fallback."""
    before = kernel.bsr_spgemm.launches
    fallbacks = sess.stats["fallbacks"]
    t0 = time.perf_counter()
    c = sess.matmul(a, b, **kw)
    wall = time.perf_counter() - t0
    check(sess.stats["fallbacks"] == fallbacks,
          f"degradation ladder fell back: {sess.last_call}")
    check(sess.last_call["engine"] == "cuda",
          f"served by engine {sess.last_call['engine']!r}, not cuda")
    check(kernel.bsr_spgemm.launches > before, "the kernel was not launched")
    return c, wall


def decode_split(entry):
    """Host seconds of one cached call's decode, and of the ``from_coo``
    COO assembly inside it (the rest is the device prune and the copy of
    the surviving entries back to the host)."""
    from repro_torch.core import device_common

    raw = entry.fn(*entry.args)
    torch.cuda.synchronize()
    inner, spent = device_common.from_coo, []

    def timed(*args, **kw):
        t = time.perf_counter()
        try:
            return inner(*args, **kw)
        finally:
            spent.append(time.perf_counter() - t)

    device_common.from_coo = timed
    try:
        t0 = time.perf_counter()
        entry.decode(entry.plan, raw)
        total = time.perf_counter() - t0
    finally:
        device_common.from_coo = inner
    return {"decode_s": total, "from_coo_s": sum(spent)}


def same_csc(c, ref, what):
    check(c.shape == ref.shape, f"{what}: shape {c.shape} != {ref.shape}")
    check(np.array_equal(c.indptr, ref.indptr), f"{what}: indptr differs")
    check(np.array_equal(c.indices, ref.indices), f"{what}: indices differ")
    check(np.array_equal(c.data.view(np.int32),
                         ref.data.astype(np.float32).view(np.int32)),
          f"{what}: values differ")


def laplacian_case(side=1024):
    """laplacian_2d(side) in float32, its values x2, and scipy's products
    A·A and (2A)·(2A)."""
    import scipy.sparse as sp

    from repro_torch.core import CSC, laplacian_2d

    a = laplacian_2d(side).astype(np.float32)
    a2 = CSC(a.indptr, a.indices, a.data * 2, a.shape)
    s = sp.csc_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                      shape=a.shape)
    ref = (s @ s).tocsc()
    ref.eliminate_zeros()
    ref.sort_indices()
    ref_c = CSC(ref.indptr.astype(np.int64), ref.indices.astype(np.int64),
                ref.data, ref.shape)
    ref4 = CSC(ref_c.indptr, ref_c.indices, ref_c.data * 4, ref.shape)
    return dict(side=side, a=a, a2=a2, ref=ref_c, ref4=ref4)


def phase_main_path(dev, case):
    """laplacian_2d(1024)·itself through SpGEMMSession, against scipy."""
    from repro_torch.core.device_common import REQUIRED_STATS
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel

    side, a, a2 = case["side"], case["a"], case["a2"]
    ref_c, ref4 = case["ref"], case["ref4"]
    sess = SpGEMMSession(device=dev)
    kw = dict(algorithm="1d", nparts=8, bs=128)
    kernel.reset_launches()
    runs = {}
    for chunk in (None, 2):
        torch.cuda.reset_peak_memory_stats()
        c, wall_cold = session_call(sess, kernel, a, a, chunk=chunk, **kw)
        same_csc(c, ref_c, f"chunk={chunk} cold")
        cold = dict(sess.last_call)
        traces = sess.stats["traces"]
        c, wall_hit = session_call(sess, kernel, a, a, chunk=chunk, **kw)
        check(sess.last_call["cache_hit"], "repeat was not a cache hit")
        check(sess.stats["traces"] == traces, "cache hit rebuilt the ring")
        same_csc(c, ref_c, f"chunk={chunk} hit")
        c, wall_repack = session_call(sess, kernel, a2, a2, chunk=chunk,
                                      **kw)
        check(sess.last_call["repacked"], "values x2 did not repack")
        check(sess.stats["traces"] == traces, "repack rebuilt the ring")
        same_csc(c, ref4, f"chunk={chunk} repack")
        runs[chunk] = dict(cold=cold, wall_s=dict(
            cold=wall_cold, hit=wall_hit, repack=wall_repack),
            max_memory_allocated=torch.cuda.max_memory_allocated())
    launches = kernel.bsr_spgemm.launches
    routes = dict(kernel.bsr_spgemm.route_launches)
    check(routes["tc"] == launches and launches > 0,
          f"main-path launches off the tc route: {routes}")

    entries = list(sess._cache.values())  # read-only: time the executables
    execute_ms = {}
    for chunk, entry in zip((None, 2), entries[:2]):
        plan = entry.plan
        r = runs[chunk]
        ms = execute_ms[chunk] = cuda_ms(lambda: entry.fn(*entry.args), 3)
        split = decode_split(entry)
        emit({"phase": "main_path", "matrix": f"laplacian_2d({side})",
              "rows": a.shape[0], "nnz_a": a.nnz, "nnz_c": ref_c.nnz,
              "chunk": chunk, "nparts": 8, "bs": 128,
              "plan_seconds": plan.stats["plan_seconds"],
              "plan_and_build_seconds": r["cold"]["plan_seconds"],
              "execute_ms": ms, "wall_s": r["wall_s"], **split,
              "max_memory_allocated": r["max_memory_allocated"],
              "tile_products": plan.stats["nprod_total"],
              **{k: plan.stats[k] for k in REQUIRED_STATS}})
    emit({"phase": "main_path_counts", "launches": launches,
          "route_launches": routes, "session_stats": sess.stats})
    ring = {k: entries[0].plan.stats[k] for k in
            ("comm_bytes_planned", "comm_bytes_padded", "messages")}
    return sess, entries[0].plan, entries[0].args, launches, ring, execute_ms


def tc_pass_panels(a_tiles, b_tiles, a_slot, b_slot, bs):
    """Tensor-core passes the ``tc`` and ``warp`` kernels run over these
    products: per product and k-panel (32 deep, or bs below 32), hi.hi plus
    one pass for each operand whose panel holds an element that is not
    TF32-exact, plus lo.lo when both do."""
    depth = min(bs, 32)
    kp = bs // depth

    def inexact(t, a_side):              # (tiles, kp) flags
        low = (t.view(torch.int32) & 0x1FFF) != 0
        if a_side:                       # an A panel is `depth` columns
            return low.view(t.shape[0], bs, kp, depth).any(3).any(1)
        return low.view(t.shape[0], kp, depth * bs).any(2)   # B: rows

    fa = inexact(a_tiles, True)[a_slot.long()]
    fb = inexact(b_tiles, False)[b_slot.long()]
    return int((1 + fa.int() + fb.int() + (fa & fb).int()).sum())


def launch_bytes(a_slot, b_slot, rs, nc, bs):
    """Bytes a launch must move: each A and B tile that the window's real
    products (``rs[0]`` to ``rs[-1]``) read, once; their three slots and the
    run starts; each of the ``nc`` output tiles, written once. Returns the
    bytes and the counts of A and B tiles read."""
    first, end = int(rs[0]), int(rs[-1])
    read = [int(torch.unique(t[first:end]).numel()) for t in (a_slot, b_slot)]
    return ((nc + sum(read)) * bs * bs * 4 + 3 * 4 * (end - first)
            + nbytes(rs)), read


def bounds(moved, fp32_flop, pass_panels, bs):
    """Least times (ms) for the work: bytes over HBM, ``fp32_flop`` over
    the CUDA-core fp32 peak, and ``pass_panels`` TF32 passes of a k-panel
    (2 bs^2 min(bs, 32) flop each) over the tensor-core peak."""
    variant, (fp32, hbm, _, tf32) = peaks(torch.cuda.get_device_name(0))
    depth = min(bs, 32)
    return {"bytes_ms": moved / hbm * 1e3,
            "fp32_ops_ms": fp32_flop / fp32 * 1e3,
            "tf32_ops_ms": pass_panels * 2 * bs * bs * depth / tf32 * 1e3,
            "peak_variant": variant, "hbm_bytes_per_s": hbm,
            "fp32_flops": fp32, "tf32_flops": tf32}


def part0_inputs(dev, plan, args):
    """Part 0's launch of an unchunked 1D plan as the ring makes it: the
    gathered A stack (its own tiles, then what the ring brings, absent ones
    at the identity) and its B stack, its schedule slots, and the host run
    starts."""
    from repro_torch.core.spgemm_1d_device import _run_starts, recv_index

    P, bs, sr = plan.nparts, plan.bs, plan.semiring
    na = plan.a_tiles.shape[1]
    idx = np.concatenate([np.arange(na), recv_index(plan, range(P - 1))[0]])
    a_tiles, b_tiles, a_slot, b_slot, c_slot = args
    stack = a_tiles.reshape(P * na, bs, bs)[
        torch.from_numpy(idx.clip(min=0)).to(dev)]
    stack[torch.from_numpy(idx < 0).to(dev)] = sr.zero
    starts = _run_starts(plan, 0, 0, int(plan.a_slot.shape[1]))
    return (stack, b_tiles[0]), (a_slot[0], b_slot[0], c_slot[0]), starts


def measure_kernel(dev, plan, args):
    """Part 0's launch of the unchunked plan, with the ring's own run
    starts, on its route, against the plain version on the same inputs:
    integer payloads (one TF32 pass), the same schedule with every value x
    (1 + 2^-12) (not TF32-exact), the ``simt`` kernel with its identity
    fill as ``previous_ms`` (and the fill alone), and fp32 ``torch.bmm`` of
    the gathered products (a yardstick: no segment sum, so not the same
    function)."""
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    bs, nc, sr = plan.bs, plan.nc_max + 1, plan.semiring
    name = kernel.route(sr, bs)
    ints, slots, starts = part0_inputs(dev, plan, args)
    nprod = int(plan.a_slot.shape[1])
    real = int(starts[-1] - starts[0])
    rs = torch.from_numpy(starts).to(dev)
    scaled = tuple(t * (1 + 2 ** -12) for t in ints)
    out = torch.empty((nc, bs, bs), dtype=torch.float32, device=dev)

    def launch(route, tiles):
        kernel._launch(route, *tiles, *slots, rs, out, bs=bs, semiring=sr)
        return out

    def plain(tiles):
        return bsr_spgemm_ref(*tiles, *slots, nc=nc, semiring=sr,
                              seg_len=real)

    want = plain(ints)
    for route in dict.fromkeys((name, "simt")):
        check(bitwise(launch(route, ints), want),
              f"main-path launch at bs {bs} on {route} != plain version")
    del want
    want = plain(scaled)
    got = launch(name, scaled)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
          f"main-path launch at bs {bs} x (1 + 2^-12) != plain version: "
          f"{err}")
    del want, got
    ms = cuda_ms(lambda: launch(name, ints), 5)
    float_ms = cuda_ms(lambda: launch(name, scaled), 5)
    previous_ms = cuda_ms(lambda: launch("simt", ints), 5)
    fill_ms = cuda_ms(lambda: out.fill_(sr.zero), 5)
    plain_ms = cuda_ms(lambda: plain(ints), 2)
    ga = ints[0][slots[0][:real].long()]
    gb = ints[1][slots[1][:real].long()]
    gout = torch.empty_like(ga)
    bmm_ms = cuda_ms(lambda: torch.bmm(ga, gb, out=gout), 3)
    del ga, gb, gout
    flop = 2 * real * bs ** 3
    moved, read = launch_bytes(slots[0], slots[1], rs, nc, bs)
    passes = tc_pass_panels(*ints, slots[0][:real], slots[1][:real], bs)
    passes_f = tc_pass_panels(*scaled, slots[0][:real], slots[1][:real], bs)
    del scaled
    bd, bd_f = (bounds(moved, flop, n, bs) for n in (passes, passes_f))
    emit({"phase": "kernel_timing", "part": 0, "bs": bs, "route": name,
          "tile_products": real, "padded_products": nprod,
          "runs": len(starts) - 1, "output_tiles": nc, "flop": flop,
          "bytes": moved, "output_bytes": nc * bs * bs * 4,
          "tiles_read": read,
          "tf32_pass_panels": {"integer": passes, "scaled": passes_f},
          "ms": ms, "float_ms": float_ms, "previous_ms": previous_ms,
          "previous_fill_ms": fill_ms,
          "previous_ms_less_fill": previous_ms - fill_ms,
          "plain_ms": plain_ms, "bmm_products_ms": bmm_ms,
          "float_max_abs_err": err, "tflops_fp32_work": flop / ms / 1e9,
          "bounds": bd, "float_tf32_ops_ms": bd_f["tf32_ops_ms"]})
    return dict(ms=ms, plain_ms=plain_ms, err=err, route=name, bs=bs,
                bound_ms=max(bd["bytes_ms"], bd["tf32_ops_ms"]),
                bound_by=("operations" if bd["tf32_ops_ms"] >= bd["bytes_ms"]
                          else "bytes"),
                previous_ms=previous_ms, previous_fill_ms=fill_ms,
                float_ms=float_ms,
                float_bound_ms=max(bd["bytes_ms"], bd_f["tf32_ops_ms"]),
                fp32_bound_ms=max(bd["bytes_ms"], bd["fp32_ops_ms"]),
                bmm_products_ms=bmm_ms, tile_products=real)


def largest_launch(kernel, fn):
    """The arguments of the bsr_spgemm call with the most products in one
    run of ``fn``; the calls of that run count on the spy, not on the
    kernel's counters."""
    inner, best = kernel.bsr_spgemm, {}

    def spy(*args, **kw):
        if kw["nprod"] > best.get("nprod", -1):
            best.update(nprod=kw["nprod"], args=args, kw=kw)
        return inner(*args, **kw)

    spy.launches, spy.route_launches = 0, dict(inner.route_launches)
    kernel.bsr_spgemm = spy
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kernel.bsr_spgemm = inner
    return best["args"], best["kw"]


def time_semiring_launch(kernel, args, kw):
    """A captured launch on its route against the plain version: bitwise,
    then both timed, beside the bound of its work."""
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    sr, bs, nc = kw["semiring"], kw["bs"], kw["nc"]
    tiles, slots, rs = args[:2], args[2:5], args[5]
    seg_start = kw.get("seg_start", 0)
    first, end = int(rs[0]), int(rs[-1])
    real = end - first
    name = kernel.route(sr, bs)
    out = torch.empty((nc, bs, bs), dtype=torch.float32, device=rs.device)

    def launch():
        kernel._launch(name, *tiles, *slots, rs, out, bs=bs, semiring=sr)
        return out

    def plain():
        return bsr_spgemm_ref(*tiles, *slots, nc=nc, semiring=sr,
                              seg_start=seg_start, seg_len=end - seg_start)

    def previous():
        kernel._launch("simt", *tiles, *slots, rs, out, bs=bs, semiring=sr)
        return out

    check(bitwise(launch(), plain()),
          f"{sr.name} launch on {name} != plain version")
    ms, plain_ms = cuda_ms(launch, 5), cuda_ms(plain, 2)
    extra = {}
    if name != "simt":   # the earlier kernel, with its fill, same inputs
        check(bitwise(previous(), plain()),
              f"{sr.name} launch on simt != plain version")
        extra["previous_ms"] = cuda_ms(previous, 5)
    if name == "minplus":
        extra.update(minplus_stats(kernel, f"bs{bs}", tiles, slots, rs, nc,
                                   bs))
    moved, read = launch_bytes(slots[0], slots[1], rs, nc, bs)
    if sr.name != "min_plus":   # bool: booleanized operands, one TF32 pass
        bd = bounds(moved, 2 * real * bs ** 3, tc_pass_panels(
            (tiles[0] != 0).float(), (tiles[1] != 0).float(),
            slots[0][first:end], slots[1][first:end], bs), bs)
        t_ops = bd["tf32_ops_ms"]
    else:              # min-plus: an add and a min a term, each at the
        # fp32 instruction rate, half the FMA FLOP rate
        bd = bounds(moved, 4 * real * bs ** 3, 0, bs)
        t_ops = bd["fp32_ops_ms"]
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_ops, bd["bytes_ms"]),
            "bound_by": "operations" if t_ops >= bd["bytes_ms"] else "bytes",
            "route": name, "bs": bs, "tile_products": real,
            "output_tiles": nc, "bytes": moved, "tiles_read": read,
            "bounds": bd, **extra}


# host copies of the timed minplus launches' inputs, by launch: profiled
# last (phase_minplus_split)
MINPLUS_INPUTS = {}


def minplus_stats(kernel, label, tiles, slots, rs, nc, bs):
    """A ``minplus`` launch's shape: its runs, its longest run, its workers
    and the runs their shares cut. Its inputs are kept on the host for
    :func:`phase_minplus_split`."""
    rs_np = rs.cpu().numpy()
    workers = kernel.minplus_workers(bs, rs.device)
    heads = kernel.minplus_shares(rs_np, workers, bs)[1]
    MINPLUS_INPUTS[label] = ([t.cpu() for t in (*tiles, *slots, rs)], nc,
                             bs)
    return {"runs": len(rs_np) - 1,
            "longest_run": int(np.diff(rs_np).max(initial=0)),
            "workers": workers, "cut_runs": int(np.unique(heads[heads >= 0])
                                                .size)}


def phase_minplus_split(dev):
    """The timed minplus launches again, from their kept inputs, under
    ``torch.profiler``: the mean duration of each of the route's two
    kernels, the product and the combine pass, and their sum; and the sum
    of the ``simt`` kernel's and its fill's (device time, which the host's
    enqueue rate cannot inflate). It runs after the LM phases, so that
    their profiler windows are the process's first: on the card, windows
    opened earlier left later ones dropping kernel records."""
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels.bsr_spgemm import kernel

    split = {}
    for label, (ts, nc, bs) in MINPLUS_INPUTS.items():
        a, b, a_slot, b_slot, c_slot, rs = (t.to(dev) for t in ts)
        out = torch.empty((nc, bs, bs), dtype=torch.float32, device=dev)
        reps = 20 if nc * bs * bs < 2 ** 26 else 5
        by_kernel, previous = (kernel_ms(lambda route=route: kernel._launch(
            route, a, b, a_slot, b_slot, c_slot, rs, out, bs=bs,
            semiring=MIN_PLUS), reps) for route in ("minplus", "simt"))
        main = [v for k, v in by_kernel.items() if "minplus_kernel" in k]
        combine = [v for k, v in by_kernel.items() if "minplus_combine" in k]
        check(len(main) == 1 and len(combine) == 1,
              f"the minplus launch ran other kernels: {sorted(by_kernel)}")
        split[label] = {"main_ms": main[0]["ms"],
                        "combine_ms": combine[0]["ms"],
                        "device_ms": main[0]["ms"] + combine[0]["ms"],
                        "previous_device_ms": sum(v["ms"] for v in
                                                  previous.values()),
                        "profiled_launches": {"main": main[0]["recorded"],
                                              "combine":
                                                  combine[0]["recorded"],
                                              "calls": reps}}
        del a, b, a_slot, b_slot, c_slot, rs, out
    MINPLUS_INPUTS.clear()
    emit({"phase": "minplus_split", **split})
    return split


SEMIRING_CALLS = (("1d", dict(nparts=8, chunk=2)), ("2d", dict(grid=2)),
                  ("3d", dict(grid=2, layers=2)))


def phase_semirings(dev, sess, n=65536):
    """bool_or_and (``tc``) and min_plus (``minplus``) at scale through the
    1D ring, 2D SUMMA and Split-3D at bs 64, against the host oracle; the
    1D call's largest launch timed on its route (launch (a) for min-plus);
    then min_plus at bs 128 through the 1D ring, unchunked, its largest
    launch timed (launch (b)). Launches are counted per call (reset just
    before, read just after) and summed per semiring."""
    from repro_torch.core import banded_clustered, by_name
    from repro_torch.core.device_common import REQUIRED_STATS
    from repro_torch.core.local_spgemm import spgemm
    from repro_torch.kernels.bsr_spgemm import kernel

    a = banded_clustered(n, 64, 16.0, seed=0)
    a.data[:] = np.rint(2 * a.data)
    a.data[a.data == 0] = 1.0
    a = a.astype(np.float32)
    timings = {}
    for srname, want_route in (("bool_or_and", "tc"),
                               ("min_plus", "minplus")):
        sr = by_name(srname)
        want = spgemm(a, a, sr)
        launches = 0
        for alg, geo in SEMIRING_CALLS:
            kernel.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            c, wall = session_call(sess, kernel, a, a, algorithm=alg, bs=64,
                                   semiring=sr, **geo)
            routes = dict(kernel.bsr_spgemm.route_launches)
            check(routes[want_route] > 0
                  and sum(routes.values()) == routes[want_route],
                  f"{srname} {alg} at bs 64 ran off the {want_route} route: "
                  f"{routes}")
            check(sess.last_call["algorithm"] == alg
                  and not sess.last_call["degraded"],
                  f"{srname} {alg} was served by another rung: "
                  f"{sess.last_call}")
            launches += routes[want_route]
            mem = torch.cuda.max_memory_allocated()
            plan_and_build = sess.last_call["plan_seconds"]
            same_csc(c, want, f"{srname} {alg}")
            entry = next(reversed(sess._cache.values()))  # the cold call's
            ms = cuda_ms(lambda: entry.fn(*entry.args), 3)
            row = {"phase": "semiring", "semiring": srname,
                   "algorithm": alg,
                   "matrix": f"banded_clustered({n}, 64, 16.0, seed=0)",
                   "bs": 64, **geo,
                   "plan_seconds": entry.plan.stats["plan_seconds"],
                   "plan_and_build_seconds": plan_and_build,
                   "execute_ms": ms, "wall_s": wall,
                   "max_memory_allocated": mem,
                   "launches": sum(routes.values()), "route_launches": routes,
                   **{k: entry.plan.stats[k] for k in REQUIRED_STATS}}
            if alg == "1d":
                t = time_semiring_launch(kernel, *largest_launch(
                    kernel, lambda: entry.fn(*entry.args)))
                timings[srname] = row["largest_launch"] = t
            emit(row)
        timings[srname]["launches"] = launches
    # launch (b): min-plus at bs 128, the 1D ring unchunked, against the
    # loop's last oracle (min-plus)
    check(sr.name == "min_plus", "launch (b) is not min-plus")
    kernel.reset_launches()
    c, wall = session_call(sess, kernel, a, a, algorithm="1d", bs=128,
                           semiring=sr, nparts=8, chunk=None)
    routes = dict(kernel.bsr_spgemm.route_launches)
    check(routes["minplus"] > 0 and sum(routes.values()) == routes["minplus"],
          f"min_plus 1d at bs 128 ran off the minplus route: {routes}")
    same_csc(c, want, "min_plus 1d bs 128")
    entry = next(reversed(sess._cache.values()))
    t = time_semiring_launch(kernel, *largest_launch(
        kernel, lambda: entry.fn(*entry.args)))
    t["launches"] = routes["minplus"]
    timings["min_plus_bs128"] = t
    emit({"phase": "semiring", "semiring": "min_plus", "algorithm": "1d",
          "matrix": f"banded_clustered({n}, 64, 16.0, seed=0)", "bs": 128,
          "nparts": 8, "chunk": None, "wall_s": wall,
          "execute_ms": cuda_ms(lambda: entry.fn(*entry.args), 3),
          "route_launches": routes, "largest_launch": t})
    return timings


def phase_minplus_main(dev, side=1024):
    """Launch (c): laplacian_2d(side) with |values| as a grid graph's edge
    weights, A (x) A in min-plus (one path-doubling step) through
    ``SpGEMMSession`` on the 1D ring (nparts=8, bs=128, unchunked), every
    launch on ``minplus``, bitwise against the host oracle; then part 0's
    launch held bitwise against the plain version on the card and timed
    beside it and the ``simt`` kernel with its fill."""
    from repro_torch.core import MIN_PLUS, laplacian_2d
    from repro_torch.core.local_spgemm import spgemm
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel
    from repro_torch.kernels.bsr_spgemm.ref import bsr_spgemm_ref

    a = laplacian_2d(side).astype(np.float32)
    a.data[:] = np.abs(a.data)
    t0 = time.perf_counter()
    want = spgemm(a, a, MIN_PLUS)
    oracle_s = time.perf_counter() - t0
    sess = SpGEMMSession(device=dev)
    kernel.reset_launches()
    c, wall = session_call(sess, kernel, a, a, algorithm="1d", nparts=8,
                           bs=128, semiring=MIN_PLUS, chunk=None)
    routes = dict(kernel.bsr_spgemm.route_launches)
    check(routes["minplus"] > 0 and sum(routes.values()) == routes["minplus"],
          f"min-plus Laplacian ran off the minplus route: {routes}")
    same_csc(c, want, "min-plus laplacian 1d bs 128")
    entry = next(reversed(sess._cache.values()))
    plan, bs = entry.plan, 128
    tiles, slots, starts = part0_inputs(dev, plan, entry.args)
    nc, real = plan.nc_max + 1, int(starts[-1] - starts[0])
    rs = torch.from_numpy(starts).to(dev)
    out = torch.empty((nc, bs, bs), dtype=torch.float32, device=dev)

    def launch(route="minplus"):
        kernel._launch(route, *tiles, *slots, rs, out, bs=bs,
                       semiring=MIN_PLUS)
        return out

    def plain():
        return bsr_spgemm_ref(*tiles, *slots, nc=nc, semiring=MIN_PLUS,
                              seg_len=real)

    ref = plain()
    check(bitwise(launch(), ref), "min-plus part 0 on minplus != plain")
    check(bitwise(launch("simt"), ref), "min-plus part 0 on simt != plain")
    check(bitwise(launch(), ref), "a repeated minplus launch differs")
    del ref
    ms = cuda_ms(launch, 5)
    previous_ms = cuda_ms(lambda: launch("simt"), 3)
    plain_ms = cuda_ms(plain, 1)
    moved, read = launch_bytes(slots[0], slots[1], rs, nc, bs)
    bd = bounds(moved, 4 * real * bs ** 3, 0, bs)
    t = {"ms": ms, "previous_ms": previous_ms, "plain_ms": plain_ms,
         "library_ms": None, "bound_ms": max(bd["fp32_ops_ms"],
                                             bd["bytes_ms"]),
         "bound_by": ("operations" if bd["fp32_ops_ms"] >= bd["bytes_ms"]
                      else "bytes"),
         "route": "minplus", "bs": bs, "tile_products": real,
         "output_tiles": nc, "bytes": moved, "tiles_read": read,
         "bounds": bd, "launches": routes["minplus"],
         **minplus_stats(kernel, "laplacian", tiles, slots, rs, nc, bs)}
    emit({"phase": "minplus_main", "matrix": f"|laplacian_2d({side})|",
          "semiring": "min_plus", "nparts": 8, "bs": bs, "chunk": None,
          "wall_s": wall, "oracle_s": oracle_s, "nnz_c": want.nnz,
          "execute_ms": cuda_ms(lambda: entry.fn(*entry.args), 3),
          "route_launches": routes, "part0_launch": t})
    del entry, plan, tiles, slots, out
    sess.clear()
    torch.cuda.empty_cache()
    return t


def phase_default_bs(dev, case, ring_ms, n=65536):
    """The session at its default bs (32; BC's 16): laplacian_2d(1024)^2
    through the 1D ring with ``bs`` left out, chunk=None and chunk=2, cold
    then hit, bitwise against scipy, the execute ms beside the bs-128
    ring's (``ring_ms``); the same at bs 16, chunk=None; part 0's launch
    timed at both; bool_or_and at bs 16 and min_plus at bs 32 on
    banded_clustered(n, 64, 16.0) through the ring (chunk=2), bitwise
    against the host oracle, each call's largest launch timed. Every launch
    on the route ``kernel.route`` names for the bs; counts are read per
    call, reset just before."""
    from repro_torch.core import PLUS_TIMES, banded_clustered, by_name
    from repro_torch.core.local_spgemm import spgemm
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel

    a, ref_c = case["a"], case["ref"]
    sess = SpGEMMSession(device=dev)
    launches, timings, ring = 0, {}, []

    def call(x, bs_kw, sr, **kw):
        """One session call, every launch on the bs's route."""
        bs = bs_kw.get("bs", 32)
        want = kernel.route(sr, bs)
        check(want == "warp", f"{sr.name} at bs {bs} is routed to {want}")
        kernel.reset_launches()
        c, wall = session_call(sess, kernel, x, x, algorithm="1d", nparts=8,
                               semiring=sr, **bs_kw, **kw)
        routes = dict(kernel.bsr_spgemm.route_launches)
        check(routes[want] > 0 and sum(routes.values()) == routes[want],
              f"{sr.name} at bs {bs} ran off the {want} route: {routes}")
        check(sess.last_call["algorithm"] == "1d"
              and not sess.last_call["degraded"],
              f"{sr.name} at bs {bs} was served by another rung")
        return c, wall, routes

    for bs_kw, chunks in (({}, (None, 2)), ({"bs": 16}, (None,))):
        for chunk in chunks:
            walls = {}
            for label in ("cold", "hit"):
                c, walls[label], routes = call(a, bs_kw, PLUS_TIMES,
                                               chunk=chunk)
                check(sess.last_call["cache_hit"] == (label == "hit"),
                      f"default bs chunk={chunk} {label}: cache_hit "
                      f"{sess.last_call['cache_hit']}")
                same_csc(c, ref_c, f"bs {bs_kw or 'default'} chunk={chunk} "
                         f"{label}")
                launches += routes[kernel.route(PLUS_TIMES,
                                                bs_kw.get("bs", 32))]
            entry = next(reversed(sess._cache.values()))
            plan = entry.plan
            ms = cuda_ms(lambda: entry.fn(*entry.args), 3)
            row = {"phase": "default_bs", "matrix":
                   f"laplacian_2d({case['side']})", "bs": plan.bs,
                   "bs_argument": bs_kw.get("bs", "default"), "chunk": chunk,
                   "nparts": 8, "route": kernel.route(PLUS_TIMES, plan.bs),
                   "route_launches": routes, "execute_ms": ms,
                   "bs128_execute_ms": ring_ms.get(chunk), "wall_s": walls,
                   "plan_seconds": plan.stats["plan_seconds"],
                   "tile_products": plan.stats["nprod_total"],
                   "nc_max": plan.nc_max}
            ring.append(row)
            emit(row)
            if chunk is None:
                timings[plan.bs] = measure_kernel(dev, plan, entry.args)
            del entry, plan
        sess.clear()
        torch.cuda.empty_cache()

    g = banded_clustered(n, 64, 16.0, seed=0)
    g.data[:] = np.rint(2 * g.data)
    g.data[g.data == 0] = 1.0
    g = g.astype(np.float32)
    semirings = {}
    for srname, bs in (("bool_or_and", 16), ("min_plus", 32)):
        sr = by_name(srname)
        c, wall, routes = call(g, {"bs": bs}, sr, chunk=2)
        same_csc(c, spgemm(g, g, sr), f"{srname} bs {bs}")
        entry = next(reversed(sess._cache.values()))
        t = time_semiring_launch(kernel, *largest_launch(
            kernel, lambda: entry.fn(*entry.args)))
        t["launches"] = routes[t["route"]]
        launches += t["launches"]
        semirings[srname] = t
        emit({"phase": "default_bs_semiring", "semiring": srname,
              "matrix": f"banded_clustered({n}, 64, 16.0, seed=0)",
              "bs": bs, "chunk": 2, "nparts": 8, "wall_s": wall,
              "execute_ms": cuda_ms(lambda: entry.fn(*entry.args), 3),
              "route_launches": routes, "largest_launch": t})
        del entry
        sess.clear()
    torch.cuda.empty_cache()
    return dict(launches=launches, timings=timings, semirings=semirings,
                ring=ring)


def phase_summa(dev, case, ring):
    """laplacian_2d(1024)·itself through SpGEMMSession as 2D SUMMA (grid
    2) and Split-3D (grid 2, 2 layers): cold, hit and values-only repack,
    each bitwise against scipy, on its own rung with every launch on the
    ``tc`` route; each call's peak device memory (reset per call), the
    executable's time from CUDA events, the decode's host time, and the
    planned and padded bytes beside the 1D ring's (``ring``)."""
    from repro_torch.core.device_common import REQUIRED_STATS
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel

    side, a, a2 = case["side"], case["a"], case["a2"]
    sess = SpGEMMSession(device=dev)
    comm = {"1d": ring}
    launches = 0
    for alg, geo in (("2d", dict(grid=2)), ("3d", dict(grid=2, layers=2))):
        kw = dict(algorithm=alg, bs=128, **geo)
        kernel.reset_launches()
        walls, peaks_b = {}, {}
        traces = sess.stats["traces"]
        for label, x, want in (("cold", a, case["ref"]),
                               ("hit", a, case["ref"]),
                               ("repack", a2, case["ref4"])):
            torch.cuda.reset_peak_memory_stats()
            c, walls[label] = session_call(sess, kernel, x, x, **kw)
            peaks_b[label] = torch.cuda.max_memory_allocated()
            same_csc(c, want, f"{alg} {label}")
            lc = sess.last_call
            check(lc["algorithm"] == lc["requested_algorithm"] == alg
                  and not lc["degraded"], f"{alg} {label} was served by "
                  f"another rung: {lc}")
            check(lc["cache_hit"] == (label != "cold")
                  and lc["repacked"] == (label == "repack"),
                  f"{alg} {label}: cache_hit {lc['cache_hit']}, repacked "
                  f"{lc['repacked']}")
            if label == "cold":
                plan_and_build = lc["plan_seconds"]
        check(sess.stats["traces"] == traces + 1,
              f"{alg}: a hit or a repack rebuilt the executable")
        routes = dict(kernel.bsr_spgemm.route_launches)
        check(routes["tc"] == kernel.bsr_spgemm.launches > 0,
              f"{alg} launches off the tc route: {routes}")
        launches += routes["tc"]
        entry = next(reversed(sess._cache.values()))
        plan = entry.plan
        ms = cuda_ms(lambda: entry.fn(*entry.args), 3)
        split = decode_split(entry)
        tile = plan.bs * plan.bs * 4
        g2, layers = plan.grid * plan.grid, plan.layers
        stacks = nbytes(entry.args[0], entry.args[1])
        out_bytes = g2 * (plan.nc_max + 1) * tile
        if alg == "2d":
            check(max(peaks_b.values()) < 30e9,
                  f"2d peak device memory {peaks_b} past 30 GB")
        else:   # the merge holds (r, c) blocks and two layers' partials
            check(max(peaks_b.values())
                  < stacks + g2 * layers * (plan.nc_max + 1) * tile,
                  f"3d peak device memory {peaks_b} reaches a whole "
                  f"(parts, nc_max + 1) output stack")
        comm[alg] = {k: plan.stats[k] for k in
                     ("comm_bytes_planned", "comm_bytes_padded",
                      "comm_bytes_model", "messages")}
        emit({"phase": "summa", "algorithm": alg,
              "matrix": f"laplacian_2d({side})", "rows": a.shape[0],
              "nnz_a": a.nnz, "nnz_c": case["ref"].nnz, "bs": 128, **geo,
              "logical_parts": g2 * layers,
              "plan_seconds": plan.stats["plan_seconds"],
              "plan_and_build_seconds": plan_and_build,
              "execute_ms": ms, "wall_s": walls, **split,
              "max_memory_allocated": peaks_b,
              "payload_stack_bytes": stacks, "output_bytes": out_bytes,
              "launches": routes["tc"], "route_launches": routes,
              "tile_products": plan.stats["nprod_total"],
              **{k: plan.stats[k] for k in
                 ("na_max", "nb_max", "nc_max", "nprod_max")},
              **{k: plan.stats[k] for k in REQUIRED_STATS}})
        sess.clear()
        del entry, plan
        torch.cuda.empty_cache()
    emit({"phase": "comm_bytes", "matrix": f"laplacian_2d({side})",
          "bs": 128, "geometry": {"1d": "nparts=8", "2d": "grid=2",
                                  "3d": "grid=2, layers=2"}, **comm})
    return launches


# ---- phase ranks: the three algorithms across processes -------------------

# 8 gloo ranks time-share the card; the group's timeout bounds every wait
# (the slowest rank's planning included), the join limit the whole spawn
RANKS_GLOO = 8
# the Laplacian's side across ranks: at 1024 (the main path's) the gloo
# world took 75-100 s on an H100, a quarter of the script's 1200 s with its
# set-up; at 512 it moves a quarter of the bytes
RANKS_SIDE = 512
RANKS_TIMEOUT_S = 300
RANKS_LIMIT_S = 400
# the ranks are stopped, and the phase fails, before the host's available
# memory falls below this (a machine out of memory loses the whole run)
RANKS_MIN_FREE = 12 << 30
# (label, operands, matmul kwargs, the route every launch must take);
# min-plus on banded_clustered with NaNs planted
RANKS_CALLS = (
    ("1d_bs128", "laplacian", dict(algorithm="1d", nparts=8, bs=128), "tc"),
    ("1d_bs128_chunk2", "laplacian",
     dict(algorithm="1d", nparts=8, bs=128, chunk=2), "tc"),
    ("1d_bs32", "laplacian", dict(algorithm="1d", nparts=8, bs=32), "warp"),
    ("1d_bs32_chunk2", "laplacian",
     dict(algorithm="1d", nparts=8, bs=32, chunk=2), "warp"),
    ("2d_bs128", "laplacian", dict(algorithm="2d", grid=2, bs=128), "tc"),
    ("3d_bs128", "laplacian", dict(algorithm="3d", grid=2, layers=2,
                                   bs=128), "tc"),
    ("min_plus_1d_bs64", "banded_nan",
     dict(algorithm="1d", nparts=8, bs=64, chunk=2, semiring="min_plus"),
     "minplus"),
    ("min_plus_3d_bs64", "banded_nan",
     dict(algorithm="3d", grid=2, layers=2, bs=64, semiring="min_plus"),
     "minplus"),
)


def ranks_operand(name):
    """The ranks phase's operands, built alike in every process:
    laplacian_2d(RANKS_SIDE) in float32 (``laplacian_case``'s ``a``), and
    banded_clustered(65536, 64, 16.0) with phase 4's integer weights
    (``"banded"``), with 16 NaNs planted at seeded entries
    (``"banded_nan"``)."""
    from repro_torch.core import banded_clustered, laplacian_2d

    if name == "laplacian":
        return laplacian_2d(RANKS_SIDE).astype(np.float32)
    a = banded_clustered(65536, 64, 16.0, seed=0)
    a.data[:] = np.rint(2 * a.data)
    a.data[a.data == 0] = 1.0
    a = a.astype(np.float32)
    if name == "banded_nan":
        a.data[np.random.default_rng(5).choice(a.nnz, 16,
                                               replace=False)] = np.nan
    return a


def csc_digest(c):
    """One digest of a CSC's shape, indptr and indices (int64) and values
    (float32 bits): equal digests, bitwise-equal results."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(c.shape, dtype=np.int64).tobytes())
    for x, dt in ((c.indptr, np.int64), (c.indices, np.int64),
                  (c.data, np.float32)):
        h.update(np.ascontiguousarray(np.asarray(x).astype(dt)).tobytes())
    return h.hexdigest()


def ranks_worker(rank, world, backend, init_file, calls, queue):
    """One rank of the ranks phase: join the group, serve ``calls`` through
    one ``SpGEMMSession(group=WORLD)`` on ``cuda:(rank % device_count)``,
    and put per call the result's digest and this rank's counts on
    ``queue``."""
    import datetime

    import torch.distributed as dist

    try:
        torch.set_num_threads(1)   # the ranks share the host's cores
        if backend == "nccl":   # one host, no network: bootstrap on loopback
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
        from repro_torch.core import by_name
        from repro_torch.core.session import SpGEMMSession
        from repro_torch.kernels.bsr_spgemm import kernel

        execute = []

        def session(validate):
            """A session over the whole group; its executables' runs timed
            (host clock to a synchronize)."""
            sess = SpGEMMSession(group=dist.group.WORLD, validate=validate)
            compile_ = sess._compile

            def timed_compile(*args, **kw):
                fn, dev_args = compile_(*args, **kw)

                def run(*xs):
                    t = time.perf_counter()
                    out = fn(*xs)
                    torch.cuda.synchronize()
                    execute.append(time.perf_counter() - t)
                    return out
                return run, dev_args

            sess._compile = timed_compile
            return sess

        # ingress validation refuses NaN operands: the NaN calls go through
        # a session that skips it
        sessions = {True: session(True), False: session(False)}
        operands, rows, rss = {}, [], PeakRss()
        for label, opname, kw, route in calls:
            if opname not in operands:
                operands[opname] = ranks_operand(opname)
            a = operands[opname]
            sess = sessions[opname != "banded_nan"]
            kw = dict(kw)
            if "semiring" in kw:
                kw["semiring"] = by_name(kw["semiring"])
            kernel.reset_launches()
            sess.transport.reset_counts()
            execute.clear()
            rss.reset()
            t0 = time.perf_counter()
            c = sess.matmul(a, a, **kw)
            wall = time.perf_counter() - t0
            entry = next(reversed(sess._cache.values()))
            plan = entry.plan
            if kw["algorithm"] == "1d":
                share = plan.stats["comm_bytes_padded"]
            else:   # the SUMMA gathers' share: D (grid - 1) (na + nb) tiles
                D = plan.grid * plan.grid * plan.layers
                share = (D * (plan.grid - 1) * (plan.a_tiles.shape[-3]
                                                + plan.b_tiles.shape[-3])
                         * plan.bs * plan.bs * 4)
            rows.append({
                "label": label, "digest": csc_digest(c), "nnz": c.nnz,
                "member": entry.part is not None, "route": route,
                "launches": kernel.bsr_spgemm.launches,
                "route_launches": dict(kernel.bsr_spgemm.route_launches),
                "wall_s": wall, "plan_and_build_s":
                    sess.last_call["plan_seconds"],
                "execute_s": sum(execute),
                "sent": dict(sess.transport.sent),
                "received": dict(sess.transport.received),
                "transport_share": share,
                "last_call": {k: sess.last_call[k] for k in (
                    "algorithm", "engine", "degraded", "retries",
                    "comm_bytes_planned", "comm_bytes_padded")},
                "fallbacks": sess.stats["fallbacks"],
                "peak_rss_bytes": rss.read()})
            sess.clear()
            del c, entry, plan
            torch.cuda.empty_cache()
        rss.close()
        queue.put((rank, "ok", rows))
    except Exception:  # report, then fail the phase in the parent
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()




def host_available():
    """The host's available memory in bytes (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return None


def process_rss(pid):
    """A process's resident memory now (``VmRSS`` of
    ``/proc/<pid>/status``)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class PeakRss:
    """This process's peak RSS, sampled every 50 ms by a daemon thread
    (the samples run while the main thread is in native code). Some hosts
    report no ``VmHWM``, and a spawned rank's ``ru_maxrss`` keeps the peak
    of the process it was forked from, so the peak is sampled.
    :meth:`reset` starts a new window."""

    def __init__(self):
        import threading

        self.peak = process_rss(os.getpid())
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, process_rss(os.getpid()))

    def reset(self):
        self.peak = process_rss(os.getpid())

    def read(self):
        return max(self.peak, process_rss(os.getpid()))

    def close(self):
        self._stop.set()
        self._thread.join()


def rank_main(target, rank, world, backend, init_file, jobs, queue):
    """A spawned rank: ``target`` on each calls the queue ``jobs`` hands it,
    each in a process group of its own (``init_file`` numbered), until
    None. The calls travel through a queue, not as the process's
    arguments: the parent writes a process's arguments into a pipe that
    the child reads only once it has imported this module, so arguments
    larger than the pipe held each start until the rank before it had
    imported (~7.5 s a rank on an H100 host). The rank's CUDA allocator
    grows its segments in place (``expandable_segments``): four ranks
    sharing the card each left ~2.3 GB reserved but unallocated, and one
    ran out of it."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    for n, calls in enumerate(iter(jobs.get, None)):
        target(rank, world, backend, f"{init_file}.{n}", calls, queue)


class RankPool:
    """``world`` spawned processes, started at once, that run ``target``
    (``ranks_worker`` by default: ``(rank, world, backend, init_file,
    calls, queue)``) on each calls handed to :meth:`run`, one after
    another, without starting again: a phase can compute between two runs
    what the next needs, and the ranks import while the phase computes
    the first. Closing ends them (joined, or killed)."""

    def __init__(self, world, backend, target=None):
        import tempfile

        ctx = torch.multiprocessing.get_context("spawn")
        self.world, self.backend = world, backend
        self.q, self.jobs = ctx.Queue(), ctx.Queue()
        self.jobs.cancel_join_thread()   # a dead rank leaves its calls
        self.tmp = tempfile.TemporaryDirectory()
        init = os.path.join(self.tmp.name, "init")
        self.procs = [ctx.Process(target=rank_main,
                                  args=(target or ranks_worker, r, world,
                                        backend, init, self.jobs, self.q))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def run(self, calls):
        """Every rank's rows for ``calls``, and the host's lowest available
        memory while they ran (sampled every half second). Past
        RANKS_LIMIT_S, or when the host's available memory falls below
        RANKS_MIN_FREE, the ranks are killed; any rank's failure fails the
        phase."""
        import queue as queues

        backend, world, procs = self.backend, self.world, self.procs
        for _ in procs:
            self.jobs.put(calls)
        got, low, lowest = {}, None, None
        deadline = time.monotonic() + RANKS_LIMIT_S
        while len(got) < world and time.monotonic() < deadline:
            free = host_available()
            lowest = free if lowest is None else min(lowest, free)
            if free is not None and free < RANKS_MIN_FREE:
                low = (free, [process_rss(p.pid) for p in procs])
                break
            try:
                rank, status, payload = self.q.get(timeout=0.5)
            except queues.Empty:
                if all(p.exitcode is not None for p in procs):
                    break
                continue
            got[rank] = (status, payload)
        bad = {r: p for r, (s, p) in got.items() if s != "ok"}
        if low is not None or len(got) < world or bad:
            for p in procs:
                p.kill()
        check(low is None, f"{backend}: the host's available memory fell "
              f"to {low and low[0]} bytes; the ranks' RSS was "
              f"{low and low[1]} (the parent's {process_rss(os.getpid())})")
        check(len(got) == world, f"{backend}: {world - len(got)} rank(s) "
              f"reported nothing within {RANKS_LIMIT_S} s")
        check(not bad, "\n".join(f"{backend} rank {r}:\n{p}"
                                 for r, p in bad.items()))
        return [got[r][1] for r in range(world)], lowest

    def close(self):
        for _ in self.procs:
            self.jobs.put(None)
        deadline = time.monotonic() + 60
        for p in self.procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.tmp.cleanup()


def spawn_ranks(world, backend, calls, target=None):
    """``calls`` run once on a :class:`RankPool` of ``world`` processes:
    per rank its rows, and the host's lowest available memory while they
    ran."""
    with RankPool(world, backend, target) as pool:
        return pool.run(calls)


def ranks_report(backend, world, calls, spawned, want):
    """Check one spawn's rows against the one-process digests ``want`` and
    emit one line per call; returns the launches by route."""
    per_rank, lowest = spawned
    emit({"phase": "ranks_host", "backend": backend, "world": world,
          "lowest_available_bytes": lowest})
    launches = dict.fromkeys(("tc", "warp", "minplus"), 0)
    for i, (label, opname, kw, route) in enumerate(calls):
        rows = [pr[i] for pr in per_rank]
        for r, row in enumerate(rows):
            check(row["digest"] == want[label],
                  f"{backend} {label}: rank {r}'s result differs from the "
                  "one-process session's")
            lc = row["last_call"]
            check(lc["engine"] == "cuda" and not lc["degraded"]
                  and lc["algorithm"] == kw["algorithm"]
                  and row["fallbacks"] == 0,
                  f"{backend} {label} rank {r} left the kernel's rung: {lc}")
            routes = row["route_launches"]
            check(row["launches"] == routes[route]
                  and (routes[route] > 0) == row["member"],
                  f"{backend} {label} rank {r} launches {routes} (member "
                  f"{row['member']}, route {route})")
            launches[route] += routes[route]
        kind = "ring" if kw["algorithm"] == "1d" else "gather"
        moved = sum(row["sent"][kind] for row in rows)
        got = sum(row["received"][kind] for row in rows)
        check(moved == got == rows[0]["transport_share"],
              f"{backend} {label}: the transport moved {moved} / {got} "
              f"bytes of {kind}, the plan's share is "
              f"{rows[0]['transport_share']}")
        emit({"phase": "ranks", "backend": backend, "world": world,
              "label": label, "operands": opname, **kw,
              "members": sum(row["member"] for row in rows),
              "nnz_c": rows[0]["nnz"], "bitwise_one_process": True,
              "route": route,
              "launches_per_rank": [row["launches"] for row in rows],
              "transport_bytes": {k: sum(row["sent"][k] for row in rows)
                                  for k in rows[0]["sent"]},
              "transport_share": rows[0]["transport_share"],
              "comm_bytes_planned": rows[0]["last_call"][
                  "comm_bytes_planned"],
              "comm_bytes_padded": rows[0]["last_call"]["comm_bytes_padded"],
              "wall_s": [row["wall_s"] for row in rows],
              "plan_and_build_s": [row["plan_and_build_s"] for row in rows],
              "execute_s": [row["execute_s"] for row in rows],
              "peak_rss_bytes": [row["peak_rss_bytes"] for row in rows]})
    return launches


def phase_ranks(dev):
    """The three algorithms across processes through
    ``SpGEMMSession(group=WORLD)``, one part per rank, from the libraries
    phase 1 built: (a) NCCL with one rank per visible card (on one card a
    world of one: the NCCL setup and the rank's kernels, no transfer), the
    1D ring at nparts = world on banded_clustered(65536, 64, 16.0) at bs
    128 and in min-plus with NaNs at bs 64; (b) 8 gloo ranks time-sharing
    cuda:0: ``RANKS_CALLS``. Every rank's result bitwise-equal to the
    one-process session's (for the Laplacian: scipy's A·A, exact in float32
    for its integer values, as phases 3, 4b and 5 hold the one-process
    session to at side 1024); every member rank's launches on the call's route, none on
    an idle rank's; the transport's bytes summed over ranks equal to
    ``comm_bytes_padded`` (ring) or the gather share (SUMMA). Returns the
    launches by route."""
    from repro_torch.core import by_name
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.kernels.bsr_spgemm import kernel

    t0 = time.perf_counter()
    banded = ranks_operand("banded_nan")
    check(np.isnan(banded.data).sum() == 16, "the NaNs were not planted")
    lap_ref = csc_digest(laplacian_case(RANKS_SIDE)["ref"])
    want = {label: lap_ref for label, opname, _, _ in RANKS_CALLS
            if opname == "laplacian"}
    n = torch.cuda.device_count()
    nccl_calls = (
        ("nccl_1d_bs128", "banded", dict(algorithm="1d", nparts=n,
                                         bs=128), "tc"),
        ("nccl_min_plus_1d_bs64", "banded_nan",
         dict(algorithm="1d", nparts=n, bs=64, semiring="min_plus"),
         "minplus"))
    # the one-process session (ingress validation refuses NaN operands)
    sess = SpGEMMSession(device=dev, validate=False)
    operands = {"banded": ranks_operand("banded"), "banded_nan": banded}
    for label, opname, kw, _ in RANKS_CALLS + nccl_calls:
        if opname != "laplacian":
            kw = dict(kw)
            if "semiring" in kw:
                kw["semiring"] = by_name(kw["semiring"])
            x = operands[opname]
            c, _ = session_call(sess, kernel, x, x, **kw)
            want[label] = csc_digest(c)
            sess.clear()
    del sess
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    emit({"phase": "ranks_host", "available_bytes": host_available(),
          "parent_rss_bytes": process_rss(os.getpid())})
    launches = ranks_report("nccl", n, nccl_calls,
                            spawn_ranks(n, "nccl", nccl_calls), want)
    t2 = time.perf_counter()
    gloo = ranks_report("gloo", RANKS_GLOO, RANKS_CALLS,
                        spawn_ranks(RANKS_GLOO, "gloo", RANKS_CALLS), want)
    t3 = time.perf_counter()
    for k, v in gloo.items():
        launches[k] += v
    emit({"phase": "ranks_counts", "route_launches": launches,
          "one_process_s": t1 - t0, "nccl_s": t2 - t1, "gloo_s": t3 - t2})
    return launches


class AppClock:
    """Where one app's time goes, read off its session: host seconds inside
    ``matmul``; of those, planning (``last_call["plan_seconds"]``: the plan
    and the executable's build), values-only repacks and decodes (host
    clock; a decode is timed once the device has finished), and the
    executables' device time (CUDA events around each run). Wraps the
    session's stage hooks, so cached entries keep them."""

    def __init__(self, sess):
        self.reset()
        plan, build, matmul = sess._plan, sess._compile, sess.matmul

        def timed(key, fn):
            def run(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    self.seconds[key] += time.perf_counter() - t0
            return run

        def planned(*args, **kw):
            p, decode, repack = plan(*args, **kw)
            decode = timed("decode_s", decode)

            def synced_decode(*a):
                torch.cuda.synchronize()
                return decode(*a)
            return p, synced_decode, timed("repack_s", repack)

        def built(*args, **kw):
            fn, dev_args = build(*args, **kw)

            def run(*xs):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                out = fn(*xs)
                e1.record()
                self.events.append((e0, e1))
                return out
            return run, dev_args

        def call(*args, **kw):
            c = timed("matmul_s", matmul)(*args, **kw)
            self.calls.append(dict(sess.last_call))
            return c

        sess._plan, sess._compile, sess.matmul = planned, built, call

    def reset(self):
        self.seconds = dict.fromkeys(("matmul_s", "repack_s", "decode_s"),
                                     0.0)
        self.events, self.calls = [], []

    def report(self):
        torch.cuda.synchronize()
        ex = sum(e0.elapsed_time(e1) for e0, e1 in self.events)
        plan_s = sum(c["plan_seconds"] for c in self.calls)
        s = self.seconds
        return {"calls": len(self.calls),
                "hits": sum(c["cache_hit"] for c in self.calls),
                "misses": sum(not c["cache_hit"] for c in self.calls),
                "repacks": sum(c["repacked"] for c in self.calls),
                "plan_seconds": plan_s, "repack_s": s["repack_s"],
                "decode_s": s["decode_s"], "execute_ms": ex,
                "session_other_s": s["matmul_s"] - plan_s - s["repack_s"]
                - s["decode_s"] - ex / 1e3,
                "comm_bytes_planned": sum(c["comm_bytes_planned"]
                                          for c in self.calls)}


def app_run(kernel, clock, fn, plain=False):
    """``fn()`` once, counted: the kernel's launches by route (set to 0
    just before, read just after), the wall, the peak device memory and the
    session's split (``clock``). A kernel run must launch only on
    ``warp`` and serve every call on the cuda engine; a plain run
    (``engine="torch"``) must launch nothing."""
    clock.reset()
    kernel.reset_launches()
    # an AppClock ties its session into a reference cycle: collect the
    # sessions of earlier runs, so their buffers do not count in this peak
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    routes = dict(kernel.bsr_spgemm.route_launches)
    row = dict(wall_s=wall, **clock.report(),
               host_app_s=wall - clock.seconds["matmul_s"],
               launches=kernel.bsr_spgemm.launches, route_launches=routes,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    engines = {c["engine"] for c in clock.calls}
    if plain:
        check(row["launches"] == 0 and engines <= {"torch"},
              f"the plain run launched the kernel: {routes}, {engines}")
    else:
        check(routes["warp"] == row["launches"] > 0 and engines == {"cuda"},
              f"app launches off the warp route: {routes}, {engines}")
        check(not any(c["degraded"] for c in clock.calls),
              "an app call was served by another rung")
    return out, row


def scipy_csc(mat):
    import scipy.sparse as sp

    return sp.csc_matrix((mat.data.astype(np.float64), mat.indices,
                          mat.indptr), shape=mat.shape)


def port_csc(s):
    from repro_torch.core import CSC

    s = s.tocsc()
    s.eliminate_zeros()
    s.sort_indices()
    return CSC(s.indptr.astype(np.int64), s.indices.astype(np.int64),
               s.data, s.shape)


def max_dev(got, want):
    """Largest |got - want| over the union of both patterns."""
    d = abs(scipy_csc(got) - scipy_csc(want))
    return float(d.max()) if d.nnz else 0.0


def apps_amg(dev, kernel, side):
    """(a) RᵀAR of laplacian_2d(side) with restriction_operator(a, 100),
    cold then again on the same session (two hits, no planning), bitwise
    against scipy in float64."""
    from repro_torch.apps import galerkin_product
    from repro_torch.core import laplacian_2d, restriction_operator
    from repro_torch.core.session import SpGEMMSession

    t0 = time.perf_counter()
    a = laplacian_2d(side)
    r = restriction_operator(a, coarsening=100)
    ref = port_csc(scipy_csc(r).T @ scipy_csc(a) @ scipy_csc(r))
    setup = time.perf_counter() - t0
    sess = SpGEMMSession(device=dev)
    clock = AppClock(sess)
    rows = {}
    for label in ("cold", "hit"):
        res, rows[label] = app_run(kernel, clock, lambda: galerkin_product(
            a, r, backend="device", nparts=8, bs=32, session=sess))
        same_csc(res.coarse, ref, f"amg {label}")
        rows[label]["max_abs_dev"] = max_dev(res.coarse, ref)
    check(rows["hit"]["hits"] == 2 and rows["hit"]["plan_seconds"] == 0.0,
          f"amg repeat: {rows['hit']['hits']} hits")
    emit({"phase": "apps", "app": "amg_galerkin",
          "matrix": f"laplacian_2d({side})", "a_shape": a.shape,
          "a_nnz": a.nnz, "r_shape": r.shape, "r_nnz": r.nnz,
          "coarse_nnz": ref.nnz, "nparts": 8, "bs": 32,
          "setup_s": setup, "runs": rows})
    del sess, clock
    torch.cuda.empty_cache()
    return rows["cold"]["launches"] + rows["hit"]["launches"]


def apps_sketch(dev, kernel, side, dim=256):
    """(b) four value sets (integers in ±{1..4}) on laplacian_2d(side)'s
    structure through one CountSketch, A·Sᵀ: one cold call and three
    values-only repacks, each bitwise against scipy."""
    from repro_torch.apps import sketch_stream
    from repro_torch.core import CSC, laplacian_2d
    from repro_torch.core.session import SpGEMMSession

    a = laplacian_2d(side)
    rng = np.random.default_rng(0)
    mats = [CSC(a.indptr, a.indices,
                rng.integers(1, 5, size=a.nnz)
                * rng.choice(np.array([-1.0, 1.0]), size=a.nnz), a.shape)
            for _ in range(4)]
    sess = SpGEMMSession(device=dev)
    clock = AppClock(sess)
    outs, row = app_run(kernel, clock, lambda: sketch_stream(
        mats, dim=dim, seed=0, side="right", session=sess, nparts=8,
        bs=32))
    check([o.cache_hit for o in outs] == [False, True, True, True]
          and sess.stats["payload_repacks"] == 3,
          f"sketch stream: hits {[o.cache_hit for o in outs]}, repacks "
          f"{sess.stats['payload_repacks']}")
    st = scipy_csc(outs[0].sketch).T
    dev_max = 0.0
    for i, (m, o) in enumerate(zip(mats, outs)):
        want = port_csc(scipy_csc(m) @ st)
        same_csc(o.sketched, want, f"sketch {i}")
        dev_max = max(dev_max, max_dev(o.sketched, want))
    row["max_abs_dev"] = dev_max
    emit({"phase": "apps", "app": "count_sketch_stream",
          "matrix": f"laplacian_2d({side}) x 4 value sets",
          "a_shape": a.shape, "a_nnz": a.nnz, "dim": dim, "side": "right",
          "out_nnz": [o.sketched.nnz for o in outs], "nparts": 8, "bs": 32,
          **row})
    del sess, clock, outs
    torch.cuda.empty_cache()
    return row["launches"]


MCL_KW = dict(inflation=2.0, prune_threshold=1e-3, max_iter=32, nparts=8,
              bs=32)


def same_mcl(res, want, what):
    """Bitwise the same MCL result: operator (float64), clusters,
    iterations, chaos and bytes."""
    m, w = res.matrix, want.matrix
    check(m.shape == w.shape and np.array_equal(m.indptr, w.indptr)
          and np.array_equal(m.indices, w.indices)
          and m.data.dtype == w.data.dtype
          and m.data.tobytes() == w.data.tobytes(),
          f"{what}: the operator differs")
    check(np.array_equal(res.clusters, want.clusters)
          and res.iterations == want.iterations
          and res.converged == want.converged
          and res.chaos == want.chaos
          and res.comm_bytes == want.comm_bytes, f"{what}: differs")


def mcl_graph(n):
    from repro_torch.core import block_diagonal_noise

    g = block_diagonal_noise(n, n // 64, d_in=8.0, d_out=0.05, seed=7)
    g.data = np.abs(g.data) + 0.5
    return g


def apps_mcl(dev, kernel, n, n_plain):
    """(c) Markov clustering of block_diagonal_noise(n, n / 64, 8, 0.05)
    (|w| + 0.5): on the kernel, and again on the kernel's session (hits,
    bitwise); the same graph family at ``n_plain`` vertices on the kernel
    and on the plain version (clusters and iterations equal, operators
    within rtol 1e-4, atol 1e-6). (e) at ``n_plain`` vertices, the run
    killed by an injected execute fault in its fourth iteration resumes
    from its snapshots on a fresh session, bitwise."""
    import tempfile

    from repro_torch.apps import mcl
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.core.validate import SpGEMMError
    from repro_torch.runtime import FaultInjector, RetryPolicy

    g = mcl_graph(n)
    rows = {}
    sess = SpGEMMSession(device=dev)
    clock = AppClock(sess)
    res, rows["kernel"] = app_run(kernel, clock,
                                  lambda: mcl(g, session=sess, **MCL_KW))
    again, rows["kernel_again"] = app_run(
        kernel, clock, lambda: mcl(g, session=sess, **MCL_KW))
    same_mcl(again, res, "mcl again on its session")
    check(rows["kernel_again"]["hits"] == again.iterations,
          f"mcl again: {rows['kernel_again']['hits']} hits in "
          f"{again.iterations} iterations")
    g_small = mcl_graph(n_plain)
    small_sess = SpGEMMSession(device=dev)
    small_clock = AppClock(small_sess)
    small, rows["kernel_small"] = app_run(
        kernel, small_clock,
        lambda: mcl(g_small, session=small_sess, **MCL_KW))
    first = list(small_clock.calls)
    plain_sess = SpGEMMSession(device=dev)
    pclock = AppClock(plain_sess)
    plain, rows["plain_small"] = app_run(kernel, pclock, lambda: mcl(
        g_small, session=plain_sess, engine="torch", **MCL_KW), plain=True)
    del plain_sess, pclock, small_sess, small_clock
    check(np.array_equal(small.clusters, plain.clusters)
          and small.iterations == plain.iterations,
          f"mcl clusters or iterations differ from the plain run "
          f"({small.iterations} vs {plain.iterations})")
    diff = abs(scipy_csc(small.matrix) - scipy_csc(plain.matrix))
    slack = diff - 1e-4 * abs(scipy_csc(plain.matrix))
    check(not slack.nnz or slack.max() <= 1e-6,
          "mcl operator beyond rtol 1e-4, atol 1e-6 of the plain run")
    dev_max = float(diff.max()) if diff.nnz else 0.0

    # (e) kill the fourth iteration: a cold call fires plan, compile and
    # execute, a hit with new values repack and execute, a plain hit
    # execute alone
    check(small.iterations >= 4, f"mcl ran {small.iterations} iterations")
    arm = sum(1 if c["cache_hit"] and not c["repacked"] else
              2 if c["cache_hit"] else 3 for c in first[:3])
    with tempfile.TemporaryDirectory() as ckpt:
        inj = FaultInjector(rates={"execute": 1.0}, arm_after=arm)
        broken = SpGEMMSession(device=dev, fault_injector=inj,
                               retry_policy=RetryPolicy(max_retries=0))

        def killed():
            try:
                mcl(g_small, session=broken, checkpoint_dir=ckpt, **MCL_KW)
            except SpGEMMError as e:
                return type(e).__name__
            return None

        fault, killed_row = app_run(kernel, AppClock(broken), killed)
        check(fault is not None and inj.total_injected == 1,
              "the injected fault did not surface")
        del broken
        from repro_torch.checkpoint import latest_step
        snap = latest_step(ckpt)
        check(snap == 3, f"mcl snapshot at step {snap}, not 3")
        fresh = SpGEMMSession(device=dev)
        fclock = AppClock(fresh)
        resumed, row = app_run(kernel, fclock, lambda: mcl(
            g_small, session=fresh, checkpoint_dir=ckpt, **MCL_KW))
        same_mcl(resumed, small, "mcl resumed")
        del fresh, fclock
    emit({"phase": "apps", "app": "mcl",
          "matrix": f"block_diagonal_noise({n}, {n // 64}, 8.0, 0.05, "
                    "seed=7), |w| + 0.5", "nnz": g.nnz,
          "iterations": res.iterations, "converged": res.converged,
          "clusters": int(len(np.unique(res.clusters))),
          "final_nnz": res.matrix.nnz, "plain_n": n_plain,
          "plain_iterations": plain.iterations,
          "max_abs_dev_plain": dev_max, **MCL_KW, "runs": rows})
    emit({"phase": "apps", "app": "mcl_resume", "n": n_plain,
          "fault": fault, "arm_after": arm, "resumed_from": snap,
          "runs": {"killed": killed_row, "resumed": row}})
    del sess, clock
    torch.cuda.empty_cache()
    return (rows["kernel"]["launches"] + rows["kernel_again"]["launches"]
            + rows["kernel_small"]["launches"] + killed_row["launches"]
            + row["launches"])


def bc_graph(n, nsources):
    from repro_torch.core import block_diagonal_noise, symmetrize

    a = symmetrize(block_diagonal_noise(n, n // 256, d_in=5.0, d_out=0.3,
                                        seed=2))
    a.data[:] = 1
    sources = np.sort(np.random.default_rng(0).choice(n, nsources,
                                                      replace=False))
    return a, sources


def apps_bc(dev, kernel, n, nsources, n_plain):
    """(d) batched betweenness centrality of symmetrize(
    block_diagonal_noise(n, n / 256, 5, 0.3)), unit weights, from
    ``nsources`` seeded sources at bs 16, on the kernel; the same graph
    family at ``n_plain`` vertices on the kernel and on the plain version
    (depths and call counts equal, scores within rtol 1e-5). (e) at
    ``n_plain`` vertices, the kernel run again with its first backward call
    failing, then resumed from its snapshots: scores bitwise."""
    import tempfile

    from repro_torch.apps import bc_batch, device_spgemm_fn
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.core.validate import DeviceExecError

    a, sources = bc_graph(n, nsources)
    rows = {}
    sess = SpGEMMSession(device=dev)
    clock = AppClock(sess)
    fn = device_spgemm_fn(nparts=8, bs=16, session=sess)
    res, rows["kernel"] = app_run(kernel, clock,
                                  lambda: bc_batch(a, sources, spgemm_fn=fn))
    calls = clock.calls
    fwd, bwd = calls[:res.fwd_spgemm_calls], calls[res.fwd_spgemm_calls:]
    check(all(c["cache_hit"] and c["repacked"] for c in bwd),
          "a backward call missed the forward levels' entries")
    a_small, src_small = bc_graph(n_plain, nsources)
    small_sess = SpGEMMSession(device=dev)
    small_clock = AppClock(small_sess)
    small_fn = device_spgemm_fn(nparts=8, bs=16, session=small_sess)
    small, rows["kernel_small"] = app_run(
        kernel, small_clock,
        lambda: bc_batch(a_small, src_small, spgemm_fn=small_fn))
    plain_sess = SpGEMMSession(device=dev)
    pclock = AppClock(plain_sess)
    plain, rows["plain_small"] = app_run(kernel, pclock, lambda: bc_batch(
        a_small, src_small, spgemm_fn=device_spgemm_fn(
            nparts=8, bs=16, engine="torch", session=plain_sess)),
        plain=True)
    del plain_sess, pclock
    check(small.depths == plain.depths
          and small.fwd_spgemm_calls == plain.fwd_spgemm_calls
          and small.bwd_spgemm_calls == plain.bwd_spgemm_calls,
          "bc depths or call counts differ from the plain run")
    rel = np.abs(small.scores - plain.scores) / np.maximum(
        np.abs(plain.scores), 1e-300)
    check(np.allclose(small.scores, plain.scores, rtol=1e-5, atol=0.0),
          f"bc scores beyond rtol 1e-5 of the plain run: {rel.max()}")

    def failing(at):
        count = {"n": 0}

        def wrapped(x, y, semiring):
            count["n"] += 1
            if count["n"] == at:
                raise DeviceExecError("injected on the first backward call",
                                      stage="execute")
            return small_fn(x, y, semiring)
        return wrapped

    with tempfile.TemporaryDirectory() as ckpt:

        def killed():
            try:
                bc_batch(a_small, src_small,
                         spgemm_fn=failing(small.fwd_spgemm_calls + 1),
                         checkpoint_dir=ckpt)
            except DeviceExecError as e:
                return type(e).__name__
            return None

        fault, killed_row = app_run(kernel, small_clock, killed)
        check(fault is not None, "the injected fault did not surface")
        resumed, row = app_run(kernel, small_clock, lambda: bc_batch(
            a_small, src_small, spgemm_fn=failing(None),
            checkpoint_dir=ckpt))
    check(resumed.scores.tobytes() == small.scores.tobytes()
          and resumed.depths == small.depths
          and resumed.fwd_spgemm_calls == small.fwd_spgemm_calls
          and resumed.bwd_spgemm_calls == small.bwd_spgemm_calls
          and resumed.comm_bytes == small.comm_bytes,
          "bc resumed differs from the uninterrupted run")
    emit({"phase": "apps", "app": "bc_batch",
          "matrix": f"symmetrize(block_diagonal_noise({n}, {n // 256}, 5.0, "
                    "0.3, seed=2)), unit weights", "nnz": a.nnz,
          "sources": nsources, "nparts": 8, "bs": 16, "depths": res.depths,
          "fwd_calls": res.fwd_spgemm_calls,
          "bwd_calls": res.bwd_spgemm_calls,
          "fwd_hits": sum(c["cache_hit"] for c in fwd),
          "bwd_hits": sum(c["cache_hit"] for c in bwd),
          "plain_n": n_plain, "plain_depths": plain.depths,
          "max_rel_dev_plain": float(rel.max()), "runs": rows})
    emit({"phase": "apps", "app": "bc_resume", "n": n_plain, "fault": fault,
          "runs": {"killed": killed_row, "resumed": row}})
    del sess, clock, fn, small_sess, small_clock, small_fn
    torch.cuda.empty_cache()
    return rows["kernel"]["launches"] + rows["kernel_small"]["launches"] \
        + killed_row["launches"] + row["launches"]


def phase_apps(dev, side=512, n_mcl=131072, n_bc=131072, nsources=128,
               n_plain=65536):
    """The paper's applications through their entry points, each on its
    own session at its default bs (every launch on ``warp``): (a) AMG
    Galerkin, (b) a CountSketch stream, (c) Markov clustering, (d) batched
    betweenness centrality, (e) MCL and BC resumed after a fault. MCL's and
    BC's runs on the plain version, the kernel runs they are held against,
    and the killed and resumed runs are at ``n_plain`` vertices (at full
    size the plain runs took 47 s and 81 s, the resumes 49 s and 88 s, of
    the script's 1200 s). The script's 1200 s also hold the Laplacian's
    ``side`` at 512 and MCL's and BC's graphs at 131,072 vertices (at 1024
    and 262,144 the phase took 289-341 s on an H100)."""
    from repro_torch.kernels.bsr_spgemm import kernel

    launches = {}
    t0 = time.perf_counter()
    launches["amg"] = apps_amg(dev, kernel, side)
    launches["sketch"] = apps_sketch(dev, kernel, side)
    launches["mcl"] = apps_mcl(dev, kernel, n_mcl, n_plain)
    launches["bc"] = apps_bc(dev, kernel, n_bc, nsources, n_plain)
    emit({"phase": "apps_done", "seconds": time.perf_counter() - t0,
          "warp_launches": launches})
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the service phase's graph size: banded_clustered(n, n / 40, 6.0), the
# serving CLI's graph, whose band grows with n, so its tiles grow as n^2:
# at 131,072 the phase took 68-85 s on an H100, the CLI ~60 s of it; the
# script's 1200 s hold it at 65,536
SERVICE_N = 65536


def service_oracle(cache, mat):
    """scipy's A·A in float64 for ``mat``, once per value set."""
    from repro_torch.core.session import values_fingerprint

    key = values_fingerprint(mat)
    if key not in cache:
        s = scipy_csc(mat)
        cache[key] = port_csc(s @ s)
    return cache[key]


def service_start(kernel):
    """Counts to 0 just before a service run drives the kernel: launches
    by route and the peak device memory; returns the host clock's start."""
    kernel.reset_launches()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter()


def service_ledger(sess, what):
    """The session's byte ledger after a drain: ``bytes_cached ==
    cached_bytes()`` and equal to the bytes its cached entries hold."""
    held = sum(e.nbytes for e in sess._cache.values())
    check(sess.stats["bytes_cached"] == sess.cached_bytes() == held,
          f"{what}: bytes_cached {sess.stats['bytes_cached']}, entries "
          f"hold {held}")


def service_row(svc, clock, kernel, wall):
    """What one service run printed per run: requests and groups, hits,
    repacks, evictions by tenant, latency percentiles (host clock), the
    session's split (planning, repack, decode, execute by CUDA events), the
    kernel's launches by route and the peak device memory."""
    st = svc.stats()
    rep = clock.report()
    return {"requests": st["requests"], "served": st["served"],
            "failed": st["failed"], "rejected": st["rejected_breaker"],
            "groups": rep["calls"], "hits": rep["hits"],
            "misses": rep["misses"], "repacks": rep["repacks"],
            "coalesced": st["coalesced"],
            "evictions_by_tenant": st["evictions_by_tenant"],
            "latency_p50_s": st["latency_p50_s"],
            "latency_p99_s": st["latency_p99_s"], "wall_s": wall,
            "plan_seconds": rep["plan_seconds"], "repack_s": rep["repack_s"],
            "decode_s": rep["decode_s"], "execute_ms": rep["execute_ms"],
            "launches": kernel.bsr_spgemm.launches,
            "route_launches": dict(kernel.bsr_spgemm.route_launches),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def service_cli(dev, kernel, n, oracle):
    """(a) ``launch.serve_spgemm.main`` on the card at 4 tenants x 4
    requests x 2 waves, bs 32 (``warp``): a prefetch, then per wave one
    group of the shared graph (every tenant's even requests) and one group
    per tenant of its reweighted twin. Every group hits the prefetched
    plan, every twin group repacks, every request rides a coalesced group,
    and every result is bitwise scipy's A·A of its operand."""
    from repro_torch.launch import serve_spgemm

    seen = {"requests": {}, "waves": []}

    class Recording(serve_spgemm.SpGEMMService):
        """The CLI's service, recording each ticket's request and checking
        the session's byte ledger after each drain."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["svc"], seen["clock"] = self, AppClock(self.session)

        def submit(self, req):
            t = super().submit(req)
            seen["requests"][t] = req
            return t

        def run_pending(self):
            done = super().run_pending()
            service_ledger(self.session, f"wave {len(seen['waves'])}")
            seen["waves"].append(done)
            return done

    out = io.StringIO()
    t0 = service_start(kernel)
    with contextlib.redirect_stdout(out), mock.patch.object(
            serve_spgemm, "SpGEMMService", Recording):
        rc = serve_spgemm.main(["--n", str(n), "--tenants", "4",
                                "--requests", "4", "--waves", "2"])
    wall = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    check(rc == 0, f"serve_spgemm exited {rc}: {lines}")
    svc, clock = seen["svc"], seen["clock"]
    waves = seen["waves"]
    row = service_row(svc, clock, kernel, wall)
    check(row["route_launches"]["warp"] == row["launches"] > 0,
          f"service launches off the warp route: {row['route_launches']}")
    check(svc.session.stats["fallbacks"] == 0
          and {c["engine"] for c in clock.calls} == {"cuda"}
          and not any(c["degraded"] for c in clock.calls),
          "a service call left the kernel's rung")
    check(row["misses"] == 1 and row["hits"] == row["groups"] - 1,
          f"the prefetched plan did not serve every group: {row}")
    repacks = 0
    for w, done in enumerate(waves):
        check(len(done) == 4 * 4, f"wave {w}: {len(done)} results")
        groups = {}
        for t, r in done.items():
            req = seen["requests"][t]
            check(r.ok and r.coalesced and r.cache_hit,
                  f"wave {w} ticket {t}: {r}")
            same_csc(r.value, service_oracle(oracle, req.a),
                     f"service wave {w} ticket {t}")
            groups.setdefault(id(r.value), []).append(r)
        check(len(groups) == 5, f"wave {w}: {len(groups)} groups, not 5")
        for k, members in enumerate(groups.values()):
            lead = [r for r in members if r.leader]
            check(len(lead) == 1, f"wave {w}: a group led {len(lead)} times")
            repacked = lead[0].call_stats["repacked"]
            # the shared graph's group comes first: in wave 0 it finds the
            # prefetched values, later it repacks back from the last twin;
            # every twin group repacks
            check(repacked == (k > 0 or w > 0),
                  f"wave {w} group {k}: repacked {repacked}")
            repacks += repacked
    check(repacks == row["repacks"] == 2 * 5 - 1,
          f"repacks {repacks} / {row['repacks']}, not 9")
    row.update(cli_output=lines, prefetched=svc.stats()["prefetched"])
    return svc, row


def service_budgets(dev, kernel, n):
    """(b) tenant ``q``'s quota of 2 over three distinct structures beside
    tenant ``o``'s one entry: only ``q`` is evicted, the survivors hit, and
    ``torch.cuda.memory_allocated``, read just before the session's
    ``_evict`` and just after it, falls by at least the evicted entry's
    bytes; then a ``max_bytes`` that holds one entry: only the newest
    stays. The byte ledger is checked after every drain."""
    from repro_torch.core.session import SpGEMMSession
    from repro_torch.serve import (ServicePolicy, SpGEMMRequest,
                                   SpGEMMService)

    graphs = [service_graph(n, seed=s) for s in (11, 12, 13, 14)]
    freed = []

    def drain(svc, tenant, g):
        r = svc.serve([SpGEMMRequest(tenant=tenant, a=g, b=g)])[0]
        check(r.ok, f"budget request failed: {r.error}")
        service_ledger(svc.session, f"budgets, tenant {tenant}")
        return r

    sess = SpGEMMSession(device=dev, tenant_quota=2)
    evict = sess._evict

    def measured(key):
        """The session's eviction, with the device memory allocated read
        just before it and just after its ``release()``."""
        entry = sess._cache[key]
        freed.append({"owner": entry.owner, "nbytes": entry.nbytes,
                      "allocated": torch.cuda.memory_allocated()})
        del entry
        evict(key)
        freed[-1]["after"] = torch.cuda.memory_allocated()

    sess._evict = measured
    svc = SpGEMMService(session=sess)
    clock = AppClock(sess)
    t0 = service_start(kernel)
    drain(svc, "o", graphs[3])
    for g in graphs[:3]:
        drain(svc, "q", g)
    check(svc.stats()["evictions_by_tenant"] == {"q": 1}
          and sess.cached_entries("q") == 2 and sess.cached_entries("o") == 1,
          f"quota: {svc.stats()['evictions_by_tenant']}")
    ev = freed[0]
    check(ev["allocated"] - ev["after"] >= ev["nbytes"] > 0,
          f"eviction returned {ev['allocated'] - ev['after']} bytes of "
          f"{ev['nbytes']}")
    hits = [drain(svc, t, g).cache_hit
            for t, g in (("q", graphs[2]), ("q", graphs[1]),
                         ("o", graphs[3]))]
    check(all(hits), f"the survivors did not hit: {hits}")
    quota = service_row(svc, clock, kernel, time.perf_counter() - t0)
    quota.update(evicted_bytes=ev["nbytes"],
                 memory_returned_bytes=ev["allocated"] - ev["after"])
    del svc, sess, clock
    gc.collect()

    budget = max(e["nbytes"] for e in freed) + 1
    svc = SpGEMMService(device=dev, policy=ServicePolicy(max_bytes=budget))
    clock = AppClock(svc.session)
    t0 = service_start(kernel)
    for g in graphs:
        drain(svc, "m", g)
        check(svc.session.cached_entries() == 1,
              f"max_bytes kept {svc.session.cached_entries()} entries")
    newest = drain(svc, "m", graphs[-1])
    check(newest.cache_hit, "the newest entry did not stay")
    max_bytes = service_row(svc, clock, kernel, time.perf_counter() - t0)
    max_bytes["max_bytes"] = budget
    check(sum(max_bytes["evictions_by_tenant"].values()) == len(graphs) - 1,
          f"max_bytes evictions {max_bytes['evictions_by_tenant']}")
    return {"quota": quota, "max_bytes": max_bytes}


def service_failures(dev, kernel, n, oracle):
    """(c) tenant ``bad`` asks at bs 48, which the kernel refuses
    (``ValidationError`` at ingress): two failures open its breaker, its
    next request is rejected at admission while ``good0`` and ``good1`` are
    served bitwise; once the injectable clock passes the cooldown, ``bad``
    is served and its breaker closes. No wall-clock sleep."""
    from repro_torch.core.validate import ValidationError
    from repro_torch.serve import (ServicePolicy, SpGEMMRequest,
                                   SpGEMMService, TenantOverloadError)

    now = [0.0]                      # the service's clock, moved by hand
    svc = SpGEMMService(device=dev, clock=lambda: now[0],
                        policy=ServicePolicy(breaker_threshold=2,
                                             breaker_cooldown_s=30.0))
    clock = AppClock(svc.session)
    g = service_graph(n, seed=21)
    t0 = service_start(kernel)
    for _ in range(2):
        r = svc.serve([SpGEMMRequest(tenant="bad", a=g, b=g, bs=48)])[0]
        check(not r.ok and isinstance(r.error, ValidationError),
              f"bs 48 was not refused at ingress: {r.error}")
    check(svc.breaker_state("bad") == "open", "the bad breaker is not open")
    out = svc.serve([SpGEMMRequest(tenant=t, a=g, b=g)
                     for t in ("bad", "good0", "good1")])
    check(out[0].rejected and isinstance(out[0].error, TenantOverloadError)
          and out[0].error.stage == "admit", f"not rejected: {out[0]}")
    for r in out[1:]:
        check(r.ok, f"a good tenant failed: {r.error}")
        same_csc(r.value, service_oracle(oracle, g), "service good tenant")
    check(svc.breaker_state("good0") == svc.breaker_state("good1")
          == "closed", "a good tenant's breaker moved")
    now[0] += 30.0
    check(svc.breaker_state("bad") == "half_open", "no half-open")
    r = svc.serve([SpGEMMRequest(tenant="bad", a=g, b=g)])[0]
    check(r.ok and svc.breaker_state("bad") == "closed",
          "bad did not recover")
    service_ledger(svc.session, "failures")
    same_csc(r.value, service_oracle(oracle, g), "service recovered tenant")
    return service_row(svc, clock, kernel, time.perf_counter() - t0)


def service_tc(svc, kernel, oracle, mat):
    """(d) one tenant's 2D SUMMA request (grid 2, bs 128) on the CLI's
    graph through the CLI's service: every launch on ``tc``, bitwise."""
    from repro_torch.serve import SpGEMMRequest

    clock = AppClock(svc.session)
    t0 = service_start(kernel)
    r = svc.serve([SpGEMMRequest(tenant="tenant0", a=mat, b=mat,
                                 algorithm="2d", grid=2, bs=128)])[0]
    wall = time.perf_counter() - t0
    check(r.ok and r.call_stats["algorithm"] == "2d"
          and not r.call_stats["degraded"], f"2d request: {r}")
    service_ledger(svc.session, "2d group")
    same_csc(r.value, service_oracle(oracle, mat), "service 2d tc")
    row = service_row(svc, clock, kernel, wall)
    check(row["route_launches"]["tc"] == row["launches"] > 0,
          f"2d launches off the tc route: {row['route_launches']}")
    return row


def service_graph(n, seed=0):
    """The serving CLI's graph: banded_clustered(n, n / 40, 6.0) with
    integer values (2 x the normal draw, rounded; 0 -> 1), float32."""
    from repro_torch.core.sparse import banded_clustered

    g = banded_clustered(n, max(n // 40, 8), 6.0, seed=seed)
    g.data[:] = np.rint(2 * g.data)
    g.data[g.data == 0] = 1.0
    return g.astype(np.float32)


def phase_service(dev, n=SERVICE_N, budget_n=16384):
    """The multi-tenant SpGEMM service on the card: (a) the serving CLI,
    (b) budgets, (c) failure routing, (d) one ``tc`` group."""
    from repro_torch.kernels.bsr_spgemm import kernel

    t0 = time.perf_counter()
    oracle = {}
    svc, cli = service_cli(dev, kernel, n, oracle)
    emit({"phase": "service", "part": "cli", "n": n, "tenants": 4,
          "requests_per_tenant_per_wave": 4, "waves": 2, "bs": 32, **cli})
    tc = service_tc(svc, kernel, oracle, service_graph(n))
    emit({"phase": "service", "part": "tc_group", "n": n, "algorithm": "2d",
          "grid": 2, "bs": 128, **tc})
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    budgets = service_budgets(dev, kernel, budget_n)
    emit({"phase": "service", "part": "budgets", "n": budget_n, **budgets})
    failures = service_failures(dev, kernel, budget_n, oracle)
    emit({"phase": "service", "part": "failures", "n": budget_n,
          **failures})
    seconds = time.perf_counter() - t0
    launches = {"cli": cli["launches"], "tc_group": tc["launches"],
                "budgets": budgets["quota"]["launches"]
                + budgets["max_bytes"]["launches"],
                "failures": failures["launches"]}
    emit({"phase": "service_done", "seconds": seconds,
          "launches": launches})
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def timing_entry(ms, plain_ms, library_ms, flop, moved, dtype, err,
                 tf32_passes=0):
    """A kernel's timing beside its bound: max(flop / peak, bytes / HBM),
    with the bf16 tensor-core peak for bf16 work and the fp32 peak else;
    for float32 work done as ``tf32_passes`` TF32 passes, that many times
    the flop at the TF32 tensor-core peak, with the fp32 bound beside it
    (``fp32_bound_ms``)."""
    variant, (fp32, hbm, bf16, tf32) = peaks(torch.cuda.get_device_name(0))
    peak = bf16 if dtype == torch.bfloat16 else fp32
    t_bytes = moved / hbm * 1e3
    extra = {}
    if tf32_passes:
        extra = {"tf32_passes": tf32_passes,
                 "fp32_bound_ms": max(flop / fp32 * 1e3, t_bytes)}
        peak, flop_done = tf32, flop * tf32_passes
    else:
        flop_done = flop
    t_ops = flop_done / peak * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": moved, "max_abs_err": err,
            "tflops": flop / ms / 1e9, "peak_variant": variant,
            "peak_flops": peak, "hbm_bytes_per_s": hbm, **extra}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def phase_build_lm(infos):
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg

    for mod, sources in ((fa, fa.SOURCES), (mg, mg.SOURCES)):
        mod.build()
        for src in sources:
            info = infos[src]
            extra = {}
            if src == fa.TC_SOURCE:   # dynamic shared memory, per launch
                extra["dynamic_smem_bytes"] = {
                    f"d_pad{d}": fa.tc_smem_bytes(d)
                    for d in (64, 128, 192, 256)}
            if src == fa.TF32_SOURCE:
                per_dp = {}
                for d in range(8, fa.MAX_D + 1, 8):
                    got = fa.fp32_kernel_config(d)
                    want = fa.fp32_config(d)
                    check(all(got[k] == want[k] for k in want),
                          f"the fp32 kernel blocks head dim {d} as {got}, "
                          f"the host expects {want}")
                    per_dp[f"d_pad{got['dp']}"] = got
                extra["blocking"] = per_dp
                extra["dynamic_smem_bytes"] = {
                    k: v["smem_bytes"] for k, v in per_dp.items()}
            if src == mg.TC_SOURCE:
                extra["dynamic_smem_bytes"] = {
                    "prefill": mg.tc_smem_bytes("prefill", 2048),
                    **{f"decode_d{d}": mg.tc_smem_bytes("decode", d)
                       for d in (2048, 1408)}}
            if src == mg.TF32_SOURCE:
                got, want = mg.fp32_kernel_config(), mg.fp32_config()
                check(got == want, f"the moe_gemm fp32 kernel blocks as "
                      f"{got}, the host expects {want}")
                extra["blocking"] = got
                extra["dynamic_smem_bytes"] = {"fp32": got["smem_bytes"]}
            emit({"phase": "build_lm", "kernel": src.stem,
                  "seconds": info["seconds"], "built": info["built"],
                  "library": info["path"], "ptxas": ptxas_lines(info["log"]),
                  **extra})


def phase_serve_smoke(arch="qwen2-moe-a2.7b"):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke`` on the
    card (its ``--device`` default): the float32 smoke config at head dim
    16 through both LM kernels' float32 routes, in a process of its own.
    It must exit 0."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    check(proc.returncode == 0, f"launch.serve --smoke exited "
          f"{proc.returncode}: {lines[-20:]}")
    emit({"phase": "serve_smoke", "arch": arch, "seconds":
          time.perf_counter() - t0, "returncode": proc.returncode,
          "output": lines[:2]})


def within(got, want, atol, rtol):
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.all((got.float() - want.float()).abs()
                        <= atol + rtol * want.float().abs()))
    return ok, err


TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
MOE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


FLASH_GRID = {torch.bfloat16: ((16, 64, 96, 128, 160, 256),
                                (77, 128, 129, 1000, 2048)),
              torch.float32: ((16, 64, 96, 128, 160, 192, 256),
                              (77, 128, 1000))}


def phase_flash_grid(dev):
    """Both attention routes against their plain version on the card."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            route)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    g = torch.Generator(device=dev).manual_seed(0)
    cases = {"float32": 0, "bfloat16": 0}
    errs = {"float32": 0.0, "bfloat16": 0.0}
    by_route = {}
    for dtype, (dims, lens) in FLASH_GRID.items():
        key = str(dtype).split(".")[-1]
        for d in dims:
            for s in lens:
                for hkv in (8, 2):
                    q = torch.randn(2, s, 8, d, generator=g, device=dev)
                    k = torch.randn(2, s, hkv, d, generator=g, device=dev)
                    v = torch.randn(2, s, hkv, d, generator=g, device=dev)
                    q, k, v = (t.to(dtype) for t in (q, k, v))
                    for window in (0, 64):
                        for cap in (0.0, 50.0):
                            kw = dict(scale=d ** -0.5, causal=True,
                                      window=window, softcap=cap)
                            label = (f"{dtype} D={d} S={s} Hkv={hkv} "
                                     f"window={window} softcap={cap}")
                            got = flash_attention(q, k, v, **kw)
                            want = mha_ref(q, k, v, **kw)
                            torch.cuda.synchronize()
                            ok, err = within(got, want, *TOL[dtype])
                            check(ok, f"flash_attention != plain version: "
                                      f"{label} (max abs err {err})")
                            check(bitwise(flash_attention(q, k, v, **kw),
                                          got),
                                  f"a repeated launch differs: {label}")
                            name = route(dtype, d)
                            by_route[name] = by_route.get(name, 0) + 1
                            errs[key] = max(errs[key], err)
                            cases[key] += 1
    cases["float32_overflow"] = f32_overflow(
        "flash_attention", flash_overflow_cases(dev))
    emit({"phase": "flash_attention_vs_plain", "cases": cases,
          "cases_by_route": by_route, "max_abs_err": errs,
          "tolerance": {"float32": TOL[torch.float32],
                        "bfloat16": TOL[torch.bfloat16],
                        "repeat": "bitwise"},
          "grid": {str(k).split(".")[-1]: {"D": v[0], "S": v[1]}
                   for k, v in FLASH_GRID.items()}})
    return errs


TILE_EDGES = (63, 64, 65, 127, 128, 129)


def moe_rows_cases(g, e, cap, dev):
    """``rows`` for one (E, cap): all cap, all 0, random in [0, cap + 8]
    (values past cap are clamped), and the 128-row tile edges (each alone at
    E = 1, cycled over the experts at E = 64)."""
    cases = [("all_cap", torch.full((e,), cap)),
             ("all_zero", torch.zeros(e)),
             ("random", torch.randint(0, cap + 9, (e,), generator=g,
                                      device=dev))]
    if e == 1:
        cases += [(f"edge_{v}", torch.full((1,), v)) for v in TILE_EDGES]
    else:
        cases.append(("edges", torch.tensor(TILE_EDGES).repeat(
            -(-e // len(TILE_EDGES)))[:e]))
    return [(name, r.to(device=dev, dtype=torch.int32)) for name, r in cases]


def phase_moe_grid(dev):
    """Every route of the grouped GEMM against its plain version."""
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm, route
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    g = torch.Generator(device=dev).manual_seed(1)
    cases, nonfinite, errs = 0, 0, {"float32": 0.0, "bfloat16": 0.0}
    by_route = {}

    def held(x, w, rows, what, exact=False):
        nonlocal cases, nonfinite
        got, want = moe_gemm(x, w, rows), moe_gemm_ref(x, w, rows)
        torch.cuda.synchronize()
        name = route(x.dtype, x.shape[1])
        label = (f"{name} route {x.dtype} E={x.shape[0]} cap={x.shape[1]} "
                 f"d={x.shape[2]} f={w.shape[2]} rows={what}")
        fin = torch.isfinite(want)
        if exact:
            check(bitwise(got, want), f"moe_gemm != plain version on "
                  f"integers: {label}")
        else:
            if not bool(fin.all()):       # planted inf / NaN
                check(all(torch.equal(a(got), a(want)) for a in (
                    torch.isnan, torch.isposinf, torch.isneginf)),
                    f"moe_gemm's inf / NaN pattern != the plain version's: "
                    f"{label}")
                nonfinite += 1
            ok, err = within(got[fin], want[fin], *MOE_TOL[x.dtype])
            check(ok, f"moe_gemm != plain version: {label} (max abs err "
                      f"{err})")
            key = str(x.dtype).split(".")[-1]
            errs[key] = max(errs[key], err)
        check(bitwise_or_nan(moe_gemm(x, w, rows), got),
              f"a repeated launch differs: {label}")
        by_route[name] = by_route.get(name, 0) + 1
        cases += 1

    for e in (1, 64):
        for cap in (8, 16, 96, 688):
            for d, f in ((2048, 1408), (1408, 2048), (640, 72), (200, 72)):
                x = torch.randn(e, cap, d, generator=g, device=dev)
                w = torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5
                xi = torch.randint(-4, 5, (e, cap, d), generator=g,
                                   device=dev).float()
                wi = torch.randint(-4, 5, (e, d, f), generator=g,
                                   device=dev).float()
                rand = torch.randint(0, cap + 9, (e,), generator=g,
                                     device=dev).int()
                for rows, what in ((None, "None"), (rand, "random")):
                    held(xi, wi, rows, what, exact=True)
                    held(x, w, rows, what)
                del xi, wi
                # inf, NaN and a value whose TF32 hi rounds to inf
                xp, wp = x.clone(), w.clone()
                xp[:, 0, 3] = float("inf")
                xp[:, min(2, cap - 1), d - 1] = float("nan")
                xp[:, min(1, cap - 1), 0] = 3.0e38
                wp[:, 5, 1] = float("-inf")
                wp[:, d // 2, f - 1] = float("nan")
                for rows, what in ((None, "None"), (rand, "random")):
                    held(xp, wp, rows, f"{what} planted inf/NaN")
                del xp, wp
                xb, wb = x.bfloat16(), w.bfloat16()
                held(xb, wb, None, "None")
                for what, rows in moe_rows_cases(g, e, cap, dev):
                    held(xb, wb, rows, what)
    overflow = f32_overflow("moe_gemm", moe_overflow_cases(dev))
    emit({"phase": "moe_gemm_vs_plain", "cases": cases,
          "float32_overflow_cases": overflow,
          "cases_by_route": by_route, "planted_nonfinite_cases": nonfinite,
          "max_abs_err": errs,
          "tolerance": {"float32": MOE_TOL[torch.float32],
                        "bfloat16": MOE_TOL[torch.bfloat16],
                        "integer_float32": "bitwise",
                        "planted_inf_nan": "the plain version's pattern",
                        "repeat": "bitwise"}})
    return errs


def f32_overflow(kind, cases):
    """Runs ``cases`` (label, kernel, plain, where) of one float32 route at
    C3's overflow magnitudes and holds each kernel output against the plain
    version on the card: the same NaN / +inf / -inf pattern, the finite
    elements within the float32 tolerance. Emits every case's reading (the
    planted element's plain and kernel values, which pattern matched) on a
    line of its own before it checks, so a failing run still reports what
    the kernel gave."""
    readings, failed = [], []
    for label, kernel, plain, where in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        same = all(torch.equal(a(got), a(want)) for a in (
            torch.isnan, torch.isposinf, torch.isneginf))
        fin = torch.isfinite(want) & torch.isfinite(got)
        ok, err = within(got[fin], want[fin], *TOL[torch.float32])
        readings.append({"case": label, "plain": repr(float(want[where])),
                         "kernel": repr(float(got[where])),
                         "nonfinite_pattern_equal": same,
                         "finite_max_abs_err": err,
                         "bitwise": bitwise_or_nan(got, want)})
        if not (same and ok):
            failed.append(label)
    emit({"phase": f"{kind}_overflow", "cases": len(readings),
          "failed": failed, "tolerance": {
              "nonfinite": "the plain version's NaN / +inf / -inf pattern",
              "finite": TOL[torch.float32]}, "readings": readings})
    check(not failed, f"{kind} float32 at overflow magnitudes != the plain "
          f"version: {failed}")
    return len(readings)


def moe_overflow_cases(dev, caps=(8, 96, 200), d=256, f=256):
    """``OVERFLOW_PAIRS`` planted in float32 moe_gemm, one expert a pair:
    x[t] holds small nonzero integers at (r, (r + o) % d) and w[t] on its
    diagonal, so every output element has one nonzero term; pair t sits at
    x[t, r, k], w[t, k, k] with k = (r + o) % d, o = 37 t + 5 (another
    k-panel and column tile from pair to pair), r = (13 t + 3) % cap. Then
    one expert more whose y[r, k] is x x - x x for x = nextafter(2**64, 0):
    -x at x[r, k ^ 1] (the same k-panel, another TF32 k-step) and x at
    w[k ^ 1, k]; the plain version gives 0, a split whose hi.hi terms sum
    to 2**128 between k-steps does not. caps 8 (a decode step's) and 96 and
    200 (a prefill's: one tile of more than 64 rows, and two tiles)."""
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    rng = np.random.default_rng(7)
    n = len(OVERFLOW_PAIRS)
    cases = []
    for cap in caps:
        x = np.zeros((n + 1, cap, d), np.float32)
        w = np.zeros((n + 1, d, f), np.float32)
        small = [-3, -2, -1, 1, 2, 3]
        rows = np.arange(cap)
        for t, (a, b) in enumerate(OVERFLOW_PAIRS + [(_X, _X)]):
            o = 37 * t + 5
            x[t, rows, (rows + o) % d] = rng.choice(small, size=cap)
            w[t, np.arange(d), np.arange(d)] = rng.choice(small, size=d)
            r = (13 * t + 3) % cap
            k = (r + o) % d
            x[t, r, k], w[t, k, k] = a, b
            label = f"pair={t} ({a!r} x {b!r})"
            if t == n:
                x[t, r, k ^ 1], w[t, k ^ 1, k] = -a, b
                label = f"cancel ({a!r} x {b!r} - {a!r} x {b!r})"
            xt, wt = (torch.from_numpy(v).to(dev) for v in (x, w))
            cases.append((f"cap={cap} {label}",
                          lambda xt=xt, wt=wt: moe_gemm(xt, wt),
                          lambda xt=xt, wt=wt: moe_gemm_ref(xt, wt),
                          (t, r, k)))
    return cases


def flash_overflow_cases(dev, dims=(16, 128), s=256):
    """``OVERFLOW_PAIRS`` planted in float32 attention: q (1, S, 2, D) and
    k, v (1, S, 1, D) seeded normals x 0.5; pair t's first value is the one
    nonzero of q row r = 250 - 9 t (head 0), its second the one nonzero of
    key c = 10 + 13 t (c <= r), both in coordinate j = (5 t + 3) % D, so
    the logit (r, c) has one nonzero term; then a case more whose logit (r,
    c) is x x - x x for x = nextafter(2**64, 0) (-x at q[r, j ^ 8], another
    TF32 k-step, and x at k[c, j ^ 8]): 0 in the plain version. Causal and
    not, scale D^-0.5. The element read out is output row r's first
    column."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import mha_ref

    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for d in dims:
        for t, (a, b) in enumerate(OVERFLOW_PAIRS + [(_X, _X)]):
            q = torch.randn(1, s, 2, d, generator=g, device=dev) * 0.5
            k = torch.randn(1, s, 1, d, generator=g, device=dev) * 0.5
            v = torch.randn(1, s, 1, d, generator=g, device=dev)
            r, c, j = 250 - 9 * t, 10 + 13 * t, (5 * t + 3) % d
            q[0, r, 0], k[0, c, 0] = 0.0, 0.0
            q[0, r, 0, j], k[0, c, 0, j] = a, b
            label = f"pair={t} ({a!r} x {b!r})"
            if t == len(OVERFLOW_PAIRS):
                q[0, r, 0, j ^ 8], k[0, c, 0, j ^ 8] = -a, b
                label = f"cancel ({a!r} x {b!r} - {a!r} x {b!r})"
            for causal in (True, False):
                kw = dict(scale=d ** -0.5, causal=causal)
                cases.append((f"D={d} causal={causal} {label}",
                              lambda q=q, k=k, v=v, kw=kw:
                              flash_attention(q, k, v, **kw),
                              lambda q=q, k=k, v=v, kw=kw:
                              mha_ref(q, k, v, **kw),
                              (0, r, 0, 0)))
    return cases


class Capture:
    """Wraps the model's op references (``models.attention.
    multihead_attention``, ``models.moe.grouped_gemm``) and the engine's
    ``prefill_step`` / ``decode_step``: records the inputs of the first
    layer's attention call and of its three grouped GEMMs (``rows``
    included) in prefill and in the first decode step (under phase None
    outside the engine), CUDA events around every step, and whether any
    logit was not finite. Adds no kernel launch."""

    def __init__(self):
        import repro_torch.models.attention as attn_mod
        import repro_torch.models.moe as moe_mod
        import repro_torch.serve.engine as engine_mod

        self.mods = (attn_mod, moe_mod, engine_mod)
        self.orig = (attn_mod.multihead_attention, moe_mod.grouped_gemm,
                     engine_mod.prefill_step, engine_mod.decode_step)
        self.attn, self.gemm = {}, {}
        self.events = {"prefill": [], "decode": []}
        self.phase = None
        self.bad = None
        self.capturing = True

    def __enter__(self):
        attn_mod, moe_mod, engine_mod = self.mods
        mha, gemm, prefill, decode = self.orig

        def attn(q, k, v, *args):
            if self.capturing and self.phase not in self.attn:
                self.attn[self.phase] = (q.clone(), k.clone(), v.clone(),
                                         args)
            return mha(q, k, v, *args)

        def grouped(x, w, rows=None):
            calls = self.gemm.setdefault(self.phase, [])
            if self.capturing and len(calls) < 3:
                calls.append((x.clone(), w,
                              None if rows is None else rows.clone()))
            return gemm(x, w, rows)

        def step(fn, phase):
            def run(params, cfg, batch, caches):
                self.phase = phase
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                logits, caches = fn(params, cfg, batch, caches)
                t1.record()
                self.events[phase].append((t0, t1))
                bad = ~torch.isfinite(logits).all()
                self.bad = bad if self.bad is None else self.bad | bad
                if phase == "decode":
                    self.capturing = False
                return logits, caches
            return run

        attn_mod.multihead_attention = attn
        moe_mod.grouped_gemm = grouped
        engine_mod.prefill_step = step(prefill, "prefill")
        engine_mod.decode_step = step(decode, "decode")
        return self

    def __exit__(self, *exc):
        attn_mod, moe_mod, engine_mod = self.mods
        (attn_mod.multihead_attention, moe_mod.grouped_gemm,
         engine_mod.prefill_step, engine_mod.decode_step) = self.orig
        return False

    def step_ms(self, phase):
        return [t0.elapsed_time(t1) for t0, t1 in self.events[phase]]


def time_flash(dev, captured):
    """The route's kernel, the plain version and SDPA on the captured
    prefill attention, as CUDA events around back-to-back launches; also
    the earlier CUDA-core kernel on the same inputs (``previous_ms``) and
    the host time of one wrapper call (argument checks, output allocation,
    three tensor-map encodes, launch) and of the C launch function alone.
    The float32 route's bound counts its three TF32 passes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        _launch, _launch_cuda_core, flash_attention, route)
    from repro_torch.kernels.flash_attention.ref import mha_ref

    q, k, v, (scale, causal, window, softcap) = captured
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    got, want = flash_attention(q, k, v, **kw), mha_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    ok, err = within(got, want, *TOL[q.dtype])
    check(ok, f"prefill attention kernel != plain version in {q.dtype} "
              f"({err})")
    del got, want
    name = route(q.dtype, q.shape[3])
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 10)
    plain_ms = cuda_ms(lambda: mha_ref(q, k, v, **kw), 3)
    library_ms = None
    if window == 0 and softcap == 0.0 and q.shape[2] == k.shape[2]:
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, scale=scale), 10)
        del qh, kh, vh
    extra = {"previous_ms": cuda_ms(
        lambda: _launch_cuda_core(q, k, v, **kw), 3)}
    extra["host_us_per_call"] = host_call_us(
        lambda: flash_attention(q, k, v, **kw))
    out = torch.empty_like(q)
    extra["launch_us_per_call"] = host_call_us(
        lambda: _launch(name, q, k, v, out, scale, causal, window, softcap))
    del out
    b, s, hq, d = q.shape
    rows = torch.arange(s, device=dev)
    lo = (rows - window + 1).clamp(min=0) if window > 0 else 0 * rows
    pairs = b * int((rows - lo + 1).sum())         # unmasked (row, key)
    flop = 4 * d * hq * pairs                      # q.k and p.v
    entry = timing_entry(ms, plain_ms, library_ms, flop,
                         nbytes(q, k, v) + nbytes(q), q.dtype, err,
                         tf32_passes=3 if name == "fp32" else 0)
    return {"shape": {"q": list(q.shape), "k": list(k.shape),
                      "dtype": str(q.dtype), "route": name, "window": window,
                      "softcap": softcap}, **entry, **extra}


def host_call_us(fn, n=50):
    """Host microseconds per call of ``fn`` over ``n`` calls (the enqueue;
    the device runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def time_moe(x, w, rows):
    """The route's kernel, the plain version, ``torch.bmm`` and the earlier
    CUDA-core kernel (every slot of every expert, as before ``rows``) on
    one captured GEMM, each as device time per call; the kernel also as
    CUDA events around back-to-back launches (``events_ms``, which the
    host's enqueue rate bounds from below); the host time of one wrapper
    call (argument checks, output allocation, tensor maps, launch) and of
    the C launch function alone (tensor maps and launch). The ``fp32``
    route's bound counts its three TF32 passes at the tensor-core peak,
    with the fp32 CUDA-core bound beside it."""
    from repro_torch.kernels.moe_gemm.kernel import (_launch,
                                                     _launch_cuda_core,
                                                     moe_gemm, route)
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    got, want = moe_gemm(x, w, rows), moe_gemm_ref(x, w, rows)
    torch.cuda.synchronize()
    ok, err = within(got, want, *MOE_TOL[x.dtype])
    check(ok, f"grouped GEMM kernel != plain version at {tuple(x.shape)} x "
              f"{tuple(w.shape)} ({err})")
    check(bitwise(moe_gemm(x, w, rows), got), "a repeated launch differs at "
          f"{tuple(x.shape)} x {tuple(w.shape)}")
    e, cap, d = x.shape
    f = w.shape[2]
    live = rows.clamp(0, cap)
    slots, experts = int(live.sum()), int((live > 0).sum())
    del got, want
    reps = 20 if cap <= 16 else 10
    ms = device_ms(lambda: moe_gemm(x, w, rows), reps)
    previous_ms = device_ms(lambda: _launch_cuda_core(x, w), reps // 2)
    plain_ms = device_ms(lambda: moe_gemm_ref(x, w, rows), 3)
    library_ms = device_ms(lambda: torch.bmm(x, w), reps)
    events_ms = cuda_ms(lambda: moe_gemm(x, w, rows), reps)
    host_us = host_call_us(lambda: moe_gemm(x, w, rows))
    out = torch.empty_like(moe_gemm(x, w, rows))
    launch_us = host_call_us(
        lambda: _launch(route(x.dtype, cap), x, w, rows, out))
    el = x.element_size()
    passes = 3 if route(x.dtype, cap) == "fp32" else 0
    # what this run's data needs: the products of live rows, those x rows,
    # the weights of experts with a live row, y written whole
    entry = timing_entry(ms, plain_ms, library_ms, 2 * slots * d * f,
                         slots * d * el + experts * d * f * el
                         + e * cap * f * el, x.dtype, err, passes)
    dense = timing_entry(ms, plain_ms, library_ms, 2 * e * cap * d * f,
                         nbytes(x, w) + e * cap * f * el, x.dtype, err,
                         passes)
    return {"shape": {"x": list(x.shape), "w": list(w.shape),
                      "dtype": str(x.dtype), "route": route(x.dtype, cap),
                      "live_rows": slots, "experts_with_rows": experts},
            **entry, "previous_ms": previous_ms, "events_ms": events_ms,
            "host_us_per_call": host_us,
            "launch_us_per_call": launch_us,
            "dense_bound_ms": dense["bound_ms"],
            "dense_bound_by": dense["bound_by"], "dense_flop": dense["flop"]}


@contextlib.contextmanager
def plain_ops():
    """Point the model's op references at the plain versions (the
    comparison's other side; the package itself has no such switch)."""
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    orig = attn_mod.multihead_attention, moe_mod.grouped_gemm
    attn_mod.multihead_attention = (
        lambda q, k, v, scale, causal, window, softcap: mha_ref(
            q, k, v, scale=scale, causal=causal, window=window,
            softcap=softcap))
    moe_mod.grouped_gemm = moe_gemm_ref
    try:
        yield
    finally:
        attn_mod.multihead_attention, moe_mod.grouped_gemm = orig


# the kernels' bf16 prefill against the plain versions', relative to the
# largest logit: each op agrees within ``TOL`` / ``MOE_TOL``, and the
# differences grow through the layers; the card read 6.6 % at
# qwen2-moe-a2.7b's 24 layers and 1.3 % at jamba's one period
PLAIN_PREFILL_REL = 0.15


def plain_prefill_check(params, cfg, dev, prompts):
    """Prefill of the prompts' last n tokens (n the shortest prompt's
    length) through the kernels and through the plain versions (the model's
    op references pointed at them); the two sets of last-position logits
    must agree within ``PLAIN_PREFILL_REL`` of the largest."""
    from repro_torch.models import init_caches, prefill_step

    n = min(len(p) for p in prompts)
    toks = torch.from_numpy(np.stack([p[-n:] for p in prompts])
                            .astype(np.int64)).to(dev)
    b = toks.shape[0]
    logits_k, _ = prefill_step(params, cfg, {"tokens": toks},
                               init_caches(cfg, b, n, device=dev))
    with plain_ops():
        logits_p, _ = prefill_step(params, cfg, {"tokens": toks},
                                   init_caches(cfg, b, n, device=dev))
    diff = float((logits_k - logits_p).abs().max())
    scale = float(logits_p.abs().max())
    same_top1 = int((logits_k.argmax(-1) == logits_p.argmax(-1)).sum())
    check(bool(torch.isfinite(logits_k).all()), f"{cfg.name}: the "
          "kernels' prefill logits are not finite")
    check(diff <= PLAIN_PREFILL_REL * scale, f"{cfg.name}: the kernels' "
          f"prefill is {diff} off the plain versions' (largest logit "
          f"{scale}, bound {PLAIN_PREFILL_REL} of it)")
    return {"tokens": list(toks.shape), "max_abs_logit_diff": diff,
            "max_abs_logit": scale, "rel": diff / scale,
            "bound_rel": PLAIN_PREFILL_REL, "top1_agree": same_top1,
            "rows": b}


def profile_generate(engine, prompts):
    """Device time by kernel over a generate of 1 token (prefill only) and
    of 5 tokens (prefill + 4 decode steps), from ``torch.profiler``; the
    decode steps' share is the difference. Also the host side of those 4
    decode steps: self CPU time by op (aten ops and the CUDA runtime calls),
    profiler overhead included."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(max_new):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.generate(prompts, max_new_tokens=max_new, sync_every=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out, host = {}, {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                out[ev.key] = (ev.count, ev.self_device_time_total / 1e3)
            else:
                host[ev.key] = (ev.count, ev.self_cpu_time_total / 1e3)
        return out, host, wall * 1e3

    def kind(name):
        low = name.lower()
        if "flash_fwd" in name:
            return "flash_attention"
        if "moe_gemm" in name:
            return "moe_gemm"
        if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            return "library_gemm"
        if "memcpy" in low or "memset" in low:
            return "memcpy"
        return "other"

    pre, pre_host, pre_wall = kernels(1)
    full, full_host, full_wall = kernels(5)
    res = {}
    for label, table, wall in (("prefill", pre, pre_wall),
                               ("prefill_plus_4_decode", full, full_wall)):
        by_kind = {}
        for name, (n, ms) in table.items():
            k = by_kind.setdefault(kind(name), [0, 0.0])
            k[0] += n
            k[1] += ms
        busy = sum(ms for _, ms in table.values())
        top = sorted(table.items(), key=lambda kv: -kv[1][1])[:12]
        res[label] = {"wall_ms": wall, "device_busy_ms": busy,
                      "idle_share": 1 - busy / wall if wall else None,
                      "by_kind": {k: {"launches": v[0], "ms": v[1]}
                                  for k, v in by_kind.items()},
                      "top": [{"kernel": n[:90], "launches": c, "ms": ms}
                              for n, (c, ms) in top]}
    decode_host = {k: (c - pre_host.get(k, (0, 0.0))[0],
                       ms - pre_host.get(k, (0, 0.0))[1])
                   for k, (c, ms) in full_host.items()}
    top = sorted(decode_host.items(), key=lambda kv: -kv[1][1])[:15]
    res["host"] = {
        "prefill_self_cpu_ms": sum(ms for _, ms in pre_host.values()),
        "prefill_plus_4_decode_self_cpu_ms": sum(
            ms for _, ms in full_host.values()),
        "decode_4_steps_top": [{"op": n[:60], "calls": c, "ms": ms}
                               for n, (c, ms) in top]}
    return res


def f32_plain_check(dev, arch, layers=2, n=256):
    """The model at full width, cut to ``layers`` layers, in float32: a
    prefill of 4 x n tokens and one decode step through the kernels and
    through the plain versions; the logits must agree within 1e-3 of their
    largest magnitude (float32 kernels agree with the plain versions to
    ~1e-6 per op). The kernels' run is the float32 routes' path: their
    launch counts, from 0 just before it, and the prefill's up and down
    grouped GEMMs and the decode step's up GEMM, timed; the decode GEMM
    also on the CUDA-core kernel with its ``rows`` (``cuda_core_rows_ms``),
    beside which the ``fp32`` route needs no decode kernel of its own."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg
    from repro_torch.models import (decode_step, init_caches, init_params,
                                    prefill_step)

    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (4, n + 1), generator=g, device=dev)

    def run(cap=None):
        caches = init_caches(cfg, 4, n + 1, device=dev)
        if cap:
            cap.phase = "prefill"
        lp, caches = prefill_step(params, cfg, {"tokens": toks[:, :n]},
                                  caches)
        if cap:
            cap.phase = "decode"
        ld, _ = decode_step(params, cfg, {"tokens": toks[:, n:]}, caches)
        return lp, ld

    mg.reset_launches()
    fa.reset_launches()
    with Capture() as cap:
        kern = run(cap)
    routes = dict(mg.moe_gemm.route_launches)
    attn_routes = dict(fa.flash_attention.route_launches)
    n_moe = sum(1 for k in cfg.pattern if k in "AM") * cfg.n_periods
    n_attn = sum(1 for k in cfg.pattern if k in "aAl") * cfg.n_periods
    want = {"prefill": 0, "decode": 0, "fp32": 6 * n_moe}
    check(routes == want, f"float32 route launches {routes}, expected "
          f"{want}")
    check(attn_routes == {"tc": 0, "fp32": n_attn},
          f"float32 attention route launches {attn_routes}, expected "
          f"{n_attn} on fp32 (one prefill)")
    with plain_ops():
        plain = run()
    out = {"dtype": "float32", "layers": layers, "tokens": [4, n],
           "route_launches": routes,
           "flash_attention_route_launches": attn_routes}
    for name, a, b in (("prefill", kern[0], plain[0]),
                       ("decode", kern[1], plain[1])):
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        check(bool(torch.isfinite(a).all()), f"{name} logits not finite")
        check(diff <= 1e-3 * scale, f"float32 {name} logits: kernels vs "
              f"plain versions differ by {diff} (max |logit| {scale})")
        out[name] = {"max_abs_logit_diff": diff, "max_abs_logit": scale,
                     "top1_agree": int((a.argmax(-1) == b.argmax(-1)).sum())}
    out["moe_gemm_fp32"] = [
        {"phase": phase, "projection": name,
         **time_moe(*cap.gemm[phase][i])}
        for phase, i, name in (("prefill", 0, "up"), ("prefill", 2, "down"),
                               ("decode", 0, "up"))]
    x, w, rows = cap.gemm["decode"][0]
    out["moe_gemm_fp32"][2]["cuda_core_rows_ms"] = device_ms(
        lambda: mg._launch_cuda_core(x, w, rows), 20)
    return out


LM_LENS = (2048, 1536, 1024, 512)


def serve_model(dev, arch, layers=None):
    """``arch`` at its published width (cut to ``layers``), bf16 weights
    from a seeded generator, and an engine for the four prompts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    engine = ServeEngine(cfg, params, max_len=4096, batch_slots=4,
                         device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in LM_LENS]
    return cfg, params, engine, prompts, {"init_s": init_s,
                                          "params": n_params,
                                          "param_bytes": 2 * n_params}


def serve_run(engine, cfg, prompts, max_new=32):
    """One generate (the main path: the kernels' counts from 0 just before
    it, read just after), its launches checked exactly (one prefill's
    attention on ``tc``, 3 GEMMs a MoE layer a forward: the prefill's on
    ``prefill``, the decode steps' on ``decode``), and a second generate
    that must repeat the tokens and the launches. Returns the row, the
    launches by route and the ``Capture`` of the first generate."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    mg.reset_launches()
    with Capture() as cap:
        t0 = time.perf_counter()
        res = engine.generate(prompts, max_new_tokens=max_new, greedy=True,
                              sync_every=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    routes = dict(mg.moe_gemm.route_launches)
    attn_routes = dict(fa.flash_attention.route_launches)
    launches = {"flash_attention": fa.flash_attention.launches,
                "moe_gemm": mg.moe_gemm.launches}
    peak = torch.cuda.max_memory_allocated()
    n_moe = sum(1 for k in cfg.pattern if k in "AM") * cfg.n_periods
    n_attn = sum(1 for k in cfg.pattern if k in "aAl") * cfg.n_periods
    forwards = 1 + len(cap.events["decode"])
    check(res.tokens.shape == (len(prompts), max_new),
          f"tokens {res.tokens.shape}")
    check(forwards == max_new, f"{forwards} forwards for {max_new} tokens")
    want_attn = {"tc": n_attn, "fp32": 0}
    check(attn_routes == want_attn, f"{cfg.name}: flash_attention routes "
          f"{attn_routes}, expected {want_attn} (one prefill)")
    want = {"prefill": 3 * n_moe, "decode": 3 * n_moe * (forwards - 1),
            "fp32": 0}
    check(routes == want, f"{cfg.name}: moe_gemm routes {routes}, expected "
          f"{want}")
    check(not bool(cap.bad), f"{cfg.name}: a logit was NaN or inf")
    check(((0 <= res.tokens) & (res.tokens < cfg.vocab)).all(),
          "token out of range")
    decode_ms = cap.step_ms("decode")
    row = {"layers": cfg.n_layers, "pattern": "".join(cfg.pattern),
           "d_model": cfg.d_model, "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": max_new,
           "generated_tokens": int(res.lengths.sum()), "generate_wall_s": wall,
           "tokens_per_s": int(res.lengths.sum()) / wall,
           "prefill_ms": cap.step_ms("prefill")[0],
           "decode_step_ms_mean": float(np.mean(decode_ms)),
           "decode_step_ms_min": float(np.min(decode_ms)),
           "decode_step_ms_max": float(np.max(decode_ms)),
           "peak_memory_allocated": peak, "launches": launches,
           "moe_gemm_route_launches": routes,
           "flash_attention_route_launches": attn_routes,
           "first_tokens": res.tokens[:, :8].tolist()}
    res2 = engine.generate(prompts, max_new_tokens=max_new, greedy=True,
                           sync_every=8)
    check(np.array_equal(res.tokens, res2.tokens),
          f"{cfg.name}: a second generate gave other tokens")
    again = {"flash_attention": fa.flash_attention.launches,
             "moe_gemm": mg.moe_gemm.launches}
    check(again == {k: 2 * v for k, v in launches.items()},
          f"{cfg.name}: repeat launches {again}, first {launches}")
    row["repeat_identical"] = True
    return row, routes, attn_routes, cap


def phase_lm_serve(dev, arch="qwen2-moe-a2.7b"):
    """qwen2-moe-a2.7b at full size through ServeEngine.generate."""
    cfg, params, engine, prompts, info = serve_model(dev, arch)
    row, routes, attn_routes, cap = serve_run(engine, cfg, prompts)
    emit({"phase": "lm_serve", "arch": arch,
          "experts_padded": cfg.moe.n_experts_padded, **info, **row})

    q, k, v, args = cap.attn["prefill"]
    flash = time_flash(dev, (q, k, v, args))
    flash_fp32 = time_flash(dev, (q.float(), k.float(), v.float(), args))
    del q, k, v
    gemms = []
    for phase in ("prefill", "decode"):
        calls = cap.gemm[phase]
        for name, (x, w, rows) in (("up", calls[0]), ("down", calls[2])):
            gemms.append({"phase": phase, "projection": name,
                          **time_moe(x, w, rows)})
    emit({"phase": "lm_kernel_timing", "flash_attention": flash,
          "flash_attention_fp32": flash_fp32, "moe_gemm": gemms})
    cap = None
    emit({"phase": "lm_profile", **profile_generate(engine, prompts)})
    emit({"phase": "lm_plain_prefill", "dtype": "bfloat16",
          "layers": cfg.n_layers,
          **plain_prefill_check(params, cfg, dev, prompts)})
    del engine, params
    torch.cuda.empty_cache()
    f32 = f32_plain_check(dev, arch)
    emit({"phase": "lm_plain_check", **f32})
    routes["fp32"] = f32["route_launches"]["fp32"]
    attn_routes["fp32"] = f32["flash_attention_route_launches"]["fp32"]
    return (routes, attn_routes, flash, flash_fp32, gemms,
            f32["moe_gemm_fp32"])


# ---------------------------------------------------------------------------
# phase 11a: mamba2 — block kinds 'm' / 'M' serving and training
# ---------------------------------------------------------------------------

MAMBA_ARCH, JAMBA_ARCH = "mamba2-1.3b", "jamba-v0.1-52b"
# jamba at its published width, cut to one period: 8 of 32 layers hold
# ~13.0 B parameters (26 GB in bf16); the 52 B of 32 layers do not fit
JAMBA_LAYERS = 8
MAMBA_TRAIN_STEPS = 4
# the first decode step against a prefill over the prompt and that token,
# relative to the largest logit: in bf16 the two paths round in other
# places (the prefill's conv sums its taps in bf16, the decode step's in
# float32; the SSD's chunked form against the recurrence); the card read
# 6.9 % at mamba2-1.3b and 1.7 % at jamba's one period (512 tokens), and
# the same step from the zero state (the reference's prefill) must land
# above the bound
DECODE_GAP_REL = 0.2
# one prompt a chunk multiple (256), one not: the prefill's padding branch
DECODE_GAP_LENS = (512, 500)


@torch.no_grad()
def first_decode_gap(params, cfg, dev, prompt):
    """Prefill of ``prompt``, then one decode step with its argmax token,
    against a prefill over the prompt and that token: the decode step
    continues from the state the prefill left, and fails above
    ``DECODE_GAP_REL`` of the largest logit. The same decode step from
    every mamba layer's zero state (what the reference's prefill leaves,
    ``src/repro/models/blocks.py:85-87``) must fail it: the planted fault
    shows that the bound can see a wrong state."""
    from repro_torch.models import (SSMState, decode_step, init_caches,
                                    init_ssm_state, prefill_step)

    toks = torch.from_numpy(prompt.astype(np.int64))[None].to(dev)
    n = toks.shape[1]
    logits, caches = prefill_step(params, cfg, {"tokens": toks},
                                  init_caches(cfg, 1, n + 1, device=dev))
    nxt = logits.argmax(-1)[:, None]
    ld, _ = decode_step(params, cfg, {"tokens": nxt}, caches)
    zero = [init_ssm_state(cfg, 1, device=dev) if isinstance(c, SSMState)
            else c for c in caches]
    lz, _ = decode_step(params, cfg, {"tokens": nxt}, zero)
    lp, _ = prefill_step(params, cfg, {"tokens": torch.cat([toks, nxt], 1)},
                         init_caches(cfg, 1, n + 1, device=dev))
    gap = float((ld - lp).abs().max())
    zero_gap = float((lz - lp).abs().max())
    scale = float(lp.abs().max())
    check(bool(torch.isfinite(ld).all() & torch.isfinite(lp).all()),
          f"{cfg.name}: first decode step's logits not finite")
    check(gap <= DECODE_GAP_REL * scale, f"{cfg.name}: the first decode "
          f"step after {n} tokens differs from the longer prefill by {gap} "
          f"(largest logit {scale}, bound {DECODE_GAP_REL} of it)")
    check(zero_gap > DECODE_GAP_REL * scale, f"{cfg.name}: from the zero "
          f"state the first decode step after {n} tokens is only "
          f"{zero_gap} off the longer prefill (largest logit {scale}): the "
          f"bound {DECODE_GAP_REL} cannot see a wrong state")
    return {"prompt_len": n, "max_abs_logit_diff": gap,
            "max_abs_logit": scale, "rel": gap / scale,
            "bound_rel": DECODE_GAP_REL, "zero_state_rel": zero_gap / scale,
            "top1_agree": bool(ld.argmax() == lp.argmax())}


def first_decode_gaps(params, cfg, dev, prompt):
    """``first_decode_gap`` on the first ``DECODE_GAP_LENS`` tokens of
    ``prompt``."""
    return [first_decode_gap(params, cfg, dev, prompt[:n])
            for n in DECODE_GAP_LENS]


def check_captured(cap, name):
    """The first layer's captured prefill attention and grouped GEMMs
    (prefill and the first decode step; none in a model without such
    layers) through the kernels against their plain versions on the same
    inputs, within ``TOL`` / ``MOE_TOL``: the checks of ``time_flash`` and
    ``time_moe`` at these shapes, untimed. Returns the largest error by
    route."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.moe_gemm import kernel as mg
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    errs = {}
    if "prefill" in cap.attn:               # a model with attention layers
        q, k, v, (scale, causal, window, softcap) = cap.attn["prefill"]
        kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
        ok, err = within(fa.flash_attention(q, k, v, **kw),
                         mha_ref(q, k, v, **kw), *TOL[q.dtype])
        check(ok, f"{name}: prefill attention kernel != plain version at q "
                  f"{tuple(q.shape)}, k {tuple(k.shape)} ({err})")
        errs[fa.route(q.dtype, q.shape[3])] = err
    for phase in ("prefill", "decode"):
        for x, w, rows in cap.gemm.get(phase, ()):
            ok, err = within(mg.moe_gemm(x, w, rows),
                             moe_gemm_ref(x, w, rows), *MOE_TOL[x.dtype])
            check(ok, f"{name}: {phase} grouped GEMM kernel != plain "
                      f"version at {tuple(x.shape)} x {tuple(w.shape)} "
                      f"({err})")
            r = mg.route(x.dtype, x.shape[1])
            errs[r] = max(errs.get(r, 0.0), err)
    return errs


def mamba_train_full(dev):
    """mamba2-1.3b at full size: ``MAMBA_TRAIN_STEPS`` AdamW steps through
    ``make_train_step`` / ``TrainLoopRunner``, each timed by CUDA events;
    every metric finite, no kernel launched (no attention or MoE layer)."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import TrainLoopRunner
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(MAMBA_ARCH)
    check(cfg.remat == "block" and cfg.dtype == "bfloat16",
          f"{cfg.name}: remat {cfg.remat}, dtype {cfg.dtype}")
    t0 = time.perf_counter()
    state = train_state(cfg, dev)
    torch.cuda.synchronize()
    out = {"arch": MAMBA_ARCH, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "remat": cfg.remat, "compute_dtype": cfg.dtype,
           "init_s": time.perf_counter() - t0,
           "params": sum(t.numel() for t in tree_leaves(state.params)),
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(state))}
    timed = TimedStep(make_train_step(cfg, AdamWConfig()))
    torch.cuda.reset_peak_memory_stats()
    runner = TrainLoopRunner(timed, state, os.path.join(
        str(Path(__file__).resolve().parent / "build"), "mamba_no_ckpt"),
        ckpt_every=10 ** 9)
    t0 = time.perf_counter()
    whole = run_logged(runner, train_batches(cfg, dev), MAMBA_TRAIN_STEPS)
    out["run_wall_s"] = time.perf_counter() - t0
    out["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
    launched = timed.launches()
    check(all(n == 0 for kern in launched.values() for n in kern.values()),
          f"mamba2 training launched kernels: {launched}")
    for s, m in whole.items():
        check(all(np.isfinite(v) for v in m.values()),
              f"mamba2 train step {s}: a metric is not finite: {m}")
    step_ms = [e0.elapsed_time(e1) for e0, e1 in
               (r["events"] for r in timed.rows)]
    steady = float(np.mean(step_ms[1:]))
    out.update(step_ms=step_ms, step_ms_mean_after_first=steady,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (steady / 1e3),
               losses=[whole[s]["loss/total"] for s in sorted(whole)],
               grad_norms=[whole[s]["opt/grad_norm"] for s in sorted(whole)])
    return out


def phase_mamba(dev):
    """(a) mamba2-1.3b serving, (b) mamba2-1.3b training, both at full
    size, (c) jamba-v0.1-52b serving at full width, one period, its kernels
    held against their plain versions at its shapes; a profile of one
    mamba2 training step. Returns jamba's launches by route (the mamba2
    paths launch no kernel) and its kernels' largest errors by route."""
    import dataclasses

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cfg, params, engine, prompts, info = serve_model(dev, MAMBA_ARCH)
    row, _, _, _ = serve_run(engine, cfg, prompts)  # checked: no launch
    row["first_decode_check"] = first_decode_gaps(params, cfg, dev,
                                                  prompts[-1])
    emit({"phase": "mamba_serve", "arch": MAMBA_ARCH, **info, **row,
          "seconds": time.perf_counter() - t0})
    del engine, params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    emit({"phase": "mamba_train", **mamba_train_full(dev),
          "seconds": time.perf_counter() - t0})
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params, engine, prompts, info = serve_model(dev, JAMBA_ARCH,
                                                     JAMBA_LAYERS)
    row, routes, attn_routes, cap = serve_run(engine, cfg, prompts)
    errs = check_captured(cap, cfg.name)
    del cap
    row["kernel_max_abs_err"] = errs
    row["plain_prefill"] = plain_prefill_check(params, cfg, dev, prompts)
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))
    row["first_decode_check"] = [{"capacity_factor": 16.0, **r} for r in
                                 first_decode_gaps(params, wide, dev,
                                                   prompts[-1])]
    emit({"phase": "mamba_jamba_serve", "arch": JAMBA_ARCH, **info, **row,
          "seconds": time.perf_counter() - t0})
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "mamba_train_profile", "arch": MAMBA_ARCH,
          "tokens": [TRAIN_BATCH, TRAIN_SEQ],
          **train_profile(arch=MAMBA_ARCH)})
    emit({"phase": "mamba", "seconds": time.perf_counter() - t_phase})
    return routes, attn_routes, errs


# ---------------------------------------------------------------------------
# phase 11b: lm_ranks — the sharding rules across ranks (ep_dp)
# ---------------------------------------------------------------------------

LM_RANKS_GLOO = 4
LM_RANKS_DECODE = 32            # greedy decode steps after the prefill
LM_RANKS_NCCL_LAYERS = 2
LM_RANKS_NCCL_DECODE = 2
LM_RANKS_TRAIN_LAYERS = 2
LM_RANKS_TRAIN_STEPS = 3
LM_RANKS_TRAIN_SEQ = 2048
# one step each from the first state beside the block steps (phase
# lm_ranks (c)): "dots" must send the MoE dispatch's collectives no more
# often than "none"
LM_RANKS_REMAT_STEPS = ("none", "dots")
# AdamW at lr 3e-4 from the first step on both sides of the training
# check: at warm-up scale (3e-6 a step) the parameters' check could not tell
# a wrong gradient from rounding
LM_RANKS_OPT = dict(warmup_steps=1)
# the ranks' training metrics against microbatches=4, relative. The first
# step's losses come from the same parameters on both sides: bf16
# activations, float32 sums in other orders (the vocab-parallel cross
# entropy's reductions), 7.7e-8 on an H100. After it the parameters are
# apart where a near-zero gradient took the other sign, and the first
# step at lr 3e-4 moves a random model far (its loss 12.3 -> 15.3): the
# later losses read 1.5e-4, the aux loss 1.5e-3, the gradient norms
# 3.2e-4 at most
LM_RANKS_FIRST_LOSS_RTOL = 1e-6
LM_RANKS_LOSS_RTOL = 1e-3
LM_RANKS_AUX_RTOL = 1e-2
LM_RANKS_GNORM_RTOL = 3e-3
# AdamW's first step moves each element by ±lr whatever its gradient's
# size, so two runs differ by up to 2·lr where a near-zero gradient takes
# the other sign: the largest difference is bounded by 2·Σlr, the mean by
# this share of Σlr (0.41-0.60 % read; a wrong-signed gradient gives
# about 2)
LM_RANKS_PARAM_MEAN_SHARE = 0.03
# the first decode step against the one-process step on its own route
# (cap rows: the `decode` kernel where P·cap takes `prefill`) may differ by
# more than this share of the largest logit only where a router's top-k
# set differs between the two routes in that step
LM_RANKS_CROSS_ROUTE_REL = 0.05


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def left_padded(prompts):
    """The prompts left-padded to the longest, as ``ServeEngine`` pads
    them: the global batch (B, S)."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks


@contextlib.contextmanager
def gemm_rows(p, plain=False):
    """The model's grouped GEMMs handed ``p``·cap rows (the buckets, then
    zero rows the ``rows`` counts exclude): the row count a rank's GEMMs
    see after the all-to-all, so the one-process model takes the ranks'
    kernel route and its arithmetic per row. With ``plain``, the plain
    version (``moe_gemm_ref``: float32 sums, one rounding to the output's
    dtype) in the kernels' place. The identity for p = 1 without it."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    orig = moe_mod.grouped_gemm
    inner = moe_gemm_ref if plain else orig

    def wide(x, w, rows=None):
        e, cap, d = x.shape
        xp = torch.zeros((e, p * cap, d), dtype=x.dtype, device=x.device)
        xp[:, :cap] = x
        return inner(xp, w, rows)[:, :cap]

    if p > 1 or plain:
        moe_mod.grouped_gemm = wide
    try:
        yield
    finally:
        moe_mod.grouped_gemm = orig


@contextlib.contextmanager
def step_log(log):
    """While ``log["on"]``, each MoE layer's router ranking appended to
    ``log["layers"]``: every token's top k+1 expert ids and probabilities,
    on the host (the router's own arithmetic, repeated on its inputs); and
    each grouped GEMM the model calls held against the plain version on
    the same inputs, ``(ok within MOE_TOL, max abs error)`` appended to
    ``log["gemm"]``."""
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    orig, gemm = moe_mod._route_and_combine, moe_mod.grouped_gemm

    def checked(x, w, rows=None):
        out = gemm(x, w, rows)
        if log.get("on"):
            log["gemm"].append(within(out, moe_gemm_ref(x, w, rows),
                                      *MOE_TOL[x.dtype]))
        return out

    def logged(cfg, router, shared, xf, run_experts, ranks=None):
        if log.get("on"):
            logits = (xf @ router).float()
            e = cfg.moe.n_experts_padded
            if e > cfg.moe.n_experts:
                logits[:, cfg.moe.n_experts:] = -1e30
            probs, ids = torch.topk(torch.softmax(logits, dim=-1),
                                    cfg.moe.top_k + 1, dim=-1)
            log["layers"].append((ids.cpu(), probs.cpu()))
        return orig(cfg, router, shared, xf, run_experts, ranks)

    moe_mod._route_and_combine, moe_mod.grouped_gemm = logged, checked
    try:
        yield
    finally:
        moe_mod._route_and_combine, moe_mod.grouped_gemm = orig, gemm


def routing_witness(a, b, k):
    """Where two runs' first decode steps routed the same token apart:
    ``a`` and ``b`` are :func:`step_log` layers (one token). The layers
    whose top-k sets differ, and at the first of them the experts swapped
    and each run's margin between its k-th and (k+1)-th probability; the
    largest probability difference over the layers before it (the
    rounding the routes' arithmetic leaves), and each layer's largest
    difference of the k ranked probabilities."""
    flipped = [i for i, (x, y) in enumerate(zip(a, b))
               if set(x[0][0, :k].tolist()) != set(y[0][0, :k].tolist())]
    diffs = [float((x[1][0, :k] - y[1][0, :k]).abs().max())
             for x, y in zip(a, b)]
    out = {"moe_layers": len(a), "flipped_layers": flipped,
           "prob_diff_by_layer": diffs}
    first = flipped[0] if flipped else len(a)
    out["max_prob_diff_before"] = max(diffs[:first] or [0.0])
    if flipped:
        (ia, pa), (ib, pb) = a[first], b[first]
        sa, sb = set(ia[0, :k].tolist()), set(ib[0, :k].tolist())
        out["first"] = {"layer": first, "only_a": sorted(sa - sb),
                        "only_b": sorted(sb - sa),
                        "margin_a": float(pa[0, k - 1] - pa[0, k]),
                        "margin_b": float(pb[0, k - 1] - pb[0, k]),
                        "kth_prob_a": float(pa[0, k - 1]),
                        "kth_prob_b": float(pb[0, k - 1])}
    return out


def top2_margin(logits):
    """Per row, (the largest logit less the second, the largest): how far
    the greedy choice is from a tie."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return torch.stack([top[:, 0] - top[:, 1], top[:, 0]], dim=1).cpu()


@torch.no_grad()
def greedy_refs(params, cfg, dev, toks, world, steps, max_len, rows_of=1,
                routing=False, plain=False, seq_blocks=1, tp_parts=1):
    """The one-process port on each rank's slab of ``toks``: the prefill's
    logits, the first decode step's (fed the prefill's argmax) and the
    greedy tokens of ``steps`` decode steps, with each step's top-2 margin
    (:func:`top2_margin`), the grouped GEMMs handed ``rows_of``·cap rows,
    or the plain version (:func:`gemm_rows`); with ``routing``, the first
    decode step's :func:`step_log`; with ``seq_blocks`` P, the MoE as
    ``ep_sharded`` routes it across P ranks (:func:`seq_blocked_moe`);
    with ``tp_parts`` P, the layers' products as a tp line of P computes
    them (:func:`tp_arithmetic`). Host tensors, per rank."""
    from repro_torch.models import decode_step, init_caches, prefill_step

    b = toks.shape[0] // world
    refs = []
    for r in range(world):
        slab = torch.from_numpy(toks[r * b:(r + 1) * b]).to(dev)
        caches = init_caches(cfg, b, max_len, device=dev)
        log = {"on": False, "layers": [], "gemm": []}
        with gemm_rows(rows_of, plain), step_log(log), \
                seq_blocked_moe(seq_blocks), tp_arithmetic(tp_parts, cfg):
            logits, caches = prefill_step(params, cfg, {"tokens": slab},
                                          caches)
            ref = {"prefill": logits.cpu()}
            out, margins = [logits.argmax(-1)], [top2_margin(logits)]
            for i in range(steps):
                log["on"] = routing and i == 0
                logits, caches = decode_step(
                    params, cfg, {"tokens": out[-1][:, None]}, caches)
                log["on"] = False
                if i == 0:
                    ref["decode1"] = logits.cpu()
                out.append(logits.argmax(-1))
                margins.append(top2_margin(logits))
        if routing:
            ref["routing"], ref["gemm"] = log["layers"], log["gemm"]
        ref["tokens"] = torch.stack(out, 1).cpu()
        ref["margins"] = torch.stack(margins, 1)
        refs.append(ref)
        del caches
    return refs


@contextlib.contextmanager
def seq_blocked_moe(p):
    """With ``p`` > 1, the one-process model's MoE layers as ``ep_sharded``
    runs them on a ``(1, p)`` mesh: where ``p`` divides the sequence, each
    of ``p`` blocks of it routed alone (its own capacity, its experts'
    GEMMs handed ``p``·cap rows as a rank's are after the all-to-all),
    the outputs joined and the shared experts' added (run on the whole
    slab), the aux loss their mean and the metrics their sum; elsewhere (a
    decode step) the whole batch, as there."""
    import repro_torch.models.blocks as blocks_mod
    from repro_torch.models.layers import mlp_apply

    orig = blocks_mod.moe_apply

    def blocked(params, cfg, x):
        if x.shape[1] % p:
            return orig(params, cfg, x)
        routed = {k: v for k, v in params.items() if k != "shared"}
        with gemm_rows(p):
            outs = [orig(routed, cfg, c) for c in x.chunk(p, dim=1)]
        y = torch.cat([o[0] for o in outs], dim=1)
        if "shared" in params:      # on the whole slab, as the ranks run it
            y = y + mlp_apply(params["shared"], x, cfg.mlp)
        return (y, torch.stack([o[1] for o in outs]).mean(),
                {k: sum(o[2][k] for o in outs) for k in outs[0][2]})

    if p > 1:
        blocks_mod.moe_apply = blocked
    try:
        yield
    finally:
        blocks_mod.moe_apply = orig


@contextlib.contextmanager
def every_launch_checked(on):
    """With ``on``: every attention and grouped-GEMM call the model makes
    (each one launch of its kernel) held against the plain version on the
    same inputs (``mha_ref`` within ``TOL``, ``moe_gemm_ref`` within
    ``MOE_TOL``; the plain versions launch no kernel); yields ``{route:
    [calls, failures, largest error]}``."""
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.moe_gemm import kernel as mg
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    seen = {}
    mha, gemm = attn_mod.multihead_attention, moe_mod.grouped_gemm

    def note(route, ok, err):
        row = seen.setdefault(route, [0, 0, 0.0])
        row[0] += 1
        row[1] += not ok
        row[2] = max(row[2], err)

    def attn(q, k, v, scale, causal, window=0, softcap=0.0):
        out = mha(q, k, v, scale, causal, window, softcap)
        note(fa.route(q.dtype, q.shape[3]), *within(
            out, mha_ref(q, k, v, scale=scale, causal=causal, window=window,
                         softcap=softcap), *TOL[q.dtype]))
        return out

    def grouped(x, w, rows=None):
        out = gemm(x, w, rows)
        note(mg.route(x.dtype, x.shape[1]),
             *within(out, moe_gemm_ref(x, w, rows), *MOE_TOL[x.dtype]))
        return out

    if on:
        attn_mod.multihead_attention, moe_mod.grouped_gemm = attn, grouped
    try:
        yield seen
    finally:
        attn_mod.multihead_attention, moe_mod.grouped_gemm = mha, gemm


def lm_ranks_serve(dev, rules, job, rank, params=None):
    """One rank's serving run under the rules: this rank's slices of the
    weights (drawn whole from the seeded generator, sliced leaf by leaf;
    or ``params``, slices already held, e.g. float32 masters, which the
    model casts to bf16 as it gathers them), a prefill of its slab,
    ``job["steps"]`` greedy decode steps (the first fed the one-process
    argmax), everything timed; the logits and
    greedy tokens against the one-process port's on the slab with its
    grouped GEMMs handed the ranks' P·cap rows (``job["refs"]``, the same
    kernel routes), the first decode step also against the one-process
    step on its own route (``job["native"]``, checked in the parent against
    the routing witness), the kernels'
    launches by route, the first layer's kernels against their plain
    versions at this rank's shapes, the transfers by kind."""
    from repro_torch.core.collectives import mesh_comm
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg
    from repro_torch.models import init_caches
    from repro_torch.sharding import use_rules
    from repro_torch.sharding.placement import (batch_slab,
                                                init_params_sharded)
    from repro_torch.train import make_decode_step, make_prefill_step
    from repro_torch.train.optimizer import tree_leaves

    cfg, ref = job["cfg"], job["refs"][rank]
    comm = mesh_comm(rules.mesh)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if params is None:
        params = init_params_sharded(
            cfg, rules, torch.Generator(device=dev).manual_seed(0),
            device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = sum(t.numel() for t in tree_leaves(params))
    held_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params))
    toks = batch_slab(torch.from_numpy(job["tokens"]), rules).to(dev)
    with use_rules(rules):         # a sequence-split cache: its block
        caches = init_caches(cfg, toks.shape[0], job["max_len"],
                             device=dev)
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c if isinstance(t, torch.Tensor))
    ssm_bytes = sum(c.ssm.numel() * c.ssm.element_size() for c in caches
                    if hasattr(c, "ssm"))
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    fa.reset_launches()
    mg.reset_launches()
    comm.reset_counts()
    with Capture() as cap, use_rules(rules), torch.no_grad(), \
            every_launch_checked(job.get("check_every")) as checked:
        cap.phase = "prefill"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": toks}, caches)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        comm_prefill = {"bytes": dict(comm.sent), "s": dict(comm.seconds),
                        "calls": dict(comm.calls)}
        comm.reset_counts()
        first = logits.cpu()
        own = [logits.argmax(-1)]
        cap.phase, step_ms, comm_decode1 = "decode", [], None
        for i in range(job["steps"]):
            feed = ref["tokens"][:, 0].to(dev) if i == 0 else own[-1]
            t0 = time.perf_counter()
            logits, caches = decode(params, {"tokens": feed[:, None]},
                                    caches)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                cap.capturing = False
                dec1 = logits.cpu()
                comm_decode1 = {"bytes": dict(comm.sent),
                                "calls": dict(comm.calls)}
            own.append(logits.argmax(-1))
        comm_decode = {"bytes": dict(comm.sent), "s": dict(comm.seconds),
                       "calls": dict(comm.calls)}
    routes = dict(mg.moe_gemm.route_launches)
    attn_routes = dict(fa.flash_attention.route_launches)
    peak = torch.cuda.max_memory_allocated()
    dry_prefill = None
    if job.get("dry_prefill"):
        # one more prefill at the dry-run's shape: a cache of the prompt's
        # length (the dry-run's ShapeConfig states one length), its
        # transfers and launches counted from 0
        with use_rules(rules), torch.no_grad():
            caches2 = init_caches(cfg, toks.shape[0], toks.shape[1],
                                  device=dev)
            fa.reset_launches()
            mg.reset_launches()
            comm.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, {"tokens": toks}, caches2)
            torch.cuda.synchronize()
            dry_prefill = {
                "ms": 1e3 * (time.perf_counter() - t0),
                "bytes": dict(comm.sent), "calls": dict(comm.calls),
                "flash_attention_route_launches":
                    dict(fa.flash_attention.route_launches),
                "moe_gemm_route_launches": dict(mg.moe_gemm.route_launches)}
        del caches2
    tokens = torch.stack(own, 1).cpu()
    ok_p, err_p = within(first, ref["prefill"], *TOL[torch.bfloat16])
    ok_d, err_d = within(dec1, ref["decode1"], *TOL[torch.bfloat16])
    # against the one-process decode step on its own route (cap rows: the
    # `decode` kernel where P·cap takes `prefill`): the two kernels round
    # each GEMM's bf16 output in other places, and a router near-tie in a
    # later layer can then pick another expert (the parent checks which)
    native = job["native"][rank]
    err_n = float((dec1 - native["decode1"]).abs().max())
    err_np = float((first - native["prefill"]).abs().max())
    errs = check_captured(cap, f"lm_ranks rank {rank}")
    del params, caches, cap, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"init_s": init_s, "params_held": held,
            "param_bytes_held": held_bytes, "cache_bytes": cache_bytes,
            "ssm_bytes": ssm_bytes, "launches_checked": checked,
            "max_len": job["max_len"], "slab": list(toks.shape),
            "peak_memory_allocated": peak, "prefill_ms": prefill_ms,
            "decode_step_ms": step_ms, "comm_prefill": comm_prefill,
            "comm_decode": comm_decode, "comm_decode1": comm_decode1,
            "dry_prefill": dry_prefill, "moe_gemm_route_launches": routes,
            "flash_attention_route_launches": attn_routes,
            "kernel_vs_plain_err": errs,
            "prefill_logits_ok": ok_p, "prefill_max_abs_err": err_p,
            "prefill_bitwise": bitwise(first, ref["prefill"]),
            "decode1_logits_ok": ok_d, "decode1_max_abs_err": err_d,
            "decode1_bitwise": bitwise(dec1, ref["decode1"]),
            "decode1_native_max_abs_err": err_n,
            "prefill_native_max_abs_err": err_np,
            "decode1_native_rel": err_n / float(
                native["decode1"].abs().max()),
            "native_tokens_agree": int((tokens[:, :2]
                                        == native["tokens"][:, :2]).sum()),
            "finite": bool(torch.isfinite(first).all()
                           and torch.isfinite(dec1).all()),
            "tokens": tokens.tolist(),
            "tokens_agree": int((tokens == ref["tokens"]).sum()),
            "tokens_total": int(tokens.numel())}


def lm_ranks_train(dev, rules, job, rank, params=None):
    """One rank's training run under the rules: float32 master slices from
    the seeded generator, an AdamW step on the rank's slab of each global
    batch (timed; int8 compression unless ``job["compress"]`` is False),
    the losses and the parameters against the one-process oracle (its
    whole leaves shared from the parent's card), the state's bytes held
    (parameters, moments, residual), then, with a ``job["ckpt_dir"]``, the
    parameters saved sharded (gathered whole on rank 0, written once) and
    restored with ``sharding_tree=``, bitwise. ``params``: this rank's
    float32 slices already drawn (a serving run before may have used
    them)."""
    from repro_torch.checkpoint import restore_checkpoint, save_sharded
    from repro_torch.core.collectives import mesh_comm
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg
    from repro_torch.sharding import use_rules
    from repro_torch.sharding.placement import (batch_slab, global_params,
                                                init_params_sharded,
                                                local_slice, named_shardings,
                                                param_specs)
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train.optimizer import tree_leaves

    cfg, oracle = job["cfg"], job["oracle"]
    comm = mesh_comm(rules.mesh)
    torch.cuda.reset_peak_memory_stats()
    if params is None:
        params = init_params_sharded(
            cfg, rules, torch.Generator(device=dev).manual_seed(0),
            device=dev, dtype=torch.float32)
    compress = job.get("compress", True)
    state = init_train_state(cfg, params, compress=compress)
    step = make_train_step(cfg, AdamWConfig(**LM_RANKS_OPT),
                           compress_grads=compress)
    fa.reset_launches()
    mg.reset_launches()
    comm.reset_counts()
    metrics, step_ms, calls_step1 = [], [], None
    with use_rules(rules):
        for batch in job["batches"]:
            slab = {k: batch_slab(torch.from_numpy(v), rules).to(dev)
                    for k, v in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, slab)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            metrics.append({k: float(v) for k, v in m.items()})
            if calls_step1 is None:
                calls_step1 = dict(comm.calls)
    routes = dict(mg.moe_gemm.route_launches)
    attn_routes = dict(fa.flash_attention.route_launches)
    comm_steps = {"bytes": dict(comm.sent), "s": dict(comm.seconds),
                  "calls": dict(comm.calls)}
    peak = torch.cuda.max_memory_allocated()
    losses = ("loss/total", "loss/ce", "loss/aux")
    # relative; a model without MoE has an aux loss of 0 on both sides
    rel = [{k: abs(got[k] - want[k]) / (abs(want[k]) or 1.0)
            for k in losses + ("opt/grad_norm",)}
           for got, want in zip(metrics, oracle["metrics"])]
    tols = [{k: LM_RANKS_FIRST_LOSS_RTOL for k in losses}] + [
        {"loss/total": LM_RANKS_LOSS_RTOL, "loss/ce": LM_RANKS_LOSS_RTOL,
         "loss/aux": LM_RANKS_AUX_RTOL}] * (len(rel) - 1)
    metrics_ok = len(metrics) == len(oracle["metrics"]) and all(
        r[k] <= t.get(k, LM_RANKS_GNORM_RTOL)
        for r, t in zip(rel, tols) for k in r)
    # the AdamW update moves an element by at most lr (1 + wd·|p|) a step;
    # two runs whose gradients differ in rounding differ by at most twice
    lrs = [m["opt/lr"] for m in metrics]
    bound = 2.0 * sum(lrs) * 1.01
    mean_bound = LM_RANKS_PARAM_MEAN_SHARE * sum(lrs)
    worst, mean_num, count = 0.0, 0.0, 0
    specs = param_specs(cfg, rules)
    for leaf, whole, (_, spec) in zip(tree_leaves(state.params),
                                      oracle["params"], specs):
        d = (leaf - local_slice(whole, spec, rules)).abs()
        worst = max(worst, float(d.max()))
        mean_num += float(d.sum())
        count += d.numel()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((state.params, state.opt.mu,
                                            state.opt.nu, state.residual)))
    save_s = restore_s = same = back = None
    if job.get("ckpt_dir"):
        shardings = named_shardings(global_params(cfg, torch.float32), rules)
        t0 = time.perf_counter()
        save_sharded(job["ckpt_dir"], len(metrics), state.params, shardings)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = restore_checkpoint(job["ckpt_dir"],
                                  global_params(cfg, torch.float32),
                                  device=dev, sharding_tree=shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = all(bitwise(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(state.params)))
    mean = mean_num / max(count, 1)
    out = {"steps": len(metrics), "metrics": metrics, "step_ms": step_ms,
           "metrics_ok": metrics_ok, "metrics_rel": rel,
           "params_ok": worst <= bound and mean <= mean_bound,
           "peak_memory_allocated": peak, "state_bytes_held": state_bytes,
           "params_held": sum(t.numel() for t in tree_leaves(params)),
           "param_max_abs_diff": worst, "param_mean_abs_diff": mean,
           "param_bound": bound, "param_mean_bound": mean_bound,
           "comm_steps": comm_steps, "moe_gemm_route_launches": routes,
           "flash_attention_route_launches": attn_routes,
           "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
           "restored_bitwise": same, "calls_step1": calls_step1}
    del state, params, back
    gc.collect()
    torch.cuda.empty_cache()
    if job.get("remat_steps"):
        out["remat_steps"] = {r: lm_ranks_remat_step(dev, rules, job, r,
                                                     compress)
                              for r in job["remat_steps"]}
    return out


def lm_ranks_remat_step(dev, rules, job, remat, compress):
    """One training step of ``job["cfg"]`` under ``remat`` from the first
    state (this rank's slices drawn again from the seeded generator) on
    the first batch: its metrics, ms, peak memory, transfers and launches
    by route, counted from 0."""
    import dataclasses

    from repro_torch.core.collectives import mesh_comm
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg
    from repro_torch.sharding import use_rules
    from repro_torch.sharding.placement import (batch_slab,
                                                init_params_sharded)
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)

    cfg = dataclasses.replace(job["cfg"], remat=remat)
    comm = mesh_comm(rules.mesh)
    params = init_params_sharded(
        cfg, rules, torch.Generator(device=dev).manual_seed(0), device=dev,
        dtype=torch.float32)
    state = init_train_state(cfg, params, compress=compress)
    step = make_train_step(cfg, AdamWConfig(**LM_RANKS_OPT),
                           compress_grads=compress)
    slab = {k: batch_slab(torch.from_numpy(v), rules).to(dev)
            for k, v in job["batches"][0].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    mg.reset_launches()
    comm.reset_counts()
    with use_rules(rules):
        t0 = time.perf_counter()
        state, m = step(state, slab)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    out = {"metrics": {k: float(v) for k, v in m.items()}, "step_ms": ms,
           "peak_memory_allocated": torch.cuda.max_memory_allocated(),
           "calls": dict(comm.calls), "bytes": dict(comm.sent),
           "flash_attention_route_launches":
               dict(fa.flash_attention.route_launches),
           "moe_gemm_route_launches": dict(mg.moe_gemm.route_launches)}
    del state, params, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_ranks_worker(rank, world, backend, init_file, job, queue):
    """One rank of the lm_ranks and fsdp phases: join the group on
    ``cuda:(rank % device_count)`` (the host when ``job["device"]`` is
    "cpu", a rehearsal), build the job's ``(data, model)`` mesh (``(1,
    world)`` by default) under its profile (``ep_dp`` by default) and run
    the job's serving and training parts (with ``job["shared_init"]``,
    both on one float32 draw of this rank's slices)."""
    import datetime

    import torch.distributed as dist

    clock = {"entry": time.time()}     # the host's wall clock
    try:
        torch.set_num_threads(1)   # the ranks share the host's cores
        if backend == "nccl":   # one host, no network: bootstrap on loopback
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if job["device"] == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.sharding import ShardingRules

        rules = ShardingRules.for_mesh(
            make_local_mesh(*job.get("mesh", (1, world))),
            job.get("profile", "ep_dp"))
        clock["group"] = time.time()
        out, params = {"clock": clock}, None
        if job.get("shared_init"):
            # one float32 draw: served from (gathered as bf16), then trained
            from repro_torch.sharding.placement import init_params_sharded

            t0 = time.perf_counter()
            params = init_params_sharded(
                job["train"]["cfg"], rules,
                torch.Generator(device=dev).manual_seed(0), device=dev,
                dtype=torch.float32)
            torch.cuda.synchronize()
            out["init_s"] = time.perf_counter() - t0
        if "serve" in job:
            out["serve"] = lm_ranks_serve(dev, rules, job["serve"], rank,
                                          params)
        if "train" in job:
            out["train"] = lm_ranks_train(dev, rules, job["train"], rank,
                                          params)
        del params
        clock["done"] = time.time()
        queue.put((rank, "ok", out))
    except Exception:  # report, then fail the phase in the parent
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        # drop the parent's tensors shared through CUDA IPC (the oracle's
        # parameters) before this process ends, so that the parent can
        # free them (``torch.cuda.ipc_collect``)
        job.clear()
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()      # the next calls, or the parent's
        if dist.is_initialized():
            dist.destroy_process_group()


def lm_serve_checks(rows, cfg, steps, label):
    """Every rank's logits within tolerance, finite, and its launches: one
    prefill's attention on ``tc``, 3 grouped GEMMs a MoE layer a forward on
    the route of the received rows (P·cap)."""
    from repro_torch.kernels.moe_gemm import kernel as mg

    n_moe = sum(1 for k in cfg.pattern if k in "AM") * cfg.n_periods
    n_attn = sum(1 for k in cfg.pattern if k in "aAl") * cfg.n_periods
    launches = {"flash_attention": {}, "moe_gemm": {}}
    for r, row in enumerate(rows):
        check(row["prefill_logits_ok"] and row["decode1_logits_ok"]
              and row["finite"], f"{label} rank {r}: logits off the "
              f"one-process port's (prefill {row['prefill_max_abs_err']}, "
              f"decode {row['decode1_max_abs_err']}) or not finite")
        check(row["flash_attention_route_launches"] == {"tc": n_attn,
                                                       "fp32": 0},
              f"{label} rank {r}: attention launches "
              f"{row['flash_attention_route_launches']}")
        slab = row["slab"][0]
        world = len(rows)
        want = dict.fromkeys(mg.ROUTES, 0)
        for phase, fwd in (("prefill", 1), ("decode", steps)):
            if n_moe:
                cap = _lm_cap(cfg, slab * (row["slab"][1]
                                           if phase == "prefill" else 1))
                want[mg.route(torch.bfloat16, world * cap)] += \
                    3 * n_moe * fwd
        check(row["moe_gemm_route_launches"] == want,
              f"{label} rank {r}: moe_gemm launches "
              f"{row['moe_gemm_route_launches']}, expected {want}")
        for kind in ("flash_attention", "moe_gemm"):
            for k, v in row[f"{kind}_route_launches"].items():
                launches[kind][k] = launches[kind].get(k, 0) + v
    return launches


def remat_checks(row, first, n_moe, label):
    """A rank's steps under remat ``"none"`` and ``"dots"`` from the first
    state: the losses within the first step's tolerance of the oracle's
    first step; under "dots" the MoE dispatch's ``a2a`` and ``rows`` calls
    those of "none" and fewer than "block"'s first step (no collective of
    the dispatch in the recompute); launches: "none" a layer's kernels
    once, "dots" twice (the hand kernels are recomputed, as under
    "block")."""
    steps = row["remat_steps"]
    for remat, got in steps.items():
        for k in ("loss/total", "loss/ce", "loss/aux"):
            rel = abs(got["metrics"][k] - first[k]) / (abs(first[k]) or 1.0)
            check(rel <= LM_RANKS_FIRST_LOSS_RTOL, f"{label} remat "
                  f"{remat}: {k} {got['metrics'][k]} is {rel} off the "
                  f"oracle's {first[k]}")
        times = 1 if remat == "none" else 2
        check(got["flash_attention_route_launches"] == {"tc": times * n_moe,
                                                       "fp32": 0}
              and got["moe_gemm_route_launches"]["prefill"]
              == 3 * times * n_moe
              and sum(got["moe_gemm_route_launches"].values())
              == 3 * times * n_moe, f"{label} remat {remat}: launches "
              f"{got['flash_attention_route_launches']}, "
              f"{got['moe_gemm_route_launches']}")
    block = row["calls_step1"]
    for kind in ("a2a", "rows"):
        dots, none = steps["dots"]["calls"][kind], steps["none"]["calls"][kind]
        check(dots == none > 0 and dots < block[kind], f"{label}: {kind} "
              f"calls under dots {dots}, none {none}, block {block[kind]}")


def _lm_cap(cfg, tokens):
    from repro_torch.models.moe import _capacity

    return _capacity(cfg.moe, tokens)


def phase_lm_ranks(dev, arch="qwen2-moe-a2.7b"):
    """The sharding rules executed across ranks under ``ep_dp`` on a
    (1, P) mesh: (a) NCCL, a world of one (2 layers at full width, the four
    prompts, a prefill and 2 decode steps) against the one-process port,
    its rank running while the parent computes (b)'s and (c)'s references;
    (b) qwen2-moe-a2.7b at full size served on 4 gloo ranks sharing
    cuda:0, one prompt a rank (the engine's left-padded global batch), a
    prefill and ``LM_RANKS_DECODE`` greedy decode steps, each rank against
    the one-process port on its slab (its grouped GEMMs handed 4·cap rows,
    the ranks' route; the first decode step also on its own route, each
    MoE layer's top-k of the token compared between the two routes); (c)
    ``LM_RANKS_TRAIN_STEPS`` AdamW steps (lr 3e-4 from the first) at full
    width, 2 layers, global batch 4 x 2048, int8 compression, against
    ``make_train_step(microbatches=4)``, and a sharded checkpoint
    of the parameters. Returns the launches by kernel and route."""
    import concurrent.futures
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    smi = card()
    rng = np.random.default_rng(0)
    full = get_config(arch)
    prompts = [rng.integers(0, full.vocab, size=n).astype(np.int32)
               for n in LM_LENS]
    toks = left_padded(prompts)
    max_len = toks.shape[1] + LM_RANKS_DECODE + 1
    launches = {"flash_attention": {}, "moe_gemm": {}}

    def add(got):
        for kind in launches:
            for k, v in got[kind].items():
                launches[kind][k] = launches[kind].get(k, 0) + v

    # (a) NCCL, a world of one: its rank (~5 GB of the card) runs while
    # the parent computes (b)'s and (c)'s one-process references
    t_a = time.perf_counter()
    cfg_a = dataclasses.replace(full, n_layers=LM_RANKS_NCCL_LAYERS)
    params = init_params(cfg_a, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    refs = greedy_refs(params, cfg_a, dev, toks, 1, LM_RANKS_NCCL_DECODE,
                       max_len)
    del params
    torch.cuda.empty_cache()
    job = {"device": dev.type,
           "serve": {"cfg": cfg_a, "tokens": toks, "max_len": max_len,
                     "steps": LM_RANKS_NCCL_DECODE, "refs": refs,
                     "native": refs}}

    def nccl_world():
        rows, _ = spawn_ranks(1, "nccl", job, target=lm_ranks_worker)
        return [r["serve"] for r in rows], time.perf_counter() - t_a

    pool = concurrent.futures.ThreadPoolExecutor(1)
    nccl = pool.submit(nccl_world)
    pool.shutdown(wait=False)

    # (b) the one-process port on each rank's slab, then 4 gloo ranks
    t0 = time.perf_counter()
    params = init_params(full, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    refs = greedy_refs(params, full, dev, toks, LM_RANKS_GLOO,
                       LM_RANKS_DECODE, max_len, rows_of=LM_RANKS_GLOO,
                       routing=True)
    native = greedy_refs(params, full, dev, toks, LM_RANKS_GLOO, 1, max_len,
                         routing=True)
    plain = greedy_refs(params, full, dev, toks, LM_RANKS_GLOO, 1, max_len,
                        routing=True, plain=True)
    # where the ranks' route, the one-process decode route and the plain
    # float32 GEMMs part: each rank's first decode step routed through each
    witness = []
    for r, n, q in zip(refs, native, plain):
        runs = {"ranks_route": r, "decode_route": n, "plain": q}
        # every grouped GEMM of the kernel routes' first decode step
        w = {f"{k}_gemm": {"calls": len(runs[k]["gemm"]),
                           "outside_tol": sum(not ok for ok, _ in
                                              runs[k]["gemm"]),
                           "max_abs_err": max(e for _, e in runs[k]["gemm"])}
             for k in ("ranks_route", "decode_route")}
        for a, b in (("ranks_route", "decode_route"),
                     ("plain", "ranks_route"), ("plain", "decode_route")):
            w[f"{a}/{b}"] = routing_witness(
                runs[a]["routing"], runs[b]["routing"], full.moe.top_k)
            w[f"{a}/{b}"]["decode1_rel"] = float(
                (runs[a]["decode1"] - runs[b]["decode1"]).abs().max()
                / runs[b]["decode1"].abs().max())
        witness.append(w)
    for run in (*refs, *native):
        del run["routing"], run["gemm"]
    del plain
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t_refs = time.perf_counter() - t0
    serve_job = {"cfg": full, "tokens": toks, "max_len": max_len,
                 "steps": LM_RANKS_DECODE, "refs": refs, "native": native}

    # (c) the one-process oracle: microbatches=4 on the global batch
    t0 = time.perf_counter()
    cfg_c = train_cfg(LM_RANKS_TRAIN_LAYERS)
    get = train_batches(cfg_c, dev, seq=LM_RANKS_TRAIN_SEQ,
                        batch=LM_RANKS_GLOO)
    batches = [{k: v.cpu().numpy() for k, v in get(i).items()}
               for i in range(LM_RANKS_TRAIN_STEPS)]
    check(all((b["labels"] >= 0).all() for b in batches),
          "the training batches mask a label")
    state = init_train_state(cfg_c, train_params(cfg_c, dev), compress=True)
    step = make_train_step(cfg_c, AdamWConfig(**LM_RANKS_OPT),
                           compress_grads=True, microbatches=LM_RANKS_GLOO)
    oracle_metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                for k, v in b.items()})
        oracle_metrics.append({k: float(v) for k, v in m.items()})
    oracle_params = tree_leaves(state.params)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    t_oracle = time.perf_counter() - t0

    rows, t_nccl = nccl.result()
    emit({"phase": "lm_ranks_nccl", "card": smi, "layers": cfg_a.n_layers,
          "batch": list(toks.shape), "seconds": t_nccl, "rank": rows[0]})
    add(lm_serve_checks(rows, cfg_a, LM_RANKS_NCCL_DECODE, "lm_ranks nccl"))

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root, prefix="lm_ranks.") as ckpt:
        job = {"device": dev.type, "serve": serve_job,
               "train": {"cfg": cfg_c, "batches": batches,
                         "oracle": {"metrics": oracle_metrics,
                                    "params": oracle_params},
                         "ckpt_dir": ckpt,
                         "remat_steps": LM_RANKS_REMAT_STEPS}}
        t0 = time.perf_counter()
        per_rank, lowest = spawn_ranks(LM_RANKS_GLOO, "gloo", job,
                                       target=lm_ranks_worker)
        t_ranks = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, files in os.walk(ckpt) for f in files)
    del oracle_params, job
    gc.collect()
    torch.cuda.empty_cache()
    serve = [r["serve"] for r in per_rank]
    train = [r["train"] for r in per_rank]
    emit({"phase": "lm_ranks_serve", "card": smi, "arch": arch,
          "ranks": LM_RANKS_GLOO, "backend": "gloo", "mesh": [1, 4],
          "profile": "ep_dp", "global_batch": list(toks.shape),
          "one_process_init_s": t_init, "one_process_refs_s": t_refs,
          "cross_route_routing": witness, "per_rank": serve})
    emit({"phase": "lm_ranks_train", "card": smi, "arch": arch,
          "layers": cfg_c.n_layers, "ranks": LM_RANKS_GLOO,
          "global_batch": [LM_RANKS_GLOO, LM_RANKS_TRAIN_SEQ],
          "oracle": "make_train_step(microbatches=4), compress_grads, "
                    "AdamWConfig(warmup_steps=1)",
          "oracle_metrics": oracle_metrics, "oracle_s": t_oracle,
          "checkpoint_bytes_on_disk": ckpt_bytes, "per_rank": train})
    add(lm_serve_checks(serve, full, LM_RANKS_DECODE, "lm_ranks gloo"))
    moe_layers = sum(1 for k in full.pattern if k in "AM") * full.n_periods
    for r, (row, w) in enumerate(zip(serve, witness)):
        for k in ("ranks_route_gemm", "decode_route_gemm"):
            check(w[k]["calls"] == 3 * moe_layers
                  and w[k]["outside_tol"] == 0, f"lm_ranks rank {r}'s slab, "
                  f"one process: {k}: a first-decode grouped GEMM off its "
                  f"plain version {w[k]}")
        check(row["decode1_native_rel"] <= LM_RANKS_CROSS_ROUTE_REL
              or w["ranks_route/decode_route"]["flipped_layers"],
              f"lm_ranks gloo rank {r}: the first "
              f"decode step is {row['decode1_native_rel']} of the largest "
              "logit off the one-process decode route with no router "
              "choosing other experts between the two")
    n_moe = cfg_c.n_layers             # every layer of the arch is 'A'
    for r, row in enumerate(train):
        check(row["metrics_ok"], f"lm_ranks train rank {r}: metrics "
              f"{row['metrics']} against the one-process {oracle_metrics}")
        check(row["params_ok"], f"lm_ranks train rank {r}: the parameters "
              f"are {row['param_max_abs_diff']} (mean "
              f"{row['param_mean_abs_diff']}) off the one-process run "
              f"(bounds {row['param_bound']}, {row['param_mean_bound']})")
        # a step: the forward and remat's recompute of each layer
        want_attn = {"tc": 2 * n_moe * LM_RANKS_TRAIN_STEPS, "fp32": 0}
        check(row["flash_attention_route_launches"] == want_attn,
              f"lm_ranks train rank {r}: attention launches "
              f"{row['flash_attention_route_launches']}")
        check(row["moe_gemm_route_launches"]["prefill"]
              == 6 * n_moe * LM_RANKS_TRAIN_STEPS
              and sum(row["moe_gemm_route_launches"].values())
              == row["moe_gemm_route_launches"]["prefill"],
              f"lm_ranks train rank {r}: moe_gemm launches "
              f"{row['moe_gemm_route_launches']}")
        check(row["restored_bitwise"], f"lm_ranks train rank {r}: restore")
        add({"flash_attention": row["flash_attention_route_launches"],
             "moe_gemm": row["moe_gemm_route_launches"]})
        remat_checks(row, oracle_metrics[0], n_moe, f"lm_ranks rank {r}")
        for got in row["remat_steps"].values():
            add({"flash_attention": got["flash_attention_route_launches"],
                 "moe_gemm": got["moe_gemm_route_launches"]})
    emit({"phase": "lm_ranks_remat", "card": smi, "layers": cfg_c.n_layers,
          "steps_from_the_first_state": list(LM_RANKS_REMAT_STEPS),
          "per_rank": [{"block_step1_calls": row["calls_step1"],
                        "block_step_ms": row["step_ms"][0],
                        "block_peak_memory_allocated":
                            row["peak_memory_allocated"],
                        **row["remat_steps"]} for row in train]})
    emit({"phase": "lm_ranks", "card": smi, "ranks_s": t_ranks,
          "lowest_available_host_bytes": lowest,
          "route_launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase 11c: fsdp — parameters ZeRO-sharded over data > 1
# ---------------------------------------------------------------------------

FSDP_ARCH = "musicgen-large"
FSDP_RANKS = 4
# musicgen-large's training steps: each moves 19.35 GB a rank through gloo
# (24–35 s on an H100); a second put the script over its time budget on a
# slower H100 host, so the later steps are checked on qwen2-moe
# (FSDP_MOE_STEPS)
FSDP_STEPS = 1
FSDP_SEQ = 2048                 # one sequence a rank
FSDP_PROMPT = 512               # one prompt a rank
FSDP_DECODE = 2                 # greedy decode steps after the prefill
FSDP_MOE_LAYERS = 2
FSDP_MOE_STEPS = 2
# the largest share of the whole model's parameter and moment bytes a rank
# may hold (a quarter, and the replicated norms)
FSDP_STATE_SHARE = 0.26


def fsdp_wire(cfg, rules):
    """The elements a rank sends to gather every FSDP leaf of the model
    once, its slice to each ``data`` peer: ``(embedding, layers)``. The
    ``fsdp`` kind's bytes are these times the wire's element size."""
    from repro_torch.checkpoint.store import _leaves
    from repro_torch.sharding import fsdp_dim, leaf_pspecs
    from repro_torch.sharding.placement import global_params, spec_axes

    whole = global_params(cfg)
    numel = {path: leaf.numel() for path, leaf in _leaves(whole)}
    peers = rules.fsdp_size - 1
    embed = layers = 0
    for path, spec in leaf_pspecs(whole, rules):
        if fsdp_dim(spec, rules) is None:
            continue
        split = 1
        for e in spec:
            for ax in spec_axes(e):
                split *= rules.axis_size(ax)
        n = peers * numel[path] // split
        if path == "embed":
            embed += n
        else:
            layers += n
    return embed, layers


def fsdp_oracle(dev, cfg, compress, steps, params=None, batch=FSDP_RANKS,
                seq=FSDP_SEQ, microbatches=FSDP_RANKS, seq_blocks=1,
                tp_parts=1):
    """The one-process port's ``make_train_step(microbatches)`` on the
    global batch of ``batch`` x ``seq`` for ``steps`` steps from
    ``params`` (``train_params`` when None; updated in place), the MoE
    routed in ``seq_blocks`` blocks (:func:`seq_blocked_moe`), the layers'
    products as a tp line of ``tp_parts`` computes them
    (:func:`tp_arithmetic`): (batches as numpy, metrics, the parameters' leaves on the card, seconds, peak
    memory). Everything else it held is freed."""
    from repro_torch.train import AdamWConfig, init_train_state, \
        make_train_step
    from repro_torch.train.optimizer import tree_leaves

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    get = train_batches(cfg, dev, seq=seq, batch=batch)
    batches = [{k: v.cpu().numpy() for k, v in get(i).items()}
               for i in range(steps)]
    check(all((b["labels"] >= 0).all() for b in batches),
          "the fsdp training batches mask a label")
    if params is None:
        params = train_params(cfg, dev)
    state = init_train_state(cfg, params, compress=compress)
    del params
    step = make_train_step(cfg, AdamWConfig(**LM_RANKS_OPT),
                           compress_grads=compress, microbatches=microbatches)
    metrics = []
    with seq_blocked_moe(seq_blocks), tp_arithmetic(tp_parts, cfg):
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                    for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    params = tree_leaves(state.params)
    peak = torch.cuda.max_memory_allocated()
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return batches, metrics, params, time.perf_counter() - t0, peak


def fsdp_train_checks(rows, cfg, rules, compress, steps, label,
                      max_share=None):
    """Every rank's training run against the one-process oracle (the
    lm_ranks phase's bounds), its state's share of the whole model's (at
    most ``max_share``, when given), its launches (the forward and remat's
    recompute of each layer) and its ``fsdp`` bytes and calls: each layer
    gathered twice a step in the compute dtype, the float32 embedding
    once, every gradient reduce-scattered in float32."""
    from repro_torch.models.transformer import _fsdp_dims
    from repro_torch.sharding.placement import global_params
    from repro_torch.train.optimizer import tree_leaves

    n = sum(t.numel() for t in tree_leaves(global_params(cfg)))
    whole = n * 4 * (4 if compress else 3)   # params, moments (residual)
    embed, layers = fsdp_wire(cfg, rules)
    n_embed = 1 if embed else 0
    # one gather a layer (its leaves in one transfer)
    n_fsdp = len({path.split("/")[1] for path in _fsdp_dims(cfg, rules)
                  if path != "embed"})
    step_bytes = 4 * embed + 2 * 2 * layers + 4 * (embed + layers)
    step_calls = 2 * (n_embed + n_fsdp) + n_fsdp
    n_attn = sum(1 for k in cfg.pattern if k in "aAl") * cfg.n_periods
    n_moe = sum(1 for k in cfg.pattern if k in "AM") * cfg.n_periods
    for r, row in enumerate(rows):
        check(row["metrics_ok"], f"{label} rank {r}: metrics "
              f"{row['metrics_rel']} off the one-process run")
        check(row["params_ok"], f"{label} rank {r}: the parameters are "
              f"{row['param_max_abs_diff']} (mean "
              f"{row['param_mean_abs_diff']}) off the one-process run "
              f"(bounds {row['param_bound']}, {row['param_mean_bound']})")
        row["whole_state_bytes"] = whole
        row["state_share"] = row["state_bytes_held"] / whole
        check(max_share is None or row["state_share"] <= max_share,
              f"{label} rank {r}: holds {row['state_share']} of the "
              "model's state")
        check(row["flash_attention_route_launches"]
              == {"tc": 2 * n_attn * steps, "fp32": 0},
              f"{label} rank {r}: attention launches "
              f"{row['flash_attention_route_launches']}")
        mg = row["moe_gemm_route_launches"]
        check(mg.get("prefill", 0) == 6 * n_moe * steps
              and sum(mg.values()) == mg.get("prefill", 0),
              f"{label} rank {r}: moe_gemm launches {mg}")
        comm = row["comm_steps"]
        check(len(row["metrics"]) == steps
              and comm["bytes"]["fsdp"] == steps * step_bytes
              and comm["calls"]["fsdp"] == steps * step_calls,
              f"{label} rank {r}: fsdp {comm['bytes']['fsdp']} bytes in "
              f"{comm['calls']['fsdp']} calls, expected "
              f"{steps * step_bytes} in {steps * step_calls}")
    return {"flash_attention": sum_routes(
        r["flash_attention_route_launches"] for r in rows),
        "moe_gemm": sum_routes(r["moe_gemm_route_launches"] for r in rows)}


def spawn_split(rows, start, end):
    """Per rank, where a spawn's wall went (host clock, seconds): from the
    parent's start to the rank's entry (the process, its imports and the
    job's arguments), joining the group, its work, and from its result to
    the parent's last join (the processes' exit)."""
    return [{"start": r["clock"]["entry"] - start,
             "group": r["clock"]["group"] - r["clock"]["entry"],
             "work": r["clock"]["done"] - r["clock"]["group"],
             "end": end - r["clock"]["done"]} for r in rows]


def sum_routes(rows):
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = out.get(k, 0) + v
    return out


def released():
    """Free what this process holds of the card's memory, tensors it shared
    with ranks through CUDA IPC included (they stay allocated here until
    ``ipc_collect`` after the ranks drop them); the bytes still
    allocated."""
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def stand_in_rules(shape, profile):
    """``profile``'s rules on a stand-in ``(data, model)`` mesh of
    ``shape`` (sizes only: no coordinate)."""
    from repro_torch.sharding import ShardingRules

    mesh = type("Mesh", (), {"axis_names": ("data", "model"),
                             "shape": dict(zip(("data", "model"), shape))})()
    return ShardingRules.for_mesh(mesh, profile)


def fsdp_run(pool, job):
    """``job`` on the pool's ranks: (rows, lowest available host memory,
    seconds, the wall's split per rank); the parent's memory released
    after."""
    t0, w0 = time.perf_counter(), time.time()
    rows, lowest = pool.run(job)
    seconds = time.perf_counter() - t0
    split = spawn_split(rows, w0, time.time())
    job.clear()
    released()
    return rows, lowest, seconds, split


def fsdp_musicgen(dev, pool, smi):
    """Part (a) of :func:`phase_fsdp`: the one-process references from the
    float32 masters the ranks draw (each layer cast to bf16, as the ranks'
    gathers cast it), each rank's prompt served, then training from the
    same masters; then the ranks. Returns the launches by kernel and
    route."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(FSDP_ARCH)
    check(cfg.remat == "block", f"remat {cfg.remat}")
    toks = np.random.default_rng(1).integers(0, cfg.vocab,
                                             (FSDP_RANKS, FSDP_PROMPT))
    max_len = FSDP_PROMPT + FSDP_DECODE + 1
    params = train_params(cfg, dev)
    refs = greedy_refs(params, cfg, dev, toks, FSDP_RANKS, FSDP_DECODE,
                       max_len)
    t_refs = time.perf_counter() - t0
    batches, metrics, oracle, t_oracle, oracle_peak = fsdp_oracle(
        dev, cfg, False, FSDP_STEPS, params)
    del params
    held = released()
    rows, lowest, t_ranks, split = fsdp_run(pool, {
        "device": dev.type, "mesh": (FSDP_RANKS, 1), "profile": "dp_only",
        "shared_init": True,
        "serve": {"cfg": cfg, "tokens": toks, "max_len": max_len,
                  "steps": FSDP_DECODE, "refs": refs, "native": refs},
        "train": {"cfg": cfg, "batches": batches, "compress": False,
                  "oracle": {"metrics": metrics, "params": oracle},
                  "ckpt_dir": None}})
    del oracle
    serve = [r["serve"] for r in rows]
    train = [dict(r["train"], init_s=r["init_s"]) for r in rows]
    rules = stand_in_rules((FSDP_RANKS, 1), "dp_only")
    launches = lm_serve_checks(serve, cfg, FSDP_DECODE, "fsdp musicgen")
    embed, layers = fsdp_wire(cfg, rules)
    # float32 masters: the embedding gathered in float32, the layers in bf16
    forward = 4 * embed + 2 * layers
    for r, row in enumerate(serve):
        check(row["tokens_agree"] == row["tokens_total"],
              f"fsdp musicgen rank {r}: {row['tokens_agree']} of "
              f"{row['tokens_total']} greedy tokens as the one-process "
              "port's")
        check(row["comm_prefill"]["bytes"]["fsdp"] == forward
              and row["comm_decode"]["bytes"]["fsdp"]
              == FSDP_DECODE * forward,
              f"fsdp musicgen rank {r}: fsdp bytes "
              f"{row['comm_prefill']['bytes']['fsdp']} / "
              f"{row['comm_decode']['bytes']['fsdp']}, expected {forward} "
              "a forward")
    emit({"phase": "fsdp_musicgen_serve", "card": smi, "arch": FSDP_ARCH,
          "ranks": FSDP_RANKS, "backend": "gloo", "mesh": [FSDP_RANKS, 1],
          "profile": "dp_only", "prompt": [FSDP_RANKS, FSDP_PROMPT],
          "decode_steps": FSDP_DECODE, "one_process_refs_s": t_refs,
          "per_rank": serve})
    trained = fsdp_train_checks(train, cfg, rules, False, FSDP_STEPS,
                                "fsdp musicgen", FSDP_STATE_SHARE)
    emit({"phase": "fsdp_musicgen_train", "card": smi, "arch": FSDP_ARCH,
          "layers": cfg.n_layers, "ranks": FSDP_RANKS,
          "mesh": [FSDP_RANKS, 1], "profile": "dp_only",
          "global_batch": [FSDP_RANKS, FSDP_SEQ],
          "oracle": "make_train_step(microbatches=4), "
                    "AdamWConfig(warmup_steps=1)",
          "oracle_metrics": metrics, "oracle_s": t_oracle,
          "oracle_peak_memory_allocated": oracle_peak,
          "ranks_s": t_ranks, "ranks_split_s": split,
          "lowest_available_host_bytes": lowest,
          "parent_memory_allocated_at_run": held, "per_rank": train})
    return {k: sum_routes([launches[k], trained[k]]) for k in launches}


def fsdp_qwen(dev, pool, smi):
    """Part (b) of :func:`phase_fsdp`: FSDP and expert parallelism together.
    Returns the launches by kernel and route."""
    cfg = train_cfg(FSDP_MOE_LAYERS)
    batches, metrics, oracle, t_oracle, oracle_peak = fsdp_oracle(
        dev, cfg, True, FSDP_MOE_STEPS)
    held = released()
    rows, lowest, t_ranks, split = fsdp_run(pool, {
        "device": dev.type, "mesh": (2, 2), "profile": "ep_dp",
        "train": {"cfg": cfg, "batches": batches, "compress": True,
                  "oracle": {"metrics": metrics, "params": oracle},
                  "ckpt_dir": None}})
    del oracle
    train = [r["train"] for r in rows]
    launches = fsdp_train_checks(train, cfg, stand_in_rules((2, 2), "ep_dp"),
                                 True, FSDP_MOE_STEPS, "fsdp qwen2-moe")
    emit({"phase": "fsdp_qwen_train", "card": smi, "arch": TRAIN_ARCH,
          "layers": cfg.n_layers, "ranks": FSDP_RANKS, "mesh": [2, 2],
          "profile": "ep_dp", "global_batch": [FSDP_RANKS, FSDP_SEQ],
          "oracle": "make_train_step(microbatches=4), compress_grads, "
                    "AdamWConfig(warmup_steps=1)",
          "oracle_metrics": metrics, "oracle_s": t_oracle,
          "oracle_peak_memory_allocated": oracle_peak,
          "ranks_s": t_ranks, "ranks_split_s": split,
          "lowest_available_host_bytes": lowest,
          "parent_memory_allocated_at_run": held, "per_rank": train})
    return launches


def phase_fsdp(dev, pool=None):
    """FSDP over ``data > 1``, in 4 spawned gloo ranks sharing the card (one
    :class:`RankPool`, started first: the ranks import while (a)'s
    references are computed; ``pool``, one the caller keeps for the next
    phase): (a) musicgen-large at full size (48 layers,
    3.22 B parameters, 51.5 GB of float32 state with gradients) under
    ``dp_only`` on a ``(4, 1)`` mesh: ``FSDP_STEPS`` AdamW step (lr 3e-4
    from the first), one sequence of ``FSDP_SEQ`` tokens a rank, against
    the one-process ``make_train_step(microbatches=4)`` on the same global
    batch (run first here, its memory freed before the ranks start);
    before it, from the same float32 masters (each rank its slices of one
    draw, gathered as bf16), a prefill of a ``FSDP_PROMPT``-token prompt a
    rank and ``FSDP_DECODE`` greedy decode steps against the one-process
    port on each rank's prompt; (b) qwen2-moe-a2.7b at full width,
    ``FSDP_MOE_LAYERS`` layers, under ``ep_dp`` on ``(2, 2)`` (FSDP and
    expert parallelism together), ``FSDP_MOE_STEPS`` steps of 4 x ``FSDP_SEQ``
    with int8 compression against ``microbatches=4``. Returns the launches
    by kernel and route."""
    if pool is None:
        with RankPool(FSDP_RANKS, "gloo", target=lm_ranks_worker) as pool:
            return phase_fsdp(dev, pool)
    t_phase = time.perf_counter()
    smi = card()
    released()                  # what an earlier phase's ranks shared
    a = fsdp_musicgen(dev, pool, smi)
    b = fsdp_qwen(dev, pool, smi)
    launches = {k: sum_routes([a[k], b[k]]) for k in a}
    emit({"phase": "fsdp", "card": smi, "route_launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase 11d: tp — tensor and sequence parallelism
# ---------------------------------------------------------------------------

class SplitProduct(torch.Tensor):
    """A weight whose products ``x @ w`` are computed as the ranks of a tp
    line of ``parts`` compute them: by blocks of its columns, joined
    (``dim`` 1: a column-split weight), or as the float32 products of its
    row blocks with ``x``'s column blocks, summed in member order and
    rounded once to ``x``'s dtype (``dim`` 0: a row-split weight,
    ``tensor_parallel.row_parallel``). Every other use sees the plain
    tensor."""

    @staticmethod
    def of(w, parts, dim):
        """``w`` as a split product (the same storage, and attached to
        ``w``'s autograd graph)."""
        t = w.as_subclass(SplitProduct)
        t.parts, t.split_dim = parts, dim
        return t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in ("matmul", "__matmul__") \
                and isinstance(args[1], cls) and not isinstance(args[0], cls):
            x, w = args
            blocks = w.as_subclass(torch.Tensor).chunk(w.parts, w.split_dim)
            if w.split_dim == 1:
                return torch.cat([x @ b.contiguous() for b in blocks], -1)
            acc = None
            for xi, b in zip(x.chunk(w.parts, -1), blocks):
                part = xi.contiguous().float() @ b.contiguous().float()
                acc = part if acc is None else acc + part
            return acc.to(x.dtype)
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def tp_arithmetic(p, cfg):
    """With ``p`` > 1, the one-process model's layer products as the ranks
    of a tp line of ``p`` compute them (:class:`SplitProduct` on each
    weight the rules split over the line), and a decode step's softmax
    over a cache the line splits by sequence as its ranks compute it
    (``attention.sp_part`` of each block, ``sp_combine``): the ranks'
    arithmetic, so that bf16 rounding, which a deep random model
    amplifies (0.07 of the logits on qwen3-8b's 36 layers), is the same on
    both sides (as :func:`gemm_rows` hands the one-process experts the
    ranks' rows). Where ``p`` divides ``cfg``'s mamba heads, also the
    mixer's head-wise work as the ranks compute it: the SSD and the decode
    recurrence on each rank's heads, and the gated norm's float32 sum of
    squares as the ranks' sums added in member order
    (:func:`mamba_tp_arithmetic`)."""
    import repro_torch.models.transformer as tr

    orig = tr._layer_weights
    cols = {"wq", "wk", "wv", "w_up", "w_gate", "w_in"}
    rows = {"wo", "w_down", "w_out"}

    def wrap(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = wrap(v)
            elif k in cols and v.shape[1] % p == 0:
                out[k] = SplitProduct.of(v, p, 1)
            elif k in rows and v.shape[0] % p == 0:
                out[k] = SplitProduct.of(v, p, 0)
            else:
                out[k] = v
        return out

    def decode(params, cfg, x, cache, *, window=0):
        # the softmax over a cache the line splits by sequence as the ranks
        # compute it: each block's part, combined in member order
        if cache.k.shape[1] % p:
            return orig_decode(params, cfg, x, cache, window=window)
        b, pos = x.shape[0], cache.length
        positions = torch.full((b, 1), pos, dtype=torch.long,
                               device=x.device)
        q, k, v = attn_mod._project_qkv(params, cfg, x, positions)
        cache.k[:, pos] = k[:, 0]
        cache.v[:, pos] = v[:, 0]
        span = cache.k.shape[1] // p
        lo = max(0, pos - window + 1) if window > 0 else 0
        clip = lambda i: min(max(i, 0), span)
        parts = [attn_mod.sp_part(q[:, 0], cache.k[:, r * span:(r + 1) * span],
                                  cache.v[:, r * span:(r + 1) * span],
                                  clip(lo - r * span), clip(pos + 1 - r * span),
                                  cfg) for r in range(p)]
        out = attn_mod.sp_combine(torch.stack(parts), q[:, 0].shape)
        out = out.to(x.dtype).reshape(b, 1, -1)
        return out @ params["wo"], cache._replace(length=pos + 1)

    import repro_torch.models.attention as attn_mod
    import repro_torch.models.blocks as blocks_mod

    orig_decode = blocks_mod.attn_decode
    if p > 1:
        tr._layer_weights = lambda lp, cfg, layer: wrap(orig(lp, cfg, layer))
        blocks_mod.attn_decode = decode
    try:
        with mamba_tp_arithmetic(p, cfg):
            yield
    finally:
        tr._layer_weights = orig
        blocks_mod.attn_decode = orig_decode


@contextlib.contextmanager
def mamba_tp_arithmetic(p, cfg):
    """With ``p`` > 1 dividing ``cfg``'s mamba heads: the one-process
    mixer's SSD (``mamba2._ssd_chunked``) and decode recurrence
    (``_recur``) run on ``p`` blocks of the heads, and its gated norm sums
    ``p`` blocks' float32 sums of squares in member order, as
    ``tensor_parallel.line_sum`` does."""
    import torch.nn.functional as F

    import repro_torch.models.mamba2 as mamba_mod

    names = ("_ssd_chunked", "_recur", "_gated_norm")
    orig = {n: getattr(mamba_mod, n) for n in names}

    def ssd(x, da, b, c, chunk):
        outs = [orig["_ssd_chunked"](xi.contiguous(), di.contiguous(), b, c,
                                     chunk)
                for xi, di in zip(x.chunk(p, 2), da.chunk(p, 2))]
        return (torch.cat([o[0] for o in outs], 2),
                torch.cat([o[1] for o in outs], 1))

    def recur(ssm, xdt, decay, b, c):
        outs = [orig["_recur"](*(t.contiguous() for t in parts), b, c)
                for parts in zip(ssm.chunk(p, 1), xdt.chunk(p, 1),
                                 decay.chunk(p, 1))]
        return (torch.cat([o[0] for o in outs], 1),
                torch.cat([o[1] for o in outs], 1))

    def norm(scale, y, z, eps, tp=None, di=0):
        g = y * F.silu(z)
        parts = [c.contiguous().float() for c in g.chunk(p, -1)]
        ss = None
        for gf in parts:
            s = (gf * gf).sum(dim=-1, keepdim=True)
            ss = s if ss is None else ss + s
        var = ss / g.shape[-1]
        return torch.cat([(gf * torch.rsqrt(var + eps) * sc.float())
                          .to(g.dtype)
                          for gf, sc in zip(parts, scale.chunk(p))], -1)

    split = p > 1 and cfg is not None and cfg.ssm is not None \
        and cfg.ssm.n_heads(cfg.d_model) % p == 0
    if split:
        for n, f in zip(names, (ssd, recur, norm)):
            setattr(mamba_mod, n, f)
    try:
        yield
    finally:
        for n in names:
            setattr(mamba_mod, n, orig[n])


TP_ARCH = "qwen3-8b"
TP_RANKS = 4
TP_BATCH = 2                    # the global batch of (a) and (c)
TP_PROMPT = 1024
TP_DECODE = 4                   # (a)'s greedy decode steps
TP_TRAIN_LAYERS = 2
TP_TRAIN_SEQ = 2048             # (b): one sequence a data rank
TP_TRAIN_STEPS = 2
TP_MOE_LAYERS = 2
TP_MOE_DECODE = 2               # (c)'s greedy decode steps
TP_MOE_TRAIN_STEPS = 1
# (d): mamba2-1.3b at full size under serve_tp
TP_MAMBA_PROMPT = 1024
TP_MAMBA_DECODE = 4
# (f): jamba-v0.1-52b at full width, one period (JAMBA_LAYERS), serve_tp
TP_JAMBA_PROMPT = 512
TP_JAMBA_DECODE = 2
# the largest share of the whole model's parameter bytes a rank may hold
# under serve_tp on (1, 4): a quarter, and the replicated norms
TP_PARAM_SHARE = 0.26


def greedy_checks(row, ref, label):
    """The rank's greedy tokens against the one-process port's: where a
    row first differs, the one-process top-2 margin at that step must be
    within twice the logits' tolerance at its largest logit (a near-tie
    the two arithmetics may break apart). Returns the differences."""
    atol, rtol = TOL[torch.bfloat16]
    got, want = torch.tensor(row["tokens"]), ref["tokens"]
    apart = []
    for i in range(got.shape[0]):
        diff = (got[i] != want[i]).nonzero()
        if len(diff):
            j = int(diff[0])
            margin, top = (float(v) for v in ref["margins"][i, j])
            bound = 2 * (atol + rtol * abs(top))
            apart.append({"row": i, "step": j, "one_process_margin": margin,
                          "bound": bound})
            check(margin <= bound, f"{label}: row {i}'s greedy token at "
                  f"step {j} differs from the one-process port's, whose "
                  f"top-2 margin there is {margin} (bound {bound})")
    return apart


def tp_serve_checks(rows, cfg, steps, refs, label, moe_rows=None):
    """Every rank's logits within ``TOL`` of the one-process port's and
    finite, its greedy tokens (:func:`greedy_checks`), its launches: one
    prefill's attention on ``tc``, 3 grouped GEMMs a MoE layer a forward
    on the route of ``moe_rows[phase]`` rows; ``tp`` and ``sp`` transfers
    in both phases, no ``fsdp``. Returns the launches by kernel."""
    from repro_torch.kernels.moe_gemm import kernel as mg

    n_moe = sum(1 for k in cfg.pattern if k in "AM") * cfg.n_periods
    n_attn = sum(1 for k in cfg.pattern if k in "aAl") * cfg.n_periods
    want = dict.fromkeys(mg.ROUTES, 0)
    if n_moe:
        want[mg.route(torch.bfloat16, moe_rows["prefill"])] += 3 * n_moe
        want[mg.route(torch.bfloat16, moe_rows["decode"])] += \
            3 * n_moe * steps
    for r, row in enumerate(rows):
        check(row["prefill_logits_ok"] and row["decode1_logits_ok"]
              and row["finite"], f"{label} rank {r}: logits off the "
              f"one-process port's (prefill {row['prefill_max_abs_err']}, "
              f"decode {row['decode1_max_abs_err']}) or not finite")
        row["tokens_apart"] = greedy_checks(row, refs[r], f"{label} rank {r}")
        check(row["flash_attention_route_launches"] == {"tc": n_attn,
                                                       "fp32": 0},
              f"{label} rank {r}: attention launches "
              f"{row['flash_attention_route_launches']}")
        check(row["moe_gemm_route_launches"] == want,
              f"{label} rank {r}: moe_gemm launches "
              f"{row['moe_gemm_route_launches']}, expected {want}")
        # the KV cache's transfers: k and v move between ranks where the
        # line splits their heads, and a decode step's softmax combines
        # where it splits the cache by sequence (none without attention)
        world = len(rows)
        heads = n_attn > 0 and cfg.n_kv_heads % world == 0
        for part, sp in (("comm_prefill", heads),
                         ("comm_decode", heads or n_attn > 0
                          and row["max_len"] % world == 0)):
            calls = row[part]["calls"]
            check(calls["tp"] > 0 and (calls["sp"] > 0) == sp
                  and calls["fsdp"] == 0, f"{label} rank {r}: {part} "
                  f"transfers by kind {calls}")
    return {"flash_attention": sum_routes(
        r["flash_attention_route_launches"] for r in rows),
        "moe_gemm": sum_routes(r["moe_gemm_route_launches"] for r in rows)}


def tp_qwen3_serve(dev, pool, smi):
    """Part (a) of :func:`phase_tp`: qwen3-8b at full size under
    ``serve_tp`` on ``(1, 4)``, its KV cache split by sequence, and one
    more prefill into a cache of the prompt's length (the dry-run's
    shape); the rows kept in ``MEASURED["tp_a"]`` for
    :func:`phase_dryrun`. Returns the launches by kernel."""
    from repro_torch.configs import get_config

    cfg = get_config(TP_ARCH)
    toks = np.random.default_rng(2).integers(0, cfg.vocab,
                                             (TP_BATCH, TP_PROMPT))
    max_len = TP_PROMPT + TP_DECODE
    check(max_len % TP_RANKS == 0, "the cache is not split by sequence")
    cache = 2 * cfg.n_layers * TP_BATCH * max_len * cfg.n_kv_heads \
        * cfg.hd * 2
    rows, launches = tp_serve_run(dev, pool, smi, "tp_qwen3_serve", cfg,
                                  toks, TP_DECODE, ("cache", cache),
                                  dry_prefill=True)
    MEASURED["tp_a"] = rows          # held against the dry-run
    return launches


def tp_qwen3_train(dev, pool, smi):
    """Part (b) of :func:`phase_tp`: qwen3-8b at full width, 2 layers,
    under ``default`` on ``(2, 2)`` (FSDP over ``data``, TP over
    ``model``). Returns the launches by kernel."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(TP_ARCH), n_layers=TP_TRAIN_LAYERS)
    check(cfg.remat == "block", f"remat {cfg.remat}")
    batches, metrics, oracle, t_oracle, oracle_peak = fsdp_oracle(
        dev, cfg, False, TP_TRAIN_STEPS, batch=2, seq=TP_TRAIN_SEQ,
        microbatches=2, tp_parts=2)
    held = released()
    rows, lowest, t_ranks, split = fsdp_run(pool, {
        "device": dev.type, "mesh": (2, 2), "profile": "default",
        "train": {"cfg": cfg, "batches": batches, "compress": False,
                  "oracle": {"metrics": metrics, "params": oracle},
                  "ckpt_dir": None}})
    del oracle
    train = [r["train"] for r in rows]
    emit({"phase": "tp_qwen3_train", "card": smi, "arch": TP_ARCH,
          "layers": cfg.n_layers, "ranks": TP_RANKS, "mesh": [2, 2],
          "profile": "default", "global_batch": [2, TP_TRAIN_SEQ],
          "oracle": "make_train_step(microbatches=2), "
                    "AdamWConfig(warmup_steps=1), the ranks' products",
          "oracle_metrics": metrics, "oracle_s": t_oracle,
          "oracle_peak_memory_allocated": oracle_peak,
          "ranks_s": t_ranks, "ranks_split_s": split,
          "lowest_available_host_bytes": lowest,
          "parent_memory_allocated_at_run": held, "per_rank": train})
    return fsdp_train_checks(train, cfg, stand_in_rules((2, 2), "default"),
                             False, TP_TRAIN_STEPS, "tp qwen3-8b train")


def tp_qwen_moe(dev, pool, smi):
    """Part (c) of :func:`phase_tp`: qwen2-moe-a2.7b at full width, 2
    layers, under ``ep_sharded`` on ``(1, 4)``: a prefill (the MoE split
    by sequence), decode steps (every rank routes the token; its experts'
    buckets), a training step; the one-process references route the MoE
    as the ranks do (:func:`seq_blocked_moe`). Returns the launches by
    kernel."""
    from repro_torch.models.moe import _capacity

    cfg = train_cfg(TP_MOE_LAYERS)
    toks = np.random.default_rng(3).integers(0, cfg.vocab,
                                             (TP_BATCH, TP_PROMPT))
    # P does not divide it: the cache stays whole on every rank
    max_len = TP_PROMPT + TP_MOE_DECODE
    params = train_params(cfg, dev)
    refs = greedy_refs(params, cfg, dev, toks, 1, TP_MOE_DECODE, max_len,
                       seq_blocks=TP_RANKS, tp_parts=TP_RANKS)
    native = greedy_refs(params, cfg, dev, toks, 1, TP_MOE_DECODE, max_len,
                         seq_blocks=TP_RANKS)
    batches, metrics, oracle, t_oracle, oracle_peak = fsdp_oracle(
        dev, cfg, True, TP_MOE_TRAIN_STEPS, params, batch=TP_BATCH,
        seq=TP_PROMPT, microbatches=1, seq_blocks=TP_RANKS,
        tp_parts=TP_RANKS)
    del params
    held = released()
    rows, lowest, t_ranks, split = fsdp_run(pool, {
        "device": dev.type, "mesh": (1, TP_RANKS), "profile": "ep_sharded",
        "shared_init": True,
        "serve": {"cfg": cfg, "tokens": toks, "max_len": max_len,
                  "steps": TP_MOE_DECODE, "refs": refs * TP_RANKS,
                  "native": native * TP_RANKS},
        "train": {"cfg": cfg, "batches": batches, "compress": True,
                  "oracle": {"metrics": metrics, "params": oracle},
                  "ckpt_dir": None}})
    del oracle
    serve = [r["serve"] for r in rows]
    train = [dict(r["train"], init_s=r["init_s"]) for r in rows]
    emit({"phase": "tp_qwen_moe", "card": smi, "arch": TRAIN_ARCH,
          "layers": cfg.n_layers, "ranks": TP_RANKS, "mesh": [1, TP_RANKS],
          "profile": "ep_sharded", "prompt": [TP_BATCH, TP_PROMPT],
          "decode_steps": TP_MOE_DECODE, "max_len": max_len,
          "oracle": "the one-process port, the MoE routed in 4 sequence "
                    "blocks where 4 divides the sequence, with the ranks' "
                    "products; training make_train_step("
                    "microbatches=1), compress_grads, "
                    "AdamWConfig(warmup_steps=1)",
          "oracle_metrics": metrics, "oracle_s": t_oracle,
          "oracle_peak_memory_allocated": oracle_peak,
          "ranks_s": t_ranks, "ranks_split_s": split,
          "lowest_available_host_bytes": lowest,
          "parent_memory_allocated_at_run": held,
          "per_rank_serve": serve, "per_rank_train": train})
    block = TP_BATCH * TP_PROMPT // TP_RANKS
    served = tp_serve_checks(
        serve, cfg, TP_MOE_DECODE, refs * TP_RANKS, "tp qwen2-moe serve",
        {"prefill": TP_RANKS * _capacity(cfg.moe, block),
         "decode": _capacity(cfg.moe, TP_BATCH)})
    for r, row in enumerate(serve):
        check(row["comm_prefill"]["calls"]["a2a"] > 0
              and row["comm_decode"]["calls"]["a2a"] == 0,
              f"tp qwen2-moe rank {r}: the prefill's MoE off the "
              "all-to-all or a decode step's on it")
    trained = fsdp_train_checks(train, cfg, stand_in_rules((1, TP_RANKS),
                                                           "ep_sharded"),
                                True, TP_MOE_TRAIN_STEPS,
                                "tp qwen2-moe train")
    return {k: sum_routes([served[k], trained[k]]) for k in served}


def tp_serve_run(dev, pool, smi, phase, cfg, toks, steps, split=None,
                 moe_rows=None, check_every=False, dry_prefill=False):
    """``cfg`` (bf16 weights from the seeded generator) served under
    ``serve_tp`` on ``(1, TP_RANKS)``: a prefill of ``toks`` and ``steps``
    greedy decode steps on every rank, against the one-process port
    computing its products as the ranks do (``refs``) and the plain one
    (``native``, reported), both released before the ranks run; with
    ``check_every``, every kernel launch of the ranks held against its
    plain version. Emits the ``phase`` record, then checks
    (:func:`tp_serve_checks` with ``moe_rows``) that a rank holds at most
    ``TP_PARAM_SHARE`` of the weights and, for ``split`` ``(name, whole
    bytes)``, a ``TP_RANKS``-th of its ``<name>_bytes``. With
    ``dry_prefill``, each rank also runs one more prefill into a cache of
    the prompt's length, the dry-run's shape (``lm_ranks_serve``), whose
    launches the returned ones include. Returns (the rows, the launches by
    kernel)."""
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import tree_leaves

    t0 = time.perf_counter()
    max_len = toks.shape[1] + steps
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.bfloat16)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    refs = greedy_refs(params, cfg, dev, toks, 1, steps, max_len,
                       tp_parts=TP_RANKS) * TP_RANKS
    native = greedy_refs(params, cfg, dev, toks, 1, steps, max_len)
    del params
    t_refs = time.perf_counter() - t0
    held = released()
    rows, lowest, t_ranks, times = fsdp_run(pool, {
        "device": dev.type, "mesh": (1, TP_RANKS), "profile": "serve_tp",
        "serve": {"cfg": cfg, "tokens": toks, "max_len": max_len,
                  "steps": steps, "refs": refs,
                  "native": native * TP_RANKS,
                  "check_every": check_every, "dry_prefill": dry_prefill}})
    serve = [r["serve"] for r in rows]
    extra = {}
    for row in serve:
        row["param_share"] = row["param_bytes_held"] / whole
        if split:
            row[f"{split[0]}_share"] = row[f"{split[0]}_bytes"] / split[1]
            extra = {f"one_process_{split[0]}_bytes": split[1]}
    emit({"phase": phase, "card": smi, "arch": cfg.name,
          "layers": cfg.n_layers, "ranks": TP_RANKS, "backend": "gloo",
          "mesh": [1, TP_RANKS], "profile": "serve_tp",
          "prompt": list(toks.shape), "decode_steps": steps,
          "max_len": max_len, "model_bytes": whole, **extra,
          "one_process_refs_s": t_refs, "ranks_s": t_ranks,
          "ranks_split_s": times, "lowest_available_host_bytes": lowest,
          "parent_memory_allocated_at_run": held,
          "one_process_native_tokens": native[0]["tokens"].tolist(),
          "per_rank": serve})
    label = f"tp {cfg.name} serve_tp"
    launches = tp_serve_checks(serve, cfg, steps, refs, label, moe_rows)
    for r, row in enumerate(serve):
        check(row["param_share"] <= TP_PARAM_SHARE, f"{label} rank {r}: "
              f"holds {row['param_share']} of the model's parameter bytes")
        if split:
            got = row[f"{split[0]}_bytes"]
            check(got * TP_RANKS == split[1], f"{label} rank {r}: {got} "
                  f"bytes of {split[0]}, the one process's {split[1]}")
        if dry_prefill:
            extra = row["dry_prefill"]
            n_attn = sum(1 for k in cfg.pattern if k in "aAl") \
                * cfg.n_periods
            check(extra["flash_attention_route_launches"]
                  == {"tc": n_attn, "fp32": 0}, f"{label} rank {r}: the "
                  f"dry-run-shaped prefill's attention launches "
                  f"{extra['flash_attention_route_launches']}")
            for kind in launches:
                launches[kind] = sum_routes(
                    [launches[kind], extra[f"{kind}_route_launches"]])
    return serve, launches


def tp_mamba_serve(dev, pool, smi):
    """Part (d) of :func:`phase_tp`: mamba2-1.3b at full size under
    ``serve_tp`` on ``(1, 4)``: each rank computes its 16 of the 64 heads
    a layer and holds their SSM state. The plain one-process port's logits
    are reported beside (``*_native_*``): 48 random bf16 layers turn the
    ranks' other rounding (float32 partial sums) into 0.27 of a largest
    logit of ~4.4 (an H100), beyond ``TOL``, so the logits are held
    against the oracle computing as the ranks do. Returns the launches by
    kernel (none: no attention or MoE layer)."""
    from repro_torch.configs import get_config

    cfg = get_config(MAMBA_ARCH)
    toks = np.random.default_rng(4).integers(0, cfg.vocab,
                                             (TP_BATCH, TP_MAMBA_PROMPT))
    s = cfg.ssm
    ssm = cfg.n_layers * TP_BATCH * s.n_heads(cfg.d_model) * s.head_dim \
        * s.d_state * 4
    return tp_serve_run(dev, pool, smi, "tp_mamba_serve", cfg, toks,
                        TP_MAMBA_DECODE, ("ssm", ssm))[1]


def tp_mamba_train(dev, pool, smi):
    """Part (e) of :func:`phase_tp`: mamba2-1.3b at full width, 2 layers,
    under ``default`` on ``(2, 2)`` (FSDP over ``data``, the mixer's heads
    over ``model``). Returns the launches by kernel."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MAMBA_ARCH),
                              n_layers=TP_TRAIN_LAYERS)
    check(cfg.remat == "block", f"remat {cfg.remat}")
    batches, metrics, oracle, t_oracle, oracle_peak = fsdp_oracle(
        dev, cfg, False, TP_TRAIN_STEPS, batch=2, seq=TP_TRAIN_SEQ,
        microbatches=2, tp_parts=2)
    held = released()
    rows, lowest, t_ranks, split = fsdp_run(pool, {
        "device": dev.type, "mesh": (2, 2), "profile": "default",
        "train": {"cfg": cfg, "batches": batches, "compress": False,
                  "oracle": {"metrics": metrics, "params": oracle},
                  "ckpt_dir": None}})
    del oracle
    train = [r["train"] for r in rows]
    emit({"phase": "tp_mamba_train", "card": smi, "arch": MAMBA_ARCH,
          "layers": cfg.n_layers, "ranks": TP_RANKS, "mesh": [2, 2],
          "profile": "default", "global_batch": [2, TP_TRAIN_SEQ],
          "oracle": "make_train_step(microbatches=2), "
                    "AdamWConfig(warmup_steps=1), the ranks' products",
          "oracle_metrics": metrics, "oracle_s": t_oracle,
          "oracle_peak_memory_allocated": oracle_peak,
          "ranks_s": t_ranks, "ranks_split_s": split,
          "lowest_available_host_bytes": lowest,
          "parent_memory_allocated_at_run": held, "per_rank": train})
    return fsdp_train_checks(train, cfg, stand_in_rules((2, 2), "default"),
                             False, TP_TRAIN_STEPS, "tp mamba2 train")


def tp_jamba_serve(dev, pool, smi):
    """Part (f) of :func:`phase_tp`: jamba-v0.1-52b at full width, one
    period, under ``serve_tp`` on ``(1, 4)``: its mamba layers by heads,
    its attention layer by heads (``tc`` at 8 query and 2 kv heads a
    rank), its MoE layers by experts (4 of 16 a rank on ``moe_gemm``).
    Every ``tc`` and ``moe_gemm`` launch of the ranks is held against its
    plain version at the rank's shapes. Returns the launches by kernel and
    the largest error by route."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import _capacity

    cfg = dataclasses.replace(get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS)
    toks = np.random.default_rng(5).integers(0, cfg.vocab,
                                             (TP_BATCH, TP_JAMBA_PROMPT))
    serve, launches = tp_serve_run(
        dev, pool, smi, "tp_jamba_serve", cfg, toks, TP_JAMBA_DECODE,
        moe_rows={"prefill": _capacity(cfg.moe, TP_BATCH * TP_JAMBA_PROMPT),
                  "decode": _capacity(cfg.moe, TP_BATCH)},
        check_every=True)
    errs = {}
    for r, row in enumerate(serve):
        made = {k: v for k, v in {**row["flash_attention_route_launches"],
                                  **row["moe_gemm_route_launches"]}.items()
                if v}
        checked = row["launches_checked"]
        check({k: v[0] for k, v in checked.items()} == made
              and all(v[1] == 0 for v in checked.values()),
              f"tp jamba rank {r}: launches held against the plain "
              f"versions {checked} (route: calls, failures, largest "
              f"error), launched {made}")
        for k, v in checked.items():
            errs[k] = max(errs.get(k, 0.0), v[2])
    return launches, errs


def phase_tp(dev, pool=None):
    """Tensor and sequence parallelism (the ``default``, ``serve_tp`` and
    ``ep_sharded`` profiles) on 4 gloo ranks sharing the card (``pool``:
    :func:`phase_fsdp`'s ranks): (a) qwen3-8b at full size (36 layers,
    15.1 GB of bf16 weights, a quarter a rank) under ``serve_tp`` on
    ``(1, 4)``: a prefill of 2 x ``TP_PROMPT`` tokens into a cache split by
    sequence, ``TP_DECODE`` greedy decode steps; (b) qwen3-8b at full
    width, 2 layers, under ``default`` on ``(2, 2)``: ``TP_TRAIN_STEPS``
    AdamW steps of one ``TP_TRAIN_SEQ``-token sequence a data rank against
    ``microbatches=2``; (c) qwen2-moe-a2.7b at full width, 2 layers, under
    ``ep_sharded`` on ``(1, 4)``: a prefill (the MoE split by sequence)
    into a cache that stays whole, ``TP_MOE_DECODE`` decode steps and a
    training step; (d) mamba2-1.3b at full size (48 layers, a quarter of
    the heads and their SSM state a rank) under ``serve_tp`` on ``(1,
    4)``: a prefill of 2 x ``TP_MAMBA_PROMPT`` tokens, ``TP_MAMBA_DECODE``
    greedy decode steps; (e) mamba2-1.3b at full width, 2 layers, under
    ``default`` on ``(2, 2)``: as (b); (f) jamba-v0.1-52b at full width,
    one period, under ``serve_tp`` on ``(1, 4)``: a prefill of 2 x
    ``TP_JAMBA_PROMPT`` tokens, ``TP_JAMBA_DECODE`` greedy decode steps,
    every kernel launch held against its plain version. Each against the
    one-process port, whose memory is released before the ranks run.
    Returns the launches by kernel and route, and (f)'s largest kernel
    errors by route."""
    if pool is None:
        with RankPool(TP_RANKS, "gloo", target=lm_ranks_worker) as pool:
            return phase_tp(dev, pool)
    t_phase = time.perf_counter()
    smi = card()
    released()
    parts, times = [], {}
    for name, run in (("a", tp_qwen3_serve), ("b", tp_qwen3_train),
                      ("c", tp_qwen_moe), ("d", tp_mamba_serve),
                      ("e", tp_mamba_train)):
        t0 = time.perf_counter()
        parts.append(run(dev, pool, smi))
        times[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    jamba, errs = tp_jamba_serve(dev, pool, smi)
    times["f"] = time.perf_counter() - t0
    parts.append(jamba)
    launches = {k: sum_routes([p[k] for p in parts]) for k in parts[0]}
    emit({"phase": "tp", "card": smi, "route_launches": launches,
          "jamba_launch_max_abs_err": errs, "part_seconds": times,
          "seconds": time.perf_counter() - t_phase})
    return launches, errs


# ---------------------------------------------------------------------------
# phase 10b: the training path
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-moe-a2.7b"
# 4 of the 24 layers: float32 masters, their gradients and two AdamW moments
# take 16 bytes a parameter, 43.7 GB at 4 layers (2.73 B parameters), 237 GB
# at 24
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 2, 4096        # SHAPES["train_4k"]'s sequence
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_KILL_AT = 6, 3, 4
# the first steps again under remat "dots", beside the block run's
TRAIN_DOTS_STEPS = 2
# the checkpointed run (kill and resume) is the same model cut to 1 layer:
# the 4-layer state is 32.8 GB, a checkpoint of it took 42 s to write and
# 59 s to read back beside an H100, whose machine took at most 45 GiB of
# disk writes a run; 1 layer is 11 GB
TRAIN_RESUME_LAYERS = 1
# gradients of the Functions against autograd through the plain versions:
# both backward passes compute in float32 from the same inputs (the
# attention's as a chunked online softmax, the plain one's as a full
# softmax), so they differ by float32 rounding and then, in bf16, by one
# rounding of the result: the forward tolerances hold for them
GRAD_TOL = TOL
MOE_GRAD_TOL = MOE_TOL
# the full-width step through the plain versions: bf16 activations rounded
# in other places (the kernel rounds P to bf16 before PV; the plain version
# rounds only its output) over 4 layers, averaged over 8192 tokens
TRAIN_PLAIN_LOSS_RTOL = 2e-3
TRAIN_PLAIN_GNORM_RTOL = 2e-2
# the float32 check: the split-TF32 kernels agree with the plain versions
# to ~1e-6 a call; a token whose router scores sit at a top-4 near-tie is
# the one place a gradient could move more
F32_LOSS_RTOL = 1e-4
F32_GRAD_REL = 1e-3


class TrainKilled(Exception):
    """Raised by the batch function to kill a training run."""


def train_cfg(layers=TRAIN_LAYERS, dtype="bfloat16"):
    """qwen2-moe-a2.7b at its published width, cut to ``layers`` layers;
    ``remat="block"`` (the config's default), compute in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=layers,
                              dtype=dtype)
    check(cfg.remat == "block", f"remat {cfg.remat}")
    return cfg


def train_params(cfg, dev, seed=0):
    """Float32 master weights from a seeded generator: the same every
    call."""
    from repro_torch.models import init_params

    return init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                       device=dev, dtype=torch.float32)


def train_state(cfg, dev, seed=0):
    """``train_params`` and AdamW's zero moments."""
    from repro_torch.train import init_train_state

    return init_train_state(cfg, train_params(cfg, dev, seed))


def train_batches(cfg, dev, seq=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0):
    from repro_torch.data import SyntheticLMDataset

    ds = SyntheticLMDataset(cfg.vocab, seq, batch, seed=seed)

    def get(step):
        out = {k: torch.from_numpy(v).to(dev)
               for k, v in ds.batch(step).items()}
        out["tokens"] = out["tokens"].long()
        return out
    return get


def host_leaves(tree):
    from repro_torch.train.optimizer import tree_leaves

    return [t.detach().to("cpu", copy=True) for t in tree_leaves(tree)]


def same_leaves(tree, host):
    """Bitwise, leaf by leaf, against host copies; the first differing
    leaf's index and largest difference, or None."""
    from repro_torch.train.optimizer import tree_leaves

    for i, (t, h) in enumerate(zip(tree_leaves(tree), host)):
        got = t.detach().to("cpu")
        if not bitwise(got, h):
            return {"leaf": i, "shape": list(h.shape),
                    "max_abs_diff": float((got - h).abs().max())}
    return None


def attention_fn_case(name, dev, b, s, hq, hkv, dtype, window=0, softcap=0.0):
    """``multihead_attention``'s Function (the route's kernel forward, the
    plain chunked recompute backward) against autograd through ``mha_ref``
    on the card: output and (dq, dk, dv)."""
    from repro_torch.kernels.flash_attention import multihead_attention
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ref import mha_ref

    g = torch.Generator(device=dev).manual_seed(s + hkv)
    d = 128
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev, dtype=dtype)
               for h in (hq, hkv, hkv))
    up = torch.randn(b, s, hq, d, generator=g, device=dev, dtype=dtype)
    scale = d ** -0.5

    def run(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        return [out.detach()] + list(torch.autograd.grad(out, ins, up))

    t0 = time.perf_counter()
    got = run(lambda *t: multihead_attention(*t, scale, True, window,
                                             softcap))
    torch.cuda.synchronize()
    fn_s = time.perf_counter() - t0
    want = run(lambda *t: mha_ref(*t, scale=scale, causal=True,
                                  window=window, softcap=softcap))
    errs = {}
    for label, a, w, tol in zip(("out", "dq", "dk", "dv"), got, want,
                                (TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        ok, errs[label] = within(a, w, *tol[dtype])
        check(ok and bool(torch.isfinite(a).all()),
              f"attention Function {name}: {label} off the plain version's "
              f"autograd by {errs[label]}")
    return {"case": name, "shape": [b, s, hq, hkv, d], "dtype": str(dtype),
            "route": route(dtype, d), "window": window, "softcap": softcap,
            "max_abs_err": errs, "function_s": fn_s}


def moe_fn_case(name, dev, e, cap, d, f, dtype):
    """``grouped_gemm``'s Function (the route's kernel forward, the float32
    einsum backward) against autograd through ``moe_gemm_ref`` on the card,
    with ``rows`` below capacity in some experts: output and (dx, dw)."""
    from repro_torch.kernels.moe_gemm import grouped_gemm
    from repro_torch.kernels.moe_gemm.kernel import route
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

    g = torch.Generator(device=dev).manual_seed(d + f)
    x = torch.randn(e, cap, d, generator=g, device=dev, dtype=dtype)
    w = (torch.randn(e, d, f, generator=g, device=dev) * d ** -0.5).to(dtype)
    up = torch.randn(e, cap, f, generator=g, device=dev, dtype=dtype)
    rows = torch.randint(0, cap + 1, (e,), generator=g, device=dev,
                         dtype=torch.int32)
    rows[::4] = cap                      # every fourth expert full
    rows[1] = 0                          # one empty

    def run(fn):
        ins = [x.clone().requires_grad_(), w.clone().requires_grad_()]
        out = fn(*ins, rows)
        return [out.detach()] + list(torch.autograd.grad(out, ins, up))

    got, want = run(grouped_gemm), run(moe_gemm_ref)
    errs = {}
    for label, a, b, tol in zip(("out", "dx", "dw"), got, want,
                                (MOE_TOL, MOE_GRAD_TOL, MOE_GRAD_TOL)):
        ok, errs[label] = within(a, b, *tol[dtype])
        check(ok and bool(torch.isfinite(a).all()),
              f"grouped_gemm Function {name}: {label} off the plain "
              f"version's autograd by {errs[label]}")
    return {"case": name, "x": [e, cap, d], "w": [e, d, f],
            "dtype": str(dtype), "route": route(dtype, cap),
            "live_rows": int(rows.sum()), "max_abs_err": errs}


def train_function_checks(dev):
    bf, f32 = torch.bfloat16, torch.float32
    attn = [attention_fn_case("bf16", dev, 2, 4096, 16, 16, bf),
            attention_fn_case("bf16_gqa", dev, 2, 4096, 16, 4, bf),
            attention_fn_case("bf16_window_softcap", dev, 2, 4096, 16, 16,
                              bf, window=1024, softcap=50.0),
            attention_fn_case("f32", dev, 1, 1024, 16, 16, f32)]
    torch.cuda.empty_cache()
    moe = [moe_fn_case(f"{p}_{str(dt)[6:]}", dev, 64, 640, d, f, dt)
           for dt in (bf, f32)
           for p, d, f in (("up", 2048, 1408), ("down", 1408, 2048))]
    torch.cuda.empty_cache()
    return attn, moe


class TimedStep:
    """The train step with CUDA events around it and its kernel launches by
    route: the counts set to 0 just before the step and read just after."""

    def __init__(self, step_fn):
        self.fn = step_fn
        self.rows = []
        self.after = None

    def __call__(self, state, batch):
        from repro_torch.kernels.flash_attention import kernel as fa
        from repro_torch.kernels.moe_gemm import kernel as mg

        fa.reset_launches()
        mg.reset_launches()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, metrics = self.fn(state, batch)
        e1.record()
        self.rows.append({
            "events": (e0, e1),
            "flash_attention": dict(fa.flash_attention.route_launches),
            "moe_gemm": dict(mg.moe_gemm.route_launches)})
        if self.after is not None:
            self.after(state)
            self.after = None
        return state, metrics

    def launches(self):
        out = {"flash_attention": dict.fromkeys(("tc", "fp32"), 0),
               "moe_gemm": dict.fromkeys(("prefill", "decode", "fp32"), 0)}
        for r in self.rows:
            for kern in out:
                for route, n in r[kern].items():
                    out[kern][route] += n
        return out


def run_logged(runner, batches, steps):
    """``runner.run`` logging every step's metrics as floats."""
    logged = {}
    runner.run(batches, steps, log_every=1,
               log_fn=lambda s, m: logged.__setitem__(s, m))
    return logged


def train_uninterrupted(dev, cfg, step_fn, batches):
    """(1) The full-width run: ``TRAIN_STEPS`` steps through
    ``TrainLoopRunner`` (no checkpoint), each step timed by CUDA events with
    its launches by route; every metric finite, the launch counts exact.
    Returns the emitted row, the launches, every step's metrics and the
    host copy of the parameters after step 0."""
    from repro_torch.runtime import TrainLoopRunner
    from repro_torch.train.optimizer import tree_leaves

    n_attn = n_moe = cfg.n_layers                  # every layer is 'A'
    want = {"flash_attention": {"tc": 2 * n_attn, "fp32": 0},
            "moe_gemm": {"prefill": 6 * n_moe, "decode": 0, "fp32": 0}}
    out = {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "experts_padded": cfg.moe.n_experts_padded,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": cfg.remat,
           "compute_dtype": cfg.dtype, "launches_per_step_expected": want}
    t0 = time.perf_counter()
    state = train_state(cfg, dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(t.numel() for t in tree_leaves(state.params))
    out["state_bytes"] = sum(t.numel() * t.element_size()
                             for t in tree_leaves(state))
    snap = {}
    timed = TimedStep(step_fn)
    timed.after = lambda st: snap.__setitem__("params",
                                              host_leaves(st.params))
    torch.cuda.reset_peak_memory_stats()
    runner = TrainLoopRunner(timed, state, os.path.join(
        str(Path(__file__).resolve().parent / "build"), "train_no_ckpt"),
        ckpt_every=10 ** 9)
    t0 = time.perf_counter()
    whole = run_logged(runner, batches, TRAIN_STEPS)
    out["run_wall_s"] = time.perf_counter() - t0
    out["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
    step_ms = [e0.elapsed_time(e1) for e0, e1 in
               (r["events"] for r in timed.rows)]
    for i, r in enumerate(timed.rows):
        got = {k: r[k] for k in want}
        check(got == want, f"train step {i}: launches {got}, expected "
              f"{want} a step")
    for s, m in whole.items():
        check(all(np.isfinite(v) for v in m.values()),
              f"train step {s}: a metric is not finite: {m}")
    out["step_ms"] = step_ms
    steady = float(np.mean(step_ms[1:]))
    out["step_ms_mean_after_first"] = steady
    out["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (steady / 1e3)
    out["losses"] = [whole[s]["loss/total"] for s in sorted(whole)]
    out["grad_norms"] = [whole[s]["opt/grad_norm"] for s in sorted(whole)]
    out["straggler_summary"] = runner.stats.summary()
    return out, timed.launches(), whole, snap["params"]


def train_repeat_first(dev, cfg, step_fn, batches, whole, snap):
    """(2) The same first step again from the same state: bitwise?"""
    state = train_state(cfg, dev)
    again_state, again = step_fn(state, batches(0))
    diff = same_leaves(again_state.params, snap)
    same_metrics = (float(again["loss/total"]) == whole[0]["loss/total"]
                    and float(again["opt/grad_norm"])
                    == whole[0]["opt/grad_norm"])
    return {"bitwise": diff is None and same_metrics,
            "first_differing_leaf": diff, "metrics_equal": same_metrics,
            "loss": float(again["loss/total"]),
            "grad_norm": float(again["opt/grad_norm"])}


def train_dots(dev, cfg, batches, whole, block):
    """(2') Remat ``"dots"``: ``TRAIN_DOTS_STEPS`` steps from the same state
    and batches as the block run (``whole``, its metrics; ``block``, its
    row): the launches a step (the hand kernels recomputed, as under
    block), the losses and gradient norms against block's within the
    training bounds (and whether they are bitwise), step ms and peak memory
    beside block's. Returns the row and the launches."""
    import dataclasses

    from repro_torch.train import AdamWConfig, make_train_step

    timed = TimedStep(make_train_step(dataclasses.replace(cfg, remat="dots"),
                                      AdamWConfig()))
    state = train_state(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    for i in range(TRAIN_DOTS_STEPS):
        state, m = timed(state, batches(i))
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del state
    want = block["launches_per_step_expected"]
    for i, r in enumerate(timed.rows):
        got = {k: r[k] for k in want}
        check(got == want, f"train dots step {i}: launches {got}, expected "
              f"{want}")
    rel = []
    for i, m in enumerate(metrics):
        b = whole[i]
        r = {k: abs(m[k] - b[k]) / abs(b[k])
             for k in ("loss/total", "opt/grad_norm")}
        tol = LM_RANKS_FIRST_LOSS_RTOL if i == 0 else LM_RANKS_LOSS_RTOL
        check(r["loss/total"] <= tol
              and r["opt/grad_norm"] <= LM_RANKS_GNORM_RTOL,
              f"train dots step {i}: loss {m['loss/total']}, grad norm "
              f"{m['opt/grad_norm']} against block's {b['loss/total']}, "
              f"{b['opt/grad_norm']}")
        rel.append(r)
    step_ms = [e0.elapsed_time(e1) for e0, e1 in
               (r["events"] for r in timed.rows)]
    return {"remat": "dots", "steps": TRAIN_DOTS_STEPS,
            "losses": [m["loss/total"] for m in metrics],
            "grad_norms": [m["opt/grad_norm"] for m in metrics],
            "block_losses": [whole[i]["loss/total"]
                             for i in range(TRAIN_DOTS_STEPS)],
            "block_grad_norms": [whole[i]["opt/grad_norm"]
                                 for i in range(TRAIN_DOTS_STEPS)],
            "rel_diff": rel,
            "bitwise_block": all(
                m["loss/total"] == whole[i]["loss/total"]
                and m["opt/grad_norm"] == whole[i]["opt/grad_norm"]
                for i, m in enumerate(metrics)),
            "step_ms": step_ms, "block_step_ms": block["step_ms"],
            "peak_memory_allocated": peak,
            "block_peak_memory_allocated": block["peak_memory_allocated"]}, \
        timed.launches()


def train_kill_resume(dev, kdir, deterministic):
    """(3) At ``TRAIN_RESUME_LAYERS`` layers: an uninterrupted run of
    ``TRAIN_STEPS`` steps, then a run killed by its batch function at step
    ``TRAIN_KILL_AT``, checkpointed every ``TRAIN_CKPT_EVERY`` steps,
    resumed in a new runner from its last checkpoint (copied into the
    killed run's state in place) to step ``TRAIN_STEPS``: its losses and
    parameters against the uninterrupted run's, bitwise when a step repeats
    bitwise. The resumed run saves no checkpoint of its own (it would cost
    15 s and 11 GB of disk writes)."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.runtime import TrainLoopRunner
    from repro_torch.train import AdamWConfig, make_train_step

    cfg = train_cfg(TRAIN_RESUME_LAYERS)
    step_fn = make_train_step(cfg, AdamWConfig())
    batches = train_batches(cfg, dev)
    runner = TrainLoopRunner(step_fn, train_state(cfg, dev), os.path.join(
        kdir, "uninterrupted"), ckpt_every=10 ** 9)
    whole = run_logged(runner, batches, TRAIN_STEPS)
    final = host_leaves(runner.state.params)
    del runner
    torch.cuda.empty_cache()

    def killing(step):
        if step == TRAIN_KILL_AT:
            raise TrainKilled(f"killed at step {step}")
        return batches(step)

    runner = TrainLoopRunner(step_fn, train_state(cfg, dev), kdir,
                             ckpt_every=TRAIN_CKPT_EVERY)
    save, saves = runner.manager.save, []

    def timed_save(step, tree):
        t0 = time.perf_counter()
        save(step, tree)
        saves.append((t0, time.perf_counter() - t0))
    runner.manager.save = timed_save
    t0 = time.perf_counter()
    try:
        runner.run(killing, TRAIN_STEPS, log_every=1)
        check(False, "the batch function's kill did not surface")
    except TrainKilled:
        pass
    runner.manager.wait()
    t_end = time.perf_counter()
    check(latest_step(kdir) == TRAIN_CKPT_EVERY and len(saves) == 1,
          f"the killed run's last checkpoint is {latest_step(kdir)}")
    out = {"layers": cfg.n_layers, "killed_at": TRAIN_KILL_AT,
           "resumed_from": TRAIN_CKPT_EVERY,
           "killed_run_s": t_end - t0,
           "save_host_copy_s": saves[0][1],
           "save_to_written_s": t_end - saves[0][0],
           "checkpoint_bytes_on_disk": sum(
               os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(kdir) for f in files)}
    template = runner.state
    del runner
    t0 = time.perf_counter()
    resumed_runner = TrainLoopRunner(step_fn, template, kdir,
                                     ckpt_every=10 ** 9)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    check(resumed_runner.start_step == TRAIN_CKPT_EVERY,
          f"resumed at {resumed_runner.start_step}")
    t0 = time.perf_counter()
    resumed = run_logged(resumed_runner, batches,
                         TRAIN_STEPS - TRAIN_CKPT_EVERY)
    out["resumed_run_s"] = time.perf_counter() - t0
    diff = same_leaves(resumed_runner.state.params, final)
    loss_diff = {s: resumed[s]["loss/total"] - whole[s]["loss/total"]
                 for s in resumed}
    out.update({"losses": [resumed[s]["loss/total"] for s in
                           sorted(resumed)],
                "loss_diff": loss_diff,
                "params_first_differing_leaf": diff,
                "bitwise": diff is None
                and all(v == 0.0 for v in loss_diff.values())})
    if deterministic:
        check(out["bitwise"], f"the resumed run differs from the "
              f"uninterrupted one: {diff}, loss diffs {loss_diff}")
    else:
        check(all(abs(v) <= 1e-3 * abs(whole[s]["loss/total"])
                  for s, v in loss_diff.items()),
              f"the resumed run's losses differ: {loss_diff}")
    return out


def train_plain_first(dev, cfg, step_fn, batches, whole):
    """(4) The first step through the plain versions (autograd through
    ``mha_ref`` and ``moe_gemm_ref``) from the same state."""
    state = train_state(cfg, dev)
    with plain_ops():
        _, plain = step_fn(state, batches(0))
        plain = {k: float(v) for k, v in plain.items()}
    del state
    rel_loss = abs(plain["loss/total"] - whole[0]["loss/total"]) / abs(
        plain["loss/total"])
    rel_gn = abs(plain["opt/grad_norm"] - whole[0]["opt/grad_norm"]) / abs(
        plain["opt/grad_norm"])
    check(rel_loss <= TRAIN_PLAIN_LOSS_RTOL,
          f"the first step's loss {whole[0]['loss/total']} is {rel_loss} "
          f"off the plain versions' {plain['loss/total']}")
    check(rel_gn <= TRAIN_PLAIN_GNORM_RTOL,
          f"the first step's grad norm {whole[0]['opt/grad_norm']} is "
          f"{rel_gn} off the plain versions' {plain['opt/grad_norm']}")
    return {"loss": plain["loss/total"], "grad_norm": plain["opt/grad_norm"],
            "kernels_loss": whole[0]["loss/total"],
            "kernels_grad_norm": whole[0]["opt/grad_norm"],
            "loss_rel_diff": rel_loss, "grad_norm_rel_diff": rel_gn}


def train_full_width(dev, ckpt_root):
    """The full-width step: the uninterrupted run, the same first step
    again, ``TRAIN_DOTS_STEPS`` steps under remat "dots", the first step
    through the plain versions, and (1 layer) kill and resume; one line
    each. Returns the uninterrupted and the "dots" runs' launches."""
    from repro_torch.train import AdamWConfig, make_train_step

    cfg = train_cfg()
    step_fn = make_train_step(cfg, AdamWConfig())
    batches = train_batches(cfg, dev)
    out, launches, whole, snap = train_uninterrupted(dev, cfg, step_fn,
                                                     batches)
    emit({"phase": "train_step", **out})
    torch.cuda.empty_cache()
    repeat = train_repeat_first(dev, cfg, step_fn, batches, whole, snap)
    emit({"phase": "train_repeat", **repeat})
    del snap
    torch.cuda.empty_cache()
    dots, dots_launches = train_dots(dev, cfg, batches, whole, out)
    emit({"phase": "train_dots", **dots})
    launches = {k: sum_routes([launches[k], dots_launches[k]])
                for k in launches}
    torch.cuda.empty_cache()
    plain = train_plain_first(dev, cfg, step_fn, batches, whole)
    emit({"phase": "train_plain_first_step", **plain})
    torch.cuda.empty_cache()
    resume = train_kill_resume(dev, os.path.join(ckpt_root, "killed"),
                               repeat["bitwise"])
    emit({"phase": "train_resume", **resume})
    shutil.rmtree(os.path.join(ckpt_root, "killed"), ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def train_f32_check(dev, layers=2, seq=1024, batch=2):
    """The model at full width, 2 layers, float32 compute, S 1024: loss and
    every leaf's gradient through the ``fp32`` routes against the plain
    versions; the kernels' run is the float32 routes' training path."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg
    from repro_torch.train.step import _grads

    cfg = train_cfg(layers, "float32")
    params = train_params(cfg, dev, seed=1)
    b = train_batches(cfg, dev, seq=seq, batch=batch, seed=1)(0)
    fa.reset_launches()
    mg.reset_launches()
    gk, mk = _grads(cfg, params, b)
    launches = {"flash_attention": dict(fa.flash_attention.route_launches),
                "moe_gemm": dict(mg.moe_gemm.route_launches)}
    want = {"flash_attention": {"tc": 0, "fp32": 2 * layers},
            "moe_gemm": {"prefill": 0, "decode": 0, "fp32": 6 * layers}}
    check(launches == want, f"float32 train launches {launches}, expected "
          f"{want}")
    with plain_ops():
        gp, mp = _grads(cfg, params, b)
    rel = abs(float(mk["loss/total"]) - float(mp["loss/total"])) / abs(
        float(mp["loss/total"]))
    check(rel <= F32_LOSS_RTOL, f"float32 loss {float(mk['loss/total'])} "
          f"is {rel} off the plain versions' {float(mp['loss/total'])}")
    worst = 0.0
    for i, (a, w) in enumerate(zip(gk, gp)):
        check(bool(torch.isfinite(a).all()), f"float32 gradient {i} not "
              "finite")
        scale = float(w.abs().max())
        err = float((a - w).abs().max())
        check(err <= F32_GRAD_REL * scale + 1e-30,
              f"float32 gradient leaf {i} {tuple(w.shape)}: {err} off "
              f"the plain versions' (largest {scale})")
        worst = max(worst, err / scale if scale else 0.0)
    return {"dtype": "float32", "layers": layers, "tokens": [batch, seq],
            "loss": float(mk["loss/total"]),
            "plain_loss": float(mp["loss/total"]), "loss_rel_diff": rel,
            "worst_leaf_rel_grad_diff": worst, "leaves": len(gk),
            "launches": launches}, launches


def train_cli(ckpt_dir, steps=4):
    """``python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --smoke
    --steps 4 --compress-grads --device cuda`` in a process of its own: it
    must exit 0, log finite metrics and launch the float32 routes (the
    smoke config is float32, head dim 16, remat "none": one attention and
    three GEMM launches a layer a step)."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--smoke", "--steps", str(steps), "--compress-grads",
         "--device", "cuda", "--ckpt-dir", ckpt_dir], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    check(proc.returncode == 0, f"launch.train exited {proc.returncode}: "
          f"{lines[-20:]}")
    out_lines = proc.stdout.strip().splitlines()
    check(out_lines[-1] == "done", f"launch.train ended {out_lines[-1:]}")
    launches = json.loads(out_lines[-2])
    logged = json.loads(out_lines[1])
    check(all(np.isfinite(v) for v in logged.values()),
          f"launch.train logged {logged}")
    layers = 2
    want = {"flash_attention": {"tc": 0, "fp32": steps * layers},
            "moe_gemm": {"prefill": 0, "decode": 0,
                         "fp32": 3 * steps * layers}}
    check(launches == want, f"launch.train launches {launches}, expected "
          f"{want}")
    return {"seconds": time.perf_counter() - t0, "returncode": 0,
            "first_line": out_lines[0], "step0": logged,
            "launches": launches}


def train_profile_worker(queue, arch=None):
    """In a process of its own (``torch.profiler`` drops kernel records in a
    process that opened windows before): one warm-up step of the full-width
    training step (``arch`` at full size if given), then one step under the
    profiler, its device time split by where each kernel was launched
    from."""
    try:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from torch.profiler import ProfilerActivity, profile, record_function

        import repro_torch.kernels.flash_attention.ops as fa_ops
        import repro_torch.kernels.moe_gemm.ops as mg_ops
        import repro_torch.models.mamba2 as mamba_mod
        import repro_torch.models.transformer as tr
        import repro_torch.train.step as step_mod
        from repro_torch.configs import get_config
        from repro_torch.train import AdamWConfig, make_train_step

        def ranged(fn, label):
            def wrapped(*a, **kw):
                with record_function(label):
                    return fn(*a, **kw)
            return wrapped

        mamba_mod._ssd_chunked = ranged(mamba_mod._ssd_chunked, "range:ssd")
        tr._train_layer = ranged(tr._train_layer, "range:layer_forward")
        tr._ce_chunk = ranged(tr._ce_chunk, "range:cross_entropy_forward")
        step_mod.adamw_update = ranged(step_mod.adamw_update,
                                       "range:optimizer")
        for fn_cls, label in ((fa_ops._Attention, "attention_backward"),
                              (mg_ops._GroupedGemm, "experts_backward")):
            fn_cls.backward = staticmethod(ranged(fn_cls.backward,
                                                  "range:" + label))
        dev = torch.device("cuda", 0)
        cfg = train_cfg() if arch is None else get_config(arch)
        state = train_state(cfg, dev)
        batches = train_batches(cfg, dev)
        step_fn = make_train_step(cfg, AdamWConfig())
        state, _ = step_fn(state, batches(0))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batches(1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        queue.put(("ok", split_train_profile(prof, wall)))
    except Exception:
        queue.put(("error", traceback.format_exc()))


def split_train_profile(prof, wall):
    """Device ms of the profiled step by where each kernel ran: inside the
    innermost of the named ranges' device spans (the layers' forward and
    remat recompute, the cross entropy's forward and recompute, the
    attention Function's backward, the grouped GEMM Function's backward,
    the optimizer) or outside them all (the rest of the backward: the
    projections', the shared experts', the cross entropy's GEMMs); within
    each by kind (``flash_attention``, ``moe_gemm``, cuBLAS in fp32 by its
    kernel's name, other cuBLAS, other). A range's device span runs from
    its first kernel's start to its last kernel's end on the one stream.
    The ranges' spans are not kernels and count nowhere."""
    def kind(name):
        low = name.lower()
        if "flash_fwd" in low:
            return "flash_attention"
        if "moe_gemm" in low:
            return "moe_gemm"
        if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            fp32 = "sgemm" in low or "f32f32_f32f32" in low
            return "cublas_fp32" if fp32 else "cublas_other"
        if "memcpy" in low or "memset" in low:
            return "memcpy"
        return "other"

    spans, kernels = [], []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        tr = ev.time_range
        if ev.name.startswith("range:"):
            spans.append((tr.start, tr.end, ev.name[len("range:"):]))
        else:
            kernels.append((tr.start, tr.end - tr.start, ev.name))
    table, names, busy = {}, {}, 0.0
    for start, dur, name in kernels:
        inside = [(e - s0, label) for s0, e, label in spans
                  if s0 <= start < e]
        place = min(inside)[1] if inside else "backward_rest"
        ms = dur / 1e3
        busy += ms
        cell = table.setdefault(place, {})
        k = kind(name)
        cell[k] = cell.get(k, 0.0) + ms
        n = names.setdefault(name[:90], [0, 0.0])
        n[0] += 1
        n[1] += ms
    by_kind = {}
    for cell in table.values():
        for k, ms in cell.items():
            by_kind[k] = by_kind.get(k, 0.0) + ms
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:15]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1 - busy / (wall * 1e3), "kernels": len(kernels),
            "ranges": len(spans),
            "by_place_ms": {p: sum(c.values()) for p, c in
                            sorted(table.items())},
            "by_place": {p: dict(sorted(c.items())) for p, c in
                         sorted(table.items())},
            "by_kind": dict(sorted(by_kind.items())),
            "top": [{"kernel": n, "launches": c, "ms": ms}
                    for n, (c, ms) in top]}


def train_profile(limit_s=300, arch=None):
    """``train_profile_worker`` in a spawned process; its result."""
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=train_profile_worker, args=(q, arch))
    t0 = time.perf_counter()
    p.start()
    try:
        status, payload = q.get(timeout=limit_s)
    finally:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    check(status == "ok", f"the profile process failed:\n{payload}")
    payload["seconds"] = time.perf_counter() - t0
    return payload


def phase_train(dev):
    """The training path on the card: the Functions against the plain
    versions' autograd, the full-width step (timed, launch counts, the same
    step twice, kill and resume), the first step through the plain
    versions, the float32 check, the CLI, and a profile of one step."""
    import tempfile

    t_phase = time.perf_counter()
    attn, moe = train_function_checks(dev)
    emit({"phase": "train_functions", "attention": attn, "moe_gemm": moe})
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root, prefix="train_ckpt.") as ckpt:
        launches = train_full_width(dev, ckpt)
        f32, f32_launches = train_f32_check(dev)
        emit({"phase": "train_f32_check", **f32})
        torch.cuda.empty_cache()
        cli = train_cli(os.path.join(ckpt, "cli"))
        emit({"phase": "train_cli", **cli})
    gc.collect()
    torch.cuda.empty_cache()
    prof = train_profile()
    emit({"phase": "train_profile", "arch": TRAIN_ARCH,
          "layers": TRAIN_LAYERS, "tokens": [TRAIN_BATCH, TRAIN_SEQ],
          **prof})
    emit({"phase": "train_done", "seconds": time.perf_counter() - t_phase})
    return {"full_width": launches, "f32": f32_launches}


# ---------------------------------------------------------------------------
# phase dryrun: the H100 dry-run on the host, against what the ranks measured
# ---------------------------------------------------------------------------

# what the ranks phases measured, for the dry-run to be held against
MEASURED = {}
DRYRUN_CELL = ("musicgen-large", "decode_32k")
DRYRUN_LIMIT_S = 600


def dryrun_job(path):
    """In a process of its own, on the host (fake tensors, no card): the
    reference test's cell (musicgen-large ``decode_32k``) on ``16x16`` and
    ``2x16x16``, and phase tp (a)'s steps at their shapes (qwen3-8b at
    full size, bf16 weights, ``serve_tp`` on a ``(1, 4)`` stand-in mesh, a
    prefill of 2 x ``TP_PROMPT`` into a cache of its length and a decode
    step in a cache of ``TP_PROMPT + TP_DECODE``); the records, rank 0's,
    and the job's first and last instants on ``time.perf_counter`` (the
    host's monotonic clock, one for every process here) written to
    ``path`` as JSON."""
    import dataclasses

    out = {"began": time.perf_counter()}
    torch.set_num_threads(2)          # the parent's phases share the host
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun

        for multi in (False, True):
            t0 = time.perf_counter()
            rec, _ = dryrun.lower_cell(*DRYRUN_CELL, multi_pod=multi,
                                       verbose=False)
            rec["wall_s"] = time.perf_counter() - t0
            out["multi" if multi else "single"] = rec
        cfg = dataclasses.replace(get_config(TP_ARCH),
                                  param_dtype="bfloat16")
        mesh = dryrun.DryMesh((1, TP_RANKS), ("data", "model"))
        for kind, seq in (("prefill", TP_PROMPT),
                          ("decode", TP_PROMPT + TP_DECODE)):
            t0 = time.perf_counter()
            rec, _ = dryrun.lower_cell(
                TP_ARCH, ShapeConfig(f"tp_a_{kind}", seq, TP_BATCH, kind),
                opts={"profile": "serve_tp"}, verbose=False,
                cfg_override=cfg, mesh=mesh)
            rec["wall_s"] = time.perf_counter() - t0
            out[f"tp_{kind}"] = rec
    except Exception:  # reported by the parent
        out["error"] = traceback.format_exc()
    out["ended"] = time.perf_counter()
    with open(path, "w") as f:
        json.dump(out, f, default=float)


def start_dryrun(t0):
    """:func:`dryrun_job` in a spawned process, started now and read by
    :func:`phase_dryrun`; it runs on the host beside the card's phases,
    which ``t0`` (the script's start) places it among."""
    import multiprocessing

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    path = root / "dryrun_records.json"
    if path.exists():
        path.unlink()
    proc = multiprocessing.get_context("spawn").Process(
        target=dryrun_job, args=(str(path),), daemon=True)
    proc.start()
    return proc, path, t0


def phase_dryrun(job):
    """The dry-run's records (:func:`dryrun_job`): the reference test's
    cell ``ok`` on 256 and 512 chips with flops and a dominant term; phase
    tp (a)'s prefill (the dry-run-shaped one) and first decode step: the
    dry-run's bytes sent and calls by kind equal what rank 0 measured,
    every kind (``tp``, ``sp`` and ``vocab`` among them). Reported, not
    gated: the dry-run's peak against the rank's peak allocation, its
    roofline terms against the measured prefill and decode-step ms; the
    job's start and end on the script's clock (the ``clock`` lines'), so
    that a reader sees which phases' walls it overlapped."""
    proc, path, t_script = job
    t0 = time.perf_counter()
    proc.join(timeout=DRYRUN_LIMIT_S)
    if proc.is_alive():
        proc.kill()
        proc.join(timeout=10)
    check(proc.exitcode == 0 and path.exists(),
          f"the dry-run process ended with {proc.exitcode}")
    with open(path) as f:
        out = json.load(f)
    check("error" not in out, f"the dry-run failed: {out.get('error')}")
    for name, chips in (("single", 256), ("multi", 512)):
        rec = out[name]
        emit({"phase": "dryrun_cell", **rec})
        check(rec["status"] == "ok" and rec["chips"] == chips
              and rec["flops_dev"] > 0
              and rec["dominant"] in ("compute", "memory", "collective"),
              f"dry-run {DRYRUN_CELL} on {rec['mesh']}: {rec}")
    rank0 = MEASURED["tp_a"][0]
    compared = {}
    for kind, measured, ms in (
            ("prefill", rank0["dry_prefill"], rank0["dry_prefill"]["ms"]),
            ("decode", rank0["comm_decode1"], rank0["decode_step_ms"][0])):
        rec = out[f"tp_{kind}"]
        check(rec["status"] == "ok", f"dry-run tp (a) {kind}: {rec}")
        same = rec["sent"] == measured["bytes"] \
            and rec["calls"] == measured["calls"]
        compared[kind] = {
            "dry_sent": rec["sent"], "rank0_sent": measured["bytes"],
            "dry_calls": rec["calls"], "rank0_calls": measured["calls"],
            "equal": same, "dry_peak_memory_gb": rec["peak_memory_gb"],
            "rank0_peak_memory_allocated_gb":
                rank0["peak_memory_allocated"] / 2 ** 30,
            "dry_t_compute_ms": rec["t_compute_ms"],
            "dry_t_memory_ms": rec["t_memory_ms"],
            "dry_t_collective_ms": rec["t_collective_ms"],
            "dry_dominant": rec["dominant"], "dry_flops_dev":
                rec["flops_dev"], "measured_ms": ms,
            "dry_wall_s": rec["wall_s"]}
    emit({"phase": "dryrun", "card": card(), "against": "phase tp (a), "
          "rank 0 of 4 gloo ranks on the card", "tp_a": compared,
          "job_began_s": out["began"] - t_script,
          "job_ended_s": out["ended"] - t_script,
          "waited_s": time.perf_counter() - t0})
    for kind, c in compared.items():
        check(c["equal"] and c["rank0_calls"]["tp"] > 0
              and c["rank0_calls"]["sp"] > 0, f"dry-run tp (a) {kind}: "
              f"bytes sent by kind {c['dry_sent']}, calls {c['dry_calls']}; "
              f"rank 0 measured {c['rank0_sent']}, {c['rank0_calls']}")
    return compared


# ---------------------------------------------------------------------------
# phase examples: the examples' torch twins on the card
# ---------------------------------------------------------------------------

EXAMPLES = ("quickstart", "amg_galerkin", "betweenness_centrality",
            "mcl_quickstart", "serve_quickstart", "moe_dispatch", "train_lm")
EXAMPLES_TRAIN_STEPS = 30


def phase_examples(dev):
    """Each twin's ``main`` (``examples/torch/*.py``) on the card at its
    default size (``train_lm --tiny --steps 30``), its output kept: the
    wall and the kernels' launches by route, counted from 0 just before
    and read just after. Checks: the host-path twins (quickstart, AMG, BC)
    correct and launching nothing; MCL and the service on ``warp`` (bs 32),
    the service's bitwise oracle (its assert); ``moe_dispatch`` on the
    ``fp32`` grouped GEMM, its output within ``MOE_TOL`` of ``moe_apply``
    through the plain versions on the same weights and tokens, the same
    routed, slot and dropped counts; ``train_lm``'s loss falling, each step
    one ``fp32`` attention launch a layer, its first step's cross entropy
    within ``F32_LOSS_RTOL`` of the same step through the plain versions
    (those runs launch no kernel). Returns the launches by kernel."""
    import importlib.util
    import tempfile

    from repro_torch.kernels.bsr_spgemm import kernel as bk
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.moe_gemm import kernel as mg

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    rows, got, mods = {}, {}, {}
    kernels = {"bsr_spgemm": (bk, bk.bsr_spgemm),
               "flash_attention": (fa, fa.flash_attention),
               "moe_gemm": (mg, mg.moe_gemm)}
    with tempfile.TemporaryDirectory(dir=root / "build",
                                     prefix="train_lm.") as ckpt:
        for name in EXAMPLES:
            spec = importlib.util.spec_from_file_location(
                f"twin_{name}", root / "examples" / "torch" / f"{name}.py")
            mod = mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            argv = ["--device", dev.type]
            if name == "train_lm":
                argv += ["--tiny", "--steps", str(EXAMPLES_TRAIN_STEPS),
                         "--ckpt-dir", ckpt]
            for mod_k, _ in kernels.values():
                mod_k.reset_launches()
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                got[name] = mod.main(argv)
            torch.cuda.synchronize()
            rows[name] = {
                "wall_s": time.perf_counter() - t0,
                "launches": {k: dict(w.route_launches)
                             for k, (_, w) in kernels.items()},
                "output": buf.getvalue().strip().splitlines()[-4:]}
        # the plain versions on the same inputs
        for mod_k, _ in kernels.values():
            mod_k.reset_launches()
        with plain_ops(), contextlib.redirect_stdout(io.StringIO()):
            moe_plain = mods["moe_dispatch"].report(
                *mods["moe_dispatch"].setup(["--device", dev.type]))
            lm = mods["train_lm"]
            cfg, params, args, _ = lm.setup(
                ["--device", dev.type, "--tiny", "--steps", "1",
                 "--ckpt-dir", os.path.join(ckpt, "plain")])
            ce_plain = lm.train(cfg, params, args, dev, log_every=1)
        plain_launches = sum(sum(w.route_launches.values())
                             for _, w in kernels.values())
    moe_got = got["moe_dispatch"]
    moe_ok, moe_err = within(moe_got["y"], moe_plain["y"],
                             *MOE_TOL[moe_got["y"].dtype])
    (step0, ce0), (pstep, pce) = got["train_lm"][0], ce_plain[0]
    ce_rel = abs(ce0 - pce) / abs(pce)
    plain = {"moe_dispatch": {"max_abs_err": moe_err,
                              "tolerance": MOE_TOL[moe_got["y"].dtype],
                              **{k: (moe_got[k], moe_plain[k])
                                 for k in ("routed", "slots", "dropped",
                                           "aux")}},
             "train_lm": {"step": step0, "ce": ce0, "plain_ce": pce,
                          "rel": ce_rel, "rtol": F32_LOSS_RTOL},
             "launches": plain_launches}
    emit({"phase": "examples", "card": card(), "twins": rows,
          "against_plain": plain, "seconds": time.perf_counter() - t_phase})
    check(plain_launches == 0, f"examples: the plain runs launched "
          f"{plain_launches} kernels")
    check(moe_ok and all(moe_got[k] == moe_plain[k]
                         for k in ("routed", "slots", "dropped")),
          f"examples moe_dispatch against the plain versions: "
          f"{plain['moe_dispatch']}")
    check(step0 == pstep == 0 and ce_rel <= F32_LOSS_RTOL,
          f"examples train_lm's first step against the plain versions: "
          f"{plain['train_lm']}")
    n = lambda name, k: sum(rows[name]["launches"][k].values())
    for name in ("quickstart", "amg_galerkin", "betweenness_centrality"):
        check(all(n(name, k) == 0 for k in kernels),
              f"examples {name}: a host path launched a kernel")
    check(got["quickstart"]["correct"] and got["amg_galerkin"]["correct"],
          "examples: quickstart's or AMG's product is wrong")
    for name in ("mcl_quickstart", "serve_quickstart"):
        warp = rows[name]["launches"]["bsr_spgemm"]["warp"]
        check(warp == n(name, "bsr_spgemm") > 0, f"examples {name}: "
              f"bsr_spgemm launches {rows[name]['launches']['bsr_spgemm']}")
    check(got["serve_quickstart"]["oracle"]
          and got["mcl_quickstart"]["converged"], "examples: the service's "
          "oracle or MCL's convergence")
    moe = rows["moe_dispatch"]["launches"]["moe_gemm"]
    check(moe["fp32"] == n("moe_dispatch", "moe_gemm") == 3
          and got["moe_dispatch"]["finite"], f"examples moe_dispatch: "
          f"moe_gemm launches {moe}, finite {got['moe_dispatch']['finite']}")
    ce = [c for _, c in got["train_lm"]]
    attn = rows["train_lm"]["launches"]["flash_attention"]
    check(len(ce) >= 2 and ce[-1] < ce[0], f"examples train_lm: the cross "
          f"entropy did not fall: {ce}")
    check(attn["fp32"] == n("train_lm", "flash_attention")
          == 2 * EXAMPLES_TRAIN_STEPS, f"examples train_lm: attention "
          f"launches {attn}")
    return {k: sum_routes([r["launches"][k] for r in rows.values()])
            for k in kernels}


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree

def kernel_row(name, replaces, launches, t, extra=None, source=None):
    source = source or f"src/repro_torch/kernels/{name}/csrc/{name}.cu"
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **(extra or {})}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repo (src/ holds "
              "repro_torch)", file=sys.stderr)
        return 2
    # the plain version's float32 products stay full precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()

    def lap(name):
        """The script's seconds so far, once ``name`` has ended."""
        emit({"phase": "clock", "after": name,
              "seconds": time.perf_counter() - t0})

    try:
        infos = phase_build()
        lap("build")
        # host work beside the card's phases, read after phase tp
        dry_job = start_dryrun(t0)
        grid_err = phase_kernel(dev)
        case = laplacian_case()
        sess, plan, args, launches, ring, ring_ms = phase_main_path(dev,
                                                                    case)
        timing = measure_kernel(dev, plan, args)
        check(timing["route"] == "tc", "the bs-128 main path is off the tc "
              "route")
        lap("main_path")
        semirings = phase_semirings(dev, sess)
        lap("semirings")
        del sess, plan, args      # the SpGEMM session's cached entries
        torch.cuda.empty_cache()
        minplus_main = phase_minplus_main(dev)
        lap("minplus_main")
        default = phase_default_bs(dev, case, ring_ms)
        lap("default_bs")
        summa_launches = phase_summa(dev, case, ring)
        lap("summa")
        rank_launches = phase_ranks(dev)
        lap("ranks")
        del case
        torch.cuda.empty_cache()
        app_launches = phase_apps(dev)
        lap("apps")
        service_launches = phase_service(dev)
        lap("service")
        phase_build_lm(infos)
        flash_grid_err = phase_flash_grid(dev)
        phase_serve_smoke()
        moe_grid_err = phase_moe_grid(dev)
        lap("lm_grids")
        (routes, attn_routes, flash, flash_fp32, gemms,
         fp32) = phase_lm_serve(dev)
        lap("lm_serve")
        split = phase_minplus_split(dev)
        lap("minplus_split")
        mamba_routes, mamba_attn_routes, jamba_err = phase_mamba(dev)
        lap("mamba")
        # after minplus_split's in-process profile: run before it, this
        # phase left that profile with no kernel record (on an H100)
        lm_ranks = phase_lm_ranks(dev)
        lap("lm_ranks")
        # one pool of ranks for both phases
        with RankPool(FSDP_RANKS, "gloo", target=lm_ranks_worker) as pool:
            fsdp = phase_fsdp(dev, pool)
            lap("fsdp")
            tp, tp_err = phase_tp(dev, pool)
        lap("tp")
        phase_dryrun(dry_job)
        lap("dryrun")
        examples = phase_examples(dev)
        lap("examples")
        train = phase_train(dev)
        lap("train")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except Exception:  # report, then fail the run
        traceback.print_exc()
        return 1
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    timing["library_ms"] = None
    timing["max_abs_err"] = max(grid_err["tc"], timing["err"])
    # minplus launches: device time first, CUDA events beside it
    mp, mp_b, mp_c = (dict(t, **split[label], events_ms=t["ms"],
                           previous_events_ms=t["previous_ms"],
                           ms=split[label]["device_ms"],
                           previous_ms=split[label]["previous_device_ms"])
                      for t, label in ((semirings["min_plus"], "bs64"),
                                       (semirings["min_plus_bs128"], "bs128"),
                                       (minplus_main, "laplacian")))
    mp["max_abs_err"] = grid_err["minplus"]
    mp_keys = ("ms", "main_ms", "combine_ms", "events_ms", "previous_ms",
               "previous_events_ms", "plain_ms", "bound_ms", "bound_by",
               "tile_products", "runs", "longest_run", "workers", "cut_runs",
               "launches")
    bsr_src = "src/repro_torch/kernels/bsr_spgemm/csrc/"
    bsr_pallas = "src/repro/kernels/bsr_spgemm/kernel.py:92"
    flash["max_abs_err"] = max(flash_grid_err["bfloat16"],
                               flash["max_abs_err"], jamba_err["tc"],
                               tp_err.get("tc", 0.0))
    flash_fp32["max_abs_err"] = max(flash_grid_err["float32"],
                                    flash_fp32["max_abs_err"])
    fa_src = "src/repro_torch/kernels/flash_attention/csrc/"
    fa_pallas = "src/repro/kernels/flash_attention/kernel.py:108"
    moe_src = "src/repro_torch/kernels/moe_gemm/csrc/"
    moe_pallas = "src/repro/kernels/moe_gemm/kernel.py:52"
    moe_keys = ("phase", "projection", "shape", "ms", "previous_ms",
                "events_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "host_us_per_call", "launch_us_per_call")

    # launches per path: serving (one generate; the float32 routes' from
    # the 2-layer check), jamba's generate (phase mamba) and training (the
    # full-width step's runs; the float32 routes' from the 2-layer float32
    # check)
    by_path = {
        "flash_attention": {
            r: {"serve": attn_routes[r],
                "lm_ranks": lm_ranks["flash_attention"].get(r, 0),
                "fsdp": fsdp["flash_attention"].get(r, 0),
                "tp": tp["flash_attention"].get(r, 0),
                "mamba": mamba_attn_routes[r],
                "examples": examples["flash_attention"].get(r, 0),
                "train": train["full_width"]["flash_attention"][r]
                + train["f32"]["flash_attention"][r]} for r in attn_routes},
        "moe_gemm": {
            r: {"serve": routes[r],
                "lm_ranks": lm_ranks["moe_gemm"].get(r, 0),
                "fsdp": fsdp["moe_gemm"].get(r, 0),
                "tp": tp["moe_gemm"].get(r, 0),
                "mamba": mamba_routes[r],
                "examples": examples["moe_gemm"].get(r, 0),
                "train": train["full_width"]["moe_gemm"][r]
                + train["f32"]["moe_gemm"][r]} for r in routes}}
    train_note = ("; lm_ranks (every rank): the NCCL world of one's prefill "
                  "and 2 decode steps (2 layers, 4 prompts), 4 gloo ranks "
                  "serving qwen2-moe-a2.7b at full size (a prefill and 32 "
                  "decode steps; the experts' GEMMs see P·cap rows, so "
                  "decode runs on the prefill route) and 3 training steps "
                  "(2 layers), then one step each under remat none and "
                  "dots; fsdp (every rank): 4 gloo ranks, "
                  "musicgen-large at full size under dp_only on (4, 1) (a "
                  "prefill and 2 decode steps, then a training step, the "
                  "forward and remat's recompute) and qwen2-moe-a2.7b at "
                  "full width, 2 layers, under ep_dp on (2, 2) (2 training "
                  "steps); tp (every rank): 4 gloo ranks, qwen3-8b at full "
                  "size under serve_tp on (1, 4) (a prefill and 4 decode "
                  "steps), at full width, 2 layers, under default on (2, 2) "
                  "(2 training steps), qwen2-moe-a2.7b at full width, 2 "
                  "layers, under ep_sharded on (1, 4) (a prefill, 2 decode "
                  "steps, a training step), mamba2-1.3b at full size under "
                  "serve_tp on (1, 4) and at full width, 2 layers, under "
                  "default on (2, 2) (no kernel), jamba-v0.1-52b at full "
                  "width, one period, under serve_tp on (1, 4) (a prefill "
                  "and 2 decode steps, every launch held against its plain "
                  "version), and (a)'s one more prefill at the dry-run's "
                  "shape; mamba (one process): jamba-v0.1-52b at full "
                  "width, one period: one "
                  "generate; examples: the twins on the card (moe_dispatch "
                  "and train_lm: the float32 routes); training: the 6 steps "
                  "of qwen2-moe-a2.7b at full "
                  "width, 4 layers, S 4096, B 2, remat block (the forward "
                  "and the backward's recompute), and 2 steps under remat "
                  "dots (the same launches); the float32 routes: the "
                  "2-layer float32 training check")

    def moe_row(route, timings, err, source, extra=None):
        head = timings[0]
        paths = by_path["moe_gemm"][route]
        return kernel_row(
            f"moe_gemm_{route}", moe_pallas, sum(paths.values()),
            {**head, "max_abs_err": max([err] + [t["max_abs_err"]
                                                 for t in timings])},
            {"shape": head["shape"], "previous_ms": head["previous_ms"],
             "shapes": [{k: t[k] for k in moe_keys} for t in timings],
             "launches_by_path": paths,
             "launches_on": "serving: one generate" + train_note,
             **(extra or {})},
            source=moe_src + source)

    service_warp = sum(v for k, v in service_launches.items()
                       if k != "tc_group")
    examples_warp = examples["bsr_spgemm"].get("warp", 0)
    ranks_note = ("; the ranks phase (the same multiplies across processes, "
                  "one part per rank: NCCL one rank per card, 8 gloo ranks "
                  "on one card)")
    warp = dict(default["timings"][32], library_ms=None,
                max_abs_err=max(grid_err["warp"],
                                *(t["err"] for t in
                                  default["timings"].values())))
    emit({"kernels": [
        kernel_row("bsr_spgemm_warp", bsr_pallas,
                   default["launches"] + sum(app_launches.values())
                   + service_warp + rank_launches["warp"] + examples_warp,
                   warp,
                   {"kernel_route": "warp", "launches_on":
                    "the session at its default bs: laplacian_2d(1024) "
                    "through the 1D ring at bs 32 (chunk None and 2) and 16 "
                    "(chunk None), cold and hit each; bool_or_and at bs 16 "
                    "and min_plus at bs 32 on banded_clustered (chunk 2); "
                    "the apps' kernel runs (AMG, the sketch stream, MCL, "
                    "BC and their resumes); the SpGEMM service's 1D "
                    "requests (the serving CLI, budgets, failure routing)"
                    + ranks_note + "; the examples' twins (MCL, the "
                    "serving quickstart)",
                    "launches_by_path": {"default_bs": default["launches"],
                                         "apps": app_launches,
                                         "service": service_warp,
                                         "ranks": rank_launches["warp"],
                                         "examples": examples_warp},
                    "bs": 32, "previous_ms": warp["previous_ms"],
                    "previous_fill_ms": warp["previous_fill_ms"],
                    "float_ms": warp["float_ms"],
                    "float_bound_ms": warp["float_bound_ms"],
                    "fp32_bound_ms": warp["fp32_bound_ms"],
                    "bmm_products_ms": warp["bmm_products_ms"],
                    "bs16": {k: default["timings"][16][k] for k in
                             ("ms", "float_ms", "previous_ms", "plain_ms",
                              "bound_ms", "bound_by", "bmm_products_ms")},
                    "bool_bs16": default["semirings"]["bool_or_and"],
                    "min_plus_bs32": default["semirings"]["min_plus"]},
                   source=bsr_src + "bsr_spgemm_warp.cu"),
        kernel_row("bsr_spgemm_tc", bsr_pallas,
                   launches + summa_launches + service_launches["tc_group"]
                   + rank_launches["tc"], timing,
                   {"kernel_route": "tc", "launches_on":
                    "the main path (laplacian_2d(1024), bs 128): the 1D "
                    "ring (chunk None and 2) and 2D / 3D SUMMA, cold, hit "
                    "and repack each; the SpGEMM service's 2D group "
                    "(bs 128)" + ranks_note,
                    "launches_by_path": {"1d": launches,
                                         "2d_3d": summa_launches,
                                         "service": service_launches[
                                             "tc_group"],
                                         "ranks": rank_launches["tc"]},
                    "previous_ms": timing["previous_ms"],
                    "float_ms": timing["float_ms"],
                    "float_bound_ms": timing["float_bound_ms"],
                    "fp32_bound_ms": timing["fp32_bound_ms"],
                    "bmm_products_ms": timing["bmm_products_ms"],
                    "bool_bs64": semirings["bool_or_and"]},
                   source=bsr_src + "bsr_spgemm_tc.cu"),
        kernel_row("bsr_spgemm_minplus", bsr_pallas,
                   mp["launches"] + mp_b["launches"] + mp_c["launches"]
                   + rank_launches["minplus"], mp,
                   {"kernel_route": "minplus", "serves": "min_plus at bs 64 "
                    "and 128", "launches_on":
                    "the min-plus paths: banded_clustered at bs 64 through "
                    "1D (chunk 2), 2D and 3D (launch a, the 1D call's "
                    "largest), at bs 128 through 1D unchunked (launch b), "
                    "and |laplacian_2d(1024)| at bs 128 through 1D "
                    "unchunked (launch c, part 0)" + ranks_note,
                    "launches_by_path": {
                        "semirings": mp["launches"] + mp_b["launches"],
                        "minplus_main": mp_c["launches"],
                        "ranks": rank_launches["minplus"]},
                    "bs": 64, "ms_is": "profiler device time of the "
                    "product and the combine pass (previous_ms: of the "
                    "simt kernel and its fill); events_ms: CUDA events "
                    "around back-to-back calls, the host's enqueue in it",
                    "previous_ms": mp["previous_ms"],
                    "previous_source": bsr_src + "bsr_spgemm.cu",
                    "launch_a": {k: mp[k] for k in mp_keys},
                    "launch_b": {k: mp_b[k] for k in mp_keys},
                    "launch_c": {k: mp_c[k] for k in mp_keys}},
                   source=bsr_src + "bsr_spgemm_minplus.cu"),
        kernel_row("flash_attention_bf16", fa_pallas,
                   sum(by_path["flash_attention"]["tc"].values()),
                   flash, {"shape": flash["shape"],
                           "launches_by_path": by_path["flash_attention"][
                               "tc"],
                           "launches_on": "serving: one generate's prefill"
                           + train_note,
                           "previous_ms": flash["previous_ms"],
                           "host_us_per_call": flash["host_us_per_call"],
                           "launch_us_per_call": flash["launch_us_per_call"]},
                   source=fa_src + "flash_attention_tc.cu"),
        kernel_row("flash_attention_fp32", fa_pallas,
                   sum(by_path["flash_attention"]["fp32"].values()),
                   flash_fp32,
                   {"shape": flash_fp32["shape"],
                    "launches_by_path": by_path["flash_attention"]["fp32"],
                    "launches_on": "serving: the 2-layer float32 check"
                    + train_note,
                    "previous_ms": flash_fp32["previous_ms"],
                    "previous_source": fa_src + "flash_attention.cu",
                    "tf32_passes": flash_fp32["tf32_passes"],
                    "fp32_bound_ms": flash_fp32["fp32_bound_ms"],
                    "host_us_per_call": flash_fp32["host_us_per_call"],
                    "launch_us_per_call":
                        flash_fp32["launch_us_per_call"]},
                   source=fa_src + "flash_attention_tf32.cu"),
        moe_row("prefill", gemms[:2], max(moe_grid_err["bfloat16"],
                                          jamba_err["prefill"],
                                          tp_err.get("prefill", 0.0)),
                "moe_gemm_tc.cu"),
        moe_row("decode", gemms[2:], max(moe_grid_err["bfloat16"],
                                         jamba_err["decode"],
                                         tp_err.get("decode", 0.0)),
                "moe_gemm_tc.cu"),
        moe_row("fp32", fp32, moe_grid_err["float32"], "moe_gemm_tf32.cu",
                {"tf32_passes": fp32[0]["tf32_passes"],
                 "fp32_bound_ms": fp32[0]["fp32_bound_ms"],
                 "previous_source": moe_src + "moe_gemm.cu",
                 "decode_cuda_core_rows_ms": fp32[2]["cuda_core_rows_ms"]})]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
