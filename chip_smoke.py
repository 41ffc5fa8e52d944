#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # the full run, n = 2**20, d = 64
    python3 chip_smoke.py --quick    # the same phases at n = 2**14 and
                                     # small MoE widths

Phases, in order; the first failure stops the run with a nonzero exit.
The run reads and writes calibrations only in a fresh temporary
``$REPRO_CALIBRATION_DIR``, removed at the end.

1. **build**: compile the six CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once) and print ``ptxas``'s report per
   kernel function: registers, shared memory, spills.
2. **calibrate**: ``repro_torch.launch.serve``'s ``--calibrate`` sweep
   (``run_startup_calibration``) with the ``cuda`` kernels at n = 2**18
   (``CARD_SCALE``; 2**14 under ``--quick``), BCSR block 64, f32i32,
   d = 4, 16, 64, 256, host clock plus synchronise per call.  Counters are
   zeroed first; each of the five SpMM kernels must launch, and the saved
   file must load back at the registry's version.  One line per format:
   peak_fraction, d_half, sustained and measured GF/s.
3. **serving** (the SpMM path): ``repro_torch.launch.serve``'s
   ``serve_spmm_stream`` on each ``serving_suite`` structure (moe-block,
   banded, scale-free, uniform) at n = 2**20, d = 64, 8 requests each,
   plus scale-free forced onto the binned and the row-split kernels
   (``--spmm-strategy binned`` / ``rowsplit``), the scale-free regime's
   own kernels.  These six runs plan under the default ceilings
   (``calibration=False``), so the kernel phase measures the layouts they
   pack.  Every kernel's launch counter is zeroed before the phase
   and read after it; each run's chosen kernel must have launched.  A run
   on the BCSR kernel must have launched only the variant that
   ``bcsr_variant`` names for its shape, and ``moe-block``'s must be a fast
   one (``tile64_f32`` at fp32, ``wgmma_bf16`` at bf16).  The last
   request's C is held against the port's ``"torch"`` backend on the
   card.  Then each auto structure is planned under the calibrated
   ceilings (classify and plan only): the default and the calibrated
   choice with their predicted GFLOP/s; where the choice differs, the
   structure is served again under the calibrated plan (8 requests, same
   n, d and seed) and checked the same way.
4. **moe** (the MoE path): ``repro_torch.launch.moe_block`` at
   qwen3-moe-235b-a22b's expert widths (4096 tokens, top-8 of 128
   experts, d_model 4096 -> moe_d_ff 1536, bm = bk = bn = 128), at bf16
   (the config's dtype) and at fp32: route, block, run the
   ``("grouped", "cuda")`` spec, and hold every routed row against its
   expert's dense product.  Counters are zeroed before the phase and read
   after it.  After both paths, every kernel must have launched on one.
5. **lm** (the LM serving path): ``repro_torch.launch.serve``'s
   ``serve_lm`` (``serve --arch olmoe-1b-7b``) at full width and depth
   (16 layers, d_model 2048, 64 experts top-8, expert d_ff 1024; 2 layers
   under ``--quick``), batch 4, prompt 32, 16 generated tokens: the model
   is drawn from seed 0 on the card, the prompt is prefilled by stepping
   and decoded greedily (47 ``decode_step`` calls), and every MoE layer's
   expert FFN runs on the grouped kernel.  Counters are zeroed before
   ``serve_lm`` and read after it: ``grouped_matmul`` must have launched
   exactly 2 x 16 x 47 times and no other kernel at all.  Printed:
   parameters, their bytes, ``max_memory_allocated``, tokens/s and the
   per-step median and max (host clock, each step synchronised) beside
   the byte bound of one step (every weight and the KV cache read once,
   over 3.35 TB/s; also with only the routed experts' weights), and a
   ``torch.profiler`` trace of two steps (kernels' device time and count
   per step, device idle share, the largest kernels).  Then the kernel
   against its plain version on the model (``lm_check``): 4
   teacher-forced steps with ``grouped_matmul_plain`` in the model, then
   the same steps on the kernel, each launch also run on the plain
   version with the same operands (``moe_block.grouped_tolerance``,
   padding rows exactly 0).  The kernel run replays the plain run's
   routing, so the two differ only by the products' roundings, and its
   logits must agree within ``models.model.logit_tolerance``; the
   decisions its own router would have changed are counted.  The model is
   freed before the next phase.
6. **families** (the ``local``, ``vlm`` and ``encdec`` families, no
   port kernel on the path): counters are zeroed first and must all read
   0 after.  gemma3-12b at full width, 12 of its 48 layers (five local to
   one global; one period of 6 under ``--quick``) through ``serve
   --arch``, as in ``lm`` (parameters, ``max_memory_allocated``, tok/s,
   the step median and max beside the byte bound: every weight the step
   uses and the KV cache once over 3.35 TB/s), with a ``torch.profiler``
   pass over two steps.  The ring check at full width on a local and a
   global layer (``RING_PATTERN``, ``models.decode_check``): one ``forward`` of
   1 x 1536 tokens, whose local layers take ``local_attention`` over three
   q blocks of 512, against 1536 teacher-forced ``decode_step`` calls,
   whose 1024-slot rings wrap at step 1024; the logits and every
   attention output within their rounding bounds, and three planted
   faults that the check must reject (the ring writes slot ``(pos + 1) %
   S_c``, a local layer attends to every slot before its ring is full,
   the forward's local layers ignore the window).  whisper-base at full
   width and depth through ``serve --arch`` (the reference's meaning:
   zero cross K/V), then ``encode`` -> ``prime_cross_cache`` -> 48
   teacher-forced steps of batch 4 against ``forward(tokens, frames=...)``,
   rejecting a zeroed cross cache and an encoder without its sinusoidal
   positions.  qwen2-vl-7b at full width, 14 of its 28 layers (2 under
   ``--quick``) through ``serve --arch`` (1-D RoPE, the reference's
   meaning), and one forward of 1 x 1024 tokens with the pipeline's
   stubs (256 patch tokens on a 16 x 16 grid, their embeddings through
   ``mm_proj``), whose logits must be finite; then, on its first 4 of 28
   layers at full width (``VLM_CHECK_LAYERS``), its decode against
   ``forward`` over 4 x 256 tokens with the data pipeline's
   ``positions_3d`` (64 patch tokens on an 8 x 8 grid: three distinct
   streams, which decode takes column by column), rejecting a decode
   whose M-RoPE swaps the height and width streams.  Each model is freed
   before the next.
7. **recurrent** (the ``ssm`` and ``hybrid`` families, no port kernel on
   the path): counters are zeroed first and must all read 0 after.
   falcon-mamba-7b (64 mamba layers, d 4096, d_in 8192, state 16) and
   recurrentgemma-9b (26 RG-LRU and 12 local layers, d 4096) at full
   width, 16 and 19 layers (2 and 19 under ``--quick``), through ``serve
   --arch``, as in ``families`` (parameters, their bytes,
   ``max_memory_allocated``, tok/s, the step median and max beside the
   byte bound, which counts each recurrent layer's conv inputs and fp32
   state read and written once and no KV cache for them), each with a
   ``torch.profiler`` pass over two steps.  Then the decode-vs-forward
   check at full width on a cut depth (``models.decode_check``):
   falcon-mamba's first 4 layers over 1 x 512 tokens (two chunks of the
   256-step scan), recurrentgemma's (rglru, rglru, local) over 1 x 1024
   (two RG-LRU chunks of 512); the logits and every mixer output within
   their rounding bounds, and planted faults the check must reject: (a)
   the forward drops the chunk carry (both), (b) mamba decode's conv cache
   stores the activated input, (c) ``rglru_decode`` omits ``a * h``, the
   decode faults over the first 64 steps.  Each model is freed before the
   next.
8. **train** (the training path): ``repro_torch.train.trainer.Trainer`` on
   olmoe-1b-7b at full width with the depth cut to 2 of 16 layers (fp32
   masters, gradients and AdamW's mu and nu take 16 B per parameter: 111
   GB at full depth; 1 layer under ``--quick``), batch 4 x sequence 512,
   8 steps at lr 3e-4 (warmup 2): the first trainer is preempted after 4
   steps and saves its checkpoint (about 12.5 GB of ``.npy`` in a
   temporary directory), a second trainer restores it and runs steps 4 to
   7.  Counters are zeroed before the first trainer and read after the
   second: ``grouped_matmul`` must have launched 6 x 2 x 8 = 96 times
   (forward, recompute and input gradient of each MoE layer) and no other
   kernel at all.  Printed: parameters, bytes and ``max_memory_allocated``;
   the loss of every step (finite, or the phase fails); the step median
   beside the byte bound (``TRAIN_BYTES_PER_PARAM``) and the FLOP bound
   (``ModelConfig.model_flops`` over the bf16 peak), tokens/s and ``mfu``
   (useful FLOPs over step time over 989 TFLOP/s); save and restore
   seconds; a ``torch.profiler`` pass over 2 more steps (kernels per step,
   device idle share, the largest kernels); the transposed-weight copies
   of the input gradient; and the kernel's ``dx`` and ``dw`` against the
   plain version's on every grouped launch of one step of the model,
   within a bound that scales with the gradients and that four planted
   faults must break (``train_grad_check``, ``grad_ratio``).  The model
   and its state are freed before the next phase.
9. **dryrun** (the dry run's counter, ``repro_torch.core.step_cost``, held
   against the card): (a) olmoe-1b-7b at ``[train]``'s shape (full width,
   2 of 16 layers, batch 4 x 512; 1 layer under ``--quick``): one train
   step counted on the card with the grouped kernel launched must count
   exactly the FLOPs and bytes of the same step counted on ``meta``
   tensors; two planted faults in the meta count (the grouped product's
   ``w`` bytes left out; its FLOPs counted for every row against every
   expert) must differ; ``useful_compute_ratio`` (``model_flops`` over the
   counted FLOPs) is printed; the step's measured median (host clock,
   synchronised, 3 steps after a warm one) must be at least the one-card
   ``DistributedRoofline`` lower bound on ``tensor_core(h100_from_device())``,
   and the bound of the full 16-layer model's count held against the same
   4-layer step (a planted fault) must exceed it.  (b) olmoe-1b-7b's
   decode step at ``[lm]``'s batch 4 and cache 48, full width and depth:
   counted on the card equal to the meta count, and its bytes at least
   ``lm_step_bytes`` (every weight read once); the count without the
   grouped ``w`` bytes (a planted fault) must fall below.  (c) llama3.2-1b
   at full width, one prefill of 4096 tokens (1024 under ``--quick``),
   batch 1, with masked and with triangle causal attention: logits within
   ``logit_tolerance`` of each other, the counted attention FLOPs of the
   triangle smaller by exactly the block ratio ``(nq + 1) / (2 nq)``, both
   wall-clocks printed; a triangle that drops the diagonal block must
   break the values and one that walks every pair the ratio.  (d) the
   analysed roofline table (``core.analyzer`` on the card's spec) of the
   five full-size meta cells of the CPU tests on the 32 x 8 mesh, counted
   in a subprocess while (a)-(c) run, with each cell's ``count_seconds``.
   Counters are zeroed before the phase and read after it.
10. **kernels**: each SpMM kernel against its plain PyTorch version on the
   card, on the layout the serving phase packed for it (f32i32) and at
   every other precision its spec declares (bf16i32 at full n, bf16i16 at
   n = 32760, where the slab fits int16 indices); kernel, plain-version
   and ``torch.sparse.mm`` times, the last with A as CSR in B's dtype
   (CUDA events, warm, median); the CSR
   kernel also on the layout that ``scale-free`` auto packed, and at d = 4
   on the layout that ``scale-free`` auto plans at that width (the
   operator and width of ``scalefree.solve-d4``), each CSR row with the
   walk it launched (checked against ``csr_variant``); the row-tile
   kernels with their work list's size (pieces, the largest piece's real
   entries, split tiles); the banded kernel with the diagonals it walks
   (slots read per nonzero) and the B-window mode its launch reported,
   also where n is not a multiple of its 128-row tile (n = 1001, 1002,
   1004), and on HPCG's 27-point stencil at its 104^3 grid (48^3 under
   ``--quick``) as ``auto`` plans it for ``hpcg.stream-d64``, where every
   launch must report mode ``none``; the row-split kernels
   with their fold (carry rows, carries, carry-buffer bytes, empty rows),
   a check that a call allocates less than the ``[C * W, d]`` window
   partials the first version wrote, and a check that two calls give C
   equal bit for bit; the BCSR kernel with the variant each precision
   launched (checked against ``bcsr_variant``), a check that two calls
   give C equal bit for bit, and ``torch.sparse.mm`` with A as BSR (the
   layout's t x t blocks, B's dtype) as a second library time,
   ``library_bsr_ms`` (None, with the error logged, where this torch has
   no such product).  The grouped matmul
   against its plain version on the MoE phase's operands, with
   ``torch._grouped_mm`` (bf16, where this torch has it) or a per-expert
   ``torch.matmul`` loop as the library time; the check must reject two
   planted faults (a dropped k-slice, +0.1 on one row).
11. **paper** (the paper's study, ``configs/paper_spmm.py``): the ten
   matrices of ``paper_suite`` at n = 2**17 (``PAPER_SCALE``, cut from
   2**18 for the run's time; 2**14 under ``--quick``), f32i32, each
   packed once through the ``cuda`` specs at ``plan_d`` 64 and run at
   every ``CONFIG.d_values`` width: the CSR kernel on all ten, BCSR (t =
   ``CONFIG.bcsr_block``) and the banded kernel where the dispatcher's
   policy admits them.  Per (matrix, d), every launch is held against the
   plain CSR version within the SpMM bound below, the kernel's launch
   counter (BCSR's by variant, CSR's by walk too) must rise by exactly
   the calls made,
   and the kernel and ``torch.sparse.mm`` (A as CSR) are timed, after one
   untimed call, warm (10 back to back between one event pair) and cold
   (the least of ``CONFIG.repeats`` single calls, each after a 128 MB
   device write).  Each launch is placed on ``h100_from_device``'s
   roofline: CSR through ``csr_kernel_roofline`` under the ``random``,
   ``diagonal`` and ``scale_free`` models, BCSR through
   ``bcsr_kernel_roofline``, the banded kernel through
   ``dia_kernel_roofline``; each model's time (useful FLOPs over its
   attainable rate) and its share of the cold and warm times are printed,
   with the matrix's classified regime and the model nearest the cold
   time (|log ratio|).  A share above 1.0 is printed on an ``above
   roofline`` line, not failed.  Last, the tallies of the nearest model
   by regime and of the shares above 1.0; the cells go to
   ``chiprun_out/paper_suite.json``.  The layouts are freed before the
   next phase.
12. **engine** (the serving-engine path): ``repro_torch.launch.serve``'s
   ``serve_spmm_engine`` with the default engine settings (8 MiB staging
   budget, queue 256, policy ``wait``, 2000 requests/s per stream), twice:
   at full width on ``moe-block`` at n = 2**20 with d = 64 and 32, 4 streams
   x 4 requests (about 3 GiB of pinned host operands, drawn before the
   clock), on the plan and dispatcher the serving phase built (nothing is
   packed again); and at the reference CLI's default shape, n = 4096, 4
   streams x 64 requests, where batches coalesce.  ``serve_spmm_engine``
   reads the counters just before the engine starts and just after it
   stops (its warm-up and the sync replay fall outside); the chosen
   kernel's launches must equal the planned-width blocks of the batch log
   (row-split: up to two per block).  Every ticket's C is held against
   the chosen format's ``torch`` backend (the plain version) on its B,
   and against ``plan.execute_wide`` of it; at full width staging must
   have overlapped (a next batch's H2D enqueued before the current
   batch's end event completed) and
   ``execute_wide`` on a moe-block batch must return to the host before
   its end event completes.  Printed: the engine's and the sync baseline's
   p50, p99 and goodput, batches and coalesced requests, and per batch the
   H2D / kernel / D2H split from CUDA events.  (``--quick``: n = 2**14 for
   the first run; the overlap and the async return are printed, not
   enforced: at that size the device work is too short to outlast the
   host's staging.)
13. **shard** (the sharded tier): ``ShardMesh(["cuda:0"] * 4)`` over the
   four ``serving_suite`` structures at n = 2**18 (cut from 2**20 to keep
   classification and packing of the unsharded and four sharded layouts
   per strategy inside the phase's time; 2**12 under ``--quick``), plus
   ``scale-free`` forced onto binned and rowsplit (at 2**18 auto already
   picks ell_coo on ``scale-free`` and ``uniform``), at every eligible
   ``b_strategy``: C held against the unsharded ``cuda`` plan, each
   plan's ``summary()``, and a p50 of 8 requests per strategy beside its
   predicted time.  Then one ``serve --spmm-stream --spmm-shards -1`` run
   (one shard per visible card), its C held against the unsharded plan.
14. **harvest**: ``repro_torch.launch.harvest_dispatch`` on the vendored
   corpus with the ``cuda`` kernels, d = 32 and 128, 3 repeats, the tree
   in a temporary store root of its own; its agreement and never-worse
   results are printed, not enforced (at n <= 256 a call is the launch
   path).  CSVs go to ``chiprun_out/harvest``.
15. **multicard** (the process mesh, ``launch/mesh.py``, ``core/comm.py``,
   and the per-shard programs on it): one world of 2 ranks spawned by
   ``launch.spawn.run_world``: NCCL with a card per rank where two or
   more cards are visible, else both ranks on ``cuda:0`` under gloo, whose
   collectives stage the payloads through the host (the phase's first
   line says which; such wire times say nothing of NVLink).  In it: (a)
   olmoe-1b-7b's MoE layer at full width (64 experts, top 8, d 2048, d_ff
   1024; fp32 masters), x ``[4, 512, 2048]`` bf16, capacity factor 1.25,
   expert-parallel on ``(data=1, model=2)`` and ``(data=2, model=1)``
   (FSDP): output and the gradients of x, the router, ``w_gate_up`` and
   ``w_down`` under a sum-of-squares loss against the one-process layer
   on each data shard's tokens (capacity is local; every rank computes
   every shard's), within
   ``models.model.rounding_tolerance`` of the roundings where the two
   differ at each row's scale (``mc_ratio``); 4 grouped launches per
   rank; the buffer shape and the counted bytes per kind; planted faults
   (the ``psum_scatter`` left out, a wrong ``e0``) must break the output
   bound.  (c) ``compressed_psum`` over ``data`` of the one-process
   layer's gradients on each rank's shard: the mean equal to ``sum_i q_i
   * s_max / n`` bit for bit, within ``sum_i (|q_i| |s_max - s_i| + s_i
   / 2) / n`` of the exact mean (half a quantum when the scales agree),
   and ``q * scale + residual == g + residual``.  (b) olmoe-1b-7b's first 4
   layers (fp32 masters, bf16 compute) as a GPipe pipeline of 2 stages x
   2 layers over 4 microbatches of 1 x 512 (``train.pipeline``): outputs
   and every stage's gradients under a sum-of-squares loss against the
   sequential stack on one process, 16 grouped launches per stage, and a
   reversed ``perm`` that must break the output bound.  (d) the sharded
   tier on a ``(shard=2)`` mesh, ``moe-block`` and ``banded`` at n =
   2**18 and ``uniform`` (the CSR kernel) at 2**16, d = 64, f32i32, every
   eligible B strategy: C gathered
   against the unsharded plan and the in-process ``ShardedPlan``, one
   launch of the chosen kernel per rank.  (e) the policy-partitioned steps
   (``train.train_step`` over a ``ProcessMesh``): (e1) olmoe-1b-7b at full
   width, 2 of 16 layers, fp32 masters and bf16 compute, batch 4 x 512, on
   ``(data=1, model=2)`` against the one-process port on the same card
   from the same seed (which runs first, its blocks kept on the host, and
   whose routing the partitioned model replays, so that the two differ
   only by roundings; the rows where its own router would have chosen
   otherwise are counted): the forward's vocab block of the logits and
   the loss, then steps 1 and 2 (loss, ``grad_norm``, every gradient and
   parameter block) within ``models.model.rounding_tolerance``
   (``mc_gspmd_train``); 12 grouped launches per rank and step; the
   counted bytes per kind beside ``core.collectives.step_collectives``;
   planted faults (the row-parallel outputs left unsummed, the
   vocab-parallel logsumexp without its ``psum``) must break their
   bounds.  (e2) the partitioned prefill on ``(data=2, model=1)`` (FSDP,
   1 layer, bf16 weights): each rank's logits equal to the one-process
   forward on its rows bit for bit; the FSDP blocks gathered in reversed
   order must differ.  (e3)-(e6) the partitioned train steps of the other
   families on ``(data=1, model=2)`` at full width, fp32 masters and bf16
   compute, steps 1 and 2 against the one-process port (which each rank
   runs in turn, keeping its blocks on the host, before the partitioned
   model is built; step 2 starts from its step-1 parameters): (e3)
   recurrentgemma-9b (rglru, rglru, local) at 1 x 4096, past its
   2048-token window; (e4) falcon-mamba-7b, 2 of 64 layers, 2 x 512 (two
   scan chunks); (e5) whisper-base whole at 4 x 448 with its 1,500
   frames, then its cross cache primed over the mesh (``LM.encode``,
   ``LM.prime_cross_cache``) and 4 serve steps; (e6) qwen2-vl-7b, 2 of 28
   layers, 2 x 512 on the pipeline's ``mm_embeds`` and ``positions_3d``
   (``mc_family_case``): the logits block and loss, each step's loss,
   ``grad_norm``, gradient and parameter blocks within their rounding
   bounds (``mc_roundings`` counts each rank's partial sums per layer
   kind); one planted fault each must break its bound (``mc_fault``:
   the RG-LRU conv's channel block from the other rank, ``x_proj``'s
   partial sums left unsummed, the encoder output's cotangent left
   unsummed over ``model`` (held at fp32), 1-D RoPE for M-RoPE); no port
   kernel launches; bytes beside ``step_collectives``, step ms, peak
   memory and seconds per rank.  (f) the serve step over a mesh
   (``make_serve_step``
   over a ``ProcessMesh``, the decode cache split along its sequence, the
   recurrent states by channels) on ``(data=1, model=2)``, bf16, batch 4,
   8 steps from a cache filled below the start from a seed
   (``mc_fill_cache``): (f1) olmoe-1b-7b at full width, 2 of 16 layers,
   cache 4096, pos 2044..2051 across the two ranks' block boundary;
   (f2) recurrentgemma-9b at full width, (rglru, rglru, local), its
   2048-slot ring full to pos 2044 and wrapping at 2048.  Each against the
   one-process ``decode_step`` on the same card (whose routing (f1)
   replays): every step's logits block, every attention output and the
   final K/V, ``h`` and ``conv`` blocks within their rounding bounds
   (``mc_serve_case``); planted faults must break one: the combine
   without its ``e^{m - m*}`` rescale and the K/V written on every rank
   (f1), the RG-LRU's gate blocks from the other rank (f2); grouped
   launches per rank 2 x 2 x 8; bytes per kind beside
   ``step_collectives``, step ms, peak memory.  Then a world of one rank on
   NCCL in this process runs every ``core.comm`` op once, and, on one
   card, a world of two ranks on ``cuda:0`` under NCCL must be refused
   (its message is printed).  Every kernel of the path must have launched
   on every rank (``multicard_launches``, per rank, in the record).
   ``--quick``: 2 x 128 tokens, 2 layers ((e1): 1), n = 2**12, (e3)-(e6)
   at 1 layer and 256 tokens, (f)'s cache 256.

Each phase prints its seconds.

Tolerance: each side of an SpMM comparison is allowed ``4 * eps * (|A| @
|B|) + 5e-4 + 5e-4 * |C|`` (eps of the value dtype), the bound of
``tests/test_differential.py``; a comparison of two computed sides is
allowed the sum of both.  The grouped matmul forms its products exactly
in fp32, so each side is allowed ``4 * eps_f32 * (|x| @ |w|) + 5e-4``
plus one rounding to the output dtype (``moe_block.grouped_tolerance``),
on the routed rows; the padding rows must be 0.  The train phase's
gradients are far smaller than that ``5e-4`` floor, so they are held
without it (``grad_ratio``).

``bound_ms`` counts what the inputs need: A in the smaller of two forms
(CSR at the layout's widths, i.e. nnz * (value + column index) bytes plus
(n + 1) int32 row pointers, or the packed layout's own bytes, which is
smaller for a blocked layout), B read once and C written once, against
2 * nnz * d operations; ``bound_layout_ms`` puts the bytes of the layout
the kernel reads (padding included) in place of A's: the packed arrays,
for the banded kernel its diagonals.  The grouped matmul's TFLOP/s count 2 * K * N per padded
row and per routed row; its tile traffic is what its tiling copies into
shared memory (each output tile's x rows and w columns), over kernel ms.

The last lines are the ``{"kernels": [...]}`` record (each kernel with
its launches per path, ``families_launches`` and ``recurrent_launches``
0, ``dryrun_launches`` the grouped matmul's in ``[dryrun]``,
``paper_launches`` those of ``[paper]``; the grouped
matmul's with the ``lm``, ``train`` and ``dryrun`` phases' figures), the
card's name and power
limit from ``nvidia-smi``, and ``{"ok": true, "device": ...}``.
Without a GPU, or without the port beside it, the script exits nonzero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: Published H100 SXM peaks (vendor data sheet, dense): HBM bytes/s and
#: FLOP/s by operand type (fp32 on CUDA cores, bf16 on tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

ATOL = RTOL = 5e-4
D = 64
STEPS = 8
#: n for the bf16i16 rows: int16 slab-local indices need n <= 32767.
N_INT16 = 32760
#: log2 n of the calibration sweep under ``--quick`` (the full run sweeps
#: at ``repro_torch.core.calibrate.CARD_SCALE``).
CAL_SCALE_QUICK = 14

#: The serving phase: (structure, forced strategy or "auto").
SERVE_RUNS = (("moe-block", "auto"), ("banded", "auto"),
              ("scale-free", "auto"), ("uniform", "auto"),
              ("scale-free", "binned"), ("scale-free", "rowsplit"))

#: The MoE phase: qwen3-moe-235b-a22b's expert FFN (src/repro/configs/
#: qwen3_moe_235b_a22b.py), and a small shape for ``--quick``.
MOE_FULL = {"tokens": 4096, "experts": 128, "top_k": 8, "d_model": 4096,
            "d_ff": 1536}
MOE_QUICK = {"tokens": 512, "experts": 16, "top_k": 2, "d_model": 256,
             "d_ff": 256}
MOE_DTYPES = ("bfloat16", "float32")

#: Kernel name -> (its CUDA source, the TPU kernel it replaces, the
#: serving run whose layout the kernel phase measures, its formats).
KERNELS = {
    "csr_spmm": ("src/repro_torch/csrc/csr_spmm.cu",
                 "src/repro/kernels/csr_spmm.py:172", ("uniform", "auto"),
                 ("csr", "ell", "ell_coo")),
    "binned_spmm": ("src/repro_torch/csrc/binned_spmm.cu",
                    "src/repro/kernels/binned_spmm.py:142",
                    ("scale-free", "binned"), ("binned",)),
    "rowsplit_spmm": ("src/repro_torch/csrc/rowsplit_spmm.cu",
                      "src/repro/kernels/binned_spmm.py:297",
                      ("scale-free", "rowsplit"), ("rowsplit",)),
    "bcsr_spmm": ("src/repro_torch/csrc/bcsr_spmm.cu",
                  "src/repro/kernels/bcsr_spmm.py:49", ("moe-block", "auto"),
                  ("bcsr",)),
    "banded_spmm": ("src/repro_torch/csrc/banded_spmm.cu",
                    "src/repro/kernels/banded_spmm.py:36", ("banded", "auto"),
                    ("dia",)),
}

#: The MoE path's kernel: (its CUDA source, the TPU kernel it replaces).
GROUPED = ("src/repro_torch/csrc/grouped_matmul.cu",
           "src/repro/kernels/grouped_matmul.py:40")

#: Further serving runs whose operator a kernel is also timed on:
#: (structure, strategy, d).  At d = D the run's own layout; at another d
#: the layout the strategy plans at that width, with the benchmark's
#: reuse (``SOLVE_REUSE``): scale-free at d = 4 is ``scalefree.solve-d4``'s
#: width, where the CSR kernel takes its narrow walk.
EXTRA_RUNS = {"csr_spmm": (("scale-free", "auto", D),
                           ("scale-free", "auto", 4))}
#: Requests a plan is reused for in ``EXTRA_RUNS`` at another d (the
#: benchmark's solve traffic, ``bench/traffic/solve-d4.json``).
SOLVE_REUSE = 4096
#: HPCG's 27-point stencil, on which the banded kernel is also timed: the
#: side of its cube grid (HPCG's default ``hpcg.dat`` local grid, as the
#: benchmark's ``hpcg.stream-d64`` runs it; 48 under ``--quick``), and the
#: requests its plan is reused for (``bench/traffic/stream-d64.json``).
#: Its diagonals span 2 * (side**2 + side + 1) rows, so at d = D no
#: launch stages a B window: each must report mode ``none``.
HPCG_SIDE = 104
HPCG_SIDE_QUICK = 48
STREAM_REUSE = 4096

#: Numbers of an SpMM kernel's row that the record carries.
RECORD_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "bound_layout_ms", "stored_per_nnz",
               "read_per_nnz", "diagonals", "window", "pieces",
               "largest_piece_nnz", "split_tiles", "real_slots",
               "carry_rows", "carries", "carry_bytes", "empty_rows",
               "call_alloc_bytes", "partials_bytes", "variant",
               "library_bsr_ms", "walk", "lanes")

#: Every kernel, in the order of the record.
KERNEL_NAMES = (*KERNELS, "grouped_matmul")

#: The LM phase: ``serve --arch`` at the reference CLI's defaults (batch 4,
#: prompt 32, 16 generated tokens) on olmoe-1b-7b at full width and depth
#: (src/repro/configs/olmoe_1b_7b.py); ``--quick`` cuts it to 2 layers.
LM_ARCH = "olmoe-1b-7b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 16
LM_QUICK_LAYERS = 2
#: Teacher-forced steps of the kernel-against-plain check on the model.
LM_CHECK_STEPS = 4

#: The families phase: gemma3-12b, whisper-base and qwen2-vl-7b through
#: ``serve --arch`` at full width, gemma3-12b at 12 of its 48 layers and
#: qwen2-vl-7b at 14 of 28 (``FAMILIES_LAYERS``, the depth cut that keeps
#: the whole run near 950 s; whisper-base whole;
#: ``--quick``: gemma3's one pattern period, qwen2-vl's first 2 layers);
#: the ring check at full width over 1536 tokens (3 q blocks of 512; the
#: 1024-slot rings wrap at step 1024) on gemma3's two kinds of layer, one
#: local and the global (``RING_PATTERN``: a window and the rings behave
#: alike in each local layer of the period), its planted decode faults
#: over the first 64 steps; whisper's decode-vs-forward check over 48 steps of
#: batch 4; qwen2-vl's over 256 steps of batch 4 on ``VLM_CHECK_LAYERS``
#: layers (the pipeline's stubs put 64 patch tokens on an 8 x 8 grid,
#: whose first 64 steps the M-RoPE fault runs); qwen2-vl's forward of the
#: pipeline's stubs at 1 x 1024 (256 patch tokens on a 16 x 16 grid).
FAMILIES_LAYERS = {"gemma3-12b": 12, "qwen2-vl-7b": 14}
FAMILIES_QUICK_LAYERS = {"gemma3-12b": 6, "qwen2-vl-7b": 2}
RING_TOKENS, RING_FAULT_STEPS = 1536, 64
RING_PATTERN = ("local", "global")
WHISPER_STEPS, VLM_CHECK_STEPS = 48, 256
#: qwen2-vl-7b's decode-vs-forward check runs on its first 4 layers of
#: 28 (2 under ``--quick``), the depth cut to keep the whole run near 900
#: s: the M-RoPE fault shows at layer 0.
VLM_CHECK_LAYERS, VLM_CHECK_LAYERS_QUICK = 4, 2
VLM_FORWARD = (1, 1024)

#: The recurrent phase: falcon-mamba-7b and recurrentgemma-9b through
#: ``serve --arch`` at full width, 16 of 64 and 19 of 38 layers (one
#: pattern period; ``RECURRENT_LAYERS``, the depth cut that keeps the
#: whole run near 950 s; ``--quick``: 2 layers, one pattern period); the decode-vs-forward check at full width on a
#: cut depth, (layer pattern or None for the config's, layers, tokens):
#: falcon-mamba's first 4 layers over 1 x 512 tokens (two scan chunks of
#: 256), recurrentgemma's (rglru, rglru, local) over 1 x 1024 (two RG-LRU
#: chunks of 512; its 2048-slot ring does not wrap); decode faults over
#: the first 64 steps.
RECURRENT_ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b")
RECURRENT_LAYERS = {"falcon-mamba-7b": 16, "recurrentgemma-9b": 19}
RECURRENT_QUICK_LAYERS = {"falcon-mamba-7b": 2, "recurrentgemma-9b": 19}
RECURRENT_CHECKS = {"falcon-mamba-7b": (None, 4, 512),
                    "recurrentgemma-9b": (("rglru", "rglru", "local"), 3,
                                          1024)}
RECURRENT_FAULT_STEPS = 64

#: The train phase: ``Trainer`` on olmoe-1b-7b at full width with the
#: depth cut from 16 to 2 layers (fp32 masters, gradients and AdamW's mu
#: and nu hold 16 B per parameter: 111 GB at full depth, 16.7 GB at 2; cut
#: from 4 so that the whole run stays near 900 s, the checkpoint's save
#: and restore being most of the phase), batch 4 x sequence 512, 8 steps
#: at lr 3e-4 (warmup 2, cosine to step 8), preempted after 4 steps and
#: resumed from its checkpoint; ``--quick`` cuts it to 1 layer.
TRAIN_LAYERS, TRAIN_QUICK_LAYERS = 2, 1
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, TRAIN_STOP = 8, 4
TRAIN_LR = 3e-4
TRAIN_SCHEDULE = {"warmup_steps": 2, "total_steps": TRAIN_STEPS}
#: Bytes per parameter a train step must move at the least: AdamW reads
#: the master, the gradient, mu and nu and writes the master, mu and nu
#: (28, fp32 state); the backward writes the gradient (4); the forward and
#: the backward each read the master once (8); the layers' masters are
#: read once more by the recompute (``TRAIN_RECOMPUTE_BYTES``).
TRAIN_BYTES_PER_PARAM = 28 + 4 + 8
TRAIN_RECOMPUTE_BYTES = 4

#: The dry-run phase: llama3.2-1b's prefill length for masked against
#: triangle attention (and under ``--quick``), and the full-size meta
#: cells whose roofline table it prints (the CPU tests' cells).
DRYRUN_PREFILL, DRYRUN_PREFILL_QUICK = 4096, 1024
DRYRUN_CELLS = (("olmoe-1b-7b", "train_4k"), ("gemma3-12b", "prefill_32k"),
                ("falcon-mamba-7b", "long_500k"),
                ("whisper-base", "decode_32k"),
                ("qwen3-moe-235b-a22b", "train_4k"))

#: The engine phase: (tag, n or None for the run's n, requests per stream).
ENGINE_RUNS = (("full width", None, 4), ("CLI default shape", 4096, 64))
ENGINE_STREAMS = 4
#: The shard phase's structures, its n (cut from 2**20, see the
#: docstring) and the forced formats it also shards.
SHARD_STRUCTURES = ("moe-block", "banded", "scale-free", "uniform")
SHARD_N = 2 ** 18
SHARD_N_QUICK = 2 ** 12
SHARD_FORCED = ("binned", "rowsplit")
SHARD_DEVICES = 4

#: The paper phase: ``paper_suite`` at n = 2**17 (the paper's matrices
#: are 2**22).  2**18 is the least n at which B alone at d = 64 in fp32
#: (64 MB) exceeds the card's 50 MB L2, the paper's out-of-cache regime,
#: but generating, planning and packing the ten matrices there took 94 s
#: of the card host's CPU, which would take the whole run past 950 s; at
#: 2**17, B and C at d = 64 (32 MB each) exceed the L2 together, each
#: alone not.  ``paper_phase(..., scale=18)`` runs the suite there alone.
#: 2**14 under ``--quick``.
PAPER_SCALE, PAPER_SCALE_QUICK = 17, 14
#: Format -> the kernel that runs it, in the phase's order.  CSR runs on
#: every matrix, BCSR and the banded kernel where the policy admits them.
PAPER_KERNELS = {"csr": "csr_spmm", "bcsr": "bcsr_spmm",
                 "dia": "banded_spmm"}
#: The regime models every CSR launch is placed under.
PAPER_REGIMES = ("random", "diagonal", "scale_free")
#: Bytes written before each cold launch: over twice the L2.
FLUSH_BYTES = 128 * 2 ** 20
#: Back-to-back launches of one warm time.
PAPER_WARM = 10


class SmokeFailure(RuntimeError):
    """A phase found the port wrong."""


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text: str) -> list:
    """``ptxas -v``'s lines per kernel function: the function, registers
    and shared memory, stack and spills, and any performance warning."""
    keep = ("Compiling entry function", "registers", "spill",
            "Performance", "setmaxnreg", "wgmma")
    return [line.strip() for line in text.splitlines()
            if any(k in line for k in keep)]


def abs_product(m, b):
    """``|A| @ |B|`` in fp32 on B's device, from the row-major COO."""
    import torch
    from repro_torch.sparse.spmm import segment_sum
    dev = b.device
    out = torch.zeros(m.n, b.shape[1], dtype=torch.float32, device=dev)
    return segment_sum(
        out, b.abs().to(torch.float32), torch.from_numpy(m.cols).to(dev),
        torch.from_numpy(abs(m.vals).astype("float32")).to(dev),
        torch.from_numpy(m.rows).to(dev))


def check_close(what: str, got, ref, absprod, eps: float) -> tuple:
    """Hold ``got`` against ``ref``; both computed, so the bound is the sum
    of both sides' bounds.  Returns ``(max_abs_err, worst_margin)``."""
    import torch
    if tuple(got.shape) != tuple(ref.shape):
        raise SmokeFailure(f"{what}: shape {tuple(got.shape)} vs "
                           f"{tuple(ref.shape)}")
    g, r = got.to(torch.float32), ref.to(torch.float32)
    if not bool(torch.isfinite(g).all()):
        raise SmokeFailure(f"{what}: non-finite values")
    err = (g - r).abs()
    bound = 2 * (4 * eps * absprod + ATOL) + RTOL * (g.abs() + r.abs())
    worst = float((err - bound).max())
    max_err = float(err.max())
    if worst > 0:
        raise SmokeFailure(f"{what}: max |err| {max_err:.3e} exceeds the "
                           f"bound by {worst:.3e}")
    return max_err, worst


def layout_bytes(layout) -> int:
    """Bytes of a layout's packed tensor fields, padding included."""
    import dataclasses
    import torch
    return sum(v.numel() * v.element_size()
               for f in dataclasses.fields(layout)
               if f.name not in LAYOUT_SKIP
               for v in [getattr(layout, f.name)]
               if isinstance(v, torch.Tensor))


def work_list_size(layout) -> dict:
    """Size of a row-tile layout's work list: pieces, the largest piece's
    real entries, split tiles (CSR)."""
    import torch
    if not hasattr(layout, "piece_ptr"):
        return {}
    ends = torch.cumsum(layout.chunk_len.long(), 0)
    ends = torch.cat([ends.new_zeros(1), ends])
    ptr = layout.piece_ptr.long()
    per_piece = ends[ptr[1:]] - ends[ptr[:-1]]
    out = {"pieces": layout.num_pieces,
           "largest_piece_nnz": int(per_piece.max()),
           "real_slots": int(ends[-1]), "slots": layout.vals.numel()}
    if hasattr(layout, "split_tiles"):
        out["split_tiles"] = int(layout.split_tiles.numel())
    return out


def torch_csr(m, dev, dtype=None):
    """A as a ``torch.sparse`` CSR tensor (fp32 unless ``dtype``): the
    library yardstick."""
    import numpy as np
    import torch
    crow = torch.from_numpy(m.row_ptr().astype(np.int64)).to(dev)
    col = torch.from_numpy(m.cols.astype(np.int64)).to(dev)
    val = torch.from_numpy(m.vals.astype(np.float32)).to(dev, dtype)
    return torch.sparse_csr_tensor(crow, col, val, size=(m.n, m.n))


def torch_backend(plan, m, disp, dev):
    """The plain PyTorch version of ``plan``'s choice: its format's
    ``"torch"`` backend bound to ``m`` on ``disp`` (conversions reused)."""
    from repro_torch.core.precision import as_precision
    from repro_torch.kernels import registry
    prec = as_precision(plan.precision)
    ctx = registry.KernelContext(
        bcsr_block=disp.bcsr_block, plan_d=D, precision=prec,
        convert=lambda mm, f, _p=prec: disp.convert(mm, f, precision=_p),
        device=dev)
    return registry.get(plan.chosen, "torch").bind(m, ctx)


def serve_run(structure: str, strategy: str, m, disp, n: int, steps: int,
              dev, tag: str = "") -> dict:
    """Serve one run through ``serve_spmm_stream`` on ``disp``; the chosen
    format's kernel must launch, and the last request's C must match the
    port's ``"torch"`` backend on the card."""
    from repro_torch import kernels
    from repro_torch.core.precision import as_precision
    from repro_torch.kernels import bcsr_spmm as bcsr_module
    from repro_torch.launch import serve

    what = f"{structure}/{strategy}{tag}"
    args = serve.parser().parse_args(
        ["--spmm-stream", "--spmm-structure", structure,
         "--spmm-n", str(n), "--spmm-d", str(D),
         "--spmm-steps", str(steps), "--spmm-strategy", strategy,
         "--device", str(dev)])
    before = kernels.launch_counts()
    variants_before = dict(bcsr_module.LAUNCHES_BY_VARIANT)
    log(f"[serve] === {structure} (strategy {strategy}{tag}) ===")
    rec = serve.serve_spmm_stream(args, dispatcher=disp, matrix=m)
    after = kernels.launch_counts()
    plan = rec["plan"]
    kernel = next(k for k, v in KERNELS.items() if plan.chosen in v[3])
    delta = after[kernel] - before[kernel]
    log(f"[serve] {what}: chosen {plan.chosen} @ {plan.precision} -> "
        f"kernel {kernel}, launches +{delta}; startup "
        f"{rec['startup_ms']:.1f} ms, p50 {rec['p50_us']:.1f} us, p99 "
        f"{rec['p99_us']:.1f} us, {rec['gflops']:.2f} GFLOP/s")
    if delta <= 0:
        raise SmokeFailure(f"{what}: kernel {kernel} of the chosen format "
                           f"{plan.chosen} never launched")
    prec = as_precision(plan.precision)
    if kernel == "bcsr_spmm":
        bcsr_fast_path(structure, plan.layout.t, prec.value_torch, delta,
                       variants_before)
    # Hold the last request's C against the torch backend on the card.
    b, c = rec["last"]
    ref = torch_backend(plan, m, disp, dev)(b)
    err, _ = check_close(f"{what} C vs torch backend", c, ref,
                         abs_product(m, b), prec.eps)
    log(f"[serve] {what}: C {tuple(c.shape)} finite, max |C - torch| = "
        f"{err:.3e} within bound")
    del ref
    empty_cache(dev)
    return dict(rec, kernel=kernel, launches=delta)


def serve_phase(n: int, steps: int, dev) -> dict:
    """The main path: serve every run under the default ceilings, then plan
    the auto structures under the calibrated ones and serve again each
    whose choice changed; hold every C against the torch backend."""
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.sparse.dispatch import Dispatcher

    matrices, dispatchers, runs = {}, {}, {}
    kernels.reset_launch_counts()
    for structure, strategy in SERVE_RUNS:
        if structure not in matrices:
            t0 = time.perf_counter()
            matrices[structure] = serve.build_stream_matrix(structure, n)
            # The default ceilings: the kernel phase measures the layouts
            # these runs pack, whatever the calibration would pick.
            dispatchers[structure] = Dispatcher(device=dev,
                                                calibration=False, tree=False)
            log(f"[serve] built {structure} n={n} "
                f"nnz={matrices[structure].nnz} in "
                f"{time.perf_counter() - t0:.1f}s")
        runs[(structure, strategy)] = serve_run(
            structure, strategy, matrices[structure],
            dispatchers[structure], n, steps, dev)
    choices = calibrated_choices(matrices, runs, n, steps, dev)
    counts = kernels.launch_counts()
    log(f"[serve] launches on the serving path: {counts}")
    return {"runs": runs, "counts": counts, "matrices": matrices,
            "dispatchers": dispatchers, "choices": choices}


def _predictions(plan) -> str:
    return ", ".join(
        f"{c.format} {c.predicted_gflops:.1f}" for c in plan.candidates
        if c.eligible and c.precision == "f32i32")


def calibrated_choices(matrices: dict, runs: dict, n: int, steps: int,
                       dev) -> dict:
    """Plan each auto structure under the calibrated ceilings (classify and
    plan only) beside its default plan; where the choice differs, serve it
    again under the calibrated plan."""
    from repro_torch.sparse.dispatch import Dispatcher

    out = {}
    for structure, strategy in SERVE_RUNS:
        if strategy != "auto":
            continue
        m = matrices[structure]
        served = runs[(structure, "auto")]
        default = served["plan"].dispatch
        disp = Dispatcher(device=dev, tree=False)
        plan = disp.plan(m, D, reuse=steps)
        chosen = plan.candidate(plan.chosen, plan.precision)
        if chosen.ceiling_source != "calibrated":
            raise SmokeFailure(f"{structure}: the calibrated plan's "
                               f"{plan.chosen} reads "
                               f"{chosen.ceiling_source} ceilings")
        pred_default = default.candidate(
            default.chosen, default.precision).predicted_gflops
        log(f"[serve] calibrated {structure}: default ceilings choose "
            f"{default.chosen} @ {default.precision} (predicted "
            f"{pred_default:.2f} GFLOP/s, served {served['gflops']:.2f}); "
            f"calibrated ceilings choose {plan.chosen} @ {plan.precision} "
            f"(predicted {chosen.predicted_gflops:.2f} GFLOP/s)")
        log(f"[serve] calibrated {structure}: predicted GFLOP/s by format, "
            f"default: {_predictions(default)}; calibrated: "
            f"{_predictions(plan)}")
        rec = {"default": default.chosen, "calibrated": plan.chosen,
               "predicted_default": pred_default,
               "predicted_calibrated": chosen.predicted_gflops,
               "served_default_gflops": served["gflops"]}
        if (plan.chosen, plan.precision) != (default.chosen,
                                             default.precision):
            run = serve_run(structure, "auto", m, disp, n, steps, dev,
                            tag=", calibrated ceilings")
            if run["plan"].chosen != plan.chosen:
                raise SmokeFailure(f"{structure}: served {run['plan'].chosen}"
                                   f" under the calibrated plan "
                                   f"{plan.chosen}")
            runs[(structure, "calibrated")] = run
            rec.update(served_calibrated_gflops=run["gflops"],
                       p50_us=run["p50_us"], p99_us=run["p99_us"])
        out[structure] = rec
    return out


def bcsr_fast_path(structure: str, t: int, dtype, launches: int,
                   before: dict) -> None:
    """A serving run's BCSR launches must all have taken the variant
    ``bcsr_variant`` names for (t, d, dtype); ``moe-block``'s a fast one."""
    from repro_torch.kernels import bcsr_spmm as bcsr_module
    want = bcsr_module.bcsr_variant(t, D, dtype)
    moved = {k: v - before[k]
             for k, v in bcsr_module.LAUNCHES_BY_VARIANT.items()
             if v != before[k]}
    log(f"[serve] {structure}: bcsr_spmm launches by variant {moved} "
        f"(t={t}, d={D}, {dtype})")
    if moved != {want: launches}:
        raise SmokeFailure(f"{structure}: bcsr_spmm launched {moved}, not "
                           f"{launches} x {want}")
    if structure == "moe-block" and want == "generic":
        raise SmokeFailure(f"moe-block: bcsr_spmm took the generic kernel "
                           f"at t={t}, {dtype}")


def moe_phase(quick: bool, dev) -> dict:
    """The MoE path at each dtype: route, block, grouped matmul, checked
    row by row against the experts' dense products."""
    from repro_torch import kernels
    from repro_torch.launch import moe_block

    widths = MOE_QUICK if quick else MOE_FULL
    runs = {}
    kernels.reset_launch_counts()
    for dtype in MOE_DTYPES:
        argv = [f"--{k.replace('_', '-')}={v}" for k, v in widths.items()]
        argv += ["--bm=128", "--bk=128", "--bn=128", f"--dtype={dtype}",
                 "--seed=0", f"--device={dev}"]
        log(f"[moe] === {dtype}: {' '.join(argv)} ===")
        before = kernels.launch_counts()["grouped_matmul"]
        rec = moe_block.main(argv)
        delta = kernels.launch_counts()["grouped_matmul"] - before
        log(f"[moe] {dtype}: {rec['routed'].x.shape[0]} block-aligned rows, "
            f"max |out - x @ w[expert]| {rec['max_abs_err']:.3e} within "
            f"bound, grouped_matmul launches +{delta}, route "
            f"{rec['route_ms']:.1f} ms, first matmul {rec['matmul_ms']:.1f} "
            f"ms")
        if delta <= 0:
            raise SmokeFailure(f"moe {dtype}: grouped_matmul never launched")
        runs[dtype] = {"w": rec["w"], "routed": rec["routed"]}
        del rec
        empty_cache(dev)
    counts = kernels.launch_counts()
    log(f"[moe] launches on the MoE path: {counts}")
    return {"runs": runs, "counts": counts, "widths": widths}


def empty_cache(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


#: Layout fields left out of ``layout_bytes``: the plain versions' owner
#: ids, and the work list and carry lists derived from the packed arrays.
LAYOUT_SKIP = {"tile_ids", "chunk_visits", "block_rows", "chunk_len",
               "piece_ptr", "piece_owner", "piece_split", "split_tiles",
               "last_slot", "shared", "carry_rows", "carry_chunks",
               "empty_rows"}


def diagonal_walk_size(layout, m) -> dict:
    """The banded kernel's walk: diagonals and slots read per nonzero
    (k * n / nnz)."""
    if not hasattr(layout, "diags"):
        return {}
    return {"diagonals": int(layout.offsets.shape[0]),
            "read_per_nnz": layout.diags.numel() / max(m.nnz, 1)}


def banded_window_run(layout, wrapper, b) -> dict:
    """The banded kernel's B window: a call must make one launch, and
    report the mode it chose."""
    if not hasattr(layout, "diags"):
        return {}
    from repro_torch.kernels import banded_spmm as banded_module
    before = dict(banded_module.LAUNCHES_BY_WINDOW)
    wrapper(layout, b)
    moved = {k: v - before[k]
             for k, v in banded_module.LAUNCHES_BY_WINDOW.items()
             if v != before[k]}
    if sorted(moved.values()) != [1]:
        raise SmokeFailure(f"banded_spmm (d = {b.shape[1]}): a call "
                           f"counted {moved}, not one launch in one mode")
    return {"window": next(iter(moved))}


def stencil27_matrix(side: int, rng):
    """HPCG's 27-point stencil on a ``side``-cube grid, as the benchmark's
    generator makes it (``bench/gen/stencil27.py``, on the host), with
    values uniform in [0.5, 1.5), as row-sorted COO."""
    import torch
    from bench.gen import stencil27
    from repro_torch.core.patterns import COOMatrix
    n = side ** 3
    rows, cols = stencil27.generate(
        n, {"nx": side, "ny": side, "nz": side}, torch.Generator())
    return COOMatrix(n=n, rows=rows.numpy(), cols=cols.numpy(),
                     vals=rng.uniform(0.5, 1.5, rows.numel()),
                     pattern="diagonal",
                     meta={"achieved_nnz": rows.numel(),
                           "achieved_avg_degree": rows.numel() / n})


def carry_fold_size(layout, wrapper, b) -> dict:
    """The row-split fold: carry rows, the carries they sum, the carry
    buffer's bytes and the rows with no entry.  A call must allocate less
    than the ``[C * W, d]`` fp32 window partials of the first version, and
    two calls must give C equal bit for bit."""
    import torch
    if not hasattr(layout, "carry_rows"):
        return {}
    dev, d = b.device, b.shape[1]
    span = layout.carry_chunks.long()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    first = wrapper(layout, b)
    torch.cuda.synchronize(dev)
    alloc = torch.cuda.max_memory_allocated(dev) - base
    partials = layout.num_chunks * layout.window * d * 4
    if alloc >= partials:
        raise SmokeFailure(f"rowsplit_spmm allocated {alloc} bytes, no less "
                           f"than the {partials} of [C * W, d] partials")
    second = wrapper(layout, b)
    bits = torch.int32 if first.dtype == torch.float32 else torch.int16
    if not torch.equal(first.view(bits), second.view(bits)):
        raise SmokeFailure(f"rowsplit_spmm ({b.dtype}): two calls differ")
    del first, second
    return {"carry_rows": int(span.shape[0]),
            "carries": int((span[:, 1] - span[:, 0] + 1).sum()),
            "carry_bytes": layout.num_chunks * 2 * d * 4,
            "empty_rows": int(layout.empty_rows.numel()),
            "call_alloc_bytes": alloc, "partials_bytes": partials}


def bcsr_variant_run(layout, wrapper, b) -> dict:
    """The BCSR kernel's variant: a call must launch the one
    ``bcsr_variant`` names, and two calls must give C equal bit for bit."""
    import torch
    if not hasattr(layout, "block_ptr"):
        return {}
    from repro_torch.kernels import bcsr_spmm as bcsr_module
    want = bcsr_module.bcsr_variant(layout.t, b.shape[1], b.dtype)
    before = dict(bcsr_module.LAUNCHES_BY_VARIANT)
    first = wrapper(layout, b)
    second = wrapper(layout, b)
    moved = {k: v - before[k]
             for k, v in bcsr_module.LAUNCHES_BY_VARIANT.items()
             if v != before[k]}
    if moved != {want: 2}:
        raise SmokeFailure(f"bcsr_spmm ({b.dtype}): two calls launched "
                           f"{moved}, not 2 x {want}")
    bits = torch.int32 if first.dtype == torch.float32 else torch.int16
    if not torch.equal(first.view(bits), second.view(bits)):
        raise SmokeFailure(f"bcsr_spmm ({b.dtype}): two calls differ")
    del first, second
    return {"variant": want}


def bsr_library_row(layout, b, runs: int) -> dict:
    """``torch.sparse.mm`` with A as BSR of the layout's t x t blocks in
    B's dtype, or None (the error logged) where this torch has no such
    product.  The BSR tensor is built from the layout's own block arrays:
    ``to_sparse_bsr((t, t))`` of the CSR tensor gives the same blocks, but
    its conversion time grows faster than n and does not finish at
    n = 2**20 within a run's time limit."""
    import torch
    from repro_torch.core.device import median_ms
    if not hasattr(layout, "block_ptr"):
        return {}
    try:
        a = torch.sparse_bsr_tensor(layout.block_ptr.long(),
                                    layout.block_cols.long(), layout.blocks,
                                    size=(layout.n, layout.n))
        ms = median_ms(lambda: torch.sparse.mm(a, b), runs)
    except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
        log(f"[kernel] torch.sparse.mm with A as BSR at {b.dtype}: "
            f"{type(e).__name__}: {e}")
        ms = None
    empty_cache(b.device)
    return {"library_bsr_ms": ms}


def csr_walk_run(name: str, layout, wrapper, b) -> dict:
    """The CSR kernel's walk: a call must launch the one ``csr_variant``
    names for B's width."""
    if name != "csr_spmm":
        return {}
    from repro_torch.kernels import csr_spmm as csr_module
    walk, lanes = csr_module.csr_variant(b.shape[1])
    before = dict(csr_module.LAUNCHES_BY_VARIANT)
    wrapper(layout, b)
    moved = {k: v - before[k]
             for k, v in csr_module.LAUNCHES_BY_VARIANT.items()
             if v != before[k]}
    if moved != {walk: 1}:
        raise SmokeFailure(f"csr_spmm (d = {b.shape[1]}): a call launched "
                           f"{moved}, not the {walk} walk")
    return {"walk": walk, "lanes": lanes}


def kernel_row(name, layout, m, b, index_bytes: int, runs: int,
               plain_runs: int) -> dict:
    """One kernel against its plain version on one layout, with times; the
    library time is ``torch.sparse.mm`` on A as CSR in B's dtype (None
    where this torch has no such product)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.device import median_ms
    mod = kernels.KERNEL_MODULES[name]
    wrapper = getattr(mod, name)
    plain = getattr(mod, f"{name}_plain")
    out = wrapper(layout, b)
    ref = plain(layout, b)
    eps = float(torch.finfo(b.dtype).eps)
    err, margin = check_close(f"{name} vs plain ({b.dtype})", out, ref,
                              abs_product(m, b), eps)
    del out, ref
    fold = carry_fold_size(layout, wrapper, b)
    variant = bcsr_variant_run(layout, wrapper, b)
    walk = csr_walk_run(name, layout, wrapper, b)
    window = banded_window_run(layout, wrapper, b)
    ms = median_ms(lambda: wrapper(layout, b), runs)
    plain_ms = median_ms(lambda: plain(layout, b), plain_runs)
    a = torch_csr(m, b.device, b.dtype)
    try:
        lib_ms = median_ms(lambda: torch.sparse.mm(a, b), runs)
    except (RuntimeError, NotImplementedError) as e:
        log(f"[kernel] torch.sparse.mm at {b.dtype}: {e}")
        lib_ms = None
    del a
    bsr = bsr_library_row(layout, b, runs)
    bc_bytes = 2 * b.numel() * b.element_size()
    # What the inputs need: A in the smaller of CSR at the layout's widths
    # and the packed layout (a blocked layout stores each value once and
    # one set of coordinates per block), B once, C once.
    a_bytes = layout_bytes(layout)
    csr_bytes = m.nnz * (b.element_size() + index_bytes) + 4 * (m.n + 1)
    nbytes = min(csr_bytes, a_bytes) + bc_bytes
    layout_nbytes = a_bytes + bc_bytes
    # Stored value slots (padding included) per true nonzero.
    stored = next(getattr(layout, f).numel() for f in ("vals", "blocks",
                                                       "diags")
                  if hasattr(layout, f))
    flops = 2.0 * m.nnz * b.shape[1]
    t_ops = flops / PEAK_FLOPS[str(b.dtype).split(".")[-1]] * 1e3

    def bound(n_bytes: int) -> tuple:
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")
    bound_ms, bound_by = bound(nbytes)
    empty_cache(b.device)
    return {"max_abs_err": err, "margin": margin, "ms": ms, "d": b.shape[1],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_layout_ms": bound(layout_nbytes)[0],
            "library_ms": lib_ms, "bytes": nbytes,
            "layout_bytes": layout_nbytes, "flops": flops,
            "stored_per_nnz": stored / max(m.nnz, 1),
            **work_list_size(layout), **diagonal_walk_size(layout, m),
            **fold, **variant, **walk, **window, **bsr}


def log_row(name: str, structure: str, row: dict) -> None:
    work = "" if "pieces" not in row else (
        f"; work list {row['pieces']} pieces, largest "
        f"{row['largest_piece_nnz']} real entries, "
        f"{row.get('split_tiles', 'n/a')} split tiles, "
        f"{row['real_slots']} of {row['slots']} slots real")
    if "diagonals" in row:
        work += (f"; walks {row['diagonals']} diagonals, read per nonzero "
                 f"{row['read_per_nnz']:.2f}, B window {row['window']}")
    if "variant" in row:
        work += (f"; variant {row['variant']} (two calls equal bit for "
                 f"bit), torch.sparse.mm with A as BSR "
                 f"{row['library_bsr_ms']} ms")
    if "walk" in row:
        work += f"; {row['walk']} walk, {row['lanes']} lanes an entry"
    if "carry_rows" in row:
        work += (f"; fold: {row['carry_rows']} carry rows summing "
                 f"{row['carries']} carries, carry buffer "
                 f"{row['carry_bytes'] / 1e6:.1f} MB, {row['empty_rows']} "
                 f"empty rows, a call allocates "
                 f"{row['call_alloc_bytes'] / 1e6:.1f} MB (partials would "
                 f"be {row['partials_bytes'] / 1e6:.1f} MB), two calls "
                 f"equal bit for bit")
    log(f"[kernel] {name} {row['precision']} n={row['n']} d={row['d']} "
        f"({structure}, "
        f"layout {row['format']}): max|err| {row['max_abs_err']:.3e} (worst "
        f"err - bound {row['margin']:.3e} <= 0), kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, torch.sparse.mm "
        f"{row['library_ms']} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), layout bound {row['bound_layout_ms']:.4f} "
        f"ms; stored values per nonzero {row['stored_per_nnz']:.2f}{work}")


def kernel_phase(served: dict, quick: bool, dev) -> list:
    """Each kernel vs its plain version at every declared precision."""
    import numpy as np
    import torch
    from repro_torch.core.precision import as_precision
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.sparse import stream
    from repro_torch.sparse.dispatch import Dispatcher

    runs, plain_runs = (3, 2) if quick else (10, 3)
    rng = np.random.default_rng(7)
    records = []
    for name, (source, replaces, run_key, formats) in KERNELS.items():
        # The designated serving run, else the first that chose a format
        # of this kernel.
        keys = [run_key] + [k for k in SERVE_RUNS if k != run_key]
        run_key = next(k for k in keys
                       if served["runs"][k]["plan"].chosen in formats)
        structure, _ = run_key
        run = served["runs"][run_key]
        m = served["matrices"][structure]
        disp = served["dispatchers"][structure]
        fmt_name = run["plan"].chosen
        spec = registry.get(fmt_name, "cuda")
        rows = []
        for token in spec.supported_precisions:
            if token == run["plan"].precision:
                mm, layout = m, run["plan"].layout
            else:
                small = token == "bf16i16"
                mm = serve.build_stream_matrix(structure, N_INT16) \
                    if small else m
                dd = Dispatcher(device=dev, calibration=False, tree=False) \
                    if small else disp
                layout = stream.plan(mm, stream.BSpec(d=D, reuse=STEPS),
                                     strategy=fmt_name, precision=token,
                                     dispatcher=dd).layout
            dtype = torch.bfloat16 if token.startswith("bf16") \
                else torch.float32
            b = torch.from_numpy(rng.normal(size=(mm.n, D))
                                 .astype(np.float32)).to(dev, dtype)
            row = kernel_row(name, layout, mm, b,
                             as_precision(token).sizeof_idx, runs,
                             plain_runs)
            row.update(precision=token, n=mm.n, format=fmt_name)
            log_row(name, structure, row)
            rows.append(row)
            del b
        others = []
        for ext, strategy, d in EXTRA_RUNS.get(name, ()):
            eplan = served["runs"][(ext, strategy)]["plan"]
            mm = served["matrices"][ext]
            if d != D:
                # The strategy's plan at width d; where it picks another
                # kernel's format, the served run's format packed at d.
                for pick in (strategy, eplan.chosen):
                    dplan = stream.plan(
                        mm, stream.BSpec(d=d, reuse=SOLVE_REUSE),
                        strategy=pick, precision=eplan.precision,
                        dispatcher=served["dispatchers"][ext])
                    if dplan.chosen in formats:
                        break
                    log(f"[kernel] {ext}/{pick} at d = {d} chose "
                        f"{dplan.chosen}, not a format of {name}")
                else:
                    raise SmokeFailure(f"[kernel] no {name} layout of {ext} "
                                       f"at d = {d}")
                eplan = dplan
            elif (ext, strategy) == run_key or eplan.chosen not in formats:
                continue
            b = torch.from_numpy(rng.normal(size=(mm.n, d))
                                 .astype(np.float32)).to(dev)
            row = kernel_row(name, eplan.layout, mm, b,
                             as_precision(eplan.precision).sizeof_idx,
                             runs, plain_runs)
            row.update(precision=eplan.precision, n=mm.n,
                       format=eplan.chosen, structure=ext)
            log_row(name, ext, row)
            others.append(row)
            del b
        main = rows[0]
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": served["counts"][name],
            **{k: main[k] for k in RECORD_KEYS if k in main},
            "precision": main["precision"], "n": main["n"], "d": D,
            "structure": structure, "format": main["format"],
            "other_precisions": [
                {k: r[k] for k in ("precision", "n", *RECORD_KEYS)
                 if k in r}
                for r in rows[1:]],
            "other_layouts": [
                {k: r[k] for k in ("structure", "format", "precision", "n",
                                   "d", *RECORD_KEYS) if k in r}
                for r in others]})
    # The banded kernel where n is not a multiple of its 128-row tile.
    from repro_torch.kernels.banded_spmm import banded_spmm, banded_spmm_plain
    for nn in (1001, 1002, 1004):
        mm = serve.build_stream_matrix("banded", nn)
        layout = stream.plan(mm, D, strategy="dia",
                             dispatcher=Dispatcher(
                                 device=dev, calibration=False,
                                 tree=False)).layout
        b = torch.from_numpy(rng.normal(size=(nn, D)).astype(np.float32)
                             ).to(dev)
        err, _ = check_close(f"banded_spmm n={nn}",
                             banded_spmm(layout, b),
                             banded_spmm_plain(layout, b),
                             abs_product(mm, b), 2.0 ** -23)
        log(f"[kernel] banded_spmm n={nn}: max|err| "
            f"{err:.3e} within bound")
    # The banded kernel on HPCG's stencil, planned as the benchmark's
    # hpcg.stream-d64 plans it; every launch of the row must read B with
    # no window.
    from repro_torch import kernels
    from repro_torch.kernels import banded_spmm as banded_module
    side = HPCG_SIDE_QUICK if quick else HPCG_SIDE
    mm = stencil27_matrix(side, rng)
    plan = stream.plan(mm, stream.BSpec(d=D, reuse=STREAM_REUSE),
                       strategy="auto",
                       dispatcher=Dispatcher(device=dev, calibration=False,
                                             tree=False))
    if (plan.chosen, plan.precision) != ("dia", "f32i32"):
        raise SmokeFailure(f"[kernel] HPCG {side}^3 planned "
                           f"{plan.chosen} at {plan.precision}, not dia at "
                           f"f32i32")
    b = torch.from_numpy(rng.normal(size=(mm.n, D)).astype(np.float32)
                         ).to(dev)
    kernels.reset_launch_counts()
    row = kernel_row("banded_spmm", plan.layout, mm, b, 4, runs, plain_runs)
    modes = {k: v for k, v in banded_module.LAUNCHES_BY_WINDOW.items() if v}
    if list(modes) != ["none"]:
        raise SmokeFailure(f"[kernel] banded_spmm on HPCG {side}^3: "
                           f"launches counted {modes}, not all none")
    row.update(precision=plan.precision, n=mm.n, format=plan.chosen,
               structure=f"hpcg-{side}")
    log_row("banded_spmm", f"hpcg {side}^3", row)
    log(f"[kernel] banded_spmm on HPCG {side}^3: launches by window "
        f"{modes}")
    del b
    banded = next(r for r in records if r["name"] == "banded_spmm")
    banded["other_layouts"].append(
        {k: row[k] for k in ("structure", "format", "precision", "n", "d",
                             *RECORD_KEYS) if k in row})
    return records


def event_ms(fn, launches: int = 1) -> float:
    """CUDA-event time of ``launches`` back-to-back calls of ``fn``, per
    call (ms)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def warm_cold_ms(fn, flush, repeats: int) -> tuple:
    """``(warm, cold)`` ms of ``fn`` after one untimed call: warm is
    ``PAPER_WARM`` calls between one event pair over their count; cold the
    least of ``repeats`` single calls, each after ``flush`` (a device
    buffer over twice the L2) was written, so that the L2 holds none of
    the call's operands."""
    fn()
    warm = event_ms(fn, PAPER_WARM)
    cold = []
    for i in range(repeats):
        flush.fill_(i)
        cold.append(event_ms(fn))
    return warm, min(cold)


def paper_cell_line(name: str, fmt: str, d: int, cell: dict) -> str:
    def ms(x) -> str:
        return "n/a" if x is None else f"{x:.5f}"
    roofs = " ".join(
        f"{model} {ms(p['ms'])} ms (share cold {p['share_cold']:.3f} warm "
        f"{p['share_warm']:.3f})" for model, p in cell["roofline"].items())
    extra = "" if "variant" not in cell else (
        f" mxu_utilization {cell['mxu_utilization']:.4f} variant "
        f"{cell['variant']}")
    if "walk" in cell:
        extra += f" walk {cell['walk']}"
    return (f"[paper] {name} {fmt} d={d} nnz={cell['nnz']} cold "
            f"{ms(cell['cold_ms'])} ms warm {ms(cell['warm_ms'])} ms lib "
            f"cold {ms(cell['lib_cold_ms'])} warm {ms(cell['lib_warm_ms'])}"
            f" ms max|err| {cell['max_abs_err']:.3e} | {roofs}{extra} | "
            f"regime={cell['regime']} nearest={cell['nearest']}")


def paper_phase(quick: bool, dev, scale: Optional[int] = None) -> dict:
    """The paper's matrix suite through the port's kernels, every launch
    placed on the kernel rooflines (see the module docstring), at n =
    2**scale (default ``PAPER_SCALE``, or ``PAPER_SCALE_QUICK`` under
    ``quick``).  Returns the launches per kernel."""
    import gc
    import math
    import torch
    from repro_torch import kernels
    from repro_torch.configs.paper_spmm import CONFIG
    from repro_torch.core.hardware import h100_from_device
    from repro_torch.core.patterns import paper_suite
    from repro_torch.core.precision import as_precision
    from repro_torch.kernels import bcsr_spmm as bcsr_module
    from repro_torch.kernels import csr_spmm as csr_module
    from repro_torch.kernels import registry
    from repro_torch.sparse.dispatch import Dispatcher

    if CONFIG.dtype != "float32":
        raise SmokeFailure(f"[paper] no precision for {CONFIG.dtype}")
    if scale is None:
        scale = PAPER_SCALE_QUICK if quick else PAPER_SCALE
    plan_d = max(CONFIG.d_values)
    hw = h100_from_device(dev)
    ctx = registry.KernelContext(hardware=hw, bcsr_block=CONFIG.bcsr_block,
                                 plan_d=plan_d,
                                 precision=as_precision("f32i32"),
                                 device=dev)
    disp = Dispatcher(hw, device=dev, calibration=False, tree=False,
                      bcsr_block=CONFIG.bcsr_block)
    plain = registry.get("csr", "torch")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    eps = float(torch.finfo(torch.float32).eps)
    launched = dict.fromkeys(PAPER_KERNELS.values(), 0)
    cells = []
    t_host = 0.0
    log(f"[paper] suite at n = 2**{scale}, d {CONFIG.d_values}, "
        f"{CONFIG.dtype}, BCSR t = {CONFIG.bcsr_block}, cold = min of "
        f"{CONFIG.repeats} after a {FLUSH_BYTES >> 20} MB write, warm = "
        f"{PAPER_WARM} back to back; rooflines on {hw.name} "
        f"({hw.hbm_bandwidth / 1e12:.2f} TB/s, "
        f"{hw.peak_flops / 1e12:.0f} TFLOP/s, L2 {hw.vmem_bytes >> 20} MB)")
    for name, make in paper_suite(scale).items():
        t0 = time.perf_counter()
        m = make()
        # The plan's regime is ``core.classify.classify(m).regime``; its
        # skips name the formats the dispatcher's policy rejects.
        plan = disp.plan(m, plan_d, precision="f32i32")
        fmts = [f for f in PAPER_KERNELS if f not in plan.skips]
        layouts = {f: registry.get(f, "cuda").prepare(m, ctx) for f in fmts}
        a_csr = plain.prepare(m, ctx)
        a_lib = torch_csr(m, dev)
        torch.cuda.synchronize(dev)
        t_host += time.perf_counter() - t0
        log(f"[paper] {name}: n {m.n}, nnz {m.nnz}, regime {plan.regime}, "
            f"layouts {fmts}, host {time.perf_counter() - t0:.1f}s")
        for d in CONFIG.d_values:
            b = torch.randn(m.n, d, generator=gen, device=dev)
            ref = plain.run(a_csr, b, ctx)
            absprod = abs_product(m, b)

            def library():
                return torch.sparse.mm(a_lib, b)
            try:
                lib_warm, lib_cold = warm_cold_ms(library, flush,
                                                  CONFIG.repeats)
            except (RuntimeError, NotImplementedError) as e:
                log(f"[paper] torch.sparse.mm: {type(e).__name__}: {e}")
                lib_warm = lib_cold = None
            for fmt in fmts:
                kname = PAPER_KERNELS[fmt]
                spec, layout = registry.get(fmt, "cuda"), layouts[fmt]

                def launch():
                    return spec.run(layout, b, ctx)
                before = kernels.launch_counts()
                variants = dict(bcsr_module.LAUNCHES_BY_VARIANT)
                walks = dict(csr_module.LAUNCHES_BY_VARIANT)
                err, _ = check_close(f"[paper] {name} {fmt} d={d}",
                                     launch(), ref, absprod, eps)
                warm, cold = warm_cold_ms(launch, flush, CONFIG.repeats)
                calls = 2 + PAPER_WARM + CONFIG.repeats
                moved = {k: v - before[k]
                         for k, v in kernels.launch_counts().items()
                         if v != before[k]}
                if moved != {kname: calls}:
                    raise SmokeFailure(f"[paper] {name} {fmt} d={d}: "
                                       f"{calls} calls launched {moved}")
                launched[kname] += calls
                cell = {"matrix": name, "format": fmt, "kernel": kname,
                        "d": d, "n": m.n, "nnz": m.nnz,
                        "regime": plan.regime, "max_abs_err": err,
                        "cold_ms": cold, "warm_ms": warm,
                        "lib_cold_ms": lib_cold, "lib_warm_ms": lib_warm}
                if fmt == "csr":
                    walk = csr_module.csr_variant(d)[0]
                    ran = {k: v - walks[k]
                           for k, v in csr_module.LAUNCHES_BY_VARIANT.items()
                           if v != walks[k]}
                    if ran != {walk: calls}:
                        raise SmokeFailure(f"[paper] {name} csr d={d}: "
                                           f"launched {ran}, not {walk}")
                    cell["walk"] = walk
                    roofs = {r: registry.csr_kernel_roofline(
                        a_csr, d, regime=r, hw=hw) for r in PAPER_REGIMES}
                elif fmt == "bcsr":
                    want = bcsr_module.bcsr_variant(layout.t, d, b.dtype)
                    ran = {k: v - variants[k]
                           for k, v in bcsr_module.LAUNCHES_BY_VARIANT.items()
                           if v != variants[k]}
                    if ran != {want: calls}:
                        raise SmokeFailure(f"[paper] {name} bcsr d={d}: "
                                           f"launched {ran}, not {want}")
                    roofs = {"blocked_tpu": registry.bcsr_kernel_roofline(
                        layout, d, hw=hw)}
                    cell.update(variant=want, mxu_utilization=roofs[
                        "blocked_tpu"].mxu_utilization)
                else:
                    roofs = {"diagonal": registry.dia_kernel_roofline(
                        m, d, hw)}
                cell["roofline"] = {}
                for model, roof in roofs.items():
                    ms = roof.useful_flops / roof.attainable_flops_per_s * 1e3
                    cell["roofline"][model] = {
                        "ms": ms, "ai": roof.ai, "share_cold": ms / cold,
                        "share_warm": ms / warm}
                cell["nearest"] = min(
                    cell["roofline"], key=lambda k: abs(math.log(
                        cell["roofline"][k]["ms"] / cold)))
                log(paper_cell_line(name, fmt, d, cell))
                for model, p in cell["roofline"].items():
                    if max(p["share_cold"], p["share_warm"]) > 1.0:
                        log(f"[paper] above roofline: {name} {fmt} d={d} "
                            f"{model}: roofline {p['ms']:.5f} ms, cold "
                            f"{cold:.5f} ms (share {p['share_cold']:.3f}), "
                            f"warm {warm:.5f} ms (share "
                            f"{p['share_warm']:.3f})")
                cells.append(cell)
            del b, ref, absprod
        del m, plan, layouts, a_csr, a_lib
        gc.collect()
        empty_cache(dev)
    del flush
    empty_cache(dev)
    nearest = {}
    for c in cells:
        if c["format"] == "csr":
            tally = nearest.setdefault(c["regime"], {})
            tally[c["nearest"]] = tally.get(c["nearest"], 0) + 1
    above = {"cold": {}, "warm": {}}
    for c in cells:
        for model, p in c["roofline"].items():
            for side in above:
                if p[f"share_{side}"] > 1.0:
                    key = f"{c['format']}/{model}"
                    above[side][key] = above[side].get(key, 0) + 1
    log(f"[paper] {len(cells)} kernel cells within the plain version's "
        f"bound; launches {launched}; host (generate, classify, plan, "
        f"pack) {t_host:.1f}s")
    log(f"[paper] nearest model of the CSR launches, by classified regime: "
        f"{nearest}")
    log(f"[paper] cells above roofline (share > 1.0), by format/model: cold "
        f"{above['cold']}, warm {above['warm']}")
    out = ROOT / "chiprun_out" / "paper_suite.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"scale": scale, "hardware": hw.name,
                               "cells": cells, "nearest": nearest,
                               "above": above}, indent=1))
    return launched


def grouped_excess(got, ref, absprod, rows) -> tuple:
    """``got`` against ``ref``, two grouped-matmul outputs, on the routed
    ``rows`` within ``moe_block.grouped_tolerance``.  Returns ``(max |err|,
    worst err - bound, worst err / bound, padding rows zero on both
    sides)``; a non-finite ``got`` counts as an infinite excess."""
    import torch
    from repro_torch.launch.moe_block import grouped_tolerance
    g, r = got[rows].to(torch.float32), ref[rows].to(torch.float32)
    err = (g - r).abs()
    if not bool(torch.isfinite(g).all()):
        err = torch.full_like(err, float("inf"))
    bound = grouped_tolerance(absprod[rows], got.dtype, g, r)
    padding = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    padding[rows] = False
    zero = not (bool(got[padding].any()) or bool(ref[padding].any()))
    return (float(err.max()), float((err - bound).max()),
            float((err / bound).max()), zero)


def grouped_row(w, routed, runs: int, plain_runs: int) -> dict:
    """The grouped matmul against its plain version on one MoE operand,
    with times; the library time is one ``torch._grouped_mm`` call (bf16,
    where this torch has it) or else a per-expert ``torch.matmul`` loop.

    The check must also reject two planted faults: the kernel run with the
    first 32-wide k-slice of x dropped, and +0.1 on one routed row."""
    import torch
    from repro_torch.core.device import median_ms
    from repro_torch.kernels.grouped_matmul import (
        TILE_N, grouped_matmul, grouped_matmul_plain, tile_rows)
    x, gids = routed.x, routed.group_ids
    bm = x.shape[0] // gids.shape[0]
    T, K = x.shape
    E, _, N = w.shape
    rows = routed.rows.reshape(-1)
    what = f"grouped_matmul vs plain ({x.dtype})"
    out = grouped_matmul(x, w, gids, bm=bm)
    ref = grouped_matmul_plain(x, w, gids, bm=bm)
    if tuple(out.shape) != tuple(ref.shape):
        raise SmokeFailure(f"{what}: shape {tuple(out.shape)} vs "
                           f"{tuple(ref.shape)}")
    absprod = grouped_matmul_plain(x.abs().float(), w.abs().float(), gids,
                                   bm=bm)
    err, margin, ratio, zero = grouped_excess(out, ref, absprod, rows)
    if margin > 0:
        raise SmokeFailure(f"{what}: max |err| {err:.3e} exceeds the bound "
                           f"by {margin:.3e}")
    if not zero:
        raise SmokeFailure(f"{what}: a padding row is not zero")
    x_cut = x.clone()
    x_cut[:, :32] = 0
    faults = {"first 32-wide k-slice dropped":
              grouped_matmul(x_cut, w, gids, bm=bm)}
    del x_cut
    faults["+0.1 on one routed row"] = out.clone()
    faults["+0.1 on one routed row"][rows[0]] += 0.1
    for fault, bad in faults.items():
        bad_err, bad_margin, bad_ratio, _ = grouped_excess(bad, ref, absprod,
                                                           rows)
        if bad_margin <= 0:
            raise SmokeFailure(f"{what}: the check let a planted fault "
                               f"through ({fault}: max |err| {bad_err:.3e})")
        log(f"[kernel] grouped_matmul {x.dtype}: planted fault ({fault}) "
            f"rejected, max |err| {bad_err:.3e}, worst err / bound "
            f"{bad_ratio:.1f}")
    del out, ref, absprod, faults
    ms = median_ms(lambda: grouped_matmul(x, w, gids, bm=bm), runs)
    plain_ms = median_ms(lambda: grouped_matmul_plain(x, w, gids, bm=bm),
                         plain_runs)
    # Rows per expert in the sorted buffer: the groups' end offsets.
    ends = torch.cumsum(torch.bincount(gids.long(), minlength=E) * bm,
                        0).to(torch.int32)
    if x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        library = "torch._grouped_mm"
        lib_ms = median_ms(lambda: torch._grouped_mm(x, w, offs=ends), runs)
    else:
        library = "per-expert torch.matmul loop"
        bounds = [0] + ends.tolist()

        def loop():
            for e in range(E):
                lo, hi = bounds[e], bounds[e + 1]
                torch.matmul(x[lo:hi], w[e])
        lib_ms = median_ms(loop, runs)
    peak = PEAK_FLOPS[str(x.dtype).split(".")[-1]]

    def bound(n_rows: int) -> tuple:
        """(ms, by) for n_rows rows of x read, w read once, out written."""
        nbytes = (n_rows * (K + N) + w.numel()) * x.element_size() + \
            gids.numel() * gids.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * n_rows * K * N / peak * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")
    bound_ms, bound_by = bound(T)
    routed_ms, routed_by = bound(rows.numel())
    flops = 2.0 * T * K * N
    # What the kernel's tiling copies into shared memory (from L2 or HBM):
    # every (row tile, column tile) reads its x rows and its w columns.
    tm = tile_rows(bm)
    tile_bytes = (T // tm) * (N // TILE_N) * K * (tm + TILE_N) * \
        x.element_size()
    empty_cache(x.device)
    return {"max_abs_err": err, "margin": margin, "err_over_bound": ratio,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_routed_ms": routed_ms,
            "bound_routed_by": routed_by, "library_ms": lib_ms,
            "library": library, "flops": flops, "rows": T,
            "routed_rows": rows.numel(), "tflops": flops / ms / 1e9,
            "tflops_routed": 2.0 * rows.numel() * K * N / ms / 1e9,
            "tile_traffic_gb": tile_bytes / 1e9,
            "tile_traffic_tb_s": tile_bytes / ms / 1e9}


def grouped_record(moe: dict, quick: bool) -> dict:
    """The grouped matmul's record: the config dtype (bf16) first."""
    runs, plain_runs = (3, 2) if quick else (10, 3)
    rows = []
    for dtype in MOE_DTYPES:
        run = moe["runs"][dtype]
        row = grouped_row(run["w"], run["routed"], runs, plain_runs)
        row.update(precision=dtype)
        log(f"[kernel] grouped_matmul {dtype} T={row['rows']} "
            f"({row['routed_rows']} routed): max|err| "
            f"{row['max_abs_err']:.3e} on the routed rows (worst err - "
            f"bound {row['margin']:.3e} <= 0, worst err / bound "
            f"{row['err_over_bound']:.3f}), kernel {row['ms']:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s over the padded rows, "
            f"{row['tflops_routed']:.1f} over the routed rows), plain "
            f"{row['plain_ms']:.4f} ms, {row['library']} "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) over the padded rows, "
            f"{row['bound_routed_ms']:.4f} ms ({row['bound_routed_by']}) "
            f"over the routed rows; its tiles copy "
            f"{row['tile_traffic_gb']:.2f} GB into shared memory, "
            f"{row['tile_traffic_tb_s']:.2f} TB/s")
        rows.append(row)
    main = rows[0]
    return {
        "name": "grouped_matmul", "route": "cuda", "source": GROUPED[0],
        "replaces": GROUPED[1],
        "launches": moe["counts"]["grouped_matmul"],
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "library",
                                "bound_routed_ms", "precision", "rows",
                                "routed_rows", "tflops", "tflops_routed",
                                "tile_traffic_gb", "tile_traffic_tb_s")},
        "widths": moe["widths"],
        "other_precisions": [
            {k: r[k] for k in ("precision", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "bound_routed_ms",
                               "library_ms", "library", "rows",
                               "routed_rows", "tflops", "tflops_routed",
                               "tile_traffic_gb", "tile_traffic_tb_s")}
            for r in rows[1:]]}


class RoutingLog:
    """Records each call of ``repro_torch.models.moe.router`` while active
    (one call per MoE layer per step): its weights, its top-k ids and the
    router logits.  With ``replay`` (another log's calls), each call
    returns the replayed call's weights and ids in place of its own."""

    def __init__(self, replay: Optional[list] = None):
        self.replay, self.calls = replay, []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe.router

        def router(x, kernel, k):
            weights, ids = self._orig(x, kernel, k)
            self.calls.append((weights, ids,
                               (x.float() @ kernel.float()).cpu()))
            if self.replay is not None:
                weights, ids, _ = self.replay[len(self.calls) - 1]
            return weights, ids
        moe.router = router
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.router = self._orig


def lm_check(model, prompts, dev) -> dict:
    """Hold the grouped kernel against its plain version on the model's own
    operands over ``LM_CHECK_STEPS`` teacher-forced steps.

    The steps run once with ``grouped_matmul_plain`` in the model, then
    with the kernel, whose every launch also runs the plain version on the
    same operands and must agree within ``moe_block.grouped_tolerance``
    (padding rows exactly 0).  The kernel run replays the plain run's
    routing, so that the runs differ only by the products' roundings; its
    logits must then agree within ``models.model.logit_tolerance``.  The
    decisions its own router would have taken differently are counted,
    with their router-logit margins."""
    import torch
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_plain)
    from repro_torch.launch.moe_block import grouped_tolerance
    from repro_torch.models.model import logit_tolerance

    worst = {"ratio": 0.0, "err": 0.0, "launches": 0}

    def checked(x, w, gids, *, bm, bk, bn, expert_rows=None):
        out = grouped_matmul(x, w, gids, bm=bm, bk=bk, bn=bn,
                             expert_rows=expert_rows)
        ref = grouped_matmul_plain(x, w, gids, bm=bm)
        absprod = grouped_matmul_plain(x.abs().float(), w.abs().float(),
                                       gids, bm=bm)
        g, r = out.float(), ref.float()
        err = (g - r).abs()
        if not bool(torch.isfinite(g).all()):
            raise SmokeFailure("lm: grouped_matmul gave non-finite values")
        ratio = float((err / grouped_tolerance(absprod, out.dtype, g,
                                               r)).max())
        padding = ~x.bool().any(dim=1)
        if bool(out[padding].any()):
            raise SmokeFailure("lm: a padding row of the capacity buffer "
                               "came out nonzero")
        if ratio > 1:
            raise SmokeFailure(f"lm: grouped_matmul vs plain on the model's "
                               f"operands {tuple(x.shape)} x "
                               f"{tuple(w.shape)}: err / bound {ratio:.3f}")
        worst.update(ratio=max(worst["ratio"], ratio),
                     err=max(worst["err"], float(err.max())),
                     launches=worst["launches"] + 1)
        return out

    toks = torch.from_numpy(prompts.astype("int64")).to(dev)

    def run(gmm, replay=None):
        cache = model.init_cache(toks.shape[0], LM_CHECK_STEPS)
        with RoutingLog(replay) as routes, torch.inference_mode():
            logits = torch.stack([model.decode_step(cache, toks[:, t], t, gmm)
                                  for t in range(LM_CHECK_STEPS)])
        return logits, routes.calls

    ref, ref_routes = run(grouped_matmul_plain)
    got, got_routes = run(checked, replay=ref_routes)
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure("lm: non-finite logits")
    k = model.cfg.num_experts_per_token
    margins = []
    for (_, own, _), (_, ids, z) in zip(got_routes, ref_routes):
        same = (own.sort(dim=1).values == ids.sort(dim=1).values).all(1)
        for b in torch.nonzero(~same).flatten().tolist():
            zs = z[b].sort(descending=True).values
            margins.append(float((zs[k - 1] - zs[k]) /
                                 z[b].pow(2).mean().sqrt()))
    rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
    bound = logit_tolerance(model.cfg, rms, ref.numel())
    err = (got - ref).abs()
    ratio = float((err / bound).max())
    if ratio > 1:
        raise SmokeFailure(f"lm: logits of the kernel run vs the plain run: "
                           f"err / bound {ratio:.3f}")
    experts = [len(torch.unique(ids)) for _, ids, _ in ref_routes]
    return {"launch_ratio": worst["ratio"], "launch_err": worst["err"],
            "checked_launches": worst["launches"],
            "max_dlogit": float(err.max()), "logit_ratio": ratio,
            "bound_min": float(bound.min()), "bound_max": float(bound.max()),
            "decisions": len(ref_routes) * toks.shape[0],
            "own_flips": len(margins),
            "flip_margin_max": max(margins, default=None),
            "experts_routed_mean": sum(experts) / len(experts)}


def lm_profile(model, prompts, dev, steps: int = 2) -> dict:
    """Where one decode step's time goes: ``torch.profiler`` over ``steps``
    teacher-forced steps (after 2 warm ones) on a fresh cache; per step the
    host wall time, the kernels' summed device time and count, and the
    largest kernels.  Device time is "not measured" where the trace holds
    no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(prompts.astype("int64")).to(dev)
    cache = model.init_cache(toks.shape[0], steps + 2)
    with torch.inference_mode():
        for t in range(2):
            model.decode_step(cache, toks[:, t], t)
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(2, steps + 2):
                model.decode_step(cache, toks[:, t], t)
            torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if kernels else None,
            "kernels": sum(e.count for e in kernels) / steps,
            "top": [(e.key[:60], e.self_device_time_total / 1e3 / steps,
                     e.count / steps) for e in top]}


def lm_step_bytes(model, batch: int, cache_len: int,
                  experts_read: Optional[float] = None) -> int:
    """Bytes one ``decode_step`` must move: every weight it uses, read once
    (the embedding table's ``batch`` rows where it is not tied; not
    whisper's encoder nor qwen2-vl's ``mm_proj``, which decode does not
    run); the KV cache of the attention layers, read once: ``cache_len``
    slots per global layer, ``min(cache_len, window)`` per local layer's
    ring, and whisper's cross K/V of ``encoder_seq`` slots per layer; and
    the state of each ``ssm`` or ``rglru`` layer, which has no KV cache,
    read once and written once: its ``K - 1`` conv inputs in the compute
    dtype and its fp32 ``h`` (``[B, d_in, N]`` for mamba, ``[B,
    rnn_width]`` for RG-LRU).  With ``experts_read``, only that many
    experts' weights per MoE layer instead of all of them."""
    from repro_torch.models.model import ATTENTION_KINDS, layer_kinds
    cfg = model.cfg
    total = 0
    for name, p in model.named_parameters():
        if name.startswith(("encoder.", "mm_proj.")):
            continue
        nbytes = p.numel() * p.element_size()
        if name == "embed.table" and not cfg.tie_embeddings:
            nbytes = batch * cfg.d_model * p.element_size()
        elif experts_read is not None and name.endswith(
                ("moe.w_gate_up", "moe.w_down")):
            nbytes = nbytes * experts_read / cfg.num_experts
        total += nbytes
    kinds = layer_kinds(cfg)
    slots = sum(min(cache_len, cfg.window_size) if kind == "local"
                else cache_len for kind in kinds if kind in ATTENTION_KINDS)
    if cfg.family == "encdec":
        slots += cfg.encoder_seq * cfg.num_layers
    kv = 2 * batch * slots * cfg.num_kv_heads * cfg.head_dim * 2
    elt = model.dtype.itemsize
    d_in = cfg.ssm_expand * cfg.d_model
    rw = cfg.rnn_width or cfg.d_model
    conv = cfg.ssm_conv - 1
    state = {"ssm": conv * d_in * elt + d_in * cfg.ssm_state * 4,
             "rglru": conv * rw * elt + rw * 4}
    recurrent = 2 * batch * sum(state[k] for k in kinds if k in state)
    return int(total + kv + recurrent)


def lm_phase(quick: bool, dev) -> dict:
    """``serve --arch olmoe-1b-7b`` at full width and depth on the card,
    through the port's LM path: build from seed 0, prefill 32 tokens by
    stepping, decode 16 greedily, with the expert FFN on the grouped
    kernel; the launches must equal the plan.  Then the kernel against its
    plain version on the model (``lm_check``); the model is freed."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params

    argv = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN), "--device", str(dev)]
    model = None
    if quick:
        cfg = dataclasses.replace(get_config(LM_ARCH),
                                  num_layers=LM_QUICK_LAYERS)
        model = init_params(cfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    log(f"[lm] === serve {' '.join(argv)}"
        f"{f' ({LM_QUICK_LAYERS} layers)' if quick else ''} ===")
    rec = serve.serve_lm(serve.parser().parse_args(argv), model=model)
    counts = kernels.launch_counts()
    model, out = rec["model"], rec["generation"]
    cfg = model.cfg
    steps = LM_PROMPT - 1 + LM_GEN
    planned = model.grouped_launches_per_step() * steps
    if counts["grouped_matmul"] != planned or \
            any(v for k, v in counts.items() if k != "grouped_matmul"):
        raise SmokeFailure(f"lm: launches {counts}, planned {planned} "
                           f"grouped_matmul and nothing else")
    tokens = out.tokens
    if tokens.shape != (LM_BATCH, LM_GEN) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size:
        raise SmokeFailure(f"lm: tokens {tokens.shape} in "
                           f"[{tokens.min()}, {tokens.max()}]")
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated(dev) - base
    ms = np.asarray(out.step_ms)
    cache_len = LM_PROMPT + LM_GEN
    step_bytes = lm_step_bytes(model, LM_BATCH, cache_len)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_token}, expert "
        f"d_ff {cfg.moe_d_ff}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}); {n_params} parameters, {n_bytes / 1e9:.2f} GB "
        f"on the card; max_memory_allocated {peak / 1e9:.2f} GB above the "
        f"{base / 1e9:.2f} GB the earlier phases hold; built in "
        f"{rec['build_s']:.1f}s")
    log(f"[lm] {LM_BATCH} x {LM_PROMPT} prompt + {LM_GEN} generated: "
        f"{steps} decode steps, {rec['tok_s']:.2f} tok/s; per step median "
        f"{np.median(ms):.3f} ms, max {ms.max():.3f} ms, min {ms.min():.3f} "
        f"ms; byte bound {bound_ms:.3f} ms ({step_bytes / 1e9:.2f} GB per "
        f"step at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, all experts' weights); "
        f"grouped_matmul launches {counts['grouped_matmul']} = planned "
        f"{planned}")
    log(f"[lm] first row: {tokens[0].tolist()}")
    prof = lm_profile(model, rec["prompts"], dev)
    if prof["device_ms"] is None:
        log(f"[lm] profiled step: {prof['wall_ms']:.3f} ms on the host "
            f"clock; device time not measured (no device events traced)")
    else:
        log(f"[lm] profiled step (torch.profiler, 2 steps): "
            f"{prof['wall_ms']:.3f} ms on the host clock, kernels "
            f"{prof['device_ms']:.3f} ms of device time "
            f"({prof['kernels']:.0f} kernels), device idle "
            f"{1 - prof['device_ms'] / prof['wall_ms']:.1%} of the profiled "
            f"step, {1 - prof['device_ms'] / np.median(ms):.1%} of the "
            f"unprofiled median; largest: "
            + "; ".join(f"{k} {ms:.3f} ms x{n:.0f}"
                        for k, ms, n in prof["top"]))
    t0 = time.perf_counter()
    check = lm_check(model, rec["prompts"], dev)
    routed_bytes = lm_step_bytes(model, LM_BATCH, cache_len,
                                 check["experts_routed_mean"])
    log(f"[lm] kernel vs plain on the model's operands, {LM_CHECK_STEPS} "
        f"teacher-forced steps: {check['checked_launches']} launches, worst "
        f"err / grouped_tolerance {check['launch_ratio']:.3f} (max |err| "
        f"{check['launch_err']:.3e}), padding rows 0; with the plain run's "
        f"routing replayed, logits of the kernel run vs the plain run: max "
        f"|dlogit| {check['max_dlogit']:.4e}, bound "
        f"{check['bound_min']:.4f}-{check['bound_max']:.4f} "
        f"(logit_tolerance), worst err / bound {check['logit_ratio']:.3f}; "
        f"the kernel run's own router would have taken "
        f"{check['own_flips']} of {check['decisions']} (token, layer, step) "
        f"decisions differently (largest router-logit margin among them "
        f"{check['flip_margin_max']} x the row rms); "
        f"{check['experts_routed_mean']:.1f} experts routed per layer and "
        f"step, whose weights alone would be {routed_bytes / 1e9:.2f} GB "
        f"per step, {routed_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; check "
        f"took {time.perf_counter() - t0:.1f}s")
    result = {"launches": counts["grouped_matmul"], "planned": planned,
              "tok_s": rec["tok_s"], "step_median_ms": float(np.median(ms)),
              "step_max_ms": float(ms.max()), "bound_ms": bound_ms,
              "routed_bound_ms": routed_bytes / HBM_BYTES_PER_S * 1e3,
              "params": n_params, "bytes": n_bytes, "peak_bytes": peak,
              "max_dlogit": check["max_dlogit"],
              "launch_ratio": check["launch_ratio"],
              "logit_ratio": check["logit_ratio"],
              "profiled_wall_ms": prof["wall_ms"],
              "profiled_device_ms": prof["device_ms"],
              "profiled_kernels": prof["kernels"]}
    del model, rec, out
    gc.collect()
    empty_cache(dev)
    return result


@contextlib.contextmanager
def patched(mod, name: str, value):
    """Set ``mod.name`` to ``value`` while the block runs: a planted
    fault."""
    saved = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def decode_check_run(model, tokens, fwd_kw: dict, enc_out=None):
    """``models.decode_check`` on the card: one ``forward`` of ``tokens``
    (``fwd_kw``: ``frames``, ``positions_3d``) against ``tokens.shape[1]``
    teacher-forced ``decode_step`` calls (primed with ``enc_out``, fed the
    forward's ``positions_3d``), the logits and every attention output
    within their rounding bounds.  Raises ``SmokeFailure`` when they are
    not; returns the record and both traces, for :func:`reject`."""
    import torch
    from repro_torch.models import decode_check as DC

    steps = tokens.shape[1]
    t0 = time.perf_counter()
    fwd = DC.forward_trace(model, tokens, **fwd_kw)
    dec = DC.decode_trace(model, tokens, steps, enc_out=enc_out,
                          positions_3d=fwd_kw.get("positions_3d"))
    torch.cuda.synchronize()
    honest = DC.compare(model, fwd, dec)
    rec = {"honest": honest, "steps": steps,
           "seconds": time.perf_counter() - t0, "faults": {}}
    if not honest["ok"]:
        raise SmokeFailure(f"{model.cfg.name}: decode vs forward over "
                           f"{steps} steps: {honest}")
    return rec, fwd, dec


def reject(rec: dict, fault: str, model, fwd: dict, dec: dict) -> None:
    """``decode_check.compare`` of two traces, one of them run with the
    planted ``fault``: raises ``SmokeFailure`` when the check passes it;
    records the ratios in ``rec["faults"]``."""
    from repro_torch.models import decode_check as DC

    got = DC.compare(model, fwd, dec)
    rec["faults"][fault] = got
    if got["ok"]:
        raise SmokeFailure(f"{model.cfg.name}: the check passed the "
                           f"planted fault {fault!r}: {got}")


def _outputs(r: dict) -> str:
    """The worst attention and recurrent-mixer ratios of a comparison,
    where the model has such layers."""
    parts = [f"attention outputs {r['attn']:.3f} (layer {r['layer']})"
             if r["layer"] else "",
             f"mixer outputs {r['mixer']:.3f} (layer {r['mixer_layer']})"
             if r["mixer_layer"] else ""]
    return ", ".join(p for p in parts if p) or "outputs not compared " \
        "(non-finite logits)"


def log_check(tag: str, rec: dict, phase: str = "families") -> None:
    h = rec["honest"]
    log(f"[{phase}] {tag}: decode vs forward over {rec['steps']} "
        f"teacher-forced steps ({rec['seconds']:.1f}s): worst err / bound "
        f"logits {h['logits']:.3f} (max |dlogit| {h['max_dlogit']:.4e}), "
        f"{_outputs(h)}")
    for name, f in rec["faults"].items():
        log(f"[{phase}] {tag}: planted fault {name!r} rejected: err / "
            f"bound logits {f['logits']:.3f}, {_outputs(f)}")


def families_serve(arch: str, layers: Optional[int], dev,
                   phase: str = "families") -> dict:
    """``serve --arch ARCH`` (the reference's meaning: qwen2-vl decodes
    with 1-D RoPE, whisper against zero cross K/V) at full width, its depth
    cut to ``layers`` where given; prints parameters, memory, tok/s and the
    step median and max beside the byte bound.  Returns the record with
    the model."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params

    argv = ["--arch", arch, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN), "--device", str(dev)]
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = None
    if layers:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        model = init_params(cfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    log(f"[{phase}] === serve {' '.join(argv)}"
        f"{f' ({layers} layers)' if layers else ''} ===")
    rec = serve.serve_lm(serve.parser().parse_args(argv), model=model)
    model, out = rec["model"], rec["generation"]
    cfg = model.cfg
    tokens = out.tokens
    if tokens.shape != (LM_BATCH, LM_GEN) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size:
        raise SmokeFailure(f"{phase}: {arch} tokens {tokens.shape} in "
                           f"[{tokens.min()}, {tokens.max()}]")
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated(dev) - base
    ms = np.asarray(out.step_ms)
    step_bytes = lm_step_bytes(model, LM_BATCH, LM_PROMPT + LM_GEN)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[{phase}] {cfg.name}: {cfg.num_layers} layers "
        f"({'/'.join(cfg.layer_pattern)}), d {cfg.d_model}, "
        f"{cfg.num_heads} x {cfg.head_dim} heads, kv {cfg.num_kv_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}); {n_params} parameters, {n_bytes / 1e9:.2f} "
        f"GB on the card; max_memory_allocated {peak / 1e9:.2f} GB above "
        f"the {base / 1e9:.2f} GB held before; built in "
        f"{rec['build_s']:.1f}s")
    log(f"[{phase}] {cfg.name}: {LM_BATCH} x {LM_PROMPT} prompt + {LM_GEN} "
        f"generated: {len(ms)} decode steps, {rec['tok_s']:.2f} tok/s; per "
        f"step median {np.median(ms):.3f} ms, max {ms.max():.3f} ms, min "
        f"{ms.min():.3f} ms; byte bound {bound_ms:.4f} ms "
        f"({step_bytes / 1e9:.4f} GB per step at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); first row "
        f"{tokens[0].tolist()}")
    return {"model": model, "prompts": rec["prompts"], "params": n_params,
            "bytes": n_bytes, "peak_bytes": peak, "tok_s": rec["tok_s"],
            "step_median_ms": float(np.median(ms)),
            "step_max_ms": float(ms.max()), "bound_ms": bound_ms,
            "step_bytes": step_bytes}


def log_profile(phase: str, name: str, prof: dict) -> None:
    """One line for :func:`lm_profile`'s record."""
    if prof["device_ms"] is None:
        log(f"[{phase}] {name} profiled step: {prof['wall_ms']:.3f} ms on "
            f"the host clock; device time not measured")
        return
    log(f"[{phase}] {name} profiled step (torch.profiler, 2 steps): "
        f"{prof['wall_ms']:.3f} ms on the host clock, kernels "
        f"{prof['device_ms']:.3f} ms of device time ({prof['kernels']:.0f} "
        f"kernels), device idle {1 - prof['device_ms'] / prof['wall_ms']:.1%}"
        f" of the profiled step; largest: " + "; ".join(
            f"{k} {t:.3f} ms x{n:.0f}" for k, t, n in prof["top"]))


def pipeline_batch(cfg, seq: int, batch: int, dev) -> dict:
    """The data pipeline's batch for ``cfg`` (seed 0) on ``dev``: tokens,
    labels and the family's modality stubs."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, Pipeline
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
            Pipeline(cfg, ShapeConfig("check", seq, batch, "train"),
                     DataConfig(seed=0)).batch_for_step(0).items()}


def free(dev) -> None:
    """Return the memory of the models the caller has dropped."""
    import gc
    gc.collect()
    empty_cache(dev)


def families_phase(quick: bool, dev) -> dict:
    """The ``local``, ``vlm`` and ``encdec`` families on the card, through the
    port's LM path, with no port kernel launched (the counters are zeroed
    first and must read 0 after). gemma3-12b at full width and
    ``FAMILIES_LAYERS`` depth (one period under ``--quick``): ``serve
    --arch`` and a profile of two steps; the ring check at full width on a
    local and a global layer (``RING_PATTERN``); whisper-base: serve, then
    the encoder and primed cross cache against ``forward``; qwen2-vl-7b (2
    layers under ``--quick``): serve, decode against ``forward`` with the
    pipeline's distinct ``positions_3d`` streams, and one forward of the
    pipeline's patch stubs. Each check must reject its planted faults.
    Each model is freed before the next."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models import decode_check as DC
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    kernels.reset_launch_counts()
    result = {}

    # gemma3-12b: serve, and profile two steps.
    g = families_serve("gemma3-12b", (FAMILIES_QUICK_LAYERS if quick
                                      else FAMILIES_LAYERS)["gemma3-12b"],
                       dev)
    prof = lm_profile(g["model"], g["prompts"], dev)
    log_profile("families", "gemma3-12b", prof)
    g["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms", "kernels")}
    del g["model"]
    result["gemma3-12b"] = g
    free(dev)

    # The ring at full width: a local and the global layer, RING_TOKENS
    # tokens.
    cfg = dataclasses.replace(get_config("gemma3-12b"),
                              layer_pattern=RING_PATTERN,
                              num_layers=len(RING_PATTERN))
    model = M.init_params(cfg, device=dev,
                          generator=torch.Generator(dev).manual_seed(0))
    toks = pipeline_batch(cfg, RING_TOKENS, 1, dev)["tokens"]

    def slot_one_off(kind, pos, s_c, _orig=M.cache_slot):
        return (pos + 1) % s_c if kind == "local" else _orig(kind, pos, s_c)

    def full_from_the_start(kind, pos, s_c, device, _orig=M.cache_mask):
        if kind == "local":
            return torch.ones(s_c, dtype=torch.bool, device=device)
        return _orig(kind, pos, s_c, device)

    def no_window(q, k, v, window, q_block=512):
        return A.chunked_attention(q, k, v, causal=True)

    ring, fwd, dec = decode_check_run(model, toks, {})
    n = RING_FAULT_STEPS
    with patched(M, "cache_slot", slot_one_off):
        reject(ring, "ring writes slot (pos + 1) % S_c", model, fwd,
               DC.decode_trace(model, toks[:, :n], n, cache_len=RING_TOKENS))
    with patched(M, "cache_mask", full_from_the_start):
        reject(ring, "local layer attends to every slot before the ring is "
               "full", model, fwd,
               DC.decode_trace(model, toks[:, :n], n, cache_len=RING_TOKENS))
    with patched(A, "local_attention", no_window):
        reject(ring, "forward's local layers ignore the window", model,
               DC.forward_trace(model, toks), dec)
    log_check(f"ring check, gemma3-12b at full width, {cfg.num_layers} "
              f"layers ({'/'.join(cfg.layer_pattern)}), 1 x {RING_TOKENS} "
              f"tokens: the local layers' forward takes local_attention over "
              f"{RING_TOKENS // 512} q blocks of 512, their rings of "
              f"{cfg.window_size} slots wrap at step {cfg.window_size}",
              ring)
    result["ring"] = ring
    del model, toks, fwd, dec
    free(dev)

    # whisper-base: serve, then encode, prime and decode against forward.
    w = families_serve("whisper-base", None, dev)
    model = w.pop("model")
    batch = pipeline_batch(model.cfg, WHISPER_STEPS, LM_BATCH, dev)
    with torch.inference_mode():
        enc = model.encode(batch["frames"])
        x = batch["frames"].to(model.dtype)
        for block in model.encoder.layers:
            x = block(x, None)
        no_pos = model.encoder.norm(x)
    toks = batch["tokens"]
    w["check"], fwd, _ = decode_check_run(
        model, toks, {"frames": batch["frames"]}, enc_out=enc)
    reject(w["check"], "zeroed cross cache", model, fwd,
           DC.decode_trace(model, toks, WHISPER_STEPS))
    reject(w["check"], "encoder without its sinusoidal positions", model,
           fwd, DC.decode_trace(model, toks, WHISPER_STEPS, enc_out=no_pos))
    log_check(f"whisper-base, {LM_BATCH} x {WHISPER_STEPS} tokens, "
              f"{model.cfg.encoder_seq} frames encoded and primed", w["check"])
    result["whisper-base"] = w
    del model, enc, no_pos, x, batch, toks, fwd
    free(dev)

    # qwen2-vl-7b: serve and one forward of the pipeline's patch stubs;
    # then decode against forward with M-RoPE positions on its first
    # VLM_CHECK_LAYERS layers.
    q = families_serve("qwen2-vl-7b", (FAMILIES_QUICK_LAYERS if quick
                                       else FAMILIES_LAYERS)["qwen2-vl-7b"],
                       dev)
    model = q.pop("model")
    b, s = VLM_FORWARD
    batch = pipeline_batch(model.cfg, s, b, dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = model(batch["tokens"], mm_embeds=batch["mm_embeds"],
                       positions_3d=batch["positions_3d"])
    torch.cuda.synchronize(dev)
    n_mm = batch["mm_embeds"].shape[1]
    finite = bool(torch.isfinite(logits).all())
    log(f"[families] qwen2-vl-7b forward of {b} x {s} tokens with the "
        f"pipeline's stubs ({n_mm} patch tokens on a "
        f"{int(batch['positions_3d'][1, 0, :n_mm].max()) + 1} x "
        f"{int(batch['positions_3d'][2, 0, :n_mm].max()) + 1} grid): logits "
        f"{tuple(logits.shape)}, finite {finite}, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    if not finite or logits.shape != (b, s, model.cfg.padded_vocab):
        raise SmokeFailure(f"families: qwen2-vl-7b stub forward gave "
                           f"{tuple(logits.shape)}, finite {finite}")
    del model, logits, batch
    free(dev)
    cfg = dataclasses.replace(
        get_config("qwen2-vl-7b"),
        num_layers=VLM_CHECK_LAYERS_QUICK if quick else VLM_CHECK_LAYERS)
    model = M.init_params(cfg, device=dev,
                          generator=torch.Generator(dev).manual_seed(0))
    batch = pipeline_batch(cfg, VLM_CHECK_STEPS, LM_BATCH, dev)
    toks, pos3 = batch["tokens"], batch["positions_3d"]
    n_mm = batch["mm_embeds"].shape[1]
    q["check"], fwd, _ = decode_check_run(model, toks,
                                          {"positions_3d": pos3})
    mrope = L.apply_mrope
    with patched(L, "apply_mrope",
                 lambda x, p, theta: mrope(x, p[[0, 2, 1]], theta)):
        reject(q["check"], "M-RoPE swaps the height and width streams",
               model, fwd, DC.decode_trace(model, toks[:, :n_mm], n_mm,
                                           cache_len=VLM_CHECK_STEPS,
                                           positions_3d=pos3))
    log_check(f"qwen2-vl-7b at full width, {cfg.num_layers} layers, "
              f"{LM_BATCH} x {VLM_CHECK_STEPS} tokens, the pipeline's "
              f"positions_3d ({n_mm} patch tokens on a grid of "
              f"{int(pos3[1, 0, :n_mm].max()) + 1} x "
              f"{int(pos3[2, 0, :n_mm].max()) + 1})", q["check"])
    result["qwen2-vl-7b"] = q
    del model, fwd, batch, toks, pos3
    free(dev)

    counts = kernels.launch_counts()
    if any(counts.values()):
        raise SmokeFailure(f"families: port kernels launched in the phase: "
                           f"{counts}")
    log(f"[families] port kernel launches in the phase: {dict(counts)}")
    result["launches"] = dict(counts)
    return result


def recurrent_phase(quick: bool, dev) -> dict:
    """The ``ssm`` and ``hybrid`` families on the card, through the port's
    LM path, with no port kernel launched (the counters are zeroed first
    and must read 0 after).  For falcon-mamba-7b and recurrentgemma-9b:
    ``serve --arch`` at full width on ``RECURRENT_LAYERS`` layers and a
    profile of two steps; then the decode-vs-forward check at full width on a cut depth
    (``RECURRENT_CHECKS``), which must reject (a) a forward that drops the
    chunk carry, and (b) a mamba conv cache of activated inputs or (c) an
    RG-LRU decode without its decay.  Each model is freed before the
    next."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import decode_check as DC
    from repro_torch.models import model as M
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as S

    def stores_activated_input(p, cache, x, _orig=S.mamba_decode):
        """(b): the conv cache keeps ``silu(conv(u))``, not ``u``."""
        out, new = _orig(p, cache, x)
        u = torch.chunk(p.in_proj(x), 2, dim=-1)[0]
        act = torch.nn.functional.silu(
            S.causal_conv(u, p.conv_w, p.conv_b, state=cache["conv"]))
        new["conv"] = torch.cat([new["conv"][:, :-1],
                                 act.to(new["conv"].dtype)], dim=1)
        return out, new

    def no_decay(p, xb, _orig=R.gates):
        """(c): the decay is 0, so ``h = a * h + gated`` omits ``a * h``."""
        a, gated = _orig(p, xb)
        return torch.zeros_like(a), gated

    kernels.reset_launch_counts()
    result = {}
    for arch in RECURRENT_ARCHS:
        r = families_serve(arch, (RECURRENT_QUICK_LAYERS if quick
                                  else RECURRENT_LAYERS)[arch], dev,
                           phase="recurrent")
        prof = lm_profile(r["model"], r["prompts"], dev)
        log_profile("recurrent", arch, prof)
        r["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms",
                                             "kernels")}
        del r["model"]
        free(dev)

        pattern, layers, seq = RECURRENT_CHECKS[arch]
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  **({"layer_pattern": pattern} if pattern
                                     else {}))
        model = M.init_params(cfg, device=dev,
                              generator=torch.Generator(dev).manual_seed(0))
        toks = pipeline_batch(cfg, seq, 1, dev)["tokens"]
        n = RECURRENT_FAULT_STEPS
        check, fwd, dec = decode_check_run(model, toks, {})
        with patched(S, "fold_carry", lambda a, b, h: b):
            reject(check, "(a) the forward drops the chunk carry", model,
                   DC.forward_trace(model, toks), dec)
        # A decode fault is held outside its patch: ``compare`` runs each
        # recurrent layer's forward, which must stay the honest one.
        if arch == "falcon-mamba-7b":
            fault = "(b) the conv cache stores the activated input"
            with patched(S, "mamba_decode", stores_activated_input):
                faulty = DC.decode_trace(model, toks[:, :n], n, cache_len=seq)
        else:
            fault = "(c) rglru_decode omits a * h"
            with patched(R, "gates", no_decay):
                faulty = DC.decode_trace(model, toks[:, :n], n, cache_len=seq)
        reject(check, fault, model, fwd, faulty)
        chunk = 256 if arch == "falcon-mamba-7b" else 512
        log_check(f"{arch} at full width, {layers} layers "
                  f"({'/'.join(cfg.layer_pattern)}), 1 x {seq} tokens "
                  f"(scan chunks of {chunk}; decode faults over {n} steps)",
                  check, "recurrent")
        r["check"] = check
        result[arch] = r
        del model, toks, fwd, dec, faulty
        free(dev)

    counts = kernels.launch_counts()
    if any(counts.values()):
        raise SmokeFailure(f"recurrent: port kernels launched in the phase: "
                           f"{counts}")
    log(f"[recurrent] port kernel launches in the phase: {dict(counts)}")
    result["launches"] = dict(counts)
    return result


def train_bounds(model, shape) -> dict:
    """The least time one train step could take on the card: the bytes
    ``TRAIN_BYTES_PER_PARAM`` (and the recompute's) count over 3.35 TB/s,
    and the useful FLOPs (``ModelConfig.model_flops``: 6 x the active
    parameters x the tokens, plus attention) over the bf16 peak."""
    n = sum(p.numel() for p in model.parameters())
    n_layers = sum(p.numel() for name, p in model.named_parameters()
                   if name.startswith("layers."))
    nbytes = n * TRAIN_BYTES_PER_PARAM + n_layers * TRAIN_RECOMPUTE_BYTES
    flops = model.cfg.model_flops(shape)
    return {"bytes": nbytes, "flops": flops,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "flops_ms": flops / PEAK_FLOPS["bfloat16"] * 1e3}


def train_profile(trainer, steps: int = 2) -> dict:
    """``torch.profiler`` over ``steps`` more train steps (the pipeline's
    next batches) after the run: per step the host wall time, the
    kernels' device time and count, and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = trainer.device
    first = trainer.history[-1]["step"] + 1
    batches = [trainer._put_batch(trainer.pipeline.batch_for_step(first + i))
               for i in range(steps)]
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches):
            m = trainer.step_fn(trainer.model, trainer.opt_state, batch,
                                first + i)
            float(m["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if kernels else None,
            "kernels": sum(e.count for e in kernels) / steps,
            "top": [(e.key[:60], e.self_device_time_total / 1e3 / steps,
                     e.count / steps) for e in top]}


def transpose_ms(model) -> float:
    """Device ms of the ``wᵀ`` copies one micro-batch's backward makes
    (each MoE layer's gate|up and down weights, in the compute dtype):
    CUDA events, warm, median of 5 per copy, summed."""
    from repro_torch.core.device import median_ms
    total = 0.0
    for block in model.layers:
        for master in (block.moe.w_gate_up, block.moe.w_down):
            w = master.detach().to(model.dtype)
            total += median_ms(lambda: w.transpose(1, 2).contiguous(), 5)
            del w
    return total


def grad_ratio(got, ref, absprod, dtype, extra: float) -> tuple:
    """``(worst err / bound, max |err|)`` of a gradient against the plain
    version's.  Bound: ``8 * eps_f32 * absprod`` (two fp32 sums of exact
    products), one rounding to ``dtype`` on each side (``eps(dtype) *
    (|got| + |ref|)``) and ``extra * absprod``.  No absolute floor: the
    gradients of a mean loss over a step's tokens are far below
    ``grouped_tolerance``'s ``ATOL``, which would pass a zeroed gradient.
    Where the bound is 0 the error must be 0; a non-finite ``got`` gives
    an infinite ratio."""
    import torch
    from repro_torch.launch.moe_block import EPS_F32
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), float("inf")
    bound = (8 * EPS_F32 + extra) * absprod + \
        float(torch.finfo(dtype).eps) * (g.abs() + r.abs())
    ratio = torch.where(bound > 0, err / bound,
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max()), float(err.max())


def train_grad_check(trainer) -> dict:
    """The kernel's gradients against the plain version's on the model's
    own operands: one forward and backward of the next batch (no remat),
    every grouped launch recorded with its ``dout`` and the ``dx`` and
    ``dw`` that ``GroupedMatmulFn`` gave; each launch then also runs
    through autograd of ``grouped_matmul_plain`` on the same operands.
    ``dx`` must agree within :func:`grad_ratio`'s bound on ``|dout| @
    |w|ᵀ``, ``dw`` within that on ``|x|ᵀ @ |dout|`` plus ``eps(dtype)``
    times it (cuBLAS may reduce split-K partials in bf16); padding rows
    must get exactly zero ``dx``.  The same comparison must reject four
    planted faults on every launch: a zeroed ``dx``, the kernel's ``dx``
    with the first ``TILE_K``-wide slice of its contraction dropped, a
    zeroed ``dw``, and ``dw`` without each expert's first block of rows.
    The model is not updated."""
    import torch
    from repro_torch.kernels.grouped_matmul import (
        TILE_K, grouped_matmul, grouped_matmul_plain)
    from repro_torch.train.train_step import softmax_xent

    model, dev = trainer.model, trainer.device
    step = trainer.history[-1]["step"] + 1
    batch = trainer._put_batch(trainer.pipeline.batch_for_step(step))
    records = []

    def recording(x, w, gids, *, bm, bk, bn, expert_rows=None):
        rec = {"x": x.detach(), "w": w.detach(), "gids": gids, "bm": bm,
               "bk": bk, "bn": bn}
        x.register_hook(lambda g: rec.__setitem__("dx", g))
        w.register_hook(lambda g: rec.__setitem__("dw", g))
        out = grouped_matmul(x, w, gids, bm=bm, bk=bk, bn=bn,
                             expert_rows=expert_rows)
        out.register_hook(lambda g: rec.__setitem__("dout", g))
        records.append(rec)
        return out

    logits = model(batch["tokens"], recording, remat=False)
    loss = softmax_xent(logits, batch["labels"], model.cfg.vocab_size)
    del logits
    params = [p for p in model.parameters()]
    torch.autograd.grad(loss, params)
    worst = {"dx": 0.0, "dw": 0.0, "dx_err": 0.0, "dw_err": 0.0,
             "dx_max": 0.0, "dw_max": 0.0}
    faults = {}
    for rec in records:
        x, w, gids, bm, dout = (rec["x"], rec["w"], rec["gids"], rec["bm"],
                                rec["dout"])
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        grouped_matmul_plain(xp, wp, gids, bm=bm).backward(dout)
        e = w.shape[0]
        w_t = w.transpose(1, 2).contiguous()
        abs_dx = grouped_matmul_plain(dout.abs().float(), w_t.abs().float(),
                                      gids, bm=bm)
        abs_dw = torch.bmm(x.abs().float().reshape(e, -1, x.shape[1])
                           .transpose(1, 2),
                           dout.abs().float().reshape(e, -1, dout.shape[1]))
        eps = float(torch.finfo(w.dtype).eps)
        cut = dout.clone()
        cut[:, :TILE_K] = 0
        x_cut = x.reshape(e, -1, x.shape[1]).clone()
        x_cut[:, :bm] = 0
        planted = {
            "dx": {"zeroed": torch.zeros_like(rec["dx"]),
                   "first k-slice dropped": grouped_matmul(
                       cut, w_t, gids, bm=bm, bk=rec["bn"], bn=rec["bk"])},
            "dw": {"zeroed": torch.zeros_like(rec["dw"]),
                   "first row block of each expert dropped": torch.bmm(
                       x_cut.transpose(1, 2),
                       dout.reshape(e, -1, dout.shape[1])).to(w.dtype)}}
        del cut, x_cut, w_t
        for what, got, ref, absprod, extra in (
                ("dx", rec["dx"], xp.grad, abs_dx, 0.0),
                ("dw", rec["dw"], wp.grad, abs_dw, eps)):
            ratio, err = grad_ratio(got, ref, absprod, w.dtype, extra)
            if ratio > 1:
                raise SmokeFailure(f"train: {what} of a grouped launch "
                                   f"{tuple(x.shape)} x {tuple(w.shape)} vs "
                                   f"the plain version: err / bound "
                                   f"{ratio:.3f}")
            worst[what] = max(worst[what], ratio)
            worst[what + "_err"] = max(worst[what + "_err"], err)
            worst[what + "_max"] = max(worst[what + "_max"],
                                       float(ref.abs().max()))
            for fault, bad in planted[what].items():
                bad_ratio, _ = grad_ratio(bad, ref, absprod, w.dtype, extra)
                if bad_ratio <= 1:
                    raise SmokeFailure(f"train: the {what} check let a "
                                       f"planted fault through ({fault}: "
                                       f"err / bound {bad_ratio:.3f})")
                key = f"{what} {fault}"
                faults[key] = min(faults.get(key, float("inf")), bad_ratio)
        padding = ~x.bool().any(dim=1)
        if not bool(padding.any()) or bool(rec["dx"][padding].any()):
            raise SmokeFailure("train: padding rows of the capacity buffer "
                               "got a nonzero dx (or there were none)")
        del xp, wp, abs_dx, abs_dw, planted
    n = len(records)
    records.clear()
    return {"checked_launches": n, **worst, "faults": faults}


def train_phase(quick: bool, dev) -> dict:
    """``Trainer`` on olmoe-1b-7b at full width (``TRAIN_LAYERS`` layers) on
    the card: 8 AdamW steps of batch 4 x 512, preempted after 4 with a
    checkpoint and resumed from it by a second trainer.  Counters are
    zeroed before the first trainer starts and read after the second one
    ends: ``grouped_matmul`` must have launched 6 x layers x 8 times and
    no other kernel at all.  Then a profile of 2 more steps, the
    transposed-weight copies, and the kernel's gradients against the plain
    version's (``train_grad_check``); everything is freed after."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(
        get_config(LM_ARCH),
        num_layers=TRAIN_QUICK_LAYERS if quick else TRAIN_LAYERS)
    shape = ShapeConfig("train-smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    ckpt_dir = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    tcfg = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=TRAIN_STEPS, keep=1,
                         schedule_kwargs=TRAIN_SCHEDULE)
    saves = []

    def trainer():
        tr = Trainer(cfg, shape, tcfg, opt_cfg=adamw.AdamWConfig(lr=TRAIN_LR),
                     data_cfg=DataConfig(seed=0), device=dev)
        save = tr.ckpt.save

        def timed(step, tree):
            t0 = time.perf_counter()
            path = save(step, tree)
            saves.append((step, time.perf_counter() - t0))
            return path
        tr.ckpt.save = timed
        return tr

    log(f"[train] === Trainer {cfg.name}: {cfg.num_layers} of 16 layers, "
        f"d {cfg.d_model}, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_token}, expert d_ff {cfg.moe_d_ff}; batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps, preempted after "
        f"{TRAIN_STOP}; checkpoints in {ckpt_dir} "
        f"({shutil.disk_usage(ckpt_dir).free / 1e9:.1f} GB free) ===")
    try:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        first = trainer()
        first.run(TRAIN_STEPS, stop_after=TRAIN_STOP)
        history = list(first.history)
        del first
        gc.collect()
        empty_cache(dev)
        second = trainer()
        t0 = time.perf_counter()
        start = second.init_or_restore()
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        second.run(TRAIN_STEPS)
        counts = kernels.launch_counts()
        history += second.history
        model = second.model
        planned = model.grouped_launches_per_step(train=True) * TRAIN_STEPS
        if start != TRAIN_STOP or [h["step"] for h in history] != \
                list(range(TRAIN_STEPS)):
            raise SmokeFailure(f"train: resumed at {start}, ran steps "
                               f"{[h['step'] for h in history]}")
        if counts["grouped_matmul"] != planned or \
                any(v for k, v in counts.items() if k != "grouped_matmul"):
            raise SmokeFailure(f"train: launches {counts}, planned {planned} "
                               f"grouped_matmul and nothing else")
        losses = [h["loss"] for h in history]
        if not np.all(np.isfinite(losses)):
            raise SmokeFailure(f"train: losses {losses}")
        peak = torch.cuda.max_memory_allocated(dev) - base
        n_params = sum(p.numel() for p in model.parameters())
        ckpt_bytes = sum(f.stat().st_size for f in
                         pathlib.Path(ckpt_dir).rglob("*.npy"))
        ms = np.asarray([h["dt"] for h in history]) * 1e3
        median = float(np.median(ms))
        bounds = train_bounds(model, shape)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        log(f"[train] {n_params} parameters, {n_params * 4 / 1e9:.2f} GB of "
            f"fp32 masters, {n_params * 16 / 1e9:.2f} GB with gradients, mu "
            f"and nu; max_memory_allocated {peak / 1e9:.2f} GB above the "
            f"{base / 1e9:.2f} GB the earlier phases hold")
        log(f"[train] losses by step: "
            + ", ".join(f"{h['step']}: {h['loss']:.4f}" for h in history))
        log(f"[train] step ms by step: "
            + ", ".join(f"{h['step']}: {h['dt'] * 1e3:.1f}"
                        for h in history))
        log(f"[train] step median {median:.3f} ms (max {ms.max():.3f}, min "
            f"{ms.min():.3f}); bounds: bytes {bounds['bytes_ms']:.3f} ms "
            f"({bounds['bytes'] / 1e9:.1f} GB), FLOPs "
            f"{bounds['flops_ms']:.3f} ms ({bounds['flops'] / 1e12:.3f} "
            f"TFLOP useful); {tokens / median * 1e3:.1f} tokens/s, mfu "
            f"{bounds['flops'] / (median / 1e3) / PEAK_FLOPS['bfloat16']:.4f}"
            f"; grouped_matmul launches {counts['grouped_matmul']} = "
            f"planned {planned}")
        log(f"[train] checkpoints: "
            + ", ".join(f"step {s} saved in {t:.1f}s" for s, t in saves)
            + f"; {ckpt_bytes / 1e9:.2f} GB of .npy; restored in "
            f"{restore_s:.1f}s, resumed at step {start}")
        prof = train_profile(second)
        if prof["device_ms"] is None:
            log(f"[train] profiled step: {prof['wall_ms']:.3f} ms on the "
                f"host clock; device time not measured (no device events "
                f"traced)")
        else:
            log(f"[train] profiled step (torch.profiler, 2 steps): "
                f"{prof['wall_ms']:.3f} ms on the host clock, kernels "
                f"{prof['device_ms']:.3f} ms of device time "
                f"({prof['kernels']:.0f} kernels), device idle "
                f"{1 - prof['device_ms'] / prof['wall_ms']:.1%} of the "
                f"profiled step; largest: "
                + "; ".join(f"{k} {t:.3f} ms x{c:.0f}"
                            for k, t, c in prof["top"]))
        t_ms = transpose_ms(model)
        log(f"[train] the dx path's transposed weight copies: {t_ms:.3f} ms "
            f"per step ({2 * cfg.num_layers} copies)")
        t0 = time.perf_counter()
        check = train_grad_check(second)
        log(f"[train] kernel gradients vs the plain version on the model's "
            f"operands, {check['checked_launches']} grouped launches of one "
            f"step: dx worst err / bound {check['dx']:.3f} (max |err| "
            f"{check['dx_err']:.3e}, max |dx| {check['dx_max']:.3e}), dw "
            f"worst err / bound {check['dw']:.3f} (max |err| "
            f"{check['dw_err']:.3e}, max |dw| {check['dw_max']:.3e}); "
            f"padding rows' dx 0; planted faults rejected on every launch, "
            f"least err / bound: "
            + ", ".join(f"{k} {v:.1f}" for k, v in check["faults"].items())
            + f"; check took {time.perf_counter() - t0:.1f}s")
        result = {"launches": counts["grouped_matmul"], "planned": planned,
                  "layers": cfg.num_layers, "losses": losses,
                  "step_median_ms": median, "step_max_ms": float(ms.max()),
                  "bound_bytes_ms": bounds["bytes_ms"],
                  "bound_flops_ms": bounds["flops_ms"],
                  "tokens_per_s": tokens / median * 1e3,
                  "mfu": bounds["flops"] / (median / 1e3)
                  / PEAK_FLOPS["bfloat16"],
                  "params": n_params, "peak_bytes": peak,
                  "ckpt_bytes": ckpt_bytes,
                  "save_s": [t for _, t in saves], "restore_s": restore_s,
                  "profiled_wall_ms": prof["wall_ms"],
                  "profiled_device_ms": prof["device_ms"],
                  "profiled_kernels": prof["kernels"],
                  "transpose_ms": t_ms, "grad_check": check}
        del model, second
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        gc.collect()
        empty_cache(dev)
    return result


def kernel_of(fmt_name: str) -> str:
    """The kernel a ``cuda`` plan of ``fmt_name`` launches."""
    return next(k for k, v in KERNELS.items() if fmt_name in v[3])


def async_return(plan, m, dev) -> dict:
    """``execute_wide`` on one planned-width batch: does it hand control
    back to the host before its end event completes?"""
    import torch
    b = torch.ones((m.n, D), device=dev)
    plan.execute_wide(b)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    plan.execute_wide(b)
    host_ms = (time.perf_counter() - t0) * 1e3
    end = torch.cuda.Event()
    end.record()
    pending = not end.query()
    end.synchronize()
    plan.reset_stats()
    return {"returned_before_end": pending, "host_ms": host_ms}


def engine_run(tag: str, m, disp, requests: int, dev, check_async: bool,
               enforce: bool) -> dict:
    """One ``serve --engine`` run on ``disp``; every ticket checked.  With
    ``check_async`` the staging overlap and the async return are reported,
    and with ``enforce`` they must hold."""
    import numpy as np
    from repro_torch.core.precision import as_precision
    from repro_torch.launch import serve

    args = serve.parser().parse_args(
        ["--engine", "--spmm-structure", "moe-block", "--spmm-n", str(m.n),
         "--spmm-d", str(D), "--engine-streams", str(ENGINE_STREAMS),
         "--engine-requests", str(ENGINE_STREAMS * requests),
         "--engine-rate", "2000", "--engine-queue", "256",
         "--engine-policy", "wait", "--device", str(dev)])
    log(f"[engine] === {tag}: moe-block n={m.n}, d={D}/{D // 2}, "
        f"{ENGINE_STREAMS} streams x {requests} requests ===")
    rec = serve.serve_spmm_engine(args, dispatcher=disp, matrix=m)
    counts = rec["engine_launches"]
    plan, eng, st = rec["plan"], rec["engine"], rec["stats"]
    kernel = kernel_of(plan.chosen)
    # One execute per planned-width block of each batch; row-split makes
    # a second launch where a block has carry or empty rows.
    calls = sum(-(-r.cols // r.block_d) for r in eng.batch_log)
    most = 2 * calls if kernel == "rowsplit_spmm" else calls
    log(f"[engine] {tag}: chosen {plan.chosen} @ {plan.precision} -> "
        f"{kernel}, launches from the engine's start to its stop {counts} "
        f"for {calls} planned-width blocks in {len(eng.batch_log)} batches")
    if not calls <= counts[kernel] <= most:
        raise SmokeFailure(f"engine {tag}: {kernel} launched "
                           f"{counts[kernel]} times for {calls} blocks")
    if st["served"] != ENGINE_STREAMS * requests:
        raise SmokeFailure(f"engine {tag}: served {st['served']} of "
                           f"{ENGINE_STREAMS * requests}")
    eps = as_precision(plan.precision).eps
    plain = torch_backend(plan, m, disp, dev)
    worst = 0.0
    for ticket, b in rec["served"]:
        got = ticket.result(timeout=0).to(dev)
        bd = b.to(dev)
        absprod = abs_product(m, bd)
        err, _ = check_close(f"engine {tag} ticket {ticket.id}", got,
                             plain(bd), absprod, eps)
        check_close(f"engine {tag} ticket {ticket.id} vs plan.execute_wide",
                    got, plan.execute_wide(bd), absprod, eps)
        worst = max(worst, err)
    plan.reset_stats()
    del plain
    log(f"[engine] {tag}: all {len(rec['served'])} tickets match the "
        f"{plan.chosen} torch backend on their B (max |err| {worst:.3e}) "
        f"and plan.execute_wide")
    batches = {r.seq: r for r in eng.batch_log}
    for t in eng.transfer_log:
        b = batches[t.seq]
        log(f"[engine] {tag} batch {t.seq}: x{len(b.request_ids)} widths "
            f"{list(b.widths)} cols {b.cols}; h2d {t.h2d_ms:.4f} ms "
            f"({t.bytes_in / 1e6:.1f} MB), kernel {t.kernel_ms:.4f} ms, "
            f"d2h {t.d2h_ms:.4f} ms ({t.bytes_out / 1e6:.1f} MB); host: "
            f"staging {t.stage_host_ms:.3f} ms, result buffer "
            f"{t.result_alloc_host_ms:.3f} ms; next batch staged before "
            f"this one ended: {t.next_staged_early}")
    split = {k: float(np.median([getattr(t, k) for t in eng.transfer_log]))
             for k in ("h2d_ms", "kernel_ms", "d2h_ms", "stage_host_ms",
                       "result_alloc_host_ms")}
    early = sum(1 for t in eng.transfer_log if t.next_staged_early)
    out = {"n": m.n, "requests": st["served"], "batches": st["batches"],
           "coalesced": st["coalesced"], "p50_us": st["p50_us"],
           "p99_us": st["p99_us"], "goodput_rps": st["goodput_rps"],
           "sync_p50_us": rec["sync_p50_us"],
           "sync_p99_us": rec["sync_p99_us"],
           "sync_goodput_rps": rec["sync_goodput_rps"],
           "mean_batch_cols": st["mean_batch_cols"],
           "staged_early": early, "counts": counts,
           "startup_ms": rec["startup_ms"], **split}
    log(f"[engine] {tag}: engine p50 {st['p50_us']:.1f} us, p99 "
        f"{st['p99_us']:.1f} us, goodput {st['goodput_rps']:.1f} req/s; "
        f"sync p50 {rec['sync_p50_us']:.1f} us, p99 "
        f"{rec['sync_p99_us']:.1f} us, goodput "
        f"{rec['sync_goodput_rps']:.1f} req/s; {st['batches']} batches, "
        f"{st['coalesced']} requests coalesced, mean batch "
        f"{st['mean_batch_cols']:.1f} columns; median per batch h2d "
        f"{split['h2d_ms']:.4f} ms, kernel {split['kernel_ms']:.4f} ms, "
        f"d2h {split['d2h_ms']:.4f} ms, host staging "
        f"{split['stage_host_ms']:.3f} ms, result buffer "
        f"{split['result_alloc_host_ms']:.3f} ms; {early} batches had the "
        f"next staged before they ended")
    if check_async:
        check = async_return(plan, m, dev)
        log(f"[engine] {tag}: execute_wide returned to the host after "
            f"{check['host_ms']:.4f} ms, before its end event completed: "
            f"{check['returned_before_end']}")
        out.update(check)
        if enforce and early <= 0:
            raise SmokeFailure(f"engine {tag}: no batch's successor was "
                               f"staged before the batch ended")
        if enforce and not check["returned_before_end"]:
            raise SmokeFailure(f"engine {tag}: execute_wide waited for the "
                               f"card")
    del rec
    empty_cache(dev)
    return out


def engine_phase(served: dict, quick: bool, dev) -> list:
    """The serving engine at full width on the serving phase's moe-block
    plan, then at the reference CLI's default shape."""
    from repro_torch.launch import serve
    from repro_torch.sparse.dispatch import Dispatcher
    rows = []
    for tag, n, requests in ENGINE_RUNS:
        if n is None:
            m = served["matrices"]["moe-block"]
            disp = served["dispatchers"]["moe-block"]
        else:
            m = serve.build_stream_matrix("moe-block", n)
            disp = Dispatcher(device=dev, calibration=False, tree=False)
        rows.append(dict(engine_run(tag, m, disp, requests, dev,
                                    check_async=n is None,
                                    enforce=n is None and not quick),
                         tag=tag))
    return rows


def served_p50(fn, dev) -> float:
    """p50 in us of ``STEPS`` calls of ``fn``, each timed on the host clock
    from a synchronised start to a synchronise, as a served request is."""
    import numpy as np
    from repro_torch.core.device import synchronize
    fn()
    lat = []
    for _ in range(STEPS):
        synchronize(dev)
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        lat.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(lat))


def shard_phase(quick: bool, dev) -> list:
    """Sharded plans over four shards of one card against the unsharded
    ``cuda`` plan, then ``serve --spmm-shards -1``."""
    import numpy as np
    import torch
    from repro_torch.core.precision import as_precision
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import ShardMesh
    from repro_torch.sparse import stream
    from repro_torch.sparse.dispatch import Dispatcher
    from repro_torch.sparse.shard import B_STRATEGIES

    mesh = ShardMesh([torch.device(dev.type, dev.index or 0)]
                     * SHARD_DEVICES)
    rng = np.random.default_rng(11)
    rows = []
    runs = [(s, "auto") for s in SHARD_STRUCTURES] + \
        [("scale-free", f) for f in SHARD_FORCED]
    n = SHARD_N_QUICK if quick else SHARD_N
    matrices, dispatchers = {}, {}
    for structure, fmt_name in runs:
        if structure not in matrices:
            matrices[structure] = serve.build_stream_matrix(structure, n)
            dispatchers[structure] = Dispatcher(device=dev,
                                                calibration=False, tree=False)
        m, disp = matrices[structure], dispatchers[structure]
        spec = stream.BSpec(d=D, reuse=STEPS)
        single = stream.plan(m, spec, strategy=fmt_name, dispatcher=disp)
        b = torch.from_numpy(rng.normal(size=(n, D)).astype("float32")
                             ).to(dev)
        want = single.execute(b)
        absprod = abs_product(m, b)
        eps = as_precision(single.precision).eps
        single_p50 = served_p50(lambda: single.execute(b), dev)
        for strat in B_STRATEGIES:
            what = f"{structure}/{fmt_name}/{strat}"
            try:
                p = stream.plan(m, spec, strategy=fmt_name, mesh=mesh,
                                b_strategy=strat, dispatcher=disp)
            except ValueError as e:
                if single.chosen == "dia" and strat == "all_gather":
                    log(f"[shard] {what} n={n}: ineligible ({e})")
                    continue
                raise
            err, _ = check_close(f"shard {what} vs unsharded cuda plan",
                                 p.execute(b), want, absprod, eps)
            ev = next(e for e in p.strategy_evals if e.strategy == strat)
            pred_us = ev.roofline.total_s * 1e6
            p50 = served_p50(lambda: p.execute(b), dev)
            log(p.summary())
            log(f"[shard] {what} n={n} nnz={m.nnz}: {p.chosen} @ "
                f"{p.precision} on {p.num_shards} shards, partition "
                f"{p.partition}, shard nnz {list(map(int, p.shard_nnz))}; "
                f"max |C - unsharded cuda| {err:.3e} within bound; p50 of "
                f"{STEPS} requests {p50:.1f} us, predicted {pred_us:.1f} us "
                f"(compute {ev.roofline.compute_s * 1e6:.1f}, collective "
                f"{ev.roofline.collective_s * 1e6:.1f}); the unsharded "
                f"cuda plan's p50 {single_p50:.1f} us")
            rows.append({"structure": structure, "format": p.chosen,
                         "b_strategy": strat, "n": n, "p50_us": p50,
                         "predicted_us": pred_us, "max_abs_err": err,
                         "unsharded_p50_us": single_p50})
            del p
        del single, want, absprod, b
        empty_cache(dev)
    args = serve.parser().parse_args(
        ["--spmm-stream", "--spmm-shards", "-1", "--spmm-steps", str(STEPS),
         "--device", str(dev)])
    log("[shard] === serve --spmm-stream --spmm-shards -1 ===")
    rec = serve.serve_spmm_stream(args)
    plan = rec["plan"]
    if dev.type == "cuda" and plan.num_shards != torch.cuda.device_count():
        raise SmokeFailure(f"--spmm-shards -1 made {plan.num_shards} shards "
                           f"on {torch.cuda.device_count()} cards")
    b, c = rec["last"]
    single = stream.plan(rec["matrix"], stream.BSpec(d=D, reuse=STEPS),
                         dispatcher=plan._dispatcher)
    err, _ = check_close("serve --spmm-shards -1 vs unsharded",
                         c, single.execute(b), abs_product(rec["matrix"], b),
                         as_precision(plan.precision).eps)
    log(f"[shard] serve --spmm-shards -1: {plan.chosen} on "
        f"{plan.num_shards} shard(s), {plan.b_strategy}; p50 "
        f"{rec['p50_us']:.1f} us; max |C - unsharded| {err:.3e} within "
        f"bound")
    return rows


def calibrate_phase(scale: Optional[int], dev) -> dict:
    """``serve --calibrate``'s sweep on the card: every SpMM kernel must
    launch, and the saved file must load back at this registry version."""
    from repro_torch import kernels
    from repro_torch.core.calibrate import CalibrationStore
    from repro_torch.core.hardware import h100_from_device
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.sparse.dispatch import FORMATS

    kernels.reset_launch_counts()
    cal = serve.run_startup_calibration(dev, scale=scale)
    counts = kernels.launch_counts()
    log(f"[calibrate] launches in the sweep: {counts}")
    missing = [k for k in KERNELS if counts[k] <= 0]
    if missing:
        raise SmokeFailure(f"the calibration sweep never launched {missing}")
    if [e.format for e in cal.entries] != list(FORMATS):
        raise SmokeFailure(f"the sweep fitted "
                           f"{[e.format for e in cal.entries]}, not "
                           f"{list(FORMATS)}")
    for e in cal.entries:
        measured = ", ".join(f"d={d} {g:.2f}"
                             for d, g in sorted(e.measured.items()))
        log(f"[calibrate] {e.format:8s} {e.precision}: peak_fraction "
            f"{e.peak_fraction:.6f}, d_half {e.d_half:.2f}, sustained "
            f"{e.sustained_gflops:.2f} GF/s (useful_fraction "
            f"{e.useful_fraction:.3f}); measured GF/s {measured}")
    loaded = CalibrationStore().load(h100_from_device(dev), "cuda")
    if loaded is None or \
            loaded.registry_version != registry.REGISTRY_VERSION:
        raise SmokeFailure(f"the saved calibration does not load back at "
                           f"registry v{registry.REGISTRY_VERSION}: "
                           f"{loaded}")
    log(f"[calibrate] saved {CalibrationStore().root}: backend "
        f"{loaded.backend}, registry v{loaded.registry_version}")
    return {"cal": cal, "counts": counts}


def harvest_phase(dev) -> dict:
    """The port's harvest on the vendored corpus with the CUDA kernels; the
    tree goes to a store root of its own.  Agreement and never-worse are
    reported, not enforced: at n <= 256 a call is the launch path."""
    import shutil
    import tempfile
    from repro_torch import kernels
    from repro_torch.data import corpus
    from repro_torch.data.dtree import DispatchTreeStore
    from repro_torch.launch import harvest_dispatch

    args = harvest_dispatch.parser().parse_args(
        ["--corpus-root", str(corpus.SAMPLES_DIR), "--backend", "cuda",
         "--device", str(dev), "--d", "32", "128", "--repeats", "3",
         "--out-dir", str(ROOT / "chiprun_out" / "harvest")])
    root = tempfile.mkdtemp(prefix="chip-smoke-tree-")
    try:
        kernels.reset_launch_counts()
        rec = harvest_dispatch.harvest(args, store=DispatchTreeStore(root))
        counts = kernels.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    worse = [f"{r['matrix']} d={r['d']}" for r in rec["audit"]
             if not r["never_worse"]]
    log(f"[harvest] {len(rec['rows'])} cells timed on "
        f"{len({r['matrix'] for r in rec['rows']})} matrices, launches "
        f"{counts}; tree {rec['tree'].fingerprint()}; agreement "
        f"{rec['agreement']:.4f} over {len(rec['audit'])} pairs; "
        f"never-worse {'PASS' if rec['claim_ok'] else 'FAIL'} "
        f"(failing pairs: {worse or 'none'})")
    return rec


DRYRUN_TABLE_CODE = r'''
import json, sys
from repro_torch.launch import dryrun as DR
for arch, shape in json.loads(sys.argv[1]):
    rec = DR.run_cell(arch, shape, False, verbose=False)
    print("RECORD " + json.dumps(rec), flush=True)
'''


def dryrun_table_start(cells) -> subprocess.Popen:
    """Count the full-size meta cells on the 32 x 8 mesh in a subprocess
    (CPU only: it sees no card)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-c", DRYRUN_TABLE_CODE, json.dumps(cells)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def counts_equal(a, b) -> bool:
    return a.flops == b.flops and a.bytes == b.bytes


def count_diff(a, b, k: int = 8) -> str:
    """The op rows where two counts differ, for a failure message."""
    keys = sorted(set(a.rows) | set(b.rows), key=str)
    diff = [(str(key), a.rows.get(key), b.rows.get(key)) for key in keys
            if a.rows.get(key) != b.rows.get(key)]
    return "; ".join(f"{key}: {x} vs {y}" for key, x, y in diff[:k])


@contextlib.contextmanager
def grouped_fault(name: str):
    """A planted fault in the counter's grouped product."""
    from repro_torch.core import step_cost as SC
    orig = SC.StepCounter.grouped

    def faulty(self, x, w, out):
        if name == "w bytes left out":
            w = w[:0]
        else:                                  # every row x every expert
            x = x.expand(w.shape[0], *x.shape).reshape(-1, x.shape[1])
        orig(self, x, w, out)
    SC.StepCounter.grouped = faulty
    try:
        yield
    finally:
        SC.StepCounter.grouped = orig


def warm_count(cfg, shape, model, state):
    """Count a step of ``model`` after one warm step (which fills its
    per-layer caches: the grouped ids, the sinusoid table)."""
    from repro_torch.launch import dryrun as DR
    DR.count_step(cfg, shape, model=model, state=state)
    return DR.count_step(cfg, shape, model=model, state=state)


def dryrun_train_check(quick: bool, dev, hw) -> dict:
    """(a): olmoe-1b-7b's train step counted on the card and on meta."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.roofline import DistributedRoofline
    from repro_torch.kernels import grouped_matmul as G
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS
    full = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(
        full, num_layers=TRAIN_QUICK_LAYERS if quick else TRAIN_LAYERS)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt_cfg = adamw.AdamWConfig()

    def made(device, c=cfg):
        gen = torch.Generator(device).manual_seed(0) \
            if device != "meta" else None
        m = LM(c, device=device, generator=gen, masters=True)
        return m, adamw.init_state(dict(m.named_parameters()), opt_cfg)

    model, state = made(dev)
    before = G.LAUNCHES
    card = warm_count(cfg, shape, model, state)
    launches = G.LAUNCHES - before
    want = 2 * model.grouped_launches_per_step(train=True)
    if launches != want:
        raise SmokeFailure(f"dryrun: the two counted train steps launched "
                           f"the grouped kernel {launches} times, not "
                           f"{want}")
    meta = warm_count(cfg, shape, *made("meta"))
    if not counts_equal(card, meta):
        raise SmokeFailure(f"dryrun: card and meta counts of the train step "
                           f"differ: {count_diff(card, meta)}")
    faults = {}
    for fault in ("w bytes left out", "every row x every expert"):
        with grouped_fault(fault):
            bad = warm_count(cfg, shape, *made("meta"))
        if counts_equal(card, bad):
            raise SmokeFailure(f"dryrun: planted fault {fault!r} counted "
                               f"equal to the card")
        faults[fault] = (bad.flops / card.flops, bad.bytes / card.bytes)
    batch = pipeline_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, dev)
    step = TS.make_train_step(cfg, shape, opt_cfg=opt_cfg)
    step(model, state, batch, 0)
    torch.cuda.synchronize(dev)
    ms = []
    for i in range(3):
        t0 = time.perf_counter()
        step(model, state, batch, i + 1)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(ms))
    model_flops = cfg.model_flops(shape)

    def bound(count, name):
        return DistributedRoofline(
            name=name, chips=1, hlo_flops=count.flops, hlo_bytes=count.bytes,
            collective_bytes=0.0, hardware=hw, model_flops=model_flops)

    roof = bound(card, f"{cfg.name}/train/{cfg.num_layers}L")
    if median < roof.step_time_lower_bound_s * 1e3:
        raise SmokeFailure(f"dryrun: the train step ran in {median:.3f} ms, "
                           f"below its lower bound "
                           f"{roof.step_time_lower_bound_s * 1e3:.3f} ms")
    del model, state, batch
    free(dev)
    full_roof = bound(warm_count(full, shape, *made("meta", full)),
                      f"{full.name}/train/16L")
    if full_roof.step_time_lower_bound_s * 1e3 <= median:
        raise SmokeFailure(f"dryrun: the 16-layer count's bound "
                           f"{full_roof.step_time_lower_bound_s * 1e3:.3f} "
                           f"ms was not above the {cfg.num_layers}-layer "
                           f"step's {median:.3f} ms")
    log(f"[dryrun] (a) {cfg.name} train step, {cfg.num_layers} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: counted on the card = on meta: "
        f"{card.flops:.6e} FLOPs, {card.bytes:.6e} bytes "
        f"({launches} grouped launches in the two counted steps); "
        f"faults rejected (FLOP, byte ratio to the card): "
        f"{ {k: (round(a, 4), round(b, 4)) for k, (a, b) in faults.items()} }"
        f"; model_flops {model_flops:.6e}, useful_compute_ratio "
        f"{roof.useful_compute_ratio:.4f}")
    log(f"[dryrun] (a) step median {median:.3f} ms (runs "
        f"{', '.join(f'{m:.3f}' for m in ms)}) >= lower bound "
        f"{roof.step_time_lower_bound_s * 1e3:.3f} ms (compute "
        f"{roof.compute_s * 1e3:.3f}, memory {roof.memory_s * 1e3:.3f} ms, "
        f"{roof.dominant}) on {hw.name} at {hw.peak_flops / 1e12:.0f} "
        f"TFLOP/s, {hw.hbm_bandwidth / 1e12:.2f} TB/s; fault: the 16-layer "
        f"count's bound {full_roof.step_time_lower_bound_s * 1e3:.3f} ms "
        f"rejected")
    return {"flops": card.flops, "bytes": card.bytes, "median_ms": median,
            "bound_ms": roof.step_time_lower_bound_s * 1e3,
            "compute_ms": roof.compute_s * 1e3,
            "memory_ms": roof.memory_s * 1e3,
            "useful_compute_ratio": roof.useful_compute_ratio,
            "faults": faults, "launches": launches,
            "full_bound_ms": full_roof.step_time_lower_bound_s * 1e3}


def dryrun_decode_check(quick: bool, dev) -> dict:
    """(b): olmoe-1b-7b's decode step counted against ``lm_step_bytes``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import LM
    cfg = get_config("olmoe-1b-7b")
    if quick:
        cfg = dataclasses.replace(cfg, num_layers=2)
    cache_len = LM_PROMPT + LM_GEN
    shape = ShapeConfig("decode", cache_len, LM_BATCH, "decode")
    counts = {}
    for device in (dev, "meta"):
        gen = torch.Generator(device).manual_seed(0) \
            if device != "meta" else None
        model = LM(cfg, device=device, generator=gen)
        cache = model.init_cache(LM_BATCH, cache_len)
        counts[str(device)] = warm_count(cfg, shape, model, cache)
        need = lm_step_bytes(model, LM_BATCH, cache_len)
        del model, cache
        free(dev)
    card, meta = counts[str(dev)], counts["meta"]
    if not counts_equal(card, meta):
        raise SmokeFailure(f"dryrun: card and meta counts of the decode "
                           f"step differ: {count_diff(card, meta)}")
    if card.bytes < need:
        raise SmokeFailure(f"dryrun: the decode step counted "
                           f"{card.bytes:.6e} bytes, below lm_step_bytes "
                           f"{need:.6e}")
    model = LM(cfg, device="meta")
    with grouped_fault("w bytes left out"):
        bad = warm_count(cfg, shape, model,
                         model.init_cache(LM_BATCH, cache_len))
    if bad.bytes >= need:
        raise SmokeFailure(f"dryrun: the count without the grouped w bytes "
                           f"({bad.bytes:.6e}) was not below lm_step_bytes")
    log(f"[dryrun] (b) {cfg.name} decode step, batch {LM_BATCH}, cache "
        f"{cache_len}, {cfg.num_layers} layers: counted on the card = on "
        f"meta: {card.flops:.6e} FLOPs, {card.bytes:.6e} bytes >= "
        f"lm_step_bytes {need:.6e} ({card.bytes / need:.4f}x); fault "
        f"(grouped w bytes left out): {bad.bytes:.6e} rejected")
    return {"flops": card.flops, "bytes": card.bytes, "lm_step_bytes": need,
            "fault_bytes": bad.bytes}


def dryrun_prefill_check(quick: bool, dev) -> dict:
    """(c): llama3.2-1b's prefill, masked against triangle attention."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.step_cost import StepCounter
    from repro_torch.models import attention as ATT
    from repro_torch.models import model as M
    cfg = get_config("llama3.2-1b")
    seq = DRYRUN_PREFILL_QUICK if quick else DRYRUN_PREFILL
    model = M.LM(cfg, device=dev,
                 generator=torch.Generator(dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size - 1, size=(1, seq))).to(dev)
    nq = seq // 512
    attn = cfg.num_layers * 4 * cfg.num_heads * seq * seq * cfg.head_dim
    want = attn * (1 - (nq + 1) / (2 * nq))

    def run(impl, fault=None):
        orig = ATT.kv_blocks
        if fault == "drops the diagonal":
            ATT.kv_blocks = lambda i, nk, tri: range(i) if tri \
                else range(nk)
        elif fault == "walks every pair":
            ATT.kv_blocks = lambda i, nk, tri: range(nk)
        ATT.set_causal_impl(impl)
        try:
            with torch.no_grad():
                with StepCounter() as c:
                    logits = model(tokens, remat=False)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                model(tokens, remat=False)
                torch.cuda.synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
        finally:
            ATT.set_causal_impl("masked")
            ATT.kv_blocks = orig
        return logits, c.count.flops, ms

    def excess(got, ref):
        rms = ref.double().pow(2).mean(dim=-1, keepdim=True).sqrt()
        tol = M.logit_tolerance(cfg, rms, ref.numel())
        return float(((got.double() - ref.double()).abs() - tol).max())

    masked, f_masked, ms_masked = run("masked")
    tri, f_tri, ms_tri = run("triangle")
    worst = excess(tri, masked)
    if not np.isfinite(worst) or worst > 0 or f_masked - f_tri != want:
        raise SmokeFailure(f"dryrun: triangle vs masked: worst excess over "
                           f"the bound {worst:.3e}, FLOPs {f_masked:.6e} - "
                           f"{f_tri:.6e} != {want:.6e}")
    ratio = (attn - (f_masked - f_tri)) / attn
    faults = {}
    for fault in ("drops the diagonal", "walks every pair"):
        bad, f_bad, _ = run("triangle", fault)
        e = excess(bad, masked)
        faults[fault] = (e, f_masked - f_bad)
        if np.isfinite(e) and e <= 0 and f_masked - f_bad == want:
            raise SmokeFailure(f"dryrun: planted triangle fault {fault!r} "
                               f"passed")
        del bad
    del model, masked, tri
    free(dev)
    log(f"[dryrun] (c) {cfg.name} prefill, 1 x {seq}: triangle logits "
        f"within the bound of masked (worst excess {worst:.3e} <= 0); "
        f"counted attention FLOPs ratio {ratio:.6f} = (nq + 1) / (2 nq) = "
        f"{(nq + 1) / (2 * nq):.6f} at nq = {nq}; wall-clock masked "
        f"{ms_masked:.3f} ms, triangle {ms_tri:.3f} ms; faults rejected: "
        f"{ {k: (f'{e:.3e}', f'{d:.6e}') for k, (e, d) in faults.items()} }")
    return {"seq": seq, "ratio": ratio, "masked_ms": ms_masked,
            "triangle_ms": ms_tri, "worst_excess": worst}


def dryrun_phase(quick: bool, dev) -> dict:
    """The dry run's counter held against the card (module docstring)."""
    from repro_torch import kernels
    from repro_torch.core import analyzer
    from repro_torch.core.hardware import h100_from_device, tensor_core
    hw = tensor_core(h100_from_device(dev))
    table = dryrun_table_start(DRYRUN_CELLS)
    try:
        kernels.reset_launch_counts()
        train = dryrun_train_check(quick, dev, hw)
        decode = dryrun_decode_check(quick, dev)
        prefill = dryrun_prefill_check(quick, dev)
        counts = kernels.launch_counts()
        out, err = table.communicate(timeout=600)
    finally:
        if table.poll() is None:
            table.kill()
            table.wait()
    if table.returncode != 0:
        raise SmokeFailure(f"dryrun: the table's counts failed: "
                           f"{err[-2000:]}")
    records = [json.loads(line[len("RECORD "):])
               for line in out.splitlines() if line.startswith("RECORD ")]
    if len(records) != len(DRYRUN_CELLS):
        raise SmokeFailure(f"dryrun: {len(records)} table records")
    analysed = [analyzer.analyze_record(r, hw) for r in records]
    log(f"[dryrun] (d) the full-size meta cells on the 32 x 8 mesh, "
        f"analysed on {hw.name} (bf16 {hw.peak_flops / 1e12:.0f} TFLOP/s, "
        f"{hw.hbm_bandwidth / 1e12:.2f} TB/s, NVLink "
        f"{hw.link_bandwidth / 1e9:.0f} GB/s; a model, not a measurement):")
    for line in analyzer.format_roofline_table(analysed).splitlines():
        log(f"[dryrun]   {line}")
    for r in records:
        log(f"[dryrun]   {r['arch']}/{r['shape']}: count_seconds "
            f"{r['count_seconds']:.2f}, fits {r['fits']} "
            f"({r['memory']['total_hbm_bytes'] / 1e9:.2f} GB per card)")
    others = {k: v for k, v in counts.items() if k != "grouped_matmul" and v}
    if others:
        raise SmokeFailure(f"dryrun: other kernels launched: {others}")
    return {"launches": counts["grouped_matmul"], "train": train,
            "decode": decode, "prefill": prefill,
            "table": [{k: r[k] for k in ("arch", "shape", "count_seconds",
                                         "fits")} | {"dominant":
                                                     a["roofline"]["dominant"]}
                      for r, a in zip(records, analysed)]}


# ---------------------------------------------------------------------------
# [multicard]: the process mesh and the per-shard programs on it.
# ---------------------------------------------------------------------------

#: The multicard phase: olmoe-1b-7b's MoE layer at full width on x [4,
#: 512, 2048] bf16 at capacity factor 1.25 over (data, model) meshes; the
#: pipeline of its first 4 layers, 2 stages x 2, 4 microbatches of 1 x
#: 512; the sharded tier on two ranks, d = 64 (``--quick``: 2 x 128
#: tokens, 2 layers, n = 2**12).
MC_ARCH = "olmoe-1b-7b"
MC_WORLD = 2
MC_MOE_MESHES = ((1, 2), (2, 1))
MC_CF = 1.25
MC_TOKENS, MC_TOKENS_QUICK = (4, 512), (2, 128)
MC_PIPE_LAYERS, MC_PIPE_LAYERS_QUICK = 4, 2
MC_PIPE_MICRO = 4
#: (structure, log2 n) of the sharded tier's runs: ``uniform`` (on the
#: CSR kernel) at 2**16 keeps its row-tile packing of each strategy's
#: shard inside the phase's time.
MC_SHARD_RUNS = (("moe-block", 18), ("banded", 18), ("uniform", 16))
MC_SHARD_N_QUICK = 2 ** 12
#: Roundings of the MoE FFN's forward between the buffer and the output
#: (gate/up, silu, the product with up, down, the combine's product and
#: its sum); its backward is counted the same again.
MC_MOE_ROUNDINGS = 6


def mc_ratio(got, ref, stages: int, dtype=None, dims=(-1,)) -> float:
    """Worst ``|got - ref|`` over ``models.model.rounding_tolerance`` of
    ``stages`` roundings to ``dtype`` (bf16 by default) at the scale of
    each row's largest ``|ref|`` (over ``dims``: by default the last
    dimension's); an error where the bound is 0 is infinite."""
    import torch
    from repro_torch.models.model import rounding_tolerance
    g, r = got.detach().float(), ref.detach().float()
    if tuple(g.shape) != tuple(r.shape):
        raise SmokeFailure(f"multicard: shape {tuple(g.shape)} vs "
                           f"{tuple(r.shape)}")
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    dims = tuple(d for d in dims if -r.ndim <= d < r.ndim)
    scale = r.abs().amax(dim=dims, keepdim=True) if dims else r.abs()
    tol = rounding_tolerance(stages, scale, r.numel(),
                             dtype or torch.bfloat16)
    err = (g - r).abs()
    ratio = torch.where(tol > 0, err / tol,
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max())


def mc_layer(cfg, dev, seed: int = 0):
    """olmoe-1b-7b's MoE layer with fp32 masters drawn from ``seed``."""
    import torch
    from repro_torch.models.moe import MoE
    g = torch.Generator(device=dev).manual_seed(seed)
    return MoE(cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
               cfg.num_experts_per_token, MC_CF, dtype=torch.float32,
               device=dev, generator=g, trainable=True)


def mc_moe(dev, backend, shape, quick: bool, lines: list) -> dict:
    """(a) The expert-parallel layer on a ``(data, model)`` mesh against
    the one-process layer on each data shard's tokens, forward and
    backward; two planted faults on the forward."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.moe import capacity, padded_capacity
    from repro_torch.models.sharding_ctx import ShardingCtx
    data, model = shape
    mesh = make_process_mesh(shape, ("data", "model"), device=dev,
                             backend=backend)
    cfg = get_config(MC_ARCH)
    B, S = MC_TOKENS_QUICK if quick else MC_TOKENS
    d = cfg.d_model
    g = torch.Generator(device=dev).manual_seed(1)
    x_all = torch.randn(B, S, d, generator=g, device=dev).to(torch.bfloat16)
    di, mi = mesh.axis_index("data"), mesh.axis_index("model")
    x = x_all[di * (B // data):(di + 1) * (B // data)]
    tag = f"[multicard] (a) data={data} model={model} rank {mesh.rank}"

    ep = mc_layer(cfg, dev).shard(mesh)
    ctx = ShardingCtx({}, mesh)
    xs = x.clone().requires_grad_()
    kernels.reset_launch_counts()
    log_ = mesh.reset_log()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = ep(xs, ctx=ctx)
    scattered = out.shape[1] != S
    fwd_bytes = dict(log_.bytes)
    ((out.float() ** 2).sum() * (1.0 if scattered else 1.0 / model)
     ).backward()
    torch.cuda.synchronize(dev)
    ep_s = time.perf_counter() - t0
    launches = kernels.launch_counts()["grouped_matmul"]
    all_bytes, staged = dict(log_.bytes), dict(log_.staged)
    T = x.shape[0] * S
    cap = capacity(T, cfg.num_experts_per_token, cfg.num_experts, MC_CF)
    buf = (ep.e_loc, padded_capacity(cap), d)
    if launches != 4:
        raise SmokeFailure(f"{tag}: {launches} grouped launches, expected "
                           f"2 forward + 2 input-gradient")

    # The one-process layer on each data shard's tokens (capacity is
    # local to a shard): this rank's output and dx, and every shard's
    # gradients, whose sum the sharded layer's must equal.
    ref = mc_layer(cfg, dev)
    shard_grads = []
    for j in range(data):
        xr = x_all[j * (B // data):(j + 1) * (B // data)].clone() \
            .requires_grad_()
        ref.zero_grad(set_to_none=True)
        out_j = ref(xr)
        (out_j.float() ** 2).sum().backward()
        shard_grads.append({k: p.grad for k, p in ref.named_parameters()})
        if j == di:
            ref_out, ref_dx = out_j.detach(), xr.grad
    ref_grads = {k: sum(g[k] for g in shard_grads) for k in shard_grads[0]}
    seq = S // model if scattered else S
    want = ref_out[:, mi * seq:(mi + 1) * seq] if scattered else ref_out
    dlo = di * (d // data)
    sl = slice(ep.e0, ep.e0 + ep.e_loc)
    stages_out = model + 1
    stages_bwd = 2 * MC_MOE_ROUNDINGS + 2 * (model + 1) + data
    ratios = {
        "out": mc_ratio(out, want, stages_out),
        "dx": mc_ratio(xs.grad, ref_dx, stages_bwd),
        "router": mc_ratio(ep.router.grad, ref_grads["router"], stages_bwd),
        "w_gate_up": mc_ratio(ep.w_gate_up.grad, ref_grads["w_gate_up"][
            sl, dlo:dlo + d // data], stages_bwd),
        "w_down": mc_ratio(ep.w_down.grad, ref_grads["w_down"][
            sl, :, dlo:dlo + d // data], stages_bwd)}
    bad = {k: v for k, v in ratios.items() if v > 1}
    if bad:
        raise SmokeFailure(f"{tag}: against the one-process layer, err / "
                           f"bound {bad}")
    exact_out = float((out.detach().float() - want.detach().float()).abs()
                      .max())

    # Planted faults, forward only: each must break the output's bound.
    faults = {}
    with torch.no_grad():
        if model > 1:
            real = comm.psum_scatter

            def no_sum(t, axis, *, scatter_dimension, tiled, mesh):
                n = t.shape[scatter_dimension] // mesh.axis_size(axis)
                return t.narrow(scatter_dimension,
                                mesh.axis_index(axis) * n, n)
            comm.psum_scatter = no_sum
            try:
                faults["psum_scatter left out"] = mc_ratio(
                    ep(x, ctx=ctx), want, stages_out)
            finally:
                comm.psum_scatter = real
        e0 = ep.e0
        ep.e0 = (e0 + ep.e_loc) % ep.num_experts if model > 1 else \
            ep.e_loc // 2
        try:
            faults["wrong e0"] = mc_ratio(ep(x, ctx=ctx), want, stages_out)
        finally:
            ep.e0 = e0
    missed = {k: v for k, v in faults.items() if v <= 1}
    if missed:
        raise SmokeFailure(f"{tag}: planted faults passed the check "
                           f"{missed}")
    lines.append(
        f"{tag}: x {tuple(x.shape)} bf16, buffer {buf} (C {cap}, padded "
        f"{buf[1]}), output {tuple(out.shape)} "
        f"({'psum_scatter' if scattered else 'psum'}), "
        f"{launches} grouped launches (2 forward + 2 input-gradient); "
        f"forward bytes {fwd_bytes}, forward + backward {all_bytes}, "
        f"staged through the host {staged}; forward + backward "
        f"{ep_s * 1e3:.1f} ms wall; err / bound {ratios} (max |out - "
        f"one-process| {exact_out:.3e}); faults err / bound {faults}")
    del ep, ref, xs, xr, out, ref_out, ref_grads
    return {"mesh": shape, "launches": launches, "buffer": buf,
            "capacity": cap, "forward_bytes": fwd_bytes,
            "bytes": all_bytes, "staged": staged, "ratios": ratios,
            "faults": faults, "seconds": ep_s,
            "shard_grads": shard_grads if data > 1 else None,
            "mesh_obj": mesh}


def mc_compress(mesh, shard_grads: list, lines: list) -> dict:
    """(c) ``compressed_psum`` over ``"data"`` of one layer's gradient
    tree, this rank's shard's (``shard_grads[i]``: data shard ``i``'s
    gradients, all computed on every rank by (a)).  The mean must be the
    reference's formula ``sum_i q_i * max_i s_i / n`` of every shard's
    ``q_i`` and scale ``s_i`` bit for bit, and within ``sum_i (|q_i|
    (s_max - s_i) + s_i / 2) / n`` of the exact mean (half a quantum when
    the scales agree); ``q * scale + residual`` must give ``g + residual``
    back."""
    import torch
    from repro_torch.optim.compression import compress_grad, compressed_psum
    n, di = mesh.shape["data"], mesh.axis_index("data")
    worst = {"bound": 0.0, "half_quantum": 0.0, "identity": 0.0}
    wire: dict = {}
    for name, g in shard_grads[di].items():
        res = torch.zeros_like(g, dtype=torch.float32)
        log_ = mesh.reset_log()
        mean, new_res = compressed_psum(g, res, "data", mesh=mesh)
        for k, v in log_.bytes.items():
            wire[k] = wire.get(k, 0.0) + v
        with torch.no_grad():
            parts = [compress_grad(sg[name], res) for sg in shard_grads]
            s_max = max(sc for _, sc, _ in parts)
            q_sum = sum(q.to(torch.int32) for q, _, _ in parts)
            formula = q_sum.float() * s_max / n
            if not torch.equal(mean.float(), formula):
                raise SmokeFailure(f"[multicard] (c) {name}: the mean is not "
                                   f"sum_i q_i * s_max / n")
            exact = sum(sg[name].float() for sg in shard_grads) / n
            bound = sum(q.float().abs() * (s_max - sc) + sc / 2
                        for q, sc, _ in parts) / n
            err = (mean.float() - exact).abs()
            q, scale, _ = parts[di]
            corrected = g.float() + res
            back = q.float() * scale + new_res
            ident = float(((back - corrected).abs()
                           / corrected.abs().clamp_min(1e-30)).max())
        worst["bound"] = max(worst["bound"], float((err / bound).max()))
        worst["half_quantum"] = max(worst["half_quantum"],
                                    float(err.max() / (s_max / 2)))
        worst["identity"] = max(worst["identity"], ident)
    if worst["bound"] > 1 + 1e-5 or worst["identity"] > 2 ** -23:
        raise SmokeFailure(f"[multicard] (c) compressed_psum: {worst}")
    lines.append(
        f"[multicard] (c) rank {mesh.rank}: compressed_psum over data={n} "
        f"of {len(shard_grads[di])} gradient leaves: the mean is sum_i q_i "
        f"* s_max / n bit for bit; |mean - exact| / derived bound (half a "
        f"quantum when the ranks' scales agree) {worst['bound']:.4f}, / "
        f"half of the largest quantum {worst['half_quantum']:.4f}; q * "
        f"scale + residual == g + residual within {worst['identity']:.2e} "
        f"relative; compressed_psum's bytes {wire} (int8 values summed in "
        f"int32 lanes, as the reference)")
    return {**worst, "bytes": wire}


def mc_pipeline(dev, backend, quick: bool, lines: list) -> dict:
    """(b) olmoe-1b-7b's first layers as a 2-stage GPipe pipeline against
    the sequential stack on one process, outputs and gradients; a planted
    fault (the hops' permutation reversed)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.model import ROUNDINGS_PER_LAYER, make_block
    from repro_torch.train import pipeline
    mesh = make_process_mesh((MC_WORLD,), ("stage",), device=dev,
                             backend=backend)
    cfg = get_config(MC_ARCH)
    layers = MC_PIPE_LAYERS_QUICK if quick else MC_PIPE_LAYERS
    S, sid = mesh.shape["stage"], mesh.axis_index("stage")
    per = layers // S
    seq = (MC_TOKENS_QUICK if quick else MC_TOKENS)[1]
    d = cfg.d_model
    g = torch.Generator(device=dev).manual_seed(2)
    kw = dict(dtype=torch.float32, device=dev, generator=g, trainable=True)
    blocks = [make_block(cfg, "global", **kw) for _ in range(layers)]
    positions = torch.arange(seq, device=dev)[None]

    def run(stack, rows):
        h = rows.reshape(1, seq, d)
        for blk in stack:
            h = blk(h, positions)
        return h.reshape(seq, d)

    mine = blocks[sid * per:(sid + 1) * per]
    gx = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(MC_PIPE_MICRO, seq, d, generator=gx,
                    device=dev).to(torch.bfloat16)
    kernels.reset_launch_counts()
    log_ = mesh.reset_log()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = pipeline.pipeline_apply(lambda _, r: run(mine, r), None, x,
                                  mesh=mesh)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    ((out.float() ** 2).sum() / S).backward()
    torch.cuda.synchronize(dev)
    pipe_s = (t1 - t0, time.perf_counter() - t1)
    launches = kernels.launch_counts()["grouped_matmul"]
    bytes_ = dict(log_.bytes)
    got = {k: p.grad.clone() for b in mine for k, p in b.named_parameters()}
    for b in blocks:
        b.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    ref = torch.stack([run(blocks, x[m]) for m in range(MC_PIPE_MICRO)])
    (ref.float() ** 2).sum().backward()
    torch.cuda.synchronize(dev)
    seq_s = time.perf_counter() - t0
    want = {k: p.grad for b in mine for k, p in b.named_parameters()}
    stages = ROUNDINGS_PER_LAYER * layers
    ratios = {"out": mc_ratio(out, ref, stages),
              "grads": max(mc_ratio(got[k], want[k], 2 * stages)
                           for k in got)}
    if max(ratios.values()) > 1:
        raise SmokeFailure(f"[multicard] (b) stage {sid}: against the "
                           f"sequential stack, err / bound {ratios}")
    expect = MC_PIPE_MICRO * per * 4     # 2 forward + 2 dx per MoE layer
    if launches != expect:
        raise SmokeFailure(f"[multicard] (b) stage {sid}: {launches} "
                           f"grouped launches, expected {expect}")
    real = pipeline.stage_perm
    pipeline.stage_perm = lambda n: [(b, a) for a, b in real(n)]
    try:
        with torch.no_grad():
            fault = mc_ratio(pipeline.pipeline_apply(
                lambda _, r: run(mine, r), None, x, mesh=mesh), ref, stages)
    finally:
        pipeline.stage_perm = real
    if fault <= 1:
        raise SmokeFailure(f"[multicard] (b) stage {sid}: the reversed "
                           f"perm passed (err / bound {fault:.3f})")
    T = MC_PIPE_MICRO + S - 1
    lines.append(
        f"[multicard] (b) stage {sid} of {S}: layers {sid * per}-"
        f"{(sid + 1) * per - 1}, {MC_PIPE_MICRO} microbatches of 1 x {seq}, "
        f"T = {T} ticks, bubble {(S - 1) / T:.3f}; {launches} grouped "
        f"launches; bytes {bytes_}; forward {pipe_s[0] * 1e3:.1f} + "
        f"backward {pipe_s[1] * 1e3:.1f} ms wall (the first on this "
        f"process: cold), the sequential stack after it "
        f"{seq_s * 1e3:.1f} ms; err / bound {ratios}; reversed perm err / "
        f"bound {fault:.3g}")
    del blocks, mine, out, ref, got, want
    return {"launches": launches, "ratios": ratios, "fault": fault,
            "ticks": T, "bubble": (S - 1) / T, "bytes": bytes_,
            "seconds": pipe_s, "sequential_seconds": seq_s}


def mc_shard(dev, backend, quick: bool, lines: list) -> dict:
    """(d) The sharded tier on a ``(shard=2)`` mesh: C against the
    in-process ``ShardedPlan`` and the unsharded plan per strategy, kernel
    launches per rank."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.precision import as_precision
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import ShardMesh, make_process_mesh
    from repro_torch.sparse import stream
    from repro_torch.sparse.dispatch import Dispatcher
    from repro_torch.sparse.shard import B_STRATEGIES
    mesh = make_process_mesh((MC_WORLD,), ("shard",), device=dev,
                             backend=backend)
    rows, launches = [], dict.fromkeys(kernels.KERNEL_MODULES, 0)
    # Rank 0 holds C against the unsharded plan, the last rank against
    # the in-process ShardedPlan (every rank gathers the same C).
    first, last = mesh.rank == 0, mesh.rank == mesh.size - 1
    for structure, log_n in MC_SHARD_RUNS:
        n = MC_SHARD_N_QUICK if quick else 2 ** log_n
        t_start = time.perf_counter()
        m = serve.build_stream_matrix(structure, n)
        disp = Dispatcher(device=dev, calibration=False, tree=False)
        spec = stream.BSpec(d=D, reuse=STEPS)
        b = torch.from_numpy(np.random.default_rng(11).normal(
            size=(n, D)).astype("float32")).to(dev)
        single = stream.plan(m, spec, dispatcher=disp)
        want = single.execute(b) if first else None
        absprod = abs_product(m, b)
        eps = as_precision(single.precision).eps
        in_mesh = ShardMesh([dev] * MC_WORLD)
        for strat in B_STRATEGIES:
            what = f"{structure}/{strat}"
            try:
                p = stream.plan(m, spec, mesh=mesh, b_strategy=strat,
                                dispatcher=disp)
            except ValueError as e:
                if single.chosen == "dia" and strat == "all_gather":
                    lines.append(f"[multicard] (d) {what}: ineligible ({e})")
                    continue
                raise
            kernels.reset_launch_counts()
            log_ = mesh.reset_log()
            block = p.execute(b)
            torch.cuda.synchronize(dev)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            wire = dict(log_.bytes)
            c = p.gather_c(block)
            kernel = {"csr": "csr_spmm", "ell": "csr_spmm",
                      "ell_coo": "csr_spmm", "binned": "csr_spmm",
                      "rowsplit": "csr_spmm", "bcsr": "bcsr_spmm",
                      "dia": "banded_spmm"}[p.chosen]
            has_shard = p.shard_layouts[0] is not None
            if has_shard and counts.get(kernel, 0) != 1:
                raise SmokeFailure(f"[multicard] (d) {what} rank "
                                   f"{mesh.rank}: launches {counts}, "
                                   f"expected one {kernel}")
            for k, v in counts.items():
                launches[k] += v
            checked, err = [], None
            if first:
                err, _ = check_close(f"multicard {what} vs unsharded",
                                     c, want, absprod, eps)
                checked.append(f"max |C - unsharded| {err:.3e}")
            if last:
                inproc = stream.plan(m, spec, mesh=in_mesh,
                                     b_strategy=strat, dispatcher=disp)
                err, _ = check_close(f"multicard {what} vs in-process",
                                     c, inproc.execute(b), absprod, eps)
                checked.append(f"max |C - in-process ShardedPlan| "
                               f"{err:.3e}")
                del inproc
            t0 = time.perf_counter()
            for _ in range(3):
                p.execute(b)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3 / 3
            lines.append(
                f"[multicard] (d) {what} n={n} rank {mesh.rank}: {p.chosen}, "
                f"partition {p.partition}, rows {p.c_rows}, shard nnz "
                f"{list(map(int, p.shard_nnz))}; launches {counts}; bytes "
                f"{wire}; {', '.join(checked)} within bound; {ms:.2f} ms per "
                f"request (host clock, mean of 3)")
            rows.append({"structure": structure, "format": p.chosen,
                         "b_strategy": strat, "launches": counts,
                         "bytes": wire, "ms": ms, "max_abs_err": err})
            del p, block, c
        del single, want, absprod, b, m, disp
        torch.cuda.empty_cache()
        lines.append(f"[multicard] (d) {structure} rank {mesh.rank}: "
                     f"{time.perf_counter() - t_start:.1f} s (build, plans, "
                     f"checks)")
    return {"rows": rows, "launches": launches}


#: (e) the partitioned steps: olmoe-1b-7b at full width, 2 of 16 layers,
#: batch 4 x 512 (``--quick``: 1 layer, 2 x 128), fp32 masters and bf16
#: compute; the train step on ``(data=1, model=2)`` at steps 1 and 2 of
#: ``[train]``'s schedule, the prefill on ``(data=2, model=1)`` at 1
#: layer.
MC_GSPMD_LAYERS, MC_GSPMD_LAYERS_QUICK = 2, 1
MC_GSPMD_STEPS = (1, 2)


class ReplayRouting:
    """Records each ``models.moe.router`` call's top-k ids while active;
    with ``replay`` (another run's ids, in call order), each call takes
    the replayed ids instead of its own and weights them by its own
    probabilities, so that two runs differ only by their roundings (its
    router's gradient stays its own).  ``flips`` counts the calls' rows
    whose own ids differed from the replayed ones."""

    def __init__(self, replay: Optional[list] = None):
        self.replay, self.ids, self.flips, self.rows = replay, [], 0, 0

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._orig = moe.router

        def router(x, kernel, k):
            weights, ids = self._orig(x, kernel, k)
            if self.replay is not None:
                want = self.replay[len(self.ids)]
                same = (ids.sort(dim=1).values ==
                        want.sort(dim=1).values).all(dim=1)
                self.flips += int((~same).sum())
                self.rows += ids.shape[0]
                probs = torch.softmax(x.float() @ kernel.float(), dim=-1)
                weights = torch.gather(probs, 1, want)
                weights = weights / torch.clamp(
                    weights.sum(dim=-1, keepdim=True), min=1e-9)
                ids = want
            self.ids.append(ids.detach())
            return weights, ids
        moe.router = router
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.router = self._orig


def mc_roundings(cfg, tp: int) -> int:
    """Roundings to bf16 between the inputs and the logits of the
    partitioned forward against one process's: the model's own
    (``models.model.roundings``) and, at each row-parallel exit, each
    rank's partial sum rounded before the sum (``tp`` more).  The exits
    per layer of each kind are its sublayers
    (``core.collectives.SUBLAYERS``), plus mamba's ``x_proj``, whisper's
    cross-attention in each decoder layer and two per encoder layer."""
    from repro_torch.core.collectives import SUBLAYERS
    from repro_torch.models.model import layer_kinds, roundings
    exits = sum(SUBLAYERS[k] + (k == "ssm") for k in layer_kinds(cfg))
    if cfg.family == "encdec":
        exits += cfg.num_layers + 2 * cfg.encoder_layers
    return roundings(cfg) + exits * tp


def mc_gspmd_train(dev, backend, quick: bool, lines: list) -> dict:
    """(e1) The partitioned train step on ``(data=1, model=2)`` against the
    one-process step on the same card, from the same seed: first the
    one-process model runs its forward and steps 1 and 2, recording its
    routing, loss, ``grad_norm``, and this rank's blocks of its gradients
    and parameters after each step (kept on the host); it is freed, and
    the partitioned model runs the same, replaying that routing (so that
    the two differ only by their roundings; the rows where its own
    router would have chosen otherwise are counted).  Bounds
    (``models.model.rounding_tolerance`` over ``mc_roundings`` stages):
    the logits over those stages at each row's scale; the loss within
    twice the bound of a logit at the largest row rms (a token's loss
    moves by at most twice its logits' largest move); the gradient blocks
    over twice the stages (forward and backward) at the scale of each
    matrix (an expert's, or the leaf's: a row of a weight's gradient can
    be exactly 0 in one run and not the other, where an expert's few
    tokens have an input feature that rounds to 0 in one run only),
    ``grad_norm`` likewise at its own scale; the parameter blocks within
    what two AdamW steps can move an element apart, ``2 * lr *
    sum(lr_scale) * (1 + wd * |p|)``.  Faults on the forward: the
    row-parallel outputs left unsummed (the logits' bound) and the
    vocab-parallel logsumexp without its ``psum`` (the loss's bound)."""
    import dataclasses
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.core.collectives import step_collectives
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import abstract_mesh, make_process_mesh
    from repro_torch.models.model import (LM, init_params, layer_kinds,
                                          rounding_tolerance)
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(
        get_config(MC_ARCH),
        num_layers=MC_GSPMD_LAYERS_QUICK if quick else MC_GSPMD_LAYERS)
    B, S = MC_TOKENS_QUICK if quick else MC_TOKENS
    shape = ShapeConfig("mc-train", S, B, "train")
    mesh = make_process_mesh((1, 2), ("data", "model"), device=dev,
                             backend=backend)
    tp, mi = 2, mesh.axis_index("model")
    tag = f"[multicard] (e1) rank {mesh.rank}"
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR)
    pipe = Pipeline(cfg, shape, DataConfig(seed=0))
    batches = {s: {k: torch.from_numpy(v).to(dev) for k, v in
                   pipe.batch_for_step(s).items()} for s in MC_GSPMD_STEPS}
    first = batches[MC_GSPMD_STEPS[0]]
    stages = mc_roundings(cfg, tp)
    specs = TS.step_specs(cfg, shape, mesh)["params"]
    eps32 = float(torch.finfo(torch.float32).eps)

    def seeded():
        g = torch.Generator(device=dev).manual_seed(0)
        return init_params(cfg, device=dev, generator=g, masters=True)

    def host_blocks(named):
        """This rank's blocks of whole leaves, copied to the host (the next
        step updates the parameters in place)."""
        return {n: SH.local_block(t.detach(), specs[n], mesh).to(
            "cpu", copy=True) for n, t in named.items()}

    grads = {}
    apply = adamw.apply_updates

    def recording(params, g, state, cfg_, lr_scale=1.0, **kw):
        grads["last"] = {n: t.detach() for n, t in g.items()}
        return apply(params, g, state, cfg_, lr_scale, **kw)

    # The one-process model: its forward, then steps 1 and 2.
    one = seeded()
    step_one = TS.make_train_step(cfg, shape, opt_cfg=opt_cfg,
                                  schedule_kwargs=TRAIN_SCHEDULE)
    opt_one = adamw.init_state(dict(one.named_parameters()), opt_cfg)
    with torch.no_grad(), ReplayRouting() as fwd_routes:
        logits = one(first["tokens"])
    v = logits.shape[-1] // tp
    want_logits = logits[..., mi * v:(mi + 1) * v].clone()
    rms = logits.pow(2).mean(dim=-1).sqrt().max()
    want_loss = float(TS.softmax_xent(logits, first["labels"],
                                      cfg.vocab_size))
    loss_bound = 2 * float(rounding_tolerance(stages, rms, 1))
    del logits
    ref_steps = []
    adamw.apply_updates = recording
    try:
        for s in MC_GSPMD_STEPS:
            with ReplayRouting() as routes:
                m = step_one(one, opt_one, batches[s], s)
            ref_steps.append({
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "lr_scale": float(m["lr_scale"]), "routes": routes.ids,
                "grads": host_blocks(grads.pop("last")),
                "params": host_blocks(dict(one.named_parameters()))})
    finally:
        adamw.apply_updates = apply
    del one, opt_one
    gc.collect()
    torch.cuda.empty_cache()

    # The partitioned model: the same forward, the two faults, the steps.
    part = seeded().shard(mesh)
    if part.param_specs != specs:
        raise SmokeFailure(f"{tag}: LM.shard's specs differ from the step's")
    ctx = TS.make_ctx(cfg, mesh, shape)
    local = SH.batch_shard(first, cfg, mesh, shape)

    def forward(fault=None):
        with torch.no_grad(), ReplayRouting(fwd_routes.ids):
            real = comm.psum_scatter, comm.psum
            if fault == "row-parallel unsummed":
                def no_sum(t, axis, *, scatter_dimension, tiled, mesh):
                    n = t.shape[scatter_dimension] // mesh.axis_size(axis)
                    return t.narrow(scatter_dimension,
                                    mesh.axis_index(axis) * n, n)
                comm.psum_scatter = no_sum
            try:
                logits = part(local["tokens"], ctx=ctx, remat=False)
                if fault == "logsumexp without psum":
                    comm.psum = lambda x, axis, *, mesh=None: x
                share = TS._mesh_loss(cfg, logits, local["labels"], ctx)
            finally:
                comm.psum_scatter, comm.psum = real
            loss = float(comm.psum(share, mesh.axis_names, mesh=mesh))
        return logits, abs(loss - want_loss) / loss_bound

    logits, loss_ratio = forward()
    logit_ratio = mc_ratio(logits, want_logits, stages)
    faults = {"row-parallel unsummed": mc_ratio(
        forward("row-parallel unsummed")[0], want_logits, stages),
        "logsumexp without psum": forward("logsumexp without psum")[1]}
    del logits, want_logits
    if logit_ratio > 1 or loss_ratio > 1:
        raise SmokeFailure(f"{tag}: forward against one process: logits "
                           f"err / bound {logit_ratio:.3f}, loss "
                           f"{loss_ratio:.3f}")
    missed = {k: r for k, r in faults.items() if r <= 1}
    if missed:
        raise SmokeFailure(f"{tag}: planted faults passed {missed}")

    step_part, _ = TS.make_train_step(cfg, shape, mesh, opt_cfg=opt_cfg,
                                      schedule_kwargs=TRAIN_SCHEDULE)
    opt_part = adamw.init_state(dict(part.named_parameters()), opt_cfg)
    rows, launches, step_ms, lr_sum = [], 0, [], 0.0
    log_ = mesh.reset_log()
    adamw.apply_updates = recording
    try:
        for s, ref in zip(MC_GSPMD_STEPS, ref_steps):
            kernels.reset_launch_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with ReplayRouting(ref["routes"]) as replay:
                m = step_part(part, opt_part,
                              SH.batch_shard(batches[s], cfg, mesh, shape), s)
            loss = float(m["loss"])
            torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches += kernels.launch_counts()["grouped_matmul"]
            got = grads.pop("last")
            worst_g = max((mc_ratio(g, ref["grads"][n].to(dev),
                                    2 * stages, dims=(-2, -1)), n)
                          for n, g in got.items())
            del got
            lr_sum += ref["lr_scale"]
            moved = 2 * TRAIN_LR * lr_sum
            worst_p = 0.0
            for n, p in part.named_parameters():
                want = ref["params"][n].to(dev)
                allowed = moved * (1 + opt_cfg.weight_decay * want.abs()) \
                    + 8 * eps32 * want.abs()
                worst_p = max(worst_p, float(((p.detach() - want).abs() /
                                              allowed).max()))
            gn = float(m["grad_norm"])
            row = {"step": s, "loss": (ref["loss"], loss),
                   "loss_ratio": abs(loss - ref["loss"]) / loss_bound,
                   "grad_norm": (ref["grad_norm"], gn),
                   "grad_norm_ratio": abs(gn - ref["grad_norm"]) / float(
                       rounding_tolerance(2 * stages, ref["grad_norm"], 1)),
                   "grads": worst_g, "params": worst_p,
                   "flips": replay.flips, "rows": replay.rows}
            rows.append(row)
            if max(row["loss_ratio"], row["grad_norm_ratio"],
                   row["grads"][0], row["params"]) > 1:
                raise SmokeFailure(f"{tag}: step {s} against one process: "
                                   f"{row}")
    finally:
        adamw.apply_updates = apply
    planned = part.grouped_launches_per_step(train=True) * \
        len(MC_GSPMD_STEPS) if dev.type == "cuda" else 0
    if launches != planned:
        raise SmokeFailure(f"{tag}: {launches} grouped launches, planned "
                           f"{planned}")
    counted = {k: v for k, v in log_.bytes.items() if v}
    named = dict(LM(cfg, device="meta", masters=True).named_parameters())
    am = abstract_mesh((1, 2), ("data", "model"))
    modelled = step_collectives(
        cfg, shape, am, params={n: (tuple(p.shape), 4)
                                for n, p in named.items()},
        specs=SH.param_pspecs(cfg, named, am),
        constraints=[("tokens_bse", (B, S, cfg.d_model), "bfloat16",
                      ("data", "model")),
                     ("logits_bsv", (B, S, cfg.padded_vocab), "float32",
                      ("data", "model"))],
        kinds=layer_kinds(cfg), compute_itemsize=2).summary()[0]
    modelled = {k: v * len(MC_GSPMD_STEPS) for k, v in modelled.items()
                if v}
    ratio = sum(counted.values()) / modelled["total"]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0
    lines.append(
        f"{tag}: olmoe-1b-7b {cfg.num_layers} layers at full width, batch "
        f"{B} x {S}, {part.layers[0].moe.e_loc} experts per rank; forward "
        f"logits err / bound {logit_ratio:.3f}, loss {loss_ratio:.3f} "
        f"(bound {loss_bound:.3e}); faults err / bound "
        + ", ".join(f"{k} {v:.1f}" for k, v in faults.items())
        + "; steps " + "; ".join(
            f"{r['step']}: loss {r['loss'][1]:.6f} vs {r['loss'][0]:.6f} "
            f"({r['loss_ratio']:.3f}), grad_norm {r['grad_norm'][1]:.5f} vs "
            f"{r['grad_norm'][0]:.5f} ({r['grad_norm_ratio']:.3f}), grads "
            f"{r['grads'][0]:.3f} ({r['grads'][1]}), params "
            f"{r['params']:.3f}, own router differs on {r['flips']} of "
            f"{r['rows']} rows" for r in rows)
        + f"; grouped launches {launches} = planned {planned}; step ms "
        f"{', '.join(f'{t:.1f}' for t in step_ms)} ({mesh.backend}"
        + (", host staging: not a link rate" if mesh.stages_through_host
           else "")
        + f"); collective bytes per kind "
        f"{dict((k, int(v)) for k, v in counted.items())} vs the dry run's "
        f"step_collectives "
        f"{dict((k, int(v)) for k, v in modelled.items())}, ratio "
        f"{ratio:.3f}; staged through the host "
        f"{dict((k, int(v)) for k, v in log_.staged.items() if v)}; peak "
        f"{peak:.2f} GB allocated")
    out = {"launches": launches, "planned": planned, "steps": rows,
           "logit_ratio": logit_ratio, "loss_ratio": loss_ratio,
           "faults": faults, "step_ms": step_ms, "bytes": counted,
           "modelled_bytes": modelled, "bytes_ratio": ratio,
           "peak_gb": peak}
    del part, opt_part, ref_steps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mc_gspmd_prefill(dev, backend, quick: bool, lines: list) -> dict:
    """(e2) The partitioned prefill on ``(data=2, model=1)`` (FSDP, 1
    layer, bf16 weights) against the one-process forward on this data
    shard's rows: bit for bit (the gather rebuilds the weights exactly).
    Fault: the FSDP blocks gathered in reversed order (its err over the
    logits' rounding bound is printed; any difference fails)."""
    import dataclasses
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models.model import init_params
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(get_config(MC_ARCH), num_layers=1)
    B, S = MC_TOKENS_QUICK if quick else MC_TOKENS
    shape = ShapeConfig("mc-prefill", S, B, "prefill")
    mesh = make_process_mesh((2, 1), ("data", "model"), device=dev,
                             backend=backend)
    tag = f"[multicard] (e2) rank {mesh.rank}"
    tokens = torch.from_numpy(Pipeline(cfg, shape, DataConfig(seed=0))
                              .batch_for_step(0)["tokens"]).to(dev)
    local = SH.batch_shard({"tokens": tokens}, cfg, mesh, shape)

    def seeded():
        g = torch.Generator(device=dev).manual_seed(0)
        return init_params(cfg, device=dev, generator=g)

    with torch.no_grad():
        want = seeded()(local["tokens"], remat=False)
    part = seeded().shard(mesh)
    fn, specs = TS.make_prefill_step(cfg, shape, mesh)
    kernels.reset_launch_counts()
    log_ = mesh.reset_log()
    got = fn(part, local)
    launches = kernels.launch_counts()["grouped_matmul"]
    counted = dict(log_.bytes)
    real = comm.all_gather

    def reversed_blocks(x, axis, *, dim=0, tiled=False, mesh=None):
        y = real(x, axis, dim=dim, tiled=tiled, mesh=mesh)
        if axis != "data":
            return y
        return torch.cat(y.chunk(mesh.axis_size(axis), dim=dim)[::-1],
                         dim=dim)
    comm.all_gather = reversed_blocks
    try:
        bad = fn(part, local)
    finally:
        comm.all_gather = real
    exact = bool(torch.equal(got, want))
    fault_equal = bool(torch.equal(bad, want))
    fault_ratio = mc_ratio(bad, want, mc_roundings(cfg, 1))
    planned = part.grouped_launches_per_step() if dev.type == "cuda" else 0
    if not exact:
        raise SmokeFailure(f"{tag}: the partitioned prefill differs from one "
                           f"process: max |err| "
                           f"{float((got - want).abs().max()):.3e}")
    if fault_equal:
        raise SmokeFailure(f"{tag}: the reversed FSDP gather passed")
    if launches != planned:
        raise SmokeFailure(f"{tag}: {launches} grouped launches, planned "
                           f"{planned}")
    lines.append(
        f"{tag}: olmoe-1b-7b 1 layer at full width, bf16, rows "
        f"{tuple(local['tokens'].shape)} of {tuple(tokens.shape)}; logits "
        f"{tuple(got.shape)} (spec {specs['logits']}) equal the one-process "
        f"forward bit for bit; reversed FSDP gather: err / rounding bound "
        f"{fault_ratio:.1f}; grouped launches {launches} = planned "
        f"{planned}; collective bytes "
        f"{dict((k, int(v)) for k, v in counted.items())}")
    out = {"launches": launches, "planned": planned, "exact": exact,
           "fault_ratio": fault_ratio, "bytes": counted}
    del part, got, bad, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: (e3)-(e6) the partitioned train steps of the other families on
#: ``(data=1, model=2)``, fp32 masters and bf16 compute, steps 1 and 2 of
#: ``[train]``'s schedule: each case's key, arch, depth (the widths stay
#: full), batch x sequence and planted fault.  (e3): recurrentgemma-9b's
#: first three layers, whose 2048-slot window is narrower than the 4096
#: tokens; (e4): falcon-mamba-7b at 2 of 64 layers, two 256-step chunks;
#: (e5): whisper-base whole (6 + 6 layers, 1,500 frames), then its cross
#: cache primed over the mesh and ``MC_FAMILY_SERVE_STEPS`` serve steps;
#: (e6): qwen2-vl-7b at 2 of 28 layers, on the pipeline's ``mm_embeds``
#: and ``positions_3d``.  ``--quick``: 1 layer (whisper: 1 + 1;
#: recurrentgemma: an RG-LRU layer) and 256 tokens.
MC_FAMILY_CASES = (
    ("e3", "recurrentgemma-9b",
     {"num_layers": 3, "layer_pattern": ("rglru", "rglru", "local")},
     (1, 4096), "conv block from the other rank"),
    ("e4", "falcon-mamba-7b", {"num_layers": 2}, (2, 512),
     "x_proj unsummed"),
    ("e5", "whisper-base", {}, (4, 448), "encoder cotangent unsummed"),
    ("e6", "qwen2-vl-7b", {"num_layers": 2}, (2, 512),
     "1-D RoPE for M-RoPE"),
)
MC_FAMILY_SERVE_STEPS = 4


def mc_fault(name: str):
    """The planted fault ``name`` of (e3)-(e6): ``(module, attribute,
    replacement, where)``; ``where`` is ``"forward"`` where the fault
    moves the logits, ``"backward"`` where only the gradients."""
    import torch
    from repro_torch.core import comm
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import rglru as R
    if name == "conv block from the other rank":
        real = L.mesh_param

        def other_rank(module, attr, ctx, dtype=None, keep=("model",)):
            w = real(module, attr, ctx, dtype, keep)
            if attr != "conv_w" or not isinstance(module, R.RGLRU):
                return w
            n = ctx.process_mesh.shape["model"]
            return comm.ppermute(w, "model",
                                 [(i, (i + 1) % n) for i in range(n)],
                                 mesh=ctx.process_mesh)
        return L, "mesh_param", other_rank, "forward"
    if name == "x_proj unsummed":
        # In a forward whose exits are reduce-scatters, x_proj's partial
        # sums are the only psum.
        return comm, "psum", lambda x, axis, *, mesh=None: x, "forward"
    if name == "1-D RoPE for M-RoPE":
        rope = L.apply_rope
        return L, "apply_mrope", (lambda x, pos, theta:
                                  rope(x, pos[0], theta)), "forward"

    class Unsummed(torch.autograd.Function):
        """The gather of the encoder's output whose backward keeps this
        rank's own share of its block (no sum over ``"model"``)."""

        @staticmethod
        def forward(ctx_, h, mesh):
            ctx_.mesh, ctx_.n = mesh, h.shape[1]
            with torch.no_grad():
                return comm.all_gather(h, "model", dim=1, tiled=True,
                                       mesh=mesh)

        @staticmethod
        def backward(ctx_, g):
            i = ctx_.mesh.axis_index("model")
            return g[:, i * ctx_.n:(i + 1) * ctx_.n], None

    def unsummed(h, ctx):
        return Unsummed.apply(h, ctx.process_mesh)
    return M, "gather_encoder_output", unsummed, "backward"


def mc_family_case(key: str, arch: str, overrides: dict, tokens: tuple,
                   fault: str, dev, backend, quick: bool,
                   lines: list) -> dict:
    """One of (e3)-(e6): ``arch``'s partitioned train step on ``(data=1,
    model=2)`` against the one-process port on the same card from the
    same seed, as (e1) (``mc_gspmd_train``) holds olmoe-1b-7b's.  The two
    ranks run the one-process model in turn (rank 0, then rank 1; the
    other waits), each keeping its blocks of the logits, the gradients
    and the parameters after steps 1 and 2 on the host, and free it
    before the partitioned model is built.  Bounds
    (``models.model.rounding_tolerance`` over ``mc_roundings`` stages):
    the forward's logits block at each row's scale and the loss at the
    largest row rms (twice a logit's bound); at each step the loss, the
    gradient blocks over twice the stages at each matrix's scale,
    ``grad_norm`` at its own, the parameter blocks within two AdamW
    moves.  Step 2 starts from the one-process model's parameters after
    step 1, so that its gradients too differ only by roundings (AdamW
    moves an element whose gradient is near 0 by ``lr`` either way, and
    a recurrent layer carries such a move into every later gradient).
    The planted fault (``mc_fault``) must break the logits' bound; a
    fault of the backward alone (whisper's encoder cotangent) is held at
    fp32, where the bound is tight: the one-process and partitioned
    gradients of step 1 at fp32 within it, the fault's beyond.  (e5) then
    primes whisper's cross cache over the mesh (``LM.encode`` and
    ``LM.prime_cross_cache`` on the sharded bf16 model) and runs
    ``MC_FAMILY_SERVE_STEPS`` serve steps, against one process: the cross
    K/V blocks and each step's logits block.  No port kernel is on these
    paths: every counter must stay 0."""
    import dataclasses
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.core.collectives import step_collectives
    from repro_torch.core.device import synchronize
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import abstract_mesh, make_process_mesh
    from repro_torch.models.model import (LM, init_params, layer_kinds,
                                          rounding_tolerance)
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    t_case = time.perf_counter()
    if quick:
        overrides = {**overrides, "num_layers": 1}
        if "layer_pattern" in overrides:
            overrides["layer_pattern"] = overrides["layer_pattern"][:1]
        if arch == "whisper-base":
            overrides["encoder_layers"] = 1
        tokens = (tokens[0], 256)
    cfg = dataclasses.replace(get_config(arch), **overrides)
    B, S = tokens
    shape = ShapeConfig(f"mc-{key}", S, B, "train")
    dshape = ShapeConfig(f"mc-{key}-serve", S, B, "decode")
    mesh = make_process_mesh((1, 2), ("data", "model"), device=dev,
                             backend=backend)
    tp, mi = 2, mesh.axis_index("model")
    tag = f"[multicard] ({key}) rank {mesh.rank}"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR)
    pipe = Pipeline(cfg, shape, DataConfig(seed=0))
    batches = {s: {k: torch.from_numpy(v).to(dev) for k, v in
                   pipe.batch_for_step(s).items()} for s in MC_GSPMD_STEPS}
    first = batches[MC_GSPMD_STEPS[0]]
    stages = mc_roundings(cfg, tp)
    specs = TS.step_specs(cfg, shape, mesh)["params"]
    head = "embed.table" if cfg.tie_embeddings else "lm_head.kernel"
    vsplit = "model" in SH.spec_axes(specs[head])
    encdec = cfg.family == "encdec"
    if encdec:
        _, sspecs = TS.make_serve_step(cfg, dshape, mesh)
    eps32 = float(torch.finfo(torch.float32).eps)

    def seeded(masters=True, dtype=None):
        g = torch.Generator(device=dev).manual_seed(0)
        return init_params(cfg, device=dev, generator=g, masters=masters,
                           dtype=dtype)

    def host_blocks(named):
        return {n: SH.local_block(t.detach(), specs[n], mesh).to(
            "cpu", copy=True) for n, t in named.items()}

    def extras(batch):
        return {k: batch[k] for k in TS.MODALITY_KEYS if k in batch}

    grads = {}
    apply = adamw.apply_updates

    def recording(params, g, state, cfg_, lr_scale=1.0, **kw):
        grads["last"] = {n: t.detach() for n, t in g.items()}
        return apply(params, g, state, cfg_, lr_scale, **kw)

    # The one-process model, one rank at a time.
    ref = {}
    kernels.reset_launch_counts()
    for turn in range(tp):
        dist.barrier()
        if turn != mi:
            continue
        one = seeded()
        step_one = TS.make_train_step(cfg, shape, opt_cfg=opt_cfg,
                                      schedule_kwargs=TRAIN_SCHEDULE)
        opt_one = adamw.init_state(dict(one.named_parameters()), opt_cfg)
        with torch.no_grad():
            logits = one(first["tokens"], **extras(first))
        v = logits.shape[-1] // tp
        ref["logits"] = (logits[..., mi * v:(mi + 1) * v] if vsplit
                         else logits).to("cpu", copy=True)
        ref["rms"] = float(logits.pow(2).mean(dim=-1).sqrt().max())
        ref["loss"] = float(TS.softmax_xent(logits, first["labels"],
                                            cfg.vocab_size))
        del logits
        ref["steps"] = []
        adamw.apply_updates = recording
        try:
            for s in MC_GSPMD_STEPS:
                m = step_one(one, opt_one, batches[s], s)
                ref["steps"].append({
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "lr_scale": float(m["lr_scale"]),
                    "grads": host_blocks(grads.pop("last")),
                    "params": host_blocks(dict(one.named_parameters()))})
        finally:
            adamw.apply_updates = apply
        del one, opt_one
        if encdec:
            one = seeded(masters=False)
            serve1, _ = TS.make_serve_step(cfg, dshape)
            with torch.no_grad():
                cache = one.prime_cross_cache(one.init_cache(B, S),
                                              one.encode(first["frames"]))
                ref["cross"] = [
                    {n: SH.local_block(layer[n], spec[n], mesh).to(
                        "cpu", copy=True) for n in ("cross_k", "cross_v")}
                    for layer, spec in zip(cache, sspecs["cache"])]
                ref["serve"] = [SH.local_block(
                    serve1(one, cache, first["tokens"][:, t], t),
                    sspecs["logits"], mesh).to("cpu", copy=True)
                    for t in range(MC_FAMILY_SERVE_STEPS)]
            del one, cache
        gc.collect()
        empty_cache(dev)
    dist.barrier()
    ref_s = time.perf_counter() - t_case

    # The partitioned model: the forward, the fault, the steps.
    part = seeded().shard(mesh)
    ctx = TS.make_ctx(cfg, mesh, shape)
    local = SH.batch_shard(first, cfg, mesh, shape)
    want_logits = ref.pop("logits").to(dev)

    def forward():
        with torch.no_grad():
            return part(local["tokens"], ctx=ctx, remat=False,
                        **extras(local))

    logits = forward()
    with torch.no_grad():
        share = TS._mesh_loss(cfg, logits, local["labels"], ctx)
        loss = float(comm.psum(share, mesh.axis_names, mesh=mesh))
    logit_ratio = mc_ratio(logits, want_logits, stages)
    loss_bound = 2 * float(rounding_tolerance(stages, ref["rms"], 1))
    loss_ratio = abs(loss - ref["loss"]) / loss_bound
    del logits
    mod, attr, fn, where = mc_fault(fault)
    fp32 = {}
    if where == "forward":
        with patched(mod, attr, fn):
            fault_ratio = (mc_ratio(forward(), want_logits, stages),
                           "logits")
    else:
        # A fault in the backward alone is held at fp32, where the
        # rounding bound is tight: the one-process gradients of step 1
        # (kept on the host), then the partitioned ones, right and with
        # the fault.
        grads_fn = TS.make_grads(cfg, ctx=ctx)
        for turn in range(tp):
            dist.barrier()
            if turn == mi:
                one = seeded(dtype=torch.float32)
                _, g1 = TS.make_grads(cfg)(one, first)
                g1 = host_blocks(g1)
                del one
                gc.collect()
                empty_cache(dev)
        dist.barrier()
        part32 = seeded(dtype=torch.float32).shard(mesh)

        def worst(grads_):
            return max((mc_ratio(g, g1[n].to(dev), 2 * stages,
                                 torch.float32, dims=(-2, -1)), n)
                       for n, g in grads_.items())
        fp32["right"] = worst(grads_fn(part32, local)[1])
        with patched(mod, attr, fn):
            fault_ratio = worst(grads_fn(part32, local)[1])
        del part32, g1
        gc.collect()
        empty_cache(dev)
        if fp32["right"][0] > 1:
            raise SmokeFailure(f"{tag}: fp32 gradients against one process: "
                               f"{fp32['right']}")
    del want_logits
    if logit_ratio > 1 or loss_ratio > 1:
        raise SmokeFailure(f"{tag}: forward against one process: logits "
                           f"err / bound {logit_ratio:.3f}, loss "
                           f"{loss_ratio:.3f}")
    if fault_ratio[0] <= 1:
        raise SmokeFailure(f"{tag}: the planted fault ({fault}) passed: "
                           f"{fault_ratio}")

    step_part, _ = TS.make_train_step(cfg, shape, mesh, opt_cfg=opt_cfg,
                                      schedule_kwargs=TRAIN_SCHEDULE)
    opt_part = adamw.init_state(dict(part.named_parameters()), opt_cfg)
    rows, step_ms, lr_sum = [], [], 0.0
    log_ = mesh.reset_log()
    adamw.apply_updates = recording
    try:
        for s, want in zip(MC_GSPMD_STEPS, ref["steps"]):
            synchronize(dev)
            t0 = time.perf_counter()
            m = step_part(part, opt_part,
                          SH.batch_shard(batches[s], cfg, mesh, shape), s)
            loss = float(m["loss"])
            synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            got = grads.pop("last")
            worst_g = max((mc_ratio(g, want["grads"][n].to(dev),
                                    2 * stages, dims=(-2, -1)), n)
                          for n, g in got.items())
            del got
            lr_sum += want["lr_scale"]
            moved = 2 * TRAIN_LR * lr_sum
            worst_p = 0.0
            for n, p in part.named_parameters():
                w = want["params"][n].to(dev)
                allowed = moved * (1 + opt_cfg.weight_decay * w.abs()) \
                    + 8 * eps32 * w.abs()
                worst_p = max(worst_p, float(((p.detach() - w).abs() /
                                              allowed).max()))
            gn = float(m["grad_norm"])
            row = {"step": s, "loss": (want["loss"], loss),
                   "loss_ratio": abs(loss - want["loss"]) / loss_bound,
                   "grad_norm": (want["grad_norm"], gn),
                   "grad_norm_ratio": abs(gn - want["grad_norm"]) / float(
                       rounding_tolerance(2 * stages, want["grad_norm"],
                                          1)),
                   "grads": worst_g, "params": worst_p}
            rows.append(row)
            if max(row["loss_ratio"], row["grad_norm_ratio"],
                   row["grads"][0], row["params"]) > 1:
                raise SmokeFailure(f"{tag}: step {s} against one process: "
                                   f"{row}")
            # The next step starts from the one-process model's blocks.
            with torch.no_grad():
                for n, p in part.named_parameters():
                    p.copy_(want["params"][n])
    finally:
        adamw.apply_updates = apply
    counted = {k: int(v) for k, v in log_.bytes.items() if v}
    del part, opt_part, ref["steps"]
    gc.collect()
    empty_cache(dev)

    serve = {}
    if encdec:
        partb = seeded(masters=False).shard(mesh)
        serve_fn, _ = TS.make_serve_step(cfg, dshape, mesh)
        dlocal = SH.batch_shard({"frames": first["frames"],
                                 "tokens": first["tokens"]}, cfg, mesh,
                                dshape)
        with torch.no_grad():
            enc = partb.encode(dlocal["frames"],
                               ctx=TS.make_ctx(cfg, mesh, dshape))
            cache = partb.init_cache(B, S, mesh=mesh, specs=sspecs["cache"])
            partb.prime_cross_cache(cache, enc, sspecs["cache"])
        serve["cross"] = max(mc_ratio(layer[n], want[n].to(dev), stages)
                             for layer, want in zip(cache, ref["cross"])
                             for n in want)
        serve["logits"] = max(
            mc_ratio(serve_fn(partb, cache, dlocal["tokens"][:, t], t),
                     ref["serve"][t].to(dev), stages)
            for t in range(MC_FAMILY_SERVE_STEPS))
        del partb, cache, enc
        gc.collect()
        empty_cache(dev)
        if max(serve.values()) > 1:
            raise SmokeFailure(f"{tag}: the cross cache and serve steps "
                               f"against one process: {serve}")
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    if launches:
        raise SmokeFailure(f"{tag}: a port kernel launched on a path "
                           f"that has none: {launches}")
    named = dict(LM(cfg, device="meta", masters=True).named_parameters())
    am = abstract_mesh((1, 2), ("data", "model"))
    modelled = step_collectives(
        cfg, shape, am, params={n: (tuple(p.shape), 4)
                                for n, p in named.items()},
        specs=SH.param_pspecs(cfg, named, am),
        constraints=[("tokens_bse", (B, S, cfg.d_model), "bfloat16",
                      ("data", "model")),
                     ("logits_bsv", (B, S, cfg.padded_vocab), "float32",
                      ("data", "model") if vsplit else ("data",))],
        kinds=layer_kinds(cfg), compute_itemsize=2).summary()[0]
    modelled = {k: int(v * len(MC_GSPMD_STEPS)) for k, v in modelled.items()
                if v}
    ratio = sum(counted.values()) / max(modelled.get("total", 0), 1)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0
    seconds = time.perf_counter() - t_case
    lines.append(
        f"{tag}: {arch} {cfg.num_layers} layers "
        f"({', '.join(layer_kinds(cfg))}"
        + (f"; encoder {cfg.encoder_layers}" if encdec else "")
        + f") at full width, batch {B} x {S}, fp32 masters, bf16; forward "
        f"logits err / bound {logit_ratio:.3f}, loss {loss_ratio:.3f} "
        f"(bound {loss_bound:.3e}); "
        + (f"fp32 gradients of step 1 err / fp32 bound {fp32['right'][0]:.3f}"
           f" ({fp32['right'][1]}); " if fp32 else "")
        + f"fault ({fault}) err / bound {fault_ratio[0]:.1f} "
        f"({fault_ratio[1]}{', fp32' if fp32 else ''}); steps " + "; ".join(
            f"{r['step']}: loss {r['loss'][1]:.6f} vs {r['loss'][0]:.6f} "
            f"({r['loss_ratio']:.3f}), grad_norm {r['grad_norm'][1]:.5f} vs "
            f"{r['grad_norm'][0]:.5f} ({r['grad_norm_ratio']:.3f}), grads "
            f"{r['grads'][0]:.3f} ({r['grads'][1]}), params "
            f"{r['params']:.3f}" for r in rows)
        + ("; cross cache primed over the mesh err / bound "
           f"{serve['cross']:.3f}, {MC_FAMILY_SERVE_STEPS} serve steps' "
           f"logits {serve['logits']:.3f}" if serve else "")
        + f"; port kernel launches 0; step ms "
        f"{', '.join(f'{t:.1f}' for t in step_ms)} ({mesh.backend}"
        + (", host staging: not a link rate" if mesh.stages_through_host
           else "")
        + f"); collective bytes per kind {counted} vs step_collectives "
        f"{modelled}, ratio {ratio:.3f}; peak {peak:.2f} GB allocated; "
        f"one-process turns {ref_s:.1f} s, case {seconds:.1f} s")
    return {"launches": 0, "steps": rows, "logit_ratio": logit_ratio,
            "loss_ratio": loss_ratio, "fault": fault_ratio,
            "fp32_grads": fp32.get("right"),
            "serve": serve, "step_ms": step_ms, "bytes": counted,
            "modelled_bytes": modelled, "bytes_ratio": ratio,
            "peak_gb": peak, "seconds": seconds}


#: (f) the serve step over a mesh: batch, steps, cache length (half of it
#: under ``--quick``) and the layers of each arch.  The steps start 4
#: before olmoe's cache boundary (its middle: ranks on ``(1, 2)`` hold one
#: half each) and 4 before recurrentgemma's ring wraps.
MC_SERVE_BATCH, MC_SERVE_STEPS = 4, 8
MC_SERVE_CACHE, MC_SERVE_CACHE_QUICK = 4096, 256
MC_SERVE_RG = "recurrentgemma-9b"
#: Depth of each arch: olmoe's first 2 of 16 layers; recurrentgemma's
#: first period cut to its first 3 layers (rglru, rglru, local) of 38.
MC_SERVE_DEPTH = {MC_ARCH: {"num_layers": 2},
                  MC_SERVE_RG: {"num_layers": 3,
                                "layer_pattern": ("rglru", "rglru",
                                                  "local")}}


def mc_fill_cache(cache, upto: int, seed: int, dev) -> None:
    """Fill a whole decode cache in place from ``seed``: the K/V slots
    below ``upto`` (a ring's below ``min(upto, S_c)``) and every recurrent
    ``conv`` and ``h``, with N(0, 1) in each leaf's dtype, K at 3x (its
    logits then spread by about 3, so a few slots carry each row's
    softmax, as in a trained model, and a block's weight in the combine
    is far from its share of the slots); the other slots stay 0.  The
    same seed gives the same numbers."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    for layer in cache:
        for name, t in layer.items():
            r = torch.randn(t.shape, generator=g, device=dev)
            if name in ("k", "v"):
                t[:, :upto] = (r[:, :upto] * (3.0 if name == "k" else 1.0)
                               ).to(t.dtype)
            else:
                t.copy_(r.to(t.dtype))


class RecordAttention:
    """Records the output of every decode attention (the input of ``wo``)
    while active: one process's ``models.attention.decode_attention`` and
    a partitioned step's ``combine``, in call order."""

    def __init__(self):
        self.outs = []

    def __enter__(self):
        from repro_torch.models import attention as A
        self._orig = A.decode_attention, A.combine

        def recording(fn):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                self.outs.append(out.detach().clone())
                return out
            return wrapped
        A.decode_attention, A.combine = map(recording, self._orig)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        A.decode_attention, A.combine = self._orig


def mc_serve_case(arch: str, dev, backend, quick: bool, lines: list,
                  tag: str) -> dict:
    """One serve case of (f) on ``(data=1, model=2)``: ``arch`` at full
    width and ``MC_SERVE_DEPTH``'s layers, bf16, batch 4, from a cache
    filled below the start position (``mc_fill_cache``, the same numbers
    in the one-process cache and in each rank's blocks).  The one-process
    ``decode_step`` runs the 8 steps first on the same card (its routing
    recorded); then the partitioned serve step (``make_serve_step`` over
    the mesh) replays that routing, with every kernel counter zeroed just
    before and read just after; then each planted fault from a fresh
    cache: on olmoe the combine without its ``e^{m - m*}`` rescale and the
    new K/V written on every rank, on recurrentgemma the RG-LRU's gate
    blocks taken from the other rank.  Held within
    ``models.model.rounding_tolerance`` at each row's scale
    (``mc_ratio``): each step's logits block over ``mc_roundings``
    stages; each attention output (``RecordAttention``) and each final
    cache block (K, V, ``h``, ``conv``) over the stages through its layer
    (``roundings(cfg, i + 1)`` and the row-parallel exits' ``2 (i + 1)
    tp``).  At full width the logits' bound is loose (a quarter of a
    row's largest logit); a fault must break one of these bounds."""
    import dataclasses
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.core.collectives import step_collectives
    from repro_torch.core.device import synchronize
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import abstract_mesh, make_process_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import rglru as R
    from repro_torch.models.model import (ATTENTION_KINDS, LM, init_params,
                                          layer_kinds, roundings)
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(get_config(arch), **MC_SERVE_DEPTH[arch])
    B, steps = MC_SERVE_BATCH, MC_SERVE_STEPS
    cache_len = MC_SERVE_CACHE_QUICK if quick else MC_SERVE_CACHE
    kinds = layer_kinds(cfg)
    if "local" in kinds:
        start = min(cache_len, cfg.window_size) - 4     # the ring wraps
    else:
        start = cache_len // 2 - 4                      # the block boundary
    shape = ShapeConfig("mc-serve", cache_len, B, "decode")
    mesh = make_process_mesh((1, 2), ("data", "model"), device=dev,
                             backend=backend)
    tp = 2
    stages = mc_roundings(cfg, tp)

    def through(i):
        return roundings(cfg, i + 1) + 2 * (i + 1) * tp

    attn_layers = [i for i, k in enumerate(kinds) if k in ATTENTION_KINDS]
    serve1, _ = TS.make_serve_step(cfg, shape)
    serve, specs = TS.make_serve_step(cfg, shape, mesh)
    g = torch.Generator(device=dev).manual_seed(11)
    tokens = torch.randint(2, cfg.vocab_size - 1, (steps, B), generator=g,
                           device=dev)

    def seeded():
        g = torch.Generator(device=dev).manual_seed(0)
        return init_params(cfg, device=dev, generator=g)

    one = seeded()
    filled = one.init_cache(B, cache_len)
    mc_fill_cache(filled, start, 3, dev)
    c1 = [{n: t.clone() for n, t in layer.items()} for layer in filled]
    want = []
    with ReplayRouting() as routes, RecordAttention() as want_attn:
        for t in range(steps):
            logits = serve1(one, c1, tokens[t], start + t)
            want.append(SH.local_block(logits, specs["logits"], mesh)
                        .clone())
    want_cache = [{n: SH.local_block(t, spec[n], mesh).clone()
                   for n, t in layer.items()}
                  for layer, spec in zip(c1, specs["cache"])]
    del one, c1
    gc.collect()
    empty_cache(dev)

    part = seeded().shard(mesh)

    def run(count: bool = False) -> dict:
        cache = SH.cache_blocks(filled, specs["cache"], mesh)
        out, ms = [], []
        if count:
            kernels.reset_launch_counts()
        with ReplayRouting(routes.ids) as replay, \
                RecordAttention() as attn:
            for t in range(steps):
                synchronize(dev)
                t0 = time.perf_counter()
                out.append(serve(part, cache, tokens[t], start + t))
                synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
        launches = kernels.launch_counts()["grouped_matmul"] if count else 0
        ratios = {
            "logits": max(mc_ratio(o, w, stages)
                          for o, w in zip(out, want)),
            "attention": max(
                mc_ratio(o, w, through(attn_layers[c % len(attn_layers)]))
                for c, (o, w) in enumerate(zip(attn.outs, want_attn.outs))),
            **{f"{i}.{n}": mc_ratio(got[n], w, through(i))
               for i, (got, ref) in enumerate(zip(cache, want_cache))
               for n, w in ref.items()}}
        del cache
        return {"ratios": ratios, "ms": ms, "launches": launches,
                "flips": replay.flips}

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log_ = mesh.reset_log()
    good = run(count=True)
    counted = {k: int(v) for k, v in log_.bytes.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0
    real = {"owner": SH.slot_owner, "gates": R.gate_blocks}

    def no_rescale(acc, m, l, mesh_, axes, dtype):
        if axes:
            l = comm.psum(l, axes, mesh=mesh_)
            acc = comm.psum(acc, axes, mesh=mesh_)
        return (acc / torch.clamp(l[..., None], min=1e-30)).to(dtype)

    def every_rank(slot, s_c, axes, mesh_):
        return (SH.axes_index(mesh_, SH.axes_of(axes)),
                real["owner"](slot, s_c, axes, mesh_)[1])

    def wrong_blocks(p, ctx):
        n = ctx.process_mesh.shape["model"]
        return tuple(comm.ppermute(w, "model",
                                   [(i, (i + 1) % n) for i in range(n)],
                                   mesh=ctx.process_mesh)
                     for w in real["gates"](p, ctx))

    # The attention faults on the arch whose every layer attends, the
    # gates' on the RG-LRU's.
    if "rglru" in kinds:
        faults = {"gates from the wrong rank's blocks": (
            R, "gate_blocks", wrong_blocks)}
    else:
        faults = {"combine without the rescale": (A, "combine", no_rescale),
                  "K/V written on every rank": (SH, "slot_owner",
                                                every_rank)}
    fault_ratios = {}
    for name, (mod, attr, fn) in faults.items():
        with patched(mod, attr, fn):
            bad = run()["ratios"]
        worst = max(bad, key=bad.get)
        fault_ratios[name] = (bad[worst], worst)
    planned = part.grouped_launches_per_step() * steps \
        if dev.type == "cuda" else 0
    named = dict(LM(cfg, device="meta").named_parameters())
    am = abstract_mesh((1, 2), ("data", "model"))
    seq = SH.seq_axes_for_batch(am, B)
    modelled = step_collectives(
        cfg, shape, am, params={n: (tuple(p.shape), 2)
                                for n, p in named.items()},
        specs=SH.param_pspecs(cfg, named, am),
        constraints=[("tokens_bse", (B, 1, cfg.d_model), "bfloat16",
                      ("data",)),
                     ("kv_cache", (B, cache_len, cfg.num_kv_heads,
                                   cfg.head_dim), "bfloat16",
                      ("data",) + seq)],
        kinds=kinds, compute_itemsize=2).summary()[0]
    modelled = {k: int(v * steps) for k, v in modelled.items() if v}
    bytes_ratio = sum(counted.values()) / max(modelled.get("total", 0), 1)
    ratios = good["ratios"]
    if max(ratios.values()) > 1:
        raise SmokeFailure(f"{tag}: err / bound against one process "
                           f"{ratios}")
    missed = {k: v for k, v in fault_ratios.items() if v[0] <= 1}
    if missed:
        raise SmokeFailure(f"{tag}: planted faults passed {missed}")
    if good["launches"] != planned:
        raise SmokeFailure(f"{tag}: {good['launches']} grouped launches, "
                           f"planned {planned}")
    lines.append(
        f"{tag}: {arch} {cfg.num_layers} layers ({', '.join(kinds)}) at full "
        f"width, bf16, batch {B}, cache {cache_len}, steps at pos {start}.."
        f"{start + steps - 1}; logits {tuple(want[0].shape)} per rank (spec "
        f"{specs['logits']}); err / bound "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
        + "; faults err / bound "
        + ", ".join(f"{k} {v:.1f} ({w})"
                    for k, (v, w) in fault_ratios.items())
        + f"; own router differs on {good['flips']} rows; grouped launches "
        f"{good['launches']} = planned {planned}; step ms "
        f"{', '.join(f'{t:.2f}' for t in good['ms'])} ({mesh.backend}"
        + (", host staging: not a link rate" if mesh.stages_through_host
           else "")
        + f"); collective bytes per kind {counted} vs step_collectives "
        f"{modelled}, ratio {bytes_ratio:.3f}; peak {peak:.2f} GB allocated")
    out = {"launches": good["launches"], "planned": planned,
           "ratios": ratios, "faults": fault_ratios, "step_ms": good["ms"],
           "bytes": counted, "modelled_bytes": modelled,
           "bytes_ratio": bytes_ratio, "peak_gb": peak,
           "flips": good["flips"]}
    del part, filled, want, want_cache
    gc.collect()
    empty_cache(dev)
    return out


def mc_gspmd_serve(dev, backend, quick: bool, lines: list) -> dict:
    """(f) The serve step over a mesh: (f1) olmoe-1b-7b across its cache's
    block boundary, (f2) recurrentgemma-9b across its ring's wrap
    (``mc_serve_case``)."""
    rank = int(os.environ.get("RANK", 0))
    return {"olmoe": mc_serve_case(MC_ARCH, dev, backend, quick, lines,
                                   f"[multicard] (f1) rank {rank}"),
            "rgemma": mc_serve_case(MC_SERVE_RG, dev, backend, quick, lines,
                                    f"[multicard] (f2) rank {rank}")}


def multicard_rank(rank: int, world: int, quick: bool,
                   distinct: bool) -> dict:
    """One rank of the ``[multicard]`` world: (a)-(f) in order, (e3)-(e6)
    after (e1) and (e2)."""
    import importlib
    import threading
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    # The attention's non-reentrant checkpoint imports torch._dynamo on
    # its first call (~8 s on the H100 host): import it meanwhile.
    warm = threading.Thread(target=importlib.import_module,
                            args=("torch._dynamo",))
    warm.start()
    dev = torch.device("cuda", rank if distinct else 0)
    backend = None if distinct else "gloo"
    lines: list = []
    out = {"rank": rank, "lines": lines, "seconds": {}}
    t0 = time.perf_counter()
    moe = [mc_moe(dev, backend, shape, quick, lines)
           for shape in MC_MOE_MESHES]
    out["seconds"]["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fsdp = next(r for r in moe if r["mesh"][0] > 1)
    out["compress"] = mc_compress(fsdp["mesh_obj"], fsdp["shard_grads"],
                                  lines)
    for r in moe:
        del r["mesh_obj"], r["shard_grads"]
    out["moe"] = moe
    torch.cuda.empty_cache()
    out["seconds"]["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm.join()
    out["pipeline"] = mc_pipeline(dev, backend, quick, lines)
    torch.cuda.empty_cache()
    out["seconds"]["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["shard"] = mc_shard(dev, backend, quick, lines)
    out["seconds"]["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    out["gspmd"] = {"train": mc_gspmd_train(dev, backend, quick, lines),
                    "prefill": mc_gspmd_prefill(dev, backend, quick,
                                                lines)}
    out["seconds"]["e"] = time.perf_counter() - t0
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["families"] = {}
    for key, arch, overrides, tokens, fault in MC_FAMILY_CASES:
        t0 = time.perf_counter()
        out["families"][key] = mc_family_case(key, arch, overrides, tokens,
                                              fault, dev, backend, quick,
                                              lines)
        out["seconds"][key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"] = mc_gspmd_serve(dev, backend, quick, lines)
    out["seconds"]["f"] = time.perf_counter() - t0
    return out


def nccl_duplicate_rank(rank: int, world: int) -> None:
    """Ask NCCL for two ranks on one card (it refuses)."""
    import torch
    from repro_torch.launch.mesh import make_process_mesh
    make_process_mesh((world,), ("x",), device=torch.device("cuda", 0),
                      backend="nccl")


def nccl_world_one(dev) -> dict:
    """A world of one rank on NCCL in this process: every ``core.comm`` op
    (and ``compressed_psum``) passes once through NCCL, with gradients."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.spawn import free_port
    from repro_torch.optim.compression import compressed_psum
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
            "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    try:
        mesh = make_process_mesh((1,), ("x",), device=dev)
        if mesh.backend != "nccl":
            raise SmokeFailure(f"[multicard] world of one on {dev}: backend "
                               f"{mesh.backend}, expected nccl")
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(8, 128, generator=g, device=dev).to(torch.bfloat16)
        xs = x.clone().requires_grad_()
        with mesh:
            y = comm.all_gather(xs, "x", dim=0, tiled=True)
            y = comm.psum_scatter(y, "x", scatter_dimension=0, tiled=True)
            y = comm.ppermute(y, "x", [(0, 0)])
            y = comm.psum(comm.pvary(y, "x"), "x")
            y.float().sum().backward()
            outs = {"pmax": comm.pmax(x, "x"),
                    "broadcast": comm.broadcast(x, "x", 0),
                    "all_gather": comm.all_gather(x, "x", dim=1)[:, 0]}
            mean, res = compressed_psum(x.float(), torch.zeros_like(
                x, dtype=torch.float32), "x")
        checks = {"chain": bool(torch.equal(y.detach(), x)),
                  "grad": bool(torch.equal(xs.grad, torch.ones_like(x))),
                  **{k: bool(torch.equal(v, x)) for k, v in outs.items()},
                  "compressed_psum": bool(torch.equal(
                      mean + res, x.float()))}
        if not all(checks.values()):
            raise SmokeFailure(f"[multicard] NCCL world of one: {checks}")
        return {"checks": checks, "bytes": dict(mesh.log.bytes)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def multicard_phase(quick: bool, dev) -> dict:
    """Spawn the ``[multicard]`` world (NCCL on distinct cards, else gloo
    with two ranks on ``cuda:0``), run (a)-(f) in it, and a world of one
    on NCCL here; on one card, also confirm that NCCL refuses two ranks on
    it.  Returns the launches per rank and kernel."""
    import threading
    import torch
    from repro_torch.kernels import KERNEL_MODULES
    from repro_torch.launch.spawn import run_world
    distinct = torch.cuda.device_count() >= MC_WORLD
    if distinct:
        log(f"[multicard] backend nccl: {MC_WORLD} ranks on cuda:0.."
            f"{MC_WORLD - 1}, one card each")
    else:
        log(f"[multicard] backend gloo: {MC_WORLD} ranks on cuda:0 (one "
            f"card; NCCL refuses two ranks on a device), collectives "
            f"staged through the host: wire times say nothing of NVLink")
    empty_cache(dev)
    dup = {}
    probe = None
    if not distinct:
        def refuse():
            try:
                run_world(nccl_duplicate_rank, MC_WORLD, timeout=120)
                dup["message"] = None
            except Exception as e:              # the rank's traceback
                dup["message"] = str(e)
        probe = threading.Thread(target=refuse)
        probe.start()
    t0 = time.perf_counter()
    try:
        results = run_world(multicard_rank, MC_WORLD, quick, distinct,
                            timeout=900)
    finally:
        if probe is not None:
            probe.join()
    world_s = time.perf_counter() - t0
    for r in results:
        for line in r["lines"]:
            log(line)
        log(f"[multicard] rank {r['rank']}: seconds {r['seconds']}, peak "
            f"{r['peak_gb']:.2f} GB allocated")
    one = nccl_world_one(dev)
    log(f"[multicard] world of one on NCCL ({dev}): every comm op and "
        f"compressed_psum once, {one['checks']}")
    if probe is not None:
        msg = dup.get("message")
        if msg is None:
            log("[multicard] NCCL accepted two ranks on one card")
        else:
            lines = [ln for ln in msg.splitlines() if "Duplicate GPU" in ln
                     or "NCCL error" in ln]
            if not lines:
                raise SmokeFailure(f"[multicard] the NCCL probe failed "
                                   f"otherwise: {msg[-2000:]}")
            log(f"[multicard] NCCL on two ranks of one card: "
                f"{lines[-1].strip()}")
    launches = {k: [0] * MC_WORLD for k in KERNEL_MODULES}
    gspmd = [0] * MC_WORLD
    serve = [0] * MC_WORLD
    for r in results:
        gspmd[r["rank"]] = r["gspmd"]["train"]["launches"] + \
            r["gspmd"]["prefill"]["launches"]
        serve[r["rank"]] = sum(c["launches"] for c in r["serve"].values())
        launches["grouped_matmul"][r["rank"]] += sum(
            m["launches"] for m in r["moe"]) + r["pipeline"]["launches"] + \
            gspmd[r["rank"]] + serve[r["rank"]]
        for k, v in r["shard"]["launches"].items():
            launches[k][r["rank"]] += v
    for k in ("grouped_matmul", "bcsr_spmm", "banded_spmm", "csr_spmm"):
        if 0 in launches[k]:
            raise SmokeFailure(f"[multicard] {k} did not launch on every "
                               f"rank: {launches[k]}")
    log(f"[multicard] launches per rank: "
        f"{ {k: v for k, v in launches.items() if any(v)} }; world "
        f"{world_s:.1f} s")
    log(f"[multicard] (e) grouped launches per rank {gspmd} (train "
        f"planned {results[0]['gspmd']['train']['planned']}, prefill "
        f"{results[0]['gspmd']['prefill']['planned']} per rank); (e) "
        f"seconds per rank {[round(r['seconds']['e'], 1) for r in results]}")
    for key, *_ in MC_FAMILY_CASES:
        log(f"[multicard] ({key}) port kernel launches per rank "
            f"{[r['families'][key]['launches'] for r in results]} (none on "
            f"the path); seconds per rank "
            f"{[round(r['seconds'][key], 1) for r in results]}; peak "
            f"{[round(r['families'][key]['peak_gb'], 2) for r in results]} "
            f"GB")
    if 0 in serve:
        raise SmokeFailure(f"[multicard] (f) the grouped kernel did not "
                           f"launch on every rank: {serve}")
    log(f"[multicard] (f) grouped launches per rank {serve} (planned "
        f"{results[0]['serve']['olmoe']['planned']} per rank); (f) seconds "
        f"per rank {[round(r['seconds']['f'], 1) for r in results]}")
    family = [sum(r["families"][key]["launches"]
                  for key, *_ in MC_FAMILY_CASES) for r in results]
    return {"launches": launches, "gspmd_launches": gspmd,
            "serve_launches": serve, "family_launches": family,
            "results": results, "backend": "nccl" if distinct else "gloo",
            "world_seconds": world_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="n = 2**14 instead of 2**20 (a short check)")
    args = ap.parse_args(argv)
    n = 2 ** 14 if args.quick else 2 ** 20

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not beside this script "
              f"({SRC / 'repro_torch'} missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The whole run reads and writes calibrations here and nowhere else:
    # a file left in the default root must never steer it.
    cal_root = tempfile.mkdtemp(prefix="chip-smoke-cal-")
    os.environ["REPRO_CALIBRATION_DIR"] = cal_root
    try:
        return run(args.quick, n)
    finally:
        shutil.rmtree(cal_root, ignore_errors=True)


def run(quick: bool, n: int) -> int:
    """Every phase in order; a failure raises."""
    import gc
    import torch
    t_start = time.perf_counter()
    seconds = {}
    smi = nvidia_smi()
    log(f"[gpu] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build(verbose=True)
    seconds["build"] = time.perf_counter() - t0
    log(f"[build] {len(build.KERNELS)} kernels built in "
        f"{seconds['build']:.1f}s into {build.build_dir()}")
    for name, text in build.LAST_LOG.items():
        for line in ptxas_report(text):
            log(f"[build] {name}: {line}")
    log(f"kernels: {' '.join(KERNEL_NAMES)}")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    calibrated = calibrate_phase(CAL_SCALE_QUICK if quick else None, dev)
    seconds["calibrate"] = time.perf_counter() - t0
    log(f"[calibrate] phase took {seconds['calibrate']:.1f}s")
    t0 = time.perf_counter()
    served = serve_phase(n, STEPS, dev)
    seconds["serve"] = time.perf_counter() - t0
    log(f"[serve] phase took {seconds['serve']:.1f}s")
    t0 = time.perf_counter()
    moe = moe_phase(quick, dev)
    seconds["moe"] = time.perf_counter() - t0
    log(f"[moe] phase took {seconds['moe']:.1f}s")
    missing = [k for k in KERNEL_NAMES
               if served["counts"][k] + moe["counts"][k] <= 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on a path: {missing}")
    t0 = time.perf_counter()
    lm = lm_phase(quick, dev)
    seconds["lm"] = time.perf_counter() - t0
    log(f"[lm] phase took {seconds['lm']:.1f}s")
    t0 = time.perf_counter()
    families = families_phase(quick, dev)
    seconds["families"] = time.perf_counter() - t0
    log(f"[families] phase took {seconds['families']:.1f}s")
    t0 = time.perf_counter()
    recurrent = recurrent_phase(quick, dev)
    seconds["recurrent"] = time.perf_counter() - t0
    log(f"[recurrent] phase took {seconds['recurrent']:.1f}s")
    t0 = time.perf_counter()
    train = train_phase(quick, dev)
    seconds["train"] = time.perf_counter() - t0
    log(f"[train] phase took {seconds['train']:.1f}s")
    t0 = time.perf_counter()
    dryrun = dryrun_phase(quick, dev)
    seconds["dryrun"] = time.perf_counter() - t0
    log(f"[dryrun] phase took {seconds['dryrun']:.1f}s")
    t0 = time.perf_counter()
    records = kernel_phase(served, quick, dev)
    records.append(grouped_record(moe, quick))
    for rec in records:
        grouped = rec["name"] == "grouped_matmul"
        rec["calibrate_launches"] = calibrated["counts"][rec["name"]]
        rec["lm_launches"] = lm["launches"] if grouped else 0
        rec["families_launches"] = families["launches"][rec["name"]]
        rec["recurrent_launches"] = recurrent["launches"][rec["name"]]
        rec["train_launches"] = train["launches"] if grouped else 0
        rec["dryrun_launches"] = dryrun["launches"] if grouped else 0
    records[-1]["lm"] = lm
    records[-1]["train"] = train
    records[-1]["dryrun"] = dryrun
    seconds["kernel"] = time.perf_counter() - t0
    log(f"[kernel] phase took {seconds['kernel']:.1f}s")
    t0 = time.perf_counter()
    paper = paper_phase(quick, dev)
    for rec in records:
        rec["paper_launches"] = paper.get(rec["name"], 0)
    seconds["paper"] = time.perf_counter() - t0
    log(f"[paper] phase took {seconds['paper']:.1f}s")
    t0 = time.perf_counter()
    engine = engine_phase(served, quick, dev)
    for rec in records:
        rec["engine_launches"] = engine[0]["counts"][rec["name"]]
    seconds["engine"] = time.perf_counter() - t0
    log(f"[engine] phase took {seconds['engine']:.1f}s")
    t0 = time.perf_counter()
    shard_phase(quick, dev)
    seconds["shard"] = time.perf_counter() - t0
    log(f"[shard] phase took {seconds['shard']:.1f}s")
    t0 = time.perf_counter()
    harvest_phase(dev)
    seconds["harvest"] = time.perf_counter() - t0
    log(f"[harvest] phase took {seconds['harvest']:.1f}s")
    # The served plans' layouts (about 22 GB on the card) are not read
    # again: free them for the multicard world's ranks, which share it.
    del served, moe
    gc.collect()
    empty_cache(dev)
    t0 = time.perf_counter()
    multicard = multicard_phase(quick, dev)
    for rec in records:
        rec["multicard_launches"] = multicard["launches"][rec["name"]]
        rec["multicard_gspmd_launches"] = multicard["gspmd_launches"] \
            if rec["name"] == "grouped_matmul" else [0] * MC_WORLD
        rec["multicard_serve_launches"] = multicard["serve_launches"] \
            if rec["name"] == "grouped_matmul" else [0] * MC_WORLD
        # (e3)-(e6): no port kernel is on those paths.
        rec["multicard_family_launches"] = multicard["family_launches"]
    seconds["multicard"] = time.perf_counter() - t0
    log(f"[multicard] phase took {seconds['multicard']:.1f}s "
        f"({multicard['backend']})")
    log(f"[time] seconds by phase: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in seconds.items())}; total "
        f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
