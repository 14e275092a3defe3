#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one GPU and hold every kernel
against its plain PyTorch version.

The first main path is the paper's own: a schedule kind's map walks an
m-simplex domain and a kernel does one tile of work per step.  The
second is serving: ``repro_torch.launch.serve`` prefills a batch of
prompts through full-width yi-6b, whose attention runs the
folded-simplex flash kernel, and decodes greedily; the same model at its
config's own bfloat16 activations prefills through the 16-bit flash
route, and the dense family's other configs (granite-8b, stablelm-12b,
internlm2-20b) serve the same way, then the MoE, MLA and hybrid families
(qwen2-moe-a2.7b, deepseek-v3-671b, jamba-v0.1-52b) and the last three
(xlstm-350m, qwen2-vl-72b with patch embeddings and M-RoPE,
seamless-m4t-large-v2 with its encoder and cross attention).  The third
is training: ``repro_torch.launch.train`` takes float32 steps at full
width with the flash forward under autograd, also under remat "dots".  The frozen originals of ``kernels/legacy.py`` check the engine
independently, and the paper's §7.1 tensor-core map turns grid
coordinates into element origins.  This script

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together, then one link) and logs
   each source's compile time and what ptxas reports per kernel
   (registers, stack, spills, shared memory), then the ``map_frame``
   line: the stack frame of every kernel of a source that includes
   ``simplex_maps.cuh``, which must be 0 bytes for the engine's MAP,
   ACCUM, CA and EDM kernels at m = 2 and 3 (``FRAMELESS``), and the
   ``legacy_md frame`` and ``legacy2d frame`` lines: the ACCUM originals'
   kernels at m = 2, 3 and 4, the CA originals' at m = 2 and 3 and the
   2-D EDM original's must keep no stack frame and spill nothing
   (``LEGACY_MD_FRAMELESS``, ``LEGACY2D_FRAMELESS``);
3. sets every launch counter to 0, drives the public entry points of
   ``repro_torch.kernels.ops`` (MAP, ACCUM, EDM, CA at m=2 and m=3, plus
   ACCUM, EDM and MAP at m=4, and MAP at m = 5..8 on small sides, so that
   every instantiation of the device map runs; ACCUM and EDM also with
   ``split=True``,
   one launch per composite piece) at the paper's sizes, and holds each
   output against the body's plain version on the same card: integers
   bit-equal, EDM within ``|k - p| <= 1e-5 + 1e-5 * max|p|`` (float32
   sums run in another order on the card, the kernel takes the Gram form
   on the tensor cores, and ``sqrtf`` rounds there), also on points with
   exact and near duplicates at m=2 and m=3, where the Gram form cancels;
   ACCUM also on ACCUM's scalar path (rho = 1 and 2 in int32, where a tile
   row is not a whole number of 16-byte pieces) and, in place through
   ``engine.accum_``, on a view that starts off a 16-byte boundary;
4. reads the counters, which must be > 0 for every kernel;
5. legacy 2-D: sets every counter to 0 again and drives the frozen 2-D
   originals of ``repro_torch.kernels.legacy`` (``map2d``, ``accum2d``,
   ``edm2d``, ``ca2d`` over the paper's ``(w, h)`` grid; n = 16384,
   rho = 16, MAP at nb = 16384) for ``hmap``, ``rb`` and ``bb``; holds
   each against its plain version and against the engine kernel of the
   same kind (``ops.map_table``, ``simplex_accum2d``, ``simplex_edm2d``,
   ``simplex_ca2d``) with the tolerances of step 3; runs ``accum2d`` once
   more at n = 65536, rho = 1, whose hmap grid is taller than the 65535
   blocks of ``gridDim.y``, and checks the triangle exactly; runs
   ``edm2d`` at ``LEGACY_EDM_ODD`` (d = 5, rho = 6: single floats staged
   and partial register blocks) against its plain version for every
   kind; then ``accum2d`` and ``ca2d`` off the main case, each one launch,
   its access path by the host's rule, bit-equal to its plain version and
   to the engine twin (``legacy check`` lines): both on the scalar path
   (``LEGACY2D_SCALAR``), ``ACCUM2D.kernel_`` in place on a view 4 bytes
   past a 16-byte boundary, ``accum2d`` in every ACCUM dtype with values
   at each type's edge, ``ca2d`` where the shared-memory budget cuts the
   warps a block, at a small n whose wrapped halos reach the corners, on
   int8 states of any value and on 0/1 states in every CA dtype; reads
   the counters, which must be > 0; times each kernel, its
   plain version and the library call (the ``edm2d`` lines also give
   ``bound_direct_ms``, the direct-difference form's own float32 floor);
6. legacy m >= 3: sets every counter to 0 and drives ``accum3d``,
   ``accum_md`` and ``ca3d`` at m=3 (n = 1024, rho = 8; hmap, octant,
   table, bb; composite and bb at n = 960) and ``accum_md`` at m=4
   (n = 64, rho = 4; hmap, bb; composite and bb at n = 60), each composite
   ACCUM also with ``split=True``; CA on a state of density 0.35 over the
   whole cube.  Checks the launches of each call against its plan, holds
   each output bit for bit against its plain version and against the
   engine kernel of the same kind and split (``ops.simplex_accum3d``,
   ``simplex_accum_md``, ``simplex_ca3d``); then the ACCUM originals off
   their 16-byte pieces and across types, each bit-equal to its plain
   version with its launches and access path checked (``legacy_md
   check`` lines): ``accum3d`` and ``accum_md`` on the scalar path (m=3,
   n = 256, rho = 2, int32), ``kernel_`` of each in place on a view 4
   bytes past a 16-byte boundary, and ``accum3d`` at m=3, n = 64 in every
   ACCUM dtype with values at each type's edge (rho 4 and 16); then
   ``ca3d`` off the main case (``LEGACY_CA3D_CASES``: rho 16, rho 12 and
   the scalar path at rho 2; int8 states of any value at n = 64, rho 8
   and 16), each one launch, its access path by ``CA3D.vector_access``,
   bit-equal to its plain version and to the engine's ``simplex_ca3d``;
   reads the counters, which must be > 0, and times each kernel beside
   its engine twin, its plain version and a dense ``torch.where``;
7. tensor-core map: sets every counter to 0 and maps the whole hmap2 grid
   of nb = 16384 (134,209,536 blocks, rho = 16) through
   ``hmap_mxu.hmap2_coords_mxu``; holds it bit for bit against its plain
   version and against ``rho * hmap2(wx, wy)`` in int64, and a case with
   outputs above 2^24 (where float32 rounds) against int64 arithmetic,
   then ``MXU_EDGES`` (a view 8 bytes off a 16-byte boundary, T = 128, a T
   that leaves the last block of warps partial, negative ``wx`` and
   ``wy <= 0``, a large ``rho``), each one launch, bit-equal to its plain
   version and to int64 arithmetic (``mxu check`` lines); the kernel must
   keep no stack frame and spill nothing (``mxu frame`` line); reads the
   counter and times the kernel, its plain version and one ``copy_`` of
   the same bytes, the practical ceiling (``mxu copy`` line);
8. dtypes: sets every counter to 0 and drives ACCUM (int8, uint8, int16,
   bfloat16, float16, with values at each type's edge: integers wrap,
   16-bit floats round), CA (int8, uint8, int16, int64, bfloat16,
   float16, float32 0/1 states) and EDM (float16, bfloat16, float64
   points) through the engine's entry points at m=2 (n = 1024) and m=3
   (n = 64) and through the originals (``accum_md`` at m=4), ACCUM and
   CA bit-equal to their plain versions, EDM within step 3's gate plus
   one ulp of a 16-bit output; CA also on bfloat16 states of other values
   than 0/1 at m=2 and m=3 (``CA_MIXED``), where only the reference's
   order of adds is bit-equal; a dtype no kernel takes must raise
   ``ValueError``;
9. the flash tile sweep: sets every counter to 0 and runs every
   ``(block_q, D)`` the kernels are built for (5 x 4) in float32,
   bfloat16 and float16 through ``flash_attention`` at small S, both
   kinds, odd and even tile counts, some with a bias (``bias_h`` 1 or
   Hq), segment ids, ``Hkv == Hq`` or a group of 8;
   float32 within ``2e-5 + 2e-5 * max|p|`` of the plain version, 16-bit
   within one ulp of its type plus ``2^-15 * max|v|``; each kernel
   (``flash``, ``flash16``, ``flash16_wgmma``, ``flash_wgmma``) launched
   once per case of its route;
10. serves full-width yi-6b (32 layers, d_model 4096, float32 weights
   from ``--seed``; batch 4, prompt 2048, 16 greedy tokens) with every
   counter at 0, and checks that prefill launched ``flash_wgmma`` once
   per layer and no other flash kernel; the decode is captured at its
   first step as a CUDA graph and replayed (``launch/graphs.StepGraph``),
   and each replayed step is held against an eager ``model.decode`` on
   the same caches and tokens: logits bit-equal (or within
   ``GRAPH_REL * max|logit|``, said), every greedy token equal; the
   ``serve ... graph`` line gives the replayed ``decode_tok_s`` (capture
   included) beside the eager one, ``capture_s``, the median step ms of
   each and the graph pool's bytes;
11. prefills the same prompts again with ``attention_impl="chunked"``
   (the reference's own executor knob) and holds the last-token logits
   of the two within ``rtol 2e-3, atol 2e-4``;
12. frees that model, builds yi-6b at its config's own dtypes (bfloat16
   activations, float32 weights from ``--seed``), prefills batch 4,
   prompt 2048 with every counter at 0, checks that it launched
   ``flash16_wgmma`` once per layer and no other flash kernel, and holds
   its last-token logits against
   the same model's chunked prefill within ``LOGIT16_TOL * max|logit|``
   with every row's argmax equal, then prefills it twice more with a
   wrong attention in the kernel's place (a mask one key too wide, which
   must fail that gate, and P rounded once to bfloat16, reported); then,
   every counter at 0 again, prefills the same model at a 2080-token
   prompt, which the tuner maps to 32-row tiles: it must launch
   ``flash16`` (the GQA group's heads stacked on ``wgmma``) once per
   layer and no other flash kernel, its logits held by the same gate;
13. dense: with every counter at 0 before each, serves granite-8b (36
   layers, GQA group 4), stablelm-12b (40 layers, head dim 160, which no
   flash tile takes: its prefill runs the chunked executor, 0 flash
   launches) and internlm2-20b at full width cut to 24 of its 48 layers
   (a GQA group of 6; 74 GiB of float32 weights would leave the card no
   room for its cache and activations) through ``launch/serve.py`` as
   yi-6b is served (float32, batch 4, prompt 2048, 16 greedy tokens),
   freeing each model before the next; checks that prefill launched
   ``flash_wgmma`` once per layer (stablelm-12b: none) and holds the
   last-token logits against the same model's chunked prefill
   (stablelm-12b: the chunked bounding-box schedule) within ``rtol 2e-3,
   atol 2e-4`` with every argmax equal; then, at internlm2-20b's head
   layout (B 4, Hq 48, Hkv 8, D 128), holds ``flash_wgmma`` (float32,
   S 2048), ``flash16_wgmma`` (bf16, S 2048) and ``flash16`` (bf16, S 2080,
   32-row tiles, its last stacked head group partly live) against their
   plain versions with step 9's gates and times them;
14. families: with every counter at 0 before each, serves the MoE, MLA and
   hybrid families through ``launch/serve.py`` as the dense family is
   served (float32, batch 4, prompt 2048, 16 greedy tokens, each model
   freed before the next): qwen2-moe-a2.7b in full (24 layers, 60 experts
   top-4 and 4 shared, ``Hkv == Hq == 16``), jamba-v0.1-52b cut to one
   period (8 of 32 layers: Mamba at 7, attention at index 4, MoE on odd
   layers) and deepseek-v3-671b cut to its 3 dense prefix layers and one
   MoE layer (MLA, 256 experts top-8, sigmoid router), then xlstm-350m in
   full (24 layers: mLSTM, and sLSTM at index 3 of each period of 8),
   qwen2-vl-72b cut to 12 of 80 layers (1024 patch embeddings and 1024
   text tokens, M-RoPE) and seamless-m4t-large-v2 in full (24 encoder
   and 24 decoder layers, 2048 frame embeddings); logs each one's
   layers, widths, parameters, cut, ``prefill_s``, ``decode_tok_s``,
   ``peak_gib`` (under 75 GiB, the replayed decode's graph pool and its
   hold against eager included) and the card line; every dense and
   family serve decodes through the captured graph, held against eager
   as in step 10 (``graph`` lines), and a MoE model's routing is
   recorded for the prefill, the graph's warm-up calls and its capture
   only, never for a replay; each serve, its model and graph freed, must
   leave no more memory allocated than it found; checks that prefill
   launched ``flash_wgmma`` 24, 1, 0, 0, 12 and 24 times (deepseek-v3's MLA
   head dims differ, so its prefill takes the chunked executor; xlstm has
   no attention; seamless's encoder and cross attention run the plain
   bidirectional attention, as the reference's do); holds the last-token
   logits against the same model's chunked prefill (deepseek-v3: the
   chunked bounding-box schedule; xlstm: mLSTM chunk 128 against 64), on
   the serve's own inputs, within ``rtol 2e-3, atol 2e-4`` with every
   argmax equal, and counts the (layer, token, slot) router choices that
   differ between the two prefills: where any does, the gate is every
   argmax equal and ``max|d| <= LOGIT16_TOL * max|logit|``, and the line
   says so; then each family's reduced config, its weights made on the
   CPU, prefills the same inputs (batch 2, 256 positions, patches and
   frame embeddings included) on the CPU and on the card, held within
   ``rtol 2e-3, atol 2e-4`` with every argmax equal and every router
   choice the same; then one mLSTM layer at xlstm-350m's full width
   (batch 4, 2048 tokens): the chunkwise form prefill runs against the
   recurrence decode runs, outputs and final state within ``1e-4 *
   max|want| + 1e-6``, and one sLSTM layer's loop over 2048 tokens timed
   beside xlstm's prefill;
15. train: ``launch/train.py`` in float32 at full width (``TRAIN_RUNS``,
   each row's config cut by ``train_config``), yi-6b cut to 4 layers
   (AdamW, batch 4 x seq 2048), internlm2-20b cut to 2 layers (Adafactor,
   batch 2 x seq 2048) and qwen2-moe-a2.7b cut to 2 layers (AdamW, batch
   4 x seq 2048: the balance loss and its gradient through the dispatch,
   ``aux`` logged with ``ce``), then the five families the card had not
   trained: jamba-v0.1-52b (one period, 4 of 16 experts, the Mamba scan
   under autograd, 1 x 1024), deepseek-v3-671b (1 dense prefix layer and
   1 MoE layer, 32 of 256 experts, sigmoid router, MLA through the
   chunked executor, and the MTP head, its share of the loss logged, 1 x
   1024), xlstm-350m (24 layers, the sLSTM loop under autograd, 4 x 1024,
   3 steps), qwen2-vl-72b (2 layers, 2 x 2048 text, then one step of 1024 patch embeddings and 1024
   tokens through ``run``'s ``batch_at``) and seamless-m4t-large-v2 (24 +
   24 layers, 1 x 1024 tokens with 1024 frame embeddings through
   ``batch_at``), 5 steps each (but xlstm) on one repeated batch:
   each row's peak reckoned on the meta device first
   (``train_reckoning``: weights, gradients, optimizer state, the
   activations autograd keeps, the backward's and the update's
   transients) and logged beside the measured peak, both under 75 GiB,
   and the update's own peak read apart, within 0.5 GiB of its reckoning
   where it sets the row's peak;
   where the row takes the flash kernel, the first step's loss and
   global gradient norm with the kernel within ``1e-4`` relative of the
   plain flash version's on the card; with every counter at 0,
   ``flash_wgmma`` launched the row's flash layers x forward passes (1, 0,
   0, 2 and 24 a pass for the five: jamba's one attention layer,
   seamless's decoder self-attention; MLA and xLSTM take none; the
   backward, autograd through ``_reference_attention``, launches none);
   the loss falls; at one layer's attention shape (and at a quarter of
   the sequence with a per-head bias) ``FlashFunction``'s gradients
   within ``1e-6 * max|g|`` of autograd through ``_reference_attention``
   (bit for bit expected); one training step of the row's reduced
   config, its weights made on the CPU, on the card against the CPU (batch
   2, 256 positions): the loss and every gradient leaf's norm within
   ``1e-4`` relative; then yi-6b at 4 layers under remat "dots"
   (AdamW, batch 4 x seq 2048): one step under "none", "full" and "dots"
   (each step's peak memory and flash launches logged), then 5 steps
   under "dots", the first within ``1e-4`` of "none"'s, the loss falling,
   its flash launches the forward's one a layer plus the recomputation's;
16. holds the flash kernels against their plain version on the card at
   the serve shape (float32 folded and bb, bfloat16 and float16
   folded), at a 2080-token prompt with 32-row tiles (float32 folded and
   bb, bfloat16 folded), an odd tile count, ``Hkv == Hq``, a broadcast
   bias and segment ids, and against ``_reference_attention`` on a small
   case;
17. times each engine kernel (median of CUDA-event-timed runs after
   warm-up), its plain version and, where one PyTorch call computes the
   same function, that call (``library_ms``, a yardstick the port never
   calls), and prints one line per (test, m, kind) with grid steps, the
   time ratio against ``bb`` at the same side, and the bound: bytes at
   3.35 TB/s against operations, float32-accurate dot products (EDM,
   flash) at the 3xTF32 tensor-core rate of 495/3 TFLOP/s, beside which
   their lines keep the float32 CUDA-core bound (``bound_f32_ms``,
   67 TFLOP/s);
18. times each flash kernel, its plain version and
    ``scaled_dot_product_attention`` in the same dtype: ``flash_wgmma``
    (folded and bb) at the serve shape, ``flash16_wgmma`` in bfloat16
    (folded and bb) and float16 at the serve shape (bound at the 16-bit
    rate, 989 TFLOP/s), ``flash`` at a 2080-token prompt (32-row tiles),
    and ``flash16`` in bfloat16 and float16 at 2080 tokens, bfloat16 with
    ``Hkv == Hq``, at 2064 (16-row tiles) and 2056 (8-row tiles), at one
    and two warpgroups a block where the group fills two; each timed
    output is held against the plain version's on the same inputs
    (``equal=`` on its line);
19. checks a small input against the dense oracles of ``kernels/ref.py``;
20. tuner: measures the constants of ``roofline/analysis.py`` as its
    comments say (``tuner constant`` lines, each beside the model's value
    and the card's name and power limit); then for ACCUM, EDM and CA at
    m=2 n=16384 and 16000 (rho 16), m=3 n=1024 and 960 (rho 8), m=4 n=64
    and 60 (rho 4; CA at m <= 3) times every kind of
    ``autotune.candidate_kinds`` and, where it is composite, its fused
    walk and its one launch per piece (back-to-back calls, so a
    launch-bound case times its host work too; the candidates take turns,
    9 rounds, 101 where the fastest call is launch-bound, under 0.1 ms),
    and prints the tuner's
    decision (kind, source, scores), its ``split=None`` choice and the
    pick's time over the fastest (``tuner case`` lines); fails when that
    exceeds 1.10 for ACCUM or 1.25 for EDM and CA, or when the entry
    point's defaults (``kind='auto'``, ``split=None``) do not launch the
    pick;
21. attn_tuner: at the serve shape in float32 and bfloat16 and at S 2080
    in bfloat16, prints ``choose_attn_impl``'s decision and the kernel,
    ``block_q`` and grid each executor launches, times
    ``simplex_attention`` with ``impl`` flash-folded, flash-bb and
    chunked (41 rounds of samples of at least 20 ms, the order turning
    each round; each candidate's min, median and max logged), and fails
    when the pick's median is more than 1.10x the fastest's or the default
    dispatch does not launch it;
22. xla: ``executor='xla'`` (the fused executors as torch ops) against
    ``executor='kernel'``, bit for bit, for ACCUM int32 at m=2 n=16384
    rho 16, m=3 n=1024 rho 8 and m=4 n=64 rho 4, and for MAP at nb=16384
    (m=2) and 512 (m=3), both timed (``xla check`` lines);
22a. examples: the port's ``examples/quickstart.py`` (the H grid,
    schedules, the composite walk, ACCUM, EDM, m=4 ACCUM and the folded
    flash forward against their oracles) and ``examples/serve_lm.py``
    (reduced yi-6b, 4 x 64, 24 tokens) on the card; every check they make
    must hold (``examples`` lines), and the quickstart must launch ACCUM,
    EDM and ``flash_wgmma``;
23. shard: sets every counter to 0 and folds the walks of CA and ACCUM's
    paper sizes (m=2 n=16384 rho=16 hmap, m=3 n=1024 rho=8 hmap, m=2
    n=16000 rho=16 composite) k = 2, 4 and 8 ways
    (``distributed/simplex_sharding.py``), MAP also over nb=16384 hmap;
    launches each shard through ``SimplexKernel(body, m, schedule=shard)``:
    MAP's shard tables equal the fused table's rows at the shards' ranges
    and cover it once, ACCUM's and EDM's shard outputs summed equal the
    fused launch bit for bit, and at k=2 every shard's output is held
    against its plain version (EDM within step 3's gate); the sharded CA's
    engine executor on ``devices=[cuda:0]`` steps 3 generations, each
    bit-equal to a fused launch, its peak memory under 75 GiB; the SPMD
    executor on a one-rank NCCL group (a ``FileStore``) steps 3 generations
    of each case bit-equal to the fused launches.  Reads the counters,
    which must be > 0 for MAP, ACCUM, EDM and CA, then times each shard's
    kernel beside the fused one, the CA executor's stitch and whole step
    (``shard case`` lines, with ``shard_skew`` and ``slab_skew``);
24. mesh: on the same one-rank NCCL group, a (1, 1) ``data``/``model``
    mesh (``launch/mesh.py``; ``make_mesh`` of 4 ranks,
    ``make_production_mesh`` and a CPU mesh over the NCCL group must
    raise): ``launch/steps.py``'s ``StepBundle`` serves full-width yi-6b
    (32 layers, float32, batch 4, prompt 2048, 16 greedy tokens; the
    prefill must launch ``flash_wgmma`` once per layer, with the counters
    at 0 just before it, the decode none), each step's logits held
    against the mesh-less serve's on the same weights (rtol 2e-3, atol
    2e-4, every argmax equal), the prefill's cache leaves handed back by
    ``serve_step`` as the same ``DTensor``s, decode tok/s beside the
    mesh-less serve's (``mesh serve`` lines); then the bundle's compiled
    step (``StepBundle.serve_graph``: ``serve_step`` captured once on the
    NCCL rank and replayed) bit-equal to its eager steps, its outputs
    ``DTensor``s and the prefill's cache leaves passed through, and the
    mesh-less decode replayed bit-equal to its own, tok/s of each (``mesh
    serve ... graph`` line); trains yi-6b cut to
    4 layers (AdamW, batch 4 x 2048) 3 steps and internlm2-20b cut to 2
    layers (Adafactor, batch 2 x 2048) 2 steps, each rank's shards updated
    in place, the first step's loss within 1e-5 relative of
    ``launch/train.train_step``'s on the same weights and every parameter
    within ``1e-6 * max|leaf|``, the peak over the steps at most 1 GiB
    above the train phase's row of the same cut; then yi-6b's step's
    gradients through ``compress_bf16`` and ``compress_int8`` on
    the card bit-equal to the CPU's, and one step with
    ``gather_dtype="bfloat16"``, whose gathered parameters alive at once
    (each unit's gathered just before it runs) may not pass the leaves
    outside every unit plus two of the largest units, nor its memory peak
    the float32 row's (``mesh train``, ``mesh compression`` lines);
    prefills qwen2-moe-a2.7b cut to 4 layers through the MoE's
    TP and EP forms (an all-reduce and two all-to-alls over NCCL) against
    the mesh-less prefill under the family phase's gate, router flips
    counted (``mesh moe`` lines); the serve's resident cache bytes (the
    stacked caches each rank stores, ``cache_specs`` of the reference's
    stacked layout) must equal the rule's figure;
24a. trace: ``torch.profiler`` (CPU and CUDA) over yi-6b's prefill and
    one decode step after it (32 layers, float32, batch 4, prompt 2048),
    eager and replayed from a CUDA graph, then over one ``StepBundle``
    decode step on the one-rank mesh, eager and replayed, read by
    ``roofline/trace_cost.py`` (``trace`` lines: kernel time by name and
    launches, the device's busy and idle share, the longest idle gaps and
    the host op under each, host ops, FLOPs by op, the collective census);
    fails when a trace has no device events (a replay's is said, and the
    step timed by CUDA events), when a hand-written kernel's
    traced launches differ from its counter for the same step, or when
    the summed kernel time passes the step's CUDA-event time; a replayed
    step's FLOPs are the eager step's, and its operations, kernel ms,
    step ms and busy share are logged beside the eager step's;
25. prints the ``kernels`` JSON line, then the result line.

The tuner's decisions go to a private cache in a temporary directory.

Any mismatch, build failure or launch error exits non-zero without the
result line.  Run from the repository root::

    python3 chip_smoke.py [--seed 0]

The script needs one CUDA card; without one it exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
import typing

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, published
# Float32-accurate products on the tensor cores: 3xTF32, three TF32 MMAs
# per product at the published dense 495 TFLOP/s.
TF32X3_FLOPS = 495e12 / 3
BF16_FLOPS = 989e12  # H100 SXM dense bf16/fp16 tensor cores, published
EDM_D = 64
TIMED_RUNS = 10

SIMPLEX = ("map", "accum", "edm", "ca")
REPLACES = {
    "map": "src/repro/kernels/engine.py:737",
    "accum": "src/repro/kernels/engine.py:503",
    "edm": "src/repro/kernels/engine.py:503",
    "ca": "src/repro/kernels/engine.py:503",
    "flash": "src/repro/kernels/flash_attention.py:296",
    "flash16": "src/repro/kernels/flash_attention.py:296",
    "flash16_wgmma": "src/repro/kernels/flash_attention.py:296",
    "flash_wgmma": "src/repro/kernels/flash_attention.py:296",
    "map2d": "src/repro/kernels/legacy.py:82",
    "accum2d": "src/repro/kernels/legacy.py:118",
    "edm2d": "src/repro/kernels/legacy.py:167",
    "ca2d": "src/repro/kernels/legacy.py:232",
    "hmap_mxu": "src/repro/kernels/hmap_mxu.py:39",
    "accum3d": "src/repro/kernels/legacy.py:360",
    "ca3d": "src/repro/kernels/legacy.py:436",
    "accum_md": "src/repro/kernels/legacy.py:546",
}
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in SIMPLEX}
SOURCES["flash"] = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCES["flash16"] = "src/repro_torch/kernels/csrc/flash16_stacked.cu"
SOURCES["flash_wgmma"] = "src/repro_torch/kernels/csrc/flash_wgmma.cu"
SOURCES["flash16_wgmma"] = "src/repro_torch/kernels/csrc/flash16_wgmma.cu"
SOURCES["hmap_mxu"] = "src/repro_torch/kernels/csrc/hmap_mxu.cu"

# The frozen 2-D originals: each legacy kernel and the engine body it is
# held against; the paper's m=2 size.
LEGACY = {"map2d": "map", "accum2d": "accum", "edm2d": "edm", "ca2d": "ca"}
LEGACY_SOURCE = "src/repro_torch/kernels/csrc/legacy2d.cu"
LEGACY_KINDS = ("hmap", "rb", "bb")
LEGACY_N, LEGACY_RHO, LEGACY_MAP_NB = 16384, 16, 16384

# The frozen m >= 3 originals: each legacy kernel and the engine entry
# point of the same kind and split it is held against; the engine's
# m >= 3 sizes of DOMAIN_CASES, with hmap beside octant at m=3.
LEGACY_MD = {"accum3d": "simplex_accum3d", "ca3d": "simplex_ca3d",
             "accum_md": "simplex_accum_md"}
LEGACY_MD_SOURCE = "src/repro_torch/kernels/csrc/legacy_md.cu"
LEGACY_MD_CASES = {
    3: [(1024, 8, ("hmap", "octant", "table", "bb")), (960, 8, ("composite", "bb"))],
    4: [(64, 4, ("hmap", "bb")), (60, 4, ("composite", "bb"))],
}
# The ACCUM originals off their 16-byte pieces and across element types,
# each bit-equal to its plain version: (m, n, rho) in int32 where rho
# elements are not a whole number of pieces (legacy.legacy_vector_access);
# (n, rho) of the in-place case on a view 4 bytes past a 16-byte
# boundary (m=3, rho 8: pieces if it were aligned); and accum3d at m=3 on
# a side of LEGACY_MD_DTYPE_N in every ACCUM dtype with values at each
# type's edge (DTYPE_EDGES and these), at rho 4 (pieces for the 4- and
# 8-byte types) and 16 (pieces for every type).
LEGACY_MD_SCALAR = (3, 256, 2)
LEGACY_MD_MISALIGNED = (256, 8)
LEGACY_MD_DTYPE_N, LEGACY_MD_DTYPE_RHOS = 64, (4, 16)
LEGACY_MD_EDGES = {"int32": (2**31 - 1, -1, 7), "int64": (2**63 - 1, -1, 7),
                   "float32": (2.0**24 - 1, 2.0**24, 3.5),
                   "float64": (2.0**53 - 1, 2.0**53, 0.25)}
# The CA original off the main case, each bit-equal to its plain version
# (and, where the engine takes the same tile, to its engine twin): (n,
# rho, kind) in int32 at rho 16 (one warp's halo is 31 KiB, seven warps a
# block), at rho 12 (not a power of two: the kernel divides) and on the
# scalar path (rho 2: 8 bytes a row); and int8 states of any value (the
# neighbour counts wrap) at n = 64, on single cells (rho 8) and 16-byte
# pieces (rho 16).
LEGACY_CA3D_CASES = ((1024, 16, "hmap"), (960, 12, "composite"), (256, 2, "hmap"))
LEGACY_CA3D_INT8_N, LEGACY_CA3D_INT8_RHOS = 64, (8, 16)
# The m >= 3 originals' kernels at m = 3 and 4 (legacy_md.cu) and the
# redesigned 2-D EDM's (legacy2d.cu), which must keep no stack frame and
# spill nothing (ptxas).
LEGACY_MD_FRAMELESS = ("legacy_accum3d_kernel", "legacy_accum_md_kernel<3>",
                       "legacy_accum_md_kernel<4>", "legacy_ca3d_kernel<0>",
                       "legacy_ca3d_kernel<1>")
LEGACY2D_FRAMELESS = ("legacy_edm2d_kernel", "legacy_accum2d_kernel", "legacy_ca2d_kernel<0>",
                      "legacy_ca2d_kernel<1>")
# The redesigned 2-D ACCUM and CA originals off the main case, each one
# launch, its access path checked and bit-equal to its plain version and
# to the engine twin of the same kind: (n, rho) in int32 on the scalar
# path (rho 2: 8 bytes a row; rho 6: 24 bytes, and not a power of two),
# for hmap, rb and bb; (n, rho) of ACCUM2D.kernel_ in place on a view 4
# bytes past a 16-byte boundary; accum2d at n = LEGACY2D_DTYPE_N in every
# ACCUM dtype with values at each type's edge (DTYPE_EDGES and
# LEGACY_MD_EDGES), at rho 4 (pieces for the 4- and 8-byte types) and 16
# (every type); ca2d where the shared-memory budget cuts the warps a block
# ((n, rho, dtype): rho 32 in int64, six warps; rho 64 in int32, three;
# rho 64 in int64, one warp and one slice a block),
# at a small n where every tile's wrapped halo reaches the corners, on
# int8 states of any value (single cells at rho 8, pieces at 16), and on
# 0/1 states in every CA dtype (rho 16: pieces for every type).
LEGACY2D_SCALAR = ((4096, 2), (3072, 6))
LEGACY2D_MISALIGNED = (4096, 16)
LEGACY2D_DTYPE_N, LEGACY2D_DTYPE_RHOS = 256, (4, 16)
LEGACY_CA2D_BUDGET = ((4096, 32, "int64"), (4096, 64, "int32"), (4096, 64, "int64"))
LEGACY_CA2D_CORNERS = (64, 16)
LEGACY_CA2D_TYPES_N, LEGACY_CA2D_INT8_RHOS = 1024, (8, 16)
# edm2d off its 16-byte staging and its 4 x 4 register blocks: (n, rho,
# d) with d not a multiple of 4 and rho not a multiple of 4, held to its
# plain version within the EDM gate for every kind.
LEGACY_EDM_ODD = (1536, 6, 5)

# The tensor-core H map: the whole hmap2 grid of nb tiles a side,
# (wx, wy) for wx < nb/2 and 1 <= wy < nb, in elements of rho.
MXU_NB, MXU_RHO = 16384, 16
# The tensor-core map's edge cases, each one launch: (label, T, bytes the
# input lies past a 16-byte boundary, wx range, wy range, rho).  T =
# 128 * 10001 leaves the last block of 8 warps with one group of 128; a
# large rho takes outputs past int32, wrapped.
MXU_EDGES = (("view 8 bytes off", 128 * 4099, 8, (0, 1 << 20), (1, 1 << 20), 16),
             ("T=128", 128, 0, (0, 1 << 12), (1, 1 << 12), 16),
             ("partial last block", 128 * 10001, 0, (0, 1 << 20), (1, 1 << 20), 16),
             ("negative wx, wy <= 0", 128 * 1031, 0, (-(1 << 30), 1 << 30), (-64, 1 << 20), 1),
             ("negative wx, 8 bytes off", 128 * 1031, 8, (-(1 << 26), 1 << 26), (-64, 1 << 10),
              16),
             ("large rho, wrapped", 128 * 64, 0, (-(1 << 20), 1 << 20), (-8, 1 << 20),
              (1 << 17) + 3))

# Serving: full-width yi-6b, batch 4, prompt 2048 (16 query tiles of 128).
SERVE_ARGV = ["--arch", "yi-6b", "--batch", "4", "--prompt-len", "2048", "--gen", "16",
              "--temperature", "0"]
SERVE_SHAPE = (4, 32, 4, 2048, 128)  # (B, Hq, Hkv, S, D) of one attention call
LOGIT_TOL = dict(rtol=2e-3, atol=2e-4)
# A replayed decode step launches the eager step's kernels on the same
# addresses, so its logits are expected bit-equal to the eager step's; a
# difference up to GRAPH_REL * max|logit| passes and is reported.
GRAPH_REL = 1e-5
# The 16-bit prefill: yi-6b at its config's own dtypes (bfloat16
# activations, float32 weights), the serve batch and prompt.  Its
# last-token logits are held against the same model's chunked prefill
# within LOGIT16_TOL * max|logit|: the chunked executor (the reference's
# own) computes its scores as bfloat16 products rounded to bfloat16
# (2^-9 relative), which moves a probability by up to |score| * 2^-9, about
# 1 % at the scores' scale here, and the difference compounds over 32
# layers; the flash kernel keeps the scores and P float32-accurate.  The
# argmax of every row must agree too.  Two wrong attentions put in the
# kernel's place show what the gate sees: a mask that lets each query see
# the key after it must fail it, and P rounded once to bfloat16 (what the
# chunked executor itself does) is only reported, since the reference
# rounds the same way; the kernel-level gate of ``FlashSmoke.compare``
# holds P.
PREFILL16_BATCH, PREFILL16_LEN = 4, 2048
LOGIT16_TOL = 0.05
# A prompt length the tuner maps with 32-row tiles (2080 = 65 * 32): the
# shape of the float32 mma.sync kernel and of the 16-bit stacked kernel on
# the prefill path, checked and timed; the 16-bit prefill also runs at it.
# 2064 = 129 * 16 and 2056 = 257 * 8 give 16- and 8-row tiles.
SMALL_TILE_S = 2080
SMALL16_S, SMALL8_S = 2064, 2056

# (m, n, rho, kinds) per domain test; each composite side gets its own bb.
DOMAIN_CASES = {
    2: [(16384, 16, ("hmap", "rb", "bb", "table")), (16000, 16, ("composite", "bb"))],
    3: [(1024, 8, ("octant", "table", "bb")), (960, 8, ("composite", "bb"))],
    4: [(64, 4, ("hmap", "bb")), (60, 4, ("composite", "bb"))],
}
MAP_CASES = {
    2: [(16384, ("hmap", "rb", "bb")), (1024, ("table", "bb")),
        (16000, ("composite", "bb"))],
    3: [(512, ("octant", "bb")), (128, ("table", "bb")), (480, ("composite", "bb"))],
    4: [(16, ("hmap", "bb")), (15, ("composite", "bb"))],
    # small, so that every M instantiation of the device map runs on the card
    5: [(16, ("hmap", "table", "bb")), (12, ("composite", "bb"))],
    6: [(16, ("hmap", "table", "bb")), (12, ("composite", "bb"))],
    7: [(8, ("hmap", "table", "bb")), (10, ("composite", "bb"))],
    8: [(8, ("hmap", "table", "bb")), (9, ("composite", "bb"))],
}
# The engine kernels whose device map must keep no stack frame at these m
# (the map_frame line; ptxas reports a frame in local memory per kernel).
FRAMELESS = ("simplex_map_kernel", "simplex_accum_kernel", "simplex_ca_kernel",
             "simplex_edm_kernel")
FRAMELESS_M = (2, 3)
# EDM on points with exact and near duplicates: (m, n, rho, kind).
EDM_DUPLICATE_CASES = ((2, 16384, 16, "hmap"), (3, 1024, 8, "octant"))
# (test, m) whose composite cases also run split=True: one launch per piece.
SPLIT = {("accum", 3), ("edm", 3), ("accum", 4), ("edm", 4)}
# ACCUM off its 16-byte pieces: (m, n, rho) in int32, where rho elements
# are not a whole number of pieces (engine.accum_vector_access), and the
# side of the in-place case on a view that starts 4 bytes past a 16-byte
# boundary.
ACCUM_SCALAR_CASES = ((2, 4096, 1), (2, 4096, 2), (3, 256, 2))
ACCUM_MISALIGNED_N = 4096
CA_DENSITY = {2: 0.4, 3: 0.35}


def _log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_records(log: str) -> list:
    """One dict per kernel that ``-Xptxas -v`` reports: its source, its
    mangled name, registers, stack frame, spill stores/loads and static
    shared memory."""
    records = []
    src = name = props = None
    info: dict = {}
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].split()[0]
        elif "Compiling entry function" in line:
            name, info, props = line.split("'")[1], {}, None
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif "bytes stack frame" in line and name and props in (None, name):
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            info.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif "Used" in line and "registers" in line and name:
            words = line.replace(",", " ").split()
            info["registers"] = int(words[words.index("Used") + 1])
            info["smem"] = int(words[words.index("smem") - 2]) if "smem" in words else 0
            records.append(dict(src=src, name=name, **info))
            name = None
    return records


def ptxas_summary(records: list, cufilt: pathlib.Path) -> list:
    """One line per kernel and resource footprint: registers, stack frame,
    spill stores/loads and static shared memory.  Instantiations of one
    kernel with the same footprint share a line, their template arguments
    joined by ``;`` (names demangled with ``cufilt`` where it exists)."""
    groups: dict = {}
    for r in records:
        info = tuple(sorted((k, v) for k, v in r.items() if k not in ("src", "name")))
        groups.setdefault((r["src"], info), []).append(r["name"])
    names = sorted({r["name"] for r in records})
    readable = dict(zip(names, names))
    if cufilt.exists() and names:
        out = subprocess.run([str(cufilt)], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            # "void k<(int)3, float>(float *, int)": drop the parameter list
            readable = {n: d[:d.rindex("(")].replace("void ", "").replace("(int)", "")
                        if d.endswith(")") else d for n, d in zip(names, out)}
    lines = []
    for (src, info), ns in sorted(groups.items()):
        bases: dict = {}
        for n in ns:
            base, _, args = readable[n].partition("<")
            bases.setdefault(base, []).append(args.rstrip(">").replace(" ", ""))
        what = " ".join(b + (f"<{';'.join(sorted(a))}>" if any(a) else "")
                        for b, a in sorted(bases.items()))
        stats = " ".join(f"{k}={v}" for k, v in info)
        lines.append(f"ptxas {src} {what}: {stats}")
    return lines


def kernel_name(mangled: str) -> str:
    """``name<M>`` of a kernel templated on its leading int (``name``
    otherwise), read from its Itanium-mangled name."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    base = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    arg = re.match(r"ILi(\d+)E", rest)
    return f"{base}<{arg.group(1)}>" if arg else base


def map_frames(records: list, csrc: pathlib.Path) -> dict:
    """``{source: {kernel: stack bytes}}`` for every kernel of a source
    that includes ``simplex_maps.cuh``."""
    users = {p.name for p in csrc.glob("*.cu")
             if '#include "simplex_maps.cuh"' in p.read_text()}
    frames: dict = {}
    for r in records:
        if r["src"] in users:
            frames.setdefault(r["src"], {})[kernel_name(r["name"])] = r["stack"]
    return {src: dict(sorted(k.items())) for src, k in sorted(frames.items())}


def _f32(row) -> str:
    """The float32 CUDA-core bounds of a row that has them, for its case
    line: the Gram form's, and the direct-difference form's where it is
    the row's own."""
    if row.get("bound_f32_ms") is None:
        return ""
    direct = row.get("bound_direct_ms")
    return (f"bound_f32_ms={row['bound_f32_ms']:.4f} "
            + ("" if direct is None else f"bound_direct_ms={direct:.4f} "))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Smoke:
    """One run of the smoke: cases, comparisons, timings, failures."""

    def __init__(self, torch, engine, ops, ref, seed: int):
        self.torch, self.engine, self.ops, self.ref = torch, engine, ops, ref
        self.seed = seed
        self.dev = torch.device("cuda")
        self.failures: list = []
        self.err = {k: 0.0 for k in SIMPLEX}
        self.rows: list = []  # per-case results

    # -- helpers ------------------------------------------------------

    def gen(self, salt: int):
        """A CUDA generator seeded from ``--seed`` and a per-input salt."""
        g = self.torch.Generator(device=self.dev)
        g.manual_seed(self.seed * 1000 + salt)
        return g

    def time_ms(self, fn, runs: int = TIMED_RUNS, warm: int = 2) -> float:
        """Median CUDA-event time of ``fn`` in ms, after ``warm`` calls."""
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def fail(self, what: str) -> None:
        """Record a failed check; the run then exits non-zero."""
        self.failures.append(what)
        _log(f"MISMATCH {what}")

    def domain_cells(self, m: int, n: int) -> int:
        """Domain elements: the inclusive triangle at m=2, else C(n+m-1, m)."""
        return math.comb(n + m - 1, m) if m > 2 else n * (n + 1) // 2

    # -- the main path: entry points + comparison with the plain version

    def main_path(self) -> None:
        """Every case through the ops entry points, each held against
        its plain version on the card."""
        torch, ops, engine = self.torch, self.ops, self.engine
        for m, cases in MAP_CASES.items():
            for nb, kinds in cases:
                for kind in kinds:
                    out = ops.map_table(nb, kind=kind, m=m)
                    torch.cuda.synchronize()
                    sched = engine.schedule_for(m, nb, kind)
                    want = engine.get_body("map").plain(sched, self.dev)
                    if not torch.equal(out, want):
                        self.fail(f"map m={m} nb={nb} kind={kind}")
                    self.rows.append(dict(test="map", m=m, n=nb, rho=1, kind=kind,
                                          split=False, steps=sched.steps))
                    del out, want
        for m, cases in DOMAIN_CASES.items():
            for n, rho, kinds in cases:
                self._accum_cases(m, n, rho, kinds)
                self._edm_cases(m, n, rho, kinds)
                if m <= 3:
                    self._ca_cases(m, n, rho, kinds)
                torch.cuda.empty_cache()
        self._edm_duplicates()
        self._accum_access()

    def variants(self, test, m, kinds):
        """``(kind, split)`` per case: every kind fused, and the composite
        kind also split into one launch per piece where ``SPLIT`` says."""
        out = [(kind, False) for kind in kinds]
        if "composite" in kinds and (test, m) in SPLIT:
            out.append(("composite", True))
        return out

    def plan(self, test, m, n, rho, kind, split) -> list:
        """The schedules one entry-point call launches, one kernel each."""
        body = self.engine.get_body(test)
        return self.engine.launch_plan(m, n // rho, kind, split, body.element_local)

    def entry(self, test, m, n, rho, kind, split, fn, *args, takes_split=False):
        """Call the entry point ``fn(*args, rho=rho, kind=kind)`` (with
        ``split=split`` when it ``takes_split``) and check it launched one
        kernel per schedule of its plan (more than one when split).

        Returns:
            ``(output, row)``: the call's output and the case's row.
        """
        body = self.engine.get_body(test)
        plan = self.plan(test, m, n, rho, kind, split)
        before = body.launches
        kw = {"split": split} if takes_split else {}
        out = fn(*args, rho=rho, kind=kind, **kw)
        self.torch.cuda.synchronize()
        what = f"{test} m={m} n={n} kind={kind} split={split}"
        if body.launches - before != len(plan) or (split and len(plan) < 2):
            self.fail(f"{what}: {body.launches - before} launches for a plan of "
                      f"{len(plan)} schedules")
        row = dict(test=test, m=m, n=n, rho=rho, kind=kind, split=split,
                   steps=sum(s.steps for s in plan))
        self.rows.append(row)
        return out, row

    def _accum_cases(self, m, n, rho, kinds):
        torch, ops, engine = self.torch, self.ops, self.engine
        x = torch.randint(0, 100, (n,) * m, generator=self.gen(1 + m), device=self.dev,
                          dtype=torch.int32)
        for kind, split in self.variants("accum", m, kinds):
            if m == 2:
                out, _ = self.entry("accum", m, n, rho, kind, split, ops.simplex_accum2d, x)
            else:
                fn = ops.simplex_accum3d if m == 3 else ops.simplex_accum_md
                out, _ = self.entry("accum", m, n, rho, kind, split, fn, x,
                                    takes_split=True)
            want = x.clone()
            engine.get_body("accum").plain_(want, engine.schedule_for(m, n // rho, kind), rho)
            if not torch.equal(out, want):
                self.fail(f"accum m={m} n={n} kind={kind} split={split}")
            del out, want

    def _accum_access(self) -> None:
        """ACCUM where ``accum.cu`` takes single elements, bit-equal to the
        plain version: rho 1 and 2 in int32 through the entry points, and
        ``engine.accum_`` in place on a view that starts 4 bytes past a
        16-byte boundary, whose neighbours must stay as they were."""
        torch, ops, engine = self.torch, self.ops, self.engine
        body = engine.get_body("accum")
        for m, n, rho in ACCUM_SCALAR_CASES:
            x = torch.randint(0, 100, (n,) * m, generator=self.gen(30 + 4 * m + rho),
                              device=self.dev, dtype=torch.int32)
            vector = engine.accum_vector_access(rho, x.element_size(), x.data_ptr())
            before = body.launches
            out = (ops.simplex_accum2d if m == 2 else ops.simplex_accum3d)(x, rho=rho,
                                                                           kind="hmap")
            torch.cuda.synchronize()
            want = x.clone()
            body.plain_(want, engine.schedule_for(m, n // rho, "hmap"), rho)
            equal = torch.equal(out, want)
            _log(f"accum check scalar path m={m} n={n} rho={rho} int32 vector={vector} "
                 f"launches={body.launches - before} equal={equal}")
            if vector or body.launches - before != 1 or not equal:
                self.fail(f"accum scalar path m={m} n={n} rho={rho}")
            del x, out, want
        n = ACCUM_MISALIGNED_N
        store = torch.randint(0, 100, (n * n + 8,), generator=self.gen(39), device=self.dev,
                              dtype=torch.int32)
        lead = (-store.data_ptr() % 16) // 4 + 1  # one element past a 16-byte boundary
        x = store[lead:lead + n * n].view(n, n)
        kept = store.clone()
        want = x.clone()
        body.plain_(want, engine.schedule_for(2, n // 16, "hmap"), 16)
        vector = engine.accum_vector_access(16, 4, x.data_ptr())
        before = body.launches
        engine.accum_(x, rho=16, kind="hmap")
        torch.cuda.synchronize()
        equal = (torch.equal(x, want) and torch.equal(store[:lead], kept[:lead])
                 and torch.equal(store[lead + n * n:], kept[lead + n * n:]))
        _log(f"accum check misaligned view m=2 n={n} rho=16 int32 data_ptr%16="
             f"{x.data_ptr() % 16} vector={vector} launches={body.launches - before} "
             f"equal={equal}")
        if vector or body.launches - before != 1 or not equal:
            self.fail(f"accum misaligned view n={n}")
        del store, kept, x, want

    def _edm_cases(self, m, n, rho, kinds):
        torch, ops, engine = self.torch, self.ops, self.engine
        p = torch.randn((n, EDM_D), generator=self.gen(10 + m), device=self.dev)
        for kind, split in self.variants("edm", m, kinds):
            if m == 2:
                out, row = self.entry("edm", m, n, rho, kind, split, ops.simplex_edm2d, p)
            else:
                out, row = self.entry("edm", m, n, rho, kind, split, ops.simplex_edm_md,
                                      p, m, takes_split=True)
            want = torch.zeros_like(out)
            engine.get_body("edm").plain_(want, p, engine.schedule_for(m, n // rho, kind), rho)
            err = (out - want).abs().max().item()
            self.err["edm"] = max(self.err["edm"], err)
            row["max_abs_err"] = err
            if not math.isfinite(err) or err > 1e-5 + 1e-5 * want.abs().max().item():
                self.fail(f"edm m={m} n={n} kind={kind} split={split} max_abs_err={err}")
            del out, want

    def _edm_duplicates(self) -> None:
        """EDM where the Gram form cancels: every fourth point repeats its
        neighbour exactly and the next one within 1e-4, at the main path's
        m=2 and m=3 sides, held to the gate of ``_edm_cases``."""
        torch, ops, engine = self.torch, self.ops, self.engine
        body = engine.get_body("edm")
        for m, n, rho, kind in EDM_DUPLICATE_CASES:
            p = torch.randn((n, EDM_D), generator=self.gen(15 + m), device=self.dev)
            p[1::4] = p[0::4]
            p[2::4] = p[0::4] + 1e-4 * torch.randn((n // 4, EDM_D), generator=self.gen(17 + m),
                                                   device=self.dev)
            before = body.launches
            out = (ops.simplex_edm2d(p, rho=rho, kind=kind) if m == 2 else
                   ops.simplex_edm_md(p, m, rho=rho, kind=kind))
            torch.cuda.synchronize()
            if body.launches - before != 1:
                self.fail(f"edm duplicates m={m}: {body.launches - before} launches, not 1")
            want = torch.zeros_like(out)
            body.plain_(want, p, engine.schedule_for(m, n // rho, kind), rho)
            err = (out - want).abs().max().item()
            tol = 1e-5 + 1e-5 * want.abs().max().item()
            self.err["edm"] = max(self.err["edm"], err)
            _log(f"edm check duplicates m={m} n={n} rho={rho} kind={kind}: "
                 f"max_abs_err={err:.3e} tol={tol:.3e}")
            if not math.isfinite(err) or err > tol:
                self.fail(f"edm duplicates m={m} n={n} kind={kind} max_abs_err={err}")
            del p, out, want

    def _ca_cases(self, m, n, rho, kinds):
        torch, ops, engine, ref = self.torch, self.ops, self.engine, self.ref
        msk = ref.simplex_mask(m, n, torch.int32, self.dev)
        s = (torch.rand((n,) * m, generator=self.gen(20 + m), device=self.dev)
             < CA_DENSITY[m]).to(torch.int32) * msk
        del msk
        fn = ops.simplex_ca2d if m == 2 else ops.simplex_ca3d
        for kind, split in self.variants("ca", m, kinds):
            out, _ = self.entry("ca", m, n, rho, kind, split, fn, s)
            want = s.clone()
            engine.get_body("ca").plain_(want, s, engine.schedule_for(m, n // rho, kind), rho)
            if not torch.equal(out, want):
                self.fail(f"ca m={m} n={n} kind={kind}")
            del out, want

    # -- timing ---------------------------------------------------------

    def bound(self, row, flops_per_s: float = TF32X3_FLOPS) -> tuple:
        """``(bound_ms, bound_by)``: the least time the card could take
        for the case's work, from its bytes and its operations at
        ``flops_per_s``: the 3xTF32 tensor-core rate by default, since
        EDM's float32-accurate dot products run there whatever implements
        them; ``F32_FLOPS`` gives the float32 CUDA-core bound."""
        test, m, n, kind = row["test"], row["m"], row["n"], row["kind"]
        if test == "map":
            nbytes = row["steps"] * (m + 1) * 4
            if kind == "table":
                nbytes += row["steps"] * m * 4
            return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
        v = self.domain_cells(m, n)
        if test in ("accum", "ca"):
            return 2 * v * 4 / HBM_BYTES_PER_S * 1e3, "bytes"
        # edm: write every domain cell, read the points.  Operations in
        # the Gram form ||a||^2 + ||b||^2 - 2 a.b: one d-wide FMA per point
        # for the norms, one d-wide dot product (FMAs) plus 3 per distinct
        # pair i < j that a domain cell holds (every pair at m=2; i + j < n
        # at m >= 3, the other coordinates 0), then the m(m-1)/2 - 1 adds
        # that sum each cell's pair distances.
        nbytes = v * 4 + n * EDM_D * 4
        if m == 2:
            pairs = n * (n - 1) // 2
        else:
            pairs = sum(max(0, n - 1 - 2 * i) for i in range(n))
        flops = n * 2 * EDM_D + pairs * (2 * EDM_D + 3) + v * (m * (m - 1) // 2 - 1)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    def timings(self) -> None:
        """Time every case's kernel, plain version and library call,
        and print one line per case."""
        torch, engine, ref = self.torch, self.engine, self.ref
        data = {}
        for row in self.rows:
            test, m, n, kind, rho = row["test"], row["m"], row["n"], row["kind"], row["rho"]
            body = engine.get_body(test)
            if test == "map":
                sched = engine.schedule_for(m, n, kind)
                row["ms"] = self.time_ms(lambda: body.kernel(sched, 128, self.dev))
                row["plain_ms"] = self.time_ms(lambda: body.plain(sched, self.dev), runs=3, warm=1)
                row["library_ms"] = None
            else:
                key = (test, m, n)
                if key not in data:
                    data.clear()
                    torch.cuda.empty_cache()
                    data[key] = self._timing_data(test, m, n)
                d = data[key]
                plan = self.plan(test, m, n, rho, kind, row["split"])
                if test == "accum":
                    buf = d["x"].clone()
                    row["ms"] = self.time_ms(
                        lambda: [body.kernel_(buf, s, rho) for s in plan])
                    row["plain_ms"] = self.time_ms(
                        lambda: [body.plain_(buf, s, rho) for s in plan], runs=3, warm=1)
                    del buf
                    msk = ref.simplex_mask(m, n, torch.bool, self.dev)
                    x = d["x"]
                    row["library_ms"] = self.time_ms(lambda: torch.where(msk, x + 1, x))
                    del msk
                elif test == "edm":
                    out = torch.zeros((n,) * m, device=self.dev)
                    p = d["p"]
                    row["ms"] = self.time_ms(
                        lambda: [body.kernel_(out, p, s, rho) for s in plan])
                    row["plain_ms"] = self.time_ms(
                        lambda: [body.plain_(out, p, s, rho) for s in plan], runs=3, warm=1)
                    del out
                    row["library_ms"] = (
                        self.time_ms(lambda: torch.cdist(p, p).tril()) if m == 2 else None
                    )
                else:
                    st = d["s"]
                    out = st.clone()
                    row["ms"] = self.time_ms(
                        lambda: [body.kernel_(out, st, s, rho) for s in plan])
                    row["plain_ms"] = self.time_ms(
                        lambda: [body.plain_(out, st, s, rho) for s in plan], runs=3, warm=1)
                    row["library_ms"] = None
                    del out
            torch.cuda.synchronize()
            row["bound_ms"], row["bound_by"] = self.bound(row)
            if test == "edm":
                row["bound_f32_ms"] = self.bound(row, F32_FLOPS)[0]
        for row in self.rows:
            bb = next(r for r in self.rows if r["test"] == row["test"] and r["m"] == row["m"]
                      and r["n"] == row["n"] and r["kind"] == "bb")
            row["bb_over_kind"] = bb["ms"] / row["ms"]
            lib = row["library_ms"]
            _log(
                f"case test={row['test']} m={row['m']} n={row['n']} rho={row['rho']} "
                f"kind={row['kind']} split={row['split']} steps={row['steps']} ms={row['ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                f"({row['bound_by']}) bound_share={row['bound_ms'] / row['ms']:.3f} "
                f"{_f32(row)}library_ms={'null' if lib is None else f'{lib:.4f}'} "
                f"bb_ms/ms={row['bb_over_kind']:.3f} "
                f"equal={'tol' if row['test'] == 'edm' else 'bit'}"
            )

    def _timing_data(self, test, m, n):
        torch, ref = self.torch, self.ref
        if test == "accum":
            return {"x": torch.randint(0, 100, (n,) * m, generator=self.gen(1 + m),
                                       device=self.dev, dtype=torch.int32)}
        if test == "edm":
            return {"p": torch.randn((n, EDM_D), generator=self.gen(10 + m), device=self.dev)}
        msk = ref.simplex_mask(m, n, torch.int32, self.dev)
        s = (torch.rand((n,) * m, generator=self.gen(20 + m), device=self.dev)
             < CA_DENSITY[m]).to(torch.int32) * msk
        return {"s": s}

    # -- oracle check on a small input ---------------------------------

    def oracle_check(self) -> None:
        """A small input through the entry points against the dense
        oracles of ``kernels/ref.py``."""
        torch, ops, ref = self.torch, self.ops, self.ref
        g = self.gen(99)
        for m, n, rho in ((2, 64, 8), (3, 32, 4)):
            msk = ref.simplex_mask(m, n, torch.bool, self.dev)
            x = torch.randint(0, 9, (n,) * m, generator=g, device=self.dev, dtype=torch.int32)
            a = ops.map_table(n // rho, m=m, kind="hmap" if m == 2 else "octant")
            acc = (ops.simplex_accum2d if m == 2 else ops.simplex_accum3d)(x, rho=rho,
                                                                           kind="hmap")
            want = ref.accum_md(x)
            if not (torch.equal(acc[msk], want[msk]) and torch.equal(acc[~msk], x[~msk])):
                self.fail(f"oracle accum m={m}")
            s = (x > 5).to(torch.int32) * msk
            st = (ops.simplex_ca2d if m == 2 else ops.simplex_ca3d)(s, rho=rho, kind="hmap")
            want = ref.ca2d_step(s) if m == 2 else ref.ca3d_step(s)
            if not torch.equal(st[msk], want[msk]):
                self.fail(f"oracle ca m={m}")
            p = torch.randn((n, 5), generator=g, device=self.dev)
            e = (ops.simplex_edm2d(p, rho=rho, kind="hmap") if m == 2 else
                 ops.simplex_edm3d(p, rho=rho, kind="hmap"))
            if not (torch.isfinite(e).all() and
                    torch.allclose(e, ref.edm_md(p, m), rtol=1e-5, atol=1e-5)):
                self.fail(f"oracle edm m={m}")
            blocks = {tuple(r) for r in a[a[:, -1] == 1, :-1].tolist()}
            if len(blocks) != math.comb(n // rho + m - 1, m):
                self.fail(f"oracle map m={m}: valid steps do not cover the simplex")
        torch.cuda.synchronize()


class LegacySmoke:
    """The frozen 2-D originals on the card: each against its plain
    version and against the engine kernel of the same kind, then timed.

    Shares the simplex ``Smoke``'s generators, timer, bounds and failure
    list.
    """

    def __init__(self, smoke: Smoke, legacy):
        self.s, self.legacy = smoke, legacy
        self.torch = smoke.torch
        self.err = {k: 0.0 for k in LEGACY}
        self.rows: list = []
        self.data: dict = {}

    def call(self, name, kind, fn, *args, **kw):
        """One legacy entry point; it must launch its kernel exactly once."""
        k = getattr(self.legacy, name.upper())
        before = k.launches
        out = fn(*args, kind=kind, **kw)
        self.torch.cuda.synchronize()
        if k.launches - before != 1:
            self.s.fail(f"legacy {name} kind={kind}: {k.launches - before} launches, not 1")
        return out

    def compare(self, name, kind, what, got, want) -> None:
        """Integers bit-equal; EDM within ``1e-5 + 1e-5 * max|want|``."""
        if name != "edm2d":
            if not self.torch.equal(got, want):
                self.s.fail(f"legacy {name} kind={kind} against {what}")
            return
        err = (got - want).abs().max().item()
        tol = 1e-5 + 1e-5 * want.abs().max().item()
        _log(f"legacy check edm2d kind={kind} against {what}: max_abs_err={err:.3e} "
             f"tol={tol:.3e}")
        if what == "plain version":
            self.err[name] = max(self.err[name], err)
        if not math.isfinite(err) or err > tol:
            self.s.fail(f"legacy edm2d kind={kind} against {what}: max_abs_err={err} > {tol}")

    def path(self) -> None:
        """Every legacy kernel at every kind through its entry point."""
        torch, L, ops, dev = self.torch, self.legacy, self.s.ops, self.s.dev
        n, rho, nb = LEGACY_N, LEGACY_RHO, LEGACY_MAP_NB
        d = self.data
        d["x"] = torch.randint(0, 100, (n, n), generator=self.s.gen(31), device=dev,
                               dtype=torch.int32)
        d["p"] = torch.randn((n, EDM_D), generator=self.s.gen(32), device=dev)
        # Not masked to the triangle: the halo mask must drop live cells above it.
        d["s"] = (torch.rand((n, n), generator=self.s.gen(33), device=dev)
                  < CA_DENSITY[2]).to(torch.int32)
        for kind in LEGACY_KINDS:
            sched = L._schedule(2, nb, kind)
            out = self.call("map2d", kind, L.map2d, nb)
            self.compare("map2d", kind, "plain version", out, L.MAP2D.plain(sched, 128, dev))
            self.compare("map2d", kind, "engine", out, ops.map_table(nb, kind=kind, m=2))
            self.rows.append(dict(name="map2d", kind=kind, steps=sched.steps))
            del out
            sched = L._schedule(2, n // rho, kind)
            for name, arg, engine_fn in (("accum2d", "x", ops.simplex_accum2d),
                                         ("edm2d", "p", ops.simplex_edm2d),
                                         ("ca2d", "s", ops.simplex_ca2d)):
                out = self.call(name, kind, getattr(L, name), d[arg], rho=rho)
                want = self.plain(name, sched)
                self.compare(name, kind, "plain version", out, want)
                del want
                self.compare(name, kind, "engine", out, engine_fn(d[arg], rho=rho, kind=kind))
                self.rows.append(dict(name=name, kind=kind, steps=sched.steps))
                del out
                torch.cuda.empty_cache()
        self.grid_loop()
        self.edm_odd()
        self.access()

    def access(self) -> None:
        """``accum2d`` and ``ca2d`` off the main case (``LEGACY2D_SCALAR``,
        ``LEGACY2D_MISALIGNED``, the dtype and CA cases above), each bit-equal
        to its plain version; ``legacy check`` lines."""
        torch, L, dev = self.torch, self.legacy, self.s.dev
        for n, rho in LEGACY2D_SCALAR:
            x = torch.randint(0, 100, (n, n), generator=self.s.gen(35), device=dev,
                              dtype=torch.int32)
            st = (torch.rand((n, n), generator=self.s.gen(36), device=dev)
                  < CA_DENSITY[2]).to(torch.int32)
            for kind in LEGACY_KINDS:
                what = f"scalar path n={n} rho={rho} kind={kind} int32"
                self.case2d("accum2d", x, rho, kind, what, vector=False)
                self.case2d("ca2d", st, rho, kind, what, vector=False)
            del x, st
        n, rho = LEGACY2D_MISALIGNED
        store = torch.randint(0, 100, (n * n + 8,), generator=self.s.gen(37), device=dev,
                              dtype=torch.int32)
        lead = (-store.data_ptr() % 16) // 4 + 1  # one element past a 16-byte boundary
        x = store[lead:lead + n * n].view(n, n)
        kept = store.clone()
        want = x.clone()
        sched = L._schedule(2, n // rho, "hmap")
        L.ACCUM2D.plain_(want, sched, rho)
        vector = L.legacy_vector_access(rho, 4, x.data_ptr())
        before = L.ACCUM2D.launches
        L.ACCUM2D.kernel_(x, sched, rho)
        torch.cuda.synchronize()
        equal = (torch.equal(x, want) and torch.equal(store[:lead], kept[:lead])
                 and torch.equal(store[lead + n * n:], kept[lead + n * n:]))
        _log(f"legacy check accum2d misaligned view n={n} rho={rho} int32 "
             f"data_ptr%16={x.data_ptr() % 16} vector={vector} "
             f"launches={L.ACCUM2D.launches - before} equal={equal}")
        if vector or L.ACCUM2D.launches - before != 1 or not equal:
            self.s.fail(f"legacy accum2d misaligned view n={n} rho={rho}")
        del store, x, kept, want
        n = LEGACY2D_DTYPE_N
        for dt_name, edges in {**DTYPE_EDGES, **LEGACY_MD_EDGES}.items():
            dt = getattr(torch, dt_name)
            x = torch.randint(0, 100, (n, n), generator=self.s.gen(38), device=dev,
                              dtype=torch.int64)
            x = x.to(torch.float64) if dt.is_floating_point else x
            flat = x.view(-1)
            flat[::3] = torch.tensor(edges, dtype=x.dtype, device=dev)[
                torch.arange(flat[::3].numel(), device=dev) % len(edges)]
            x = x.to(dt)
            for rho in LEGACY2D_DTYPE_RHOS:
                for kind in LEGACY_KINDS:
                    self.case2d("accum2d", x, rho, kind, f"dtype {dt_name} n={n} rho={rho} "
                                f"kind={kind}", vector=(rho * x.element_size()) % 16 == 0)
            del x, flat
        for n, rho, dt_name in LEGACY_CA2D_BUDGET:
            st = (torch.rand((n, n), generator=self.s.gen(39), device=dev)
                  < CA_DENSITY[2]).to(getattr(torch, dt_name))
            warps = L.CA2D.layout(rho, st.element_size(), True)["warps"]
            for kind in LEGACY_KINDS:
                self.case2d("ca2d", st, rho, kind, f"n={n} rho={rho} kind={kind} {dt_name} "
                            f"warps={warps}", vector=True)
            if warps == L.CA2D.WARPS:
                self.s.fail(f"legacy ca2d rho={rho} {dt_name}: the budget cut no warps")
            del st
        n, rho = LEGACY_CA2D_CORNERS
        for salt in (40, 41):
            st = (torch.rand((n, n), generator=self.s.gen(salt), device=dev) < 0.5).to(torch.int32)
            for kind in LEGACY_KINDS:
                self.case2d("ca2d", st, rho, kind, f"corners n={n} rho={rho} kind={kind} "
                            f"seed {salt}", vector=True)
        n = LEGACY_CA2D_TYPES_N
        st = torch.randint(-128, 128, (n, n), generator=self.s.gen(42), device=dev)
        small = torch.randint(0, 2, (n, n), generator=self.s.gen(43), device=dev)
        # half the cells 0/1, so that some counts wrap to 2 or 3
        half = torch.rand((n, n), generator=self.s.gen(44), device=dev) < 0.5
        st = torch.where(half, small, st).to(torch.int8)
        for rho in LEGACY_CA2D_INT8_RHOS:
            self.case2d("ca2d", st, rho, "hmap", f"n={n} rho={rho} kind=hmap int8 any values",
                        vector=rho == 16)
        for dt_name in ("int8", "uint8", "int16", "int32", "int64", "bfloat16", "float16",
                        "float32"):
            st = (torch.rand((n, n), generator=self.s.gen(45), device=dev)
                  < CA_DENSITY[2]).to(getattr(torch, dt_name))
            for kind in LEGACY_KINDS:
                self.case2d("ca2d", st, 16, kind, f"n={n} rho=16 kind={kind} {dt_name} 0/1",
                            vector=True)
            del st
        torch.cuda.empty_cache()

    def case2d(self, name, arg, rho, kind, what, vector) -> None:
        """One ``accum2d`` or ``ca2d`` entry-point call: one launch, the
        access path ``vector`` by the host's rule, bit-equal to the plain
        version and to the engine twin of the same kind."""
        torch, L, ops = self.torch, self.legacy, self.s.ops
        k = getattr(L, name.upper())
        sched = L._schedule(2, arg.shape[0] // rho, kind)
        before = k.launches
        out = getattr(L, name)(arg, rho=rho, kind=kind)
        torch.cuda.synchronize()
        launches = k.launches - before
        want = arg.clone()
        if name == "accum2d":
            rule = L.legacy_vector_access(rho, arg.element_size(), out.data_ptr())
            k.plain_(want, sched, rho)
            engine = ops.simplex_accum2d(arg, rho=rho, kind=kind)
        else:
            rule = k.vector_access(rho, arg.element_size(), out.data_ptr(), arg.data_ptr())
            k.plain_(want, arg, sched, rho)
            engine = ops.simplex_ca2d(arg, rho=rho, kind=kind)
        equal = out.dtype == want.dtype and torch.equal(out, want)
        engine = torch.equal(out, engine)
        _log(f"legacy check {name} {what} vector={rule} launches={launches} "
             f"equal={equal} engine={engine}")
        if rule is not vector or launches != 1 or not equal or not engine:
            self.s.fail(f"legacy {name} {what}")
        del out, want

    def edm_odd(self) -> None:
        """``edm2d`` at ``LEGACY_EDM_ODD``: d not a multiple of 4 (single
        floats staged, the rows padded with zeros) and rho not a multiple
        of a thread's 4 x 4 cells, against its plain version for every
        kind, one launch each."""
        torch, L = self.torch, self.legacy
        n, rho, d = LEGACY_EDM_ODD
        p = torch.randn((n, d), generator=self.s.gen(34), device=self.s.dev)
        for kind in LEGACY_KINDS:
            out = self.call("edm2d", kind, L.edm2d, p, rho=rho)
            want = torch.zeros_like(out)
            L.EDM2D.plain_(want, p, L._schedule(2, n // rho, kind), rho)
            err = (out - want).abs().max().item()
            tol = 1e-5 + 1e-5 * want.abs().max().item()
            vec = L.legacy_vector_access(d, 4, p.data_ptr())
            _log(f"legacy check edm2d n={n} rho={rho} d={d} kind={kind} vector={vec}: "
                 f"max_abs_err={err:.3e} tol={tol:.3e}")
            self.err["edm2d"] = max(self.err["edm2d"], err)
            if vec or not math.isfinite(err) or err > tol:
                self.s.fail(f"legacy edm2d n={n} rho={rho} d={d} kind={kind}: "
                            f"max_abs_err={err} > {tol} or vector={vec}")
            del out, want
        torch.cuda.empty_cache()

    def grid_loop(self) -> None:
        """``accum2d`` at n = 65536, rho = 1: the hmap grid is
        (32768, 65537), taller than the 65535 blocks ``gridDim.y`` allows,
        so blocks loop over ``wy``.  On zeros, row r must hold ones in
        exactly columns 0..r: r+1 ones whose column indices sum to
        r(r+1)/2, the least any r+1 distinct columns can sum to."""
        torch, dev = self.torch, self.s.dev
        n = 65536
        x = torch.zeros((n, n), dtype=torch.int32, device=dev)
        out = self.call("accum2d", "hmap", self.legacy.accum2d, x, rho=1)
        del x
        cols = torch.arange(n, device=dev)
        ok = int(out.min()) == 0 and int(out.max()) == 1
        for r0 in range(0, n, 4096):
            blk = out[r0:r0 + 4096].to(torch.int64)
            rows = cols[r0:r0 + 4096]
            ok = ok and torch.equal(blk.sum(1), rows + 1) and torch.equal(
                (blk * cols).sum(1), rows * (rows + 1) // 2)
        _log(f"legacy check accum2d n={n} rho=1 grid (32768, 65537): triangle exact={ok}")
        if not ok:
            self.s.fail("legacy accum2d n=65536 rho=1: the gridDim.y loop missed cells")
        del out, blk
        torch.cuda.empty_cache()

    def plain(self, name, sched):
        """The plain version's output on the phase's input."""
        k, d, rho = getattr(self.legacy, name.upper()), self.data, LEGACY_RHO
        if name == "accum2d":
            out = d["x"].clone()
            k.plain_(out, sched, rho)
        elif name == "edm2d":
            out = self.torch.zeros((LEGACY_N, LEGACY_N), device=self.s.dev)
            k.plain_(out, d["p"], sched, rho)
        else:
            out = d["s"].clone()
            k.plain_(out, d["s"], sched, rho)
        return out

    def timings(self) -> None:
        """Kernel, plain version and library call per (kernel, kind)."""
        torch, L, d, rho = self.torch, self.legacy, self.data, LEGACY_RHO
        n = LEGACY_N
        msk = torch.ones((n, n), dtype=torch.bool, device=self.s.dev).tril_()
        x, p, st = d["x"], d["p"], d["s"]
        lib = {"map2d": None, "ca2d": None,
               "accum2d": self.s.time_ms(lambda: torch.where(msk, x + 1, x)),
               "edm2d": self.s.time_ms(lambda: torch.cdist(p, p).tril())}
        del msk
        for row in self.rows:
            name, kind = row["name"], row["kind"]
            if name == "map2d":
                sched = L._schedule(2, LEGACY_MAP_NB, kind)
                row["ms"] = self.s.time_ms(lambda: L.MAP2D.kernel(sched, 128, self.s.dev))
                row["plain_ms"] = self.s.time_ms(lambda: L.MAP2D.plain(sched, 128, self.s.dev),
                                                 runs=2, warm=0)
                row["bound_ms"], row["bound_by"] = self.s.bound(
                    dict(test="map", m=2, n=LEGACY_MAP_NB, kind=kind, steps=row["steps"]))
            else:
                sched = L._schedule(2, n // rho, kind)
                k = getattr(L, name.upper())
                if name == "accum2d":
                    buf = x.clone()
                    row["ms"] = self.s.time_ms(lambda: k.kernel_(buf, sched, rho))
                elif name == "edm2d":
                    buf = torch.zeros((n, n), device=self.s.dev)
                    row["ms"] = self.s.time_ms(lambda: k.kernel_(buf, p, sched, rho))
                else:
                    buf = st.clone()
                    row["ms"] = self.s.time_ms(lambda: k.kernel_(buf, st, sched, rho))
                del buf
                row["plain_ms"] = self.s.time_ms(lambda: self.plain(name, sched), runs=2,
                                                 warm=0)
                case = dict(test=LEGACY[name], m=2, n=n, kind=kind, steps=row["steps"])
                row["bound_ms"], row["bound_by"] = self.s.bound(case)
                if name == "edm2d":
                    row["bound_f32_ms"] = self.s.bound(case, F32_FLOPS)[0]
                    # the direct-difference form edm2d computes: a subtract
                    # and a multiply-add a coordinate and domain pair, each
                    # a lane operation, at half the FLOP rate
                    row["bound_direct_ms"] = (n * (n + 1) // 2 * 2 * EDM_D
                                              / (F32_FLOPS / 2) * 1e3)
            row["library_ms"] = lib[name]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        for row in self.rows:
            bb = next(r for r in self.rows if r["name"] == row["name"] and r["kind"] == "bb")
            lib_ms = row["library_ms"]
            _log(f"case test={row['name']} m=2 n={LEGACY_MAP_NB if row['name'] == 'map2d' else n} "
                 f"rho={1 if row['name'] == 'map2d' else rho} kind={row['kind']} "
                 f"steps={row['steps']} ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                 f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                 f"bound_share={row['bound_ms'] / row['ms']:.3f} {_f32(row)}"
                 f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                 f"bb_ms/ms={bb['ms'] / row['ms']:.3f} "
                 f"equal={'tol' if row['name'] == 'edm2d' else 'bit'}")
        self.data.clear()
        torch.cuda.empty_cache()


class LegacyMdSmoke:
    """The frozen m >= 3 originals on the card: each against its plain
    version and against the engine kernel of the same kind and split,
    then timed beside that engine twin.

    Shares the simplex ``Smoke``'s generators, timer, bounds and failure
    list.
    """

    def __init__(self, smoke: Smoke, legacy):
        self.s, self.legacy = smoke, legacy
        self.torch = smoke.torch
        self.rows: list = []

    def kernel(self, name):
        """The legacy kernel object of ``name`` (its counter, kernel_, plain_)."""
        return getattr(self.legacy, name.upper())

    def variants(self, name, kinds):
        """``(kind, split)`` per case: every kind fused, the composite kind
        also one launch per piece (never for ``ca3d``)."""
        out = [(kind, False) for kind in kinds]
        if "composite" in kinds and name != "ca3d":
            out.append(("composite", True))
        return out

    def data(self, m, n):
        """The inputs at ``(m, n)``: an int32 cube, and at m=3 a 0/1 state
        of density ``CA_DENSITY[3]`` over the whole cube (not masked:
        live cells above the tetrahedron must not count)."""
        torch, dev = self.torch, self.s.dev
        d = {"x": torch.randint(0, 100, (n,) * m, generator=self.s.gen(50 + m),
                                device=dev, dtype=torch.int32)}
        if m == 3:
            d["s"] = (torch.rand((n,) * m, generator=self.s.gen(53), device=dev)
                      < CA_DENSITY[3]).to(torch.int32)
        return d

    def plain(self, name, d, plan, rho):
        """The plain version's output over every schedule of the plan."""
        k = self.kernel(name)
        if name == "ca3d":
            out = d["s"].clone()
            for sched in plan:
                k.plain_(out, d["s"], sched, rho)
        else:
            out = d["x"].clone()
            for sched in plan:
                k.plain_(out, sched, rho)
        return out

    def path(self) -> None:
        """Every legacy m >= 3 kernel at every kind and size through its
        entry point."""
        torch, L, ops = self.torch, self.legacy, self.s.ops
        for m, cases in LEGACY_MD_CASES.items():
            names = ("accum3d", "accum_md", "ca3d") if m == 3 else ("accum_md",)
            for n, rho, kinds in cases:
                d = self.data(m, n)
                for name in names:
                    for kind, split in self.variants(name, kinds):
                        self.case(name, m, n, rho, kind, split, d, getattr(ops, LEGACY_MD[name]))
                        torch.cuda.empty_cache()
                del d
                torch.cuda.empty_cache()
        self.access()
        self.ca_access()

    def ca_access(self) -> None:
        """``ca3d`` off the main case: ``LEGACY_CA3D_CASES`` on 0/1 int32
        states over the whole cube, then int8 states of any value."""
        torch, dev = self.torch, self.s.dev
        for n, rho, kind in LEGACY_CA3D_CASES:
            st = (torch.rand((n,) * 3, generator=self.s.gen(63), device=dev)
                  < CA_DENSITY[3]).to(torch.int32)
            self.ca_case(st, rho, kind, f"m=3 n={n} rho={rho} kind={kind} int32")
            del st
            torch.cuda.empty_cache()
        n = LEGACY_CA3D_INT8_N
        st = torch.randint(-128, 128, (n,) * 3, generator=self.s.gen(64), device=dev)
        small = torch.randint(0, 2, (n,) * 3, generator=self.s.gen(65), device=dev)
        # half the cells 0/1, so that some counts wrap to 2 or 3
        half = torch.rand((n,) * 3, generator=self.s.gen(66), device=dev) < 0.5
        st = torch.where(half, small, st).to(torch.int8)
        for rho in LEGACY_CA3D_INT8_RHOS:
            self.ca_case(st, rho, "hmap", f"m=3 n={n} rho={rho} kind=hmap int8 any values")

    def ca_case(self, st, rho, kind, what) -> None:
        """One ``ca3d`` call: one launch, the access path by
        ``CA3D.vector_access``, bit-equal to its plain version and to the
        engine's ``simplex_ca3d``."""
        torch, L = self.torch, self.legacy
        k = L.CA3D
        before = k.launches
        out = L.ca3d(st, rho=rho, kind=kind)
        torch.cuda.synchronize()
        launches = k.launches - before
        rule = k.vector_access(rho, st.element_size(), out.data_ptr(), st.data_ptr())
        want = st.clone()
        k.plain_(want, st, L._schedule(3, st.shape[0] // rho, kind), rho)
        equal = torch.equal(out, want)
        del want
        engine = torch.equal(out, self.s.ops.simplex_ca3d(st, rho=rho, kind=kind))
        _log(f"legacy_md check ca3d {what} vector={rule} launches={launches} "
             f"equal={equal} engine={engine}")
        if (rule is not ((rho * st.element_size()) % 16 == 0) or launches != 1 or not equal
                or not engine):
            self.s.fail(f"legacy ca3d {what}")
        del out

    def access(self) -> None:
        """The ACCUM originals off their 16-byte pieces and in every element
        type, each bit-equal to its plain version: ``accum3d`` and
        ``accum_md`` on the scalar path (``LEGACY_MD_SCALAR``), ``kernel_``
        of each in place on a view 4 bytes past a 16-byte boundary, whose
        neighbours must stay as they were, and ``accum3d`` in every ACCUM
        dtype with values at the type's edge."""
        torch, L, dev = self.torch, self.legacy, self.s.dev
        m, n, rho = LEGACY_MD_SCALAR
        x = torch.randint(0, 100, (n,) * m, generator=self.s.gen(60), device=dev,
                          dtype=torch.int32)
        for name in ("accum3d", "accum_md"):
            self.entry_case(name, x, rho, f"scalar path m={m} n={n} rho={rho} int32",
                            vector=False)
        del x
        n, rho = LEGACY_MD_MISALIGNED
        store = torch.randint(0, 100, (n**3 + 8,), generator=self.s.gen(61), device=dev,
                              dtype=torch.int32)
        lead = (-store.data_ptr() % 16) // 4 + 1  # one element past a 16-byte boundary
        sched = L._schedule(3, n // rho, "hmap")
        for name in ("accum3d", "accum_md"):
            k = self.kernel(name)
            x = store[lead:lead + n**3].view(n, n, n)
            kept = store.clone()
            want = x.clone()
            k.plain_(want, sched, rho)
            vector = L.legacy_vector_access(rho, 4, x.data_ptr())
            before = k.launches
            k.kernel_(x, sched, rho)
            torch.cuda.synchronize()
            equal = (torch.equal(x, want) and torch.equal(store[:lead], kept[:lead])
                     and torch.equal(store[lead + n**3:], kept[lead + n**3:]))
            _log(f"legacy_md check {name} misaligned view m=3 n={n} rho={rho} int32 "
                 f"data_ptr%16={x.data_ptr() % 16} vector={vector} "
                 f"launches={k.launches - before} equal={equal}")
            if vector or k.launches - before != 1 or not equal:
                self.s.fail(f"legacy {name} misaligned view n={n} rho={rho}")
            del x, kept, want
        del store
        n = LEGACY_MD_DTYPE_N
        for dt_name, edges in {**DTYPE_EDGES, **LEGACY_MD_EDGES}.items():
            dt = getattr(torch, dt_name)
            x = torch.randint(0, 100, (n,) * 3, generator=self.s.gen(62), device=dev,
                              dtype=torch.int64)
            x = x.to(torch.float64) if dt.is_floating_point else x
            flat = x.view(-1)
            flat[::3] = torch.tensor(edges, dtype=x.dtype, device=dev)[
                torch.arange(flat[::3].numel(), device=dev) % len(edges)]
            x = x.to(dt)
            for rho in LEGACY_MD_DTYPE_RHOS:
                vector = (rho * x.element_size()) % 16 == 0
                self.entry_case("accum3d", x, rho, f"dtype {dt_name} m=3 n={n} rho={rho}",
                                vector=vector)
            del x, flat
        torch.cuda.empty_cache()

    def entry_case(self, name, x, rho, what, vector) -> None:
        """One ``kind='hmap'`` entry-point call on ``x``: one launch, the
        access path ``vector`` by the host's rule, bit-equal to the plain
        version."""
        torch, L = self.torch, self.legacy
        k = self.kernel(name)
        m, n = x.ndim, x.shape[0]
        plan = L._launch_plan(m, n // rho, "hmap")
        rule = L.legacy_vector_access(rho, x.element_size(), x.data_ptr())
        before = k.launches
        out = getattr(L, name)(x, rho=rho, kind="hmap")
        torch.cuda.synchronize()
        want = x.clone()
        for sched in plan:
            k.plain_(want, sched, rho)
        equal = out.dtype == want.dtype and torch.equal(out, want)
        _log(f"legacy_md check {name} {what} vector={rule} "
             f"launches={k.launches - before} equal={equal}")
        if (rule is not vector or k.launches - before != len(plan) or len(plan) != 1
                or not equal):
            self.s.fail(f"legacy {name} {what}")

    def case(self, name, m, n, rho, kind, split, d, engine_fn) -> None:
        """One entry-point call: launches per the plan, then bit-equal to
        the plain version and to the engine twin."""
        torch, L = self.torch, self.legacy
        k = self.kernel(name)
        plan = L._launch_plan(m, n // rho, kind, split) if name != "ca3d" else [
            L._schedule(m, n // rho, kind)]
        kw = {} if name == "ca3d" else {"split": split}
        arg = d["s"] if name == "ca3d" else d["x"]
        before = k.launches
        out = getattr(L, name)(arg, rho=rho, kind=kind, **kw)
        torch.cuda.synchronize()
        what = f"legacy {name} m={m} n={n} kind={kind} split={split}"
        if k.launches - before != len(plan) or (split and len(plan) < 2):
            self.s.fail(f"{what}: {k.launches - before} launches for a plan of "
                        f"{len(plan)} schedules")
        want = self.plain(name, d, plan, rho)
        if not torch.equal(out, want):
            self.s.fail(f"{what} against the plain version")
        del want
        if not torch.equal(out, engine_fn(arg, rho=rho, kind=kind, **kw)):
            self.s.fail(f"{what} against the engine")
        del out
        self.rows.append(dict(name=name, m=m, n=n, rho=rho, kind=kind, split=split,
                              steps=sum(s.steps for s in plan)))

    def timings(self) -> None:
        """Kernel, engine twin, plain version and library call per case."""
        torch, L, E, ref = self.torch, self.legacy, self.s.engine, self.s.ref
        data, lib = {}, {}
        for row in self.rows:
            name, m, n, rho, kind, split = (row[k] for k in
                                            ("name", "m", "n", "rho", "kind", "split"))
            if (m, n) not in data:
                data.clear()
                torch.cuda.empty_cache()
                data[(m, n)] = self.data(m, n)
                msk = ref.simplex_mask(m, n, torch.bool, self.s.dev)
                x = data[(m, n)]["x"]
                lib[(m, n)] = self.s.time_ms(lambda: torch.where(msk, x + 1, x))
                del msk, x
            d = data[(m, n)]
            k = self.kernel(name)
            test = "ca" if name == "ca3d" else "accum"
            body = E.get_body(test)
            if name == "ca3d":
                plan = [L._schedule(m, n // rho, kind)]
                eplan = E.launch_plan(m, n // rho, kind, None, False)
                st = d["s"]
                buf = st.clone()
                row["ms"] = self.s.time_ms(lambda: [k.kernel_(buf, st, s, rho) for s in plan])
                row["engine_ms"] = self.s.time_ms(
                    lambda: [body.kernel_(buf, st, s, rho) for s in eplan])
                row["plain_ms"] = self.s.time_ms(lambda: self.plain(name, d, plan, rho),
                                                 runs=1, warm=0)
                row["library_ms"] = None
            else:
                plan = L._launch_plan(m, n // rho, kind, split)
                eplan = E.launch_plan(m, n // rho, kind, split, True)
                buf = d["x"].clone()
                row["ms"] = self.s.time_ms(lambda: [k.kernel_(buf, s, rho) for s in plan])
                row["engine_ms"] = self.s.time_ms(
                    lambda: [body.kernel_(buf, s, rho) for s in eplan])
                row["plain_ms"] = self.s.time_ms(lambda: self.plain(name, d, plan, rho),
                                                 runs=3, warm=1)
                row["library_ms"] = lib[(m, n)]
            del buf
            torch.cuda.synchronize()
            row["bound_ms"], row["bound_by"] = self.s.bound(
                dict(test=test, m=m, n=n, kind=kind, steps=row["steps"]))
        data.clear()
        torch.cuda.empty_cache()
        for row in self.rows:
            bb = next(r for r in self.rows if r["name"] == row["name"] and r["m"] == row["m"]
                      and r["n"] == row["n"] and r["kind"] == "bb")
            lib_ms = row["library_ms"]
            _log(f"case test={row['name']} m={row['m']} n={row['n']} rho={row['rho']} "
                 f"kind={row['kind']} split={row['split']} steps={row['steps']} "
                 f"ms={row['ms']:.4f} engine_ms={row['engine_ms']:.4f} "
                 f"engine/legacy={row['engine_ms'] / row['ms']:.3f} "
                 f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                 f"({row['bound_by']}) bound_share={row['bound_ms'] / row['ms']:.3f} "
                 f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                 f"bb_ms/ms={bb['ms'] / row['ms']:.3f} equal=bit")


class MxuSmoke:
    """The tensor-core H map on the card: the whole hmap2 grid of
    ``MXU_NB`` tiles a side against the plain version and against
    ``rho * hmap2(wx, wy)`` in int64, a case above 2^24 against int64
    arithmetic, then timed.

    Shares the simplex ``Smoke``'s generators, timer and failure list.
    """

    def __init__(self, smoke: Smoke, mxu, hmap):
        self.s, self.mxu, self.hmap = smoke, mxu, hmap
        self.torch = smoke.torch
        self.row: dict = {}

    def grid(self):
        """``(T, 2)`` int32 ``(wx, wy)``: wx < nb/2, 1 <= wy < nb."""
        torch, dev, nb = self.torch, self.s.dev, MXU_NB
        wy, wx = torch.meshgrid(torch.arange(1, nb, device=dev),
                                torch.arange(nb // 2, device=dev), indexing="ij")
        return torch.stack([wx.reshape(-1), wy.reshape(-1)], 1).to(torch.int32)

    def int64(self, wxy, rho):
        """The map in int64 arithmetic, ``b`` at ``max(wy, 1)``."""
        torch = self.torch
        wx, wy = wxy[:, 0].to(torch.int64), wxy[:, 1].to(torch.int64)
        b = self.hmap.pow2_floor(wy.clamp(min=1))
        qb = (wx // b) * b
        return torch.stack([rho * (wx + qb), rho * (wy + 2 * qb)], 1)

    def call(self, what, wxy, rho):
        """One entry-point call; it must launch its kernel exactly once."""
        k = self.mxu.HMAP_MXU
        before = k.launches
        out = self.mxu.hmap2_coords_mxu(wxy, rho=rho)
        self.torch.cuda.synchronize()
        if k.launches - before != 1:
            self.s.fail(f"hmap_mxu {what}: {k.launches - before} launches, not 1")
        return out

    def path(self) -> None:
        """The full grid and the case above 2^24."""
        torch, rho = self.torch, MXU_RHO
        wxy = self.grid()
        out = self.call("full grid", wxy, rho)
        if not torch.equal(out, self.mxu.HMAP_MXU.plain(wxy, rho)):
            self.s.fail(f"hmap_mxu nb={MXU_NB} against the plain version")
        wx, wy = wxy[:, 0].to(torch.int64), wxy[:, 1].to(torch.int64)
        x, y = self.hmap.hmap2(wx, wy)
        del wx, wy
        ok = torch.equal(out[:, 0].to(torch.int64), rho * x) and torch.equal(
            out[:, 1].to(torch.int64), rho * y)
        del x, y
        _log(f"mxu check nb={MXU_NB} T={len(wxy)} rho={rho}: equal to rho*hmap2 in "
             f"int64={ok}, max x={int(out[:, 0].max())} max y={int(out[:, 1].max())}")
        if not ok:
            self.s.fail(f"hmap_mxu nb={MXU_NB} against rho*hmap2(wx, wy) in int64")
        self.row = dict(steps=len(wxy))
        del out, wxy
        torch.cuda.empty_cache()
        # Outputs between 2^24 and 2^31, where float32 rounds; some rows of wy = 0.
        g = self.s.gen(90)
        big = torch.randint(1 << 24, 1 << 29, (4096, 2), generator=g, device=self.s.dev,
                            dtype=torch.int32)
        big[::5, 1] = 0
        out = self.call("above 2^24", big, 1)
        ok = torch.equal(out.to(torch.int64), self.int64(big, 1))
        _log(f"mxu check above 2^24: T=4096 max output {int(out.max())}, equal to int64 "
             f"arithmetic={ok}")
        if not ok:
            self.s.fail("hmap_mxu above 2^24 against int64 arithmetic")
        for i, (label, t, lead, wxs, wys, r) in enumerate(MXU_EDGES):
            self.edge(91 + i, label, t, lead, wxs, wys, r)

    def edge(self, salt, label, t, lead, wxs, wys, rho) -> None:
        """One of ``MXU_EDGES``: ``T`` random blocks, the input ``lead``
        bytes past a 16-byte boundary, every tenth ``wy`` at 0."""
        torch, dev = self.torch, self.s.dev
        g = self.s.gen(salt)
        store = torch.empty(t + 2, 2, dtype=torch.int32, device=dev)
        wxy = store[lead // 8:lead // 8 + t]
        wxy[:, 0] = torch.randint(*wxs, (t,), generator=g, device=dev, dtype=torch.int32)
        wxy[:, 1] = torch.randint(*wys, (t,), generator=g, device=dev, dtype=torch.int32)
        wxy[::10, 1] = 0
        out = self.call(label, wxy, rho)
        plain = torch.equal(out, self.mxu.HMAP_MXU.plain(wxy, rho))
        want = self.int64(wxy, rho)
        exact = torch.equal(out, ((want + 2**31) % 2**32 - 2**31).to(torch.int32))  # wrapped
        _log(f"mxu check {label}: T={t} input {wxy.data_ptr() % 16} bytes past 16, "
             f"rho={rho}, min wx {int(wxy[:, 0].min())}, min wy {int(wxy[:, 1].min())}: "
             f"equal to the plain version={plain}, to int64 arithmetic={exact}")
        if not (plain and exact):
            self.s.fail(f"hmap_mxu {label} against the plain version or int64 arithmetic")

    def timings(self) -> None:
        """Kernel and plain version on the full grid; the bound is 16 bytes
        a block (8 read, 8 written)."""
        torch, rho = self.torch, MXU_RHO
        wxy = self.grid()
        k = self.mxu.HMAP_MXU
        self.row["ms"] = self.s.time_ms(lambda: k.kernel(wxy, rho))
        dst = torch.empty_like(wxy)
        copy_ms = self.s.time_ms(lambda: dst.copy_(wxy))
        del dst
        _log(f"mxu copy nb={MXU_NB}: one copy_ of the same {2 * wxy.numel() * 4} bytes "
             f"ms={copy_ms:.4f}, the kernel's ms over it {self.row['ms'] / copy_ms:.3f}")
        self.row["plain_ms"] = self.s.time_ms(lambda: k.plain(wxy, rho), runs=3, warm=1)
        self.row["bound_ms"] = len(wxy) * 16 / HBM_BYTES_PER_S * 1e3
        self.row["bound_by"] = "bytes"
        self.row["library_ms"] = None  # no one PyTorch call computes qb and the product
        del wxy
        torch.cuda.empty_cache()
        r = self.row
        _log(f"case test=hmap_mxu nb={MXU_NB} rho={rho} steps={r['steps']} ms={r['ms']:.4f} "
             f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} (bytes) "
             f"bound_share={r['bound_ms'] / r['ms']:.3f} library_ms=null equal=bit")


# The element types each simplex family takes on the card besides the
# ones the other phases run (ACCUM int32, int64, float32 and float64; CA
# int32; EDM float32).
DTYPE_ACCUM = ("int8", "uint8", "int16", "bfloat16", "float16")
DTYPE_CA = ("int8", "uint8", "int16", "int64", "bfloat16", "float16", "float32")
DTYPE_EDM = ("float16", "bfloat16", "float64")
# Values where +1 leaves the easy range: integers at their top (they
# wrap), bfloat16 around 256 and float16 around 2048 (the sum rounds).
DTYPE_EDGES = {"int8": (127, 126, -128), "uint8": (255, 254, 0), "int16": (32767, 32766, -1),
               "bfloat16": (255, 256, 258), "float16": (2047, 2048, 2050)}
# (m, n, rho, kind) of the engine's dtype cases; the originals run at the
# same sides (accum_md at m=4).
DTYPE_ENGINE = ((2, 1024, 16, "hmap"), (3, 64, 4, "octant"))
# CA on bfloat16 states of other values than 0/1, where the order of the
# neighbour count's roundings shows (256 + 0.5 rounds back to 256 in
# bf16): the kernel must add in the reference's order to stay bit-equal
# (tests/test_torch_ca_walk.py shows a reversed order failing on such a
# state).  Values drawn from CA_MIXED; (m, n, rho, kind) per case.
CA_MIXED = (0, 0, 1, 1, 1, 0.5, 1.5, 2, -1, 256, -256, 2048, -2048, 0.25)
CA_MIXED_CASES = ((2, 1024, 16, "hmap"), (3, 64, 8, "octant"))


def ulp16(torch, t, dtype):
    """The spacing of a 16-bit float type at |t| (its subnormal spacing
    below the normal range), as a float32 tensor."""
    bits, emin = (7, -126) if dtype == torch.bfloat16 else (10, -14)
    _, e = torch.frexp(t.to(torch.float32).abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), (e - 1).clamp(min=emin) - bits)


class DtypeSmoke:
    """The simplex kernels at the element types the reference takes:
    ACCUM in int8, uint8, int16, bfloat16 and float16, CA in int8, uint8,
    int16, int64, bfloat16, float16 and float32, EDM storing float16,
    bfloat16 and float64, each through the engine's entry points and the
    originals', held against the plain version on the same input.

    ACCUM and CA are bit-equal.  EDM stores float64 within the existing
    gate ``1e-5 + 1e-5 * max|p|``; a 16-bit EDM output may also differ by
    one ulp of its type where the float32 distance (Gram form on the card,
    difference form in the plain version) lies within that gate of a
    16-bit rounding boundary.  A dtype no kernel takes (flash attention's
    too) must raise ``ValueError`` before any launch.

    Shares the simplex ``Smoke``'s generators and failure list.
    """

    def __init__(self, smoke: Smoke, legacy, fa):
        self.s, self.legacy, self.fa = smoke, legacy, fa
        self.torch = smoke.torch
        self.cases = 0

    def data(self, shape, dtype, salt, kind):
        """An integer-valued input (``kind='accum'``, edges included) or a
        0/1 state (``'ca'``) of ``dtype`` on the card."""
        torch, dev = self.torch, self.s.dev
        if kind == "ca":
            return (torch.rand(shape, generator=self.s.gen(salt), device=dev) < 0.4).to(dtype)
        x = torch.randint(0, 100, shape, generator=self.s.gen(salt), device=dev,
                          dtype=torch.int64)
        edges = torch.tensor(DTYPE_EDGES[str(dtype).split(".")[-1]], device=dev)
        flat = x.view(-1)
        flat[::3] = edges[torch.arange(flat[::3].numel(), device=dev) % len(edges)]
        return x.to(dtype)

    def equal(self, what, got, want) -> None:
        """ACCUM and CA: the kernel's output bit-equal to the plain one."""
        self.cases += 1
        if got.dtype != want.dtype or not self.torch.equal(got, want):
            self.s.fail(f"dtype {what}")

    def path(self) -> None:
        """Every new dtype of every family through its entry points."""
        torch, ops, E, L = self.torch, self.s.ops, self.s.engine, self.legacy
        for name in DTYPE_ACCUM:
            dt = getattr(torch, name)
            for m, n, rho, kind in DTYPE_ENGINE:
                x = self.data((n,) * m, dt, 100 + m, "accum")
                fn = ops.simplex_accum2d if m == 2 else ops.simplex_accum3d
                want = x.clone()
                E.get_body("accum").plain_(want, E.schedule_for(m, n // rho, kind), rho)
                self.equal(f"accum {name} m={m}", fn(x, rho=rho, kind=kind), want)
                old = L.accum2d if m == 2 else L.accum3d
                sched = L._schedule(m, n // rho, "hmap")
                want = x.clone()
                (L.ACCUM2D if m == 2 else L.ACCUM3D).plain_(want, sched, rho)
                self.equal(f"legacy accum {name} m={m}", old(x, rho=rho, kind="hmap"), want)
            x = self.data((16,) * 4, dt, 104, "accum")
            want = x.clone()
            L.ACCUM_MD.plain_(want, L._schedule(4, 8, "hmap"), 2)
            self.equal(f"legacy accum_md {name} m=4", L.accum_md(x, rho=2, kind="hmap"), want)
        for name in DTYPE_CA:
            dt = getattr(torch, name)
            for m, n, rho, kind in DTYPE_ENGINE:
                st = self.data((n,) * m, dt, 110 + m, "ca")
                fn = ops.simplex_ca2d if m == 2 else ops.simplex_ca3d
                want = st.clone()
                E.get_body("ca").plain_(want, st, E.schedule_for(m, n // rho, kind), rho)
                self.equal(f"ca {name} m={m}", fn(st, rho=rho, kind=kind), want)
                sched = L._schedule(m, n // rho, "hmap")
                want = st.clone()
                (L.CA2D if m == 2 else L.CA3D).plain_(want, st, sched, rho)
                self.equal(f"legacy ca {name} m={m}",
                           (L.ca2d if m == 2 else L.ca3d)(st, rho=rho, kind="hmap"), want)
        vals = torch.tensor(CA_MIXED, device=self.s.dev)
        for m, n, rho, kind in CA_MIXED_CASES:
            pick = torch.randint(0, len(CA_MIXED), (n,) * m, generator=self.s.gen(115 + m),
                                 device=self.s.dev)
            st = vals[pick].to(torch.bfloat16)
            want = st.clone()
            E.get_body("ca").plain_(want, st, E.schedule_for(m, n // rho, kind), rho)
            fn = ops.simplex_ca2d if m == 2 else ops.simplex_ca3d
            self.equal(f"ca bfloat16 mixed values m={m}", fn(st, rho=rho, kind=kind), want)
        for name in DTYPE_EDM:
            dt = getattr(torch, name)
            for m, n, rho, kind in DTYPE_ENGINE:
                p = torch.randn((n, EDM_D), generator=self.s.gen(120 + m), device=self.s.dev)
                p = p.to(dt)
                got = (ops.simplex_edm2d(p, rho=rho, kind=kind) if m == 2 else
                       ops.simplex_edm_md(p, m, rho=rho, kind=kind))
                want = torch.zeros_like(got)
                E.get_body("edm").plain_(want, p, E.schedule_for(m, n // rho, kind), rho)
                self.edm(f"edm {name} m={m}", got, want)
                if m == 2:
                    old = L.edm2d(p, rho=rho, kind="hmap")
                    want = torch.zeros_like(old)
                    L.EDM2D.plain_(want, p, L._schedule(2, n // rho, "hmap"), rho)
                    self.edm(f"legacy edm2d {name}", old, want)
        self.refusals()
        torch.cuda.synchronize()
        _log(f"dtype check: {self.cases} cases, ACCUM {DTYPE_ACCUM}, CA {DTYPE_CA} and "
             f"bfloat16 of values {CA_MIXED} at {CA_MIXED_CASES}, "
             f"EDM {DTYPE_EDM}")

    def edm(self, what, got, want) -> None:
        """EDM within ``1e-5 + 1e-5 * max|p|``, plus one ulp of a 16-bit
        output."""
        torch = self.torch
        self.cases += 1
        if got.dtype != want.dtype:
            self.s.fail(f"dtype {what}: {got.dtype}, plain {want.dtype}")
            return
        g, w = got.to(torch.float64), want.to(torch.float64)
        tol = 1e-5 + 1e-5 * w.abs().max().item()
        if got.dtype in (torch.float16, torch.bfloat16):
            tol = tol + ulp16(torch, torch.maximum(g.abs(), w.abs()), got.dtype).double()
        err = (g - w).abs()
        ok = bool(torch.isfinite(err).all()) and bool((err <= tol).all())
        _log(f"dtype check {what}: max_abs_err={err.max().item():.3e} gate "
             f"1e-5 + 1e-5*max|p|{' + 1 ulp' if got.dtype != torch.float64 else ''} ok={ok}")
        if not ok:
            self.s.fail(f"dtype {what}: max_abs_err={err.max().item()}")

    def refusals(self) -> None:
        """Each family refuses a dtype it does not take, before a launch."""
        torch, ops, L = self.torch, self.s.ops, self.legacy
        dev = self.s.dev
        cases = (
            ("accum bool", lambda: ops.simplex_accum2d(
                torch.zeros((64, 64), dtype=torch.bool, device=dev), rho=16)),
            ("ca float64", lambda: ops.simplex_ca2d(
                torch.zeros((64, 64), dtype=torch.float64, device=dev), rho=16)),
            ("edm int32", lambda: ops.simplex_edm2d(
                torch.zeros((64, 8), dtype=torch.int32, device=dev), rho=16)),
            ("legacy ca3d float64", lambda: L.ca3d(
                torch.zeros((16,) * 3, dtype=torch.float64, device=dev), rho=4)),
            ("legacy accum2d bool", lambda: L.accum2d(
                torch.zeros((64, 64), dtype=torch.bool, device=dev), rho=16)),
            ("legacy edm2d int32", lambda: L.edm2d(
                torch.zeros((64, 8), dtype=torch.int32, device=dev), rho=16)),
            ("flash float64", lambda: self.fa.flash_attention(
                *(torch.zeros((1, 2, 128, 64), dtype=torch.float64, device=dev),) * 3,
                block_q=64, block_kv=64)),
        )
        for what, fn in cases:
            try:
                fn()
            except ValueError:
                continue
            self.s.fail(f"dtype {what}: no ValueError")


class FlashSmoke:
    """The serving path and the flash kernel's checks and timings.

    Shares the simplex ``Smoke``'s generators, timer and failure list.
    """

    def __init__(self, smoke: Smoke, fa, serve, configs, model_cls, card: str):
        self.s, self.fa, self.serve = smoke, fa, serve
        self.configs, self.model_cls, self.card = configs, model_cls, card
        self.torch = smoke.torch
        self.err = dict.fromkeys(fa.ROUTES, 0.0)
        self.rows: list = []
        self.stats: dict = {}

    # -- the serving main path ------------------------------------------

    def serve_path(self):
        """``serve.run`` on full-width yi-6b; returns the run."""
        torch = self.torch
        torch.cuda.reset_peak_memory_stats()
        r = self.serve.run(self.serve.parse_args(SERVE_ARGV + ["--seed", str(self.s.seed)]))
        torch.cuda.synchronize()
        cfg = r.model.cfg
        b, gen = r.tokens.shape
        self.stats = dict(prefill_s=r.prefill_s, decode_tok_s=(gen - 1) * b / r.decode_s,
                          params=sum(p.numel() for p in r.model.parameters()))
        _log(f"serve {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} heads "
             f"{cfg.n_heads}/{cfg.n_kv_heads} d_ff {cfg.d_ff} vocab {cfg.vocab}, "
             f"{self.stats['params']} float32 parameters; batch {b}, prompt "
             f"{r.prompts.shape[1]}, {gen - 1} greedy tokens")
        self.stats.update(self.graph_hold(r, f"serve {cfg.name}"))
        self.stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        _log(f"serve prefill_s={r.prefill_s:.4f} decode_s={r.decode_s:.4f} "
             f"decode_tok_s={self.stats['decode_tok_s']:.2f} "
             f"peak_gib={self.stats['peak_gib']:.3f} card={self.card}")
        lg = r.prefill_logits
        if tuple(lg.shape) != (b, 1, cfg.vocab) or not torch.isfinite(lg).all():
            self.s.fail(f"serve: prefill logits {tuple(lg.shape)} not finite or misshapen")
        if (tuple(r.tokens.shape) != (b, 17) or int(r.tokens.min()) < 0
                or int(r.tokens.max()) >= cfg.vocab):
            self.s.fail(f"serve: token ids {tuple(r.tokens.shape)} out of range")
        return r

    def graph_hold(self, r, tag: str) -> dict:
        """``serve.run``'s decode, captured at its first step and replayed,
        against an eager ``model.decode`` on the same caches and tokens (the
        run's own).  The eager steps run first, then each step is replayed
        again: every replayed step's logits must equal the eager step's bit
        for bit, or lie within ``GRAPH_REL * max|logit|`` (said on the
        line), and every greedy token of the run must be the eager step's
        argmax.  Then the replayed steps again, timed as the eager ones
        were: one synchronisation at the end, CUDA events between the steps
        (``_steps``).  Logs and returns the run's ``decode_tok_s`` (capture
        included), ``capture_s``, its median step ms (each step
        synchronised), the eager and the replayed loop's tok/s and median
        step ms, and the graph pool's bytes."""
        torch = self.torch
        model, dev = r.model, r.prefill_logits.device
        b, n = r.tokens.shape
        s = r.prompts.shape[1] + model.cfg.n_patches
        tokens = r.tokens.to(dev)
        pos = torch.empty((b,), dtype=torch.long, device=dev)

        def inputs(i):
            pos.fill_(s + i)
            return {"tokens": tokens[:, i:i + 1], "pos": pos}

        eager, eager_s, eager_ms = self._steps(
            n - 1, lambda i: model.decode(r.caches, inputs(i))[0], keep=True)
        err, equal, greedy = 0.0, True, True
        for i in range(n - 1):
            got = r.decode(inputs(i))
            err = max(err, (got - eager[i]).abs().max().item())
            equal = equal and torch.equal(got, eager[i])
            greedy = greedy and bool((eager[i][:, -1].argmax(-1) == tokens[:, i + 1]).all())
        _, replay_s, replay_ms = self._steps(n - 1, lambda i: r.decode(inputs(i)))
        scale = max(x.abs().max().item() for x in eager)
        ok = greedy and (equal or err <= GRAPH_REL * scale)
        st = dict(decode_tok_s=(n - 1) * b / r.decode_s, capture_s=r.capture_s,
                  run_step_ms=statistics.median(r.step_s[1:]) * 1e3,
                  eager_decode_tok_s=(n - 1) * b / eager_s,
                  eager_step_ms=statistics.median(eager_ms),
                  replay_decode_tok_s=(n - 1) * b / replay_s,
                  replay_step_ms=statistics.median(replay_ms),
                  pool_gib=r.decode.pool_bytes() / 2**30, graph_err=err, graph_equal=equal)
        _log(f"{tag} graph: decode captured at the first step and replayed: decode_tok_s="
             f"{st['decode_tok_s']:.2f} (capture included) capture_s={r.capture_s:.4f} "
             f"run_step_ms={st['run_step_ms']:.3f} (median, each step synchronised); "
             f"{n - 1} steps again: replayed {st['replay_decode_tok_s']:.2f} tok/s, "
             f"replay_step_ms={st['replay_step_ms']:.3f}, eager "
             f"{st['eager_decode_tok_s']:.2f} tok/s, eager_step_ms={st['eager_step_ms']:.3f} "
             f"(medians of CUDA-event steps) pool_gib={st['pool_gib']:.4f}; replayed "
             f"steps against eager model.decode: bit_equal={equal} max_abs_err={err:.3e} "
             f"max|logit|={scale:.3f} greedy_tokens_equal={greedy}: ok={ok} card={self.card}")
        if not ok:
            self.s.fail(f"{tag}: the replayed decode differs from the eager one by {err} "
                        f"(greedy tokens equal: {greedy})")
        return st

    def _steps(self, n: int, step, keep: bool = False):
        """``step(i)`` for ``i < n``, each followed by its greedy argmax, one
        synchronisation at the end.  Returns the logits (``keep``), the
        seconds of the loop, and each step's ms between CUDA events."""
        torch = self.torch
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(n):
            lg = step(i)
            lg[:, -1].argmax(-1)
            marks[i + 1].record()
            if keep:
                out.append(lg)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, [a.elapsed_time(z) for a, z in
                                               zip(marks, marks[1:])]

    def hold(self, r) -> None:
        """The same prefill with the chunked executor: last-token logits
        must agree with the flash path's."""
        torch = self.torch
        model = r.model
        before = dict(self.fa.FLASH.launches)
        model.cfg = model.cfg.replace(attention_impl="chunked")
        try:
            t0 = time.perf_counter()
            chunked, _ = model.prefill({"tokens": r.prompts})
            torch.cuda.synchronize()
            self.stats["chunked_prefill_s"] = time.perf_counter() - t0
        finally:
            model.cfg = model.cfg.replace(attention_impl="auto")
        if self.fa.FLASH.launches != before:
            self.s.fail("hold: the chunked prefill launched a flash kernel")
        flash = r.prefill_logits
        err = (flash - chunked).abs().max().item()
        self.stats["logit_err"] = err
        self.stats["logit_rel"] = err / chunked.abs().max().item()
        ok = torch.allclose(flash, chunked, **LOGIT_TOL)
        _log(f"hold flash vs chunked prefill: max_abs_err={err:.3e} "
             f"max|logit|={chunked.abs().max().item():.3f} "
             f"chunked_prefill_s={self.stats['chunked_prefill_s']:.4f} allclose={ok}")
        if not ok:
            self.s.fail(f"hold: flash and chunked logits differ by {err}")

    # -- the kernel against its plain version ----------------------------

    def qkv(self, b, hq, hkv, s, d, salt):
        """Random float32 q, k, v on the card from ``--seed`` and ``salt``."""
        torch, dev = self.torch, self.s.dev
        g = self.s.gen(salt)
        return (torch.randn((b, hq, s, d), generator=g, device=dev),
                torch.randn((b, hkv, s, d), generator=g, device=dev),
                torch.randn((b, hkv, s, d), generator=g, device=dev))

    def segments(self, b, s):
        """Packing ids with boundaries inside tiles: rows of a later
        segment see fully masked first KV tiles."""
        seg = self.torch.zeros((b, s), dtype=self.torch.int32, device=self.s.dev)
        seg[0, s // 3:] = 1
        seg[-1, (2 * s) // 3 + 5:] = 2
        return seg

    def compare(self, what, route, got, want, v) -> bool:
        """Hold a float32 ``got`` within ``2e-5 + 2e-5 * max|want|`` of
        ``want``; a 16-bit one within one ulp of its type (of the larger
        of the two values) plus ``2^-15 * max|v|``: both sides compute
        float32 values that differ by the order of float32 sums and, in
        the kernel, by P's two-part split, then round once
        (tests/test_torch_flash16.py derives it).  Returns whether it held."""
        torch = self.torch
        if got.dtype != want.dtype:
            self.s.fail(f"flash {what}: {got.dtype} against {want.dtype}")
            return False
        g, w = got.to(torch.float32), want.to(torch.float32)
        diff = (g - w).abs()
        err = diff.max().item()
        if got.dtype == torch.float32:
            tol = 2e-5 + 2e-5 * w.abs().max().item()
            ok = math.isfinite(err) and err <= tol
            gate = f"tol={tol:.3e}"
        else:
            one = ulp16(torch, torch.maximum(g.abs(), w.abs()), got.dtype)
            extra = 2.0**-15 * v.abs().max().item()
            ok = bool(torch.isfinite(diff).all()) and bool((diff <= one + extra).all())
            gate = f"max_ulps={(diff / one).max().item():.2f} gate 1 ulp + {extra:.2e}"
        self.err[route] = max(self.err[route], err)
        _log(f"flash check {route} {what}: max_abs_err={err:.3e} {gate} ok={ok}")
        if not ok:
            self.s.fail(f"flash {route} {what}: max_abs_err={err}")
        return ok

    def kernel_cases(self) -> None:
        """Every case through the kernel and its plain version."""
        torch, FL = self.torch, self.fa.FLASH
        b, hq, hkv, s, d = SERVE_SHAPE
        cases = [  # (what, (b, hq, hkv, s, d), block_q, kinds, bias lead dims, segments)
            ("serve shape", (b, hq, hkv, s, d), 128, ("folded", "bb"), None, False),
            ("32-row tiles", (b, hq, hkv, SMALL_TILE_S, d), 32, ("folded", "bb"), None, False),
            ("odd nq=15", (1, hq, hkv, 1920, d), 128, ("folded", "bb"), None, False),
            ("Hkv == Hq", (1, hq, hq, 1024, d), 128, ("folded",), None, False),
            ("bias (1,Hq)", (2, 8, 2, 512, d), 128, ("folded", "bb"), (1, 8), False),
            ("bias (B,1)+segments", (2, 8, 2, 512, d), 64, ("folded", "bb"), (2, 1), True),
            ("segments", (2, 8, 2, 512, d), 128, ("folded",), None, True),
        ]
        for i, (what, shape, bq, kinds, lead, with_seg) in enumerate(cases):
            q, k, v = self.qkv(*shape, salt=40 + i)
            bias = None if lead is None else torch.randn(
                lead + (shape[3], shape[3]), generator=self.s.gen(60 + i), device=self.s.dev)
            seg = self.segments(shape[0], shape[3]) if with_seg else None
            for kind in kinds:
                scale = shape[4] ** -0.5
                got = FL.kernel(kind, bq, scale, q, k, v, bias, seg)
                torch.cuda.synchronize()
                self.compare(f"{what} {kind} shape={shape} block_q={bq}",
                             self.fa.flash_route(bq, q.dtype), got,
                             FL.plain(kind, bq, scale, q, k, v, bias, seg), v)
            del q, k, v, bias, seg
        for dtype in (torch.bfloat16, torch.float16):  # the 16-bit route at the serve shape
            q, k, v = (t.to(dtype) for t in self.qkv(b, hq, hkv, s, d, salt=46))
            got = FL.kernel("folded", 128, d**-0.5, q, k, v)
            torch.cuda.synchronize()
            self.compare(f"serve shape {str(dtype)[6:]} folded shape={SERVE_SHAPE} block_q=128",
                         self.fa.flash_route(128, dtype), got,
                         FL.plain("folded", 128, d**-0.5, q, k, v), v)
            del q, k, v
        q, k, v = self.qkv(1, 4, 2, 256, 64, salt=70)
        bias = torch.randn((1, 4, 256, 256), generator=self.s.gen(71), device=self.s.dev)
        seg = self.segments(1, 256)
        got = FL.kernel("folded", 64, 0.125, q, k, v, bias, seg)
        self.compare("folded vs _reference_attention shape=(1, 4, 2, 256, 64)", "flash_wgmma",
                     got, self.fa._reference_attention(q, k, v, bias, seg, 0.125), v)
        torch.cuda.empty_cache()

    def tile_sweep(self) -> dict:
        """Every tile the kernels are built for, at small S: each
        ``(block_q, D)`` of ``KERNEL_BLOCKS x KERNEL_HEAD_DIMS`` in
        float32, bfloat16 and float16 through ``flash_attention``, odd and
        even tile counts, both kinds, a bias of ``bias_h = Hq`` on every
        fourth case and of ``bias_h = 1`` on every fourth, segment ids on
        every fourth, ``Hkv == Hq`` on every fifth (``flash16``'s padding
        slots) and a group of 8 on every fifth (``flash16`` on two
        warpgroups at ``block_q`` 16 and 32), each held against the plain
        version.

        Returns:
            The launches each route should have made.
        """
        torch, fa = self.torch, self.fa
        want_launches = dict.fromkeys(fa.ROUTES, 0)
        i = 0
        for name in ("float32", "bfloat16", "float16"):
            dtype = getattr(torch, name)
            for bq in fa.KERNEL_BLOCKS:
                for d in fa.KERNEL_HEAD_DIMS:
                    i += 1
                    s = (3 if i % 2 else 4) * bq
                    kind = "bb" if i % 3 == 0 else "folded"
                    hq, hkv = {0: (4, 4), 3: (8, 1)}.get(i % 5, (4, 2))
                    q, k, v = (t.to(dtype) for t in self.qkv(1, hq, hkv, s, d, salt=200 + i))
                    lead = {1: (1, hq), 3: (1, 1)}.get(i % 4)
                    bias = (None if lead is None else torch.randn(
                        lead + (s, s), generator=self.s.gen(400 + i), device=self.s.dev))
                    seg = self.segments(1, s) if i % 4 == 2 else None
                    got = fa.flash_attention(q, k, v, bias=bias, segment_ids=seg, kind=kind,
                                             block_q=bq, block_kv=bq)
                    route = fa.flash_route(bq, dtype)
                    want_launches[route] += 1
                    self.compare(f"sweep {name} block_q={bq} D={d} S={s} Hq={hq} Hkv={hkv} "
                                 f"{kind} bias={lead} segments={seg is not None}", route,
                                 got, fa.FLASH.plain(kind, bq, d**-0.5, q, k, v, bias, seg), v)
        torch.cuda.synchronize()
        _log(f"flash sweep: {i} cases, launches wanted {want_launches}")
        return want_launches

    def prefill16(self, model=None, length: int = PREFILL16_LEN):
        """Full-width yi-6b at its config's own dtypes (bfloat16
        activations, float32 weights from ``--seed``; built unless
        ``model`` is given): one prefill of the serve batch at prompts of
        ``length`` tokens.  Returns ``(model, prompts, last-token
        logits)``."""
        torch = self.torch
        cfg = self.configs.config("yi-6b")
        gen = torch.Generator(device=self.s.dev).manual_seed(
            self.s.seed if model is None else self.s.seed + length)
        if model is None:
            model = self.model_cls(cfg, device=self.s.dev).init(gen)
        prompts = torch.randint(0, cfg.vocab, (PREFILL16_BATCH, length), generator=gen,
                                device=self.s.dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, _ = model.prefill({"tokens": prompts})
        torch.cuda.synchronize()
        key = "" if length == PREFILL16_LEN else f"_{length}"
        self.stats[f"prefill16{key}_s"] = time.perf_counter() - t0
        self.stats[f"peak16{key}_gib"] = torch.cuda.max_memory_allocated() / 2**30
        _log(f"prefill16 {cfg.name}: act_dtype {cfg.act_dtype} param_dtype "
             f"{cfg.param_dtype}, batch {PREFILL16_BATCH}, prompt {length}: "
             f"prefill_s={self.stats[f'prefill16{key}_s']:.4f} "
             f"peak_gib={self.stats[f'peak16{key}_gib']:.3f} logits {tuple(logits.shape)} "
             f"{logits.dtype}")
        if (logits.dtype != torch.bfloat16 or tuple(logits.shape) != (PREFILL16_BATCH, 1, cfg.vocab)
                or not torch.isfinite(logits).all()):
            self.s.fail(f"prefill16: logits {tuple(logits.shape)} {logits.dtype} not finite "
                        "or misshapen")
        return model, prompts, logits

    def hold16(self, model, prompts, logits, route: str = "flash16_wgmma",
               controls: bool = True) -> None:
        """The same 16-bit prefill with the chunked executor; last-token
        logits within ``LOGIT16_TOL * max|logit|`` with every row's argmax
        equal (see its note), then (``controls``) the gate's two
        controls.  ``route`` names the flash kernel the prefill ran."""
        torch = self.torch
        key = "" if prompts.shape[1] == PREFILL16_LEN else f"_{prompts.shape[1]}"
        before = dict(self.fa.FLASH.launches)
        model.cfg = model.cfg.replace(attention_impl="chunked")
        try:
            t0 = time.perf_counter()
            chunked, _ = model.prefill({"tokens": prompts})
            torch.cuda.synchronize()
            self.stats[f"chunked16{key}_s"] = time.perf_counter() - t0
        finally:
            model.cfg = model.cfg.replace(attention_impl="auto")
        if self.fa.FLASH.launches != before:
            self.s.fail("hold16: the chunked prefill launched a flash kernel")
        ref = chunked.float()
        scale = ref.abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).min().item()
        ok, err, agree = self.gate16(logits, ref, scale)
        self.stats[f"logit16{key}_err"] = err
        self.stats[f"logit16{key}_rel"] = err / scale
        _log(f"hold16 {route} prompt {prompts.shape[1]} vs chunked prefill: max_abs_err={err:.3e} "
             f"max|logit|={scale:.3f} "
             f"rel={err / scale:.3e} gate {LOGIT16_TOL} * max|logit| and argmax_agree == 1 "
             f"chunked_prefill_s={self.stats[f'chunked16{key}_s']:.4f} argmax_agree={agree:.3f} "
             f"min_top2_gap={gap:.3e} ok={ok}")
        if not ok:
            self.s.fail(f"hold16: {route} and chunked logits differ by {err} (max|logit| "
                        f"{scale}), argmax agreeing on {agree}")
        if not controls:
            return
        from repro_torch.models import attention as attn
        real = attn.flash_attention
        for name, round_p, see_next in (("mask sees next key", False, True),
                                        ("P rounded once", True, False)):
            calls = []
            attn.flash_attention = self.wrong16(round_p, see_next, calls)
            try:
                wrong, _ = model.prefill({"tokens": prompts})
                torch.cuda.synchronize()
            finally:
                attn.flash_attention = real
            held, werr, wagree = self.gate16(wrong, ref, scale)
            self.stats[f"control16 {name}"] = werr / scale
            _log(f"control16 {name}: max_abs_err={werr:.3e} rel={werr / scale:.3e} "
                 f"argmax_agree={wagree:.3f} calls={len(calls)} passes_gate={held}")
            if len(calls) != model.cfg.n_layers:
                self.s.fail(f"control16 {name}: the wrong attention ran {len(calls)} times")
            if see_next and held:
                self.s.fail(f"control16 {name}: the 16-bit logit gate does not see it")
        if self.fa.FLASH.launches != before:
            self.s.fail("hold16: a control prefill launched a flash kernel")

    @staticmethod
    def gate16(got, ref, scale) -> tuple:
        """``(held, max_abs_err, argmax agreement)`` of 16-bit logits
        ``got`` against the float32 view of the chunked ones."""
        g = got.float()
        err = (g - ref).abs().max().item()
        agree = (g.argmax(-1) == ref.argmax(-1)).float().mean().item()
        return math.isfinite(err) and err <= LOGIT16_TOL * scale and agree == 1.0, err, agree

    def wrong16(self, round_p: bool, see_next: bool, calls: list):
        """A wrong attention with ``flash_attention``'s signature for the
        16-bit gate's controls: dense causal attention from q's dtype in
        float32, with P rounded once to q's dtype before P V
        (``round_p``) or each query also seeing the key after it
        (``see_next``).  Appends to ``calls`` at each call."""
        torch = self.torch

        def attend(q, k, v, *, kind=None, block_q=None, block_kv=None, scale=None,
                   device=None):
            calls.append(kind)
            b, hq, s, d = q.shape
            g = hq // k.shape[1]
            scale = d**-0.5 if scale is None else scale
            keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril(int(see_next))
            out = torch.empty_like(q)
            for i in range(b):  # one sequence at a time: 0.5 GiB of scores
                sc = (q[i].float() @ k[i].repeat_interleave(g, 0).float().transpose(1, 2))
                sc = (sc * scale).masked_fill(~keep, float("-inf"))
                pr = torch.exp(sc - sc.amax(-1, keepdim=True))
                l = pr.sum(-1, keepdim=True)
                if round_p:
                    pr = pr.to(q.dtype).float()
                out[i] = ((pr @ v[i].repeat_interleave(g, 0).float()) / l).to(q.dtype)
                del sc, pr
            return out

        return attend

    # -- timing -----------------------------------------------------------

    @staticmethod
    def bound(b, hq, hkv, s, d, flops_per_s: float = TF32X3_FLOPS, itemsize: int = 4) -> tuple:
        """``(bound_ms, bound_by)`` of one causal attention call: q, k, v
        read once and the output written once (``itemsize`` bytes an
        element), against the operations 4 * B * Hq * D * S(S+1)/2 (QK^T
        and PV, 2*D each per visible (query, key) pair; the softmax's exp
        and sums are not counted) at ``flops_per_s``: float32-accurate
        products on the tensor cores (3xTF32) by default, ``F32_FLOPS`` on
        the CUDA cores, ``BF16_FLOPS`` for 16-bit inputs."""
        nbytes = itemsize * d * s * (2 * b * hq + 2 * b * hkv)
        flops = 4 * b * hq * d * s * (s + 1) // 2
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    def timings(self) -> None:
        """Each flash kernel, its plain version and SDPA at the shapes the
        paths give it: ``flash_wgmma`` (folded and bb) at the serve shape
        in float32, ``flash16_wgmma`` at the serve shape in bfloat16 (the
        16-bit prefill's; folded and bb) and float16, and, at prompts the
        tuner maps to small tiles, ``flash`` (float32, 2080 tokens, 32-row
        tiles) and ``flash16``: bfloat16 and float16 at 2080 tokens,
        bfloat16 with ``Hkv == Hq``, at 2064 (16-row tiles) and at 2056
        (8-row tiles), each at one and two warpgroups a block where the
        group fills two (the fixed rule's first, then the other)."""
        torch, FL = self.torch, self.fa.FLASH
        b, hq, hkv, s, d = SERVE_SHAPE
        sdpa = torch.nn.functional.scaled_dot_product_attention
        both = "both"
        for route, dtype, seq, bq, kv, kinds, wgs in (
                ("flash_wgmma", torch.float32, s, 128, hkv, ("folded", "bb"), (None,)),
                ("flash16_wgmma", torch.bfloat16, s, 128, hkv, ("folded", "bb"), (None,)),
                ("flash16_wgmma", torch.float16, s, 128, hkv, ("folded",), (None,)),
                ("flash", torch.float32, SMALL_TILE_S, 32, hkv, ("folded",), (None,)),
                ("flash16", torch.bfloat16, SMALL_TILE_S, 32, hkv, ("folded",), both),
                ("flash16", torch.float16, SMALL_TILE_S, 32, hkv, ("folded",), both),
                ("flash16", torch.bfloat16, SMALL_TILE_S, 32, hq, ("folded",), (1,)),
                ("flash16", torch.bfloat16, SMALL16_S, 16, hkv, ("folded",), both),
                ("flash16", torch.bfloat16, SMALL8_S, 8, hkv, ("folded",), both)):
            if wgs == both:
                rule = self.fa.flash16_warpgroups(bq, hq // kv)
                wgs = (rule, 3 - rule)
            q, k, v = (t.to(dtype) for t in self.qkv(b, hq, kv, seq, d, salt=80))
            scale = d**-0.5
            kx = k.repeat_interleave(hq // kv, dim=1)
            vx = v.repeat_interleave(hq // kv, dim=1)
            lib = self.s.time_ms(lambda: sdpa(q, kx, vx, is_causal=True, scale=scale))
            lib_err = (sdpa(q, kx, vx, is_causal=True, scale=scale).float()
                       - FL.plain("folded", bq, scale, q, k, v).float()).abs().max().item()
            _log(f"library scaled_dot_product_attention {str(dtype)[6:]} S={seq} Hkv={kv} vs "
                 f"plain: max_abs_err={lib_err:.3e}")
            rate = TF32X3_FLOPS if dtype == torch.float32 else BF16_FLOPS
            bound_ms, bound_by = self.bound(b, hq, kv, seq, d, rate, dtype.itemsize)
            bound_f32_ms = self.bound(b, hq, kv, seq, d, F32_FLOPS, dtype.itemsize)[0]
            # The plain version walks the schedule step by step in Python:
            # below 32-row tiles one call takes seconds, so it is timed once.
            plain_runs = (3, 1) if bq >= 32 else (1, 0)
            for kind in kinds:
                want = FL.plain(kind, bq, scale, q, k, v)
                plain = self.s.time_ms(lambda: FL.plain(kind, bq, scale, q, k, v),
                                       runs=plain_runs[0], warm=plain_runs[1])
                for w in wgs:
                    got = FL.kernel(kind, bq, scale, q, k, v, warpgroups=w)
                    torch.cuda.synchronize()
                    equal = self.compare(f"timed {kind} shape={(b, hq, kv, seq, d)} block_q={bq}"
                                         + (f" warpgroups={w}" if w else ""), route, got, want, v)
                    del got
                    ms = self.s.time_ms(lambda: FL.kernel(kind, bq, scale, q, k, v, warpgroups=w))
                    self.rows.append(dict(route=route, dtype=str(dtype)[6:], s=seq, block_q=bq,
                                          hkv=kv, warpgroups=w, kind=kind, ms=ms, plain_ms=plain,
                                          library_ms=lib, bound_ms=bound_ms, bound_by=bound_by,
                                          bound_f32_ms=bound_f32_ms, equal=equal,
                                          steps=b * hq * self.fa.flash_grid_steps(seq // bq, kind)))
                del want
            del q, k, v, kx, vx
            torch.cuda.empty_cache()
        for row in self.rows:
            bb = next((r for r in self.rows if r["route"] == row["route"]
                       and r["dtype"] == row["dtype"] and r["kind"] == "bb"), None)
            _log(f"case test={row['route']} dtype={row['dtype']} kind={row['kind']} B={b} "
                 f"Hq={hq} Hkv={row['hkv']} S={row['s']} D={d} block_q={row['block_q']} "
                 + (f"warpgroups={row['warpgroups']} " if row["warpgroups"] else "")
                 + f"steps={row['steps']} ms={row['ms']:.4f} "
                 f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                 f"({row['bound_by']}) bound_share={row['bound_ms'] / row['ms']:.3f} "
                 f"{_f32(row)}library_ms={row['library_ms']:.4f} "
                 f"library/ms={row['library_ms'] / row['ms']:.3f} "
                 + (f"bb_ms/ms={bb['ms'] / row['ms']:.3f} " if bb else "")
                 + f"equal={row['equal']}")


# The dense family at full width (serve) and the training path.  Each
# model is served as yi-6b is (float32, batch 4, prompt 2048, 16 greedy
# tokens, random weights from --seed) and freed before the next.
# internlm2-20b's 48 layers hold 74 GiB of float32 weights, which leave
# an 80 GB card no room for the cache and activations, so its depth is
# cut to 24 layers (about 39 GiB) at full width.  stablelm-12b's head dim
# (160) is no flash tile's: its prefill takes the chunked executor, as the
# reference's does on a compiled TPU, so it is held against the chunked
# executor's bounding-box schedule instead.
# (arch, layers, flash_wgmma launches of the prefill, the hold's knob)
CHUNKED, CHUNKED_BB = dict(attention_impl="chunked"), dict(attention_schedule="bb")
DENSE_SERVES = (("granite-8b", 0, 36, CHUNKED), ("stablelm-12b", 0, 0, CHUNKED_BB),
                ("internlm2-20b", 24, 24, CHUNKED))
DENSE_ARGV = ["--batch", "4", "--prompt-len", "2048", "--gen", "16", "--temperature", "0"]
# The MoE, MLA and hybrid families at full width through launch/serve.py,
# as the dense family is served (float32, batch 4, prompt 2048, 16 greedy
# tokens): (arch, layers, flash_wgmma launches of the prefill, the hold's
# knob).  qwen2-moe-a2.7b (53.3 GiB of float32 weights) is not cut;
# jamba-v0.1-52b is cut to one period, 8 of its 32 layers (192.1 -> 49.5
# GiB); deepseek-v3-671b to its 3 dense prefix layers and 1 MoE layer of 61
# (58.8 GiB with the MTP head).  qwen2-moe and jamba hold the flash prefill
# against their own chunked prefill; deepseek-v3's MLA prefill takes the
# chunked executor (qk head dim 192, v 128, as in the reference) and is held
# against the chunked bounding-box schedule, as stablelm-12b is.
# The last three families, served the same way: xlstm-350m in full (no
# attention: its prefill is held at mLSTM chunk 64 against chunk 128),
# qwen2-vl-72b cut to 12 of its 80 layers (270.9 -> 48.5 GiB of float32
# weights; 1024 patch embeddings and 1024 text tokens make the 2048
# positions) and seamless-m4t-large-v2 in full (its 24 decoder layers
# launch the flash kernel, its encoder and cross attention none).  A knob's
# dict value replaces fields of the nested config it names.
XLSTM_CHUNK128 = {"xlstm": {"chunk": 128}}
FAMILY_SERVES = (("qwen2-moe-a2.7b", 0, 24, CHUNKED), ("jamba-v0.1-52b", 8, 1, CHUNKED),
                 ("deepseek-v3-671b", 4, 0, CHUNKED_BB), ("xlstm-350m", 0, 0, XLSTM_CHUNK128),
                 ("qwen2-vl-72b", 12, 12, CHUNKED), ("seamless-m4t-large-v2", 0, 24, CHUNKED))
# Each serve's peak device memory must stay under this (deepseek-v3 keeps
# batch 4 only while it does).
SERVE_PEAK_GIB = 75.0
# The card-against-CPU hold of each family's reduced config: (batch,
# prompt); 256 tokens are two of the Mamba scan's 128-token chunks.
FAMILY_CPU_HOLD = (2, 256)
# One mLSTM layer at xlstm-350m's full width (dp 2048, 4 heads of 512):
# the chunkwise form prefill runs against the recurrence decode runs, on
# (batch, tokens), each output and the final (C, n, m) within
# MLSTM_REL * max|want| + MLSTM_ABS.
MLSTM_HOLD = (4, 2048)
MLSTM_REL, MLSTM_ABS = 1e-4, 1e-6
# internlm2-20b's head layout (B, Hq, Hkv, D): a GQA group of 6, which the
# card had not run; each kernel at it against its plain version.
GROUP6 = (4, 48, 8, 128)
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
# The first step's loss and gradient norm with the kernel against the
# plain flash version on the card; the loss and every gradient leaf's
# norm of one step of a reduced config on the card against the CPU.
TRAIN_REL = 1e-4


class TrainRow(typing.NamedTuple):
    """One run of the train phase: ``launch/train.py`` at full width,
    float32 as the reference forces, the config's optimizer, ``steps``
    steps on one repeated batch of ``batch`` x ``seq`` tokens."""

    arch: str
    layers: int  # the depth kept (0: the config's)
    batch: int
    seq: int
    flash: int  # the layers whose attention takes the flash kernel, a forward pass
    remat: str = "none"
    steps: int = TRAIN_STEPS
    prefix: int = -1  # the dense prefix layers kept (-1: the config's)
    experts: int = 0  # the routed experts kept (0: the config's)
    # what ``run``'s batch_at adds to the tokens: "src_embeds" (frame
    # embeddings, seq of them, every step) or "patches" (one more step of
    # n_patches patch embeddings and seq - n_patches text tokens)
    inputs: str = ""
    why: str = ""  # the reason for the cut


# The train rows.  yi-6b, internlm2-20b and qwen2-moe-a2.7b are cut in
# depth to keep weights, gradients, state and the dense attention
# backward's (B, H, S, S) scores well inside 80 GB; the "dots" run's
# first step is held against remat "none"'s, and the peak of one step
# under each policy is logged.  The other five families follow the
# reckoning (``train_reckoning``): a step holds 8 bytes a parameter
# (weights and gradients) beside the optimizer's state and the
# activations, so one card holds about 9 B parameters under Adafactor,
# whose state is small, and about 5 B under AdamW's 8 bytes more;
# jamba's and deepseek's full expert counts wait for the four-card
# sharded trainer, and each cut below keeps the reckoned peak under
# TRAIN_PEAK_GIB.
TRAIN_RUNS = (
    TrainRow("yi-6b", 4, 4, 2048, 4), TrainRow("internlm2-20b", 2, 2, 2048, 2),
    TrainRow("qwen2-moe-a2.7b", 2, 4, 2048, 2), TrainRow("yi-6b", 4, 4, 2048, 4, remat="dots"),
    TrainRow("jamba-v0.1-52b", 8, 1, 1024, 1, experts=4,
             why="one period (8 of 32 layers) as served; experts 16 -> 4 (one period with 16 "
                 "is 13.3 B parameters, 8 bytes each exceed the card); seq 2048 -> 1024: the "
                 "Mamba scan under autograd keeps every token's (d_inner, d_state) state, "
                 "35 GiB of activations at 2048, reckoned"),
    TrainRow("deepseek-v3-671b", 2, 1, 1024, 0, prefix=1, experts=32,
             why="1 dense prefix layer and 1 MoE layer (2 of 61) and the MTP head; experts "
                 "256 -> 32, top-8 kept (4.76 B parameters, 44.1 GiB reckoned; all 256 in one "
                 "layer make the cut 14.6 B, 8 bytes each exceed the card)"),
    TrainRow("xlstm-350m", 0, 4, 1024, 0, steps=3,
             why="all 24 layers; seq 2048 -> 1024: the mLSTM's chunk states and the sLSTM "
                 "loop under autograd keep 65 GiB of activations at 4 x 2048, reckoned; 3 "
                 "steps: the sLSTM loop's backward makes a step the longest of the phase"),
    TrainRow("qwen2-vl-72b", 2, 2, 2048, 2, inputs="patches",
             why="2 of 80 layers: the embedding and unembedding (vocab 152064) are 2.5 B of "
                 "its 4.25 B parameters; 52.7 GiB reckoned"),
    TrainRow("seamless-m4t-large-v2", 0, 1, 1024, 24, inputs="src_embeds",
             why="not cut (24 encoder + 24 decoder layers); batch 1 x 1024 tokens and 1024 "
                 "frame embeddings"),
)
# Each train row's peak device memory, measured and reckoned, must stay
# under this, the serves' line; where the update sets a row's peak, its
# reckoning must be within TRAIN_RECKON_GIB of it (above the memory
# allocated before the row).
TRAIN_PEAK_GIB = 75.0
TRAIN_RECKON_GIB = 0.5
# The reckoning of a train row's peak.  The update (optim/optimizer.py)
# writes the parameters and the state in place and frees each gradient as
# it goes, a period's tensor at a time: beyond weights, gradients and state
# it holds LEAF_TEMPS float32 copies of the largest unit (a per-period
# tensor, or a stack of vectors) at once: the norm's squares, the clipped
# gradient beside the one it replaces, then one temporary at a time beside
# the clipped gradient, whose own gradient is freed by then.
# FlashFunction's backward holds FLASH_BWD_COPIES (B, Hq, S, S) float32
# tensors of one layer (the scores recomputed through _reference_attention,
# the probabilities and their gradients), the loss's backward
# LOGIT_BWD_COPIES (B, S, vocab).
LEAF_TEMPS = 1
FLASH_BWD_COPIES, LOGIT_BWD_COPIES = 4, 2


def train_config(configs, row: TrainRow):
    """``row``'s config: its architecture's full config with the row's
    depth, dense prefix and expert cuts (widths unchanged)."""
    cfg = configs.config(row.arch)
    over: dict = {}
    if row.layers:
        over["n_layers"] = row.layers
    if row.prefix >= 0:
        over.update(n_prefix=row.prefix, prefix_spec=cfg.prefix_spec[:row.prefix])
    if row.experts:
        over["moe"] = dataclasses.replace(cfg.moe, n_experts=row.experts)
    return cfg.replace(**over)


def saved_bytes(model, batch: dict) -> int:
    """Bytes of the tensors autograd keeps for the backward of
    ``model.loss(batch)`` (parameters not counted, each storage once), on
    whatever device the model and batch are, ``meta`` included."""
    import torch

    params = {p.untyped_storage()._cdata for p in model.parameters()}
    seen: dict = {}

    def pack(t):
        st = t.untyped_storage()
        if st._cdata not in params:
            seen[st._cdata] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(batch)
    return sum(seen.values())


def train_reckoning(cfg, batch: int, seq: int, flash: int = 0) -> dict:
    """Bytes of one training step of ``cfg`` on ``batch`` x ``seq`` tokens
    at its peak, as ``launch/train.py`` runs it (float32, remat "none"),
    reckoned on the ``meta`` device before the card runs it: weights 4
    bytes a parameter (``cfg.param_count()``'s model), gradients 4,
    optimizer state (AdamW 8; Adafactor its factored row and column
    statistics), the activations autograd keeps
    (``saved_bytes``; frame embeddings as many as tokens) and the
    backward's transients (``flash`` > 0: one layer's attention scores)
    during the backward; during the update the largest unit's temporaries
    (``LEAF_TEMPS``).  A config with a sequential mixer (the Mamba scan,
    the xLSTM loops) is counted at two
    lengths of its scan chunk and extrapolated: its saved bytes grow
    linearly with the tokens.  Sizes in GiB but ``params``."""
    import torch

    from repro_torch.models.convert import is_stacked, stacked_groups
    from repro_torch.models.mamba import SCAN_CHUNK
    from repro_torch.models.model import Model

    cfg = cfg.replace(act_dtype="float32", param_dtype="float32", remat="none")
    model = Model(cfg, device="meta").requires_grad_(True)
    params = dict(model.named_parameters())
    n = sum(p.numel() for p in params.values())
    temps = factored = 0
    for key, members in stacked_groups(params).items():
        shape = ((len(members),) if is_stacked(key) else ()) + tuple(params[members[0]].shape)
        numel = math.prod(shape)
        unit = numel if len(shape) == 2 and is_stacked(key) else numel // len(members)
        temps = max(temps, LEAF_TEMPS * 4 * unit)
        factored += (math.prod(shape[:-1]) + math.prod(shape[:-2] + shape[-1:])
                     if len(shape) >= 2 else numel)
    state = 8 * n if cfg.optimizer == "adamw" else 4 * factored

    def act(s):
        b = {"tokens": torch.zeros((batch, s + 1), dtype=torch.long, device="meta")}
        if cfg.encoder_layers:
            b["src_embeds"] = torch.empty((batch, s, cfg.d_model), device="meta")
        return saved_bytes(model, b)

    chunk = SCAN_CHUNK if cfg.mamba else cfg.xlstm.chunk if cfg.xlstm else 0
    if chunk and seq > 2 * chunk:
        one, two = act(chunk), act(2 * chunk)
        activations = one + (two - one) * (seq - chunk) // chunk
    else:
        activations = act(seq)
    transient = (LOGIT_BWD_COPIES * batch * seq * cfg.vocab * 4
                 + (FLASH_BWD_COPIES * batch * cfg.n_heads * seq * seq * 4 if flash else 0))
    backward = 8 * n + state + activations + transient
    update = 8 * n + state + temps
    gib = {k: v / 2**30 for k, v in dict(
        weights=4 * n, state=state, activations=activations, transient=transient, temps=temps,
        backward=backward, update=update, peak=max(backward, update)).items()}
    return dict(params=n, **gib)


class ModelSmoke:
    """The decoders' serves (the dense family, then the MoE, MLA and
    hybrid families), the group-6 kernel holds, the families'
    card-against-CPU holds and the training path.  Shares the
    ``FlashSmoke``'s comparisons and the simplex ``Smoke``'s generators,
    timer and failure list."""

    def __init__(self, flash: "FlashSmoke", train, optimizer, moe, model_cls, counts,
                 zero_counts, card):
        self.f, self.s, self.fa, self.card = flash, flash.s, flash.fa, card
        self.torch = flash.torch
        self.train, self.optimizer = train, optimizer
        self.moe, self.model_cls = moe, model_cls
        self.counts, self.zero_counts = counts, zero_counts
        self.stats: dict = {}
        self.rows: list = []

    def _free(self) -> None:
        import gc

        gc.collect()
        self.torch.cuda.empty_cache()

    def live(self, what: str) -> float:
        """Log and return the device memory (GiB) still allocated after a
        collection: the earlier phases must have freed their models before
        a peak is read, and a peak is compared above it."""
        self._free()
        gib = self.torch.cuda.memory_allocated() / 2**30
        _log(f"memory before {what}: allocated_gib={gib:.3f}")
        return gib

    # -- serving ----------------------------------------------------------

    @staticmethod
    def moe_layers(cfg) -> int:
        """MoE layers of a config: one routing record each per forward."""
        specs = tuple(cfg.prefix_spec) + tuple(cfg.period) * cfg.n_periods
        return sum(s.ffn == "moe" for s in specs)

    @staticmethod
    def flips(a: list, b: list) -> int:
        """(layer, token, slot) router choices that differ between two
        records of the same prompts."""
        return sum(int((x != y).sum()) for x, y in zip(a, b))

    @staticmethod
    def describe(cfg) -> str:
        """A config's layers and widths."""
        mixers = "/".join(f"{s.mixer}+{s.ffn}" for s in cfg.period)
        out = (f"{cfg.n_layers} layers ({cfg.n_prefix} prefix + {cfg.n_periods} x period "
               f"[{mixers}]) d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
               f"head_dim {cfg.hd} d_ff {cfg.d_ff} vocab {cfg.vocab}")
        if cfg.moe:
            m = cfg.moe
            out += (f"; experts {m.n_experts} top-{m.top_k} expert_ff {m.expert_ff} shared "
                    f"{m.n_shared} x {m.shared_ff} router {m.router}")
        if cfg.mla:
            m = cfg.mla
            out += (f"; MLA q_lora {m.q_lora_rank} kv_lora {m.kv_lora_rank} nope "
                    f"{m.qk_nope_dim} rope {m.qk_rope_dim} v {m.v_head_dim}")
        if cfg.mamba:
            m = cfg.mamba
            out += (f"; Mamba d_inner {m.expand * cfg.d_model} d_state {m.d_state} d_conv "
                    f"{m.d_conv}")
        if cfg.xlstm:
            x = cfg.xlstm
            out += (f"; xLSTM heads {x.n_heads} mLSTM dp {int(cfg.d_model * x.proj_factor_mlstm)} "
                    f"chunk {x.chunk} d_conv {x.d_conv} sLSTM FFN x{x.proj_factor_slstm:.4f}")
        if cfg.mrope_sections:
            out += f"; M-RoPE sections {cfg.mrope_sections}, {cfg.n_patches} patch embeddings"
        if cfg.encoder_layers:
            out += (f"; encoder {cfg.encoder_layers} bidirectional layers, cross attention in "
                    "every decoder layer")
        return out + (" mtp" if cfg.mtp else "")

    @staticmethod
    def with_knob(cfg, knob: dict):
        """``cfg`` with ``knob``'s fields replaced; a dict value replaces
        fields of the nested config it names."""
        return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                              if isinstance(v, dict) else v for k, v in knob.items()})

    def serve(self, arch: str, layers: int, flash_want: int, knob: dict, tag: str) -> None:
        """``serve.run`` on ``arch`` at full width (``layers`` > 0 cuts the
        depth), its prefill's ``flash_wgmma`` launches checked against
        ``flash_want``, its last-token logits held against the same model's
        prefill with ``knob``, and the router choices of the two prefills
        compared (none without experts); ``tag`` starts its lines."""
        from repro_torch.launch.graphs import WARMUP

        torch, fa = self.torch, self.fa
        argv = ["--arch", arch, "--seed", str(self.s.seed)] + DENSE_ARGV
        if layers:
            argv += ["--n-layers", str(layers)]
        before = self.live(f"{tag} {arch}")
        self.zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with self.moe.record_routing() as ids:
            r = self.f.serve.run(self.f.serve.parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in self.counts().items() if k in fa.ROUTES}
        cfg = r.model.cfg
        full = self.f.configs.config(arch)
        b, gen = r.tokens.shape
        n_moe = self.moe_layers(cfg)
        # the prefill's routing, then one record a MoE layer for each of the
        # graph's warm-up calls and its capture, none for a replay
        records = len(ids)
        routes = ids[:n_moe]
        del ids
        st = dict(prefill_s=r.prefill_s, serve_s=wall,
                  params=sum(p.numel() for p in r.model.parameters()),
                  flash_launches=launches["flash_wgmma"])
        st.update(self.f.graph_hold(r, f"{tag} {arch}"))
        st["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        want_records = n_moe * (2 + WARMUP)
        _log(f"{tag} {arch} routing records {records} (want {want_records}: the prefill, "
             f"{WARMUP} warm-up calls and the capture, none for the {gen - 1} replays)")
        if records != want_records:
            self.s.fail(f"{tag} {arch}: {records} routing records, not {want_records}")
        cut = (f"depth cut {full.n_layers} -> {cfg.n_layers} layers (float32 weights "
               f"{full.param_count() * 4 / 2**30:.1f} -> {st['params'] * 4 / 2**30:.1f} GiB)"
               if layers else f"not cut ({st['params'] * 4 / 2**30:.1f} GiB of float32 weights)")
        extra = "".join(f", {k} {tuple(v.shape)}" for k, v in r.inputs.items() if k != "tokens")
        _log(f"{tag} {arch}: {self.describe(cfg)}; {st['params']} float32 parameters; {cut}; "
             f"batch {b}, prompt {r.prompts.shape[1]} tokens{extra}, {gen - 1} greedy tokens")
        _log(f"{tag} {arch} prefill_s={r.prefill_s:.4f} decode_s={r.decode_s:.4f} "
             f"decode_tok_s={st['decode_tok_s']:.2f} peak_gib={st['peak_gib']:.3f} "
             f"launches={launches} card={self.card}")
        want = dict.fromkeys(fa.ROUTES, 0)
        want["flash_wgmma"] = flash_want
        has_attn = any(sp.mixer == "attn" for sp in cfg.prefix_spec + cfg.period)
        if not flash_want and has_attn:
            why = (f"v head dim {cfg.mla.v_head_dim} differs from it" if cfg.mla else
                   f"no flash tile takes it (KERNEL_HEAD_DIMS {fa.KERNEL_HEAD_DIMS})")
            _log(f"{tag} {arch}: head_dim {cfg.hd}, {why}, so prefill takes the chunked "
                 "executor: 0 flash launches wanted")
        elif not flash_want:
            _log(f"{tag} {arch}: no attention layer, so 0 flash launches wanted")
        if launches != want:
            self.s.fail(f"{tag} {arch}: prefill launched {launches}, not {want}")
        if st["peak_gib"] > SERVE_PEAK_GIB:
            self.s.fail(f"{tag} {arch}: peak {st['peak_gib']:.3f} GiB over "
                        f"{SERVE_PEAK_GIB} GiB")
        lg = r.prefill_logits
        if (tuple(lg.shape) != (b, 1, cfg.vocab) or not torch.isfinite(lg).all()
                or tuple(r.tokens.shape) != (b, 17) or int(r.tokens.min()) < 0
                or int(r.tokens.max()) >= cfg.vocab or len(routes) != n_moe):
            self.s.fail(f"{tag} {arch}: logits {tuple(lg.shape)}, tokens "
                        f"{tuple(r.tokens.shape)} or {len(routes)} routing records "
                        "misshapen, out of range or not finite")
        model = r.model
        r.decode = r.caches = None  # the graph's pool and the caches, before the next prefill
        self._free()
        self.zero_counts()
        model.cfg = self.with_knob(cfg, knob)
        try:
            t0 = time.perf_counter()
            with self.moe.record_routing() as other_routes:
                other = model.prefill(r.inputs)[0]
            torch.cuda.synchronize()
            st["hold_prefill_s"] = time.perf_counter() - t0
        finally:
            model.cfg = cfg
        if any(self.counts()[k] for k in fa.ROUTES):
            self.s.fail(f"{tag} {arch}: the {knob} prefill launched a flash kernel")
        flips = self.flips(routes, other_routes)
        choices = sum(x.numel() for x in routes)
        err = (lg - other).abs().max().item()
        scale = other.abs().max().item()
        argmax = bool((lg.argmax(-1) == other.argmax(-1)).all())
        close = torch.allclose(lg, other, **LOGIT_TOL)
        if flips:
            ok = argmax and err <= LOGIT16_TOL * scale
            gate = (f"router flips {flips}, so the gate is every argmax equal and "
                    f"max_abs_err <= {LOGIT16_TOL} * max|logit| (rtol 2e-3 atol 2e-4: "
                    f"{close})")
        else:
            ok = argmax and close
            gate = "rtol 2e-3 atol 2e-4 and every argmax equal"
        st.update(logit_err=err, flips=flips, choices=choices)
        what = "flash" if flash_want else ("chunked folded" if has_attn else "as served")
        _log(f"{tag} {arch} hold {what} vs {knob} "
             f"prefill: max_abs_err={err:.3e} max|logit|={scale:.3f} "
             + (f"router_flips={flips} of {choices} (layer, token, slot) choices in "
                f"{len(routes)} MoE layers " if routes else "")
             + f"hold_prefill_s={st['hold_prefill_s']:.4f} gate {gate}: ok={ok} card={self.card}")
        if not ok:
            self.s.fail(f"{tag} {arch}: logits differ from the {knob} prefill's by {err} "
                        f"({flips} router flips)")
        self.stats[f"{tag} {arch}"] = st
        del r, model, lg, other, routes, other_routes
        self._free()
        # the serve, its graph and its pool freed leave nothing allocated (a
        # new capture stream each graph kept a cuBLAS workspace, 32 MiB)
        left = torch.cuda.memory_allocated() / 2**30 - before
        _log(f"{tag} {arch} left allocated after the serve: {left:.4f} GiB (gate 0)")
        if left > 0:
            self.s.fail(f"{tag} {arch}: the serve left {left:.4f} GiB allocated")

    def card_vs_cpu(self, arch: str) -> None:
        """The reduced config's weights made on the CPU (float32, from
        ``--seed``) prefill the same prompts on the CPU and on the card:
        last-token logits within ``LOGIT_TOL`` with every argmax equal, and
        every router choice the same."""
        import copy

        torch = self.torch
        b, s = FAMILY_CPU_HOLD
        cfg = self.f.configs.config(arch, smoke=True).replace(act_dtype="float32",
                                                            param_dtype="float32")
        g = torch.Generator().manual_seed(self.s.seed)
        cpu = self.model_cls(cfg, device="cpu").init(g)
        inputs = {"tokens": torch.randint(0, cfg.vocab, (b, s - cfg.n_patches), generator=g)}
        if cfg.n_patches:
            inputs["patches"] = torch.randn((b, cfg.n_patches, cfg.d_model), generator=g)
        if cfg.encoder_layers:
            inputs["src_embeds"] = torch.randn((b, s, cfg.d_model), generator=g)
        card = copy.deepcopy(cpu).to(self.s.dev)
        with self.moe.record_routing() as cpu_routes:
            want, _ = cpu.prefill(inputs)
        self.zero_counts()
        with self.moe.record_routing() as card_routes:
            got, _ = card.prefill({k: v.to(self.s.dev) for k, v in inputs.items()})
        torch.cuda.synchronize()
        launches = {k: v for k, v in self.counts().items() if k in self.fa.ROUTES and v}
        got = got.cpu()
        flips = self.flips([x.cpu() for x in card_routes], cpu_routes)
        err = (got - want).abs().max().item()
        ok = (torch.allclose(got, want, **LOGIT_TOL) and flips == 0
              and len(card_routes) == len(cpu_routes) == self.moe_layers(cfg)
              and bool((got.argmax(-1) == want.argmax(-1)).all()))
        _log(f"family {arch} card vs cpu reduced {cfg.name} ({self.describe(cfg)}) batch {b} "
             f"prompt {s} positions ({', '.join(inputs)}): max_abs_err={err:.3e} max|logit|={want.abs().max().item():.3f} "
             f"router_flips={flips} in {len(card_routes)} MoE layers card flash "
             f"launches={launches} gate rtol 2e-3 atol 2e-4, every argmax equal, routing "
             f"equal: ok={ok} card={self.card}")
        if not ok:
            self.s.fail(f"family {arch}: the card's reduced prefill differs from the CPU's "
                        f"by {err} with {flips} router flips")
        del cpu, card
        self._free()

    def mlstm_hold(self) -> None:
        """One mLSTM layer at xlstm-350m's full width on ``MLSTM_HOLD``
        tokens: ``mlstm_chunkwise`` (prefill's form, chunk 64, ``m`` from
        -inf) against ``mlstm_recurrent`` stepped token by token (decode's
        form, from the decode cache's start), the outputs and the final
        ``(C, n, m)`` each within ``MLSTM_REL * max|want| + MLSTM_ABS``."""
        from repro_torch.models import xlstm

        torch, dev = self.torch, self.s.dev
        cfg = self.f.configs.config("xlstm-350m").replace(act_dtype="float32",
                                                          param_dtype="float32")
        b, s = MLSTM_HOLD
        g = self.s.gen(97)
        p = xlstm.mlstm_init(g, cfg)
        dp = p["wq"].shape[0]
        x = torch.randn((b, s, dp), generator=g, device=dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs, state = xlstm.mlstm_chunkwise(p, cfg, x)
            torch.cuda.synchronize()
            chunk_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            routs, rstate = xlstm.mlstm_recurrent(
                p, cfg, x, xlstm.init_mlstm_cache(cfg, b, torch.float32, dev))
            torch.cuda.synchronize()
            rec_s = time.perf_counter() - t0
        errs, ok = {}, True
        for name, got, want in zip(("y", "C", "n", "m"), (outs,) + state, (routs,) + rstate[:3]):
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            errs[name] = (err, scale)
            ok = ok and bool(torch.isfinite(got).all()) and err <= MLSTM_REL * scale + MLSTM_ABS
        h = cfg.xlstm.n_heads
        _log(f"family xlstm-350m mlstm hold: one layer dp {dp} heads {h} dh {dp // h} batch {b} "
             f"tokens {s} chunk {cfg.xlstm.chunk}: chunkwise vs recurrent "
             + " ".join(f"{n}_err={e:.3e} max|{n}|={m:.4f}" for n, (e, m) in errs.items())
             + f" gate {MLSTM_REL} * max|want| + {MLSTM_ABS}: ok={ok} chunkwise_s={chunk_s:.4f} "
             f"recurrent_s={rec_s:.4f} card={self.card}")
        self.stats["mlstm hold"] = dict(errs=errs, chunkwise_s=chunk_s, recurrent_s=rec_s)
        if not ok:
            self.s.fail(f"mlstm hold: chunkwise and recurrent differ {errs}")
        del p, x, outs, state, routs, rstate
        self._free()

    def slstm_loop(self) -> None:
        """One sLSTM layer of xlstm-350m at full width on ``MLSTM_HOLD``
        tokens, timed (prefill mode, synchronised): its loop over time is
        a few small ops a token, so its share of xlstm's prefill is
        logged beside it."""
        from repro_torch.models import xlstm

        torch, dev = self.torch, self.s.dev
        cfg = self.f.configs.config("xlstm-350m").replace(act_dtype="float32",
                                                          param_dtype="float32")
        b, s = MLSTM_HOLD
        g = self.s.gen(98)
        p = xlstm.slstm_init(g, cfg)
        x = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
        times = []
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, _ = xlstm.slstm_apply(p, cfg, x, mode="prefill")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        layers = sum(sp.mixer == "slstm" for sp in cfg.period) * cfg.n_periods
        serve = self.stats.get("family xlstm-350m", {})
        per = statistics.median(times)
        share = (f"{layers} layers x {per:.4f} s = {layers * per / serve['hold_prefill_s']:.3f} "
                 f"of the hold prefill's {serve['hold_prefill_s']:.4f} s" if serve else "")
        _log(f"family xlstm-350m slstm loop: one layer d {cfg.d_model} heads "
             f"{cfg.xlstm.n_heads} batch {b} tokens {s}: slstm_s={per:.4f} (of {times}) "
             f"finite={bool(torch.isfinite(out).all())} {share} card={self.card}")
        if not torch.isfinite(out).all():
            self.s.fail("slstm loop: output not finite")
        self.stats["slstm loop"] = dict(slstm_s=per, layers=layers)
        del p, x, out
        self._free()

    def group6(self) -> None:
        """At internlm2-20b's head layout (a GQA group of 6): ``flash_wgmma``
        (float32, S 2048), ``flash16_wgmma`` (bf16, S 2048) and ``flash16``
        (bf16, S 2080, 32-row tiles, the last stacked head group of each
        KV head partly live) against their plain versions, each timed."""
        torch, FL = self.torch, self.fa.FLASH
        b, hq, hkv, d = GROUP6
        for route, dtype, seq, bq in (("flash_wgmma", torch.float32, 2048, 128),
                                      ("flash16_wgmma", torch.bfloat16, 2048, 128),
                                      ("flash16", torch.bfloat16, SMALL_TILE_S, 32)):
            q, k, v = (t.to(dtype) for t in self.f.qkv(b, hq, hkv, seq, d, salt=90))
            scale = d**-0.5
            if self.fa.flash_route(bq, dtype) != route:
                self.s.fail(f"group6: block_q {bq} {dtype} routes to "
                            f"{self.fa.flash_route(bq, dtype)}, not {route}")
            got = FL.kernel("folded", bq, scale, q, k, v)
            torch.cuda.synchronize()
            want = FL.plain("folded", bq, scale, q, k, v)
            shape = (b, hq, hkv, seq, d)
            wgs = self.fa.flash16_warpgroups(bq, hq // hkv) if route == "flash16" else None
            equal = self.f.compare(f"group6 folded shape={shape} block_q={bq}"
                                   + (f" warpgroups={wgs}" if wgs else ""),
                                   route, got, want, v)
            del got, want
            ms = self.s.time_ms(lambda: FL.kernel("folded", bq, scale, q, k, v))
            rate = TF32X3_FLOPS if dtype == torch.float32 else BF16_FLOPS
            bound_ms, bound_by = self.f.bound(b, hq, hkv, seq, d, rate, dtype.itemsize)
            self.rows.append(dict(route=route, dtype=str(dtype)[6:], s=seq, ms=ms,
                                  bound_ms=bound_ms, equal=equal))
            _log(f"group6 case test={route} dtype={str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} "
                 f"S={seq} D={d} block_q={bq} " + (f"warpgroups={wgs} " if wgs else "")
                 + f"ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
                 f"bound_share={bound_ms / ms:.3f} equal={equal} card={self.card}")
            del q, k, v
            self._free()

    # -- training ---------------------------------------------------------

    def update_peaks(self, t):
        """Wrap ``t``'s optimizer so that each update's peak device memory
        is read apart: returns ``(held, in_update)``, the peaks (bytes) of
        the stretches between updates and of each update; the caller adds
        the last stretch's to ``held``."""
        torch = self.torch
        held, in_update, real = [], [], t.opt

        def update(*args, **kw):
            held.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = real.update(*args, **kw)
            in_update.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return out

        t.opt = self.optimizer.Optimizer(real.init, update)
        return held, in_update

    def train_run(self, row: TrainRow) -> None:
        """``launch/train.py`` on ``row``'s config (``train_config``): its
        peak reckoned first (``train_reckoning``); where the row takes the
        flash kernel, the first step's loss and gradient norm with the
        kernel against the plain flash version; then ``row.steps`` steps
        on one repeated batch (frame embeddings with it, or one more step
        with patch embeddings), whose flash launches must be the row's
        flash layers x forward passes (the backward launches none), whose
        loss must fall and whose peak must stay under ``TRAIN_PEAK_GIB``;
        then the attention gradients at one layer's shape and one step of
        the reduced config on the card against the CPU.  Under another
        ``remat`` than "none", ``remat_run`` instead."""
        torch, dev = self.torch, self.s.dev
        arch, batch, seq = row.arch, row.batch, row.seq
        args = self.train.parse_args([
            "--arch", arch, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(row.steps), "--lr", str(TRAIN_LR), "--seed", str(self.s.seed),
            "--log-every", "1"])
        tag = f"train {arch}" + (f" remat {row.remat}" if row.remat != "none" else "")
        full = self.f.configs.config(arch)
        cut = train_config(self.f.configs, row)
        reck = train_reckoning(cut, batch, seq, row.flash)
        base = self.live(tag)
        torch.cuda.reset_peak_memory_stats()
        t = self.train.build(args, cfg=cut)
        cfg = t.model.cfg
        fixed = t.data.batch_at(0)
        g = self.s.gen(99)
        if row.inputs == "src_embeds":
            fixed["src_embeds"] = torch.randn((batch, seq, cfg.d_model), generator=g, device=dev)
        n_params = sum(p.numel() for p in t.model.parameters())
        _log(f"{tag}: {self.describe(cfg)}; {cfg.n_layers} of {full.n_layers} layers at full "
             f"width, {n_params} float32 parameters, {cfg.optimizer}, lr {TRAIN_LR}, batch "
             f"{batch} x seq {seq}" + "".join(f", {k} {tuple(v.shape)}" for k, v in fixed.items()
                                             if k != "tokens")
             + f", {row.steps} steps on one repeated batch; cut: {row.why or 'depth'}; "
             "reckoned GiB " + " ".join(f"{k} {v:.2f}" for k, v in reck.items() if k != "params"))
        if row.remat != "none":
            self.remat_run(tag, args, t, fixed, row.remat)
            self.stats[tag]["reckoned_gib"] = reck["peak"]
            return
        fa = self.fa
        if row.flash:
            # the first step with the plain flash version in the kernel's place
            real = fa.FLASH.kernel
            fa.FLASH.kernel = lambda *a, warpgroups=None: fa.FLASH.plain(*a)
            try:
                loss_p, grads = self.train.loss_and_grads(t.model, fixed)
                gn_p = float(self.optimizer.global_norm(grads))
                loss_p = float(loss_p)
            finally:
                fa.FLASH.kernel = real
            del grads
            self._free()
        # the update's own peak, apart from the rest of each step's
        held, in_update = self.update_peaks(t)
        self.zero_counts()
        self.train.run(args, t, batch_at=lambda step: fixed)
        passes = row.steps
        if row.inputs == "patches":
            # one more step: n_patches patch embeddings, then the text
            text = seq - cfg.n_patches
            patched = {"tokens": fixed["tokens"][:, :text + 1],
                       "patches": torch.randn((batch, cfg.n_patches, cfg.d_model), generator=g,
                                              device=dev)}
            args.steps, t.step0 = row.steps + 1, row.steps
            self.train.run(args, t, batch_at=lambda step: patched)
            passes += 1
        launches = {k: v for k, v in self.counts().items() if k in fa.ROUTES}
        held.append(torch.cuda.max_memory_allocated())
        update_peak, rest_peak = max(in_update) / 2**30, max(held) / 2**30
        peak = max(update_peak, rest_peak)
        step_s = statistics.median(t.step_s[1:row.steps])
        mtp = [x - c - a for x, c, a in zip(t.losses, t.ce, t.aux)]
        st = dict(losses=t.losses, aux=t.aux, grad_norms=t.grad_norms, step_s=step_s,
                  first_step_s=t.step_s[0], tok_s=batch * seq / step_s, peak_gib=peak,
                  base_gib=base, update_peak_gib=update_peak, rest_peak_gib=rest_peak,
                  reckoned_gib=reck["peak"], launches=launches)
        bound = "update" if update_peak >= rest_peak else "backward"
        _log(f"{tag} cut: {row.why or 'depth'}; params={n_params} reckoned_gib="
             f"{reck['peak']:.3f} peak_gib={peak:.3f} ({bound}-bound; the update's "
             f"{update_peak:.3f}, reckoned {reck['update']:.3f}; the rest of the step's "
             f"{rest_peak:.3f}, reckoned {reck['backward']:.3f}; {base:.3f} allocated "
             f"before) step_s={step_s:.4f} (first "
             f"{t.step_s[0]:.4f}) tok_s={st['tok_s']:.1f} losses="
             f"{[round(x, 5) for x in t.losses]} ce={[round(x, 5) for x in t.ce]} "
             + (f"mtp_share={[round(x, 5) for x in mtp]} " if cfg.mtp else "")
             + f"aux={[round(x, 7) for x in t.aux]} grad_norms="
             f"{[round(x, 5) for x in t.grad_norms]} launches={launches} card={self.card}")
        want = dict.fromkeys(fa.ROUTES, 0)
        want["flash_wgmma"] = row.flash * passes
        if launches != want:
            self.s.fail(f"{tag}: flash launches {launches}, not {want} (flash layers "
                        f"{row.flash} x {passes} forward passes; the backward launches none)")
        if peak > TRAIN_PEAK_GIB or reck["peak"] > TRAIN_PEAK_GIB:
            self.s.fail(f"{tag}: peak {peak:.3f} GiB (reckoned {reck['peak']:.3f}) over "
                        f"{TRAIN_PEAK_GIB} GiB")
        if bound == "update" and abs(update_peak - base - reck["update"]) > TRAIN_RECKON_GIB:
            self.s.fail(f"{tag}: the update's peak {update_peak:.3f} GiB ({base:.3f} before) "
                        f"is not within {TRAIN_RECKON_GIB} GiB of its reckoning "
                        f"{reck['update']:.3f}")
        if row.flash:
            rel_loss = abs(t.losses[0] - loss_p) / abs(loss_p)
            rel_gn = abs(t.grad_norms[0] - gn_p) / abs(gn_p)
            ok = rel_loss <= TRAIN_REL and rel_gn <= TRAIN_REL
            _log(f"{tag} first step kernel vs plain flash: loss {t.losses[0]:.6f} vs "
                 f"{loss_p:.6f} (rel {rel_loss:.3e}), grad norm {t.grad_norms[0]:.6f} vs "
                 f"{gn_p:.6f} (rel {rel_gn:.3e}) gate {TRAIN_REL}: ok={ok} card={self.card}")
            if not ok:
                self.s.fail(f"{tag}: kernel and plain flash first steps differ "
                            f"(loss rel {rel_loss}, grad norm rel {rel_gn})")
        text_losses = t.losses[:row.steps]
        if (not all(math.isfinite(x) for x in t.losses)
                or not text_losses[-1] < text_losses[0]):
            self.s.fail(f"{tag}: the loss did not fall over the repeated batch {t.losses}")
        self.stats[tag] = st
        del t, fixed
        self._free()
        if row.flash:
            self.attention_grads(arch, batch, seq, cfg)
        self.train_card_vs_cpu(arch)

    def remat_run(self, tag: str, args, t, fixed, remat: str) -> None:
        """After an untimed step, one forward and backward on ``fixed`` under
        remat "none", "full" and ``remat`` (each step's time, peak memory
        and flash launches, the forward's apart), then ``TRAIN_STEPS`` steps under ``remat``: its
        first step's loss and gradient norm within ``TRAIN_REL`` of
        "none"'s, its loss falling, and its launches ``steps x`` the step's
        (the forward's one a layer, plus one a layer where the backward
        recomputes the attention)."""
        torch, fa = self.torch, self.fa
        cfg = t.model.cfg
        names = [n for n, _ in t.model.named_parameters()]
        params = [p for p in t.model.parameters()]
        # an untimed step first, under a checkpoint: the card's first
        # backward sets up cuBLAS and the allocator, and the first
        # checkpoint imports torch._dynamo (seconds), which would count
        # against the first policy timed
        t.model.cfg = cfg.replace(remat="full")
        torch.autograd.grad(t.model.loss(fixed)[0], params)
        step: dict = {}
        for policy in ("none", "full", remat):
            t.model.cfg = cfg.replace(remat=policy)
            self._free()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            self.zero_counts()
            t0 = time.perf_counter()
            loss, _ = t.model.loss(fixed)
            fwd = self.counts()["flash_wgmma"]
            grads = torch.autograd.grad(loss, params)
            gn = float(self.optimizer.global_norm(dict(zip(names, grads))))
            torch.cuda.synchronize()
            step[policy] = dict(loss=loss.item(), gnorm=gn, step_s=time.perf_counter() - t0,
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                act_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                                fwd=fwd, launches=self.counts()["flash_wgmma"])
            del loss, grads
        t.model.cfg = cfg.replace(remat=remat)
        self._free()
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        self.train.run(args, t, batch_at=lambda i: fixed)
        launches = {k: v for k, v in self.counts().items() if k in fa.ROUTES}
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_s = statistics.median(t.step_s[1:])
        _log(f"{tag} one step on the batch per remat policy: " + "; ".join(
             f"{k}: loss {v['loss']:.6f} grad_norm {v['gnorm']:.6f} step_s {v['step_s']:.4f} "
             f"peak_gib {v['peak_gib']:.3f} (above the weights and state: {v['act_gib']:.3f}) "
             f"flash_wgmma forward {v['fwd']} step {v['launches']}" for k, v in step.items())
             + f" card={self.card}")
        _log(f"{tag} losses={[round(x, 5) for x in t.losses]} grad_norms="
             f"{[round(x, 5) for x in t.grad_norms]} step_s={step_s:.4f} (first "
             f"{t.step_s[0]:.4f}) tok_s={args.batch * args.seq / step_s:.1f} "
             f"peak_gib={peak:.3f} launches={launches} card={self.card}")
        n, mine = cfg.n_layers, step[remat]
        want = dict.fromkeys(fa.ROUTES, 0)
        want["flash_wgmma"] = mine["launches"] * TRAIN_STEPS
        if (mine["fwd"] != n or mine["launches"] not in (n, 2 * n) or launches != want
                or step["none"]["launches"] != n):
            self.s.fail(f"{tag}: flash launches forward {mine['fwd']}, step "
                        f"{mine['launches']}, run {launches} (want forward {n}, step {n} or "
                        f"{2 * n}, run {want}; remat none's step {step['none']['launches']})")
        rel_loss = abs(t.losses[0] - step["none"]["loss"]) / abs(step["none"]["loss"])
        rel_gn = abs(t.grad_norms[0] - step["none"]["gnorm"]) / abs(step["none"]["gnorm"])
        ok = rel_loss <= TRAIN_REL and rel_gn <= TRAIN_REL
        _log(f"{tag} first step vs remat none: loss rel {rel_loss:.3e} grad norm rel "
             f"{rel_gn:.3e} gate {TRAIN_REL}: ok={ok} card={self.card}")
        if not ok:
            self.s.fail(f"{tag}: first step differs from remat none's (loss rel {rel_loss}, "
                        f"grad norm rel {rel_gn})")
        if not all(math.isfinite(x) for x in t.losses) or not t.losses[-1] < t.losses[0]:
            self.s.fail(f"{tag}: the loss did not fall over the repeated batch {t.losses}")
        self.stats[tag] = dict(losses=t.losses, aux=t.aux, grad_norms=t.grad_norms,
                               step_s=step_s, tok_s=args.batch * args.seq / step_s,
                               peak_gib=peak, launches=launches, policies=step)
        del t, fixed, params
        self._free()

    def train_card_vs_cpu(self, arch: str) -> None:
        """One training step's loss and gradients of ``arch``'s reduced
        config (float32), its weights made on the CPU from ``--seed`` as
        ``card_vs_cpu`` makes them, on ``FAMILY_CPU_HOLD``'s batch and
        positions (patch and frame embeddings included) on the CPU and on
        the card: the loss and every gradient leaf's norm within
        ``TRAIN_REL`` relative."""
        import copy

        torch = self.torch
        b, s = FAMILY_CPU_HOLD
        cfg = self.f.configs.config(arch, smoke=True).replace(
            act_dtype="float32", param_dtype="float32", remat="none")
        g = torch.Generator().manual_seed(self.s.seed)
        cpu = self.model_cls(cfg, device="cpu").init(g).requires_grad_(True)
        batch = {"tokens": torch.randint(0, cfg.vocab, (b, s - cfg.n_patches + 1), generator=g)}
        if cfg.n_patches:
            batch["patches"] = torch.randn((b, cfg.n_patches, cfg.d_model), generator=g)
        if cfg.encoder_layers:
            batch["src_embeds"] = torch.randn((b, s, cfg.d_model), generator=g)
        card = copy.deepcopy(cpu).to(self.s.dev)
        want_loss, want = self.train.loss_and_grads(cpu, batch)
        self.zero_counts()
        got_loss, got = self.train.loss_and_grads(
            card, {k: v.to(self.s.dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        launches = {k: v for k, v in self.counts().items() if k in self.fa.ROUTES and v}
        rel = {"loss": abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))}
        for name, w in want.items():
            wn, gn = float(w.norm()), float(got[name].norm())
            rel[name] = abs(gn - wn) / wn if wn else float(gn != 0.0)
        worst = max(rel, key=rel.get)
        ok = all(r <= TRAIN_REL for r in rel.values())  # False on a NaN too
        _log(f"train {arch} card vs cpu reduced {cfg.name} ({self.describe(cfg)}) batch {b} "
             f"positions {s} ({', '.join(batch)}): loss {float(got_loss):.6f} vs "
             f"{float(want_loss):.6f} rel {rel['loss']:.3e}; {len(want)} gradient leaves, "
             f"the furthest {worst} rel {rel[worst]:.3e} gate {TRAIN_REL}: ok={ok} card flash "
             f"launches={launches} card={self.card}")
        if not ok:
            self.s.fail(f"train {arch}: the card's reduced training step differs from the "
                        f"CPU's: {worst} rel {rel[worst]}")
        del cpu, card, want, got
        self._free()

    def attention_grads(self, arch, b, s, cfg) -> None:
        """At one layer's attention shape: q, k, v (and, at a quarter of
        the sequence, a per-head bias) through ``FlashFunction`` and through
        autograd of ``_reference_attention``; the gradients must agree
        within ``1e-6 * max|g|``, and bit for bit is expected (the backward
        runs those very ops on the same inputs)."""
        torch, fa = self.torch, self.fa
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        for seq, bias_on in ((s, False), (s // 4, True)):
            q, k, v = (t.requires_grad_(True) for t in self.f.qkv(b, hq, hkv, seq, d,
                                                                   salt=95))
            g = self.s.gen(96)
            bias = (torch.randn((1, hq, seq, seq), generator=g, device=self.s.dev)
                    .requires_grad_(True) if bias_on else None)
            cot = torch.randn((b, hq, seq, d), generator=g, device=self.s.dev)
            wrt = [q, k, v] + ([bias] if bias_on else [])
            self.zero_counts()
            out = fa.flash_attention(q, k, v, bias=bias, device=q.device)
            fwd = dict(self.counts())
            got = torch.autograd.grad(out, wrt, cot)
            torch.cuda.synchronize()
            bwd = {r: self.counts()[r] - fwd[r] for r in fa.ROUTES}
            ref = fa._reference_attention(q, k, v, bias, None, d**-0.5)
            want = torch.autograd.grad(ref, wrt, cot)
            names = ("dq", "dk", "dv", "dbias")
            errs = {n: (x - y).abs().max().item() for n, x, y in zip(names, got, want)}
            exact = all(torch.equal(x, y) for x, y in zip(got, want))
            ok = all(errs[n] <= 1e-6 * y.abs().max().item() for n, y in zip(names, want))
            ok = ok and not any(bwd.values()) and out.grad_fn.name() == "FlashFunctionBackward"
            _log(f"train {arch} attention grads shape={(b, hq, hkv, seq, d)} bias={bias_on}: "
                 f"FlashFunction vs autograd of _reference_attention max_abs_err={errs} "
                 f"bit_equal={exact} backward flash launches={sum(bwd.values())} ok={ok} "
                 f"card={self.card}")
            if not ok:
                self.s.fail(f"train {arch}: attention gradients {errs}, backward launches "
                            f"{bwd}")
            del q, k, v, bias, cot, out, got, ref, want
            self._free()




# The tuner phase: (m, n, rho) per case, PERF.md's sizes; CA at m <= 3.
TUNER_CASES = ((2, 16384, 16), (2, 16000, 16), (3, 1024, 8), (3, 960, 8), (4, 64, 4),
               (4, 60, 4))
# The pick's time over the fastest candidate's, at most: the tuner's rule
# is body-independent and ACCUM is what its model describes.
TUNER_GATE = {"accum": 1.10, "edm": 1.25, "ca": 1.25}
# A timed sample of a tuner candidate runs back-to-back calls for at
# least this long, so that a launch-bound case times its host work too;
# the candidates of a case take turns, TUNER_ROUNDS samples each, and the
# median sample counts (the host's clock drifts between candidates).
TUNER_SAMPLE_MS = 5.0
TUNER_ROUNDS = 9
# A launch-bound case, whose fastest call takes under TUNER_LAUNCH_BOUND_MS,
# times the host more than the kernels: its 5 ms samples spread by about
# 12 % between quartiles (ACCUM m=4 n=60, 201 rounds, PERF.md §6), so
# 9 rounds let the medians of tied candidates part by more than the gate.
# Its candidates take TUNER_ROUNDS_LAUNCH_BOUND rounds.
TUNER_LAUNCH_BOUND_MS = 0.1
TUNER_ROUNDS_LAUNCH_BOUND = 101
# The attention tuner: (B, Hq, Hkv, S, D) and dtype; the pick within 1.10x.
ATTN_TUNER_CASES = (((4, 32, 4, 2048, 128), "float32"), ((4, 32, 4, 2048, 128), "bfloat16"),
                    ((4, 32, 4, SMALL_TILE_S, 128), "bfloat16"))
ATTN_TUNER_GATE = 1.10
# The attention executors' calls take 0.7-20 ms, and a flash executor's
# sample runs slower right after the chunked executor's than right after
# the other flash executor's (scripts/attn_turns.py): with 9 rounds in a
# fixed order, the pick, which followed chunked, once read 1.172x the
# fastest, an executor of the same kernel (ROADMAP C.7; NVIDIA H100 80GB
# HBM3, 700 W).  The attention candidates take ATTN_TUNER_ROUNDS rounds of
# samples of at least ATTN_TUNER_SAMPLE_MS, in an order that turns each
# round, so that no executor always follows the same one.
ATTN_TUNER_ROUNDS = 41
ATTN_TUNER_SAMPLE_MS = 20.0
# The calls of one sample, at most.
TUNER_MAX_CALLS = 200


def tuner_rounds(one_ms: dict, attention: bool = False) -> tuple:
    """The turn-taking timer's rule: for candidates whose single calls
    take ``one_ms`` (ms, by key), ``(rounds, calls a sample by key)``.
    Attention cases take ``ATTN_TUNER_ROUNDS`` rounds of samples of at
    least ``ATTN_TUNER_SAMPLE_MS``; the simplex cases ``TUNER_ROUNDS`` of
    at least ``TUNER_SAMPLE_MS``, ``TUNER_ROUNDS_LAUNCH_BOUND`` where the
    fastest call takes under ``TUNER_LAUNCH_BOUND_MS``.

    Example:
        >>> tuner_rounds({"hmap": 0.5, "bb": 1.0})
        (9, {'hmap': 10, 'bb': 5})
        >>> tuner_rounds({"flash-folded": 0.8, "chunked": 12.0}, attention=True)
        (41, {'flash-folded': 25, 'chunked': 2})
    """
    sample = ATTN_TUNER_SAMPLE_MS if attention else TUNER_SAMPLE_MS
    calls = {key: max(1, min(TUNER_MAX_CALLS, math.ceil(sample / max(ms, 1e-3))))
             for key, ms in one_ms.items()}
    if attention:
        return ATTN_TUNER_ROUNDS, calls
    if min(one_ms.values()) < TUNER_LAUNCH_BOUND_MS:
        return TUNER_ROUNDS_LAUNCH_BOUND, calls
    return TUNER_ROUNDS, calls


def flash_grid(route: str, kind: str, block_q: int, b: int, hq: int, hkv: int, s: int,
               warpgroups) -> int:
    """Blocks of a flash kernel's launch, as its launcher counts them
    (``flash_args`` in ``csrc/flash_common.cuh``; ``flash16_stacked_launch``
    stacks the heads of a GQA group): a row of folded tile pairs, or of
    query tiles, for each (batch, head) or stacked head group."""
    nq = s // block_q
    rows = (nq + 1) // 2 if kind == "folded" else nq
    if route == "flash16":
        stack = warpgroups * (64 // block_q)
        return b * hkv * -(-(hq // hkv) // stack) * rows
    return b * hq * rows
# executor='xla' against the kernels: ACCUM int32 (m, n, rho), MAP (m, nb).
XLA_ACCUM_CASES = ((2, 16384, 16), (3, 1024, 8), (4, 64, 4))
XLA_MAP_CASES = ((2, 16384), (3, 512))


class TunerSmoke:
    """The autotuner on the card: the cost model's constants measured
    the way ``roofline/analysis.py`` says, every candidate the tuner ranks
    timed against its pick, the attention executors likewise, and the
    fused torch executors (``executor='xla'``) against the kernels.

    Shares the simplex ``Smoke``'s generators, timer and failure list.
    """

    def __init__(self, smoke: Smoke, card: str):
        from repro_torch.autotune import tuner
        from repro_torch.roofline import analysis

        self.s, self.card = smoke, card
        self.torch, self.engine, self.ops = smoke.torch, smoke.engine, smoke.ops
        self.tuner, self.analysis = tuner, analysis
        self.rounds = TUNER_ROUNDS  # of the last ``batch_ms``
        self.calls: dict = {}  # calls a sample, of the last ``batch_ms``
        self.spread: dict = {}  # (min, median, max) of the last ``batch_ms``

    def batch_ms(self, fns: dict, attention: bool = False) -> dict:
        """Per function of ``fns``, the median time of one call over the
        rounds ``tuner_rounds`` gives, each a sample of back-to-back calls,
        the functions taking turns (for ``attention``, starting each round
        one function further on)."""
        ones = {key: self.s.time_ms(fn, runs=3, warm=1) for key, fn in fns.items()}
        rounds, self.calls = tuner_rounds(ones, attention)
        self.rounds = rounds
        keys = list(fns)
        samples = {key: [] for key in fns}
        for r in range(rounds):
            turn = r % len(keys) if attention else 0
            for key in keys[turn:] + keys[:turn]:
                fn, n = fns[key], self.calls[key]
                samples[key].append(
                    self.s.time_ms(lambda: [fn() for _ in range(n)], runs=1, warm=0) / n)
        self.spread = {key: (min(v), statistics.median(v), max(v)) for key, v in samples.items()}
        return {key: med for key, (_, med, _) in self.spread.items()}

    def constants(self) -> None:
        """Measure each constant of the cost model and print it beside the
        model's value."""
        torch, engine, A = self.torch, self.engine, self.analysis
        from repro_torch.core.schedule import SimplexSchedule

        dev = self.s.dev
        got = {}
        a = torch.empty(1 << 28, device=dev)
        b = torch.empty_like(a)
        got["HBM_BW"] = 2 * a.numel() * 4 / (self.s.time_ms(lambda: b.copy_(a)) / 1e3)
        del a, b
        body = engine.get_body("accum")
        x = torch.zeros((256,) * 3, dtype=torch.int32, device=dev)
        per_step = {}
        for kind in ("bb", "table", "hmap", "composite"):
            sched = engine.schedule_for(3, 256, kind)
            ms = self.s.time_ms(lambda: body.kernel_(x, sched, 1))
            per_step[kind] = ms / 1e3 / sched.steps
            _log(f"tuner step accum m=3 n=256 rho=1 kind={kind} steps={sched.steps} "
                 f"ms={ms:.4f} ns_per_step={per_step[kind] * 1e9:.4f}")
        del x
        got["PREDICATE_S"] = per_step["bb"]
        got["SMEM_READ_S"] = per_step["table"]
        got["SELECT_S"] = per_step["hmap"] / (255).bit_length()
        x = torch.zeros((60,) * 4, dtype=torch.int32, device=dev)
        pieces = len(engine.launch_plan(4, 15, "composite", True, True))
        fused, split = self.batch_ms({
            split: (lambda split=split: engine.accum_(x, rho=4, kind="composite", split=split))
            for split in (False, True)}).values()
        got["LAUNCH_OVERHEAD_S"] = (split - fused) / 1e3 / (pieces - 1)
        _log(f"tuner step accum_ m=4 n=60 rho=4 composite fused_ms={fused:.4f} "
             f"split_ms={split:.4f} launches={pieces}")
        del x
        fresh = SimplexSchedule(3, 256, "table")
        t0 = time.perf_counter()
        fresh.prefetch
        got["HOST_ENUM_S"] = (time.perf_counter() - t0) / fresh.useful
        peaks = {}
        for name in A.ATTN_PEAK_FLOPS:
            m = torch.randn((8192, 8192), device=dev).to(getattr(torch, name))
            peaks[name] = 2 * 8192**3 / (self.s.time_ms(lambda: m @ m, runs=5) / 1e3)
            del m
        for name, value in got.items():
            _log(f"tuner constant {name} measured={value:.4e} model={getattr(A, name):.4e} "
                 f"card={self.card}")
        for name, value in peaks.items():
            _log(f"tuner constant ATTN_PEAK_FLOPS[{name}] measured={value:.4e} "
                 f"model={A.ATTN_PEAK_FLOPS[name]:.4e} card={self.card}")
        torch.cuda.empty_cache()

    def kinds(self) -> None:
        """Every candidate of every case timed; the tuner's pick (kind and
        ``split=None`` choice) within ``TUNER_GATE`` of the fastest, and the
        entry points' defaults launching that pick."""
        for test in ("accum", "edm", "ca"):
            for m, n, rho in TUNER_CASES:
                if test == "ca" and m > 3:
                    continue
                self.case(test, m, n, rho)
                self.torch.cuda.empty_cache()

    def data(self, test, m, n):
        """The input of (test, m, n): int32 values, points, or a 0/1 state
        on the simplex."""
        torch, s = self.torch, self.s
        if test == "accum":
            return torch.randint(0, 100, (n,) * m, generator=s.gen(200 + m), device=s.dev,
                                 dtype=torch.int32)
        if test == "edm":
            return torch.randn((n, EDM_D), generator=s.gen(210 + m), device=s.dev)
        msk = s.ref.simplex_mask(m, n, torch.int32, s.dev)
        return (torch.rand((n,) * m, generator=s.gen(220 + m), device=s.dev)
                < CA_DENSITY[m]).to(torch.int32) * msk

    def default_call(self, test, m, x, rho, **kw):
        """The entry point of ``ops`` for (test, m) with ``kw`` on top of
        its defaults."""
        ops = self.ops
        if test == "accum":
            fn = {2: ops.simplex_accum2d, 3: ops.simplex_accum3d}.get(m, ops.simplex_accum_md)
            return fn(x, rho=rho, **kw)
        if test == "edm":
            return (ops.simplex_edm2d(x, rho=rho, **kw) if m == 2 else
                    ops.simplex_edm_md(x, m, rho=rho, **kw))
        return (ops.simplex_ca2d if m == 2 else ops.simplex_ca3d)(x, rho=rho, **kw)

    def case(self, test, m, n, rho) -> None:
        """One (test, m, n): every candidate's launches timed, the pick
        against the fastest, the default call against the pick."""
        torch, engine, tuner = self.torch, self.engine, self.tuner
        body = engine.get_body(test)
        nb, dev = n // rho, self.s.dev
        x = self.data(test, m, n)
        out = torch.zeros((n,) * m, device=dev) if test == "edm" else x.clone()

        def launch(sched):
            if test == "accum":
                body.kernel_(out, sched, rho)
            else:
                body.kernel_(out, x, sched, rho)

        def walk(kind, split):
            for sched in engine.launch_plan(m, nb, kind, split, body.element_local,
                                            device=dev):
                launch(sched)

        variants = [(kind, split) for kind in tuner.candidate_kinds(m, nb)
                    for split in ((False, True) if kind == "composite" and body.element_local
                                  else (False,))]
        times = self.batch_ms({v: (lambda v=v: walk(*v)) for v in variants})
        del out
        dec = tuner.choose_kind(m, nb, dev)
        plan = engine.launch_plan(m, nb, "auto", None, body.element_local, device=dev)
        pick = (dec.kind, len(plan) > 1)
        before = body.launches
        got = self.default_call(test, m, x, rho)
        torch.cuda.synchronize()
        launched = body.launches - before
        want = self.default_call(test, m, x, rho, kind=pick[0],
                                 **({"split": pick[1]} if m > 2 and test != "ca" else {}))
        same = torch.equal(got, want)
        del got, want, x
        best = min(times, key=times.get)
        ratio = times[pick] / times[best]
        gate = TUNER_GATE[test]
        ok = ratio <= gate and same and launched == len(plan)
        scores = {k: round(v, 3) for k, v in dec.scores_us.items()}
        cands = " ".join(f"{k}{'+split' if sp else ''}={t:.4f}" for (k, sp), t in times.items())
        _log(f"tuner case test={test} m={m} n={n} rho={rho} nb={nb} decision kind={dec.kind} "
             f"source={dec.source} split={pick[1]} scores_us={json.dumps(scores)} "
             f"candidates_ms {cands} rounds={self.rounds} pick_ms={times[pick]:.4f} "
             f"fastest={best[0]}"
             f"{'+split' if best[1] else ''} ratio={ratio:.3f} gate={gate:.2f} "
             f"default_launches={launched} default_equal={same} ok={ok}")
        if not ok:
            self.s.fail(f"tuner {test} m={m} n={n}: pick {pick} at {ratio:.3f}x the fastest "
                        f"{best} (gate {gate}), default call equal={same}, "
                        f"launches {launched} for a plan of {len(plan)}")

    def attention(self) -> None:
        """At each shape: ``choose_attn_impl``'s decision, the three
        executors timed through ``simplex_attention``, the pick within
        ``ATTN_TUNER_GATE`` of the fastest, and the default dispatch
        launching the pick's flash kernel (or none, for chunked)."""
        torch, tuner = self.torch, self.tuner
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.models.attention import simplex_attention

        impls = ("flash-folded", "flash-bb", "chunked")
        for (b, hq, hkv, s, d), name in ATTN_TUNER_CASES:
            dt = getattr(torch, name)
            g = self.s.gen(230 + s % 97)
            q, k, v = (torch.randn((b, h, s, d), generator=g, device=self.s.dev).to(dt)
                       for h in (hq, hkv, hkv))
            dec = tuner.choose_attn_impl(s, hq, d, self.s.dev, dt)
            # what each executor launches: the kernel, block_q and grid
            real, seen = fa.FLASH.kernel, []

            def record(kind, block_q, *a, warpgroups=None, **kw):
                route = fa.flash_route(block_q, dt)
                wgs = (warpgroups or fa.flash16_warpgroups(block_q, hq // hkv)
                       if route == "flash16" else None)
                seen.append(f"{route} block_q={block_q} grid="
                            f"{flash_grid(route, kind, block_q, b, hq, hkv, s, wgs)}"
                            + (f" warpgroups={wgs}" if wgs else ""))
                return real(kind, block_q, *a, warpgroups=warpgroups, **kw)

            launched_by = {}
            fa.FLASH.kernel = record
            try:
                for impl in impls:
                    seen.clear()
                    simplex_attention(q, k, v, impl=impl)
                    launched_by[impl] = "; ".join(seen) or "no kernel"
            finally:
                fa.FLASH.kernel = real
            torch.cuda.synchronize()
            times = self.batch_ms({
                impl: (lambda impl=impl: simplex_attention(q, k, v, impl=impl))
                for impl in impls}, attention=True)
            pick = "chunked" if dec.impl == "chunked" else f"flash-{dec.kind}"
            before = sum(fa.launch_counts().values())
            simplex_attention(q, k, v)
            torch.cuda.synchronize()
            launched = sum(fa.launch_counts().values()) - before
            best = min(times, key=times.get)
            ratio = times[pick] / times[best]
            ok = ratio <= ATTN_TUNER_GATE and launched == (pick != "chunked")
            scores = {kk: round(vv, 3) for kk, vv in dec.scores_us.items()}
            _log(f"attn_tuner case B={b} Hq={hq} Hkv={hkv} S={s} D={d} {name} decision "
                 f"impl={dec.impl} kind={dec.kind} block_q={dec.block_q} source={dec.source} "
                 f"scores_us={json.dumps(scores)} "
                 + " ".join(f"{kk}_ms={vv:.4f}" for kk, vv in times.items())
                 + f" pick={pick} fastest={best} ratio={ratio:.3f} "
                 f"gate={ATTN_TUNER_GATE:.2f} default_launches={launched} ok={ok} "
                 f"rounds={self.rounds} calls_a_sample={json.dumps(self.calls)} "
                 "min/median/max_ms " + " ".join(
                     f"{kk}={lo:.4f}/{med:.4f}/{hi:.4f}"
                     for kk, (lo, med, hi) in self.spread.items())
                 + " launches " + " | ".join(f"{kk}: {vv}" for kk, vv in launched_by.items())
                 + f" card={self.card}")
            if not ok:
                self.s.fail(f"attn_tuner S={s} {name}: pick {pick} at {ratio:.3f}x the "
                            f"fastest {best}, {launched} flash launches")
            del q, k, v
            torch.cuda.empty_cache()

    def xla(self) -> None:
        """``executor='xla'`` (torch ops) bit-equal to ``executor='kernel'``
        for ACCUM and MAP, both timed through the engine."""
        torch, engine = self.torch, self.engine
        for m, n, rho in XLA_ACCUM_CASES:
            x = self.data("accum", m, n)
            got = engine.accum(x, rho=rho, executor="xla")
            want = engine.accum(x, rho=rho)
            same = torch.equal(got, want)
            del got, want
            ms = {ex: self.s.time_ms(lambda: engine.accum(x, rho=rho, executor=ex), runs=5)
                  for ex in ("xla", "kernel")}
            kind = engine.schedule_for(m, n // rho, "auto", self.s.dev).kind
            _log(f"xla check accum int32 m={m} n={n} rho={rho} kind={kind} "
                 f"xla_ms={ms['xla']:.4f} kernel_ms={ms['kernel']:.4f} equal={same}")
            if not same:
                self.s.fail(f"xla accum m={m} n={n}: executor='xla' differs from the kernel")
            del x
            torch.cuda.empty_cache()
        for m, nb in XLA_MAP_CASES:
            got = engine.map_table(nb, m=m, executor="xla")
            want = engine.map_table(nb, m=m)
            same = torch.equal(got, want)
            del got, want
            ms = {ex: self.s.time_ms(lambda: engine.map_table(nb, m=m, executor=ex), runs=5)
                  for ex in ("xla", "kernel")}
            _log(f"xla check map m={m} nb={nb} kind=hmap xla_ms={ms['xla']:.4f} "
                 f"kernel_ms={ms['kernel']:.4f} equal={same}")
            if not same:
                self.s.fail(f"xla map m={m} nb={nb}: executor='xla' differs from the kernel")
            torch.cuda.empty_cache()


# The shard phase: the sharded simplex path at the paper's sizes, (m, n,
# rho, kind) per base walk, each folded k ways for k in SHARD_KS; MAP also
# over the main path's m=2 walk (nb = 16384).  The plain versions are held
# at SHARD_PLAIN_K shards; the CA executors step SHARD_GENERATIONS times.
SHARD_CASES = ((2, 16384, 16, "hmap"), (3, 1024, 8, "hmap"), (2, 16000, 16, "composite"))
SHARD_MAP_NB = 16384
SHARD_KS = (2, 4, 8)
SHARD_PLAIN_K = 2
SHARD_GENERATIONS = 3
SHARD_PEAK_GIB = 75.0


class ShardSmoke:
    """The sharded simplex path on the card (``distributed/
    simplex_sharding.py``): shard schedules launched through the MAP,
    ACCUM, EDM and CA kernels by their device descriptors, the engine
    executor of the sharded CA on ``devices=[cuda:0]``, and its SPMD
    executor on a one-rank NCCL group.

    Shares the simplex ``Smoke``'s generators, timer and failure list.
    """

    def __init__(self, smoke: Smoke, sharding, card: str):
        self.s, self.sharding, self.card = smoke, sharding, card
        self.torch, self.engine, self.ref = smoke.torch, smoke.engine, smoke.ref
        self.rows: list = []  # per (test, case, k): times and skews
        self.err_edm = 0.0

    def _row(self, test, m, n, rho, kind, k, **kw) -> dict:
        row = dict(test=test, m=m, n=n, rho=rho, kind=kind, k=k, **kw)
        self.rows.append(row)
        return row

    def _kernel(self, body, m, rho, sched):
        return self.engine.SimplexKernel(body, m, rho=rho, schedule=sched)

    def path(self) -> None:
        """Every check of the phase, each shard launched through its
        ``SimplexKernel(body, m, schedule=shard)``."""
        torch, engine = self.torch, self.engine
        base = engine.schedule_for(2, SHARD_MAP_NB, "hmap")
        self._map(2, SHARD_MAP_NB, base)
        for m, n, rho, kind in SHARD_CASES:
            base = engine.schedule_for(m, n // rho, kind)
            self._map(m, n // rho, base)
            self._accum(m, n, rho, base)
            self._edm(m, n, rho, base)
            self._ca(m, n, rho, base)
            torch.cuda.empty_cache()
        self._spmd()

    def _ranges_index(self, shards):
        """The base steps of ``shards`` in shard order, and whether they
        cover the base walk once."""
        torch = self.torch
        idx = torch.cat([torch.arange(a, b, device=self.s.dev)
                         for sh in shards for a, b in sh.ranges])
        base = shards[0].base
        covers = torch.equal(torch.sort(idx).values,
                             torch.arange(base.steps, device=self.s.dev))
        return idx, covers

    def _map(self, m, nb, base) -> None:
        torch, body = self.torch, self.engine.get_body("map")
        fused = self._kernel("map", m, 1, base)(nb)
        for k in SHARD_KS:
            shards = self.sharding.shard_schedules(base, k)
            tables = [self._kernel("map", m, 1, sh)(nb) for sh in shards]
            torch.cuda.synchronize()
            idx, covers = self._ranges_index(shards)
            equal = covers and torch.equal(torch.cat(tables), fused[idx])
            plain = True
            if k == SHARD_PLAIN_K:
                plain = all(torch.equal(t, body.plain(sh, self.s.dev))
                            for t, sh in zip(tables, shards))
            _log(f"shard check map m={m} nb={nb} kind={base.kind} k={k} covers={covers} "
                 f"equal={equal}" + (f" plain_equal={plain}" if k == SHARD_PLAIN_K else ""))
            if not (equal and plain):
                self.s.fail(f"shard map m={m} nb={nb} k={k}")
            self._row("map", m, nb, 1, base.kind, k, shards=shards, base=base)
            del tables, idx

    def _accum(self, m, n, rho, base) -> None:
        torch, body = self.torch, self.engine.get_body("accum")
        x0 = torch.zeros((n,) * m, dtype=torch.int32, device=self.s.dev)
        fused = self._kernel("accum", m, rho, base)(x0)
        for k in SHARD_KS:
            shards = self.sharding.shard_schedules(base, k)
            total = torch.zeros_like(x0)
            plain = True
            for sh in shards:
                out = self._kernel("accum", m, rho, sh)(x0)
                total += out
                if k == SHARD_PLAIN_K:
                    want = x0.clone()
                    body.plain_(want, sh, rho)
                    plain = plain and torch.equal(out, want)
                    del want
                del out
            torch.cuda.synchronize()
            equal = torch.equal(total, fused)
            _log(f"shard check accum m={m} n={n} rho={rho} kind={base.kind} k={k} "
                 f"sum_equal={equal}" + (f" plain_equal={plain}" if k == SHARD_PLAIN_K else ""))
            if not (equal and plain):
                self.s.fail(f"shard accum m={m} n={n} k={k}")
            self._row("accum", m, n, rho, base.kind, k, shards=shards, base=base)
            del total
        del x0, fused

    def _edm(self, m, n, rho, base) -> None:
        torch, body = self.torch, self.engine.get_body("edm")
        p = torch.randn((n, EDM_D), generator=self.s.gen(60 + m), device=self.s.dev)
        fused = self._kernel("edm", m, rho, base)(p)
        tol = 1e-5 + 1e-5 * fused.abs().max().item()
        for k in SHARD_KS:
            shards = self.sharding.shard_schedules(base, k)
            total = torch.zeros_like(fused)
            err = 0.0
            for sh in shards:
                out = self._kernel("edm", m, rho, sh)(p)
                total += out
                if k == SHARD_PLAIN_K:
                    want = torch.zeros_like(out)
                    body.plain_(want, p, sh, rho)
                    err = max(err, (out - want).abs().max().item())
                    del want
                del out
            torch.cuda.synchronize()
            equal = torch.equal(total, fused)
            diff = (total - fused).abs().max().item()
            self.err_edm = max(self.err_edm, err)
            _log(f"shard check edm m={m} n={n} rho={rho} kind={base.kind} k={k} "
                 f"sum_equal={equal} max_abs_diff={diff:.3e}"
                 + (f" plain_max_abs_err={err:.3e} tol={tol:.3e}" if k == SHARD_PLAIN_K
                    else ""))
            if not equal or not math.isfinite(err) or err > tol:
                self.s.fail(f"shard edm m={m} n={n} k={k}")
            self._row("edm", m, n, rho, base.kind, k, shards=shards, base=base, p=p)
            del total
        del fused

    def _state(self, m, n):
        torch = self.torch
        msk = self.ref.simplex_mask(m, n, torch.int32, self.s.dev)
        return (torch.rand((n,) * m, generator=self.s.gen(70 + m), device=self.s.dev)
                < CA_DENSITY[m]).to(torch.int32) * msk

    def _ca(self, m, n, rho, base) -> None:
        torch, body = self.torch, self.engine.get_body("ca")
        fused = self._kernel("ca", m, rho, base)
        s0 = self._state(m, n)
        for k in SHARD_KS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runner = self.sharding.ShardedSimplexCA(m, n, k, rho=rho, kind=base.kind,
                                                    devices=[self.s.dev])
            cur, equal, plain = s0, True, True
            for gen in range(SHARD_GENERATIONS):
                outs = runner.shard_outputs(cur)
                if k == SHARD_PLAIN_K and gen == 0:
                    for out, sh in zip(outs, runner.shards):
                        want = cur.clone()
                        body.plain_(want, cur, sh, rho)
                        plain = plain and torch.equal(out, want)
                        del want
                nxt = runner.stitch(cur, outs)
                del outs
                equal = equal and torch.equal(nxt, fused(cur))
                cur = nxt
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            _log(f"shard check ca engine m={m} n={n} rho={rho} kind={base.kind} k={k} "
                 f"generations={SHARD_GENERATIONS} equal={equal} peak_gib={peak:.3f}"
                 + (f" plain_equal={plain}" if k == SHARD_PLAIN_K else ""))
            if not (equal and plain) or peak > SHARD_PEAK_GIB:
                self.s.fail(f"shard ca engine m={m} n={n} k={k}")
            self._row("ca", m, n, rho, base.kind, k, shards=runner.shards, base=base,
                      runner=runner, peak_gib=peak)
            del cur, nxt

    def _spmd(self) -> None:
        """The SPMD executor on the one-rank NCCL group ``main`` opened,
        three generations of each case bit-equal to the fused engine
        launches."""
        import torch.distributed as dist

        torch = self.torch
        mesh = self.sharding.shard_mesh(1, device=self.s.dev)
        try:
            self.sharding.shard_mesh(2, device=self.s.dev)
            self.s.fail("shard_mesh(2) on a one-rank group did not raise")
        except ValueError:
            pass
        for m, n, rho, kind in SHARD_CASES:
            base = self.engine.schedule_for(m, n // rho, kind)
            fused = self._kernel("ca", m, rho, base)
            runner = self.sharding.ShardedSimplexCA(m, n, 1, rho=rho, kind=base.kind, mesh=mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cur = want = self._state(m, n)
            t0 = time.perf_counter()
            for _ in range(SHARD_GENERATIONS):
                cur = runner.step(cur, executor="spmd")
                want = fused(want)
            full = cur.full_tensor()
            torch.cuda.synchronize()
            equal = torch.equal(full, want)
            ms = self.s.time_ms(lambda: runner.step(cur, executor="spmd"), runs=3, warm=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            _log(f"shard check ca spmd m={m} n={n} kind={base.kind} ranks=1 "
                 f"backend={dist.get_backend()} generations={SHARD_GENERATIONS} "
                 f"equal={equal} step_ms={ms:.4f} peak_gib={peak:.3f} "
                 f"({time.perf_counter() - t0:.1f} s) card={self.card}")
            if not equal or peak > SHARD_PEAK_GIB:
                self.s.fail(f"shard ca spmd m={m} n={n}")
            del cur, want, full
            torch.cuda.empty_cache()

    def timings(self) -> None:
        """Time each shard's kernel beside the fused walk's, the CA
        executor's stitch and whole step, and print one line per
        (test, case, k)."""
        torch, engine = self.torch, self.engine
        dev = self.s.dev
        for row in self.rows:
            test, m, n, rho, k = row["test"], row["m"], row["n"], row["rho"], row["k"]
            body, scheds = engine.get_body(test), [row["base"], *row["shards"]]
            extra = ""
            if test == "map":
                times = [self.s.time_ms(lambda: body.kernel(sh, 128, dev)) for sh in scheds]
            elif test == "accum":
                buf = torch.zeros((n,) * m, dtype=torch.int32, device=dev)
                times = [self.s.time_ms(lambda: body.kernel_(buf, sh, rho)) for sh in scheds]
                del buf
            elif test == "edm":
                out = torch.zeros((n,) * m, device=dev)
                times = [self.s.time_ms(lambda: body.kernel_(out, row["p"], sh, rho))
                         for sh in scheds]
                del out
            else:
                st = self._state(m, n)
                out = st.clone()
                times = [self.s.time_ms(lambda: body.kernel_(out, st, sh, rho))
                         for sh in scheds]
                del out
                runner = row["runner"]
                outs = runner.shard_outputs(st)
                stitch = self.s.time_ms(lambda: runner.stitch(st, outs), runs=5, warm=1)
                del outs
                step = self.s.time_ms(lambda: runner.step_engine(st), runs=5, warm=1)
                extra = (f" stitch_ms={stitch:.4f} step_ms={step:.4f} "
                         f"peak_gib={row['peak_gib']:.3f}")
                del st
                torch.cuda.empty_cache()
            fused, shard = times[0], times[1:]
            row.update(fused_ms=fused, shard_ms=shard)
            nb = row["base"].n
            _log(f"shard case test={test} m={m} n={n} rho={rho} kind={row['kind']} k={k} "
                 f"fused_ms={fused:.4f} shard_ms={[round(t, 4) for t in shard]} "
                 f"sum_ms={sum(shard):.4f} max_over_mean={max(shard) / statistics.mean(shard):.4f} "
                 f"shard_skew={self.sharding.shard_skew(row['base'], k):.5f} "
                 f"slab_skew={self.sharding.slab_skew(m, nb, k):.4f}{extra} card={self.card}")
        for row in self.rows:  # drop the tensors and launchers the rows held
            for key in ("p", "runner", "shards", "base"):
                row.pop(key, None)


# The mesh phase: the LM half of distribution (distributed/sharding.py,
# distributed/collectives.py, launch/mesh.py, launch/steps.py) on the
# one-rank NCCL group of the shard phase, a (1, 1) data/model mesh, so
# every collective of the mesh forms runs on NCCL over one rank.
# Serve: (arch, batch, prompt, greedy tokens) at full width and depth,
# float32, held against the mesh-less serve on the same weights.
MESH_SERVE = ("yi-6b", 4, 2048, 16)
# Train: (arch, layers, batch, seq, steps) at full width, float32, the
# config's optimizer (yi-6b AdamW, internlm2-20b Adafactor), each at the
# train phase's cut of the same arch; the first step held against
# launch/train.train_step's on the same weights: the loss within
# MESH_TRAIN_REL and every parameter within MESH_PARAM_REL * max|leaf|.
# The bundle's peak over its steps may exceed the train phase's row's by
# MESH_PEAK_GIB.
MESH_TRAIN = (("yi-6b", 4, 4, 2048, 3), ("internlm2-20b", 2, 2, 2048, 2))
MESH_TRAIN_REL = 1e-5
MESH_PARAM_REL = 1e-6
MESH_PEAK_GIB = 1.0
# A gather_dtype="bfloat16" step's loss against the float32 gather's on
# the same weights (bfloat16 weights in the forward).  Its gathered
# parameters alive at once (LiveGathers) may not pass the leaves outside
# every unit plus two of the largest units (launch/dryrun.unit_bytes), nor
# its memory peak the float32 row's.
MESH_GATHER16_REL = 1e-2
# The MoE forms: (arch, layers, batch, prompt) prefilled through the TP and
# EP forms against the mesh-less prefill, under the family phase's gate.
MESH_MOE = ("qwen2-moe-a2.7b", 4, 4, 2048)


class LiveGathers:
    """The bytes of gathered parameters a bundle holds at once inside the
    block: each tensor ``bundle._gather_leaf`` returns in a storage of its
    own (a copy its cast to ``gather_dtype`` or its gather made; on one
    rank a float32 gather is the shard itself) counts from its return
    until a finalizer on its storage runs; ``peak`` is the most alive at
    once (the tests' ``_LiveGathers``, ``tests/port_lm_spmd.py``)."""

    def __init__(self, bundle):
        self.b, self.live, self.peak = bundle, 0, 0

    def _drop(self, n: int) -> None:
        self.live -= n

    def __enter__(self):
        import weakref

        gather = self.b._gather_leaf

        def counted(shard, name, spec=None):
            out = gather(shard, name, spec)
            storage = out.untyped_storage()
            if storage.data_ptr() != shard.untyped_storage().data_ptr():
                self.live += storage.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(storage, self._drop, storage.nbytes())
            return out

        self.b._gather_leaf = counted
        return self

    def __exit__(self, *exc):
        del self.b._gather_leaf
        return False


class MeshSmoke:
    """The LM mesh path on the card: ``StepBundle`` serve, train and the
    MoE forms on a one-rank NCCL group, each held against the mesh-less
    path on the same weights; the gradients' compression on the card held
    bit for bit against the CPU's.  Shares the ``ModelSmoke``'s counters,
    generators and failure list."""

    def __init__(self, lm: "ModelSmoke", steps, mesh_mod, compression, card: str):
        self.lm, self.s, self.torch, self.fa, self.card = lm, lm.s, lm.torch, lm.fa, card
        self.steps, self.mesh_mod, self.comp = steps, mesh_mod, compression
        self.stats: dict = {}
        self.launches = dict.fromkeys(lm.fa.ROUTES, 0)

    def _count(self) -> dict:
        """The flash launches since the counters were last set to 0, added
        to the phase's; the counters are set to 0 again."""
        got = {k: v for k, v in self.lm.counts().items() if k in self.fa.ROUTES}
        for k, v in got.items():
            self.launches[k] += v
        self.lm.zero_counts()
        return got

    def _sync(self) -> float:
        self.torch.cuda.synchronize()
        return time.perf_counter()

    def path(self) -> None:
        """The refusals, then serve, train and the MoE forms."""
        axes = ("data", "model")
        mesh = self.mesh_mod.make_mesh((1, 1), axes)
        for what, call in (("make_mesh (2, 2)", lambda: self.mesh_mod.make_mesh((2, 2), axes)),
                           ("make_production_mesh",
                            lambda: self.mesh_mod.make_production_mesh()),
                           ("make_mesh on the CPU over the NCCL group",
                            lambda: self.mesh_mod.make_mesh((1, 1), axes, device="cpu"))):
            try:
                call()
                self.s.fail(f"mesh: {what} did not raise")
            except ValueError as e:
                _log(f"mesh refusal {what}: {e}")
        self.serve(mesh)
        for row in MESH_TRAIN:
            self.train(mesh, *row)
        self.moe(mesh)

    def _cfg(self, arch: str, **kw):
        return self.lm.f.configs.config(arch).replace(act_dtype="float32",
                                                      param_dtype="float32", **kw)

    def serve(self, mesh) -> None:
        """Full-depth serve through the bundle: prefill, then greedy decode
        steps against the fixed prefill cache, each step's logits held
        against the mesh-less serve's; then the bundle's step and the
        mesh-less decode captured as CUDA graphs and replayed, each held bit
        for bit against its eager steps."""
        from repro_torch.launch.graphs import StepGraph

        torch, fa = self.torch, self.fa
        arch, b, s, gen = MESH_SERVE
        cfg = self._cfg(arch)
        self.lm.live("mesh serve")
        torch.cuda.reset_peak_memory_stats()
        g = self.s.gen(9000)
        model = self.lm.model_cls(cfg, device=self.s.dev).init(g)
        prompts = torch.randint(0, cfg.vocab, (b, s), generator=g, device=self.s.dev)

        def pos(i):
            return torch.full((b,), s + i, dtype=torch.long, device=self.s.dev)

        t0 = self._sync()
        want, caches = model.prefill({"tokens": prompts})
        plain_prefill_s = self._sync() - t0
        want = [want]
        for i in range(gen):
            lg, _ = model.decode(caches, {"tokens": want[-1][:, -1].argmax(-1)[:, None],
                                          "pos": pos(i)})
            want.append(lg)
        plain_decode_s = self._sync() - t0 - plain_prefill_s
        t0 = self._sync()  # the same steps again, warm
        for i in range(gen):
            model.decode(caches, {"tokens": want[i][:, -1].argmax(-1)[:, None], "pos": pos(i)})
        plain_warm_s = self._sync() - t0
        # the mesh-less decode captured and replayed (launch/graphs.StepGraph)
        t0 = self._sync()
        plain_graph = StepGraph(lambda bt: model.decode(caches, bt)[0],
                                {"tokens": want[0][:, -1].argmax(-1)[:, None], "pos": pos(0)})
        plain_capture_s = self._sync() - t0
        plain_graph_equal = True
        for i in range(gen):
            lg = plain_graph({"tokens": want[i][:, -1].argmax(-1)[:, None], "pos": pos(i)})
            plain_graph_equal = plain_graph_equal and torch.equal(lg, want[i + 1])
        t0 = self._sync()  # again, timed
        for i in range(gen):
            plain_graph({"tokens": want[i][:, -1].argmax(-1)[:, None], "pos": pos(i)})
        plain_graph_s = self._sync() - t0
        del caches, plain_graph
        self.lm._free()
        bundle = self.steps.build(cfg, mesh, self.steps.ShapeCfg("serve", s, b, "decode"))
        params = bundle.shard_params(model)
        alias = all(params[n].to_local().data_ptr() == p.data_ptr()
                    for n, p in model.named_parameters())
        self.lm.zero_counts()
        t0 = self._sync()
        logits, caches = bundle.prefill_step(params, {"tokens": prompts})
        prefill_s = self._sync() - t0
        launches = self._count()
        got = [logits.to_local()]
        t0 = self._sync()
        for i in range(gen):
            lg, new = bundle.serve_step(params, caches,
                                        {"tokens": got[-1][:, -1].argmax(-1)[:, None],
                                         "pos": pos(i)})
            got.append(lg.to_local())
        decode_s = self._sync() - t0
        t0 = self._sync()  # the same steps again, warm
        for i in range(gen):
            bundle.serve_step(params, caches, {"tokens": got[i][:, -1].argmax(-1)[:, None],
                                               "pos": pos(i)})
        warm_decode_s = self._sync() - t0
        # the prefill's keys and values come back as the caller's DTensors
        passed = all(c is n for c, n in zip(caches["stack"]["l0"]["mixer"],
                                            new["stack"]["l0"]["mixer"]))
        del new
        # the bundle's compiled step: serve_step captured once, replayed
        t0 = self._sync()
        graph = bundle.serve_graph(params, caches, {"tokens": got[0][:, -1].argmax(-1)[:, None],
                                                    "pos": pos(0)})
        capture_s = self._sync() - t0
        replayed = []
        t0 = self._sync()
        for i in range(gen):
            lg, gnew = graph({"tokens": got[i][:, -1].argmax(-1)[:, None], "pos": pos(i)})
            replayed.append(lg.to_local().clone())
        graph_s = self._sync() - t0
        graph_equal = all(torch.equal(x, y) for x, y in zip(replayed, got[1:]))
        graph_err = max((x - y).abs().max().item() for x, y in zip(replayed, got[1:]))
        graph_kinds = ({type(lg).__name__}
                       | {type(c).__name__ for c in gnew["stack"]["l0"]["mixer"]})
        graph_passed = all(c is n for c, n in zip(caches["stack"]["l0"]["mixer"],
                                                  gnew["stack"]["l0"]["mixer"]))
        pool_gib = graph.pool_bytes() / 2**30
        t0 = self._sync()  # again, timed
        for i in range(gen):
            graph({"tokens": got[i][:, -1].argmax(-1)[:, None], "pos": pos(i)})
        graph_warm_s = self._sync() - t0
        del graph, lg, gnew, replayed
        resident, rule = self.cache_bytes(caches, mesh)
        decode_launches = self._count()
        t0 = self._sync()  # again, warm: the first call made the NCCL communicators
        warm, _ = bundle.prefill_step(params, {"tokens": prompts})
        warm_prefill_s = self._sync() - t0
        warm_launches = self._count()
        warm_equal = torch.equal(warm.to_local(), got[0])
        del warm, _
        peak = torch.cuda.max_memory_allocated() / 2**30
        err = max((x - y).abs().max().item() for x, y in zip(got, want))
        argmax = all(bool((x.argmax(-1) == y.argmax(-1)).all()) for x, y in zip(got, want))
        close = all(torch.allclose(x, y, **LOGIT_TOL) for x, y in zip(got, want))
        kinds = {type(c).__name__ for c in caches["stack"]["l0"]["mixer"]}
        st = dict(prefill_s=prefill_s, warm_prefill_s=warm_prefill_s,
                  decode_tok_s=gen * b / decode_s, warm_decode_tok_s=gen * b / warm_decode_s,
                  plain_prefill_s=plain_prefill_s, plain_decode_tok_s=gen * b / plain_decode_s,
                  plain_warm_decode_tok_s=gen * b / plain_warm_s,
                  graph_decode_tok_s=gen * b / (capture_s + graph_s),
                  graph_warm_decode_tok_s=gen * b / graph_warm_s, capture_s=capture_s,
                  plain_graph_decode_tok_s=gen * b / (plain_capture_s + plain_graph_s),
                  plain_graph_warm_decode_tok_s=gen * b / plain_graph_s,
                  plain_capture_s=plain_capture_s, pool_gib=pool_gib,
                  peak_gib=peak, logit_err=err, launches=launches, cache_bytes=resident)
        self.stats["mesh serve"] = st
        want_launches = dict.fromkeys(fa.ROUTES, 0)
        want_launches["flash_wgmma"] = cfg.n_layers
        graph_ok = (graph_equal and graph_passed and graph_kinds == {"DTensor"}
                    and plain_graph_equal)
        ok = (argmax and close and launches == want_launches and kinds == {"DTensor"}
              and passed and not any(decode_launches.values()) and peak <= SERVE_PEAK_GIB
              and warm_equal and warm_launches == want_launches and resident == rule
              and graph_ok)
        _log(f"mesh serve {arch}: {cfg.n_layers} layers at full width, float32, batch {b}, "
             f"prompt {s}, {gen} greedy tokens through StepBundle on a (1, 1) data/model mesh "
             f"(backend {self.torch.distributed.get_backend()}, tp_size {cfg.tp_size}); "
             f"weights aliased by the shards: {alias}; caches {sorted(kinds)}; the "
             f"prefill's cache leaves handed back by serve_step unwrapped: {passed}; "
             f"resident cache bytes {resident} beside the reference rule's {rule} (the "
             f"stacked caches' cache_specs on this mesh): equal {resident == rule}")
        _log(f"mesh serve {arch} prefill_s={prefill_s:.4f} (warm {warm_prefill_s:.4f}, equal "
             f"{warm_equal}) decode_s={decode_s:.4f} decode_tok_s={st['decode_tok_s']:.2f} "
             f"(again, warm: {st['warm_decode_tok_s']:.2f}) beside the mesh-less serve's "
             f"prefill_s={plain_prefill_s:.4f} (first forward) "
             f"decode_tok_s={st['plain_decode_tok_s']:.2f} (again, warm: "
             f"{st['plain_warm_decode_tok_s']:.2f}); peak_gib={peak:.3f} "
             f"launches={launches} decode_launches={decode_launches} card={self.card}")
        _log(f"mesh serve {arch} graph: StepBundle.serve_graph (serve_step captured once "
             f"under capture_error_mode thread_local, replayed) capture_s={capture_s:.4f} "
             f"decode_tok_s={st['graph_decode_tok_s']:.2f} (capture included; again, warm: "
             f"{st['graph_warm_decode_tok_s']:.2f}) pool_gib={pool_gib:.4f}; {gen} replayed "
             f"steps against the bundle's eager serve_step: bit_equal={graph_equal} "
             f"max_abs_err={graph_err:.3e}, outputs {sorted(graph_kinds)}, the prefill's "
             f"cache leaves passed through: {graph_passed}; beside the mesh-less decode "
             f"replayed: capture_s={plain_capture_s:.4f} decode_tok_s="
             f"{st['plain_graph_decode_tok_s']:.2f} (again, warm: "
             f"{st['plain_graph_warm_decode_tok_s']:.2f}), bit-equal to its eager steps: "
             f"{plain_graph_equal}: ok={graph_ok} card={self.card}")
        _log(f"mesh serve {arch} hold vs mesh-less serve: {gen + 1} logit steps "
             f"max_abs_err={err:.3e} argmax_equal={argmax} rtol 2e-3 atol 2e-4: {close} "
             f"flash_wgmma={launches['flash_wgmma']} (want {cfg.n_layers}): ok={ok} "
             f"card={self.card}")
        if not ok:
            self.s.fail(f"mesh serve {arch}: err {err}, argmax {argmax}, launches {launches}, "
                        f"decode {decode_launches}, caches {kinds}, passed {passed}, peak {peak}, "
                        f"cache bytes {resident} (rule {rule}), graph equal {graph_equal} "
                        f"(mesh-less {plain_graph_equal}), outputs {graph_kinds}, graph "
                        f"passed {graph_passed}")
        del model, params, caches, logits, got, want, bundle
        self.lm._free()

    @staticmethod
    def cache_bytes(caches, mesh):
        """The cache bytes this rank stores, and the bytes the reference's
        rule gives a rank: ``cache_specs`` on the stacked caches' global
        shapes, through ``local_shape``."""
        import math

        from repro_torch.distributed.sharding import (cache_specs, leaf_at, local_shape,
                                                      map_specs)

        leaves = []
        map_specs(lambda path, t: leaves.append((path, t)), caches)
        specs = cache_specs(map_specs(lambda _, t: tuple(t.shape), caches), mesh)
        resident = sum(t.to_local().nbytes for _, t in leaves)
        rule = sum(math.prod(local_shape(t.shape, leaf_at(specs, p), mesh)) * t.element_size()
                   for p, t in leaves)
        return resident, rule

    def train(self, mesh, arch: str, layers: int, b: int, seq: int, steps: int) -> None:
        """Train steps through the bundle, which updates the shards in
        place; the first step against ``launch/train.train_step`` on a copy
        of the same weights (its new parameters kept on the host); the
        bundle's peak over its steps beside the train phase's row of the
        same cut.  For yi-6b then the step's gradients compressed on the
        card and on the CPU, and one step with the bfloat16 gather."""
        import copy

        torch, fa = self.torch, self.fa
        tag = f"mesh train {arch}"
        cfg = self._cfg(arch, n_layers=layers, remat="none")
        base = self.lm.live(tag)
        g = self.s.gen(9100 + 10 * [r[0] for r in MESH_TRAIN].index(arch))
        model = self.lm.model_cls(cfg, device=self.s.dev).init(g)
        batch = {"tokens": torch.randint(0, cfg.vocab, (b, seq + 1), generator=g,
                                         device=self.s.dev)}
        opt = self.lm.optimizer
        ref = copy.deepcopy(model).requires_grad_(True)
        trainer = self.lm.train.Trainer(
            ref, opt.make_optimizer(cfg.optimizer, opt.warmup_cosine(3e-4, 2000, 100_000)),
            None, None)
        trainer.opt_state = trainer.opt.init(dict(ref.named_parameters()))
        loss_ref = float(self.lm.train.train_step(trainer, 0, batch))
        want = {n: p.detach().cpu() for n, p in ref.named_parameters()}
        del trainer, ref
        self.lm._free()
        torch.cuda.reset_peak_memory_stats()
        bundle = self.steps.build(cfg, mesh, self.steps.ShapeCfg("train", seq, b, "train"))
        params, state = bundle.shard_params(model), bundle.init_opt_state()
        self.lm.zero_counts()
        losses, times = [], []
        with LiveGathers(bundle) as live:
            for step in range(steps):
                t0 = self._sync()
                params, state, _, metrics = bundle.train_step(params, state, step, batch)
                losses.append(float(metrics["loss"]))
                times.append(self._sync() - t0)
                if step == 0:
                    worst = max(((params[n].to_local().cpu() - p).abs().max()
                                 / p.abs().max().clamp(min=1e-30)).item()
                                for n, p in want.items())
                    del want
        # each peak above the memory allocated before its row
        peak_abs = torch.cuda.max_memory_allocated() / 2**30
        peak = peak_abs - base
        row = self.lm.stats[f"train {arch}"]
        plain = row["peak_gib"] - row["base_gib"]
        launches = self._count()
        rel = abs(losses[0] - loss_ref) / abs(loss_ref)
        want_launches = dict.fromkeys(fa.ROUTES, 0)
        want_launches["flash_wgmma"] = layers * steps
        ok = (rel <= MESH_TRAIN_REL and worst <= MESH_PARAM_REL and launches == want_launches
              and all(math.isfinite(x) for x in losses) and peak <= plain + MESH_PEAK_GIB)
        self.stats[tag] = dict(losses=losses, step_s=times, peak_gib=peak, plain_peak_gib=plain,
                               peak_abs_gib=peak_abs, gather_peak=live.peak)
        _log(f"{tag}: {layers} layers at full width, float32, {cfg.optimizer}, "
             f"batch {b} x seq {seq}, {steps} steps through StepBundle on a (1, 1) mesh, "
             "each unit's parameters gathered just before it runs, the shards updated in place")
        _log(f"{tag} losses={[round(x, 6) for x in losses]} "
             f"step_s={[round(x, 4) for x in times]} launches={launches} peak_gib={peak:.3f} "
             f"above the {base:.3f} allocated before, beside the train phase's row {plain:.3f} "
             f"above its {row['base_gib']:.3f} (gate +{MESH_PEAK_GIB}); gathered parameters "
             f"alive at once {live.peak} bytes (a float32 gather on one rank is the shard "
             f"itself) card={self.card}")
        _log(f"{tag} first step vs launch/train.train_step: loss {losses[0]:.7f} vs "
             f"{loss_ref:.7f} (rel {rel:.3e}, gate {MESH_TRAIN_REL}), parameters max "
             f"|diff|/max|leaf| {worst:.3e} (gate {MESH_PARAM_REL}): ok={ok} card={self.card}")
        if not ok:
            self.s.fail(f"{tag}: loss rel {rel}, parameters {worst}, launches {launches}, "
                        f"peak {peak} GiB beside {plain}")
        if arch == MESH_TRAIN[0][0]:
            self.gather16(mesh, cfg, bundle, params, state, batch, steps)
        del model, params, state, bundle, batch
        self.lm._free()

    def gather16(self, mesh, cfg, bundle, params, state, batch, step: int) -> None:
        """The step's gradients compressed on the card and on the CPU; then
        one step with the parameters gathered in bfloat16, its loss against
        the float32 gather's on the same weights, its gathered parameters
        alive at once within the leaves outside every unit and two units,
        its memory peak within the float32 row's."""
        from repro_torch.launch.dryrun import unit_bytes

        torch = self.torch
        loss32, grads = bundle.loss_and_grads(params, batch)
        self._count()
        self.compression(grads)
        del grads
        self.lm._free()
        torch.cuda.reset_peak_memory_stats()
        b16 = self.steps.build(cfg.replace(gather_dtype="bfloat16"), mesh, bundle.shape)
        t0 = self._sync()
        with LiveGathers(b16) as live:
            params, state, _, metrics = b16.train_step(params, state, step, batch)
        step16 = self._sync() - t0
        self._count()
        loss16 = float(metrics["loss"])
        rel16 = abs(loss16 - float(loss32)) / abs(float(loss32))
        peak = torch.cuda.max_memory_allocated() / 2**30
        tag = f"mesh train {cfg.name}"
        outer, unit = unit_bytes(b16)
        bound = outer + 2 * unit
        peak32 = self.stats[tag]["peak_abs_gib"]
        ok16 = rel16 <= MESH_GATHER16_REL and live.peak <= bound and peak <= peak32
        self.stats[tag].update(step16_s=step16, peak16_gib=peak, gather16_peak=live.peak)
        _log(f"{tag} gather_dtype=bfloat16 step_s={step16:.4f} loss {loss16:.6f} vs float32 "
             f"gather {float(loss32):.6f} on the same weights (rel {rel16:.3e}, gate "
             f"{MESH_GATHER16_REL}); gathered parameters alive at once {live.peak} bytes "
             f"beside the leaves outside every unit {outer} plus two of the largest units "
             f"{2 * unit}: {bound} (gate); peak_gib={peak:.3f} beside the float32 row's "
             f"{peak32:.3f} (gate): ok={ok16} card={self.card}")
        if not ok16:
            self.s.fail(f"{tag}: bfloat16 gather loss rel {rel16}, gathered peak {live.peak} "
                        f"(bound {bound}), peak {peak} GiB (float32 row {peak32})")

    def compression(self, grads: dict) -> None:
        """``compress_bf16`` and ``compress_int8`` of ``grads`` on the card,
        the compressed gradients and the new error state bit-equal to the
        same on the CPU (one step from a zero error state; the feedback's
        addition is held over 8 steps against the JAX package on the CPU,
        ``tests/test_torch_sharding.py``)."""
        torch, comp = self.torch, self.comp
        host = {n: g.cpu() for n, g in grads.items()}
        for kind, fn in (("bf16", comp.compress_bf16), ("int8", comp.compress_int8)):
            t0 = self._sync()
            out_d, err_d = fn(grads, comp.init_error_state(grads))
            card_s = self._sync() - t0
            out_h, err_h = fn(host, comp.init_error_state(host))
            equal = True
            for n in grads:
                a, b = out_d[n], out_h[n]
                pairs = [(a[0], b[0]), (a[1], b[1])] if kind == "int8" else [(a, b)]
                pairs.append((err_d[n], err_h[n]))
                equal &= all(torch.equal(x.cpu(), y) for x, y in pairs)
            del out_d, out_h, err_d, err_h
            secs = self._sync() - t0
            n_el = sum(g.numel() for g in grads.values())
            _log(f"mesh compression {kind}: {len(grads)} gradient leaves, {n_el} elements, "
                 f"card bit-equal to CPU: {equal} (card {card_s:.3f} s, with the CPU's and the "
                 f"comparison {secs:.1f} s) card={self.card}")
            if not equal:
                self.s.fail(f"mesh compression {kind}: the card differs from the CPU")
        del host

    def moe(self, mesh) -> None:
        """The MoE forms' prefill against the mesh-less prefill: the
        family phase's gate, router flips counted."""
        torch, fa = self.torch, self.fa
        arch, layers, b, s = MESH_MOE
        cfg = self._cfg(arch, n_layers=layers)
        self.lm.live("mesh moe")
        g = self.s.gen(9200)
        model = self.lm.model_cls(cfg, device=self.s.dev).init(g)
        prompts = torch.randint(0, cfg.vocab, (b, s), generator=g, device=self.s.dev)
        with self.lm.moe.record_routing() as ids:
            want, _ = model.prefill({"tokens": prompts})
        routes = list(ids)
        for impl in ("tp", "ep"):
            bundle = self.steps.build(cfg.replace(moe_impl=impl), mesh,
                                      self.steps.ShapeCfg("moe", s, b, "prefill"))
            params = bundle.shard_params(model)
            self.lm.zero_counts()
            t0 = self._sync()
            with self.lm.moe.record_routing() as ids:
                logits, caches = bundle.prefill_step(params, {"tokens": prompts})
            secs = self._sync() - t0
            launches = self._count()
            got = logits.to_local()
            flips = self.lm.flips(routes, list(ids))
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            argmax = bool((got.argmax(-1) == want.argmax(-1)).all())
            close = torch.allclose(got, want, **LOGIT_TOL)
            ok = argmax and (err <= LOGIT16_TOL * scale if flips else close)
            ok &= launches["flash_wgmma"] == layers and len(ids) == layers
            self.stats[f"mesh moe {impl}"] = dict(prefill_s=secs, logit_err=err, flips=flips)
            _log(f"mesh moe {arch} form={impl}: {layers} layers at full width (experts "
                 f"{cfg.moe.n_experts} top-{cfg.moe.top_k} expert_ff {cfg.moe.expert_ff}), "
                 f"float32, batch {b}, prompt {s}, prefill_s={secs:.4f} launches={launches} "
                 f"vs mesh-less prefill: max_abs_err={err:.3e} max|logit|={scale:.3f} "
                 f"router_flips={flips} of {sum(x.numel() for x in routes)} argmax_equal={argmax} "
                 f"rtol 2e-3 atol 2e-4: {close}: ok={ok} card={self.card}")
            if not ok:
                self.s.fail(f"mesh moe {arch} {impl}: err {err}, flips {flips}, "
                            f"launches {launches}")
            del bundle, params, logits, caches, got
        del model, want
        self.lm._free()


# The trace phase: yi-6b in full, float32, batch 4, a 2048-token prompt
# (the serve row's), traced by torch.profiler and read by
# roofline/trace_cost.py.  Each hand-written kernel's symbol, by its
# launch counter's name.
TRACE_SERVE = ("yi-6b", 4, 2048)
TRACE_SYMBOLS = {"flash_wgmma": "flash_wgmma_kernel", "flash16_wgmma": "flash16_wgmma_kernel",
                 "flash16": "flash16_stacked_kernel", "flash": "flash_fwd_kernel",
                 "map": "simplex_map_kernel", "accum": "simplex_accum_kernel",
                 "edm": "simplex_edm_kernel", "ca": "simplex_ca_kernel"}
# CUDA events resolve about half a microsecond: the summed kernel time may
# pass the step's event time by this much.
TRACE_EVENT_SLACK_MS = 1e-3
TRACE_TOP = 12


class TraceSmoke:
    """The trace phase: ``torch.profiler`` traces (CPU and CUDA
    activities) of yi-6b's prefill and of one decode step after it, and of
    one ``StepBundle`` decode step on the one-rank mesh, each read by
    ``roofline/trace_cost.py``: kernel time by name, launches, the device's
    busy and idle share, its longest idle gaps with the host op under
    them, the step's FLOPs (``flop_count``, a second run) and the
    collective census.  Checks: the trace has device events; each
    hand-written kernel's traced launches equal its launch counter for the
    same step; the summed kernel time is at most the step's CUDA-event
    time.  Shares the ``ModelSmoke``'s counters and failure list."""

    def __init__(self, lm: "ModelSmoke", steps, card: str):
        from repro_torch.roofline import trace_cost

        self.lm, self.s, self.torch, self.card = lm, lm.s, lm.torch, card
        self.steps, self.tc = steps, trace_cost
        self.stats: dict = {}

    def traced(self, label: str, fn, eager=None) -> None:
        """Trace one call of ``fn`` (already warm), check it and log it.
        ``eager``, for ``fn`` a replayed CUDA graph: the eager step that
        does the same work, whose FLOPs are counted (a dispatch mode sees
        no op under a replay); a replay's trace without device events is
        said and timed by CUDA events alone, not failed."""
        import re

        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize()
        self.lm.zero_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            a.record()
            fn()
            b.record()
            b.synchronize()
        counts = self.lm.counts()
        step_ms = a.elapsed_time(b)
        events = prof.events()
        _, flops, moved = self.tc.flop_count(fn if eager is None else eager)
        self.lm.zero_counts()
        out = self.tc.summarize(events, flops, group_size=1, gaps=5)
        kernels, dev = out["kernels"], out["device"]
        kernel_ms = sum(r["us"] for r in kernels.values()) / 1e3
        traced = {k: sum(r["launches"] for name, r in kernels.items()
                         if re.search(rf"(?<!\w){sym}(?!\w)", name))
                  for k, sym in TRACE_SYMBOLS.items()}
        want = {k: counts[k] for k in TRACE_SYMBOLS}
        ok = ((dev is not None or eager is not None) and traced == want
              and kernel_ms <= step_ms + TRACE_EVENT_SLACK_MS)
        if dev is None and eager is not None:
            _log(f"trace {label}: the profiler recorded no kernel inside the graph launch; "
                 f"the step is timed by CUDA events alone (step_ms={step_ms:.4f})")
        self.stats[label] = dict(step_ms=step_ms, kernel_ms=kernel_ms, device=dev,
                                 events=sum(r["launches"] for r in kernels.values()),
                                 flops=out["flops_total"], bytes=moved,
                                 top={k: v for k, v in list(kernels.items())[:TRACE_TOP]},
                                 host_ops=dict(list(out["host_ops"].items())[:TRACE_TOP]),
                                 collectives=out["collectives"], launches=traced)
        busy = dev["busy_share"] if dev else float("nan")
        _log(f"trace {label}: step_ms={step_ms:.4f} (CUDA events, under the profiler) "
             f"kernel_ms={kernel_ms:.4f} device_events={sum(r['launches'] for r in kernels.values())} "
             f"kernel_names={len(kernels)} busy_share={busy:.4f} "
             f"idle_share={(1 - busy) if dev else float('nan'):.4f} "
             f"window_ms={(dev['window_us'] / 1e3) if dev else float('nan'):.4f} "
             f"flops={out['flops_total']:.4e} bytes={moved:.4e} card={self.card}")
        for name, r in list(kernels.items())[:TRACE_TOP]:
            _log(f"trace {label} kernel us={r['us']:.1f} launches={r['launches']} "
                 f"name={name[:110]}")
        for gap in (dev["gaps"] if dev else []):
            _log(f"trace {label} gap us={gap['us']:.1f} at_us={gap['at_us']:.1f} "
                 f"host_op={gap['host_op']}")
        for name, r in list(out["host_ops"].items())[:TRACE_TOP]:
            _log(f"trace {label} host_op calls={r['calls']} host_us={r['host_us']:.1f} "
                 f"name={name[:80]}")
        _log(f"trace {label} flops_by_op {json.dumps(flops)}")
        _log(f"trace {label} census {json.dumps(out['collectives'])}")
        _log(f"trace {label} hand-written launches traced={traced} counters={want} "
             f"kernel_ms <= step_ms: {kernel_ms <= step_ms + TRACE_EVENT_SLACK_MS} ok={ok}")
        if not ok:
            self.s.fail(f"trace {label}: device events {dev is not None}, traced launches "
                        f"{traced} against counters {want}, kernel_ms {kernel_ms} against "
                        f"step_ms {step_ms}")

    def path(self, mesh) -> None:
        """yi-6b's prefill and decode step, eager and replayed, then the
        bundle's decode step, eager and replayed."""
        from repro_torch.launch.graphs import StepGraph

        torch = self.torch
        arch, b, s = TRACE_SERVE
        cfg = self.lm.f.configs.config(arch).replace(act_dtype="float32",
                                                     param_dtype="float32")
        self.lm.live("trace")
        g = self.s.gen(9100)
        model = self.lm.model_cls(cfg, device=self.s.dev).init(g)
        prompts = torch.randint(0, cfg.vocab, (b, s), generator=g, device=self.s.dev)
        logits, caches = model.prefill({"tokens": prompts})
        step = {"tokens": logits[:, -1].argmax(-1)[:, None],
                "pos": torch.full((b,), s, dtype=torch.long, device=self.s.dev)}
        model.decode(caches, step)
        self.traced(f"{arch} prefill", lambda: model.prefill({"tokens": prompts}))
        self.traced(f"{arch} decode", lambda: model.decode(caches, step))
        graph = StepGraph(lambda bt: model.decode(caches, bt)[0], step)
        graph(step)
        self.traced(f"{arch} decode replayed", lambda: graph(step),
                    eager=lambda: model.decode(caches, step))
        self.beside(f"{arch} decode")
        del caches, graph
        self.lm._free()
        bundle = self.steps.build(cfg, mesh, self.steps.ShapeCfg("serve", s, b, "decode"))
        params = bundle.shard_params(model)
        _, bcaches = bundle.prefill_step(params, {"tokens": prompts})
        bundle.serve_step(params, bcaches, step)
        self.traced(f"{arch} bundle decode", lambda: bundle.serve_step(params, bcaches, step))
        graph = bundle.serve_graph(params, bcaches, step)
        graph(step)
        self.traced(f"{arch} bundle decode replayed", lambda: graph(step),
                    eager=lambda: bundle.serve_step(params, bcaches, step))
        self.beside(f"{arch} bundle decode")
        del model, params, bcaches, bundle, logits, graph
        self.lm._free()

    def beside(self, label: str) -> None:
        """The replayed step's trace figures beside the eager step's."""
        e, r = self.stats[label], self.stats[f"{label} replayed"]

        def busy(st):
            return f"{st['device']['busy_share']:.4f}" if st["device"] else "not measured"

        _log(f"trace {label} replayed vs eager: device_events {r['events']} vs {e['events']} "
             f"kernel_ms {r['kernel_ms']:.4f} vs {e['kernel_ms']:.4f} step_ms "
             f"{r['step_ms']:.4f} vs {e['step_ms']:.4f} busy_share {busy(r)} vs {busy(e)} "
             f"(flops, from the eager step, {r['flops']:.4e}) card={self.card}")


def examples_phase(smoke: Smoke, counts, zero_counts) -> dict:
    """The port's quickstart and serve_lm on the card, their output kept
    in the log; a failed check fails the script.  Returns the launches."""
    import contextlib
    import io

    from repro_torch.examples import quickstart, serve_lm

    zero_counts()
    for name, run in (("quickstart", lambda: quickstart.main(["--device", "cuda"])),
                      ("serve_lm", lambda: serve_lm.main(["--device", "cuda"]))):
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                run()
        except quickstart.ExampleCheckFailed as e:
            smoke.fail(f"examples {name}: check failed: {e}")
        checks = [line.strip() for line in buf.getvalue().splitlines()
                  if line.strip().endswith((": ok", ": FAILED"))]
        for line in checks:
            _log(f"examples {name}: {line}")
        _log(f"examples {name}: {len(checks)} checks in {time.perf_counter() - t0:.1f} s")
    got = counts()
    for name in ("accum", "edm", "flash_wgmma"):
        if got[name] <= 0:
            smoke.fail(f"examples: kernel {name} was never launched by the quickstart")
    return got


def main(argv=None) -> int:
    """Run every phase; 0 only when every check passed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    # The tuner's decisions go to a private cache that ends with the run.
    cache_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(cache_dir.name, "autotune.json")
    from repro_torch.configs import ALL as configs
    from repro_torch.core import hmap
    from repro_torch.distributed import compression
    from repro_torch.distributed import simplex_sharding as sharding
    from repro_torch.kernels import _build, engine, legacy, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hmap_mxu
    from repro_torch.launch import mesh as lm_mesh
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim import optimizer

    t_all = time.perf_counter()
    card = _card_line()
    _log(f"card: {card}")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    _log(f"phase build: {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if line.startswith("== "):
            _log(f"build {line[3:]}")
    records = ptxas_records(_build.build_log())
    for line in ptxas_summary(records, _build.CUDA_HOME / "bin" / "cu++filt"):
        _log(line)
    frames = map_frames(records, _build.CSRC)
    _log(f"map_frame {json.dumps(frames)}")

    def zero_counts():
        for name in engine.registered_bodies():
            engine.get_body(name).launches = 0
        fa.FLASH.launches = dict.fromkeys(fa.ROUTES, 0)
        for k in (legacy.MAP2D, legacy.ACCUM2D, legacy.EDM2D, legacy.CA2D,
                  legacy.ACCUM3D, legacy.CA3D, legacy.ACCUM_MD, hmap_mxu.HMAP_MXU):
            k.launches = 0

    def counts():
        return dict(engine.launch_counts(), **fa.launch_counts(), **legacy.launch_counts(),
                    **hmap_mxu.launch_counts())

    smoke = Smoke(torch, engine, ops, ref, args.seed)
    for kernel in FRAMELESS:
        for m in FRAMELESS_M:
            stack = [f[f"{kernel}<{m}>"] for f in frames.values() if f"{kernel}<{m}>" in f]
            if stack != [0]:
                smoke.fail(f"ptxas: {kernel}<{m}> keeps a stack frame {stack} (want [0])")
    for kernel in LEGACY_MD_FRAMELESS + LEGACY2D_FRAMELESS:
        recs = [r for r in records if kernel_name(r["name"]) == kernel]
        frame = [(r.get("stack"), r.get("spill_stores"), r.get("spill_loads")) for r in recs]
        where = "legacy_md" if kernel in LEGACY_MD_FRAMELESS else "legacy2d"
        _log(f"{where} frame {kernel}: (stack, spill stores, spill loads) {frame}")
        if frame != [(0, 0, 0)]:
            smoke.fail(f"ptxas: {kernel} keeps a stack frame or spills {frame} "
                       "(want [(0, 0, 0)])")
    mxu_frame = [(r.get("stack"), r.get("spill_stores"), r.get("spill_loads"))
                 for r in records if kernel_name(r["name"]) == "hmap2_coords_mxu_kernel"]
    _log(f"mxu frame hmap2_coords_mxu_kernel: (stack, spill stores, spill loads) {mxu_frame}")
    if mxu_frame != [(0, 0, 0)]:
        smoke.fail(f"ptxas: hmap2_coords_mxu_kernel keeps a stack frame or spills {mxu_frame} "
                   "(want [(0, 0, 0)])")
    old = LegacySmoke(smoke, legacy)
    old_md = LegacyMdSmoke(smoke, legacy)
    mxu = MxuSmoke(smoke, hmap_mxu, hmap)
    dtypes = DtypeSmoke(smoke, legacy, fa)
    flash = FlashSmoke(smoke, fa, serve, configs, Model, card)
    lm = ModelSmoke(flash, train, optimizer, moe, Model, counts, zero_counts, card)
    zero_counts()
    t0 = time.perf_counter()
    smoke.main_path()
    launches = counts()
    _log(f"phase main path: {time.perf_counter() - t0:.1f} s, launches {launches}")
    for name in SIMPLEX:
        if launches[name] <= 0:
            smoke.fail(f"kernel {name} was never launched on the main path")
    torch.cuda.empty_cache()

    zero_counts()
    t0 = time.perf_counter()
    old.path()
    legacy_launches = counts()
    _log(f"phase legacy 2-D path: {time.perf_counter() - t0:.1f} s, "
         f"launches {legacy_launches}")
    for name in LEGACY:
        launches[name] = legacy_launches[name]
        if launches[name] <= 0:
            smoke.fail(f"kernel {name} was never launched on the legacy 2-D path")
    t1 = time.perf_counter()
    old.timings()
    _log(f"phase legacy 2-D timing: {time.perf_counter() - t1:.1f} s; "
         f"legacy 2-D in all {time.perf_counter() - t0:.1f} s")

    zero_counts()
    t0 = time.perf_counter()
    old_md.path()
    md_launches = counts()
    _log(f"phase legacy m>=3 path: {time.perf_counter() - t0:.1f} s, launches {md_launches}")
    for name in LEGACY_MD:
        launches[name] = md_launches[name]
        if launches[name] <= 0:
            smoke.fail(f"kernel {name} was never launched on the legacy m>=3 path")
    t1 = time.perf_counter()
    old_md.timings()
    _log(f"phase legacy m>=3 timing: {time.perf_counter() - t1:.1f} s; "
         f"legacy m>=3 in all {time.perf_counter() - t0:.1f} s")

    zero_counts()
    t0 = time.perf_counter()
    mxu.path()
    mxu_launches = counts()
    _log(f"phase tensor-core map path: {time.perf_counter() - t0:.1f} s, "
         f"launches {mxu_launches}")
    launches["hmap_mxu"] = mxu_launches["hmap_mxu"]
    if launches["hmap_mxu"] <= 0:
        smoke.fail("kernel hmap_mxu was never launched on the tensor-core map path")
    t1 = time.perf_counter()
    mxu.timings()
    _log(f"phase tensor-core map timing: {time.perf_counter() - t1:.1f} s; "
         f"tensor-core map in all {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    zero_counts()
    t0 = time.perf_counter()
    dtypes.path()
    dtype_launches = counts()
    _log(f"phase dtype path: {time.perf_counter() - t0:.1f} s, launches {dtype_launches}")
    for name in ("accum", "ca", "edm", "accum2d", "edm2d", "ca2d", "accum3d", "ca3d",
                 "accum_md"):
        if dtype_launches[name] <= 0:
            smoke.fail(f"kernel {name} was never launched on the dtype path")
    torch.cuda.empty_cache()

    zero_counts()
    t0 = time.perf_counter()
    want = flash.tile_sweep()
    sweep_launches = counts()
    _log(f"phase flash tile sweep: {time.perf_counter() - t0:.1f} s, "
         f"launches {sweep_launches}")
    launches["flash"] = sweep_launches["flash"]
    for route in fa.ROUTES:
        if sweep_launches[route] != want[route] or want[route] <= 0:
            smoke.fail(f"flash sweep: {route} launched {sweep_launches[route]} times, "
                       f"not {want[route]}")
    torch.cuda.empty_cache()

    zero_counts()
    t0 = time.perf_counter()
    run = flash.serve_path()
    serve_launches = counts()
    _log(f"phase serve path: {time.perf_counter() - t0:.1f} s, launches {serve_launches}")
    launches["flash_wgmma"] = serve_launches["flash_wgmma"]
    n_layers = run.model.cfg.n_layers
    if (serve_launches["flash_wgmma"] != n_layers
            or any(serve_launches[r] for r in fa.ROUTES if r != "flash_wgmma")):
        smoke.fail(f"serve: prefill launched the flash kernels {serve_launches}, not "
                   f"flash_wgmma once per layer ({n_layers})")
    t0 = time.perf_counter()
    flash.hold(run)
    _log(f"phase hold: {time.perf_counter() - t0:.1f} s")
    del run
    torch.cuda.empty_cache()

    zero_counts()
    t0 = time.perf_counter()
    model16, prompts16, logits16 = flash.prefill16()
    p16_launches = counts()
    _log(f"phase 16-bit prefill path: {time.perf_counter() - t0:.1f} s, "
         f"launches {p16_launches}")
    launches["flash16_wgmma"] = p16_launches["flash16_wgmma"]
    n_layers = model16.cfg.n_layers
    if (p16_launches["flash16_wgmma"] != n_layers
            or any(p16_launches[r] for r in fa.ROUTES if r != "flash16_wgmma")):
        smoke.fail(f"prefill16: launched the flash kernels {p16_launches}, not flash16_wgmma "
                   f"once per layer ({n_layers})")
    t0 = time.perf_counter()
    flash.hold16(model16, prompts16, logits16)
    _log(f"phase hold16: {time.perf_counter() - t0:.1f} s")
    del prompts16, logits16
    torch.cuda.empty_cache()

    zero_counts()
    t0 = time.perf_counter()
    prompts16, logits16 = flash.prefill16(model16, SMALL_TILE_S)[1:]
    small_launches = counts()
    _log(f"phase 16-bit prefill path at {SMALL_TILE_S} tokens: "
         f"{time.perf_counter() - t0:.1f} s, launches {small_launches}")
    launches["flash16"] = small_launches["flash16"]
    if (small_launches["flash16"] != n_layers
            or any(small_launches[r] for r in fa.ROUTES if r != "flash16")):
        smoke.fail(f"prefill16 at {SMALL_TILE_S}: launched the flash kernels {small_launches}, "
                   f"not flash16 once per layer ({n_layers})")
    t0 = time.perf_counter()
    flash.hold16(model16, prompts16, logits16, route="flash16", controls=False)
    _log(f"phase hold16 at {SMALL_TILE_S} tokens: {time.perf_counter() - t0:.1f} s")
    del model16, prompts16, logits16
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    for arch, layers, flash_want, knob in DENSE_SERVES:
        t1 = time.perf_counter()
        lm.serve(arch, layers, flash_want, knob, "dense")
        _log(f"phase dense serve {arch}: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    lm.group6()
    _log(f"phase dense group6: {time.perf_counter() - t1:.1f} s; dense in all "
         f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for arch, layers, flash_want, knob in FAMILY_SERVES:
        t1 = time.perf_counter()
        lm.serve(arch, layers, flash_want, knob, "family")
        _log(f"phase family serve {arch}: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    for arch, *_ in FAMILY_SERVES:
        lm.card_vs_cpu(arch)
    _log(f"phase family card vs cpu: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    lm.mlstm_hold()
    lm.slstm_loop()
    _log(f"phase family xlstm holds: {time.perf_counter() - t1:.1f} s; families in all "
         f"{time.perf_counter() - t0:.1f} s")
    # row 5's launches: yi-6b's serve, the families' prefills and the
    # training runs below
    launches["flash_wgmma"] += sum(lm.stats[f"family {arch}"]["flash_launches"]
                                   for arch, *_ in FAMILY_SERVES)

    t0 = time.perf_counter()
    for row in TRAIN_RUNS:
        t1 = time.perf_counter()
        lm.train_run(row)
        tag = f"train {row.arch}" + (f" remat {row.remat}" if row.remat != "none" else "")
        _log(f"phase {tag}: {time.perf_counter() - t1:.1f} s")
        launches["flash_wgmma"] += lm.stats[tag]["launches"]["flash_wgmma"]
    _log(f"phase train: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    flash.kernel_cases()
    _log(f"phase flash checks: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    smoke.timings()
    flash.timings()
    _log(f"phase timing: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    smoke.oracle_check()
    _log(f"phase oracle: {time.perf_counter() - t0:.1f} s")

    tune = TunerSmoke(smoke, card)
    zero_counts()
    t0 = time.perf_counter()
    tune.constants()
    tune.kinds()
    tuner_launches = counts()
    _log(f"phase tuner: {time.perf_counter() - t0:.1f} s, launches {tuner_launches}")
    for name in ("accum", "edm", "ca"):
        if tuner_launches[name] <= 0:
            smoke.fail(f"kernel {name} was never launched on the tuner path")
    zero_counts()
    t0 = time.perf_counter()
    tune.attention()
    attn_launches = counts()
    _log(f"phase attn_tuner: {time.perf_counter() - t0:.1f} s, launches {attn_launches}")
    for route in ("flash_wgmma", "flash16_wgmma", "flash16"):
        if attn_launches[route] <= 0:
            smoke.fail(f"kernel {route} was never launched on the attn_tuner path")
    zero_counts()
    t0 = time.perf_counter()
    tune.xla()
    xla_launches = counts()
    _log(f"phase xla: {time.perf_counter() - t0:.1f} s, launches {xla_launches}")
    for name in ("accum", "map"):
        if xla_launches[name] <= 0:
            smoke.fail(f"kernel {name} was never launched on the xla path")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    example_launches = examples_phase(smoke, counts, zero_counts)
    _log(f"phase examples: {time.perf_counter() - t0:.1f} s, launches {example_launches}")
    torch.cuda.empty_cache()

    # One NCCL group of one rank serves the shard and mesh phases.
    import torch.distributed as dist

    store = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store.name, "store"), 1),
                            rank=0, world_size=1)
    try:
        shard = ShardSmoke(smoke, sharding, card)
        zero_counts()
        t0 = time.perf_counter()
        shard.path()
        shard_launches = counts()
        _log(f"phase shard path: {time.perf_counter() - t0:.1f} s, launches {shard_launches}")
        for name in SIMPLEX:
            launches[name] += shard_launches[name]
            if shard_launches[name] <= 0:
                smoke.fail(f"kernel {name} was never launched on the shard path")
        smoke.err["edm"] = max(smoke.err["edm"], shard.err_edm)
        t1 = time.perf_counter()
        shard.timings()
        _log(f"phase shard timing: {time.perf_counter() - t1:.1f} s; shard in all "
             f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

        mesh = MeshSmoke(lm, steps, lm_mesh, compression, card)
        t0 = time.perf_counter()
        mesh.path()
        _log(f"phase mesh: {time.perf_counter() - t0:.1f} s, launches {mesh.launches}")
        if mesh.launches["flash_wgmma"] <= 0:
            smoke.fail("kernel flash_wgmma was never launched on the mesh path")
        launches["flash_wgmma"] += mesh.launches["flash_wgmma"]

        trace = TraceSmoke(lm, steps, card)
        t0 = time.perf_counter()
        trace.path(lm_mesh.make_mesh((1, 1), ("data", "model")))
        _log(f"phase trace: {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
        store.cleanup()

    kernels = []
    for name in SIMPLEX:
        head = next(r for r in smoke.rows if r["test"] == name and r["m"] == 2
                    and r["kind"] == "hmap")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": smoke.err[name], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": f"m=2 n={head['n']} rho={head['rho']} kind=hmap",
            **({"bound_f32_ms": head["bound_f32_ms"]} if name == "edm" else {}),
        })
    b, hq, hkv, s, d = SERVE_SHAPE
    for route in fa.ROUTES:
        head = next(r for r in flash.rows if r["route"] == route and r["kind"] == "folded")
        kernels.append({
            "name": route, "route": "cuda", "source": SOURCES[route],
            "replaces": REPLACES[route], "launches": launches[route],
            "max_abs_err": flash.err[route], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "bound_f32_ms": head["bound_f32_ms"],
            "shape": (f"{head['dtype']} B={b} Hq={hq} Hkv={head['hkv']} S={head['s']} D={d} "
                      f"block_q={head['block_q']} kind=folded"
                      + (f" warpgroups={head['warpgroups']}" if head["warpgroups"] else "")),
        })
    for name in LEGACY:
        head = next(r for r in old.rows if r["name"] == name and r["kind"] == "hmap")
        kernels.append({
            "name": name, "route": "cuda", "source": LEGACY_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": old.err[name], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": (f"m=2 nb={LEGACY_MAP_NB} kind=hmap" if name == "map2d" else
                      f"m=2 n={LEGACY_N} rho={LEGACY_RHO} kind=hmap"),
            **({"bound_f32_ms": head["bound_f32_ms"]} if name == "edm2d" else {}),
        })
    r = mxu.row
    kernels.append({
        "name": "hmap_mxu", "route": "cuda", "source": SOURCES["hmap_mxu"],
        "replaces": REPLACES["hmap_mxu"], "launches": launches["hmap_mxu"],
        "max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        "shape": f"hmap2 grid nb={MXU_NB} T={r['steps']} rho={MXU_RHO}",
    })
    for name in LEGACY_MD:
        head = next(r for r in old_md.rows if r["name"] == name and r["m"] == 3
                    and r["kind"] == "hmap")
        kernels.append({
            "name": name, "route": "cuda", "source": LEGACY_MD_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "engine_ms": head["engine_ms"],
            "shape": f"m=3 n={head['n']} rho={head['rho']} kind=hmap",
        })
    st = flash.stats
    _log(f"serve summary: prefill_s={st['prefill_s']:.4f} "
         f"decode_tok_s={st['decode_tok_s']:.2f} (replayed, capture included; eager "
         f"{st['eager_decode_tok_s']:.2f}, replayed again {st['replay_decode_tok_s']:.2f}) "
         f"capture_s={st['capture_s']:.4f} replay_step_ms={st['replay_step_ms']:.3f} "
         f"eager_step_ms={st['eager_step_ms']:.3f} pool_gib={st['pool_gib']:.4f} "
         f"graph_bit_equal={st['graph_equal']} peak_gib={st['peak_gib']:.3f} "
         f"logit_err={st['logit_err']:.3e} prefill16_s={st['prefill16_s']:.4f} "
         f"peak16_gib={st['peak16_gib']:.3f} logit16_rel={st['logit16_rel']:.3e} "
         f"prefill16_{SMALL_TILE_S}_s={st[f'prefill16_{SMALL_TILE_S}_s']:.4f} "
         f"logit16_{SMALL_TILE_S}_rel={st[f'logit16_{SMALL_TILE_S}_rel']:.3e} "
         f"card={card}")
    for key, d in lm.stats.items():
        if key in ("mlstm hold", "slstm loop"):
            continue
        _log(f"{key} summary: prefill_s={d['prefill_s']:.4f} "
             f"decode_tok_s={d['decode_tok_s']:.2f} (replayed, capture included; eager "
             f"{d['eager_decode_tok_s']:.2f}, replayed again {d['replay_decode_tok_s']:.2f}) "
             f"capture_s={d['capture_s']:.4f} replay_step_ms={d['replay_step_ms']:.3f} "
             f"eager_step_ms={d['eager_step_ms']:.3f} "
             f"pool_gib={d['pool_gib']:.4f} graph_bit_equal={d['graph_equal']} "
             f"peak_gib={d['peak_gib']:.3f} "
             f"hold_prefill_s={d['hold_prefill_s']:.4f} logit_err={d['logit_err']:.3e} "
             f"router_flips={d['flips']} of {d['choices']} card={card}"
             if "prefill_s" in d else
             f"{key} summary: step_s={d['step_s']:.4f} tok_s={d['tok_s']:.1f} "
             f"peak_gib={d['peak_gib']:.3f} reckoned_gib={d['reckoned_gib']:.3f} "
             f"loss {d['losses'][0]:.5f} -> "
             f"{d['losses'][-1]:.5f} aux {d['aux'][0]:.7f} -> {d['aux'][-1]:.7f} card={card}")
    d = mesh.stats
    _log(f"mesh summary: serve prefill_s={d['mesh serve']['prefill_s']:.4f} "
         f"warm_prefill_s={d['mesh serve']['warm_prefill_s']:.4f} "
         f"decode_tok_s={d['mesh serve']['decode_tok_s']:.2f} (mesh-less "
         f"{d['mesh serve']['plain_decode_tok_s']:.2f}) replayed "
         f"{d['mesh serve']['graph_decode_tok_s']:.2f}, warm "
         f"{d['mesh serve']['graph_warm_decode_tok_s']:.2f} (mesh-less replayed "
         f"{d['mesh serve']['plain_graph_decode_tok_s']:.2f}, warm "
         f"{d['mesh serve']['plain_graph_warm_decode_tok_s']:.2f}) "
         f"peak_gib={d['mesh serve']['peak_gib']:.3f} "
         + "".join(f"train {a} step_s={[round(x, 4) for x in d[f'mesh train {a}']['step_s']]} "
                   f"peak_gib={d[f'mesh train {a}']['peak_gib']:.3f} (mesh-less "
                   f"{d[f'mesh train {a}']['plain_peak_gib']:.3f}) "
                   f"gather_peak={d[f'mesh train {a}']['gather_peak']} " for a, *_ in MESH_TRAIN)
         + f"bf16_gather_step_s={d[f'mesh train {MESH_TRAIN[0][0]}']['step16_s']:.4f} "
         f"peak_gib={d[f'mesh train {MESH_TRAIN[0][0]}']['peak16_gib']:.3f} "
         f"gather_peak={d[f'mesh train {MESH_TRAIN[0][0]}']['gather16_peak']} "
         f"moe tp prefill_s={d['mesh moe tp']['prefill_s']:.4f} "
         f"ep prefill_s={d['mesh moe ep']['prefill_s']:.4f} card={card}")
    _log(f"phase total: {time.perf_counter() - t_all:.1f} s")
    if smoke.failures:
        print(f"{len(smoke.failures)} failures: {smoke.failures}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
