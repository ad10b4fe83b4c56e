#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``): builds its
CUDA kernels, holds each to its plain torch version, serves
eris-gptneo-1.3b at full width, runs ERIS rounds of it and of qwen2-0.5b
at full width, training through the flash-attention kernels, and runs
the reference's default round (threefry DSC), the distributed FSA train
step over NCCL with its scenario and async knobs, the round matrix (the
baselines, defenses, failures and async methods), the privacy audit
of the step's captured wire, the non-IID feeds, the reference's init
draws and the MoE family (olmoe-1b-7b served, a gradient and ERIS
rounds), and the recurrent and vision families (xlstm-350m and
hymba-1.5b trained, beam-searched and in ERIS rounds, internvl2-26b at
reduced depth), the model axis (tensor, context and expert
parallelism: ranks sharing the card over gloo), and the pipe axis (the
1F1B wavefront over gloo ranks, its composite checkpoint served through
``ServeEngine.from_checkpoint``), serving over a (data, model) mesh
of gloo ranks, and the account of the step and of the serving programs
against their dry runs on the meta device, on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--only 8 16 17 18 19 20]

``--only`` runs the device, the build and the named phases (8, the
context gradient and its remat policies, or the multi-rank phases and
the account) alone, and prints no result line.

Phases, in order; any failure exits non-zero and nothing is caught:

1. device -- needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as nvidia-smi gives them.
2. build -- compiles every kernel source under
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, started together) and prints the seconds, each kernel's
   registers and spills from ``-Xptxas -v``, and the shared memory of the
   tensor-core forward, dq and dk/dv kernels (bf16, and the f32 forward
   and dk/dv) and of the paged kernel.
3. kernel vs plain version -- ``paged_attention`` (split over 64-position
   chunks) against ``paged_attention_ref`` on the card at (H, KV, hd) =
   (16, 16, 128) and (14, 2, 64) and at a model-2 rank's (8, 8, 128) and
   (7, 1, 64), f32 and bf16, with and without a window,
   a ctx-0 row and ragged contexts over several pages, then contexts up
   to 2048 over 128 pages (up to 32 chunks, merged); every row of batch 8
   must be bit-identical to the same row alone, with a table only as wide
   as its pages, and a CUDA graph of the kernel replayed must equal the
   eager call.  Then kernel and plain version are timed at phase 4's
   decode shape for eris-gptneo-1.3b and for qwen2-0.5b (14 query heads
   over 2), beside the kernel's bound and the first design's time.
4. serving -- ``ServeEngine`` on eris-gptneo-1.3b (24 layers, d_model
   2048, bf16 params made from ``--seed``, bf16 cache): 8 requests of
   32-256 prompt tokens and 32 new tokens, greedy and sampled.  Asserts
   every request ends by length, every logit is finite, and the kernel
   ran n_layers times per decode step; then replays one decode step of
   the same engine state through the kernel and through the plain
   version and compares the logits; then serves qwen2-0.5b's smoke
   variant in f32 on the card and on the host and compares the tokens,
   greedy and sampled (the threefry sampler).
   A torch.profiler breakdown of three decode steps says where the
   step's time goes.
5. wire kernels vs plain versions -- ``dsc_update``, ``quantize``,
   ``dequantize`` and ``dsc_quantize`` against ``kernels/ref.py`` at
   n = 3 * 2**20 + 77 and 2**24, g in f32 and bf16, p = 0.25 and 1, index
   bases 0 and 2**32 - 4096 (straddling the wrap), with a zero block and a
   ragged tail: codes, scales, v and s' must be bit-identical.  Then each
   kernel is timed at the ERIS round's per-client n (1,816,565,760) beside
   its byte bound, and each plain version on a 2**26 window.
6. flash kernels vs plain versions -- ``flash_fwd``, ``flash_dq`` and
   ``flash_dkv`` against ``kernels/ref.py`` at (B, H, KV, S, d) =
   (2, 4, 2, 128, 64) f32, phase 11's (8, 16, 16, 64, 128) f32 (the
   kernels its steps 2-3 run), (4, 16, 16, 64, 128), (2, 14, 2, 256, 64),
   (1, 16, 16, 2048, 128) bf16, and in bf16 and f32 a ragged (1, 4, 4,
   100, 128), (1, 14, 2, 512, 64) and contiguous (2, 4, 4, 128, 128), and
   d = 16 and 32 in f32, phase 15's hymba-1.5b (4, 25, 5, 64, 64) and (1,
   25, 5, 2048, 64) and internvl2-26b (4, 48, 8, 512, 128) and (1, 48, 8,
   512, 128) in bf16, causal, full, and causal with windows 100 and
   200 (four k-tiles), mostly on (B, S, H, d) tensors seen as (B, H, S,
   d), as the model hands them over: o, lse, dq, dk and dv; every bf16
   forward, dq and dk/dv on the tensor cores, every f32 forward, dq and
   dk/dv on the f32 tensor-core kernels (3xTF32).
   Then each kernel, its plain version and scaled_dot_product_attention
   (forward; forward + backward less the forward) are timed at the two
   rounds' shapes and at S = 2048 for both models, at phase 15's
   gradient shapes (1, 25, 5, 2048, 64) and (1, 48, 8, 512, 128), causal,
   bf16, and at phase 11's f32 shape and S = 2048 in f32, beside the
   kernel's bound and its first (SIMT) version's time.
7. the ERIS round -- ``FLRun`` on eris-gptneo-1.3b at full width (bf16
   params from ``--seed``, flash_attention on, K = 4, A = 8, lr 0.1,
   4 x 64 tokens a client from ``lm_token_batches``), two rounds in each
   of three
   configurations: DSC on the int8 wire through the fused kernel, DSC
   through ``dsc_update``, and the int8 wire alone; the first again with
   flash off (the plain chunked attention, right after itself, to compare
   within one call); then two rounds of qwen2-0.5b at full width in the
   first configuration.  Asserts finite
   client losses, x and s_agg after every round, K launches a round of
   each wire kernel of the configuration and n_layers x K of each flash
   kernel, and replays client 3's round-2 compression (index base
   3 * n_pad, past 2**32) on a 2**24 window through the kernel and the
   plain version.  Prints each round's time split (client gradients,
   compression, aggregation + server, from CUDA events) and the peak
   device memory, and a torch.profiler breakdown of one more round of
   the first configuration.
8. the GPT-Neo context -- one client gradient of eris-gptneo-1.3b at full
   width on 1 x 2048 tokens (2048 is the max_position_embeddings of
   EleutherAI/gpt-neo-1.3B's published config), through the flash kernels
   and through the plain chunked attention: ms, peak memory, and the two
   gradients within 5e-2 relative norm; a torch.profiler breakdown of one
   more flash gradient.  A profile of one round-shape
   client gradient each way counts its host syncs, and six of each, in
   turns, are timed.  Then the flash gradient once under each remat
   policy (``none``, ``full``, ``dots``, ``dots_batch``,
   ``offload_dots``): ms, the peak above the params, the flash launches
   (2 n_layers forwards under every policy but ``none``), each gradient
   equal to ``none``'s bit for bit, the peaks in the order none >
   dots_batch >= dots > full, what offload_dots' forward leaves on the
   card under dots' by at least what it sent to the host (an account of
   one more gradient), its peak not above dots'.
   Every gradient of the script runs its config's ``remat_policy``,
   ``full`` as the reference's: each flash forward launches twice a
   layer, dq and dk/dv once.
9. small input -- the fused configuration on eris-gptneo-1.3b's smoke
   variant in f32 with flash on, two rounds on the card (kernels) and on
   the host (plain versions) with the same seeds: a host-made gradient
   compressed on both gives the same codes, scales and s', and x agrees
   to 1e-4 relative norm; every forward, dq and dk/dv on the f32
   tensor-core kernels.
10. the key stream and the reference's default round -- ``random``'s
    bits, split, fold_in, uniform, bernoulli, randint, permutation and
    gumbel on the card against the host under both threefry layouts
    (bit for bit; gumbel within 8 ulps), with jax 0.9.0's values where
    known, and the last 2**24 elements of a chunked full-width bernoulli
    on both; then two full-width rounds of eris-gptneo-1.3b in the
    configuration of ``examples/fl_train_lm.py`` (``use_dsc``,
    ``RandP(p=0.25)``, ``compress_impl="jnp"``), and two with
    participation 0.5 on the int8 wire: splits, peaks (under 80 GB),
    client 3's round-2 compression replayed on the card and the host,
    the round-2 keys split on the card equal to the host's, and the mask
    draw's ms a client; then, at the smoke size in f32, error feedback
    with TopK, RandK, QSGD and fresh random masks on the card and the
    host.
11. the distributed FSA step (``launch/train.py``) over a one-rank
    ``cpu:gloo,cuda:nccl`` group on a loopback port (a failure to
    initialise NCCL fails the run): eris-gptneo-1.3b at full width (bf16
    params from ``--seed``), the reference CLI's settings (adam lr 1e-2, 8
    x 64 tokens from ``lm_token_batches(PRNGKey(0))``, keys
    ``PRNGKey(i)``, ``grad_dtype="float32"``), three steps in each of (a)
    FSA on the f32 wire, (b) DSC on the int8 wire through the fused
    kernel, (c) the int8 wire, (d) DSC alone (threefry RandP), (e) (a) on
    the default bf16 wire.  Then, at full width and 2 of the 24 layers
    (at all 24 the host's step took 83 s): (a) two steps, whose step 1
    the host's plain path (gloo, no kernels) takes again from the card's
    params and must land on the card's loss, grad_norm and loss after the
    update (within 5e-2), so the card path's step is the configuration's;
    and each configuration at adam lr 1e-5 ((d) two steps), where the
    loss must fall at every step (at lr 1e-2 the full-width loss rises: a
    first step of ~1e-2 a weight is half the init's std).  Asserts
    finite loss and grad_norm every step, f32 params after each adam step (the
    reference's promotion), peak memory under 80 GB, and each kernel's
    launches a step (the fused path: one ``dsc_quantize`` and one
    ``dequantize`` a leaf; the int8 wire: one
    ``quantize`` and one ``dequantize`` a leaf; n_layers of each flash
    kernel, on the bf16 tensor-core kernels while the params are bf16, and
    of the forward and dk/dv on the f32 ones once they are f32).  Prints
    each step's ms split into gather, gradient, wire (with the Eq. 4
    compensation) and optimizer, the peak, and ``mesh_wire_bytes`` at
    n_client 1, 4 and 8 (computed). Then the scenario and async knobs at
    full width, three sgd steps at lr 0.1 each (bf16 params stay bf16):
    (f) the cell ``ldp_int8+agg_fail`` (LDP eps 8 on the int8 wire,
    aggregator dropout 0.25, link failure 0.1), (g) the FedBuff buffer on
    the int8 wire (cadence 2, client dropout 0.25, delay_max 2), (h)
    ``dsc_int8+agg_fail`` (DSC p 0.5 on the fused int8 wire), (i)
    ``secure_agg+none`` (the f32 wire); each step holds or moves as the
    step's own draws say, asserted (a dead link leaves (f)'s params and
    (h)'s s_agg as they were, bit for bit; (g) holds its params at the
    rounds the cadence skips, with grad_norm 0; (i)'s mask row at n_client
    1 is zero), with the launches (one ``quantize`` and one ``dequantize``
    a leaf in (f) and (g), one ``dsc_quantize`` and one ``dequantize`` in
    (h), none in (i)) and the split (with LDP's part).  Then the n_client
    = 4 draws no single rank runs, on the card: the four ranks' mask rows
    of ``blocks/w_up`` summed to exactly zero in f32, rank 3's row on
    2**24 elements equal to the host's and its LDP noise within 8 ulps,
    each timed.  Then the smoke variant in f32, (a)-(d) and (f)-(i), two
    sgd steps on the card and on the host (gloo) from the same params and
    keys (within 1e-4), and a host-made leaf through the fused payload and
    host-made trees through two adam updates on both, bit for bit.
12. the round matrix -- eris-gptneo-1.3b at full width as phase 7 runs
    it (bf16 params from ``--seed``, flash on, K = 4, A = 8, 4 x 64
    tokens a client): (a) ``eris`` on the int8 wire with aggregator
    dropout 0.25 and link failure 0.1, (b) ``eris_async`` on the int8
    wire over a population of 16 (client dropout 0.25, delay_max 2,
    buffer cadence 2), (c) the scenario cell ``ldp_int8+agg_fail``, two
    rounds each; (d) ``secure_agg``, (e) ``priprune``, (f) ``shatter``,
    one round each; (c) and (d), whose threefry draws take ~11 s a round
    and ~13 s a client at all 24 layers, at 2 of them.  Prints each
    round's split (client gradients, compression by stage, aggregation
    and server) and peak, and the
    threefry draws' ms a client (LDP noise; a pairwise mask row, (d)'s
    aggregation over K).
    Asserts finite x every round, peaks under 80 GB, K ``quantize`` and
    K ``dequantize`` launches a round on the int8 wire (none else) and
    n_layers x K of dq and dk/dv (2x forwards); in (a) and (c) x unchanged bit for
    bit at a dead aggregator's coordinates; in (b) x unchanged in round 1
    (cadence 2) and moved in round 2; in (e) client 3's update replayed
    equal to the round's, at least k coordinates withheld, the threshold
    the k-th largest |g|; in (f) the update on a window across 2**31 / 8
    recomputed from the clients' gradients with the reference's int32
    chunk ids (they wrap there).  Then, at the smoke size in f32, every
    method and every feasible scenario cell (the ``dsc_int8`` cells once
    more through the fused kernel, whose launches are counted) two rounds
    on the card and on the host from the same seeds, x within 1e-4 (the
    host's half in three processes of their own, started with the
    phase).
13. the privacy audit of the captured wire -- eris-gptneo-1.3b at full
    width (bf16 params from ``--seed``, sgd lr 0.1) on a one-rank
    ``cpu:gloo,cuda:nccl`` group, two steps with ``capture_views`` in (j)
    the int8 wire and (k) DSC (p 1.0, gamma 0.5) on the fused int8 wire,
    8 x 64 tokens.  Each step's captured views, put through Eq. 4 (with
    DSC) and sgd's update from the pre-step params, must give the
    post-step params bit for bit, leaf by leaf.  Then ``mia_audit`` of the
    two pre-step iterates and views ((k)'s after ``deshift_views``) at
    full observation (A = 1), 4 members from the step's batch and 4 fresh
    rows of the same draw, 64 bootstrap resamples: a finite AUC inside its
    CI, n_layers launches of dq and dk/dv (2x forwards) a canary gradient, member
    0's alignment again with flash off within 5e-2; the audit's and one
    canary gradient's ms and the phase's peak (under 80 GB).  Then, at the
    smoke size, card vs host from the same seeds: ``mia_mlp`` at A = 1 and
    4 and on the int8 wire, ``mia_lm`` on ``tiny_lm_config`` (scores within
    1e-4, AUC, balanced accuracy and intervals equal), ``dlg_mlp`` on the
    int8 wire and ``dlg_lm`` at A = 1 and 4 (match losses within 1e-3 over
    20 steps); and a ``create_graph=True`` backward through the flash
    kernels must raise.
14. non-IID feeds, init and MoE -- (a) ``federated_population`` (10,000
    clients of 64 samples, alpha 0.5) and ``federated_classification``
    (100 clients of 64, alpha 0.1) on the card and on the host from one
    key: labels and the Dirichlet partition's indices (owners for the
    latter) equal, features within 4e-6, each timed.  (b) ``init_params``
    of olmoe-1b-7b at full width (16 layers, d_model 2048, 64 experts of
    d_ff 1024, top 8; bf16, the reference's threefry draws) on the card,
    timed, with its peak; w_gate's 2**31 elements around 2**30 and its
    last 4,096 recomputed on the host, equal.  (c) ``ServeEngine`` on
    those params as phase 4 runs eris-gptneo-1.3b: 8 requests, every one
    ending by length, finite logits, n_layers paged launches a decode
    step, one decode step replayed through the kernel and through the
    plain version on the kernel step's expert slots and combine weights
    (so the two differ in attention only; logits within 3e-2, as phase
    4's; the layers and rows where the plain version's own routes would
    differ counted), a profile of three steps; then olmoe's smoke variant in f32
    served card vs host, greedy and sampled, tokens equal.  (d) one
    full-width gradient on 1 x 128 tokens, flash on (n_layers launches
    of dq and dk/dv (2x forwards), on the bf16 tensor cores) and off: the losses
    within 1e-2 relative, the share of layer 0's routes (top-k experts,
    dispatch rows) that differ printed beside the gap, ms and peaks.
    (e) two ERIS rounds of olmoe cut to 4 of its 16 layers (n =
    1,884,309,504) as phase 12 runs gptneo: the int8 wire, flash on, K =
    4, A = 8; x finite, K ``quantize`` and ``dequantize`` launches a
    round, n_layers x K of dq and dk/dv (2x forwards), the split and the peak
    (under 80 GB).  Prints each part's seconds.
15. the recurrent and vision families, bf16 params from ``--seed``
    (the reference's init draws), flash on.  (a) xlstm-350m at full
    width (24 layers, d_model 1024, 4 mLSTM heads of 256; 354,927,808
    params): one gradient on 1 x 2048 tokens (ms, peak above the params,
    finite, no flash launch), ``beam_search`` with 4 beams and 16 new
    tokens on a 64-token prompt (timed) and with 1 beam, equal to greedy
    ``decode_step`` tokens from the same prefill, then two ERIS rounds on
    the int8 wire as phase 12 runs them (K = 4, A = 8, 4 x 64 tokens a
    client: x finite, K ``quantize`` and ``dequantize`` launches a round,
    the split, the peak).  (b) hymba-1.5b at full width (d_model 1600, 25
    query heads over 5 kv heads of 64, N 16; 1,474,769,600 params at its
    32 layers) cut to 8 layers: the 1 x 2048 gradient flash on (n_layers
    launches of dq and dk/dv (2x forwards), on the bf16 tensor cores) and off, the
    losses within 1e-2 relative, ms and peaks; the selective scan's share
    of the gradient (one layer's ``ssm_scan`` forward and backward,
    profiled, times n_layers, over a profiled gradient's busy time);
    ``beam_search`` as in (a) on the hybrid caches; two int8 rounds
    (n_layers x K launches of dq and dk/dv (2x forwards), peak under 80 GB).  (c)
    internvl2-26b (19,867,551,744 params: it cannot train on one card) at
    8 of its 48 layers: a gradient on one image of 256 patch embeddings
    and 256 text tokens (S = 512, 8 launches of dq and dk/dv (2x forwards) at d
    128, GQA 6), flash on vs off within 1e-2; ``beam_search`` refused for
    want of an image, as the reference fails; two int8 rounds at 2
    layers (n = 1,923,753,984), each client's batch with its own image
    embeddings.  (d) each family's smoke variant in f32 card vs host from
    the same params and batch (4 x 64 positions): the loss and every
    gradient leaf, the prefill logits and caches within 1e-4, and
    ``beam_search``'s tokens equal and score within 1e-4 (vlm: refused on
    both).  Prints each part's seconds.
16. the model axis -- ranks are ``torch.multiprocessing`` processes, all
    on cuda:0, over process groups whose backend the phase chooses,
    gloo (NCCL refuses two ranks on one device): every collective of a
    CUDA tensor goes through host buffers (``dist/collectives.py``) and
    the phase says so on a line of its own; the compute stays on the
    card.  (a) two ranks: eris-gptneo-1.3b at full width and 8 of its 24
    layers in f32, one 1 x 512 ``loss_fn`` value and gradient at tp = 2 (heads and
    FFN sharded, the vocab of 50257 replicated; flash at 8 of the 16
    heads, on the f32 tensor cores) against the same model replicated
    on the card, computed first by each rank and freed before the TP
    ranks run: the loss within 1e-5 relative, each merged leaf's max
    error within 1e-3 of its max |g| (the reference's gates,
    ``tests/test_tp.py``); olmoe-1b-7b at full width cut to 4 layers, 1
    x 128, expert parallel (the replicated run's top-k experts pinned, so
    the two differ in arithmetic only), and hymba-1.5b at 4 layers, 1 x
    256 (ring attention over its 25 heads, the channel-sharded mamba
    head), with the same gates; then three steps of the distributed
    step at (data 1, model 2) (eris-gptneo-1.3b at full width and 8
    layers), phase 11's DSC fused int8 settings, adam
    lr 1e-5, the first under an account (phase 19): losses finite and
    falling, one ``dsc_quantize`` and one
    ``dequantize`` a leaf a step, n_layers launches of dq and dk/dv (2x forwards)
    a step.  (b) four ranks: qwen2-0.5b at full width and AXIS_LAYERS of
    its 24 layers at tp = 4 (ring
    attention for its 2 kv heads, the vocab-parallel CE, the FFN
    sharded), 1 x 512, the same gates; then its smoke step at (data 2,
    model 2) on the int8 wire, two sgd steps on the card and on the host
    from the same params and keys, within 1e-4.  Each case prints its
    loss error, worst leaf, ms, launches and each rank's peak; the flash
    launches of (a)'s TP gradients and steps join the kernels line.
17. the pipe axis, as phase 16 runs the model axis (ranks are processes
    on cuda:0 over gloo groups; every boundary send is staged through
    the host).  (a) two ranks: eris-gptneo-1.3b at full width and 8 of
    its 24 layers in f32, 4 x 512 in 4 microbatches at pp = 2 (4 layers
    a stage), its pipelined gradient against the same model replicated
    on the card (loss 1e-5 relative, each merged leaf 1e-3 of its max; 4
    layers x 5 ticks of flash launches a rank: every tick runs, masked);
    then three steps at (data 1, pipe 2) with phase 11's (b) settings,
    bf16 params, adam lr 1e-5, 8 x 64 in 4 microbatches (the loss falls;
    the wire kernels once a leaf a step), and the composite checkpoint;
    this process then serves 4 requests x 16 greedy tokens through
    ``ServeEngine.from_checkpoint`` on the paged kernel and through an
    engine built from the ranks' merged pieces: the tokens must be
    equal.  (b) four ranks: qwen2-0.5b at full width and AXIS_LAYERS at
    (pipe 2, model 2), 2 x 512 in 2 microbatches (7 heads over 1 kv head a rank through
    the flash kernels), the same gates; the smoke int8 step at (data 2,
    pipe 2) on the card and the host within 1e-6.  The launches of the
    pipelined gradients, the steps and the serving join the kernels
    line.  The checkpoint stays on disk for phase 18.
18. serving over a ("data", "model") mesh, ranks as in phase 16: first
    the paged kernel timed at a rank's heads at model 2 (eris-gptneo-1.3b
    8 over 8, qwen2-0.5b 7 over 1), bf16, and held to the plain version
    within phase 3's bound.  (a) four ranks at (data 2, model 2):
    eris-gptneo-1.3b at full width and depth, f32 params (drawn from
    ``--seed`` by torch's generator on the card) and pools, 8 requests
    of 32-128 prompt and 16 new tokens, every third
    sampled; rank 0 serves them meshless first on the same params, and
    every rank's mesh tokens must equal those; the manual path (each data
    position four slots), the paged kernel 24 times a decode step on
    each rank, its first call with a live row held to the plain version
    at (8, 8, 128) (the vocab, 50,257, does not divide: replicated).
    (b) the same for qwen2-0.5b (7 heads over 1 kv head a rank at (7, 1,
    64), the vocab sharded).  (d) olmoe-1b-7b's smoke config at (2, 2),
    expert parallel, card vs host tokens.  (c) two ranks at (data 1,
    model 2): eris-gptneo-1.3b in bf16, the meshless engine's first
    decode step replayed through the TP step (logits within phase 4's
    3e-2), then the requests served: decode step ms by CUDA events and
    the collectives each step issues, every logit finite.  (e)
    ``from_checkpoint(..., mesh=)`` at (1, 2) from phase 17's checkpoint
    (8 layers; its 4 greedy requests; tokens equal to phase 17's meshless
    ``from_checkpoint``),
    or, under ``--only 18``, from a smoke checkpoint saved there.  Every
    rank's paged launches join the kernels line.
19. the account (``launch/accounting.py``): (a) on a one-rank NCCL
    group, phase 11's eris-gptneo-1.3b step (full width, 8 x 64 tokens,
    adam) in its (c) int8 and (b) DSC fused int8 configurations from
    fresh params, one step each under an ``Account`` on the card, then
    the same step on meta twins of its inputs under another: the flops,
    every kernel's launches and declared work and the argument bytes
    equal, the traffic within ``ACCOUNT_TRAFFIC_TOL``, the meta peak
    over the arguments within 20% of the card's ``max_memory_allocated``
    rise over the step; (b) rank 0's account of phase 16 (a)'s first
    step at (data 1, model 2) over gloo against that step's dry run at a
    fake world of 2 in a subprocess: the collective records equal per
    axis, kind and dtype in bytes and counts, the flops equal, the
    card's host staging reported apart.  Prints both records' flops,
    per-axis bytes, peak and the card's step ms.
20. the serving account: on a one-rank group, after the allocator's cache
    is emptied, the programs that the serving shapes' dry run accounts
    (``launch/serve.serve_program`` at the shape's global batch, params
    from ``--seed`` and caches, pools and tokens drawn from it): (a)
    qwen2-0.5b ``decode_32k`` at full width and depth (128 slots x 32,768
    positions, 51.5 GB of bf16 pools, the paged kernel), (b)
    eris-gptneo-1.3b ``long_500k`` (1 slot, window 8,192 over a
    524,288-position table, the pages before the window on the scratch
    block), (c) hymba-1.5b ``long_500k`` (the dense ``decode_step`` on its
    ring of 8,192, written in place), (d) qwen2-0.5b ``prefill_32k`` (32 x
    32,768 tokens) cut to ``n_layers=1,vocab=4096,attn_chunk=128``. Each
    decode: a warm-up step (in (a) and (b) the first layer's kernel call
    held to its plain version within phase 3's tolerance); then every case
    one step under an ``Account`` on the card (finite logits) and one on
    meta twins of its inputs: flops, each kernel's launches and declared
    work and the argument bytes equal, n_layers paged launches in (a) and
    (b), none in (c) and (d), traffic within ``ACCOUNT_TRAFFIC_TOL``, the
    meta peak over the arguments within ``ACCOUNT_PEAK_TOL`` of the card's
    ``max_memory_allocated`` rise.  Prints each step's ms (by events,
    without the account but (d)'s), and the paged kernel alone at (a)'s
    and (b)'s shapes (24 launches over the layers' pools) beside its
    bound.  The accounted steps' paged launches join the kernels line.
21. prints each phase's seconds, the ``{"kernels": [...]}`` line, then,
    last, the ``{"ok": true, "device": ...}`` line.

Builds go to ``build/kernels/`` (listed in .gitignore).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

# the ERIS round allocates and frees 3.6-7.3 GB vectors of several sizes
# (bf16 and f32, n and n padded); with fixed segments the cache strands
# gigabytes between them, so let segments grow (set before torch starts)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import random  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (tree_leaves, tree_map,  # noqa: E402
                                 tree_unflatten)
from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.core import dsc as dsc_lib  # noqa: E402
from repro_torch.core import fl  # noqa: E402
from repro_torch.core.compressors import QSGD, RandK, RandP, TopK  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.pipeline import (DSCCompress, Int8Wire,  # noqa: E402
                                       _seed_of, split_round_keys)
from repro_torch.core.rounds import scenarios as sc  # noqa: E402
from repro_torch import data as data_lib  # noqa: E402
from repro_torch.data import lm_token_batches  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dsc_quantize as dq  # noqa: E402
from repro_torch.kernels import dsc_update as du  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import ref as wire_ref  # noqa: E402
from repro_torch.launch import fl_train  # noqa: E402
from repro_torch.launch.accounting import Account  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import SamplingParams, ServeEngine, pages_for  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
# H100 SXM float32 outside the tensor cores: the scalar work of the wire
# and paged kernels
F32_OPS_PER_S = 67e12
BF16_TC_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
# f32-accurate products on the tensor cores: three TF32 products (495
# TFLOP/s dense) a product; the least time for an f32 flash kernel's
# products, whatever runs them
F32_TC_FLOPS = 495e12 / 3
# every kernel of the port: (name, wrapper, source, the TPU kernel it replaces)
KERNELS = (
    ("paged_attention", pa.paged_attention, "paged_attention.cu",
     "src/repro/kernels/paged_attention.py:52"),
    ("dsc_update", du.dsc_update, "dsc_update.cu",
     "src/repro/kernels/dsc_update.py:30"),
    ("quantize", qz.quantize, "quantize.cu",
     "src/repro/kernels/quantize.py:35"),
    ("dequantize", qz.dequantize, "quantize.cu",
     "src/repro/kernels/quantize.py:52"),
    ("dsc_quantize", dq.dsc_quantize, "dsc_quantize.cu",
     "src/repro/kernels/dsc_quantize.py:36"),
    ("flash_fwd", fa.flash_fwd, "flash_fwd_sm90.cu",
     "src/repro/kernels/flash_attention.py:50"),
    ("flash_dq", fa.flash_dq, "flash_bwd_sm90.cu",
     "src/repro/kernels/flash_attention.py:90"),
    ("flash_dkv", fa.flash_dkv, "flash_bwd_sm90.cu",
     "src/repro/kernels/flash_attention.py:124"),
)
WIRE = {name: fn for name, fn, _, _ in KERNELS[1:5]}
FLASH = {name: fn for name, fn, _, _ in KERNELS[5:]}
ROUND = {**WIRE, **FLASH}        # every kernel the ERIS round may launch
# each counts its bf16 launches (tensor_core_launches) and its f32 ones
# (f32_tensor_core_launches, 3xTF32) apart, all on the tensor cores
TENSOR_CORE = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)

# kernel vs plain version: f32 agrees to summation order; with bf16 pools
# the plain version rounds its softmax weights to bf16 before the PV
# product while the kernel keeps them in f32
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
# the paged kernel at a long context: the softmax spreads over thousands
# of keys, so an output is ~1/sqrt(keys) of V's scale (0.0055 at 32,768
# keys of N(0, 1) values under a flat softmax), below the bounds above;
# each (row, head)'s output vector is also held to its norm relative to
# the plain version's (bf16's output rounding is ~0.2% of it).  A lost
# or doubled chunk of 64 keys moves it by ~sqrt(64 / keys) under a flat
# softmax: 4.4% at 32,768 keys, 8.8% at a window of 8,192.
PAGED_REL_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
# one full-width decode step, kernel vs plain version, bf16 end to end:
# the attention outputs differ by the weights' bf16 rounding in every
# layer, so the logits are held to a relative norm (their argmax may flip
# where random weights leave near ties; the agreement is printed)
LOGITS_REL_TOL = 3e-2

PROMPT_MIN, PROMPT_MAX, GEN, REQUESTS = 32, 256, 32, 8


class PhaseError(RuntimeError):
    pass


_DRAWN: dict = {}         # (config, seed) -> its init_params draw, on the host


def _init_params(cfg, seed, dev) -> dict:
    """``tr.init_params(cfg, seed)`` on ``dev``: drawn on the card the first
    time a (config, seed) asks, and from then on copied from a pinned host
    copy of that draw, the same bits (a full-width draw takes seconds,
    the copy a fraction of one)."""
    key = (cfg, seed)
    if key not in _DRAWN:
        params = tr.init_params(cfg, seed=seed, device=dev)
        _DRAWN[key] = tree_map(lambda t: t.cpu().pin_memory(), params)
        return params
    return tree_map(lambda t: t.to(dev), _DRAWN[key])


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


PHASE_SECONDS = {}
_current = []                    # (name, start) of the phase under way


def phase(name) -> None:
    """Ends the phase under way, keeping its seconds, and starts ``name``
    (None starts nothing)."""
    now = time.monotonic()
    if _current:
        last, t0 = _current.pop()
        PHASE_SECONDS[last] = now - t0
        print(f"   ({last}: {PHASE_SECONDS[last]:.1f} s)", flush=True)
    if name is not None:
        _current.append((name, now))
        print(f"== {name}", flush=True)


# ------------------------------------------------------------ phase 1 / 2
def device_phase() -> torch.device:
    phase("1 device")
    check(torch.cuda.is_available(),
          "no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    # a reference states and sets both: full f32 products on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def build_phase() -> None:
    phase("2 build")
    t0 = time.monotonic()
    seconds = _build.build()
    print(f"built {_build.sources()} in {time.monotonic() - t0:.2f} s "
          f"(per source: {json.dumps(seconds)})")
    for name in _build.sources():
        log = _build.library_path(name).with_name(
            _build.library_path(name).name + ".log")
        if log.exists():
            for kernel, report in _ptxas_report(log.read_text()):
                print(f"  ptxas {name}: {kernel}: {report}")
    fwd_smem = _build.bind("flash_fwd_sm90", "flash_fwd_sm90_smem",
                           [ctypes.c_int])
    smem = _build.bind("flash_bwd_sm90", "flash_bwd_sm90_smem",
                       [ctypes.c_int, ctypes.c_int])
    print("  flash_fwd_sm90 and flash_bwd_sm90 dynamic shared memory a "
          "block, bytes: " +
          json.dumps({**{f"forward d={d}": fwd_smem(d)
                         for d in fa.HEAD_DIMS},
                      **{f"{kind} d={d}": smem(i, d)
                         for i, kind in enumerate(("dq", "dk/dv"))
                         for d in fa.HEAD_DIMS}}))
    f32_smem = _build.bind("flash_f32_sm90", "flash_f32_sm90_smem",
                           [ctypes.c_int, ctypes.c_int])
    print("  flash_f32_sm90 dynamic shared memory a block (the forward and "
          "dq with two stages), bytes: " +
          json.dumps({f"{kind} d={d}": f32_smem(i, d)
                      for i, kind in enumerate(("forward", "dk/dv", "dq"))
                      for d in fa.HEAD_DIMS}))
    paged_smem = _build.bind("paged_attention", "paged_attention_smem",
                             [ctypes.c_int] * 4)
    print("  paged_attention dynamic shared memory a block (bf16 pools, "
          "bs 16), bytes: " + json.dumps(
              {f"G={G} hd={hd}": paged_smem(G, hd, pa.chunk_positions(16), 2)
               for G, hd in ((1, 128), (7, 64))}))


def _ptxas_report(log: str):
    """(kernel<template args>, "N registers, spills ...") for each entry
    function of an ``-Xptxas -v`` log, and any wgmma serialisation
    warning."""
    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:                   # <length><name> in the mangled name
            mangled = entry.group(1)
            for m in re.finditer(r"(?=(\d+))", mangled):
                at = m.start() + len(m.group(1))
                name = mangled[at:at + int(m.group(1))]
                if name.endswith("_kernel"):  # I<args>E, Li128E an int
                    args = re.match(r"I(\w+?)EEv", mangled[at + len(name):])
                    args = "" if args is None else re.sub(
                        r"L[a-z](\d+)E", r"\1,", args.group(1)).replace(
                        "13__nv_bfloat16", "bf16,").strip(",")
                    kernel = name + (f"<{args}>" if args else "")
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and kernel:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((kernel, f"{regs} registers, {spills}"))
        elif "wgmma" in line:
            out.append((kernel, line.strip()))
    return out


# ---------------------------------------------------------------- phase 3
def _inputs(gen, dev, B, H, KV, hd, bs, P, ctx, qdt, kvdt, n_pools=1):
    """q, (n_pools, N, KV, bs, hd) pools, shuffled block tables, ctx."""
    N = B * P + 1
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(qdt)
    shape = (n_pools, N, KV, bs, hd)
    kp = torch.randn(shape, generator=gen, device=dev).to(kvdt)
    vp = torch.randn(shape, generator=gen, device=dev).to(kvdt)
    perm = torch.randperm(N - 1, generator=gen, device=dev) + 1
    tbl = perm.reshape(B, P).to(torch.int32)
    return q, kp, vp, tbl, torch.tensor(ctx, dtype=torch.int32, device=dev)


def kernel_cases(dev, seed):
    """Kernel vs plain version at the listed shapes (eris-gptneo-1.3b's
    and qwen2-0.5b's (heads, kv heads, head dim), whole and at one model
    position of two, as the serving mesh cuts them), over short contexts
    (one or a few 64-position chunks) and long ones (up to 32 chunks, so
    the merge of the chunks' partials runs); then a CUDA graph of the
    kernel replayed against an eager call.  Returns the largest absolute
    error seen."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bs = 16
    # an inactive row, single tokens, page and chunk edges, and contexts
    # over many pages up to the table's reach; then up to 2048 over 128
    # pages
    contexts = ((18, [0, 1, 15, 16, 17, 100, 203, 18 * bs]),
                (128, [0, 63, 65, 700, 1024, 1500, 2047, 128 * bs]))
    worst = 0.0
    for P, ctx in contexts:
        for H, KV, hd in ((16, 16, 128), (14, 2, 64), (8, 8, 128),
                          (7, 1, 64)):
            for window in (None, 40 if P < 100 else 1000):
                for qdt, kvdt in ((torch.float32, torch.float32),
                                  (torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.bfloat16)):
                    q, kp, vp, tbl, c = _inputs(gen, dev, len(ctx), H, KV,
                                                hd, bs, P, ctx, qdt, kvdt)
                    kp, vp = kp[0], vp[0]
                    out = pa.paged_attention(q, kp, vp, tbl, c, window=window)
                    ref = pa.paged_attention_ref(q, kp, vp, tbl, c,
                                                 window=window)
                    torch.cuda.synchronize()
                    tol = TOL_F32 if kvdt == torch.float32 else TOL_BF16
                    err = (out.float() - ref.float()).abs()
                    bound = tol + tol * ref.float().abs()
                    check(bool((err <= bound).all()),
                          f"kernel disagrees with the plain version at H={H} "
                          f"KV={KV} hd={hd} window={window} q={qdt} "
                          f"pool={kvdt} ctx={ctx}: max err "
                          f"{float(err.max())}")
                    check(not bool(out[0].any()),
                          "ctx-0 row is not exact zeros")
                    for b in range(len(ctx)):
                        pages = max(1, pages_for(ctx[b], bs))
                        one = pa.paged_attention(q[b:b + 1], kp, vp,
                                                 tbl[b:b + 1, :pages],
                                                 c[b:b + 1], window=window)
                        check(torch.equal(one[0], out[b]),
                              f"row {b} alone differs from row {b} of "
                              f"batch 8 (ctx {ctx[b]}, window {window})")
                    worst = max(worst, float(err.max()))
                    print(f"  H={H:2d} KV={KV:2d} hd={hd:3d} P={P:3d} "
                          f"window={window} q={str(qdt)[6:]} "
                          f"pool={str(kvdt)[6:]}: max abs err "
                          f"{float(err.max()):.3e} (tol {tol:g}), ctx-0 row "
                          f"zero, batch-8 rows == rows alone")
    # a CUDA graph of the kernel at the long contexts, replayed twice
    eager = pa.paged_attention(q, kp, vp, tbl, c, window=window)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        pa.paged_attention(q, kp, vp, tbl, c, window=window)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        replayed = pa.paged_attention(q, kp, vp, tbl, c, window=window)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        check(torch.equal(replayed, eager),
              "paged kernel: a CUDA graph replay differs from the eager call")
    check(not bool(pa._workspaces[dev.index][1].any()),
          "paged kernel: a merge counter was left non-zero")
    print(f"  CUDA graph of the kernel (ctx {ctx}, window {window}) replayed "
          f"twice == the eager call, bit for bit; merge counters zero")
    return worst


def _graph_ms(fn, n: int) -> float:
    """Device time of one call of ``fn(i)``, i = 0..n-1, captured back to
    back in a CUDA graph so the host's enqueue cost is not measured."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n)


# the first design's time at eris-gptneo-1.3b's decode shape, one block a
# (request, kv head) (PERF.md's kernel table: NVIDIA H100 80GB HBM3,
# 700.00 W); qwen2-0.5b's decode shape was not timed then
PAGED_FIRST_DESIGN_US = {"eris-gptneo-1.3b": 21.42}


def decode_shape_timing(dev, seed, cfg, ctx, block_size, model: int = 1):
    """The kernel and its plain version at a model's decode shape: batch 8
    at the given contexts, one layer's pools out of n_layers so that,
    as in the decode step, each call finds its pool cold in L2.  With
    ``model`` > 1, at one model position's heads (its share of the heads
    and of the kv heads, as the serving mesh cuts them).  The timed call
    is held to the plain version within phase 3's bf16 bound."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    B, hd = len(ctx), cfg.hd
    H, KV = cfg.n_heads // model, cfg.n_kv_heads // model
    P = max(pages_for(c, block_size) for c in ctx)
    q, kp, vp, tbl, c = _inputs(gen, dev, B, H, KV, hd, block_size, P, ctx,
                                torch.bfloat16, torch.bfloat16,
                                n_pools=cfg.n_layers)
    Lyr = cfg.n_layers
    out = pa.paged_attention(q, kp[0], vp[0], tbl, c)
    ref = pa.paged_attention_ref(q, kp[0], vp[0], tbl, c)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    check(bool((diff <= TOL_BF16 + TOL_BF16 * ref.float().abs()).all()),
          f"{cfg.name} at model {model}: kernel disagrees with the plain "
          f"version at H={H} KV={KV} hd={hd} ctx={ctx}: max err {err}")
    ms = _graph_ms(lambda i: pa.paged_attention(q, kp[i % Lyr], vp[i % Lyr],
                                                tbl, c), 4 * Lyr)
    plain_ms = _graph_ms(lambda i: pa.paged_attention_ref(
        q, kp[i % Lyr], vp[i % Lyr], tbl, c), Lyr)
    # least work: each valid key and value read once, q/tables/ctx read
    # and out written once; 4 * H * hd f32 operations per key
    keys = sum(ctx)
    nbytes = (keys * KV * hd * 2 * kp.element_size()
              + 2 * q.numel() * q.element_size() + tbl.numel() * 4 + B * 4)
    ops = keys * H * hd * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    was = PAGED_FIRST_DESIGN_US.get(cfg.name) if model == 1 else None
    where = cfg.name + (f" at model {model}" if model > 1 else "")
    print(f"  {where} decode shape B={B} H={H} KV={KV} hd={hd} "
          f"bs={block_size} ctx={ctx}: kernel {ms * 1e3:.2f} us (first "
          f"design: {'not timed' if was is None else f'{was:.2f} us'}), "
          f"plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by "
          f"{bound_by} ({nbytes} bytes, {ops} ops), kernel at "
          f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s, "
          f"{100 * bound_ms / ms:.1f}% of its bound, max abs err {err:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


# ---------------------------------------------------------------- phase 4
class LogitSpy:
    """Wraps ``transformer.forward``/``paged_decode_step`` while the
    engine runs: counts non-finite logits on the device (no extra host
    sync) and times each call with CUDA events."""

    def __init__(self):
        self.bad = None
        self.events = {"prefill": [], "decode": []}
        self._saved = (tr.forward, tr.paged_decode_step)

    def _wrap(self, fn, kind):
        def run(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events[kind].append((start, end))
            nonfinite = (~torch.isfinite(out[0])).sum()
            self.bad = nonfinite if self.bad is None else self.bad + nonfinite
            return out
        return run

    def __enter__(self):
        tr.forward = self._wrap(self._saved[0], "prefill")
        tr.paged_decode_step = self._wrap(self._saved[1], "decode")
        return self

    def __exit__(self, *exc):
        tr.forward, tr.paged_decode_step = self._saved

    def ms(self, kind):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[kind]]


def serving_phase(dev, seed, cfg, params, requests, settings):
    # warm-up outside the measured run: cuBLAS handles, the loaded library
    warm = serve_lib.settings_for(requests[:1], 2, 1, cache_dtype="bfloat16")
    serve_lib.serve(ServeEngine(cfg, params, warm, device=dev), requests[:1])
    torch.cuda.synchronize()

    engine = ServeEngine(cfg, params, settings, device=dev)
    with LogitSpy() as spy:
        pa.paged_attention.launches = 0           # the main path starts
        t0 = time.monotonic()
        outs = serve_lib.serve(engine, requests)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = pa.paged_attention.launches    # the main path ended
    st = engine.stats()
    check(len(outs) == REQUESTS, f"{len(outs)} of {REQUESTS} requests came back")
    check(all(o.finish_reason == "length" and len(o.tokens) == GEN
              for o in outs), "a request did not finish by length")
    check(all(0 <= t < cfg.vocab for o in outs for t in o.tokens),
          "a token outside the vocabulary")
    check(int(spy.bad) == 0, f"{int(spy.bad)} non-finite logits")
    check(st["decode_steps"] > 0 and
          launches == cfg.n_layers * st["decode_steps"],
          f"paged kernel launched {launches} times over "
          f"{st['decode_steps']} decode steps of {cfg.n_layers} layers")
    decode_ms, prefill_ms = spy.ms("decode"), spy.ms("prefill")
    ttft = [o.ttft_s for o in outs]
    metrics = {
        "wall_s": wall, "tokens_out": st["tokens_out"],
        "tokens_per_s": st["tokens_per_s"],
        "decode_tokens_per_s": (REQUESTS * st["decode_steps"]
                                / (sum(decode_ms) / 1e3)),
        "mean_ttft_ms": 1e3 * sum(ttft) / len(ttft),
        "max_ttft_ms": 1e3 * max(ttft),
        "decode_steps": st["decode_steps"],
        "decode_step_ms_mean": sum(decode_ms) / len(decode_ms),
        "decode_step_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
        "prefills": len(prefill_ms),
        "prefill_ms_mean": sum(prefill_ms) / len(prefill_ms),
        "peak_blocks": st["peak_blocks"],
        "block_capacity": st["block_capacity"],
        "kernel_launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("serving " + json.dumps(metrics))
    print(f"  {REQUESTS} requests, {st['tokens_out']} tokens: "
          f"{metrics['tokens_per_s']:.1f} tok/s over the run, mean TTFT "
          f"{metrics['mean_ttft_ms']:.1f} ms, peak blocks "
          f"{st['peak_blocks']}/{st['block_capacity']}, kernel launches "
          f"{launches} = {cfg.n_layers} layers x {st['decode_steps']} steps")
    return launches, metrics


class RouteSpy:
    """Keeps every ``route_tokens`` call's top-k experts, dispatch and
    combine weights, in layer order, of the forward run inside it (none
    for a dense model): ``idxs[0]`` and ``disps[0]`` are layer 0's
    routes.  With ``pin`` (another run's ``(disp, comb)`` list) each
    call still records its own routes but returns the pinned ones."""

    def __init__(self, pin=None):
        self.pin = pin

    def __enter__(self):
        self.idxs, self.disps, self.routes = [], [], []
        self._saved = (moe_lib.route_tokens, moe_lib.sorted_top_k)
        route, top_k = self._saved

        def spy_top_k(x, k):
            vals, idx = top_k(x, k)
            self.idxs.append(idx.detach().clone())
            return vals, idx

        def spy_route(*a, **kw):
            disp, comb, aux = route(*a, **kw)
            self.disps.append(disp.detach().clone())
            self.routes.append((disp.detach().clone(), comb.detach().clone()))
            if self.pin is not None:
                disp, comb = self.pin[len(self.routes) - 1]
            return disp, comb, aux

        moe_lib.route_tokens, moe_lib.sorted_top_k = spy_route, spy_top_k
        return self

    def __exit__(self, *exc):
        moe_lib.route_tokens, moe_lib.sorted_top_k = self._saved


def replay_phase(dev, cfg, params, requests, settings, step_ms):
    """One decode step of a live engine state, through the kernel and
    through the plain version, on copies of the same pools; then a
    profile of that step against the run's decode step time."""
    engine = ServeEngine(cfg, params, settings, device=dev)
    for i, (prompt, samp) in enumerate(requests):
        engine.submit(prompt, sampling=samp, seed=i)
    for _ in range(4):
        engine.step()
    engine._schedule()
    tables, ctxs, toks, _ = engine._decode_batch()

    def step(use_kernel, pin=None):
        pools = {n: t.clone() for n, t in engine.pools.items()}
        with RouteSpy(pin) as spy:
            logits, _ = tr.paged_decode_step(
                engine.params, cfg, pools, tables, ctxs, toks,
                window=engine.window, use_kernel=use_kernel)
        return logits[:, 0].float(), spy

    # a moe step's plain replay takes the kernel step's expert slots and
    # combine weights in every layer, so the two differ in attention only
    # (bf16 attention moves near-tie routes, and at capacity 1 a moved
    # route moves its batch's others; those rows are counted)
    got, kernel_spy = step(True)
    want, plain_spy = step(False, kernel_spy.routes if kernel_spy.routes
                           else None)
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite logits in the replayed step")
    rel = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    note = ""
    if kernel_spy.routes:
        moved = [bool((a != b).any()) for a, b in
                 zip(kernel_spy.disps, plain_spy.disps)]
        rows = torch.zeros(got.shape[0], dtype=torch.bool)
        for a, b in zip(kernel_spy.disps, plain_spy.disps):
            rows |= (a != b).flatten(2).any(-1).flatten().cpu()
        note = (f"; the plain version's own routes differ in "
                f"{sum(moved)} of {len(moved)} layers (first: "
                f"{moved.index(True) if any(moved) else None}), "
                f"{int(rows.sum())} of {len(rows)} rows; replayed with "
                f"the kernel step's routes")
    check(rel <= LOGITS_REL_TOL,
          f"decode step logits, kernel vs plain: relative error {rel:.3e}")
    print(f"  replayed decode step at ctx {ctxs.tolist()}: logits kernel vs "
          f"plain relative error {rel:.3e} (tol {LOGITS_REL_TOL:g}), max abs "
          f"{float((got - want).abs().max()):.3e}, argmax agreement "
          f"{agree:.3f}{note}")
    profile_steps(engine, cfg, tables, ctxs, toks, step_ms)


def profile_steps(engine, cfg, tables, ctxs, toks, step_ms):
    """torch.profiler over three decode steps: device kernels by time, the
    device's busy share of the unprofiled step time ``step_ms``, and the
    host ops by self time (the profiler inflates host time)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    pools = {n: t.clone() for n, t in engine.pools.items()}
    for _ in range(2):
        tr.paged_decode_step(engine.params, cfg, pools, tables, ctxs, toks)
    torch.cuda.synchronize()
    steps = 3
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tr.paged_decode_step(engine.params, cfg, pools, tables, ctxs,
                                 toks)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3 / steps
    launches = sum(n for _, n in kernels.values()) / steps
    print(f"  profile: per decode step {launches:.0f} device kernels, "
          f"{busy_ms:.3f} ms busy; of the unprofiled {step_ms:.3f} ms step "
          f"the device is idle {100 * (1 - busy_ms / step_ms):.1f}%")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    device {us / steps:9.1f} us/step {n // steps:5d}x  "
              f"{name[:80]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:8]:
        print(f"    host {e.self_cpu_time_total / steps:11.1f} us/step "
              f"{e.count // steps:5d}x  {e.key[:80]}")


def small_input_phase(dev, seed, arch="qwen2-0.5b"):
    """``arch``'s smoke variant in f32 (qwen2-0.5b's: GQA 4/2, qkv bias,
    tied embeddings): greedy and sampled tokens on the card, through the
    kernel and the threefry sampler, equal the host's plain-torch tokens,
    which the CPU tests hold to the JAX reference."""
    cfg = get_config(arch).smoke()
    requests = [(p, serve_lib.SAMPLED if i % 2 else SamplingParams())
                for i, (p, _) in enumerate(serve_lib.random_requests(
                    cfg.vocab, 6, 5, 40, seed))]
    settings = serve_lib.settings_for(requests, 8, 3, cache_dtype="float32")
    host = tr.init_params(cfg, seed=seed, device="cpu")
    card = {k: (v.to(dev) if not isinstance(v, dict) else
                {n: t.to(dev) for n, t in v.items()})
            for k, v in host.items()}
    a = serve_lib.serve(ServeEngine(cfg, card, settings, device=dev),
                        requests)
    b = serve_lib.serve(ServeEngine(cfg, host, settings, device="cpu"),
                        requests)
    check([o.tokens for o in a] == [o.tokens for o in b],
          f"{arch} smoke: card and host tokens differ")
    print(f"  {arch} smoke f32: {len(a)} streams (greedy and sampled, "
          f"{serve_lib.SAMPLED}) on the card == on the host")


# ---------------------------------------------------------------- phase 5
FULL_N = 1_816_565_760          # eris-gptneo-1.3b's parameters: one client
WINDOW = 1 << 26                # the plain versions' timing window
WRAP = 2**32 - 4096             # an index base that straddles 2**32
GAMMA = 0.37


def _same(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The kernel's output must equal the plain version's bit for bit;
    returns the largest absolute difference (0.0)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: kernel gives {got.dtype} {tuple(got.shape)}, plain "
          f"version {want.dtype} {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    check(torch.equal(got, want),
          f"{what}: kernel differs from the plain version "
          f"({int((got != want).sum())} of {got.numel()} differ, max abs "
          f"err {err:.3e})")
    return err


def wire_cases(dev, seed) -> float:
    """Each wire kernel against its plain version, bit for bit, at ragged
    and block-aligned n, f32 and bf16 g, p = 0.25 and 1, and index bases
    0 and 2**32 - 4096; the first full block is zeros, the last is ragged.
    Returns the largest absolute error seen (0.0)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    worst, cases = 0.0, 0
    for n in (3 * 2**20 + 77, 2**24):
        for gdt in (torch.float32, torch.bfloat16):
            g = torch.randn(n, generator=gen, device=dev).to(gdt)
            s = 0.3 * torch.randn(n, generator=gen, device=dev)
            g[256:512] = 0.0                           # a zero block
            s[256:512] = 0.0
            for base in (0, WRAP):
                tag = f"n={n} g={str(gdt)[6:]} base={base}"
                for p in (0.25, 1.0):
                    v, s1 = du.dsc_update(g, s, seed + 1, p=p, gamma=GAMMA,
                                          index_base=base)
                    rv, rs1 = wire_ref.dsc_update_ref(
                        g, s, seed + 1, p=p, gamma=GAMMA, index_base=base)
                    worst = max(worst, _same(f"dsc_update v {tag}", v, rv),
                                _same(f"dsc_update s' {tag}", s1, rs1))
                    q, sc, s2 = dq.dsc_quantize(g, s, seed + 2, seed + 3,
                                                p=p, gamma=GAMMA,
                                                index_base=base)
                    rq, rsc, rs2 = wire_ref.dsc_quantize_ref(
                        g, s, seed + 2, seed + 3, p=p, gamma=GAMMA,
                        index_base=base)
                    worst = max(worst, _same(f"dsc_quantize q {tag}", q, rq),
                                _same(f"dsc_quantize scales {tag}", sc, rsc),
                                _same(f"dsc_quantize s' {tag}", s2, rs2))
                    check(float(sc[1]) == 0.0 and not bool(q[256:512].any())
                          and not bool(q[n:].any()),
                          f"dsc_quantize {tag}: a zero block or the padded "
                          f"tail moved")
                    cases += 2
                q, sc = qz.quantize(g, seed + 4, index_base=base)
                rq, rsc = wire_ref.quantize_ref(g, seed + 4, index_base=base)
                worst = max(worst, _same(f"quantize q {tag}", q, rq),
                            _same(f"quantize scales {tag}", sc, rsc),
                            _same(f"dequantize {tag}", qz.dequantize(q, sc),
                                  wire_ref.dequantize_ref(q, sc)))
                check(float(sc[1]) == 0.0 and not bool(q[n:].any()),
                      f"quantize {tag}: a zero block or the tail moved")
                cases += 2
            # in place: s' written over s, as the round does
            s_in = s.clone()
            q, sc, s3 = dq.dsc_quantize(g, s_in, 1, 2, p=0.25, gamma=GAMMA,
                                        out=s_in)
            rq, rsc, rs3 = wire_ref.dsc_quantize_ref(g, s, 1, 2, p=0.25,
                                                     gamma=GAMMA)
            check(s3 is s_in, "dsc_quantize(out=s) did not write into s")
            worst = max(worst, _same("dsc_quantize in place", s3, rs3))
    torch.cuda.synchronize()
    print(f"  {cases} kernel calls bit-identical to their plain versions "
          f"(codes, scales, v, s'), zero block and ragged tail unmoved, "
          f"across the 2**32 index wrap; max abs err {worst:.3e}")
    return worst


def _event_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``, by CUDA events over ``reps``
    calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: int, ops: int) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


# scalar operations a coordinate, counted from each kernel's arithmetic
# (a draw is 13: index, seed, the hash's 8, shift, convert, scale), all
# taken at the f32 rate: the card lists no separate integer rate
OPS_PER_COORD = {"dsc_update": 13 + 5, "quantize": 13 + 10,
                 "dequantize": 2, "dsc_quantize": 2 * 13 + 5 + 10 + 2}


def wire_timing(dev, seed) -> dict:
    """Each wire kernel at the round's per-client n with an f32 g, and its
    plain version on a 2**26-coordinate window (its int64 index tensor
    does not fit at full width), beside the kernel's bound."""
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    n = FULL_N
    n_pad = qz.padded(n)
    nb = n_pad // wire_ref.QBLOCK
    g = torch.randn(n, generator=gen, device=dev)
    s = 0.3 * torch.randn(n, generator=gen, device=dev)
    gw, sw = g[:WINDOW], s[:WINDOW]
    q, sc = qz.quantize(g, 5)
    qw, scw = q[:WINDOW], sc[:WINDOW // wire_ref.QBLOCK]
    calls = {
        "dsc_update": (
            lambda: du.dsc_update(g, s, 1, p=0.25, gamma=GAMMA, out=s),
            lambda: du.dsc_update(gw, sw, 1, p=0.25, gamma=GAMMA, out=sw),
            lambda: wire_ref.dsc_update_ref(gw, sw, 1, p=0.25, gamma=GAMMA),
            16 * n),
        "quantize": (
            lambda: qz.quantize(g, 5), lambda: qz.quantize(gw, 5),
            lambda: wire_ref.quantize_ref(gw, 5),
            4 * n + n_pad + 4 * nb),
        "dequantize": (
            lambda: qz.dequantize(q, sc), lambda: qz.dequantize(qw, scw),
            lambda: wire_ref.dequantize_ref(qw, scw),
            n_pad + 4 * nb + 4 * n_pad),
        "dsc_quantize": (
            lambda: dq.dsc_quantize(g, s, 1, 2, p=0.25, gamma=GAMMA, out=s),
            lambda: dq.dsc_quantize(gw, sw, 1, 2, p=0.25, gamma=GAMMA,
                                    out=sw),
            lambda: wire_ref.dsc_quantize_ref(gw, sw, 1, 2, p=0.25,
                                              gamma=GAMMA),
            8 * n + n_pad + 4 * nb + 4 * n),
    }
    out = {}
    for name, (full, window, plain, nbytes) in calls.items():
        ms = _event_ms(full, 3)
        window_ms = _event_ms(window, 5)
        plain_ms = _event_ms(plain, 2)
        b = _bound(nbytes, OPS_PER_COORD[name] * n)
        out[name] = dict(ms=ms, plain_ms=plain_ms, window_ms=window_ms, **b)
        print(f"  {name:12s} n={n}: kernel {ms:.3f} ms "
              f"({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s, "
              f"{100 * b['bound_ms'] / ms:.1f}% of its bound "
              f"{b['bound_ms']:.3f} ms by {b['bound_by']}); on the 2**26 "
              f"window kernel {window_ms:.3f} ms, plain version "
              f"{plain_ms:.3f} ms")
    del g, s, q, sc
    return out


# ---------------------------------------------------------------- phase 6
# (B, H, KV, S, d, dtype, bshd): a small f32 case, every shape phases 7-9
# and 11 give the kernels (eris-gptneo-1.3b's round, qwen2-0.5b's round,
# the smoke round of phase 9 in f32, the GPT-Neo context, and phase 11's
# step in f32: after adam's first step the params are f32, so steps 2-3
# run the f32 kernels at d = 128), qwen2-0.5b's GQA (7 heads a kv head)
# over four and eight k-tiles, a ragged S at d = 128, contiguous (B, H, S,
# d) inputs beside the model's (B, S, H, d) views, and d = 16 and 32, the
# last five in bf16 and in f32; then both models' context in f32, the f32
# kernels' longest sums (dk/dv at GQA 7 sums 7 heads of 32 q-tiles); then
# phase 15's: hymba-1.5b's round and 2048-token gradient (GQA 5 at d = 64)
# and internvl2-26b's round and gradient (GQA 6 at d = 128, S = 512); each
# under every mask
FLASH_SHAPES = ((2, 4, 2, 128, 64, torch.float32, True),
                (8, 16, 16, 64, 128, torch.float32, True),
                (4, 16, 16, 64, 128, torch.bfloat16, True),
                (4, 14, 2, 64, 64, torch.bfloat16, True),
                (4, 4, 2, 64, 64, torch.float32, True),
                (2, 14, 2, 256, 64, torch.bfloat16, True),
                (1, 16, 16, 2048, 128, torch.bfloat16, True),
                (1, 4, 4, 100, 128, torch.bfloat16, True),
                (1, 14, 2, 512, 64, torch.bfloat16, True),
                (2, 4, 4, 128, 128, torch.bfloat16, False),
                (1, 4, 4, 100, 128, torch.float32, True),
                (1, 14, 2, 512, 64, torch.float32, True),
                (2, 4, 4, 128, 128, torch.float32, False),
                (1, 2, 1, 256, 16, torch.float32, True),
                (1, 2, 1, 128, 32, torch.float32, True),
                (1, 14, 2, 2048, 64, torch.float32, True),
                (1, 16, 16, 2048, 128, torch.float32, True),
                (4, 25, 5, 64, 64, torch.bfloat16, True),
                (1, 25, 5, 2048, 64, torch.bfloat16, True),
                (4, 48, 8, 512, 128, torch.bfloat16, True),
                (1, 48, 8, 512, 128, torch.bfloat16, True))
# the flash kernels and their plain versions both compute in f32 and cast
# once, so a bf16 output may differ by one bf16 step (2**-7 of its size)
# and the f32 sums' order
FLASH_BF16_STEP = 2.0 ** -7
# causal, full, and causal with windows of 100 and 200 (four k-tiles)
FLASH_MASKS = ((True, None), (False, None), (True, 100), (True, 200))
# timed causal in bf16: the two rounds' shapes (4 clients' batch of 4 x 64
# tokens is one call per layer), both models at the GPT-Neo context, and
# phase 15's gradients: hymba-1.5b at 2048 and internvl2-26b at 512
FLASH_TIMED = (("gptneo-round", (4, 16, 16, 64, 128)),
               ("qwen2-round", (4, 14, 2, 64, 64)),
               ("gptneo-s2048", (1, 16, 16, 2048, 128)),
               ("qwen2-s2048", (1, 14, 2, 2048, 64)),
               ("hymba-s2048", (1, 25, 5, 2048, 64)),
               ("internvl-s512", (1, 48, 8, 512, 128)))
# timed causal in f32: phase 11's step from its second step on, 8 x 64
# tokens on one rank, and both models' context, where the products and not
# the bytes bound the f32 kernels
FLASH_TIMED_F32 = (("gptneo-train-f32", (8, 16, 16, 64, 128)),
                   ("gptneo-s2048-f32", (1, 16, 16, 2048, 128)),
                   ("qwen2-s2048-f32", (1, 14, 2, 2048, 64)))
# each kernel's first version's time in us at those shapes: f32 FMAs on
# the CUDA cores (PERF.md's kernel table: NVIDIA H100 80GB HBM3, 700.00 W),
# printed beside this run's; at qwen2's S = 2048 only the SIMT forward
# was timed; at S = 2048 in f32 the SIMT kernels were timed by
# tools/kernel_ab.py against the parent tree
FIRST_VERSION_US = {"gptneo-round": {"flash_fwd": 23.24, "flash_dq": 28.82,
                            "flash_dkv": 30.68},
           "qwen2-round": {"flash_fwd": 12.12, "flash_dq": 16.40,
                           "flash_dkv": 105.57},
           "gptneo-s2048": {"flash_fwd": 1582.0, "flash_dq": 2058.5,
                            "flash_dkv": 1964.9},
           "qwen2-s2048": {"flash_fwd": 622.90},
           "gptneo-train-f32": {"flash_fwd": 23.11, "flash_dq": 27.57,
                                "flash_dkv": 31.23},
           "gptneo-s2048-f32": {"flash_fwd": 1651.98, "flash_dq": 1873.53,
                                "flash_dkv": 1942.94},
           "qwen2-s2048-f32": {"flash_fwd": 620.50, "flash_dq": 814.75,
                               "flash_dkv": 3164.05}}
# f32 operations per visible (query, key) pair, per unit of head dim:
# forward q.k and p v; dq adds do.v and ds k; dk/dv do.v, p^T do, ds^T q
FLASH_FLOPS = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}


def _flash_inputs(gen, dev, B, H, KV, S, d, dtype, bshd=True):
    """q, k, v, do as (B, H, S, d) views of (B, S, H, d) tensors, or
    contiguous."""
    def one(heads):
        if not bshd:
            return torch.randn(B, heads, S, d, generator=gen,
                               device=dev).to(dtype)
        return torch.randn(B, S, heads, d, generator=gen, device=dev).to(
            dtype).transpose(1, 2)
    return one(H), one(KV), one(KV), one(H)


def _flash_all(q, k, v, do, mask):
    """(o, lse, dq, dk, dv) through the kernels, and through the plain
    versions with the kernels' lse and delta."""
    o, lse = fa.flash_fwd(q, k, v, **mask)
    delta = wire_ref.flash_delta(o, do)
    got = (o, lse, fa.flash_dq(q, k, v, do, lse, delta, **mask),
           *fa.flash_dkv(q, k, v, do, lse, delta, **mask))
    want = (*wire_ref.flash_fwd_ref(q, k, v, **mask),
            wire_ref.flash_dq_ref(q, k, v, do, lse, delta, **mask),
            *wire_ref.flash_dkv_ref(q, k, v, do, lse, delta, **mask))
    return got, want


def flash_cases(dev, seed) -> dict:
    """Each flash kernel against its plain version at every listed shape
    and mask (f32: TOL_F32 absolute and relative, the order of summation
    and the 3xTF32 products; bf16 outputs: FLASH_BF16_STEP relative plus
    TOL_F32, one bf16 step; lse is f32 throughout); every bf16 forward, dq
    and dk/dv call launches the tensor-core kernels, every f32 one the f32
    tensor-core kernels.
    Prints each kernel's largest error as a share of its bound; returns
    its largest absolute error."""
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    worst = dict.fromkeys(FLASH, 0.0)
    share = dict.fromkeys(FLASH, 0.0)
    owner = ("flash_fwd", "flash_fwd", "flash_dq", "flash_dkv", "flash_dkv")
    for B, H, KV, S, d, dtype, bshd in FLASH_SHAPES:
        q, k, v, do = _flash_inputs(gen, dev, B, H, KV, S, d, dtype, bshd)
        for causal, window in FLASH_MASKS:
            mask = dict(causal=causal, window=window)
            tc = [fn.tensor_core_launches for fn in TENSOR_CORE]
            tc32 = [fn.f32_tensor_core_launches for fn in TENSOR_CORE]
            got, want = _flash_all(q, k, v, do, mask)
            torch.cuda.synchronize()
            added = [fn.tensor_core_launches - n
                     for fn, n in zip(TENSOR_CORE, tc)]
            added32 = [fn.f32_tensor_core_launches - n
                       for fn, n in zip(TENSOR_CORE, tc32)]
            bf16 = dtype == torch.bfloat16
            check(added == [int(bf16)] * 3 and added32 == [int(not bf16)] * 3,
                  f"flash forward, dq, dk/dv at {dtype}: {added} bf16 "
                  f"tensor-core launches, {added32} f32 ones")
            errs = []
            for kname, what, a, b in zip(owner, ("o", "lse", "dq", "dk", "dv"),
                                         got, want):
                rel = TOL_F32 if what == "lse" or dtype == torch.float32 \
                    else FLASH_BF16_STEP
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"flash {what}: kernel gives {a.dtype} "
                      f"{tuple(a.shape)}, plain {b.dtype} {tuple(b.shape)}")
                err = (a.float() - b.float()).abs()
                bound = TOL_F32 + rel * b.float().abs()
                share[kname] = max(share[kname], float((err / bound).max()))
                check(bool((err <= bound).all()),
                      f"{kname} disagrees with its plain version on {what} "
                      f"at B={B} H={H} KV={KV} S={S} d={d} {dtype} {mask}: "
                      f"max abs err {float(err.max()):.3e}")
                errs.append(float(err.max()))
                worst[kname] = max(worst[kname], errs[-1])
            print(f"  B={B} H={H:2d} KV={KV:2d} S={S:4d} d={d:3d} "
                  f"{str(dtype)[6:]:8s} {'bshd' if bshd else 'bhsd'} "
                  f"causal={causal!s:5s} "
                  f"window={window}: max abs err o/lse/dq/dk/dv "
                  f"{' '.join(f'{e:.2e}' for e in errs)}")
    print(f"  largest error as a share of its bound: "
          f"{ {k: round(v, 4) for k, v in share.items()} }")
    return worst


def _pairs(S: int, causal: bool) -> int:
    """(query, key) pairs of one head that the mask lets through."""
    return S * (S + 1) // 2 if causal else S * S


def _flash_bound(nbytes: int, flops: int, rate: float) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=flops)


def flash_timing(dev, seed) -> dict:
    """Each flash kernel and its plain version at the rounds' shapes and
    at S = 2048, causal, bf16, and at phase 11's f32 shape and S = 2048 in
    f32, in CUDA graphs of back-to-back calls (the host's enqueue is not
    measured); beside them scaled_dot_product_attention: its forward, and
    its forward and autograd backward less the forward (dq, dk and dv in
    one call).  The bound counts each input read once and each output
    written once at 3.35 TB/s, and the visible pairs' products at the bf16
    tensor-core peak of 989 TFLOP/s (f32: 165 TFLOP/s, the tensor cores'
    495 TFLOP/s of TF32 over the three products of an f32-accurate
    one)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    out = {}
    timed = ([(label, shape, torch.bfloat16) for label, shape in FLASH_TIMED]
             + [(label, shape, torch.float32)
                for label, shape in FLASH_TIMED_F32])
    for label, (B, H, KV, S, d), dtype in timed:
        q, k, v, do = _flash_inputs(gen, dev, B, H, KV, S, d, dtype)
        o, lse = fa.flash_fwd(q, k, v)
        delta = wire_ref.flash_delta(o, do)
        size = q.element_size()
        rate = BF16_TC_FLOPS if dtype == torch.bfloat16 else F32_TC_FLOPS
        qb, kvb, rows = (size * B * H * S * d, size * B * KV * S * d,
                         4 * B * H * S)
        nbytes = {"flash_fwd": 2 * qb + 2 * kvb + rows,
                  "flash_dq": 3 * qb + 2 * kvb + 2 * rows,
                  "flash_dkv": 2 * qb + 4 * kvb + 2 * rows}
        pairs = B * H * _pairs(S, True)
        calls = {
            "flash_fwd": (lambda i: fa.flash_fwd(q, k, v),
                          lambda i: wire_ref.flash_fwd_ref(q, k, v)),
            "flash_dq": (
                lambda i: fa.flash_dq(q, k, v, do, lse, delta),
                lambda i: wire_ref.flash_dq_ref(q, k, v, do, lse, delta)),
            "flash_dkv": (
                lambda i: fa.flash_dkv(q, k, v, do, lse, delta),
                lambda i: wire_ref.flash_dkv_ref(q, k, v, do, lse, delta)),
        }
        n = 24 if S <= 256 else 4
        gqa = {"enable_gqa": True} if KV != H else {}
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def lib_fwd(i):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  **gqa)

        def lib_fwd_bwd(i):
            o_ = F.scaled_dot_product_attention(*leaves, is_causal=True, **gqa)
            return torch.autograd.grad(o_, leaves, do)

        lib_fwd_ms = _graph_ms(lib_fwd, n)
        lib_bwd_ms = _graph_ms(lib_fwd_bwd, n) - lib_fwd_ms
        row = {}
        for name, (kernel, plain) in calls.items():
            row[name] = dict(
                ms=_graph_ms(kernel, n), plain_ms=_graph_ms(plain, n),
                library_ms=lib_fwd_ms if name == "flash_fwd" else lib_bwd_ms,
                **_flash_bound(nbytes[name], FLASH_FLOPS[name] * d * pairs,
                               rate))
            r = row[name]
            was = FIRST_VERSION_US.get(label, {}).get(name)
            print(f"  {label} B={B} H={H} KV={KV} S={S} d={d} "
                  f"{str(dtype)[6:]}: {name:9s} "
                  f"kernel {r['ms'] * 1e3:10.2f} us (first version: "
                  f"{'not timed' if was is None else f'{was:.2f} us'}), plain "
                  f"{r['plain_ms'] * 1e3:10.2f} us, bound "
                  f"{r['bound_ms'] * 1e3:8.2f} us by {r['bound_by']} "
                  f"({r['bytes']} bytes, {r['ops']} flops), kernel at "
                  f"{r['ops'] / (r['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
        print(f"  {label}: scaled_dot_product_attention forward "
              f"{lib_fwd_ms * 1e3:.2f} us, backward {lib_bwd_ms * 1e3:.2f} us "
              f"(kernels: forward {row['flash_fwd']['ms'] * 1e3:.2f} us, "
              f"dq + dk/dv {(row['flash_dq']['ms'] + row['flash_dkv']['ms']) * 1e3:.2f} us)")
        out[label] = row
    return out


# ---------------------------------------------------------------- phase 7
K_CLIENTS, A_AGGS, LR, BATCH, SEQ = 4, 8, 0.1, 4, 64
FL_CONFIGS = (
    # (name, FLConfig fields, kernels each client launches once)
    ("dsc-int8-fused", dict(use_dsc=True, compressor=RandP(p=0.25),
                            int8_wire=True, compress_impl="fused"),
     ("dsc_quantize", "dequantize")),
    ("dsc-pallas", dict(use_dsc=True, compressor=RandP(p=0.25),
                        compress_impl="pallas"),
     ("dsc_update",)),
    ("int8", dict(int8_wire=True), ("quantize", "dequantize")),
)
REPLAY_CLIENT, REPLAY_ROUND, REPLAY_N = 3, 1, 1 << 24


class TimedStage:
    """A compress stage with CUDA events around each client's apply; for
    the replayed (round, client) it also keeps a window of the stage's
    input, shift and output."""

    def __init__(self, stage, events: list, capture: dict):
        self.stage, self.events, self.capture = stage, events, capture

    def apply(self, keys, state, v, k, K=None):
        grab = self.capture.get("round") == REPLAY_ROUND and \
            k == REPLAY_CLIENT
        lo, hi = self.capture["window"]
        if grab:
            self.capture["g"] = v[lo:hi].clone()
            if state.dsc is not None:
                self.capture["s"] = state.dsc.s_clients[k][lo:hi].clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.stage.apply(keys, state, v, k, K)
        end.record()
        self.events.append((start, end))
        if grab:
            self.capture["out"] = out[lo:hi].clone()
            if state.dsc is not None:
                self.capture["s_after"] = \
                    state.dsc.s_clients[k][lo:hi].clone()
        return out


def _replay(stage, keys, capture, n) -> None:
    """Client 3's round-2 compression, on a 2**24 window, with the
    round's keys: for a kernel's path at index base 3 * n_pad + lo (past
    2**32), through the kernel and through the plain version; for the
    threefry (jnp) path, the window [lo, lo + 2**24) of client 3's draw,
    on the card and on the host.  Codes (or v) and s' bit for bit, and
    equal to what the round transmitted."""
    lo, _ = capture["window"]
    g, out = capture["g"], capture["out"]
    inner = stage.stage
    if isinstance(inner, DSCCompress) and inner.impl == "jnp":
        base = lo
        key = random.split(keys.comp, K_CLIENTS)[REPLAY_CLIENT]
        card_s, host_s = capture["s"].clone(), capture["s"].cpu()
        v = dsc_lib.compress_client(card_s, g, inner.compressor, inner.gamma,
                                    key, offset=lo, n=n)
        hv = dsc_lib.compress_client(host_s, g.cpu(), inner.compressor,
                                     inner.gamma, key, offset=lo, n=n)
        _same("replay v, card vs host", v.cpu(), hv)
        _same("replay s', card vs host", card_s.cpu(), host_s)
        _same("replay v vs the round", v, out)
        _same("replay s' vs the round", card_s, capture["s_after"])
    elif isinstance(inner, DSCCompress) and inner.impl == "fused":
        base = REPLAY_CLIENT * qz.padded(n) + lo
        k_in, k_q = random.split(keys.comp)
        args = (_seed_of(k_in), _seed_of(k_q))
        kw = dict(p=inner.p, gamma=inner.gamma, index_base=base)
        q, sc, s_new = dq.dsc_quantize(g, capture["s"].clone(), *args, **kw)
        rq, rsc, rs = wire_ref.dsc_quantize_ref(g, capture["s"], *args, **kw)
        _same("replay codes", q, rq)
        _same("replay scales", sc, rsc)
        _same("replay s'", s_new, rs)
        _same("replay s' vs the round", rs, capture["s_after"])
        _same("replay wire value vs the round",
              wire_ref.dequantize_ref(rq, rsc)[:g.numel()], out)
    elif isinstance(inner, DSCCompress):
        base = REPLAY_CLIENT * qz.padded(n, du.LANES) + lo
        kw = dict(p=inner.p, gamma=inner.gamma, index_base=base)
        seed = _seed_of(keys.comp)
        v, s_new = du.dsc_update(g, capture["s"].clone(), seed, **kw)
        rv, rs = wire_ref.dsc_update_ref(g, capture["s"], seed, **kw)
        _same("replay v", v, rv)
        _same("replay s'", s_new, rs)
        _same("replay v vs the round", rv, out)
        _same("replay s' vs the round", rs, capture["s_after"])
    else:
        check(isinstance(inner, Int8Wire), f"no replay for {inner}")
        base = REPLAY_CLIENT * qz.padded(n) + lo
        seed = _seed_of(keys.wire)
        q, sc = qz.quantize(g, seed, index_base=base)
        rq, rsc = wire_ref.quantize_ref(g, seed, index_base=base)
        _same("replay codes", q, rq)
        _same("replay scales", sc, rsc)
        _same("replay wire value vs the round",
              wire_ref.dequantize_ref(rq, rsc)[:g.numel()], out)
    torch.cuda.synchronize()
    print(f"  replayed client {REPLAY_CLIENT}'s round-{REPLAY_ROUND + 1} "
          f"compression on [{lo}, {lo + g.numel()}) at index base {base} "
          f"(mod 2**32: {base % 2**32}): "
          + ("card == host == the round" if base == lo else
             "kernel == plain version == the round") + ", bit for bit")


def _set_round_launches(value: int = 0) -> None:
    for fn in ROUND.values():
        fn.launches = value
    for fn in TENSOR_CORE:
        fn.tensor_core_launches = fn.f32_tensor_core_launches = value


def _flash_want(cfg, grads: int) -> dict:
    """Each flash kernel's launches in ``grads`` layer gradients of
    ``cfg`` (a gradient of L flash layers is L): under remat (every
    policy but ``none``, the configs' ``full`` as the reference's) the
    backward runs each layer's forward kernel again, dq and dk/dv once."""
    again = 1 if cfg.remat_policy == "none" else 2
    return {"flash_fwd": again * grads, "flash_dq": grads,
            "flash_dkv": grads}


def _check_tensor_cores(what: str, want: dict, bf16: bool) -> None:
    """``want[name]`` calls of each flash kernel, all bf16 or all f32,
    went to the tensor-core kernels of their dtype."""
    tc = [fn.tensor_core_launches for fn in TENSOR_CORE]
    tc32 = [fn.f32_tensor_core_launches for fn in TENSOR_CORE]
    n = [want[k] for k in FLASH]
    want = (n, [0] * 3) if bf16 else ([0] * 3, n)
    check((tc, tc32) == want, f"{what}: forward, dq, dk/dv launched {tc} "
          f"times on the bf16 tensor-core kernels and {tc32} on the f32 "
          f"ones, want {want} ({'bf16' if bf16 else 'f32'})")


def _live_cuda_tensors(top: int = 8) -> list:
    """The largest CUDA tensors the interpreter still reaches: what holds
    memory that a phase should have freed."""
    found = {}
    for obj in gc.get_objects():
        if torch.is_tensor(obj) and obj.is_cuda:
            st = obj.untyped_storage()
            found[st.data_ptr()] = (st.nbytes(), tuple(obj.shape),
                                    str(obj.dtype))
    return sorted(found.values(), reverse=True)[:top]


def _expect_free_card(what: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 1e9, f"{what}: {held / 1e9:.2f} GB still allocated: "
          f"{_live_cuda_tensors()}")


def _instrument(run, capture: dict) -> tuple[list, list]:
    """CUDA events around each client gradient and each compress stage's
    apply of ``run``; returns the two event lists, cleared by the caller
    each round."""
    grad_events, comp_events = [], []
    run.pipeline = dataclasses.replace(run.pipeline, compress=tuple(
        TimedStage(st, comp_events, capture) for st in run.pipeline.compress))
    grad = run._grad

    def timed_grad(x, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g = grad(x, batch)
        end.record()
        grad_events.append((start, end))
        return g

    run._grad = timed_grad
    return grad_events, comp_events


def _run_config(dev, seed, cfg, toks, name, fields, path, totals,
                check_keys: bool = False) -> dict:
    """Two rounds of one configuration; adds its launches to ``totals``.
    Each wire kernel of ``path`` launches once a client (the threefry
    path's int8 round trip: once a 2**24 chunk a client), each flash
    kernel once a layer a client.  ``check_keys`` splits the round-2
    keys on the card and holds them to the host's the run stepped with."""
    _expect_free_card(f"before {name}")
    torch.cuda.reset_peak_memory_stats()
    fcfg = fl.FLConfig(method="eris", K=K_CLIENTS, A=A_AGGS, lr=LR,
                       seed=seed, **fields)
    params = _init_params(cfg, seed, dev)
    run = fl.FLRun(fcfg, params, lambda p, b: tr.loss_fn(
        p, cfg, {"tokens": b}), device=dev)
    del params
    n = run.n
    lo = (n // 2) // du.LANES * du.LANES
    capture = {"window": (lo, lo + REPLAY_N)}
    grad_events, comp_events = _instrument(run, capture)
    flash_per_round = _flash_want(
        cfg, cfg.n_layers * K_CLIENTS
        if tr.uses_flash_kernel(cfg, toks.shape[-1]) else 0)
    per_client = (math.ceil(n / random.CHUNK) if fields.get("use_dsc") and
                  fields.get("compress_impl", "jnp") == "jnp" else 1)
    rounds = []
    for t in range(2):
        capture["round"] = t
        grad_events.clear()
        comp_events.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _set_round_launches(0)                    # the main path starts
        t0 = time.monotonic()
        start.record()
        run.step(toks)
        end.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: fn.launches for k, fn in ROUND.items()}
        _check_tensor_cores(f"{name} round {t + 1}", flash_per_round,
                            cfg.dtype == "bfloat16")
        for k, count in launches.items():       # the main path ended
            totals[k] += count
            want = (flash_per_round[k] if k in FLASH else
                    K_CLIENTS * per_client if k in path else 0)
            check(count == want, f"{name} round {t + 1}: {k} launched "
                  f"{count} times, want {want}")
        losses = [float(x) for x in run.client_losses[-1]]
        check(len(losses) == K_CLIENTS and
              all(math.isfinite(x) for x in losses),
              f"{name} round {t + 1}: client losses {losses}")
        check(bool(run.x.isfinite().all()),
              f"{name} round {t + 1}: x is not finite")
        if run.state.dsc is not None:
            check(bool(run.state.dsc.s_agg.isfinite().all()),
                  f"{name} round {t + 1}: s_agg is not finite")
        weights = pipeline.participation_weights(
            run.keys.part, K_CLIENTS, fcfg.participation)
        participants = (K_CLIENTS if weights is None
                        else int(weights.count_nonzero()))
        total = start.elapsed_time(end)
        grad_ms = sum(a.elapsed_time(b) for a, b in grad_events)
        comp_ms = sum(a.elapsed_time(b) for a, b in comp_events)
        rounds.append(dict(round_ms=total, grad_ms=grad_ms,
                           compress_ms=comp_ms,
                           aggregate_server_ms=total - grad_ms - comp_ms,
                           wall_s=wall, client_losses=losses,
                           participants=participants, launches=launches,
                           allocated_gb=torch.cuda.memory_allocated() / 1e9,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        print(f"  {name} round {t + 1}: {total:.1f} ms = client "
              f"gradients {grad_ms:.1f} + compression {comp_ms:.1f} + "
              f"aggregation and server {total - grad_ms - comp_ms:.1f} "
              f"(wall {wall:.2f} s); {participants} of {K_CLIENTS} "
              f"clients aggregated; x {run.x.dtype}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; client "
              f"losses {[round(x, 4) for x in losses]}; device memory "
              f"{rounds[-1]['allocated_gb']:.2f} GB held, "
              f"{rounds[-1]['peak_gb']:.2f} GB peak", flush=True)
    _replay(run.pipeline.compress[0], run.keys, capture, n)
    if check_keys:
        _check_round_keys(dev, seed, run.keys, REPLAY_ROUND + 1)
        print(f"  round-{REPLAY_ROUND + 1} keys split on the card == the "
              f"host's")
    if name == FL_CONFIGS[0][0]:
        profile_round(run, toks, rounds[-1]["round_ms"])
    peak = torch.cuda.max_memory_allocated()
    print(f"  {name}: n = {n}, K = {K_CLIENTS}, A = {A_AGGS}, peak device "
          f"memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB)")
    return dict(rounds=rounds, peak_mem_gb=peak / 1e9, n=n)


def profile_round(run, toks, round_ms: float) -> None:
    """torch.profiler over one more round: device kernels by time, and
    the device's busy share of the unprofiled round time ``round_ms``."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        run.step(toks)
        torch.cuda.synchronize()
    _print_device_kernels(prof, "one more round", round_ms)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:6]:
        print(f"    host {e.self_cpu_time_total / 1e3:9.2f} ms "
              f"{e.count:6d}x  {e.key[:80]}")


def _print_device_kernels(prof, what: str, span_ms: float,
                          top: int = 12) -> float:
    """The profile's device kernels by time, and the device's busy share
    of the unprofiled span ``span_ms`` of the same work; returns the busy
    ms."""
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, count = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    print(f"  profile of {what}: "
          f"{sum(c for _, c in kernels.values())} device kernels, "
          f"{busy_ms:.1f} ms busy; of the unprofiled {span_ms:.1f} ms "
          f"the device is idle {100 * (1 - busy_ms / span_ms):.1f}%")
    for kname, (us, count) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][0])[:top]:
        print(f"    device {us / 1e3:9.2f} ms {count:6d}x  {kname[:80]}")
    return busy_ms


# (arch, configurations); flash on and off compare at the round's shape in
# phase 8, client gradient against client gradient in turns
FL_RUNS = (("eris-gptneo-1.3b", FL_CONFIGS),
           ("qwen2-0.5b", FL_CONFIGS[:1]))


def fl_round_phase(dev, seed) -> dict:
    """Two ERIS rounds of eris-gptneo-1.3b at full width in each of the
    three configurations, then two of qwen2-0.5b in the first, all with
    flash attention on.  Returns the kernels' launches over all eight
    rounds (the main path's count)."""
    totals = {name: 0 for name in ROUND}
    results = {}
    for arch, configs in FL_RUNS:
        cfg = fl_train.model_config(arch, full=True)
        check(cfg.flash_attention, f"{arch}: flash attention is off")
        toks = fl_train.client_tokens(seed, K_CLIENTS, BATCH, SEQ,
                                      cfg.vocab, dev)
        for name, fields, path in configs:
            label = name if arch == "eris-gptneo-1.3b" else f"{arch} {name}"
            results[label] = _run_config(dev, seed, cfg, toks, label, fields,
                                         path, totals)
    _expect_free_card("after the rounds")
    print("fl_round " + json.dumps(results))
    return totals


# ---------------------------------------------------------------- phase 8
CONTEXT = 2048       # max_position_embeddings of EleutherAI/gpt-neo-1.3B
# flash vs the plain chunked attention over 24 layers of random bf16
# weights: the plain path rounds its softmax weights to bf16 before the
# PV product and the kernels keep them in f32, in every layer both ways
CONTEXT_GRAD_REL_TOL = 5e-2
# the remat policies, in ModelConfig.remat_policy's names; the first is
# the gradient the others are held to
REMAT_POLICIES = ("none", "full", "dots", "dots_batch", "offload_dots")


def _client_grad(cfg, params, toks, resident: list | None = None):
    """One client's gradient (bf16 leaves), its loss, its device ms and
    the peak memory it added above what was held before it.  The cache
    allocator keeps its blocks, as between a round's clients.  ``toks``
    is the tokens, or a whole batch dict (vlm's carries its image).
    ``resident`` gets the bytes the forward left allocated for the
    backward."""
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loss = tr.loss_fn(tree_unflatten(params, leaves), cfg, _batch_of(toks))
    if resident is not None:
        resident.append(torch.cuda.memory_allocated() - held)
    grads = torch.autograd.grad(loss, leaves)
    end.record()
    torch.cuda.synchronize()
    return (grads, float(loss.detach()), start.elapsed_time(end),
            (torch.cuda.max_memory_allocated() - held) / 1e9)


def _batch_of(toks) -> dict:
    return toks if isinstance(toks, dict) else {"tokens": toks}


def _profiled_grad(cfg, params, toks):
    """torch.profiler over one client gradient."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        loss = tr.loss_fn(tree_unflatten(params, leaves), cfg,
                          _batch_of(toks))
        torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return prof


def _host_syncs(cfg, params, toks) -> dict:
    """Host-side waits in one client gradient, by torch.profiler."""
    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaMemcpyAsync", "cudaLaunchKernel")
    return {e.key: e.count for e in
            _profiled_grad(cfg, params, toks).key_averages()
            if e.key in names}


def context_phase(dev, seed) -> None:
    """One eris-gptneo-1.3b client gradient on 1 x 2048 tokens through the
    flash kernels and through the plain chunked attention."""
    on = fl_train.model_config("eris-gptneo-1.3b", full=True)
    off = dataclasses.replace(on, flash_attention=False)
    check(tr.uses_flash_kernel(on, CONTEXT), "S = 2048 does not take flash")
    params = _init_params(on, seed, dev)
    toks = lm_token_batches(random.fold_in(random.PRNGKey(seed), 3), 1, 1,
                            CONTEXT, on.vocab, device=dev)[0]
    short = toks[:, :128]
    for cfg in (on, off):                      # cuBLAS handles, the library
        _client_grad(cfg, params, short)
    round_toks = fl_train.client_tokens(seed, 1, BATCH, SEQ, on.vocab,
                                        dev)[0]
    for cfg in (off, on):
        syncs = _host_syncs(cfg, params, round_toks)
        print(f"  one client gradient at {BATCH} x {SEQ} tokens, flash "
              f"{cfg.flash_attention}: host calls {json.dumps(syncs)}")
    # the round's client gradient both ways, in turns, each side first in
    # half the pairs
    ms = {False: [], True: []}
    for i in range(6):
        for cfg in ((off, on) if i % 2 == 0 else (on, off)):
            ms[cfg.flash_attention].append(
                _client_grad(cfg, params, round_toks)[2])
    print(f"  one client gradient at {BATCH} x {SEQ} tokens, device-event "
          f"ms in turns: flash off {[round(x, 1) for x in ms[False]]}, "
          f"flash on {[round(x, 1) for x in ms[True]]}")
    _set_round_launches(0)
    g_on, loss_on, ms_on, peak_on = _client_grad(on, params, toks)
    check(on.dtype == "bfloat16", f"the context gradient runs {on.dtype}")
    _check_tensor_cores(f"S = {CONTEXT} flash gradient",
                        _flash_want(on, on.n_layers), True)
    g_off, loss_off, ms_off, peak_off = _client_grad(off, params, toks)
    diff = sum(float((a.float() - b.float()).square().sum())
               for a, b in zip(g_on, g_off))
    ref = sum(float(b.float().square().sum()) for b in g_off)
    rel = math.sqrt(diff / ref)
    finite = all(bool(g.isfinite().all()) for g in g_on)
    del g_on, g_off
    check(finite and math.isfinite(loss_on), "flash gradient not finite")
    _print_device_kernels(_profiled_grad(on, params, toks),
                          f"one more flash gradient at 1 x {CONTEXT} tokens",
                          ms_on, top=8)
    print("context " + json.dumps(dict(
        tokens=CONTEXT, flash_ms=ms_on, plain_ms=ms_off,
        flash_peak_gb=peak_on, plain_peak_gb=peak_off, loss_flash=loss_on,
        loss_plain=loss_off, grad_rel=rel)))
    print(f"  1 x {CONTEXT} tokens: flash {ms_on:.1f} ms, {peak_on:.2f} GB "
          f"above the params; plain chunked {ms_off:.1f} ms, {peak_off:.2f} "
          f"GB; losses {loss_on:.5f} / {loss_off:.5f}; gradient relative "
          f"difference {rel:.3e} (tol {CONTEXT_GRAD_REL_TOL:g})")
    check(rel <= CONTEXT_GRAD_REL_TOL,
          f"S = {CONTEXT} gradient, flash vs plain: relative difference "
          f"{rel:.3e}")
    remat_policies(on, params, toks, short)
    del params
    _expect_free_card("after the context gradient")


def remat_policies(on, params, toks, short) -> None:
    """One flash gradient at 1 x CONTEXT under each remat policy: device
    ms, the peak it adds above the params, the flash launches (the
    forward kernel again per layer under every policy but ``none``), and
    its gradient against ``none``'s.  Every kernel on the path is
    deterministic (the flash forward, dq and dk/dv write each output tile
    from one block, no atomics; cuBLAS' products on one stream), so each
    gradient must equal ``none``'s bit for bit.  The peaks fall in the
    order none > dots_batch >= dots > full.  What the forward leaves on
    the card for the backward under offload_dots is under dots' by at
    least what it sent to the host, and its peak is not above dots'."""
    cfgs = {p: dataclasses.replace(on, remat_policy=p)
            for p in REMAT_POLICIES}
    for cfg in cfgs.values():   # each policy's first use: the host's
        _client_grad(cfg, params, toks)   # pinned blocks, cuBLAS' plans
    res, want = {}, None
    for p, cfg in cfgs.items():
        _set_round_launches(0)
        resident = []
        grads, loss, ms, peak = _client_grad(cfg, params, toks, resident)
        launches = {k: fn.launches for k, fn in FLASH.items()}
        flash = _flash_want(cfg, cfg.n_layers)
        check(launches == flash, f"remat {p}: flash launches {launches}, "
              f"want {flash}")
        _check_tensor_cores(f"remat {p}", flash, True)
        if want is None:
            want = grads
        equal = all(torch.equal(a, b) for a, b in zip(grads, want))
        worst = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(grads, want))
        del grads
        res[p] = dict(ms=ms, peak_gb=peak, resident_bytes=resident[0],
                      loss=loss, flash_fwd=launches["flash_fwd"],
                      equal=equal, max_abs_diff=worst)
    del want
    with Account(device=toks.device) as acc:
        _client_grad(cfgs["offload_dots"], params, toks)
    host = int(acc.offload_bytes)
    res["offload_dots"]["host_bytes"] = host
    print("remat " + json.dumps(res))
    for p, r in res.items():
        print(f"  remat {p}: {r['ms']:.1f} ms, {r['peak_gb']:.3f} GB above "
              f"the params at the peak, {r['resident_bytes'] / 1e9:.3f} GB "
              f"after the forward, flash_fwd {r['flash_fwd']}, loss "
              f"{r['loss']:.5f}, gradient == none's {r['equal']} (max abs "
              f"diff {r['max_abs_diff']:.3e})")
    print(f"  offload_dots sent {host} B to pinned host memory")
    for p, r in res.items():
        check(r["equal"], f"remat {p}: gradient differs from none's (max "
              f"abs diff {r['max_abs_diff']:.3e})")
    pk = {p: r["peak_gb"] for p, r in res.items()}
    check(pk["none"] > pk["dots_batch"] >= pk["dots"] > pk["full"],
          f"remat peaks out of order: {pk}")
    kept = {p: r["resident_bytes"] for p, r in res.items()}
    check(host > 0 and kept["dots"] - kept["offload_dots"] >= host and
          pk["offload_dots"] <= pk["dots"],
          f"offload_dots: {kept['offload_dots']} B left on the card after "
          f"the forward against dots' {kept['dots']} B, {host} B sent to "
          f"the host; peaks {pk['offload_dots']:.3f} and {pk['dots']:.3f} "
          f"GB")


# ---------------------------------------------------------------- phase 9
def fl_small_input_phase(dev, seed) -> None:
    """The fused configuration on the smoke variant in f32, flash on, on
    the card (through the kernels) and on the host (through the plain
    versions) with the same seeds."""
    cfg = fl_train.model_config("eris-gptneo-1.3b", full=False)
    check(tr.uses_flash_kernel(cfg, SEQ), "the smoke round does not take "
          "the flash kernels")
    fcfg = fl.FLConfig(method="eris", K=K_CLIENTS, A=A_AGGS, lr=LR,
                       seed=seed, **FL_CONFIGS[0][1])
    toks = fl_train.client_tokens(seed, K_CLIENTS, BATCH, SEQ, cfg.vocab)

    def loss(p, b):
        return tr.loss_fn(p, cfg, {"tokens": b})

    host = fl.FLRun(fcfg, tr.init_params(cfg, seed=seed, device="cpu"), loss,
                    device="cpu")
    card = fl.FLRun(fcfg, tr.init_params(cfg, seed=seed, device="cpu"), loss,
                    device=dev)
    _set_round_launches(0)
    for _ in range(2):
        host.step(toks)
        card.step(toks.to(dev))
    launched = {k: fn.launches for k, fn in FLASH.items()}
    want = _flash_want(cfg, 2 * K_CLIENTS * cfg.n_layers)
    check(launched == want, f"smoke rounds: flash kernels launched "
          f"{launched} times, want {want}")
    _check_tensor_cores("smoke rounds in f32", want, False)
    # one host-made gradient through the kernel and the plain version
    g = host._grad(host.x, toks[0])
    s = host.state.dsc.s_clients[0]
    seeds = [_seed_of(k) for k in random.split(host.keys.comp)]
    kw = dict(p=0.25, gamma=0.5, index_base=3 * qz.padded(g.numel()))
    on_card = dq.dsc_quantize(g.to(dev), s.to(dev), *seeds, **kw)
    on_host = dq.dsc_quantize(g, s, *seeds, **kw)
    for what, a, b in zip(("codes", "scales", "s'"), on_card, on_host):
        _same(f"smoke gradient {what}, card vs host", a.cpu(), b)
    rel = float((card.x.cpu() - host.x).norm() / host.x.norm())
    check(rel <= 1e-4, f"smoke fused round: x card vs host relative error "
          f"{rel:.3e} after 2 rounds")
    print(f"  eris-gptneo-1.3b smoke f32, fused config, flash on, 2 rounds: "
          f"x card vs host relative error {rel:.3e} (tol 1e-4); flash "
          f"kernels {launched} launches; a host gradient compressed on the "
          f"card == on the host (codes, scales, s')")


# --------------------------------------------------------------- phase 10
# jax 0.9.0's draws (jax.random on the CPU, both values of
# jax_threefry_partitionable): the card's machine has no jax
JAX_0_9_0 = {
    True: {"bits": [4070199207, 4202968722, 1427181096, 2012915765],
           "split": [[1832780943, 270669613], [64467757, 2916123636]],
           "permutation": [0, 1, 8, 5, 6, 4, 3, 2, 7, 9],
           "uniform_bits": [1054905456, 1057530888, 1055149928],
           "last_of_full_width_draw": 881270661},
    False: {"bits": [4146024105, 967050713, 2718843009, 1272950319],
            "split": [[2465931498, 3679230171], [255383827, 267815257]],
            "permutation": [2, 7, 9, 6, 0, 8, 1, 3, 4, 5],
            "uniform_bits": [1058114728, 1048864696, 1063496476],
            "last_of_full_width_draw": 3636358454},
}
JAX_FOLD_IN_0_1 = [928981903, 3453687069]    # fold_in(PRNGKey(0), 1)
# gumbel, card vs host: both logs within an ulp of the true value, so
# within the bound the CPU tests hold the host to against jax
GUMBEL_ULPS = 8
STREAM_N = 1_000_003


def _same_keys(what, card, host) -> None:
    _same(what, card.cpu(), host)


def stream_phase(dev) -> None:
    """The threefry stream on the card against the host, under both
    counter layouts: integer draws bit for bit, Gumbel noise within its
    ulp bound, jax 0.9.0's values where they are known, and the last
    2**24 elements of a full-width (n = 1,816,565,760) bernoulli drawn
    in 2**24-element chunks."""
    for layout in (True, False):
        random.partitionable = layout
        name = "partitionable" if layout else "original"
        want = JAX_0_9_0[layout]
        host, card = random.PRNGKey(0), random.PRNGKey(0).to(dev)
        for k in (host, card):
            check(random.bits(k, (4,), device=k.device).tolist()
                  == want["bits"], f"{name}: bits(PRNGKey(0)) is not jax's")
            check(random.split(random.PRNGKey(42).to(k.device)).tolist()
                  == want["split"], f"{name}: split(PRNGKey(42)) is not jax's")
            check(random.permutation(k, 10).tolist() == want["permutation"],
                  f"{name}: permutation(PRNGKey(0), 10) is not jax's")
            u = random.uniform(random.PRNGKey(1).to(k.device), (3,))
            check((u.view(torch.int32).long() & 0xFFFFFFFF).tolist()
                  == want["uniform_bits"], f"{name}: uniform is not jax's")
            check(random.fold_in(k, 1).tolist() == JAX_FOLD_IN_0_1,
                  f"{name}: fold_in(PRNGKey(0), 1) is not jax's")
            big = random.fold_in(random.PRNGKey(7).to(k.device), 3)
            check(int(random.bits(big, (FULL_N,), window=(FULL_N - 1,
                                                           FULL_N))[0])
                  == want["last_of_full_width_draw"],
                  f"{name}: the full-width draw's last element is not jax's")
        key, ckey = random.PRNGKey(5), random.PRNGKey(5).to(dev)
        _same_keys(f"{name} split", random.split(ckey, 7),
                   random.split(key, 7))
        _same_keys(f"{name} fold_in", random.fold_in(ckey, 2**31 + 3),
                   random.fold_in(key, 2**31 + 3))
        _same(f"{name} bits", random.bits(key, (STREAM_N,), device=dev).cpu(),
              random.bits(key, (STREAM_N,)))
        _same(f"{name} uniform",
              random.uniform(key, (STREAM_N,), device=dev).cpu(),
              random.uniform(key, (STREAM_N,)))
        _same(f"{name} bernoulli",
              random.bernoulli(key, 0.3, (STREAM_N,), device=dev).cpu(),
              random.bernoulli(key, 0.3, (STREAM_N,)))
        _same(f"{name} randint",
              random.randint(key, (STREAM_N,), -5, 100003, device=dev).cpu(),
              random.randint(key, (STREAM_N,), -5, 100003))
        _same(f"{name} permutation", random.permutation(ckey, STREAM_N).cpu(),
              random.permutation(key, STREAM_N))
        g = random.gumbel(key, (STREAM_N,), device=dev).cpu()
        hg = random.gumbel(key, (STREAM_N,))
        ulp = torch.from_numpy(np.spacing(
            hg.abs().clamp_min(1.0).numpy()))
        worst = float(((g - hg).abs() / ulp).max())
        check(worst <= GUMBEL_ULPS, f"{name} gumbel: card vs host "
              f"{worst:.1f} ulps of max(|g|, 1), bound {GUMBEL_ULPS}")
        window = (FULL_N - (1 << 24), FULL_N)
        big = random.fold_in(random.PRNGKey(7), 3)
        t0 = time.monotonic()
        on_card = random.bernoulli(big, 0.25, (FULL_N,), device=dev,
                                   window=window)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        on_host = random.bernoulli(big, 0.25, (FULL_N,), device="cpu",
                                   window=window)
        t2 = time.monotonic()
        _same(f"{name} full-width bernoulli window", on_card.cpu(), on_host)
        print(f"  {name}: jax 0.9.0's values and card == host for bits, "
              f"split, fold_in, uniform, bernoulli, randint, permutation; "
              f"gumbel within {worst:.1f} ulps; bernoulli on "
              f"[{window[0]}, {window[1]}) of n = {FULL_N}: card == host "
              f"({(t1 - t0) * 1e3:.1f} ms on the card, "
              f"{(t2 - t1) * 1e3:.0f} ms on the host)")
    random.partitionable = True


def _check_round_keys(dev, seed, keys, rounds: int) -> None:
    """The round keys of round ``rounds``, split on the card from
    PRNGKey(seed), equal the host's that the run stepped with."""
    key = random.PRNGKey(seed).to(dev)
    for _ in range(rounds):
        key, sub = random.split(key)
    on_card = split_round_keys(sub)
    for field in keys._fields:
        _same_keys(f"round key {field}", getattr(on_card, field),
                   getattr(keys, field))


def _draw_ms(dev, n: int) -> float:
    """Device ms of one client's RandP mask at n coordinates: the
    chunked bernoulli alone, each chunk consumed (summed) as drawn."""
    key = random.PRNGKey(1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    kept = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    start.record()
    for lo in range(0, n, random.CHUNK):
        kept += random.bernoulli(key, 0.25, (n,), device=dev,
                                 window=(lo, min(n, lo + random.CHUNK))
                                 ).sum()
    end.record()
    end.synchronize()
    check(abs(int(kept) / n - 0.25) < 1e-3, f"mask keeps {int(kept) / n}")
    return start.elapsed_time(end)


# the reference example's round (examples/fl_train_lm.py: FLConfig with
# use_dsc and RandP(p=0.25), compress_impl left at "jnp"), then the same
# with client sampling and the int8 wire (Int8RoundTrip(RandP) under jnp,
# its round trip on the quantize kernels, one launch a 2**24 chunk)
DEFAULT_CONFIGS = (
    ("dsc-jnp", dict(use_dsc=True, compressor=RandP(p=0.25)), ()),
    ("dsc-jnp-int8-participation",
     dict(use_dsc=True, compressor=RandP(p=0.25), int8_wire=True,
          participation=0.5), ("quantize", "dequantize")),
)


def default_round_phase(dev, seed) -> dict:
    """Two full-width rounds of eris-gptneo-1.3b in each DEFAULT_CONFIG:
    the split and peak as phase 7 prints them, client 3's round-2
    compression replayed on the card and the host, the round-2 keys split
    on the card == the host's; then the mask draw's ms a client.  Returns
    the kernels' launches over the four rounds."""
    totals = {name: 0 for name in ROUND}
    cfg = fl_train.model_config("eris-gptneo-1.3b", full=True)
    toks = fl_train.client_tokens(seed, K_CLIENTS, BATCH, SEQ, cfg.vocab,
                                  dev)
    results = {}
    for name, fields, path in DEFAULT_CONFIGS:
        results[name] = _run_config(dev, seed, cfg, toks, name, fields, path,
                                    totals, check_keys=True)
        peak = results[name]["peak_mem_gb"]
        check(peak < 80, f"{name}: peak {peak:.2f} GB does not fit the card")
    _expect_free_card("after the default rounds")
    n = results[DEFAULT_CONFIGS[0][0]]["n"]
    draw = [_draw_ms(dev, n) for _ in range(3)]
    results["mask_draw_ms_a_client"] = draw
    print(f"  RandP mask draw (random.bernoulli, 2**24-element chunks) at "
          f"n = {n}: {', '.join(f'{ms:.1f}' for ms in draw)} ms a client")
    print("default_round " + json.dumps(results))
    return totals


# (name, FLConfig fields, integer-keyed): the dense compressors and the
# keyed aggregation at the smoke size (k = n / 10 of its 1,443,072
# parameters), card vs host
KEYED_CONFIGS = (
    ("ef-topk", dict(use_ef=True, compressor=TopK(k=144_307)), True),
    ("dsc-rand_k", dict(use_dsc=True, compressor=RandK(k=144_307)), False),
    ("dsc-qsgd", dict(use_dsc=True, compressor=QSGD(s=16)), True),
    ("fresh-masks-random", dict(fresh_masks=True, mask_scheme="random"),
     True),
)


def keyed_small_input_phase(dev, seed) -> None:
    """eris-gptneo-1.3b's smoke variant in f32, K = 2: two rounds on the
    card and on the host in each KEYED_CONFIG, x within 1e-4 relative
    norm; one host-made gradient through the stage on both with the same
    state and keys: v and the state bit for bit where the draws are
    integer-keyed (RandK ranks Gumbel scores, a few ulps apart)."""
    cfg = fl_train.model_config("eris-gptneo-1.3b", full=False)
    toks = fl_train.client_tokens(seed, 2, BATCH, SEQ, cfg.vocab)

    def loss(p, b):
        return tr.loss_fn(p, cfg, {"tokens": b})

    for name, fields, exact in KEYED_CONFIGS:
        fcfg = fl.FLConfig(method="eris", K=2, A=A_AGGS, lr=LR, seed=seed,
                           **fields)
        host = fl.FLRun(fcfg, tr.init_params(cfg, seed=seed, device="cpu"),
                        loss, device="cpu")
        card = fl.FLRun(fcfg, tr.init_params(cfg, seed=seed, device="cpu"),
                        loss, device=dev)
        for _ in range(2):
            host.step(toks)
            card.step(toks.to(dev))
        rel = float((card.x.cpu() - host.x).norm() / host.x.norm())
        check(rel <= 1e-4, f"{name}: x card vs host relative error "
              f"{rel:.3e} after 2 rounds")
        g = host._grad(host.x, toks[0])
        if fields.get("fresh_masks"):
            stage = host.pipeline.aggregate
            a = stage.assignment(host.keys, g.numel(), dev)
            b = stage.assignment(host.keys, g.numel(), "cpu")
            _same(f"{name} assignment, card vs host", a.cpu(), b)
            what = "the random assignment"
        else:
            stage = host.pipeline.compress[0]
            states = [host.state._replace(
                dsc=None if host.state.dsc is None else
                type(host.state.dsc)(*(t.to(d).clone()
                                       for t in host.state.dsc)),
                ef=None if host.state.ef is None else
                type(host.state.ef)(*(t.to(d).clone()
                                      for t in host.state.ef)))
                for d in (dev, "cpu")]
            v = [stage.apply(host.keys, st, g.to(d), 0)
                 for st, d in zip(states, (dev, "cpu"))]
            if exact:
                _same(f"{name} v, card vs host", v[0].cpu(), v[1])
                for a, b in zip(states[0].dsc or states[0].ef,
                                states[1].dsc or states[1].ef):
                    _same(f"{name} state, card vs host", a.cpu(), b)
                what = "v and the state bit for bit"
            else:
                agree = float((v[0].cpu() == v[1]).float().mean())
                what = f"v equal in {100 * agree:.4f}% of coordinates"
        print(f"  {name}: x card vs host {rel:.3e} after 2 rounds (tol "
              f"1e-4); a host gradient through the stage: {what}")


# --------------------------------------------------------------- phase 11
# The distributed FSA step (launch/train.py) as the reference's CLI runs
# it (python -m repro.launch.train): adam lr 1e-2, 8 x 64 tokens from
# lm_token_batches(PRNGKey(0)), keys PRNGKey(i), grad_dtype float32; (e)
# keeps TrainSettings' default bf16 wire.  One rank over NCCL: every leaf
# is this aggregator's whole (n_client = 1).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 3, 8, 64, 1e-2
TRAIN_CONFIGS = (
    # (name, TrainSettings fields, wire kernels launched once a sharded
    # leaf a step)
    ("a fsa f32 wire", dict(grad_dtype="float32"), ()),
    ("b dsc int8 fused", dict(grad_dtype="float32", use_dsc=True,
                              int8_wire=True), ("dsc_quantize", "dequantize")),
    ("c int8", dict(grad_dtype="float32", int8_wire=True),
     ("quantize", "dequantize")),
    ("d dsc jnp", dict(grad_dtype="float32", use_dsc=True), ()),
    ("e fsa bf16 wire", dict(), ()),
)
# At the CLI's lr 1e-2 adam's first step moves every weight by ~1e-2,
# half the std of eris-gptneo-1.3b's init (fan_in**-0.5 = 0.022 at
# d_model 2048), and the full-width loss rises (11.373 -> 18.943 in (a);
# NVIDIA H100 80GB HBM3, 700.00 W).  At the smoke width the same lr is a
# smaller share of the init std and the reference's first step lowers
# the loss (FSA f32: 6.793, 4.989, 6.926; jax 0.9.0 on the CPU), so the
# smoke size says nothing of the full width.  Two witnesses instead, at
# full width and TRAIN_CUT_LAYERS of the 24 layers (at all 24 the host's
# step alone took 83 s): the host's plain path (gloo, no kernels, the
# CPU's bf16) takes step 1 of (a) from the card's params and must land on
# the card's step-1 loss and grad_norm and on the card's step-2 loss
# (TRAIN_WITNESS_TOL, chosen before the first run: bf16 sums in other
# orders, and adam's sign-like step flips coordinates whose gradients are
# near zero); and every configuration runs again at lr 1e-5, where the
# loss must fall at every step on the repeated batch; (d) takes two steps
# there (one fall) and the others three.
TRAIN_FALL_LR = 1e-5
TRAIN_FALL_CONFIGS = tuple(name for name, _, _ in TRAIN_CONFIGS)
TRAIN_FALL_STEPS = {"d dsc jnp": 2}
TRAIN_WITNESS_TOL = 5e-2
TRAIN_CUT_LAYERS = 2
# The scenario and async knobs (the rounds.scenarios cells on the mesh
# wire) at full width, bf16 params from --seed, three steps of sgd at
# phase 12's lr: sgd keeps the params bf16 and leaves a segment that
# receives a zero update as it was, bit for bit (adam's moments and DSC's
# Eq. 4 move it all the same).  (name, TrainSettings fields, wire kernels
# launched once a sharded leaf a step).  The one-rank draws at PRNGKey(0..2)
# (jax 0.9.0 on the CPU, and the port's): the aggregator lives at every
# step and its one link dies at step 2, so (f)'s params and (h)'s s_agg
# hold still there; the client drops at step 1 and arrives at 2 and 3, so
# (g) holds at steps 1 and 3 (cadence 2) and moves at 2; (i)'s mask row
# at n_client = 1 is exactly zero.
TRAIN_KNOB_LR = 0.1
TRAIN_KNOB_CONFIGS = (
    ("f ldp_int8+agg_fail", dict(grad_dtype="float32", int8_wire=True,
                                 ldp_eps=8.0, ldp_delta=1e-5, ldp_clip=1.0,
                                 agg_dropout=0.25, link_failure=0.1),
     ("quantize", "dequantize")),
    ("g async int8", dict(grad_dtype="float32", int8_wire=True,
                          async_buffer=True, buffer_cadence=2,
                          client_dropout=0.25, delay_max=2),
     ("quantize", "dequantize")),
    ("h dsc_int8+agg_fail", dict(grad_dtype="float32", use_dsc=True,
                                 dsc_p=0.5, int8_wire=True,
                                 agg_dropout=0.25, link_failure=0.1),
     ("dsc_quantize", "dequantize")),
    ("i secure_agg+none", dict(grad_dtype="float32", secure_mask=True), ()),
)
# the n_client = 4 pieces one rank cannot run, on the card: every rank's
# mask row of blocks/w_up (402,653,184 elements) and rank 3's LDP noise;
# card vs host on the leaf's last 2**24 elements (normal within
# MESH_NORMAL_ULPS: both sides' log and erfinv within an ulp or two)
MESH_CLIENTS, MESH_LEAF, MESH_NORMAL_ULPS = 4, ("blocks", "w_up"), 8
# the smoke steps, card (NCCL, kernels) vs host (gloo, plain versions),
# with sgd (phase 9's precedent: the gradients differ in their last bits,
# and an int8 code flips where a draw falls within an ulp of its
# fraction).  Adam's first step is ~ lr sign(g): a gradient within that
# noise of zero flips a whole 2 lr step, so adam's trajectories are held
# apart from the gradients, by one update card == host bit for bit.
TRAIN_SMOKE_LR, TRAIN_SMOKE_TOL = 0.05, 1e-4


def _knob_plan(settings, steps: int) -> list:
    """What each step of a knob configuration must do at one rank, from
    the step's own draws: "held" (params as they were, bit for bit: sgd
    with a zero update, a dead link or aggregator without DSC, or a round
    the cadence does not apply, where grad_norm is 0 too), "moved", or
    "s_agg held" (DSC: Eq. 4 keeps s_agg where nothing arrives)."""
    from repro_torch.launch import train
    plan = []
    arrival = settings.arrival_model()
    cadence = settings.async_settings().buffer_cadence
    for i in range(steps):
        key, what, note = random.PRNGKey(i), "moved", ""
        if settings.agg_dropout > 0 or settings.link_failure > 0:
            agg, link, cnt = train.failure_draws(
                key, 1, settings.agg_dropout, settings.link_failure)
            note = f"aggregator alive {int(agg[0])}, link {int(link[0, 0])}"
            if float(link[0, 0] * agg[0]) == 0.0:
                what = "s_agg held" if settings.use_dsc else "held"
        if settings.async_buffer:
            _, alive, omega, _ = train.arrival_draws(key, 1, arrival)
            note = f"client arrives {bool(alive[0])}, omega {float(omega[0])}"
            if (i + 1) % cadence:
                what = "held"
        if settings.secure_mask:
            row = train.mask_row(key, 0, 0, 1, random.CHUNK)
            check(not bool(row.any()), "a mask row at n_client 1 is not 0")
            note = "mask row at n_client 1 exactly zero"
        plan.append((what, note))
    return plan


def _train_config(dev, seed, cfg, mesh, toks, name, fields, path,
                  totals, lr=TRAIN_LR, witness=False,
                  optimizer="adam", n_steps=TRAIN_STEPS) -> dict:
    """``n_steps`` steps of one configuration at full width and ``cfg``'s
    depth; adds its launches to ``totals``.  At ``TRAIN_FALL_LR`` the loss
    must fall at every step.  With ``witness``, step 1 again on the host
    (:func:`_train_witness`).  With sgd (the knob configurations) each
    step holds or moves as :func:`_knob_plan` says."""
    from repro_torch.launch import train
    from repro_torch.optim import adam, sgd
    _expect_free_card(f"before {name}")
    torch.cuda.reset_peak_memory_stats()
    settings = train.TrainSettings(**fields)
    opt = {"adam": adam, "sgd": sgd}[optimizer](lr)
    events = {}

    def mark(part):
        events[part] = torch.cuda.Event(enable_timing=True)
        events[part].record()

    step = train.make_train_step(cfg, mesh, opt, settings, device=dev,
                                 mark=mark)
    params = train.store_params(_init_params(cfg, seed, dev), cfg, mesh,
                                settings)
    params0 = tree_map(lambda t: t.cpu(), params) if witness else None
    state = opt.init(params)
    dsc_ref = train.init_dsc_state(cfg, mesh, settings, device=dev)
    n_leaves = len(tree_leaves(params))
    flash = _flash_want(cfg, cfg.n_layers
                        if tr.uses_flash_kernel(cfg, TRAIN_SEQ) else 0)
    plan = (_knob_plan(settings, n_steps) if optimizer == "sgd"
            else [("", "")] * n_steps)
    steps = []
    for i in range(n_steps):
        bf16 = {t.dtype for t in tree_leaves(params)} == {torch.bfloat16}
        what = plan[i][0]
        before = ([t.clone() for t in tree_leaves(params)]
                  if what in ("held", "moved") else None)
        s_agg = ([t.clone() for t in tree_leaves(dsc_ref["s_agg"])]
                 if what == "s_agg held" else None)
        _set_round_launches(0)                    # the main path starts
        t0 = time.monotonic()
        params, state, dsc_ref, m = step(params, state, dsc_ref,
                                         {"tokens": toks}, random.PRNGKey(i))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: fn.launches for k, fn in ROUND.items()}
        tc = ([fn.tensor_core_launches for fn in TENSOR_CORE],
              [fn.f32_tensor_core_launches for fn in TENSOR_CORE])
        for k, count in launches.items():         # the main path ended
            totals[k] += count
            want = (flash[k] if k in FLASH else n_leaves if k in path
                    else 0)
            check(count == want, f"{name} step {i + 1}: {k} launched "
                  f"{count} times, want {want}")
        _check_tensor_cores(f"{name} step {i + 1}", flash, bf16)
        for name_ in FLASH:                       # this step's f32 launches
            totals[f"{name_} f32"] += 0 if bf16 else launches[name_]
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"{name} step {i + 1}: loss {loss}, grad_norm {gnorm}")
        dtypes = sorted({str(t.dtype) for t in tree_leaves(params)})
        want_dtypes = ["torch.float32" if optimizer == "adam"
                       else f"torch.{cfg.dtype}"]
        check(dtypes == want_dtypes, f"{name} step {i + 1}: params "
              f"{dtypes} after an {optimizer} step, want {want_dtypes} "
              f"(the reference's promotion)")
        if what == "held":
            for a, b in zip(tree_leaves(params), before):
                _same(f"{name} step {i + 1}: params held", a, b)
            check(gnorm == 0.0, f"{name} step {i + 1}: a held round's "
                  f"grad_norm {gnorm}, want 0 (a zero update)")
        elif what == "moved":
            check(any(not torch.equal(a, b) for a, b in
                      zip(tree_leaves(params), before)),
                  f"{name} step {i + 1}: params did not move")
        elif what == "s_agg held":
            for a, b in zip(tree_leaves(dsc_ref["s_agg"]), s_agg):
                _same(f"{name} step {i + 1}: s_agg held", a, b)
        del before, s_agg
        order = list(events)
        split = {part: events[part].elapsed_time(events[nxt])
                 for part, nxt in zip(order, order[1:])}
        total = events["gather"].elapsed_time(events["end"])
        steps.append(dict(step_ms=total, **{f"{k}_ms": v for k, v in
                                             split.items()},
                          loss=loss, grad_norm=gnorm, wall_s=wall,
                          launches={k: v for k, v in launches.items() if v},
                          allocated_gb=torch.cuda.memory_allocated() / 1e9,
                          gate=" ".join(plan[i]).strip()))
        print(f"  {name} step {i + 1}: {total:.1f} ms = "
              + " + ".join(f"{k} {v:.1f}" for k, v in split.items())
              + f" (wall {wall:.2f} s); loss {loss:.4f}, grad_norm "
              f"{gnorm:.4f}; launches {steps[-1]['launches']}; tensor "
              f"cores bf16 {tc[0]}, f32 {tc[1]}; device "
              f"memory "
              f"{steps[-1]['allocated_gb']:.2f} "
              f"GB held" + (f"; {' '.join(plan[i])}: checked"
                            if plan[i][0] else ""), flush=True)
    losses = [s["loss"] for s in steps]           # loss i before update i
    falls = all(b < a for a, b in zip(losses, losses[1:]))
    check(falls or lr != TRAIN_FALL_LR, f"{name} at lr {lr}: the loss did "
          f"not fall at every step on the repeated batch: {losses}")
    peak = torch.cuda.max_memory_allocated()
    check(peak < 80e9, f"{name}: peak {peak / 1e9:.2f} GB does not fit "
          f"the card")
    if witness:
        _train_witness(cfg, mesh, toks, fields, lr, params0, steps)
        del params0
    moments = (f"; mu/nu {sorted({str(t.dtype) for t in tree_leaves(state.mu)})}"
               if optimizer == "adam" else "")
    print(f"  {name}, {optimizer} lr {lr}: losses {losses} (falls at every "
          f"step: {falls}); peak device memory "
          f"{peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB){moments}")
    del params, state, dsc_ref, step
    return dict(lr=lr, optimizer=optimizer, steps=steps, peak_gb=peak / 1e9)


def _train_witness(cfg, mesh, toks, fields, lr, params0, card) -> None:
    """Step 1 of a full-width configuration at ``cfg``'s depth on the
    host's plain path (gloo, the kernels' plain versions, the CPU's bf16)
    from the card's params and tokens, then the loss at the updated params: each within
    TRAIN_WITNESS_TOL of the card's step-1 loss and grad_norm and of its
    step-2 loss, which is the loss after update 1."""
    from repro_torch.launch import train
    from repro_torch.optim import adam
    t0 = time.monotonic()
    cpu = torch.device("cpu")
    settings = train.TrainSettings(**fields)
    opt = adam(lr)
    step = train.make_train_step(cfg, mesh, opt, settings, device=cpu)
    batch = {"tokens": toks.cpu()}
    params, _, _, m = step(params0, opt.init(params0),
                           train.init_dsc_state(cfg, mesh, settings,
                                                device=cpu),
                           batch, random.PRNGKey(0))
    with torch.no_grad():
        after = float(tr.loss_fn(params, cfg, batch))
    del params
    host = (float(m["loss"]), float(m["grad_norm"]), after)
    want = (card[0]["loss"], card[0]["grad_norm"], card[1]["loss"])
    rel = [abs(a - b) / abs(b) for a, b in zip(host, want)]
    check(max(rel) <= TRAIN_WITNESS_TOL, f"host witness: step-1 loss, "
          f"grad_norm and the loss after update 1 {host}, card {want} "
          f"(relative {rel}, tol {TRAIN_WITNESS_TOL})")
    print(f"  host witness, adam lr {lr}: step-1 loss {host[0]:.4f}, "
          f"grad_norm {host[1]:.4f}, loss after update 1 {host[2]:.4f}; "
          f"card {want[0]:.4f}, {want[1]:.4f}, {want[2]:.4f}; relative "
          f"{' '.join(f'{r:.3e}' for r in rel)} (tol {TRAIN_WITNESS_TOL}); "
          f"{time.monotonic() - t0:.1f} s on the host", flush=True)


def _train_smoke(dev, mesh, seed) -> None:
    """The smoke variant in f32, flash on: configurations (a)-(d) and the
    knob configurations (f)-(i), two sgd steps on the card (NCCL, kernels)
    and on the host (gloo, plain versions) from the same params and keys;
    a host-made leaf through the
    fused wire payload, and host-made trees through two adam updates
    (bf16 params), on both, bit for bit."""
    from repro_torch.launch import train
    from repro_torch.optim import adam, sgd
    cfg = fl_train.model_config("eris-gptneo-1.3b", full=False)
    check(tr.uses_flash_kernel(cfg, TRAIN_SEQ), "the smoke steps do not "
          "take the flash kernels")
    toks = lm_token_batches(random.PRNGKey(0), 1, TRAIN_BATCH, TRAIN_SEQ,
                            cfg.vocab)[0]
    for name, fields, _ in TRAIN_CONFIGS[:4] + TRAIN_KNOB_CONFIGS:
        settings = train.TrainSettings(**fields)
        out = []                                  # the card's, the host's
        for d in (dev, torch.device("cpu")):
            opt = sgd(TRAIN_SMOKE_LR)
            step = train.make_train_step(cfg, mesh, opt, settings, device=d)
            params = train.store_params(
                tr.init_params(cfg, seed=seed, device="cpu"), cfg, mesh,
                settings)
            params = tree_map(lambda t: t.to(d), params)
            state = opt.init(params)
            dsc_ref = train.init_dsc_state(cfg, mesh, settings, device=d)
            losses = []
            for i in range(2):
                params, state, dsc_ref, m = step(
                    params, state, dsc_ref, {"tokens": toks.to(d)},
                    random.PRNGKey(i))
                losses.append(float(m["loss"]))
            out.append((torch.cat([t.reshape(-1).float().cpu()
                                   for t in tree_leaves(params)]), losses))
        (cx, closs), (hx, hloss) = out
        rel = float((cx - hx).norm() / hx.norm())
        lrel = max(abs(a - b) / abs(b) for a, b in zip(closs, hloss))
        check(rel <= TRAIN_SMOKE_TOL and lrel <= TRAIN_SMOKE_TOL,
              f"smoke {name}: params card vs host {rel:.3e}, losses "
              f"{lrel:.3e} (tol {TRAIN_SMOKE_TOL})")
        print(f"  smoke {name}: 2 steps, params card vs host {rel:.3e}, "
              f"losses {lrel:.3e} (tol {TRAIN_SMOKE_TOL})")
    # a host-made leaf through the fused payload (n_client 1), both ways
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 256, 512)).astype(np.float32))
    s = 0.3 * g.roll(1, 0)
    seeds = (int(random.bits(random.PRNGKey(3))), 0x3177 + seed)
    on_host = train.fused_payload(g, s.clone(), 2, 1, *seeds, 0.1, 0.5)
    on_card = train.fused_payload(g.to(dev), s.to(dev), 2, 1, *seeds, 0.1,
                                  0.5)
    for what, a, b in zip(("codes", "scales", "s'"), on_card, on_host):
        _same(f"fused payload {what}, card vs host", a.cpu(), b)
    print("  a host-made (2, 256, 512) leaf through the fused payload: "
          "codes, scales and s' card == host, bit for bit")
    # two adam updates of host-made bf16 params (f32 from the first on)
    rng = np.random.default_rng(seed + 1)
    p0 = {"w": torch.from_numpy(rng.standard_normal((512, 300)).astype(
        np.float32)).bfloat16(), "b": torch.zeros(300, dtype=torch.bfloat16)}
    grads = [{k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                  .astype(np.float32)) for k, v in p0.items()}
             for _ in range(2)]
    ends = []
    for d in (dev, torch.device("cpu")):
        opt = adam(TRAIN_LR, weight_decay=0.1)
        p = tree_map(lambda t: t.to(d), p0)
        st = opt.init(p)
        for g in grads:
            g = tree_map(lambda x, q: x.to(d).to(q.dtype), g, p)
            delta, st = opt.update(g, st, p)
            p = tree_map(torch.add, p, delta)
        ends.append(tree_leaves(p) + tree_leaves(st.mu) + tree_leaves(st.nu))
    for a, b in zip(*ends):
        _same("adam update, card vs host", a.cpu(), b)
    print(f"  two adam updates of host-made bf16 params: params, mu, nu "
          f"({sorted({str(t.dtype) for t in ends[1]})}) card == host, bit "
          f"for bit")


def _event_pair():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def mesh_draws(dev, cfg) -> dict:
    """The n_client = 4 draws of the step that one rank cannot run, on
    the card through the step's own functions, on MESH_LEAF at round key
    PRNGKey(0): every rank's mask row, window by window, the four summed
    in rank order exactly zero in f32; rank 3's row on the leaf's last
    2**24 elements equal to the host's, bit for bit, and its LDP noise
    there within MESH_NORMAL_ULPS of the host's.  Each row and the noise
    are timed over the whole leaf (device events); the host's window is
    drawn on a thread of its own meanwhile."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import train
    items = list(sh.spec_items(cfg))
    i = [path for path, _ in items].index(MESH_LEAF)
    shape = items[i][1]
    n = math.prod(shape)
    key = random.PRNGKey(0)
    window = ((n - 1) // random.CHUNK * random.CHUNK, n)

    def on_host():
        t0 = time.monotonic()
        row = train.mask_row(key, i, MESH_CLIENTS - 1, MESH_CLIENTS, n,
                             window=window)
        host_s = time.monotonic() - t0
        return row, host_s, train.ldp_noise(key, i, MESH_CLIENTS - 1, shape,
                                            window=window)

    with ThreadPoolExecutor(1) as pool:
        host_job = pool.submit(on_host)
        out = _mesh_draws_card(dev, train, key, i, shape, n)
        host, host_s, host_noise = host_job.result()
    lo, hi, row, noise, noise_ms, row_ms = out
    check((lo, hi) == window, f"the last window {(lo, hi)}, the host's "
          f"{window}")
    _same(f"rank {MESH_CLIENTS - 1}'s mask row on [{lo}, {hi}), card vs "
          f"host", row.cpu(), host)
    card = noise.cpu()
    ulps = (card.view(torch.int32).long()
            - host_noise.view(torch.int32).long()).abs().max()
    check(torch.equal(card.sign(), host_noise.sign())
          and int(ulps) <= MESH_NORMAL_ULPS,
          f"rank {MESH_CLIENTS - 1}'s LDP noise on [{lo}, {hi}): card vs "
          f"host {int(ulps)} ulps (tol {MESH_NORMAL_ULPS})")
    out = dict(leaf="/".join(MESH_LEAF), n=n, n_client=MESH_CLIENTS,
               mask_row_ms=row_ms,
               pair_draw_ms=[ms / (MESH_CLIENTS - 1) for ms in row_ms],
               ldp_noise_ms=noise_ms, noise_ulps=int(ulps),
               host_mask_window_s=host_s)
    print(f"  n_client {MESH_CLIENTS} on {out['leaf']} ({n} elements), "
          f"round key PRNGKey(0): the four mask rows sum to exactly zero "
          f"in f32; rows {' / '.join(f'{ms:.1f}' for ms in row_ms)} ms "
          f"({MESH_CLIENTS - 1} pair draws each: "
          f"{row_ms[0] / (MESH_CLIENTS - 1):.1f} ms a pair draw; phase 12 "
          f"times a row over (d)'s n); rank "
          f"{MESH_CLIENTS - 1}'s row on [{lo}, {hi}) card == host bit for "
          f"bit (host {host_s:.1f} s); its LDP noise {noise_ms:.1f} ms over "
          f"the leaf, card vs host {int(ulps)} ulps on that window",
          flush=True)
    return out


def _mesh_draws_card(dev, train, key, i, shape, n) -> tuple:
    """:func:`mesh_draws`' card half: every rank's mask row, window by
    window, summed, and rank 3's LDP noise over the leaf.  Returns rank
    3's last window (lo, hi, its row, its noise there), the noise's ms and
    each row's ms."""
    events = [[] for _ in range(MESH_CLIENTS)]
    nonzero_sum = nonzero_row = 0
    last = None
    for lo in range(0, n, random.CHUNK):
        hi = min(n, lo + random.CHUNK)
        acc = None
        for a in range(MESH_CLIENTS):
            start, end = _event_pair()
            start.record()
            row = train.mask_row(key, i, a, MESH_CLIENTS, n, device=dev,
                                 window=(lo, hi))
            end.record()
            events[a].append((start, end))
            acc = row if acc is None else acc + row
            if a == 0:
                nonzero_row += int((row != 0).sum())
            if a == MESH_CLIENTS - 1 and hi == n:
                last = (lo, hi, row)
        nonzero_sum += int((acc != 0).sum())
        del acc, row
    torch.cuda.synchronize()
    row_ms = [sum(a.elapsed_time(b) for a, b in ev) for ev in events]
    check(nonzero_sum == 0, f"mask rows of {'/'.join(MESH_LEAF)} at "
          f"n_client {MESH_CLIENTS}: {nonzero_sum} coordinates do not "
          f"cancel")
    check(nonzero_row > n // 2, f"rank 0's mask row is mostly zero "
          f"({nonzero_row} of {n} nonzero)")
    lo, hi, row = last
    # rank 3's noise: the whole leaf timed, the last window vs the host
    start, end = _event_pair()
    total = torch.zeros((), device=dev)
    start.record()
    for w in range(0, n, random.CHUNK):
        noise = train.ldp_noise(key, i, MESH_CLIENTS - 1, shape, device=dev,
                                window=(w, min(n, w + random.CHUNK)))
        total += noise.sum()
    end.record()
    end.synchronize()
    noise_ms = start.elapsed_time(end)
    check(bool(total.isfinite()), "LDP noise: not finite")
    return lo, hi, row, noise, noise_ms, row_ms


def train_phase(dev, seed) -> dict:
    """The distributed step over a one-rank ``cpu:gloo,cuda:nccl`` group
    on a loopback port: the five configurations at full width, the four
    knob configurations, the n_client = 4 draws, then the smoke steps card
    vs host.  Returns the kernels' launches over the full-width steps (the
    main path's count)."""
    import torch.distributed as dist
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_process_group(dev)
    try:
        probe = torch.full((4,), 2.0, device=dev)
        dist.all_reduce(probe)                    # NCCL initialises here
        torch.cuda.synchronize()
        check(probe.tolist() == [2.0] * 4, f"NCCL all_reduce gave {probe}")
        print(f"  process group: backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}; torch {torch.__version__} has "
              f"reduce_scatter_single: "
              f"{hasattr(dist, 'reduce_scatter_single')}, "
              f"reduce_scatter_tensor: "
              f"{hasattr(dist, 'reduce_scatter_tensor')}")
        mesh = mesh_lib.make_host_mesh(device=dev)
        cfg = get_config("eris-gptneo-1.3b")
        for n in (1, 4, 8):
            print(f"  mesh_wire_bytes (computed, not measured) at n_client "
                  f"= {n}: int8 {sh.mesh_wire_bytes(cfg, n, int8=True)} B, "
                  f"f32 {sh.mesh_wire_bytes(cfg, n, int8=False, grad_bytes=4)}"
                  f" B, bf16 "
                  f"{sh.mesh_wire_bytes(cfg, n, int8=False, grad_bytes=2)} "
                  f"B a client a step")
        toks = lm_token_batches(random.PRNGKey(0), 1, TRAIN_BATCH, TRAIN_SEQ,
                                cfg.vocab, device=dev)[0]
        totals = {name: 0 for name in ROUND}
        totals.update({f"{name} f32": 0 for name in FLASH})
        results = {}
        for name, fields, path in TRAIN_CONFIGS:
            results[name] = _train_config(dev, seed, cfg, mesh, toks, name,
                                          fields, path, totals)
        cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
        name, fields, path = TRAIN_CONFIGS[0]
        name = f"{name} at {TRAIN_CUT_LAYERS} layers"
        results[name] = _train_config(dev, seed, cut, mesh, toks, name,
                                      fields, path, totals, witness=True,
                                      n_steps=2)
        for name, fields, path in TRAIN_CONFIGS:
            if name in TRAIN_FALL_CONFIGS:
                results[f"{name} lr {TRAIN_FALL_LR}"] = _train_config(
                    dev, seed, cut, mesh, toks,
                    f"{name} at {TRAIN_CUT_LAYERS} layers", fields, path,
                    totals, lr=TRAIN_FALL_LR,
                    n_steps=TRAIN_FALL_STEPS.get(name, TRAIN_STEPS))
        for name, fields, path in TRAIN_KNOB_CONFIGS:
            results[name] = _train_config(dev, seed, cfg, mesh, toks, name,
                                          fields, path, totals,
                                          lr=TRAIN_KNOB_LR, optimizer="sgd")
        _expect_free_card("after the train steps")
        results["mesh_draws"] = mesh_draws(dev, cfg)
        print("train_step " + json.dumps(results))
        _train_smoke(dev, mesh, seed)
    finally:
        dist.destroy_process_group()
    return totals


# --------------------------------------------------------------- phase 12
# The round matrix at full width, as phase 7 runs eris-gptneo-1.3b (bf16
# params from --seed, flash on, K = 4, A = 8, 4 x 64 tokens a client):
# (name, FLConfig fields, rounds, layers (None: all 24)).  (c) is the
# scenario pack's cell.  (c)'s LDP noise and (d)'s pairwise masks draw
# threefry normals and integers per coordinate (~11 s a round and ~13 s a
# client at n = 1,816,565,760 on an NVIDIA H100 80GB HBM3, 700.00 W):
# they run at MATRIX_CUT_LAYERS, whose n the line of threefry ms names.
MATRIX_POPULATION = 16
MATRIX_CUT_LAYERS = 2
MATRIX_CONFIGS = (
    ("a eris int8 agg_fail", dict(method="eris", int8_wire=True,
                                  agg_dropout=0.25, link_failure=0.1), 2,
     None),
    ("b eris_async int8", dict(method="eris_async", int8_wire=True,
                               population=MATRIX_POPULATION,
                               client_dropout=0.25, delay_max=2,
                               buffer_cadence=2), 2, None),
    ("c ldp_int8+agg_fail", dict(method="eris",
                                 **sc.get("ldp_int8+agg_fail").knobs), 2,
     MATRIX_CUT_LAYERS),
    ("d secure_agg", dict(method="secure_agg"), 1, MATRIX_CUT_LAYERS),
    ("e priprune", dict(method="priprune"), 1, None),
    ("f shatter", dict(method="shatter"), 1, None),
)
# (f)'s replayed window straddles 2**31 / 8, where the reference's int32
# chunk ids wrap
SHATTER_WINDOW = (2**28 - 2048, 2**28 + 2048)


class WindowedAggregate:
    """An aggregate stage that keeps a window of each round's update."""

    def __init__(self, stage, window, store: dict):
        self.stage, self.window, self.store = stage, window, store

    def apply(self, keys, state, vs, K, weights=None, collect_views=False):
        res = self.stage.apply(keys, state, vs, K, weights, collect_views)
        lo, hi = self.window
        self.store["update"] = res.update[lo:hi].clone()
        return res


def _next_keys(run):
    """The role keys ``run.step`` will split next."""
    return split_round_keys(random.split(run.key)[1])


def _replay_prune(run, capture, n) -> str:
    """Client 3's withheld update replayed: the stage again on the
    captured gradient equals what the round transmitted, at least k
    coordinates are zero, and the threshold is the k-th largest |g|."""
    stage = run.pipeline.compress[0].stage
    g, out = capture["g"], capture["out"]
    k = max(1, int(round(stage.rate * n)))
    again = stage.apply(None, None, g, REPLAY_CLIENT, K_CLIENTS)
    _same("priprune replay vs the round", again, out)
    zeros = int((out == 0).sum())
    check(zeros >= k, f"priprune: {zeros} coordinates withheld, want >= {k}")
    t = bl.withhold_threshold(g, k)
    above = sum(int((g[lo:lo + random.CHUNK].abs() > t).sum())
                for lo in range(0, n, random.CHUNK))
    at_least = sum(int((g[lo:lo + random.CHUNK].abs() >= t).sum())
                   for lo in range(0, n, random.CHUNK))
    check(above < k <= at_least, f"priprune threshold {float(t)}: {above} "
          f"above, {at_least} at or above, k = {k}")
    return (f"client {REPLAY_CLIENT} replayed == the round, {zeros} of {n} "
            f"withheld (k = {k}), threshold {float(t):.4e} the k-th largest "
            f"|g| ({above} above it)")


def _replay_shatter(run, grads: list, store: dict, n) -> str:
    """The update on SHATTER_WINDOW recomputed from the clients'
    gradients there, with chunk ids from the reference's int32 formula
    in numpy (the product wraps, the floor is negative, the index reads
    from the end): bit for bit, and the window takes chunk 6's weights
    past 2**28 where the unwrapped formula gives chunk 1."""
    lo, hi = SHATTER_WINDOW
    stage = run.pipeline.aggregate.stage
    i = np.arange(lo, hi, dtype=np.int32)
    ids = np.minimum(i * np.int32(stage.chunks) // np.int32(n),
                     stage.chunks - 1)
    chunk = np.arange(stage.chunks)[ids]
    unwrapped = np.minimum(np.arange(lo, hi, dtype=np.int64) * stage.chunks
                           // n, stage.chunks - 1)
    check(bool((chunk != unwrapped).any()), "shatter window: no wrap")
    members = bl.shatter_members(run.keys.comp, stage.chunks, K_CLIENTS,
                                 stage.r, grads[0].device)
    c = torch.from_numpy(chunk).to(grads[0].device)
    want = torch.zeros(hi - lo, device=grads[0].device)
    for k, g in enumerate(grads):
        want += members[c, k] * g
    _same("shatter window vs the int32 chunk ids", store["update"], want)
    return (f"update on [{lo}, {hi}) == the int32 chunk ids' recomputation "
            f"(chunks {sorted(set(chunk.tolist()))}; unwrapped "
            f"{sorted(set(unwrapped.tolist()))})")


def _matrix_config(dev, seed, cfg, name, fields, rounds, totals,
                   batches=None, flash_layers=None) -> dict:
    """``rounds`` rounds of one configuration at full width; adds its
    launches to ``totals`` and holds its gate (module docstring).  The
    clients' batches are the example's tokens unless ``batches`` (a dict
    with a leading client axis) is given; the flash kernels launch once a
    client in each of ``flash_layers`` layers (default all)."""
    _expect_free_card(f"before {name}")
    torch.cuda.reset_peak_memory_stats()
    fcfg = fl.FLConfig(K=K_CLIENTS, A=A_AGGS, lr=LR, seed=seed, **fields)
    if batches is None:
        toks = fl_train.client_tokens(seed, fcfg.population or K_CLIENTS,
                                      BATCH, SEQ, cfg.vocab, dev)
        loss = lambda p, b: tr.loss_fn(p, cfg, {"tokens": b})  # noqa: E731
    else:
        toks = batches
        loss = lambda p, b: tr.loss_fn(p, cfg, b)  # noqa: E731
    params = _init_params(cfg, seed, dev)
    run = fl.FLRun(fcfg, params, loss, device=dev)
    del params
    n = run.n
    capture = {"window": (0, n)}
    grad_events, comp_events = _instrument(run, capture)
    shatter_grads, store = [], {}
    if fcfg.method == "shatter":
        run.pipeline = dataclasses.replace(run.pipeline, aggregate=(
            WindowedAggregate(run.pipeline.aggregate, SHATTER_WINDOW, store)))
        timed = run._grad

        def kept_grad(x, batch):
            g = timed(x, batch)
            shatter_grads.append(g[slice(*SHATTER_WINDOW)].clone())
            return g

        run._grad = kept_grad
    int8 = fcfg.int8_wire
    failures = fcfg.agg_dropout > 0
    out, notes, went_down = [], [], 0
    x0 = run.x.clone() if fcfg.method == "eris_async" else None
    for t in range(rounds):
        grad_events.clear()
        comp_events.clear()
        # priprune keeps client 3's whole gradient and update to replay
        capture["round"] = REPLAY_ROUND if fcfg.method == "priprune" \
            else None
        dead, saved = [], {}
        if failures:
            alive, _ = run.pipeline.aggregate.draws(_next_keys(run),
                                                    K_CLIENTS)
            dead = [a for a in range(A_AGGS) if not alive[a]]
            saved = {a: run.x[a::A_AGGS].clone() for a in dead}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _set_round_launches(0)                    # the main path starts
        t0 = time.monotonic()
        start.record()
        run.step(toks)
        end.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {k: fn.launches for k, fn in ROUND.items()}
        flash = _flash_want(cfg, (cfg.n_layers if flash_layers is None
                                  else flash_layers) * K_CLIENTS)
        _check_tensor_cores(f"{name} round {t + 1}", flash, True)
        for k, count in launches.items():       # the main path ended
            totals[k] += count
            want = (flash[k] if k in FLASH else K_CLIENTS
                    if int8 and k in ("quantize", "dequantize") else 0)
            check(count == want, f"{name} round {t + 1}: {k} launched "
                  f"{count} times, want {want}")
        check(bool(run.x.isfinite().all()),
              f"{name} round {t + 1}: x is not finite")
        for a in dead:
            _same(f"{name} round {t + 1}: x at dead aggregator {a}",
                  run.x[a::A_AGGS], saved[a].to(run.x.dtype))
        if failures:
            went_down += len(dead)
            notes.append(f"round {t + 1}: aggregators {dead} down, x "
                         f"unchanged there bit for bit")
        if x0 is not None:
            same = bool((run.x == x0).all())
            check(same == (t == 0), f"{name} round {t + 1}: x "
                  f"{'moved' if not same else 'did not move'} (cadence 2: "
                  f"held in round 1, applied in round 2)")
            notes.append(f"round {t + 1}: x {'unchanged bit for bit' if same else 'moved'}"
                         f" (buffer t = {run.state.buf.t})")
        total = start.elapsed_time(end)
        grad_ms = sum(a.elapsed_time(b) for a, b in grad_events)
        comp_ms = sum(a.elapsed_time(b) for a, b in comp_events)
        stage_ms = {type(st.stage).__name__: sum(
            a.elapsed_time(b) for a, b in comp_events[i::len(
                run.pipeline.compress)]) for i, st in
            enumerate(run.pipeline.compress)}
        out.append(dict(round_ms=total, grad_ms=grad_ms, compress_ms=comp_ms,
                        stage_ms=stage_ms,
                        aggregate_server_ms=total - grad_ms - comp_ms,
                        wall_s=wall, launches=launches,
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        print(f"  {name} round {t + 1}: {total:.1f} ms = client gradients "
              f"{grad_ms:.1f} + compression {comp_ms:.1f} "
              f"{ {k: round(v, 1) for k, v in stage_ms.items()} } + "
              f"aggregation and server {total - grad_ms - comp_ms:.1f} (wall "
              f"{wall:.2f} s); launches "
              f"{ {k: v for k, v in launches.items() if v} }; peak "
              f"{out[-1]['peak_gb']:.2f} GB", flush=True)
    if fcfg.method == "priprune":
        notes.append(_replay_prune(run, capture, n))
    if fcfg.method == "shatter":
        notes.append(_replay_shatter(run, shatter_grads[-K_CLIENTS:], store,
                                     n))
    if failures:
        check(went_down > 0,
              f"{name}: no aggregator went down in {rounds} rounds")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 80, f"{name}: peak {peak:.2f} GB does not fit the card")
    for note in notes:
        print(f"  {name}: {note}")
    return dict(rounds=out, peak_mem_gb=peak, n=n, notes=notes)


def _threefry_ms(dev, n: int) -> dict:
    """Device ms of one client's LDP noise (``random.normal`` over its
    window of the (K, n) draw), 2**24 coordinates at a time and consumed
    (summed) as drawn.  (The other stage that draws per coordinate, the
    pairwise mask, is timed by (d)'s round: :func:`matrix_phase`.)"""
    key = random.PRNGKey(2)
    draws = {
        "ldp_noise_a_client": lambda lo, hi: random.normal(
            key, (K_CLIENTS, n), device=dev, window=(lo, hi)),
    }
    out = {}
    for name, draw in draws.items():
        acc = torch.zeros((), device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for lo in range(0, n, random.CHUNK):
            acc += draw(lo, min(n, lo + random.CHUNK)).sum()
        end.record()
        end.synchronize()
        check(bool(acc.isfinite()), f"{name}: draws not finite")
        out[name] = start.elapsed_time(end)
    return out


def matrix_phase(dev, seed) -> dict:
    """(a)-(f) at full width, the threefry draws' ms, then the smoke-size
    matrix card vs host, whose host half runs in SMOKE_HOST_PROCS
    processes of its own beside the full-width rounds.  Returns the
    kernels' launches over the full-width rounds (the main path's
    count)."""
    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        procs = []
        try:
            for part in range(SMOKE_HOST_PROCS):
                with open(pathlib.Path(out, f"host{part}.log"), "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", _SMOKE_HOST, str(ROOT),
                         str(seed), str(pathlib.Path(out, f"host{part}.pt")),
                         str(part), str(SMOKE_HOST_PROCS)],
                        stdout=subprocess.DEVNULL, stderr=f))
            totals = _matrix_full(dev, seed)
            host_x = {}
            for part, proc in enumerate(procs):
                try:
                    proc.wait(timeout=600)
                except subprocess.TimeoutExpired:
                    raise PhaseError("the smoke matrix's host half took "
                                     "over 600 s")
                log = pathlib.Path(out, f"host{part}.log")
                check(proc.returncode == 0, f"the smoke matrix's host half "
                      f"{part} failed: {log.read_text()[-2000:]}")
                host_x.update(torch.load(pathlib.Path(out, f"host{part}.pt")))
            matrix_small_input_phase(dev, seed, host_x)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return totals


def _matrix_full(dev, seed) -> dict:
    """(a)-(f) at full width and the threefry draws' ms."""
    totals = {name: 0 for name in ROUND}
    cfg = fl_train.model_config("eris-gptneo-1.3b", full=True)
    check(cfg.flash_attention, "eris-gptneo-1.3b: flash attention is off")
    results = {}
    for name, fields, rounds, layers in MATRIX_CONFIGS:
        at = cfg if layers is None else dataclasses.replace(
            cfg, n_layers=layers)
        results[name] = _matrix_config(dev, seed, at, name, fields, rounds,
                                       totals)
    _expect_free_card("after the round matrix")
    n = results["d secure_agg"]["n"]
    results["threefry_ms"] = _threefry_ms(dev, n)
    # (d)'s aggregation draws each client's pairwise-mask row (K - 1
    # ``random.randint`` pair draws over n) and sums the masked updates:
    # a row is that span over K (the sum and the server step are ~0.1 s
    # of ~52 s at n = 1,816,565,760 on an NVIDIA H100 80GB HBM3)
    agg = results["d secure_agg"]["rounds"][0]["aggregate_server_ms"]
    results["threefry_ms"]["pairwise_mask_a_client"] = agg / K_CLIENTS
    results["threefry_ms"]["n"] = n
    print(f"  threefry draws at n = {n} ({MATRIX_CUT_LAYERS} layers): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in
                      results["threefry_ms"].items() if k != "n"))
    print("round_matrix " + json.dumps(results))
    return totals


# every method and every feasible scenario cell at the smoke size; the
# dsc_int8 cells once more through the fused kernel (FLConfig fields)
SMOKE_POPULATION = 8
SMOKE_METHODS = {
    "fedavg": dict(),
    "min_leakage": dict(),
    "fedavg_ldp": dict(),
    "soteriafl": dict(compressor=RandP(p=0.25), ldp=sc.SCENARIO_LDP),
    "priprune": dict(),
    "shatter": dict(),
    "secure_agg": dict(),
    "eris": dict(),
    "fedbuff": dict(int8_wire=True, population=SMOKE_POPULATION,
                    client_dropout=0.25, delay_max=2, buffer_cadence=2),
    "eris_async": dict(population=SMOKE_POPULATION, client_dropout=0.25,
                       delay_max=2, buffer_cadence=2),
}


def _smoke_cases(seed) -> list:
    cases = [(f"method {m}", fl.FLConfig(method=m, K=K_CLIENTS, A=A_AGGS,
                                         lr=LR, seed=seed, **fields))
             for m, fields in SMOKE_METHODS.items()]
    for cell in sc.scenario_matrix():
        fcfg = cell.fl_config(K=K_CLIENTS, A=A_AGGS, lr=LR, seed=seed)
        cases.append((f"cell {cell.name}", fcfg))
        if cell.defense == "dsc_int8":
            cases.append((f"cell {cell.name} fused", dataclasses.replace(
                fcfg, compress_impl="fused")))
    return cases


# the smoke matrix's host half, in processes of their own: ``python -c
# _SMOKE_HOST <repo root> <seed> <output file> <part> <parts>``
_SMOKE_HOST = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.matrix_small_input_host(int(sys.argv[2]), sys.argv[3],
                                   int(sys.argv[4]), int(sys.argv[5]))
"""
SMOKE_HOST_PROCS, SMOKE_HOST_THREADS = 3, 2


def _smoke_matrix_run(cfg, seed, fcfg, device):
    """One smoke case's FLRun and its clients' tokens."""
    toks = fl_train.client_tokens(seed, fcfg.population or K_CLIENTS,
                                  BATCH, SEQ, cfg.vocab)
    run = fl.FLRun(fcfg, tr.init_params(cfg, seed=seed, device="cpu"),
                   lambda p, b: tr.loss_fn(p, cfg, {"tokens": b}),
                   device=device)
    return run, toks


def matrix_small_input_host(seed, out: str, part: int = 0,
                            parts: int = 1) -> None:
    """The host half of :func:`matrix_small_input_phase` (plain versions,
    SMOKE_HOST_THREADS threads), cases ``part``, ``part + parts``, ...:
    each case's x after two rounds, saved to ``out`` by case name."""
    torch.set_num_threads(SMOKE_HOST_THREADS)
    cfg = fl_train.model_config("eris-gptneo-1.3b", full=False)
    xs = {}
    for name, fcfg in _smoke_cases(seed)[part::parts]:
        host, toks = _smoke_matrix_run(cfg, seed, fcfg, "cpu")
        for _ in range(2):
            host.step(toks)
        xs[name] = host.x
    torch.save(xs, out)


def matrix_small_input_phase(dev, seed, host_x: dict) -> None:
    """Every method and every feasible scenario cell, eris-gptneo-1.3b's
    smoke variant in f32, flash on: two rounds on the card (kernels)
    against ``host_x``, the host's (plain versions) from the same seeds
    (:func:`matrix_small_input_host`), x within 1e-4 relative norm."""
    cfg = fl_train.model_config("eris-gptneo-1.3b", full=False)
    worst, cases = 0.0, _smoke_cases(seed)
    check(sorted(host_x) == sorted(name for name, _ in cases),
          f"the host half's cases {sorted(host_x)}")
    for name, fcfg in cases:
        card, toks = _smoke_matrix_run(cfg, seed, fcfg, dev)
        host_xn = host_x[name]
        _set_round_launches(0)
        for _ in range(2):
            card.step(toks.to(dev))
        if fcfg.compress_impl == "fused":
            check(dq.dsc_quantize.launches == 2 * K_CLIENTS,
                  f"{name}: dsc_quantize launched {dq.dsc_quantize.launches} "
                  f"times, want {2 * K_CLIENTS}")
        check(bool(card.x.isfinite().all()), f"{name}: x is not finite")
        rel = float((card.x.cpu() - host_xn).norm() / host_xn.norm())
        check(rel <= 1e-4, f"smoke {name}: x card vs host relative error "
              f"{rel:.3e} after 2 rounds")
        worst = max(worst, rel)
        print(f"  smoke {name}: x card vs host {rel:.3e} after 2 rounds")
    print(f"  smoke matrix: {len(cases)} configurations, worst "
          f"x card vs host {worst:.3e} (tol 1e-4)")


# ------------------------------------------------------------------- main
# --------------------------------------------------------------- phase 13
# The privacy audit of the distributed step's captured wire at full
# width: eris-gptneo-1.3b in bf16 from --seed, sgd at phase 11's knob lr,
# on a one-rank cpu:gloo,cuda:nccl group (n_client = 1: every leaf is the
# aggregator's whole, and its view is the whole update), AUDIT_STEPS steps
# with capture_views in (j) the int8 wire and (k) DSC at p 1.0, gamma 0.5
# on the fused int8 wire (the reference's view-parity settings).  The
# batch is rows [0, 8) of one lm_token_batches(PRNGKey(0)) draw of 12 x 64
# tokens; its rows [0, 4) are the members, rows [8, 12) the non-members.
AUDIT_STEPS, AUDIT_LR, AUDIT_BATCH, AUDIT_CANARIES = 2, 0.1, 8, 4
AUDIT_SEQ, AUDIT_BOOTSTRAP, AUDIT_KEY_SALT = 64, 64, 0xA0D3
AUDIT_CONFIGS = (
    # (name, TrainSettings fields, wire kernels launched once a leaf a step)
    ("j int8", dict(grad_dtype="float32", int8_wire=True),
     ("quantize", "dequantize")),
    ("k dsc int8 fused", dict(grad_dtype="float32", int8_wire=True,
                              use_dsc=True, dsc_p=1.0, dsc_gamma=0.5),
     ("dsc_quantize", "dequantize")),
)
# one member's alignment with flash on and off (the plain chunked
# attention), as phase 8 holds the two gradients
AUDIT_FLASH_OFF_TOL = 5e-2
# the smoke size, card vs host from the same seeds: scores within
# AUDIT_SMOKE_TOL of the largest |score|, AUC and balanced accuracy equal;
# DLG's match losses within AUDIT_DLG_TOL over its first AUDIT_DLG_STEPS
AUDIT_SMOKE_TOL, AUDIT_DLG_TOL, AUDIT_DLG_STEPS = 1e-4, 1e-3, 20


def _audit_capture(dev, seed, cfg, mesh, toks, name, fields, path,
                   totals) -> tuple:
    """AUDIT_STEPS steps of one configuration with ``capture_views``.
    Each step's views, put through Eq. 4 (with DSC: s_agg from the
    earlier views) and sgd's own update from the pre-step params, must
    give the post-step params bit for bit, leaf by leaf.  Returns (the
    pre-step iterates (T, n) in the params' dtype, the views (T, n) f32,
    the unravel of a flat vector, the steps' ms), the step state freed."""
    from repro_torch.convert import ravel_params
    from repro_torch.launch import train
    from repro_torch.optim import sgd
    from repro_torch.optim.optimizers import weak
    settings = train.TrainSettings(capture_views=True, **fields)
    opt = sgd(AUDIT_LR)
    step = train.make_train_step(cfg, mesh, opt, settings, device=dev)
    params = train.store_params(_init_params(cfg, seed, dev), cfg, mesh,
                                settings)
    state = opt.init(params)
    dsc_ref = train.init_dsc_state(cfg, mesh, settings, device=dev)
    _, unravel = ravel_params(tree_map(lambda t: t.to("meta"), params))
    sizes = [t.numel() for t in tree_leaves(params)]
    n, n_leaves = sum(sizes), len(sizes)
    x_traj = torch.empty(AUDIT_STEPS, n, dtype=tree_leaves(params)[0].dtype,
                         device=dev)
    views = torch.empty(AUDIT_STEPS, n, dtype=torch.float32, device=dev)
    flash = _flash_want(cfg, cfg.n_layers
                        if tr.uses_flash_kernel(cfg, AUDIT_SEQ) else 0)
    step_ms = []
    for t in range(AUDIT_STEPS):
        torch.cat([x.reshape(-1) for x in tree_leaves(params)], out=x_traj[t])
        _set_round_launches(0)                    # the main path starts
        start, end = _event_pair()
        start.record()
        params, state, dsc_ref, m, v = step(params, state, dsc_ref,
                                            {"tokens": toks},
                                            random.PRNGKey(t))
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        for k, fn in ROUND.items():               # the main path ended
            totals[k] += fn.launches
            want = flash[k] if k in FLASH else n_leaves if k in path \
                else 0
            check(fn.launches == want, f"{name} step {t + 1}: {k} launched "
                  f"{fn.launches} times, want {want}")
        _check_tensor_cores(f"{name} step {t + 1}", flash, True)
        check(sorted(v, key=int) == [str(i) for i in range(n_leaves)],
              f"{name} step {t + 1}: views of leaves {sorted(v, key=int)}")
        torch.cat([v[str(i)].reshape(-1) for i in range(n_leaves)],
                  out=views[t])
        del v
        check(math.isfinite(float(m["loss"])), f"{name}: loss {m}")
        # the view is what was aggregated: sgd's update of it, bit for bit
        pre = tree_leaves(unravel(x_traj[t]))
        off = 0
        for i, (p0, p1) in enumerate(zip(pre, tree_leaves(params))):
            u = views[t, off:off + sizes[i]].view(p0.shape)
            if settings.use_dsc:
                s = torch.zeros_like(u)
                for tau in range(t):        # Eq. 4's s_agg, from the views
                    w = s + views[tau, off:off + sizes[i]].view(p0.shape)
                    s = dsc_lib.fma_shift(settings.dsc_gamma, w - s, s)
                u = s + u
            g = u.to(p0.dtype)
            check(torch.equal(p1, p0 + weak(-AUDIT_LR, g) * g),
                  f"{name} step {t + 1}: leaf {i}'s view does not give the "
                  f"step's update")
            off += sizes[i]
        print(f"  {name} step {t + 1}: {step_ms[-1]:.1f} ms, loss "
              f"{float(m['loss']):.4f}; {n_leaves} leaves captured, "
              f"{views[t].numel() * 4 / 1e9:.2f} GB of f32 views; the "
              f"views give the step's update bit for bit", flush=True)
    del params, state, dsc_ref, step, pre, p0, p1, u, g
    gc.collect()
    torch.cuda.empty_cache()
    return x_traj, views, unravel, step_ms


def _audit_full(dev, seed, cfg, unravel, x_traj, views, members, non,
                name, totals) -> dict:
    """``mia_audit`` of one configuration's captured views at full
    observation (A = 1, the mask all ones), with its launches, then one
    member's alignment again with flash off."""
    from repro_torch.core import privacy
    from repro_torch.privacy import harness
    n = views.shape[1]
    obs = torch.ones(n, device=dev)

    def grads_of(c):
        return harness.flat_grad(
            lambda p, tok: tr.loss_fn(p, c, {"tokens": tok[None]}), unravel)

    _set_round_launches(0)                        # the main path starts
    start, end = _event_pair()
    start.record()
    res = privacy.mia_audit(
        random.fold_in(random.PRNGKey(seed), AUDIT_KEY_SALT), grads_of(cfg),
        x_traj, views, obs, members, non, n_bootstrap=AUDIT_BOOTSTRAP)
    end.record()
    torch.cuda.synchronize()
    audit_ms = start.elapsed_time(end)
    grads = AUDIT_STEPS * (len(members) + len(non))
    flash = _flash_want(cfg, cfg.n_layers * grads
                        if tr.uses_flash_kernel(cfg, AUDIT_SEQ) else 0)
    for k, fn in ROUND.items():                   # the main path ended
        totals[k] += fn.launches
        want = flash[k] if k in FLASH else 0
        check(fn.launches == want, f"{name} audit: {k} launched "
              f"{fn.launches} times, want {want} ({grads} canary gradients "
              f"of {cfg.n_layers} layers)")
    _check_tensor_cores(f"{name} audit", flash, True)
    lo, hi = res["auc_ci"]
    check(math.isfinite(res["auc"]) and lo <= res["auc"] <= hi,
          f"{name}: AUC {res['auc']} outside its CI {res['auc_ci']}")
    # member 0's alignment sum_t <g, v> / ||v||, flash on and off
    off_cfg = dataclasses.replace(cfg, flash_attention=False)
    align, grad_ms = {True: 0.0, False: 0.0}, []
    for t in range(AUDIT_STEPS):
        w, inv = privacy._round_weights(views[t], obs)
        for flash_on, c in ((True, cfg), (False, off_cfg)):
            start, end = _event_pair()
            start.record()
            g = grads_of(c)(x_traj[t], members[0])
            end.record()
            align[flash_on] += privacy._dot(g, w) * inv
            if flash_on:
                grad_ms.append(start.elapsed_time(end))
            del g
        del w
    rel = abs(align[True] - align[False]) / abs(align[False])
    check(rel <= AUDIT_FLASH_OFF_TOL, f"{name}: member 0's alignment with "
          f"flash {align[True]} and without {align[False]} (relative {rel})")
    out = dict(res, audit_ms=audit_ms, canary_grads=grads,
               canary_grad_ms=grad_ms[-1], member0_align_flash=align[True],
               member0_align_plain=align[False], flash_off_rel=rel)
    print(f"  {name} audit (A = 1, {len(members)} members, {len(non)} "
          f"non-members, {AUDIT_BOOTSTRAP} resamples): AUC {res['auc']:.4f} "
          f"CI {res['auc_ci']}, balanced accuracy "
          f"{res['balanced_accuracy']:.4f} CI {res['bal_acc_ci']}, score gap "
          f"{res['score_gap']:.4e}; {audit_ms:.1f} ms for {grads} canary "
          f"gradients ({grad_ms[-1]:.1f} ms one); member 0 flash on "
          f"{align[True]:.6e} vs off {align[False]:.6e} (relative "
          f"{rel:.2e}, tol {AUDIT_FLASH_OFF_TOL})", flush=True)
    return out


def _smoke_scores(dev, spec, lm_cfg=None, params0=None):
    """``mia_mlp`` (or ``mia_lm`` on ``lm_cfg``) step by step on ``dev``,
    returning the scores beside the statistics."""
    from repro_torch.core import masks as masks_lib
    from repro_torch.core import privacy
    from repro_torch.privacy import harness
    if lm_cfg is None:
        params0, loss_fn, batches, members, non = \
            harness.mlp_canary_problem(spec, device=dev)
    else:
        params0, loss_fn, batches, members, non = harness.lm_canary_problem(
            lm_cfg, spec, params0=params0, device=dev)
    run, x_traj, views = harness.capture_run(spec, params0, loss_fn,
                                             batches, device=dev)
    grad_fn = (harness._mlp_grad_fn(run, loss_fn) if lm_cfg is None else
               harness.flat_grad(lambda p, c: tr.loss_fn(
                   p, lm_cfg, {"tokens": c[None]}), run.unravel))
    assign = masks_lib.make_assignment(run.n, spec.A, spec.mask_scheme,
                                       device=dev)
    obs, v = harness.coalition_views(views, assign, spec.a_c)
    v = harness.deshift_views(v, harness.dsc_gamma_of(run))
    scores = privacy._mia_scores(grad_fn, x_traj, v, obs,
                                 torch.cat([members, non]))
    salt = 0xA0D1 if lm_cfg is None else 0xA0D2
    stats = privacy._host_stats(privacy._stats_from_scores(
        random.fold_in(random.PRNGKey(spec.seed), salt), scores,
        len(members), spec.n_bootstrap))
    return scores, stats


def _audit_smoke(dev, seed) -> dict:
    """The smoke-size audits card vs host from the same seeds: mia_mlp at
    A = 1 and 4 and on the int8 wire, mia_lm on ``tiny_lm_config``, then
    DLG on the int8 wire (dlg_mlp) and at A = 1 and 4 (dlg_lm)."""
    from repro_torch.privacy import harness
    cpu = torch.device("cpu")
    out = {}
    lm_cfg = harness.tiny_lm_config()
    lm_params = tr.init_params(lm_cfg, seed=seed, device=cpu)
    cases = [("mia_mlp A=1", harness.AuditSpec(A=1, rounds=12,
                                               n_bootstrap=64, seed=seed),
              None),
             ("mia_mlp A=4", harness.AuditSpec(A=4, rounds=12,
                                               n_bootstrap=64, seed=seed),
              None),
             ("mia_mlp A=4 int8", harness.AuditSpec(
                 A=4, rounds=12, n_bootstrap=64, seed=seed,
                 int8_wire=True), None),
             ("mia_lm A=2", harness.AuditSpec(A=2, rounds=4, K=2,
                                              n_canaries=4, lr=0.5,
                                              n_bootstrap=32, seed=seed),
              lm_cfg)]
    for name, spec, c in cases:
        (s_card, st_card), (s_host, st_host) = [
            _smoke_scores(d, spec, c, None if c is None else tree_map(
                lambda t: t.to(d), lm_params)) for d in (dev, cpu)]
        err = float((s_card - s_host).abs().max() / s_host.abs().max())
        check(err <= AUDIT_SMOKE_TOL, f"{name}: scores card vs host "
              f"{err:.3e} of the largest (tol {AUDIT_SMOKE_TOL})")
        for k in ("auc", "balanced_accuracy", "auc_ci", "bal_acc_ci"):
            check(st_card[k] == st_host[k], f"{name}: {k} card "
                  f"{st_card[k]}, host {st_host[k]}")
        if c is None:                     # the entry point, on the card
            entry = harness.mia_mlp(spec, device=dev)
            check(entry["auc"] == st_card["auc"],
                  f"{name}: mia_mlp's AUC {entry['auc']}, steps' "
                  f"{st_card['auc']}")
        out[name] = dict(auc=st_card["auc"], auc_ci=st_card["auc_ci"],
                         score_err=err)
        print(f"  {name}: AUC {st_card['auc']:.4f} CI {st_card['auc_ci']} "
              f"on both; scores card vs host {err:.2e} of the largest",
              flush=True)
    for name, fn, kw in (
            ("dlg_mlp int8", harness.dlg_mlp_runs,
             dict(A_values=[1, 8], wire="int8", seed=seed)),
            ("dlg_lm", harness.dlg_lm_runs,
             dict(cfg=lm_cfg, A_values=[1, 4], seed=seed))):
        got = []
        for d in (dev, cpu):
            extra = ({} if fn is harness.dlg_mlp_runs else
                     dict(params0=tree_map(lambda t: t.to(d), lm_params)))
            got.append(fn(steps=AUDIT_DLG_STEPS, device=d, **kw, **extra)[0])
        for A in kw["A_values"]:
            card = got[0][A]["match_losses"].cpu()
            host = got[1][A]["match_losses"]
            rel = float(((card - host).abs() / host.abs()).max())
            check(bool(card.isfinite().all()) and rel <= AUDIT_DLG_TOL,
                  f"{name} A={A}: match losses card vs host {rel:.3e} "
                  f"(tol {AUDIT_DLG_TOL})")
            out[f"{name} A={A}"] = dict(match_loss_rel=rel,
                                        first=float(host[0]),
                                        last=float(host[-1]))
            print(f"  {name} A={A}: match losses {float(host[0]):.4e} -> "
                  f"{float(host[-1]):.4e} over {AUDIT_DLG_STEPS} steps, card "
                  f"vs host {rel:.2e} (tol {AUDIT_DLG_TOL})", flush=True)
    return out


def _refuse_double_backward(dev) -> None:
    """A create_graph=True backward through the flash Function on the card
    raises (its kernels record no graph)."""
    x = torch.randn(1, AUDIT_SEQ, 64, device=dev, requires_grad=True)
    w = torch.randn(64, 256, device=dev, requires_grad=True)
    q = (x @ w).view(1, AUDIT_SEQ, 2, 128).transpose(1, 2)
    loss = (fa.flash_attention(q, q, q) ** 2).sum()
    try:
        torch.autograd.grad(loss, (w,), create_graph=True)
    except RuntimeError as err:
        check("once differentiable" in str(err), f"double backward: {err}")
        print(f"  a create_graph=True backward through the flash kernels "
              f"raises: {str(err)[:72]}...")
        return
    raise PhaseError("a create_graph=True backward through the flash "
                     "kernels did not raise")


def audit_phase(dev, seed) -> dict:
    """The privacy audit of eris-gptneo-1.3b's captured wire at full width
    over a one-rank NCCL group, then the smoke-size audits card vs host and
    the double-backward refusal.  Returns the kernels' launches over the
    full-width steps and audits (the main path's count)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.privacy import harness
    _expect_free_card("before the audit")
    torch.cuda.reset_peak_memory_stats()
    totals = {name: 0 for name in ROUND}
    results = {}
    cfg = get_config("eris-gptneo-1.3b")
    rows = lm_token_batches(random.PRNGKey(0), 1, AUDIT_BATCH
                            + AUDIT_CANARIES, AUDIT_SEQ, cfg.vocab,
                            device=dev)[0]
    toks = rows[:AUDIT_BATCH]
    members, non = rows[:AUDIT_CANARIES], rows[AUDIT_BATCH:]
    mesh_lib.init_process_group(dev)
    try:
        mesh = mesh_lib.make_host_mesh(device=dev)
        for name, fields, path in AUDIT_CONFIGS:
            t0 = time.monotonic()
            x_traj, views, unravel, step_ms = _audit_capture(
                dev, seed, cfg, mesh, toks, name, fields, path, totals)
            gamma = fields.get("dsc_gamma", 0.0) if fields.get("use_dsc") \
                else 0.0
            harness.deshift_views(views, gamma, inplace=True)
            results[name] = _audit_full(dev, seed, cfg, unravel, x_traj,
                                        views, members, non, name, totals)
            results[name].update(step_ms=step_ms,
                                 seconds=time.monotonic() - t0)
            del x_traj, views
            _expect_free_card(f"after {name}")
    finally:
        dist.destroy_process_group()
    peak = torch.cuda.max_memory_allocated()
    check(peak < 80e9, f"audit: peak {peak / 1e9:.2f} GB does not fit")
    results["peak_gb"] = peak / 1e9
    print(f"  audit peak device memory {peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB)", flush=True)
    t0 = time.monotonic()
    results["smoke"] = _audit_smoke(dev, seed)
    results["smoke_seconds"] = time.monotonic() - t0
    _refuse_double_backward(dev)
    print("privacy_audit " + json.dumps(results))
    return totals


# --------------------------------------------------------------- phase 14
MOE_ARCH = "olmoe-1b-7b"
# the round's cut: 4 of olmoe's 16 layers, n = 1,884,309,504 (under 2**31
# as eris-gptneo-1.3b's); at 16 layers a round's weights, gradient and
# two f32 vectors of n do not fit the card, and n passes 2**32
MOE_ROUND_LAYERS = 4
FEEDS = (("federated_population",
          dict(population=10_000, samples_per_client=64, alpha=0.5)),
         ("federated_classification",
          dict(K=100, samples_per_client=64, alpha=0.1)))
FEED_X_ATOL = 4e-6              # features: normal's ulps, |x| < 10
MOE_GRAD_TOKENS = 128
# olmoe's loss on 1 x 128 tokens, flash vs the plain chunked attention,
# 16 layers of random bf16 weights (a flipped route moves that token a
# long way; the share of first-layer flips is printed beside the gap)
MOE_LOSS_REL_TOL = 1e-2
INIT_CHECK = 4096               # w_gate elements recomputed on the host


def _feed_phase(dev, seed) -> dict:
    """(a) the non-IID feeds on the card and on the host from one key:
    labels and the partition's indices equal, features within normal's
    ulps, each call timed."""
    key = random.PRNGKey(seed)
    out = {}
    for name, kw in FEEDS:
        fn = getattr(data_lib, name)
        got = {}
        for where in (dev, torch.device("cpu")):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            x, y = fn(key, **kw, device=where)
            torch.cuda.synchronize()
            got[where.type] = (x.cpu(), y.cpu(), time.monotonic() - t0)
        (xc, yc, tc), (xh, yh, th) = got["cuda"], got["cpu"]
        _same(f"{name} labels", yc, yh)
        err = float((xc - xh).abs().max())
        check(err <= FEED_X_ATOL, f"{name}: features card vs host differ "
              f"by {err:.3e} (atol {FEED_X_ATOL:g})")
        # the partition itself, as each call draws it
        n = x.shape[0] * x.shape[1] * (1 if name == "federated_population"
                                       else 4)
        parts = {}
        for where in (dev, torch.device("cpu")):
            if name == "federated_population":
                kd, kp = random.split(key)
                _, labels = data_lib.make_classification(kd, n, 16, 4,
                                                         device=where)
                parts[where.type] = data_lib.balanced_dirichlet_indices(
                    kp, labels, kw["population"], kw["alpha"], 4).cpu()
            else:
                kd, kp, _ = random.split(key, 3)
                _, labels = data_lib.make_classification(kd, n, 16, 4,
                                                         device=where)
                parts[where.type] = data_lib.dirichlet_partition(
                    kp, labels, kw["K"], kw["alpha"], 4).cpu()
        _same(f"{name} partition indices", parts["cuda"], parts["cpu"])
        out[name] = dict(card_s=tc, host_s=th, x_max_abs_err=err,
                         shape=list(x.shape))
        print(f"  {name}({kw}): x {tuple(x.shape)}; labels and partition "
              f"indices card == host, features within {err:.2e}; "
              f"{tc:.2f} s on the card, {th:.2f} s on the host")
    return out


def _leaf_index(cfg, leaf: str) -> int:
    """Leaf ``blocks/<leaf>``'s place in ``param_spec`` order: the i of
    its ``fold_in(key, i)``."""
    i = 0
    for name, shape in tr.param_spec(cfg).items():
        if name != "blocks":
            i += 1
            continue
        for bn in shape:
            if bn == leaf:
                return i
            i += 1
    raise KeyError(leaf)


def _moe_init(dev, seed, cfg) -> tuple:
    """(b) ``init_params`` at full width on the card, timed, with its
    peak; w_gate's 2**31 elements around 2**30 and at the end recomputed
    on the host."""
    _expect_free_card("before olmoe's init")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    params = tr.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    count = sum(t.numel() for t in _leaves(params))
    shape = tuple(params["blocks"]["w_gate"].shape)
    n = math.prod(shape)
    check(n == 2**31, f"olmoe's w_gate holds {n} elements, not 2**31")
    key = random.fold_in(random.PRNGKey(seed), _leaf_index(cfg, "w_gate"))
    scale = float(np.float32(shape[-2] ** -0.5))
    flat = params["blocks"]["w_gate"].view(-1)
    for lo, hi in ((2**30 - INIT_CHECK // 2, 2**30 + INIT_CHECK // 2),
                   (n - INIT_CHECK, n)):
        host = (random.normal(key, shape, device="cpu", window=(lo, hi))
                * scale).to(flat.dtype)
        _same(f"olmoe w_gate [{lo}, {hi}) card vs host", flat[lo:hi].cpu(),
              host)
    print(f"  init_params {cfg.name}: {count} params ({cfg.dtype}) in "
          f"{secs:.2f} s on the card ({count / secs / 1e9:.2f} G params/s), "
          f"peak {peak:.2f} GB; w_gate (2**31 elements) around 2**30 and "
          f"its last {INIT_CHECK} == the host's draws")
    return params, dict(seconds=secs, params=count, peak_gb=peak)


def _moe_grad(dev, seed, cfg, params) -> dict:
    """(d) one full-width gradient on 1 x 128 tokens, flash on and off."""
    off = dataclasses.replace(cfg, flash_attention=False)
    check(tr.uses_flash_kernel(cfg, MOE_GRAD_TOKENS),
          f"{cfg.name}: {MOE_GRAD_TOKENS} tokens do not take flash")
    toks = lm_token_batches(random.fold_in(random.PRNGKey(seed), 3), 1, 1,
                            MOE_GRAD_TOKENS, cfg.vocab, device=dev)[0]
    _client_grad(off, params, toks[:, :64])    # cuBLAS handles
    res = {}
    for c in (cfg, off):
        _set_round_launches(0)
        with RouteSpy() as spy:
            grads, loss, ms, peak = _client_grad(c, params, toks)
        finite = all(bool(g.isfinite().all()) for g in grads)
        del grads
        check(finite and math.isfinite(loss),
              f"{cfg.name} gradient (flash {c.flash_attention}) not finite")
        if c.flash_attention:
            want = _flash_want(c, cfg.n_layers)
            _check_tensor_cores(f"{cfg.name} flash gradient", want, True)
            for k in FLASH:
                check(FLASH[k].launches == want[k],
                      f"{cfg.name} gradient: {k} launched "
                      f"{FLASH[k].launches} times, want {want[k]}")
        res[c.flash_attention] = dict(loss=loss, ms=ms, peak_gb=peak,
                                      idx=spy.idxs[0], disp=spy.disps[0])
    on, pl = res[True], res[False]
    idx_diff = float((on["idx"] != pl["idx"]).float().mean())
    disp_diff = float((on["disp"] != pl["disp"]).flatten(2).any(-1)
                      .float().mean())
    gap = abs(on["loss"] - pl["loss"]) / abs(pl["loss"])
    out = dict(tokens=MOE_GRAD_TOKENS, loss_flash=on["loss"],
               loss_plain=pl["loss"], loss_rel_gap=gap,
               flash_ms=on["ms"], plain_ms=pl["ms"],
               flash_peak_gb=on["peak_gb"], plain_peak_gb=pl["peak_gb"],
               first_layer_idx_differ=idx_diff,
               first_layer_dispatch_differ=disp_diff)
    print(f"  {cfg.name} gradient on 1 x {MOE_GRAD_TOKENS} tokens: loss "
          f"flash {on['loss']:.5f} / plain {pl['loss']:.5f} (relative gap "
          f"{gap:.2e}, tol {MOE_LOSS_REL_TOL:g}); first-layer routes that "
          f"differ: top-k experts {100 * idx_diff:.2f}% of (token, choice), "
          f"dispatch rows {100 * disp_diff:.2f}% of tokens; {on['ms']:.1f} "
          f"ms flash, {pl['ms']:.1f} ms plain; peak above the params "
          f"{on['peak_gb']:.2f} / {pl['peak_gb']:.2f} GB")
    check(gap <= MOE_LOSS_REL_TOL, f"{cfg.name} loss flash vs plain: "
          f"relative gap {gap:.3e}")
    return out


def moe_phase(dev, seed) -> tuple:
    """Phase 14: the non-IID feeds, the reference's init draws and the MoE
    family on olmoe-1b-7b.  Returns (the paged kernel's launches while
    serving, the round kernels' launches over (e)'s rounds)."""
    parts = {}
    t0 = time.monotonic()
    results = {"feeds": _feed_phase(dev, seed)}
    parts["a feeds"] = time.monotonic() - t0
    cfg = get_config(MOE_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.flash_attention,
          f"{MOE_ARCH}: {cfg.dtype}, flash {cfg.flash_attention}")

    t0 = time.monotonic()
    params, results["init"] = _moe_init(dev, seed, cfg)
    parts["b init"] = time.monotonic() - t0

    t0 = time.monotonic()
    requests = serve_lib.random_requests(cfg.vocab, REQUESTS, PROMPT_MIN,
                                         PROMPT_MAX, seed)
    settings = serve_lib.settings_for(requests, GEN, REQUESTS,
                                      cache_dtype="bfloat16")
    paged, metrics = serving_phase(dev, seed, cfg, params, requests,
                                   settings)
    results["serving"] = metrics
    replay_phase(dev, cfg, params, requests, settings,
                 metrics["decode_step_ms_median"])
    small_input_phase(dev, seed, MOE_ARCH)
    parts["c serving"] = time.monotonic() - t0

    t0 = time.monotonic()
    results["gradient"] = _moe_grad(dev, seed, cfg, params)
    parts["d gradient"] = time.monotonic() - t0
    del params

    t0 = time.monotonic()
    totals = {name: 0 for name in ROUND}
    cut = dataclasses.replace(cfg, n_layers=MOE_ROUND_LAYERS)
    results["round"] = _matrix_config(
        dev, seed, cut, f"e {MOE_ARCH} {MOE_ROUND_LAYERS} layers eris int8",
        dict(method="eris", int8_wire=True), 2, totals)
    parts["e round"] = time.monotonic() - t0
    _expect_free_card("after the moe round")
    results["seconds"] = parts
    print("moe " + json.dumps(results))
    print("  phase 14 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return paged, totals


# --------------------------------------------------------------- phase 15
# the recurrent families at full width, bf16 params from --seed, flash on;
# hymba-1.5b at FAMILY_LAYERS of its 32 (its selective scan took ~80% of a
# 12.5 s gradient at all 32 on an NVIDIA H100 80GB HBM3, 700.00 W)
FAMILY_ARCHS = ("xlstm-350m", "hymba-1.5b")
FAMILY_LAYERS = {"hymba-1.5b": 8}
VLM_ARCH = "internvl2-26b"
FAMILY_CONTEXT = 2048
# the loss on 1 x 2048 tokens, flash vs the plain chunked attention (as
# phase 14(d)): hymba's 8 layers of random bf16 weights, the plain
# path's softmax weights rounded to bf16 before the PV product
FAMILY_LOSS_REL_TOL = 1e-2
BEAM_PROMPT, BEAM_NEW, BEAM_WIDTH = 64, 16, 4
# internvl2-26b has 19,867,551,744 params (39.7 GB in bf16; its gradient
# as much again): its gradient runs at 8 of its 48 layers (4,264,249,344
# params) on one image of 256 patch embeddings and 256 text tokens, S =
# 512; its rounds at 2 (n = 1,923,753,984), 4 x 256 text tokens a client
# beside each client's own images
VLM_GRAD_LAYERS, VLM_ROUND_LAYERS, VLM_TEXT = 8, 2, 256
# card vs host at the smoke size in f32; image and text fill one flash
# tile of 64 positions
FAMILY_SMOKE_TOL = 1e-4
FAMILY_SMOKE_POSITIONS, FAMILY_SMOKE_BATCH, FAMILY_SMOKE_NEW = 64, 4, 8


def _family_batch(where, seed, cfg, lead, text) -> dict:
    """Tokens (lead..., text) from the threefry stream and, for vlm, the
    image's patch embeddings (lead..., n_frontend_tokens, d_frontend),
    normals from a generator seeded by ``seed``, on ``where``."""
    n = math.prod(lead)
    toks = lm_token_batches(random.fold_in(random.PRNGKey(seed), 5), 1, n,
                            text, cfg.vocab, device=where)[0]
    batch = {"tokens": toks.reshape(*lead, text)}
    if cfg.frontend == "vlm":
        gen = torch.Generator(device=where).manual_seed(seed + 15)
        batch["frontend_embeds"] = torch.randn(
            *lead, cfg.n_frontend_tokens, cfg.d_frontend, generator=gen,
            device=where)
    return batch


def _positions(cfg, batch) -> int:
    return batch["tokens"].shape[-1] + (
        cfg.n_frontend_tokens if cfg.frontend == "vlm" else 0)


def _device_profile(fn):
    """torch.profiler over ``fn()``, device activity only: a hymba-1.5b
    gradient launches ~260,000 kernels, and with the host's ops recorded
    too the profile takes minutes to read."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _family_grad(cfg, params, batch, attn_layers: int, totals,
                 profile: bool) -> dict:
    """One gradient, flash on and, where the family attends, off: ms and
    peak above the params, the loss gap within FAMILY_LOSS_REL_TOL;
    ``attn_layers`` launches of each flash kernel on the bf16 tensor cores
    (none for ssm), added to ``totals``.  A first gradient on 64 tokens,
    flash off, loads the family's kernels (the recurrent mixers' are new
    to the process) before the timed ones.  With ``profile``, one more
    flash gradient under the profiler: its device kernels and idle
    share."""
    S = _positions(cfg, batch)
    check(tr.uses_flash_kernel(cfg, S), f"{cfg.name}: S = {S} does not "
          f"take flash")
    off = dataclasses.replace(cfg, flash_attention=False)
    _client_grad(off, params, dict(batch, tokens=batch["tokens"][:, :64]))
    res = {}
    for c in ((cfg, off) if attn_layers else (cfg,)):
        _set_round_launches(0)
        grads, loss, ms, peak = _client_grad(c, params, batch)
        finite = all(bool(g.isfinite().all()) for g in grads)
        del grads
        check(finite and math.isfinite(loss),
              f"{cfg.name} gradient (flash {c.flash_attention}) not finite")
        if c.flash_attention:
            want = _flash_want(c, attn_layers)
            _check_tensor_cores(f"{cfg.name} gradient", want, True)
            for k, fn in FLASH.items():
                check(fn.launches == want[k], f"{cfg.name} gradient: {k} "
                      f"launched {fn.launches} times, want {want[k]}")
                totals[k] += fn.launches
        res[c.flash_attention] = dict(loss=loss, ms=ms, peak_gb=peak)
    on = res[True]
    out = dict(positions=S, loss_flash=on["loss"], flash_ms=on["ms"],
               flash_peak_gb=on["peak_gb"])
    line = (f"  {cfg.name} ({cfg.n_layers} layers) gradient on 1 x {S} "
            f"positions: flash {on['ms']:.1f} ms, {on['peak_gb']:.2f} GB "
            f"above the params, loss {on['loss']:.5f}")
    if attn_layers:
        pl = res[False]
        gap = abs(on["loss"] - pl["loss"]) / abs(pl["loss"])
        out.update(loss_plain=pl["loss"], plain_ms=pl["ms"],
                   plain_peak_gb=pl["peak_gb"], loss_rel_gap=gap)
        line += (f"; plain {pl['ms']:.1f} ms, {pl['peak_gb']:.2f} GB, loss "
                 f"{pl['loss']:.5f} (relative gap {gap:.2e}, tol "
                 f"{FAMILY_LOSS_REL_TOL:g})")
        check(gap <= FAMILY_LOSS_REL_TOL, f"{cfg.name} loss flash vs "
              f"plain: relative gap {gap:.3e}")
    print(line, flush=True)
    if profile:
        out["busy_ms"] = _print_device_kernels(
            _device_profile(lambda: _client_grad(cfg, params, batch)),
            f"one more {cfg.name} gradient", on["ms"], top=8)
    return out


def _scan_share(dev, seed, cfg, params, batch, grad_ms) -> dict:
    """The selective scan's share of hymba's gradient: one ``ssm_scan``
    forward and backward at a layer's shape (bf16 inputs, as the layer
    gives them, chunks of ``scan_chunk`` under checkpoint), its event ms
    times n_layers over the gradient's event ms; its device kernels and
    idle share from a profile."""
    T, Di, N = _positions(cfg, batch), cfg.d_model, cfg.ssm_state
    gen = torch.Generator(device=dev).manual_seed(seed + 16)

    def leaf(*shape, softplus=False):
        x = torch.randn(*shape, generator=gen, device=dev)
        return (F.softplus(x) if softplus else x).to(
            torch.bfloat16).requires_grad_()

    u, dt = leaf(1, T, Di), leaf(1, T, Di, softplus=True)
    Bm, Cm = leaf(1, T, N), leaf(1, T, N)
    A_log = params["blocks"]["m_A"][0].detach().requires_grad_()
    D = params["blocks"]["m_D"][0].detach().requires_grad_()
    gy = torch.randn(1, T, Di, generator=gen, device=dev).to(torch.bfloat16)
    inputs = [u, dt, Bm, Cm, A_log, D]

    def fwd_bwd():
        y, _ = ssm_lib.ssm_scan(u, dt, Bm, Cm, A_log, D,
                                chunk=cfg.scan_chunk,
                                scan_f32=cfg.ssm_scan_f32)
        return torch.autograd.grad(y, inputs, gy)

    fwd_bwd()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fwd_bwd()
    end.record()
    torch.cuda.synchronize()
    scan_ms = start.elapsed_time(end)
    busy = _print_device_kernels(_device_profile(fwd_bwd),
                                 "one ssm_scan forward and backward",
                                 scan_ms, top=4)
    out = dict(scan_ms=scan_ms, scan_busy_ms=busy,
               ms_share=cfg.n_layers * scan_ms / grad_ms)
    print(f"  {cfg.name}: one layer's ssm_scan forward and backward at (1, "
          f"{T}, {Di}, {N}) {scan_ms:.2f} ms ({busy:.2f} ms busy); x "
          f"{cfg.n_layers} layers: {100 * out['ms_share']:.1f}% of the "
          f"gradient's {grad_ms:.1f} ms", flush=True)
    return out


def _greedy(params, cfg, prompt, new: int) -> torch.Tensor:
    """``new`` greedy tokens by ``decode_step`` from the prompt's prefill
    cache (one copy, in the params' dtype, as ``_family_beam`` keeps
    it)."""
    total = prompt.shape[0] + new
    logits, cache = sampling.prefill_cache(
        params, cfg, prompt, 1, total, cache_dtype=tr.DTYPES[cfg.dtype])
    tok = logits[0, -1].argmax()
    out = [tok]
    for pos in range(prompt.shape[0], total - 1):
        logits, cache = tr.decode_step(params, cfg, cache, tok.view(1, 1),
                                       pos)
        tok = logits[0, 0].argmax()
        out.append(tok)
    return torch.stack(out).to(torch.int32)


def _family_beam(dev, seed, cfg, params) -> dict:
    """``beam_search`` with BEAM_WIDTH beams and BEAM_NEW new tokens on a
    BEAM_PROMPT-token prompt, timed; its 1-beam result equal to greedy
    ``decode_step`` tokens.  The K/V cache is bf16, as the params: an f32
    one would promote the residual stream, which the reference's layer
    scan refuses and so does the port."""
    prompt = lm_token_batches(random.fold_in(random.PRNGKey(seed), 6), 1, 1,
                              BEAM_PROMPT, cfg.vocab, device=dev)[0][0]
    out = {}
    for beams in (BEAM_WIDTH, 1):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        toks, score = sampling.beam_search(
            params, cfg, prompt, n_beams=beams, max_new_tokens=BEAM_NEW,
            cache_dtype=tr.DTYPES[cfg.dtype])
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        check(toks.shape == (BEAM_NEW,) and bool((toks >= 0).all())
              and bool((toks < cfg.vocab).all())
              and math.isfinite(float(score)),
              f"{cfg.name} beam_search({beams}): {toks.tolist()}, {score}")
        out[beams] = dict(seconds=secs, score=float(score),
                          tokens=toks.tolist())
    greedy = _greedy(params, cfg, prompt, BEAM_NEW)
    check(greedy.tolist() == out[1]["tokens"], f"{cfg.name}: 1-beam tokens "
          f"{out[1]['tokens']} != greedy {greedy.tolist()}")
    wide = out[BEAM_WIDTH]
    print(f"  {cfg.name} beam_search on {BEAM_PROMPT} prompt tokens, "
          f"{BEAM_NEW} new: {BEAM_WIDTH} beams {wide['seconds']:.2f} s "
          f"(score {wide['score']:.4f}), 1 beam "
          f"{out[1]['seconds']:.2f} s == greedy decode_step tokens",
          flush=True)
    return {f"beams_{k}": v for k, v in out.items()}


def _recurrent_part(dev, seed, arch, totals) -> dict:
    """(a) xlstm-350m, (b) hymba-1.5b at full width (hymba at
    FAMILY_LAYERS): init, the 1 x 2048 gradient (hymba: flash on and off,
    the scan's share), beam_search, two int8 rounds."""
    cfg = get_config(arch)
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    check(cfg.dtype == "bfloat16" and cfg.flash_attention,
          f"{arch}: {cfg.dtype}, flash {cfg.flash_attention}")
    attn = 0 if cfg.family == "ssm" else cfg.n_layers
    _expect_free_card(f"before {arch}")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    params = tr.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    count = sum(t.numel() for t in _leaves(params))
    print(f"  {arch}: {count} params ({cfg.dtype}) made in "
          f"{time.monotonic() - t0:.2f} s", flush=True)
    res = {"params": count}
    secs = {"init": time.monotonic() - t0}
    t0 = time.monotonic()
    batch = _family_batch(dev, seed, cfg, (1,), FAMILY_CONTEXT)
    # hymba's ~260,000 kernels a gradient are profiled through its scan
    # alone
    hybrid = cfg.family == "hybrid"
    res["gradient"] = _family_grad(cfg, params, batch, attn, totals,
                                   profile=not hybrid)
    secs["gradient"] = time.monotonic() - t0
    if hybrid:
        t0 = time.monotonic()
        res["scan"] = _scan_share(dev, seed, cfg, params, batch,
                                  res["gradient"]["flash_ms"])
        secs["scan"] = time.monotonic() - t0
    t0 = time.monotonic()
    res["beam"] = _family_beam(dev, seed, cfg, params)
    secs["beam"] = time.monotonic() - t0
    del params, batch
    t0 = time.monotonic()
    res["round"] = _matrix_config(
        dev, seed, cfg, f"{arch} eris int8", dict(method="eris",
                                                  int8_wire=True), 2,
        totals, flash_layers=attn)
    secs["round"] = time.monotonic() - t0
    res["seconds"] = secs
    print(f"  {arch} seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in secs.items()))
    return res


def _vlm_part(dev, seed, totals) -> dict:
    """(c) internvl2-26b at full width and reduced depth: a gradient at
    VLM_GRAD_LAYERS layers flash on and off, ``beam_search`` refused for
    want of an image, two int8 rounds at VLM_ROUND_LAYERS, each client
    with its own images."""
    full = get_config(VLM_ARCH)
    check(full.dtype == "bfloat16" and full.flash_attention,
          f"{VLM_ARCH}: {full.dtype}, flash {full.flash_attention}")
    cfg = dataclasses.replace(full, n_layers=VLM_GRAD_LAYERS)
    _expect_free_card(f"before {VLM_ARCH}")
    params = tr.init_params(cfg, seed=seed, device=dev)
    res = {"params": sum(t.numel() for t in _leaves(params))}
    batch = _family_batch(dev, seed, cfg, (1,), VLM_TEXT)
    res["gradient"] = _family_grad(cfg, params, batch, cfg.n_layers, totals,
                                   profile=True)
    try:
        sampling.beam_search(params, cfg, batch["tokens"][0])
    except ValueError as e:
        refused = str(e)
    else:
        refused = None
    check(refused is not None and "frontend_embeds" in refused,
          f"{VLM_ARCH}: beam_search on a text prompt did not refuse")
    print(f"  {VLM_ARCH}: beam_search refused: {refused}", flush=True)
    del params, batch
    cut = dataclasses.replace(full, n_layers=VLM_ROUND_LAYERS)
    batches = _family_batch(dev, seed, cut, (K_CLIENTS, BATCH), VLM_TEXT)
    res["round"] = _matrix_config(
        dev, seed, cut, f"{VLM_ARCH} {VLM_ROUND_LAYERS} layers eris int8",
        dict(method="eris", int8_wire=True), 2, totals, batches=batches)
    return res


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _named_grads(cfg, params, batch) -> tuple:
    """The loss and every leaf's gradient by its path in the tree."""
    names = [name for name, _ in _named_leaves(params)]
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = tr.loss_fn(tree_unflatten(params, leaves), cfg, batch)
    return float(loss.detach()), dict(zip(
        names, torch.autograd.grad(loss, leaves)))


def _named_leaves(tree, prefix=""):
    """(path, leaf) in ``tree_leaves`` order: keys sorted, depth first."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named_leaves(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


def _family_smoke(dev, seed) -> dict:
    """(d) each family's smoke variant in f32, card vs host from the same
    params and batch: the loss and every gradient leaf, the prefill
    logits and caches, and ``beam_search``'s tokens and score (vlm: both
    refuse).  xlstm's ``b_i`` gradient is zero but for rounding (a
    constant shift of a head's input gate changes nothing), so it is held
    against ``w_i``'s scale."""
    worst = {}
    for arch in FAMILY_ARCHS + (VLM_ARCH,):
        cfg = get_config(arch).smoke()
        host = tr.init_params(cfg, seed=seed, device="cpu")
        card = tree_map(lambda t: t.to(dev), host)
        text = FAMILY_SMOKE_POSITIONS - (cfg.n_frontend_tokens
                                         if cfg.frontend == "vlm" else 0)
        hb = _family_batch("cpu", seed, cfg, (FAMILY_SMOKE_BATCH,), text)
        cb = {k: v.to(dev) for k, v in hb.items()}
        errs = {}
        (lc, gcard), (lh, ghost) = (_named_grads(cfg, card, cb),
                                    _named_grads(cfg, host, hb))
        errs["loss"] = abs(lc - lh) / abs(lh)
        for name, g in ghost.items():
            if name == "blocks/b_i":
                errs[name] = float((gcard[name].cpu() - g).norm()
                                   / ghost["blocks/w_i"].norm())
            else:
                errs[name] = _rel_err(gcard[name], g)
        outs = []
        for params, b in ((card, cb), (host, hb)):
            outs.append(tr.forward(params, cfg, b["tokens"], "prefill",
                                   frontend_embeds=b.get("frontend_embeds")))
        errs["prefill logits"] = _rel_err(outs[0][0], outs[1][0])
        hc = dict(_named_leaves(outs[1][1]))
        for name, c in _named_leaves(outs[0][1]):
            errs[f"cache {name}"] = _rel_err(c, hc[name])
        if cfg.frontend == "vlm":
            for params, b in ((card, cb), (host, hb)):
                try:
                    sampling.beam_search(params, cfg, b["tokens"][0])
                except ValueError:
                    continue
                check(False, f"{arch} smoke: beam_search did not refuse")
        else:
            bc = sampling.beam_search(card, cfg, cb["tokens"][0],
                                      n_beams=BEAM_WIDTH,
                                      max_new_tokens=FAMILY_SMOKE_NEW)
            bh = sampling.beam_search(host, cfg, hb["tokens"][0],
                                      n_beams=BEAM_WIDTH,
                                      max_new_tokens=FAMILY_SMOKE_NEW)
            check(bc[0].tolist() == bh[0].tolist(), f"{arch} smoke: beam "
                  f"tokens card {bc[0].tolist()} != host {bh[0].tolist()}")
            errs["beam score"] = abs(float(bc[1]) - float(bh[1])) / abs(
                float(bh[1]))
        name, err = max(errs.items(), key=lambda kv: kv[1])
        check(err <= FAMILY_SMOKE_TOL, f"{arch} smoke card vs host: {name} "
              f"relative error {err:.3e}")
        worst[arch] = dict(worst=name, rel=err, checked=len(errs))
        print(f"  {arch} smoke f32 card vs host: loss, {len(ghost)} gradient "
              f"leaves, prefill logits and caches"
              f"{'' if cfg.frontend == 'vlm' else ', beam tokens and score'}"
              f" within {err:.2e} (largest: {name}; tol "
              f"{FAMILY_SMOKE_TOL:g})", flush=True)
    return worst


def family_phase(dev, seed) -> dict:
    """Phase 15: the recurrent and vision families.  Returns the round
    kernels' launches over (a)-(c): the gradients' flash launches and the
    rounds'."""
    parts, results = {}, {}
    totals = {name: 0 for name in ROUND}
    for label, arch in zip(("a", "b"), FAMILY_ARCHS):
        t0 = time.monotonic()
        results[arch] = _recurrent_part(dev, seed, arch, totals)
        parts[f"{label} {arch}"] = time.monotonic() - t0
    t0 = time.monotonic()
    results[VLM_ARCH] = _vlm_part(dev, seed, totals)
    parts[f"c {VLM_ARCH}"] = time.monotonic() - t0
    _expect_free_card("after the families' rounds")
    t0 = time.monotonic()
    results["smoke"] = _family_smoke(dev, seed)
    parts["d smoke card vs host"] = time.monotonic() - t0
    _set_round_launches(0)
    results["seconds"] = parts
    print("families " + json.dumps(results))
    print("  phase 15 seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return totals


# --------------------------------------------------------------- phase 16
# The model axis (tensor, sequence, context and expert parallelism) on
# the one card: ranks are processes on cuda:0 over process groups whose
# backend the phase chooses, gloo (NCCL refuses two ranks on one device);
# every collective of a CUDA tensor then goes through host buffers
# (dist/collectives.py), so its times are host staging, not NVLink.  The
# compute (matmuls, the flash and wire kernels) stays on the card.
# (a) 2 ranks: (arch, layers (None = all), tokens, tp) gradient parity,
# TP against the same model replicated on the card, f32; then the step.
# eris-gptneo-1.3b runs at full width and AXIS_LAYERS of its 24 layers
# here, in phase 17 (4 a stage) and in the checkpoint phase 18 serves: the
# axes' collectives, plans and gates are the same at every depth, and at
# 24 the ranks' gradients, steps and checkpoint took ~150 s of the script
# (NVIDIA H100 80GB HBM3, 700.00 W).
AXIS_LAYERS = 8
TP_PARITY_A = (("eris-gptneo-1.3b", AXIS_LAYERS, 512, 2),
               ("olmoe-1b-7b", 4, 128, 2),
               ("hymba-1.5b", 4, 256, 2))
# (b) 4 ranks; qwen2-0.5b at AXIS_LAYERS of its 24 too: under remat its
# ring attention ships K/V again in the backward, and at 24 layers its TP
# gradient took 6.8 s (NVIDIA H100 80GB HBM3, 700.00 W)
TP_PARITY_B = (("qwen2-0.5b", AXIS_LAYERS, 512, 4),)
# the reference's own gates (tests/test_tp.py): the loss's relative error,
# each merged leaf's max |error| over max(max |g|, 1e-4)
TP_LOSS_TOL, TP_GRAD_TOL = 1e-5, 1e-3
TP_STEP_LR, TP_STEPS = 1e-5, 3
TP_STEP_CONFIG = TRAIN_CONFIGS[1]          # (b) dsc int8 fused


def _tp_env(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class TopKPin:
    """Records every ``sorted_top_k`` call's experts (layer order) of a
    replicated run; with ``pin`` (that list) and this rank's model index,
    each call of an expert-parallel run returns the replicated run's
    experts for this rank's token groups (their gates gathered from its
    own probabilities, so the router keeps its gradient) and counts the
    (token, choice) pairs where its own would differ."""

    def __init__(self, pin=None, index: int = 0):
        self.pin, self.index = pin, index

    def __enter__(self):
        self.idxs, self.flips = [], 0
        self._saved = moe_lib.sorted_top_k
        top_k = self._saved

        def spy(x, k):
            vals, idx = top_k(x, k)
            if self.pin is not None:
                rep = self.pin[len(self.idxs)]
                gl = x.shape[0]
                lo = self.index * gl
                rows = max(0, min(gl, rep.shape[0] - lo))
                own = idx
                idx = idx.clone()
                idx[:rows] = rep[lo:lo + rows]
                self.flips += int((own[:rows] != idx[:rows]).sum())
                vals = x.gather(-1, idx)
            self.idxs.append(idx.detach().clone())
            return vals, idx

        moe_lib.sorted_top_k = spy
        return self

    def __exit__(self, *exc):
        moe_lib.sorted_top_k = self._saved


def _tp_parity(dev, seed, rank, arch, layers, tokens, tp, group) -> dict:
    """One gradient of ``arch`` at full width (``layers`` of it), f32,
    replicated and at tp on this rank's model group: the loss's relative
    error and each merged leaf's, with the TP gradient's ms, launches and
    peak."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as cl
    from repro_torch.dist import sharding as sh
    from repro_torch.models import shard_plan as sp
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    plan = sp.build_plan(cfg, tp)
    check(plan.active, f"{arch} at tp {tp}: no plan")
    idx = rank % tp
    specs = tree_leaves(sh.tp_specs(cfg, tp))
    toks = lm_token_batches(random.fold_in(random.PRNGKey(seed), 16), 1, 1,
                            tokens, cfg.vocab, device=dev)[0]
    params = tr.init_params(cfg, seed=seed, device=dev)
    template = sh.shape_tree(cfg, lambda s: None)
    # the replicated gradient on the card; this rank keeps its shards
    with TopKPin() as rec:
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss = tr.loss_fn(tree_unflatten(template, leaves), cfg,
                          {"tokens": toks})
        grads = torch.autograd.grad(loss, leaves)
    rep_loss = float(loss.detach())
    ref = [sh.tp_shard(g, s, tp, idx).clone() for g, s in zip(grads, specs)]
    local = [sh.tp_shard(p, s, tp, idx).clone()
             for p, s in zip(tree_leaves(params), specs)]
    del grads, leaves, loss, params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier(group)
    # the TP gradient: the path whose launches count
    rt = sp.TPRuntime(group, tp, idx, plan)
    _set_round_launches(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = _event_pair()
    with TopKPin(rec.idxs, idx) as pin:
        start.record()
        leaves = [t.requires_grad_() for t in local]
        loss = tr.loss_fn(tree_unflatten(template, leaves), cfg,
                          {"tokens": toks}, tp=rt)
        grads = sh.tp_grad_sync(list(torch.autograd.grad(loss, leaves)),
                                specs, rt)
        end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: FLASH[k].launches for k in FLASH}
    f32_tc = [fn.f32_tensor_core_launches for fn in TENSOR_CORE]
    flash = tr.uses_flash_kernel(cfg, tokens) and plan.attn
    want = _flash_want(cfg, cfg.n_layers if flash else 0)
    check(launches == want and f32_tc == list(want.values()),
          f"{arch} tp {tp}: flash launches {launches} (f32 tensor cores "
          f"{f32_tc}), want {want}")
    loss_err = abs(float(loss.detach()) - rep_loss) / abs(rep_loss)
    worst, worst_leaf = 0.0, None
    names = [".".join(p) for p, _ in sh.spec_items(cfg)]
    for g, r, s, name in zip(grads, ref, specs, names):
        pair = torch.stack([(g - r).abs().max(), r.abs().max()])
        if s.dim >= 0:           # the leaf's max over its shards
            pair = cl.all_reduce(pair, group, dist.ReduceOp.MAX)
        err = float(pair[0]) / max(float(pair[1]), 1e-4)
        if err > worst:
            worst, worst_leaf = err, name
    head = (f"  rank {rank}: {arch}" + (f" at {layers} layers" if layers
                                        else "") +
            f", 1 x {tokens} tokens, tp {tp} {plan}")
    print(f"{head}\n  rank {rank}:   loss {rep_loss:.6f} replicated, "
          f"relative error {loss_err:.3e} (tol {TP_LOSS_TOL:g})\n"
          f"  rank {rank}:   worst leaf {worst_leaf} {worst:.3e} of its max "
          f"|g| (tol {TP_GRAD_TOL:g}); route flips pinned {pin.flips}\n"
          f"  rank {rank}:   TP gradient {ms:.1f} ms, flash launches "
          f"{launches}, peak {peak:.2f} GB (this rank)", flush=True)
    check(loss_err <= TP_LOSS_TOL and worst <= TP_GRAD_TOL,
          f"{arch} tp {tp}: loss {loss_err:.3e}, worst leaf {worst_leaf} "
          f"{worst:.3e}")
    return dict(loss_err=loss_err, worst_leaf=worst_leaf, grad_err=worst,
                ms=ms, peak_gb=peak, launches=launches, flips=pin.flips)


def _tp_step(dev, seed, rank) -> dict:
    """Three steps of eris-gptneo-1.3b at full width and AXIS_LAYERS at
    (data 1, model 2), phase 11's DSC fused int8 settings, adam lr 1e-5:
    the loss finite and falling, the wire kernels once a leaf a step, the
    flash kernels n_layers a step at the TP-local head counts."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.optim import adam
    cfg = dataclasses.replace(get_config("eris-gptneo-1.3b"),
                              n_layers=AXIS_LAYERS)
    mesh = mesh_lib.make_host_mesh(data=1, model=2, device=dev)
    name, fields, wire = TP_STEP_CONFIG
    settings = train.TrainSettings(**fields)
    opt = adam(TP_STEP_LR)
    step = train.make_train_step(cfg, mesh, opt, settings, device=dev)
    params = train.store_params(tr.init_params(cfg, seed=seed, device=dev),
                                cfg, mesh, settings)
    gc.collect()
    torch.cuda.empty_cache()
    state = opt.init(params)
    dsc_ref = train.init_dsc_state(cfg, mesh, settings, device=dev)
    toks = lm_token_batches(random.PRNGKey(0), 1, TRAIN_BATCH, TRAIN_SEQ,
                            cfg.vocab, device=dev)[0]
    n_leaves = len(tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _set_round_launches(0)
    losses, ms = [], []
    # step 1 runs under an account (phase 19 holds it to its dry run)
    acc = Account(mesh, dev, inputs=(params, state, dsc_ref, toks))
    for i in range(TP_STEPS):
        start, end = _event_pair()
        with acc if i == 0 else contextlib.nullcontext():
            start.record()
            params, state, dsc_ref, m = step(params, state, dsc_ref,
                                             {"tokens": toks},
                                             random.PRNGKey(i))
            end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    launches = {k: fn.launches for k, fn in ROUND.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  rank {rank}: step {name} at (data 1, model 2), adam lr "
          f"{TP_STEP_LR}: losses {losses}, ms {[round(x, 1) for x in ms]} "
          f"(step 1 under the account), "
          f"launches {launches}, peak {peak:.2f} GB (this rank)",
          flush=True)
    check(all(math.isfinite(x) for x in losses) and
          all(b < a for a, b in zip(losses, losses[1:])),
          f"TP step losses {losses}: not finite and falling")
    for k in wire:
        check(launches[k] == n_leaves * TP_STEPS,
              f"TP step: {k} launched {launches[k]}, want {n_leaves} a "
              f"step")
    want = _flash_want(cfg, cfg.n_layers * TP_STEPS)
    for k in FLASH:
        check(launches[k] == want[k],
              f"TP step: {k} launched {launches[k]}, want {want[k]}")
    del params, state, dsc_ref
    return dict(losses=losses, ms=ms, peak_gb=peak, launches=launches,
                account=acc.record())


def _smoke_run(d, seed, mesh, settings) -> tuple:
    """Two sgd steps of the smoke variant in f32 on device ``d`` over
    ``mesh``'s gloo groups, from ``init_params(seed)`` and the keys 0 and
    1.  Returns the rank's params after them, flat on the host, and the
    losses."""
    from repro_torch.launch import train
    from repro_torch.optim import sgd
    cfg = fl_train.model_config("eris-gptneo-1.3b", full=False)
    toks = lm_token_batches(random.PRNGKey(0), 1, TRAIN_BATCH, TRAIN_SEQ,
                            cfg.vocab)[0]
    opt = sgd(TRAIN_SMOKE_LR)
    step = train.make_train_step(cfg, mesh, opt, settings, device=d)
    params = tree_map(lambda t: t.to(d), train.store_params(
        tr.init_params(cfg, seed=seed, device="cpu"), cfg, mesh, settings))
    state = opt.init(params)
    dsc_ref = train.init_dsc_state(cfg, mesh, settings, device=d)
    losses = []
    for i in range(2):
        params, state, dsc_ref, m = step(params, state, dsc_ref,
                                         {"tokens": toks.to(d)},
                                         random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return torch.cat([t.reshape(-1).float().cpu()
                      for t in tree_leaves(params)]), losses


def _smoke_steps(dev, seed, mesh, settings) -> tuple:
    """:func:`_smoke_run` on the card and on the host.  Returns the
    params' relative error card vs host over every rank's pieces, the
    losses' largest, and the card's losses.  The host pass runs on one
    thread: at the process's default, the ranks' host reductions split by
    the load and the host's params move about 3e-7 (relative) from one
    run to the next (``tools/smoke_repeat.py``); on one thread they
    repeat bit for bit, as the card's do."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as cl
    cx, closs = _smoke_run(dev, seed, mesh, settings)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    hx, hloss = _smoke_run(torch.device("cpu"), seed, mesh, settings)
    torch.set_num_threads(threads)
    # the norms over every rank's pieces
    sums = cl.all_reduce(torch.stack([(cx - hx).square().sum(),
                                      hx.square().sum()]).double(),
                         dist.group.WORLD)
    rel = float(sums[0].sqrt() / sums[1].sqrt())
    lrel = max(abs(a - b) / abs(b) for a, b in zip(closs, hloss))
    return rel, lrel, closs


def _tp_smoke(dev, seed, rank) -> dict:
    """The smoke variant at (data 2, model 2) on the int8 wire
    (:func:`_smoke_steps`): params and losses within TRAIN_SMOKE_TOL."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    mesh = mesh_lib.make_host_mesh(data=2, model=2, device=dev)
    settings = train.TrainSettings(grad_dtype="float32", int8_wire=True)
    rel, lrel, _ = _smoke_steps(dev, seed, mesh, settings)
    if rank == 0:
        print(f"  smoke int8 at (data 2, model 2): 2 sgd steps, params card "
              f"vs host {rel:.3e}, losses {lrel:.3e} (tol "
              f"{TRAIN_SMOKE_TOL})", flush=True)
    check(rel <= TRAIN_SMOKE_TOL and lrel <= TRAIN_SMOKE_TOL,
          f"TP smoke int8: params card vs host {rel:.3e}, losses "
          f"{lrel:.3e}")
    return dict(params_rel=rel, loss_rel=lrel)


def _tp_rank(rank: int, world: int, port: int, part: str, seed: int,
             out_dir: str) -> None:
    """One rank of the phase, in its own process on cuda:0."""
    _tp_env(rank, world, port)
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    dev = mesh_lib.init_process_group("cuda", backend="gloo")
    t0 = time.monotonic()
    res = {"backend": str(dist.get_backend()), "cases": {}}
    try:
        world_group = dist.group.WORLD
        cases = {"a": TP_PARITY_A, "b": TP_PARITY_B, "step": ()}[part]
        for arch, layers, tokens, tp in cases:
            res["cases"][arch] = _tp_parity(dev, seed, rank, arch, layers,
                                            tokens, tp, world_group)
            gc.collect()
            torch.cuda.empty_cache()
        if part in ("a", "step"):
            res["step"] = _tp_step(dev, seed, rank)
        else:
            res["smoke"] = _tp_smoke(dev, seed, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.monotonic() - t0
    pathlib.Path(out_dir, f"{part}{rank}.json").write_text(json.dumps(res))


def model_axis_phase(dev, seed) -> tuple:
    """Phase 16: (a) two ranks, (b) four, each a ``torch.multiprocessing``
    launch of processes on cuda:0 over gloo groups.  Returns the main
    path's launches (the TP gradients and steps of (a), summed over
    ranks) and rank 0's account of (a)'s first step."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.launch import mesh as mesh_lib
    _expect_free_card("before the model axis")
    print("  the model groups run over gloo on one card: every rank is a "
          "process on cuda:0 and the caller chose backend='gloo' (NCCL "
          "refuses two ranks on one device), so every collective of a CUDA "
          "tensor is staged through host buffers; its times are host "
          "staging, not NVLink", flush=True)
    totals = {name: 0 for name in ROUND}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        for part, world in (("a", 2), ("b", 4)):
            t0 = time.monotonic()
            mp.spawn(_tp_rank, args=(world, mesh_lib.free_port(), part,
                                     seed, out), nprocs=world, join=True)
            ranks = [json.loads(pathlib.Path(out, f"{part}{r}.json")
                                .read_text()) for r in range(world)]
            check(all(r["backend"] == "gloo" for r in ranks),
                  f"model axis ({part}): backends "
                  f"{[r['backend'] for r in ranks]}")
            print(f"  ({part}) {world} ranks in {time.monotonic() - t0:.1f} "
                  f"s (each rank's own: "
                  f"{[round(r['seconds'], 1) for r in ranks]})", flush=True)
            print("model_axis " + json.dumps({part: ranks}), flush=True)
            for r in ranks:
                for case in r["cases"].values():
                    for k, n in case["launches"].items():
                        totals[k] += n
                for k, n in r.get("step", {}).get("launches", {}).items():
                    totals[k] += n
            if part == "a":
                account = ranks[0]["step"]["account"]
    return totals, account


def _tp_step_account(dev, seed) -> dict:
    """Rank 0's account of phase 16 (a)'s first step, from a two-rank
    launch of that step alone (``--only 19`` without 16)."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.launch import mesh as mesh_lib
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        mp.spawn(_tp_rank, args=(2, mesh_lib.free_port(), "step", seed,
                                 out), nprocs=2, join=True)
        return json.loads(pathlib.Path(out, "step0.json").read_text())[
            "step"]["account"]


# ------------------------------------------------------------------ phase 17
# The pipe axis on one card, as phase 16 runs the model axis: ranks are
# processes on cuda:0 over gloo groups (every collective of a CUDA tensor
# staged through the host), the compute on the card.  (a) two ranks:
# (arch, layers (None = all), batch, tokens, pipe, model, microbatches)
# gradient parity, the pipelined gradient against the same model
# replicated on the card, f32; then the step, its composite checkpoint,
# and serving from it in this process.  (b) four ranks.
PIPE_PARITY_A = ("eris-gptneo-1.3b", AXIS_LAYERS, 4, 512, 2, 1, 4)
PIPE_PARITY_B = ("qwen2-0.5b", AXIS_LAYERS, 2, 512, 2, 2, 2)
PIPE_STEP_LR, PIPE_STEPS, PIPE_STEP_MB = 1e-5, 3, 4
PIPE_STEP_CONFIG = TRAIN_CONFIGS[1]         # (b) dsc int8 fused
PIPE_SERVE_REQUESTS, PIPE_SERVE_GEN = 4, 16
# the smoke int8 step at (data 2, pipe 2), card vs host: params and
# losses within this relative error
PIPE_SMOKE_TOL = 1e-6


def _axis_gptneo():
    """eris-gptneo-1.3b at full width and AXIS_LAYERS: phase 17's step,
    its checkpoint and the engines phases 17 and 18 serve from it."""
    return dataclasses.replace(get_config("eris-gptneo-1.3b"),
                               n_layers=AXIS_LAYERS)


def _pipe_mesh(dev, data: int, pipe: int, model: int):
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.make_host_mesh(data=data, pipe=pipe, model=model,
                                   device=dev)


def _pipe_parity(dev, seed, rank, case, mesh) -> dict:
    """One gradient of the case's model at full width, f32: replicated on
    the card, then pipelined at (1, pipe, model) on this rank's stage and
    model position: the loss's relative error, each merged leaf's, the
    pipelined gradient's ms, launches and peak."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as cl
    from repro_torch.dist import sharding as sh
    from repro_torch.models import shard_plan as sp
    arch, layers, batch, tokens, pipe, tp, mb = case
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    plan = sp.build_plan(cfg, tp)
    pplan = sp.build_pipeline_plan(cfg, pipe, mb)
    check(pplan.active and (tp == 1 or plan.active),
          f"{arch} at pipe {pipe}, tp {tp}: no plan")
    s, j = sh.axis_rank(mesh, "pipe"), sh.axis_rank(mesh, "model")
    specs = tree_leaves(sh.tp_specs(cfg, tp))
    pdims = tree_leaves(sh.pipe_dims(cfg, pipe))
    cuts = [((pd, pipe, s), (t.dim, tp, j)) for t, pd in zip(specs, pdims)]
    toks = lm_token_batches(random.fold_in(random.PRNGKey(seed), 17), 1,
                            batch, tokens, cfg.vocab, device=dev)[0]
    params = tr.init_params(cfg, seed=seed, device=dev)
    template = sh.shape_tree(cfg, lambda shape: None)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = tr.loss_fn(tree_unflatten(template, leaves), cfg,
                      {"tokens": toks})
    grads = torch.autograd.grad(loss, leaves)
    rep_loss = float(loss.detach())
    ref = [sh.cut_piece(g, c).clone() for g, c in zip(grads, cuts)]
    local = [sh.cut_piece(p, c).clone()
             for p, c in zip(tree_leaves(params), cuts)]
    del grads, leaves, loss, params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    tp_rt = (sp.TPRuntime(mesh.get_group("model"), tp, j, plan)
             if tp > 1 else None)
    pipe_rt = sp.PipeRuntime(mesh.get_group("pipe"), pipe, s, pplan)
    _set_round_launches(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = _event_pair()
    start.record()
    leaves = [t.requires_grad_() for t in local]
    loss = tr.pipeline_loss_fn(tree_unflatten(template, leaves), cfg,
                               {"tokens": toks}, tp=tp_rt, pipe=pipe_rt)
    grads = list(torch.autograd.grad(loss, leaves))
    if tp_rt is not None:
        grads = sh.tp_grad_sync(grads, specs, tp_rt)
    grads = sh.pipe_grad_sync(grads, pdims, pipe_rt)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: FLASH[k].launches for k in FLASH}
    f32_tc = [fn.f32_tensor_core_launches for fn in TENSOR_CORE]
    flash = tr.uses_flash_kernel(cfg, tokens) and (tp == 1 or plan.attn)
    # every tick runs the stage's layers both ways, valid or not
    want = _flash_want(cfg, pplan.layers_per_stage * (mb + pipe - 1)
                       if flash else 0)
    check(launches == want and f32_tc == list(want.values()),
          f"{arch} pipe {pipe} tp {tp}: flash launches {launches} (f32 "
          f"tensor cores {f32_tc}), want {want}")
    loss_err = abs(float(loss.detach()) - rep_loss) / abs(rep_loss)
    worst, worst_leaf = 0.0, None
    names = [".".join(p) for p, _ in sh.spec_items(cfg)]
    for g, r, name in zip(grads, ref, names):
        pair = cl.all_reduce(torch.stack([(g - r).abs().max(),
                                          r.abs().max()]),
                             dist.group.WORLD, dist.ReduceOp.MAX)
        err = float(pair[0]) / max(float(pair[1]), 1e-4)
        if err > worst:
            worst, worst_leaf = err, name
    print(f"  rank {rank}: {arch}, {batch} x {tokens} tokens, pipe {pipe} "
          f"({pplan.layers_per_stage} layers a stage), tp {tp}, "
          f"microbatches {mb}\n"
          f"  rank {rank}:   loss {rep_loss:.6f} replicated, relative error "
          f"{loss_err:.3e} (tol {TP_LOSS_TOL:g}); worst leaf {worst_leaf} "
          f"{worst:.3e} of its max |g| (tol {TP_GRAD_TOL:g})\n"
          f"  rank {rank}:   pipelined gradient {ms:.1f} ms, flash launches "
          f"{launches}, peak {peak:.2f} GB (this rank)", flush=True)
    check(loss_err <= TP_LOSS_TOL and worst <= TP_GRAD_TOL,
          f"{arch} pipe {pipe} tp {tp}: loss {loss_err:.3e}, worst leaf "
          f"{worst_leaf} {worst:.3e}")
    return dict(loss_err=loss_err, worst_leaf=worst_leaf, grad_err=worst,
                ms=ms, peak_gb=peak, launches=launches)


def _pipe_step(dev, seed, rank, mesh, out_dir) -> dict:
    """Three steps of eris-gptneo-1.3b at full width and AXIS_LAYERS at
    (data 1, pipe 2), phase 11's DSC fused int8 settings, bf16 params,
    adam lr 1e-5, 8 x 64 in 4 microbatches: the loss finite and falling,
    the wire kernels once a leaf a step, the flash kernels (a stage's
    layers) x 5 ticks a step; then the composite checkpoint under
    ``out_dir`` and this rank's pieces beside it (for the merged
    engine)."""
    from repro_torch.checkpoint import msgpack_ckpt as ck
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import train
    from repro_torch.optim import adam
    cfg = _axis_gptneo()
    name, fields, wire = PIPE_STEP_CONFIG
    settings = train.TrainSettings(microbatches=PIPE_STEP_MB, **fields)
    opt = adam(PIPE_STEP_LR)
    step = train.make_train_step(cfg, mesh, opt, settings, device=dev)
    params = train.store_params(tr.init_params(cfg, seed=seed, device=dev),
                                cfg, mesh, settings)
    gc.collect()
    torch.cuda.empty_cache()
    state = opt.init(params)
    dsc_ref = train.init_dsc_state(cfg, mesh, settings, device=dev)
    toks = lm_token_batches(random.PRNGKey(0), 1, TRAIN_BATCH, TRAIN_SEQ,
                            cfg.vocab, device=dev)[0]
    n_leaves = len(tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _set_round_launches(0)
    losses, ms = [], []
    for i in range(PIPE_STEPS):
        start, end = _event_pair()
        start.record()
        params, state, dsc_ref, m = step(params, state, dsc_ref,
                                         {"tokens": toks}, random.PRNGKey(i))
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    launches = {k: fn.launches for k, fn in ROUND.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    lps = cfg.n_layers // 2
    print(f"  rank {rank}: step {name} at (data 1, pipe 2), microbatches "
          f"{PIPE_STEP_MB}, adam lr {PIPE_STEP_LR}: losses {losses}, ms "
          f"{[round(x, 1) for x in ms]}, launches {launches}, peak "
          f"{peak:.2f} GB (this rank)", flush=True)
    check(all(math.isfinite(x) for x in losses) and
          all(b < a for a, b in zip(losses, losses[1:])),
          f"pipe step losses {losses}: not finite and falling")
    for k in wire:
        check(launches[k] == n_leaves * PIPE_STEPS,
              f"pipe step: {k} launched {launches[k]}, want {n_leaves} a "
              f"step")
    want = _flash_want(cfg, lps * (PIPE_STEP_MB + 1) * PIPE_STEPS)
    for k in FLASH:
        check(launches[k] == want[k],
              f"pipe step: {k} launched {launches[k]}, want {want[k]}")
    del state, dsc_ref
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    ck.save_sharded(pathlib.Path(out_dir, "ckpt"), params,
                    cuts=train.store_cuts(cfg, mesh, settings))
    torch.save({"leaves": [t.cpu() for t in tree_leaves(params)],
                "stage": sh.axis_rank(mesh, "pipe")},
               pathlib.Path(out_dir, f"pieces{rank}.pt"))
    save_s = time.monotonic() - t0
    print(f"  rank {rank}: composite checkpoint and pieces written in "
          f"{save_s:.1f} s", flush=True)
    del params
    return dict(losses=losses, ms=ms, peak_gb=peak, launches=launches,
                save_s=save_s)


def _pipe_smoke(dev, seed, rank) -> dict:
    """The smoke variant at (data 2, pipe 2) on the int8 wire, 2
    microbatches (:func:`_smoke_steps`): params and losses within
    PIPE_SMOKE_TOL."""
    from repro_torch.launch import train
    mesh = _pipe_mesh(dev, 2, 2, 1)
    settings = train.TrainSettings(grad_dtype="float32", int8_wire=True,
                                   microbatches=2)
    rel, lrel, closs = _smoke_steps(dev, seed, mesh, settings)
    if rank == 0:
        print(f"  smoke int8 at (data 2, pipe 2), microbatches 2: 2 sgd "
              f"steps, params card vs host {rel:.3e}, losses {lrel:.3e} "
              f"(tol {PIPE_SMOKE_TOL:g}); losses {closs}", flush=True)
    check(rel <= PIPE_SMOKE_TOL and lrel <= PIPE_SMOKE_TOL,
          f"pipe smoke int8: params card vs host {rel:.3e}, losses "
          f"{lrel:.3e}")
    return dict(params_rel=rel, loss_rel=lrel)


def _pipe_rank(rank: int, world: int, port: int, part: str, seed: int,
               out_dir: str) -> None:
    """One rank of phase 17, in its own process on cuda:0."""
    _tp_env(rank, world, port)
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    dev = mesh_lib.init_process_group("cuda", backend="gloo")
    t0 = time.monotonic()
    res = {"backend": str(dist.get_backend()), "cases": {}}
    try:
        case = PIPE_PARITY_A if part == "a" else PIPE_PARITY_B
        mesh = _pipe_mesh(dev, 1, case[4], case[5])
        res["cases"][case[0]] = _pipe_parity(dev, seed, rank, case, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        if part == "a":
            res["step"] = _pipe_step(dev, seed, rank, mesh, out_dir)
        else:
            res["smoke"] = _pipe_smoke(dev, seed, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.monotonic() - t0
    pathlib.Path(out_dir, f"{part}{rank}.json").write_text(json.dumps(res))


def _pipe_serve(dev, seed, out_dir) -> tuple:
    """Serves 4 requests x 16 greedy tokens from (a)'s composite checkpoint
    through ``ServeEngine.from_checkpoint`` on the paged kernel, and from
    an engine built from the ranks' pieces merged here (stage 0's block
    rows, then stage 1's; the pipe-replicated leaves equal on both): the
    tokens must be equal.  Returns (the paged kernel's launches of the
    checkpoint's engine, its tokens)."""
    from repro_torch.dist import sharding as sh
    cfg = dataclasses.replace(_axis_gptneo(), dtype="float32")
    requests = [(p, SamplingParams()) for p, _ in serve_lib.random_requests(
        cfg.vocab, PIPE_SERVE_REQUESTS, 32, 64, seed)]
    settings = serve_lib.settings_for(requests, PIPE_SERVE_GEN,
                                      PIPE_SERVE_REQUESTS,
                                      cache_dtype="float32")
    t0 = time.monotonic()
    engine = ServeEngine.from_checkpoint(pathlib.Path(out_dir, "ckpt"), cfg,
                                         settings, device=dev)
    load_s = time.monotonic() - t0
    pa.paged_attention.launches = 0
    got = [o.tokens for o in serve_lib.serve(engine, requests)]
    launches = pa.paged_attention.launches
    steps = engine.stats()["decode_steps"]
    check(launches == cfg.n_layers * steps,
          f"pipe serve: paged kernel launched {launches} times over "
          f"{steps} decode steps")
    ckpt_leaves = tree_leaves(engine.params)
    del engine
    pieces = [torch.load(pathlib.Path(out_dir, f"pieces{r}.pt"))
              for r in range(2)]
    pieces.sort(key=lambda p: p["stage"])
    merged = []
    for pd, a, b in zip(tree_leaves(sh.pipe_dims(cfg, 2)),
                        pieces[0]["leaves"], pieces[1]["leaves"]):
        if pd >= 0:
            merged.append(torch.cat([a, b], pd))
        else:
            check(torch.equal(a, b), "pipe serve: a pipe-replicated leaf "
                  "differs between the stages")
            merged.append(a)
    same = all(torch.equal(x.cpu(), y) for x, y in zip(ckpt_leaves, merged))
    del ckpt_leaves
    params = tree_unflatten(sh.shape_tree(cfg, lambda s: None), merged)
    want = [o.tokens for o in serve_lib.serve(
        ServeEngine(cfg, params, settings, device=dev), requests)]
    print(f"  from_checkpoint: restored in {load_s:.1f} s, leaves == the "
          f"ranks' merged pieces: {same}; {PIPE_SERVE_REQUESTS} requests x "
          f"{PIPE_SERVE_GEN} greedy tokens, paged launches {launches}, "
          f"tokens == the merged params' engine: {got == want}", flush=True)
    check(same and got == want and all(len(t) == PIPE_SERVE_GEN
                                       for t in got),
          "pipe serve: the checkpoint's engine differs from the merged "
          "params' engine")
    return launches, got


def pipe_axis_phase(dev, seed, out) -> tuple:
    """Phase 17: (a) two ranks, (b) four, each a ``torch.multiprocessing``
    launch of processes on cuda:0 over gloo groups, and serving from (a)'s
    checkpoint in this process.  Its files go under ``out``: the
    checkpoint stays there for phase 18.  Returns (the paged kernel's
    launches, the main path's other launches: the pipelined gradients and
    steps, summed over ranks, and the checkpoint's served tokens)."""
    import torch.multiprocessing as mp
    from repro_torch.launch import mesh as mesh_lib
    _expect_free_card("before the pipe axis")
    print("  the pipe stages run over gloo on one card, as phase 16's model "
          "groups: every boundary send and every collective of a CUDA "
          "tensor is staged through host buffers", flush=True)
    totals = {name: 0 for name in ROUND}
    paged, served = 0, None
    for part, world in (("a", 2), ("b", 4)):
        t0 = time.monotonic()
        mp.spawn(_pipe_rank, args=(world, mesh_lib.free_port(), part,
                                   seed, out), nprocs=world, join=True)
        ranks = [json.loads(pathlib.Path(out, f"{part}{r}.json")
                            .read_text()) for r in range(world)]
        check(all(r["backend"] == "gloo" for r in ranks),
              f"pipe axis ({part}): backends "
              f"{[r['backend'] for r in ranks]}")
        print(f"  ({part}) {world} ranks in {time.monotonic() - t0:.1f} "
              f"s (each rank's own: "
              f"{[round(r['seconds'], 1) for r in ranks]})", flush=True)
        print("pipe_axis " + json.dumps({part: ranks}), flush=True)
        for r in ranks:
            for case in r["cases"].values():
                for k, n in case["launches"].items():
                    totals[k] += n
            for k, n in r.get("step", {}).get("launches", {}).items():
                totals[k] += n
        if part == "a":
            t0 = time.monotonic()
            paged, served = _pipe_serve(dev, seed, out)
            print(f"  (a) serving from the checkpoint in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return paged, totals, served


# ------------------------------------------------------------------ phase 18
# Serving over a ("data", "model") mesh on one card, as phases 16-17 run
# their ranks: processes on cuda:0 over gloo groups, every collective of a
# CUDA tensor staged through the host.  (a) and (b) at (data 2, model 2),
# four ranks: eris-gptneo-1.3b and qwen2-0.5b at full width and depth, f32
# params and pools, each against the meshless engine on the same params,
# then (d) olmoe-1b-7b's smoke config card vs host; (c) and (e) at (data 1,
# model 2), two ranks: eris-gptneo-1.3b in bf16, timed, and serving from a
# composite checkpoint (phase 17's when it ran, else one saved here at the
# smoke size).
SERVE_MESH_REQUESTS, SERVE_MESH_GEN = 8, 16
SERVE_MESH_PROMPT = (32, 128)
# (arch, the kernel's (heads, kv heads, head dim) on a rank at model 2)
SERVE_MESH_FULL = (("eris-gptneo-1.3b", (8, 8, 128)),
                   ("qwen2-0.5b", (7, 1, 64)))
SERVE_MESH_SMOKE = "olmoe-1b-7b"
SERVE_MESH_SMOKE_PROMPT, SERVE_MESH_SMOKE_GEN = (8, 24), 8


def _paged_rel(out, ref) -> torch.Tensor:
    """Each (row, head)'s ||out - ref|| / ||ref|| over the head dim (0
    where both are 0: an inactive row)."""
    diff = (out.float() - ref.float()).norm(dim=-1)
    return diff / ref.float().norm(dim=-1).clamp_min(1e-30)


class PagedCheck:
    """Inside: the model's paged kernel calls go through a wrapper that
    holds the first call with a live row to the plain version on the same
    inputs: phase 3's elementwise tolerance and, per (row, head),
    ``PAGED_REL_TOL`` of the output's norm.  With ``plant`` the plain
    version also runs with the window's (or the context's) oldest 64 keys
    dropped, a chunk partial lost, and ``fault_rel`` is that fault's
    least relative error over the live (row, head)s, which must exceed the
    tolerance.  The wrapper is put in the transformer's view of the kernel
    module only, so the kernel's own launch counter counts as always; the
    plain version launches nothing."""

    def __init__(self, plant: bool = False):
        self.err, self.shape, self.tol, self.ok = None, None, None, False
        self.rel = self.rel_tol = self.ref_rms = self.fault_rel = None
        self.plant = plant

    def __enter__(self):
        import types
        real = pa.paged_attention

        def run(q, k_pool, v_pool, tables, ctx, **kw):
            out = real(q, k_pool, v_pool, tables, ctx, **kw)
            if self.err is None and bool((ctx > 1).any()):
                ref = pa.paged_attention_ref(q, k_pool, v_pool, tables, ctx,
                                             **kw)
                self.tol = (TOL_F32 if k_pool.dtype == torch.float32
                            else TOL_BF16)
                self.rel_tol = PAGED_REL_TOL[k_pool.dtype]
                err = (out.float() - ref.float()).abs()
                self.err = float(err.max())
                self.rel = float(_paged_rel(out, ref).max())
                self.ref_rms = float(ref.float().square().mean().sqrt())
                self.ok = bool((err <= self.tol + self.tol * ref.float()
                                .abs()).all()) and self.rel <= self.rel_tol
                self.shape = (q.shape[1], k_pool.shape[1], q.shape[2])
                if self.plant:
                    keys = kw.get("window") or int(ctx.max())
                    drop = pa.paged_attention_ref(
                        q, k_pool, v_pool, tables, ctx,
                        window=keys - pa.chunk_positions(k_pool.shape[2]))
                    self.fault_rel = float(_paged_rel(drop, ref)[ctx > 0]
                                           .min())
            return out

        tr.pa = types.SimpleNamespace(paged_attention=run,
                                      paged_attention_ref=
                                      pa.paged_attention_ref)
        return self

    def __exit__(self, *exc):
        tr.pa = pa


class CollectiveCount(LogitSpy):
    """A :class:`LogitSpy` that also counts the calls of every collective
    of ``dist.collectives`` and keeps, for each ``paged_decode_step``,
    how many it issued, the host ms spent inside them (a staged
    collective first waits for the card's work before it) and the
    step's own host ms."""

    NAMES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
             "ring_shift")

    def __init__(self):
        super().__init__()
        from repro_torch.dist import collectives as cl
        self.cl, self.calls, self.coll_s = cl, 0, 0.0
        self.per_step, self.coll_ms, self.host_ms = [], [], []

    def __enter__(self):
        self.saved = {n: getattr(self.cl, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(self.cl, n, self._counted(fn))
        return super().__enter__()

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.cl, n, fn)
        super().__exit__(*exc)

    def _counted(self, fn):
        def run(*a, **k):
            self.calls += 1
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.coll_s += time.perf_counter() - t0
            return out
        return run

    def _wrap(self, fn, kind):
        timed = super()._wrap(fn, kind)
        if kind != "decode":
            return timed

        def run(*a, **k):
            calls, coll_s, t0 = self.calls, self.coll_s, time.perf_counter()
            out = timed(*a, **k)
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
            self.per_step.append(self.calls - calls)
            self.coll_ms.append((self.coll_s - coll_s) * 1e3)
            return out
        return run


def _serve_mesh_requests(cfg, seed, lo_hi, n=SERVE_MESH_REQUESTS):
    return serve_lib.random_requests(cfg.vocab, n, *lo_hi, seed)


def _seeded_params(cfg, seed, dev) -> dict:
    """Random params of ``cfg`` on the card from ``seed``, the same in
    every process: torch's generator on the card, normal draws scaled by
    fan_in ** -0.5 as ``init_params`` scales its own, norm scales ones,
    biases zeros.  Four ranks draw these at once in a few hundred ms,
    where ``init_params``' threefry stream takes seconds a rank."""
    from repro_torch.dist import sharding as sh
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = tr.DTYPES[cfg.dtype]

    def one(shape, name):
        if name.startswith(("ln", "q_norm", "k_norm")):
            return torch.ones(shape, dtype=dtype, device=dev)
        if name.startswith("b"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return (torch.randn(shape, generator=gen, device=dev)
                * fan_in ** -0.5).to(dtype)

    leaves = [one(shape, path[-1]) for path, shape in sh.spec_items(cfg)]
    return tree_unflatten(sh.shape_tree(cfg, lambda shape: None), leaves)


def _serve_mesh_full(dev, seed, rank, mesh, arch, local) -> dict:
    """One model at full width and depth, f32, on this rank of the (2, 2)
    mesh: rank 0 first serves the requests meshless on the same params
    (the target), then every rank serves them on the mesh, the first
    kernel call with a live row held to the plain version."""
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    requests = _serve_mesh_requests(cfg, seed, SERVE_MESH_PROMPT)
    settings = serve_lib.settings_for(requests, SERVE_MESH_GEN,
                                      SERVE_MESH_REQUESTS,
                                      cache_dtype="float32")
    params = _seeded_params(cfg, seed, dev)
    want = None
    if rank == 0:
        want = [o.tokens for o in serve_lib.serve(
            ServeEngine(cfg, params, settings, device=dev), requests)]
    engine = ServeEngine(cfg, params, settings, mesh=mesh, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with PagedCheck() as kernel:
        pa.paged_attention.launches = 0           # the main path starts
        t0 = time.monotonic()
        outs = serve_lib.serve(engine, requests)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = pa.paged_attention.launches    # the main path ended
    steps = engine.stats()["decode_steps"]
    plan = engine._tp_plan
    print(f"  rank {rank}: {arch} f32 at (2, 2): manual {engine._manual}, "
          f"slots {list(engine._slots)}, plan attn {plan.attn} vocab "
          f"{plan.vocab} ffn {plan.ffn}, pools {tuple(engine.pools['k'].shape)}"
          f", {steps} decode steps in {wall:.2f} s, paged launches "
          f"{launches}; the first live call at (H, KV, hd) {kernel.shape} "
          f"vs the plain version: max abs err {kernel.err:.3e} (tol "
          f"{kernel.tol:g}), relative a (row, head) {kernel.rel:.3e} (tol "
          f"{kernel.rel_tol:g})", flush=True)
    check(engine._manual, f"{arch} at (2, 2): not the manual path")
    check(launches == cfg.n_layers * steps and steps > 0,
          f"{arch} at (2, 2): paged kernel launched {launches} times over "
          f"{steps} decode steps of {cfg.n_layers} layers")
    check(kernel.shape == tuple(local) and kernel.ok,
          f"{arch} at (2, 2): kernel at {kernel.shape} (want {local}) "
          f"disagrees with the plain version: {kernel.err}, relative "
          f"{kernel.rel}")
    return dict(tokens=[o.tokens for o in outs], want=want,
                launches=launches, steps=steps, wall_s=wall,
                max_abs_err=kernel.err, shape=kernel.shape,
                attn=plan.attn, vocab=plan.vocab)


def _serve_mesh_smoke(dev, seed, rank, mesh) -> dict:
    """(d) olmoe-1b-7b's smoke config at (2, 2), expert parallel in
    decode: the same program on the card and on the host (gloo carries
    both), tokens equal."""
    cfg = get_config(SERVE_MESH_SMOKE).smoke()
    requests = _serve_mesh_requests(cfg, seed, SERVE_MESH_SMOKE_PROMPT)
    settings = serve_lib.settings_for(requests, SERVE_MESH_SMOKE_GEN,
                                      SERVE_MESH_REQUESTS,
                                      cache_dtype="float32")
    params = tr.init_params(cfg, seed=seed, device="cpu")
    host = [o.tokens for o in serve_lib.serve(
        ServeEngine(cfg, params, settings, mesh=mesh, device="cpu"),
        requests)]
    engine = ServeEngine(cfg, params, settings, mesh=mesh, device=dev)
    pa.paged_attention.launches = 0               # the main path starts
    card = [o.tokens for o in serve_lib.serve(engine, requests)]
    launches = pa.paged_attention.launches        # the main path ended
    steps = engine.stats()["decode_steps"]
    print(f"  rank {rank}: {cfg.name} at (2, 2), experts sharded "
          f"{engine._tp_plan.moe}: tokens card == host {card == host}, "
          f"paged launches {launches}", flush=True)
    check(engine._tp_plan.moe and engine._manual,
          f"{cfg.name} at (2, 2): not expert parallel on the manual path")
    check(card == host, f"{cfg.name} at (2, 2): card tokens differ from the "
          f"host's")
    check(launches == cfg.n_layers * steps,
          f"{cfg.name} at (2, 2): paged launches {launches}, {steps} steps")
    return dict(tokens=card, launches=launches, steps=steps)


class FirstStep:
    """Inside: keeps the first ``paged_decode_step``'s inputs (the pools
    as they were before it wrote them) and its logits."""

    def __enter__(self):
        self.decode, self.kept = tr.paged_decode_step, None
        tr.paged_decode_step = self._keep
        return self

    def __exit__(self, *exc):
        tr.paged_decode_step = self.decode

    def _keep(self, params, cfg, pools, tables, ctxs, toks, **kw):
        before = ({n: t.clone() for n, t in pools.items()}
                  if self.kept is None else None)
        logits, pools = self.decode(params, cfg, pools, tables, ctxs, toks,
                                    **kw)
        if self.kept is None:
            self.kept = (before, tables.clone(), ctxs.clone(), toks.clone(),
                         logits.clone(), kw)
        return logits, pools


def _serve_mesh_bf16(dev, seed, rank, mesh) -> dict:
    """(c) eris-gptneo-1.3b in bf16 at (1, 2), the shape users serve: the
    meshless engine's first decode step replayed through the TP step on
    this rank's heads (logits within phase 4's replay gate), then the
    requests served on the mesh: decode step ms by events, the
    collectives each step issues (all host-staged here)."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import shard_plan as sp
    cfg = get_config("eris-gptneo-1.3b")
    requests = _serve_mesh_requests(cfg, seed, SERVE_MESH_PROMPT)
    settings = serve_lib.settings_for(requests, SERVE_MESH_GEN,
                                      SERVE_MESH_REQUESTS,
                                      cache_dtype="bfloat16")
    params = _seeded_params(cfg, seed, dev)
    meshless = ServeEngine(cfg, params, settings, device=dev)
    for i, (prompt, samp) in enumerate(requests):
        meshless.submit(prompt, sampling=samp, seed=i)
    with FirstStep() as first:
        while meshless.stats()["decode_steps"] == 0:
            meshless.step()
    del meshless
    pools, tables, ctxs, toks, want, kw = first.kept
    idx = sh.axis_rank(mesh, "model")
    plan = dataclasses.replace(tr.tp_plan(cfg, 2), seq=False, seq_ce=False,
                               ctx=1)
    rt = sp.TPRuntime(mesh.get_group("model"), 2, idx, plan)
    heads = sh.paged_pool_heads(cfg, plan, 2, idx)
    local = {n: t[:, :, heads.start:heads.stop].contiguous()
             for n, t in pools.items()}
    got, _ = tr.paged_decode_step(sh.tp_piece(params, cfg, 2, idx), cfg,
                                  local, tables, ctxs, toks,
                                  window=kw.get("window"), tp=rt)
    rel = float((got.float() - want.float()).norm()
                / want.float().norm())
    del pools, local, got, want
    engine = ServeEngine(cfg, params, settings, mesh=mesh, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    with CollectiveCount() as spy:
        pa.paged_attention.launches = 0           # the main path starts
        t0 = time.monotonic()
        serve_lib.serve(engine, requests)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = pa.paged_attention.launches    # the main path ended
    steps = engine.stats()["decode_steps"]
    ms = spy.ms("decode")
    def mid(xs):
        return sorted(xs)[len(xs) // 2]

    median = mid(ms)
    host, coll = mid(spy.host_ms), mid(spy.coll_ms)
    print(f"  rank {rank}: eris-gptneo-1.3b bf16 at (1, 2): the meshless "
          f"first step replayed at tp 2, logits relative error {rel:.3e} "
          f"(gate {LOGITS_REL_TOL:g}); served in {wall:.2f} s, {steps} "
          f"decode steps, median {median:.2f} ms ({min(ms):.2f}-"
          f"{max(ms):.2f}), collectives a step {sorted(set(spy.per_step))}, "
          f"host ms a step (median) {host:.2f}, of it inside the "
          f"collectives {coll:.2f} and outside {host - coll:.2f}, paged "
          f"launches {launches}", flush=True)
    check(int(spy.bad) == 0, f"bf16 at (1, 2): {int(spy.bad)} non-finite "
          f"logits")
    check(rel <= LOGITS_REL_TOL,
          f"bf16 at (1, 2): the TP step's logits {rel:.3e} from the "
          f"meshless step's")
    check(launches == cfg.n_layers * steps,
          f"bf16 at (1, 2): paged launches {launches}, {steps} steps")
    return dict(rel_err=rel, steps=steps, wall_s=wall, median_ms=median,
                ms=ms, collectives=spy.per_step, launches=launches,
                host_ms=spy.host_ms, coll_ms=spy.coll_ms)


def _serve_mesh_ckpt(dev, seed, rank, mesh, out_dir, served) -> dict:
    """(e) ``ServeEngine.from_checkpoint(..., mesh=)`` at (1, 2): phase
    17's composite checkpoint of eris-gptneo-1.3b (f32) with its requests,
    against the tokens its meshless ``from_checkpoint`` served there; or,
    when phase 17 did not run, a checkpoint of the smoke config saved here
    at (1, 2) against the meshless ``from_checkpoint`` on rank 0."""
    from repro_torch.checkpoint import msgpack_ckpt as ck
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import train
    path = pathlib.Path(out_dir, "ckpt")
    if served is not None:
        cfg = dataclasses.replace(_axis_gptneo(), dtype="float32")
        requests = [(p, SamplingParams()) for p, _ in
                    serve_lib.random_requests(cfg.vocab, PIPE_SERVE_REQUESTS,
                                              32, 64, seed)]
        gen, n = PIPE_SERVE_GEN, PIPE_SERVE_REQUESTS
    else:
        import torch.distributed as dist
        cfg = dataclasses.replace(get_config("eris-gptneo-1.3b").smoke(),
                                  dtype="float32")
        requests = _serve_mesh_requests(cfg, seed, SERVE_MESH_SMOKE_PROMPT)
        gen, n = SERVE_MESH_SMOKE_GEN, SERVE_MESH_REQUESTS
        settings = train.TrainSettings()
        ck.save_sharded(path, train.store_params(
            tr.init_params(cfg, seed=seed, device=dev), cfg, mesh, settings),
            cuts=train.store_cuts(cfg, mesh, settings))
        dist.barrier(mesh.get_group("model"))
    settings = serve_lib.settings_for(requests, gen, n, cache_dtype="float32")
    if served is None and rank == 0:
        served = [o.tokens for o in serve_lib.serve(
            ServeEngine.from_checkpoint(path, cfg, settings, device=dev),
            requests)]
    t0 = time.monotonic()
    engine = ServeEngine.from_checkpoint(path, cfg, settings, mesh=mesh,
                                         device=dev)
    load_s = time.monotonic() - t0
    pa.paged_attention.launches = 0               # the main path starts
    got = [o.tokens for o in serve_lib.serve(engine, requests)]
    launches = pa.paged_attention.launches        # the main path ended
    steps = engine.stats()["decode_steps"]
    held = sum(t.numel() for t in tree_leaves(engine.params))
    whole = sum(math.prod(s) for _, s in sh.spec_items(cfg))
    print(f"  rank {rank}: from_checkpoint({cfg.name}, mesh=(1, 2)): "
          f"restored this rank's pieces in {load_s:.1f} s ({held} of "
          f"{whole} params), paged launches {launches}", flush=True)
    check(launches == cfg.n_layers * steps,
          f"from_checkpoint at (1, 2): paged launches {launches}, {steps} "
          f"steps")
    check(held < whole, f"from_checkpoint at (1, 2): {held} params held, "
          f"the whole model has {whole}")
    return dict(tokens=got, want=served, load_s=load_s, launches=launches,
                steps=steps, arch=cfg.name, held=held, whole=whole)


class PairMesh:
    """A (data 1, model 2) mesh over two ranks, from their model group and
    this rank's own one-rank data group: the helpers of
    ``dist/sharding``, the step's cuts and the engine read only these."""
    mesh_dim_names = ("data", "model")

    def __init__(self, model_group, data_group):
        self.groups = {"model": model_group, "data": data_group}

    def size(self, i: int) -> int:
        return (1, 2)[i]

    def get_group(self, name: str):
        return self.groups[name]


def _staged_ms(group, dev, reps: int = 20) -> dict:
    """Host-clock ms of one staged collective at the bf16 decode step's
    activation shape, (8, 1, 2048), on the card: the all-reduce after
    ``wo`` and one ring shift of the FFN's ring all-reduce (two at tp
    2), each ``reps`` times after a barrier; and the same all-reduce of
    a host tensor, gloo alone."""
    import torch.distributed as dist
    from repro_torch.dist import collectives as cl
    x = torch.randn(8, 1, 2048, device=dev).to(torch.bfloat16)
    halves = list(x.reshape(2, -1).unbind(0))
    host = x.cpu()
    out = {}
    for name, fn in (("all_reduce", lambda: cl.all_reduce(x, group)),
                     ("ring_shift", lambda: cl.ring_shift(halves, group)),
                     ("host_all_reduce",
                      lambda: cl.all_reduce(host, group))):
        fn()
        torch.cuda.synchronize()
        dist.barrier(group)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def _serve_mesh_rank(rank: int, world: int, port: int, seed: int,
                     out_dir: str, served) -> None:
    """One rank of phase 18, in its own process on cuda:0: (a), (b) and
    (d) on the (data 2, model 2) mesh of the four ranks, then (c) and
    (e) on ranks 0 and 1 at (data 1, model 2)."""
    _tp_env(rank, world, port)
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    dev = mesh_lib.init_process_group("cuda", backend="gloo")
    t0 = time.monotonic()
    res = {"backend": str(dist.get_backend())}
    try:
        mesh = mesh_lib.make_host_mesh(2, 2, device=dev)
        for arch, local in SERVE_MESH_FULL:
            res[arch] = _serve_mesh_full(dev, seed, rank, mesh, arch, local)
            gc.collect()
            torch.cuda.empty_cache()
        res["smoke"] = _serve_mesh_smoke(dev, seed, rank, mesh)
        # every rank makes every group, in one order
        model_group = dist.new_group([0, 1])
        data_groups = [dist.new_group([r]) for r in range(world)]
        pair = PairMesh(model_group, data_groups[rank])
        if rank < 2:
            res["bf16"] = _serve_mesh_bf16(dev, seed, rank, pair)
            res["bf16"]["staged_ms"] = _staged_ms(model_group, dev)
            gc.collect()
            torch.cuda.empty_cache()
            res["ckpt"] = _serve_mesh_ckpt(dev, seed, rank, pair, out_dir,
                                           served)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    res["seconds"] = time.monotonic() - t0
    pathlib.Path(out_dir, f"serve_{rank}.json").write_text(json.dumps(res))


def serve_mesh_phase(dev, seed, out, served) -> tuple:
    """Phase 18: the paged kernel timed at a rank's heads at model 2 for
    both models, then one ``torch.multiprocessing`` launch of four
    processes on cuda:0 over gloo groups: (a, b, d) at (data 2, model 2),
    (c, e) on two of them at (data 1, model 2).  ``served``: phase 17's
    checkpoint tokens, or None.  Returns (the paged kernel's launches on
    the main paths, summed over ranks, and its timings at the local
    shapes)."""
    import torch.multiprocessing as mp
    from repro_torch.launch import mesh as mesh_lib
    _expect_free_card("before serving over a mesh")
    print("  the serving ranks run over gloo on one card, as phase 16's: "
          "every collective of a CUDA tensor is staged through host "
          "buffers, so the times are host staging, not NVLink", flush=True)
    timing = {}
    requests = _serve_mesh_requests(get_config("eris-gptneo-1.3b"), seed,
                                    SERVE_MESH_PROMPT)
    mid = [len(p) + SERVE_MESH_GEN // 2 for p, _ in requests]
    for arch, _ in SERVE_MESH_FULL:
        timing[arch] = decode_shape_timing(dev, seed, get_config(arch), mid,
                                           16, model=2)
    world = 4
    t0 = time.monotonic()
    mp.spawn(_serve_mesh_rank, args=(world, mesh_lib.free_port(), seed, out,
                                     served), nprocs=world, join=True)
    ranks = [json.loads(pathlib.Path(out, f"serve_{r}.json").read_text())
             for r in range(world)]
    check(all(r["backend"] == "gloo" for r in ranks),
          f"serving mesh: backends {[r['backend'] for r in ranks]}")
    print(f"  {world} ranks in {time.monotonic() - t0:.1f} s (each rank's "
          f"own: {[round(r['seconds'], 1) for r in ranks]})", flush=True)
    launches = 0
    for key in [a for a, _ in SERVE_MESH_FULL] + ["smoke", "bf16", "ckpt"]:
        results = [r[key] for r in ranks if key in r]
        check(len(results) == (2 if key in ("bf16", "ckpt") else world),
              f"serving mesh {key}: {len(results)} ranks reported")
        launches += sum(x["launches"] for x in results)
        want = results[0].get("want")
        if want is not None:
            same = all(x["tokens"] == want for x in results)
            print(f"  {key}: every rank's tokens == the meshless engine's: "
                  f"{same}", flush=True)
            check(same, f"serving mesh {key}: tokens differ from the "
                  f"meshless engine's")
        elif key == "smoke":
            check(all(x["tokens"] == results[0]["tokens"] for x in results),
                  "smoke: the ranks' tokens differ")
    for r in ranks[:2]:
        print(f"  (c) staged collectives at (8, 1, 2048) bf16, ms each: "
              f"{r['bf16']['staged_ms']}", flush=True)
    print("serve_mesh " + json.dumps(ranks), flush=True)
    return launches, timing


# ------------------------------------------------------------------ phase 19
# The account (launch/accounting.py): the card's step counted as it runs
# against the same step's dry run on the meta device.  (a) one rank over
# NCCL, phase 11's eris-gptneo-1.3b step at full width (8 x 64 tokens,
# adam at phase 11's lr) in configurations (c) int8 and (b) DSC fused
# int8, each from fresh params: flops, every kernel's launches and
# declared work, and the arguments equal; the traffic within
# ACCOUNT_TRAFFIC_TOL (the ops that branch on the device: the flash
# backward lays a do that is off 16 bytes out afresh on the card only);
# the meta peak over the arguments within ACCOUNT_PEAK_TOL of the card's
# max_memory_allocated rise over the step (the allocator rounds each block
# up to 512 bytes).  (b) rank 0's account of phase 16 (a)'s first step at
# (data 1, model 2) over gloo against the dry run of that step at a fake
# world of 2 in a subprocess: the collective records equal per axis, kind
# and dtype, in bytes and counts, the flops equal, the host staging (the
# card's gloo copies) reported apart.
ACCOUNT_CONFIGS = (TRAIN_CONFIGS[2], TRAIN_CONFIGS[1])
ACCOUNT_TRAFFIC_TOL = 1e-3
ACCOUNT_PEAK_TOL = 0.2

_TP_DRYRUN = """
import dataclasses, json, sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch import random
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_lib, train
from repro_torch.launch.accounting import Account
from repro_torch.optim import adam
spec = json.loads(sys.argv[2])
mesh_lib.init_dryrun_group(2)
mesh = mesh_lib.make_host_mesh(data=1, model=2, device="cpu")
cfg = dataclasses.replace(get_config(spec["arch"]),
                          n_layers=spec["n_layers"])
settings = train.TrainSettings(**spec["fields"])
opt = adam(spec["lr"])
step = train.make_train_step(cfg, mesh, opt, settings, device="meta")
state = train.abstract_train_state(cfg, mesh, opt, settings)
toks = torch.empty(spec["tokens"], dtype=torch.int32, device="meta")
with Account(mesh, "meta", inputs=(*state, toks)) as acc:
    step(*state, {"tokens": toks}, random.PRNGKey(0))
print("DRYRUN" + json.dumps(acc.record()))
"""


def _meta_twin(tree):
    """``tree`` with every CUDA tensor replaced by a meta tensor of its
    shape, dtype and strides, and the host ones copied."""
    import torch.utils._pytree as pytree
    return pytree.tree_map(
        lambda t: (torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device="meta") if t.is_cuda
                   else t.clone()), tree)


def _headline(rec: dict) -> str:
    cb = rec["collective_bytes"]
    return (f"flops {rec['flops']:.6e}, traffic {rec['traffic_bytes']:.6e} "
            f"B, peak {rec['peak_bytes']} B over arguments "
            f"{rec['argument_bytes']} B, staging {rec['staging_bytes']} B, "
            f"collectives by axis {json.dumps(cb['axes'])}, kernels "
            f"{json.dumps(rec['kernels'])}")


def _account_gates(what: str, c: dict, m: dict, rise: int) -> tuple:
    """The card's account ``c`` against the meta one ``m``: flops, each
    kernel's launches and declared work and the argument bytes equal, the
    traffic within ``ACCOUNT_TRAFFIC_TOL``, the meta peak over the
    arguments within ``ACCOUNT_PEAK_TOL`` of the card's rise.  Returns
    (the traffic gap, the meta peak over the arguments)."""
    check(c["flops"] == m["flops"], f"{what}: flops card {c['flops']} vs "
          f"meta {m['flops']}")
    check(c["kernels"] == m["kernels"], f"{what}: kernels card "
          f"{c['kernels']} vs meta {m['kernels']}")
    check(c["argument_bytes"] == m["argument_bytes"], f"{what}: arguments "
          f"card {c['argument_bytes']} vs meta {m['argument_bytes']}")
    gap = abs(c["traffic_bytes"] - m["traffic_bytes"]) / c["traffic_bytes"]
    check(gap <= ACCOUNT_TRAFFIC_TOL, f"{what}: traffic card "
          f"{c['traffic_bytes']} vs meta {m['traffic_bytes']}")
    temp = m["peak_bytes"] - m["argument_bytes"]
    check(abs(temp - rise) <= ACCOUNT_PEAK_TOL * rise, f"{what}: meta peak "
          f"over the arguments {temp} B vs the card's rise {rise} B")
    return gap, temp


def _account_card(dev, seed, cfg, mesh, toks, name, fields) -> dict:
    """One step of a phase 11 configuration on the card under an account,
    then the same step on meta twins of its inputs; the gates."""
    from repro_torch.launch import train
    from repro_torch.optim import adam
    _expect_free_card(f"before the account of {name}")
    settings = train.TrainSettings(**fields)
    opt = adam(TRAIN_LR)
    step = train.make_train_step(cfg, mesh, opt, settings, device=dev)
    params = train.store_params(_init_params(cfg, seed, dev), cfg, mesh,
                                settings)
    inputs = [params, opt.init(params),
              train.init_dsc_state(cfg, mesh, settings, device=dev),
              {"tokens": toks}]
    twins = _meta_twin(inputs)
    del params
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _set_round_launches(0)                        # the main path starts
    start, end = _event_pair()
    with Account(mesh, dev, inputs=inputs) as card:
        start.record()
        out = step(*inputs, random.PRNGKey(0))
        end.record()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in ROUND.items()}  # it ended
    rise = torch.cuda.max_memory_allocated() - base
    ms = start.elapsed_time(end)
    loss = float(out[3]["loss"])
    check(math.isfinite(loss), f"account {name}: loss {loss}")
    del out, inputs
    meta_step = train.make_train_step(cfg, mesh, opt, settings,
                                      device="meta")
    with Account(mesh, "meta", inputs=twins) as meta:
        meta_step(*twins, random.PRNGKey(0))
    c, m = card.record(), meta.record()
    print(f"  {name}: card step {ms:.1f} ms (the account's own cost "
          f"included), loss {loss:.4f}, max_memory_allocated rise {rise} B"
          f"\n    card: {_headline(c)}\n    meta: {_headline(m)}",
          flush=True)
    gap, temp = _account_gates(f"account {name}", c, m, rise)
    check(all(launches[k] == v["launches"] for k, v in c["kernels"].items())
          and sum(launches.values()) == sum(v["launches"] for v in
                                            c["kernels"].values()),
          f"account {name}: launches {launches} vs declarations "
          f"{c['kernels']}")
    check(c["staging_bytes"] == m["staging_bytes"] == 0,
          f"account {name}: staging on one NCCL rank")
    return dict(card=c, meta=m, ms=ms, rise=rise, launches=launches,
                traffic_gap=gap, peak_ratio=temp / rise)


def _tp_dryrun_start() -> subprocess.Popen:
    """Starts phase 19 (b)'s dry run of phase 16's step (a CPU process on
    meta tensors, which needs nothing of the card's runs)."""
    name, fields, _ = TP_STEP_CONFIG
    spec = dict(arch="eris-gptneo-1.3b", n_layers=AXIS_LAYERS,
                fields=fields, lr=TP_STEP_LR,
                tokens=[TRAIN_BATCH, TRAIN_SEQ])
    return subprocess.Popen([sys.executable, "-c", _TP_DRYRUN,
                             str(ROOT / "src"), json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _tp_dryrun_record(proc: subprocess.Popen) -> dict:
    """The dry run's account record, once its process has ended."""
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise PhaseError("the model-axis dry run took over 300 s")
    check(proc.returncode == 0, f"the model-axis dry run failed: "
          f"{err[-2000:]}")
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("DRYRUN")][-1][len("DRYRUN"):])


def account_phase(dev, seed, tp_account, dryrun=None) -> dict:
    """Phase 19: (a) phase 11's step, card against meta, (b) phase 16's
    model-axis step, rank 0 against a fake world of 2 (``dryrun``: its
    process, when the caller started it early).  Returns the main path's
    launches ((a)'s steps)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    totals = {name: 0 for name in ROUND}
    results = {}
    if dryrun is None:
        dryrun = _tp_dryrun_start()
    try:
        mesh_lib.init_process_group(dev)
        try:
            mesh = mesh_lib.make_host_mesh(device=dev)
            cfg = get_config("eris-gptneo-1.3b")
            toks = lm_token_batches(random.PRNGKey(0), 1, TRAIN_BATCH,
                                    TRAIN_SEQ, cfg.vocab, device=dev)[0]
            for name, fields, _ in ACCOUNT_CONFIGS:
                results[name] = _account_card(dev, seed, cfg, mesh, toks,
                                              name, fields)
                for k, n in results[name]["launches"].items():
                    totals[k] += n
            del toks
        finally:
            dist.destroy_process_group()
        _expect_free_card("after the account's steps")
        if tp_account is None:
            tp_account = _tp_step_account(dev, seed)
        meta = _tp_dryrun_record(dryrun)
    finally:
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.communicate()
    name = TP_STEP_CONFIG[0]
    print(f"  (b) {name} at (data 1, model 2), rank 0 over gloo:\n"
          f"    card: {_headline(tp_account)}\n"
          f"    meta: {_headline(meta)}", flush=True)
    cb, mb = tp_account["collective_bytes"], meta["collective_bytes"]
    for key in ("axes", "axis_counts", "axis_dtypes", "counts", "dtypes"):
        check(cb[key] == mb[key], f"model-axis account: {key} card "
              f"{cb[key]} vs meta {mb[key]}")
    check(set(cb["axes"]) == {"model"}, f"collectives off the model axis: "
          f"{cb['axes']}")
    check(tp_account["flops"] == meta["flops"], f"model-axis account: "
          f"flops card {tp_account['flops']} vs meta {meta['flops']}")
    check(meta["staging_bytes"] == 0 < tp_account["staging_bytes"],
          f"staging: card {tp_account['staging_bytes']}, meta "
          f"{meta['staging_bytes']}")
    results["model axis"] = dict(card=tp_account, meta=meta)
    print("account " + json.dumps({k: {kk: vv for kk, vv in v.items()
                                       if kk not in ("card", "meta")}
                                   for k, v in results.items()}),
          flush=True)
    return totals


# ---------------------------------------------------------------- phase 20
# the serving account: each case's program as the dry run accounts it
# (launch/serve.serve_program at the shape's global batch on one rank), on
# the card under an account and then on meta twins of its inputs, with
# phase 19's gates; (d) is cut (named here) so that its meta peak stays
# under 60 GB
SERVE_ACCOUNT_CASES = (
    ("(a)", "qwen2-0.5b", "decode_32k", ""),
    ("(b)", "eris-gptneo-1.3b", "long_500k", ""),
    ("(c)", "hymba-1.5b", "long_500k", ""),
    ("(d)", "qwen2-0.5b", "prefill_32k",
     "n_layers=1,vocab=4096,attn_chunk=128"),
)
SERVE_KERNEL_REPS = 24


def _paged_timing(dev, seed, cfg, inputs, window) -> dict:
    """The paged kernel alone at a decode case's shapes (its tables, its
    lengths + 1, one layer's pools a call in turn, a random bf16 q), by
    CUDA events over repeated launches, beside its bound (each position
    the call may read, cut at the window, once)."""
    _, pools, tables, ctx, _ = inputs
    L, _, KV, _, hd = pools["k"].shape
    H = KV * (cfg.n_heads // cfg.n_kv_heads)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    q = torch.randn(tables.shape[0], H, hd, generator=gen, device=dev).to(
        pools["k"].dtype)
    lens = ctx + 1
    turn = iter(range(1 << 30))

    def call():
        i = next(turn) % L
        pa.paged_attention(q, pools["k"][i], pools["v"][i], tables, lens,
                           window=window)
    ms = _event_ms(call, SERVE_KERNEL_REPS)
    flops, nbytes = pa.declared_work(q, pools["k"][0], tables, window)
    bound = _bound(nbytes, int(flops))
    print(f"    paged kernel at B={q.shape[0]} H={H} KV={KV} hd={hd} table "
          f"{tables.shape[1]} pages window={window}: {ms * 1e3:.2f} us a "
          f"launch, bound {bound['bound_ms'] * 1e3:.2f} us by "
          f"{bound['bound_by']} ({nbytes} bytes), "
          f"{100 * bound['bound_ms'] / ms:.1f}% of its bound, "
          f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s", flush=True)
    return dict(ms=ms, bound_ms=bound["bound_ms"],
                bound_by=bound["bound_by"], bytes=nbytes)


def _serve_account_case(dev, seed, mesh, label, arch, shape_name,
                        opt) -> dict:
    """One case: params from ``seed``, the inputs drawn from it, a warm-up
    step (the paged kernel's first call with a live row held to its plain
    version), then the step on the card under an account and on meta twins
    of its inputs under another; the gates; the step's ms without the
    account; at a paged case the kernel alone at its shapes."""
    from repro_torch.launch import dryrun, shapes as shp
    _expect_free_card(f"before the serving account {label}")
    cfg = dataclasses.replace(get_config(arch), **dryrun._overrides(opt))
    shape = shp.SHAPES[shape_name]
    window = (shp.decode_window(cfg, shape) if shape.kind == "decode"
              else None)
    step, inputs = serve_lib.serve_program(
        cfg, mesh, shape.kind, shape.global_batch, shape.seq_len, window,
        device=dev, params=_init_params(cfg, seed, dev))
    serve_lib.fill_inputs(inputs, cfg, seed)
    paged = shape.kind == "decode" and cfg.family in tr.paged_families()
    twins = _meta_twin(inputs)
    decode = shape.kind == "decode"
    if decode:
        # a warm-up step (a prefill takes none: its ~12 s step allocates
        # nothing the step after it would not, cuBLAS being warm by (c))
        with PagedCheck(plant=True) as chk:
            step(*inputs)
        torch.cuda.synchronize()
        if paged:
            print(f"    the first layer's paged call vs its plain version: "
                  f"max abs err {chk.err:.3e} (bound {chk.tol:g} + "
                  f"{chk.tol:g} |ref|), |ref| rms {chk.ref_rms:.3e}, max "
                  f"relative error a (row, head) {chk.rel:.3e} (tol "
                  f"{chk.rel_tol:g}); planted fault (the oldest 64 keys "
                  f"dropped): least relative error {chk.fault_rel:.3e}",
                  flush=True)
            check(chk.ok, f"serving account {label}: the first layer's "
                  f"paged kernel call disagrees with its plain version: "
                  f"max err {chk.err} (tol {chk.tol}), relative "
                  f"{chk.rel} (tol {chk.rel_tol})")
            check(chk.fault_rel > chk.rel_tol, f"serving account {label}: "
                  f"a dropped chunk of 64 keys moves a (row, head) by only "
                  f"{chk.fault_rel}, within the check's {chk.rel_tol}")
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0               # the main path starts
    start, end = _event_pair()
    with Account(mesh, dev, inputs=inputs) as card:
        start.record()
        out = step(*inputs)
        end.record()
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches        # it ended
    rise = torch.cuda.max_memory_allocated() - base
    acc_ms = start.elapsed_time(end)
    check(bool(torch.isfinite(out[0]).all()), f"serving account {label}: "
          f"non-finite logits")
    del out
    with Account(mesh, "meta", inputs=twins) as meta:
        step(*twins)
    c, m = card.record(), meta.record()
    name = f"{label} {arch} {shape_name}" + (f" at {opt}" if opt else "")
    # a decode step's ms without the account; the prefill's under it (its
    # dispatch costs ~0.4 of ~12 s)
    ms = _event_ms(lambda: step(*inputs), 3) if decode else acc_ms
    print(f"  {name}: {shape.kind} step {ms:.3f} ms "
          f"({'no account; ' if decode else ''}{acc_ms:.1f} ms under it), "
          f"window {window}, max_memory_allocated rise {rise} B\n    card: "
          f"{_headline(c)}\n    meta: {_headline(m)}", flush=True)
    gap, temp = _account_gates(f"serving account {name}", c, m, rise)
    want = cfg.n_layers if paged else 0
    check(launches == c["kernels"].get("paged_attention", {}).get(
        "launches", 0) == want, f"serving account {name}: {launches} paged "
          f"launches, declared {c['kernels']}, want {want}")
    timing = None
    if paged:
        timing = dict(_paged_timing(dev, seed, cfg, inputs, window),
                      max_abs_err=chk.err, max_rel_err=chk.rel,
                      ref_rms=chk.ref_rms, planted_fault_rel=chk.fault_rel)
    del inputs, twins, step
    return dict(ms=ms, accounted_ms=acc_ms, rise=rise, meta_temp=temp,
                peak_ratio=temp / rise, traffic_gap=gap, launches=launches,
                flops=c["flops"], traffic=c["traffic_bytes"],
                arguments=c["argument_bytes"], kernel=timing)


def serve_account_phase(dev, seed) -> tuple:
    """Phase 20: cases (a)-(d) on a one-rank group.  Returns the paged
    launches of the accounted steps and the kernel's timings at (a)'s and
    (b)'s shapes."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    gc.collect()
    torch.cuda.empty_cache()
    results = {}
    mesh_lib.init_process_group(dev)
    try:
        mesh = mesh_lib.make_host_mesh(device=dev)
        for label, arch, shape_name, opt in SERVE_ACCOUNT_CASES:
            results[label] = _serve_account_case(dev, seed, mesh, label,
                                                 arch, shape_name, opt)
    finally:
        dist.destroy_process_group()
    _expect_free_card("after the serving account")
    print("serving account " + json.dumps(results), flush=True)
    launches = sum(r["launches"] for r in results.values())
    return launches, {"qwen2_decode_32k": results["(a)"]["kernel"],
                      "gptneo_long_500k": results["(b)"]["kernel"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", type=int, nargs="+",
                    choices=(8, 16, 17, 18, 19, 20),
                    help="after the device and the build, run only these "
                         "phases (8, the context gradient and the remat "
                         "policies, or the multi-rank ones), and print no "
                         "result (a partial run: the kernels line needs "
                         "every phase)")
    args = ap.parse_args()

    dev = device_phase()
    build_phase()
    if args.only:
        import tempfile
        served = tp_account = None
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
            for n in sorted(args.only):
                if n == 8:
                    phase("8 eris-gptneo-1.3b gradient at its 2048-token "
                          "context")
                    context_phase(dev, args.seed)
                elif n == 16:
                    phase("16 the model axis")
                    tp_account = model_axis_phase(dev, args.seed)[1]
                elif n == 17:
                    phase("17 the pipe axis")
                    served = pipe_axis_phase(dev, args.seed, out)[2]
                elif n == 18:
                    phase("18 serving over a mesh")
                    serve_mesh_phase(dev, args.seed, out, served)
                elif n == 19:
                    phase("19 the account")
                    account_phase(dev, args.seed, tp_account)
                else:
                    phase("20 the serving account")
                    serve_account_phase(dev, args.seed)
        phase(None)
        print(f"phase seconds {json.dumps(PHASE_SECONDS)}")
        print(f"partial run of phases {args.only}: no result line")
        return

    cfg = get_config("eris-gptneo-1.3b")
    requests = serve_lib.random_requests(cfg.vocab, REQUESTS, PROMPT_MIN,
                                         PROMPT_MAX, args.seed)
    settings = serve_lib.settings_for(requests, GEN, REQUESTS,
                                      cache_dtype="bfloat16")

    phase("3 kernel vs plain version")
    worst = kernel_cases(dev, args.seed)
    # mid-generation contexts of phase 4's requests, at both models' shapes
    mid = [len(p) + GEN // 2 for p, _ in requests]
    timing = decode_shape_timing(dev, args.seed, cfg, mid,
                                 settings.block_size)
    qwen_timing = decode_shape_timing(dev, args.seed,
                                      get_config("qwen2-0.5b"), mid,
                                      settings.block_size)

    phase("4 serving eris-gptneo-1.3b at full width")
    t0 = time.monotonic()
    params = tr.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    print(f"  {sum(t.numel() for t in _leaves(params))} params ({cfg.dtype}) "
          f"made in {time.monotonic() - t0:.2f} s; settings {settings}")
    launches, metrics = serving_phase(dev, args.seed, cfg, params, requests,
                                      settings)
    replay_phase(dev, cfg, params, requests, settings,
                 metrics["decode_step_ms_median"])
    small_input_phase(dev, args.seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    phase("5 wire kernels vs plain versions")
    _expect_free_card("after serving")
    wire_worst = wire_cases(dev, args.seed)
    wire_timing_ = wire_timing(dev, args.seed)

    phase("6 flash kernels vs plain versions")
    flash_worst = flash_cases(dev, args.seed)
    flash_timing_ = flash_timing(dev, args.seed)

    phase("7 ERIS rounds of eris-gptneo-1.3b and qwen2-0.5b at full width")
    round_launches = fl_round_phase(dev, args.seed)

    phase("8 eris-gptneo-1.3b gradient at its 2048-token context")
    context_phase(dev, args.seed)

    phase("9 ERIS round, small input, card vs host")
    fl_small_input_phase(dev, args.seed)

    phase("10 the key stream and the reference's default round")
    stream_phase(dev)
    default_launches = default_round_phase(dev, args.seed)
    keyed_small_input_phase(dev, args.seed)
    for name in round_launches:
        round_launches[name] += default_launches[name]

    phase("11 the distributed FSA step of eris-gptneo-1.3b over NCCL")
    train_launches = train_phase(dev, args.seed)
    for name in round_launches:
        round_launches[name] += train_launches[name]

    phase("12 the round matrix of eris-gptneo-1.3b at full width")
    matrix_launches = matrix_phase(dev, args.seed)
    for name in round_launches:
        round_launches[name] += matrix_launches[name]

    phase("13 the privacy audit of eris-gptneo-1.3b's captured wire at "
          "full width")
    audit_launches = audit_phase(dev, args.seed)
    for name in round_launches:
        round_launches[name] += audit_launches[name]

    phase("14 non-IID feeds, init and MoE: olmoe-1b-7b at full width")
    moe_paged, moe_launches = moe_phase(dev, args.seed)
    launches += moe_paged
    for name in round_launches:
        round_launches[name] += moe_launches[name]

    phase("15 the recurrent and vision families: xlstm-350m and "
          "hymba-1.5b at full width, internvl2-26b at reduced depth")
    family_launches = family_phase(dev, args.seed)
    for name in round_launches:
        round_launches[name] += family_launches[name]

    phase("16 the model axis: eris-gptneo-1.3b at tp = 2, olmoe-1b-7b, "
          "hymba-1.5b and qwen2-0.5b, ranks on one card over gloo")
    tp_launches, tp_account = model_axis_phase(dev, args.seed)
    for name in round_launches:
        round_launches[name] += tp_launches[name]

    import tempfile
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        phase("17 the pipe axis: eris-gptneo-1.3b at pp = 2, its composite "
              "checkpoint served, qwen2-0.5b at (pipe 2, model 2), ranks on "
              "one card over gloo")
        pipe_paged, pipe_launches, served = pipe_axis_phase(dev, args.seed,
                                                            out)
        launches += pipe_paged
        for name in round_launches:
            round_launches[name] += pipe_launches[name]

        phase("18 serving over a mesh: eris-gptneo-1.3b and qwen2-0.5b at "
              "(data 2, model 2), olmoe-1b-7b's smoke config, "
              "eris-gptneo-1.3b in bf16 and from phase 17's checkpoint at "
              "(data 1, model 2), ranks on one card over gloo")
        # phase 19's dry run runs on the host's CPU beside phase 18
        dryrun = _tp_dryrun_start()
        try:
            mesh_paged, mesh_timing = serve_mesh_phase(dev, args.seed, out,
                                                       served)
        except BaseException:
            dryrun.kill()
            dryrun.communicate()
            raise
        launches += mesh_paged

    phase("19 the account: the card's step against its dry run on meta")
    account_launches = account_phase(dev, args.seed, tp_account, dryrun)
    for name in round_launches:
        round_launches[name] += account_launches[name]

    phase("20 the serving account: qwen2-0.5b decode_32k, "
          "eris-gptneo-1.3b and hymba-1.5b long_500k, qwen2-0.5b "
          "prefill_32k cut, card against meta")
    serve_paged, serve_timing = serve_account_phase(dev, args.seed)
    launches += serve_paged

    phase("21 result")
    rows = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:52",
        "launches": launches,
        "max_abs_err": max(worst, timing["max_abs_err"],
                           qwen_timing["max_abs_err"],
                           *(t["max_abs_err"] for t in mesh_timing.values()),
                           *(t["max_abs_err"] for t in serve_timing.values())),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
        "shape": "eris-gptneo-1.3b decode, B=8 H=KV=16 hd=128 bf16",
        "qwen2_decode": {key: qwen_timing[key] for key in
                         ("ms", "plain_ms", "bound_ms", "bound_by")},
        "model_2_decode": {arch: {key: t[key] for key in
                                  ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "max_abs_err")}
                           for arch, t in mesh_timing.items()},
        "serving_account_decode": {case: {key: t[key] for key in
                                          ("ms", "bound_ms", "bound_by",
                                           "max_abs_err")}
                                   for case, t in serve_timing.items()}}]
    for name, _, source, replaces in KERNELS[1:5]:
        t = wire_timing_[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": round_launches[name],
            "max_abs_err": wire_worst, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    # the flash rows at the gptneo round's shape, where they launch; the
    # other timed shapes beside it, the f32 ones on the f32 source, which
    # phase 11's f32 steps launch f32_launches times; the library call is
    # scaled_dot_product_attention (forward for flash_fwd; its backward,
    # dq, dk and dv in one call, for flash_dq and flash_dkv)
    for name, _, source, replaces in KERNELS[5:]:
        t = flash_timing_["gptneo-round"][name]
        more = {label.replace("-", "_"): {
            key: flash_timing_[label][name][key] for key in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for label in ("qwen2-round", "gptneo-s2048", "qwen2-s2048",
                          "hymba-s2048", "internvl-s512",
                          "gptneo-train-f32", "gptneo-s2048-f32",
                          "qwen2-s2048-f32")}
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "f32_source": "src/repro_torch/kernels/csrc/flash_f32_sm90.cu",
            "f32_launches": train_launches[f"{name} f32"],
            "replaces": replaces, "launches": round_launches[name],
            "max_abs_err": flash_worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": "B=4 H=16 KV=16 S=64 d=128 bf16 causal", **more})
    phase(None)
    print(f"phase seconds {json.dumps(PHASE_SECONDS)}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


if __name__ == "__main__":
    main()
