"""Smoke test of the PyTorch + CUDA port (fdtpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one printed line each (any failure raises, and the script exits
non-zero; without a CUDA card it fails at once and prints no result):

1. the card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build the hand-written kernels from the checkout's sources;
3. the decode+filter+NMS kernel against its plain PyTorch version on the
   card: B in {1, 8, 128}, N in {100, 225, 4774}, capacity in {64, 128},
   thresholds 0.5/0.5 and 0.7/0.01, random, saturated, tie, all-equal and
   empty maps; negative scores under a threshold of -0.7 (a score <= -0.5
   ends the scan); +0.0 and -0.0 tied under -0.3; exactly capacity,
   capacity + 1, 256 and 257 eligible candidates (the rank sort's limit
   and the bitonic sort's first size); and past the kernel's shared-memory
   limit (its global-scratch path): N = the limit + 1 (8,187 on the H100),
   8,204 (SSD at 632 px) and 20,000, B in {1, 8}, capacity 128, random,
   saturated and tie maps. Outputs are allocated over blocks filled with
   0xFF, so a row the kernel fails to write shows. Masks, scores and
   coordinates must be bit-equal;
4. the full-width float32 forward (PoolResnet-128, 10 blocks, 480 px, B=2,
   TF32 off) on the card against the same model on the CPU, atol 1e-4;
5. the serving path: a bfloat16 Detector on the card, ``predict`` on three
   odd-sized u8 frames at DetectorConfig() (480 px, grid 10), then the batch
   path at the bench shape (320 px, grid 15, B=128, capacity 64). The
   kernel's launch count must rise once per call, and the batch path's boxes
   must equal the plain version's on the same forward output;
6. timings: the NMS kernel on the card alone (``device_ms``) through its
   wrapper and through the bare entry point, against its plain version,
   and its wrapper's host time a call (``host_us``), at three shapes, and
   its global-scratch path at (1, 8204), (8, 8204) and (8, 20000); with
   CUDA events after warmup the b128 forward + decode and the b1 predict
   latency;
7. the rotation kernels (shear_rows, shear_cols) against their plain
   versions on the card, every pass and the whole rotate_batch, float32 and
   bfloat16, B in {1, 8, 26}, S in {200, 320, 480} (200 = 8 mod 16), angles
   0, +-ROTATE_LIMIT_RAD and random; and K4's rotate_batch_transposed. Then
   the edges of both shears: k from 0 to 40 (shear_cols' ring, and its
   read straight from device memory when the shear outgrows the ring;
   shear_rows' shifts past the row's length), rows not a multiple of its
   128-row band (328, 37), lanes off the 16-byte grid (45), c = 1, and for
   shear_rows rows = 3 row_mod (K4's horizontal passes), rows shorter than
   a warp's 64 vectors and of one vector, shifts of every residue modulo
   the vector (checked from the plain version's shifts), planes one
   element into their storage. Bit-equal; the K4-layout launches counted;
8. one float32 SAM + SGD train step at DetectorConfig() (480 px, grid 10,
   B=2, augmentation and dropout off, TF32 off) on the card against the
   same step on the CPU: loss rtol 1e-4, grad norm rtol 1e-3, and the
   update (params after minus before) in relative L2 norm, 1e-2 over all
   params and 5e-2 for each tensor. The update is held in norm, not
   element by element: a pre-activation or max-pool pair that rounds to the
   other side of a leaky-ReLU or max-pool kink moves a few elements far,
   and which ones flip depends on the CPU's oneDNN kernels as much as on
   the card (oneDNN limited to AVX2 moves the update by 1.6e-3 in norm,
   1.2e-2 in one tensor, and 5.3e-5 in one element, against the same
   CPU with AVX-512). A wrong gradient in any tensor is off by order 1;
9. the training path: bf16 compute, float32 params, SAM + Adam, device
   augmentation with rotation, dropout on; five steps at the bench shape
   (PoolResnet-128, 10 blocks, 320 px, grid 15, B=128, positional crop) and
   five at DetectorConfig() with B=8, the last of each with train metrics.
   Losses finite, params moving; the shear launch counts rise by 3 per
   rotate_batch (one per step) and the NMS kernel launches once per metrics
   step;
10. timings with CUDA events after warmup: train img/s at b128/320 with
    rotation on and off, the b8/480 step; then each shear kernel on the
    card alone (``device_ms``) against its plain version at the shapes the
    training path gives it (and shear_rows on K4's channel-stacked planes
    of the same images, its horizontal and its vertical pass), and against
    the library call, one
    ``F.grid_sample`` of the same planes (float32 only: with bfloat16
    planes its grid is bfloat16 too, which is not the same function), with
    its largest difference from the plain version;
11. the fused photometric kernel (K5) against its plain version on the
    card: identity, brightness/contrast, noise (seeds 0, 2^31 - 2 and
    random), glass, motion, all gates at once, at B in {1, 26, 128} and S in
    {64, 320, 480}; halo-free and blurred images in one batch, all noised,
    at 320 px and at odd sides (37x45, 33x70) that put rows, images and the
    buffer's end off the 16-byte grid; a view at an odd offset; each of the
    16 motion bins. Bit-equal with noise off; with noise on, bit-equal or
    within atol 1e-6 (the line says which). Then the whole fused exact-k
    augmentation at b128/320 with rotation, kernel against plain version on
    the same draws;
12. the fused residual-tail kernel (K6) against its plain version, float32
    and bfloat16, pooled and unpooled, channels_last and contiguous, with
    and without conv2's bias folded in, at (128, 128, 40, 40),
    (128, 128, 20, 20), (1, 128, 60, 60), (1, 128, 30, 30) and the edges:
    C = 12 and 6 (not a multiple of 8), (3, 5, 7, 9) (a numel not a
    multiple of 8), inputs at an offset of one element. Bit-equal. Then the
    K6 path: ``Detector.apply`` with ``fused_tail`` at b128/320 and b1/480,
    bit-equal to the eager forward, the tail kernel launched once a block;
13. the K5 path: three bf16 train steps at b128/320 with rotation and
    ``fused_photometric``, losses finite, the photometric kernel launched
    once a step; then timings with CUDA events after warmup: K5 against its
    plain version at b128/320 on four tables (the fused route's, every gate
    off, noise on every row, both blurs on every row), K6 at the eval
    forward's shapes with and without the bias, each with warm and cold L2
    (cycling through more than 150 MB of inputs), the train step with
    ``fused_photometric`` against the default chain, and the three arms of
    ``fdtpu_torch.bench_pool_fusion`` at b128/320 and b1/480;
14. the Trainer path at full width (``DetectorConfig()``, ``TrainConfig()``
    defaults with rotation on the card and no first-batch drawings), b8,
    SAM + Adam, on ``make_synthetic_widerface`` data (48 train, 16 val
    images) in a temporary directory: ``Trainer.fit`` for two epochs with
    ``StreamedDriver`` (losses finite, params moving, the ``.log``,
    ``.jsonl`` and TensorBoard records and a checkpoint each epoch written,
    K1 launched once a train epoch and once a val batch, the shears twice
    and once a rotating step); a resume in a new Trainer (params, Adam
    moments and step bit-equal to the saved ones) and one epoch more;
    ``ResidentDriver`` against ``StreamedDriver`` in float32 with shuffle and
    augmentation off and ``torch.use_deterministic_algorithms(True)``
    (epoch metrics and params bit-equal); ``run_validation_epoch --with-ap``
    on the saved checkpoint; and ``fdtpu_torch.bench``'s measuring
    functions with loops of 5, 20 and 50 and one rep (``bench.py``'s keys,
    every value finite);
15. the SSD path (SSD-16, ``train_model_ssd``'s model, random weights):
    the float32 forward at 480 px, B=2, card against CPU, atol 1e-4; bf16
    serving: ``predict`` on three odd-sized frames, then the batch path at
    b24/480 (N = 4,774, capacity 128, K1 in shared memory) and at b8/640
    (N = 8,500, K1 on global scratch), boxes bit-equal to the plain
    version's on the same forward output and K1 launched once a call; one
    float32 SAM + SGD step at 480 px, B=2, card against CPU, at phase 8's
    tolerances (the loss's hard-negative mining adds one more kink: a
    negative whose score ties within rounding may be mined on one device
    and not the other; the line counts those); five bf16 SAM + Adam steps
    at b24/480, augmentation off, the last with train metrics (K1 once);
    ``train_model_ssd``'s Trainer for two quarter-epochs on 192 / 24
    synthetic images, a resume (params, Adam moments and step bit-equal)
    and ``run_validation_epoch --model ssd --with-ap`` on its checkpoint;
    timings with CUDA events: the train step, forward + decode at b24 and
    the b1 ``predict``, and K1 alone on the SSD's maps at (24, 4774),
    (1, 4774) and (8, 8500), each with its plain version and bound.

16. the rest of the zoo at 480 px: MobileNetV3-Small (grid 15), Resnet-64
    (10 blocks, grid 15) and SeparableCNN-128 (10 blocks, 16 patches, grid
    10). The float32 eval forward at B=2, card against CPU, atol 1e-4, TF32
    off, MobileNetV3's weights and non-trivial running statistics imported
    from a reference-layout TorchScript archive; one float32 SAM + SGD step
    of MobileNetV3 at B=2, card against CPU, at phase 8's tolerances, and
    the batch statistics each BatchNorm folds in within 1e-3 (the ``bn3``
    biases, whose gradient is rounding noise, held to a negligible update
    instead); bf16 serving of each family (``predict`` on three odd-sized
    frames, then b64/480), K1 once a call and bit-equal to its plain
    version; bf16 SAM + Adam steps at b8/480 with rotation on the card
    (five of MobileNetV3, two each of the others, the last with train
    metrics): losses finite, params and BatchNorm statistics moving, three
    shear launches a step; ``train_model --model mobilenetv3
    --rotate-device`` for one epoch on 48 / 16 synthetic images, a resume
    (params, statistics, Adam moments and step bit-equal) and
    ``run_validation_epoch`` (MobileNetV3 by default) on its checkpoint;
    timings with CUDA events: b1 ``predict``, b64 forward + decode and the
    b8 train step (three runs: a range) of each family;
17. data parallelism on the one card (``fdtpu_torch.parallel``), each rank
    a spawned process that loads the kernels phase 2 built: (a) NCCL at
    world size 1 on the flagship at b128/320 (bf16 compute, SAM + Adam):
    one step through the DP step against the plain step from the same
    state, augmentation and dropout off, deterministic algorithms (loss
    rtol 1e-6, update rel. L2 1e-4), then three DP steps with rotation on
    the card and train metrics (K1 once, the shears three times a step);
    the plain and the DP step timed in turns, three runs, and the gradient
    reduction alone; then the DP step captured in a CUDA graph with its
    NCCL all-reduces (``CapturedTrainStep``), SAM + Adam with rotation on
    the card: five replays against five eager DP steps, bit-equal (losses,
    grad norms, params, buffers, Adam moments and steps, and the shears'
    launches), on PoolResnet-128x10 at b128/320 and on MobileNetV3-Small at
    b16/480 (its BatchNorm ``pmean`` inside the graph too); the b128 DP step
    eager, replayed and the replayed plain step in turns (median and range
    of three runs of 50, device busy ms and idle share by both readings),
    the graph's pool and capture s; and the Trainer over the world-1 NCCL
    group (``GroupTrainer``) at ``DetectorConfig()`` b8 with rotation,
    phase 14's images, two epochs, streamed at ``steps_per_dispatch`` 1 and
    2 and with ``device_data``, each replaying its DP step, bit-equal to
    the same fits eager; (b) two gloo ranks on the card (CUDA tensors staged
    through the host), float32 SAM + SGD, against the one-process step on
    the global batch at phase 8's tolerances: PoolResnet-128 at b128/320
    (64 + 64, one padded sample) and SSD-16 at b24/480 (12 + 12, uneven
    positives); MobileNetV3-Small's params and statistics identical on both
    ranks and the statistics the mean of each rank's own update (the
    shard_map route); MobileNetV3-Small by the GSPMD route (the global
    batch's statistics) at b16 with one padded sample against the
    one-process step at phase 8's tolerances, its running statistics
    within 1e-3, its ``bn3`` biases held to a negligible update as in
    phase 16; the DP step's time, gloo's staging included (not a scaling
    number); (c)
    ``Trainer(data_parallel=2)`` at ``DetectorConfig()`` in float32 over
    gloo: one streamed and one resident epoch, bit-equal, each with its
    per-rank eval through K1, and a resume from rank 0's checkpoint. A rank
    that fails or outlives its timeout fails the script;
18. deployment (``fdtpu_torch.export``, ``fdtpu_torch.native``,
    ``compat/pruning.py``) at 480 px on PoolResnet-128x10 grid 10 and
    SSD-16, bf16, thresholds 0.7 / 0.01 and capacity 64 (each head's score
    column set up so that some candidates pass and float32 noise decides no
    pick, see ``deploy_models``): (a) the predict program exported at b1
    and b8, saved, loaded back: one K1 node in its graph, one K1 launch a
    call, masks equal to the eager program's and boxes within 1e-3 px;
    (b) ``aot_compile_predict`` at b1 (the exported program in a CUDA
    graph) against eager the same way, then the b1 latency by CUDA events,
    median of 3 loops of 2,000, of ``Detector.predict``, the eager program
    and the graph replay; (c) float32 and int8 ``.fdn`` artifacts through
    the port's C++ engine on the host, 8 frames, against the card's float32
    predict (TF32 off): counts equal and boxes within atol 2e-3 / rtol
    1e-4 for float32, the int8 counts and matches printed, the engine's ms
    a frame; (d) PoolResnet-128 L1-pruned to 102 channels and, with
    ``align`` 64, to 64: forwards finite, b64 forward + decode img/s at
    128, 102 and 64 channels. ``--deployment`` runs phases 1, 2 and 18
    alone;
19. the spatial axis on the one card (``fdtpu_torch.parallel``'s data x
    spatial grid of ranks, the row-halo exchange, each family's spatial
    forward) for every family at 480 px: PoolResnet-128x10 grid 10
    (``DetectorConfig()``), SSD-16, MobileNetV3-Small grid 15, Resnet-64
    grid 15, SeparableCNN-128 grid 10, each rank a spawned process that
    loads the kernels phase 2 built: (a) NCCL at world size 1 on a 1 x 1
    mesh, through the spatial step, b8, bf16 compute, SAM + Adam: one step
    against the plain step from the same state, augmentation and dropout
    off, deterministic algorithms where torch has them (phase 17a's loss
    rtol 1e-6, update rel. L2 1e-4), then three steps with the family's
    augmentation (rotation on the card; none for the SSD, as it trains)
    and train metrics (K1 once a step, three shear launches a rotating
    step); the plain and the spatial step timed in turns, three runs; then
    the spatial step captured in a CUDA graph (SAM + Adam, rotation on the
    card but for the SSD): five replays against five eager spatial steps,
    bit-equal as in 17a, and the spatial step eager and replayed against
    the replayed plain step, in turns (median and range of three runs of
    50, of 10 for the eager arm), with the graph's pool and capture s;
    (b) four gloo ranks on the card: a 1 x 2 mesh on ranks 0 and 1, then
    a 2 x 2 mesh on all four, float32 SAM + SGD, global batch 8 with one
    padded sample, each against the one-process step on the global batch
    at phase 8's tolerances (MobileNetV3: its ``bn3`` biases held to a
    negligible update, its running statistics within 1e-3), params
    identical on every rank of the mesh; on each mesh the output gathered
    from each rank's rows against the one-process forward, atol 1e-4: of
    its data row with the same dropout masks, MobileNetV3's in train mode
    of the global batch (its BatchNorms sum their statistics over the
    mesh); the SSD also counts the mined negatives that differ between
    the two forwards without dropout, as phase 15 does; (c) each family's
    spatial step ms and its collectives' ms (``parallel.halo.timer``: the
    row exchanges forward and backward, MobileNetV3's BatchNorm and
    squeeze-excite sums under their own kinds) on each mesh, with the
    one-process step's: what the axis costs on one card with gloo's host
    staging, not a scaling number. A rank that fails or outlives its
    timeout fails the script. ``--spatial`` runs phases 1, 2 and 19 alone;
20. the last entry points: (a) ``fdtpu_torch.demo_model.run_camera`` on
    the card, a bf16 Detector of PoolResnet-128x10 grid 10 at 480 px
    (``demo_model``'s flags ``--filters 128 --prob-threshold 0.5``, random
    weights from seed 0, the head's score bias shifted so that 5% of the
    frames' cells pass), fed by a stub ``cv2`` in ``sys.modules`` that
    serves 30 BGR 640x480 frames (``make_synthetic_widerface`` images
    resized) and then fails a read: each frame's rectangles equal the boxes
    of a separate ``predict`` on the same RGB frame, as ints, as many as
    its mask keeps, some frame has one, K1 launched once a frame in the
    loop and once a checking call; ms a frame by CUDA events around
    ``predict`` and by the host clock around the whole frame, median and
    range; (b) the native JPEG feed on the card's host: the C++ loader
    loads (the libjpeg it resolved printed), ``WIDERFaceDataSource()``
    decodes through it by default, and ``get_batch`` equals per-sample
    ``get`` bit for bit at b8/480 and b128/320 on 256 JPEGs of 1024x768 at
    quality 90 (``make_synthetic_widerface`` images resized, from the
    seed); host decode ms a batch, PIL against native, medians of 5, cache
    off, at the loader's default threads (``os.cpu_count()`` printed); the
    first-epoch ``BatchLoader`` feed in img/s at b128/320 with each decoder.
    ``--entry`` runs phases 1, 2 and 20 alone;
21. the train step captured in a CUDA graph
    (``fdtpu_torch.train.graphs.CapturedTrainStep``), bf16 compute, SAM +
    Adam, at full width: PoolResnet-128x10 grid 10 at b8/480 with rotation
    (the shears in the graph), ``bench.py``'s PoolResnet-128x10 grid 15 at
    b128/320 with rotation and ``fused_photometric`` (K5 in the graph too),
    SSD-16 at b24/480 with augmentation off, MobileNetV3-Small grid 15 at
    b8/480 with rotation (its BatchNorm statistics in the graph): (a) five
    eager steps and five replays, each from its own copy of the same state,
    on five batches: losses, grad norms, params, buffers, Adam moments and
    step counts bit-equal, no wrapper count ticking on a replay, and the
    kernel launches a replay recorded at the capture times the replays
    equal to the eager steps' counts, the graph's private pool bytes and
    its warm-up + capture seconds; (b) the Trainer at ``DetectorConfig()``
    b8 with rotation on 48 / 16 synthetic images, two epochs, streamed
    (``steps_per_dispatch`` 1 and 4) and with ``device_data``, each
    replaying its captured step, bit-equal to the same fits run eagerly
    (``Trainer.replaying`` off), and a replayed fit resumed after its first
    epoch bit-equal to the straight one (epoch metrics, step, params, Adam
    moments and steps; the fits replay their metrics and eval steps too,
    and the eager fits run all three eagerly); then ``fdtpu_torch.bench``'s
    graph rows with short
    loops (the captured b128 step, the b128 ``GraphPredict`` with K1
    inside). ``--graph`` runs phases 1, 2 and 21 alone and adds (c): eager
    against graph for each model, step ms as the median and range of three
    runs of 50 steps in turns, img/s, device busy ms over a profiled window
    of five steps and the idle share of that window (the profiler lengthens
    it) and of the median (two runs: it can read below 0), kernels and host
    launch calls a step,
    and one more train epoch of each 21b fit by the host clock. Phases 14
    and 16 replay the Trainer's captured step too, and phases 14-16 and 21
    count the replays' shear and K5 launches (a replay adds its graph's
    ``per_replay`` to ``LAUNCHES``);
22. serving and eval replayed from CUDA graphs (``utils/graphs.py``), each
    replay held to its eager body bit for bit: (a) a bf16 Detector of each
    family at 480 px at phase 16's widths (PoolResnet-128x10 grid 10,
    SSD-16, MobileNetV3-Small, Resnet-64, SeparableCNN-128; each score bias
    shifted so that 5% of a seeded frame's candidates pass 0.5): ``predict``
    on a 480x480 u8 frame, a 640x480 u8 frame (PIL resize) and a float32
    frame at 0.5/0.5 and 0.7/0.01 in turn, twice (four graphs, twelve
    replays), against ``predict_body`` called directly (normalised image,
    boxes, mask); ``non_max_suppression`` at both pairs at B 1, 8 and 128
    (PoolResnet), SSD b24/480 and b8/640 (K1's global scratch inside the
    graph) against the eager decode; (b) every family's eval step at b8
    (bf16, one padded sample), batch and gather forms, against the eager
    step; the Trainer's streamed and resident eval epochs on phase 14's
    images against the same epochs run eagerly (``Trainer.replaying``
    off); the metrics train step (five replays against five eager steps, 21a's
    check); ``run_validation_epoch --with-ap`` on phase 14's checkpoint
    with the replay rule on and off (``GroupTrainer``'s eval over NCCL is
    17a's fits); (c) in turns: the b1 ``predict`` of PoolResnet-128 and
    SSD-16, eager body against replay, medians of 3 x 2,000 by CUDA events,
    then 20 of each under torch.profiler (device busy ms, kernels and host
    launch calls a predict); phase 20a's camera frame by the host clock,
    three runs each, its ``predict`` call and the ``host_frame`` step (the
    PIL resize) in it timed apart; one eval epoch of 256 synthetic images
    (32 batches of b8) of each feed, three runs each by the host clock and
    one under the profiler; each with its graph's pool MiB and capture s.
    ``--serve`` runs phases 1, 2 and 22 alone. Phases 5, 6, 14-18 and 20
    go through the same replays (K1 counted once a call, eager or
    replayed; the warm-ups before a capture apart, as each graph measured
    them: :func:`warm_ups`).
23. PoolResnet-128's narrow convolutions in the no-grad bf16 forward
    (``layers.narrow_conv``): the 3-channel stem and the 5-channel head,
    channels_last, at b1, b2, b4, b8, b16 and b32 at 480 px and b1, b4, b8
    and b128 at 320 px (the head's input the blocks' output of a random
    frame), ``F.conv2d`` through cuDNN against ``conv_gemm`` (im2col and
    one GEMM), ten calls of an arm replayed from one CUDA graph and timed
    by ``device_ms``, in turns (cuDNN, GEMM, GEMM, cuDNN, twice), each arm's
    largest error against the float32 convolution of the same bf16
    operands beside one bf16 step at the output's scale, the form the rule
    picks and, at b1, each arm's kernels; the rejected candidate (the
    stem's input channels zero-padded to 8 through cuDNN) timed once at
    each shape. One JSON line, ``narrow_convs``. ``--stem`` runs phases 1
    and 23 alone.
24. RetinaFace-R50 at 840 px (every ``cfg_re50`` width, random weights):
    K1 at its served shape, B=1, N=29,126 priors, capacity 750, thresholds
    0.6/0.4, on its global-scratch path, the plain op and the indexed op
    (``fdtpu_decode_filter_nms_indexed``) on served-like maps (about 60
    candidates over 0.6), saturated and tie maps, outputs allocated over
    0xFF blocks, bit-equal to the plain version (the index too), one
    scratch launch a call; then the bf16 Detector's ``predict`` on a frame
    (the face-score biases shifted so that 50 of the float32 forward's
    candidates score over 0.6, the served threshold), three replays after the
    capture with the counters zeroed first: K1 and its scratch path
    launched once a replay and no eager launch, boxes compacted, the
    landmarks zero past the kept rows, every replay's answer the same.
    One JSON line, ``retinaface``. ``--retinaface`` runs phases 1, 2 and
    24 alone.
25. the fused BatchNorm epilogue (``kernels/bn_act.py``, a kernel of the
    port alone) at every chain the bf16 RetinaFace-R50 serves at 840 px
    (73 calls of ``layers.bn_act`` a forward, recorded from the forward;
    BatchNorm params and statistics random, off the identity): each
    distinct chain bit-equal to the eager chain (``F.batch_norm``, ``+
    skip``, ReLU) and timed against it, ten calls of an arm replayed from
    one CUDA graph and timed by ``device_ms`` in turns (chain, kernel,
    kernel, chain; warm: the same buffers each call), beside its bytes
    bound (y, skip and the output once at 3.35 TB/s); each summed over a
    frame's calls. Then the 840 px ``predict`` graph with the epilogue (73
    launches a replay) and with the eager chain, their replays timed by
    ``device_ms`` in turns, and their answers equal. One JSON line,
    ``bn_act``. ``--bn-act`` runs phases 1, 2 and 25 alone and ends with
    a ``kernels`` line that holds the ``bn_act`` entry alone (below).

The line before the last is a JSON object with each kernel's launches on
the paths (:data:`PATH_LAUNCHES`: the delta of ``kernels/launches.py``'s
``LAUNCHES`` over each path's own run, the serving, training, fused,
Trainer, SSD, zoo, data-parallel, deployment, spatial, camera, graph,
serve and RetinaFace paths, with the warm-ups before their captures and
their CUDA graphs' replays; 17a's, 17c's and 19a's handed back by their
ranks; the checks against the plain versions and the timing phases are no
path), error, times, and its bound: the
larger of the bytes it must move over the card's 3.35 TB/s and the
operations it does on this run's inputs over the 67 TFLOP/s of float32
outside the tensor cores (H100 SXM data sheet). ``library_ms`` is the time
of one ``F.grid_sample`` call (bilinear, zero padding, align_corners) for
the shears' float32 rows, the same function within float32 rounding of its
normalised coordinates; null for the bfloat16 rows (its grid would be
bfloat16 too) and for the other kernels: no single PyTorch call computes a
batched greedy NMS, the photometric chain or the fused tail.
The ``bn_act`` entry (a kernel of the port alone, ``replaces`` null) is
phase 25's: its launches a RetinaFace predict replay, error 0 (each chain
bit-equal), and a frame's kernel time,
eager chain (``plain_ms``) and bytes bound summed over its 73 calls. The
``decode_filter_nms``, the shears', ``residual_tail`` and ``bn_act``
entries also list every shape they were timed at (``shapes``); K4 has an
entry of its own, ``shear_rows_stacked`` (``shear_rows`` with ``c = 1``),
whose launches on the paths are counted apart (none: no path stacks
channels), and the ``shear_rows`` entry's launches are K3a's alone.
The last line is ``{"ok": true, "device": {...}}``. Weights are random,
drawn from a fixed seed.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from fdtpu_torch import bench as fbench
from fdtpu_torch import bench_pool_fusion as bpf
from fdtpu_torch import run_validation_epoch, train_model, train_model_ssd
from fdtpu_torch.compat import torch_import
from fdtpu_torch.data import BatchLoader, WIDERFaceDataSource, load_targets
from fdtpu_torch.data import augment as aug
from fdtpu_torch.data import make_synthetic_widerface
from fdtpu_torch.kernels import LAUNCHES
from fdtpu_torch.kernels import bn_act as kbn
from fdtpu_torch.kernels import build
from fdtpu_torch.kernels import epilogue as kep
from fdtpu_torch.kernels import nms as knms
from fdtpu_torch.kernels import photometric as kphoto
from fdtpu_torch.kernels import rotate as krot
from fdtpu_torch.losses.ssd import hard_negative_mining
from fdtpu_torch.kernels.conv_gemm import conv_gemm
from fdtpu_torch.models import layers
from fdtpu_torch.models.layers import BatchNorm, DropoutMasks, conv, narrow_conv
from fdtpu_torch.models import (
    DTYPES,
    SSD,
    Detector,
    MobileNetV3Backbone,
    PoolResnet,
    Resnet,
    SeparableCNN,
    build_model,
    has_batch_stats,
    ssd_patch_sizes,
)
from fdtpu_torch.parallel import (
    data_shard,
    grad_all_reduce,
    initialize_multihost,
    launch_local_ranks,
    make_dp_train_step,
    make_mesh,
    shutdown,
    spatial_forward,
    spatial_plan,
)
from fdtpu_torch.parallel import halo as khalo
from fdtpu_torch.train import (
    CapturedEvalStep,
    CapturedTrainStep,
    Trainer,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from fdtpu_torch.train import step as tstep
from fdtpu_torch.train.checkpoint import latest_checkpoint
from fdtpu_torch.train.sam import global_norm
from fdtpu_torch.utils import graphs as ugraphs
from fdtpu_torch.utils.config import DetectorConfig, RetinaFaceConfig, SSDConfig, TrainConfig
from fdtpu_torch.utils.tb import read_scalars

SEED = 0
FORWARD_ATOL = 1e-4  # float32 card vs CPU: summation order only, TF32 off
BENCH_CFG = DetectorConfig(input_shape=(320, 320), num_patches=15, nms_capacity=64)
KERNEL = {
    "name": "decode_filter_nms",
    "route": "cuda",
    "source": "fdtpu_torch/kernels/csrc/decode_filter_nms.cu",
    "replaces": "fdtpu/kernels/nms_pallas.py:197",
}
SHEARS = {  # K3a, K3b and K4 (shear_rows on channel-stacked planes, c = 1)
    "shear_rows": {"route": "cuda", "source": "fdtpu_torch/kernels/csrc/rotate_shear.cu",
                   "replaces": "fdtpu/kernels/rotate_pallas.py:197"},
    "shear_rows_stacked": {"route": "cuda", "source": "fdtpu_torch/kernels/csrc/rotate_shear.cu",
                           "replaces": "fdtpu/kernels/rotate_pallas.py:55"},
    "shear_cols": {"route": "cuda", "source": "fdtpu_torch/kernels/csrc/rotate_shear.cu",
                   "replaces": "fdtpu/kernels/rotate_pallas.py:232"},
}
PHOTOMETRIC = {"name": "photometric", "route": "cuda",
               "source": "fdtpu_torch/kernels/csrc/photometric.cu",
               "replaces": "fdtpu/kernels/augment_pallas.py:108"}
RESIDUAL_TAIL = {"name": "residual_tail", "route": "cuda",
                 "source": "fdtpu_torch/kernels/csrc/residual_tail.cu",
                 "replaces": "fdtpu/kernels/epilogue_pallas.py:49"}
BN_ACT = {"name": "bn_act", "route": "cuda", "source": "fdtpu_torch/kernels/csrc/bn_act.cu",
          "replaces": None}  # a kernel of the port alone
PATH_KERNELS = ("decode_filter_nms", *SHEARS)  # what phases 17a and 19a count on a path
TRAIN_RTOL_LOSS, TRAIN_RTOL_GRAD_NORM = 1e-4, 1e-3
TRAIN_RTOL_UPDATE, TRAIN_RTOL_UPDATE_TENSOR = 1e-2, 5e-2  # relative L2, phase 8
TRAIN_STEPS = 5
BN_RTOL = 1e-3  # phase 16: the batch statistics a BatchNorm folds in, f32, card vs CPU
FUSED_STEPS = 3
NOISE_ATOL = 1e-6  # K5 with noise on: logf/cosf against PyTorch's log/cos
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s
F32_OPS_PER_MS = 67e9  # H100 SXM: 67 TFLOP/s float32 outside the tensor cores
# operations counted per element (each multiply, add, compare, integer op,
# conversion and transcendental is one)
# K1: the filter's compare on every candidate; the decode of each eligible
# one (score above the threshold); a greedy round's IoU test of each eligible
# one of its image
NMS_FILTER_OPS, NMS_DECODE_OPS, NMS_ROUND_OPS = 1, 17, 14
SHEAR_OPS = 4  # (1 - f) a + f b
# K5, per pixel and channel: brightness/contrast, clip and /255 on every
# plane; the noise (two murmur3 mixes, Box-Muller) and the two 5-tap passes
# on their planes; 2 a motion tap on the motion planes
PHOTO_BASE_OPS, PHOTO_NOISE_OPS, PHOTO_GLASS_OPS = 5, 30, 18
TAIL_OPS = 3  # leaky, add, max, per input element
NMS_TIMED = ((128, 225, 64), (1, 100, 128), (128, 4774, 128))  # (B, N, capacity)
K6_SHAPES = (((128, 128, 40, 40), True), ((128, 128, 20, 20), False),
             ((1, 128, 60, 60), True), ((1, 128, 30, 30), True), ((1, 128, 15, 15), False))
L2_FLUSH_BYTES = 150e6  # three times the H100's 50 MB L2
TRAINER_IMAGES = (48, 16)  # phase 14's synthetic train and val images
TRAINER_EPOCHS = 2
BENCH_LOOPS = (5, 20, 50)  # phase 14's short train, infer and b1 loops, one rep
SSD_CFG = SSDConfig()  # SSD-16, 480 px, patch sizes (60, 30, 15, 7): 4,774 priors
SSD_640 = SSDConfig(input_shape=(640, 640), patch_sizes=ssd_patch_sizes((640, 640)))  # 8,500
SSD_BATCH, SSD_640_BATCH = 24, 8
SSD_FACES = 4  # boxes an image in phase 15's batches
SSD_TRAINER_IMAGES = (192, 24)  # two steps a quarter-epoch at b24, one val batch
# phase 16: the rest of the zoo at 480 px, at the widths their reference
# configurations train at
ZOO_SIZE = 480
ZOO = {
    "mobilenetv3": DetectorConfig(num_patches=15),  # MobileNetV3-Small, grid 480 / 32 = 15
    "resnet": DetectorConfig(filters=64, num_patches=15),  # Resnet-64, 10 blocks, grid 15
    "separable": DetectorConfig(num_patches=16),  # SeparableCNN-128, 10 blocks, grid 10
}
ZOO_SERVE_BATCH, ZOO_TRAIN_BATCH = 64, 8
ZOO_TRAIN_STEPS = {"mobilenetv3": 5, "resnet": 2, "separable": 2}
ZOO_TRAINER_IMAGES = (48, 16)  # six steps at b8, two val batches
# phase 17: data parallelism
DP_RANK_TIMEOUT_S = 300  # a rank that runs longer fails the script
DP_LOSS_RTOL, DP_UPDATE_RTOL = 1e-6, 1e-4  # 17a, world 1: g * w / w may round by an ulp
DP_BN_RTOL = 1e-5  # 17b: MobileNetV3's statistics against the mean of the ranks' own updates
DP_BATCH = 128  # 17a's batch and 17b's global batch (64 + 64), at the bench shape
DP_STEPS, DP_TIMED_STEPS = 3, 10
DP_MOBILENET_BATCH = 8  # a rank's
DP_TRAINER_BATCH = 8  # global: 4 + 4
DP_TRAINER_IMAGES = (16, 8)  # two steps an epoch, one val batch
# 17a replayed: the DP step captured with its NCCL collectives, label ->
# GRAPH_MODELS' tuple (both on fdtpu's shard_map route: rotation on the card)
DP_GRAPH_MODELS = {
    "poolresnet-b128-320": ("poolresnet", BENCH_CFG, DP_BATCH, {"rotate_device": True}, True),
    "mobilenetv3-b16-480": ("mobilenetv3", ZOO["mobilenetv3"], 2 * DP_MOBILENET_BATCH,
                            {"rotate_device": True}, True),
}
# phase 18: deployment
DEPLOY_SIZE = 480
DEPLOY_BATCHES = (1, 8)
DEPLOY_THRESHOLDS = (0.7, 0.01, 64)  # the reference converter's, fdtpu's export defaults
DEPLOY_PASS = {"poolresnet": 0.5, "ssd": 48 / 4774}  # candidates over the threshold, a frame
EXPORT_ATOL = 1e-3  # px, fdtpu's export round trip (tests/test_compat.py)
NATIVE_ATOL, NATIVE_RTOL = 2e-3, 1e-4  # the engine against the float32 predict (test_native_infer)
LATENCY_LOOPS, LATENCY_ITERS = 3, 2000
NATIVE_FRAMES = 8
PRUNE_BATCH = 64
# K1 on trained val maps (config_of_record, PERF.md §6): eligible candidates an image
K1_RECORDED = (("trained PoolResnet val maps", (8, 100, 64), 2.29),
               ("trained SSD-16 val maps, bg_push 0.02", (24, 4774, 64), 17.8),
               ("trained SSD-16 val maps, bg_push 0", (24, 4774, 64), 4564))
# phase 19: the spatial axis, every family of the zoo at 480 px
SP_RANK_TIMEOUT_S = 600
SP_BATCH = 8  # 19a's batch and 19b's global batch
SP_STEPS, SP_TIMED_STEPS = 3, 5
SP_EAGER_TIMED_STEPS = 10  # 19a replayed: the eager spatial arm's steps a run (host-bound, slow)
SP_NAMES = {"poolresnet": "PoolResnet-128x10 grid 10", "ssd": "SSD-16",
            "mobilenetv3": "MobileNetV3-Small grid 15", "resnet": "Resnet-64x10 grid 15",
            "separable": "SeparableCNN-128x10 grid 10"}
SP_FAMILIES = tuple(SP_NAMES)
# 19a replayed: each family's spatial step on the 1 x 1 mesh captured, as
# GRAPH_MODELS' tuples (rotation on the card; none for the SSD, as it trains)
SP_GRAPH_MODELS = {
    family: (family, {"poolresnet": DetectorConfig(), "ssd": SSD_CFG}.get(family, ZOO.get(family)),
             SP_BATCH, {} if family == "ssd" else {"rotate_device": True}, family != "ssd")
    for family in SP_FAMILIES
}
# phase 20: the last entry points
CAMERA_ARGS = ["--filters", "128", "--prob-threshold", "0.5"]  # the README's serving flags
CAMERA_FRAMES = 30
CAMERA_HW = (480, 640)  # a webcam's VGA frame, rows x columns
CAMERA_PASS = 0.05  # the frames' cells over the threshold, see camera_detector
FEED_JPEG_WH, FEED_QUALITY = (1024, 768), 90  # WIDERFace's image width
FEED_IMAGES = 256  # two b128 batches a first epoch
FEED_SHAPES = ((8, 480), (128, 320))  # (batch, side) of the decode timings
FEED_REPS = 5
# phase 21: the train step in a CUDA graph; label -> (family, config, batch,
# TrainConfig fields, augment)
GRAPH_MODELS = {
    "poolresnet-b8-480": ("poolresnet", DetectorConfig(), 8, {"rotate_device": True}, True),
    "poolresnet-b128-320": ("poolresnet", BENCH_CFG, 128,
                            {"rotate_device": True, "fused_photometric": True}, True),
    "ssd-b24-480": ("ssd", SSD_CFG, 24, {}, False),
    "mobilenetv3-b8-480": ("mobilenetv3", ZOO["mobilenetv3"], 8, {"rotate_device": True}, True),
}
GRAPH_STEPS = 5
GRAPH_RUNS, GRAPH_TIMED_STEPS, GRAPH_PROFILED_STEPS = 3, 50, 5
# phase 22: serving and eval replayed from CUDA graphs; the five families at
# 480 px at phase 16's widths
SERVE_MODELS = {"poolresnet": DetectorConfig(), "ssd": SSD_CFG, **ZOO}
SERVE_PASS = 0.05  # a seeded frame's candidates over 0.5, see serve_model
SERVE_THRESHOLDS = ((0.5, 0.5), (0.7, 0.01))
SERVE_NMS_BATCHES = (1, 8, 128)  # PoolResnet's; the SSD's at b24/480 and b8/640
SERVE_EVAL_BATCH = 8
SERVE_TIMED = ("poolresnet", "ssd")  # 22c's b1 predict
SERVE_TURNS = 3  # 22c's camera and eval-epoch runs, each arm
SERVE_PROFILED = 20  # 22c's b1 predicts under the profiler, each arm
SERVE_EPOCH_IMAGES = (16, 256)  # 22c's eval epoch: synthetic train and val images (32 batches)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def nms_bound(vals, tables, boxes, mask, prob: float = 0.5) -> tuple[dict, int, int]:
    """K1's bound on this data: every candidate read and compared; only the
    eligible ones (score above ``prob``) decoded and scanned, once a greedy
    round of their image (its kept rows, plus the round that finds none
    alive when fewer than capacity survive), whatever implements it.
    Returns the bound, the rounds and the eligible candidates in all."""
    b, n, _ = vals.shape
    eligible = (vals[..., 0] > prob).sum(-1)
    kept = mask.sum(-1)
    rounds = kept + (kept < mask.shape[-1]).long()
    ops = (b * n * NMS_FILTER_OPS + int(eligible.sum()) * NMS_DECODE_OPS
           + int((rounds * eligible).sum()) * NMS_ROUND_OPS)
    return (bound(nbytes(vals, *tables[:4], boxes, mask), ops), int(rounds.sum()),
            int(eligible.sum()))


def k1_recorded_map_bounds() -> list[dict]:
    """K1's bound (``nms_bound``'s count) on the trained val maps that
    ``config_of_record`` timed (PERF.md §6), from their recorded eligible
    candidates an image, which stand in for the maps (not kept): each
    image's eligible count spread evenly and one greedy round an image,
    the least any map with that count needs, so a lower bound on the
    bound."""
    rows = []
    for what, (b, n, cap), per_image in K1_RECORDED:
        eligible = round(b * per_image)
        vals = torch.zeros((b, n, 5))
        vals[..., 0] = 0.1
        for i in range(eligible):
            vals[i % b, i // b, 0] = 0.9
        boxes, mask = torch.zeros((b, cap, 5)), torch.zeros((b, cap), dtype=torch.bool)
        bnd, rounds, counted = nms_bound(vals, tables_for(n), boxes, mask)
        check(counted == eligible and rounds == b, f"K1 recorded bound counts {counted}, {rounds}")
        rows.append({"maps": what, "shape": [b, n, cap], "eligible": eligible, **bnd})
        print(f"[K1 bound] {what} B={b} N={n} cap={cap}: {per_image} eligible an image (recorded) "
              f"-> {eligible} in all, one round an image: bound {bnd['bound_ms']:.3g} ms "
              f"({bnd['bound_by']}), a lower bound on the bound")
    return rows


# -- inputs ----------------------------------------------------------------------


def candidates(rng, b, n, case, eligible=None):
    """(B, N, 5) rows [conf, x, y, w, h] in the model's [0, 1] units. With
    ``eligible``, exactly that many rows an image score 0.9 and the rest
    0.1, all boxes of zero size (nothing suppresses anything)."""
    v = rng.uniform(0, 1, size=(b, n, 5)).astype(np.float32)
    if eligible is not None:
        v[..., 0] = 0.1
        for i in range(b):
            v[i, rng.choice(n, size=eligible, replace=False), 0] = 0.9
        v[..., 3:] = 0.0
    elif case == "saturated":  # small, mostly disjoint boxes: > capacity survive
        v[..., 3:] = rng.uniform(0.002, 0.03, size=(b, n, 2))
    elif case == "tie":  # three score levels, many exact ties
        v[..., 0] = rng.choice(np.float32([0.3, 0.75, 0.9]), size=(b, n))
        v[..., 3:] *= 0.1
    elif case == "equal":  # every score the same: the index decides
        v[..., 0] = 0.75
        v[..., 3:] *= 0.1
    elif case == "negative":  # scores in [-1, -0.4]: a score <= -0.5 ends the scan
        v[..., 0] = rng.uniform(-1, -0.4, size=(b, n))
        v[..., 3:] *= 0.1
    elif case == "signed zeros":  # +0.0 and -0.0 tie; the index decides
        v[..., 0] = rng.choice(np.float32([0.0, -0.0, -0.25, -0.6]), size=(b, n))
        v[..., 3:] *= 0.1
    elif case == "empty":
        v[:] = 0.0
    else:  # random
        v[..., 3:] *= 0.3
    return torch.from_numpy(v).cuda()


def poison(*shapes_dtypes) -> None:
    """Leave NaN / 0xFF blocks of these shapes in the caching allocator, so
    that a kernel which skips an output entry it should write shows it."""
    for shape, dtype in shapes_dtypes:
        t = torch.empty(shape, dtype=dtype, device="cuda")
        t.view(torch.uint8).fill_(0xFF)
        del t


def tables_for(n):
    if n == 4774:  # SSD model output, 480 px
        cols = knms.ssd_output_decode_tables(n, (480, 480))
    elif n > 4774:  # past the shared-memory path: SSD output tables at 632 px
        cols = knms.ssd_output_decode_tables(n, (632, 632))
    else:
        s = int(round(n ** 0.5))
        cols = knms.grid_decode_tables(s, (480, 480) if s == 10 else (320, 320))
    return (*(torch.from_numpy(c).cuda() for c in cols[:4]), *cols[4:])


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_s() -> float:
    """The rate at which ``torch.cuda._sleep`` spins, from one timed sleep."""
    torch.cuda._sleep(1000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / (start.elapsed_time(end) / 1e3)


def queue_behind_sleep(host_s: float) -> None:
    """Occupy the card for longer than ``host_s`` seconds of host launches
    (at most half a second), so that the launches queue up behind it."""
    torch.cuda._sleep(int(sleep_cycles_per_s() * min(1.5 * host_s + 1e-3, 0.5)))


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """The card's time for one call of ``fn``: the calls are queued behind a
    sleep that outlasts their launches on the host, so the card runs them
    back to back and the CUDA events around them time the card alone, not
    the host's launch cost. (A ``fn`` that synchronises, as a plain
    version's ``nonzero`` does, runs at the host's pace as in
    ``event_ms``.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    queue_behind_sleep(host_s * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int) -> float:
    """Host microseconds one call of ``fn`` takes to launch, with the card
    busy behind a sleep so that no launch waits for a free queue slot."""
    fn()
    torch.cuda.synchronize()
    queue_behind_sleep(2e-4 * iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


# -- phases ----------------------------------------------------------------------


def phase_card() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs only on a GPU")
    card = bpf.card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"[1 card] {name}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    return card, name


def phase_build() -> None:
    fresh = not build.library_path().exists()
    t0 = time.perf_counter()
    build.load_library()
    print(f"[2 build] {build.library_path().name} in {time.perf_counter() - t0:.2f} s "
          f"({'compiled' if fresh else 'already built'}); max N per image "
          f"{knms.max_candidates(0)}")


def phase_kernel_vs_plain() -> float:
    rng = np.random.default_rng(SEED)
    worst, runs = 0.0, 0

    def same_fit(vals, tables, prob, iou, cap, where):
        nonlocal worst, runs
        b = vals.shape[0]
        # the kernel writes every entry: uninitialised outputs full of 0xFF
        poison(((b, cap, 5), torch.float32), ((b, cap), torch.bool))
        gb, gm = knms.decode_filter_nms_batch(vals, tables, prob, iou, cap)
        wb, wm = knms.decode_filter_nms_reference(vals, tables, prob, iou, cap)
        torch.cuda.synchronize()
        err = (gb - wb).abs().max().item()
        worst = max(worst, err)
        runs += 1
        check(torch.equal(gm, wm), f"masks differ at {where}")
        check(torch.equal(gb, wb), f"boxes differ at {where} (max {err})")
        return gm

    for b in (1, 8, 128):
        for n in (100, 225, 4774):
            tables = tables_for(n)
            for cap in (64, 128):
                for case in ("random", "saturated", "tie", "equal", "empty"):
                    vals = candidates(rng, b, n, case)
                    for prob, iou in ((0.5, 0.5), (0.7, 0.01)):
                        where = f"B={b} N={n} cap={cap} {case} {prob}/{iou}"
                        gm = same_fit(vals, tables, prob, iou, cap, where)
                        if case == "saturated" and prob == 0.5 and n / 2 > 1.5 * cap:
                            check(bool(gm.all()), f"not saturated at {where}")
                        if case == "empty":
                            check(not gm.any(), f"boxes from an empty map at {where}")
                # thresholds below -0.5: negative scores, and +0.0 / -0.0 ties
                for case, prob in (("negative", -0.7), ("signed zeros", -0.3)):
                    vals = candidates(rng, b, n, case)
                    same_fit(vals, tables, prob, 0.5, cap, f"B={b} N={n} cap={cap} {case} {prob}/0.5")
                # eligible counts at the edges: capacity, one above it, and
                # the rank sort's limit of 256 against the bitonic sort's 257
                for m in (cap, cap + 1, 256, 257):
                    if m > n:
                        continue
                    vals = candidates(rng, b, n, None, eligible=m)
                    gm = same_fit(vals, tables, 0.5, 0.5, cap, f"B={b} N={n} cap={cap} M={m}")
                    check(bool((gm.sum(-1) == min(m, cap)).all()), f"M={m} kept != {min(m, cap)}")
    # past the shared-memory limit: the same kernel on global scratch
    large = large_n()
    for b in (1, 8):
        for n in large:
            tables = tables_for(n)
            for case in ("random", "saturated", "tie"):
                vals = candidates(rng, b, n, case)
                gm = same_fit(vals, tables, 0.5, 0.5, 128, f"B={b} N={n} cap=128 {case} (scratch)")
                if case == "saturated":
                    check(bool(gm.all()), f"not saturated at B={b} N={n}")
    print(f"[3 kernel=plain] {runs} cases bit-equal (masks, scores, coordinates; outputs "
          f"allocated over 0xFF): random, saturated, tie, equal, empty, negative scores under "
          f"threshold -0.7, +-0.0 under -0.3, M = cap, cap + 1, 256, 257; past the shared-memory "
          f"limit of {knms.max_candidates(0)} (global scratch): N = {large}, B = 1 and 8, cap 128, "
          f"random, saturated, tie; max |kernel - plain| = {worst}")
    return worst


def large_n() -> tuple[int, ...]:
    """N past the kernel's shared-memory path: one past its limit, the SSD
    map at 632 px, and 20,000."""
    return (knms.max_candidates(0) + 1, 8204, 20000)


def phase_forward_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DetectorConfig()
    cpu = build_model("poolresnet", cfg, "cpu", torch.Generator().manual_seed(SEED)).eval()
    gpu = build_model("poolresnet", cfg, "cuda", torch.Generator().manual_seed(SEED)).eval()
    u8 = np.random.default_rng(SEED + 1).integers(0, 256, size=(2, 480, 480, 3), dtype=np.uint8)
    x = torch.from_numpy(u8).float() / 255.0
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.cuda()).cpu()
    check(got.shape == (2, 10, 10, 5), f"forward shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite forward output")
    err = (got - want).abs().max().item()
    live = ((want > 0.01) & (want < 0.99)).float().mean().item()
    check(err <= FORWARD_ATOL, f"card forward differs from CPU by {err} > {FORWARD_ATOL}")
    print(f"[4 forward f32] PoolResnet-128x10 480px B=2, card vs CPU max abs err {err:.3g} "
          f"(atol {FORWARD_ATOL}); {live:.0%} of outputs in (0.01, 0.99)")


def check_boxes(boxes, mask, cap, prob, what):
    check(boxes.shape[-2:] == (cap, 5) and mask.shape[-1] == cap, f"{what} shape")
    check(bool(torch.isfinite(boxes).all()), f"{what} non-finite boxes")
    kept = mask.sum(-1)
    # compacted: the first `kept` rows are valid, the rest are zero
    check(bool((mask == (torch.arange(cap, device=mask.device) < kept[..., None])).all()),
          f"{what} rows not compacted")
    check(bool((boxes[~mask] == 0).all()), f"{what} invalid rows not zero")
    check(bool((boxes[..., 0][mask] > prob).all()), f"{what} score below threshold")
    return kept


def phase_main_path():
    gen = torch.Generator().manual_seed(SEED)
    det480 = Detector(build_model("poolresnet", DetectorConfig(), "cuda", gen))
    det320 = Detector(build_model("poolresnet", BENCH_CFG, "cuda", gen),
                      nms_capacity=BENCH_CFG.nms_capacity)
    rng = np.random.default_rng(SEED + 2)
    frames = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
              for h, w in ((377, 501), (480, 641), (211, 173))]
    batch = torch.from_numpy(
        rng.integers(0, 256, size=(128, 320, 320, 3), dtype=np.uint8)).cuda()

    start = LAUNCHES.copy()
    preds = [det480.predict(f) for f in frames]
    out = det320.apply(batch.float() / 255.0)
    boxes, mask = det320.non_max_suppression(out)
    torch.cuda.synchronize()
    launches = on_path(start)["decode_filter_nms"]  # both replayed: K1 in the graphs
    calls = launches - warm_ups(det480, det320)["decode_filter_nms"]
    check(calls == len(frames) + 1, f"kernel launched {calls} times, want {len(frames) + 1}")

    counts = []
    for norm, b, m in preds:
        check(norm.shape == (480, 480, 3), "predict image shape")
        counts.append(int(check_boxes(b, m, 128, 0.5, "predict")))
    check(out.shape == (128, 15, 15, 5) and out.dtype == torch.float32, "batch forward shape")
    check(bool(torch.isfinite(out).all()), "non-finite batch forward")
    kept = check_boxes(boxes, mask, 64, 0.5, "batch")
    wb, wm = knms.decode_filter_nms_reference(
        out.reshape(128, -1, 5), knms.grid_tables_on(15, (320, 320), out.device), 0.5, 0.5, 64)
    check(torch.equal(mask, wm) and torch.equal(boxes, wb), "batch boxes differ from plain")
    print(f"[5 main path] bf16 Detector on the card: predict x3 at 480px -> {counts} boxes; "
          f"b128 at 320px/grid 15 -> {int(kept.sum())} boxes (min {int(kept.min())}, "
          f"max {int(kept.max())} per image); kernel launches {launches} ({calls} calls, "
          f"replayed from CUDA graphs, and the warm-ups before their captures); batch decode "
          f"equals plain")
    return det480, det320, batch


def mean_of_two(fn, iters: int) -> tuple[float, str]:
    """``device_ms`` twice; the mean and both runs."""
    a, b = device_ms(fn, iters), device_ms(fn, iters)
    return (a + b) / 2, f"runs {a:.4f}/{b:.4f}"


def nms_kernel_alone(vals, tables, cap):
    """A launch of the library's entry point on outputs made once: the
    kernel's time without the wrapper's checks and allocations (and without
    the two zero fills an older wrapper launched before it)."""
    lib = build.load_library()
    b, n, _ = vals.shape
    boxes = torch.zeros((b, cap, 5), device="cuda")
    mask = torch.zeros((b, cap), dtype=torch.bool, device="cuda")
    args = (vals.data_ptr(), *(t.data_ptr() for t in tables[:4]),
            *(float(np.float32(v)) for v in (*tables[4:], 0.5, 0.5)), b, n, cap,
            boxes.data_ptr(), mask.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def launch():
        check(lib.fdtpu_decode_filter_nms(*args) == 0, "decode_filter_nms launch")
        return boxes, mask
    return launch


def nms_times(card) -> list[dict]:
    """K1/K2 on random maps at the three timed shapes, the card's time alone
    (``device_ms``): through the wrapper as the paths call it (``ms``), the
    kernel alone (``kernel_ms``), and the wrapper's host time a call
    (``host_us``)."""
    rng = np.random.default_rng(SEED + 3)
    rows = []
    for b, n, cap in NMS_TIMED:
        vals = candidates(rng, b, n, "random")
        tables = tables_for(n)
        kern = lambda: knms.decode_filter_nms_batch(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        plain = lambda: knms.decode_filter_nms_reference(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        row = {"shape": [b, n, cap]}
        row["ms"], row["plain_ms"], runs = turns(kern, plain, 50, 3)
        row["kernel_ms"], alone_runs = mean_of_two(nms_kernel_alone(vals, tables, cap), 50)
        row["host_us"] = host_us(kern, 200)
        bnd, rounds, eligible = nms_bound(vals, tables, *kern())
        row.update(bnd)
        rows.append(row)
        print(f"[6 time] decode_filter_nms B={b} N={n} cap={cap} random maps: wrapper "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms ({runs}); kernel alone {row['kernel_ms']:.4f} ms "
              f"({alone_runs}); host {row['host_us']:.1f} us a call; bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']} ({rounds} rounds, {eligible} "
              f"eligible) [{card}]")
    return rows


def nms_large_times(card) -> list[dict]:
    """K1's global-scratch path (N past the shared-memory limit) on random
    maps, the card's time alone (``device_ms``) against its plain version."""
    rng = np.random.default_rng(SEED + 12)
    rows = []
    for b, n in ((1, 8204), (8, 8204), (8, 20000)):
        cap = 128
        vals = candidates(rng, b, n, "random")
        tables = tables_for(n)
        kern = lambda: knms.decode_filter_nms_batch(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        plain = lambda: knms.decode_filter_nms_reference(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        row = {"shape": [b, n, cap], "path": "scratch"}
        row["ms"], row["plain_ms"], runs = turns(kern, plain, 20, 2)
        bnd, rounds, eligible = nms_bound(vals, tables, *kern())
        row.update(bnd)
        rows.append(row)
        print(f"[6 time] decode_filter_nms B={b} N={n} cap={cap} random maps, global scratch: "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms ({runs}); bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']} ({rounds} rounds, {eligible} "
              f"eligible) [{card}]")
    return rows


def phase_timings(card, det480, det320, batch):
    rows = nms_times(card) + nms_large_times(card)

    def infer():
        return det320.non_max_suppression(det320.apply(batch.float() / 255.0))

    ms = event_ms(infer, 20)
    print(f"[6 time] b128 320px bf16 forward + decode: {ms:.3f} ms/batch, "
          f"{128e3 / ms:.1f} img/s [{card}]")

    b1 = predict_b1_ms(det480)
    print(f"[6 time] b1 predict 480px bf16 (H2D + /255 + forward + decode): median "
          f"{b1['median_ms']:.3f} ms, min {b1['min_ms']:.3f} ms over {b1['n']} [{card}]")
    return rows


def predict_b1_ms(det) -> dict:
    """``det.predict`` of one seeded 480 px u8 frame, host clock to the
    card's end: the median and least ms of 50 calls after 10 warm ones."""
    frame = np.random.default_rng(SEED + 4).integers(0, 256, size=(480, 480, 3), dtype=np.uint8)
    lat = []
    for i in range(60):
        t0 = time.perf_counter()
        det.predict(frame)
        torch.cuda.synchronize()
        if i >= 10:
            lat.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(lat), "min_ms": min(lat), "n": len(lat)}


# -- training -------------------------------------------------------------------


def shear_inputs(x, angles):
    """rotate_batch's first-pass planes ``(K, Hp, Hp * 3)``, its
    coefficients and its center (exact in float32)."""
    padded, _, center, k1, k2 = krot._prepare(x, angles)
    return padded.reshape(*padded.shape[:2], -1), k1, k2, center


# phase 7's edges of the shears: (rows, lanes, c, row_mod). Rows not a
# multiple of shear_cols' band (328); lanes neither a multiple of its tile
# nor of 16 bytes (45); c = 1; rows = 3 row_mod (K4's horizontal passes);
# rows shorter than a warp's step of 64 vectors (24 lanes), of one vector (8 bf16
# lanes; 4 float32 lanes, which in bfloat16 are off the 16-byte grid); c = 5
# (more than a float32 vector: the second tap is a vector away) and c = 9 (more
# than a bfloat16 vector), which take the one-element instance
SHEAR_EDGES = ((328, 984, 3, 0), (37, 45, 3, 0), (70, 1000, 1, 0), (336, 512, 1, 112),
               (120, 984, 3, 40), (64, 24, 3, 0), (48, 8, 1, 16), (48, 4, 1, 0),
               (40, 200, 5, 0), (40, 360, 9, 0))


def edge_center(rows: int, row_mod: int) -> float:
    return krot._f32(((row_mod or rows) - 1) / 2.0)


def shear_residues(ks, rows: int, lanes: int, c: int, row_mod: int, vec: int) -> set:
    """The residues ``m = s mod vec`` of the row shifts ``s = n c`` (``n``
    the plain version's) that stay inside the row, ``|s| < lanes``."""
    r = torch.arange(rows, device=ks.device)
    t = ks[:, None] * ((r % row_mod if row_mod else r).float() - edge_center(rows, row_mod))
    shift = torch.floor(t).long() * c
    return set((shift[shift.abs() < lanes] % vec).tolist())


def phase_rotate_vs_plain() -> dict:
    """Returns the largest |kernel - plain| of each entry of ``SHEARS``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lim = krot.ROTATE_LIMIT_RAD
    worst = dict.fromkeys(SHEARS, 0.0)
    runs = 0

    def same_fit(got, want, kname, what):
        nonlocal runs
        err = (got.float() - want.float()).abs().max().item()
        worst[kname] = max(worst[kname], err)
        runs += 1
        check(got.dtype == want.dtype and torch.equal(got, want), f"{what} differs (max {err})")

    start = LAUNCHES["shear_rows_stacked"]
    for s in (200, 320, 480):
        for dtype in (torch.float32, torch.bfloat16):
            for b in (1, 8, 26):
                x = (torch.rand((b, s, s, 3), generator=gen, device="cuda") * 255).to(dtype)
                rand = (torch.rand((max(b, 4),), generator=gen, device="cuda") * 2 - 1) * lim
                pattern = torch.cat([torch.tensor([0.0, lim, -lim], device="cuda"), rand[3:]])
                cases = [pattern[i : i + 1] for i in range(4)] if b == 1 else [pattern[:b]]
                for ang in cases:
                    where = f"B={b} S={s} {dtype} angles {[round(a, 4) for a in ang.tolist()[:4]]}"
                    same_fit(krot.rotate_batch(x, ang), krot.rotate_batch_reference(x, ang),
                         "shear_rows", f"rotate_batch at {where}")
                    same_fit(krot.rotate_batch_transposed(x, ang),
                         krot.rotate_batch_transposed_reference(x, ang),
                         "shear_rows_stacked", f"rotate_batch_transposed (K4) at {where}")
                # every pass on its own, each fed the kernel's previous output
                planes, k1, k2, center = shear_inputs(x, pattern[:b])
                p1 = krot.shear_rows(planes, k1, 3, 0, center)
                same_fit(p1, krot.shear_rows_reference(planes, k1, 3, 0, center), "shear_rows",
                     f"shear_rows pass 1 at B={b} S={s} {dtype}")
                p2 = krot.shear_cols(p1, k2, 3, center)
                same_fit(p2, krot.shear_cols_reference(p1, k2, 3, center), "shear_cols",
                     f"shear_cols pass 2 at B={b} S={s} {dtype}")
    # the shear kernels' edges (SHEAR_EDGES), one plane per k: no shear,
    # +-sin of the limit, and shears steep enough that shear_cols stages a
    # band in passes (|k| 1.5 and 3) or reads its taps straight from device
    # memory (k 40), and that shift shear_rows' rows by their whole length
    # and more; each also as a view one element into its storage (the
    # scalar instances)
    ks = torch.tensor([0.0, math.sin(lim), -math.sin(lim), 0.9, -1.5, 3.0, 40.0], device="cuda")
    for (rows, lanes, c, row_mod), dtype, offset in itertools.product(
            SHEAR_EDGES, (torch.float32, torch.bfloat16), (0, 1)):
        numel = len(ks) * rows * lanes
        flat = (torch.rand((numel + offset,), generator=gen, device="cuda") * 255).to(dtype)
        planes = flat[offset:].view(len(ks), rows, lanes)
        center = edge_center(rows, row_mod)
        where = f"({len(ks)}, {rows}, {lanes}) c={c} row_mod={row_mod} {dtype} offset {offset}"
        if not row_mod:
            same_fit(krot.shear_cols(planes, ks, c, center),
                 krot.shear_cols_reference(planes, ks, c, center), "shear_cols",
                 f"shear_cols edges {where}")
        same_fit(krot.shear_rows(planes, ks, c, row_mod, center),
             krot.shear_rows_reference(planes, ks, c, row_mod, center),
             "shear_rows_stacked" if c == 1 else "shear_rows", f"shear_rows edges {where}")
    torch.cuda.synchronize()
    stacked = LAUNCHES["shear_rows_stacked"] - start
    # the edges give the aligned instances every residue of the shift, for
    # c = 1 and 3, and |s| >= lanes
    for c in (1, 3):
        for vec in (4, 8):
            got = set().union(*(shear_residues(ks, r, l, cc, rm, vec)
                                for r, l, cc, rm in SHEAR_EDGES if cc == c and l % vec == 0))
            check(got == set(range(vec)), f"edges give c={c} residues {sorted(got)} of {vec}")
    check(all(float(ks.abs().max()) * edge_center(r, rm) * cc >= l
              for r, l, cc, rm in SHEAR_EDGES), "an edge case with no shift past its row's end")
    print(f"[7 rotate=plain] {runs} comparisons bit-equal (rotate_batch, K4's "
          f"rotate_batch_transposed, the passes alone, and the edges: k up to 40 (shifts past "
          f"the row), rows 328 and 37, lanes 45, rows = 3 row_mod, rows of 24 lanes and of one "
          f"vector, every residue of the shift, c = 1, 3, 5 and 9, views at an offset of one "
          f"element); "
          f"K4-layout launches {stacked}; max |kernel - plain| = {worst}")
    return worst


def bench_like_batch(b, size, device):
    """``bench.py``'s train batch: random u8 frames, one face per image."""
    rng = np.random.default_rng(SEED + 6)
    images = rng.integers(0, 255, size=(b, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, 5), dtype=np.float32)
    boxes[:, 0] = [1.0, 40, 60, 120, 100]
    masks = np.tile([True, False, False, False], (b, 1))
    return tuple(torch.from_numpy(a).to(device) for a in (images, boxes, masks))


def f32_step_card_vs_cpu(make_module, make_batch, what: str, noise: tuple[str, ...] = ()) -> str:
    """One float32 SAM + SGD step (augmentation off, TF32 off) of
    ``make_module(device)`` on ``make_batch(device)``, on the CPU and on the
    card; checks the loss, the grad norm and the update (params after minus
    before) at phase 8's tolerances and returns the line's numbers.

    Params named with a suffix in ``noise`` have no gradient to match (a
    MobileNetV3 block's last BatchNorm bias: a later train-mode BatchNorm
    subtracts any shift it adds, so its gradient is rounding noise); their
    update must be below 1e-3 of the others' in norm on both devices
    instead. A module with BatchNorm layers has the batch statistics each
    folds into its running ones held too: the running statistics start at
    0, so the step leaves ``(1 - momentum)`` times the batch's mean and
    variance there, and each channel's mean must agree within ``BN_RTOL``
    of its standard deviation and its variance within ``BN_RTOL`` relative
    (BatchNorm's eps added to both). (A relative measure of the change
    alone would not do: a BatchNorm behind a 1x1 conv of a freshly
    normalised input sees a batch mean of 0 up to rounding.)"""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainConfig(optimizer="sgd", learning_rate=1e-2)
    got = {}
    for dev in ("cpu", "cuda"):
        module = make_module(dev)
        names = [n for n, _ in module.named_parameters()]
        before = [p.detach().cpu().clone() for p in module.parameters()]
        bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
        for bn in bns:
            bn.running_mean.zero_()
            bn.running_var.zero_()
        state = create_train_state(module, tcfg, 100)
        step = make_train_step(module, tcfg, augment=False)
        state, sc = step(state, *make_batch(dev))
        got[dev] = (sc["loss"].item(), sc["grad_norm"].item(),
                    [p.detach().cpu() - q for p, q in zip(module.parameters(), before)],
                    [(bn.running_mean.cpu() / (1 - bn.momentum),
                      bn.running_var.cpu() / (1 - bn.momentum), bn.eps) for bn in bns])
    (l_c, g_c, u_c, s_c), (l_g, g_g, u_g, s_g) = got["cpu"], got["cuda"]
    real = [not n.endswith(noise) for n in names] if noise else [True] * len(names)
    u_c_real = [u for u, r in zip(u_c, real) if r]
    loss_err, gn_err = abs(l_g / l_c - 1), abs(g_g / g_c - 1)
    diff = [a - b for a, b, r in zip(u_g, u_c, real) if r]
    upd_err = global_norm(diff).item() / global_norm(u_c_real).item()
    tensor_err = max((d.norm() / u.norm()).item() for d, u in zip(diff, u_c_real))
    p_err = max(d.abs().max().item() for d in diff)
    check(np.isfinite([l_g, g_g]).all(), f"non-finite f32 {what} step on the card")
    check(loss_err <= TRAIN_RTOL_LOSS, f"{what} loss card {l_g} vs CPU {l_c}")
    check(gn_err <= TRAIN_RTOL_GRAD_NORM, f"{what} grad norm card {g_g} vs CPU {g_c}")
    check(upd_err <= TRAIN_RTOL_UPDATE, f"{what} update differs by {upd_err} in relative L2")
    check(tensor_err <= TRAIN_RTOL_UPDATE_TENSOR,
          f"a {what} tensor's update differs by {tensor_err} in relative L2")
    line = (f"loss {l_g:.6f} vs {l_c:.6f} (rel {loss_err:.3g}, rtol {TRAIN_RTOL_LOSS}); grad norm "
            f"rel {gn_err:.3g} (rtol {TRAIN_RTOL_GRAD_NORM}); update rel L2 {upd_err:.3g} (rtol "
            f"{TRAIN_RTOL_UPDATE}), worst tensor {tensor_err:.3g} (rtol "
            f"{TRAIN_RTOL_UPDATE_TENSOR}); params max abs err {p_err:.3g}")
    if noise:
        ratio = max(global_norm([u for u, r in zip(upd, real) if not r]).item()
                    / global_norm([u for u, r in zip(upd, real) if r]).item()
                    for upd in (u_c, u_g))
        check(ratio <= 1e-3, f"{what} {noise} updates {ratio} of the others' in norm")
        line += f"; {real.count(False)} {'/'.join(noise)} tensors' update {ratio:.3g} of the rest"
    if s_c:
        mean_err = max(((mg - mc).abs() / (vc + eps).sqrt()).max().item()
                       for (mg, _, _), (mc, vc, eps) in zip(s_g, s_c))
        var_err = max(((vg - vc).abs() / (vc + eps)).max().item()
                      for (_, vg, _), (_, vc, eps) in zip(s_g, s_c))
        check(max(mean_err, var_err) <= BN_RTOL,
              f"{what} BatchNorm batch statistics differ: means by {mean_err} of the std, "
              f"variances by {var_err}")
        line += (f"; the batch statistics {len(s_c)} BatchNorms fold in: means within "
                 f"{mean_err:.3g} of the std, variances {var_err:.3g} relative (tol {BN_RTOL})")
    return line


def phase_train_f32() -> None:
    cfg = DetectorConfig()

    def module(dev):
        return PoolResnet(cfg.filters, cfg.input_shape, cfg.num_patches, cfg.num_residual_blocks,
                          dropout=0.0, head_dropout=0.0,
                          generator=torch.Generator().manual_seed(SEED + 5)).to(dev)

    line = f32_step_card_vs_cpu(module, lambda dev: bench_like_batch(2, 480, dev), "PoolResnet")
    print(f"[8 train f32] SAM + SGD step, PoolResnet-128x10 480px B=2, card vs CPU: {line}")


def train_setup(cfg: DetectorConfig, b: int):
    module = build_model("poolresnet", cfg, "cuda", torch.Generator().manual_seed(SEED),
                         compute_dtype=torch.bfloat16)
    tcfg = TrainConfig(rotate_device=True, positional_crop=True, seed=SEED)
    state = create_train_state(module, tcfg, 100)
    steps = (make_train_step(module, tcfg), make_train_step(module, tcfg, compute_metrics=True))
    return state, steps, bench_like_batch(b, cfg.input_shape[0], "cuda")


def phase_train_path():
    runs = {"b128-320": train_setup(BENCH_CFG, 128), "b8-480": train_setup(DetectorConfig(), 8)}
    before = {k: [p.detach().clone() for p in st.module.parameters()]
              for k, (st, _, _) in runs.items()}

    start = LAUNCHES.copy()
    scalars = {}
    for key, (state, (step, metrics_step), batch) in runs.items():
        for i in range(TRAIN_STEPS):
            state, sc = (metrics_step if i == TRAIN_STEPS - 1 else step)(state, *batch)
            scalars.setdefault(key, []).append(sc)
    torch.cuda.synchronize()
    launches = on_path(start)

    calls = TRAIN_STEPS * len(runs)  # one rotate_batch per step
    check(launches["shear_rows"] == 2 * calls and launches["shear_cols"] == calls,
          f"shear launches {launches}, want {2 * calls} and {calls}")
    check(launches["decode_filter_nms"] == len(runs), f"NMS launches {launches}, want {len(runs)}")
    for key, (state, _, _) in runs.items():
        check(state.step == TRAIN_STEPS, f"{key} stepped {state.step} times")
        losses = [sc["loss"].item() for sc in scalars[key]]
        check(all(np.isfinite(v) for sc in scalars[key] for v in
                  (t.item() for t in sc.values())), f"{key} non-finite scalars")
        moved = max((p - q).abs().max().item()
                    for p, q in zip(state.module.parameters(), before[key]))
        check(moved > 0, f"{key} params did not move")
        check(all(p.dtype == torch.float32 for p in state.module.parameters()),
              f"{key} params left float32")
        last = scalars[key][-1]
        print(f"[9 train path] {key}: losses {[round(v, 3) for v in losses]}, grad norm "
              f"{last['grad_norm'].item():.4f}, metrics iou {last['iou'].item():.4f} recall "
              f"{last['recall'].item():.4f} precision {last['precision'].item():.4f}; params "
              f"moved up to {moved:.3g}")
    print(f"[9 train path] launches: shear_rows {launches['shear_rows']}, shear_cols "
          f"{launches['shear_cols']} ({calls} rotate_batch calls), decode_filter_nms "
          f"{launches['decode_filter_nms']} ({len(runs)} metrics steps)")
    return runs


def step_ms(state, step, batch, iters: int) -> float:
    def once():
        step(state, *batch)
    return event_ms(once, iters, warmup=5)


def phase_train_timings(card, runs):
    state, (step, _), batch = runs["b128-320"]
    step_off = make_train_step(state.module, TrainConfig(positional_crop=True, seed=SEED))
    # on, off, off, on: drift on the card hits both alike
    on1, off1, off2, on2 = (step_ms(state, f, batch, 30) for f in (step, step_off, step_off, step))
    on, off = (on1 + on2) / 2, (off1 + off2) / 2
    print(f"[10 time] train b128 320px bf16 SAM+Adam rotation on: {on:.3f} ms/step "
          f"({128e3 / on:.1f} img/s; runs {on1:.3f}/{on2:.3f}); rotation off: {off:.3f} ms/step "
          f"({128e3 / off:.1f} img/s; runs {off1:.3f}/{off2:.3f}) [{card}]")
    state8, (step8, _), batch8 = runs["b8-480"]
    ms8 = step_ms(state8, step8, batch8, 30)
    print(f"[10 time] train b8 480px bf16 SAM+Adam rotation on: {ms8:.3f} ms/step "
          f"({8e3 / ms8:.1f} img/s) [{card}]")

    return shear_times(card)


def shear_grids(k, center: float, hp: int):
    """``F.grid_sample`` grids (align_corners, pixel units normalised by
    ``hp - 1``) of the row shear (sample row ``y`` at ``x + k (y -
    center)``) and of the column shear (column ``x`` at ``y + k (x -
    center)``) of ``(K, 3, hp, hp)`` images; the offsets are the plain
    versions' float32 ``t``, the unsheared coordinate sits on a pixel
    centre."""
    pos = torch.arange(hp, device=k.device, dtype=torch.float32)
    t = k[:, None] * (pos - center)  # (K, hp)
    along = pos[None, None, :] + t[:, :, None]  # [i, y, x] = x + t_i(y)
    fixed = pos[None, :, None].expand_as(along)
    norm = lambda v: v * (2.0 / (hp - 1)) - 1.0  # noqa: E731
    rows = torch.stack([norm(along), norm(fixed)], dim=-1)  # (x', y)
    cols = torch.stack([norm(fixed.transpose(1, 2)), norm(along.transpose(1, 2))], dim=-1)
    return rows.contiguous(), cols.contiguous()


def stacked_vertical_grid(k, center, hp):
    """The ``F.grid_sample`` grid of K4's vertical pass on its planes
    ``(K, Hp, 3 Hp)`` seen as one ``(K, 1, Hp, 3 Hp)`` image: row ``y`` read
    at ``x + k (y - center)`` along all ``3 Hp`` lanes."""
    y = torch.arange(hp, device=k.device, dtype=torch.float32)
    x = torch.arange(3 * hp, device=k.device, dtype=torch.float32)
    t = k[:, None] * (y - center)  # (K, hp)
    along = x[None, None, :] + t[:, :, None]  # [i, y, x] = x + t_i(y)
    fixed = y[None, :, None].expand_as(along)
    return torch.stack([along * (2.0 / (3 * hp - 1)) - 1.0, fixed * (2.0 / (hp - 1)) - 1.0],
                       dim=-1).contiguous()


def grid_sample(img, grid):
    return torch.nn.functional.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=True)


def shear_times(card) -> list[dict]:
    """K3a, K3b and K4 on the planes the training path gives them: the
    26-image exact-k subset at b128/320 in bf16, all 8 images at b8/480 in
    float32; K4 (``shear_rows_stacked``) on the same images stacked by
    channel, its horizontal pass and its vertical pass (on the transpose,
    ``c = 1``, ``row_mod = 0``); the card's time alone (``device_ms``); and
    the library call: one ``F.grid_sample`` (bilinear,
    zero padding, align_corners) of the same planes seen as ``(K, 3, Hp,
    Hp)`` images (K4's vertical pass: its planes seen as one ``(K, 1, Hp,
    3 Hp)`` image, since its taps run on across the channels' blocks of a
    lane row and read zeros only outside the row, as ``F.grid_sample``'s do
    on that view), its time and its largest difference from the plain
    version. In bfloat16 the grid is bfloat16 too (its normalised
    coordinates keep 8 bits: steps of up to 1 pixel on rows of 512 lanes, 3
    on rows of 1,536), so there it is not the same function: no
    ``library_ms``, the error is given. ``copy_ms``: one ``Tensor.copy_`` of
    the planes, the same bytes moved with no arithmetic, what the card
    streams in practice."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for b, s, dtype in ((26, 320, torch.bfloat16), (8, 480, torch.float32)):
        x = (torch.rand((b, s, s, 3), generator=gen, device="cuda") * 255).to(dtype)
        ang = (torch.rand((b,), generator=gen, device="cuda") * 2 - 1) * krot.ROTATE_LIMIT_RAD
        planes, k1, k2, ctr = shear_inputs(x, ang)
        hp = planes.shape[1]
        # K4's layout: channels stacked on rows, a row shear with c = 1; the
        # vertical pass on the transpose, lanes (channel, y)
        stacked = planes.reshape(b, hp, hp, 3).permute(0, 3, 1, 2).reshape(b, 3 * hp, hp)
        stacked_t = stacked.transpose(1, 2).contiguous()
        image = planes.reshape(b, hp, hp, 3).permute(0, 3, 1, 2)  # a view: channels_last
        grid_rows, _ = shear_grids(k1, ctr, hp)
        _, grid_cols = shear_grids(k2, ctr, hp)
        grid_vertical = stacked_vertical_grid(k2, ctr, hp)
        pairs = {
            "shear_rows": (planes, lambda: krot.shear_rows(planes, k1, 3, 0, ctr),
                           lambda: krot.shear_rows_reference(planes, k1, 3, 0, ctr),
                           lambda g: grid_sample(image, g), grid_rows,
                           lambda o: o.permute(0, 2, 3, 1).reshape(b, hp, 3 * hp)),
            "shear_cols": (planes, lambda: krot.shear_cols(planes, k2, 3, ctr),
                           lambda: krot.shear_cols_reference(planes, k2, 3, ctr),
                           lambda g: grid_sample(image, g), grid_cols,
                           lambda o: o.permute(0, 2, 3, 1).reshape(b, hp, 3 * hp)),
            "shear_rows_stacked": (
                stacked, lambda: krot.shear_rows(stacked, k1, 1, hp, ctr),
                lambda: krot.shear_rows_reference(stacked, k1, 1, hp, ctr),
                lambda g: grid_sample(stacked.view(b, 3, hp, hp), g), grid_rows,
                lambda o: o.reshape(b, 3 * hp, hp)),
            "shear_rows_stacked, vertical pass": (
                stacked_t, lambda: krot.shear_rows(stacked_t, k2, 1, 0, ctr),
                lambda: krot.shear_rows_reference(stacked_t, k2, 1, 0, ctr),
                lambda g: grid_sample(stacked_t.view(b, 1, hp, 3 * hp), g), grid_vertical,
                lambda o: o.reshape(b, hp, 3 * hp)),
        }
        for name, (inp, kern, plain, library, grid, layout) in pairs.items():
            shape = tuple(inp.shape)
            # each pass reads its planes once and writes them once
            row = {"name": name, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                   **bound(2 * nbytes(inp), SHEAR_OPS * inp.numel())}
            row["ms"], row["plain_ms"], runs = turns(kern, plain, 50, 5)
            copy = torch.empty_like(inp)
            row["copy_ms"], _ = mean_of_two(lambda: copy.copy_(inp), 50)
            row["library_ms"], lib_txt = None, "; no library call computes it"
            if library is not None:
                grid = grid.to(dtype)
                err = (layout(library(grid)).float() - plain().float()).abs().max().item()
                row["library_max_abs_err"] = err
                if dtype == torch.float32:
                    row["library_ms"], lib_runs = mean_of_two(lambda: library(grid), 50)
                    lib_txt = (f"; library F.grid_sample {row['library_ms']:.4f} ms "
                               f"({lib_runs}), max abs err {err:.3g} against plain on 0-255 "
                               f"planes")
                else:
                    lib_txt = (f"; F.grid_sample takes a bf16 grid with bf16 planes: max abs "
                               f"err {err:.3g}, not the same function")
            rows.append(row)
            print(f"[10 time] {name} {shape} {dtype}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, a copy of the planes {row['copy_ms']:.4f} ms "
                  f"({runs}); bound {row['bound_ms']:.4f} ms by {row['bound_by']}{lib_txt} "
                  f"[{card}]")
    return rows


# -- the fused kernels: K5 and K6 ----------------------------------------------------


def photometric_table(gen, b, noise, glass, motion, bins=None, bc=True):
    """A ``(B, 8)`` scalar table on the card: brightness/contrast drawn for
    every row (with ``bc``), and each gate on for a random half of the rows
    where its argument is True (all rows for "all")."""
    def gate(on):
        if on == "all":
            return torch.ones((b,), device="cuda")
        return (torch.rand((b,), generator=gen, device="cuda") < 0.5).float() if on else \
            torch.zeros((b,), device="cuda")

    u = lambda: torch.rand((b,), generator=gen, device="cuda")  # noqa: E731
    sc = torch.zeros((b, 8), device="cuda")
    sc[:, kphoto.ALPHA] = 1.0 + (u() * 0.4 - 0.2 if bc else 0.0)
    sc[:, kphoto.BETA] = (u() * 0.4 - 0.2) * 255.0 if bc else 0.0
    sc[:, kphoto.NOISE_SIGMA] = gate(noise) * torch.sqrt(10.0 + u() * 390.0)
    sc[:, kphoto.GLASS] = gate(glass)
    sc[:, kphoto.MOTION] = gate(motion)
    sc[:, kphoto.MDX] = (torch.randint(0, 16, (b,), generator=gen, device="cuda").float()
                         if bins is None else bins)
    return sc


def photometric_seeds(gen, b, fixed=None):
    seeds = torch.randint(0, 2**31 - 1, (3 * b,), generator=gen, device="cuda",
                          dtype=torch.int32)
    if fixed is not None:
        seeds[: min(3, 3 * b)] = fixed
    return seeds


def phase_photometric_vs_plain() -> float:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    worst, runs, noise_exact = 0.0, 0, True
    cases = {
        "identity": dict(noise=False, glass=False, motion=False, bc=False),
        "brightness/contrast": dict(noise=False, glass=False, motion=False),
        "noise, seed 0": dict(noise="all", glass=False, motion=False, fixed=0),
        "noise, seed 2^31-2": dict(noise="all", glass=False, motion=False, fixed=2**31 - 2),
        "noise, random seeds": dict(noise=True, glass=False, motion=False),
        "glass": dict(noise=False, glass="all", motion=False),
        "motion": dict(noise=False, glass=False, motion="all"),
        "gates mixed": dict(noise=True, glass=True, motion=True),
        "all gates": dict(noise="all", glass="all", motion="all"),
    }

    def compare(imgs, sc, seeds, noised, where):
        nonlocal worst, runs, noise_exact
        got = kphoto.photometric_batch(imgs, sc, seeds)
        want = kphoto.photometric_reference(imgs, sc, seeds)
        err = (got - want).abs().max().item()
        runs += 1
        check(got.shape == imgs.shape and got.dtype == torch.float32, f"K5 output at {where}")
        if noised:
            worst = max(worst, err)
            noise_exact = noise_exact and torch.equal(got, want)
            check(err <= NOISE_ATOL, f"K5 differs by {err} > {NOISE_ATOL} at {where}")
        else:
            check(torch.equal(got, want), f"K5 differs by {err} at {where} (noise off)")

    for b in (1, 26, 128):
        for s in (64, 320, 480):
            imgs = torch.rand((b, s, s, 3), generator=gen, device="cuda") * 255.0
            for case, kw in cases.items():
                kw = dict(kw)
                seeds = photometric_seeds(gen, b, kw.pop("fixed", None))
                sc = photometric_table(gen, b, **kw)
                compare(imgs, sc, seeds, bool(sc[:, kphoto.NOISE_SIGMA].any()),
                        f"B={b} S={s} {case}")
    # halo-free and blurred images in one batch, every one noised: rows
    # cycle through no blur, glass, motion and both (the kernel picks its
    # path per CTA); odd sides put row starts, image starts and the buffer's
    # end off the 16-byte grid; a view at an odd offset takes the wrapper's
    # aligned copy
    for b, h, w in ((128, 320, 320), (8, 37, 45), (5, 33, 70)):
        imgs = torch.rand((b, h, w, 3), generator=gen, device="cuda") * 255.0
        sc = photometric_table(gen, b, "all", False, False)
        sc[:, kphoto.GLASS] = (torch.arange(b, device="cuda") % 4 % 2).float()
        sc[:, kphoto.MOTION] = (torch.arange(b, device="cuda") % 4 >= 2).float()
        compare(imgs, sc, photometric_seeds(gen, b), True,
                f"B={b} {h}x{w} halo-free and blurred rows, all noised")
    flat = torch.rand((3 * 37 * 45 * 3 + 1,), generator=gen, device="cuda") * 255.0
    compare(flat[1:].view(3, 37, 45, 3), photometric_table(gen, 3, True, True, True),
            photometric_seeds(gen, 3), True, "B=3 37x45 at an offset of one float")

    imgs = torch.rand((16, 64, 64, 3), generator=gen, device="cuda") * 255.0
    bins = torch.arange(16, device="cuda").float()
    compare(imgs, photometric_table(gen, 16, False, False, "all", bins=bins),
            photometric_seeds(gen, 16), False, "B=16 S=64, motion bins 0..15")
    compare(imgs[:1].expand(16, -1, -1, -1).contiguous(),
            photometric_table(gen, 16, "all", "all", "all", bins=bins),
            photometric_seeds(gen, 16), True, "B=16 S=64 one image, all gates, bins 0..15")

    # the whole fused exact-k augmentation at the train shape, the kernel's
    # route against the same route with the plain version in its place
    x, bx, m = bench_like_batch(128, 320, "cuda")
    d = aug.sample_exact_k(torch.Generator(device="cuda").manual_seed(SEED), 128, 320, 320,
                           "cuda", rotate=True, positional_crop=True, fused_photometric=True)
    got = aug.apply_exact_k(x, bx, m, d, fused_photometric=True)
    aug.photometric_batch = kphoto.photometric_reference
    try:
        want = aug.apply_exact_k(x, bx, m, d, fused_photometric=True)
    finally:
        aug.photometric_batch = kphoto.photometric_batch
    err = (got[0] - want[0]).abs().max().item()
    worst = max(worst, err)
    noise_exact = noise_exact and torch.equal(got[0], want[0])
    check(err <= NOISE_ATOL, f"fused exact-k augmentation differs by {err}")
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          "fused exact-k augmentation boxes or masks differ")
    check(got[0].dtype == torch.float32 and 0 <= got[0].min() and got[0].max() <= 1,
          "fused exact-k augmentation output range")
    torch.cuda.synchronize()
    print(f"[11 photometric=plain] {runs} cases and the fused exact-k augmentation at b128/320 "
          f"(rotation, {int((d.scalars[:, kphoto.NOISE_SIGMA] > 0).sum())} noised images): "
          f"noise off bit-equal; noise on "
          f"{'bit-equal' if noise_exact else f'within {NOISE_ATOL}'}, max |kernel - plain| = "
          f"{worst}")
    return worst


def tail_operands(gen, shape, dtype, fmt, offset=0):
    """``c2``, ``skip`` and a conv-like ``bias`` on the card; with
    ``offset``, ``c2`` and ``skip`` are views ``offset`` elements into their
    storage."""
    def one():
        n, c, h, w = shape
        flat = (torch.randn((n * c * h * w + offset,), generator=gen, device="cuda") * 3).to(dtype)
        t = flat[offset:]
        if fmt == torch.channels_last:
            return t.view(n, h, w, c).permute(0, 3, 1, 2)
        return t.view(shape)

    bias = (torch.randn((shape[1],), generator=gen, device="cuda") * 0.5).to(dtype)
    return one(), one(), bias


def phase_tail_vs_plain() -> None:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    runs = 0

    def same_fit(c2, skip, pool, bias, where):
        nonlocal runs
        fmt = torch.contiguous_format if c2.is_contiguous() else torch.channels_last
        got = kep.fused_residual_tail(c2, skip, pool=pool, bias=bias)
        want = kep.reference_tail(c2, skip, pool, bias)
        runs += 1
        check(got.dtype == want.dtype and torch.equal(got, want), f"K6 differs at {where}")
        check(got.is_contiguous(memory_format=fmt), f"K6 output layout at {where}")

    # the main paths' shapes, and the edges: C not a multiple of 8, a numel
    # not a multiple of 8 (unpooled), odd widths
    shapes = ((128, 128, 40, 40), (128, 128, 20, 20), (1, 128, 60, 60), (1, 128, 30, 30),
              (4, 12, 20, 20), (3, 5, 7, 9), (2, 6, 6, 10))
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for fmt in (torch.channels_last, torch.contiguous_format):
                c2, skip, bias = tail_operands(gen, shape, dtype, fmt)
                for pool in (True, False):
                    if pool and (shape[2] % 2 or shape[3] % 2):
                        continue
                    for b in (None, bias):
                        same_fit(c2, skip, pool, b, f"{shape} {dtype} {fmt} pool={pool} "
                                                f"bias={b is not None}")
                # inputs 16-byte misaligned: both (out stays aligned), or c2 alone
                c2o, skipo, _ = tail_operands(gen, shape, dtype, fmt, offset=1)
                for pool in (True, False):
                    if pool and (shape[2] % 2 or shape[3] % 2):
                        continue
                    same_fit(c2o, skipo, pool, bias, f"{shape} {dtype} {fmt} pool={pool} offset 1")
                    same_fit(c2o, skip, pool, None, f"{shape} {dtype} {fmt} pool={pool} c2 offset 1")
    torch.cuda.synchronize()
    print(f"[12 tail=plain] {runs} cases bit-equal (float32 and bfloat16, pooled and "
          f"unpooled, channels_last and contiguous, with and without the bias; C = 12 and 5, "
          f"numel 945, inputs at an offset of one element)")


def phase_tail_path():
    """The K6 path: ``Detector.apply`` with every block's tail fused (conv2's
    bias folded in), against the eager forward of the same Detector."""
    shapes = {"b128-320": (128, BENCH_CFG), "b1-480": (1, DetectorConfig())}
    dets = {key: Detector(build_model("poolresnet", cfg, "cuda",
                                      torch.Generator().manual_seed(SEED)))
            for key, (_, cfg) in shapes.items()}
    images = {key: bpf.frames(b, cfg.input_shape[0], SEED + 10) for key, (b, cfg) in shapes.items()}
    eager = {key: dets[key].apply(images[key]) for key in shapes}

    start = LAUNCHES.copy()
    for det in dets.values():
        bpf.set_fused_tail(det.net, True)
    fused = {key: dets[key].apply(images[key]) for key in shapes}
    torch.cuda.synchronize()
    launches = on_path(start)["residual_tail"]
    for det in dets.values():
        bpf.set_fused_tail(det.net, False)

    blocks = sum(len(det.net.residual_blocks) for det in dets.values())
    check(launches == blocks, f"tail kernel launched {launches} times, want {blocks}")
    for key in shapes:
        check(bool(torch.isfinite(fused[key]).all()), f"{key} non-finite fused forward")
        check(torch.equal(fused[key], eager[key]), f"{key} fused forward differs from eager")
    print(f"[12 tail path] Detector.apply with fused_tail at b128/320 and b1/480 bit-equal to "
          f"the eager forward; tail kernel launches {launches} ({blocks} blocks)")


def phase_photometric_path():
    """The K5 path: bf16 train steps at b128/320 with rotation through the
    fused photometric kernel."""
    module = build_model("poolresnet", BENCH_CFG, "cuda", torch.Generator().manual_seed(SEED),
                         compute_dtype=torch.bfloat16)
    tcfg = TrainConfig(rotate_device=True, positional_crop=True, seed=SEED,
                       fused_photometric=True)
    state = create_train_state(module, tcfg, 100)
    step = make_train_step(module, tcfg)
    batch = bench_like_batch(128, 320, "cuda")

    start = LAUNCHES.copy()
    losses, counts = [], []
    for _ in range(FUSED_STEPS):
        state, sc = step(state, *batch)
        losses.append(sc["loss"].item())
        counts.append(LAUNCHES["photometric"] - start["photometric"])
    torch.cuda.synchronize()
    launches = on_path(start)

    check(counts == list(range(1, FUSED_STEPS + 1)), f"photometric launches by step {counts}")
    check(launches["shear_rows"] == 2 * FUSED_STEPS and launches["shear_cols"] == FUSED_STEPS,
          f"shear launches {launches}")
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    print(f"[13 photometric path] {FUSED_STEPS} bf16 SAM+Adam steps at b128/320 with rotation and "
          f"fused_photometric: losses {[round(v, 3) for v in losses]}; photometric launches by "
          f"step {counts}, shear_rows {launches['shear_rows']}, shear_cols "
          f"{launches['shear_cols']}")
    return state, step, batch


def photometric_bound(imgs, sc, seeds) -> dict:
    """K5's bound on these inputs: every pixel read and written once; the
    noise, the Gaussian and the motion taps counted only on their planes."""
    plane = imgs[0].numel()
    taps = torch.tensor([len(t) for t in kphoto.MOTION_TAPS], device=sc.device)
    bins = sc[:, kphoto.MDX].long().clamp(0, kphoto.N_DIRS - 1)
    moving = sc[:, kphoto.MOTION] > 0.5
    ops = plane * (PHOTO_BASE_OPS * imgs.shape[0]
                   + PHOTO_NOISE_OPS * int((sc[:, kphoto.NOISE_SIGMA] != 0).sum())
                   + PHOTO_GLASS_OPS * int((sc[:, kphoto.GLASS] > 0.5).sum())
                   + 2 * int(taps[bins][moving].sum()))
    return bound(2 * nbytes(imgs) + nbytes(sc, seeds), ops)


def tail_bound(c2, skip, pool: bool, bias=None) -> dict:
    out = c2.numel() // 4 if pool else c2.numel()
    extra = (bias is not None) * c2.numel()  # the bias add
    return bound(nbytes(c2, skip, *(() if bias is None else (bias,))) + out * c2.element_size(),
                 TAIL_OPS * c2.numel() + extra)


def turns(kern, plain, iters: int, plain_iters: int) -> tuple[float, float, str]:
    """Kernel and plain times on the card (``device_ms``): plain, kernel,
    kernel, plain, so that drift on the card hits both alike."""
    p1, k1, k2, p2 = (device_ms(f, n) for f, n in
                      ((plain, plain_iters), (kern, iters), (kern, iters), (plain, plain_iters)))
    return (k1 + k2) / 2, (p1 + p2) / 2, f"runs {k1:.4f}/{k2:.4f} vs {p1:.4f}/{p2:.4f}"


def cycling(fn, operands):
    """A call of ``fn`` on the next operands of the list, round and round."""
    it = itertools.cycle(operands)
    return lambda: fn(*next(it))


def photometric_times(card, gen) -> dict:
    """K5 at the train shape, b128/320 float32, on four tables: the exact-k
    table of the fused route (26 rows each noised, glass-blurred and
    motion-blurred; the row of record), every gate off, the noise on every
    row, and both blurs on every row (noise off). Brightness/contrast as the
    fused route drew it in all four. Each split shows what a stage costs."""
    d = aug.sample_exact_k(gen, 128, 320, 320, "cuda", rotate=True, positional_crop=True,
                           fused_photometric=True)
    imgs = torch.rand((128, 320, 320, 3), generator=gen, device="cuda") * 255.0
    off = d.scalars.clone()
    off[:, [kphoto.NOISE_SIGMA, kphoto.GLASS, kphoto.MOTION]] = 0.0
    noise, blurs = off.clone(), off.clone()
    noise[:, kphoto.NOISE_SIGMA] = torch.sqrt(
        10.0 + torch.rand((128,), generator=gen, device="cuda") * 390.0)
    blurs[:, [kphoto.GLASS, kphoto.MOTION]] = 1.0
    out = {}
    for table, sc in (("the fused route's table", d.scalars), ("gates off", off),
                      ("noise on every row", noise), ("both blurs on every row", blurs)):
        ms, plain, runs = turns(lambda sc=sc: kphoto.photometric_batch(imgs, sc, d.seeds),
                                lambda sc=sc: kphoto.photometric_reference(imgs, sc, d.seeds),
                                20, 3)
        bnd = photometric_bound(imgs, sc, d.seeds)
        out[table] = (ms, plain, bnd)
        print(f"[13 time] photometric (128, 320, 320, 3) float32, {table}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms ({runs}); bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']} [{card}]")
    return out


def tail_times(card, gen, with_bias: bool = True) -> list[dict]:
    """K6 at the eval forward's shapes, bf16 channels_last: at b128/320
    block 0 pools and blocks 1-9 do not; at b1/480 blocks 0 and 1 pool and
    blocks 2-9 do not. ``with_bias``: conv2's bias folded in, as the
    ``fused_tail`` forward runs it on the card, and the plain version adds
    it first, as the eager forward does. Each shape twice: warm, the same
    inputs every launch (at b128 an unpooled block's 26 MB of inputs stay in
    the 50 MB L2), and cold, cycling through enough input sets that each
    launch finds its inputs out of L2. Times are the card's alone
    (``device_ms``); the host's launch cost of one call is ``host_us``."""
    rows = []
    for shape, pool in K6_SHAPES:
        sets = [tail_operands(gen, shape, torch.bfloat16, torch.channels_last)]
        while len(sets) * nbytes(*sets[0][:2]) < L2_FLUSH_BYTES:
            sets.append(tail_operands(gen, shape, torch.bfloat16, torch.channels_last))
        if with_bias:
            def kern(c, s, b, pool=pool):
                return kep.fused_residual_tail(c, s, pool=pool, bias=b)

            def plain(c, s, b, pool=pool):
                return kep.reference_tail(c, s, pool, b)
        else:
            def kern(c, s, b, pool=pool):
                return kep.fused_residual_tail(c, s, pool=pool)

            def plain(c, s, b, pool=pool):
                return kep.reference_tail(c, s, pool)
        c2, skip, bias = sets[0]
        row = {"shape": list(shape), "pool": pool, "bias": with_bias,
               **tail_bound(c2, skip, pool, bias if with_bias else None)}
        for l2, operands in (("warm", sets[:1]), ("cold", sets)):
            ms, plain_ms, runs = turns(cycling(kern, operands), cycling(plain, operands), 50, 50)
            row[f"ms_{l2}"], row[f"plain_ms_{l2}"] = ms, plain_ms
            print(f"[13 time] residual_tail {shape} bf16 channels_last pool={pool} "
                  f"bias={with_bias}, {l2} L2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"({runs}); bound {row['bound_ms']:.4f} ms by {row['bound_by']} [{card}]")
        row["host_us"] = host_us(lambda: kern(c2, skip, bias), 200)
        row["plain_host_us"] = host_us(lambda: plain(c2, skip, bias), 200)
        print(f"[13 time] residual_tail {shape} pool={pool} bias={with_bias}: host "
              f"{row['host_us']:.1f} us a call, plain {row['plain_host_us']:.1f} us [{card}]")
        rows.append(row)
    return rows


def phase_fused_timings(card, train):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    photo = photometric_times(card, gen)
    tails = tail_times(card, gen) + tail_times(card, gen, with_bias=False)
    # the kernels line: K5 on the fused route's table; K6 at its most
    # launched shape, b128 unpooled with the bias (nine launches of ten a
    # b128 forward), warm, beside every shape it was timed at
    top = next(r for r in tails if r["shape"] == [128, 128, 20, 20] and r["bias"])
    times = {"photometric": photo["the fused route's table"],
             "residual_tail": (top["ms_warm"], top["plain_ms_warm"],
                               {k: top[k] for k in ("bound_ms", "bound_by")}),
             "residual_tail_shapes": tails}

    state, fused_step, batch = train
    default_step = make_train_step(state.module, TrainConfig(rotate_device=True,
                                                             positional_crop=True, seed=SEED))
    # fused, default, default, fused: drift on the card hits both alike
    f1, d1, d2, f2 = (step_ms(state, f, batch, 20)
                      for f in (fused_step, default_step, default_step, fused_step))
    print(f"[13 time] train b128 320px bf16 SAM+Adam rotation on, fused_photometric: "
          f"{(f1 + f2) / 2:.3f} ms/step (runs {f1:.3f}/{f2:.3f}); default chain: "
          f"{(d1 + d2) / 2:.3f} ms/step (runs {d1:.3f}/{d2:.3f}) [{card}]")
    for b, size, grid in ((128, 320, 15), (1, 480, 10)):
        r = bpf.measure(b, size, grid, iters=20)
        runs = "; ".join(f"{arm} {'/'.join(f'{t:.4f}' for t in r[f'fwd_{arm}_runs_ms'])}"
                         for arm in bpf.ARMS)
        print(f"[13 time] bench_pool_fusion b{b} {size}px: prod {r['fwd_prod_ms']:.4f} ms, "
              f"slicemax {r['fwd_slicemax_ms']:.4f} ms, fused {r['fwd_fused_ms']:.4f} ms a forward "
              f"(runs {runs}; all bit-equal to prod) [{card}]")
    return times


# -- the Trainer path --------------------------------------------------------------


# every kernel's launches on the program's paths, which the kernels line
# prints: each path phase adds what its own run launched (on_path), and the
# ranks' processes hand theirs back; the checks against the plain versions
# and the timing loops are no path
PATH_LAUNCHES = Counter()


def on_path(start: Counter) -> Counter:
    """The launches since ``start`` (a copy of ``LAUNCHES`` taken just
    before a path's run), added to :data:`PATH_LAUNCHES`."""
    launches = LAUNCHES - start
    PATH_LAUNCHES.update(launches)
    return launches


def held_graphs(*owners) -> list:
    """The graphs that ``owners`` hold: a Detector's, a Trainer's captured
    steps'."""
    graphs = []
    for owner in owners:
        if isinstance(owner, Detector):
            graphs += owner._graphs.graphs.values()
        else:
            graphs += [g for c in owner.captured.values() for g in c.graphs.values()]
    return graphs


def warm_ups(*owners) -> Counter:
    """The launches of the warm-ups before the captures of the graphs that
    ``owners`` hold, as each capture measured them (``Graph.warm_launches``).
    Each caller's owners are new, so that all their graphs were captured
    inside its window: the window's delta of ``LAUNCHES`` less these is the
    calls' own launches, eager or replayed. A graph dropped inside the
    window (a Detector's beyond its eight, a train step's at a new SGD rate)
    takes its warm-ups with it, so a check of that difference fails rather
    than passes."""
    launches = Counter()
    for g in held_graphs(*owners):
        launches.update(g.warm_launches)
    return launches


def slot_replays(trainer, slot: str) -> int:
    """The replays of a Trainer's captured ``slot`` (0 if it never
    captured it)."""
    return trainer.captured[slot].replays if slot in trainer.captured else 0


def trainer_loaders(root, shuffle: bool):
    shape = DetectorConfig().input_shape
    train = WIDERFaceDataSource(load_targets(root, "train", 3), shape, 8, error_log=None)
    val = WIDERFaceDataSource(load_targets(root, "val", 3), shape, 8, error_log=None)
    return BatchLoader(train, 8, shuffle=shuffle, seed=SEED, drop_last=True), BatchLoader(val, 8)


def trainer_module(seed: int, dtype=torch.bfloat16):
    return build_model("poolresnet", DetectorConfig(), "cuda", torch.Generator().manual_seed(seed),
                       compute_dtype=dtype)


def bench_py_keys() -> set[str]:
    """The keys of ``bench.py``'s result line, read from its source."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parent / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result":
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "result"
                and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def phase_trainer(tmp) -> None:
    """14: the Trainer path at full width (``DetectorConfig()``,
    ``TrainConfig()`` defaults but rotation on the card and no first-batch
    drawings), b8, on ``make_synthetic_widerface`` data."""
    from pathlib import Path

    tmp = Path(tmp)
    n_train, n_val = TRAINER_IMAGES
    root = make_synthetic_widerface(tmp / "data", n_train, split="train", seed=SEED)
    make_synthetic_widerface(root, n_val, split="val", seed=SEED + 1)
    tcfg = TrainConfig(rotate_device=True, max_epochs=TRAINER_EPOCHS, seed=SEED,
                       visualize_first_batch=False, checkpoint_dir=str(tmp / "ckpt"),
                       log_path=str(tmp / "logs" / "out.log"))

    # fit, two epochs, streamed
    train, val = trainer_loaders(root, shuffle=True)
    trainer = Trainer(trainer_module(SEED), tcfg, train, val, run_name="smoke", device="cuda")
    before = [p.detach().clone() for p in trainer.state.module.parameters()]
    start = LAUNCHES.copy()  # the phase's path, to its end: on_path
    out = trainer.fit()
    torch.cuda.synchronize()
    fit = LAUNCHES - start
    calls = fit - warm_ups(trainer)  # the steps' own launches, eager or replayed
    steps, val_batches = TRAINER_EPOCHS * len(train), len(val)
    check(trainer.state.step == steps, f"Trainer took {trainer.state.step} steps, want {steps}")
    check(all(np.isfinite(v) for split in out.values() for v in split.values()),
          f"non-finite epoch metrics {out}")
    moved = max((p - q).abs().max().item()
                for p, q in zip(trainer.state.module.parameters(), before))
    check(moved > 0, "Trainer params did not move")
    # the metrics step, then each val batch; once a call, eager or replayed
    want_k1 = TRAINER_EPOCHS * (1 + val_batches)
    check(calls["decode_filter_nms"] == want_k1, f"K1 launched {calls['decode_filter_nms']} "
          f"times in fit (the warm-ups apart), want {want_k1}")
    replays = {slot: slot_replays(trainer, slot) for slot in ("train", "metrics", "eval")}
    check(replays == {"train": steps - TRAINER_EPOCHS, "metrics": TRAINER_EPOCHS,
                      "eval": TRAINER_EPOCHS * val_batches},
          f"replays {replays} of {steps} steps and {TRAINER_EPOCHS * val_batches} val batches")
    # one rotation a step, eager or replayed, the warm-ups apart
    check(calls["shear_rows"] == 2 * steps and calls["shear_cols"] == steps,
          f"shear launches {dict(calls)} in {steps} steps, the warm-ups apart")
    logs = tmp / "logs"
    lines = (logs / "out.log").read_text().splitlines()
    records = (logs / "out.jsonl").read_text().splitlines()
    (tb,) = (logs / "tb").glob("events.out.tfevents.*")
    check(len(lines) == len(records) == len(read_scalars(tb)) == 2 * TRAINER_EPOCHS,
          "log, jsonl and TensorBoard records")
    ckpts = sorted(p.name for p in (tmp / "ckpt" / "smoke").glob("step_*.pt"))
    want_ckpts = [f"step_{len(train) * (e + 1):08d}.pt" for e in range(TRAINER_EPOCHS)]
    check(ckpts == want_ckpts, f"checkpoints {ckpts}, want {want_ckpts}")
    print(f"[14 trainer] fit {TRAINER_EPOCHS} epochs, PoolResnet-128x10 480px grid 10 b8 bf16 "
          f"SAM+Adam, rotation on the card, {n_train} train / {n_val} val synthetic images: "
          f"train {out['train']}, val {out['val']}; params moved up to {moved:.3g}; launches "
          f"{dict(fit)} ({steps} steps, all CUDA-graph replays, {TRAINER_EPOCHS} of them metrics "
          f"steps, {TRAINER_EPOCHS * val_batches} val batches replayed); "
          f"{len(lines)} log lines, checkpoints {ckpts}")

    # resume in a new Trainer from other params: bit-equal state, one epoch more
    train, val = trainer_loaders(root, shuffle=True)
    resumed = Trainer(trainer_module(SEED + 1), tcfg, train, val, run_name="smoke", device="cuda")
    check(resumed.maybe_resume() and resumed.epoch == TRAINER_EPOCHS,
          "maybe_resume found no checkpoint")
    check(resumed.state.step == trainer.state.step, "resumed step")
    for p, q in zip(resumed.state.module.parameters(), trainer.state.module.parameters()):
        check(torch.equal(p, q), "resumed params differ from the saved ones")
        sa, sb = resumed.state.optimizer.state[p], trainer.state.optimizer.state[q]
        check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
              "resumed Adam state differs from the saved one")
    more = resumed.fit(TRAINER_EPOCHS + 1)
    check(resumed.state.step == steps + len(train), "the resumed epoch's steps")
    check(all(np.isfinite(v) for split in more.values() for v in split.values()),
          f"non-finite metrics after resume {more}")
    print(f"[14 trainer] resumed at step {trainer.state.step}: params, Adam moments and step "
          f"bit-equal to the saved ones; one more epoch: train loss {more['train']['loss']:.4f}, "
          f"val loss {more['val']['loss']:.4f}")

    # ResidentDriver against StreamedDriver, float32, deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for resident in (False, True):
            train, val = trainer_loaders(root, shuffle=False)
            cfg = dataclasses.replace(tcfg, device_data=resident, rotate_device=False,
                                      checkpoint_dir=str(tmp / f"ckpt_{resident}"),
                                      log_path=str(tmp / f"logs_{resident}" / "out.log"))
            t = Trainer(trainer_module(SEED, dtype=None), cfg, train, val, augment=False,
                        run_name="det", device="cuda")
            runs[resident] = (t, t.fit())
    finally:
        torch.use_deterministic_algorithms(False)
    (ts, streamed), (tr, resident) = runs[False], runs[True]
    check(type(tr.driver).__name__ == "ResidentDriver", "device_data takes ResidentDriver")
    check(streamed == resident, f"epoch metrics differ: streamed {streamed}, resident {resident}")
    for p, q in zip(ts.state.module.parameters(), tr.state.module.parameters()):
        check(torch.equal(p, q), "resident params differ from streamed")
    check(all(slot_replays(t, "train") and slot_replays(t, "eval") for t in (ts, tr)),
          "a deterministic fit did not replay")
    print(f"[14 trainer] resident = streamed (both replayed, train and eval), float32, shuffle and "
          f"augmentation off, deterministic algorithms: epoch metrics and params bit-equal "
          f"(train loss {streamed['train']['loss']:.6f}, val loss {streamed['val']['loss']:.6f})")

    # run_validation_epoch on the saved checkpoint, with AP
    ckpt = latest_checkpoint(tmp / "ckpt" / "smoke")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        val_out = run_validation_epoch.main([
            "--data-dir", str(root), "--model", "poolresnet", "--checkpoint", str(ckpt),
            "--patches", "10", "--with-ap", "--device", "cuda"])
    finally:
        os.chdir(cwd)
    check(set(val_out) == {"loss", "iou", "recall", "precision", "f1", "AP@0.5"}
          and all(np.isfinite(v) for v in val_out.values()), f"run_validation_epoch {val_out}")
    print(f"[14 trainer] run_validation_epoch --with-ap on {ckpt.name}: {val_out}")

    # the bench's measuring functions, short loops
    train_iters, infer_iters, latency_iters = BENCH_LOOPS
    line = fbench.run("cuda", rotate_device=True, train_iters=train_iters,
                      infer_iters=infer_iters, latency_iters=latency_iters, reps=1)
    want = bench_py_keys()
    check(want <= set(line), f"bench keys {sorted(line)} lack {sorted(want - set(line))}")
    numbers = [v for k, v in line.items() if isinstance(v, (int, float)) and not isinstance(v, bool)]
    numbers += [x for v in line.values() if isinstance(v, list) for x in v]
    check(all(np.isfinite(numbers)) and line["train_mfu"] > 0, f"bench line {line}")
    print(f"[14 trainer] fdtpu_torch.bench, loops {BENCH_LOOPS}, reps 1: {json.dumps(line)}")
    on_path(start)


# -- the SSD path ------------------------------------------------------------------


def ssd_module(cfg: SSDConfig, device, compute_dtype=None, seed: int = SEED):
    return build_model("ssd", cfg, device, torch.Generator().manual_seed(seed),
                       compute_dtype=compute_dtype)


def ssd_batch(b, size, device):
    """Random u8 frames with ``SSD_FACES`` boxes each, in a padded (B, 8, 5)
    box array."""
    rng = np.random.default_rng(SEED + 13)
    images = rng.integers(0, 255, size=(b, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((b, 8, 5), dtype=np.float32)
    boxes[:, :SSD_FACES, 0] = 1.0
    boxes[:, :SSD_FACES, 1:3] = rng.uniform(0, size - 100, (b, SSD_FACES, 2)).round()
    boxes[:, :SSD_FACES, 3:5] = rng.uniform(20, 100, (b, SSD_FACES, 2)).round()
    masks = np.tile(np.arange(8) < SSD_FACES, (b, 1))
    return tuple(torch.from_numpy(a).to(device) for a in (images, boxes, masks))


def phase_ssd_forward_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, gpu = ssd_module(SSD_CFG, "cpu").eval(), ssd_module(SSD_CFG, "cuda").eval()
    u8 = np.random.default_rng(SEED + 14).integers(0, 256, size=(2, 480, 480, 3), dtype=np.uint8)
    x = torch.from_numpy(u8).float() / 255.0
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.cuda()).cpu()
    check(got.shape == (2, 4774, 5), f"SSD forward shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite SSD forward output")
    err = (got - want).abs().max().item()
    check(err <= FORWARD_ATOL, f"card SSD forward differs from CPU by {err} > {FORWARD_ATOL}")
    above = (want[..., 0] > 0.5).float().mean().item()
    print(f"[15 ssd forward f32] SSD-16 480px B=2 (4774 priors), card vs CPU max abs err "
          f"{err:.3g} (atol {FORWARD_ATOL}); {above:.0%} of the scores above 0.5")


def phase_ssd_serving():
    """bf16 Detectors on the card: ``predict`` on three odd-sized frames,
    then the batch path at b24/480 (N = 4,774, K1 in shared memory) and
    b8/640 (N = 8,500, K1 on global scratch), boxes equal to the plain
    version's on the same forward output."""
    det = Detector(ssd_module(SSD_CFG, "cuda"))
    det640 = Detector(ssd_module(SSD_640, "cuda"))
    rng = np.random.default_rng(SEED + 15)
    frames = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
              for h, w in ((377, 501), (480, 641), (211, 173))]
    b24 = torch.from_numpy(rng.integers(0, 256, size=(SSD_BATCH, 480, 480, 3), dtype=np.uint8)).cuda()
    b8 = torch.from_numpy(rng.integers(0, 256, size=(SSD_640_BATCH, 640, 640, 3),
                                       dtype=np.uint8)).cuda()

    start = LAUNCHES.copy()
    preds = [det.predict(f) for f in frames]
    out24 = det.apply(b24.float() / 255.0)
    boxes24, mask24 = det.non_max_suppression(out24)
    out8 = det640.apply(b8.float() / 255.0)
    boxes8, mask8 = det640.non_max_suppression(out8)
    torch.cuda.synchronize()
    launches = on_path(start)["decode_filter_nms"]
    calls = launches - warm_ups(det, det640)["decode_filter_nms"]
    check(calls == len(frames) + 2, f"K1 launched {calls} times, want {len(frames) + 2}")

    counts = [int(check_boxes(b, m, 128, 0.5, "SSD predict")) for _, b, m in preds]
    check(out24.shape == (SSD_BATCH, 4774, 5) and out8.shape == (SSD_640_BATCH, 8500, 5),
          f"SSD forward shapes {tuple(out24.shape)}, {tuple(out8.shape)}")
    check(8500 > knms.max_candidates(0), "N = 8,500 does not reach K1's global-scratch path")
    kept = {}
    for name, out, boxes, mask, size in (("b24/480", out24, boxes24, mask24, 480),
                                         ("b8/640", out8, boxes8, mask8, 640)):
        check(bool(torch.isfinite(out).all()), f"non-finite SSD forward at {name}")
        kept[name] = check_boxes(boxes, mask, 128, 0.5, f"SSD {name}")
        tables = knms.ssd_output_tables_on(out.shape[1], (size, size), out.device)
        wb, wm = knms.decode_filter_nms_reference(out, tables, 0.5, 0.5, 128)
        check(torch.equal(mask, wm) and torch.equal(boxes, wb), f"SSD {name} boxes differ from plain")
    eligible = (out24[..., 0] > 0.5).sum(-1).float().mean().item()
    print(f"[15 ssd serving] bf16 SSD-16 Detectors on the card: predict x3 at 480px -> {counts} "
          f"boxes; b24 at 480px (N 4774, {eligible:.0f} eligible an image) -> "
          f"{int(kept['b24/480'].sum())} boxes; b8 at 640px (N 8500, global scratch) -> "
          f"{int(kept['b8/640'].sum())} boxes; K1 launches {launches} ({calls} calls, replayed); "
          f"both batch decodes equal plain")
    return {"det": det, "det640": det640, "b24": b24, "out24": out24, "out8": out8}


def phase_ssd_train_f32() -> None:
    """One float32 SAM + SGD step of SSD-16 at 480 px, B=2, card against
    CPU, augmentation and dropout off, at phase 8's tolerances; and how many
    of the first forward's mined priors differ between the devices."""

    def module(dev):
        return SSD(SSD_CFG.filters, SSD_CFG.input_shape, SSD_CFG.patch_sizes, dropout=0.0,
                   generator=torch.Generator().manual_seed(SEED + 5)).to(dev)

    mined = {}
    for dev in ("cpu", "cuda"):
        net = module(dev)
        images, boxes, masks = ssd_batch(2, 480, dev)
        with torch.no_grad():
            out = net(images.float() / 255.0)
            enc, _ = tstep._encode_targets(net, boxes, masks, (480, 480))
        mined[dev] = hard_negative_mining(-torch.log(out[..., 0].clamp(1e-7, 1.0)),
                                          enc[..., 0], 10).cpu()
    line = f32_step_card_vs_cpu(module, lambda dev: ssd_batch(2, 480, dev), "SSD")
    flips = int((mined["cpu"] != mined["cuda"]).sum())
    print(f"[15 ssd train f32] SAM + SGD step, SSD-16 480px B=2, card vs CPU: {line}; mined "
          f"priors that differ {flips} of {int(mined['cpu'].sum())}")


def phase_ssd_train_path():
    """Five bf16 SAM + Adam steps of SSD-16 at 480 px, b24, augmentation
    off (``train_model_ssd``'s default), the last with train metrics."""
    module = ssd_module(SSD_CFG, "cuda", compute_dtype=torch.bfloat16)
    tcfg = TrainConfig(seed=SEED)
    state = create_train_state(module, tcfg, 100)
    step = make_train_step(module, tcfg, augment=False)
    metrics_step = make_train_step(module, tcfg, augment=False, compute_metrics=True)
    batch = ssd_batch(SSD_BATCH, 480, "cuda")
    before = [p.detach().clone() for p in module.parameters()]

    start = LAUNCHES.copy()
    scalars = []
    for i in range(TRAIN_STEPS):
        state, sc = (metrics_step if i == TRAIN_STEPS - 1 else step)(state, *batch)
        scalars.append(sc)
    torch.cuda.synchronize()
    launches = on_path(start)["decode_filter_nms"]
    check(launches == 1, f"K1 launched {launches} times in {TRAIN_STEPS} SSD steps, want 1")
    check(all(np.isfinite(v.item()) for sc in scalars for v in sc.values()),
          "non-finite SSD train scalars")
    moved = max((p - q).abs().max().item() for p, q in zip(module.parameters(), before))
    check(moved > 0, "SSD params did not move")
    check(all(p.dtype == torch.float32 for p in module.parameters()), "SSD params left float32")
    last = scalars[-1]
    print(f"[15 ssd train path] SSD-16 b24 480px bf16 SAM+Adam, {TRAIN_STEPS} steps: losses "
          f"{[round(sc['loss'].item(), 3) for sc in scalars]}, grad norm "
          f"{last['grad_norm'].item():.4f}, metrics iou {last['iou'].item():.4f} recall "
          f"{last['recall'].item():.4f} precision {last['precision'].item():.4f}; params moved "
          f"up to {moved:.3g}; K1 launches {launches}")
    return state, step, batch


def phase_ssd_trainer(tmp) -> None:
    """``train_model_ssd``'s Trainer (its defaults: SSD-16, 480 px, b24,
    SAM + Adam, quarter-epochs) for two quarter-epochs on synthetic data,
    a resume in a new Trainer, and ``run_validation_epoch --model ssd
    --with-ap`` on the checkpoint."""
    from pathlib import Path

    tmp = Path(tmp) / "ssd"
    n_train, n_val = SSD_TRAINER_IMAGES
    root = make_synthetic_widerface(tmp / "data", n_train, split="train", seed=SEED, max_faces=4)
    make_synthetic_widerface(root, n_val, split="val", seed=SEED + 1, max_faces=4)
    flags = ["--data-dir", str(root), "--epochs", str(TRAINER_EPOCHS), "--device", "cuda"]
    cwd = os.getcwd()
    os.chdir(tmp)  # checkpoints/, logs/ and imgs/ go here
    try:
        start = LAUNCHES.copy()  # the fit, the resume and the validation: on_path
        trainer = train_model_ssd.build_trainer(train_model_ssd.parse_args(flags))
        out = trainer.fit()
        torch.cuda.synchronize()
        # eager or replayed, the warm-ups apart
        fit_launches = (LAUNCHES - start - warm_ups(trainer))["decode_filter_nms"]
        steps = TRAINER_EPOCHS * len(trainer.train_loader)
        check(trainer.state.step == steps, f"SSD Trainer took {trainer.state.step} steps, want {steps}")
        check(all(np.isfinite(v) for split in out.values() for v in split.values()),
              f"non-finite SSD epoch metrics {out}")
        # each quarter-epoch: the first-batch drawing's eval, the metrics step, each val batch
        want = TRAINER_EPOCHS * (2 + len(trainer.val_loader))
        check(fit_launches == want, f"K1 launched {fit_launches} times in fit, want {want}")
        ckpt = latest_checkpoint(tmp / "checkpoints" / trainer.run_name)
        check(ckpt is not None and ckpt.name == f"step_{steps:08d}.pt", f"checkpoint {ckpt}")

        resumed = train_model_ssd.build_trainer(train_model_ssd.parse_args([*flags, "--seed", "1"]))
        check(resumed.maybe_resume() and resumed.epoch == TRAINER_EPOCHS
              and resumed.state.step == steps, "the SSD resume's epoch or step")
        for p, q in zip(resumed.state.module.parameters(), trainer.state.module.parameters()):
            check(torch.equal(p, q), "resumed SSD params differ from the saved ones")
            sa, sb = resumed.state.optimizer.state[p], trainer.state.optimizer.state[q]
            check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
                  "resumed SSD Adam state differs from the saved one")

        val_out = run_validation_epoch.main([
            "--data-dir", str(root), "--model", "ssd", "--checkpoint", str(ckpt),
            "--batch-size", str(SSD_BATCH), "--with-ap", "--device", "cuda"])
    finally:
        os.chdir(cwd)
    on_path(start)
    check(all(np.isfinite(v) for v in val_out.values()) and 0.0 <= val_out["AP@0.5"] <= 1.0,
          f"run_validation_epoch --model ssd {val_out}")
    print(f"[15 ssd trainer] train_model_ssd's Trainer, {TRAINER_EPOCHS} quarter-epochs of "
          f"{len(trainer.train_loader)} steps (SSD-16 480px b24 bf16 SAM+Adam, {n_train} train / "
          f"{n_val} val synthetic images): train {out['train']}, val {out['val']}; K1 launches "
          f"{fit_launches}; resume: params, Adam moments and step bit-equal; "
          f"run_validation_epoch --model ssd --with-ap on {ckpt.name}: {val_out}")


def phase_ssd_timings(card, serving, train) -> list[dict]:
    """CUDA events after warmup: the SSD train step, forward + decode at
    b24/480 and the b1 ``predict``; then K1 alone (``device_ms``) on the
    SSD's own maps against its plain version."""
    state, step, batch = train
    ms = step_ms(state, step, batch, 20)
    print(f"[15 time] SSD-16 train b24 480px bf16 SAM+Adam: {ms:.3f} ms/step "
          f"({SSD_BATCH * 1e3 / ms:.1f} img/s) [{card}]")
    det, b24 = serving["det"], serving["b24"]
    ms = event_ms(lambda: det.non_max_suppression(det.apply(b24.float() / 255.0)), 20)
    print(f"[15 time] SSD-16 b24 480px bf16 forward + decode: {ms:.3f} ms/batch, "
          f"{SSD_BATCH * 1e3 / ms:.1f} img/s [{card}]")
    frame = np.random.default_rng(SEED + 16).integers(0, 256, size=(480, 480, 3), dtype=np.uint8)
    lat = []
    for i in range(60):
        t0 = time.perf_counter()
        det.predict(frame)
        torch.cuda.synchronize()
        if i >= 10:
            lat.append((time.perf_counter() - t0) * 1e3)
    print(f"[15 time] SSD-16 b1 predict 480px bf16 (H2D + /255 + forward + decode): median "
          f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms over {len(lat)} [{card}]")

    rows = []
    out24, out8 = serving["out24"], serving["out8"]
    for vals, size in ((out24, 480), (out24[:1].contiguous(), 480), (out8, 640)):
        b, n, cap = vals.shape[0], vals.shape[1], 128
        tables = knms.ssd_output_tables_on(n, (size, size), vals.device)
        kern = lambda: knms.decode_filter_nms_batch(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        plain = lambda: knms.decode_filter_nms_reference(vals, tables, 0.5, 0.5, cap)  # noqa: E731
        row = {"shape": [b, n, cap], "maps": "SSD-16 bf16 output, random weights",
               "path": "scratch" if n > knms.max_candidates(0) else "shared"}
        row["ms"], row["plain_ms"], runs = turns(kern, plain, 20, 2)
        bnd, rounds, eligible = nms_bound(vals, tables, *kern())
        row.update(bnd)
        rows.append(row)
        print(f"[15 time] decode_filter_nms B={b} N={n} cap={cap} on SSD maps ({row['path']}): "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms ({runs}); bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']} ({rounds} rounds, {eligible} "
              f"eligible) [{card}]")
    return rows


def phase_ssd(card, tmp):
    """15: the SSD path. Returns its timed rows."""
    phase_ssd_forward_f32()
    serving = phase_ssd_serving()
    phase_ssd_train_f32()
    train = phase_ssd_train_path()
    phase_ssd_trainer(tmp)
    return phase_ssd_timings(card, serving, train)


# -- the rest of the zoo -------------------------------------------------------------


def zoo_module(name: str, device, compute_dtype=None, seed: int = SEED):
    return build_model(name, ZOO[name], device, torch.Generator().manual_seed(seed),
                       compute_dtype=compute_dtype)


class Holder(torch.nn.Module):
    """A scriptable module that only carries named tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def mobilenetv3_reference_archive(path, seed: int) -> None:
    """A TorchScript archive in the reference's layout (timm's stage names,
    ``num_batches_tracked`` included) of a MobileNetV3 from ``seed`` with
    random BatchNorm params and running statistics (means in [-0.5, 0.5],
    variances in [0.5, 1.5])."""
    port = MobileNetV3Backbone((ZOO_SIZE, ZOO_SIZE), ZOO_SIZE // 32,
                               generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    # timm's block 0 is a DepthwiseSeparableConv: its conv_pw is the projection
    to_ref = {v: k for k, v in torch_import.mobilenetv3_prefixes(
        {"feature_extractor.3.0.0.conv_pw.weight": None}).items()}
    root = Holder()
    for name, t in port.state_dict().items():
        prefix, leaf = name.rsplit(".", 1)
        t = t.clone()
        if leaf == "running_mean" or (leaf == "bias" and t.dim() == 1):
            t.uniform_(-0.5, 0.5, generator=gen)
        elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
            t.uniform_(0.5, 1.5, generator=gen)
        mod = root
        for part in to_ref[prefix].split("."):
            if not hasattr(mod, part):
                mod.add_module(part, torch.nn.Module())
            mod = getattr(mod, part)
        if leaf.startswith("running"):
            mod.register_buffer(leaf, t)
            mod.register_buffer("num_batches_tracked", torch.tensor(1000))
        else:
            mod.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
    torch.jit.script(root).save(str(path))


def phase_zoo_forward_f32(tmp) -> None:
    """Each family's float32 eval forward at 480 px, B=2, card against CPU,
    TF32 off; MobileNetV3's weights and running statistics imported from a
    reference-layout TorchScript archive through ``compat.torch_import``."""
    from pathlib import Path

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    archive = Path(tmp) / "mobilenetv3_reference.pth"
    mobilenetv3_reference_archive(archive, SEED + 20)
    u8 = np.random.default_rng(SEED + 21).integers(0, 256, size=(2, ZOO_SIZE, ZOO_SIZE, 3),
                                                   dtype=np.uint8)
    x = torch.from_numpy(u8).float() / 255.0
    for name in ZOO:
        cpu, gpu = zoo_module(name, "cpu"), zoo_module(name, "cuda")
        if name == "mobilenetv3":
            for m in (cpu, gpu):
                torch_import.load_torchscript_weights(archive, m)
            check(not torch.equal(gpu.bn_576.running_var.cpu(), torch.ones(576)),
                  "the archive's running statistics did not load")
        with torch.inference_mode():
            want = cpu(x)
            got = gpu(x.cuda()).cpu()
        s = cpu.grid_size()
        check(got.shape == (2, s, s, 5), f"{name} forward shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"non-finite {name} forward output")
        err = (got - want).abs().max().item()
        check(err <= FORWARD_ATOL, f"card {name} forward differs from CPU by {err}")
        live = ((want > 0.01) & (want < 0.99)).float().mean().item()
        src = " (imported archive)" if has_batch_stats(cpu) else ""
        print(f"[16 zoo forward f32] {name} {ZOO_SIZE}px grid {s} B=2{src}, card vs CPU max abs "
              f"err {err:.3g} (atol {FORWARD_ATOL}); {live:.0%} of outputs in (0.01, 0.99)")


def phase_zoo_train_f32() -> None:
    """One float32 SAM + SGD step of MobileNetV3 at 480 px, B=2, card
    against CPU, at phase 8's tolerances, BatchNorm statistics included."""

    def module(dev):
        return MobileNetV3Backbone((ZOO_SIZE, ZOO_SIZE), 15,
                                   generator=torch.Generator().manual_seed(SEED + 5)).to(dev)

    line = f32_step_card_vs_cpu(module, lambda dev: bench_like_batch(2, ZOO_SIZE, dev),
                                "MobileNetV3", noise=("bn3.bias",))
    print(f"[16 zoo train f32] SAM + SGD step, MobileNetV3-Small {ZOO_SIZE}px B=2, card vs CPU: "
          f"{line}")


def phase_zoo_serving():
    """bf16 Detectors of each family on the card: ``predict`` on three
    odd-sized frames, then the batch path at b64/480; K1 once a call, its
    boxes equal to the plain version's on the same forward output."""
    rng = np.random.default_rng(SEED + 22)
    frames = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
              for h, w in ((377, 501), (480, 641), (211, 173))]
    batch = torch.from_numpy(rng.integers(0, 256, size=(ZOO_SERVE_BATCH, ZOO_SIZE, ZOO_SIZE, 3),
                                          dtype=np.uint8)).cuda()
    dets = {name: Detector(zoo_module(name, "cuda")) for name in ZOO}
    outs = {}
    for name, det in dets.items():
        start = LAUNCHES.copy()
        preds = [det.predict(f) for f in frames]
        out = det.apply(batch.float() / 255.0)
        boxes, mask = det.non_max_suppression(out)
        torch.cuda.synchronize()
        # replayed, the warm-ups apart
        calls = (on_path(start) - warm_ups(det))["decode_filter_nms"]
        check(calls == len(frames) + 1, f"{name}: K1 launched {calls} times a frame and a batch")
        counts = [int(check_boxes(b, m, 128, 0.5, f"{name} predict")) for _, b, m in preds]
        s = det.module.grid_size()
        check(out.shape == (ZOO_SERVE_BATCH, s, s, 5) and bool(torch.isfinite(out).all()),
              f"{name} batch forward")
        kept = check_boxes(boxes, mask, 128, 0.5, f"{name} batch")
        wb, wm = knms.decode_filter_nms_reference(
            out.reshape(ZOO_SERVE_BATCH, -1, 5),
            knms.grid_tables_on(s, (ZOO_SIZE, ZOO_SIZE), out.device), 0.5, 0.5, 128)
        check(torch.equal(mask, wm) and torch.equal(boxes, wb), f"{name} boxes differ from plain")
        outs[name] = out
        print(f"[16 zoo serving] bf16 {name} Detector on the card: predict x3 -> {counts} boxes; "
              f"b{ZOO_SERVE_BATCH} at {ZOO_SIZE}px grid {s} (N {s * s}) -> {int(kept.sum())} "
              f"boxes; K1 launches {calls}; batch decode equals plain")
    return dets, batch, outs


def phase_zoo_train():
    """bf16 SAM + Adam steps at b8/480 with rotation on the card: five of
    MobileNetV3, two each of Resnet and SeparableCNN, the last of each with
    train metrics. Returns the runs."""
    runs = {}
    for name in ZOO:
        module = zoo_module(name, "cuda", compute_dtype=torch.bfloat16)
        tcfg = TrainConfig(rotate_device=True, positional_crop=True, seed=SEED)
        state = create_train_state(module, tcfg, 100)
        steps = (make_train_step(module, tcfg), make_train_step(module, tcfg, compute_metrics=True))
        runs[name] = (state, steps, bench_like_batch(ZOO_TRAIN_BATCH, ZOO_SIZE, "cuda"))
    before = {name: {k: v.detach().clone() for k, v in st.module.state_dict().items()}
              for name, (st, _, _) in runs.items()}

    start = LAUNCHES.copy()
    scalars = {}
    for name, (state, (step, metrics_step), batch) in runs.items():
        n = ZOO_TRAIN_STEPS[name]
        for i in range(n):
            state, sc = (metrics_step if i == n - 1 else step)(state, *batch)
            scalars.setdefault(name, []).append(sc)
    torch.cuda.synchronize()
    launches = on_path(start)
    calls = sum(ZOO_TRAIN_STEPS.values())  # one rotate_batch a step
    check(launches["shear_rows"] == 2 * calls and launches["shear_cols"] == calls,
          f"zoo shear launches {launches}, want {2 * calls} and {calls}")
    check(launches["decode_filter_nms"] == len(runs), f"zoo K1 launches {launches}")
    for name, (state, _, _) in runs.items():
        check(state.step == ZOO_TRAIN_STEPS[name], f"{name} stepped {state.step} times")
        check(all(np.isfinite(v.item()) for sc in scalars[name] for v in sc.values()),
              f"{name} non-finite scalars")
        after = state.module.state_dict()
        moved = max((after[k] - v).abs().max().item() for k, v in before[name].items()
                    if "running" not in k)
        stats = [k for k in after if "running" in k]
        check(moved > 0, f"{name} params did not move")
        check(all(not torch.equal(after[k], before[name][k]) for k in stats),
              f"{name} BatchNorm statistics did not move")
        check(all(p.dtype == torch.float32 for p in state.module.parameters()),
              f"{name} params left float32")
        last = scalars[name][-1]
        print(f"[16 zoo train] {name} b{ZOO_TRAIN_BATCH} {ZOO_SIZE}px bf16 SAM+Adam rotation on, "
              f"{ZOO_TRAIN_STEPS[name]} steps: losses "
              f"{[round(sc['loss'].item(), 3) for sc in scalars[name]]}, grad norm "
              f"{last['grad_norm'].item():.4f}, metrics iou {last['iou'].item():.4f}; params moved "
              f"up to {moved:.3g}; {len(stats)} BatchNorm statistics, all moved")
    print(f"[16 zoo train] launches: shear_rows {launches['shear_rows']}, shear_cols "
          f"{launches['shear_cols']} ({calls} rotate_batch calls), decode_filter_nms "
          f"{launches['decode_filter_nms']} ({len(runs)} metrics steps)")
    return runs


def phase_zoo_trainer(tmp) -> None:
    """``train_model --model mobilenetv3 --rotate-device`` for one epoch on
    synthetic data (its defaults otherwise: 480 px, b8, bf16, SAM + Adam),
    a resume in a new Trainer from another seed (params, BatchNorm
    statistics, Adam's state and the step bit-equal), and
    ``run_validation_epoch`` (MobileNetV3, its default) on the checkpoint."""
    from pathlib import Path

    tmp = Path(tmp) / "zoo"
    n_train, n_val = ZOO_TRAINER_IMAGES
    root = make_synthetic_widerface(tmp / "data", n_train, split="train", seed=SEED)
    make_synthetic_widerface(root, n_val, split="val", seed=SEED + 1)
    flags = ["--data-dir", str(root), "--model", "mobilenetv3", "--input", str(ZOO_SIZE),
             "--patches", str(ZOO_SIZE // 32), "--epochs", "1", "--rotate-device",
             "--device", "cuda"]
    cwd = os.getcwd()
    os.chdir(tmp)  # checkpoints/, logs/ and imgs/ go here
    try:
        start = LAUNCHES.copy()  # the fit, the resume and the validation: on_path
        trainer = train_model.build_trainer(train_model.parse_args(flags))
        out = trainer.fit()
        torch.cuda.synchronize()
        fit = LAUNCHES - start
        calls = fit - warm_ups(trainer)  # eager or replayed
        steps = len(trainer.train_loader)
        check(trainer.state.step == steps, f"MobileNetV3 Trainer took {trainer.state.step} steps")
        check(all(np.isfinite(v) for split in out.values() for v in split.values()),
              f"non-finite MobileNetV3 epoch metrics {out}")
        # the first batch's drawing, the metrics step, each val batch (K1 once
        # a call, eager or replayed, the warm-ups apart)
        want = 2 + len(trainer.val_loader)
        check(calls["decode_filter_nms"] == want and calls["shear_rows"] == 2 * steps
              and calls["shear_cols"] == steps and slot_replays(trainer, "train") == steps - 1,
              f"MobileNetV3 Trainer launches {dict(fit)}, the warm-ups apart {dict(calls)}")
        ckpt = latest_checkpoint(tmp / "checkpoints" / trainer.run_name)
        check(ckpt is not None and ckpt.name == f"step_{steps:08d}.pt", f"checkpoint {ckpt}")

        resumed = train_model.build_trainer(train_model.parse_args([*flags, "--seed", "1"]))
        check(resumed.maybe_resume() and resumed.state.step == steps, "the MobileNetV3 resume")
        saved, now = trainer.state.module.state_dict(), resumed.state.module.state_dict()
        check(saved.keys() == now.keys() and all(torch.equal(saved[k], now[k]) for k in saved),
              "resumed MobileNetV3 params or BatchNorm statistics differ from the saved ones")
        for p, q in zip(resumed.state.module.parameters(), trainer.state.module.parameters()):
            sa, sb = resumed.state.optimizer.state[p], trainer.state.optimizer.state[q]
            check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
                  "resumed MobileNetV3 Adam state differs from the saved one")
        val_out = run_validation_epoch.main([
            "--data-dir", str(root), "--checkpoint", str(ckpt), "--input", str(ZOO_SIZE),
            "--patches", str(ZOO_SIZE // 32), "--with-ap", "--device", "cuda"])
    finally:
        os.chdir(cwd)
    on_path(start)
    check(set(val_out) == {"loss", "iou", "recall", "precision", "f1", "AP@0.5"}
          and all(np.isfinite(v) for v in val_out.values()), f"run_validation_epoch {val_out}")
    print(f"[16 zoo trainer] train_model --model mobilenetv3 --rotate-device, one epoch of "
          f"{steps} steps ({ZOO_SIZE}px b8 bf16 SAM+Adam, {n_train} train / {n_val} val synthetic "
          f"images): train {out['train']}, val {out['val']}; launches {dict(fit)}; resume: params, "
          f"BatchNorm statistics, Adam moments and step bit-equal; run_validation_epoch "
          f"(--model mobilenetv3 by default) --with-ap on {ckpt.name}: {val_out}")


def phase_zoo_timings(card, serving, train) -> None:
    """Per family, CUDA events after warmup: the b1 ``predict`` latency
    (median and min over 50 calls), forward + decode at b64/480, and the
    b8/480 train step, three runs of 10 (the step is host-bound: the runs'
    range is given)."""
    dets, batch, _ = serving
    frame = np.random.default_rng(SEED + 23).integers(0, 256, size=(ZOO_SIZE, ZOO_SIZE, 3),
                                                      dtype=np.uint8)
    for name, det in dets.items():
        lat = []
        for i in range(60):
            t0 = time.perf_counter()
            det.predict(frame)
            torch.cuda.synchronize()
            if i >= 10:
                lat.append((time.perf_counter() - t0) * 1e3)
        ms = event_ms(lambda: det.non_max_suppression(det.apply(batch.float() / 255.0)), 10)
        state, (step, _), tbatch = train[name]
        runs = [step_ms(state, step, tbatch, 10) for _ in range(3)]
        print(f"[16 time] {name}: b1 predict {ZOO_SIZE}px bf16 median "
              f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms over {len(lat)}; "
              f"b{ZOO_SERVE_BATCH} {ZOO_SIZE}px forward + decode "
              f"{ms:.3f} ms/batch ({ZOO_SERVE_BATCH * 1e3 / ms:.1f} img/s); train "
              f"b{ZOO_TRAIN_BATCH} "
              f"{ZOO_SIZE}px bf16 SAM+Adam rotation on {min(runs):.3f}-{max(runs):.3f} ms/step "
              f"({ZOO_TRAIN_BATCH * 1e3 / max(runs):.1f}-{ZOO_TRAIN_BATCH * 1e3 / min(runs):.1f} "
              f"img/s) [{card}]")


def phase_zoo(card, tmp) -> None:
    """16: the rest of the zoo."""
    t0, start = time.perf_counter(), PATH_LAUNCHES.copy()
    phase_zoo_forward_f32(tmp)
    phase_zoo_train_f32()
    serving = phase_zoo_serving()
    train = phase_zoo_train()
    phase_zoo_trainer(tmp)
    phase_zoo_timings(card, serving, train)
    print(f"[16 zoo] launches on the zoo's paths {dict(PATH_LAUNCHES - start)}; phase 16 took "
          f"{time.perf_counter() - t0:.1f} s")


# -- data parallelism ------------------------------------------------------------------


def dp_require_library() -> None:
    """A rank loads the library its parent built (phase 2); it never starts
    nvcc itself, and never falls back to a plain version."""
    check(build.library_path().exists(), "the kernels' library was not built before the ranks")
    build.load_library()


def dp_slice(batch, rank: int, world: int):
    lb = batch[0].shape[0] // world
    return [t[rank * lb:(rank + 1) * lb] for t in batch]


def dp_params_identical(module, group=None) -> bool:
    """Rank 0's params and buffers broadcast (over ``group``, the default
    group when None) and compared bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in module.state_dict().values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=group)
    return torch.equal(flat, ref)


def update_errors(before, got, want) -> tuple[float, float]:
    """``got``'s update (params after minus ``before``) against ``want``'s,
    in relative L2 over all params and for the worst tensor."""
    du = [g - b for g, b in zip(got, before)]
    dw = [w - b for w, b in zip(want, before)]
    diff = [a - c for a, c in zip(du, dw)]
    total = (global_norm(diff) / global_norm(dw)).item()
    worst = max((d.norm() / w.norm()).item() for d, w in zip(diff, dw) if w.norm() > 0)
    return total, worst


def dp_flagship(device, dropout: bool, seed: int = SEED, cfg: DetectorConfig = BENCH_CFG,
                compute_dtype=torch.bfloat16):
    """PoolResnet-128 at the bench shape (320 px, grid 15; or ``cfg``),
    bf16 compute (or ``compute_dtype``; None: the params' float32)."""
    rate = 0.25 if dropout else 0.0
    return PoolResnet(cfg.filters, cfg.input_shape, cfg.num_patches, cfg.num_residual_blocks,
                      dropout=rate, head_dropout=2 * rate, compute_dtype=compute_dtype,
                      generator=torch.Generator().manual_seed(seed)).to(device)


def dp_nccl_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """17a: NCCL at world size 1, in a spawned rank, on the flagship at
    b128/320 (bf16 compute, float32 params, SAM + Adam)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dp_require_library()
    device = torch.device("cuda", 0)
    initialize_multihost(rank=rank, world_size=world, init_method=init_method, device=device)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"17a wants NCCL at world size 1, got {dist.get_backend()}")
        batch = bench_like_batch(DP_BATCH, BENCH_CFG.input_shape[0], device)
        # the DP step against the plain step, augmentation and dropout off
        tcfg = TrainConfig(seed=SEED)
        torch.use_deterministic_algorithms(True)
        try:
            runs = {}
            for name, make in (("plain", make_train_step), ("dp", make_dp_train_step)):
                module = dp_flagship(device, dropout=False)
                before = [p.detach().clone() for p in module.parameters()]
                state = create_train_state(module, tcfg, 100)
                state, sc = make(module, tcfg, augment=False)(state, *batch)
                runs[name] = (sc["loss"].item(), before,
                              [p.detach().clone() for p in module.parameters()])
                del module, state
        finally:
            torch.use_deterministic_algorithms(False)
        (l_p, before, after_p), (l_d, _, after_d) = runs["plain"], runs["dp"]
        loss_err = abs(l_d / l_p - 1)
        upd_err, worst = update_errors(before, after_d, after_p)
        check(np.isfinite(l_d) and loss_err <= DP_LOSS_RTOL,
              f"17a DP loss {l_d} vs plain {l_p} (rel {loss_err})")
        check(upd_err <= DP_UPDATE_RTOL, f"17a DP update differs by {upd_err} in relative L2")
        del runs, before, after_p, after_d

        # three steps with rotation on the card and train metrics: the
        # path's launches
        tcfg = TrainConfig(rotate_device=True, positional_crop=True, seed=SEED)
        module = dp_flagship(device, dropout=True)
        state = create_train_state(module, tcfg, 100)
        metrics_step = make_dp_train_step(module, tcfg, compute_metrics=True)
        start = [p.detach().clone() for p in module.parameters()]
        path_start = LAUNCHES.copy()
        scalars = [metrics_step(state, *batch)[1] for _ in range(DP_STEPS)]
        torch.cuda.synchronize()
        launches = on_path(path_start)
        launches = {k: launches[k] for k in PATH_KERNELS}
        check(launches == {"decode_filter_nms": DP_STEPS, "shear_rows": 2 * DP_STEPS,
                           "shear_rows_stacked": 0, "shear_cols": DP_STEPS},
              f"17a launches {launches}")
        check(all(np.isfinite(v.item()) for sc in scalars for v in sc.values()),
              "17a non-finite scalars")
        check(max((p - q).abs().max().item() for p, q in zip(module.parameters(), start)) > 0,
              "17a params did not move")

        # timings: the plain and the DP step in turns, three runs each; the
        # reduction alone on the flagship's gradients (one flat buffer of
        # 3,013,253 floats, 12.05 MB)
        plain, dp = make_train_step(module, tcfg), make_dp_train_step(module, tcfg)
        times = {"plain": [], "dp": []}
        grads = [torch.randn_like(p) for p in module.parameters()]
        reduce = grad_all_reduce(dist.group.WORLD, torch.tensor(DP_BATCH, device=device))
        for _ in range(3):
            for name, step in (("plain", plain), ("dp", dp)):
                times[name].append(step_ms(state, step, batch, DP_TIMED_STEPS))
        reduce_ms = event_ms(lambda: reduce(grads), 20)
        grad_floats = sum(g.numel() for g in grads)
        del module, state, plain, dp, grads, metrics_step
        torch.cuda.empty_cache()

        # replayed: the DP step captured with its collectives, five replays
        # against five eager DP steps; the b128 step's arms in turns; the
        # Trainer over this group
        graph, rows, path_start = {}, None, LAUNCHES.copy()
        for label, spec in DP_GRAPH_MODELS.items():
            run = graph_vs_eager(spec, make_dp_train_step)
            failures = graph_failures(f"17a replayed {label}", run)
            check(not failures, "; ".join(failures))
            graph[label] = graph_summary(run)
            if spec[1] is BENCH_CFG:
                (es, step), (gs, captured), gb = run["eager"], run["graph"], run["batch"]
                rows = arm_rows({"DP eager": lambda: step(es, *gb),
                                 "DP graph": lambda: captured(gs, *gb),
                                 "plain graph": plain_replay(spec, gb)}, DP_BATCH)
                del es, step, gs, captured, gb
            del run
            torch.cuda.empty_cache()
        fits = dp_trainer_fits(out_dir)
        on_path(path_start)
        with open(os.path.join(out_dir, "dp_nccl.json"), "w") as f:
            json.dump({"loss": [l_p, l_d], "loss_err": loss_err, "update_err": upd_err,
                       "worst_tensor": worst, "launches": launches,
                       "metrics": {k: v.item() for k, v in scalars[-1].items()},
                       "times": times, "reduce_ms": reduce_ms,
                       "grad_floats": grad_floats,
                       "graph": graph, "graph_rows": rows, "trainer": fits,
                       "path_launches": PATH_LAUNCHES}, f)
    finally:
        shutdown()


class GroupTrainer(Trainer):
    """The Trainer over the default process group whatever its size: at
    world size 1 ``Trainer`` itself takes no group (one process), and 17a
    drives the data-parallel path through its world-1 NCCL group."""

    @staticmethod
    def _data_parallel_group(config, train_loader, val_loader):
        return dist.group.WORLD


def dp_trainer_fits(tmp) -> dict:
    """17a: ``GroupTrainer`` over the world-1 NCCL group at
    ``DetectorConfig()`` b8 with rotation on phase 14's 48 / 16 images, two
    epochs: streamed at ``steps_per_dispatch`` 1 and 2 and with
    ``device_data``, each replaying its captured DP train, metrics and eval
    steps (fdtpu's shard_map route; the eval's loss and metric all-reduces
    over NCCL in its graph), bit-equal to the same fits run eagerly
    (``Trainer.replaying`` off; phase 22b reads this)."""
    from pathlib import Path

    tmp = Path(tmp)
    n_train, n_val = TRAINER_IMAGES
    root = make_synthetic_widerface(tmp / "dp_graph_data", n_train, split="train", seed=SEED)
    make_synthetic_widerface(root, n_val, split="val", seed=SEED + 1)
    base = TrainConfig(rotate_device=True, max_epochs=TRAINER_EPOCHS, seed=SEED,
                       visualize_first_batch=False, log_every_steps=0)
    replays = {}

    def fit(name, eager=False, **kw):
        cfg = dataclasses.replace(base, checkpoint_dir=str(tmp / f"dp_ckpt_{name}"),
                                  log_path=str(tmp / f"dp_logs_{name}" / "out.log"), **kw)
        train, val = trainer_loaders(root, shuffle=True)
        t = GroupTrainer(trainer_module(SEED), cfg, train, val, run_name=name, device="cuda")
        check(t.group is dist.group.WORLD and t.route == "shard_map" and t.replaying,
              f"17a {name}: group {t.group}, route {t.route}, replaying {t.replaying}")
        t.replaying = not eager  # eager: the eager steps run, as over gloo
        out = t.fit()
        torch.cuda.synchronize()
        replays[name] = (slot_replays(t, "train"), slot_replays(t, "eval"))
        check(all((n == 0) == eager for n in replays[name])
              and all(t.captured[s].step.group is t.group for s in ("train", "eval")
                      if s in t.captured),
              f"17a {name}: {replays[name]} train and eval replays")
        return t, out

    eager = fit("eager", eager=True)
    same_fit(fit("k1"), eager, "17a the replayed DP fit against the eager one")
    same_fit(fit("k2", steps_per_dispatch=2), eager, "17a steps_per_dispatch=2 against eager")
    same_fit(fit("resident", device_data=True), fit("resident_eager", device_data=True, eager=True),
             "17a device_data replayed against device_data eager")
    return {"train": eager[1]["train"], "replays": replays}


def dp_against_global(make_module, batch, rank: int, world: int, what: str) -> dict:
    """17b: one float32 SAM + SGD step on this rank's slice of ``batch``
    through the DP step; the ranks' params must come out identical, and
    (rank 0) equal the one-process step on the global batch at phase 8's
    tolerances. Two more DP steps time the step."""
    tcfg = TrainConfig(optimizer="sgd", learning_rate=1e-2)
    module = make_module()
    before = [p.detach().clone() for p in module.parameters()]
    state = create_train_state(module, tcfg, 100)
    step = make_dp_train_step(module, tcfg, augment=False)
    mine = dp_slice(batch, rank, world)
    state, sc = step(state, *mine)
    check(dp_params_identical(module), f"17b {what}: params differ between the ranks")
    out = {"loss": sc["loss"].item(), "grad_norm": sc["grad_norm"].item()}
    after = [p.detach().clone() for p in module.parameters()]
    step_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *mine)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    out["step_ms"] = [1e3 * t for t in step_s]
    if rank == 0:
        ref = make_module()
        ref_state = create_train_state(ref, tcfg, 100)
        ref_state, ref_sc = make_train_step(ref, tcfg, augment=False)(ref_state, *batch)
        want = [p.detach() for p in ref.parameters()]
        out["loss_err"] = abs(out["loss"] / ref_sc["loss"].item() - 1)
        out["grad_norm_err"] = abs(out["grad_norm"] / ref_sc["grad_norm"].item() - 1)
        out["update_err"], out["worst_tensor"] = update_errors(before, after, want)
        check(out["loss_err"] <= TRAIN_RTOL_LOSS, f"17b {what} loss rel err {out['loss_err']}")
        check(out["grad_norm_err"] <= TRAIN_RTOL_GRAD_NORM,
              f"17b {what} grad norm rel err {out['grad_norm_err']}")
        check(out["update_err"] <= TRAIN_RTOL_UPDATE,
              f"17b {what} update rel L2 {out['update_err']}")
        check(out["worst_tensor"] <= TRAIN_RTOL_UPDATE_TENSOR,
              f"17b {what} worst tensor's update rel L2 {out['worst_tensor']}")
    return out


def dp_mobilenetv3_statistics(rank: int, world: int, device) -> dict:
    """17b: MobileNetV3's per-rank batch statistics make the DP step differ
    from the global batch's by design (fdtpu's pmean); after one step the
    params and running statistics must be identical on both ranks, and the
    statistics the mean of each rank's own update."""
    tcfg = TrainConfig(optimizer="sgd", learning_rate=1e-2)
    module = MobileNetV3Backbone((ZOO_SIZE, ZOO_SIZE), ZOO_SIZE // 32,
                                 generator=torch.Generator().manual_seed(SEED + 5)).to(device)
    images, boxes, masks = dp_slice(bench_like_batch(2 * DP_MOBILENET_BATCH, ZOO_SIZE, device),
                                    rank, world)
    own = MobileNetV3Backbone((ZOO_SIZE, ZOO_SIZE), ZOO_SIZE // 32).to(device)
    own.load_state_dict(module.state_dict())
    own = own.to(memory_format=torch.channels_last)  # as the train state holds it
    with torch.no_grad():  # this rank's own update, as the step's first forward makes it
        imgs, _, _ = tstep._prepare_inputs(images, boxes, masks, None)
        own(imgs, train=True, update_stats=True)
    want = [t.clone() for t in tstep._batch_stats(own)]
    for t in want:
        dist.all_reduce(t)
        t.div_(world)
    state = create_train_state(module, tcfg, 100)
    make_dp_train_step(module, tcfg, augment=False)(state, images, boxes, masks)
    check(dp_params_identical(module), "17b MobileNetV3: params or statistics differ between ranks")
    got = tstep._batch_stats(module)
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    # each mean within DP_BN_RTOL of its channel's std, each variance relative
    err = max(max(((g_m - w_m).abs() / (w_v + bn.eps).sqrt()).max().item(),
                  ((g_v - w_v).abs() / (w_v + bn.eps)).max().item())
              for bn, g_m, g_v, w_m, w_v in zip(bns, got[::2], got[1::2], want[::2], want[1::2]))
    check(err <= DP_BN_RTOL, f"17b MobileNetV3 running statistics {err} from the ranks' mean")
    return {"bn_err": err, "buffers": len(got)}


def dp_mobilenetv3_gspmd(rank: int, world: int, device) -> dict:
    """17b: MobileNetV3's data-parallel step by the GSPMD route (fdtpu's
    Trainer's without ``rotate_device`` or ``device_data``): the BatchNorms
    normalise by the global batch's statistics. One float32 SAM + SGD step
    on each rank's half of a global b16 with one padded sample, against the
    one-process step on the global batch (``step_against``: phase 8's
    tolerances, running statistics included); params and statistics
    identical on both ranks. Two more steps time it."""
    tcfg = TrainConfig(optimizer="sgd", learning_rate=1e-2)
    images, boxes, masks = bench_like_batch(2 * DP_MOBILENET_BATCH, ZOO_SIZE, device)
    sm = torch.ones(2 * DP_MOBILENET_BATCH, dtype=torch.bool, device=device)
    sm[-1] = False  # one padded sample: the ranks weigh 8 and 7
    batch = (images, boxes, masks, sm)
    ref = sp_reference("mobilenetv3", batch, device) if rank == 0 else None
    module = sp_model("mobilenetv3", device)
    names = [n for n, _ in module.named_parameters()]
    before = [p.detach().clone() for p in module.parameters()]
    state = create_train_state(module, tcfg, 100)
    step = make_dp_train_step(module, tcfg, route="gspmd", augment=False)
    mine = dp_slice(batch, rank, world)
    state, sc = step(state, *mine)
    check(dp_params_identical(module), "17b MobileNetV3 GSPMD route: params or statistics differ "
          "between the ranks")
    out = {"loss": sc["loss"].item(), "grad_norm": sc["grad_norm"].item(),
           "stats": bn_stats(module)}
    after = [p.detach().clone() for p in module.parameters()]
    out["step_ms"] = timed_steps(step, state, mine)
    if rank == 0:
        out.update(step_against(out, ref, before, after, names, "17b MobileNetV3 GSPMD route"))
    del out["stats"]
    return out


def dp_trainer(rank: int, world: int, device, root: str, tmp: str) -> dict:
    """17c: ``Trainer(data_parallel=2)`` at ``DetectorConfig()`` in float32,
    augmentation and shuffle off, deterministic algorithms: one epoch
    streamed and one resident (bit-equal), each with its per-rank eval
    through K1; then a resume from rank 0's checkpoint."""
    from pathlib import Path

    shape = trainer_module(SEED, dtype=None).input_shape
    srcs = [WIDERFaceDataSource(load_targets(root, split, 3), shape, 8, error_log=None)
            for split in ("train", "val")]
    shard = (rank, world)
    out, trainers = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for resident in (False, True):
            train = BatchLoader(srcs[0], DP_TRAINER_BATCH, process_shard=shard)
            val = BatchLoader(srcs[1], DP_TRAINER_BATCH, process_shard=shard)
            cfg = TrainConfig(max_epochs=1, seed=SEED, visualize_first_batch=False,
                              data_parallel=world, device_data=resident,
                              checkpoint_dir=str(Path(tmp) / f"dp_ckpt_{resident}"),
                              log_path=str(Path(tmp) / f"dp_logs_{resident}" / "out.log"))
            t = Trainer(trainer_module(SEED + rank, dtype=None), cfg, train, val, augment=False,
                        run_name="dp", device=device)
            start = LAUNCHES.copy()
            fit = t.fit()
            torch.cuda.synchronize()
            k1 = on_path(start)["decode_filter_nms"]  # over gloo the eager steps: no capture
            check(k1 == 1 + len(val), f"17c K1 launched {k1} times, want {1 + len(val)}")
            check(all(np.isfinite(v) for split in fit.values() for v in split.values()),
                  f"17c non-finite metrics {fit}")
            out["resident" if resident else "streamed"] = {"metrics": fit, "k1": k1,
                                                            "steps": t.state.step}
            trainers[resident] = t
        (ts, tr) = trainers[False], trainers[True]
        check(out["streamed"]["metrics"] == out["resident"]["metrics"],
              f"17c streamed {out['streamed']['metrics']} != resident {out['resident']['metrics']}")
        for p, q in zip(ts.state.module.parameters(), tr.state.module.parameters()):
            check(torch.equal(p, q), "17c resident params differ from streamed")
        check(dp_params_identical(ts.state.module), "17c params differ between the ranks")
        # resume from rank 0's checkpoint in a new Trainer from other params
        resumed = Trainer(trainer_module(SEED + 7, dtype=None), ts.config, ts.train_loader,
                          ts.val_loader, augment=False, run_name="dp", device=device)
        check(resumed.maybe_resume() and resumed.state.step == ts.state.step, "17c resume")
        for p, q in zip(resumed.state.module.parameters(), ts.state.module.parameters()):
            check(torch.equal(p, q), "17c resumed params differ from the saved ones")
            sa, sb = resumed.state.optimizer.state[p], ts.state.optimizer.state[q]
            check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa),
                  "17c resumed Adam state differs from the saved one")
    finally:
        torch.use_deterministic_algorithms(False)
    out["ckpts"] = sorted(p.name for p in (Path(tmp) / "dp_ckpt_False" / "dp").glob("step_*.pt"))
    return out


def dp_gloo_rank(rank: int, world: int, init_method: str, out_dir: str, root: str) -> None:
    """17b and 17c: two ranks on the one card, gloo on CUDA tensors
    (staged through the host)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dp_require_library()
    device = torch.device("cuda", 0)
    initialize_multihost(rank=rank, world_size=world, init_method=init_method, device=device,
                         backend="gloo")
    try:
        check(dist.get_backend() == "gloo" and dist.get_world_size() == 2, "17b wants 2 gloo ranks")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        result = {}
        cfg = BENCH_CFG
        images, boxes, masks = bench_like_batch(DP_BATCH, cfg.input_shape[0], device)
        sm = torch.ones(DP_BATCH, dtype=torch.bool, device=device)
        sm[-1] = False  # one padded sample: the ranks weigh 64 and 63

        def pool():
            return PoolResnet(cfg.filters, cfg.input_shape, cfg.num_patches,
                              cfg.num_residual_blocks, dropout=0.0, head_dropout=0.0,
                              generator=torch.Generator().manual_seed(SEED + 5)).to(device)

        result["poolresnet"] = dp_against_global(pool, (images, boxes, masks, sm), rank, world,
                                                 "PoolResnet")
        images, boxes, masks = ssd_batch(SSD_BATCH, SSD_CFG.input_shape[0], device)
        masks[SSD_BATCH // 2:, 1:] = False  # 4 faces an image on rank 0, 1 on rank 1

        def ssd():
            return SSD(SSD_CFG.filters, SSD_CFG.input_shape, SSD_CFG.patch_sizes, dropout=0.0,
                       generator=torch.Generator().manual_seed(SEED + 5)).to(device)

        with torch.no_grad():
            enc, _ = tstep._encode_targets(ssd(), boxes, masks, SSD_CFG.image_size)
        result["ssd_positives"] = [int((enc[part, :, 0] > 0).sum()) for part in
                                   (slice(0, SSD_BATCH // 2), slice(SSD_BATCH // 2, None))]
        check(result["ssd_positives"][0] != result["ssd_positives"][1],
              f"17b SSD positives {result['ssd_positives']} are even")
        result["ssd"] = dp_against_global(ssd, (images, boxes, masks), rank, world, "SSD")
        result["mobilenetv3"] = dp_mobilenetv3_statistics(rank, world, device)
        result["mobilenetv3_gspmd"] = dp_mobilenetv3_gspmd(rank, world, device)
        result["trainer"] = dp_trainer(rank, world, device, root, out_dir)
        result["path_launches"] = PATH_LAUNCHES
        with open(os.path.join(out_dir, f"dp_gloo_rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        shutdown()


def phase_dp(card, tmp) -> None:
    """17: data parallelism on the card. The ranks' launches on their paths,
    made on the card in their own processes, are added to
    :data:`PATH_LAUNCHES`."""
    from pathlib import Path

    t0 = time.perf_counter()
    n_train, n_val = DP_TRAINER_IMAGES
    root = make_synthetic_widerface(Path(tmp) / "dp_data", n_train, split="train", seed=SEED)
    make_synthetic_widerface(root, n_val, split="val", seed=SEED + 1)
    launch_local_ranks(dp_nccl_rank, 1, args=(tmp,), timeout=DP_RANK_TIMEOUT_S)
    with open(os.path.join(tmp, "dp_nccl.json")) as f:
        a = json.load(f)
    (p_lo, p_hi), (d_lo, d_hi) = ((min(v), max(v)) for v in (a["times"]["plain"],
                                                            a["times"]["dp"]))
    print(f"[17a dp nccl] world 1, PoolResnet-128x10 320px b{DP_BATCH} bf16 SAM+Adam: DP step "
          f"vs plain step, augmentation and dropout off, deterministic: loss {a['loss'][1]:.6f} vs "
          f"{a['loss'][0]:.6f} (rel {a['loss_err']:.3g}, rtol {DP_LOSS_RTOL}), update rel L2 "
          f"{a['update_err']:.3g} (tol {DP_UPDATE_RTOL}), worst tensor {a['worst_tensor']:.3g}; "
          f"{DP_STEPS} DP steps with rotation on the card and train metrics: launches "
          f"{a['launches']}, last metrics {a['metrics']}")
    print(f"[17a time] plain step {p_lo:.3f}-{p_hi:.3f} ms, DP step (NCCL, world 1) "
          f"{d_lo:.3f}-{d_hi:.3f} ms (three runs of {DP_TIMED_STEPS} steps each, in turns, "
          f"rotation on); the gradient reduction alone (flatten of {a['grad_floats']:,} "
          f"floats, all_reduce, divide) {a['reduce_ms']:.4f} ms [{card}]")

    for label, g in a["graph"].items():
        print(f"[17a graph] {label} bf16 SAM + Adam, rotation on the card, the DP step over the "
              f"world-1 NCCL group captured with its all-reduces: {GRAPH_STEPS} replays = "
              f"{GRAPH_STEPS} eager DP steps bit for bit (losses, grad norms, params, buffers, Adam "
              f"moments and steps); losses {g['losses']}; kernel launches a replay "
              f"{g['per_replay']}, eager {g['eager_launches']}; graph pool "
              f"{g['pool_bytes'] / 2**20:.1f} MiB, warm-up + capture {g['capture_s']:.2f} s")
    print(f"[17a graph time] PoolResnet-128x10 320px b{DP_BATCH}, rotation on, medians in "
          f"turns: {arm_line(a['graph_rows'])} [{card}]")
    t = a["trainer"]
    print(f"[17a trainer] the Trainer over the world-1 NCCL group (fdtpu's shard_map route), "
          f"DetectorConfig() b8 bf16, rotation on, {TRAINER_IMAGES[0]} / {TRAINER_IMAGES[1]} "
          f"images, {TRAINER_EPOCHS} epochs: streamed at steps_per_dispatch 1 and 2 and "
          f"device_data replayed (train, metrics and eval steps; the eval's all-reduces in its "
          f"graph) = the same fits eager, bit for bit; (train, eval) replays {t['replays']}; "
          f"train {t['train']}")

    launch_local_ranks(dp_gloo_rank, 2, args=(tmp, str(root)), timeout=DP_RANK_TIMEOUT_S)
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"dp_gloo_rank{r}.json")) as f:
            ranks.append(json.load(f))
    b = ranks[0]
    for what, key in ((f"PoolResnet-128x10 320px b{DP_BATCH} ({DP_BATCH // 2} + "
                       f"{DP_BATCH // 2}, one padded sample)", "poolresnet"),
                      (f"SSD-16 480px b{SSD_BATCH} ({SSD_BATCH // 2} + {SSD_BATCH // 2}, "
                       f"positive priors {b['ssd_positives']})", "ssd")):
        r = b[key]
        print(f"[17b dp gloo] 2 ranks on one card, f32 SAM + SGD, {what} vs one process on the "
              f"global batch: loss rel {r['loss_err']:.3g} (rtol {TRAIN_RTOL_LOSS}), grad norm "
              f"rel {r['grad_norm_err']:.3g} (rtol {TRAIN_RTOL_GRAD_NORM}), update rel L2 "
              f"{r['update_err']:.3g} (rtol {TRAIN_RTOL_UPDATE}), worst tensor "
              f"{r['worst_tensor']:.3g} (rtol {TRAIN_RTOL_UPDATE_TENSOR}); params identical on "
              f"both ranks")
    m = b["mobilenetv3"]
    print(f"[17b dp gloo] MobileNetV3-Small {ZOO_SIZE}px b{2 * DP_MOBILENET_BATCH} f32 SAM + SGD: "
          f"params and statistics identical on both ranks; {m['buffers']} running-statistics "
          f"tensors within {m['bn_err']:.3g} of the mean of each rank's own update "
          f"(rtol {DP_BN_RTOL})")
    g = b["mobilenetv3_gspmd"]
    print(f"[17b dp gloo] MobileNetV3-Small {ZOO_SIZE}px b{2 * DP_MOBILENET_BATCH} (one padded "
          f"sample) f32 SAM + SGD by the GSPMD route (statistics of the global batch) vs one "
          f"process on the global batch: loss rel {g['loss_err']:.3g} (rtol {TRAIN_RTOL_LOSS}), "
          f"grad norm rel {g['grad_norm_err']:.3g} (rtol {TRAIN_RTOL_GRAD_NORM}), update rel L2 "
          f"{g['update_err']:.3g} (rtol {TRAIN_RTOL_UPDATE}), worst tensor "
          f"{g['worst_tensor']:.3g} (rtol {TRAIN_RTOL_UPDATE_TENSOR}), bn3.bias updates "
          f"{g['noise_ratio']:.3g} of the rest's (tol 1e-3), running statistics within "
          f"{g['bn_err']:.3g} (tol {BN_RTOL}); params and statistics identical on both ranks; "
          f"{ms_range(g['step_ms'])} ms a step over gloo [{card}]")
    print(f"[17b time] the DP step, gloo staging through the host (two ranks on one card, not "
          f"a scaling number): PoolResnet b{DP_BATCH // 2} a rank "
          f"{min(b['poolresnet']['step_ms']):.1f}-{max(b['poolresnet']['step_ms']):.1f} ms, SSD "
          f"b{SSD_BATCH // 2} a rank {min(b['ssd']['step_ms']):.1f}-"
          f"{max(b['ssd']['step_ms']):.1f} ms [{card}]")
    c = b["trainer"]
    print(f"[17c dp trainer] data_parallel=2 over gloo on the card, DetectorConfig() f32, "
          f"{n_train} / {n_val} images, b{DP_TRAINER_BATCH}: streamed = resident bit for bit "
          f"(train {c['streamed']['metrics']['train']}, val {c['streamed']['metrics']['val']}); "
          f"K1 {c['streamed']['k1']} + {c['resident']['k1']} launches on each rank; resume from "
          f"rank 0's {c['ckpts']} bit-equal")
    launches = sum((Counter(r["path_launches"]) for r in (a, *ranks)), Counter())
    PATH_LAUNCHES.update(launches)
    print(f"[17 dp] launches on the DP paths {dict(launches)}; phase 17 took "
          f"{time.perf_counter() - t0:.1f} s")


# -- the spatial axis ------------------------------------------------------------------


def sp_model(family: str, device, dropout: bool = False, compute_dtype=None,
             seed: int = SEED + 5):
    """Phase 19's model of ``family`` at its full width, 480 px: PoolResnet
    at ``DetectorConfig()``, SSD-16, and phase 16's MobileNetV3-Small (grid
    15), Resnet-64 (grid 15) and SeparableCNN-128 (16 patches, grid 10).
    Float32 params, computing in ``compute_dtype`` (None: float32);
    dropout (not MobileNetV3's: it has none) at the models' rates, or off."""
    gen = torch.Generator().manual_seed(seed)
    rate = 0.25 if dropout else 0.0
    if family == "poolresnet":
        return dp_flagship(device, dropout, seed, DetectorConfig(), compute_dtype=compute_dtype)
    if family == "ssd":
        module = SSD(SSD_CFG.filters, SSD_CFG.input_shape, SSD_CFG.patch_sizes, dropout=rate,
                     generator=gen, compute_dtype=compute_dtype)
    elif family == "mobilenetv3":
        module = MobileNetV3Backbone((ZOO_SIZE, ZOO_SIZE), ZOO_SIZE // 32, generator=gen,
                                     compute_dtype=compute_dtype)
    else:
        cfg, cls = ZOO[family], {"resnet": Resnet, "separable": SeparableCNN}[family]
        module = cls(cfg.filters, cfg.input_shape, cfg.num_patches, cfg.num_residual_blocks,
                     dropout=rate, head_dropout=2 * rate, generator=gen,
                     compute_dtype=compute_dtype)
    return module.to(device)


def sp_batch(family: str, b: int, device):
    """Phase 19's u8 batch: phase 15's faces for the SSD, ``bench.py``'s
    one face an image for the grid families."""
    return ssd_batch(b, ZOO_SIZE, device) if family == "ssd" else bench_like_batch(b, ZOO_SIZE,
                                                                                device)


def sp_nccl_family(family: str, mesh, device) -> dict:
    """19a for one family: through the spatial step on a 1 x 1 mesh, b8,
    bf16 compute, SAM + Adam, one step against the plain step from the same
    state (augmentation and dropout off, deterministic algorithms where
    torch has them), then three steps with the family's augmentation
    (rotation on the card; none for the SSD, as ``train_model_ssd``
    trains) and train metrics; the plain and the spatial step in turns."""
    batch = sp_batch(family, SP_BATCH, device)
    spatial_step = functools.partial(make_dp_train_step, mesh=mesh)
    tcfg = TrainConfig(seed=SEED)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for name, make in (("plain", make_train_step), ("spatial", spatial_step)):
            module = sp_model(family, device, compute_dtype=torch.bfloat16, seed=SEED)
            before = [p.detach().clone() for p in module.parameters()]
            state = create_train_state(module, tcfg, 100)
            state, sc = make(module, tcfg, augment=False)(state, *batch)
            runs[name] = (sc["loss"].item(), before,
                          [p.detach().clone() for p in module.parameters()])
            del module, state
    finally:
        torch.use_deterministic_algorithms(False)
    (l_p, before, after_p), (l_s, _, after_s) = runs["plain"], runs["spatial"]
    loss_err = abs(l_s / l_p - 1)
    upd_err, worst = update_errors(before, after_s, after_p)
    check(np.isfinite(l_s) and loss_err <= DP_LOSS_RTOL,
          f"19a {family} spatial loss {l_s} vs plain {l_p} (rel {loss_err})")
    check(upd_err <= DP_UPDATE_RTOL,
          f"19a {family} spatial update differs by {upd_err} in relative L2")
    del runs, before, after_p, after_s

    # three steps with the family's augmentation and train metrics: the path's launches
    augment = family != "ssd"
    tcfg = TrainConfig(rotate_device=augment, positional_crop=True, seed=SEED)
    module = sp_model(family, device, dropout=True, compute_dtype=torch.bfloat16, seed=SEED)
    state = create_train_state(module, tcfg, 100)
    metrics_step = spatial_step(module, tcfg, augment=augment, compute_metrics=True)
    start = [p.detach().clone() for p in module.parameters()]
    path_start = LAUNCHES.copy()
    scalars = [metrics_step(state, *batch)[1] for _ in range(SP_STEPS)]
    torch.cuda.synchronize()
    launches = on_path(path_start)
    launches = {k: launches[k] for k in PATH_KERNELS}
    shears = SP_STEPS if augment else 0
    check(launches == {"decode_filter_nms": SP_STEPS, "shear_rows": 2 * shears,
                       "shear_rows_stacked": 0, "shear_cols": shears},
          f"19a {family} launches {launches}")
    check(all(np.isfinite(v.item()) for sc in scalars for v in sc.values()),
          f"19a {family} non-finite scalars")
    check(max((p - q).abs().max().item() for p, q in zip(module.parameters(), start)) > 0,
          f"19a {family} params did not move")

    # the plain and the spatial step in turns, three runs each
    plain = make_train_step(module, tcfg, augment=augment)
    spatial = spatial_step(module, tcfg, augment=augment)
    times = {"plain": [], "spatial": []}
    for _ in range(3):
        for name, step in (("plain", plain), ("spatial", spatial)):
            times[name].append(step_ms(state, step, batch, SP_TIMED_STEPS))
    del module, state, plain, spatial, metrics_step
    torch.cuda.empty_cache()

    # replayed: five replays of the captured spatial step against five eager
    # spatial steps; the spatial step eager and replayed against the
    # replayed plain step, in turns
    spec, path_start = SP_GRAPH_MODELS[family], LAUNCHES.copy()
    run = graph_vs_eager(spec, spatial_step)
    failures = graph_failures(f"19a replayed {family}", run)
    check(not failures, "; ".join(failures))
    (es, step), (gs, captured), gb = run["eager"], run["graph"], run["batch"]
    rows = arm_rows({"spatial eager": lambda: step(es, *gb),
                     "spatial graph": lambda: captured(gs, *gb),
                     "plain graph": plain_replay(spec, gb)}, SP_BATCH, profiled=False,
                    steps={"spatial eager": SP_EAGER_TIMED_STEPS})
    graph = dict(graph_summary(run), rows=rows)
    on_path(path_start)
    del run, es, step, gs, captured, gb
    torch.cuda.empty_cache()
    return {"loss": [l_p, l_s], "loss_err": loss_err, "update_err": upd_err,
            "worst_tensor": worst, "launches": launches,
            "metrics": {k: v.item() for k, v in scalars[-1].items()}, "times": times,
            "augment": augment, "graph": graph}


def sp_nccl_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """19a: NCCL at world size 1 on a 1 x 1 mesh, through the data x spatial
    step, every family at b8 (bf16 compute, float32 params, SAM + Adam)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dp_require_library()
    device = torch.device("cuda", 0)
    initialize_multihost(rank=rank, world_size=world, init_method=init_method, device=device)
    try:
        mesh = make_mesh(1, 1)
        check(dist.get_backend() == "nccl" and mesh.shape == (1, 1),
              f"19a wants NCCL on a 1 x 1 mesh, got {dist.get_backend()} {mesh.shape}")
        result = {family: sp_nccl_family(family, mesh, device) for family in SP_FAMILIES}
        with open(os.path.join(out_dir, "sp_nccl.json"), "w") as f:
            json.dump({"families": result, "path_launches": PATH_LAUNCHES}, f)
    finally:
        shutdown()


def bn_stats(module) -> list[tuple]:
    """Each BatchNorm's running mean and variance, and its eps."""
    return [(m.running_mean.detach().clone(), m.running_var.detach().clone(), m.eps)
            for m in module.modules() if isinstance(m, BatchNorm)]


def step_against(got: dict, ref: dict, before, after, names, what: str) -> dict:
    """A one-step result (``got``: loss, grad norm; ``after``, the params;
    ``got["stats"]``, :func:`bn_stats`) against the one-process step on the
    global batch (``ref``, from the same ``before``) at phase 8's
    tolerances; a MobileNetV3 block's ``bn3.bias`` has no gradient to match
    (``f32_step_card_vs_cpu``) and its update is held below 1e-3 of the
    rest's instead; running statistics within ``BN_RTOL`` (each mean of its
    channel's std, each variance relative)."""
    noise = [n.endswith("bn3.bias") for n in names]
    real = [not x for x in noise]
    out = {"loss_err": abs(got["loss"] / ref["loss"] - 1),
           "grad_norm_err": abs(got["grad_norm"] / ref["grad_norm"] - 1)}
    keep = [i for i, r in enumerate(real) if r]
    out["update_err"], out["worst_tensor"] = update_errors(
        [before[i] for i in keep], [after[i] for i in keep], [ref["want"][i] for i in keep])
    check(out["loss_err"] <= TRAIN_RTOL_LOSS, f"{what} loss rel err {out['loss_err']}")
    check(out["grad_norm_err"] <= TRAIN_RTOL_GRAD_NORM,
          f"{what} grad norm rel err {out['grad_norm_err']}")
    check(out["update_err"] <= TRAIN_RTOL_UPDATE, f"{what} update rel L2 {out['update_err']}")
    check(out["worst_tensor"] <= TRAIN_RTOL_UPDATE_TENSOR,
          f"{what} worst tensor's update rel L2 {out['worst_tensor']}")
    if any(noise):
        ratio = max(global_norm([a - b for a, b, x in zip(upd, before, noise) if x]).item()
                    / global_norm([a - b for a, b, x in zip(upd, before, noise) if not x]).item()
                    for upd in (after, ref["want"]))
        check(ratio <= 1e-3, f"{what} bn3.bias updates {ratio} of the others' in norm")
        out["noise_ratio"] = ratio
    if ref["stats"]:
        out["bn_err"] = max(max(((gm - wm).abs() / (wv + eps).sqrt()).max().item(),
                                ((gv - wv).abs() / (wv + eps)).max().item())
                            for (gm, gv, _), (wm, wv, eps) in zip(got["stats"], ref["stats"]))
        check(out["bn_err"] <= BN_RTOL, f"{what} running statistics differ by {out['bn_err']}")
    return out


def timed_steps(step, state, batch, n: int = 2) -> list[float]:
    """The ms of ``n`` more steps, the card synchronised around each."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *batch)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def sp_reference(family: str, batch, device) -> dict:
    """19b, rank 0: the one-process float32 SAM + SGD step on the global
    batch, and its time (two more steps)."""
    tcfg = TrainConfig(optimizer="sgd", learning_rate=1e-2)
    module = sp_model(family, device)
    before = [p.detach().clone() for p in module.parameters()]
    state = create_train_state(module, tcfg, 100)
    step = make_train_step(module, tcfg, augment=False)
    state, sc = step(state, *batch)
    return {"loss": sc["loss"].item(), "grad_norm": sc["grad_norm"].item(), "before": before,
            "want": [p.detach().clone() for p in module.parameters()],
            "stats": bn_stats(module), "step_ms": timed_steps(step, state, batch)}


def sp_against_global(family: str, mesh, batch, rank: int, ref: dict | None, what: str) -> dict:
    """19b: one float32 SAM + SGD step of the data x spatial step on this
    rank's data row of ``batch``; the params must come out identical on
    every rank of the mesh, and (rank 0) equal the one-process step on the
    global batch (:func:`step_against`). Two more steps time the step, and
    a third the exchanges (``parallel.halo.timer``: the row exchanges'
    forward and backward, MobileNetV3's BatchNorm and squeeze-excite sums
    under their own kinds)."""
    tcfg = TrainConfig(optimizer="sgd", learning_rate=1e-2)
    module = sp_model(family, batch[0].device)
    names = [n for n, _ in module.named_parameters()]
    before = [p.detach().clone() for p in module.parameters()]
    state = create_train_state(module, tcfg, 100)
    step = make_dp_train_step(module, tcfg, mesh=mesh, augment=False)
    mine = data_shard(mesh, *batch)
    state, sc = step(state, *mine)
    check(dp_params_identical(module, mesh.group),
          f"19b {family} {what}: params differ between the ranks")
    out = {"loss": sc["loss"].item(), "grad_norm": sc["grad_norm"].item(),
           "stats": bn_stats(module)}
    after = [p.detach().clone() for p in module.parameters()]
    out["step_ms"] = timed_steps(step, state, mine)
    khalo.timer = {}
    try:
        step(state, *mine)
    finally:
        timed, khalo.timer = khalo.timer, None
    out["halo_ms"] = {k: 1e3 * v for k, v in timed.items()}
    if rank == 0:
        out.update(step_against(out, ref, before, after, names, f"19b {family} {what}"))
    del out["stats"]
    return out


def sp_forward_error(family: str, mesh, batch) -> dict:
    """19b: the output this rank gathers from its rows against the
    one-process forward: of its data row with the same dropout masks, or
    MobileNetV3's in train mode, of the global batch (its statistics span
    the mesh). For the SSD, also the mined negatives of the two forwards
    without dropout that differ (phase 15's count of near ties)."""
    images, boxes, masks = batch[:3]
    module = sp_model(family, images.device, dropout=True)
    x = images.float() / 255
    (row,) = data_shard(mesh, x)
    plan = spatial_plan(module, row.shape[1], mesh.spatial)
    a, b = plan.image_rows[mesh.spatial_index]

    def drop():
        return DropoutMasks(torch.Generator(images.device).manual_seed(mesh.data_index))

    out = {}
    with torch.no_grad():
        if family == "mobilenetv3":
            got = spatial_forward(module, row[:, a:b], plan, mesh, train=True, update_stats=False)
            (want,) = data_shard(mesh, module(x, train=True, update_stats=False))
        else:
            got = spatial_forward(module, row[:, a:b], plan, mesh, drop())
            want = module(row, drop())
        if family == "ssd":
            plain = [spatial_forward(module, row[:, a:b], plan, mesh), module(row)]
            (bx, bm) = data_shard(mesh, boxes, masks)
            enc, _ = tstep._encode_targets(module, bx, bm, SSD_CFG.image_size)
            mined = [hard_negative_mining(-torch.log(o[..., 0].clamp(1e-7, 1.0)), enc[..., 0], 10)
                     for o in plain]
            out["mined_flips"] = int((mined[0] != mined[1]).sum())
            out["mined"] = int(mined[1].sum())
    out["forward_err"] = (got - want).abs().max().item()
    check(out["forward_err"] <= FORWARD_ATOL,
          f"19b {family}: gathered output differs from one process by {out['forward_err']}")
    return out


def sp_gloo_rank(rank: int, world: int, init_method: str, out_dir: str) -> None:
    """19b and 19c: four gloo ranks on the one card (CUDA tensors staged
    through the host); for each family a 1 x 2 mesh on ranks 0 and 1, then
    a 2 x 2 mesh on all four."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dp_require_library()
    device = torch.device("cuda", 0)
    initialize_multihost(rank=rank, world_size=world, init_method=init_method, device=device,
                         backend="gloo")
    try:
        check(dist.get_backend() == "gloo" and dist.get_world_size() == 4,
              "19b wants 4 gloo ranks")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        meshes = {"1x2": make_mesh(2, 2), "2x2": make_mesh(4, 2)}  # every rank makes both
        result = {}
        for family in SP_FAMILIES:
            images, boxes, masks = sp_batch(family, SP_BATCH, device)
            sm = torch.ones(SP_BATCH, dtype=torch.bool, device=device)
            sm[-1] = False  # one padded sample: the 2 x 2 rows weigh 4 and 3
            batch = (images, boxes, masks, sm)
            ref = sp_reference(family, batch, device) if rank == 0 else None
            res = {}
            for name, mesh in meshes.items():
                if mesh is None:  # ranks 2 and 3 sit out the 1 x 2 mesh
                    continue
                res[name] = sp_against_global(family, mesh, batch, rank, ref, name)
                res[name].update(sp_forward_error(family, mesh, batch))
            if ref is not None:
                res["reference_step_ms"] = ref["step_ms"]
            result[family] = res
            del ref
            torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"sp_gloo_rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        shutdown()


def ms_range(values) -> str:
    return f"{min(values):.1f}-{max(values):.1f}"


def phase_spatial(card, tmp) -> None:
    """19: the spatial axis on the card, every family. 19a's launches on its
    paths, made on the card in its own process, are added to
    :data:`PATH_LAUNCHES`."""
    t0 = time.perf_counter()
    launch_local_ranks(sp_nccl_rank, 1, args=(tmp,), timeout=SP_RANK_TIMEOUT_S)
    with open(os.path.join(tmp, "sp_nccl.json")) as f:
        nccl = json.load(f)
    for family, a in nccl["families"].items():
        (p_lo, p_hi), (s_lo, s_hi) = ((min(v), max(v)) for v in (a["times"]["plain"],
                                                                a["times"]["spatial"]))
        print(f"[19a spatial nccl] 1 x 1 mesh, {SP_NAMES[family]} 480px b{SP_BATCH} bf16 SAM + "
              f"Adam: spatial step vs plain step, augmentation and dropout off, deterministic: "
              f"loss {a['loss'][1]:.6f} vs {a['loss'][0]:.6f} (rel {a['loss_err']:.3g}, rtol "
              f"{DP_LOSS_RTOL}), update rel L2 {a['update_err']:.3g} (tol {DP_UPDATE_RTOL}), "
              f"worst tensor {a['worst_tensor']:.3g}; {SP_STEPS} spatial steps "
              f"{'with rotation on the card' if a['augment'] else 'without augmentation'} and "
              f"train metrics: launches {a['launches']}, last metrics {a['metrics']}")
        print(f"[19a time] {family}: plain step {p_lo:.3f}-{p_hi:.3f} ms, spatial step (NCCL, "
              f"1 x 1) {s_lo:.3f}-{s_hi:.3f} ms (three runs of {SP_TIMED_STEPS} steps each, in "
              f"turns) [{card}]")
        g = a["graph"]
        print(f"[19a graph] {family} b{SP_BATCH} bf16 SAM + Adam, "
              f"{'rotation on the card' if a['augment'] else 'augmentation off'}, the spatial step "
              f"on the NCCL 1 x 1 mesh captured: {GRAPH_STEPS} replays = {GRAPH_STEPS} eager "
              f"spatial steps bit for bit (losses, grad norms, params, buffers, Adam moments and "
              f"steps); losses {g['losses']}; kernel launches a replay {g['per_replay']}, eager "
              f"{g['eager_launches']}; graph pool {g['pool_bytes'] / 2**20:.1f} MiB, warm-up + "
              f"capture {g['capture_s']:.2f} s")
        print(f"[19a graph time] {family}, medians in turns: {arm_line(g['rows'])} [{card}]")

    t1 = time.perf_counter()
    launch_local_ranks(sp_gloo_rank, 4, args=(tmp,), timeout=SP_RANK_TIMEOUT_S)
    ranks = []
    for r in range(4):
        with open(os.path.join(tmp, f"sp_gloo_rank{r}.json")) as f:
            ranks.append(json.load(f))
    print("[19c] the spatial step's ms with gloo's staging through the host, its ranks on one "
          "card: what the axis costs here, not a scaling number. Its collectives' ms a step "
          "(two forwards and two backwards a SAM step, the card synchronised around each), "
          "over the ranks: forward/backward, the row exchanges and the gather; bn and se, "
          "MobileNetV3's BatchNorm and squeeze-excite sums")
    for family in SP_FAMILIES:
        b = ranks[0][family]
        for name in ("1x2", "2x2"):
            r, on = b[name], [x[family][name] for x in ranks if name in x[family]]
            extra = ""
            if "noise_ratio" in r:
                extra += f", bn3.bias updates {r['noise_ratio']:.3g} of the rest's (tol 1e-3)"
            if "bn_err" in r:
                extra += f", running statistics within {r['bn_err']:.3g} (tol {BN_RTOL})"
            if family == "ssd":
                extra += (f"; mined negatives that differ without dropout "
                          f"{sum(x['mined_flips'] for x in on)} of {sum(x['mined'] for x in on)}"
                          f" over the ranks")
            print(f"[19b spatial gloo] {name} mesh on one card, {SP_NAMES[family]} 480px f32 SAM + "
                  f"SGD, global batch {SP_BATCH} (one padded sample) vs one process on the global "
                  f"batch: loss rel {r['loss_err']:.3g} (rtol {TRAIN_RTOL_LOSS}), grad norm rel "
                  f"{r['grad_norm_err']:.3g} (rtol {TRAIN_RTOL_GRAD_NORM}), update rel L2 "
                  f"{r['update_err']:.3g} (rtol {TRAIN_RTOL_UPDATE}), worst tensor "
                  f"{r['worst_tensor']:.3g} (rtol {TRAIN_RTOL_UPDATE_TENSOR}){extra}; params "
                  f"identical on every rank; gathered output vs one-process forward, largest "
                  f"difference over the ranks {max(x['forward_err'] for x in on):.3g} (atol "
                  f"{FORWARD_ATOL})")
        for name in ("1x2", "2x2"):
            on = [x[family][name] for x in ranks if name in x[family]]
            kinds = sorted({k for x in on for k in x["halo_ms"]})
            spent = ", ".join(f"{k} {ms_range([x['halo_ms'].get(k, 0.0) for x in on])} ms"
                              for k in kinds)
            print(f"[19c time] {family} {name} spatial step over {len(on)} gloo ranks: "
                  f"{ms_range([t for x in on for t in x['step_ms']])} ms a step; collectives "
                  f"{spent}; the one-process step on the global batch "
                  f"{ms_range(b['reference_step_ms'])} ms [{card}]")
    launches = Counter(nccl["path_launches"])
    PATH_LAUNCHES.update(launches)
    print(f"[19 spatial] launches on the spatial paths {dict(launches)}; 19a took "
          f"{t1 - t0:.1f} s, 19b and 19c {time.perf_counter() - t1:.1f} s, phase 19 "
          f"{time.perf_counter() - t0:.1f} s")


# -- deployment ------------------------------------------------------------------------


def deploy_models() -> dict:
    """PoolResnet-128x10 grid 10 (``DetectorConfig()``) and SSD-16, 480 px,
    float32 masters on the card, random weights from the seed, with the
    score column of each head set up so that the comparisons see boxes
    whose order float32 noise does not decide: random weights alone put no
    PoolResnet cell above 0.7, and thousands of SSD priors within 1e-4 of
    each other (the first run of this phase saturated capacity 64 with
    them, and the engine and the card kept a different box at a near tie).
    The SSD heads' score weights are scaled by 4, as
    ``tests/test_native_infer.py`` spreads them, and each head's score bias
    is shifted so that ``DEPLOY_PASS`` of a seeded frame's candidates pass
    the export threshold."""
    gen = torch.Generator().manual_seed(SEED + 40)
    models = {"poolresnet": build_model("poolresnet", DetectorConfig(), "cuda", gen),
              "ssd": build_model("ssd", SSD_CFG, "cuda", gen)}
    frame = torch.from_numpy(np.random.default_rng(SEED + 41).integers(
        0, 256, size=(1, DEPLOY_SIZE, DEPLOY_SIZE, 3)).astype(np.float32)).cuda()
    prob = DEPLOY_THRESHOLDS[0]
    with torch.no_grad():
        for head in models["ssd"].heads:
            head.weight[0] *= 4.0
        for name, model in models.items():
            score = model(frame / 255.0)[..., 0].double().clamp(1e-9, 1 - 1e-9)
            logit = torch.quantile(torch.logit(score).flatten(), 1 - DEPLOY_PASS[name])
            shift = math.log(prob / (1 - prob)) - float(logit)
            for head in ([model.out] if isinstance(model, PoolResnet) else model.heads):
                head.bias[0] += shift
    return models


def deploy_frames(rng, b: int) -> torch.Tensor:
    """``(b, 480, 480, 3)`` float32 frames of whole values in [0, 255] on the card."""
    return torch.from_numpy(rng.integers(0, 256, size=(b, DEPLOY_SIZE, DEPLOY_SIZE, 3))
                            .astype(np.float32)).cuda()


def same_boxes(got, want, what: str) -> float:
    """Masks equal and boxes within fdtpu's export tolerance; the largest
    box difference."""
    (gb, gm), (wb, wm) = got, want
    err = (gb - wb).abs().max().item()
    check(torch.equal(gm, wm), f"{what}: masks differ")
    check(err <= EXPORT_ATOL, f"{what}: boxes differ by {err} px (atol {EXPORT_ATOL})")
    return err


def phase_deploy_export(models, programs, tmp) -> None:
    """18a: each model's predict program exported at b1 and b8 on the card,
    saved, loaded back and run on seeded frames against the eager program
    (the same net, ``decode_filter_nms_batch``): one K1 node in each
    graph, one K1 launch a call."""
    from fdtpu_torch.export import export_predict, load_exported

    rng = np.random.default_rng(SEED + 42)
    prob, iou, cap = DEPLOY_THRESHOLDS
    for name, model in models.items():
        for b in DEPLOY_BATCHES:
            t0 = time.perf_counter()
            path = export_predict(model, os.path.join(tmp, f"{name}_b{b}.pt2"), b, prob, iou, cap)
            export_s = time.perf_counter() - t0
            loaded = load_exported(path)
            nodes = sum(n.target is torch.ops.fdtpu_torch.decode_filter_nms.default
                        for n in loaded.graph.nodes)
            check(nodes == 1, f"{name} b{b}: {nodes} K1 nodes in the exported graph")
            frames = deploy_frames(rng, b)
            start = LAUNCHES["decode_filter_nms"]
            got = loaded(frames)
            torch.cuda.synchronize()
            calls = LAUNCHES["decode_filter_nms"] - start
            check(calls == 1, f"{name} b{b}: the loaded program launched K1 {calls} times")
            with torch.no_grad():
                want = programs[name](frames)
            err = same_boxes(got, want, f"{name} b{b} loaded .pt2")
            kept = check_boxes(*got, cap, prob, f"{name} b{b} loaded")
            print(f"[18a export] {name} b{b} {DEPLOY_SIZE}px bf16: exported and saved in "
                  f"{export_s:.1f} s ({path.stat().st_size / 1e6:.1f} MB), one K1 node; the "
                  f"loaded program against eager: masks equal, {int(kept.sum())} boxes, largest "
                  f"difference {err:.3g} px (atol {EXPORT_ATOL}); K1 launched {calls} time")


def phase_deploy_graph(card, models, programs) -> int:
    """18b: ``aot_compile_predict`` at b1 (the exported program captured in a
    CUDA graph) against the eager program, then the b1 latency by CUDA
    events, median of three loops: ``Detector.predict`` (a u8 host frame),
    the eager program and the graph replay (a float frame on the card).
    Returns K1's launches by the ``GraphPredict`` replays: each graph's
    replays times the K1 launches captured in it (``per_replay``)."""
    from fdtpu_torch.export import aot_compile_predict

    rng = np.random.default_rng(SEED + 43)
    prob, iou, cap = DEPLOY_THRESHOLDS
    replays = 0
    for name, model in models.items():
        graph = aot_compile_predict(model, 1, prob, iou, cap)
        per = graph.graph.per_replay["decode_filter_nms"]
        check(per == 1, f"{name}: {per} K1 launches captured")
        frame = deploy_frames(rng, 1)
        got = graph(frame)
        program = programs[name]
        with torch.no_grad():
            want = program(frame)
        err = same_boxes(got, want, f"{name} CUDA graph")
        det = Detector(model, prob, iou, cap)
        u8 = frame[0].to(torch.uint8).cpu().numpy()

        def eager():
            with torch.no_grad():
                return program(frame)

        arms = {"Detector.predict": lambda: det.predict(u8), "eager program": eager,
                "graph replay": lambda: graph(frame)}
        ms = {k: statistics.median(event_ms(fn, LATENCY_ITERS) for _ in range(LATENCY_LOOPS))
              for k, fn in arms.items()}
        replays += graph.replays * per
        print(f"[18b graph] {name} b1 {DEPLOY_SIZE}px bf16: CUDA-graph predict against eager: "
              f"masks equal, {int(got[1].sum())} boxes, largest difference {err:.3g} px; b1 "
              f"latency (median of {LATENCY_LOOPS} loops of {LATENCY_ITERS}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()) + f" [{card}]")
    return replays


def iou_matched(boxes, others) -> int:
    """How many of ``boxes`` (``[score, x, y, w, h]`` rows) have a row of
    ``others`` at IoU > 0.5."""
    if not len(boxes) or not len(others):
        return 0
    a, o = boxes[:, None, 1:], others[None, :, 1:]
    ix = np.clip(np.minimum(a[..., 0] + a[..., 2], o[..., 0] + o[..., 2])
                 - np.maximum(a[..., 0], o[..., 0]), 0, None)
    iy = np.clip(np.minimum(a[..., 1] + a[..., 3], o[..., 1] + o[..., 3])
                 - np.maximum(a[..., 1], o[..., 1]), 0, None)
    inter = ix * iy
    union = a[..., 2] * a[..., 3] + o[..., 2] * o[..., 3] - inter
    iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0)
    return int((iou > 0.5).any(axis=1).sum())


def phase_deploy_native(models, tmp) -> None:
    """18c: float32 and int8 ``.fdn`` artifacts of both models through the
    port's engine on the host, 8 frames, against the port's float32 predict
    on the card (TF32 off): counts equal and boxes within the engine's
    tolerance for float32; the int8 artifact's agreement; the engine's ms a
    frame."""
    from fdtpu_torch.export import export_native
    from fdtpu_torch.native import NativeDetector

    rng = np.random.default_rng(SEED + 44)
    prob, iou, cap = DEPLOY_THRESHOLDS
    frames = rng.integers(0, 256, size=(NATIVE_FRAMES, DEPLOY_SIZE, DEPLOY_SIZE, 3),
                          dtype=np.uint8)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, model in models.items():
            det = Detector(model, prob, iou, cap, dtype=torch.float32)
            with torch.inference_mode():
                tb, tm = det.non_max_suppression(
                    det.apply(torch.from_numpy(frames).cuda().float() / 255.0))
            tb, tm = tb.cpu().numpy(), tm.cpu().numpy()
            got, line = {}, []
            for quant in (None, "int8"):
                path = export_native(model, os.path.join(tmp, f"{name}_{quant}.fdn"), prob, iou,
                                     cap, weight_quant=quant)
                engine = NativeDetector(path)
                t0 = time.perf_counter()
                got[quant] = engine.predict(frames)
                batch_ms = (time.perf_counter() - t0) * 1e3 / NATIVE_FRAMES
                one = []
                for i in range(3):
                    t0 = time.perf_counter()
                    engine.predict(frames[i])
                    one.append((time.perf_counter() - t0) * 1e3)
                line.append(f"{quant or 'f32'} {path.stat().st_size / 1e6:.2f} MB: "
                            f"{batch_ms:.1f} ms a frame at b{NATIVE_FRAMES} "
                            f"({os.cpu_count()} threads), b1 median {statistics.median(one):.1f} ms")
            nb, nm = got[None]
            worst, total = 0.0, 0
            for i in range(NATIVE_FRAMES):
                cn, ct = nb[i][nm[i]], tb[i][tm[i]]
                check(len(cn) == len(ct), f"{name} .fdn frame {i}: {len(cn)} boxes, card {len(ct)}")
                if len(cn):
                    np.testing.assert_allclose(cn, ct, atol=NATIVE_ATOL, rtol=NATIVE_RTOL,
                                               err_msg=f"{name} .fdn frame {i}")
                    worst = max(worst, float(np.abs(cn - ct).max()))
                total += len(cn)
            check(total > 0, f"{name}: no boxes to compare")
            qb, qm = got["int8"]
            q_counts = [int(qm[i].sum()) for i in range(NATIVE_FRAMES)]
            f_counts = [int(nm[i].sum()) for i in range(NATIVE_FRAMES)]
            matched = sum(iou_matched(nb[i][nm[i]], qb[i][qm[i]]) for i in range(NATIVE_FRAMES))
            print(f"[18c native] {name} {DEPLOY_SIZE}px: the engine's float32 artifact against "
                  f"the card's float32 predict on {NATIVE_FRAMES} frames: counts equal "
                  f"({total} boxes), largest difference {worst:.3g} (atol {NATIVE_ATOL}, rtol "
                  f"{NATIVE_RTOL}); int8 counts {q_counts} against float32 {f_counts}, "
                  f"{matched} of {total} float32 boxes matched in int8 (IoU > 0.5); "
                  + "; ".join(line))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def phase_deploy_prune(card, model) -> None:
    """18d: PoolResnet-128 pruned to 102 channels (amount 0.2) and to 64
    (``align`` 64); each bf16 forward at b64/480 finite and of the grid's
    shape, then b64 forward + decode img/s for 128, 102 and 64 channels
    (CUDA events, median of three loops of 20)."""
    from fdtpu_torch.compat.pruning import prune_l1_structured

    pruned = {128: model, 102: prune_l1_structured(model, 0.2),
              64: prune_l1_structured(model, 0.2, align=64)}
    batch = torch.from_numpy(np.random.default_rng(SEED + 45).integers(
        0, 256, size=(PRUNE_BATCH, DEPLOY_SIZE, DEPLOY_SIZE, 3), dtype=np.uint8)).cuda()
    line = []
    for width, m in pruned.items():
        check(m.conv1.out_channels == width, f"pruned to {m.conv1.out_channels}, want {width}")
        det = Detector(m)
        out = det.apply(batch.float() / 255.0)
        check(out.shape == (PRUNE_BATCH, 10, 10, 5) and bool(torch.isfinite(out).all()),
              f"pruned {width} forward")

        def infer():
            return det.non_max_suppression(det.apply(batch.float() / 255.0))

        ms = statistics.median(event_ms(infer, 20) for _ in range(3))
        line.append(f"{width} channels {ms:.3f} ms/batch ({PRUNE_BATCH * 1e3 / ms:.1f} img/s)")
    print(f"[18d prune] PoolResnet-128x10 {DEPLOY_SIZE}px bf16 L1-pruned by amount 0.2 -> 102 "
          f"and with align 64 -> 64, forwards finite; b{PRUNE_BATCH} forward + decode: "
          + ", ".join(line) + f" [{card}]")


def phase_deploy(card, tmp) -> None:
    """18: deployment."""
    from fdtpu_torch.export import PredictProgram

    t0 = time.perf_counter()
    models = deploy_models()
    prob, iou, cap = DEPLOY_THRESHOLDS
    programs = {name: PredictProgram(m, prob, iou, cap) for name, m in models.items()}
    start = LAUNCHES.copy()
    phase_deploy_export(models, programs, tmp)
    replays = phase_deploy_graph(card, models, programs)
    phase_deploy_native(models, tmp)
    phase_deploy_prune(card, models["poolresnet"])
    launches = on_path(start)["decode_filter_nms"]
    print(f"[18 deploy] K1 launches on the deployment paths {launches} ({replays} of them "
          f"GraphPredict replays, the rest eager calls, the Detectors' replays and the "
          f"warm-ups before the captures); phase 18 took {time.perf_counter() - t0:.1f} s")


# -- phase 20: the last entry points ------------------------------------------------------------


def camera_detector(frames):
    """``demo_model``'s bf16 Detector of PoolResnet-128x10 grid 10 at 480 px
    (random weights from seed 0, as its ``build_detector`` draws them),
    with the head's score bias shifted so that ``CAMERA_PASS`` of the cells
    of the BGR ``frames`` pass the threshold, as phase 18 does: random
    weights alone put no cell above 0.5."""
    from PIL import Image

    from fdtpu_torch import demo_model

    args = demo_model.parse_args(CAMERA_ARGS)
    cfg = DetectorConfig(filters=args.filters, input_shape=(args.input, args.input),
                         num_patches=args.patches, num_residual_blocks=args.blocks)
    module = build_model(args.model, cfg, args.device, torch.Generator().manual_seed(0))
    resized = np.stack([np.asarray(Image.fromarray(np.ascontiguousarray(f[..., ::-1])).resize(
        (args.input, args.input), Image.BILINEAR)) for f in frames])
    batch = torch.from_numpy(resized.astype(np.float32)).to(args.device)
    prob, iou = demo_model.thresholds(args, cfg)
    with torch.no_grad():
        score = module(batch / 255.0)[..., 0].double().clamp(1e-9, 1 - 1e-9)
        logit = torch.quantile(torch.logit(score).flatten(), 1 - CAMERA_PASS)
        module.out.bias[0] += math.log(prob / (1 - prob)) - float(logit)
    return Detector(module, probability_threshold=prob, iou_threshold=iou,
                    nms_capacity=cfg.nms_capacity, dtype=DTYPES[cfg.dtype])


def camera_frames(tmp) -> list[np.ndarray]:
    """``CAMERA_FRAMES`` BGR frames of a webcam's size, from
    ``make_synthetic_widerface`` images resized with PIL."""
    from PIL import Image

    root = make_synthetic_widerface(os.path.join(tmp, "camera"), num_images=CAMERA_FRAMES,
                                    seed=SEED + 61)
    paths = sorted((root / "WIDER_train" / "images" / "0--Synthetic").glob("*.jpg"))
    h, w = CAMERA_HW
    return [np.ascontiguousarray(np.asarray(Image.open(p).convert("RGB").resize(
        (w, h), Image.BILINEAR))[..., ::-1]) for p in paths]


class StubCv2:
    """What ``run_camera`` calls of OpenCV: a camera that serves ``frames``
    and then fails a read, with the host clock at each read, the
    rectangles drawn on each frame and the frames shown."""

    COLOR_BGR2RGB, COLOR_RGB2BGR = 4, 5

    def __init__(self, frames):
        self.frames, self.read_at, self.rects, self.shown = list(frames), [], [], 0
        self.released = self.destroyed = 0
        stub = self

        class VideoCapture:
            def __init__(self, index):
                check(index == 0, f"camera {index}")

            def read(self):
                stub.read_at.append(time.perf_counter())
                if not stub.frames:
                    return False, None
                stub.rects.append([])
                return True, stub.frames.pop(0)

            def release(self):
                stub.released += 1

        self.VideoCapture = VideoCapture

    @staticmethod
    def cvtColor(img, code):
        return np.ascontiguousarray(img[..., ::-1])

    def rectangle(self, img, p1, p2, color, thickness):
        check(color == (255, 0, 0) and thickness == 2, f"rectangle {color} {thickness}")
        self.rects[-1].append((*p1, *p2))

    def imshow(self, name, img):
        self.shown += 1

    @staticmethod
    def waitKey(ms):
        return -1

    def destroyAllWindows(self):
        self.destroyed += 1


def phase_camera(card, tmp) -> None:
    """20a: ``demo_model.run_camera`` on the card over a stub ``cv2``'s
    frames."""
    from fdtpu_torch import demo_model
    from fdtpu_torch.core import compact_boxes

    frames = camera_frames(tmp)
    det = camera_detector(frames)
    cv2 = StubCv2(frames)
    events = []
    predict = det.predict

    def timed_predict(img):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = predict(img)
        end.record()
        events.append((start, end))
        return out

    det.predict = timed_predict
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = cv2
    try:
        start = LAUNCHES.copy()
        demo_model.run_camera(det)
        launches = on_path(start)["decode_filter_nms"]
        calls = launches - warm_ups(det)["decode_filter_nms"]
    finally:
        if saved is None:
            sys.modules.pop("cv2")
        else:
            sys.modules["cv2"] = saved
        det.predict = predict
    torch.cuda.synchronize()
    check(len(cv2.rects) == cv2.shown == CAMERA_FRAMES and len(cv2.read_at) == CAMERA_FRAMES + 1,
          f"{len(cv2.rects)} frames drawn, {cv2.shown} shown, {len(cv2.read_at)} reads")
    check(cv2.released == cv2.destroyed == 1, "camera released and windows destroyed once")
    check(calls == CAMERA_FRAMES, f"K1 launched {calls} times in {CAMERA_FRAMES} frames")
    drawn = []
    for i, (frame, rects) in enumerate(zip(frames, cv2.rects)):
        _, boxes, mask = det.predict(np.ascontiguousarray(frame[..., ::-1]))
        kept = compact_boxes(boxes, mask)
        want = [(int(x), int(y), int(x) + int(w), int(y) + int(h)) for _, x, y, w, h in kept]
        check(rects == want, f"frame {i}: drawn {rects}, predict {want}")
        check(len(rects) == int(mask.sum()), f"frame {i}: {len(rects)} drawn, mask {mask.sum()}")
        drawn.append(len(rects))
    check(max(drawn) > 0, "no frame had a box")
    calls = (LAUNCHES - start - warm_ups(det))["decode_filter_nms"]
    check(calls == 2 * CAMERA_FRAMES, f"K1 launches {calls}, want {2 * CAMERA_FRAMES}")
    replays = sum(g.replays for g in det._graphs.graphs.values())
    check(replays == 2 * CAMERA_FRAMES, f"predict replayed {replays} times, want "
          f"{2 * CAMERA_FRAMES}")
    device = [s.elapsed_time(e) for s, e in events]
    host = [(b - a) * 1e3 for a, b in zip(cv2.read_at, cv2.read_at[1:])]
    print(f"[20a camera] demo_model.run_camera on the card, bf16 PoolResnet-128x10 grid 10 at "
          f"480 px, {CAMERA_FRAMES} BGR {CAMERA_HW[1]}x{CAMERA_HW[0]} frames of a stub cv2: "
          f"rectangles = predict's boxes on every frame ({sum(drawn)} drawn, up to {max(drawn)} "
          f"a frame), K1 {launches} launches in the loop (one a frame, replayed from predict's "
          f"CUDA graph, and its capture's warm-ups) + {CAMERA_FRAMES} checking calls; "
          f"predict by CUDA events median {statistics.median(device):.3f} ms "
          f"({min(device):.3f}-{max(device):.3f}), the whole frame by the host clock median "
          f"{statistics.median(host):.3f} ms ({min(host):.3f}-{max(host):.3f}) [{card}]")


def feed_dataset(tmp):
    """``FEED_IMAGES`` JPEGs of ``FEED_JPEG_WH`` at ``FEED_QUALITY``, written
    with PIL from ``make_synthetic_widerface`` images (seeded) resized to that
    size, and their targets (boxes scaled alike)."""
    from PIL import Image

    root = make_synthetic_widerface(os.path.join(tmp, "feed"), num_images=FEED_IMAGES,
                                    seed=SEED + 62)
    targets = load_targets(root, "train", 3)
    w, h = FEED_JPEG_WH
    for t in targets:
        img = Image.open(t["img_path"]).convert("RGB")
        w0, h0 = img.size
        img.resize((w, h), Image.BILINEAR).save(t["img_path"], quality=FEED_QUALITY)
        t["bbx"] = t["bbx"].copy()
        t["bbx"][:, [1, 3]] *= w / w0
        t["bbx"][:, [2, 4]] *= h / h0
    return targets


def median_s(fn, reps: int = FEED_REPS) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_feed(card, tmp) -> None:
    """20b: the native JPEG feed on the card's host: the loader loads,
    ``get_batch`` equals per-sample ``get`` bit for bit, and the host decode
    and the first-epoch feed timed with each decoder."""
    from fdtpu_torch.native import loader

    t0 = time.perf_counter()
    check(loader.native_available(), "the native loader does not load on this machine")
    lib = loader.build()
    ldd = subprocess.run(["ldd", str(lib)], capture_output=True, text=True).stdout
    jpeg = " ".join(line.split()[0] + " => " + line.split()[2] for line in ldd.splitlines()
                    if "jpeg" in line and "=>" in line)
    targets = feed_dataset(tmp)
    made_s = time.perf_counter() - t0

    def source(side, native, cache=False):
        return WIDERFaceDataSource(targets, (side, side), 8, error_log=None,
                                   use_native=native, cache_decoded=cache)

    line = []
    for b, side in FEED_SHAPES:
        idx = list(range(b))
        native, plain = source(side, None), source(side, False)
        check(native.use_native, "WIDERFaceDataSource() does not decode natively here")
        got, want = native.get_batch(idx), [native.get(i) for i in idx]
        for i, (g, w) in enumerate(zip(got, want)):
            for a, c in zip(g, w):
                check(np.array_equal(a, c), f"b{b}/{side} sample {i}: get_batch != get")
        pil_ms = median_s(lambda: [plain.get(i) for i in idx]) * 1e3
        native_ms = median_s(lambda: native.get_batch(idx)) * 1e3
        line.append(f"b{b}/{side} PIL {pil_ms:.1f} ms, native {native_ms:.1f} ms a batch "
                    f"({pil_ms / native_ms:.2f}x)")
    feed = []
    for native in (False, True):
        loader_ = BatchLoader(source(320, native, cache=True), 128)
        t1 = time.perf_counter()
        n = sum(int(batch.sample_mask.sum()) for batch in loader_)
        check(n == FEED_IMAGES, f"feed gave {n} images")
        feed.append(f"{'native' if native else 'PIL'} {n / (time.perf_counter() - t1):.1f} img/s")
    shapes = " and ".join(f"b{b}/{side}" for b, side in FEED_SHAPES)
    print(f"[20b feed] native loader loads ({lib.name}: {jpeg}); get_batch = per-sample get "
          f"bit for bit at {shapes} on {FEED_JPEG_WH[0]}x{FEED_JPEG_WH[1]} q"
          f"{FEED_QUALITY} JPEGs; host decode, medians of {FEED_REPS}, cache off, "
          f"os.cpu_count() {os.cpu_count()} (the loader's threads): " + "; ".join(line)
          + f"; first-epoch BatchLoader feed at b128/320 over {FEED_IMAGES} images: "
          + ", ".join(feed) + f" (dataset written in {made_s:.1f} s) [{card}]")


def phase_entry(card, tmp) -> None:
    """20: the last entry points."""
    t0 = time.perf_counter()
    phase_camera(card, tmp)
    phase_feed(card, tmp)
    print(f"[20 entry] phase 20 took {time.perf_counter() - t0:.1f} s")


# -- phase 21: the train step in a CUDA graph -------------------------------------


def graph_batch(b: int, size: int, seed: int):
    """A train batch from ``seed``: random u8 frames and one to three faces
    an image in a padded (B, 4, 5) box array."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, size=(b, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((b, 4, 5), dtype=np.float32)
    wh = rng.uniform(24, size / 3, (b, 4, 2)).round()
    boxes[..., 0] = 1.0
    boxes[..., 1:3] = (rng.uniform(0, 1, (b, 4, 2)) * (size - wh)).round()
    boxes[..., 3:5] = wh
    masks = np.arange(4)[None] < rng.integers(1, 4, (b, 1))
    boxes[~masks] = 0.0
    return tuple(torch.from_numpy(a).to("cuda") for a in (images, boxes, masks))


def graph_state(spec: tuple):
    """A capturable state of ``spec`` (a value of :data:`GRAPH_MODELS`)
    from the seed, and its TrainConfig."""
    family, cfg, _, kw, _ = spec
    tcfg = TrainConfig(positional_crop=True, seed=SEED, **kw)
    module = build_model(family, cfg, "cuda", torch.Generator().manual_seed(SEED),
                         compute_dtype=torch.bfloat16)
    return create_train_state(module, tcfg, 100, capturable=True), tcfg


def state_tensors_named(state) -> list[tuple[str, torch.Tensor]]:
    """The params, buffers and optimizer state of a train state, named."""
    out = [(f"param {n}", p.detach()) for n, p in state.module.named_parameters()]
    out += [(f"buffer {n}", b) for n, b in state.module.named_buffers()]
    names = {id(p): n for n, p in state.module.named_parameters()}
    for p, st in state.optimizer.state.items():
        out += [(f"adam {k} {names[id(p)]}", v) for k, v in st.items()
                if isinstance(v, torch.Tensor)]
    return out


def graph_vs_eager(spec: tuple, make=make_train_step) -> dict:
    """21a for one model (``spec``, a value of :data:`GRAPH_MODELS`; 17a and
    19a with ``make`` a data-parallel or spatial step builder): five eager
    steps and five replays of the captured step, each from its own copy of
    the same state (both built from the seed), on five batches; returns
    what differs and the launches."""
    family, cfg, b, _, augment = spec
    size = cfg.input_shape[0]
    batches = [graph_batch(b, size, SEED + 100 + i) for i in range(GRAPH_STEPS)]
    (eager, tcfg), (replayed, _) = graph_state(spec), graph_state(spec)
    step = make(eager.module, tcfg, augment=augment)
    captured = CapturedTrainStep(make(replayed.module, tcfg, augment=augment))
    start = LAUNCHES.copy()
    want = [dict(step(eager, *batch)[1]) for batch in batches]
    torch.cuda.synchronize()
    eager_launches = dict(LAUNCHES - start)
    start = LAUNCHES.copy()
    got = [dict(captured(replayed, *batch)[1]) for batch in batches]
    torch.cuda.synchronize()
    (g,) = captured.graphs.values()
    graph_launches = {k: n * g.replays for k, n in g.per_replay.items() if n}
    check(LAUNCHES - start == g.warm_launches + Counter(graph_launches),
          f"the captured step launched {dict(LAUNCHES - start)}: not its warm-up's "
          f"{dict(g.warm_launches)} and its replays' {graph_launches}")
    differ = [f"step {i} {k}" for i, (w, g) in enumerate(zip(want, got)) for k in w
              if not torch.equal(w[k], g[k])]
    worst = 0.0
    for (name, a), (_, c) in zip(state_tensors_named(eager), state_tensors_named(replayed)):
        if not torch.equal(a, c):
            differ.append(name)
            worst = max(worst, (a.float() - c.float()).abs().max().item())
    return {"differ": differ, "worst": worst, "eager_launches": eager_launches,
            "graph_launches": graph_launches, "per_replay": dict(g.per_replay),
            "pool_bytes": g.pool_bytes, "capture_s": g.capture_s,
            "losses": [round(s["loss"].item(), 4) for s in got],
            "eager": (eager, step), "graph": (replayed, captured), "batch": batches[0]}


def graph_failures(label: str, run: dict) -> list[str]:
    """What makes ``run`` (:func:`graph_vs_eager`) fail: a state tensor or
    scalar that differs, or replays that launch other kernels than the
    eager steps."""
    out = []
    if run["differ"]:
        out.append(f"{label}: {len(run['differ'])} differ, first {run['differ'][:4]}, worst "
                   f"{run['worst']:.3g}")
    if run["graph_launches"] != run["eager_launches"]:
        out.append(f"{label}: launches {run['graph_launches']} in the replays against "
                   f"{run['eager_launches']} eager")
    return out


def graph_summary(run: dict) -> dict:
    """The printed part of a :func:`graph_vs_eager` run."""
    return {k: run[k] for k in ("losses", "per_replay", "eager_launches", "pool_bytes",
                                "capture_s")}


def plain_replay(spec: tuple, batch):
    """One replay of the one-process step of ``spec`` captured on its own
    state, on ``batch``: the arm the data-parallel and spatial replays are
    timed against."""
    state, tcfg = graph_state(spec)
    captured = CapturedTrainStep(make_train_step(state.module, tcfg, augment=spec[4]))
    return lambda: captured(state, *batch)


def arm_rows(arms: dict, b: int, profiled: bool = True, steps: dict | None = None) -> dict:
    """Each arm (name -> one step) timed GRAPH_RUNS times over
    GRAPH_TIMED_STEPS steps (or ``steps[arm]``) by CUDA events, in turns:
    the median step ms, its range, the steps a run and img/s; with
    ``profiled`` also device busy ms and idle
    share under the profiler (``profile_train.measure``), of the profiled
    window itself, which the profiler lengthens, and of the timed median,
    which can read below 0, kernels and host launch calls a step."""
    from fdtpu_torch.profile_train import measure

    steps = {arm: (steps or {}).get(arm, GRAPH_TIMED_STEPS) for arm in arms}
    ms = {arm: [] for arm in arms}
    for _ in range(GRAPH_RUNS):
        for arm, fn in arms.items():
            ms[arm].append(event_ms(fn, steps[arm]))
    out = {}
    for arm, fn in arms.items():
        med = statistics.median(ms[arm])
        out[arm] = {"step_ms": med, "range": [min(ms[arm]), max(ms[arm])],
                    "steps": steps[arm], "img_s": b * 1e3 / med}
        if profiled:
            prof = measure(fn, GRAPH_PROFILED_STEPS)
            out[arm].update({"busy_ms": prof["busy_ms"], "idle": prof["idle"],
                             "idle_unprofiled": 1 - prof["busy_ms"] / med,
                             "kernels": prof["kernels"], "launch_calls": prof["launch_calls"]})
    return out


def arm_line(rows: dict) -> str:
    """The step ms of each arm of :func:`arm_rows`, median (range), and
    where profiled the busy ms, both idle shares and the kernels and host
    launch calls a step."""
    parts = []
    for arm, r in rows.items():
        lo, hi = r["range"]
        part = (f"{arm} {r['step_ms']:.3f} ({lo:.3f}-{hi:.3f}; {GRAPH_RUNS} x {r['steps']}) ms, "
                f"{r['img_s']:.1f} img/s")
        if "busy_ms" in r:
            part += (f", busy {r['busy_ms']:.3f} ms, idle {r['idle']:.3f} of the profiled "
                     f"window / {r['idle_unprofiled']:.3f} of the median, {r['kernels']:.0f} "
                     f"kernels / {r['launch_calls']:.0f} host launch calls a step")
        parts.append(part)
    return "; ".join(parts)


def graph_milestones() -> None:
    """21a, the learning rate: Adam and SGD across a milestone (epochs of
    two steps, the rate times 0.1 from step 2), PoolResnet-128x10 b8/480
    with rotation: four replays bit-equal to four eager steps; Adam's graph
    reads the new rate from its tensor, SGD's step is captured again."""
    family, cfg, b, kw, augment = GRAPH_MODELS["poolresnet-b8-480"]
    batches = [graph_batch(b, cfg.input_shape[0], SEED + 200 + i) for i in range(4)]
    for opt in ("adam", "sgd"):
        tcfg = TrainConfig(positional_crop=True, seed=SEED, optimizer=opt, lr_milestones=(1,), **kw)
        eager, replayed = (create_train_state(
            build_model(family, cfg, "cuda", torch.Generator().manual_seed(SEED),
                        compute_dtype=torch.bfloat16), tcfg, steps_per_epoch=2, capturable=True)
            for _ in range(2))
        step = make_train_step(eager.module, tcfg, augment=augment)
        captured = CapturedTrainStep(make_train_step(replayed.module, tcfg, augment=augment))
        for batch in batches:
            step(eager, *batch)
            captured(replayed, *batch)
        differ = [n for (n, x), (_, y) in zip(state_tensors_named(eager),
                                              state_tensors_named(replayed))
                  if not torch.equal(x, y)]
        check(not differ, f"{opt} across a milestone: {differ[:4]} differ")
        recaptured = captured._retired_replays
        check(captured.replays == 4 and recaptured == (2 if opt == "sgd" else 0),
              f"{opt}: {captured.replays} replays, {recaptured} before a new capture")
        rates = [eager.schedule(i) for i in range(4)]
        print(f"[21 graph] {opt} across a milestone (rates {rates}): 4 replays = 4 eager steps "
              f"bit for bit; {'captured again at the new rate' if recaptured else 'one graph'}")


def graph_times(card: str, label: str, run: dict) -> dict:
    """21c for one model (``--graph`` only): eager step against replay
    (:func:`arm_rows`). Both arms run the capturable Adam."""
    (es, step), (gs, captured), batch = run["eager"], run["graph"], run["batch"]
    out = arm_rows({"eager": lambda: step(es, *batch), "graph": lambda: captured(gs, *batch)},
                   batch[0].shape[0])
    e, g = out["eager"], out["graph"]
    print(f"[21 graph] {label}: step ms median (range of {GRAPH_RUNS} x {GRAPH_TIMED_STEPS}) "
          f"eager {e['step_ms']:.3f} ({ms_range(e['range'])}), graph {g['step_ms']:.3f} "
          f"({ms_range(g['range'])}); img/s {e['img_s']:.1f} -> {g['img_s']:.1f}; device busy "
          f"{e['busy_ms']:.3f} / {g['busy_ms']:.3f} ms, idle share of the profiled window "
          f"{e['idle']:.3f} -> {g['idle']:.3f}, of the median {e['idle_unprofiled']:.3f} -> "
          f"{g['idle_unprofiled']:.3f}; kernels a step {e['kernels']:.0f} / {g['kernels']:.0f}, host launch "
          f"calls a step {e['launch_calls']:.0f} / {g['launch_calls']:.0f}; graph pool "
          f"{run['pool_bytes'] / 2**20:.1f} MiB, warm-up + capture {run['capture_s']:.2f} s "
          f"[{card}]")
    return out


def same_fit(a, b, what: str) -> None:
    """Two ``(trainer, fit result)`` pairs bit for bit: the epoch metrics,
    the step, the params, buffers and Adam state."""
    (ta, oa), (tb, ob) = a, b
    check(oa == ob, f"{what}: epoch metrics {oa} against {ob}")
    check(ta.state.step == tb.state.step, f"{what}: steps {ta.state.step} / {tb.state.step}")
    for (n, x), (_, y) in zip(state_tensors_named(ta.state), state_tensors_named(tb.state)):
        check(torch.equal(x, y), f"{what}: {n} differs")


def graph_trainer_fits(tmp, timings: bool) -> None:
    """21b: the Trainer's fits on the card, streamed at
    ``steps_per_dispatch`` 1 and 4 and with ``device_data``, every batch
    replayed (the metrics one too), against the fits run eagerly
    (``Trainer.replaying`` off, the same capturable Adam), and a resume in the
    middle of a replayed fit against the straight one. With ``timings``
    one more train epoch of each, by the host clock."""
    from pathlib import Path

    tmp = Path(tmp)
    n_train, n_val = TRAINER_IMAGES
    root = make_synthetic_widerface(tmp / "graph_data", n_train, split="train", seed=SEED)
    make_synthetic_widerface(root, n_val, split="val", seed=SEED + 1)
    base = TrainConfig(rotate_device=True, max_epochs=TRAINER_EPOCHS, seed=SEED,
                       visualize_first_batch=False, log_every_steps=0)

    def fit(name, epochs=TRAINER_EPOCHS, resume=False, eager=False, **kw):
        cfg = dataclasses.replace(base, checkpoint_dir=str(tmp / f"ckpt_{name}"),
                                  log_path=str(tmp / f"logs_{name}" / "out.log"), **kw)
        train, val = trainer_loaders(root, shuffle=True)
        t = Trainer(trainer_module(SEED), cfg, train, val, run_name=name, device="cuda")
        check(type(t.driver).__name__ == ("ResidentDriver" if cfg.device_data
                                          else "StreamedDriver"), f"{name}: {t.driver}")
        t.replaying = not eager  # eager: the eager steps run, as over gloo
        if resume:
            check(t.maybe_resume(), f"{name}: no checkpoint to resume")
        out = t.fit(epochs)
        torch.cuda.synchronize()
        replays = (slot_replays(t, "train"), slot_replays(t, "eval"))
        check(all((n == 0) == eager for n in replays),
              f"{name}: {replays} train and eval replays")
        return t, out

    eager = fit("eager", eager=True)
    streamed = fit("k1")
    same_fit(streamed, eager, "the replayed fit (steps_per_dispatch=1) against the eager fit")
    grouped = fit("k4", steps_per_dispatch=4)
    same_fit(grouped, eager, "steps_per_dispatch=4 against the eager fit")
    resident = fit("resident", device_data=True)
    resident_eager = fit("resident_eager", device_data=True, eager=True)
    same_fit(resident, resident_eager, "device_data replayed against device_data eager")
    fit("half", epochs=1)
    resumed = fit("half", resume=True)
    same_fit(resumed, streamed, "a replayed fit resumed after one epoch against the straight one")
    print(f"[21 graph] Trainer fits, PoolResnet-128x10 480px grid 10 b8 bf16 SAM+Adam, rotation "
          f"on the card, {n_train} / {n_val} synthetic images, {TRAINER_EPOCHS} epochs: "
          f"streamed replayed at steps_per_dispatch 1 and 4 = eager, device_data replayed = "
          f"device_data eager, and a replayed fit resumed after epoch 1 = the straight one, bit "
          f"for bit (epoch metrics, step, params, Adam moments and steps); train "
          f"{eager[1]['train']}")
    if not timings:
        return
    secs = {}  # one more train epoch of each, a sync at its end
    for name, (t, _) in (("streamed replayed", streamed), ("eager", eager),
                         ("resident replayed", resident), ("resident eager", resident_eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_epoch()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    for (t, _), (u, _) in ((streamed, eager), (resident, resident_eager)):
        same_fit((t, None), (u, None), "one more epoch")
    print("[21 graph] one more train epoch, host clock: " + ", ".join(
        f"{name} {1e3 * v:.1f} ms ({n_train / v:.1f} img/s)" for name, v in secs.items()))


def phase_graph(card: str, tmp, timings: bool = False) -> None:
    """21: the train step captured in a CUDA graph; ``timings`` (``--graph``)
    adds 21c."""
    t0, start = time.perf_counter(), LAUNCHES.copy()
    failures = []
    for label, spec in GRAPH_MODELS.items():
        run = graph_vs_eager(spec)
        failures += graph_failures(label, run)
        print(f"[21 graph] {label}: {GRAPH_STEPS} replays against {GRAPH_STEPS} eager steps "
              f"from the same state: {'bit-equal' if not run['differ'] else 'DIFFER'} (losses, "
              f"grad norms, params, buffers, Adam moments and steps); losses {run['losses']}; "
              f"kernel launches a replay {run['per_replay']}, eager {run['eager_launches']}; "
              f"graph pool {run['pool_bytes'] / 2**20:.1f} MiB, warm-up + capture "
              f"{run['capture_s']:.2f} s")
        if timings:
            graph_times(card, label, run)
        del run
        torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    graph_milestones()
    graph_trainer_fits(tmp, timings)
    # bench's graph rows, short loops
    w = fbench.make_workload("cuda", rotate_device=True)
    train_iters, infer_iters, latency_iters = BENCH_LOOPS
    rates = fbench.measure_train_graph(w, train_iters, 1)
    graph = fbench._graph_predict(w, w["data"][0])
    infer = [graph(w["data"][0]) for _ in range(infer_iters)]
    check(all(torch.equal(m, infer[0][1]) for _, m in infer), "GraphPredict b128 masks vary")
    print(f"[21 graph] bench's graph rows, loops {train_iters} / {infer_iters}: train "
          f"{rates[0]:.1f} img/s, b128 predict through GraphPredict "
          f"({graph.graph.per_replay['decode_filter_nms']} K1 a replay)")
    print(f"[21 graph] phase 21 took {time.perf_counter() - t0:.1f} s; launches "
          f"{dict(on_path(start))}")


# -- phase 22: serving and eval replayed from CUDA graphs ---------------------------


def score_heads(model) -> list:
    """The layers whose output channel 0 is the score: the SSD's four heads,
    MobileNetV3's head, the grid models' ``out``."""
    if isinstance(model, SSD):
        return list(model.heads)
    return [model.head if isinstance(model, MobileNetV3Backbone) else model.out]


def serve_model(family: str, cfg, seed: int):
    """A float32 master of ``family`` at ``cfg`` on the card, random weights
    from ``seed``, its score bias shifted so that ``SERVE_PASS`` of a seeded
    frame's candidates pass 0.5, as phases 18 and 20 do: random weights
    alone put few or none above it."""
    model = build_model(family, cfg, "cuda", torch.Generator().manual_seed(seed))
    h = cfg.input_shape[0]
    frame = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 256, size=(1, h, h, 3)).astype(np.float32)).cuda()
    with torch.no_grad():
        score = model.eval()(frame / 255.0)[..., 0].double().clamp(1e-9, 1 - 1e-9)
        logit = torch.quantile(torch.logit(score).flatten(), 1 - SERVE_PASS)
        for head in score_heads(model):
            head.bias[0] -= float(logit)
    return model


def serve_frames(seed: int) -> dict:
    """22a's frames: a model-size u8 frame, a 640x480 u8 frame (resized
    through PIL) and a model-size float32 frame in [0, 255]."""
    rng = np.random.default_rng(seed)
    return {"u8": rng.integers(0, 256, size=(480, 480, 3), dtype=np.uint8),
            "vga": rng.integers(0, 256, size=(*CAMERA_HW, 3), dtype=np.uint8),
            "float": rng.uniform(0, 255, size=(480, 480, 3)).astype(np.float32)}


def eager_predict(det, image, prob=None, iou=None):
    """``Detector.predict``'s eager body called directly: the host step, the
    frame on the card, ``predict_body`` (what ``predict`` ran before it
    replayed)."""
    prob = det.probability_threshold if prob is None else prob
    iou = det.iou_threshold if iou is None else iou
    with torch.inference_mode():
        img = torch.tensor(det.host_frame(image), device=det.device)
        norm, boxes, mask = det.predict_body(img, prob, iou)
        return norm[0], boxes[0], mask[0]


def det_graphs(det) -> list:
    return list(det._graphs.graphs.values())


def serve_predict_vs_eager(models: dict) -> dict:
    """22a: each family's bf16 Detector, ``predict`` on each frame kind at
    both threshold pairs in turn, twice (the second pass replays the graphs
    the first captured), against its eager body; then
    ``non_max_suppression`` at B 1, 8 and 128 (PoolResnet), 24 (SSD) and
    b8/640 (SSD-16 at 640 px: K1's global scratch inside the graph) at both
    pairs against the eager decode. Returns the Detectors."""
    dets = {}
    frames = serve_frames(SEED + 70)
    for family, model in models.items():
        det = dets[family] = Detector(model)
        check(len(det._graphs) == 0 and det._pool is None, f"22a {family}: captured at "
              "construction")
        differ, kept = [], []
        for _ in range(2):
            for kind, image in frames.items():
                for prob, iou in SERVE_THRESHOLDS:
                    got = det.predict(image, prob, iou)
                    want = eager_predict(det, image, prob, iou)
                    differ += [f"{kind} {prob}/{iou} {what}" for what, g, w in
                               zip(("norm", "boxes", "mask"), got, want) if not torch.equal(g, w)]
                    kept.append(int(got[2].sum()))
        graphs = det_graphs(det)
        replays = sum(g.replays for g in graphs)
        check(not differ, f"22a {family} predict replayed differs from eager: {differ[:4]}")
        check(len(graphs) == 4 and replays == 4 * len(frames), f"22a {family}: {len(graphs)} "
              f"graphs, {replays} replays")
        check(max(kept) > 0, f"22a {family}: no frame kept a box")
        print(f"[22a predict] bf16 {SP_NAMES[family]} 480px Detector: predict on a 480x480 u8, "
              f"a 640x480 u8 (PIL resize) and a 480x480 float32 frame at 0.5/0.5 and 0.7/0.01 in "
              f"turn, twice: {replays} replays of {len(graphs)} graphs (keyed by the frame's "
              f"dtype and the thresholds) = the eager body bit for bit (normalised image, boxes, "
              f"mask); boxes kept {kept[:6]}; pools "
              f"{[round(g.pool_bytes / 2**20, 1) for g in graphs]} MiB, capture "
              f"{[round(g.capture_s, 2) for g in graphs]} s")
    rng = np.random.default_rng(SEED + 71)
    det640 = Detector(serve_model("ssd", SSD_640, SEED + 72))
    cases = [("poolresnet", dets["poolresnet"], b, 480) for b in SERVE_NMS_BATCHES]
    cases += [("ssd", dets["ssd"], SSD_BATCH, 480), ("ssd 640", det640, SSD_640_BATCH, 640)]
    for name, det, b, size in cases:
        frames_b = torch.from_numpy(rng.integers(0, 256, size=(b, size, size, 3),
                                                 dtype=np.uint8)).cuda()
        out = det.apply(frames_b.float() / 255.0)
        kept = []
        for prob, iou in SERVE_THRESHOLDS:
            det.probability_threshold, det.iou_threshold = prob, iou
            got = det.non_max_suppression(out)
            want = det._decode(out, prob, iou, det.nms_capacity)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"22a {name} b{b}: non_max_suppression replayed differs from eager at "
                  f"{prob}/{iou}")
            kept.append(int(got[1].sum()))
        det.probability_threshold, det.iou_threshold = 0.5, 0.5
        n = out.reshape(b, -1, 5).shape[1]
        path = "global scratch" if n > knms.max_candidates(0) else "shared memory"
        check(name != "ssd 640" or path == "global scratch", "22a: b8/640 in shared memory")
        print(f"[22a nms] {name} b{b}/{size} (N {n}, K1 on {path}): non_max_suppression "
              f"replayed = the eager decode bit for bit at 0.5/0.5 and 0.7/0.01; boxes kept "
              f"{kept}")
        del out, frames_b
    return dets


def serve_eval_vs_eager(family: str, cfg) -> None:
    """22b for one family: its eval step (bf16 compute, b8, capacity 64)
    replayed, batch form and gather form, against the eager step on three
    batches, the last with a padded sample: scalars and boxes bit-equal."""
    module = build_model(family, cfg, "cuda", torch.Generator().manual_seed(SEED + 73),
                         compute_dtype=torch.bfloat16)
    state = create_train_state(module, TrainConfig(), 100, capturable=True)
    step = make_eval_step(module, nms_params=(0.5, 0.5, 64), return_boxes=True)
    captured = CapturedEvalStep(step)
    size = cfg.input_shape[0]
    batches = []
    for i in range(3):
        images, boxes, masks = graph_batch(SERVE_EVAL_BATCH, size, SEED + 300 + i)
        sample = torch.ones(SERVE_EVAL_BATCH, dtype=torch.bool, device="cuda")
        sample[-1] = i < 2
        batches.append((images, boxes, masks, sample))
    data = tuple(torch.cat(parts) for parts in zip(*batches))
    rows = torch.arange(data[0].shape[0], device="cuda")
    differ, losses = [], []
    for i, batch in enumerate(batches):
        want = step(state, *batch)
        losses.append(round(want[0]["loss"].item(), 4))
        sl = rows[i * SERVE_EVAL_BATCH:(i + 1) * SERVE_EVAL_BATCH]
        for form, got in (("batch", captured(state, *batch)),
                          ("gather", captured.gather(state, data, sl))):
            (ws, (wb, wm)), (gs, (gb, gm)) = want, got
            differ += [f"{form} {i} {k}" for k in ws if not torch.equal(ws[k], gs[k])]
            differ += [f"{form} {i} boxes"] * (not (torch.equal(wb, gb) and torch.equal(wm, gm)))
    check(not differ, f"22b {family} eval step replayed differs: {differ[:4]}")
    per = [g.per_replay["decode_filter_nms"] for g in captured.graphs.values()]
    check(captured.replays == 6 and per == [1, 1], f"22b {family}: {captured.replays} replays, "
          f"K1 a replay {per}")
    print(f"[22b eval step] {SP_NAMES[family]} 480px b{SERVE_EVAL_BATCH} bf16: the eval step "
          f"replayed (batch and gather forms, one padded sample in the last batch) = eager bit "
          f"for bit (loss, iou, recall, precision, boxes, mask); K1 once a replay; losses "
          f"{losses}")


def serve_trainer_evals(tmp) -> None:
    """22b: the Trainer's eval epoch (``DetectorConfig()`` b8 bf16, phase
    14's images, its first batch drawn), streamed and resident,
    replayed against the same epoch run eagerly (``Trainer.replaying``
    off);
    the metrics train step replayed against eager (phase 21a's check);
    ``run_validation_epoch --with-ap`` on a phase-14 checkpoint with the
    Trainer's replay rule on and off."""
    from pathlib import Path

    tmp = Path(tmp)
    root = tmp / "data"
    if not (root / "WIDER_val").exists():  # --serve alone: phase 14's images
        make_synthetic_widerface(root, TRAINER_IMAGES[0], split="train", seed=SEED)
        make_synthetic_widerface(root, TRAINER_IMAGES[1], split="val", seed=SEED + 1)
    trainers = {}
    cwd = os.getcwd()
    os.chdir(tmp)  # the drawings go to imgs/ here
    try:
        for feed in ("streamed", "resident"):
            cfg = TrainConfig(rotate_device=True, seed=SEED, device_data=feed == "resident",
                              checkpoint_dir=str(tmp / f"serve_ckpt_{feed}"),
                              log_path=str(tmp / f"serve_logs_{feed}" / "out.log"))
            train, val = trainer_loaders(root, shuffle=False)
            t = trainers[feed] = Trainer(trainer_module(SEED), cfg, train, val,
                                         run_name=f"serve_{feed}", device="cuda")
            replayed = t.eval_epoch()
            t.replaying = False  # the eager steps run
            eager = t.eval_epoch()
            t.replaying = True
            check(replayed == eager, f"22b {feed} eval epoch replayed {replayed} against eager "
                  f"{eager}")
            n = slot_replays(t, "eval")
            check(n == len(val), f"22b {feed}: {n} eval replays, want {len(val)}")
            print(f"[22b trainer eval] {feed} eval epoch, DetectorConfig() b8 bf16, "
                  f"{len(val)} val batches of phase 14's images, the first batch drawn: "
                  f"replayed ({n} replays"
                  f"{', gather form' if feed == 'resident' else ''}) = eager bit for bit: "
                  f"{replayed}")
        ckpt = latest_checkpoint(tmp / "ckpt" / "smoke")
        if ckpt is None:  # --serve alone: a checkpoint of a fresh Trainer's state
            ckpt = trainers["streamed"].save()
        args = ["--data-dir", str(root), "--model", "poolresnet", "--checkpoint", str(ckpt),
                "--patches", "10", "--with-ap", "--device", "cuda"]
        made = []

        class Kept(Trainer):  # the Trainer run_validation_epoch makes, kept for its graphs
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        start = LAUNCHES.copy()
        run_validation_epoch.Trainer = Kept
        try:
            replayed = run_validation_epoch.main(args)
        finally:
            run_validation_epoch.Trainer = Trainer
        # the batches are padded to one shape: one eval graph, after its warm-up
        calls = (LAUNCHES - start - warm_ups(*made))["decode_filter_nms"]
        rule = Trainer.__dict__["replays"]  # the staticmethod itself
        Trainer.replays = staticmethod(lambda *a: False)
        try:
            eager = run_validation_epoch.main(args)
        finally:
            Trainer.replays = rule
    finally:
        os.chdir(cwd)
    check(replayed == eager, f"22b run_validation_epoch replayed {replayed}, eager {eager}")
    n_val = math.ceil(TRAINER_IMAGES[1] / 8)
    check(calls == n_val, f"22b run_validation_epoch: K1 {calls} calls, want {n_val}")
    print(f"[22b run_validation_epoch] --with-ap on {ckpt.name}: replayed (the Trainer's "
          f"captured eval step, K1 once a batch) = eager (the replay rule off) bit for bit: "
          f"{replayed}")
    run = graph_vs_eager(GRAPH_MODELS["poolresnet-b8-480"],
                         functools.partial(make_train_step, compute_metrics=True))
    failures = graph_failures("22b metrics step", run)
    check(not failures, "; ".join(failures))
    print(f"[22b metrics step] PoolResnet-128x10 480px b8 bf16 SAM+Adam, rotation, train "
          f"metrics (K1 inside): {GRAPH_STEPS} replays = {GRAPH_STEPS} eager steps bit for bit "
          f"(losses, grad norms, iou, recall, precision, params, buffers, Adam state); kernel "
          f"launches a replay {run['per_replay']}, eager {run['eager_launches']}")
    print("[22b group] the Trainer over the world-1 NCCL group (GroupTrainer): its train, "
          "metrics and eval steps replayed (the eval's all-reduces in its graph) = eager, bit "
          "for bit: phase 17a's fits")


def profiled_line(rows: dict, what: str) -> str:
    """Each arm's :func:`profile_train.measure` row: device busy ms,
    kernels and host launch calls a ``what``."""
    return ", ".join(f"{arm} busy {r['busy_ms']:.4f} ms, idle {r['idle']:.3f} of the profiled "
                     f"window, {r['kernels']:.0f} kernels / {r['launch_calls']:.0f} host launch "
                     f"calls a {what}" for arm, r in rows.items())


def serve_latency(card, dets: dict) -> None:
    """22c: b1 ``predict`` eager body against replayed, medians of
    ``LATENCY_LOOPS`` loops of ``LATENCY_ITERS`` by CUDA events, in turns;
    then ``SERVE_PROFILED`` of each under torch.profiler."""
    from fdtpu_torch.profile_train import measure

    frame = serve_frames(SEED + 74)["u8"]
    for family in SERVE_TIMED:
        det = dets[family]
        det.predict(frame)  # captured (0.5/0.5, u8)
        arms = {"eager": lambda: eager_predict(det, frame), "replayed": lambda: det.predict(frame)}
        ms = {arm: [] for arm in arms}
        for _ in range(LATENCY_LOOPS):
            for arm, fn in arms.items():
                ms[arm].append(event_ms(fn, LATENCY_ITERS))
        prof = {arm: measure(fn, SERVE_PROFILED) for arm, fn in arms.items()}
        g = next(g for k, g in det._graphs.graphs.items() if k[0] == "predict"
                 and k[2] == torch.uint8 and k[3] == 0.5)
        print(f"[22c predict] {SP_NAMES[family]} b1 480px bf16 u8 frame (host step, H2D, /255, "
              f"forward, K1): eager {ms_line(ms['eager'])}, replayed {ms_line(ms['replayed'])}; "
              f"medians of {LATENCY_LOOPS} x {LATENCY_ITERS} in turns; under the profiler, "
              f"{SERVE_PROFILED} each: {profiled_line(prof, 'predict')}; graph pool "
              f"{g.pool_bytes / 2**20:.1f} MiB, warm-up + capture {g.capture_s:.2f} s [{card}]")


def camera_ms(det, frames, predict) -> dict:
    """``run_camera`` over a stub ``cv2`` with ``det.predict`` set to
    ``predict``: the host ms of each frame, of its ``predict`` call (to the
    card's end of it: ``run_camera`` waits there next, for the frame's
    copy to the host) and of the ``host_frame`` step (the PIL resize)
    inside that call."""
    from fdtpu_torch import demo_model

    cv2 = StubCv2(frames)
    saved = sys.modules.get("cv2")
    parts = {"predict": [], "host_frame": []}

    def timed(part, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            if part == "predict":
                torch.cuda.synchronize()
            parts[part].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    sys.modules["cv2"] = cv2
    det.predict, det.host_frame = timed("predict", predict), timed("host_frame", det.host_frame)
    try:
        demo_model.run_camera(det)
    finally:
        del det.predict, det.host_frame  # the class's methods again
        if saved is None:
            sys.modules.pop("cv2")
        else:
            sys.modules["cv2"] = saved
    torch.cuda.synchronize()
    return {"frame": [(b - a) * 1e3 for a, b in zip(cv2.read_at, cv2.read_at[1:])], **parts}


def serve_epoch_trainers(tmp) -> dict:
    """22c's Trainers: ``DetectorConfig()`` b8 bf16 over
    ``SERVE_EPOCH_IMAGES`` synthetic images, streamed and resident, no
    drawing."""
    from pathlib import Path

    root = Path(tmp) / "serve_epoch"
    make_synthetic_widerface(root, SERVE_EPOCH_IMAGES[0], split="train", seed=SEED + 76)
    make_synthetic_widerface(root, SERVE_EPOCH_IMAGES[1], split="val", seed=SEED + 77)
    trainers = {}
    for feed in ("streamed", "resident"):
        cfg = TrainConfig(seed=SEED, device_data=feed == "resident", visualize_first_batch=False,
                          checkpoint_dir=str(root / f"ckpt_{feed}"),
                          log_path=str(root / f"logs_{feed}" / "out.log"))
        train, val = trainer_loaders(root, shuffle=False)
        trainers[feed] = Trainer(trainer_module(SEED), cfg, train, val,
                                 run_name=f"serve_epoch_{feed}", device="cuda")
    return trainers


def serve_timings(card, dets, tmp) -> None:
    """22c: b1 ``predict`` (PoolResnet-128, SSD-16), the camera frame with
    its parts, and one eval epoch of ``SERVE_EPOCH_IMAGES[1]`` images
    (streamed and resident), eager against replayed, in turns; the epochs
    also under torch.profiler, one of each arm."""
    from fdtpu_torch.profile_train import measure

    serve_latency(card, dets)
    frames = camera_frames(tmp)
    det = camera_detector(frames)
    arms = {"eager": lambda img: eager_predict(det, img), "replayed": det.predict}
    ms = {arm: {"frame": [], "predict": [], "host_frame": []} for arm in arms}
    for _ in range(SERVE_TURNS):
        for arm, fn in arms.items():
            for part, v in camera_ms(det, frames, fn).items():
                ms[arm][part].append(statistics.median(v))
    (g,) = det_graphs(det)
    print(f"[22c camera] demo_model.run_camera, bf16 PoolResnet-128x10 grid 10 480px, "
          f"{CAMERA_FRAMES} VGA frames of a stub cv2, host ms a frame, median of each run, "
          f"{SERVE_TURNS} runs in turns: " + "; ".join(
              f"{arm} frame {ms_line(m['frame'])}, its predict call {ms_line(m['predict'])} (to "
              f"the card's end), in it host_frame (the PIL resize) {ms_line(m['host_frame'])}"
              for arm, m in ms.items()) + f"; graph pool {g.pool_bytes / 2**20:.1f} MiB, "
          f"warm-up + capture {g.capture_s:.2f} s [{card}]")
    for feed, t in serve_epoch_trainers(tmp).items():
        t.eval_epoch()  # the val set decoded (staged, resident) and the graphs captured
        secs = {"eager": [], "replayed": []}
        for _ in range(SERVE_TURNS):
            for arm in secs:
                t.replaying = arm == "replayed"
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.eval_epoch()
                torch.cuda.synchronize()
                secs[arm].append((time.perf_counter() - t0) * 1e3)
        prof = {}
        for arm in secs:
            t.replaying = arm == "replayed"
            prof[arm] = measure(t.eval_epoch, 1)
        t.replaying = True
        check(slot_replays(t, "eval") > 0, f"22c {feed}: no eval replay")
        graphs = t.captured["eval"].graphs.values()
        print(f"[22c eval epoch] {feed}, DetectorConfig() b8 bf16, {len(t.val_loader)} val "
              f"batches of {SERVE_EPOCH_IMAGES[1]} synthetic images, no drawing, host ms an "
              f"epoch, {SERVE_TURNS} runs in turns: eager {ms_line(secs['eager'])}, replayed "
              f"{ms_line(secs['replayed'])}; one epoch each under the profiler: "
              f"{profiled_line(prof, 'epoch')}; eval graph pools "
              f"{[round(g.pool_bytes / 2**20, 1) for g in graphs]} MiB (the Trainer's pool), "
              f"capture {[round(g.capture_s, 2) for g in graphs]} s [{card}]")


def ms_line(values) -> str:
    return f"{statistics.median(values):.3f} ({min(values):.3f}-{max(values):.3f}) ms"


def phase_serve(card, tmp) -> None:
    """22: serving and eval replayed from CUDA graphs."""
    t0 = time.perf_counter()
    start = LAUNCHES.copy()
    models = {family: serve_model(family, cfg, SEED + 75)
              for family, cfg in SERVE_MODELS.items()}
    dets = serve_predict_vs_eager(models)
    for family, cfg in SERVE_MODELS.items():
        serve_eval_vs_eager(family, cfg)
    serve_trainer_evals(tmp)
    serve_timings(card, dets, tmp)
    launches = on_path(start)["decode_filter_nms"]
    print(f"[22 serve] K1 launches {launches} (replayed, eager and warm-ups); phase 22 took "
          f"{time.perf_counter() - t0:.1f} s")


# phase 23: the narrow convolutions, (batch, size, grid)
NARROW_SHAPES = ((1, 480, 10), (2, 480, 10), (4, 480, 10), (8, 480, 10), (16, 480, 10),
                 (32, 480, 10), (1, 320, 15), (4, 320, 15), (8, 320, 15), (128, 320, 15))
NARROW_CALLS = 10  # calls of an arm in one CUDA graph


def stem_padded_to_8(layer, x):
    """The rejected candidate for the stem: its input channels zero-padded
    to 8, input and weight, through cuDNN (the added products are exact
    zeros)."""
    pad = 8 - x.shape[1]
    xp = F.pad(x.permute(0, 2, 3, 1), (0, pad)).permute(0, 3, 1, 2)
    w = F.pad(layer.weight.to(x.dtype).permute(0, 2, 3, 1), (0, pad)).permute(0, 3, 1, 2)
    return F.conv2d(xp, w, layer.bias.to(x.dtype), layer.stride, layer.padding)


def graph_ms(fn, iters: int) -> float:
    """The card's time for one call of ``fn``: :data:`NARROW_CALLS` calls
    captured in one CUDA graph (``utils/graphs.py``, which counts the
    replays' launches), its replays timed by :func:`device_ms`, so that no
    call waits for the host's launches (a b1 call of ``conv_gemm``
    launches for longer than the card runs it)."""
    device = torch.device("cuda")
    graph = ugraphs.capture(lambda: [fn() for _ in range(NARROW_CALLS)], device,
                            warm=lambda: ugraphs.warm_up(fn, device, 3))
    ms = device_ms(graph.replay, iters) / NARROW_CALLS
    del graph
    torch.cuda.empty_cache()
    return ms


def kernel_names(fn, n: int = 3) -> list:
    """The kernels ``fn`` runs, by device ms a call, longest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key[:100], round(e.self_device_time_total / n / 1e3, 5))
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def phase_narrow_convs(card) -> dict:
    """23: the stem and the head, cuDNN against ``conv_gemm``."""
    rows = []
    with torch.no_grad():
        for b, size, grid in NARROW_SHAPES:
            det = Detector(build_model("poolresnet", DetectorConfig(input_shape=(size, size),
                                                                    num_patches=grid),
                                       "cuda", torch.Generator().manual_seed(SEED)))
            net = det.net
            x = torch.rand((b, size, size, 3), device="cuda").permute(0, 3, 1, 2)
            x = x.to(torch.bfloat16)
            feat = conv(net.conv1, x)
            for block in net.residual_blocks:
                feat = block(feat)
            for name, layer, inp in (("stem", net.conv1, x), ("head", net.out, feat)):
                ref = F.conv2d(inp.float(), layer.weight.float(), layer.bias.float(),
                               layer.stride, layer.padding)
                step = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
                arms = {"cudnn": lambda: conv(layer, inp), "conv_gemm": lambda: conv_gemm(layer, inp)}
                row = {"layer": name, "shape": list(inp.shape), "bf16_step": step}
                for arm, fn in arms.items():
                    row[f"{arm}_err"] = (fn().float() - ref).abs().max().item()
                iters = 20 if b == 1 else 5
                times = {arm: [] for arm in arms}
                for order in (("cudnn", "conv_gemm", "conv_gemm", "cudnn"),) * 2:
                    for arm in order:
                        times[arm].append(graph_ms(arms[arm], iters))
                for arm in arms:
                    row[f"{arm}_ms"] = statistics.median(times[arm])
                    row[f"{arm}_ms_all"] = [round(t, 5) for t in times[arm]]
                start = LAUNCHES["conv_gemm"]
                narrow_conv(layer, inp)
                row["rule"] = "conv_gemm" if LAUNCHES["conv_gemm"] > start else "cudnn"
                if name == "stem":
                    row["padded_to_8_ms"] = graph_ms(lambda: stem_padded_to_8(layer, inp), iters)
                    row["padded_to_8_err"] = (stem_padded_to_8(layer, inp).float()
                                              - ref).abs().max().item()
                if b == 1:
                    row["kernels"] = {arm: kernel_names(fn)[:4] for arm, fn in arms.items()}
                check(row["conv_gemm_err"] <= row["cudnn_err"] + step,
                      f"{name} b{b}: conv_gemm off by {row['conv_gemm_err']}")
                rows.append(row)
                print(f"[23 narrow] {name} {tuple(inp.shape)}: cuDNN {row['cudnn_ms']:.4f} ms, "
                      f"conv_gemm {row['conv_gemm_ms']:.4f} ms, rule {row['rule']}; err "
                      f"{row['cudnn_err']:.4g} / {row['conv_gemm_err']:.4g} (bf16 step {step})")
            del det, net, x, feat
            torch.cuda.empty_cache()
    out = {"narrow_convs": {"card": card, "rows": rows}}
    print(json.dumps(out))
    return out


RF_PRIORS, RF_CAP, RF_PROB, RF_IOU = 29126, 750, 0.6, 0.4  # cfg_re50 at 840 px, detect.py's
RF_ELIGIBLE = 50  # phase 24's frame: candidates of the float32 forward over RF_PROB


def served_like(rng, b: int, n: int) -> torch.Tensor:
    """(B, N, 5) normalised prior rows with about 60 of ``n`` candidates an
    image over 0.6 (a served frame's load), boxes of 2-40% of the side."""
    v = rng.uniform(0, 1, size=(b, n, 5)).astype(np.float32)
    v[..., 0] = np.where(rng.uniform(size=(b, n)) < 150 / n, v[..., 0], np.float32(0.1))
    v[..., 3:] = 0.02 + 0.38 * v[..., 3:]
    return torch.from_numpy(v).cuda()


def phase_retinaface(card) -> dict:
    """Phase 24 (module docstring): K1 at RetinaFace's served shape, both
    ops, against the plain version; the 840 px predict's launches a
    replay."""
    n, cap = RF_PRIORS, RF_CAP
    check(n > knms.max_candidates(0), f"N={n} is not past the shared-memory limit")
    rng = np.random.default_rng(SEED + 24)
    tables = knms.ssd_output_tables_on(n, (840, 840), torch.device("cuda"))
    cases = {"served": served_like(rng, 1, n), "saturated": candidates(rng, 1, n, "saturated"),
             "tie": candidates(rng, 1, n, "tie")}
    kept = {}
    for case, vals in cases.items():
        where = f"B=1 N={n} cap={cap} {case} {RF_PROB}/{RF_IOU}"
        scratch = LAUNCHES["decode_filter_nms_scratch"]
        poison(((1, cap, 5), torch.float32), ((1, cap), torch.bool), ((1, cap), torch.int32))
        gb, gm, gi = knms.decode_filter_nms_batch(vals, tables, RF_PROB, RF_IOU, cap, indexed=True)
        poison(((1, cap, 5), torch.float32), ((1, cap), torch.bool))
        pb, pm = knms.decode_filter_nms_batch(vals, tables, RF_PROB, RF_IOU, cap)
        wb, wm, wi = knms.decode_filter_nms_reference(vals, tables, RF_PROB, RF_IOU, cap,
                                                      indexed=True)
        torch.cuda.synchronize()
        check(LAUNCHES["decode_filter_nms_scratch"] == scratch + 2,
              f"not two scratch launches at {where}")
        check(torch.equal(gm, wm) and torch.equal(gb, wb), f"indexed op differs at {where}")
        check(torch.equal(gi, wi), f"index differs at {where}")
        check(torch.equal(pm, wm) and torch.equal(pb, wb), f"plain op differs at {where}")
        k = int(gm.sum())
        check(bool((gi[0, :k] >= 0).all()) and bool((gi[0, k:] == -1).all()),
              f"index not -1 past the kept rows at {where}")
        kept[case] = k
    check(kept["saturated"] == cap, f"not saturated: {kept['saturated']} kept")

    cfg = RetinaFaceConfig()
    module = build_model("retinaface", cfg, "cuda", torch.Generator().manual_seed(SEED)).eval()
    frame = np.random.default_rng(SEED + 25).integers(0, 256, size=(840, 840, 3), dtype=np.uint8)
    with torch.inference_mode():
        rows = module(torch.from_numpy(frame).cuda().float()[None] / 255.0)
        # the threshold halfway between the RF_ELIGIBLE-th score and the next
        edge = torch.logit(rows[0, :, 0].double().topk(RF_ELIGIBLE + 1).values[-2:], eps=1e-12)
        shift = math.log(RF_PROB / (1 - RF_PROB)) - float(edge.mean())
        for head in module.ClassHead:  # channel 2a + 1: anchor a's face logit
            head.conv1x1.bias[1::2] += shift
    det = Detector(module, cfg.probability_threshold, cfg.iou_threshold, cfg.nms_capacity,
                   DTYPES[cfg.dtype])
    path_start = LAUNCHES.copy()  # the path: the predicts, the capture's warm-up included
    det.predict(frame)  # the capture, after its warm-up (real launches)
    (g,) = det._graphs.graphs.values()
    keys = ("decode_filter_nms", "decode_filter_nms_scratch")
    start, replays = LAUNCHES.copy(), g.replays
    preds = [det.predict(frame) for _ in range(3)]
    torch.cuda.synchronize()
    replays = g.replays - replays
    per = {key: g.per_replay[key] for key in keys}
    # what the replays do not account for ran eagerly
    launched = LAUNCHES - start
    eager = tuple(launched[key] - replays * per[key] for key in keys)
    check(replays == len(preds), f"{replays} replays of {len(preds)} predicts")
    check(per == {"decode_filter_nms": 1, "decode_filter_nms_scratch": 1},
          f"predict's launches a replay {per}")
    check(eager == (0, 0), f"eager K1 launches during the replays {eager}")
    path = on_path(path_start)
    norm, boxes, mask = preds[0]
    points = preds[0].landmarks
    k = int(check_boxes(boxes, mask, cap, cfg.probability_threshold, "retinaface predict"))
    check(norm.shape == (840, 840, 3) and points.shape == (cap, 10), "retinaface predict shapes")
    check(bool(torch.isfinite(points).all()) and bool((points[k:] == 0).all()),
          "landmarks not zero past the kept rows")
    check(all(torch.equal(a, b) for p in preds[1:] for a, b in zip((*p, p.landmarks),
                                                                  (*preds[0], points))),
          "replays answer differently")
    check(0 < k < cap, f"predict kept {k} of {cap}")
    out = {"shape": [1, n, cap], "thresholds": [RF_PROB, RF_IOU], "kept": kept,
           "predict_kept": k, "per_replay": per,
           "launches": path["decode_filter_nms"]}
    print(f"[24 retinaface] K1 at B=1 N={n} cap={cap} {RF_PROB}/{RF_IOU} on global scratch "
          f"(limit {knms.max_candidates(0)}): plain and indexed op bit-equal to the plain "
          f"version, index too, on {', '.join(f'{c} ({v} kept)' for c, v in kept.items())}; "
          f"840 px bf16 predict: {k} kept with landmarks, a replay launches K1 "
          f"{per['decode_filter_nms']:g} and its scratch path "
          f"{per['decode_filter_nms_scratch']:g} times, no eager launch [{card}]")
    print(json.dumps({"retinaface": out}))
    return out


BN_ACT_TURNS = 2  # (chain, kernel, kernel, chain) rounds a chain's timing


def served_bn_act_calls(det) -> list[tuple]:
    """``(shape, act, skip)`` of each ``layers.bn_act`` call of ``det``'s
    forward at its input size, in call order."""
    calls, real = [], layers.fused_bn_act

    def record(y, *args):  # weight, bias, mean, var, eps, act, skip
        calls.append((tuple(y.shape), args[5], args[6] is not None))
        return real(y, *args)

    layers.fused_bn_act = record
    try:
        det.apply(torch.rand((1, *det.module.input_shape, 3), device="cuda"))
    finally:
        layers.fused_bn_act = real
    return calls


def bn_act_operands(shape, with_skip: bool, gen) -> tuple:
    """Random bf16 channels_last operands of one chain: y, skip (or None)
    and the BatchNorm's four float32 vectors, off the identity."""
    n, c, h, w = shape

    def act():
        return (torch.randn((n, h, w, c), generator=gen, device="cuda") * 2).to(
            torch.bfloat16).permute(0, 3, 1, 2)

    params = (torch.randn(c, generator=gen, device="cuda") * 1.5,
              torch.randn(c, generator=gen, device="cuda"),
              torch.randn(c, generator=gen, device="cuda"),
              10.0 ** (torch.rand(c, generator=gen, device="cuda") * 4 - 2))
    return act(), act() if with_skip else None, params


def phase_bn_act(card) -> dict:
    """Phase 25 (module docstring): the fused BatchNorm epilogue at the
    served chains, against the eager chain, and the predict graph with
    and without it."""
    cfg = RetinaFaceConfig()
    module = build_model("retinaface", cfg, "cuda", torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 25)
    with torch.no_grad():  # every BatchNorm off the identity, mildly (finite activations)
        for m in module.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(c, generator=gen))
    det = Detector(module, cfg.probability_threshold, cfg.iou_threshold, cfg.nms_capacity,
                   DTYPES[cfg.dtype])
    calls = served_bn_act_calls(det)
    check(len(calls) == 73, f"{len(calls)} bn_act calls a forward, not 73")
    rows, frame = [], {"kernel_ms": 0.0, "eager_ms": 0.0, "bound_ms": 0.0}
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED)
    for key in sorted(set(calls), key=str):
        shape, act, with_skip = key
        count = calls.count(key)
        y, skip, params = bn_act_operands(shape, with_skip, cuda_gen)
        with torch.inference_mode():
            got = kbn.fused_bn_act(y, *params, 1e-5, act, skip)
            want = kbn.reference_bn_act(y, *params, 1e-5, act, skip)
        torch.cuda.synchronize()
        check(torch.equal(got.contiguous().view(torch.int16), want.contiguous().view(torch.int16)),
              f"bn_act {key} differs from the eager chain")
        arms = {"eager": lambda: kbn.reference_bn_act(y, *params, 1e-5, act, skip),
                "kernel": lambda: kbn.fused_bn_act(y, *params, 1e-5, act, skip)}
        times = {arm: [] for arm in arms}
        with torch.inference_mode():
            for _ in range(BN_ACT_TURNS):
                for arm in ("eager", "kernel", "kernel", "eager"):
                    times[arm].append(graph_ms(arms[arm], 20))
        moved = y.numel() * 2 * (3 if with_skip else 2)
        row = {"shape": list(shape), "act": act, "skip": with_skip, "calls_a_frame": count,
               **{f"{arm}_ms": statistics.median(t) for arm, t in times.items()},
               "bound_ms": moved / HBM_BYTES_PER_MS}
        row["roofline_pct"] = 100 * row["bound_ms"] / row["kernel_ms"]
        for k in frame:
            frame[k] += count * row[k]
        rows.append(row)
        print(f"[25 bn_act] {shape} act={act} skip={with_skip} x{count}: "
              f"kernel {row['kernel_ms']:.5f} ms ({row['roofline_pct']:.0f}% of "
              f"{row['bound_ms']:.5f}), eager chain {row['eager_ms']:.5f} ms, bit-equal")
        del y, skip, params, got, want
    frame_img = np.random.default_rng(SEED + 25).integers(0, 256, size=(840, 840, 3),
                                                           dtype=np.uint8)
    pred_on = det.predict(frame_img)
    (g_on,) = det._graphs.graphs.values()
    real = layers.fused_bn_act
    layers.fused_bn_act = kbn.reference_bn_act  # the eager chain on the card
    try:
        off = Detector(module, cfg.probability_threshold, cfg.iou_threshold, cfg.nms_capacity,
                       DTYPES[cfg.dtype])
        pred_off = off.predict(frame_img)
    finally:
        layers.fused_bn_act = real
    (g_off,) = off._graphs.graphs.values()
    check((g_on.per_replay["bn_act"], g_off.per_replay["bn_act"]) == (73, 0),
          f"bn_act a replay: {g_on.per_replay['bn_act']} on, {g_off.per_replay['bn_act']} off")
    check(all(torch.equal(a, b) for a, b in zip((*pred_on, pred_on.landmarks),
                                                (*pred_off, pred_off.landmarks))),
          "predict differs with the epilogue")
    graph_times = {"on": [], "off": []}
    for arm in ("off", "on", "on", "off") * 2:
        graph_times[arm].append(device_ms((g_on if arm == "on" else g_off).replay, 50))
    out = {"card": card, "chains": rows, "frame": frame, "calls_a_frame": len(calls),
           "per_replay": g_on.per_replay["bn_act"],
           "predict_graph_ms": {arm: statistics.median(t) for arm, t in graph_times.items()},
           "predict_graph_ms_all": graph_times}
    print(f"[25 bn_act] a frame's 73 chains: kernel {frame['kernel_ms']:.4f} ms against "
          f"{frame['bound_ms']:.4f} bound, eager chain {frame['eager_ms']:.4f} ms; predict "
          f"graph {out['predict_graph_ms']['on']:.4f} ms with the epilogue, "
          f"{out['predict_graph_ms']['off']:.4f} without, same answers [{card}]")
    print(json.dumps({"bn_act": out}))
    return out


def bn_act_entry(out: dict) -> dict:
    """The ``kernels`` line's ``bn_act`` entry from phase 25's result: the
    launches a predict replay, error 0 (phase 25 checks each chain bit for
    bit), a frame's kernel time, eager chain and bytes bound, the chains
    under ``shapes``."""
    frame = out["frame"]
    return {**BN_ACT, "launches": out["per_replay"], "max_abs_err": 0.0,
            "ms": frame["kernel_ms"], "plain_ms": frame["eager_ms"],
            "bound_ms": frame["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "shapes": out["chains"]}


def bn_act_only() -> None:
    """``--bn-act``: the card, the build and phase 25 alone, then a
    ``kernels`` line with the ``bn_act`` entry."""
    card, _ = phase_card()
    phase_build()
    print(json.dumps({"kernels": [bn_act_entry(phase_bn_act(card))]}))


def retinaface_only() -> None:
    """``--retinaface``: the card, the build and phase 24 alone."""
    card, _ = phase_card()
    phase_build()
    phase_retinaface(card)


def stem_only() -> None:
    """``--stem``: the card and phase 23 alone."""
    card, _ = phase_card()
    phase_narrow_convs(card)


def graph_only() -> None:
    """``--graph``: the card, the build and phase 21 alone, with 21c's
    timings."""
    card, _ = phase_card()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        phase_graph(card, tmp, timings=True)


def deployment_only() -> None:
    """``--deployment``: the card, the build and phase 18 alone."""
    card, _ = phase_card()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        phase_deploy(card, tmp)


def spatial_only() -> None:
    """``--spatial``: the card, the build and phase 19 alone."""
    card, _ = phase_card()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        phase_spatial(card, tmp)


def entry_only() -> None:
    """``--entry``: the card, the build and phase 20 alone."""
    card, _ = phase_card()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        phase_entry(card, tmp)


def serve_only() -> None:
    """``--serve``: the card, the build and phase 22 alone."""
    card, _ = phase_card()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        phase_serve(card, tmp)


def main() -> None:
    card, name = phase_card()
    phase_build()
    worst = phase_kernel_vs_plain()
    phase_forward_f32()
    det480, det320, batch = phase_main_path()
    nms_rows = phase_timings(card, det480, det320, batch)
    rot_worst = phase_rotate_vs_plain()
    phase_train_f32()
    runs = phase_train_path()
    shear_rows = phase_train_timings(card, runs)
    del runs
    photo_worst = phase_photometric_vs_plain()
    phase_tail_vs_plain()
    phase_tail_path()
    train = phase_photometric_path()
    fused_times = phase_fused_timings(card, train)
    del train
    with tempfile.TemporaryDirectory() as tmp:
        phase_trainer(tmp)
        ssd_rows = phase_ssd(card, tmp)
        phase_zoo(card, tmp)
        phase_dp(card, tmp)
        phase_deploy(card, tmp)
        phase_spatial(card, tmp)
        phase_entry(card, tmp)
        phase_graph(card, tmp)
        phase_serve(card, tmp)
    phase_narrow_convs(card)
    phase_retinaface(card)
    bn_act = phase_bn_act(card)
    k1_recorded_map_bounds()

    def entry(meta, launches, err, times, library_ms=None):
        ms, plain, bnd = times
        return {**meta, "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                **bnd, "library_ms": library_ms}

    def row_times(row):
        return row["ms"], row["plain_ms"], {k: row[k] for k in ("bound_ms", "bound_by")}

    # K1 at b128/225 and the shears on the b128 exact-k planes head their
    # entries; every shape timed follows under "shapes"
    # (library_ms: F.grid_sample on the float32 rows only, see shear_times);
    # the launches are the paths'
    kernels = [{**entry(KERNEL, PATH_LAUNCHES["decode_filter_nms"], worst,
                        row_times(nms_rows[0])), "shapes": nms_rows + ssd_rows}]
    shear_launches = {k: PATH_LAUNCHES[k] for k in SHEARS}
    shear_launches["shear_rows"] -= shear_launches["shear_rows_stacked"]  # K3a's alone
    for kname, meta in SHEARS.items():
        rows = [r for r in shear_rows if r["name"].split(",")[0] == kname]
        kernels.append({**entry({"name": kname, **meta}, shear_launches[kname], rot_worst[kname],
                                row_times(rows[0]), rows[0]["library_ms"]), "shapes": rows})
    kernels.append(entry(PHOTOMETRIC, PATH_LAUNCHES["photometric"], photo_worst,
                         fused_times["photometric"]))
    kernels.append({**entry(RESIDUAL_TAIL, PATH_LAUNCHES["residual_tail"], 0.0,
                            fused_times["residual_tail"]),
                    "shapes": fused_times["residual_tail_shapes"]})
    kernels.append(bn_act_entry(bn_act))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--deployment"]:
        deployment_only()
    elif sys.argv[1:] == ["--spatial"]:
        spatial_only()
    elif sys.argv[1:] == ["--entry"]:
        entry_only()
    elif sys.argv[1:] == ["--graph"]:
        graph_only()
    elif sys.argv[1:] == ["--serve"]:
        serve_only()
    elif sys.argv[1:] == ["--stem"]:
        stem_only()
    elif sys.argv[1:] == ["--retinaface"]:
        retinaface_only()
    elif sys.argv[1:] == ["--bn-act"]:
        bn_act_only()
    else:
        main()
