#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``deepvision_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` with nvJPEG and a host C++ compiler; exits
non-zero without them, and in a directory that does not hold the port.
It drives the port's main paths, serving and training AlexNet V1,
Inception V1 (``inception1_ref``, whose stem LRNs have the wide windows
n=64 and n=192, and the BN variant ``inception1``), the ResNets
(``resnet50``, the training side's north star, then ``resnet34`` and
``resnet50v2``, none of which reaches an LRN), ``resnet50`` trained from
ImageNet TFRecords over the uint8 wire (raw-crop and JPEG shards, the
JPEGs decoded on the card) with the augmentation in the step,
``resnet152`` under its block rematerialization, YOLO v3 (``yolov3``
on Darknet-53) served, trained from detection TFRecords, evaluated and
post-processed by the NMS sweep kernel, the hourglass models,
CenterNet (``centernet``) and Hourglass-104 pose (``hourglass104``),
served, trained from records and evaluated, and the GANs, DCGAN
(``dcgan``, its generator served) and CycleGAN (``cyclegan``, trained
from unpaired records), trained, served and scored, and the last five
classifiers, VGG-16 and -19, MobileNet V1 (RMSprop, depthwise
convolutions), ShuffleNet V1 (grouped convolutions, SAME stride-2 pads)
and Inception V3 at 299, and the resilient training run (recovery, fault
injection, the sentinel, preemption, the spawned loader, tracing); it
holds every kernel on them against its plain version.
Phases, each of which raises on failure (nothing is caught) and prints
the seconds it took:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   and the float32 policy (TF32 off for cuDNN and cuBLAS); then the
   probe: whether the toolkit holds ``nvjpeg.h`` and ``libnvjpeg`` and
   the host a C++ compiler;
2. build: ``csrc/lrn.cu`` (forward), ``csrc/lrn_bwd.cu`` (backward) and
   ``csrc/nvjpeg.cu`` (the nvJPEG binding and the ``ycc_to_rgb``
   kernel, linked with ``-lnvjpeg``) with ``nvcc`` for ``sm_90a``, and
   ``csrc/crc32c.cpp`` with the host's C++ compiler, from the sources in
   this checkout, all at once, with ptxas's report;
3. kernels vs plain versions on the card, forward and backward, at every
   LRN shape of the model zoo (AlexNet V1 at the training batch of 128
   and the serving batch of 64, and V2-TF, with n=5, k=2; the Inception
   V1 stem with n=64 and n=192, k=1, at the training batch of 128 and at
   8), odd channel counts, row counts that leave a ragged last tile, the
   widest C, and narrow odd and even windows on the prefix-sum path
   (n=3, 4 and 6): f32 to atol 1e-5 and rtol 1e-5, bf16 to atol 1e-2
   and one bf16 step (rtol 2^-7) against the plain version run in bf16;
   the backward's incoming gradient is N(0, 1) from a seed. A base
   pointer off 16 bytes (the forward's x, the backward's g) is refused
   with no launch counted;
4. times, with CUDA events (``deepvision_tpu_torch/timing.py``: median of
   100 runs after 10 of warm-up, 5 after 1 for the plain versions and
   library calls, the stream held busy while the host
   queues them), of each kernel, its plain version and the library call
   (``F.local_response_norm``, and for the backward only the autograd
   backward of it) at AlexNet V1's two LRNs and Inception V1's two stem
   LRNs at the training batch of 128, and the Inception stem's shapes at
   batch 64 (n=64 on C=64, n=192 and n=5 on C=192), beside the least
   time the card could take. "Cold" rotates over distinct buffers, at
   least 100 MB of inputs, so that each call misses the 50 MB L2; "warm"
   calls on one buffer. Beside each kernel, what the card reaches in
   practice on the same bytes: a copy for the forward (one read, one
   write), ``torch.add(x, g)`` for the backward (two reads, one write);
5. serve: ``load_served`` of AlexNet V1, later of ``inception1_ref``, at
   224x224x3 and 1000 classes with seeded weights, an
   ``InferenceEngine`` on buckets (1, 4, 16, 64) whose runners are CUDA
   graphs, one a bucket, captured at its warm-up (the runner cache
   frozen after it), 96 seeded requests held against the same module
   run with the plain LRN (probabilities within 1e-4), 2 LRN launches
   per batch (a replay); then two different bucket-16 batches, a
   bucket-4 one and two bucket-1 ones, each answered bit for bit as the
   eager forward (``ServedModel.run``) answers the same batch at the
   same bucket, the two of one bucket differently; the warm-up's
   seconds, the cache's misses before and after the traffic (equal) and
   hits, the graph pool's bytes, each bucket's kernel launches a replay
   and the memory reserved after the engine's close; the eager answers
   are computed before the launch counts are zeroed, so that the counts
   read after the traffic are the engine's alone. Then ``torch.profiler``
   windows over one bucket-64 batch on a graph captured after the close
   (AlexNet V1 also eager, the forward before the graphs), whose traced
   replay must run the port's kernels exactly as often as the launches
   that each replay credits to the counts: device time, launches, the
   LRN's and the reduction and elementwise kernels' shares, the top
   kernels, the idle share, the host wall a call; every other served
   phase below holds its engine's answers to the eager forward and
   reports its graphs the same way;
6. the serving CLI, ``python -m deepvision_tpu_torch.serve``, answering
   like the engine (AlexNet V1; it runs beside the training CLIs of 9),
   its last line counting the LRN kernel's true launches (each
   capture's eager forward, two a replay);
7. a train step on the card, kernel vs plain: AlexNet V1, later
   ``inception1_ref`` (aux heads on at 0.3), at full width, batch 128,
   seeded weights, float32 with TF32 off, dropout off, 3 steps with the
   kernels and 3 with the plain forward, which autograd differentiates
   (independent of the analytic backward): loss within rtol 1e-4 and
   every parameter within atol 1e-5, with the gap measured beside the
   gap between two plain runs (cuDNN's backward is not deterministic);
   2 forward and 2 backward LRN launches a step;
8. train: the port's ``Trainer`` at full width in the config's bf16
   policy and batch, the model built with the config's ``model_kwargs``,
   one epoch of 2 steps on a synthetic set of 3 batches (one held out),
   counting the LRN launches: AlexNet V1, ``inception1_ref`` and
   ``inception1`` (no LRN; every BN statistic moved);
9. the training CLI at full width, ``python -m deepvision_tpu_torch.train
   -m alexnet1 --synthetic-size 384 --steps-per-epoch 2 --epochs 2`` (at
   the config's batch, bf16), then ``--resume --epochs 3`` from its
   checkpoints, then ``load_served`` from the newest one; the same for
   ``inception1_ref`` (its n=64 and n=192 LRN kernels launched there),
   ``inception1`` and ``resnet50``, whose running statistics must have
   moved and come back bit for bit from a restore, with the LR
   schedule's update count; the four models' CLIs run at once, after 11;
10. training throughput at the config's batch in bf16 over 4 timed
   steps after warm-up, through the device feed
   and on a
   device-resident batch, with the peak of allocated memory and the
   model FLOP utilization (convolution and matmul FLOPs from their
   shapes, the backward counted twice, over the step time and the
   dense bf16 peak), and ``torch.profiler`` windows over one step, with
   the kernel that runs just before each ``lrn_backward_*`` launch (a
   copy there is the ``g.contiguous()`` of ``ops/lrn.py``'s backward):
   AlexNet V1, ``inception1_ref`` and ``inception1``;
11. the ResNets, with no LRN launch on any of their paths: ``resnet50``
   served as in 5, its first 8 answers held against the same weights
   run on this machine's CPU (probabilities within 1e-4); one float32
   train step at batch 8 (TF32 off) on the card against the CPU, each
   parameter and BN statistic within 1e-5 plus three times its floor,
   the largest gap that two runs on a reordered batch give on either
   platform (each flips its own ReLUs near 0), and two faults planted
   on the card (the state before the step, the step at 0.9 times the
   LR) shown to fail it; the Trainer (8) at
   batch 256 with all 106 BN statistic tensors moved; throughput (10);
   the training CLI (9), whose model carries the config's
   ``s2d_stem`` (flax's stock BN on the stem) while the served one is
   built without it; then ``resnet34`` and ``resnet50v2`` trained for
   one epoch (8) and served one bucket-64 batch by its CUDA graph
   (``compile_for(64)``), bit for bit the eager forward's.

12. the native pieces of the ImageNet reader (after phase 4): the
   compiled CRC32C against its plain twin on buffers of 0-64 bytes at
   every offset and its MB/s; nvJPEG's decode of the committed fixtures
   (``tests/data/``) against ``tf.io.decode_jpeg``'s pixels and the
   decode stage against the JAX reader's evaluation output, within
   stated bounds (``NVJPEG_*``); ``ycc_to_rgb`` against its plain
   version, exactly, and its time beside its bound; the decode of 256
   ImageNet-sized JPEGs in images/s (nvJPEG's ``gpu_hybrid`` decoder);
13. the record path (after 11): synthetic ``raw-train-*``, ``train-*``
   and ``validation-*`` shards written on the card (JPEGs by nvJPEG's
   encoder), the host reader's records/s, ``resnet50``'s bf16 step at
   batch 256 fed by the reader for ``--raw --device-aug --mixup 0.2``,
   ``--raw`` and ``--no-raw --device-aug`` beside the same step on a
   device-resident batch, with the feed's bytes an image and waits and
   the idle share, validation over the JPEG shards (before 9's training
   CLIs); beside those CLIs the training CLI of each, one epoch with
   validation and a checkpoint and a resume, the three at once, each
   CLI's ``ycc_to_rgb`` launches read from its own last line (the
   kernels line's count for that kernel);
14. ``resnet152`` under ``remat="block"``: the Trainer at batch 256 in
   bf16, images/s with MFU and peak memory, peak memory and step time
   at batch 128 under no remat, ``"block"`` and ``"conv"``, a float32
   rematerialized step against the plain one (BN statistics bit for
   bit), one served batch.

15. YOLO v3 (``phase_yolo``, last): ``yolov3`` served at 416x416x3 and
   20 classes with seeded weights in float32 behind an
   ``InferenceEngine`` on buckets (1, 4, 16, 64), 32 queued requests and
   4 single ones, each answer identical to the same batch post-processed
   with the plain NMS sweep, with a profile of a bucket-64 batch; the NMS
   sweep kernel (``csrc/nms.cu``) against its plain version (alive masks
   identical) and ``batched_nms`` on the card against the CPU's (every
   output identical) on ``yolov3``'s candidates at buckets 64 and 16,
   N < K, planted equal scores (trap C17) and near-threshold pairs (trap
   C18), at score thresholds 0.5 and 0.05, and its time beside its bound,
   its plain version and ``yolo_postprocess`` whole; ``encode_labels``
   on the card against the CPU with a planted collision (trap C16); a
   skipped ``bf16_scaled`` Adam step with no host sync (trap C10); an
   f32 step, card against CPU, at batch 4 and 128 px with two planted
   faults; then detection records written on the card (256 train, 64
   val, nvJPEG), the fed and device-resident step at 416 and batch 16 in
   bf16 (images/s, MFU, peak memory, idle), and the training CLI
   (``--data-dir --device-aug``, 1 epoch, ``--resume`` to 2), the
   serving CLI and the ``eval detection`` CLI from its checkpoint, whose
   mAP line is printed and not gated (these CLIs run in phase 19). No
   YOLO path launches an LRN kernel.
16. CenterNet and Hourglass-104 (``phase_centernet``, ``phase_pose``,
   after 15), neither of which launches an LRN or NMS kernel: each
   served at 256x256x3 with seeded weights in float32 behind an
   ``InferenceEngine`` on buckets (1, 4, 16, 64), 32 queued requests and
   4 single ones, the first 8 answers held against this machine's CPU
   (CenterNet: kept scores within 1e-4, classes and boxes at every rank
   whose score is 2e-4 from its neighbours'; pose: each joint's cell
   holding the CPU heatmap's peak within 1e-4 of the maps' scale), with
   a profile of a bucket-64 batch (and CenterNet's peak decode timed on
   its heads); CenterNet's targets (planted shared centres and padding,
   trap C19) and peak decode (planted ties, trap C20) on the card
   against the CPU; a float32 step of each (the config's Adam, batch 4;
   CenterNet at 128 px, the hourglass at 256) on the card against the
   CPU under the YOLO step's rule, with the same two planted faults;
   the hourglass's ``"stack"`` remat step against the plain one, bit for
   bit (trap C11), and a skipped ``bf16_scaled`` step under
   ``set_sync_debug_mode("error")``; then records written on the card
   (detection with 80 classes, and pose in the builder's schema), the
   fed and device-resident step at 256 and batch 16 in each config's
   precision (images/s, MFU, peak memory, idle, launches), and the
   training CLI (``--data-dir --device-aug``, 1 epoch, ``--resume`` to
   2), the serving CLI and ``eval detection -m centernet`` and ``eval
   pose`` from its checkpoint (mAP and PCK printed, not gated; phase 19).
17. The GANs (``phase_gan``, after 16), neither of which launches an
   LRN or NMS kernel: the DCGAN generator served (``dcgan_generator``,
   seeded weights, float32 with TF32 off) behind an ``InferenceEngine``
   on buckets (1, 4, 16, 64), 32 queued noise vectors and 4 single ones,
   the first 8 answers and the singles within 1e-4 of this machine's
   CPU, with a profile of a bucket-64 batch; a float32 DCGAN step (full
   width, batch 32) and a CycleGAN step (``n_blocks=2``, 64 px, batch 4)
   on the card against the CPU from one state with the same noise,
   dropout masks and pool draws, under the card-vs-CPU rule of 11 and 15
   (the pools, which hold the fakes in batch order, within 1e-4), with
   the same two planted faults; a skipped ``bf16_scaled`` CycleGAN step
   at full width under ``set_sync_debug_mode("error")`` (every net,
   both Adams' moments and counts, the schedule's count, every BN
   statistic and both pools unchanged, the scale halved); ``--gan``
   records written on the card and the fed and device-resident bf16
   steps of ``cyclegan`` (9 blocks, 256 px, batch 4, the crop and flip in
   the step) and ``dcgan`` (batch 256): images/s, MFU from the port's
   modules' FLOPs, idle share, launches and device time a step, peak
   memory.
18. The five classifiers (``phase_classifiers``, after 17), none of
   which launches an LRN or NMS kernel: ``vgg16``, ``vgg19``,
   ``mobilenet1``, ``shufflenet1`` (224 px) and ``inception3`` (299 px),
   1000 classes, seeded weights (BN statistics set from one batch of
   the requests, as a trained model's), each served in float32 (TF32 off)
   behind an ``InferenceEngine`` on buckets (1, 4, 16, 64), 64 queued
   requests and 4 single ones, the first 4 answers' top-5 and logits
   within 1e-4 of this machine's CPU (logits 1e-4 of their scale), with
   a profile of the bucket-64 batch; each Trainer's bf16 step at the
   config's batch (128, 64, 128, 256, 128) on a device-resident batch, 2
   warm-up steps and 4 timed (images/s, MFU, peak memory), with a
   profile of one step (device time, launches, the top 5 kernels, idle
   share); the float32 steps of ``mobilenet1`` and ``shufflenet1`` at
   batch 8, card against CPU under the rule and planted faults of 11; a
   skipped ``bf16_scaled`` ``mobilenet1`` step under
   ``set_sync_debug_mode("error")`` (parameters, BN statistics, RMSprop's
   ``nu`` and update count unchanged bit for bit, the scale halved).
19. The CLI chains of 15-18 at once, one process chain each: ``yolov3``,
   ``centernet`` and ``hourglass104`` as above; ``train -m dcgan`` (512
   synthetic digits, 2 steps an epoch) and ``train -m cyclegan
   --data-dir --device-aug`` (2 steps an epoch at 256 px), 1 epoch each
   then ``--resume`` to 2, and ``eval gan -m dcgan`` and ``-m cyclegan``
   (scores printed, not gated); ``train -m mobilenet1`` as the training
   CLIs of 9 (2 epochs, ``--resume`` to 3, the update count and BN
   statistics restored bit for bit). The serving CLIs of ``yolov3``,
   ``hourglass104``, the DCGAN generator and ``mobilenet1`` are one
   process over the four chains' checkpoints (``-m`` repeated) and 24's
   converted ``inception1_ref`` (``-m``) with its ``predict export``
   artifact (``--artifact``), started once the four chains have trained
   and the converters have offered theirs (each offers its checkpoint
   through a future, :func:`_chain`, and goes on to its eval and predict
   CLIs), ``centernet``'s (the longest chain) its own once it has
   trained, 2 requests a model;
   their runners show one NMS launch a replay for ``yolov3``, two LRN
   launches for ``inception1_ref`` and its artifact (one runner, at the
   exported batch 1) and none for the others; the artifact's top-5 are
   those of ``-m``, its probabilities within 1e-4. Each
   chain but ``centernet``'s ends in a ``predict`` CLI from its
   checkpoint, on a JPEG encoded by nvJPEG or a PNG written by the
   port's writer (``detect -m yolov3`` at 416, ``pose`` at 256,
   ``dcgan -n 16``, ``cyclegan`` at 256, ``classify -m mobilenet1``),
   whose answer must be ``load_served(...).run``'s (or ``gen_a2b``'s) on
   the same decoded tensor in this process: top-k equal, boxes, joints
   and pixels within 1e-4.
20. The resilient run (``phase_resilience``, beside 19's chains):
   ``alexnet1`` at full width (224 px, 1000 classes, batch 128, bf16)
   through three training CLIs at once. Chaos: 2 epochs over 13's JPEG
   shards with
   ``--device-aug --loader-workers 2``, ``--recover --faults
   CHAOS_FAULTS`` (a garbled checkpoint, two transient reads, a NaN
   batch, a SIGKILLed loader worker), ``--sentinel --async-checkpoint
   --keep-best --stall-timeout``, ``--trace`` and ``--profile-steps``:
   the ``[recovery]`` line's one rollback, one checkpoint fallback and
   two data retries, one worker respawned, both LRN kernels launched on
   its steps (rolled back and resumed ones included; the ``kernels``
   line counts them under ``chaos_cli_bf16``), the spans' coverage of
   its epochs at least 95% and the profiler window's trace holding the
   card's kernels. SDC: ``--sentinel --recover --faults
   sdc_grad@SDC_STEP:SDC_SCALE`` trips the sentinel and rolls back.
   Preemption: SIGTERM after the first step line (exit 143, a mid-epoch
   save), then ``--resume`` goes on at the next step and ends at the
   uninterrupted twin's step count with its losses within 5%.
21. The loader (``phase_loader``, last, alone on the card):
   ``resnet50``'s bf16 step at batch 256
   fed from the JPEG shards by one reader process and by four spawned
   ones: the seconds to the first batch, images/s over the next steps,
   the waits and the path of the workers' batches, beside the card.
22. The dataset builders on this machine, which has no PIL or
   TensorFlow (``phase_builders``, after 12, alone): a flattened
   ImageNet tree of 256 + 192 JPEGs encoded by nvJPEG, with one
   grayscale JPEG (written without PIL, ``_gray_jpeg``) and one PNG under
   a ``.JPEG`` name, a bounding-box XML tree and its CSV, a VOC tree and
   an MPII JSON; the ImageNet train shards by this process (the two odd
   files re-encoded at quality 95 by the encoder that wrote the trees at
   90) and the validation shards by a spawned pool of 2, records/s each;
   both splits read back by the port's readers in one decode each (258
   and 192 images) with their labels and sizes, the odd files RGB JPEGs
   within 2 steps of their pixels on average; then, beside 9's training
   CLIs (``phase_builder_shards``), the VOC, MPII and raw-crop shards at
   once (pools of 2; nvJPEG and the resize on the card for the raw
   crops), every record read back with its label and size.
23. ``eval classification`` (after 22's second half, beside 9's
   training CLIs) of ``resnet50`` at 224, batch 64, float32 (TF32 off)
   over 22's validation shards, on seeded weights saved as a port
   checkpoint: its top-1 and top-5 equal to a direct loop of
   ``classification_eval_step`` over the same batches.
24. The converters (beside 19's chains): a seeded reference-layout
   ``resnet50`` and ``inception1_ref`` (``tests/torch_reference_nets.py``)
   saved with ``torch.save``, converted by ``python -m
   deepvision_tpu_torch.convert`` and classified by ``predict
   classify``: the top-5 the source module's on the card, the converted
   module's logits within 1e-4 of the source's; the ``inception1_ref``
   CLI's ``lrn_forward_f32`` launches counted in the ``kernels`` line;
   then ``predict export`` of the converted ``inception1_ref`` through
   its entry point in this process (no process of its own), a batch-1
   float32 artifact holding its 2 ``deepvision.lrn_forward`` nodes,
   offered to 19's serving CLI of the four chains.

25. The HTTP server (``phase_http``, beside 19's chains): ``python
   -m deepvision_tpu_torch.serve -m alexnet1 -m yolov3 --http 0
   --port-file F --faults crash@2 --buckets 1,4`` as a process, seeded
   weights; requests one at a time over HTTP (JSON lists and base64):
   the ``alexnet1`` answers bit for bit the in-process engine's of 5 at
   bucket 1, the ``yolov3`` ones those of 15's engine (boxes and scores
   within 1e-4), the crashed third batch 500, ``/healthz`` 503 with
   ``Retry-After`` during the supervisor's backoff and then 200, 400
   and 404 where due, ``/stats`` with one crash, one restart and the
   cache's 4 misses frozen, ``/metrics`` with the crash counter and the
   device memory gauges, exit 0 on SIGINT, and its last line's true
   launches of the LRN and NMS kernels. With ``--trace-spool DIR
   --obs-role http --profile-dir DIR``: the spool holds the batches'
   ``device`` spans and the traced request's ``replica_queue`` and
   ``postprocess`` (its trace id in the body), the crash left
   ``flightrec-http-dispatcher_crash-*.json`` with the spans before it,
   and the profiler's trace of the session, started after the warm-up,
   holds 2 ``lrn_forward_kernel<float`` a ``alexnet1`` replay in it.
26. Model export (``phase_export``, after 15), float32 with TF32 off
   under deterministic cuDNN: ``alexnet1`` (seeded weights) exported
   by ``export.export_forward`` at batch 4 and loaded by
   ``load_exported``, its graph holding 2 ``deepvision.lrn_forward``
   nodes and no plain window sum, one call launching 2
   ``lrn_forward_f32`` on the counters and a profiled one running 2
   ``lrn_forward_kernel<float`` by name, its logits the eager module's
   bit for bit; then ``yolov3`` (416 px, 20 classes) on engines with an
   artifact store over a fresh directory and buckets (1, 4): cold, both
   buckets traced and exported into it; a second engine warms both from
   it with no runner traced, each replay launching 1 ``nms_sweep`` on
   the counters and 1 ``nms_sweep_kernel`` by name in a profiled
   replay, its answers bit for bit the cold engine's; a corrupt blob and
   a bucket-1 program filed under the bucket-4 key, both quarantined by
   a third engine, which traces both and answers the same bits. It
   prints the export seconds, the artifacts' megabytes and the warm-up
   seconds cold and from the store.
27. The serving fleet (``phase_fleet``, beside 25 and 19's chains): ``python -m deepvision_tpu_torch.serve --fleet 2 -m
   alexnet1 -m yolov3 --buckets 1,4 --http 0 --store DIR --hedge-after 1
   --faults replica_kill@2,replica_slow@5:4,replica_kill@25 --track
   yolov3:4 --session-dir DIR --snapshot-every 4``: a router process that
   holds no card file over two replica processes that do; the third
   request's replica SIGKILLed and the request answered by failover, the
   replica respawned and warmed from the store the first generation
   filled concurrently (every model's runner from the store; one
   verified blob a key, nothing quarantined), the first request after
   the respawn hedged, 25's inputs answered as 25 holds them; then the
   stream drill: 2 tracking streams of 12 drifting ``yolov3`` frames, one
   frame at a time, the replica pinned by the first SIGKILLed on its
   frame 6 and the stream re-pinned to the survivor, which restores its
   seq-3 snapshot while the router replays the window: every frame in
   order, without a reset, bit for bit an in-process tracking engine's at
   bucket 1 (1 ``nms_sweep`` a detect replay, none an advance replay,
   each program's device time at bucket 1 printed); after the second
   respawn the federated ``/metrics`` against the replicas' ``/stats``,
   each replica's runners and true kernel launches, and SIGTERM: the
   router 143 after its exit line, its children 143 after their
   ``[serve]`` lines. With ``--trace-spool DIR`` every process spools its
   spans: ``python -m deepvision_tpu_torch.obs.trace_merge DIR
   --assert-flow --assert-spans router_attempt,replica_queue,device,
   postprocess`` exits 0, a request's flow crosses from the router's row
   into a replica's, each stream's session is on a replica's
   ``replica_queue`` span, the migrated one on two replicas' spools (the
   SIGKILLed one's up to its kill, then the survivor's), each replica
   the router stopped left ``flightrec-rN-signal-15-*.json`` with its last
   spans and its registry, and the router's own dump its
   ``router_attempt`` spans and ``note:probe`` notes; the router still
   holds no card file at the end. It prints the spans by name, the
   flows, the spools' bytes and the merge's seconds.
28. Pipeline serving (``phase_pipeline``, in process on a worker of its
   own beside 27): ``yolov3`` (416 px, score 0), ``hourglass104`` (256
   px) and ``alexnet1`` behind one engine on buckets (1, 4) with two
   DAGs, ``detpose`` (the top 3 boxes of VOC's person class, 256 px crops,
   pose) and ``detcls`` (the top 3 boxes, 224 px crops, ``alexnet1``),
   each stage chunked through (4, 8) and each (DAG, entry bucket) one
   CUDA graph: every answer bit for bit the eager DAG's, the DAGs'
   decisions the sequential client's, the glue on the card its CPU
   version's within 1e-6, frozen misses, each replay's credited
   ``nms_sweep`` and ``lrn_forward_f32`` and the counted launches equal
   to them; the DAGs' and the sequential client's device time and host
   wall a call at entry bucket 4, printed. Then, with a span spool
   attached in process, both DAGs at entry buckets 1 and 4 with trace
   ids: the answers bit for bit the untraced ones, each node's
   ``stage:<node>`` span (the CUDA events of the graph) inside its
   batch's ``device`` span, in DAG order, their sum within it; each
   stage's device ms at entry bucket 4 printed; the spool detached
   before 29. The chains' serving CLI of 19
   serves ``detpose`` over the chains' checkpoints too (``--pipelines``,
   2 requests, ``[pipeline] served detpose=2 frozen=True``).
29. Multi-tenant serving in process (``phase_tenancy``, after 28 on its
   worker): ``alexnet1``, ``inception1_ref`` and ``yolov3`` at full width,
   float32, with the ``detcls`` DAG behind one engine on buckets (1, 4),
   frozen, under a residency budget of the two largest tenants' weight
   bytes: round-robin passes bit for bit through each tenant's eviction
   and restore (its graphs recaptured, never missed), an eviction of
   ``yolov3`` freeing at least its weight bytes, the DAG recaptured and
   answering bit for bit as before, a hot swap of ``alexnet1`` under 3
   submitting threads (every answer one edition's whole, old before new,
   none dropped, the DAG still on the old weights); the window's launches
   counted (``CARD_COUNTS``), the recaptures' seconds, the bytes and the
   pools printed.
30. The swap drill through the serving CLI (``phase_tenancy_cli``, after
   25 on its worker): ``-m alexnet1 -m inception1_ref -m yolov3
   --residency-mb R --tenant-quota yolov3=8 --slo-class
   inception1_ref=batch`` on a paced stdin stream with one swap control
   line: every line answered, both editions of ``alexnet1`` seen, the
   others untouched, each tenant's answers the same across its eviction,
   and ``[tenancy] swaps=1`` with evictions and restores in its log.

It then prints the native pieces' line (``[native] {...}``), the
``{"kernels": [...]}`` line (the LRN kernels' four entry points, per-shape
times under ``shapes``, launches by path under ``launches_by_path`` and
a served model's launches a graph replay under ``launches_per_replay``, the
JPEG path's ``ycc_to_rgb`` and the YOLO post-process's ``nms_sweep_f32``,
which stand for no TPU kernel), the ``[yolo] {...}``, ``[centernet]
{...}``, ``[pose] {...}``, ``[gan] {...}`` and ``[classifiers] {...}``
summaries, the ``[resilience] {...}``, ``[loader] {...}`` and
``[offline] {...}`` (22-24 and the predict CLIs: records/s, seconds)
lines, the ``[graphs] {...}`` line (each engine-served model's warm-up,
cache, pool bytes, launches a replay and profile, and 25's readings),
the ``[pipeline] {...}`` line (28's readings), the ``[tenancy] {...}``
line (29's and 30's), the ``[export] {...}``
line (26's figures and the ``predict export`` CLI's), the card's name
and power limit, and last ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from functools import partial
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA's data sheet: HBM3 rate and float32 rate outside the
# tensor cores (the kernel's math is f32 for both input types)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

LRN_SOURCE = "deepvision_tpu_torch/csrc/lrn.cu"
LRN_REPLACES = "deepvision_tpu/ops/lrn_pallas.py:79"
LRN_BWD_SOURCE = "deepvision_tpu_torch/csrc/lrn_bwd.cu"
LRN_BWD_REPLACES = "deepvision_tpu/ops/lrn_pallas.py:125"
# the native pieces of the ImageNet reader, not TPU kernels
CRC_SOURCE = "deepvision_tpu_torch/csrc/crc32c.cpp"
NVJPEG_SOURCE = "deepvision_tpu_torch/csrc/nvjpeg.cu"
# the port's decode on the card (nvJPEG's planes, libjpeg's chroma
# upsampling and colour conversion) against tf.io.decode_jpeg's pixels on
# the committed fixtures (tests/data/), in uint8 steps. tf's default IDCT
# is libjpeg's fast integer one, nvJPEG's is accurate: PIL's accurate
# decode of the same files is 3-4 steps off tf's, 1.0-1.04 on average;
# against tf's accurate IDCT only rounding remains
NVJPEG_MAX_LSB = 8.0
NVJPEG_MEAN_LSB = 1.5
NVJPEG_ACCURATE_MAX_LSB = 4.0
NVJPEG_ACCURATE_MEAN_LSB = 0.1
# batch sizes that alternate over the decoder (_nvjpeg_mixed): around
# gpu_hybrid's switch to Huffman decode on the card (over 100), 1, and
# the builders' readback batches (258, 192)
NVJPEG_MIXED_BATCHES = (1, 258, 3, 192, 101, 7, 100, 64, 256, 2)
# not a TPU kernel: the colour stage of the JAX reader's tf.io.decode_jpeg
YCC_REPLACES = "deepvision_tpu/data/imagenet.py:138"
# the LRN models' training batch (their configs'), where the kernels'
# training shapes and the kernel-vs-plain train step are taken
TRAIN_BATCH = 128
# (name, shape, size, k): AlexNet V1's LRNs at the training batch, the
# shapes the train step gives the kernels (their sums make the kernels
# line), then Inception V1's stem LRNs at batch 64, whose window costs
# O(C) and not O(C*n) only if n=192 takes about the time of n=5
ALEXNET_V1_LRNS = [("lrn1", (TRAIN_BATCH, 55, 55, 96), 5, 2.0),
                   ("lrn2", (TRAIN_BATCH, 27, 27, 256), 5, 2.0)]
# Inception V1's stem LRNs (inception1_ref) at the training batch
INCEPTION_V1_LRNS = [("inception1_lrn1_b128", (TRAIN_BATCH, 56, 56, 64), 64,
                      1.0),
                     ("inception1_lrn2_b128", (TRAIN_BATCH, 56, 56, 192),
                      192, 1.0)]
TIMED_LRNS = ALEXNET_V1_LRNS + INCEPTION_V1_LRNS + [
    ("inception1_lrn1", (64, 56, 56, 64), 64, 1.0),
    ("inception1_lrn2", (64, 56, 56, 192), 192, 1.0),
    ("inception1_c192_n5", (64, 56, 56, 192), 5, 1.0),
]
# float operations an element whatever n is. Forward: square, two window
# adds, scale, add k, log2, scale by -beta, exp2, multiply. Backward:
# that denominator (6), two exp2 and their scalings (4), g*d^-beta and
# g*x*d^(-beta-1) (3), the second window's two adds (2), the final
# scale, multiply and subtract (3), rounded up
LRN_OPS_PER_ELEMENT = 9
LRN_BWD_OPS_PER_ELEMENT = 20
# (name, shape, size, k, input scale): AlexNet V1's LRNs at the training
# and the largest serving batch first
PARITY_CASES = [
    *((f"alexnet1_{name}_b{TRAIN_BATCH}", shape, size, k, 1.0)
      for name, shape, size, k in ALEXNET_V1_LRNS),
    *((name, shape, size, k, 2.0)
      for name, shape, size, k in INCEPTION_V1_LRNS),
    ("alexnet1_lrn1", (64, 55, 55, 96), 5, 2.0, 1.0),
    ("alexnet1_lrn2", (64, 27, 27, 256), 5, 2.0, 1.0),
    ("alexnet2_tf_lrn1", (8, 55, 55, 64), 5, 2.0, 1.0),
    ("alexnet2_tf_lrn2", (8, 27, 27, 192), 5, 2.0, 1.0),
    ("inception1_lrn1", (8, 56, 56, 64), 64, 1.0, 2.0),
    ("inception1_lrn2", (8, 56, 56, 192), 192, 1.0, 2.0),
    ("odd_c56", (3, 3, 3, 56), 5, 2.0, 1.0),
    # 289 rows: a ragged last tile at 4 (f32) and 8 (bf16) rows a tile
    ("ragged_rows", (1, 17, 17, 96), 5, 2.0, 1.0),
    # C*4 and C*2 not multiples of 16: one channel a lane, and a last
    # tile whose bytes end off a 16-byte boundary (63 rows, 4 a tile in
    # f32, 8 in bf16)
    ("odd_c57_ragged", (1, 7, 9, 57), 5, 2.0, 1.0),
    ("odd_c57_n64", (2, 9, 9, 57), 64, 1.0, 2.0),
    ("tiny_c3", (1, 1, 1, 3), 5, 2.0, 1.0),  # under 16 bytes in all
    ("wide_c768", (2, 9, 9, 768), 5, 2.0, 1.0),
    ("wide_c768_n192", (2, 9, 9, 768), 192, 1.0, 2.0),
    # a narrow window other than n=5 takes the prefix-sum path too
    ("n3_c96", (2, 9, 9, 96), 3, 2.0, 1.0),
    # even narrow windows on the prefix-sum path: the backward's mirrored
    # window differs from the forward's, on 16-byte vectors and on the
    # ragged C=57 (one channel a lane, a last tile off 16 bytes)
    ("n4_c96", (2, 9, 9, 96), 4, 2.0, 1.0),
    ("n6_c57_ragged", (1, 7, 9, 57), 6, 2.0, 1.0),
]
N_REQUESTS = 96
BUCKETS = (1, 4, 16, 64)
HTTP_FAULTS = "crash@2"  # the HTTP server's third batch crashes
HTTP_BACKOFF_S = 2.0  # the supervisor's first backoff there
HTTP_TRACE = "0123456789abcdef"  # the trace id of one of its requests
# served answers of a model without LRN held against the CPU's
CPU_CHECKED = 8
# timed training steps of the paths before the records', resnet50's
# included
EARLIER_TIMED_STEPS = 4
# H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate (MFU's peak)
BF16_DENSE_FLOPS_PER_S = 989e12
# the plain versions' and library calls' timings, 10-300x the kernels'
# own: the median of 5 after 1 (the kernels keep 100 after 10). Each
# costs about three times its calls (the stream is held for twice their
# host time first, taken from one call after the warm-up); at 20 after 3
# they took 65 of the 72 s of phase 4
YARDSTICK = {"iters": 5, "warmup": 1}
# the record path: batches of training records written, validation JPEGs
# (one full batch and a padded one), timed fed steps
RECORD_BATCHES = 2
RECORD_VAL = 256 + 100
RECORD_TIMED_STEPS = 4
RESNET152_TIMED_STEPS = 4
# YOLO v3 (slice 8): the NMS sweep kernel, not a TPU kernel (the greedy
# fori_loop of the JAX nms_indices, stock XLA)
NMS_SOURCE = "deepvision_tpu_torch/csrc/nms.cu"
NMS_REPLACES = "deepvision_tpu/ops/nms.py:59"
# float32 operations of one IoU and its comparison (csrc/nms.cu's iou():
# 4 max/min, 2 sub and 2 max for the overlap, its product, 2 x (2 sub,
# 2 max, 1 mul) for the areas, add, sub and max for the union, the
# division, the comparison)
NMS_IOU_OPS = 24
YOLO_SIZE = 416
YOLO_CLASSES = 20
YOLO_N = 3 * (52 ** 2 + 26 ** 2 + 13 ** 2)  # 10,647 candidate boxes
MAX_BOXES = 100
YOLO_REQUESTS = 32
YOLO_TIMED_STEPS = 4
YOLO_CLI_STEPS = 2
# CenterNet and Hourglass-104: their configs' 256 px, 80 COCO
# classes, 16 MPII joints; synthetic records (train, val), timed fed
# steps and CLI steps an epoch
CN_SIZE = 256
CN_CLASSES = 80
CN_REQUESTS = 32
CN_SCORE = 0.05
CN_BATCH = 16
CN_TRAIN, CN_VAL = 128, 32
CN_TIMED_STEPS = 2
CN_CLI_STEPS = 2
POSE_SIZE = 256
POSE_JOINTS = 16
POSE_TRAIN, POSE_VAL = 128, 32
POSE_TIMED_STEPS = 2
POSE_CLI_STEPS = 2
# the GANs: DCGAN's noise width and served requests, the card-vs-CPU
# steps' batches and CycleGAN's reduced depth there, the full-width
# CycleGAN's size and batch, its records a domain, timed steps, and the
# CLIs' steps an epoch
DCGAN_NOISE = 100
GAN_REQUESTS = 32
DCGAN_STEP_BATCH = 32
CYC_STEP_SIZE, CYC_STEP_BLOCKS, CYC_STEP_BATCH = 64, 2, 4
CYC_SIZE, CYC_BATCH = 256, 4
CYC_RECORDS = 16
GAN_TIMED_STEPS = 4
GAN_CLI_STEPS = 2
# the five classifiers of slice 11 at their configs' geometry: served
# answers held against the CPU, the batch that sets their BN statistics,
# the timed bf16 steps after warm-up, the card-vs-CPU steps' batch
CLASSIFIERS = ("vgg16", "vgg19", "mobilenet1", "shufflenet1", "inception3")
CLS_CPU_CHECKED = 4
CLS_CALIBRATION = 16
CLS_TOL = 1e-4
CLS_WARMUP, CLS_TIMED_STEPS = 2, 4
CLS_STEP_BATCH = 8
# the resilient run (phase_resilience): steps an epoch of the chaos CLI
# (2 epochs), its schedule (occurrences: train batch 5 is epoch 1's
# second, the first checkpoint save, the feed's pulls 5 and 6 are epoch
# 1's first, the loader's first turn, before worker 0 has made a batch: a
# later turn may find the worker's share of a 4-step epoch already
# queued, and nothing to respawn for), and the SDC drill's run step and
# scale
RES_STEPS = 4
CHAOS_FAULTS = "nan@5,ckpt@0,io@5x2,wkill@0"
SDC_STEP = 12
SDC_SCALE = 4
LOADER_STEPS = 6
# the offline tools: the builders' trees, eval classification
OFFLINE_TRAIN = 256  # the ImageNet tree's RGB JPEGs (train)
OFFLINE_VAL = 192  # its validation JPEGs: 3 batches of EVAL_BATCH
OFFLINE_CLASSES = 10  # the first synsets of the ImageNet list
OFFLINE_SMALL = 8  # the VOC and MPII trees' images
OFFLINE_STORED = 256  # the raw-crop shards' shorter side
EVAL_BATCH = 64
PREDICT_TOL = 1e-4
# a re-encoded file (quality 95, by nvJPEG) against its source pixels
REENCODE_MEAN_LSB = 2.0
# phase_export: alexnet1's artifact at bucket 4, yolov3's store on (1, 4)
EXPORT_BUCKET = 4
STORE_BUCKETS = (1, 4)
ARTIFACT_SUFFIX = "_pt2"  # the model name of a served predict-export file
# phase_fleet: the replica chosen for the third routed attempt (the third
# request's first) is SIGKILLed; the sixth attempt (the first request
# after the respawn: the third request's failover is the fourth) waits
# FLEET_SLOW_S before it is sent, and is hedged after FLEET_HEDGE_S
FLEET_KILL_AT = 2
FLEET_SLOW_AT = 5
FLEET_SLOW_S = 4.0
FLEET_HEDGE_S = 1.0
FLEET_PAIRS = 3  # concurrent (alexnet1, yolov3) pairs at the end
# phase_fleet's stream drill (``--track yolov3:STREAM_K``): after those 13
# attempts (4 requests, the failover, the delayed request and its hedge,
# the 3 pairs), 2 streams of STREAM_FRAMES frames, one frame at a time,
# interleaved (attempt 13 + 2 i is the first stream's frame i). The
# second replica_kill SIGKILLs the replica that the first stream is
# pinned to on its frame STREAM_KILL_FRAME, while that replica holds the
# stream's state past its newest snapshot (snapshots every
# STREAM_SNAPSHOT_EVERY frames: after seq 3): the survivor restores seq 3
# and the router replays the window. The session ids' crc32 pins differ
# in parity, so that the two streams start on the two replicas. The
# frames drift from one of the yolov3 requests to the next, scaled to
# PIPE_AMPLITUDE, where seed-0 yolov3 keeps finite boxes (at 0.03 and
# above its boxes overflow to inf)
FLEET_STREAM_AT = 13
STREAM_SIDS = ("cam0", "cam4")
STREAM_FRAMES = 12
STREAM_K = 4
STREAM_SNAPSHOT_EVERY = 4
STREAM_KILL_FRAME = 6
FLEET_FAULTS = (f"replica_kill@{FLEET_KILL_AT},"
                f"replica_slow@{FLEET_SLOW_AT}:{FLEET_SLOW_S},"
                f"replica_kill@{FLEET_STREAM_AT + 2 * STREAM_KILL_FRAME}")
# phase_pipeline: the DAGs' top-K, yolov3's class of VOC's "person", each
# stage's chunk ladder, the entry (and the engine's) buckets, and the
# requests' amplitude (fresh detector weights saturate on full-scale
# inputs: every score 1.0, boxes at inf, a degenerate top-K)
PIPE_K = 3
PIPE_PERSON = 14
PIPE_LADDER = [4, 8]
PIPE_BUCKETS = (1, 4)
PIPE_AMPLITUDE = 0.003
PIPE_TIMED = 10  # timed calls a DAG and a sequential client
STAGE_TIMED = 5  # traced entry-bucket-4 batches a DAG for its stage times
# the tenancy drills (phase_tenancy, phase_tenancy_cli)
TENANCY_PASSES = 2  # round-robin passes: each tenant evicted between them
SWAP_PERTURB = 1e-3  # hot_swap(perturb=...): every weight plus this
SWAP_THREADS = 3  # threads submitting through the swap
SWAP_ANSWERS = 6  # answers before the swap and after it
TENANCY_CLI_QUOTA = 8  # yolov3's --tenant-quota: above a group of 4
# --batch-window-ms of the CLI drill: a group of 4 lines (parsed one by
# one from JSON) makes one bucket-4 batch
TENANCY_CLI_WINDOW_MS = 10000
# the CLI drill's tenants and their input sizes (each config's own)
TENANCY_CLI_SIZES = {"alexnet1": 224, "inception1_ref": 224,
                     "yolov3": YOLO_SIZE}
# taken by a counted window (zero the counters, drive a path, read them)
# on a worker thread, and by any in-process work that may launch one of
# the port's kernels while such a window may be open on another thread
CARD_COUNTS = threading.Lock()


def _say(*parts) -> None:
    print(*parts, flush=True)


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _lrn_bound_ms(shape, itemsize: int, tensors: int = 2,
                  ops: int = LRN_OPS_PER_ELEMENT) -> tuple[float, str]:
    """Least time for one LRN pass: each of ``tensors`` activation-sized
    tensors read or written once (forward: x in, y out; backward: x and
    g in, dx out) over the HBM rate, against ``ops`` f32 operations an
    element (what the algorithm needs, whatever n) over the f32 rate."""
    numel = int(np.prod(shape))
    bytes_s = tensors * numel * itemsize / HBM_BYTES_PER_S
    ops_s = numel * ops / F32_OPS_PER_S
    if bytes_s >= ops_s:
        return bytes_s * 1e3, "bytes"
    return ops_s * 1e3, "operations"


def phase_card() -> str:
    import torch

    from deepvision_tpu_torch.device import strict_fp32

    smi = _nvidia_smi()
    _say(f"[card] {smi}")
    _say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} "
         f"count {torch.cuda.device_count()}")
    _say(f"[card] float32 policy {strict_fp32()} (TF32 off: convolutions "
         "and matmuls in full float32)")
    return smi


def phase_probe() -> None:
    """Before any JPEG code: whether the toolkit holds nvJPEG's header and
    library, and whether the host has a C++ compiler (the CRC32C's)."""
    from deepvision_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    homes = dict.fromkeys([Path(nvcc).resolve().parents[1],
                           Path(os.environ.get("CUDA_HOME")
                                or "/usr/local/cuda")])
    for home in homes:
        header = home / "include" / "nvjpeg.h"
        lib = home / "lib64" / "libnvjpeg.so"
        _say(f"[probe] {home}: nvjpeg.h {'present' if header.exists() else 'absent'}, "
             f"libnvjpeg.so {'present' if lib.exists() else 'absent'}")
    cxx = _build.find_cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    _say(f"[probe] nvcc {nvcc}; host C++ compiler {cxx} ({version})")


def phase_build() -> dict[str, str]:
    """Every native source at once, one compiler each: the LRN kernels,
    the nvJPEG binding and the NMS sweep with ``nvcc``, the CRC32C with
    the host's C++ compiler. Returns the native pieces' libraries by
    source."""
    from concurrent.futures import ThreadPoolExecutor

    from deepvision_tpu_torch.ops import _build

    stems = {"lrn": LRN_SOURCE, "lrn_bwd": LRN_BWD_SOURCE,
             "crc32c": CRC_SOURCE, "nvjpeg": NVJPEG_SOURCE,
             "nms": NMS_SOURCE}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(stems)) as pool:
        libs = list(pool.map(_build.build, stems))
    wall = time.perf_counter() - t0
    for (stem, source), lib in zip(stems.items(), libs):
        _build.load_library(stem)
        flags = (_build.CXX_FLAGS if source.endswith(".cpp")
                 else _build.NVCC_FLAGS)
        _say(f"[build] {source} -> {lib.name} ({wall:.2f} s for all "
             f"{len(stems)}, flags: {' '.join(flags)}"
             + (f", linked: {_build.LINK[stem]}" if stem in _build.LINK
                else "") + ")")
        for kernel, report in _ptxas_report(_build.build_logs.get(stem,
                                                                  "")):
            _say(f"[build] ptxas {kernel}: {report}")
    return {CRC_SOURCE: libs[2].name, NVJPEG_SOURCE: libs[3].name,
            NMS_SOURCE: libs[4].name}


def _ptxas_report(log: str) -> list[tuple[str, str]]:
    """(instantiation, "N registers, spills") for each kernel in nvcc's
    ``-Xptxas -v`` output; shared memory is dynamic (the launch plan)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"lrn_(forward|backward)_kernelI"
                          r"(13__nv_bfloat16|f)Li(\d+)ELb([01])E", m[1])
            if t:
                name = (f"{t[1]} {'bf16' if t[2] != 'f' else 'f32'} "
                        f"vec={t[3]} "
                        f"{'prefix sums' if t[4] == '1' else 'n=5 slide'}")
            else:
                name = m[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"{m[1]}/{m[2]} bytes spilled (stores/loads)"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, f"{m[1]} registers, {spills}"))
            name = None
    return out


def phase_parity() -> dict[str, float]:
    """Kernels vs plain versions at every zoo shape, forward and
    backward; max abs error by kernel name."""
    import torch

    from deepvision_tpu_torch.ops.lrn import (
        local_response_norm_backward_reference,
        local_response_norm_reference,
    )
    from deepvision_tpu_torch.ops.lrn_cuda import (
        BACKWARD_KERNEL_NAMES,
        KERNEL_NAMES,
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )

    errs = dict.fromkeys([*KERNEL_NAMES.values(),
                          *BACKWARD_KERNEL_NAMES.values()], 0.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, size, k, scale in PARITY_CASES:
        x32 = torch.randn(shape, device="cuda", generator=gen) * scale
        g32 = torch.randn(shape, device="cuda", generator=gen)
        lrn = (size, 1e-4, 0.75, k)
        # bf16: both sides compute in f32 and round once to bf16, so a
        # last-bit f32 difference can land on either side of a rounding
        # boundary; one bf16 step (2^-7 relative) on top of atol 1e-2
        for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=1e-5)),
                           (torch.bfloat16, dict(atol=1e-2, rtol=2**-7))):
            x, g = x32.to(dtype), g32.to(dtype)
            for kernel, got, want in (
                    (KERNEL_NAMES[dtype],
                     local_response_norm_cuda(x, *lrn),
                     local_response_norm_reference(x, *lrn)),
                    (BACKWARD_KERNEL_NAMES[dtype],
                     local_response_norm_backward_cuda(x, g, *lrn),
                     local_response_norm_backward_reference(x, g, *lrn))):
                torch.cuda.synchronize()
                assert got.dtype == dtype and got.shape == x.shape
                torch.testing.assert_close(
                    got.float(), want.float(), **tol,
                    msg=lambda m: f"{kernel} {name}: {m}")
                err = (got.float() - want.float()).abs().max().item()
                errs[kernel] = max(errs[kernel], err)
                _say(f"[parity] {kernel} {name} {tuple(shape)} n={size} "
                     f"k={k}: max abs err {err:.3e}")
    # a base pointer off a 16-byte boundary is refused, never copied: the
    # forward's input, and the backward's incoming gradient
    odd = torch.zeros(65, device="cuda")[1:].view(1, 1, 1, 64)
    even = torch.zeros(1, 1, 1, 64, device="cuda")
    for wrapper, args in ((local_response_norm_cuda, (odd,)),
                          (local_response_norm_backward_cuda, (even, odd))):
        before = wrapper.launches
        try:
            wrapper(*args)
        except ValueError as e:
            assert "16-byte aligned" in str(e), e
        else:
            raise AssertionError(f"{wrapper.__name__} launched a misaligned "
                                 "tensor")
        assert wrapper.launches == before
    _say("[parity] a tensor 4 bytes off a 16-byte boundary is refused by "
         "both kernels (the backward's g), no launch counted")
    return errs


def _lib_backward_inputs(xs, gs, size, k):
    """For each cold buffer, the forward graph of ``F.local_response_norm``
    on the NCHW view, so that the library's backward alone can be timed
    (``retain_graph``)."""
    import torch.nn.functional as F

    out = []
    for x, g in zip(xs, gs):
        xg = x.detach().requires_grad_()
        y = F.local_response_norm(xg.permute(0, 3, 1, 2), size, 1e-4, 0.75,
                                  k)
        out.append((y, xg, g.permute(0, 3, 1, 2)))
    return out


def phase_times() -> dict[str, dict]:
    """Kernel, plain and library times at every shape of ``TIMED_LRNS``,
    forward and backward, cold and warm; per kernel, the cold sums over
    AlexNet V1's two LRNs (what one train step launches each way) and
    the per-shape detail."""
    import torch
    import torch.nn.functional as F

    from deepvision_tpu_torch.ops.lrn import (
        local_response_norm_backward_reference,
        local_response_norm_reference,
    )
    from deepvision_tpu_torch.ops.lrn_cuda import (
        BACKWARD_KERNEL_NAMES,
        KERNEL_NAMES,
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )
    from deepvision_tpu_torch.timing import cold_inputs, time_ms

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in KERNEL_NAMES:
        fwd, bwd = KERNEL_NAMES[dtype], BACKWARD_KERNEL_NAMES[dtype]
        keys = ("ms", "ms_warm", "plain_ms", "library_ms", "bound_ms")
        tot = {fwd: dict.fromkeys(keys, 0.0), bwd: dict.fromkeys(keys, 0.0)}
        bound_by = {fwd: set(), bwd: set()}
        shapes = {fwd: [], bwd: []}
        xs = gs = None
        for lrn, shape, size, k in TIMED_LRNS:
            t_row = time.perf_counter()
            if xs is None or xs[0].shape != shape:  # same shape: same inputs
                xs = gs = None  # free the last shape's buffers first
                torch.cuda.empty_cache()
                xs = cold_inputs(shape, dtype, gen)
                gs = cold_inputs(shape, dtype, gen)[:len(xs)]
            xgs = list(zip(xs, gs))
            p = (size, 1e-4, 0.75, k)

            def lib_bwd(item):
                y, xg, g = item
                return torch.autograd.grad(y, xg, g, retain_graph=True)[0]

            lib_inputs = _lib_backward_inputs(xs, gs, size, k)
            rows = {
                fwd: {"ms": time_ms(lambda x: local_response_norm_cuda(
                          x, *p), xs),
                      "ms_warm": time_ms(lambda x: local_response_norm_cuda(
                          x, *p), xs[:1]),
                      "plain_ms": time_ms(
                          lambda x: local_response_norm_reference(x, *p), xs,
                          **YARDSTICK),
                      # on the channels_last NCHW view
                      "library_ms": time_ms(lambda x: F.local_response_norm(
                          x.permute(0, 3, 1, 2), *p), xs, **YARDSTICK),
                      # one read and one write of the same bytes: what the
                      # card reaches in practice, beside the bound
                      "copy_ms": time_ms(torch.clone, xs)},
                bwd: {"ms": time_ms(
                          lambda a: local_response_norm_backward_cuda(*a, *p),
                          xgs),
                      "ms_warm": time_ms(
                          lambda a: local_response_norm_backward_cuda(*a, *p),
                          xgs[:1]),
                      "plain_ms": time_ms(
                          lambda a: local_response_norm_backward_reference(
                              *a, *p), xgs, **YARDSTICK),
                      "library_ms": time_ms(lib_bwd, lib_inputs,
                                            **YARDSTICK),
                      # two reads and one write of the same bytes: what the
                      # card reaches in practice, beside the bound
                      "add_ms": time_ms(lambda a: torch.add(*a), xgs)},
            }
            lib_inputs = None
            # the gradient is taken with respect to the NHWC leaf
            lib_err = (lib_bwd(_lib_backward_inputs(xs[:1], gs[:1], size,
                                                    k)[0]).float()
                       - local_response_norm_backward_reference(
                           xs[0], gs[0], *p).float()).abs().max().item()
            for kernel, tensors, ops in ((fwd, 2, LRN_OPS_PER_ELEMENT),
                                         (bwd, 3, LRN_BWD_OPS_PER_ELEMENT)):
                row = {"lrn": lrn, "shape": list(shape), "size": size,
                       "k": k, "cold_buffers": len(xs), **rows[kernel]}
                row["bound_ms"], row["bound_by"] = _lrn_bound_ms(
                    shape, xs[0].element_size(), tensors, ops)
                row["bound_share"] = row["bound_ms"] / row["ms"]
                bound_by[kernel].add(row["bound_by"])
                shapes[kernel].append(row)
                copy = (f"; a copy of the same bytes {row['copy_ms']:.4f} "
                        f"ms, {row['bound_ms'] / row['copy_ms']:.1%}"
                        if "copy_ms" in row else
                        f"; torch.add of the same bytes {row['add_ms']:.4f} "
                        f"ms, {row['bound_ms'] / row['add_ms']:.1%}; "
                        f"library max abs diff to plain {lib_err:.2e}")
                _say(f"[time] {kernel} {lrn} {tuple(shape)} n={size}: "
                     f"kernel cold {row['ms']:.4f} ms warm "
                     f"{row['ms_warm']:.4f} ms ({len(xs)} buffers cold), "
                     f"plain {row['plain_ms']:.4f} ms, library "
                     f"{row['library_ms']:.4f} ms, bound "
                     f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                     f"({row['bound_share']:.1%} of the bound, cold{copy})")
                if (lrn, shape, size, k) in ALEXNET_V1_LRNS:
                    for key in keys:
                        tot[kernel][key] += row[key]
            _say(f"[time] {lrn} {dtype}: {time.perf_counter() - t_row:.2f} s "
                 "of the phase (inputs, both kernels, plain, library)")
        for kernel in (fwd, bwd):
            by_name = {r["lrn"]: r for r in shapes[kernel]}
            ratio = (by_name["inception1_lrn2"]["ms"]
                     / by_name["inception1_c192_n5"]["ms"])
            _say(f"[time] {kernel} (64,56,56,192): n=192 takes {ratio:.3f}x "
                 "the time of n=5 on the same input (cold)")
            tot[kernel]["bound_by"] = ("bytes" if bound_by[kernel] == {"bytes"}
                                       else "operations")
            tot[kernel]["shapes"] = shapes[kernel]
            out[kernel] = tot[kernel]
        xs = gs = xgs = None
        torch.cuda.empty_cache()
    return out


def _check_against(results, ref_probs, ref_classes, full_probs,
                   atol: float) -> None:
    """Engine answers vs the plain-LRN run: probabilities within
    ``atol``; a class may differ from the reference's only where the
    reference gives it the same probability within ``atol`` (a tie)."""
    for i, r in enumerate(results):
        classes = np.asarray(r["classes"])
        probs = np.asarray(r["probs"])
        assert classes.shape == (5,) and np.all(np.isfinite(probs)), r
        np.testing.assert_allclose(probs, ref_probs[i], atol=atol)
        for j in np.nonzero(classes != ref_classes[i])[0]:
            gap = abs(full_probs[i, classes[j]] - ref_probs[i, j])
            assert gap <= atol, (
                f"request {i}: class {classes[j]} in place {j} where the "
                f"plain-LRN run has {ref_classes[i, j]} (gap {gap:.2e})")


def _bucket(n: int) -> int:
    """The engine's bucket for a batch of ``n`` rows on ``BUCKETS``."""
    return next(b for b in BUCKETS if b >= n)


def _same_bits(got, want) -> bool:
    """Answers equal bit for bit: the shortest round-trip text of every
    float (NaN and infinities included) is the same."""
    return json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def _eager_answers(served, batches) -> list:
    """``served``'s answers to each host batch of ``batches`` from the
    eager forward (``ServedModel.run``) of the batch padded to the
    engine's bucket: what :func:`_graph_rounds` holds the engine to. Its
    kernel launches are a comparison's, not the served path's, so it
    runs before the counts are zeroed for the engine's traffic."""
    out = []
    for xs in batches:
        padded = np.zeros((_bucket(len(xs)), *served.input_shape),
                          np.float32)
        padded[:len(xs)] = xs
        host = served.run(padded)
        out.append([served.postprocess(host, i) for i in range(len(xs))])
    return out


def _queued(eng, xs, model: str | None = None) -> list:
    """``xs`` queued on the paused engine at once, so that they make one
    batch (at most the largest bucket); their answers."""
    eng.pause()
    futures = [eng.submit(x, model=model) for x in xs]
    eng.resume()
    return [f.result(timeout=600) for f in futures]


def _graph_rounds(eng, served, batches, eager: list,
                  model: str | None = None) -> list:
    """Each host batch of ``batches`` queued on ``eng`` in turn, one
    batch each: its answers, from the CUDA graph of its bucket, equal bit
    for bit to ``eager``'s (:func:`_eager_answers` of the same batches,
    run before). Two batches of one size in a row (the same graph
    replayed on new inputs) must give different answers: a replay that
    missed the copy into the graph's static input would repeat the
    previous batch's. Only the engine launches anything here. Returns
    the answers."""
    out = []
    for xs, want in zip(batches, eager, strict=True):
        got = _queued(eng, xs, model)
        assert _same_bits(got, want), (
            f"{served.name}: the CUDA graph of bucket {_bucket(len(xs))} "
            "answered other bits than the eager forward")
        if out and _bucket(len(out[-1])) == _bucket(len(xs)):
            assert not _same_bits(got, out[-1]), (
                f"{served.name}: two different batches at bucket "
                f"{_bucket(len(xs))} got the same answers")
        out.append(got)
    return out


def _graph_report(label: str, eng, name: str, misses: int) -> dict:
    """The engine's runners of ``name`` after its traffic: the warm-up's
    seconds (the captures), the cache's misses before and after the
    traffic (equal: no request built a runner) and hits, the graph
    pool's bytes and the port's kernels that one replay launches, by
    bucket."""
    stats = eng.stats()
    cache, runners = stats["cache"], stats["runners"][name]
    assert runners["kind"] == "cuda_graph", runners
    assert cache["misses"] == misses == cache["entries"], (misses, cache)
    per_replay = {b: r["launches"] for b, r in runners["buckets"].items()}
    _say(f"[graphs] {label}: warm-up {eng.warmup_s} s (an eager forward "
         f"and a CUDA graph capture for each of buckets {BUCKETS}); cache "
         f"misses {misses} before the traffic and {cache['misses']} after,"
         f" hits {cache['hits']}; the graph pool reserves "
         f"{runners['pool_bytes'] / 2**20:.1f} MiB; kernel launches a "
         f"replay by bucket {per_replay}")
    return {"warmup_s": eng.warmup_s, "misses": cache["misses"],
            "hits": cache["hits"], "pool_bytes": runners["pool_bytes"],
            "launches_per_replay": per_replay}


def _closed(label: str) -> int:
    """The memory the allocator reserves after an engine's close (its
    graphs and pool dropped, the cache emptied), printed."""
    import torch

    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    _say(f"[graphs] {label}: engine closed; memory reserved "
         f"{reserved / 2**20:.1f} MiB")
    return reserved


# each kernel counter's name (``ops.kernel_launches``) -> a part of the
# name that the profiler gives its kernel on the card
DEVICE_KERNELS = {"lrn_forward_f32": "lrn_forward_kernel<float,",
                  "lrn_forward_bf16": "lrn_forward_kernel<__nv_bfloat16,",
                  "lrn_backward_f32": "lrn_backward_kernel<float,",
                  "lrn_backward_bf16": "lrn_backward_kernel<__nv_bfloat16,",
                  "nms_sweep": "nms_sweep_kernel("}


def _profile_served(runner, served, batch, label: str, eager: bool = False,
                    **kw) -> dict:
    """Profiler windows over a CUDA graph runner on ``batch`` (with the
    host wall a call: the median of the card-only windows); with
    ``eager`` the same for ``ServedModel.run``, the forward before the
    graphs. The traced window holds one replay, which must have run each
    of the port's kernels as many times as the runner's ``launches``
    (what each replay credits to the counts) and no other."""
    ran: dict[str, int] = {}
    prof = _profile(lambda: runner(batch), f"{label} (CUDA graph)",
                    counts=ran, **kw)
    assert ran, (f"{label}: the profiler recorded no device time, so a "
                 "replay's kernels cannot be held to its credited launches")
    traced = {name: sum(n for k, n in ran.items() if part in k)
              for name, part in DEVICE_KERNELS.items()}
    assert {k: n for k, n in traced.items() if n} == runner.launches, (
        label, traced, runner.launches)
    _say(f"[graphs] {label}: the traced replay ran {runner.launches or 'none'}"
         " of the port's kernels, as its credited launches say")
    if eager:
        before = _profile(lambda: served.run(batch), f"{label} (eager)",
                          **kw)
        prof["eager"] = {k: before[k] for k in ("device_ms", "launches",
                                                "idle", "host_ms")}
        _say(f"[graphs] {label}: host wall a call {prof['host_ms']} ms on "
             f"the CUDA graph, {before['host_ms']} ms eager; device time "
             f"{prof['device_ms']} ms against {before['device_ms']} ms "
             "eager")
    return prof


def _profile_largest(served, batch, graphs: dict, **kw) -> dict:
    """:func:`_profile_served` (``kw``: its keywords) over a new CUDA
    graph runner of the largest bucket, captured after the engine that
    ``graphs`` reports on has closed: no dispatcher replays a graph
    beside it. Its kernels a replay must be those of the engine's runner
    of that bucket."""
    runner = served.compile_for(BUCKETS[-1])
    engine_runner = graphs["launches_per_replay"][str(BUCKETS[-1])]
    assert runner.launches == engine_runner, (runner.launches,
                                              engine_runner)
    return _profile_served(runner, served, batch, **kw)


def phase_serve(smi: str, name: str = "alexnet1", lrns: int = 2,
                eager: bool = False) -> tuple[dict[str, int], list,
                                              np.ndarray, dict]:
    """Serving ``name`` in float32, a main path, with ``lrns`` LRNs a
    forward, on the engine's CUDA graphs; returns the LRN launches it made
    by kernel, the answers, the inputs and the graphs' report. The
    answers are held against the same module run with the plain LRN on
    the card, or, for a model without LRN, against the same weights run
    on this machine's CPU (the first 8 requests); then two different
    bucket-16 batches, a bucket-4 one and two bucket-1 ones, each bit for
    bit the eager forward's (the graphs' report keeps the bucket-1
    answers under ``bucket1``). Profiler windows over a bucket-64 batch, and with
    ``eager`` over the eager forward's too."""
    import torch

    from deepvision_tpu_torch.ops.lrn import local_response_norm_reference
    from deepvision_tpu_torch.serve import InferenceEngine, load_served

    t0 = time.perf_counter()
    served = load_served(name, seed=0)
    engine = InferenceEngine([served], buckets=BUCKETS,
                             batch_window_s=0.002, freeze_cache=True)
    misses = engine.stats()["cache"]["misses"]
    _say(f"[serve] {name} {served.input_shape} -> 1000 classes on "
         f"{served.device}, {sum(p.numel() for p in served.module.parameters())}"
         f" parameters; load + warm-up {time.perf_counter() - t0:.2f} s; "
         f"precision {engine.precision}")
    xs = (np.random.default_rng(0)
          .normal(0, 1, (N_REQUESTS, *served.input_shape))
          .astype(np.float32))
    batches = [xs[:16], xs[16:32], xs[32:35], xs[35:36], xs[36:37]]
    eager_answers = _eager_answers(served, batches)
    _zero_launch_counts()
    try:
        t0 = time.perf_counter()
        futures = [engine.submit(x) for x in xs]
        results = [f.result(timeout=300) for f in futures]
        wall = time.perf_counter() - t0
        by_kernel = _launch_counts()
        snap = engine.telemetry.snapshot()
        rounds = _graph_rounds(engine, served, batches, eager_answers)
        graphs = _graph_report(name, engine, name, misses)
        graphs["bucket1"] = {35: rounds[3][0], 36: rounds[4][0]}
    finally:
        engine.close()
    graphs["reserved_after_close"] = _closed(name)
    graphs["profile"] = _profile_largest(
        served, xs[:BUCKETS[-1]], graphs,
        label=f"{name} bucket-{BUCKETS[-1]} batch", eager=eager)
    batches = snap["batches"]
    launches = sum(by_kernel.values())
    assert snap["completed"] == N_REQUESTS and snap["failed"] == 0, snap
    assert launches == lrns * batches, (launches, batches)
    assert by_kernel["lrn_forward_f32"] == launches, by_kernel
    for per in graphs["launches_per_replay"].values():
        assert per == ({"lrn_forward_f32": lrns} if lrns else {}), per
    _say(f"[serve] {name}: {N_REQUESTS} requests in {batches} batches "
         f"(pad overhead {snap['pad_overhead_frac']}); LRN launches "
         f"{launches} = {lrns} per batch (replay); {by_kernel}; two "
         f"bucket-16 batches, a bucket-4 one and two bucket-1 ones equal "
         f"bit for bit to the eager forward")
    _say(f"[serve] {name}: {N_REQUESTS / wall:.1f} images/s, e2e p50 "
         f"{snap['e2e_latency']['p50_ms']} ms p95 "
         f"{snap['e2e_latency']['p95_ms']} ms, device time per batch p50 "
         f"{snap['device_time']['p50_ms']} ms (offered as one burst; "
         f"{smi})")

    ref = copy.deepcopy(served.module)
    if lrns:
        ref.lrn = local_response_norm_reference
        n, where, what = N_REQUESTS, "cuda", "the plain-LRN run"
    else:
        ref = ref.cpu()
        n, where, what = CPU_CHECKED, "cpu", "the CPU run"
    with torch.inference_mode():
        probs = torch.cat([
            torch.softmax(ref(torch.from_numpy(xs[i:min(i + 32, n)])
                              .to(where)), -1)
            for i in range(0, n, 32)])
        top_p, top_c = torch.topk(probs, 5, dim=-1)
    _check_against(results[:n], top_p.cpu().numpy(), top_c.cpu().numpy(),
                   probs.cpu().numpy(), atol=1e-4)
    _say(f"[serve] {name}: the first {n} answers match {what} of the same "
         "weights (probs within 1e-4)")
    return by_kernel, results, xs, graphs


def _zero_launch_counts() -> None:
    from deepvision_tpu_torch.ops.lrn_cuda import (
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )

    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    for wrapper in (local_response_norm_cuda,
                    local_response_norm_backward_cuda):
        wrapper.launches = 0
        for key in wrapper.launches_by_kernel:
            wrapper.launches_by_kernel[key] = 0
    nms_sweep_cuda.launches = 0


def _nms_launches() -> int:
    """The NMS sweep kernel's launches since the last
    ``_zero_launch_counts``."""
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    return nms_sweep_cuda.launches


def _launch_counts() -> dict[str, int]:
    """Launches by entry point since the last ``_zero_launch_counts``."""
    from deepvision_tpu_torch.ops.lrn_cuda import (
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )

    return {**local_response_norm_cuda.launches_by_kernel,
            **local_response_norm_backward_cuda.launches_by_kernel}


def _device_events(prof) -> list[tuple[str, float, float]]:
    """``(name, start us, end us)`` of every kernel and copy the card ran
    in ``prof``'s window, read from the profiler's raw results. Its
    Python event tree (``events()``, ``key_averages()``) took most of
    each window's seconds, 6-8 s for a step of 47,000 launches. User
    annotations (``Optimizer.step#SGD.step``) are ranges on the device's
    timeline over kernels counted themselves, and are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def _profile(run, label: str, top: int = 10, windows: int = 3,
             before: str | None = None, share_of: str = "lrn",
             counts: dict | None = None) -> dict:
    """``torch.profiler`` windows over ``run()``, which does its work and
    waits for the card. One window traces the card (nothing here reads
    the host's operations): the device time by kernel name, the
    launches, the LRN kernels' share of the device time and that of the
    reduction and elementwise kernels (BatchNorm's statistics and apply
    are both), and for each kernel whose name holds ``before``, the
    kernel the card ran just before it and whether that was a copy. Then
    :func:`_idle_share` over ``windows`` card-only windows. Returns
    ``device_ms``, ``launches``, ``reduction_share``,
    ``elementwise_share``, ``kernel_share`` (that of the kernels whose
    names hold ``share_of``) and ``idle`` (the median share; None where
    the profiler recorded no device time) and ``host_ms`` (the median
    host wall of a card-only window); fills ``counts``, if given, with
    the traced window's launches by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = _device_events(prof)
    by_name: dict[str, list] = {}
    for name, start, end in events:
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += end - start
        entry[1] += 1
    total_us = sum(us for us, _ in by_name.values())
    if total_us == 0:
        _say(f"[profile] {label}: device time by kernel not measured (the "
             "profiler recorded no device time)")
        return {"device_ms": None, "launches": None, "idle": None,
                "reduction_share": None, "elementwise_share": None,
                "kernel_share": None, "host_ms": None}

    def share(word: str) -> float:
        return sum(us for name, (us, _) in by_name.items()
                   if word in name.lower()) / total_us

    kernel = share(share_of)
    out = {"device_ms": total_us / 1e3, "launches": len(events),
           "reduction_share": share("reduce"),
           "elementwise_share": share("elementwise"), "idle": None,
           "kernel_share": kernel}
    if counts is not None:
        counts.update((name, n) for name, (_, n) in by_name.items())
    _say(f"[profile] {label} (card traced): "
         f"device time {total_us / 1e3:.3f} ms in {out['launches']} "
         f"launches of {len(by_name)} kernels/copies; "
         f"{share_of.upper()} {kernel * total_us / 1e3:.4f} ms = "
         f"{kernel:.2%} of device time; "
         f"reduction kernels {out['reduction_share']:.2%}, elementwise "
         f"kernels {out['elementwise_share']:.2%}")
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    # the top kernels, and every LRN kernel and copy wherever it ranks
    for name, (us, count) in ranked[:top] + [kv for kv in ranked[top:] if any(
            word in kv[0].lower() for word in (share_of, "copy", "memcpy"))]:
        _say(f"[profile]   {us / 1e3:9.4f} ms {us / total_us:6.2%} "
             f"x{count} {name[:110]}")
    if before:
        timeline = sorted(events, key=lambda e: e[1])
        for i, (name, _, _) in enumerate(timeline):
            if before in name:
                prev = timeline[i - 1][0] if i else "nothing"
                copy = "copy" in prev.lower()
                _say(f"[profile] before {name[:60]}: "
                     f"{'a copy' if copy else 'no copy'} ({prev[:100]})")

    walls: list[float] = []
    out["idle"] = _idle_share(run, label, windows, walls)
    out["host_ms"] = statistics.median(walls) if walls else None
    return out


def _idle_share(run, label: str, windows: int,
                walls: list | None = None) -> float | None:
    """``windows`` ``torch.profiler`` windows over ``run()`` that trace
    the card alone, so that no tracing of host operations lengthens the
    host's wall time: the device's idle share of it, 1 - busy / wall,
    and the H2D copies' time in each. Returns the median share (None
    where the profiler recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    idle = []
    for w in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = _device_events(prof)
        busy_us, end = 0.0, float("-inf")
        for _, a, b in sorted(events, key=lambda e: e[1]):
            if b > end:  # the union of the device's intervals
                busy_us += b - max(a, end)
                end = b
        if busy_us == 0:
            _say(f"[profile] card-only window {w}: idle share not measured "
                 "(the profiler recorded no device time)")
            return None
        h2d_us = sum(b - a for name, a, b in events if "HtoD" in name)
        idle.append(1 - busy_us / wall_us)
        if walls is not None:
            walls.append(wall_us / 1e3)
        _say(f"[profile] card-only window {w}: host wall "
             f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
             f"(H2D copy {h2d_us / 1e3:.3f} ms), idle share {idle[-1]:.1%}")
    share = statistics.median(idle)
    _say(f"[profile] {label}: device idle share, median of {windows} "
         f"card-only windows, {share:.1%} (range "
         f"{min(idle):.1%}-{max(idle):.1%})")
    return share


def phase_cli(results, xs, n: int = 4) -> None:
    """The serving CLI on the card answers like the engine."""
    lines = "".join(json.dumps({"id": i, "model": "alexnet1",
                                "input": xs[i].tolist()}) + "\n"
                    for i in range(n))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m",
         "alexnet1", "--buckets", "1,4", "--seed", "0"],
        input=lines, capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    replies = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [r["id"] for r in replies] == list(range(n)), replies
    for r in replies:
        want = results[r["id"]]
        assert r["result"]["classes"][0] == want["classes"][0], (r, want)
        np.testing.assert_allclose(r["result"]["probs"], want["probs"],
                                   atol=1e-4)
    # true launches: the eager forward of each bucket's capture, then two
    # a replay; at least one batch ran
    lrn = _cli_launches(proc.stderr)["lrn_forward_f32"]
    assert lrn >= 2 * 2 + 2 and lrn % 2 == 0, proc.stderr[-2000:]
    _say(f"[cli] python -m deepvision_tpu_torch.serve answered {n} "
         f"requests like the engine in {time.perf_counter() - t0:.1f} s; "
         f"{proc.stderr.strip().splitlines()[-1]}")


def _http(port: int, method: str, path: str, body=None):
    """One request to the HTTP server on ``port``: (status, Retry-After,
    the body's bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), resp.read()
    finally:
        conn.close()


def _b64_request(model: str, x: np.ndarray) -> dict:
    """A ``/v1/predict`` body in the binary wire format."""
    import base64

    return {"model": model, "input_b64": base64.b64encode(
        np.ascontiguousarray(x, np.float32).tobytes()).decode(),
        "shape": list(x.shape)}


def phase_http(workdir: Path, alexnet_xs: np.ndarray, alexnet: list,
               yolo_xs: np.ndarray, yolo: list) -> dict:
    """The HTTP server as a user starts it: ``python -m
    deepvision_tpu_torch.serve -m alexnet1 -m yolov3 --http 0 --port-file
    F --faults HTTP_FAULTS`` (seeded weights, ``--buckets 1,4`` as the
    other serving CLIs here, the supervisor's first backoff
    ``HTTP_BACKOFF_S``). Requests one at a time: ``alexnet1`` as JSON
    lists, ``yolov3`` as base64; the third batch crashes the dispatcher
    and answers 500, ``/healthz`` then answers 503 with ``Retry-After``
    until the supervisor restarts it, then 200, and both models answer
    again; a bad input 400, an unknown path 404. The ``alexnet1``
    answers to ``alexnet_xs`` equal bit for bit the in-process engine's
    at bucket 1 (``alexnet``), the ``yolov3`` ones to ``yolo_xs`` those
    of the in-process engine (``yolo``; :func:`_http_yolo_check`);
    ``/stats`` shows one crash, one
    restart and no miss after the warm-up, ``/metrics`` the crash
    counter and the device memory gauges; SIGINT ends the process with
    0, and its last line counts the kernels' true launches (the eager
    forward of each capture, then one replay a batch; the crashed batch
    replayed nothing). With ``--trace-spool``, ``--obs-role http`` and
    ``--profile-dir``: :func:`_http_obs_checks`. Returns the readings."""
    port_file, log = workdir / "http.port", workdir / "http.log"
    port_file.unlink(missing_ok=True)
    obs, prof = workdir / "http-obs", workdir / "http-profile"
    shutil.rmtree(obs, ignore_errors=True)
    shutil.rmtree(prof, ignore_errors=True)
    cmd = [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m",
           "alexnet1", "-m", "yolov3", "--http", "0", "--port-file",
           str(port_file), "--faults", HTTP_FAULTS, "--buckets", "1,4",
           "--restart-backoff-s", str(HTTP_BACKOFF_S), "--trace-spool",
           str(obs), "--obs-role", "http", "--profile-dir", str(prof)]
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL,
                                stderr=err,
                                env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        while not port_file.exists():
            assert proc.poll() is None, _log_text(log)[-4000:]
            assert time.perf_counter() - t0 < 600, _log_text(log)[-4000:]
            time.sleep(0.1)
        start_s = time.perf_counter() - t0
        port = int(port_file.read_text())
        healthy = _http(port, "GET", "/healthz")
        got = {"a0": _http(port, "POST", "/v1/predict",
                           {"model": "alexnet1",
                            "input": alexnet_xs[0].tolist()}),
               "y0": _http(port, "POST", "/v1/predict",
                           _b64_request("yolov3", yolo_xs[0]))}
        crashed = _http(port, "POST", "/v1/predict",
                        _b64_request("alexnet1", alexnet_xs[1]))
        recovering = _http(port, "GET", "/healthz")
        t_crash = time.perf_counter()
        while _http(port, "GET", "/healthz")[0] != 200:
            assert time.perf_counter() - t_crash < 60
            time.sleep(0.05)
        healed_s = time.perf_counter() - t_crash
        # a trace id in the body, as a client sends one
        got["a1"] = _http(port, "POST", "/v1/predict",
                          {**_b64_request("alexnet1", alexnet_xs[1]),
                           "trace": HTTP_TRACE})
        got["y1"] = _http(port, "POST", "/v1/predict",
                          _b64_request("yolov3", yolo_xs[1]))
        bad = _http(port, "POST", "/v1/predict",
                    {"model": "alexnet1", "input": [1.0]})
        missing = _http(port, "GET", "/v2/nothing")
        stats = json.loads(_http(port, "GET", "/stats")[2])
        metrics = _http(port, "GET", "/metrics")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
    text = _log_text(log)
    assert rc == 0, text[-4000:]
    assert healthy[0] == 200, healthy
    for key, (code, _, body) in got.items():
        assert code == 200, (key, code, body[:2000])
    answers = {k: json.loads(v[2])["result"] for k, v in got.items()}
    assert _same_bits([answers["a0"], answers["a1"]], alexnet), (
        "the HTTP server's alexnet1 answers differ from the in-process "
        "engine's at bucket 1")
    _http_yolo_check([answers["y0"], answers["y1"]], yolo)
    assert crashed[0] == 500, crashed
    assert b"dispatcher crashed" in crashed[2], crashed
    assert recovering[0] == 503 and recovering[1] is not None, recovering
    assert json.loads(recovering[2])["status"] == "recovering", recovering
    assert 1 <= int(recovering[1]) <= math.ceil(HTTP_BACKOFF_S), recovering
    assert bad[0] == 400 and missing[0] == 404, (bad, missing)
    tel, cache = stats["telemetry"], stats["cache"]
    assert (tel["dispatcher_crashes"], tel["dispatcher_restarts"]) == (1, 1)
    assert (tel["completed"], tel["failed"], tel["batches"]) == (4, 1, 4), tel
    assert cache["misses"] == cache["entries"] == 4 and cache["frozen"], cache
    runners = stats["runners"]
    for name, per in (("alexnet1", {"lrn_forward_f32": 2}),
                      ("yolov3", {"nms_sweep": 1})):
        assert runners[name]["kind"] == "cuda_graph", runners
        assert all(b["launches"] == per
                   for b in runners[name]["buckets"].values()), runners
    assert metrics[0] == 200
    assert b"serve_dispatcher_crashes_total 1" in metrics[2], metrics[2][:2000]
    assert b"mem_bytes_in_use_dev0" in metrics[2], metrics[2][:2000]
    last = text.strip().splitlines()[-1]
    launches = _cli_launches(text)
    # 2 buckets' captures' eager forwards, then the 2 answered batches
    assert launches["lrn_forward_f32"] == 2 * (2 + 2), last
    assert launches["nms_sweep"] == 2 + 2, last
    pools = {n: r["pool_bytes"] for n, r in runners.items()}
    obs_readings = _http_obs_checks(obs, prof, runners)
    _say(f"[http] the server took {start_s:.1f} s to its port (import, "
         f"load, warm-up {stats['warmup_s']} s); alexnet1 answers bit for "
         f"bit the in-process engine's; the crashed batch answered 500, "
         f"/healthz 503 with Retry-After {recovering[1]} s, then 200 after "
         f"{healed_s:.2f} s; 400 and 404 where due; /stats: crashes "
         f"{tel['dispatcher_crashes']}, restarts "
         f"{tel['dispatcher_restarts']}, cache misses {cache['misses']} "
         f"of {cache['entries']} runners (frozen), hits {cache['hits']}; "
         f"graph pools {pools} bytes; exit 0 on SIGINT in "
         f"{time.perf_counter() - t0:.1f} s in all; {last}")
    return {"start_s": start_s, "healed_s": healed_s, "pool_bytes": pools,
            "launches": {"lrn_forward_f32": launches["lrn_forward_f32"],
                         "nms_sweep": launches["nms_sweep"]},
            "obs": obs_readings}


def _http_obs_checks(obs: Path, prof: Path, runners: dict) -> dict:
    """The HTTP server's observability: its spool (``trace-spool-http-*``)
    holds the answered batches' ``device`` spans and the traced request's
    ``replica_queue`` and ``postprocess`` under ``HTTP_TRACE``; the crash
    left ``flightrec-http-dispatcher_crash-*.json``, whose ring holds the
    spans before it and whose snapshot counts the crash; the profiler's
    Chrome trace of the session, started after the warm-up, holds
    ``lrn_forward_kernel<float`` events at 2 a ``alexnet1`` replay, for
    every replay of the session (the runners' calls)."""
    from deepvision_tpu_torch.obs.distributed import read_spool

    (spool,) = obs.glob("trace-spool-http-*.jsonl")
    events = read_spool(spool)["events"]
    names = [e["name"] for e in events]
    traced = sorted(e["name"] for e in events
                    if (e.get("args") or {}).get("trace") == HTTP_TRACE)
    assert names.count("device") == 4, names
    assert traced == ["postprocess", "replica_queue"], traced
    (dump,) = obs.glob("flightrec-http-dispatcher_crash-*.json")
    body = json.loads(dump.read_text())
    ring = [e["name"] for e in body["events"] if e["kind"] == "span"]
    assert ring.count("device") == 2, ring
    assert body["snapshot"]["serve_dispatcher_crashes"] == 1, body[
        "snapshot"]
    replays = sum(b["calls"] for b in runners["alexnet1"][
        "buckets"].values())
    trace = json.loads((prof / "session.pt.trace.json").read_text())
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    lrn = [e for e in kernels
           if DEVICE_KERNELS["lrn_forward_f32"] in e.get("name", "")]
    nms = [e for e in kernels
           if DEVICE_KERNELS["nms_sweep"] in e.get("name", "")]
    _say(f"[http] observability: spool {spool.stat().st_size} bytes "
         f"({len(events)} spans: {dict((n, names.count(n)) for n in set(names))}"
         f"), the crash's dump {dump.name} holding {len(ring)} spans; the "
         f"session's profile {len(kernels)} kernel events, "
         f"{len(lrn)} of lrn_forward_kernel<float for {replays} alexnet1 "
         f"replays, {len(nms)} of nms_sweep_kernel")
    assert replays == 2 and len(lrn) == 2 * replays, (
        "the profile of the serving session lacks the LRN kernel's "
        f"launches: {len(lrn)} events for {replays} replays")
    return {"spool_bytes": spool.stat().st_size, "spans": len(events),
            "dump_spans": len(ring), "profile_kernels": len(kernels),
            "profile_lrn_forward_f32": len(lrn),
            "profile_nms_sweep": len(nms), "alexnet1_replays": replays}


def _http_yolo_check(http: list, engine: list) -> None:
    """The HTTP server's ``yolov3`` answers against the in-process
    engine's at bucket 1 for the same inputs: the same classes and as
    many boxes, boxes and scores within 1e-4 (the in-process engine
    captured its graphs under cuDNN's deterministic algorithms, the
    server under its default ones)."""
    for got, want in zip(http, engine):
        assert got["classes"] == want["classes"], (got, want)
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                       np.asarray(want[key], np.float64),
                                       atol=1e-4, err_msg=key)
    _say(f"[http] yolov3's {len(http)} answers match the in-process "
         f"engine's (boxes and scores within 1e-4; bit for bit: "
         f"{_same_bits(http, engine)})")


def _fleet_replicas(tmp: Path) -> dict[str, int]:
    """The fleet's replicas that have written their port file, by slot
    id (``ProcessReplica`` writes its child's under
    ``$TMPDIR/dvt-replica-<sid>-*/``)."""
    out = {}
    for d in sorted(tmp.glob("dvt-replica-*")):
        port = d / "port"
        if port.exists() and port.read_text().strip():
            out[d.name.split("-")[2]] = int(port.read_text())
    return out


def _children(pid: int) -> list[int]:
    """The live processes whose parent is ``pid``, from ``/proc``."""
    out = []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(stat.parent.name))
    return sorted(out)


def _card_files(pid: int) -> int:
    """How many of ``pid``'s open files are the card's device files
    (``/dev/nvidia*``): none until the process initializes CUDA."""
    n = 0
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            n += os.readlink(fd).startswith("/dev/nvidia")
        except OSError:
            continue
    return n


def _verified_store(store: Path) -> dict[str, str]:
    """The store's manifest entries, each blob read back against its
    recorded size and SHA-256, by ``model@bucket``; asserts nothing is
    quarantined."""
    import hashlib

    entries = json.loads((store / "manifest.json").read_text())["entries"]
    out = {}
    for e in entries.values():
        data = (store / e["file"]).read_bytes()
        assert len(data) == e["size"], e
        assert hashlib.sha256(data).hexdigest() == e["sha256"], e
        out[f"{e['model']}@{e['bucket']}"] = f"{len(data) / 1e6:.1f} MB"
    quarantine = store / "quarantine"
    assert not quarantine.exists() or not any(quarantine.iterdir()), \
        sorted(quarantine.iterdir())
    return dict(sorted(out.items()))


def _stream_frames() -> np.ndarray:
    """The stream drill's frames, ``(streams, STREAM_FRAMES, 416, 416,
    3)``: stream k drifts linearly from ``yolov3``'s request 2k to request
    2k + 1, scaled to ``PIPE_AMPLITUDE``."""
    reqs = _yolo_requests()
    t = np.linspace(0, 1, STREAM_FRAMES, dtype=np.float32)[:, None, None,
                                                            None]
    return np.stack([
        PIPE_AMPLITUDE * ((1 - t) * reqs[2 * k] + t * reqs[2 * k + 1])
        for k in range(len(STREAM_SIDS))]).astype(np.float32)


def _stream_reference(frames: np.ndarray, snapshots: Path) -> tuple:
    """The stream drill's yardstick in process: seeded ``yolov3`` (416,
    score 0.5, as the fleet's replicas serve it) behind a
    ``TrackingPipeline`` (detector every ``STREAM_K``-th frame) on bucket 1,
    the streams' frames one at a time, interleaved. Its warm-up and traffic
    take ``CARD_COUNTS``; the counts are zeroed after the warm-up and read
    after the traffic: 1 ``nms_sweep`` a detect+update replay and none an
    advance replay. Then each program's replay at bucket 1 is timed (CUDA
    events, median of 20; raw replays, no launch counted). -> (answers by
    session id, readings)."""
    from deepvision_tpu_torch.serve import InferenceEngine, load_served
    from deepvision_tpu_torch.serve.sessions import (
        SessionStore,
        TrackingPipeline,
    )
    from deepvision_tpu_torch.timing import time_ms

    det = load_served("yolov3", seed=0)
    store = SessionStore(snapshot_dir=snapshots,
                         snapshot_every=STREAM_SNAPSHOT_EVERY)
    track = TrackingPipeline("track", det, store, detect_every=STREAM_K)
    answers = {sid: [] for sid in STREAM_SIDS}
    with CARD_COUNTS:
        t0 = time.perf_counter()
        eng = InferenceEngine([track], buckets=(1,), freeze_cache=True)
        warm_s = time.perf_counter() - t0
        with eng:
            _zero_launch_counts()
            for i in range(STREAM_FRAMES):
                for k, sid in enumerate(STREAM_SIDS):
                    answers[sid].append(eng.submit(
                        frames[k][i], model="track", session=sid,
                        seq=i).result(timeout=300))
            nms, lrn = _nms_launches(), sum(_launch_counts().values())
            (runner,) = [r for key, r in eng._cache.items()
                         if key[0] == "track"]
            calls = {"detect": runner.detect.calls - 1,  # the warm-up's
                     "advance": runner.advance.calls}
            per_replay = {"detect": dict(runner.detect.launches),
                          "advance": dict(runner.advance.launches)}
            device_ms = {
                mode: round(time_ms(lambda _, g=prog._graph: g.replay(),
                                    [None], iters=20, warmup=3), 4)
                for mode, prog in (("detect", runner.detect),
                                   ("advance", runner.advance))}
            counters = eng.stats()["sessions"]["track"]["counters"]
    detect_frames = len(STREAM_SIDS) * len(range(0, STREAM_FRAMES, STREAM_K))
    assert calls == {"detect": detect_frames,
                     "advance": len(STREAM_SIDS) * STREAM_FRAMES
                     - detect_frames}, calls
    assert per_replay == {"detect": {"nms_sweep": 1}, "advance": {}}, \
        per_replay
    assert nms == calls["detect"] and lrn == 0, (nms, lrn)
    assert counters["resets"] == 0 and counters["restores"] == 0, counters
    return answers, {"warmup_s": round(warm_s, 3), "nms_launches": nms,
                     "replays": calls, "launches_per_replay": per_replay,
                     "device_ms_bucket1": device_ms}


def _stream_checks(got: dict, want: dict) -> None:
    """The fleet's stream answers against the in-process yardstick's: every
    frame answered in order and without a reset, its ``boxes``, ``scores``
    and ``tracked`` bit for bit the yardstick's (and ``detected``), live
    tracks on detect and on interpolated frames, every box finite."""
    for sid in STREAM_SIDS:
        assert [r["seq"] for r in got[sid]] == list(range(STREAM_FRAMES))
        for i, (g, w) in enumerate(zip(got[sid], want[sid])):
            assert g["session"] == sid and g["state_reset"] is False, g
            assert g["detected"] == w["detected"] == (i % STREAM_K == 0)
            for key in ("boxes", "scores", "tracked"):
                assert g[key] == w[key], (sid, i, key, g[key], w[key])
            assert any(g["tracked"]), (sid, i, g)
            assert np.isfinite(np.asarray(g["boxes"])).all(), (sid, i, g)


def phase_fleet(workdir: Path, alexnet_xs: np.ndarray, alexnet: list,
                yolo_xs: np.ndarray, yolo: list) -> dict:
    """The serving fleet as a user starts it: ``python -m
    deepvision_tpu_torch.serve --fleet 2 -m alexnet1 -m yolov3 --buckets
    1,4 --http 0 --port-file F --store DIR --hedge-after FLEET_HEDGE_S
    --faults FLEET_FAULTS`` (seeded weights, a fresh store). The router
    process must hold no card file (``/dev/nvidia*``) open, each replica
    must. Requests go through the router one at a time, then in
    concurrent pairs: the third request's replica is SIGKILLed
    (``replica_kill``) and the request answered by failover; the router
    respawns the replica, which warms every model's runner from the store
    the first generation filled (0 traced; its 2 cache misses are the
    tracker's buckets, never stored); the first
    request after the respawn is delayed ``FLEET_SLOW_S``
    (``replica_slow``) and hedged to the other replica, which answers,
    once. Every ``alexnet1`` answer equals the
    in-process engine's at bucket 1 bit for bit, every ``yolov3`` one
    passes :func:`_http_yolo_check`. ``/stats``: a failover, one death,
    one restart, a hedge won, nothing failed; ``/healthz`` two ready
    replicas; ``/metrics`` the ``router_*`` families and each replica's
    ``serve_*`` counters under ``replica="rN"``, equal to the replicas'
    own ``/stats``; each replica's runners a CUDA graph a bucket with 2
    ``lrn_forward_f32`` (``alexnet1``) and 1 ``nms_sweep`` (``yolov3``)
    a replay; the store one verified blob a key and nothing quarantined.
    Then the stream drill (``--track yolov3:STREAM_K --session-dir
    <root>/sessions --snapshot-every STREAM_SNAPSHOT_EVERY``): the 2
    streams' ``STREAM_FRAMES`` frames (:func:`_stream_frames`) go through
    the router one at a time, interleaved (``POST /v1/predict`` with
    ``session`` and ``seq``), each stream pinned to its own replica; the
    first stream's frame ``STREAM_KILL_FRAME`` SIGKILLs its replica
    (``replica_kill``), which holds the stream's state past its newest
    snapshot, so that the router re-pins the stream to the survivor and
    replays the stream's earlier frames, the survivor restoring the
    snapshot of seq 3 and answering seqs 0-3 as duplicates. After the
    second respawn: every frame answered in order without a reset, bit for
    bit the in-process yardstick's (:func:`_stream_reference`,
    :func:`_stream_checks`); one migration, no reset, 2 deaths, 2
    restarts; each replica's ``track`` runners a CUDA graph pair a bucket,
    1 ``nms_sweep`` a detect replay and none an advance replay. The checks
    of the first kill read the fleet before the drill; ``/metrics`` and the
    launches are read after it. SIGTERM ends the router with 143 after its
    exit line (its flight recorder's dump first) and its children with
    143, each after its ``[serve]`` line. Every process spools its spans
    under ``--trace-spool <root>/obs``: :func:`_fleet_trace_checks`.
    Returns the live replicas' true kernel launches (their ``/stats``; the
    killed replicas' are lost with them), the yardstick's NMS launches and
    the readings."""
    import concurrent.futures

    import torch

    from deepvision_tpu_torch.obs.distributed import parse_prometheus

    t_phase = time.perf_counter()
    root = workdir / "fleet"
    shutil.rmtree(root, ignore_errors=True)
    tmp, store, obs = root / "tmp", root / "aot", root / "obs"
    tmp.mkdir(parents=True)
    port_file, log = root / "router.port", root / "router.log"
    cmd = [sys.executable, "-m", "deepvision_tpu_torch.serve", "--fleet",
           "2", "-m", "alexnet1", "-m", "yolov3", "--buckets", "1,4",
           "--http", "0", "--port-file", str(port_file), "--store",
           str(store), "--hedge-after", str(FLEET_HEDGE_S), "--faults",
           FLEET_FAULTS, "--track", f"yolov3:{STREAM_K}", "--session-dir",
           str(root / "sessions"), "--snapshot-every",
           str(STREAM_SNAPSHOT_EVERY), "--trace-spool", str(obs)]
    inputs = {"alexnet1": alexnet_xs, "yolov3": yolo_xs}
    answers: list[tuple[str, int, tuple]] = []  # (model, input, reply)

    def ask(port: int, model: str, i: int) -> tuple:
        reply = _http(port, "POST", "/v1/predict",
                      _b64_request(model, inputs[model][i]))
        answers.append((model, i, reply))
        return reply

    def get(port: int, path: str):
        code, _, body = _http(port, "GET", path)
        assert code == 200, (path, code, body[:2000])
        return body if path == "/metrics" else json.loads(body)

    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err,
            env={**os.environ, "PYTHONPATH": str(ROOT), "TMPDIR": str(tmp)})
    try:
        # the yardstick runs while the replicas warm up
        frames = _stream_frames()
        reference, stream_readings = _stream_reference(
            frames, root / "reference-sessions")
        while not port_file.exists():
            assert proc.poll() is None, _log_text(log)[-4000:]
            assert time.perf_counter() - t0 < 600, _log_text(log)[-4000:]
            time.sleep(0.1)
        start_s = time.perf_counter() - t0
        port = int(port_file.read_text())
        first = {sid: get(p, "/stats")
                 for sid, p in _fleet_replicas(tmp).items()}
        kids = _children(proc.pid)
        card_files = {pid: _card_files(pid) for pid in [proc.pid, *kids]}
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        free_before = torch.cuda.mem_get_info()[0]
        ask(port, "alexnet1", 0)
        ask(port, "yolov3", 0)
        ask(port, "alexnet1", 1)  # its replica is SIGKILLed
        ask(port, "yolov3", 1)
        t_kill = time.perf_counter()
        while get(port, "/healthz")["replicas_ready"] < 2:
            assert time.perf_counter() - t_kill < 300, \
                _log_text(log)[-4000:]
            time.sleep(0.1)
        respawn_s = time.perf_counter() - t_kill
        free_after = torch.cuda.mem_get_info()[0]
        t_hedge = time.perf_counter()
        ask(port, "alexnet1", 0)  # delayed, hedged
        hedged_s = time.perf_counter() - t_hedge
        while any(r["inflight"] for r in get(port, "/stats")["replicas"]):
            assert time.perf_counter() - t_hedge < 60
            time.sleep(0.05)
        # concurrent pairs reach both replicas (least in flight first)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for k in range(FLEET_PAIRS):
                list(pool.map(lambda m, k=k: ask(port, m, k % 2),
                              ("alexnet1", "yolov3")))
        # the first kill's checks read the fleet as it is now
        stats = get(port, "/stats")
        health = get(port, "/healthz")
        live = _fleet_replicas(tmp)
        ids = {r["id"] for r in stats["replicas"]}
        replicas = {sid: get(p, "/stats") for sid, p in live.items()
                    if sid in ids}
        pins_before = {}
        streams = {sid: [] for sid in STREAM_SIDS}
        for i in range(STREAM_FRAMES):
            for k, sid in enumerate(STREAM_SIDS):
                if k == 0 and i == STREAM_KILL_FRAME:
                    pins_before = get(port, "/stats")["sessions"]["pins"]
                    t_kill2 = time.perf_counter()
                code, _, body = _http(port, "POST", "/v1/predict", {
                    **_b64_request("track", frames[k][i]),
                    "session": sid, "seq": i})
                assert code == 200, (sid, i, code, body[:2000])
                streams[sid].append(json.loads(body)["result"])
        while (get(port, "/healthz")["replicas_ready"] < 2
               or get(port, "/stats")["telemetry"]["replica_restarts"]
               < 2):
            assert time.perf_counter() - t_kill2 < 300, \
                _log_text(log)[-4000:]
            time.sleep(0.1)
        respawn2_s = time.perf_counter() - t_kill2
        end = get(port, "/stats")
        end_health = get(port, "/healthz")
        metrics = get(port, "/metrics").decode()
        live = _fleet_replicas(tmp)
        end_ids = {r["id"] for r in end["replicas"]}
        end_replicas = {sid: get(p, "/stats") for sid, p in live.items()
                        if sid in end_ids}
        # the spools and the flight recorder opened no card file either
        router_card_files_end = _card_files(proc.pid)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(180)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
    text = _log_text(log)
    assert rc == 143, text[-4000:]
    assert router_card_files_end == 0, router_card_files_end
    # the router holds no card file, every replica does. (nvidia-smi's
    # compute apps, printed, cannot tell: in a container it may give
    # every process's pid as the host's or as 1)
    assert card_files[proc.pid] == 0, card_files
    assert len(kids) == 2 and all(card_files[k] > 0 for k in kids), \
        card_files
    for model, i, (code, _, body) in answers:
        assert code == 200, (model, i, code, body[:2000])
    alex = [(i, json.loads(b)["result"]) for m, i, (_, _, b) in answers
            if m == "alexnet1"]
    gaps = [(i, r["classes"] == alexnet[i]["classes"], float(np.abs(
        np.asarray(r["probs"]) - np.asarray(alexnet[i]["probs"])).max()))
        for i, r in alex]
    assert _same_bits([r for _, r in alex], [alexnet[i] for i, _ in alex]), (
        "the fleet's alexnet1 answers differ from the in-process engine's "
        f"at bucket 1: (input, same classes, max |probs gap|) {gaps}")
    yolos = [(i, json.loads(b)["result"]) for m, i, (_, _, b) in answers
             if m == "yolov3"]
    _http_yolo_check([r for _, r in yolos], [yolo[i] for i, _ in yolos])
    tel = stats["telemetry"]
    n = len(answers)
    assert tel["failovers"] >= 1 and tel["replica_deaths"] == 1, tel
    assert tel["replica_restarts"] == 1, tel
    assert tel["hedges"] >= 1 and tel["hedge_wins"] >= 1, tel
    assert (tel["completed"], tel["failed"], tel["requests"]) == (n, 0, n), tel
    assert health["replicas_ready"] == 2 and health["status"] == "ok", health
    assert hedged_s < FLEET_SLOW_S, hedged_s
    # the first generation traced and filled the store, concurrently;
    # the respawn warmed every runner from it
    runners = [f"{m}@{b}" for m in ("alexnet1", "yolov3") for b in (1, 4)]
    assert sorted(first) == ["r1", "r2"], sorted(first)
    traced = {sid: sorted(set(runners) - set(st["warmed_from_store"]))
              for sid, st in first.items()}
    assert set().union(*traced.values()) == set(runners), traced
    blobs = _verified_store(store)
    assert list(blobs) == runners, blobs
    (old,) = ids - {"r3"}
    assert ids == {old, "r3"} and sorted(replicas) == sorted(ids), (
        ids, replicas.keys())
    respawned = replicas["r3"]
    assert respawned["warmed_from_store"] == runners, respawned
    # the stateful tracker's runners are built, never stored: a miss a
    # bucket
    assert respawned["cache"]["misses"] == 2, respawned["cache"]
    assert respawned["cache"]["entries"] == len(runners) + 2
    assert respawned["artifact_store"]["quarantined"] == 0
    # the stream drill: the first stream re-pinned on its frame
    # STREAM_KILL_FRAME with its earlier frames replayed, the survivor
    # restoring the seq-3 snapshot (seqs 0-3 duplicates)
    _stream_checks(streams, reference)
    lead, other = STREAM_SIDS
    assert pins_before[lead] != pins_before[other], pins_before
    moved = re.findall(r"\[router\] session (\S+) re-pinned to (r\d+) "
                       r"\(replaying (\d+) frame\(s\)\)", text)
    assert moved == [(lead, pins_before[other],
                      str(STREAM_KILL_FRAME))], moved
    etel = end["telemetry"]
    n_all = n + len(STREAM_SIDS) * STREAM_FRAMES
    assert (etel["sessions_migrated"], etel["session_resets"]) == (1, 0), etel
    assert (etel["replica_deaths"], etel["replica_restarts"]) == (2, 2), etel
    assert (etel["completed"], etel["failed"], etel["requests"]) == (
        n_all, 0, n_all), etel
    assert end_health["replicas_ready"] == 2, end_health
    assert pins_before[lead] not in end_ids, (pins_before, end_ids)
    counters = [st["sessions"]["track"]["counters"]
                for st in end_replicas.values()]
    assert sum(c["restores"] for c in counters) == 1, counters
    assert sum(c["duplicates"] for c in counters) == 4, counters
    assert sum(c["resets"] for c in counters) == 0, counters
    # federated: the router's families, and each replica's counters under
    # its label summing to the replicas' own
    fed = parse_prometheus(metrics)
    assert fed["router_completed_total"] == [({}, float(n_all))], \
        fed.get("router_completed_total")
    assert fed["router_hedge_wins_total"][0][1] >= 1
    for counter in ("completed", "batches", "failed"):
        per = {labels.get("replica"): v
               for labels, v in fed[f"serve_{counter}_total"]}
        own = {sid: float(st["telemetry"][counter])
               for sid, st in end_replicas.items()}
        assert per == {**own, None: sum(own.values())}, (counter, per, own)
    launches, stream_replays = {}, {}
    for sid, st in end_replicas.items():
        for name, per in (("alexnet1", {"lrn_forward_f32": 2}),
                          ("yolov3", {"nms_sweep": 1}),
                          ("track", {"nms_sweep": 1})):
            r = st["runners"][name]
            assert r["kind"] == "cuda_graph", r
            assert all(b["launches"] == per for b in r["buckets"].values()), r
        track = st["runners"]["track"]["buckets"]
        assert all(b["advance_launches"] == {} for b in track.values())
        # replays past each bucket's warm-up zero run
        stream_replays[sid] = {
            "detect": sum(b["calls"] - 1 for b in track.values()),
            "advance": sum(b["advance_calls"] for b in track.values())}
        k = st["kernel_launches"]
        assert k["lrn_forward_f32"] > 0 and k["lrn_forward_f32"] % 2 == 0, k
        assert k["nms_sweep"] > 0, k
        launches[sid] = {"lrn_forward_f32": k["lrn_forward_f32"],
                         "nms_sweep": k["nms_sweep"]}
    assert replicas["r3"]["telemetry"]["completed"] >= 1, replicas["r3"]
    # the survivor ran its own stream (3 detect frames, 9 advance) and the
    # migrated one from the seq-3 snapshot on: seqs 4 (replayed) and 8
    # detect, 5 (replayed), 6, 7, 9, 10, 11 advance; the fresh respawn none
    assert {k: sum(v[k] for v in stream_replays.values())
            for k in ("detect", "advance")} == {"detect": 5,
                                                "advance": 15}, \
        stream_replays
    # SIGTERM: the router stopped its children by SIGTERM, 143 each, after
    # their [serve] lines
    stopped = re.findall(r"\[router\] replica (r\d+) \(pid \d+\) stopped: "
                         r"exit (-?\d+)", text)
    assert sorted(stopped) == sorted((sid, "143") for sid in end_ids), \
        stopped
    last = text.strip().splitlines()[-1]
    assert last.startswith("[router] failovers="), last
    assert "sessions_migrated=1 resets=0" in last, last
    for sid in end_ids:
        (child,) = tmp.glob(f"dvt-replica-{sid}-*/replica.log")
        tail = _log_text(child).strip().splitlines()[-1]
        assert tail.startswith("[serve] completed="), (sid, tail)
    trace = _fleet_trace_checks(
        obs, {sid: st["telemetry"]["completed"]
              for sid, st in end_replicas.items()}, pins_before)
    warm = {sid: st["warmup_s"] for sid, st in first.items()}
    readings = {
        "start_s": round(start_s, 1), "respawn_s": round(respawn_s, 1),
        "hedged_s": round(hedged_s, 2), "warmup_s": warm,
        "respawn_warmup_s": respawned["warmup_s"],
        "traced_by_first_generation": traced, "store": blobs,
        "free_gib_before_kill": round(free_before / 2**30, 2),
        "free_gib_after_respawn": round(free_after / 2**30, 2),
        "card_files": {("router" if pid == proc.pid else str(pid)): v
                       for pid, v in card_files.items()},
        "compute_apps": apps.splitlines(), "launches_by_replica": launches,
        "telemetry": {k: tel[k] for k in (
            "requests", "completed", "failed", "failovers", "hedges",
            "hedge_wins", "replica_deaths", "replica_restarts")},
        "streams": {
            "frames": len(STREAM_SIDS) * STREAM_FRAMES,
            "migrations": etel["sessions_migrated"],
            "resets": etel["session_resets"],
            "respawn_s": round(respawn2_s, 1),
            "pins_before_kill": pins_before,
            "replicas_after": sorted(end_ids),
            "session_counters": {sid: st["sessions"]["track"]["counters"]
                                 for sid, st in end_replicas.items()},
            "replays_by_replica": stream_replays,
            "telemetry": {k: etel[k] for k in (
                "requests", "completed", "failed", "failovers",
                "replica_deaths", "replica_restarts")},
            "reference": stream_readings},
        "trace": trace}
    _say(f"[fleet] {json.dumps(readings)}")
    _say(f"[fleet] the router ({start_s:.1f} s to its port, both replicas "
         f"warm) held no card file, each replica's process did; {n} "
         f"requests answered, alexnet1 bit for bit the in-process engine's; "
         f"the killed replica's request failed over, its replacement warmed "
         f"all {len(runners)} runners from the store in "
         f"{respawned['warmup_s']} s against the first generation's "
         f"{warm} s (ready {respawn_s:.1f} s after the kill; free card "
         f"memory {free_before / 2**30:.2f} GiB before the kill, "
         f"{free_after / 2**30:.2f} after the respawn); the delayed request "
         f"answered by its hedge in {hedged_s:.2f} s; the {len(STREAM_SIDS)} "
         f"streams' {len(STREAM_SIDS) * STREAM_FRAMES} frames answered in "
         f"order without a reset, bit for bit the in-process yardstick's, "
         f"{lead} migrated off its SIGKILLed replica on frame "
         f"{STREAM_KILL_FRAME} (restored from the seq-3 snapshot, "
         f"{STREAM_KILL_FRAME} frames replayed), the respawn ready "
         f"{respawn2_s:.1f} s after that kill; a frame's device time at "
         f"bucket 1 {stream_readings['device_ms_bucket1']} ms; kernel "
         f"launches of the live replicas {launches} (the killed replicas' "
         f"are lost with them); SIGTERM: exit 143, children 143; the "
         f"merged trace: {trace['cross_process_requests']} requests across "
         f"processes, {trace['spool_bytes']} spool bytes, merged in "
         f"{trace['merge_s']} s; {last}; the phase took "
         f"{time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": {
        "lrn_forward_f32": sum(v["lrn_forward_f32"]
                               for v in launches.values()),
        "nms_sweep": sum(v["nms_sweep"] for v in launches.values())},
        "stream_reference_nms": stream_readings["nms_launches"],
        **readings}


def _fleet_trace_checks(obs: Path, completed: dict, pins: dict) -> dict:
    """The fleet's spools and dumps under ``obs``, merged by the port's
    merger as a user runs it (``python -m
    deepvision_tpu_torch.obs.trace_merge obs --assert-flow --assert-spans
    router_attempt,replica_queue,device,postprocess``): it exits 0; at
    least one request's flow crosses from the router's row into a
    replica's; each stream's session is on a replica's ``replica_queue``
    span, and the migrated stream's on the spools of two replicas, the
    SIGKILLed pin's (read up to its kill, past a torn tail if the kill
    tore one) and the survivor's; each replica that the router stopped by
    SIGTERM (``completed``: its answered requests by slot id) left
    ``flightrec-rN-signal-15-*.json`` with its registry (that count) and
    its last spans, if it answered any; the router's dump holds its ``router_attempt``
    spans and its ``note:probe`` notes. -> the readings (the spans by
    name, the flows, the spools' bytes, the merge's seconds)."""
    from deepvision_tpu_torch.obs.trace_merge import cross_process_requests

    out = obs / "trace_merged.json"
    t0 = time.perf_counter()
    merge = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.obs.trace_merge",
         str(obs), "-o", str(out), "--assert-flow", "--assert-spans",
         "router_attempt,replica_queue,device,postprocess"],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    merge_s = time.perf_counter() - t0
    assert merge.returncode == 0, merge.stdout[-3000:] + merge.stderr[-3000:]
    merged = json.loads(out.read_text())
    meta = merged["metadata"]
    # pid rows: a source each, in the order of the metadata's sources
    source = {i + 1: m for i, m in enumerate(meta["sources"])}
    spans: dict[str, int] = {}
    notes: dict[str, int] = {}
    stream_rows: dict[str, set] = {sid: set() for sid in STREAM_SIDS}
    router_dump_spans = 0
    for e in merged["traceEvents"]:
        src = source.get(e.get("pid"), {})
        role = (src.get("labels") or {}).get("role") or src.get("role")
        if e.get("ph") == "i" and role == "router":
            notes[e["name"]] = notes.get(e["name"], 0) + 1
        if e.get("ph") != "X":
            continue
        spans[e["name"]] = spans.get(e["name"], 0) + 1
        if src.get("kind") == "flightrec" and role == "router" \
                and e["name"] == "router_attempt":
            router_dump_spans += 1
        session = (e.get("args") or {}).get("session")
        if e["name"] == "replica_queue" and session in stream_rows \
                and src.get("kind") == "spool":
            stream_rows[session].add(role)
    crossing = cross_process_requests(merged)
    assert crossing >= 1, meta
    lead, other = STREAM_SIDS
    assert stream_rows[other] == {pins[other]}, (stream_rows, pins)
    assert stream_rows[lead] == {pins[lead], pins[other]}, (
        stream_rows, pins)
    killed = [p for p in obs.glob(f"trace-spool-{pins[lead]}-*.jsonl")]
    assert len(killed) == 1, killed
    raw = killed[0].read_bytes()
    torn = not raw.endswith(b"\n")
    dumps = {}
    for sid, n in completed.items():
        (path,) = obs.glob(f"flightrec-{sid}-signal-15-*.json")
        body = json.loads(path.read_text())
        ring = [e for e in body["events"] if e["kind"] == "span"]
        assert body["snapshot"]["serve_completed"] == n, (sid, n, body)
        assert bool(ring) == (n > 0), (sid, n, len(ring))
        dumps[sid] = len(ring)
    assert not list(obs.glob(f"flightrec-{pins[lead]}-*.json")), (
        "a SIGKILLed replica ran a dump handler")
    (router_dump,) = obs.glob("flightrec-router-signal-15-*.json")
    assert router_dump_spans > 0 and notes.get("note:probe", 0) > 0, (
        router_dump_spans, notes)
    assert spans.get("router_attempt", 0) > router_dump_spans, spans
    spool_bytes = {p.name: p.stat().st_size for p in obs.glob(
        "trace-spool-*.jsonl*")}
    readings = {
        "merge_s": round(merge_s, 3), "spans": spans, "notes": notes,
        "flows": meta["flow_count"], "traced_requests": meta["trace_count"],
        "cross_process_flows": meta["cross_process_flows"],
        "cross_process_requests": crossing,
        "sources": len(meta["sources"]),
        "spool_bytes": sum(spool_bytes.values()),
        "spool_bytes_by_file": spool_bytes,
        "killed_spool_torn_tail": torn,
        "dump_spans": dumps, "router_dump_spans": router_dump_spans,
        "stream_rows": {k: sorted(v) for k, v in stream_rows.items()}}
    _say(f"[fleet] the merged trace: {merge.stdout.strip().splitlines()[0]}"
         f"; spans by name {spans}; router notes {notes}; "
         f"{meta['flow_count']} flows, {crossing} requests from the "
         f"router's row into a replica's; {lead} on the spools of "
         f"{sorted(stream_rows[lead])} (the killed spool's tail torn: "
         f"{torn}); dumps of the SIGTERMed replicas {dumps}, the router's "
         f"{router_dump.name}; spools {sum(spool_bytes.values())} bytes; "
         f"merged in {merge_s:.3f} s")
    return readings


def _pipeline_specs(cls_size: int) -> list[dict]:
    """The two DAGs of ``phase_pipeline`` and the chains' serving CLI:
    ``detpose``, ``yolov3`` -> the top ``PIPE_K`` boxes of class
    ``PIPE_PERSON`` -> 256 px crops -> ``hourglass104``, and ``detcls``,
    ``yolov3`` -> the top ``PIPE_K`` boxes -> ``cls_size`` crops ->
    ``alexnet1``; each stage chunked through ``PIPE_LADDER``."""

    def spec(name, people, size, model, stage):
        return {"name": name, "buckets": list(PIPE_BUCKETS), "nodes": [
            {"name": "det", "model": "yolov3"},
            {"name": "people", "glue": "top_k_boxes", "inputs": ["det"],
             "params": people},
            {"name": "crop", "glue": "crop_resize",
             "inputs": ["input", "people"], "params": {"size": size}},
            {"name": stage, "model": model, "inputs": ["crop.crops"],
             "buckets": PIPE_LADDER}],
            "outputs": [{"node": "det"}, {"node": stage,
                                          "mask": "crop.valid"}]}

    return [spec("detpose", {"k": PIPE_K, "class_id": PIPE_PERSON},
                 POSE_SIZE, "hourglass104", "pose"),
            spec("detcls", {"k": PIPE_K}, cls_size, "alexnet1", "cls")]


def _pipeline_requests(n: int, seed: int = 0) -> np.ndarray:
    return (PIPE_AMPLITUDE * np.random.default_rng(seed).normal(
        size=(n, YOLO_SIZE, YOLO_SIZE, 3))).astype(np.float32)


def _host_crops(x: np.ndarray, det: dict, size: int,
                class_id: int | None) -> tuple[np.ndarray, np.ndarray]:
    """The sequential client's glue: the top ``PIPE_K`` boxes of a detect
    answer by score (of ``class_id`` only: the others score 0), in a
    stable descending sort (``top_k_boxes``' order), cut from ``x`` by the
    plain ``crop_and_resize`` on this machine's CPU. -> (the ``PIPE_K``
    crops, which of them a client keeps: a score above 0). With a score
    threshold of 0 every one of the detector's 100 slots is kept, so the
    answer's boxes are its slots in order, as the DAG sees them."""
    import torch

    from deepvision_tpu_torch.ops.crop_resize import crop_and_resize

    scores = np.asarray(det["scores"], np.float32)
    assert len(scores) >= PIPE_K, len(scores)
    if class_id is not None:
        scores = scores * (np.asarray(det["classes"]) == class_id)
    order = np.argsort(-scores, kind="stable")[:PIPE_K]
    boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)[order]
    crops = crop_and_resize(torch.from_numpy(x[None]),
                            torch.from_numpy(boxes[None]), size)[0].numpy()
    return crops, scores[order] > 0


def _glue_on_card(det, xs: np.ndarray, cls_size: int) -> float:
    """``top_k_boxes`` (both DAGs' parameters) and ``crop_resize`` on the
    card against the same functions on this machine's CPU, on one batch
    of the card's detections: -> the largest gap (held to 1e-6)."""
    import torch

    from deepvision_tpu_torch.export import TensorSpec
    from deepvision_tpu_torch.serve import pipeline

    with torch.inference_mode():
        x = torch.from_numpy(xs).cuda()
        out = det.forward(x)
    avals = [{k: TensorSpec(tuple(v.shape), v.dtype)
              for k, v in out.items()}]
    gaps = []
    for people, size in (({"k": PIPE_K, "class_id": PIPE_PERSON},
                          POSE_SIZE), ({"k": PIPE_K}, cls_size)):
        top_k, _ = pipeline._GLUE["top_k_boxes"](people, avals)
        with torch.inference_mode():
            card = top_k(out)
            cpu = top_k({k: v.cpu() for k, v in out.items()})
            sel_avals = [TensorSpec(tuple(x.shape), x.dtype),
                         {k: TensorSpec(tuple(v.shape), v.dtype)
                          for k, v in card.items()}]
            crop, _ = pipeline._GLUE["crop_resize"]({"size": size},
                                                    sel_avals)
            crops_card = crop(x, card)
            crops_cpu = crop(x.cpu(), {k: v.cpu() for k, v in card.items()})
        assert torch.equal(card["valid"].cpu(), cpu["valid"])
        assert torch.equal(crops_card["valid"].cpu(), crops_cpu["valid"])
        for a, b in ((card["boxes"], cpu["boxes"]),
                     (card["scores"], cpu["scores"]),
                     (crops_card["crops"], crops_cpu["crops"])):
            a = a.cpu()
            finite = torch.isfinite(b)
            assert torch.equal(finite, torch.isfinite(a))
            assert torch.equal(a[~finite], b[~finite])
            gaps.append(float((a[finite] - b[finite]).abs().max())
                        if finite.any() else 0.0)
    gap = max(gaps)
    assert gap <= 1e-6, gaps
    return gap


def _dag_times(eng, name: str, xs: np.ndarray) -> dict:
    """At entry bucket 4: the DAG runner's replay alone on the card
    (median of CUDA events around ``PIPE_TIMED`` replays) and its call
    on the host (copy in, replay, copy out: median wall)."""
    import torch

    runner = eng._bucket_runner(eng._models[name], PIPE_BUCKETS[-1])
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(PIPE_TIMED)]
    runner(xs)
    walls = []
    for _ in range(PIPE_TIMED):
        t0 = time.perf_counter()
        runner(xs)
        walls.append((time.perf_counter() - t0) * 1e3)
    for start, end in events:
        start.record()
        runner._graph.replay()
        end.record()
    torch.cuda.synchronize()
    return {"device_ms": statistics.median(s.elapsed_time(e)
                                           for s, e in events),
            "wall_ms": statistics.median(walls)}


def _sequential_times(eng, stage: str, size: int, class_id, xs) -> dict:
    """The sequential client of the same 4 images through the runners
    the front door uses: the detector's bucket-4 call, its answers
    decoded on the host, the host crops, then the stage's calls of up to
    4 crops. -> the replays' device time summed (CUDA events around each
    replay) and the client's host wall, medians over ``PIPE_TIMED``."""
    import torch

    det = eng._models["yolov3"]
    det_run = eng._bucket_runner(det, PIPE_BUCKETS[-1])
    stage_model = eng._models[stage]

    def client():
        host = det_run(xs)
        crops = np.concatenate([
            c[keep] for c, keep in (
                _host_crops(x, det.postprocess(host, i), size, class_id)
                for i, x in enumerate(xs))])
        runs = []
        for j in range(0, len(crops), PIPE_BUCKETS[-1]):
            chunk = crops[j:j + PIPE_BUCKETS[-1]]
            b = next(b for b in PIPE_BUCKETS if b >= len(chunk))
            run = eng._bucket_runner(stage_model, b)
            run(chunk)
            runs.append((run, len(chunk)))
        return runs

    runs = client()
    walls = []
    for _ in range(PIPE_TIMED):
        t0 = time.perf_counter()
        client()
        walls.append((time.perf_counter() - t0) * 1e3)
    device = []
    for _ in range(PIPE_TIMED):
        total = 0.0
        for run in [det_run] + [r for r, _ in runs]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run._graph.replay()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        device.append(total)
    return {"device_ms": statistics.median(device),
            "wall_ms": statistics.median(walls),
            "calls": 1 + len(runs)}


def phase_pipeline(smi: str) -> dict:
    """Pipeline serving as a user builds it in process: ``yolov3`` at 416
    (20 classes, seeded weights, score threshold 0), ``hourglass104`` at
    256 (16 joints) and ``alexnet1`` at 224, float32 (TF32 off, cuDNN
    deterministic), behind one ``InferenceEngine`` on buckets (1, 4) with
    the ``detpose`` and ``detcls`` DAGs (:func:`_pipeline_specs`) and
    ``freeze_cache=True``: each (DAG, entry bucket) one CUDA graph. With
    ``PIPE_K`` = 3, entry bucket 1 gives a padded stage chunk (3 rows to
    4) and entry bucket 4 two (8 and 4). Small-amplitude requests: each
    DAG answer bit for bit the eager DAG's at its entry bucket
    (``Pipeline.run``), and so its outputs before the decode, masked K
    slots included (seed-0 ``yolov3`` may keep no box of the person
    class, and the decode drops masked rows), two different batches at
    one bucket answering differently; the DAG deciding what the
    sequential client decides (:func:`_sequential_parity`: the detector
    through the front door at rtol 5e-3, the host's crops of its top-3
    boxes by the plain ``crop_and_resize``, each crop through the front
    door, every K slot's row: pose argmax joints equal and confidences to
    rtol 1e-4, ``alexnet1``'s top-5 classes equal); the glue on the card
    equal to its CPU version within 1e-6; cache misses flat and
    ``stats()["pipelines"]`` counting each request; each replay crediting
    1 ``nms_sweep`` and ``detcls``' 2 ``lrn_forward_f32`` a stage chunk
    (2 at entry bucket 1, 4 at 4), the counted window's launches equal to
    those. Prints, without gating, each DAG's device time and host wall a
    call at entry bucket 4 and the sequential client's. No profiler
    window (one on a worker thread lost the port's kernels). Returns the
    DAG traffic's launches and the readings."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import (
        InferenceEngine,
        Pipeline,
        PipelineSpec,
        load_served,
    )

    strict_fp32()
    deterministic = torch.backends.cudnn.deterministic
    # the same convolution algorithms in the graphs and the eager DAG, so
    # that they answer the same bits
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        det = load_served("yolov3", seed=0, score_thresh=0.0)
        pose = load_served("hourglass104", seed=0, input_size=POSE_SIZE)
        cls = load_served("alexnet1", seed=0)
        cls_size = cls.input_shape[0]
        models = {m.name: m for m in (det, pose, cls)}
        t_valid = time.perf_counter()
        pipes = [Pipeline(PipelineSpec.from_json(spec), models)
                 for spec in _pipeline_specs(cls_size)]
        valid_s = time.perf_counter() - t_valid
        load_s = t_valid - t0
        eng = InferenceEngine(list(models.values()), buckets=PIPE_BUCKETS,
                              pipelines=pipes, freeze_cache=True)
        with eng:
            out = _pipeline_traffic(eng, pipes, cls_size)
        out["reserved_after_close"] = _closed("pipelines")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out.update(load_s=round(load_s, 1), validate_s=round(valid_s, 3),
               phase_s=round(time.perf_counter() - t0, 1))
    _say(f"[pipeline] {json.dumps(out)}")
    _say(f"[pipeline] detpose and detcls served in process on {smi}: "
         f"models loaded in {load_s:.1f} s, both DAGs validated by shape "
         f"propagation in {valid_s:.3f} s, the engine warm in "
         f"{out['warmup_s']} s (the DAGs' captures "
         f"{out['dag_warmup_s']} s); {out['requests']} DAG requests "
         f"answered by graph replays bit for bit the eager DAGs', deciding "
         f"what the sequential client decides; the glue on the card within "
         f"{out['glue_gap']:.1e} of the CPU's; launches of the DAG traffic "
         f"{out['launches']}; at entry bucket 4 a DAG call "
         f"{ {k: v['dag'] for k, v in out['times'].items()} } against the "
         f"sequential client's "
         f"{ {k: v['sequential'] for k, v in out['times'].items()} } (ms); "
         f"{out['phase_s']} s in all")
    return out


def _pipeline_traffic(eng, pipes, cls_size: int) -> dict:
    """``phase_pipeline``'s checks on the warm engine."""
    stats = eng.stats()
    misses = stats["cache"]["misses"]
    runners = stats["runners"]
    for p in pipes:
        assert runners[p.name]["kind"] == "cuda_graph", runners[p.name]
    dag_warm = {p.name: round(sum(r["capture_s"] for r in runners[
        p.name]["buckets"].values()), 2) for p in pipes}
    xs = _pipeline_requests(1 + 1 + 2 * PIPE_BUCKETS[-1])
    four = PIPE_BUCKETS[-1]
    batches = [xs[0:1], xs[1:2], xs[2:2 + four], xs[2 + four:2 + 2 * four]]
    # the eager DAG's outputs, every K slot (masked ones too), and its
    # answers (masked rows dropped)
    eager_raw = {p.name: [p.run(_padded(xs, p.input_shape)) for xs in batches]
                 for p in pipes}
    eager = {p.name: [[p.postprocess(raw, i) for i in range(len(xs))]
                      for raw, xs in zip(eager_raw[p.name], batches)]
             for p in pipes}
    with CARD_COUNTS:
        _zero_launch_counts()
        for p in pipes:
            _graph_rounds(eng, p, batches, eager[p.name], model=p.name)
        launches = {"nms_sweep": _nms_launches(),
                    **{k: v for k, v in _launch_counts().items() if v}}
    stats = eng.stats()
    requests = sum(len(b) for b in batches)
    assert stats["cache"]["misses"] == misses, (misses, stats["cache"])
    assert stats["pipelines"] == {p.name: requests for p in pipes}, stats
    per_replay = {p.name: {b: r["launches"] for b, r in stats["runners"][
        p.name]["buckets"].items()} for p in pipes}
    assert per_replay == {
        "detpose": {"1": {"nms_sweep": 1}, "4": {"nms_sweep": 1}},
        "detcls": {"1": {"nms_sweep": 1, "lrn_forward_f32": 2},
                   "4": {"nms_sweep": 1, "lrn_forward_f32": 4}}}, per_replay
    # the eager DAGs were built last at entry bucket 4
    assert [p.last_chunk_plans for p in pipes] == [
        {"det": [(0, 4, 4)], stage: [(0, 8, 8), (8, 4, 4)]}
        for stage in ("pose", "cls")], [p.last_chunk_plans for p in pipes]
    replays = len(pipes) * len(batches)
    assert launches == {"nms_sweep": replays,
                        "lrn_forward_f32": 2 * (2 + 4)}, launches
    # the graphs' outputs before the decode, masked rows included, bit for
    # bit the eager DAG's (the decode drops masked rows: with seed-0
    # weights no box of the person class may be kept at all)
    for p in pipes:
        for xs, want in zip(batches, eager_raw[p.name], strict=True):
            got = eng._bucket_runner(p, _bucket(len(xs)))(xs)
            assert got.keys() == want.keys(), (got.keys(), want.keys())
            for k, w in want.items():
                g = got[k][:len(xs)]
                assert g.dtype == w.dtype and g.tobytes() == w[
                    :len(xs)].tobytes(), (p.name, len(xs), k)
    # the sequential client on the entry-bucket-4 batch of each DAG
    xs4 = batches[2]
    stages = {"detpose": ("pose", "hourglass104", POSE_SIZE, PIPE_PERSON),
              "detcls": ("cls", "alexnet1", cls_size, None)}
    valid = _sequential_parity(eng, pipes, xs4, stages)
    out = _pipeline_rest(eng, pipes, xs4, stages, cls_size, misses,
                         dag_warm, requests, launches, per_replay, valid)
    out["traced"] = _traced_dags(eng, pipes, batches, eager, per_replay)
    # the traced replays are the same path's
    out["launches"] = {k: v + out["traced"]["launches"].get(k, 0)
                       for k, v in launches.items()}
    return out


def _traced_dags(eng, pipes, batches: list, eager: dict,
                 per_replay: dict) -> dict:
    """Both DAGs traced, through the engine, with a span spool attached
    to the process's tracer (``SpanSpool``, as ``serve --trace-spool``
    attaches one): each of ``batches`` (entry buckets 1 and 4) with a
    trace id a request, then the entry-bucket-4 batch ``STAGE_TIMED``
    times more. Each answer is bit for bit the untraced eager DAG's (the
    graph is the same, traced or not); each batch's ``device`` span holds
    one ``stage:<node>`` span a node, in DAG order, one after another,
    the stages' sum within it; the window's launches (``CARD_COUNTS``)
    are those that the replays credit. The spool is detached before this
    returns. -> each DAG's stage ms at entry bucket 4 (medians of the
    ``STAGE_TIMED`` batches) beside its ``device`` span, the spool's bytes
    and the launches."""
    from deepvision_tpu_torch.obs.distributed import SpanSpool, read_spool

    d = ROOT / "build" / "chip_smoke_pipeline_obs"
    shutil.rmtree(d, ignore_errors=True)
    four = PIPE_BUCKETS[-1]
    runs = [(p, k, xs) for p in pipes for k, xs in enumerate(batches)]
    runs += [(p, 2, batches[2]) for p in pipes for _ in range(STAGE_TIMED)]
    spool = SpanSpool(d, role="pipeline")
    traced: list[tuple] = []
    try:
        with CARD_COUNTS:
            _zero_launch_counts()
            for n, (p, k, xs) in enumerate(runs):
                ids = [f"{n:08x}{i:08x}" for i in range(len(xs))]
                eng.pause()
                futs = [eng.submit(x, model=p.name, trace=t)
                        for x, t in zip(xs, ids)]
                eng.resume()
                got = [f.result(timeout=300) for f in futs]
                assert _same_bits(got, eager[p.name][k]), (
                    f"{p.name}: a traced answer differs from the untraced "
                    f"one at entry bucket {_bucket(len(xs))}")
                traced.append((p, len(xs), set(ids)))
            launches = {"nms_sweep": _nms_launches(),
                        **{k: v for k, v in _launch_counts().items() if v}}
        # the postprocess spans land after the answers
        ours = {t for _, _, ids in traced for t in ids}
        deadline = time.perf_counter() + 30
        while sum(e["name"] == "postprocess"
                  and e["args"]["trace"] in ours
                  for e in read_spool(spool.path)["events"]) < len(ours):
            assert time.perf_counter() < deadline
            time.sleep(0.05)
    finally:
        spool.close()
    events = [e for e in read_spool(spool.path)["events"]
              if set(e.get("args", {}).get("traces", ())) & ours
              or e.get("args", {}).get("trace") in ours]
    expected: dict[str, int] = {}
    for p, n, _ in traced:
        for k, v in per_replay[p.name][str(_bucket(n))].items():
            expected[k] = expected.get(k, 0) + v
    assert launches == expected, (launches, expected)
    stage_ms: dict[str, dict[str, list]] = {p.name: {} for p in pipes}
    device_ms: dict[str, list] = {p.name: [] for p in pipes}
    for p, n, ids in traced:
        dev = [e for e in events if e["name"] == "device"
               and set(e["args"].get("traces", ())) == ids]
        assert len(dev) == 1, (p.name, n, len(dev))
        dev = dev[0]
        stages = [e for e in events if e["name"].startswith("stage:")
                  and set(e["args"]["traces"]) == ids]
        nodes = [node.name for node in p._order]
        assert [e["name"] for e in stages] == [
            f"stage:{x}" for x in nodes], (p.name, stages)
        end = dev["ts"] + dev["dur"]
        last = dev["ts"]
        for e in stages:
            assert last <= e["ts"] + 1e-9 and e["ts"] + e["dur"] <= end, (
                p.name, n, e, dev)
            last = e["ts"] + e["dur"]
        assert sum(e["dur"] for e in stages) <= dev["dur"], (p.name, n)
        if n == four:
            device_ms[p.name].append(dev["dur"] * 1e3)
            for e in stages:
                stage_ms[p.name].setdefault(e["args"]["stage"], []).append(
                    e["dur"] * 1e3)
    out = {"stage_ms_bucket4": {
        name: {st: round(statistics.median(v), 4) for st, v in per.items()}
        for name, per in stage_ms.items()},
        "device_span_ms_bucket4": {
            name: round(statistics.median(v), 4)
            for name, v in device_ms.items()},
        "spool_bytes": spool.path.stat().st_size, "spans": len(events),
        "launches": launches}
    _say(f"[pipeline] traced through a spool ({out['spool_bytes']} bytes, "
         f"{len(events)} spans): every answer bit for bit the untraced one, "
         f"each node's stage:<node> span inside its batch's device span in "
         f"DAG order; at entry bucket 4 the stages' device ms "
         f"{out['stage_ms_bucket4']} in device spans of "
         f"{out['device_span_ms_bucket4']} ms (medians of "
         f"{len(device_ms[pipes[0].name])} batches); launches {launches}")
    shutil.rmtree(d, ignore_errors=True)
    return out


def _padded(xs: np.ndarray, shape: tuple) -> np.ndarray:
    """``xs`` padded with zero rows to its bucket."""
    out = np.zeros((_bucket(len(xs)), *shape), np.float32)
    out[:len(xs)] = xs
    return out


def _sequential_parity(eng, pipes, xs4: np.ndarray, stages: dict) -> dict:
    """Each DAG at entry bucket 4 on ``xs4`` against the sequential
    client: the DAG's detections against the detector's answers through
    the front door (one bucket-4 batch; rtol 5e-3); its K slots' mask
    against the host's top ``PIPE_K`` boxes (:func:`_host_crops`); and
    every K slot's stage row (masked ones too: the DAG computes them all)
    against the front door's answer to the host's crop of that box (pose
    argmax joints equal and confidences to rtol 1e-4, ``alexnet1``'s top-5
    classes equal). -> the slots a client keeps, by DAG."""
    four = PIPE_BUCKETS[-1]
    seq_det = _queued(eng, xs4, "yolov3")
    valid = {}
    for p in pipes:
        stage, model, size, class_id = stages[p.name]
        raw = eng._bucket_runner(p, four)(xs4)
        rows = {k.split("/", 1)[1]: v for k, v in raw.items()
                if k.startswith(stage + "/")}
        crops, kept = [], 0
        for i, d in enumerate(seq_det):
            a = p.postprocess(raw, i)
            assert a["det"]["classes"] == d["classes"], (p.name, i)
            for key in ("boxes", "scores"):
                np.testing.assert_allclose(
                    np.asarray(a["det"][key], np.float64),
                    np.asarray(d[key], np.float64), rtol=5e-3, atol=1e-6,
                    err_msg=f"{p.name} det {key}")
            mine, keep = _host_crops(xs4[i], d, size, class_id)
            assert keep.tolist() == raw[stage + "__mask"][i].tolist(), (
                p.name, i, keep, raw[stage + "__mask"][i])
            assert len(a[stage]) == int(keep.sum()), (p.name, i)
            crops.append(mine)
            kept += int(keep.sum())
        valid[p.name] = kept
        crops = np.concatenate(crops)
        seq = []
        for j in range(0, len(crops), four):
            seq += _queued(eng, crops[j:j + four], model)
        served = eng._models[model]
        for n, want in enumerate(seq):
            i, j = divmod(n, PIPE_K)
            got = served.postprocess({k: v[i] for k, v in rows.items()}, j)
            if stage == "pose":
                g, w = np.asarray(got["joints"]), np.asarray(want["joints"])
                np.testing.assert_array_equal(g[:, :2], w[:, :2])
                np.testing.assert_allclose(g[:, 2], w[:, 2], rtol=1e-4)
            else:
                assert got["classes"] == want["classes"], (i, j, got, want)
    return valid


def _pipeline_rest(eng, pipes, xs4, stages, cls_size, misses, dag_warm,
                   requests, launches, per_replay, valid) -> dict:
    """``phase_pipeline``'s glue check, its timings, the frozen misses
    once more, and its readings."""
    glue_gap = _glue_on_card(eng._models["yolov3"], xs4, cls_size)
    times = {p.name: {
        "dag": _dag_times(eng, p.name, xs4),
        "sequential": _sequential_times(eng, *stages[p.name][1:3],
                                        stages[p.name][3], xs4)}
        for p in pipes}
    for t in times.values():
        for v in t.values():
            for k in ("device_ms", "wall_ms"):
                v[k] = round(v[k], 3)
    stats = eng.stats()
    assert stats["cache"]["misses"] == misses, stats["cache"]
    return {"warmup_s": eng.warmup_s, "dag_warmup_s": dag_warm,
            "misses": misses, "hits": stats["cache"]["hits"],
            "requests": requests * len(pipes), "valid_crops": valid,
            "launches": launches, "launches_per_replay": per_replay,
            "pool_bytes": {p.name: stats["runners"][p.name]["pool_bytes"]
                           for p in pipes},
            "glue_gap": glue_gap, "times": times}


def _tenancy_models() -> list:
    """``phase_tenancy``'s tenants at full width, float32, seeded:
    ``alexnet1`` (224 px), ``inception1_ref`` (224 px) and ``yolov3``
    (416 px, score 0, as ``phase_pipeline`` serves it)."""
    from deepvision_tpu_torch.serve import load_served

    return [load_served("alexnet1", seed=0),
            load_served("inception1_ref", seed=0),
            load_served("yolov3", seed=0, score_thresh=0.0)]


def _two_largest(nbytes: dict) -> int:
    """The residency budget of the tenancy drills: the two largest
    tenants' weight bytes, below the three's sum, so that a round-robin
    pass evicts one tenant each time the third comes back."""
    ordered = sorted(nbytes.values())
    budget = ordered[-1] + ordered[-2]
    assert budget < sum(ordered), nbytes
    return budget


def phase_tenancy(smi: str) -> dict:
    """Multi-tenant serving in process (``serve/tenancy.py``), chained
    after ``phase_pipeline`` on its worker: ``alexnet1``,
    ``inception1_ref`` and ``yolov3`` (:func:`_tenancy_models`) behind
    one engine on buckets (1, 4) with the ``detcls`` DAG (``yolov3`` ->
    ``alexnet1``), ``freeze_cache=True`` and a residency budget of the
    two largest tenants' weight bytes (read from the tenants' editions,
    then from ``stats()``). In a counted window (``CARD_COUNTS``):
    ``TENANCY_PASSES`` round-robin passes of a bucket-1 and a bucket-4
    batch a tenant, each tenant evicted and restored between passes, its
    answers bit for bit its first pass's; the ``detcls`` answers; an
    explicit eviction of ``yolov3`` freeing at least its weight bytes of
    ``memory_allocated`` (and the DAG's graphs with its own); the DAG
    answering bit for bit as before through recaptured graphs; a hot swap
    of ``alexnet1`` (``perturb``) under ``SWAP_THREADS`` submitting
    threads. After the window: each swap-drill answer bit for bit the
    pre-swap graph's or the new weights' eager forward's (buckets 1 and
    4), old before new in every thread, nothing dropped, one swap; the
    DAG still on the old weights (``retired_pinned``); the weights'
    layout (strides) the same after a restore; the frozen misses flat.
    Prints the recaptures and their seconds, the tenants' bytes, the
    graph pool bytes and the window's launches. -> the readings."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import (
        InferenceEngine,
        Pipeline,
        PipelineSpec,
    )

    strict_fp32()
    t0 = time.perf_counter()
    models = _tenancy_models()
    nbytes = {m.name: m.edition.nbytes for m in models}
    budget = _two_largest(nbytes)
    by_name = {m.name: m for m in models}
    detcls = Pipeline(PipelineSpec.from_json(
        _pipeline_specs(by_name["alexnet1"].input_shape[0])[1]), by_name)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(21)
    xs = {m.name: ((PIPE_AMPLITUDE if m.task == "detect" else 1.0)
                   * rng.normal(size=(5, *m.input_shape))).astype(np.float32)
          for m in models}
    xs["detcls"] = _pipeline_requests(5, seed=2)
    strides = [(tuple(t.shape), t.stride())
               for t in by_name["alexnet1"].module.parameters()]
    eng = InferenceEngine(models, buckets=PIPE_BUCKETS, pipelines=[detcls],
                          freeze_cache=True, residency_bytes=budget)
    with eng:
        stats = eng.stats()
        assert stats["tenancy"]["bytes"] == nbytes, stats["tenancy"]
        assert stats["tenancy"]["budget_bytes"] == budget
        misses = stats["cache"]["misses"]
        warm_tenancy = stats["tenancy"]
        with CARD_COUNTS:
            _zero_launch_counts()
            t_window = time.perf_counter()
            out = _tenancy_traffic(eng, xs, nbytes)
            launches = {"nms_sweep": _nms_launches(),
                        **{k: v for k, v in _launch_counts().items() if v}}
            window_s = time.perf_counter() - t_window
        # comparisons, outside the counted window: the new weights' eager
        # forward at buckets 1 and 4
        _swap_answers_check(eng, xs["alexnet1"][0], out)
        assert [(tuple(t.shape), t.stride()) for t in eng._models[
            "alexnet1"].module.parameters()] == strides
        stats = eng.stats()
        assert stats["cache"]["misses"] == misses, stats["cache"]
        ten = stats["tenancy"]
        assert [p["tenant"] for p in ten["retired_pinned"]] == \
            ["alexnet1"], ten["retired_pinned"]
        assert ten["swaps"] == 1 and ten["evictions"] >= 3 \
            and ten["rematerializations"] >= 3, ten
        assert launches.get("lrn_forward_f32", 0) > 0 \
            and launches["nms_sweep"] > 0, launches
        pools = {n: r["pool_bytes"] for n, r in stats["runners"].items()}
    warmup_s = eng.warmup_s
    # the models, the DAG's stages (the retired alexnet1 among them) and
    # the engine go before the reading
    models = by_name = detcls = eng = None
    reserved = _closed("tenancy")
    readings = {
        "load_s": round(load_s, 1), "warmup_s": warmup_s,
        "warm_evictions": warm_tenancy["evictions"],
        "window_s": round(window_s, 1), "budget_bytes": budget,
        "bytes": nbytes, "pool_bytes": pools,
        "pool_bytes_by_tenant": out["pool_bytes_by_tenant"],
        "freed": out["freed"], "swap": out["swap"],
        "recaptures": ten["recaptures"], "recapture_s": ten["recapture_s"],
        "evictions": ten["evictions"],
        "rematerializations": ten["rematerializations"],
        "launches": launches, "reserved_after_close": reserved,
        "phase_s": round(time.perf_counter() - t0, 1)}
    _say(f"[tenancy] {json.dumps(readings)}")
    _say(f"[tenancy] alexnet1, inception1_ref and yolov3 with the detcls "
         f"DAG in one engine on {smi}: budget {budget} B of {nbytes} B; "
         f"{TENANCY_PASSES} round-robin passes bit for bit through "
         f"{ten['evictions']} evictions and {ten['rematerializations']} "
         f"restores, {ten['recaptures']} graphs recaptured in "
         f"{ten['recapture_s']} s; evicting yolov3 freed "
         f"{out['freed']['allocated']} B allocated ({out['freed']['reserved']}"
         f" B reserved with the graphs' pools); the DAG recaptured bit for "
         f"bit; the swap captured its ladder in {out['swap']['capture_s']} s "
         f"under {SWAP_THREADS} threads, {out['swap']['old']} answers on the "
         f"old weights then {out['swap']['new']} on the new, none dropped; "
         f"frozen misses {misses}; window launches {launches}; "
         f"{readings['phase_s']} s in all")
    return readings


def _tenancy_traffic(eng, xs: dict, nbytes: dict) -> dict:
    """``phase_tenancy``'s counted traffic: the passes, the eviction's
    memory, the DAG through recaptured graphs and the swap under load.
    -> the answers and readings that the checks after the window read."""
    import torch

    from deepvision_tpu_torch.serve.models import capture_lock

    tenants = ("alexnet1", "inception1_ref", "yolov3")
    batches = {name: [xs[name][0:1], xs[name][1:5]]
               for name in (*tenants, "detcls")}
    passes = []
    for _ in range(TENANCY_PASSES):
        passes.append({name: [_queued(eng, b, name) for b in batches[name]]
                       for name in tenants})
    for name in tenants:
        for k, got in enumerate(passes[1:], 2):
            assert _same_bits(got[name], passes[0][name]), (
                f"{name}: pass {k} after its eviction and restore answered "
                "other bits than pass 1")
    dag = [_queued(eng, b, "detcls") for b in batches["detcls"]]
    pools = eng.tenancy.pool_bytes()

    def memory():
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        with capture_lock:  # never inside another thread's capture
            torch.cuda.empty_cache()
        return allocated, torch.cuda.memory_reserved()

    before = memory()
    recaptured = eng.tenancy.recaptures
    assert eng.tenancy.evict("yolov3")
    after = memory()
    freed = {"allocated": before[0] - after[0],
             "reserved": before[1] - after[1]}
    assert freed["allocated"] >= nbytes["yolov3"], (freed, nbytes)
    again = [_queued(eng, b, "detcls") for b in batches["detcls"]]
    assert _same_bits(again, dag), "detcls after its stage's restore"
    # yolov3's 2 buckets and the DAG's 2 entry buckets
    assert eng.tenancy.recaptures - recaptured == 4, eng.tenancy.stats()
    swap = _swap_under_load(eng, xs["alexnet1"][0], passes[0]["alexnet1"])
    swapped_dag = [_queued(eng, b, "detcls") for b in batches["detcls"]]
    assert _same_bits(swapped_dag, dag), "detcls after alexnet1's swap"
    return {"freed": freed, "swap": swap, "pool_bytes_by_tenant": pools}


def _swap_under_load(eng, x: np.ndarray, first: list) -> dict:
    """``SWAP_THREADS`` threads submit ``x`` to ``alexnet1`` one request
    at a time; once ``SWAP_ANSWERS`` have come back, ``hot_swap(perturb=
    SWAP_PERTURB)`` on this thread, then ``SWAP_ANSWERS`` more. The
    pre-swap graphs' answers to ``x`` at buckets 1 (``first``, pass 1's)
    and 4 are taken before. -> the answers by thread and the swap's
    result, for :func:`_swap_answers_check`."""
    pre = {1: first[0][0], 4: _queued(eng, np.stack([x] * 4),
                                      "alexnet1")[0]}
    results = [[] for _ in range(SWAP_THREADS)]
    errors = []
    stop = threading.Event()

    def pound(k):
        while not stop.is_set():
            try:
                results[k].append(eng.submit(x, model="alexnet1")
                                  .result(timeout=300))
            except Exception as e:  # a dropped request fails the phase
                errors.append(e)
                return

    def answered():
        return sum(len(r) for r in results)

    def wait_for(n):
        t0 = time.perf_counter()
        while answered() < n and not errors:
            assert time.perf_counter() - t0 < 300, answered()
            time.sleep(0.005)

    threads = [threading.Thread(target=pound, args=(k,))
               for k in range(SWAP_THREADS)]
    for t in threads:
        t.start()
    try:
        wait_for(SWAP_ANSWERS)
        result = eng.hot_swap("alexnet1", perturb=SWAP_PERTURB)
        wait_for(answered() + SWAP_ANSWERS)
    finally:
        stop.set()
        for t in threads:
            t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert eng.tenancy.swaps == 1, eng.tenancy.stats()
    return {"pre": pre, "results": results, "result": result,
            "capture_s": result["capture_s"]}


def _swap_answers_check(eng, x: np.ndarray, out: dict) -> None:
    """Each answer of the swap drill bit for bit either a pre-swap graph's
    or the new weights' eager forward's (at bucket 1 or 4), the old ones
    before the new ones in every thread, and some new. Fills in the
    counts of both."""
    served = eng._models["alexnet1"]
    eng.tenancy.ensure_resident("alexnet1")
    new = {b: served.postprocess(served.run(np.stack([x] * b)), 0)
           for b in (1, 4)}
    swap = out["swap"]
    pre = swap.pop("pre")
    assert not _same_bits(pre[1], new[1]), "the swap changed nothing"
    counts = {"old": 0, "new": 0}
    for answers in swap.pop("results"):
        seen_new = False
        for a in answers:
            old = any(_same_bits(a, p) for p in pre.values())
            fresh = any(_same_bits(a, n) for n in new.values())
            assert old or fresh, ("an answer from neither edition", a)
            assert not (seen_new and old and not fresh), \
                "an old answer after a new one"
            seen_new = seen_new or (fresh and not old)
            counts["old" if old else "new"] += 1
    assert counts["new"] > 0, counts
    result = swap.pop("result")
    swap.update(counts, fingerprint=result["fingerprint"],
                dropped=result["dropped_executables"])


def phase_tenancy_cli(workdir: Path) -> dict:
    """The swap drill through the serving CLI, chained after
    ``phase_http`` on its worker: one ``python -m
    deepvision_tpu_torch.serve -m alexnet1 -m inception1_ref -m yolov3
    --buckets 1,4 --residency-mb R --tenant-quota yolov3=N --slo-class
    inception1_ref=batch`` (R the two largest tenants' weight bytes,
    counted on the meta device; ``--batch-window-ms`` long enough that a
    group of 4 lines makes one bucket-4 batch), fed a paced stdin stream:
    two passes of a group of 4 requests a tenant, the control line
    ``{"control": "swap", "model": "alexnet1", "perturb": ...}``, a wait
    for the swap's log line, a third pass. The gates of JAX's ``make
    swap-smoke``: every data line answered, ``alexnet1`` answering from
    both editions, the other tenants untouched, each tenant's pass 2 bit
    for bit its pass 1 (an eviction and a restore between them), the
    exit line ``[tenancy] swaps=1`` with evictions and restores. Prints
    the process's reserved memory before it starts (C33). -> the
    launches from its last line, and readings."""
    import torch

    from deepvision_tpu_torch.models import get_model
    from deepvision_tpu_torch.train.configs import get_config

    tenants = tuple(TENANCY_CLI_SIZES)
    sizes = {}
    for name, size in TENANCY_CLI_SIZES.items():
        with torch.device("meta"):
            module = get_model(name, input_size=size,
                               num_classes=get_config(name)["num_classes"])
        sizes[name] = sum(t.numel() * t.element_size()
                          for t in module.state_dict().values())
    budget_mb = (_two_largest(sizes) + 4096) / 2 ** 20
    rng = np.random.default_rng(22)
    bodies = {}
    for name, size in TENANCY_CLI_SIZES.items():
        # yolov3 at small amplitude (full scale overflows fresh boxes),
        # rounded: the lines are JSON that the CLI parses one by one
        amp, digits = ((PIPE_AMPLITUDE, 5) if name == "yolov3"
                       else (1.0, 3))
        bodies[name] = [json.dumps({"model": name, "input": np.round(
            amp * rng.normal(size=(size, size, 3)), digits).tolist()})
            for _ in range(4)]
    _say(f"[memory] before the tenancy swap drill this process holds "
         f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; the "
         f"card {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free")
    log, out = workdir / "tenancy_cli.log", workdir / "tenancy_cli.out"
    cmd = [sys.executable, "-m", "deepvision_tpu_torch.serve",
           "-m", "alexnet1", "-m", "inception1_ref", "-m", "yolov3",
           "--buckets", "1,4", "--residency-mb", f"{budget_mb:.6f}",
           "--tenant-quota", f"yolov3={TENANCY_CLI_QUOTA}",
           "--slo-class", "inception1_ref=batch",
           "--batch-window-ms", str(TENANCY_CLI_WINDOW_MS)]
    t0 = time.perf_counter()
    with open(log, "w") as err, open(out, "w") as reply:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.PIPE,
                                stdout=reply, stderr=err, text=True,
                                env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        for p in range(3):
            if p == 2:
                proc.stdin.write(json.dumps(
                    {"control": "swap", "model": "alexnet1",
                     "perturb": SWAP_PERTURB}) + "\n")
                proc.stdin.flush()
                t_swap = time.perf_counter()
                while "[tenancy] swapped alexnet1" not in _log_text(log):
                    assert proc.poll() is None, _log_text(log)[-4000:]
                    assert time.perf_counter() - t_swap < 600
                    time.sleep(0.1)
            for k, name in enumerate(tenants):
                proc.stdin.write("".join(
                    f'{{"id": {100 * p + 10 * k + i}, ' + body[1:] + "\n"
                    for i, body in enumerate(bodies[name])))
                proc.stdin.flush()
        proc.stdin.close()
        rc = proc.wait(900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = _log_text(log)
    assert rc == 0, text[-4000:]
    replies = {r["id"]: r for r in (json.loads(s) for s in _log_text(
        out).splitlines() if s.strip())}
    assert sorted(replies) == sorted(100 * p + 10 * k + i for p in range(3)
                                     for k in range(3) for i in range(4))
    assert all("result" in r for r in replies.values()), replies
    got = {(p, k): [replies[100 * p + 10 * k + i]["result"]
                    for i in range(4)] for p in range(3) for k in range(3)}
    for k, name in enumerate(tenants):
        assert _same_bits(got[(1, k)], got[(0, k)]), (
            f"{name}: pass 2 differs from pass 1 across its eviction")
        if name == "alexnet1":
            assert not _same_bits(got[(2, k)], got[(0, k)]), \
                "alexnet1 answered no new edition after the swap"
        else:
            assert _same_bits(got[(2, k)], got[(0, k)]), (
                f"{name}: the swap of alexnet1 touched its answers")
    line = next(s for s in text.splitlines()
                if s.startswith("[tenancy] swaps="))
    fields = dict(kv.split("=") for kv in line.split()[1:])
    assert fields["swaps"] == "1", line
    assert int(fields["evictions"]) >= 1, line
    assert int(fields["rematerializations"]) >= 1, line
    restored = {name: text.count(f"[tenancy] rematerialized {name} ")
                for name in sizes}
    launches = _cli_launches(text)
    assert launches["lrn_forward_f32"] > 0 and launches["nms_sweep"] > 0, \
        text.strip().splitlines()[-1]
    seconds = time.perf_counter() - t0
    _say(f"[tenancy-cli] 3 tenants under --residency-mb {budget_mb:.3f}: 36 "
         f"lines answered, alexnet1 from both editions, the others "
         f"untouched, each tenant's pass 2 bit for bit its pass 1; "
         f"restores {restored}; {line}; {text.strip().splitlines()[-1]}; "
         f"{seconds:.1f} s")
    return {"launches": {"lrn_forward_f32": launches["lrn_forward_f32"],
                         "nms_sweep": launches["nms_sweep"]},
            "line": line, "restored": restored, "bytes": sizes,
            "seconds": round(seconds, 1)}


def _train_batch(n: int, classes: int = 1000, seed: int = 0,
                 size: int = 224) -> dict:
    """A seeded host batch of ``n`` size x size x 3 images and labels."""
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0, 1, (n, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, classes, n).astype(np.int32)}


def phase_train_step(name: str = "alexnet1", steps: int = 3
                     ) -> dict[str, int]:
    """The train step of ``name`` on the card, kernels against plain
    versions, in float32 with TF32 off and dropout off (aux heads on, at
    0.3); returns the kernel run's LRN launches."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.ops.lrn import local_response_norm_reference
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    strict_fp32()
    cfg = get_config(name)
    base = create_model(name, device=torch.device("cuda"), seed=0)
    for m in base.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(TRAIN_BATCH).items()}

    def run(lrn):
        module = copy.deepcopy(base)
        if lrn is not None:
            module.lrn = lrn
        optimizer, _ = make_optimizer(cfg, module.parameters(), 1000)
        state = TrainState(module, optimizer)
        keys = KeySeq(1, 0, device="cuda")
        losses = [classification_train_step(state, batch, next(keys),
                                            "torch")["loss"]
                  for _ in range(steps)]
        torch.cuda.synchronize()
        return (torch.stack(losses).tolist(),
                {n: p.detach().clone() for n, p in module.named_parameters()})

    def gap(a, b):
        loss = max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0]))
        param = max((a[1][n] - b[1][n]).abs().max().item() for n in a[1])
        return loss, param

    t0 = time.perf_counter()
    _zero_launch_counts()
    kernel = run(None)
    launches = _launch_counts()
    # autograd of the plain forward: a reference that shares no code with
    # the analytic backward the kernel implements
    plain = local_response_norm_reference
    ref, ref2 = run(plain), run(plain)
    loss_gap, param_gap = gap(kernel, ref)
    noise_loss, noise_param = gap(ref2, ref)
    _say(f"[train-step] {name} batch {TRAIN_BATCH} f32 (TF32 off, dropout "
         f"off), {steps} steps in {time.perf_counter() - t0:.1f} s for three "
         f"runs: losses kernel {kernel[0]} plain {ref[0]}; kernel vs plain: "
         f"loss rel gap {loss_gap:.3e}, max param abs gap {param_gap:.3e}; "
         f"plain vs plain: {noise_loss:.3e}, {noise_param:.3e}; LRN "
         f"launches {launches}")
    assert np.all(np.isfinite(kernel[0])), kernel[0]
    assert loss_gap <= 1e-4 and param_gap <= 1e-5, (loss_gap, param_gap)
    assert launches["lrn_forward_f32"] == 2 * steps, launches
    assert launches["lrn_backward_f32"] == 2 * steps, launches
    return launches


def phase_card_vs_cpu_step(name: str = "resnet50", n: int = 8) -> None:
    """One float32 train step of ``name`` (config's optimizer and
    ``model_kwargs``, fresh seeded weights, a batch of ``n`` at full
    width, TF32 off) on the card and on this machine's CPU from the same
    state. The loss and every parameter and BN statistic are held as the
    CPU tests hold the port against JAX, to float32's own noise: float32
    BN models flip ReLUs whose inputs lie within rounding of 0, and each
    flip moves the gradients below it by up to a few percent. Each
    platform flips its own: two more runs on each, on the batch reversed
    and rolled by 3, give each leaf its floor, the largest gap between a
    platform's run and its reordered runs; each leaf is held within 1e-5
    plus three times its floor, the loss within 1e-4 plus four times
    its. Both floors come from within one platform, so a fault of one
    platform's path is not in them. Two faults planted on the card show
    that the check sees one: the state left as it was before the step,
    and the step taken at 0.9 times the config's LR; each must put
    leaves over their tolerance. No LRN kernel launches."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import (
        make_optimizer,
        set_lr_scale,
    )
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    strict_fp32()
    cfg = get_config(name)
    base = create_model(name, device=torch.device("cpu"), seed=0,
                        **cfg.get("model_kwargs", {}))
    host = _train_batch(n)
    orders = (lambda a: a, lambda a: a[::-1],
              lambda a: np.roll(a, 3, axis=0))

    def run(device, order, lr_scale=1.0):
        module = copy.deepcopy(base).to(device)
        optimizer, _ = make_optimizer(cfg, module.parameters(), 1000)
        set_lr_scale(optimizer, lr_scale)
        state = TrainState(module, optimizer)
        batch = {k: torch.from_numpy(order(v).copy()).to(device)
                 for k, v in host.items()}
        loss = classification_train_step(
            state, batch, next(KeySeq(1, 0, device=device)), "torch")["loss"]
        return float(loss), {k: v.detach().cpu()
                             for k, v in module.state_dict().items()}

    t0 = time.perf_counter()
    _zero_launch_counts()
    card = [run("cuda", o) for o in orders]
    launches = sum(_launch_counts().values())
    wrong_lr = run("cuda", orders[0], lr_scale=0.9)[1]
    t_cpu = time.perf_counter()
    cpu = [run("cpu", o) for o in orders]
    t_cpu = time.perf_counter() - t_cpu

    def gap(a, b):
        return float((a - b).abs().max())

    def floor(runs, key):
        return max(gap(r[1][key], runs[0][1][key]) for r in runs[1:])

    floors = {key: (floor(card, key), floor(cpu, key)) for key in card[0][1]}

    def used(state):
        """Each leaf's gap between ``state`` and the CPU's step, as a
        share of its tolerance."""
        return {k: gap(cpu[0][1][k], v) / (1e-5 + 3 * max(floors[k]))
                for k, v in state.items()}

    held = used(card[0][1])
    worst_key = max(held, key=held.get)
    worst = held[worst_key]
    planted = {"state before the step": used(base.state_dict()),
               "LR x 0.9": used(wrong_lr)}
    loss_floor = max(abs(r[0] - runs[0][0]) for runs in (card, cpu)
                     for r in runs[1:])
    loss_gap = abs(cpu[0][0] - card[0][0])
    loss_tol = 1e-4 * abs(card[0][0]) + 4 * loss_floor
    wk = worst_key
    _say(f"[card-vs-cpu] {name} f32 (TF32 off) batch {n} at 224, one step "
         f"on each of 3 batch orders on each side in "
         f"{time.perf_counter() - t0:.1f} s (CPU {t_cpu:.1f} s): loss card "
         f"{card[0][0]:.6f} CPU {cpu[0][0]:.6f}, gap {loss_gap:.3e} "
         f"(tolerance {loss_tol:.3e}, floor {loss_floor:.3e}); "
         f"{len(floors)} parameters and BN statistics, each within 1e-5 + 3 "
         f"x its floor: at most {worst:.1%} of its tolerance used ({wk}: gap "
         f"{gap(cpu[0][1][wk], card[0][1][wk]):.3e}, card floor "
         f"{floors[wk][0]:.3e}, CPU floor {floors[wk][1]:.3e}); largest "
         f"floor card {max(f[0] for f in floors.values()):.3e}, CPU "
         f"{max(f[1] for f in floors.values()):.3e}; LRN launches "
         f"{launches}")
    # what the card's floor alone would say: the leaves over it, and
    # whether the worst one's gap sits in one output channel (one ReLU
    # flip) or across them
    over = {k: gap(cpu[0][1][k], w) / (1e-5 + 3 * floors[k][0])
            for k, w in card[0][1].items()}
    ok = max(over, key=over.get)
    per_channel = sorted(((cpu[0][1][ok] - card[0][1][ok]).abs()
                          .reshape(len(card[0][1][ok]), -1).amax(1)
                          .tolist()), reverse=True)
    _say(f"[card-vs-cpu] held to the card's floor alone: "
         f"{sum(v > 1 for v in over.values())} of {len(over)} leaves over "
         f"it, at most {over[ok]:.2f}x ({ok}: gap "
         f"{gap(cpu[0][1][ok], card[0][1][ok]):.3e}, card floor "
         f"{floors[ok][0]:.3e}, CPU floor {floors[ok][1]:.3e}; largest "
         f"gaps by output channel {per_channel[0]:.3e}, "
         f"{per_channel[1] if len(per_channel) > 1 else 0.0:.3e})")
    for fault, shares in planted.items():
        over = sorted(shares.values(), reverse=True)
        _say(f"[card-vs-cpu] planted fault on the card, {fault}: "
             f"{sum(v > 1 for v in over)} of {len(over)} leaves over their "
             f"tolerance, at most {over[0]:.2f}x (the sound step: "
             f"{sum(v > 1 for v in held.values())}, at most {worst:.1%})")
    assert np.isfinite(card[0][0]) and loss_gap <= loss_tol
    assert worst <= 1.0, (worst_key, worst)
    assert launches == 0
    # the check sees both faults: the unchanged state on most leaves, as
    # the CPU tests require of theirs, the wrong LR on at least one
    stale = planted["state before the step"]
    assert sum(v > 1 for v in stale.values()) > len(stale) // 2
    assert max(planted["LR x 0.9"].values()) > 1.0


def phase_trainer(workdir: Path, name: str = "alexnet1", lrns: int = 2
                  ) -> tuple[dict[str, int], object]:
    """Training ``name``, a main path: the port's Trainer at full width
    in the config's bf16 policy and batch, the model built with the
    config's ``model_kwargs``, one epoch of 2 steps on a synthetic set of
    3 batches (one held out), ``lrns`` LRNs a forward; returns its LRN
    launches and the trainer. A model with BN: every running statistic
    moved."""
    import torch

    from deepvision_tpu_torch.data.mnist import batches
    from deepvision_tpu_torch.data.synthetic import synthetic_classification
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.trainer import Trainer

    cfg = get_config(name)
    bs = cfg["batch_size"]
    imgs, labels, split = synthetic_classification(3 * bs, 224, 3, 1000, bs)
    steps = (len(imgs) - split) // bs
    assert steps == 2, (len(imgs), split, bs)
    module = create_model(name, device=torch.device("cuda"), seed=0,
                          dtype=torch.bfloat16,
                          **cfg.get("model_kwargs", {}))
    trainer = Trainer(
        module, cfg,
        lambda e: batches(imgs[split:], labels[split:], bs,
                          rng=np.random.default_rng(e)),
        lambda: batches(imgs[:split], labels[:split], bs,
                        drop_remainder=False),
        workdir=workdir, log_every=0, steps_per_epoch=steps)
    _zero_launch_counts()
    loggers = trainer.fit(1)
    launches = _launch_counts()
    evals = 2 * -(-split // bs)  # before and after the epoch
    _say(f"[trainer] {name} bf16 batch {bs}: {steps} steps, loss "
         f"{loggers.latest('train_loss'):.4f}, val_loss "
         f"{loggers.latest('val_loss'):.4f}, "
         f"{loggers.latest('examples_per_sec'):.1f} images/s (first epoch, "
         f"warm-up included); LRN launches {launches}")
    assert np.isfinite(loggers.latest("train_loss"))
    assert launches["lrn_forward_bf16"] == lrns * (steps + evals), launches
    assert launches["lrn_backward_bf16"] == lrns * steps, launches
    assert trainer.ckpt.latest_epoch() == 0
    stats = _unmoved_bn_statistics(module)
    if stats[1]:
        assert not stats[0], stats[0][:5]
        _say(f"[trainer] {name}: all {stats[1]} BN statistic tensors moved "
             "from their fresh values (mean 0, var 1)")
    return launches, trainer


def _unmoved_bn_statistics(module) -> tuple[list[str], int]:
    """(names of BN running statistics still at their fresh values, mean
    0 or var 1; how many there are in all)."""
    import torch

    stats = {k: v for k, v in module.state_dict().items()
             if k.endswith((".mean", ".var"))}
    unmoved = [k for k, v in stats.items()
               if (k.endswith(".mean") and not v.any())
               or (k.endswith(".var") and torch.equal(v, torch.ones_like(v)))]
    return unmoved, len(stats)


def _train_env() -> dict:
    """The environment of a training CLI of the training-CLI block, whose
    nine processes (four ``resnet50`` at batch 256 among them) fill the
    card's 80 GB: expandable segments keep each allocator's reserved
    memory near what it holds (without them the ``resnet50`` CLI once ran
    out of memory there)."""
    return {**os.environ, "PYTHONPATH": str(ROOT),
            "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}


def _run_cli(args: list[str]) -> subprocess.CompletedProcess:
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.train", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=_train_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc


def _cli_launches(stderr: str) -> dict:
    """The kernel launches a training CLI counted in its own process
    (from 0 at its start), read from its last line."""
    return ast.literal_eval(stderr.rsplit("kernel launches ", 1)[1].strip())


def phase_train_cli(workdir: Path, name: str = "alexnet1",
                    lrns: int = 2, steps: int = 2) -> None:
    """The training CLI of ``name`` at full width and the config's batch:
    2 epochs of ``steps`` steps on a synthetic set of ``steps`` + 1
    batches (one held out), a resume to 3, then the served model from
    the newest checkpoint. The config's ``model_kwargs`` reached the
    model. The LRN kernels launched if the model has ``lrns`` LRNs a
    forward, and not otherwise. A model with BN: its running statistics
    moved and a restore gives them back bit for bit, with the schedule's
    update count where it has one."""
    import torch

    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.serve import load_served
    from deepvision_tpu_torch.train import manifest
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState

    cfg = get_config(name)
    model_kwargs = cfg.get("model_kwargs", {})
    common = ["-m", name, "--synthetic-size",
              str((steps + 1) * cfg["batch_size"]), "--steps-per-epoch",
              str(steps), "--workdir", str(workdir)]
    t0 = time.perf_counter()
    first = _run_cli([*common, "--epochs", "2"])
    assert f"model_kwargs {model_kwargs}" in first.stdout, first.stdout[:2000]
    epochs = [ln for ln in first.stdout.splitlines() if ln.startswith("[")]
    ckpt = workdir / name / "ckpt"
    for e in (0, 1):
        ok, why = manifest.verify_manifest(ckpt, e)
        assert ok and why == "ok", (e, why)
    _say(f"[train-cli] {name}: 2 epochs in {time.perf_counter() - t0:.1f} s:")
    for line in epochs:
        _say(f"[train-cli]   {line[:300]}")
    _say(f"[train-cli]   {first.stderr.strip().splitlines()[-1]}")
    loss = [float(m) for m in re.findall(r"\] train_loss=(\S+)",
                                         first.stdout)]
    assert len(loss) == 2 and np.all(np.isfinite(loss)), loss
    launches = _cli_launches(first.stderr)
    for kernel in ("lrn_forward_bf16", "lrn_backward_bf16"):
        assert (launches[kernel] > 0) == (lrns > 0), (kernel, launches)
    assert launches["ycc_to_rgb"] == 0, launches  # no JPEG on this path

    t0 = time.perf_counter()
    second = _run_cli([*common, "--epochs", "3", "--resume"])
    assert "resumed at epoch 2" in second.stdout, second.stdout[-2000:]
    assert re.search(r"^\[epoch 2\] ", second.stdout, re.M), second.stdout
    assert not re.search(r"^\[epoch [01]\] ", second.stdout, re.M)
    assert manifest.verify_manifest(ckpt, 2) == (True, "ok")
    _say(f"[train-cli] {name}: --resume --epochs 3 started at epoch 2 and "
         f"saved it in {time.perf_counter() - t0:.1f} s; "
         f"{second.stderr.strip().splitlines()[-1]}")

    served = load_served(name, str(workdir / name))
    want, _ = CheckpointManager(ckpt).restore_model(2, "cuda")
    for key, tensor in served.module.state_dict().items():
        assert torch.equal(tensor, want[key]), key
    out = served.run(_train_batch(8, seed=3)["image"])
    assert out["classes"].shape == (8, 5)
    assert np.all(np.isfinite(out["probs"])), out
    _say(f"[train-cli] {name}: load_served answers from the epoch-2 "
         f"checkpoint (weights equal to it; top-1 of 8 images "
         f"{out['classes'][:, 0]})")
    fresh = create_model(name, device=torch.device("cuda"), seed=1,
                         dtype=torch.bfloat16, **model_kwargs)
    if model_kwargs.get("s2d_stem"):
        # the stem's BN is flax's stock one only under the config's
        # model_kwargs, which the CLI printed it was built with
        assert type(fresh.stem.bn).__name__ == "BatchNorm", fresh.stem.bn
        assert type(served.module.stem.bn).__name__ == "MixedBatchNorm"
    unmoved, n_stats = _unmoved_bn_statistics(served.module)
    if n_stats:
        opt, _ = make_optimizer(cfg, fresh.parameters(), steps)
        CheckpointManager(ckpt).restore(TrainState(fresh, opt), 2)
        restored = fresh.state_dict()
        assert all(torch.equal(restored[k], want[k]) for k in want)
        count = getattr(opt, "count", None)  # a step-count schedule's
        if count is not None:
            assert float(count) == 3.0 * steps, float(count)
        assert not unmoved, unmoved[:5]
        _say(f"[train-cli] {name}: all {n_stats} BN running statistics "
             f"moved from their fresh values (mean 0, var 1); a restore "
             f"gives them back bit for bit"
             + ("" if count is None else
                f", with the update count {float(count):.0f}")
             + (f"; built with model_kwargs {model_kwargs} (stock stem BN)"
                if model_kwargs else ""))


def _model_flops_per_image(module, size: int = 224) -> float:
    """Model FLOPs of one forward of one size x size x 3 image: 2 a MAC
    of every convolution and matmul, counted from their shapes by
    ``torch.utils.flop_counter``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros(1, size, size, 3, device="cuda")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(x)
    return float(counter.get_total_flops())


def phase_throughput(trainer, name: str = "alexnet1", steps: int = 24,
                     warmup: int = 3) -> dict:
    """Training images/s of ``name`` at the trainer's batch in bf16:
    through the device feed, and on one device-resident batch, with the
    peak of allocated device memory over the resident steps and the
    model FLOP utilization (a step's model FLOPs, the backward counted
    as twice the forward, over the step time and the dense bf16 peak);
    then profiler windows over one step. Returns the readings."""
    import itertools

    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher
    from deepvision_tpu_torch.train.steps import classification_train_step

    state = trainer.state
    bs = trainer.config["batch_size"]
    keys = KeySeq(1, 99, device="cuda")
    host = [_train_batch(bs, seed=s) for s in range(4)]

    def step(batch):
        return classification_train_step(state, batch, next(keys), "torch")

    feed = DevicePrefetcher(
        itertools.islice(itertools.cycle(host), warmup + steps),
        torch.device("cuda"), depth=2)
    try:
        for _ in range(warmup):
            step(next(feed))["loss"].item()
        t0 = time.perf_counter()
        for batch in feed:
            m = step(batch)
        m["loss"].item()
        fed = steps * bs / (time.perf_counter() - t0)
        tel = feed.telemetry.summary()
    finally:
        feed.close()

    resident = {k: torch.from_numpy(v).cuda() for k, v in host[0].items()}
    for _ in range(warmup):
        step(resident)["loss"].item()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(resident)
    m["loss"].item()
    dev = steps * bs / (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    flops = 3 * bs * _model_flops_per_image(state.module)
    mfu = {k: flops * ips / bs / BF16_DENSE_FLOPS_PER_S
           for k, ips in (("feed", fed), ("resident", dev))}
    _say(f"[throughput] {name} train bf16 batch {bs}, {steps} "
         f"timed steps after {warmup}: {fed:.1f} images/s through the device "
         f"feed (h2d_wait {tel['h2d_wait_ms']} ms, step {tel['step_ms']} ms "
         f"a batch), {dev:.1f} images/s on a device-resident batch; loss "
         f"{m['loss'].item():.4f}; peak allocated {peak_gb:.2f} GiB; model "
         f"FLOPs {flops:.4e} a step (convolutions and matmuls, 2 a MAC, "
         f"backward twice the forward), MFU {mfu['feed']:.2%} fed and "
         f"{mfu['resident']:.2%} resident of the dense bf16 peak "
         f"{BF16_DENSE_FLOPS_PER_S:.3e} FLOP/s")
    assert np.isfinite(m["loss"].item())

    def one_step():
        step(resident)
        torch.cuda.synchronize()

    # does the layout step of the LRN's backward (g.contiguous()) copy?
    prof = _profile(one_step, f"{name} train step bf16 batch {bs}",
                    before="lrn_backward")
    return {"fed": fed, "resident": dev, "peak_gb": peak_gb, "flops": flops,
            "mfu": mfu, **prof}


def phase_served_batch(name: str) -> None:
    """``load_served(name)`` in float32 (TF32 off) answers one bucket-64
    batch through its CUDA graph runner (``compile_for(64)``): finite
    top-5 answers bit for bit the eager forward's, no LRN launch; then
    profiler windows over the runner."""
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import load_served

    strict_fp32()
    served = load_served(name, seed=0)
    batch = (np.random.default_rng(0)
             .normal(0, 1, (BUCKETS[-1], *served.input_shape))
             .astype(np.float32))
    runner = served.compile_for(len(batch))
    _zero_launch_counts()
    t0 = time.perf_counter()
    out = runner(batch)
    wall = time.perf_counter() - t0
    launches = sum(_launch_counts().values())
    assert out["classes"].shape == (len(batch), 5), out["classes"].shape
    assert np.all(np.isfinite(out["probs"])) and launches == 0, launches
    eager = served.run(batch)
    assert all(np.array_equal(out[k], eager[k]) for k in eager), name
    _say(f"[serve-batch] {name}: a bucket-{len(batch)} batch answered by "
         f"its CUDA graph (captured in {runner.capture_s:.2f} s, pool "
         f"{runner.pool_bytes / 2**20:.1f} MiB) in {wall * 1e3:.1f} ms of "
         f"host wall, bit for bit the eager forward's, top-1 of the first "
         f"8 {out['classes'][:8, 0]}; LRN launches {launches}")
    _profile_served(runner, served, batch,
                    f"{name} bucket-{len(batch)} batch")
    runner = None
    _closed(f"{name} served batch")


def phase_resnets(smi: str, workdir: Path) -> None:
    """The ResNet paths, none of which reaches an LRN kernel: ``resnet50``
    served, its float32 step on the card against the CPU, its Trainer and
    its training throughput (its CLI runs in :func:`phase_train_clis`);
    then ``resnet34`` and ``resnet50v2`` trained for one epoch and served
    one batch."""
    GRAPHS["resnet50"] = _timed("resnet50 serve", phase_serve, smi,
                                "resnet50", lrns=0)[3]
    GRAPHS["resnet50"].pop("bucket1")
    _timed("resnet50 card-vs-cpu step", phase_card_vs_cpu_step, "resnet50")
    _, trainer = _timed("resnet50 trainer", phase_trainer,
                        workdir / "inproc_resnet50", "resnet50", lrns=0)
    r = _timed("resnet50 throughput", phase_throughput, trainer, "resnet50",
               steps=EARLIER_TIMED_STEPS)
    trainer = None
    _say(f"[resnet50] train bf16 batch 256: {r['fed']:.1f} images/s fed, "
         f"{r['resident']:.1f} resident; MFU {r['mfu']['feed']:.2%} fed, "
         f"{r['mfu']['resident']:.2%} resident ({r['flops']:.4e} FLOPs a "
         f"step over {BF16_DENSE_FLOPS_PER_S:.3e} FLOP/s); device time "
         f"{r['device_ms']} ms in {r['launches']} launches a step, idle "
         f"{r['idle']}; reduction kernels {r['reduction_share']}, "
         f"elementwise kernels {r['elementwise_share']} of device time; "
         f"peak allocated {r['peak_gb']:.2f} GiB ({smi})")
    for name in ("resnet34", "resnet50v2"):
        _timed(f"{name} trainer", phase_trainer, workdir / f"inproc_{name}",
               name, lrns=0)
        _timed(f"{name} served batch", phase_served_batch, name)


def phase_train_clis(workdir: Path, runs: dict[str, int],
                     served: tuple) -> None:
    """:func:`phase_train_cli` of each model (name -> LRNs a forward) and
    the serving CLI (:func:`phase_cli` of ``served``, AlexNet V1's
    answers and inputs), at once, one thread each (their processes share
    the card): the runs' checks are their own, and their seconds are not
    read as rates."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(runs) + 1) as pool:
        futures = [pool.submit(_timed, f"{name} train CLI", phase_train_cli,
                               workdir, name, lrns=lrns)
                   for name, lrns in runs.items()]
        futures.append(pool.submit(_timed, "serving CLI", phase_cli,
                                   *served))
        for future in futures:
            future.result()


def phase_crc(workdir: Path) -> dict:
    """The compiled CRC32C against its plain twin on random buffers of 0
    to 64 bytes at every offset 0-7 (unaligned slices) and on one record
    of 262,144 bytes; then its rate over 64 MB and the verified read
    (both CRCs of every record) of 256 raw-crop-sized records."""
    from deepvision_tpu_torch.data import tfrecord

    rng = np.random.default_rng(0)
    cases = 0
    for n in range(65):
        buf = rng.bytes(n + 8)
        for off in range(8):
            view = memoryview(buf)[off:off + n]
            assert tfrecord.crc32c(view) == tfrecord.crc32c_reference(view), \
                (n, off)
            cases += 1
    record = rng.bytes(256 * 341 * 3)
    assert tfrecord.crc32c(record) == tfrecord.crc32c_reference(record)
    big = rng.bytes(64 << 20)
    t0 = time.perf_counter()
    tfrecord.crc32c(big)
    crc_mb_s = len(big) / (time.perf_counter() - t0) / 1e6
    path = workdir / "crc.tfrecord"
    path.parent.mkdir(parents=True, exist_ok=True)
    tfrecord.write_records(path, [record] * 256)
    t0 = time.perf_counter()
    n = sum(1 for _ in tfrecord.read_records(path, verify=True))
    dt = time.perf_counter() - t0
    path.unlink()
    hw = tfrecord.crc32c_native().dv_crc32c_hardware()
    out = {"crc_mb_s": crc_mb_s, "read_mb_s": n * len(record) / dt / 1e6,
           "read_records_s": n / dt}
    _say(f"[crc] compiled CRC32C ({'crc32 instruction' if hw else 'tables'})"
         f" equals the plain one on {cases} buffers of 0-64 bytes at "
         f"offsets 0-7 and on a {len(record)}-byte record; "
         f"{crc_mb_s:.1f} MB/s over 64 MB; verified read of {n} records of "
         f"{len(record)} bytes: {out['read_records_s']:.1f} records/s, "
         f"{out['read_mb_s']:.1f} MB/s (host CPU, one thread)")
    return out


def _imagenet_sized_jpegs(n: int, seed: int = 0):
    """``n`` JPEGs of ImageNet-like sizes (sides 300-500), encoded by
    nvJPEG from synthetic images made on the card."""
    import torch

    from deepvision_tpu_torch.data.jpeg import encode_images
    from deepvision_tpu_torch.data.synthetic_records import synthetic_image

    rng = np.random.default_rng(seed)
    images = [synthetic_image(rng, int(rng.integers(300, 501)),
                              int(rng.integers(300, 501)), i % 1000,
                              torch.device("cuda")) for i in range(n)]
    return encode_images(images), images


def _ycc_bound_ms(desc) -> float:
    """Least time of one ``ycc_to_rgb`` launch: Y and both chroma planes
    read once, three bytes a pixel written, over the HBM rate (a few
    integer operations a pixel are far below the card's rate)."""
    luma = int((desc["h"].astype(np.int64) * desc["w"]).sum())
    chroma = int((desc["ch"].astype(np.int64) * desc["cw"]).sum())
    return (luma + 2 * chroma + 3 * luma) / HBM_BYTES_PER_S * 1e3


def phase_nvjpeg() -> dict:
    """nvJPEG and the ``ycc_to_rgb`` kernel on the card. The committed
    fixtures (``tests/data/``) decoded and held to ``tf.io.decode_jpeg``'s
    pixels, its default fast IDCT's (the JAX reader's; bounds
    ``NVJPEG_MAX_LSB``, ``NVJPEG_MEAN_LSB``) and its accurate IDCT's
    (``NVJPEG_ACCURATE_*``), in uint8 steps; the decode stage on them held
    to the JAX reader's evaluation output (the normalized gap taken back
    to pixel steps). The kernel against its plain version on the planes
    nvJPEG gives, for the fixtures and a batch of 256 ImageNet-sized JPEGs
    (exact: integer math on both sides), and its time at that batch
    beside the bound and the plain version's. Then the batched decode of
    the 256 alone and with the train stage (resize, crop, flip, jitter,
    uint8), in images/s. Returns the readings and the kernel's line."""
    import torch

    from deepvision_tpu_torch.data import jpeg
    from deepvision_tpu_torch.ops.normalize import TORCH_CHANNEL_STDS
    from deepvision_tpu_torch.timing import time_ms

    cuda = torch.device("cuda")
    nv = jpeg.nvjpeg(cuda)
    ref = np.load(ROOT / "tests" / "data" / "jpeg_reference.npz")
    n_fix = len([k for k in ref.files if k.startswith("pixels_accurate_")])
    blobs = [(ROOT / "tests" / "data" / f"jpeg_{i}.jpg").read_bytes()
             for i in range(n_fix)]
    packed, offsets = jpeg.pack(blobs)
    decoded = jpeg.decode_images(packed, offsets, cuda)
    torch.cuda.synchronize()
    worst = dict.fromkeys(["fast_max", "fast_mean", "accurate_max",
                           "accurate_mean", "eval_max", "eval_mean"], 0.0)
    for i, img in enumerate(decoded):
        got = img.cpu().numpy().astype(np.int32)
        for key, name in (("fast", "pixels"), ("accurate", "pixels_accurate")):
            d = np.abs(got - ref[f"{name}_{i}"].astype(np.int32))
            worst[f"{key}_max"] = max(worst[f"{key}_max"], float(d.max()))
            worst[f"{key}_mean"] = max(worst[f"{key}_mean"], float(d.mean()))
    size = int(ref["eval_size"])
    batch = jpeg.PackedJpegBatch(blobs, list(range(n_fix)), jpeg.JpegPlan(
        size, jpeg.resize_min_for(size), normalize="torch")).decode(cuda)
    steps = 255.0 * np.asarray(TORCH_CHANNEL_STDS, np.float32)
    for i in range(n_fix):
        d = np.abs(batch["image"][i].cpu().numpy() - ref[f"eval_{i}"]) * steps
        worst["eval_max"] = max(worst["eval_max"], float(d.max()))
        worst["eval_mean"] = max(worst["eval_mean"], float(d.mean()))
    _say(f"[nvjpeg] {n_fix} fixtures, uint8 steps (worst image): against "
         f"tf.io.decode_jpeg's default IDCT max {worst['fast_max']:.0f}, mean "
         f"{worst['fast_mean']:.4f} (bounds {NVJPEG_MAX_LSB}, "
         f"{NVJPEG_MEAN_LSB}); against its accurate IDCT max "
         f"{worst['accurate_max']:.0f}, mean {worst['accurate_mean']:.4f} "
         f"(bounds {NVJPEG_ACCURATE_MAX_LSB}, {NVJPEG_ACCURATE_MEAN_LSB}); "
         f"the decode stage against the JAX eval output at size {size}: max "
         f"{worst['eval_max']:.4f}, mean {worst['eval_mean']:.4f} (bounds "
         f"{NVJPEG_MAX_LSB}, {NVJPEG_MEAN_LSB})")
    for key, (top, mean) in (
            ("fast", (NVJPEG_MAX_LSB, NVJPEG_MEAN_LSB)),
            ("eval", (NVJPEG_MAX_LSB, NVJPEG_MEAN_LSB)),
            ("accurate", (NVJPEG_ACCURATE_MAX_LSB, NVJPEG_ACCURATE_MEAN_LSB))):
        assert worst[f"{key}_max"] <= top, worst
        assert worst[f"{key}_mean"] <= mean, worst

    big, images = _imagenet_sized_jpegs(256)
    packed, offsets = jpeg.pack(big)
    back = jpeg.decode_images(packed[:offsets[1]], offsets[:2], cuda)[0]
    rt = (back.int() - images[0].int()).abs()
    _say(f"[nvjpeg] encode-decode round trip of a {tuple(images[0].shape)} "
         f"image at quality 90: max |delta| {rt.max().item()}, mean "
         f"{rt.float().mean().item():.3f} steps")
    # a sanity bound, set after the first reading (4.749 steps: the
    # synthetic images' noise, 6 steps, is what JPEG drops); a wrong
    # layout or channel order is tens of steps off
    assert rt.float().mean().item() < 8.0
    images = None

    # the kernel against its plain version, on nvJPEG's planes
    err = 0
    for batch_blobs in (blobs, big[:16], big):
        planes = nv.decode_to_planes(*jpeg.pack(batch_blobs))
        got = nv.ycc_to_rgb(planes)
        want = torch.cat([jpeg.ycc_to_rgb_reference(*p).reshape(-1)
                          for p in jpeg.planes_of(planes)])
        torch.cuda.synchronize()
        assert got.numel() == want.numel()
        err = max(err, (got.int() - want.int()).abs().max().item())
    assert err == 0, err
    desc = planes[3]

    def plain(_):
        return [jpeg.ycc_to_rgb_reference(*p)
                for p in jpeg.planes_of(planes)]

    ms = time_ms(lambda _: nv.ycc_to_rgb(planes), [None], iters=50)
    plain_ms = time_ms(plain, [None], iters=5, warmup=2)
    bound_ms = _ycc_bound_ms(desc)
    pixels = int(desc["h"].astype(np.int64).dot(desc["w"]))
    _say(f"[nvjpeg] ycc_to_rgb kernel equals its plain version on the "
         f"{n_fix} fixtures, 16 ImageNet-sized JPEGs and the batch of 256 "
         f"({pixels} pixels; max |delta| {err}): {ms:.4f} ms a launch "
         f"(warm), bound {bound_ms:.4f} ms (bytes), plain version "
         f"{plain_ms:.3f} ms")

    plan = jpeg.JpegPlan(
        224, 256, crop_u=np.random.default_rng(1).random((256, 2)),
        flips=np.arange(256) % 2 == 0,
        jitter=np.full((256, 3), 1.1, np.float32))
    stage = jpeg.PackedJpegBatch(big, np.zeros(256, np.int32), plan)
    rates = {}
    for label, run in (("decode", lambda: jpeg.decode_images(packed, offsets,
                                                             cuda)),
                       ("decode+stage", lambda: stage.decode(cuda))):
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rates[label] = 256 / statistics.median(times)
    mb = offsets[-1] / 1e6
    _say(f"[nvjpeg] batch of 256 JPEGs ({mb:.2f} MB, sides 300-500), "
         f"gpu_hybrid decoder: decode {rates['decode']:.1f} images/s, decode with the train "
         f"stage (resize, crop 224, flip, jitter, uint8) "
         f"{rates['decode+stage']:.1f} images/s (median of 3, host wall)")
    _nvjpeg_mixed(nv, big)
    line = {"name": "ycc_to_rgb", "route": "cuda", "source": NVJPEG_SOURCE,
            "replaces": YCC_REPLACES, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}
    return {**worst, **{f"{k}_images_s": v for k, v in rates.items()},
            "kernel": line}


def _nvjpeg_mixed(nv, big: list[bytes]) -> None:
    """The process's one encoder at quality 90, 95 and 90 again (the
    builders' re-encode is 95, the records' 90): the two 90s give the
    same bytes, the 95 more. Then the 256 JPEGs of ``big``, those
    re-encodes and a grayscale JPEG, decoded in batches whose sizes
    alternate (``NVJPEG_MIXED_BATCHES``, each one re-initializing the
    batched decode), every image within the decode's bounds
    (``NVJPEG_MAX_LSB``, ``NVJPEG_MEAN_LSB``) of its decode in one batch
    of all."""
    import torch

    from deepvision_tpu_torch.data import jpeg

    srcs = jpeg.decode_images(*jpeg.pack(big[:4]), nv.device)
    runs = [[nv.encode(x, q) for x in srcs] for q in (90, 95, 90)]
    assert runs[0] == runs[2], "quality 90 after 95 gave other bytes"
    assert all(len(b95) > len(b90) for b90, b95 in zip(*runs[:2])), (
        [len(b) for b in runs[0]], [len(b) for b in runs[1]])
    gray = np.repeat(np.repeat(np.arange(0, 240, 8, dtype=np.uint8)
                               .reshape(5, 6), 8, 0), 8, 1)
    blobs = [*big, *runs[1], _gray_jpeg(gray)]
    want = jpeg.decode_images(*jpeg.pack(blobs), nv.device)
    # each size in turn, over the list from where the last batch ended
    # (wrapping round): every image decoded three or four times
    got, order, at = [], [], 0
    for n in NVJPEG_MIXED_BATCHES:
        idx = [(at + i) % len(blobs) for i in range(n)]
        got += jpeg.decode_images(*jpeg.pack([blobs[i] for i in idx]),
                                  nv.device)
        order += idx
        at += n
    torch.cuda.synchronize()
    assert len(set(order)) == len(blobs), len(set(order))
    pairs = [(got[j], want[i]) for j, i in enumerate(order)]
    assert all(g.shape == w.shape for g, w in pairs)
    gaps = [(g.int() - w.int()).abs() for g, w in pairs]
    top = max(d.max().item() for d in gaps)
    mean = (sum(d.sum().item() for d in gaps)
            / sum(d.numel() for d in gaps))
    # gpu_hybrid decodes a batch over 100 on the card and a smaller one
    # through the host's Huffman decode, whose pixels differ by a step or
    # two; a mix-up of images or planes is tens of steps off
    assert top <= NVJPEG_MAX_LSB and mean <= NVJPEG_MEAN_LSB, (top, mean)
    # a DC-only file of 8x8-constant blocks: its levels within a step
    assert np.abs(want[-1][..., 0].cpu().numpy().astype(int)
                  - gray).max() <= 1
    _say(f"[nvjpeg] one encoder at quality 90, 95, 90: the 90s the same "
         f"bytes, the 95s {sum(map(len, runs[1]))} bytes against "
         f"{sum(map(len, runs[0]))}; {len(blobs)} JPEGs (4 of them those "
         f"95s, one grayscale) decoded in batches of "
         f"{list(NVJPEG_MIXED_BATCHES)}: against "
         f"their decode in one batch of {len(blobs)} max {top} steps, mean "
         f"{mean:.4f} (bounds {NVJPEG_MAX_LSB}, {NVJPEG_MEAN_LSB})")


def _reader_rates(d: Path) -> dict:
    """Host records/s of the raw-crop reader at batch 256 (one thread):
    the crop only (``device_aug``) and the crop with the host flip and
    jitter, over the batches after the shuffle buffer's first fill."""
    from deepvision_tpu_torch.data import imagenet

    files = sorted(d.glob("raw-train-*"))
    out = {}
    for device_aug in (True, False):
        it = imagenet.raw_train_batches(files, 256, 224, seed=0, steps=4,
                                        augment="pt", device_aug=device_aug)
        t0 = time.perf_counter()
        next(it)  # reads every file into the shuffle buffer
        fill = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = sum(len(b["label"]) for b in it)
        rate = n / (time.perf_counter() - t0)
        out["crop" if device_aug else "crop+flip+jitter"] = rate
        _say(f"[records] host raw reader, "
             f"{'crop only' if device_aug else 'crop, flip and jitter'}: "
             f"{rate:.1f} records/s after the first batch ({fill:.2f} s: "
             f"the shuffle buffer's fill from disk); one host thread")
    return out


def _feed_run(trainer, d: Path, label: str, use_raw, device_aug: bool,
              mixup: float) -> dict:
    """The training step of ``trainer`` (resnet50, bf16, batch 256) fed
    by the ImageNet reader over ``d``: images/s through the device feed
    over ``RECORD_TIMED_STEPS`` steps after 2, the same step (augmentation
    included) on a device-resident batch, the feed's telemetry, and
    profiler windows (idle share) over two fed steps each."""
    from functools import partial

    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.device_aug import (
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.imagenet import PT_JITTER, make_imagenet_data
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher
    from deepvision_tpu_torch.train.steps import classification_train_step

    warm, timed, windows = 2, RECORD_TIMED_STEPS, 2
    total = warm + timed + 2 * (1 + windows)
    train_data, _, _ = make_imagenet_data(
        str(d), 256, 224, augment="pt", use_raw=use_raw,
        steps_per_epoch=total, device_aug=device_aug)
    step = partial(classification_train_step, normalize_kind="torch")
    if device_aug:
        step = augment_step(step, DeviceAugment(
            "classification", flip=True, jitter=PT_JITTER, mixup=mixup))
    keys = KeySeq(1, 7, device="cuda")
    state = trainer.state
    feed = DevicePrefetcher(train_data(0), torch.device("cuda"), depth=2)
    try:
        first = next(feed)
        step(state, first, next(keys))["loss"].item()
        resident = {k: v.clone() for k, v in first.items()}
        step(state, next(feed), next(keys))["loss"].item()
        tel0 = feed.telemetry.summary()
        t0 = time.perf_counter()
        for _ in range(timed):
            m = step(state, next(feed), next(keys))
        m["loss"].item()
        fed = timed * 256 / (time.perf_counter() - t0)
        tel = feed.telemetry.summary()

        def two_fed_steps():
            for _ in range(2):
                step(state, next(feed), next(keys))
            torch.cuda.synchronize()

        prof = _profile(two_fed_steps, f"resnet50 {label}: two fed steps",
                        top=5, windows=windows)
    finally:
        feed.close()
    for _ in range(2):
        step(state, resident, next(keys))["loss"].item()
    t0 = time.perf_counter()
    for _ in range(timed):
        m = step(state, resident, next(keys))
    m["loss"].item()
    dev = timed * 256 / (time.perf_counter() - t0)
    assert np.isfinite(m["loss"].item())
    assert tel["wire_dtype"] == ("uint8" if use_raw else "jpeg"), tel
    if use_raw:
        assert tel["image_bytes_per_image"] == 224 * 224 * 3, tel
    _say(f"[records] resnet50 bf16 batch 256, {label}: {fed:.1f} images/s "
         f"through the feed over {timed} steps, {dev:.1f} images/s on a "
         f"device-resident batch (same step); wire {tel['wire_dtype']}, "
         f"h2d_bytes_per_image {tel['h2d_bytes_per_image']} (image bytes "
         f"{tel['image_bytes_per_image']}), h2d_wait {tel['h2d_wait_ms']} ms "
         f"and host_wait {tel['host_wait_ms']} ms a batch (first two "
         f"batches: {tel0['h2d_wait_ms']} and {tel0['host_wait_ms']}), "
         f"staging {tel['shard_ms']} ms a batch; idle share {prof['idle']}")
    return {"fed": fed, "resident": dev, "idle": prof["idle"], **tel}


def _run_clis(runs: dict[str, list[str]]) -> dict[str, tuple[str, str]]:
    """The training CLI for each run at once (one process each, on the
    one card); (stdout, stderr) by run. Fails if any fails."""
    procs = {label: subprocess.Popen(
        [sys.executable, "-m", "deepvision_tpu_torch.train", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=_train_env())
        for label, args in runs.items()}
    out = {}
    for label, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, (label, stdout[-2000:], stderr[-4000:])
        out[label] = stdout, stderr
    return out


def phase_records(smi: str, workdir: Path) -> dict:
    """The record-backed ImageNet path of ``resnet50`` at batch 256:
    synthetic shards written on the card (``raw-train-*`` frames 256 by
    256-512 with their sidecar; ``train-*`` and ``validation-*`` JPEGs
    encoded by nvJPEG, sides 300-500), the host reader's records/s, then
    in this process the step fed by the reader for ``--raw --device-aug
    --mixup 0.2``, ``--raw`` and ``--no-raw --device-aug`` beside the same
    step on a device-resident batch, and validation over the JPEG shards
    (their training CLIs run later, :func:`_records_clis`). Returns the
    reader's rates, the runs and the shards' directory."""
    import torch

    from deepvision_tpu_torch.data.jpeg import nvjpeg
    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_imagenet,
    )
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.trainer import Trainer

    d = workdir / "records"
    t0 = time.perf_counter()
    counts = write_synthetic_imagenet(
        d, train=RECORD_BATCHES * 256, val=RECORD_VAL, raw=RECORD_BATCHES * 256,
        classes=1000, shards=8, jpeg_sizes=(300, 500), device="cuda")
    size_mb = sum(p.stat().st_size for p in d.iterdir()) / 1e6
    _say(f"[records] wrote {counts} ({size_mb:.1f} MB in {len(list(d.iterdir()))}"
         f" files) under {d.name}/ in {time.perf_counter() - t0:.1f} s")
    rates = _reader_rates(d)

    cfg = get_config("resnet50")
    module = create_model("resnet50", device=torch.device("cuda"), seed=0,
                          dtype=torch.bfloat16, **cfg["model_kwargs"])
    from deepvision_tpu_torch.data.imagenet import make_imagenet_data

    _, val_data, _ = make_imagenet_data(str(d), 256, 224, augment="pt",
                                        steps_per_epoch=1)
    trainer = Trainer(module, cfg, lambda e: iter(()), val_data,
                      workdir=workdir / "records_inproc", log_every=0,
                      steps_per_epoch=1)
    nv = nvjpeg("cuda")
    nv.ycc_launches = 0
    runs = {}
    for label, use_raw, device_aug, mixup in (
            ("--raw --device-aug --mixup 0.2", True, True, 0.2),
            ("--raw", True, False, 0.0),
            ("--no-raw --device-aug", False, True, 0.0)):
        runs[label] = _feed_run(trainer, d, label, use_raw, device_aug, mixup)
    t0 = time.perf_counter()
    val = trainer.validate()
    _say(f"[records] validation over {RECORD_VAL} JPEGs (two batches, the "
         f"last padded and masked) in {time.perf_counter() - t0:.2f} s: "
         f"{val}")
    assert np.isfinite(val["val_loss"]), val
    _say(f"[records] ycc_to_rgb launched {nv.ycc_launches} times by the "
         f"JPEG feed and validation above")
    assert nv.ycc_launches > 0
    trainer = module = None
    torch.cuda.empty_cache()
    return {"reader": rates, "runs": runs, "dir": d}


def _records_clis(d: Path, workdir: Path) -> dict:
    """The training CLI over :func:`phase_records`' shards for each of its
    three reader configurations, 1 epoch with validation and a
    checkpoint, and a resume to epoch 2, the three at once (run beside
    the training CLIs). Each CLI launched ``ycc_to_rgb`` once for each
    JPEG batch it decoded: the validation batches of each validation
    (before training and after each epoch) and, reading the JPEG shards,
    each training batch. Returns those launches by run."""
    from deepvision_tpu_torch.train import manifest

    steps = 2
    common = ["-m", "resnet50", "--data-dir", str(d), "--steps-per-epoch",
              str(steps)]
    flags = {"raw_device_aug_mixup": ["--raw", "--device-aug", "--mixup",
                                      "0.2"],
             "raw": ["--raw"], "jpeg_device_aug": ["--no-raw", "--device-aug"]}
    t0 = time.perf_counter()
    first = _run_clis({k: [*common, *v, "--epochs", "1", "--workdir",
                           str(workdir / f"cli_{k}")]
                       for k, v in flags.items()})
    second = _run_clis({k: [*common, *v, "--epochs", "2", "--resume",
                            "--workdir", str(workdir / f"cli_{k}")]
                        for k, v in flags.items()})
    val_batches = -(-RECORD_VAL // 256)
    launches = {}
    for k, v in flags.items():
        out = first[k][0] + second[k][0]
        assert "[pre-train] val_loss=" in first[k][0], first[k][0][-2000:]
        assert "resumed at epoch 1" in second[k][0], second[k][0][-2000:]
        # epoch 0: validation before and after it; epoch 1: after it
        train_jpeg = steps if "--no-raw" in v else 0
        path = f"train_cli {' '.join(v)}"
        launches[path] = 0
        for run, validations in ((first[k], 2), (second[k], 1)):
            n = _cli_launches(run[1])
            assert n["ycc_to_rgb"] == validations * val_batches + train_jpeg, (
                k, n)
            assert n["lrn_forward_bf16"] == n["lrn_backward_bf16"] == 0, n
            launches[path] += n["ycc_to_rgb"]
        wire = re.findall(r"^\[feed\] epoch \d: wire (\S+), ([\d.]+) bytes an "
                          r"image crossed \(([\d.]+) of them", out, re.M)
        assert len(wire) == 2, out[-2000:]
        for dtype, total, image in wire:
            assert dtype == ("jpeg" if "--no-raw" in v else "uint8"), wire
            if dtype == "uint8":
                assert float(image) == 224 * 224 * 3, wire
        loss = [float(x) for x in re.findall(r"\] train_loss=(\S+)", out)]
        assert len(loss) == 2 and np.all(np.isfinite(loss)), loss
        for e in (0, 1):
            ckpt = workdir / f"cli_{k}" / "resnet50" / "ckpt"
            assert manifest.verify_manifest(ckpt, e) == (True, "ok"), (k, e)
        for line in out.splitlines():
            if line.startswith(("[epoch 0]", "[epoch 1]", "[feed]",
                                "[device-aug]", "[data]")):
                _say(f"[records-cli] {' '.join(v)}: {line[:260]}")
    _say(f"[records-cli] the three CLIs trained, validated over the JPEG "
         f"shards, checkpointed and resumed ({time.perf_counter() - t0:.1f} s,"
         f" run at once on the one card); ycc_to_rgb launches {launches}")
    return launches


def phase_remat_memory(batch: int = 128, steps: int = 5) -> dict:
    """``resnet152`` in bf16 at a batch where every policy fits: peak
    allocated memory and step time under no remat, ``"block"`` and
    ``"conv"``, the same seeded weights and batch."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    cfg = get_config("resnet152")
    kw = {k: v for k, v in cfg["model_kwargs"].items() if k != "remat"}
    host = _train_batch(batch)
    out = {}
    for policy in (None, "block", "conv"):
        torch.cuda.empty_cache()
        module = create_model("resnet152", device=torch.device("cuda"),
                              seed=0, dtype=torch.bfloat16, remat=policy,
                              **kw)
        opt, _ = make_optimizer(cfg, module.parameters(), 1000)
        state = TrainState(module, opt)
        resident = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        keys = KeySeq(1, 0, device="cuda")
        for _ in range(2):
            classification_train_step(state, resident, next(keys),
                                      "torch")["loss"].item()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            m = classification_train_step(state, resident, next(keys),
                                          "torch")
        m["loss"].item()
        ms = (time.perf_counter() - t0) / steps * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[str(policy)] = {"step_ms": ms, "peak_gib": peak}
        _say(f"[resnet152] remat={policy} bf16 batch {batch}: {ms:.1f} ms a "
             f"step, {batch / ms * 1e3:.1f} images/s, peak allocated "
             f"{peak:.2f} GiB")
        module = state = opt = resident = None
    return out


def phase_remat_step(n: int = 8) -> dict:
    """One float32 ``resnet152`` step at batch ``n`` (TF32 off, cuDNN's
    deterministic algorithms) under ``"block"`` and ``"conv"`` against
    the un-rematerialized step from the same weights: the BN running
    statistics bit for bit (a second running update in the recompute
    would move them), each parameter within 1e-6 plus three times its
    gap between two plain runs (the max pool's backward adds with
    atomics in no fixed order)."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    strict_fp32()
    cfg = get_config("resnet152")
    kw = {k: v for k, v in cfg["model_kwargs"].items() if k != "remat"}
    base = create_model("resnet152", device=torch.device("cuda"), seed=0,
                        **kw)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(n, seed=5).items()}

    def run(policy):
        module = copy.deepcopy(base)
        module.remat = policy
        opt, _ = make_optimizer(cfg, module.parameters(), 1000)
        state = TrainState(module, opt)
        loss = classification_train_step(state, batch, next(KeySeq(1, 0)),
                                         "torch")["loss"].item()
        torch.cuda.synchronize()
        return loss, {k: v.detach().clone()
                      for k, v in module.state_dict().items()}

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, plain2, block, conv = (run(p) for p in (None, None, "block",
                                                       "conv"))
    finally:
        torch.backends.cudnn.deterministic = was
    stats = [k for k in plain[1] if k.endswith((".mean", ".var"))]
    noise = {k: (plain2[1][k] - plain[1][k]).abs().max().item()
             for k in plain[1]}
    out = {}
    for name, got in (("block", block), ("conv", conv)):
        assert got[0] == plain[0], (name, got[0], plain[0])
        for k in stats:
            assert torch.equal(got[1][k], plain[1][k]), (name, k)
        gaps = {k: (got[1][k] - plain[1][k]).abs().max().item()
                for k in plain[1] if k not in stats}
        over = [k for k, g in gaps.items() if g > 1e-6 + 3 * noise[k]]
        assert not over, (name, over[:5])
        out[name] = max(gaps.values())
        _say(f"[resnet152] remat={name} f32 step at batch {n} against the "
             f"plain step: loss {got[0]:.6f} equal, all {len(stats)} BN "
             f"statistic tensors bit for bit, parameters within "
             f"{out[name]:.3e} (plain against plain: "
             f"{max(noise.values()):.3e})")
    return out


def phase_resnet152(smi: str, workdir: Path) -> dict:
    """``resnet152`` under its registry default ``remat="block"``: the
    Trainer at batch 256 in bf16 (all BN statistics moved), images/s with
    MFU and peak memory, the three policies' memory and time at batch
    128, the rematerialized step against the plain one, one served
    batch."""
    import torch

    _, trainer = _timed("resnet152 trainer", phase_trainer,
                        workdir / "inproc_resnet152", "resnet152", lrns=0)
    assert trainer.state.module.remat == "block"
    r = _timed("resnet152 throughput", phase_throughput, trainer,
               "resnet152", steps=RESNET152_TIMED_STEPS)
    trainer = None
    torch.cuda.empty_cache()
    _say(f"[resnet152] train bf16 batch 256, remat=block: {r['fed']:.1f} "
         f"images/s fed, {r['resident']:.1f} resident; MFU "
         f"{r['mfu']['feed']:.2%} fed, {r['mfu']['resident']:.2%} resident "
         f"({r['flops']:.4e} model FLOPs a step, the recompute not counted); "
         f"device time {r['device_ms']} ms a step, idle {r['idle']}; peak "
         f"allocated {r['peak_gb']:.2f} GiB ({smi})")
    memory = _timed("resnet152 remat memory", phase_remat_memory)
    step = _timed("resnet152 remat step", phase_remat_step)
    _timed("resnet152 served batch", phase_served_batch, "resnet152")
    return {"throughput": r, "memory": memory, "step": step}


# ------------------------------------------------------------ YOLO v3


def _detection_host_batch(n: int, size: int, seed: int = 0,
                          classes: int = YOLO_CLASSES) -> dict:
    """A seeded host batch of ``n`` float32 images in [-1, 1] with 1-4
    padded boxes each, two planted on one grid slot in image 0 (trap
    C16)."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n, MAX_BOXES, 4), np.float32)
    labels = np.full((n, MAX_BOXES), -1, np.int32)
    for i in range(n):
        for j in range(int(rng.integers(1, 5))):
            w, h = rng.uniform(0.02, 0.8, 2)
            boxes[i, j] = [rng.uniform(w / 2, 1 - w / 2),
                           rng.uniform(h / 2, 1 - h / 2), w, h]
            labels[i, j] = rng.integers(0, classes)
    boxes[0, 4:6] = [[0.5, 0.5, 0.1, 0.1], [0.501, 0.502, 0.1, 0.1]]
    labels[0, 4:6] = [1, 2]
    return {"image": rng.uniform(-1, 1, (n, size, size, 3)).astype(
                np.float32), "boxes": boxes, "label": labels}


def _near_threshold_pairs(rng, n: int) -> np.ndarray:
    """``n`` adjacent pairs of equal boxes shifted by a third of their
    width (IoU 1/2 up to float32 rounding), jittered by an ulp (trap
    C18)."""
    w = rng.uniform(0.05, 0.3, n).astype(np.float32)
    h = rng.uniform(0.05, 0.3, n).astype(np.float32)
    x = rng.uniform(0, 0.6, n).astype(np.float32)
    y = rng.uniform(0, 0.6, n).astype(np.float32)
    d = np.nextafter((w / np.float32(3)).astype(np.float32), np.where(
        rng.random(n) < 0.5, 0, 1).astype(np.float32))
    a = np.stack([x, y, x + w, y + h], -1)
    b = np.stack([x + d, y, x + d + w, y + h], -1)
    return np.stack([a, b], 1).reshape(2 * n, 4).astype(np.float32)


def _nms_cases(grids) -> dict:
    """The NMS inputs held on the card (boxes, scores, classes, on the
    card): ``yolov3``'s candidates at bucket 64 and 16 (N = 10,647 at
    416, from the seeded head on seeded images), N < K, planted equal
    scores (a third at exactly 1.0, trap C17) and planted near-threshold
    pairs (trap C18)."""
    import torch

    from deepvision_tpu_torch.ops.yolo_postprocess import yolo_candidates

    boxes, scores, classes = yolo_candidates(grids, YOLO_CLASSES)
    assert boxes.shape == (BUCKETS[-1], YOLO_N, 4), boxes.shape
    cases = {"yolov3_b64": (boxes, scores, classes),
             "yolov3_b16": (boxes[:16], scores[:16], classes[:16])}
    rng = np.random.default_rng(11)

    def random(b, n):
        c = rng.uniform(0, 1, (b, n, 2))
        wh = rng.uniform(0.02, 0.3, (b, n, 2))
        bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        sc = rng.uniform(0, 1, (b, n)).astype(np.float32)
        cl = rng.integers(0, YOLO_CLASSES, (b, n)).astype(np.int32)
        return bx, sc, cl

    bx, sc, cl = random(16, 300)
    cases["n_300_below_k"] = bx, sc, cl
    bx, sc, cl = random(16, YOLO_N)
    sc[rng.uniform(0, 1, sc.shape) < 0.33] = 1.0
    sc[rng.uniform(0, 1, sc.shape) < 0.2] = np.float32(0.75)
    cases["planted_ties"] = bx, sc, cl
    bx, sc, cl = random(16, YOLO_N)
    for i in range(16):
        bx[i, :400] = _near_threshold_pairs(rng, 200)
        sc[i, :400] = np.linspace(1.0, 0.99, 400)
    cases["planted_near_threshold"] = bx, sc, cl
    return {k: tuple(torch.as_tensor(a).cuda() for a in v)
            for k, v in cases.items()}


def _nms_bound_ms(b: int, k: int) -> tuple[float, str]:
    """Least time for the sweep of ``b`` images of ``k`` candidates:
    each box (16 bytes) and seed (1 byte) read once and each flag (1
    byte) written once, over the HBM rate, against the K(K-1)/2 IoUs of
    ``NMS_IOU_OPS`` float32 operations each, over the float32 rate."""
    bytes_s = b * k * (16 + 1 + 1) / HBM_BYTES_PER_S
    ops_s = b * k * (k - 1) / 2 * NMS_IOU_OPS / F32_OPS_PER_S
    return (bytes_s * 1e3, "bytes") if bytes_s >= ops_s else (
        ops_s * 1e3, "operations")


def phase_nms(served) -> dict:
    """The NMS sweep kernel against its plain version on the card, at
    every case of :func:`_nms_cases` and score thresholds 0.5 and 0.05:
    the alive masks of the kernel and the plain sweep on the same sorted
    candidates identical, and ``batched_nms`` on the card (kernel) equal
    to ``batched_nms`` on this machine's CPU (plain version, CPU sort):
    indices, boxes, scores, classes, valid and ``n_candidates``. Then the
    times (``timing.time_ms``) at bucket 64: the kernel, its plain
    version and ``yolo_postprocess`` whole, beside the bound."""
    import torch

    from deepvision_tpu_torch.ops import nms
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda
    from deepvision_tpu_torch.ops.yolo_postprocess import yolo_postprocess
    from deepvision_tpu_torch.timing import time_ms

    x = (np.random.default_rng(3).uniform(-1, 1, (BUCKETS[-1], YOLO_SIZE,
                                                  YOLO_SIZE, 3))
         .astype(np.float32))
    with torch.inference_mode():
        grids = served.module(torch.from_numpy(x).cuda())
    cases = _nms_cases(grids)
    over_cap = []
    for name, (boxes, scores, classes) in cases.items():
        for thresh in (0.5, 0.05):
            k = min(boxes.shape[1], nms.NMS_CANDIDATE_CAP)
            top, seeds, _, _, n_cand = nms.nms_prefilter(
                boxes, scores, score_thresh=thresh, k=k)
            kernel = nms_sweep_cuda(top, seeds, 0.5)
            plain = nms.nms_sweep_reference(top, seeds, 0.5)
            assert torch.equal(kernel, plain), (name, thresh, int(
                (kernel != plain).sum()))
            card = nms.batched_nms(boxes, scores, classes,
                                   score_thresh=thresh)
            cpu = nms.batched_nms(boxes.cpu(), scores.cpu(), classes.cpu(),
                                  score_thresh=thresh)
            for c, h in zip(card, cpu):
                assert torch.equal(c.cpu(), h), (name, thresh)
            kept = int(card[3].sum())
            if int(n_cand.max()) > nms.NMS_CANDIDATE_CAP:
                over_cap.append(f"{name}@{thresh}")
            _say(f"[nms] {name} (B={boxes.shape[0]}, N={boxes.shape[1]}, "
                 f"K={k}) at score {thresh}: alive masks identical "
                 f"({int(seeds.sum())} seeds, {int(kernel.sum())} alive), "
                 f"batched_nms on the card equal to the CPU's: {kept} kept, "
                 f"n_candidates at most {int(n_cand.max())}")
    assert over_cap, "no case put n_candidates above the cap"
    _say(f"[nms] n_candidates above the cap of {nms.NMS_CANDIDATE_CAP} in "
         f"{over_cap}: the tripwire's case, held all the same")

    boxes, scores, _ = cases["yolov3_b64"]
    top, seeds, _, _, _ = nms.nms_prefilter(boxes, scores, score_thresh=0.5,
                                            k=nms.NMS_CANDIDATE_CAP)
    b, k = seeds.shape
    ms = time_ms(lambda a: nms_sweep_cuda(a[0], a[1], 0.5), [(top, seeds)])
    plain_ms = time_ms(lambda a: nms.nms_sweep_reference(a[0], a[1], 0.5),
                       [(top, seeds)], **YARDSTICK)
    post_ms = time_ms(lambda g: yolo_postprocess(g, YOLO_CLASSES), [grids],
                      **YARDSTICK)
    bound_ms, bound_by = _nms_bound_ms(b, k)
    _say(f"[nms] times at bucket {b} (K={k}, {int(seeds.sum())} seeds at "
         f"score 0.5): kernel {ms:.4f} ms, plain version {plain_ms:.4f} ms, "
         f"bound {bound_ms:.4f} ms ({bound_by}; {ms and bound_ms / ms:.1%} "
         f"of it); yolo_postprocess whole {post_ms:.4f} ms (decode, "
         f"prefilter and compaction in torch ops, {post_ms - ms:.4f} ms "
         "beside the kernel); no PyTorch call computes NMS")
    return {"name": "nms_sweep_f32", "route": "cuda", "source": NMS_SOURCE,
            "replaces": NMS_REPLACES, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "yolo_postprocess_ms": post_ms}


def phase_encode_labels() -> None:
    """``encode_labels`` on the card equals the CPU's grids at 416 (52²,
    26², 13²), batch 16, with two boxes planted on one slot (trap C16:
    the last in index order owns it)."""
    import torch

    from deepvision_tpu_torch.ops.yolo_encode import encode_labels

    host = _detection_host_batch(16, 8)
    boxes, labels = (torch.from_numpy(host[k]) for k in ("boxes", "label"))
    cpu = encode_labels(boxes, labels, YOLO_CLASSES)
    card = encode_labels(boxes.cuda(), labels.cuda(), YOLO_CLASSES)
    for c, h in zip(card, cpu):
        assert torch.equal(c.cpu(), h)
    owner = cpu[1][0, 13, 13, :, :4]
    assert (owner == boxes[0, 5]).all(-1).any()
    _say(f"[encode] encode_labels on the card equals the CPU's grids "
         f"{[tuple(g.shape) for g in card]} bit for bit, the planted "
         f"collision's slot held by the later box")


def phase_adam_skip() -> None:
    """Trap C10: ``yolov3`` (full width, 128 px, batch 2) under
    ``bf16_scaled`` with Adam built by ``make_optimizer`` (its step count
    on the card): one clean step, then one whose images hold an inf, run
    under ``torch.cuda.set_sync_debug_mode("error")`` (any host sync
    raises). The step is skipped: every parameter, both Adam moments,
    Adam's step count and the BN statistics keep their values, and the
    loss scale halves."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import yolo_train_step

    policy = get_policy("bf16_scaled")
    module = create_model("yolov3", device=torch.device("cuda"), seed=0,
                          num_classes=YOLO_CLASSES,
                          dtype=policy.compute_dtype)
    opt, _ = make_optimizer(get_config("yolov3"), module.parameters())
    assert opt.param_groups[0]["capturable"]
    state = TrainState(module, opt, loss_scale=policy.make_loss_scale())
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _detection_host_batch(2, 128, seed=1).items()}
    yolo_train_step(state, batch, None)["loss"].item()
    before = {**{k: v.clone() for k, v in module.state_dict().items()},
              **{f"{i}:{k}": v.clone() for i, p in
                 enumerate(module.parameters())
                 for k, v in opt.state[p].items()}}
    scale = float(state.loss_scale.scale)
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 5, 5, 0] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = yolo_train_step(state, bad, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = {**module.state_dict(),
             **{f"{i}:{k}": v for i, p in enumerate(module.parameters())
                for k, v in opt.state[p].items()}}
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert not moved, moved[:5]
    assert float(m["mp_grads_finite"]) == 0.0
    assert float(state.loss_scale.scale) == scale / 2
    assert not torch.isfinite(m["loss"])
    steps = {str(v.device) for k, v in after.items() if k.endswith(":step")}
    _say(f"[adam] C10: a bf16_scaled yolov3 step with an inf in its images "
         f"ran with no host sync (sync debug mode 'error'); skipped: "
         f"{len(before)} tensors (parameters, BN statistics, Adam's "
         f"exp_avg, exp_avg_sq and step, on {sorted(steps)}) unchanged, "
         f"loss scale {scale:g} -> {float(state.loss_scale.scale):g}")


def _yolo_requests(served_shape=(YOLO_SIZE, YOLO_SIZE, 3)) -> np.ndarray:
    """The seeded requests of ``yolov3``'s serving phases."""
    return (np.random.default_rng(0).uniform(
        -1, 1, (YOLO_REQUESTS, *served_shape)).astype(np.float32))


def phase_yolo_serve(smi: str) -> tuple:
    """``load_served("yolov3")`` at 416x416x3 and 20 classes, seeded
    weights, float32 (TF32 off), behind an ``InferenceEngine`` on buckets
    (1, 4, 16, 64): 32 seeded requests queued at once (one bucket-64
    batch) and 4 one at a time (bucket 1), each answer bit for bit the
    eager forward's at its bucket and identical (boxes, scores, classes)
    to the same module's batch post-processed with the plain NMS sweep;
    the NMS kernel launched once a replay, no LRN; then profiler windows
    over a bucket-64 batch, on the graph and eager. Returns (the served
    model, the path's NMS launches, the profile, the graphs' report, the
    answers)."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.ops.nms import nms_sweep_reference
    from deepvision_tpu_torch.ops.yolo_postprocess import yolo_postprocess
    from deepvision_tpu_torch.serve import InferenceEngine, load_served
    from deepvision_tpu_torch.serve.models import _detect_post, _to_host

    strict_fp32()
    # the same convolution algorithms in the engine's graphs, the eager
    # run and the plain one, so that their grids are the same bits and
    # only NMS differs
    torch.backends.cudnn.deterministic = True
    served = load_served("yolov3", seed=0)
    assert served.task == "detect"
    assert served.input_shape == (YOLO_SIZE, YOLO_SIZE, 3)
    xs = _yolo_requests(served.input_shape)

    def plain(batch):
        with torch.inference_mode():
            out = yolo_postprocess(
                served.module(torch.from_numpy(batch).cuda()), YOLO_CLASSES,
                sweep=nms_sweep_reference)
        keys = ("boxes", "scores", "classes", "valid")
        return _to_host(dict(zip(keys, out[:4])))

    t0 = time.perf_counter()
    batches = [xs] + [xs[i:i + 1] for i in range(4)]
    with InferenceEngine([served], buckets=BUCKETS,
                         freeze_cache=True) as eng:
        misses = eng.stats()["cache"]["misses"]
        eager_answers = _eager_answers(served, batches)
        _zero_launch_counts()
        rounds = _graph_rounds(eng, served, batches, eager_answers)
        stats = eng.stats()
        launches, lrn = _nms_launches(), sum(_launch_counts().values())
        wall = time.perf_counter() - t0
        graphs = _graph_report("yolov3", eng, "yolov3", misses)
    graphs["reserved_after_close"] = _closed("yolov3")
    # the served batch's times under cuDNN's default algorithms, as the
    # serving CLI runs: a bucket-64 graph captured under them, and eager
    torch.backends.cudnn.deterministic = False
    batch = np.zeros((BUCKETS[-1], *served.input_shape), np.float32)
    batch[:len(xs)] = xs
    prof = _profile_largest(served, batch, graphs,
                            label=f"yolov3 bucket-{BUCKETS[-1]} batch f32",
                            eager=True, share_of="nms")
    graphs["profile"] = prof
    answers, singles = rounds[0], [r[0] for r in rounds[1:]]
    tel = stats["telemetry"]
    padded = np.zeros((BUCKETS[-1], *served.input_shape), np.float32)
    padded[:len(xs)] = xs
    torch.backends.cudnn.deterministic = True
    want = plain(padded)
    for i, a in enumerate(answers):
        assert a == _detect_post(want, i), i
    for i, a in enumerate(singles):
        assert a == _detect_post(plain(xs[i:i + 1]), 0), i
    torch.backends.cudnn.deterministic = False
    assert launches == tel["batches"] == 5, (launches, tel)
    assert lrn == 0
    for per in graphs["launches_per_replay"].values():
        assert per == {"nms_sweep": 1}, per
    kept = [len(a["scores"]) for a in answers]
    _say(f"[yolo-serve] yolov3 f32 at {YOLO_SIZE}, {YOLO_CLASSES} classes: "
         f"{len(xs)} queued requests (one bucket-64 batch) and 4 single "
         f"ones answered in {wall:.1f} s by CUDA graph replays, bit for bit "
         f"the eager forward's and with detections identical to the "
         f"plain-NMS run of the same batches; kept {min(kept)}-{max(kept)} "
         f"boxes a request; batches {tel['batches']}, NMS kernel launches "
         f"{launches} (one a replay), LRN {lrn}; e2e latency p50 "
         f"{tel['e2e_latency']['p50_ms']} ms, device time a batch p50 "
         f"{tel['device_time']['p50_ms']} ms")
    return served, launches, prof, graphs, answers + singles


def _cli(module: str, args: list[str], stdin: str | None = None
         ) -> subprocess.CompletedProcess:
    """``python -m <module> <args>`` from the checkout; fails if it
    fails."""
    proc = subprocess.run(
        [sys.executable, "-m", module, *args], input=stdin,
        capture_output=True, text=True, cwd=ROOT, timeout=900,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, (module, proc.stdout[-2000:],
                                  proc.stderr[-4000:])
    return proc


def _fed_and_resident(label: str, module, step, train_data, bs: int,
                      size: int, timed: int, share_of: str = "nms",
                      windows: int = 3) -> dict:
    """``step`` (an augmented train step) at batch ``bs`` fed by the
    reader's ``train_data(0)`` (JPEGs decoded on the card by nvJPEG,
    cropped and resized there): images/s through the feed and on a
    device-resident batch, the feed's telemetry, MFU, peak memory and
    profiler windows (idle share: ``windows`` card-only ones over two fed
    steps, as many over a resident step)."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher

    keys = KeySeq(1, 5, device="cuda")
    feed = DevicePrefetcher(train_data(0), torch.device("cuda"), depth=2)
    try:
        first = next(feed)
        step(first, next(keys))["loss"].item()
        resident = {k: v.clone() for k, v in first.items()}
        step(next(feed), next(keys))["loss"].item()
        t0 = time.perf_counter()
        for _ in range(timed):
            m = step(next(feed), next(keys))
        m["loss"].item()
        fed = timed * bs / (time.perf_counter() - t0)
        tel = feed.telemetry.summary()

        def two_fed_steps():
            for _ in range(2):
                step(next(feed), next(keys))
            torch.cuda.synchronize()

        idle_fed = _idle_share(two_fed_steps, f"{label} two fed steps",
                               windows)
    finally:
        feed.close()
    for _ in range(2):
        step(resident, next(keys))["loss"].item()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        m = step(resident, next(keys))
    m["loss"].item()
    dev = timed * bs / (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    x = torch.zeros(1, size, size, 3, device="cuda")
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(x)
    flops = 3 * bs * float(counter.get_total_flops())
    mfu = {k: flops * v / bs / BF16_DENSE_FLOPS_PER_S
           for k, v in (("fed", fed), ("resident", dev))}

    def one_step():
        step(resident, next(keys))
        torch.cuda.synchronize()

    prof = _profile(one_step, f"{label} train step batch {bs}",
                    share_of=share_of, windows=windows)
    assert np.isfinite(m["loss"].item())
    assert tel["wire_dtype"] == "jpeg", tel
    _say(f"[{label}-records] {label} batch {bs} at {size}: {fed:.1f} "
         f"images/s through the feed over {timed} steps, {dev:.1f} "
         f"images/s on a device-resident batch (same step); wire "
         f"{tel['wire_dtype']}, {tel['image_bytes_per_image']} JPEG bytes "
         f"an image, h2d_wait {tel['h2d_wait_ms']} ms and host_wait "
         f"{tel['host_wait_ms']} ms a batch; model FLOPs {flops:.4e} a step "
         f"(backward twice the forward), MFU {mfu['fed']:.2%} fed and "
         f"{mfu['resident']:.2%} resident; peak allocated {peak_gb:.2f} "
         f"GiB; idle share fed {idle_fed}, resident {prof['idle']}; "
         f"{prof['launches']} launches a resident step")
    return {"fed": fed, "resident": dev, "mfu": mfu, "peak_gb": peak_gb,
            "idle_fed": idle_fed, "idle": prof["idle"],
            "device_ms": prof["device_ms"], "launches": prof["launches"]}


def _yolo_feed_run(d: Path) -> dict:
    """``yolov3``'s bf16 step at 416 and batch 16 (Adam, the detection
    flip in the step) fed by the detection reader over ``d``
    (:func:`_fed_and_resident`)."""
    import torch

    from deepvision_tpu_torch.data.detection import make_detection_data
    from deepvision_tpu_torch.data.device_aug import (
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import yolo_train_step

    cfg = get_config("yolov3")
    bs = cfg["batch_size"]
    module = create_model("yolov3", device=torch.device("cuda"), seed=0,
                          num_classes=YOLO_CLASSES, dtype=torch.bfloat16)
    opt, _ = make_optimizer(cfg, module.parameters())
    state = TrainState(module, opt)
    step = augment_step(yolo_train_step, DeviceAugment("detection",
                                                       flip=True))
    train_data, _, _ = make_detection_data(
        str(d), bs, YOLO_SIZE, steps_per_epoch=2 + YOLO_TIMED_STEPS + 8,
        device_aug=True)
    return _fed_and_resident("yolov3", module, partial(step, state),
                             train_data, bs, YOLO_SIZE, YOLO_TIMED_STEPS)


def phase_yolo_records(smi: str, workdir: Path) -> dict:
    """The detection path from records: synthetic ``train-*`` (256) and
    ``val-*`` (64) shards of 8 each written on the card (nvJPEG's
    encoder; 20 classes, sides 300-500) and the fed step
    (:func:`_yolo_feed_run`). Returns the rates and the records'
    directory, whose CLIs (:func:`_yolo_clis`) run with the other
    models' in :func:`phase_model_clis`."""
    import torch

    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_detection,
    )

    d = workdir / "detection_records"
    t0 = time.perf_counter()
    counts = write_synthetic_detection(d, train=256, val=64,
                                       classes=YOLO_CLASSES, shards=8)
    _say(f"[yolo-records] wrote {counts} on the card (nvJPEG) in "
         f"{time.perf_counter() - t0:.1f} s")
    rates = _yolo_feed_run(d)
    torch.cuda.empty_cache()
    return {**rates, "records": d}


def _yolo_clis(d: Path, workdir: Path, images: dict, offer) -> dict:
    """``yolov3``'s CLIs over its records (:func:`_model_clis`): the
    training CLI ``--data-dir ... --device-aug`` at the config's 416,
    batch 16 and bf16 for 1 epoch of ``YOLO_CLI_STEPS`` steps,
    ``--resume`` to 2, and from that checkpoint the ``eval detection``
    CLI over the ``val-*`` shards (the mAP line is printed, not gated)
    and beside it ``predict detect`` on a JPEG (:func:`_predict_detect`);
    the checkpoint is offered to the serving CLI (``offer``, held by
    :func:`_yolo_served`). Returns the NMS launches by path and the mAP
    line."""
    clis = _model_clis(
        "yolov3", d, workdir / "yolo_cli", YOLO_SIZE,
        ["--steps-per-epoch", str(YOLO_CLI_STEPS)], offer, _yolo_served,
        ["detection"], partial(_predict_detect, image=images["jpeg"]))
    line = clis["eval"]
    eval_nms = clis["eval_launches"]["nms_sweep"]
    assert line["metric"] == "mAP" and line["images"] == 64, line
    assert eval_nms == 4, eval_nms
    _say(f"[yolo-cli] NMS kernel launches eval {eval_nms}")
    return {"nms_launches": {"eval_cli": eval_nms,
                             "predict_cli": clis["beside"]},
            "map": line}


def _yolo_served(replies: list, launches: dict, runners: dict) -> int:
    """The serving CLI's detections for ``yolov3`` (one NMS launch a
    replay, the only NMS launches of that process); returns its NMS
    launches."""
    assert all(set(r["result"]) == {"boxes", "scores", "classes"}
               for r in replies)
    assert all(b["launches"] == {"nms_sweep": 1}
               for b in runners["buckets"].values()), runners
    # the eager forwards of the 2 buckets' captures, then 1 or 2 replays
    serve_nms = launches["nms_sweep"]
    assert 3 <= serve_nms <= 4, serve_nms
    _say(f"[yolo-cli] NMS kernel launches serve {serve_nms}")
    return serve_nms


def _predict_detect(wd: Path, image: str) -> int:
    """``predict detect -m yolov3`` from the chain's checkpoint at 416:
    its boxes, scores and classes those of ``load_served(...).run`` on
    the same decoded tensor (boxes and scores within ``PREDICT_TOL``).
    Returns its NMS launches (one)."""
    t0 = time.perf_counter()
    p = _predict_served(
        "yolov3", wd, image,
        ["detect", "-m", "yolov3", "--workdir", str(wd), image, "--size",
         str(YOLO_SIZE), "-o", str(wd / "detections.png")], "tanh",
        YOLO_SIZE, input_size=YOLO_SIZE, num_classes=YOLO_CLASSES)
    got, want = p["got"], p["want"]
    assert got["classes"] == want["classes"], (got, want)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   atol=PREDICT_TOL, err_msg=k)
    nms = p["launches"]["nms_sweep"]
    assert nms == 1 and p["launches"]["ycc_to_rgb"] == 1, p["launches"]
    _record_predict("yolov3_detect", p["launches"], time.perf_counter() - t0)
    _say(f"[yolo-cli] predict detect: {len(got['boxes'])} boxes, equal to "
         f"load_served's; launches {p['launches']}")
    return nms


def _adam_step_card_vs_cpu(label: str, cfg: dict, base, host: dict,
                           step) -> dict:
    """One float32 step of ``step`` (the config's Adam) on the card and on
    this machine's CPU from the same seeded module ``base``, TF32 off. As
    the CPU tests hold the port against JAX: each leaf (parameters, BN
    statistics, both Adam moments) within 1e-5 plus three times its
    floor, the largest gap between a platform's run and its runs on the
    batch reversed and rolled by 1 and 2 (six samples of float32's noise,
    three a platform), but for at most 0.1% of its elements (at least
    one), each within 2·lr more (Adam's first update is ±lr for any
    gradient above eps, so a gradient rounding moves across 0 turns its
    update around); the loss within 1e-4 plus four times its floor. Two
    faults planted on the card must fail it: the state before the step,
    and the step at 0.9 times the LR. No LRN kernel launches. Returns the
    readings."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.train.optimizers import (
        make_optimizer,
        set_lr_scale,
    )
    from deepvision_tpu_torch.train.state import TrainState

    strict_fp32()
    orders = (lambda a: a, lambda a: a[::-1],
              lambda a: np.roll(a, 1, axis=0),
              lambda a: np.roll(a, 2, axis=0))

    def run(device, order, lr_scale=1.0):
        module = copy.deepcopy(base).to(device)
        optimizer, _ = make_optimizer(cfg, module.parameters())
        set_lr_scale(optimizer, lr_scale)
        state = TrainState(module, optimizer)
        batch = {k: torch.from_numpy(order(v).copy()).to(device)
                 for k, v in host.items()}
        loss = float(step(state, batch, None)["loss"])
        leaves = {k: v.detach().cpu()
                  for k, v in module.state_dict().items()}
        for name, p in module.named_parameters():
            for key in ("exp_avg", "exp_avg_sq"):
                leaves[f"{name}:{key}"] = optimizer.state[p][key].cpu()
        return loss, leaves

    t0 = time.perf_counter()
    _zero_launch_counts()
    card = [run("cuda", o) for o in orders]
    launches = sum(_launch_counts().values())
    wrong_lr = run("cuda", orders[0], lr_scale=0.9)[1]
    cpu = [run("cpu", o) for o in orders]
    lr = cfg["optimizer_params"]["lr"]

    def gap(a, b):
        return (a - b).abs()

    floors = {k: max(float(gap(r[1][k], runs[0][1][k]).max())
                     for runs in (card, cpu) for r in runs[1:])
              for k in card[0][1]}
    tol = {k: 1e-5 + 3 * f for k, f in floors.items()}

    def verdict(leaves):
        """(leaves beyond the rule, the most elements of a leaf over its
        tolerance, the three largest gaps over their tolerance)"""
        bad, most, worst = [], 0, []
        for k, v in leaves.items():
            g = gap(cpu[0][1][k], v)
            over = int((g > tol[k]).sum())
            most = max(most, over)
            worst.append((float(g.max()) / tol[k], k))
            if over > max(1, g.numel() // 1000) or float(
                    g.max()) > tol[k] + 2 * lr:
                bad.append(k)
        return bad, most, sorted(worst, reverse=True)[:3]

    bad, most, worst = verdict(card[0][1])
    stale = {k: v for k, v in base.state_dict().items()}
    stale.update({k: torch.zeros_like(v) for k, v in card[0][1].items()
                  if ":" in k})
    planted = {"state before the step": verdict(stale)[0],
               "LR x 0.9": verdict(wrong_lr)[0]}
    loss_floor = max(abs(r[0] - rs[0][0]) for rs in (card, cpu)
                     for r in rs[1:])
    loss_gap = abs(cpu[0][0] - card[0][0])
    loss_tol = 1e-4 * abs(card[0][0]) + 4 * loss_floor
    n, size = host["image"].shape[:2]
    _say(f"[card-vs-cpu] {label} f32 (TF32 off) batch {n} at {size}, one "
         f"Adam step (lr {lr:g}) on {len(orders)} batch orders on each "
         f"side in "
         f"{time.perf_counter() - t0:.1f} s: loss card {card[0][0]:.6f} CPU "
         f"{cpu[0][0]:.6f}, gap {loss_gap:.3e} (tolerance {loss_tol:.3e}); "
         f"{len(tol)} leaves, {len(bad)} beyond the rule {bad[:3]}, at most "
         f"{most} elements of a leaf over its floor tolerance, largest gaps "
         f"over tolerance {[(round(r, 2), k) for r, k in worst]}; planted "
         "faults: " + ", ".join(f"{k}: {len(v)} leaves beyond"
                                for k, v in planted.items()) + "; "
         f"LRN launches {launches}")
    assert np.isfinite(card[0][0]) and loss_gap <= loss_tol
    assert not bad, bad[:10]
    assert launches == 0
    assert planted["state before the step"]
    assert planted["LR x 0.9"]
    return {"loss_gap": loss_gap, "loss_tol": loss_tol,
            "planted": {k: len(v) for k, v in planted.items()},
            "leaves": len(tol)}


def phase_yolo_card_vs_cpu(n: int = 4, size: int = 128) -> None:
    """``yolov3`` (full width, the config's Adam at lr 0.01) at batch
    ``n`` and ``size`` px (:func:`_adam_step_card_vs_cpu`). Batch 4, not
    2: at batch 2 a platform has one reordered run, and leaky ReLUs
    flipping beside BatchNorms of 32 values a channel moved 10 of 810
    leaves past that one sample's floor. The stale state must put over
    half the leaves beyond the rule."""
    import torch

    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import yolo_train_step

    base = create_model("yolov3", device=torch.device("cpu"), seed=0,
                        num_classes=YOLO_CLASSES)
    out = _adam_step_card_vs_cpu("yolov3", get_config("yolov3"), base,
                                 _detection_host_batch(n, size, seed=2),
                                 yolo_train_step)
    assert out["planted"]["state before the step"] > out["leaves"] // 2


def phase_yolo(smi: str, workdir: Path) -> dict:
    """Every YOLO v3 phase but the CLIs: serving (engine, then the NMS
    kernel against its plain version and its times), the label grids on
    the card, the skipped Adam step, the card-vs-CPU step, the record
    path. Returns the NMS kernel's entry, its launches by path, a summary
    and the records' directory (for :func:`phase_model_clis`); every
    path's LRN launches are 0."""
    import torch

    served, serve_nms, serve_prof, GRAPHS["yolov3"], answers = _timed(
        "yolov3 serve", phase_yolo_serve, smi)
    nms = _timed("nms sweep", phase_nms, served)
    served = None
    torch.cuda.empty_cache()
    _timed("encode labels", phase_encode_labels)
    _timed("adam skip", phase_adam_skip)
    _timed("yolov3 card vs cpu", phase_yolo_card_vs_cpu)
    torch.cuda.empty_cache()
    records = _timed("yolov3 records", phase_yolo_records, smi, workdir)
    summary = {
        "serve_bucket64": {k: serve_prof[k] for k in (
            "device_ms", "launches", "kernel_share", "idle")},
        "train_bf16_b16": {k: records[k] for k in (
            "fed", "resident", "mfu", "peak_gb", "idle_fed", "idle",
            "device_ms", "launches")},
        "nms_ms": nms["ms"], "yolo_postprocess_ms":
            nms["yolo_postprocess_ms"], "card": smi}
    return {"nms": {k: v for k, v in nms.items()
                    if k != "yolo_postprocess_ms"},
            "nms_launches": {"serve_engine": serve_nms},
            "summary": summary, "records": records["records"],
            "answers": answers}


# ------------------------------------------------------------- export


def _traced_port_kernels(run, want: dict[str, int],
                         windows: int = 3) -> dict[str, int]:
    """The port's kernels (``DEVICE_KERNELS``) that a profiled ``run()``
    ran on the card, by counter name, found by kernel name: ``want``, or
    this fails. A window that recorded another set is printed with what
    it did record, and ``run`` is profiled again, up to ``windows``
    times: in whole-script runs on this card the profiler has recorded
    windows with none of the port's kernels, or with no device time at
    all, around calls that launched them on the counters (PERF.md)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for window in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [name for name, _, _ in _device_events(prof)]
        traced = {counter: sum(part in n for n in names)
                  for counter, part in DEVICE_KERNELS.items()}
        traced = {k: n for k, n in traced.items() if n}
        if traced == want:
            return traced
        top = sorted(set(names), key=names.count, reverse=True)[:6]
        _say(f"[profile] window {window}: {len(names)} device events, the "
             f"port's kernels {traced}, not {want}; the most frequent "
             f"{[n[:60] for n in top]}")
    raise AssertionError(f"no window of {windows} traced {want}")


def _export_alexnet(smi: str, workdir: Path) -> dict:
    """``alexnet1`` (seeded weights, 1000 classes, float32, TF32 off,
    deterministic cuDNN) exported by ``export_forward`` at batch
    ``EXPORT_BUCKET`` and loaded by ``load_exported``: the graph holds 2
    ``deepvision.lrn_forward`` nodes and no plain window sum
    (``aten.unfold``); one call of the loaded program launches
    ``lrn_forward_f32`` twice on the counters, and a profiled call runs 2
    ``lrn_forward_kernel<float`` by name; its logits equal the eager
    module's bit for bit. Returns the figures and the LRN launches of the
    program's two calls."""
    import torch

    from deepvision_tpu_torch.export import (
        export_forward,
        graph_ops,
        load_exported,
        save_exported,
    )
    from deepvision_tpu_torch.serve import load_served

    module = load_served("alexnet1", seed=0).module
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (EXPORT_BUCKET, 224, 224, 3)).astype(np.float32)).cuda()
    t0 = time.perf_counter()
    data = export_forward(module, x)
    export_s = time.perf_counter() - t0
    path = save_exported(workdir / "export" / "alexnet1.pt2", data)
    t0 = time.perf_counter()
    program = load_exported(path)
    load_s = time.perf_counter() - t0
    ops = graph_ops(program)
    assert ops.get("deepvision.lrn_forward.default") == 2, ops
    assert not any("unfold" in op for op in ops), ops
    assert [tuple(a.shape) for a in program.in_avals] == [tuple(x.shape)]
    with torch.inference_mode():
        want = module(x)
        _zero_launch_counts()
        got = program(x)
        torch.cuda.synchronize()
        once = _launch_counts()
        traced = _traced_port_kernels(lambda: program(x),
                                      {"lrn_forward_f32": 2})
    assert once == {**dict.fromkeys(once, 0), "lrn_forward_f32": 2}, once
    assert torch.equal(got, want), (got - want).abs().max().item()
    _say(f"[export] alexnet1 f32 at batch {EXPORT_BUCKET}: exported in "
         f"{export_s:.2f} s, {len(data) / 1e6:.1f} MB, loaded in "
         f"{load_s:.2f} s; the graph holds 2 deepvision.lrn_forward nodes; "
         f"a call launches {once['lrn_forward_f32']} lrn_forward_f32, and "
         f"a traced call ran {traced} by name; logits bit for bit the "
         f"eager module's ({smi})")
    return {"export_s": export_s, "load_s": load_s,
            "mb": len(data) / 1e6,
            "lrn_launches": _launch_counts()["lrn_forward_f32"]}


def _store_engine(served, store_dir: Path):
    from deepvision_tpu_torch.serve import InferenceEngine

    return InferenceEngine([dataclasses.replace(served, _fingerprint=None)],
                           buckets=STORE_BUCKETS, store=store_dir,
                           freeze_cache=True)


def _store_answers(eng, xs) -> list:
    """``xs`` at the largest bucket, then its first row at bucket 1."""
    return [_queued(eng, xs), _queued(eng, xs[:1])]


def _export_store(smi: str, workdir: Path) -> dict:
    """``yolov3`` (416 px, 20 classes, seeded weights, float32, TF32 off,
    deterministic cuDNN) on engines with an artifact store over a fresh
    directory and buckets ``STORE_BUCKETS``, each engine's fingerprint
    taken anew from the weights. Cold: both buckets miss, are traced and
    exported into the store (2 puts, 2 entries); the bucket-1 program
    holds 1 ``deepvision.nms_sweep`` node and none of the plain sweep's
    ``bitwise_and`` steps. A second engine warms
    both from disk (``warmed_from_store`` both buckets, 0 cache misses:
    no runner traced), each replay launching 1 ``nms_sweep`` on the
    counters and a profiled replay running 1 ``nms_sweep_kernel`` by
    name; its answers equal the cold engine's bit for bit. Then the
    bucket-1 blob is corrupted and the bucket-1 program filed under the
    bucket-4 key (it loads, and fails on a bucket-4 batch): a third
    engine quarantines both, traces both, and answers the same bits. No
    reject or quarantine on the clean path. Returns the figures and the
    phase's NMS launches."""
    import torch

    from deepvision_tpu_torch.export import deserialize_exported, graph_ops
    from deepvision_tpu_torch.serve import load_served
    from deepvision_tpu_torch.serve.artifact_store import ArtifactStore

    served = load_served("yolov3", seed=0)
    xs = _yolo_requests()[:EXPORT_BUCKET]
    store_dir = workdir / "aot"
    shutil.rmtree(store_dir, ignore_errors=True)
    _zero_launch_counts()
    with _store_engine(served, store_dir) as eng:
        stats = eng.stats()
        cold = _store_answers(eng, xs)
    cold_s = stats["warmup_s"]
    assert stats["warmed_from_store"] == [], stats
    assert stats["cache"]["misses"] == len(STORE_BUCKETS), stats["cache"]
    assert stats["artifact_store"] | {"root": None} == {
        "root": None, "entries": 2, "hits": 0, "misses": 2, "puts": 2,
        "quarantined": 0}, stats["artifact_store"]
    entries = {e["bucket"]: e for e in ArtifactStore(
        store_dir, log=print).entries().values()}
    mb = {b: e["size"] / 1e6 for b, e in sorted(entries.items())}

    with _store_engine(served, store_dir) as eng:
        stats = eng.stats()
        before = _nms_launches()
        warm = _store_answers(eng, xs)
        replays = _nms_launches() - before
        runner = eng._bucket_runner(eng._models["yolov3"], EXPORT_BUCKET)
        traced = _traced_port_kernels(
            lambda: runner(np.zeros((EXPORT_BUCKET, *served.input_shape),
                                    np.float32)), {"nms_sweep": 1})
    warm_s = stats["warmup_s"]
    assert stats["warmed_from_store"] == [
        f"yolov3@{b}" for b in STORE_BUCKETS], stats["warmed_from_store"]
    assert stats["cache"]["misses"] == 0, stats["cache"]
    assert stats["artifact_store"]["hits"] == 2, stats["artifact_store"]
    assert stats["artifact_store"]["quarantined"] == 0
    for per in stats["runners"]["yolov3"]["buckets"].values():
        assert per["launches"] == {"nms_sweep": 1}, per
    assert replays == 2, replays
    assert _same_bits(warm, cold), "the store-warmed engine answered " \
        "other bits than the cold one"

    one = entries[1]
    program1 = (store_dir / one["file"]).read_bytes()
    ops = graph_ops(deserialize_exported(program1))
    assert ops.get("deepvision.nms_sweep.default") == 1, ops
    assert not any("bitwise_and" in op for op in ops), ops
    (store_dir / one["file"]).write_bytes(b"not a torch.export program")
    store = ArtifactStore(store_dir, log=print)
    store.put(program1, **{k: entries[EXPORT_BUCKET][k] for k in (
        "model", "bucket", "dtype", "device", "fingerprint")})
    with _store_engine(served, store_dir) as eng:
        stats = eng.stats()
        healed = _store_answers(eng, xs)
    assert stats["warmed_from_store"] == [], stats["warmed_from_store"]
    assert stats["cache"]["misses"] == 2, stats["cache"]
    assert stats["artifact_store"]["quarantined"] == 2, stats
    assert len(list((store_dir / "quarantine").iterdir())) == 2
    assert _same_bits(healed, cold), "the re-traced engine answered other " \
        "bits than the cold one"
    nms = _nms_launches()
    shutil.rmtree(store_dir, ignore_errors=True)
    kept = [len(a["scores"]) for a in cold[0]]
    _say(f"[export] yolov3 f32 at {YOLO_SIZE} on buckets {STORE_BUCKETS} "
         f"with an artifact store: cold warm-up {cold_s} s (2 traces, 2 "
         f"exports; blobs {mb} MB), warm-up from the store {warm_s} s (2 "
         f"loads, 0 traces); the stored program holds 1 "
         f"deepvision.nms_sweep node; NMS launches a replay 1 (counters "
         f"{replays} for 2 batches, traced {traced}); answers bit for bit "
         f"the cold engine's (kept {min(kept)}-{max(kept)} boxes a "
         f"request); a "
         f"corrupt blob and an unrunnable one quarantined and traced "
         f"again, answers unchanged ({smi})")
    return {"cold_warmup_s": cold_s, "store_warmup_s": warm_s,
            "blob_mb": mb, "nms_launches": nms}


def phase_export(smi: str, workdir: Path) -> dict:
    """Model export on the card under deterministic cuDNN (bit for bit
    needs the same convolution algorithms in the eager module, the
    traced graphs and the loaded programs): :func:`_export_alexnet`, then
    :func:`_export_store`, alone on the card and in this process (the
    counters are the process's, and an export on a worker thread left
    the next profiler window empty, PERF.md). Returns their figures."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32

    strict_fp32()
    torch.backends.cudnn.deterministic = True
    try:
        out = {"alexnet1": _export_alexnet(smi, workdir)}
        torch.cuda.empty_cache()
        out["yolov3_store"] = _export_store(smi, workdir)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------- CenterNet and pose


def _serve_against_cpu(served, xs, check, profile: dict | None = None,
                       **load_kw) -> tuple:
    """``served`` behind an ``InferenceEngine`` on ``BUCKETS``: ``xs``
    queued at once (one bucket-64 batch) and 4 single requests (4
    bucket-1 batches in a row), each answer bit for bit the eager
    forward's at its bucket (:func:`_graph_rounds`), no LRN or NMS
    launch; then ``check(the first 8 answers, the singles, cpu, xs[:8])``,
    where ``cpu`` is the served model rebuilt on this machine's CPU
    (``load_served(**load_kw)``) with the card's weights. With
    ``profile`` (``_profile_served``'s keywords, ``label`` among them),
    profiler windows over the bucket-64 batch on a graph captured after
    the engine closed (:func:`_profile_largest`). Returns (the
    answers, the engine's telemetry, the seconds, the graphs' report with
    the profile)."""
    from deepvision_tpu_torch.serve import InferenceEngine, load_served

    t0 = time.perf_counter()
    batches = [xs] + [xs[i:i + 1] for i in range(4)]
    with InferenceEngine([served], buckets=BUCKETS,
                         freeze_cache=True) as eng:
        misses = eng.stats()["cache"]["misses"]
        eager_answers = _eager_answers(served, batches)
        _zero_launch_counts()
        rounds = _graph_rounds(eng, served, batches, eager_answers)
        stats = eng.stats()
        wall = time.perf_counter() - t0
        assert sum(_launch_counts().values()) == 0 and _nms_launches() == 0
        graphs = _graph_report(served.name, eng, served.name, misses)
        for per in graphs["launches_per_replay"].values():
            assert per == {}, per
    graphs["reserved_after_close"] = _closed(served.name)
    if profile is not None:
        batch = np.zeros((BUCKETS[-1], *served.input_shape), np.float32)
        batch[:len(xs)] = xs
        graphs["profile"] = _profile_largest(served, batch, graphs,
                                             **profile)
    GRAPHS[served.name] = graphs
    answers, singles = rounds[0], [r[0] for r in rounds[1:]]
    cpu = load_served(served.name, device="cpu",
                      input_size=served.input_shape[0], **load_kw)
    cpu.module.load_state_dict(served.module.state_dict())
    check(answers[:CPU_CHECKED], singles, cpu,
          xs[:max(CPU_CHECKED, len(singles))])
    return answers, stats["telemetry"], wall, graphs


def _centernet_check(got: dict, want: dict, tol: float = 1e-4) -> None:
    """A served CenterNet answer against the CPU's: the kept scores, in
    rank order, within ``tol``; at every rank whose score is more than
    2·tol from its neighbours' (an unambiguous rank) the same class and
    box (corners within ``tol``). Near-ties may trade ranks, and a score
    within ``tol`` of the threshold may be kept on one side only, so the
    counts may differ by the near-threshold rows."""
    g, w = np.asarray(got["scores"]), np.asarray(want["scores"])
    n = min(len(g), len(w))
    assert abs(len(g) - len(w)) <= int(np.sum(np.abs(w - CN_SCORE) <= tol)
                                       + np.sum(np.abs(g - CN_SCORE) <= tol))
    assert np.all(np.abs(g[:n] - w[:n]) <= tol), np.abs(g[:n] - w[:n]).max()
    for i in range(n):
        near = [abs(w[i] - w[j]) <= 2 * tol for j in (i - 1, i + 1)
                if 0 <= j < len(w)]
        if any(near):
            continue
        assert got["classes"][i] == want["classes"][i], i
        assert np.allclose(got["boxes"][i], want["boxes"][i], atol=tol), i


def _centernet_checks(answers, singles, cpu, xs) -> None:
    for single, batched in zip(singles, answers):
        _centernet_check(single, batched)
    host = cpu.run(xs[:len(answers)])
    for i, answer in enumerate(answers):
        _centernet_check(answer, cpu.postprocess(host, i))


def phase_centernet_serve(smi: str) -> dict:
    """``load_served("centernet")`` at 256x256x3, 80 classes, seeded
    weights, float32 (TF32 off), ``score_thresh`` ``CN_SCORE``, behind an
    ``InferenceEngine`` on buckets (1, 4, 16, 64): 32 queued requests
    and 4 single ones; the first 8 answers held against the CPU
    (:func:`_centernet_check`); the peak decode's time on the bucket-64
    batch's heads beside the whole batch's device time; profiler windows
    over the batch."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.ops.centernet_decode import decode_centernet
    from deepvision_tpu_torch.serve import load_served
    from deepvision_tpu_torch.timing import time_ms

    strict_fp32()
    served = load_served("centernet", seed=0, score_thresh=CN_SCORE,
                         input_size=CN_SIZE)
    assert served.task == "detect"
    assert served.input_shape == (CN_SIZE, CN_SIZE, 3)
    xs = (np.random.default_rng(0).uniform(
        -1, 1, (CN_REQUESTS, *served.input_shape)).astype(np.float32))
    answers, tel, wall, graphs = _serve_against_cpu(
        served, xs, _centernet_checks,
        profile={"label": f"centernet bucket-{BUCKETS[-1]} batch f32",
                 "share_of": "sort"}, score_thresh=CN_SCORE)
    kept = [len(a["scores"]) for a in answers]
    assert tel["batches"] == 5, tel
    batch = np.zeros((BUCKETS[-1], *served.input_shape), np.float32)
    batch[:len(xs)] = xs
    with torch.inference_mode():
        heads = served.module(torch.from_numpy(batch).cuda())[-1]
        decode_ms = time_ms(lambda _: decode_centernet(*heads), [None],
                            **YARDSTICK)
    _say(f"[centernet-serve] centernet f32 at {CN_SIZE}, {CN_CLASSES} "
         f"classes: {len(xs)} queued requests and 4 single ones answered in "
         f"{wall:.1f} s; the first {CPU_CHECKED} held against the CPU "
         f"(kept scores within 1e-4, classes and boxes at unambiguous "
         f"ranks); kept {min(kept)}-{max(kept)} boxes a request at score "
         f"> {CN_SCORE}; batches {tel['batches']}; e2e latency p50 "
         f"{tel['e2e_latency']['p50_ms']} ms, device time a batch p50 "
         f"{tel['device_time']['p50_ms']} ms; the peak decode of a "
         f"bucket-{BUCKETS[-1]} batch's heads {decode_ms:.4f} ms")
    prof = graphs["profile"]
    if prof["device_ms"]:
        _say(f"[centernet-serve] the decode is {decode_ms:.4f} of "
             f"{prof['device_ms']:.3f} ms = "
             f"{decode_ms / prof['device_ms']:.2%} of the batch's device "
             f"time ({smi})")
    return {**prof, "decode_ms": decode_ms}


def _centernet_targets_batch(n: int, size: int, seed: int = 0) -> dict:
    """A detection host batch (:func:`_detection_host_batch`) with more
    collisions planted for trap C19: image 1 holds three boxes on one
    centre cell of the 64² grid, the padding rows follow."""
    host = _detection_host_batch(n, size, seed=seed, classes=CN_CLASSES)
    for j in range(3):
        host["boxes"][1, 6 + j] = [0.3 + j / 1024, 0.7, 0.1 * (j + 1), 0.2]
        host["label"][1, 6 + j] = 10 * j
    return host


def _decode_ties(rng, b: int = 16, g: int = 64, c: int = CN_CLASSES):
    """Heat logits with planted ties (trap C20): equal plateaus, a
    saturated map (sigmoid 1.0), and images with one peak a class (80
    peaks, fewer than K = 100: 0.0 ties after them)."""
    heat = rng.normal(-3, 2, (b, g, g, c)).astype(np.float32)
    heat[0, ::4, ::4, 1] = 2.0
    heat[1] = 40.0
    yy, xx = np.mgrid[:g, :g]
    for i in (2, 3):  # one peak a class: c peaks, then 0.0 ties
        for ch in range(c):
            py, px = rng.integers(0, g, 2)
            top = 2.0 if ch % 40 == 0 else -30.0
            heat[i, ..., ch] = top - np.hypot(yy - py, xx - px)
    wh = rng.uniform(0, 8, (b, g, g, 2)).astype(np.float32)
    off = rng.uniform(0, 1, (b, g, g, 2)).astype(np.float32)
    return heat, wh, off


def phase_centernet_codec() -> None:
    """The CenterNet targets and decode on the card against the CPU, at
    the 64² grid of 256 px: ``encode_centernet``'s ``wh``, ``offset`` and
    ``mask`` bit for bit with planted collisions and padding (trap C19),
    the heatmap within 1e-6 on the same support (``exp`` is CUDA's on one
    side and ATen's on the other); ``decode_centernet`` with planted ties
    (trap C20): classes and cells identical, scores within 1e-6."""
    import torch

    from deepvision_tpu_torch.ops.centernet_decode import decode_centernet
    from deepvision_tpu_torch.ops.centernet_encode import encode_centernet

    host = _centernet_targets_batch(CN_BATCH, 8)
    boxes, labels = (torch.from_numpy(host[k]) for k in ("boxes", "label"))
    g = CN_SIZE // 4
    cpu = encode_centernet(boxes, labels, CN_CLASSES, g)
    card = encode_centernet(boxes.cuda(), labels.cuda(), CN_CLASSES, g)
    for k in ("wh", "offset", "mask"):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    heat_gap = float((card["heatmap"].cpu() - cpu["heatmap"]).abs().max())
    assert torch.equal(card["heatmap"].cpu() > 0, cpu["heatmap"] > 0)
    assert heat_gap <= 1e-6, heat_gap
    assert cpu["mask"][1].sum() < (labels[1] >= 0).sum()
    assert cpu["mask"][:, 0, 0].sum() == 0
    heat, wh, off = _decode_ties(np.random.default_rng(3))
    args = [torch.from_numpy(a) for a in (heat, wh, off)]
    want = decode_centernet(*args)
    got = decode_centernet(*(a.cuda() for a in args))
    assert torch.equal(got["classes"].cpu(), want["classes"])
    cells = (want["boxes"][..., :2] * g).floor()
    assert torch.equal((got["boxes"][..., :2].cpu() * g).floor(), cells)
    score_gap = float((got["scores"].cpu() - want["scores"]).abs().max())
    assert score_gap <= 1e-6, score_gap
    assert (want["scores"][2:4, :CN_CLASSES] > 0).all()
    assert (want["scores"][2:4, CN_CLASSES:] == 0).all()
    _say(f"[centernet-codec] encode_centernet at {g}² on the card: wh, "
         f"offset and mask equal to the CPU's bit for bit (planted "
         f"collisions, padding kept off cell (0, 0)), heatmap within "
         f"{heat_gap:.2e}; decode_centernet with planted ties: classes and "
         f"cells identical, scores within {score_gap:.2e}")


def phase_centernet_step(size: int = 128) -> None:
    """The float32 CenterNet step (full width, two stacks, the config's
    Adam) at batch 4 and ``size`` px on the card against the CPU
    (:func:`_adam_step_card_vs_cpu`)."""
    import torch

    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import centernet_train_step

    base = create_model("centernet", device=torch.device("cpu"), seed=0,
                        num_classes=CN_CLASSES)
    _adam_step_card_vs_cpu("centernet", get_config("centernet"), base,
                           _centernet_targets_batch(4, size, seed=2),
                           centernet_train_step)


class _Offer(NamedTuple):
    """A model chain's checkpoint for the serving CLI
    (:func:`_serve_chains`), offered once the chain has trained: the
    model, the workdir that holds its checkpoint, its requests and
    ``check(replies, launches, runners)``, which holds the model's
    replies, the process's kernel launches and the model's runners to
    the chain's expectations; with ``artifact``, a ``predict export``
    file of the same model and weights, served beside it under the name
    ``name + ARTIFACT_SUFFIX`` with the same requests
    (:func:`_artifact_served`)."""

    name: str
    workdir: Path
    xs: np.ndarray
    check: object
    artifact: Path | None = None


def _chain(ready, label: str, chain, *args):
    """``_timed(label, chain, *args, offer=ready.set_result)``: a model
    chain that offers its checkpoint through the future ``ready``, which
    takes the chain's error instead if it fails before its offer."""
    try:
        return _timed(label, chain, *args, offer=ready.set_result)
    except BaseException as e:
        if not ready.done():
            ready.set_exception(e)
        raise


def _serve_chains(ready, pipelines: Path | None = None) -> dict:
    """Once every future of ``ready`` holds its chain's :class:`_Offer`
    (:func:`_chain`), one ``python -m deepvision_tpu_torch.serve -m
    name=workdir ...`` over all their checkpoints (``--buckets 1,4
    --score 0.05``: the score threshold reaches the detectors alone),
    the requests of each model addressed by ``"model"``; then each
    offer's ``check``. With ``pipelines`` (a spec file of ``detpose``
    over the chains' ``yolov3`` and ``hourglass104``), ``--pipelines``
    too and 2 requests addressed by ``"pipeline"`` (:func:`_dag_served`),
    whose NMS launches are taken out of the process's before the checks.
    Returns the checks' results by model (and ``detpose``'s launches)."""
    offers = [f.result() for f in ready]
    args, lines = [], []
    for o in offers:
        args += ["-m", f"{o.name}={o.workdir}"]
        names = [o.name]
        if o.artifact is not None:
            names.append(o.name + ARTIFACT_SUFFIX)
            args += ["--artifact", f"{names[-1]}={o.artifact}"]
        lines += [json.dumps({"id": f"{name}/{i}", "model": name,
                              "input": x.tolist()}) + "\n"
                  for name in names for i, x in enumerate(o.xs)]
    if pipelines is not None:
        args += ["--pipelines", str(pipelines)]
        lines += [json.dumps({"id": f"detpose/{i}", "pipeline": "detpose",
                              "input": x.tolist()}) + "\n"
                  for i, x in enumerate(_pipeline_requests(2, seed=1))]
    t0 = time.perf_counter()
    proc = _cli("deepvision_tpu_torch.serve",
                [*args, "--buckets", "1,4", "--score", "0.05"],
                "".join(lines))
    replies = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["id"] for r in replies] == [
        json.loads(line)["id"] for line in lines], replies
    runners = json.loads(re.search(r"^\[serve\] runners (.*)$",
                                   proc.stderr, re.M).group(1))
    launches = _cli_launches(proc.stderr)
    names = [o.name for o in offers]
    _say(f"[chain-serve] one serving CLI answered {len(replies)} requests "
         f"for {names} from their chains' checkpoints in "
         f"{time.perf_counter() - t0:.1f} s; "
         f"{proc.stderr.strip().splitlines()[-1]}")
    def replies_of(name, n):
        mine = [r for r in replies if r["id"].startswith(f"{name}/")]
        assert len(mine) == n and all("result" in r for r in mine), mine
        return mine

    out = {}
    if pipelines is not None:
        out["detpose"] = _dag_served(replies_of("detpose", 2), proc.stderr)
        launches = {**launches,
                    "nms_sweep": launches["nms_sweep"] - out["detpose"]}
    for o in offers:
        mine = replies_of(o.name, len(o.xs))
        out[o.name] = o.check(mine, launches, runners[o.name])
        if o.artifact is not None:
            art = o.name + ARTIFACT_SUFFIX
            out[art] = _artifact_served(mine, replies_of(art, len(o.xs)),
                                        runners[art], launches)
    return out


def _dag_served(replies: list, stderr: str) -> int:
    """The serving CLI's ``detpose`` answers (the detections and the
    masked pose rows, ``--pipelines``): the exit lines ``[pipeline]
    served detpose=2 frozen=True`` with the cache's misses those of the
    warm-up (one a runner), and ``[pipeline] runners``, a CUDA graph an
    entry bucket that launches 1 ``nms_sweep`` a replay, called once on
    a zero batch at the warm-up and then by the requests' 1 or 2
    batches. Returns the DAG's NMS launches in the process: each
    capture's eager DAG, then every call."""
    assert all(set(r["result"]) == {"det", "pose"} for r in replies), (
        replies)
    assert all(len(r["result"]["pose"]) <= PIPE_K for r in replies)
    served = re.search(r"^\[pipeline\] served detpose=2 frozen=True "
                       r"misses=(\d+) hits=\d+$", stderr, re.M)
    warm = re.search(r"^warmup done in \S+s \((\d+) runners", stderr, re.M)
    assert served and warm and served.group(1) == warm.group(1), (
        stderr[-4000:])
    dag = json.loads(re.search(r"^\[pipeline\] runners (.*)$", stderr,
                               re.M).group(1))["detpose"]
    assert dag["kind"] == "cuda_graph", dag
    buckets = dag["buckets"].values()
    assert all(b["launches"] == {"nms_sweep": 1} for b in buckets), dag
    calls = sum(b["calls"] for b in buckets)
    assert len(buckets) + 1 <= calls <= len(buckets) + len(replies), dag
    nms = len(buckets) + calls
    _say(f"[pipeline-cli] serve --pipelines answered {len(replies)} detpose "
         f"requests ({[len(r['result']['pose']) for r in replies]} person "
         f"crops); misses {served.group(1)}, frozen; the DAG's runners "
         f"called {calls} times, {nms} NMS launches")
    return nms


def _artifact_served(replies: list, art_replies: list, art_runners: dict,
                     launches: dict) -> int:
    """A ``predict export`` artifact served by ``--artifact`` beside the
    same checkpoint served by ``-m`` (``inception1_ref``): one runner, at
    the exported batch 1, whose replay launches 2 ``lrn_forward_f32``; the
    same top-5 classes for every
    request, the probabilities within ``PREDICT_TOL`` (the ``-m`` model
    may answer both requests in one bucket-4 replay, whose cuDNN
    algorithms need not be those of a bucket-1 one, and cuDNN runs
    nondeterministic algorithms in the serving CLI). The process's LRN
    launches: each ``-m`` bucket's capture runs an eager forward first
    (2 each), the artifact's capture and its warm-up's zero batch 2
    each, and every replay 2. Returns the process's LRN launches."""
    assert list(art_runners["buckets"]) == ["1"], art_runners
    art_launches = art_runners["buckets"]["1"]["launches"]
    assert art_launches == {"lrn_forward_f32": 2}, art_runners
    for got, want in zip(art_replies, replies, strict=True):
        _same_topk(got["result"], want["result"], "artifact")
    lrn = launches["lrn_forward_f32"]
    art = 2 + 2 + 2 * len(art_replies)
    assert art + 4 + 2 <= lrn <= art + 4 + 2 * len(replies), launches
    _say(f"[export-cli] serve --artifact answered {len(art_replies)} "
         f"requests with the top-5 of -m's from the same weights; "
         f"lrn_forward_f32 a replay {art_launches['lrn_forward_f32']}, "
         f"{lrn} in the process")
    return lrn


def _model_clis(name: str, d: Path, wd: Path, size: int,
                train_args: list[str], offer, check, eval_args: list[str],
                beside=None) -> dict:
    """The training CLI of ``name`` over the records in ``d`` with
    ``--device-aug`` for 1 epoch, then ``--resume`` to 2 (every epoch's
    train loss finite, no kernel but nvJPEG's ``ycc_to_rgb`` launched);
    then its newest checkpoint offered to a serving CLI (``offer``, an
    :class:`_Offer` of 2 requests of ``size`` px held by ``check``), and
    the eval CLI from it beside ``beside(wd / name)`` (a predict CLI and
    its check) if given. Returns the epoch lines, the eval line, the
    kernel launches each CLI counted (None where it prints none) and
    ``beside``'s result."""
    from concurrent.futures import ThreadPoolExecutor

    common = ["-m", name, "--data-dir", str(d), "--device-aug",
              "--workdir", str(wd), *train_args]
    t0 = time.perf_counter()
    first = _cli("deepvision_tpu_torch.train", [*common, "--epochs", "1"])
    resumed = _cli("deepvision_tpu_torch.train",
                   [*common, "--epochs", "2", "--resume"])
    assert "resumed at epoch 1" in resumed.stdout
    epochs = [s for s in (first.stdout + resumed.stdout).splitlines()
              if s.startswith("[epoch ") and "] train_loss" in s]
    assert len(epochs) == 2, epochs
    for line in epochs:
        assert np.isfinite(float(line.split("train_loss=")[1].split()[0]))
        _say(f"[{name}-cli] {line[:240]}")
    train_launches = [_cli_launches(p.stderr) for p in (first, resumed)]
    for counts in train_launches:
        assert not any(v for k, v in counts.items() if k != "ycc_to_rgb"), (
            counts)
    _say(f"[{name}-cli] train CLI 1 epoch then --resume to 2 in "
         f"{time.perf_counter() - t0:.1f} s; launches {train_launches}")
    xs = (np.random.default_rng(1).uniform(-1, 1, (2, size, size, 3))
          .astype(np.float32))
    offer(_Offer(name, wd / name, xs, check))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        evaluate = pool.submit(_cli, "deepvision_tpu_torch.eval",
                               [*eval_args, "--workdir", str(wd / name),
                                "--data-dir", str(d), "--batch-size", "16"])
        extra = pool.submit(beside, wd / name) if beside else None
        evaluate = evaluate.result()
        extra = extra.result() if extra else None
    line = json.loads(evaluate.stdout.strip().splitlines()[-1])
    _say(f"[{name}-cli] eval CLI: {json.dumps(line)[:400]}; with "
         f"{'its predict CLI ' if beside else ''}in "
         f"{time.perf_counter() - t0:.1f} s")

    def launches(proc):
        return (_cli_launches(proc.stderr)
                if "kernel launches " in proc.stderr else None)

    return {"epochs": epochs, "eval": line,
            "train_launches": train_launches,
            "eval_launches": launches(evaluate), "beside": extra}


def phase_centernet_records(smi: str, workdir: Path) -> dict:
    """The CenterNet path from records: synthetic detection shards (80
    classes, ``CN_TRAIN`` train and ``CN_VAL`` val, 4 shards each, JPEGs
    by nvJPEG), the fed and device-resident bf16 step at 256 and batch
    16 (:func:`_fed_and_resident`). Returns the readings and the
    records' directory, whose CLIs :func:`phase_model_clis` runs."""
    import torch

    from deepvision_tpu_torch.data.detection import make_detection_data
    from deepvision_tpu_torch.data.device_aug import (
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_detection,
    )
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import centernet_train_step

    d = workdir / "centernet_records"
    t0 = time.perf_counter()
    counts = write_synthetic_detection(d, train=CN_TRAIN, val=CN_VAL,
                                       classes=CN_CLASSES, shards=4)
    _say(f"[centernet-records] wrote {counts} on the card (nvJPEG) in "
         f"{time.perf_counter() - t0:.1f} s")
    cfg = get_config("centernet")
    bs = cfg["batch_size"]
    module = create_model("centernet", device=torch.device("cuda"), seed=0,
                          num_classes=CN_CLASSES, dtype=torch.bfloat16)
    opt, _ = make_optimizer(cfg, module.parameters())
    step = augment_step(centernet_train_step,
                        DeviceAugment("detection", flip=True))
    train_data, _, _ = make_detection_data(
        str(d), bs, CN_SIZE, steps_per_epoch=2 + CN_TIMED_STEPS + 8,
        device_aug=True)
    rates = _fed_and_resident("centernet", module,
                              partial(step, TrainState(module, opt)),
                              train_data, bs, CN_SIZE, CN_TIMED_STEPS,
                              share_of="sort", windows=2)
    return {**rates, "records": d}


def _no_kernel_a_replay(runners: dict) -> None:
    """A served model whose graphs launch none of the port's kernels."""
    assert all(b["launches"] == {} for b in runners["buckets"].values()), (
        runners)


def _centernet_clis(d: Path, workdir: Path, offer) -> dict:
    """``centernet``'s CLIs over its records (:func:`_model_clis`):
    ``eval detection -m centernet`` over the ``val-*`` shards with null
    NMS fields, no NMS kernel launched; the served answers detections.
    Returns the mAP line."""
    clis = _model_clis(
        "centernet", d, workdir / "centernet_cli", CN_SIZE,
        ["--steps-per-epoch", str(CN_CLI_STEPS)], offer, _detections_served,
        ["detection", "-m", "centernet", "--names", "mscoco", "--size",
         str(CN_SIZE)])
    line = clis["eval"]
    assert clis["eval_launches"]["nms_sweep"] == 0
    assert line["metric"] == "mAP" and line["images"] == CN_VAL, line
    assert line["nms_candidates_max"] is None and line["nms_exact"] is None
    return line


def _detections_served(replies: list, launches: dict, runners: dict
                       ) -> None:
    """Detections served by graphs that launch none of the port's
    kernels."""
    assert all(set(r["result"]) == {"boxes", "scores", "classes"}
               for r in replies)
    _no_kernel_a_replay(runners)


def _pose_clis(d: Path, workdir: Path, images: dict, offer) -> dict:
    """``hourglass104``'s CLIs over its records (:func:`_model_clis`):
    ``eval pose`` over the ``val-*`` shards, and beside it ``predict
    pose`` on a PNG (:func:`_predict_pose`); 16 joints a served answer.
    Returns the PCK line."""
    clis = _model_clis(
        "hourglass104", d, workdir / "pose_cli", POSE_SIZE,
        ["--steps-per-epoch", str(POSE_CLI_STEPS)], offer, _joints_served,
        ["pose", "--size", str(POSE_SIZE)],
        partial(_predict_pose, image=images["png"]))
    line = clis["eval"]
    assert line["metric"] == "PCK@0.5" and 0.0 <= line["value"] <= 1.0
    return line


def _joints_served(replies: list, launches: dict, runners: dict) -> None:
    """``POSE_JOINTS`` joints an answer, from graphs that launch none of
    the port's kernels."""
    assert all(len(r["result"]["joints"]) == POSE_JOINTS for r in replies)
    _no_kernel_a_replay(runners)


def _predict_pose(wd: Path, image: str) -> None:
    """``predict pose`` at 256 px on a PNG from ``wd``'s checkpoint: its
    joints those of ``load_served(...).run`` on the same decoded tensor
    (within ``PREDICT_TOL``, and relatively so for the confidences)."""
    t0 = time.perf_counter()
    p = _predict_served(
        "hourglass104", wd, image,
        ["pose", "-m", "hourglass104", "--workdir", str(wd), image,
         "--size", str(POSE_SIZE), "-o", str(wd / "pose.png")], "tanh",
        POSE_SIZE, input_size=POSE_SIZE, num_heatmaps=POSE_JOINTS)
    np.testing.assert_allclose(p["got"]["joints"], p["want"]["joints"],
                               atol=PREDICT_TOL, rtol=PREDICT_TOL)
    _record_predict("hourglass104_pose", p["launches"],
                    time.perf_counter() - t0)
    _say(f"[pose-cli] predict pose on a PNG: {POSE_JOINTS} joints equal to "
         f"load_served's; launches {p['launches']}")


def phase_model_clis(workdir: Path, yolo: dict, centernet: dict,
                     pose: dict, gan: dict, images: dict,
                     artifact) -> dict:
    """The YOLO v3, CenterNet, pose, DCGAN, CycleGAN and MobileNet V1 CLI
    chains at once, one thread each (their processes share the card;
    their checks are their own and their seconds are not read as rates),
    each but CenterNet's ending in a ``predict`` CLI on ``images``; once
    the YOLO v3, pose, DCGAN and MobileNet V1 chains have trained, one
    serving CLI over their checkpoints and the converted
    ``inception1_ref`` with its ``predict export`` artifact (``artifact``,
    the future through which the converters offer them) and the
    ``detpose`` DAG over the chains' ``yolov3`` and ``hourglass104``
    (``--pipelines``) beside their eval and predict CLIs, and once
    CenterNet's (the longest) has, one over its own
    (:func:`_serve_chains`). Adds the NMS launches and the
    mAP, PCK and GAN score lines to the summaries. Returns the replies'
    checks by model."""
    from concurrent.futures import Future, ThreadPoolExecutor

    ready = {name: Future() for name in (
        "yolov3", "hourglass104", "dcgan", "mobilenet1", "centernet")}
    # detpose over the chains' yolov3 and hourglass104 checkpoints
    spec = workdir / "pipelines.json"
    spec.write_text(json.dumps(_pipeline_specs(224)[0]))
    with ThreadPoolExecutor(8) as pool:
        yl = pool.submit(_chain, ready["yolov3"], "yolov3 CLIs", _yolo_clis,
                         yolo.pop("records"), workdir, images)
        cn = pool.submit(_chain, ready["centernet"], "centernet CLIs",
                         _centernet_clis, centernet.pop("records"), workdir)
        hg = pool.submit(_chain, ready["hourglass104"], "hourglass104 CLIs",
                         _pose_clis, pose.pop("records"), workdir, images)
        dc = pool.submit(_chain, ready["dcgan"], "dcgan CLIs", _dcgan_clis,
                         workdir)
        cy = pool.submit(_timed, "cyclegan CLIs", _cyclegan_clis,
                         gan.pop("records"), workdir, images)
        mb = pool.submit(_chain, ready["mobilenet1"], "mobilenet1 CLIs",
                         _mobilenet_clis, workdir, images)
        served = [pool.submit(_timed, "chains' serving CLI", _serve_chains,
                              [ready[name] for name in (
                                  "yolov3", "hourglass104", "dcgan",
                                  "mobilenet1")] + [artifact], spec),
                  pool.submit(_timed, "centernet's serving CLI",
                              _serve_chains, [ready["centernet"]])]
        replies = {k: v for f in served for k, v in f.result().items()}
        y = yl.result()
        yolo["nms_launches"].update(serving_cli=replies["yolov3"],
                                    pipeline_serving_cli=replies.pop(
                                        "detpose"),
                                    **y["nms_launches"])
        yolo["summary"]["map_line"] = y["map"]
        centernet["map_line"], pose["pck_line"] = cn.result(), hg.result()
        gan["dcgan_eval"], gan["cyclegan_eval"] = dc.result(), cy.result()
        mb.result()
    return replies


def phase_centernet(smi: str, workdir: Path) -> dict:
    """Every CenterNet phase but the CLIs: serving, the targets and
    decode on the card, the card-vs-CPU step, the record path. Returns a
    summary and the records' directory (for
    :func:`phase_model_clis`); no LRN or NMS kernel is launched."""
    import torch

    serve = _timed("centernet serve", phase_centernet_serve, smi)
    _timed("centernet codec", phase_centernet_codec)
    _timed("centernet card vs cpu", phase_centernet_step)
    torch.cuda.empty_cache()
    records = _timed("centernet records", phase_centernet_records, smi,
                     workdir)
    torch.cuda.empty_cache()
    return {"serve_bucket64": {k: serve[k] for k in (
                "device_ms", "launches", "kernel_share", "idle",
                "decode_ms")},
            "train_bf16_b16": {k: records[k] for k in (
                "fed", "resident", "mfu", "peak_gb", "idle_fed", "idle",
                "device_ms", "launches")},
            "records": records["records"], "card": smi}


def _pose_checks(answers, singles, cpu, xs) -> None:
    """Served pose answers against the CPU's heatmaps of the same
    images: each joint's cell holds the CPU map's peak within 1e-4 of the
    maps' scale (a near-tie may pick another cell), its confidence within
    that of the peak; the single requests' answers likewise."""
    import torch

    with torch.inference_mode():
        heat = cpu.module(torch.from_numpy(xs))[-1].numpy()
    h, w = heat.shape[1:3]
    tol = 1e-4 * float(np.abs(heat).max())
    for i, answer in [*enumerate(answers), *enumerate(singles)]:
        joints = np.asarray(answer["joints"])
        assert joints.shape == (POSE_JOINTS, 3)
        cx = np.rint(joints[:, 0] * w).astype(int)
        cy = np.rint(joints[:, 1] * h).astype(int)
        at = heat[i, cy, cx, np.arange(POSE_JOINTS)]
        peak = heat[i].reshape(-1, POSE_JOINTS).max(0)
        assert np.all(at >= peak - tol), (i, (peak - at).max(), tol)
        assert np.all(np.abs(joints[:, 2] - peak) <= tol), i


def phase_pose_serve(smi: str) -> dict:
    """``load_served("hourglass104")`` at 256x256x3, 16 joints, seeded
    weights, float32 (TF32 off), behind an ``InferenceEngine``: 32 queued
    requests (a bucket-64 batch) and 4 single ones, the first 8 answers
    held against the CPU (:func:`_pose_checks`); profiler windows over the
    bucket-64 batch."""
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import load_served

    strict_fp32()
    served = load_served("hourglass104", seed=0, input_size=POSE_SIZE)
    assert served.task == "pose" and served.input_shape == (POSE_SIZE,
                                                            POSE_SIZE, 3)
    xs = (np.random.default_rng(0).uniform(
        -1, 1, (CN_REQUESTS, *served.input_shape)).astype(np.float32))
    answers, tel, wall, graphs = _serve_against_cpu(
        served, xs, _pose_checks,
        profile={"label": f"hourglass104 bucket-{BUCKETS[-1]} batch f32",
                 "share_of": "argmax", "eager": True})
    assert all(len(a["joints"]) == POSE_JOINTS for a in answers)
    assert tel["batches"] == 5, tel
    _say(f"[pose-serve] hourglass104 f32 at {POSE_SIZE}, {POSE_JOINTS} "
         f"joints: {len(xs)} queued requests and 4 single ones answered in "
         f"{wall:.1f} s; the first {CPU_CHECKED} and the single ones "
         f"held against the CPU's heatmaps (peak within 1e-4 of their "
         f"scale); "
         f"batches {tel['batches']}; e2e latency p50 "
         f"{tel['e2e_latency']['p50_ms']} ms, device time a batch p50 "
         f"{tel['device_time']['p50_ms']} ms")
    return graphs["profile"]


def phase_pose_remat(n: int = 4) -> None:
    """Trap C11 at ``"stack"``: one float32 ``hourglass104`` step (the
    config's Adam) at batch ``n`` and 256 px, TF32 off and cuDNN's
    deterministic algorithms, under ``remat="stack"`` against the plain
    step from the same weights: the loss, every BN statistic and every
    parameter bit for bit (two plain runs are bit for bit too)."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import pose_train_step

    strict_fp32()
    cfg = get_config("hourglass104")
    base = create_model("hourglass104", device=torch.device("cuda"), seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _pose_host_batch(n, POSE_SIZE, seed=5).items()}

    def run(policy):
        module = copy.deepcopy(base)
        module.remat = policy
        opt, _ = make_optimizer(cfg, module.parameters())
        loss = pose_train_step(TrainState(module, opt), batch,
                               None)["loss"].item()
        torch.cuda.synchronize()
        return loss, {k: v.detach().clone()
                      for k, v in module.state_dict().items()}

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain, plain2, stack = run(None), run(None), run("stack")
    finally:
        torch.backends.cudnn.deterministic = was
    assert plain[0] == plain2[0] == stack[0], (plain[0], stack[0])
    for k, v in plain[1].items():
        assert torch.equal(plain2[1][k], v), ("plain twice", k)
        assert torch.equal(stack[1][k], v), ("stack", k)
    stats = sum(k.endswith((".mean", ".var")) for k in plain[1])
    _say(f"[pose-remat] hourglass104 remat=stack f32 step at batch {n}, "
         f"{POSE_SIZE} px: loss {stack[0]:.6f}, all {len(plain[1])} tensors "
         f"({stats} BN statistics) equal to the plain step's bit for bit")


def _pose_host_batch(n: int, size: int, seed: int = 0) -> dict:
    """A seeded pose host batch: float32 images in [-1, 1], 16 joints,
    some off the image or hidden."""
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (n, size, size, 3)).astype(
                np.float32),
            "kx": rng.uniform(-0.1, 1.1, (n, POSE_JOINTS)).astype(
                np.float32),
            "ky": rng.uniform(-0.1, 1.1, (n, POSE_JOINTS)).astype(
                np.float32),
            "v": (rng.uniform(size=(n, POSE_JOINTS)) > 0.2).astype(
                np.int32)}


def phase_pose_loss_scale() -> None:
    """The config's ``bf16_scaled`` ``hourglass104`` step (Adam on the
    card, the loss scale on the card, ``"stack"`` remat) at batch 2 and
    256 px: a clean step, then one whose images hold an inf, run under
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises).
    The second is skipped: every parameter, both Adam moments, Adam's
    step count and the BN statistics keep their values, and the loss
    scale halves."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import pose_train_step

    cfg = get_config("hourglass104")
    policy = get_policy(cfg["precision"])
    assert policy.name == "bf16_scaled"
    module = create_model("hourglass104", device=torch.device("cuda"),
                          seed=0, dtype=policy.compute_dtype,
                          **cfg["model_kwargs"])
    assert module.remat == "stack"
    opt, _ = make_optimizer(cfg, module.parameters())
    state = TrainState(module, opt, loss_scale=policy.make_loss_scale())
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _pose_host_batch(2, POSE_SIZE, seed=1).items()}
    first = pose_train_step(state, batch, None)
    first_finite = float(first["mp_grads_finite"])
    before = {**{k: v.clone() for k, v in module.state_dict().items()},
              **{f"{i}:{k}": v.clone() for i, p in
                 enumerate(module.parameters())
                 for k, v in opt.state[p].items()}}
    scale = float(state.loss_scale.scale)
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 5, 5, 0] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = pose_train_step(state, bad, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = {**module.state_dict(),
             **{f"{i}:{k}": v for i, p in enumerate(module.parameters())
                for k, v in opt.state[p].items()}}
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert not moved, moved[:5]
    assert float(m["mp_grads_finite"]) == 0.0
    assert float(state.loss_scale.scale) == scale / 2
    _say(f"[pose-loss-scale] bf16_scaled hourglass104 under remat=stack: "
         f"a first step (finite {first_finite:g}, loss "
         f"{float(first['loss']):.4f}), then one with an inf in its images "
         f"that ran with no host sync (sync debug mode 'error') and was "
         f"skipped: {len(before)} tensors unchanged, loss scale {scale:g} "
         f"-> {float(state.loss_scale.scale):g}")


def phase_pose_step(size: int = POSE_SIZE) -> None:
    """The float32 ``hourglass104`` step (full width, the config's Adam)
    at batch 4 and ``size`` px on the card against the CPU
    (:func:`_adam_step_card_vs_cpu`). At 128 px the recursion's bottom
    BatchNorms see 16 values a channel, and one first moment behind them
    fell 1.9 times its tolerance off on an H100; at 256, 64."""
    import torch

    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import pose_train_step

    base = create_model("hourglass104", device=torch.device("cpu"), seed=0)
    _adam_step_card_vs_cpu("hourglass104", get_config("hourglass104"), base,
                           _pose_host_batch(4, size, seed=2),
                           pose_train_step)


def phase_pose_records(smi: str, workdir: Path) -> dict:
    """The pose path from records: synthetic pose shards (``POSE_TRAIN``
    train and ``POSE_VAL`` val, 4 shards each, JPEGs by nvJPEG, written on
    the card in the builder's schema), the fed and device-resident step
    at 256 and batch 16 in the config's ``bf16_scaled`` under ``"stack"``
    remat with the pose flip in the step (:func:`_fed_and_resident`).
    Returns the readings and the records' directory, whose CLIs
    :func:`phase_model_clis` runs."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.data.device_aug import (
        MPII_FLIP_PERM,
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.pose import make_pose_data
    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_pose,
    )
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import pose_train_step

    d = workdir / "pose_records"
    t0 = time.perf_counter()
    counts = write_synthetic_pose(d, train=POSE_TRAIN, val=POSE_VAL,
                                  shards=4)
    _say(f"[pose-records] wrote {counts} on the card (nvJPEG) in "
         f"{time.perf_counter() - t0:.1f} s")
    cfg = get_config("hourglass104")
    bs = cfg["batch_size"]
    policy = get_policy(cfg["precision"])
    module = create_model("hourglass104", device=torch.device("cuda"),
                          seed=0, dtype=policy.compute_dtype,
                          **cfg["model_kwargs"])
    opt, _ = make_optimizer(cfg, module.parameters())
    state = TrainState(module, opt, loss_scale=policy.make_loss_scale())
    step = augment_step(pose_train_step, DeviceAugment(
        "pose", flip=True, flip_pairs=MPII_FLIP_PERM))
    train_data, _, _ = make_pose_data(
        str(d), bs, POSE_SIZE, steps_per_epoch=2 + POSE_TIMED_STEPS + 8,
        device_aug=True)
    rates = _fed_and_resident("hourglass104", module, partial(step, state),
                              train_data, bs, POSE_SIZE, POSE_TIMED_STEPS,
                              share_of="sort", windows=1)
    return {**rates, "records": d}


def phase_pose(smi: str, workdir: Path) -> dict:
    """Every pose phase but the CLIs: serving, the ``"stack"`` remat
    step, the loss scale's skipped step, the card-vs-CPU step, the record
    path. Returns a summary and the records' directory; no LRN or NMS
    kernel is launched."""
    import torch

    serve = _timed("hourglass104 serve", phase_pose_serve, smi)
    _timed("hourglass104 remat stack", phase_pose_remat)
    _timed("hourglass104 loss scale", phase_pose_loss_scale)
    _timed("hourglass104 card vs cpu", phase_pose_step)
    torch.cuda.empty_cache()
    records = _timed("hourglass104 records", phase_pose_records, smi,
                     workdir)
    torch.cuda.empty_cache()
    return {"serve_bucket64": {k: serve[k] for k in (
                "device_ms", "launches", "idle")},
            "train_bf16_scaled_b16": {k: records[k] for k in (
                "fed", "resident", "mfu", "peak_gb", "idle_fed", "idle",
                "device_ms", "launches")},
            "records": records["records"], "card": smi}


# ------------------------------------------------------------------ GANs


def _gan_checks(answers, singles, cpu, zs) -> None:
    """Served DCGAN images against the CPU's of the same noise: each
    within 1e-4 (float32, TF32 off; the images lie in [-1, 1]); the
    single requests' answers likewise."""
    want = cpu.run(zs)["image"]
    for i, a in enumerate(answers):
        assert np.abs(np.asarray(a["image"]) - want[i]).max() <= 1e-4, i
    for i, a in enumerate(singles):
        assert np.abs(np.asarray(a["image"]) - want[i]).max() <= 1e-4, i


def phase_gan_serve(smi: str) -> dict:
    """``load_served("dcgan_generator")`` with seeded weights, float32
    (TF32 off), behind an ``InferenceEngine`` on buckets (1, 4, 16, 64):
    ``GAN_REQUESTS`` seeded noise vectors queued at once (one bucket-64
    batch) and 4 single ones, the first 8 answers and the singles held
    against the same module on this machine's CPU (:func:`_gan_checks`);
    profiler windows over a bucket-64 batch. No LRN or NMS launch. The
    engine and its eager comparison run under cuDNN's deterministic
    algorithms."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import load_served

    strict_fp32()
    served = load_served("dcgan_generator", seed=0)
    assert served.task == "gan" and served.scale == "tanh"
    assert served.input_shape == (DCGAN_NOISE,)
    zs = (np.random.default_rng(0).normal(size=(GAN_REQUESTS, DCGAN_NOISE))
          .astype(np.float32))
    # cuDNN's default transposed convolutions (dgrad engines) sum with
    # atomics and differ from call to call in the last bit; its
    # deterministic ones let the graphs be held to the eager forward bit
    # for bit
    torch.backends.cudnn.deterministic = True
    try:
        answers, tel, wall, graphs = _serve_against_cpu(
            served, zs, _gan_checks,
            profile={"label": f"dcgan_generator bucket-{BUCKETS[-1]} batch "
                              f"f32 (deterministic cuDNN)", "windows": 3})
    finally:
        torch.backends.cudnn.deterministic = False
    assert all(np.asarray(a["image"]).shape == (28, 28, 1) for a in answers)
    assert tel["batches"] == 5, tel
    _say(f"[gan-serve] dcgan_generator f32: {len(zs)} queued noise "
         f"vectors and 4 single ones answered in {wall:.1f} s; the first "
         f"{CPU_CHECKED} and the single ones within 1e-4 of the CPU's "
         f"images; batches {tel['batches']}; e2e latency p50 "
         f"{tel['e2e_latency']['p50_ms']} ms, device time a batch p50 "
         f"{tel['device_time']['p50_ms']} ms")
    return graphs["profile"]


def _gan_leaves(state) -> dict:
    """Every tensor a GAN step updates, by name: each net's parameters
    and BN statistics, both optimizers' moments and step counts and a
    scheduled Adam's update count, the pools, the loss scale."""
    out = {f"{net}.{k}": v.detach().clone()
           for net, m in state.modules.items()
           for k, v in m.state_dict().items()}
    for name, opt in state.optimizers.items():
        for net in state.roles[name]:
            for k, p in state.modules[net].named_parameters():
                for key, v in opt.state[p].items():
                    out[f"{name}:{key}:{net}.{k}"] = v.detach().clone()
        if hasattr(opt, "count"):
            out[f"{name}:count"] = opt.count.clone()
    for name, pool in state.pools.items():
        out.update({f"{name}:{k}": v.clone() for k, v in pool.items()})
    if state.loss_scale is not None:
        out.update({f"loss_scale:{k}": v.clone() for k, v in
                    state.loss_scale.state_dict().items()})
    return out


def _gan_step_card_vs_cpu(label: str, make_state, host: dict, draws: dict,
                          step, lr: float) -> dict:
    """One float32 step of ``step`` (TF32 off) on the card and on this
    machine's CPU from the same seeded state (``make_state(device)``, the
    CPU's state loaded into both) with the same draws, under the rule of
    :func:`_adam_step_card_vs_cpu`: each leaf within 1e-5 plus three
    times its floor, the largest gap between a platform's run and its
    runs on the batch (and the per-image draws) reversed and rolled by 1
    and 2, for all but 0.1% of its elements, each within 2·lr more; each
    loss within 1e-4 of its scale plus four times its floor. The pools,
    which hold the fakes in batch order, are held card against CPU in
    the batch's own order, within 1e-4. Two faults planted on the card
    must fail it: the state before the step, and the step at 0.9 times
    the LR. No LRN kernel launches."""
    import torch

    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.train.optimizers import set_lr_scale

    strict_fp32()
    orders = (lambda a: a, lambda a: a[::-1],
              lambda a: np.roll(a, 1, axis=0),
              lambda a: np.roll(a, 2, axis=0))
    base = make_state("cpu")
    start = copy.deepcopy(base.state_dict())

    def run(device, order, lr_scale=1.0):
        state = make_state(device)
        state.load_state_dict(copy.deepcopy(start))
        for opt in state.optimizers.values():
            set_lr_scale(opt, lr_scale)

        def moved(v):
            if isinstance(v, (tuple, list)):
                return type(v)(moved(x) for x in v)
            return torch.from_numpy(order(v.numpy()).copy()).to(device)

        batch = {k: torch.from_numpy(order(v).copy()).to(device)
                 for k, v in host.items()}
        metrics = step(state, batch, {k: moved(v) for k, v in draws.items()})
        return ({k: float(v) for k, v in metrics.items()},
                {k: v.cpu() for k, v in _gan_leaves(state).items()})

    t0 = time.perf_counter()
    _zero_launch_counts()
    card = [run("cuda", o) for o in orders]
    launches = sum(_launch_counts().values())
    wrong_lr = run("cuda", orders[0], lr_scale=0.9)[1]
    cpu = [run("cpu", o) for o in orders]

    def gap(a, b):
        return (a.double() - b.double()).abs()

    pooled = [k for k in card[0][1] if k.startswith("pool_")]
    for k in pooled:
        assert float(gap(card[0][1][k], cpu[0][1][k]).max()) <= 1e-4, k
    leaves = [k for k in card[0][1] if k not in pooled]
    floors = {k: max(float(gap(r[1][k], runs[0][1][k]).max())
                     for runs in (card, cpu) for r in runs[1:])
              for k in leaves}
    tol = {k: 1e-5 + 3 * f for k, f in floors.items()}

    def verdict(got):
        bad, most, worst = [], 0, []
        for k in leaves:
            g = gap(cpu[0][1][k], got[k])
            over = int((g > tol[k]).sum())
            most = max(most, over)
            worst.append((float(g.max()) / tol[k], k))
            if over > max(1, g.numel() // 1000) or float(
                    g.max()) > tol[k] + 2 * lr:
                bad.append(k)
        return bad, most, sorted(worst, reverse=True)[:3]

    bad, most, worst = verdict(card[0][1])
    stale = {k: v.cpu() for k, v in _gan_leaves(base).items()}
    stale.update({k: torch.zeros_like(v) for k, v in card[0][1].items()
                  if ":exp_avg" in k})
    stale.update({k: torch.zeros_like(v) for k, v in card[0][1].items()
                  if ":step:" in k or k.endswith(":count")})
    planted = {"state before the step": verdict(stale)[0],
               "LR x 0.9": verdict(wrong_lr)[0]}
    losses = {}
    for k, v in card[0][0].items():
        floor = max(abs(r[0][k] - rs[0][0][k]) for rs in (card, cpu)
                    for r in rs[1:])
        losses[k] = (abs(cpu[0][0][k] - v), 1e-4 * max(1.0, abs(v))
                     + 4 * floor)
    n = len(next(iter(host.values())))
    _say(f"[gan-steps] {label} f32 (TF32 off), batch {n}, one step on "
         f"{len(orders)} batch orders on each side in "
         f"{time.perf_counter() - t0:.1f} s: losses (gap, tolerance) "
         f"{ {k: (f'{g:.2e}', f'{t:.2e}') for k, (g, t) in losses.items()} };"
         f" {len(leaves)} leaves, {len(bad)} beyond the rule {bad[:3]}, at "
         f"most {most} elements of a leaf over its floor tolerance, largest "
         f"gaps over tolerance {[(round(r, 2), k) for r, k in worst]}; "
         f"{len(pooled)} pool tensors within 1e-4; planted faults: "
         + ", ".join(f"{k}: {len(v)} leaves beyond"
                     for k, v in planted.items())
         + f"; LRN launches {launches}")
    assert all(np.isfinite(v) for v in card[0][0].values())
    assert all(g <= t for g, t in losses.values()), losses
    assert not bad, bad[:10]
    assert launches == 0
    assert planted["state before the step"] and planted["LR x 0.9"]
    return {"leaves": len(leaves), "planted": {k: len(v)
                                               for k, v in planted.items()}}


def phase_gan_steps() -> None:
    """Float32 steps, card against CPU (:func:`_gan_step_card_vs_cpu`):
    DCGAN at full width (its config's Adam at 1e-4) at batch
    ``DCGAN_STEP_BATCH``, and CycleGAN at ``n_blocks=2`` and
    ``CYC_STEP_SIZE`` px at batch ``CYC_STEP_BATCH`` (the config's two
    Adams, β1 0.5, under ``linear_decay``, pools of 50), each from one
    seeded state with the same noise, dropout masks and pool draws."""
    import torch

    from deepvision_tpu_torch.data.gan import synthetic_unpaired
    from deepvision_tpu_torch.train import gan
    from deepvision_tpu_torch.train.schedules import linear_decay

    rng = np.random.default_rng(5)
    dc_host = {"image": rng.uniform(-1, 1, (DCGAN_STEP_BATCH, 28, 28, 1))
               .astype(np.float32)}
    dc_draws = gan.dcgan_draws(torch.Generator().manual_seed(3),
                               DCGAN_STEP_BATCH, DCGAN_NOISE)
    _gan_step_card_vs_cpu(
        "dcgan", lambda dev: gan.create_dcgan_state(device=dev), dc_host,
        dc_draws, gan.dcgan_train_step, 1e-4)
    a, b = synthetic_unpaired(CYC_STEP_BATCH, size=CYC_STEP_SIZE, seed=7)
    cy_draws = gan.cyclegan_draws(torch.Generator().manual_seed(4),
                                  CYC_STEP_BATCH, gan.POOL_SIZE)

    def make(dev):
        return gan.create_cyclegan_state(
            image_size=CYC_STEP_SIZE, lr_schedule=linear_decay(2e-4, 8, 2),
            n_blocks=CYC_STEP_BLOCKS, device=dev)

    _gan_step_card_vs_cpu("cyclegan n_blocks=2", make, {"a": a, "b": b},
                          cy_draws, gan.cyclegan_train_step, 2e-4)


def phase_gan_skip() -> None:
    """A ``bf16_scaled`` CycleGAN step at full width (9 blocks, 256 px,
    batch 4; the config's two Adams under ``linear_decay``, one loss
    scale over both tapes): a clean step, then one whose B images hold an
    inf, run under ``torch.cuda.set_sync_debug_mode("error")`` (any host
    sync raises). The second is skipped: every parameter of the four
    nets, both Adams' moments and step counts, the schedule's update
    count, every BN statistic and both pools keep their values, and the
    loss scale halves."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.train import gan
    from deepvision_tpu_torch.train.schedules import linear_decay

    policy = get_policy("bf16_scaled")
    state = gan.create_cyclegan_state(
        image_size=CYC_SIZE, lr_schedule=linear_decay(2e-4, 200 * 250,
                                                      100 * 250),
        policy=policy, dtype=policy.compute_dtype, device="cuda")
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.uniform(
        -1, 1, (CYC_BATCH, CYC_SIZE, CYC_SIZE, 3)).astype(np.float32)).cuda()
        for k in ("a", "b")}
    gen = torch.Generator("cuda").manual_seed(0)
    _zero_launch_counts()
    first = gan.cyclegan_train_step(state, batch, gen)
    first_finite = float(first["mp_grads_finite"])
    before = _gan_leaves(state)
    scale = float(state.loss_scale.scale)
    bad = dict(batch, b=batch["b"].clone())
    bad["b"][0, 5, 5, 0] = float("inf")
    draws = gan.cyclegan_draws(gen, CYC_BATCH, gan.POOL_SIZE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = gan.cyclegan_train_step(state, bad, draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = _gan_leaves(state)
    scale_keys = [k for k in before if k.startswith("loss_scale:")]
    moved = [k for k in before if k not in scale_keys
             and not torch.equal(before[k], after[k])]
    assert not moved, moved[:5]
    assert float(m["mp_grads_finite"]) == 0.0
    assert float(state.loss_scale.scale) == scale / 2
    assert sum(_launch_counts().values()) == 0
    kinds = {"parameters and BN statistics": sum(
        1 for k in before if ":" not in k),
        "Adam moments and counts": sum(1 for k in before if ":exp_avg" in k
                                       or ":step:" in k
                                       or k.endswith(":count")),
        "pool tensors": sum(1 for k in before if k.startswith("pool_"))}
    _say(f"[gan-skip] bf16_scaled cyclegan at {CYC_SIZE} px, batch "
         f"{CYC_BATCH}: a first step (finite {first_finite:g}, total "
         f"generator loss {float(first['loss_gen_total']):.4f}), then one "
         f"with an inf in its B images that ran with no host sync (sync "
         f"debug mode 'error') and was skipped: {kinds} unchanged, loss "
         f"scale {scale:g} -> {float(state.loss_scale.scale):g}; LRN "
         f"launches 0")


def _gan_rates(label: str, step, train_data, bs: int, flops: float,
               timed: int, windows: int = 2) -> dict:
    """``step(batch, generator)`` at batch ``bs`` fed by ``train_data``
    through the device feed, and on a device-resident batch: images/s
    (pairs for CycleGAN), MFU from ``flops`` a step, the feed's
    telemetry, peak memory, and profiler windows (the idle share over
    two fed steps and over a resident step; the device time and launches
    of one resident step)."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher

    keys = KeySeq(1, 6, device="cuda")

    def wait(m):
        float(next(iter(m.values())))

    feed = DevicePrefetcher(train_data, torch.device("cuda"), depth=2)
    try:
        first = next(feed)
        wait(step(first, next(keys)))
        resident = {k: v.clone() for k, v in first.items()}
        wait(step(next(feed), next(keys)))
        t0 = time.perf_counter()
        for _ in range(timed):
            m = step(next(feed), next(keys))
        wait(m)
        fed = timed * bs / (time.perf_counter() - t0)
        tel = feed.telemetry.summary()

        def two_fed_steps():
            for _ in range(2):
                step(next(feed), next(keys))
            torch.cuda.synchronize()

        idle_fed = _idle_share(two_fed_steps, f"{label} two fed steps",
                               windows)
    finally:
        feed.close()
    for _ in range(2):
        wait(step(resident, next(keys)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        m = step(resident, next(keys))
    wait(m)
    dev = timed * bs / (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    mfu = {k: flops * v / bs / BF16_DENSE_FLOPS_PER_S
           for k, v in (("fed", fed), ("resident", dev))}

    def one_step():
        step(resident, next(keys))
        torch.cuda.synchronize()

    prof = _profile(one_step, f"{label} train step batch {bs}",
                    windows=windows)
    assert all(np.isfinite(float(v)) for v in m.values()), m
    _say(f"[gan-train] {label} bf16 batch {bs}: {fed:.1f} images/s "
         f"through the feed over {timed} steps, {dev:.1f} images/s on a "
         f"device-resident batch (same step); wire {tel['wire_dtype']}, "
         f"{tel['image_bytes_per_image']} image bytes an image, h2d_wait "
         f"{tel['h2d_wait_ms']} ms and host_wait {tel['host_wait_ms']} ms a "
         f"batch; model FLOPs {flops:.4e} a step (backward twice the "
         f"forward), MFU {mfu['fed']:.2%} fed and {mfu['resident']:.2%} "
         f"resident; peak allocated {peak_gb:.2f} GiB; idle share fed "
         f"{idle_fed}, resident {prof['idle']}; {prof['launches']} launches "
         f"and {prof['device_ms']} ms of device time a resident step; "
         f"reduction kernels {prof['reduction_share']}, elementwise "
         f"{prof['elementwise_share']} of it")
    return {"fed": fed, "resident": dev, "mfu": mfu, "peak_gb": peak_gb,
            "idle_fed": idle_fed, "idle": prof["idle"],
            "device_ms": prof["device_ms"], "launches": prof["launches"],
            "reduction_share": prof["reduction_share"],
            "elementwise_share": prof["elementwise_share"],
            "flops": flops, "wire": tel["wire_dtype"]}


def _forward_flops(module, x) -> float:
    """Model FLOPs of one forward (2 a MAC of every convolution and
    matmul, from their shapes)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(x)
    return float(counter.get_total_flops())


def phase_gan_train(smi: str, workdir: Path) -> dict:
    """The GANs' training paths at the configs' widths, batches and bf16:
    ``cyclegan`` (9 blocks, 256 px, batch 4) fed from ``--gan`` synthetic
    records (``CYC_RECORDS`` a domain at sides 286-400, JPEGs by nvJPEG,
    written on the card; decoded and resized to the 286 canvas on the
    card, cropped, flipped and scaled in the step) and on a resident
    batch; ``dcgan`` (batch 256) fed from the synthetic digits and
    resident (:func:`_gan_rates`). A CycleGAN step's model FLOPs are
    three times six generator and six critic forwards an image pair;
    DCGAN's three times one generator and three critic forwards an
    image. Returns the readings and the records' directory."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.data.device_aug import (
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.gan import make_cyclegan_data
    from deepvision_tpu_torch.data.mnist import synthetic_mnist
    from deepvision_tpu_torch.data.padding import iter_array_batches
    from deepvision_tpu_torch.data.synthetic_records import (
        write_synthetic_gan,
    )
    from deepvision_tpu_torch.train import gan
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.schedules import linear_decay

    _zero_launch_counts()
    d = workdir / "gan_records"
    t0 = time.perf_counter()
    counts = write_synthetic_gan(d, train=CYC_RECORDS, val=2, shards=4)
    _say(f"[gan-records] wrote {counts} on the card (nvJPEG) in "
         f"{time.perf_counter() - t0:.1f} s")
    cfg = get_config("cyclegan")
    policy = get_policy(cfg["precision"])
    bs = cfg["batch_size"]
    steps = 1000 // bs
    state = gan.create_cyclegan_state(
        image_size=CYC_SIZE, lr_schedule=linear_decay(
            cfg["optimizer_params"]["lr"], cfg["total_epochs"] * steps,
            cfg["decay_epochs"] * steps),
        beta1=cfg["optimizer_params"]["beta1"], policy=policy,
        dtype=policy.compute_dtype, device="cuda")
    step = augment_step(gan.cyclegan_train_step, DeviceAugment(
        "gan", crop=CYC_SIZE, flip=True, normalize="tanh"))
    train_data = make_cyclegan_data(
        str(d), bs, CYC_SIZE, steps_per_epoch=2 + 2 * GAN_TIMED_STEPS + 8,
        device_aug=True)
    x = torch.zeros(1, CYC_SIZE, CYC_SIZE, 3, device="cuda")
    g_flops = _forward_flops(state.modules["gen_a2b"], x)
    d_flops = _forward_flops(state.modules["dis_a"], x)
    cyc = _gan_rates("cyclegan", partial(step, state), train_data(0), bs,
                     3 * 6 * (g_flops + d_flops) * bs, GAN_TIMED_STEPS)
    assert cyc["wire"] == "jpeg", cyc
    state = step = None
    torch.cuda.empty_cache()

    cfg = get_config("dcgan")
    policy = get_policy(cfg["precision"])
    bs = cfg["batch_size"]
    imgs, _ = synthetic_mnist(bs * (4 + 2 * GAN_TIMED_STEPS + 8))
    imgs = (imgs[:, 2:30, 2:30, :] * 2.0 - 1.0).astype(np.float32)
    state = gan.create_dcgan_state(
        noise_dim=cfg["noise_dim"], lr=cfg["optimizer_params"]["lr"],
        policy=policy, dtype=policy.compute_dtype, device="cuda")
    gx = _forward_flops(state.modules["generator"],
                        torch.zeros(1, DCGAN_NOISE, device="cuda"))
    dx = _forward_flops(state.modules["discriminator"],
                        torch.zeros(1, 28, 28, 1, device="cuda"))
    dc = _gan_rates("dcgan", partial(gan.dcgan_train_step, state),
                    iter_array_batches({"image": imgs}, bs,
                                       rng=np.random.default_rng(0)),
                    bs, 3 * (gx + 3 * dx) * bs, 2 * GAN_TIMED_STEPS)
    assert sum(_launch_counts().values()) == 0
    _say(f"[gan-train] forward FLOPs an image: cyclegan generator "
         f"{g_flops:.4e} and PatchGAN {d_flops:.4e} at {CYC_SIZE} px; "
         f"dcgan generator {gx:.4e} and critic {dx:.4e}; LRN launches 0 "
         f"({smi})")
    return {"cyclegan_bf16_b4": cyc, "dcgan_bf16_b256": dc,
            "forward_flops": {"cyclegan_generator": g_flops,
                              "cyclegan_discriminator": d_flops,
                              "dcgan_generator": gx,
                              "dcgan_discriminator": dx},
            "records": d}


def _gan_epochs(out: str) -> list[str]:
    """The per-epoch lines of a GAN training CLI, each loss finite."""
    lines = [s for s in out.splitlines()
             if s.startswith("[epoch ") and " time=" in s]
    for line in lines:
        values = dict(kv.split("=") for kv in line.split("] ", 1)[1].split()
                      if kv.startswith(("loss", "g_loss", "d_loss")))
        assert values and all(np.isfinite(float(v))
                              for v in values.values()), line
    return lines


def _gan_chain(name: str, wd: Path, train_args: list[str]) -> list[str]:
    """``train -m name`` for 1 epoch, then ``--resume`` to 2: each
    epoch's losses finite, a checkpoint each run, no kernel of the port's
    launched but nvJPEG's ``ycc_to_rgb`` on records. Returns the epoch
    lines."""
    common = ["-m", name, "--workdir", str(wd), *train_args]
    first = _cli("deepvision_tpu_torch.train", [*common, "--epochs", "1"])
    resumed = _cli("deepvision_tpu_torch.train",
                   [*common, "--epochs", "2", "--resume"])
    assert "resumed at epoch 1" in resumed.stdout, resumed.stdout[-2000:]
    epochs = _gan_epochs(first.stdout + resumed.stdout)
    assert len(epochs) == 2, epochs
    launches = [_cli_launches(p.stderr) for p in (first, resumed)]
    for counts in launches:  # nvJPEG's colour kernel reads the records
        assert not any(v for k, v in counts.items() if k != "ycc_to_rgb"), (
            counts)
    for line in epochs:
        _say(f"[{name}-cli] {line[:260]}")
    _say(f"[{name}-cli] train CLI 1 epoch then --resume to 2; launches "
         f"{launches}")
    return epochs


def _dcgan_clis(workdir: Path, offer) -> dict:
    """``train -m dcgan`` at its batch of 256 on 512 synthetic digits (2
    steps an epoch), the resume, then its checkpoint offered to the
    serving CLI (``offer``: 2 noise vectors -> 28x28x1 images in [-1,
    1]), and from it ``eval gan -m dcgan`` (the LeNet-5 judge's
    Inception-Score ratio, printed, not gated) and ``predict dcgan``
    (:func:`_predict_dcgan`) at once. Returns the eval line."""
    from concurrent.futures import ThreadPoolExecutor

    wd = workdir / "gan_cli"
    _gan_chain("dcgan", wd, ["--synthetic-size", "512"])
    zs = np.random.default_rng(2).normal(size=(2, DCGAN_NOISE))
    offer(_Offer("dcgan", wd / "dcgan", zs, _images_served))
    with ThreadPoolExecutor(2) as pool:
        evaluate = pool.submit(_cli, "deepvision_tpu_torch.eval",
                               ["gan", "-m", "dcgan", "--workdir",
                                str(wd / "dcgan")])
        predicted = pool.submit(_predict_dcgan, wd / "dcgan")
        evaluate = evaluate.result()
        predicted.result()
    line = json.loads(evaluate.stdout.strip().splitlines()[-1])
    assert line["epoch"] == 1 and np.isfinite(line["score"]), line
    _say(f"[dcgan-cli] eval CLI: {json.dumps(line)}")
    return line


def _images_served(replies: list, launches: dict, runners: dict) -> None:
    """28x28x1 images in [-1, 1], from graphs that launch none of the
    port's kernels."""
    for r in replies:
        image = np.asarray(r["result"]["image"])
        assert image.shape == (28, 28, 1) and np.abs(image).max() <= 1.0
    _no_kernel_a_replay(runners)


def _predict_dcgan(wd: Path) -> None:
    """``predict dcgan -n 16 --seed 0`` from the chain's checkpoint: its
    grid that of ``load_served(...).run`` on the same noise (torch's
    generator on the card, seed 0) within ``PREDICT_TOL``."""
    import torch

    from deepvision_tpu_torch import predict
    from deepvision_tpu_torch.serve.models import load_served

    t0 = time.perf_counter()
    got, launches = _predict(["dcgan", "--workdir", str(wd), "-n", "16",
                              "-o", str(wd / "samples.png")],
                             wd / "dcgan_predict.json")
    dev = torch.device("cuda")
    served = load_served("dcgan", str(wd), device=dev)
    z = predict.sample_noise(16, served.input_shape[0], 0, dev)
    want = predict.dcgan_grid(served.run(z)["image"])
    np.testing.assert_allclose(np.asarray(got), want, atol=PREDICT_TOL)
    _record_predict("dcgan", launches, time.perf_counter() - t0)
    _say(f"[dcgan-cli] predict dcgan: a {want.shape} grid equal to "
         f"load_served's on the same noise; launches {launches}")


def _cyclegan_clis(d: Path, workdir: Path, images: dict) -> dict:
    """``train -m cyclegan --data-dir d --device-aug`` at the config's
    256 px, batch 4 and bf16 for ``GAN_CLI_STEPS`` steps an epoch, the
    resume, then ``eval gan -m cyclegan`` from its checkpoint (the
    inversion score on 32 held-out synthetic pairs at 64 px, printed,
    not gated) and ``predict cyclegan`` (:func:`_predict_cyclegan`) at
    once. Returns the eval line."""
    from concurrent.futures import ThreadPoolExecutor

    wd = workdir / "gan_cli"
    _gan_chain("cyclegan", wd, ["--data-dir", str(d), "--device-aug",
                                "--steps-per-epoch", str(GAN_CLI_STEPS)])
    with ThreadPoolExecutor(2) as pool:
        evaluate = pool.submit(_cli, "deepvision_tpu_torch.eval",
                               ["gan", "-m", "cyclegan", "--workdir",
                                str(wd / "cyclegan"), "--n", "32"])
        predicted = pool.submit(_predict_cyclegan, wd / "cyclegan",
                                images["png"])
        evaluate = evaluate.result()
        predicted.result()
    line = json.loads(evaluate.stdout.strip().splitlines()[-1])
    assert line["epoch"] == 1 and np.isfinite(line["score"]), line
    _say(f"[cyclegan-cli] eval CLI: {json.dumps(line)}")
    return line


def _predict_cyclegan(wd: Path, image: str) -> None:
    """``predict cyclegan`` at 256 px on a PNG from the chain's
    checkpoint: its image that of ``gen_a2b`` run here on the same
    decoded tensor, within ``PREDICT_TOL``."""
    import torch

    from deepvision_tpu_torch import predict

    t0 = time.perf_counter()
    got, launches = _predict(["cyclegan", "--workdir", str(wd), image,
                              "--size", "256", "-o", str(wd / "a2b.png")],
                             wd / "cyclegan_predict.json")
    dev = torch.device("cuda")
    module = predict.cyclegan_generator(str(wd), "a2b", dev)
    x = predict.load_image(image, 256, scale="tanh", device=dev)
    with torch.inference_mode():
        want = module(torch.from_numpy(x).to(dev)).float().cpu().numpy()[0]
    np.testing.assert_allclose(np.asarray(got), want, atol=PREDICT_TOL)
    _record_predict("cyclegan", launches, time.perf_counter() - t0)
    _say(f"[cyclegan-cli] predict cyclegan: {want.shape} equal to gen_a2b's "
         f"on the same decoded PNG; launches {launches}")


def phase_gan(smi: str, workdir: Path) -> dict:
    """Every GAN phase but the CLIs: the served DCGAN generator, the
    card-vs-CPU steps, the skipped loss-scaled step, the training paths.
    Returns a summary and the records' directory (for
    :func:`phase_model_clis`); no LRN or NMS kernel is launched."""
    import torch

    serve = _timed("gan serve", phase_gan_serve, smi)
    _timed("gan steps", phase_gan_steps)
    torch.cuda.empty_cache()
    _timed("gan skip", phase_gan_skip)
    torch.cuda.empty_cache()
    train = _timed("gan train", phase_gan_train, smi, workdir)
    torch.cuda.empty_cache()
    keys = ("fed", "resident", "mfu", "peak_gb", "idle_fed", "idle",
            "device_ms", "launches", "reduction_share", "elementwise_share")
    return {"dcgan_generator_serve_bucket64": {k: serve[k] for k in (
                "device_ms", "launches", "idle")},
            "cyclegan_train_bf16_b4": {
                k: train["cyclegan_bf16_b4"][k] for k in keys},
            "dcgan_train_bf16_b256": {
                k: train["dcgan_bf16_b256"][k] for k in keys},
            "forward_flops": train["forward_flops"],
            "records": train["records"], "card": smi}


# ---------------------------------------------------- the five classifiers


def _classify_check(served, n: int, tol: float):
    """A check for :func:`_serve_against_cpu`: the first ``n`` of
    ``served``'s answers' top-5 classes and probabilities, and the logits
    of the same images, against the CPU's run of the same weights; a
    class may differ only where the CPU gives it the same probability
    within ``tol`` (a tie). Returns the check and the dict it fills with
    the largest gaps."""
    import torch

    gaps = {}

    def check(answers, singles, cpu, xs):
        del singles
        with torch.inference_mode():
            logits_cpu = cpu.module(torch.from_numpy(xs[:n]))
            logits_card = served.module(
                torch.from_numpy(xs[:n]).cuda()).cpu()
        probs = torch.softmax(logits_cpu, -1)
        top_p, top_c = torch.topk(probs, 5, dim=-1)
        _check_against(answers[:n], top_p.numpy(), top_c.numpy(),
                       probs.numpy(), atol=tol)
        gaps["logits"] = float((logits_card - logits_cpu).abs().max())
        gaps["logit_scale"] = float(logits_cpu.abs().max())
        gaps["probs"] = max(float(np.abs(np.asarray(a["probs"])
                                         - top_p[i].numpy()).max())
                            for i, a in enumerate(answers[:n]))
        assert gaps["logits"] <= tol * max(1.0, gaps["logit_scale"]), gaps

    return check, gaps


def _calibrate_bn(module, xs: np.ndarray) -> None:
    """Every BatchNorm's running statistics set to those of a batch of
    ``xs`` (one training-mode forward at momentum 0, dropout off), as a
    trained model's would be: fresh statistics (mean 0, var 1) shrink
    MobileNet's activations through its depthwise layers to logits of
    1e-19 and blow Inception V3's up to hundreds, where a comparison of
    answers says little."""
    import torch

    from deepvision_tpu_torch.models.layers import MixedBatchNorm

    norms = [m for m in module.modules() if isinstance(m, MixedBatchNorm)]
    if not norms:
        return
    saved = [m.momentum for m in norms]
    rates = {m: m.dropout_rate for m in module.modules()
             if hasattr(m, "dropout_rate")}
    try:
        for m in norms:
            m.momentum = 0.0
        for m in rates:
            m.dropout_rate = 0.0
        with torch.no_grad():
            module(torch.from_numpy(xs[:CLS_CALIBRATION]).cuda(), train=True)
    finally:
        for m, momentum in zip(norms, saved):
            m.momentum = momentum
        for m, rate in rates.items():
            m.dropout_rate = rate


def _classifier_serve(smi: str, name: str) -> dict:
    """``name`` served in float32 (TF32 off) at its config's geometry,
    1000 classes, seeded weights (BN statistics from
    :func:`_calibrate_bn`), behind an ``InferenceEngine`` on
    ``BUCKETS``: 64 queued requests (one bucket-64 batch) and 4 single
    ones, the first ``CLS_CPU_CHECKED`` answers and their logits held
    against the same weights on this machine's CPU, no LRN or NMS
    launch; then profiler windows over one bucket-64 batch."""
    from deepvision_tpu_torch.device import strict_fp32
    from deepvision_tpu_torch.serve import load_served

    strict_fp32()
    t0 = time.perf_counter()
    served = load_served(name, seed=0)
    xs = (np.random.default_rng(0)
          .normal(0, 1, (BUCKETS[-1], *served.input_shape))
          .astype(np.float32))
    _calibrate_bn(served.module, xs)
    check, gaps = _classify_check(served, CLS_CPU_CHECKED, CLS_TOL)
    _, tel, wall, graphs = _serve_against_cpu(
        served, xs, check,
        profile={"label": f"{name} bucket-{BUCKETS[-1]} batch", "top": 5,
                 "windows": 3})
    _say(f"[{name}-serve] {served.input_shape} -> 1000 classes, largest "
         f"|logit| {gaps['logit_scale']:.3g}, "
         f"{sum(p.numel() for p in served.module.parameters())} parameters,"
         f" input scale {served.scale}: {len(xs)} queued requests and 4 "
         f"single ones in {wall:.1f} s (load, warm-up and the CPU's run "
         f"{time.perf_counter() - t0:.1f} s in all); e2e p50 "
         f"{tel['e2e_latency']['p50_ms']} ms; the first {CLS_CPU_CHECKED} "
         f"answers' top-5 and logits match the CPU's (probs within "
         f"{CLS_TOL}: largest gap {gaps['probs']:.2e}; logits within "
         f"{CLS_TOL} x max(1, |logit|) = "
         f"{CLS_TOL * max(1.0, gaps['logit_scale']):.2e}: largest gap "
         f"{gaps['logits']:.2e}); LRN and NMS launches 0 ({smi})")
    prof = graphs["profile"]
    return {"device_ms": prof["device_ms"], "launches": prof["launches"],
            "idle": prof["idle"], "logit_gap": gaps["logits"]}


def _classifier_train(smi: str, name: str, workdir: Path) -> dict:
    """The bf16 step of ``name``'s Trainer at its config's batch and
    geometry (``trainer.state`` and the classification step it runs),
    on one device-resident synthetic batch: ``CLS_WARMUP`` steps, then
    ``CLS_TIMED_STEPS`` timed ones (images/s, MFU from the model's
    FLOPs, peak allocated memory, no LRN launch), then profiler windows
    over one step (device time, launches, the top 5 kernels, idle
    share)."""
    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import classification_train_step
    from deepvision_tpu_torch.train.trainer import Trainer

    cfg = get_config(name)
    bs, size = cfg["batch_size"], cfg["input_size"]
    kind = "torch" if cfg.get("augment") == "pt" else "imagenet"
    module = create_model(name, device=torch.device("cuda"), seed=0,
                          dtype=torch.bfloat16,
                          **cfg.get("model_kwargs", {}))
    trainer = Trainer(module, cfg, lambda e: iter(()), lambda: iter(()),
                      workdir=workdir / "inproc_classifiers",
                      steps_per_epoch=1000)
    state = trainer.state
    keys = KeySeq(1, 7, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(bs, size=size).items()}

    def step():
        return classification_train_step(state, batch, next(keys), kind)

    for _ in range(CLS_WARMUP):
        step()["loss"].item()
    _zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(CLS_TIMED_STEPS):
        m = step()
    loss = m["loss"].item()
    rate = CLS_TIMED_STEPS * bs / (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    assert np.isfinite(loss) and sum(_launch_counts().values()) == 0
    flops = 3 * bs * _model_flops_per_image(module, size)
    mfu = flops * rate / bs / BF16_DENSE_FLOPS_PER_S
    _say(f"[{name}-train] bf16 batch {bs} at {size} ({cfg['optimizer']}, "
         f"{cfg['scheduler']} schedule): {rate:.1f} images/s on a "
         f"device-resident batch over {CLS_TIMED_STEPS} steps after "
         f"{CLS_WARMUP}; loss {loss:.4f}; peak allocated {peak_gb:.2f} GiB;"
         f" model FLOPs {flops:.4e} a step, MFU {mfu:.2%}; LRN launches 0 "
         f"({smi})")

    def one_step():
        step()
        torch.cuda.synchronize()

    prof = _profile(one_step, f"{name} train step bf16 batch {bs}", top=5,
                    windows=3)
    return {"images_s": rate, "peak_gb": peak_gb, "mfu": mfu,
            "flops": flops, "device_ms": prof["device_ms"],
            "launches": prof["launches"], "idle": prof["idle"],
            "reduction_share": prof["reduction_share"],
            "elementwise_share": prof["elementwise_share"]}


def phase_rmsprop_skip() -> None:
    """``mobilenet1`` (full width, 224 px, batch 2) under ``bf16_scaled``
    with its RMSprop built by ``make_optimizer`` (``nu`` and the update
    count on the card): one clean step, then one whose images hold an
    inf, run under ``torch.cuda.set_sync_debug_mode("error")`` (any host
    sync raises). The step is skipped: every parameter, BN statistic,
    ``nu`` and the update count keep their values bit for bit, and the
    loss scale halves."""
    import torch

    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.optimizers import (
        ScheduledRMSprop,
        make_optimizer,
    )
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    policy = get_policy("bf16_scaled")
    module = create_model("mobilenet1", device=torch.device("cuda"), seed=0,
                          dtype=policy.compute_dtype)
    opt, _ = make_optimizer(get_config("mobilenet1"), module.parameters(),
                            1000)
    assert isinstance(opt, ScheduledRMSprop) and opt.count.is_cuda
    state = TrainState(module, opt, loss_scale=policy.make_loss_scale())
    keys = KeySeq(1, 3, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _train_batch(2, seed=4).items()}
    classification_train_step(state, batch, next(keys), "torch")[
        "loss"].item()

    def snapshot():
        return {**{k: v.clone() for k, v in module.state_dict().items()},
                **{f"nu:{n}": opt.state[p]["nu"].clone()
                   for n, p in module.named_parameters()},
                "count": opt.count.clone()}

    before, scale = snapshot(), float(state.loss_scale.scale)
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 5, 5, 0] = float("inf")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = classification_train_step(state, bad, next(keys), "torch")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = snapshot()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert not moved, moved[:5]
    assert float(m["mp_grads_finite"]) == 0.0
    assert float(state.loss_scale.scale) == scale / 2
    assert float(after["count"]) == 1.0
    _say(f"[rmsprop] a bf16_scaled mobilenet1 step with an inf in its "
         f"images ran with no host sync (sync debug mode 'error'); "
         f"skipped: {len(before)} tensors (parameters, BN statistics, "
         f"RMSprop's nu and update count, on the card) unchanged bit for "
         f"bit, loss scale {scale:g} -> {float(state.loss_scale.scale):g}")


def _mobilenet_clis(workdir: Path, images: dict, offer) -> None:
    """:func:`phase_train_cli` of ``mobilenet1`` (RMSprop and the step
    schedule, whose update count the restore must give back), then its
    newest checkpoint offered to the serving CLI (``offer``, 2
    requests) and ``predict classify`` on a JPEG from it
    (:func:`_predict_classify`)."""
    wd = workdir / "classifier_cli"
    phase_train_cli(wd, "mobilenet1", lrns=0)
    offer(_Offer("mobilenet1", wd / "mobilenet1",
                 _train_batch(2, seed=1)["image"], _top5_served))
    _predict_classify(wd / "mobilenet1", images["jpeg"])


def _lrn_top5_served(replies: list, launches: dict, runners: dict) -> None:
    """Finite top-5 answers, from graphs that launch 2 ``lrn_forward_f32``
    a replay (``inception1_ref``'s stem LRNs)."""
    for r in replies:
        assert len(r["result"]["classes"]) == 5
        assert np.all(np.isfinite(r["result"]["probs"])), r
    assert all(b["launches"] == {"lrn_forward_f32": 2}
               for b in runners["buckets"].values()), runners


def _top5_served(replies: list, launches: dict, runners: dict) -> None:
    """Finite top-5 answers, from graphs that launch none of the port's
    kernels."""
    for r in replies:
        assert len(r["result"]["classes"]) == 5
        assert np.all(np.isfinite(r["result"]["probs"])), r
    _no_kernel_a_replay(runners)


def _predict_classify(wd: Path, image: str) -> None:
    """``predict classify -m mobilenet1`` on a JPEG from ``wd``'s
    checkpoint: its top-5 those of ``load_served(...).run`` on the same
    decoded tensor (probabilities within ``PREDICT_TOL``)."""
    t0 = time.perf_counter()
    p = _predict_served("mobilenet1", wd, image,
                        ["classify", "-m", "mobilenet1", "--workdir",
                         str(wd), image], "torch", 224)
    _same_topk(p["got"][0], p["want"], "mobilenet1")
    assert p["launches"]["ycc_to_rgb"] == 1, p["launches"]
    _record_predict("mobilenet1_classify", p["launches"],
                    time.perf_counter() - t0)
    _say(f"[mobilenet1-cli] predict classify on a JPEG: top-5 "
         f"{p['got'][0]['classes']} equal to load_served's; launches "
         f"{p['launches']}")


def phase_classifiers(smi: str, workdir: Path) -> dict:
    """VGG-16 and -19, MobileNet V1, ShuffleNet V1 and Inception V3 at
    their configs' geometry (224 px; 299 for ``inception3``), none of
    which reaches an LRN or NMS kernel: each served (float32, bucket 64,
    held against the CPU) and its Trainer's bf16 step timed; the float32
    step of ``mobilenet1`` (RMSprop, depthwise convolutions) and
    ``shufflenet1`` (grouped convolutions, SAME stride-2 pads) on the
    card against the CPU under the rule and planted faults of
    :func:`phase_card_vs_cpu_step`; the skipped RMSprop step. Returns a
    summary by model (the CLI chain runs in :func:`phase_model_clis`)."""
    import torch

    summary = {}
    for name in CLASSIFIERS:
        serve = _timed(f"{name} serve", _classifier_serve, smi, name)
        torch.cuda.empty_cache()
        train = _timed(f"{name} train", _classifier_train, smi, name,
                       workdir)
        torch.cuda.empty_cache()
        summary[name] = {"serve_bucket64": serve, "train_bf16": train}
    for name in ("mobilenet1", "shufflenet1"):
        _timed(f"{name} card-vs-cpu step", phase_card_vs_cpu_step, name,
               n=CLS_STEP_BATCH)
    _timed("rmsprop skip", phase_rmsprop_skip)
    torch.cuda.empty_cache()
    summary["card"] = smi
    return summary


def _log_text(path: Path) -> str:
    return path.read_text(errors="replace") if path.exists() else ""


def _cli_proc(args: list[str], log: Path) -> subprocess.Popen:
    """The training CLI in its own process, its stdout and stderr into
    ``log``.out and ``log``.err (no pipe to fill while others run)."""
    return subprocess.Popen(
        [sys.executable, "-m", "deepvision_tpu_torch.train", *args],
        stdout=open(f"{log}.out", "w"), stderr=open(f"{log}.err", "w"),
        text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)})


def _finished(proc: subprocess.Popen, log: Path, code: int = 0
              ) -> tuple[str, str]:
    proc.wait(timeout=900)
    out, err = _log_text(Path(f"{log}.out")), _log_text(Path(f"{log}.err"))
    assert proc.returncode == code, (log.name, proc.returncode,
                                     out[-3000:], err[-3000:])
    return out, err


def _epoch_metrics(out: str, epoch: int) -> dict:
    """The ``[epoch N] k=v ...`` line of a training CLI as floats."""
    line = re.search(rf"^\[epoch {epoch}\] (.*)$", out, re.M).group(1)
    return {k: float(v) for k, v in
            (kv.split("=", 1) for kv in line.split() if "=" in kv)}


def _saved_step(ckpt: Path, epoch: int) -> int:
    import torch

    return int(torch.load(ckpt / str(epoch) / "state.pt", map_location="cpu",
                          weights_only=True)["step"])


def phase_resilience(smi: str, workdir: Path, d: Path) -> dict:
    """The resilient run of ``alexnet1`` at full width (224 px, 1000
    classes, batch 128, bf16), three CLIs at once on the one card:

    - chaos: 2 epochs over the JPEG shards ``d`` with ``--device-aug
      --loader-workers 2``, ``--recover --faults CHAOS_FAULTS`` (the
      epoch-0 checkpoint garbled, two transient reads and then a NaN
      batch in epoch 1, so that the rollback quarantines the only
      checkpoint and restores the initial state; a loader worker
      SIGKILLed),
      ``--sentinel --async-checkpoint --keep-best --stall-timeout`` and
      ``--trace`` with ``--profile-steps``: the ``[recovery]`` line says
      one rollback, one checkpoint fallback and two data retries, one
      loader worker was respawned, the LRN kernels launched on the
      rolled-back and resumed steps, the trace's ``fetch``, ``step``,
      ``eval`` and ``checkpoint`` spans cover at least 95% of its
      epochs, and the profiler window wrote a trace with the card's
      kernels;
    - SDC: synthetic data, ``--sentinel --recover --faults
      sdc_grad@SDC_STEP:SDC_SCALE``: the sentinel trips on the corrupted
      weights and the run rolls back;
    - preempt: SIGTERM after the first step line, exit 143 with a
      mid-epoch save, then ``--resume``: the same epoch goes on at the
      next step and the run ends at the uninterrupted twin's (run at
      once) step count, its losses finite and within 5% of the twin's
      (bit-identity of a resume is the CPU tests'; cuDNN's backward is
      not deterministic here).

    Returns the chaos CLI's kernel launches and a summary."""
    from deepvision_tpu_torch.obs.trace import summarize_chrome

    root = workdir / "resilience"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    trace = root / "chaos_trace.json"
    chaos_args = [
        "-m", "alexnet1", "--data-dir", str(d), "--no-raw", "--device-aug",
        "--loader-workers", "2", "--steps-per-epoch", str(RES_STEPS),
        "--epochs", "2", "--recover", "--faults", CHAOS_FAULTS, "--sentinel",
        "--async-checkpoint", "--keep-best", "--stall-timeout", "300",
        "--trace", str(trace), "--profile-steps", "5:6",
        "--workdir", str(root / "chaos")]
    bs = 128
    synth = ["-m", "alexnet1", "--synthetic-size",
             str((RES_STEPS * 2 + 1) * bs), "--steps-per-epoch",
             str(RES_STEPS * 2)]
    sdc_args = [*synth, "--epochs", "2", "--sentinel", "--sentinel-warmup",
                "4", "--recover", "--faults",
                f"sdc_grad@{SDC_STEP}:{SDC_SCALE}",
                "--workdir", str(root / "sdc")]
    pre_args = [*synth, "--epochs", "2", "--workdir", str(root / "preempt")]
    t0 = time.perf_counter()
    procs = {"chaos": _cli_proc(chaos_args, root / "chaos"),
             "sdc": _cli_proc(sdc_args, root / "sdc"),
             "straight": _cli_proc([*synth, "--epochs", "2", "--workdir",
                                    str(root / "straight")],
                                   root / "straight")}
    # the preempted run: SIGTERM once its first step line is out
    cut = subprocess.Popen(
        [sys.executable, "-m", "deepvision_tpu_torch.train", *pre_args],
        stdout=subprocess.PIPE, stderr=open(root / "cut.err", "w"),
        text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)})
    lines = []
    for line in cut.stdout:
        lines.append(line)
        if line.startswith("[epoch 0 batch 0]"):
            cut.send_signal(signal.SIGTERM)  # printed once a run
    cut.wait(timeout=600)
    cut_out = "".join(lines)
    assert cut.returncode == 143, (cut.returncode, cut_out[-3000:],
                                   _log_text(root / "cut.err")[-3000:])
    k = int(re.search(r"^\[preempted\] saved epoch 0 step (\d+) to ",
                      cut_out, re.M).group(1))
    assert 0 < k < RES_STEPS * 2, k
    resumed = _run_cli([*pre_args, "--resume"])
    assert f"resumed at epoch 0 step {k}" in resumed.stdout, \
        resumed.stdout[-2000:]
    first = _epoch_metrics(resumed.stdout, 0)
    assert first["train_from_step"] == k, first
    straight_out, _ = _finished(procs["straight"], root / "straight")
    want, got = _epoch_metrics(straight_out, 1), _epoch_metrics(
        resumed.stdout, 1)
    steps = (_saved_step(root / "preempt" / "alexnet1" / "ckpt", 1),
             _saved_step(root / "straight" / "alexnet1" / "ckpt", 1))
    assert steps == (2 * 2 * RES_STEPS,) * 2, steps
    for key in ("train_loss", "val_loss"):
        assert np.isfinite(got[key]), got
        assert abs(got[key] - want[key]) <= 0.05 * abs(want[key]), (
            key, got[key], want[key])
    assert not (root / "preempt" / "alexnet1" / "ckpt_preempt").exists()
    _say(f"[preempt] SIGTERM after the first step line: saved epoch 0 step "
         f"{k}, exit 143; --resume went on at step {k} (train_from_step "
         f"{first['train_from_step']:.0f}) and ended at step {steps[0]} "
         f"like the uninterrupted twin: train_loss {got['train_loss']:.4f} "
         f"vs {want['train_loss']:.4f}, val_loss {got['val_loss']:.4f} vs "
         f"{want['val_loss']:.4f}")

    sdc_out, _ = _finished(procs["sdc"], root / "sdc")
    assert (f"[fault] sdc_grad corrupted local state at run step "
            f"{SDC_STEP}") in sdc_out, sdc_out[-3000:]
    trip = re.search(r"^\[rollback\] (sentinel \S+ tripped \(\|z\|=\S+\) "
                     r"at epoch \d+ step \d+): restored (.+?); resuming",
                     sdc_out, re.M)
    assert trip, sdc_out[-3000:]
    assert "[recovery] rollbacks=1 " in sdc_out, sdc_out[-2000:]
    _say(f"[sdc] sdc_grad@{SDC_STEP}:{SDC_SCALE} scaled the largest weight; "
         f"{trip.group(1)}, restored {trip.group(2)}; "
         + re.search(r"^\[recovery\] rollbacks.*$", sdc_out, re.M).group(0))

    chaos_out, chaos_err = _finished(procs["chaos"], root / "chaos")
    _say(f"[chaos] three CLIs at once in {time.perf_counter() - t0:.1f} s")
    for line in chaos_out.splitlines():
        if line.startswith(("[fault]", "[rollback]", "[ckpt-integrity]",
                            "[data-retry]", "[loader]", "[feed]",
                            "[recovery]", "[faults]", "[obs]")):
            _say(f"[chaos]   {line[:300]}")
    assert ("[recovery] rollbacks=1 ckpt_fallbacks=1 data_retries=2"
            in chaos_out), chaos_out[-3000:]
    restarts = re.findall(r"^\[loader\] worker \d died .* \(restart 1/2\)$",
                          chaos_out, re.M)
    assert len(restarts) == 1, chaos_out[-3000:]
    # the garbled epoch-0 checkpoint quarantined, none older: the
    # rollback's last resort, the initial state
    assert re.search(r"^\[rollback\] NaN/Inf detected at epoch 1 step 1: "
                     r".*restored initial state \(no verifiable checkpoint "
                     r"yet\); resuming epoch 1 at step 2", chaos_out, re.M), \
        chaos_out[-3000:]
    paths = re.findall(r"loader workers moved (\d+) batches through shared "
                       r"memory and (\d+) pickled", chaos_out)
    assert paths and all(int(a) > 0 for a, _ in paths), paths
    launches = _cli_launches(chaos_err)
    for kernel in ("lrn_forward_bf16", "lrn_backward_bf16"):
        assert launches[kernel] > 0, launches
    summary = summarize_chrome(json.loads(trace.read_text()))
    spans = summary["spans"]
    for name in ("fetch", "step", "eval", "checkpoint"):
        assert name in spans, sorted(spans)
    assert summary["coverage"] >= 0.95, summary
    prof = root / "chaos" / "alexnet1" / "profile" / "steps_5_6.pt.trace.json"
    kernels = [e for e in json.loads(prof.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    assert kernels, prof
    _say(f"[chaos] trace: coverage {summary['coverage']:.4f} of "
         f"{summary['wall_ms']:.0f} ms of epochs; "
         + ", ".join(f"{n} {spans[n]['count']}x {spans[n]['total_ms']:.0f} ms"
                     for n in ("fetch", "step", "drain", "eval",
                               "checkpoint") if n in spans)
         + f"; profiler window steps 5..6: {len(kernels)} kernel events "
         f"in {prof.name}; kernel launches {launches}; {smi}")
    return {"launches": launches,
            "summary": {"chaos_coverage": summary["coverage"],
                        "chaos_loader_batches": [[int(a), int(b)]
                                                 for a, b in paths],
                        "preempt_step": k, "sdc_trip": trip.group(1),
                        "card": smi}}


def phase_loader(smi: str, workdir: Path, d: Path) -> dict:
    """``resnet50`` in bf16 at batch 256 (its Trainer's step, with the
    augmentation of ``--device-aug``), fed from the JPEG shards ``d`` by
    one reader process (``loader_workers=1``) and then by four spawned
    ones: the seconds to the first batch (the workers' start-up), then
    images/s over ``LOADER_STEPS`` steps after 2, the host and feed
    waits a batch, and the path the loader's batches took. Printed
    beside the card; no gain is claimed or gated."""
    from functools import partial

    import torch

    from deepvision_tpu_torch.core.prng import KeySeq
    from deepvision_tpu_torch.data.device_aug import (
        DeviceAugment,
        augment_step,
    )
    from deepvision_tpu_torch.data.imagenet import PT_JITTER, make_imagenet_data
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.obs.metrics import default_registry
    from deepvision_tpu_torch.train.configs import get_config
    from deepvision_tpu_torch.train.steps import classification_train_step
    from deepvision_tpu_torch.train.trainer import Trainer

    cfg = get_config("resnet50")
    module = create_model("resnet50", device=torch.device("cuda"), seed=0,
                          dtype=torch.bfloat16, **cfg["model_kwargs"])
    trainer = Trainer(module, cfg, lambda e: iter(()), lambda: iter(()),
                      workdir=workdir / "loader", log_every=0,
                      steps_per_epoch=1)
    step = augment_step(
        partial(classification_train_step, normalize_kind="torch"),
        DeviceAugment("classification", flip=True, jitter=PT_JITTER))
    keys = KeySeq(1, 9, device="cuda")
    # the step's first calls (cuDNN's autotuning, the allocator) on a
    # resident batch, so that neither reader's run pays them
    resident = {"image": torch.randint(0, 256, (256, 224, 224, 3),
                                       dtype=torch.uint8, device="cuda"),
                "label": torch.randint(0, 1000, (256,), device="cuda")}
    for _ in range(3):
        step(trainer.state, resident, next(keys))["loss"].item()
    reg = default_registry()
    out = {}
    for workers in (1, 4):
        paths0 = {k: reg.value_of(f"loader_{k}_batches")
                  for k in ("shm", "pickle")}
        train_data, _, _ = make_imagenet_data(
            str(d), 256, 224, augment="pt", use_raw=False, device_aug=True,
            steps_per_epoch=2 + LOADER_STEPS, loader_workers=workers)
        t0 = time.perf_counter()
        feed = DevicePrefetcher(train_data(0), torch.device("cuda"),
                                depth=2)
        try:
            batch = next(feed)
            startup = time.perf_counter() - t0
            step(trainer.state, batch, next(keys))
            step(trainer.state, next(feed), next(keys))["loss"].item()
            tel0 = feed.telemetry.summary()
            t0 = time.perf_counter()
            for _ in range(LOADER_STEPS):
                m = step(trainer.state, next(feed), next(keys))
            assert np.isfinite(m["loss"].item())
            rate = LOADER_STEPS * 256 / (time.perf_counter() - t0)
            tel = feed.telemetry
        finally:
            feed.close()
        n = tel.batches
        host_wait = tel.host_wait_s * 1e3 / n
        h2d_wait = (tel.h2d_wait_s * 1e3 - tel0["h2d_wait_ms"] * 2) / (n - 2)
        moved = {k: int(reg.value_of(f"loader_{k}_batches") - v)
                 for k, v in paths0.items()}
        if workers > 1:
            assert moved["shm"] > 0, moved
        via = (f"{moved['shm']} batches through shared memory, "
               f"{moved['pickle']} pickled" if workers > 1
               else "one reader process, no loader")
        out[workers] = {"images_s": rate, "first_batch_s": startup,
                        "host_wait_ms": host_wait, "h2d_wait_ms": h2d_wait,
                        "path": via}
        _say(f"[loader] resnet50 bf16 batch 256, JPEG shards, "
             f"{workers} reader process{'es' if workers > 1 else ''}: "
             f"first batch after {startup:.2f} s, then {rate:.1f} images/s "
             f"over {LOADER_STEPS} steps; host_wait {host_wait:.1f} ms a "
             f"batch (first batch included), h2d_wait {h2d_wait:.1f} ms a "
             f"timed batch; {via}; {smi}")
    return out


# ------------------------------------------------------------ offline tools


def _gray_jpeg(pixels: np.ndarray) -> bytes:
    """A baseline 1-component (grayscale) JPEG of uint8 ``pixels`` (H, W),
    written without PIL: each 8x8 block is coded by its DC term alone
    (quantizer 8, the standard luminance DC table, an AC table holding
    only end-of-block), so it decodes to the blocks' means."""
    import struct

    h, w = pixels.shape
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    x = np.pad(pixels.astype(np.float64), ((0, ph - h), (0, pw - w)),
               mode="edge")
    means = x.reshape(ph // 8, 8, pw // 8, 8).mean(axis=(1, 3))
    # the DC term is 8 x the level-shifted mean, over the quantizer 8
    dc = np.round(means - 128.0).astype(int).reshape(-1)
    bits = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    codes, code, k = {}, 0, 0  # canonical Huffman codes of categories
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            codes[k] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    out, acc, nbits = bytearray(), 0, 0

    def put(value, length):
        nonlocal acc, nbits
        acc, nbits = (acc << length) | value, nbits + length
        while nbits >= 8:
            byte = (acc >> (nbits - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nbits -= 8

    prev = 0
    for value in dc:
        diff, prev = value - prev, value
        cat = int(abs(diff)).bit_length()
        put(*codes[cat])
        if cat:
            put(diff if diff > 0 else diff + (1 << cat) - 1, cat)
        put(0, 1)  # end of block: the AC table's one code
    if nbits:
        put((1 << (8 - nbits)) - 1, 8 - nbits)

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    quant = bytes([0, 8] + [1] * 63)
    return (b"\xff\xd8"
            + seg(0xDB, quant)
            + seg(0xC0, struct.pack(">BHHBBBB", 8, h, w, 1, 1, 0x11, 0))
            + seg(0xC4, bytes([0x00, *bits, *range(12)]))
            + seg(0xC4, bytes([0x10, 1] + [0] * 15 + [0]))
            + seg(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
            + bytes(out) + b"\xff\xd9")


def _nv_jpegs(images) -> list[bytes]:
    """uint8 (H, W, 3) tensors on the card -> JPEG bytes by nvJPEG."""
    from deepvision_tpu_torch.data.jpeg import encode_images

    return encode_images(images)


def _offline_trees(root: Path) -> dict:
    """The builders' inputs, every image made on the card and encoded by
    nvJPEG (no PIL here): a flattened ImageNet tree (``OFFLINE_TRAIN``
    JPEGs, one grayscale JPEG and one PNG under a ``.JPEG`` name, written
    by ``_gray_jpeg`` and the port's PNG writer) and a validation tree
    (``OFFLINE_VAL``), a synsets file, a bounding-box XML tree for the
    first 16 train files, a VOC tree and an MPII JSON of
    ``OFFLINE_SMALL`` images each. Returns the paths and each file's
    source (label, height, width), and the odd files' pixels."""
    import torch

    from deepvision_tpu_torch.data.image_io import encode_png
    from deepvision_tpu_torch.data.metadata import imagenet_synsets
    from deepvision_tpu_torch.data.synthetic_records import synthetic_image

    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    root.mkdir(parents=True)
    wnids = [w for w, _ in imagenet_synsets()[:OFFLINE_CLASSES]]
    (root / "synsets.txt").write_text("\n".join(wnids) + "\n")
    sources, odd = {}, {}
    for split, n in (("train", OFFLINE_TRAIN), ("val", OFFLINE_VAL)):
        d = root / split
        d.mkdir(parents=True)
        dims = [(int(rng.integers(224, 320)), int(rng.integers(224, 320)))
                for _ in range(n)]
        labels = rng.integers(0, OFFLINE_CLASSES, n)
        blobs = _nv_jpegs([synthetic_image(rng, h, w, int(c), dev)
                           for (h, w), c in zip(dims, labels)])
        for i, (blob, (h, w), c) in enumerate(zip(blobs, dims, labels)):
            name = f"{wnids[c]}_{split}{i:04d}.JPEG"
            (d / name).write_bytes(blob)
            sources[name] = (int(c) + 1, h, w)
    # 8x8-block-constant, so that _gray_jpeg's DC-only coding is exact
    gray = synthetic_image(rng, 232, 248, 1, dev).float().mean(-1)
    gray = torch.nn.functional.avg_pool2d(gray[None, None], 8)[0, 0]
    gray = gray.round().repeat_interleave(8, 0).repeat_interleave(8, 1)
    gray = gray.to(torch.uint8).cpu().numpy()
    # a smooth field (no noise), as a photo, whose re-encode stays close
    low = torch.from_numpy(rng.uniform(0, 255, (1, 3, 8, 8))).float()
    png = torch.nn.functional.interpolate(low, size=(240, 262),
                                          mode="bilinear")[0]
    png = png.permute(1, 2, 0).round().to(torch.uint8).numpy()
    for name, blob, pixels in ((f"{wnids[1]}_gray.JPEG", _gray_jpeg(gray),
                                np.repeat(gray[..., None], 3, -1)),
                               (f"{wnids[2]}_png.JPEG", encode_png(png),
                                png)):
        (root / "train" / name).write_bytes(blob)
        sources[name] = (wnids.index(name.split("_")[0]) + 1,
                         *pixels.shape[:2])
        odd[name] = pixels
    for name in sorted(os.listdir(root / "train"))[:16]:
        syn = name.split("_")[0]
        (root / "bbox" / syn).mkdir(parents=True, exist_ok=True)
        _, h, w = sources[name]
        (root / "bbox" / syn / f"{Path(name).stem}.xml").write_text(
            f"<annotation><filename>{Path(name).stem}</filename><size>"
            f"<width>{w}</width><height>{h}</height></size><object>"
            f"<bndbox><xmin>10</xmin><ymin>20</ymin><xmax>{w - 30}</xmax>"
            f"<ymax>{h - 9}</ymax></bndbox></object></annotation>")
    voc = root / "voc"
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (voc / sub).mkdir(parents=True)
    mpii, anns = root / "mpii", []
    mpii.mkdir()
    imgs = _nv_jpegs([synthetic_image(rng, 240, 320, i, dev)
                      for i in range(2 * OFFLINE_SMALL)])
    names = [f"{i:06d}" for i in range(OFFLINE_SMALL)]
    for i, name in enumerate(names):
        (voc / "JPEGImages" / f"{name}.jpg").write_bytes(imgs[i])
        (voc / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><filename>{name}.jpg</filename><size><width>320"
            "</width><height>240</height></size><object><name>dog</name>"
            f"<bndbox><xmin>{10 + i}</xmin><ymin>20</ymin><xmax>200</xmax>"
            "<ymax>230</ymax></bndbox></object></annotation>")
        (mpii / f"p{i}.jpg").write_bytes(imgs[OFFLINE_SMALL + i])
        anns.append({"image": f"p{i}.jpg", "center": [160.0, 120.0],
                     "scale": 1.5,
                     "joints": [{"id": j, "x": 20.0 + 15 * j + i,
                                 "y": 30.0 + 10 * j, "visible": 1}
                                for j in range(16)]})
    (voc / "ImageSets/Main/train.txt").write_text("\n".join(names) + "\n")
    (root / "mpii.json").write_text(json.dumps(anns))
    return {"sources": sources, "odd": odd, "wnids": wnids}



def _records(d: Path, prefix: str) -> list:
    from deepvision_tpu_torch.data.tfrecord import read_records

    files = sorted(d.glob(f"{prefix}-*"))
    assert files, (d, prefix)
    return [rec for f in files for rec in read_records(f)]


def _check_imagenet_records(d: Path, split: str, trees: dict) -> int:
    """Every record of ``split`` read back by the port's reader: label,
    size and file name those of its source file, an RGB JPEG that nvJPEG
    decodes at that size (the whole split one batch), the bbox CSV's
    boxes on its 16 train files; the grayscale and PNG files within
    ``REENCODE_MEAN_LSB`` of their pixels. Returns the records read."""
    import torch

    from deepvision_tpu_torch.data.image_io import jpeg_header
    from deepvision_tpu_torch.data.jpeg import decode_images, pack
    from deepvision_tpu_torch.data.tfrecord import decode_example

    feats = [decode_example(r) for r in _records(d, split)]
    blobs = [f["image/encoded"][0] for f in feats]
    images = decode_images(*pack(blobs), torch.device("cuda"))
    boxed = sum("image/object/bbox/xmin" in f for f in feats)
    assert boxed == (16 if split == "train" else 0), (split, boxed)
    for f, blob, image in zip(feats, blobs, images):
        name = f["image/filename"][0].decode()
        label, h, w = trees["sources"][name]
        assert f["image/class/label"][0] == label, name
        assert (f["image/height"][0], f["image/width"][0]) == (h, w), name
        assert jpeg_header(blob)["components"] == 3, name
        assert tuple(image.shape) == (h, w, 3), (name, image.shape)
        if name in trees["odd"]:
            gap = (image.int() - torch.from_numpy(trees["odd"][name])
                   .to(image.device).int()).abs().float()
            _say(f"[builders] {name}: re-encoded to an RGB JPEG by nvJPEG, "
                 f"decoded {gap.mean().item():.3f} steps off its source on "
                 f"average (max {gap.max().item():.0f})")
            assert gap.mean().item() <= REENCODE_MEAN_LSB, name
    return len(feats)


def _timed_build(fn, *args, **kwargs) -> tuple[int, float]:
    """A builder's call -> (records written, its seconds)."""
    t0 = time.perf_counter()
    n = fn(*args, **kwargs)
    return n, time.perf_counter() - t0


def phase_builders(smi: str, workdir: Path) -> dict:
    """The dataset builders on this machine, which has no PIL or
    TensorFlow (alone on the machine, for their rates): the trees of
    :func:`_offline_trees`, the bbox CSV, the ImageNet train shards, the
    bbox CSV's boxes and the two odd files among them, by this process
    (the odd files re-encoded at quality 95 by the nvJPEG encoder that
    encoded the trees at 90), and the validation shards (every file an
    RGB JPEG whose bytes are kept) by a spawned pool of 2; records/s of
    each; then both splits read back (:func:`_check_imagenet_records`,
    batches of 258 and 192 on the decoder). Returns the trees, the
    records' directory and the rates (:func:`phase_builder_shards` builds
    the rest)."""
    from deepvision_tpu_torch.data.builders import imagenet, imagenet_bbox

    root = workdir / "offline"
    t0 = time.perf_counter()
    trees = _offline_trees(root)
    n_train = OFFLINE_TRAIN + 2
    _say(f"[builders] trees of {n_train} + {OFFLINE_VAL} ImageNet files, "
         f"{OFFLINE_SMALL} VOC and MPII images encoded on the card in "
         f"{time.perf_counter() - t0:.1f} s")
    synsets, rec = root / "synsets.txt", root / "records"
    assert imagenet_bbox.process_bounding_boxes(root / "bbox",
                                                root / "bbox.csv") == 16
    rates = {}
    for split, tree, workers, n_want in (("train", "train", 1, n_train),
                                         ("validation", "val", 2,
                                          OFFLINE_VAL)):
        n, secs = _timed_build(
            imagenet.build_imagenet_tfrecords, root / tree, synsets, rec,
            split, bbox_csv=root / "bbox.csv", num_shards=4,
            num_workers=workers)
        assert n == n_want, (split, n)
        rates[f"imagenet_{split}_records_s_{workers}_worker"] = n / secs
        _say(f"[builders] ImageNet {split}: {n} records, {workers} "
             f"worker(s), {secs:.3f} s, {n / secs:.1f} records/s ({smi})")
    read = {s: _check_imagenet_records(rec, s, trees)
            for s in ("train", "validation")}
    assert read == {"train": n_train, "validation": OFFLINE_VAL}, read
    return {"root": root, "trees": trees, "dir": rec, "rates": rates}


def phase_builder_shards(built: dict) -> None:
    """The rest of the builders (run beside the training CLIs; no rate is
    read): the VOC, MPII and raw-crop builds at once, each by a spawned
    pool of 2 (the raw crops decoded and resized on the card in the
    workers), then every record read back by the port's readers with its
    label and size."""
    from concurrent.futures import ThreadPoolExecutor

    from deepvision_tpu_torch.data.builders import (
        detection,
        pose,
        raw_crops,
    )
    from deepvision_tpu_torch.data.detection import parse_detection_record
    from deepvision_tpu_torch.data.imagenet import parse_raw_crop
    from deepvision_tpu_torch.data.pose import parse_pose_record

    root, trees, rec = built["root"], built["trees"], built["dir"]
    n_train = OFFLINE_TRAIN + 2
    pool2 = {"num_shards": 2, "num_workers": 2}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = {
            "raw": pool.submit(_timed_build, raw_crops.build_raw_crops, rec,
                               root / "raw", stored=OFFLINE_STORED, **pool2),
            "voc": pool.submit(_timed_build, detection.build_voc_tfrecords,
                               root / "voc", root / "voc_rec", **pool2),
            "mpii": pool.submit(_timed_build, pose.build_mpii_tfrecords,
                                root / "mpii", root / "mpii.json",
                                root / "mpii_rec", **pool2)}
        counts = {k: f.result()[0] for k, f in builds.items()}
    assert counts == {"raw": n_train, "voc": OFFLINE_SMALL,
                      "mpii": OFFLINE_SMALL}, counts
    n_raw = counts["raw"]
    _say(f"[builders] VOC, MPII and raw-crop shards (nvJPEG decode and "
         f"resize on the card) at once, each by 2 spawned workers: "
         f"{counts} in {time.perf_counter() - t0:.2f} s")
    labels = {}
    for r in _records(root / "raw", "raw-train"):
        frame, label = parse_raw_crop(r)
        assert min(frame.shape[:2]) == OFFLINE_STORED, frame.shape
        labels[label] = labels.get(label, 0) + 1
    want = {}
    for name, (label, _, _) in trees["sources"].items():
        if "_val" not in name:
            want[label - 1] = want.get(label - 1, 0) + 1
    assert labels == want, (labels, want)
    for r in _records(root / "voc_rec", "train"):
        _, boxes, cls = parse_detection_record(r)
        assert cls.tolist() == [11] and boxes.shape == (1, 4), (cls, boxes)
        assert abs(boxes[0, 2] - 200 / 320) < 1e-6, boxes
    for r in _records(root / "mpii_rec", "train"):
        _, kx, ky, v, scale = parse_pose_record(r)
        assert len(kx) == 16 and v.tolist() == [1] * 16 and scale == 1.5
        assert abs(ky[0] - 30 / 240) < 1e-6, ky
    _say(f"[builders] read back by the port's readers: {n_train} train and "
         f"{OFFLINE_VAL} validation records, {n_raw} raw crops (shorter side {OFFLINE_STORED}), "
         f"{OFFLINE_SMALL} VOC and {OFFLINE_SMALL} MPII records; no file "
         "skipped")


def phase_eval_classification(smi: str, d: Path, workdir: Path) -> dict:
    """``python -m deepvision_tpu_torch.eval classification`` for
    ``resnet50`` at 224 and batch 64, float32 with TF32 off, over the
    built validation shards (decoded by nvJPEG), on seeded weights saved
    as a port checkpoint; its top-1 and top-5 must equal a direct loop of
    ``classification_eval_step`` over the same batches. Returns the
    seconds of both."""
    import torch

    from deepvision_tpu_torch.convert.__main__ import save_as_checkpoint
    from deepvision_tpu_torch.data.imagenet import val_batches
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.serve.models import restore_state
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_eval_step

    dev = torch.device("cuda")
    wd = workdir / "eval_classification"
    module = create_model("resnet50", device=dev, seed=0)
    save_as_checkpoint(module.state_dict(), "resnet50", str(wd),
                       num_classes=1000, input_size=224, device=dev)
    t0 = time.perf_counter()
    proc = _cli("deepvision_tpu_torch.eval",
                ["classification", "-m", "resnet50", "--workdir",
                 str(wd / "resnet50"), "--data-dir", str(d), "--batch-size",
                 str(EVAL_BATCH)])
    cli_s = time.perf_counter() - t0
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    module, _ = restore_state("resnet50", str(wd / "resnet50"), device=dev)
    state = TrainState(module, None)
    sums = dict.fromkeys(("loss_sum", "count", "top1", "top5"), 0.0)
    t0 = time.perf_counter()
    feed = DevicePrefetcher(val_batches(sorted(d.glob("validation-*")),
                                        EVAL_BATCH, 224, augment="pt"), dev)
    for batch in feed:
        with torch.inference_mode():
            out = classification_eval_step(state, batch, "torch")
        for k in sums:
            sums[k] += float(out[k])
    feed.close()
    loop_s = time.perf_counter() - t0
    n = sums["count"]
    assert line["images"] == int(n) == OFFLINE_VAL, (line, n)
    for k in ("top1", "top5"):
        assert line[f"val_{k}"] == round(sums[k] / n, 4), (k, line, sums)
    loss = sums["loss_sum"] / n  # printed to 4 decimals; float32 sums
    assert abs(line["val_loss"] - loss) <= 1e-4 * max(1.0, abs(loss)), (
        line, sums)
    _say(f"[eval-classification] resnet50 at 224, batch {EVAL_BATCH}, "
         f"float32: {json.dumps(line)}; the CLI {cli_s:.1f} s (process, "
         f"restore, {OFFLINE_VAL} images), the direct loop of "
         f"classification_eval_step {loop_s:.2f} s; equal ({smi})")
    shutil.rmtree(wd, ignore_errors=True)
    return {"line": line, "cli_s": cli_s, "loop_s": loop_s}


def _predict_images(workdir: Path) -> dict:
    """The predict CLIs' inputs: a JPEG encoded by nvJPEG (decoded by
    nvJPEG again, ``ycc_to_rgb`` launched) and a PNG written by the
    port's PNG writer (read by its PNG reader)."""
    import torch

    from deepvision_tpu_torch.data.image_io import encode_png
    from deepvision_tpu_torch.data.synthetic_records import synthetic_image

    d = workdir / "predict_inputs"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(41)
    dev = torch.device("cuda")
    (d / "photo.jpg").write_bytes(
        _nv_jpegs([synthetic_image(rng, 300, 260, 3, dev)])[0])
    (d / "photo.png").write_bytes(
        encode_png(synthetic_image(rng, 280, 310, 4, dev).cpu().numpy()))
    return {"jpeg": str(d / "photo.jpg"), "png": str(d / "photo.png")}


def _predict(args: list[str], out: Path) -> tuple[object, dict]:
    """``python -m deepvision_tpu_torch.predict <args> --json out`` ->
    (its answers, the kernel launches it counted)."""
    proc = _cli("deepvision_tpu_torch.predict", [*args, "--json", str(out)])
    return json.loads(out.read_text()), _cli_launches(proc.stderr)


def _same_topk(got: dict, want: dict, label: str) -> None:
    assert got["classes"] == want["classes"], (label, got, want)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=PREDICT_TOL,
                               err_msg=label)


def _predict_served(name: str, wd: Path, image: str, args: list[str],
                    scale: str, size: int, **load_kw) -> dict:
    """The predict CLI's answer for ``name`` from ``wd``'s checkpoint and
    ``load_served(...).run`` on the same decoded tensor in this process
    (``predict.load_image`` on the card). Returns both and the CLI's
    launches."""
    import torch

    from deepvision_tpu_torch import predict
    from deepvision_tpu_torch.serve.models import load_served

    got, launches = _predict(args, wd / f"{name}_predict.json")
    served = load_served(name, str(wd), device=torch.device("cuda"),
                         **load_kw)
    with CARD_COUNTS:  # its kernels are no path's (phase_pipeline)
        x = predict.load_image(image, size, scale=scale, device="cuda")
        want = served.postprocess(served.run(x), 0)
    return {"got": got, "want": want, "launches": launches}


def _reference_nets():
    """``tests/torch_reference_nets.py``, loaded from its file (a
    ``tests`` package installed on the machine would shadow the
    checkout's)."""
    import importlib.util

    path = ROOT / "tests" / "torch_reference_nets.py"
    spec = importlib.util.spec_from_file_location("torch_reference_nets",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _converted(name: str, workdir: Path, image: str, offer=None) -> dict:
    """A seeded reference-layout ``name`` (``tests/torch_reference_nets``,
    BN statistics away from 0 and 1) saved with ``torch.save``, converted
    by ``python -m deepvision_tpu_torch.convert`` (on the card, the
    default), then ``predict classify`` on its checkpoint: its top-5
    equal the source module's on the card, the probabilities within
    ``PREDICT_TOL``; the converted module's logits (``load_served``)
    within ``PREDICT_TOL`` of the source's. With ``offer``, then
    ``predict export`` of the checkpoint (:func:`_predict_export`), and
    both offered to a serving CLI. Returns the CLI's launches."""
    import torch

    from deepvision_tpu_torch import predict
    from deepvision_tpu_torch.serve.models import input_scale, load_served

    nets = _reference_nets()
    dev = torch.device("cuda")
    wd = workdir / "converted"
    wd.mkdir(parents=True, exist_ok=True)
    torch.manual_seed(0)
    source = (nets.TorchResNet50(1000) if name == "resnet50"
              else nets.TorchInceptionV1(1000))
    g = torch.Generator().manual_seed(1)
    for mod in source.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.normal_(0, 0.05, generator=g)
            mod.running_var.uniform_(0.8, 1.2, generator=g)
    pt = wd / f"{name}.pt"
    torch.save({"epoch": 0, "model": source.state_dict()}, pt)
    t0 = time.perf_counter()
    _cli("deepvision_tpu_torch.convert", [str(pt), "-m", name, "-o",
                                          str(wd)])
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, launches = _predict(["classify", "-m", name, "--workdir",
                              str(wd / name), image], wd / f"{name}.json")
    predict_s = time.perf_counter() - t0
    x = predict.load_image(image, 224, scale=input_scale(name), device=dev)
    source = source.to(dev).eval()
    served = load_served(name, str(wd / name), device=dev)
    with torch.inference_mode(), CARD_COUNTS:  # no path's (phase_pipeline)
        xs = torch.from_numpy(x).to(dev)
        want_logits = source(xs.permute(0, 3, 1, 2)).float()
        got_logits = served.module(xs).float()
    gap = (got_logits - want_logits).abs().max().item()
    probs = torch.softmax(want_logits, -1)[0].cpu()
    top = torch.argsort(-probs, stable=True)[:5]
    _same_topk(got[0], {"classes": top.tolist(),
                        "probs": probs[top].tolist()}, name)
    assert gap <= PREDICT_TOL, (name, gap)
    _say(f"[convert] {name}: reference .pt -> port checkpoint in "
         f"{convert_s:.1f} s; predict classify's top-5 {top.tolist()} equal "
         f"the source module's on the card, logits {gap:.2e} apart; "
         f"launches {launches}")
    out = {"launches": launches, "convert_s": convert_s,
           "predict_s": predict_s}
    if offer is None:
        shutil.rmtree(wd / name, ignore_errors=True)
        return out
    out["export"] = _predict_export(name, wd)
    xs = (np.random.default_rng(2).normal(0, 1, (2, 224, 224, 3))
          .astype(np.float32))
    offer(_Offer(name, wd / name, xs, _lrn_top5_served,
                 artifact=out["export"]["path"]))
    return out


def _predict_export(name: str, wd: Path) -> dict:
    """``python -m deepvision_tpu_torch.predict export -m name --workdir
    wd/name -o wd/name.pt2`` through its entry point in this process (no
    process of its own: the phases' processes already fill the host): its
    line names the artifact and its megabytes, and the file loads with a
    batch-1 float32 input and 2 ``deepvision.lrn_forward`` nodes for
    ``inception1_ref``. Returns its path, megabytes and seconds."""
    import contextlib
    import io

    import torch

    from deepvision_tpu_torch import predict
    from deepvision_tpu_torch.export import graph_ops, load_exported

    path = wd / f"{name}.pt2"
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        predict.main(["export", "-m", name, "--workdir", str(wd / name),
                      "-o", str(path)])
    export_s = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    mb = path.stat().st_size / 1e6
    assert f"exported {mb:.1f} MB torch.export artifact to {path}" in (
        out.getvalue()), out.getvalue()
    program = load_exported(path)
    assert [(tuple(a.shape), a.dtype) for a in program.in_avals] == [
        ((1, 224, 224, 3), torch.float32)], program.in_avals
    ops = graph_ops(program)
    assert ops.get("deepvision.lrn_forward.default") == 2, ops
    _say(f"[export-cli] predict export -m {name}: {mb:.1f} MB in "
         f"{export_s:.1f} s; 2 deepvision.lrn_forward nodes")
    return {"path": path, "mb": mb, "s": export_s}


def phase_converters(smi: str, workdir: Path, images: dict,
                     offer) -> dict:
    """:func:`_converted` for ``resnet50`` and ``inception1_ref`` (whose
    stem LRNs launch ``lrn_forward_f32``) at once; ``inception1_ref``'s
    checkpoint and its ``predict export`` artifact offered to a serving
    CLI through ``offer``. Returns each one's predict launches and
    seconds."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        runs = {name: pool.submit(
            _converted, name, workdir, images["jpeg"],
            offer if name == "inception1_ref" else None)
            for name in ("resnet50", "inception1_ref")}
        out = {name: run.result() for name, run in runs.items()}
    launches = {name: r["launches"] for name, r in out.items()}
    assert launches["inception1_ref"]["lrn_forward_f32"] == 2, launches
    assert launches["resnet50"]["lrn_forward_f32"] == 0, launches
    assert all(n["ycc_to_rgb"] == 1 for n in launches.values()), launches
    return out


# the predict CLIs appended to the model CLI chains: their kernel
# launches and seconds, by chain
PREDICT_RUNS: dict[str, dict] = {}
# each engine-served model's CUDA graph report (:func:`_graph_report`)
GRAPHS: dict[str, dict] = {}


def _record_predict(label: str, launches: dict, seconds: float) -> None:
    PREDICT_RUNS[label] = {"launches": launches, "s": seconds}


def _timed(label: str, phase, *args, **kwargs):
    """``phase(*args, **kwargs)``, with the seconds it took printed."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    _say(f"[phase] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import deepvision_tpu_torch  # noqa: F401  (fails outside the checkout)
    from deepvision_tpu_torch.ops.lrn_cuda import BACKWARD_KERNEL_NAMES

    t_start = time.perf_counter()
    workdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    smi = _timed("card", phase_card)
    _timed("probe", phase_probe)
    libs = _timed("build", phase_build)
    errs = _timed("parity", phase_parity)
    times = _timed("times", phase_times)
    crc = _timed("crc", phase_crc, workdir)
    jpeg = _timed("nvjpeg", phase_nvjpeg)
    from concurrent.futures import ThreadPoolExecutor

    # the offline tools' timed builders alone (their records/s); the other
    # builds, the predict inputs and the offline phases come later
    t_offline = time.perf_counter()
    built = _timed("builders", phase_builders, smi, workdir)
    images = _predict_images(workdir)
    offline_s = time.perf_counter() - t_offline
    # each main path's LRN launches, counted from 0 just before it
    paths = {}
    paths["serve_f32"], results, xs, GRAPHS["alexnet1"] = _timed(
        "alexnet1 serve", phase_serve, smi, eager=True)
    # two of the requests and the engine's bucket-1 answers, for the HTTP
    # server's (phase_http)
    alexnet_http = (xs[35:37], list(GRAPHS["alexnet1"].pop("bucket1")
                                    .values()))
    paths["train_step_f32"] = _timed("alexnet1 train step",
                                     phase_train_step)
    paths["trainer_bf16"], trainer = _timed("alexnet1 trainer",
                                            phase_trainer, workdir / "inproc")
    _timed("alexnet1 throughput", phase_throughput, trainer,
           steps=EARLIER_TIMED_STEPS)
    trainer = None
    # Inception V1: the reference's BN-free variant, whose stem LRNs
    # (n=64, n=192) run on the kernels, then the BN variant
    paths["inception1_ref_serve_f32"], _, _, GRAPHS["inception1_ref"] = \
        _timed("inception1_ref serve", phase_serve, smi, "inception1_ref")
    GRAPHS["inception1_ref"].pop("bucket1")
    paths["inception1_ref_train_step_f32"] = _timed(
        "inception1_ref train step", phase_train_step, "inception1_ref")
    paths["inception1_ref_trainer_bf16"], trainer = _timed(
        "inception1_ref trainer", phase_trainer,
        workdir / "inproc_inception1_ref", "inception1_ref")
    _timed("inception1_ref throughput", phase_throughput, trainer,
           "inception1_ref", steps=EARLIER_TIMED_STEPS)
    paths["inception1_trainer_bf16"], trainer = _timed(
        "inception1 trainer", phase_trainer, workdir / "inproc_inception1",
        "inception1", lrns=0)
    _timed("inception1 throughput", phase_throughput, trainer, "inception1",
           steps=EARLIER_TIMED_STEPS)
    trainer = None
    torch.cuda.empty_cache()
    phase_resnets(smi, workdir)
    torch.cuda.empty_cache()
    records = _timed("records", phase_records, smi, workdir)
    torch.cuda.empty_cache()
    _say(f"[memory] before the training-CLI block this process holds "
         f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, "
         f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; the "
         f"card {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free")
    # the record CLIs, the other builds and eval classification beside the
    # training CLIs: all only wait on their own processes (no rate is read)
    with ThreadPoolExecutor(2) as pool:
        record_clis = pool.submit(_timed, "record CLIs", _records_clis,
                                  records["dir"], workdir)
        evaluation = pool.submit(
            lambda: (_timed("builder shards", phase_builder_shards, built),
                     _timed("eval classification",
                            phase_eval_classification, smi, built["dir"],
                            workdir))[1])
        _timed("train CLIs", phase_train_clis, workdir / "cli", {
            "alexnet1": 2, "inception1_ref": 2, "inception1": 0,
            "resnet50": 0}, (results, xs))
        records["ycc_launches"] = record_clis.result()
        evaluation = evaluation.result()
    results = xs = None
    _timed("resnet152", phase_resnet152, smi, workdir)
    torch.cuda.empty_cache()

    yolo = phase_yolo(smi, workdir)
    torch.cuda.empty_cache()
    export = _timed("export", phase_export, smi, workdir)
    hourglass = {"centernet": phase_centernet(smi, workdir),
                 "pose": phase_pose(smi, workdir)}
    gan = phase_gan(smi, workdir)
    classifiers = phase_classifiers(smi, workdir)

    # the resilience drills and the converters beside the model CLI chains:
    # all only wait on their own processes, and none of their numbers is a
    # rate
    from concurrent.futures import Future

    # the converted inception1_ref and its predict-export artifact, for
    # CenterNet's serving CLI
    artifact = Future()
    with ThreadPoolExecutor(5) as pool:
        drills = pool.submit(_timed, "resilience", phase_resilience, smi,
                             workdir, records["dir"])
        converted = pool.submit(_chain, artifact, "converters",
                                phase_converters, smi, workdir, images)
        # the HTTP server and the fleet over the same requests, each on a
        # worker of its own, so that both end before the model CLI chains
        served_http = (*alexnet_http, _yolo_requests()[:2],
                       yolo.pop("answers")[-4:-2])
        # the CLI's swap drill after it, on the same worker
        http = pool.submit(lambda: (
            _timed("HTTP server", phase_http, workdir, *served_http),
            _timed("tenancy CLI", phase_tenancy_cli, workdir)))
        fleet = pool.submit(_timed, "fleet", phase_fleet, workdir,
                            *served_http)
        # in process, on a worker of its own: its launches are counted in
        # a window that the other workers' in-process kernels wait out
        # (CARD_COUNTS); then the tenancy drill in process, likewise
        pipeline = pool.submit(lambda: (
            _timed("pipelines", phase_pipeline, smi),
            _timed("tenancy", phase_tenancy, smi)))
        served = _timed("model CLIs", phase_model_clis, workdir, yolo,
                        hourglass["centernet"], hourglass["pose"], gan,
                        images, artifact)
        resilience = drills.result()
        converted = converted.result()
        http, tenancy_cli = http.result()
        fleet = fleet.result()
        pipeline, tenancy = pipeline.result()
    paths["export_alexnet1_f32"] = {
        **dict.fromkeys(times, 0),
        "lrn_forward_f32": export["alexnet1"].pop("lrn_launches")}
    yolo["nms_launches"]["export_store"] = export["yolov3_store"].pop(
        "nms_launches")
    paths["serve_cli_artifact_f32"] = {
        **dict.fromkeys(times, 0),
        "lrn_forward_f32": served["inception1_ref" + ARTIFACT_SUFFIX]}
    cli_export = converted["inception1_ref"].pop("export")
    export["predict_export_cli"] = {"mb": cli_export["mb"],
                                    "s": cli_export["s"]}
    paths["http_server_f32"] = {
        **dict.fromkeys(times, 0),
        "lrn_forward_f32": http["launches"]["lrn_forward_f32"]}
    yolo["nms_launches"]["http_server"] = http["launches"]["nms_sweep"]
    # the fleet's surviving and respawned replicas, from their own /stats
    # (the stream drill's detect replays among the NMS launches)
    paths["fleet_f32"] = {
        **dict.fromkeys(times, 0),
        "lrn_forward_f32": fleet["launches"]["lrn_forward_f32"]}
    yolo["nms_launches"]["fleet"] = fleet["launches"]["nms_sweep"]
    # the stream drill's in-process yardstick, counted from 0 after its
    # warm-up: 1 a detect+update replay, none an advance replay
    yolo["nms_launches"]["fleet_stream_yardstick"] = fleet.pop(
        "stream_reference_nms")
    # the DAGs' graph replays in process (phase_pipeline)
    paths["pipeline_f32"] = {
        **dict.fromkeys(times, 0),
        "lrn_forward_f32": pipeline["launches"]["lrn_forward_f32"]}
    yolo["nms_launches"]["pipeline_f32"] = pipeline["launches"]["nms_sweep"]
    # the tenancy drill's counted window in process (phase_tenancy: the
    # passes, recaptures' eager forwards, the DAG, the swap under load) and
    # the CLI drill's process, from its last line
    paths["tenancy_f32"] = {
        **dict.fromkeys(times, 0),
        "lrn_forward_f32": tenancy["launches"].get("lrn_forward_f32", 0)
        + tenancy_cli["launches"]["lrn_forward_f32"]}
    yolo["nms_launches"]["tenancy"] = (tenancy["launches"]["nms_sweep"]
                                       + tenancy_cli["launches"]["nms_sweep"])
    paths["chaos_cli_bf16"] = resilience["launches"]
    for name, run in converted.items():
        paths[f"predict_converted_{name}_f32"] = run.pop("launches")
    offline = {"builders_records_s": built["rates"],
               "builders_s": offline_s,
               "eval_classification_s": {
                   k: evaluation[k] for k in ("cli_s", "loop_s")},
               "converters_s": converted,
               "predict_in_chains_s": {k: v["s"]
                                       for k, v in PREDICT_RUNS.items()}}
    loader = _timed("loader", phase_loader, smi, workdir, records["dir"])
    shutil.rmtree(workdir, ignore_errors=True)

    kernels = []
    for name, t in times.items():
        backward = name in BACKWARD_KERNEL_NAMES.values()
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        assert by_path, f"{name} was launched on no main path"
        kernels.append({
            "name": name, "route": "cuda",
            "source": LRN_BWD_SOURCE if backward else LRN_SOURCE,
            "replaces": LRN_BWD_REPLACES if backward else LRN_REPLACES,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            # a served model's CUDA graph launches this many a replay
            "launches_per_replay": {
                m: g["launches_per_replay"][str(BUCKETS[-1])][name]
                for m, g in GRAPHS.items()
                if name in g["launches_per_replay"][str(BUCKETS[-1])]},
            # a DAG's graph by entry bucket (phase_pipeline)
            "pipeline_launches_per_replay": {
                f"{dag}@{b}": per[name]
                for dag, by in pipeline["launches_per_replay"].items()
                for b, per in by.items() if name in per},
            # times: cold, summed over AlexNet V1's two LRNs at batch 128
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "ms_warm": t["ms_warm"], "shapes": t["shapes"],
        })
    # the JPEG path's colour kernel, launched by the record CLIs, each
    # counting from 0 in its own process (it stands for no TPU kernel)
    by_path = {**records["ycc_launches"],
               "chaos_cli": resilience["launches"]["ycc_to_rgb"],
               **{f"predict_{k}": v["launches"]["ycc_to_rgb"]
                  for k, v in PREDICT_RUNS.items()
                  if v["launches"]["ycc_to_rgb"]},
               **{f"predict_converted_{k}": paths[
                   f"predict_converted_{k}_f32"]["ycc_to_rgb"]
                  for k in converted}}
    kernels.append({**jpeg["kernel"], "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "note": "not a TPU kernel: the chroma upsampling and "
                            "colour conversion of tf.io.decode_jpeg"})
    # the YOLO post-process's NMS sweep (it stands for no TPU kernel)
    by_path = yolo["nms_launches"]
    kernels.append({**yolo["nms"], "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "launches_per_replay": {"yolov3": GRAPHS["yolov3"][
                        "launches_per_replay"][str(BUCKETS[-1])][
                        "nms_sweep"]},
                    "pipeline_launches_per_replay": {
                        f"{dag}@{b}": per["nms_sweep"]
                        for dag, by in pipeline[
                            "launches_per_replay"].items()
                        for b, per in by.items()},
                    # a tracking stream's two graphs at bucket 1
                    # (phase_fleet's yardstick)
                    "stream_launches_per_replay": {
                        prog: per.get("nms_sweep", 0)
                        for prog, per in fleet["streams"]["reference"][
                            "launches_per_replay"].items()},
                    "note": "not a TPU kernel: the greedy fori_loop of the "
                            "JAX nms_indices (stock XLA)"})
    native = {
        "nms": {"source": NMS_SOURCE, "library": libs[NMS_SOURCE]},
        "crc32c": {"source": CRC_SOURCE, "library": libs[CRC_SOURCE],
                   **{k: round(v, 1) for k, v in crc.items()}},
        "nvjpeg": {"source": NVJPEG_SOURCE, "library": libs[NVJPEG_SOURCE],
                   **{k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in jpeg.items() if k != "kernel"}},
        "reader_records_s": {k: round(v, 1)
                             for k, v in records["reader"].items()},
        "fed_vs_resident_images_s": {
            k: [round(v["fed"], 1), round(v["resident"], 1)]
            for k, v in records["runs"].items()}}
    _say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"[native] {json.dumps(native)}")
    print(f"[yolo] {json.dumps(yolo['summary'])}")
    for name, summary in hourglass.items():
        print(f"[{name}] {json.dumps(summary)}")
    print(f"[gan] {json.dumps(gan)}")
    print(f"[classifiers] {json.dumps(classifiers)}")
    print(f"[resilience] {json.dumps(resilience['summary'])}")
    print(f"[loader] {json.dumps(loader)}")
    print(f"[offline] {json.dumps(offline)}")
    # the fleet's readings hold the stream drill's ("streams"): migrations,
    # the second respawn's seconds, the yardstick's device ms of a detect
    # and of an interpolated frame at bucket 1
    print(f"[graphs] {json.dumps({**GRAPHS, 'http': http, 'fleet': fleet})}")
    print(f"[pipeline] {json.dumps({**pipeline, 'card': smi})}")
    tenancy.update(cli=tenancy_cli, card=smi)
    print(f"[tenancy] {json.dumps(tenancy)}")
    print(f"[export] {json.dumps({**export, 'card': smi})}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
