#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each:

1. env     the card (``nvidia-smi``), torch and CUDA versions; TF32 pinned off.
2. build   every kernel of the port built from ``ops/csrc`` with ``nvcc``,
           one compiler process per source, all started together.
3. kernel  each kernel against its plain PyTorch version on the card, at the
           shapes the main paths give it and at edge shapes (flash: GQA,
           ragged non-causal at head dim 64, causal ragged, q/k/v as strided
           views of one packed tensor, f32, and Llama-3-8B's B 1, S 8192,
           32/8 heads; each bf16 row of out within ``BF16_ROW_ULPS`` ulps of
           its largest value as well; fused dense: ragged with 16-byte
           rows, ragged with odd rows; in f32 the ResNet head, split across a
           thread-block cluster, BERT's mlp_in without a split, both on the
           bf16 tensor cores with x and w in three parts each (bound by six
           bf16 passes; the f32 CUDA-core bound beside it), the head's output
           checked bitwise equal over two calls, and a ragged shape on the
           CUDA cores; int8-weight
           dense: BERT's mlp_in with a bf16 and with an f32 x on the bf16
           tensor cores, ragged M and K with 16-byte rows, and a ragged shape
           on the CUDA cores; bound by the design's arithmetic, one bf16
           pass for a bf16 x and three for an f32 x), with the variant
           the launcher reported for the row's launch, its time beside the
           plain version's, the PyTorch library call that computes the same
           function (timed here only as a yardstick; the port never calls
           it) and the bound.  ``kernel_ms``, ``plain_ms`` and ``library_ms``
           are CUDA-event times a call, the host's share included;
           ``device_ms`` and ``library_device_ms`` are the device time alone
           (``torch.profiler``), ``host_ms`` and ``library_host_ms`` the
           host's time to issue one call.
           Then the flash crossover: the kernel against the materialised-
           score attention the model takes below ``FLASH_CROSSOVER_SEQ``, at
           the m435 heads and sequence lengths 512 to 4096 with the tokens
           per call held equal, forward alone and forward plus backward.
4. grad    autograd through ``FlashAttention`` and ``FusedDenseFunction``
           (kernel forward + torch backward) against autograd through the
           plain references.
5. slice   the Llama path: ``examples.llama_train.main`` at the m435
           shape, seq 2048, batch 8, six adamw steps; the launch counters
           are zeroed just before and read just after, and every kernel of
           the path must have launched, each launch in the wgmma variant.  Then one forward with the kernel
           against one with the plain flash forward, on the same weights.
6. learn   six steps on one repeated batch at the same shape must lower the
           loss (the main path's synthetic tokens are uniform over the vocab,
           so its loss starts at the entropy floor and cannot fall); the last
           two steps are profiled by kernel.
6b. moe    ``examples.llama_train.main`` at m435, seq 2048, batch 8, with
           ``--experts 8`` (top-2, capacity factor 1.25, aux weight 0.01),
           six adamw steps: the losses finite, ``moe_aux_loss`` reported, flash
           launched in its wgmma variant as often a step as in ``slice``; step
           time, tokens/s, MFU on the active parameters, peak memory.  Then
           one f32 forward of the MoE model with the kernel (its f32 variant)
           against one with the plain flash forward, on the same weights
           (the logits' largest and mean error gated); one bf16 forward at
           the step's shape, every layer's kernel output (wgmma variant)
           against the plain flash forward on the same q, k, v; two steps
           profiled.
6c. adafactor  ``llama_train.main --size 3b --optimizer adafactor``, seq
           2048, batch 4, four steps: losses finite, flash 2 a block and step;
           the optimizer state's bytes (reckoned) beside AdamW's.
6d. mesh   a one-rank NCCL process group; the m435 step with
           ``strategy="fsdp"`` over ``build_mesh(MeshSpec(fsdp=1))`` (FSDP2:
           every parameter the specs shard a DTensor; the model's tp and sp
           collectives built from the mesh at size 1) for four steps on one
           repeated batch (a loss that falls), against the same steps without
           a mesh: losses and final parameters, beside the numbers a planted
           run that never updates would give, which the limits must catch.
6e. llama_captured  ``multi_step_fn(4)`` of the m435 AdamW step captured as
           one CUDA graph: its losses and final parameters against four eager
           steps from the same state on one repeated batch, held as in
           ``mesh``, then two replays timed, beside the eager step.
7. bert    the BERT path: ``examples.bert_pretrain.main`` at BERT-base, seq
           128, batch 32, ``--use_pallas_mlp``, forty adamw steps; the launch
           counters are zeroed just before and read just after, the
           fused-dense kernel must have launched 24 times a step, all in its
           wgmma variants (ping-pong at mlp_in, 128 x 192 at mlp_out), and
           the loss must fall.  The same run on the plain cuBLAS MLP beside it;
           one forward with the kernel against one with the plain fused
           dense, on the same weights; two steps of each path profiled by
           kernel.
8. serve   the serving path at Llama-3-8B's widths (``LlamaConfig.llama3_8b``),
           random weights drawn on the card from a seed.  In f32 at two
           layers: the ``ContinuousBatchingEngine``'s greedy tokens, one
           request admitted mid-flight, equal to ``generate``'s, and
           teacher-forced paged decode logits within 1e-4 of the forward.
           In bf16 at full depth: one decode step replayed from the engine's
           captured CUDA graph against the eager step on a copy of the pool
           (tokens and pool bytes equal), both timed (device time, events,
           the host's time) beside the step's bound (weights and resident
           K/V over the memory rate) and profiled by kernel; then 16
           requests in one burst on the wall clock through 8 slots, every
           completion its requested length, every page recycled, one
           capture, no kernel of the port launched (the path's attention is
           plain torch, as the JAX package's is plain XLA); decode tokens/s,
           TTFT and inter-token latency, prefill time, memory.
9. resnet  ResNet-50 training at bench.py's configuration: bf16, batch 128,
           224 x 224, uint8 images from a pool of 4 synthetic batches
           normalised in the step, label smoothing 0.1, Nesterov momentum at
           lr 0.1.  In f32, on one batch of one state, the kernel head's
           logits and head gradients against the plain fused dense's.  Then
           the example a user runs, ``examples.resnet_imagenet.main`` at
           ResNet-50, batch 128, 224 x 224, bf16, ``--use_pallas_head``, on
           its own f32 synthetic stream with two prefetch producers: 3 steps
           and one held-out eval batch, the launch counters zeroed just
           before and read just after (one split-K launch a step and one for
           the eval batch).  Then for each head (the f32 fused-dense kernel, and the plain cuBLAS
           product): 2 + 8 eager steps through ``Trainer.fit`` with two
           prefetch producers (the launch counters zeroed just before and
           read just after: the kernel head launches once a step, split-K),
           the loss finite and falling, step time, images/s, MFU (analytic
           FLOPs from ``FlopCounterMode`` over 989 TFLOP/s), memory, the
           pipeline's counters; two steps profiled by kernel;
           ``multi_step_fn(4)`` captured as one CUDA graph, its 4 losses
           against 4 eager steps from the same state, then 3 replays timed
           (a replay launches no wrapper, so the counters show the warm-up
           and the capture only); and ``evaluate`` on 2 held-out batches.

10. checkpoint  save and resume (``train/checkpoint.Checkpointer`` on
           ``torch.distributed.checkpoint``), checkpoints under a temporary
           directory removed at the end.  m435 (seq 2048, batch 8, AdamW,
           ``CKPT_LAYERS`` of its 24 layers: the full-depth save and
           restore, held bitwise, are ``live_reshard``'s fallback) on 8 synthetic
           batches: 8 steps straight; 4 steps, a
           synchronous save, then in a fresh trainer from another seed a
           restore (every tensor of the state bitwise the saved one: no
           weight moved on the way in) and the straight run's batches 5-8:
           losses and the whole final state bitwise the straight run's, the
           flash kernel launched 2 a block and step; a planted control (the
           model restored, the optimizer fresh) that must land past
           ``PARAM_GAP_MAX``.  The saving run goes on through ``fit`` with
           async saves every 2 steps (steps 7 and 8 update the state in
           place while step 6 is written): each checkpoint bitwise the
           parameters of its step, the losses the straight run's; bytes,
           save, staging, restore and write times, the steps' times with
           and without the saves.  ResNet-50 at the ``resnet`` phase's
           configuration, the kernel head, cuDNN deterministic: 2 + 2 steps
           across a restore bitwise 4 straight (losses, parameters, BatchNorm
           statistics, momentum traces), the f32 fused dense launched once a
           resumed step; ``multi_step_fn(2)`` captured on one state, a
           restore into it, a replay: equal to eager steps from the restored
           state.  Then ``examples.llama_train.main`` (m435) and
           ``examples.resnet_imagenet.main`` (ResNet-50, kernel head), each
           run twice with ``--checkpoint_dir``: the second resumes at the
           first's last step.
11. detection  RetinaNet-R50-FPN with the prototype-mask head at the JAX
           configuration's widths (ResNet-50, FPN 256, 80 classes, 9 anchors
           a cell, 16 prototypes), 256 px (12,276 anchors), max_boxes 10, on
           the synthetic detection stream.  ``detection_parity``: the f32
           forward on the card against the same weights on the CPU at batch
           2 (every BatchNorm's variables drawn at random), the largest and
           mean error of the class logits, box deltas, coefficients and
           prototypes gated; then ``predict`` on the card against ``predict``
           on the CPU on the same head outputs (classes and valid slots
           equal, scores within 1e-6, boxes within a few f32 ulps).  ``detection``:
           bf16, batch 32, momentum lr 0.01, clip 10, 2 + 8 steps through
           ``fit`` (a readback each step): step time, images/s, MFU
           (``FlopCounterMode`` FLOPs over the card's bf16 peak), peak memory,
           the four loss terms finite with ``num_pos`` and ``mask_slots`` over
           0; a ``profile`` line.  ``detection_learn``: 20 steps on one
           repeated batch, the loss below 0.7 of its start.
           ``detection_eval``: ``predict`` and ``DetectionAccumulator`` over 2
           held-out batches (mAP and mask mAP gate nothing).
           ``detection_example``: a ResNet-50 classifier saved by one
           ``resnet_imagenet`` step, then ``examples.detection_train.main
           --masks --backbone_ckpt`` (3 steps, one eval batch, batch 8): every
           backbone tensor transferred, the losses finite.
12. cifar10  ``examples.cifar10_train.main`` (VGG-11, batch 64, 20 steps, 2
           eval batches) and ``examples.lenet_mnist.main`` (20 steps): step
           time and images/s, the losses finite.
13. records  the record-backed input plane, sources written from seeds under
           a temporary directory (removed at the end) and converted by the
           port's ``cli convert``; every run's loaders must be the native
           loader (``train/native_loader.py``, built by ``g++`` from
           ``native/dataloader``), its launch counters zeroed just before and
           read just after.  ``records_resnet``: 1,024 JPEGs of 16 classes
           converted with ``--format imagefolder --margin 32`` (stored at 256
           px) and 256 at 224 px as ``val``; ``examples.resnet_imagenet.main``
           at ResNet-50, bf16, batch 128, ``--use_pallas_head``,
           ``--augment_crop --augment_flip`` (the 224-px window and the flip
           on the card), two prefetch producers, 10 steps under
           ``--profile``, then ``--full_eval`` over the whole val split: step
           time, images/s, MFU, the ``data_wait`` and ``h2d`` shares of the
           step (over the run, from the profile; and steady, the medians of
           the journaled per-step breakdowns over steps 2..10), the
           prefetcher's counters, 256 held-out records scored, the f32 dense
           once a step and once an eval batch (split-K).
           ``records_llama``: the tree's own ``deeplearning_cfn_tpu/**/*.py``
           (sorted, one text) converted byte-level at seq 2048, m435, batch
           8, 8 steps: the mean of the last two losses below the first, flash
           2 a block and step (wgmma).  ``records_bert``: the same text at
           seq 128, BERT-base ``--use_pallas_mlp``, batch 32, 20 steps at lr
           1e-4: 24 fused-dense launches a step (wgmma), mask id 257.
           ``records_small``: VGG-11 on converted CIFAR-10 pickles with
           ``--eval_data_dir --full_eval`` (256 held out), and
           ``detection_train --masks`` on 64 ``instance_spec(256, 10)``
           records for 4 steps: finite losses, no kernel launched.
14. llama8b  Llama-3-8B (``LlamaConfig.llama3_8b``: untied, 32 q and 8 kv
           heads, full remat a layer) on one card; the flash kernel's row at
           its shape is phase 3's.  ``llama_memory.validate_on_device`` (batch 1, seq 8192, two
           adafactor steps): the peak at or below ``memory_report``'s
           prediction.  The main path: ``examples.llama_train.main --size 8b
           --optimizer adafactor --seq_len 8192 --global_batch_size 2
           --grad_accum 2 --steps 3`` (JAX's memory-lean program, batch 8
           with accumulation 8, cut to 2 and 2: the same microbatch), the
           counters zeroed just before: the losses finite, the peak at or
           below the prediction and the error printed, flash launched
           2 x 32 x 2 x 3 = 384 times in its wgmma variant; step time,
           tokens/s, MFU; one more step profiled by kernel.  An HF-layout
           state dict at
           ``expected_hf_shapes(llama3_8b)`` drawn in bf16 on the card from
           seeds through ``llama_import.from_hf_state_dict``: every tensor
           its source transposed, the source dict emptied, the peak within
           1.1 x (one model + its largest tensor).  ``TrainerConfig.remat``
           off, on (nested over the preset's "dots" remat a block) and on
           without the block remat, one m435 step each: the gradients
           agree, and the peak with remat on is at most the peak without.

15. pp_layout  JAX's stage-stacked m435 (``pp_stages`` 2, ``pp_microbatches``
           4): weights drawn on the card from a seed, laid out as the JAX
           tree (``[pp, L/pp, ...]`` by ``parallel.pipeline.stack_stages``) and
           carried into the model through ``interop``.  One rank has no pp
           axis, so the stage-stacked model runs its 24 layers in sequence
           (JAX's fallback; the whole batch is the one microbatch): its
           logits and 4 AdamW steps on one repeated batch bitwise those of
           the unstaged model on the same weights, flash 2 a block and step.
           GPipe across ranks runs in phase 24, its activations staged
           through the host (``parallel/p2p.py``: gloo refuses send/recv of
           CUDA tensors, ``tools/gloo_cuda_probe.py``).
16. two_ranks  two processes of this script on the one card, a gloo group
           over CUDA tensors (host-staged), ``DEEPLEARNING_SLICES_COUNT=2``:
           the mesh is ``hybrid_mesh_for_slices(2)``, dp 2 over the "DCN"
           axis.  m435 at ``TWO_RANK_LAYERS`` (4) of its 24 layers, seq
           2048, batch 8 a rank, 4 AdamW steps on the same
           batches each: the dp step (DDP's sync at its bucket size, named
           "hookless" in the rows); ``comms_overlap`` (f32 buckets),
           bitwise the hookless run (losses and parameters); a planted
           control (the bucketed run with its first bucket left unsynced),
           which the bitwise check must fail; ``overlap_compress`` (int8 with
           error feedback), its losses within ``INT8_RTOL``/``INT8_ATOL`` of
           the f32 run's.  Step ms (gloo, host-staged: not NVLink times),
           bytes a rank sends a step, each process's peak memory, flash 2 a
           block and step in every run.  Then phase 24's cases, in the same
           two processes.
17. mesh_captured  ``multi_step_fn(4)`` of the m435 step with ``strategy
           "fsdp"`` over ``build_mesh(MeshSpec(fsdp=1))`` on a one-rank NCCL
           group (the ``mesh`` phase's mesh; FSDP2's collectives in the
           graph): its losses and parameters bitwise four eager steps over
           that mesh, with the planted no-update control, then replays
           timed.  Then, on the same group over ``MeshSpec(dp=1)`` at
           ``MESH_SYNC_LAYERS`` (4) of the 24 layers, seq 2048, batch 8:
           the dp step (DDP's sync without its wrapper), the
           bucketed sync in f32 and in int8 (``comms_overlap``, its
           one-rank gate, JAX's, lifted here: the engine is the same at any
           rank count), each one capture whose losses and parameters over
           ``MESH_REPLAYS`` calls are bitwise as many eager steps'; the
           collectives the capture put in the graph (c10d ops, counted by
           the profiler) the sync's buckets times the steps; the device
           activity of one replay, reported (on one rank NCCL launches no
           kernel: nothing for an all-reduce or broadcast in place, a copy
           for an all-to-all or all-gather, ``tools/gloo_cuda_probe.py``; the
           NCCL kernels of a replay are held on two cards by
           ``tools/nccl_layouts.py``); flash in its wgmma variant.  A
           planted control, the f32 sync with one bucket left out of the
           graph, must fail the count.
18. live_reshard  two processes of this script on ``cuda:0`` over gloo,
           ``DEEPLEARNING_SLICES_COUNT=2``, one slice each, driving the cluster
           plane: the port's ``EventBus`` into ``ElasticityController`` (10 s
           debounce on a ``VirtualClock``), ``LiveReshardManager`` and
           ``LiveReshardCoordinator`` handed to ``Trainer.fit(reshard=)``.
           m435 at full width, ``RESHARD_LAYERS`` (4) of its 24 layers
           deep, seq 2048, batch 8 a rank (16 in
           all), AdamW, ``strategy "fsdp"`` on the hybrid mesh (dp over the
           slices), six steps, flash on.  Runs: ``straight`` (no loss,
           ``fit`` without ``reshard=``); ``live`` (the slice-s1 terminate
           burst, a duplicate in it, published on the coordinator rank's bus
           while batch 3 is made, then the clock past the window: both ranks
           pause at the next boundary, rank 1 leaves, rank 0 re-forms a
           one-slice mesh and trains steps 4-6 on the whole batch of 16 as
           two microbatches of 8); ``control`` (the live run to step 4 with
           the survivor's Adam moments zeroed after migration, which the
           state comparison must refuse, and a checkpoint saved at step 4,
           after the boundary, by rank 0 alone over the survivors' group);
           ``fallback`` (``force_fallback``: ``fit`` stops at the boundary,
           the DCP checkpoint of step 3 is restored on the one-slice mesh
           with accumulation 2, every tensor bitwise rank 0's state at the
           boundary, then steps 4-6).
           Gates: finite losses; live steps 1-3 bitwise straight's; live and
           fallback after the boundary within ``RESHARD_RTOL``/``RESHARD_ATOL``
           of straight (the JAX scenario's tolerance); rank 0's migrated
           parameters and optimizer state bitwise its pre-pause state; one
           live reshard, no fallback; accumulation 2 after; the mesh from
           dp 2 to one device; the control's save after the boundary
           committed; the fallback's restore bitwise; flash 2 a block and
           microbatch (24 a step a rank before, 48 a step on rank 0 after),
           all ``wgmma_tma``.  Reported:
           step times before and after, with and without ``reshard=``, the
           pause (``ReshardRecord.seconds``), the fallback's save and restore,
           each process's peak memory.
19. provision_run  the provisioning plane, template to trained job:
           ``stock`` is ``python -m deeplearning_cfn_tpu_torch.cli run
           templates/local.json`` (the committed template: the port's LeNet,
           30 steps, on ``cuda:0``, 4 local workers); then a local template
           written to a temporary directory (backend ``local``, 1 worker of
           ``local-1``, local storage at a temporary mount, retained on
           delete; job module ``deeplearning_cfn_tpu.examples.llama_train``,
           which the launcher maps onto the port's; args m435, seq 2048,
           batch 8, ``steps`` from the template parameter ``Steps``, the
           checkpoint directory from ``CheckpointDir``).  ``straight``: ``cli
           run <template> -P Steps=6``, no checkpoint.  ``recovered``:
           ``run_with_recovery`` over ``Steps=3`` with ``<mount>/ckpt``; each
           episode runs the plan's module through ``LocalJobRunner``; after
           episode 1 ``LocalBackend.kill_instance`` takes the coordinator, the
           ``RecoveryManager`` recreates the cluster on the retained storage
           and episode 2 resumes at step 3.  ``control``: the same, but with
           no checkpoint directory, so episode 2 starts at step 0.  Gates: the
           stock run's rc 0 and finite losses; one recovery; episodes at steps
           0 and 3, ending at 6; the storage id kept, ``created`` false; a
           fresh ``contract.json`` and ``env.sh`` with 1 worker; one
           ``recovery_start`` and one ``recovery_done`` in the journal;
           recovered steps 1-6 bitwise ``straight``'s, the control refused;
           flash 48 a step, all ``wgmma_tma``.  Reported:
           ``template_to_first_step_s`` (stock, straight), the recreate
           (``Provisioner.recover``'s ``recover`` span), episode 2's restore
           and first step, the time to recover by recreate, the m435 step.
           ``episode2_first_step_ms`` is one step's time: the throughput
           record of a resumed run counts only the steps it ran (it used to
           divide one step's time by the restored step + 1).
20. provision_broker  the production topology, the broker's control plane
           on the card: the broker built from ``native/broker/broker.cpp``
           into ``build/torch_native/`` (``broker_build_s``, 0 when cached,
           outside every other clock); a local template written to a
           temporary directory (2 workers of ``local-1``, retained local
           storage at a temporary mount, job module
           ``deeplearning_cfn_tpu.examples.llama_train``, m435 at seq 2048,
           batch 8, AdamW, flash on, ``Steps`` 6, 0.5 s polls);
           ``python -m deeplearning_cfn_tpu_torch.cli run <template>
           --broker auto`` in its own process (on the card, no
           ``--device``), which starts the broker detached and records it
           under its ``DLCFN_ROOT``; the script reads that record, as a VM
           reads its metadata, and starts two ``python -m
           deeplearning_cfn_tpu_torch.cluster.agent_main`` processes, each
           with its own root and the stamped token, and a third without the
           token.  Gates: the controller exits 0 with 6 steps on
           ``cuda:0``; both agents exit 0; the tokenless one is refused at
           AUTH and exits non-zero while the cluster comes up without it;
           the three ``contract.json`` files byte-equal; ``status --cluster``
           names both agents with at least one beat and ``--fleet`` merges
           both agents' telemetry; ``delete`` prints ``"broker": "stopped"``,
           the broker's pid is gone within 10 s and its record removed;
           flash 48 a step, ``wgmma_tma`` (from the run's
           ``kernel_launches``).  Reported: ``template_to_first_step_s``,
           the bootstrap (the controller's ``broker_started`` to the
           coordinator agent's ``bootstrap_complete``), the m435 step,
           beats and telemetry frames per agent, the phase's seconds.
21. sched_flash_crowd  the fleet scheduler with live regrowth, JAX's
           ``sched-flash-crowd`` incident on the card: two processes of this
           script on ``cuda:0`` over gloo, training JAX's
           ``LlamaConfig.m435`` at full width, ``SCHED_LAYERS`` (4) of its
           24 layers (seq 2048, per-rank
           batch 8, AdamW, flash on; FSDP2 at fsdp 1 under dp 2; job
           ``train-fsdp``, ``prod-train``, slices s1 and s2, one rank each).
           Each first trains 16 steps straight; then in rank 0's process the
           ``chaos.scenarios.FlashCrowd`` world: job ``serve-chat``
           (``prod-serve``, s0) with replicas ``pool-a``/``pool-b`` of the
           paged-KV engine at m435 width in bf16 (seed-0 weights, 4 slots,
           blocks of 4, 8 a slot, prefill 16, a decode CUDA graph each),
           one round a train step: 2, 2, 8, 8, 8, 1, 1 arrivals (4-11
           tokens from the vocab, 4 new each), ``pool-a`` killed in round
           3.  The inflight rule pages, the arbiter preempts s2 (the live
           reshard to rank 0 alone, accumulation 2; rank 1 parks, its black
           box capturing the notice) and lends it as a 6-slot replica; the
           resolve reclaims it and regrows the mesh (rank 1 rejoins, the
           state broadcast to it, accumulation 1).  Gates: JAX's invariants
           (``crowd_checks``: the SLO fires and resolves once, no request
           lost, one preemption and one restore journaled, the loan
           returned, a crashed arbiter's resume absorbs the replayed page);
           the steps before the preemption bitwise the straight run's, the
           whole run within rtol 5e-3/atol 1e-4; both ranks' parameters and
           optimizer state bitwise equal after the regrowth (rank 0's
           broadcast and compared on rank 1, after the pause), the returning
           rank's state as laid out before the transfer (a planted control:
           what a grow without it leaves) unequal; flash 2 a block and
           microbatch (24 at 12 layers), ``wgmma_tma``.  Then over the run's journals, black
           boxes and metrics streams through ``cli.main``: ``status
           --profile --serve --format prom`` (the ``dlcfn_sched_*``,
           ``dlcfn_serve_*``, ``dlcfn_step_phase_ms`` families), ``trace``
           (two host rows), ``postmortem`` (two hosts), ``status
           --metrics-dir`` (both workers at step 16).  Reported: the shrink
           and regrowth pauses (``ReshardRecord.seconds``), the step ms
           before, while lent and after (the world's round excluded), the
           pool's TTFT p50/p99 on the wall clock and its tokens/s over its
           steps, the phase's seconds.
22. chaos_catalog  the rest of the chaos catalog and the composed-incident
           gauntlet, seed 0, at JAX's sizes, through ``chaos.run_scenario``
           with ``device="cuda"``: the ten control-plane scenarios in this
           process on virtual clocks; ``serve-replica-loss`` (two engines of
           the tiny f32 Llama on ``cuda:0``, 80 Poisson requests, a replica
           killed mid-traffic); ``data-reshard-live`` and the ``gauntlet``
           (four gloo ranks of ``chaos.scenarios``, 2 slices x fsdp 2, all on
           ``cuda:0``, training JAX's 64-256-256-10 MLP from DLC1 records;
           the gauntlet's broker ring, data plane and SLO engine in rank 0's
           process).  The in-process ones run first; then, concurrently,
           ``data-reshard-live``, the gauntlet, the gauntlet's pinned
           schedule once more, and ``cli gauntlet --sweep 2 --device cuda``
           in its own process (a rank process spends seconds importing
           torch).  One line a scenario: passed, the number of invariants,
           the violations, its seconds, its ranks' or engines' devices, the
           ranks' seconds by stage.  Then the two gauntlet ``to_dict()``
           reports byte-equal, and the straight curves that each of the
           two trained for itself equal; rank 0's composed pause
           (``ReshardRecord.seconds``: the MLP's live reshard 4 -> 2 ranks
           with the data plane's reshard and the shard failover inside it)
           beside phase 18's plain pause; the sweep passing both
           schedules.  Gates: every report passes, every
           rank and engine on ``cuda:0``, the reports and straight curves
           equal, the sweep clean, no kernel of the port launched in this
           process or in the ranks' (the sweep's ranks counted by ``cli
           gauntlet``'s stderr line; the MLP and the tiny Llama's serving
           run none).
23. analysis  the port's ``analysis/`` on the card.  ``cli lint`` with every
           pass against the port's baseline (exit 0; the findings the
           baseline holds, by rule) and on a planted file (a host sync in a
           ``torch.cuda.graph`` block, a host read of ``full_tensor()``:
           exit 1 with DLC003 and DLC502).  The compile audit: the audit
           MLP's ``single_step`` and ``multi_step`` paths; m435 at full
           width (seq 2048, bf16) cut to ``ANALYSIS_LAYERS``,
           ``multi_step_fn(ANALYSIS_K)`` with one warm-up call and
           ``ANALYSIS_STEADY`` steady calls (exactly one capture, no capture
           or build after the mark, flash in its wgmma variant in the
           warm-up and capture, every state leaf updated in place); the
           serve engine at m435 widths (``ANALYSIS_SERVE_LAYERS``, bf16),
           ``ANALYSIS_REQUESTS`` mixed requests (one ``CapturedDecode``, the
           pool's storage unchanged); a control, a second model handed to
           one wrapper, must give DLC410.  The comms audit: the six programs
           on 2 gloo ranks on ``cuda:0`` (``multi_step`` eagerly: its graph
           needs NCCL, phase 17's), counts and bytes equal to the committed
           CPU budget, c10d's count equal to the backend's, peak memory
           reported.  The replay audit: every catalog scenario that starts
           no rank process and both soaks, twice each, byte-equal; the four
           that do are named as not replayed here.  The lints, the comms
           ranks and the replay audit are subprocesses that run while this
           process runs the compile audit.
24. model_parallel_ranks  the rest of slice 5b across two ranks on the card,
           run in phase 16's two processes after their dp runs (its row and
           gates come last): JAX's ``LlamaConfig.m435`` at full width cut to
           ``MP_LAYERS`` (4) of its 24 layers (2 a stage under pp), seq 2048,
           batch ``MP_BATCH`` (2) on each rank, ``MP_STEPS`` (3) AdamW steps
           from seed 0 on one repeated batch, each mesh ``build_mesh`` over
           gloo with ``device_type "cuda"``.  Cases: ``pp2_remat`` (GPipe at
           pp 2, M 2, ``TrainerConfig.remat``, bf16, flash; activations and
           their gradients staged through pinned host buffers,
           ``parallel/p2p.py``), ``sp2_flash`` (sp 2, bf16, k/v gathered
           over sp; the flash kernel on the block's q rows, twice after sp
           rank 0: the keys before the rows unmasked, the diagonal block
           causal, merged by their lse),
           ``sp2_ring`` (sp 2, ring attention through the staged p2p),
           ``moe_tp2`` (8 experts, top-2, tp 2, f32, FSDP2 over the tp
           DTensors), ``moe_sp2`` (the same at sp 2: one routing group over
           the two sequence blocks).  Each against rank 0's one-rank run of
           the same weights and batches on the card (``sp2_ring``'s with the
           materialised attention, whose scores round as the ring's do; the
           reference's numbers and final parameters broadcast to rank 1), within
           ``MP_TOL`` (bf16: losses 2e-3, the first step's global gradient
           norm 1e-2, the worst parameter gap 0.2; f32: 1e-5, 1e-4, 0.05);
           the MoE cases' first-step experts, slots and kept claims equal
           the one-rank run's (each rank's rows).  Gates also: both ranks'
           losses equal, every parameter on ``cuda:0``, the model's tp, sp
           and pp, flash ``MP_FLASH_PER_BLOCK`` a block, microbatch and step
           (twice that past sp rank 0; all ``wgmma_tma``; none in the f32 MoE and ring cases), no other
           kernel, bytes staged in the pp and ring cases.  Reported: the
           bytes each rank staged, step ms (gloo, host-staged), seconds.

The f32 fused-dense rows and the int8-weight rows with an f32 x also hold
the kernel and f32 ``addmm`` (TF32 off; for the int8 kernel on the
dequantised weight) against the float64 product, and the tensor-core
variants must be within twice ``addmm``'s error.
The variants are read from the launch counters, which count each launch
under the variant its C launcher reports.
The flash row of the kernels line counts the launches of every Llama path
(``slice``, ``moe``, ``adafactor``, ``mesh``, ``llama_captured``, the resumed
m435 run of ``checkpoint``, the m435 run of ``records``, the 8B run of
``llama8b``, ``pp_layout``, both processes' runs of ``two_ranks`` and
``mesh_captured``, ``live_reshard``, ``provision_run``, ``provision_broker``,
``sched_flash_crowd``, ``analysis``, ``model_parallel_ranks``; by path in
``launches_by_path``), each counted from zero just
before its run, with the 8B shape's row beside it (``llama8b_shape``); the bf16
fused dense's row those of the ``bert`` and ``records`` runs; the f32 fused
dense's those of the ``resnet`` phase's eager kernel-head run, the resumed
ResNet-50 run of ``checkpoint`` and the ResNet-50 run of ``records``.  The
``detection``, ``cifar10`` and ``chaos_catalog`` phases launch no kernel of
the port (the JAX models they port are plain XLA): each kernel's
``launches_by_path`` reports them as 0, and a launch there fails the run.
Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the script exits non-zero without the last line; with no CUDA card, or
outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pickle
import statistics
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

STEPS = 6
SLICE_ARGS = [
    "--size", "435m", "--seq_len", "2048", "--global_batch_size", "8",
    "--steps", str(STEPS), "--log_every", "1", "--optimizer", "adamw",
    "--weight_decay", "0.1", "--device", "cuda",
]
# Tolerances, kernel against its plain version on the same inputs:
# bf16 out: both round p to bf16 for p @ v, at different blockings (the
# kernel's running max moves every 64 keys, the reference's every 512), and
# round out to bf16, so they may differ by two bf16 ulps of |out| <= 1.
BF16_OUT_ATOL = 2e-2
# ... and, since |out| shrinks as the keys grow (about sqrt(e/n) over n keys
# of random scores: 0.018 at n = 8192, near BF16_OUT_ATOL itself), each bf16
# row (its D values) within BF16_ROW_ULPS ulps of its own largest |value|:
# the two sides' p roundings give under one, their out roundings one more.
BF16_ROW_ULPS = 4
# lse and f32 out: f32 sums of up to 2048 terms in another order, and
# another exp/log.
LSE_ATOL = 1e-3
F32_OUT_ATOL = 1e-5
# f32 gradients through the torch backward: the same backward on forwards
# that differ by f32 rounding.
F32_GRAD_ATOL = 1e-4
# Fused dense against its plain version (an f32 product of the same stored
# values): bf16 out, both round an f32 sum of the same products, taken in
# another order, so an output next to a rounding boundary may land one bf16
# ulp apart (2**-7 relative covers one ulp in any binade).  f32 out: two f32
# sums of up to 2048 terms in another order, each within a few 1e-6 of the
# float64 product on O(1) outputs (the f32 rows print both errors).
DENSE_TOL = {"bfloat16": (2**-7, 1e-5), "float32": (1e-5, 1e-5)}  # (rtol, atol)
# The int8-weight dense: as the fused dense (with an f32 x, each K chunk's
# products are summed apart and added on the CUDA cores, so it sums as an f32
# product does; its f32 rows print the float64 errors beside addmm's).
QUANT_TOL = {"bfloat16": DENSE_TOL["bfloat16"], "float32": DENSE_TOL["float32"]}
# Gradients through FusedDenseFunction, kernel forward against plain forward:
# the same torch backward on forwards that differ by f32 rounding, and dw
# sums 512 products of the gelu derivative at those forwards: 1e-4 in f32.
GRAD_TOL = {"bfloat16": DENSE_TOL["bfloat16"], "float32": (1e-4, 1e-4)}
# Logits of the m435 model, kernel path against the plain flash forward:
# each layer's attention output differs by up to two bf16 ulps, carried
# through 24 residual layers into bf16 logits of magnitude about 1 at random
# init (ulp 2**-7), so a max of 8 ulps and a mean of 1e-2.
LOGITS_MAX_ATOL = 0.0625
LOGITS_MEAN_ATOL = 1e-2
BERT_STEPS = 40
BERT_BATCH, BERT_SEQ = 32, 128
BERT_ARGS = [
    "--seq_len", str(BERT_SEQ), "--global_batch_size", str(BERT_BATCH),
    "--steps", str(BERT_STEPS), "--log_every", "1", "--device", "cuda",
]
# BERT-base logits, fused-dense kernel against the plain fused dense: each
# MLP output may differ by one bf16 ulp where its f32 sum lies next to a
# rounding boundary, carried through 12 layers into bf16 logits of magnitude
# below 8 at random init (ulp at most 2**-5): a max of four ulps there, and a
# mean of 1e-2.
BERT_LOGITS_MAX_ATOL = 0.125
BERT_LOGITS_MEAN_ATOL = 1e-2
# The f32 fused dense's variants: split across a cluster, and not.
F32_SPLITK = "wgmma_tma_bf16x6_splitk_128x192"
F32_COOP = "wgmma_tma_bf16x6_128x192"
# Flash crossover: sequence lengths at the m435 heads, tokens per call held
# at the Llama path's batch 8 x seq 2048.
CROSSOVER_SEQS = (512, 1024, 2048, 4096)
CROSSOVER_TOKENS = 8 * 2048
# Serving: Llama-3-8B at full width and depth, bf16, random weights from a
# seed; 8 slots of 64 pages of 16 tokens (a 512-page pool, 1 GiB), prompts
# padded to 512; 16 requests in one burst, so 8 run and 8 queue.
SERVE_SLOTS = dict(num_slots=8, block_size=16, blocks_per_slot=64, prefill_len=512)
SERVE_TRAFFIC = dict(requests=16, seed=0, prompt_len_range=(128, 512),
                     output_len_range=(64, 256))
# The f32 parity check at 8B widths: two layers, two 64-token prompts, 32 new
# tokens each (max_context = 64 + 32, generate's extent).  Teacher-forced
# paged decode logits against Llama.forward: f32 sums of up to 14336 terms in
# another order through two layers, on logits of O(1), a few 1e-6; 1e-4.
PARITY_LAYERS, PARITY_PROMPT, PARITY_NEW = 2, 64, 32
SERVE_LOGITS_ATOL = 1e-4
# ResNet-50, bench.py's training configuration: bf16, batch 128, 224 x 224,
# uint8 images from a pool of 4 synthetic batches normalised in the step,
# label smoothing 0.1, Nesterov momentum at lr 0.1; 2 + 8 eager steps a head,
# multi_step_fn(4) captured and replayed 3 times a head.
RESNET_BATCH, RESNET_IMAGE, RESNET_POOL = 128, 224, 4
RESNET_WARMUP, RESNET_STEPS = 2, 8
RESNET_K, RESNET_REPLAYS = 4, 3
RESNET_EXAMPLE_STEPS = 3
# Captured steps against eager ones from the same state: the same kernels on
# the same inputs, but cuDNN's backward may sum in another order from run to
# run (atomics), so the losses agree to 1e-3 relative, not always bitwise.
RESNET_CAPTURE_RTOL = 1e-3
# The parallelism slice's Llama paths (phases 6b-6e).  moe: the m435 shape at
# full depth and width with 8 experts (JAX's defaults: top-2, capacity factor
# 1.25, aux weight 0.01); adafactor: the 3b rung; mesh: MeshSpec(fsdp=1) on a
# one-rank NCCL group against the same steps without a mesh; llama_captured:
# multi_step_fn(LLAMA_K) of the m435 AdamW step against as many eager steps.
MOE_STEPS = 6
MOE_ARGS = SLICE_ARGS[:SLICE_ARGS.index("--steps")] + [
    "--steps", str(MOE_STEPS), "--log_every", "1", "--experts", "8", "--device", "cuda"]
ADAFACTOR_STEPS = 4
ADAFACTOR_ARGS = ["--size", "3b", "--optimizer", "adafactor", "--seq_len", "2048",
                  "--global_batch_size", "4", "--steps", str(ADAFACTOR_STEPS), "--log_every", "1",
                  "--device", "cuda"]
MESH_STEPS = 4
LLAMA_K, LLAMA_REPLAYS = 4, 2
# The MoE path's attention, kernel against plain: every layer's flash call
# in one bf16 forward of the MoE model at the step's shape (batch 8, seq
# 2048, the wgmma variant) is recorded, and the plain flash forward runs on
# the recorded q, k, v.  Routing never enters: the inputs are the same.  The
# kernel rows hold outputs of |out| <= 1 at BF16_OUT_ATOL, two bf16 ulps
# there; down the residual stream the outputs grow (past 4 in later layers)
# and their ulps with them, so each layer is held at BF16_OUT_ATOL times its
# largest |out| (when above 1): the same two ulps, at that layer's scale.
# MoE logits, kernel path against the plain flash forward, in f32 (the
# kernel's f32 variant), batch 2: in f32 each layer's attention output agrees
# to a few 1e-7 and the logits, of O(1), to 2.1e-6 at most and 2.4e-7 on
# the mean (H100, 700 W).  A routing flip (a token whose two best experts'
# scores lie within that rounding of each other) would move that token's
# logits by O(0.1); at these seeds none happens, and the run is deterministic,
# so the limits sit ten and four times above the readings and a flip fails.
MOE_LOGITS_ATOL, MOE_LOGITS_MEAN_ATOL = 2e-5, 1e-6
# The mesh run against the unsharded run, and the captured steps against
# eager ones, on one repeated batch, whose loss falls (10.39 to 9.87 in four
# steps), so a run that never updates shows: its losses sit 5.2e-2 from the
# sound run's, and its parameters a whole run's travel (a gap of 1.0 below).
# Losses: relative; parameters: the worst parameter's
# ||p_a - p_b|| / ||p_b - p_0||, the gap over the distance travelled.  Sound
# runs differ only by rounding: both pairs were bitwise equal (H100, 700 W),
# but the backward may sum in another order from run to run (captured losses
# 1.9e-6 apart on uniform tokens), and a bf16 weight near 0.03 takes steps of
# ~2.5 ulps, so one rounding flip moves an element by ~40% of its step: an
# AdamW that rounded differently on one side gave losses 2.0e-5 and a
# parameter gap of 0.049 apart.  The limits sit five and four times above
# that, and the planted no-update run past them by NO_UPDATE_MARGIN at least.
MESH_LOSS_RTOL = 1e-4
LLAMA_CAPTURE_RTOL = 1e-4
PARAM_GAP_MAX = 0.2
NO_UPDATE_MARGIN = 4
# Checkpoint and resume (phase 10): the m435 AdamW run over CKPT_STEPS
# batches, saved at half of them; every checkpoint is written under a
# temporary directory, which must have CKPT_DISK_BYTES free (at most three
# m435 checkpoints of ~2.6 GB at once, one of them in flight).  Its m435 is
# cut to CKPT_LAYERS deep (6 since phase 23 joined, 4 since phase 24), to hold
# the whole script within its time limit; phase 18's fallback saves and
# restores the m435 state, held bitwise.
CKPT_STEPS, CKPT_EXAMPLE_STEPS, CKPT_LAYERS = 8, 2, 4
CKPT_DISK_BYTES = 10 * 10**9
# Detection (phase 11): the JAX RetinaNet configuration at full width --
# ResNet-50, FPN 256, 80 classes, 9 anchors a cell, 16 prototypes, masks,
# bf16 -- at the JAX example's 256 px (12,276 anchors), max_boxes 10, batch
# 32, momentum lr 0.01, clip 10.  Parity: the f32 forward on the card against
# the same weights on the CPU at batch 2, eval mode, every BatchNorm's
# variables drawn at random.  cuDNN and the CPU sum the convolutions in
# other orders (TF32 off), so each output is held at DET_PARITY_RTOL of its
# largest entry (at most) and DET_PARITY_MEAN_RTOL of it (on the mean).
# predict on the card against predict on the CPU on the CPU's head outputs:
# classes and valid slots equal, scores within 1e-6, boxes within DET_BOX_RTOL
# of their coordinate and DET_BOX_ATOL px (decoded through exp, which the
# card and the CPU may round differently in the last place; decoded boxes
# reach past the image, to ~2,000 px, where an f32 ulp is 1.2e-4).
DET_ARCH = dict(num_classes=80, backbone_stages=(3, 4, 6, 3), fpn_channels=256,
                with_masks=True, num_prototypes=16)
DET_BATCH, DET_IMAGE, DET_MAX_BOXES = 32, 256, 10
DET_WARMUP, DET_STEPS, DET_LEARN_STEPS, DET_EVAL_BATCHES = 2, 8, 20, 2
DET_PARITY_RTOL, DET_PARITY_MEAN_RTOL = 1e-3, 1e-5
DET_SCORE_ATOL, DET_BOX_RTOL, DET_BOX_ATOL = 1e-6, 2e-6, 1e-4
DET_LEARN_RATIO = 0.7
DET_EXAMPLE_ARGS = ["--masks", "--steps", "3", "--eval_steps", "1", "--global_batch_size", "8",
                    "--log_every", "1", "--device", "cuda"]
# CIFAR (phase 12): cifar10_train at VGG-11, batch 64, 20 steps, 2 eval
# batches; lenet_mnist for 20 steps.
CIFAR_ARGS = ["--model", "vgg11", "--global_batch_size", "64", "--steps", "20",
              "--eval_steps", "2", "--log_every", "1", "--device", "cuda"]
LENET_ARGS = ["--steps", "20", "--log_every", "1", "--device", "cuda"]
# Records (phase 13): sources written from seeds under a temporary directory,
# converted by the port's converters, trained through the examples.
# a. ImageNet-layout JPEGs of REC_CLASSES classes (class-dependent blocks plus
# noise), REC_SRC_PX square: 1,024 for training, stored at 224 + 32 px; 256
# held out at 224 px.  ResNet-50 as the resnet phase's, from the records.
REC_CLASSES, REC_TRAIN_PER_CLASS, REC_VAL_PER_CLASS, REC_SRC_PX = 16, 64, 16, 288
REC_MARGIN, REC_RESNET_STEPS = 32, 10
REC_RESNET_ARGS = ["--depth", "50", "--global_batch_size", str(RESNET_BATCH), "--image_size",
                   str(RESNET_IMAGE), "--steps", str(REC_RESNET_STEPS), "--log_every", "1",
                   "--augment_crop", "--augment_flip", "--use_pallas_head", "--eval_steps", "1",
                   "--full_eval", "--prefetch_workers", "2", "--profile", "--device", "cuda"]
# b. The tree's own deeplearning_cfn_tpu/**/*.py, sorted by path, one text,
# byte-level at seq 2048: m435, batch 8, 8 adamw steps.  c. The same text at
# seq 128: BERT-base with the kernel MLP, batch 32, 20 steps at lr 1e-4.
REC_LLAMA_STEPS, REC_BERT_STEPS = 8, 20
REC_LLAMA_ARGS = ["--size", "435m", "--seq_len", "2048", "--global_batch_size", "8", "--steps",
                  str(REC_LLAMA_STEPS), "--log_every", "1", "--device", "cuda"]
REC_BERT_ARGS = ["--use_pallas_mlp", "--seq_len", str(BERT_SEQ), "--global_batch_size",
                 str(BERT_BATCH), "--steps", str(REC_BERT_STEPS), "--learning_rate", "1e-4",
                 "--log_every", "1", "--device", "cuda"]
# d. CIFAR-10 pickles in the public layout (two data batches of 640, a test
# batch of 256) for VGG-11; 64 detection records of instance_spec(256, 10).
REC_CIFAR_PER_BATCH, REC_CIFAR_TEST, REC_DET_RECORDS, REC_DET_STEPS = 640, 256, 64, 4

# Llama-3-8B (phase 14): JAX's memory-lean single-chip program (adafactor,
# seq 8192, full remat a layer) with batch 2 and accumulation 2 in place of 8
# and 8: the same microbatch, so the same peak.
L8B_SEQ, L8B_BATCH, L8B_ACCUM, L8B_STEPS, L8B_VALIDATE_STEPS = 8192, 2, 2, 3, 2
L8B_ARGS = ["--size", "8b", "--optimizer", "adafactor", "--seq_len", str(L8B_SEQ),
            "--global_batch_size", str(L8B_BATCH), "--grad_accum", str(L8B_ACCUM), "--steps",
            str(L8B_STEPS), "--log_every", "1", "--device", "cuda"]
# The import's peak: one model plus its largest tensor, with this margin.
IMPORT_PEAK_MARGIN = 1.1
# remat on against off, one m435 step (bf16; the recomputation repeats the
# same kernels on the same inputs): the gradients' largest difference over
# the tensor's largest value.
REMAT_GRAD_RTOL = 1e-2

# The rest of the parallelism slice (phases 15-17), m435 at seq 2048.
# pp_layout: JAX's stage-stacked m435 at 2 stages and 4 microbatches.
PP_STAGES, PP_MICROBATCHES, PP_STEPS, PP_BATCH = 2, 4, 4, 8
# two_ranks: two processes on the one card, a gloo group, per-rank batch 8;
# m435 cut to TWO_RANK_LAYERS of its 24 layers (6 since phase 23 joined, 4
# since phase 24 runs in the same processes), to hold the whole script within
# its time limit.
TWO_RANK_BATCH, TWO_RANK_STEPS, TWO_RANK_TIMEOUT, TWO_RANK_LAYERS = 8, 4, 600, 4
# JAX's test_int8_error_feedback_tracks_the_f32_curve.
INT8_RTOL, INT8_ATOL = 5e-3, 1e-3
# Phase 24, model_parallel_ranks (in phase 16's two processes, after its dp
# runs): JAX's m435 at full width cut to MP_LAYERS of its 24 layers (2 a
# stage under pp), seq 2048, batch MP_BATCH on every rank (no data axis: each
# rank holds the whole batch, its block of the sequence or its columns),
# MP_STEPS AdamW steps from seed 0 on one repeated batch, no clip (so the
# first step's gradient norm is read off .grad).  Each case against rank 0's
# one-rank run of the same weights and batches on the card.
MP_LAYERS, MP_BATCH, MP_STEPS, MP_SEQ = 4, 2, 3, 2048
MP_MOE = dict(n_experts=8, moe_top_k=2, dtype="float32", use_flash_attention=False)
MP_CASES = {  # name: (mesh, config overrides, trainer overrides, the reference's overrides)
    "pp2_remat": (dict(pp=2), dict(pp_stages=2, pp_microbatches=2), dict(remat=True),
                  dict(pp_stages=1, pp_microbatches=0)),
    "sp2_flash": (dict(sp=2), {}, {}, {}),
    # The reference's scores round to bf16 before the softmax, as the ring's do.
    "sp2_ring": (dict(sp=2), dict(use_ring_attention=True), {}, dict(use_flash_attention=False)),
    "moe_tp2": (dict(tp=2), MP_MOE, dict(strategy="fsdp"), {}),
    "moe_sp2": (dict(sp=2), MP_MOE, {}, {}),
}
# Flash launches a block and step of a case's run (pp: a block of the rank's
# stage and microbatch): the forward and its recompute under the preset's
# "dots" remat; under TrainerConfig.remat the forward, the stage's
# recompute and the block's own recompute inside it, but for the last block
# of a stage before the last, which the stage's recompute does not reach
# (torch.utils.checkpoint stops once the saved inputs of the blocks' own
# checkpoints are back, and the stage's output is sent, not saved).  The MoE
# cases run in f32 with the materialised attention (a bf16 token may take
# another expert: ROADMAP queue 3) and launch no kernel; ring attention none.
# Under sp a rank past sp rank 0 launches twice a block forward: its rows
# over the keys before them, unmasked, then over its diagonal block, causal.
MP_FLASH_PER_BLOCK = {"pp2_remat": 3, "sp2_flash": 2, "sp2_ring": 0, "moe_tp2": 0, "moe_sp2": 0}
# Tolerances against the one-rank run: the losses (relative), the first
# step's global gradient norm (relative) and the worst parameter's gap
# (||run - ref|| / ||ref - p0||, 1 for a run that never moved).  bf16: the
# ranks' products, sums and microbatch gradients round in another order;
# f32 (TF32 off): only the summation order differs.
MP_TOL = {"bfloat16": dict(loss_rtol=2e-3, norm_rtol=1e-2, param_gap=PARAM_GAP_MAX),
          "float32": dict(loss_rtol=1e-5, norm_rtol=1e-4, param_gap=0.05)}
# mesh_captured: multi_step_fn(MESH_K) over the mesh phase's one-rank mesh.
MESH_K, MESH_REPLAYS = 4, 2
# ... and over MeshSpec(dp=1): the dp step and the bucketed sync in f32 and int8,
# m435's widths cut to MESH_SYNC_LAYERS of its 24 layers (to hold the
# script's time), each held over MESH_REPLAYS calls.
MESH_SYNC_LAYERS = 4
MESH_SYNC_CASES = {  # name: trainer overrides
    "ddp": dict(strategy="dp"),
    "buckets_f32": dict(strategy="dp", comms_overlap=True),
    "buckets_int8": dict(strategy="dp", comms_overlap=True, overlap_compress=True),
}
# live_reshard: two ranks on the one card, per-rank batch 8, the loss seen
# while batch RESHARD_DIE_AT is made; the JAX slice-loss-live scenario's
# continuity tolerance (chaos/scenarios.py).
RESHARD_BATCH, RESHARD_STEPS, RESHARD_DIE_AT, RESHARD_TIMEOUT = 8, 6, 3, 900
# ... cut to RESHARD_LAYERS of m435's 24 layers, to hold the whole script
# within its time limit beside phases 21-23.
RESHARD_LAYERS = 4
RESHARD_RTOL, RESHARD_ATOL = 5e-3, 1e-4
# provision_run: the job of the phase's template, steps of the straight run
# and of each episode of the recovered one.
PROV_STEPS, PROV_EPISODE_STEPS, PROV_STOCK_TIMEOUT = 6, 3, 600
# provision_broker: the cluster's name, the job's steps, the provisioner's and
# the agents' poll interval, and the bootstrap budget (seconds).
BROKER_CLUSTER, BROKER_STEPS, BROKER_POLL_S, BROKER_TIMEOUT = "provision-broker", 6, 0.5, 180
# sched_flash_crowd: two ranks on the one card, per-rank batch 8, JAX's
# incident (chaos/scenarios.py CROWD_SCHEDULE, 16 steps); JAX's continuity
# tolerance (deeplearning_cfn_tpu/chaos/scenarios.py:2777).
SCHED_BATCH, SCHED_TIMEOUT = 8, 900
# ... cut to SCHED_LAYERS of m435's 24 layers (training and the serve pool),
# to hold the whole script within its time limit beside phases 22 and 23.
SCHED_LAYERS = 4
SCHED_RTOL, SCHED_ATOL = 5e-3, 1e-4
# Phase 22: the scenarios this slice added, in the JAX catalog's order
# (slice-loss-live and sched-flash-crowd are phases 18 and 21's).
CHAOS_TIMEOUT = 900
CHAOS_ADDED = ("silent-death", "partition", "flaky-rpc", "slow-disk", "data-reshard-live",
               "straggler", "serve-replica-loss", "broker-failover", "split-brain",
               "shard-failover", "degraded-pair-heal", "alert-storm", "gauntlet")


# Phase 23 (analysis): the m435 compile audit's depth (full width, seq 2048,
# bf16), batch and steady calls of multi_step_fn(ANALYSIS_K); the serve
# audit's depth (m435 widths, bf16) and requests; the lint and audit
# subprocesses' time limit.
ANALYSIS_LAYERS, ANALYSIS_BATCH, ANALYSIS_K, ANALYSIS_STEADY = 4, 2, 2, 4
ANALYSIS_SERVE_LAYERS, ANALYSIS_REQUESTS = 4, 24
ANALYSIS_SERVE_SLOTS = dict(num_slots=8, block_size=16, blocks_per_slot=16, prefill_len=128)
ANALYSIS_TIMEOUT = 600
ANALYSIS_LINT_FLAGS = ["--concurrency", "--protocol", "--sharding", "--comms", "--determinism"]
# The lint control: a host sync in captured code (DLC003) and a host read of
# a gathered DTensor (DLC502, the shape train/reshard.py's _move had).
ANALYSIS_PLANTED = (
    "import torch\n\n\n"
    "def step(graph, x, w):\n"
    "    with torch.cuda.graph(graph):\n"
    "        y = x @ w\n"
    "        scale = y.sum().item()\n"
    "    return y * scale\n\n\n"
    "def move(src, region):\n"
    "    src = src.full_tensor()\n"
    "    return src[region]\n"
)


# Traces _device_ms takes before it gives up on seeing device time.
PROFILE_TRIES = 3


#: What one phase measured that a later one reports beside its own.
_NOTES: dict = {}


_T0 = time.perf_counter()


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
    # The timeline, on stderr: seconds since the script started, a line.
    label = obj.get("phase") or next(iter(obj), "")
    print(f"chip_smoke +{time.perf_counter() - _T0:.1f}s {label}", file=sys.stderr, flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _row_ulps(torch, out, ref) -> float:
    """The largest error of ``out`` against ``ref`` in each row (the last
    dim), in bf16 ulps of that row's largest ``|ref|``; the worst row's."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    top = ref.abs().amax(-1).clamp_min(2.0**-126)
    return (err / torch.exp2(torch.floor(torch.log2(top)) - 7)).max().item()


def _time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: the summed time of the kernels and
    copies it ran on the card (``torch.profiler``), over ``iters`` calls.
    The host's time between launches (Python, the wrapper, ctypes) is not in
    it; :func:`_time_ms` has it.  A trace that comes back without device
    time (it happens now and then, even in phase 3) is taken again, up to
    ``PROFILE_TRIES`` traces; none with device time fails the run (the kernel
    rows are taken in phase 3, before the long phases)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0
                       and not getattr(e, "is_user_annotation", False))
        if total_us > 0:
            return total_us / 1e3 / iters
    _require(False, f"the profiler saw no device time in {PROFILE_TRIES} traces")


def _variants(counts: dict, kernel: str) -> dict:
    """Launches of ``kernel`` by variant, from the launch counters."""
    return {k.split("/", 1)[1]: n for k, n in counts.items() if k.startswith(kernel + "/")}


def _launched_variant(kernels_mod, kernel: str, call):
    """Run ``call`` (one launch of ``kernel``) with the counters zeroed and
    return its result and the variant the launcher reported."""
    kernels_mod.reset_launch_counts()
    result = call()
    launched = _variants(kernels_mod.launch_counts, kernel)
    _require(list(launched.values()) == [1], f"{kernel}: one launch expected, got {launched}")
    return result, next(iter(launched))


def _host_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Host time of one call of ``fn``: the wall time to issue ``iters``
    calls back to back, without waiting for the card (its launch queue holds
    far more than ``iters`` launches), then a wait for it to catch up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host_ms


def _attention_work(B, Sq, Sk, Hq, Hkv, D, causal, elt) -> tuple[float, float]:
    """(operations, bytes) one flash forward must do and move: two products
    per valid (query, key) pair, 2*D operations each; q, k, v read once,
    out and lse written once."""
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    flops = 4.0 * B * Hq * D * pairs
    nbytes = elt * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) + 4 * B * Hq * Sq
    return flops, nbytes


def _dense_work(M, K, N, x_bytes, w_bytes, peak_ops, peak_bw) -> dict:
    """The bound of one fused dense: 2*M*N*K operations at ``peak_ops``
    against x, w, the bias (and the int8 path's f32 scale) read once and the
    output written once."""
    flops = 2.0 * M * N * K
    nbytes = x_bytes * (M * K + N + M * N) + w_bytes * K * N + (4 * N if w_bytes == 1 else 0)
    t_ops, t_bytes = flops / peak_ops * 1e3, nbytes / peak_bw * 1e3
    return {"gflop": flops / 1e9, "mbytes": nbytes / 1e6, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _profile(torch, step, n: int) -> dict:
    """Run ``step()`` ``n`` times under the profiler: device time per step
    by kernel name, the wall time per step, and the idle share.  Only the
    device is traced: the host's op events, which nothing here reads, took
    two thirds of a profile's time (the 8B step's ~90 s) for the same
    kernels and device time."""
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    prof.stop()
    # Device time of kernels and copies; a user annotation (such as the
    # optimizer's "Optimizer.step#AdamW.step" range) spans kernels already counted.
    kernels = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    return {"steps": n, "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "idle_share": 1 - device_ms / wall_ms if device_ms else None,
            "top": [{"name": k[:120], "ms_per_step": ms, "calls_per_step": c}
                    for k, ms, c in kernels[:25]]}


def _run_summary(result, batch: int, tokens: int) -> dict:
    """Steady step time (median over steps 2..), rate and MFU of a training run."""
    steady = result["history"][1:]  # the first step includes one-time set-up
    rate = statistics.median(h["examples_per_sec"] for h in steady)
    return {"losses": [h["loss"] for h in result["history"]],
            "step_ms": [batch / h["examples_per_sec"] * 1e3 for h in result["history"]],
            "steady_step_ms": batch / rate * 1e3, "examples_per_s": rate,
            "tokens_per_s": rate * tokens / batch,
            "mfu": statistics.median(h["mfu"] for h in steady),
            "first_step_s": result["first_step_s"], "params": result["params"]}


def _llama_on_card(torch, llama, cfg, seed: int):
    """The port's Llama with random weights drawn on the card: built on the
    meta device, then every matrix filled with normal / sqrt(fan_in), as
    ``init_model`` draws them on the CPU, from a seeded CUDA generator, and
    the norms with ones.  (At 8B, ``init_model`` would take some 8e9 draws
    on the host.)"""
    with torch.device("meta"):
        model = llama.Llama(cfg)
    model = model.to_empty(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith("norm"):
                p.fill_(1.0)
            else:  # the fan-in: [in, out] matrices, [E, in, out] expert banks
                p.normal_(generator=gen).mul_(p.shape[-2] ** -0.5)
    return model


def _flash_check(launches: dict, steps: int, per_step: float, what: str) -> dict:
    """Flash launches of a Llama run: every one in the wgmma variant, at
    ``per_step`` a step (the ``slice`` phase's count a block and step — one
    forward and one remat recompute — times the run's blocks)."""
    n = launches.get("flash_attention_fwd", 0)
    variants = _variants(launches, "flash_attention_fwd")
    _require(variants == {"wgmma_tma": n} and n > 0,
             f"{what}: the Llama path launched flash variants {variants}")
    _require(n == per_step * steps, f"{what}: flash launched {n} times in {steps} steps, "
             f"expected {per_step} a step")
    return {"flash_launches": n, "flash_launches_per_step": n / steps, "flash_variants": variants}


def _adafactor_state_bytes(llama, optimizers, cfg, elt: int = 2) -> int:
    """The Adafactor state of ``cfg``'s JAX leaves, in the parameter dtype:
    row plus column means for a factored leaf (per layer when stacked),
    the full second moment otherwise."""
    leaves = [(cfg.vocab_size, cfg.dim), (cfg.dim,)]
    leaves += [(cfg.n_layers, *shape) for shape in llama.layer_param_shapes(cfg).values()]
    total = 0
    for shape in leaves:
        dims = optimizers.factored_dims(shape)
        n = math.prod(shape)
        total += n if dims is None else n // shape[dims[1]] + n // shape[dims[0]]
    return total * elt


def _param_copy(model) -> dict:
    """Each parameter's local values (a DTensor's shard: the whole tensor on
    one rank), copied."""
    from deeplearning_cfn_tpu_torch.train.optimizers import local_part

    return {n: local_part(p).detach().clone() for n, p in model.named_parameters()}


def _param_gap(a: dict, b: dict, p0: dict) -> dict:
    """The worst parameter's ``||a - b|| / ||b - p0||``, the gap between two
    runs from ``p0`` over the distance run ``b`` travelled: 0 for equal
    runs, 1 for a run ``a`` that never moved."""
    gaps = {}
    for n in b:
        gap = (a[n].float() - b[n].float()).norm().item()
        travelled = (b[n].float() - p0[n].float()).norm().item()
        gaps[n] = gap / travelled if travelled else (0.0 if gap == 0 else math.inf)
    worst = max(gaps, key=gaps.get)
    return {"param_gap_max": gaps[worst], "param_gap_worst": worst,
            "param_gap_median": statistics.median(gaps.values())}


def _held_runs(losses: list, ref_losses: list, gap: dict, p0_gap: dict, rtol: float) -> dict:
    """A run's losses and parameter ``gap`` against the reference run's, and
    the same numbers for a planted run that never updates: its losses all
    the reference's first, its parameters ``p0`` (``p0_gap``)."""
    return {"max_rel_loss_diff": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "rtol": rtol, **gap, "param_gap_limit": PARAM_GAP_MAX,
            "no_update_control": {
                "max_rel_loss_diff": max(abs(ref_losses[0] - b) / abs(b) for b in ref_losses),
                "param_gap_max": p0_gap["param_gap_max"]}}


def _check_held(what: str, row: dict) -> None:
    """The run within the limits, and the planted no-update run
    ``NO_UPDATE_MARGIN`` times past them (so the limits can catch it)."""
    control = row["no_update_control"]
    _require(control["max_rel_loss_diff"] > NO_UPDATE_MARGIN * row["rtol"]
             and control["param_gap_max"] > NO_UPDATE_MARGIN * row["param_gap_limit"],
             f"{what}: the limits would pass a run that never updates: {control}")
    _require(row["max_rel_loss_diff"] <= row["rtol"],
             f"{what}: losses {row['max_rel_loss_diff']} apart, relative")
    _require(row["param_gap_max"] <= row["param_gap_limit"],
             f"{what}: parameter {row['param_gap_worst']} {row['param_gap_max']} apart")


def _slice5a_phases(torch, kernels_mod, smi: str, flash_per_block: float,
                    peak_flops: float) -> dict:
    """Phases 6b-6e: ``moe``, ``adafactor``, ``mesh`` and ``llama_captured``
    (see the module docstring).  Returns each path's flash launches."""
    import socket

    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.examples import llama_train
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel import sharding
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train import optimizers
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    launches_by_path = {}

    def run_example(name, args, steps, batch, n_layers):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        result = llama_train.main(args)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(kernels_mod.launch_counts)
        launches_by_path[name] = launches.get("flash_attention_fwd", 0)
        tokens = batch * 2048
        run = {"phase": name, "args": args, **_run_summary(result, tokens, tokens),
               "active_params": result["active_params"], "wall_s": wall_s,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               **_flash_check(launches, steps, flash_per_block * n_layers, name),
               "nvidia_smi": smi}
        _require(len(run["losses"]) == steps and all(math.isfinite(v) for v in run["losses"]),
                 f"{name}: non-finite loss {run['losses']}")
        return result, run

    # 6b. moe: the m435 shape at full depth and width with 8 experts, top-2.
    cfg = llama.LlamaConfig.m435(seq_len=2048)
    flash_per_step = flash_per_block * cfg.n_layers
    result, run = run_example("moe", MOE_ARGS, MOE_STEPS, 8, cfg.n_layers)
    run["moe_aux_loss"] = result["moe_aux_loss"]
    _emit(run)
    _require(math.isfinite(run["moe_aux_loss"]) and run["moe_aux_loss"] > 0,
             f"moe: the aux loss {run['moe_aux_loss']}")
    mcfg = dataclasses.replace(cfg, n_experts=8, dtype=torch.float32)
    model = _llama_on_card(torch, llama, mcfg, seed=0)
    tokens = torch.from_numpy(next(SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size, batch_size=2).batches(1)).x).cuda()
    kernels_mod.reset_launch_counts()
    with torch.no_grad():
        logits_kernel = llama.forward(model, tokens)
        with llama.force_attention_kind("flash_reference"):
            logits_plain = llama.forward(model, tokens)
    f32_variants = _variants(kernels_mod.launch_counts, "flash_attention_fwd")
    diff = (logits_kernel - logits_plain).abs()
    row = {"phase": "logits", "path": "moe", "flash_variants": f32_variants, "dtype": "float32", "B": 2, "S": 2048,
           "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
           "atol": MOE_LOGITS_ATOL, "mean_atol": MOE_LOGITS_MEAN_ATOL,
           "logits_max_abs": logits_plain.abs().max().item(),
           "finite": bool(torch.isfinite(logits_kernel).all())}
    _emit(row)
    _require(row["finite"], "moe: non-finite logits")
    _require(f32_variants == {"simt": mcfg.n_layers}, f"moe: f32 forward launched {f32_variants}")
    _require(row["max_abs_err"] <= MOE_LOGITS_ATOL, "moe: logits max error")
    _require(row["mean_abs_err"] <= MOE_LOGITS_MEAN_ATOL, "moe: logits mean error")
    del model, logits_kernel, logits_plain, diff, result
    torch.cuda.empty_cache()
    # Two steps of the same bf16 MoE step profiled by kernel, after two
    # warm-up steps, on weights drawn on the card.
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer

    mcfg = dataclasses.replace(cfg, n_experts=8)
    trainer = Trainer(lambda gen: _llama_on_card(torch, llama, mcfg, seed=0), TrainerConfig(
        optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0),
        loss_fn=llama.causal_lm_loss, device="cuda")
    state = trainer.init(seed=0)
    x, y = device_put_batch(next(SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size, batch_size=8).batches(1)), torch.device("cuda"))

    # Every layer's attention in one bf16 forward at the step's shape: the
    # kernel's output against the plain flash forward on the same q, k, v.
    kernel_flash, errs = llama.flash_attention, []

    def checked_flash(q, k, v, causal, **kw):
        out = kernel_flash(q, k, v, causal=causal, **kw)
        ref = llama.flash_attention_reference(q, k, v, causal=causal)[0]
        errs.append(torch.stack([(out.float() - ref.float()).abs().max(),
                                 ref.float().abs().max()]))
        return out

    kernels_mod.reset_launch_counts()
    llama.flash_attention = checked_flash
    try:
        with torch.no_grad():
            llama.forward(state.model, x)
    finally:
        llama.flash_attention = kernel_flash
    errs, scales = torch.stack(errs).T.tolist()
    limits = [BF16_OUT_ATOL * max(1.0, m) for m in scales]
    row = {"phase": "attention", "path": "moe", "dtype": "bfloat16", "B": 8, "S": 2048,
           "flash_variants": _variants(kernels_mod.launch_counts, "flash_attention_fwd"),
           "max_abs_err_by_layer": errs, "max_abs_out_by_layer": scales,
           "atol_by_layer": limits}
    _emit(row)
    _require(row["flash_variants"] == {"wgmma_tma": mcfg.n_layers},
             f"moe: the bf16 forward launched {row['flash_variants']}")
    _require(all(e <= lim for e, lim in zip(errs, limits)),
             f"moe: attention off the plain forward by {errs}, limits {limits}")

    def moe_step():
        nonlocal state
        state, _ = trainer.train_step(state, x, y)

    for _ in range(2):
        moe_step()
    _emit({"phase": "profile", "path": "moe", **_profile(torch, moe_step, 2)})
    del trainer, state, x, y

    # 6c. adafactor: the 3b rung with the memory-lean optimizer.
    bcfg = llama.LlamaConfig.b3(seq_len=2048)
    result, run = run_example("adafactor", ADAFACTOR_ARGS, ADAFACTOR_STEPS, 4, bcfg.n_layers)
    run["optimizer_state_bytes"] = _adafactor_state_bytes(llama, optimizers, bcfg)
    run["adamw_state_bytes"] = 2 * 2 * llama.param_count(bcfg)  # mu and nu in bf16
    run["param_bytes"] = 2 * llama.param_count(bcfg)
    _emit(run)
    del result

    # 6d. mesh: a one-rank NCCL group, the m435 path with strategy "fsdp"
    # over build_mesh(MeshSpec(fsdp=1)) (FSDP2, every parameter a DTensor),
    # against the same steps on one repeated batch without a mesh.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshSpec(fsdp=1))
        tcfg = TrainerConfig(strategy="fsdp", optimizer="adamw", learning_rate=3e-4,
                             weight_decay=0.1, grad_clip_norm=1.0, log_every=1)
        batch = device_put_batch(next(SyntheticTokenDataset(
            seq_len=2048, vocab_size=cfg.vocab_size, batch_size=8).batches(1)), torch.device("cuda"))
        batches = [batch] * MESH_STEPS
        runs, finals = {}, {}
        for path, m in (("mesh", mesh), ("no_mesh", None)):
            trainer = llama.make_trainer(cfg, tcfg, device="cuda", mesh=m)
            state = trainer.init(seed=0)
            if m is None:
                p0 = _param_copy(state.model)
            dtensors = sum(hasattr(p, "placements") for p in state.model.parameters())
            torch.cuda.synchronize()
            kernels_mod.reset_launch_counts()
            losses, step_ms = [], []
            for x, y in batches:
                t0 = time.perf_counter()
                state, metrics = trainer.train_step(state, x, y)
                losses.append(metrics["loss"].item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(kernels_mod.launch_counts)
            mp = llama.model_parallel(state.model)
            runs[path] = {"losses": losses, "step_ms": step_ms,
                          "steady_step_ms": statistics.median(step_ms[1:]),
                          "dtensor_params": dtensors, "launches": launches,
                          "model_tp_sp": [mp.tp, mp.sp],
                          **_flash_check(launches, MESH_STEPS, flash_per_step, f"mesh ({path})")}
            if m is not None:
                launches_by_path["mesh"] = launches["flash_attention_fwd"]
            finals[path] = _param_copy(state.model)
            del trainer, state
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    row = {"phase": "mesh", "mesh": "MeshSpec(fsdp=1), one NCCL rank", "steps": MESH_STEPS,
           **{f"{k}_{p}": v for p, r in runs.items() for k, v in r.items()},
           **_held_runs(runs["mesh"]["losses"], runs["no_mesh"]["losses"],
                        _param_gap(finals["mesh"], finals["no_mesh"], p0),
                        _param_gap(p0, finals["no_mesh"], p0), MESH_LOSS_RTOL),
           "nvidia_smi": smi}
    _emit(row)
    # FSDP2 holds every parameter the specs shard; the norms stay whole.
    n_sharded = sum(sharding.fsdp_dim(spec) is not None for spec in llama.param_specs(cfg).values())
    _require(runs["mesh"]["dtensor_params"] == n_sharded and runs["no_mesh"]["dtensor_params"] == 0,
             f"mesh: {runs['mesh']['dtensor_params']} parameters sharded, expected {n_sharded}")
    _require(all(math.isfinite(v) for v in runs["mesh"]["losses"]), "mesh: non-finite loss")
    _require(runs["mesh"]["model_tp_sp"] == [1, 1], f"mesh: tp, sp {runs['mesh']['model_tp_sp']}")
    _check_held("mesh", row)
    del batches, batch, finals

    # 6e. llama_captured: multi_step_fn(LLAMA_K) of the m435 AdamW step as one
    # CUDA graph, against as many eager steps from the same state, on one
    # repeated batch.
    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0,
        log_every=1), device="cuda")
    one = next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size, batch_size=8).batches(1))
    xs, ys = device_put_batch(next(stack_batches(iter([one] * LLAMA_K), LLAMA_K)),
                              torch.device("cuda"))
    eager_state = trainer.init(seed=0)
    p0 = _param_copy(eager_state.model)
    eager, eager_ms = [], []
    for i in range(LLAMA_K):
        t0 = time.perf_counter()
        eager_state, m = trainer.train_step(eager_state, xs[i], ys[i])
        eager.append(m["loss"].item())
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    eager_final = _param_copy(eager_state.model)
    del eager_state, m
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init(seed=0)
    kfn = trainer.multi_step_fn(LLAMA_K)
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    state, captured = kfn(state, xs, ys)
    captured = captured.tolist()
    capture_s = time.perf_counter() - t0
    held = _held_runs(captured, eager, _param_gap(_param_copy(state.model), eager_final, p0),
                      _param_gap(p0, eager_final, p0), LLAMA_CAPTURE_RTOL)
    del p0, eager_final
    launches = dict(kernels_mod.launch_counts)
    launches_by_path["llama_captured"] = launches.get("flash_attention_fwd", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LLAMA_REPLAYS):
        state, losses = kfn(state, xs, ys)
        losses.tolist()
    step_ms = (time.perf_counter() - t0) * 1e3 / (LLAMA_REPLAYS * LLAMA_K)
    flops = llama.train_flops_per_token(cfg, 2048) * 8 * 2048
    row = {"phase": "llama_captured", "k": LLAMA_K, "replays": LLAMA_REPLAYS,
           "eager_losses": eager, "captured_losses": captured, **held,
           "bitwise_equal": captured == eager,
           "first_call_s": capture_s, "captures": kfn.captures,
           "step_ms": step_ms, "eager_step_ms": eager_ms,
           "eager_steady_step_ms": statistics.median(eager_ms[1:]),
           "tokens_per_s": 8 * 2048 / step_ms * 1e3, "mfu": flops / (step_ms / 1e3) / peak_flops,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches_in_warmup_and_capture": launches,
           "replay_launches": "not counted: a replay launches no wrapper", "nvidia_smi": smi}
    _emit(row)
    _require(kfn.captures == 1, f"llama_captured: {kfn.captures} captures")
    _check_held("llama_captured", row)
    _flash_check(launches, 1 + LLAMA_K, flash_per_step, "llama_captured (warm-up + capture)")
    del trainer, state, kfn, xs, ys
    torch.cuda.empty_cache()
    return launches_by_path


def _serve_phase(torch, kernels_mod, smi: str, peak_bw: float) -> dict:
    """Phase 8: the serving path at Llama-3-8B (see the module docstring).
    Emits the ``serve_parity``, ``serve_graph``, ``profile`` and ``serve``
    lines; returns the ``serve`` line."""
    from deeplearning_cfn_tpu_torch.models import llama, llama_decode
    from deeplearning_cfn_tpu_torch.serve import (
        ContinuousBatchingEngine,
        ServeConfig,
        ServeRequest,
        TrafficConfig,
        generate_traffic,
    )
    from deeplearning_cfn_tpu_torch.serve import engine as serve_engine
    from deeplearning_cfn_tpu_torch.serve.paged_cache import PagedKVCache, init_paged_cache

    base = llama.LlamaConfig.llama3_8b()

    # 1. Parity in f32 (TF32 off since phase 1), 8B widths at two layers:
    # the engine's greedy tokens, one request admitted mid-flight, against
    # generate; then teacher-forced paged decode logits against the forward.
    cfg32 = dataclasses.replace(base, n_layers=PARITY_LAYERS, dtype=torch.float32)
    model32 = _llama_on_card(torch, llama, cfg32, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg32.vocab_size, (2, PARITY_PROMPT), device="cuda",
                            generator=gen, dtype=torch.int32)
    ref = llama_decode.generate(model32, prompts, max_new_tokens=PARITY_NEW)
    bs = SERVE_SLOTS["block_size"]
    pcfg = ServeConfig(num_slots=2, block_size=bs, prefill_len=PARITY_PROMPT,
                       blocks_per_slot=(PARITY_PROMPT + PARITY_NEW) // bs)
    host = prompts.cpu().numpy()
    engine = ContinuousBatchingEngine(model32, pcfg, clock=time.monotonic, journal=False,
                                      name="parity")
    engine.submit(ServeRequest("p0", host[0], PARITY_NEW))
    done, i = {}, 0
    while i <= 3 or engine.pending():
        if i == 3:  # joins the in-flight batch
            engine.submit(ServeRequest("p1", host[1], PARITY_NEW))
        for c in engine.step():
            done[c.request_id] = c
        i += 1
    tokens_equal = [done["p0"].tokens, done["p1"].tokens] == ref.cpu().tolist()
    seq = torch.cat([prompts[:1], ref[:1]], dim=1)  # [1, 96]
    with torch.no_grad():
        full = llama.forward(model32, seq)[0]
    cache = init_paged_cache(cfg32, pcfg.blocks_per_slot, bs, "cuda")
    table = torch.arange(pcfg.blocks_per_slot, device="cuda")
    serve_engine.paged_prefill(model32, cache, seq[:, :PARITY_PROMPT], PARITY_PROMPT, table)
    errs = []
    for pos in range(PARITY_PROMPT, PARITY_PROMPT + PARITY_NEW):
        logits = serve_engine.paged_decode_logits(
            model32, cache, seq[0, pos : pos + 1], torch.tensor([pos], device="cuda"),
            table[None], torch.tensor([True], device="cuda"))
        errs.append((logits[0] - full[pos]).abs().max().item())
    parity = {"phase": "serve_parity", "dtype": "float32", "layers": PARITY_LAYERS,
              "prompt": PARITY_PROMPT, "new_tokens": PARITY_NEW, "mid_flight_admission": True,
              "decode_captures": engine.decode_captures, "tokens_equal_generate": tokens_equal,
              "teacher_forced_max_abs_err": max(errs), "atol": SERVE_LOGITS_ATOL,
              "logits_max_abs": full.abs().max().item()}
    _emit(parity)
    _require(tokens_equal, "serve: the engine's greedy tokens differ from generate's")
    _require(max(errs) <= SERVE_LOGITS_ATOL, f"serve: teacher-forced logits error {max(errs)}")
    del model32, engine, cache, full, seq
    torch.cuda.empty_cache()

    # 2. Llama-3-8B in bf16 at full depth: one decode step by graph replay
    # against the eager step on a copy of the pool, same inputs.
    model = _llama_on_card(torch, llama, base, seed=0)
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    scfg = ServeConfig(**SERVE_SLOTS)
    traffic = generate_traffic(TrafficConfig(vocab_size=base.vocab_size, **SERVE_TRAFFIC))

    def fresh(requests):
        return [ServeRequest(r.request_id, r.prompt.copy(), r.max_new_tokens) for r in requests]

    t0 = time.perf_counter()
    check = ContinuousBatchingEngine(model, scfg, clock=time.monotonic, journal=False,
                                     name="graph-check")
    capture_s = time.perf_counter() - t0
    for r in fresh(traffic[: scfg.num_slots]):
        check.submit(r)
    for _ in range(2):  # admit (prefill) all slots, two replayed steps
        check.step()
    inputs = check.decode_inputs()
    tensors = [torch.from_numpy(a).to("cuda") for a in inputs]
    eager_cache = PagedKVCache(k=check.cache.k.clone(), v=check.cache.v.clone())
    eager_tokens, _ = serve_engine.paged_decode_step(model, eager_cache, *tensors)
    replay_tokens = check.decode(inputs)
    torch.cuda.synchronize()
    graph = {"phase": "serve_graph", "dtype": "bfloat16", "layers": base.n_layers,
             "active_slots": int(inputs[3].sum()), "capture_s": capture_s,
             "tokens_equal": eager_tokens.cpu().tolist() == replay_tokens.tolist(),
             "pool_equal": bool(torch.equal(check.cache.k, eager_cache.k)
                                and torch.equal(check.cache.v, eager_cache.v))}
    # Every step rewrites the same positions with the same values from here.
    replay = lambda: check.captured(*inputs)  # noqa: E731
    eager = lambda: serve_engine.paged_decode_logits(model, eager_cache, *tensors)  # noqa: E731
    kv_bytes = (int((inputs[1] + 1)[inputs[3]].sum()) * base.n_layers * 2
                * base.n_kv_heads * base.head_dim * 2)
    gathered_bytes = (scfg.num_slots * scfg.max_context * base.n_layers * 2
                      * base.n_kv_heads * base.head_dim * 2)
    step_weight_bytes = (weight_bytes - model.embed.numel() * model.embed.element_size()
                         + scfg.num_slots * base.dim * 2)
    # The host's clock around a whole engine decode: inputs copied in, the
    # replay, sampling, the tokens back on the host.
    t0 = time.perf_counter()
    for _ in range(10):
        check.decode(inputs)
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    graph.update({
        "decode_step_ms": _device_ms(torch, replay, iters=10),
        "decode_step_event_ms": _time_ms(torch, replay, iters=10),
        "decode_step_host_ms": host_ms,
        "eager_step_ms": _time_ms(torch, eager, iters=5, warmup=1),
        "eager_step_device_ms": _device_ms(torch, eager, iters=5, warmup=1),
        "eager_step_host_ms": _host_ms(torch, eager, iters=5, warmup=1),
        "decode_weight_bytes": step_weight_bytes, "decode_kv_bytes": kv_bytes,
        "decode_kv_gathered_bytes": gathered_bytes,
        "decode_bound_ms": (step_weight_bytes + kv_bytes) / peak_bw * 1e3,
        "decode_bound_by": "bytes",
    })
    _emit(graph)
    _require(graph["tokens_equal"] and graph["pool_equal"],
             "serve: the replayed decode step differs from the eager step")
    _emit({"phase": "profile", "path": "serve_decode_replay",
           **_profile(torch, lambda: check.decode(inputs), 5)})
    _emit({"phase": "profile", "path": "serve_decode_eager", **_profile(torch, eager, 2)})
    del check, eager_cache, tensors
    torch.cuda.empty_cache()

    # 3. The serving run: 16 requests in one burst on the wall clock.
    engine = ContinuousBatchingEngine(model, scfg, clock=time.monotonic, journal=False,
                                      name="serve0")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launch_counts()
    requests = fresh(traffic)
    for r in requests:
        engine.submit(r)
    t0 = time.monotonic()
    done, decode_s, decode_tokens = {}, 0.0, 0
    while engine.pending():
        prefills, active = engine.prefills, engine.active_slots
        ts = time.perf_counter()
        for c in engine.step():
            done[c.request_id] = c
        if engine.prefills == prefills:  # a decode-only step
            decode_s += time.perf_counter() - ts
            decode_tokens += active
    wall_s = time.monotonic() - t0
    launches = dict(kernels_mod.launch_counts)
    snap = engine.snapshot()
    peak_mem = torch.cuda.max_memory_allocated()
    row = {"phase": "serve", "model": "llama3_8b", "layers": base.n_layers, "dtype": "bfloat16",
           "serve_config": SERVE_SLOTS, "traffic": SERVE_TRAFFIC, "nvidia_smi": smi,
           "completed": len(done), "steps": snap["steps"], "wall_s": wall_s,
           "tokens_out": snap["tokens_out"], "tokens_per_s": snap["tokens_per_s"],
           "decode_tokens_per_s": decode_tokens / decode_s if decode_s else None,
           "ttft_ms": snap["ttft_ms"], "itl_ms": snap["itl_ms"],
           "free_blocks": snap["free_blocks"], "recycled_blocks": snap["recycled_blocks"],
           "decode_captures": snap["decode_captures"], "launches": launches,
           "max_memory_allocated_bytes": peak_mem, "weights_gb": weight_bytes / 1e9,
           "pool_gb": (engine.cache.k.nbytes + engine.cache.v.nbytes) / 1e9}
    row.update({k: graph[k] for k in (
        "decode_step_ms", "decode_step_event_ms", "decode_step_host_ms", "eager_step_ms",
        "eager_step_device_ms", "eager_step_host_ms", "decode_bound_ms", "decode_bound_by")})
    # Every prompt is padded to prefill_len, so one prefill costs the same at
    # any prompt length: timed on the first request's prompt, into free pages.
    first = traffic[0]
    padded = torch.zeros((1, scfg.prefill_len), dtype=torch.int32)
    padded[0, : first.prompt.size] = torch.from_numpy(first.prompt)
    padded = padded.cuda()
    blocks = torch.arange(scfg.blocks_per_slot, device="cuda")
    prefill = lambda: serve_engine.paged_prefill(  # noqa: E731
        model, engine.cache, padded, int(first.prompt.size), blocks)
    row["prefill_ms"] = _time_ms(torch, prefill, iters=3, warmup=1)
    row["prefill_device_ms"] = _device_ms(torch, prefill, iters=3, warmup=1)
    _emit(row)
    _require(row["completed"] == len(traffic), f"serve: {row['completed']} of {len(traffic)} done")
    _require(all(len(done[r.request_id].tokens) == r.max_new_tokens for r in traffic),
             "serve: a completion has another token count than requested")
    _require(all(0 <= t < base.vocab_size for c in done.values() for t in c.tokens),
             "serve: a token outside the vocabulary")
    _require(row["free_blocks"] == scfg.resolved_num_blocks, "serve: pages not recycled")
    _require(row["decode_captures"] == 1, f"serve: {row['decode_captures']} decode captures")
    _require(sum(launches.get(k, 0) for k in kernels_mod._KERNELS) == 0,
             f"serve: the serving path launched a kernel of the port: {launches}")
    del engine, model
    torch.cuda.empty_cache()
    return row


def _resnet_phase(torch, kernels_mod, smi: str, peak_flops: float) -> dict:
    """Phase 9: ResNet-50 training (see the module docstring).  Emits the
    ``resnet_parity``, ``resnet_example``, ``resnet`` (one a head), ``profile``,
    ``resnet_captured``, ``resnet_prefetch`` and ``resnet_eval`` lines;
    returns the fused-dense launches of the kernel head's eager run."""
    from deeplearning_cfn_tpu_torch.examples import resnet_imagenet
    from deeplearning_cfn_tpu_torch.models import resnet
    from deeplearning_cfn_tpu_torch.ops import fused_dense as fd
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    ds = SyntheticDataset.imagenet_like(batch_size=RESNET_BATCH, image_size=RESNET_IMAGE,
                                        dtype="uint8", pool_batches=RESNET_POOL)
    cfg = TrainerConfig(learning_rate=0.1, has_train_arg=True, label_smoothing=0.1,
                        input_stats=ds.input_stats, log_every=1)
    shape = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)

    def make(pallas: bool, dtype=torch.bfloat16) -> Trainer:
        arch = dict(stage_sizes=(3, 4, 6, 3), dtype=dtype, use_pallas_head=pallas)
        return Trainer(lambda gen: resnet.ResNet(**arch, generator=gen), cfg, device="cuda",
                       analytic_flops_fn=lambda x: resnet.train_flops(arch, x.shape))

    pool = list(ds.batches(RESNET_POOL))
    x0, y0 = device_put_batch(pool[0], torch.device("cuda"))

    # 1. Parity in f32 (TF32 off since phase 1), one batch, the same state:
    # the kernel head's logits and head gradients against the plain fused
    # dense's (force_reference), in eval mode (no statistic moves).
    trainer = make(True, torch.float32)
    state = trainer.init(seed=0)
    model = state.model
    grads, logits = {}, {}
    for path in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        with fd.force_reference() if path == "plain" else contextlib.nullcontext():
            out = model(trainer._normalize_input(x0), train=False)
            torch.nn.functional.cross_entropy(out, y0.long()).backward()
        logits[path] = out.detach()
        grads[path] = {n: getattr(model.head, n).grad.clone() for n in ("kernel", "bias")}
    rtol, atol = DENSE_TOL["float32"]
    grtol, gatol = GRAD_TOL["float32"]
    err = (logits["kernel"] - logits["plain"]).abs()
    gerr = {n: (grads["kernel"][n] - grads["plain"][n]).abs() for n in grads["kernel"]}
    parity = {"phase": "resnet_parity", "dtype": "float32", "B": RESNET_BATCH,
              "logits_max_abs_err": err.max().item(), "rtol": rtol, "atol": atol,
              "logits_within": bool((err <= atol + rtol * logits["plain"].abs()).all()),
              "grad_max_abs_err": {n: e.max().item() for n, e in gerr.items()},
              "grad_rtol": grtol, "grad_atol": gatol,
              "grad_within": all(bool((gerr[n] <= gatol + grtol * grads["plain"][n].abs()).all())
                                 for n in gerr),
              "logits_max_abs": logits["plain"].abs().max().item()}
    _emit(parity)
    _require(parity["logits_within"], "resnet: kernel-head logits off the plain head's")
    _require(parity["grad_within"], "resnet: kernel-head gradients off the plain head's")
    del trainer, state, model, grads, logits, out, err, gerr
    torch.cuda.empty_cache()

    # 2. The example, as a user runs it, with the kernel head: its own
    # synthetic stream (f32 images, as the JAX example's), its trainer, fit
    # with two producers, then one held-out eval batch.
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = resnet_imagenet.main([
        "--depth", "50", "--global_batch_size", str(RESNET_BATCH),
        "--image_size", str(RESNET_IMAGE), "--steps", str(RESNET_EXAMPLE_STEPS),
        "--log_every", "1", "--eval_steps", "1", "--prefetch_workers", "2",
        "--use_pallas_head", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(kernels_mod.launch_counts)
    example = {"phase": "resnet_example", "args": "--depth 50 --use_pallas_head",
               "steps": result["steps"], "final_loss": result["final_loss"],
               "losses": [h["loss"] for h in result["history"]],
               "step_ms": [RESNET_BATCH / h["examples_per_sec"] * 1e3 for h in result["history"]],
               "eval": result["eval"], "params": result["params"],
               "first_step_s": result["first_step_s"], "wall_s": time.perf_counter() - t0,
               "launches": launches}
    _emit(example)
    _require(result["steps"] == RESNET_EXAMPLE_STEPS
             and all(math.isfinite(v) for v in example["losses"])
             and math.isfinite(result["eval"]["loss"]), f"resnet example: {example}")
    _require(_variants(launches, "fused_dense") == {F32_SPLITK: RESNET_EXAMPLE_STEPS + 1},
             f"resnet example: the kernel head launched {launches}, expected one "
             f"{F32_SPLITK} a step and one for the eval batch")
    del result
    torch.cuda.empty_cache()

    # 3. Eager training, kernel head then plain head, through fit (prefetcher
    # with two producers over the pooled uint8 stream; a readback each step,
    # so each logged step time is the step's whole time).
    runs, kernel_launches = {}, {}
    steps = RESNET_WARMUP + RESNET_STEPS
    for path, pallas in (("kernel", True), ("plain", False)):
        trainer = make(pallas)
        state = trainer.init(seed=0)
        logger = trainer.throughput_logger(pool[0].x, RESNET_BATCH, name="resnet50", log_every=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        state, losses = trainer.fit(state, ds.batches(steps), steps=steps, logger=logger,
                                    prefetch_workers=2)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(kernels_mod.launch_counts)
        steady = logger.history[RESNET_WARMUP:]
        rate = statistics.median(h["examples_per_sec"] for h in steady)
        run = {"phase": "resnet", "head": path, "model": "resnet50", "dtype": "bfloat16",
               "batch": RESNET_BATCH, "image": RESNET_IMAGE, "steps": steps,
               "losses": losses, "step_ms": [RESNET_BATCH / h["examples_per_sec"] * 1e3
                                             for h in logger.history],
               "steady_step_ms": RESNET_BATCH / rate * 1e3, "images_per_s": rate,
               "mfu": statistics.median(h["mfu"] for h in steady),
               "flops_per_step": logger.flops_per_step, "peak_flops": peak_flops,
               "first_step_s": trainer.first_step_seconds, "wall_s": wall_s,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               "fused_dense_launches_per_step": launches["fused_dense"] / steps,
               "pipeline": trainer.last_pipeline_stats.snapshot(), "nvidia_smi": smi}
        _emit(run)
        _require(len(losses) == steps and all(math.isfinite(v) for v in losses),
                 f"resnet ({path}): non-finite loss")
        _require(statistics.mean(losses[-3:]) < statistics.mean(losses[:3]),
                 f"resnet ({path}): the loss did not fall: {losses}")
        if pallas:
            kernel_launches = launches
            _require(launches["fused_dense"] == steps
                     and _variants(launches, "fused_dense") == {F32_SPLITK: steps},
                     f"resnet: the kernel head launched {launches}, expected one "
                     f"{F32_SPLITK} a step")
            _require(run["pipeline"]["batches"] == steps, "resnet: prefetcher batch count")
            _emit({"phase": "resnet_prefetch", "workers": 2, **run["pipeline"]})
        else:
            _require(launches["fused_dense"] == 0, "resnet: the plain head ran the kernel")
        x, y = device_put_batch(pool[1], torch.device("cuda"))

        def step():
            nonlocal state
            state, _ = trainer.train_step(state, x, y)

        _emit({"phase": "profile", "path": "resnet50", "head": path, **_profile(torch, step, 2)})
        runs[path] = run
        if not pallas:
            # 4. Eval on two held-out batches, eval mode, running statistics.
            held_out = SyntheticDataset(shape=shape[1:], num_classes=1000,
                                        batch_size=RESNET_BATCH, seed=10_000, template_seed=0,
                                        dtype="uint8")
            ev = trainer.evaluate(state, held_out.batches(2), steps=2)
            _emit({"phase": "resnet_eval", **ev})
            _require(math.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 1.0
                     and ev["examples"] == 2 * RESNET_BATCH, f"resnet eval: {ev}")
        del trainer, state, logger, x, y
        torch.cuda.empty_cache()

    # 5. multi_step_fn(RESNET_K) captured as one CUDA graph, against as many
    # eager steps from the same state on the same stacked batches; then
    # replays timed on the host's clock (each call ends in a readback).
    stack = next(stack_batches(iter(pool), RESNET_K))
    xs, ys = device_put_batch(stack, torch.device("cuda"))
    for path, pallas in (("kernel", True), ("plain", False)):
        trainer = make(pallas)
        eager_state = trainer.init(seed=0)
        eager = []
        for i in range(RESNET_K):
            eager_state, m = trainer.train_step(eager_state, xs[i], ys[i])
            eager.append(m["loss"])
        eager = torch.stack(eager).tolist()
        del eager_state
        torch.cuda.empty_cache()
        state = trainer.init(seed=0)
        kfn = trainer.multi_step_fn(RESNET_K)
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        state, captured = kfn(state, xs, ys)
        captured = captured.tolist()
        capture_s = time.perf_counter() - t0
        launches = dict(kernels_mod.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RESNET_REPLAYS):
            state, losses = kfn(state, xs, ys)
            losses.tolist()
        step_ms = (time.perf_counter() - t0) * 1e3 / (RESNET_REPLAYS * RESNET_K)
        rel = max(abs(a - b) / abs(b) for a, b in zip(captured, eager))
        row = {"phase": "resnet_captured", "head": path, "k": RESNET_K,
               "replays": RESNET_REPLAYS, "eager_losses": eager, "captured_losses": captured,
               "max_rel_diff": rel, "rtol": RESNET_CAPTURE_RTOL,
               "bitwise_equal": captured == eager, "first_call_s": capture_s,
               "captures": kfn.captures, "step_ms": step_ms,
               "images_per_s": RESNET_BATCH / step_ms * 1e3,
               "mfu": runs[path]["flops_per_step"] / (step_ms / 1e3) / peak_flops,
               "launches_in_warmup_and_capture": launches,
               "replay_launches": "not counted: a replay launches no wrapper"}
        _emit(row)
        _require(rel <= RESNET_CAPTURE_RTOL, f"resnet ({path}): captured losses {captured} "
                 f"off the eager {eager}")
        _require(kfn.captures == 1, f"resnet ({path}): {kfn.captures} captures")
        if pallas:
            _require(_variants(launches, "fused_dense") == {F32_SPLITK: 1 + RESNET_K},
                     f"resnet: the captured kernel head launched {launches}, expected one "
                     f"warm-up and {RESNET_K} captured {F32_SPLITK} launches")
        runs[path]["captured"] = row
        del trainer, state, kfn
        torch.cuda.empty_cache()
    del xs, ys, x0, y0
    torch.cuda.empty_cache()
    return kernel_launches


def _state_copy(state) -> dict:
    """Every tensor of a TrainState's state dict (parameters, buffers,
    optimizer state, step), copied, by path."""
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif hasattr(t, "detach"):
            out[prefix] = t.detach().clone()

    walk("", state.state_dict())
    return out


def _unequal(a: dict, b: dict) -> list:
    """The paths whose tensors are not bitwise equal (or missing)."""
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not bool((a[k] == b[k]).all()))


class _StepClock:
    """A ``fit`` logger that times each step on the host's clock (fit calls
    it after each step, before that step's checkpoint save; the loss
    readback is the sync), and copies the parameters at the steps asked."""

    def __init__(self, model, copies=()):
        self.model, self.at, self.copies, self.ms = model, set(copies), {}, []
        self._t = time.perf_counter()

    def resume(self, step: int) -> None:
        """Nothing to re-anchor: each step is timed from the one before."""

    def step(self, step: int, loss) -> None:
        float(loss)
        now = time.perf_counter()
        self.ms.append((now - self._t) * 1e3)
        if step in self.at:
            self.copies[step] = _param_copy(self.model)
        self._t = time.perf_counter()


def _checkpoint_phase(torch, kernels_mod, smi: str) -> dict:
    """Phase 10: checkpoint and resume (see the module docstring).  Emits
    ``checkpoint_llama``, ``checkpoint_async``, ``checkpoint_resnet``,
    ``checkpoint_captured`` and ``checkpoint_example`` (one an example);
    returns the launches of the resumed runs, by kernel."""
    import itertools
    import shutil
    import tempfile

    from deeplearning_cfn_tpu_torch.examples import llama_train, resnet_imagenet
    from deeplearning_cfn_tpu_torch.models import llama, resnet
    from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticDataset,
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig, _make_optimizer

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt-"))
    launches: dict = {}
    try:
        free = shutil.disk_usage(root).free
        _emit({"phase": "checkpoint_disk", "dir": str(root), "free_bytes": free})
        _require(free > CKPT_DISK_BYTES, f"checkpoint: {free} bytes free under {root}, "
                 f"the phase writes up to {CKPT_DISK_BYTES}")

        # (a) Llama m435 across a synchronous save and a restore into a fresh
        # trainer from another seed, fed the straight run's batches 5-8.
        cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=2048), n_layers=CKPT_LAYERS)
        tcfg = TrainerConfig(strategy="fsdp", optimizer="adamw", learning_rate=3e-4,
                             weight_decay=0.1, grad_clip_norm=1.0, log_every=1)
        batches = list(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size,
                                             batch_size=8).batches(CKPT_STEPS))
        half = CKPT_STEPS // 2

        def run(state, trainer, part, ckpt=None, copies=()):
            """fit over ``part`` (a readback a step): the losses, each step's
            wall time (a checkpoint saved after a step is in the next one's),
            and the parameters copied at the steps in ``copies``."""
            clock = _StepClock(state.model, copies)
            state, losses = trainer.fit(state, iter(part), steps=len(part), logger=clock,
                                        checkpointer=ckpt, prefetch=0)
            return state, losses, clock.ms, clock.copies

        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=0)
        p0 = _param_copy(state.model)
        state, straight, straight_ms, _ = run(state, trainer, batches)
        straight_state = _state_copy(state)
        del state, trainer
        torch.cuda.empty_cache()

        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=0)
        state, first, _, _ = run(state, trainer, batches[:half])
        at_half = _state_copy(state)
        sync = Checkpointer(root / "llama", interval_s=None, async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync.save(state.step, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        saved = sync.last_save
        del state, trainer, sync
        torch.cuda.empty_cache()

        # (b) The same run through fit with async saves every 2 steps; the
        # parameters copied at steps 6 and 8 (before their saves), which
        # steps 7 and 8 then update in place while step 6 is written.
        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=0)
        ck = Checkpointer(root / "llama_async", interval_s=None, every_steps=2, max_to_keep=2,
                          async_save=True)
        saves = []
        record = ck.save  # each save's record, completed when it commits

        def save(step, st):
            record(step, st)
            saves.append(ck.last_save)

        ck.save = save
        state, async_losses, async_ms, copies = run(state, trainer, batches, ck, copies=(6, 8))
        t0 = time.perf_counter()
        ck.wait()
        tail_wait_ms = (time.perf_counter() - t0) * 1e3
        row_async = {"phase": "checkpoint_async", "every_steps": 2, "steps": CKPT_STEPS,
                     "saves": saves, "tail_wait_ms": tail_wait_ms,
                     "step_ms_with_async": async_ms, "step_ms_without": straight_ms,
                     "median_step_ms_with_async": statistics.median(async_ms[1:]),
                     "median_step_ms_without": statistics.median(straight_ms[1:]),
                     "losses_bitwise_equal_straight": async_losses == straight}
        at_6, at_8 = copies[6], copies[8]
        del state, trainer, ck, copies
        torch.cuda.empty_cache()

        # The fresh trainer, from another seed: restore, check that no weight
        # moved on the way in (nothing but the load may write them), 4 steps.
        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, step = Checkpointer(root / "llama").restore_latest(state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        restored_unequal = _unequal(_state_copy(state), at_half)
        kernels_mod.reset_launch_counts()
        state, rest, rest_ms, _ = run(state, trainer, batches[half:])
        launches["flash_attention_fwd"] = kernels_mod.launch_counts.get("flash_attention_fwd", 0)
        flash = _flash_check(dict(kernels_mod.launch_counts), CKPT_STEPS - half,
                             2 * cfg.n_layers, "checkpoint (resumed m435)")
        resumed_unequal = _unequal(_state_copy(state), straight_state)
        resumed_final = _param_copy(state.model)
        del state, trainer
        torch.cuda.empty_cache()

        # The planted control: the model restored alone, a fresh optimizer.
        trainer = llama.make_trainer(cfg, tcfg, device="cuda")
        state = trainer.init(seed=2)
        Checkpointer(root / "llama").restore_latest(state)
        state.optimizer = _make_optimizer(state.model, tcfg, trainer._leaves(state.model))
        state, control, _, _ = run(state, trainer, batches[half:])
        control_gap = _param_gap(_param_copy(state.model), resumed_final, p0)
        del state, trainer
        torch.cuda.empty_cache()
        row = {"phase": "checkpoint_llama", "model": "m435", "n_layers": cfg.n_layers,
               "seq": 2048, "batch": 8,
               "optimizer": "adamw", "steps": [half, CKPT_STEPS - half],
               "straight_losses": straight, "resumed_losses": first + rest,
               "losses_bitwise_equal": first + rest == straight,
               "restored_state_unequal": restored_unequal,
               "final_state_unequal": resumed_unequal, "restored_step": step,
               "bytes": saved.get("bytes"), "staged_bytes": saved["staged_bytes"],
               "save_ms": save_ms, "save_staging_ms": saved["staging_ms"],
               "save_write_s": saved["write_s"], "restore_ms": restore_ms,
               "first_save_of_a_checkpointer": "staging allocates its pinned host buffers",
               "step_ms_straight": straight_ms, "step_ms_resumed": rest_ms, **flash,
               "control": {"what": "the model restored, the optimizer fresh",
                           "losses": first + control,
                           "max_rel_loss_diff": max(abs(a - b) / abs(b) for a, b in
                                                    zip(control, straight[half:])),
                           **control_gap},
               "nvidia_smi": smi}
        _emit(row)
        _require(step == half and not restored_unequal,
                 f"checkpoint: the restored m435 state differs at {restored_unequal[:5]}")
        _require(row["losses_bitwise_equal"] and not resumed_unequal,
                 f"checkpoint: the resumed m435 run differs from the straight one at "
                 f"{resumed_unequal[:5]}: {first + rest} against {straight}")
        _require(control_gap["param_gap_max"] > PARAM_GAP_MAX,
                 f"checkpoint: the planted control (fresh optimizer) lies within "
                 f"{PARAM_GAP_MAX} of the resumed run: {control_gap}")
        del straight_state, at_half, resumed_final, p0

        # (b)'s gate: each async checkpoint holds the parameters of its step.
        ck = Checkpointer(root / "llama_async")
        row_async["committed_steps"] = ck.all_steps()
        unequal = {}
        for step, want in ((6, at_6), (8, at_8)):
            t0 = time.perf_counter()
            sd, _ = ck.restore_raw(step)
            row_async.setdefault("raw_restore_ms", []).append((time.perf_counter() - t0) * 1e3)
            unequal[step] = sorted(n for n, w in want.items()
                                   if not torch.equal(sd["model"][n], w.cpu()))
            del sd
        row_async["params_unequal"] = unequal
        row_async["nvidia_smi"] = smi
        _emit(row_async)
        _require(row_async["committed_steps"] == [6, 8], f"checkpoint async: {row_async}")
        _require(not unequal[6] and not unequal[8],
                 f"checkpoint async: a checkpoint differs from its step's parameters: {unequal}")
        _require(row_async["losses_bitwise_equal_straight"],
                 "checkpoint async: the run with saves differs from the straight run")
        del at_6, at_8, ck
        shutil.rmtree(root / "llama")
        shutil.rmtree(root / "llama_async")
        torch.cuda.empty_cache()

        # (c) ResNet-50 at bench.py's configuration, the kernel head: 2 + 2
        # steps across a restore against 4 straight.  cuDNN deterministic, so
        # that two runs of the same steps may be held bitwise.
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            ds = SyntheticDataset.imagenet_like(batch_size=RESNET_BATCH, image_size=RESNET_IMAGE,
                                                dtype="uint8", pool_batches=RESNET_POOL)
            rcfg = TrainerConfig(learning_rate=0.1, has_train_arg=True, label_smoothing=0.1,
                                 input_stats=ds.input_stats, log_every=1)
            arch = dict(stage_sizes=(3, 4, 6, 3), dtype=torch.bfloat16, use_pallas_head=True)

            def make():
                return Trainer(lambda gen: resnet.ResNet(**arch, generator=gen), rcfg,
                               device="cuda")

            t = make()
            state, straight = t.fit(t.init(seed=0), ds.batches(4), steps=4)
            straight_state = _state_copy(state)
            del state, t
            t = make()
            state, first = t.fit(t.init(seed=0), ds.batches(2), steps=2)
            at_2 = _state_copy(state)
            sync = Checkpointer(root / "resnet", interval_s=None, async_save=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sync.save(state.step, state)
            rsave_ms = (time.perf_counter() - t0) * 1e3
            rsaved = dict(sync.last_save)
            del state, t
            t = make()
            state = t.init(seed=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Checkpointer(root / "resnet").restore_latest(state)
            torch.cuda.synchronize()
            rrestore_ms = (time.perf_counter() - t0) * 1e3
            kernels_mod.reset_launch_counts()
            state, rest = t.fit(state, itertools.islice(ds.batches(4), 2, None), steps=2)
            head = dict(kernels_mod.launch_counts)
            launches["fused_dense_f32"] = sum(_variants(head, "fused_dense").values())
            unequal = _unequal(_state_copy(state), straight_state)
            del state, t
            row = {"phase": "checkpoint_resnet", "model": "resnet50", "dtype": "bfloat16",
                   "batch": RESNET_BATCH, "image": RESNET_IMAGE, "steps": [2, 2],
                   "straight_losses": straight, "resumed_losses": first + rest,
                   "losses_bitwise_equal": first + rest == straight,
                   "final_state_unequal": unequal,
                   "batchnorm_statistics": sum(k.endswith((".mean", ".var"))
                                               for k in straight_state),
                   "momentum_traces": sum("momentum_buffer" in k for k in straight_state),
                   "bytes": rsaved.get("bytes"), "staged_bytes": rsaved["staged_bytes"],
                   "save_ms": rsave_ms, "restore_ms": rrestore_ms, "launches": head,
                   "nvidia_smi": smi}
            _emit(row)
            _require(row["losses_bitwise_equal"] and not unequal,
                     f"checkpoint: the resumed ResNet-50 run differs at {unequal[:5]}")
            _require(_variants(head, "fused_dense") == {F32_SPLITK: 2},
                     f"checkpoint: the resumed ResNet-50 head launched {head}")

            # Capture, restore, replay: the graph captured on a state before
            # a restore replays on the restored values (in place), equal to
            # eager steps from the restored state.
            pool = list(ds.batches(2 * 2))
            stacks = [device_put_batch(s, torch.device("cuda"))
                      for s in stack_batches(iter(pool), 2)]
            t = make()
            state = t.init(seed=3)
            kfn = t.multi_step_fn(2)
            state, _ = kfn(state, *stacks[0])  # the capture, on the seed-3 state
            Checkpointer(root / "resnet").restore_latest(state)
            restored_ok = not _unequal(_state_copy(state), at_2)
            state, replayed = kfn(state, *stacks[1])
            replayed = replayed.tolist()
            replay_state = _state_copy(state)
            del state
            state = t.init(seed=4)
            Checkpointer(root / "resnet").restore_latest(state)
            eager = []
            for i in range(2):
                state, m = t.train_step(state, stacks[1][0][i], stacks[1][1][i])
                eager.append(m["loss"].item())
            unequal = _unequal(replay_state, _state_copy(state))
            row = {"phase": "checkpoint_captured", "k": 2, "captures": kfn.captures,
                   "restored_in_place_equal": restored_ok, "replayed_losses": replayed,
                   "eager_losses": eager, "losses_bitwise_equal": replayed == eager,
                   "final_state_unequal": unequal, "nvidia_smi": smi}
            _emit(row)
            _require(kfn.captures == 1 and restored_ok, f"checkpoint captured: {row}")
            _require(replayed == eager and not unequal,
                     f"checkpoint: the replay after a restore differs from eager steps from the "
                     f"restored state at {unequal[:5]}: {replayed} against {eager}")
            del state, t, kfn, stacks, pool, straight_state, at_2
        finally:
            torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root / "resnet")
        torch.cuda.empty_cache()

        # (d) The examples, as a user runs them twice with --checkpoint_dir.
        for name, main, argv in (
                ("llama_train", llama_train.main, SLICE_ARGS[:SLICE_ARGS.index("--steps")]
                 + ["--steps", str(CKPT_EXAMPLE_STEPS), "--log_every", "1", "--device", "cuda"]),
                ("resnet_imagenet", resnet_imagenet.main,
                 ["--depth", "50", "--global_batch_size", str(RESNET_BATCH), "--image_size",
                  str(RESNET_IMAGE), "--steps", str(CKPT_EXAMPLE_STEPS), "--log_every", "1",
                  "--use_pallas_head", "--device", "cuda"])):
            d = root / name
            runs = []
            for _ in range(2):
                t0 = time.perf_counter()
                result = main(argv + ["--checkpoint_dir", str(d)])
                torch.cuda.synchronize()
                runs.append({"start_step": result["start_step"], "end_step": result["end_step"],
                             "losses": [h["loss"] for h in result["history"]],
                             "wall_s": time.perf_counter() - t0})
                torch.cuda.empty_cache()
            row = {"phase": "checkpoint_example", "example": name, "args": argv,
                   "runs": runs, "committed_steps": Checkpointer(d).all_steps()}
            _emit(row)
            n = CKPT_EXAMPLE_STEPS
            _require([r["start_step"] for r in runs] == [0, n]
                     and [r["end_step"] for r in runs] == [n, 2 * n]
                     and row["committed_steps"] == [n, 2 * n]
                     and all(math.isfinite(v) for r in runs for v in r["losses"]),
                     f"checkpoint example {name}: {row}")
            shutil.rmtree(d)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches



def _kernel_free(counts: dict, what: str) -> None:
    """No kernel of the port launched (these paths run none)."""
    _require(not any(counts.values()), f"{what}: kernels launched {counts}")


def _random_norms(torch, model, seed: int) -> None:
    """Every BatchNorm's scale, bias, mean and variance drawn from a seeded
    generator (the initial zero ``bn3`` scales would hide each block's
    residual branch)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            scope, _, leaf = name.rpartition(".")
            if not scope.rpartition(".")[2].startswith("bn"):
                continue
            if leaf in ("weight", "var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            else:
                t.copy_(0.2 * torch.randn(t.shape, generator=gen))


def _detection_phase(torch, kernels_mod, smi: str, peak_flops: float) -> dict:
    """Phase 11: RetinaNet-R50-FPN with the mask head (see the module
    docstring).  Emits ``detection_parity``, ``detection``, ``profile``,
    ``detection_learn``, ``detection_eval`` and ``detection_example``;
    returns the launches of the port's kernels over the phase (none)."""
    import argparse
    import copy
    import shutil
    import tempfile

    from deeplearning_cfn_tpu_torch.examples import detection_train, resnet_imagenet
    from deeplearning_cfn_tpu_torch.models import retinanet
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDetectionDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    cuda = torch.device("cuda")
    launches: dict = {}

    def count(what: str) -> None:
        got = dict(kernels_mod.launch_counts)
        _kernel_free(got, what)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    def stream(batch: int, **kw):
        return SyntheticDetectionDataset(image_size=DET_IMAGE, num_classes=80,
                                         max_boxes=DET_MAX_BOXES, batch_size=batch,
                                         with_masks=True, **kw)

    anchors_cpu = torch.from_numpy(retinanet.generate_anchors(DET_IMAGE))
    anchors = anchors_cpu.to(cuda)

    # 1. Parity in f32 (TF32 off since phase 1): the card's forward against
    # the CPU's on the same weights, then predict on the same head outputs.
    kernels_mod.reset_launch_counts()
    cpu_model = retinanet.RetinaNet(**DET_ARCH, generator=torch.Generator().manual_seed(0))
    _random_norms(torch, cpu_model, 1)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    x = torch.from_numpy(next(iter(stream(2, seed=3).batches(1))).x)
    with torch.no_grad():
        ref = cpu_model(x, train=False)
        got = [t.cpu() for t in card_model(x.to(cuda), train=False)]
    parity = {"phase": "detection_parity", "dtype": "float32", "B": 2, "image": DET_IMAGE,
              "anchors": int(anchors.shape[0]), "rtol_of_max": DET_PARITY_RTOL,
              "mean_rtol_of_max": DET_PARITY_MEAN_RTOL, "outputs": {}}
    for name, r, g in zip(("cls_logits", "box_deltas", "coeffs", "protos"), ref, got):
        err, scale = (g - r).abs(), max(1.0, r.abs().max().item())
        parity["outputs"][name] = {
            "shape": list(r.shape), "max_abs": r.abs().max().item(),
            "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
            "within": err.max().item() <= DET_PARITY_RTOL * scale
            and err.mean().item() <= DET_PARITY_MEAN_RTOL * scale}
    # The class logits moved up by 3 so that many anchors pass the 0.05
    # score threshold (at the prior's bias almost none would).
    head = [ref[0] + 3.0, ref[1], ref[2], ref[3]]
    want = retinanet.predict(head[0], head[1], anchors_cpu, coeffs=head[2], protos=head[3])
    card_head = [t.to(cuda) for t in head]

    def card_predict():
        return retinanet.predict(card_head[0], card_head[1], anchors, coeffs=card_head[2],
                                 protos=card_head[3])

    have = {k: v.cpu() for k, v in card_predict().items()}
    parity["predict"] = {
        "max_detections": 100, "valid_slots": int(want["valid"].sum()),
        "classes_equal": torch.equal(have["classes"], want["classes"]),
        "valid_equal": torch.equal(have["valid"], want["valid"]),
        "score_max_abs_err": (have["scores"] - want["scores"]).abs().max().item(),
        "box_max_abs_err": (have["boxes"] - want["boxes"]).abs().max().item(),
        "box_max_abs": want["boxes"].abs().max().item(),
        "boxes_within": torch.allclose(have["boxes"], want["boxes"], rtol=DET_BOX_RTOL,
                                       atol=DET_BOX_ATOL),
        "mask_pixels_differing": int((have["masks"] != want["masks"]).sum()),
        "score_atol": DET_SCORE_ATOL, "box_rtol": DET_BOX_RTOL, "box_atol": DET_BOX_ATOL,
        "card_ms": _time_ms(torch, card_predict, iters=3)}
    _emit(parity)
    count("detection parity")
    pp = parity["predict"]
    _require(all(o["within"] for o in parity["outputs"].values()),
             f"detection: the card's forward off the CPU's: {parity['outputs']}")
    _require(pp["classes_equal"] and pp["valid_equal"] and pp["valid_slots"] > 0
             and pp["score_max_abs_err"] <= DET_SCORE_ATOL and pp["boxes_within"],
             f"detection: predict on the card off the CPU's: {pp}")
    del cpu_model, card_model, ref, got, head, card_head, want, have
    torch.cuda.empty_cache()

    # 2. Training at full width, bf16, through fit (two producers), a
    # readback each step.
    arch = dict(DET_ARCH, dtype=torch.bfloat16)

    def loss_fn(model, x, y):
        return retinanet.detection_loss_with_masks(*model(x, train=True), anchors, y["boxes"],
                                                   y["classes"], y["masks"], 80)

    trainer = Trainer(lambda g: retinanet.RetinaNet(**arch, generator=g),
                      TrainerConfig(learning_rate=0.01, has_train_arg=True, grad_clip_norm=10.0,
                                    log_every=1),
                      loss_fn=loss_fn, device="cuda",
                      analytic_flops_fn=lambda x: retinanet.train_flops(arch, x.shape))
    state = trainer.init(seed=0)
    first = next(iter(stream(DET_BATCH).batches(1)))
    logger = trainer.throughput_logger(first.x, DET_BATCH, name="detection", log_every=1)
    steps = DET_WARMUP + DET_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    state, losses = trainer.fit(state, stream(DET_BATCH).batches(steps), steps=steps,
                                logger=logger, prefetch_workers=2)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    count("detection")
    terms = {k: float(v) for k, v in trainer.last_metrics.items()}
    step_ms = [DET_BATCH / h["examples_per_sec"] * 1e3 for h in logger.history]
    steady_ms = statistics.median(step_ms[DET_WARMUP:])
    run = {"phase": "detection", "model": "retinanet_r50_fpn_masks", "dtype": "bfloat16",
           "batch": DET_BATCH, "image": DET_IMAGE, "anchors": int(anchors.shape[0]),
           "steps": steps, "losses": losses, "step_ms": step_ms, "steady_step_ms": steady_ms,
           "images_per_s": DET_BATCH / steady_ms * 1e3,
           "flops_per_step": logger.flops_per_step, "peak_flops": peak_flops,
           "mfu": logger.flops_per_step / (steady_ms / 1e3) / peak_flops,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "last_step_terms": terms, "first_step_s": trainer.first_step_seconds,
           "wall_s": wall_s, "pipeline": trainer.last_pipeline_stats.snapshot(),
           "params": sum(p.numel() for p in state.model.parameters()), "nvidia_smi": smi}
    _emit(run)
    _require(len(losses) == steps and all(math.isfinite(v) for v in losses)
             and all(math.isfinite(v) for v in terms.values())
             and terms["num_pos"] > 0 and terms["mask_slots"] > 0,
             f"detection: losses {losses}, terms {terms}")
    x, y = device_put_batch(first, cuda)

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, x, y)

    kernels_mod.reset_launch_counts()
    _emit({"phase": "profile", "path": "detection", **_profile(torch, step, 2)})
    count("detection profile")

    # 3. Learning: DET_LEARN_STEPS steps from a fresh state on one repeated batch.
    del state
    torch.cuda.empty_cache()
    state = trainer.init(seed=0)
    kernels_mod.reset_launch_counts()
    learn = []
    for _ in range(DET_LEARN_STEPS):
        state, m = trainer.train_step(state, x, y)
        learn.append(m["loss"])
    learn = torch.stack(learn).tolist()
    count("detection learn")
    _emit({"phase": "detection_learn", "steps": DET_LEARN_STEPS, "losses": learn,
           "ratio": learn[-1] / learn[0], "limit": DET_LEARN_RATIO})
    _require(all(math.isfinite(v) for v in learn) and learn[-1] < DET_LEARN_RATIO * learn[0],
             f"detection: the loss on one repeated batch did not fall below "
             f"{DET_LEARN_RATIO} of its start: {learn}")

    # 4. Eval: predict and DetectionAccumulator over held-out batches.
    args = argparse.Namespace(masks=True, image_size=DET_IMAGE, num_classes=80,
                              max_boxes=DET_MAX_BOXES)
    kernels_mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = detection_train.evaluate_map(trainer, state, anchors, args, DET_BATCH,
                                      steps=DET_EVAL_BATCHES)
    eval_s = time.perf_counter() - t0
    count("detection eval")
    _emit({"phase": "detection_eval", "batches": DET_EVAL_BATCHES, "batch": DET_BATCH,
           "ms_per_batch": eval_s * 1e3 / DET_EVAL_BATCHES, "images": ev["images"],
           "mAP": ev["mAP"], "mask_mAP": ev["mask_mAP"],
           "mask_mAP_stride": ev["mask_mAP_stride"]})
    _require(ev["images"] == DET_EVAL_BATCHES * DET_BATCH
             and all(0.0 <= ev[k] <= 1.0 for k in ("mAP", "mask_mAP", "mask_mAP_stride")),
             f"detection eval: {ev}")
    del trainer, state, x, y
    torch.cuda.empty_cache()

    # 5. The example a user runs, from a ResNet-50 classifier's checkpoint.
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_det-"))
    try:
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        resnet_imagenet.main(["--depth", "50", "--global_batch_size", "8", "--image_size", "64",
                              "--steps", "1", "--checkpoint_dir", str(root / "cls"),
                              "--device", "cuda"])
        result = detection_train.main(DET_EXAMPLE_ARGS + ["--backbone_ckpt", str(root / "cls")])
        torch.cuda.synchronize()
        count("detection example")
        with torch.device("meta"):  # the example's default backbone, ResNet-50
            backbone_tensors = len(retinanet.RetinaNet(
                backbone_stages=detection_train.BACKBONES["resnet50"]).backbone.state_dict())
        row = {"phase": "detection_example", "args": DET_EXAMPLE_ARGS + ["--backbone_ckpt"],
               "steps": result["steps"], "losses": [h["loss"] for h in result["history"]],
               "backbone_tensors_transferred": result["backbone_tensors_transferred"],
               "backbone_tensors": backbone_tensors,
               "eval": {k: result["eval"][k] for k in ("mAP", "mask_mAP", "mask_mAP_stride")},
               "first_step_s": result["first_step_s"], "wall_s": time.perf_counter() - t0}
        _emit(row)
        _require(result["steps"] == 3 and all(math.isfinite(v) for v in row["losses"])
                 and row["backbone_tensors_transferred"] == backbone_tensors,
                 f"detection example: {row}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _cifar_phase(torch, kernels_mod, smi: str) -> dict:
    """Phase 12: ``cifar10_train`` (VGG-11) and ``lenet_mnist`` as a user
    runs them.  Emits one ``cifar10`` line an example; returns the launches
    of the port's kernels over the phase (none)."""
    from deeplearning_cfn_tpu_torch.examples import cifar10_train, lenet_mnist

    launches: dict = {}
    for name, main, argv in (("cifar10_train", cifar10_train.main, CIFAR_ARGS),
                             ("lenet_mnist", lenet_mnist.main, LENET_ARGS)):
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        result = main(argv)
        torch.cuda.synchronize()
        got = dict(kernels_mod.launch_counts)
        _kernel_free(got, name)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        batch = 64
        rate = statistics.median(h["examples_per_sec"] for h in result["history"][1:])
        row = {"phase": "cifar10", "example": name, "args": argv, "steps": result["steps"],
               "losses": [h["loss"] for h in result["history"]],
               "step_ms": [batch / h["examples_per_sec"] * 1e3 for h in result["history"]],
               "steady_step_ms": batch / rate * 1e3, "images_per_s": rate,
               "first_step_s": result["first_step_s"], "wall_s": time.perf_counter() - t0,
               "eval": result.get("eval"), "nvidia_smi": smi}
        _emit(row)
        _require(result["steps"] == 20 and all(math.isfinite(v) for v in row["losses"]),
                 f"{name}: {row}")
        if name == "cifar10_train":
            _require(math.isfinite(result["eval"]["loss"]) and result["eval"]["examples"] == 128,
                     f"{name} eval: {result['eval']}")
        torch.cuda.empty_cache()
    return launches

@contextlib.contextmanager
def _opened_loaders():
    """The record loaders opened in the block, by class name."""
    from deeplearning_cfn_tpu_torch.train import native_loader

    opened: list[str] = []
    saved = {cls: cls.__post_init__ for cls in (native_loader.NativeRecordLoader,
                                                native_loader.PythonRecordLoader)}

    def recording(init):
        def post_init(self):
            opened.append(type(self).__name__)
            init(self)
        return post_init

    for cls, init in saved.items():
        cls.__post_init__ = recording(init)
    try:
        yield opened
    finally:
        for cls, init in saved.items():
            cls.__post_init__ = init


def _convert(argv: list) -> dict:
    """``cli convert`` as a user runs it; its JSON summary, parsed."""
    import io

    from deeplearning_cfn_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["convert", *argv])
    _require(rc == 0, f"cli convert {argv}: exit {rc}")
    return json.loads(out.getvalue())


def _records_phase(torch, kernels_mod, smi: str, flash_per_block: float) -> dict:
    """Phase 13: the record-backed input plane (see the module docstring).
    Emits ``records_convert``, ``records_resnet``, ``records_llama``,
    ``records_bert`` and ``records_small``; returns the launches of the
    port's kernels over the phase."""
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from deeplearning_cfn_tpu_torch.examples import (
        bert_pretrain,
        cifar10_train,
        detection_train,
        llama_train,
        resnet_imagenet,
    )
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.obs.profiler import PHASES
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDetectionDataset
    from deeplearning_cfn_tpu_torch.train.datasets import instance_spec
    from deeplearning_cfn_tpu_torch.train.records import write_records

    t_phase = time.perf_counter()
    launches: dict = {}

    def run(main, argv):
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        with _opened_loaders() as opened:
            result = main(argv)
        torch.cuda.synchronize()
        got = dict(kernels_mod.launch_counts)
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        return result, got, opened, time.perf_counter() - t0

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_records_"))
    try:
        # a. ImageNet-layout sources -> cli convert (margin records + a val split).
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        blocks = rng.integers(0, 256, (REC_CLASSES, 8, 8, 3)).astype(np.int16)
        cell = REC_SRC_PX // 8
        for split, per_class in (("train", REC_TRAIN_PER_CLASS), ("val", REC_VAL_PER_CLASS)):
            for c in range(REC_CLASSES):
                d = tmp / "imagenet" / split / f"n{c:08d}"
                d.mkdir(parents=True)
                base = np.kron(blocks[c], np.ones((cell, cell, 1), np.int16))
                for i in range(per_class):
                    noise = rng.integers(-40, 41, base.shape, dtype=np.int16)
                    img = np.clip(base + noise, 0, 255).astype(np.uint8)
                    Image.fromarray(img).save(d / f"{split}_{c}_{i}.JPEG", quality=90)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        image_dir = tmp / "imagenet" / "records"
        train_out = _convert(["--format", "imagefolder", "--src", str(tmp / "imagenet" / "train"),
                              "--out", str(image_dir), "--size", str(RESNET_IMAGE),
                              "--margin", str(REC_MARGIN)])
        val_out = _convert(["--format", "imagefolder", "--src", str(tmp / "imagenet" / "val"),
                            "--out", str(image_dir), "--size", str(RESNET_IMAGE),
                            "--split", "val"])
        convert_s = time.perf_counter() - t0
        stored = RESNET_IMAGE + REC_MARGIN
        _emit({"phase": "records_convert", "route": "cli convert --format imagefolder",
               "train": train_out, "val": val_out, "write_sources_s": write_s,
               "convert_s": convert_s,
               "train_bytes": (image_dir / "train.dlc").stat().st_size,
               "val_bytes": (image_dir / "val.dlc").stat().st_size})
        _require(train_out["records"] == {"train": REC_CLASSES * REC_TRAIN_PER_CLASS}
                 and train_out["stored_px"] == stored
                 and val_out["records"] == {"val": REC_CLASSES * REC_VAL_PER_CLASS},
                 f"records: conversions {train_out} {val_out}")

        # ResNet-50 from the records, through the native loader and the
        # prefetcher, the steps profiled; then the whole val split.
        argv = REC_RESNET_ARGS + ["--data_dir", str(image_dir)]
        result, got, opened, wall_s = run(resnet_imagenet.main, argv)
        steady = result["history"][1:]
        rate = statistics.median(h["examples_per_sec"] for h in steady)
        prof = result["profile"]
        step_mean = prof["step_ms"]["mean"]
        # The journaled step_time events hold each step's critical phases
        # only (the producers' overlapped copies are in the profile's h2d):
        # their medians over steps 2.. are the steady step's breakdown.
        per_step = [e for e in get_recorder().tail(4096)
                    if e["kind"] == "step_time" and e.get("profiler") == prof["name"]]
        per_step = per_step[-REC_RESNET_STEPS:][1:]
        breakdown = {f"{p}_ms": statistics.median(e.get(f"{p}_ms", 0.0) for e in per_step)
                     for p in (*PHASES, "total")}
        n_eval = -(-REC_CLASSES * REC_VAL_PER_CLASS // RESNET_BATCH)
        row = {"phase": "records_resnet", "args": argv, "steps": result["steps"],
               "losses": [h["loss"] for h in result["history"]],
               "step_ms": [RESNET_BATCH / h["examples_per_sec"] * 1e3 for h in result["history"]],
               "steady_step_ms": RESNET_BATCH / rate * 1e3, "images_per_s": rate,
               "mfu": statistics.median(h["mfu"] for h in steady),
               "profile": prof, "steady_breakdown": breakdown,
               "steady_data_wait_share": breakdown["data_wait_ms"] / breakdown["total_ms"],
               "steady_h2d_share": breakdown["h2d_ms"] / breakdown["total_ms"],
               "data_wait_share": prof["data_wait_ms"] / step_mean,
               "h2d_share": prof["h2d_ms"] / step_mean,
               "pipeline": result["pipeline"], "eval": result["eval"], "loaders": opened,
               "launches": got, "first_step_s": result["first_step_s"], "wall_s": wall_s,
               "nvidia_smi": smi}
        _emit(row)
        _require(result["steps"] == REC_RESNET_STEPS
                 and all(math.isfinite(v) for v in row["losses"]), f"records_resnet: {row}")
        _require(opened and set(opened) == {"NativeRecordLoader"},
                 f"records_resnet: loaders {opened}, expected the native loader only")
        _require(result["eval"]["split"] == "heldout-full"
                 and result["eval"]["examples"] == REC_CLASSES * REC_VAL_PER_CLASS
                 and math.isfinite(result["eval"]["loss"]), f"records_resnet eval: {result['eval']}")
        _require(_variants(got, "fused_dense") == {F32_SPLITK: REC_RESNET_STEPS + n_eval},
                 f"records_resnet: the kernel head launched {got}, expected one {F32_SPLITK} "
                 f"a step and one an eval batch")
        del result
        torch.cuda.empty_cache()

        # b. The tree's own Python sources, one text file -> byte-level token
        # records at seq 2048 and 128.
        corpus = tmp / "corpus"
        corpus.mkdir()
        root = Path(__file__).resolve().parent
        sources = sorted((root / "deeplearning_cfn_tpu").rglob("*.py"))
        with open(corpus / "corpus.txt", "wb") as f:
            for src in sources:
                f.write(src.read_bytes())
        text = {}
        for seq in (2048, BERT_SEQ):
            text[seq] = _convert(["--format", "text", "--src", str(corpus), "--out",
                                  str(tmp / f"tokens{seq}"), "--seq-len", str(seq)])
        _emit({"phase": "records_text", "files": len(sources),
               "bytes": (corpus / "corpus.txt").stat().st_size, "converted": text})

        argv = REC_LLAMA_ARGS + ["--data_dir", str(tmp / "tokens2048")]
        result, got, opened, wall_s = run(llama_train.main, argv)
        cfg = llama.LlamaConfig.m435(seq_len=2048)
        losses = [h["loss"] for h in result["history"]]
        row = {"phase": "records_llama", "args": argv, **_run_summary(result, 8 * 2048, 8 * 2048),
               "loaders": opened, "launches": got, "wall_s": wall_s,
               **_flash_check(got, REC_LLAMA_STEPS, flash_per_block * cfg.n_layers,
                              "records_llama")}
        _emit(row)
        _require(len(losses) == REC_LLAMA_STEPS and all(math.isfinite(v) for v in losses),
                 f"records_llama: {losses}")
        _require(statistics.mean(losses[-2:]) < losses[0],
                 f"records_llama: the loss on text records did not fall: {losses}")
        _require(set(opened) == {"NativeRecordLoader"}, f"records_llama: loaders {opened}")
        del result
        torch.cuda.empty_cache()

        # c. BERT-base with the kernel MLP on the seq-128 records.
        argv = REC_BERT_ARGS + ["--data_dir", str(tmp / f"tokens{BERT_SEQ}")]
        result, got, opened, wall_s = run(bert_pretrain.main, argv)
        losses = [h["loss"] for h in result["history"]]
        variants = _variants(got, "fused_dense")
        row = {"phase": "records_bert", "args": argv,
               **_run_summary(result, BERT_BATCH, BERT_BATCH * BERT_SEQ),
               "mask_token": result.get("mask_token"), "loaders": opened, "launches": got,
               "fused_dense_launches_per_step": got["fused_dense"] / REC_BERT_STEPS,
               "wall_s": wall_s}
        _emit(row)
        _require(len(losses) == REC_BERT_STEPS and all(math.isfinite(v) for v in losses),
                 f"records_bert: {losses}")
        _require(result.get("mask_token") == 257, f"records_bert: mask id {row['mask_token']}")
        _require(got["fused_dense"] == 24 * REC_BERT_STEPS
                 and sum(n for v, n in variants.items() if v.startswith("wgmma_tma"))
                 == got["fused_dense"], f"records_bert: fused-dense launches {variants}, "
                 f"expected 24 a step in the wgmma variants")
        _require(set(opened) == {"NativeRecordLoader"}, f"records_bert: loaders {opened}")
        del result
        torch.cuda.empty_cache()

        # d. VGG-11 from converted CIFAR-10 pickles, with the held-out split
        # scored whole; RetinaNet with masks from instance records.
        cifar = tmp / "cifar" / "cifar-10-batches-py"
        cifar.mkdir(parents=True)
        crng = np.random.default_rng(1)
        templates = crng.integers(0, 256, (10, 3072)).astype(np.int16)
        for name, n in (("data_batch_1", REC_CIFAR_PER_BATCH),
                        ("data_batch_2", REC_CIFAR_PER_BATCH), ("test_batch", REC_CIFAR_TEST)):
            labels = crng.integers(0, 10, n)
            data = np.clip(templates[labels] + crng.integers(-60, 61, (n, 3072)), 0, 255)
            with open(cifar / name, "wb") as f:
                pickle.dump({b"data": data.astype(np.uint8), b"labels": labels.tolist()}, f)
        cifar_out = _convert(["--format", "cifar10", "--src", str(tmp / "cifar"), "--out",
                              str(tmp / "cifar_records")])
        det_dir = tmp / "detection"
        spec = instance_spec(DET_IMAGE, DET_MAX_BOXES)
        det = SyntheticDetectionDataset(image_size=DET_IMAGE, num_classes=80,
                                        max_boxes=DET_MAX_BOXES, batch_size=8, seed=5,
                                        with_masks=True)
        recs = []
        for b in det.batches(REC_DET_RECORDS // 8):
            x = np.clip(np.rint(b.x * 80.0), 0, 255).astype(np.uint8)
            recs += [spec.encode(x=x[i], boxes=b.y["boxes"][i], classes=b.y["classes"][i],
                                 masks=b.y["masks"][i]) for i in range(len(x))]
        write_records(det_dir / "train.dlc", spec, recs)
        small = {}
        for name, main, argv in (
                ("cifar10_train", cifar10_train.main,
                 CIFAR_ARGS + ["--full_eval", "--data_dir", str(tmp / "cifar_records"),
                               "--eval_data_dir", str(tmp / "cifar_records")]),
                ("detection_train", detection_train.main,
                 ["--masks", "--steps", str(REC_DET_STEPS), "--global_batch_size", "8",
                  "--log_every", "1", "--data_dir", str(det_dir), "--device", "cuda"])):
            result, got, opened, wall_s = run(main, argv)
            losses = [h["loss"] for h in result["history"]]
            small[name] = {"args": argv, "losses": losses, "eval": result.get("eval"),
                           "loaders": opened, "launches": got, "wall_s": wall_s}
            _kernel_free(got, f"records {name}")
            _require(losses and all(math.isfinite(v) for v in losses),
                     f"records {name}: {losses}")
            _require(set(opened) == {"NativeRecordLoader"}, f"records {name}: loaders {opened}")
            torch.cuda.empty_cache()
        ev = small["cifar10_train"]["eval"]
        _require(ev["split"] == "heldout-full" and ev["examples"] == REC_CIFAR_TEST
                 and math.isfinite(ev["loss"]), f"records cifar10_train eval: {ev}")
        _emit({"phase": "records_small", "cifar_converted": cifar_out, **small})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _emit({"phase": "records_done", "wall_s": time.perf_counter() - t_phase,
           "launches": launches})
    return launches


def _llama8b_phase(torch, kernels_mod, smi: str) -> dict:
    """Phase 14: Llama-3-8B on one card (see the module docstring).  Returns
    the example's launches (the flash kernel's row at the 8B shape is phase
    3's)."""
    from deeplearning_cfn_tpu_torch.examples import llama_train
    from deeplearning_cfn_tpu_torch.models import llama, llama_import, llama_memory
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    gib = 1024**3
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), use_flash_attention=True)
    _emit({"phase": "llama8b_start", "memory_allocated_bytes": torch.cuda.memory_allocated(),
           "params": llama.param_count(cfg)})

    # b. llama_memory.validate_on_device: two steps at batch 1.
    val = llama_memory.validate_on_device(cfg, batch_global=1, seq_len=L8B_SEQ,
                                          steps=L8B_VALIDATE_STEPS, cfg_name="llama3_8b",
                                          optimizer="adafactor")
    _emit({"phase": "llama8b_validate", **val, "nvidia_smi": smi})
    _require(all(math.isfinite(v) for v in val["losses"]), f"llama8b_validate: {val['losses']}")
    _require(val["measured_peak_gib"] <= val["predicted_gib"],
             f"llama8b_validate: peak {val['measured_peak_gib']} GiB over the prediction "
             f"{val['predicted_gib']}")
    torch.cuda.empty_cache()

    # c. The example a user runs: the main path, counters zeroed just before.
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    result = llama_train.main(L8B_ARGS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels_mod.launch_counts)
    peak = torch.cuda.max_memory_allocated() - base
    predicted = llama_memory.memory_report(cfg, {"fsdp": 1}, L8B_BATCH, L8B_SEQ,
                                           optimizer="adafactor", cfg_name="llama3_8b",
                                           grad_accum=L8B_ACCUM)
    tokens = L8B_BATCH * L8B_SEQ
    run = {"phase": "llama8b", "args": L8B_ARGS, **_run_summary(result, tokens, tokens),
           "flops_per_step": llama.train_flops_per_token(cfg, L8B_SEQ) * tokens,
           "wall_s": wall_s, "measured_peak_gib": peak / gib,
           "predicted_gib": predicted.total_gib, "predicted": vars(predicted),
           "prediction_error_pct": 100.0 * (predicted.total_gib - peak / gib) / (peak / gib),
           "launches": launches,
           **_flash_check(launches, L8B_STEPS, 2 * cfg.n_layers * L8B_ACCUM, "llama8b"),
           "nvidia_smi": smi}
    _emit(run)
    _require(len(run["losses"]) == L8B_STEPS and all(math.isfinite(v) for v in run["losses"]),
             f"llama8b: losses {run['losses']}")
    _require(peak / gib <= predicted.total_gib,
             f"llama8b: peak {peak / gib} GiB over the prediction {predicted.total_gib}")
    del result
    torch.cuda.empty_cache()
    # One more step of the same program, profiled by kernel.
    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adafactor", learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=1.0,
        grad_accum_steps=L8B_ACCUM), device="cuda")
    state = trainer.init(seed=0, draw_on_device=True)
    x, y = device_put_batch(next(SyntheticTokenDataset(
        seq_len=L8B_SEQ, vocab_size=cfg.vocab_size, batch_size=L8B_BATCH).batches(1)),
        torch.device("cuda"))

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, x, y)

    step()
    _emit({"phase": "profile", "path": "llama8b", **_profile(torch, step, 1)})
    del trainer, state, x, y
    torch.cuda.empty_cache()

    # d. An HF-layout state dict at Llama-3-8B's shapes, drawn in bf16 on the
    # card (tensor i from seed i), through the importer.
    shapes = llama_import.expected_hf_shapes(cfg)

    def source(i, shape):
        g = torch.Generator(device="cuda").manual_seed(i)
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    sd = {key: source(i, shape) for i, (key, shape) in enumerate(shapes.items())}
    model_bytes = sum(t.nbytes for t in sd.values())
    largest = max(t.nbytes for t in sd.values())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imported = llama_import.from_hf_state_dict(cfg, sd)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    import_peak = torch.cuda.max_memory_allocated() - base
    hf_to_port = {"model.embed_tokens.weight": "embed", "model.norm.weight": "final_norm",
                  "lm_head.weight": "output"}
    for i in range(cfg.n_layers):
        for hf, ours, _ in llama_import.HF_LAYER_KEYS:
            hf_to_port[f"model.layers.{i}.{hf}"] = f"layers.{i}.{ours}"
    mismatched = []
    for i, (key, shape) in enumerate(shapes.items()):
        want = source(i, shape)
        if len(shape) == 2 and key != "model.embed_tokens.weight":
            want = want.T
        got = imported[hf_to_port[key]]
        if got.shape != want.shape or not torch.equal(got.float(), want.float()):
            mismatched.append(key)
    row = {"phase": "llama8b_import", "tensors": len(shapes), "model_bytes": model_bytes,
           "largest_tensor_bytes": largest, "import_s": import_s, "peak_bytes": import_peak,
           "peak_bound_bytes": IMPORT_PEAK_MARGIN * (model_bytes + largest),
           "source_left": len(sd), "mismatched": mismatched, "nvidia_smi": smi}
    _emit(row)
    _require(not mismatched and not sd, f"llama8b_import: {len(mismatched)} tensors differ, "
             f"{len(sd)} left in the source")
    _require(import_peak <= row["peak_bound_bytes"],
             f"llama8b_import: peak {import_peak} B over {row['peak_bound_bytes']}")
    del imported, sd
    torch.cuda.empty_cache()

    # e. TrainerConfig.remat on one m435 step, against the same step without.
    mcfg = llama.LlamaConfig.m435(seq_len=2048)
    x, y = device_put_batch(next(SyntheticTokenDataset(
        seq_len=2048, vocab_size=mcfg.vocab_size, batch_size=8).batches(1)), torch.device("cuda"))
    grads, remat_runs = {}, {}
    # remat off; on, nested over the preset's "dots" remat a block; on alone.
    for remat in ("off", "on", "on_without_block_remat"):
        trainer = llama.make_trainer(
            mcfg if remat != "on_without_block_remat" else dataclasses.replace(mcfg, remat=False),
            TrainerConfig(optimizer="sgd", learning_rate=1e-3, remat=remat != "off"),
            device="cuda")
        state = trainer.init(seed=0, draw_on_device=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, x, y)
        loss = metrics["loss"].item()
        remat_runs[remat] = {"loss": loss, "step_s": time.perf_counter() - t0,
                             "peak_bytes": torch.cuda.max_memory_allocated() - base,
                             "flash_launches": kernels_mod.launch_counts["flash_attention_fwd"]}
        grads[remat] = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        del trainer, state
        torch.cuda.empty_cache()
    worst = max((grads[r][n].float() - g.float()).abs().max().item()
                / max(g.float().abs().max().item(), 1e-30)
                for r in ("on", "on_without_block_remat") for n, g in grads["off"].items())
    row = {"phase": "llama8b_remat", "model": "m435", "B": 8, "S": 2048, **remat_runs,
           "grad_max_rel_diff": worst, "grad_rtol": REMAT_GRAD_RTOL,
           "bitwise_equal": all(torch.equal(grads[r][n], g) for r in ("on", "on_without_block_remat")
                                for n, g in grads["off"].items()),
           "nvidia_smi": smi}
    _emit(row)
    _require(worst <= REMAT_GRAD_RTOL, f"llama8b_remat: gradients {worst} apart")
    _require(remat_runs["on"]["peak_bytes"] <= remat_runs["off"]["peak_bytes"],
             f"llama8b_remat: the peak with remat on, {remat_runs['on']['peak_bytes']} B, over "
             f"the peak without it, {remat_runs['off']['peak_bytes']} B")
    del grads, x, y
    torch.cuda.empty_cache()
    return {"launches": launches}


def _pp_layout_phase(torch, kernels_mod, smi: str, flash_per_block: float) -> int:
    """Phase 15 (see the module docstring).  Returns its flash launches."""
    import numpy as np

    from deeplearning_cfn_tpu_torch import interop
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel import pipeline
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    cfg = llama.LlamaConfig.m435(seq_len=2048)
    pcfg = dataclasses.replace(cfg, pp_stages=PP_STAGES, pp_microbatches=PP_MICROBATCHES)
    # The JAX tree of weights drawn on the card: [L, ...] layers stacked into
    # [pp, L/pp, ...] stages, on the host in f32 (bf16 values, exactly).
    t0 = time.perf_counter()
    drawn = _llama_on_card(torch, llama, cfg, seed=0).state_dict()
    host = {k: v.float().cpu().numpy() for k, v in drawn.items()}
    del drawn
    names = llama.layer_param_shapes(cfg)
    tree = {"embed": host["embed"], "final_norm": host["final_norm"],
            "layers": pipeline.stack_stages(
                {n: np.stack([host[f"layers.{i}.{n}"] for i in range(cfg.n_layers)])
                 for n in names}, PP_STAGES)}
    del host
    weights = {"stage_stacked": interop.llama_params_from_jax(pcfg, tree),
               "unstacked": interop.llama_params_from_jax(
                   cfg, {**tree, "layers": pipeline.unstack_stages(tree["layers"])})}
    layout_s = time.perf_counter() - t0
    stacked_shape = list(tree["layers"]["wq"].shape)
    del tree
    x, y = device_put_batch(next(SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size, batch_size=PP_BATCH).batches(1)),
        torch.device("cuda"))
    tcfg = TrainerConfig(optimizer="adamw", learning_rate=3e-4, weight_decay=0.1,
                         grad_clip_norm=1.0, log_every=1)
    runs, logits, finals = {}, {}, {}
    for path, c in (("stage_stacked", pcfg), ("unstacked", cfg)):
        with torch.device("meta"):
            model = llama.Llama(c)
        model = model.to_empty(device="cuda")
        model.load_state_dict(weights[path])
        trainer = llama.make_trainer(c, tcfg, device="cuda")
        state = trainer.init_from(model)
        with torch.no_grad():
            logits[path] = llama.forward(state.model, x[:2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels_mod.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(PP_STEPS):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, x, y)
            losses.append(metrics["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels_mod.launch_counts)
        runs[path] = {"losses": losses, "step_ms": step_ms,
                      "steady_step_ms": statistics.median(step_ms[1:]),
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                      "blocks": len(state.model.blocks()), "pipelined": state.model.pipelined,
                      "launches": launches,
                      **_flash_check(launches, PP_STEPS, flash_per_block * c.n_layers,
                                     f"pp_layout ({path})")}
        finals[path] = _param_copy(state.model)
        del trainer, state, model
        torch.cuda.empty_cache()
    del weights
    logits_equal = torch.equal(logits["stage_stacked"], logits["unstacked"])
    params_equal = all(torch.equal(finals["stage_stacked"][n], p)
                       for n, p in finals["unstacked"].items())
    row = {"phase": "pp_layout", "model": "m435", "pp_stages": PP_STAGES,
           "pp_microbatches": PP_MICROBATCHES, "B": PP_BATCH, "S": 2048,
           "jax_layers_wq_shape": stacked_shape, "layout_s": layout_s,
           "runs_at_pp": 1, "microbatches_run": 1,
           "gpipe_across_ranks": "phase 24 model_parallel_ranks (pp2_remat, through the "
                                 "host staging of parallel/p2p.py)",
           **{f"{k}_{p}": v for p, r in runs.items() for k, v in r.items()},
           "logits_bitwise_equal": logits_equal,
           "losses_bitwise_equal": runs["stage_stacked"]["losses"] == runs["unstacked"]["losses"],
           "params_bitwise_equal": params_equal, "nvidia_smi": smi}
    _emit(row)
    _require(all(math.isfinite(v) for v in runs["stage_stacked"]["losses"]),
             "pp_layout: non-finite loss")
    _require(runs["stage_stacked"]["blocks"] == cfg.n_layers
             and not runs["stage_stacked"]["pipelined"], "pp_layout: the layout at pp 1")
    _require(logits_equal and row["losses_bitwise_equal"] and params_equal,
             "pp_layout: the stage-stacked model is not the unstaged one")
    del logits, finals, x, y
    torch.cuda.empty_cache()
    return runs["stage_stacked"]["flash_launches"]


def _first_routing(torch, moe):
    """A pre-hook on the MoE block that keeps its next input and router;
    the returned function removes it and routes them again (``route``: the
    same group and token order), outside the step: the experts, slots and
    kept claims."""
    from deeplearning_cfn_tpu_torch.ops.moe import route

    seen: dict = {}

    def hook(mod, args):
        if not seen:
            seen.update(x=args[0].detach().clone(), router=mod.router.detach().clone())

    handle = moe.register_forward_pre_hook(hook)

    def decide() -> dict:
        handle.remove()
        B, S, d = seen["x"].shape
        with torch.no_grad():
            r = route(moe.cfg, seen["router"], seen["x"].reshape(B * S, d), moe.mp, B)
        return {"expert": r.expert, "slot": r.slot, "kept": r.kept}

    return decide


def _mp_run(torch, cfg, mesh, train_kw: dict, batches, device) -> dict:
    """One run of a phase 24 case (or, without ``mesh``, its one-rank
    reference): ``MP_STEPS`` AdamW steps from seed 0, the kernel and staging
    counters zeroed just before them.  Returns the losses, the first step's
    global gradient norm, layer 0's routing of the first step (MoE), the
    launches, the bytes staged through the host, the step times, each
    parameter's initial and final local part, and the model's layout."""
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.parallel import p2p
    from deeplearning_cfn_tpu_torch.train.optimizers import local_part
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig, clip_by_global_norm

    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, log_every=1, **train_kw),
        device=device, mesh=mesh)
    state = trainer.init(seed=0, draw_on_device=True)
    p0 = {n: local_part(q).detach().clone() for n, q in state.model.named_parameters()}
    if device.type == "cuda":
        torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    p2p.reset_staged_bytes()
    losses, step_ms, norm, routing = [], [], None, None
    moe = getattr(state.model.blocks()[0], "moe", None)
    decide = _first_routing(torch, moe) if moe is not None else None
    for i, (x, y) in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, x, y)
        losses.append(metrics["loss"].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:  # no clip: .grad holds the step's whole gradient
            norm = clip_by_global_norm(state.model.parameters(), math.inf,
                                       trainer._clip_groups()).item()
            if decide is not None:  # layer 0's routing of the first step
                routing = decide()
    model = state.model
    params = dict(model.named_parameters())
    out = {"losses": losses, "norm": norm, "routing": routing, "step_ms": step_ms,
           "launches": dict(_kernels.launch_counts), "staged_bytes": p2p.staged_bytes,
           "p0": p0, "final": {n: local_part(q).detach().clone() for n, q in params.items()},
           "layout": {n: (q.device_mesh, q.placements) for n, q in params.items()
                      if hasattr(q, "placements")},
           "devices": sorted({str(q.device) for q in params.values()}),
           "mp": [model.mp.tp, model.mp.sp, getattr(model, "n_stages", 1)]}
    del trainer, state
    return out


def _global_part(torch, whole, layout):
    """The part of the global tensor ``whole`` that a DTensor of ``layout``
    (its mesh and placements) holds on this rank."""
    if layout is None:
        return whole
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(whole.shape, *layout)
    return whole[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def _model_parallel_cases(torch, rank: int, device) -> dict:
    """Phase 24 on this rank (both ranks run every case; rank 0 also runs
    each case's one-rank reference and broadcasts its results): per case
    its losses, the reference's, the norms, the worst parameter gap, the
    routing's agreement (MoE), flash launches, bytes staged, seconds."""
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch

    base = dataclasses.replace(llama.LlamaConfig.m435(seq_len=MP_SEQ), n_layers=MP_LAYERS)
    one = next(SyntheticTokenDataset(seq_len=MP_SEQ, vocab_size=base.vocab_size,
                                     batch_size=MP_BATCH).batches(1))
    batches = [device_put_batch(one, device)] * MP_STEPS
    results = {}
    for name, (mesh_kw, cfg_kw, train_kw, ref_kw) in MP_CASES.items():
        t0 = time.perf_counter()
        kw = dict(cfg_kw)
        if "dtype" in kw:
            kw["dtype"] = getattr(torch, kw["dtype"])
        cfg = dataclasses.replace(base, **kw)
        mesh = build_mesh(MeshSpec(**mesh_kw), device_type=device.type)
        run = _mp_run(torch, cfg, mesh, train_kw, batches, device)
        run_s = time.perf_counter() - t0
        ref = None
        if rank == 0:
            ref = _mp_run(torch, dataclasses.replace(cfg, **ref_kw), None, train_kw, batches,
                          device)
        # The reference's numbers and final parameters to every rank.
        meta = [None if ref is None else {
            "losses": ref["losses"], "norm": ref["norm"], "launches": ref["launches"],
            "shapes": {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                       for n, t in ref["final"].items()},
            "routing": None if ref["routing"] is None else {
                k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for k, t in ref["routing"].items()}}]
        dist.broadcast_object_list(meta, src=0)
        meta = meta[0]

        def from_rank0(mine, shape, dtype):
            t = mine if mine is not None else torch.empty(shape, dtype=getattr(torch, dtype),
                                                          device=device)
            dist.broadcast(t, src=0)
            return t

        gaps, p0_gaps, sp, sp_rank = {}, {}, mesh_kw.get("sp", 1), mesh.get_local_rank("sp")
        for n, (shape, dtype) in meta["shapes"].items():
            whole = from_rank0(None if ref is None else ref["final"][n], shape, dtype)
            if n not in run["final"]:  # another stage's parameter
                continue
            want = _global_part(torch, whole, run["layout"].get(n)).float()
            start = run["p0"][n].float()
            travelled = (want - start).norm().item()
            gap = (run["final"][n].float() - want).norm().item()
            gaps[n] = gap / travelled if travelled else (0.0 if gap == 0 else math.inf)
            p0_gaps[n] = 1.0 if travelled else 0.0
        routing_equal = None
        if meta["routing"] is not None:
            routing_equal = True
            for k, (shape, dtype) in meta["routing"].items():
                whole = from_rank0(None if ref is None else ref["routing"][k], shape, dtype)
                if sp > 1:  # this rank's [batch, S/sp] block of the group's tokens
                    whole = whole.reshape(MP_BATCH, sp, -1, whole.shape[-1])[:, sp_rank]
                routing_equal &= bool(torch.equal(run["routing"][k],
                                                  whole.reshape(run["routing"][k].shape)))
        worst = max(gaps, key=gaps.get)
        results[name] = {
            "mesh": mesh_kw, "dtype": str(cfg.dtype).removeprefix("torch."),
            "model_tp_sp_pp": run["mp"], "devices": run["devices"],
            "losses": run["losses"], "ref_losses": meta["losses"],
            "norm": run["norm"], "ref_norm": meta["norm"],
            "param_gap_max": gaps[worst], "param_gap_worst": worst,
            "param_gap_median": statistics.median(gaps.values()),
            "no_update_param_gap_max": max(p0_gaps.values()),
            "params_compared": len(gaps), "routing_equal": routing_equal,
            "flash_launches": run["launches"].get("flash_attention_fwd", 0),
            "flash_variants": _variants(run["launches"], "flash_attention_fwd"),
            "other_launches": {k: v for k, v in run["launches"].items()
                               if v and not k.startswith("flash_attention_fwd")},
            "ref_flash_launches": meta["launches"].get("flash_attention_fwd", 0),
            "staged_bytes": run["staged_bytes"], "step_ms": run["step_ms"],
            "run_s": run_s, "seconds": time.perf_counter() - t0}
        del run, ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return results


def _two_ranks_worker(rank: int, port: int, out: str) -> int:
    """One of ``two_ranks``' processes (``chip_smoke.py --two-ranks-worker
    RANK PORT OUT``): the runs of phase 16 on this rank's half of the
    batches, its results as JSON in ``OUT.rank<RANK>``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.parallel import overlap
    from deeplearning_cfn_tpu_torch.parallel.mesh import hybrid_mesh_for_slices, mesh_spec
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    class Unsynced(overlap.BucketedGradSync):
        """The planted control: the first bucket keeps each rank's own
        gradient (never all-reduced)."""

        def _issue(self, b):
            if b:
                return super()._issue(b)
            self.issued.append(b)
            self._runs.append(overlap._Run(b, self._flat(b) * self.nd))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    mesh = hybrid_mesh_for_slices(int(os.environ["DEEPLEARNING_SLICES_COUNT"]))
    cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=2048), n_layers=TWO_RANK_LAYERS)
    batches = [device_put_batch(b, torch.device("cuda")) for b in SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size,
        batch_size=2 * TWO_RANK_BATCH).batches(TWO_RANK_STEPS)]
    runs, finals = {}, {}
    for name, kw in (("hookless", {}), ("overlap", {"comms_overlap": True}),
                     ("control", {"comms_overlap": True}),
                     ("int8", {"comms_overlap": True, "overlap_compress": True})):
        trainer = llama.make_trainer(cfg, TrainerConfig(
            strategy="dp", optimizer="adamw", learning_rate=3e-4, weight_decay=0.1,
            grad_clip_norm=1.0, log_every=1, **kw), device="cuda", mesh=mesh)
        state = trainer.init(seed=0, draw_on_device=True)
        if name == "control":
            old = state.grad_sync
            old.remove()
            state.grad_sync = Unsynced(old.members, old.group, old.nd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        losses, step_ms = [], []
        for x, y in batches:
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, x, y)
            losses.append(metrics["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_kernels.launch_counts)
        sync = state.grad_sync
        runs[name] = {"losses": losses, "step_ms": step_ms,
                      "steady_step_ms": statistics.median(step_ms[1:]),
                      "bytes_sent_per_step": sync.wire_bytes,
                      "buckets": len(sync.members), "issued_last_step": list(sync.issued),
                      "ddp": isinstance(sync, overlap.DDPGradSync),
                      "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                      "flash_launches": launches.get("flash_attention_fwd", 0),
                      "flash_variants": _variants(launches, "flash_attention_fwd")}
        finals[name] = [p.detach().clone() for p in state.model.parameters()]
        del trainer, state, sync
        torch.cuda.empty_cache()
    base = finals["hookless"]
    result = {"rank": rank, "mesh": mesh_spec(mesh).axis_sizes(), "mesh_grid": mesh.mesh.tolist(),
              "runs": runs,
              **{f"{n}_bitwise_hookless": runs[n]["losses"] == runs["hookless"]["losses"]
                 and all(torch.equal(p, q) for p, q in zip(finals[n], base))
                 for n in ("overlap", "control", "int8")}}
    del finals, base
    torch.cuda.empty_cache()
    # Phase 24 in the same two processes (no second start-up).
    t0 = time.perf_counter()
    result["model_parallel"] = _model_parallel_cases(torch, rank, torch.device("cuda", 0))
    result["model_parallel_s"] = time.perf_counter() - t0
    dist.destroy_process_group()
    Path(f"{out}.rank{rank}").write_text(json.dumps(result))
    return 0


def _two_ranks_phase(torch, smi: str, flash_per_block: float) -> int:
    """Phase 16 (see the module docstring): two processes of this script on
    the card.  Returns the flash launches of both processes' runs."""
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n_layers = TWO_RANK_LAYERS
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "two_ranks")
        env = dict(os.environ, DEEPLEARNING_SLICES_COUNT="2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--two-ranks-worker", str(r), str(port), out],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(2)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=TWO_RANK_TIMEOUT)
                errs.append(err)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_s = time.perf_counter() - t0
        failed = [f"rank {r}:\n{err[-3000:]}" for r, (p, err) in enumerate(zip(procs, errs))
                  if p.returncode != 0]
        _require(not failed, "two_ranks: a process failed:\n" + "\n".join(failed))
        ranks = [json.loads(Path(f"{out}.rank{r}").read_text()) for r in range(2)]
    runs = {name: {"losses": ranks[0]["runs"][name]["losses"],
                   "losses_rank1": ranks[1]["runs"][name]["losses"],
                   **{k: [r["runs"][name][k] for r in ranks] for k in (
                       "steady_step_ms", "step_ms", "bytes_sent_per_step", "buckets",
                       "max_memory_allocated_bytes", "flash_launches", "flash_variants")},
                   "issued_last_step": ranks[0]["runs"][name]["issued_last_step"]}
            for name in ranks[0]["runs"]}
    f32, int8 = runs["overlap"]["losses"], runs["int8"]["losses"]
    int8_gap = max(abs(a - b) - INT8_RTOL * abs(b) for a, b in zip(int8, f32))
    row = {"phase": "two_ranks", "processes": 2, "device": "cuda:0 for both",
           "backend": "gloo over CUDA tensors (host-staged)", "slices": 2,
           "mesh": ranks[0]["mesh"], "model": "m435", "S": 2048, "batch_per_rank": TWO_RANK_BATCH,
           "steps": TWO_RANK_STEPS, "times": "gloo, host-staged: not NVLink times",
           "wall_s": wall_s, "runs": runs,
           "overlap_bitwise_hookless": [r["overlap_bitwise_hookless"] for r in ranks],
           "control_bitwise_hookless": [r["control_bitwise_hookless"] for r in ranks],
           "int8_vs_f32_max_excess": int8_gap, "int8_rtol": INT8_RTOL, "int8_atol": INT8_ATOL,
           "nvidia_smi": smi}
    _emit(row)
    for name, run in runs.items():
        _require(all(math.isfinite(v) for v in run["losses"] + run["losses_rank1"]),
                 f"two_ranks ({name}): non-finite loss")
        per_step = flash_per_block * n_layers
        _require(all(n == per_step * TWO_RANK_STEPS for n in run["flash_launches"])
                 and all(v == {"wgmma_tma": per_step * TWO_RANK_STEPS}
                         for v in run["flash_variants"]),
                 f"two_ranks ({name}): flash launched {run['flash_variants']}")
    _require(ranks[0]["mesh"]["dp"] == 2, f"two_ranks: mesh {ranks[0]['mesh']}")
    _require(runs["hookless"]["losses"] == runs["hookless"]["losses_rank1"],
             "two_ranks: the ranks disagree on the hookless losses")
    _require(all(row["overlap_bitwise_hookless"]),
             "two_ranks: the bucketed f32 sync is not bitwise the dp step")
    _require(not any(row["control_bitwise_hookless"]),
             "two_ranks: the check passed the planted control (a bucket left unsynced)")
    _require(int8_gap <= INT8_ATOL, f"two_ranks: int8 losses {int8} off the f32 curve {f32}")
    _NOTES["model_parallel"] = {"ranks": [r["model_parallel"] for r in ranks],
                                "seconds": [r["model_parallel_s"] for r in ranks]}
    return sum(sum(run["flash_launches"]) for run in runs.values())


def _model_parallel_phase(smi: str) -> int:
    """Phase 24 (see the module docstring): the cases ran in phase 16's two
    processes; here their rows and gates.  Returns the cases' flash
    launches (both ranks'; the references' are not counted)."""
    mp = _NOTES["model_parallel"]
    ranks = mp["ranks"]
    cases = {}
    for name, (mesh_kw, cfg_kw, _, _) in MP_CASES.items():
        r0, r1 = ranks[0][name], ranks[1][name]
        tol = MP_TOL[r0["dtype"]]
        pp = mesh_kw.get("pp", 1)
        per_micro = MP_FLASH_PER_BLOCK[name] * MP_LAYERS // pp
        n_micro = cfg_kw.get("pp_microbatches", 1) if pp > 1 else 1
        stages = [r * pp // 2 for r in range(2)]  # each rank's stage
        passes = [1 + (mesh_kw.get("sp", 1) > 1 and r > 0) for r in range(2)]  # sp rank r
        expected = [(per_micro - (0 < per_micro and stage < pp - 1)) * n_micro * MP_STEPS * n
                    for stage, n in zip(stages, passes)]
        cases[name] = {
            "mesh": r0["mesh"], "dtype": r0["dtype"], "model_tp_sp_pp": r0["model_tp_sp_pp"],
            "devices": sorted(set(r0["devices"] + r1["devices"])),
            "losses": r0["losses"], "losses_rank1": r1["losses"], "ref_losses": r0["ref_losses"],
            "max_rel_loss_diff": max(abs(a - b) / abs(b)
                                     for a, b in zip(r0["losses"], r0["ref_losses"])),
            # A run that never updates: the reference's first loss every step.
            "no_update_max_rel_loss_diff": max(abs(r0["ref_losses"][0] - b) / abs(b)
                                               for b in r0["ref_losses"]),
            "norm": r0["norm"], "ref_norm": r0["ref_norm"],
            "norm_rel_diff": abs(r0["norm"] - r0["ref_norm"]) / r0["ref_norm"],
            "param_gap_max": max(r0["param_gap_max"], r1["param_gap_max"]),
            "param_gap_worst": max((r0, r1), key=lambda r: r["param_gap_max"])["param_gap_worst"],
            "param_gap_median": [r0["param_gap_median"], r1["param_gap_median"]],
            "no_update_param_gap_max": min(r0["no_update_param_gap_max"],
                                           r1["no_update_param_gap_max"]),
            "params_compared": [r0["params_compared"], r1["params_compared"]],
            "routing_equal": [r0["routing_equal"], r1["routing_equal"]],
            "flash_launches": [r0["flash_launches"], r1["flash_launches"]],
            "flash_expected_per_rank": expected,
            "flash_variants": [r0["flash_variants"], r1["flash_variants"]],
            "ref_flash_launches": r0["ref_flash_launches"],
            "other_launches": [r0["other_launches"], r1["other_launches"]],
            "staged_bytes": [r0["staged_bytes"], r1["staged_bytes"]],
            "steady_step_ms": [statistics.median(r["step_ms"][1:]) for r in (r0, r1)],
            "seconds": [r0["seconds"], r1["seconds"]], **tol}
    row = {"phase": "model_parallel_ranks", "processes": 2, "device": "cuda:0 for both",
           "backend": "gloo (collectives on CUDA tensors; point-to-point staged through "
                      "pinned host buffers, parallel/p2p.py)",
           "model": "m435", "layers": MP_LAYERS, "S": MP_SEQ, "batch": MP_BATCH,
           "steps": MP_STEPS, "reference": "rank 0's one-rank run, same weights and batches",
           "moe_kernels": "the MoE cases run in f32 with the materialised attention: no kernel",
           "times": "gloo, host-staged: not NVLink times", "seconds": mp["seconds"],
           "cases": cases, "nvidia_smi": smi}
    _emit(row)
    for name, c in cases.items():
        what = f"model_parallel_ranks ({name})"
        _require(c["devices"] == ["cuda:0"], f"{what}: parameters on {c['devices']}")
        _require(all(math.isfinite(v) for v in c["losses"] + c["losses_rank1"]),
                 f"{what}: non-finite loss")
        _require(c["losses"] == c["losses_rank1"], f"{what}: the ranks disagree on the loss")
        _require(c["max_rel_loss_diff"] <= c["loss_rtol"],
                 f"{what}: losses {c['losses']} against the one-rank {c['ref_losses']}")
        _require(c["norm_rel_diff"] <= c["norm_rtol"],
                 f"{what}: gradient norm {c['norm']} against the one-rank {c['ref_norm']}")
        _require(c["param_gap_max"] <= c["param_gap"],
                 f"{what}: parameter {c['param_gap_worst']} {c['param_gap_max']} apart")
        _require(c["no_update_param_gap_max"] > NO_UPDATE_MARGIN * c["param_gap"]
                 and c["no_update_max_rel_loss_diff"] > NO_UPDATE_MARGIN * c["loss_rtol"],
                 f"{what}: the limits would pass a run that never updates")
        mesh_kw = MP_CASES[name][0]
        want_mp = [mesh_kw.get("tp", 1), mesh_kw.get("sp", 1), mesh_kw.get("pp", 1)]
        _require(c["model_tp_sp_pp"] == want_mp, f"{what}: the model's tp, sp, pp "
                 f"{c['model_tp_sp_pp']}")
        for r, n in enumerate(c["flash_expected_per_rank"]):
            launches = {"flash_attention_fwd": c["flash_launches"][r],
                        **{f"flash_attention_fwd/{v}": k
                           for v, k in c["flash_variants"][r].items()}}
            if n:
                _flash_check(launches, MP_STEPS, n / MP_STEPS, f"{what}, rank {r}")
            else:
                _require(not c["flash_launches"][r],
                         f"{what}: rank {r} launched flash {c['flash_variants'][r]}")
        _require(not any(c["other_launches"]), f"{what}: other kernels {c['other_launches']}")
        if name.startswith("moe"):
            _require(c["routing_equal"] == [True, True],
                     f"{what}: the first step's slots or kept claims are not the one-rank run's")
        if mesh_kw.get("pp", 1) > 1 or MP_CASES[name][1].get("use_ring_attention"):
            _require(all(b > 0 for b in c["staged_bytes"]),
                     f"{what}: nothing went through the host staging")
    return sum(sum(c["flash_launches"]) for c in cases.values())


def _mesh_captured_phase(torch, kernels_mod, smi: str, flash_per_block: float) -> int:
    """Phase 17 (see the module docstring).  Returns the flash launches of
    the warm-up and the capture."""
    import socket

    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        cfg = llama.LlamaConfig.m435(seq_len=2048)
        trainer = llama.make_trainer(cfg, TrainerConfig(
            strategy="fsdp", optimizer="adamw", learning_rate=3e-4, weight_decay=0.1,
            grad_clip_norm=1.0, log_every=1), device="cuda", mesh=build_mesh(MeshSpec(fsdp=1)))
        one = next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size,
                                         batch_size=8).batches(1))
        xs, ys = device_put_batch(next(stack_batches(iter([one] * MESH_K), MESH_K)),
                                  torch.device("cuda"))
        eager_state = trainer.init(seed=0, draw_on_device=True)
        p0 = _param_copy(eager_state.model)
        eager, eager_ms = [], []
        for i in range(MESH_K):
            t0 = time.perf_counter()
            eager_state, m = trainer.train_step(eager_state, xs[i], ys[i])
            eager.append(m["loss"].item())
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager_final = _param_copy(eager_state.model)
        del eager_state, m
        torch.cuda.empty_cache()
        state = trainer.init(seed=0, draw_on_device=True)
        kfn = trainer.multi_step_fn(MESH_K)
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        state, captured = kfn(state, xs, ys)
        captured = captured.tolist()
        capture_s = time.perf_counter() - t0
        launches = dict(kernels_mod.launch_counts)
        final = _param_copy(state.model)
        held = _held_runs(captured, eager, _param_gap(final, eager_final, p0),
                          _param_gap(p0, eager_final, p0), LLAMA_CAPTURE_RTOL)
        params_equal = all(torch.equal(final[n], p) for n, p in eager_final.items())
        dtensors = sum(hasattr(p, "placements") for p in state.model.parameters())
        del p0, eager_final, final
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_REPLAYS):
            state, losses = kfn(state, xs, ys)
            losses.tolist()
        step_ms = (time.perf_counter() - t0) * 1e3 / (MESH_REPLAYS * MESH_K)
        row = {"phase": "mesh_captured", "mesh": "MeshSpec(fsdp=1), one NCCL rank",
               "strategy": "fsdp (FSDP2)", "k": MESH_K, "replays": MESH_REPLAYS,
               "dtensor_params": dtensors, "eager_losses": eager, "captured_losses": captured,
               **held, "losses_bitwise_equal": captured == eager,
               "params_bitwise_equal": params_equal, "first_call_s": capture_s,
               "captures": kfn.captures, "step_ms": step_ms, "eager_step_ms": eager_ms,
               "eager_steady_step_ms": statistics.median(eager_ms[1:]),
               "launches_in_warmup_and_capture": launches, "nvidia_smi": smi}
        _emit(row)
        _require(kfn.captures == 1 and dtensors > 0, f"mesh_captured: {kfn.captures} captures, "
                 f"{dtensors} DTensor parameters")
        _check_held("mesh_captured", row)
        _require(row["losses_bitwise_equal"] and params_equal,
                 "mesh_captured: the captured steps are not bitwise the eager ones")
        _flash_check(launches, 1 + MESH_K, flash_per_block * cfg.n_layers,
                     "mesh_captured (warm-up + capture)")
        n = launches["flash_attention_fwd"]
        del trainer, state, kfn, xs, ys
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, n_layers=MESH_SYNC_LAYERS)
        xs, ys = device_put_batch(next(stack_batches(iter([one] * MESH_K), MESH_K)),
                                  torch.device("cuda"))
        for name, overrides in [*MESH_SYNC_CASES.items(), ("control", None)]:
            n += _mesh_sync_case(torch, kernels_mod, smi, flash_per_block, cfg, xs, ys, name,
                                 overrides or MESH_SYNC_CASES["buckets_f32"])
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return n


def _c10d_counts(torch, call) -> tuple:
    """Run ``call()`` under the profiler's CPU activity: its result and the
    c10d collectives it dispatched, by op name (``c10d::allreduce_`` ...)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call()
    counts: dict = {}
    for e in prof.events():
        if e.name.startswith("c10d::"):
            counts[e.name] = counts.get(e.name, 0) + 1
    return out, counts


def _device_activity(torch, call) -> dict:
    """The kernels and copies one ``call()`` ran on the card, by name."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return {e.key[:100]: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


def _mesh_sync_case(torch, kernels_mod, smi: str, flash_per_block: float, cfg, xs, ys,
                    name: str, overrides: dict) -> int:
    """One of phase 17's dp and bucketed cases (the module docstring),
    ``name`` "control" the f32 buckets with one bucket left out of the
    graph.  Returns the flash launches of the warm-up and the capture."""
    from unittest import mock

    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.parallel import overlap
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0,
        log_every=1, **overrides), device="cuda", mesh=build_mesh(MeshSpec(dp=1)))
    with mock.patch.object(overlap, "check_sync", lambda *a, **k: None):  # one data rank
        eager_state = trainer.init(seed=0, draw_on_device=True)
        state = trainer.init(seed=0, draw_on_device=True)
    if name == "control":  # the last bucket's parameters left unsynced
        members = state.grad_sync.members[:-1]
        state.grad_sync.remove()
        state.grad_sync = overlap.BucketedGradSync(members, state.grad_sync.group, 1)
    eager = []
    t0 = time.perf_counter()
    for _ in range(MESH_REPLAYS):
        for i in range(MESH_K):
            eager_state, m = trainer.train_step(eager_state, xs[i], ys[i])
            eager.append(m["loss"].item())
    eager_ms = (time.perf_counter() - t0) * 1e3 / (MESH_REPLAYS * MESH_K)
    eager_final = _param_copy(eager_state.model)
    buckets = len(state.grad_sync.members) + (name == "control")
    del eager_state, m
    torch.cuda.empty_cache()
    kfn = trainer.multi_step_fn(MESH_K)
    kernels_mod.reset_launch_counts()
    t0 = time.perf_counter()
    (state, losses), c10d = _c10d_counts(torch, lambda: kfn(state, xs, ys))
    captured = losses.tolist()
    capture_s = time.perf_counter() - t0
    launches = dict(kernels_mod.launch_counts)
    for _ in range(MESH_REPLAYS - 1):
        state, losses = kfn(state, xs, ys)
        captured += losses.tolist()
    final = _param_copy(state.model)
    params_equal = all(torch.equal(final[n], p) for n, p in eager_final.items())
    del final, eager_final
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = kfn(state, xs, ys)
    losses.tolist()
    replay_ms = (time.perf_counter() - t0) * 1e3 / MESH_K
    replay = _device_activity(torch, lambda: kfn(state, xs, ys))
    # The int8 exchange: an all-to-all and three all-gathers a bucket.
    per_bucket = {"c10d::alltoall_base_": 1, "c10d::_allgather_base_": 3} \
        if overrides.get("overlap_compress") else {"c10d::allreduce_": 1}
    # The capture call runs one warm-up step, then captures MESH_K.
    expected = {op: k * buckets * (1 + MESH_K) for op, k in per_bucket.items()}
    row = {"phase": "mesh_captured", "case": name,
           "mesh": "MeshSpec(dp=1), one NCCL rank", "layers": cfg.n_layers, "k": MESH_K,
           "calls": MESH_REPLAYS, "trainer": overrides, "buckets": buckets,
           "captures": kfn.captures, "captured_losses": captured, "eager_losses": eager,
           "losses_bitwise_equal": captured == eager, "params_bitwise_equal": params_equal,
           "c10d_in_capture_call": c10d, "c10d_expected": expected,
           "replay_nccl_kernels": {k: v for k, v in replay.items() if k.startswith("nccl")},
           "replay_copies": {k: v for k, v in replay.items() if k.startswith("Memcpy")},
           "first_call_s": capture_s, "step_ms": replay_ms, "eager_step_ms": eager_ms,
           "launches_in_warmup_and_capture": launches, "nvidia_smi": smi}
    _emit(row)
    counted = c10d == expected
    if name == "control":
        _require(not counted, f"mesh_captured control: a bucket left out of the graph "
                 f"passed the count ({c10d})")
    else:
        _require(kfn.captures == 1, f"mesh_captured {name}: {kfn.captures} captures")
        _require(counted, f"mesh_captured {name}: the graph holds {c10d}, expected {expected}")
        _require(row["losses_bitwise_equal"] and params_equal,
                 f"mesh_captured {name}: the captured steps are not bitwise the eager ones")
    _flash_check(launches, 1 + MESH_K, flash_per_block * cfg.n_layers,
                 f"mesh_captured {name} (warm-up + capture)")
    del trainer, state, kfn
    return launches["flash_attention_fwd"]


def _reshard_worker(rank: int, port: int, out: str) -> int:
    """One of ``live_reshard``'s processes (``chip_smoke.py --reshard-worker
    RANK PORT OUT``): the runs of phase 18, its results as JSON in
    ``OUT.rank<RANK>``, the fallback's checkpoint in ``OUT.ckpt``.  Between
    runs the rank of the lost slice waits at the store until rank 0 is done:
    after a loss rank 0 uses no group of rank 1's."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
    from deeplearning_cfn_tpu_torch.cluster.elasticity import ElasticityController, GroupPolicy
    from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.parallel.mesh import (
        MeshSpec,
        data_group,
        hybrid_mesh_for_slices,
    )
    from deeplearning_cfn_tpu_torch.provision.events import EventBus, EventKind, LifecycleEvent
    from deeplearning_cfn_tpu_torch.train import reshard
    from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_cfn_tpu_torch.train.data import SyntheticTokenDataset, device_put_batch
    from deeplearning_cfn_tpu_torch.train.optimizers import local_part
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    store = dist.distributed_c10d._get_default_store()
    cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=2048), n_layers=RESHARD_LAYERS)
    cuda = torch.device("cuda")
    batches = [device_put_batch(b, cuda) for b in SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size,
        batch_size=2 * RESHARD_BATCH).batches(RESHARD_STEPS)]
    origin = ClusterContract.build(
        cluster_name="chip-live", coordinator_ip="10.0.0.1", other_worker_ips=["10.0.0.2"],
        chips_per_worker=1, storage_mount="/mnt/none",
        slices={"s0": ["10.0.0.1"], "s1": ["10.0.0.2"]})

    def mesh_for(contract):
        return hybrid_mesh_for_slices(contract.slices_count, MeshSpec(fsdp=1), "dp",
                                      device_type="cuda",
                                      ranks=reshard.survivor_ranks(origin, contract))

    def make_trainer(mesh, accum=1):
        return llama.make_trainer(cfg, TrainerConfig(
            strategy="fsdp", optimizer="adamw", learning_rate=3e-4,
            weight_decay=0.1, grad_clip_norm=1.0, log_every=1, grad_accum_steps=accum),
            device="cuda", mesh=mesh)

    def local_state(state) -> dict:
        return {k: local_part(v).detach().clone()
                for k, v in reshard._flat(state.state_dict()).items()}

    def same(a: dict, b: dict) -> bool:
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    def plane():
        class Backend:
            def __init__(self):
                self.events = EventBus()

        vclock = VirtualClock()
        controller = ElasticityController(backend=Backend(), coordinator_queue_name="coord",
                                          slice_loss_window_s=10.0, clock=vclock)
        controller.register(GroupPolicy("s0", 1, "sig-s0", coordinator=True))
        controller.register(GroupPolicy("s1", 1, "sig-s1"))
        controller.attach()
        manager = LiveReshardManager(origin)
        manager.attach(controller)
        return controller, manager, vclock

    def flash_total() -> int:
        return _kernels.launch_counts.get("flash_attention_fwd", 0)

    def run(name: str, steps: int, coordinator=None, controller=None, vclock=None,
            checkpointer=None, trainer=None, state=None, first=0) -> dict:
        """``fit`` over ``batches[first:first + steps]``; per step its time
        (between the pulls of consecutive batches: each step reads its loss
        back) and its flash launches."""
        if trainer is None:
            trainer = make_trainer(mesh_for(origin))
            state = trainer.init(seed=0, draw_on_device=True)
        pulls, flash = [], []

        def source():
            for i, (x, y) in enumerate(batches[first:first + steps]):
                if coordinator is not None and i == RESHARD_DIE_AT and rank == 0:
                    for ip in ("10.0.0.2", "10.0.0.2"):  # the burst, a duplicate in it
                        controller.backend.events.publish(LifecycleEvent(
                            kind=EventKind.INSTANCE_TERMINATE, group="s1", instance_id=ip,
                            detail={"reason": "preempted"}))
                        vclock.advance(0.5)
                    vclock.advance(11.0)
                torch.cuda.synchronize()
                pulls.append(time.perf_counter())
                flash.append(flash_total())
                yield x, y

        from deeplearning_cfn_tpu_torch.train.data import Batch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        state, losses = trainer.fit(state, (Batch(x=x, y=y) for x, y in source()), steps=steps,
                                    prefetch=0, reshard=coordinator, checkpointer=checkpointer)
        torch.cuda.synchronize()
        pulls.append(time.perf_counter())
        flash.append(flash_total())
        n = len(losses)
        launches = dict(_kernels.launch_counts)
        row = {"losses": losses, "step": state.step,
               "step_ms": [(b - a) * 1e3 for a, b in zip(pulls[:n], pulls[1:n + 1])],
               "flash_per_step": [b - a for a, b in zip(flash[:n], flash[1:n + 1])],
               "flash_variants": _variants(launches, "flash_attention_fwd"),
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "grad_accum": trainer.config.grad_accum_steps,
               "topology": reshard.mesh_topology(trainer.mesh)}
        return row, trainer, state

    class Checked(reshard.LiveReshardCoordinator):
        """The coordinator with rank 0's state copied before the pause and
        after the migration (kept as ``stopped_state`` on a fallback, for
        the restore to be held to); ``plant`` zeroes the survivor's Adam
        moments after it, as a re-keying bug would."""

        plant = False
        stopped_state = None

        def execute(self, trainer, state, step):
            before = local_state(state)
            new_state, action = super().execute(trainer, state, step)
            if action == "resume":
                if self.plant:
                    with torch.no_grad():
                        for st in new_state.optimizer.state.values():
                            for k in ("exp_avg", "exp_avg_sq"):
                                local_part(st[k]).zero_()
                self.migrated_bitwise = same(before, local_state(new_state))
            elif action == "stop":
                self.stopped_state = before
            del before
            return new_state, action

    def wait_for_rank0(key: str, mine: dict) -> None:
        if mine.get("left"):
            store.wait([key])
        elif rank == 0:
            store.set(key, "done")

    result = {"rank": rank}
    # straight: no loss, fit without reshard=
    row, trainer, state = run("straight", RESHARD_STEPS)
    result["straight"] = row
    del trainer, state
    torch.cuda.empty_cache()
    # live and its planted control
    for name, steps in (("live", RESHARD_STEPS), ("control", RESHARD_DIE_AT + 1)):
        controller, manager, vclock = plane()
        coordinator = Checked(manager=manager, mesh_for=mesh_for,
                              flush=controller.flush_slice_losses, clock=time.monotonic)
        coordinator.plant = name == "control"
        # The control saves once, at its last step, after the boundary: on
        # rank 0 alone over the survivors' group (fit rebinds the
        # checkpointer).  The live run's step times stay free of saves.
        ck = (Checkpointer(f"{out}.ckpt_{name}", interval_s=None, every_steps=steps,
                           async_save=False) if name == "control" else None)
        row, trainer, state = run(name, steps, coordinator, controller, vclock,
                                  checkpointer=ck)
        if ck is not None and not coordinator.departed:
            row.update(saved_steps=ck.all_steps(), save=dict(ck.last_save))
        row.update(left=coordinator.departed, live_total=coordinator.live_total,
                   fallback_total=coordinator.fallback_total,
                   paused_at=[r.step for r in coordinator.records],
                   migrated_bitwise=getattr(coordinator, "migrated_bitwise", None),
                   pause_ms=[r.seconds * 1e3 for r in coordinator.records],
                   records=[dataclasses.asdict(r) for r in coordinator.records],
                   contract_slices=manager.contract.slices_count)
        result[name] = row
        del trainer, state, coordinator
        torch.cuda.empty_cache()
        wait_for_rank0(f"live_reshard/{name}", row)
    # fallback: stop at the boundary, restore the checkpoint on the survivors' mesh
    with contextlib.nullcontext(f"{out}.ckpt") as tmp:  # one directory for both ranks
        controller, manager, vclock = plane()
        coordinator = Checked(manager=manager, mesh_for=mesh_for,
                              flush=controller.flush_slice_losses, clock=time.monotonic,
                              force_fallback=True)
        ck = Checkpointer(tmp, interval_s=None, every_steps=RESHARD_DIE_AT, async_save=False)
        row, trainer, state = run("fallback", RESHARD_STEPS, coordinator, controller, vclock,
                                  checkpointer=ck)
        row.update(left=coordinator.departed, fallback_total=coordinator.fallback_total,
                   live_total=coordinator.live_total, save=dict(ck.last_save),
                   records=[dataclasses.asdict(r) for r in coordinator.records])
        del trainer, state
        torch.cuda.empty_cache()
        if rank == 0:
            mesh2 = mesh_for(coordinator.fallback_contract)
            accum = reshard.rescale_grad_accum(1, 2, int(mesh2.size()))
            trainer2 = make_trainer(mesh2, accum)
            state2 = trainer2.init(seed=1, draw_on_device=True)
            ck2 = Checkpointer(tmp, interval_s=None, async_save=False,
                               process_group=data_group(mesh2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state2, restore_step = ck2.restore_latest(state2)
            torch.cuda.synchronize()
            restore_wall_ms = (time.perf_counter() - t0) * 1e3
            restored_bitwise = (coordinator.stopped_state is not None
                                and same(coordinator.stopped_state, local_state(state2)))
            coordinator.stopped_state = None
            resumed, _, _ = run("resumed", RESHARD_STEPS - restore_step, trainer=trainer2,
                                state=state2, first=restore_step)
            row.update(restore_step=restore_step, restore=dict(ck2.last_restore),
                       restore_wall_ms=restore_wall_ms, restored_bitwise=restored_bitwise,
                       resumed=resumed,
                       restored_accum=accum, restored_topology=reshard.mesh_topology(mesh2))
            del trainer2, state2
        result["fallback"] = row
    Path(f"{out}.rank{rank}").write_text(json.dumps(result))
    sys.stdout.flush()
    # No teardown of the groups: the lost slice's rank is gone (a gloo
    # teardown with a peer gone may block).
    os._exit(0)


def _live_reshard_phase(torch, smi: str, flash_per_block: float) -> int:
    """Phase 18 (see the module docstring): two processes of this script on
    the card.  Returns the flash launches of both processes' runs."""
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n_layers = RESHARD_LAYERS
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "live_reshard")
        env = dict(os.environ, DEEPLEARNING_SLICES_COUNT="2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--reshard-worker", str(r), str(port), out],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for r in range(2)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=RESHARD_TIMEOUT)
                errs.append(err)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall_s = time.perf_counter() - t0
        for p, err in zip(procs, errs):
            _require(p.returncode == 0, f"live_reshard: a process failed:\n{err[-3000:]}")
        ranks = [json.loads(Path(f"{out}.rank{r}").read_text()) for r in range(2)]
    r0, r1 = ranks
    straight, live, control, fallback = (r0[k] for k in ("straight", "live", "control",
                                                          "fallback"))
    cut = RESHARD_DIE_AT
    resumed = fallback["resumed"]
    fallback_losses = fallback["losses"] + resumed["losses"]

    def within(a: list, b: list) -> float:
        """The largest excess of |a - b| over the tolerance (<= 0 holds)."""
        return max(abs(x - y) - RESHARD_ATOL - RESHARD_RTOL * abs(y) for x, y in zip(a, b))

    per_mb = flash_per_block * n_layers
    before_ms = statistics.median(live["step_ms"][1:cut])
    after_ms = statistics.median(live["step_ms"][cut + 1:])
    row = {"phase": "live_reshard", "processes": 2, "device": "cuda:0 for both",
           "backend": "gloo over CUDA tensors (host-staged)", "slices": 2, "model": "m435",
           "layers": n_layers,
           "S": 2048, "batch_per_rank": RESHARD_BATCH, "global_batch": 2 * RESHARD_BATCH,
           "steps": RESHARD_STEPS, "pause_at_step": cut,
           "strategy": "fsdp (FSDP2 at fsdp 1 under dp 2: HSDP over gloo)",
           "times": "two ranks share the card over gloo before the pause: not NVLink times",
           "wall_s": wall_s,
           "losses": {"straight": straight["losses"], "live": live["losses"],
                      "fallback": fallback_losses, "control": control["losses"],
                      "straight_rank1": r1["straight"]["losses"], "live_rank1": r1["live"]["losses"]},
           "pre_pause_bitwise": live["losses"][:cut] == straight["losses"][:cut],
           "live_excess": within(live["losses"], straight["losses"]),
           "fallback_excess": within(fallback_losses, straight["losses"]),
           "rtol": RESHARD_RTOL, "atol": RESHARD_ATOL,
           "migrated_bitwise": live["migrated_bitwise"],
           "control_migrated_bitwise": control["migrated_bitwise"],
           "live_total": live["live_total"], "fallback_total_live": live["fallback_total"],
           "fallback_run_totals": {"live": fallback["live_total"],
                                   "fallback": fallback["fallback_total"]},
           "rank1_left": [r1[k]["left"] for k in ("live", "control", "fallback")],
           "grad_accum_after": live["grad_accum"],
           "mesh_before": straight["topology"], "mesh_after": live["topology"],
           "flash_per_step_rank0": live["flash_per_step"],
           "flash_per_step_rank1": r1["live"]["flash_per_step"],
           "flash_variants": {k: [r[k]["flash_variants"] for r in ranks]
                              for k in ("straight", "live", "control", "fallback")},
           "step_ms_straight": straight["step_ms"], "step_ms_live": live["step_ms"],
           "step_ms_before_pause": before_ms, "step_ms_after_pause": after_ms,
           "step_ms_without_reshard_arg": statistics.median(straight["step_ms"][1:cut]),
           "step_ms_with_reshard_arg": before_ms,
           "pause_ms": live["pause_ms"], "pause_step_ms": live["step_ms"][cut],
           "fallback_save_ms": fallback["save"].get("blocking_ms"),
           "fallback_save_bytes": fallback["save"].get("bytes"),
           "fallback_restore_ms": fallback["restore"].get("ms"),
           "fallback_restore_wall_ms": fallback["restore_wall_ms"],
           "fallback_restore_step": fallback["restore_step"],
           "fallback_restored_bitwise": fallback["restored_bitwise"],
           "control_saved_steps": control.get("saved_steps"),
           "control_save_ms": control.get("save", {}).get("blocking_ms"),
           "fallback_restored_accum": fallback["restored_accum"],
           "peak_memory_bytes": {k: [r[k]["max_memory_allocated_bytes"] for r in ranks]
                                 for k in ("straight", "live", "control", "fallback")},
           "records": live["records"], "nvidia_smi": smi}
    _emit(row)
    _NOTES["live_reshard_pause_ms"] = row["pause_ms"]
    every = [straight["losses"], live["losses"], fallback_losses, control["losses"],
             r1["straight"]["losses"], r1["live"]["losses"]]
    _require(all(math.isfinite(v) for run in every for v in run), "live_reshard: non-finite loss")
    _require(row["pre_pause_bitwise"], "live_reshard: the live run's first steps are not "
             "bitwise the straight run's")
    _require(row["live_excess"] <= 0 and row["fallback_excess"] <= 0,
             f"live_reshard: live or fallback off the straight run: {row['losses']}")
    _require(live["migrated_bitwise"] is True,
             "live_reshard: the migrated state is not bitwise the pre-pause state")
    _require(control["migrated_bitwise"] is False,
             "live_reshard: the state check passed the planted control (moments zeroed)")
    _require(live["live_total"] == 1 and live["fallback_total"] == 0,
             f"live_reshard: {live['live_total']} live, {live['fallback_total']} fallback")
    _require(fallback["fallback_total"] == 1 and fallback["losses"] == straight["losses"][:cut]
             and fallback["restore_step"] == cut,
             "live_reshard: the fallback did not stop at the boundary and restore its step")
    _require(fallback["restored_bitwise"] is True,
             "live_reshard: the fallback's restored state is not bitwise rank 0's at the "
             "boundary")
    _require(control.get("saved_steps") == [cut + 1],
             f"live_reshard: the save after the boundary: {control.get('saved_steps')}")
    _require(live["grad_accum"] == 2 and fallback["restored_accum"] == 2,
             "live_reshard: accumulation not 2 after the loss")
    _require(straight["topology"] == {"devices": 2, "axes": {"dp": 2}}
             and live["topology"] == {"devices": 1, "axes": {}},
             f"live_reshard: mesh {straight['topology']} -> {live['topology']}")
    _require(all(r1[k]["left"] for k in ("live", "control", "fallback"))
             and r1["live"]["losses"] == live["losses"][:cut],
             "live_reshard: rank 1 did not leave at the boundary")
    _require(live["flash_per_step"] == [per_mb] * cut + [2 * per_mb] * (RESHARD_STEPS - cut)
             and r1["live"]["flash_per_step"] == [per_mb] * cut
             and resumed["flash_per_step"] == [2 * per_mb] * (RESHARD_STEPS - cut),
             f"live_reshard: flash per step {live['flash_per_step']}, rank 1 "
             f"{r1['live']['flash_per_step']}, expected {per_mb} a microbatch")
    _require(all(set(v) <= {"wgmma_tma"} for runs in row["flash_variants"].values()
                 for v in runs), f"live_reshard: flash variants {row['flash_variants']}")
    return sum(sum(r[k]["flash_per_step"]) for r in ranks
               for k in ("straight", "live", "control", "fallback")) + sum(
        resumed["flash_per_step"])


def _provision_template(mount: str) -> dict:
    """Phase 19's local template: one worker, retained local storage at
    ``mount``, the JAX package's Llama job module (the launcher maps it onto
    the port's), m435 at seq 2048 and batch 8; ``Steps`` and
    ``CheckpointDir`` are its parameters (an empty directory: no checkpoint)."""
    return {
        "Parameters": {
            "Steps": {"type": "int", "default": PROV_STEPS, "min": 1},
            "CheckpointDir": {"type": "str", "default": ""},
        },
        "Cluster": {
            "name": "provision-run",
            "backend": "local",
            "pool": {"accelerator_type": "local-1", "workers": 1},
            "storage": {"kind": "local", "mount_point": mount, "retain_on_delete": True},
            "job": {
                "name": "llama-m435",
                "module": "deeplearning_cfn_tpu.examples.llama_train",
                "global_batch_size": 8,
                "args": {"size": "435m", "seq_len": 2048, "global_batch_size": 8,
                         "steps": {"ref": "Steps"}, "log_every": 1,
                         "checkpoint_dir": {"ref": "CheckpointDir"}},
            },
        },
    }


def _provision_run_phase(torch, kernels_mod, smi: str, flash_per_block: float) -> int:
    """Phase 19 (see the module docstring).  Returns the flash launches of
    its Llama runs."""
    import contextlib
    import importlib
    import io
    import tempfile

    from deeplearning_cfn_tpu_torch import cli
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
    from deeplearning_cfn_tpu_torch.cluster.launcher import LocalJobRunner, build_launch_plan
    from deeplearning_cfn_tpu_torch.cluster.recovery import run_with_recovery
    from deeplearning_cfn_tpu_torch.config.template import render_template_file
    from deeplearning_cfn_tpu_torch.obs.recorder import ENV_JOURNAL, configure, read_journal
    from deeplearning_cfn_tpu_torch.provision.local import LocalBackend
    from deeplearning_cfn_tpu_torch.provision.provisioner import Provisioner, worker_group_name
    from deeplearning_cfn_tpu_torch.train import checkpoint as ckpt_mod

    t_phase = time.perf_counter()
    per_step = flash_per_block * 24
    repo = Path(__file__).resolve().parent
    restores = []
    restore_latest = ckpt_mod.Checkpointer.restore_latest

    def recording_restore(self, state):
        out = restore_latest(self, state)
        if out is not None:
            restores.append(dict(self.last_restore))
        return out

    saved_env = {k: os.environ.get(k) for k in ("DLCFN_ROOT", "DLCFN_CHECKPOINT_DIR")}
    ckpt_mod.Checkpointer.restore_latest = recording_restore
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            os.environ.pop("DLCFN_CHECKPOINT_DIR", None)

            # stock: the committed template through the command line, its own process.
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "run",
                 "templates/local.json"], cwd=repo, capture_output=True, text=True,
                env=dict(os.environ, DLCFN_ROOT=str(tmp / "stock-root")),
                timeout=PROV_STOCK_TIMEOUT)
            stock_wall_s = time.perf_counter() - t0
            _require(proc.returncode == 0,
                     f"provision_run: cli run templates/local.json rc {proc.returncode}:\n"
                     f"{proc.stderr[-3000:]}")
            stock = json.loads(proc.stdout.strip().splitlines()[-1])

            os.environ["DLCFN_ROOT"] = str(tmp / "root")
            template = tmp / "provision-run.json"
            mount = tmp / "mount"
            template.write_text(json.dumps(_provision_template(str(mount))))

            # straight: six steps through the command line, in this process.
            kernels_mod.reset_launch_counts()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["run", str(template), "-P", f"Steps={PROV_STEPS}"])
            torch.cuda.synchronize()
            straight_launches = dict(kernels_mod.launch_counts)
            _require(rc == 0, f"provision_run: straight run rc {rc}")
            straight = json.loads(out.getvalue().strip().splitlines()[-1])

            def recovered_run(name: str, keep_checkpoint: bool) -> dict:
                """``run_with_recovery`` over ``Steps=3``: the coordinator
                killed after episode 1; episode 2 gets the checkpoint
                directory only when ``keep_checkpoint``."""
                journal = tmp / f"{name}.jsonl"
                configure(journal)
                spec = render_template_file(template, {
                    "Steps": str(PROV_EPISODE_STEPS), "CheckpointDir": str(mount / name)})
                backend = LocalBackend()
                prov = Provisioner(backend, spec)
                contract_json = ClusterContract.root_dir() / "contract.json"
                episodes = []

                def train_once(result) -> dict:
                    plan = build_launch_plan(result.contract, spec.job, result.job_violation)
                    job = dict(spec.job.args)
                    if episodes and not keep_checkpoint:
                        job["checkpoint_dir"] = ""
                    job_args = [a for k, v in sorted(job.items()) for a in (f"--{k}", str(v))]
                    main = importlib.import_module(plan.module).main
                    n_restores = len(restores)
                    kernels_mod.reset_launch_counts()
                    res = LocalJobRunner(plan).run(main, job_args)
                    torch.cuda.synchronize()
                    episodes.append({
                        "result": res, "launches": dict(kernels_mod.launch_counts),
                        "module": plan.module, "storage": result.storage.storage_id,
                        "storage_created": result.storage.created,
                        "workers": result.contract.workers_count,
                        "contract_mtime_ns": contract_json.stat().st_mtime_ns,
                        "env_sh": (contract_json.parent / "env.sh").read_text(),
                        "restore": restores[n_restores:]})
                    if len(episodes) == 1:
                        group = backend.describe_group(worker_group_name(spec.name))
                        coordinator = min(group.instances, key=lambda i: i.index)
                        backend.kill_instance(coordinator.instance_id)
                    return {"final_step": res["end_step"]}

                t0 = time.perf_counter()
                final, _, recoveries = run_with_recovery(prov, train_once, max_recoveries=1)
                wall_s = time.perf_counter() - t0
                events = list(read_journal(journal))
                configure(os.environ.get(ENV_JOURNAL) or None)
                recover_s = [e["seconds"] for e in events
                             if e.get("kind") == "span" and e.get("span") == "recover"]
                kinds = [e.get("kind") for e in events]
                return {"episodes": episodes, "final_step": final["final_step"],
                        "recoveries": recoveries, "wall_s": wall_s, "recover_s": recover_s,
                        "recovery_start": kinds.count("recovery_start"),
                        "recovery_done": kinds.count("recovery_done")}

            recovered = recovered_run("recovered", keep_checkpoint=True)
            control = recovered_run("control", keep_checkpoint=False)
    finally:
        ckpt_mod.Checkpointer.restore_latest = restore_latest
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def losses(result: dict) -> list:
        return [h["loss"] for h in result["history"]]

    def resumed(run: dict) -> list:
        """The run's losses if it resumed where episode 1 stopped, else None."""
        ep1, ep2 = (e["result"] for e in run["episodes"])
        if ep1["start_step"] != 0 or ep2["start_step"] != ep1["end_step"]:
            return None
        return losses(ep1) + losses(ep2)

    tokens = 8 * 2048
    straight_result = straight["result"]
    s_sum = _run_summary(straight_result, tokens, tokens)
    ep1, ep2 = recovered["episodes"]
    e2_sum = _run_summary(ep2["result"], tokens, tokens)
    recover_s = recovered["recover_s"][0] if recovered["recover_s"] else None
    restore_ms = ep2["restore"][0]["ms"] if ep2["restore"] else None
    row = {"phase": "provision_run", "model": "m435", "S": 2048, "batch": 8,
           "template_module": "deeplearning_cfn_tpu.examples.llama_train",
           "ran_module": ep1["module"],
           "stock": {"rc": proc.returncode, "wall_s": stock_wall_s,
                     "template_to_first_step_s": stock.get("template_to_first_step_s"),
                     "first_step_s": stock["result"]["first_step_s"],
                     "final_loss": stock["result"]["final_loss"],
                     "device": stock["result"]["device"], "steps": stock["result"]["steps"]},
           "straight": {"template_to_first_step_s": straight.get("template_to_first_step_s"),
                        "first_step_s": straight_result["first_step_s"],
                        "losses": s_sum["losses"], "step_ms": s_sum["step_ms"],
                        "steady_step_ms": s_sum["steady_step_ms"], "mfu": s_sum["mfu"],
                        "device": straight_result["device"]},
           "recovered": {"recoveries": recovered["recoveries"],
                         "starts": [e["result"]["start_step"] for e in recovered["episodes"]],
                         "final_step": recovered["final_step"],
                         "losses": resumed(recovered),
                         "storage": [e["storage"] for e in recovered["episodes"]],
                         "storage_created": [e["storage_created"]
                                             for e in recovered["episodes"]],
                         "workers": [e["workers"] for e in recovered["episodes"]],
                         "recovery_start": recovered["recovery_start"],
                         "recovery_done": recovered["recovery_done"],
                         "wall_s": recovered["wall_s"]},
           "control": {"starts": [e["result"]["start_step"] for e in control["episodes"]],
                       "losses": [losses(e["result"]) for e in control["episodes"]],
                       "resumed": resumed(control) is not None},
           "recover_s": recover_s,
           "episode2_restore_ms": restore_ms,
           "episode2_first_step_s": ep2["result"]["first_step_s"],
           "episode2_first_step_ms": e2_sum["step_ms"][0],
           "time_to_recover_s": (recover_s + ep2["result"]["first_step_s"]
                                 if recover_s is not None else None),
           "time_to_recover_basis": "recover span + episode 2 from its main() to its first "
                                    "step (model init, restore and the step)",
           "flash_variants": {"straight": _variants(straight_launches, "flash_attention_fwd"),
                              **{f"{name}{i + 1}": _variants(e["launches"], "flash_attention_fwd")
                                 for name, run in (("recovered", recovered), ("control", control))
                                 for i, e in enumerate(run["episodes"])}},
           "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    _emit(row)
    rec = row["recovered"]
    every = [losses(straight_result), *(losses(e["result"]) for run in (recovered, control)
                                        for e in run["episodes"])]
    _require(all(math.isfinite(v) for run in every for v in run)
             and math.isfinite(stock["result"]["final_loss"]), "provision_run: non-finite loss")
    _require(stock["result"]["device"].startswith("cuda")
             and straight_result["device"].startswith("cuda"),
             f"provision_run: the runs trained on {stock['result']['device']}, "
             f"{straight_result['device']}")
    _require(row["ran_module"] == "deeplearning_cfn_tpu_torch.examples.llama_train",
             f"provision_run: the plan ran {row['ran_module']}")
    _require(rec["recoveries"] == 1, f"provision_run: {rec['recoveries']} recoveries")
    _require(rec["starts"] == [0, PROV_EPISODE_STEPS] and rec["final_step"] == PROV_STEPS,
             f"provision_run: episodes started at {rec['starts']}, ended at {rec['final_step']}")
    _require(rec["storage"][0] == rec["storage"][1] and rec["storage_created"][1] is False,
             f"provision_run: storage {rec['storage']}, created {rec['storage_created']}")
    _require(ep2["contract_mtime_ns"] > ep1["contract_mtime_ns"] and rec["workers"] == [1, 1]
             and "DEEPLEARNING_WORKERS_COUNT=1\n" in ep2["env_sh"],
             "provision_run: the contract was not rewritten for 1 worker")
    _require(rec["recovery_start"] == 1 and rec["recovery_done"] == 1,
             f"provision_run: the journal holds {rec['recovery_start']} recovery_start, "
             f"{rec['recovery_done']} recovery_done")
    _require(recover_s is not None and restore_ms is not None,
             "provision_run: no recover span or no restore in episode 2")
    _require(rec["losses"] == losses(straight_result),
             f"provision_run: recovered steps {rec['losses']} are not bitwise the straight "
             f"run's {losses(straight_result)}")
    _require(resumed(control) is None and control["episodes"][1]["result"]["start_step"] == 0,
             "provision_run: the resume check passed the planted control (no checkpoint)")
    checked = [_flash_check(straight_launches, PROV_STEPS, per_step, "provision_run/straight")]
    for name, run in (("recovered", recovered), ("control", control)):
        for i, e in enumerate(run["episodes"]):
            checked.append(_flash_check(e["launches"], PROV_EPISODE_STEPS, per_step,
                                        f"provision_run/{name}{i + 1}"))
    return sum(c["flash_launches"] for c in checked)


def _broker_template(mount: str) -> dict:
    """Phase 20's local template: two workers of ``local-1``, retained local
    storage at ``mount``, the JAX package's Llama job module (the launcher
    maps it onto the port's), m435 at seq 2048 and batch 8 for ``Steps``
    steps, on the card (no ``device`` arg); the provisioner polls every
    ``BROKER_POLL_S``."""
    return {
        "Parameters": {"Steps": {"type": "int", "default": BROKER_STEPS, "min": 1}},
        "Cluster": {
            "name": BROKER_CLUSTER,
            "backend": "local",
            "pool": {"accelerator_type": "local-1", "workers": 2},
            "storage": {"kind": "local", "mount_point": mount, "retain_on_delete": True},
            "timeouts": {"cluster_ready_s": BROKER_TIMEOUT, "controller_launch_s": 30.0,
                         "poll_interval_s": BROKER_POLL_S},
            "job": {
                "name": "llama-m435",
                "module": "deeplearning_cfn_tpu.examples.llama_train",
                "global_batch_size": 8,
                "args": {"size": "435m", "seq_len": 2048, "global_batch_size": 8,
                         "steps": {"ref": "Steps"}, "log_every": 1},
            },
        },
    }


def _provision_broker_phase(smi: str, flash_per_block: float) -> int:
    """Phase 20 (see the module docstring).  Returns the flash launches of
    the controller's Llama run."""
    import signal
    import tempfile

    from deeplearning_cfn_tpu_torch.cluster.broker_client import broker_binary_path, build_broker
    from deeplearning_cfn_tpu_torch.obs.recorder import read_journal

    t_phase = time.perf_counter()
    per_step = flash_per_block * 24
    repo = Path(__file__).resolve().parent

    # 1. The broker from native/broker/broker.cpp into build/torch_native/,
    # on no other clock (0 when a build of this source is there already).
    cached = broker_binary_path().exists()
    t0 = time.perf_counter()
    build_broker()
    broker_build_s = 0.0 if cached else time.perf_counter() - t0

    procs: list = []
    pid = None
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        template = tmp / "provision-broker.json"
        template.write_text(json.dumps(_broker_template(str(tmp / "mount"))))
        ctrl_root = tmp / "controller"
        base_env = {k: v for k, v in os.environ.items() if k != "DLCFN_BROKER_TOKEN"}
        ctrl_env = dict(base_env, DLCFN_ROOT=str(ctrl_root),
                        DLCFN_FLIGHT_JOURNAL=str(tmp / "controller.jsonl"))
        cli_cmd = [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli"]
        try:
            # 2-3. The controller: the operator's command, in its own process.
            t_start = time.time()
            controller = subprocess.Popen(
                cli_cmd + ["run", str(template), "--broker", "auto"], cwd=repo, env=ctrl_env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append(controller)
            # 4. The agents learn the broker as a VM would: from the record
            # the controller stamps (the VM metadata), not from this script.
            record_path = ctrl_root / "broker" / f"{BROKER_CLUSTER}.json"
            deadline = time.monotonic() + BROKER_TIMEOUT
            while not record_path.exists():  # written whole, then renamed into place
                if controller.poll() is not None or time.monotonic() > deadline:
                    controller.kill()
                    _require(False, f"provision_broker: no broker record, controller rc "
                             f"{controller.wait()}:\n{controller.stderr.read()[-3000:]}")
                time.sleep(0.05)
            rec = json.loads(record_path.read_text())
            pid = int(rec["pid"])
            _require(bool(rec.get("token")), "provision_broker: the broker requires no AUTH")

            def agent(index: int, name: str, token: str | None, budget_s: float):
                env = dict(base_env, DLCFN_CLUSTER=BROKER_CLUSTER, DLCFN_WORKER_INDEX=str(index),
                           DLCFN_BROKER=f"{rec['host']}:{rec['port']}",
                           DLCFN_GROUPS=f"{BROKER_CLUSTER}-workers",
                           DLCFN_STORAGE_MOUNT=str(tmp / "mount"),
                           DLCFN_BOOTSTRAP_BUDGET_S=str(budget_s),
                           DLCFN_POLL_INTERVAL_S=str(BROKER_POLL_S),
                           DLCFN_ROOT=str(tmp / name),
                           DLCFN_FLIGHT_JOURNAL=str(tmp / f"{name}.jsonl"),
                           DLCFN_BLACKBOX_DIR=str(tmp / "blackbox"))
                if token:
                    env["DLCFN_BROKER_TOKEN"] = token
                proc = subprocess.Popen(
                    [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cluster.agent_main"],
                    cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                procs.append(proc)
                return proc

            intruder = agent(7, "intruder", None, 10.0)
            agents = [agent(i, f"vm{i}", rec["token"], BROKER_TIMEOUT) for i in range(2)]
            ctrl_out, ctrl_err = controller.communicate(timeout=BROKER_TIMEOUT + 300)
            agent_out = [a.communicate(timeout=60)[0] for a in agents]
            intruder_out = intruder.communicate(timeout=60)[0]
            # 5. The controller first: a failed controller leaves the agents
            # dying on their budget, which would hide the cause.
            _require(controller.returncode == 0,
                     f"provision_broker: controller rc {controller.returncode}:\n"
                     f"{ctrl_err[-3000:]}")
            for i, a in enumerate(agents):
                _require(a.returncode == 0,
                         f"provision_broker: agent {i} rc {a.returncode}:\n{agent_out[i][-3000:]}")
            _require(intruder.returncode != 0 and "auth required" in intruder_out,
                     f"provision_broker: the tokenless agent exited {intruder.returncode}:\n"
                     f"{intruder_out[-2000:]}")
            record = json.loads(ctrl_out.strip().splitlines()[-1])
            contracts = [(root / "contract.json").read_bytes()
                         for root in (ctrl_root, tmp / "vm0", tmp / "vm1")]

            # 6. The broker's state, read back while it lives.
            def status(*extra) -> dict:
                proc = subprocess.run(cli_cmd + ["status", "--cluster", BROKER_CLUSTER, *extra],
                                      cwd=repo, env=ctrl_env, capture_output=True, text=True,
                                      timeout=120)
                _require(proc.returncode == 0,
                         f"provision_broker: status {extra} rc {proc.returncode}:\n{proc.stderr}")
                return json.loads(proc.stdout)

            liveness = status().get("liveness") or {}
            fleet = status("--fleet").get("fleet") or {}

            # 7. Tear down with the cluster.
            deleted = subprocess.run(cli_cmd + ["delete", str(template)], cwd=repo,
                                     env=ctrl_env, capture_output=True, text=True, timeout=120)
            _require(deleted.returncode == 0,
                     f"provision_broker: delete rc {deleted.returncode}:\n{deleted.stderr}")
            teardown = json.loads(deleted.stdout)
            deadline = time.monotonic() + 10
            gone = False
            while not gone and time.monotonic() < deadline:
                try:
                    os.kill(pid, 0)
                    time.sleep(0.05)
                except ProcessLookupError:
                    gone = True
            record_left = record_path.exists()
            events = {name: list(read_journal(tmp / f"{name}.jsonl"))
                      for name in ("controller", "vm0", "vm1")}
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
            if pid is not None:
                try:
                    os.kill(pid, signal.SIGKILL)  # only if delete left it
                except ProcessLookupError:
                    pass

    def first(name: str, kind: str) -> float | None:
        return next((e["ts"] for e in events[name] if e.get("kind") == kind), None)

    result = record["result"]
    tokens = 8 * 2048
    summary = _run_summary(result, tokens, tokens)
    started = first("controller", "broker_started")
    ready = first("vm0", "bootstrap_complete")
    workers = [f"{BROKER_CLUSTER}-workers/{i}" for i in range(2)]
    row = {"phase": "provision_broker", "model": "m435", "S": 2048, "batch": 8,
           "workers": 2, "poll_interval_s": BROKER_POLL_S,
           "broker_build_s": broker_build_s, "broker_cached": cached,
           "template_to_first_step_s": record.get("template_to_first_step_s"),
           "first_step_s": result["first_step_s"],
           "bootstrap_s": (ready - started) if started and ready else None,
           "bootstrap_basis": "the controller's broker_started event to the coordinator "
                              "agent's bootstrap_complete (its ready signal), one host clock",
           "broker_started_after_s": (started - t_start) if started else None,
           "steps": result["steps"], "device": result["device"],
           "losses": summary["losses"], "step_ms": summary["step_ms"],
           "steady_step_ms": summary["steady_step_ms"], "mfu": summary["mfu"],
           "contracts_equal": len(set(contracts)) == 1,
           "beats": {w: (liveness.get(w) or {}).get("beats") for w in workers},
           "liveness_states": {w: (liveness.get(w) or {}).get("state") for w in workers},
           "telemetry_frames": {w: ((fleet.get("workers") or {}).get(w) or {}).get("count")
                                for w in workers},
           "fleet_hosts": fleet.get("hosts"),
           "fleet_gauges": sorted(fleet.get("gauges") or {}),
           "intruder_rc": intruder.returncode,
           "delete": {k: teardown.get(k) for k in ("broker", "pid")},
           "broker_gone_within_10s": gone, "record_left": record_left,
           "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi}
    _emit(row)
    _require(result["steps"] == BROKER_STEPS and result["device"] == "cuda:0",
             f"provision_broker: {result['steps']} steps on {result['device']}")
    _require(all(math.isfinite(v) for v in summary["losses"]), "provision_broker: non-finite loss")
    _require(row["contracts_equal"], "provision_broker: the three contract.json files differ")
    _require(all((row["beats"][w] or 0) >= 1 for w in workers),
             f"provision_broker: liveness {liveness}")
    _require(fleet.get("hosts") == 2 and all(row["telemetry_frames"][w] for w in workers),
             f"provision_broker: fleet {fleet}")
    _require(teardown.get("broker") == "stopped" and gone and not record_left,
             f"provision_broker: delete {teardown}, pid gone {gone}, record left {record_left}")
    _require(started is not None and ready is not None,
             "provision_broker: no broker_started or bootstrap_complete in the journals")
    return _flash_check(result["kernel_launches"], BROKER_STEPS, per_step,
                        "provision_broker")["flash_launches"]


def _local_tensors(torch, state) -> dict:
    """Every parameter, buffer and optimizer state tensor of ``state`` that
    this rank holds (its local part of a sharded one), by key."""
    from deeplearning_cfn_tpu_torch.train import reshard
    from deeplearning_cfn_tpu_torch.train.optimizers import local_part

    return {k: local_part(v).detach() for k, v in reshard._flat(state.state_dict()).items()}


def _bitwise_across(torch, mine: dict, group) -> bool:
    """Whether ``mine`` (``_local_tensors``) is, bit for bit, the first rank
    of ``group``'s: that rank broadcasts each tensor over the group, the
    others compare their bits with it, and the ranks agree on the verdict."""
    import torch.distributed as dist

    views = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    src = dist.get_global_rank(group, 0)
    same = True
    with torch.no_grad():
        for key in sorted(mine):
            t = mine[key].contiguous()
            theirs = t if dist.get_rank() == src else torch.empty_like(t)
            dist.broadcast(theirs, src=src, group=group)
            bits = views[t.element_size()]
            same = same and torch.equal(theirs.view(bits), t.view(bits))
    verdict = torch.tensor([int(same)])
    dist.all_reduce(verdict, op=dist.ReduceOp.MIN, group=group)
    return bool(verdict.item())


def _sched_worker(rank: int, port: int, out: str) -> int:
    """One of ``sched_flash_crowd``'s processes (``chip_smoke.py
    --sched-worker RANK PORT OUT``): the straight run, then the incident (on
    rank 0 with the ``FlashCrowd`` world: the serve pool, the arbiter, the
    SLO engine), its results as JSON in ``OUT.rank<RANK>``.  Its journal is
    ``$DLCFN_FLIGHT_JOURNAL``, its black box under ``OUT.blackbox``, its
    metrics stream under ``OUT.metrics``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from deeplearning_cfn_tpu_torch.chaos.scenarios import (
        CROWD_STEPS,
        FlashCrowd,
        crowd_train_contract,
    )
    from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.obs.blackbox import BlackBox
    from deeplearning_cfn_tpu_torch.obs.profiler import StepProfiler
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, hybrid_mesh_for_slices
    from deeplearning_cfn_tpu_torch.provision.events import EventBus, EventKind, LifecycleEvent
    from deeplearning_cfn_tpu_torch.serve import ContinuousBatchingEngine, ServeConfig
    from deeplearning_cfn_tpu_torch.train import reshard
    from deeplearning_cfn_tpu_torch.train.data import (
        Batch,
        SyntheticTokenDataset,
        device_put_batch,
    )
    from deeplearning_cfn_tpu_torch.train.metrics import JsonlMetricsSink, ThroughputLogger
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=2048), n_layers=SCHED_LAYERS)
    cuda = torch.device("cuda")
    batches = [device_put_batch(b, cuda) for b in SyntheticTokenDataset(
        seq_len=2048, vocab_size=cfg.vocab_size,
        batch_size=2 * SCHED_BATCH).batches(CROWD_STEPS)]
    origin = crowd_train_contract(hosts_per_slice=1)

    def mesh_for(contract):
        return hybrid_mesh_for_slices(contract.slices_count, MeshSpec(fsdp=1), "dp",
                                      device_type="cuda",
                                      ranks=reshard.survivor_ranks(origin, contract))

    def make_trainer():
        return llama.make_trainer(cfg, TrainerConfig(
            strategy="fsdp", optimizer="adamw", learning_rate=3e-4, weight_decay=0.1,
            grad_clip_norm=1.0, log_every=1, grad_accum_steps=1), device="cuda",
            mesh=mesh_for(origin))

    def flash_total() -> int:
        return _kernels.launch_counts.get("flash_attention_fwd", 0)

    def fit(trainer, state, first, coordinator=None, crowd=None, **kw):
        """``fit`` over ``batches[first:]``: per step its time less the
        world's round (each step reads its loss back), the round's time,
        and the flash launches."""
        marks, rounds, flash = [], [], []

        def source():
            for i, (x, y) in enumerate(batches[first:], start=first):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                flash.append(flash_total())
                t0 = time.perf_counter()
                if crowd is not None:
                    crowd.round(i)
                    if "mid" not in result and coordinator.live_total == 1:
                        result["mid"] = {"topology": reshard.mesh_topology(trainer.mesh),
                                         "grad_accum": trainer.config.grad_accum_steps}
                torch.cuda.synchronize()
                rounds.append(time.perf_counter() - t0)
                yield Batch(x=x, y=y)

        state, losses = trainer.fit(state, source(), steps=CROWD_STEPS - first, prefetch=0,
                                    reshard=coordinator, **kw)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        flash.append(flash_total())
        n = len(losses)
        return state, {"losses": losses,
                       "step_ms": [(b - a - r) * 1e3 for a, b, r in
                                   zip(marks[:n], marks[1:n + 1], rounds)],
                       "round_ms": [r * 1e3 for r in rounds[:n]],
                       "flash_per_step": [b - a for a, b in zip(flash[:n], flash[1:n + 1])]}

    result: dict = {"rank": rank}
    # straight: the same steps with no world and no reshard=
    _kernels.reset_launch_counts()
    trainer = make_trainer()
    _, row = fit(trainer, trainer.init(seed=0, draw_on_device=True), 0)
    row["flash_variants"] = _variants(dict(_kernels.launch_counts), "flash_attention_fwd")
    result["straight"] = row
    del trainer
    torch.cuda.empty_cache()

    # the incident
    _kernels.reset_launch_counts()
    crowd = bus = None
    if rank == 0:
        model = _llama_on_card(torch, llama, cfg, seed=0)
        model.eval()

        def make_engine(name, slots, clock):
            scfg = ServeConfig(num_slots=slots, block_size=4, blocks_per_slot=8,
                               prefill_len=16)
            return ContinuousBatchingEngine(model, scfg, clock=clock, name=name,
                                            journal=False)

        crowd = FlashCrowd(0, make_engine, origin, vocab_size=cfg.vocab_size,
                           serve_clock=time.perf_counter)
        manager, bus = crowd.manager, crowd.backend.events
    else:
        manager, bus = LiveReshardManager(origin), EventBus()
    profiler = StepProfiler(name="train", per_step_events=True)
    box = BlackBox(f"{out}.blackbox", host=f"rank{rank}", worker=f"rank{rank}",
                   instance_id=None if rank == 0 else origin.slices["s2"][0],
                   profiler=profiler, recorder=get_recorder())
    box.attach(bus)
    coordinator = reshard.LiveReshardCoordinator(
        manager=manager, mesh_for=mesh_for,
        flush=crowd.controller.flush_slice_losses if crowd is not None else None,
        clock=time.monotonic, symmetric_accum=True)
    execute = coordinator.execute

    control: dict = {}

    def compared(state) -> None:
        """After the regrowth, on both ranks (outside the pause): the state
        against rank 0's, then the planted control against it."""
        result["regrown_bitwise"] = _bitwise_across(torch, _local_tensors(torch, state),
                                                    coordinator.group)
        mine = control if rank == 1 else _local_tensors(torch, state)
        result["control_bitwise"] = _bitwise_across(torch, mine, coordinator.group)
        control.clear()

    def recorded(trainer, state, step):
        state, action = execute(trainer, state, step)
        if action == "resume" and coordinator.live_total == 2:
            compared(state)
        return state, action

    coordinator.execute = recorded
    if rank == 1:
        # The planted control: what a grow without the transfer leaves on the
        # returning rank (a copy of its state as laid out, before the fill).
        regrow = reshard._regrow

        def kept(state, new, *args):
            control.update({k: v.clone() for k, v in _local_tensors(torch, new).items()})
            return regrow(state, new, *args)

        reshard._regrow = kept
    logger = ThroughputLogger(global_batch_size=2 * SCHED_BATCH, log_every=1,
                              sink=JsonlMetricsSink(Path(f"{out}.metrics") / "sched"
                                                    / f"worker{rank}.jsonl"))
    trainer = make_trainer()
    state, live = fit(trainer, trainer.init(seed=0, draw_on_device=True), 0, coordinator,
                      crowd, profiler=profiler, logger=logger)
    result["left_at"] = len(live["losses"]) if coordinator.departed else None
    if coordinator.departed:
        # The preemption's notice on this host's bus (its black box captures).
        bus.publish(LifecycleEvent(kind=EventKind.INSTANCE_TERMINATE, group="s2",
                                   instance_id=origin.slices["s2"][0],
                                   detail={"reason": "sched-preempt"}))
        state = coordinator.rejoin(trainer, state)
        _require(state is not None, "sched_flash_crowd: rank 1 was released, not regrown")
        result["rejoined_at"] = state.step
        compared(state)
        state, more = fit(trainer, state, state.step, coordinator, profiler=profiler,
                          logger=logger)
        live = {k: live[k] + more[k] for k in live}
    profiler.journal()
    logger.sink.close()
    live["flash_variants"] = _variants(dict(_kernels.launch_counts), "flash_attention_fwd")
    result.update(live=live, step=state.step, records=[dataclasses.asdict(r)
                                                       for r in coordinator.records],
                  post={"topology": reshard.mesh_topology(trainer.mesh),
                        "grad_accum": trainer.config.grad_accum_steps},
                  slices=manager.contract.slices_count, live_total=coordinator.live_total,
                  fallback_total=coordinator.fallback_total)
    if crowd is not None:
        coordinator.release()
        t0 = time.perf_counter()
        crowd.drain()
        result["drain_s"] = time.perf_counter() - t0
        for replica in crowd.frontend.replicas.values():
            get_recorder().record("serve_metrics", **replica.engine.snapshot())
        result["crowd"] = crowd.summary()
        result["journal"] = result["crowd"]["journal"]
        result["serve_graphs"] = [r.engine.decode_captures
                                  for r in crowd.frontend.replicas.values()]
    Path(f"{out}.rank{rank}").write_text(json.dumps(result))
    sys.stdout.flush()
    dist.barrier()  # both ranks are back in the group
    os._exit(0)


def _sched_flash_crowd_phase(torch, smi: str, flash_per_block: float) -> int:
    """Phase 21 (see the module docstring): two processes of this script on
    the card, then the obs commands over their files.  Returns the flash
    launches of both processes' runs."""
    import contextlib
    import io
    import socket
    import tempfile

    from deeplearning_cfn_tpu_torch import cli
    from deeplearning_cfn_tpu_torch.chaos.scenarios import (
        CROWD_STEPS,
        ScenarioReport,
        crowd_checks,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n_layers = SCHED_LAYERS
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "sched")
        procs = []
        for r in range(2):
            env = dict(os.environ, DLCFN_WORKER=f"rank{r}",
                       DLCFN_FLIGHT_JOURNAL=f"{out}.journal.rank{r}")
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                           "--sched-worker", str(r), str(port), out],
                                          env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=SCHED_TIMEOUT)
                errs.append(err)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        workers_s = time.perf_counter() - t_phase
        for p, err in zip(procs, errs):
            _require(p.returncode == 0, f"sched_flash_crowd: a process failed:\n{err[-3000:]}")
        r0, r1 = (json.loads(Path(f"{out}.rank{r}").read_text()) for r in range(2))

        def run_cli(*argv) -> str:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
                rc = cli.main(list(argv))
            _require(rc == 0, f"sched_flash_crowd: cli {argv[0]} exited {rc}")
            return buf.getvalue()

        j0, j1 = f"{out}.journal.rank0", f"{out}.journal.rank1"
        prom = run_cli("status", "--journal", j0, "--profile", "--serve", "--format", "prom")
        run_cli("trace", "--journal", j0, "--journal", j1, "--out", f"{out}.trace.json")
        trace = json.loads(Path(f"{out}.trace.json").read_text())
        rows = sorted(e["args"]["name"] for e in trace["traceEvents"]
                      if e.get("name") == "process_name")
        postmortem = run_cli("postmortem", f"{out}.blackbox")
        workers = json.loads(run_cli("status", "--metrics-dir", f"{out}.metrics"))
    wall_s = time.perf_counter() - t_phase

    report = ScenarioReport("sched-flash-crowd", 0)
    c = r0["crowd"]
    report.check(c["initial"] == {"serve-chat": ["s0"], "train-fsdp": ["s1", "s2"]},
                 "placer gave prod-serve the first slice and prod-train the rest")
    crowd_checks(report, r0, r0["straight"]["losses"], r0["live"]["losses"],
                 {**(r0.get("mid") or {"topology": None, "grad_accum": None}),
                  "want": {"devices": 1, "axes": {}}},
                 {**r0["post"], "want": {"devices": 2, "axes": {"dp": 2}}},
                 SCHED_RTOL, SCHED_ATOL)
    records = r0["records"]
    shrink, grow = (rec["step"] for rec in records[:2])
    live, straight = r0["live"], r0["straight"]

    def median(xs):
        return statistics.median(xs) if xs else None

    per_mb = flash_per_block * n_layers
    mb0 = CROWD_STEPS + (grow - shrink)
    mb1 = shrink + (CROWD_STEPS - grow)
    ttft = sorted(c["ttft_s"])
    row = {"phase": "sched_flash_crowd", "processes": 2, "device": "cuda:0 for both",
           "backend": "gloo over CUDA tensors (host-staged)", "model": "m435",
           "n_layers": n_layers, "S": 2048,
           "batch_per_rank": SCHED_BATCH, "global_batch": 2 * SCHED_BATCH,
           "steps": CROWD_STEPS,
           "serve": f"m435 at {n_layers} layers, bf16, seed 0, pool-a/pool-b 4 slots, lent 6",
           "strategy": "fsdp (FSDP2 at fsdp 1 under dp 2: HSDP over gloo)",
           "times": "two ranks and the pool share the card: not NVLink times",
           "wall_s": wall_s, "workers_s": workers_s,
           "shrink_at": shrink, "grow_at": grow,
           "pause_ms": {"shrink": records[0]["seconds"] * 1e3,
                        "regrowth": records[1]["seconds"] * 1e3},
           "rank1_regrowth_ms": r1["records"][-1]["seconds"] * 1e3 if r1["records"] else None,
           "step_ms": {"before": median(live["step_ms"][1:shrink]),
                       "lent": median(live["step_ms"][shrink + 1:grow]),
                       "after": median(live["step_ms"][grow + 1:]),
                       "straight": median(straight["step_ms"][1:])},
           "step_ms_all": live["step_ms"], "round_ms": live["round_ms"],
           "ttft_ms": {"p50": 1e3 * ttft[len(ttft) // 2] if ttft else None,
                       "p99": 1e3 * ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))]
                       if ttft else None},
           "pool_tokens_per_s": c["tokens"] / c["serve_s"] if c["serve_s"] else None,
           "pool_tokens": c["tokens"], "pool_serve_s": c["serve_s"], "drain_s": r0["drain_s"],
           "requests": c["requests"], "completions": c["completions"],
           "timeline": c["timeline"], "counters": c["counters"],
           "serve_graphs": r0["serve_graphs"],
           "losses": {"straight": straight["losses"], "live": live["losses"],
                      "rank1": r1["live"]["losses"]},
           "pre_preempt_bitwise": live["losses"][:shrink] == straight["losses"][:shrink],
           "rtol": SCHED_RTOL, "atol": SCHED_ATOL,
           "regrown_bitwise": [r0.get("regrown_bitwise"), r1.get("regrown_bitwise")],
           "control_bitwise": [r0.get("control_bitwise"), r1.get("control_bitwise")],
           "grad_accum": [rec["grad_accum_after"] for rec in records],
           "flash": {"rank0": sum(live["flash_per_step"]), "rank1": sum(
               r1["live"]["flash_per_step"]), "microbatches": [mb0, mb1],
               "per_microbatch": per_mb},
           "flash_variants": [r0["live"]["flash_variants"], r1["live"]["flash_variants"],
                              r0["straight"]["flash_variants"],
                              r1["straight"]["flash_variants"]],
           "trace_rows": rows, "postmortem_head": postmortem.splitlines()[:1],
           "metrics_workers": [(w["worker"], w.get("step")) for w in workers],
           "invariants": report.invariants, "violations": report.violations,
           "nvidia_smi": smi}
    _emit(row)
    _require(report.passed, f"sched_flash_crowd: {report.violations}")
    _require(row["pre_preempt_bitwise"], "sched_flash_crowd: the steps before the "
             "preemption are not bitwise the straight run's")
    _require(row["grad_accum"] == [2, 1], f"sched_flash_crowd: accumulation {row['grad_accum']}")
    _require(r1["left_at"] == shrink and r1["rejoined_at"] == grow
             and r1["live"]["losses"] == live["losses"][:shrink] + live["losses"][grow:],
             "sched_flash_crowd: rank 1 did not park at the shrink and train on from the grow")
    _require(row["regrown_bitwise"] == [True, True],
             "sched_flash_crowd: the ranks' states differ after the regrowth")
    _require(row["control_bitwise"] == [False, False], "sched_flash_crowd: the state check "
             "passed the planted control (a grow without the transfer)")
    _require(sum(live["flash_per_step"]) == per_mb * mb0
             and sum(r1["live"]["flash_per_step"]) == per_mb * mb1
             and sum(straight["flash_per_step"]) == sum(r1["straight"]["flash_per_step"])
             == per_mb * CROWD_STEPS,
             f"sched_flash_crowd: flash launches {row['flash']}, expected {per_mb} a "
             "microbatch")
    _require(all(set(v) <= {"wgmma_tma"} and v for v in row["flash_variants"]),
             f"sched_flash_crowd: flash variants {row['flash_variants']}")
    for family in ("dlcfn_sched_preemptions_total 1", "dlcfn_sched_restores_total 1",
                   "dlcfn_serve_ttft_ms", "dlcfn_step_phase_ms"):
        _require(family in prom, f"sched_flash_crowd: status prom lacks {family}")
    _require(rows == ["rank0", "rank1"], f"sched_flash_crowd: trace rows {rows}")
    _require(postmortem.startswith("postmortem: 2 host(s)"),
             f"sched_flash_crowd: postmortem {postmortem[:200]}")
    _require(sorted(row["metrics_workers"]) == [("worker0", CROWD_STEPS),
                                                ("worker1", CROWD_STEPS)],
             f"sched_flash_crowd: status --metrics-dir {row['metrics_workers']}")
    return (sum(live["flash_per_step"]) + sum(r1["live"]["flash_per_step"])
            + sum(straight["flash_per_step"]) + sum(r1["straight"]["flash_per_step"]))


def _chaos_catalog_phase(torch, kernels_mod, smi: str) -> dict:
    """Phase 22 (see the module docstring): every scenario this slice added,
    seed 0, its trainers and engines on the card; the gauntlet's pinned
    schedule again (the two reports byte-equal); ``cli gauntlet --sweep 2``
    in its own process.  The runs that start rank processes go
    concurrently (each start imports torch for seconds).  Returns the
    port's kernel launches over the phase, its rank processes' included
    (none)."""
    from deeplearning_cfn_tpu_torch.chaos import gauntlet as gauntlet_mod
    from deeplearning_cfn_tpu_torch.chaos import pinned_schedule, run_gauntlet, run_scenario
    from deeplearning_cfn_tpu_torch.chaos.scenarios import on_device

    t_phase = time.perf_counter()
    kernels_mod.reset_launch_counts()

    def timed(fn, *args):
        t0 = time.perf_counter()
        return fn(*args), time.perf_counter() - t0

    def sweep():
        return subprocess.run(
            [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cli", "gauntlet", "--sweep", "2",
             "--device", "cuda"], capture_output=True, text=True, timeout=CHAOS_TIMEOUT,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                filter(None, [str(Path(__file__).resolve().parent),
                              os.environ.get("PYTHONPATH")]))))

    # The in-process scenarios first: they count their journal events in
    # this process's ring, which the others' must not crowd meanwhile.
    spawning = ("data-reshard-live", "gauntlet")
    done = {name: timed(run_scenario, name, 0, "cuda")
            for name in CHAOS_ADDED if name not in spawning}
    # Both pinned runs start with no cached straight curve, so each trains
    # its own and checks against it: the two are compared below.
    gauntlet_mod._STRAIGHT_CACHE.clear()
    with ThreadPoolExecutor(max_workers=4) as pool:
        running = {name: pool.submit(timed, run_scenario, name, 0, "cuda") for name in spawning}
        again = pool.submit(timed, run_gauntlet, pinned_schedule(0), "cuda")
        swept = pool.submit(timed, sweep)
        done.update({name: f.result() for name, f in running.items()})
        second, again_s = again.result()
        proc, sweep_s = swept.result()
    in_ranks: dict = {}
    for name in CHAOS_ADDED:
        rep, wall_s = done[name]
        for k, n in rep.observed.get("kernel_launches", {}).items():
            in_ranks[k] = in_ranks.get(k, 0) + n
        devices = rep.observed.get("devices")
        _emit({"phase": "chaos_catalog", "scenario": name, "seed": 0, "passed": rep.passed,
               "invariants": len(rep.invariants), "violations": rep.violations,
               "wall_s": wall_s, "concurrent": name in spawning,
               "device": devices or "host (virtual clocks, no tensors)",
               "rank_kernel_launches": rep.observed.get("kernel_launches"),
               "rank_seconds": rep.observed.get("rank_seconds"), "nvidia_smi": smi})
        _require(rep.passed, f"chaos_catalog: {name} violated {rep.violations}")
        _require(on_device(name) == (devices is not None)
                 and all(d == "cuda:0" for d in devices or ()),
                 f"chaos_catalog: {name} ran on {devices}")
    first = done["gauntlet"][0]
    a, b = (json.dumps(r.to_dict(), sort_keys=True) for r in (first, second))
    for k, n in second.observed.get("kernel_launches", {}).items():
        in_ranks[k] = in_ranks.get(k, 0) + n
    _require(proc.returncode == 0, f"chaos_catalog: cli gauntlet --sweep 2 exited "
             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout)
    swept_launches = [json.loads(line)["kernel_launches"] for line in proc.stderr.splitlines()
                      if line.startswith('{"kernel_launches"')]
    _require(len(swept_launches) == 1, "chaos_catalog: cli gauntlet --sweep 2 printed no "
             f"kernel launches:\n{proc.stderr[-3000:]}")
    for k, n in swept_launches[0].items():
        in_ranks[k] = in_ranks.get(k, 0) + n
    straights = [r.observed["straight"] for r in (first, second)]
    got = dict(kernels_mod.launch_counts)
    row = {"phase": "chaos_catalog", "scenario": "gauntlet-determinism", "seed": 0,
           "reports_byte_equal": a == b, "report_bytes": len(a), "second_run_s": again_s,
           "straight_curves_equal": straights[0] == straights[1],
           "straight_trained_by_both": [r.observed["straight_ran"] for r in (first, second)],
           "composed_pause_ms": [r.observed["pause_s"][0] * 1e3 for r in (first, second)],
           "composed_pause": "ReshardRecord.seconds on rank 0: the MLP's live reshard 4 -> 2 "
                             "gloo ranks with the data plane's reshard and the broker shard "
                             "failover inside it (on_commit)",
           "live_reshard_pause_ms": _NOTES.get("live_reshard_pause_ms"),
           "live_reshard_pause": "phase 18: m435 at RESHARD_LAYERS, 2 -> 1 rank, no failover",
           "post_mesh": first.observed["post_mesh"], "grad_accum": first.observed["grad_accum"],
           "sweep": {"cli": "gauntlet --sweep 2 --device cuda", "rc": proc.returncode,
                     "passed": summary["passed"], "failures": summary["failures"],
                     "fault_counts": summary["fault_counts"], "wall_s": sweep_s},
           "main_process_kernel_launches": {k: n for k, n in got.items() if n},
           "rank_kernel_launches": in_ranks, "wall_s": time.perf_counter() - t_phase,
           "nvidia_smi": smi}
    _emit(row)
    _require(a == b, "chaos_catalog: the gauntlet's two seed-0 reports differ")
    _require(first.observed["straight_ran"] and second.observed["straight_ran"]
             and straights[0] == straights[1],
             "chaos_catalog: the two pinned runs did not each train the same straight curve")
    _require(summary["passed"] == 2 and summary["failures"] == [],
             f"chaos_catalog: cli gauntlet --sweep 2: {row['sweep']}")
    _kernel_free(got, "chaos_catalog")
    _kernel_free(in_ranks, "chaos_catalog (rank processes)")
    return got


def _analysis_phase(torch, kernels_mod, smi: str, flash_per_block: float) -> int:
    """Phase 23 (see the module docstring): ``cli lint`` with every pass
    against the port's baseline and on a planted file; the compile audit
    (the audit MLP, m435 ``multi_step_fn`` at ``ANALYSIS_LAYERS``, the serve
    engine at m435 widths, a recapture control); the comms audit on 2 gloo
    ranks on cuda:0 against the committed budget; the replay audit over
    the catalog's rank-free scenarios and both soaks.  The subprocesses
    (three lints, the comms ranks, the replay audit) run while this process
    runs the compile audit.  Returns the flash launches of the phase."""
    import tempfile

    from deeplearning_cfn_tpu_torch.analysis import compile_audit as ca
    from deeplearning_cfn_tpu_torch.analysis import comms_audit as cm
    from deeplearning_cfn_tpu_torch.analysis.collectives import (
        AUDIT_RULE_IDS as COMMS_AUDIT_RULE_IDS,
    )
    from deeplearning_cfn_tpu_torch.analysis.core import Violation
    from deeplearning_cfn_tpu_torch.analysis import replay_audit as ra
    from deeplearning_cfn_tpu_torch.analysis import runner
    from deeplearning_cfn_tpu_torch.chaos.scenarios import SCENARIOS
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.serve.engine import ServeConfig
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticTokenDataset,
        device_put_batch,
        stack_batches,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(root), os.environ.get("PYTHONPATH")])))
    tmp = tempfile.TemporaryDirectory()
    planted = Path(tmp.name) / "train" / "planted.py"
    planted.parent.mkdir()
    planted.write_text(ANALYSIS_PLANTED)

    def start(args):
        return subprocess.Popen([sys.executable, "-m", *args], cwd=root, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    cli = "deeplearning_cfn_tpu_torch.cli"
    procs = {
        "lint": start([cli, "lint", *ANALYSIS_LINT_FLAGS, "--baseline"]),
        "lint_json": start([cli, "lint", *ANALYSIS_LINT_FLAGS, "--format", "json"]),
        "lint_planted": start([cli, "lint", "--sharding", "--comms", "--format", "json",
                               str(planted)]),
        # The replay audit in two processes, the scenarios and the soaks.
        "replay": start(["deeplearning_cfn_tpu_torch.analysis.replay_audit", "--device", "cuda",
                         "--no-ranks", "--no-soaks"]),
        "replay_soaks": start(["deeplearning_cfn_tpu_torch.analysis.replay_audit",
                               "--device", "cuda", "--soaks-only"]),
    }
    comms: dict = {}

    def comms_run():
        t0 = time.perf_counter()
        comms["report"] = cm.run_comms_audit(device="cuda", journal=False, workdir=tmp.name)
        comms["wall_s"] = time.perf_counter() - t0

    comms_thread = threading.Thread(target=comms_run, daemon=True)
    comms_thread.start()
    try:
        # --- compile audit: the JAX-shaped audit (the audit MLP) ---------
        t0 = time.perf_counter()
        mlp = ca.run_compile_audit(device="cuda", journal=False)
        mlp_s = time.perf_counter() - t0
        by_path = {p.name: p for p in mlp.paths}
        _emit({"phase": "analysis", "part": "compile_audit_mlp", "wall_s": mlp_s,
               **mlp.to_dict(), "nvidia_smi": smi})
        _require(mlp.violations == [], f"analysis: the audit MLP's findings {mlp.violations}")
        _require(by_path["multi_step"].cache_size == 1,
                 "analysis: the audit MLP's multi_step wrapper holds no graph")

        # --- the control: a second model object recaptures (DLC410) ------
        from deeplearning_cfn_tpu_torch.train.trainer import Trainer

        trainer = Trainer(ca.audit_mlp(), TrainerConfig(learning_rate=0.05, optimizer="sgd"),
                          device="cuda")
        xs = torch.randn(2, 8, 8, 8, 1, device="cuda")
        ys = torch.randint(0, 4, (2, 8), device="cuda")
        kfn = trainer.multi_step_fn(2)
        with ca.CompileWatcher(owners=[kfn]) as watcher:
            kfn(trainer.init(seed=0), xs, ys)
            watcher.mark_steady()
            kfn(trainer.init(seed=1), xs, ys)  # another model: the graph recaptures
            control = ca.PathAudit(name="multi_step", steady_steps=1,
                                   new_compiles=watcher.new_compiles_since_mark())
        control_rules = [v.rule for v in ca.violations_for([control])]
        _emit({"phase": "analysis", "part": "compile_audit_control",
               "new_compiles": control.new_compiles, "rules": control_rules})
        _require(control_rules == ["DLC410"],
                 f"analysis: a recapture on a second model gave {control_rules}, not DLC410")
        del trainer, kfn, xs, ys

        # --- m435 multi_step_fn(K) at full width -------------------------
        cfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=2048), n_layers=ANALYSIS_LAYERS)
        trainer = llama.make_trainer(cfg, TrainerConfig(
            optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0,
            log_every=1), device="cuda")
        data = SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size,
                                     batch_size=ANALYSIS_BATCH)
        batches = list(data.batches(2 * ANALYSIS_K))
        stacks = [device_put_batch(b, torch.device("cuda"))
                  for b in stack_batches(iter(batches), ANALYSIS_K)]
        state = trainer.init(seed=0, draw_on_device=True)
        kfn = trainer.multi_step_fn(ANALYSIS_K)
        t0 = time.perf_counter()
        with ca.CompileWatcher(owners=[kfn]) as watcher:
            kernels_mod.reset_launch_counts()
            state, losses = kfn(state, *stacks[0])  # warm-up + capture
            losses.tolist()
            capture_launches = dict(kernels_mod.launch_counts)
            captures_at_mark = dict(watcher.traces)
            watcher.mark_steady()
            kernels_mod.reset_launch_counts()
            for i in range(ANALYSIS_STEADY):
                xs, ys = stacks[(i + 1) % len(stacks)]
                if i == ANALYSIS_STEADY - 1:
                    (state, losses), donation = ca.measure_donation(kfn, state, xs, ys)
                else:
                    state, losses = kfn(state, xs, ys)
            steady_losses = losses.tolist()
            replay_launches = {k: n for k, n in kernels_mod.launch_counts.items() if n}
            m435 = ca.PathAudit(name="multi_step", steady_steps=ANALYSIS_STEADY,
                                new_compiles=watcher.new_compiles_since_mark(),
                                new_traces=watcher.new_traces_since_mark(),
                                cache_size=ca.cache_size(kfn), donation=donation)
            snapshot = watcher.snapshot()
        m435_s = time.perf_counter() - t0
        leaves = len(ca.state_leaves(state))
        flash = _flash_check(capture_launches, 1 + ANALYSIS_K, flash_per_block * cfg.n_layers,
                             "analysis: m435 multi_step_fn warm-up + capture")
        row = {"phase": "analysis", "part": "compile_audit_m435", "model": "m435",
               "n_layers": cfg.n_layers, "dim": cfg.dim, "heads": cfg.n_heads, "S": 2048,
               "batch": ANALYSIS_BATCH, "dtype": "bfloat16", "k": ANALYSIS_K,
               "steady_calls": ANALYSIS_STEADY, "captures": kfn.captures,
               "captures_before_mark": captures_at_mark, **m435.to_dict(), "watcher": snapshot,
               "state_leaves": leaves, "steady_losses": steady_losses,
               "launches_in_warmup_and_capture": capture_launches,
               "launches_in_steady_calls": replay_launches, **flash, "wall_s": m435_s,
               "nvidia_smi": smi}
        _emit(row)
        _require(kfn.captures == 1 and captures_at_mark == {f"CapturedSteps(k={ANALYSIS_K})": 1},
                 f"analysis: m435 captured {kfn.captures} times ({captures_at_mark})")
        _require(m435.new_compiles == {} and ca.violations_for([m435]) == [],
                 f"analysis: m435 captured or built after the mark: {m435.new_compiles}")
        _require(donation.retained_leaves == 0 and donation.untouched_leaves == 0
                 and donation.donated_leaves == leaves,
                 f"analysis: m435 donation {donation.to_dict()} over {leaves} leaves")
        _require(all(math.isfinite(v) for v in steady_losses), "analysis: m435 non-finite loss")
        del trainer, state, kfn, stacks, batches, losses
        torch.cuda.empty_cache()

        # --- the serve audit at m435 widths ------------------------------
        scfg = dataclasses.replace(llama.LlamaConfig.m435(seq_len=2048),
                                   n_layers=ANALYSIS_SERVE_LAYERS)
        kernels_mod.reset_launch_counts()
        t0 = time.perf_counter()
        serve = ca.run_serve_audit(steady_requests=ANALYSIS_REQUESTS, journal=False,
                                   device="cuda", cfg=scfg,
                                   serve_cfg=ServeConfig(**ANALYSIS_SERVE_SLOTS))
        serve_s = time.perf_counter() - t0
        serve_launches = {k: n for k, n in kernels_mod.launch_counts.items() if n}
        sp = serve.paths[0]
        _emit({"phase": "analysis", "part": "compile_audit_serve", "model": "m435 widths",
               "n_layers": scfg.n_layers, "dtype": "bfloat16", "requests": ANALYSIS_REQUESTS,
               **serve.to_dict(), "launches": serve_launches, "wall_s": serve_s,
               "nvidia_smi": smi})
        _require(serve.watcher["decode_captures"] == 1 and serve.violations == []
                 and serve.watcher["pool_storage_unchanged"] and sp.cache_size == 1
                 and sp.donation.retained_leaves == 0,
                 f"analysis: the serve audit {serve.to_dict()}")
        torch.cuda.empty_cache()
        compile_s = time.perf_counter() - t_phase

        # --- the subprocesses --------------------------------------------
        outs = {}
        for name, p in procs.items():
            out, err = p.communicate(timeout=ANALYSIS_TIMEOUT)
            outs[name] = (p.returncode, out, err)
        comms_thread.join(timeout=ANALYSIS_TIMEOUT)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        tmp.cleanup()

    # lint against the baseline, by rule, and the planted control.
    rc, out, err = outs["lint"]
    _require(rc == 0, f"analysis: cli lint --baseline exited {rc}:\n{out[-3000:]}{err[-2000:]}")
    found = json.loads(outs["lint_json"][1])["violations"]
    by_rule: dict = {}
    for v in found:
        by_rule[v["rule"]] = by_rule.get(v["rule"], 0) + 1
    baseline = runner.load_baseline(runner.DEFAULT_BASELINE)
    # The same findings against the ratchet: nothing fresh, and every static
    # entry matched (a lint that read no file would leave them all stale).
    fresh, stale = runner.apply_baseline([Violation(**v) for v in found], baseline)
    stale = [e for e in stale if e[0] not in runner.DYNAMIC_AUDIT_RULE_IDS]
    planted_rc, planted_out, planted_err = outs["lint_planted"]
    planted_rules = sorted({v["rule"] for v in json.loads(planted_out)["violations"]})
    _emit({"phase": "analysis", "part": "lint", "flags": ANALYSIS_LINT_FLAGS,
           "rc_with_baseline": rc, "findings_by_rule": by_rule,
           "baseline_entries": len(baseline), "fresh": len(fresh), "stale_static": stale,
           "planted_rc": planted_rc, "planted_rules": planted_rules})
    _require(fresh == [] and stale == [] and found,
             f"analysis: lint's findings against the ratchet: fresh {fresh}, stale {stale}")
    _require(planted_rc == 1 and {"DLC003", "DLC502"} <= set(planted_rules),
             f"analysis: the planted file gave rc {planted_rc}, rules {planted_rules}:\n"
             f"{planted_err[-2000:]}")

    # comms: the six programs on 2 gloo ranks on cuda:0 against the budget.
    _require("report" in comms, "analysis: the comms audit did not finish")
    report, budget = comms["report"], cm.load_budget()
    programs = {p.name: p for p in report.programs}
    equal = {name: (programs[name].collective_count == b["collective_count"]
                    and programs[name].collective_bytes == b["collective_bytes"])
             for name, b in budget["programs"].items()}
    _emit({"phase": "analysis", "part": "comms_audit", "ranks": cm.RANKS,
           "device": "cuda:0 for both", "backend": "gloo over CUDA tensors",
           "multi_step": "its k steps eagerly on the gloo ranks (the CUDA-graph form needs "
                         "NCCL: phase 17)",
           "peak_hbm_bytes": "torch.cuda.max_memory_allocated over the profiled step "
                             "(the budget's is the CPU profiler's peak)",
           "programs": {n: p.to_dict() for n, p in programs.items()},
           "measured": report.measured, "budget_equal": equal,
           "violations": [v.to_dict() for v in report.violations],
           "wall_s": comms["wall_s"], "nvidia_smi": smi})
    _require(all(equal.values()), f"analysis: comms counts or bytes differ from the budget: "
             f"{equal}")
    _require(all(m["witness_counts"] == m["rank_counts"] for m in report.measured.values()),
             f"analysis: the backend's count disagrees with c10d's: {report.measured}")
    fresh, _ = runner.apply_audit_baseline(report.violations, None, COMMS_AUDIT_RULE_IDS)
    _require(fresh == [], f"analysis: fresh comms findings {fresh}")

    # replay: every rank-free case twice, byte-equal.
    replays = []
    for name in ("replay", "replay_soaks"):
        rc, out, err = outs[name]
        _require(rc == 0, f"analysis: the replay audit exited {rc}:\n{out[-2000:]}{err[-2000:]}")
        replays.append(json.loads(out))
    not_replayed = sorted(n for n in SCENARIOS if ra.spawns_ranks(n))
    runs = [r for rep in replays for r in rep["replays"]]
    divergent = sorted(n for rep in replays for n in rep["divergent"])
    _emit({"phase": "analysis", "part": "replay_audit",
           "cases": sum(rep["cases"] for rep in replays), "divergent": divergent,
           "replays": [{k: r[k] for k in ("name", "identical", "nbytes")} for r in runs],
           "not_replayed_here": not_replayed,
           "not_replayed_why": "they start rank processes; phase 22 replays the gauntlet"})
    _require(all(rep["clean"] for rep in replays) and divergent == []
             and all(r["identical"] for r in runs) and len(runs) == len(SCENARIOS) - 2,
             f"analysis: replay divergence {divergent}")
    wall_s = time.perf_counter() - t_phase
    _emit({"phase": "analysis", "part": "done", "compile_audit_s": compile_s,
           "comms_audit_s": comms["wall_s"], "wall_s": wall_s, "nvidia_smi": smi})
    return flash["flash_launches"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F

    from deeplearning_cfn_tpu_torch.examples import bert_pretrain, llama_train
    from deeplearning_cfn_tpu_torch.models import bert, llama
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.ops import fused_dense as fd
    from deeplearning_cfn_tpu_torch.ops.attention import dot_product_attention
    from deeplearning_cfn_tpu_torch.ops.flash_attention import (
        FlashAttention,
        flash_attention,
        flash_attention_reference,
    )
    from deeplearning_cfn_tpu_torch.ops.quant import dequantize_weight, quantize_weight
    from deeplearning_cfn_tpu_torch.train.data import (
        SyntheticMLMDataset,
        SyntheticTokenDataset,
        device_put_batch,
    )
    from deeplearning_cfn_tpu_torch.train.metrics import (
        peak_f32_flops_per_chip,
        peak_flops_per_chip,
        peak_hbm_bytes_per_chip,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import TrainerConfig

    # 1. env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = peak_flops_per_chip(name), peak_hbm_bytes_per_chip(name)
    peak_f32 = peak_f32_flops_per_chip(name)
    _require(peak_flops is not None, f"no peak rates known for {name!r}")
    _emit({"phase": "env", "nvidia_smi": smi, "device": name, "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "peak_bf16_flops": peak_flops, "peak_f32_flops": peak_f32,
           "peak_hbm_bytes_per_s": peak_bw})

    # 2. build
    sources = ["flash_attn_fwd", "fused_dense"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_kernels.build, sources))
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for lib in libs for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "arning" in ln]
    _emit({"phase": "build", "seconds": build_s, "libraries": [p.name for p in libs],
           "ptxas": ptxas})

    # 3. kernel vs plain, on the card
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, S, Hq, Hkv, D, dtype):
        return [torch.randn(B, S, h, D, device="cuda", generator=gen, dtype=torch.float32).to(dtype)
                for h in (Hq, Hkv, Hkv)]

    shapes = {  # name: (B, S, Hq, Hkv, D, causal, dtype, packed)
        "slice": (8, 2048, 8, 8, 128, True, torch.bfloat16, False),
        "gqa": (1, 2048, 32, 8, 128, True, torch.bfloat16, False),
        "ragged-full": (2, 1000, 8, 8, 64, False, torch.bfloat16, False),
        # The diagonal and Sk-edge masks on one tile, with TMA's zero fill.
        "causal-ragged": (2, 1000, 8, 8, 128, True, torch.bfloat16, False),
        # q, k and v as views of one [B, S, 3, H, D] tensor: the tensor maps' strides.
        "strided": (2, 2048, 8, 8, 128, True, torch.bfloat16, True),
        "f32": (1, 300, 4, 2, 64, True, torch.float32, False),
        # Llama-3-8B's attention at seq 8192 (phase 14's main path).
        "llama8b": (1, L8B_SEQ, 32, 8, 128, True, torch.bfloat16, False),
    }
    kernel_rows = {}
    for label, (B, S, Hq, Hkv, D, causal, dtype, packed) in shapes.items():
        if packed:
            qkv_packed = torch.randn(B, S, 3, Hq, D, device="cuda", generator=gen).to(dtype)
            q, k, v = (qkv_packed[:, :, i] for i in range(3))
        else:
            q, k, v = qkv(B, S, Hq, Hkv, D, dtype)
        scale = D**-0.5
        (out, lse), variant = _launched_variant(_kernels, "flash_attention_fwd", lambda: (
            _kernels.flash_attn_fwd(q, k, v, causal=causal, sm_scale=scale)))
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, causal=causal, sm_scale=scale)
        out_err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        out_tol = BF16_OUT_ATOL if dtype == torch.bfloat16 else F32_OUT_ATOL
        row = {"phase": "kernel", "kernel": "flash_attention_fwd", "shape": label, "B": B, "S": S,
               "Hq": Hq, "Hkv": Hkv, "D": D, "causal": causal,
               "dtype": str(dtype).replace("torch.", ""), "packed_qkv": packed,
               "variant": variant,
               "out_max_abs_err": out_err, "out_atol": out_tol,
               "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL,
               "finite": bool(torch.isfinite(out).all())}
        if dtype == torch.bfloat16:
            row["out_row_ulps"] = _row_ulps(torch, out, ref_out)
            row["out_row_ulps_limit"] = BF16_ROW_ULPS
        if dtype == torch.bfloat16:
            flops, nbytes = _attention_work(B, S, S, Hq, Hkv, D, causal, q.element_size())
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kernel = lambda: _kernels.flash_attn_fwd(q, k, v, causal=causal, sm_scale=scale)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=Hq != Hkv)
            row.update({
                "kernel_ms": _time_ms(torch, kernel, iters=20),
                "device_ms": _device_ms(torch, kernel, iters=20),
                "plain_ms": _time_ms(torch, lambda: flash_attention_reference(
                    q, k, v, causal=causal, sm_scale=scale), iters=3, warmup=1),
                "library_ms": _time_ms(torch, library, iters=20),
                "library_device_ms": _device_ms(torch, library, iters=20),
                "host_ms": _host_ms(torch, kernel, iters=20),
                "library_host_ms": _host_ms(torch, library, iters=20),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            })
            row["tflops"] = flops / row["kernel_ms"] / 1e9
        _emit(row)
        _require(row["finite"], f"{label}: non-finite kernel output")
        _require(out_err <= out_tol, f"{label}: out error {out_err} > {out_tol}")
        _require(lse_err <= LSE_ATOL, f"{label}: lse error {lse_err} > {LSE_ATOL}")
        _require(row.get("out_row_ulps", 0) <= BF16_ROW_ULPS,
                 f"{label}: out error {row.get('out_row_ulps')} ulps of its row > {BF16_ROW_ULPS}")
        _require(row["variant"] == ("wgmma_tma" if dtype == torch.bfloat16 else "simt"),
                 f"{label}: flash variant {row['variant']}")
        kernel_rows[label] = row
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.synchronize()

    # Flash crossover: the kernel against the materialised-score path the
    # model takes below FLASH_CROSSOVER_SEQ, at equal tokens per call.
    Hc, Dc = 8, 128
    for S in CROSSOVER_SEQS:
        B = CROSSOVER_TOKENS // S
        q, k, v = qkv(B, S, Hc, Hc, Dc, torch.bfloat16)
        g = torch.randn(B, S, Hc, Dc, device="cuda", generator=gen).to(torch.bfloat16)
        grads = [x.detach().requires_grad_() for x in (q, k, v)]

        def fwd_bwd(attn):
            attn(*grads).backward(g)

        flash = lambda *t: flash_attention(*t, causal=True)  # noqa: E731
        plain = lambda *t: dot_product_attention(*t, causal=True)  # noqa: E731
        with torch.no_grad():
            row = {"phase": "crossover", "B": B, "S": S, "Hq": Hc, "D": Dc, "causal": True,
                   "tokens": B * S,
                   "flash_fwd_ms": _time_ms(torch, lambda: flash(q, k, v), iters=10),
                   "materialised_fwd_ms": _time_ms(torch, lambda: plain(q, k, v), iters=10)}
        row["flash_fwd_bwd_ms"] = _time_ms(torch, lambda: fwd_bwd(flash), iters=3, warmup=1)
        row["materialised_fwd_bwd_ms"] = _time_ms(torch, lambda: fwd_bwd(plain), iters=3, warmup=1)
        _emit(row)
        del q, k, v, g, grads
    torch.cuda.synchronize()

    def dense_operands(M, K, N, dtype):
        x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(K, N, device="cuda", generator=gen) / K**0.5).to(dtype)
        b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dtype)
        return x, w, b

    def dense_check(label, kernel_name, got, ref, dtype, tols=DENSE_TOL) -> dict:
        rtol, atol = tols[str(dtype).replace("torch.", "")]
        err = (got.float() - ref.float()).abs()
        within = bool((err <= atol + rtol * ref.float().abs()).all())
        return {"phase": "kernel", "kernel": kernel_name, "shape": label,
                "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err.max().item(),
                "rtol": rtol, "atol": atol, "within_tolerance": within,
                "finite": bool(torch.isfinite(got).all())}

    library_act = {None: lambda z: z, "relu": torch.relu,
                   "gelu": lambda z: F.gelu(z, approximate="tanh")}

    def f64_errors(got, x, w, b, act, library) -> dict:
        """The kernel's and the library call's largest errors against the
        float64 product, with the same bias and activation in float64."""
        exact = library_act[act](x.double() @ w.double() + b.double())
        kernel_err = (got.double() - exact).abs().max().item()
        library_err = (library().double() - exact).abs().max().item()
        return {"f64_kernel_max_abs_err": kernel_err, "f64_library_max_abs_err": library_err,
                "f64_kernel_over_library": kernel_err / library_err}
    dense_shapes = {  # name: (M, K, N, dtype, activation)
        "mlp_in": (BERT_BATCH * BERT_SEQ, 768, 3072, torch.bfloat16, "gelu"),
        "mlp_out": (BERT_BATCH * BERT_SEQ, 3072, 768, torch.bfloat16, None),
        # Ragged M, K and N with 16-byte rows: TMA's zero fill, the epilogue's guards.
        "aligned-ragged": (1000, 200, 304, torch.bfloat16, "relu"),
        "ragged": (1000, 200, 300, torch.bfloat16, "relu"),
        "resnet_head": (128, 2048, 1000, torch.float32, None),
        "mlp_in-f32": (BERT_BATCH * BERT_SEQ, 768, 3072, torch.float32, "gelu"),
        # N not a multiple of 4: rows TMA cannot read.
        "ragged-f32": (1000, 200, 301, torch.float32, "relu"),
    }
    # The launcher's choice on an H100 (132 SMs): bf16, ping-pong where there
    # are two 128 x 128 tiles or more an SM, else cooperative 128 x 192, and
    # mma.sync for rows TMA cannot read; f32, six bf16 products of parts, K
    # split across a cluster where 128 x 192 tiles leave half the SMs idle
    # (the head: 6 tiles, 16 CTAs each), without a split otherwise, and CUDA cores for
    # rows TMA cannot read.
    dense_variants = {"mlp_in": "wgmma_tma_pingpong_128x128", "mlp_out": "wgmma_tma_128x192",
                      "aligned-ragged": "wgmma_tma_128x192", "ragged": "mma_sync",
                      "resnet_head": F32_SPLITK, "mlp_in-f32": F32_COOP, "ragged-f32": "simt"}
    dense_rows = {}
    for label, (M, K, N, dtype, act) in dense_shapes.items():
        x, w, b = dense_operands(M, K, N, dtype)
        got, variant = _launched_variant(_kernels, "fused_dense", lambda: (
            _kernels.fused_dense(x, w, b, activation=act)))
        torch.cuda.synchronize()
        row = dense_check(label, "fused_dense", got, fd.fused_dense_reference(x, w, b, act), dtype)
        row.update({"M": M, "K": K, "N": N, "activation": act, "variant": variant})
        # The bound of the design's arithmetic: bf16 products at the bf16
        # peak, one pass for bf16 operands and six for f32 ones split in
        # three; an f32 product on the CUDA cores at the f32 peak, which
        # stays beside the others for the record.
        if dtype == torch.bfloat16:
            peak_ops, basis = peak_flops, "bf16 tensor cores x1"
        elif variant == "simt":
            peak_ops, basis = peak_f32, "f32 CUDA cores"
        else:
            peak_ops, basis = peak_flops / 6, "bf16 tensor cores x6"
        row.update(_dense_work(M, K, N, x.element_size(), w.element_size(), peak_ops, peak_bw))
        row["bound_basis"] = basis
        if dtype == torch.float32:
            row["bound_f32_cuda_cores_ms"] = _dense_work(
                M, K, N, 4, 4, peak_f32, peak_bw)["bound_ms"]
            row["splits"] = _kernels.fused_dense_f32_splits(M, N, K) if variant == F32_SPLITK else 1
            # The cluster sums its partial tiles in rank order: the same bits each call.
            again = _kernels.fused_dense(x, w, b, activation=act)
            torch.cuda.synchronize()
            row["bitwise_repeatable"] = bool(torch.equal(again, got))
            _require(row["bitwise_repeatable"], f"fused_dense {label}: two calls differ")
        kernel = lambda: _kernels.fused_dense(x, w, b, activation=act)  # noqa: E731
        library = lambda: library_act[act](torch.addmm(b, x, w))  # noqa: E731
        if dtype == torch.float32:
            # Against float64, the kernel sums as f32 addmm (TF32 off) does.
            row.update(f64_errors(got, x, w, b, act, library))
            if variant != "simt":
                _require(row["f64_kernel_over_library"] <= 2,
                         f"fused_dense {label}: float64 error {row['f64_kernel_max_abs_err']} "
                         f"over twice addmm's {row['f64_library_max_abs_err']}")
        row.update({
            "kernel_ms": _time_ms(torch, kernel, iters=50),
            "device_ms": _device_ms(torch, kernel, iters=50),
            "plain_ms": _time_ms(torch, lambda: fd.fused_dense_reference(x, w, b, act), iters=10),
            "library_ms": _time_ms(torch, library, iters=50),
            "library_device_ms": _device_ms(torch, library, iters=50),
            "host_ms": _host_ms(torch, kernel, iters=50),
            "library_host_ms": _host_ms(torch, library, iters=50),
        })
        row["tflops"] = row["gflop"] / row["kernel_ms"]
        _emit(row)
        _require(row["finite"] and row["within_tolerance"], f"fused_dense {label}: {row}")
        _require(row["variant"] == dense_variants[label],
                 f"fused_dense {label}: variant {row['variant']}")
        dense_rows[label] = row

    quant_shapes = {  # name: (M, K, N, x dtype, activation)
        "mlp_in": (BERT_BATCH * BERT_SEQ, 768, 3072, torch.bfloat16, "gelu"),
        "mlp_in-f32": (BERT_BATCH * BERT_SEQ, 768, 3072, torch.float32, "gelu"),
        # Ragged M and K chunk with 16-byte rows: TMA's zero fill in all three parts.
        "aligned-ragged": (1000, 200, 304, torch.float32, "relu"),
        "ragged": (1000, 200, 300, torch.float32, "relu"),
    }
    # The launcher's choice: bf16 tensor cores (128 x 192 tiles) where TMA
    # can read the rows, one bf16 part of x for a bf16 x and three (h, m, l)
    # for an f32 x; CUDA cores where N is off 16 bytes of int8.
    quant_variants = {"mlp_in": "wgmma_tma_bf16x1_128x192",
                      "mlp_in-f32": "wgmma_tma_bf16x3_128x192",
                      "aligned-ragged": "wgmma_tma_bf16x3_128x192", "ragged": "simt"}
    quant_rows = {}
    for label, (M, K, N, dtype, act) in quant_shapes.items():
        x, w, b = dense_operands(M, K, N, dtype)
        wq, scale = quantize_weight(w.float())
        got, variant = _launched_variant(_kernels, "fused_dense_quantized", lambda: (
            _kernels.fused_dense_quantized(x, wq, scale, b, activation=act)))
        torch.cuda.synchronize()
        ref = fd._quant_reference(x, wq, scale, b, act, dtype)
        row = dense_check(label, "fused_dense_quantized", got, ref, dtype, QUANT_TOL)
        row.update({"M": M, "K": K, "N": N, "activation": act, "variant": variant})
        # The bound of the design's arithmetic: bf16 products at the bf16
        # peak, one pass for a bf16 x and three for an f32 x; an f32 product
        # on the CUDA cores at the f32 peak.
        if variant == "simt":
            peak_ops, basis = peak_f32, "f32 CUDA cores"
        else:
            parts = 1 if dtype == torch.bfloat16 else 3
            peak_ops, basis = peak_flops / parts, f"bf16 tensor cores x{parts}"
        row.update(_dense_work(M, K, N, x.element_size(), 1, peak_ops, peak_bw))
        row["bound_basis"] = basis
        x32, b32, w32 = x.float(), b.float(), dequantize_weight(wq, scale)
        kernel = lambda: _kernels.fused_dense_quantized(x, wq, scale, b, activation=act)  # noqa: E731
        library = lambda: library_act[act](torch.addmm(b32, x32, w32))  # noqa: E731
        if dtype == torch.float32:
            # Against x @ (wq * scale) in float64; addmm on the dequantised weight.
            row.update(f64_errors(got, x32, wq.double() * scale.double(), b32, act, library))
            if variant != "simt":
                _require(row["f64_kernel_over_library"] <= 2,
                         f"fused_dense_quantized {label}: float64 error "
                         f"{row['f64_kernel_max_abs_err']} over twice addmm's "
                         f"{row['f64_library_max_abs_err']}")
        row.update({
            "kernel_ms": _time_ms(torch, kernel, iters=50),
            "device_ms": _device_ms(torch, kernel, iters=50),
            "plain_ms": _time_ms(torch, lambda: fd._quant_reference(x, wq, scale, b, act, dtype),
                                 iters=10),
            "library_ms": _time_ms(torch, library, iters=50),
            "library_device_ms": _device_ms(torch, library, iters=50),
            "host_ms": _host_ms(torch, kernel, iters=50),
            "library_host_ms": _host_ms(torch, library, iters=50),
        })
        if dtype == torch.bfloat16:
            # A floor for information only: a bf16 product on the widened
            # weight, without the scale, bias or activation.
            wq16 = wq.to(torch.bfloat16)
            bf16_mm = lambda: torch.mm(x, wq16)  # noqa: E731
            row["library_bf16_mm_ms"] = _time_ms(torch, bf16_mm, iters=50)
            row["library_bf16_mm_device_ms"] = _device_ms(torch, bf16_mm, iters=50)
        row["tflops"] = row["gflop"] / row["kernel_ms"]
        _emit(row)
        _require(row["finite"] and row["within_tolerance"], f"fused_dense_quantized {label}: {row}")
        _require(row["variant"] == quant_variants[label],
                 f"fused_dense_quantized {label}: variant {row['variant']}")
        quant_rows[label] = row
    del x, w, b, wq, scale, got, ref, x32, b32, w32

    # 4. grad: FlashAttention (kernel forward + torch backward) vs the reference's autograd
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 64
    base = qkv(B, S, Hq, Hkv, D, torch.float32)
    w = torch.randn(B, S, Hq, D, device="cuda", generator=gen)
    kq, kk, kv = (x.clone().requires_grad_() for x in base)
    rq, rk, rv = (x.clone().requires_grad_() for x in base)
    (FlashAttention.apply(kq, kk, kv, True, D**-0.5) * w).sum().backward()
    (flash_attention_reference(rq, rk, rv, causal=True)[0] * w).sum().backward()
    grad_err = max((a.grad - b.grad).abs().max().item() for a, b in ((kq, rq), (kk, rk), (kv, rv)))
    _emit({"phase": "grad", "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "dtype": "float32",
           "max_abs_err": grad_err, "atol": F32_GRAD_ATOL})
    _require(grad_err <= F32_GRAD_ATOL, f"grad error {grad_err} > {F32_GRAD_ATOL}")
    # FusedDenseFunction: the backward reads only x, w, b and g, so the kernel
    # forward and the plain one must give the same gradients.
    for dtype in (torch.float32, torch.bfloat16):
        M, K, N = 512, 768, 640
        base = dense_operands(M, K, N, dtype)
        r = torch.randn(M, N, device="cuda", generator=gen)
        kx, kw, kb = (t.clone().requires_grad_() for t in base)
        px, pw, pb = (t.clone().requires_grad_() for t in base)
        (fd.FusedDenseFunction.apply(kx, kw, kb, "gelu").float() * r).sum().backward()
        (fd.fused_dense_reference(px, pw, pb, "gelu").float() * r).sum().backward()
        rtol, atol = GRAD_TOL[str(dtype).replace("torch.", "")]
        errs = {n: (a.grad.float() - p.grad.float()).abs() for n, a, p in
                (("dx", kx, px), ("dw", kw, pw), ("db", kb, pb))}
        within = all(bool((errs[n] <= atol + rtol * p.grad.float().abs()).all())
                     for n, p in (("dx", px), ("dw", pw), ("db", pb)))
        _emit({"phase": "grad", "kernel": "fused_dense", "M": M, "K": K, "N": N,
               "dtype": str(dtype).replace("torch.", ""), "activation": "gelu",
               "max_abs_err": {n: e.max().item() for n, e in errs.items()},
               "rtol": rtol, "atol": atol, "within_tolerance": within})
        _require(within, f"fused_dense gradients ({dtype}) outside tolerance")

    # 5. slice: the Llama path, through the entry point a user calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result = llama_train.main(SLICE_ARGS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    llama_launches = dict(_kernels.launch_counts)
    peak_mem = torch.cuda.max_memory_allocated()
    tokens_per_step = 8 * 2048
    cfg = llama.LlamaConfig.m435(seq_len=2048)
    run = _run_summary(result, tokens_per_step, tokens_per_step)
    losses = run["losses"]
    slice_variants = _variants(llama_launches, "flash_attention_fwd")
    _emit({"phase": "slice", "args": SLICE_ARGS, **run, "wall_s": wall_s,
           "max_memory_allocated_bytes": peak_mem, "launches": llama_launches,
           "flash_launches_per_step": llama_launches["flash_attention_fwd"] / STEPS,
           "flash_variants": slice_variants})
    _require(slice_variants == {"wgmma_tma": llama_launches["flash_attention_fwd"]},
             f"the Llama path launched flash variants {slice_variants}")
    _require(len(losses) == STEPS and all(math.isfinite(x) for x in losses), "non-finite loss")
    _require(llama_launches["flash_attention_fwd"] >= cfg.n_layers * STEPS,
             f"flash kernel launched {llama_launches['flash_attention_fwd']} times, "
             f"expected >= {cfg.n_layers} per step")

    # Same weights as the trainer started from (seed 0), one forward each way.
    model = llama.init_model(cfg, seed=0, device="cuda")
    tokens = torch.from_numpy(
        next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size, batch_size=2).batches(1)).x
    ).cuda()
    with torch.no_grad():
        logits_kernel = llama.forward(model, tokens)
        with llama.force_attention_kind("flash_reference"):
            logits_plain = llama.forward(model, tokens)
    diff = (logits_kernel - logits_plain).abs()
    logits_row = {"phase": "logits", "B": 2, "S": 2048, "max_abs_err": diff.max().item(),
                  "mean_abs_err": diff.mean().item(), "max_atol": LOGITS_MAX_ATOL,
                  "mean_atol": LOGITS_MEAN_ATOL, "logits_max_abs": logits_plain.abs().max().item(),
                  "finite": bool(torch.isfinite(logits_kernel).all())}
    _emit(logits_row)
    _require(logits_row["finite"], "non-finite logits")
    _require(logits_row["max_abs_err"] <= LOGITS_MAX_ATOL, "logits max error")
    _require(logits_row["mean_abs_err"] <= LOGITS_MEAN_ATOL, "logits mean error")
    del model, logits_kernel, logits_plain, diff

    # 6. learn: the synthetic tokens are uniform over the vocab, so the main
    # path's loss starts at the entropy floor ln(32000) = 10.373 and cannot
    # fall.  Learning is checked by overfitting one batch at the same shape
    # through the same trainer; its last two steps are profiled.
    trainer = llama.make_trainer(cfg, TrainerConfig(
        optimizer="adamw", learning_rate=3e-4, weight_decay=0.1, grad_clip_norm=1.0,
        strategy="fsdp", log_every=1), device="cuda")
    state = trainer.init(seed=0)
    batch = next(SyntheticTokenDataset(seq_len=2048, vocab_size=cfg.vocab_size, batch_size=8).batches(1))
    x, y = device_put_batch(batch, torch.device("cuda"))
    fit_losses = []

    def llama_step():
        nonlocal state
        state, metrics = trainer.train_step(state, x, y)
        fit_losses.append(metrics["loss"])

    for _ in range(STEPS - 2):
        llama_step()
    llama_profile = _profile(torch, llama_step, 2)
    fit_losses = torch.stack(fit_losses).tolist()
    _emit({"phase": "learn", "losses": fit_losses})
    _require(all(math.isfinite(v) for v in fit_losses), "non-finite loss on one batch")
    _require(fit_losses[-1] < fit_losses[0], f"loss on one repeated batch did not fall: {fit_losses}")
    _emit({"phase": "profile", "path": "llama", **llama_profile})
    del state, trainer, x, y

    # 6b-6e. The parallelism slice's Llama paths: MoE, adafactor, the mesh,
    # the captured AdamW step.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flash_per_block = llama_launches["flash_attention_fwd"] / STEPS / cfg.n_layers
    flash_by_path = {"slice": llama_launches["flash_attention_fwd"],
                     **_slice5a_phases(torch, _kernels, smi, flash_per_block, peak_flops)}

    # 7. bert: the BERT path, through the entry point a user calls
    bert_launches, bert_runs = {}, {}
    for path, extra in (("kernel", ["--use_pallas_mlp"]), ("plain", [])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = bert_pretrain.main(BERT_ARGS + extra)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(_kernels.launch_counts)
        run = {"phase": "bert", "mlp": path, "args": BERT_ARGS + extra,
               **_run_summary(result, BERT_BATCH, BERT_BATCH * BERT_SEQ),
               "wall_s": wall_s, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches,
               "fused_dense_launches_per_step": launches["fused_dense"] / BERT_STEPS}
        _emit(run)
        losses = run["losses"]
        _require(len(losses) == BERT_STEPS and all(math.isfinite(v) for v in losses),
                 f"bert ({path}): non-finite loss")
        # Mean of the last ten steps against the first ten: at the example's
        # learning rate (1e-4, no warmup) the loss falls by a few hundredths
        # in twenty steps, about as much as one batch's loss differs from the
        # next one's.  (At 1e-3 it falls faster, then diverges within twenty
        # steps.)
        _require(statistics.mean(losses[-10:]) < statistics.mean(losses[:10]),
                 f"bert ({path}): the MLM loss did not fall: {losses}")
        bert_runs[path] = run
        if path == "kernel":
            bert_launches = launches
    bcfg = dataclasses.replace(bert.BertConfig.base(), use_pallas_mlp=True)
    _require(bert_launches["fused_dense"] >= 2 * bcfg.n_layers * BERT_STEPS,
             f"fused_dense launched {bert_launches['fused_dense']} times, expected >= "
             f"{2 * bcfg.n_layers} per step")
    _require(bert_runs["plain"]["launches"]["fused_dense"] == 0, "plain BERT path ran the kernel")
    # Every launch of the kernel path in a wgmma variant: ping-pong at mlp_in
    # (768 tiles of 128 x 128), cooperative 128 x 192 at mlp_out (128 tiles).
    bert_variants = _variants(bert_launches, "fused_dense")
    _require(sum(bert_variants.values()) == bert_launches["fused_dense"]
             and bert_variants.get("wgmma_tma_pingpong_128x128", 0) >= bcfg.n_layers * BERT_STEPS
             and bert_variants.get("wgmma_tma_128x192", 0) >= bcfg.n_layers * BERT_STEPS
             and sum(n for v, n in bert_variants.items() if not v.startswith("wgmma_tma")) == 0,
             f"the BERT path launched fused-dense variants {bert_variants}")

    # Same weights as the trainer started from (seed 0), one forward each way.
    model = bert.BertEncoder(bcfg, torch.Generator().manual_seed(0)).to("cuda")
    batch = next(SyntheticMLMDataset(seq_len=BERT_SEQ, vocab_size=bcfg.vocab_size,
                                     batch_size=BERT_BATCH).batches(1))
    x, y = device_put_batch(batch, torch.device("cuda"))
    with torch.no_grad():
        logits_kernel = model(x)
        with fd.force_reference():
            logits_plain = model(x)
    diff = (logits_kernel - logits_plain).abs()
    logits_row = {"phase": "logits", "path": "bert", "B": BERT_BATCH, "S": BERT_SEQ,
                  "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
                  "max_atol": BERT_LOGITS_MAX_ATOL, "mean_atol": BERT_LOGITS_MEAN_ATOL,
                  "logits_max_abs": logits_plain.abs().max().item(),
                  "finite": bool(torch.isfinite(logits_kernel).all())}
    _emit(logits_row)
    _require(logits_row["finite"], "non-finite BERT logits")
    _require(logits_row["max_abs_err"] <= BERT_LOGITS_MAX_ATOL, "BERT logits max error")
    _require(logits_row["mean_abs_err"] <= BERT_LOGITS_MEAN_ATOL, "BERT logits mean error")
    del model, logits_kernel, logits_plain, diff

    for path, pallas in (("kernel", True), ("plain", False)):
        trainer = bert.make_trainer(
            dataclasses.replace(bcfg, use_pallas_mlp=pallas),
            TrainerConfig(optimizer="adamw", learning_rate=1e-4, weight_decay=0.01,
                          grad_clip_norm=1.0, log_every=1),
            device="cuda")
        state = trainer.init(seed=0)

        def bert_step():
            nonlocal state
            state, _ = trainer.train_step(state, x, y)

        for _ in range(2):
            bert_step()
        _emit({"phase": "profile", "path": "bert", "mlp": path, **_profile(torch, bert_step, 2)})
        del state, trainer
    del x, y

    # 8. serve: the serving path at Llama-3-8B, through the engine a user builds
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _serve_phase(torch, _kernels, smi, peak_bw)

    # 9. resnet: ResNet-50 training, the head through the f32 fused dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resnet_launches = _resnet_phase(torch, _kernels, smi, peak_flops)

    # 10. checkpoint: save and resume on the Llama and ResNet-50 paths
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ckpt_launches = _checkpoint_phase(torch, _kernels, smi)
    flash_by_path["checkpoint"] = ckpt_launches["flash_attention_fwd"]

    # 11. detection: RetinaNet-R50-FPN with the mask head (no kernel of the port)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    new_paths = {"detection": _detection_phase(torch, _kernels, smi, peak_flops)}

    # 12. cifar10: cifar10_train (VGG-11) and lenet_mnist (no kernel of the port)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    new_paths["cifar10"] = _cifar_phase(torch, _kernels, smi)

    # 13. records: ResNet-50, m435 and BERT-base (and VGG, detection) trained
    # from converted records through the native loader
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    new_paths["records"] = _records_phase(torch, _kernels, smi, flash_per_block)
    for path, counts in new_paths.items():
        flash_by_path[path] = counts.get("flash_attention_fwd", 0)

    # 14. llama8b: Llama-3-8B training on one card, its memory prediction,
    # the HF import, and TrainerConfig.remat
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    l8b = _llama8b_phase(torch, _kernels, smi)
    flash_by_path["llama8b"] = l8b["launches"].get("flash_attention_fwd", 0)

    # 15-17. The rest of the parallelism slice: the stage-stacked layout, two
    # ranks on the one card, a captured step over a mesh.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flash_by_path["pp_layout"] = _pp_layout_phase(torch, _kernels, smi, flash_per_block)
    flash_by_path["two_ranks"] = _two_ranks_phase(torch, smi, flash_per_block)
    flash_by_path["mesh_captured"] = _mesh_captured_phase(torch, _kernels, smi, flash_per_block)

    # 18. live_reshard: a slice lost mid-run, the trainer resharded live onto
    # the survivor, beside the checkpoint/restore fallback.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flash_by_path["live_reshard"] = _live_reshard_phase(torch, smi, flash_per_block)

    # 19. provision_run: template -> local cluster -> launched job, then the
    # recreate-and-resume tier on an instance loss.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flash_by_path["provision_run"] = _provision_run_phase(torch, _kernels, smi, flash_per_block)

    # 20. provision_broker: the production topology -- run --broker auto with
    # two agent processes and a tokenless intruder.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flash_by_path["provision_broker"] = _provision_broker_phase(smi, flash_per_block)

    # 21. sched_flash_crowd: a serve pool under a flash crowd takes a slice
    # of m435 training, which grows back live when the crowd drains.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flash_by_path["sched_flash_crowd"] = _sched_flash_crowd_phase(torch, smi, flash_per_block)

    # 22. chaos_catalog: the rest of the chaos catalog and the composed-incident
    # gauntlet, their trainers' ranks and serving engines on the card.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    new_paths["chaos_catalog"] = _chaos_catalog_phase(torch, _kernels, smi)
    flash_by_path["chaos_catalog"] = new_paths["chaos_catalog"].get("flash_attention_fwd", 0)

    # 23. analysis: cli lint with the port's ratchet, the compile, comms and
    # replay audits on the card.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    flash_by_path["analysis"] = _analysis_phase(torch, _kernels, smi, flash_per_block)

    # 24. model_parallel_ranks: the layouts of the rest of slice 5b across
    # two ranks on the card (run in phase 16's processes; their rows here).
    flash_by_path["model_parallel_ranks"] = _model_parallel_phase(smi)

    def on_new_paths(key: str, variants=None) -> dict:
        """Launches of ``key`` on the phases after ``checkpoint``; with
        ``variants``, only those variants' launches."""
        if variants is None:
            return {path: counts.get(key, 0) for path, counts in new_paths.items()}
        return {path: sum(n for v, n in _variants(counts, key).items() if v in variants)
                for path, counts in new_paths.items()}

    def kernel_entry(name, source, replaces, launches, max_abs_err, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max_abs_err, "ms": row["kernel_ms"],
                "device_ms": row["device_ms"], "host_ms": row["host_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "variant": row["variant"], "shape": row["shape"]}

    csrc = "deeplearning_cfn_tpu_torch/ops/csrc/"
    # The fused dense by operand dtype: bf16 on the BERT paths; f32 on the
    # ResNet-50 paths (their kernel heads' eager runs).
    f32_variants = (F32_SPLITK, F32_COOP, "simt")
    bf16_variants = set(_kernels._VARIANTS["fused_dense"].values()) - set(f32_variants)
    dense_launches = {"bf16": 0, "f32": ckpt_launches["fused_dense_f32"]}
    for counts in (llama_launches, bert_launches, resnet_launches, new_paths["records"]):
        for v, n in _variants(counts, "fused_dense").items():
            dense_launches["f32" if v in f32_variants else "bf16"] += n
    bf16_rows = [r for r in dense_rows.values() if r["dtype"] == "bfloat16"]
    f32_rows = [r for r in dense_rows.values() if r["dtype"] == "float32"]
    _emit({"kernels": [
        {**kernel_entry("flash_attention_fwd", csrc + "flash_attn_fwd.cu",
                        "deeplearning_cfn_tpu/ops/pallas_attention.py:222",
                        sum(flash_by_path.values()),
                        max(r["out_max_abs_err"] for r in kernel_rows.values()),
                        kernel_rows["slice"]),
         "launches_by_path": flash_by_path,
         "llama8b_shape": {k: kernel_rows["llama8b"][k] for k in (
             "B", "S", "Hq", "Hkv", "D", "variant", "out_max_abs_err", "kernel_ms", "device_ms",
             "host_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}},
        {**kernel_entry("fused_dense", csrc + "fused_dense.cu",
                        "deeplearning_cfn_tpu/ops/pallas_fused.py:135",
                        dense_launches["bf16"],
                        max(r["max_abs_err"] for r in bf16_rows), dense_rows["mlp_in"]),
         "launches_by_path": on_new_paths("fused_dense", bf16_variants)},
        {**kernel_entry("fused_dense_f32", csrc + "fused_dense.cu",
                        "deeplearning_cfn_tpu/ops/pallas_fused.py:135", dense_launches["f32"],
                        max(r["max_abs_err"] for r in f32_rows), dense_rows["resnet_head"]),
         "launches_by_path": on_new_paths("fused_dense", f32_variants)},
        {**kernel_entry("fused_dense_quantized", csrc + "fused_dense.cu",
                        "deeplearning_cfn_tpu/ops/pallas_fused.py:292",
                        bert_launches["fused_dense_quantized"],
                        max(r["max_abs_err"] for r in quant_rows.values()), quant_rows["mlp_in"]),
         "launches_by_path": on_new_paths("fused_dense_quantized")},
    ]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--two-ranks-worker":
        sys.exit(_two_ranks_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--reshard-worker":
        sys.exit(_reshard_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--sched-worker":
        sys.exit(_sched_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
