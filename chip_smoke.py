"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it finishes; any failure exits non-zero:
  1. build   - nvcc builds every kernel of the paths from
               paddle_tpu_torch/csrc, one process per source, in parallel.
  2. kernel  - each kernel against its plain PyTorch version on the card at
               the paths' shapes and more, with times, the card's bound
               and a PyTorch library call's time as a yardstick. A
               kernel's `ms` is its device time, launches replayed from a
               CUDA graph; `eager_ms` times the same launches from Python,
               wrapper included. Two launches of each dq entry on the same
               inputs must give bitwise-equal dq; the fused backward's two
               kernels are timed apart under the profiler. f32 at d = 64 /
               128 runs the split-TF32 kernels: each such row reads the
               kernel names from the profiler (no CUDA-core kernel) and
               keeps its CUDA-core bound (bound_ms_cuda_cores) beside its
               bound at the split-TF32 rate; any row timed above 1.05 of
               its bound fails (the bound would be miscounted).
  3. slice 1, f32  - GPT-2 small (seeded weights) prefill logits on the card
               against the same weights on the CPU plain path; greedy tokens
               (on F32_PARITY_ROWS of phase 4's 8 prompts since slice 20).
  4. slice 1, bf16 - serving: generate() on 8 prompts of 768 tokens, 128 new
               tokens, greedy, timed as the median of 3 calls; the flash
               forward must launch exactly once per layer. A 64-token run
               must not launch it.
  5. slice 2, f32  - one AdamW TrainStep of the bench's GPT cut to 2 layers
               (full width and vocabulary, batch 2 x 512) on the card
               against the same step on the CPU plain path.
  6. slice 2, bf16 - training, the main path: the bench's configuration
               (vocab 30528, hidden 768, 12 layers, 12 heads, batch 32 x
               seq 512, bf16, fused loss, AdamW lr 1e-4); 2 warm-up and 10
               timed steps, 12 flash forward and 12 fused backward launches
               a step, falling loss on the fixed batch, and a profile.
  7. slice 2, seq 1024 - GPT-2 small training at batch 8 x 1024 tokens, the
               two-pass backward: 12 dq and 12 dk/dv launches a step.
  8. long kernels - the long route's forward, dq and dk/dv entries against
               their plain versions (n = 8192 at the slice's shape, 4096
               with d = 128, a ragged 4100, fp16, f32, non-causal n != m),
               each timed beside the standard entry at the same shape (both
               launch the same kernels).
  9. wide heads - the d = 192 and 256 instantiations of the forward,
               fused, dq and dk/dv entries (CUDA cores, 16-bit operands
               staged as 16-bit), bf16 / fp16 / f32, at b=2 h=4 n=m=512
               causal and a ragged cross-length shape, each against its
               plain version with its time, bound and library time (the
               `kernels_wide` line). No path runs these head dims.
 10. slice 4, f32 - engine parity: GPT-2 small at full width (cut to
               PARITY_GPT2_LAYERS of its 12 layers since slice 20),
               6 prompts of 5-300 tokens + 32 new, greedy, through the slot
               engine (3 slots x 512), the paged engine with prefix sharing
               and the paged engine with spec_k=4: each token-identical to
               sequential generate() on the card.
 11. slice 4, bf16 - engine throughput: 64 requests at t = 0 (prompts of
               64-512 tokens, 128 new) through the slot engine (16 slots x
               1024, chunk 128, burst 4): tokens/s, TTFT p50/p99, the decode
               burst's time, a profiled burst's busy share, peak memory;
               the same requests through the paged engine with 4 groups
               sharing a 256-token prefix; spec_k=4 on repetitive prompts.
 12. slice 3, long context - the JAX package's long-context training run
               (bench.py with PADDLE_TPU_BENCH_SEQ=8192, BATCH=2): the
               bench's GPT with max_position 8192, bf16, batch 2 x 8192, 2
               warm-up and 6 timed steps, 12 launches a step of each long
               kernel and none of the standard ones, falling loss, a
               profile, and the same step on the standard route.
 13. slice 5, f32 - gateway parity: GPT-2 small (PARITY_GPT2_LAYERS
               layers), 10 prompts of 3-300
               tokens + 16 new, greedy, through a ServingGateway of 2
               replicas (2 slots x 352 each): sync slot and sync paged
               pools, a seeded arrival schedule with replica 1
               partitioned mid-burst (failovers equal to its in-flight
               count), the threaded drive; each token-identical to one
               slot engine on the card, no flash launch.
 14. slice 5, bf16 - the JAX package's QoS rung (bench_extra.py) at its
               on-TPU configuration and full width: 2 replicas x 8 slots,
               48 requests replayed open-loop (premium + bg, bg's rate
               doubling mid-trace), bg token-bucket limited; premium never
               shed, every shed handle has its 'rejected' wide event;
               TTFT, shed rate, tokens/s, each replica's burst split,
               peak memory; the gateway's /metrics and /readyz scraped;
               then the same replay on 1 replica.
 15. slice 6, f32 - the fabric: the gpt-bench preset (the rungs'
               on-TPU configuration, vocab 30528, 768 x 12 heads, slot
               engine 8 x 256) at 2 of its 12 layers since slice 23 (a
               variant, its overrides in the artifacts' meta) published as v1 (seeded) and v2 (another seed) into a
               ModelRegistry and served by an ArtifactServer; 2 worker
               processes on the card pull v1 by fingerprint into a
               ModelHost; a gateway over their SocketReplicas: 10 prompts
               of 3-241 tokens + 16 new token-identical to one in-process
               slot engine; rollout() to v2 mid-burst (zero loss, v1 tokens
               before the flip and v2 after, cache_hits / misses and
               load_s); worker 0 SIGKILLed at request 5 of a seeded
               schedule (failovers equal to its in-flight count, v2
               tokens); a pull with a wrong fingerprint refused.
 16. slice 6, bf16 - (a) phase 14's QoS trace, policy and replay through 2
               worker processes of the gpt-bench preset in bf16, beside
               phase 14's in-process 2- and 1-replica tokens/s; each
               worker's burst split from its /metrics.json; the cold
               bring-up. (b) bench_extra.py's multi-model rung at its
               on-TPU configuration (each model cut to MULTIMODEL_LAYERS
               of its 12 layers since slice 20): 3 models + the head
               model's v2, 2 in-process ModelHost replicas, 32
               zipf-mixed requests,
               rollout() at request 16; completed ratio 1.0, the wide
               events' model mix, no compile-cache miss, and a pager whose
               bytes stay under its budget with the LRU oracle's
               evictions.
 17. slice 7, training as users configure it - GPT-3 small's optimiser
               settings on the bench's model (AdamW 0.9 / 0.95, weight decay
               0.1 off biases and norms, clip 1.0, warm-up into cosine),
               under the flash strict mode: (a) f32 with remat and k_steps
               2 on the bench GPT cut to 2 layers (batch 2 x 512), 3
               updates, against the CPU; (b) full width with f32 master
               parameters and bf16 AMP, 2 warm-up + 10 timed steps, median
               step, MFU and peak memory beside phase 6's; (c) the same
               with whole-step remat and with per-block recompute (24
               forward launches a step); (d) fp16 AMP with loss scaling
               from 2^32: skipped steps (scale halved, parameters and step
               count kept), then training through the fp16 kernels; (e)
               the eager loop: auto_cast O1 bf16 (attention in the f32
               kernels; one more step profiled for its busy share) and O2
               fp16 with a GradScaler. The kernel phases
               time the forward and fused backward at the training shape
               in fp16 and f32 too.
 18. slice 9, the training shell - (a) Model.fit over phase 6's model and
               batch (bf16, AdamW lr 1e-4, fused loss) from a DataLoader
               of 2 forked workers over seeded token rows (513 tokens a
               sample, ids and shifted labels), shuffled, 24 steps: 12
               forward and 12 fused backward launches every step, the fit
               step's p50 and its StepTimeline split (data_wait /
               host_dispatch / device_block) beside phase 6's bare
               TrainStep, a profiled fit step's busy share, peak memory;
               then evaluate() on 4 batches with Accuracy (12 forward
               launches a batch). (b) f32, 2 layers at full width, batch
               4 x 512: an uninterrupted 12-step fit against the same fit
               killed after step 7 under a TrainingSupervisor (checkpoints
               every 4 steps) and resumed in a fresh Model after a wrong
               np.random.seed, and against one preempted by
               PreemptionWatcher.request() after step 6 and resumed: the
               batch order, the losses after the resume and every
               parameter bitwise equal. (c) the sample rows as 4 shards
               through IngestPipeline (window 64, prefetch 2, device_put)
               into (a)'s model for 8 steps (data_wait share), then (b)'s
               fit on the pipeline killed and resumed through the
               supervisor with the pipeline attached: the batches after the
               resume and the parameters bitwise equal.
 19. slice 10, compiled mode and the inference engine - (1) the kernels as
               torch.library custom ops (paddle_tpu_torch::flash_fwd /
               flash_bwd): torch.library.opcheck of both on each route
               (standard + fused in bf16 and f32, two-pass at n = 1024,
               long at b=1 h=2 n=4096), each op's outputs against the
               plain versions; (2) f32, the bench GPT cut to 1 layer
               (2 before slice 23), batch 2 x 512: 3 AdamW steps with the
               forward and the loss
               under jit.to_static against the same steps eager; (3) path
               (a): the bench's bf16 step (phase 6's model cut to 1
               layer to make room for phases 24-25 and 28, its batch and
               AdamW) with the forward and the loss as one to_static
               program, then loss.backward() and the update: one graph
               and no break, one compile, a forward and a fused backward
               launch a layer every step, a falling loss, the compile seconds,
               2 warm-up and 10 timed steps beside the same step eager,
               a profiled step's busy share and top kernels,
               the _rows_aligned copies, peak memory; (4) path (b):
               jit.save of GPT-2 small cut to 1 layer (to make room
               for phases 23-25 and 28) with InputSpec([8, 768], 'int64'),
               jit.load, the exported program against the eager model,
               then a Predictor on the card in f32 and in bf16, run() on
               8 x 768 ids: the first run compiles, 3 more do not, one
               flash forward launch a layer and run, logits against the eager
               model (f32 within 1e-4), run() p50 beside the eager
               forward. The phase prints its own seconds.
 20. slice 11, the static graph - (a) GPT-2 small (seeded, dropout 0,
               cut to 1 layer to make room for phases 23-25 and 28) built under
               static.program_guard from static.data('ids', [8, 768],
               'int64') in f32 and bf16, Executor.run on the
               card with 3 fresh feeds: logits against the eager f32
               forward (f32 within 1e-4, bf16 within 0.1 of the range),
               different feeds give different fetches, one flash forward
               launch a layer and run, one compile, the first run's compile
               seconds, run() p50 with numpy out and with tensors on the
               card, a profiled run's busy share; (b) save_inference_model
               of the f32 Program (a torch.export program, weights
               inside), load_inference_model and Executor.run on the card:
               fetches within 1e-5 of (a)'s, a launch a layer, its size
               and load seconds; (c) phase 6's bf16 model and batch under
               program_guard with its fused loss: append_backward's
               (parameter, grad) pairs against loss.backward() of the same
               model on the same batch, 12 + 12 launches; (d) the digits
               CNN and fit_a_line written in the reference format (a
               ProgramDesc and LoDTensor writer of this script's own), in
               the separate and the combined layout, through a Predictor
               and through load_inference_model + Executor on the card,
               each within 1e-5 of the op table on the CPU. The phase
               prints its own seconds.
 21. slice 12, the parameter server and the graph engine - (a) CTR at the
               shape of PaddleRec's Criteo DNN: 30 batches x 512 of 26
               Zipf-skewed slots (one table of 1,000,001 ids of dim 9) and
               a label, written as MultiSlot files and parsed by the native
               datafeed (the Python parser refused), 2 EmbeddingServer
               shards on the native table (server-side adagrad) behind
               sockets, an AsyncCommunicator, DownpourTrainer with 2
               threads and its dense half (26 x 9 -> 512 -> 1) on the card:
               examples/s, the p50 of a batch's pull / device step / push,
               rows held per shard, a falling loss, one batch's pooling and
               dense step on the card against the CPU (f32, TF32 off,
               1e-5); (b) HeterEmbedding over the 26 slots into the same
               MLP under the port's Adam: one step's pushed rows against an
               nn.Embedding's gradient (1e-6), then every batch through
               the communicator; PassCachedEmbedding over a pass of 20
               batches: end_pass pushes exactly the touched rows' deltas;
               examples/s of each and peak memory; (c) a graph of
               ogbn-arxiv's shape (169,343 nodes, 1,166,243 edges both
               ways, 128-dim features, 40 classes, communities from the
               seed) in 2 GraphPyServer shards on the native store, a
               2-layer GraphSAGE mean (hidden 256, fan-outs 25 / 10, 512
               seeds) under Adam on the card for 10 steps: seeds/s, the
               p50 of sampling / feature gather / copy to the card /
               device step, the load time, a falling loss, the first
               batch's forward against the CPU (1e-5); (d) bench_extra's
               supervisor rung: a journaled PS shard snapshotted, killed
               and recovered by ShardSupervisor.poll() (rows bitwise
               equal, MTTR, the journal's replays and dedup hits), then a
               graph shard the same way (degrees and seeded samples
               equal). Every line carries the card's name and power
               limit. The phase prints its own seconds.
 22. slice 13, collective training, at world 1 over NCCL - the collective
               API on CUDA tensors; (a) phase 6's bench GPT (bf16, batch
               32 x 512, AdamW lr 1e-4) for 5 steps through
               fleet.fleet_train_step under dp and sp in ring and Ulysses
               mode (mp and sharding stage 3 run composed in phase 26
               (a)), each beside the plain TrainStep from the same
               weights: losses within 2e-2, 12 + 12 flash launches a
               step, the parameters after the steps within 0.05 of the
               plain step's update (update_rel), step p50 and peak
               memory; (b)
               the ring attention's forward and backward block steps over
               every block of a P-block ring (bf16, b=2 h=12 d=64, seq
               1024 / P=2, 8192 / 4, 8192 / 2, causal and not): merged o
               and lse, dq, dk, dv against plain f32 attention at the
               kernel rows' tolerances, each entry's launches. The phase
               prints its own seconds.
 23. slice 14, BERT-class training - (a) BertForPretraining at BERT-base
               (vocab 30522, 768 x 12 x 12, intermediate 3072, gelu,
               dropout 0.1) with the fused MLM loss, bf16, batch 32 x 512
               without padding (~15% MLM labels, seeded NSP labels), AdamW
               lr 1e-4 through TrainStep, 2 warm-up and 10 timed steps:
               step ms, tokens/s, MFU, busy share, peak memory, a profile;
               BertModel's pad mask keeps attention on the masked path (0
               flash launches, asserted) and the loss falls. (b) the same
               model at 2 layers, dropout 0, f32: 3 steps on the card
               against the CPU (losses within 1e-5) and the sequence
               classifier's logits (1e-5). (c) nn.TransformerEncoder at
               BERT-base width without a mask (attn_dropout 0), bf16, batch
               32 x 512, a mean-square loss, AdamW: 12 non-causal forward
               and 12 fused backward launches a step, a profile;
               nn.Transformer at Transformer-base width (512, 8 heads,
               ff 2048, relu), 2 + 2 layers, f32, source 1024 and target
               512 with the causal target mask: the encoder's and the
               cross-attention's non-causal forward and two-pass backward
               (4 + 4 + 4 launches), output and gradients within 1e-4 of
               the CPU (the ReLU branches pinned to the CPU run's;
               gradients against the model's largest). The kernel
               phases time #1 and #3 at the encoder's non-causal shape and
               the f32 rows of nn.Transformer's calls.
 24. slice 15, the observability plane - (a) paddle_tpu_torch.profiler's
               Profiler around two of phase 6's bf16 bench steps: the
               device trace holds the flash kernels by name, 12 + 12 a
               step (the fused backward's two kernels each), a RecordEvent
               region is in the trace and in the tracer's FlightRecorder,
               merge_traces of the trace and the recorder's export loads
               back. (b) Model.summary_perf of the bench GPT (bf16, 32 x
               512), priced on fake tensors: FLOPs within 1% of the hand
               count (GEMMs, the fused LM head, the flash products as the
               kernel bounds count them), mfu_est from phase 6's median
               step, both it and the roofline share at most 1.05. (c) a
               CompileWatchdog on phase 19 (b)'s f32 Predictor: 0
               recompiles over same-shape runs after the barrier, 1 for a
               new batch size, attributed to this file, RecompileError
               under strict. (d) two GPT-2 small replicas (f32) behind a
               gateway wired to a FleetCollector, an AlertManager, a
               rotating RequestLog sink, a Tracer with a recorder and
               retention and a MetricsServer: replica 1 partitioned
               mid-flight, the threshold rule fires once with one flight
               dump, the failed-over traces are retained, /fleet /alerts
               /requests answer, tokens equal one engine's, no flash
               launch. (e) the fleet simulator fitted on (d)'s wide
               events: K-S and p50 / p99 TTFT errors.
 25. slice 16, pipeline and expert parallelism - (a) phase 6's bench GPT
               (bf16, batch 32 x 512, AdamW lr 1e-4) through
               TrainStep(pp_state) on a one-stage pipeline over NCCL (world
               1) of 4 microbatches, GPipe and 1F1B, 5 steps each beside
               the plain step from the same weights: losses within 2e-2,
               update_rel within 0.05, 4 x (12 + 12) flash launches a step,
               step p50 and peak memory. (b) the stage pieces at the
               per-rank shapes of pp 2 (6 / 6 layers) and pp 4 (3 x 4),
               the embeddings on stage 0, ln_f, the tied head and the loss
               on the last, one microbatch of 8 chained forward and backward
               as the schedule calls them: the loss and every grad (the
               tied wte's the sum of its two stages') against the unsplit
               model, 2e-2 in bf16 and 1e-5 in f32. (c) the bench GPT with
               a SwitchMoE of 8 experts in every block at Switch-Base width
               (768, ff 3072, capacity factor 1.25, top-1; 505 M
               parameters), bf16, batch 16 x 512, AdamW, 2 warm-up and 5
               timed steps: step ms, tokens/s, MFU over the active
               parameters, peak, the share of tokens dropped in each layer,
               the aux loss, a profile, 12 + 12 flash launches a step and a
               falling loss; GShardMoE (top-2) in every block for 2 steps;
               2 layers in f32 at capacity factor 0.5 (tokens drop), 3
               steps against the CPU within 1e-5. The phase prints its own
               seconds.
 26. slice 17, the rest of the distributed stack, at world 1 - (a) a pod
               of one rank started by python -m
               paddle_tpu_torch.distributed.launch (SLICE17_JOB, this
               file's slice17_job: NCCL on card FLAGS_selected_gpus from
               the launcher's env contract, its NCCL groups ended at the
               end) trains phase 6's bench GPT (bf16, 32 x 512) 5 steps
               through fleet_train_step under ZeRO-3 over tensor-parallel
               placements (mp and sharding of size 1: FSDP2 over 2-D
               DTensors) with per-block recompute, bf16 AMP and AdamW
               under ClipGradByNorm, beside the plain step with the same
               optimizer: losses within 2e-2, update_rel within 0.05,
               24 + 12 launches a step (12 + 12 plain), step p50, peak,
               the launcher's start-up seconds.
               (b) the same launcher with --elastic_server: f32, 2
               layers, the job checkpoints after 3 steps and exits 101,
               is relaunched and resumes for 3 more; its losses within
               1e-5 of the 6 steps uninterrupted in this process (and
               whether bitwise). (c) GPT-2 small generate() of 8 x 768 +
               32 new through weights over 'mp' (fleet.distributed_model)
               against the plain model: f32 tokens identical, one flash
               launch a layer (the prefill); bf16 decode tokens/s of both; the
               QKV weight's gather and head cut timed alone. (d) Linear ->
               SyncBatchNorm -> ReLU -> Linear under DataParallel on the
               card against BatchNorm1D on the CPU, f32, 5 SGD steps,
               within 1e-5. (c) decodes through GPT-2 small cut to 2 of
               its 12 layers (TP_DECODE_LAYERS: 6 since slice 18, 2 since
               slice 23).
 27. slice 18, convolutional vision - (a) BASELINE config 2: resnet50()
               cast to bf16 (its batch norm statistics too), batch 64 of
               seeded 3 x 224 x 224 images and labels in [0, 1000),
               Momentum lr 0.1 and cross-entropy through TrainStep; 2
               warm-up steps, the median of 10: images/s, the step's
               FLOPs from the cost model (held within 1% of the layers'
               hand count), mfu_est over the bf16 datasheet peak, a
               profiled step's busy share and top kernels, peak memory;
               the loss finite and falling, no flash launch. (b) resnet18
               on the card (TF32 off) and on the CPU from the same
               weights, 3 steps at 32 x 3 x 64 x 64, in f32 and float64:
               float64 losses, first update and state within F64_TOL of
               the CPU's; f32 within F32_FACTOR x the CPU's own f32
               distance from float64 in the same run. (c)
               mobilenet_v2 in bf16, a step at batch 64 x 224 (17
               depthwise convolutions, ReLU6). (d) LeNet through
               Model.fit for one epoch of MNIST-format idx files written
               from the seed, read by vision.datasets.MNIST under a
               transforms.Compose of Normalize, then evaluate(): the loss
               falls. The phase prints its own seconds.
 28. slice 19, sequence models - (a) the PTB "medium" LSTM language
               model (Zaremba et al. 2014; PaddleNLP's rnnlm default):
               Embedding(10000, 650), LSTM(650, 650, 2 layers) on torch's
               fused RNN op (cuDNN), Linear(650, 10000), dropout 0.5,
               35 steps x batch 20 of seeded Zipf token ids, SGD lr 1.0
               under ClipGradByGlobalNorm(5.0) through TrainStep, f32
               with TF32 off: the median of 10 steps after 2 warm-up,
               tokens/s, MFU by a hand count over the f32 peak, a
               profiled step's busy share and top kernels, peak memory,
               the loss falling; the same step through the per-step cell
               loop; dropout 0, 3 steps card vs CPU (losses within 1e-5,
               parameters within 1e-4 of their largest entry). (b)
               BeamSearchDecoder over LSTMCell(512, 512) with an
               Embedding(10000, 512) and a Linear(512, 10000), beam 10,
               batch 8, 64 steps at most, f32: steps/s, a step's host
               and device time; the cell in float64, each card step held
               to the CPU's step from the same state (scores within 1e-5;
               picks differ only at ties within it), gather_tree on the
               card against the CPU. (c) a 2-layer bidirectional GRU
               with sequence_length (a row of length 0), ctc_loss with
               its logit gradients (T 50, B 8, C 30), the CRF cost and
               crf_decoding: card vs CPU in f32 within 1e-5. No flash
               launch. The phase prints its own seconds.
 29. slice 20, detection - (a) BASELINE config 4, as bench_extra.py's
               bench_yolo_infer drives it: ppyolov2(num_classes=80) at
               width 32 and 320 x 320, eval, f32, seeded images; the
               forward with decode at batch 1 and 8 (3 repeats of 10
               calls: the median and the spread, ms an image and QPS),
               then postprocess (matrix NMS, keep_top_k 100) alone, each
               with TF32 off and on; a profiled forward's and
               postprocess's busy share and top kernels, peak memory, the
               convolutions' FLOPs by hand and MFU over the f32 or TF32
               peak. (b) the same weights on the card and the CPU (TF32
               off): decode within 1e-4 of its largest value; matrix_nms
               and multiclass_nms on the card fed the CPU's decode:
               labels, counts and boxes equal, scores within 1e-5, rows a
               tie within 4 ulps placed counted; roi_align (the value),
               yolo_loss and deform_conv2d (values and gradients) within
               1e-5. (c) jit.save of the eval model, a Predictor on the
               card at batch 8 (batch 1 before slice 23), its Inductor
               cache in a directory of its own: boxes within 1e-4 of the
               eager forward, the first run and run()'s p50; then phase
               32 (b) on the same artifact, cache and Predictor, before
               the directory is removed. (d) the fluid PP-YOLO tail
               (yolo_box -> transpose2 -> multiclass_nms3) through
               load_fluid_model compiled on the card against the op table
               on the CPU. No flash launch. The phase prints its own
               seconds.
 30. slice 21, quantization and the rest of incubate - (a) weight-only
               int8 serving on phase 4's model and prompts: GPT-2 small
               in bf16, 8 x 768 + 128 new, greedy; generate()'s prefill
               ms and decode tokens/s (medians of 3), streamed_bytes and
               peak memory, plain and after quantize_weight_only (48
               Linears swapped, the tied head kept), 12 flash launches a
               prefill; the slot engine (8 slots) over the same requests,
               plain and int8; at 2 layers in f32 on 2 prompts of 512:
               the card's int8 weights equal the CPU's, the prefill on
               the f32 kernel, its last logits within 1e-4 of the CPU's,
               16 greedy tokens equal the CPU's and the engine's equal
               generate()'s. (b) QAT at BASELINE config 2: phase 27 (a)'s
               ResNet-50 recipe, plain then under ImperativeQuantAware
               (channel-wise weights; 53 Conv2D and 1 Linear wrapped),
               the median of 10 steps after 2 warm-up each, images/s,
               busy share, peak memory; the loss falls, every activation
               scale set and finite, no flash launch; resnet18 QAT in
               float64, 3 steps, card vs CPU within 1e-6. (c) PTQ of
               ResNet-50 in f32 (abs_max and KL, 2 batches of 16 x 224,
               4 before slice 23):
               calibration seconds split into the forward and the host
               observers, the quantized eval forward at batch 64 beside
               the plain one; resnet18 in float64 (8 x 224, 2 batches),
               each of the five algorithms: every layer's scale on the
               card within 1e-5 (relative) of the CPU's. (d) ASP on
               phase 6's bench GPT in bf16 at 8 x 512: prune_model 2:4
               (48 Linears), 3 eager steps of a decorated AdamW beside
               the same steps unpruned, 12 flash forward and 12 fused
               backward launches a step, every pruned weight 2:4 after
               the steps; ResNet-50: the fc alone pruned. (e)
               LookAhead, ModelAverage and ExponentialMovingAverage over
               6 eager steps of an MLP, the segment ops (empty segments
               too) and softmax_mask_fuse_upper_triangle: card vs CPU in
               float64 within 1e-6. The phase prints its own seconds.
 31. slice 22, the library surface - (a) utils.op_benchmark's default
               suite (the JAX package's seven configs at its sizes) on the
               card: the flash config through run_benchmarks, then the
               suite through main --out into a temporary file (once: its
               set-up draws 250 M normals with numpy): every config ok,
               the flash config 23 launches of the flash forward (3
               warm-up + 20 timed) and no other kernel in each run,
               compare(results, results) empty, the seven mean_ms. (b) F.sparse_attention at a BigBird-base layout
               (b 2, h 12, n = m = 4096, d 64, 64-token blocks, 3 window +
               2 global + 3 random blocks a row, a key-padding mask) on
               the card: f32 forward and q / k / v gradients on batch 0's
               first two heads against the float64 CPU run of the same
               function on those heads, within SPARSE_TOL; bf16 forward
               within SPARSE_TOL_BF16; each timed by CUDA events. (c) the
               eight distributions on the card: 10^6 draws' mean and
               variance within 5 standard errors of the closed forms, the
               same draws again from the same generator seed, log_prob /
               entropy / kl_divergence in float64 within 1e-12 of the
               CPU's. (d) utils.cpp_extension.load builds the relu / cat
               C++ source with g++: CUDA tensors forward, backward and
               under torch.compile(fullgraph=True) equal to the CPU run,
               with the op's host round trips. (e) fit-a-line: a seeded
               506 x 14 housing.data, nn.Linear(13, 1) in float64 with
               SGD for 2 epochs through batch(dataset.uci_housing.train(),
               20) on the card: every step's loss within 1e-10 of the
               CPU's, and the loss falls. (f) check_numerics on card
               tensors and utils.run_check() on the card. The phase prints
               its own seconds.
 32. slice 23, export and the C surface - (a) GPT-2 small (full width
               and depth, f32, TF32 off, seeded) on 1 x 512 ids: the eager
               forward on the card (12 f32 flash_fwd launches, split
               TF32), onnx.export at the same spec (no launch; the flash
               op lowered to its plain version, 12 lowered nodes), the
               file read back and run on the host by tests/onnx_numpy.py:
               logits within 1e-4 of the card's largest; the export's
               seconds, the file's MB, the evaluation's seconds. (b) runs
               inside phase 29 (c), beside the Predictor it is held to;
               this phase prints its numbers again. The C
               API: the library (g++, CPython embedded) and a C client
               (gcc) built on the machine; the client in a child process
               serves phase 29 (c)'s PP-YOLOv2 artifact (batch 8 x 3 x
               320 x 320, f32) on device "gpu" with phase 29 (c)'s
               Inductor cache (warm or cold, by its new entries) and
               writes its outputs as raw bytes: equal bit for bit to the
               in-process Predictor's under the same TF32 defaults
               (cuDNN's on), or within 1e-4 of the largest; the child's
               seconds to its first output, PD_PredictorRun's p50 over
               10 (C clock) beside the in-process run()'s. (c) (a)'s
               state saved from the card with encryption_key= and loaded
               back onto the card: bit-equal, the scheme (AES-256-GCM
               expected), GB/s each way, a wrong key refused. The phase
               prints its own seconds.
(Phases 9-11 and 13-16 run after phase 8 and before phases 5-7, 12, 17,
18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31 and 32 in main().)
The last lines are the whole run's seconds (the build included), a
{"kernels_wide": [...]} line, the card's name and power limit as
nvidia-smi gives them, a {"kernels": [...]} line and the {"ok": true,
...} line.
"""
import collections
import gc
import json
import math
import os
import socket
import struct
import subprocess
import sys
import time
import weakref

import numpy as np
import torch

SEED = 1234
# torch's matmul precision setting as a fresh process has it (the phases
# below set allow_tf32, which changes it): Inductor's cache key holds it,
# so phase 29 (c) compiles under it for phase 32 (b)'s C client, a fresh
# process, to find that compile in the cache
MATMUL_FP32_DEFAULT = getattr(torch.backends.cuda.matmul, 'fp32_precision',
                              None)

# The card's datasheet peaks (dense, no sparsity) come from the port's cost
# model (paddle_tpu_torch/monitor/perf/costmodel.py, SKUS), the one table
# both the kernel bounds below and the cost model's MFU read.

# A kernel timed below its bound means the bound's count is wrong: any row
# whose bound_ms / ms exceeds this raises.
MAX_SHARE_OF_BOUND = 1.05


def _check(ok, msg):
    if not ok:
        raise RuntimeError('check failed: ' + msg)


def _sku(name):
    """(key, bytes/s, {dtype: ops/s}) of the card's datasheet row."""
    from paddle_tpu_torch.monitor.perf import costmodel
    return costmodel.sku(name)


def _nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters=10, warmup=2):
    """Mean device time of fn over `iters` launches, by CUDA events."""
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


def _graph_ms(fn, iters=10):
    """Device time of one call of fn: `iters` calls captured in a CUDA graph,
    the graph replayed 3 times between CUDA events. A kernel's wrapper costs
    tens of microseconds of host time a call, as much as the kernel itself at
    the short shapes; replaying the graph leaves no host gaps between the
    launches, so this times the kernel. fn is warmed up on a side stream
    before the capture, as torch.cuda.graph asks for code that runs
    autograd."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def _profile(fn):
    """(wall ms, summed device kernel ms, top kernels, top aten ops) of fn.
    The wall time is taken on a call without the profiler, which slows the
    host; the kernel times on a second call under torch.profiler. Their
    ratio is the card's busy share. An aten op's device time includes the
    kernels of the ops it calls. The trace opens on the port profiler's
    pad (a trace can lose its first launches), left out of the sums."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.profiler import pad_window

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_window()
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and 'spin_kernel' not in e.key]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith('aten::')),
                 key=lambda e: -e.device_time_total)[:6]
    return (wall_ms, device_ms,
            [(e.key[:60], e.self_device_time_total / 1e3, e.count)
             for e in top],
            [(e.key, e.device_time_total / 1e3, e.count) for e in ops])


def _rate_name(dtype, cuda_cores):
    name = {torch.bfloat16: 'bfloat16', torch.float16: 'float16',
            torch.float32: 'float32'}[dtype]
    return name + '_cuda_cores' if cuda_cores and name == 'float32' else name


def _share_of_bound(bound_ms, ms, what):
    """bound_ms / ms, raising above MAX_SHARE_OF_BOUND."""
    share = bound_ms / ms
    _check(share <= MAX_SHARE_OF_BOUND,
           '%s: %.4f ms is %.2f of its bound %.4f ms: the bound is miscounted'
           % (what, ms, share, bound_ms))
    return share


def _flash_bound_ms(b, h, n, m, d, dtype, causal, sku, cuda_cores=False):
    """Least time for the flash forward: each input read once, o and lse
    written once, over the memory rate; the score and p @ v products that
    these inputs need (causal: the visible pairs only) over the peak rate
    for their type (f32: split TF32, or with cuda_cores the FFMA rate).
    Returns (ms, 'bytes' or 'operations')."""
    from paddle_tpu_torch.monitor.perf import costmodel
    _, bw, ops = sku
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * b * h * n * d + 2 * b * h * m * d) * item + 4 * b * h * n
    flops = costmodel.flash_fwd_flops(b, h, n, m, d, causal)
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / ops[_rate_name(dtype, cuda_cores)] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


# (b, h, n, m, d, dtype, causal, strided): `strided` slices q, k, v out of
# one [b, n, 3, h, d] projection as the GPT prefill does; the first row is
# the serving path's shape, the second the training path's
PREFILL_SHAPE = (8, 12, 768, 768, 64, torch.bfloat16, True, True)
TRAIN_SHAPE = (32, 12, 512, 512, 64, torch.bfloat16, True, True)
TRAIN_SHAPE_F16 = (32, 12, 512, 512, 64, torch.float16, True, True)
TRAIN_SHAPE_F32 = (32, 12, 512, 512, 64, torch.float32, True, True)
ENCODER_SHAPE = (32, 12, 512, 512, 64, torch.bfloat16, False, False)
XF_CROSS_SHAPE = (2, 8, 512, 1024, 64, torch.float32, False, False)
KERNEL_SHAPES = [
    PREFILL_SHAPE,
    TRAIN_SHAPE,
    (8, 12, 768, 768, 64, torch.bfloat16, False, False),
    (8, 12, 768, 768, 64, torch.float32, True, False),
    (8, 12, 768, 768, 64, torch.float32, False, True),
    (8, 12, 768, 768, 64, torch.float16, True, False),
    (2, 12, 4096, 4096, 64, torch.bfloat16, True, False),
    (2, 8, 1024, 1024, 128, torch.bfloat16, True, False),
    (2, 8, 1024, 1024, 128, torch.bfloat16, False, False),
    # ragged last tiles, and a cross-length call, on both kernel paths
    (1, 2, 700, 700, 64, torch.float32, True, False),
    (1, 2, 700, 700, 64, torch.bfloat16, True, False),
    (1, 3, 300, 700, 128, torch.float16, False, False),
    # the training shape in the other operand types: slice 7's fp16 AMP
    # (loss scaling) and auto_cast O1, which runs attention in f32
    TRAIN_SHAPE_F16,
    TRAIN_SHAPE_F32,
    # the split-TF32 kernels at the seq-1024 shape and at d = 128
    (8, 12, 1024, 1024, 64, torch.float32, True, True),
    (2, 8, 1024, 1024, 128, torch.float32, True, False),
    # slice 14: the unmasked encoder's non-causal call at BERT-base's
    # shape; nn.Transformer's f32 cross-attention (n = 512, m = 1024) and
    # encoder self-attention (1024)
    ENCODER_SHAPE,
    XF_CROSS_SHAPE,
    (2, 8, 1024, 1024, 64, torch.float32, False, False),
]

# f32 at these head dims runs the split-TF32 kernels (flash_*_tf32_kernel);
# a CUDA-core kernel there is a fault
TF32_HEAD_DIMS = (64, 128)

# Tolerances of the kernel against its plain version. Both sum the same
# f32 products in another order and round p to v's dtype at another point
# (the kernel against the running max, the plain version against the row
# max), then round o to the input dtype. In f32 that leaves sum-order error
# (~1e-6 here), so 1e-4 holds with margin. In bf16 / fp16, o is rounded to
# 8 / 11 bits: |o| < 4 at these inputs gives a bf16 ulp of at most 1/64,
# so one ulp of disagreement stays under 2e-2. lse is f32 in every case and
# only sees sum order: 1e-3 for the 16-bit inputs (their exp sums are
# larger and less flat), 1e-4 for f32.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3),
             torch.float16: (2e-2, 1e-3)}


def _qkv(gen, b, h, n, m, d, dtype, strided):
    """Seeded q, k, v [b, h, n|m, d]; strided ones are views of one
    [b, n, 3, h, d] projection, as in the GPT attention."""
    if strided:
        _check(n == m, 'strided inputs share one sequence length')
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device='cuda')
        qkv[:, :, 2] *= 0.5
        qkv = qkv.to(dtype)
        return [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    q = torch.randn((b, h, n, d), generator=gen, device='cuda')
    k = torch.randn((b, h, m, d), generator=gen, device='cuda')
    v = 0.5 * torch.randn((b, h, m, d), generator=gen, device='cuda')
    return [q.to(dtype), k.to(dtype), v.to(dtype)]


def _check_kernel_names(fn, want, what):
    """The flash kernels fn launches, by name from the profiler over 3
    calls after its pad (a trace can lose its first launches): every name
    in `want` and no CUDA-core kernel (flash_*_cc_kernel). Returns the
    names."""
    flash = sorted(n for n in _kernels_ms(fn, calls=3)
                   if n.startswith('flash_'))
    _check(set(want) <= set(flash) and
           not any(n.endswith('_cc_kernel') for n in flash),
           '%s launched %s, want %s and no CUDA-core kernel'
           % (what, flash, sorted(want)))
    return flash


def _f32_fields(row, dtype, d, bound_cc, fn, want, what):
    """An f32 row's CUDA-core bound, and at d = 64 / 128 the names of the
    kernels fn launches (the split-TF32 ones, checked; fn None: none)."""
    if dtype != torch.float32:
        return
    row['bound_ms_cuda_cores'] = bound_cc
    if d in TF32_HEAD_DIMS and fn is not None:
        row['kernels'] = _check_kernel_names(fn, want, what)


def kernel_phase(sku):
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rows = []
    for b, h, n, m, d, dtype, causal, strided in KERNEL_SHAPES:
        scale = 1.0 / math.sqrt(d)
        q, k, v = _qkv(gen, b, h, n, m, d, dtype, strided)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        _check(o.shape == (b, h, n, d) and lse.shape == (b, h, n, 1),
               'output shapes')
        _check(bool(torch.isfinite(o.float()).all()), 'o finite')
        tol_o, tol_lse = TOLERANCE[dtype]
        _check(err_o <= tol_o and err_lse <= tol_lse,
               'kernel vs plain at %s: o err %.3g (tol %g), lse err %.3g '
               '(tol %g)' % ((b, h, n, m, d, str(dtype), causal), err_o,
                             tol_o, err_lse, tol_lse))
        ms = _graph_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale))
        eager_ms = _time_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale))
        plain_ms = _time_ms(
            lambda: fa.flash_attention_fwd_ref(q, k, v, causal, scale),
            iters=3, warmup=1)
        library_ms = _graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale))
        bound_ms, bound_by = _flash_bound_ms(b, h, n, m, d, dtype, causal,
                                             sku)
        what = 'flash_fwd at %s' % ((b, h, n, m, d, str(dtype), causal),)
        row = {'shape': [b, h, n, m, d], 'dtype': str(dtype).split('.')[-1],
               'causal': causal, 'strided': strided, 'err_o': err_o,
               'err_lse': err_lse, 'ms': ms, 'eager_ms': eager_ms,
               'plain_ms': plain_ms,
               'library_ms': library_ms, 'bound_ms': bound_ms,
               'bound_by': bound_by,
               'share_of_bound': _share_of_bound(bound_ms, ms, what)}
        _f32_fields(row, dtype, d, _flash_bound_ms(
            b, h, n, m, d, dtype, causal, sku, cuda_cores=True)[0],
            lambda: fa.flash_fwd_cuda(q, k, v, causal, scale),
            {'flash_fwd_tf32_kernel'}, what)
        print('kernel flash_fwd %s' % json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    return rows


def _bwd_bound_ms(b, h, n, m, d, dtype, causal, which, sku, cuda_cores=False):
    """Least time for a backward kernel: q, k, v, do, lse and delta read
    once and its gradients (fused: dq, dk, dv; dq: dq; dkv: dk, dv) written
    once, over the memory rate; its products (5, 3 or 4 of 2 * d flops for
    each visible pair) over the peak rate for their type (f32: split TF32,
    or with cuda_cores the FFMA rate). Returns (ms, 'bytes' or
    'operations')."""
    from paddle_tpu_torch.monitor.perf import costmodel
    _, bw, ops = sku
    item = torch.empty((), dtype=dtype).element_size()
    q_elems, k_elems = b * h * n * d, b * h * m * d
    written = {'fused': q_elems + 2 * k_elems, 'dq': q_elems,
               'dkv': 2 * k_elems}[which]
    nbytes = (2 * q_elems + 2 * k_elems + written) * item + 2 * 4 * b * h * n
    flops = costmodel.flash_bwd_flops(b, h, n, m, d, causal, which)
    t_bytes = nbytes / bw * 1e3
    t_ops = flops / ops[_rate_name(dtype, cuda_cores)] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


# (b, h, n, m, d, dtype, causal, strided): every backward kernel runs at
# every shape. The first is the training main path's shape (fused route),
# the second the seq-1024 path's (two-pass); the last the non-causal
# cross-length call with which ring attention takes the two-pass pair.
BWD_MAIN_SHAPE = (32, 12, 512, 512, 64, torch.bfloat16, True, True)
BWD_SECOND_SHAPE = (8, 12, 1024, 1024, 64, torch.bfloat16, True, True)
BWD_SHAPES = [
    BWD_MAIN_SHAPE,
    BWD_SECOND_SHAPE,
    (8, 12, 512, 512, 64, torch.bfloat16, False, True),
    (8, 12, 512, 512, 64, torch.float16, True, False),
    (2, 12, 512, 512, 64, torch.float32, True, True),
    (4, 8, 512, 512, 128, torch.bfloat16, True, False),
    (2, 8, 1024, 1024, 128, torch.bfloat16, False, False),
    (1, 2, 300, 300, 64, torch.bfloat16, True, False),
    (1, 2, 700, 700, 64, torch.bfloat16, True, False),
    (1, 2, 700, 700, 128, torch.float32, False, False),
    (2, 8, 640, 1152, 64, torch.bfloat16, False, False),
    TRAIN_SHAPE_F16,
    TRAIN_SHAPE_F32,
    # the split-TF32 kernels at the seq-1024 two-pass shape
    (8, 12, 1024, 1024, 64, torch.float32, True, True),
    # slice 14: the unmasked encoder's fused backward; nn.Transformer's
    # cross-attention and encoder backward (two-pass, f32)
    ENCODER_SHAPE,
    XF_CROSS_SHAPE,
    (2, 8, 1024, 1024, 64, torch.float32, False, False),
]

# the split-TF32 kernels each backward entry launches
TF32_BWD_KERNELS = {
    'fused': {'flash_bwd_kv_tf32_kernel', 'flash_bwd_dq_tf32_kernel'},
    'dq': {'flash_bwd_dq_tf32_kernel'}, 'dkv': {'flash_bwd_kv_tf32_kernel'}}

# Tolerances of the backward kernels against their plain version, as a
# share of the largest reference gradient. Both take the same f32 products
# of the same native operands; they differ in the order of the f32 sums
# (~1e-6 relative), so where p or ds lies that close to a rounding boundary
# of the operand dtype they may round it differently, and each gradient is
# then rounded to the operand dtype: one ulp at the largest entry is 2^-8
# of it in bf16 and 2^-11 in fp16. 2e-2 (bf16) and 4e-3 (fp16) allow a few
# ulps; f32 sees sum order only, 1e-4.
BWD_TOLERANCE = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
                 torch.float32: 1e-4}


def bwd_kernel_phase(sku):
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED + 1)
    rows = []
    for shape_key in BWD_SHAPES:
        b, h, n, m, d, dtype, causal, strided = shape_key
        scale = 1.0 / math.sqrt(d)
        q, k, v = _qkv(gen, b, h, n, m, d, dtype, strided)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        # the output gradient as the GPT attention hands it over: a
        # [b, h, n, d] view of a [b, n, h, d] tensor
        do = torch.randn((b, n, h, d), generator=gen,
                         device='cuda').to(dtype).transpose(1, 2)
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        args = (q, k, v, do, lse, delta, causal, scale)
        ref = fa.flash_attention_bwd_ref(*args)
        calls = {
            'fused': lambda: fa.flash_bwd_fused_cuda(*args),
            'dq': lambda: (fa.flash_bwd_dq_cuda(*args),),
            'dkv': lambda: fa.flash_bwd_dkv_cuda(*args),
        }
        refs = {'fused': ref, 'dq': ref[:1], 'dkv': ref[1:]}
        tol = BWD_TOLERANCE[dtype]
        shape = [b, h, n, m, d]
        lib = _sdpa_bwd_ms(q, k, v, do, causal, scale)
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_ref(*args),
                            iters=3, warmup=1)
        for which, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            errs, scales = [], []
            for g, r in zip(got, refs[which]):
                _check(g.shape == r.shape and g.dtype == r.dtype,
                       'flash_bwd_%s output shape / dtype' % which)
                _check(bool(torch.isfinite(g.float()).all()),
                       'flash_bwd_%s output finite' % which)
                errs.append((g.float() - r.float()).abs().max().item())
                scales.append(r.float().abs().max().item())
            for err, top in zip(errs, scales):
                _check(err <= tol * top,
                       'flash_bwd_%s vs plain at %s %s causal=%s: err %.3g > '
                       '%g x max %.3g' % (which, shape, dtype, causal, err,
                                          tol, top))
            if which != 'dkv':
                _check_same_dq(call, got[0], 'flash_bwd_%s' % which, shape)
            bound_ms, bound_by = _bwd_bound_ms(b, h, n, m, d, dtype, causal,
                                               which, sku)
            what = 'flash_bwd_%s at %s %s causal=%s' % (which, shape, dtype,
                                                        causal)
            ms = _graph_ms(call)
            row = {'shape': shape, 'dtype': str(dtype).split('.')[-1],
                   'causal': causal, 'strided': strided,
                   'max_abs_err': max(errs), 'errs': errs,
                   'ref_max': scales, 'tol_share': tol, 'ms': ms,
                   'eager_ms': _time_ms(call),
                   'plain_ms': plain_ms, 'library_ms': lib,
                   'bound_ms': bound_ms, 'bound_by': bound_by,
                   'share_of_bound': _share_of_bound(bound_ms, ms, what)}
            _f32_fields(row, dtype, d, _bwd_bound_ms(
                b, h, n, m, d, dtype, causal, which, sku,
                cuda_cores=True)[0], call, TF32_BWD_KERNELS[which], what)
            if which == 'fused' and shape_key in (BWD_MAIN_SHAPE,
                                                  TRAIN_SHAPE_F32,
                                                  ENCODER_SHAPE):
                # the dk/dv kernel and the dq kernel apart
                row['kernels_ms'] = _kernels_ms(call)
            print('kernel flash_bwd_%s %s' % (which, json.dumps(row)),
                  flush=True)
            rows.append((which, shape_key, row))
        del q, k, v, o, lse, do, delta, ref
        torch.cuda.empty_cache()
    return rows


def _check_same_dq(call, dq, name, shape):
    """A second launch of a dq entry on the same inputs gives a bitwise-equal
    dq: the kernels sum in a fixed order, with no atomics."""
    again = call()[0]
    torch.cuda.synchronize()
    _check(torch.equal(again, dq),
           '%s at %s: two launches differ by up to %.3g' % (
               name, shape, (again.float() - dq.float()).abs().max().item()))


def _kernels_ms(fn, calls=10):
    """{kernel name: mean device ms a launch} over `calls` calls of fn
    under torch.profiler: the fused backward's two kernels apart. The
    trace opens on the port profiler's pad (a trace can lose its first
    launches: cupti_probe.py), left out."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.profiler import pad_window

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_window()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split('<')[0].split('::')[-1]:
            e.self_device_time_total / 1e3 / e.count
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and 'spin_kernel' not in e.key}


def _sdpa_bwd_ms(q, k, v, do, causal, scale):
    """The backward part of torch's scaled_dot_product_attention on these
    inputs: forward + backward through autograd, minus the forward, both
    timed by CUDA-graph replay as the kernels are."""
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def both():
        out = sdpa(qr, kr, vr, is_causal=causal, scale=scale)
        torch.autograd.grad(out, (qr, kr, vr), do)

    def forward():
        with torch.no_grad():
            sdpa(qr, kr, vr, is_causal=causal, scale=scale)

    return _graph_ms(both) - _graph_ms(forward)


def _prefill_logits(model, ids):
    from paddle_tpu_torch.text.models.gpt import GPTStaticCache

    c = model.config
    dev = model.gpt.wte.weight.device
    caches = [GPTStaticCache.empty(
        ids.shape[0], ids.shape[1] + 1, c.num_heads,
        c.hidden_size // c.num_heads, dtype=model.gpt.wte.weight.dtype,
        device=dev) for _ in range(c.num_layers)]
    with torch.no_grad():
        logits, _ = model(ids.to(dev), caches=caches)
    return logits


# phase 3's prompts held to the CPU in f32 (of the 8 that phase 4 serves)
F32_PARITY_ROWS = 2


def slice_phases():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.gpt2_small()
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
    cpu = GPTForCausalLM(cfg, device='cpu', seed=SEED + 1).eval()
    cpu.load_state_dict(model.state_dict())
    prompt_gen = torch.Generator().manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (8, 768), generator=prompt_gen)

    # -- slice, f32: the card against the CPU plain path, same weights, on
    # the first F32_PARITY_ROWS prompts (the CPU's side is this phase's
    # largest cost)
    t0 = time.time()
    logits = _prefill_logits(model, ids)
    torch.cuda.synchronize()
    rows = ids[:F32_PARITY_ROWS]
    logits_cpu = _prefill_logits(cpu, rows)
    err = (logits[:F32_PARITY_ROWS].cpu() - logits_cpu).abs().max().item()
    # f32 products on both sides (TF32 off); sums in another order through
    # 12 layers leave ~1e-5 on logits of magnitude ~1
    _check(err <= 1e-3, 'f32 prefill logits vs CPU: %.3g > 1e-3' % err)
    new_f32 = 32
    out = model.generate(rows.cuda(), max_new_tokens=new_f32).cpu()
    out_cpu = cpu.generate(rows, max_new_tokens=new_f32)
    agree = int((out[:, 768:] == out_cpu[:, 768:]).sum())
    print('slice f32: params %d, %d prompts: prefill logits max abs err vs '
          'CPU %.3g (tol 1e-3), greedy tokens agreeing %d of %d, %.1f s'
          % (model.num_params(), F32_PARITY_ROWS, err, agree,
             out_cpu[:, 768:].numel(), time.time() - t0), flush=True)
    last_f32 = logits[:, -1].float()
    del cpu, logits, logits_cpu

    # -- slice, bf16: the main path
    model.bfloat16()
    ids_cuda = ids.cuda()
    model.generate(ids_cuda[:, :64], max_new_tokens=2)  # warm-up, no flash
    last_bf16 = _prefill_logits(model, ids_cuda)[:, -1].float()
    rel = ((last_bf16 - last_f32).abs().max()
           / last_f32.abs().max()).item()
    # bf16 keeps 8 mantissa bits; 12 layers of it stay within a few per
    # cent of the f32 logits' range
    _check(rel <= 0.1, 'bf16 vs f32 last logits: %.3g of range' % rel)

    _reset_counts(fa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(ids_cuda, max_new_tokens=128)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = fa.flash_fwd_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    _check(launches == cfg.num_layers,
           'flash launches %d on the main path, want %d (one per layer, '
           'prefill only)' % (launches, cfg.num_layers))
    _check(fa.counts['rejected'] == 0, 'a shape was routed off the kernel')
    _check(tuple(out.shape) == (8, 768 + 128), 'generate output shape')
    _check(bool((out[:, :768] == ids_cuda).all()), 'prompt preserved')
    _check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
           'tokens in the vocabulary')

    model.generate(ids_cuda[:, :64], max_new_tokens=128)
    torch.cuda.synchronize()
    _check(fa.flash_fwd_cuda.launches == launches,
           '64-token prompts launched the flash kernel')

    # one generate call varies by a fifth from call to call on the host's
    # clock, so the decode rate is taken from the median of three
    total_s = [total_s]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids_cuda, max_new_tokens=128)
        torch.cuda.synchronize()
        total_s.append(time.perf_counter() - t0)
    calls_ms = ['%.1f' % (x * 1e3) for x in total_s]
    total_s = sorted(total_s)[1]
    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids_cuda, max_new_tokens=1)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    prefill_s = sorted(prefill_s)[1]
    decode_tps = 8 * 127 / max(total_s - prefill_s, 1e-9)
    print('slice bf16: generate 8 x 768 + 128 new in %.1f ms (median of '
          '%s), prefill %.2f ms, decode %.1f tokens/s, peak memory %.2f GiB, '
          'flash launches %d, bf16 vs f32 last logits %.3g of range'
          % (total_s * 1e3, ', '.join(calls_ms), prefill_s * 1e3, decode_tps,
             peak / 2 ** 30, launches, rel), flush=True)

    for label, new in (('prefill', 1), ('prefill + 32 decode steps', 33)):
        wall, dev, top, ops = _profile(
            lambda: model.generate(ids_cuda, max_new_tokens=new))
        print('profile %s: wall %.2f ms, device kernels %.2f ms, busy '
              'share %.3f; top kernels: %s; top aten ops: %s'
              % (label, wall, dev, dev / wall,
                 '; '.join('%s %.2f ms x%d' % t for t in top),
                 '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)
    return launches


def _wrappers(fa):
    return {'flash_fwd': fa.flash_fwd_cuda,
            'flash_bwd_fused': fa.flash_bwd_fused_cuda,
            'flash_bwd_dq': fa.flash_bwd_dq_cuda,
            'flash_bwd_dkv': fa.flash_bwd_dkv_cuda,
            'flash_fwd_long': fa.flash_fwd_long_cuda,
            'flash_bwd_dq_long': fa.flash_bwd_dq_long_cuda,
            'flash_bwd_dkv_long': fa.flash_bwd_dkv_long_cuda}


def _reset_counts(fa):
    for wrapper in _wrappers(fa).values():
        wrapper.launches = 0
    for key in fa.counts:
        fa.counts[key] = 0


def _launches(fa):
    out = {name: w.launches for name, w in _wrappers(fa).items()}
    out['rejected'] = fa.counts['rejected']
    return out


def _want(steps, **per_step):
    """The launch counts of `steps` steps: per_step[name] a step for the
    kernels named, none of the others, none rejected."""
    from paddle_tpu_torch.ops import flash_attention as fa

    out = {name: steps * per_step.get(name, 0) for name in _wrappers(fa)}
    out['rejected'] = 0
    return out


# the bench's training configuration (bench.py), at full width and depth
BENCH_CFG = dict(vocab_size=30528, hidden_size=768, num_layers=12,
                 num_heads=12, max_position_embeddings=512, dropout=0.0,
                 fused_loss=True)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 32, 512, 1e-4


def _train_setup(cfg, device, seed, batch, seq, dtype=None):
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(cfg, device=device, seed=seed)
    if dtype is not None:
        model.to(dtype)
    step = TrainStep(model, model.loss,
                     AdamW(learning_rate=TRAIN_LR,
                           parameters=model.parameters()))
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    return model, step, ids.to(device), labels.to(device)


def train_f32_phase():
    """One AdamW step of the bench's GPT cut to 2 layers on the card and on
    the CPU plain path, from the same weights."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**dict(BENCH_CFG, num_layers=2))
    t0 = time.time()
    model, step, ids, labels = _train_setup(cfg, 'cuda', SEED, 2, TRAIN_SEQ)
    cpu, cpu_step, _, _ = _train_setup(cfg, 'cpu', SEED + 1, 2, TRAIN_SEQ)
    cpu.load_state_dict(model.state_dict())
    _reset_counts(fa)
    loss = step(ids, labels).item()
    torch.cuda.synchronize()
    launches = _launches(fa)
    loss_cpu = cpu_step(ids.cpu(), labels.cpu()).item()
    _check(launches == _want(1, flash_fwd=2, flash_bwd_fused=2),
           'f32 step launches %s, want 2 forward and 2 fused backward'
           % launches)
    # f32 products on both sides (TF32 off), summed in another order: the
    # loss to 1e-5 of itself
    rel = abs(loss - loss_cpu) / abs(loss_cpu)
    _check(rel <= 1e-5, 'f32 loss %.7f vs CPU %.7f' % (loss, loss_cpu))
    # Adam moves each parameter by ~lr whatever the size of its gradient;
    # where the exact gradient is 0 (the key third of each qkv bias) the
    # sign of f32 noise decides, so entries may differ by up to 2 lr. All
    # others agree to f32 rounding of the update.
    worst, close, total = 0.0, 0, 0
    cpu_state = cpu.state_dict()
    for name, p in model.state_dict().items():
        diff = (p.cpu() - cpu_state[name]).abs()
        worst = max(worst, diff.max().item())
        close += int((diff <= 1e-6 + 1e-4 * cpu_state[name].abs()).sum())
        total += diff.numel()
    _check(worst <= 2 * TRAIN_LR + 1e-6,
           'f32 params after the step differ by %.3g > 2 lr' % worst)
    _check(close >= 0.999 * total,
           'f32 params: only %d of %d close to the CPU step' % (close, total))
    print('train f32: 2 layers, batch 2 x %d, loss %.7f vs CPU %.7f '
          '(rel %.3g, tol 1e-5), params after the step max abs diff %.3g '
          '(tol 2 lr), %d of %d within 1e-6 + 1e-4 |p|, launches %s, '
          '%.1f s' % (TRAIN_SEQ, loss, loss_cpu, rel, worst, close, total,
                      launches, time.time() - t0), flush=True)
    del model, step, cpu, cpu_step
    torch.cuda.empty_cache()


def _stage_memory(step, ids, labels):
    """One more step of `step` (no remat) read by stage: the device memory
    resident at its start, and for the forward, the loss with the backward,
    and the update, the peak within the stage and what stays resident at
    its end, in GiB."""
    gib = 2.0 ** 30
    out = {}

    def mark(stage):
        torch.cuda.synchronize()
        out[stage] = (torch.cuda.max_memory_allocated() / gib,
                      torch.cuda.memory_allocated() / gib)
        torch.cuda.reset_peak_memory_stats()

    loss_and_grads = step._loss_and_grads

    def staged(*args):
        result = loss_and_grads(*args)
        mark('loss+backward')
        return result

    hook = step.model.register_forward_hook(lambda *_: mark('forward'))
    step._loss_and_grads = staged
    try:
        torch.cuda.synchronize()
        out['start'] = torch.cuda.memory_allocated() / gib
        torch.cuda.reset_peak_memory_stats()
        step(ids, labels)
        mark('update')
    finally:
        hook.remove()
        del step._loss_and_grads
    return out


def _stage_text(stages):
    return 'start %.2f, %s' % (stages['start'], ', '.join(
        '%s peak %.2f (end %.2f)' % ((k,) + stages[k])
        for k in ('forward', 'loss+backward', 'update')))


def _collect_garbage():
    """Free the cyclic garbage earlier phases left: (GiB of device memory
    allocated before, after, the CUDA tensors' GiB among the garbage, and
    the most common types of the garbage objects)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        gc.collect()
        storages = {}
        for obj in gc.garbage:
            # a weak proxy among the garbage may outlive its referent
            if isinstance(obj, (weakref.ProxyType, weakref.CallableProxyType)):
                continue
            if torch.is_tensor(obj) and obj.is_cuda:
                st = obj.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        kinds = collections.Counter(type(o).__name__ for o in gc.garbage)
    finally:
        gc.set_debug(0)
        del gc.garbage[:]
    gc.collect()
    torch.cuda.synchronize()
    return (before / 2 ** 30, torch.cuda.memory_allocated() / 2 ** 30,
            sum(storages.values()) / 2 ** 30, kinds.most_common(6))


def train_main_phase(sku):
    """The main path: the bench's training step on the card."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(**BENCH_CFG)
    # the peak below is this step's own: the serving phases before it
    # leave device tensors in reference cycles that no collection has
    # reached yet
    before, after, garbage, kinds = _collect_garbage()
    print('train bf16: device memory allocated %.2f GiB before a garbage '
          'collection, %.2f after (%.2f GiB of CUDA tensors among the '
          'garbage; most common garbage types %s)'
          % (before, after, garbage, kinds), flush=True)
    model, step, ids, labels = _train_setup(
        cfg, 'cuda', SEED, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)
    losses = [step(ids, labels).item() for _ in range(2)]  # warm-up
    steps = 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = _launches(fa)
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    _check(launches == _want(steps, flash_fwd=layers,
                             flash_bwd_fused=layers),
           'main path launches %s over %d steps, want %d forward and %d '
           'fused backward a step' % (launches, steps, layers, layers))
    _check(all(math.isfinite(x) for x in losses), 'losses finite')
    _check(losses[-1] < losses[0],
           'loss %.4f after %d steps not below the first %.4f'
           % (losses[-1], len(losses), losses[0]))
    median = sorted(step_ms)[steps // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops_tok = model.flops_per_token(TRAIN_SEQ)
    peak_flops = sku[2]['bfloat16']
    mfu = flops_tok * tokens / (median / 1e3) / peak_flops
    print('train bf16 (main path): %d params, batch %d x %d, median step '
          '%.2f ms (min %.2f, max %.2f), %.1f samples/s, %.0f tokens/s, '
          '%.1f MFLOP/token, MFU %.4f of %.0f TFLOP/s (least step at peak '
          '%.2f ms), peak memory %.2f GiB, launches over %d steps %s, '
          'losses %s' % (model.num_params(), TRAIN_BATCH, TRAIN_SEQ, median,
                         min(step_ms), max(step_ms), TRAIN_BATCH / median
                         * 1e3, tokens / median * 1e3, flops_tok / 1e6, mfu,
                         peak_flops / 1e12, flops_tok * tokens / peak_flops
                         * 1e3, peak / 2 ** 30, steps, launches,
                         ['%.4f' % x for x in losses]), flush=True)
    wall, dev, top, ops = _profile(lambda: step(ids, labels))
    print('profile train step: wall %.2f ms, device kernels %.2f ms, busy '
          'share %.3f; top kernels: %s; top aten ops: %s'
          % (wall, dev, dev / wall,
             '; '.join('%s %.2f ms x%d' % t for t in top),
             '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)
    stages = _stage_memory(step, ids, labels)
    print('memory by stage, train bf16 (GiB): %s' % _stage_text(stages),
          flush=True)

    # The fused/two-pass threshold (512) is the TPU's tuning. For its
    # re-measurement on this card: the same step with the two-pass
    # backward, after the main path's launches were read.
    fused_max, fa.FUSED_BWD_MAX_SEQ = fa.FUSED_BWD_MAX_SEQ, 0
    try:
        _reset_counts(fa)
        two_pass_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ids, labels).item()
            two_pass_ms.append((time.perf_counter() - t0) * 1e3)
        _check(fa.flash_bwd_dq_cuda.launches == 5 * layers,
               'two-pass variant did not take the two-pass kernels')
    finally:
        fa.FUSED_BWD_MAX_SEQ = fused_max
    print('train bf16 with the two-pass backward at seq 512: median step '
          '%.2f ms (fused route above: %.2f ms)'
          % (sorted(two_pass_ms)[2], median), flush=True)
    del model, step
    torch.cuda.empty_cache()
    return {'launches': launches, 'steps': steps, 'median_ms': median,
            'peak': peak, 'busy': dev / wall, 'stages': stages}


def train_seq1024_phase():
    """GPT-2 small training at 1024 tokens: the two-pass backward."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024, dropout=0.0,
                    fused_loss=True)
    model, step, ids, labels = _train_setup(cfg, 'cuda', SEED, 8, 1024,
                                            torch.bfloat16)
    steps = 2
    torch.cuda.synchronize()
    _reset_counts(fa)
    t0 = time.perf_counter()
    losses = [step(ids, labels).item() for _ in range(steps)]
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches(fa)
    layers = cfg.num_layers
    _check(launches == _want(steps, flash_fwd=layers,
                             flash_bwd_dq=layers, flash_bwd_dkv=layers),
           'seq-1024 launches %s over %d steps, want %d forward, dq and dk/dv '
           'a step' % (launches, steps, layers))
    _check(all(math.isfinite(x) for x in losses), 'seq-1024 losses finite')
    print('train seq 1024 (two-pass path): GPT-2 small, batch 8 x 1024, '
          'bf16, %d steps in %.1f ms (first includes warm-up), losses %s, '
          'launches %s' % (steps, total_ms, ['%.4f' % x for x in losses],
                           launches), flush=True)
    del model, step
    torch.cuda.empty_cache()
    return {'launches': launches, 'steps': steps}


# ---- slice 7: training as users configure it --------------------------------

# GPT-3 small's optimiser (Brown et al. 2020, Appendix B) on the bench's
# model: AdamW (0.9, 0.95), eps 1e-8, weight decay 0.1 off biases and norms,
# global-norm clip 1.0, a linear warm-up into a cosine decay to a tenth
RECIPE_LR = 6e-4
RECIPE_WARMUP = 2


def _recipe_decays(name):
    return name.endswith('.weight') and '.ln_' not in name and \
        not name.startswith('gpt.ln_f')


def _recipe_optimizer(model, total_updates):
    from paddle_tpu_torch import nn, optimizer

    sched = optimizer.lr.LinearWarmup(
        optimizer.lr.CosineAnnealingDecay(
            RECIPE_LR, max(total_updates - RECIPE_WARMUP, 1),
            eta_min=RECIPE_LR / 10), RECIPE_WARMUP, 0.0, RECIPE_LR)
    opt = optimizer.AdamW(sched, beta1=0.9, beta2=0.95, epsilon=1e-8,
                          weight_decay=0.1,
                          apply_decay_param_fun=_recipe_decays,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0),
                          parameters=model.named_parameters())
    return opt, sched


def _recipe_setup(cfg, device, seed, batch, seq, total_updates, **step_kw):
    """The bench's GPT with f32 parameters, the recipe's optimizer and a
    TrainStep with `step_kw`; a fixed seeded batch."""
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(cfg, device=device, seed=seed)
    opt, sched = _recipe_optimizer(model, total_updates)
    step = TrainStep(model, model.loss, opt, **step_kw)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    return model, step, sched, ids.to(device), labels.to(device)


def recipe_parity_phase():
    """17a: the recipe in f32 with remat and k_steps=2, 3 updates, on the
    card and on the CPU plain path from the same weights."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(**dict(BENCH_CFG, num_layers=2))
    t0 = time.time()
    kw = dict(remat=True, k_steps=2)
    model, step, sched, ids, labels = _recipe_setup(
        cfg, 'cuda', SEED, 2, TRAIN_SEQ, 3, **kw)
    cpu, cpu_step, cpu_sched, _, _ = _recipe_setup(
        cfg, 'cpu', SEED + 1, 2, TRAIN_SEQ, 3, **kw)
    cpu.load_state_dict(model.state_dict())
    micro = 6
    _reset_counts(fa)
    losses = []
    for i in range(micro):
        losses.append(step(ids, labels).item())
        if i % 2:
            sched.step()
    torch.cuda.synchronize()
    launches = _launches(fa)
    cpu_losses = []
    for i in range(micro):
        cpu_losses.append(cpu_step(ids.cpu(), labels.cpu()).item())
        if i % 2:
            cpu_sched.step()
    _check(launches == _want(micro, flash_fwd=4, flash_bwd_fused=2),
           'recipe f32 launches %s over %d micro-steps, want 4 forward '
           '(remat: 2 a layer) and 2 fused backward each' % (launches, micro))
    _check(step.optimizer._step_count == 3 == cpu_step.optimizer._step_count,
           'recipe f32: %d updates, want 3' % step.optimizer._step_count)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    _check(rel <= 1e-5, 'recipe f32 losses %s vs CPU %s' % (losses,
                                                            cpu_losses))
    # as phase 5: within 2 lr an update of the CPU, nearly all within f32
    # rounding
    worst, close, total = 0.0, 0, 0
    cpu_state = cpu.state_dict()
    for name, p in model.state_dict().items():
        diff = (p.cpu() - cpu_state[name]).abs()
        worst = max(worst, diff.max().item())
        close += int((diff <= 1e-6 + 1e-4 * cpu_state[name].abs()).sum())
        total += diff.numel()
    _check(worst <= 2 * RECIPE_LR * 3 + 1e-6,
           'recipe f32 params differ by %.3g > 2 lr an update' % worst)
    _check(close >= 0.999 * total,
           'recipe f32 params: only %d of %d close to the CPU' % (close,
                                                                  total))
    print('slice 7 (a) recipe f32 parity: 2 layers, batch 2 x %d, remat, '
          'k_steps 2, %d micro-steps / 3 updates, losses %s vs CPU %s '
          '(max rel %.3g, tol 1e-5), params max abs diff %.3g (tol 2 lr an '
          'update), %d of %d within 1e-6 + 1e-4 |p|, launches %s, %.1f s'
          % (TRAIN_SEQ, micro, ['%.6f' % x for x in losses],
             ['%.6f' % x for x in cpu_losses], rel, worst, close, total,
             launches, time.time() - t0), flush=True)
    del model, step, cpu, cpu_step
    torch.cuda.empty_cache()
    return {'launches': launches, 'steps': micro}


def _timed_steps(step, sched, ids, labels, warmup, steps):
    """(losses, step ms, peak bytes) of warm-up + timed steps, the
    scheduler stepped after each."""
    losses = []
    for _ in range(warmup):
        losses.append(step(ids, labels).item())
        sched.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        sched.step()
    return losses, step_ms, torch.cuda.max_memory_allocated()


def recipe_train_phase(sku, main):
    """17b-c: the recipe at full width with bf16 AMP (f32 master
    parameters); then with whole-step remat and with per-block recompute."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    layers = BENCH_CFG['num_layers']
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {}
    for label, cfg_kw, step_kw, warmup, steps in (
            ('recipe', {}, {}, 2, 10),
            ('remat', {}, {'remat': True}, 1, 5),
            ('recompute', {'recompute': True}, {}, 1, 5)):
        cfg = GPTConfig(**dict(BENCH_CFG, **cfg_kw))
        model, step, sched, ids, labels = _recipe_setup(
            cfg, 'cuda', SEED, TRAIN_BATCH, TRAIN_SEQ, warmup + steps,
            amp_dtype='bfloat16', **step_kw)
        seen = set()
        undo = _kernel_dtypes(fa, seen)
        _reset_counts(fa)
        try:
            losses, step_ms, peak = _timed_steps(step, sched, ids, labels,
                                                 warmup, steps)
        finally:
            undo()
        launches = _launches(fa)
        _check(seen == {('flash_fwd', 'bfloat16'),
                        ('flash_bwd_fused', 'bfloat16')},
               '%s attention kernels launched %s, want the bf16 ones'
               % (label, sorted(seen)))
        fwd = 2 * layers if label != 'recipe' else layers
        _check(launches == _want(warmup + steps, flash_fwd=fwd,
                                 flash_bwd_fused=layers),
               '%s launches %s over %d steps, want %d forward and %d fused '
               'backward a step' % (label, launches, warmup + steps, fwd,
                                    layers))
        _check(all(math.isfinite(x) for x in losses), label + ' finite')
        _check(losses[-1] < losses[1],
               '%s loss %.4f not below the first trained step %.4f'
               % (label, losses[-1], losses[1]))
        median = sorted(step_ms)[steps // 2]
        flops_tok = model.flops_per_token(TRAIN_SEQ)
        mfu = flops_tok * tokens / (median / 1e3) / sku[2]['bfloat16']
        print('slice 7 (%s) %s: f32 master, bf16 AMP, AdamW + warm-up/'
              'cosine + clip 1.0, batch %d x %d, median step %.2f ms (min '
              '%.2f, max %.2f), %.0f tokens/s, MFU %.4f, peak memory %.2f '
              'GiB; phase 6 (bf16 parameters, no recipe): %.2f ms, %.2f '
              'GiB; launches over %d steps %s; losses %s'
              % ('b' if label == 'recipe' else 'c', label, TRAIN_BATCH,
                 TRAIN_SEQ, median, min(step_ms), max(step_ms),
                 tokens / median * 1e3, mfu, peak / 2 ** 30,
                 main['median_ms'], main['peak'] / 2 ** 30, warmup + steps,
                 launches, ['%.4f' % x for x in losses]), flush=True)
        out[label] = {'median_ms': median, 'mfu': mfu, 'peak': peak,
                      'launches': launches, 'steps': warmup + steps}
        if label == 'recipe':
            wall, dev, top, ops = _profile(lambda: step(ids, labels))
            print('profile recipe step: wall %.2f ms, device kernels %.2f '
                  'ms, busy share %.3f (phase 6 in this run: %.3f); top '
                  'kernels: %s; top aten ops: %s'
                  % (wall, dev, dev / wall, main['busy'],
                     '; '.join('%s %.2f ms x%d' % t for t in top),
                     '; '.join('%s %.2f ms x%d' % t for t in ops)),
                  flush=True)
            stages = _stage_memory(step, ids, labels)
            print('memory by stage, recipe (GiB): %s; phase 6: %s'
                  % (_stage_text(stages), _stage_text(main['stages'])),
                  flush=True)
        del model, step
        torch.cuda.empty_cache()
    return out


FP16_INIT_SCALE = 2.0 ** 32


def recipe_fp16_phase():
    """17d: the recipe with fp16 AMP and dynamic loss scaling from 2^32.
    The fp16 loss's own cotangent (the scale) overflows fp16 from 2^16 up,
    so the first steps skip: the scale halves, the parameters and the step
    count stay; then the steps train, through the fp16 kernels."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(**BENCH_CFG)
    layers = cfg.num_layers
    steps = 24
    model, step, sched, ids, labels = _recipe_setup(
        cfg, 'cuda', SEED, TRAIN_BATCH, TRAIN_SEQ, steps,
        amp_dtype='float16', init_loss_scaling=FP16_INIT_SCALE)
    probe = model.gpt.h[0].attn.qkv_proj.weight
    seen = set()
    undo = _kernel_dtypes(fa, seen)
    _reset_counts(fa)
    trace = []
    t0 = time.time()
    try:
        for _ in range(steps):
            before = probe.detach().clone()
            count = step.optimizer._step_count
            loss = step(ids, labels).item()
            skipped = step.optimizer._step_count == count
            if skipped:
                _check(torch.equal(probe, before), 'a skipped step moved a '
                       'parameter')
            else:
                sched.step()
            trace.append((step.loss_scale, skipped, loss))
        torch.cuda.synchronize()
    finally:
        undo()
    launches = _launches(fa)
    _check(seen == {('flash_fwd', 'float16'),
                    ('flash_bwd_fused', 'float16')},
           'fp16 attention kernels launched %s, want the fp16 ones'
           % sorted(seen))
    _check(launches == _want(steps, flash_fwd=layers,
                             flash_bwd_fused=layers),
           'fp16 launches %s over %d steps, want %d forward and %d fused '
           'backward a step' % (launches, steps, layers, layers))
    skips = sum(1 for _, s, _ in trace if s)
    _check(trace[0][1] and trace[0][0] == FP16_INIT_SCALE / 2,
           'the first fp16 step at 2^32 did not skip and halve the scale')
    _check(all(s for _, s, _ in trace[:skips]) and skips < steps - 3,
           'fp16: skipped steps %d of %d, want a run of skips then '
           'training' % (skips, steps))
    trained = [l for _, s, l in trace if not s]
    _check(all(math.isfinite(x) for x in trained) and
           trained[-1] < trained[0],
           'fp16 trained losses %s not falling' % trained)
    _check(step.optimizer._step_count == steps - skips,
           'fp16 step count %d, want %d' % (step.optimizer._step_count,
                                            steps - skips))
    print('slice 7 (d) fp16 AMP + loss scaling from 2^32: %d of %d steps '
          'skipped (scale halved each, parameters and step count kept), '
          'scale now 2^%d, %d updates, losses of trained steps %s, '
          'launches %s (fp16 kernels), %.1f s'
          % (skips, steps, int(math.log2(step.loss_scale)), steps - skips,
             ['%.4f' % x for x in trained], launches, time.time() - t0),
          flush=True)
    del model, step
    torch.cuda.empty_cache()
    return {'launches': launches, 'steps': steps, 'skips': skips}


def _kernel_dtypes(fa, seen):
    """Wrap the flash module's forward and backward launch helpers so each
    launch adds (entry, operand dtype) to `seen`; returns the undo."""
    fwd, bwd = fa._fwd_launch, fa._bwd_launch

    def fwd_seen(entry, q, *rest):
        seen.add((entry, str(q.dtype).split('.')[-1]))
        return fwd(entry, q, *rest)

    def bwd_seen(entry, operands, *rest):
        seen.add((entry, str(operands[0].dtype).split('.')[-1]))
        return bwd(entry, operands, *rest)

    fa._fwd_launch, fa._bwd_launch = fwd_seen, bwd_seen

    def undo():
        fa._fwd_launch, fa._bwd_launch = fwd, bwd
    return undo


def eager_amp_phase():
    """17e: the eager loop at full width, with the recipe's optimizer:
    auto_cast O1 bf16 (attention, norms and the loss in f32: the f32
    kernels), then O2 fp16 with a GradScaler."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**BENCH_CFG)
    layers = cfg.num_layers
    gen = torch.Generator().manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=gen).cuda()
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen).cuda()
    out = {}
    for level, dtype, steps, scale in (('O1', 'bfloat16', 3, None),
                                       ('O2', 'float16', 6, 2.0 ** 17)):
        model = GPTForCausalLM(cfg, device='cuda', seed=SEED)
        model.train()
        opt, sched = _recipe_optimizer(model, steps)
        sched.step()  # past the warm-up's zero rate
        scaler = amp.GradScaler(init_loss_scaling=scale) if scale else None
        seen = set()
        undo = _kernel_dtypes(fa, seen)
        _reset_counts(fa)
        losses, skipped, step_ms = [], [], []

        def step():
            with amp.auto_cast(level=level, dtype=dtype):
                loss = model.loss(model(ids), labels)
            if scaler is None:
                loss.backward()
                opt.step()
                skipped.append(False)
            else:
                scaler.scale(loss).backward()
                scaler.step(opt)
                skipped.append(scaler._found_inf)
                scaler.update()
            opt.clear_grad(set_to_zero=False)
            sched.step()
            losses.append(loss.item())

        try:
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                step_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            undo()
        launches = _launches(fa)
        want_dtype = 'float32' if level == 'O1' else 'float16'
        want_seen = {('flash_fwd', want_dtype),
                     ('flash_bwd_fused', want_dtype)}
        _check(seen == want_seen, '%s attention kernels launched %s, want '
               '%s' % (level, sorted(seen), sorted(want_seen)))
        _check(launches == _want(steps, flash_fwd=layers,
                                 flash_bwd_fused=layers),
               'eager %s launches %s over %d steps' % (level, launches,
                                                        steps))
        trained = [l for l, s in zip(losses, skipped) if not s]
        _check(all(math.isfinite(x) for x in trained) and len(trained) >= 2
               and trained[-1] < trained[0],
               'eager %s trained losses %s not falling' % (level, trained))
        print('slice 7 (e) eager %s %s: auto_cast, %s, recipe optimizer, '
              'batch %d x %d, %d steps (%d skipped), step ms %s, losses %s, '
              'attention kernels %s, launches %s'
              % (level, dtype, 'GradScaler from 2^%d' % math.log2(scale)
                 if scale else 'no scaler', TRAIN_BATCH, TRAIN_SEQ, steps,
                 sum(skipped), ['%.1f' % x for x in step_ms],
                 ['%.4f' % x for x in losses], sorted(seen), launches),
              flush=True)
        busy = None
        if level == 'O1':
            # two more steps: one timed alone, one under the profiler (the
            # card's busy share of the step and where its time goes)
            wall_ms, device_ms, top, _ = _profile(step)
            busy = {'wall_ms': wall_ms, 'device_ms': device_ms,
                    'busy': device_ms / wall_ms,
                    'top': [(k, round(ms, 3), n) for k, ms, n in top]}
            print('slice 7 (e) eager O1 profiled step: %.1f ms wall, %.1f ms '
                  'device (busy %.2f); top kernels %s'
                  % (wall_ms, device_ms, device_ms / wall_ms, busy['top']),
                  flush=True)
        out[level] = {'launches': launches, 'steps': steps,
                      'median_ms': sorted(step_ms)[steps // 2],
                      'profile': busy}
        del model, opt
        torch.cuda.empty_cache()
    return out


def slice7_phases(sku, main):
    """Phase 17, under the flash strict mode: a shape no kernel takes
    raises instead of running the plain attention."""
    prev = os.environ.get('PADDLE_TPU_FLASH_STRICT')
    os.environ['PADDLE_TPU_FLASH_STRICT'] = '1'
    try:
        out = {'parity': recipe_parity_phase()}
        out.update(recipe_train_phase(sku, main))
        out['fp16'] = recipe_fp16_phase()
        out['eager'] = eager_amp_phase()
        return out
    finally:
        if prev is None:
            del os.environ['PADDLE_TPU_FLASH_STRICT']
        else:
            os.environ['PADDLE_TPU_FLASH_STRICT'] = prev


# Slice 9: the training shell. The sample pool: seeded numpy token rows of
# TRAIN_SEQ + 1 tokens, split into ids and next-token labels; one epoch of
# (a)'s fit at batch TRAIN_BATCH.
SLICE9_FIT_ITERS = 24
SLICE9_SAMPLES = SLICE9_FIT_ITERS * TRAIN_BATCH
SLICE9_EVAL_BATCHES = 4
RESUME_BATCH, RESUME_ITERS, RESUME_KILL_AT, RESUME_EVERY = 4, 12, 7, 4
PREEMPT_AT = 6
INGEST_WINDOW, INGEST_ITERS = 64, 8


def _slice9_pool(vocab):
    import numpy as np

    rng = np.random.RandomState(SEED + 9)
    toks = rng.randint(0, vocab, (SLICE9_SAMPLES, TRAIN_SEQ + 1))
    return toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)


def _shell_model(cfg, seed, dtype=None):
    """A Model over a fresh GPT on the card, prepared with AdamW at the
    bench's rate and the model's own (fused) loss."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    net = GPTForCausalLM(cfg, device='cuda', seed=seed)
    if dtype is not None:
        net.to(dtype)
    model = Model(net)
    model.prepare(AdamW(learning_rate=TRAIN_LR, parameters=net.parameters()),
                  loss=net.loss)
    return model


def _shell_callbacks():
    """A callback class recording each step's loss and launch counts (read,
    never reset, so the counts of the whole run stay intact), and one that
    raises KeyboardInterrupt (a hard kill) or sends a preemption notice
    after the step named."""
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.ops import flash_attention as fa

    class Record(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.launches = [], [_launches(fa)]

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs['loss'][0]))
            self.launches.append(_launches(fa))

        def per_step(self):
            return [{k: b[k] - a[k] for k in a}
                    for a, b in zip(self.launches, self.launches[1:])]

    class After(Callback):
        def __init__(self, at, action):
            super().__init__()
            self.at, self.action, self.seen = at, action, 0

        def on_train_batch_end(self, step, logs=None):
            self.seen += 1
            if self.seen == self.at:
                self.action()

    return Record, After


def _split(tl):
    s = tl.summary()
    return {p: s[p]['p50'] * 1e3 for p in
            ('data_wait', 'host_dispatch', 'device_block', 'total')
            if p in s}


def shell_fit_phase(card, main, pool):
    """(a) Model.fit over the bench's GPT with a DataLoader of 2 workers,
    then evaluate() with Accuracy; the fit step beside phase 6's bare
    TrainStep step."""
    from paddle_tpu_torch import io, metric
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(**BENCH_CFG)
    layers = cfg.num_layers
    t0 = time.time()
    ids, labels = pool
    dataset = io.TensorDataset([torch.from_numpy(ids),
                                torch.from_numpy(labels)])
    model = _shell_model(cfg, SEED, torch.bfloat16)
    Record, _ = _shell_callbacks()
    rec = Record()
    loader = io.DataLoader(dataset, batch_size=TRAIN_BATCH, shuffle=True,
                           num_workers=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    rec.launches = [_launches(fa)]
    model.fit(loader, epochs=1, num_iters=SLICE9_FIT_ITERS, verbose=0,
              callbacks=[rec])
    torch.cuda.synchronize()
    launches = _launches(fa)
    peak = torch.cuda.max_memory_allocated()
    steps = len(rec.losses)
    _check(steps == SLICE9_FIT_ITERS, 'fit ran %d steps, want %d'
           % (steps, SLICE9_FIT_ITERS))
    _check(launches == _want(steps, flash_fwd=layers,
                             flash_bwd_fused=layers),
           'fit launches %s over %d steps, want %d forward and %d fused '
           'backward a step' % (launches, steps, layers, layers))
    want_step = _want(1, flash_fwd=layers, flash_bwd_fused=layers)
    _check(all(d == want_step for d in rec.per_step()),
           'fit launches by step %s' % rec.per_step())
    _check(all(math.isfinite(x) for x in rec.losses), 'fit losses finite')
    split = _split(model.last_timeline)
    median = split['total']
    bare = main['median_ms']
    print('slice 9 (a) fit [%s]: bench GPT bf16, DataLoader batch %d x %d, '
          'shuffle, 2 workers, %d steps in 1 epoch: fit step p50 %.2f ms (data_wait '
          '%.2f, host_dispatch %.2f, device_block %.2f ms p50) against '
          'phase 6\'s bare TrainStep %.2f ms: the loop\'s host cost %.2f ms '
          '(%.1f %%); peak memory %.2f GiB; launches %s; losses %s; %.1f s'
          % (card, TRAIN_BATCH, TRAIN_SEQ, steps, median,
             split['data_wait'], split['host_dispatch'],
             split['device_block'], bare, median - bare,
             100 * (median - bare) / bare, peak / 2 ** 30, launches,
             ['%.4f' % x for x in rec.losses[::6]], time.time() - t0),
          flush=True)
    batch = next(iter(io.DataLoader(dataset, batch_size=TRAIN_BATCH)))
    wall, dev, top, _ = _profile(lambda: model.train_batch([batch[0]],
                                                           [batch[1]]))
    print('slice 9 (a) profile of one fit step [%s]: wall %.2f ms, device '
          'kernels %.2f ms, busy share %.3f; top kernels: %s'
          % (card, wall, dev, dev / wall,
             '; '.join('%s %.2f ms x%d' % t for t in top)), flush=True)

    # evaluate() on SLICE9_EVAL_BATCHES batches with Accuracy (top 1 and 5)
    n_eval = SLICE9_EVAL_BATCHES * TRAIN_BATCH
    model.prepare(model._optimizer, model.network.loss,
                  metrics=metric.Accuracy(topk=(1, 5)))
    _reset_counts(fa)
    t1 = time.time()
    logs = model.evaluate(io.TensorDataset([torch.from_numpy(ids[:n_eval]),
                                            torch.from_numpy(
                                                labels[:n_eval])]),
                          batch_size=TRAIN_BATCH, verbose=0)
    torch.cuda.synchronize()
    eval_launches = _launches(fa)
    _check(eval_launches == _want(SLICE9_EVAL_BATCHES, flash_fwd=layers),
           'evaluate launches %s over %d batches, want %d forward a batch'
           % (eval_launches, SLICE9_EVAL_BATCHES, layers))
    _check(math.isfinite(logs['loss']), 'evaluate loss finite')
    _check(0 <= logs['acc_top1'] <= logs['acc_top5'],
           'accuracy %s' % logs)
    print('slice 9 (a) evaluate [%s]: %d batches, loss %.4f, acc_top1 %.6f, '
          'acc_top5 %.6f (correct tokens over samples, the JAX package\'s '
          'count), launches %s, %.2f s'
          % (card, SLICE9_EVAL_BATCHES, logs['loss'], logs['acc_top1'],
             logs['acc_top5'], eval_launches, time.time() - t1), flush=True)
    return model, {'launches': launches, 'steps': steps, 'median_ms': median,
                   'split': split, 'bare_ms': bare, 'peak': peak,
                   'busy': dev / wall, 'eval_launches': eval_launches}


def _resume_cfg():
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    return GPTConfig(**dict(BENCH_CFG, num_layers=2))


def _params_equal(a, b):
    """Names of the parameters whose values differ, with the largest
    difference of each."""
    out = {}
    for (name, x), y in zip(a.network.state_dict().items(),
                            b.network.state_dict().values()):
        if not torch.equal(x, y):
            out[name] = (x.float() - y.float()).abs().max().item()
    return out


def shell_resume_phase(card, pool):
    """(b) f32, 2 layers at full width: an uninterrupted fit against the
    same fit killed after step RESUME_KILL_AT under a TrainingSupervisor
    and resumed in a fresh Model after a wrong np.random.seed, and against
    one preempted through PreemptionWatcher.request() and resumed."""
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch import io
    from paddle_tpu_torch.distributed.supervisor import (PreemptionWatcher,
                                                         TrainingSupervisor)
    from paddle_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _resume_cfg()
    ids, labels = pool
    Record, After = _shell_callbacks()

    class Tracked(io.Dataset):
        def __init__(self):
            self.accessed = []

        def __len__(self):
            return len(ids)

        def __getitem__(self, i):
            self.accessed.append(int(i))
            return ids[i], labels[i]

    def fit(model, data, **kw):
        model.fit(data, batch_size=RESUME_BATCH, epochs=1, shuffle=True,
                  num_iters=RESUME_ITERS, verbose=0, **kw)

    t0 = time.time()
    root = tempfile.mkdtemp(prefix='slice9_')
    try:
        np.random.seed(SEED)
        ref, ref_data, ref_rec = _shell_model(cfg, SEED + 1), Tracked(), \
            Record()
        _reset_counts(fa)
        ref_rec.launches = [_launches(fa)]
        fit(ref, ref_data, callbacks=[ref_rec])
        torch.cuda.synchronize()
        layers = cfg.num_layers
        _check(_launches(fa) == _want(RESUME_ITERS, flash_fwd=layers,
                                      flash_bwd_fused=layers),
               'resume reference launches %s' % _launches(fa))

        kill_dir = os.path.join(root, 'kill')
        np.random.seed(SEED)
        killed = _shell_model(cfg, SEED + 1)
        sup = TrainingSupervisor(kill_dir, save_every_steps=RESUME_EVERY)

        def kill():
            raise KeyboardInterrupt('slice 9: kill after step %d'
                                    % RESUME_KILL_AT)
        try:
            fit(killed, Tracked(), supervisor=sup,
                callbacks=[After(RESUME_KILL_AT, kill)])
            _check(False, 'the killed fit ran to its end')
        except KeyboardInterrupt:
            pass
        saved = sup.last_saved_step
        _check(saved == RESUME_KILL_AT // RESUME_EVERY * RESUME_EVERY,
               'last checkpoint at step %s' % saved)
        np.random.seed(SEED + 1000)   # the cursor must restore the order
        resumed, data, rec = _shell_model(cfg, SEED + 1), Tracked(), Record()
        fit(resumed, data, callbacks=[rec],
            supervisor=TrainingSupervisor(kill_dir,
                                          save_every_steps=RESUME_EVERY))
        _check(data.accessed == ref_data.accessed,
               'resumed batch order differs from the uninterrupted run')
        _check(rec.losses == ref_rec.losses[saved:],
               'resumed losses %s, uninterrupted %s'
               % (rec.losses, ref_rec.losses[saved:]))
        diff = _params_equal(ref, resumed)
        _check(not diff, 'resumed parameters differ: %s' % diff)

        pre_dir = os.path.join(root, 'preempt')
        watcher = PreemptionWatcher()
        np.random.seed(SEED)
        first = _shell_model(cfg, SEED + 1)
        sup = TrainingSupervisor(pre_dir, watcher=watcher)
        fit(first, Tracked(), supervisor=sup,
            callbacks=[After(PREEMPT_AT, watcher.request)])
        _check(first.stop_training and sup.last_saved_step == PREEMPT_AT,
               'preemption: stop %s, urgent checkpoint at %s'
               % (first.stop_training, sup.last_saved_step))
        np.random.seed(SEED + 2000)
        after, rec2 = _shell_model(cfg, SEED + 1), Record()
        fit(after, Tracked(), callbacks=[rec2],
            supervisor=TrainingSupervisor(pre_dir))
        _check(rec2.losses == ref_rec.losses[PREEMPT_AT:],
               'losses after the preemption %s' % rec2.losses)
        diff = _params_equal(ref, after)
        _check(not diff, 'parameters after the preemption differ: %s'
               % diff)
        print('slice 9 (b) resume [%s]: f32 GPT %d layers at full width, '
              'batch %d x %d, shuffle, %d steps; killed after step %d, '
              'resumed from the step-%d checkpoint after a wrong seed: '
              'batch order equal (%d indices), %d losses and every '
              'parameter bitwise equal to the uninterrupted run; preempted '
              'after step %d (urgent checkpoint, clean stop), resumed: %d '
              'losses and every parameter bitwise equal; %.1f s'
              % (card, layers, RESUME_BATCH, TRAIN_SEQ, RESUME_ITERS,
                 RESUME_KILL_AT, saved, len(data.accessed), len(rec.losses),
                 PREEMPT_AT, len(rec2.losses), time.time() - t0),
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def shell_ingest_phase(card, bench_model, pool):
    """(c) the pool as 4 shards through IngestPipeline (window 64,
    prefetch 2, device_put) into (a)'s model, then killed and resumed
    through the supervisor with the pipeline attached (on (b)'s model)."""
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch import data
    from paddle_tpu_torch.distributed.supervisor import TrainingSupervisor
    from paddle_tpu_torch.ops import flash_attention as fa

    ids, labels = pool
    t0 = time.time()
    root = tempfile.mkdtemp(prefix='slice9_shards_')
    try:
        paths = data.write_shards(list(zip(ids, labels)), root, 4)
        Record, After = _shell_callbacks()
        pipe = data.IngestPipeline(paths, batch_size=TRAIN_BATCH,
                                   shuffle_window=INGEST_WINDOW, seed=SEED,
                                   prefetch=2, device_put=True)
        layers = bench_model.network.config.num_layers
        rec = Record()
        _reset_counts(fa)
        rec.launches = [_launches(fa)]
        bench_model.prepare(bench_model._optimizer,
                            bench_model.network.loss, metrics=[])
        bench_model.fit(pipe, epochs=1, num_iters=INGEST_ITERS, verbose=0,
                        callbacks=[rec])
        torch.cuda.synchronize()
        launches = _launches(fa)
        _check(launches == _want(INGEST_ITERS, flash_fwd=layers,
                                 flash_bwd_fused=layers),
               'pipeline fit launches %s' % launches)
        _check(all(math.isfinite(x) for x in rec.losses),
               'pipeline fit losses finite')
        s = bench_model.last_timeline.summary()
        wait_share = s['data_wait']['mean'] / s['total']['mean']
        split = _split(bench_model.last_timeline)
        print('slice 9 (c) ingest [%s]: %d samples in 4 shards, window %d, '
              'prefetch 2, device_put, batch %d x %d into (a)\'s model, %d '
              'steps: step p50 %.2f ms (data_wait %.3f, host_dispatch '
              '%.2f, device_block %.2f ms p50), data_wait share %.4f of the '
              'step time (mean over the steps, the first step\'s wait for '
              'the pipeline to fill included; %.4f at p50), launches %s'
              % (card, len(ids), INGEST_WINDOW, TRAIN_BATCH, TRAIN_SEQ,
                 len(rec.losses), split['total'], split['data_wait'],
                 split['host_dispatch'], split['device_block'], wait_share,
                 split['data_wait'] / split['total'], launches), flush=True)

        class Tee(data.IngestPipeline):
            """The pipeline, keeping a host copy of every batch it hands
            out."""

            def __iter__(self):
                for batch in super().__iter__():
                    self.seen.append([t.cpu() for t in batch])
                    yield batch

        def run(**kw):
            pipe = Tee(paths, batch_size=RESUME_BATCH,
                       shuffle_window=INGEST_WINDOW, seed=SEED, prefetch=2,
                       device_put=True)
            pipe.seen = []
            sup = kw.pop('supervisor', None)
            if sup is not None:
                sup.attach_pipeline(pipe)
            model = _shell_model(_resume_cfg(), SEED + 2)
            model.fit(pipe, epochs=1, num_iters=RESUME_ITERS, verbose=0,
                      supervisor=sup, **kw)
            return model, pipe

        ref, ref_pipe = run()
        ckpt_dir = os.path.join(root, 'ckpt')
        sup = TrainingSupervisor(ckpt_dir, save_every_steps=RESUME_EVERY)

        def kill():
            raise KeyboardInterrupt('slice 9: kill after step %d'
                                    % RESUME_KILL_AT)
        try:
            run(supervisor=sup, callbacks=[After(RESUME_KILL_AT, kill)])
            _check(False, 'the killed pipeline fit ran to its end')
        except KeyboardInterrupt:
            pass
        saved = sup.last_saved_step
        np.random.seed(SEED + 3000)
        resumed, pipe = run(supervisor=TrainingSupervisor(
            ckpt_dir, save_every_steps=RESUME_EVERY))
        want = ref_pipe.seen[saved:RESUME_ITERS]
        _check(len(pipe.seen) == len(want) and all(
            all(torch.equal(a, b) for a, b in zip(x, y))
            for x, y in zip(pipe.seen, want)),
            'resumed pipeline batches differ from the uninterrupted run')
        diff = _params_equal(ref, resumed)
        _check(not diff, 'pipeline-resumed parameters differ: %s' % diff)
        print('slice 9 (c) ingest resume [%s]: killed after step %d, '
              'resumed from the step-%d cursor (a seek): the %d batches '
              'after the resume bitwise equal to the uninterrupted run\'s, '
              'every parameter bitwise equal; %.1f s'
              % (card, RESUME_KILL_AT, saved, len(pipe.seen),
                 time.time() - t0), flush=True)
        return {'launches': launches, 'steps': len(rec.losses),
                'wait_share': wait_share, 'split': split}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def slice9_phases(card, main):
    """Phase 18: the training shell on the card."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    pool = _slice9_pool(GPTConfig(**BENCH_CFG).vocab_size)
    model, out = shell_fit_phase(card, main, pool)
    shell_resume_phase(card, pool)
    out['ingest'] = shell_ingest_phase(card, model, pool)
    del model
    torch.cuda.empty_cache()
    return out


# -- phase 19: slice 10, compiled mode and the inference engine ------------

# (name, (b, h, n, d, dtype), forward wrapper, backward wrappers): each
# route of the two custom ops, the shapes strided as the GPT hands them over
OP_ROUTES = [
    ('standard + fused', (2, 4, 512, 64, torch.bfloat16), 'flash_fwd',
     ('flash_bwd_fused',)),
    ('standard + fused, f32', (2, 4, 512, 64, torch.float32), 'flash_fwd',
     ('flash_bwd_fused',)),
    ('two-pass', (2, 4, 1024, 64, torch.bfloat16), 'flash_fwd',
     ('flash_bwd_dq', 'flash_bwd_dkv')),
    ('long', (1, 2, 4096, 64, torch.bfloat16), 'flash_fwd_long',
     ('flash_bwd_dq_long', 'flash_bwd_dkv_long')),
]


# GPT-2 small as phase 19 (b) and phase 20 (a, b) compile it, and the
# bench GPT as phase 19 (a) compiles it: their width, vocabulary and
# sequence, cut to 1 of their 12 layers. Inductor's compile of the
# Predictor's and the Executor's programs grows with the depth (34-40 s
# each at 12 layers), as does the to_static bench step's (53.6 s at 12),
# and it runs on the host, whose speed varies from machine to machine
# (phases 19 and 20 took 107.6 + 70.9 s at 6 layers on one H100 host and
# 147.8 + 101.8 s on another; 235.8 / 236.1 s at 3 layers against 185.6 /
# 171.4 s at 1 on one host by compiled_depth_probe.py): the cuts make
# room for phases 23-25 and 28 in chip_smoke's time limit.
COMPILED_GPT2_LAYERS = 1


def op_registration_phase():
    """(1) The custom ops on the card: torch.library.opcheck (schema, fake,
    autograd registration, the AOT dispatch) of both ops on each route,
    and each op's outputs against the plain versions within the kernel
    phases' tolerances, launching the route's kernels."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED + 19)
    out = []
    for name, (b, h, n, d, dtype), fwd, bwds in OP_ROUTES:
        scale = 1.0 / math.sqrt(d)
        q, k, v = _qkv(gen, b, h, n, n, d, dtype, True)
        _reset_counts(fa)
        o, lse = fa.flash_fwd_op(q, k, v, True, scale)
        do = torch.randn((b, n, h, d), generator=gen,
                         device='cuda').to(dtype).transpose(1, 2)
        grads = fa.flash_bwd_op(q, k, v, o, lse, do, True, scale)
        torch.cuda.synchronize()
        launches = _launches(fa)
        _check(launches == _want(1, **{w: 1 for w in (fwd,) + bwds}),
               'ops on the %s route launched %s' % (name, launches))
        o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        refs = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, True,
                                          scale)
        tol_o, tol_lse = TOLERANCE[dtype]
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        _check(err_o <= tol_o and err_lse <= tol_lse,
               'flash_fwd op on the %s route: o err %.3g, lse err %.3g'
               % (name, err_o, err_lse))
        errs = []
        for g, r in zip(grads, refs):
            top = r.float().abs().max().item()
            err = (g.float() - r.float()).abs().max().item()
            _check(err <= BWD_TOLERANCE[dtype] * top,
                   'flash_bwd op on the %s route: err %.3g > %g x %.3g'
                   % (name, err, BWD_TOLERANCE[dtype], top))
            errs.append(err / top)
        t0 = time.time()
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        for op, args in ((fa.flash_fwd_op, (qg, kg, vg, True, scale)),
                         (fa.flash_bwd_op, (q, k, v, o, lse, do, True,
                                            scale))):
            result = torch.library.opcheck(op, args)
            _check(all(r == 'SUCCESS' for r in result.values()),
                   'opcheck %s on the %s route: %s' % (op, name, result))
        row = {'route': name, 'shape': [b, h, n, d],
               'dtype': str(dtype).split('.')[-1], 'err_o': err_o,
               'err_lse': err_lse, 'grad_err_share': max(errs),
               'launched': sorted(w for w, c in launches.items() if c),
               'opcheck_s': time.time() - t0}
        print('op registration: %s' % json.dumps(row), flush=True)
        out.append(row)
        del q, k, v, o, lse, do, grads, refs, qg, kg, vg
        torch.cuda.empty_cache()
    return out


def _static_step(model):
    """to_static on the Layer, and the forward and the loss as one
    compiled function over it (the Layer's program traced into it)."""
    from paddle_tpu_torch import jit

    jit.to_static(model)
    return jit.to_static(lambda ids, labels: model.loss(model(ids), labels))


def _eager_or_static_steps(model, opt, fn, ids, labels, steps):
    losses = []
    for _ in range(steps):
        loss = fn(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad(set_to_zero=False)
        losses.append(loss.item())
    return losses


# phase 19's f32 to_static parity: the bench's width at 1 of its 12 layers
# (2 before slice 23; the compile grows with the depth)
STATIC_PARITY_LAYERS = 1


def static_parity_phase():
    """(2) f32 at the bench's width cut to STATIC_PARITY_LAYERS, batch 2 x
    512: 3 AdamW steps through to_static against the same steps eager on
    the card."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**dict(BENCH_CFG, num_layers=STATIC_PARITY_LAYERS))
    t0 = time.time()
    eager, _, ids, labels = _train_setup(cfg, 'cuda', SEED, 2, TRAIN_SEQ)
    static, _, _, _ = _train_setup(cfg, 'cuda', SEED + 1, 2, TRAIN_SEQ)
    static.load_state_dict(eager.state_dict())
    opts = [AdamW(learning_rate=TRAIN_LR, parameters=m.parameters())
            for m in (eager, static)]
    eager.train()
    static.train()
    want = _eager_or_static_steps(
        eager, opts[0], lambda i, lab: eager.loss(eager(i), lab), ids,
        labels, 3)
    step = _static_step(static)
    _reset_counts(fa)
    got = _eager_or_static_steps(static, opts[1], step, ids, labels, 3)
    launches = _launches(fa)
    _check(launches == _want(3, flash_fwd=cfg.num_layers,
                             flash_bwd_fused=cfg.num_layers),
           'to_static f32 steps launched %s' % launches)
    _check(step.compile_count() == 1, 'f32 step compiled %d graphs'
           % step.compile_count())
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    _check(rel <= 1e-5, 'to_static f32 losses %s vs eager %s' % (got, want))
    worst, close, total = 0.0, 0, 0
    want_state = eager.state_dict()
    for name, p in static.state_dict().items():
        diff = (p - want_state[name]).abs()
        worst = max(worst, diff.max().item())
        close += int((diff <= 1e-6 + 1e-4 * want_state[name].abs()).sum())
        total += diff.numel()
    # phase 5's tolerances: Adam's first steps move a parameter by ~lr
    # whatever its gradient, so where it is ~0 the sign of f32 noise
    # decides (2 lr); all others agree to rounding
    _check(worst <= 2 * 3 * TRAIN_LR + 1e-6,
           'to_static f32 params differ by %.3g' % worst)
    _check(close >= 0.999 * total,
           'to_static f32 params: %d of %d close' % (close, total))
    print('to_static f32: %d layers, batch 2 x %d, 3 AdamW steps, losses %s '
          'vs eager %s (max rel %.3g, tol 1e-5), params max abs diff %.3g '
          '(tol 2 lr a step), %d of %d within 1e-6 + 1e-4 |p|, launches %s, '
          '%.1f s' % (cfg.num_layers, TRAIN_SEQ, ['%.7f' % x for x in got],
                      ['%.7f' % x for x in want], rel, worst, close, total,
                      launches, time.time() - t0), flush=True)
    del eager, static, opts
    torch.cuda.empty_cache()


def _eager_median_ms(cfg, steps=10):
    """Median ms of the eager forward + loss + backward + AdamW step of
    the bench model at `cfg` (bf16, the bench batch), after 2 warm-up
    steps: the to_static step's yardstick at the same depth."""
    from paddle_tpu_torch.optimizer import AdamW

    model, _, ids, labels = _train_setup(
        cfg, 'cuda', SEED, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    model.train()

    def fn(i, l):
        return model.loss(model(i), l)
    _eager_or_static_steps(model, opt, fn, ids, labels, 2)
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _eager_or_static_steps(model, opt, fn, ids, labels, 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    del model, opt
    torch.cuda.empty_cache()
    return sorted(step_ms)[steps // 2]


def static_train_phase(sku, main):
    """(3) Path (a): the bench's training step with the forward and the
    loss under to_static, at full width cut to COMPILED_GPT2_LAYERS
    layers (Inductor's compile of the 12-layer step took 53.6 s on an
    H100), against the same step eager at that depth."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(**dict(BENCH_CFG, num_layers=COMPILED_GPT2_LAYERS))
    layers = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    eager_ms = _eager_median_ms(cfg)
    model, _, ids, labels = _train_setup(
        cfg, 'cuda', SEED, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    model.train()
    step = _static_step(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step(ids, labels)
    torch.cuda.synchronize()
    fwd_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    bwd_compile_s = time.perf_counter() - t0
    opt.step()
    opt.clear_grad(set_to_zero=False)
    losses = [loss.item()]
    losses += _eager_or_static_steps(model, opt, step, ids, labels, 1)
    steps = 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, per_step, copies = [], [], 0
    for _ in range(steps):
        _reset_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += _eager_or_static_steps(model, opt, step, ids, labels, 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(_launches(fa))
        copies += fa.counts['aligned_copies']
    peak = torch.cuda.max_memory_allocated()
    want = _want(1, flash_fwd=layers, flash_bwd_fused=layers)
    _check(all(s == want for s in per_step),
           'to_static steps launched %s, want %s every step'
           % (per_step, want))
    _check(step.compile_count() == 1,
           'the to_static step compiled %d graphs, want 1'
           % step.compile_count())
    _check(all(math.isfinite(x) for x in losses), 'losses finite')
    _check(losses[-1] < losses[0], 'to_static loss %.4f not below %.4f'
           % (losses[-1], losses[0]))
    median = sorted(step_ms)[steps // 2]

    def one_step():
        _eager_or_static_steps(model, opt, step, ids, labels, 1)
    wall, dev, top, ops = _profile(one_step)
    clones = sum(c for name, _, c in ops if name == 'aten::clone')
    print('to_static train bf16 (path a, %d layers): compile %.1f s '
          'forward + %.1f s backward, 1 graph, 0 breaks, median step %.2f '
          'ms (min %.2f, max %.2f) against the same step eager %.2f ms '
          '(phase 6\'s 12-layer TrainStep %.2f ms) in this run, peak '
          'memory %.2f GiB (phase 6: %.2f), launches a step %s, '
          '_rows_aligned copies over %d steps %d, losses %s'
          % (layers, fwd_compile_s, bwd_compile_s, median, min(step_ms),
             max(step_ms), eager_ms, main['median_ms'], peak / 2 ** 30,
             main['peak'] / 2 ** 30, per_step[0], steps, copies,
             ['%.4f' % x for x in losses]), flush=True)
    print('profile to_static train step: wall %.2f ms, device kernels %.2f '
          'ms, busy share %.3f (phase 6: %.3f); top kernels: %s; top aten '
          'ops: %s' % (wall, dev, dev / wall, main['busy'],
                       '; '.join('%s %.2f ms x%d' % t for t in top),
                       '; '.join('%s %.2f ms x%d' % t for t in ops)),
          flush=True)
    del model, opt, step
    torch.cuda.empty_cache()
    return {'launches': {k: steps * v for k, v in per_step[0].items()},
            'steps': steps, 'median_ms': median, 'eager_ms': eager_ms,
            'layers': layers, 'busy': dev / wall,
            'peak': peak, 'compile_s': fwd_compile_s + bwd_compile_s,
            'aligned_copies': copies}


def predictor_phase():
    """(4) Path (b): jit.save of GPT-2 small (seeded weights,
    COMPILED_GPT2_LAYERS layers) with InputSpec([8, 768], 'int64'),
    jit.load, then a Predictor on the card in f32 and in
    PrecisionType.Bfloat16, run on 8 x 768 token ids. The f32 Predictor
    (its program compiled) is kept for phase 24 (c)'s watchdog."""
    import shutil
    import tempfile

    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.gpt2_small()
    cfg.num_layers = COMPILED_GPT2_LAYERS
    layers = cfg.num_layers
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
    gen = torch.Generator().manual_seed(SEED + 19)
    ids = torch.randint(0, cfg.vocab_size, (8, 768), generator=gen)
    ids_np = ids.numpy()
    with torch.no_grad():
        want = model(ids.cuda()).float()
    eager_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model(ids.cuda())
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_jit_')
    try:
        path = os.path.join(tmp, 'gpt2')
        t0 = time.time()
        jit.save(model, path, input_spec=[InputSpec([8, 768], 'int64',
                                                    'input_ids')])
        save_s = time.time() - t0
        loaded = jit.load(path)
        exported = loaded.run_exported(ids.cuda()).float()
        err_exported = (exported - want).abs().max().item()
        _check(err_exported <= 1e-4, 'the exported program vs eager: %.3g'
               % err_exported)
        del loaded, exported
        rows = {}
        for label, precision in (('f32', inference.PrecisionType.Float32),
                                 ('bf16', inference.PrecisionType.Bfloat16)):
            config = inference.Config(path)
            config.enable_use_gpu()
            config.enable_tensorrt_engine(precision_mode=precision)
            pred = inference.create_predictor(config)
            _reset_counts(fa)
            t0 = time.perf_counter()
            out = pred.run([ids_np])[0]
            compile_s = time.perf_counter() - t0
            launches = _launches(fa)
            _check(launches == _want(1, flash_fwd=layers),
                   'Predictor %s first run launched %s' % (label, launches))
            compiles = pred.compile_count()
            run_ms = []
            for _ in range(3):
                _reset_counts(fa)
                t0 = time.perf_counter()
                out = pred.run([ids_np])[0]
                run_ms.append((time.perf_counter() - t0) * 1e3)
                _check(_launches(fa) == _want(1, flash_fwd=layers),
                       'Predictor %s run launched %s'
                       % (label, _launches(fa)))
            _check(pred.compile_count() == compiles == 1,
                   'Predictor %s compiled %d programs over 4 runs'
                   % (label, pred.compile_count()))
            tensor = torch.from_numpy(ids_np).cuda()
            program_ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    pred._program(tensor)
                torch.cuda.synchronize()
                program_ms.append((time.perf_counter() - t0) * 1e3)
            got = torch.from_numpy(out).cuda()
            err = (got - want).abs().max().item()
            if label == 'f32':
                _check(err <= 1e-4, 'Predictor f32 logits vs eager: %.3g'
                       % err)
            else:
                rel = err / want.abs().max().item()
                _check(rel <= 0.1, 'Predictor bf16 logits vs eager f32: '
                       '%.3g of range' % rel)
            rows[label] = {
                'compile_s': compile_s, 'run_p50_ms': sorted(run_ms)[1],
                'program_p50_ms': sorted(program_ms)[2],
                'max_abs_err': err, 'launches_a_run': layers}
            print('Predictor %s (path b): first run (compile) %.1f s, then '
                  'no compile over 3 runs; run() p50 %.2f ms (numpy in, '
                  'logits [8, 768, %d] back to the host), the compiled '
                  'program alone p50 %.2f ms, the eager f32 forward p50 '
                  '%.2f ms; logits max abs err vs eager f32 %.3g; %d flash '
                  'forward launches a run' % (
                      label, compile_s, rows[label]['run_p50_ms'],
                      cfg.vocab_size, rows[label]['program_p50_ms'],
                      sorted(eager_ms)[2], err, layers), flush=True)
            if label == 'f32':
                kept = (pred, ids_np)
            del pred, out, got, tensor
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print('jit.save of GPT-2 small (f32, export included) %.1f s; the '
          'exported program vs eager max abs err %.3g'
          % (save_s, err_exported), flush=True)
    del model, want
    torch.cuda.empty_cache()
    return {'rows': rows, 'eager_p50_ms': sorted(eager_ms)[2],
            'save_s': save_s, 'exported_err': err_exported, 'keep': kept}


def slice10_phases(sku, main):
    """Phase 19: compiled mode and the inference engine on the card."""
    t0 = time.time()
    out = {'ops': op_registration_phase()}
    static_parity_phase()
    out['train'] = static_train_phase(sku, main)
    out['predictor'] = predictor_phase()
    out['seconds'] = time.time() - t0
    print('phase 19 (slice 10): %.1f s' % out['seconds'], flush=True)
    return out


# -- phase 20: slice 11, the static graph -------------------------------------

def _static_feeds(vocab, batch, seq, count):
    gen = torch.Generator().manual_seed(SEED + 20)
    return [torch.randint(0, vocab, (batch, seq), generator=gen).numpy()
            for _ in range(count)]


def _p50(xs):
    return sorted(xs)[len(xs) // 2]


def _timed_runs(fn, count):
    ms = []
    for _ in range(count):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def static_program_phase():
    """(a) GPT-2 small (seeded weights, dropout 0, COMPILED_GPT2_LAYERS
    layers) built under static.program_guard from static.data('ids', [8,
    768], 'int64'), in f32 and in bf16, then Executor.run on the card with
    three fresh feeds: each run's logits against the eager f32 forward on
    the same ids, one flash forward launch a layer and run, one compile,
    run() p50 with and without the host copy, a profiled run's busy share.
    (b) save_inference_model of the f32 Program, load_inference_model and
    Executor.run on the card: the fetches against (a)'s, a launch a layer
    and run."""
    import shutil
    import tempfile

    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.gpt2_small()
    cfg.dropout = 0.0
    cfg.num_layers = COMPILED_GPT2_LAYERS
    layers, batch, seq = cfg.num_layers, 8, 768
    feeds = _static_feeds(cfg.vocab_size, batch, seq, 3)
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
    with torch.no_grad():
        wants = [model(torch.from_numpy(f).cuda()).float() for f in feeds]
    rows, f32 = {}, None
    exe = static.Executor('gpu')
    for label, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        # the bf16 model is a second one from the same seed: to() converts
        # in place, and the f32 Program holds the f32 model's parameters
        m = model if dtype == torch.float32 else GPTForCausalLM(
            cfg, device='cuda', seed=SEED).eval().to(dtype)
        prog = static.Program()
        t0 = time.perf_counter()
        with torch.no_grad(), static.program_guard(prog):
            ids = static.data('ids', [batch, seq], 'int64')
            logits = m(ids)
        build_s = time.perf_counter() - t0
        outs, run_s = [], []
        for feed, want in zip(feeds, wants):
            _reset_counts(fa)
            t0 = time.perf_counter()
            out = exe.run(prog, feed={'ids': feed}, fetch_list=[logits])[0]
            run_s.append(time.perf_counter() - t0)
            launches = _launches(fa)
            _check(launches == _want(1, flash_fwd=layers),
                   'Executor.run %s launched %s' % (label, launches))
            got = torch.from_numpy(out).cuda()
            err = (got - want).abs().max().item()
            if dtype == torch.float32:
                _check(err <= 1e-4, 'Executor %s logits vs eager: %.3g'
                       % (label, err))
            else:
                rel = err / want.abs().max().item()
                _check(rel <= 0.1, 'Executor bf16 logits vs eager f32: '
                       '%.3g of range' % rel)
            outs.append(got)
            del got
        _check(not torch.equal(outs[0], outs[1]),
               'Executor %s: two feeds gave the same fetches' % label)
        _check(prog.compile_count() == 1 and prog.program_count() == 1,
               'Executor %s compiled %d graphs for %d signatures'
               % (label, prog.compile_count(), prog.program_count()))
        numpy_ms = _timed_runs(lambda: exe.run(
            prog, feed={'ids': feeds[0]}, fetch_list=[logits]), 5)
        device_feed = torch.from_numpy(feeds[0]).cuda()
        tensor_ms = _timed_runs(lambda: exe.run(
            prog, feed={'ids': device_feed}, fetch_list=[logits],
            return_numpy=False), 5)
        wall, dev, top, _ = _profile(lambda: exe.run(
            prog, feed={'ids': device_feed}, fetch_list=[logits],
            return_numpy=False))
        _check(prog.compile_count() == 1, 'Executor %s recompiled' % label)
        rows[label] = {
            'build_s': build_s, 'compile_s': run_s[0],
            'run_p50_ms': _p50(numpy_ms), 'device_p50_ms': _p50(tensor_ms),
            'busy': dev / wall, 'max_abs_err': err,
            'recorded_calls': len(prog._ops), 'launches_a_run': layers}
        print('static Executor %s (a): GPT-2 small Program (%d layers) on '
              'ids [%d, %d], %d recorded torch calls, build %.2f s, first '
              'run (compile) %.1f s, then runs of %.2f / %.2f s; 3 feeds: '
              'logits max abs '
              'err vs eager f32 %.3g, %d flash forward launches a run, 1 '
              'compile; run() p50 %.2f ms (numpy out), %.2f ms (tensors on '
              'the card); a profiled run: wall %.2f ms, kernels %.2f ms, '
              'busy %.3f; top kernels: %s' % (
                  label, layers, batch, seq, len(prog._ops), build_s,
                  run_s[0],
                  run_s[1], run_s[2], err, layers, rows[label]['run_p50_ms'],
                  rows[label]['device_p50_ms'], wall, dev, dev / wall,
                  '; '.join('%s %.2f ms x%d' % t for t in top)), flush=True)
        if dtype == torch.float32:
            f32 = (prog, ids, logits, outs[0])
        else:
            del prog, ids, logits
        del outs, device_feed
        torch.cuda.empty_cache()

    # (b) the f32 Program as an inference artifact
    prog, ids, logits, want = f32
    tmp = tempfile.mkdtemp(prefix='chip_smoke_static_')
    try:
        path = os.path.join(tmp, 'gpt2')
        t0 = time.perf_counter()
        static.save_inference_model(path, [ids], [logits], exe, program=prog)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path + '.pdmodel')
        del prog, ids, logits, model, m
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loaded, names, fetches = static.load_inference_model(path, exe)
        load_s = time.perf_counter() - t0
        _check(names == ['ids'], 'artifact feeds %s' % names)
        run_s = []
        for _ in range(2):
            _reset_counts(fa)
            t0 = time.perf_counter()
            out, = exe.run(loaded, feed={'ids': feeds[0]},
                           fetch_list=fetches, return_numpy=False)
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
            launches = _launches(fa)
            _check(launches == _want(1, flash_fwd=layers),
                   'the loaded artifact launched %s' % launches)
            err = (out - want).abs().max().item()
            _check(err <= 1e-5, 'the loaded artifact vs the Program: %.3g'
                   % err)
        _check(loaded.compile_count() == 1, 'the artifact compiled %d graphs'
               % loaded.compile_count())
        tensor_ms = _timed_runs(lambda: exe.run(
            loaded, feed={'ids': feeds[0]}, fetch_list=fetches,
            return_numpy=False), 5)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows['artifact'] = {'save_s': save_s, 'bytes': size, 'load_s': load_s,
                        'compile_s': run_s[0], 'device_p50_ms':
                        _p50(tensor_ms), 'max_abs_err': err,
                        'launches_a_run': layers}
    print('static artifact (b): save_inference_model %.1f s, %.1f MiB '
          '(weights inside), load_inference_model %.2f s, first run '
          '(compile) %.1f s, run p50 %.2f ms (tensors on the card), fetches '
          'vs the Program max abs err %.3g, %d flash forward launches a run'
          % (save_s, size / 2 ** 20, load_s, run_s[0], _p50(tensor_ms), err,
             layers), flush=True)
    del loaded, out, want, wants
    torch.cuda.empty_cache()
    return rows


def append_backward_phase():
    """(c) phase 6's bench GPT (bf16, batch 32 x 512, fused loss) built
    under program_guard: append_backward's (parameter, grad) pairs against
    loss.backward() of the same model on the same batch, eagerly; 12 fused
    backward launches in append_backward."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(**BENCH_CFG)
    layers = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    model, _, ids, labels = _train_setup(
        cfg, 'cuda', SEED, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)
    model.train()
    prog = static.Program()
    _reset_counts(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with static.program_guard(prog):
        loss = model.loss(model(ids), labels)
        pairs = static.append_backward(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches(fa)
    _check(launches == _want(1, flash_fwd=layers, flash_bwd_fused=layers),
           'append_backward launched %s' % launches)
    names = {id(p): n for n, p in model.named_parameters()}
    got = {names[id(p)]: g.detach().clone() for p, g in pairs}
    _check(set(got) == set(names.values()),
           'append_backward paired %d of %d parameters'
           % (len(got), len(names)))
    prog_loss = loss.item()
    del prog, loss, pairs
    model.zero_grad(set_to_none=True)
    loss = model.loss(model(ids), labels)
    loss.backward()
    worst, equal = 0.0, 0
    for name, p in model.named_parameters():
        top = p.grad.float().abs().max().item()
        err = (got[name].float() - p.grad.float()).abs().max().item()
        _check(err <= 1e-2 * top, 'append_backward %s: err %.3g of %.3g'
               % (name, err, top))
        worst = max(worst, err / top if top else err)
        equal += int(torch.equal(got[name], p.grad))
    _check(loss.item() == prog_loss, 'losses %r vs %r'
           % (loss.item(), prog_loss))
    print('static append_backward (c): bench GPT bf16, batch %d x %d, loss '
          '%.6f (eager %.6f), %d (parameter, grad) pairs, %d bitwise equal '
          'to loss.backward(), worst err %.3g of the gradient\'s max (tol '
          '1e-2), forward + backward %.2f s, launches %s' % (
              TRAIN_BATCH, TRAIN_SEQ, prog_loss, loss.item(), len(got), equal,
              worst, seconds, launches), flush=True)
    del model, got, loss, ids, labels
    torch.cuda.empty_cache()
    return {'launches': launches, 'pairs': len(names), 'bitwise': equal,
            'worst': worst, 'seconds': seconds}


# -- a reference-format (fluid ProgramDesc) writer: proto2 wire format and
# LoDTensor streams (framework.proto, lod_tensor.cc SerializeToStream)

def _pb_varint(v):
    if v < 0:
        v += 1 << 64
    out = b''
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _pb_len(field, payload):
    return _pb_varint((field << 3) | 2) + _pb_varint(len(payload)) + payload


def _pb_int(field, v):
    return _pb_varint(field << 3) + _pb_varint(v)


def _pb_attr(name, value):
    """INT, FLOAT, STRING, INTS or BOOLEAN, by the value's Python type."""
    out = _pb_len(1, name.encode())
    if isinstance(value, bool):
        return out + _pb_int(2, 6) + _pb_int(10, int(value))
    if isinstance(value, int):
        return out + _pb_int(2, 0) + _pb_int(3, value)
    if isinstance(value, float):
        return out + _pb_int(2, 1) + _pb_varint((4 << 3) | 5) + \
            struct.pack('<f', value)
    if isinstance(value, str):
        return out + _pb_int(2, 2) + _pb_len(5, value.encode())
    return out + _pb_int(2, 3) + b''.join(_pb_int(6, v) for v in value)


def _pb_op(op_type, inputs, outputs, **attrs):
    out = b''
    for field, slots in ((1, inputs), (2, outputs)):
        for slot, names in slots.items():
            out += _pb_len(field, _pb_len(1, slot.encode()) + b''.join(
                _pb_len(2, n.encode()) for n in names))
    out += _pb_len(3, op_type.encode())
    for name, value in attrs.items():
        out += _pb_len(4, _pb_attr(name, value))
    return out


def _pb_desc(dtype, dims):
    return _pb_int(1, dtype) + b''.join(_pb_int(2, d) for d in dims)


def _pb_var(name, dims=None, vtype=7, dtype=5, persistable=False):
    vt = _pb_int(1, vtype)
    if dims is not None:
        vt += _pb_len(3, _pb_len(1, _pb_desc(dtype, dims)) + _pb_int(2, 0))
    return _pb_len(1, name.encode()) + _pb_len(2, vt) + \
        (_pb_int(3, 1) if persistable else b'')


def _pb_program(variables, ops):
    block = _pb_int(1, 0) + _pb_int(2, -1) + \
        b''.join(_pb_len(3, v) for v in variables) + \
        b''.join(_pb_len(4, o) for o in ops)
    return _pb_len(1, block) + _pb_len(4, _pb_int(1, 0))


def _lod_tensor(arr):
    desc = _pb_desc(5, arr.shape)
    return struct.pack('<IQIi', 0, 0, 0, len(desc)) + desc + \
        np.ascontiguousarray(arr, np.float32).tobytes()


def _write_fluid(root, name, feeds, fetches, variables, ops, params,
                 combined):
    """A reference-format model directory: __model__ and one file per
    parameter, or __model__ and the parameters in one __params__ file
    (sorted by name). Returns (model path, params path or None)."""
    d = os.path.join(root, name + ('_combined' if combined else ''))
    os.makedirs(d)
    head = [_pb_var('feed', vtype=9, persistable=True),
            _pb_var('fetch', vtype=10, persistable=True)]
    head += [_pb_var(n, dims=list(a.shape), persistable=True)
             for n, a in params.items()]
    ops = [_pb_op('feed', {'X': ['feed']}, {'Out': [n]}, col=i)
           for i, n in enumerate(feeds)] + ops + \
        [_pb_op('fetch', {'X': [n]}, {'Out': ['fetch']}, col=i)
         for i, n in enumerate(fetches)]
    with open(os.path.join(d, '__model__'), 'wb') as f:
        f.write(_pb_program(head + variables, ops))
    if combined:
        with open(os.path.join(d, '__params__'), 'wb') as f:
            for n in sorted(params):
                f.write(_lod_tensor(params[n]))
        return os.path.join(d, '__model__'), os.path.join(d, '__params__')
    for n, a in params.items():
        with open(os.path.join(d, n), 'wb') as f:
            f.write(_lod_tensor(a))
    return d, None


def _digits_model(root, combined):
    """recognize_digits' convolutional net: conv2d(20 5x5) + batch_norm +
    relu + pool2d(max 2x2), twice (50 filters), then mul + elementwise_add
    to 10 classes and softmax."""
    gen = np.random.RandomState(SEED + 20)
    p = {'conv1_w': gen.randn(20, 1, 5, 5) * 0.2,
         'conv2_w': gen.randn(50, 20, 5, 5) * 0.05,
         'fc_w': gen.randn(50 * 4 * 4, 10) * 0.03, 'fc_b': gen.randn(10)}
    for i, c in ((1, 20), (2, 50)):
        p['bn%d_s' % i] = gen.rand(c) + 0.5
        p['bn%d_b' % i] = gen.randn(c) * 0.1
        p['bn%d_m' % i] = gen.randn(c) * 0.1
        p['bn%d_v' % i] = gen.rand(c) + 0.5
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    ops = []
    x = 'img'
    for i in (1, 2):
        ops += [
            _pb_op('conv2d', {'Input': [x], 'Filter': ['conv%d_w' % i]},
                   {'Output': ['conv%d' % i]}, strides=[1, 1],
                   paddings=[0, 0], dilations=[1, 1], groups=1),
            _pb_op('batch_norm', {'X': ['conv%d' % i],
                                  'Scale': ['bn%d_s' % i],
                                  'Bias': ['bn%d_b' % i],
                                  'Mean': ['bn%d_m' % i],
                                  'Variance': ['bn%d_v' % i]},
                   {'Y': ['bn%d' % i]}, epsilon=1e-5, is_test=True),
            _pb_op('relu', {'X': ['bn%d' % i]}, {'Out': ['relu%d' % i]}),
            _pb_op('pool2d', {'X': ['relu%d' % i]}, {'Out': ['pool%d' % i]},
                   pooling_type='max', ksize=[2, 2], strides=[2, 2],
                   paddings=[0, 0])]
        x = 'pool%d' % i
    ops += [
        _pb_op('flatten_contiguous_range', {'X': ['pool2']},
               {'Out': ['flat']}, start_axis=1, stop_axis=-1),
        _pb_op('mul', {'X': ['flat'], 'Y': ['fc_w']}, {'Out': ['fc_tmp']},
               x_num_col_dims=1, y_num_col_dims=1),
        _pb_op('elementwise_add', {'X': ['fc_tmp'], 'Y': ['fc_b']},
               {'Out': ['logits']}, axis=1),
        _pb_op('softmax', {'X': ['logits']}, {'Out': ['prob']}, axis=-1)]
    return _write_fluid(root, 'digits', ['img'], ['prob'],
                        [_pb_var('img', dims=[-1, 1, 28, 28])], ops, p,
                        combined)


def _fit_a_line_model(root, combined):
    gen = np.random.RandomState(SEED + 21)
    p = {'fc_w': gen.randn(13, 1).astype(np.float32),
         'fc_b': gen.randn(1).astype(np.float32)}
    ops = [_pb_op('mul', {'X': ['x'], 'Y': ['fc_w']}, {'Out': ['fc_tmp']},
                  x_num_col_dims=1, y_num_col_dims=1),
           _pb_op('elementwise_add', {'X': ['fc_tmp'], 'Y': ['fc_b']},
                  {'Out': ['y']}, axis=1)]
    return _write_fluid(root, 'fit_a_line', ['x'], ['y'],
                        [_pb_var('x', dims=[-1, 13])], ops, p, combined)


def fluid_model_phase():
    """(d) reference-format models written by this script's own
    ProgramDesc / LoDTensor writer — recognize_digits' CNN (batch 64 x 1 x
    28 x 28) and fit_a_line (batch 256 x 13), each in the separate-files
    and the combined layout — served through a Predictor on the card and
    through static.load_inference_model + Executor on the card, each
    against the port's op table run on the CPU (uncompiled) on the same
    artifact within 1e-5."""
    import shutil
    import tempfile

    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.inference import fluid_program

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = np.random.RandomState(SEED + 22)
    inputs = {'digits': gen.rand(64, 1, 28, 28).astype(np.float32),
              'fit_a_line': gen.randn(256, 13).astype(np.float32)}
    root = tempfile.mkdtemp(prefix='chip_smoke_fluid_')
    rows = []
    try:
        for name, write in (('digits', _digits_model),
                            ('fit_a_line', _fit_a_line_model)):
            x = inputs[name]
            for combined in (False, True):
                model, params = write(root, combined)
                # the CPU run through the op table uncompiled (a card's
                # host may lack the C++ toolchain Inductor's CPU backend
                # needs)
                ref = fluid_program.load_fluid_model(model, params,
                                                     device='cpu')
                with torch.no_grad():
                    cpu = ref._forward(torch.from_numpy(x))[0].numpy()
                config = inference.Config(model, params)
                config.enable_use_gpu()
                pred = inference.create_predictor(config)
                t0 = time.perf_counter()
                out = pred.run([x])[0]
                compile_s = time.perf_counter() - t0
                ms = _timed_runs(lambda: pred.run([x]), 5)
                exe = static.Executor('gpu')
                kw = {'model_filename': '__model__',
                      'params_filename': '__params__'} if combined else {}
                prog, feeds, fetches = static.load_inference_model(
                    os.path.dirname(model) if combined else model, exe,
                    **kw)
                out2 = exe.run(prog, feed={feeds[0]: x},
                               fetch_list=fetches)[0]
                errs = []
                for got in (out, out2):
                    err = np.abs(got - cpu).max()
                    _check(np.allclose(got, cpu, rtol=1e-5, atol=1e-5),
                           '%s (%s) on the card vs the CPU: %.3g' % (
                               name, 'combined' if combined else 'separate',
                               err))
                    errs.append(float(err))
                _check(pred.compile_count() == 1 and
                       prog.compile_count() == 1,
                       '%s compiled %d + %d graphs' % (
                           name, pred.compile_count(), prog.compile_count()))
                row = {'model': name, 'layout': 'combined' if combined
                       else 'separate', 'batch': x.shape[0],
                       'predictor_err': errs[0], 'executor_err': errs[1],
                       'compile_s': compile_s, 'run_p50_ms': _p50(ms)}
                print('static fluid (d): %s' % json.dumps(row), flush=True)
                rows.append(row)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rows


def slice11_phases():
    """Phase 20: the static graph on the card."""
    t0 = time.time()
    out = {'program': static_program_phase()}
    out['backward'] = append_backward_phase()
    out['fluid'] = fluid_model_phase()
    out['seconds'] = time.time() - t0
    print('phase 20 (slice 11): %.1f s' % out['seconds'], flush=True)
    return out


# ---- phase 21 (slice 12): the parameter server and the graph engine -------
# CTR at the shape of PaddleRec's Criteo DNN (models/rank/dnn/config.yaml):
# 26 categorical slots hashed into one sparse table of 1,000,001 ids of dim
# 9, batch 512; the JAX DownpourTrainer's one hidden layer makes the dense
# half 26 x 9 -> 512 -> 1. The ids are Zipf-skewed draws made from SEED.
CTR_SLOTS = 26
CTR_IDS = 1000001
CTR_DIM = 9
CTR_HIDDEN = 512
CTR_BATCH = 512
CTR_BATCHES = 30
CTR_FILES = 4
PASS_BATCHES = 20
# the graph at ogbn-arxiv's shape (nodes, undirected edges loaded both ways,
# 128-dim f32 features, 40 classes), made from SEED as communities; a
# 2-layer GraphSAGE mean, hidden 256, fan-outs 25 then 10, 512 seeds a
# batch (Hamilton et al., 2017)
GNN_NODES = 169343
GNN_EDGES = 1166243
GNN_FEAT = 128
GNN_CLASSES = 40
GNN_HIDDEN = 256
GNN_FANOUTS = (25, 10)
GNN_BATCH = 512
GNN_STEPS = 10


def _ctr_data(seed, n_inst):
    """One id a slot, Zipf-skewed (a = 1.2) and hashed into CTR_IDS per
    slot; the label draws from a logistic of hidden per-id scores of the
    first 4 slots, so it is learnable from the embeddings."""
    rng = np.random.RandomState(seed)
    z = rng.zipf(1.2, (n_inst, CTR_SLOTS)) % CTR_IDS
    ids = (z * 2654435761 + np.arange(CTR_SLOTS) * 1000003) % CTR_IDS
    score = ((ids[:, :4] * 7919) % 1000) / 500.0 - 1.0
    p = 1.0 / (1.0 + np.exp(-3.0 * score.sum(axis=1)))
    return ids.astype(np.int64), (rng.rand(n_inst) < p).astype(np.float32)


def _write_multislot(ids, labels, root, n_files):
    """MultiSlot text: '1 <id>' per slot, then '1 <label>'."""
    files = []
    for f, part in enumerate(np.array_split(np.arange(len(ids)), n_files)):
        path = os.path.join(root, 'part-%03d' % f)
        with open(path, 'w') as fh:
            fh.write('\n'.join(
                ' '.join('1 %d' % v for v in row) + ' 1 %.1f' % y
                for row, y in zip(ids[part].tolist(),
                                  labels[part].tolist())))
            fh.write('\n')
        files.append(path)
    return files


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def _timed_trainer(base):
    """The trainer with its three parts timed per batch and the device of
    every dense step recorded."""
    import threading

    class TimedTrainer(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.parts = {'pull': [], 'step': [], 'push': []}
            self.dense_devices = []
            self._parts_lock = threading.Lock()

        def _timed(self, part, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            with self._parts_lock:
                self.parts[part].append(time.perf_counter() - t0)
            return out

        def _pull(self, batch):
            return self._timed('pull', super()._pull, batch)

        def _device_step(self, *args):
            return self._timed('step', super()._device_step, *args)

        def _push(self, *args):
            return self._timed('push', super()._push, *args)

        def _dense_step(self, dense, pooled, labels):
            with self._parts_lock:
                self.dense_devices.append((pooled.device.type,
                                           dense['w1'].device.type))
            return super()._dense_step(dense, pooled, labels)

    return TimedTrainer


def _drain(dataset):
    channel = dataset.start_channel()
    out = []
    while True:
        batch = channel.get()
        if batch is None:
            return out
        out.append(batch)


def ps_ctr_phase(card, dev):
    """(a) CTR through the PS: MultiSlot files parsed by the native
    datafeed, 2 EmbeddingServer shards (native tables, server-side
    adagrad) behind sockets, an AsyncCommunicator, DownpourTrainer with 2
    threads and its dense half on the card."""
    import tempfile
    import threading
    from paddle_tpu_torch import native
    from paddle_tpu_torch.native import datafeed
    from paddle_tpu_torch.distributed.ps import (AsyncCommunicator,
                                                 DownpourTrainer,
                                                 EmbeddingClient,
                                                 EmbeddingServer,
                                                 MultiSlotDataset)
    t0 = time.perf_counter()
    n_inst = CTR_BATCH * CTR_BATCHES
    ids, labels = _ctr_data(SEED, n_inst)
    root = tempfile.mkdtemp(prefix='ctr_')
    files = _write_multislot(ids, labels, root, CTR_FILES)
    _check(native.available('datafeed'), 'the native datafeed did not build')
    # the native parser must parse every file: the Python one refuses
    calls = collections.Counter()
    lock = threading.Lock()
    real = datafeed._parse_native, datafeed._parse_python

    def native_parse(*args):
        with lock:
            calls['native'] += 1
        return real[0](*args)

    def python_parse(*args):
        with lock:
            calls['python'] += 1
        raise RuntimeError('the Python MultiSlot parser ran')

    datafeed._parse_native, datafeed._parse_python = native_parse, \
        python_parse
    try:
        slots = ['s%d' % s for s in range(CTR_SLOTS)]
        ds = MultiSlotDataset()
        ds.set_use_var([(s, 'int64') for s in slots] +
                       [('label', 'float32')])
        ds.set_filelist(files)
        ds.set_batch_size(CTR_BATCH)
        ds.set_thread(CTR_FILES)
        ds.load_into_memory()
    finally:
        datafeed._parse_native, datafeed._parse_python = real
    _check(calls == {'native': CTR_FILES},
           'MultiSlot parsers run: %s' % dict(calls))
    _check(ds.get_memory_data_size() == n_inst,
           'dataset holds %d of %d instances'
           % (ds.get_memory_data_size(), n_inst))
    setup_s = time.perf_counter() - t0

    servers = []
    for _ in range(2):
        srv = EmbeddingServer()
        for table in (0, 1):       # 0: the Downpour run, 1: the heter runs
            srv.create_table(table, CTR_DIM, backend='native',
                             optimizer='adagrad', lr=0.05, init_scale=0.01,
                             seed=SEED)
        srv.start()
        servers.append(srv)
    _check(all(type(s.table(t)).__name__ == 'NativeEmbeddingTable'
               for s in servers for t in (0, 1)),
           'a table is not on the native backend')
    client = EmbeddingClient(endpoints=['127.0.0.1:%d' % s.port
                                        for s in servers])
    comm = AsyncCommunicator(client)
    comm.start()
    trainer = _timed_trainer(DownpourTrainer)(
        client, comm, slots, {s: 0 for s in slots}, CTR_DIM,
        hidden=CTR_HIDDEN, lr=0.05, n_threads=2, seed=SEED, device=dev)
    t1 = time.perf_counter()
    losses = trainer.train_from_dataset(ds)
    wall = time.perf_counter() - t1
    comm.stop()
    _check(len(losses) == CTR_BATCHES, '%d losses' % len(losses))
    _check(all(np.isfinite(losses)), 'a loss is not finite')
    _check(trainer.dense_devices == [(dev.type, dev.type)] * CTR_BATCHES,
           'dense steps ran on %s' % sorted(set(trainer.dense_devices)))
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    _check(last < first, 'the CTR loss did not fall: %.4f -> %.4f'
           % (first, last))

    # one batch's pooling and dense step on the card against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = _drain(ds)
    batch = batches[0]
    rows, index, segment, _ = trainer._pull(batch)
    y = np.asarray(batch['label'], np.float32)
    outs = []
    for d in (dev, torch.device('cpu')):
        pooled, _, _ = trainer._pool(CTR_BATCH, rows, index, segment, d)
        dense = {k: v.to(d) for k, v in trainer.dense.items()}
        loss, d_pooled, d_dense = trainer._dense_step(
            dense, pooled, torch.from_numpy(y).to(d))
        outs.append([pooled, loss, d_pooled] + [d_dense[k]
                                                for k in sorted(d_dense)])
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(*outs))
    _check(err <= 1e-5, 'CTR dense step card vs CPU: %.3g > 1e-5' % err)

    rows_held = [len(s.table(0)) for s in servers]
    ex_s = n_inst / wall
    p50 = {k: _p50(v) * 1e3 for k, v in trainer.parts.items()}
    print('phase 21 (a) CTR through the PS [%s]: %d batches x %d, 26 '
          'slots, 2 threads, 2 native shards: %.0f examples/s; p50 a '
          'batch: pull %.2f ms, device step %.2f ms, push %.2f ms; rows '
          'held per shard %s; loss %.4f -> %.4f (mean of the first / last '
          '10); card vs CPU pooling + dense step max err %.3g (f32, TF32 '
          'off); data set-up %.1f s'
          % (card, CTR_BATCHES, CTR_BATCH, ex_s, p50['pull'], p50['step'],
             p50['push'], rows_held, first, last, err, setup_s), flush=True)
    return {'servers': servers, 'client': client, 'batches': batches,
            'slots': slots, 'root': root, 'examples_s': ex_s, 'p50_ms': p50,
            'rows_held': rows_held, 'loss': (losses[0], losses[-1]),
            'err': err}


class _RecordingClient:
    """An EmbeddingClient's pull / push / push_delta, recorded; pushes and
    deltas go on to the service only when `forward`."""

    def __init__(self, client, forward):
        self.client = client
        self.forward = forward
        self.pulls, self.pushes, self.deltas = [], [], []

    def pull(self, table_id, ids):
        rows = self.client.pull(table_id, ids)
        self.pulls.append((np.asarray(ids).copy(), rows.copy()))
        return rows

    def push(self, table_id, ids, grads):
        self.pushes.append((np.asarray(ids).copy(), np.asarray(grads).copy()))
        if self.forward:
            self.client.push(table_id, ids, grads)

    def push_delta(self, table_id, ids, deltas):
        self.deltas.append((np.asarray(ids).copy(),
                            np.asarray(deltas).copy()))
        if self.forward:
            self.client.push_delta(table_id, ids, deltas)


def _ctr_net(emb, dev):
    from paddle_tpu_torch.nn.layer.common import Linear

    class CTRNet(torch.nn.Module):
        """The heter model: the embedding over the 26 slots into the
        Downpour trainer's MLP (26 x 9 -> 512 -> 1, tanh)."""

        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(SEED)
            self.emb = emb
            self.fc1 = Linear(CTR_SLOTS * CTR_DIM, CTR_HIDDEN, device=dev,
                              generator=gen)
            self.fc2 = Linear(CTR_HIDDEN, 1, device=dev, generator=gen)

        def forward(self, ids):
            e = self.emb(ids)
            return self.fc2(torch.tanh(self.fc1(
                e.reshape(e.shape[0], -1))))[:, 0]

    return CTRNet()


def _batch_ids(batch, slots):
    """[B, 26] ids (one id a slot in this data) and the labels."""
    for s in slots:
        _check(np.array_equal(batch[s][1], np.arange(batch['__size__'] + 1)),
               'slot %s does not hold one id an instance' % s)
    return (np.stack([batch[s][0] for s in slots], axis=1),
            np.asarray(batch['label'], np.float32))


def heter_phase(card, dev, ps):
    """(b) HeterEmbedding (rows pulled to the card each step, grads pushed
    back through the communicator) and PassCachedEmbedding (a pass's rows
    on the card as a Parameter, deltas pushed at end_pass), each under the
    port's Adam."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.distributed.ps import (AsyncCommunicator,
                                                 HeterEmbedding,
                                                 PassCachedEmbedding)
    bce = torch.nn.functional.binary_cross_entropy_with_logits
    client, slots, batches = ps['client'], ps['slots'], ps['batches']
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # one step's pushed rows against an nn.Embedding holding the same rows
    rec = _RecordingClient(client, forward=False)
    net = _ctr_net(HeterEmbedding(rec, 1, CTR_DIM, device=dev), dev)
    ids, y = _batch_ids(batches[0], slots)
    y_d = torch.from_numpy(y).to(dev)
    bce(net(torch.from_numpy(ids)), y_d).backward()
    _check(len(rec.pulls) == 1 and len(rec.pushes) == 1,
           'heter step: %d pulls, %d pushes' % (len(rec.pulls),
                                                 len(rec.pushes)))
    flat = ids.reshape(-1)
    uniq, first_at, inv = np.unique(flat, return_index=True,
                                    return_inverse=True)
    ref = torch.nn.Embedding(len(uniq), CTR_DIM, device=dev)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(rec.pulls[0][1][first_at]))
    e = ref(torch.from_numpy(inv.reshape(ids.shape)).to(dev))
    bce(net.fc2(torch.tanh(net.fc1(e.reshape(e.shape[0], -1))))[:, 0],
        y_d).backward()
    pushed_ids, pushed = rec.pushes[0]
    _check(np.array_equal(pushed_ids, flat), 'pushed ids differ')
    merged = np.zeros((len(uniq), CTR_DIM), np.float32)
    np.add.at(merged, inv, pushed)
    push_err = float(np.abs(merged - ref.weight.grad.cpu().numpy()).max())
    _check(push_err <= 1e-6, 'pushed rows vs nn.Embedding grad: %.3g > '
           '1e-6' % push_err)

    # HeterEmbedding training over every batch
    comm = AsyncCommunicator(client)
    comm.start()
    net = _ctr_net(HeterEmbedding(client, 1, CTR_DIM, communicator=comm,
                                  device=dev), dev)
    opt = tpt.optimizer.Adam(learning_rate=1e-3,
                             parameters=list(net.parameters()))
    losses, on_dev = [], 0
    _sync(dev)
    t0 = time.perf_counter()
    for batch in batches:
        ids, y = _batch_ids(batch, slots)
        logit = net(torch.from_numpy(ids))
        on_dev += logit.device.type == dev.type
        loss = bce(logit, torch.from_numpy(y).to(dev))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    comm.flush()
    heter_s = time.perf_counter() - t0
    comm.stop()
    _check(on_dev == len(batches), 'heter forwards off the card')
    _check(all(np.isfinite(losses)), 'a heter loss is not finite')
    heter_ex_s = len(batches) * CTR_BATCH / heter_s

    # PassCachedEmbedding over one pass
    pass_batches = [_batch_ids(b, slots) for b in batches[:PASS_BATCHES]]
    pass_ids = np.concatenate([i.reshape(-1) for i, _ in pass_batches])
    rec = _RecordingClient(client, forward=True)
    emb = PassCachedEmbedding(rec, 1, CTR_DIM, device=dev)
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    n_rows = emb.begin_pass(pass_ids)
    net = _ctr_net(emb, dev)
    opt = tpt.optimizer.Adam(learning_rate=1e-3,
                             parameters=list(net.parameters()))
    pass_losses = []
    for ids, y in pass_batches:
        logit = net(torch.from_numpy(emb.lookup_slots(ids)).to(dev))
        loss = bce(logit, torch.from_numpy(y).to(dev))
        loss.backward()
        opt.step()
        opt.clear_grad()
        pass_losses.append(loss.item())
    final = emb.table.detach().cpu().numpy()
    base = emb._base.copy()
    n_pushed = emb.end_pass()
    pass_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == 'cuda' else 0
    _check(len(rec.deltas) == 1, '%d end_pass pushes' % len(rec.deltas))
    d_ids, d_rows = rec.deltas[0]
    touched = np.unique(pass_ids)
    _check(n_pushed == len(touched) == n_rows
           and np.array_equal(d_ids, touched),
           'end_pass pushed %d rows for %d touched' % (n_pushed,
                                                       len(touched)))
    _check(np.array_equal(d_rows, (final - base)[np.searchsorted(
        touched, d_ids)]), 'end_pass deltas are not the pass deltas')
    pass_ex_s = PASS_BATCHES * CTR_BATCH / pass_s
    print('phase 21 (b) heter paths [%s]: HeterEmbedding %d batches x %d: '
          '%.0f examples/s, loss %.4f -> %.4f, one step\'s pushed rows vs '
          'an nn.Embedding\'s grad max err %.3g; PassCachedEmbedding, a pass '
          'of %d batches over %d rows: %.0f examples/s (begin_pass and '
          'end_pass included), loss %.4f -> %.4f, end_pass pushed exactly '
          'the %d touched rows\' deltas; peak memory %.1f MiB'
          % (card, len(batches), CTR_BATCH, heter_ex_s, losses[0],
             losses[-1], push_err, PASS_BATCHES, n_rows, pass_ex_s,
             pass_losses[0], pass_losses[-1], n_pushed, peak / 2 ** 20),
          flush=True)
    return {'heter_examples_s': heter_ex_s, 'pass_examples_s': pass_ex_s,
            'push_err': push_err, 'pass_rows': n_rows,
            'peak_mib': peak / 2 ** 20}


def _gnn_graph(seed):
    """Communities: each node's label is its community; 80% of edges stay
    inside a community; features are the community's centroid (scaled by
    0.5) plus unit noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, GNN_CLASSES, GNN_NODES).astype(np.int64)
    order = np.argsort(labels, kind='stable')
    counts = np.bincount(labels, minlength=GNN_CLASSES)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    src = rng.randint(0, GNN_NODES, GNN_EDGES).astype(np.int64)
    c = labels[src]
    inside = order[starts[c] + (rng.rand(GNN_EDGES) * counts[c]).astype(
        np.int64)]
    dst = np.where(rng.rand(GNN_EDGES) < 0.8, inside,
                   rng.randint(0, GNN_NODES, GNN_EDGES)).astype(np.int64)
    centroids = rng.randn(GNN_CLASSES, GNN_FEAT).astype(np.float32)
    feats = (0.5 * centroids[labels] +
             rng.randn(GNN_NODES, GNN_FEAT).astype(np.float32))
    return src, dst, feats.astype(np.float32), labels


def _load_graph(client, src, dst, feats, chunk=500000):
    both_src = np.concatenate([src, dst])
    both_dst = np.concatenate([dst, src])
    for lo in range(0, len(both_src), chunk):
        client.add_edges('default', both_src[lo:lo + chunk],
                         both_dst[lo:lo + chunk])
    for lo in range(0, len(feats), chunk // 10):
        hi = min(lo + chunk // 10, len(feats))
        client.set_node_feat('default', np.arange(lo, hi), feats[lo:hi])


def gnn_phase(card, dev):
    """(c) GraphSAGE through the graph engine: the graph in 2 GraphPyServer
    shards, neighborhoods sampled and features gathered over the sockets,
    one copy of each hop's features to the card, Adam on the card."""
    import copy
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import native
    from paddle_tpu_torch.distributed.graph_learning import (
        GraphSageLayer, gather_features, neighbor_sample, sample_and_gather)
    from paddle_tpu_torch.distributed.graph_service import GraphPyService
    from paddle_tpu_torch.nn.functional import cross_entropy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src, dst, feats, labels = _gnn_graph(SEED + 1)
    _check(native.available('graph_store'), 'the native graph store did '
           'not build')
    svc = GraphPyService()
    client = svc.set_up(num_servers=2)
    try:
        stores = [s._srv.stores['default'] for s in svc._servers]
        _check(all(type(st).__name__ == '_NativeStore' for st in stores),
               'a graph shard is not on the native store')
        t0 = time.perf_counter()
        _load_graph(client, src, dst, feats)
        load_s = time.perf_counter() - t0
        edges = sum(st.edge_count() for st in stores)
        _check(edges == 2 * GNN_EDGES, '%d edges loaded' % edges)

        gen = torch.Generator().manual_seed(SEED)
        sage1 = GraphSageLayer(GNN_FEAT, GNN_HIDDEN, device=dev,
                               generator=gen)
        sage2 = GraphSageLayer(GNN_HIDDEN, GNN_CLASSES, act=None,
                               device=dev, generator=gen)

        def forward(l1, l2, f0, f1, f2):
            return l2(l1(f0, f1), l1(f1, f2))

        opt = tpt.optimizer.Adam(learning_rate=1e-2, parameters=list(
            sage1.parameters()) + list(sage2.parameters()))
        rng = np.random.RandomState(SEED + 2)
        parts = {'sample': [], 'gather': [], 'to_card': [], 'step': []}
        losses, err = [], None
        _sync(dev)
        t_all = time.perf_counter()
        for step in range(GNN_STEPS):
            seeds = rng.choice(GNN_NODES, GNN_BATCH, replace=False)
            t0 = time.perf_counter()
            hop1 = neighbor_sample(client, 'default', seeds, GNN_FANOUTS[0])
            hop2 = neighbor_sample(client, 'default', hop1.reshape(-1),
                                   GNN_FANOUTS[1]).reshape(
                                       hop1.shape + (GNN_FANOUTS[1],))
            t1 = time.perf_counter()
            host = [gather_features(client, 'default', a, GNN_FEAT)
                    for a in (seeds, hop1, hop2)]
            t2 = time.perf_counter()
            x = [torch.from_numpy(a).to(dev) for a in host]
            y = torch.from_numpy(labels[seeds]).to(dev)
            _sync(dev)
            t3 = time.perf_counter()
            if step == 0:
                # the first batch's forward on the card against the CPU
                with torch.no_grad():
                    got = forward(sage1, sage2, *x).cpu()
                    want = forward(copy.deepcopy(sage1).cpu(),
                                   copy.deepcopy(sage2).cpu(),
                                   *[torch.from_numpy(a) for a in host])
                err = float((got - want).abs().max())
                _check(err <= 1e-5, 'GraphSAGE card vs CPU: %.3g > 1e-5'
                       % err)
                t3 = time.perf_counter()
            logits = forward(sage1, sage2, *x)
            _check(logits.device.type == dev.type, 'GraphSAGE off the card')
            loss = cross_entropy(logits, y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
            t4 = time.perf_counter()
            for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[k].append(v)
        wall = time.perf_counter() - t_all
        _check(all(np.isfinite(losses)), 'a GraphSAGE loss is not finite')
        _check(losses[-1] < losses[0], 'the GraphSAGE loss did not fall: '
               '%.4f -> %.4f' % (losses[0], losses[-1]))
        self_f, hops = sample_and_gather(client, 'default', seeds[:4],
                                         GNN_FANOUTS, GNN_FEAT)
        _check(self_f.shape == (4, GNN_FEAT) and hops[1].shape == (
            4, GNN_FANOUTS[0], GNN_FANOUTS[1], GNN_FEAT),
            'sample_and_gather shapes')
    finally:
        svc.stop()
    seeds_s = GNN_STEPS * GNN_BATCH / wall
    p50 = {k: _p50(v) * 1e3 for k, v in parts.items()}
    rows = GNN_BATCH * (1 + GNN_FANOUTS[0] * (1 + GNN_FANOUTS[1]))
    print('phase 21 (c) GraphSAGE through the graph engine [%s]: %d nodes, '
          '%d edges both ways, %d-dim features in 2 native shards, loaded '
          'in %.1f s; %d steps of %d seeds (fan-outs %s, %d feature rows, '
          '%.1f MB a batch): %.0f seeds/s; p50 a step: sample %.1f ms, '
          'gather %.1f ms, to the card %.1f ms, device step %.1f ms; loss '
          '%.4f -> %.4f; first batch card vs CPU max err %.3g (f32, TF32 '
          'off)'
          % (card, GNN_NODES, 2 * GNN_EDGES, GNN_FEAT, load_s, GNN_STEPS,
             GNN_BATCH, '/'.join(map(str, GNN_FANOUTS)), rows,
             rows * GNN_FEAT * 4 / 1e6, seeds_s, p50['sample'],
             p50['gather'], p50['to_card'], p50['step'], losses[0],
             losses[-1], err), flush=True)
    return {'seeds_s': seeds_s, 'p50_ms': p50, 'load_s': load_s,
            'loss': (losses[0], losses[-1]), 'err': err}


def recovery_phase(card):
    """(d) bench_extra.py's supervisor rung on the port: a journaled PS
    shard snapshotted, killed and recovered by ShardSupervisor.poll();
    then the same for one graph shard."""
    import shutil
    import tempfile
    from paddle_tpu_torch.distributed.graph_service import (GraphPyClient,
                                                            GraphPyServer)
    from paddle_tpu_torch.distributed.ps import (EmbeddingClient,
                                                 EmbeddingServer)
    from paddle_tpu_torch.distributed.supervisor import (PushJournal,
                                                         ShardSpec,
                                                         ShardSupervisor)
    from paddle_tpu_torch.testing import chaos
    snap_dir = tempfile.mkdtemp(prefix='shards_')
    dim, n_ids, pushes = 16, 256, 8
    holder = {}

    def make_ps(port=0):
        s = EmbeddingServer(port=port)
        s.create_table(0, dim=dim, optimizer='sgd', lr=0.1)
        s.start()
        holder['ps'] = s

    make_ps()
    port = holder['ps'].port
    journal = PushJournal('trainer-0')
    cli = EmbeddingClient(endpoints=['127.0.0.1:%d' % port],
                          journal=journal)
    rng = np.random.RandomState(SEED)
    ids = list(range(n_ids))
    cli.pull(0, ids)
    for _ in range(pushes):
        cli.push(0, ids, rng.randn(n_ids, dim).astype(np.float32))
    sup = ShardSupervisor(miss_threshold=1, restart_budget=3,
                          ping_timeout=0.5)
    sup.add_shard(ShardSpec('emb0', '127.0.0.1:%d' % port, role='ps',
                            restart=lambda: make_ps(port),
                            snapshot_dir=snap_dir, clients=(cli,)))
    sup.snapshot_all()
    for _ in range(2):
        cli.push(0, ids, rng.randn(n_ids, dim).astype(np.float32))
    want = cli.pull(0, ids)
    chaos.kill_server(holder['ps'])
    t0 = time.perf_counter()
    alive = sup.poll()
    ps_mttr = time.perf_counter() - t0
    got = cli.pull(0, ids)
    holder['ps'].stop()
    _check(alive == {'emb0': True}, 'the PS shard did not recover')
    _check(np.array_equal(want, got), 'the recovered PS rows differ')
    ps_journal = (journal.replayed, journal.dedup_hits)

    # one graph shard: the GNN graph's first 200,000 edges, the last
    # 20,000 of them sent after the snapshot
    src, dst, _, _ = _gnn_graph(SEED + 1)
    src, dst = src[:200000], dst[:200000]

    def make_graph(port=0):
        s = GraphPyServer(rank=0, port=port)
        s.start_server()
        holder['graph'] = s

    make_graph()
    gport = holder['graph'].port
    gjournal = PushJournal('loader-0')
    gcli = GraphPyClient(['127.0.0.1:%d' % gport], journal=gjournal)
    gcli.add_edges('default', src[:180000], dst[:180000])
    gsup = ShardSupervisor(miss_threshold=1, restart_budget=3,
                           ping_timeout=0.5)
    gsup.add_shard(ShardSpec('graph0', '127.0.0.1:%d' % gport,
                             role='graph', restart=lambda: make_graph(gport),
                             snapshot_dir=snap_dir, clients=(gcli,)))
    gsup.snapshot_all()
    gcli.add_edges('default', src[180000:], dst[180000:])
    nodes = np.unique(src[:4096])
    degrees = gcli.get_degree('default', nodes)

    def seeded_samples():
        # drawn on this thread from the shard's store after seeding this
        # thread's generator: the handler threads draw unseeded
        store = holder['graph']._srv.stores['default']
        store._lib.gs_seed(SEED)
        return store.sample_neighbors(nodes, 10)

    before = seeded_samples()
    chaos.kill_server(holder['graph'])
    t0 = time.perf_counter()
    galive = gsup.poll()
    graph_mttr = time.perf_counter() - t0
    try:
        _check(galive == {'graph0': True}, 'the graph shard did not '
               'recover')
        _check(np.array_equal(gcli.get_degree('default', nodes), degrees),
               'the recovered graph degrees differ')
        _check(np.array_equal(seeded_samples(), before),
               'the recovered graph samples differ')
    finally:
        gcli.close()
        holder['graph'].stop_server()
    graph_journal = (gjournal.replayed, gjournal.dedup_hits)
    shutil.rmtree(snap_dir, ignore_errors=True)
    print('phase 21 (d) shard recovery [%s]: PS shard (%d rows x %d, %d + '
          '2 journaled pushes) killed and recovered by poll() in %.4f s '
          '(MTTR), rows bitwise equal, journal replayed %d, dedup hits %d; '
          'graph shard (%d edges, the last %d after the snapshot) in %.4f s, '
          'degrees and seeded samples of %d nodes equal, journal replayed '
          '%d, dedup hits %d'
          % (card, n_ids, dim, pushes, ps_mttr, ps_journal[0],
             ps_journal[1], len(src), 20000, graph_mttr, len(nodes),
             graph_journal[0], graph_journal[1]), flush=True)
    return {'ps_mttr_s': ps_mttr, 'ps_journal': ps_journal,
            'graph_mttr_s': graph_mttr, 'graph_journal': graph_journal}


def slice12_phases(card, dev=None):
    """Phase 21: the parameter server and the graph engine on the card."""
    import shutil
    dev = torch.device('cuda' if dev is None else dev)
    t0 = time.time()
    ps = ps_ctr_phase(card, dev)
    try:
        out = {'ctr': ps, 'heter': heter_phase(card, dev, ps)}
    finally:
        for srv in ps['servers']:
            srv.stop()
        shutil.rmtree(ps['root'], ignore_errors=True)
    out['gnn'] = gnn_phase(card, dev)
    out['recovery'] = recovery_phase(card)
    out['seconds'] = time.time() - t0
    print('phase 21 (slice 12) [%s]: %.1f s' % (card, out['seconds']),
          flush=True)
    return out


# (b, h, n, m, d, dtype, causal): the d = 192 / 256 instantiations (CUDA
# cores, operands staged as their own type) of every entry, at one short
# causal shape and one ragged non-causal cross-length shape. No path of this
# script runs these head dims; their launches here are checks, not a path.
WIDE_SHAPES = [(b, h, n, m, d, dtype, causal)
               for d in (192, 256)
               for dtype in (torch.bfloat16, torch.float16, torch.float32)
               for b, h, n, m, causal in ((2, 4, 512, 512, True),
                                          (1, 3, 300, 700, False))]


def wide_kernel_phase(sku):
    """Each entry at d = 192 and 256 against its plain version, at the
    forward's and the backward's tolerances, with its time, bound and the
    library call's time."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    rows = []
    for key in WIDE_SHAPES:
        b, h, n, m, d, dtype, causal = key
        scale = 1.0 / math.sqrt(d)
        q, k, v = _qkv(gen, b, h, n, m, d, dtype, False)
        do = torch.randn((b, n, h, d), generator=gen,
                         device='cuda').to(dtype).transpose(1, 2)
        dt = str(dtype).split('.')[-1]
        shape = [b, h, n, m, d]
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        tol_o, tol_lse = TOLERANCE[dtype]
        _check(o.shape == (b, h, n, d) and bool(torch.isfinite(
            o.float()).all()), 'wide forward output')
        _check(err_o <= tol_o and err_lse <= tol_lse,
               'flash_fwd vs plain at %s %s causal=%s: o err %.3g (tol %g), '
               'lse err %.3g (tol %g)' % (shape, dt, causal, err_o, tol_o,
                                          err_lse, tol_lse))
        bound, bound_by = _flash_bound_ms(b, h, n, m, d, dtype, causal, sku)
        ms = _graph_ms(lambda: fa.flash_fwd_cuda(q, k, v, causal, scale))
        row = {'name': 'flash_fwd', 'shape': shape, 'dtype': dt,
               'causal': causal, 'max_abs_err': err_o, 'err_lse': err_lse,
               'ms': ms,
               'plain_ms': _time_ms(lambda: fa.flash_attention_fwd_ref(
                   q, k, v, causal, scale), iters=3, warmup=1),
               'library_ms': _graph_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q, k, v, is_causal=causal, scale=scale)),
               'bound_ms': bound, 'bound_by': bound_by,
               'share_of_bound': _share_of_bound(
                   bound, ms, 'wide flash_fwd at %s %s' % (shape, dt))}
        _f32_fields(row, dtype, d, _flash_bound_ms(
            b, h, n, m, d, dtype, causal, sku, cuda_cores=True)[0],
            None, (), '')
        print('kernel wide %s' % json.dumps(row), flush=True)
        rows.append(row)

        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        args = (q, k, v, do, lse, delta, causal, scale)
        calls = (('fused', lambda: fa.flash_bwd_fused_cuda(*args)),
                 ('dq', lambda: (fa.flash_bwd_dq_cuda(*args),)),
                 ('dkv', lambda: fa.flash_bwd_dkv_cuda(*args)))
        # every kernel runs before the plain version first does, so no
        # output of the plain version lies freed in the allocator's cache
        # for a kernel's output to be handed (a kernel that wrote nothing
        # would then read as exact)
        outs = {which: call() for which, call in calls}
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_ref(*args)
        refs = {'fused': ref, 'dq': ref[:1], 'dkv': ref[1:]}
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_ref(*args),
                            iters=3, warmup=1)
        lib = _sdpa_bwd_ms(q, k, v, do, causal, scale)
        tol = BWD_TOLERANCE[dtype]
        for which, call in calls:
            got = outs.pop(which)
            errs, shares = _err_share(got, refs[which])
            _check(max(shares) <= tol,
                   'flash_bwd_%s vs plain at %s %s causal=%s: errors %s of '
                   'the largest gradient > %g' % (which, shape, dt, causal,
                                                  shares, tol))
            if which != 'dkv':
                _check_same_dq(call, got[0], 'flash_bwd_%s' % which, shape)
            bound, bound_by = _bwd_bound_ms(b, h, n, m, d, dtype, causal,
                                            which, sku)
            ms = _graph_ms(call)
            row = {'name': 'flash_bwd_%s' % which, 'shape': shape,
                   'dtype': dt, 'causal': causal, 'max_abs_err': max(errs),
                   'err_share': shares, 'tol_share': tol,
                   'ms': ms, 'plain_ms': plain_ms,
                   'library_ms': lib, 'bound_ms': bound,
                   'bound_by': bound_by,
                   'share_of_bound': _share_of_bound(
                       bound, ms, 'wide flash_bwd_%s at %s %s' % (
                           which, shape, dt))}
            _f32_fields(row, dtype, d, _bwd_bound_ms(
                b, h, n, m, d, dtype, causal, which, sku,
                cuda_cores=True)[0], None, (), '')
            print('kernel wide %s' % json.dumps(row), flush=True)
            rows.append(row)
            del got
        del q, k, v, do, o, lse, delta, ref, args, o_ref, lse_ref
        torch.cuda.empty_cache()
    return rows


# (b, h, n, m, d, dtype, causal, strided): every long kernel runs at every
# shape. The first is the long training path's (the attention of one layer
# at batch 2 x 8192, q, k, v strided views of the packed projection).
LONG_MAIN_SHAPE = (2, 12, 8192, 8192, 64, torch.bfloat16, True, True)
LONG_SHAPES = [
    LONG_MAIN_SHAPE,
    (1, 8, 4096, 4096, 128, torch.bfloat16, True, False),
    (1, 4, 4100, 4100, 64, torch.bfloat16, True, False),
    (1, 4, 4096, 4096, 64, torch.float16, True, False),
    (1, 2, 4100, 4100, 128, torch.float32, True, False),
    (1, 4, 4096, 4096, 64, torch.float32, True, False),
    (1, 4, 1000, 4160, 64, torch.bfloat16, False, False),
]


def _err_share(got, refs):
    """(largest error, largest error over the largest reference entry) of
    each output."""
    errs, shares = [], []
    for g, r in zip(got, refs):
        _check(g.shape == r.shape and g.dtype == r.dtype,
               'output shape / dtype')
        _check(bool(torch.isfinite(g.float()).all()), 'output finite')
        err = (g.float() - r.float()).abs().max().item()
        errs.append(err)
        shares.append(err / max(r.float().abs().max().item(), 1e-30))
    return errs, shares


def long_kernel_phase(sku):
    """Each long entry against its plain version, its time beside the
    standard entry's at the same shape, the bound and the library call."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    rows = {}
    for key in LONG_SHAPES:
        b, h, n, m, d, dtype, causal, strided = key
        scale = 1.0 / math.sqrt(d)
        q, k, v = _qkv(gen, b, h, n, m, d, dtype, strided)
        do = torch.randn((b, n, h, d), generator=gen,
                         device='cuda').to(dtype).transpose(1, 2)
        dt = str(dtype).split('.')[-1]
        shape = [b, h, n, m, d]

        # forward
        o, lse = fa.flash_fwd_long_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        tol_o, tol_lse = TOLERANCE[dtype]
        _check(o.shape == (b, h, n, d) and bool(torch.isfinite(
            o.float()).all()), 'long forward output')
        _check(err_o <= tol_o and err_lse <= tol_lse,
               'flash_fwd_long vs plain at %s %s causal=%s: o err %.3g (tol '
               '%g), lse err %.3g (tol %g)' % (shape, dt, causal, err_o,
                                                tol_o, err_lse, tol_lse))
        bound, bound_by = _flash_bound_ms(b, h, n, m, d, dtype, causal, sku)
        ms = _graph_ms(lambda: fa.flash_fwd_long_cuda(q, k, v, causal, scale))
        row = {'shape': shape, 'dtype': dt, 'causal': causal,
               'strided': strided, 'max_abs_err': err_o, 'err_lse': err_lse,
               'ms': ms,
               'eager_ms': _time_ms(lambda: fa.flash_fwd_long_cuda(
                   q, k, v, causal, scale)),
               'std_ms': _graph_ms(lambda: fa.flash_fwd_cuda(
                   q, k, v, causal, scale)),
               'plain_ms': _time_ms(lambda: fa.flash_attention_fwd_ref(
                   q, k, v, causal, scale), iters=3, warmup=1),
               'library_ms': _graph_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q, k, v, is_causal=causal, scale=scale)),
               'bound_ms': bound, 'bound_by': bound_by,
               'share_of_bound': _share_of_bound(
                   bound, ms, 'flash_fwd_long at %s %s' % (shape, dt))}
        _f32_fields(row, dtype, d, _flash_bound_ms(
            b, h, n, m, d, dtype, causal, sku, cuda_cores=True)[0],
            lambda: fa.flash_fwd_long_cuda(q, k, v, causal, scale),
            {'flash_fwd_tf32_kernel'}, 'flash_fwd_long at %s %s' % (shape,
                                                                     dt))
        print('kernel flash_fwd_long %s' % json.dumps(row), flush=True)
        rows['fwd', key] = row
        torch.cuda.empty_cache()

        # backward
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        args = (q, k, v, do, lse, delta, causal, scale)
        ref = fa.flash_attention_bwd_ref(*args)
        torch.cuda.empty_cache()
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_ref(*args),
                            iters=3, warmup=1)
        torch.cuda.empty_cache()
        lib = _sdpa_bwd_ms(q, k, v, do, causal, scale)
        tol = BWD_TOLERANCE[dtype]
        for which, call, std, refs in (
                ('dq', lambda: (fa.flash_bwd_dq_long_cuda(*args),),
                 lambda: fa.flash_bwd_dq_cuda(*args), ref[:1]),
                ('dkv', lambda: fa.flash_bwd_dkv_long_cuda(*args),
                 lambda: fa.flash_bwd_dkv_cuda(*args), ref[1:])):
            got = call()
            torch.cuda.synchronize()
            errs, shares = _err_share(got, refs)
            _check(max(shares) <= tol,
                   'flash_bwd_%s_long vs plain at %s %s causal=%s: errors %s '
                   'of the largest gradient > %g' % (which, shape, dt, causal,
                                                     shares, tol))
            if which == 'dq':
                _check_same_dq(call, got[0], 'flash_bwd_dq_long', shape)
            bound, bound_by = _bwd_bound_ms(b, h, n, m, d, dtype, causal,
                                            which, sku)
            what = 'flash_bwd_%s_long at %s %s' % (which, shape, dt)
            ms = _graph_ms(call)
            row = {'shape': shape, 'dtype': dt, 'causal': causal,
                   'strided': strided, 'max_abs_err': max(errs),
                   'err_share': shares, 'tol_share': tol,
                   'ms': ms, 'eager_ms': _time_ms(call),
                   'std_ms': _graph_ms(std),
                   'plain_ms': plain_ms, 'library_ms': lib,
                   'bound_ms': bound, 'bound_by': bound_by,
                   'share_of_bound': _share_of_bound(bound, ms, what)}
            _f32_fields(row, dtype, d, _bwd_bound_ms(
                b, h, n, m, d, dtype, causal, which, sku,
                cuda_cores=True)[0], call, TF32_BWD_KERNELS[which], what)
            print('kernel flash_bwd_%s_long %s' % (which, json.dumps(row)),
                  flush=True)
            rows[which, key] = row
            del got
        del q, k, v, do, o, lse, delta, ref, args
        torch.cuda.empty_cache()
    return rows


# the JAX package's long-context run (bench.py:102-120 with
# PADDLE_TPU_BENCH_SEQ=8192 and PADDLE_TPU_BENCH_BATCH=2)
LONG_CFG = dict(BENCH_CFG, max_position_embeddings=8192)
LONG_BATCH, LONG_SEQ = 2, 8192


def train_long_phase(sku):
    """Slice 3: the bench's GPT trained at batch 2 x 8192 on the long
    route; then the same step with the long route switched off."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cfg = GPTConfig(**LONG_CFG)
    model, step, ids, labels = _train_setup(
        cfg, 'cuda', SEED, LONG_BATCH, LONG_SEQ, torch.bfloat16)
    losses = [step(ids, labels).item() for _ in range(2)]  # warm-up
    steps = 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = _launches(fa)
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    _check(launches == _want(steps, flash_fwd_long=layers,
                             flash_bwd_dq_long=layers,
                             flash_bwd_dkv_long=layers),
           'long path launches %s over %d steps, want %d of each long '
           'kernel a step and no other' % (launches, steps, layers))
    _check(all(math.isfinite(x) for x in losses), 'long losses finite')
    _check(losses[-1] < losses[0],
           'long loss %.4f after %d steps not below the first %.4f'
           % (losses[-1], len(losses), losses[0]))
    median = sorted(step_ms)[steps // 2]
    tokens = LONG_BATCH * LONG_SEQ
    flops_tok = model.flops_per_token(LONG_SEQ)
    peak_flops = sku[2]['bfloat16']
    mfu = flops_tok * tokens / (median / 1e3) / peak_flops
    print('train long (slice 3): %d params, batch %d x %d, median step '
          '%.2f ms (min %.2f, max %.2f), %.2f samples/s, %.0f tokens/s, '
          '%.1f MFLOP/token, MFU %.4f of %.0f TFLOP/s (least step at peak '
          '%.2f ms), peak memory %.2f GiB, launches over %d steps %s, '
          'losses %s' % (model.num_params(), LONG_BATCH, LONG_SEQ, median,
                         min(step_ms), max(step_ms), LONG_BATCH / median
                         * 1e3, tokens / median * 1e3, flops_tok / 1e6, mfu,
                         peak_flops / 1e12, flops_tok * tokens / peak_flops
                         * 1e3, peak / 2 ** 30, steps, launches,
                         ['%.4f' % x for x in losses]), flush=True)
    wall, dev, top, ops = _profile(lambda: step(ids, labels))
    print('profile train long step: wall %.2f ms, device kernels %.2f ms, '
          'busy share %.3f; top kernels: %s; top aten ops: %s'
          % (wall, dev, dev / wall,
             '; '.join('%s %.2f ms x%d' % t for t in top),
             '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)

    # The 4096 threshold is the TPU's tuning. Both routes launch the same
    # kernels here; the same step on the standard route (two-pass backward),
    # after the long path's launches were read, shows they cost the same.
    long_seq, fa.LONG_SEQ = fa.LONG_SEQ, LONG_SEQ + 1
    try:
        _reset_counts(fa)
        std_ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ids, labels).item()
            std_ms.append((time.perf_counter() - t0) * 1e3)
        _check(fa.flash_bwd_dq_cuda.launches == 4 * layers
               and fa.flash_fwd_long_cuda.launches == 0,
               'standard variant did not take the standard route')
    finally:
        fa.LONG_SEQ = long_seq
    print('train long on the standard route: median step %.2f ms (long '
          'route above: %.2f ms)' % (sorted(std_ms)[2], median), flush=True)
    del model, step
    torch.cuda.empty_cache()
    return {'launches': launches, 'steps': steps, 'median_ms': median}


def _first_divergence(model, prompt, want, got):
    """(index, top-2 logit gap of generate()'s model at that token) of the
    first token where `got` leaves `want`."""
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    ids = torch.tensor([prompt + want[:j]], device='cuda')
    with torch.no_grad():
        top = model(ids)[0, -1].float().topk(2).values
    return j, (top[0] - top[1]).item()


# phases 10 and 13's GPT-2 small: full width, 2 of its 12 layers (since
# slice 20; token identity across engines and replicas does not depend on
# depth)
PARITY_GPT2_LAYERS = 2


def engine_parity_phase():
    """Slice 4, f32: the slot engine, the paged engine with prefix sharing
    and the paged engine with spec_k=4 against sequential generate() on the
    card, GPT-2 small at full width cut to PARITY_GPT2_LAYERS, token for
    token."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    cfg = GPTConfig.gpt2_small()
    cfg.num_layers = PARITY_GPT2_LAYERS
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
    gen = torch.Generator().manual_seed(SEED + 4)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    # six prompts of 5 to 300 tokens; the first and the fourth share a
    # 64-token head (the fourth is admitted after the first has prefilled)
    head = tokens(64)
    prompts = [head + tokens(40), tokens(5), tokens(300), head + tokens(100),
               tokens(23), tokens(150)]
    new = 32
    want = [model.generate(torch.tensor([p], device='cuda'),
                           max_new_tokens=new)[0, len(p):].tolist()
            for p in prompts]
    kw = dict(max_len=512, prefill_chunk=16, decode_block=4)
    engines = [
        ('slot', ContinuousBatchingEngine(model, num_slots=3, **kw)),
        ('paged prefix', PagedContinuousBatchingEngine(
            model, num_seqs=3, page_size=16, **kw)),
        ('paged spec_k=4', PagedContinuousBatchingEngine(
            model, num_seqs=3, page_size=16, spec_k=4, **kw))]
    _reset_counts(fa)
    reports = {}
    for label, eng in engines:
        got = eng.generate(prompts, max_new_tokens=new)
        for i, (w, g) in enumerate(zip(want, got)):
            if w != g:
                j, gap = _first_divergence(model, prompts[i], w, g)
                raise RuntimeError(
                    'check failed: %s engine diverges from generate() on '
                    'prompt %d (%d tokens) at new token %d: %d vs %d, top-2 '
                    'logit gap there %.3g' % (label, i, len(prompts[i]), j,
                                              g[j], w[j], gap))
        reports[label] = eng.metrics.report()
    _check(reports['paged prefix']['prefix_hits'] > 0,
           'the shared head hit no prefix-cache page')
    _check(_launches(fa) == _want(1), 'an engine launched a flash kernel: '
           '%s' % _launches(fa))
    print('engine f32 parity: GPT-2 small (%d layers), 6 prompts of %s '
          'tokens, %d new, greedy: slot, paged (prefix hits %d blocks) and '
          'paged spec_k=4 (accept rate %.3f) token-identical to generate() '
          'on the card, %.1f s'
          % (cfg.num_layers, [len(p) for p in prompts], new,
             reports['paged prefix']['prefix_hits'],
             reports['paged spec_k=4']['spec_accept_rate'],
             time.time() - t0), flush=True)
    del model, engines
    torch.cuda.empty_cache()


# the throughput workload: 64 requests at t = 0, prompts of 64-512 tokens
# from the seed, 128 new tokens, greedy
THROUGHPUT_REQUESTS, THROUGHPUT_NEW = 64, 128


def _serve(eng, prompts, new):
    """Submit every prompt at once, drive to the end; (requests, wall s,
    pages in use at peak)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    peak_pages = 0
    while eng.step():
        peak_pages = max(peak_pages, getattr(eng, 'pages', eng.allocator)
                         .in_use)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(all(len(r.tokens) == new for r in reqs), 'a request came short')
    return reqs, wall, peak_pages


def engine_throughput_phase():
    """Slice 4, bf16: the throughput workload through the slot engine, the
    paged engine with 4 groups sharing a 256-token prefix, and spec_k=4 on
    repetitive prompts."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    t_phase = time.time()
    cfg = GPTConfig.gpt2_small()
    model = GPTForCausalLM(cfg, device='cuda',
                           seed=SEED).eval().bfloat16()
    gen = torch.Generator().manual_seed(SEED + 5)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    lengths = torch.randint(64, 513, (THROUGHPUT_REQUESTS,),
                            generator=gen).tolist()
    prompts = [tokens(n) for n in lengths]
    new = THROUGHPUT_NEW
    slot = ContinuousBatchingEngine(model, num_slots=16, max_len=1024,
                                    prefill_chunk=128, decode_block=4)
    slot.generate(prompts[:2], max_new_tokens=8)     # warm-up
    _reset_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    metrics_before = slot.metrics.report()['tokens']
    reqs, wall, _ = _serve(slot, prompts, new)
    peak = torch.cuda.max_memory_allocated()
    _check(_launches(fa) == _want(1), 'the slot engine launched a flash '
           'kernel: %s' % _launches(fa))
    ttft = sorted(r._first_token_t - r._arrival_t for r in reqs)
    rep = slot.metrics.report()
    _check(rep['tokens'] - metrics_before == THROUGHPUT_REQUESTS * new,
           'token count')
    tl = slot.timeline
    burst = {key: tl.percentile(50, key) for key in ('host_dispatch',
                                                     'device_block')}
    print('engine bf16 slot: %d requests (prompts %d-%d, mean %.0f tokens) '
          '+ %d new at t=0, 16 slots x 1024: %.0f tokens/s (%d tokens in '
          '%.2f s), TTFT p50 %.1f ms p99 %.1f ms, decode burst (4 steps) '
          'p50 %.2f ms (host dispatch %.2f, wait for the card %.2f), peak '
          'memory %.2f GiB' % (
              THROUGHPUT_REQUESTS, min(lengths), max(lengths),
              sum(lengths) / len(lengths), new,
              THROUGHPUT_REQUESTS * new / wall, THROUGHPUT_REQUESTS * new,
              wall, _pct(ttft, 50) * 1e3, _pct(ttft, 99) * 1e3,
              tl.percentile(50) * 1e3, burst['host_dispatch'] * 1e3,
              burst['device_block'] * 1e3, peak / 2 ** 30), flush=True)

    # one burst with all 16 slots decoding, under the profiler
    for p in prompts[:16]:
        slot.add_request(p[:128], max_new_tokens=64)
    while slot.scheduler.queue or any(
            r.state != 'decode' for r in slot.scheduler.resident.values()):
        slot.step()

    def burst_fn():
        with slot._lock, torch.no_grad():
            slot._decode_step()

    wall_ms, dev_ms, top, ops = _profile(burst_fn)
    print('profile decode burst (16 slots, 4 steps): wall %.2f ms, device '
          'kernels %.2f ms, busy share %.3f; top kernels: %s; top aten '
          'ops: %s' % (wall_ms, dev_ms, dev_ms / wall_ms,
                       '; '.join('%s %.2f ms x%d' % t for t in top),
                       '; '.join('%s %.2f ms x%d' % t for t in ops)),
          flush=True)
    slot.run()
    del slot
    torch.cuda.empty_cache()

    # the same requests, 4 groups each sharing a 256-token prefix
    heads = [tokens(256) for _ in range(4)]
    shared = [heads[i % 4] + p[:max(len(p) - 256, 16)]
              for i, p in enumerate(prompts)]
    paged = PagedContinuousBatchingEngine(
        model, num_seqs=16, max_len=1024, page_size=16, prefill_chunk=128,
        decode_block=4)
    _reset_counts(fa)
    reqs, wall, peak_pages = _serve(paged, shared, new)
    rep = paged.metrics.report()
    _check(rep['prefix_hits'] > 0, 'the shared prefixes hit no page')
    print('engine bf16 paged: the same %d requests with 4 groups sharing a '
          '256-token prefix (prompts %d-%d tokens), page 16: %.0f tokens/s '
          '(%.2f s), prompt tokens saved by the prefix cache %d of %d, '
          'pages in use at peak %d of %d, launches %s' % (
              THROUGHPUT_REQUESTS, min(map(len, shared)),
              max(map(len, shared)), THROUGHPUT_REQUESTS * new / wall, wall,
              rep['prefix_hits'] * 16, sum(map(len, shared)), peak_pages,
              paged.num_pages - 1, _launches(fa)), flush=True)
    del paged
    torch.cuda.empty_cache()

    # spec_k=4 on repetitive prompts: a 16-token motif repeated
    spec_prompts = [(tokens(16) * 16)[:96 + 8 * i] for i in range(16)]
    spec = PagedContinuousBatchingEngine(
        model, num_seqs=16, max_len=1024, page_size=16, prefill_chunk=128,
        decode_block=4, spec_k=4)
    reqs, wall, _ = _serve(spec, spec_prompts, 64)
    rep = spec.metrics.report()
    print('engine bf16 paged spec_k=4: 16 repetitive prompts (a 16-token '
          'motif, 96-216 tokens) + 64 new: acceptance rate %.3f (%d of %d '
          'drafts), %.0f tokens/s (%.2f s); whole phase %.1f s' % (
              rep['spec_accept_rate'], rep['spec_accepted'],
              rep['spec_proposed'], 16 * 64 / wall, wall,
              time.time() - t_phase), flush=True)
    del spec, model
    torch.cuda.empty_cache()


# the gateway parity workload: 10 prompts of 3-300 tokens, 16 new, greedy
GATEWAY_PROMPT_LENS = (3, 170, 41, 300, 9, 122, 64, 250, 17, 88)
GATEWAY_NEW = 16


def gateway_parity_phase():
    """Slice 5, f32: the ServingGateway over 2 replicas against one slot
    engine's tokens (the oracle), GPT-2 small at full width cut to
    PARITY_GPT2_LAYERS: a
    sync gateway of slot engines and one of paged engines, a seeded
    arrival schedule with replica 1 partitioned mid-burst (the failover
    count must equal its in-flight count at the partition), and the
    threaded drive. No flash kernel may launch."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.monitor.registry import MetricRegistry
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine,
                                          ServingGateway)
    from paddle_tpu_torch.testing import chaos
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    cfg = GPTConfig.gpt2_small()
    cfg.num_layers = PARITY_GPT2_LAYERS
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
    gen = torch.Generator().manual_seed(SEED + 6)
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=gen).tolist()
               for n in GATEWAY_PROMPT_LENS]
    new = GATEWAY_NEW
    kw = dict(max_len=352, prefill_chunk=32, decode_block=4)

    def slot():
        return ContinuousBatchingEngine(model, num_slots=2, **kw)

    def paged():
        return PagedContinuousBatchingEngine(model, num_seqs=2, page_size=16,
                                             **kw)

    want = slot().generate(prompts, max_new_tokens=new)

    def check(label, got):
        bad = [i for i, (w, g) in enumerate(zip(want, got)) if w != g]
        _check(not bad, '%s gateway diverges from the engine on prompts '
               '%s' % (label, bad))

    def gateway(factory):
        return ServingGateway(factory, replicas=2, registry=MetricRegistry())

    _reset_counts(fa)
    runs = {}
    for label, factory in (('sync slot', slot), ('sync paged', paged)):
        gw = gateway(factory)
        check(label, gw.generate(prompts, max_new_tokens=new))
        runs[label] = [gw.registry.get('gateway_route_total').labels(
            str(i)).value() for i in range(2)]
        _check(all(runs[label]), '%s: a replica took no request: %s'
               % (label, runs[label]))

    # tests/test_serving_gateway.py's exact oracle: a seeded Poisson
    # schedule quantised to gateway steps, replica 1 partitioned when
    # request 5 arrives
    gw = gateway(slot)
    gaps = torch.empty(len(prompts), dtype=torch.float64).exponential_(
        generator=torch.Generator().manual_seed(5))
    arrival_step = (gaps.cumsum(0) / 1.5).floor().long().tolist()
    kill_at = len(prompts) // 2
    reqs, expected, fault, ctx = [], None, None, None
    try:
        i = k = 0
        while i < len(prompts) or any(not r.done for r in reqs):
            while i < len(prompts) and arrival_step[i] <= k:
                if i == kill_at:
                    ctx = chaos.partition(gw.pool[1].endpoint)
                    fault = ctx.__enter__()
                    expected = len([g for g in gw.pool[1].assigned
                                    if len(g.tokens) < new])
                reqs.append(gw.submit(prompts[i], max_new_tokens=new))
                i += 1
            gw.step()
            k += 1
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    failovers = gw.registry.get('gateway_failover_total').value()
    _check(expected is not None and expected > 0,
           'the partition caught no request in flight')
    _check(all(r.done for r in reqs), 'a request did not complete')
    check('partitioned', [r.tokens for r in reqs])
    _check(failovers == expected and fault.fired >= 1,
           'failovers %d, the partitioned replica had %s in flight'
           % (failovers, expected))
    _check(len(gw.failover_log) == 1 and gw.failover_log[0]['replica'] == 1,
           'failover log %s' % gw.failover_log)
    _check(chaos.active_faults() == 0, 'a chaos fault leaked')

    gw = gateway(slot).start()
    try:
        reqs = [gw.submit(p, max_new_tokens=new) for p in prompts]
        _check(all(r.wait(300) for r in reqs), 'a threaded request timed out')
    finally:
        gw.shutdown()
    check('threaded', [r.tokens for r in reqs])
    launches = _launches(fa)
    _check(launches == _want(1), 'the gateway launched a flash kernel: %s'
           % launches)
    print('gateway f32 parity: GPT-2 small (%d layers), %d prompts of %d-%d '
          'tokens, %d new, greedy, 2 replicas x 2 slots: sync slot (routed '
          '%s), sync paged (routed %s), partition of replica 1 (%d in flight '
          '-> %d failovers, %d chaos drops) and threaded drive '
          'token-identical to one engine on the card; flash launches %s; '
          '%.1f s' % (
              cfg.num_layers, len(prompts), min(GATEWAY_PROMPT_LENS),
              max(GATEWAY_PROMPT_LENS), new, runs['sync slot'],
              runs['sync paged'], expected, failovers, fault.fired,
              sum(launches.values()), time.time() - t0), flush=True)
    del model, gw
    torch.cuda.empty_cache()


def _qos_trace(vocab):
    """bench_extra.py's QoS rung traffic at its on-TPU configuration: 32
    requests, Poisson arrivals with a mean gap of 20 ms, a 32/64/96/128
    prompt ladder, premium and bg round robin, and a bg-only trace of 16
    overlaid from the midpoint (bg's arrival rate doubles)."""
    import numpy as np
    from paddle_tpu_torch.capacity.workload import Trace, WorkloadSpec

    def spec(n, tenants):
        return WorkloadSpec(
            requests=n, seed=0, vocab_size=vocab,
            arrival={'process': 'poisson', 'mean_gap_s': 0.02},
            lengths={'dist': 'ladder', 'lens': [32, 64, 96, 128]},
            output={'dist': 'fixed', 'len': 64},
            tenants={'mode': 'round_robin',
                     'tenants': [{'name': t} for t in tenants]})
    main, burst = spec(32, ('premium', 'bg')), spec(16, ('bg',))
    a, b = main.generate(), burst.generate()
    t_mid = float(a.arrival[-1]) * 0.5
    bg_id = a.tenant_names.index('bg')
    arr = np.concatenate([a.arrival, b.arrival + t_mid])
    order = np.argsort(arr, kind='stable')
    trace = Trace(
        arr[order], np.concatenate([a.prompt_len, b.prompt_len])[order],
        np.concatenate([a.new_tokens, b.new_tokens])[order],
        np.concatenate([a.tenant_id,
                        np.full(len(b), bg_id, np.int64)])[order],
        a.tenant_names, np.full(len(order), -1, np.int64),
        np.zeros(len(order), np.int64),
        meta={'vocab_size': vocab, 'spec': {'seed': 0}})
    return trace, main.hash, burst.hash, t_mid


def _qos_policy():
    """The QoS rung's admission policy: premium never rate-limited, bg a
    token bucket of 30 requests/s with a burst of 8."""
    from paddle_tpu_torch.capacity import QosPolicy, TenantClass
    return QosPolicy(classes=[
        TenantClass('premium', priority=1),
        TenantClass('bg', rate=30.0, burst=8, priority=0)])


def _qos_replay(make_gateway, trace):
    """One warm-up and one replay of the QoS trace through a started
    gateway from make_gateway(policy); (gateway, replay result, the run's
    wide events, the warm-up's seconds)."""
    from paddle_tpu_torch.capacity import replay
    from paddle_tpu_torch.monitor.events import (RequestLog,
                                                 set_default_request_log)

    log = RequestLog(capacity=4 * len(trace))
    prev = set_default_request_log(log)
    try:
        gw = make_gateway(_qos_policy())
        t0 = time.time()
        gw.generate(trace.prompts()[:2], max_new_tokens=2, tenant='warmup')
        t_warm = time.time() - t0
        gw.start()
        try:
            res = replay(gw, trace, max_new_tokens=64, timeout=600)
        except BaseException:
            gw.shutdown()
            raise
    finally:
        set_default_request_log(prev)
    events = [e for e in log.events() if e['tenant'] != 'warmup']
    return gw, res, events, t_warm


def _qos_run(model, trace, replicas):
    """The QoS replay through in-process replicas of `model`; (gateway,
    replay result, the run's wide events)."""
    from paddle_tpu_torch.monitor.registry import MetricRegistry
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          ServingGateway)

    def factory():
        return ContinuousBatchingEngine(model, num_slots=8, max_len=256,
                                        prefill_chunk=32, decode_block=8)
    gw, res, events, _ = _qos_replay(
        lambda policy: ServingGateway(factory, replicas=replicas,
                                      admission=policy,
                                      registry=MetricRegistry()), trace)
    return gw, res, events


def _burst_split(gw):
    """Each replica's decode-burst p50 from its StepTimeline, split into
    host dispatch and the wait for the card (the window includes the
    warm-up's bursts)."""
    out = []
    for rep in gw.pool:
        tl = rep.engine.timeline
        out.append('replica %d: %.2f ms (host dispatch %.2f, wait for the '
                   'card %.2f), %d bursts' % (
                       rep.index, tl.percentile(50) * 1e3,
                       tl.percentile(50, 'host_dispatch') * 1e3,
                       tl.percentile(50, 'device_block') * 1e3, tl.steps))
    return '; '.join(out)


def gateway_qos_phase():
    """Slice 5, bf16: bench_extra.py's QoS rung at its on-TPU configuration
    and full width (vocab 30528, 768 x 12 x 12), 2 replicas of 8 slots:
    premium's completed ratio must be 1.0 while bg is shed, every shed
    handle has its 'rejected' wide event, no flash kernel launches; then
    the same replay on 1 replica, and a scrape of the gateway's
    MetricsServer."""
    import re
    import urllib.error
    import urllib.request
    from paddle_tpu_torch.monitor import MetricsServer
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    t0 = time.time()
    cfg = GPTConfig(vocab_size=30528, hidden_size=768, num_layers=12,
                    num_heads=12, max_position_embeddings=1024, dropout=0.0)
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval().bfloat16()
    trace, spec_hash, burst_hash, t_mid = _qos_trace(cfg.vocab_size)
    tenants = trace.tenants()

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    gw, res, events = _qos_run(model, trace, replicas=2)
    launches = _launches(fa)
    peak = torch.cuda.max_memory_allocated()
    server = MetricsServer(registry=gw.registry,
                           readiness=lambda: any(r.ready() for r in gw.pool))
    with server:
        with urllib.request.urlopen(server.url + '/metrics',
                                    timeout=10) as r:
            body = r.read().decode()
        with urllib.request.urlopen(server.url + '/metrics.json',
                                    timeout=10) as r:
            snapshot = json.loads(r.read().decode())
        with urllib.request.urlopen(server.url + '/readyz', timeout=10) as r:
            ready_code = r.status
        gw.shutdown()
        try:
            urllib.request.urlopen(server.url + '/readyz', timeout=10)
            drained_code = 200
        except urllib.error.HTTPError as e:
            drained_code = e.code
    premium = [h for h, t in zip(res.handles, tenants) if t == 'premium']
    shed = sum(1 for h in res.handles if h.error is not None)
    prem_ratio = sum(1 for h in premium if h.done and h.error is None) \
        / float(len(premium))
    _check(prem_ratio == 1.0, 'premium completed ratio %.4f != 1.0 under '
           'the bg burst' % prem_ratio)
    rejected = sum(1 for e in events if e['outcome'] == 'rejected')
    _check(rejected == shed, 'rejected wide events (%d) != shed handles (%d)'
           % (rejected, shed))
    _check(launches == _want(1), 'the gateway launched a flash kernel: %s'
           % launches)
    for family in ('gateway_requests_total', 'gateway_ttft_seconds',
                   'qos_admitted_total', 'qos_rejected_total',
                   'qos_token_bucket_level', 'qos_ttft_seconds',
                   'tenant_requests_total', 'tenant_ttft_seconds'):
        _check('# TYPE %s ' % family in body, '/metrics lacks %s' % family)
    # the label order a scraper reads, with or without a shed sample
    _check(snapshot['qos_rejected_total']['labels'] == ['reason', 'tenant'],
           'qos_rejected_total labels %s'
           % snapshot['qos_rejected_total']['labels'])
    rejected_lines = re.findall(
        r'^qos_rejected_total\{reason="(\w+)",tenant="(\w+)"\} (\S+)$',
        body, re.M)
    _check(sum(float(n) for _, _, n in rejected_lines) == shed,
           '/metrics qos_rejected_total samples %s, shed %d'
           % (rejected_lines, shed))
    _check(ready_code == 200 and drained_code == 503,
           '/readyz answered %d while serving and %d drained'
           % (ready_code, drained_code))
    prem_ttft = [(e['first_token_t'] - e['arrival_t']) * 1e3 for e in events
                 if e['tenant'] == 'premium'
                 and e['first_token_t'] is not None]
    bursts = _burst_split(gw)
    print('gateway bf16 QoS: %d requests (premium + bg round robin, bg '
          'doubling at %.3f s; specs %s + %s), 2 replicas x 8 slots x 256, '
          'chunk 32, burst 8, 64 new: premium completed ratio %.1f, premium '
          'TTFT p50 %.1f ms p99 %.1f ms, shed rate %.4f (%d of %d, reasons '
          '%s), %.0f tokens/s (%d tokens in %.2f s, max submit lag %.1f ms); '
          'decode burst p50 %s; peak memory %.2f GiB; flash launches %s; '
          'scrape %d bytes, /readyz %d then %d drained' % (
              len(trace), t_mid, spec_hash, burst_hash, prem_ratio,
              _pct(prem_ttft, 50), _pct(prem_ttft, 99), shed / len(trace),
              shed, len(trace), sorted({r for r, _, _ in rejected_lines}),
              res.tokens_per_sec, res.tokens, res.wall_s,
              res.max_lag_s * 1e3, bursts, peak / 2 ** 30,
              sum(launches.values()), len(body), ready_code, drained_code),
          flush=True)
    del gw

    _reset_counts(fa)
    gw1, res1, events1 = _qos_run(model, trace, replicas=1)
    gw1.shutdown()
    launches = _launches(fa)
    _check(launches == _want(1), 'the 1-replica gateway launched a flash '
           'kernel: %s' % launches)
    shed1 = sum(1 for h in res1.handles if h.error is not None)
    prem1 = [(e['first_token_t'] - e['arrival_t']) * 1e3 for e in events1
             if e['tenant'] == 'premium' and e['first_token_t'] is not None]
    print('gateway bf16 QoS, 1 replica: %.0f tokens/s (%d tokens in %.2f s), '
          'max submit lag %.1f ms, shed %d, premium TTFT p50 %.1f ms p99 %.1f '
          'ms, decode burst p50 %s; whole phase %.1f s'
          % (res1.tokens_per_sec, res1.tokens, res1.wall_s,
             res1.max_lag_s * 1e3, shed1, _pct(prem1, 50), _pct(prem1, 99),
             _burst_split(gw1), time.time() - t0), flush=True)
    del gw1, model
    torch.cuda.empty_cache()
    return {'2 replicas': res.tokens_per_sec, '1 replica': res1.tokens_per_sec}


# the fabric parity workload: phase 13's prompts, the two longest cut to
# fit the preset's 256-row slots beside 16 new tokens
FABRIC_PROMPT_LENS = (3, 170, 41, 241, 9, 122, 64, 230, 17, 88)
# phase 16 (a)'s workers: the full-width preset, beside phase 14's
# in-process replicas of the same model
FABRIC_PRESET = 'gpt-bench'
# phase 15's: the same preset at 2 of its 12 layers (since slice 23; token
# identity, the rollout and the failover do not depend on depth),
# published as a variant: the artifacts' meta carries the overrides
FABRIC_PARITY_MODEL = {'num_layers': 2}


def _spawn_workers(kwargs_list, timeout=300):
    """Worker processes started together (their bring-ups overlap);
    every started one is killed if any fails."""
    import threading
    from paddle_tpu_torch.serving.fabric import spawn_worker

    handles = [None] * len(kwargs_list)
    errors = []

    def run(i):
        try:
            handles[i] = spawn_worker(timeout=timeout, **kwargs_list[i])
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(kwargs_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for h in handles:
            if h is not None:
                h.cleanup()
        raise errors[0]
    return handles


def _fabric_gateway(handles, **kw):
    """A gateway over one SocketReplica per worker process."""
    from paddle_tpu_torch.monitor.registry import MetricRegistry
    from paddle_tpu_torch.serving import ServingGateway
    from paddle_tpu_torch.serving.fabric import SocketReplica

    gw = ServingGateway(None, replicas=0, registry=MetricRegistry(), **kw)
    for h in handles:
        gw.adopt_replica(SocketReplica(h.endpoint, metrics_url=h.metrics_url,
                                       poll_interval=0.002).connect())
    return gw


def fabric_parity_phase():
    """Slice 6, f32: two worker processes (ModelHost on the card) pull the
    FABRIC_PRESET's seeded weights at FABRIC_PARITY_MODEL's depth (2 of
    its 12 layers, a variant published with the overrides in its meta) as
    v1 from an ArtifactServer by
    fingerprint; a gateway over their SocketReplicas must match one
    in-process slot engine's tokens; rollout() to a differently seeded v2
    mid-burst loses nothing and serves v2 after the flip; a SIGKILLed
    worker's in-flight requests fail over with v2's tokens; a pull with a
    wrong fingerprint raises ArtifactVerifyError. The in-process
    references launch no flash kernel."""
    import argparse
    import os
    import shutil
    import tempfile
    from paddle_tpu_torch.framework import io_save
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import ModelRegistry
    from paddle_tpu_torch.serving.fabric import (ArtifactServer,
                                                 ArtifactVerifyError,
                                                 build_engine, preset,
                                                 publish_preset)
    from paddle_tpu_torch.serving.fabric import worker as fworker
    from paddle_tpu_torch.serving.fabric.presets import build_model
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    root = tempfile.mkdtemp(prefix='chip_smoke_fabric_')
    handles, art, gw = [], None, None
    try:
        reg = ModelRegistry(root=os.path.join(root, 'registry'))
        e1 = publish_preset(reg, FABRIC_PRESET, version='v1', device='cpu',
                            model=FABRIC_PARITY_MODEL)
        cfg = GPTConfig(**dict(preset(FABRIC_PRESET)['model'],
                               **FABRIC_PARITY_MODEL))
        e2 = reg.publish(FABRIC_PRESET, 'v2', GPTForCausalLM(
            cfg, device='cpu', seed=SEED + 15).state_dict(),
            meta=dict(e1.meta))
        t_publish = time.time() - t0
        art = ArtifactServer(reg).start()
        t1 = time.time()
        handles = _spawn_workers([dict(
            artifacts=art.endpoint, cache=os.path.join(root, 'w%d' % i),
            model=FABRIC_PRESET, version='v1',
            fingerprint=e1.fingerprint)
            for i in range(2)])
        t_bound = time.time() - t1

        gen = torch.Generator().manual_seed(SEED + 6)
        prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                 generator=gen).tolist()
                   for n in FABRIC_PROMPT_LENS]
        new = GATEWAY_NEW
        _reset_counts(fa)
        want = {}
        for entry in (e1, e2):
            eng = build_engine(FABRIC_PRESET, model=build_model(
                FABRIC_PRESET, state_dict=io_save.load(entry.path),
                model=FABRIC_PARITY_MODEL))
            want[entry.version] = eng.generate(prompts, max_new_tokens=new)
            del eng
        launches = _launches(fa)
        _check(launches == _want(1), 'the reference engines launched a '
               'flash kernel: %s' % launches)
        _check(want['v1'] != want['v2'], 'v1 and v2 gave the same tokens')
        torch.cuda.empty_cache()

        def check(label, got, ref):
            bad = [i for i, (w, g) in enumerate(zip(ref, got)) if w != g]
            _check(len(got) == len(ref) and not bad,
                   '%s: the fabric diverges from the engine on prompts %s'
                   % (label, bad))

        gw = _fabric_gateway(handles)
        t2 = time.time()
        check('parity', gw.generate(prompts, max_new_tokens=new),
              want['v1'])
        t_first = time.time() - t2
        routed = [int(gw.registry.get('gateway_route_total').labels(
            str(i)).value()) for i in range(2)]
        _check(all(routed), 'a worker took no request: %s' % routed)

        # rollout mid-burst: the first half is in flight at the flip
        before = [gw.submit(p, max_new_tokens=new) for p in prompts[:5]]
        in_flight = sum(1 for r in before if not r.done)
        t3 = time.time()
        summary = gw.rollout(FABRIC_PRESET, 'v2')
        t_rollout = time.time() - t3
        after = [gw.submit(p, max_new_tokens=new) for p in prompts[5:]]
        gw.run()
        _check(in_flight > 0, 'no request was in flight at the flip')
        _check(all(r.done and r.error is None for r in before + after),
               'the rollout lost a request')
        check('before the flip', [r.tokens for r in before], want['v1'][:5])
        check('after the flip', [r.tokens for r in after], want['v2'][5:])
        _check(summary['from_version'] == 'v1' and
               summary['to_version'] == 'v2' and
               summary['replicas'] == [0, 1], 'rollout summary %s' % summary)

        # chaos: phase 13's seeded schedule, worker 0 SIGKILLed when
        # request 5 arrives; its in-flight requests must fail over
        gaps = torch.empty(len(prompts), dtype=torch.float64).exponential_(
            generator=torch.Generator().manual_seed(5))
        arrival_step = (gaps.cumsum(0) / 1.5).floor().long().tolist()
        kill_at = len(prompts) // 2
        reqs, expected = [], None
        i = k = 0
        while i < len(prompts) or any(not r.done for r in reqs):
            while i < len(prompts) and arrival_step[i] <= k:
                if i == kill_at:
                    expected = len([g for g in gw.pool[0].assigned
                                    if len(g.tokens) < new])
                    handles[0].kill()
                    handles[0].wait(30)
                reqs.append(gw.submit(prompts[i], max_new_tokens=new))
                i += 1
            gw.step()
            k += 1
        failovers = int(gw.registry.get('gateway_failover_total').value())
        _check(expected is not None and expected > 0,
               'the SIGKILL caught no request in flight')
        _check(all(r.done and r.error is None for r in reqs),
               'a request did not complete after the SIGKILL')
        check('SIGKILL', [r.tokens for r in reqs], want['v2'])
        _check(failovers == expected, 'failovers %d, the killed worker had '
               '%d in flight' % (failovers, expected))
        crossed = [r.replica_history for r in reqs
                   if len(r.replica_history) > 1]
        _check(len(crossed) == failovers and
               all(h == [0, 1] for h in crossed),
               'failed-over histories %s' % crossed)

        # a pull whose content identity is not the expected one
        t4 = time.time()
        try:
            fworker._build_engine_from_args(argparse.Namespace(
                artifacts=art.endpoint, cache=os.path.join(root, 'wrong'),
                model=FABRIC_PRESET, version='v1',
                fingerprint='0' * 16,
                preset=None, device='cuda', dtype=None))
            refused = None
        except ArtifactVerifyError as e:
            refused = e
        _check(refused is not None, 'a pull with a wrong fingerprint was '
               'accepted')
        t_refuse = time.time() - t4
        print('fabric f32 (slice 6): %s preset at %d layers (f32 artifacts '
              'of %.0f MB), '
              '2 worker processes on the card pulling v1 by fingerprint '
              '(publish %.1f s, both bound in %.1f s, first generate with '
              'the lazy loads %.1f s); %d prompts of %d-%d tokens + %d new '
              'token-identical to one slot engine (routed %s); rollout to '
              'v2 with %d of 5 in flight at the flip: zero loss, v1 tokens '
              'before and v2 after, cache_hits %d cache_misses %d, load_s '
              '%.2f (both workers), rollout %.2f s; SIGKILL of worker 0: %d '
              'in flight -> %d failovers, completed ratio 1.0, v2 tokens; '
              'wrong fingerprint refused (%s, %.1f s); reference flash '
              'launches %d; %.1f s'
              % (FABRIC_PRESET, cfg.num_layers, e1.nbytes / 2 ** 20,
                 t_publish, t_bound, t_first, len(prompts),
                 min(FABRIC_PROMPT_LENS), max(FABRIC_PROMPT_LENS), new,
                 routed, in_flight, summary['cache_hits'],
                 summary['cache_misses'], summary['load_s'], t_rollout,
                 expected, failovers, type(refused).__name__, t_refuse,
                 sum(launches.values()), time.time() - t0), flush=True)
    finally:
        if gw is not None:
            gw.shutdown(timeout=30)
        for h in handles:
            h.cleanup()
        if art is not None:
            art.stop()
        shutil.rmtree(root, ignore_errors=True)


def _worker_bursts(handle):
    """A worker process's decode-burst split from its /metrics.json: the
    StepTimeline's perf_step_phase_seconds per phase, as the mean (sum /
    count, exact) and the median read from the histogram's buckets
    (interpolated within the bucket it falls in)."""
    import urllib.request
    with urllib.request.urlopen(handle.metrics_url + '/metrics.json',
                                timeout=10) as r:
        snap = json.loads(r.read().decode())
    out = {}
    for sample in snap['perf_step_phase_seconds']['samples']:
        phase = sample['labels']['phase']
        n = sample['count']
        if not n:
            continue
        seen, lo, p50 = 0, 0.0, None
        # per-bucket counts, keyed by upper bound (JSON sorts the keys)
        for hi, c in sorted((float(le), c)
                            for le, c in sample['buckets'].items()):
            if p50 is None and c and seen + c >= n / 2.0:
                p50 = lo + (hi - lo) * (n / 2.0 - seen) / c \
                    if hi != float('inf') else lo
            seen += c
            lo = hi
        out[phase] = (n, sample['sum'] / n * 1e3, p50 * 1e3)
    return out


def fabric_qos_phase(inproc):
    """Slice 6, bf16: phase 14's QoS trace, policy and replay through 2
    worker processes, each the full-width preset in bf16 on the card
    (seeded weights): premium's completed ratio must be 1.0 and every
    shed handle has its 'rejected' wide event. Printed beside phase 14's
    in-process 2- and 1-replica tokens/s from this run."""
    from paddle_tpu_torch.serving.fabric import preset

    t0 = time.time()
    vocab = preset(FABRIC_PRESET)['model']['vocab_size']
    trace, _, _, t_mid = _qos_trace(vocab)
    tenants = trace.tenants()
    handles = _spawn_workers([dict(preset=FABRIC_PRESET,
                                   dtype='bfloat16')] * 2)
    t_bound = time.time() - t0
    try:
        gw, res, events, t_warm = _qos_replay(
            lambda policy: _fabric_gateway(handles, admission=policy),
            trace)
        gw.shutdown(timeout=60)
        bursts = [_worker_bursts(h) for h in handles]
    finally:
        for h in handles:
            h.cleanup()
    premium = [h for h, t in zip(res.handles, tenants) if t == 'premium']
    shed = sum(1 for h in res.handles if h.error is not None)
    prem_ratio = sum(1 for h in premium if h.done and h.error is None) \
        / float(len(premium))
    _check(prem_ratio == 1.0, 'fabric premium completed ratio %.4f != 1.0'
           % prem_ratio)
    rejected = sum(1 for e in events if e['outcome'] == 'rejected')
    _check(rejected == shed, 'fabric rejected wide events (%d) != shed '
           'handles (%d)' % (rejected, shed))
    _check(res.completed + shed == len(trace), 'fabric replay: %d completed '
           '+ %d shed of %d' % (res.completed, shed, len(trace)))
    prem_ttft = [(e['first_token_t'] - e['arrival_t']) * 1e3 for e in events
                 if e['tenant'] == 'premium'
                 and e['first_token_t'] is not None]
    split = '; '.join(
        'worker %d: %d bursts, host dispatch mean %.2f ms p50 %.2f, wait for '
        'the card mean %.2f ms p50 %.2f' % (
            i, b['host_dispatch'][0], b['host_dispatch'][1],
            b['host_dispatch'][2], b['device_block'][1],
            b['device_block'][2])
        for i, b in enumerate(bursts))
    print('fabric bf16 QoS (slice 6): %d requests (bg doubling at %.3f s), '
          '2 worker processes x 8 slots x 256 (%s preset, bf16), chunk 32, '
          'burst 8, 64 new: premium completed ratio %.1f, premium TTFT p50 '
          '%.1f ms p99 %.1f ms, shed rate %.4f (%d of %d), %.0f tokens/s '
          '(%d tokens in %.2f s, max submit lag %.1f ms); in-process in '
          'this run: 2 replicas %.0f tokens/s, 1 replica %.0f tokens/s; '
          'cold bring-up %.1f s (both workers bound %.1f s + first tokens '
          '%.1f s); decode bursts %s; %.1f s'
          % (len(trace), t_mid, FABRIC_PRESET, prem_ratio,
             _pct(prem_ttft, 50), _pct(prem_ttft, 99), shed / len(trace),
             shed, len(trace), res.tokens_per_sec, res.tokens, res.wall_s,
             res.max_lag_s * 1e3, inproc['2 replicas'], inproc['1 replica'],
             t_bound + t_warm, t_bound, t_warm, split, time.time() - t0),
          flush=True)


# phase 16 (b)'s models: 2 of the rung's 12 layers (since slice 20; the
# registry, pager, rollout and router it checks do not depend on depth)
MULTIMODEL_LAYERS = 2


def multimodel_phase():
    """Slice 6, bf16: bench_extra.py's multi-model rung at its on-TPU
    configuration (3 models and the head model's v2, vocab 30528, 768 x
    12 heads, cut to MULTIMODEL_LAYERS of 12 layers, 2 in-process
    ModelHost replicas of 8 slots x 256, chunk 32,
    burst 8, 32 zipf-mixed Poisson requests with a mean gap of 20 ms,
    rollout() of the head model at the midpoint): completed ratio 1.0,
    per-model wide events equal to the workload's mix, no compile-cache
    miss, and a budgeted pager whose resident bytes never pass the budget
    and whose evictions equal the LRU oracle. No flash kernel launches."""
    import shutil
    import tempfile
    from paddle_tpu_torch.capacity.replay import replay
    from paddle_tpu_torch.capacity.workload import WorkloadSpec
    from paddle_tpu_torch.framework import io_save
    from paddle_tpu_torch.monitor.events import (RequestLog,
                                                 set_default_request_log)
    from paddle_tpu_torch.monitor.registry import MetricRegistry
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          ModelAffinityRouter, ModelHost,
                                          ModelRegistry, ServingGateway)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    t0 = time.time()
    cfg = GPTConfig(vocab_size=30528, hidden_size=768,
                    num_layers=MULTIMODEL_LAYERS, num_heads=12,
                    max_position_embeddings=1024, dropout=0.0)
    lens, mnt, n_req = (32, 64, 96, 128), 64, 32
    max_len, chunk, block, num_slots = 256, 32, 8, 8
    mean_gap, n_models, swap_at = 0.02, 3, 16
    head = 'model_000'
    root = tempfile.mkdtemp(prefix='chip_smoke_registry_')
    try:
        reg = ModelRegistry(root=root)
        for i in range(n_models):
            reg.publish('model_%03d' % i, 'v1', GPTForCausalLM(
                cfg, device='cpu', seed=100 + i).state_dict())
        reg.publish(head, 'v2', GPTForCausalLM(
            cfg, device='cpu', seed=200).state_dict())
        nbytes = reg.entry(head, 'v1').nbytes
        t_publish = time.time() - t0

        def engine_for(entry):
            m = GPTForCausalLM(cfg, device='cuda')
            m.load_state_dict(io_save.load(entry.path))
            m.bfloat16().eval()
            return ContinuousBatchingEngine(
                m, num_slots=num_slots, max_len=max_len,
                prefill_chunk=chunk, decode_block=block)

        spec = WorkloadSpec(
            requests=n_req, seed=0, vocab_size=cfg.vocab_size,
            arrival={'process': 'poisson', 'mean_gap_s': mean_gap},
            lengths={'dist': 'ladder', 'lens': list(lens)},
            output={'dist': 'fixed', 'len': mnt},
            models={'mode': 'zipf', 'count': n_models})
        trace = spec.generate()

        def host_factory():
            # every model plus the rollout's incoming version co-resident
            return ModelHost(reg, engine_for,
                             byte_budget=(n_models + 2) * nbytes,
                             max_len=max_len)

        log = RequestLog(capacity=4 * n_req)
        prev_log = set_default_request_log(log)
        _reset_counts(fa)
        try:
            gw = ServingGateway(host_factory, replicas=2,
                                registry=MetricRegistry(),
                                router=ModelAffinityRouter())
            t1 = time.time()
            gw.generate(trace.prompts()[:2], max_new_tokens=2, model=head,
                        tenant='warmup')
            t_cold = time.time() - t1
            gw.start()
            rollout = {}

            def swap(i):
                if i == swap_at:
                    rollout.update(gw.rollout(head, 'v2'))
            try:
                res = replay(gw, trace, max_new_tokens=mnt, timeout=600,
                             before_submit=swap)
            finally:
                gw.shutdown(timeout=60)
            events = [e for e in log.events() if e['tenant'] != 'warmup']
        finally:
            set_default_request_log(prev_log)
        launches = _launches(fa)
        _check(launches == _want(1), 'the multi-model rung launched a flash '
               'kernel: %s' % launches)
        _check(res.completed_ratio == 1.0, 'the rollout lost requests: '
               'completed ratio %.4f' % res.completed_ratio)
        _check(rollout.get('to_version') == 'v2', 'the mid-burst rollout '
               'did not run: %s' % rollout)
        _check(int(rollout.get('cache_misses') or 0) == 0,
               'the warm bring-up compiled: %s' % rollout)
        mix = {}
        for e in events:
            mix[e['model']] = mix.get(e['model'], 0) + 1
        _check(mix == trace.model_mix(), 'wide-event attribution %s != the '
               "trace's model mix %s" % (mix, trace.model_mix()))

        # the weight-paging proof: a budget that holds 2 of the 3 models
        t2 = time.time()
        pager = ModelHost(reg, engine_for,
                          byte_budget=2 * nbytes + nbytes // 2)
        oracle, evicted, peak = [], [], 0
        for i in list(range(n_models)) * 2:
            key = ('model_%03d' % i, 'v1')
            pager.load(*key)
            if key in oracle:
                oracle.remove(key)
            while len(oracle) >= 2:
                evicted.append(oracle.pop(0))
            oracle.append(key)
            _check(pager.resident_bytes <= pager.byte_budget,
                   'resident bytes %d over the budget %d'
                   % (pager.resident_bytes, pager.byte_budget))
            peak = max(peak, pager.resident_bytes)
        names = ['model_%03d' % i for i in range(n_models)]
        evictions = {m: int(pager._m_evictions.labels(m).value())
                     for m in names}
        want = {m: sum(1 for k in evicted if k[0] == m) for m in names}
        _check(evictions == want, 'evictions %s != the LRU oracle %s'
               % (evictions, want))
        pager.shutdown()
        t_pager = time.time() - t2
        print('multi-model rung (slice 6): %d models (%d layers) + %s v2 '
              '(bf16, %.0f MB '
              'f32 artifacts each, publish %.1f s), 2 in-process ModelHost '
              'replicas x %d slots x %d, chunk %d, burst %d, %d zipf-mixed '
              'requests (mix %s), %d new, rollout of %s at request %d: '
              'completed ratio %.1f, %.0f tokens/s (%d tokens in %.2f s, max '
              'submit lag %.1f ms), cold first generate %.2f s, rollout '
              'load_s %.2f (both replicas), cache_hits %d cache_misses %d; '
              'pager (budget 2.5 artifacts): peak resident %.0f MB of %.0f, '
              'evictions %s = the LRU oracle (%.1f s); flash launches %d; '
              '%.1f s'
              % (n_models, cfg.num_layers, head, nbytes / 2 ** 20, t_publish,
                 num_slots,
                 max_len, chunk, block, n_req, trace.model_mix(), mnt, head,
                 swap_at, res.completed_ratio, res.tokens_per_sec,
                 res.tokens, res.wall_s, res.max_lag_s * 1e3, t_cold,
                 rollout['load_s'], rollout['cache_hits'],
                 rollout['cache_misses'], peak / 2 ** 20,
                 pager.byte_budget / 2 ** 20, evictions, t_pager,
                 sum(launches.values()), time.time() - t0), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


# Slice 13: collective training. (a) phase 6's bench GPT through
# fleet.fleet_train_step under each strategy on the one-rank mesh (NCCL),
# against the plain TrainStep from the same initial weights; (b) the ring
# attention's block steps over every block of a P-block ring in one
# process, against plain full attention.
FLEET_STEPS = 5
# 'mp' and 'sharding3' run in phase 26 (a) as one composition (ZeRO-3
# over 'mp' placements with per-block recompute and amp), not here
FLEET_STRATEGIES = ('dp', 'sp_ring', 'sp_ulysses')
# (seq, P, causal): blocks of 512 (fused backward), 2048 (two-pass), 4096
# (the long entries)
RING_CASES = [(n, p, causal) for n, p in ((1024, 2), (8192, 4), (8192, 2))
              for causal in (True, False)]
RING_B, RING_H, RING_D = 2, 12, 64
# the merged loss against the plain step's: the bf16 tolerance of the
# kernel rows (TOLERANCE) as a share of the loss
FLEET_LOSS_RTOL = 2e-2
# the parameters after FLEET_STEPS steps against the plain step's, as a
# share of the plain step's update: AdamW moves each parameter by ~lr
# whatever its grad's size, so a grad near 0 that flips sign under
# another order of sums moves it 2 lr; 0.05 of the update allows a few
FLEET_UPDATE_RTOL = 5e-2


# the suffixes of a strategy name: '_amp' adds bf16 AMP; '_clip' trains
# with AdamW under ClipGradByNorm(FLEET_CLIP_NORM) (each parameter's
# whole norm), '_sgdclip' with SGD at FLEET_SGD_CLIP[1] under
# ClipGradByNorm(FLEET_SGD_CLIP[0]), a norm below the weights' grads, so
# the clip factor sets each weight's move (AdamW's update hides a grad's
# scale), '_lamb' with Lamb (each parameter's whole trust ratio)
FLEET_CLIP_NORM = 1.0
FLEET_SGD_CLIP = (0.05, 1.0)


def _split_name(name):
    """(strategy base, amp, optimizer kind) of a strategy name."""
    opt = None
    for kind in ('sgdclip', 'clip', 'lamb'):
        if name.endswith('_' + kind):
            name, opt = name[:-len(kind) - 1], kind
    amp = name.endswith('_amp')
    return (name[:-4] if amp else name), amp, opt


def _fleet_optimizer(kind, params):
    """AdamW at TRAIN_LR; with kind 'clip' under ClipGradByNorm, 'lamb':
    Lamb at TRAIN_LR, 'sgdclip': SGD under ClipGradByNorm (FLEET_SGD_CLIP)."""
    from paddle_tpu_torch.nn import ClipGradByNorm
    from paddle_tpu_torch.optimizer import SGD, AdamW, Lamb
    if kind == 'lamb':
        return Lamb(learning_rate=TRAIN_LR, parameters=params)
    if kind == 'sgdclip':
        return SGD(learning_rate=FLEET_SGD_CLIP[1], parameters=params,
                   grad_clip=ClipGradByNorm(FLEET_SGD_CLIP[0]))
    return AdamW(learning_rate=TRAIN_LR, parameters=params,
                 grad_clip=ClipGradByNorm(FLEET_CLIP_NORM)
                 if kind == 'clip' else None)


def _fleet_strategy(name, world=1):
    """fleet's strategy `name` over `world` ranks: its axis takes them all
    ('dp', 'sharding1' / 'sharding3', 'mp', 'sp_<mode>', 'pp' (GPipe),
    'pp_1f1b', 'ep' (a MoE model's experts)); a 'dp_' before the name puts
    dp 2 beside it, the axis taking the rest. 'mp_sharding3': ZeRO-3 over
    tensor-parallel placements, mp 2 x sharding (the rest) on an even
    world, both axes of size 1 on one rank; 'mp_sharding3_recompute' adds
    per-block recompute. The suffixes of _split_name add amp and name the
    optimizer."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    deg = {'dp_degree': 1, 'mp_degree': 1, 'pp_degree': 1,
           'sharding_degree': 1, 'sp_degree': 1, 'ep_degree': 1}
    base, amp, _ = _split_name(name)
    if base.startswith('dp_'):
        deg['dp_degree'], world, base = 2, world // 2, base[3:]
    if base.startswith('mp_sharding3'):
        mp = 2 if world > 1 and world % 2 == 0 else 1
        deg['mp_degree'], deg['sharding_degree'] = mp, world // mp
        s.tensor_parallel = True
        s.sharding = True
        s.sharding_configs['stage'] = 3
        s.recompute = base.endswith('_recompute')
        s.hybrid_configs = deg
        s.amp = amp
        return s
    axis = ('dp' if base == 'dp' else 'mp' if base == 'mp' else
            'sharding' if base.startswith('sharding') else
            'pp' if base.startswith('pp') else 'ep' if base == 'ep' else
            'sp')
    deg[axis + '_degree'] = world
    s.hybrid_configs = deg
    if base == 'pp_1f1b':
        s.pipeline = True
        s.pipeline_configs['schedule_mode'] = '1F1B'
    if axis == 'sharding':
        s.sharding = True
        s.sharding_configs['stage'] = int(base[-1])
    elif axis == 'mp':
        s.tensor_parallel = True
    elif axis == 'sp':
        s.sequence_parallel = True
        s.sequence_parallel_configs['mode'] = base[3:]
    if amp:
        s.amp = True
    return s


def _fresh_bench_model(base):
    """A copy of `base` (phase 6's initial bf16 weights) whose parameters
    keep their placement hints (copy_layer)."""
    from paddle_tpu_torch.nn.layer.layers import copy_layer
    return copy_layer(base)


def _whole(p):
    from torch.distributed.tensor import DTensor
    return (p.full_tensor() if isinstance(p, DTensor) else p).detach()


def _fleet_run(name, base, ids, labels, hcg=None, ref=None, world=1,
               opt_kind=None):
    """FLEET_STEPS steps of `name` ('plain': the bare TrainStep, with the
    optimizer `opt_kind` names) over `world` ranks from a copy of `base`:
    losses, per-step launches, p50 step ms, peak GiB; the final
    parameters, or (with the plain run's final parameters `ref`) their
    _update_rel against them. Without `hcg`, fleet.init makes the
    strategy's."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from torch.distributed.tensor import DTensor

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = _fresh_bench_model(base)
    opt = _fleet_optimizer(opt_kind or _split_name(name)[2],
                           model.parameters())
    if name == 'plain':
        step = TrainStep(model, model.loss, opt)
    else:
        strategy = _fleet_strategy(name, world)
        if hcg is None:
            fleet.init(is_collective=True, strategy=strategy)
            hcg = fleet.get_hybrid_communicate_group()
        step = fleet.fleet_train_step(model, model.loss, opt,
                                      strategy=strategy, hcg=hcg)
    placed = {n: p.placements for n, p in model.named_parameters()
              if isinstance(p, DTensor)}
    losses, step_ms, launches = [], [], []
    for _ in range(FLEET_STEPS):
        _reset_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(_launches(fa))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {'losses': losses, 'launches': launches, 'placed': placed,
           'p50_ms': sorted(step_ms[1:])[len(step_ms[1:]) // 2],
           'first_ms': step_ms[0], 'peak_gib': peak}
    final = {n: _whole(p) for n, p in model.named_parameters()}
    if ref is None:
        out['final'] = final
    else:
        out.update(_update_rel(final, ref, base))
    del step, model, opt, final
    torch.cuda.empty_cache()
    return out


def _update_rel(final, ref, base):
    """update_rel of parameters `final` against `ref`, both grown from
    `base`'s: |final - ref| / |ref - base| over the parameters `final`
    holds (a pipeline stage's: its own), and the three parameters with the
    largest share of their own update."""
    init = dict(base.named_parameters())
    # a pipeline stage holds only its own parameters
    names = [n for n in ref if n in final]
    num = {n: (final[n].float() - ref[n].float()).square().sum()
           for n in names}
    den = {n: (ref[n].float() - init[n].float()).square().sum()
           for n in names}
    worst = sorted(((n, (num[n] / den[n].clamp_min(1e-30)).sqrt().item())
                    for n in names), key=lambda x: -x[1])[:3]
    return {'update_rel': (sum(num.values()) / sum(den.values())).sqrt()
            .item(), 'worst_params': worst}


def _fleet_check(name, run, plain, update_rtol=FLEET_UPDATE_RTOL):
    """Hold a strategy's run against the plain step's: the losses within
    FLEET_LOSS_RTOL, the parameters within update_rtol (update_rel)."""
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(run['losses'], plain['losses']))
    run['loss_rel'] = worst
    _check(worst <= FLEET_LOSS_RTOL and
           all(math.isfinite(x) for x in run['losses']),
           '%s losses %s vs the plain step %s (rtol %g)'
           % (name, run['losses'], plain['losses'], FLEET_LOSS_RTOL))
    _check(run['update_rel'] <= update_rtol,
           '%s parameters after %d steps off the plain step\'s: '
           'update_rel %.4g (tol %g; the largest shares %s)'
           % (name, FLEET_STEPS, run['update_rel'], update_rtol,
              run['worst_params']))


def _collectives_check():
    """The collective API over NCCL at world 1 on CUDA tensors."""
    import paddle_tpu_torch.distributed as dist
    x = torch.arange(4.0, device='cuda')
    dist.all_reduce(x)
    got = []
    dist.all_gather(got, x)
    dist.broadcast(x, src=0)
    parts = dist.alltoall([x.clone()])
    y = dist.collective.p2p_shift(x, dist.get_group(0))
    dist.barrier()
    ok = (x.tolist() == [0.0, 1.0, 2.0, 3.0] and len(got) == 1 and
          torch.equal(parts[0], x) and torch.equal(y, x))
    _check(ok, 'collectives over NCCL at world 1')
    return torch.distributed.get_backend()


def fleet_phase(card):
    """Phase 22 (a): the bench GPT under fleet on the one-rank mesh."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**BENCH_CFG)
    base = GPTForCausalLM(cfg, device='cuda', seed=SEED).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                        generator=gen).cuda()
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen).cuda()
    fleet.init(is_collective=True, strategy=_fleet_strategy('dp'))
    hcg = fleet.get_hybrid_communicate_group()
    backend = _collectives_check()
    runs = {'plain': _fleet_run('plain', base, ids, labels, hcg)}
    layers = cfg.num_layers
    ref = runs['plain'].pop('final')
    for name in FLEET_STRATEGIES:
        run = runs[name] = _fleet_run(name, base, ids, labels, hcg, ref)
        want = _want(1, flash_fwd=layers, flash_bwd_fused=layers)
        _check(all(x == want for x in run['launches']),
               '%s launches %s a step, want %s' % (name, run['launches'],
                                                   want))
        _fleet_check(name, run, runs['plain'])
    del base
    torch.cuda.empty_cache()
    for name in ('plain',) + FLEET_STRATEGIES:
        run = runs[name]
        print('fleet %s [%s]: losses %s (worst rel vs plain %.3g, tol %g), '
              'parameters after %d steps vs the plain step\'s: update_rel '
              '%.4g (tol %g), launches a step %s, step p50 %.2f ms (first '
              '%.1f ms), peak %.2f GiB, DTensor params %d'
              % (name, card, ['%.4f' % x for x in run['losses']],
                 run.get('loss_rel', 0.0), FLEET_LOSS_RTOL, FLEET_STEPS,
                 run.get('update_rel', 0.0), FLEET_UPDATE_RTOL,
                 {k: v for k, v in run['launches'][-1].items() if v},
                 run['p50_ms'], run['first_ms'], run['peak_gib'],
                 len(run['placed'])), flush=True)
    return {'runs': runs, 'backend': backend, 'layers': layers}


def _attention_ref(q, k, v, do, causal, scale):
    """Plain full attention in f32 (heads in groups of 4 to bound memory):
    (o, lse, dq, dk, dv) from q, k, v, do [b, h, n, d]."""
    outs = [[] for _ in range(5)]
    for h0 in range(0, q.shape[1], 4):
        qs, ks, vs = (t[:, h0:h0 + 4].float().requires_grad_()
                      for t in (q, k, v))
        s = torch.matmul(qs, ks.transpose(-1, -2)) * scale
        if causal:
            n = s.shape[-1]
            keep = torch.ones(n, n, dtype=torch.bool,
                              device=s.device).tril()
            s = s.masked_fill(~keep, -1e30)
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        o = torch.matmul(torch.exp(s - lse), vs)
        o.backward(do[:, h0:h0 + 4].float())
        for acc, t in zip(outs, (o.detach(), lse.detach(), qs.grad, ks.grad,
                                 vs.grad)):
            acc.append(t)
        del s, o, lse
    return [torch.cat(t, dim=1) for t in outs]


def ring_block_phase():
    """Phase 22 (b): the ring's forward and backward block steps over every
    block of a P-block ring (the blocks the distributed ring rotates are
    indexed here), merged o and lse, dq, dk, dv against plain attention."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ring_attention as ra

    gen = torch.Generator(device='cuda').manual_seed(SEED + 22)
    rows, total = [], collections.Counter()
    for n, parts, causal in RING_CASES:
        c = n // parts
        scale = 1.0 / math.sqrt(RING_D)
        q, k, v, do = (torch.randn(RING_B, RING_H, n, RING_D, device='cuda',
                                   generator=gen).to(torch.bfloat16)
                       for _ in range(4))

        def blk(t, i):
            return t[:, :, i * c:(i + 1) * c]

        def seen(r):
            # the other blocks rank r's queries see
            return [s for s in range(parts) if s != r and
                    (not causal or s < r)]
        _reset_counts(fa)
        o_parts, lse_parts = [], []
        for r in range(parts):
            o, lse = ra.ring_flash_fwd_block(blk(q, r), blk(k, r), blk(v, r),
                                             None, None, causal, scale)
            for s in seen(r):
                o, lse = ra.ring_flash_fwd_block(blk(q, r), blk(k, s),
                                                 blk(v, s), o, lse, False,
                                                 scale)
            o_parts.append(o.to(torch.bfloat16))
            lse_parts.append(lse)
        dq_parts, dk_acc, dv_acc = [], [None] * parts, [None] * parts
        for r in range(parts):
            o_r, lse_r, do_r = o_parts[r], lse_parts[r], blk(do, r)
            dq, dk_acc[r], dv_acc[r] = ra.ring_flash_bwd_block(
                blk(q, r), blk(k, r), blk(v, r), o_r, lse_r, do_r, causal,
                scale, None, dk_acc[r], dv_acc[r])
            for s in seen(r):
                dq, dk_acc[s], dv_acc[s] = ra.ring_flash_bwd_block(
                    blk(q, r), blk(k, s), blk(v, s), o_r, lse_r, do_r, False,
                    scale, dq, dk_acc[s], dv_acc[s])
            dq_parts.append(dq)
        torch.cuda.synchronize()
        launches = {k_: v_ for k_, v_ in _launches(fa).items() if v_}
        total.update(launches)
        o_ref, lse_ref, dq_ref, dk_ref, dv_ref = _attention_ref(
            q, k, v, do, causal, scale)
        got_o = torch.cat(o_parts, dim=2).float()
        got_lse = torch.cat(lse_parts, dim=2)
        # the accumulators are [b, rows, h, d]
        grads = [torch.cat(g, dim=1).transpose(1, 2)
                 for g in (dq_parts, dk_acc, dv_acc)]
        # o, dq, dk, dv as shares of the largest element of their
        # reference (at n = 8192 a typical |o| is near 0.02, the bf16
        # kernels' absolute o tolerance)
        err_o, *errs = [((g - ref).abs().max() / ref.abs().max()).item()
                        for g, ref in zip([got_o] + grads,
                                          (o_ref, dq_ref, dk_ref, dv_ref))]
        err_lse = (got_lse - lse_ref).abs().max().item()
        tol_lse = TOLERANCE[torch.bfloat16][1]
        tol_g = BWD_TOLERANCE[torch.bfloat16]
        _check(err_o <= tol_g and err_lse <= tol_lse and max(errs) <= tol_g,
               'ring blocks n=%d P=%d causal=%s: o err %.3g, dq/dk/dv %s '
               '(tol %g of the largest), lse %.3g (tol %g)'
               % (n, parts, causal, err_o, ['%.3g' % e for e in errs],
                  tol_g, err_lse, tol_lse))
        blocks = sum(1 + len(seen(r)) for r in range(parts))
        fwd = 'flash_fwd_long' if c >= fa.LONG_SEQ else 'flash_fwd'
        bwd = (('flash_bwd_dq_long', 'flash_bwd_dkv_long')
               if c >= fa.LONG_SEQ else ('flash_bwd_fused',)
               if c <= fa.FUSED_BWD_MAX_SEQ
               else ('flash_bwd_dq', 'flash_bwd_dkv'))
        want = {fwd: blocks}
        want.update({name: blocks for name in bwd})
        _check(launches == want, 'ring blocks n=%d P=%d causal=%s launched '
               '%s, want %s' % (n, parts, causal, launches, want))
        row = {'n': n, 'P': parts, 'block': c, 'causal': causal,
               'blocks': blocks, 'err_o': err_o, 'err_lse': err_lse,
               'err_dq_dk_dv': errs, 'launches': launches}
        rows.append(row)
        print('ring blocks: n=%d P=%d (blocks of %d) causal=%s: %d blocks, '
              'o err %.3g of the largest, lse err %.3g, dq/dk/dv err %s of '
              'the largest, '
              'launches %s' % (n, parts, c, causal, blocks, err_o, err_lse,
                               ['%.3g' % e for e in errs], launches),
              flush=True)
        del q, k, v, do, o_ref, dq_ref, dk_ref, dv_ref, grads
        torch.cuda.empty_cache()
    return {'rows': rows, 'launches': dict(total)}


def slice13_phases(card):
    """Phase 22: collective training on the one-rank mesh and the ring's
    block math."""
    t0 = time.time()
    out = {'fleet': fleet_phase(card), 'ring': ring_block_phase()}
    out['seconds'] = time.time() - t0
    runs = out['fleet']['runs']
    print('phase 22 (slice 13) [%s]: %s' % (card, json.dumps({
        'backend': out['fleet']['backend'],
        'step_p50_ms': {k: round(r['p50_ms'], 2) for k, r in runs.items()},
        'peak_gib': {k: round(r['peak_gib'], 2) for k, r in runs.items()},
        'loss_rel_vs_plain': {k: r.get('loss_rel', 0.0)
                              for k, r in runs.items()},
        'update_rel_vs_plain': {k: r.get('update_rel', 0.0)
                                for k, r in runs.items()},
        'ring_launches': out['ring']['launches'],
        'seconds': round(out['seconds'], 1)})), flush=True)
    return out


# -- slice 14: BERT-class training ------------------------------------------
# BERT-base (Devlin et al. 2018, §3 and App. A.2: L=12, H=768, A=12,
# intermediate 4H, gelu, vocab 30522 (WordPiece), 512 positions, 2 segment
# types, dropout 0.1 on the hidden states and the attention probabilities)
BERT_CFG = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, intermediate_size=3072,
                hidden_act='gelu', hidden_dropout_prob=0.1,
                attention_probs_dropout_prob=0.1, max_position_embeddings=512,
                type_vocab_size=2)
BERT_BATCH, BERT_SEQ, BERT_LR = 32, 512, 1e-4
BERT_MLM_SHARE = 0.15
# Transformer-base (Vaswani et al. 2017, Table 3): d_model 512, 8 heads,
# ff 2048, relu; cut to 2 + 2 layers
XF_CFG = dict(d_model=512, nhead=8, dim_feedforward=2048, activation='relu',
              num_encoder_layers=2, num_decoder_layers=2, dropout=0.0)
XF_SRC, XF_TGT, XF_BATCH = 1024, 512, 2


def _bert_batch(vocab, batch, seq, seed):
    """BERT pretraining inputs without padding: ids in [1, vocab) (0 is the
    pad id), sentence A then B, MLM labels at ~15% of the positions (-100
    elsewhere) and NSP labels."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, vocab, (batch, seq), generator=gen)
    types = torch.zeros(batch, seq, dtype=torch.long)
    types[:, seq // 2:] = 1
    picked = torch.rand(batch, seq, generator=gen) < BERT_MLM_SHARE
    mlm = torch.where(picked, torch.randint(1, vocab, (batch, seq),
                                            generator=gen), -100)
    nsp = torch.randint(0, 2, (batch,), generator=gen)
    return ids, types, mlm, nsp


def _kernel_modes(fa, seen):
    """Wrap the flash launch helpers so each launch adds (entry, causal) to
    the Counter `seen`; returns the undo."""
    fwd, bwd = fa._fwd_launch, fa._bwd_launch

    def fwd_seen(entry, q, k, v, causal, scale):
        seen[entry, bool(causal)] += 1
        return fwd(entry, q, k, v, causal, scale)

    def bwd_seen(entry, operands, dims, outs, ds, scale, causal):
        seen[entry, bool(causal)] += 1
        return bwd(entry, operands, dims, outs, ds, scale, causal)

    fa._fwd_launch, fa._bwd_launch = fwd_seen, bwd_seen

    def undo():
        fa._fwd_launch, fa._bwd_launch = fwd, bwd
    return undo


def _timed_train(step, inputs, labels, warmup, steps):
    """(losses, step ms of the timed steps, peak bytes, launches) of
    `warmup` + `steps` calls of `step`; launches and the peak are the
    timed steps' own."""
    from paddle_tpu_torch.ops import flash_attention as fa

    losses = [step(inputs, labels).item() for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(fa)
    ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(inputs, labels)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    return losses, ms, torch.cuda.max_memory_allocated(), _launches(fa)


def bert_pretrain_phase(card, sku):
    """23 (a): BertForPretraining at BERT-base, the fused MLM loss, bf16,
    batch 32 x 512, AdamW lr 1e-4 through TrainStep."""
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.bert import BertForPretraining

    # phase 22's FSDP2 run leaves tensors whose storage it freed among the
    # garbage, so _collect_garbage's census cannot read them
    gc.collect()
    torch.cuda.empty_cache()
    model = BertForPretraining(fused_mlm=True, device='cuda', seed=SEED,
                               **BERT_CFG).to(torch.bfloat16)
    step = TrainStep(model, model.loss,
                     AdamW(learning_rate=BERT_LR,
                           parameters=model.parameters()))
    ids, types, mlm, nsp = (t.cuda() for t in _bert_batch(
        BERT_CFG['vocab_size'], BERT_BATCH, BERT_SEQ, SEED))
    inputs, labels = (ids, types), (mlm, nsp)
    steps = 10
    losses, ms, peak, launches = _timed_train(step, inputs, labels, 2, steps)
    # BertModel builds its pad mask on every call, so attention takes the
    # masked path: no flash kernel launches
    _check(launches == _want(steps),
           'BERT launches %s over %d steps, want none' % (launches, steps))
    _check(all(math.isfinite(x) for x in losses), 'BERT losses finite')
    _check(losses[-1] < losses[0], 'BERT loss %.4f after %d steps not below '
           'the first %.4f' % (losses[-1], len(losses), losses[0]))
    median = sorted(ms)[steps // 2]
    tokens = BERT_BATCH * BERT_SEQ
    flops_tok = model.flops_per_token(BERT_SEQ)
    peak_flops = sku[2]['bfloat16']
    wall, dev, top, ops = _profile(lambda: step(inputs, labels))
    out = {'params': sum(p.numel() for p in model.parameters()),
           'median_ms': median, 'min_ms': min(ms), 'max_ms': max(ms),
           'tokens_per_s': tokens / median * 1e3,
           'samples_per_s': BERT_BATCH / median * 1e3,
           'mflop_per_token': flops_tok / 1e6,
           'mfu': flops_tok * tokens / (median / 1e3) / peak_flops,
           'peak_gib': peak / 2 ** 30, 'busy': dev / wall,
           'mlm_positions': int((mlm != -100).sum()),
           'launches': launches, 'steps': steps,
           'losses': [round(x, 4) for x in losses]}
    print('phase 23a BERT-base pretraining [%s]: %s' % (card, json.dumps(
        out)), flush=True)
    print('profile BERT step: wall %.2f ms, device kernels %.2f ms, busy '
          'share %.3f; top kernels: %s; top aten ops: %s'
          % (wall, dev, dev / wall,
             '; '.join('%s %.2f ms x%d' % t for t in top),
             '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)
    del model, step
    torch.cuda.empty_cache()
    return out


def bert_parity_phase(card):
    """23 (b): BERT-base cut to 2 layers, dropout 0, f32 (TF32 off): 3
    TrainStep calls on the card against the same steps on the CPU, and the
    sequence classifier's logits."""
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.bert import (
        BertForPretraining, BertForSequenceClassification)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(BERT_CFG, num_hidden_layers=2, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    batch = _bert_batch(cfg['vocab_size'], 2, BERT_SEQ, SEED + 2)
    losses = {}
    for dev in ('cuda', 'cpu'):
        model = BertForPretraining(fused_mlm=True, device=dev, seed=SEED,
                                   **cfg)
        step = TrainStep(model, model.loss,
                         AdamW(learning_rate=BERT_LR,
                               parameters=model.parameters()))
        ids, types, mlm, nsp = (t.to(dev) for t in batch)
        losses[dev] = [step((ids, types), (mlm, nsp)).item()
                       for _ in range(3)]
        del model, step
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses['cuda'],
                                                 losses['cpu']))
    _check(rel <= 1e-5, 'BERT f32 losses %s vs CPU %s (rel %.3g > 1e-5)'
           % (losses['cuda'], losses['cpu'], rel))
    logits = {}
    for dev in ('cuda', 'cpu'):
        clf = BertForSequenceClassification(num_classes=3, device=dev,
                                            seed=SEED, **cfg).eval()
        with torch.no_grad():
            logits[dev] = clf(batch[0].to(dev), batch[1].to(dev)).cpu()
    err = (logits['cuda'] - logits['cpu']).abs().max().item()
    _check(err <= 1e-5, 'classifier logits differ by %.3g > 1e-5' % err)
    out = {'losses': losses['cuda'], 'cpu_losses': losses['cpu'],
           'loss_rel': rel, 'logits_err': err}
    print('phase 23b BERT f32 parity [%s]: %s' % (card, json.dumps(out)),
          flush=True)
    torch.cuda.empty_cache()
    return out


def encoder_phase(card):
    """23 (c): nn.TransformerEncoder at BERT-base width without a mask
    (attn_dropout 0): the non-causal flash forward and fused backward, 12
    of each a step, bf16, batch 32 x 512; then nn.Transformer at
    Transformer-base width, f32, against the CPU."""
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    gen = torch.Generator().manual_seed(SEED)
    layers, hidden = BERT_CFG['num_hidden_layers'], BERT_CFG['hidden_size']
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        hidden, BERT_CFG['num_attention_heads'],
        BERT_CFG['intermediate_size'], dropout=0.1, activation='gelu',
        attn_dropout=0.0, device='cuda', generator=gen),
        layers).to(torch.bfloat16)
    src = torch.randn(BERT_BATCH, BERT_SEQ, hidden, generator=gen).to(
        'cuda', torch.bfloat16)
    target = torch.randn(BERT_BATCH, BERT_SEQ, hidden, generator=gen).cuda()

    def mse(out, want):
        return ((out.float() - want) ** 2).mean()

    step = TrainStep(enc, mse, AdamW(learning_rate=BERT_LR,
                                     parameters=enc.parameters()))
    modes = collections.Counter()
    undo = _kernel_modes(fa, modes)
    try:
        steps = 5
        losses, ms, peak, launches = _timed_train(step, (src,), (target,), 2,
                                                  steps)
    finally:
        undo()
    _check(launches == _want(steps, flash_fwd=layers,
                             flash_bwd_fused=layers),
           'encoder launches %s over %d steps, want %d forward and %d fused '
           'backward a step' % (launches, steps, layers, layers))
    _check(set(modes) == {('flash_fwd', False), ('flash_bwd_fused', False)},
           'encoder launches were not all non-causal: %s' % dict(modes))
    _check(losses[-1] < losses[0], 'encoder loss did not fall: %s' % losses)
    wall, dev, top, ops = _profile(lambda: step((src,), (target,)))
    encoder = {'median_ms': sorted(ms)[steps // 2], 'peak_gib': peak / 2 ** 30,
               'busy': dev / wall, 'launches': launches, 'steps': steps,
               'losses': [round(x, 5) for x in losses]}
    print('profile encoder step: wall %.2f ms, device kernels %.2f ms, busy '
          'share %.3f; top kernels: %s; top aten ops: %s'
          % (wall, dev, dev / wall,
             '; '.join('%s %.2f ms x%d' % t for t in top),
             '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)
    del enc, step, src, target
    torch.cuda.empty_cache()

    # nn.Transformer, f32: the unmasked encoder self-attention at 1024 and
    # the cross-attention (n = 512, m = 1024) take flash forward and the
    # two-pass backward; the decoder's self-attention is masked. The CPU
    # runs first. A ReLU input within f32 rounding of 0 may take the other
    # branch on the card, and one such element moves a weight gradient's
    # entry by a few percent (a sum over 1024 tokens), so the card's run
    # takes each ReLU's branches from the CPU run (a * [a_cpu > 0]): both
    # then compute one piecewise-linear function, whose gradients the
    # kernels must give within their tolerance. The branches the card's
    # own inputs would have taken otherwise are counted (flips).
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    branches = []

    def recording(a):
        branches.append(a.detach() > 0)
        return torch.relu(a)

    def pinned(a):
        keep = branches[pinned.calls].to(a.device)
        pinned.calls += 1
        pinned.flips += int((keep != (a.detach() > 0)).sum())
        return a * keep

    pinned.calls = pinned.flips = 0
    for dev in ('cpu', 'cuda'):
        g = torch.Generator().manual_seed(SEED + 3)
        model = tnn.Transformer(**XF_CFG, device=dev, generator=g)
        for layer in list(model.encoder.layers) + list(model.decoder.layers):
            layer.activation = recording if dev == 'cpu' else pinned
        d = XF_CFG['d_model']
        s = torch.randn(XF_BATCH, XF_SRC, d, generator=g).to(dev)
        t = torch.randn(XF_BATCH, XF_TGT, d, generator=g).to(dev)
        w = torch.randn(XF_BATCH, XF_TGT, d, generator=g).to(dev)
        mask = model.generate_square_subsequent_mask(XF_TGT)
        _reset_counts(fa)
        modes.clear()
        undo = _kernel_modes(fa, modes)
        try:
            out = model(s, t, tgt_mask=mask)
            (out * w).mean().backward()
        finally:
            undo()
        if dev == 'cuda':
            torch.cuda.synchronize()
            runs['launches'] = _launches(fa)
            runs['modes'] = dict(modes)
        runs[dev] = (out.detach().cpu(), {
            k: p.grad.cpu() for k, p in model.named_parameters()})
        del model
    want = _want(1, flash_fwd=4, flash_bwd_dq=4, flash_bwd_dkv=4)
    _check(runs['launches'] == want,
           'nn.Transformer launches %s, want %s' % (runs['launches'], want))
    _check(all(not causal for _, causal in runs['modes']),
           'nn.Transformer flash launches not all non-causal: %s'
           % runs['modes'])
    (out_c, g_c), (out_h, g_h) = runs['cuda'], runs['cpu']
    scale = out_h.abs().max().item()
    out_err = (out_c - out_h).abs().max().item() / scale
    # The gradients as one output, as a kernel row holds its dq, dk, dv: the
    # largest error over the largest reference gradient of the model.
    # Each parameter's error over its own largest entry is reported beside
    # it: where a gradient is a cancellation it reads higher (a key
    # projection's weight gradient is X^T dk with dk summing to 0 over the
    # keys; its bias's exact gradient is 0, so that ratio is noise over
    # noise and is left out).
    top = max(g.abs().max().item() for g in g_h.values())
    grad_err = max((g_c[k] - g_h[k]).abs().max().item() for k in g_h) / top
    own = {k: (g_c[k] - g_h[k]).abs().max().item() /
           g_h[k].abs().max().item()
           for k in g_h if not k.endswith('k_proj.bias')}
    worst = max(own, key=own.get)
    _check(out_err <= 1e-4 and grad_err <= 1e-4,
           'nn.Transformer card vs CPU: output %.3g, gradients %.3g of the '
           'largest (tol 1e-4)' % (out_err, grad_err))
    transformer = {'launches': runs['launches'], 'out_err': out_err,
                   'grad_err': grad_err, 'worst_param': worst,
                   'worst_param_err': own[worst], 'relu_flips': pinned.flips,
                   'relu_elements': sum(b.numel() for b in branches),
                   'modes': {'%s causal=%s' % k: v
                             for k, v in runs['modes'].items()}}
    out = {'encoder': encoder, 'transformer': transformer}
    print('phase 23c encoder / Transformer [%s]: %s' % (card, json.dumps(
        out)), flush=True)
    torch.cuda.empty_cache()
    return out


def slice14_phases(card, sku):
    """Phase 23: BERT-class training."""
    t0 = time.time()
    out = {'bert': bert_pretrain_phase(card, sku),
           'parity': bert_parity_phase(card),
           'encoder': encoder_phase(card)}
    out['seconds'] = time.time() - t0
    print('phase 23 (slice 14) [%s]: %.1f s' % (card, out['seconds']),
          flush=True)
    return out


# -- phase 24: slice 15, the observability plane ------------------------------

# the bench step's flash kernels by name, as _check_kernel_names reads them:
# the forward's, and the fused backward's two (dk/dv, then dq)
FLASH_TRAIN_KERNELS = ('flash_fwd_tma_kernel', 'flash_bwd_kv_tma_kernel',
                       'flash_bwd_dq_tma_kernel')
# phase 24 (c): a batch no earlier phase compiles GPT-2 small at
WATCHDOG_BATCH = 3


def _lost_launches(trace):
    """(launches, lost) of a Chrome trace: the host's kernel launches
    (runtime or driver events named *LaunchKernel*), and those whose
    correlation id has no device kernel, as (position in launch order,
    host us after the first launch)."""
    events = trace['traceEvents']
    launches = sorted((e for e in events
                       if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                       and 'LaunchKernel' in e.get('name', '')),
                      key=lambda e: e['ts'])
    found = {e['args'].get('correlation') for e in events
             if e.get('cat') == 'kernel'}
    t0 = launches[0]['ts'] if launches else 0.0
    lost = [(i, e['ts'] - t0) for i, e in enumerate(launches)
            if e['args'].get('correlation') not in found]
    return len(launches), lost


def profiler_phase(card):
    """(a) paddle_tpu_torch.profiler.Profiler around two steps of phase 6's
    bf16 bench TrainStep: the device trace holds 12 + 12 flash launches a
    step by kernel name, a RecordEvent region lands both in the trace and
    in the tracer's FlightRecorder, and merge_traces of the trace and the
    recorder's Chrome export loads back through load_profiler_result."""
    import shutil
    import tempfile

    from paddle_tpu_torch import profiler as prof_mod
    from paddle_tpu_torch.monitor import tracing
    from paddle_tpu_torch.monitor.registry import MetricRegistry
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    t0 = time.time()
    cfg = GPTConfig(**BENCH_CFG)
    model, step, ids, labels = _train_setup(
        cfg, 'cuda', SEED, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)
    step(ids, labels).item()                       # warm-up
    tracer = tracing.Tracer(registry=MetricRegistry())
    prev = tracing.set_default_tracer(tracer)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_prof_')
    try:
        rank_dir = os.path.join(tmp, 'rank0')
        host_dir = os.path.join(tmp, 'host')
        # step 0 is the trace's warm-up, steps 1 and 2 are recorded after
        # the profiler's pad (the launches a trace can lose at the start
        # of its window, cupti_probe.py)
        _reset_counts(fa)
        prof = prof_mod.Profiler(log_dir=rank_dir, scheduler=(1, 3))
        with prof:
            for _ in range(3):
                with prof_mod.RecordEvent('chip_smoke.train_step'):
                    loss = step(ids, labels)
                loss.item()
                prof.step()
        launches = _launches(fa)
        steps, layers = 2, cfg.num_layers
        _check(launches == _want(steps + 1, flash_fwd=layers,
                                 flash_bwd_fused=layers),
               'profiled steps launched %s' % launches)
        device = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        flash = {k: sum(n for name, n in device.items() if k in name)
                 for k in FLASH_TRAIN_KERNELS}
        _check(all(v == steps * layers for v in flash.values()),
               'the profiled trace holds %s flash kernels over %d steps, '
               'want %d of each (its device events: %s)'
               % (flash, steps, steps * layers,
                  [(n[:80], c) for n, c in device.most_common(12)]))
        with open(prof.trace_path) as fh:
            trace = json.load(fh)
        n_launch, lost = _lost_launches(trace)
        regions = [e for e in trace['traceEvents']
                   if e.get('name') == 'chip_smoke.train_step']
        spans = [sp for sp in tracer.recorder.spans()
                 if sp['name'] == 'chip_smoke.train_step']
        _check(len(regions) >= steps and len(spans) == steps + 1,
               'RecordEvent: %d trace events (want %d recorded steps), %d '
               'flight spans (want %d)' % (len(regions), steps, len(spans),
                                           steps + 1))
        tracer.recorder.export_chrome(os.path.join(host_dir,
                                                   'host.trace.json'))
        merged = prof_mod.merge_traces(
            [rank_dir, host_dir], os.path.join(tmp, 'merged', 'all.json'))
        (found,) = prof_mod.load_profiler_result(os.path.dirname(merged))
        with open(found) as fh:
            lanes = {e['args']['name'] for e in json.load(fh)['traceEvents']
                     if e.get('name') == 'process_name'}
        _check(any(n.startswith('rank 0: ') for n in lanes) and
               any(n.startswith('rank 1: ') for n in lanes),
               'merged lanes %s' % sorted(lanes))
        # the steps' kernels alone: the trace's kernel events without the
        # profiler's pad of device sleeps (spin_kernel)
        kernels = [e for e in trace['traceEvents']
                   if e.get('cat') == 'kernel']
        pad = [e['dur'] for e in kernels if 'spin_kernel' in e['name']]
        device_ms = (sum(e['dur'] for e in kernels) - sum(pad)) / 1e3 / steps
    finally:
        tracing.set_default_tracer(prev)
        shutil.rmtree(tmp, ignore_errors=True)
    print('phase 24 (a) profiler: 2 bf16 bench steps recorded (after a '
          'warm-up step) by paddle_tpu_torch.profiler on %s: flash kernels '
          '%s (%d a step each), %d host launches (the first %d the '
          'profiler\'s pad: %d of its kernels in the trace, %.2f ms) of '
          'which %d have no device kernel %s, device kernels %.2f ms a '
          'step, RecordEvent in the trace (%d events) and the flight '
          'recorder (%d spans), merged lanes %s; %.1f s'
          % (card, flash, layers, n_launch, prof_mod.PAD_LAUNCHES,
             len(pad), sum(pad) / 1e3, len(lost), lost[:8], device_ms,
             len(regions), len(spans), sorted(lanes), time.time() - t0),
          flush=True)
    return model, ids, labels, {'flash': flash, 'device_ms': device_ms,
                                'launches': n_launch, 'lost': len(lost)}


def _hand_flops(cfg, batch, seq):
    """The bench step's FLOPs from its configuration: every layer's four
    GEMMs (q/k/v, out, fc1, fc2: 12 h^2 multiply-adds a token) forward and
    backward (6 a multiply-add), the fused LM head's four GEMMs (forward;
    the logits again, dx and dw), and the flash products as the kernel
    bounds count them (2 + 5 of 2 * d a visible pair)."""
    from paddle_tpu_torch.monitor.perf import costmodel
    h, layers, vocab = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    heads = cfg.num_heads
    d = h // heads
    tokens = batch * seq
    gemms = layers * 6 * tokens * 12 * h * h
    head = 4 * 2 * tokens * h * vocab
    flash = layers * (
        costmodel.flash_fwd_flops(batch, heads, seq, seq, d, True) +
        costmodel.flash_bwd_flops(batch, heads, seq, seq, d, True, 'fused'))
    return gemms + head + flash


def costmodel_phase(card, model, ids, labels, train):
    """(b) Model.summary_perf of the bench GPT at full width (bf16): its
    FLOPs within 1% of the hand count, its MFU from phase 6's measured
    step, neither MFU nor the roofline share above MAX_SHARE_OF_BOUND."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.monitor.registry import MetricRegistry
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    t0 = time.time()
    cfg = GPTConfig(**BENCH_CFG)
    hapi = tpt.Model(model)
    hapi.prepare(optimizer=AdamW(learning_rate=TRAIN_LR,
                                 parameters=model.parameters()),
                 loss=model.loss)
    before = torch.cuda.memory_allocated()
    reg = MetricRegistry()
    est = hapi.summary_perf(ids, labels, step_seconds=train['median_ms'] / 1e3,
                            registry=reg)
    grew = (torch.cuda.memory_allocated() - before) / 2 ** 30
    want = _hand_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    rel = abs(est['flops'] - want) / want
    _check(rel <= 0.01, 'cost model %.6g FLOPs against the hand count '
           '%.6g (%.4f apart)' % (est['flops'], want, rel))
    for key in ('mfu_est', 'roofline_frac'):
        _check(est[key] <= MAX_SHARE_OF_BOUND,
               '%s %.4f above %.2f: the count or the peak is wrong'
               % (key, est[key], MAX_SHARE_OF_BOUND))
    _check(reg.get('perf_mfu_est').value() == est['mfu_est'],
           'the perf_mfu_est gauge does not carry the estimate')
    print('phase 24 (b) cost model: Model.summary_perf of the bench GPT '
          '(bf16, batch %d x %d) on %s: %.6g FLOPs (hand count %.6g, %.2e '
          'apart), %.6g bytes accessed (unfused), intensity %.1f FLOP/B '
          '(ridge %.1f, %s-bound), ideal step %.2f ms at the %s peak (%.0f '
          'TFLOP/s, %.2f TB/s); phase 6 median %.2f ms: mfu_est %.4f, '
          'roofline_frac %.4f; device memory grew %.3f GiB; %.1f s' % (
              TRAIN_BATCH, TRAIN_SEQ, card, est['flops'], want, rel,
              est['bytes_accessed'], est['arithmetic_intensity'],
              est['ridge_intensity'], est['roofline_bound'],
              est['ideal_step_s'] * 1e3, est['platform'],
              est['peak_flops'] / 1e12, est['peak_bandwidth'] / 1e12,
              train['median_ms'], est['mfu_est'], est['roofline_frac'],
              grew, time.time() - t0), flush=True)
    return {k: est[k] for k in ('flops', 'bytes_accessed', 'mfu_est',
                                'roofline_frac', 'ideal_step_s',
                                'roofline_bound')}


def watchdog_phase(kept):
    """(c) A CompileWatchdog on phase 19 (b)'s f32 GPT-2 small Predictor
    (its program compiled there): after declare_warmup() three runs of the
    same shape count 0 recompiles; a new batch size counts 1, attributed
    to this file, and under strict=True raises RecompileError from the
    run."""
    from paddle_tpu_torch.monitor import tracing
    from paddle_tpu_torch.monitor.perf import CompileWatchdog, RecompileError
    from paddle_tpu_torch.monitor.registry import MetricRegistry

    t0 = time.time()
    pred, ids_np = kept
    reg = MetricRegistry()
    tracer = tracing.Tracer(registry=reg)
    wd = CompileWatchdog(registry=reg, tracer=tracer, name='chip_smoke')
    try:
        compiles = pred.compile_count()
        wd.declare_warmup('phase 19 (b) compiled')
        for _ in range(3):
            pred.run([ids_np])
        _check(wd.recompiles == 0 and pred.compile_count() == compiles,
               'same-shape runs after the barrier: %d recompiles'
               % wd.recompiles)
        wd.strict = True
        small = ids_np[:WATCHDOG_BATCH]
        try:
            pred.run([small])
            raised = False
        except RecompileError:
            raised = True
        _check(raised, 'strict mode did not raise on a new batch size')
        rec = wd.records[-1] if wd.records else {}
        _check(wd.recompiles == 1 and
               os.path.basename(str(rec.get('callsite')).split(':')[0]) ==
               os.path.basename(__file__),
               'new batch: %d recompiles, attributed to %s'
               % (wd.recompiles, rec.get('callsite')))
        ring = [sp for sp in tracer.recorder.spans()
                if sp['name'] == 'perf.recompile']
        _check(len(ring) == 1, 'recompile records in the flight ring: %d'
               % len(ring))
        report = wd.report()
    finally:
        wd.close()
    print('phase 24 (c) watchdog on the f32 GPT-2 small Predictor: 0 '
          'recompiles over 3 same-shape runs after the barrier; batch %d: '
          '%d recompile at %s (signature %s, %.1f s), RecompileError under '
          'strict; stage counts %s; %.1f s' % (
              WATCHDOG_BATCH, wd.recompiles, rec['callsite'],
              rec['signature'], rec['duration_s'], report['counts'],
              time.time() - t0), flush=True)
    return {'recompiles': wd.recompiles, 'compile_s': rec['duration_s'],
            'counts': report['counts']}


def serving_observability_phase(card):
    """(d) Two in-process GPT-2 small replicas (f32, full width) behind a
    ServingGateway wired to the observability plane: attach_fleet (plus
    the gateway's own registry) on a FleetCollector, an AlertManager with
    a threshold rule on fleet_target_up and a burn-rate rule over the
    merged gateway TTFT (federated_burn_source feeding the autoscaler's
    burn), a RequestLog with a rotating sink, a Tracer with a recorder and
    retention, a MetricsServer. A chaos partition of replica 1 (and of
    its scrape target) mid-flight is failed over: the threshold rule fires
    once with one flight dump, the failed-over requests' traces are
    retained; /fleet, /alerts and /requests answer JSON; the tokens equal
    one engine's, with no flash launch."""
    import shutil
    import tempfile
    import urllib.request

    from paddle_tpu_torch.monitor import events, tracing
    from paddle_tpu_torch.monitor.alerts import (AlertManager, BurnRateRule,
                                                 ThresholdRule,
                                                 federated_burn_source)
    from paddle_tpu_torch.monitor.federation import FleetCollector
    from paddle_tpu_torch.monitor.registry import MetricRegistry
    from paddle_tpu_torch.monitor.server import MetricsServer
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          ServingGateway)
    from paddle_tpu_torch.testing import chaos
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_obs_')
    reg = MetricRegistry()
    tracer = tracing.Tracer(
        registry=reg,
        recorder=tracing.FlightRecorder(dump_dir=os.path.join(tmp, 'flight'),
                                        registry=reg),
        retention=tracing.TraceRetention(registry=reg))
    log = events.RequestLog(sink_path=os.path.join(tmp, 'requests.jsonl'),
                            max_sink_bytes=4096, sink_backups=2,
                            registry=reg)
    prev_tracer = tracing.set_default_tracer(tracer)
    prev_log = events.set_default_request_log(log)
    srv = None
    try:
        cfg = GPTConfig.gpt2_small()
        model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
        gen = torch.Generator().manual_seed(SEED + 24)
        prompts = [torch.randint(0, cfg.vocab_size, (n,),
                                 generator=gen).tolist()
                   for n in GATEWAY_PROMPT_LENS]
        new = GATEWAY_NEW
        kw = dict(max_len=352, prefill_chunk=32, decode_block=4)

        def slot():
            return ContinuousBatchingEngine(model, num_slots=2, **kw)

        want = slot().generate(prompts, max_new_tokens=new)
        log.clear()
        gw = ServingGateway(slot, replicas=2, registry=reg)
        fc = FleetCollector(registry=reg, tracer=tracer)
        gw.attach_fleet(fc)
        fc.add_target('gateway', registry=gw.registry)
        slo = reg.get('gateway_ttft_seconds').buckets[10]
        gw.burn_source = federated_burn_source(fc, slo, window_s=30.0)
        mgr = AlertManager(
            [ThresholdRule('replica-1-down', 'fleet_target_up', 0.5, op='<',
                           labels={'instance': 'gw-replica-1'}),
             BurnRateRule('gateway-ttft-burn', 'gateway_ttft_seconds', slo,
                          objective=0.95, windows=((30.0, 5.0, 1.0),))],
            source=fc.merged, registry=reg, recorder=tracer.recorder)
        srv = MetricsServer(registry=reg, tracer=tracer, collector=fc,
                            alerts=mgr, events=log).start()
        fc.scrape()
        mgr.evaluate()
        _check(mgr.firing() == [], 'alerts firing before the fault: %s'
               % mgr.firing())
        _reset_counts(fa)
        target = next(t for t in fc.targets()
                      if t.instance == 'gw-replica-1')
        kill_at = len(prompts) // 2
        reqs, expected, faults, edges = [], None, [], []
        try:
            for i, p in enumerate(prompts):
                if i == kill_at:
                    for ep in (gw.pool[1].endpoint, target.endpoint):
                        ctx = chaos.partition(ep)
                        faults.append((ctx, ctx.__enter__()))
                    expected = len([g for g in gw.pool[1].assigned
                                    if len(g.tokens) < new])
                reqs.append(gw.submit(p, max_new_tokens=new))
                gw.step()
                if i >= kill_at:
                    fc.scrape()
                    edges += mgr.evaluate()
            while any(not r.done for r in reqs):
                gw.step()
            fc.scrape()
            edges += mgr.evaluate()
            burn = gw.burn_source(time.monotonic())
        finally:
            for ctx, _ in faults:
                ctx.__exit__(None, None, None)
        _check(chaos.active_faults() == 0, 'a chaos fault leaked')
        bad = [i for i, (w, r) in enumerate(zip(want, reqs))
               if w != r.tokens]
        _check(not bad, 'the observed gateway diverges from one engine on '
               'prompts %s' % bad)
        failovers = reg.get('gateway_failover_total').value()
        _check(expected and failovers == expected,
               'failovers %d, replica 1 had %s in flight'
               % (failovers, expected))
        fired = [e for e in edges if e == ('replica-1-down', 'firing')]
        dumps = [f for f in os.listdir(os.path.join(tmp, 'flight'))
                 if f.startswith('flight_alert_firing_')]
        _check(len(fired) == 1 and len(dumps) == 1,
               'the threshold rule fired %d times with %d flight dumps '
               '(edges %s)' % (len(fired), len(dumps), edges))
        moved = [r for r in reqs if r.failovers]
        kept = [tracer.retention.get(r._eng_req._span.trace_id)
                for r in moved]
        reasons = {x for r in moved for t in tracer.retention.traces()
                   if t['trace_id'] == r._eng_req._span.trace_id
                   for x in t['reasons']}
        _check(moved and all(kept) and 'failover' in reasons,
               'failed-over traces retained: %d of %d (reasons %s)'
               % (sum(1 for k in kept if k), len(moved), reasons))
        bodies = {}
        for route in ('/fleet', '/alerts', '/requests?min_failovers=1'):
            with urllib.request.urlopen(srv.url + route, timeout=10) as r:
                bodies[route.split('?')[0]] = json.loads(r.read().decode())
        _check(bodies['/fleet']['targets']['gw-replica-1']['up'] is False
               and bodies['/alerts']['firing'] == ['replica-1-down'] and
               bodies['/requests']['count'] == len(moved),
               'routes: fleet %s, alerts firing %s, %d failed-over events'
               % (bodies['/fleet']['targets'], bodies['/alerts']['firing'],
                  bodies['/requests']['count']))
        rotations = reg.get('request_sink_rotations_total').value()
        _check(rotations >= 1 and len(log.events()) == len(prompts),
               'sink rotations %d, %d events' % (rotations,
                                                 len(log.events())))
        launches = _launches(fa)
        _check(launches == _want(1), 'the gateway launched a flash kernel: '
               '%s' % launches)
        wide = log.events()
    finally:
        if srv is not None:
            srv.stop()
        tracing.set_default_tracer(prev_tracer)
        events.set_default_request_log(prev_log)
        shutil.rmtree(tmp, ignore_errors=True)
    print('phase 24 (d) serving observability on %s: GPT-2 small f32, 2 '
          'replicas, %d prompts, replica 1 partitioned at request %d (%d in '
          'flight -> %d failovers), tokens identical to one engine; alert '
          'edges %s, %d flight dump on the firing edge, %d failed-over '
          'traces retained, %d sink rotations, federated burn %.3f; /fleet '
          '/alerts /requests answered; flash launches %d; %.1f s' % (
              card, len(prompts), kill_at, expected, failovers, edges,
              len(dumps), len(moved), rotations, burn,
              sum(launches.values()), time.time() - t0), flush=True)
    del model, gw
    torch.cuda.empty_cache()
    return wide


def simulator_phase(wide):
    """(e) ServiceModel.from_events fitted on (d)'s wide events, then the
    same trace simulated: the K-S statistic and the p50 / p99 TTFT errors
    (finite; the CPU tests hold the simulator's parity)."""
    from paddle_tpu_torch.capacity import (ServiceModel, simulate,
                                           trace_from_events,
                                           ttft_divergence, ttfts_of_events)

    t0 = time.time()
    ok = [e for e in wide if e['outcome'] == 'ok']
    trace = trace_from_events(ok)
    model = ServiceModel.from_events(ok, prefill_chunk=32, decode_block=4,
                                     num_slots=2, trace=trace, replicas=2)
    sim = simulate(trace, model, replicas=2)
    div = ttft_divergence(sim.ttft(), ttfts_of_events(ok))
    _check(all(math.isfinite(v) for v in div.values()),
           'simulator divergence %s' % div)
    print('phase 24 (e) simulator: fitted on %d wide events (prefill chunk '
          '%.4f s, decode burst %.4f s), K-S %.3f, p50 TTFT error %.3f, p99 '
          '%.3f; %.1f s' % (len(ok), model.prefill_chunk_s,
                            model.decode_burst_s, div['ks'],
                            div['p50_rel_err'], div['p99_rel_err'],
                            time.time() - t0), flush=True)
    return div


def slice15_phases(card, train, kept):
    """Phase 24: the observability plane on the card."""
    t0 = time.time()
    model, ids, labels, prof = profiler_phase(card)
    out = {'profiler': prof}
    out['cost'] = costmodel_phase(card, model, ids, labels, train)
    del model, ids, labels
    _collect_garbage()
    torch.cuda.empty_cache()
    out['watchdog'] = watchdog_phase(kept)
    del kept
    torch.cuda.empty_cache()
    out['simulator'] = simulator_phase(serving_observability_phase(card))
    out['seconds'] = time.time() - t0
    print('phase 24 (slice 15): %.1f s' % out['seconds'], flush=True)
    return out


# -- phase 25: slice 16, pipeline and expert parallelism ----------------------
# (a) phase 6's bench GPT through TrainStep(pp_state) on a one-stage
# pipeline (world 1, NCCL) under GPipe and 1F1B, 4 microbatches of 8, beside
# the plain step from the same weights; (b) the stage pieces at the per-rank
# shapes of pp 2 and pp 4, chained in one process as the schedule calls
# them, against the unsplit model; (c) MoE at Switch-Base width (Fedus et
# al. 2021: d_model 768, d_ff 3072, 12 heads, 8 experts, capacity factor
# 1.25, top-1) in every block of the bench GPT.
PP_MICRO = 4
PP_STAGE_BATCH = 8
MOE_EXPERTS, MOE_CAPACITY = 8, 1.25
MOE_BATCH, MOE_WARMUP, MOE_STEPS = 16, 2, 5
# the chained stages' loss and grads against the unsplit model's: the
# same kernels on the same microbatch, the tied embedding's grad summed
# from two graphs; as a share of the largest reference grad
PP_STAGE_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _pp_run(schedule, base, ids, labels, hcg, ref):
    """FLEET_STEPS steps of TrainStep(pp_state) on a one-stage pipeline of
    PP_MICRO microbatches from a copy of `base`: _fleet_run's record plus
    the schedule's stats."""
    from paddle_tpu_torch.distributed.pipeline import make_pp_state
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = _fresh_bench_model(base)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    step = TrainStep(model, model.loss, opt, pp_state=make_pp_state(
        hcg.mesh, n_stages=1, n_micro=PP_MICRO, schedule=schedule))
    losses, step_ms, launches = [], [], []
    for _ in range(FLEET_STEPS):
        _reset_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(ids, labels).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(_launches(fa))
    out = {'losses': losses, 'launches': launches, 'stats': step.pp_stats,
           'p50_ms': sorted(step_ms[1:])[len(step_ms[1:]) // 2],
           'first_ms': step_ms[0],
           'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30}
    out.update(_update_rel({n: _whole(p) for n, p in
                            model.named_parameters()}, ref, base))
    # one more step under the profiler (after the parameters were read):
    # the card's busy share of a microbatched step
    wall, dev, top, _ = _profile(lambda: step(ids, labels))
    out.update(busy=dev / wall, profiled_ms=wall,
               top_kernels=[t[:2] for t in top])
    del step, model, opt
    torch.cuda.empty_cache()
    return out


def pipeline_phase(card):
    """25 (a): the bench GPT through the pipeline schedules at world 1."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**BENCH_CFG)
    base = GPTForCausalLM(cfg, device='cuda', seed=SEED).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED + 25)
    ids, labels = (torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                 generator=gen).cuda() for _ in range(2))
    fleet.init(is_collective=True, strategy=_fleet_strategy('dp'))
    hcg = fleet.get_hybrid_communicate_group()
    runs = {'plain': _fleet_run('plain', base, ids, labels, hcg)}
    ref = runs['plain'].pop('final')
    layers = cfg.num_layers
    for schedule in ('gpipe', '1f1b'):
        run = runs[schedule] = _pp_run(schedule, base, ids, labels, hcg,
                                       ref)
        # one forward and one fused backward a layer and a microbatch (b=8)
        want = _want(1, flash_fwd=PP_MICRO * layers,
                     flash_bwd_fused=PP_MICRO * layers)
        _check(all(x == want for x in run['launches']),
               'pp %s launches %s a step, want %s'
               % (schedule, run['launches'], want))
        _fleet_check('pp ' + schedule, run, runs['plain'])
        _check(run['stats']['n_micro'] == PP_MICRO and
               run['stats']['peak_stash'] ==
               (PP_MICRO if schedule == 'gpipe' else 1),
               'pp %s stats %s' % (schedule, run['stats']))
    del base
    torch.cuda.empty_cache()
    for name, run in runs.items():
        print('pp %s [%s]: %d microbatches of %d, losses %s (worst rel vs '
              'plain %.3g, tol %g), update_rel %.4g (tol %g), launches a '
              'step %s, step p50 %.2f ms (first %.1f ms), peak %.2f GiB%s'
              % (name, card, PP_MICRO if name != 'plain' else 1,
                 TRAIN_BATCH // (PP_MICRO if name != 'plain' else 1),
                 ['%.4f' % x for x in run['losses']],
                 run.get('loss_rel', 0.0), FLEET_LOSS_RTOL,
                 run.get('update_rel', 0.0), FLEET_UPDATE_RTOL,
                 {k: v for k, v in run['launches'][-1].items() if v},
                 run['p50_ms'], run['first_ms'], run['peak_gib'],
                 '' if 'busy' not in run else
                 ', profiled step %.2f ms, busy share %.3f, top kernels %s'
                 % (run['profiled_ms'], run['busy'], run['top_kernels'])),
              flush=True)
    return runs


def _grads_of(model):
    return {n: p.grad.float() for n, p in model.named_parameters()
            if p.grad is not None}


def pp_stage_phase(card):
    """25 (b): one microbatch through the stages of pp 2 and pp 4, chained
    forward and backward in one process as the schedule runs them (the
    received activation a leaf, each stage's backward from the next
    stage's gradient), against the unsplit model: the loss and every
    grad, the tied embedding's as the sum of its first and last stage's."""
    from paddle_tpu_torch.distributed import pipeline as pp_mod
    from paddle_tpu_torch.distributed.topology import PPLine
    from paddle_tpu_torch.nn.layer.layers import copy_layer
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**BENCH_CFG)
    gen = torch.Generator().manual_seed(SEED + 26)
    ids, labels = (torch.randint(0, cfg.vocab_size,
                                 (PP_STAGE_BATCH, TRAIN_SEQ),
                                 generator=gen).cuda() for _ in range(2))
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        base = GPTForCausalLM(cfg, device='cuda', seed=SEED).to(dtype)
        base.train()
        loss_ref = base.loss(base(ids), labels)
        loss_ref.backward()
        ref = _grads_of(base)
        base.zero_grad(set_to_none=True)
        for pp in (2, 4):
            stages = []
            for r in range(pp):
                m = copy_layer(base)
                m.pp_keep_stage(r, pp)
                m._pp_kept = r
                m.train()
                line = PPLine(r, pp, None, None, list(range(pp)))
                stages.append((m, pp_mod._Stage(m, m.loss, pp_mod.make_pp_state(
                    None, pp), line)))
            _reset_counts(fa)
            x, outs = None, []
            for m, stage in stages:
                out = stage(x, [ids], [labels])
                outs.append((x, out))
                if not stage.last:
                    x = out.detach().requires_grad_()
            grad = None
            for x_in, out in reversed(outs):
                torch.autograd.backward(out, grad)
                grad = None if x_in is None else x_in.grad
            torch.cuda.synchronize()
            launches = {k: v for k, v in _launches(fa).items() if v}
            got = {}
            for m, _ in stages:
                for n, g in _grads_of(m).items():
                    got[n] = g if n not in got else got[n] + g
            scale = max(g.abs().max().item() for g in ref.values())
            err = max((got[n] - ref[n]).abs().max().item() for n in ref)
            loss = outs[-1][1].item()
            loss_rel = abs(loss - loss_ref.item()) / abs(loss_ref.item())
            tol = PP_STAGE_TOL[dtype]
            split = [len(m.gpt.h) for m, _ in stages]
            _check(sorted(got) == sorted(ref),
                   'pp %d stages hold %d of %d grads' % (pp, len(got),
                                                         len(ref)))
            _check(loss_rel <= tol and err <= tol * scale,
                   'pp %d %s stages: loss %.6f vs unsplit %.6f, worst grad '
                   'err %.3g (tol %g of the largest %.3g)'
                   % (pp, dtype, loss, loss_ref.item(), err, tol, scale))
            _check(launches == {'flash_fwd': cfg.num_layers,
                                'flash_bwd_fused': cfg.num_layers},
                   'pp %d stages launched %s' % (pp, launches))
            wte = [m for m, _ in stages if m.gpt.wte is not None]
            _check(len(wte) == 2 and split == [cfg.num_layers // pp] * pp,
                   'pp %d stages: layers %s, wte on %d stages'
                   % (pp, split, len(wte)))
            row = {'pp': pp, 'dtype': str(dtype).split('.')[-1],
                   'layers': split, 'loss': loss, 'loss_ref': loss_ref.item(),
                   'loss_rel': loss_rel, 'grad_err_share': err / scale,
                   'launches': launches}
            rows.append(row)
            print('pp stages [%s]: %s' % (card, json.dumps(row)), flush=True)
            del stages, outs, got
        del base, ref, loss_ref
        torch.cuda.empty_cache()
    return rows


def _moe_config(**kw):
    from paddle_tpu_torch.text.models.gpt import GPTConfig
    cfg = dict(BENCH_CFG, num_experts=MOE_EXPERTS,
               moe_capacity_factor=MOE_CAPACITY)
    cfg.update(kw)
    return GPTConfig(**cfg)


def _moe_flops_per_token(model, seq, top_k=1):
    """Forward + backward FLOPs a token of the MoE GPT: 6 x the parameters
    a token passes through (every non-expert one and top_k experts' FFN
    a layer) plus the attention term, as flops_per_token counts it. The
    expert products run over the capacity's slots, empty ones too: those
    are not counted (MFU counts useful work)."""
    c = model.config
    expert = sum(p.numel() for n, p in model.named_parameters()
                 if '.mlp.' in n and '.mlp.gate.' not in n)
    dense = sum(p.numel() for p in model.parameters()) - expert
    active = dense + expert * top_k // c.num_experts
    return 6 * active + 12 * c.num_layers * c.hidden_size * seq


def moe_phase(card, sku):
    """25 (c): the MoE GPT at Switch-Base width, bf16, batch 16 x 512,
    AdamW, through TrainStep; then GShardMoE (top-2) in every block; then
    2 layers in f32 at a capacity that drops tokens against the CPU."""
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.incubate.moe import GShardMoE
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    gc.collect()
    torch.cuda.empty_cache()
    cfg = _moe_config()
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).to(torch.bfloat16)
    step = TrainStep(model, model.loss, AdamW(
        learning_rate=TRAIN_LR, parameters=model.parameters()))
    gen = torch.Generator().manual_seed(SEED + 27)
    ids, labels = (torch.randint(0, cfg.vocab_size, (MOE_BATCH, TRAIN_SEQ),
                                 generator=gen).cuda() for _ in range(2))
    losses, ms, peak, launches = _timed_train(step, ids, labels, MOE_WARMUP,
                                              MOE_STEPS)
    layers = cfg.num_layers
    _check(launches == _want(MOE_STEPS, flash_fwd=layers,
                             flash_bwd_fused=layers),
           'MoE launches %s over %d steps, want %d + %d a step'
           % (launches, MOE_STEPS, layers, layers))
    _check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
           'MoE losses %s do not fall' % losses)
    dropped = [b.mlp.last_dropped.item() for b in model.gpt.h]
    aux = sum(b.mlp.aux_loss.item() * b.mlp.aux_loss_weight
              for b in model.gpt.h)
    median = sorted(ms)[MOE_STEPS // 2]
    tokens = MOE_BATCH * TRAIN_SEQ
    flops_tok = _moe_flops_per_token(model, TRAIN_SEQ)
    wall, dev, top, ops = _profile(lambda: step(ids, labels))
    params = sum(p.numel() for p in model.parameters())
    expert_params = sum(p.numel() for n, p in model.named_parameters()
                        if n.endswith(('.w1', '.b1', '.w2', '.b2')))
    cap = max(1, int(MOE_CAPACITY * tokens / MOE_EXPERTS))
    switch = {'params': params, 'expert_params': expert_params,
              'capacity': cap, 'median_ms': median, 'min_ms': min(ms),
              'max_ms': max(ms), 'tokens_per_s': tokens / median * 1e3,
              'active_mflop_per_token': flops_tok / 1e6,
              'mfu': flops_tok * tokens / (median / 1e3) / sku[2]['bfloat16'],
              'peak_gib': peak / 2 ** 30, 'busy': dev / wall,
              'dropped_share': [round(d, 4) for d in dropped],
              'aux_weighted': aux, 'launches': launches, 'steps': MOE_STEPS,
              'losses': [round(x, 4) for x in losses]}
    print('phase 25c Switch MoE GPT [%s]: %s' % (card, json.dumps(switch)),
          flush=True)
    print('profile MoE step: wall %.2f ms, device kernels %.2f ms, busy '
          'share %.3f; top kernels: %s; top aten ops: %s'
          % (wall, dev, dev / wall,
             '; '.join('%s %.2f ms x%d' % t for t in top),
             '; '.join('%s %.2f ms x%d' % t for t in ops)), flush=True)
    del step
    # GShard (top-2, capacity factor 2) in every block, 2 steps
    for block in model.gpt.h:
        block.mlp = GShardMoE(cfg.hidden_size, cfg.intermediate_size,
                              num_experts=MOE_EXPERTS, device='cuda',
                              generator=torch.Generator().manual_seed(SEED)
                              ).to(torch.bfloat16)
    step = TrainStep(model, model.loss, AdamW(
        learning_rate=TRAIN_LR, parameters=model.parameters()))
    g_losses, g_ms, g_peak, g_launches = _timed_train(step, ids, labels, 0, 2)
    _check(g_launches == _want(2, flash_fwd=layers, flash_bwd_fused=layers)
           and all(math.isfinite(x) for x in g_losses),
           'GShard MoE losses %s, launches %s' % (g_losses, g_launches))
    gshard = {'step_ms': g_ms, 'peak_gib': g_peak / 2 ** 30,
              'losses': g_losses,
              'dropped_share': [round(b.mlp.last_dropped.item(), 4)
                                for b in model.gpt.h]}
    print('phase 25c GShard MoE GPT [%s]: %s' % (card, json.dumps(gshard)),
          flush=True)
    del model, step
    torch.cuda.empty_cache()
    return {'switch': switch, 'gshard': gshard, 'parity': moe_parity_phase()}


def moe_parity_phase():
    """25 (c), last: the MoE GPT cut to 2 layers, f32 (TF32 off), capacity
    factor 0.5 (tokens drop), 3 TrainStep calls on the card against the
    same steps on the CPU."""
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _moe_config(num_layers=2, moe_capacity_factor=0.5)
    gen = torch.Generator().manual_seed(SEED + 28)
    ids, labels = (torch.randint(0, cfg.vocab_size, (2, TRAIN_SEQ),
                                 generator=gen) for _ in range(2))
    losses, dropped = {}, {}
    for dev in ('cuda', 'cpu'):
        model = GPTForCausalLM(cfg, device=dev, seed=SEED)
        step = TrainStep(model, model.loss, AdamW(
            learning_rate=TRAIN_LR, parameters=model.parameters()))
        losses[dev] = [step(ids.to(dev), labels.to(dev)).item()
                       for _ in range(3)]
        dropped[dev] = [b.mlp.last_dropped.item() for b in model.gpt.h]
        del model, step
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses['cuda'],
                                                  losses['cpu']))
    _check(rel <= 1e-5 and min(dropped['cuda']) > 0 and
           dropped['cuda'] == dropped['cpu'],
           'MoE f32 losses %s vs CPU %s (rel %.3g, tol 1e-5), dropped %s '
           'vs %s' % (losses['cuda'], losses['cpu'], rel, dropped['cuda'],
                      dropped['cpu']))
    out = {'losses': losses['cuda'], 'losses_cpu': losses['cpu'],
           'rel': rel, 'dropped_share': dropped['cuda']}
    print('phase 25c MoE f32 vs CPU: %s' % json.dumps(out), flush=True)
    torch.cuda.empty_cache()
    return out


def slice16_phases(card, sku):
    """Phase 25: pipeline and expert parallelism."""
    t0 = time.time()
    out = {'pipeline': pipeline_phase(card), 'stages': pp_stage_phase(card),
           'moe': moe_phase(card, sku)}
    out['seconds'] = time.time() - t0
    runs = out['pipeline']
    print('phase 25 (slice 16) [%s]: %s' % (card, json.dumps({
        'step_p50_ms': {k: round(r['p50_ms'], 2) for k, r in runs.items()},
        'peak_gib': {k: round(r['peak_gib'], 2) for k, r in runs.items()},
        'moe_step_ms': out['moe']['switch']['median_ms'],
        'moe_mfu': out['moe']['switch']['mfu'],
        'seconds': round(out['seconds'], 1)})), flush=True)
    return out


# -- slice 17: the launcher, elastic relaunch, the composed strategy, TP
# decode and SyncBatchNorm ------------------------------------------------

# the job each rank of phase 26's launched pods runs: this file's
# slice17_job, from the checkout whose root is its first argument
SLICE17_JOB = """import sys, time
T_START = time.time()
root, out, mode, life = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, root)
import chip_smoke
sys.exit(chip_smoke.slice17_job(out, mode, T_START))
"""
# phase 26 (a): the composition under the launcher, as phase 22 holds a
# strategy (FLEET_STEPS steps of the bench model against the plain step);
# per-block recompute runs each block's forward twice a step
COMPOSED = 'mp_sharding3_recompute_amp_clip'
# phase 26 (b): f32 at 2 layers; the first life takes ELASTIC_STEPS[0]
# steps, checkpoints and exits 101, the second resumes for the rest
ELASTIC_STEPS = (3, 3)
ELASTIC_LAYERS = 2
DECODE_NEW = 32
# phase 26 (c) decodes through GPT-2 small's width and vocabulary cut to
# 6 of its 12 layers (since slice 18: the depth cut that makes room for
# phase 27's vision training in chip_smoke's time limit)
TP_DECODE_LAYERS = 2


def _composed_job(res):
    """Phase 26 (a) inside a launched rank: the plain bf16 step with AdamW
    under ClipGradByNorm, then COMPOSED from the same weights."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(**BENCH_CFG)
    base = GPTForCausalLM(cfg, device='cuda', seed=SEED).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED)
    ids, labels = (torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                 generator=gen).cuda() for _ in range(2))
    plain = _fleet_run('plain', base, ids, labels, opt_kind='clip')
    ref = plain.pop('final')
    run = _fleet_run(COMPOSED, base, ids, labels, ref=ref)
    for r in (plain, run):
        r['placed'] = {n: str(p) for n, p in r['placed'].items()}
    res.update(plain=plain, composed=run,
               n_params=len(list(base.parameters())), layers=cfg.num_layers)


def _elastic_model(cfg_kw, ckpt):
    """The f32 2-layer bench model under COMPOSED without amp, and its
    step; from the checkpoint `ckpt` when it exists (model weights
    carried in before the layout, the optimizer's state after)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  load_paddle_tpu_state)
    cfg = GPTConfig(**cfg_kw)
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED)
    state = torch.load(ckpt) if ckpt and os.path.exists(ckpt) else None
    if state is not None:
        load_paddle_tpu_state(model, {k: v.numpy() for k, v in
                                      state['model'].items()})
    opt = _fleet_optimizer('clip', model.parameters())
    strategy = _fleet_strategy('mp_sharding3', 1)
    fleet.init(is_collective=True, strategy=strategy)
    step = fleet.fleet_train_step(model, model.loss, opt, strategy=strategy)
    if state is not None:
        opt.set_state_dict(state['opt'])
    return model, opt, step, (0 if state is None else state['done'])


def _elastic_batch(cfg_kw):
    gen = torch.Generator().manual_seed(SEED + 26)
    return [torch.randint(0, cfg_kw['vocab_size'], (4, TRAIN_SEQ),
                          generator=gen).cuda() for _ in range(2)]


def _elastic_life(out, res):
    """Phase 26 (b) inside a launched rank: train, checkpoint and exit
    101 on the first life; resume from the checkpoint on the second."""
    cfg_kw = dict(BENCH_CFG, num_layers=ELASTIC_LAYERS)
    ckpt = os.path.join(out, 'elastic.ckpt')
    model, opt, step, done = _elastic_model(cfg_kw, ckpt)
    ids, labels = _elastic_batch(cfg_kw)
    n = ELASTIC_STEPS[0] if done == 0 else sum(ELASTIC_STEPS) - done
    res['resumed_at'] = done
    res['losses'] = [step(ids, labels).item() for _ in range(n)]
    if done:
        return 0
    state = {'done': n, 'opt': {k: (_whole(v).cpu() if torch.is_tensor(v)
                                    else v)
                                for k, v in opt.state_dict().items()},
             'model': {k: _whole(v).float().cpu()
                       for k, v in model.state_dict().items()}}
    torch.save(state, ckpt)
    return 101


def slice17_job(out, mode, t_start):
    """A launched rank of phase 26: NCCL from the launcher's env contract
    (card FLAGS_selected_gpus), the mode's work ('train': (a), 'elastic':
    (b)), its results in out/<mode>_<rank>_<pid>.json, then its NCCL
    groups ended. Returns the process's exit code."""
    import paddle_tpu_torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    res = {'t_start': t_start, 't_ready': time.time(),
           'rank': dist.get_rank(), 'world': dist.get_world_size(),
           'card': torch.cuda.current_device(),
           'env': {k: os.environ.get(k) for k in (
               'PADDLE_TRAINER_ID', 'PADDLE_TRAINERS_NUM',
               'PADDLE_TRAINER_ENDPOINTS', 'PADDLE_CURRENT_ENDPOINT',
               'FLAGS_selected_gpus', 'TRAINING_ROLE')}}
    rc = 0
    try:
        if mode == 'train':
            _composed_job(res)
        else:
            rc = _elastic_life(out, res)
    finally:
        res['t_end'] = time.time()
        with open(os.path.join(out, '%s_%d_%d.json' % (
                mode, res['rank'], os.getpid())), 'w') as f:
            json.dump(res, f)
        from paddle_tpu_torch.distributed import env as env_mod
        env_mod.end_nccl_groups()
    return rc


def _launch(mode, extra=(), timeout=900):
    """Run the launcher (one rank, this card) over SLICE17_JOB in `mode`
    from this checkout; returns (rc, seconds, results by life, log)."""
    import shutil
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix='slice17_')
    job = os.path.join(tmp, 'job.py')
    with open(job, 'w') as f:
        f.write(SLICE17_JOB)
    env = dict(os.environ, PYTHONPATH=root + os.pathsep +
               os.environ.get('PYTHONPATH', ''))
    env.pop('PADDLE_DISTRI_DEVICE', None)
    sock = socket.socket()
    sock.bind(('127.0.0.1', 0))
    port = sock.getsockname()[1]
    sock.close()
    cmd = [sys.executable, '-m', 'paddle_tpu_torch.distributed.launch',
           '--nproc_per_node', '1', '--start_port', str(port),
           '--log_dir', os.path.join(tmp, 'logs')] + list(extra) + \
        [job, root, tmp, mode, '0']
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=root, env=env, timeout=timeout,
                          capture_output=True, text=True)
    seconds = time.time() - t0
    lives = []
    for name in sorted(os.listdir(tmp)):
        if name.startswith(mode + '_') and name.endswith('.json'):
            with open(os.path.join(tmp, name)) as f:
                lives.append(json.load(f))
    lives.sort(key=lambda r: r['t_start'])
    log = ''
    path = os.path.join(tmp, 'logs', 'workerlog.0')
    if os.path.exists(path):
        with open(path) as f:
            log = f.read()
    shutil.rmtree(tmp, ignore_errors=True)
    return proc.returncode, seconds, t0, lives, log[-3000:] + proc.stdout[
        -1000:] + proc.stderr[-1000:]


def launched_job_phase(card):
    """Phase 26 (a): the composed strategy in a launched pod of one rank."""
    rc, seconds, t0, lives, log = _launch('train')
    _check(rc == 0 and len(lives) == 1,
           'launched job: rc %s, %d result files\n%s' % (rc, len(lives),
                                                         log))
    res = lives[0]
    env = res['env']
    _check(env['FLAGS_selected_gpus'] == '0' and env['PADDLE_TRAINERS_NUM']
           == '1' and env['TRAINING_ROLE'] == 'TRAINER' and
           env['PADDLE_CURRENT_ENDPOINT'] == env['PADDLE_TRAINER_ENDPOINTS']
           and res['card'] == 0, 'the launched rank\'s env %s' % env)
    plain, run = res['plain'], res['composed']
    layers = res['layers']
    for name, r, fwd in (('plain', plain, layers),
                         (COMPOSED, run, 2 * layers)):
        want = _want(1, flash_fwd=fwd, flash_bwd_fused=layers)
        _check(all(x == want for x in r['launches']),
               '%s launches %s a step, want %s' % (name, r['launches'],
                                                   want))
    _fleet_check(COMPOSED, run, plain)
    placed = run['placed']
    _check(len(placed) == res['n_params'] and all(
        pl.count('Shard') == 2 for n, pl in placed.items()
        if n.endswith(('qkv_proj.weight', 'fc_in.weight', 'out_proj.weight',
                       'fc_out.weight', 'wte.weight'))),
           '%s: %d of %d parameters laid out, %s' % (
               COMPOSED, len(placed), res['n_params'],
               placed.get('gpt.h.0.attn.qkv_proj.weight')))
    out = {'plain': plain, 'composed': run, 'seconds': seconds,
           'startup_s': res['t_start'] - t0,
           'ready_s': res['t_ready'] - t0}
    print('slice 17 (a) [%s]: launched pod of 1 rank, %s vs the plain step '
          '(both AdamW under ClipGradByNorm(%g), bf16): losses %s vs %s '
          '(worst rel %.3g, tol %g), update_rel %.4g (tol %g), launches a '
          'step %s, step p50 %.2f vs %.2f ms, peak %.2f vs %.2f GiB; '
          'launcher to script %.2f s, to NCCL ready %.2f s, pod %.1f s'
          % (card, COMPOSED, FLEET_CLIP_NORM,
             ['%.4f' % x for x in run['losses']],
             ['%.4f' % x for x in plain['losses']], run['loss_rel'],
             FLEET_LOSS_RTOL, run['update_rel'], FLEET_UPDATE_RTOL,
             {k: v for k, v in run['launches'][-1].items() if v},
             run['p50_ms'], plain['p50_ms'], run['peak_gib'],
             plain['peak_gib'], out['startup_s'], out['ready_s'], seconds),
          flush=True)
    return out


def elastic_phase(card):
    """Phase 26 (b): the launcher's elastic relaunch, against the same
    steps uninterrupted in this process."""
    import tempfile
    kv = tempfile.mkdtemp(prefix='slice17_kv_')
    rc, seconds, t0, lives, log = _launch(
        'elastic', ('--elastic_server', 'file://' + kv, '--job_id', 'p26'))
    import shutil
    shutil.rmtree(kv, ignore_errors=True)
    _check(rc == 0 and len(lives) == 2 and lives[1]['resumed_at'] ==
           ELASTIC_STEPS[0],
           'elastic job: rc %s, %d lives %s\n%s'
           % (rc, len(lives), [r.get('resumed_at') for r in lives], log))
    cfg_kw = dict(BENCH_CFG, num_layers=ELASTIC_LAYERS)
    model, opt, step, _ = _elastic_model(cfg_kw, None)
    ids, labels = _elastic_batch(cfg_kw)
    ref = [step(ids, labels).item() for _ in range(sum(ELASTIC_STEPS))]
    del model, opt, step
    got = lives[0]['losses'] + lives[1]['losses']
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    bitwise = got == ref
    _check(worst <= 1e-5, 'elastic losses %s vs uninterrupted %s'
           % (got, ref))
    out = {'losses': got, 'ref': ref, 'worst_rel': worst,
           'bitwise': bitwise, 'seconds': seconds,
           'second_life_startup_s': lives[1]['t_start'] - lives[0]['t_end'],
           'startup_s': lives[0]['t_start'] - t0}
    print('slice 17 (b) [%s]: elastic pod, 2 lives (exit 101 after %d '
          'steps, resumed at step %d), f32 %d layers: losses %s vs '
          'uninterrupted %s, worst rel %.3g (tol 1e-5), bitwise %s; first '
          'life started %.2f s after the launcher, the second %.2f s after '
          'the first ended; pod %.1f s'
          % (card, ELASTIC_STEPS[0], lives[1]['resumed_at'],
             ELASTIC_LAYERS, ['%.6f' % x for x in got],
             ['%.6f' % x for x in ref], worst, bitwise, out['startup_s'],
             out['second_life_startup_s'], seconds), flush=True)
    return out


def _decode_rate(model, ids, new):
    """(median ms of generate(ids, new), median ms of the prefill alone,
    decode tokens/s) over 3 calls each."""
    def med(fn):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[1]
    total = med(lambda: model.generate(ids, max_new_tokens=new))
    prefill = med(lambda: model.generate(ids, max_new_tokens=1))
    return (total * 1e3, prefill * 1e3,
            ids.shape[0] * (new - 1) / max(total - prefill, 1e-9))


def tp_decode_phase(card):
    """Phase 26 (c): GPT-2 small (cut to TP_DECODE_LAYERS layers)
    generate() through weights laid out over 'mp' (world 1) against the
    plain model, f32 then bf16; the cost of each call's QKV weight gather
    and head cut."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.meta_parallel import mp_layers
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  cache_heads)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig.gpt2_small()
    cfg.num_layers = TP_DECODE_LAYERS
    plain = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
    tp = _fresh_bench_model(plain).eval()
    strategy = _fleet_strategy('mp', 1)
    fleet.init(is_collective=True, strategy=strategy)
    fleet.distributed_model(tp)
    placed = sum(1 for p in tp.parameters() if hasattr(p, 'placements'))
    gen = torch.Generator().manual_seed(SEED + 3)
    ids = torch.randint(0, cfg.vocab_size, (8, 768), generator=gen).cuda()
    want = plain.generate(ids, max_new_tokens=DECODE_NEW)
    _reset_counts(fa)
    got = tp.generate(ids, max_new_tokens=DECODE_NEW)
    launches = _launches(fa)
    _check(torch.equal(got, want), 'TP decode f32 tokens differ from the '
           'plain generate(): %d of %d agree'
           % (int((got == want).sum()), want.numel()))
    _check(launches == _want(1, flash_fwd=cfg.num_layers),
           'TP decode launches %s, want %d flash forward (the prefill)'
           % (launches, cfg.num_layers))
    _check(cache_heads(tp) == cfg.num_heads, 'cache heads at mp 1')
    attn = tp.gpt.h[0].attn

    def gather():
        return mp_layers.qkv_head_columns(attn.qkv_proj.weight,
                                          attn.qkv_proj.bias, attn.num_heads)
    gather_ms = _time_ms(gather, iters=50)
    rates = {}
    for dtype in (torch.bfloat16,):
        plain.to(dtype)
        tp.to(dtype)
        for name, m in (('plain', plain), ('tp', tp)):
            m.generate(ids[:, :64], max_new_tokens=2)   # warm-up
            rates[name] = _decode_rate(m, ids, DECODE_NEW)
    del plain, tp
    torch.cuda.empty_cache()
    step_ms = 1e3 * 8 / rates['tp'][2]
    out = {'placed': placed, 'launches': launches['flash_fwd'],
           'gather_ms_f32': gather_ms,
           'gather_ms_per_token': gather_ms * cfg.num_layers,
           'decode_step_ms_bf16': step_ms, 'rates': rates}
    print('slice 17 (c) [%s]: GPT-2 small (%d layers) generate() 8 x 768 + '
          '%d through %d DTensor parameters over \'mp\' (world 1): f32 '
          'tokens equal to the plain generate(), %d flash launches (the '
          'prefill); bf16 '
          'TP generate %.1f ms (prefill %.2f ms), %.1f decode tokens/s vs '
          'plain %.1f ms (prefill %.2f), %.1f tokens/s; the QKV gather and '
          'head cut %.4f ms a call (f32), %.4f ms a token over %d layers, '
          'a decode step %.2f ms (bf16)'
          % (card, cfg.num_layers, DECODE_NEW, placed, launches['flash_fwd'],
             rates['tp'][0], rates['tp'][1], rates['tp'][2],
             rates['plain'][0], rates['plain'][1], rates['plain'][2],
             gather_ms, gather_ms * cfg.num_layers, cfg.num_layers,
             step_ms), flush=True)
    return out


def _bn_net(device):
    from paddle_tpu_torch import nn as pnn
    torch.manual_seed(SEED)
    return torch.nn.Sequential(
        pnn.Linear(256, 512, device=device), pnn.BatchNorm1D(512,
                                                             device=device),
        torch.nn.ReLU(), pnn.Linear(512, 10, device=device))


def _bn_train(net, xs, ys, wrap=None):
    from paddle_tpu_torch.optimizer import SGD
    model = wrap(net) if wrap else net
    opt = SGD(learning_rate=0.1, parameters=net.parameters())
    losses = []
    for x, y in zip(xs, ys):
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad(set_to_zero=False)
        losses.append(loss.item())
    return losses


def syncbn_phase(card):
    """Phase 26 (d): Linear -> SyncBatchNorm -> ReLU -> Linear under
    DataParallel at world 1 on the card against the same net with
    BatchNorm1D on the CPU, f32, 5 SGD steps."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn as pnn
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 4)
    xs = [torch.randn(256, 256, generator=gen) for _ in range(5)]
    ys = [torch.randint(0, 10, (256,), generator=gen) for _ in range(5)]
    cpu = _bn_net('cpu')
    card_net = pnn.SyncBatchNorm.convert_sync_batchnorm(_bn_net('cuda'))
    _check(isinstance(card_net[1], pnn.SyncBatchNorm), 'converted')
    want = _bn_train(cpu, xs, ys)
    got = _bn_train(card_net, [x.cuda() for x in xs],
                    [y.cuda() for y in ys], wrap=dist.DataParallel)
    errs = {'loss': max(abs(a - b) for a, b in zip(got, want))}
    for (n, a), (_, b) in zip(card_net.state_dict().items(),
                              cpu.state_dict().items()):
        errs[n] = (a.cpu() - b).abs().max().item()
    worst = max(errs.values())
    _check(worst <= 1e-5, 'SyncBatchNorm on the card vs the CPU: %s' % errs)
    print('slice 17 (d) [%s]: SyncBatchNorm under DataParallel (world 1, '
          'NCCL) vs BatchNorm1D on the CPU, f32, 5 SGD steps: losses %s, '
          'worst abs err over losses, weights and running statistics '
          '%.3g (tol 1e-5)' % (card, ['%.5f' % x for x in got], worst),
          flush=True)
    return {'losses': got, 'worst': worst}


def slice17_phases(card):
    """Phase 26: slice 17 at world 1."""
    t0 = time.time()
    out = {'launch': launched_job_phase(card),
           'elastic': elastic_phase(card),
           'decode': tp_decode_phase(card), 'syncbn': syncbn_phase(card)}
    out['seconds'] = time.time() - t0
    run = out['launch']['composed']
    print('phase 26 (slice 17) [%s]: %s' % (card, json.dumps({
        'composed_step_p50_ms': round(run['p50_ms'], 2),
        'plain_step_p50_ms': round(out['launch']['plain']['p50_ms'], 2),
        'composed_peak_gib': round(run['peak_gib'], 2),
        'elastic_bitwise': out['elastic']['bitwise'],
        'tp_decode_tokens_s': round(out['decode']['rates']['tp'][2], 1),
        'plain_decode_tokens_s': round(
            out['decode']['rates']['plain'][2], 1),
        'seconds': round(out['seconds'], 1)})), flush=True)
    return out


# -- phase 27: slice 18, convolutional vision --------------------------------

# BASELINE config 2 (bench_extra.py's bench_resnet on the TPU): resnet50()
# cast to bf16, batch 64 of 3 x 224 x 224, Momentum at lr 0.1 and
# cross-entropy through TrainStep; 2 warm-up steps, then 10 timed
VISION_BATCH, VISION_SIZE, VISION_LR = 64, 224, 0.1
# phase 27 (b): resnet18 on the card and on the CPU from the same weights,
# 3 Momentum steps (lr 0.1) on batches of 32 x 3 x 64 x 64, in f32 (TF32
# off) and in float64. Its train-mode batch norms make the steps
# ill-conditioned in f32: on an H100 host the CPU's own f32 run stood
# 2.5e-2 (of a tensor's largest entry) off its float64 run after the
# first update and 0.18 after 3 steps, the card's f32 run as far, while
# the card's and the CPU's float64 runs agreed within 1.1e-7. So float64
# holds the card to the CPU within F64_TOL (float64 rounding, amplified
# as f32's is, stays below it), and the f32 runs are held to the rounding
# of f32 itself: the card's f32 losses, first update and state stand
# within F32_FACTOR times the CPU's f32 distance from the float64 run
# (plus 1e-5), each measured in the same run.
RESNET_F32_BATCH, RESNET_F32_SIZE = 32, 64
F64_TOL, F32_FACTOR = 1e-6, 4.0
# phase 27 (d): LeNet through Model.fit on MNIST-format files written from
# the seed: 4096 training and 1024 test images of 28 x 28
MNIST_TRAIN, MNIST_TEST = 4096, 1024


def _vision_step(model, lr):
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    ce = pnn.CrossEntropyLoss()
    return TrainStep(model, lambda lo, la: ce(lo, la),
                     Momentum(learning_rate=lr,
                              parameters=model.parameters()))


def _vision_batch(seed, batch, size, device, dtype=torch.float32):
    """Seeded images (standard normal) and labels in [0, 1000)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, 3, size, size, generator=gen)
    y = torch.randint(0, 1000, (batch,), generator=gen)
    return x.to(device, dtype), y.to(device)


def _layer_flops(model, x):
    """A training step's FLOPs by hand from the layers' shapes: 2 x
    in / groups x prod(k) x out x the output's positions for each
    convolution and 2 x in x out a row for each Linear, taken from one
    forward; three times that for the forward, the input grad and the
    weight grad, less the first convolution's input grad (the images
    need none)."""
    from paddle_tpu_torch.nn.layer.common import Linear
    from paddle_tpu_torch.nn.layer.conv import _ConvNd
    counts = []

    def hook(layer, args, out):
        if isinstance(layer, Linear):
            counts.append(2 * layer.in_features * layer.out_features *
                          out.numel() // layer.out_features)
        else:
            k = int(np.prod(layer._kernel_size))
            counts.append(2 * layer._in_channels // layer._groups * k *
                          out.numel())
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Linear, _ConvNd))]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return 3 * sum(counts) - counts[0]


def resnet_train_phase(card, sku):
    """Phase 27 (a): BASELINE config 2, ResNet-50 training in bf16 at
    batch 64 x 224 on the card."""
    from paddle_tpu_torch.monitor.perf import costmodel
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.vision.models import resnet50

    t0 = time.time()
    model = resnet50(device='cuda', seed=SEED).bfloat16()
    step = _vision_step(model, VISION_LR)
    x, y = _vision_batch(SEED + 27, VISION_BATCH, VISION_SIZE, 'cuda',
                         torch.bfloat16)
    _reset_counts(fa)
    losses = [step(x, y).item() for _ in range(2)]  # warm-up
    steps = 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    launches = _launches(fa)
    _check(launches == _want(steps), 'the vision path launched flash '
           'kernels: %s' % launches)
    _check(all(math.isfinite(v) for v in losses), 'ResNet-50 losses not '
           'finite: %s' % losses)
    _check(losses[-1] < losses[0], 'ResNet-50 loss %.4f after %d steps not '
           'below the first %.4f' % (losses[-1], len(losses), losses[0]))
    median = sorted(step_ms)[steps // 2]
    est = costmodel.estimate(step, args=(x, y), step_seconds=median / 1e3,
                             dtype='bfloat16')
    hand = _layer_flops(model, x)
    rel = abs(est['flops'] - hand) / hand
    _check(rel <= 0.01, 'cost model %.6g FLOPs a step against the layers\' '
           'hand count %.6g (%.4f apart)' % (est['flops'], hand, rel))
    for key in ('mfu_est', 'roofline_frac'):
        _check(est[key] <= MAX_SHARE_OF_BOUND, '%s %.4f above %.2f: the count '
               'or the peak is wrong' % (key, est[key], MAX_SHARE_OF_BOUND))
    wall, dev, top, ops = _profile(lambda: step(x, y))
    out = {'median_ms': median, 'images_s': VISION_BATCH / median * 1e3,
           'flops': est['flops'], 'mfu': est['mfu_est'],
           'roofline_frac': est['roofline_frac'],
           'bound': est['roofline_bound'], 'busy': dev / wall,
           'peak_gib': peak / 2 ** 30, 'losses': losses, 'top': top,
           'launches': launches, 'seconds': time.time() - t0}
    print('slice 18 (a) [%s]: ResNet-50 (bf16 parameters and batch norm '
          'statistics) training, batch %d x 3 x %d x %d, Momentum lr %g: '
          'median step %.2f ms (min %.2f, max %.2f), %.1f images/s; cost '
          'model %.6g FLOPs a step (the layers\' hand count %.6g, %.2e '
          'apart), %.6g bytes (unfused), %s-bound, mfu_est %.4f of %.0f '
          'TFLOP/s, roofline_frac %.4f; peak memory %.2f GiB; profiled step '
          'wall %.2f ms, device kernels %.2f ms, busy share %.3f; top '
          'kernels: %s; top aten ops: %s; flash launches %s; losses %s; '
          '%.1f s' % (card, VISION_BATCH, VISION_SIZE, VISION_SIZE,
                      VISION_LR, median, min(step_ms), max(step_ms),
                      out['images_s'], est['flops'], hand, rel,
                      est['bytes_accessed'], est['roofline_bound'],
                      est['mfu_est'], est['peak_flops'] / 1e12,
                      est['roofline_frac'], out['peak_gib'], wall, dev,
                      out['busy'], '; '.join('%s %.2f ms x%d' % t
                                             for t in top),
                      '; '.join('%s %.2f ms x%d' % t for t in ops),
                      {k: v for k, v in launches.items() if v},
                      ['%.4f' % v for v in losses], out['seconds']),
          flush=True)
    del model, step
    torch.cuda.empty_cache()
    return out


def _max_rel(got, want, floor):
    """The largest error of each tensor over its largest entry (at least
    `floor`), by name."""
    return {k: ((got[k].double() - want[k].double()).abs().max() /
                max(want[k].double().abs().max().item(), floor)).item()
            for k in want}


def _resnet_runs(seed):
    """resnet18 on the CPU and on the card in f32 and float64 from one
    set of weights, 3 Momentum steps each on the same batches: by run,
    its losses, its first update and its state after the steps (each
    tensor in float64 on the CPU)."""
    from paddle_tpu_torch.vision.models import resnet18

    base = resnet18(device='cpu', seed=seed)
    start = {k: v.double() for k, v in base.state_dict().items()}
    runs = {}
    for name, device, dtype in (('cpu32', 'cpu', torch.float32),
                                ('cpu64', 'cpu', torch.float64),
                                ('card32', 'cuda', torch.float32),
                                ('card64', 'cuda', torch.float64)):
        model = resnet18(device=device, seed=seed + 1).to(dtype)
        model.load_state_dict(base.state_dict())
        step = _vision_step(model, VISION_LR)
        run = {'losses': []}
        for i in range(3):
            x, y = _vision_batch(SEED + 270 + i, RESNET_F32_BATCH,
                                 RESNET_F32_SIZE, device, dtype)
            run['losses'].append(step(x, y).item())
            if i == 0:
                run['first'] = {k: v.cpu().double() - start[k] for k, v in
                                model.state_dict().items()}
        run['state'] = {k: v.cpu().double() for k, v in
                        model.state_dict().items()}
        runs[name] = run
        del model, step
    torch.cuda.empty_cache()
    return runs


def _run_distance(a, b):
    """(losses, first update, state) distances of run a from run b: the
    largest relative loss error, and each tensor's largest error over
    its largest entry at the worst tensor, with its name."""
    losses = max(abs(x - y) / abs(y) for x, y in zip(a['losses'],
                                                     b['losses']))
    first = max(_max_rel(a['first'], b['first'], 1e-5).items(),
                key=lambda kv: kv[1])
    state = max(_max_rel(a['state'], b['state'], 1e-6).items(),
                key=lambda kv: kv[1])
    return losses, first, state


def resnet_f32_phase(card):
    """Phase 27 (b): resnet18 on the card (TF32 off) against the CPU from
    the same weights, 3 Momentum steps, in f32 and float64."""
    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = _resnet_runs(SEED)
    f64 = _run_distance(runs['card64'], runs['cpu64'])
    card32 = _run_distance(runs['card32'], runs['cpu64'])
    cpu32 = _run_distance(runs['cpu32'], runs['cpu64'])
    direct = _run_distance(runs['card32'], runs['cpu32'])
    for what, got in zip(('losses', 'first update', 'state'), f64):
        err = got if what == 'losses' else got[1]
        _check(err <= F64_TOL, 'resnet18 float64 %s on the card vs the '
               'CPU %s apart (tol %g)' % (what, got, F64_TOL))
    for what, got, ref in zip(('losses', 'first update', 'state'), card32,
                              cpu32):
        err, base = (got, ref) if what == 'losses' else (got[1], ref[1])
        _check(err <= F32_FACTOR * base + 1e-5, 'resnet18 f32 %s on the '
               'card %s from float64, the CPU\'s f32 %s (factor %g)'
               % (what, got, ref, F32_FACTOR))
    out = {'losses': {k: r['losses'] for k, r in runs.items()},
           'f64': f64, 'card32': card32, 'cpu32': cpu32, 'direct': direct,
           'seconds': time.time() - t0}

    def text(d):
        return 'losses %.3g, first update %.3g (%s), state %.3g (%s)' % (
            d[0], d[1][1], d[1][0], d[2][1], d[2][0])
    print('slice 18 (b) [%s]: resnet18 on the card (TF32 off) and the CPU '
          'from the same weights, 3 Momentum steps (lr %g) at batch %d x 3 '
          'x %d x %d; losses %s; float64 card vs CPU: %s (tol %g); f32 '
          'card from float64: %s; f32 CPU from float64: %s (the card held '
          'within %g x the CPU + 1e-5); f32 card vs f32 CPU: %s; %.1f s'
          % (card, VISION_LR, RESNET_F32_BATCH, RESNET_F32_SIZE,
             RESNET_F32_SIZE, {k: ['%.7f' % v for v in ls] for k, ls in
                               out['losses'].items()}, text(f64), F64_TOL,
             text(card32), text(cpu32), F32_FACTOR, text(direct),
             out['seconds']), flush=True)
    return out


def mobilenet_phase(card):
    """Phase 27 (c): mobilenet_v2 in bf16, batch 64 x 224: its depthwise
    (grouped) convolutions and ReLU6 on the card; a first step, then one
    timed."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.vision.models import mobilenet_v2

    t0 = time.time()
    model = mobilenet_v2(device='cuda', seed=SEED).bfloat16()
    depthwise = sum(1 for m in model.modules()
                    if getattr(m, '_groups', 1) > 1 and
                    m._groups == m._in_channels)
    step = _vision_step(model, VISION_LR)
    x, y = _vision_batch(SEED + 28, VISION_BATCH, VISION_SIZE, 'cuda',
                         torch.bfloat16)
    _reset_counts(fa)
    first = step(x, y).item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    second = step(x, y).item()
    ms = (time.perf_counter() - t) * 1e3
    launches = _launches(fa)
    _check(launches == _want(2), 'mobilenet_v2 launched flash kernels: %s'
           % launches)
    _check(math.isfinite(first) and math.isfinite(second),
           'mobilenet_v2 losses %s, %s' % (first, second))
    out = {'ms': ms, 'images_s': VISION_BATCH / ms * 1e3,
           'losses': [first, second], 'depthwise': depthwise,
           'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
           'seconds': time.time() - t0}
    print('slice 18 (c) [%s]: mobilenet_v2 (bf16, %d depthwise '
          'convolutions) a Momentum step at batch %d x 3 x %d x %d: %.2f ms '
          '(the second step), %.1f images/s, peak %.2f GiB, losses %.4f, '
          '%.4f; %.1f s' % (card, depthwise, VISION_BATCH, VISION_SIZE,
                            VISION_SIZE, ms, out['images_s'],
                            out['peak_gib'], first, second, out['seconds']),
          flush=True)
    del model, step
    torch.cuda.empty_cache()
    return out


def _write_mnist(root, prefix, count, seed):
    """MNIST-format idx files (gzipped) of `count` 28 x 28 images whose
    label is drawn from the seed and marked by a bright 6 x 6 block at a
    place of its own over uint8 noise."""
    import gzip
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, count).astype(np.uint8)
    images = rng.randint(0, 64, (count, 28, 28)).astype(np.uint8)
    for i, lab in enumerate(labels):
        r, c = 2 + 8 * (lab // 3), 2 + 8 * (lab % 3)
        images[i, r:r + 6, c:c + 6] = 255
    paths = []
    for kind, head, body in (
            ('images-idx3-ubyte', struct.pack('>IIII', 2051, count, 28, 28),
             images), ('labels-idx1-ubyte', struct.pack('>II', 2049, count),
                       labels)):
        path = os.path.join(root, '%s-%s.gz' % (prefix, kind))
        with gzip.open(path, 'wb') as f:
            f.write(head + body.tobytes())
        paths.append(path)
    return paths


def lenet_fit_phase(card):
    """Phase 27 (d): the hapi drive on the card: LeNet through Model.fit
    for one epoch on MNIST-format files read by vision.datasets.MNIST
    under a transforms.Compose of Normalize, then evaluate()."""
    import tempfile

    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import vision
    from paddle_tpu_torch.vision import transforms as T

    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        tf = T.Compose([T.Normalize(mean=[0.5], std=[0.5],
                                    data_format='CHW')])
        train = vision.datasets.MNIST(*_write_mnist(root, 'train',
                                                    MNIST_TRAIN, SEED),
                                      transform=tf)
        test = vision.datasets.MNIST(*_write_mnist(root, 't10k', MNIST_TEST,
                                                   SEED + 1),
                                     mode='test', transform=tf)
        net = vision.models.LeNet(device='cuda', seed=SEED)
        model = tpt.Model(net)
        model.prepare(optimizer=tpt.optimizer.Adam(
            learning_rate=2e-3, parameters=net.parameters()),
            loss=tpt.nn.CrossEntropyLoss(), metrics=tpt.metric.Accuracy())
        before = model.evaluate(test, batch_size=256, verbose=0)
        t = time.perf_counter()
        model.fit(train, batch_size=64, epochs=1, verbose=0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        after = model.evaluate(test, batch_size=256, verbose=0)
    loss0, loss1 = float(np.mean(before['loss'])), float(np.mean(
        after['loss']))
    _check(next(net.parameters()).is_cuda, 'LeNet left the card')
    _check(math.isfinite(loss1) and loss1 < loss0, 'LeNet eval loss %.4f '
           'after the epoch not below %.4f before' % (loss1, loss0))
    steps = MNIST_TRAIN // 64
    out = {'loss_before': loss0, 'loss_after': loss1, 'acc': after['acc'],
           'fit_s': fit_s, 'step_ms': fit_s / steps * 1e3,
           'seconds': time.time() - t0}
    print('slice 18 (d) [%s]: LeNet through Model.fit, one epoch of %d '
          'MNIST-format images (%d steps of 64) in %.2f s (%.2f ms a step '
          'with the loader), evaluate() on %d: loss %.4f -> %.4f, accuracy '
          '%s; %.1f s' % (card, MNIST_TRAIN, steps, fit_s, out['step_ms'],
                          MNIST_TEST, loss0, loss1, after['acc'],
                          out['seconds']), flush=True)
    return out


def slice18_phases(card, sku):
    """Phase 27: slice 18, convolutional vision, on one card."""
    t0 = time.time()
    out = {'resnet50': resnet_train_phase(card, sku),
           'resnet18_f32': resnet_f32_phase(card),
           'mobilenet_v2': mobilenet_phase(card),
           'lenet_fit': lenet_fit_phase(card)}
    out['seconds'] = time.time() - t0
    r50 = out['resnet50']
    print('phase 27 (slice 18) [%s]: %s' % (card, json.dumps({
        'resnet50_images_s': round(r50['images_s'], 1),
        'resnet50_step_ms': round(r50['median_ms'], 2),
        'resnet50_mfu': round(r50['mfu'], 4),
        'resnet50_busy': round(r50['busy'], 3),
        'resnet50_peak_gib': round(r50['peak_gib'], 2),
        'resnet18_f64_card_vs_cpu': out['resnet18_f32']['f64'][2][1],
        'mobilenet_v2_images_s': round(out['mobilenet_v2']['images_s'], 1),
        'lenet_fit_s': round(out['lenet_fit']['fit_s'], 2),
        'seconds': round(out['seconds'], 1)})), flush=True)
    return out


# Phase 28 (slice 19, sequence models). (a) the PTB "medium" language
# model of Zaremba et al. 2014 (PaddleNLP's examples/language_model/rnnlm
# default): vocab 10000, embedding 650, a 2-layer LSTM of 650, a Linear
# head, 35 steps x batch 20, SGD lr 1.0 under ClipGradByGlobalNorm(5.0),
# dropout 0.5 on the embedding, between the layers and before the head.
# Token ids are drawn from the seed (a Zipf law over the vocabulary, the
# shape of PTB's unigrams); one batch, repeated, so the loss must fall.
PTB_CFG = dict(vocab=10000, emb=650, hidden=650, layers=2, steps=35,
               batch=20, lr=1.0, clip=5.0, dropout=0.5)
# f32 parity, dropout 0, 3 steps card vs CPU from the same weights: the
# losses within LM_LOSS_RTOL (relative), each parameter after the steps
# within LM_PARAM_TOL of its largest entry
LM_LOSS_RTOL, LM_PARAM_TOL = 1e-5, 1e-4
# (b) beam search over an LSTMCell at the hidden width and beam of
# PaddleNLP's seq2seq example (one cell layer), batch 8, 64 steps at most.
# The head's seeded weights are scaled by head_scale: with the default
# init a step's distribution over 10000 tokens is nearly uniform, and the
# best 10 of 100000 candidates lie within a few f32 ulps of each other
# (the scores reach -590 by step 64, where an ulp is 6e-5), so rounding
# alone decides the order. Scaled, a step's distribution is peaked, as a
# trained model's is.
BEAM_CFG = dict(hidden=512, vocab=10000, beam=10, batch=8, max_steps=64,
                head_scale=100.0)
# the card's and the CPU's step scores, from the same state, within
# BEAM_SCORE_RTOL of the largest: a pick may differ only where two
# candidates' scores tie within it (counted and printed)
BEAM_SCORE_RTOL = 1e-5
# (c) the small checks' tolerance: card vs CPU in f32, each tensor's
# largest error over its largest entry (at least 1)
SEQ_TOL = 1e-5


class _PtbLM(torch.nn.Module):
    """Embedding, dropout, LSTM, dropout, Linear from the port's layers;
    `loop` runs the LSTM through its per-step cell loop instead of the
    fused op (the same function)."""

    def __init__(self, dropout, device, seed):
        super().__init__()
        from paddle_tpu_torch import nn as pnn
        c = PTB_CFG
        gen = torch.Generator().manual_seed(seed)
        self.emb = pnn.Embedding(c['vocab'], c['emb'], device=device,
                                 generator=gen)
        self.lstm = pnn.LSTM(c['emb'], c['hidden'], c['layers'],
                             dropout=dropout, device=device, generator=gen)
        self.head = pnn.Linear(c['hidden'], c['vocab'], device=device,
                               generator=gen)
        self.drop = pnn.Dropout(dropout)
        self.loop = False

    def forward(self, ids):
        x = self.drop(self.emb(ids))
        out, _ = (self.lstm.forward_loop if self.loop else self.lstm)(x)
        return self.head(self.drop(out))


def _lm_step(model):
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.framework.functional import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    def loss(logits, labels):
        return pnn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    return TrainStep(model, loss, SGD(
        learning_rate=PTB_CFG['lr'], parameters=model.parameters(),
        grad_clip=pnn.ClipGradByGlobalNorm(PTB_CFG['clip'])))


def _ptb_batch(seed, device):
    """(ids, next-token labels), each [batch, steps]."""
    c = PTB_CFG
    p = 1.0 / np.arange(1, c['vocab'] + 1)
    ids = torch.from_numpy(np.random.RandomState(seed).choice(
        c['vocab'], size=(c['batch'], c['steps'] + 1), p=p / p.sum()))
    return ids[:, :-1].to(device), ids[:, 1:].to(device)


def _lm_flops_per_token():
    """6 x the multiply-adds a token of the forward: each LSTM layer's
    4h(in + h) and the head's h V (the embedding is a lookup). By hand:
    FlopCounterMode has no formula for cuDNN's RNN op."""
    c = PTB_CFG
    lstm = sum(4 * c['hidden'] * ((c['emb'] if i == 0 else c['hidden']) +
                                  c['hidden']) for i in range(c['layers']))
    return 6 * (lstm + c['hidden'] * c['vocab'])


def _lm_timed_steps(step, ids, labels, warmup, steps):
    losses = [step(ids, labels).item() for _ in range(warmup)]
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(loss.item())
    return losses, step_ms


def lm_train_phase(card, sku):
    """Phase 28 (a): the PTB-medium LSTM language model's training step
    on the card (f32, TF32 off): the fused LSTM, then the same step
    through the cell loop; then 3 steps without dropout against the CPU."""
    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = PTB_CFG
    model = _PtbLM(c['dropout'], 'cuda', SEED + 28)
    step = _lm_step(model)
    ids, labels = _ptb_batch(SEED + 28, 'cuda')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = _lm_timed_steps(step, ids, labels, 2, 10)
    peak = torch.cuda.max_memory_allocated()
    _check(all(math.isfinite(v) for v in losses), 'LSTM LM losses not '
           'finite: %s' % losses)
    _check(losses[-1] < losses[0], 'LSTM LM loss %.4f after %d steps not '
           'below the first %.4f' % (losses[-1], len(losses), losses[0]))
    median = sorted(step_ms)[len(step_ms) // 2]
    tokens = c['batch'] * c['steps']
    flops = _lm_flops_per_token() * tokens
    peak_f32 = sku[2]['float32_cuda_cores']
    wall, dev, top, ops = _profile(lambda: step(ids, labels))
    model.loop = True
    loop_losses, loop_ms = _lm_timed_steps(step, ids, labels, 1, 5)
    loop_median = sorted(loop_ms)[len(loop_ms) // 2]
    loop_wall, loop_dev, _, _ = _profile(lambda: step(ids, labels))
    del model, step

    # parity: dropout 0, 3 steps from the same weights on the card and
    # on the CPU (uncompiled f32 on both)
    runs = {}
    start = _PtbLM(0.0, 'cpu', SEED + 281).state_dict()
    for dev_name in ('cuda', 'cpu'):
        m = _PtbLM(0.0, dev_name, SEED + 282)
        m.load_state_dict(start)
        s = _lm_step(m)
        x, y = _ptb_batch(SEED + 283, dev_name)
        runs[dev_name] = ([s(x, y).item() for _ in range(3)],
                          {k: v.cpu() for k, v in m.state_dict().items()})
        del m, s
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs['cuda'][0],
                                                      runs['cpu'][0]))
    param = max(_max_rel(runs['cuda'][1], runs['cpu'][1], 1e-6).items(),
                key=lambda kv: kv[1])
    _check(loss_rel <= LM_LOSS_RTOL, 'LSTM LM f32 losses card %s vs CPU %s '
           '(%.3g apart, tol %g)' % (runs['cuda'][0], runs['cpu'][0],
                                     loss_rel, LM_LOSS_RTOL))
    _check(param[1] <= LM_PARAM_TOL, 'LSTM LM f32 parameters after 3 steps: '
           '%s %.3g of its largest entry off the CPU (tol %g)'
           % (param[0], param[1], LM_PARAM_TOL))
    torch.cuda.empty_cache()
    out = {'median_ms': median, 'tokens_s': tokens / median * 1e3,
           'mfu': flops / (median / 1e3) / peak_f32, 'busy': dev / wall,
           'peak_gib': peak / 2 ** 30, 'losses': losses,
           'loop_median_ms': loop_median, 'loop_busy': loop_dev / loop_wall,
           'parity_loss_rel': loss_rel, 'parity_param': param,
           'seconds': time.time() - t0}
    print('slice 19 (a) [%s]: PTB-medium LSTM LM (vocab %d, embedding %d, '
          '%d-layer LSTM of %d, Linear head) training, batch %d x %d '
          'tokens, SGD lr %g under ClipGradByGlobalNorm(%g), dropout %g, '
          'f32 with TF32 off: median step %.2f ms (min %.2f, max %.2f), '
          '%.1f tokens/s; %.4g FLOPs a token by hand (6 x the LSTM\'s and '
          'the head\'s multiply-adds: FlopCounterMode has no formula for '
          'cuDNN\'s RNN op), MFU %.4f of the %.0f TFLOP/s f32 peak (CUDA '
          'cores); peak memory %.2f GiB; profiled step wall %.2f ms, '
          'device kernels %.2f ms, busy share %.3f; top kernels: %s; top '
          'aten ops: %s; losses %s; the same step through the per-step '
          'cell loop: median %.2f ms (min %.2f, max %.2f; %.2fx the fused '
          'step), busy share %.3f; dropout 0, 3 steps card vs CPU: losses '
          '%s vs %s (max rel %.3g, tol %g), parameters worst %s %.3g of '
          'its largest entry (tol %g); %.1f s'
          % (card, c['vocab'], c['emb'], c['layers'], c['hidden'],
             c['batch'], c['steps'], c['lr'], c['clip'], c['dropout'],
             median, min(step_ms), max(step_ms), out['tokens_s'],
             _lm_flops_per_token(), out['mfu'], peak_f32 / 1e12,
             out['peak_gib'], wall, dev, out['busy'],
             '; '.join('%s %.2f ms x%d' % t for t in top),
             '; '.join('%s %.2f ms x%d' % t for t in ops),
             ['%.4f' % v for v in losses], loop_median, min(loop_ms),
             max(loop_ms), loop_median / median, out['loop_busy'],
             ['%.6f' % v for v in runs['cuda'][0]],
             ['%.6f' % v for v in runs['cpu'][0]], loss_rel, LM_LOSS_RTOL,
             param[0], param[1], LM_PARAM_TOL, out['seconds']), flush=True)
    return out


def _beam_decoder(device, dtype):
    """BeamSearchDecoder over LSTMCell(H, H) with an Embedding(V, H) and a
    Linear(H, V) head, weights from the seed (drawn on the CPU, so the same
    on every device), and the seeded initial states."""
    from paddle_tpu_torch import nn as pnn
    c = BEAM_CFG
    gen = torch.Generator().manual_seed(SEED + 29)
    kw = dict(device=device, generator=gen)
    cell = pnn.LSTMCell(c['hidden'], c['hidden'], **kw).to(dtype)
    emb = pnn.Embedding(c['vocab'], c['hidden'], **kw).to(dtype)
    head = pnn.Linear(c['hidden'], c['vocab'], **kw).to(dtype)
    with torch.no_grad():
        head.weight.mul_(c['head_scale'])
    dec = pnn.BeamSearchDecoder(cell, start_token=1, end_token=2,
                                beam_size=c['beam'], embedding_fn=emb,
                                output_fn=head)
    h, cc = (0.5 * torch.randn(c['batch'], c['hidden'], generator=gen)
             for _ in range(2))
    return dec, (h.to(device, dtype), cc.to(device, dtype))


def _teacher_forced(card_dec, cpu_dec, pairs):
    """Make card_dec's every step also run cpu_dec's step from a CPU copy
    of the same inputs and states, appending both steps' outputs to
    `pairs`: the CPU step is held to the card's from the card's state."""
    from torch.utils import _pytree as pytree
    card_step = card_dec.step

    def step(time, inputs, states, **kw):
        out = card_step(time, inputs, states, **kw)
        ref = cpu_dec.step(time, inputs.cpu(), pytree.tree_map(
            lambda t: t.cpu(), states), **kw)
        pairs.append(({k: v.cpu() for k, v in out[0].items()}, ref[0]))
        return out
    card_dec.step = step


def beam_search_phase(card):
    """Phase 28 (b): beam search on the card, timed in f32; then the cell
    in float64 (the steps score in f32), each card step held to the CPU's
    step from the same state."""
    from paddle_tpu_torch import nn as pnn
    t0 = time.time()
    c = BEAM_CFG
    dec, init = _beam_decoder('cuda', torch.float32)

    def decode():
        with torch.no_grad():
            return pnn.dynamic_decode(dec, inits=init,
                                      max_step_num=c['max_steps'],
                                      return_length=True)
    decode()  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        preds, _, lengths = decode()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    steps = preds.shape[1]
    _check(tuple(preds.shape) == (c['batch'], steps, c['beam']) and
           0 < steps <= c['max_steps'] and
           bool(((preds >= 0) & (preds < c['vocab'])).all()),
           'beam search predictions %s' % (tuple(preds.shape),))
    wall_s = sorted(times)[1]
    wall, dev, top, _ = _profile(decode)
    del dec, init

    pairs = []
    dec, init = _beam_decoder('cuda', torch.float64)
    _teacher_forced(dec, _beam_decoder('cpu', torch.float64)[0], pairs)
    with torch.no_grad():
        preds = pnn.dynamic_decode(dec, inits=init,
                                   max_step_num=c['max_steps'])[0].cpu()
    score_err, ties = 0.0, 0
    for got, want in pairs:
        err = ((got['scores'] - want['scores']).abs().max() /
               want['scores'].abs().max()).item()
        score_err = max(score_err, err)
        ties += int(((got['token'] != want['token']) |
                     (got['parent'] != want['parent'])).sum())
    _check(score_err <= BEAM_SCORE_RTOL, 'beam scores card vs CPU %.3g of '
           'the largest apart (tol %g)' % (score_err, BEAM_SCORE_RTOL))
    ids = torch.stack([p[0]['token'] for p in pairs])
    parents = torch.stack([p[0]['parent'] for p in pairs])
    tree_cpu = pnn.functional.gather_tree(ids, parents)
    tree_card = pnn.functional.gather_tree(ids.cuda(), parents.cuda()).cpu()
    _check(torch.equal(tree_card, tree_cpu) and
           torch.equal(tree_cpu.transpose(0, 1), preds),
           'gather_tree on the card differs from the CPU')
    picks = sum(p[0]['token'].numel() for p in pairs)
    out = {'steps': steps, 'steps_s': steps / wall_s,
           'step_ms': wall_s * 1e3 / steps, 'host_ms': (wall - dev) / steps,
           'device_ms': dev / steps, 'busy': dev / wall,
           'parity_steps': len(pairs), 'score_err': score_err,
           'ties': ties, 'picks': picks, 'seconds': time.time() - t0}
    print('slice 19 (b) [%s]: BeamSearchDecoder over LSTMCell(%d, %d), '
          'Embedding(%d, %d), Linear(%d, %d) (weights x %g), beam %d, '
          'batch %d, f32: %d steps (max_step_num %d) in %.2f ms (median of '
          '3), %.1f steps/s, %.3f ms a step; profiled decode %.2f ms wall, '
          '%.2f ms of device kernels: %.3f ms host + %.3f ms device a step, '
          'busy share %.3f; top kernels: %s; float64 cell, each of %d card '
          'steps against the CPU step from the same state: scores %.3g of '
          'the largest apart (tol %g), %d of %d picks (token, parent) '
          'differ, each at a tie within it; gather_tree identical; %.1f s'
          % (card, c['hidden'], c['hidden'], c['vocab'], c['hidden'],
             c['hidden'], c['vocab'], c['head_scale'], c['beam'],
             c['batch'], steps, c['max_steps'], wall_s * 1e3,
             out['steps_s'], out['step_ms'], wall, dev, out['host_ms'],
             out['device_ms'], out['busy'],
             '; '.join('%s %.2f ms x%d' % t for t in top),
             len(pairs), score_err, BEAM_SCORE_RTOL, ties, picks,
             out['seconds']), flush=True)
    return out


def _card_vs_cpu(fn, inputs, seed, params=lambda device: []):
    """fn(device, *inputs)'s outputs and the grads of sum(out * cot) by its
    floating inputs and params(device), on the card and on the CPU from
    the same inputs: the worst error, each tensor's largest error over its
    largest entry (at least 1; an integer output counts 1 unless equal)."""
    res = {}
    for dev_name in ('cuda', 'cpu'):
        xs = [x.to(dev_name).requires_grad_(x.is_floating_point())
              for x in inputs]
        outs = fn(dev_name, *xs)
        gen = torch.Generator().manual_seed(seed)
        loss = sum((o * torch.randn(o.shape, generator=gen).to(dev_name))
                   .sum() for o in outs if o.is_floating_point())
        floats = [x for x in xs if x.requires_grad] + list(params(dev_name))
        grads = torch.autograd.grad(loss, floats)
        res[dev_name] = [o.detach().cpu().double() for o in outs] + \
            [g.cpu().double() for g in grads]
    errs = [((a - b).abs().max() / max(b.abs().max().item(), 1.0)).item()
            if a.is_floating_point() else float(not torch.equal(a, b))
            for a, b in zip(res['cuda'], res['cpu'])]
    return max(errs)


def seq_checks_phase(card):
    """Phase 28 (c): a bidirectional 2-layer GRU with sequence_length (a
    row of length 0 among them), ctc_loss with its logit gradients, the
    CRF cost and crf_decoding: the card against the CPU in f32."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import static
    t0 = time.time()
    gen = torch.Generator().manual_seed(SEED + 30)
    grus = {d: pnn.GRU(32, 64, 2, 'bidirect', device=d,
                       generator=torch.Generator().manual_seed(SEED + 31))
            for d in ('cuda', 'cpu')}

    def gru(dev_name, x, lens):
        return grus[dev_name](x, sequence_length=lens)
    lens = torch.tensor([20, 0, 7, 13, 1, 20])
    gru_err = _card_vs_cpu(gru, [torch.randn(6, 20, 32, generator=gen),
                                 lens], 1, lambda d: grus[d].parameters())

    logits = torch.randn(50, 8, 30, generator=gen)
    labels = torch.randint(1, 30, (8, 12), generator=gen)
    il = torch.tensor([50, 45, 40, 50, 30, 20, 50, 12])
    ll = torch.tensor([12, 10, 8, 12, 5, 3, 1, 7])

    def ctc(dev_name, x, lab, i, n):
        return (pnn.functional.ctc_loss(x, lab, i, n, reduction='none'),)
    ctc_err = _card_vs_cpu(ctc, [logits, labels, il, ll], 2)

    em = torch.randn(8, 30, 12, generator=gen)
    tags = torch.randint(0, 12, (8, 30), generator=gen)
    trans = torch.randn(14, 12, generator=gen) * 0.3
    crf_lens = torch.tensor([30, 25, 1, 17, 30, 8, 12, 29])

    def crf(dev_name, e, lab, t, n):
        cost, _ = static.nn.linear_chain_crf(e, lab, length=n, transition=t)
        return cost, static.nn.crf_decoding(e, t, length=n)
    crf_err = _card_vs_cpu(crf, [em, tags, trans, crf_lens], 3)
    for what, err in (('GRU', gru_err), ('ctc_loss', ctc_err),
                      ('CRF', crf_err)):
        _check(err <= SEQ_TOL, '%s card vs CPU %.3g apart (tol %g)'
               % (what, err, SEQ_TOL))
    out = {'gru': gru_err, 'ctc': ctc_err, 'crf': crf_err,
           'seconds': time.time() - t0}
    print('slice 19 (c) [%s]: card vs CPU in f32, outputs and gradients, '
          'the worst error over the largest entry: GRU(32, 64, 2 layers, '
          'bidirect) over 6 x 20 with lengths %s %.3g; ctc_loss T 50 B 8 '
          'C 30 (labels up to 12) %.3g; linear_chain_crf + crf_decoding '
          '8 x 30 x 12 %.3g (decoded tags identical); tol %g; %.1f s'
          % (card, lens.tolist(), gru_err, ctc_err, crf_err, SEQ_TOL,
             out['seconds']), flush=True)
    return out


def slice19_phases(card, sku):
    """Phase 28: slice 19, sequence models, on one card; no flash kernel
    is on this path."""
    from paddle_tpu_torch.ops import flash_attention as fa
    t0 = time.time()
    _reset_counts(fa)
    out = {'lm': lm_train_phase(card, sku), 'beam': beam_search_phase(card),
           'checks': seq_checks_phase(card)}
    launches = _launches(fa)
    _check(launches == _want(0), 'the sequence-model path launched flash '
           'kernels: %s' % launches)
    out['seconds'] = time.time() - t0
    lm, beam = out['lm'], out['beam']
    print('phase 28 (slice 19) [%s]: %s' % (card, json.dumps({
        'lm_step_ms': round(lm['median_ms'], 2),
        'lm_tokens_s': round(lm['tokens_s'], 1),
        'lm_mfu': round(lm['mfu'], 4), 'lm_busy': round(lm['busy'], 3),
        'lm_peak_gib': round(lm['peak_gib'], 2),
        'lm_loop_step_ms': round(lm['loop_median_ms'], 2),
        'lm_parity_loss_rel': lm['parity_loss_rel'],
        'beam_steps_s': round(beam['steps_s'], 1),
        'beam_step_ms': round(beam['step_ms'], 3),
        'beam_busy': round(beam['busy'], 3),
        'flash_launches': sum(launches.values()),
        'seconds': round(out['seconds'], 1)})), flush=True)
    return out


# Phase 29 (slice 20, detection). (a) BASELINE config 4, PP-YOLOv2
# inference as bench_extra.py's bench_yolo_infer drives it: ppyolov2(80
# classes) at its defaults (width 32, 320 x 320), eval, f32, seeded
# images; the forward with decode at batch 1 and 8, 3 repeats of 10
# calls, the median and the spread; postprocess (matrix NMS, keep_top_k
# 100) on each batch's outputs on its own; each with TF32 off and with
# torch's default for convolutions (TF32 on).
YOLO_CFG = dict(num_classes=80, width=32, img_size=320)
YOLO_BATCHES = (1, 8)
YOLO_CALLS, YOLO_REPS = 10, 3
# (b) card against CPU, TF32 off: decode within DECODE_TOL of the largest
# |value|; NMS rows on the CPU decode's outputs: labels, counts and boxes
# equal, scores within NMS_SCORE_TOL (rows whose scores tie within it may
# swap places: counted); roi_align, yolo_loss and deform_conv2d values
# and gradients within DET_TOL of each tensor's largest entry (at least 1)
DECODE_TOL, NMS_SCORE_TOL, DET_TOL = 1e-4, 1e-5, 1e-5
# NMS rows whose scores lie within this many f32 units in the last place
# of each other tie: the two devices' rounding orders them
TIE_ULPS = 4
# (d) the fluid PP-YOLO tail as PaddleDetection exports it: yolo_box on
# the stride-32 head (80 classes), transpose2, multiclass_nms3
YOLO_TAIL_NMS = dict(score_threshold=0.01, nms_top_k=1000, keep_top_k=100,
                     nms_threshold=0.45, normalized=True,
                     background_label=-1)


def _conv_flops(model, x):
    """A forward's FLOPs by hand from the layers' shapes, as _layer_flops
    counts them (2 x in / groups x prod(k) x out x the output's
    positions a convolution), for the forward only."""
    from paddle_tpu_torch.nn.layer.conv import _ConvNd
    counts = []

    def hook(layer, args, out):
        k = int(np.prod(layer._kernel_size))
        counts.append(2 * layer._in_channels // layer._groups * k *
                      out.numel())
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, _ConvNd)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return sum(counts), len(counts)


def _reps_ms(fn, calls, reps):
    """bench_extra's timing: `reps` repeats of `calls` calls, each repeat
    ending in a synchronise; the ms a call of each repeat."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / calls)
    return out


def yolo_infer_phase(card, sku):
    """Phase 29 (a): BASELINE config 4 on the card."""
    from paddle_tpu_torch.vision.models import ppyolov2

    t0 = time.time()
    model = ppyolov2(**YOLO_CFG, device='cuda', seed=SEED).eval()
    params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(SEED + 29)
    size = YOLO_CFG['img_size']
    images = {b: torch.rand(b, 3, size, size, generator=gen).cuda()
              for b in YOLO_BATCHES}
    flops, convs = _conv_flops(model, images[1])
    peaks = {False: ('f32 CUDA cores', sku[2]['float32_cuda_cores']),
             True: ('TF32', 3 * sku[2]['float32'])}
    saved = torch.backends.cudnn.allow_tf32
    rows = []
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            for b in YOLO_BATCHES:
                x = images[b]
                with torch.no_grad():
                    torch.cuda.reset_peak_memory_stats()
                    fwd = _reps_ms(lambda: model(x), YOLO_CALLS, YOLO_REPS)
                    peak = torch.cuda.max_memory_allocated()
                    boxes, scores = model(x)
                    post = _reps_ms(lambda: model.postprocess(boxes, scores),
                                    YOLO_CALLS, YOLO_REPS)
                    out, num = model.postprocess(boxes, scores)
                _check(bool(torch.isfinite(boxes).all()) and
                       bool(torch.isfinite(scores).all()),
                       'PP-YOLOv2 decode not finite')
                _check(tuple(out.shape) == (b * 100, 6) and
                       out.is_cuda and num.dtype == torch.int32,
                       'postprocess gave %s %s' % (tuple(out.shape),
                                                   num.dtype))
                med = sorted(fwd)[len(fwd) // 2]
                row = {'tf32': tf32, 'batch': b, 'ms': med,
                       'ms_img': med / b, 'qps': b / med * 1e3,
                       'spread_ms': max(fwd) - min(fwd), 'reps_ms': fwd,
                       'post_ms': sorted(post)[len(post) // 2],
                       'post_spread_ms': max(post) - min(post),
                       'kept': num.tolist(), 'peak_gib': peak / 2 ** 30,
                       'mfu': flops * b / (med / 1e3) / peaks[tf32][1],
                       'peak_name': peaks[tf32][0]}
                if not tf32:
                    with torch.no_grad():
                        wall, dev, top, _ = _profile(lambda: model(x))
                        pwall, pdev, ptop, _ = _profile(
                            lambda: model.postprocess(boxes, scores))
                    row.update(busy=dev / wall, top=top, post_busy=pdev /
                               pwall, post_top=ptop)
                rows.append(row)
                print('slice 20 (a) [%s]: PP-YOLOv2 (80 classes, width 32, '
                      '%d x %d, %.2f M parameters, %d convolutions, %.4g '
                      'GFLOP an image by hand), eval f32, TF32 %s, batch %d: '
                      'forward + decode %.3f ms (%s), %.3f ms/img, %.1f QPS, '
                      'spread %.3f ms, MFU %.4f of the %s peak; postprocess '
                      '(matrix_nms, keep_top_k 100) %.3f ms (spread %.3f), '
                      'rows kept %s; peak %.3f GiB%s'
                      % (card, size, size, params / 1e6, convs, flops / 1e9,
                         'on' if tf32 else 'off', b, med,
                         ', '.join('%.3f' % v for v in fwd), row['ms_img'],
                         row['qps'], row['spread_ms'], row['mfu'],
                         row['peak_name'], row['post_ms'],
                         row['post_spread_ms'], row['kept'],
                         row['peak_gib'],
                         '' if tf32 else '; profiled forward busy %.3f, top '
                         'kernels: %s; postprocess busy %.3f, top kernels: '
                         '%s' % (row['busy'], '; '.join(
                             '%s %.3f ms x%d' % t for t in row['top']),
                             row['post_busy'], '; '.join(
                                 '%s %.3f ms x%d' % t
                                 for t in row['post_top']))), flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    del model, images
    torch.cuda.empty_cache()
    return {'rows': rows, 'params': params, 'flops': flops, 'convs': convs,
            'seconds': time.time() - t0}


def _nms_rows(got, want, keep, score_tol, box_tol):
    """Two NMS outputs [B * keep, 6] (the card's, the CPU's): scores within
    score_tol row by row, and each CPU row's label and box (within
    box_tol) on the card in the same place, except among rows whose CPU
    scores tie within TIE_ULPS units in the last place (f32 rounding of
    the two devices orders them): such a run is matched as a set, and
    when keep cuts it, its rows past the cut may differ. Returns (rows a
    tie placed, rows a tie at the cut left out, the largest box error)."""
    _check(np.abs(got[:, 1] - want[:, 1]).max() <= score_tol,
           'NMS scores %.3g apart (tol %g)'
           % (np.abs(got[:, 1] - want[:, 1]).max(), score_tol))
    moved, cut, b_err = 0, 0, 0.0
    for g, w in zip(got.reshape(-1, keep, 6), want.reshape(-1, keep, 6)):
        start = 0
        for end in range(1, keep + 1):
            if end < keep and abs(w[end, 1] - w[end - 1, 1]) <= \
                    TIE_ULPS * np.spacing(np.float32(w[end - 1, 1])):
                continue
            free = list(range(start, end))
            for i in range(start, end):
                hit = next((j for j in free if g[j, 0] == w[i, 0] and
                            np.abs(g[j, 2:] - w[i, 2:]).max() <= box_tol),
                           None)
                if hit is None:
                    _check(end == keep and end - start > 1, 'NMS row %d '
                           '(%s) of the CPU has no match on the card among '
                           'the rows tied with it: %s'
                           % (i, w[i], g[start:end]))
                    cut += 1
                    continue
                free.remove(hit)
                moved += hit != i
                b_err = max(b_err, float(np.abs(g[hit, 2:] - w[i, 2:])
                                         .max()))
            start = end
    return moved, cut, b_err


def yolo_parity_phase(card):
    """Phase 29 (b): the same weights on the CPU and the card, TF32 off."""
    from paddle_tpu_torch.vision import detection, ops
    from paddle_tpu_torch.vision.models import ppyolov2

    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = ppyolov2(**YOLO_CFG, device='cpu', seed=SEED + 1).eval()
    on_card = ppyolov2(**YOLO_CFG, device='cuda', seed=SEED + 2).eval()
    on_card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(SEED + 291)
    size = YOLO_CFG['img_size']
    x = torch.rand(2, 3, size, size, generator=gen)
    with torch.no_grad():
        want = cpu(x)
        got = on_card(x.cuda())
    decode = [((g.cpu() - w).abs().max() / w.abs().max()).item()
              for g, w in zip(got, want)]
    _check(max(decode) <= DECODE_TOL, 'decode card vs CPU %s of the largest '
           '(tol %g)' % (decode, DECODE_TOL))
    boxes, scores = want
    nms = {}
    for name, fn, kw in (
            ('matrix_nms', detection.matrix_nms, dict(
                score_threshold=0.01, post_threshold=0.01, nms_top_k=400,
                keep_top_k=100, use_gaussian=True, background_label=-1)),
            ('multiclass_nms', detection.multiclass_nms, dict(
                score_threshold=0.01, nms_top_k=400, keep_top_k=100,
                nms_threshold=0.45, background_label=-1))):
        c_out, c_num = fn(boxes, scores, **kw)
        g_out, g_num = fn(boxes.cuda(), scores.cuda(), **kw)
        _check(g_out.is_cuda and torch.equal(g_num.cpu(), c_num),
               '%s counts card %s vs CPU %s' % (name, g_num.tolist(),
                                                c_num.tolist()))
        g_np, c_np = g_out.cpu().numpy(), c_out.numpy()
        moved, cut, b_err = _nms_rows(g_np, c_np, 100, NMS_SCORE_TOL, 0.0)
        nms[name] = {'counts': c_num.tolist(), 'tie_rows': moved,
                     'tie_cut_rows': cut, 'score_err': float(np.abs(
                         g_np[:, 1] - c_np[:, 1]).max()), 'box_err': b_err}

    rng = torch.Generator().manual_seed(SEED + 292)
    feat = torch.randn(2, 64, 40, 40, generator=rng)
    rois = torch.rand(64, 4, generator=rng) * 300 - 20
    rois[:, 2:] += rois[:, :2] + 16    # some reach past the 320 image
    rois_num = torch.tensor([40, 24])
    # the value only: samples past the map weigh the edge pixels by
    # extrapolated weights of either sign, and the feature map's gradient
    # sums them in an order of the device's choosing (two CPU runs part
    # by 1.7e-5 of its largest entry)
    with torch.no_grad():
        roi_out = [ops.roi_align(feat.to(d), rois.to(d), rois_num.to(d), 7,
                                 spatial_scale=1 / 8, sampling_ratio=2).cpu()
                   for d in ('cuda', 'cpu')]
    roi_err = ((roi_out[0] - roi_out[1]).abs().max() /
               max(roi_out[1].abs().max().item(), 1.0)).item()
    head = torch.randn(8, 255, 10, 10, generator=rng)
    gt = torch.rand(8, 20, 4, generator=rng) * 0.5
    gt[..., :2] += 0.25
    gt[:, 15:] = 0.0                   # padded boxes
    gt_label = torch.randint(0, 80, (8, 20), generator=rng)

    def yolo(dev_name, a, b, lab):
        return (ops.yolo_loss(a, b, lab, anchors=sum(
            on_card.ANCHORS, []), anchor_mask=[6, 7, 8], class_num=80,
            ignore_thresh=0.7, downsample_ratio=32, scale_x_y=1.05),)
    yolo_err = _card_vs_cpu(yolo, [head, gt, gt_label], 2)
    dx = torch.randn(2, 128, 20, 20, generator=rng)
    doff = torch.randn(2, 18, 20, 20, generator=rng) * 2
    dw = torch.randn(128, 128, 3, 3, generator=rng) * 0.03
    db = torch.randn(128, generator=rng)
    dm = torch.rand(2, 9, 20, 20, generator=rng)

    def deform(dev_name, a, o, w, b, m):
        return (ops.deform_conv2d(a, o, w, b, padding=1, mask=m),)
    deform_err = _card_vs_cpu(deform, [dx, doff, dw, db, dm], 3)
    for what, err in (('roi_align', roi_err), ('yolo_loss', yolo_err),
                      ('deform_conv2d', deform_err)):
        _check(err <= DET_TOL, '%s card vs CPU %.3g apart (tol %g)'
               % (what, err, DET_TOL))
    del cpu, on_card
    torch.cuda.empty_cache()
    out = {'decode': decode, 'nms': nms, 'roi_align': roi_err,
           'yolo_loss': yolo_err, 'deform_conv2d': deform_err,
           'seconds': time.time() - t0}
    print('slice 20 (b) [%s]: card vs CPU, f32, TF32 off: PP-YOLOv2 decode '
          'at batch 2 x %d, boxes %.3g and scores %.3g of the largest (tol '
          '%g); on the CPU decode\'s outputs: %s (labels, counts and boxes '
          'equal, scores within %g; rows placed by a tie within %d ulps '
          'counted, and those a tie at the cut left out); '
          'roi_align 64 rois (some past the image) 7 x 7 over [2, 64, 40, '
          '40] %.3g (the value), yolo_loss [8, 255, 10, 10] with 20 boxes '
          'an image %.3g, deform_conv2d [2, 128, 20, 20] 3 x 3 with a mask '
          '%.3g (values and gradients), each of its largest entry (tol %g); '
          '%.1f s'
          % (card, size, decode[0], decode[1], DECODE_TOL, json.dumps(nms),
             NMS_SCORE_TOL, TIE_ULPS, roi_err, yolo_err, deform_err, DET_TOL,
             out['seconds']), flush=True)
    return out


def yolo_predictor_phase(card):
    """Phase 29 (c): jit.save of the eval model, then a Predictor on the
    card at BASELINE config 4's batch (YOLO_BATCHES[-1] x 320), its
    Inductor cache in a directory of its own, held to the eager forward;
    then phase 32 (b) (capi_phase) serves the same artifact from a child
    process against this Predictor, before the directory is removed.
    TF32 is off for the convolutions and the matmuls, the matmuls under a
    fresh process's setting (capi_phase turns cuDNN's on, as the child has
    it); both settings are restored at the end."""
    import shutil
    import tempfile

    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.vision.models import ppyolov2

    t0 = time.time()
    matmul = torch.backends.cuda.matmul
    settings = (torch.backends.cudnn.allow_tf32,
                getattr(matmul, 'fp32_precision', None))
    torch.backends.cudnn.allow_tf32 = False
    if MATMUL_FP32_DEFAULT is not None:  # TF32 off for matmuls all the same
        matmul.fp32_precision = MATMUL_FP32_DEFAULT
    model = ppyolov2(**YOLO_CFG, device='cuda', seed=SEED).eval()
    size, batch = YOLO_CFG['img_size'], YOLO_BATCHES[-1]
    x = np.random.RandomState(SEED + 293).rand(batch, 3, size, size).astype(
        np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x).cuda())[0].cpu().numpy()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_yolo_')
    try:
        path = os.path.join(tmp, 'ppyolov2')
        jit.save(model, path)
        config = inference.Config(path)
        config.enable_use_gpu()
        before = os.environ.get('TORCHINDUCTOR_CACHE_DIR')
        config.set_optim_cache_dir(os.path.join(tmp, 'inductor'))
        pred = inference.create_predictor(config)
        name = pred.get_input_names()[0]
        t1 = time.perf_counter()
        pred.get_input_handle(name).copy_from_cpu(x)
        pred.run()
        compile_s = time.perf_counter() - t1
        # the later phases compile into the cache they used before
        if before is None:
            os.environ.pop('TORCHINDUCTOR_CACHE_DIR', None)
        else:
            os.environ['TORCHINDUCTOR_CACHE_DIR'] = before
        handle = pred.get_output_handle(pred.get_output_names()[0])
        boxes = handle.copy_to_cpu()
        err = float(np.abs(boxes - want).max() / np.abs(want).max())
        _check(err <= DECODE_TOL, 'Predictor boxes vs eager %.3g of the '
               'largest (tol %g)' % (err, DECODE_TOL))
        run_ms = []
        for _ in range(20):
            t1 = time.perf_counter()
            pred.get_input_handle(name).copy_from_cpu(x)
            pred.run()
            handle.copy_to_cpu()
            run_ms.append((time.perf_counter() - t1) * 1e3)
        _check(pred.compile_count() == 1, 'Predictor compiled %d programs'
               % pred.compile_count())
        out = {'err': err, 'compile_s': compile_s, 'p50_ms': _p50(run_ms),
               'seconds': time.time() - t0}
        print('slice 20 (c) [%s]: jit.save -> Config / create_predictor on '
              'the card, batch %d x %d: first run (compiles) %.2f s, run() '
              'p50 %.3f ms over 20 (numpy in, boxes back to the host), boxes '
              '%.3g of the largest off the eager forward (tol %g); %.1f s'
              % (card, batch, size, compile_s, out['p50_ms'], err,
                 DECODE_TOL, out['seconds']), flush=True)
        out['capi'] = capi_phase(card, pred, x, path,
                                 os.path.join(tmp, 'inductor'), tmp)
    finally:
        torch.backends.cudnn.allow_tf32 = settings[0]
        if settings[1] is not None:
            matmul.fp32_precision = settings[1]
        shutil.rmtree(tmp, ignore_errors=True)
    del model, pred
    torch.cuda.empty_cache()
    return out


def yolo_fluid_phase(card):
    """Phase 29 (d): the fluid PP-YOLO tail (yolo_box -> transpose2 ->
    multiclass_nms3, as tests/test_fluid_interop.py writes it) through
    load_fluid_model compiled on the card, against the op table run on
    the CPU (uncompiled)."""
    import shutil
    import tempfile

    from paddle_tpu_torch.inference import fluid_program

    t0 = time.time()
    na, cls, h, batch = 3, 80, 10, 8
    c = na * (5 + cls)
    variables = [_pb_var('head', dims=[-1, c, h, h]),
                 _pb_var('imgsz', dims=[-1, 2], dtype=2),
                 _pb_var('boxes', dims=[-1, na * h * h, 4]),
                 _pb_var('scores_mc', dims=[-1, na * h * h, cls]),
                 _pb_var('scores', dims=[-1, cls, na * h * h]),
                 _pb_var('dets', dims=[-1, 6]),
                 _pb_var('rois_n', dims=[-1], dtype=2)]
    ops = [_pb_op('yolo_box', {'X': ['head'], 'ImgSize': ['imgsz']},
                  {'Boxes': ['boxes'], 'Scores': ['scores_mc']},
                  anchors=[116, 90, 156, 198, 373, 326], class_num=cls,
                  conf_thresh=0.01, downsample_ratio=32, clip_bbox=True,
                  scale_x_y=1.05),
           _pb_op('transpose2', {'X': ['scores_mc']}, {'Out': ['scores']},
                  axis=[0, 2, 1]),
           _pb_op('multiclass_nms3', {'BBoxes': ['boxes'],
                                      'Scores': ['scores']},
                  {'Out': ['dets'], 'NmsRoisNum': ['rois_n']},
                  **YOLO_TAIL_NMS)]
    gen = np.random.RandomState(SEED + 294)
    feed = {'head': gen.randn(batch, c, h, h).astype(np.float32),
            'imgsz': np.full((batch, 2), 320, np.int32)}
    root = tempfile.mkdtemp(prefix='chip_smoke_yolo_fluid_')
    try:
        model, _ = _write_fluid(root, 'yolo_tail', ['head', 'imgsz'],
                                ['dets', 'rois_n'], variables, ops, {},
                                False)
        ref = fluid_program.load_fluid_model(model, device='cpu')
        with torch.no_grad():
            want = [t.numpy() for t in ref._forward(
                *[torch.from_numpy(feed[n]) for n in ('head', 'imgsz')])]
        prog = fluid_program.load_fluid_model(model, device='cuda')
        t1 = time.perf_counter()
        got = prog.run(feed)
        compile_s = time.perf_counter() - t1
        ms = _timed_runs(lambda: prog.run(feed), 5)
        tensors = prog.run(feed, return_numpy=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _check(all(t.is_cuda for t in tensors), 'the fluid tail left the card')
    _check(np.array_equal(got[1], want[1]), 'fluid tail counts card %s vs '
           'CPU %s' % (got[1].tolist(), want[1].tolist()))
    keep = YOLO_TAIL_NMS['keep_top_k']
    moved, cut, b_err = _nms_rows(got[0], want[0], keep, NMS_SCORE_TOL,
                                  DECODE_TOL * 320)
    s_err = float(np.abs(got[0][:, 1] - want[0][:, 1]).max())
    _check(prog.compile_count() == 1, 'the fluid tail compiled %d graphs'
           % prog.compile_count())
    out = {'counts': want[1].tolist(), 'tie_rows': moved,
           'tie_cut_rows': cut, 'score_err': s_err, 'box_err': b_err, 'compile_s': compile_s, 'run_p50_ms': _p50(ms),
           'seconds': time.time() - t0}
    print('slice 20 (d) [%s]: the fluid PP-YOLO tail (yolo_box on [%d, %d, '
          '%d, %d], 80 classes, transpose2, multiclass_nms3 %s) compiled on '
          'the card: first run %.2f s, run p50 %.3f ms; against the CPU: '
          'counts %s equal, %d rows placed by a score tie within %d ulps, '
          '%d left out by one at the cut, scores %.3g (tol %g), boxes %.3g '
          'px apart; %.1f s'
          % (card, batch, c, h, h, json.dumps(YOLO_TAIL_NMS), compile_s,
             out['run_p50_ms'], out['counts'], moved, TIE_ULPS, cut, s_err,
             NMS_SCORE_TOL, b_err, out['seconds']), flush=True)
    return out


def slice20_phases(card, sku):
    """Phase 29: slice 20, detection, on one card; no flash kernel is on
    this path."""
    from paddle_tpu_torch.ops import flash_attention as fa
    t0 = time.time()
    _reset_counts(fa)
    out = {'infer': yolo_infer_phase(card, sku),
           'parity': yolo_parity_phase(card),
           'predictor': yolo_predictor_phase(card),
           'fluid': yolo_fluid_phase(card)}
    launches = _launches(fa)
    _check(launches == _want(0), 'the detection path launched flash '
           'kernels: %s' % launches)
    out['seconds'] = time.time() - t0
    rows = {(r['tf32'], r['batch']): r for r in out['infer']['rows']}
    summary = {}
    for tf32 in (False, True):
        for b in YOLO_BATCHES:
            r = rows[tf32, b]
            key = 'b%d_tf32_%s' % (b, 'on' if tf32 else 'off')
            summary[key + '_ms_img'] = round(r['ms_img'], 3)
            summary[key + '_qps'] = round(r['qps'], 1)
            summary[key + '_post_ms'] = round(r['post_ms'], 3)
    for b in YOLO_BATCHES:
        summary['b%d_busy' % b] = round(rows[False, b]['busy'], 3)
        summary['b%d_post_busy' % b] = round(rows[False, b]['post_busy'], 3)
    parity = out['parity']
    summary.update({
        'decode_err': max(parity['decode']),
        'nms_tie_rows': {k: [v['tie_rows'], v['tie_cut_rows']]
                         for k, v in parity['nms'].items()},
        'roi_yolo_deform_err': [parity['roi_align'], parity['yolo_loss'],
                                parity['deform_conv2d']],
        'predictor_p50_ms': round(out['predictor']['p50_ms'], 3),
        'fluid_tie_rows': [out['fluid']['tie_rows'],
                           out['fluid']['tie_cut_rows']],
        'flash_launches': sum(launches.values()),
        'seconds': round(out['seconds'], 1)})
    print('phase 29 (slice 20) [%s]: %s' % (card, json.dumps(summary)),
          flush=True)
    return out


# Phase 30 (slice 21, quantization and the rest of incubate).
# (a) weight-only int8 serving on phase 4's model and prompts (8 x 768,
# 128 new); the engine at 8 slots; the f32 checks at 2 layers on 2 prompts
# of 512, 16 new tokens, the last prefill logits within INT8_LOGIT_TOL
INT8_NEW, INT8_SLOTS = 128, 8
INT8_PARITY_LAYERS, INT8_PARITY_ROWS, INT8_PARITY_LEN = 2, 2, 512
INT8_PARITY_NEW, INT8_LOGIT_TOL = 16, 1e-4
# (c) PTQ of ResNet-50: 2 calibration batches of 16 x 224 (4 before slice
# 23); the card-vs-CPU scales on resnet18 at 8 x 224, 2 batches, within
# PTQ_SCALE_RTOL
PTQ_ALGOS = ('abs_max', 'avg', 'mse', 'KL', 'hist')
PTQ_BATCHES, PTQ_BATCH = 2, 16
PTQ_PARITY_BATCHES, PTQ_PARITY_BATCH, PTQ_SCALE_RTOL = 2, 8, 1e-5
# (d) ASP on phase 6's bench GPT: 3 eager steps at batch 8 x 512
ASP_BATCH, ASP_STEPS = 8, 3


def _generate_rates(model, ids, new):
    """generate(ids, new) as phase 4 times it: (prefill ms, call ms,
    decode tokens/s, peak GiB), the prefill and the call each the median of
    3 calls."""
    def median_s(n):
        calls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate(ids, max_new_tokens=n)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
        return sorted(calls)[1]

    torch.cuda.reset_peak_memory_stats()
    total = median_s(new)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prefill = median_s(1)
    tps = ids.shape[0] * (new - 1) / max(total - prefill, 1e-9)
    return prefill * 1e3, total * 1e3, tps, peak


def int8_serving_phase(card):
    """Phase 30 (a): GPT-2 small in bf16 served plain, then with its
    Linears swapped for WeightOnlyLinear, through generate() and the slot
    engine."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.slim import (WeightOnlyLinear, quantize_weight_only,
                                       streamed_bytes)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    t0 = time.time()
    cfg = GPTConfig.gpt2_small()
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval().bfloat16()
    ids = torch.randint(0, cfg.vocab_size, (8, 768),
                        generator=torch.Generator().manual_seed(SEED))
    prompts = ids.tolist()
    ids = ids.cuda()
    wte = model.gpt.wte.weight
    rows = {}
    for label in ('bf16', 'int8w'):
        if label == 'int8w':
            swapped = quantize_weight_only(model)
            _check(swapped == 4 * cfg.num_layers, 'quantize_weight_only '
                   'swapped %d Linears, want %d' % (swapped,
                                                    4 * cfg.num_layers))
            _check(model.lm_head is None and model.gpt.wte.weight is wte,
                   'the tied head did not stay the embedding')
            _check(all(isinstance(m, WeightOnlyLinear) for b in model.gpt.h
                       for m in (b.attn.qkv_proj, b.attn.out_proj,
                                 b.mlp.fc_in, b.mlp.fc_out)),
                   'a block kept a float Linear')
        model.generate(ids[:, :64], max_new_tokens=2)  # warm-up, no flash
        _reset_counts(fa)
        first = model.generate(ids, max_new_tokens=1)[:, -1].cpu()
        torch.cuda.synchronize()
        launches = _launches(fa)
        _check(launches == _want(1, flash_fwd=cfg.num_layers),
               '%s prefill launches %s, want %d flash_fwd' % (
                   label, launches, cfg.num_layers))
        prefill_ms, call_ms, tps, peak = _generate_rates(model, ids, INT8_NEW)
        eng = ContinuousBatchingEngine(model, num_slots=INT8_SLOTS,
                                       max_len=1024, prefill_chunk=128,
                                       decode_block=4)
        eng.generate([p[:64] for p in prompts[:2]], max_new_tokens=8)
        _reset_counts(fa)
        _, wall, _ = _serve(eng, prompts, INT8_NEW)
        _check(_launches(fa) == _want(1), 'the slot engine launched a '
               'flash kernel: %s' % _launches(fa))
        del eng
        rows[label] = {'prefill_ms': prefill_ms, 'call_ms': call_ms,
                       'decode_tps': tps, 'peak_gib': peak,
                       'engine_tps': len(prompts) * INT8_NEW / wall,
                       'streamed_bytes': streamed_bytes(model),
                       'launches': launches['flash_fwd'], 'first': first}
    agree = int((rows['bf16']['first'] == rows['int8w']['first']).sum())
    swapped = 4 * len(model.gpt.h)
    del model
    torch.cuda.empty_cache()
    b, q = rows['bf16'], rows['int8w']
    print('slice 21 (a) [%s]: GPT-2 small bf16, 8 x 768 + %d new, greedy: '
          'plain prefill %.2f ms, decode %.1f tokens/s (call %.1f ms), peak '
          '%.2f GiB, streamed_bytes %.0f, slot engine (%d slots) %.1f '
          'tokens/s; weight-only int8 (%d Linears): prefill %.2f ms, decode '
          '%.1f tokens/s (call %.1f ms), peak %.2f GiB, streamed_bytes %.0f '
          '(%.3f of plain), engine %.1f tokens/s; int8 / plain decode %.3f, '
          'engine %.3f; first tokens agreeing %d of 8; flash launches a '
          'prefill %d / %d; %.1f s'
          % (card, INT8_NEW, b['prefill_ms'], b['decode_tps'], b['call_ms'],
             b['peak_gib'], b['streamed_bytes'], INT8_SLOTS, b['engine_tps'],
             swapped, q['prefill_ms'], q['decode_tps'], q['call_ms'],
             q['peak_gib'], q['streamed_bytes'],
             q['streamed_bytes'] / b['streamed_bytes'], q['engine_tps'],
             q['decode_tps'] / b['decode_tps'],
             q['engine_tps'] / b['engine_tps'], agree, b['launches'],
             q['launches'], time.time() - t0), flush=True)
    parity = int8_parity_phase()
    print('slice 21 (a) f32 [%s]: weight-only int8 GPT-2 small cut to %d '
          'layers, %d prompts of %d: int8 weights card == CPU, prefill '
          'logits max abs err %.3g (tol %g), %d x %d greedy tokens equal the '
          "CPU's, the slot engine's equal generate()'s, kernels %s"
          % (card, INT8_PARITY_LAYERS, INT8_PARITY_ROWS, INT8_PARITY_LEN,
             parity['err'], INT8_LOGIT_TOL, INT8_PARITY_ROWS,
             INT8_PARITY_NEW, sorted(parity['kernels'])), flush=True)
    return {'rows': rows, 'first_token_agree': agree, 'parity': parity,
            'seconds': time.time() - t0}


def int8_parity_phase():
    """Phase 30 (a), f32 at INT8_PARITY_LAYERS layers: the card's
    quantized GPT against the same quantized model on the CPU."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.slim import quantize_weight_only
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.gpt2_small()
    cfg.num_layers = INT8_PARITY_LAYERS
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).eval()
    cpu = GPTForCausalLM(cfg, device='cpu', seed=SEED + 1).eval()
    cpu.load_state_dict(model.state_dict())
    _check(quantize_weight_only(model) == quantize_weight_only(cpu) ==
           4 * cfg.num_layers, 'f32 swap count')
    cpu_state = cpu.state_dict()
    for k, v in model.state_dict().items():
        _check(v.dtype == cpu_state[k].dtype and
               torch.equal(v.cpu(), cpu_state[k]),
               'the int8 quantization of %s differs from the CPU\'s' % k)
    ids = torch.randint(0, cfg.vocab_size, (INT8_PARITY_ROWS,
                                            INT8_PARITY_LEN),
                        generator=torch.Generator().manual_seed(SEED + 30))
    seen = set()
    undo = _kernel_dtypes(fa, seen)
    try:
        _reset_counts(fa)
        logits = _prefill_logits(model, ids)[:, -1].cpu()
        torch.cuda.synchronize()
        launches = _launches(fa)
    finally:
        undo()
    _check(launches == _want(1, flash_fwd=cfg.num_layers) and
           seen == {('flash_fwd', 'float32')}, 'f32 int8 prefill launched '
           '%s (%s), want %d f32 flash_fwd' % (launches, sorted(seen),
                                               cfg.num_layers))
    err = (logits - _prefill_logits(cpu, ids)[:, -1]).abs().max().item()
    _check(err <= INT8_LOGIT_TOL, 'f32 int8 prefill logits vs CPU %.3g > '
           '%g' % (err, INT8_LOGIT_TOL))
    out = model.generate(ids.cuda(), max_new_tokens=INT8_PARITY_NEW).cpu()
    want = cpu.generate(ids, max_new_tokens=INT8_PARITY_NEW)
    _check(torch.equal(out, want), 'f32 int8 tokens on the card %s differ '
           'from the CPU\'s %s' % (out[:, INT8_PARITY_LEN:].tolist(),
                                   want[:, INT8_PARITY_LEN:].tolist()))
    eng = ContinuousBatchingEngine(model, num_slots=INT8_PARITY_ROWS,
                                   max_len=640, prefill_chunk=128,
                                   decode_block=4)
    got = eng.generate(ids.tolist(), max_new_tokens=INT8_PARITY_NEW)
    _check(got == out[:, INT8_PARITY_LEN:].tolist(), 'the slot engine\'s '
           'int8 tokens differ from generate()\'s')
    return {'err': err, 'kernels': seen}


def _qat_steps(step, x, y, steps=10):
    """2 warm-up and `steps` timed calls of step(x, y): (median ms, the
    losses of all the calls)."""
    losses = [step(x, y).item() for _ in range(2)]
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(loss.item())
    return sorted(times)[steps // 2], losses


def qat_phase(card):
    """Phase 30 (b): QAT at BASELINE config 2 (phase 27 (a)'s recipe)
    beside the plain step; resnet18 QAT in float64 against the CPU."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.slim import (FakeQuantMovingAverageAbsMax,
                                       ImperativeQuantAware)
    from paddle_tpu_torch.vision.models import resnet50

    t0 = time.time()
    # phase 27 (a)'s weights and batch, so the plain and the QAT runs start
    # alike. At lr 0.1 the QAT loss rises for a few steps before it falls
    # below its start (qat_probe.py: on another batch its 12th loss was
    # still above its first, below it from the 21st)
    x, y = _vision_batch(SEED + 27, VISION_BATCH, VISION_SIZE, 'cuda',
                         torch.bfloat16)
    model = resnet50(device='cuda', seed=SEED).bfloat16()
    plain_ms, plain_losses = _qat_steps(_vision_step(model, VISION_LR), x, y)
    del model
    torch.cuda.empty_cache()
    model = resnet50(device='cuda', seed=SEED).bfloat16()
    ImperativeQuantAware(
        weight_quantize_type='channel_wise_abs_max').quantize(model)
    kinds = collections.Counter(type(m).__name__ for m in model.modules())
    _check(kinds['QuantedConv2D'] == 53 and kinds['QuantedLinear'] == 1 and
           kinds['Conv2D'] == 0 and kinds['Linear'] == 0,
           'QAT wrapped %s' % dict(kinds))
    step = _vision_step(model, VISION_LR)
    _reset_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    median, losses = _qat_steps(step, x, y)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = _launches(fa)
    _check(launches == _want(0), 'QAT launched flash kernels: %s'
           % launches)
    _check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
           'QAT ResNet-50 losses %s' % losses)
    quanters = [m for m in model.modules()
                if isinstance(m, FakeQuantMovingAverageAbsMax)]
    scales = torch.stack([q.scale for q in quanters]).cpu()
    inited = torch.stack([q.initialized for q in quanters]).cpu()
    _check(len(quanters) == 54 and bool((inited == 1).all()) and
           bool(torch.isfinite(scales).all()) and bool((scales > 0).all()),
           'activation scales not all set: %d quanters, scales %s'
           % (len(quanters), scales.tolist()))
    wall, dev, top, _ = _profile(lambda: step(x, y))
    del model, step
    torch.cuda.empty_cache()
    f64 = _qat_f64_runs(SEED)
    out = {'plain_ms': plain_ms, 'median_ms': median,
           'images_s': VISION_BATCH / median * 1e3, 'busy': dev / wall,
           'peak_gib': peak, 'losses': losses, 'f64': f64,
           'seconds': time.time() - t0}
    print('slice 21 (b) [%s]: ResNet-50 QAT (bf16, channel-wise weights, '
          'moving-average activations; 53 Conv2D + 1 Linear wrapped), batch '
          '%d x %d, Momentum lr %g: median step %.2f ms, %.1f images/s, '
          'against the plain step\'s %.2f ms (%.3fx); peak %.2f GiB; '
          'profiled step wall %.2f ms, device kernels %.2f ms, busy share '
          '%.3f; top kernels: %s; losses %s (plain %s); activation scales '
          '%.4g-%.4g; resnet18 QAT float64, 3 steps, each from the CPU\'s '
          'state: card vs CPU losses %.3g, state %.3g (%s) (tol %g), the '
          'stem\'s conv1.weight (max-pool ties) %.3g; flash launches 0; '
          '%.1f s'
          % (card, VISION_BATCH, VISION_SIZE, VISION_LR, median,
             out['images_s'],
             plain_ms, median / plain_ms, peak, wall, dev, out['busy'],
             '; '.join('%s %.2f ms x%d' % t for t in top),
             ['%.4f' % v for v in losses], ['%.4f' % v for v in
                                            plain_losses],
             scales.min().item(), scales.max().item(), f64[0], f64[1][1],
             f64[1][0], F64_TOL, f64[2], out['seconds']), flush=True)
    return out


def _qat_f64_runs(seed):
    """resnet18 under QAT in float64 on the CPU and the card from one set of
    weights, 3 Momentum steps on the same batches, the card starting each
    step from the CPU's state (parameters, buffers and the optimizer's
    velocities): (the largest relative loss error, (name, the largest error
    of a tensor over its largest entry) after a step over every tensor but
    the stem's conv1.weight, conv1.weight's), the first two checked within
    F64_TOL.

    Why step by step, and conv1.weight apart: the fake quant puts the stem
    convolution's inputs and weights on grids, so its outputs tie exactly
    in the max pool's windows, and each device's sum order breaks the ties
    in its last bit. The max pool's gradient goes to the position that
    wins, so conv1.weight's gradient moves with it (qat_tie_probe.py: on
    the CPU alone, 1e-15 on the weights moves it by 0.9% of its largest
    entry, and by 1.4e-14 with an average pool in the max pool's place),
    and every later step after it. The other gradients see the tied value
    only."""
    from paddle_tpu_torch.slim import ImperativeQuantAware
    from paddle_tpu_torch.vision.models import resnet18

    base = resnet18(device='cpu', seed=seed).state_dict()
    runs = {}
    for device in ('cpu', 'cuda'):
        model = resnet18(device=device, seed=seed + 1).double()
        model.load_state_dict(base)
        ImperativeQuantAware(
            weight_quantize_type='channel_wise_abs_max').quantize(model)
        runs[device] = (model, _vision_step(model, VISION_LR))
    (cpu, cpu_step), (card, card_step) = runs['cpu'], runs['cuda']
    loss_err, worst, stem = 0.0, ('', 0.0), 0.0
    for i in range(3):
        card.load_state_dict(cpu.state_dict())
        card_step.optimizer.set_state_dict(cpu_step.optimizer.state_dict())
        x, y = _vision_batch(SEED + 300 + i, RESNET_F32_BATCH,
                             RESNET_F32_SIZE, 'cpu', torch.float64)
        want = cpu_step(x, y).item()
        got = card_step(x.cuda(), y.cuda()).item()
        loss_err = max(loss_err, abs(got - want) / abs(want))
        errs = _max_rel({k: v.cpu().double() for k, v in
                         card.state_dict().items()},
                        {k: v.double() for k, v in cpu.state_dict().items()},
                        1e-6)
        stem = max(stem, errs.pop('conv1.weight'))
        worst = max([worst] + list(errs.items()), key=lambda kv: kv[1])
    _check(loss_err <= F64_TOL and worst[1] <= F64_TOL, 'resnet18 QAT '
           'float64 card vs CPU: losses %.3g, state %s (tol %g)'
           % (loss_err, worst, F64_TOL))
    del runs, cpu, card, cpu_step, card_step
    torch.cuda.empty_cache()
    return loss_err, worst, stem


def ptq_phase(card):
    """Phase 30 (c): PTQ of ResNet-50 in f32 (abs_max and KL), timed by
    part; resnet18 in float64: every algorithm's scales, card vs CPU."""
    from paddle_tpu_torch.slim import PostTrainingQuantization
    from paddle_tpu_torch.slim import ptq as ptq_mod
    from paddle_tpu_torch.vision.models import resnet18, resnet50

    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x64, _ = _vision_batch(SEED + 31, VISION_BATCH, VISION_SIZE, 'cuda')
    calib = [_vision_batch(SEED + 32 + i, PTQ_BATCH, VISION_SIZE, 'cuda')[0]
             for i in range(PTQ_BATCHES)]
    model = resnet50(device='cuda', seed=SEED).eval()
    with torch.no_grad():
        plain_ms = _time_ms(lambda: model(x64), iters=5)
        plain = model(x64).float()
    del model
    # the host's parts of a calibration: each layer input's copy to the
    # host, the observers' statistics, and their scales (the KL search)
    host = dict.fromkeys(('copy', 'observe', 'scale'), 0.0)
    orig = {'copy': ptq_mod._host_f32, 'observe': ptq_mod._Observer.observe,
            'scale': ptq_mod._Observer.scale}

    def timed(part):
        def wrapper(*args):
            t = time.perf_counter()
            try:
                return orig[part](*args)
            finally:
                host[part] += time.perf_counter() - t
        return wrapper

    rows = {}
    ptq_mod._host_f32 = timed('copy')
    ptq_mod._Observer.observe = timed('observe')
    ptq_mod._Observer.scale = timed('scale')
    try:
        for algo in ('abs_max', 'KL'):
            model = resnet50(device='cuda', seed=SEED).eval()
            host.update(dict.fromkeys(host, 0.0))
            torch.cuda.synchronize()
            t = time.perf_counter()
            ptq = PostTrainingQuantization(model=model, data_loader=calib,
                                           batch_nums=PTQ_BATCHES, algo=algo)
            qmodel = ptq.quantize()
            torch.cuda.synchronize()
            calib_s = time.perf_counter() - t
            scales = ptq.scales
            _check(len(scales) == 54 and all(
                math.isfinite(s) and s > 0 for s in scales.values()),
                'PTQ %s scales: %d, %s' % (algo, len(scales), scales))
            with torch.no_grad():
                q_ms = _time_ms(lambda: qmodel(x64), iters=5)
                got = qmodel(x64).float()
            rel = ((got - plain).abs().max() / plain.abs().max()).item()
            agree = int((got.argmax(-1) == plain.argmax(-1)).sum())
            rows[algo] = dict(host, calib_s=calib_s, ms=q_ms, rel=rel,
                              agree=agree)
            del model, qmodel, ptq
            torch.cuda.empty_cache()
    finally:
        ptq_mod._host_f32 = orig['copy']
        ptq_mod._Observer.observe = orig['observe']
        ptq_mod._Observer.scale = orig['scale']

    # resnet18 in float64: each algorithm's scales on the card and the CPU
    base = resnet18(device='cpu', seed=SEED).state_dict()
    batches = [_vision_batch(SEED + 40 + i, PTQ_PARITY_BATCH, VISION_SIZE,
                             'cpu', torch.float64)[0]
               for i in range(PTQ_PARITY_BATCHES)]
    worst = {}
    for algo in PTQ_ALGOS:
        got = {}
        for device in ('cpu', 'cuda'):
            model = resnet18(device=device, seed=SEED + 1).double().eval()
            model.load_state_dict(base)
            ptq = PostTrainingQuantization(
                model=model, data_loader=[b.to(device) for b in batches],
                batch_nums=PTQ_PARITY_BATCHES, algo=algo)
            ptq.quantize()
            got[device] = ptq.scales
        _check(sorted(got['cuda']) == sorted(got['cpu']) and
               len(got['cpu']) == 21, 'resnet18 %s scales named %s'
               % (algo, sorted(got['cuda'])))
        worst[algo] = max((abs(got['cuda'][k] - v) / abs(v), k)
                          for k, v in got['cpu'].items())
        _check(worst[algo][0] <= PTQ_SCALE_RTOL, 'resnet18 PTQ %s scale %s '
               'on the card vs the CPU %.3g apart (tol %g)'
               % (algo, worst[algo][1], worst[algo][0], PTQ_SCALE_RTOL))
    out = {'plain_ms': plain_ms, 'rows': rows, 'parity': worst,
           'seconds': time.time() - t0}
    print('slice 21 (c) [%s]: ResNet-50 PTQ (f32, TF32 off), %d calibration '
          'batches of %d x %d: %s; eval forward at batch %d: plain %.2f ms; '
          'resnet18 float64 (%d x %d, %d batches) scales card vs CPU, '
          'worst relative: %s (tol %g); %.1f s'
          % (card, PTQ_BATCHES, PTQ_BATCH, VISION_SIZE, '; '.join(
              '%s calibration %.2f s (the forwards and the swap %.2f s; on '
              'the host: inputs copied %.2f s, observed %.2f s, scales %.2f '
              's), quantized forward %.2f ms (%.3fx plain), logits %.3g of '
              'range from plain, top-1 agreeing %d of %d'
              % (algo, r['calib_s'], r['calib_s'] - r['copy'] -
                 r['observe'] - r['scale'], r['copy'], r['observe'],
                 r['scale'], r['ms'], r['ms'] / plain_ms, r['rel'],
                 r['agree'], VISION_BATCH)
              for algo, r in rows.items()), VISION_BATCH, plain_ms,
             PTQ_PARITY_BATCH, VISION_SIZE, PTQ_PARITY_BATCHES,
             {a: '%.3g (%s)' % w for a, w in worst.items()}, PTQ_SCALE_RTOL,
             out['seconds']), flush=True)
    return out


def asp_phase(card):
    """Phase 30 (d): 2:4 sparsity on phase 6's bench GPT, eager steps of a
    decorated AdamW beside the unpruned steps; a convnet's prune count."""
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.vision.models import resnet50

    t0 = time.time()
    cfg = GPTConfig(**BENCH_CFG)
    layers = cfg.num_layers
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED).bfloat16()
    gen = torch.Generator().manual_seed(SEED + 33)
    ids = torch.randint(0, cfg.vocab_size, (ASP_BATCH, TRAIN_SEQ),
                        generator=gen).cuda()
    labels = torch.randint(0, cfg.vocab_size, (ASP_BATCH, TRAIN_SEQ),
                           generator=gen).cuda()

    def eager_steps(opt, n):
        times, losses = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = model.loss(model(ids), labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(loss.item())
        return sorted(times)[n // 2], losses

    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    eager_steps(opt, 1)  # warm-up
    plain_ms, plain_losses = eager_steps(opt, ASP_STEPS)
    del opt
    helper = asp.ASPHelper()
    torch.cuda.synchronize()
    t = time.perf_counter()
    masks = helper.prune_model(model, n=2, m=4, mask_algo='mask_1d')
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - t
    _check(len(masks) == 4 * layers, 'prune_model pruned %d weights, want '
           '%d' % (len(masks), 4 * layers))
    opt = helper.decorate(AdamW(learning_rate=TRAIN_LR,
                                parameters=model.parameters()))
    _reset_counts(fa)
    pruned_ms, losses = eager_steps(opt, ASP_STEPS)
    launches = _launches(fa)
    _check(launches == _want(ASP_STEPS, flash_fwd=layers,
                             flash_bwd_fused=layers),
           'pruned eager steps launched %s, want %d forward and %d fused '
           'backward a step' % (launches, layers, layers))
    _check(all(math.isfinite(v) for v in losses), 'pruned losses %s'
           % losses)
    density = []
    for w, _ in masks.values():
        _check(asp.check_sparsity(w, 'check_1d', 2, 4), 'a pruned weight '
               'lost its 2:4 pattern after the steps')
        density.append(asp.calculate_density(w))
    del model, opt, helper, masks
    torch.cuda.empty_cache()
    convnet = resnet50(device='cuda', seed=SEED)
    conv_masks = asp.ASPHelper().prune_model(convnet)
    pruned = [w for w, _ in conv_masks.values()]
    _check(len(pruned) == 1 and pruned[0] is convnet.fc.weight,
           'ResNet-50: ASP pruned %d weights, want the fc alone'
           % len(pruned))
    del convnet
    torch.cuda.empty_cache()
    out = {'plain_ms': plain_ms, 'pruned_ms': pruned_ms, 'prune_s': prune_s,
           'launches': launches, 'steps': ASP_STEPS,
           'seconds': time.time() - t0}
    print('slice 21 (d) [%s]: ASP 2:4 (mask_1d) on the bench GPT (bf16, '
          'batch %d x %d): prune_model %.2f s for %d Linears (densities '
          '%.4f-%.4f after the steps); decorated AdamW eager step %.2f ms '
          '(median of %d) against %.2f ms unpruned; losses %s (unpruned %s); '
          'launches over %d steps %s; ResNet-50: %d weight pruned (fc), the '
          '53 convolutions skipped by the last-dim rule; %.1f s'
          % (card, ASP_BATCH, TRAIN_SEQ, prune_s, 4 * layers, min(density),
             max(density), pruned_ms, ASP_STEPS, plain_ms,
             ['%.4f' % v for v in losses], ['%.4f' % v for v in
                                            plain_losses],
             ASP_STEPS, {k: v for k, v in launches.items() if v},
             len(pruned), out['seconds']), flush=True)
    return out


def _incubate_runs(device, state):
    """The optimizer wrappers over 6 eager steps of a float64 MLP from
    `state`, the segment ops and the masked softmax on `device`: {name:
    tensor on the CPU}."""
    from paddle_tpu_torch import incubate
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt

    out = {}
    for kind in ('lookahead', 'model_average', 'ema'):
        model = pnn.Sequential(pnn.Linear(16, 32, device=device), pnn.Tanh(),
                               pnn.Linear(32, 4, device=device)).double()
        model.load_state_dict(state)
        params = list(model.parameters())
        after = None
        if kind == 'lookahead':
            opt = incubate.LookAhead(popt.Momentum(
                learning_rate=0.1, momentum=0.9, parameters=params),
                alpha=0.5, k=5)
        else:
            opt = popt.SGD(learning_rate=0.2, parameters=params)
            wrap = incubate.ModelAverage(0.15, parameters=params) \
                if kind == 'model_average' else \
                incubate.optimizer.ExponentialMovingAverage(
                    decay=0.8, parameters=params)
            after = wrap.step if kind == 'model_average' else wrap.update
        gen = torch.Generator().manual_seed(SEED + 34)
        for _ in range(6):
            x = torch.randn(16, 16, generator=gen, dtype=torch.float64)
            y = torch.randn(16, 4, generator=gen, dtype=torch.float64)
            pnn.functional.mse_loss(model(x.to(device)),
                                    y.to(device)).backward()
            opt.step()
            opt.clear_grad()
            if after is not None:
                after()
        # copies: on the CPU .cpu() would alias the parameters, which
        # apply() and restore() overwrite in place
        for k, v in model.state_dict().items():
            out['%s.%s' % (kind, k)] = v.to('cpu', copy=True)
        if after is not None:
            with wrap.apply():
                for k, v in model.state_dict().items():
                    out['%s.applied.%s' % (kind, k)] = v.to('cpu',
                                                            copy=True)
    gen = torch.Generator().manual_seed(SEED + 35)
    data = torch.randn(10, 3, generator=gen, dtype=torch.float64).to(device)
    ids = torch.tensor([0, 0, 1, 1, 1, 3, 3, 4, 6, 6]).to(device)
    cot = torch.arange(1.0, 22.0, dtype=torch.float64).reshape(7, 3)
    for op in ('sum', 'mean', 'max', 'min'):
        x = data.clone().requires_grad_()
        y = getattr(incubate, 'segment_' + op)(x, ids)
        (y * cot.to(device)).sum().backward()
        out['segment_' + op] = y.detach().cpu()
        out['segment_%s.grad' % op] = x.grad.cpu()
    scores = torch.randn(2, 4, 64, 64, generator=gen,
                         dtype=torch.float64) * 4
    out['softmax_mask_fuse_upper_triangle'] = \
        incubate.softmax_mask_fuse_upper_triangle(scores.to(device)).cpu()
    return out


def incubate_parity_phase(card):
    """Phase 30 (e): the optimizer wrappers and the incubate ops, card vs
    CPU in float64."""
    from paddle_tpu_torch import nn as pnn

    t0 = time.time()
    base = pnn.Sequential(pnn.Linear(16, 32, device='cpu'), pnn.Tanh(),
                          pnn.Linear(32, 4, device='cpu')).double()
    state = base.state_dict()
    cpu, card_out = _incubate_runs('cpu', state), _incubate_runs('cuda',
                                                                  state)
    for k in ('segment_sum', 'segment_max'):
        _check(not cpu[k][2].any() and not cpu[k][5].any(),
               '%s: an empty segment is not 0' % k)
    errs = _max_rel(card_out, cpu, 1e-6)
    name, worst = max(errs.items(), key=lambda kv: kv[1])
    _check(worst <= F64_TOL, 'incubate float64 card vs CPU: %s %.3g apart '
           '(tol %g)' % (name, worst, F64_TOL))
    out = {'worst': (name, worst), 'count': len(errs),
           'seconds': time.time() - t0}
    print('slice 21 (e) [%s]: LookAhead (Momentum, alpha 0.5, k 5), '
          'ModelAverage and ExponentialMovingAverage (applied and after) over '
          '6 eager float64 MLP steps, segment_sum / mean / max / min with 2 '
          'empty segments (values and gradients), '
          'softmax_mask_fuse_upper_triangle: %d tensors card vs CPU, worst '
          '%.3g (%s; tol %g); %.1f s'
          % (card, len(errs), worst, name, F64_TOL, out['seconds']),
          flush=True)
    return out


def slice21_phases(card, sku):
    """Phase 30: slice 21, quantization and the rest of incubate, on one
    card."""
    t0 = time.time()
    out = {'int8w': int8_serving_phase(card), 'qat': qat_phase(card),
           'ptq': ptq_phase(card), 'asp': asp_phase(card),
           'incubate': incubate_parity_phase(card)}
    out['seconds'] = time.time() - t0
    rows = out['int8w']['rows']
    ptq = out['ptq']['rows']
    print('phase 30 (slice 21) [%s]: %s' % (card, json.dumps({
        'int8w_decode_tps': round(rows['int8w']['decode_tps'], 1),
        'bf16_decode_tps': round(rows['bf16']['decode_tps'], 1),
        'int8w_prefill_ms': round(rows['int8w']['prefill_ms'], 2),
        'bf16_prefill_ms': round(rows['bf16']['prefill_ms'], 2),
        'int8w_engine_tps': round(rows['int8w']['engine_tps'], 1),
        'bf16_engine_tps': round(rows['bf16']['engine_tps'], 1),
        'streamed_bytes': [rows['bf16']['streamed_bytes'],
                           rows['int8w']['streamed_bytes']],
        'qat_step_ms': round(out['qat']['median_ms'], 2),
        'plain_step_ms': round(out['qat']['plain_ms'], 2),
        'qat_images_s': round(out['qat']['images_s'], 1),
        'ptq_calib_s': {a: round(r['calib_s'], 2) for a, r in ptq.items()},
        'ptq_forward_ms': {a: round(r['ms'], 2) for a, r in ptq.items()},
        'asp_step_ms': round(out['asp']['pruned_ms'], 2),
        'asp_plain_step_ms': round(out['asp']['plain_ms'], 2),
        'seconds': round(out['seconds'], 1)})), flush=True)
    return out


# phase 31: slice 22, the library surface
OP_BENCH_LAUNCHES = 23  # op_benchmark's warm-up 3 + timed 20 calls
SPARSE_CFG = dict(batch=2, heads=12, seq=4096, head_dim=64, block=64,
                  window=3, globals=2, randoms=3)
SPARSE_REF_HEADS = 2
# f32 card vs the float64 CPU run: largest error over the largest value
SPARSE_TOL = 1e-5
SPARSE_TOL_BF16 = 2e-2
DIST_DRAWS = 1_000_000
DIST_TOL = 1e-12
HOUSING_ROWS = 506
FIT_EPOCHS = 2
FIT_TOL = 1e-10
# tests/test_custom_op.py's relu (with its grad kernel) and cat (with its
# shape inference) source
CUSTOM_OP_SRC = r"""
#include "pd_extension.h"

static int relu_fwd(const PDTensor* ins, int n_in, PDTensor* outs,
                    int n_out) {
  const float* x = (const float*)ins[0].data;
  float* y = (float*)outs[0].data;
  for (int64_t i = 0; i < pd_numel(&ins[0]); i++)
    y[i] = x[i] > 0.f ? x[i] : 0.f;
  return 0;
}

static int relu_bwd(const PDTensor* ins, int n_in, PDTensor* outs,
                    int n_out) {
  const float* x = (const float*)ins[0].data;
  const float* dy = (const float*)ins[1].data;
  float* dx = (float*)outs[0].data;
  for (int64_t i = 0; i < pd_numel(&ins[0]); i++)
    dx[i] = x[i] > 0.f ? dy[i] : 0.f;
  return 0;
}

PD_BUILD_OP(custom_relu, 1, 1, relu_fwd);
PD_BUILD_GRAD_OP(custom_relu, 2, 1, relu_bwd);

static int cat_infer(const PDTensor* ins, int n_in, PDTensor* outs,
                     int n_out) {
  outs[0].ndim = 2;
  outs[0].shape[0] = ins[0].shape[0];
  outs[0].shape[1] = ins[0].shape[1] + ins[1].shape[1];
  outs[0].dtype = ins[0].dtype;
  return 0;
}

static int cat_fwd(const PDTensor* ins, int n_in, PDTensor* outs,
                   int n_out) {
  int64_t n = ins[0].shape[0], a = ins[0].shape[1], b = ins[1].shape[1];
  const float* x = (const float*)ins[0].data;
  const float* y = (const float*)ins[1].data;
  float* o = (float*)outs[0].data;
  for (int64_t r = 0; r < n; r++) {
    for (int64_t i = 0; i < a; i++) o[r * (a + b) + i] = x[r * a + i];
    for (int64_t i = 0; i < b; i++) o[r * (a + b) + a + i] = y[r * b + i];
  }
  return 0;
}

PD_BUILD_OP_INFER(custom_cat2, 2, 1, cat_fwd, cat_infer);
"""


def op_benchmark_phase(card):
    """Phase 31 (a): op_benchmark on the card: the flash config through
    run_benchmarks, then the default suite through main --out (which runs
    run_benchmarks over OP_CONFIGS). The suite's set-up is numpy's normals
    for its inputs (8192 x 30528 of them for the CE), so it runs once."""
    import tempfile

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.utils import op_benchmark as ob

    t0 = time.time()
    flash = [c for c in ob.OP_CONFIGS if c[0].startswith('flash_')]
    _reset_counts(fa)
    direct = ob.run_benchmarks(flash)
    direct_launches = _launches(fa)
    _check(len(direct) == 1 and direct[0]['ok'], 'run_benchmarks of the '
           'flash config: %s' % direct)
    _check(direct_launches == _want(1, flash_fwd=OP_BENCH_LAUNCHES),
           'run_benchmarks of the flash config launched %s, want %d flash '
           'forward launches and no other' % (direct_launches,
                                              OP_BENCH_LAUNCHES))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'ops.json')
        _reset_counts(fa)
        rc = ob.main(['--out', out])
        launches = _launches(fa)
        with open(out) as f:
            results = json.load(f)
    _check(rc == 0, 'op_benchmark main --out returned %d' % rc)
    _check(all(r['ok'] for r in results),
           'op_benchmark configs failed: %s' % [r for r in results
                                                if not r['ok']])
    _check([r['op'] for r in results] == [n for n, _ in ob.OP_CONFIGS],
           'op_benchmark ran %s' % [r['op'] for r in results])
    _check(launches == _want(1, flash_fwd=OP_BENCH_LAUNCHES),
           'the suite launched %s, want %d flash forward launches and no '
           'other' % (launches, OP_BENCH_LAUNCHES))
    _check(ob.compare(results, results) == [], 'compare(results, results) '
           'found regressions')
    means = {r['op']: r['mean_ms'] for r in results}
    print('slice 22 (a) [%s]: op_benchmark default suite through main '
          '--out (warm-up 3, 20 timed calls, host clock between '
          'synchronisations): %s; the flash config through run_benchmarks '
          '%.4f ms; flash forward launches %d a run; %.1f s'
          % (card, json.dumps(means), direct[0]['mean_ms'],
             launches['flash_fwd'], time.time() - t0), flush=True)
    return {'mean_ms': means, 'direct_flash_ms': direct[0]['mean_ms'],
            'launches': launches['flash_fwd'], 'seconds': time.time() - t0}


def _bigbird_csr(cfg, seed):
    """The CSR (offsets, columns) over tokens of a BigBird layout: each
    query block attends its window blocks, the global blocks and seeded
    random blocks; a global block's rows attend every block."""
    nb = cfg['seq'] // cfg['block']
    rng = np.random.RandomState(seed)
    glob = set(range(cfg['globals']))
    blocks_of = []
    for i in range(nb):
        if i in glob:
            blocks_of.append(list(range(nb)))
            continue
        half = cfg['window'] // 2
        chosen = glob | set(range(max(0, i - half), min(nb, i + half + 1)))
        rest = [b for b in range(nb) if b not in chosen]
        chosen |= set(rng.choice(rest, cfg['randoms'], replace=False)
                      .tolist())
        blocks_of.append(sorted(chosen))
    offs, cols = [0], []
    base = np.arange(cfg['block'])
    for i in range(nb):
        row = np.concatenate([b * cfg['block'] + base for b in blocks_of[i]])
        for _ in range(cfg['block']):
            cols.append(row)
            offs.append(offs[-1] + len(row))
    return (torch.tensor(offs, dtype=torch.int32),
            torch.tensor(np.concatenate(cols), dtype=torch.int32))


def _rel_err(got, want):
    return ((got.double().cpu() - want).abs().max() /
            want.abs().max()).item()


def sparse_attention_phase(card):
    """Phase 31 (b): F.sparse_attention at a BigBird-base layout on the
    card, f32 forward and gradients against the float64 CPU run of two
    heads, bf16 forward."""
    import paddle_tpu_torch.nn.functional as F

    t0 = time.time()
    c = SPARSE_CFG
    b, h, n, d = c['batch'], c['heads'], c['seq'], c['head_dim']
    offs, cols = _bigbird_csr(c, SEED + 41)
    gen = torch.Generator().manual_seed(SEED + 42)
    q, k, v, cot = (torch.randn(b, h, n, d, generator=gen)
                    for _ in range(4))
    kpm = torch.ones(b, n)
    kpm[0, n - 300:] = 0
    kpm[1, n - 700:] = 0
    dev_offs = offs.cuda()[None, None].expand(b, h, -1)
    dev_cols = cols.cuda()[None, None].expand(b, h, -1)
    dev_kpm = kpm.cuda()

    def run(dtype, grads):
        qq, kk, vv = (t.detach().to('cuda', dtype).requires_grad_(grads)
                      for t in (q, k, v))
        out = F.sparse_attention(qq, kk, vv, dev_offs, dev_cols,
                                 key_padding_mask=dev_kpm)
        if grads:
            (out * cot.cuda().to(dtype)).sum().backward()
        return out.detach(), [t.grad for t in (qq, kk, vv)], (qq, kk, vv)

    # full f32 products: an earlier phase may have left TF32 on
    torch.backends.cuda.matmul.allow_tf32 = False
    out32, grads32, leaves = run(torch.float32, True)
    torch.cuda.synchronize()
    # the reference: batch 0's first heads in float64 on the CPU
    r = SPARSE_REF_HEADS
    rq, rk, rv = (t[:1, :r].detach().double().requires_grad_(True)
                  for t in (q, k, v))
    ref = F.sparse_attention(rq, rk, rv, offs[None, None].expand(1, r, -1),
                             cols[None, None].expand(1, r, -1),
                             key_padding_mask=kpm[:1].double())
    (ref * cot[:1, :r].double()).sum().backward()
    errs = {'out': _rel_err(out32[:1, :r], ref.detach())}
    for name, g, rg in zip('qkv', grads32, (rq, rk, rv)):
        errs['d' + name] = _rel_err(g[:1, :r], rg.grad)
    _check(all(math.isfinite(e) and e <= SPARSE_TOL for e in errs.values()),
           'sparse_attention f32 against the float64 CPU run: %s (tol %g)'
           % (errs, SPARSE_TOL))
    _check(bool(torch.isfinite(out32).all()) and
           all(bool(torch.isfinite(g).all()) for g in grads32),
           'sparse_attention f32: non-finite values')
    out16, _, _ = run(torch.bfloat16, False)
    err16 = _rel_err(out16[:1, :r], ref.detach())
    _check(math.isfinite(err16) and err16 <= SPARSE_TOL_BF16,
           'sparse_attention bf16 forward against the float64 CPU run: %.3g '
           '(tol %g)' % (err16, SPARSE_TOL_BF16))
    del out16, ref, rq, rk, rv
    qq, kk, vv = leaves
    q16, k16, v16 = (t.detach().bfloat16() for t in leaves)
    cot32 = cot.cuda()

    def fwd32():
        with torch.no_grad():
            F.sparse_attention(qq, kk, vv, dev_offs, dev_cols,
                               key_padding_mask=dev_kpm)

    def fwd_bwd32():
        for t in leaves:
            t.grad = None
        out = F.sparse_attention(qq, kk, vv, dev_offs, dev_cols,
                                 key_padding_mask=dev_kpm)
        (out * cot32).sum().backward()

    def fwd16():
        with torch.no_grad():
            F.sparse_attention(q16, k16, v16, dev_offs, dev_cols,
                               key_padding_mask=dev_kpm)
    torch.cuda.reset_peak_memory_stats()
    ms = {'f32_fwd': _time_ms(fwd32, iters=3, warmup=1),
          'f32_fwd_bwd': _time_ms(fwd_bwd32, iters=3, warmup=1),
          'bf16_fwd': _time_ms(fwd16, iters=3, warmup=1)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nnz = cols.numel()
    del leaves, qq, kk, vv, q16, k16, v16, grads32, out32
    torch.cuda.empty_cache()
    out = {'errs': errs, 'err_bf16': err16, 'ms': ms, 'peak_gib': peak,
           'nnz': nnz, 'density': nnz / (n * n), 'seconds': time.time() - t0}
    print('slice 22 (b) [%s]: sparse_attention, BigBird-base layout (b %d, '
          'h %d, n = m = %d, d %d, %d-token blocks, %d window + %d global '
          '+ %d random blocks a row; nnz %d of %d, density %.4f) with a '
          'key-padding mask: f32 vs the float64 CPU run of batch 0 heads '
          '0-%d, largest error over largest value %s (tol %g); bf16 forward '
          '%.3g (tol %g); f32 forward %.2f ms, forward + backward %.2f ms, '
          'bf16 forward %.2f ms (dense masked scores, CUDA events, mean of '
          '3); peak %.2f GiB; %.1f s'
          % (card, b, h, n, d, c['block'], c['window'], c['globals'],
             c['randoms'], nnz, n * n, out['density'], r - 1,
             {k2: '%.3g' % e for k2, e in errs.items()}, SPARSE_TOL, err16,
             SPARSE_TOL_BF16, ms['f32_fwd'], ms['f32_fwd_bwd'],
             ms['bf16_fwd'], peak, out['seconds']), flush=True)
    return out


def _dist_cases(device):
    """{name: (distribution, closed-form mean, variance)} on `device` in
    float64, and a value to score for each that has log_prob."""
    from paddle_tpu_torch import distribution as D

    def t(x):
        return torch.tensor(x, dtype=torch.float64, device=device)
    logits = np.log(np.array([0.1, 0.2, 0.3, 0.4]))
    p = np.exp(logits)
    k = np.arange(4)
    conc = np.array([1.0, 2.0, 3.0])
    a0 = conc.sum()
    mp = np.array([0.2, 0.3, 0.5])
    cases = {
        'Normal': (D.Normal(t(0.5), t(2.0)), 0.5, 4.0, t([-1.0, 0.3, 4.0])),
        'Uniform': (D.Uniform(t(-1.0), t(3.0)), 1.0, 16.0 / 12,
                    t([-2.0, 0.0, 2.5])),
        'Categorical': (D.Categorical(t(logits)), (k * p).sum(),
                        (k * k * p).sum() - (k * p).sum() ** 2,
                        torch.tensor(3, device=device)),
        'Beta': (D.Beta(t(2.0), t(3.0)), 0.4, 0.04, t([0.1, 0.5, 0.9])),
        'Dirichlet': (D.Dirichlet(t(conc)), conc / a0,
                      conc * (a0 - conc) / (a0 ** 2 * (a0 + 1)),
                      t([[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]])),
        'Exponential': (D.Exponential(t(2.0)), 0.5, 0.25,
                        t([0.1, 1.0, 3.0])),
        'Bernoulli': (D.Bernoulli(t(0.3)), 0.3, 0.21, t([0.0, 1.0])),
        'Multinomial': (D.Multinomial(10, t(mp)), 10 * mp,
                        10 * mp * (1 - mp), None),
    }
    return cases


def _moment_z(x, mean, var):
    """The largest distance of the draws' mean and variance from the closed
    forms, in standard errors (the variance's from the fourth moment)."""
    x = x.double()
    n = x.shape[0]
    m = x.mean(0)
    cen = x - m
    v = (cen ** 2).mean(0)
    m4 = (cen ** 4).mean(0)
    mean = torch.as_tensor(mean, dtype=torch.float64, device=x.device)
    var = torch.as_tensor(var, dtype=torch.float64, device=x.device)
    z_mean = (m - mean).abs() / torch.sqrt(var / n)
    z_var = (v - var).abs() / torch.sqrt((m4 - v ** 2).clamp_min(1e-300) / n)
    return float(torch.maximum(z_mean, z_var).max())


def distribution_phase(card):
    """Phase 31 (c): the eight distributions on the card."""
    from paddle_tpu_torch import distribution as D

    t0 = time.time()
    card_cases, cpu_cases = _dist_cases('cuda'), _dist_cases('cpu')
    rows = {}
    for name, (dist, mean, var, value) in card_cases.items():
        gen = torch.Generator(device='cuda').manual_seed(SEED + 51)
        torch.cuda.synchronize()
        t = time.perf_counter()
        x = dist.sample((DIST_DRAWS,), generator=gen)
        torch.cuda.synchronize()
        draw_ms = (time.perf_counter() - t) * 1e3
        _check(x.is_cuda and x.shape[0] == DIST_DRAWS,
               '%s drew %s on %s' % (name, tuple(x.shape), x.device))
        z = _moment_z(x, mean, var)
        _check(z < 5.0, '%s: %d draws %.2f standard errors from the closed '
               'forms' % (name, DIST_DRAWS, z))
        again = dist.sample((DIST_DRAWS,), generator=torch.Generator(
            device='cuda').manual_seed(SEED + 51))
        _check(torch.equal(x, again), '%s: the same seed drew other values'
               % name)
        cpu = cpu_cases[name][0]
        scores = {}
        if value is not None:
            scores['log_prob'] = (dist.log_prob(value),
                                  cpu.log_prob(value.cpu()))
        try:
            scores['entropy'] = (dist.entropy(), cpu.entropy())
        except NotImplementedError:
            pass
        if name in ('Normal', 'Categorical'):
            other = (D.Normal(dist.loc * 0.5 + 1.0, dist.scale * 1.5)
                     if name == 'Normal' else
                     D.Categorical(dist.logits.flip(-1)))
            cpu_other = (D.Normal(cpu.loc * 0.5 + 1.0, cpu.scale * 1.5)
                         if name == 'Normal' else
                         D.Categorical(cpu.logits.flip(-1)))
            scores['kl'] = (D.kl_divergence(dist, other),
                            D.kl_divergence(cpu, cpu_other))
        errs = {}
        for key, (got, want) in scores.items():
            _check(got.is_cuda and got.dtype == torch.float64,
                   '%s %s: %s on %s' % (name, key, got.dtype, got.device))
            finite = torch.isfinite(want)
            _check(torch.equal(torch.isfinite(got).cpu(), finite),
                   '%s %s: infinities differ' % (name, key))
            errs[key] = float((got.cpu()[finite] - want[finite]).abs()
                              .max()) if finite.any() else 0.0
        _check(all(e <= DIST_TOL for e in errs.values()),
               '%s: card vs CPU %s (tol %g)' % (name, errs, DIST_TOL))
        rows[name] = {'z': z, 'errs': errs, 'draw_ms': draw_ms,
                      'dtype': str(x.dtype).split('.')[-1]}
    out = {'rows': rows, 'seconds': time.time() - t0}
    print('slice 22 (c) [%s]: distributions on the card, %d draws each '
          '(float64 parameters): %s; %.1f s'
          % (card, DIST_DRAWS, '; '.join(
              '%s %s: moments within %.2f SE, draw %.2f ms, card vs CPU %s'
              % (n, r['dtype'], r['z'], r['draw_ms'],
                 {k: '%.2g' % e for k, e in r['errs'].items()})
              for n, r in rows.items()), out['seconds']), flush=True)
    return out


def custom_op_phase(card):
    """Phase 31 (d): a g++-built custom op on CUDA tensors, eager and
    compiled, against the CPU run."""
    import tempfile

    from paddle_tpu_torch.utils import cpp_extension

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, 'custom_ops.cc')
        with open(src, 'w') as f:
            f.write(CUSTOM_OP_SRC)
        tb = time.time()
        ext = cpp_extension.load('custom_ops', [src], build_directory=tmp)
        build_s = time.time() - tb
    gen = torch.Generator().manual_seed(SEED + 61)
    x = torch.randn(64, 33, generator=gen)
    cot = torch.randn(64, 33, generator=gen)
    a, b = torch.randn(8, 5, generator=gen), torch.randn(8, 7, generator=gen)

    def run(device, fn):
        xx = x.detach().to(device).requires_grad_(True)
        y = fn(xx)
        (y * cot.to(device)).sum().backward()
        return y.detach().cpu(), xx.grad.cpu()

    def relu2(t):
        return ext.custom_relu(t) * 2.0

    relu = ext.custom_relu
    trips0 = relu.host_round_trips
    cpu_y, cpu_g = run('cpu', relu)
    _check(relu.host_round_trips == trips0, 'CPU tensors made a host round '
           'trip')
    card_y, card_g = run('cuda', relu)
    eager_trips = relu.host_round_trips - trips0
    _check(torch.equal(card_y, cpu_y) and torch.equal(card_g, cpu_g),
           'custom_relu on the card differs from the CPU run')
    cat_cpu = ext.custom_cat2(a, b)
    cat_card = ext.custom_cat2(a.cuda(), b.cuda())
    _check(cat_card.is_cuda and tuple(cat_card.shape) == (8, 12) and
           torch.equal(cat_card.cpu(), cat_cpu), 'custom_cat2 on the card')
    tc = time.time()
    compiled = torch.compile(relu2, fullgraph=True)
    comp_y, comp_g = run('cuda', compiled)
    compile_s = time.time() - tc
    want_y, want_g = run('cpu', relu2)
    _check(torch.equal(comp_y, want_y) and torch.equal(comp_g, want_g),
           'custom_relu under torch.compile on the card differs from the '
           'CPU run')
    trips = relu.host_round_trips - trips0
    out = {'build_s': build_s, 'compile_s': compile_s,
           'host_round_trips': trips, 'eager_round_trips': eager_trips,
           'seconds': time.time() - t0}
    print('slice 22 (d) [%s]: custom op (tests/test_custom_op.py\'s relu '
          '/ cat source) built with g++ in %.2f s; CUDA tensors, eager '
          'forward + backward and torch.compile(fullgraph=True) forward + '
          'backward (compile %.1f s): equal to the CPU run bit for bit; '
          'custom_relu host_round_trips %d (%d eager: forward, grad), '
          'custom_cat2 %d; %.1f s'
          % (card, build_s, compile_s, trips, eager_trips,
             ext.custom_cat2.host_round_trips, out['seconds']), flush=True)
    return out


def _write_housing(path, seed):
    """A seeded HOUSING_ROWS x 14 housing.data in UCI's layout: 13
    features and a price a row, fixed-width, whitespace-separated."""
    rng = np.random.RandomState(seed)
    feats = rng.uniform(0.0, 1.0, (HOUSING_ROWS, 13)) * \
        rng.uniform(1.0, 100.0, 13)
    w = rng.randn(13)
    price = 22.5 + (feats - feats.mean(0)) / feats.std(0) @ w + \
        rng.randn(HOUSING_ROWS)
    np.savetxt(path, np.hstack([feats, price[:, None]]), fmt='%9.4f')


def fit_a_line_phase(card):
    """Phase 31 (e): fit-a-line through the legacy reader and batch on the
    card against the CPU, in float64."""
    import tempfile

    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import dataset, nn, optimizer

    t0 = time.time()

    def train(device, data_file):
        lin = nn.Linear(13, 1, device=device, generator=torch.Generator()
                        .manual_seed(SEED + 71)).double()
        opt = optimizer.SGD(learning_rate=0.01, parameters=lin.parameters())
        losses = []
        reader = tpt.batch(dataset.uci_housing.train(data_file=data_file), 20)
        for _ in range(FIT_EPOCHS):
            for rows in reader():
                x = torch.tensor(np.stack([r[0] for r in rows]),
                                 dtype=torch.float64, device=device)
                y = torch.tensor(np.stack([r[1] for r in rows]),
                                 dtype=torch.float64, device=device)
                loss = ((lin(x) - y) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.item())
        return losses

    with tempfile.TemporaryDirectory() as tmp:
        data_file = os.path.join(tmp, 'housing.data')
        _write_housing(data_file, SEED + 72)
        card_losses = train('cuda', data_file)
        cpu_losses = train('cpu', data_file)
    worst = max(abs(a - b) for a, b in zip(card_losses, cpu_losses))
    _check(len(card_losses) == len(cpu_losses) == FIT_EPOCHS * 21,
           'fit-a-line took %d steps, want %d' % (len(card_losses),
                                                  FIT_EPOCHS * 21))
    _check(worst <= FIT_TOL, 'fit-a-line losses card vs CPU %.3g (tol %g)'
           % (worst, FIT_TOL))
    _check(card_losses[-1] < card_losses[0], 'fit-a-line loss did not fall: '
           '%s' % card_losses)
    out = {'losses': card_losses, 'worst': worst,
           'seconds': time.time() - t0}
    print('slice 22 (e) [%s]: fit-a-line (nn.Linear(13, 1), float64, SGD '
          'lr 0.01) on a seeded %d x 14 housing.data through '
          'batch(dataset.uci_housing.train(), 20), %d epochs of 21 steps: '
          'loss %.4f -> %.4f, card vs CPU worst %.3g (tol %g); %.1f s'
          % (card, HOUSING_ROWS, FIT_EPOCHS, card_losses[0],
             card_losses[-1], worst, FIT_TOL, out['seconds']), flush=True)
    return out


def numerics_phase(card):
    """Phase 31 (f): check_numerics on card tensors and run_check() on the
    card."""
    import contextlib
    import io

    from paddle_tpu_torch import utils
    from paddle_tpu_torch.framework.debug import check_numerics

    x = torch.randn(4, 5, device='cuda')
    _check(check_numerics(x, 'x') is x, 'check_numerics returned another '
           'tensor')
    bad = x.clone()
    bad[0, 0] = float('nan')
    bad[1, 1] = float('inf')
    bad[2, 2] = -float('inf')
    try:
        check_numerics(bad, 'bad')
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    want = ('bad contains 1 NaN and 2 Inf values (shape (4, 5), dtype '
            'float32)')
    _check(raised == want, 'check_numerics on the card raised %r, want %r'
           % (raised, want))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = utils.run_check()
    _check(ok and 'installed successfully' in buf.getvalue(),
           'run_check() on the card: %r' % buf.getvalue())
    print('slice 22 (f) [%s]: check_numerics on card tensors (finite: '
          'returned; NaN / Inf: %r); run_check() on %s: %s'
          % (card, raised, torch.cuda.get_device_name(0),
             buf.getvalue().strip()), flush=True)
    return {'raised': raised}


def slice22_phases(card):
    """Phase 31: slice 22, the library surface, on one card."""
    t0 = time.time()
    out = {'op_benchmark': op_benchmark_phase(card),
           'sparse': sparse_attention_phase(card),
           'distribution': distribution_phase(card),
           'custom_op': custom_op_phase(card),
           'fit': fit_a_line_phase(card),
           'numerics': numerics_phase(card)}
    out['seconds'] = time.time() - t0
    sp = out['sparse']
    print('phase 31 (slice 22) [%s]: %s' % (card, json.dumps({
        'op_benchmark_mean_ms': out['op_benchmark']['mean_ms'],
        'flash_launches_a_run': out['op_benchmark']['launches'],
        'sparse_f32_fwd_ms': round(sp['ms']['f32_fwd'], 2),
        'sparse_f32_fwd_bwd_ms': round(sp['ms']['f32_fwd_bwd'], 2),
        'sparse_bf16_fwd_ms': round(sp['ms']['bf16_fwd'], 2),
        'sparse_f32_err': max(sp['errs'].values()),
        'sparse_bf16_err': sp['err_bf16'],
        'custom_op_host_round_trips':
            out['custom_op']['host_round_trips'],
        'fit_worst': out['fit']['worst'],
        'seconds': round(out['seconds'], 1)})), flush=True)
    return out


# -- phase 32: slice 23, export and the C surface -----------------------------
# (a) GPT-2 small at full width and depth (f32, TF32 off, seeded weights) on
# 1 x ONNX_SEQ ids: the eager forward on the card (12 causal f32 launches of
# the flash forward), onnx.export at the same spec (the flash op lowered to
# its plain version), the file read back and run by tests/onnx_numpy.py on
# the host; the logits within ONNX_TOL of the card's largest magnitude
ONNX_SEQ, ONNX_TOL = 512, 1e-4
# (b) PP-YOLOv2 at BASELINE config 4 through the C API in a child process
# (device "gpu"), on phase 29 (c)'s artifact and Inductor cache: its outputs
# against the in-process Predictor's, bit for bit or within DECODE_TOL; the
# child's seconds to its first output, PD_PredictorRun's p50 over CAPI_RUNS
CAPI_RUNS = 10
CAPI_CLIENT_C = r'''
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include "pd_capi.h"

static double now_s(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

static int cmp(const void* a, const void* b) {
  double x = *(const double*)a, y = *(const double*)b;
  return (x > y) - (x < y);
}

int main(int argc, char** argv) {
  /* argv: repo model device input.raw N C H W output.raw runs */
  double t0 = now_s();
  if (argc < 11) { fprintf(stderr, "usage\n"); return 2; }
  int64_t shape[4];
  int64_t count = 1;
  for (int i = 0; i < 4; ++i) { shape[i] = atoll(argv[5 + i]); count *= shape[i]; }
  float* x = (float*)malloc(count * sizeof(float));
  FILE* f = fopen(argv[4], "rb");
  if (!f || fread(x, sizeof(float), count, f) != (size_t)count) return 7;
  fclose(f);
  if (PD_Init(argv[1]) != 0) { fprintf(stderr, "init: %s\n", PD_GetLastError()); return 3; }
  PD_Config* cfg = PD_ConfigCreate();
  PD_ConfigSetModel(cfg, argv[2]);
  PD_ConfigSetDevice(cfg, argv[3]);
  PD_Predictor* pred = PD_PredictorCreate(cfg);
  PD_ConfigDestroy(cfg);
  if (!pred) { fprintf(stderr, "create: %s\n", PD_GetLastError()); return 4; }
  char name[128];
  if (PD_PredictorGetInputName(pred, 0, name, 128) < 0) { fprintf(stderr, "name: %s\n", PD_GetLastError()); return 5; }
  double t_ready = now_s();
  if (PD_PredictorSetInputFloat(pred, name, x, shape, 4) != 0 || PD_PredictorRun(pred) != 0) {
    fprintf(stderr, "run: %s\n", PD_GetLastError());
    return 6;
  }
  double t_first = now_s();
  int runs = atoi(argv[10]);
  double* ms = (double*)malloc(runs * sizeof(double));
  for (int i = 0; i < runs; ++i) {
    double a = now_s();
    if (PD_PredictorRun(pred) != 0) { fprintf(stderr, "run: %s\n", PD_GetLastError()); return 6; }
    ms[i] = 1e3 * (now_s() - a);
  }
  int n = PD_PredictorGetOutputNum(pred);
  FILE* o = fopen(argv[9], "wb");
  if (n < 1 || !o) return 8;
  fwrite(&n, sizeof(int), 1, o);
  for (int k = 0; k < n; ++k) {
    int64_t dims[8];
    int rank = PD_PredictorGetOutputShape(pred, k, dims, 8);
    if (rank < 0 || rank > 8) { fprintf(stderr, "shape %d: %s\n", k, PD_GetLastError()); return 9; }
    int64_t total = 1;
    for (int i = 0; i < rank; ++i) total *= dims[i];
    float* buf = (float*)malloc((total > 0 ? total : 1) * sizeof(float));
    if (PD_PredictorGetOutputFloat(pred, k, buf, total) != total) {
      fprintf(stderr, "output %d: %s\n", k, PD_GetLastError());
      return 9;
    }
    fwrite(&rank, sizeof(int), 1, o);
    fwrite(dims, sizeof(int64_t), rank, o);
    fwrite(buf, sizeof(float), total, o);
    free(buf);
  }
  fclose(o);
  PD_PredictorDestroy(pred);
  qsort(ms, runs, sizeof(double), cmp);
  printf("{\"ready_s\": %.6f, \"first_output_s\": %.6f, \"run_p50_ms\": %.6f, "
         "\"run_min_ms\": %.6f, \"run_max_ms\": %.6f}\n",
         t_ready - t0, t_first - t0, ms[runs / 2], ms[0], ms[runs - 1]);
  return 0;
}
'''


def _onnx_evaluator():
    """tests/onnx_numpy.py of this checkout (the evaluator the tests run),
    loaded by path: the package ships no ONNX runtime."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests',
                        'onnx_numpy.py')
    spec = importlib.util.spec_from_file_location('onnx_numpy', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def onnx_export_phase(card, root):
    """Phase 32 (a); returns its numbers and the model for (c)."""
    from paddle_tpu_torch import onnx
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

    evaluator = _onnx_evaluator()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig.gpt2_small()
    model = GPTForCausalLM(cfg, device='cuda', seed=SEED + 320).eval()
    ids = np.random.RandomState(SEED + 320).randint(
        0, cfg.vocab_size, (1, ONNX_SEQ)).astype(np.int64)
    seen = set()
    undo = _kernel_dtypes(fa, seen)
    try:
        _reset_counts(fa)
        with torch.no_grad():
            want = model(torch.from_numpy(ids).cuda()).cpu().numpy()
        torch.cuda.synchronize()
        launches = _launches(fa)
    finally:
        undo()
    _check(launches == _want(1, flash_fwd=cfg.num_layers) and
           seen == {('flash_fwd', 'float32')}, 'the eager forward launched '
           '%s (%s), want %d f32 flash_fwd' % (launches, sorted(seen),
                                               cfg.num_layers))
    t0 = time.perf_counter()
    path = onnx.export(model, os.path.join(root, 'gpt2_small'),
                       input_spec=[InputSpec([1, ONNX_SEQ], 'int64', 'ids')])
    export_s = time.perf_counter() - t0
    stats = dict(onnx.export.stats)
    _check(_launches(fa) == launches, 'the export launched kernels: %s'
           % _launches(fa))
    _check(stats['flash_lowered'] == cfg.num_layers, 'the export lowered '
           '%d flash nodes, want %d' % (stats['flash_lowered'],
                                        cfg.num_layers))
    t0 = time.perf_counter()
    with open(path, 'rb') as f:
        blob = f.read()
    got = evaluator.run_onnx(blob, {'ids': ids})[0]
    eval_s = time.perf_counter() - t0
    del blob
    _check(got.shape == want.shape and np.isfinite(got).all(),
           'ONNX logits %s, want finite %s' % (got.shape, want.shape))
    err = float(np.abs(got - want).max() / np.abs(want).max())
    _check(err <= ONNX_TOL, 'ONNX logits vs the card %.3g of the largest '
           '(tol %g)' % (err, ONNX_TOL))
    out = {'export_s': export_s, 'mb': stats['bytes'] / 1e6,
           'nodes': stats['nodes'], 'initializers': stats['initializers'],
           'flash_lowered': stats['flash_lowered'],
           'launches': launches['flash_fwd'], 'eval_s': eval_s, 'err': err}
    print('slice 23 (a) [%s]: GPT-2 small f32 (TF32 off) on 1 x %d ids: the '
          'eager forward %d f32 flash_fwd launches; onnx.export %.2f s, '
          '%.1f MB, %d nodes, %d initializers, %d flash nodes lowered; '
          'the file on the host through tests/onnx_numpy.py %.2f s, logits '
          '%.3g of the largest off the card\'s (tol %g)'
          % (card, ONNX_SEQ, out['launches'], export_s, out['mb'],
             out['nodes'], out['initializers'], out['flash_lowered'],
             eval_s, err, ONNX_TOL), flush=True)
    return out, model


def _cache_files(root, sub):
    n = 0
    for _, _, names in os.walk(os.path.join(root, sub)):
        n += len(names)
    return n


def _read_outputs(path):
    """The client's output file: int32 n, then per output int32 rank,
    int64 dims, f32 values."""
    with open(path, 'rb') as f:
        blob = f.read()
    (n,), pos, outs = struct.unpack_from('<i', blob), 4, []
    for _ in range(n):
        (rank,) = struct.unpack_from('<i', blob, pos)
        dims = struct.unpack_from('<%dq' % rank, blob, pos + 4)
        pos += 4 + 8 * rank
        count = int(np.prod(dims))
        outs.append(np.frombuffer(blob, np.float32, count, pos).reshape(
            dims))
        pos += 4 * count
    return outs


def capi_phase(card, pred, x, path, cache, root):
    """Phase 32 (b), run by phase 29 (c): the C API serving its PP-YOLOv2
    artifact `path` on input `x` from a child process (Inductor cache
    `cache`, builds in `root`), against its Predictor `pred` in process.
    The caller restores cuDNN's TF32 setting."""
    from paddle_tpu_torch import capi

    # the child runs under torch's defaults (cuDNN TF32 on, matmul TF32
    # off, as phase 29 (c) compiled): the in-process reference runs under
    # the same
    torch.backends.cudnn.allow_tf32 = True
    name = pred.get_input_names()[0]
    names = pred.get_output_names()
    run_ms = []
    for _ in range(1 + CAPI_RUNS):
        t0 = time.perf_counter()
        pred.get_input_handle(name).copy_from_cpu(x)
        pred.run()
        want = [pred.get_output_handle(n).copy_to_cpu() for n in names]
        run_ms.append((time.perf_counter() - t0) * 1e3)
    _check(pred.compile_count() == 1, 'the Predictor compiled %d programs'
           % pred.compile_count())
    t0 = time.perf_counter()
    lib = capi.build_capi()
    src = os.path.join(root, 'client.c')
    exe = os.path.join(root, 'client')
    with open(src, 'w') as f:
        f.write(CAPI_CLIENT_C)
    proc = subprocess.run(['gcc', '-O2', '-o', exe, src, '-I',
                           os.path.dirname(capi.header_path()), lib,
                           '-Wl,-rpath,' + os.path.dirname(lib)],
                          capture_output=True, text=True)
    _check(proc.returncode == 0, 'the C client did not build: %s'
           % proc.stderr[-2000:])
    build_s = time.perf_counter() - t0
    x_path, out_path = os.path.join(root, 'x.raw'), os.path.join(root,
                                                                 'out.raw')
    x.astype(np.float32).tofile(x_path)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TORCHINDUCTOR_CACHE_DIR=cache,
               PYTHONPATH=os.pathsep.join(
                   [repo] + [p for p in sys.path if p and os.path.isdir(p)]))
    before = {sub: _cache_files(cache, sub)
              for sub in ('fxgraph', 'aotautograd')}
    t0 = time.perf_counter()
    proc = subprocess.run([exe, repo, path, 'gpu', x_path] +
                          [str(d) for d in x.shape] +
                          [out_path, str(CAPI_RUNS)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    child_s = time.perf_counter() - t0
    _check(proc.returncode == 0, 'the C client exited %d: %s'
           % (proc.returncode, proc.stderr[-3000:]))
    timing = json.loads(proc.stdout.strip().splitlines()[-1])
    new = {sub: _cache_files(cache, sub) - n
           for sub, n in before.items()}
    got = _read_outputs(out_path)
    _check(len(got) == len(want) and all(
        g.shape == w.shape for g, w in zip(got, want)), 'C outputs %s, want '
        '%s' % ([g.shape for g in got], [w.shape for w in want]))
    bitwise = all(np.array_equal(g, w.astype(np.float32))
                  for g, w in zip(got, want))
    err = max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
              for g, w in zip(got, want))
    _check(bitwise or err <= DECODE_TOL, 'C outputs vs the Predictor %.3g '
           'of the largest (tol %g)' % (err, DECODE_TOL))
    out = {'bitwise': bitwise, 'err': err, 'build_s': build_s,
           'child_s': child_s, 'first_output_s': timing['first_output_s'],
           'ready_s': timing['ready_s'], 'capi_p50_ms': timing['run_p50_ms'],
           'run_p50_ms': _p50(run_ms[1:]), 'new_cache_files': new,
           'warm': new['fxgraph'] == 0}
    print('slice 23 (b) [%s]: PP-YOLOv2 (BASELINE config 4, %s, f32, cuDNN '
          'TF32 on as torch defaults) through the C API in a child process '
          'on device "gpu": library + client built in %.2f s; the child %.2f '
          's to its first output (interpreter and Predictor ready at %.2f '
          's), %.2f s in all; Inductor cache %s (new entries %s); outputs %s '
          '(largest error %.3g of the largest, tol %g); PD_PredictorRun p50 '
          '%.3f ms over %d (C clock) beside the in-process run() p50 %.3f ms '
          '(numpy in, both outputs to the host, as the bridge copies them)'
          % (card, 'x'.join(str(d) for d in x.shape), build_s,
             out['first_output_s'], out['ready_s'], child_s,
             'warm' if out['warm'] else 'cold', json.dumps(new),
             'bit-equal' if bitwise else 'not bit-equal', err, DECODE_TOL,
             out['capi_p50_ms'], CAPI_RUNS, out['run_p50_ms']), flush=True)
    return out


def crypto_phase(card, model, root):
    """Phase 32 (c): (a)'s GPT-2 small state saved from the card with
    encryption_key=, loaded back onto the card: bit-equal, the scheme, the
    rate each way; a wrong key raises."""
    from paddle_tpu_torch.framework import crypto, io_save

    state = {k: v.detach() for k, v in model.state_dict().items()}
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    key = crypto.generate_key()
    path = os.path.join(root, 'gpt2_small.pdparams')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    io_save.save(state, path, encryption_key=key)
    save_s = time.perf_counter() - t0
    with open(path, 'rb') as f:
        head = f.read(9)
    scheme = {crypto._SCHEME_GCM: 'gcm',
              crypto._SCHEME_HMAC_CTR: 'hmac_ctr'}.get(head[8])
    _check(head[:8] == crypto._MAGIC, 'the file is not a PTCRYPT1 container')
    t0 = time.perf_counter()
    loaded = {k: v.cuda() for k, v in io_save.load(
        path, encryption_key=key).items()}
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    _check(set(loaded) == set(state) and all(
        loaded[k].dtype == v.dtype and torch.equal(loaded[k], v)
        for k, v in state.items()), 'the decrypted state differs')
    try:
        io_save.load(path, encryption_key='not-the-key')
        refused = False
    except ValueError:
        refused = True
    _check(refused, 'a wrong key loaded the state')
    out = {'scheme': scheme, 'gb': nbytes / 1e9, 'save_s': save_s,
           'load_s': load_s, 'save_gbs': nbytes / 1e9 / save_s,
           'load_gbs': nbytes / 1e9 / load_s}
    print('slice 23 (c) [%s]: GPT-2 small state (%d tensors, %.3f GB) '
          'saved from the card with encryption_key= (%s) in %.2f s (%.3f '
          'GB/s) and loaded onto the card in %.2f s (%.3f GB/s): bit-equal, '
          'a wrong key refused' % (card, len(state), out['gb'], scheme,
                                   save_s, out['save_gbs'], load_s,
                                   out['load_gbs']), flush=True)
    return out


def slice23_phases(card, capi_out):
    """Phase 32: slice 23, export and the C surface, on one card: (a) and
    (c); (b) ran inside phase 29 (c), whose numbers `capi_out` are."""
    import shutil
    import tempfile

    t0 = time.time()
    root = tempfile.mkdtemp(prefix='chip_smoke_slice23_')
    try:
        onnx_out, model = onnx_export_phase(card, root)
        out = {'onnx': onnx_out, 'crypto': crypto_phase(card, model, root)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    out['seconds'] = time.time() - t0
    a, b, c = out['onnx'], capi_out, out['crypto']
    print('phase 32 (slice 23) [%s]: %s' % (card, json.dumps({
        'onnx_export_s': round(a['export_s'], 2), 'onnx_mb': round(a['mb'], 1),
        'onnx_flash_lowered': a['flash_lowered'],
        'onnx_flash_launches': a['launches'],
        'onnx_eval_s': round(a['eval_s'], 2), 'onnx_err': a['err'],
        'capi_bitwise': b['bitwise'], 'capi_err': b['err'],
        'capi_first_output_s': round(b['first_output_s'], 2),
        'capi_inductor_warm': b['warm'],
        'capi_run_p50_ms': round(b['capi_p50_ms'], 3),
        'predictor_run_p50_ms': round(b['run_p50_ms'], 3),
        'crypto_scheme': c['scheme'],
        'crypto_save_gbs': round(c['save_gbs'], 3),
        'crypto_load_gbs': round(c['load_gbs'], 3),
        'seconds': round(out['seconds'], 1)})), flush=True)
    return out


def _pct(xs, q):
    from paddle_tpu_torch.serving import percentile
    return percentile(xs, q)


# How each kernel entry computes its products: "wgmma+tma" (warpgroup
# wgmma on TMA-fed shared memory, a producer warpgroup and consumer
# warpgroups). The fused backward launches the dk/dv kernel, then the dq
# kernel; both are wgmma+tma. In f32 at d = 64 / 128 every entry runs
# DESIGN_F32: three TF32 mma.sync products for each f32 product, operands
# split in registers, on TMA-fed shared memory (csrc/tf32x3.cuh).
DESIGN_F32 = 'split-tf32 mma.sync+tma'
DESIGN = {'flash_fwd': 'wgmma+tma', 'flash_fwd_long': 'wgmma+tma',
          'flash_bwd_fused': 'wgmma+tma', 'flash_bwd_dkv': 'wgmma+tma',
          'flash_bwd_dkv_long': 'wgmma+tma', 'flash_bwd_dq': 'wgmma+tma',
          'flash_bwd_dq_long': 'wgmma+tma'}


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    from paddle_tpu_torch import _build

    card = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    sku = _sku(name)
    print('card: %s (datasheet row %s)' % (card, sku[0]), flush=True)
    print('torch %s, CUDA %s' % (torch.__version__, torch.version.cuda),
          flush=True)

    t0 = t_run = time.time()
    outputs = _build.build(['flash_fwd', 'flash_bwd'])
    print('build: %.1f s' % (time.time() - t0), flush=True)
    for src, text in outputs.items():
        entry = ''
        for line in text.splitlines():
            if 'Compiling entry function' in line:
                entry = line.split("'")[1] if "'" in line else line
                # from the kernel's name on: its template arguments follow
                entry = entry[entry.rfind('flash_'):]
            if any(key in line for key in ('registers', 'spill', 'wgmma')):
                print('  %s: %s %s' % (src, entry[:64], line.strip()), flush=True)

    start = time.time()

    def timed(phase, *args):
        out = phase(*args)
        print('%s done at %.1f s' % (phase.__name__, time.time() - start),
              flush=True)
        return out

    fwd_rows = timed(kernel_phase, sku)
    bwd_rows = timed(bwd_kernel_phase, sku)
    long_rows = timed(long_kernel_phase, sku)
    wide_rows = timed(wide_kernel_phase, sku)
    generate_launches = timed(slice_phases)
    timed(engine_parity_phase)
    timed(engine_throughput_phase)
    timed(gateway_parity_phase)
    inproc_qos = timed(gateway_qos_phase)
    timed(fabric_parity_phase)
    timed(fabric_qos_phase, inproc_qos)
    timed(multimodel_phase)
    timed(train_f32_phase)
    train = timed(train_main_phase, sku)
    second = timed(train_seq1024_phase)
    long_train = timed(train_long_phase, sku)
    slice7 = timed(slice7_phases, sku, train)
    slice9 = timed(slice9_phases, card, train)
    slice10 = timed(slice10_phases, sku, train)
    slice11 = timed(slice11_phases)
    timed(slice12_phases, card)
    slice13 = timed(slice13_phases, card)
    slice14 = timed(slice14_phases, card, sku)
    slice15 = timed(slice15_phases, card, train,
                    slice10['predictor'].pop('keep'))
    slice16 = timed(slice16_phases, card, sku)
    slice17 = timed(slice17_phases, card)
    timed(slice18_phases, card, sku)
    timed(slice19_phases, card, sku)
    slice20 = timed(slice20_phases, card, sku)
    slice21 = timed(slice21_phases, card, sku)
    slice22 = timed(slice22_phases, card)
    slice23 = timed(slice23_phases, card, slice20['predictor']['capi'])

    def train_fwd(dtype):
        return next(r for r in fwd_rows
                    if r['shape'] == list(TRAIN_SHAPE[:5]) and r['strided']
                    and r['dtype'] == str(dtype).split('.')[-1])

    fwd = train_fwd(torch.bfloat16)

    def bwd(which, shape_key):
        return next(r for w, key, r in bwd_rows
                    if w == which and key == shape_key)

    def entry(name, source, line, row, launches, steps, path, shape):
        out = {
            'name': name, 'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/%s.cu' % source,
            'replaces': 'paddle_tpu/ops/flash_attention.py:%d' % line,
            'design': DESIGN[name],
            'launches': launches, 'launches_per_step': launches // steps,
            'path': path, 'max_abs_err': row.get('err_o', row.get(
                'max_abs_err')),
            'ms': row['ms'], 'eager_ms': row['eager_ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
            'bound_by': row['bound_by'],
            'share_of_bound': row['share_of_bound'],
            'library_ms': row['library_ms'],
            'vs_library': row['ms'] / row['library_ms'], 'shape': shape,
        }
        for key in ('std_ms', 'kernels_ms', 'bound_ms_cuda_cores',
                    'kernels'):
            if key in row:
                out[key] = row[key]
        return out

    def pair(dq_row, dkv_row):
        """The two-pass pair (dq + dk/dv ms) over the library's whole
        backward at the same shape: no PyTorch call computes dq alone."""
        return (dq_row['ms'] + dkv_row['ms']) / dq_row['library_ms']

    train_shape = 'b=32 h=12 n=m=512 d=64 bfloat16 causal strided'
    second_shape = 'b=8 h=12 n=m=1024 d=64 bfloat16 causal strided'
    kernels = [
        entry('flash_fwd', 'flash_fwd', 137, fwd,
              train['launches']['flash_fwd'], train['steps'],
              'train (generate: %d)' % generate_launches, train_shape),
        dict(entry('flash_bwd_fused', 'flash_bwd', 659,
                   bwd('fused', BWD_MAIN_SHAPE),
                   train['launches']['flash_bwd_fused'], train['steps'],
                   'train', train_shape),
             two_pass_ms=bwd('dq', BWD_MAIN_SHAPE)['ms'] +
             bwd('dkv', BWD_MAIN_SHAPE)['ms']),
        entry('flash_bwd_dq', 'flash_bwd', 580,
              bwd('dq', BWD_SECOND_SHAPE),
              second['launches']['flash_bwd_dq'], second['steps'],
              'train seq 1024', second_shape),
        entry('flash_bwd_dkv', 'flash_bwd', 617,
              bwd('dkv', BWD_SECOND_SHAPE),
              second['launches']['flash_bwd_dkv'], second['steps'],
              'train seq 1024', second_shape),
    ]
    long_shape = 'b=2 h=12 n=m=8192 d=64 bfloat16 causal strided'
    for kernel, source, line, which in (
            ('flash_fwd_long', 'flash_fwd', 343, 'fwd'),
            ('flash_bwd_dq_long', 'flash_bwd', 437, 'dq'),
            ('flash_bwd_dkv_long', 'flash_bwd', 474, 'dkv')):
        kernels.append(entry(kernel, source, line,
                             long_rows[which, LONG_MAIN_SHAPE],
                             long_train['launches'][kernel],
                             long_train['steps'], 'train seq 8192',
                             long_shape))
    # slice 7's operand types at the training shape: fp16 under loss
    # scaling (wgmma, like bf16), f32 under auto_cast O1 (split TF32)
    for shape_key, run, path in (
            (TRAIN_SHAPE_F16, slice7['fp16'], 'slice 7 (d) fp16 AMP'),
            (TRAIN_SHAPE_F32, slice7['eager']['O1'],
             'slice 7 (e) eager auto_cast O1')):
        dtype = str(shape_key[5]).split('.')[-1]
        shape = 'b=32 h=12 n=m=512 d=64 %s causal strided' % dtype
        design = DESIGN_F32 if dtype == 'float32' else None
        for kernel, source, line, row in (
                ('flash_fwd', 'flash_fwd', 137, train_fwd(shape_key[5])),
                ('flash_bwd_fused', 'flash_bwd', 659,
                 bwd('fused', shape_key))):
            k = dict(entry(kernel, source, line, row,
                           run['launches'][kernel], run['steps'], path,
                           shape), dtype=dtype)
            if design:
                k['design'] = design
            kernels.append(k)
    # slice 9 drives the same two kernels through Model.fit: its launches
    # beside the main path's
    for k in kernels[:2]:
        k['fit_launches'] = slice9['launches'][k['name']]
        k['fit_launches_per_step'] = k['fit_launches'] // slice9['steps']
    # slice 10 drives them from inside compiled programs: the to_static
    # step (path a), and the forward in each Predictor run (path b)
    for k in kernels[:2]:
        k['static_launches'] = slice10['train']['launches'][k['name']]
        k['static_launches_per_step'] = \
            k['static_launches'] // slice10['train']['steps']
    kernels[0]['predictor_launches_per_run'] = \
        slice10['predictor']['rows']['f32']['launches_a_run']
    # slice 11 drives them through the static graph: the forward in each
    # Executor.run of the GPT-2 small Program and of its artifact, the
    # forward and the fused backward in append_backward
    kernels[0]['executor_launches_per_run'] = \
        slice11['program']['f32']['launches_a_run']
    kernels[0]['artifact_launches_per_run'] = \
        slice11['program']['artifact']['launches_a_run']
    for k in kernels[:2]:
        k['append_backward_launches'] = \
            slice11['backward']['launches'][k['name']]
    # slice 13: the fleet strategies' launches a step (the forward and the
    # fused backward) and the ring block check's launches of every entry
    fleet_runs = slice13['fleet']['runs']
    for k in kernels[:2]:
        k['fleet_launches_per_step'] = {
            name: fleet_runs[name]['launches'][-1][k['name']]
            for name in FLEET_STRATEGIES}
    for k in kernels:
        # the ring check runs in bf16 and counts by entry, not by dtype:
        # its counts go on the bf16 rows alone (the rows without 'dtype')
        if 'dtype' not in k:
            k['ring_launches'] = slice13['ring']['launches'].get(k['name'], 0)
    # slice 14: nn.Transformer's non-causal launches a step of #1, #4 and
    # #5 (the cross-attention n = 512, m = 1024, the encoder at 1024), and
    # the unmasked encoder's #1 and #3 as rows of their own
    xf = slice14['encoder']['transformer']['launches']
    for k in kernels:
        if 'dtype' not in k and k['name'] in ('flash_fwd', 'flash_bwd_dq',
                                              'flash_bwd_dkv'):
            k['transformer_launches_per_step'] = xf[k['name']]
        if 'dtype' not in k:
            k['bert_launches_per_step'] = \
                slice14['bert']['launches'][k['name']] // \
                slice14['bert']['steps']
    # slice 15: the profiled bench step's flash kernels by name (the fused
    # backward's two kernels each once a launch of its entry)
    prof = slice15['profiler']['flash']
    kernels[0]['profiled_launches_per_step'] = \
        prof['flash_fwd_tma_kernel'] // 2
    kernels[1]['profiled_launches_per_step'] = \
        prof['flash_bwd_kv_tma_kernel'] // 2
    # slice 16: the pipeline schedules' launches a step (4 microbatches of
    # 8) and the MoE GPT's
    moe = slice16['moe']['switch']
    for k in kernels[:2]:
        k['pp_launches_per_step'] = {
            s: slice16['pipeline'][s]['launches'][-1][k['name']]
            for s in ('gpipe', '1f1b')}
        k['moe_launches_per_step'] = moe['launches'][k['name']] // \
            moe['steps']
    # slice 17: the launched pod's composed step (ZeRO-3 over 'mp',
    # recompute, amp, ClipGradByNorm) a step, and the TP decode's prefill
    for k in kernels[:2]:
        k['composed_launches_per_step'] = \
            slice17['launch']['composed']['launches'][-1][k['name']]
    kernels[0]['tp_decode_launches'] = slice17['decode']['launches']
    # slice 21: the weight-only int8 GPT-2 small's prefill, and the 2:4
    # pruned bench GPT's eager steps (the forward and the fused backward)
    kernels[0]['int8w_prefill_launches'] = \
        slice21['int8w']['rows']['int8w']['launches']
    for k in kernels[:2]:
        k['asp_launches_per_step'] = \
            slice21['asp']['launches'][k['name']] // slice21['asp']['steps']
    # slice 22: op_benchmark's flash config, warm-up and timed calls
    kernels[0]['op_benchmark_launches_per_run'] = \
        slice22['op_benchmark']['launches']
    # slice 23: GPT-2 small's eager forward before its ONNX export (f32)
    kernels[0]['onnx_export_forward_launches'] = slice23['onnx']['launches']
    enc = slice14['encoder']['encoder']
    encoder_shape = 'b=32 h=12 n=m=512 d=64 bfloat16 non-causal'
    for kernel, source, line, row in (
            ('flash_fwd', 'flash_fwd', 137, next(
                r for r in fwd_rows if r['shape'] == list(ENCODER_SHAPE[:5])
                and not r['causal'] and r['dtype'] == 'bfloat16')),
            ('flash_bwd_fused', 'flash_bwd', 659,
             bwd('fused', ENCODER_SHAPE))):
        kernels.append(dict(entry(kernel, source, line, row,
                                  enc['launches'][kernel], enc['steps'],
                                  'slice 14 (c) encoder, no mask',
                                  encoder_shape), causal=False))
    pairs = {'flash_bwd_dq': pair(bwd('dq', BWD_SECOND_SHAPE),
                                  bwd('dkv', BWD_SECOND_SHAPE)),
             'flash_bwd_dq_long': pair(long_rows['dq', LONG_MAIN_SHAPE],
                                       long_rows['dkv', LONG_MAIN_SHAPE])}
    for k in kernels:
        if k['name'] in pairs:
            k['pair_vs_library'] = pairs[k['name']]
    body_line = {'flash_fwd': 137, 'flash_bwd_fused': 659,
                 'flash_bwd_dq': 580, 'flash_bwd_dkv': 617}
    wide = [dict(row, route='cuda', design='cuda cores, 16-bit staged',
                 source='paddle_tpu_torch/csrc/%s.cu' % (
                     'flash_fwd' if row['name'] == 'flash_fwd'
                     else 'flash_bwd'),
                 replaces='paddle_tpu/ops/flash_attention.py:%d'
                 % body_line[row['name']],
                 launches=0, path='none (a check at d = 192 / 256)')
            for row in wide_rows]
    print('chip_smoke: %.1f s in all, the build included (time limit 1200 '
          's)' % (time.time() - t_run), flush=True)
    print(json.dumps({'kernels_wide': wide}), flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
