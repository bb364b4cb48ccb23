#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100
is the target: the kernels build for sm_90a). Phases, in order; any
failure exits non-zero before the result line:

  1. device   — CUDA present; the card's name and power limit
                (nvidia-smi);
  2. build    — nvcc builds every kernel in incubator_mxnet_tpu_torch/
                csrc/ (in parallel), timed; each ragged and flash
                kernel's ptxas registers, shared memory and spills, and
                its SASS counts of HMMA / LDSM / LDGSTS / UTMALDG /
                STS.U16 (cuobjdump): the ragged tensor-core bodies
                (prefill_mma, verify_mma, decode_mma) must issue HMMA,
                LDSM and LDGSTS; the flash TMA bodies (forward, dq,
                dk/dv) HMMA, LDSM and TMA loads (UTMALDG), and no STS.U16
                (no transposed copy, stored 2 bytes at a time); the
                forward's no spills;
  3. kernels  — each of the six ragged kernels (decode, prefill, verify,
                and their int8 / fp8_e4m3 code-pool variants) against its
                plain PyTorch version on the card at the serving path's
                shapes, f32 and bf16 queries (prefill: the chunk as a
                device span at starts 0, 64, 200 and 960), plus the
                contract cases:
                NaN past the bound (length, start + n_real, length +
                draft_len), NaN inside it, length 0, page permutation,
                and a NaN page scale on a masked and on a live page
                (decode, prefill and verify: on both bodies, f32 and
                bf16, raw and code pools, with two launches bitwise
                equal); the decode tensor-core body (bf16, D=64) at
                lengths 0-65 and the capacity, capacities of 1, 4 and 64
                pages; the verify tensor-core body at W = 1, 2, 5, 16, 17
                and capacities of 1024 and 2048 keys, raw / int8 / fp8;
                torch.profiler shows one bf16 decode call running one
                device kernel;
  4. flash    — the three flash-attention kernels (forward, dq, dk/dv)
                against their plain versions, f32 and bf16, at BERT's
                shapes (B=4, H=12, T=512, D=64, lengths 0 / 1 / 200 /
                512), at T=2048 causal and not, D=128 with Tq != Tk, and
                D=64 at lengths that straddle the 64-row tiles; each
                gradient within a fraction of the largest |gradient| of
                its own (batch, head) slice, and the Δ the dq launch
                writes within f32 summation error of attn_delta; bf16
                causal at tile counts and B x H awkward for the
                heaviest-first work order (T = 576 with B x H = 15, 65,
                511, 2048); two launches bitwise equal (causal and not);
                NaN in the K/V rows past valid_len changes no output
                (bf16, T = 37 / 200 / 512, causal and not);
  5. serving  — gpt_small (GPT-2 small widths, bf16, seeded random
                weights) through InferenceEngine with chunked prefill and
                the prefix cache, 16 requests per run, every decode /
                verify step a replay of its width's CUDA graph and every
                prefill chunk a replay of its bucket's (each width and
                each (kind, bucket) that ran captured once: printed with
                its capture ms, and checked): plain decode;
                spec_k=4 with the n-gram drafter (raw pools); spec_k=4
                drafting by replay of the plain run's streams (a
                controlled accept rate) on raw pools, on int8 pools, and
                (4 requests) on fp8_e4m3 pools; then a short monolithic
                run (chunk_pages=None: the dense prompt programs, one per
                page bucket) on raw and int8 pools, with a request that
                repeats the first 250 tokens of an earlier prompt (a
                prefix hit through the COW copy program and a suffix
                chunk). Each run reads its kernels' launch counts
                (decode = non-speculative steps x layers, verify =
                speculative steps x layers, prefill = chunk replays x
                layers: no launch outside a graph) and prints tokens/s,
                TTFT p50, decode ms/step, accept rate and tokens per
                step; 10 steps of the plain and the speculative engine
                run under torch.profiler (device-busy share), and 10
                graphed chunk steps of one 960-token prompt (the ragged
                prefill kernels' share); the graphed decode step's and
                chunk step's host time (staging, launch, readback) and
                the device time of the draw and of the whole
                acceptance;
  5b. surface — the serving engine's remaining surface on gpt_small bf16
                (seed 0): KV cache tiers on raw bf16, int8 and fp8_e4m3
                pools (18 requests: 6 prefixes of 512 tokens, 3 requests
                each with a 64-token tail and 32 new greedy tokens, on 4
                slots and a pool just above their reservation, DRAM
                holding two prefixes and a disk tier under a temporary
                directory): demotions, spills, promotions from DRAM and
                from disk, no crc fallback, one gather and one promotion
                capture, the audit clean before every step, greedy
                streams bitwise an engine's that never evicts, ragged
                launches from replays only; prints the tier counters,
                the gather and promotion host ms per page and the bytes
                a page. Page transport between two engines (raw bf16 and
                int8 pools; 8 requests of 64-768 prompt tokens, 64 new,
                greedy and seeded T=0.8): each slot captured off A at 16
                tokens, installed on B, finished there; streams bitwise
                those of A alone, B prefilling nothing (its decode step
                takes each slot on from its last token), custody
                released, audits clean, one promotion build on B; prints
                capture / install ms per slot and MB moved.
                Brownout: one overloaded run (16 requests of three tiers
                on 4 slots, spec_k=4, a 50 ms delay reference): the level
                timeline, every request terminal, audits clean. Warm
                start: an engine on the seed-0 model serves 4 requests,
                takes the seed-1 model's weights, serves 4 more: no new
                capture, streams bitwise a fresh seed-1 engine's;
  5c. fleet   — one row with top-p 0.9 / top-k 40 in each of 8 slots of
                an (8, W, 50257) batch draws the same (`[sampling]`);
                then 3 gpt_small bf16 replicas behind a Router
                (build_fleet: one weight copy each), the serving phase's
                mixed workload in two waves: fault-free (the prefix's
                requests on the prefix's replica; streams bitwise one
                engine's under the router-pinned seeds); a replica
                killed mid-decode, and on a spec_k=4 fleet whose drafter
                always drafts, mid-verify (one terminal each, emitted
                prefixes kept, survivors bitwise the fault-free run's);
                remove_replica (decode-ready slots moved by capsule,
                streams bitwise); upgrade_replica(0) to the seed-1
                weights while 1-2 serve (then replica 0 serves seed-1
                streams, 1-2 seed 0's); a ServeFrontend on 127.0.0.1 over
                a plain fleet (4 SSE + 1 blocking, tokens equal the
                direct router's, /metrics and /healthz) and over a spec
                fleet (one stream a replica while the front end's thread
                captures their verify programs). Every run: page audits
                after every step, one capture per program met, summed
                ragged launches = steps x 12, and no breaker transition
                but the injected ones; a `[fleet]` line each (tokens/s,
                TTFT p50 direct or over HTTP, requeue-to-first-token ms,
                ms a slot migrated, transitions, captures per replica);
  6. parity   — at f32, the engine's greedy tokens, without and with
                spec_k=4, equal the port's dense-cache cached_generate
                (which runs no kernel), through the step and chunk graphs
                (the prefill kernel's CUDA-core body); then the graphs'
                cuda tests (tests/test_torch_serve_graphs.py,
                tests/test_torch_page_graphs.py,
                tests/test_torch_train_graphs.py,
                tests/test_torch_gpt_graphs.py and
                tests/test_torch_symbol_graphs.py, pytest without the
                conftest, so no JAX): replay == body bitwise (steps and
                chunks; train steps with dropout from a registered
                generator, two signatures alternating), a build touches
                no live page, launches per replay, one capture per width
                through stalls and a quarantine, one per (kind, bucket)
                through a COW hit, one per batch signature, a NaN batch
                through a replay, a failed capture raising; the page
                gather and promotion captured once over tiered traffic,
                a gather after a decode replay seeing its row, bf16 /
                fp8 payloads bitwise through DRAM and disk, a promotion
                on the card writing the CPU path's bytes, a warm start
                seen by the next replays;
  6b. ops     — every registered op (the port's 279: the JAX registry less
                the contrib, vision, quantization and RNN ops that wait)
                on the card against the port on the CPU, every case of
                tests/test_torch_op_cases.py (f32 within 1e-5 of the
                output's largest |entry| or the case's rtol if larger,
                bf16 within 2e-2; gesvd / syevd / gelqf by reconstruction
                and orthogonality), the samplers by their moments on the
                card (that file's `cuda` test, pytest without the
                conftest: no JAX);
  7. training — bert_base bf16 (flash, dropout 0.1) + BERTForPretraining
                through SPMDTrainer with LAMB (lr 1e-4, f32 masters), the
                bench's batch (B=32, T=512, M=76; lengths in [256, 512]):
                3 warm-up and 10 timed steps on one repeating batch
                (dropout masks included); the first step runs eagerly and
                the step graph is captured after it, inside the warm-up
                (one build: step_trace_count 1), every timed step a
                replay; every loss finite, the last below the first, each
                flash kernel launched 12 times a step. Prints tokens/s,
                ms/step, MFU against the card's peak, peak memory, a
                `[capture]` line (the eager first step's ms, the
                capture's), a `[host]` line (a replayed step's staging /
                launch / readback ms), the guarded LAMB apply run
                eagerly (what the graph took off the host), and from one
                profiled step the device-busy share and the attention
                kernels' share; then bert_base at T=1024 (B=4, 2 steps:
                the shapes the JAX package sends to its streaming
                kernels; the second a replay), and bert_tiny: 5 LAMB
                steps on the card (kernels; steps 2-5 replays) against
                the port on the CPU (plain versions), the losses within
                rtol 1e-4 in f32 (CUDA-core bodies) and 2e-3 in bf16
                (the mma.sync bodies bert_base runs), and in bf16 every
                parameter's first-step gradient within 5e-2 of its
                largest |gradient|;
  7b. gluon   — the verify drive on the card, bert_base bf16 through
                autograd.record() / gluon.Trainer("lamb");
  7c. vision  — convolutional image classification, which runs no kernel
                of the port's own (cuDNN convolutions, torch pooling):
                (1) Convolution (1-3-d, stride, dilation, groups,
                depthwise, a 256-channel 3x3), Deconvolution (adj),
                Pooling (max / avg / sum, valid and full at odd padded
                sizes, count_include_pad off) and AdaptiveAvgPooling2D on
                the card against the port on the CPU, f32 within 1e-4 of
                the output's largest |entry| (forward, and the input and
                weight gradients), bf16 within 2e-2, with cuDNN's f32
                convolutions left at torch's TF32 default: the ops set
                IEEE f32 per call (a direct F.conv2d is timed against it
                as the control); (2) resnet50_v1 bf16, B=64, 224x224, as
                bench.py builds it (one forward, cast, SPMDTrainer SGD lr
                0.1 momentum 0.9 multi_precision), 3 warm-up and 10 timed
                steps on one batch: one capture, every timed step a
                replay, finite losses, the last below the first, the
                BatchNorm running statistics moved and finite; img/s, ms
                a step, MFU (3 x 4.1 GFLOP an image over the card's
                peak), peak memory, the eager first step's and the
                capture's ms, and from one profiled step the busy share,
                the top device operations and the shares of the layout
                transposes, of PyTorch's elementwise and reduction
                kernels and of cuDNN / cuBLAS; (3) resnet18_v1(thumbnail=True, classes=10) f32,
                B=32, 32x32, 3 SGD steps (lr 1e-3, momentum 0.9) on the
                card against the port on the CPU from the same weights:
                losses within rtol 1e-4, every parameter and running
                statistic within 1e-3 of its largest |entry| + 1e-5; (4)
                LeNet through
                DataLoader(MNIST(synthetic=True).transform_first(
                ToTensor())), split_and_load, autograd.record(),
                gluon.Trainer("sgd") and metric.Accuracy for 3 epochs
                (282 batches): the loss falls; accuracy and batches/s.
                One `[vision]` JSON line with the card's name and limit;
  7c2. amp    — the MXNet 1.x mixed-precision front end: under
                amp.init("bfloat16") Convolution, FullyConnected, dot,
                batch_dot and interleaved_matmul_selfatt_qk on f32 inputs
                are bitwise the unwrapped op on bf16-cast inputs cast back
                to f32, softmax and BatchNorm on bf16 inputs bitwise the
                f32 computation cast back to bf16; resnet50_v1 (f32
                parameters, B=64, 224x224, one seeded batch) through
                autograd.record() -> amp.scale_loss -> backward ->
                gluon.Trainer("sgd", momentum 0.9).step(64), 3 warm-up and
                10 timed steps, beside the same loop without amp (ms a
                step, img/s, busy share; every loss and every f32
                gradient finite); the first amp bf16 loss of resnet18_v1
                at B=8 on the card within 2e-2 of the port on the CPU;
                then amp.init("float16") (scale from 2^16): resnet18_v1
                B=32, 20 steps, each skipped step keeping the parameters
                and momenta bitwise and halving the scale, at least one
                applied, a batch with an inf skipped bitwise; after
                _deinit_for_tests() no OpSpec.fn stays wrapped. One `[amp]`
                JSON line with the card's name and limit;
  7c3. symbolic — MXNet 1.x's train_imagenet.py flow on resnet50_v1 f32,
                B=64, 224x224: the gluon block hybridized and exported,
                the -symbol.json loaded back (its "[..]" __shape__
                strings parsed) under SoftmaxOutput(normalization=
                "batch"), mx.mod.Module on gpu(0) bound at (64, 3, 224,
                224), set_params from the exported .params, SGD (lr 1e-3,
                momentum 0.9) over seeded batches of an NDArrayIter: 3
                warm-up and 10 timed forward_backward + update steps, the
                train program captured once (its eager first call and
                capture ms), every later step a replay; its first 3 losses
                against the same weights and batches through
                gluon.Trainer on the card (the first loss within 1e-5,
                the parameters after the first update within 1e-4 of
                each tensor's largest |entry|, losses 2-3 within 4x the
                gap a 1e-7 weight perturbation opens between two
                gluon.Trainer runs: a random ResNet-50 is chaotic); a
                replay against the Executor's body run eagerly from the
                same state (outputs within 1e-5, gradients and running
                statistics within 5e-4 of each tensor's largest |entry|:
                cuDNN's backward is not deterministic by default); the
                eager body's step timed
                beside the replayed one; score on the same iterator adds
                the eval program (one capture); SymbolBlock.imports of the
                files against the block at rtol 1e-5. One `[symbolic]`
                JSON line with the card's name and limit (ms a step,
                img/s, busy share, captures and their ms);
  7c4. detection — bench.py `_run_ssd`'s configuration:
                ssd_300(num_classes=20) f32, B=32, 300x300 (7424 anchors),
                two boxes an image from RandomState(0), through
                SPMDTrainer(forward_loss=...) with SGD (lr 0.05, momentum
                0.9, wd 5e-4): MultiBoxTarget (bipartite matching, hard
                negative mining) and the joint loss inside the one
                captured step; 3 warm-up steps (the first eager, then the
                capture) and 10 timed replays; the 3 warm-up losses
                against a second trainer's step body run eagerly from the
                same weights (within 1e-4), finite losses that fall,
                step_trace_count 1; ms a step, img/s, the busy share and
                leading device ops of one profiled step, peak memory.
                SSD.detect (nms_topk 400) on 8 images on the card (the
                initial random weights, where rows survive), timed
                and profiled, against MultiBoxDetection on the CPU from
                the card's probabilities (class ids bitwise, scores and
                boxes within 1e-5; the softmax card vs CPU within 1e-5).
                faster_rcnn_small(num_classes=20) f32, B=2, 600x800: the
                forward and the toy loss of tests/test_contrib_det.py on
                the card against the CPU at the same weights (the RoI
                half of the CPU run from the card's RPN probabilities:
                rois within 1e-2 px with the same batch column and empty
                rows; scores, deltas, RPN outputs, loss and the first
                backbone weight's gradient within 1e-4 of each largest
                |entry|), then net(x, im_info), the toy loss and one
                gluon.Trainer("sgd") step. One `[detection]` JSON line
                with the card's name and limit;
  7c5. imagenet — BASELINE.md config #2 on one card, the ImageNet input
                path: 1024 JPEGs at MXNet's recipe size (short side 256)
                in 32 class folders, packed by the port's im2rec; the
                reader alone (every record a JPEG, the native RecordIO
                reader built, the decoder named, img/s at 1 thread and at
                the machine's core count, the normalization on the card
                bitwise numpy's, a batch bitwise the same at 1 and N
                threads); resnet50_v1 bf16 (1000 classes, each
                bottleneck's last gamma 0) through
                SPMDTrainer.step_microbatches, k = 4 x B = 64 at 224x224
                (a global batch of 256), SGD lr 0.1 momentum 0.9 wd 1e-4
                multi_precision, fed by ImageRecordIter(rand_crop,
                rand_mirror, ImageNet mean / std, bf16) under
                PrefetchingIter: rounds of k = 1, 4, 4 (one build, every
                later microbatch a replay), 5 timed rounds fed and 5 from
                one resident batch (ms a round, img/s, busy share of a
                profiled round each), finite losses that fall, every
                round applied; one round with a NaN microbatch skipped
                bitwise (parameters, optimizer state, BatchNorm
                statistics; one skip, the loss scale 2 -> 1), the next
                applied by the same build; the device ms of the apply the
                accumulation computes on every microbatch; peak memory.
                One `[imagenet]` JSON line with the card's name and
                limit;
  7c6. rnn    — the fused RNN op (ops/rnn.py: one cuDNN call a layer, f32
                forward and backward in IEEE f32) in every mode at 1 and 2
                layers, one and two directions, state_outputs, at T=35,
                B=32, H=650: outputs and the gradients of data, flat
                vector and states card against CPU within 5e-5 of each
                one's largest |entry|; bf16 once (taken, its distance from
                f32); one LSTM layer at PyTorch's default TF32 RNN math
                for the record; the device ms of cuDNN's weight copy (the
                LM's second layer from the flat vector's views against
                the same weights in cuDNN's own layout). MXNet 1.x's word_language_model in its 650-wide
                tied setting (V = 33278, LSTM(650, 2, dropout 0.5), the
                decoder tied by params=, bptt 35, B = 32, f32, seeded
                tokens): the first window's loss (dropout off) on the card
                within 1e-5 of the CPU's from the same weights; 20 windows
                of the example's loop (hidden carried and detached,
                clip_global_norm 0.25 x bptt x B, gluon.Trainer SGD lr
                20): finite losses, ms a window of the last 15 and the
                busy share; the same model through SPMDTrainer's step
                graph (zero begin state a batch, SGD clip_gradient 0.25):
                the first 3 steps against the eager step body of a second
                trainer within 1e-4 (the dropout generator reseeded alike
                for each pair), one build, 10 timed replays (ms a step,
                busy share); cuDNN's weight-copy warnings listed. One
                `[rnn]` JSON line with the card's name and limit;
  7c7. quantization — the six int8 ops (quantize, quantize_v2,
                dequantize, requantize, quantized_fully_connected,
                quantized_conv) card against CPU at k = 147 and m <= 16
                (the padding of the card's int8 product) and at
                ResNet-50's shapes: every output and the int32
                accumulators bitwise. quantize_net (naive) on resnet50_v1
                (1000 classes, Xavier from seed 0, 224²) over 4 seeded
                batches of 32; the int8 net on the card against the same
                int8 net on the CPU (B = 2): every int8 layer bitwise on
                the CPU chain's own input to it; the two chains as they
                run: the first layer whose input codes differ at most one
                quantum apart (a float input on a rounding edge), the
                share flipped and the logits' distance; its logits
                against the f32 net's (top-1 agreement, relative error),
                ms a batch of 32 int8 against f32, and torch.profiler:
                one aten::_int_mm a quantized layer, running cuBLASLt's
                int8 GEMM kernels (their share of busy). One
                `[quantization]` JSON line;
  7d. gpt_training — bench.py `_run_gpt`'s configuration: gpt_small
                bf16 (flash, dropout 0.1, built by `gpt_small(...)` +
                `initialize()`) through SPMDTrainer(forward_loss=lm_loss)
                with AdamW (lr 1e-4, f32 masters), B=16, T=512, one
                repeating batch: 3 warm-up steps (one capture) and 10
                timed replays, each launching the causal flash forward,
                dq and dk/dv 12 times (counts set to 0 just before the
                timed steps); finite losses that fall; ms a step,
                tokens/s, MFU (`utils/flops.gpt_train_flops`, 6.30e12
                FLOP a step, over the card's peak), peak memory, the
                eager first step and capture ms, the busy and attention
                shares of a profiled step; a trainer each with remat=True
                and "dots" (first loss within 1e-2 relative of the
                no-remat one, one capture, peak memory); gpt_mini f32 on
                the card against the CPU from one set of weights (3 AdamW
                steps within 1e-5 relative; greedy_generate's tokens
                equal);
  7e. nmt     — bench.py `_run_nmt`'s configuration: transformer_base
                (max_length=256) f32, B=16, Ts=64, Tgen=48, K=4:
                beam_search_translate_cached once to warm up, 3 timed
                runs (tokens/s, busy share); the cached search's tokens
                equal the uncached search's, scores within 1e-4
                relative, with and without src_valid_length; a small
                flash Transformer (units 256, 4 heads of 64) whose logits
                are within 1e-4 of the largest |logit| of flash=False,
                and 2 SPMDTrainer Adam steps launching the flash kernels
                3 times a layer (encoder, decoder causal, cross);
  7f. checkpoint — gpt_small bf16 (flash, dropout 0.1, AdamW with f32
                masters) through SPMDTrainer at B=16, T=512, 8 steps on
                8 batches with the dropout masks drawn on (not reseeded):
                two uninterrupted runs first (bitwise equal, or their
                spread); `save_checkpoint` at step 2 (its write drained)
                and at step 4, which returns before steps 5-8 run while
                the write is in flight: the committed step 4 bitwise a
                synchronous host copy taken at step 4; a restore of step
                4 into the same trainer (no new capture) reruns 5-8, the
                losses bitwise or within the spread (12 launches of each
                causal flash kernel a replay), a restore into a fresh
                trainer from another seed gives the saved parameters,
                optimizer leaves, counters and generator state bitwise,
                then one capture; a live gpt_small engine
                `warm_start(manager=)` from the training capsule keeps its
                captures and serves the greedy streams of a `params=`
                warm start from the same arrays (ragged decode / prefill
                launched); `train.Supervisor` runs `train.example_target`
                on the card killed at two steps, its per-step losses equal
                an uninterrupted run's. One `[checkpoint]` JSON line: the
                gather (cold and warm), background write and restore ms
                beside the card's name and power limit (the supervised
                runs go on beside the engine part);
  7g. sparse  — MXNet 1.x's example/sparse/matrix_factorization
                (matrix_fact_net in gluon) at MovieLens-10M's id ranges:
                SparseEmbedding(71569, 128) for users and (65135, 128) for
                items, a Dense(64) on each, their product summed, L2 loss,
                f32, B = 128, gluon.Trainer SGD momentum 0.9 with
                lazy_update; ids from a seeded power law over each range,
                ratings from a seeded low-rank target in half-star steps.
                3 steps on the card against the CPU from one set of
                weights (losses and every parameter within 1e-5
                relative); 200 steps whose loss falls, after each the rows
                its batch did not look up bitwise unchanged in both
                tables' weight and momentum; row_sparse_pull of a batch's
                user rows from a local kvstore equal to the table's rows;
                a NaN rating skips its step with every parameter and
                state bitwise unchanged; ms a step over 50 steps, the
                busy share of a profiled step, host syncs a step
                (torch.cuda's sync debug mode) and active rows a step.
                Then LibSVMIter -> Module.fit: 2-class logistic
                regression at a9a's shape (32,561 rows, 123 binary
                features, 11-14 set a row; a seeded file in a temporary
                directory), B = 128, 2 epochs: the first epoch's
                per-batch losses on the card within 1e-5 of the CPU's,
                the loss falls. One `[sparse]` JSON line;
  7h. contrib — resnet50_v1 f32 224² exported to ONNX from the card,
                imported back and bound by the Executor there (logits at
                B = 2 within 1e-4 of the block's largest |logit|; the file
                byte-equal to the one a CPU copy of the weights writes);
                SVRGModule on a linear regression at YearPredictionMSD's
                90 features (MXNet 1.x's example/svrg_module; seeded): the
                gradient at the snapshot equals mu, the loss falls; one
                matrix-factorization step under mx.profiler with the
                device trace on (the dumped Chrome trace holds its CUDA
                kernels); a Monitor's rows from the MF net; nd.Custom
                forward and backward on the card equal numpy, and refused
                inside a CUDA graph capture; test_utils.check_consistency
                cpu() against gpu(0) on seven registry ops;
                gpu_memory_info. One `[contrib]` JSON line;
  7i. parallel — data parallelism over a real NCCL process group of
                one rank, formed by parallel.initialize() from the
                variables tools/launch.py sets (MXTPU_COORDINATOR /
                MXTPU_NUM_PROCS / MXTPU_PROC_ID): gpt_small bf16 (flash,
                dropout 0.1, AdamW with f32 masters) B=16 T=512 through
                SPMDTrainer(mesh=build_mesh()) with sharding "replicated"
                and "fsdp" (over an fsdp axis of 1 the JAX rule shards
                nothing, so it is the replicated step), losses of 15
                steps bitwise the single-device trainer's (run before the
                group formed), each with ms a step over 12 back-to-back
                replays, the busy share and the NCCL kernels found in a
                profiled replay (the collectives are in the step graph);
                resnet50_v1 f32 B=64 224² through gluon.Trainer(kvstore=
                "dist_sync", int8_allreduce=True, overlap_allreduce=True)
                for 3 SGD steps against the first step of the same path
                in a CPU process over a gloo group of one, started first
                (the first loss within 1e-4; the first update of the
                trained parameters within 0.1 of the CPU's in L1
                relative, between what an H100 read for int8, 0.034,
                and for the plain f32 step, 0.44, which must read above
                it; the running statistics within 1e-4), then 3 more
                steps timed beside the plain gluon step's; a
                dist_sync store with 2-bit compression on the card
                (pulled values and residuals bitwise the CPU's); and a
                dozen mx.np / mx.npx calls against numpy. Everything
                timed runs after the CPU process has exited. One
                `[parallel]` JSON line;
  7j. sequence — the sp ring's kernel path on the card: block_attn_lse
                (gpt_small's heads, H=12 D=64 bf16, B=4 T=1024, lengths
                full, 0 and ragged) against its plain version (out, lse,
                the autograd dq / dk / dv, and block_attn_bwd's from an
                outside (out, lse)); then four virtual ranks of the flash
                ring (parallel/ring_attention.py's flash_ring_fwd /
                flash_ring_bwd, the loops ring_flash_attention runs, with
                the four ranks in this process and the blocks rotated
                between steps: T=4096 B=4, 1024-token blocks), causal and
                not, forward and backward, held against flash attention
                over the whole sequence (the same kernels at T=4096) and
                against the plain ring (plain_ring, autograd), at phase
                4's bf16 tolerances; the ring's launches counted
                (SEQ["launches"] per ring, both rings, into the kernels
                line) and its
                forward and backward timed beside the whole sequence's.
                One `[sequence]` JSON line;
  7k. pipelined — over an NCCL group of one (as 7i): (a) gpt_small bf16
                B=16 T=512 (flash, dropout 0.1, AdamW, f32 masters)
                through SPMDTrainer(pipeline=lm_pipeline(model)) as
                par_gpt builds it, at 64 KiB and at the default 32 MiB
                buckets: the first step eager, the capture, 10 timed
                replays and one profiled; every loss bitwise par_gpt's
                replicated run, one capture, the causal flash launches
                (12 a replay), and on the profiled replay's kernel
                timeline the buckets' NCCL kernels in plan order after
                the step's marks of the backward segments they wait for
                (pipelined.structure_report), interleaved with those
                segments at 64 KiB; ms a step and the busy share beside
                par_gpt's replicated ms; then step_microbatches (k = 4)
                and remat_plan=["dots"] * 12, each bitwise the plain
                step of the same build, one capture each; (b) bert_base
                bf16 B=32 T=512 ragged lengths, LAMB with f32 masters,
                through pretraining_pipeline: 10 replays, every loss
                bitwise the plain step of the same build, which is held
                bitwise to a second run of itself, 12 launches of each
                flash kernel a replay; two runs with a fault planted in
                the step (the deepest block's gradients zeroed, the
                plan's first bucket zeroed) must fail that gate; (c) GPipe over 4 virtual stages
                (pipeline.gpipe_ticks with the list rotation, the loop
                pipeline_apply runs), each a gpt_small block (causal
                flash, bf16), M = 8 microbatches of B = 2, T = 512:
                output and every gradient against the blocks applied in
                sequence at phase 4's bf16 tolerances, the worst |err| /
                tolerance printed, 44 launches of each kernel (4 stages x
                11 ticks); (d) switch_moe at Switch-Base-8's widths (D =
                768, d_ff = 3072, E = 8, capacity factor 1.25, 16 x 512
                tokens, bf16 expert FFNs) against direct per-token
                routing in f32 and the same call on the CPU (max |err|
                within 2e-2 of the largest |output|), the dropped tokens,
                ms forward and backward; (e) kernel_policy.training_plan
                for bert_base and bert_large at T=512 and one captured
                pipelined step of each at the plan's batch and remat
                mode: peak memory against HBM_USABLE. The pipelined
                launches join the kernels line. One `[pipelined]` JSON
                line;
  8. times    — the flash kernels held against their plain versions
                once more on the training batch's own shapes and lengths
                (B=32, T=512, bf16), and causal at gpt_small's (B=16,
                T=512, every length 512; the `_causal` rows of the
                kernels line, with their launches from 7d); each kernel's device time (CUDA events around it, the
                host held ahead by a sleep kernel, cold L2, median), its
                plain version's, a library call's (on the gathered, and
                dequantized, window for the ragged kernels; the same
                boolean mask, forward or backward, for the flash ones),
                and the bound from bytes / operations; each decode and
                prefill case with its split plan; the port's whole flash
                backward as autograd runs it beside the library's whole
                backward, and the eager Δ (attn_delta) for the record.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989.4e12}

DEC = dict(S=8, H=12, D=64, ps=16, maxp=64,
           lengths=[0, 1, 17, 100, 255, 512, 777, 1024])
PRE = dict(C=64, H=12, D=64, ps=16, maxp=64,          # (start, n_real)
           cases=[(0, 64), (64, 64), (200, 37), (960, 64)])
VER = dict(S=8, W=5, H=12, D=64, ps=16, maxp=64,
           lengths=[0, 1, 17, 100, 255, 512, 777, 1019],
           draft_len=[0, 4, 1, 3, 4, 0, 2, 4])
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-2)}   # atol, rtol
QUANTS = ("int8", "fp8_e4m3")
RA = "incubator_mxnet_tpu/ops/ragged_attention.py"
REPLACES = {                 # the TPU kernel: function that reaches the
    "ragged_decode": f"{RA}:75",            # pallas_call (file:line)
    "ragged_decode_q": f"{RA}:199",
    "ragged_prefill": f"{RA}:348",
    "ragged_prefill_q": f"{RA}:471",
    "ragged_verify": f"{RA}:586",
    "ragged_verify_q": f"{RA}:734",
}
PA = "incubator_mxnet_tpu/ops/pallas_attention.py"
REPLACES.update({            # each flash kernel serves both Pallas arms
    "flash_fwd": f"{PA}:115 (_flash_kernel); {PA}:305 (_dense_fwd_kernel)",
    "flash_bwd_dq": f"{PA}:465 (_flash_bwd_dq_kernel); {PA}:334 "
                    f"(_dense_bwd_kernel, dq)",
    "flash_bwd_dkv": f"{PA}:501 (_flash_bwd_dkv_kernel); {PA}:334 "
                     f"(_dense_bwd_kernel, dk and dv)",
})
KERNELS = tuple(REPLACES)
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
FLASH_CASES = [          # (B, H, Tq, Tk, D, lengths, causal)
    (4, 12, 512, 512, 64, [0, 1, 200, 512], False),
    (2, 12, 2048, 2048, 64, [2048, 1500], True),
    (2, 12, 2048, 2048, 64, [2048, 1500], False),
    (2, 12, 384, 512, 128, [512, 300], False),
    # the tensor-core bodies (bf16, D=64) at tile-straddling lengths
    (2, 12, 200, 200, 64, [200, 150], True),
    (2, 12, 96, 160, 64, [160, 33], False),
    # ... and below one 64-row tile (TMA boxes larger than the tensor)
    *[(3, 12, T, T, 64, [T, (T + 1) // 2, 0], causal)
      for T in (1, 16, 37) for causal in (False, True)],
    (3, 12, 40, 24, 64, [24, 9, 0], False),
    (3, 12, 24, 40, 64, [40, 23, 0], False),
]
# bf16 D=64 causal cases (the tensor-core bodies) whose tile count and
# B x H are awkward for the heaviest-first work order (flash_common.cuh
# `flash_unit`) and the forward's diagonal by warp: 9 tiles with an odd
# B x H, one tile and a row, a row short of 8 tiles, and 32 tiles
FLASH_CAUSAL_BF16 = [
    (3, 5, 576, 576, 64, [576, 300, 1], True),
    (1, 12, 65, 65, 64, [65], True),
    (2, 12, 511, 511, 64, [511, 64], True),
    (4, 12, 2048, 2048, 64, [2048] * 4, True),
]
# out and lse: |err| <= atol + rtol |plain|; gradients: |err| <= frac x
# the largest |plain gradient| of the same (batch, head) slice, that
# largest value taken as at least `floor` (a slice whose true gradient
# is ~0, e.g. length 1, holds only summation noise)
FLASH_TOL = {                # atol, rtol, frac, floor
    "float32": (2e-5, 2e-5, 2e-5, 1.0),
    "bfloat16": (1e-2, 1e-2, 2e-2, 1e-2),
}
# Δ = rowsum(dO ⊙ O) from the dq launch against attn_delta: |err| <=
# DELTA_ULPS x D x 2^-24 x sum |dO ⊙ O| (two f32 summations of D terms)
DELTA_ULPS = 2
BERT = dict(B=32, T=512, M=76, steps=10, warmup=3)
GPT = dict(B=16, T=512, steps=10, warmup=3)
NMT = dict(B=16, Ts=64, Tgen=48, K=4, reps=3)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------- #

def make_pools(torch, gen, P, H, ps, D, dtype, quant):
    """(k_pool, v_pool, k_scale, v_scale): raw pools of ``dtype``, or
    int8 / fp8_e4m3 code pools with per-page scales in [0.005, 0.025)."""
    shape, dev = (P, H, ps, D), "cuda"
    if quant is None:
        mk = lambda: torch.randn(shape, generator=gen, device=dev).to(dtype)
        return mk(), mk(), None, None
    if quant == "int8":
        mk = lambda: torch.randint(-127, 128, shape, generator=gen,
                                   device=dev).to(torch.int8)
    else:
        mk = lambda: (torch.randn(shape, generator=gen, device=dev) *
                      64).clamp(-448, 448).to(torch.float8_e4m3fn)
    sc = lambda: torch.rand(P, generator=gen, device=dev) * 0.02 + 0.005
    return mk(), mk(), sc(), sc()


def slot_table(torch, gen, n_map, P, maxp):
    """A page table mapping n_map[s] distinct shuffled pages per slot."""
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    pt = torch.zeros(len(n_map), maxp, dtype=torch.int32, device="cuda")
    used = 0
    for s, n in enumerate(n_map):
        pt[s, :n] = perm[used:used + n].int()
        used += n
    return pt


def decode_case(torch, gen, dtype, quant=None, extra=0):
    """Decode inputs at DEC's lengths; ``extra`` maps pages for that many
    positions past each live slot's length (wholly masked pages)."""
    S, H, D, ps, maxp = (DEC[k] for k in ("S", "H", "D", "ps", "maxp"))
    n_map = [min(maxp, -(-(L + extra) // ps)) if L else 0
             for L in DEC["lengths"]]
    P = 1 + sum(n_map) + 3
    q = torch.randn(S, H, D, generator=gen, device="cuda").to(dtype)
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, dtype, quant)
    pt = slot_table(torch, gen, n_map, P, maxp)
    ln = torch.tensor(DEC["lengths"], dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, ln, ks, vs


def prefill_case(torch, gen, dtype, start, n_real, quant=None):
    """Prefill inputs and the chunk's span [start, n_real] on the card
    (what the kernel reads)."""
    C, H, D, ps, maxp = (PRE[k] for k in ("C", "H", "D", "ps", "maxp"))
    n_live = -(-(start + C) // ps)
    P = 1 + maxp + 3
    q = torch.randn(C, H, D, generator=gen, device="cuda").to(dtype)
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, dtype, quant)
    row = slot_table(torch, gen, [n_live], P, maxp)[0]
    span = torch.tensor([start, n_real], dtype=torch.int32, device="cuda")
    return q, kp, vp, row, ks, vs, span


def verify_case(torch, gen, dtype, quant=None):
    """Verify inputs: each live slot maps the pages of its whole window
    (length + W - 1 positions)."""
    S, W, H, D, ps, maxp = (VER[k] for k in ("S", "W", "H", "D", "ps",
                                             "maxp"))
    n_map = [-(-(L + W - 1) // ps) if L else 0 for L in VER["lengths"]]
    P = 1 + sum(n_map) + 3
    q = torch.randn(S, W, H, D, generator=gen, device="cuda").to(dtype)
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, dtype, quant)
    pt = slot_table(torch, gen, n_map, P, maxp)
    ln = torch.tensor(VER["lengths"], dtype=torch.int32, device="cuda")
    dl = torch.tensor(VER["draft_len"], dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, ln, dl, ks, vs


def consumed_rows(torch):
    """(S, W) mask of the verify rows a caller consumes (r <= draft_len);
    later rows are garbage by contract."""
    W = VER["W"]
    dl = torch.tensor(VER["draft_len"], device="cuda")
    return torch.arange(W, device="cuda")[None, :] <= dl[:, None]


# the verify tensor-core body's shapes: W, and (maxp, ps) capacities of
# 1024 and 2048 keys
VER_TC = dict(H=12, W=(1, 2, 5, 16, 17), caps=((64, 16), (128, 16)))


def verify_tc_case(torch, gen, W, maxp, ps, quant):
    """bf16 verify inputs at VER_TC's head count: lengths 0, 1, around a
    page and a split, deep and at the capacity; draft_len cycling through
    0 .. W - 1; each live slot maps its whole window (at most the row)."""
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    H, D, cap = VER_TC["H"], 64, maxp * ps
    split = ra.verify_plan(1, W, H, D, ps, maxp, True).split_keys
    lengths = [0, 1, ps - 1, ps, ps + 1, split - 1, split, split + 1,
               cap // 2 + 5, cap - W, cap]
    S = len(lengths)
    n_map = [min(maxp, -(-(L + W - 1) // ps)) if L else 0 for L in lengths]
    P = 1 + sum(n_map) + 2
    q = torch.randn(S, W, H, D, generator=gen, device="cuda").bfloat16()
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, torch.bfloat16,
                                quant)
    pt = slot_table(torch, gen, n_map, P, maxp)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    dl = torch.tensor([i % W for i in range(S)], dtype=torch.int32,
                      device="cuda")
    return q, kp, vp, pt, ln, dl, ks, vs


def poisoned(torch, pool, cells):
    """A copy of ``pool`` with each (page, position) of ``cells`` made
    non-finite (NaN; the e4m3 NaN code; -128 in an int8 pool, a code the
    writers never emit), written through a byte view."""
    out = pool.view(torch.uint8).clone().view(pool.dtype)
    for pg, pos in cells:
        if pool.dtype in (torch.float32, torch.bfloat16):
            out[pg, :, pos] = float("nan")
        else:
            out.view(torch.uint8)[pg, :, pos] = \
                0x7F if pool.dtype == torch.float8_e4m3fn else 0x80
    return out


def permutation(torch, gen, P, table):
    """A random relabelling of pages 1 .. P - 1 (the null page 0 stays)
    and the page table under it."""
    remap = torch.zeros(P, dtype=torch.long, device="cuda")
    remap[1:] = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    t = table.clone()
    live = table > 0
    t[live] = remap[table[live].long()].int()
    return remap, t


def moved(torch, x, remap):
    """Page p of ``x`` (a pool or a per-page scale) moved to remap[p]."""
    if x is None:
        return None
    b = x.view(torch.uint8).reshape(x.shape[0], -1)
    out = b.clone()
    out[remap[1:]] = b[1:]
    return out.view(x.dtype).reshape(x.shape)


def verify_contract(torch, ra, gen, dt, quant, sc, rows, nan_scale):
    """The verify contract at VER's shapes on one body and pool."""
    q, kp, vp, pt, ln, dl, ks, vs = verify_case(torch, gen, dt, quant)
    ps, S = VER["ps"], VER["S"]
    tag = f"verify {str(dt).removeprefix('torch.')} {quant or 'raw'}"
    run = lambda kp_, vp_, pt_=pt, ln_=ln, ks_=ks, vs_=vs: \
        ra._ragged_verify_cuda(q, kp_, vp_, pt_, ln_, dl, sc, ks_, vs_)
    clean = run(kp, vp)
    check(bool(torch.equal(clean, run(kp, vp))),
          f"{tag}: two launches differ")
    past = [(int(pt[s, pos // ps]), pos % ps)
            for s, (L, d) in enumerate(zip(VER["lengths"], VER["draft_len"]))
            if L for pos in range(L + d, int((pt[s] > 0).sum()) * ps)]
    past += [(0, pos) for pos in range(ps)]               # the null page
    got = run(poisoned(torch, kp, past), poisoned(torch, vp, past))
    check(bool(torch.isfinite(got[rows].float()).all()) and
          bool(torch.equal(got, clean)),
          f"{tag}: NaN past length + draft_len reached the output")
    others = [i for i in range(S) if i != 5]
    if quant != "int8":                   # an int8 code cannot be NaN
        got = run(kp, poisoned(torch, vp, [(int(pt[5, 0]), 0)]))
        check(bool(torch.isnan(got[5][rows[5]].float()).all()),
              f"{tag}: NaN inside the length did not propagate")
        check(bool(torch.equal(got[others], clean[others])),
              f"{tag}: NaN in one slot changed another")
    z = run(kp, vp, ln_=torch.zeros_like(ln))
    check(bool((z == 0).all()), f"{tag}: length-0 slots not exactly zero")
    remap, perm_pt = permutation(torch, gen, kp.shape[0], pt)
    got = run(moved(torch, kp, remap), moved(torch, vp, remap), perm_pt,
              ks_=moved(torch, ks, remap), vs_=moved(torch, vs, remap))
    check(bool(torch.equal(got, clean)),
          f"{tag}: page permutation changed the output")
    if quant is None:
        return
    s5 = VER["lengths"].index(512)        # slot 5: length 512, no draft
    masked = int(pt[s5, 512 // ps])       # a mapped page wholly past it
    got = run(kp, vp, ks_=nan_scale(nan_scale(ks, 0), masked),
              vs_=nan_scale(nan_scale(vs, 0), masked))
    check(bool(torch.equal(got, clean)),
          f"{tag}: NaN scale on a masked page leaked")
    others = [i for i in range(S) if i != 3]
    for bad_k in (True, False):
        got = run(kp, vp,
                  ks_=nan_scale(ks, int(pt[3, 0])) if bad_k else ks,
                  vs_=vs if bad_k else nan_scale(vs, int(pt[3, 0])))
        check(bool(torch.isnan(got[3][rows[3]].float()).all()) and
              bool(torch.equal(got[others], clean[others])),
              f"{tag}: NaN {'k' if bad_k else 'v'} scale on a live page "
              f"did not stay in its slot")


# the decode tensor-core body's shapes: (maxp, ps) capacities of 1, 4 and
# 64 pages, and lengths around a page and a 64-key tile
DEC_TC = dict(H=12, caps=((1, 16), (4, 16), (64, 16)),
              lengths=(0, 1, 15, 16, 17, 63, 64, 65))


def decode_tc_case(torch, gen, maxp, ps, quant):
    """bf16 decode inputs at DEC_TC's head count: its lengths (at most the
    capacity) and the capacity itself, each live slot mapping its pages."""
    H, D, cap = DEC_TC["H"], 64, maxp * ps
    lengths = [min(L, cap) for L in DEC_TC["lengths"]] + [cap]
    n_map = [-(-L // ps) for L in lengths]
    P = 1 + sum(n_map) + 2
    q = torch.randn(len(lengths), H, D, generator=gen,
                    device="cuda").bfloat16()
    kp, vp, ks, vs = make_pools(torch, gen, P, H, ps, D, torch.bfloat16,
                                quant)
    pt = slot_table(torch, gen, n_map, P, maxp)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, ln, ks, vs


def decode_contract(torch, ra, gen, dt, quant, sc, nan_scale):
    """The decode contract at DEC's shapes on one body and pool, each live
    slot mapping one page past its length (a wholly masked page)."""
    ps, S = DEC["ps"], DEC["S"]
    q, kp, vp, pt, ln, ks, vs = decode_case(torch, gen, dt, quant, extra=ps)
    tag = f"decode {str(dt).removeprefix('torch.')} {quant or 'raw'}"
    run = lambda kp_, vp_, pt_=pt, ln_=ln, ks_=ks, vs_=vs: \
        ra._ragged_decode_cuda(q, kp_, vp_, pt_, ln_, sc, ks_, vs_)
    clean = run(kp, vp)
    check(bool(torch.equal(clean, run(kp, vp))),
          f"{tag}: two launches differ")
    past = [(int(pt[s, pos // ps]), pos % ps)
            for s, L in enumerate(DEC["lengths"])
            if L for pos in range(L, int((pt[s] > 0).sum()) * ps)]
    past += [(0, pos) for pos in range(ps)]               # the null page
    got = run(poisoned(torch, kp, past), poisoned(torch, vp, past))
    check(bool(torch.isfinite(got.float()).all()) and
          bool(torch.equal(got, clean)),
          f"{tag}: NaN past the length (or in the null page) leaked")
    others = [i for i in range(S) if i != 5]
    if quant != "int8":                   # an int8 code cannot be NaN
        got = run(kp, poisoned(torch, vp, [(int(pt[5, 0]), 0)]))
        check(bool(torch.isnan(got[5].float()).all()),
              f"{tag}: NaN inside the length did not propagate")
        check(bool(torch.equal(got[others], clean[others])),
              f"{tag}: NaN in one slot changed another")
    z = run(kp, vp, ln_=torch.zeros_like(ln))
    check(bool((z == 0).all()), f"{tag}: length-0 slots not exactly zero")
    remap, perm_pt = permutation(torch, gen, kp.shape[0], pt)
    got = run(moved(torch, kp, remap), moved(torch, vp, remap), perm_pt,
              ks_=moved(torch, ks, remap), vs_=moved(torch, vs, remap))
    check(bool(torch.equal(got, clean)),
          f"{tag}: page permutation changed the output")
    if quant is None:
        return
    s5 = DEC["lengths"].index(512)        # slot 5: its page 32 is wholly
    masked = int(pt[s5, 512 // ps])       # past its length
    got = run(kp, vp, ks_=nan_scale(nan_scale(ks, 0), masked),
              vs_=nan_scale(nan_scale(vs, 0), masked))
    check(bool(torch.equal(got, clean)),
          f"{tag}: NaN scale on a masked page leaked")
    others = [i for i in range(S) if i != 3]
    for bad_k in (True, False):
        got = run(kp, vp,
                  ks_=nan_scale(ks, int(pt[3, 0])) if bad_k else ks,
                  vs_=vs if bad_k else nan_scale(vs, int(pt[3, 0])))
        check(bool(torch.isnan(got[3].float()).all()) and
              bool(torch.equal(got[others], clean[others])),
              f"{tag}: NaN {'k' if bad_k else 'v'} scale on a live page "
              f"did not stay in its slot")


def decode_one_kernel(torch, ra, gen, sc, n=4):
    """torch.profiler over ``n`` bf16 decode calls on each pool at DEC's
    shapes: one device kernel a call, the tensor-core body (no combine
    launch, no scratch fill). The tracer can miss kernels at the start of
    a process's first sessions, so a throwaway session runs first, and a
    session that recorded fewer than ``n`` kernels is taken again (at
    most 3 times): a call launches at least one kernel or raises, so
    fewer than ``n`` is a lost record, while more fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(fn):
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            if len(names) >= n:
                break
        return names

    one = torch.zeros(1, device="cuda")
    kernels(lambda: one.add_(1))
    for quant in (None,) + QUANTS:
        q, kp, vp, pt, ln, ks, vs = decode_case(torch, gen, torch.bfloat16,
                                                quant)
        fn = lambda: ra._ragged_decode_cuda(q, kp, vp, pt, ln, sc, ks, vs)
        fn()
        torch.cuda.synchronize()
        names = kernels(fn)
        print(f"[kernels] {n} bf16 decode calls, pools {quant or 'raw'}: "
              f"{len(names)} device kernel(s) "
              f"{sorted({x[:40] for x in names})}", flush=True)
        check(len(names) == n and all("decode_mma" in x for x in names),
              f"{n} bf16 decode calls ran {len(names)} device kernels "
              f"({sorted(set(names))}), not one tensor-core launch each")


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_bytes_flops(lengths, H, D, kv_elem, q_elem, ps, quant):
    live = sum(lengths)
    S = len(lengths)
    nbytes = 2 * live * H * D * kv_elem + 2 * S * H * D * q_elem + \
        S * DEC["maxp"] * 4 + S * 4
    if quant:                            # one K and one V scale per page
        nbytes += 2 * 4 * sum(-(-L // ps) for L in lengths)
    return nbytes, 4 * live * H * D


def prefill_bytes_flops(start, n_real, C, H, D, kv_elem, q_elem, ps,
                        quant):
    keys = start + n_real
    nbytes = 2 * keys * H * D * kv_elem + 2 * C * H * D * q_elem + \
        PRE["maxp"] * 4
    if quant:
        nbytes += 2 * 4 * -(-keys // ps)
    flops = sum(4 * (start + i + 1) * D * H for i in range(n_real))
    return nbytes, flops


def verify_bytes_flops(H, D, kv_elem, q_elem, ps, quant):
    """Live K/V = the keys the consumed rows see (length + draft_len per
    slot); operations of the consumed rows only."""
    S, W = VER["S"], VER["W"]
    keys = [L + d if L else 0
            for L, d in zip(VER["lengths"], VER["draft_len"])]
    nbytes = 2 * sum(keys) * H * D * kv_elem + 2 * S * W * H * D * q_elem + \
        S * VER["maxp"] * 4 + 2 * S * 4
    if quant:
        nbytes += 2 * 4 * sum(-(-k // ps) for k in keys)
    flops = sum(4 * (L + r) * H * D
                for L, d in zip(VER["lengths"], VER["draft_len"]) if L
                for r in range(d + 1))
    return nbytes, flops


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #

def phase_device(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(line, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


def phase_build():
    from incubator_mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    for name, (t, log) in built.items():
        info = sorted({ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln})
        print(f"[build] {name}: {t:.1f} s  " + " | ".join(info[:6]),
              flush=True)
    print(f"[build] all kernels in {secs:.1f} s "
          f"({_build.build_dir()})", flush=True)
    spills = {}
    for name in ("ragged_decode", "ragged_prefill", "ragged_verify",
                 "flash_fwd", "flash_bwd"):
        log = _build.build_dir() / f"{name}.log"
        if log.is_file():
            for fn, regs, spill in ptxas_entries(log.read_text()):
                print(f"[build] {name} {fn}: {regs}; {spill}", flush=True)
                spills[fn] = spill
        sass_counts(_build.build_dir() / f"lib{name}.so")
    for fn, spill in spills.items():
        if "flash_fwd_tma" in fn:
            check(re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                            spill) is not None,
                  f"{fn} spills registers ({spill})")


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        got = out.stdout.splitlines()
        if out.returncode == 0 and len(got) == len(names):
            return [g.split("(")[0] for g in got]
    except (OSError, subprocess.SubprocessError):
        pass
    return list(names)


def ptxas_entries(log):
    """(kernel, 'Used ... registers, ... smem', 'spill stores / loads')
    for every entry function of one nvcc -Xptxas -v log."""
    rows, fn, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn, spill = m.group(1), ""
        elif fn and "spill" in ln:
            spill = ln.strip()
        elif fn and "Used" in ln and "registers" in ln:
            rows.append((fn, ln.split(":", 1)[-1].strip(), spill))
            fn = None
    names = _demangle([r[0] for r in rows])
    return [(n, r[1], r[2]) for n, r in zip(names, rows)]


# the tensor-core bodies each kernel library must hold (SASS checks)
TC_BODIES = {"ragged_decode": ("decode_mma",),
             "ragged_prefill": ("prefill_mma",),
             "ragged_verify": ("verify_mma",),
             "flash_fwd": ("flash_fwd_tma",),
             "flash_bwd": ("flash_bwd_dq_tma", "flash_bwd_dkv_tma")}


def sass_counts(lib):
    """Tensor-core (HMMA), ldmatrix (LDSM), cp.async (LDGSTS), TMA load
    (UTMALDG) and 2-byte shared-store (STS.U16) instructions in each
    ragged and flash kernel's SASS, from cuobjdump. The ragged
    tensor-core bodies (decode_mma, prefill_mma, verify_mma) must issue
    HMMA, LDSM and LDGSTS; each flash TMA body (forward, dq, dk/dv) HMMA,
    LDSM and UTMALDG, and no STS.U16 (no transposed copy, stored 2 bytes
    at a time)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        print("[build] cuobjdump not found: SASS not inspected", flush=True)
        return
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300).stdout
    funcs, cur = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            funcs[cur] = {"HMMA": 0, "LDSM": 0, "LDGSTS": 0, "UTMALDG": 0,
                          "STS.U16": 0}
        elif cur:
            for op in funcs[cur]:
                if re.search(rf"\b{re.escape(op)}\b", ln):
                    funcs[cur][op] += 1
    lib_name = re.sub(r"^lib|\.so$", "", os.path.basename(str(lib)))
    seen = set()
    for name, c in zip(_demangle(list(funcs)), funcs.values()):
        print(f"[build] sass {name}: " + ", ".join(
            f"{op} x{n}" for op, n in c.items()), flush=True)
        for body in TC_BODIES.get(lib_name, ()):
            if body not in name:
                continue
            seen.add(body)
            check(c["HMMA"] > 0 and c["LDSM"] > 0,
                  f"{name}: a tensor-core body must issue HMMA and LDSM "
                  f"({c})")
            if body.startswith("flash"):
                check(c["UTMALDG"] > 0, f"{name}: no TMA load ({c})")
                check(c["STS.U16"] == 0, f"{name} stores 2-byte elements "
                                         f"to shared memory (a transposed "
                                         f"copy)")
            else:
                check(c["LDGSTS"] > 0, f"{name}: no cp.async ({c})")
    for body in TC_BODIES.get(lib_name, ()):
        check(body in seen, f"no {body} kernel in the SASS of {lib}")


def phase_kernels(torch):
    """Kernel vs plain version on identical inputs; returns the largest
    |difference| per kernel over every compared case."""
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = {k: 0.0 for k in KERNELS if k not in FLASH}
    rows = consumed_rows(torch)
    nan = float("nan")

    def cmp(name, got, ref, dtype_name, keep=None, what=""):
        torch.cuda.synchronize()
        g, r = got.float(), ref.float()
        if keep is not None:
            g, r = g[keep], r[keep]
        atol, rtol = TOL[dtype_name]
        d = (g - r).abs()
        ok = bool(torch.isfinite(g).all()) and \
            bool((d <= atol + rtol * r.abs()).all())
        e = float(d.max())
        err[name] = max(err[name], e)
        print(f"[kernels] {name} {dtype_name} {what}: max|err| {e:.3e} "
              f"(atol {atol}, rtol {rtol})", flush=True)
        check(ok, f"{name} {dtype_name} {what} disagrees with its plain "
                  f"version (max |err| {e:.3e})")

    sc = DEC["D"] ** -0.5
    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        for quant in (None,) + QUANTS:
            sfx = "_q" if quant else ""
            tag = quant or "raw"
            q, kp, vp, pt, ln, ks, vs = decode_case(torch, gen, dt, quant)
            got = ra._ragged_decode_cuda(q, kp, vp, pt, ln, sc, ks, vs)
            ref = ra.ragged_attention_reference(q, kp, vp, pt, ln, sc, ks,
                                                vs)
            cmp("ragged_decode" + sfx, got, ref, dt_name,
                what=f"{tag} mixed lengths")
            check(bool((got[0] == 0).all()), "decode: length-0 slot not "
                                             "zero")
            for start, n_real in PRE["cases"]:
                q, kp, vp, row, ks, vs, span = prefill_case(
                    torch, gen, dt, start, n_real, quant)
                got = ra._ragged_prefill_cuda(q, kp, vp, row, span, sc, ks,
                                              vs)
                ref = ra.ragged_prefill_reference(q, kp, vp, row, start, sc,
                                                  n_real, ks, vs)
                cmp("ragged_prefill" + sfx, got, ref, dt_name,
                    keep=slice(0, n_real),
                    what=f"{tag} device span start={start} "
                         f"n_real={n_real}")
                check(bool((got[n_real:] == 0).all()),
                      "prefill: rows past n_real not zero")
            q, kp, vp, pt, ln, dl, ks, vs = verify_case(torch, gen, dt,
                                                        quant)
            got = ra._ragged_verify_cuda(q, kp, vp, pt, ln, dl, sc, ks, vs)
            ref = ra.ragged_verify_reference(q, kp, vp, pt, ln, sc, ks, vs)
            cmp("ragged_verify" + sfx, got, ref, dt_name, keep=rows,
                what=f"{tag} W={VER['W']} mixed lengths/drafts")
            check(bool((got[0] == 0).all()), "verify: length-0 slot not "
                                             "zero")

    # a NaN page scale: on a masked page it must not leak, on a live page
    # it must propagate to the slots that read it
    def nan_scale(scale, page):
        bad = scale.clone()
        bad[page] = nan
        return bad

    # decode on both bodies (f32: CUDA cores; bf16 at D=64: tensor cores)
    # and every pool: NaN past the length and in the null page, NaN inside,
    # length 0, page permutation, two launches bitwise equal; on code pools
    # a NaN page scale on a masked and on a live page
    f32 = torch.float32
    ps = DEC["ps"]
    for dt in (f32, torch.bfloat16):
        for quant in (None,) + QUANTS:
            decode_contract(torch, ra, gen, dt, quant, sc, nan_scale)
    # the tensor-core body at lengths around a page and a tile, and at the
    # capacity, for capacities of 1, 4 and 64 pages
    for maxp, ps_ in DEC_TC["caps"]:
        for quant in (None,) + QUANTS:
            q, kp, vp, pt, ln, ks, vs = decode_tc_case(torch, gen, maxp, ps_,
                                                       quant)
            got = ra._ragged_decode_cuda(q, kp, vp, pt, ln, sc, ks, vs)
            ref = ra.ragged_attention_reference(q, kp, vp, pt, ln, sc, ks,
                                                vs)
            cmp("ragged_decode" + ("_q" if quant else ""), got, ref,
                "bfloat16", what=f"{quant or 'raw'} tensor cores capacity "
                                 f"{maxp * ps_} lengths {ln.tolist()}")
            check(bool((got[ln == 0] == 0).all()),
                  "decode: length-0 slot not exactly zero")
    decode_one_kernel(torch, ra, gen, sc)

    # prefill: a partial chunk's unwritten tail holding NaN, and the null
    # page, on both bodies (f32: CUDA cores; bf16 at D=64: tensor cores);
    # two launches bitwise equal
    start, n_real = PRE["cases"][2]
    for dt in (f32, torch.bfloat16):
        q, kp, vp, row, _, _, span = prefill_case(torch, gen, dt, start,
                                                  n_real)
        clean = ra._ragged_prefill_cuda(q, kp, vp, row, span, sc)
        end = start + n_real
        kp2, vp2 = kp.clone(), vp.clone()
        for pos in range(end, start + PRE["C"]):
            pg = int(row[pos // ps])
            kp2[pg, :, pos % ps] = nan
            vp2[pg, :, pos % ps] = nan
        kp2[0], vp2[0] = nan, nan
        got = ra._ragged_prefill_cuda(q, kp2, vp2, row, span, sc)
        check(bool(torch.isfinite(got[:n_real]).all()) and
              bool(torch.equal(got[:n_real], clean[:n_real])),
              f"prefill {dt}: unwritten-tail NaN poisoned live rows")
        check(bool(torch.equal(clean, ra._ragged_prefill_cuda(
            q, kp, vp, row, span, sc))),
            f"prefill {dt}: two launches differ")
        vp3 = vp.clone()
        vp3[int(row[0]), :, 0] = nan                  # seen by every row
        got = ra._ragged_prefill_cuda(q, kp, vp3, row, span, sc)
        check(bool(torch.isnan(got[:n_real].float()).all()),
              f"prefill {dt}: NaN inside the live keys did not propagate")

    start, n_real = PRE["cases"][2]           # live keys end at 237
    for dt in (f32, torch.bfloat16):
        for quant in QUANTS:
            q, kp, vp, row, ks, vs, span = prefill_case(torch, gen, dt,
                                                        start, n_real, quant)
            clean = ra._ragged_prefill_cuda(q, kp, vp, row, span, sc, ks, vs)
            masked = int(row[(start + n_real) // ps + 1])   # past 237
            got = ra._ragged_prefill_cuda(q, kp, vp, row, span, sc,
                                          nan_scale(nan_scale(ks, 0), masked),
                                          nan_scale(nan_scale(vs, 0), masked))
            check(bool(torch.equal(got[:n_real], clean[:n_real])),
                  f"prefill_q {dt} {quant}: NaN scale on a masked page "
                  f"leaked")
            for bad_k in (True, False):
                live = int(row[0])
                got = ra._ragged_prefill_cuda(
                    q, kp, vp, row, span, sc,
                    nan_scale(ks, live) if bad_k else ks,
                    vs if bad_k else nan_scale(vs, live))
                check(bool(torch.isnan(got[:n_real].float()).all()),
                      f"prefill_q {dt} {quant}: NaN "
                      f"{'k' if bad_k else 'v'} scale on a live page did "
                      f"not propagate")

    # verify on both bodies (f32: CUDA cores; bf16 at D=64: tensor cores)
    # and every pool: NaN past length + draft_len and in the null page, NaN
    # inside, length 0, page permutation, two launches bitwise equal; on
    # code pools a NaN page scale on a masked and on a live page
    for dt in (f32, torch.bfloat16):
        for quant in (None,) + QUANTS:
            verify_contract(torch, ra, gen, dt, quant, sc, rows, nan_scale)
    # the tensor-core body across its shapes: W = 1 .. 17, capacities of
    # 1024 and 2048 keys (16 splits of 64 or of 128)
    for maxp, ps_ in VER_TC["caps"]:
        for W in VER_TC["W"]:
            for quant in (None,) + QUANTS:
                q, kp, vp, pt, ln, dl, ks, vs = verify_tc_case(
                    torch, gen, W, maxp, ps_, quant)
                got = ra._ragged_verify_cuda(q, kp, vp, pt, ln, dl, sc, ks,
                                             vs)
                ref = ra.ragged_verify_reference(q, kp, vp, pt, ln, sc, ks,
                                                 vs)
                keep = torch.arange(W, device="cuda")[None, :] <= \
                    dl.long()[:, None]
                cmp("ragged_verify" + ("_q" if quant else ""), got, ref,
                    "bfloat16", keep=keep,
                    what=f"{quant or 'raw'} tensor cores W={W} capacity "
                         f"{maxp * ps_} (ps={ps_})")
                check(bool((got[~keep] == 0).all()),
                      f"verify W={W}: rows past draft_len not zero")
    torch.cuda.synchronize()
    print("[kernels] contract cases: NaN past length / start + n_real / "
          "length + draft_len, NaN inside, length 0, page permutation, "
          "NaN scale on a masked and on a live page, bitwise reruns "
          "(verify: both bodies, every pool): ok", flush=True)
    return err


def _time_ms(torch, fn, flush, iters=30):
    """Median device time of ``fn`` (ms) with a cold L2. A sleep kernel
    holds the stream while the host enqueues the events and ``fn``, so
    the events bracket device work, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()                    # cold L2, as a real step sees
        torch.cuda._sleep(2_000_000)     # ~1 ms: the host runs ahead
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def phase_times(torch):
    """Times at the serving path's shapes and dtype (bf16 queries; int8
    code pools for the _q kernels, fp8_e4m3 printed beside them)."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    dt, dt_name = torch.bfloat16, "bfloat16"
    H, D, ps, maxp = DEC["H"], DEC["D"], DEC["ps"], DEC["maxp"]
    sc = D ** -0.5
    K = maxp * ps
    ar = torch.arange(K, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}

    def window(pool, table, scale):
        return ra._gather_window(pool, table, scale).to(dt)

    def record(name, shape, ms, plain_ms, library_ms, nbytes, flops):
        bms, by = bound(nbytes, flops, dt_name)
        r = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=bms, bound_by=by, shape=shape)
        print(f"[times] {name} {shape}: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"library {library_ms:.4f}, bound {bms:.5f} by {by})",
              flush=True)
        return r

    for quant in (None,) + QUANTS:
        sfx, kv_elem = ("_q", 1) if quant else ("", 2)
        tag = quant or "bf16"
        q, kp, vp, pt, ln, ks, vs = decode_case(torch, gen, dt, quant)
        kw, vw = window(kp, pt, ks), window(vp, pt, vs)
        mask = (ar[None, :] < ln.long()[:, None])[:, None, None, :]
        plan = ra.decode_plan(DEC["S"], H, D, ps, maxp, True, sms)
        r = record(
            "ragged_decode" + sfx,
            f"S={DEC['S']} H={H} D={D} ps={ps} maxp={maxp} "
            f"lengths={DEC['lengths']} q bf16, pools {tag}; plan "
            f"{plan.nsplit} x {plan.split_keys} keys, {plan.blocks} blocks",
            _time_ms(torch, lambda: ra._ragged_decode_cuda(
                q, kp, vp, pt, ln, sc, ks, vs), flush),
            _time_ms(torch, lambda: ra.ragged_attention_reference(
                q, kp, vp, pt, ln, sc, ks, vs), flush),
            _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], kw, vw, attn_mask=mask), flush),
            *decode_bytes_flops(DEC["lengths"], H, D, kv_elem, 2, ps,
                                quant))
        out.setdefault("ragged_decode" + sfx, r)

        C = PRE["C"]
        rows = []
        for start, n_real in PRE["cases"]:
            q, kp, vp, row, ks, vs, span = prefill_case(torch, gen, dt,
                                                        start, n_real, quant)
            kw = window(kp, row[None], ks)[0]            # (H, K, D)
            vw = window(vp, row[None], vs)[0]
            pos_q = start + torch.arange(C, device="cuda")[:, None]
            mask = ar[None, :] <= pos_q
            plan = ra.prefill_plan(C, H, D, ps, row.shape[0], True, sms)
            rows.append(record(
                "ragged_prefill" + sfx,
                f"C={C} H={H} D={D} ps={ps} start={start} n_real={n_real} "
                f"(device span) q bf16, pools {tag}; plan {plan.nsplit} x "
                f"{plan.split_keys} keys, {plan.blocks} blocks, scratch "
                f"{4 * plan.scratch_floats} B",
                _time_ms(torch, lambda: ra._ragged_prefill_cuda(
                    q, kp, vp, row, span, sc, ks, vs), flush),
                _time_ms(torch, lambda: ra.ragged_prefill_reference(
                    q, kp, vp, row, span, sc, None, ks, vs), flush),
                _time_ms(torch, lambda: F.scaled_dot_product_attention(
                    q.transpose(0, 1)[None], kw[None], vw[None],
                    attn_mask=mask), flush),
                *prefill_bytes_flops(start, n_real, C, H, D, kv_elem, 2, ps,
                                     quant)))
        out.setdefault("ragged_prefill" + sfx, rows[-1])  # deepest chunk
        for (start, _), r in ((PRE["cases"][0], rows[0]),
                              (PRE["cases"][-1], rows[-1])):
            print(f"[times] ragged_prefill{sfx} {tag} at start {start}: "
                  f"kernel {r['ms']:.4f} ms vs library "
                  f"{r['library_ms']:.4f} ms "
                  f"({r['library_ms'] / r['ms']:.2f}x)", flush=True)

        q, kp, vp, pt, ln, dl, ks, vs = verify_case(torch, gen, dt, quant)
        kw, vw = window(kp, pt, ks), window(vp, pt, vs)
        W = VER["W"]
        see = ln.long()[:, None] + torch.arange(W, device="cuda")[None, :]
        mask = (ar[None, None, :] < see[:, :, None])[:, None]   # S,1,W,K
        r = record(
            "ragged_verify" + sfx,
            f"S={VER['S']} W={W} H={H} D={D} ps={ps} maxp={maxp} "
            f"lengths={VER['lengths']} draft_len={VER['draft_len']} "
            f"q bf16, pools {tag}",
            _time_ms(torch, lambda: ra._ragged_verify_cuda(
                q, kp, vp, pt, ln, dl, sc, ks, vs), flush),
            _time_ms(torch, lambda: ra.ragged_verify_reference(
                q, kp, vp, pt, ln, sc, ks, vs), flush),
            _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kw, vw, attn_mask=mask), flush),
            *verify_bytes_flops(H, D, kv_elem, 2, ps, quant))
        out.setdefault("ragged_verify" + sfx, r)
    del flush
    return out


def _prompts(np, rng, vocab):
    """16 prompts of 64-768 tokens; 8 share a 512-token prefix. One
    shared-prefix request leads the first wave so the second wave's
    shared requests find the prefix cached."""
    prefix = rng.randint(0, vocab, size=512).astype(np.int32)
    shared = [np.concatenate([prefix, rng.randint(
        0, vocab, size=int(n)).astype(np.int32)])
        for n in rng.randint(16, 257, size=8)]
    other = [rng.randint(0, vocab, size=int(n)).astype(np.int32)
             for n in rng.randint(64, 769, size=8)]
    return [shared[0]] + other[:7] + shared[1:] + other[7:]


def replay_drafter(np, streams):
    """A drafter that proposes what an earlier run emitted after the same
    history (its prompt plus the tokens so far), and nothing once the
    history has left that run's stream: a controlled, high accept rate
    for the greedy requests (the ceiling of speculation's gain)."""
    table = [(np.asarray(p, np.int32), np.asarray(t, np.int32))
             for p, t in streams]

    def draft(history, k):
        h = np.asarray(history, np.int32)
        for prompt, toks in table:
            t0 = prompt.size
            e = h.size - t0
            if 0 <= e < toks.size and np.array_equal(h[:t0], prompt) and \
                    np.array_equal(h[t0:], toks[:e]):
                return toks[e:e + k]
        return np.zeros((0,), np.int32)

    return draft


def serve_run(torch, np, model, label, spec_k=0, kv_quant=None,
              n_req=16, profile=False, draft_fn=None, need_accept=True,
              decode_bound=False):
    """One serving run on a fresh engine; returns its stats with the
    launch counts read around it, and the requests' (prompt, tokens)
    streams. The phase-4 workload (``_prompts``: long prompts, mixed
    greedy / temperature), or with ``decode_bound`` 8 greedy requests of
    32 prompt and 96 new tokens, where the run is all decode steps."""
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import (InferenceEngine, Outcome,
                                                 Request)
    from incubator_mxnet_tpu_torch.events import EventType

    eng = InferenceEngine(model, num_slots=8, page_size=16, max_len=1024,
                          chunk_pages=4, prefix_cache=True, spec_k=spec_k,
                          kv_quant=kv_quant, draft_fn=draft_fn)
    rng = np.random.RandomState(0)
    # warm-up: one short request (cuBLAS handles, allocator)
    eng.run([Request(rng.randint(0, model.vocab_size, size=40),
                     max_new_tokens=4)])
    check(eng.health[Outcome.MAX_TOKENS.value] == 1, "warm-up failed")
    if decode_bound:
        reqs = [Request(rng.randint(0, model.vocab_size, size=32),
                        max_new_tokens=96) for _ in range(8)]
    else:
        prompts = _prompts(np, rng, model.vocab_size)[:n_req]
        reqs = [Request(p, max_new_tokens=64, eos_id=50256,
                        temperature=0.0 if i % 2 == 0 else 0.8,
                        seed=100 + i)
                for i, p in enumerate(prompts)]
    steps0, spec0, hits0 = eng.decode_steps, eng.spec_steps, eng.prefix_hits
    drafted0, accepted0 = eng.drafted_tokens, eng.accepted_tokens
    n_ev0 = len(eng.flight.events(etype=EventType.DECODE_STEP))
    replays0 = chunk_replays(eng)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    steps = eng.decode_steps - steps0
    spec_steps = eng.spec_steps - spec0
    drafted = eng.drafted_tokens - drafted0
    accepted = eng.accepted_tokens - accepted0

    bad = [(r.request_id, r.outcome, r.detail) for r in reqs
           if r.outcome not in (Outcome.EOS, Outcome.MAX_TOKENS)]
    check(not bad, f"{label}: requests ended badly: {bad}")
    eng.audit_pages()
    check(eng.prefix_hits > hits0 or n_req < 9 or decode_bound,
          f"{label}: no prefix-cache hit")
    chunks = chunk_replays(eng) - replays0
    check_ragged_launches(eng, launches, label, steps, chunks, spec_steps)
    check(chunks > 0, f"{label}: prefill kernel never launched")
    if spec_k:
        check(drafted > 0 and (accepted > 0 or not need_accept),
              f"{label}: drafted {drafted}, accepted {accepted}")
    for r in reqs:
        check(all(0 <= t < model.vocab_size for t in r.token_ids),
              f"{label}: token out of vocab")
    check_captures(eng, label)
    n_tok = sum(len(r.token_ids) for r in reqs)
    ttft = [r.token_stamps[0] - r.submit_time for r in reqs]
    ev = eng.flight.events(etype=EventType.DECODE_STEP)[n_ev0:]
    slot_steps = sum(e.data["live"] for e in ev)
    stats = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                 tokens_per_s=n_tok / wall,
                 ttft_p50_ms=statistics.median(ttft) * 1e3,
                 decode_ms_per_step=statistics.median(
                     e.data["dur_s"] for e in ev) * 1e3,
                 decode_steps=steps, spec_steps=spec_steps,
                 drafted=drafted, accepted=accepted,
                 accept_rate=accepted / drafted if drafted else 0.0,
                 tokens_per_step=(n_tok - len(reqs)) / steps,
                 tokens_per_slot_step=(n_tok - len(reqs)) / slot_steps,
                 prefix_hits=eng.prefix_hits - hits0,
                 kv_pool_bytes=eng.health_snapshot()["kv_pool_bytes"],
                 launches={k: v for k, v in launches.items() if v})
    print(f"[serving] {label}: {json.dumps(stats)}", flush=True)
    if profile:
        profile_decode(torch, np, eng, rng, Request, label)
        if not spec_k:
            profile_prefill(torch, eng, rng, Request, label)
    if not spec_k and not decode_bound:
        host_costs(torch, np, eng, Request)
        chunk_host_costs(torch, np, eng, Request)
    del eng
    torch.cuda.empty_cache()
    return stats, [(r.prompt_ids, r.token_ids) for r in reqs]


def chunk_replays(eng):
    """Replays of the engine's prefill chunk programs so far."""
    return sum(p.replays for (kind, _), p in eng._prefill_programs.items()
               if kind == "chunk")


def check_captures(eng, label):
    """One step program per width that ran (warm-up included) and one
    prefill program per (kind, bucket), each captured once, and at most
    one COW copy program; prints the counts and each capture's ms."""
    counts = captures_once(eng, label)
    progs = [(f"W={w}", p) for w, p in sorted(eng._programs.items())]
    progs += [(f"{k} {t}", p) for (k, t), p in
              sorted(eng._prefill_programs.items())]
    if eng._copy_prog is not None:
        progs.append(("copy", eng._copy_prog))
    print(f"[capture] {label}: decode_trace_count "
          f"{eng.decode_trace_count}, verify_trace_count "
          f"{eng.verify_trace_count}, prefill_trace_count "
          f"{eng.prefill_trace_count}, prefill_trace_counts "
          f"{ {f'{k} {t}': n for (k, t), n in sorted(counts.items())} }, "
          f"copy_trace_count {eng.copy_trace_count}; capture ms: " +
          ", ".join(f"{name} {p.build_ms:.1f}" for name, p in progs),
          flush=True)


def captures_once(eng, label):
    """The checks of ``check_captures``, without the print; returns the
    prefill program counts."""
    for what, ran, built in (
            ("decode", eng.decode_steps > eng.spec_steps,
             eng.decode_trace_count),
            ("verify", eng.spec_steps > 0, eng.verify_trace_count)):
        check(built == int(ran), f"{label}: {what} program built {built} "
                                 f"times (steps ran: {ran})")
    counts = eng.prefill_trace_counts
    check(set(counts.values()) == {1} and
          eng.prefill_trace_count == len(counts) ==
          len(eng._prefill_programs),
          f"{label}: prefill programs built {eng.prefill_trace_count} "
          f"times for {counts}")
    check(eng.copy_trace_count == int(eng._copy_prog is not None),
          f"{label}: COW copy program built {eng.copy_trace_count} times")
    return counts


def serve_monolithic(torch, np, model, label, kv_quant=None):
    """A short monolithic run (chunk_pages=None): 6 prompts of 40-700
    tokens prefilled whole by the dense program of their page bucket
    (4-64 pages), and a 7th repeating the first 250 tokens of the
    300-token one, admitted after it: 15 shared pages, the boundary page
    through the COW copy program, the 1-token suffix through a chunk
    program. Half greedy, half T=0.8, 16 new tokens each."""
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    eng = InferenceEngine(model, num_slots=8, page_size=16, max_len=1024,
                          chunk_pages=None, prefix_cache=True,
                          kv_quant=kv_quant)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, model.vocab_size, size=n).astype(np.int32)
               for n in (40, 100, 200, 300, 520, 700)]
    prompts.append(prompts[3][:250].copy())
    reqs = [Request(p, max_new_tokens=16, eos_id=50256,
                    temperature=0.0 if i % 2 == 0 else 0.8, seed=200 + i)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    eng.audit_pages()
    check(all(r.outcome is not None and r.outcome.ok for r in reqs),
          f"{label}: requests ended badly")
    check(eng.prefix_hits == 1 and eng.copy_trace_count == 1,
          f"{label}: prefix hits {eng.prefix_hits}, copy_trace_count "
          f"{eng.copy_trace_count} (want 1 and 1)")
    want = {("dense", 16 * b) for b in (4, 8, 16, 32, 64)} | {("chunk", 16)}
    check(set(eng.prefill_trace_counts) == want,
          f"{label}: prefill programs {sorted(eng.prefill_trace_counts)} "
          f"!= {sorted(want)}")
    check_captures(eng, label)
    sfx = "_q" if kv_quant else ""
    L = model.num_layers
    check(launches["ragged_prefill" + sfx] == chunk_replays(eng) * L == L,
          f"{label}: ragged_prefill{sfx} launches "
          f"{launches['ragged_prefill' + sfx]} (one chunk replay x {L})")
    n_tok = sum(len(r.token_ids) for r in reqs)
    stats = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                 prefix_hits=eng.prefix_hits,
                 launches={k: v for k, v in launches.items() if v})
    print(f"[serving] {label}: {json.dumps(stats)}", flush=True)
    del eng
    torch.cuda.empty_cache()


def bench_gpt(seed, dtype="bfloat16", **kw):
    """GPT-2 small as bench.py builds it: ``mx.random.seed``,
    ``gpt_small(dtype=, ...)``, ``initialize()`` (on the card)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.models.gpt import gpt_small
    mx.random.seed(seed)
    model = gpt_small(dtype=dtype, **kw)
    model.initialize(ctx=mx.gpu(0))
    return model


def phase_serving(torch):
    import numpy as np
    model = bench_gpt(0)
    runs = {}
    runs["plain"], streams = serve_run(
        torch, np, model, "gpt_small bf16, 8 slots, chunk_pages=4",
        profile=True)
    # the n-gram drafter on random weights: the accept rate it finds
    runs["spec_ngram"], _ = serve_run(
        torch, np, model, "spec_k=4, n-gram drafter, raw bf16 pools",
        spec_k=4, profile=True, need_accept=False)
    # a replay of the plain run's streams: a controlled accept rate
    replay = replay_drafter(np, streams)
    runs["spec"], _ = serve_run(
        torch, np, model, "spec_k=4, replay drafter, raw bf16 pools",
        spec_k=4, draft_fn=replay)
    runs["spec_int8"], _ = serve_run(
        torch, np, model, "spec_k=4, replay drafter, int8 pools", spec_k=4,
        kv_quant="int8", draft_fn=replay)
    runs["spec_fp8"], _ = serve_run(
        torch, np, model, "spec_k=4, replay drafter, fp8_e4m3 pools, 4 "
        "requests", spec_k=4, kv_quant="fp8_e4m3", n_req=4,
        draft_fn=replay)
    # decode-bound pair: does a higher tokens-per-step show in tokens/s?
    runs["decode_plain"], streams = serve_run(
        torch, np, model, "decode-bound, 8 greedy x 96 tokens, plain",
        decode_bound=True)
    runs["decode_spec"], _ = serve_run(
        torch, np, model, "decode-bound, spec_k=4, replay drafter",
        spec_k=4, draft_fn=replay_drafter(np, streams), decode_bound=True)
    for quant in (None, "int8"):
        serve_monolithic(torch, np, model, f"monolithic (chunk_pages=None) "
                         f"with a COW prefix hit, {quant or 'raw bf16'} "
                         f"pools", kv_quant=quant)
    del model
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------------- #
# the serving engine's remaining surface: cache tiers, page transport,
# warm restart, brownout
# --------------------------------------------------------------------- #

def _timed(fn, into):
    """``fn`` with each call's host wall ms appended to ``into``."""
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        into.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def _median(xs):
    return round(statistics.median(xs), 4) if xs else None


def check_ragged_launches(eng, launches, label, steps, chunks,
                          spec_steps=0):
    """Every ragged launch of a run came from a graph replay: decode =
    non-speculative steps x layers, verify = speculative steps x layers,
    prefill = chunk replays x layers, on the engine's pool kind only."""
    L = eng.model.num_layers
    sfx, other = ("_q", "") if eng.kv_quant else ("", "_q")
    want = {"ragged_decode" + sfx: (steps - spec_steps) * L,
            "ragged_verify" + sfx: spec_steps * L,
            "ragged_prefill" + sfx: chunks * L,
            "ragged_decode" + other: 0, "ragged_verify" + other: 0,
            "ragged_prefill" + other: 0}
    for k, n in want.items():
        check(launches[k] == n, f"{label}: {k} launches {launches[k]} != "
                                f"{n} ({steps} steps, {spec_steps} "
                                f"speculative, {chunks} chunk replays, "
                                f"{L} layers)")


def tier_workload(np, vocab):
    """6 prefixes of 512 tokens, each shared by 3 requests with a
    64-token tail of their own and 32 new greedy tokens, round-robin over
    the prefixes: on 4 slots a prefix's pages are evicted from HBM by
    the 5 others before it recurs (with 4 prefixes on 4 slots every
    recurrence still finds its prefix in HBM)."""
    rng = np.random.RandomState(5)
    prefixes = [rng.randint(0, vocab, size=512).astype(np.int32)
                for _ in range(6)]
    return [np.concatenate([prefixes[i % 6], rng.randint(
        0, vocab, size=64).astype(np.int32)]) for i in range(18)]


def tier_run(torch, np, model, quant, tiered, disk_dir):
    """The tier workload on one engine (4 slots, chunk_pages=4). Tiered:
    a pool just above four slots' reservation (1 + 4 x 38 + 8 pages), so
    each recurring prefix was evicted from HBM into the tiers (DRAM holds
    two prefixes, the rest spills to disk); untiered: a pool large
    enough that no prefix page is reclaimed (512 pages). Returns the
    engine, the streams, the wall seconds and the gather / promote host
    ms per page."""
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    elem = 1 if quant else torch.empty((), dtype=model.dtype).element_size()
    page_bytes = 2 * model.num_layers * 16 * model.units * elem
    kw = dict(num_pages=1 + 4 * 38 + 8,
              kv_tiers={"dram_bytes": 2 * 32 * page_bytes,
                        "disk_dir": disk_dir}) if tiered \
        else dict(num_pages=512)
    eng = InferenceEngine(model, num_slots=4, page_size=16, max_len=1024,
                          chunk_pages=4, prefix_cache=True, kv_quant=quant,
                          **kw)
    gather_ms, promote_ms = [], []
    eng.gather_page = _timed(eng.gather_page, gather_ms)
    eng._promote_page = _timed(eng._promote_page, promote_ms)
    reqs = [Request(p, max_new_tokens=32) for p in
            tier_workload(np, model.vocab_size)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng.run(reqs, before_step=lambda e, _i: e.audit_pages())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    eng.audit_pages()
    bad = [(r.request_id, r.outcome) for r in reqs
           if r.outcome is None or not r.outcome.ok]
    check(not bad, f"tiers {quant or 'bf16'}: requests ended badly: {bad}")
    check_ragged_launches(eng, launches, f"tiers {quant or 'bf16'}",
                          eng.decode_steps, chunk_replays(eng))
    return eng, [r.token_ids for r in reqs], wall, gather_ms, promote_ms


def phase_tiers(torch, np, model):
    """KV cache tiers on raw bf16, int8 and fp8_e4m3 pools: demotions to
    DRAM, spills to disk, promotions from both, no crc fallback, one
    gather and one promotion capture, clean audits before every step,
    and greedy streams bitwise those of an engine that never evicts."""
    import tempfile
    from incubator_mxnet_tpu_torch.events import EventType
    for quant in (None, "int8", "fp8_e4m3"):
        label = f"tiers {quant or 'raw bf16'}"
        disk = tempfile.mkdtemp(prefix="mx_tiers_")
        try:
            eng, got, wall, g_ms, p_ms = tier_run(torch, np, model, quant,
                                                  True, disk)
            ref, want, _, _, _ = tier_run(torch, np, model, quant, False,
                                          None)
        finally:
            shutil.rmtree(disk, ignore_errors=True)
        snap = eng.health_snapshot()
        proms = eng.flight.events(etype=EventType.CACHE_PROMOTE)
        from_dram = sum(e.data["tier"] == "dram" for e in proms)
        from_disk = sum(e.data["tier"] == "disk" for e in proms)
        check(ref.prefix_reclaimed_pages == 0 and ref.tier_demotions == 0,
              f"{label}: the reference engine reclaimed prefix pages")
        check(snap["tier_demotions"] > 0 and snap["tier_disk_demotions"] > 0
              and from_dram > 0 and from_disk > 0,
              f"{label}: demotions {snap['tier_demotions']}, spills "
              f"{snap['tier_disk_demotions']}, promotions from DRAM "
              f"{from_dram} / disk {from_disk} (each must be > 0)")
        check(snap["tier_crc_fallbacks"] == 0 and
              eng._tiers.crc_failures == 0,
              f"{label}: crc fallbacks {snap['tier_crc_fallbacks']}")
        check(eng.promote_trace_count == eng.demote_trace_count == 1,
              f"{label}: promote / demote built "
              f"{eng.promote_trace_count} / {eng.demote_trace_count} "
              f"times")
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        check(not diff, f"{label}: streams {diff} differ from the "
                        f"untiered engine's")
        page_bytes = next((e.nbytes for _k, e in eng._tiers.entries()),
                          None)
        stats = dict(wall_s=round(wall, 3), demoted=snap["tier_demotions"],
                     spilled=snap["tier_disk_demotions"],
                     promoted=snap["tier_promotions"],
                     promoted_from_dram=from_dram,
                     promoted_from_disk=from_disk,
                     tier_hits=snap["tier_hits"],
                     tier_hit_tokens=snap["tier_hit_tokens"],
                     dropped=snap["tier_dropped"],
                     gather_ms_per_page=_median(g_ms),
                     promote_ms_per_page=_median(p_ms),
                     bytes_per_page=page_bytes,
                     capture_ms=dict(gather=eng._gather_prog.build_ms,
                                     promote=eng._promote_prog.build_ms))
        print(f"[tiers] {label}: {json.dumps(stats)}", flush=True)
        del eng, ref
        torch.cuda.empty_cache()


def transport_requests(np, Request, vocab):
    """8 requests of 64-768 prompt tokens, 64 new tokens each, greedy and
    seeded T=0.8 alternating."""
    rng = np.random.RandomState(7)
    return [Request(rng.randint(0, vocab, size=int(n)), max_new_tokens=64,
                    temperature=0.0 if i % 2 == 0 else 0.8, seed=300 + i)
            for i, n in enumerate(rng.randint(64, 769, size=8))]


def phase_transport(torch, np, model):
    """Page transport between two engines on the same model, raw bf16
    and int8 pools: each slot captured off A once it has 16 tokens,
    installed on B and finished there; the streams equal the same
    requests run on A alone, bitwise; B prefills nothing for them (its
    decode step takes each slot on from its last token); the custody is
    released and both audits are clean; B builds one promotion
    program."""
    from incubator_mxnet_tpu_torch.events import EventType
    from incubator_mxnet_tpu_torch.serve import (InferenceEngine,
                                                 PageTransport, Request)
    kw = dict(num_slots=8, page_size=16, max_len=1024, chunk_pages=4,
              prefix_cache=True)
    for quant in (None, "int8"):
        label = f"transport {quant or 'raw bf16'}"
        solo = InferenceEngine(model, kv_quant=quant, **kw)
        ref = transport_requests(np, Request, model.vocab_size)
        solo.run(ref)
        a = InferenceEngine(model, kv_quant=quant, **kw)
        b = InferenceEngine(model, kv_quant=quant, **kw)
        reqs = transport_requests(np, Request, model.vocab_size)
        for r in reqs:
            a.submit(r)
        tr = PageTransport()
        moved, cap_ms, inst_ms, nbytes = {}, [], [], 0
        for _ in range(5000):
            if all(r.request_id in moved for r in reqs) and \
                    all(t.outcome is not None for t in moved.values()):
                break
            a.step()
            for r in reqs:
                if r.request_id in moved or len(r.token_ids) < 16 or \
                        not a.decode_ready(r.request_id):
                    continue
                t0 = time.perf_counter()
                cap = tr.capture(a, r.request_id)
                cap_ms.append((time.perf_counter() - t0) * 1e3)
                check(cap is not None, f"{label}: capture refused")
                att = cap.make_resume_request()
                t0 = time.perf_counter()
                ok = tr.install(b, cap, att)
                inst_ms.append((time.perf_counter() - t0) * 1e3)
                check(ok, f"{label}: install refused")
                check(a.release_capsule(r.request_id) == cap.num_pages,
                      f"{label}: custody release")
                nbytes += cap.nbytes
                moved[r.request_id] = att
            b.step()
            a.audit_pages()
            b.audit_pages()
        check(len(moved) == 8 and all(t.outcome is not None and t.outcome.ok
                                      for t in moved.values()),
              f"{label}: {len(moved)} of 8 moved, not all finished")
        diff = []
        for r, want in zip(reqs, ref):
            got = r.token_ids + moved[r.request_id].token_ids
            if got != want.token_ids:
                first = next((i for i, (x, y) in enumerate(
                    zip(got, want.token_ids)) if x != y), None)
                diff.append((r.request_id, r.temperature, first))
        check(not diff, f"{label}: migrated streams differ from A alone "
                        f"(request, temperature, first differing token): "
                        f"{diff}")
        ids = {t.request_id for t in moved.values()}
        chunks = [e.data["n"] for e in b.flight.events(
            etype=EventType.PREFILL_CHUNK) if e.request_id in ids]
        check(chunks == [], f"{label}: B prefilled {chunks} tokens for "
                            f"the installed slots (want none)")
        check(b.promote_trace_count == 1 and a.demote_trace_count == 1 and
              not a._capsule_pages and not b._capsule_pages,
              f"{label}: promote / demote builds "
              f"{b.promote_trace_count} / {a.demote_trace_count}, custody "
              f"{a._capsule_pages}")
        stats = dict(slots=len(moved), pages=b.migrated_in_pages,
                     mb_moved=round(nbytes / 1e6, 3),
                     capture_ms_per_slot=_median(cap_ms),
                     install_ms_per_slot=_median(inst_ms),
                     pages_per_slot=b.migrated_in_pages / len(moved))
        print(f"[transport] {label}: {json.dumps(stats)}", flush=True)
        del solo, a, b
        torch.cuda.empty_cache()


def phase_warm_start(torch, np):
    """An engine on the seed-0 model serves 4 requests (its decode and
    prefill graphs captured), then takes the seed-1 model's weights by
    ``warm_start`` and serves 4 more: no new capture, the streams those
    of a fresh engine on the seed-1 model, the prefix index flushed."""
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    kw = dict(num_slots=4, page_size=16, max_len=1024, chunk_pages=4,
              prefix_cache=True)
    live = bench_gpt(0)
    other = bench_gpt(1)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, live.vocab_size, size=int(n)).astype(np.int32)
               for n in (80, 200, 333, 500)]
    mk = lambda: [Request(p, max_new_tokens=32) for p in prompts]
    eng = InferenceEngine(live, **kw)
    first = mk()
    eng.run(first)
    builds = (eng.decode_trace_count, dict(eng.prefill_trace_counts))
    flushes = eng.prefix_flushes
    t0 = time.perf_counter()
    eng.warm_start(params=other.state_dict())
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    second = mk()
    eng.run(second)
    eng.audit_pages()
    fresh = mk()
    InferenceEngine(other, **kw).run(fresh)
    check((eng.decode_trace_count, dict(eng.prefill_trace_counts)) ==
          builds, f"warm start: builds moved from {builds}")
    check(eng.prefix_flushes == flushes + 1, "warm start: no flush")
    check([r.token_ids for r in second] == [r.token_ids for r in fresh],
          "warm start: streams differ from a fresh engine on the new "
          "weights")
    check([r.token_ids for r in second] != [r.token_ids for r in first],
          "warm start: the new weights changed nothing")
    stats = dict(swap_ms=round(swap_ms, 3), decode_builds=builds[0],
                 prefill_builds=builds[1],
                 decode_replays=eng._programs[1].replays)
    print(f"[warm_start] gpt_small bf16 seed 0 -> seed 1, streams equal a "
          f"fresh engine's: {stats}", flush=True)
    del eng, live, other
    torch.cuda.empty_cache()


def phase_brownout(torch, np, model):
    """One overloaded run under the brownout controller (16 requests of
    three tiers on 4 slots, spec_k=4, a 50 ms delay reference): the level
    timeline; every request terminal and the audit clean."""
    from incubator_mxnet_tpu_torch.serve import (BrownoutController,
                                                 InferenceEngine, Request,
                                                 Tier)
    bo = BrownoutController(up_steps=1, down_steps=2, delay_ref=0.05)
    eng = InferenceEngine(model, num_slots=4, page_size=16, max_len=1024,
                          chunk_pages=4, prefix_cache=True, spec_k=4,
                          brownout=bo)
    rng = np.random.RandomState(11)
    tiers = (Tier.LATENCY, Tier.STANDARD, Tier.BATCH)
    reqs = [Request(rng.randint(0, model.vocab_size, size=int(n)),
                    max_new_tokens=32, tier=tiers[i % 3])
            for i, n in enumerate(rng.randint(64, 257, size=16))]
    eng.run(reqs, before_step=lambda e, _i: e.audit_pages())
    eng.audit_pages()
    check(all(r.outcome is not None for r in reqs),
          "brownout: a request never ended")
    outcomes = {}
    for r in reqs:
        outcomes[r.outcome.value] = outcomes.get(r.outcome.value, 0) + 1
    stats = dict(escalations=bo.escalations, deescalations=bo.deescalations,
                 final_level=bo.level, timeline=bo.timeline,
                 outcomes=outcomes, spec_steps=eng.spec_steps,
                 decode_steps=eng.decode_steps)
    print(f"[brownout] {json.dumps(stats)}", flush=True)


def phase_surface(torch):
    import numpy as np
    model = bench_gpt(0)
    phase_tiers(torch, np, model)
    phase_transport(torch, np, model)
    phase_brownout(torch, np, model)
    del model
    torch.cuda.empty_cache()
    phase_warm_start(torch, np)


# --------------------------------------------------------------------- #
# the serving fleet: a Router over gpt_small replicas on one card, slot
# migration, the rolling upgrade, the chaos kill and the HTTP front end
# --------------------------------------------------------------------- #

FLEET = dict(replicas=3, router_seed=5, max_new=64,
             engine=dict(num_slots=8, page_size=16, max_len=1024,
                         chunk_pages=4, prefix_cache=True))


def fleet_model(seed):
    return bench_gpt(seed)


def fleet_requests(np, Request, vocab, seeds=None, n=16):
    """The serving phase's mixed workload (``_prompts``: 8 of 16 share a
    512-token prefix), 64 new tokens, greedy and T=0.8 alternating; the
    seeds left to the router to pin unless ``seeds`` gives them."""
    prompts = _prompts(np, np.random.RandomState(0), vocab)[:n]
    return [Request(p, max_new_tokens=FLEET["max_new"], eos_id=vocab - 1,
                    temperature=0.0 if i % 2 == 0 else 0.8,
                    seed=None if seeds is None else seeds[i])
            for i, p in enumerate(prompts)]


def always_drafter(np, streams):
    """``replay_drafter`` over an earlier run's streams, and where it has
    nothing, the last token repeated: with ``spec_patience=0`` every
    decode-ready slot with more than one token to go drafts every step,
    so a speculative replica runs the verify program whoever shares it
    (a slot's logits then depend on its own row only) — except in a step
    where every decode-ready slot is at its last token, which runs the
    W = 1 decode program."""
    replay = replay_drafter(np, streams)

    def draft(history, k):
        d = replay(history, k)
        return d if d.size else np.full((k,), history[-1], np.int32)

    return draft


def fleet_audit(rt):
    for rep in rt.replicas:
        if rep.state.value != "DEAD" and rep.killed is None:
            rep.engine.audit_pages()


def fleet_drive(torch, rt, reqs, before=None, waves=True, limit_s=300.0):
    """Wave 1 (the first 8: the prefix's first request and 7 others), then
    — once request 0 has its first token, its prefix pages published —
    wave 2; steps until every request is terminal, auditing every live
    replica's pages after each step (a pass that advanced nothing sleeps
    1 ms, as ``Router.run`` does). Returns the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, rest = (reqs[:8], reqs[8:]) if waves else (reqs, [])
    for r in first:
        check(rt.submit(r), f"fleet refused request {r.request_id}")
    i = 0
    while rest or any(r.outcome is None for r in reqs):
        if rest and rt.live_tokens(reqs[0]):
            for r in rest:
                check(rt.submit(r), f"fleet refused {r.request_id}")
            rest = []
        if before is not None:
            before(rt, i)
        if not rt.step():
            time.sleep(1e-3)
        fleet_audit(rt)
        i += 1
        check(time.perf_counter() - t0 < limit_s,
              f"fleet wedged: {i} steps in {limit_s} s")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fleet_launches(rt, launches, label):
    """The process-wide ragged launch counts of a fleet run equal the sum
    over its replicas (the dead one included) of steps x layers: decode =
    non-speculative steps, verify = speculative steps, prefill = chunk
    replays."""
    engs = [rep.engine for rep in rt.replicas]
    check_ragged_launches(
        engs[0], launches, label,
        sum(e.decode_steps for e in engs),
        sum(chunk_replays(e) for e in engs),
        sum(e.spec_steps for e in engs))


def fleet_captures(rt, label):
    """Each replica captured one program per width and (kind, bucket) it
    met, at most one COW copy, gather and promotion; a replica that met
    nothing captured nothing. Returns (decode, verify, prefill, copy,
    promote, gather) per replica."""
    out = []
    for rep in rt.replicas:
        e = rep.engine
        if e.prefill_trace_count:
            captures_once(e, f"{label} replica {rep.idx}")
        else:
            check(e.decode_trace_count == e.verify_trace_count ==
                  e.copy_trace_count == 0,
                  f"{label}: idle replica {rep.idx} captured programs")
        check(e.promote_trace_count <= 1 and e.demote_trace_count <= 1,
              f"{label}: replica {rep.idx} page programs captured "
              f"{e.promote_trace_count} / {e.demote_trace_count} times")
        out.append((e.decode_trace_count, e.verify_trace_count,
                    e.prefill_trace_count, e.copy_trace_count,
                    e.promote_trace_count, e.demote_trace_count))
    return out


def fleet_transitions(rt, label, want):
    """The router's replica-health transitions, (replica, from, to), must
    be exactly the ones the run injected: anything else (a breaker that
    opened) is a failure to explain."""
    got = [(e.data["replica"], e.data["from_state"], e.data["to_state"])
           for e in rt.flight.events("router")
           if e.etype.value == "REPLICA_HEALTH"]
    check(got == want, f"{label}: replica transitions {got}, want {want}")
    return [f"{i}:{a}->{b}" for i, a, b in got]


def fleet_dispatches(rt, reqs):
    """Per request, the replicas its (re)dispatches chose, in order."""
    idx = {r.request_id: i for i, r in enumerate(reqs)}
    out = [[] for _ in reqs]
    for e in rt.flight.events("router"):
        if e.etype.value == "DISPATCH" and e.request_id in idx:
            out[idx[e.request_id]].append(e.data["replica"])
    return out


def fleet_ttft_ms(reqs):
    return _median([(r.token_stamps[0] - r.submit_time) * 1e3
                    for r in reqs if r.token_stamps])


def fleet_ok(reqs, label):
    bad = [(i, r.outcome, r.detail[:80]) for i, r in enumerate(reqs)
           if r.outcome is None or not r.outcome.ok]
    check(not bad, f"{label}: requests ended badly: {bad}")


def first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def fleet_line(label, rt, wall, captures, transitions, reqs=(),
               **extra):
    """One ``[fleet]`` line: the run's tokens/s and TTFT p50 (over
    ``reqs``, the router's clients), its routing, re-queue and migration
    tallies, breaker transitions and captures per replica."""
    n_tok = sum(len(r.token_ids) for r in reqs)
    stats = dict(requests=len(reqs), tokens=n_tok,
                 wall_s=round(wall, 3),
                 tokens_per_s=round(n_tok / wall, 1) if reqs else None,
                 ttft_p50_ms=fleet_ttft_ms(reqs) if reqs else None,
                 steps=rt.steps, affinity_routed=rt.affinity_routed,
                 spill_routed=rt.spill_routed, requeues=rt.requeues,
                 migrations=rt.migrations,
                 breaker_transitions=transitions,
                 captures_per_replica=captures, **extra)
    print(f"[fleet] {label}: {json.dumps(stats)}", flush=True)


def check_top_p_slots(torch):
    """One row with top-p 0.9 and top-k 40 (T = 0.8) placed in each of 8
    slots of an (8, W, 50257) batch: the constrained row and the
    inverse-CDF draw from it bitwise the same in every slot (the top-p
    normalizer and cumsum run over row-aligned rows)."""
    from incubator_mxnet_tpu_torch.serve.sampling import (
        constrain_logits, sample_inverse_cdf)
    V, S, dev = 50257, 8, "cuda"
    for W in (1, 5):
        gen = torch.Generator(device=dev).manual_seed(1)
        row = torch.randn(V, device=dev, generator=gen) * 2.0
        u = torch.rand(32, device=dev, generator=gen)
        full = lambda v, dt=torch.float32: torch.full(  # noqa: E731
            (S, W), v, dtype=dt, device=dev)
        menu = dict(
            counts=torch.zeros(S, W, V, dtype=torch.int32, device=dev),
            bias=torch.zeros(S, W, V, device=dev),
            mask=torch.ones(S, W, V, dtype=torch.bool, device=dev),
            top_k=full(40, torch.int32), top_p=full(0.9),
            rep_pen=full(1.0), pres_pen=full(0.0))
        rows, draws = [], []
        for s in range(S):
            x = torch.randn(S, W, V, device=dev, generator=gen)
            x[s, 0] = row
            c = constrain_logits(x, full(0.8), **menu)
            rows.append(c[s, 0].clone())
            draws.append(torch.stack([sample_inverse_cdf(
                c / 0.8, torch.full((S, W), float(v), device=dev))[s, 0]
                for v in u]))
        same = sum(torch.equal(r, rows[0]) and torch.equal(d, draws[0])
                   for r, d in zip(rows, draws))
        kept = int((rows[0] > -1e29).sum())
        check(same == S and 1 < kept <= 40,
              f"top-p W={W}: {same} of {S} slots drew as slot 0 "
              f"({kept} tokens kept)")
        print(f"[sampling] top-p 0.9 / top-k 40 row, W={W}: the same "
              f"constrained row and {u.numel()} draws in {same} of {S} "
              f"slots ({kept} tokens kept)", flush=True)


def phase_fleet(torch):
    """The serving fleet on one card: 3 gpt_small bf16 replicas, each on
    its own copy of the weights, behind a Router (``build_fleet``)."""
    import numpy as np
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import (InferenceEngine, Request,
                                                 build_fleet)
    from incubator_mxnet_tpu_torch.serve.chaos import (
        KillReplica, assert_fleet_health_consistent)
    check_top_p_slots(torch)
    model = fleet_model(0)
    V = model.vocab_size
    KW, N, RS = FLEET["engine"], FLEET["replicas"], FLEET["router_seed"]

    def fleet(**kw):
        return build_fleet(model, N, engine_kw=dict(KW, **kw), seed=RS)

    def run(label, rt, reqs, before=None, waves=True):
        torch.cuda.synchronize()
        reset_launch_counts()
        wall = fleet_drive(torch, rt, reqs, before=before, waves=waves)
        fleet_launches(rt, dict(LAUNCHES), label)
        assert_fleet_health_consistent(rt, reqs)
        return wall

    # 1. fault-free: affinity, streams == one engine under the pinned seeds
    label = "fault-free, 3 replicas"
    rt = fleet()
    reqs = fleet_requests(np, Request, V)
    wall = run(label, rt, reqs)
    fleet_ok(reqs, label)
    seeds = [r.seed for r in reqs]
    base = [list(r.token_ids) for r in reqs]
    streams = [(r.prompt_ids, r.token_ids) for r in reqs]
    routes = fleet_dispatches(rt, reqs)
    holder = routes[0][0]
    shared = routes[8:15]
    check(all(d == [holder] for d in shared) and
          rt.replicas[holder].engine.prefix_hits >= len(shared) and
          rt.affinity_routed >= len(shared),
          f"{label}: the prefix's requests went to {shared}, its pages "
          f"are on replica {holder} (prefix hits "
          f"{rt.replicas[holder].engine.prefix_hits}, affinity "
          f"{rt.affinity_routed})")
    caps = fleet_captures(rt, label)
    trans = fleet_transitions(rt, label, [])
    solo = InferenceEngine(model, **KW)
    ref = fleet_requests(np, Request, V, seeds=seeds)
    solo.run(ref)
    diff = [(i, first_diff(a, r.token_ids)) for i, (a, r) in
            enumerate(zip(base, ref)) if a != r.token_ids]
    check(not diff, f"{label}: streams differ from one engine's "
                    f"(request, first token): {diff}")
    fleet_line(label, rt, wall, caps, trans, reqs, holder=holder,
               prefix_hits=[rep.engine.prefix_hits
                            for rep in rt.replicas],
               routes=[d[0] for d in routes])
    del rt, solo
    gc.collect()
    torch.cuda.empty_cache()
    victim = (holder + 1) % N

    def kill_run(label, rt, reqs, inj, want):
        wall = run(label, rt, reqs, before=inj.on_step)
        check(inj.fired and rt.replica_deaths == 1,
              f"{label}: the kill never fired")
        fleet_ok(reqs, label)
        moved = {id(c): pre for c, pre in inj.inflight_at_kill}
        check(moved, f"{label}: nothing was in flight on the victim")
        for r in reqs:
            pre = moved.get(id(r))
            check(pre is None or r.token_ids[:len(pre)] == pre,
                  f"{label}: request {r.request_id} lost its emitted "
                  f"prefix")
        surv = [i for i, r in enumerate(reqs) if id(r) not in moved]
        bad = [(i, first_diff(reqs[i].token_ids, want[i])) for i in surv
               if reqs[i].token_ids != want[i]]
        check(not bad, f"{label}: survivors differ from the fault-free "
                       f"run (request, first token): {bad}")
        replay = [i for i, r in enumerate(reqs) if id(r) in moved]
        requeue_at = {e.request_id: e.ts for e in rt.flight.events("router")
                      if e.etype.value == "REQUEUE"}
        gap = [(next(t for t in reqs[i].token_stamps
                     if t > requeue_at[reqs[i].request_id]) -
                requeue_at[reqs[i].request_id]) * 1e3
               for i in replay if reqs[i].request_id in requeue_at and
               any(t > requeue_at[reqs[i].request_id]
                   for t in reqs[i].token_stamps)]
        caps = fleet_captures(rt, label)
        trans = fleet_transitions(rt, label, [(victim, "SERVING", "DEAD")])
        fleet_line(label, rt, wall, caps, trans, reqs, victim=victim,
                   requeued=len(replay), survivors=len(surv),
                   requeued_equal=sum(reqs[i].token_ids == want[i]
                                      for i in replay),
                   requeued_first_diff=[first_diff(reqs[i].token_ids,
                                                   want[i])
                                        for i in replay],
                   requeue_to_first_token_ms=_median(gap))

    # 2a. a kill mid-decode
    kill_run("KillReplica mid-decode", fleet(),
             fleet_requests(np, Request, V),
             KillReplica(replica=victim, at_step=12, phase="decode"), base)
    gc.collect()
    torch.cuda.empty_cache()

    # 2b. spec_k=4, every step a verify step: fault-free, then a kill
    # mid-verify
    spec = dict(spec_k=4, spec_patience=0,
                draft_fn=always_drafter(np, streams))
    label = "spec_k=4 fault-free, 3 replicas"
    rt = fleet(**spec)
    reqs = fleet_requests(np, Request, V)
    wall = run(label, rt, reqs)
    fleet_ok(reqs, label)
    spec_base = [list(r.token_ids) for r in reqs]
    check(all(rep.engine.spec_steps for rep in rt.replicas),
          f"{label}: a replica never ran a verify step")
    caps = fleet_captures(rt, label)
    trans = fleet_transitions(rt, label, [])
    fleet_line(label, rt, wall, caps, trans, reqs,
               equal_to_plain=sum(a == b for a, b in zip(spec_base, base)),
               w1_steps=[rep.engine.decode_steps - rep.engine.spec_steps
                         for rep in rt.replicas],
               accept_rate=round(sum(rep.engine.accepted_tokens for rep in
                                     rt.replicas) /
                                 max(1, sum(rep.engine.drafted_tokens
                                            for rep in rt.replicas)), 3))
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    kill_run("spec_k=4, KillReplica mid-verify", fleet(**spec),
             fleet_requests(np, Request, V),
             KillReplica(replica=victim, at_step=12, phase="verify"),
             spec_base)
    gc.collect()
    torch.cuda.empty_cache()

    # 3. remove_replica with live decode-ready slots: page capsules
    label = "remove_replica, slots moved by capsule"
    rt = fleet()
    gone = (holder + 2) % N
    mig_ms = []
    rt.migrate = _timed(rt.migrate, mig_ms)
    removed = []

    def remove(router, _i):
        rep = router.replicas[gone]
        if removed:
            return
        for t in router._inflight:
            if t.replica == gone and t.attempt.token_ids and \
                    rep.engine.decode_ready(t.attempt.request_id):
                router.remove_replica(gone)
                removed.append(_i)
                return

    reqs = fleet_requests(np, Request, V)
    wall = run(label, rt, reqs, before=remove)
    for _ in range(50):
        if rt.replicas[gone].state.value == "RETIRED":
            break
        rt.step()
    fleet_ok(reqs, label)
    check(removed and rt.migrations > 0 and rt.migrations_failed == 0 and
          rt.migrated_pages > 0 and rt.migrated_bytes > 0,
          f"{label}: migrations {rt.migrations} (failed "
          f"{rt.migrations_failed}, pages {rt.migrated_pages})")
    diff = [(i, first_diff(r.token_ids, b)) for i, (r, b) in
            enumerate(zip(reqs, base)) if r.token_ids != b]
    check(not diff, f"{label}: streams differ from the fault-free run "
                    f"(request, first token): {diff}")
    caps = fleet_captures(rt, label)
    trans = fleet_transitions(rt, label, [(gone, "SERVING", "DRAINING"),
                                          (gone, "DRAINING", "RETIRED")])
    fleet_line(label, rt, wall, caps, trans, reqs, removed=gone,
               at_step=removed[0], migrated_pages=rt.migrated_pages,
               migrated_mb=round(rt.migrated_bytes / 1e6, 3),
               migrate_ms_per_slot=_median(mig_ms))
    del rt
    gc.collect()
    torch.cuda.empty_cache()

    # 4. upgrade_replica(0) to the seed-1 weights while 1-2 serve
    label = "upgrade_replica(0) to seed-1 weights"
    other = fleet_model(1)
    rt = fleet()
    reqs = fleet_requests(np, Request, V)[:8]
    t_swap = []

    def upgrade(router, i):
        if i == 1:
            router.upgrade_replica(0, params=other.state_dict())
        if router.upgrades and not t_swap:
            t_swap.append(i)

    wall = run(label, rt, reqs, before=upgrade, waves=False)
    for _ in range(200):
        if rt.replicas[0].state.value == "SERVING" and rt.upgrades:
            break
        rt.step()
    fleet_ok(reqs, label)
    check(rt.upgrades == 1 and rt.replicas[0].state.value == "SERVING",
          f"{label}: replica 0 is {rt.replicas[0].state} after "
          f"{rt.upgrades} upgrades")
    diff = [i for i, r in enumerate(reqs) if r.token_ids != base[i]]
    check(not diff, f"{label}: streams {diff} differ from the fault-free "
                    f"run (all served on seed-0 weights)")
    caps = fleet_captures(rt, label)
    trans = fleet_transitions(rt, label, [(0, "SERVING", "DRAINING"),
                                          (0, "DRAINING", "WARMING"),
                                          (0, "WARMING", "SERVING")])
    rng = np.random.RandomState(9)
    probe = [rng.randint(0, V, size=int(n)).astype(np.int32)
             for n in (80, 300)]
    mk = lambda: [Request(p, max_new_tokens=32) for p in probe]  # noqa
    got = []
    for rep in rt.replicas:
        rs = mk()
        rep.engine.run(rs)
        got.append([r.token_ids for r in rs])
    want = []
    for m in (other, model):
        rs = mk()
        InferenceEngine(m, **KW).run(rs)
        want.append([r.token_ids for r in rs])
    check(got[0] == want[0] and got[1] == got[2] == want[1] and
          want[0] != want[1],
          f"{label}: replica 0 serves seed-1 streams: "
          f"{got[0] == want[0]}; replicas 1, 2 seed-0 streams: "
          f"{got[1] == want[1]}, {got[2] == want[1]}")
    fleet_audit(rt)
    fleet_line(label, rt, wall, caps, trans, reqs,
               swapped_at_step=t_swap[:1], replica0_seed1=True,
               replicas12_seed0=True)
    del rt, other
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the HTTP front end: over a plain fleet, 4 SSE + 1 blocking
    # against the direct router's streams; over a speculative fleet, one
    # stream a replica while the front end's thread captures their verify
    # programs, against the same requests driven directly
    picks = [fleet_requests(np, Request, V)[i] for i in range(5)]
    payloads = [dict(prompt=[int(t) for t in r.prompt_ids],
                     max_new_tokens=FLEET["max_new"], eos_id=V - 1,
                     temperature=r.temperature, seed=seeds[i],
                     stream=i != 4) for i, r in enumerate(picks)]
    fleet_http(torch, fleet(), payloads, base,
               "ServeFrontend over the plain fleet, 4 SSE + 1 blocking")
    label = "spec_k=4 fleet driven directly, one request a replica"
    rt = fleet(**spec)
    reqs = fleet_requests(np, Request, V)[:N]
    wall = run(label, rt, reqs, waves=False)
    fleet_ok(reqs, label)
    alone = [list(r.token_ids) for r in reqs]
    check(sorted(d[0] for d in fleet_dispatches(rt, reqs)) ==
          list(range(N)), f"{label}: not one request a replica")
    fleet_line(label, rt, wall, fleet_captures(rt, label),
               fleet_transitions(rt, label, []), reqs)
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    rt = fleet_http(torch, fleet(**spec),
                    [dict(p, stream=True) for p in payloads[:N]], alone,
                    "ServeFrontend over the spec_k=4 fleet, one stream a "
                    "replica, verify captured while they are open")
    check(all(rep.engine.verify_trace_count == 1 for rep in rt.replicas),
          f"verify captures on the front end's thread: "
          f"{[rep.engine.verify_trace_count for rep in rt.replicas]}")
    del rt, model
    gc.collect()
    torch.cuda.empty_cache()


def fleet_http(torch, rt, payloads, want, label):
    """``payloads`` sent at once to a ``ServeFrontend`` over ``rt`` on
    127.0.0.1 (port 0), each from its own client thread (SSE, or a
    blocking completion where ``stream`` is False); every completion
    must come back 200 with the tokens of ``want``, /healthz and
    /metrics must answer, and the ragged launches equal the replicas'
    steps x layers. Returns the router."""
    from incubator_mxnet_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from incubator_mxnet_tpu_torch.serve import (ServeFrontend,
                                                 stream_completion)
    from incubator_mxnet_tpu_torch.serve.frontend import http_request
    host = "127.0.0.1"
    out = [None] * len(payloads)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with ServeFrontend(rt, host=host, port=0) as fe:
        def client(j):
            t = time.perf_counter()
            if payloads[j]["stream"]:
                r = stream_completion(host, fe.bound_port, payloads[j],
                                      timeout=300)
                out[j] = (r["status"], r["tokens"],
                          r["final"]["outcome"] if r["final"] else None,
                          (r["stamps"][0] - t) * 1e3 if r["stamps"]
                          else None)
            else:
                status, _, body = http_request(
                    host, fe.bound_port, "POST", "/v1/completions",
                    payloads[j], timeout=300)
                out[j] = (status, body["tokens"], body["outcome"], None)

        threads = [threading.Thread(target=client, args=(j,), daemon=True)
                   for j in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads),
              f"{label}: a client never finished")
        hs, _, health = http_request(host, fe.bound_port, "GET",
                                     "/healthz")
        ms, _, metrics = http_request(host, fe.bound_port, "GET",
                                      "/metrics")
        fe_stats = fe.stats_snapshot()
    wall = time.perf_counter() - t0
    n = len(rt.replicas)
    metrics = metrics.decode() if isinstance(metrics, bytes) else metrics
    check(hs == 200 and health["status"] == "ok" and
          health["replicas"].get("SERVING") == n,
          f"{label}: /healthz {hs} {health}")
    check(ms == 200 and f"mxtpu_serve_fleet_size {n}" in metrics and
          "mxtpu_serve_http_requests_total" in metrics,
          f"{label}: /metrics {ms}")
    bad = [(j, o[0], o[2], first_diff(o[1], want[j]))
           for j, o in enumerate(out) if o[0] != 200 or o[1] != want[j]]
    check(not bad, f"{label}: (request, status, outcome, first differing "
                   f"token) vs the direct router: {bad}")
    check(rt.health["MAX_TOKENS"] + rt.health["EOS"] == len(payloads),
          f"{label}: router outcomes {rt.health}")
    fleet_launches(rt, dict(LAUNCHES), label)
    n_tok = sum(len(o[1]) for o in out)
    fleet_line(label, rt, wall, fleet_captures(rt, label),
               fleet_transitions(rt, label, []),
               http_requests=fe_stats["http_requests"],
               sse_tokens=fe_stats["sse_tokens"], http_tokens=n_tok,
               tokens_per_s_http=round(n_tok / wall, 1),
               ttft_http_p50_ms=_median([o[3] for o in out
                                         if o[3] is not None]))
    return rt


def profile_decode(torch, np, eng, rng, Request, label):
    """Where a full decode step's time goes: 8 slots at ~200 tokens of
    context, 10 steps under torch.profiler — device-busy time per step
    (kernel and copy time on the card) against the step's wall time,
    and the kernels that take it. Profiling adds host time, so the busy
    share printed is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [Request(rng.randint(0, eng.model.vocab_size, size=200),
                    max_new_tokens=40) for _ in range(eng.num_slots)]
    for r in reqs:
        eng.submit(r)
    while any(sl is None or sl.prefilling for sl in eng._slots):
        eng.step()
    torch.cuda.synchronize()
    n = 10
    spec0 = eng.spec_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    wide = eng.spec_steps - spec0
    eng.run([])
    eng.audit_pages()
    kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not kern:
        print("[profile] device time not measured: the profiler recorded "
              "no kernel", flush=True)
        return
    busy_ms = sum(t for _, t in kern) / 1e3 / n
    top = sorted(kern, key=lambda kt: -kt[1])[:6]
    print(f"[profile] {label}: decode, 8 slots, ~200-240 context, "
          f"{wide}/{n} steps speculative: wall {wall_ms:.3f} ms/step "
          f"(profiled), device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%); top: " + "; ".join(
              f"{k[:48]} {t / 1e3 / n:.3f} ms" for k, t in top), flush=True)


def profile_prefill(torch, eng, rng, Request, label):
    """Where a prefill chunk step's time goes: one 960-token prompt, its
    chunk steps 2-11 (64 tokens each at depths 64-703, each one replay of
    the 64-token bucket's graph) under torch.profiler — wall and
    device-busy ms per step, and the ragged prefill kernels' device ms
    (their share of busy and of wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.submit(Request(rng.randint(0, eng.model.vocab_size, size=960),
                       max_new_tokens=2))
    eng.step()                                   # admission, first chunk
    torch.cuda.synchronize()

    def prefilling():
        return any(sl is not None and sl.prefilling for sl in eng._slots)

    n = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while n < 10 and prefilling():
            eng.step()
            n += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / max(n, 1)
    eng.run([])
    eng.audit_pages()
    kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    check(n > 0, f"{label}: no chunk step to profile")
    if not kern:
        print("[profile] device time not measured: the profiler recorded "
              "no kernel", flush=True)
        return
    busy_ms = sum(t for _, t in kern) / 1e3 / n
    pre_ms = sum(t for k, t in kern if "prefill" in k) / 1e3 / n
    print(f"[profile] {label}: graphed prefill chunk steps, 1 slot, 64 "
          f"tokens at depths 64-703, {n} steps: wall {wall_ms:.3f} ms/step "
          f"(profiled), device busy {busy_ms:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}%), ragged prefill kernels "
          f"{pre_ms:.3f} ms/step ({100 * pre_ms / busy_ms:.1f}% of busy, "
          f"{100 * pre_ms / wall_ms:.1f}% of wall)", flush=True)


def host_costs(torch, np, eng, Request):
    """Host time of the graphed decode step's own work at 8 live slots
    (~100-160 tokens of context, half at T=0.8) and gpt_small's
    vocabulary: staging the step into the pinned inputs (with the menu
    sync, nothing to copy here), the launch (one copy in, one replay)
    and the readback (which waits for the device); and the device time
    of sampling: the draw alone (``draw_uniform`` + ``sample_inverse_cdf``)
    and the whole of ``_accept_emit`` (menu, acceptance, draw, guard) at
    W = 1 and 5, each captured into a CUDA graph as the step runs it (an
    eager call's events would time the host's launches). Host: medians
    of 20 repeats of the same step; device: CUDA events over 20 replays.
    Plus n-gram drafting over a 1024-token history."""
    from incubator_mxnet_tpu_torch.serve import ngram_propose
    from incubator_mxnet_tpu_torch.serve.sampling import (
        DRAW_STREAM, draw_uniform, sample_inverse_cdf)
    rng = np.random.RandomState(4)
    S, V = eng.num_slots, eng.model.vocab_size
    for i in range(S):
        eng.submit(Request(rng.randint(0, V, size=100), max_new_tokens=60,
                           temperature=0.8 if i % 2 else 0.0, seed=i))
    while any(sl is None or sl.prefilling for sl in eng._slots):
        eng.step()
    live = list(range(S))
    prog = eng._program(1)
    toks = np.zeros((S, 1), np.int64)
    toks[:, 0] = [sl.request.token_ids[-1] for sl in eng._slots]
    dl = np.zeros((S,), np.int32)

    def stage():
        eng._sync_menu(1, {}, live)
        eng._stage_step(prog, toks, dl, [])

    def host_ms(fn, n=20):
        times = []
        for _ in range(n):
            stage()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            prog.read()
        return statistics.median(times)

    def dev_ms(fn, n=20):
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph)
        side = capture.capture_stream        # the process-wide one
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.synchronize()
        with capture:
            fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def launch_then_read():
        prog.launch()
        t0 = time.perf_counter()
        prog.read()
        return (time.perf_counter() - t0) * 1e3

    out = dict(stage_ms=host_ms(stage), launch_ms=host_ms(prog.launch))
    stage()
    out["readback_ms"] = statistics.median(
        launch_then_read() for _ in range(20))
    dev = eng.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for W in (1, 5):
        logits = torch.randn(S, W, V, generator=gen, device=dev) * 3
        keys = torch.arange(S, device=dev)
        pos = torch.arange(100, 100 + W, device=dev)[None, :].expand(S, W)
        temps = torch.full((S,), 0.8, device=dev)
        tok = torch.randint(0, V, (S, W), generator=gen, device=dev)
        dlen = torch.full((S,), W - 1, dtype=torch.int32, device=dev)
        mask = torch.ones((S, W, V), dtype=torch.bool, device=dev)
        menu = (eng._menu_counts, eng._menu_bias, mask,
                torch.zeros(S, dtype=torch.int32, device=dev),
                torch.ones(S, device=dev), torch.ones(S, device=dev),
                torch.zeros(S, device=dev))
        out[f"draw_w{W}_device_ms"] = dev_ms(lambda: sample_inverse_cdf(
            logits, draw_uniform(keys[:, None], pos, DRAW_STREAM)))
        out[f"accept_emit_w{W}_device_ms"] = dev_ms(
            lambda: eng._accept_emit(logits, tok, dlen, temps, keys, pos,
                                     menu))
    hist = np.random.RandomState(3).randint(0, 64, size=1024)
    t0 = time.perf_counter()
    for _ in range(20):
        [ngram_propose(hist, 4) for _ in range(S)]
    out["ngram_draft_8_slots_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    eng.run([])
    eng.audit_pages()
    print(f"[host] graphed decode step, 8 live slots, V={V}: "
          f"{json.dumps(out)}", flush=True)


def chunk_host_costs(torch, np, eng, Request):
    """Host time of the graphed prefill chunk step's own work: one
    960-token prompt past its first chunk, its second chunk (64 tokens at
    depth 64) staged into the 64-token bucket's pinned inputs, the launch
    (one copy in, one replay) and the readback (which waits for the
    device); medians of 20 repeats of the same chunk."""
    rng = np.random.RandomState(6)
    eng.submit(Request(rng.randint(0, eng.model.vocab_size, size=960),
                       max_new_tokens=2))
    eng.step()                                   # admission, first chunk
    s = next(i for i, sl in enumerate(eng._slots)
             if sl is not None and sl.prefilling)
    start = eng._slots[s].prefill_pos
    prog = eng._stage_chunk(s, start, 64)

    def host_ms(fn, n=20):
        times = []
        for _ in range(n):
            eng._stage_chunk(s, start, 64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            prog.read()
        return statistics.median(times)

    def launch_then_read():
        eng._stage_chunk(s, start, 64)
        prog.launch()
        t0 = time.perf_counter()
        prog.read()
        return (time.perf_counter() - t0) * 1e3

    out = dict(stage_ms=host_ms(lambda: eng._stage_chunk(s, start, 64)),
               launch_ms=host_ms(prog.launch),
               readback_ms=statistics.median(
                   launch_then_read() for _ in range(20)))
    eng.run([])
    eng.audit_pages()
    print(f"[host] graphed prefill chunk step, 64 tokens at depth {start}: "
          f"{json.dumps(out)}", flush=True)


def phase_parity(torch):
    import numpy as np
    from incubator_mxnet_tpu_torch.models.gpt import cached_generate
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    model = bench_gpt(1, dtype="float32")
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, model.vocab_size, size=150).astype(np.int32)
    ref = cached_generate(model, torch.tensor(prompt[None], device="cuda"),
                          max_new_tokens=32)[0, prompt.size:].tolist()
    for spec_k in (0, 4):
        eng = InferenceEngine(model, num_slots=2, page_size=16, max_len=256,
                              chunk_pages=2, prefix_cache=True,
                              spec_k=spec_k)
        req = Request(prompt, max_new_tokens=32)
        eng.run([req])
        eng.audit_pages()
        check(req.token_ids == ref,
              f"spec_k={spec_k}: engine tokens {req.token_ids} != "
              f"cached_generate {ref}")
        check(spec_k == 0 or eng.spec_steps > 0,
              "spec_k=4 parity run never verified a draft")
        counts = (eng.decode_trace_count, eng.verify_trace_count)
        check(counts == (int(eng.decode_steps > eng.spec_steps),
                         int(eng.spec_steps > 0)),
              f"spec_k={spec_k}: programs built {counts}")
        check({k for k, _ in eng.prefill_trace_counts} == {"chunk"} and
              set(eng.prefill_trace_counts.values()) == {1},
              f"spec_k={spec_k}: prefill programs built "
              f"{eng.prefill_trace_counts}")
        print(f"[parity] f32 gpt_small spec_k={spec_k}: engine == "
              f"cached_generate over {len(ref)} greedy tokens "
              f"({eng.decode_steps} steps, {eng.spec_steps} speculative, "
              f"accept rate {eng.accept_rate:.3f}; through the step "
              f"graphs: decode / verify captured {counts}; through the "
              f"chunk graphs: {eng.prefill_trace_counts})", flush=True)
        del eng
    del model
    torch.cuda.empty_cache()


def phase_graph_tests():
    """The step programs' ``cuda`` tests in a pytest subprocess without
    the repository's conftest, so it imports no JAX (the subprocess fails
    if JAX or the JAX package was imported): the serving engine's
    (tests/test_torch_serve_graphs.py: replay == body bitwise, builds
    touch no live page, launch accounting, one capture per width through
    stalls and a quarantine; tests/test_torch_page_graphs.py: the page
    gather and promotion programs and warm start) and the train step's
    (tests/test_torch_train_graphs.py: replay == eager body bitwise with
    dropout from a registered generator, two alternating signatures, flash
    launches per replay, a NaN batch through a replay, a failed capture
    raising; tests/test_torch_gpt_graphs.py: a GPT causal step's replay
    == its eager body, and remat replays equal to no remat's bitwise) and
    the symbolic Executor's (tests/test_torch_symbol_graphs.py: a train
    replay == its eager body bitwise, one capture per signature, outputs
    that later replays leave alone, grad_req add, dropout from the
    registered generator, a host-reading op failing its capture) and the
    accumulation step's (tests/test_torch_microbatch_graphs.py: rounds of
    1, 4 and 4 replayed from one capture == the eager body bitwise, a NaN
    round through a replay skipped bitwise, ImageRecordIter normalizing
    on the card as numpy does and staging batches on its thread while the
    step graph is captured)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    run = ("import sys, pytest\n"
           "rc = int(pytest.main(sys.argv[1:]))\n"
           "jax = {'jax', 'incubator_mxnet_tpu'} & set(sys.modules)\n"
           "print('imported', sorted(jax)) if jax else None\n"
           "sys.exit(rc or (3 if jax else 0))\n")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", run, "-q", "--noconftest", "-m", "cuda",
         "-p", "no:cacheprovider", "-W",
         "ignore::pytest.PytestUnknownMarkWarning",
         "tests/test_torch_serve_graphs.py",
         "tests/test_torch_page_graphs.py",
         "tests/test_torch_train_graphs.py",
         "tests/test_torch_gpt_graphs.py",
         "tests/test_torch_symbol_graphs.py",
         "tests/test_torch_detection_graphs.py",
         "tests/test_torch_microbatch_graphs.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    print(f"[graphs] cuda tests: {tail[0]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(proc.returncode == 0 and "skipped" not in tail[0],
          f"step-graph cuda tests failed:\n{proc.stdout[-6000:]}"
          f"{proc.stderr[-3000:]}")


# --------------------------------------------------------------------- #
# flash attention and BERT pretraining
# --------------------------------------------------------------------- #

def flash_inputs(torch, gen, B, H, Tq, Tk, D, lens, dtype):
    mk = lambda T: torch.randn(B, H, T, D, generator=gen,
                               device="cuda").to(dtype)
    q, k, v, do = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, do, vl


def flash_run(torch, fa, q, k, v, do, vl, causal):
    """The forward, dq (which writes Δ) and dk/dv launches on these
    inputs: (out, lse, dq, delta, dk, dv), synchronized."""
    out, lse = fa._flash_fwd_cuda(q, k, v, vl, causal, None)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, vl, do, out, lse, causal,
                                      None)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, vl, do, lse, delta, causal,
                                    None)
    torch.cuda.synchronize()
    return out, lse, dq, delta, dk, dv


FLASH_OUTPUTS = ("out", "lse", "dq", "delta", "dk", "dv")


def compare_flash(torch, fa, q, k, v, do, vl, causal, what, err):
    """Run the three flash kernels and their plain versions on the same
    inputs and hold them together (FLASH_TOL); folds each kernel's
    largest |difference| into ``err``."""
    dt_name = str(q.dtype).removeprefix("torch.")
    atol, rtol, gfrac, gfloor = FLASH_TOL[dt_name]
    what = f"{dt_name} {what}"
    out, lse, dq, delta, dk, dv = flash_run(torch, fa, q, k, v, do, vl,
                                            causal)
    ro, rl = fa.dense_attn_lse(q, k, v, vl, causal)
    grads = fa.dense_attn_bwd(q, k, v, vl, ro, rl, do, causal)
    torch.cuda.synchronize()
    # the dq launch's Δ against attn_delta on the same out: f32 sums of D
    # terms in two orders (bf16 products exact in f32; f32 products
    # rounded once each), so within 2 D 2^-24 sum |dO O| of each other
    ref_delta = fa.attn_delta(out, do)
    dtol = DELTA_ULPS * q.shape[-1] * 2.0 ** -24 * \
        (do.float().abs() * out.float().abs()).sum(dim=-1)
    dd = (delta - ref_delta).abs()
    worst = float((dd / dtol.clamp(min=1e-30)).max()) if dd.numel() else 0.0
    print(f"[flash] flash_bwd_dq delta {what}: max|err| "
          f"{float(dd.max()) if dd.numel() else 0.0:.3e}, worst |err| / "
          f"tolerance {worst:.3f}", flush=True)
    check(bool((dd <= dtol).all()), f"flash_bwd_dq {what}: the delta it "
                                    f"writes disagrees with attn_delta "
                                    f"({worst:.2f} x its tolerance)")
    live = rl > -1e29
    check(bool((lse[~live] == -1e30).all()) and
          bool((out.float()[~live] == 0).all()),
          f"flash_fwd {what}: a fully masked row is not zero with lse -1e30")
    diffs = [("flash_fwd", "out", out, ro,
              atol + rtol * ro.float().abs()),
             ("flash_fwd", "lse", lse[live], rl[live],
              atol + rtol * rl[live].abs())]
    for name, part, g, r in (("flash_bwd_dq", "dq", dq, grads[0]),
                             ("flash_bwd_dkv", "dk", dk, grads[1]),
                             ("flash_bwd_dkv", "dv", dv, grads[2])):
        scale = r.float().abs().amax(dim=(2, 3), keepdim=True)
        diffs.append((name, part, g, r, gfrac * scale.clamp(min=gfloor)))
    for name, part, g, r, tol in diffs:
        check(bool(torch.isfinite(g).all()),
              f"{name} {what}: non-finite {part}")
        d = (g.float() - r.float()).abs()
        e = float(d.max()) if d.numel() else 0.0
        worst = float((d / tol).max()) if d.numel() else 0.0
        err[name] = max(err[name], e)
        print(f"[flash] {name} {part} {what}: max|err| {e:.3e}, worst "
              f"|err| / tolerance {worst:.3f}", flush=True)
        check(worst <= 1.0, f"{name} {what}: {part} disagrees with its "
                            f"plain version (max |err| {e:.3e}, "
                            f"{worst:.2f} x its tolerance)")
    del out, lse, dq, dk, dv, ro, rl, grads, delta, ref_delta
    torch.cuda.empty_cache()


def phase_flash_kernels(torch):
    """The three flash kernels against their plain versions on identical
    inputs; returns the largest |difference| per kernel."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    err = {k: 0.0 for k in FLASH}
    cases = [(dt, c) for dt in (torch.float32, torch.bfloat16)
             for c in FLASH_CASES]
    cases += [(torch.bfloat16, c) for c in FLASH_CAUSAL_BF16]
    for dt, (B, H, Tq, Tk, D, lens, causal) in cases:
        q, k, v, do, vl = flash_inputs(torch, gen, B, H, Tq, Tk, D, lens,
                                       dt)
        compare_flash(torch, fa, q, k, v, do, vl, causal,
                      f"B={B} H={H} Tq={Tq} Tk={Tk} D={D} "
                      f"lengths={lens} causal={causal}", err)
        del q, k, v, do, vl
    # two launches of each kernel bitwise equal (every output element is
    # owned by one block: no atomics), causal and not
    for causal in (False, True):
        args = flash_inputs(torch, gen, 3, 5, 576, 576, 64, [576, 300, 1],
                            torch.bfloat16)
        runs = [flash_run(torch, fa, *args, causal) for _ in range(2)]
        for name, a, b in zip(FLASH_OUTPUTS, *runs):
            check(bool(torch.equal(a, b)),
                  f"flash bf16 B=3 H=5 T=576 causal={causal}: two launches "
                  f"give different {name}")
        del args, runs
    print("[flash] two launches bitwise equal (bf16, D=64, B=3 H=5 T=576, "
          "causal and not): out, lse, dq, delta, dk, dv", flush=True)
    # NaN in the K and V rows at or past valid_len (not only past Tk, where
    # TMA zero-fills): bf16 D=64, every output bitwise as with finite rows
    for T in (37, 200, 512):
        for causal in (False, True):
            lens = [T, T // 2 + 3, 1, 0]
            q, k, v, do, vl = flash_inputs(torch, gen, len(lens), 12, T, T,
                                           64, lens, torch.bfloat16)
            dead = (torch.arange(T, device="cuda")[None, :] >=
                    vl.long()[:, None])[:, None, :, None].expand_as(k)
            nan = torch.full_like(k, float("nan"))
            runs = [flash_run(torch, fa, q, kk, vv, do, vl, causal)
                    for kk, vv in ((k, v), (torch.where(dead, nan, k),
                                            torch.where(dead, nan, v)))]
            for name, a, b in zip(FLASH_OUTPUTS, *runs):
                check(bool(torch.equal(a, b)),
                      f"flash bf16 T={T} causal={causal}: NaN past "
                      f"valid_len changed {name}")
            del q, k, v, do, vl, runs
    print("[flash] NaN in K/V past valid_len (bf16, D=64, T=37/200/512, "
          "causal and not): out, lse, dq, delta, dk, dv unchanged",
          flush=True)
    return err


def bert_batch(torch, np, rng, B, T, M, vocab, min_len, ctx=None):
    """The bench's batch tuple as ``nd.array``s (int32 indices, f32
    weights; on ``ctx``, the card by default): valid lengths drawn in
    [min_len, T] and M distinct masked positions inside each length."""
    from incubator_mxnet_tpu_torch import nd
    lens = rng.randint(min_len, T + 1, size=B)
    pos = np.stack([rng.choice(n, size=M, replace=False) for n in lens])
    arrays = (rng.randint(0, vocab, (B, T)), rng.randint(0, 2, (B, T)),
              lens, pos, rng.randint(0, vocab, (B, M)),
              np.ones((B, M), np.float32), rng.randint(0, 2, (B,)))
    return [nd.array(a, ctx=ctx, dtype="float32" if a.dtype == np.float32
                     else "int32") for a in arrays]


def tensors(batch):
    """The tensors of a batch of ``NDArray``s (what a step program
    stages)."""
    return [b._data for b in batch]


def bench_bert(seed, T, dtype="bfloat16", size="base", ctx=None,
               dropout=0.1):
    """bench.py's ``_run_bert`` model, through the same calls:
    ``mx.random.seed``, ``bert_base(dtype=, max_length=, flash=,
    remat=, dropout=)``, ``initialize()``, ``BERTForPretraining``,
    ``initialize()`` (on ``ctx``: the card by default)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    mx.random.seed(seed)
    ctor = bert_mod.bert_base if size == "base" else bert_mod.bert_tiny
    model = ctor(dtype=dtype, max_length=T, flash=True, remat=False,
                 dropout=dropout)
    model.initialize(ctx=ctx)
    pre = bert_mod.BERTForPretraining(model)
    pre.initialize(ctx=ctx)
    return pre


def bert_trainer(torch, T, seed, dtype="bfloat16", size="base", ctx=None,
                 dropout=0.1, lr=1e-4):
    from incubator_mxnet_tpu_torch import models, parallel
    pre = bench_bert(seed, T, dtype=dtype, size=size, ctx=ctx,
                     dropout=dropout)
    tr = parallel.SPMDTrainer(
        pre, forward_loss=models.pretraining_loss, optimizer="lamb",
        optimizer_params={"learning_rate": lr,
                          "multi_precision": dtype != "float32"},
        sharding="replicated")
    return pre, tr


def phase_training(torch, device_name):
    """The bench configuration: bert_base bf16 through SPMDTrainer with
    LAMB; returns its stats (with the flash launch counts of its run)
    and the batch's valid lengths."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.utils import flops
    import incubator_mxnet_tpu_torch as mx
    B, T, M = BERT["B"], BERT["T"], BERT["M"]
    pre, tr = bert_trainer(torch, T, 0)
    bert = pre.bert
    batch = bert_batch(torch, np, np.random.RandomState(0), B, T, M,
                       bert.vocab_size, 256)

    def step():
        mx.random.seed(1)         # a repeating batch: its dropout masks too
        return tr.step(*batch)

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    losses = [float(step()) for _ in range(BERT["warmup"])]
    # the step graph was built inside the warm-up: the timed steps replay
    check(tr.step_trace_count == 1 and len(tr._programs) == 1,
          f"training: {tr.step_trace_count} step programs built in the "
          f"warm-up")
    prog = next(iter(tr._programs.values()))
    replays = prog.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step() for _ in range(BERT["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    losses += [float(x) for x in timed]
    n_steps = BERT["warmup"] + BERT["steps"]
    check(all(np.isfinite(losses)), f"training: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"training: loss did not fall over {n_steps} steps: {losses}")
    check(tr.step_count == n_steps, f"training: {tr.step_count} of "
                                    f"{n_steps} steps applied")
    check(tr.step_trace_count == 1 and
          prog.replays - replays == BERT["steps"],
          f"training: {prog.replays - replays} of {BERT['steps']} timed "
          f"steps replayed, {tr.step_trace_count} builds")
    for name in FLASH:
        check(launches[name] == bert.num_layers * n_steps,
              f"training: {name} launches {launches[name]} != "
              f"{bert.num_layers} layers x {n_steps} steps")
    print(f"[capture] training: step_trace_count {tr.step_trace_count}, "
          f"eager first step {prog.first_ms:.1f} ms, capture "
          f"{prog.build_ms:.1f} ms, replays {prog.replays}", flush=True)
    step_flops = flops.bert_train_flops(B, T, M, bert.num_layers,
                                        bert.units, bert.hidden_size,
                                        bert.vocab_size)
    ms_step = dt * 1e3 / BERT["steps"]
    lens = batch[2].asnumpy().tolist()
    stats = dict(config=f"bert_base bf16 flash dropout=0.1 LAMB lr=1e-4 "
                        f"multi_precision B={B} T={T} M={M}",
                 losses=losses, ms_per_step=ms_step,
                 tokens_per_s=B * T / (ms_step / 1e3),
                 live_tokens_per_s=sum(lens) / (ms_step / 1e3),
                 flops_per_step=step_flops,
                 mfu=step_flops / (ms_step / 1e3) /
                 flops.peak_flops(device_name),
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                 peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                 step_trace_count=tr.step_trace_count,
                 first_step_ms=prog.first_ms, capture_ms=prog.build_ms,
                 launches=launches)
    train_host_costs(torch, tr, prog, tensors(batch))
    # what the graph removed: the guarded LAMB apply over every parameter
    # run eagerly, op by op (host clock around it, synchronised)
    params = [tr._params[i] for i in tr._train_idx]
    zeros = [torch.zeros_like(p) for p in params]
    one = torch.ones((), device="cuda")
    lr = torch.full((), 1e-4, device="cuda")
    opt_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr._apply(zeros, one, lr, one)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t1) * 1e3)
    stats["eager_apply_ms"] = statistics.median(opt_ms)
    stats["n_params"] = len(params)
    # one profiled step: device-busy share and the attention kernels' part
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if kern:
        busy = sum(t for _, t in kern) / 1e3
        attn = {n: sum(t for k, t in kern
                       if re.search(rf"mxt::{n}_([mt]ma_)?kernel", k)) / 1e3
                for n in FLASH}
        stats.update(profiled_wall_ms=wall_ms, device_busy_ms=busy,
                     device_busy_share=busy / wall_ms,
                     attention_ms=attn,
                     attention_share_of_busy=sum(attn.values()) / busy,
                     top=[(k[:60], t / 1e3) for k, t in
                          sorted(kern, key=lambda kt: -kt[1])[:8]])
    else:
        stats["device_busy_share"] = "not measured (no kernel traced)"
    print(f"[training] {json.dumps(stats)}", flush=True)
    del tr, pre, bert, batch, params, zeros, prog
    torch.cuda.empty_cache()
    return stats, lens


def train_host_costs(torch, tr, prog, batch):
    """Host time of a replayed train step's own work (medians of 10, the
    device idle before each): staging the batch (device to device) and
    t / lr / scale (one copy), the launch (one replay), and the readback
    of loss and flag (one 8-byte transfer), once with the device idle and
    once right after the launch (then it waits for the step). Each replay
    applies an update, outside the step count."""
    def host_ms(before, fn, n=10):
        times = []
        for _ in range(n):
            before()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        return statistics.median(times)

    import incubator_mxnet_tpu_torch as mx

    def stage():
        mx.random.seed(1)
        prog.stage(batch, tr.step_count + 1, tr.learning_rate, 1.0)

    def staged_replay():
        stage()
        prog.replay()

    out = dict(stage_ms=host_ms(lambda: None, stage),
               launch_ms=host_ms(stage, prog.replay),
               readback_idle_ms=host_ms(staged_replay, prog.read),
               readback_after_launch_ms=host_ms(stage, lambda: (
                   prog.replay(), prog.read())))
    print(f"[host] graphed train step (bert_base bf16 B={BERT['B']} "
          f"T={BERT['T']}): {json.dumps(out)}", flush=True)


def phase_long_sequence(torch):
    """bert_base at T=1024 (B=4, 2 steps): the lengths the JAX package
    sends to its streaming kernels; the same three kernels here."""
    import numpy as np
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    T = 1024
    pre, tr = bert_trainer(torch, T, 5)
    batch = bert_batch(torch, np, np.random.RandomState(5), 4, T,
                       BERT["M"], pre.bert.vocab_size, 512)
    fa.reset_launch_counts()
    losses = [float(tr.step(*batch)) for _ in range(2)]
    launches = dict(fa.LAUNCHES)
    check(all(np.isfinite(losses)), f"T=1024: non-finite loss {losses}")
    for name in FLASH:
        check(launches[name] == 2 * pre.bert.num_layers,
              f"T=1024: {name} launches {launches[name]}")
    replays = [p.replays for p in tr._programs.values()]
    check(tr.step_trace_count == 1 and replays == [1],
          f"T=1024: {tr.step_trace_count} builds, replays {replays}")
    print(f"[long] bert_base bf16 T=1024 B=4 lengths "
          f"{batch[2].asnumpy().tolist()}: losses {losses} (the second a replay of "
          f"the step graph), launches {launches}", flush=True)
    del tr, pre, batch
    torch.cuda.empty_cache()


# bert_tiny on the card against the port on the CPU: loss-sequence rtol;
# bf16 also each parameter's first-step gradient, |err| <= frac x that
# parameter's largest |CPU gradient|
BERT_PARITY_TOL = {"float32": (1e-4, None), "bfloat16": (2e-3, 5e-2)}


def phase_bert_parity(torch):
    """bert_tiny, 5 LAMB steps: the card (the flash kernels) against the
    port on the CPU (their plain versions), the same weights and batch,
    dropout 0. In f32 the kernels run their CUDA-core bodies; in bf16
    (D=64) the mma.sync bodies that bert_base trains on, so bf16 also
    holds every parameter's gradient of the first step."""
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    T, B, M, steps = 128, 8, 20, 5
    for dtype in ("float32", "bfloat16"):
        rtol, gfrac = BERT_PARITY_TOL[dtype]
        cpu_pre, cpu_tr = bert_trainer(
            torch, T, 7, dtype=dtype, size="tiny", ctx=mx.cpu(),
            dropout=0.0, lr=1e-3)
        gpu_pre, gpu_tr = bert_trainer(torch, T, 7, dtype=dtype,
                                       size="tiny", dropout=0.0, lr=1e-3)
        gpu_pre.load_state_dict(cpu_pre.state_dict())
        batch = bert_batch(torch, np, np.random.RandomState(7), B, T, M,
                           cpu_pre.bert.vocab_size, 32)
        cpu_batch = [b.as_in_context(mx.cpu()) for b in batch]
        if gfrac is not None:
            one = torch.ones((), device="cuda")
            _, g_card = gpu_tr._forward_backward(tensors(batch), one)
            _, g_cpu = cpu_tr._forward_backward(tensors(cpu_batch),
                                                one.cpu())
            worst = (0.0, "")
            for i, a, b in zip(cpu_tr._train_idx, g_card, g_cpu):
                name = cpu_tr._names[i]
                check(a.dtype == b.dtype and bool(torch.isfinite(a).all()),
                      f"bert_tiny {dtype}: gradient of {name} is "
                      f"{a.dtype}, finite {bool(torch.isfinite(a).all())}")
                d = float((a.cpu().float() - b.float()).abs().max())
                scale = float(b.float().abs().max())
                r = d / (gfrac * scale) if scale > 0 else \
                    (0.0 if d == 0 else float("inf"))
                worst = max(worst, (r, name))
            print(f"[bert-parity] bert_tiny {dtype} first-step gradients, "
                  f"{len(g_cpu)} parameters: worst |err| / tolerance "
                  f"{worst[0]:.3f} ({worst[1]}; tolerance {gfrac} x the "
                  f"parameter's largest |gradient|)", flush=True)
            check(worst[0] <= 1.0, f"bert_tiny {dtype}: the card's gradient "
                                   f"of {worst[1]} disagrees with the CPU's "
                                   f"({worst[0]:.2f} x its tolerance)")
            del g_card, g_cpu
        fa.reset_launch_counts()
        on_card = [float(gpu_tr.step(*batch)) for _ in range(steps)]
        launches = dict(fa.LAUNCHES)
        replays = [p.replays for p in gpu_tr._programs.values()]
        check(gpu_tr.step_trace_count == 1 and replays == [steps - 1],
              f"bert_tiny {dtype}: {gpu_tr.step_trace_count} builds, "
              f"replays {replays}")
        on_cpu = [float(cpu_tr.step(*cpu_batch)) for _ in range(steps)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(on_card, on_cpu))
        print(f"[bert-parity] bert_tiny {dtype} LAMB: card {on_card} "
              f"(steps 2-{steps} replays of the step graph) vs cpu "
              f"{on_cpu}: max rel diff {rel:.3e} (rtol {rtol}), launches "
              f"{launches}", flush=True)
        check(rel <= rtol,
              f"bert_tiny {dtype} parity: card {on_card} vs cpu {on_cpu}")
        check(all(launches[n] == gpu_pre.bert.num_layers * steps
                  for n in FLASH),
              f"bert_tiny {dtype} parity: launches {launches}")
        check(all(np.isfinite(on_card)) and on_card[-1] < on_card[0],
              f"bert_tiny {dtype}: loss did not fall on the card {on_card}")
        del cpu_pre, cpu_tr, gpu_pre, gpu_tr, batch, cpu_batch
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# the MXNet front end on the card
# --------------------------------------------------------------------- #

GLUON = dict(B=32, T=512, M=76, steps=10, warmup=3)
# the gluon Trainer's first step against SPMDTrainer's, dropout off: the
# loss at rtol, every updated weight within this fraction of its tensor's
# largest |entry| (one bf16 rounding is 2^-8 of it)
GLUON_PARITY = dict(loss_rtol=2e-4, weight_frac=2 ** -7)


def gluon_drive(torch, np):
    """The verify drive (``.claude/skills/verify/SKILL.md`` steps 1-5)
    with ``incubator_mxnet_tpu_torch as mx`` on the card: nd arithmetic,
    a hand-computed gradient, HybridSequential(Dense, Activation, Dense)
    + SoftmaxCrossEntropyLoss + gluon.Trainer("sgd") for 30 steps eager
    and hybridized, and save / load_parameters in both formats."""
    import tempfile
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    a = nd.array([[1, 2], [3, 4]])
    check(a.context == mx.gpu(0) and a._data.is_cuda,
          f"gluon drive: nd.array on {a.context}, not the card")
    b = (a * 2 + 1) / 2 - a
    check(np.array_equal(b.asnumpy(), np.full((2, 2), 0.5, np.float32)),
          f"gluon drive: arithmetic gave {b.asnumpy()}")
    x = nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x * x).sum()
    y.backward()
    check(np.allclose(x.grad.asnumpy(), [3.0, 12.0, 27.0], rtol=1e-6),
          f"gluon drive: d(x^3)/dx = {x.grad.asnumpy()}")
    rng = np.random.RandomState(0)
    X = rng.randn(256, 20).astype(np.float32)
    Y = (X @ rng.randn(20, 4)).argmax(1).astype(np.float32)
    Xn, Yn = nd.array(X), nd.array(Y)
    runs = {}
    for hybrid in (False, True):
        mx.random.seed(0)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(64), gluon.nn.Activation("relu"),
                gluon.nn.Dense(4))
        net.initialize(mx.init.Xavier())
        if hybrid:
            net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5}, kvstore="device")
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for _ in range(30):
            with autograd.record():
                L = loss_fn(net(Xn), Yn)
            L.backward()
            tr.step(X.shape[0])
            losses.append(float(L.mean().asscalar()))
        progs = list(tr._fused._programs.values())
        check(losses[-1] < 0.7 * losses[0],
              f"gluon drive (hybridize={hybrid}): loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, not below 0.7x")
        check(tr._fused.trace_count == 1 and tr._fused.call_count == 30 and
              all(p.graph is not None for p in progs),
              f"gluon drive: {tr._fused.trace_count} applier captures, "
              f"{tr._fused.call_count} calls")
        if hybrid:
            check(len(net._cached_op._cache) == 1,
                  f"gluon drive: {len(net._cached_op._cache)} cached "
                  f"signatures")
        runs[hybrid] = (net, losses)
    net, losses = runs[True]
    rel = max(abs(a - b) / b for a, b in zip(losses, runs[False][1]))
    out = net(Xn).asnumpy()
    same = {}
    with tempfile.TemporaryDirectory() as d:
        for fmt in ("mxtpu", "mxnet"):
            path = os.path.join(d, f"net.{fmt}")
            net.save_parameters(path, format=fmt)
            net2 = gluon.nn.HybridSequential()
            net2.add(gluon.nn.Dense(64), gluon.nn.Activation("relu"),
                     gluon.nn.Dense(4))
            net2.load_parameters(path, ctx=mx.gpu(0))
            same[fmt] = bool(np.array_equal(net2(Xn).asnumpy(), out))
    check(all(same.values()), f"gluon drive: outputs after the save / load "
                              f"round trip bitwise {same}")
    print(f"[gluon] verify drive on the card: x^3 gradient ok; 30 SGD "
          f"steps eager {runs[False][1][0]:.4f} -> {runs[False][1][-1]:.4f},"
          f" hybridized {losses[0]:.4f} -> {losses[-1]:.4f} (max rel diff "
          f"{rel:.2e}), one applier capture each; save/load bitwise "
          f"{same}", flush=True)


def gluon_state(trainer, pre):
    """Copies of every parameter and optimizer-state tensor of a gluon
    Trainer."""
    from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
    return [p.detach().clone() for p in pre.parameters()] + [
        x.clone() for s in trainer._updaters[0].states.values()
        for x in tree_leaves(s)]


def phase_gluon(torch, device_name):
    """bert_base bf16 trained through MXNet user code on the card
    (``autograd.record()``, ``loss.backward()``, ``gluon.Trainer`` with
    LAMB and f32 masters, its update two captured group programs and one
    all-finite program), then its first step against SPMDTrainer's with
    dropout off, and a skipped step."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
    from incubator_mxnet_tpu_torch.train import StepOutcome
    from incubator_mxnet_tpu_torch.utils import flops
    t_phase = time.perf_counter()
    gluon_drive(torch, np)
    B, T, M = GLUON["B"], GLUON["T"], GLUON["M"]
    opt = {"learning_rate": 1e-4, "multi_precision": True}
    pre = bench_bert(0, T)
    bert = pre.bert
    batch = bert_batch(torch, np, np.random.RandomState(0), B, T, M,
                       bert.vocab_size, 256)
    trainer = gluon.Trainer(pre.collect_params(), "lamb", dict(opt))
    app = trainer._fused
    issue = {"forward": [], "backward": []}

    def step():
        mx.random.seed(1)         # a repeating batch: its dropout masks too
        t0 = time.perf_counter()
        with autograd.record():
            L = bert_mod.pretraining_loss(pre, *batch)
        t1 = time.perf_counter()
        L.backward()
        t2 = time.perf_counter()
        trainer.step(1)
        issue["forward"].append((t1 - t0) * 1e3)
        issue["backward"].append((t2 - t1) * 1e3)
        return L

    def counts():
        return (app.trace_count, app.guard_trace_count,
                app.accum_trace_count)

    torch.cuda.synchronize()
    fa.reset_launch_counts()
    losses = [float(step().asscalar())]
    first = counts()
    losses += [float(step().asscalar()) for _ in range(GLUON["warmup"] - 1)]
    check(first == (2, 1, 0) and counts() == first,
          f"gluon: applier captures {first} after the first step, "
          f"{counts()} after the warm-up (want 2 groups and one guard, as "
          f"the JAX Trainer traces for bert_base)")
    issue = {"forward": [], "backward": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step() for _ in range(GLUON["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    losses += [float(x.asscalar()) for x in timed]
    n_steps = GLUON["warmup"] + GLUON["steps"]
    check(all(np.isfinite(losses)), f"gluon: non-finite loss {losses}")
    check(counts() == first, f"gluon: applier captures moved to "
                             f"{counts()} in the timed steps")
    check(trainer.last_outcome is StepOutcome.APPLIED and
          trainer.health[StepOutcome.APPLIED.value] == n_steps,
          f"gluon: outcomes {trainer.health}")
    for name in FLASH:
        check(launches[name] == bert.num_layers * n_steps,
              f"gluon: {name} launches {launches[name]} != "
              f"{bert.num_layers} layers x {n_steps} steps")
    ms_step = dt * 1e3 / GLUON["steps"]
    step_flops = flops.bert_train_flops(B, T, M, bert.num_layers,
                                        bert.units, bert.hidden_size,
                                        bert.vocab_size)
    host_ms = statistics.median(issue["forward"]) + \
        statistics.median(issue["backward"])
    stats = dict(config=f"bert_base bf16 flash dropout=0.1 gluon.Trainer "
                        f"LAMB lr=1e-4 multi_precision B={B} T={T} M={M}",
                 losses=losses, ms_per_step=ms_step,
                 tokens_per_s=B * T / (ms_step / 1e3),
                 mfu=step_flops / (ms_step / 1e3) /
                 flops.peak_flops(device_name),
                 forward_issue_ms=statistics.median(issue["forward"]),
                 backward_issue_ms=statistics.median(issue["backward"]),
                 host_share=host_ms / ms_step,
                 applier_captures=dict(zip(
                     ("trace_count", "guard_trace_count",
                      "accum_trace_count"), first)),
                 applier_calls=app.call_count, launches=launches,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = [e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if kern:
        busy = sum(kern) / 1e3
        stats.update(profiled_wall_ms=wall_ms, device_busy_ms=busy,
                     device_busy_share=busy / wall_ms)
    else:
        stats["device_busy_share"] = "not measured (no kernel traced)"
    print(f"[gluon] {json.dumps(stats)}", flush=True)

    # a skipped step: one poisoned gradient; weights and optimizer state
    # bitwise, no capture count moves
    before = gluon_state(trainer, pre)
    at = counts()
    mx.random.seed(1)
    with autograd.record():
        L = bert_mod.pretraining_loss(pre, *batch)
    L.backward()
    poisoned = pre.bert.layer3.ffn_in.weight.grad()
    poisoned._data.view(-1)[7] = float("nan")
    trainer.step(1)
    after = gluon_state(trainer, pre)
    changed = sum(not torch.equal(x, y) for x, y in zip(before, after))
    check(trainer.last_outcome is StepOutcome.SKIPPED_NONFINITE and
          changed == 0 and counts() == at and app.skipped_steps == 1,
          f"gluon skipped step: outcome {trainer.last_outcome}, "
          f"{changed} tensors changed, captures {at} -> {counts()}")
    print(f"[gluon] skipped step: SKIPPED_NONFINITE, {len(after)} weight "
          f"and state tensors bitwise, captures {counts()}", flush=True)
    del trainer, pre, bert, timed, before, after
    torch.cuda.empty_cache()

    # dropout off: the gluon Trainer's first step against SPMDTrainer's
    pre_a = bench_bert(3, T, dropout=0.0)
    pre_b = bench_bert(3, T, dropout=0.0)
    pre_b.load_state_dict(pre_a.state_dict())
    gt = gluon.Trainer(pre_a.collect_params(), "lamb", dict(opt))
    st = SPMDTrainer(pre_b, forward_loss=bert_mod.pretraining_loss,
                     optimizer="lamb", optimizer_params=dict(opt),
                     sharding="replicated")
    with autograd.record():
        La = bert_mod.pretraining_loss(pre_a, *batch)
    La.backward()
    gt.step(1)
    Lb = st.step(*batch)
    la, lb = float(La.asscalar()), float(Lb.asscalar())
    worst = (0.0, "")
    want = pre_b.state_dict()
    for name, got in pre_a.state_dict().items():
        ref = want[name].float()
        d = float((got.float() - ref).abs().max())
        scale = float(ref.abs().max())
        worst = max(worst, (d / (GLUON_PARITY["weight_frac"] * scale)
                            if scale > 0 else float(d > 0), name))
    print(f"[gluon] first step, dropout 0: gluon.Trainer loss {la!r} vs "
          f"SPMDTrainer {lb!r} (rel {abs(la - lb) / abs(lb):.2e}, rtol "
          f"{GLUON_PARITY['loss_rtol']}); updated weights: worst |diff| / "
          f"tolerance {worst[0]:.3f} ({worst[1]}; tolerance "
          f"{GLUON_PARITY['weight_frac']} x the tensor's largest |entry|)",
          flush=True)
    check(abs(la - lb) <= GLUON_PARITY["loss_rtol"] * abs(lb),
          f"gluon vs SPMDTrainer first-step loss {la} vs {lb}")
    check(worst[0] <= 1.0, f"gluon vs SPMDTrainer: updated {worst[1]} "
                           f"differs ({worst[0]:.2f} x the tolerance)")
    del gt, st, pre_a, pre_b, batch, want
    torch.cuda.empty_cache()
    print(f"[gluon] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return stats


# --------------------------------------------------------------------- #
# convolutional vision training
# --------------------------------------------------------------------- #

VISION = dict(B=64, side=224, steps=10, warmup=3, classes=1000,
              gflop_per_image=4.1)
VISION_PARITY = dict(B=32, side=32, steps=3, loss_rtol=1e-4, scale=1e-3,
                     floor=1e-5)
VISION_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of the largest |ref|
# (name, op, input shapes, keywords)
VISION_OPS = [
    ("conv1d", "Convolution", [(4, 8, 37), (16, 8, 5), (16,)],
     dict(kernel=(5,), stride=(2,), pad=(2,), num_filter=16)),
    ("conv2d-dilate", "Convolution", [(4, 16, 29, 31), (32, 16, 3, 3),
                                      (32,)],
     dict(kernel=(3, 3), stride=(2, 1), dilate=(2, 2), pad=(2, 1),
          num_filter=32)),
    ("conv2d-256", "Convolution", [(8, 256, 14, 14), (256, 256, 3, 3)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=256, no_bias=True)),
    ("conv2d-groups", "Convolution", [(4, 32, 15, 15), (64, 8, 3, 3)],
     dict(kernel=(3, 3), pad=(1, 1), num_filter=64, num_group=4,
          no_bias=True)),
    ("conv2d-depthwise", "Convolution", [(4, 64, 28, 28), (64, 1, 3, 3)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=64,
          num_group=64, no_bias=True)),
    ("conv3d", "Convolution", [(2, 4, 9, 10, 11), (8, 4, 3, 3, 3), (8,)],
     dict(kernel=(3, 3, 3), stride=(1, 2, 2), pad=(1, 1, 1),
          num_filter=8)),
    ("deconv2d-adj", "Deconvolution", [(4, 16, 13, 13), (16, 8, 4, 4),
                                       (8,)],
     dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=8, no_bias=False)),
    ("max-valid-pad", "Pooling", [(8, 64, 112, 112)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")),
    ("max-full", "Pooling", [(4, 32, 7, 7)],
     dict(kernel=(3, 3), stride=(2, 2), pool_type="max",
          pooling_convention="full")),
    ("max-full-pad", "Pooling", [(4, 32, 7, 6)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
          pooling_convention="full")),
    ("avg-full-pad", "Pooling", [(4, 32, 7, 7)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention="full")),
    ("avg-full-exclude", "Pooling", [(4, 32, 7, 7)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention="full", count_include_pad=False)),
    ("avg-valid-exclude", "Pooling", [(4, 32, 7, 7)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          count_include_pad=False)),
    ("sum-full", "Pooling", [(4, 32, 9, 9)],
     dict(kernel=(2, 2), stride=(2, 2), pool_type="sum",
          pooling_convention="full")),
    ("global-avg", "Pooling", [(8, 2048, 7, 7)],
     dict(global_pool=True, pool_type="avg")),
    ("adaptive", "AdaptiveAvgPooling2D", [(4, 32, 13, 11)],
     dict(output_size=(3, 4))),
]


def _rel_err(torch, got, want):
    """max |got - want| over max |want|, in f64 on the host."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def vision_ops(torch, np):
    """Each VISION_OPS case on the card against the port on the CPU: f32
    forward and gradients, bf16 forward (its reference: the CPU on the
    bf16-rounded inputs in f32). cuDNN's f32 convolutions are left at
    torch's TF32 default here, so only the ops' own per-call setting
    keeps them IEEE f32; a direct F.conv2d on conv2d-256 is the
    control."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, nd
    conv = torch.backends.cudnn.conv
    old = conv.fp32_precision
    conv.fp32_precision = "tf32"
    worst = {}
    try:
        rng = np.random.RandomState(0)
        for name, op, shapes, kw in VISION_OPS:
            arrays = [rng.randn(*sh).astype(np.float32) for sh in shapes]
            fn = getattr(nd, op)
            res = {}
            for ctx in (mx.cpu(), mx.gpu(0)):
                xs = [nd.array(a, ctx=ctx) for a in arrays]
                for x in xs:
                    x.attach_grad()
                with autograd.record():
                    out = fn(*xs, **kw)
                    r = nd.array(np.random.RandomState(1).randn(
                        *out.shape).astype(np.float32), ctx=ctx)
                    (out * r).sum().backward()
                res[ctx.device_type] = [out._data] + [x.grad._data
                                                      for x in xs]
            errs = [_rel_err(torch, g, c)
                    for g, c in zip(res["gpu"], res["cpu"])]
            bf = [nd.array(a, ctx=mx.gpu(0)).astype("bfloat16")
                  for a in arrays]
            ref = fn(*[nd.array(b._data.float().cpu(), ctx=mx.cpu())
                       for b in bf], **kw)
            got = fn(*bf, **kw)
            check(str(got.dtype) == "bfloat16",
                  f"vision op {name}: bf16 in, {got.dtype} out")
            bf_err = _rel_err(torch, got._data, ref._data)
            check(max(errs) <= VISION_TOL["float32"],
                  f"vision op {name}: f32 card vs CPU (output, gradients) "
                  f"{errs} > {VISION_TOL['float32']}")
            check(bf_err <= VISION_TOL["bfloat16"],
                  f"vision op {name}: bf16 card vs CPU {bf_err:.2e} > "
                  f"{VISION_TOL['bfloat16']}")
            worst[name] = dict(f32=max(errs), bf16=bf_err)
        x = torch.tensor(rng.randn(8, 256, 14, 14).astype(np.float32))
        w = torch.tensor(rng.randn(256, 256, 3, 3).astype(np.float32))
        want = torch.nn.functional.conv2d(x, w, padding=1)
        control = _rel_err(torch, torch.nn.functional.conv2d(
            x.cuda(), w.cuda(), padding=1), want)
        port = _rel_err(torch, nd.Convolution(
            nd.array(x.numpy(), ctx=mx.gpu(0)),
            nd.array(w.numpy(), ctx=mx.gpu(0)), kernel=(3, 3), pad=(1, 1),
            num_filter=256, no_bias=True)._data, want)
    finally:
        conv.fp32_precision = old
    print(f"[vision] ops: {len(VISION_OPS)} cases card vs CPU, worst f32 "
          f"{max(v['f32'] for v in worst.values()):.2e}, bf16 "
          f"{max(v['bf16'] for v in worst.values()):.2e}; TF32 control: "
          f"F.conv2d {control:.2e}, nd.Convolution {port:.2e}", flush=True)
    return dict(worst=worst, tf32_control=control, port_under_tf32=port)


def vision_resnet50(torch, np, device_name):
    """bench.py's _run_resnet on the card: resnet50_v1 bf16 through
    SPMDTrainer with SGD, one CUDA graph."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, parallel
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.utils import flops
    B, side = VISION["B"], VISION["side"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(0)
    net = resnet50_v1()
    net.initialize()
    rng0 = np.random.RandomState(0)
    net(nd.array(rng0.rand(1, 3, side, side).astype("float32")))
    net.cast("bfloat16")
    rng = np.random.RandomState(0)
    x = nd.array(rng.rand(B, 3, side, side).astype("float32")) \
        .astype("bfloat16")
    y = nd.array(rng.randint(0, VISION["classes"], (B,)), dtype="int32")
    tr = parallel.SPMDTrainer(
        net, loss=gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                          "multi_precision": True},
        sharding="replicated")
    stats = {k: p for k, p in net._collect_params_with_prefix().items()
             if "running_" in k}
    before = {k: p.data()._data.clone() for k, p in stats.items()}
    losses = [float(tr.step(x, y).asnumpy())
              for _ in range(VISION["warmup"])]
    check(tr.step_trace_count == 1 and len(tr._programs) == 1,
          f"resnet50: {tr.step_trace_count} step programs built in the "
          f"warm-up")
    prog = next(iter(tr._programs.values()))
    replays = prog.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [tr.step(x, y) for _ in range(VISION["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [float(v.asnumpy()) for v in timed]
    n_steps = VISION["warmup"] + VISION["steps"]
    check(all(np.isfinite(losses)), f"resnet50: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"resnet50: loss did not fall over {n_steps} steps: {losses}")
    check(tr.step_count == n_steps and tr.step_trace_count == 1 and
          prog.replays - replays == VISION["steps"],
          f"resnet50: {tr.step_count} steps applied, "
          f"{prog.replays - replays} of {VISION['steps']} timed steps "
          f"replayed, {tr.step_trace_count} builds")
    moved = sum(not torch.equal(p.data()._data, before[k])
                for k, p in stats.items())
    finite = all(bool(torch.isfinite(p.data()._data).all())
                 for p in stats.values())
    check(moved == len(stats) and finite and len(stats) == 106,
          f"resnet50: {moved} of {len(stats)} running statistics moved, "
          f"finite {finite}")
    ms = dt * 1e3 / VISION["steps"]
    img_s = B / (ms / 1e3)
    out = dict(config=f"resnet50_v1 bf16 B={B} {side}x{side} SGD lr 0.1 "
                      f"momentum 0.9 multi_precision",
               losses=losses, ms_per_step=ms, img_per_s=img_s,
               mfu=img_s * 3 * VISION["gflop_per_image"] * 1e9
               / flops.peak_flops(device_name),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_step_ms=prog.first_ms, capture_ms=prog.build_ms,
               step_trace_count=tr.step_trace_count,
               replays=prog.replays)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        tr.step(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if kern:
        busy = sum(t for _, t, _ in kern) / 1e3
        layout = sum(t for k, t, _ in kern if re.search(
            r"nchwToNhwc|nhwcToNchw|[Tt]ranspose", k)) / 1e3
        # PyTorch's own kernels: BatchNorm's passes, casts, ReLU, the
        # residual adds, the SGD apply; the rest is cuDNN / cuBLAS
        aten = sum(t for k, t, _ in kern if "at::native" in k) / 1e3
        out.update(profiled_wall_ms=wall_ms, device_busy_ms=busy,
                   device_busy_share=busy / wall_ms,
                   layout_transpose_ms=layout,
                   layout_transpose_share_of_busy=layout / busy,
                   aten_elementwise_reduce_ms=aten,
                   aten_share_of_busy=aten / busy,
                   cudnn_cublas_ms=busy - aten - layout,
                   cudnn_cublas_share_of_busy=(busy - aten - layout)
                   / busy,
                   top=[(k[:90], round(t / 1e3, 3), n) for k, t, n in
                        sorted(kern, key=lambda e: -e[1])[:14]])
    else:
        out["device_busy_share"] = "not measured (no kernel traced)"
    print(f"[capture] resnet50: step_trace_count {tr.step_trace_count}, "
          f"eager first step {prog.first_ms:.1f} ms, capture "
          f"{prog.build_ms:.1f} ms, replays {prog.replays}", flush=True)
    del tr, net, x, y, prog, stats, before
    torch.cuda.empty_cache()
    return out


def vision_parity(torch, np):
    """resnet18_v1(thumbnail=True, classes=10) f32: SGD steps on the card
    against the port on the CPU from the same weights, cuDNN's f32
    convolutions left at torch's TF32 default (the ops set IEEE)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    from incubator_mxnet_tpu_torch.parallel import SPMDTrainer
    P = VISION_PARITY
    rng = np.random.RandomState(0)
    x = rng.rand(P["B"], 3, P["side"], P["side"]).astype(np.float32)
    y = rng.randint(0, 10, (P["B"],)).astype(np.int32)
    conv = torch.backends.cudnn.conv
    old = conv.fp32_precision
    conv.fp32_precision = "tf32"
    runs = {}
    try:
        state = None
        for ctx in (mx.cpu(), mx.gpu(0)):
            mx.random.seed(0)
            net = resnet18_v1(thumbnail=True, classes=10)
            net.initialize(ctx=ctx)
            net(nd.array(x, ctx=ctx))
            if state is None:
                state = {k: v.clone() for k, v in net.state_dict().items()}
            net.load_state_dict(state)
            tr = SPMDTrainer(net, loss=gloss.SoftmaxCrossEntropyLoss(),
                             optimizer="sgd",
                             optimizer_params={"learning_rate": 1e-3,
                                               "momentum": 0.9})
            xs, ys = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx,
                                                    dtype="int32")
            losses = [float(tr.step(xs, ys).asnumpy())
                      for _ in range(P["steps"])]
            runs[ctx.device_type] = (losses, {
                k: p.data()._data.detach().cpu() for k, p in
                net._collect_params_with_prefix().items()}, tr)
    finally:
        conv.fp32_precision = old
    (lc, pc, _), (lg, pg, trg) = runs["cpu"], runs["gpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    check(loss_err <= P["loss_rtol"],
          f"resnet18 card vs CPU: losses {lg} vs {lc}")
    check(trg.step_trace_count == 1 and
          next(iter(trg._programs.values())).replays == P["steps"] - 1,
          "resnet18 on the card: not one capture and replays")
    # a tensor within scale x its largest |entry| (a weight near 0 has no
    # relative precision of its own), or floor: a BatchNorm beta is a
    # sum with cancellation; after 3 steps one of 3.3e-4 is 6.7e-6 off
    # float64 in f32 (tools/torch_vision_conditioning.py float64)
    errs = {k: float((pg[k] - pc[k]).abs().max()) for k in pc}
    bad = {k: (e, float(pc[k].abs().max())) for k, e in errs.items()
           if e > P["scale"] * float(pc[k].abs().max()) + P["floor"]}
    check(not bad, f"resnet18 card vs CPU: {len(bad)} tensors past "
                   f"{P['scale']} x max + {P['floor']}: "
                   f"{sorted(bad.items())[:6]}")
    worst = max(errs[k] / float(pc[k].abs().max().clamp_min(1e-30))
                for k in pc)
    print(f"[vision] resnet18_v1 thumbnail f32 B={P['B']} card vs CPU: "
          f"losses {lg} vs {lc} (max rel {loss_err:.2e}); {len(pc)} "
          f"parameters and running statistics within {P['scale']} x "
          f"their largest |entry| + {P['floor']} (worst {worst:.2e} of "
          f"the largest)", flush=True)
    return dict(losses_card=lg, losses_cpu=lc, loss_rel_err=loss_err,
                worst_param_rel=worst)


def vision_lenet(torch, np):
    """BASELINE.md config #1 as users write it, on the card."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, metric
    from incubator_mxnet_tpu_torch.gluon.data.vision import (MNIST,
                                                             transforms)
    mx.random.seed(0)
    data = gluon.data.DataLoader(
        MNIST(synthetic=True).transform_first(transforms.ToTensor()),
        batch_size=64)
    net = mx.models.LeNet()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(3):
        acc.reset()
        for x, y in data:
            x = gluon.utils.split_and_load(x, [mx.gpu(0)])[0]
            y = gluon.utils.split_and_load(y, [mx.gpu(0)])[0]
            with autograd.record():
                out = net(x)
                L = loss_fn(out, y)
            L.backward()
            trainer.step(x.shape[0])
            acc.update(y, out)
            losses.append(L.mean())
    accuracy = acc.get()[1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v.asnumpy()) for v in losses]
    check(acc.sum_metric.is_cuda and out.context == mx.gpu(0),
          "lenet: the metric or the net is not on the card")
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    check(np.isfinite(losses).all() and last < 0.5 * first,
          f"lenet: loss {first:.4f} -> {last:.4f}, not below half")
    out = dict(batches=len(losses), batches_per_s=len(losses) / wall,
               loss_first20=first, loss_last20=last,
               last_epoch_accuracy=accuracy)
    print(f"[vision] lenet: {len(losses)} batches, loss {first:.4f} -> "
          f"{last:.4f}, accuracy {accuracy:.4f}, "
          f"{len(losses) / wall:.1f} batches/s", flush=True)
    return out


def phase_vision(torch, smi):
    """The vision slice on the card (module docstring, phase 7c)."""
    import numpy as np
    t0 = time.perf_counter()
    out = dict(card=smi, ops=vision_ops(torch, np),
               resnet50=vision_resnet50(torch, np,
                                        torch.cuda.get_device_name(0)),
               parity=vision_parity(torch, np), lenet=vision_lenet(torch, np))
    out["phase_s"] = time.perf_counter() - t0
    print(f"[vision] {json.dumps(out)}", flush=True)


# --------------------------------------------------------------------- #
# GPT causal-LM training and the WMT Transformer's beam search
# --------------------------------------------------------------------- #

def gpt_trainer(model, lr=1e-4):
    """bench.py ``_run_gpt``'s trainer: ``SPMDTrainer(forward_loss=
    lm_loss)``, AdamW, f32 masters for a bf16 model."""
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.models import gpt as gpt_mod
    return parallel.SPMDTrainer(
        model, forward_loss=gpt_mod.lm_loss, optimizer="adamw",
        optimizer_params={"learning_rate": lr,
                          "multi_precision": model._dtype != "float32"},
        sharding="replicated")


def busy_share(torch, fn, pattern=None):
    """One profiled call of ``fn``: wall ms, device-busy ms and share, the
    top device operations and (with ``pattern``, a regex over kernel
    names) that group's share of busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not kern:
        return dict(device_busy_share="not measured (no kernel traced)")
    busy = sum(t for _, t in kern) / 1e3
    out = dict(profiled_wall_ms=wall_ms, device_busy_ms=busy,
               device_busy_share=busy / wall_ms,
               top=[(k[:60], t / 1e3) for k, t in
                    sorted(kern, key=lambda kt: -kt[1])[:8]])
    if pattern is not None:
        group = sum(t for k, t in kern if re.search(pattern, k)) / 1e3
        out.update(group_ms=group, group_share_of_busy=group / busy)
    return out


def gpt_mini_parity(torch, np):
    """gpt_mini f32 (dropout 0, flash: the f32 kernel bodies on the card)
    from one set of weights on the card and on the CPU: 3 AdamW steps,
    the losses within 1e-5 relative; greedy_generate's tokens equal."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.models import gpt as gpt_mod

    def build(ctx, like=None):
        mx.random.seed(2)
        m = gpt_mod.gpt_mini(vocab_size=512, max_length=128, flash=True)
        m.initialize(ctx=ctx)
        if like is not None:
            m.load_state_dict(like.state_dict())
        return m

    rng = np.random.RandomState(3)
    X = rng.randint(0, 512, (8, 65))
    prompt = rng.randint(0, 512, (2, 16))
    cpu = build(mx.cpu())
    card = build(mx.gpu(0), like=cpu)
    gen_cpu = gpt_mod.greedy_generate(cpu, prompt, max_new_tokens=16)
    gen_card = gpt_mod.greedy_generate(card, prompt, max_new_tokens=16)
    losses = {}
    for name, m, ctx in (("card", card, mx.gpu(0)), ("cpu", cpu, mx.cpu())):
        tr = gpt_trainer(m, lr=1e-3)
        batch = [nd.array(a, ctx=ctx, dtype="int32")
                 for a in (X[:, :-1], X[:, 1:])]
        losses[name] = [float(tr.step(*batch).asnumpy()) for _ in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                  losses["cpu"]))
    same = bool((gen_cpu.asnumpy() == gen_card.asnumpy()).all())
    print(f"[gpt_training] gpt_mini f32 card vs CPU: losses {losses}, max "
          f"relative difference {rel:.3e}; greedy_generate tokens equal "
          f"{same}", flush=True)
    check(rel <= 1e-5, f"gpt_mini f32: card losses {losses['card']} vs "
                       f"CPU {losses['cpu']} (rel {rel:.2e} > 1e-5)")
    check(same, f"gpt_mini greedy_generate: card {gen_card.asnumpy()} != "
                f"CPU {gen_cpu.asnumpy()}")
    return dict(losses=losses, max_rel=rel, greedy_equal=same)


def phase_gpt_training(torch, smi):
    """bench.py ``_run_gpt``'s configuration: gpt_small bf16 (flash,
    dropout 0.1) through SPMDTrainer(forward_loss=lm_loss) with AdamW (lr
    1e-4, f32 masters), B=16, T=512, one repeating batch (its dropout
    masks too): 3 warm-up steps (the first eager, the capture after it)
    and 10 timed replays, each launching the causal flash forward, dq and
    dk/dv once a layer; beside it a trainer each with remat=True and
    "dots" (first-step loss, one capture, peak memory), and gpt_mini f32
    on the card against the CPU. Returns the run's stats, with the
    flash launch counts of the timed replays (counts set to 0 just
    before them)."""
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.utils import flops
    t_phase = time.perf_counter()
    B, T = GPT["B"], GPT["T"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = bench_gpt(0, flash=True, dropout=0.1)
    L, V = model.num_layers, model.vocab_size
    rng = np.random.RandomState(0)
    batch = [nd.array(rng.randint(0, V, (B, T)), ctx=mx.gpu(0),
                      dtype="int32") for _ in range(2)]
    tr = gpt_trainer(model)

    def step(trainer):
        mx.random.seed(1)         # a repeating batch: its dropout masks too
        return trainer.step(*batch)

    losses = [float(step(tr).asnumpy()) for _ in range(GPT["warmup"])]
    check(tr.step_trace_count == 1 and len(tr._programs) == 1,
          f"gpt_training: {tr.step_trace_count} step programs built in "
          f"the warm-up")
    prog = next(iter(tr._programs.values()))
    replays = prog.replays
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    timed = [step(tr) for _ in range(GPT["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES, **fa.CAUSAL_LAUNCHES)
    losses += [float(x.asnumpy()) for x in timed]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = GPT["warmup"] + GPT["steps"]
    check(all(np.isfinite(losses)), f"gpt_training: non-finite loss "
                                    f"{losses}")
    check(losses[-1] < losses[0],
          f"gpt_training: loss did not fall over {n_steps} steps: {losses}")
    check(tr.step_count == n_steps, f"gpt_training: {tr.step_count} of "
                                    f"{n_steps} steps applied")
    check(tr.step_trace_count == 1 and
          prog.replays - replays == GPT["steps"],
          f"gpt_training: {prog.replays - replays} of {GPT['steps']} "
          f"timed steps replayed, {tr.step_trace_count} builds")
    for name in FLASH:
        want = L * GPT["steps"]
        check(launches[name + "_causal"] == want == launches[name],
              f"gpt_training: {name} launches {launches[name]} (causal "
              f"{launches[name + '_causal']}) over {GPT['steps']} replays "
              f"!= {L} layers a replay")
    print(f"[capture] gpt_training: step_trace_count "
          f"{tr.step_trace_count}, eager first step {prog.first_ms:.1f} "
          f"ms, capture {prog.build_ms:.1f} ms, replays {prog.replays}",
          flush=True)
    step_flops = flops.gpt_train_flops(B, T, L, model.units,
                                       model.hidden_size, V)
    ms_step = dt * 1e3 / GPT["steps"]
    stats = dict(card=smi,
                 config=f"gpt_small bf16 flash dropout=0.1 AdamW lr=1e-4 "
                        f"multi_precision B={B} T={T}",
                 losses=losses, ms_per_step=ms_step,
                 tokens_per_s=B * T / (ms_step / 1e3),
                 flops_per_step=step_flops,
                 mfu=step_flops / (ms_step / 1e3) /
                 flops.peak_flops(torch.cuda.get_device_name(0)),
                 peak_memory_gb=peak_gb,
                 step_trace_count=tr.step_trace_count,
                 first_step_ms=prog.first_ms, capture_ms=prog.build_ms,
                 launches=launches)
    prof = busy_share(torch, lambda: step(tr),
                      r"mxt::flash_(fwd|bwd_dq|bwd_dkv)_([mt]ma_)?kernel")
    if "group_ms" in prof:
        prof["attention_ms"] = prof.pop("group_ms")
        prof["attention_share_of_busy"] = prof.pop("group_share_of_busy")
    stats.update(prof)
    first = losses[0]
    del tr, model, prog, timed
    gc.collect()
    torch.cuda.empty_cache()
    remat = {}
    for mode in (True, "dots"):
        torch.cuda.reset_peak_memory_stats()
        m = bench_gpt(0, flash=True, dropout=0.1, remat=mode)
        rt = gpt_trainer(m)
        rl = [float(step(rt).asnumpy()) for _ in range(3)]
        torch.cuda.synchronize()
        rprog = next(iter(rt._programs.values()))
        diff = abs(rl[0] - first)
        remat[str(mode)] = dict(
            losses=rl, first_loss_diff=diff,
            loss_diffs=[abs(a - b) for a, b in zip(rl, losses)],
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            step_trace_count=rt.step_trace_count,
            capture_ms=rprog.build_ms, replays=rprog.replays)
        check(rt.step_trace_count == 1 and rprog.replays == 2,
              f"gpt_training remat={mode!r}: {rt.step_trace_count} builds, "
              f"{rprog.replays} replays")
        check(all(np.isfinite(rl)) and diff <= 1e-2 * abs(first),
              f"gpt_training remat={mode!r}: first loss {rl[0]} vs "
              f"{first} without remat")
        del rt, m, rprog
        gc.collect()
        torch.cuda.empty_cache()
    stats["remat"] = remat
    print(f"[gpt_training] peak memory (GB): remat False {peak_gb:.2f}, "
          f"True {remat['True']['peak_memory_gb']:.2f}, dots "
          f"{remat['dots']['peak_memory_gb']:.2f}", flush=True)
    stats["parity"] = gpt_mini_parity(torch, np)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"[gpt_training] {json.dumps(stats)}", flush=True)
    return stats


def host_state(torch, tr):
    """A synchronous host copy of an SPMDTrainer's parameters and
    optimizer leaves (and the card's generator state), in capsule
    order."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
    torch.cuda.synchronize()
    out = {f"param/{i}": p.detach().to("cpu", copy=True)
           for i, p in enumerate(tr._params)}
    for i, st in enumerate(tr._opt_state):
        for j, leaf in enumerate(tree_leaves(st)):
            out[f"opt/{i}/{j}"] = leaf.to("cpu", copy=True)
    out["generator"] = mx.random.generator(tr.device).get_state()
    return out


def same_state(torch, want, tr):
    """Every parameter, optimizer leaf and the generator state of ``tr``
    bitwise ``want`` (a ``host_state``)."""
    got = host_state(torch, tr)
    return sorted(got) == sorted(want) and all(
        torch.equal(got[k], want[k]) for k in want)


def committed_equals(torch, np, arrays, want):
    """A committed step's ``param/`` and ``opt/`` entries bitwise the host
    copy ``want``."""
    from incubator_mxnet_tpu_torch.checkpoint.capsule import host_leaf
    keys = {k for k in want if k != "generator"}
    stored = {k for k in arrays if k.startswith(("param/", "opt/"))}
    return stored == keys and all(
        np.array_equal(arrays[k], host_leaf(want[k])[1]) for k in keys)


def target_run(tmp, tag, env_extra):
    """``train.example_target`` on the card under a ``train.Supervisor``;
    returns the report and the per-step loss map."""
    from incubator_mxnet_tpu_torch.train import Supervisor
    ckpt_dir = os.path.join(tmp, f"target_{tag}")
    results = os.path.join(tmp, f"target_{tag}.jsonl")
    os.makedirs(ckpt_dir)
    env = {"PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
           "MXTPU_TGT_CKPT_DIR": ckpt_dir, "MXTPU_TGT_RESULTS": results,
           "MXTPU_TGT_STEPS": "14", "MXTPU_TGT_SAVE_EVERY": "2"}
    env.update(env_extra)
    sup = Supervisor(
        [sys.executable, "-m",
         "incubator_mxnet_tpu_torch.train.example_target"],
        ckpt_dir=ckpt_dir, progress_file=results, max_restarts=4,
        backoff_s=0.05, env=env)
    report = sup.run(raise_on_failure=False)
    losses = {}
    if os.path.exists(results):
        with open(results) as f:
            for line in f:
                rec = json.loads(line)
                losses[rec["step"]] = rec["loss"]
    return report, losses


def checkpoint_supervisor(tmp):
    """The clean target run (in a thread) beside the one killed at steps
    5 and 9: two restarts, the per-step losses equal."""
    clean = {}
    th = threading.Thread(target=lambda: clean.update(
        zip(("report", "losses"), target_run(tmp, "clean", {}))))
    th.start()
    report, killed = target_run(tmp, "killed", {"MXTPU_TGT_KILL_AT": "5,9"})
    th.join(timeout=600)
    check(not th.is_alive() and "report" in clean and
          clean["report"].completed,
          f"checkpoint: the clean example_target run did not complete: "
          f"{clean.get('report') and clean['report'].summary()}")
    check(report.completed and report.restarts == 2,
          f"checkpoint: the killed example_target run: {report.summary()}")
    check(killed == clean["losses"] and sorted(killed) == list(range(14)),
          f"checkpoint: supervised losses {killed} != uninterrupted "
          f"{clean['losses']}")
    return dict(restarts=report.restarts,
                attempts=[a.reason for a in report.attempts],
                wall_s=report.total_wall_s, steps=len(killed))


def phase_checkpoint(torch, smi):
    """Checkpointing on gpt_small (see the module's docstring, 7f)."""
    import tempfile
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.checkpoint import CheckpointManager
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import ragged_attention as ra
    from incubator_mxnet_tpu_torch.serve import InferenceEngine, Request
    t_phase = time.perf_counter()
    B, T = GPT["B"], GPT["T"]
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mxt_ckpt_")
    sup_thread = None
    try:
        def trainer(seed):
            return gpt_trainer(bench_gpt(seed, flash=True, dropout=0.1))

        def steps(tr, idx):
            return [float(tr.step(*batches[i]).asnumpy()) for i in idx]

        # two uninterrupted runs: what "the same steps" give on this card
        ref_tr = trainer(0)
        V = ref_tr.block.vocab_size
        rng = np.random.RandomState(0)
        batches = [[nd.array(rng.randint(0, V, (B, T)), ctx=mx.gpu(0),
                             dtype="int32") for _ in range(2)]
                   for _ in range(8)]
        mx.random.seed(1)
        ref = steps(ref_tr, range(8))
        del ref_tr
        gc.collect()
        tr = trainer(0)
        mx.random.seed(1)
        losses = steps(tr, range(2))
        mgr = CheckpointManager(tmp + "/run", keep=3)
        tr.save_checkpoint(mgr, step=2)
        gather_cold_ms = mgr.last_gather_ms
        mgr.wait()
        losses += steps(tr, range(2, 4))
        at4 = host_state(torch, tr)
        saved = tr.save_checkpoint(mgr, step=4)
        gather_ms = mgr.last_gather_ms
        in_flight = 0
        for i in range(4, 8):
            losses += steps(tr, [i])
            in_flight += mgr._pending is not None
        mgr.wait()
        write_ms = mgr.last_write_ms
        print(f"[checkpoint] gather ms cold {gather_cold_ms:.1f}, warm "
              f"{gather_ms:.1f}; write ms {write_ms:.1f}; steps 5-8 "
              f"finished during the write: {in_flight}; losses {losses}, "
              f"uninterrupted {ref}", flush=True)
        check(saved == 4 and mgr.all_steps() == [2, 4],
              f"checkpoint: committed steps {mgr.all_steps()}")
        check(in_flight >= 1, "checkpoint: the step-4 write had finished "
                              "before step 5 did")
        arrays, meta = mgr.restore(4)
        check(committed_equals(torch, np, arrays, at4),
              "checkpoint: the committed step 4 differs from the host copy "
              "taken at step 4")
        del arrays
        bitwise = losses == ref
        spread = max(abs(a - b) for a, b in zip(losses, ref))

        def held(got, want):
            if bitwise:
                return got == want
            return all(abs(a - b) <= spread for a, b in zip(got, want))

        check(held(losses, ref), f"checkpoint: {losses} vs {ref}")

        # restore into the same trainer: no new capture
        prog = next(iter(tr._programs.values()))
        builds = tr.step_trace_count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.restore_checkpoint(mgr, step=4)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(same_state(torch, at4, tr) and tr.step_count == 4,
              "checkpoint: the restored state differs from step 4's")
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        resumed = steps(tr, range(4, 8))
        ms_step = (time.perf_counter() - t0) * 1e3 / 4
        launches = dict(fa.CAUSAL_LAUNCHES)
        print(f"[checkpoint] restore ms {restore_ms:.1f}; resumed "
              f"{resumed}; causal launches {launches}; "
              f"{tr.step_trace_count} step programs", flush=True)
        check(tr.step_trace_count == builds == 1 and
              len(tr._programs) == 1,
              f"checkpoint: {tr.step_trace_count} step programs after the "
              f"restore")
        check(all(n == 12 * 4 for n in launches.values()),
              f"checkpoint: causal flash launches {launches} over 4 "
              f"replays != 12 a replay")
        check(held(resumed, losses[4:]),
              f"checkpoint: resumed losses {resumed} vs {losses[4:]} "
              f"({'bitwise' if bitwise else f'spread {spread:g}'})")
        replays = prog.replays
        num_update = tr._optimizer.num_update
        del tr, prog
        gc.collect()
        torch.cuda.empty_cache()

        # restore into a fresh trainer from another seed
        fresh = trainer(5)
        t0 = time.perf_counter()
        fresh.restore_checkpoint(mgr, step=4)
        torch.cuda.synchronize()
        fresh_restore_ms = (time.perf_counter() - t0) * 1e3
        check(same_state(torch, at4, fresh) and fresh.step_count == 4 and
              fresh._optimizer.num_update == meta["num_update"],
              "checkpoint: the fresh trainer's restored state differs")
        fresh_loss = steps(fresh, [4])
        print(f"[checkpoint] fresh trainer: restore ms "
              f"{fresh_restore_ms:.1f}, step-5 loss {fresh_loss[0]!r}",
              flush=True)
        check(fresh.step_trace_count == 1 and np.isfinite(fresh_loss[0]),
              f"checkpoint: fresh trainer {fresh.step_trace_count} "
              f"captures, loss {fresh_loss}")
        del fresh
        gc.collect()
        torch.cuda.empty_cache()

        # the supervised example_target runs (child processes, a few MB
        # of the card) go on beside the train-to-serve part
        box = {}

        def supervise():
            try:
                box["stats"] = checkpoint_supervisor(tmp)
            except PhaseError as e:          # raised on the phase's thread
                box["error"] = e

        sup_thread = threading.Thread(target=supervise)
        sup_thread.start()

        # train to serve
        kw = dict(num_slots=4, page_size=16, max_len=1024, chunk_pages=4,
                  prefix_cache=True)
        prng = np.random.RandomState(9)
        prompts = [prng.randint(0, V, size=int(n)).astype(np.int32)
                   for n in (80, 200, 333, 500)]
        mk = lambda: [Request(p, max_new_tokens=32) for p in prompts]
        live = InferenceEngine(bench_gpt(2), **kw)
        live.run(mk())
        engine_builds = (live.decode_trace_count,
                         dict(live.prefill_trace_counts))
        t0 = time.perf_counter()
        live.warm_start(manager=mgr)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        ra.reset_launch_counts()
        served = mk()
        live.run(served)
        serve_launches = {k: ra.LAUNCHES[k]
                          for k in ("ragged_decode", "ragged_prefill")}
        live.audit_pages()
        print(f"[checkpoint] warm_start(manager=) ms {warm_ms:.1f}, "
              f"launches {serve_launches}", flush=True)
        check((live.decode_trace_count, dict(live.prefill_trace_counts))
              == engine_builds,
              f"checkpoint: warm_start(manager=) moved the engine's "
              f"captures from {engine_builds}")
        check(all(n > 0 for n in serve_launches.values()),
              f"checkpoint: the warm-started engine's ragged launches "
              f"{serve_launches}")
        arrays, _ = mgr.restore()
        other = InferenceEngine(bench_gpt(3), **kw)
        other.warm_start(params=arrays)
        ref_served = mk()
        other.run(ref_served)
        check([r.token_ids for r in served] ==
              [r.token_ids for r in ref_served],
              "checkpoint: warm_start(manager=) streams differ from a "
              "params= warm start's")
        mgr.close()
        del live, other, arrays
        gc.collect()
        torch.cuda.empty_cache()

        sup_thread.join(timeout=600)
        if "error" in box:
            raise box["error"]
        check("stats" in box, "checkpoint: the supervised runs did not end")
        supervised = box["stats"]
    finally:
        if sup_thread is not None:
            sup_thread.join(timeout=600)
        shutil.rmtree(tmp, ignore_errors=True)
    stats = dict(
        card=smi, config=f"gpt_small bf16 flash dropout=0.1 AdamW "
                         f"multi_precision B={B} T={T}",
        capsule_gb=sum(a.numel() * a.element_size()
                       for k, a in at4.items() if k != "generator") / 1e9,
        gather_cold_ms=gather_cold_ms, gather_ms=gather_ms,
        write_ms=write_ms, restore_ms=restore_ms,
        fresh_restore_ms=fresh_restore_ms, ms_per_step=ms_step,
        gather_share_of_step=gather_ms / ms_step,
        steps_during_write=in_flight,
        losses_held="bitwise" if bitwise else f"within spread {spread!r}",
        uninterrupted=ref, losses=losses, resumed=resumed,
        fresh_step5_loss=fresh_loss[0], replays=replays,
        num_update=num_update, causal_launches=launches,
        warm_start_ms=warm_ms, serve_launches=serve_launches,
        supervisor=supervised, phase_s=time.perf_counter() - t_phase)
    print(f"[checkpoint] {json.dumps(stats)}", flush=True)
    return stats


def nmt_loss(model, src, tgt_in, tgt_out, src_valid_length):
    """Teacher-forced token cross entropy of the Transformer."""
    logits = model(src, tgt_in, src_valid_length)
    return -logits.log_softmax(axis=-1).pick(tgt_out, axis=-1).mean()


def nmt_flash_step(torch, np):
    """A small Transformer (units 256, 4 heads of 64, 2 layers, f32) with
    flash=True: its logits against flash=False on the same weights
    (within 1e-4 of the largest |logit|), then 2 Adam steps through
    SPMDTrainer (an eager first step, then a replay), each launching the
    flash kernels for encoder self-attention, decoder causal
    self-attention and cross-attention (3 a layer, 1 of them causal)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, nd, parallel
    from incubator_mxnet_tpu_torch.models import transformer as tm
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    cfg = dict(src_vocab=1000, tgt_vocab=1000, units=256, hidden_size=1024,
               num_heads=4, num_layers=2, max_length=128, dropout=0.0)
    mx.random.seed(3)
    dense = tm.TransformerModel(**cfg)
    dense.initialize(ctx=mx.gpu(0))
    flash = tm.TransformerModel(flash=True, **cfg)
    flash.initialize(ctx=mx.gpu(0))
    flash.load_state_dict(dense.state_dict())
    rng = np.random.RandomState(5)
    B, S, T = 8, 48, 40
    arr = lambda a: nd.array(a, ctx=mx.gpu(0), dtype="int32")
    src = arr(rng.randint(3, 1000, (B, S)))
    tgt = rng.randint(3, 1000, (B, T + 1))
    vl = arr(rng.randint(S // 2, S + 1, B))
    tgt_in, tgt_out = arr(tgt[:, :-1]), arr(tgt[:, 1:])
    with autograd.predict_mode():
        want = dense(src, tgt_in, vl)._data
        got = flash(src, tgt_in, vl)._data
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= 1e-4 * scale, f"nmt flash logits: max |err| {err:.3e} > "
                               f"1e-4 x {scale:.3e}")
    tr = parallel.SPMDTrainer(flash, forward_loss=nmt_loss, optimizer="adam",
                              optimizer_params={"learning_rate": 1e-3})
    L = cfg["num_layers"]
    per_step = []
    losses = []
    for _ in range(2):
        fa.reset_launch_counts()
        losses.append(float(tr.step(src, tgt_in, tgt_out, vl).asnumpy()))
        torch.cuda.synchronize()
        per_step.append(dict(fa.LAUNCHES, **fa.CAUSAL_LAUNCHES))
    check(tr.step_trace_count == 1 and all(np.isfinite(losses)),
          f"nmt flash training: {tr.step_trace_count} builds, losses "
          f"{losses}")
    for n, launches in enumerate(per_step):
        for name in FLASH:
            check(launches[name] == 3 * L and
                  launches[name + "_causal"] == L,
                  f"nmt flash step {n}: {name} launches {launches[name]} "
                  f"(causal {launches[name + '_causal']}), want {3 * L} "
                  f"({L} causal)")
    out = dict(logits_max_err=err, logits_max=scale, losses=losses,
               launches_per_step=per_step[-1])
    del tr, flash, dense
    return out


def phase_nmt(torch, smi):
    """bench.py ``_run_nmt``'s configuration: transformer_base
    (max_length=256) f32, B=16, Ts=64, Tgen=48, K=4,
    beam_search_translate_cached once to warm up and 3 timed runs
    (tokens/s = B Tgen reps / s, the busy share of a profiled run); the
    cached search's tokens equal the uncached search's on the card with
    scores within 1e-4 relative, with and without src_valid_length; and
    a flash Transformer's training step (``nmt_flash_step``)."""
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.models import transformer as tm
    t_phase = time.perf_counter()
    B, Ts, Tgen, K, reps = (NMT[k] for k in ("B", "Ts", "Tgen", "K",
                                             "reps"))
    mx.random.seed(0)
    model = tm.transformer_base(max_length=256)
    model.initialize(ctx=mx.gpu(0))
    rng = np.random.RandomState(0)
    src = nd.array(rng.randint(3, 1000, (B, Ts)), ctx=mx.gpu(0),
                   dtype="int32")

    def run(cached=True, vl=None):
        search = tm.beam_search_translate_cached if cached else \
            tm.beam_search_translate
        return search(model, src, beam_size=K, max_length=Tgen,
                      src_valid_length=vl)

    t0 = time.perf_counter()
    run()[1].asnumpy()
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        _, scores = run()
    scores.asnumpy()
    dt = time.perf_counter() - t0
    stats = dict(card=smi,
                 config=f"transformer_base(max_length=256) f32 B={B} "
                        f"Ts={Ts} Tgen={Tgen} K={K}",
                 tokens_per_s=B * Tgen * reps / dt, ms_per_search=dt * 1e3 /
                 reps, warmup_s=warm_s)
    stats.update(busy_share(torch, lambda: run()[1].asnumpy()))
    vl = nd.array(rng.randint(Ts // 2, Ts + 1, B), ctx=mx.gpu(0),
                  dtype="int32")
    parity = {}
    for label, v in (("full", None), ("valid_length", vl)):
        (ct, cs), (ut, us) = run(True, v), run(False, v)
        ct, cs, ut, us = (x.asnumpy() for x in (ct, cs, ut, us))
        rows = int((ct != ut).any(axis=-1).sum())
        rel = float(np.max(np.abs(cs - us) / np.abs(us)))
        parity[label] = dict(rows_differing=rows, score_rel=rel)
        check(rows == 0, f"nmt {label}: {rows} of {B * K} beams of the "
                         f"cached search differ from the uncached")
        check(rel <= 1e-4, f"nmt {label}: scores differ by {rel:.2e} "
                           f"relative")
    stats["parity"] = parity
    del model
    gc.collect()
    torch.cuda.empty_cache()
    stats["flash_step"] = nmt_flash_step(torch, np)
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"[nmt] {json.dumps(stats)}", flush=True)


def flash_work(B, H, T, D, lens, elem, causal=False):
    """(bytes, flops) each flash kernel needs at these lengths: K/V rows
    of live keys, every q / dO / out row, f32 lse and delta; operations
    over the (query, key) pairs the mask keeps: 4, 6 and 8 x pairs x D.
    Not causal, every row sees the live keys (H T live pairs a batch
    row); causal, row i sees min(i + 1, length) keys (H T (T + 1) / 2 at
    full length): half the operations, the same bytes. dq reads out and
    writes delta (it computes delta); dk/dv reads delta."""
    live = sum(min(n, T) for n in lens)
    if causal:
        pairs = H * sum(min(n, T) * (min(n, T) + 1) // 2 +
                        (T - min(n, T)) * min(n, T) for n in lens)
    else:
        pairs = H * T * live
    rows = B * H * T * D * elem           # one (B, H, T, D) tensor
    kv = H * live * D * elem              # K or V, live rows
    vec = B * H * T * 4                   # one f32 (B, H, T) vector
    return {"flash_fwd": (rows + 2 * kv + rows + vec + 4 * B,
                          4 * pairs * D),
            "flash_bwd_dq": (3 * rows + 2 * kv + 2 * vec + rows + 4 * B,
                             6 * pairs * D),
            "flash_bwd_dkv": (2 * rows + 2 * kv + 2 * vec + 2 * kv + 4 * B,
                              8 * pairs * D)}


def flash_times(torch, B, T, lens, causal, err):
    """The three flash kernels at (B, H=12, T, D=64) bf16 with these
    lengths, held against their plain versions on these inputs (folded
    into ``err``), then timed: kernel, plain version (the dq and dk/dv
    rows share the one plain backward), and the library call on the same
    mask (forward; for both backward rows the library's whole backward:
    a boolean key mask, or ``is_causal=True`` at full length). Beside
    them: the port's whole backward as ``_BlockAttnLse.backward`` runs
    it (autograd, dq with Δ then dk/dv) against the library's, and the
    eager ``attn_delta``. Returns each kernel's times and bound."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    H, D = 12, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    q, k, v, do, vl = flash_inputs(torch, gen, B, H, T, T, D, lens,
                                   torch.bfloat16)
    label = (f"B={B} H={H} T={T} D={D} bf16 causal={causal} lengths in "
             f"[{min(lens)}, {max(lens)}]")
    compare_flash(torch, fa, q, k, v, do, vl, causal, label, err)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    out, lse = fa._flash_fwd_cuda(q, k, v, vl, causal, None)
    _, delta = fa._flash_bwd_dq_cuda(q, k, v, vl, do, out, lse, causal,
                                     None)
    if causal:
        check(min(lens) == T, "the causal library call needs full lengths")
        lib_kw = dict(is_causal=True)
    else:
        lib_kw = dict(attn_mask=(torch.arange(T, device="cuda")[None, :] <
                                 vl.long()[:, None])[:, None, None, :])
    ql, kl, vlib = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vlib, **lib_kw)
    qp, kp, vp = (x.detach().clone().requires_grad_() for x in (q, k, v))
    port_out = fa.flash_attention_bhtd(qp, kp, vp, vl, causal)
    ms = {
        "flash_fwd": (
            _time_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, vl, causal,
                                                       None), flush),
            _time_ms(torch, lambda: fa.dense_attn_lse(q, k, v, vl, causal),
                     flush),
            _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, **lib_kw), flush)),
        "flash_bwd_dq": (
            _time_ms(torch, lambda: fa._flash_bwd_dq_cuda(
                q, k, v, vl, do, out, lse, causal, None), flush),),
        "flash_bwd_dkv": (
            _time_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
                q, k, v, vl, do, lse, delta, causal, None), flush),),
    }
    plain_bwd = _time_ms(torch, lambda: fa.dense_attn_bwd(
        q, k, v, vl, out, lse, do, causal), flush)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (ql, kl, vlib), do, retain_graph=True), flush)
    port_bwd = _time_ms(torch, lambda: torch.autograd.grad(
        port_out, (qp, kp, vp), do, retain_graph=True), flush)
    delta_ms = _time_ms(torch, lambda: fa.attn_delta(out, do), flush)
    pair = ms["flash_bwd_dq"][0] + ms["flash_bwd_dkv"][0]
    print(f"[times] flash backward {label}: dq + dk/dv {pair:.4f} ms; the "
          f"port's whole backward (autograd, Δ inside dq) {port_bwd:.4f} "
          f"ms; the library's whole backward {lib_bwd:.4f} ms "
          f"({lib_bwd / pair:.2f}x dq + dk/dv, {lib_bwd / port_bwd:.2f}x "
          f"the port's whole); the eager attn_delta {delta_ms:.4f} ms",
          flush=True)
    work = flash_work(B, H, T, D, lens, 2, causal)
    out_times = {}
    for name in FLASH:
        t = ms[name]
        kernel_ms = t[0]
        plain_ms = t[1] if len(t) > 1 else plain_bwd
        library_ms = t[2] if len(t) > 2 else lib_bwd
        bms, by = bound(*work[name], "bfloat16")
        out_times[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=bms,
                               bound_by=by)
        print(f"[times] {name} {label}: {kernel_ms:.4f} ms (plain "
              f"{plain_ms:.4f}, library {library_ms:.4f}, bound "
              f"{bms:.5f} by {by})", flush=True)
    del flush, q, k, v, do, out, lse, lib_out, port_out, delta
    torch.cuda.empty_cache()
    return out_times


def phase_flash_times(torch, lens, err):
    """The flash kernels timed at both training runs' shapes: bert_base's
    (B=32, T=512, its batch's lengths, not causal) and gpt_small's
    (B=16, T=512, every length 512, causal: the ``_causal`` rows, their
    errors folded into ``err`` under those names)."""
    out = flash_times(torch, BERT["B"], BERT["T"], lens, False, err)
    cerr = {k: 0.0 for k in FLASH}
    causal = flash_times(torch, GPT["B"], GPT["T"], [GPT["T"]] * GPT["B"],
                         True, cerr)
    for name in FLASH:
        out[name + "_causal"] = causal[name]
        err[name + "_causal"] = cerr[name]
    return out


# --------------------------------------------------------------------- #
# the operator surface and the amp front end
# --------------------------------------------------------------------- #

def phase_ops():
    """Every registered op on the card against the port on the CPU
    (tests/test_torch_op_cases.py's ``cuda`` test in a pytest subprocess
    without the conftest: no JAX; the subprocess fails if JAX or the JAX
    package was imported), the samplers by their moments on the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    run = ("import sys, pytest\n"
           "rc = int(pytest.main(sys.argv[1:]))\n"
           "jax = {'jax', 'incubator_mxnet_tpu'} & set(sys.modules)\n"
           "print('imported', sorted(jax)) if jax else None\n"
           "sys.exit(rc or (3 if jax else 0))\n")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", run, "-q", "--noconftest", "-m", "cuda",
         "-p", "no:cacheprovider", "-W",
         "ignore::pytest.PytestUnknownMarkWarning",
         "tests/test_torch_op_cases.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    sys.path.insert(0, os.path.join(root, "tests"))
    try:
        import test_torch_op_cases as cases
        n_ops, n_cases = len(cases.CASES), len(cases.CASE_IDS)
    finally:
        sys.path.pop(0)
    print(f"[ops] {n_ops} registered ops, {n_cases} cases on the card "
          f"against the CPU: {tail[0]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(proc.returncode == 0 and "1 passed" in tail[0],
          f"op cuda test failed:\n{proc.stdout[-6000:]}"
          f"{proc.stderr[-3000:]}")


AMP = dict(B=64, side=224, warmup=3, steps=10, classes=1000,
           f16_B=32, f16_side=224, f16_steps=20, parity_B=8,
           parity_side=224, parity_rtol=2e-2)


def amp_casts(torch, np):
    """Under amp.init("bfloat16"), on the card: the target ops on f32
    inputs equal the unwrapped op on bf16-cast inputs, cast back to f32;
    softmax and BatchNorm on bf16 inputs equal the f32 computation cast
    back to bf16; bitwise."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.ops import registry
    gen = torch.Generator(device="cuda").manual_seed(3)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    target = [("Convolution", [r(8, 16, 14, 14), r(32, 16, 3, 3), r(32)],
               dict(kernel=(3, 3), num_filter=32, pad=(1, 1))),
              ("FullyConnected", [r(64, 256), r(128, 256), r(128)],
               dict(num_hidden=128)),
              ("dot", [r(64, 96), r(96, 80)], {}),
              ("batch_dot", [r(4, 64, 32), r(4, 32, 48)], {}),
              ("interleaved_matmul_selfatt_qk", [r(32, 4, 8 * 3 * 64)],
               dict(heads=8))]
    pinned = [("softmax", [r(16, 1000).bfloat16()], {}),
              ("BatchNorm", [r(8, 64, 7, 7).bfloat16(), r(64).bfloat16(),
                             r(64).bfloat16(), r(64).bfloat16(),
                             r(64).abs().bfloat16() + 0.5],
               dict(fix_gamma=False, training=False))]
    cast_in = {n for n, _, _ in target}
    done = []
    for name, ins, kw in target + pinned:
        spec = registry.get(name)
        raw = spec.fn.__wrapped__
        got = getattr(nd, name)(*[nd.NDArray(t) for t in ins], **kw)
        if name in cast_in:
            want = raw(*[t.bfloat16() for t in ins], **kw).float()
        else:
            want = raw(*[t.float() for t in ins], **kw)
            want = [w.bfloat16() for w in want] \
                if isinstance(want, (tuple, list)) else want.bfloat16()
        gots = got if isinstance(got, list) else [got]
        wants = want if isinstance(want, (list, tuple)) else [want]
        for g, w in zip(gots, wants):
            check(g._data.dtype == w.dtype and torch.equal(g._data, w),
                  f"amp: {name} is not the unwrapped op on cast inputs "
                  f"({g._data.dtype} vs {w.dtype})")
        done.append(name)
    print(f"[amp] casts bitwise on the card: {', '.join(done)}", flush=True)
    return done


def amp_resnet50(torch, np, use_amp):
    """resnet50_v1 with f32 parameters, B=64 224^2, one fixed batch, the
    MXNet 1.x loop: record -> amp.scale_loss -> backward ->
    gluon.Trainer("sgd", momentum 0.9).step(64); 3 warm-up and 10 timed
    steps."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import amp, autograd, gluon, nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    B, side = AMP["B"], AMP["side"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(0)
    net = resnet50_v1()
    net.initialize()
    rng = np.random.RandomState(0)
    x = nd.array(rng.rand(B, 3, side, side).astype("float32"))
    y = nd.array(rng.randint(0, AMP["classes"], (B,)), dtype="int32")
    net(x[:1])
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    if use_amp:
        amp.init_trainer(tr)
    lossf = gloss.SoftmaxCrossEntropyLoss()
    losses = []

    def step():
        with autograd.record():
            loss = lossf(net(x), y).mean()
            if use_amp:
                with amp.scale_loss(loss, tr) as scaled:
                    scaled.backward()
            else:
                loss.backward()
        tr.step(B)
        return loss

    losses += [float(step().asnumpy()) for _ in range(AMP["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step() for _ in range(AMP["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses += [float(v.asnumpy()) for v in timed]
    label = "amp bf16" if use_amp else "f32"
    check(all(np.isfinite(losses)), f"resnet50 {label}: loss {losses}")
    grads = [p.grad()._data for p in net.collect_params().values()
             if p.grad_req != "null"]
    check(all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
              for g in grads),
          f"resnet50 {label}: a parameter gradient is not f32 or finite")
    ms = dt * 1e3 / AMP["steps"]
    out = dict(losses=losses, ms_per_step=ms, img_per_s=B / (ms / 1e3),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               outcomes=tr.last_outcome.value)
    out.update(busy_share(torch, step))
    out.pop("top", None)
    del tr, net, x, y
    torch.cuda.empty_cache()
    return out


def amp_float16(torch, np):
    """resnet18_v1 under amp.init("float16") (scale from 2^16), B=32: up
    to 20 steps; every skipped step keeps the parameters and the momentum
    bitwise and halves the scale; at least one step applies; a batch
    holding an inf is skipped bitwise."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import amp, autograd, gluon, nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    from incubator_mxnet_tpu_torch.train import StepOutcome
    B, side = AMP["f16_B"], AMP["f16_side"]
    mx.random.seed(0)
    net = resnet18_v1()
    net.initialize()
    rng = np.random.RandomState(1)
    x = nd.array(rng.rand(B, 3, side, side).astype("float32"))
    y = nd.array(rng.randint(0, AMP["classes"], (B,)), dtype="int32")
    net(x[:1])
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.01, "momentum": 0.9})
    amp.init_trainer(tr)
    check(tr.loss_scaler.loss_scale == 2.0 ** 16,
          f"float16: initial scale {tr.loss_scaler.loss_scale}")
    lossf = gloss.SoftmaxCrossEntropyLoss()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]

    def snapshot():
        w = [p.data()._data.clone() for p in params]
        m = [s.clone() for s in tr._updaters[0].states.values()]
        return w, m

    def same(a, b):
        """Parameters and momenta bitwise (momenta the step created:
        zero)."""
        if len(a[1]) != len(b[1]):
            moms = not a[1] and all(not bool(v.any()) for v in b[1])
        else:
            moms = all(torch.equal(u, v) for u, v in zip(a[1], b[1]))
        return moms and all(torch.equal(u, v) for u, v in zip(a[0], b[0]))

    def step(batch):
        before, scale = snapshot(), tr.loss_scaler.loss_scale
        with autograd.record():
            loss = lossf(net(batch), y).mean()
            with amp.scale_loss(loss, tr) as scaled:
                scaled.backward()
        tr.step(B)
        outcome = tr.last_outcome
        after = snapshot()
        if outcome is StepOutcome.SKIPPED_NONFINITE:
            check(same(before, after) and
                  tr.loss_scaler.loss_scale == scale / 2,
                  f"float16: a skipped step changed the state or the "
                  f"scale went {scale} -> {tr.loss_scaler.loss_scale}")
        else:
            check(outcome is StepOutcome.APPLIED and
                  not same(before, after),
                  f"float16: step {outcome} left the parameters alone")
        return outcome, scale

    runs = [step(x) for _ in range(AMP["f16_steps"])]
    applied = sum(o is StepOutcome.APPLIED for o, _ in runs)
    check(applied >= 1, f"float16: no step applied in {len(runs)}")
    bad = x.copy()
    bad[0, 0, 0, 0] = float("inf")
    outcome, scale = step(bad)
    check(outcome is StepOutcome.SKIPPED_NONFINITE,
          f"float16: a batch with an inf was not skipped ({outcome})")
    skipped = sum(o is StepOutcome.SKIPPED_NONFINITE for o, _ in runs)
    out = dict(steps=len(runs), applied=applied, skipped=skipped,
               scales=[s for _, s in runs] + [scale],
               final_scale=tr.loss_scaler.loss_scale)
    print(f"[amp] float16 resnet18_v1 B={B}: {skipped} skipped / "
          f"{applied} applied, scale {out['scales'][0]:.0f} -> "
          f"{out['final_scale']:.0f}; the inf batch skipped bitwise",
          flush=True)
    del tr, net
    torch.cuda.empty_cache()
    return out


def amp_parity(torch, np):
    """The first amp bf16 loss of resnet18_v1 at B=8 on the card against
    the port on the CPU, from the same weights."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    B, side = AMP["parity_B"], AMP["parity_side"]
    rng = np.random.RandomState(2)
    x = rng.rand(B, 3, side, side).astype(np.float32)
    y = rng.randint(0, AMP["classes"], (B,)).astype(np.int32)
    state, vals = None, []
    for ctx in (mx.cpu(), mx.gpu(0)):
        mx.random.seed(0)
        net = resnet18_v1()
        net.initialize(ctx=ctx)
        net(nd.array(x[:1], ctx=ctx))
        if state is None:
            state = {k: v.clone() for k, v in net.state_dict().items()}
        net.load_state_dict(state)
        loss = gloss.SoftmaxCrossEntropyLoss()(
            net(nd.array(x, ctx=ctx)), nd.array(y, ctx=ctx, dtype="int32"))
        vals.append(float(loss.mean().asnumpy()))
    losses = dict(cpu=vals[0], gpu=vals[1])
    rel = abs(losses["gpu"] - losses["cpu"]) / abs(losses["cpu"])
    check(rel <= AMP["parity_rtol"],
          f"amp bf16 resnet18 card vs CPU: {losses} (rel {rel:.3e})")
    print(f"[amp] bf16 resnet18_v1 B={B} first loss card {losses['gpu']} "
          f"vs CPU {losses['cpu']} (rel {rel:.2e} <= "
          f"{AMP['parity_rtol']})", flush=True)
    return dict(card=losses["gpu"], cpu=losses["cpu"], rel_err=rel)


def phase_amp(torch, smi):
    """The amp front end on the card (module docstring, phase 7c2)."""
    import numpy as np
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch.ops import registry
    t0 = time.perf_counter()
    fns = {n: registry.get(n).fn for n in registry.list_all_ops()}
    out = dict(card=smi)
    try:
        out["resnet50_f32"] = amp_resnet50(torch, np, use_amp=False)
        amp.init("bfloat16")
        out["casts"] = amp_casts(torch, np)
        out["resnet50_amp_bf16"] = amp_resnet50(torch, np, use_amp=True)
        out["parity"] = amp_parity(torch, np)
        amp._deinit_for_tests()
        amp.init("float16")
        out["float16"] = amp_float16(torch, np)
    finally:
        amp._deinit_for_tests()
    wrapped = [n for n in fns if registry.get(n).fn is not fns[n]]
    check(not wrapped, f"amp: ops still wrapped after _deinit_for_tests: "
                       f"{wrapped}")
    a, f = out["resnet50_amp_bf16"], out["resnet50_f32"]
    print(f"[amp] resnet50_v1 B={AMP['B']} {AMP['side']}x{AMP['side']} "
          f"gluon.Trainer sgd: amp bf16 {a['ms_per_step']:.1f} ms/step "
          f"{a['img_per_s']:.0f} img/s busy {a.get('device_busy_share')}; "
          f"f32 {f['ms_per_step']:.1f} ms/step {f['img_per_s']:.0f} img/s "
          f"busy {f.get('device_busy_share')}", flush=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[amp] {json.dumps(out)}", flush=True)


# Module against gluon.Trainer from the same weights and batches: the
# first loss (a forward) within loss_rtol, the parameters after the first
# update within param_frac of each tensor's largest |entry|, and losses 2
# and 3 within spread_k times the gap between two gluon.Trainer runs, one
# from weights perturbed by perturb (relative). A randomly initialized
# ResNet-50 in training mode is chaotic: on the CPU (B=16, 64x64) such a
# perturbation moves the second loss by 1.6e-2 and some BatchNorm betas
# by 6% of their largest entry after one update. A replay against the
# Executor's eager body: outputs within out_tol of their largest |entry|,
# each gradient and running statistic within state_frac of its own
# (cuDNN's default backward algorithms sum with atomics; two runs on an
# H100 showed 6.2e-5 and 8.0e-5).
SYMBOLIC = dict(B=64, side=224, classes=1000, batches=4, warmup=3,
                steps=10, eager_steps=3, lr=1e-3, momentum=0.9,
                loss_rtol=1e-5, param_frac=1e-4, perturb=1e-7,
                spread_k=4.0, out_tol=1e-5, state_frac=5e-4,
                block_B=8, block_rtol=1e-5)


def _nll(torch, probs, labels):
    """Mean -log p[label] of a batch's softmax outputs."""
    p = probs._data.float()
    lab = labels._data.to(p.device).long()
    return float(-torch.log(p.gather(1, lab[:, None])).mean())


def _bound_state(exe):
    return {f"{k}:{n}": v._data.clone() for k, d in
            (("grad", exe.grad_dict), ("aux", exe.aux_dict))
            for n, v in d.items()}


def symbolic_replay_vs_eager(torch, mod, key, batch):
    """One step replayed, then the same step from the same state with the
    Executor's body run eagerly: the largest output error over the
    largest output, and the largest gradient / running-statistic error
    over each tensor's largest |entry|."""
    exe = mod._exec
    aux0 = {n: v._data.clone() for n, v in exe.aux_dict.items()}
    mod.forward(batch, is_train=True)
    exe.backward()
    replay_out = exe.outputs[0]._data.clone()
    replayed = _bound_state(exe)
    with torch.no_grad():
        for n, v in exe.aux_dict.items():
            v._data.copy_(aux0[n])
    mod.forward(batch, is_train=True)
    eager_out = exe._body(key)[0]
    exe._pending = None
    torch.cuda.synchronize()
    out_err = _rel_err(torch, eager_out, replay_out)
    state_err = max((_rel_err(torch, v, replayed[k]), k)
                    for k, v in _bound_state(exe).items())
    return out_err, state_err


def symbolic_gluon_run(torch, np, net, x, y, perturb):
    """3 gluon.Trainer SGD steps of ``net`` from its current weights
    (multiplied by 1 + perturb x N(0, 1) when perturb), on the phase's
    first 3 batches; the weights are put back after. Returns the losses
    and each parameter (and running statistic) after the first step, by
    name."""
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    S = SYMBOLIC
    B = S["B"]
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    params = list(net.collect_params().values())
    if perturb:
        gen = torch.Generator(device=params[0].data()._data.device)
        gen.manual_seed(1)
        with torch.no_grad():
            for p in params:
                if p.grad_req != "null":
                    t = p.data()._data
                    t.mul_(1 + perturb * torch.randn(
                        t.shape, generator=gen, device=t.device))
    tr = gluon.Trainer(params, "sgd", {"learning_rate": S["lr"],
                                       "momentum": S["momentum"]})
    lossf = gloss.SoftmaxCrossEntropyLoss()
    losses, after1 = [], None
    for i in range(S["warmup"]):
        with autograd.record():
            L = lossf(net(nd.array(x[i * B:(i + 1) * B])),
                      nd.array(y[i * B:(i + 1) * B]))
        L.backward()
        tr.step(B)
        losses.append(float(L.mean().asnumpy()))
        if after1 is None:
            after1 = {p.name: p.data()._data.clone() for p in params}
    net.load_state_dict(saved)
    return losses, after1


def phase_symbolic(torch, smi):
    """The symbolic front end on the card (module docstring, phase
    7c3)."""
    import tempfile

    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, nd
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    S = SYMBOLIC
    B, side = S["B"], S["side"]
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(0)
    n = B * S["batches"]
    x = rng.rand(n, 3, side, side).astype(np.float32)
    y = rng.randint(0, S["classes"], (n,)).astype(np.float32)
    mx.random.seed(0)
    net = resnet50_v1(classes=S["classes"])
    net.initialize()
    net(nd.array(x[:1]))
    net.hybridize()
    out = dict(card=smi)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet50_v1")
        t1 = time.perf_counter()
        net.export(prefix)
        out["export_s"] = time.perf_counter() - t1
        xb = nd.array(x[:S["block_B"]])
        blk = gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                        prefix + "-0000.params")
        out["symbolblock_rel_err"] = _rel_err(torch, blk(xb)._data,
                                              net(xb)._data)
        check(out["symbolblock_rel_err"] <= S["block_rtol"],
              f"symbolic: SymbolBlock.imports vs the block "
              f"{out['symbolblock_rel_err']:.3e}")
        del blk
        sym = mx.sym.load(prefix + "-symbol.json")
        params = nd.load(prefix + "-0000.params", ctx=mx.cpu())
    arg = {k[4:]: v for k, v in params.items() if k.startswith("arg:")}
    aux = {k[4:]: v for k, v in params.items() if k.startswith("aux:")}
    ref, after1 = symbolic_gluon_run(torch, np, net, x, y, 0.0)
    spread = symbolic_gluon_run(torch, np, net, x, y, S["perturb"])[0]
    it = mx.io.NDArrayIter(x, y, batch_size=B)
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(
        sym, mx.sym.Variable("softmax_label"), normalization="batch"),
        context=mx.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.set_params(arg, aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": S["lr"], "momentum": S["momentum"]})
    exe = mod._exec

    def next_batch():
        try:
            return it.next()
        except StopIteration:
            it.reset()
            return it.next()

    def step():
        batch = next_batch()
        mod.forward_backward(batch)
        mod.update()
        return batch

    losses, param_err = [], None
    for _ in range(S["warmup"]):
        batch = step()
        losses.append(_nll(torch, mod.get_outputs()[0], batch.label[0]))
        if param_err is None:
            got = {**mod.get_params()[0], **mod.get_params()[1]}
            param_err = max(_rel_err(torch, got[n]._data, v)
                            for n, v in after1.items())
    check(len(exe._programs) == 1, f"symbolic: programs "
                                   f"{list(exe._programs)} after warm-up")
    key = next(iter(exe._programs))
    train = exe._programs[key]
    prog = next(iter(train.values()))
    check(len(train) == 1 and prog.graph is not None,
          f"symbolic: {len(train)} train signatures, graph {prog.graph}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(S["steps"]):
        batch = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3 / S["steps"]
    check(prog.replays == S["warmup"] - 1 + S["steps"],
          f"symbolic: {prog.replays} replays")
    last = _nll(torch, mod.get_outputs()[0], batch.label[0])
    check(all(np.isfinite(losses + [last])), f"symbolic: losses {losses}")
    module = dict(ms_per_step=ms, img_per_s=B / (ms / 1e3), losses=losses,
                  first_call_ms=prog.first_ms, capture_ms=prog.capture_ms,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    module.update(busy_share(torch, step))
    module["replays"] = prog.replays
    out["module"] = module
    out_err, state_err = symbolic_replay_vs_eager(torch, mod, key,
                                                  next_batch())
    out["replay_vs_eager"] = dict(output=out_err, state=state_err[0],
                                  worst=state_err[1])
    check(out_err <= S["out_tol"] and state_err[0] <= S["state_frac"],
          f"symbolic: replay vs eager body: outputs {out_err:.3e}, "
          f"gradients / statistics {state_err}")

    def eager_step():
        mod.forward(next_batch(), is_train=True)
        exe._body(key)
        exe._pending = None
        mod.update()

    eager_step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(S["eager_steps"]):
        eager_step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t1) * 1e3 / S["eager_steps"]
    out["eager_body"] = dict(ms_per_step=eager_ms,
                             img_per_s=B / (eager_ms / 1e3))
    score = dict(mod.score(it, "acc"))
    evals = exe._programs.get(False, {})
    check(len(evals) == 1 and all(p.graph is not None
                                  for p in evals.values()),
          f"symbolic: {len(evals)} eval signatures after score")
    ev = next(iter(evals.values()))
    check(ev.replays == S["batches"] - 1, f"symbolic: eval replays "
                                          f"{ev.replays}")
    out["captures"] = dict(train=len(train), eval=len(evals),
                           train_capture_ms=prog.capture_ms,
                           eval_capture_ms=ev.capture_ms,
                           eval_first_call_ms=ev.first_ms,
                           accuracy=score["accuracy"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(spread, ref)]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    out["vs_gluon"] = dict(module_losses=losses, gluon_losses=ref,
                           perturbed_gluon_losses=spread, loss_rel=rels,
                           perturbed_rel=gaps, param_err_step1=param_err)
    check(rels[0] <= S["loss_rtol"] and param_err <= S["param_frac"] and
          all(r <= max(S["loss_rtol"], S["spread_k"] * g)
              for r, g in zip(rels[1:], gaps[1:])),
          f"symbolic: Module vs gluon.Trainer: losses {losses} vs {ref} "
          f"(rel {rels}, perturbed gluon rel {gaps}), parameters after "
          f"the first update {param_err:.3e}")
    del mod, exe, net, params, arg, aux
    gc.collect()
    torch.cuda.empty_cache()
    m = out["module"]
    print(f"[symbolic] resnet50_v1 f32 B={B} {side}x{side} Module "
          f"sgd: {m['ms_per_step']:.1f} ms/step {m['img_per_s']:.0f} img/s "
          f"busy {m.get('device_busy_share')}; eager body "
          f"{eager_ms:.1f} ms/step; captures train "
          f"{prog.capture_ms:.0f} ms eval {ev.capture_ms:.0f} ms; losses "
          f"rel {rels} vs gluon.Trainer ({gaps} perturbed)", flush=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[symbolic] {json.dumps(out)}", flush=True)


# --------------------------------------------------------------------- #
# object detection: SSD-300 training and detection, Faster R-CNN
# --------------------------------------------------------------------- #

DETECTION = dict(B=32, side=300, classes=20, boxes=2, warmup=3, steps=10,
                 lr=0.05, momentum=0.9, wd=5e-4, loss_rtol=1e-4,
                 detect_B=8, prob_rtol=1e-5, box_atol=1e-5,
                 rcnn_B=2, rcnn_h=600, rcnn_w=800, rcnn_lr=0.01,
                 rcnn_frac=1e-4, roi_atol=1e-2)


def ssd_batch(np, B, side, classes):
    """bench.py ``_run_ssd``'s batch: uniform pixels, two boxes an image
    from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    x = rng.rand(B, 3, side, side).astype(np.float32)
    labels = np.full((B, 2, 5), -1.0, np.float32)
    for b in range(B):
        for o in range(2):
            x1, y1 = rng.uniform(0.0, 0.6, 2)
            w, h = rng.uniform(0.2, 0.35, 2)
            labels[b, o] = (rng.randint(0, classes), x1, y1,
                            min(x1 + w, 1.0), min(y1 + h, 1.0))
    return x, labels


def ssd_forward_loss(model, xb, yb):
    """bench.py ``_run_ssd``'s objective: MultiBoxTarget (hard negative
    mining) and the joint loss, inside the captured step."""
    anchors, cls_preds, box_preds = model(xb)
    bt, bm, ct = model.training_targets(anchors, cls_preds, yb)
    return model.loss(cls_preds, box_preds, bt, bm, ct)


def detection_ssd(torch, np):
    """bench.py ``_run_ssd`` on the card: ssd_300(num_classes=20) f32
    through SPMDTrainer(forward_loss=...) with SGD; a second trainer from
    the same weights runs the step body eagerly, the reference of the
    first steps' losses. Then SSD.detect on the card against the CPU."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, parallel
    from incubator_mxnet_tpu_torch.models.ssd import ssd_300
    D = DETECTION
    B, side = D["B"], D["side"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, labels = ssd_batch(np, B, side, D["classes"])
    xs, ys = nd.array(x), nd.array(labels)
    nets = []
    for _ in range(2):
        mx.random.seed(0)
        net = ssd_300(num_classes=D["classes"])
        net.initialize()
        net(xs[:1])
        nets.append(net)
    net, ref = nets
    ref.load_state_dict(net.state_dict())
    # detection from the random weights (13 steps on one batch teach the
    # network background everywhere: no row would survive)
    detect = detection_detect(torch, np, net, xs[:D["detect_B"]])
    opt = {"learning_rate": D["lr"], "momentum": D["momentum"],
           "wd": D["wd"]}
    tr, ref_tr = (parallel.SPMDTrainer(n, forward_loss=ssd_forward_loss,
                                       optimizer="sgd",
                                       optimizer_params=dict(opt),
                                       sharding="replicated")
                  for n in (net, ref))
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    try:
        # the step body run eagerly outside any graph: a replay's reference
        from test_torch_train_graphs import _eager_step
    finally:
        sys.path.pop(0)
    losses, eager = [], []
    for _ in range(D["warmup"]):
        losses.append(float(tr.step(xs, ys).asnumpy()))
        eager.append(float(_eager_step(ref_tr, [xs._data, ys._data])))
    check(tr.step_trace_count == 1 and len(tr._programs) == 1,
          f"ssd: {tr.step_trace_count} step programs built in the warm-up")
    prog = next(iter(tr._programs.values()))
    replays = prog.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [tr.step(xs, ys) for _ in range(D["steps"])]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / D["steps"]
    losses += [float(v.asnumpy()) for v in timed]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, eager)]
    check(all(np.isfinite(losses)), f"ssd: non-finite loss {losses}")
    check(max(rels) <= D["loss_rtol"],
          f"ssd: the first losses {losses[:len(eager)]} against the eager "
          f"body's {eager} (rel {rels}) > {D['loss_rtol']}")
    check(losses[-1] < losses[0], f"ssd: loss did not fall: {losses}")
    check(tr.step_trace_count == 1 and
          prog.replays - replays == D["steps"],
          f"ssd: {prog.replays - replays} of {D['steps']} timed steps "
          f"replayed, {tr.step_trace_count} builds")
    out = dict(config=f"ssd_300(num_classes={D['classes']}) f32 B={B} "
                      f"{side}x{side}, SGD lr {D['lr']} momentum "
                      f"{D['momentum']} wd {D['wd']}",
               losses=losses, eager_body_losses=eager, loss_rel=rels,
               ms_per_step=ms, img_per_s=B / (ms / 1e3),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               first_step_ms=prog.first_ms, capture_ms=prog.build_ms,
               step_trace_count=tr.step_trace_count)
    out.update(busy_share(torch, lambda: tr.step(xs, ys)))
    out["replays"] = prog.replays
    del ref_tr, ref, nets
    out["detect"] = detect
    del tr, net, xs, ys, prog
    gc.collect()
    torch.cuda.empty_cache()
    return out


def detection_detect(torch, np, net, xs):
    """SSD.detect on the card (timed and profiled) against the port on
    the CPU from the card's class probabilities: the detection is a
    selection by score, and scores an ulp apart (softmax on two devices)
    would order rows differently, so the CPU decodes and suppresses the
    card's probabilities (``detect`` is that softmax, then
    MultiBoxDetection); the softmax itself is held to ``prob_rtol``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd
    D = DETECTION
    anchors, cls_preds, box_preds = net(xs)
    kw = dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)
    dets = net.detect(cls_preds, box_preds, anchors, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.detect(cls_preds, box_preds, anchors, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    prof = busy_share(torch, lambda: net.detect(cls_preds, box_preds,
                                                anchors, **kw))
    probs = nd.softmax(cls_preds, axis=1)
    cpu = [nd.array(a._data.cpu(), ctx=mx.cpu())
           for a in (cls_preds, box_preds, anchors, probs)]
    with mx.cpu():
        prob_err = _rel_err(torch, probs._data,
                            nd.softmax(cpu[0], axis=1)._data)
        want = nd.MultiBoxDetection(cpu[3], cpu[1], cpu[2], **kw)._data
    got = dets._data.cpu()
    valid = int((want[..., 0] >= 0).sum())
    ids_equal = bool(torch.equal(got[..., :2] >= 0, want[..., :2] >= 0) and
                     torch.equal(got[..., 0], want[..., 0]))
    score_err = float((got[..., 1] - want[..., 1]).abs().max())
    box_err = float((got[..., 2:] - want[..., 2:]).abs().max())
    check(prob_err <= D["prob_rtol"],
          f"ssd detect: softmax card vs CPU {prob_err:.2e}")
    check(ids_equal and valid > 0 and score_err <= D["box_atol"] and
          box_err <= D["box_atol"],
          f"ssd detect: card vs CPU rows: ids equal {ids_equal}, {valid} "
          f"valid, scores {score_err:.2e}, boxes {box_err:.2e}")
    return dict(B=int(xs.shape[0]), anchors=int(anchors.shape[1]),
                valid_rows=valid, ms=ms, softmax_rel_err=prob_err,
                score_max_abs_err=score_err, box_max_abs_err=box_err,
                **{f"profile_{k}": v for k, v in prof.items()})


def rcnn_toy_loss(s, d):
    """tests/test_contrib_det.py's toy loss over the head's outputs."""
    return (s.log_softmax(axis=-1)[:, :, 0]).mean() * -1 + (d * d).mean()


def rcnn_staged(mx, nd, autograd, net, x, info, probs=None):
    """The model's forward (``rpn_forward`` then ``roi_forward``), its toy
    loss and the backward; the RoI half reads ``probs`` when given (the
    other device's RPN probabilities). Returns the outputs by name and
    the first backbone weight's gradient."""
    with autograd.record():
        feat, rpn_cls, rpn_box, own = net.rpn_forward(nd, x)
        rois, s, d = net.roi_forward(nd, feat, own if probs is None
                                     else probs, rpn_box, info)
        loss = rcnn_toy_loss(s, d)
    loss.backward()
    outs = dict(rois=rois, scores=s, deltas=d, rpn_cls=rpn_cls,
                rpn_box=rpn_box, probs=own, loss=loss)
    return outs, net.backbone.body[0].weight.grad()._data.clone()


def detection_rcnn(torch, np):
    """faster_rcnn_small(num_classes=20) f32 at its defaults, B=2 at 600 x
    800: the forward and the toy loss on the card against the port on
    the CPU at the same weights (the RoI half of the CPU run reads the
    card's RPN probabilities: proposals are a selection by score), then
    one gluon.Trainer("sgd") step on the card through ``net(x, im_info)``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    from incubator_mxnet_tpu_torch.models.faster_rcnn import \
        faster_rcnn_small
    D = DETECTION
    B, H, W = D["rcnn_B"], D["rcnn_h"], D["rcnn_w"]
    rng = np.random.RandomState(0)
    x = rng.rand(B, 3, H, W).astype(np.float32)
    info = np.tile([H, W, 1.0], (B, 1)).astype(np.float32)
    mx.random.seed(0)
    net = faster_rcnn_small(num_classes=D["classes"])
    net.initialize()
    xg, ig = nd.array(x), nd.array(info)
    net(xg, ig)
    with mx.cpu():
        cpu_net = faster_rcnn_small(num_classes=D["classes"])
        cpu_net.initialize()
        cpu_net(nd.array(x[:, :, :64, :64]), nd.array(info))
        cpu_net.load_state_dict({k: v.cpu() for k, v in
                                 net.state_dict().items()})
    card, g_card = rcnn_staged(mx, nd, autograd, net, xg, ig)
    with mx.cpu():
        probs = nd.array(card["probs"]._data.cpu())
        ref, g_cpu = rcnn_staged(mx, nd, autograd, cpu_net, nd.array(x),
                                 nd.array(info), probs)
    errs = {k: _rel_err(torch, card[k]._data, ref[k]._data)
            for k in ("scores", "deltas", "rpn_cls", "rpn_box", "probs",
                      "loss")}
    errs["backbone_grad"] = _rel_err(torch, g_card, g_cpu)
    rg, rc = card["rois"]._data.detach().cpu(), ref["rois"]._data.detach()
    roi_err = float((rg[..., 1:] - rc[..., 1:]).abs().max())
    live = int((rc[..., 1:] != 0).any(dim=-1).sum())
    check(torch.equal(rg[..., 0], rc[..., 0]) and
          torch.equal(rg[..., 1:] == 0, rc[..., 1:] == 0) and
          roi_err <= D["roi_atol"] and live > 0,
          f"faster_rcnn: rois card vs CPU: {roi_err:.2e} px, {live} live")
    check(max(errs.values()) <= D["rcnn_frac"],
          f"faster_rcnn: card vs CPU (of each largest |entry|) {errs}")
    # the user's path: net(x, im_info), the toy loss, one SGD step
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": D["rcnn_lr"]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with autograd.record():
        rois, s, d, _, _ = net(xg, ig)
        loss = rcnn_toy_loss(s, d)
    loss.backward()
    tr.step(1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    # the toy loss is a mean over the rois: the staged forward's, whatever
    # the order of proposals an ulp apart
    loss_rel = _rel_err(torch, loss._data, card["loss"]._data)
    finite = all(bool(torch.isfinite(p.data()._data).all())
                 for p in net.collect_params().values())
    check(loss_rel <= D["rcnn_frac"] and finite,
          f"faster_rcnn: net(x)'s loss vs the staged forward's {loss_rel:.2e}"
          f", parameters finite after the step {finite}")
    prof = busy_share(torch, lambda: net(xg, ig))
    return dict(config=f"faster_rcnn_small(num_classes={D['classes']}) f32 "
                       f"B={B} {H}x{W}, rpn_post_nms_top_n=64",
                rois_max_abs_err_px=roi_err, live_rois=live, rel_err=errs,
                sgd_step_ms=step_ms, loss=float(loss.asnumpy()),
                loss_vs_staged=loss_rel,
                **{f"forward_{k}": v for k, v in prof.items()})


def phase_detection(torch, smi):
    """Object detection on the card (module docstring, phase 7c4)."""
    import numpy as np
    t0 = time.perf_counter()
    out = dict(card=smi, ssd=detection_ssd(torch, np),
               faster_rcnn=detection_rcnn(torch, np))
    s, det = out["ssd"], out["ssd"]["detect"]
    print(f"[detection] ssd_300 f32 B={DETECTION['B']} 300x300 SPMDTrainer "
          f"sgd: {s['ms_per_step']:.2f} ms/step {s['img_per_s']:.0f} img/s "
          f"busy {s.get('device_busy_share')}; capture "
          f"{s['capture_ms']:.0f} ms; peak {s['peak_memory_gb']:.2f} GB; "
          f"detect B={det['B']} {det['ms']:.1f} ms ({det['valid_rows']} "
          f"rows); faster_rcnn card vs CPU {out['faster_rcnn']['rel_err']}",
          flush=True)
    out["phase_s"] = time.perf_counter() - t0
    print(f"[detection] {json.dumps(out)}", flush=True)


IMAGENET = dict(records=1024, labels=32, short=256, long=(256, 384),
                quality=90, B=64, k=4, side=224, classes=1000,
                warmup=(1, 4, 4), rounds=5, lr=0.1, momentum=0.9, wd=1e-4,
                rate_batches=(3, 8), mean=(123.68, 116.28, 103.53),
                std=(58.395, 57.12, 57.375), apply_reps=20)


def imagenet_pack(np, root):
    """IMAGENET["records"] JPEGs at MXNet's recipe size (short side 256,
    the long side drawn in [256, 384), landscape or portrait), in
    ``labels`` class folders (each class a coarse colour field of its own
    under per-pixel noise), packed by the port's im2rec into
    ``root/imagenet.rec`` / ``.idx``. Returns the prefix and the mean
    JPEG size."""
    from concurrent.futures import ThreadPoolExecutor
    from incubator_mxnet_tpu_torch.io import recordio
    from incubator_mxnet_tpu_torch.tools import im2rec
    D = IMAGENET
    rng = np.random.RandomState(0)
    protos = rng.rand(D["labels"], 8, 12, 3)
    specs = []
    for i in range(D["records"]):
        long_side = int(rng.randint(*D["long"]))
        hw = (D["short"], long_side) if i % 2 else (long_side, D["short"])
        specs.append((i, i % D["labels"], hw, int(rng.randint(1 << 30))))

    def write(spec):
        i, label, (h, w), seed = spec
        r = np.random.RandomState(seed)
        field = protos[label] * 0.7 + r.rand(8, 12, 3) * 0.3
        img = np.repeat(np.repeat(field, 32, 0), 32, 1)
        img = np.resize(img, (max(h, 256), max(w, 384), 3))[:h, :w] * 220
        img = (img + r.randint(0, 32, (h, w, 3))).astype(np.uint8)
        payload = recordio._encode_img(img, D["quality"], ".jpg")
        check(payload[:3] == b"\xff\xd8\xff",
              "imagenet: no JPEG encoder (cv2 / PIL) on this machine")
        folder = os.path.join(root, "images", f"n{label:08d}")
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, f"{i:05d}.jpg"), "wb") as f:
            f.write(payload)
        return len(payload)

    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        sizes = list(pool.map(write, specs))
    prefix = os.path.join(root, "imagenet")
    im2rec.main([prefix, os.path.join(root, "images"), "--recursive"])
    return prefix, float(np.mean(sizes))


def imagenet_iter(mx, prefix, threads, **kw):
    """The recipe's training reader: random 224 crops and flips,
    ImageNet's mean and std, bf16 batches on the card."""
    D = IMAGENET
    args = dict(path_imgrec=prefix + ".rec", data_shape=(3, D["side"],
                                                          D["side"]),
                batch_size=D["B"], rand_crop=True, rand_mirror=True,
                shuffle=True, preprocess_threads=threads, dtype="bfloat16",
                **{f"mean_{c}": m for c, m in zip("rgb", D["mean"])},
                **{f"std_{c}": v for c, v in zip("rgb", D["std"])})
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def imagenet_reader(torch, np, mx, prefix):
    """The reader alone: every record a JPEG, the native RecordIO reader,
    img/s at 1 thread and at the machine's core count; on the card the
    normalization bitwise the host formula, and a batch bitwise the same
    at 1 and at N threads for one seed."""
    from incubator_mxnet_tpu_torch.io import _native_image, recordio
    D = IMAGENET
    rec = recordio.MXRecordIO(prefix + ".rec", "r")
    n_rec = n_jpeg = 0
    while (payload := rec.read()) is not None:
        n_rec += 1
        n_jpeg += recordio.unpack(payload)[1][:3] == b"\xff\xd8\xff"
    rec.close()
    check(n_rec == D["records"] and n_jpeg == n_rec,
          f"imagenet: {n_jpeg} of {n_rec} records hold a JPEG")
    decoder = mx.image.decoder()
    check(decoder != "none", "imagenet: no JPEG decoder on this machine")
    cores = os.cpu_count() or 1
    rates = {}
    for threads, batches in zip((1, cores), D["rate_batches"]):
        it = imagenet_iter(mx, prefix, threads)
        check(it.reader == "native",
              f"imagenet: the native RecordIO reader did not build "
              f"({it.reader})")
        next(it)                      # the pool and the pinned buffers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            b = next(it)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(b.data[0].shape == (D["B"], 3, D["side"], D["side"]) and
              b.data[0].dtype == "bfloat16" and b.data[0].context.device_type
              == "gpu", f"imagenet: batch {b.data[0].shape} "
                        f"{b.data[0].dtype} on {b.data[0].context}")
        rates[threads] = batches * D["B"] / dt
    # the normalization on the card against numpy's formula on the
    # decoded pixels (mean 0, std 1 gives them as floats)
    plain = dict(rand_crop=False, rand_mirror=False, shuffle=False,
                 dtype="float32")
    card = next(imagenet_iter(mx, prefix, cores, **plain)).data[0]
    with mx.cpu():
        pix = next(imagenet_iter(
            mx, prefix, cores, **plain, mean_r=0.0, mean_g=0.0, mean_b=0.0,
            std_r=1.0, std_g=1.0, std_b=1.0)).data[0].asnumpy()
    mean = np.asarray(D["mean"], np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(D["std"], np.float32).reshape(1, 3, 1, 1)
    want = (pix - mean) / std
    norm_equal = bool(np.array_equal(card.asnumpy(), want))
    check(norm_equal, "imagenet: the normalization on the card differs "
                      "from numpy's (x - mean) / std")
    batches = []
    for threads in (1, cores):
        mx.random.seed(5)
        batches.append(next(imagenet_iter(mx, prefix, threads)))
    threads_equal = all(
        torch.equal(a._data, b._data)
        for a, b in zip(batches[0].data + batches[0].label,
                        batches[1].data + batches[1].label))
    check(threads_equal, f"imagenet: a batch at 1 thread differs from "
                         f"the same batch at {cores}")
    native_jpeg = _native_image.lib() is not None
    return dict(decoder=decoder, reader="native", records=n_rec,
                jpeg_records=n_jpeg,
                native_jpeg="built" if native_jpeg else
                (_native_image.build_error("mxtpu_image") or "")
                .strip().splitlines()[-1][:160],
                img_per_s_1_thread=rates[1], cores=cores,
                img_per_s_all_cores=rates[cores],
                normalization_bitwise_numpy=norm_equal,
                batch_bitwise_1_vs_all_threads=threads_equal)


def imagenet_state(torch, tr, net):
    from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
    return [p.detach().clone() for p in tr._params] + \
        [t.clone() for t in tree_leaves(tr._opt_state)] + \
        [b.clone() for b in net.buffers()]


def imagenet_apply_ms(torch, tr):
    """The device ms of the update the accumulation body computes on
    every microbatch and keeps on the last (``_accum_apply`` with the
    select false: nothing changes), as one graph replayed."""
    prog = next(iter(tr._accum_programs.values()))
    never = torch.zeros((), dtype=torch.bool, device=tr.device)
    opt = tr._optimizer
    saved = dict(opt._index_update_count), opt.num_update
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tr._accum_apply(prog.inp.dev, never)       # warm-up
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        tr._accum_apply(prog.inp.dev, never)
    opt._index_update_count, opt.num_update = saved
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    graph.replay()
    start.record()
    for _ in range(IMAGENET["apply_reps"]):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / IMAGENET["apply_reps"]
    del graph
    return ms


def imagenet_training(torch, np, mx, prefix, device_name):
    """resnet50_v1 bf16 through SPMDTrainer.step_microbatches, k = 4 x 64
    from ImageRecordIter under PrefetchingIter, against the same rounds
    from one resident batch; captures, a NaN round, the apply's cost."""
    from incubator_mxnet_tpu_torch import amp, nd, parallel
    from incubator_mxnet_tpu_torch.gluon import loss as gloss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        BottleneckV1
    from incubator_mxnet_tpu_torch.train import StepOutcome
    from incubator_mxnet_tpu_torch.utils import flops
    D = IMAGENET
    B, k, side = D["B"], D["k"], D["side"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(0)
    net = resnet50_v1(classes=D["classes"])
    net.initialize()
    net(nd.array(np.random.RandomState(0).rand(1, 3, side, side)
                 .astype(np.float32)))
    # GluonCV's last_gamma: each bottleneck's last BatchNorm starts at
    # gamma 0, so every residual block starts as the identity (from the
    # default init at a constant lr 0.1 the loss on these records rose)
    for block in net.modules():
        if isinstance(block, BottleneckV1):
            gamma = block.body[-1].gamma
            gamma.set_data(nd.zeros(gamma.shape))
    net.cast("bfloat16")
    # a power-of-two scale changes no bf16 value; the NaN round halves it
    scaler = amp.LossScaler(init_scale=2.0, scale_window=1 << 30)
    tr = parallel.SPMDTrainer(
        net, loss=gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": D["lr"],
                          "momentum": D["momentum"], "wd": D["wd"],
                          "multi_precision": True},
        loss_scaler=scaler)
    fed_batches = sum(D["warmup"]) + (D["rounds"] + 1) * k
    pf = mx.io.PrefetchingIter(mx.io.ResizeIter(
        imagenet_iter(mx, prefix, os.cpu_count() or 1), fed_batches))

    def fed(n):
        return [(b.data[0], b.label[0]) for b in (next(pf) for _ in range(n))]

    losses = []
    for n in D["warmup"]:
        micros = fed(n)
        losses.append(float(tr.step_microbatches(micros).asnumpy()))
    resident = micros[0]
    check(tr.accum_step_trace_count == 1 and len(tr._accum_programs) == 1,
          f"imagenet: {tr.accum_step_trace_count} accumulation programs "
          f"built over rounds of k = {D['warmup']}")
    prog = next(iter(tr._accum_programs.values()))
    check(prog.graph is not None and prog.replays == sum(D["warmup"]) - 1,
          f"imagenet: {prog.replays} replays after the warm-up rounds")
    # what else the host does meanwhile: the process's threads, its CPU
    # seconds, and the garbage collector's pauses over the fed rounds
    pauses = []

    def gc_timer(phase, info):
        if phase == "start":
            pauses.append(-time.perf_counter())
        elif pauses:
            pauses[-1] += time.perf_counter()

    host = dict(threads=threading.active_count(),
                gc_tracked_objects=len(gc.get_objects()),
                loadavg_1min=os.getloadavg()[0])
    gc.callbacks.append(gc_timer)
    torch.cuda.synchronize()
    t0, cpu0 = time.perf_counter(), time.process_time()
    try:
        timed = [tr.step_microbatches(fed(k)) for _ in range(D["rounds"])]
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(gc_timer)
    wall = time.perf_counter() - t0
    fed_ms = wall * 1e3 / D["rounds"]
    host.update(process_cpu_s_per_wall_s=(time.process_time() - cpu0) / wall,
                gc_pauses=len(pauses), gc_ms=sum(pauses) * 1e3)
    losses += [float(v.asnumpy()) for v in timed]
    fed_profile = busy_share(torch, lambda: tr.step_microbatches(fed(k)))
    drained = len(list(pf))
    t0 = time.perf_counter()
    for _ in range(D["rounds"]):
        tr.step_microbatches([resident] * k)
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t0) * 1e3 / D["rounds"]
    resident_profile = busy_share(
        torch, lambda: tr.step_microbatches([resident] * k))
    n_rounds = len(D["warmup"]) + 2 * D["rounds"] + 2
    check(all(np.isfinite(losses)), f"imagenet: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"imagenet: the fed rounds' loss did not "
                                  f"fall: {losses}")
    check(tr.step_count == n_rounds and tr.health["APPLIED"] == n_rounds,
          f"imagenet: {tr.step_count} of {n_rounds} rounds applied "
          f"({tr.health})")
    # one NaN microbatch (the second) skips the round bitwise
    bad = resident[0].copy()
    bad._data[0, 0, 0, 0] = float("nan")
    before = imagenet_state(torch, tr, net)
    health = dict(tr.health)
    tr.step_microbatches([resident, (bad, resident[1])] + [resident] * 2)
    after = imagenet_state(torch, tr, net)
    changed = sum(not torch.equal(a, b) for a, b in zip(before, after))
    skipped = tr.health["SKIPPED_NONFINITE"] - health["SKIPPED_NONFINITE"]
    check(tr.last_outcome is StepOutcome.SKIPPED_NONFINITE and
          skipped == 1 and changed == 0 and tr.step_count == n_rounds and
          scaler.loss_scale == 1.0,
          f"imagenet: the NaN round changed {changed} tensors, "
          f"{skipped} skips, outcome {tr.last_outcome}, step_count "
          f"{tr.step_count}, loss scale {scaler.loss_scale}")
    tr.step_microbatches([resident] * k)
    check(tr.last_outcome is StepOutcome.APPLIED and
          tr.accum_step_trace_count == 1,
          f"imagenet: after the NaN round {tr.last_outcome}, "
          f"{tr.accum_step_trace_count} builds")
    apply_ms = imagenet_apply_ms(torch, tr)
    img = B * k
    gflop = img * 3 * VISION["gflop_per_image"] * 1e9
    out = dict(config=f"resnet50_v1 bf16 {D['classes']} classes, "
                      f"step_microbatches k={k} x B={B} at {side}x{side} "
                      f"(global batch {img}), last_gamma, SGD lr {D['lr']} "
                      f"momentum "
                      f"{D['momentum']} wd {D['wd']} multi_precision, "
                      f"ImageRecordIter(rand_crop, rand_mirror, ImageNet "
                      f"mean/std, bf16) under PrefetchingIter",
               losses=losses, fed_ms_per_round=fed_ms,
               fed_img_per_s=img / (fed_ms / 1e3),
               resident_ms_per_round=resident_ms,
               resident_img_per_s=img / (resident_ms / 1e3),
               fed_over_resident=fed_ms / resident_ms,
               mfu_resident=gflop / (resident_ms / 1e3)
               / flops.peak_flops(device_name),
               apply_select_ms_per_microbatch=apply_ms,
               accum_step_trace_count=tr.accum_step_trace_count,
               last_accum_count=tr.last_accum_count,
               first_microbatch_ms=prog.first_ms, capture_ms=prog.build_ms,
               replays=prog.replays, nan_round="skipped bitwise, one "
               "SKIPPED_NONFINITE, loss scale 2 -> 1",
               drained_batches=drained, fed_host=host,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    out.update({f"fed_{k_}": v for k_, v in fed_profile.items()})
    out.update({f"resident_{k_}": v for k_, v in resident_profile.items()})
    del tr, net, pf, prog, resident, micros, bad, before, after
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_imagenet(torch, smi):
    """The ImageNet input path on the card (module docstring, 7c5)."""
    import tempfile
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mx_imagenet_")
    try:
        prefix, jpeg_bytes = imagenet_pack(np, root)
        pack_s = time.perf_counter() - t0
        reader = imagenet_reader(torch, np, mx, prefix)
        train = imagenet_training(torch, np, mx, prefix,
                                  torch.cuda.get_device_name(0))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = dict(card=smi, pack_s=pack_s, mean_jpeg_bytes=jpeg_bytes,
               reader=reader, training=train,
               phase_s=time.perf_counter() - t0)
    print(f"[imagenet] {smi}: decoder {reader['decoder']}, reader "
          f"{reader['reader']}; ImageRecordIter {reader['img_per_s_1_thread']:.0f}"
          f" img/s at 1 thread, {reader['img_per_s_all_cores']:.0f} at "
          f"{reader['cores']}; resnet50_v1 bf16 k=4 x 64: fed "
          f"{train['fed_ms_per_round']:.1f} ms/round "
          f"({train['fed_img_per_s']:.0f} img/s, busy "
          f"{train.get('fed_device_busy_share')}), resident "
          f"{train['resident_ms_per_round']:.1f} ms/round "
          f"({train['resident_img_per_s']:.0f} img/s, busy "
          f"{train.get('resident_device_busy_share')}); builds "
          f"{train['accum_step_trace_count']}, capture "
          f"{train['capture_ms'] or 0:.0f} ms; apply+select "
          f"{train['apply_select_ms_per_microbatch']:.3f} ms/microbatch; "
          f"peak {train['peak_memory_gb']:.2f} GB", flush=True)
    print(f"[imagenet] {json.dumps(out)}", flush=True)


# --------------------------------------------------------------------- #
# recurrent networks (module docstring, phase 7c6)
# --------------------------------------------------------------------- #
# the RNN op card against CPU: T, B, H of the 650-wide language model;
# each output and gradient within RNN_TOL of its largest |entry| (IEEE
# f32 on both sides: cuDNN's TF32 default misses it by an order)
RNN = dict(T=35, B=32, H=650, tol=5e-5, vocab=33278, bptt=35, windows=20,
           timed_from=5, lr=20.0, clip=0.25, dropout=0.5, warmup=3,
           steps=10, loss_rtol=1e-4, first_loss_rtol=1e-5)
RNN_MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


def rnn_inputs(torch, mode, layers, bidirectional, seed):
    """The op's inputs on the host: data (T, B, H), the flat vector at
    PyTorch's default RNN init (uniform +-1/sqrt(H)), states."""
    from incubator_mxnet_tpu_torch.ops.rnn import rnn_param_size
    T, B, H = RNN["T"], RNN["B"], RNN["H"]
    d = 2 if bidirectional else 1
    g = torch.Generator().manual_seed(seed)
    n = rnn_param_size(layers, H, H, mode, bidirectional)
    ins = [torch.randn(T, B, H, generator=g),
           (torch.rand(n, generator=g) * 2 - 1) / H ** 0.5,
           torch.randn(layers * d, B, H, generator=g) * 0.5]
    if mode == "lstm":
        ins.append(torch.randn(layers * d, B, H, generator=g) * 0.5)
    return ins


def rnn_forward_backward(torch, fn, inputs, kw, device, dtype, seed):
    """The outputs and the gradients of every input under seeded
    cotangents."""
    xs = [t.to(device, dtype).requires_grad_() for t in inputs]
    outs = fn(*xs, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    cts = [torch.randn(o.shape, generator=g).to(device, dtype)
           for o in outs]
    grads = torch.autograd.grad(outs, xs, cts)
    return [t.detach() for t in outs], list(grads)


def rnn_op_on_card(torch):
    """Every mode at 1 and 2 layers, one and two directions, f32 with
    state_outputs: card against CPU (outputs and the gradients of data,
    flat vector and states); bf16 once; the default TF32 once."""
    from incubator_mxnet_tpu_torch.ops import registry
    fn = registry.get("RNN").fn
    H = RNN["H"]
    worst, cases = 0.0, []
    t0 = time.perf_counter()
    for i, (mode, layers, bi) in enumerate(
            (m, n, b) for m in RNN_MODES for n in (1, 2)
            for b in (False, True)):
        inputs = rnn_inputs(torch, mode, layers, bi, seed=i)
        kw = dict(state_size=H, num_layers=layers, mode=mode,
                  bidirectional=bi, state_outputs=True)
        card = rnn_forward_backward(torch, fn, inputs, kw, "cuda",
                                    torch.float32, seed=100 + i)
        host = rnn_forward_backward(torch, fn, inputs, kw, "cpu",
                                    torch.float32, seed=100 + i)
        errs = [_rel_err(torch, a, b) for a, b in zip(card[0] + card[1],
                                                      host[0] + host[1])]
        cases.append(dict(mode=mode, layers=layers, bidirectional=bi,
                          fwd_rel=max(errs[:len(card[0])]),
                          grad_rel=max(errs[len(card[0]):])))
        worst = max(worst, max(errs))
        check(max(errs) <= RNN["tol"],
              f"rnn op {mode} L={layers} bi={bi}: card vs CPU rel "
              f"{errs} > {RNN['tol']}")
    # bf16 once: does cuDNN take it (f32 is the slice's dtype)
    inputs = rnn_inputs(torch, "lstm", 2, False, seed=50)
    kw = dict(state_size=H, num_layers=2, mode="lstm", state_outputs=True)
    b16 = rnn_forward_backward(torch, fn, inputs, kw, "cuda",
                               torch.bfloat16, seed=150)
    f32 = rnn_forward_backward(torch, fn, inputs, kw, "cuda",
                               torch.float32, seed=150)
    bf16_rel = max(_rel_err(torch, a.float(), b) for a, b in
                   zip(b16[0] + b16[1], f32[0] + f32[1]))
    check(all(bool(torch.isfinite(t.float()).all())
              for t in b16[0] + b16[1]), "rnn op bf16: non-finite")
    # what the precision setting buys: one LSTM layer through torch._VF
    # at PyTorch's default RNN math (TF32) against the CPU
    inputs = rnn_inputs(torch, "lstm", 1, False, seed=60)
    w = list(_rnn_views(inputs[1], H))

    def vf(dev):
        xs = [t.to(dev).requires_grad_() for t in inputs[:1] + inputs[2:]]
        p = [t.to(dev) for t in w]
        out = torch._VF.lstm(xs[0], (xs[1], xs[2]), p, True, 1, 0.0, True,
                             False, False)
        g = torch.Generator().manual_seed(160)
        cts = [torch.randn(o.shape, generator=g).to(dev) for o in out]
        return torch.autograd.grad(out, xs, cts)
    rnn_backend = torch.backends.cudnn.rnn
    old = rnn_backend.fp32_precision
    rnn_backend.fp32_precision = "tf32"        # PyTorch's default
    try:
        card = vf("cuda")
    finally:
        rnn_backend.fp32_precision = old
    tf32_rel = max(_rel_err(torch, a, b) for a, b in zip(card, vf("cpu")))
    return dict(cases=len(cases), worst_rel=worst, by_case=cases,
                tol=RNN["tol"], bf16_vs_f32_rel=bf16_rel,
                tf32_grad_rel=tf32_rel,
                seconds=time.perf_counter() - t0)


def _rnn_views(flat, H):
    """A one-layer, one-direction LSTM's four weights in ops/rnn.py's
    layout."""
    G = 4 * H
    return (flat[:G * H].view(G, H), flat[G * H:2 * G * H].view(G, H),
            flat[2 * G * H:2 * G * H + G], flat[2 * G * H + G:])


def rnn_weight_copy(torch):
    """The cost of cuDNN's weight copy: the second layer of the 650-wide
    two-layer LSTM (forward, T=35, B=32, IEEE f32) from views of the
    JAX-layout flat vector (its biases lie after every layer's weights,
    so cuDNN packs a copy each call) against the same weights in one
    buffer laid out as cuDNN's own (no copy); median device ms, cold
    L2."""
    from incubator_mxnet_tpu_torch.ops.rnn import (_ieee_fp32, _unpack,
                                                   rnn_param_size)
    T, B, H = RNN["T"], RNN["B"], RNN["H"]
    g = torch.Generator(device="cuda").manual_seed(3)
    flat = (torch.rand(rnn_param_size(2, H, H, "lstm"), device="cuda",
                       generator=g) * 2 - 1) / H ** 0.5
    weights, biases = _unpack(flat, 2, H, H, "lstm", 1)
    views = list(weights[1][0] + biases[1][0])
    packed = torch.cat([v.reshape(-1) for v in views])
    sizes = [v.numel() for v in views]
    own = [t.view(v.shape) for t, v in zip(packed.split(sizes), views)]
    x, h, c = (torch.randn(*shape, device="cuda", generator=g) for shape in
               ((T, B, H), (1, B, H), (1, B, H)))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def run(ws):
        with _ieee_fp32(x.device):
            return torch._VF.lstm(x, (h, c), ws, True, 1, 0.0, False,
                                  False, False)
    check(max(_rel_err(torch, a, b) for a, b in zip(run(views), run(own)))
          <= RNN["tol"], "rnn weight copy: packed and copied weights "
                         "disagree")
    views_ms = _time_ms(torch, lambda: run(views), flush)
    own_ms = _time_ms(torch, lambda: run(own), flush)
    return dict(layer_forward_ms_views=views_ms,
                layer_forward_ms_cudnn_layout=own_ms,
                copy_ms=views_ms - own_ms,
                weight_bytes=packed.numel() * 4)


def word_lm(mx, vocab, units, layers, dropout):
    """MXNet 1.x's example/gluon/word_language_model ``RNNModel`` in its
    README's 650-wide tied setting: embedding, rnn.LSTM with a dropout
    between layers, dropout, the decoder tied to the embedding by
    ``params=encoder.params``."""
    from incubator_mxnet_tpu_torch.gluon import Block, nn, rnn

    class RNNModel(Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.drop = nn.Dropout(dropout)
                self.encoder = nn.Embedding(
                    vocab, units, weight_initializer=mx.init.Uniform(0.1))
                self.rnn = rnn.LSTM(units, layers, dropout=dropout,
                                    input_size=units)
                self.decoder = nn.Dense(vocab, in_units=units,
                                        params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, units))), hidden

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel()


def rnn_lm_loop(torch, np, mx):
    """(a) the example's train() loop on the card: ~20 windows, the
    hidden state carried and detached, clip_global_norm, SGD lr 20; the
    first window's loss (dropout off) on the card against the CPU from
    the same weights."""
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    R = RNN
    V, U, B, T = R["vocab"], R["H"], R["B"], R["bptt"]
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, V, (R["windows"] * T + 1, B))
    windows = [(nd.array(tokens[i * T:(i + 1) * T], dtype="int32"),
                nd.array(tokens[i * T + 1:(i + 1) * T + 1].reshape(-1),
                         dtype="int32")) for i in range(R["windows"])]
    mx.random.seed(0)
    model = word_lm(mx, V, U, 2, R["dropout"])
    model.initialize(mx.init.Xavier())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def eval_loss(m, ctx):
        data, target = (w.as_in_context(ctx) for w in windows[0])
        hidden = m.begin_state(batch_size=B, ctx=ctx)
        out, _ = m(data, hidden)
        return float(loss_fn(out, target).mean().asnumpy())

    with mx.cpu():
        host = word_lm(mx, V, U, 2, R["dropout"])
        host.initialize()
        host.load_state_dict({k: v.cpu() for k, v in
                              model.state_dict().items()})
        host_loss = eval_loss(host, mx.cpu())
    del host
    card_loss = eval_loss(model, mx.gpu(0))
    first_rel = abs(card_loss - host_loss) / abs(host_loss)
    check(first_rel <= R["first_loss_rtol"],
          f"rnn lm: first loss {card_loss} on the card, {host_loss} on the "
          f"CPU (rel {first_rel})")
    trainer = gluon.Trainer(model.collect_params(), "sgd",
                            {"learning_rate": R["lr"], "momentum": 0,
                             "wd": 0})
    params = list(model.collect_params().values())
    hidden = model.begin_state(func=nd.zeros, batch_size=B, ctx=mx.gpu(0))
    losses = []

    def window(data, target):
        nonlocal hidden
        hidden = [h.detach() for h in hidden]
        with autograd.record():
            output, hidden = model(data, hidden)
            L = loss_fn(output, target)
            L.backward()
        gluon.utils.clip_global_norm([p.grad() for p in params],
                                     R["clip"] * T * B)
        trainer.step(B)
        return L.mean()

    t_start = None
    for i, (data, target) in enumerate(windows):
        if i == R["timed_from"]:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(window(data, target))
    torch.cuda.synchronize()
    n_timed = R["windows"] - R["timed_from"]
    ms = (time.perf_counter() - t_start) * 1e3 / n_timed
    losses = [float(v.asnumpy()) for v in losses]
    check(all(np.isfinite(losses)), f"rnn lm: non-finite loss {losses}")
    out = dict(config=f"word_language_model tied: V={V}, embedding {U}, "
                      f"LSTM({U}, 2, dropout {R['dropout']}), bptt {T}, "
                      f"B={B}, f32, SGD lr {R['lr']}, clip_global_norm "
                      f"{R['clip']} x bptt x B",
               first_loss_card=card_loss, first_loss_cpu=host_loss,
               first_loss_rel=first_rel, losses=losses,
               ms_per_window=ms, tokens_per_s=T * B / (ms / 1e3))
    out.update(busy_share(torch, lambda: window(*windows[0]).asnumpy()))
    return out


def rnn_lm_step_graph(torch, np, mx):
    """(b) the same model through SPMDTrainer(forward_loss=...): a zero
    begin state a batch, SGD with clip_gradient; one capture; the first
    steps against the step body run eagerly by a second trainer from the
    same weights, each pair of steps drawing its dropout masks from the
    generator reseeded alike."""
    from incubator_mxnet_tpu_torch import gluon, nd, parallel
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    try:
        from test_torch_train_graphs import _eager_step
    finally:
        sys.path.pop(0)
    R = RNN
    V, U, B, T = R["vocab"], R["H"], R["B"], R["bptt"]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def forward_loss(model, data, target):
        hidden = model.begin_state(batch_size=B, ctx=data.context)
        out, _ = model(data, hidden)
        return loss_fn(out, target).mean()

    models = []
    for _ in range(2):
        mx.random.seed(1)
        m = word_lm(mx, V, U, 2, R["dropout"])
        m.initialize(mx.init.Xavier())
        models.append(m)
    models[1].load_state_dict(models[0].state_dict())
    opt = {"learning_rate": R["lr"], "clip_gradient": R["clip"]}
    tr, ref = (parallel.SPMDTrainer(m, forward_loss=forward_loss,
                                    optimizer="sgd",
                                    optimizer_params=dict(opt),
                                    sharding="replicated") for m in models)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, V, (T + 1, B))
    data = nd.array(tokens[:T], dtype="int32")
    target = nd.array(tokens[1:].reshape(-1), dtype="int32")
    gen = mx.random.generator(torch.device("cuda", 0))
    losses, eager = [], []
    for i in range(R["warmup"]):
        gen.manual_seed(10 + i)
        losses.append(float(tr.step(data, target).asnumpy()))
        gen.manual_seed(10 + i)
        eager.append(float(_eager_step(ref, [data._data, target._data])))
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, eager)]
    check(max(rels) <= R["loss_rtol"],
          f"rnn lm step graph: replays {losses} against the eager body "
          f"{eager} (rel {rels})")
    prog = next(iter(tr._programs.values()))
    replays = prog.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [tr.step(data, target) for _ in range(R["steps"])]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / R["steps"]
    losses += [float(v.asnumpy()) for v in timed]
    check(all(np.isfinite(losses)), f"rnn lm step graph: {losses}")
    check(tr.step_trace_count == 1 and
          prog.replays - replays == R["steps"],
          f"rnn lm step graph: {tr.step_trace_count} builds, "
          f"{prog.replays - replays} of {R['steps']} steps replayed")
    out = dict(optimizer=f"sgd lr {R['lr']} clip_gradient {R['clip']}",
               losses=losses, eager_body_losses=eager, loss_rel=rels,
               ms_per_step=ms, tokens_per_s=T * B / (ms / 1e3),
               step_trace_count=tr.step_trace_count,
               first_step_ms=prog.first_ms, capture_ms=prog.build_ms)
    out.update(busy_share(torch, lambda: tr.step(data, target)))
    return out


def phase_rnn(torch, smi):
    """Recurrent networks on the card (module docstring, 7c6)."""
    import warnings

    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        op = rnn_op_on_card(torch)
        op["weight_copy"] = rnn_weight_copy(torch)
        loop = rnn_lm_loop(torch, np, mx)
        graph = rnn_lm_step_graph(torch, np, mx)
    # cuDNN's weight copy where the views are not its packed buffer: kept
    # and reported, not silenced
    copy_warnings = sorted({str(w.message)[:120] for w in caught
                            if "contiguous chunk" in str(w.message)})
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(card=smi, op=op, gluon_loop=loop, step_graph=graph,
               weight_copy_warnings=copy_warnings,
               phase_s=time.perf_counter() - t0)
    print(f"[rnn] {smi}: RNN op {op['cases']} cases card vs CPU worst "
          f"rel {op['worst_rel']:.2e} (tol {op['tol']}; cuDNN's TF32 "
          f"default: grad rel {op['tf32_grad_rel']:.2e}); bf16 taken, rel "
          f"{op['bf16_vs_f32_rel']:.2e} vs f32; cuDNN's weight copy "
          f"{op['weight_copy']['copy_ms']:.4f} ms of a "
          f"{op['weight_copy']['layer_forward_ms_views']:.4f} ms layer "
          f"forward; word LM 650 tied V=33278: "
          f"first loss rel {loop['first_loss_rel']:.2e}, gluon loop "
          f"{loop['ms_per_window']:.2f} ms/window (busy "
          f"{loop.get('device_busy_share')}), losses "
          f"{loop['losses'][0]:.3f} -> {loop['losses'][-1]:.3f}; step "
          f"graph {graph['ms_per_step']:.2f} ms/step, builds "
          f"{graph['step_trace_count']}, replay vs eager rel "
          f"{max(graph['loss_rel']):.2e}", flush=True)
    print(f"[rnn] {json.dumps(out)}", flush=True)


# --------------------------------------------------------------------- #
# int8 post-training quantization (module docstring, phase 7c7)
# --------------------------------------------------------------------- #
QUANT = dict(B=32, side=224, classes=1000, calib=4, small_B=2, reps=10)


def quant_op_cases(torch):
    """(name, inputs, keywords) of the six ops at shapes that need the
    card's int8 product padded (k = 147, m <= 16) and at ResNet-50's."""
    g = torch.Generator().manual_seed(0)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int32).to(torch.int8)

    def f(*shape):
        return torch.randn(*shape, generator=g)

    r = [torch.tensor(v) for v in (-1.0, 1.0, -0.5, 0.5)]
    stem = dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=64)
    return [
        ("quantize", [f(64, 1000), torch.tensor(-2.0), torch.tensor(3.0)],
         dict(out_type="uint8")),
        ("quantize", [f(64, 1000), torch.tensor(-2.0), torch.tensor(3.0)],
         dict(out_type="int8")),
        ("quantize_v2", [f(32, 64, 56, 56)], {}),
        ("quantize_v2", [f(32, 64, 56, 56)],
         dict(min_calib_range=-1.5, max_calib_range=1.5)),
        ("dequantize", [codes(32, 64, 56, 56), torch.tensor(-1.0),
                        torch.tensor(2.0)], {}),
        ("requantize", [torch.randint(-(1 << 20), 1 << 20, (64, 1000),
                                      generator=g, dtype=torch.int32),
                        torch.tensor(-1000.0), torch.tensor(1000.0)], {}),
        ("requantize", [torch.randint(-(1 << 20), 1 << 20, (64, 1000),
                                      generator=g, dtype=torch.int32),
                        torch.tensor(-1000.0), torch.tensor(1000.0)],
         dict(min_calib_range=-0.25, max_calib_range=0.25)),
        ("quantized_fully_connected",
         [codes(5, 147), codes(9, 147), f(9)] + r, dict(num_hidden=9)),
        ("quantized_fully_connected",
         [codes(32, 2048), codes(1000, 2048), f(1000)] + r,
         dict(num_hidden=1000)),
        ("quantized_conv", [codes(2, 3, 224, 224), codes(64, 3, 7, 7),
                            f(64)] + r, stem),
        ("quantized_conv", [codes(8, 64, 56, 56), codes(64, 64, 3, 3),
                            f(64)] + r,
         dict(kernel=(3, 3), pad=(1, 1), num_filter=64)),
        ("quantized_conv", [codes(2, 4, 9, 8), codes(6, 2, 3, 3), f(6)] + r,
         dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2), num_filter=6,
              num_group=2)),
    ]


def quant_ops_on_card(torch):
    """Each case on the card against the port on the CPU: every output
    bitwise (codes, ranges, float outputs); the int32 accumulators of the
    products bitwise."""
    from incubator_mxnet_tpu_torch.ops import registry
    from incubator_mxnet_tpu_torch.ops.quantization import (int8_conv,
                                                            int8_matmul)
    n_out = 0
    for name, inputs, kw in quant_op_cases(torch):
        fn = registry.get(name).fn
        card = fn(*[t.cuda() for t in inputs], **kw)
        host = fn(*inputs, **kw)
        card = card if isinstance(card, tuple) else (card,)
        host = host if isinstance(host, tuple) else (host,)
        for a, b in zip(card, host):
            check(a.dtype == b.dtype and torch.equal(a.cpu(), b),
                  f"quantization op {name} {kw}: card != CPU (max |diff| "
                  f"{(a.cpu().double() - b.double()).abs().max()})")
            n_out += 1
        if name == "quantized_fully_connected":
            acc = [int8_matmul(x, w) for x, w in
                   ((inputs[0].cuda(), inputs[1].cuda()),
                    (inputs[0], inputs[1]))]
        elif name == "quantized_conv":
            conv = [kw.get(k, d) for k, d in (("stride", (1, 1)),
                                              ("pad", (0, 0)),
                                              ("dilate", (1, 1)),
                                              ("num_group", 1))]
            acc = [int8_conv(x, w, *conv) for x, w in
                   ((inputs[0].cuda(), inputs[1].cuda()),
                    (inputs[0], inputs[1]))]
        else:
            continue
        check(acc[0].dtype == torch.int32 and
              torch.equal(acc[0].cpu(), acc[1]),
              f"quantization op {name} {kw}: int32 accumulators differ")
    return n_out


def quantized_twin(qnet, fnet):
    """``fnet`` (the float net of the same structure) with each layer
    that ``qnet`` quantized swapped for its int8 twin at ``qnet``'s
    threshold (the same int8 weights, made on ``fnet``'s device)."""
    from incubator_mxnet_tpu_torch.contrib.quantization import (
        QuantizedConv2D, QuantizedDense)
    for name, qc in qnet._children.items():
        fc = fnet._children[name]
        if isinstance(qc, (QuantizedDense, QuantizedConv2D)):
            twin = type(qc)(fc, qc._thresh)
            fnet._children[name] = twin
            setattr(fnet, name, twin)
        else:
            quantized_twin(qc, fc)
    return fnet


def quantized_layers(net):
    from incubator_mxnet_tpu_torch.contrib.quantization import (
        QuantizedConv2D, QuantizedDense)
    return [b for b in net.modules()
            if isinstance(b, (QuantizedDense, QuantizedConv2D))]


def record_inputs(torch, net, codes, inputs=None):
    """Forward pre-hooks keeping each quantized layer's input codes (and,
    with ``inputs``, the input itself on the host)."""
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.contrib.quantization import \
        QuantizedDense
    for block in quantized_layers(net):
        def hook(blk, args):
            x = args[0]
            if inputs is not None:
                inputs.append(x._data.detach().cpu().clone())
            if isinstance(blk, QuantizedDense) and blk._flatten and \
                    x.ndim > 2:
                x = nd.flatten(x)
            q = nd.quantize_v2(x, min_calib_range=-blk._thresh,
                               max_calib_range=blk._thresh)[0]
            codes.append(q._data.cpu().to(torch.int16))
        block.register_forward_pre_hook(hook)


def quant_resnet50(torch, np, mx):
    """quantize_net on resnet50_v1 (1000 classes, seeded weights, 224²),
    naive calibration on 4 seeded batches of 32; the int8 net on the card
    against the same int8 net on the CPU, against the f32 net, timed and
    profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.contrib import quantization
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    Q = QUANT
    B, side = Q["B"], Q["side"]
    rng = np.random.RandomState(0)
    nets = []
    for ctx in (mx.gpu(0), mx.gpu(0), mx.cpu()):
        with ctx:
            mx.random.seed(0)
            net = resnet50_v1(classes=Q["classes"])
            net.initialize(mx.init.Xavier())
            net(nd.array(np.zeros((1, 3, side, side), np.float32)))
            nets.append(net)
    fnet, qnet, host = nets
    state = fnet.state_dict()
    qnet.load_state_dict(state)
    host.load_state_dict({k: v.cpu() for k, v in state.items()})
    calib = [nd.array(rng.randn(B, 3, side, side).astype(np.float32))
             for _ in range(Q["calib"])]
    t0 = time.perf_counter()
    quantization.quantize_net(qnet, calib_data=calib, calib_mode="naive")
    calib_s = time.perf_counter() - t0
    n_int8 = sum(isinstance(b, (quantization.QuantizedConv2D,
                                quantization.QuantizedDense))
                 for b in qnet.modules())
    with mx.cpu():
        quantized_twin(qnet, host)
    # the int8 net on the card against itself on the CPU: each quantized
    # layer on the CPU chain's own input, then the two chains as they run
    small = rng.randn(Q["small_B"], 3, side, side).astype(np.float32)
    codes_card, codes_host, host_inputs = [], [], []
    record_inputs(torch, qnet, codes_card)
    record_inputs(torch, host, codes_host, host_inputs)
    card_logits = qnet(nd.array(small)).asnumpy()
    with mx.cpu():
        host_logits = host(nd.array(small)).asnumpy()
    for blk in list(qnet.modules()) + list(host.modules()):
        if hasattr(blk, "_gluon_pre_hooks"):
            blk._gluon_pre_hooks.clear()
    check(len(codes_card) == len(codes_host) == len(host_inputs) == n_int8,
          f"quantization: {len(codes_card)} / {len(codes_host)} layers "
          f"hooked of {n_int8}")
    layer_bitwise = 0
    for qb, hb, x in zip(quantized_layers(qnet), quantized_layers(host),
                         host_inputs):
        got = qb(nd.array(x, ctx=mx.gpu(0)))._data.cpu()
        with mx.cpu():
            want = hb(nd.array(x))._data
        layer_bitwise += bool(torch.equal(got, want))
    check(layer_bitwise == n_int8,
          f"quantization: {n_int8 - layer_bitwise} int8 layers differ card "
          f"against CPU on the same input")
    per_layer = [(a - b).abs() for a, b in zip(codes_card, codes_host)]
    flipped = [int((d > 0).sum()) for d in per_layer]
    worst = [int(d.max()) for d in per_layer]
    first = next((i for i, n in enumerate(flipped) if n), None)
    # the first layer whose input codes differ: its float input differs in
    # the last bits only, so a code moves by one quantum at a rounding
    # edge; later layers inherit the moved codes through the chain
    check(first is None or worst[first] <= 1,
          f"quantization: the first diverging layer ({first}) has codes "
          f"{worst[first] if first is not None else 0} quanta apart")
    total = sum(d.numel() for d in per_layer)
    logit_rel = float(np.abs(card_logits - host_logits).max()
                      / np.abs(host_logits).max())
    # int8 against f32, timed
    x = nd.array(rng.randn(B, 3, side, side).astype(np.float32))
    f32 = fnet(x).asnumpy()
    int8 = qnet(x).asnumpy()
    check(np.isfinite(int8).all(), "quantization: non-finite int8 logits")
    top1 = float((f32.argmax(1) == int8.argmax(1)).mean())
    rel = float(np.linalg.norm(int8 - f32) / np.linalg.norm(f32))
    times = {}
    for label, net in (("f32", fnet), ("int8", qnet)):
        net(x).asnumpy()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(Q["reps"]):
            net(x)
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t1) * 1e3 / Q["reps"]
    profiles = {label: busy_share(torch, lambda n=net: n(x).asnumpy())
                for label, net in (("f32", fnet), ("int8", qnet))}
    # the int8 products: cuBLASLt's int8 kernels under aten::_int_mm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        qnet(x).asnumpy()
    ev = prof.key_averages()
    int_mm = sum(e.count for e in ev if e.key == "aten::_int_mm")
    kern = [(e.key, e.self_device_time_total) for e in ev
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    gemm = [(k, t) for k, t in kern
            if re.search(r"(^|[^a-z])(s8|i8|int8|imma)|i8816|i16832|"
                         r"i161616", k)]
    busy = sum(t for _, t in kern)
    check(int_mm == n_int8, f"quantization: {int_mm} aten::_int_mm calls "
                            f"for {n_int8} int8 layers")
    check(gemm, "quantization: no int8 GEMM kernel in the profile: "
                f"{[k[:80] for k, _ in kern][:12]}")
    return dict(config=f"resnet50_v1 ({Q['classes']} classes, Xavier "
                       f"seed 0) f32 {side}x{side}; quantize_net naive on "
                       f"{Q['calib']} seeded batches of {B}",
                int8_layers=n_int8, calib_s=calib_s,
                card_vs_cpu=dict(batch=Q["small_B"],
                                 layers_bitwise_on_same_input=layer_bitwise,
                                 codes=total, codes_flipped=sum(flipped),
                                 flipped_share=sum(flipped) / total,
                                 first_diverging_layer=first,
                                 worst_code_diff_by_layer=worst,
                                 flipped_by_layer=flipped,
                                 logits_rel=logit_rel,
                                 top1_equal=bool((card_logits.argmax(1) ==
                                                  host_logits.argmax(1))
                                                 .all())),
                top1_agreement_int8_vs_f32=top1, logits_rel_int8_vs_f32=rel,
                ms_per_batch_f32=times["f32"], ms_per_batch_int8=times["int8"],
                int_mm_calls=int_mm,
                int8_gemm_kernels=sorted({k[:120] for k, _ in gemm}),
                int8_gemm_share_of_busy=sum(t for _, t in gemm) / busy,
                profile_f32=profiles["f32"], profile_int8=profiles["int8"])


def phase_quantization(torch, smi):
    """int8 post-training quantization on the card (module docstring,
    7c7)."""
    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    n_out = quant_ops_on_card(torch)
    net = quant_resnet50(torch, np, mx)
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(card=smi, op_outputs_bitwise=n_out, resnet50=net,
               phase_s=time.perf_counter() - t0)
    cv = net["card_vs_cpu"]
    print(f"[quantization] {smi}: {n_out} op outputs and the int32 "
          f"accumulators card == CPU bitwise; resnet50_v1 int8 "
          f"({net['int8_layers']} layers, each bitwise card vs CPU on one "
          f"input): chained codes {cv['flipped_share']:.2e} flipped (first "
          f"at layer {cv['first_diverging_layer']}, worst "
          f"{max(cv['worst_code_diff_by_layer'])}), logits rel "
          f"{cv['logits_rel']:.2e}; top-1 vs f32 "
          f"{net['top1_agreement_int8_vs_f32']:.3f}, rel "
          f"{net['logits_rel_int8_vs_f32']:.3e}; "
          f"{net['ms_per_batch_int8']:.1f} ms/batch int8 vs "
          f"{net['ms_per_batch_f32']:.1f} f32 (B={QUANT['B']}); int8 "
          f"GEMMs {net['int8_gemm_share_of_busy']:.2f} of busy", flush=True)
    print(f"[quantization] {json.dumps(out)}", flush=True)


# --------------------------------------------------------------------- #
# sparse storage: matrix factorization and LibSVM (module docstring, 7g)
# --------------------------------------------------------------------- #
MF = dict(users=71569, items=65135, factor=128, hidden=64, B=128,
          lr=0.05, momentum=0.9, alpha=1.0, rank=8, parity_steps=3,
          steps=200, timed=50, sync_steps=5)
A9A = dict(rows=32561, features=123, nnz=(11, 15), B=128, epochs=2,
           lr=0.5)


def fresh_names():
    """The port's block and symbol name counters back to zero (two
    builds of one model then carry the same parameter names)."""
    from incubator_mxnet_tpu_torch.gluon import block
    from incubator_mxnet_tpu_torch.symbol import symbol
    block._naming.counter = {}
    symbol._name_counters.clear()


def mf_net(gluon):
    """MXNet 1.x example/sparse/matrix_factorization's matrix_fact_net in
    gluon: a row-sparse embedding each for users and items, a Dense each,
    their product summed over the hidden units."""
    class MatrixFact(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.user = gluon.contrib.nn.SparseEmbedding(
                    MF["users"], MF["factor"])
                self.item = gluon.contrib.nn.SparseEmbedding(
                    MF["items"], MF["factor"])
                self.user_fc = gluon.nn.Dense(MF["hidden"],
                                              in_units=MF["factor"])
                self.item_fc = gluon.nn.Dense(MF["hidden"],
                                              in_units=MF["factor"])

        def hybrid_forward(self, F, u, i):
            return (self.user_fc(self.user(u))
                    * self.item_fc(self.item(i))).sum(axis=1)
    return MatrixFact()


def mf_batches(np, n, seed=0):
    """``n`` batches of (user, item, rating): ids from a power law over
    each range (popular ids spread over it), ratings from a low-rank
    target in MovieLens' half-star steps, 0.5 to 5."""
    rng = np.random.RandomState(seed)
    B = MF["B"]

    def ids(n_ids):
        p = np.arange(1, n_ids + 1, dtype=np.float64) ** -MF["alpha"]
        return rng.permutation(n_ids)[rng.choice(n_ids, n * B, p=p / p.sum())]
    users, items = ids(MF["users"]), ids(MF["items"])
    U = rng.randn(MF["users"], MF["rank"]) * 0.5
    V = rng.randn(MF["items"], MF["rank"]) * 0.5
    r = np.clip(np.round(2 * (3.5 + (U[users] * V[items]).sum(1))) / 2,
                0.5, 5.0)
    return [(users[k * B:(k + 1) * B].astype(np.float32),
             items[k * B:(k + 1) * B].astype(np.float32),
             r[k * B:(k + 1) * B].astype(np.float32)) for k in range(n)]


def mf_trainer(gluon, net):
    return gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": MF["lr"],
                          "momentum": MF["momentum"], "lazy_update": True})


def mf_step(mx, net, tr, batch, ctx):
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    u, i, r = (nd.array(a, ctx=ctx) for a in batch)
    with autograd.record():
        L = gluon.loss.L2Loss()(net(u, i), r)
    L.backward()
    tr.step(MF["B"])
    return L.mean()


def mf_tables(tr, net):
    """(weight, momentum) tensors of the two row-sparse tables."""
    out = []
    for emb in (net.user, net.item):
        p = emb.weight
        idx = tr._params.index(p)
        out.append((p.data()._data, tr._updaters[0].states[idx]))
    return out


def mf_card_vs_cpu(torch, np, mx, net, batches):
    """The same weights on the card and on the CPU, ``parity_steps``
    steps each: losses and every parameter within 1e-5 relative."""
    from incubator_mxnet_tpu_torch import gluon
    with mx.cpu():
        fresh_names()
        host = mf_net(gluon)
        host.initialize()
        card_params = net._collect_params_with_prefix()
        for name, p in host._collect_params_with_prefix().items():
            p.set_data(card_params[name].data().asnumpy())
        host_tr = mf_trainer(gluon, host)
        host_losses = [float(mf_step(mx, host, host_tr, b, mx.cpu())
                             .asnumpy())
                       for b in batches[:MF["parity_steps"]]]
    tr = mf_trainer(gluon, net)
    card_losses = [float(mf_step(mx, net, tr, b, mx.gpu(0)).asnumpy())
                   for b in batches[:MF["parity_steps"]]]
    loss_rel = max(abs(c - h) / abs(h)
                   for c, h in zip(card_losses, host_losses))
    param_rel = 0.0
    host_params = host._collect_params_with_prefix()
    for name, p in net._collect_params_with_prefix().items():
        a = p.data().asnumpy()
        b = host_params[name].data().asnumpy()
        param_rel = max(param_rel, float(np.abs(a - b).max()
                                         / np.abs(b).max()))
    check(loss_rel <= 1e-5 and param_rel <= 1e-5,
          f"sparse: MF card vs CPU after {MF['parity_steps']} steps: loss "
          f"rel {loss_rel:.2e}, parameter rel {param_rel:.2e}")
    return tr, dict(losses_card=card_losses, losses_cpu=host_losses,
                    loss_rel=loss_rel, param_rel=param_rel)


def mf_training(torch, np, mx, net, tr, batches):
    """``steps`` steps; after each, the rows its batch did not look up
    are bitwise unchanged in both tables' weight and momentum (one device
    flag, read at the end)."""
    tables = mf_tables(tr, net)
    dev = tables[0][0].device
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    losses = []
    for u, i, r in batches:
        before = [(w.clone(), m.clone()) for w, m in tables]
        losses.append(mf_step(mx, net, tr, (u, i, r), mx.gpu(0)))
        for (w, m), (w0, m0), ids in zip(tables, before, (u, i)):
            seen = torch.zeros(w.shape[0], dtype=torch.bool, device=dev)
            seen[torch.from_numpy(ids.astype(np.int64)).to(dev)] = True
            moved = (w != w0).any(1) | (m != m0).any(1)
            bad |= (moved & ~seen).any()
    losses = [float(v.asnumpy()) for v in losses]
    check(bool(np.isfinite(losses).all()), "sparse: non-finite MF loss")
    check(not bool(bad.item()),
          "sparse: a row no batch looked up moved (weight or momentum)")
    head, tail = np.mean(losses[:20]), np.mean(losses[-20:])
    check(tail < head, f"sparse: MF loss did not fall ({head} -> {tail})")
    return dict(losses=losses[::20] + [losses[-1]], first20=head,
                last20=tail, untouched_rows_bitwise=True)


def mf_pull(torch, np, mx, net, batch):
    """``row_sparse_pull`` of a batch's user rows from a local kvstore
    holding the user table: the rows, bitwise."""
    from incubator_mxnet_tpu_torch import nd
    w = net.user.weight.data()
    kv = mx.kv.create("local")
    kv.init("user_weight", w)
    out = nd.sparse.zeros("row_sparse", w.shape, ctx=mx.gpu(0))
    kv.row_sparse_pull("user_weight", out=out,
                       row_ids=nd.array(batch[0], ctx=mx.gpu(0)))
    want = np.unique(batch[0].astype(np.int64))
    check(np.array_equal(out.indices.asnumpy(), want),
          "sparse: row_sparse_pull indices are not the batch's rows")
    check(torch.equal(out.data._data, w._data[torch.from_numpy(want)
                                              .to(w._data.device)]),
          "sparse: row_sparse_pull rows differ from the table's")
    return len(want)


def mf_nan_skip(torch, np, mx, net, tr, batch):
    """A NaN rating: the step is skipped, every parameter and state
    bitwise unchanged."""
    from incubator_mxnet_tpu_torch.optimizer.fused import tree_leaves
    params = [p.data()._data for p in net.collect_params().values()]
    states = [s for st in tr._updaters[0].states.values()
              for s in tree_leaves(st)]
    before = [t.clone() for t in params + states]
    skipped = tr._fused.skipped_steps
    u, i, r = batch
    r = r.copy()
    r[5] = np.nan
    mf_step(mx, net, tr, (u, i, r), mx.gpu(0))
    check(tr._fused.skipped_steps == skipped + 1,
          "sparse: the NaN step was not skipped")
    check(all(torch.equal(a, b) for a, b in zip(params + states, before)),
          "sparse: the skipped step changed a parameter or a state")
    return str(tr.last_outcome.value)


def mf_costs(torch, np, mx, net, tr, batches):
    """ms a step (``timed`` steps), host syncs and active rows a step, and
    one profiled step's busy share."""
    import warnings
    for b in batches[:3]:
        mf_step(mx, net, tr, b, mx.gpu(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[:MF["timed"]]:
        last = mf_step(mx, net, tr, b, mx.gpu(0))
    last.asnumpy()
    ms = (time.perf_counter() - t0) * 1e3 / MF["timed"]
    syncs = []
    active = []
    from incubator_mxnet_tpu_torch.ndarray.sparse import _row_sparse_of
    for b in batches[:MF["sync_steps"]]:
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                mf_step(mx, net, tr, b, mx.gpu(0))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        active.append(sum(_row_sparse_of(e.weight.grad()._data).nnz
                          for e in (net.user, net.item)))
    looked_up = [len(np.unique(b[0])) + len(np.unique(b[1]))
                 for b in batches[:MF["sync_steps"]]]
    out = dict(ms_per_step=ms, samples_per_s=MF["B"] / (ms / 1e3),
               host_syncs_per_step=syncs, active_rows_per_step=active,
               looked_up_rows_per_step=looked_up)
    out.update(busy_share(torch, lambda: mf_step(
        mx, net, tr, batches[0], mx.gpu(0)).asnumpy()))
    return out


def a9a_file(np, path):
    """A seeded LibSVM file at a9a's shape: 123 binary features, 11-14
    set a row, 0/1 labels from a noisy linear rule."""
    rng = np.random.RandomState(1)
    w = rng.randn(A9A["features"])
    lo, hi = A9A["nnz"]
    with open(path, "w") as f:
        for _ in range(A9A["rows"]):
            cols = np.sort(rng.choice(A9A["features"], rng.randint(lo, hi),
                                      replace=False))
            label = int(w[cols].sum() + rng.randn() > 0)
            f.write(f"{label} " + " ".join(f"{c}:1" for c in cols) + "\n")


def a9a_fit(np, mx, path, ctx, epochs):
    """LibSVMIter -> Module.fit: 2-class logistic regression, the
    per-batch cross-entropy."""
    losses = []

    def record(param):
        losses.append(param.eval_metric.get()[1])
        param.eval_metric.reset()
    rng = np.random.RandomState(2)
    params = {"fc_weight": rng.randn(2, A9A["features"]) * 0.01,
              "fc_bias": np.zeros(2)}
    fresh_names()
    data = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(data, num_hidden=2, name="fc"),
        mx.sym.Variable("softmax_label"), name="softmax")
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(A9A["features"],),
                          batch_size=A9A["B"])
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(it, eval_metric=mx.metric.CrossEntropy(),
            batch_end_callback=record, optimizer="sgd",
            optimizer_params={"learning_rate": A9A["lr"],
                              "rescale_grad": 1.0 / A9A["B"]},
            arg_params={k: mx.nd.array(v.astype(np.float32), ctx=ctx)
                        for k, v in params.items()}, num_epoch=epochs)
    return mod, losses


def a9a_module(torch, np, mx, tmp):
    path = os.path.join(tmp, "a9a.libsvm")
    t0 = time.perf_counter()
    a9a_file(np, path)
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod, card = a9a_fit(np, mx, path, mx.gpu(0), A9A["epochs"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    with mx.cpu():
        _, host = a9a_fit(np, mx, path, mx.cpu(), 1)
    per_epoch = len(host)
    rel = max(abs(c - h) / abs(h) for c, h in zip(card[:per_epoch], host))
    check(rel <= 1e-5, f"sparse: a9a first-epoch losses card vs CPU rel "
                       f"{rel:.2e}")
    head, tail = np.mean(card[:20]), np.mean(card[-20:])
    check(bool(np.isfinite(card).all()) and tail < head,
          f"sparse: a9a loss did not fall ({head} -> {tail})")
    return dict(config=f"a9a shape: {A9A['rows']} rows x "
                       f"{A9A['features']} features, {A9A['nnz'][0]}-"
                       f"{A9A['nnz'][1] - 1} set a row (seeded file), "
                       f"B={A9A['B']}, SGD lr {A9A['lr']} (rescale 1/B), "
                       f"{A9A['epochs']} epochs",
                batches_per_epoch=per_epoch, first_epoch_rel=rel,
                loss_first20=head, loss_last20=tail, write_s=write_s,
                fit_s=fit_s, ms_per_batch=fit_s * 1e3 / len(card),
                signature_counts={str(k): v for k, v in
                                  mod._exec.signature_counts().items()})


def phase_sparse(torch, smi):
    """Sparse storage on the card (module docstring, 7g); returns the MF
    net, its trainer and batches for the contrib phase."""
    import tempfile

    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    batches = mf_batches(np, MF["steps"])
    data_s = time.perf_counter() - t0
    mx.random.seed(0)
    fresh_names()
    net = mf_net(gluon)
    net.initialize(ctx=mx.gpu(0))
    tr, parity = mf_card_vs_cpu(torch, np, mx, net, batches)
    train = mf_training(torch, np, mx, net, tr, batches)
    pulled = mf_pull(torch, np, mx, net, batches[7])
    outcome = mf_nan_skip(torch, np, mx, net, tr, batches[8])
    costs = mf_costs(torch, np, mx, net, tr, batches)
    with tempfile.TemporaryDirectory() as tmp:
        a9a = a9a_module(torch, np, mx, tmp)
    out = dict(card=smi, mf=dict(
        config=f"matrix_fact_net at MovieLens-10M's id ranges: users "
               f"{MF['users']}, items {MF['items']}, SparseEmbedding "
               f"{MF['factor']} -> Dense {MF['hidden']} each, L2 loss, f32, "
               f"B={MF['B']}, SGD lr {MF['lr']} momentum {MF['momentum']} "
               f"lazy_update; seeded power-law ids, low-rank ratings",
        card_vs_cpu=parity, training=train, pulled_rows=pulled,
        nan_step=outcome, skipped_steps=tr._fused.skipped_steps,
        trace_count=tr._fused.trace_count,
        guard_trace_count=tr._fused.guard_trace_count,
        data_s=data_s, **costs), a9a=a9a,
        phase_s=time.perf_counter() - t0)
    print(f"[sparse] {smi}: MF {costs['ms_per_step']:.2f} ms/step (busy "
          f"{costs.get('device_busy_share')}), host syncs a step "
          f"{costs['host_syncs_per_step']}, active rows a step "
          f"{costs['active_rows_per_step']}; card vs CPU loss rel "
          f"{parity['loss_rel']:.2e}, params {parity['param_rel']:.2e}; "
          f"loss {train['first20']:.3f} -> {train['last20']:.3f} over "
          f"{MF['steps']} steps, untouched rows bitwise; row_sparse_pull "
          f"{pulled} rows bitwise; NaN step skipped; a9a LibSVMIter -> "
          f"Module.fit first epoch rel {a9a['first_epoch_rel']:.2e}, loss "
          f"{a9a['loss_first20']:.4f} -> {a9a['loss_last20']:.4f}",
          flush=True)
    print(f"[sparse] {json.dumps(out)}", flush=True)
    return net, tr, batches


# --------------------------------------------------------------------- #
# mx.contrib and the small modules (module docstring, 7h)
# --------------------------------------------------------------------- #
def contrib_onnx(torch, np, mx, tmp):
    """resnet50_v1 f32 224² exported by the port on the card, imported
    back and bound by the Executor there; the same weights exported from
    a CPU copy: byte-equal files."""
    from incubator_mxnet_tpu_torch import nd
    from incubator_mxnet_tpu_torch.contrib import onnx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    x = np.random.RandomState(0).rand(2, 3, 224, 224).astype(np.float32)
    mx.random.seed(0)
    fresh_names()
    net = vision.resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    xd = nd.array(x, ctx=mx.gpu(0))
    logits = net(xd).asnumpy()
    sym, _ = mx.sym.trace_block(net)
    params = {p.name: p.data() for p in net.collect_params().values()}
    t0 = time.perf_counter()
    card_file = onnx.export_model(sym, params, {"data": x.shape},
                                  os.path.join(tmp, "card.onnx"))
    export_s = time.perf_counter() - t0
    with mx.cpu():
        fresh_names()
        host = vision.resnet50_v1()
        host.initialize()
        host(nd.array(x[:1]))
        src = net._collect_params_with_prefix()
        for name, p in host._collect_params_with_prefix().items():
            p.set_data(src[name].data().asnumpy())
        hsym, _ = mx.sym.trace_block(host)
        host_file = onnx.export_model(
            hsym, {p.name: p.data() for p in host.collect_params().values()},
            {"data": x.shape}, os.path.join(tmp, "cpu.onnx"))
    with open(card_file, "rb") as f:
        blob = f.read()
    with open(host_file, "rb") as f:
        check(f.read() == blob, "contrib: the ONNX files written on the "
                                "card and on the CPU differ")
    t0 = time.perf_counter()
    isym, args, _ = onnx.import_model(card_file)
    import_s = time.perf_counter() - t0
    aux_names = set(isym.list_auxiliary_states())
    exe = isym.simple_bind(mx.gpu(0), grad_req="null", data=x.shape)
    exe.copy_params_from(
        {k: v for k, v in args.items() if k not in aux_names},
        {k: v for k, v in args.items() if k in aux_names})
    out = exe.forward(is_train=False, data=xd)[0].asnumpy()
    rel = float(np.abs(out - logits).max() / np.abs(logits).max())
    check(rel <= 1e-4, f"contrib: imported resnet50_v1 logits rel {rel:.2e}")
    n_nodes = len(onnx.graph_to_ir(sym, params, {"data": x.shape})["nodes"])
    return dict(model="resnet50_v1 f32 224x224 B=2", nodes=n_nodes,
                bytes=len(blob), byte_equal_card_cpu=True,
                logits_rel=rel, export_s=export_s, import_s=import_s)


def contrib_svrg(torch, np, mx):
    """SVRGModule on a linear regression at YearPredictionMSD's 90
    features (MXNet 1.x's example/svrg_module), seeded data."""
    from incubator_mxnet_tpu_torch.contrib import SVRGModule
    rng = np.random.RandomState(3)
    X = rng.randn(4096, 90).astype(np.float32)
    y = (X @ (rng.randn(90) * 0.1) + 0.1 * rng.randn(4096)) \
        .astype(np.float32)

    def it():
        return mx.io.NDArrayIter(X, y, batch_size=128, shuffle=False,
                                 label_name="lin_reg_label")

    def module():
        fresh_names()
        data = mx.sym.Variable("data")
        sym = mx.sym.LinearRegressionOutput(
            mx.sym.FullyConnected(data, num_hidden=1, name="fc"),
            mx.sym.Variable("lin_reg_label"), name="lro")
        return SVRGModule(sym, data_names=["data"],
                          label_names=["lin_reg_label"], update_freq=2,
                          context=mx.gpu(0))
    mod = module()
    d = it()
    mod.bind(data_shapes=d.provide_data, label_shapes=d.provide_label)
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.0})
    mod.update_full_grads(d)
    d.reset()
    mod.forward_backward(next(iter(d)))
    exact = max(float((mod._exec.grad_dict[n]._data - mu._data).abs().max()
                      / mu._data.abs().max())
                for n, mu in mod._mu.items())
    check(exact <= 1e-6, f"contrib: SVRG gradient at the snapshot off mu "
                         f"by {exact:.2e}")
    losses = []

    def record(param):
        losses.append(param.eval_metric.get()[1])
        param.eval_metric.reset()
    mod = module()
    t0 = time.perf_counter()
    mod.fit(it(), eval_metric="mse", optimizer="sgd",
            optimizer_params={"learning_rate": 0.005,
                              "rescale_grad": 1.0 / 128}, num_epoch=4,
            batch_end_callback=record, initializer=mx.init.Xavier())
    fit_s = time.perf_counter() - t0
    check(bool(np.isfinite(losses).all())
          and np.mean(losses[-8:]) < np.mean(losses[:8]),
          f"contrib: SVRG loss did not fall ({losses[:3]} ... "
          f"{losses[-3:]})")
    return dict(config="linear regression, 90 features, 4096 rows, B=128, "
                       "update_freq 2, SGD lr 0.005 (rescale 1/B), 4 "
                       "epochs",
                snapshot_rel=exact, mse_first8=float(np.mean(losses[:8])),
                mse_last8=float(np.mean(losses[-8:])), fit_s=fit_s)


def contrib_profiler_monitor(torch, np, mx, net, tr, batch, tmp):
    """One MF step under mx.profiler (device trace on): the dumped Chrome
    trace holds its CUDA kernels; a Monitor's rows from the MF net."""
    from incubator_mxnet_tpu_torch import nd
    prof = mx.profiler
    path = os.path.join(tmp, "mf_trace.json")
    prof.set_config(filename=path, profile_all=True, aggregate_stats=True)
    prof.start()
    with prof.scope("mf_step"):
        mf_step(mx, net, tr, batch, mx.gpu(0)).asnumpy()
    prof.stop()
    prof.set_config(profile_all=False)
    with open(prof.dump()) as f:
        trace = json.load(f)
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    check(len(kernels) > 0, "contrib: the profiler's dump holds no CUDA "
                            "kernel")
    check(any(e["name"] == "mf_step" for e in trace["traceEvents"]),
          "contrib: the profiler's dump lacks the step's scope")
    names = sorted({e["name"][:48] for e in kernels})
    mon = mx.monitor.Monitor(interval=1).install(net)
    mon.tic()
    net(nd.array(batch[0], ctx=mx.gpu(0)), nd.array(batch[1],
                                                    ctx=mx.gpu(0)))
    rows = mon.toc()
    check(len(rows) >= 4 and all(np.isfinite(s).all() for _, _, s in rows),
          f"contrib: monitor rows {rows}")
    return dict(profiler=dict(events=len(trace["traceEvents"]),
                              kernels=len(kernels),
                              kernel_device_us=sum(e["dur"]
                                                   for e in kernels),
                              kernel_names=names[:12]),
                monitor=[(s, n, float(np.asarray(v).ravel()[0]))
                         for s, n, v in rows])


def contrib_custom(torch, np, mx):
    """nd.Custom forward and backward on the card against numpy; refused
    inside a CUDA graph capture."""
    from incubator_mxnet_tpu_torch import autograd, nd

    class Cube(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] ** 3)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 3 * in_data[0] ** 2
                        * out_grad[0])

    @mx.operator.register("chip_cube")
    class CubeProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Cube()
    a = np.random.RandomState(4).randn(64, 32).astype(np.float32)
    x = nd.array(a, ctx=mx.gpu(0))
    x.attach_grad()
    with autograd.record():
        y = nd.Custom(x, op_type="chip_cube")
        (y * 2).sum().backward()
    check(y.context == mx.gpu(0) and
          np.array_equal(y.asnumpy(), a ** 3) and
          np.array_equal(x.grad.asnumpy(), 3 * a ** 2 * 2),
          "contrib: nd.Custom on the card differs from numpy")
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    refused = None
    with torch.cuda.stream(stream):
        try:
            with torch.cuda.graph(g, stream=stream):
                x._data.mul(2)
                nd.Custom(x, op_type="chip_cube")
        except mx.MXNetError as e:
            refused = str(e)
    torch.cuda.synchronize()
    check(refused is not None and "capture" in refused,
          f"contrib: nd.Custom inside a capture: {refused}")
    check(float((x * 2).sum().asnumpy()) == float(a.sum() * 2),
          "contrib: the card is not usable after the refused capture")
    return dict(forward_backward_equal_numpy=True, capture_refusal=refused)


def contrib_consistency(torch, np, mx):
    """check_consistency, cpu() against gpu(0), over a handful of ops."""
    from incubator_mxnet_tpu_torch import nd, test_utils
    rng = np.random.RandomState(5)
    a = rng.randn(16, 32).astype(np.float32)
    b = rng.randn(32, 8).astype(np.float32)
    cases = {"softmax": (lambda v: nd.softmax(v), [a]),
             "log_softmax": (lambda v: nd.log_softmax(v), [a]),
             "relu": (nd.relu, [a]), "sigmoid": (nd.sigmoid, [a]),
             "sum": (lambda v: nd.sum(v, axis=1), [a]),
             "dot": (nd.dot, [a, b]),
             "FullyConnected": (lambda v, w: nd.FullyConnected(
                 v, w.T, no_bias=True, num_hidden=8), [a, b])}
    for name, (fn, ins) in cases.items():
        test_utils.check_consistency(fn, ins)
    return sorted(cases)


def phase_contrib(torch, smi, mf):
    """mx.contrib and the small modules on the card (module docstring,
    7h)."""
    import tempfile

    import numpy as np
    import incubator_mxnet_tpu_torch as mx
    net, tr, batches = mf
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        onnx_out = contrib_onnx(torch, np, mx, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        svrg = contrib_svrg(torch, np, mx)
        pm = contrib_profiler_monitor(torch, np, mx, net, tr, batches[1],
                                      tmp)
    custom = contrib_custom(torch, np, mx)
    ops = contrib_consistency(torch, np, mx)
    free, total = mx.gpu_memory_info(0)
    check(0 < free <= total, f"contrib: gpu_memory_info {free}, {total}")
    out = dict(card=smi, onnx=onnx_out, svrg=svrg, custom=custom,
               check_consistency_ops=ops,
               gpu_memory_info=dict(free=free, total=total),
               phase_s=time.perf_counter() - t0, **pm)
    print(f"[contrib] {smi}: ONNX resnet50_v1 ({onnx_out['nodes']} nodes, "
          f"{onnx_out['bytes']} bytes) card == CPU bytes, imported logits "
          f"rel {onnx_out['logits_rel']:.2e}; SVRG snapshot rel "
          f"{svrg['snapshot_rel']:.1e}, mse {svrg['mse_first8']:.4f} -> "
          f"{svrg['mse_last8']:.4f}; profiler {pm['profiler']['kernels']} "
          f"CUDA kernels in the MF step's trace; monitor "
          f"{len(pm['monitor'])} rows; nd.Custom == numpy, refused in a "
          f"capture; check_consistency cpu vs gpu(0) on {len(ops)} ops; "
          f"gpu_memory_info free {free / 2**30:.1f} of "
          f"{total / 2**30:.1f} GiB", flush=True)
    print(f"[contrib] {json.dumps(out)}", flush=True)


# --------------------------------------------------------------------- #
# data parallelism over a process group (parallel/), mx.np / mx.npx
# --------------------------------------------------------------------- #

PAR = dict(gpt_replays=12, rn_steps=3, rn_timed=3, rn_B=64, rn_side=224,
           rn_lr=0.1, rn_update_limit=0.1, rn_stats_limit=1e-4)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def par_launch_env(n=1, rank=0):
    """What tools/launch.py --launcher local sets for a worker."""
    return {"MXTPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
            "MXTPU_NUM_PROCS": str(n), "MXTPU_PROC_ID": str(rank)}


def nccl_kernels(torch, fn):
    """One profiled call of ``fn``: the busy share (``busy_share``) and
    the NCCL kernels the trace holds, by name and count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    # NCCL's own kernels; with one rank a scaled reduction runs its
    # oneRankReduce kernel
    nccl = {e.key[:80]: e.count for e in kern
            if re.search(r"nccl|onerankreduce", e.key.lower())}
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy,
                device_busy_share=busy / wall_ms if kern else
                "not measured (no kernel traced)", nccl_kernels=nccl,
                kernel_names=sorted({e.key[:60] for e in kern}))


def par_gpt(torch, np, sharding):
    """gpt_small bf16 B=16 T=512 through SPMDTrainer(forward_loss=lm_loss,
    AdamW, f32 masters); ``sharding`` None is the single-device trainer
    (no process group), else the mesh of the group. The first step runs
    eager, the second is captured and replayed, then PAR["gpt_replays"]
    replays are timed back to back and one more is profiled."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, parallel
    from incubator_mxnet_tpu_torch.models import gpt as gpt_mod
    B, T = GPT["B"], GPT["T"]
    gc.collect()
    torch.cuda.empty_cache()
    model = bench_gpt(0, flash=True, dropout=0.1)
    rng = np.random.RandomState(0)
    batch = [nd.array(rng.randint(0, model.vocab_size, (B, T)),
                      ctx=mx.gpu(0), dtype="int32") for _ in range(2)]
    kw = {} if sharding is None else dict(mesh=parallel.build_mesh(),
                                          sharding=sharding)
    tr = parallel.SPMDTrainer(
        model, forward_loss=gpt_mod.lm_loss, optimizer="adamw",
        optimizer_params={"learning_rate": 1e-4, "multi_precision": True},
        **kw)

    def step():
        mx.random.seed(1)         # a repeating batch: its dropout masks too
        return tr.step(*batch)

    losses = [float(step().asnumpy()) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step() for _ in range(PAR["gpt_replays"])]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(timed)
    losses += [float(x.asnumpy()) for x in timed]
    holder = []
    prof = nccl_kernels(torch, lambda: holder.append(step()))
    losses.append(float(holder[0].asnumpy()))
    prog = next(iter(tr._programs.values()))
    out = dict(losses=losses, ms_per_step=ms,
               step_trace_count=tr.step_trace_count, replays=prog.replays,
               first_step_ms=prog.first_ms, capture_ms=prog.build_ms,
               **prof)
    if sharding is not None:
        out["collective"] = tr._collective
        out["sharded_params"] = sum(d is not None for d in tr._shard_dims)
    print(f"[parallel] gpt {sharding or 'single-device'}: "
          f"{json.dumps(out)}", flush=True)
    check(all(np.isfinite(losses)), f"parallel gpt {sharding}: loss "
                                    f"{losses}")
    check(tr.step_trace_count == 1 and prog.replays == PAR["gpt_replays"] + 2,
          f"parallel gpt {sharding}: {tr.step_trace_count} builds, "
          f"{prog.replays} replays")
    del tr, model, prog, batch, timed, holder
    gc.collect()
    torch.cuda.empty_cache()
    return out


def par_resnet_data(np):
    rng = np.random.RandomState(0)
    B, side = PAR["rn_B"], PAR["rn_side"]
    return (rng.rand(B, 3, side, side).astype("float32"),
            rng.randint(0, 1000, (B,)).astype("int32"))


def par_resnet_run(mx, np, x, y, params_file, dist_kw, ctx, steps,
                   timed=0):
    """resnet50_v1 f32 from ``params_file`` through gluon.Trainer("sgd",
    momentum 0.9) with ``dist_kw``: ``steps`` steps of the MXNet 1.x loop
    and ``timed`` more, timed; returns the untimed steps' losses, the
    parameters before and after the first step (and which are trained:
    BatchNorm's running statistics move in the forward), the ms a timed
    step, the int8 bucket count and the issue schedule."""
    from incubator_mxnet_tpu_torch import autograd, gluon, nd
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    with ctx:
        net = resnet50_v1()
        net.initialize()
        xb, yb = nd.array(x), nd.array(y, dtype="int32")
        net(xb[:1])                   # the deferred shapes
        net.load_parameters(params_file, ctx=ctx)
        init = [p.data().asnumpy() for p in net.collect_params().values()]
        trained = [p.grad_req != "null"
                   for p in net.collect_params().values()]
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": PAR["rn_lr"], "momentum": 0.9},
                           **dist_kw)
        lossf = gluon.loss.SoftmaxCrossEntropyLoss()
        losses, first, t0 = [], None, None
        for i in range(steps + timed):
            if i == steps:
                import torch
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with autograd.record():
                loss = lossf(net(xb), yb).mean()
            loss.backward()
            tr.step(PAR["rn_B"])
            losses.append(loss)
            if i == 0:
                first = [p.data().asnumpy() for p in
                         net.collect_params().values()]
        losses = [float(v.asnumpy()) for v in losses[:steps]]
        ms = (time.perf_counter() - t0) * 1e3 / timed if timed else None
        return dict(losses=losses, init=init, first=first, trained=trained,
                    ms_per_step=ms,
                    int8_buckets=getattr(tr, "int8_buckets", 0),
                    schedule=list(getattr(tr, "grad_issue_schedule", [])),
                    outcome=tr.last_outcome.value)


def par_cpu_worker(d):
    """The CPU half of the parallel phase, in a process of its own over a
    gloo group of one (the environment tools/launch.py sets): the first
    step of the resnet50_v1 dist_sync int8 / overlap run (the one the
    card is held to) and the 2-bit store, into ``d``/cpu.npz."""
    import numpy as np
    import torch
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import parallel
    torch.set_num_threads(os.cpu_count() or 1)
    with mx.cpu():
        parallel.initialize()
        check(torch.distributed.get_backend() == "gloo",
              "parallel cpu worker: not a gloo group")
        x, y = np.load(os.path.join(d, "x.npy")), \
            np.load(os.path.join(d, "y.npy"))
        t0 = time.perf_counter()
        run = par_resnet_run(mx, np, x, y, os.path.join(d, "rn.params"),
                             dict(kvstore="dist_sync", int8_allreduce=True,
                                  overlap_allreduce=True), mx.cpu(), 1)
        run_s = time.perf_counter() - t0
        kv = par_kv_2bit(mx, np)
    np.savez(os.path.join(d, "cpu.npz"), losses=np.array(run["losses"]),
             int8_buckets=run["int8_buckets"], run_s=run_s,
             **{f"first{i}": a for i, a in enumerate(run["first"])},
             **{f"kv_{k}": v for k, v in kv.items()})
    torch.distributed.destroy_process_group()


def par_kv_2bit(mx, np):
    """A dist_sync store with 2-bit compression (threshold 0.5): three
    pushes of a seeded gradient, each pulled, with the key's residual."""
    from incubator_mxnet_tpu_torch import nd
    kv = mx.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    g = np.random.RandomState(7).randn(1003).astype(np.float32) * 0.4
    kv.init("g", nd.zeros((1003,)))
    out, got = nd.zeros((1003,)), {}
    for t in range(3):
        kv.push("g", nd.array(g))
        kv.pull("g", out=out)
        got[f"pull{t}"] = out.asnumpy().copy()
        got[f"residual{t}"] = kv._residuals["g"].cpu().numpy().copy()
    return got


def par_numpy(torch, np, mx):
    """A dozen mx.np / mx.npx calls on the card against numpy."""
    rng = np.random.RandomState(11)
    a = rng.randn(8, 16).astype(np.float32)
    b = rng.randn(16, 4).astype(np.float32)
    x, y = mx.np.array(a), mx.np.array(b)
    check(x.context == mx.gpu(0), f"mx.np.array landed on {x.context}")
    cases = {
        "exp": (mx.np.exp(x), np.exp(a)),
        "matmul": (mx.np.matmul(x, y), a @ b),
        "sum": (mx.np.sum(x, axis=1), a.sum(1)),
        "std": (mx.np.std(x, axis=0), a.std(0)),
        "maximum": (mx.np.maximum(x, 0.5), np.maximum(a, 0.5)),
        "transpose": (mx.np.transpose(x), a.T),
        "concatenate": (mx.np.concatenate([x, x], axis=0),
                        np.concatenate([a, a], 0)),
        "argsort": (mx.np.argsort(x, axis=1), np.argsort(a, 1,
                                                         kind="stable")),
        "where": (mx.np.where(x > 0, x, -x), np.abs(a)),
        "arange": (mx.np.arange(2, 20, 3), np.arange(2, 20, 3)),
        "linspace": (mx.np.linspace(0.0, 1.0, 5), np.linspace(0, 1, 5)),
        "npx.relu": (mx.npx.relu(x), np.maximum(a, 0)),
        "npx.softmax": (mx.npx.softmax(x),
                        np.exp(a) / np.exp(a).sum(1, keepdims=True)),
    }
    errs = {}
    for name, (got, want) in cases.items():
        g = got.asnumpy()
        check(got.context == mx.gpu(0), f"mx.np {name} on {got.context}")
        errs[name] = float(np.abs(g.astype(np.float64) - want).max())
        check(g.shape == np.shape(want) and np.allclose(
            g, want, rtol=1e-5, atol=1e-5),
            f"mx.np {name}: max abs err {errs[name]:.2e}")
    mx.npx.waitall()
    return errs


def phase_parallel(torch, smi):
    """Data parallelism over a one-rank NCCL group on the card (module
    docstring, 7i). The CPU process of the ResNet comparison starts
    first; only the mx.np calls run beside it, and everything timed runs
    after it has exited, with the host's cores to itself."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import parallel
    t_phase = time.perf_counter()
    out = dict(card=smi)
    env = par_launch_env()
    with tempfile.TemporaryDirectory() as tmp:
        worker = par_resnet_start(np, mx, tmp)
        try:
            out["np"] = par_numpy(torch, np, mx)
            cpu = par_resnet_wait(np, tmp, worker)
            gpt = {"single": par_gpt(torch, np, None)}
            os.environ.update(env)
            parallel.initialize()
            check(dist.is_initialized() and dist.get_backend() == "nccl"
                  and dist.get_world_size() == 1,
                  "parallel: the NCCL group of one did not form")
            gpt["replicated"] = par_gpt(torch, np, "replicated")
            gpt["fsdp"] = par_gpt(torch, np, "fsdp")
            out["gpt"] = par_gpt_checks(gpt)
            out["gpt_s"] = time.perf_counter() - t_phase
            out["resnet"], out["kv_2bit"] = par_resnet_finish(
                np, mx, tmp, cpu)
        finally:
            if worker.poll() is None:
                os.killpg(worker.pid, 9)
                worker.wait()
            if dist.is_initialized():
                dist.destroy_process_group()
            parallel.set_default_mesh(None)
            for k in env:
                os.environ.pop(k, None)
    out["phase_s"] = time.perf_counter() - t_phase
    g = out["gpt"]
    print(f"[parallel] {smi}: gpt_small bf16 B=16 T=512 ms a step: single "
          f"{g['single']['ms_per_step']:.2f}, replicated "
          f"{g['replicated']['ms_per_step']:.2f}, fsdp "
          f"{g['fsdp']['ms_per_step']:.2f}; NCCL kernels replicated "
          f"{g['replicated']['nccl_kernels']}, fsdp "
          f"{g['fsdp']['nccl_kernels']}; resnet50_v1 dist_sync int8 "
          f"overlap {out['resnet']['ms_per_step']:.2f} ms vs plain "
          f"{out['resnet']['plain_ms_per_step']:.2f} ms", flush=True)
    print(f"[parallel] {json.dumps(out)}", flush=True)
    return out


def par_gpt_checks(gpt):
    """The GPT runs against the single-device trainer's: replicated and
    fsdp losses bitwise (over an fsdp axis of 1 the JAX rule shards
    nothing, so fsdp is the replicated step); an NCCL kernel in each
    profiled replay."""
    ref = gpt["single"]["losses"]
    for name in ("replicated", "fsdp"):
        check(gpt[name]["losses"] == ref,
              f"parallel gpt {name}: losses {gpt[name]['losses']} != "
              f"single-device {ref}")
        check(gpt[name]["collective"] and gpt[name]["nccl_kernels"],
              f"parallel gpt {name}: no NCCL kernel in the profiled "
              f"replay; its kernels: {gpt[name]['kernel_names']}")
    check(gpt["fsdp"]["sharded_params"] == 0,
          f"parallel gpt fsdp: {gpt['fsdp']['sharded_params']} parameters "
          f"sharded over an fsdp axis of 1")
    for name in gpt:
        gpt[name].pop("kernel_names", None)
    return gpt


def par_resnet_start(np, mx, tmp):
    """resnet50_v1's weights (seeded on the card) and the batch into
    ``tmp``, and the CPU process of the comparison started over them
    (a gloo group of one, the launcher's variables)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    x, y = par_resnet_data(np)
    np.save(os.path.join(tmp, "x.npy"), x)
    np.save(os.path.join(tmp, "y.npy"), y)
    mx.random.seed(0)
    net = resnet50_v1()
    net.initialize()
    net(mx.nd.array(x[:1]))
    net.save_parameters(os.path.join(tmp, "rn.params"))
    del net
    env = dict(os.environ, **par_launch_env(), CUDA_VISIBLE_DEVICES="")
    worker = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-cpu-worker",
         tmp], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    worker.t0 = time.perf_counter()
    return worker


def par_resnet_wait(np, tmp, worker):
    """The CPU process's results (cpu.npz) once it has exited, with its
    wall time."""
    try:
        log, _ = worker.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        raise PhaseError("parallel: the CPU worker passed 600 s")
    check(worker.returncode == 0,
          f"parallel: the CPU worker failed:\n{log[-3000:]}")
    cpu = dict(np.load(os.path.join(tmp, "cpu.npz")))
    cpu["worker_s"] = time.perf_counter() - worker.t0
    return cpu


def par_resnet_finish(np, mx, tmp, cpu):
    """resnet50_v1 f32 B=64 through gluon.Trainer(kvstore="dist_sync",
    int8_allreduce=True, overlap_allreduce=True) on the card against the
    CPU process's first step from the same weights and batch: the first
    loss within 1e-4; the first step's change of the trained parameters
    within PAR["rn_update_limit"] of the CPU's in L1 (the summed
    |difference| over the summed |change|), and of the running
    statistics within PAR["rn_stats_limit"]. An element-wise maximum
    cannot tell int8 from f32 here: card and CPU gradients put some codes
    on either side of a rounding edge, a whole int8 step apart, as far
    as f32 is from int8. The plain gluon step (f32 gradients, no
    reduction) is timed beside it, and its update must read above the
    limit against the CPU's int8 one, or the limit could not tell an
    int8 reduction from none. Then the 2-bit store on the card against
    the CPU's."""
    x, y = np.load(os.path.join(tmp, "x.npy")), \
        np.load(os.path.join(tmp, "y.npy"))
    params_file = os.path.join(tmp, "rn.params")
    steps, timed = PAR["rn_steps"], PAR["rn_timed"]
    card = par_resnet_run(mx, np, x, y, params_file,
                          dict(kvstore="dist_sync", int8_allreduce=True,
                               overlap_allreduce=True), mx.gpu(0), steps,
                          timed)
    plain = par_resnet_run(mx, np, x, y, params_file,
                           dict(kvstore="device"), mx.gpu(0), steps, timed)
    kv_card = par_kv_2bit(mx, np)
    cl = float(cpu["losses"][0])
    first_rel = abs(card["losses"][0] - cl) / abs(cl)
    init = card["init"]
    cpu_first = [cpu[f"first{k}"] for k in range(len(init))]

    def l1_rel(first, trained):
        pick = [k for k, t in enumerate(card["trained"]) if t == trained]
        diff = sum(float(np.abs(first[k].astype(np.float64) - cpu_first[k])
                         .sum()) for k in pick)
        move = sum(float(np.abs(cpu_first[k].astype(np.float64) - init[k])
                         .sum()) for k in pick)
        return diff / move

    update_rel, stats_rel = l1_rel(card["first"], True), \
        l1_rel(card["first"], False)
    plain_rel = l1_rel(plain["first"], True)
    limit, stats_limit = PAR["rn_update_limit"], PAR["rn_stats_limit"]
    res = dict(losses=card["losses"], cpu_first_loss=cl,
               first_loss_rel=first_rel, first_update_l1_rel=update_rel,
               running_stats_l1_rel=stats_rel,
               plain_first_update_l1_rel=plain_rel,
               first_update_max_abs_err=max(
                   float(np.abs(a - b).max())
                   for a, b in zip(card["first"], cpu_first)),
               ms_per_step=card["ms_per_step"],
               plain_ms_per_step=plain["ms_per_step"],
               plain_losses=plain["losses"],
               int8_buckets=card["int8_buckets"],
               cpu_int8_buckets=int(cpu["int8_buckets"]),
               buckets_a_step=len(card["schedule"]),
               outcome=card["outcome"], cpu_worker_s=cpu["worker_s"],
               cpu_step_s=float(cpu["run_s"]))
    print(f"[parallel] resnet: {json.dumps(res)}", flush=True)
    check(card["int8_buckets"] > 0 and card["outcome"] == "APPLIED",
          f"parallel resnet: int8 buckets {card['int8_buckets']}, outcome "
          f"{card['outcome']}")
    check(all(np.isfinite(card["losses"] + plain["losses"])),
          f"parallel resnet: losses {card['losses']}, plain "
          f"{plain['losses']}")
    check(first_rel <= 1e-4, f"parallel resnet: first loss card "
                             f"{card['losses'][0]} vs CPU {cl}")
    check(update_rel <= limit and stats_rel <= stats_limit,
          f"parallel resnet: first step card vs CPU, L1 relative "
          f"{update_rel:.3e} (trained; limit {limit:.1e}), "
          f"{stats_rel:.3e} (running statistics; limit "
          f"{stats_limit:.1e})")
    check(plain_rel > limit,
          f"parallel resnet: the f32 step's first update is within "
          f"{plain_rel:.3e} (L1 relative) of the CPU's int8 one, under "
          f"the limit {limit:.1e}")
    kv_ok = {k: bool(np.array_equal(v, cpu["kv_" + k]))
             for k, v in kv_card.items()}
    check(all(kv_ok.values()), f"parallel dist_sync 2-bit: card != CPU "
                               f"({kv_ok})")
    return res, dict(equal_to_cpu=kv_ok,
                     pulled_nonzero=int(np.count_nonzero(
                         kv_card["pull0"])))


SEQ = dict(B=4, H=12, D=64, T=4096, ranks=4, block_lens=(1024, 0, 517, 1))


def seq_compare(torch, what, got, want, tol, err, name):
    """``got`` against ``want`` within ``tol`` (a tensor or float of
    ``want``'s shape); folds the largest |difference| into err[name]."""
    check(bool(torch.isfinite(got).all()), f"sequence {what}: non-finite")
    d = (got.float() - want.float()).abs()
    worst = float((d / tol).max())
    e = float(d.max())
    err[name] = max(err.get(name, 0.0), e)
    print(f"[sequence] {what}: max|err| {e:.3e}, worst |err| / tolerance "
          f"{worst:.3f}", flush=True)
    check(worst <= 1.0, f"sequence {what}: max |err| {e:.3e} is "
                        f"{worst:.2f} x its tolerance")
    return e


def seq_grad_tol(torch, ref, gfrac, gfloor):
    """phase 4's gradient tolerance: a fraction of the largest |gradient|
    of each (batch, head) slice of a (B, H, T, D) reference."""
    return gfrac * ref.float().abs().amax(dim=(2, 3),
                                          keepdim=True).clamp(min=gfloor)


def seq_block(torch, fa, err):
    """block_attn_lse on the card against its plain version: out and lse,
    the autograd gradients, and block_attn_bwd from an outside (out,
    lse) (the plain version's)."""
    B, H, D = SEQ["B"], SEQ["H"], SEQ["D"]
    T = SEQ["T"] // SEQ["ranks"]
    atol, rtol, gfrac, gfloor = FLASH_TOL["bfloat16"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    for causal in (False, True):
        lens = [T] * B if causal else list(SEQ["block_lens"])
        q, k, v, do, vl = flash_inputs(torch, gen, B, H, T, T, D, lens,
                                       torch.bfloat16)
        qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
        out, lse = fa.block_attn_lse(qa, ka, va, vl, causal)
        check(not lse.requires_grad, "block_attn_lse: lse is "
                                     "differentiable")
        out.backward(do)
        ro, rl = fa.dense_attn_lse(q, k, v, vl, causal)
        rg = fa.dense_attn_bwd(q, k, v, vl, ro, rl, do, causal)
        outside = fa.block_attn_bwd(q, k, v, vl, ro, rl, do, causal)
        torch.cuda.synchronize()
        tag = f"block_attn_lse bf16 B={B} H={H} T={T} lengths={lens} " \
              f"causal={causal}"
        live = rl > -1e29
        check(bool((lse[~live] == -1e30).all()) and
              bool((out.float()[~live] == 0).all()),
              f"{tag}: a fully masked row is not zero with lse -1e30")
        seq_compare(torch, f"{tag} out", out, ro,
                    atol + rtol * ro.float().abs(), err, "flash_fwd")
        seq_compare(torch, f"{tag} lse", lse[live], rl[live],
                    atol + rtol * rl[live].abs(), err, "flash_fwd")
        for part, name, g, o, r in (
                ("dq", "flash_bwd_dq", qa.grad, outside[0], rg[0]),
                ("dk", "flash_bwd_dkv", ka.grad, outside[1], rg[1]),
                ("dv", "flash_bwd_dkv", va.grad, outside[2], rg[2])):
            tol = seq_grad_tol(torch, r, gfrac, gfloor)
            seq_compare(torch, f"{tag} {part} (autograd)", g, r, tol, err,
                        name)
            seq_compare(torch, f"{tag} {part} (outside out, lse)", o, r,
                        tol, err, name)
        if not causal:
            dead = [b for b, n in enumerate(lens) if n == 0]
            for x in (qa.grad, ka.grad, va.grad):
                check(bool((x[dead] == 0).all()),
                      f"{tag}: a gated-off batch row has a nonzero "
                      f"gradient")
        del q, k, v, do, qa, ka, va, out, lse, ro, rl, rg, outside
    torch.cuda.empty_cache()


def seq_blocks(torch, x, n):
    """Rank r's (B, H, T/n, D) block of a (B, H, T, D) tensor."""
    return [b.contiguous() for b in x.split(x.shape[2] // n, dim=2)]


def seq_ring(torch, fa, ra, causal, err, launches):
    """Four virtual ranks of the flash ring at SEQ's shape against the
    whole sequence's flash kernels and against the plain ring; the
    launches of the ring's forward and backward (counts zeroed just
    before, read just after) added into ``launches``; times."""
    B, H, D, T, n = SEQ["B"], SEQ["H"], SEQ["D"], SEQ["T"], SEQ["ranks"]
    atol, rtol, gfrac, gfloor = FLASH_TOL["bfloat16"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26 + int(causal))
    q, k, v, do, vl = flash_inputs(torch, gen, B, H, T, T, D, [T] * B,
                                   torch.bfloat16)
    qs, ks, vs, dos = (seq_blocks(torch, x, n) for x in (q, k, v, do))
    tag = f"ring of {n} bf16 B={B} H={H} T={T} causal={causal}"
    # the path: the ring's forward and backward, counted
    fa.reset_launch_counts()
    res = ra.flash_ring_fwd(qs, ks, vs, causal)
    outs, lses = [o for o, _ in res], [lse for _, lse in res]
    grads = ra.flash_ring_bwd(qs, ks, vs, outs, lses, dos, causal)
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCHES)
    counts.update(fa.CAUSAL_LAUNCHES)
    for name, c in counts.items():
        launches[name] = launches.get(name, 0) + c
    want_each = n * n
    check(all(counts[name] == want_each for name in FLASH),
          f"{tag}: launches {counts}, want {want_each} of each kernel")
    check(all(counts[f"{name}_causal"] == (n if causal else 0)
              for name in FLASH),
          f"{tag}: causal launches {counts}, want {n if causal else 0}")
    ring_out = torch.cat(outs, dim=2)
    ring_lse = torch.cat(lses, dim=2)
    ring_g = [torch.cat([g[j] for g in grads], dim=2) for j in range(3)]
    # the whole sequence through the same kernels
    whole = flash_run(torch, fa, q, k, v, do, vl, causal)
    wo, wl, wdq, _, wdk, wdv = whole
    seq_compare(torch, f"{tag} out vs whole-sequence flash", ring_out, wo,
                atol + rtol * wo.float().abs(), err, "flash_fwd")
    seq_compare(torch, f"{tag} lse vs whole-sequence flash", ring_lse, wl,
                atol + rtol * wl.abs(), err, "flash_fwd")
    for part, name, g, r in (("dq", "flash_bwd_dq", ring_g[0], wdq),
                             ("dk", "flash_bwd_dkv", ring_g[1], wdk),
                             ("dv", "flash_bwd_dkv", ring_g[2], wdv)):
        seq_compare(torch, f"{tag} {part} vs whole-sequence flash", g, r,
                    seq_grad_tol(torch, r, gfrac, gfloor), err, name)
    del whole, wo, wl, wdq, wdk, wdv
    # the plain ring: the same per-step functions on the plain versions
    # (autograd through the plain streaming ring), (B, T, H, D)
    pq, pk, pv = (list(x.transpose(1, 2).split(T // n, dim=1))
                  for x in (q, k, v))
    pq = [x.detach().requires_grad_() for x in pq]
    pk = [x.detach().requires_grad_() for x in pk]
    pv = [x.detach().requires_grad_() for x in pv]
    pouts = ra.plain_ring(pq, pk, pv, None, causal)
    torch.autograd.backward(pouts, [x.transpose(1, 2) for x in dos])
    plain_out = torch.cat(pouts, dim=1).transpose(1, 2)
    seq_compare(torch, f"{tag} out vs the plain ring", ring_out, plain_out,
                atol + rtol * plain_out.float().abs(), err, "flash_fwd")
    for part, name, g, xs in (("dq", "flash_bwd_dq", ring_g[0], pq),
                              ("dk", "flash_bwd_dkv", ring_g[1], pk),
                              ("dv", "flash_bwd_dkv", ring_g[2], pv)):
        r = torch.cat([x.grad for x in xs], dim=1).transpose(1, 2)
        seq_compare(torch, f"{tag} {part} vs the plain ring", g, r,
                    seq_grad_tol(torch, r, gfrac, gfloor), err, name)
    del pq, pk, pv, pouts, plain_out
    torch.cuda.empty_cache()
    # times: the ring's forward and backward (every rank's steps on the
    # one card, merges and rotations included) beside the whole
    # sequence's three kernels
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    wo, wl = fa._flash_fwd_cuda(q, k, v, vl, causal, None)
    _, wdelta = fa._flash_bwd_dq_cuda(q, k, v, vl, do, wo, wl, causal,
                                      None)
    times = dict(
        ring_fwd_ms=_time_ms(torch, lambda: ra.flash_ring_fwd(
            qs, ks, vs, causal), flush, iters=10),
        ring_bwd_ms=_time_ms(torch, lambda: ra.flash_ring_bwd(
            qs, ks, vs, outs, lses, dos, causal), flush, iters=10),
        whole_fwd_ms=_time_ms(torch, lambda: fa._flash_fwd_cuda(
            q, k, v, vl, causal, None), flush, iters=10),
        whole_bwd_ms=_time_ms(torch, lambda: (
            fa._flash_bwd_dq_cuda(q, k, v, vl, do, wo, wl, causal, None),
            fa._flash_bwd_dkv_cuda(q, k, v, vl, do, wl, wdelta, causal,
                                   None)), flush, iters=10))
    del flush, q, k, v, do, qs, ks, vs, dos, res, outs, lses, grads
    del ring_out, ring_lse, ring_g, wo, wl, wdelta
    torch.cuda.empty_cache()
    return dict(launches=counts, **times)


def phase_sequence(torch, smi):
    """The sp ring's kernel path on the card (module docstring, 7j).
    Returns the ring's launches (the ``sequence`` path of the kernels
    line) and the phase's numbers."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.parallel import ring_attention as ra
    t0 = time.perf_counter()
    err = {}
    seq_block(torch, fa, err)
    launches = {}
    rings = {("causal" if c else "full"): seq_ring(torch, fa, ra, c, err,
                                                   launches)
             for c in (False, True)}
    out = dict(card=smi, shape=dict(SEQ), tolerance_bf16=dict(zip(
        ("atol", "rtol", "grad_frac", "grad_floor"), FLASH_TOL["bfloat16"])),
        max_abs_err=err, rings=rings, launches=launches,
        phase_s=time.perf_counter() - t0)
    for name, r in rings.items():
        print(f"[sequence] {smi}: ring of {SEQ['ranks']} ({name}) bf16 "
              f"B={SEQ['B']} H={SEQ['H']} T={SEQ['T']}: forward "
              f"{r['ring_fwd_ms']:.3f} ms vs whole-sequence flash "
              f"{r['whole_fwd_ms']:.3f} ms; backward {r['ring_bwd_ms']:.3f} "
              f"ms vs {r['whole_bwd_ms']:.3f} ms", flush=True)
    print(f"[sequence] {json.dumps(out)}", flush=True)
    return dict(launches=launches)


# --------------------------------------------------------------------- #
# 7k. pipelined: the pipelined-backward step, GPipe, Switch MoE, policy
# --------------------------------------------------------------------- #
# bucket_bytes: MXTPU_GRAD_BUCKET_BYTES of the two pipelined GPT runs:
# 64 KiB (the JAX package's drive) and the default (None: 32 MiB). At
# the default the plan's first bucket (deepest-first, by dtype) holds the
# f32 LayerNorm parameters of every block and the position table, so
# strict plan order holds every bucket to the stem's pullback and none
# runs beside the backward; 64 KiB buckets split them.
PIPE = dict(replays=10, accum_k=4, bert_replays=10, stages=4, micro=8,
            micro_B=2, moe_E=8, moe_D=768, moe_ff=3072, moe_N=16 * 512,
            moe_cf=1.25, bucket_bytes=("65536", None))


def pipe_timeline(torch, fn):
    """One profiled call of ``fn``: the device kernels' names in start
    order, and the busy share (``busy_share``'s fields) with the count
    and device time of the pipelined step's segment marks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.parallel.pipelined import _SEGMENT_MARK
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    marks = [e.time_range.elapsed_us() for e in kern
             if _SEGMENT_MARK.search(e.name)]
    return [e.name for e in kern], dict(
        profiled_wall_ms=wall_ms, device_busy_ms=busy,
        device_busy_share=busy / wall_ms if kern else
        "not measured (no kernel traced)", segment_marks=len(marks),
        segment_marks_device_us=sum(marks))


def loss_diff(a, b):
    """(step, |a - b|) of the first of ``a``'s steps whose loss differs
    from ``b``'s, or None."""
    b = b[:len(a)]
    i = first_diff(a, b)
    return None if i is None else (i, abs(a[i] - b[i]))


def pipe_gpt_trainer(torch, mx, parallel, gpt_mod, pipelined, remat=False,
                     plan=None):
    """par_gpt's build (gpt_small bf16, flash, dropout 0.1, AdamW, f32
    masters) over the NCCL group of one; ``pipelined``: through
    ``lm_pipeline`` (with ``remat_plan=plan``)."""
    model = bench_gpt(0, flash=True, dropout=0.1, remat=remat)
    kw = dict(pipeline=gpt_mod.lm_pipeline(model), remat_plan=plan) \
        if pipelined else dict(forward_loss=gpt_mod.lm_loss)
    tr = parallel.SPMDTrainer(
        model, optimizer="adamw",
        optimizer_params={"learning_rate": 1e-4, "multi_precision": True},
        mesh=parallel.build_mesh(), sharding="replicated", **kw)
    return model, tr


def pipe_gpt_run(torch, np, ref, bucket_bytes):
    """One pipelined gpt_small run at ``bucket_bytes`` (None: the
    default): the first step eager, the capture, PIPE["replays"] timed
    replays and one profiled. Its 13 losses are held bitwise to
    par_gpt's replicated run (``ref``), and the profiled replay's
    timeline to the plan's order (and, at 64 KiB, to the interleave).
    par_gpt repeats one batch with its dropout masks at every step, so
    the first 13 of its losses are the steps this run takes."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, parallel
    from incubator_mxnet_tpu_torch.models import gpt as gpt_mod
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.parallel import collectives
    B, T = GPT["B"], GPT["T"]
    label = f"pipelined gpt ({bucket_bytes or 'default'} bucket bytes)"
    gc.collect()
    torch.cuda.empty_cache()
    model, tr = pipe_gpt_trainer(torch, mx, parallel, gpt_mod, True)
    rng = np.random.RandomState(0)
    batch = [nd.array(rng.randint(0, model.vocab_size, (B, T)),
                      ctx=mx.gpu(0), dtype="int32") for _ in range(2)]

    def step():
        mx.random.seed(1)         # par_gpt's repeating batch and masks
        return tr.step(*batch)

    # the bucket plan is made at the first step
    saved = os.environ.pop("MXTPU_GRAD_BUCKET_BYTES", None)
    if bucket_bytes is not None:
        os.environ["MXTPU_GRAD_BUCKET_BYTES"] = bucket_bytes
    try:
        limit = collectives.bucket_limit()
        losses = [float(step().asnumpy())]
    finally:
        os.environ.pop("MXTPU_GRAD_BUCKET_BYTES", None)
        if saved is not None:
            os.environ["MXTPU_GRAD_BUCKET_BYTES"] = saved
    losses.append(float(step().asnumpy()))
    prog = next(iter(tr._programs.values()))
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    timed = [step() for _ in range(PIPE["replays"])]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / PIPE["replays"]
    launches = dict(fa.LAUNCHES, **fa.CAUSAL_LAUNCHES)
    losses += [float(x.asnumpy()) for x in timed]
    holder = []
    names, prof = pipe_timeline(torch, lambda: holder.append(step()))
    losses.append(float(holder[0].asnumpy()))
    rep = tr.pipelined_structure(timeline=names)
    diff = loss_diff(losses, ref["losses"])
    out = dict(bucket_bytes=limit, buckets=len(tr.pipelined_bucket_order),
               losses=losses, ms_per_step=ms,
               replicated_ms_per_step=ref["ms_per_step"],
               pipelined_step_trace_count=tr.pipelined_step_trace_count,
               replays=prog.replays, first_step_ms=prog.first_ms,
               capture_ms=prog.build_ms, structure=rep,
               losses_bitwise_replicated=diff is None,
               first_difference=diff, launches=launches, **prof)
    print(f"[pipelined] gpt at {limit} bucket bytes: {json.dumps(out)}",
          flush=True)
    check(all(np.isfinite(losses)), f"{label}: loss {losses}")
    check(diff is None, f"{label}: losses {losses} not bitwise the first "
                        f"{len(losses)} of par_gpt's replicated "
                        f"{ref['losses']} (first difference {diff})")
    check(tr.pipelined_step_trace_count == 1 and tr.step_trace_count == 1
          and prog.replays == PIPE["replays"] + 2,
          f"{label}: {tr.pipelined_step_trace_count} captures, "
          f"{prog.replays} replays")
    for name in FLASH:
        want = model.num_layers * PIPE["replays"]
        check(launches[name + "_causal"] == want,
              f"{label}: {name} causal launches "
              f"{launches[name + '_causal']} over {PIPE['replays']} replays "
              f"!= {model.num_layers} layers a replay")
    check(rep["order_matches_plan"] and rep["n_segment_marks"] ==
          model.num_layers + 2, f"{label}: the profiled replay's timeline "
                                f"{rep}: buckets out of plan order")
    check(bucket_bytes is None or rep["interleaved"],
          f"{label}: the profiled replay's timeline {rep}: no bucket ran "
          f"between two backward segments")
    del tr, model, prog, timed, holder
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipe_gpt(torch, np, ref):
    """(a) gpt_small through the pipelined step against par_gpt's
    replicated run (``ref``) at 64 KiB and at the default bucket size
    (pipe_gpt_run); then step_microbatches (k = 4) and
    remat_plan=["dots"] * 12, each bitwise the plain step of the same
    build."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import nd, parallel
    from incubator_mxnet_tpu_torch.models import gpt as gpt_mod
    B, T = GPT["B"], GPT["T"]
    out, launches = {}, {}
    for bb in PIPE["bucket_bytes"]:
        rec = pipe_gpt_run(torch, np, ref, bb)
        out[f"bucket_bytes_{bb or 'default'}"] = rec
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches

    # accumulation (k = 4 microbatches of B / 4) and the remat plan,
    # each against the plain step of the same build
    rng = np.random.RandomState(0)
    batch = [nd.array(rng.randint(0, 50257, (B, T)), ctx=mx.gpu(0),
                      dtype="int32") for _ in range(2)]
    k = PIPE["accum_k"]
    micros = [[b[m * B // k:(m + 1) * B // k] for b in batch]
              for m in range(k)]
    runs = {}
    for name, kw in (("accum", {}),
                     ("remat", dict(remat="dots",
                                    plan=["dots"] * 12))):
        for pipelined in (False, True):
            remat = kw.get("remat", False)
            model, t2 = pipe_gpt_trainer(
                torch, mx, parallel, gpt_mod, pipelined,
                remat=False if pipelined else remat,
                plan=kw.get("plan") if pipelined else None)
            ls = []
            for _ in range(2):
                mx.random.seed(1)
                ls.append(float((t2.step_microbatches(micros)
                                 if name == "accum" else
                                 t2.step(*batch)).asnumpy()))
            runs[(name, pipelined)] = dict(
                losses=ls, step_trace_count=t2.step_trace_count,
                accum_step_trace_count=t2.accum_step_trace_count,
                pipelined_step_trace_count=t2.pipelined_step_trace_count,
                pipelined_accum_step_trace_count=(
                    t2.pipelined_accum_step_trace_count))
            del model, t2
            gc.collect()
            torch.cuda.empty_cache()
        p, q = runs[(name, False)], runs[(name, True)]
        d = loss_diff(q["losses"], p["losses"])
        out[name] = dict(plain=p, pipelined=q, bitwise=d is None,
                         first_difference=d)
        check(all(np.isfinite(q["losses"])), f"pipelined gpt {name}: "
                                             f"loss {q['losses']}")
        counts = (q["pipelined_accum_step_trace_count"],
                  p["accum_step_trace_count"]) if name == "accum" else \
            (q["pipelined_step_trace_count"], p["step_trace_count"])
        check(counts == (1, 1), f"pipelined gpt {name}: captures {counts}")
        check(d is None, f"pipelined gpt {name}: losses {q['losses']} not "
                         f"bitwise the plain step's {p['losses']}")
    return out


@contextlib.contextmanager
def planted_fault(torch, kind):
    """A fault planted in the pipelined step for the runs inside, to show
    that pipe_bert's gate can fail: each bucket's reduction
    (PipelinedBackward._reduce_bucket) is wrapped so that ``"block"``
    zeroes the deepest block's gradients and ``"bucket"`` those of the
    plan's first bucket. The method is restored on exit."""
    from incubator_mxnet_tpu_torch.parallel import pipelined as pl
    orig = pl.PipelinedBackward._reduce_bucket

    def faulty(self, bucket, grads):
        res = orig(self, bucket, grads)
        drop = set(self.block_own[-1] if kind == "block"
                   else self.plan[0].indices)
        for i in bucket.indices:
            if i in drop:
                grads[self.slot[i]] = torch.zeros_like(grads[self.slot[i]])
        return res

    pl.PipelinedBackward._reduce_bucket = faulty
    try:
        yield
    finally:
        pl.PipelinedBackward._reduce_bucket = orig


def pipe_bert(torch, np):
    """(b) bert_base bf16 B=32 T=512 through pretraining_pipeline (LAMB,
    f32 masters) over the NCCL group of one, ragged lengths, 10 replays.
    The plain step of the same build runs twice, the control that it
    repeats itself; every step of the pipelined run is held bitwise to
    the plain step's. Two pipelined runs with a planted fault
    (planted_fault) must differ from the plain step: the gate can
    fail."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import models, parallel
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    B, T, M = BERT["B"], BERT["T"], BERT["M"]
    res = {}
    for run, fault in (("plain", None), ("plain_again", None),
                       ("pipelined", None), ("fault_block", "block"),
                       ("fault_bucket", "bucket")):
        pipelined = run not in ("plain", "plain_again")
        gc.collect()
        torch.cuda.empty_cache()
        pre = bench_bert(0, T)
        kw = dict(pipeline=bert_mod.pretraining_pipeline(pre)) \
            if pipelined else dict(forward_loss=models.pretraining_loss)
        tr = parallel.SPMDTrainer(
            pre, optimizer="lamb",
            optimizer_params={"learning_rate": 1e-4,
                              "multi_precision": True},
            mesh=parallel.build_mesh(), sharding="replicated", **kw)
        batch = bert_batch(torch, np, np.random.RandomState(0), B, T, M,
                           pre.bert.vocab_size, M)

        def step():
            mx.random.seed(1)
            return tr.step(*batch)

        with planted_fault(torch, fault) if fault else \
                contextlib.nullcontext():
            losses = [float(step().asnumpy()) for _ in range(2)]
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            timed = [step() for _ in range(PIPE["bert_replays"])]
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / PIPE["bert_replays"]
        res[run] = dict(
            losses=losses + [float(x.asnumpy()) for x in timed],
            ms_per_step=ms, step_trace_count=tr.step_trace_count,
            launches=dict(fa.LAUNCHES, **fa.CAUSAL_LAUNCHES))
        del tr, pre, batch, timed
    p, q = res["plain"], res["pipelined"]
    d = loss_diff(q["losses"], p["losses"])
    c = loss_diff(res["plain_again"]["losses"], p["losses"])
    faults = {run: dict(
        losses=res[run]["losses"],
        first_difference=loss_diff(res[run]["losses"], p["losses"]),
        max_gap=max(abs(x - y) for x, y in zip(res[run]["losses"],
                                               p["losses"])))
        for run in ("fault_block", "fault_bucket")}
    out = dict(plain=p, pipelined=q, bitwise=d is None,
               first_difference=d, plain_repeats_bitwise=c is None,
               plain_first_difference=c,
               plain_again_ms_per_step=res["plain_again"]["ms_per_step"],
               planted_faults=faults)
    check(all(np.isfinite(q["losses"])) and q["losses"][-1] <
          q["losses"][0], f"pipelined bert: losses {q['losses']}")
    check(q["step_trace_count"] == 1, f"pipelined bert: "
                                      f"{q['step_trace_count']} captures")
    check(c is None, f"pipelined bert: the plain step does not repeat "
                     f"itself: {res['plain_again']['losses']} vs "
                     f"{p['losses']} (first difference {c})")
    check(d is None, f"pipelined bert: losses {q['losses']} not bitwise "
                     f"the plain step's {p['losses']} (first difference "
                     f"{d})")
    for run, f in faults.items():
        check(f["first_difference"] is not None,
              f"pipelined bert: a planted fault ({run}) leaves every loss "
              f"bitwise the plain step's: the gate cannot fail")
    for name in FLASH:
        check(q["launches"][name] == 12 * PIPE["bert_replays"],
              f"pipelined bert: {name} launches {q['launches'][name]}")
    return out


def pipe_gpipe(torch, np, err):
    """(c) GPipe over 4 virtual stages (parallel/pipeline.py's
    gpipe_ticks with the list rotation, the loop pipeline_apply runs),
    each one gpt_small block (768 wide, 12 heads, causal flash, bf16):
    M = 8 microbatches of B = 2, T = 512, forward and backward against
    the four blocks applied in sequence, at phase 4's bf16 tolerances."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.models.gpt import GPTBlock
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.parallel import pipeline as pl
    S, M, Bm, T = PIPE["stages"], PIPE["micro"], PIPE["micro_B"], GPT["T"]
    atol, rtol, gfrac, gfloor = FLASH_TOL["bfloat16"]
    mx.random.seed(0)
    blocks = []
    for _ in range(S):
        blk = GPTBlock(768, 3072, 12, dropout=0.0, dtype="bfloat16",
                       flash=True)
        blk.initialize(ctx=mx.gpu(0))
        blocks.append(blk)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    x = torch.randn(M, Bm, T, 768, generator=gen,
                    device="cuda").to(torch.bfloat16)
    dout = torch.randn(M, Bm, T, 768, generator=gen,
                       device="cuda").to(torch.bfloat16)
    params = [[p for p in b.parameters()] for b in blocks]

    def stage_fn(blk, h):
        return blk(NDArray(h))._data

    def grads(run):
        xa = x.clone().requires_grad_()
        with torch.enable_grad(), autograd.record(train_mode=True):
            y = run(xa)
            g = torch.autograd.grad(y, [xa] + sum(params, []), dout)
        torch.cuda.synchronize()
        return y.detach(), g

    def sequence(xa):
        outs = []
        for m in range(M):
            h = xa[m]
            for blk in blocks:
                h = stage_fn(blk, h)
            outs.append(h)
        return torch.stack(outs)

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    # the stages' masked outputs summed, as pipeline_apply's psum over
    # the pp ranks sums them: every stage's every tick is in the graph
    y, g = grads(lambda xa: torch.stack(pl.gpipe_ticks(
        stage_fn, blocks, xa, list(range(S)), S)).sum(0))
    pipe_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES, **fa.CAUSAL_LAUNCHES)
    t0 = time.perf_counter()
    ry, rg = grads(sequence)
    seq_s = time.perf_counter() - t0
    worst = {}

    def hold(what, got, want, tol, name):
        d = (got.float() - want.float()).abs()
        check(bool(torch.isfinite(got).all()), f"gpipe {what}: non-finite")
        worst[what] = float((d / tol).max())
        err[name] = max(err.get(name, 0.0), float(d.max()))
        check(worst[what] <= 1.0, f"gpipe {what}: worst |err| / tolerance "
                                  f"{worst[what]:.2f}")

    hold("out", y, ry, atol + rtol * ry.float().abs(), "flash_fwd_causal")
    for j, (a, b) in enumerate(zip(g, rg)):
        hold(f"grad{j}", a, b, gfrac * max(float(b.float().abs().max()),
                                           gfloor), "flash_bwd_dkv_causal")
    ticks = M + S - 1
    for name in FLASH:
        check(launches[name + "_causal"] == S * ticks,
              f"gpipe: {name} causal launches {launches[name + '_causal']}"
              f" != {S} stages x {ticks} ticks")
    out = dict(stages=S, microbatches=M, micro_B=Bm, T=T,
               worst_err_over_tol=max(worst.values()),
               worst_by_part={k: v for k, v in sorted(
                   worst.items(), key=lambda kv: -kv[1])[:4]},
               pipe_s=pipe_s, sequence_s=seq_s, launches=launches)
    del blocks, params, x, dout, y, g, ry, rg
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipe_moe(torch, np):
    """(d) switch_moe at Switch-Base-8's widths (D = 768, d_ff = 3072,
    E = 8, capacity factor 1.25, N = 16 x 512 tokens, bf16 expert FFNs)
    against direct per-token routing in f32 and the same call on the
    CPU; the dropped tokens, ms forward and backward."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch import parallel
    E, D, H, N = PIPE["moe_E"], PIPE["moe_D"], PIPE["moe_ff"], PIPE["moe_N"]
    cf = PIPE["moe_cf"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    x = torch.randn(N, D, generator=gen, device="cuda").to(torch.bfloat16)
    logits = torch.randn(N, E, generator=gen, device="cuda")
    experts = parallel.stack_expert_params([
        {"w1": (torch.randn(D, H, generator=gen, device="cuda")
                * D ** -0.5).to(torch.bfloat16),
         "w2": (torch.randn(H, D, generator=gen, device="cuda")
                * H ** -0.5).to(torch.bfloat16)} for _ in range(E)])

    def ffn(p, h):
        return F.gelu(h @ p["w1"]) @ p["w2"]

    def run():
        xa = x.clone().requires_grad_()
        la = logits.clone().requires_grad_()
        wa = {k: v.clone().requires_grad_() for k, v in experts.items()}
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out, aux = parallel.switch_moe(xa, la, ffn, wa, capacity_factor=cf)
        ev[1].record()
        (out.float().sum() + 0.01 * aux).backward()
        ev[2].record()
        torch.cuda.synchronize()
        return (xa, la, wa, out.detach(), aux.detach(),
                ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]))

    first = run()[5:]          # the first call: cuBLAS / allocator warm-up
    xa, la, wa, out, aux, fwd_ms, bwd_ms = run()
    # direct routing in f32: each token to its argmax expert while the
    # expert's queue has room, gate x FFN(token), else zero
    probs = torch.softmax(logits, -1)
    idx = probs.argmax(-1)
    C = int(max(1, np.ceil(N / E * cf)))
    ref = torch.zeros(N, D, device="cuda")
    dropped = 0
    for e in range(E):
        rows = (idx == e).nonzero()[:, 0]
        kept, dropped = rows[:C], dropped + max(0, rows.numel() - C)
        p = {k: v[e].float() for k, v in experts.items()}
        ref[kept] = probs[kept, e, None] * ffn(p, x[kept].float())
    got = out.float()
    scale = float(ref.abs().max())
    card_vs_direct = float((got - ref).abs().max()) / scale
    cpu = {k: v.cpu() for k, v in experts.items()}
    cpu_out, cpu_aux = parallel.switch_moe(x.cpu(), logits.cpu(), ffn, cpu,
                                           capacity_factor=cf)
    card_vs_cpu = float((got.cpu() - cpu_out.float()).abs().max()) / scale
    zero_rows = int((got.abs().sum(-1) == 0).sum())
    res = dict(N=N, D=D, d_ff=H, E=E, capacity_factor=cf, capacity=C,
               dropped_tokens=dropped, zero_rows=zero_rows,
               max_err_over_max_ref_direct=card_vs_direct,
               max_err_over_max_ref_cpu=card_vs_cpu,
               aux=float(aux), aux_cpu=float(cpu_aux),
               fwd_ms=fwd_ms, bwd_ms=bwd_ms, first_call_fwd_bwd_ms=first)
    check(zero_rows == dropped, f"switch_moe: {zero_rows} zero rows for "
                                f"{dropped} dropped tokens")
    check(card_vs_direct <= 2e-2 and card_vs_cpu <= 2e-2,
          f"switch_moe: max |err| / max |ref| {card_vs_direct:.3e} vs "
          f"direct routing, {card_vs_cpu:.3e} vs the CPU (bound 2e-2)")
    check(abs(float(aux) - float(cpu_aux)) <= 1e-5 * abs(float(cpu_aux)),
          f"switch_moe: aux {float(aux)} vs the CPU's {float(cpu_aux)}")
    check(all(bool(torch.isfinite(t.grad).all()) and
              float(t.grad.abs().sum()) > 0 for t in (xa, la, *wa.values())),
          "switch_moe: a gradient is zero or not finite")
    return res


def pipe_policy(torch, np, free_bytes):
    """(e) kernel_policy.training_plan for bert_base and bert_large (24 x
    1024) at T=512, and one captured step of each at the plan's batch
    and remat mode through pretraining_pipeline (LAMB, f32 masters): the
    peak memory against HBM_USABLE."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import parallel
    from incubator_mxnet_tpu_torch.models import bert as bert_mod
    from incubator_mxnet_tpu_torch.ops import kernel_policy as kp
    T = BERT["T"]
    total = torch.cuda.get_device_properties(0).total_memory
    out = dict(HBM_BYTES=kp.HBM_BYTES, HBM_USABLE=kp.HBM_USABLE,
               total_memory=total, free_at_start=free_bytes)
    check(kp.HBM_USABLE <= free_bytes and kp.HBM_BYTES <= total,
          f"policy: HBM_USABLE {kp.HBM_USABLE} / HBM_BYTES {kp.HBM_BYTES} "
          f"above the {free_bytes} bytes free / {total} on the card")
    for name, ctor, (L, u, h) in (("bert_base", bert_mod.bert_base,
                                   (12, 768, 3072)),
                                  ("bert_large", bert_mod.bert_large,
                                   (24, 1024, 4096))):
        plan = kp.training_plan(L, u, h, 30522, T)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mx.random.seed(0)
        model = ctor(dtype="bfloat16", max_length=T, flash=True,
                     dropout=0.1)
        model.initialize(ctx=mx.gpu(0))
        pre = bert_mod.BERTForPretraining(model)
        pre.initialize(ctx=mx.gpu(0))
        tr = parallel.SPMDTrainer(
            pre, pipeline=bert_mod.pretraining_pipeline(pre),
            remat_plan=[plan["remat"]] * L, optimizer="lamb",
            optimizer_params={"learning_rate": 1e-4,
                              "multi_precision": True},
            mesh=parallel.build_mesh(), sharding="replicated")
        batch = bert_batch(torch, np, np.random.RandomState(0),
                           plan["batch"], T, BERT["M"], 30522, BERT["M"])
        losses = []
        t0 = time.perf_counter()
        for _ in range(3):          # eager, captured, one replay
            mx.random.seed(1)
            losses.append(float(tr.step(*batch).asnumpy()))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[name] = dict(plan=plan, losses=losses, peak_bytes=peak,
                         peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                         peak_over_usable=peak / kp.HBM_USABLE,
                         steps_s=time.perf_counter() - t0,
                         captures=tr.pipelined_step_trace_count)
        check(all(np.isfinite(losses)) and tr.pipelined_step_trace_count
              == 1, f"policy {name}: losses {losses}, "
                    f"{tr.pipelined_step_trace_count} captures")
        check(peak <= kp.HBM_USABLE, f"policy {name}: peak {peak} bytes "
                                     f"over HBM_USABLE {kp.HBM_USABLE}")
        check(out[name]["peak_reserved_bytes"] <= free_bytes,
              f"policy {name}: {out[name]['peak_reserved_bytes']} bytes "
              f"reserved, {free_bytes} were free")
        del tr, pre, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_pipelined(torch, smi, par):
    """The pipelined-backward step, GPipe and Switch MoE on the card
    (module docstring, 7k). ``par`` is phase_parallel's record (par_gpt's
    replicated losses and ms). Returns the path's launches for the
    kernels line and the phase's numbers."""
    import numpy as np
    import torch.distributed as dist
    from incubator_mxnet_tpu_torch import parallel
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free_bytes = torch.cuda.mem_get_info()[0]
    err = {}
    env = par_launch_env()
    out = dict(card=smi)
    try:
        os.environ.update(env)
        parallel.initialize()
        check(dist.is_initialized() and dist.get_world_size() == 1,
              "pipelined: the NCCL group of one did not form")
        out["gpt"] = pipe_gpt(torch, np, par["gpt"]["replicated"])
        out["bert"] = pipe_bert(torch, np)
        out["gpipe"] = pipe_gpipe(torch, np, err)
        out["moe"] = pipe_moe(torch, np)
        out["policy"] = pipe_policy(torch, np, free_bytes)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        parallel.set_default_mesh(None)
        for k in env:
            os.environ.pop(k, None)
    out["max_abs_err"] = err
    out["phase_s"] = time.perf_counter() - t0
    launches = {}
    for part in ("gpt", "bert", "gpipe"):
        for k, v in out[part].get("launches", out[part].get(
                "pipelined", {}).get("launches", {})).items():
            launches[k] = launches.get(k, 0) + v
    g, b = out["gpt"], out["bert"]
    g64, gdef = g["bucket_bytes_65536"], g["bucket_bytes_default"]
    print(f"[pipelined] {smi}: gpt_small bf16 B=16 T=512 pipelined "
          f"{g64['ms_per_step']:.2f} ms a step at {g64['buckets']} buckets "
          f"of 64 KiB, {gdef['ms_per_step']:.2f} ms at the default "
          f"{gdef['buckets']}, vs replicated "
          f"{g64['replicated_ms_per_step']:.2f}; busy "
          f"{g64['device_busy_share']} / {gdef['device_busy_share']}; "
          f"losses bitwise replicated at both; timeline {g64['structure']}"
          f" / {gdef['structure']}; bert_base bf16 B=32 "
          f"{b['pipelined']['ms_per_step']:.2f} ms vs plain "
          f"{b['plain']['ms_per_step']:.2f}, losses bitwise the plain "
          f"step's {b['bitwise']} (planted faults first differ at "
          f"{[f['first_difference'] for f in b['planted_faults'].values()]}"
          f"); gpipe "
          f"worst |err| / tolerance {out['gpipe']['worst_err_over_tol']:.3f}"
          f"; switch_moe dropped {out['moe']['dropped_tokens']} of "
          f"{out['moe']['N']}, fwd {out['moe']['fwd_ms']:.2f} ms bwd "
          f"{out['moe']['bwd_ms']:.2f} ms", flush=True)
    print(f"[pipelined] {json.dumps(out)}", flush=True)
    return dict(launches=launches, err=err)


def kernel_record(err, runs, times):
    """The kernels' JSON record; each kernel's launches come from the run
    of its own path (decode / prefill: plain; verify: spec_k=4 on raw
    pools; the _q variants: spec_k=4 on int8 pools; both replaying the
    plain run's streams as drafts; the flash kernels: the bert_base
    training run; their causal rows: the gpt_small training run's timed
    replays), the flash kernels' plus the sp ring's (7j) and the
    pipelined path's (7k: the pipelined GPT and BERT steps' timed
    replays, the virtual GPipe stages)."""
    path_of = {"ragged_decode": "plain", "ragged_prefill": "plain",
               "ragged_verify": "spec", "ragged_decode_q": "spec_int8",
               "ragged_prefill_q": "spec_int8",
               "ragged_verify_q": "spec_int8",
               "flash_fwd": "training", "flash_bwd_dq": "training",
               "flash_bwd_dkv": "training"}
    path_of.update({f"{k}_causal": "gpt_training" for k in FLASH})
    # the sp ring's launches (7j) and the pipelined path's (7k) join the
    # flash kernels' paths'
    seq = dict(runs.get("sequence", {}).get("launches", {}))
    for k, v in runs.get("pipelined", {}).get("launches", {}).items():
        seq[k] = seq.get(k, 0) + v
    source = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
              "flash_bwd_dkv": "flash_bwd"}
    kernels = []
    for name in KERNELS + tuple(f"{k}_causal" for k in FLASH):
        t = times[name]
        launches = runs[path_of[name]]["launches"].get(name, 0)
        check(launches > 0, f"{name} never launched on its path")
        launches += seq.get(name, 0)
        base = name.removesuffix("_causal")
        src = source.get(base, base.removesuffix("_q"))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"incubator_mxnet_tpu_torch/csrc/{src}.cu",
            "replaces": REPLACES[base],
            "launches": launches,
            "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    return kernels


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-cpu-worker":
        par_cpu_worker(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script needs the GPU",
              file=sys.stderr)
        return 1
    try:
        import incubator_mxnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        smi = phase_device(torch)
        phase_build()
        err = phase_kernels(torch)
        err.update(phase_flash_kernels(torch))
        runs = phase_serving(torch)
        phase_surface(torch)
        phase_fleet(torch)
        phase_parity(torch)
        phase_graph_tests()
        phase_ops()
        runs["training"], lens = phase_training(
            torch, torch.cuda.get_device_name(0))
        phase_long_sequence(torch)
        phase_bert_parity(torch)
        phase_gluon(torch, torch.cuda.get_device_name(0))
        phase_vision(torch, smi)
        phase_amp(torch, smi)
        phase_symbolic(torch, smi)
        phase_detection(torch, smi)
        phase_imagenet(torch, smi)
        phase_rnn(torch, smi)
        phase_quantization(torch, smi)
        runs["gpt_training"] = phase_gpt_training(torch, smi)
        phase_checkpoint(torch, smi)
        phase_nmt(torch, smi)
        mf = phase_sparse(torch, smi)
        phase_contrib(torch, smi, mf)
        del mf
        par = phase_parallel(torch, smi)
        runs["sequence"] = phase_sequence(torch, smi)
        runs["pipelined"] = phase_pipelined(torch, smi, par)
        del par
        times = phase_times(torch)
        times.update(phase_flash_times(torch, lens, err))
        for mod in ("jax", "incubator_mxnet_tpu"):
            check(mod not in sys.modules, f"{mod} was imported")
        kernels = kernel_record(err, runs, times)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
