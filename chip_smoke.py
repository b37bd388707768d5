#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no final "ok" line:

  device    the card's name, and its name and power limit as nvidia-smi
            reports them (also printed alone on a line)
  build     nvcc builds every kernel library from paddle_tpu_torch/csrc
            (decode attention, flash attention, GRU, LSTM, gate-blocked
            LSTM, simple RNN), one nvcc per source, in parallel; seconds
            taken
  kernels   each kernel at the main path's shapes against its plain
            PyTorch version (max abs error within the stated bound; the
            LSTM pair on a ragged mask with an empty row, timed on the
            train batch's full rows with the backward's BPTT / dW_r split,
            also across the (B, D) its rule admits (D 128 and 256 at
            B 24, D 384 at B 64, D 640 at B 32, B 1448 at D 128, B 168 at
            D 512) and through a reverse LSTM, every check also within
            the 3xTF32 gate, which a one-TF32-pass build of the kernels
            must fail at the train shape; the decode kernels also at
            head dims 6 to 512, the flash forward, its backward pair and
            flash_attention_quant at the same widths (256, 384, 512 on
            the wide instances); the
            paged pair over a 129-block pool with
            shuffled ids, shared leading blocks and a free row on block
            0, and the Tq=1 slab kernel; the Tq=1 kernels on the split-KV
            template (slab and paged, float32 and int8, H = Hkv and GQA)
            bit for bit on a repeat, each row alone (S 1) and inside a
            T 2048 span, a long span against the plain version, int8 bit
            for bit its float32 kernel, with their device time alone
            (CUDA-graph replay) beside SDPA's; the flash forward, dK/dV
            and dQ at dh 256, 384 and 512 (B 4, H 2, T 512, causal and
            full) within the 3xTF32 gate 1e-5, which a one-TF32-pass
            build must fail, timed beside SDPA (naming its backend), and
            flash_attention_quant at dh 256; the int8 instances of the four
            decode kernels at the same shapes and flash_attention_quant
            at B=32, T=32 and a ragged T=200 with Hkv=2, each also held
            bit for bit against its float32 kernel on the dequantized
            cache; the flash forward and its backward pair at the MT
            train shape B=32, H=8, T=256, dh=64, causal and not, the pair
            also ragged and at dh 16/32/128 and repeated bit for bit; the
            GRU pair at the seq2seq train shape T=30, B=64, D=512 on full
            rows and on a ragged mask with an empty row, at D=128 and 640
            (B=64), D=768 (B=8) and the largest B the rule admits at D 128,
            512 and 768 (2536, 392, 16), each also within the 3xTF32 gate
            and bit for bit on a second launch, the gate failed by a
            one-TF32-pass build at the train shape, the backward timed
            with its BPTT / dW split, and through a reverse rnn.gru, with
            the cost of one grid barrier of the forward's grid timed
            alone; the gate-blocked
            LSTM forward, both variants, at T=100, B=64, D=1280 and 2048
            on full rows and on a ragged mask with an empty row, at D=640
            and odd T (B=64), B=256 with D=512, B=8 with D=3456 and
            B=72 with D=2432; a
            reverse rnn.lstm at B=8 through the resident kernels, and
            rnn.lstm at B=5 and with act="relu" through the masked scan
            on the card, held against the CPU, launching no kernel; the
            simple-RNN forward, BPTT and dW at the DSL slice's train shape
            T=100, B=64, D=512 on full rows and on a ragged mask with an
            empty row, at the ends of the rule's range (D 1152 at B 64,
            D 1280 at B 8, B 4736 at D 128) and odd T, each also within
            the 3xTF32 gate and bit for bit on a second launch, the
            gate failed by a one-TF32-pass build at the train shape, the
            backward timed with its BPTT / dW split; a reverse
            rnn.simple_rnn through the kernels and rnn.simple_rnn at B 12
            and with act="relu" through the scan on the card, held
            against the CPU),
            timed with CUDA events beside the plain version, one
            PyTorch library call computing the same function (a
            yardstick the port never calls; none exists for the int8
            kernels) and the least time the card could take (for the
            3xTF32 flash forward, its int8 instance, dK/dV, dQ, the
            gate-blocked LSTM forward, the GRU and the simple-RNN
            kernels at the tensor cores' rate, the float32 SIMT bound
            and the ratio to the library call beside it; for the
            blocked forward also the time W_r takes to
            stream from HBM once a step)
  flash_dh96  the flash forward and backward pair at head dim 96, which
            the wrappers zero-pad to the compiled 128, against the plain
            versions at dh 96 (causal T 256, non-causal Tq 200 / Tk 136),
            and dot_product_attention's flash route at B 2, H 8, T 256:
            one launch of each flash kernel, gradients against autograd
            of the plain forward
  generate  lm_generate on the full-width Transformer-base LM (vocab
            32000, d_model 512, 8 heads, dff 2048, 6 layers), batch 32,
            prompt 32, max_len 160, greedy: the flash kernel launches
            once per layer; two rows are held against the same call on
            the CPU (plain versions)
  serve     the port's HTTP server over the same trunk (8 slots, max_len
            256, chunk 8) answers 12 concurrent staggered /v1/generate
            requests, some streamed: the chunk kernel launches once per
            layer per step; each stream is held against lm_generate on
            the card
  serve_paged  the same server on the paged KV layout (block size 16) with
            a pool a quarter of the slab's size: 12 requests, half sharing
            a 64-token preamble, two exact duplicates, most in one burst.
            The paged chunk kernel launches once per layer per step; the
            prefix cache hits, a shared block is forked (copy-on-write)
            and a dry pool preempts a slot; every stream is held against
            lm_generate
  ladder    the legacy prefill ladder (prefill_chunk=0, buckets 32/64) on
            the slab and the paged layout, 8 staggered requests each: the
            flash kernel launches once per layer per prefill batch, the
            Tq=1 slab / paged kernel once per layer per step; streams are
            held against lm_generate
  generate_int8  lm_generate over an int8 KV cache at the generate phase's
            shape: flash_attention_quant launches once per layer; the int8
            prefill's logits within the budget (0.06) of the float32
            twin's; the greedy prefix shared with the float32 stream is
            reported; two rows are held against the same call on the CPU;
            the int8 KV quantizer (quant/kv.quantize_heads) on the card
            against the CPU on the same inputs (the first layer's K and a
            wide spread of random magnitudes), codes and scales bit for
            bit, the Python-scalar division it no longer uses counted
            beside it
  serve_int8  the serve phase over an int8 KV cache: the int8 chunk kernel
            once per layer per step, /metrics shows kv_cache_int8 1,
            streams held against the int8 lm_generate
  serve_paged_int8  the paged layout over an int8 KV cache with the auto
            pool (twice the float32 slab's blocks, fewer bytes): the 12
            serve_paged requests; prefix hits and copy-on-write forks of
            int8 blocks; the pool's KV bytes beside the float32 slab's
  ladder_int8  the ladder phase over an int8 KV cache, both layouts:
            flash_attention_quant once per layer per prefill batch, the
            int8 Tq=1 slab / paged kernel once per layer per step
  serve_w8  the LM's int8 trunk (quant/weights.quantize_lm) behind the
            server in a slab engine over float32 KV and a paged engine
            over int8 KV (the full-quant engine): 12 staggered requests
            each, the chunk kernel of the cache once per layer per step,
            every stream held against lm_generate over the same int8
            tree (whose prefill launches the flash kernel once per layer
            per call); first, the card's int8 tree is held against the
            CPU's on the same weights (codes and scales bit for bit)
            and its prefill logits within 1e-3 of the CPU's; the logit
            error against the float32 tree is reported on both devices
            beside quant/kv's budget (0.06)
  serve_spec  speculative serving (k 4, a 2-layer draft sharing the
            target's embedding) on the slab over float32 KV and the
            paged layout over int8 KV, each beside its non-speculating
            twin, then with another seed's draft and an adversarial one
            (that trunk's embedding scaled by 0.01), and the int8 trunk
            speculating (--quant-weights 1 --speculate-k 4): streams held
            against the twin and lm_generate; every verify run delivers
            a token; the target's chunk kernel once per layer per step,
            the draft's chunk kernel once and its Tq=1 kernel 3 times per
            draft layer per rollout; acceptance rate, tokens a verify
            step and tokens/s beside the twin's
  serve_moe  the LM's trunk with 8-expert top-2 FFNs (random from the
            seed) behind the server in a slab engine over float32 KV and
            a paged engine over int8 KV: 12 staggered requests each, the
            chunk kernel of the cache once per layer per step, every
            stream held against lm_generate over the same trunk (whose
            prefill launches the flash kernel, or its int8 instance,
            once per layer per call); first its prefill against a CPU
            witness on the same inputs that routes by the card's expert
            choices (logits, router probabilities, flips only at ties),
            and the card's prefill under that probe bit for bit the one
            without it
  ladder_dh256, ladder_dh256_int8  the ladder on the slab layout for an
            LM at D 512 over 2 heads (dh 256; 2 layers), float32 and int8
            KV: the wide flash instance (flash_attention_quant) once per
            layer per prefill batch, the Tq=1 slab kernel at dh 256 once
            per layer per step; streams held against lm_generate
  train     the headline benchmark, bench.py's bench_lstm ported
            (scripts/bench.bench_lstm): the LSTM text classifier at vocab
            30000, embedding 128, 2 x LSTM h=512, batch 64, length 100,
            Momentum, on one fixed batch.  Its first step is held
            against the same step on the CPU (plain versions: loss and
            every gradient leaf), then warm-up and timed steps: each
            step launches the LSTM forward and backward kernels once per
            layer, the loss is finite and falls
  train_lstm1280, train_lstm2048  bench.py's lstm1280 / lstm2048 rows:
            the same model and batch at h=1280 and 2048, whose LSTMs take
            the gate-blocked route: the first step against the CPU (at
            batch 8 for h=2048, the same route at an eighth of the
            host's cost), then warm-up and timed steps at batch 64, each
            launching the blocked forward once per layer and no resident
            kernel; the loss is finite and falls
  train_transformer  bench.py's bench_transformer ported
            (scripts/bench.bench_transformer): the Transformer-base MT
            model at vocab 32000, d_model 512, 8 heads, dff 2048, 6+6
            layers, length 256, Adam lr 1e-4, label smoothing 0.1,
            full_seq.  One step at batch 2 is held against the same step
            on the CPU: its FFN pre-activations, the ReLU sign flips
            between the two counted; loss, every gradient leaf and m/v
            slot against a CPU step that keeps the card's ReLU
            decisions, and by relative L2 against the plain CPU step; a
            TF32 control step must fail these checks.  Adam's update on
            the card is held against its own slots; then
            warm-up and timed steps at batch 32, each launching the flash
            forward, dK/dV and dQ kernels 18 times (6 encoder, 6 decoder
            self-, 6 cross-attentions); the loss is finite and falls
  train_packed  bench.py's bench_transformer_packed ported: the
            decoder-only trunk (vocab 32000, d_model 512, 8 heads, dff
            2048, 6 layers) on 16 packed rows of 512 slots, lm_loss over
            segment ids and within-segment positions, Adam lr 1e-4.  The
            first step against a CPU witness on the same weights and
            batch that keeps the card's ReLU decisions; warm-up and timed
            steps, none launching a flash kernel (segmented attention is
            the dense path); real tokens/s and the pack efficiency
  train_moe  bench.py's bench_transformer_moe ported: that trunk with
            8-expert top-2 FFNs at batch 16, length 512; the first step
            (at MOE_CHECK_BATCH rows) against a CPU witness that keeps the
            card's ReLU decisions and top-2 expert choices, the router's
            probabilities, flips at ties only and the aux term checked;
            timed steps at batch 16 launching no flash kernel
  train_remat  the train_transformer step with remat=True (each block
            recomputed in the backward) beside remat=False: the first
            step's loss and gradients bit for bit equal, the flash
            forward 36 times a step and dK/dV and dQ 18 (18 each
            without), the step's memory peak lower with remat; ms/batch
            of both
  train_seq2seq  bench.py's bench_seq2seq ported
            (scripts/bench.bench_seq2seq): the attention NMT model at
            vocab 30000 both sides, emb = hidden = attention 512, batch
            64, lengths 30 / 30, Momentum.  Its first step is held against
            the same step on the CPU (plain versions: loss, every
            gradient leaf and momentum slot), then warm-up and timed
            steps, each launching the GRU forward and backward kernels
            twice (the encoder's two directions); the loss is finite and
            falls.  Then greedy_generate at batch 64, max_len 30 on the
            trained params: the lean GRU forward twice, no backward; its
            tokens held against the same call on the CPU up to each
            row's first step whose top-1/top-2 margin is below MARGIN_TOL,
            and the whole sample on values: the encoder's outputs and
            every step's log-probs teacher-forced on the CPU's tokens,
            card vs CPU within S2S_REL_TOL
  train_rnn  a layer-DSL config through trainer.SGD (models/text_rnn: the
            RNN text classifier, vocab 30000, embedding 128, 2 x
            [fc_layer(512) -> recurrent_layer(tanh)], max-pool, fc 2
            softmax, classification_cost, batch 64, length 100,
            Momentum): the first step against a CPU witness from the
            same weights that max-pools at the card's argmax (loss, every
            gradient, param and momentum leaf; the argmax flips counted,
            each a near-tie), its update lowering its batch's cost; then
            SGD.train over 20 batches, each step launching the simple-RNN
            forward and backward kernels twice, the losses finite;
            SGD.test on a held-out reader; the step's split into feed,
            forward, backward and update; then `python -m
            paddle_tpu_torch train` as a subprocess on a config file,
            whose pass dir SGD.load restores bit for bit
  train_int8  bench.py's bench_trainer_int8 ported: SGD(quant_weights=True)
            on an fc classifier (batch 64, dim 64, hidden 128): the first
            step's int8 twin (initial and requantized after the update)
            bit for bit the CPU's on the same masters; 24 batches beside
            the float32 twin, the loss gap within quant/weights'
            TRAIN_LOSS_BUDGET (0.05); between steps only int8 codes and
            float32 scales of the quantized weight (and no widened
            float32 copy) live; ms/batch of both
  train_rnn_bf16  the train_rnn config under the bf16 compute policy
            (SGD(compute_dtype=torch.bfloat16), core/dtypes.set_policy
            bfloat16): the first step against a CPU witness from the same
            weights that max-pools at the card's argmax (loss and every
            gradient leaf within BF16_GRAD_TOL, which the same step with
            its products' cotangent rounded to bf16 must fail), B11's
            (float32 xs, bf16 W) instances launched 2 + 2; then
            BF16_STEPS steps of
            SGD.train on one batch (its loss falls), each launching them
            2 + 2, ms/batch beside the same steps without the policy;
            then `python -m paddle_tpu_torch train --dtype bfloat16` as a
            subprocess, whose float32 pass dir SGD.load restores bit for
            bit
  train_dsl_bf16  the same for text_rnn's cell="lstm" at h 512 (B9's
            instances) and h 1280 (B12's forward; its backward is plain
            torch) and cell="gru" at h 512 (B10's), the first step at
            BF16_CHECK_BATCH rows; then each family's recurrent layer fed
            by an embedding (bf16 xs: the (bf16 xs, bf16 W) instances),
            two steps each, launch counts exact
  rnn_ops_bf16  the ops API's recurrent entry points (ops/rnn.simple_rnn,
            lstm at h 512 and 1280, gru) called with bf16 xs and float32
            weights at the kernel table's shapes, forward and backward:
            the (bf16 xs, float32 W) instances launched once each way,
            hs within one bf16 step of the CPU's, the gradients within
            MIXED_GRAD_TOL
  train_transformer_bf16  bench_transformer (B 32, T 256) under
            set_policy("float32", "bfloat16"): the first step at batch 2
            against a CPU witness that keeps the card's ReLU decisions
            (loss, every gradient leaf within BF16_MT_GRAD_TOL, which the
            rounded-cotangent control must fail), warm-up and timed steps
            with the
            flash kernels' launches, the loss falling, ms/batch beside
            train_transformer's and the matmul route the card took
  train_dsl_f16  text_rnn's RNN, LSTM (h 512 and 1280) and GRU under the
            float16 policy (SGD(compute_dtype=torch.float16)): each first
            step against the plain CPU step (loss, every gradient leaf
            within F16_GRAD_TOL), the (float32 xs, float16 W) instances'
            launches exact; each family fed by an embedding (the
            (float16 xs, float16 W) instances), one step each
  rnn_ops_f16  rnn_ops_bf16's calls with the pairs no float16 policy
            feeds ((float16 xs, float32 W) and the mixed bf16 / float16
            pairs), F16_OPS_T steps
  attention_ops_bf16, attention_ops_f16  dot_product_attention's flash
            route (forward and backward), flash_attention_quant and the
            four decode wrappers called with bf16 (float16) operands in
            every combination with float32 JAX takes (the float16 run
            also two that mix float16 with bf16): each instance launched
            as counted, every output within one bf16 (float16) step of
            the CPU's, the gradients within MIXED_GRAD_TOL
  generate_mt  transformer.generate_cached at bench_transformer_decode's
            widths (batch 32, sources of 128, 128 steps, beam 4, vocab
            32000, 6 + 6 layers): no kernel launch (the encoder's key
            mask takes the dense path, as JAX's route), held against the
            full-recompute generate on the card and a CPU run of the
            first rows up to each row's first near-tie (BEAM_MARGIN),
            bit for bit on a repeat; ms per batch, emitted tokens/s
  generate_seq2seq  seq2seq.generate (beam 5, 50 steps) at
            bench_seq2seq's widths: the lean GRU forward twice, held
            against a CPU run of the first rows as generate_mt is
  train_resnet50  bench.py's bench_resnet50 ported: ResNet-50, batch 32
            of 224x224x3, 1000 classes, Momentum lr 0.1.  The first step
            at RESNET_CHECK_BATCH rows against a CPU witness from the
            same weights that keeps the card's ReLU and max-pool
            decisions (loss, every gradient leaf, the new moving stats),
            which a step with cuDNN's TF32 on must fail; the plain CPU
            step's readings and the decision flips reported; then
            warm-up and timed steps (ms/batch, images/s), the loss
            finite, the moving stats moved, features() against the
            forward's pooled tensor, no counted kernel launched
  train_lenet  demo/mnist's config rebuilt with paddle_tpu_torch.layers
            (models/image_dsl.lenet) through SGD on the mnist loader's
            batches of 128: the first step against the CPU witness, then
            SGD.train (the loss falls), SGD.test, and `python -m
            paddle_tpu_torch train` on a config file, whose pass dir
            SGD.load restores bit for bit
  train_image  bench.py's bench_image ported: SmallNet (64 x 32x32),
            AlexNet (64 x 227x227) and GoogLeNet (64 x 224x224): each
            first step at IMAGE_CHECK_BATCH rows against the CPU
            witness, then timed steps, beside the reference's K40m time
  train_resnet_cifar  demo/image_classification's DSL ResNet
            (models/image_dsl.resnet_cifar: batch_norm_layer, addto_layer)
            at depth 32 on CIFAR shapes through SGD: the first step at
            DSL_RESNET_CHECK rows against the CPU witness (parameters,
            momentum, moving stats), SGD.train over 8 batches of 128
            with the moving stats threading through, SGD.test on them
  train_recommendation  demo/recommendation's step at full width
            (scripts/bench.bench_recommendation: the MovieLens towers,
            emb 256, hidden 256, batch 128 of the movielens loader, Adam
            lr 1e-3): the first step against the same step on the CPU
            (loss and every gradient leaf within REC_TOL of the largest,
            every new parameter within REC_PARAM_TOL), which the step
            with cuBLAS's TF32 on must fail; then one pass, the loss falling, no counted kernel
            launched; ms/batch, samples/s
  train_vgg_cifar  demo/image_classification's vgg (models/image_dsl
            .vgg_bn_drop: networks.img_conv_group with batch norm and a
            0.3 dropout_layer) through SGD at batch 128 of the cifar
            loader: the first step at VGG_CHECK rows against the CPU
            witness that replays the card's ReLU / max-pool decisions
            and dropout masks, which cuDNN's TF32 must fail; SGD.train
            over VGG_PASSES passes of VGG_BATCHES batches (the loss
            falls below the first step's), SGD.test
  train_sentiment  demo/sentiment's stacked_lstm_net (models/text_dsl:
            three lstmemory of hid 128, the middle one reversed) through
            SGD at batch 64 of the imdb loader's ragged reviews: the
            first step against a CPU witness that max-pools at the
            card's argmax (loss and every gradient leaf), which the same
            step through the one-TF32-pass LSTM build must fail; the LSTM
            kernels launched 3 + 3 a step over SENT_BATCHES steps (the
            loss falls), SGD.test, and `python -m paddle_tpu_torch train
            --config paddle_tpu_torch/models/text_dsl.py`, whose pass dir
            SGD.load restores bit for bit; then quick_start's lstm config
            (networks.simple_lstm), its first step likewise and 1 + 1
            launches a step
  trainer_a9c  the rest of the trainer at the text demos' widths: the
            sentiment demo through SGD(evaluators=[classification error,
            auc], grad_accum_steps=2), two passes of 8 micro-batches (B9
            3 + 3 a micro-batch), the evaluators equal to a host recount
            of the card's outputs, the first micro-batch holding the
            parameters, the first applied update against a CPU witness
            (its one-TF32-pass control failing), the pass-end saves in the
            background reloading equal (pass seconds beside a pass with
            blocking saves); a real SIGTERM mid-pass, its meta, and the
            resume in a fresh SGD against the uninterrupted run (bit for
            bit, or the spread of two uninterrupted runs); Inferencer at
            float32, bf16 and int8 against the CPU's; quick_start's lstm
            with a 0.5 pruning hook on both weights, its pruned entries
            exactly 0.0 after 10 steps (1 + 1 launches a step); the CLI's
            time, checkgrad (PASSED, B9 on its path), merge_model and
            version jobs as subprocesses
  train_srl  demo/semantic_role_labeling's db-LSTM + CRF
            (models/tagging_dsl: emb 32, eight lstmemory of hid 128
            alternating in direction over 512-wide mixed layers, the
            crf_layer cost) through SGD at batch 16 of the conll05
            loader's ragged sentences: the first step against the CPU
            (loss and every gradient leaf), which the same step through
            the one-TF32-pass LSTM build must fail; the decoded paths
            held by their score under the CPU's emissions; the LSTM
            kernels launched 8 + 8 a step over SRL_BATCHES steps,
            SGD.test's cost below the start weights', and `python -m
            paddle_tpu_torch train
            --config paddle_tpu_torch/models/tagging_dsl.py`, whose pass
            dir SGD.load restores bit for bit
  train_crf_demos  demo/sequence_tagging's linear CRF (its first step
            against the CPU, the decoded paths by score, a pass after
            which SGD.test's cost is below the start weights'),
            quick_start's cnn (networks.sequence_conv_pool: its first
            step against a witness that max-pools at the card's argmax,
            a pass), the introduction's line (8 passes reach w 2,
            b 0.3) and a ctc_layer graph's loss and gradients against
            the CPU; no counted kernel launched
  layers_a10b  the elementwise, sequence and layer_math layers, nce_layer
            and hsigmoid (2073 classes) and sampling_id_layer in one
            graph at batch 64, width 256 over ragged sequences: every
            output and gradient against the CPU within 1e-5 of its
            largest entry, the card's draws replayed on the CPU; no
            counted kernel launched
  train_word2vec, train_word2vec_softmax  demo/word2vec
            (models/word2vec_dsl: vocab 2073, four embeddings sharing one
            table, fc 128, hsigmoid or a softmax fc) through SGD at batch
            64 with AdaGrad: the first step against the CPU, three
            passes of the imikolov loader (the first pass's loss falling,
            SGD.test's cost below the start weights'), the CLI on
            word2vec_dsl.py; no counted kernel launched
  train_seqtoseq_demo  demo/seqToseq's training script
            (models/seqtoseq_demo: hidden 256, batch 32 of the wmt14
            loader's ragged sources, Adam with clip_norm): the encoder
            before any step and the first step's loss and gradients
            against the CPU, which the same step through the
            one-TF32-pass GRU build must fail; the GRU kernels 2 + 2 a
            step over a pass whose loss falls; beam generate (5 lanes,
            40 steps) on 8 test sources, the lean forward once a
            direction, against the CPU up to each row's first near-tie
  train_sparse  models/text_rnn's LSTM config (vocab 30000, emb 128, two
            LSTMs of 512, batch 64 x 100, Momentum) with a sparse_update
            embedding through SGD's sparse step: the first step against
            the CPU (the row block's gradient; the one-TF32-pass LSTM
            build must fail that gate) and against the card's dense step,
            the catch-up rows (touched at step 1, not at step 2)
            unchanged sparse and moved dense, B9 2 + 2 a step over 8
            batches; ms/batch, samples/s and the host sync's share,
            sparse and dense, at vocab 30000 and 1,000,000
  nested_a9f  models/text_dsl's nested config (imdb reviews as 1-8
            sub-sequences of at most 16 tokens, averaged within each, an
            LSTM of 128 over them) at batch 64: the first step against
            the CPU, B9 1 + 1 a step, two more Adam steps through SGD
  trainer_prefetch  bench.py's bench_trainer_prefetch MLP through
            SGD.train: a pass at prefetch=2 bit for bit prefetch=0;
            steps/s at both depths and h2d_wait
  train_lstm_group  models/text_rnn with each LSTM a
            networks.lstmemory_group (a recurrent_group of lstm_step
            layers; vocab 30000, emb 128, two of h 512, batch 64 x 100,
            Momentum) through SGD: the first step against the CPU (the
            TF32 cuBLAS step must fail that gate), then a pass launching
            no counted kernel; its lstmemory twin on the mapped weights
            through SGD (B9 2 + 2 a step); on one batch the group's loss,
            both layers' outputs and every gradient against the twin's,
            which the twin with its peepholes zeroed must fail; the same
            for networks.gru_group against grumemory at T 30 (B10 2 + 2);
            ms/batch and peak memory of each; the scan hoist on and off
            (values equal) on lstm_recurrent_layer_group and on a group
            that projects its input inside the step
  seqtoseq_v1  models/seqtoseq_dsl (demo/seqToseq/v1's attention GRU
            encoder-decoder at train.conf's widths: dim 512, beam 3,
            max_length 250, error clipping 50, Adam lr 5e-4; wmt14
            vocabularies 3000 / 3000, batch 48) through SGD: the first
            step against the CPU, B10 2 + 2 a step, the loss falling;
            the trained weights decode by name in the beam_search graph
            (B10 forward once a direction), held against a CPU decode
            up to each row's first near-tie, every beam re-scored by
            the training graph's decoder within 1e-4, greedy_generation
            equal to beam 1; ms/batch and tokens/s of both
  nested_group  models/text_dsl's nested_group classifier (a
            recurrent_group over SubsequenceInput sentences, an
            lstmemory of 128 in its step) through SGD: the first step
            against the CPU, B9 once per padded outer step forward and
            backward, the loss falling; sequence_nest_rnn equal to
            sequence_rnn at width 128, which the unbooted inner memory
            must fail
  recurrence_1b  mdlstmemory (B 16, 16 x 16, D 64) forward and backward
            against the CPU, timed; prev_batch_state: an lstmemory of
            512 (B 64, T 100) over two carried halves equal to one
            unbroken run (B9 on the first half, the scan on the second),
            which the halves without the carry must fail; three carried
            SGD steps (the carry requires no gradient, the step time
            does not grow); the halves for grumemory (B10)
  demos_a14  the four demos with no earlier port config at their own
            widths (models/traffic_dsl: 24 heads over a shared
            _link_vec.w, RMSProp; moe_dsl: 4 experts top 2, Adam;
            gan_dsl: two Topologies in turn, Adam; lm_demo: the packed
            char LM, Adam, then lm_generate): each first step against
            the CPU within 2e-5, which the same step with cuBLAS's TF32
            on must fail; ms/step; the demos' own end checks (moe's
            quadrant accuracy >= 0.9, gan's radius mean within 0.25 of
            1, each with its untrained control missing; lm's greedy
            continuations equal to a CPU run on the trained weights up
            to the margin, a sentence of the grammar); lm_generate's
            flash prefill and Tq=1 split-KV launches counted
  host_a5   utils/flags, obs/trace and resilience/faults: the served LM
            (slab, chunked) with tracing off and on through FLAGS,
            tokens bit for bit, the span structure equal to the CPU's,
            traceparent continued, the step wall of both; unsupervised
            decode-step (chunked) and prefill (ladder) faults ending the
            same requests as on the CPU, the rest bit for bit a clean
            run; a trainer.step fault then train(resume=True) bit for
            bit; FLAGS giving python -m paddle_tpu_torch train its
            --prefetch default
  serve_a6b the host KV tier on the served LM (paged, chunked, a
            41-block pool): two waves of 12 chained streams over three
            shared 96-token prefixes with churn between, the second
            restoring the spilled prefixes, on a float32 and an int8
            pool: bit for bit a tier-off engine, the second wave against
            the CPU, spills and restores counted, the ledger clean, B4 /
            6d LAYERS a step; the pinned host-to-device rate and the step
            wall (the h100 row of perf/roofline); restore against
            recompute of a 16-block and a sub-chunk prefix, timed beside
            the router's prediction, whose direction must hold both
            ways; a handoff between a prefill and a decode server over
            /v1/kv/export, bit for bit a single engine; continuation
            replay on the slab and paged engines, bit for bit
  serve_a7  supervised recovery on the chunked slab engine and the
            ladder (B1; B3 and B2): 12 chained streams under two step
            errors and a hang past the watchdog deadline, bit for bit
            the clean run, the evictions and failed requests of the same
            plan on the CPU, one watchdog trip, the late step discarded
            by the epoch guard, the supervisor.recover stall; supervised
            without faults equal to unsupervised; the breaker opening
            after three failures (/readyz 503 with Retry-After) and a
            probe closing it; /v1/infer on lenet (concurrent clients bit
            for bit the direct forward) and the sentiment classifier's
            sequence feeds (B9 3 a batch, against the CPU), ms a batch by
            bucket, an engine.execute fault failing only its batch
  serve_a8  the multi-process tier on the served LM: two replica
            subprocesses (python -m paddle_tpu_torch.serving) under
            ReplicaSupervisor behind Router, 12 streaming clients, kill
            -9 of one mid-stream: every stream bit for bit an in-process
            engine from the same seed, the victim restarted on its
            seeded backoff; the failover stall, kill -> ready and the
            router's added TTFT / TPOT against direct clients; a drain
            under load with no failed request; a prefill/decode pair
            (paged, host tier) handing every stream off at its first
            token, bit for bit a mixed engine, with the analytic and
            dead-source recompute fallbacks (B4 LAYERS a step); AIMD
            shedding by class (429 + Retry-After) and the brownout token
            cap (a prefix of the uncapped stream); the autoscaler
            scaling out on a TTFT breach and back in, no failed request,
            its journal printed
  api_a11   the API surfaces: demo/seqToseq/v1's train.conf through
            the port's config compiler at dim 512, batch 48 (the parsed
            graph is models/seqtoseq_dsl's, its first step on the card
            that graph's from the same weights, 4 steps with B10 2 + 2,
            the generation parse decoding 8 rows with B10 forward 2);
            the same config through the trainer CLI (2 steps and the
            pass-end test); a paddle_tpu_torch.v2 lstmemory classifier
            (B9 1 + 1 a step, against the CPU, the parameters tar bit for
            bit, v2.infer); --prefill-chunk-budget 4 on the served LM
            (streams equal lm_generate, B1 6 a step)
The kernels phase also holds every bf16 and float16 instance of the
recurrent kernels (bf16_instances, rnn_f16: each (xs, W) pair of
float32 / bf16 / float16 with a low-precision operand) and every bf16
instance of the attention kernels (attention_bf16: each combination of
float32 and bf16 q, k, v; bf16 q over int8 K/V) and every float16 one
(attention_f16: each combination of float32 and float16, two mixing
float16 with bf16; float16 q over int8 K/V) against its plain version on
the same inputs at the kernel table's shapes, timed beside its float32
instance.
Then the kernel summary line, the nvidia-smi line, and last:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Without a CUDA device, or run from a directory that holds this script
and nothing else of the repository, it exits non-zero and prints no
result.
"""

import argparse
import contextlib
from concurrent.futures import ThreadPoolExecutor
import json
import math
import signal
import sys
import threading
import time
import urllib.request

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s,
# float32 FLOP/s outside the tensor cores (the SIMT kernels), and the
# tensor cores' dense TF32 rate (495 TFLOP/s) over 3: the flash forward,
# its int8 instance, the dK/dV and dQ kernels, the gate-blocked LSTM
# forward, the resident LSTM and the vanilla-RNN kernels run each float32
# product as three TF32 ones (3xTF32), so their least time is the float32
# FLOPs over PEAK_3XTF32_FLOPS.  Their phase rows also keep the float32
# SIMT bound beside it (bound_f32_simt_ms), comparable with the earlier
# rows; the `kernels` line carries bound_ms alone.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
# the tensor cores' dense bf16 rate: the bf16 instances' products at it,
# beside their 3xTF32 bound (they widen bf16 to float32 and multiply as
# the float32 kernels do)
PEAK_BF16_FLOPS = 989e12

# Kernel vs plain version on the same inputs: float32 with TF32 off on
# both sides, summed in different orders (tiled online softmax vs a
# materialized softmax); observed differences are ~1e-6, so 1e-4 bounds
# them with room and still catches any indexing or masking fault (those
# give O(1) errors on N(0, 1) inputs).
KERNEL_TOL = 1e-4
# Engine stream vs lm_generate, and card vs CPU: the two paths round
# differently (chunked slab step vs prefill + decode step; kernel vs
# plain attention), moving logits by ~1e-5.  A token is compared only
# while the reference's top-1/top-2 logit margin exceeds this; past the
# first smaller margin the two may legitimately diverge.  Random weights
# give small margins, so the number of tokens compared is reported.
MARGIN_TOL = 2e-3

LAYERS, HEADS, VOCAB, D_MODEL, DFF = 6, 8, 32000, 512, 2048
SLOTS, SERVE_MAX_LEN, CHUNK = 8, 256, 8
GEN_BATCH, GEN_PROMPT, GEN_MAX_LEN = 32, 32, 160
# the paged layout: block size 16 (the JAX default); the kernels phase
# uses the slab-equivalent pool (8 rows x 16 blocks + scratch), the
# serve_paged phase a quarter of it, so that the pool runs dry
PAGE_BS = 16
PAGE_BLOCKS = SLOTS * SERVE_MAX_LEN // PAGE_BS + 1
PAGED_POOL = (PAGE_BLOCKS - 1) // 4 + 1
# The split-KV chunk kernels' long-span case: rows of chunk_qpos(2048),
# its longest crossing 2048 / 128 = 16 splits at dh 64 (at least
# SPLIT_MIN_SPLITS is checked), over a pool of 8 x 128 blocks + scratch
SPLIT_LONG_T = 2048
SPLIT_MIN_SPLITS = 16
# the split-KV kernels' rows also carry their device time alone (CUDA-graph
# replay) and scaled_dot_product_attention's, beside the wrapper-timed ms
DEVICE_KEYS = ("device_ms", "library_device_ms")
PREAMBLE = 64
LADDER_PROMPTS, LADDER_TOKENS = (5, 17, 32, 40, 64, 9, 50, 23), 24
# serve_w8: the card's quantize_lm against the CPU's on the same weights,
# bit for bit (amax / 127 and w / s are correctly rounded divisions on
# both devices), and its prefill logits against the CPU's plain prefill
# of the same int8 tree.  Both devices compute in float32 with TF32 off
# (the card's flash prefill in 3xTF32), so the logits agree to ~1e-6 (the
# float32 tree's difference is reported beside); 1e-3 bounds that with
# room, while five codes off by one (scales an ulp off: a division by a
# Python scalar on the card) moved a logit by 2.7e-3 there, and a wrong
# scale or dequantization moves them by far more
W8_CPU_TOL = 1e-3
# speculative serving: bench.py's bench_serving_speculative defaults
# (bench.py:2601-2604); the step's lane width max(CHUNK, SPEC_K + 1)
# stays CHUNK, the K the split kernels are checked at
SPEC_K, SPEC_DRAFT_LAYERS = 4, 2

# The LSTM kernels at the train path's shape (bench_lstm: T=100, B=64,
# h=512) against their plain versions on the same inputs, at the JAX
# tests' scale (x*0.3, W_r*0.1, checks*0.1).  Both sides are float32 but
# sum the recurrent products in different orders, and the differences
# ride the recurrence for 100 steps: 1e-4 absolute bounds hs, c_fin, cs,
# acts and dxs (O(0.1-1) values) with room and still catches an indexing
# or masking fault, which moves values by O(0.1).  dW_r and dchecks sum
# T*B = 6400 terms each, so they are held relative to max |ref|.
LSTM_T, LSTM_B, LSTM_D = 100, 64, 512
LSTM_TOL = 1e-4
LSTM_REL_TOL = 1e-4
# Every resident LSTM check is also held within LSTM_TC_TOL, the gate
# that tells 3xTF32 from one TF32 pass (hs, c_fin, cs, acts and dxs
# absolute, dW_r and dchecks relative to their largest entry): at the
# train shape one pass lands at 1.4e-3 (forward) and 3.6e-3 (dxs) from
# the plain versions, 3xTF32 under 7e-6 (scripts/probe_lstm.py, `tf32_1x`
# and `kernel`).  The tf32_1x variant, built from the source, must fail
# it at the train shape.
LSTM_TC_TOL = 1e-5
# The resident kernels across the (B, D) lstm.supported admits, each on a
# ragged mask with an empty row: D 128 and 256 at B 24 and odd T, D 384
# at B 64, D 640 at B 32 (the largest B there), and the largest B at
# D 128 (1448) and at D 512 (168), where a CTA walks several b-blocks.
LSTM_OTHER = ((37, 24, 128), (37, 24, 256), (20, 64, 384), (20, 32, 640),
              (5, 1448, 128), (9, 168, 512))
# The gate-blocked LSTM forward at the lstm1280 / lstm2048 train shape
# (T=100, B=64; timed at both D on full rows) and across the range
# lstm_blocked.supported admits: D 640 and odd T at B 64, B 256 with
# D 512, the largest D at B 8 (3456), and B 72 with D 2432, where the
# kernel halves its pass to fit shared memory, each on a ragged mask
# with an empty row, against its plain version within KERNEL_TOL.  W_r is drawn
# at the model's own init scale, std 1/sqrt(D) (text_lstm.init): at the
# JAX tests' 0.1 the recurrent gain 0.1 sqrt(D) is 3.6 at D=1280, and
# 100 steps of it amplify float32 rounding to O(0.1) between any two
# summation orders, two plain versions included (BLK_GAIN_PROBE shows it
# at D=1280: kernel vs plain beside plain on the card vs plain on the CPU).
BLK_T, BLK_B = 100, 64
# Every blocked check is also held within BLK_TC_TOL, the gate that tells
# 3xTF32 from one TF32 pass: at the train shapes one pass (a_big b_big)
# lands at 6e-5 to 8e-5 from the plain version, under KERNEL_TOL, and
# 3xTF32 at ~4e-7 (scripts/probe_lstm_blocked.py, `tf32_1x` and `kernel`).
BLK_TC_TOL = 1e-5
BLK_TIMED = (1280, 2048)
BLK_OTHER = ((100, 64, 640), (37, 64, 1280), (9, 256, 512), (15, 8, 3456),
             (5, 72, 2432))
BLK_GAIN_PROBE = 0.1
# Card (kernels) vs CPU (plain versions) on the first train step: the
# loss, every gradient leaf, and every param leaf and ``mom`` slot after
# the in-place Momentum update, each relative to the leaf's max |CPU
# value|.  The two run the same float32 arithmetic in different
# summation orders through 2 x 100 recurrent steps forward and back;
# 1e-3 leaves room for that drift while a wrong gradient or slot is off
# by O(1).  A param moves by about 1e-4 of itself in one step, too little
# for a param comparison to see a wrong update, so the card's params are
# also held to its own step, p0 + mom (mom starts at 0), relative to max
# |mom|: that catches a wrong sign, step size or a slot not applied.
TRAIN_REL_TOL = 1e-3
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
# The flash kernels at the MT train path's shape (bench_transformer: B 32,
# H 8, T 256, dh 64).  The backward's dq, dk and dv sum up to T terms of
# products of O(1) values; each is held relative to its largest magnitude
# (as the LSTM backward's sums are), 1e-4, which an indexing or masking
# fault exceeds by orders of magnitude.  The train phase's first step at
# batch 2 (card vs CPU) is held at TRAIN_REL_TOL, and Adam's update on
# the card to its own m/v slots.  Then MT_WARMUP + MT_STEPS steps at
# batch 32, each launching the flash forward, dK/dV and dQ kernels once
# per attention: 6 encoder self-, 6 decoder self- and 6 cross-attentions.
MT_BATCH, MT_SEQ, MT_HEADS, MT_DH = 32, 256, 8, 64
MT_REL_TOL = 1e-4
# The MT model's FFNs are ReLUs.  Card and CPU round their products
# differently, so at batch 2 a few of the 6.3 M FFN pre-activations lie
# close enough to 0 to fall on the other side of the kink: each such
# flip moves one token's whole contribution to its layer's w1/b1
# gradient and, through the residual stream, gradients upstream of it
# (the embedding rows of that token).  The first step therefore shows
# and takes out that cause before it holds the gradients:
#   - every FFN pre-activation on the card within MT_PRE_TOL of the
#     CPU's, relative to its layer's largest (1.6e-6 on an H100), so
#     each flip lies within that distance of 0; the flips are counted;
#   - every gradient leaf and m/v slot within TRAIN_REL_TOL of its
#     largest magnitude of a CPU witness step that keeps the card's
#     ReLU decisions (the same step with each FFN's mask given);
#   - against the plain CPU step, each gradient leaf and slot by its
#     relative L2 error at MT_GRAD_TOL, which the flips' share (1.3e-3
#     on an H100) stays well under.
# A TF32 control step on the card (matrix products at 10-bit mantissa)
# must fail these checks, or they could not tell it from float32.
MT_PRE_TOL = 2e-5
MT_GRAD_TOL = 4e-3
MT_WARMUP, MT_STEPS = 2, 10
MT_ATTENTIONS = 18
# train_remat: the MT step with every block recomputed in the backward
# (torch.utils.checkpoint, as JAX's jax.checkpoint): each attention's
# flash forward runs twice a step (the forward and the recompute), its
# dK/dV and dQ once; the first step's loss and gradients bit for bit
# those of the step without remat (the same kernels on the same inputs)
REMAT_FWD = 2 * MT_ATTENTIONS
# The packed and MoE LM train phases: bench.py's bench_transformer_packed
# and bench_transformer_moe at their defaults (B 16 x 512; the serving
# LM's widths, 6 layers; the MoE FFNs MOE_EXPERTS experts, top
# MOE_TOP_K).  JAX routes their segmented or key-masked attention to the
# dense path, so neither launches a flash kernel.  The first step is held
# as train_transformer's: the pre-activations within MT_PRE_TOL of the
# CPU's (their ReLU flips counted), then loss, every gradient leaf and
# Adam slot within TRAIN_REL_TOL of the largest entry of a CPU witness
# step on the same weights and batch that keeps the card's ReLU
# decisions and, for the mixture, its top-2 expert choices: a router
# probability near-tied with the next may rank the other way on the CPU,
# which moves a whole expert's share of that token.  The router's
# probabilities are held within MT_PRE_TOL, and each row whose choice
# flipped must be a tie on the CPU (its k-th and (k+1)-th probabilities
# within MOE_TIE_TOL).  The MoE check runs at MOE_CHECK_BATCH rows (every
# expert runs on every token, on the host's cores too), the timed steps
# at the defaults.
LM_WARMUP, LM_STEPS = 2, 10
MOE_EXPERTS, MOE_TOP_K = 8, 2
MOE_CHECK_BATCH = 4
MOE_TIE_TOL = 1e-5
# serve_moe: the MoE trunk's prefill logits on the card against a CPU
# witness that routes by the card's expert choices; float32 with TF32 off
# on both sides, so they agree to ~1e-6, and 1e-3 bounds that with room
# while a wrong expert, gate or product moves them by far more
MOE_CPU_TOL = 1e-3
# train_int8: the int8 trainer's and its float32 twin's timed steps
INT8_TRAIN_STEPS = 20
# The flash route at a head dim between the compiled ones (JAX's kernel
# takes any up to 128; the port's wrappers pad it to the next compiled
# width), held like the train shape's checks.
FLASH_PADDED_DH = 96
# check_head_dims' widths: the decode kernels at each (6, 8, 24 and 96
# padded inside the kernel, 6 loading one value at a time, 8 and 24 their
# int8 codes one at a time; 256, 384 and 512 compiled widths), the flash
# kernels up to 128
HEAD_DIMS_CHECKED = (6, 8, 16, 24, 32, 96, 128, 256, 384, 512)
# The flash kernels' wide instances (dh 256, 384, 512: the head dim split
# across a CTA's warps, 3xTF32 products) at a timed shape, B 4, H 2, T 512
# causal and full, each output within WIDE_TC_TOL of the plain version
# (the forward's o and lse absolute, dq / dk / dv relative to their
# largest entry), which a one-TF32-pass build (probe_flash.py's tf32_1x)
# must fail on the same inputs.  The 2-head ladder runs the LM at D 512
# with dh 256 through them and the Tq=1 kernels at that width.
WIDE_TC_TOL = 1e-5
WIDE_B, WIDE_H, WIDE_T = 4, 2, 512
WIDE_HEADS, WIDE_LAYERS = 2, 2
# The GRU kernels at the seq2seq train path's shape (bench_seq2seq's
# encoder: T=30, B=64, h=512) against their plain versions, held as the
# LSTM pair is (hs, acts and dxs within LSTM_TOL absolute, dW_gate and
# dW_state within LSTM_REL_TOL of their largest entry), and at the ends
# of the range gru.supported admits: D 128 and 640 at B 64, D 768 at B 8,
# and the largest B at D 128, 512 and 768 (2536, 392, 16: B % 16 = 8 at
# the first, half an m16 tile), where a CTA walks several b-blocks.
# The train phase's first step (card vs CPU) is held at TRAIN_REL_TOL:
# the model has no ReLU, so card and CPU differ only by summation order.
GRU_T, GRU_B, GRU_D = 30, 64, 512
GRU_OTHER = ((64, 128), (64, 640), (8, 768), (2536, 128), (392, 512),
             (16, 768))
# Every GRU check is also held within GRU_TC_TOL, the gate that tells
# 3xTF32 from one TF32 pass: hs and acts absolute (|h| < 1), dxs, dW_gate
# and dW_state relative to their largest entry (dxs grows along the
# reversed recurrence, as the simple RNN's does).  The tf32_1x variant of
# csrc/gru.cu (scripts/probe_gru.py), built from the source, must fail it
# at the train shape.  Two launches on the same inputs must give
# bit-identical hs, acts, dxs, dW_gate and dW_state: every sum runs in a
# fixed order.
GRU_TC_TOL = 1e-5
S2S_BATCH, S2S_LEN, S2S_VOCAB, S2S_HIDDEN = 64, 30, 30000, 512
S2S_WARMUP, S2S_STEPS = 3, 10
# greedy_generate card vs CPU on the trained params, beyond the tokens
# the margins let through: the encoder's outputs (enc, proj, boot) and
# the log-probs of every step teacher-forced on the CPU's tokens, each
# relative to its largest magnitude.  Same float32 arithmetic in other
# summation orders, through 30 encoder and 30 decoder steps without
# updates; a wrong kernel or step moves them by O(1e-2) and more.
S2S_REL_TOL = 1e-4
S2S_DIRECTIONS = 2
# The vanilla-RNN kernels at the DSL slice's train shape
# (models/text_rnn: T=100, B=64, h=512) against their plain versions on
# the same inputs, W at the layer's own init std 1/sqrt(D)
# (layers/recurrent.py, the recurrence's gain about 1) and x*0.3: hs and
# dxs within KERNEL_TOL absolute, dW within KERNEL_TOL of its largest
# entry (T*B = 6400 terms a sum).  Then at the ends of the range
# simple_rnn.supported admits (D 1152 at B 64, D 1280 at B 8, B 4736 at
# D 128) and at an odd T, each on a ragged mask with an empty row.
RNN_T, RNN_B, RNN_D = 100, 64, 512
RNN_OTHER = ((30, 64, 1152), (30, 8, 1280), (30, 4736, 128), (37, 64, 512))
# Every simple-RNN check is also held within RNN_TC_TOL, the gate that
# tells 3xTF32 from one TF32 pass: hs absolute (|h| < 1), dxs and dW
# relative to their largest entry.  dxs is held relative because it
# grows along the reversed recurrence (|dxs| reaches ~10 at the train
# shape's full rows and ~40 on a ragged mask, where 3xTF32's absolute
# error reaches ~1e-5 while its relative error stays under 1e-6).  At
# the train shape one pass lands at 1.2e-3 on hs and 4.5e-4 / 5.1e-4 on
# dxs / dW, 3xTF32 under 8e-7 (scripts/probe_simple_rnn.py, `tf32_1x`
# and `kernel`); the tf32_1x variant, built from the source, must fail
# it.  Two launches on the same inputs must give bit-identical hs, dxs
# and dW: every sum runs in a fixed order.
RNN_TC_TOL = 1e-5
# The train_rnn phase: the first step on the card against the CPU at
# TRAIN_REL_TOL, and its update must lower the cost of the batch it was
# taken on (SGD.test before and after).  With the reference's Momentum
# (lr 0.01, m 0.9) on random labels, a pass's losses wander and may
# climb after a few steps, on the CPU as on the card, so the pass over
# RNN_BATCHES batches is held to finite losses (reported) and 2 + 2
# launches of the simple-RNN kernels a step.  The CLI runs
# RNN_CLI_BATCHES batches.
RNN_BATCHES, RNN_CLI_BATCHES = 20, 3
# The model max-pools each hidden unit over 100 steps.  Card and CPU
# round the recurrence differently (kernel vs plain hs agree to ~1e-6),
# so a unit whose two largest steps lie closer than that may take the
# other argmax: one such flip among the 32,768 pooled units sends that
# unit's gradient down another step, which moves the weight gradients
# by percents of a leaf's largest entry (the phase reports it against
# the plain CPU step).  So, as the MT step does with its ReLU kinks, the
# first step records each max-pool's argmax on the card (pool_probe)
# and holds:
#   - the pooled values, card vs CPU, within RNN_TIE_TOL of the largest;
#   - every flipped unit's top-1/top-2 gap on the CPU within RNN_TIE_TOL
#     of the largest pooled value (a tie within rounding, not a fault:
#     a wrong kernel moves values by O(1e-2));
#   - loss, every gradient, param and momentum leaf within TRAIN_REL_TOL
#     of the largest entry of a CPU witness step that pools at the
#     card's argmax; the plain CPU step's errors are reported.
RNN_TIE_TOL = 1e-5
# The bf16 instances of the recurrent kernels against their plain
# versions on the same inputs (at the shapes of their float32 rows).  A
# float32 output is held at the 3xTF32 gate, BF16_F32_FLOOR of its
# largest entry.  A bf16 output element is held within one bf16 step
# (2^-7 of its power of two) of the plain version's, plus that floor:
# both round a float32 value once, and two float32 sums in other orders
# that straddle a rounding boundary land one step apart; where the value
# is near zero (a sum that cancels) the floor covers the float32 sums'
# own difference.  The share of elements that differ at all is printed.
BF16_F32_FLOOR = 1e-5
# The first bf16 step on the card against the plain CPU step from the
# same weights (JAX's arithmetic: float32 products of the bf16-rounded
# operands, the float32 cotangent in the backward's products), keeping
# the card's max-pool / ReLU decisions.  The card's products are
# aten::mm.dtype (bf16 operands, float32 accumulator); their backward
# (ops/linear._MmBf16) takes the cotangent as two bf16 terms, so what is
# left is float32 summation order and the bf16 roundings it flips, which
# compound through the layers.  Each limit lies between the sound step's
# reading and a control's: the same step on the card whose products
# round the float32 cotangent to bf16 (rounded_cotangent), a departure
# from JAX's arithmetic the gate must see; every run checks that the
# control fails its gate.  Readings (NVIDIA H100 80GB HBM3, 700 W; the
# largest leaf's relative L2 error, sound / control): the DSL steps'
# 0.50e-3-2.61e-3 / 5.95e-3-12.5e-3 (train_rnn's the closest pair,
# 2.61e-3 / 5.95e-3), held at BF16_GRAD_TOL.  The MT step's largest leaf
# reads 2.30e-2 / 2.43e-2: summation order alone moves its attention
# projections as far as the control does (on the CPU a float64-
# accumulated product moves them by up to 3.8e-2), so the MT step is held
# on the leaves' median, 3.16e-3 / 5.00e-3, at BF16_MT_GRAD_TOL, its
# largest leaf under BF16_MT_GRAD_MAX (a ceiling for gross faults, which
# the control passes too), and one product of the step at its shapes
# ([8192, 512] x [512, 2048]) on its own, where no layers compound:
# dx, dW 1.2e-4, 2.2e-4 / 2.56e-3 at BF16_MM_GRAD_TOL.  The loss is held
# at TRAIN_REL_TOL.
BF16_GRAD_TOL = 4e-3
BF16_MT_GRAD_TOL = 4e-3
BF16_MT_GRAD_MAX = 5e-2
BF16_MM_GRAD_TOL = 7e-4
# The ops API's recurrent calls with bf16 xs and float32 weights on the
# card against the same calls on the CPU: hs within one bf16 step (plus
# BF16_F32_FLOOR) of the CPU's, as an instance is held; each gradient
# within MIXED_GRAD_TOL relative L2 of the CPU's.  The backward reads each
# device's own hs, of which 0.02-0.07 % of elements round one bf16 step
# (2^-8) apart: ~1e-4 through the BPTT, the limit ten times that.
MIXED_GRAD_TOL = 1e-3
# text_rnn's cells under the policy (cell, hidden): the LSTM at 512
# takes the resident kernels, at 1280 the gate-blocked forward, the GRU
# at 512 its kernels; their first step on BF16_CHECK_BATCH rows.  Then
# each family fed by an embedding (bf16 xs): (cell, hidden) at a small
# vocabulary, the LSTM at 640 (B 64 fails the resident rule) for the
# blocked forward.
BF16_DSL = (("lstm", 512), ("lstm", 1280), ("gru", 512))
BF16_EMB_FED = (("rnn", 128), ("lstm", 128), ("gru", 128), ("lstm", 640))
BF16_EMB_VOCAB = 1000
BF16_CHECK_BATCH = 16
BF16_WARMUP, BF16_STEPS = 3, 20


# ms/batch of the float32 train phases, beside their bf16 twins
F32_MS = {}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def time_ms(torch, fn, samples=50, reps=10):
    """Median over ``samples`` of the mean device time of ``reps``
    back-to-back calls between two CUDA events, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def bound(nbytes, flops, peak=PEAK_F32_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tc_bound(row, nbytes, flops):
    """A 3xTF32 kernel's row: bound_ms / bound_by at the tensor-core
    peak, bound_f32_simt_ms at the float32 SIMT one, and library_ratio =
    ms / library_ms where both were timed."""
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops,
                                             PEAK_3XTF32_FLOPS)
    row["bound_f32_simt_ms"] = bound(nbytes, flops)[0]
    if row.get("library_ms"):
        row["library_ratio"] = row["ms"] / row["library_ms"]


# ------------------------------------------------------------- kernels

def chunk_qpos(t):
    """Per-lane positions [8, 8] mixing the row kinds the serving step
    sees: decode rows (one live lane), full 8-lane prompt chunks, a
    ragged chunk tail (clamped lanes repeat the last live position), a
    row ending at T-1 and a free row at 0."""
    rows = [[100] * 8,                                   # decode row
            list(range(0, 8)),                           # first chunk
            list(range(40, 48)),                         # full chunk
            [120, 121, 122, 123, 124, 124, 124, 124],    # ragged tail
            [t - 1] * 8,                                 # decode at T-1
            [0] * 8,                                     # free row at 0
            list(range(t - 8, t)),                       # chunk to T-1
            [17] * 8]                                    # decode row
    return np.asarray(rows, np.int32)


def check_decode_kernel(torch, dev, rng, hkv):
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    s, kk, t, d, h = 8, CHUNK, SERVE_MAX_LEN, D_MODEL, HEADS
    dkv = d // h * hkv
    q = torch.tensor(normal(rng, (s, kk, d)), device=dev)
    k = torch.tensor(normal(rng, (s, t, dkv)),
                     device=dev)
    v = torch.tensor(normal(rng, (s, t, dkv)),
                     device=dev)
    qpos_np = chunk_qpos(t)
    qpos = torch.tensor(qpos_np, device=dev)
    out = dk.decode_attention_slab_chunk(q, k, v, qpos, h)
    ref = dk.decode_attention_slab_chunk_plain(q, k, v, qpos, h)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    decode_rows = qpos_np[:, -1] == qpos_np[:, 0]
    zeros_ok = bool((out[torch.tensor(decode_rows, device=dev), 1:] == 0)
                    .all())
    if not err <= KERNEL_TOL or not zeros_ok:
        fail(f"decode_attention_slab_chunk (Hkv={hkv}) disagrees with its "
             f"plain version: max abs err {err} (bound {KERNEL_TOL}), "
             f"decode-row dead lanes exact zero: {zeros_ok}")
    row = {"name": dk.NAME, "hkv": hkv, "max_abs_err": err}
    if hkv != h:
        return row
    # this run's work: each row streams K and V up to its furthest lane;
    # a decode row reads q and computes for lane 0 only (its other lanes
    # are written as zeros), every other row all K lanes
    dh = d // h
    span = qpos_np[:, -1].astype(np.int64) + 1
    live = np.where(decode_rows[:, None], np.arange(kk)[None] == 0, True)
    nbytes = (4 * (s * kk * d + int(live.sum()) * d + s * kk)
              + 4 * 2 * int(span.sum()) * dkv)
    flops = 4 * dh * h * int(((qpos_np + 1) * live).sum())
    mask = (torch.arange(t, device=dev)[None, None, :]
            <= qpos.long()[:, :, None])[:, None]
    qh = q.reshape(s, kk, h, dh).transpose(1, 2).contiguous()
    kh = k.reshape(s, t, h, dh).transpose(1, 2).contiguous()
    vh = v.reshape(s, t, h, dh).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row.update(
        shape={"S": s, "K": kk, "T": t, "D": d, "H": h, "Hkv": hkv},
        ms=time_ms(torch, lambda: dk.decode_attention_slab_chunk(
            q, k, v, qpos, h)),
        plain_ms=time_ms(torch, lambda: dk.decode_attention_slab_chunk_plain(
            q, k, v, qpos, h)),
        library_ms=time_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=mask)),
        bytes=nbytes, flops=flops)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return row


def paged_tables(rng, last, nb_row, num_blocks):
    """Block tables [S, nb_row] int32 for rows whose furthest positions
    are ``last`` [S]: each row's blocks drawn from a shuffled pool (ids
    1..num_blocks-1), row 3 sharing row 0's leading blocks, the free row
    (row 5, at position 0) all on scratch block 0, and the entries past a
    row's last block pointing at blocks the row must never read."""
    ids = list(rng.permutation(np.arange(1, num_blocks)))
    tables = rng.randint(1, num_blocks, (len(last), nb_row)).astype(np.int32)
    need = last // PAGE_BS + 1
    for r in range(len(last)):
        tables[r, :need[r]] = [ids.pop() for _ in range(need[r])]
    share = min(need[0], need[3])
    tables[3, :share] = tables[0, :share]
    tables[5] = 0
    return tables


def check_paged_kernels(torch, dev, rng, hkv):
    """The paged chunk kernel at the paged serving step's shapes (8 rows
    of K = 8 lanes, chunk_qpos, over a 129-block pool of 16 positions,
    16 blocks per row; paged_tables), and the Tq=1 pair at each row's
    furthest position: decode_attention_slab over [8, 256] slab rows,
    decode_attention_paged over the same pool.  Each against its plain
    version; timed when Hkv = H.  The library yardstick is one masked
    scaled_dot_product_attention, over the gathered chain on the pool
    (the gather included)."""
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    s, kk, t, d, h = 8, CHUNK, SERVE_MAX_LEN, D_MODEL, HEADS
    dh, nb_row = d // h, t // PAGE_BS
    dkv = dh * hkv
    qpos_np = chunk_qpos(t)
    last = qpos_np[:, -1].astype(np.int64)
    tables_np = paged_tables(rng, last, nb_row, PAGE_BLOCKS)
    q = torch.tensor(normal(rng, (s, kk, d)), device=dev)
    q1 = torch.tensor(normal(rng, (s, d)), device=dev)
    pool_k, pool_v = (torch.tensor(normal(rng, (PAGE_BLOCKS, PAGE_BS, dkv)),
                                   device=dev) for _ in range(2))
    slab_k, slab_v = (torch.tensor(normal(rng, (s, t, dkv)), device=dev)
                      for _ in range(2))
    qpos = torch.tensor(qpos_np, device=dev)
    pos = torch.tensor(qpos_np[:, -1].copy(), device=dev)
    tables = torch.tensor(tables_np, device=dev)
    calls = {
        dk.NAME_PAGED_CHUNK: (
            lambda: dk.decode_attention_paged_chunk(q, pool_k, pool_v, qpos,
                                                    tables, h),
            lambda: dk.decode_attention_paged_chunk_plain(
                q, pool_k, pool_v, qpos, tables, h)),
        dk.NAME_SLAB: (
            lambda: dk.decode_attention_slab(q1, slab_k, slab_v, pos, h),
            lambda: dk.decode_attention_slab_plain(q1, slab_k, slab_v, pos,
                                                   h)),
        dk.NAME_PAGED: (
            lambda: dk.decode_attention_paged(q1, pool_k, pool_v, pos,
                                              tables, h),
            lambda: dk.decode_attention_paged_plain(q1, pool_k, pool_v, pos,
                                                    tables, h))}
    rows = {}
    decode_rows = qpos_np[:, -1] == qpos_np[:, 0]
    for name, (fn, plain) in calls.items():
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        zeros_ok = name != dk.NAME_PAGED_CHUNK or bool(
            (out[torch.tensor(decode_rows, device=dev), 1:] == 0).all())
        if not err <= KERNEL_TOL or not zeros_ok:
            fail(f"{name} (Hkv={hkv}) disagrees with its plain version: max "
                 f"abs err {err} (bound {KERNEL_TOL}), decode-row dead "
                 f"lanes exact zero: {zeros_ok}")
        rows[name] = {"name": name, "hkv": hkv, "max_abs_err": err}
    if hkv != h:
        return rows
    # this run's work.  Bytes: q for the lanes computed, out, positions
    # and table words, and each pool block some row's furthest lane
    # reaches, once (shared blocks are one input); the slab kernel reads
    # each row up to its position.  Operations: QK and PV per live lane
    # per column <= its position.
    live = np.where(decode_rows[:, None], np.arange(kk)[None] == 0, True)
    need = last // PAGE_BS + 1
    reached = {int(tables_np[r, j]) for r in range(s) for j in range(need[r])}
    pool_bytes = 4 * 2 * len(reached) * PAGE_BS * dkv
    tq1_flops = 4 * dh * h * int((last + 1).sum())
    costs = {
        dk.NAME_PAGED_CHUNK: (
            4 * (int(live.sum()) * d + s * kk * d + s * kk + int(need.sum()))
            + pool_bytes, 4 * dh * h * int(((qpos_np + 1) * live).sum())),
        dk.NAME_SLAB: (4 * (2 * s * d + s) + 4 * 2 * int((last + 1).sum())
                       * dkv, tq1_flops),
        dk.NAME_PAGED: (4 * (2 * s * d + s + int(need.sum())) + pool_bytes,
                        tq1_flops)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cols = torch.arange(t, device=dev)
    chunk_mask = (cols[None, None, :] <= qpos.long()[:, :, None])[:, None]
    tq1_mask = (cols[None, :] <= pos.long()[:, None])[:, None, None]
    qh = q.reshape(s, kk, h, dh).transpose(1, 2)
    q1h = q1.reshape(s, 1, h, dh).transpose(1, 2)

    def heads(rows_):           # [S, T, D] -> [S, H, T, dh]
        return rows_.reshape(s, t, h, dh).transpose(1, 2)

    def chain(pool):            # the gather the library call needs
        return heads(pool[tables.long()])

    library = {
        dk.NAME_PAGED_CHUNK: lambda: sdpa(qh, chain(pool_k), chain(pool_v),
                                          attn_mask=chunk_mask),
        dk.NAME_SLAB: lambda: sdpa(q1h, heads(slab_k), heads(slab_v),
                                   attn_mask=tq1_mask),
        dk.NAME_PAGED: lambda: sdpa(q1h, chain(pool_k), chain(pool_v),
                                    attn_mask=tq1_mask)}
    for name, (fn, plain) in calls.items():
        nbytes, flops = costs[name]
        row = rows[name]
        row.update(
            shape={"S": s, "K": 1 if name == dk.NAME_SLAB
                   or name == dk.NAME_PAGED else kk, "T": t, "D": d, "H": h,
                   "Hkv": hkv, "block_size": PAGE_BS,
                   "pool_blocks": PAGE_BLOCKS, "blocks_reached":
                   len(reached)},
            ms=time_ms(torch, fn), plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, library[name]), bytes=nbytes,
            flops=flops)
        if name != dk.NAME_SLAB:
            row["library_note"] = ("one masked scaled_dot_product_attention "
                                   "over each row's chain gathered from the "
                                   "pool, the gather included")
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    return rows


def graph_ms(torch, fn, calls=20, replays=30):
    """Median device ms a call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed, so that the host's launch path is out of
    the reading (as ab_kernels.py's ``graph:`` rows)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def check_split_kernels(torch, dev, rng, tq1=False, h=HEADS, hkv=HEADS):
    """The split-KV decode kernels (slab and paged, float32 and int8 K/V)
    at the main path's shape (S 8, T 256, D 512, H heads over Hkv KV
    heads; the paged over the 129-block pool): the chunked pair (K 8
    lanes a row at chunk_qpos) or, ``tq1``, the Tq=1 pair (one query a
    row at chunk_qpos' last positions).  Checks: within KERNEL_TOL of the
    plain version; a second launch equal to the first bit for bit; each
    row computed alone (S 1) and inside a T 2048 span (the slab's first
    256 columns, the table's first 16 entries) equal to the same row of
    the S 8 batch bit for bit; a long span (chunk_qpos(SPLIT_LONG_T)
    rows over T 2048, the paged over 8 x 128 blocks; its longest row
    crossing at least SPLIT_MIN_SPLITS splits) within KERNEL_TOL of the
    plain version; each int8 instance bit for bit its float32 kernel on
    the dequantized cache, at both spans.  At Hkv = H also each kernel's
    device time alone (graph_ms) beside one
    scaled_dot_product_attention over the same rows (the paged: over
    each row's chain gathered from the pool, the gather included; none
    for int8).  Returns {kernel: row}."""
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    s, d = 8, D_MODEL
    kk = 1 if tq1 else CHUNK
    dh, t, tl = d // h, SERVE_MAX_LEN, SPLIT_LONG_T
    dkv = dh * hkv
    qpos_np, long_np = chunk_qpos(t), chunk_qpos(tl)
    if tq1:
        qpos_np, long_np = qpos_np[:, -1:], long_np[:, -1:]
    q = torch.tensor(normal(rng, (s, kk, d)), device=dev)
    # the Tq=1 kernels take q [S, D] and positions [S]
    qpos, qlong = (torch.tensor(x[:, 0] if tq1 else x, device=dev)
                   for x in (qpos_np, long_np))
    if tq1:
        q = q[:, 0]
    # the slab rows at T 2048; the main path's T 256 are their first
    # columns (codes and scales alike)
    kl, vl = (torch.tensor(normal(rng, (s, tl, dkv)), device=dev)
              for _ in range(2))
    (kl8, ksl8), (vl8, vsl8) = (quantized(torch, dev, rng, (s, tl, dkv), hkv)
                                for _ in range(2))

    def head(x):
        return x[:, :t].contiguous()

    slab = {False: ((kl, vl, None, None), tuple(
                head(x) for x in (kl, vl)) + (None, None)),
            True: ((kl8, vl8, ksl8, vsl8), tuple(
                head(x) for x in (kl8, vl8, ksl8, vsl8)))}
    pool_shape = (PAGE_BLOCKS, PAGE_BS, dkv)
    pk, pv = (torch.tensor(normal(rng, pool_shape), device=dev)
              for _ in range(2))
    (p8, ps8), (w8, ws8) = (quantized(torch, dev, rng, pool_shape, hkv)
                            for _ in range(2))
    pool = {False: (pk, pv, None, None), True: (p8, w8, ps8, ws8)}
    tables_np = paged_tables(rng, qpos_np[:, -1].astype(np.int64),
                             t // PAGE_BS, PAGE_BLOCKS)
    tables = torch.tensor(tables_np, device=dev)
    # the same rows' tables at span 2048: entries past each row's
    # furthest block point at pool blocks the row must never read
    wide = torch.tensor(np.concatenate(
        [tables_np, rng.randint(1, PAGE_BLOCKS, (s, (tl - t) // PAGE_BS))],
        1).astype(np.int32), device=dev)
    long_blocks = s * (tl // PAGE_BS) + 1
    lpool_shape = (long_blocks, PAGE_BS, dkv)
    lk, lv = (torch.tensor(normal(rng, lpool_shape), device=dev)
              for _ in range(2))
    (lk8, lks8), (lv8, lvs8) = (quantized(torch, dev, rng, lpool_shape, hkv)
                                for _ in range(2))
    lpool = {False: (lk, lv, None, None), True: (lk8, lv8, lks8, lvs8)}
    ltables = torch.tensor(paged_tables(
        rng, long_np[:, -1].astype(np.int64), tl // PAGE_BS, long_blocks),
        device=dev)
    fns = {(False, False): (dk.decode_attention_slab_chunk,
                            dk.decode_attention_slab_chunk_plain),
           (True, False): (dk.decode_attention_paged_chunk,
                           dk.decode_attention_paged_chunk_plain),
           (False, True): (dk.decode_attention_slab,
                           dk.decode_attention_slab_plain),
           (True, True): (dk.decode_attention_paged,
                          dk.decode_attention_paged_plain)}

    def call(paged, kv, qp, tbl, rows=slice(None), widen=False, plain=False):
        """One kernel call (or its plain version) on ``rows``."""
        k, v, ks, vs = kv
        if ks is not None and widen:
            k, v, ks, vs = (dequantize_heads(k, ks), dequantize_heads(v, vs),
                            None, None)
        extra = {} if ks is None else dict(kscale=ks, vscale=vs)
        qp = qp[rows].clone()       # a fresh, 16-byte aligned buffer
        fn = fns[paged, tq1][plain]
        if paged:
            return fn(q[rows], k, v, qp, tbl[rows], h, **extra)
        return fn(q[rows], k[rows], v[rows], qp, h,
                  **{a: x[rows] for a, x in extra.items()})

    # splits of the longest long-span row: the scratch holds a record a
    # (row, query vector, KV head, split)
    nq = kk * (h // hkv)
    n_split = dk._count("decode_attention_chunk_scratch", s, kk, tl, h, hkv,
                        dh) // (s * nq * hkv * (dh + 4))
    if n_split < SPLIT_MIN_SPLITS:
        fail(f"the long-span case crosses {n_split} splits (want at least "
             f"{SPLIT_MIN_SPLITS})")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(t, device=dev)[None, None, :]
            <= qpos.long().reshape(s, kk)[:, :, None])[:, None]
    qh = q.reshape(s, kk, h, dh).transpose(1, 2)

    def heads(x):               # [S, T, Dkv] -> [S, H, T, dh]
        x = x.reshape(s, t, hkv, dh).transpose(1, 2)
        return x if hkv == h else torch.repeat_interleave(x, h // hkv, 1)

    library = {
        (False, False): lambda: sdpa(qh, heads(slab[False][1][0]),
                                     heads(slab[False][1][1]),
                                     attn_mask=mask),
        (True, False): lambda: sdpa(qh, heads(pk[tables.long()]),
                                    heads(pv[tables.long()]),
                                    attn_mask=mask)}
    names = {(False, False): (dk.NAME, dk.NAME_SLAB),
             (False, True): (dk.NAME_I8, dk.NAME_SLAB_I8),
             (True, False): (dk.NAME_PAGED_CHUNK, dk.NAME_PAGED),
             (True, True): (dk.NAME_PAGED_CHUNK_I8, dk.NAME_PAGED_I8)}
    rows = {}
    for paged, int8 in ((False, False), (False, True), (True, False),
                        (True, True)):
        name = names[paged, int8][tq1]
        main = pool[int8] if paged else slab[int8][1]
        big = pool[int8] if paged else slab[int8][0]
        tbl, tbl_wide = (tables, wide) if paged else (None, None)
        first, second = call(paged, main, qpos, tbl), call(paged, main, qpos,
                                                           tbl)
        ref = call(paged, main, qpos, tbl, plain=True)
        alone = [call(paged, main, qpos, tbl, slice(r, r + 1))
                 for r in range(s)]
        in_wide = call(paged, big, qpos, tbl_wide)
        lkv = lpool[int8] if paged else slab[int8][0]
        ltbl = ltables if paged else None
        long_out = call(paged, lkv, qlong, ltbl)
        long_ref = call(paged, lkv, qlong, ltbl, plain=True)
        f32 = (call(paged, main, qpos, tbl, widen=True),
               call(paged, lkv, qlong, ltbl, widen=True)) if int8 else None
        torch.cuda.synchronize()
        err = float((first - ref).abs().max())
        repeat = bool(torch.equal(first, second))
        row_alone = all(bool(torch.equal(a, first[r:r + 1]))
                        for r, a in enumerate(alone))
        row_wide = bool(torch.equal(in_wide, first))
        long_err = float((long_out - long_ref).abs().max())
        exact = (max(float((first - f32[0]).abs().max()),
                     float((long_out - f32[1]).abs().max()))
                 if int8 else None)
        if not (repeat and row_alone and row_wide) or not err <= KERNEL_TOL \
                or not long_err <= KERNEL_TOL or exact not in (None, 0.0):
            fail(f"{name} (H={h}, Hkv={hkv}, dh={dh}): max abs err {err}, "
                 f"long span {long_err} (bound {KERNEL_TOL}); second launch "
                 f"bit for bit {repeat}, rows alone (S 1) {row_alone}, rows "
                 f"inside a T {tl} span {row_wide}; against the float32 "
                 f"kernel on the dequantized cache {exact} (want 0)")
        row = {"name": name, "h": h, "hkv": hkv, "dh": dh,
               "max_abs_err": err, "repeat_bit_for_bit": repeat,
               "rows_alone_bit_for_bit": row_alone,
               f"rows_in_T{tl}_bit_for_bit": row_wide,
               "long_span": {"T": tl, "splits_longest_row": n_split,
                             "max_abs_err": long_err},
               "err_vs_f32_kernel_on_dequantized": exact}
        if hkv == h:
            row["device_ms"] = graph_ms(torch, lambda: call(paged, main, qpos,
                                                            tbl))
            lib = library.get((paged, int8))
            row["library_device_ms"] = graph_ms(torch, lib) if lib else None
        rows[name] = row
    return rows


def check_flash_kernel(torch, dev, rng, b, t, timed):
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    h, dh = HEADS, D_MODEL // HEADS
    q, k, v = (torch.tensor(normal(rng, (b, h, t, dh)),
                            device=dev) for _ in range(3))
    o, lse = fk.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max(float((o - o_ref).abs().max()),
              float((lse - lse_ref).abs().max()))
    if not err <= KERNEL_TOL:
        fail(f"flash_attention (B={b}, T={t}) disagrees with its plain "
             f"version: max abs err {err} (bound {KERNEL_TOL})")
    row = {"name": fk.NAME, "T": t, "max_abs_err": err}
    if not timed:
        return row
    nbytes = 4 * (4 * b * h * t * dh + b * h * t)
    flops = 4 * dh * b * h * (t * (t + 1) // 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row.update(
        shape={"B": b, "H": h, "T": t, "dh": dh, "causal": True},
        ms=time_ms(torch, lambda: fk.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(torch, lambda: fk.flash_attention_plain(
            q, k, v, causal=True)),
        library_ms=time_ms(torch, lambda: sdpa(q, k, v, is_causal=True)),
        bytes=nbytes, flops=flops)
    tc_bound(row, nbytes, flops)
    return row


def flash_bwd_cost(bh, tq, tk, dh, causal):
    """(bytes, flops) of the forward, the dK/dV and the dQ kernel: each
    input read once and each output written once (lse and delta [BH, Tq]
    besides the [BH, T, dh] operands; the dQ kernel reads q, do, o, k, v
    and lse and writes dq and delta, which dK/dV reads beside q, do, k,
    v and lse), and the products over the (q, k) pairs the mask leaves
    (a causal row t needs t + 1 columns): the forward 2 (s, p v), dK/dV
    4 (s, dp, dv, dk), dQ 3 (s, dp, dq), each 2 * dh FLOPs per pair."""
    pairs = bh * (tq * (tq + 1) // 2 if causal else tq * tk)
    q_side, k_side, row = bh * tq * dh, bh * tk * dh, bh * tq
    return {"fwd": (4 * (2 * q_side + 2 * k_side + row), 4 * dh * pairs),
            "dkv": (4 * (2 * q_side + 4 * k_side + 2 * row), 8 * dh * pairs),
            "dq": (4 * (4 * q_side + 2 * k_side + 2 * row), 6 * dh * pairs)}


def flash_bwd_pair(torch, dev, rng, b, h, tq, tk, dh, causal):
    """The backward pair against flash_attention_bwd_plain on one set of
    inputs (both given the plain forward's o and lse, so the check
    stands alone): each of dq, dk, dv relative to its largest magnitude;
    then a second run, which must equal the first bit for bit."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    q = torch.tensor(normal(rng, (b, h, tq, dh)), device=dev)
    k, v = (torch.tensor(normal(rng, (b, h, tk, dh)), device=dev)
            for _ in range(2))
    do = torch.tensor(normal(rng, (b, h, tq, dh)), device=dev)
    o, lse = fk.flash_attention_plain(q, k, v, causal=causal)
    got = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ref = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    rel = {n: float((g - r).abs().max() / r.abs().max())
           for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    where = (f"B={b}, H={h}, Tq={tq}, Tk={tk}, dh={dh}, "
             f"causal={causal}")
    if not max(rel.values()) <= MT_REL_TOL:
        fail(f"flash backward ({where}) disagrees with its plain version: "
             f"relative errors {rel} (bound {MT_REL_TOL})")
    if not same:
        fail(f"flash backward ({where}): two runs differ")
    return {"shape": where, "rel_err": rel, "bitwise_repeatable": same,
            "max_abs_err": max(float((g - r).abs().max())
                               for g, r in zip(got, ref))}, \
        (q, k, v, o, lse, do)


def check_flash_train(torch, dev, rng):
    """The flash kernels at the MT train path's shape: the forward
    non-causal and causal (max abs err, bound KERNEL_TOL), the backward
    pair causal and not, ragged (non-causal Tq 200 / Tk 136, causal T
    200) and at dh 16, 32 and 128 (each output relative to its largest
    magnitude, bound MT_REL_TOL, and bit for bit equal over two runs);
    timed at the train shape beside the plain versions, the bound and
    the library's scaled_dot_product_attention (its backward timed
    alone: autograd.grad over a retained graph)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    b, h, t, dh = MT_BATCH, MT_HEADS, MT_SEQ, MT_DH
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd_rows, checks, rows = {}, [], {}
    for causal in (False, True):
        q, k, v = (torch.tensor(normal(rng, (b, h, t, dh)), device=dev)
                   for _ in range(3))
        o, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max(float((o - o_ref).abs().max()),
                  float((lse - lse_ref).abs().max()))
        if not err <= KERNEL_TOL:
            fail(f"flash_attention (B={b}, T={t}, causal={causal}) disagrees "
                 f"with its plain version: max abs err {err} (bound "
                 f"{KERNEL_TOL})")
        cost = flash_bwd_cost(b * h, t, t, dh, causal)
        fwd = {"causal": causal, "max_abs_err": err,
               "ms": time_ms(torch, lambda: fk.flash_attention_fwd(
                   q, k, v, causal=causal), samples=20, reps=5),
               "plain_ms": time_ms(torch, lambda: fk.flash_attention_plain(
                   q, k, v, causal=causal), samples=10, reps=2),
               "library_ms": time_ms(torch, lambda: sdpa(
                   q, k, v, is_causal=causal), samples=20, reps=5),
               "bytes": cost["fwd"][0], "flops": cost["fwd"][1]}
        tc_bound(fwd, *cost["fwd"])
        fwd_rows[causal] = fwd

        row, (q, k, v, o, lse, do) = flash_bwd_pair(torch, dev, rng, b, h,
                                                    t, t, dh, causal)
        checks.append(row)
        scale = 1.0 / math.sqrt(dh)
        _, delta = fk.bwd_dq_kernel(q, k, v, o, lse, do, scale, causal)
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        lib_out = sdpa(qg, kg, vg, is_causal=causal)
        library = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), do, retain_graph=True), samples=20,
            reps=5)
        plain = time_ms(torch, lambda: fk.flash_attention_bwd_plain(
            q, k, v, o, lse, do, scale, causal), samples=10, reps=2)
        for name, fn in (
                (fk.NAME_BWD_DKV, lambda: fk.bwd_dkv_kernel(
                    q, k, v, do, lse, delta, scale, causal)),
                (fk.NAME_BWD_DQ, lambda: fk.bwd_dq_kernel(
                    q, k, v, o, lse, do, scale, causal))):
            key = "dkv" if name == fk.NAME_BWD_DKV else "dq"
            r = {"causal": causal, "ms": time_ms(torch, fn, samples=20,
                                                  reps=5),
                 "plain_ms": plain, "library_ms": library,
                 "bytes": cost[key][0], "flops": cost[key][1],
                 "rel_err": row["rel_err"],
                 "max_abs_err": row["max_abs_err"]}
            tc_bound(r, *cost[key])
            rows.setdefault(name, {})[causal] = r
    for bb, hh, tq, tk, d, causal in ((2, 2, 200, 136, MT_DH, False),
                                      (2, 2, 200, 200, MT_DH, True),
                                      *((1, 2, 77, 77, d, True)
                                        for d in (16, 32, 128)),
                                      *((1, 2, 45, 77, d, False)
                                        for d in (16, 32, 128))):
        checks.append(flash_bwd_pair(torch, dev, rng, bb, hh, tq, tk, d,
                                     causal)[0])
    return fwd_rows, rows, checks


def sdpa_backend(torch, q, k, v, causal):
    """The backend scaled_dot_product_attention picks for these inputs
    (its own dispatch rule, torch._fused_sdp_choice)."""
    names = {0: "MATH", 1: "FLASH_ATTENTION", 2: "EFFICIENT_ATTENTION",
             3: "CUDNN_ATTENTION", 4: "OVERRIDEABLE"}
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "not reported by this torch"
    pick = int(choose(q, k, v, None, 0.0, causal))
    return names.get(pick, str(pick))


def check_flash_wide(torch, dev, rng, control):
    """The flash forward, dK/dV and dQ kernels at the wide head dims
    (_check.WIDE_HEAD_DIMS) at B WIDE_B, H WIDE_H, T WIDE_T, causal and
    full: within WIDE_TC_TOL of the plain versions (the backward given
    the plain forward's o and lse), bit for bit on a second run, and the
    one-TF32-pass build ``control`` (probe_flash.py's tf32_1x library)
    outside it on the same inputs; each timed beside the plain versions,
    its bounds and one scaled_dot_product_attention call (forward, and
    its backward alone: autograd.grad over a retained graph), naming the
    backend SDPA picked.  Returns a list of rows."""
    from paddle_tpu_torch.ops.kernels import _build, _check
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.scripts import probe_flash
    one_fwd, one_dkv, one_dq, _ = probe_flash.entries(control)
    b, h, t = WIDE_B, WIDE_H, WIDE_T
    sdpa = torch.nn.functional.scaled_dot_product_attention
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for dh in _check.WIDE_HEAD_DIMS:
        for causal in (False, True):
            q, k, v, do = (torch.tensor(normal(rng, (b, h, t, dh)),
                                        device=dev) for _ in range(4))
            scale = 1.0 / math.sqrt(dh)
            o, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
            o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=causal)
            got = fk.flash_attention_bwd(q, k, v, o_ref, lse_ref, do,
                                         causal=causal)
            again = fk.flash_attention_bwd(q, k, v, o_ref, lse_ref, do,
                                           causal=causal)
            ref = fk.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                               scale, causal)
            # the one-pass control on the same inputs
            o1, lse1 = torch.empty_like(q), torch.empty_like(lse_ref)
            dq1, dk1, dv1 = (torch.empty_like(x) for x in (q, k, v))
            delta1 = torch.empty_like(lse_ref)
            _build.check("tf32_1x", one_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o1.data_ptr(),
                lse1.data_ptr(), b * h, t, t, dh, scale, int(causal),
                stream))
            _build.check("tf32_1x", one_dq(
                *(x.data_ptr() for x in (q, k, v, do, o_ref, lse_ref, delta1,
                                         dq1)),
                b * h, t, t, dh, scale, int(causal), stream))
            _build.check("tf32_1x", one_dkv(
                *(x.data_ptr() for x in (q, k, v, do, lse_ref, delta1, dk1,
                                         dv1)),
                b * h, t, t, dh, scale, int(causal), stream))
            torch.cuda.synchronize()

            def rel(x, r):
                return float((x - r).abs().max() / r.abs().max())

            err = {"fwd": max(float((o - o_ref).abs().max()),
                              float((lse - lse_ref).abs().max())),
                   "dq": rel(got[0], ref[0]),
                   "dkv": max(rel(got[1], ref[1]), rel(got[2], ref[2]))}
            one = {"fwd": max(float((o1 - o_ref).abs().max()),
                              float((lse1 - lse_ref).abs().max())),
                   "dq": rel(dq1, ref[0]),
                   "dkv": max(rel(dk1, ref[1]), rel(dv1, ref[2]))}
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            where = f"B={b}, H={h}, T={t}, dh={dh}, causal={causal}"
            if not max(err.values()) <= WIDE_TC_TOL or not same:
                fail(f"flash kernels ({where}) disagree with their plain "
                     f"versions: {err} (bound {WIDE_TC_TOL}); the backward "
                     f"bit for bit on a second run: {same}")
            if not min(one.values()) > WIDE_TC_TOL:
                fail(f"flash kernels ({where}): the one-TF32-pass control "
                     f"{one} passes the {WIDE_TC_TOL} gate")
            _, delta = fk.bwd_dq_kernel(q, k, v, o_ref, lse_ref, do, scale,
                                        causal)
            qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
            lib_out = sdpa(qg, kg, vg, is_causal=causal)
            cost = flash_bwd_cost(b * h, t, t, dh, causal)
            plain_bwd = time_ms(torch, lambda: fk.flash_attention_bwd_plain(
                q, k, v, o_ref, lse_ref, do, scale, causal), samples=10,
                reps=2)
            lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), do, retain_graph=True), samples=20,
                reps=5)
            row = {"dh": dh, "causal": causal,
                   "shape": {"B": b, "H": h, "T": t},
                   "sdpa_backend": sdpa_backend(torch, q, k, v, causal),
                   "bitwise_repeatable": same, "one_tf32_pass_err": one}
            for key, fn, plain, lib in (
                    ("fwd", lambda: fk.flash_attention_fwd(
                        q, k, v, causal=causal),
                     time_ms(torch, lambda: fk.flash_attention_plain(
                         q, k, v, causal=causal), samples=10, reps=2),
                     time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal),
                             samples=20, reps=5)),
                    ("dkv", lambda: fk.bwd_dkv_kernel(
                        q, k, v, do, lse_ref, delta, scale, causal),
                     plain_bwd, lib_bwd),
                    ("dq", lambda: fk.bwd_dq_kernel(
                        q, k, v, o_ref, lse_ref, do, scale, causal),
                     plain_bwd, lib_bwd)):
                r = {"max_err": err[key],
                     "ms": time_ms(torch, fn, samples=20, reps=5),
                     "plain_ms": plain, "library_ms": lib,
                     "bytes": cost[key][0], "flops": cost[key][1]}
                tc_bound(r, *cost[key])
                row[key] = r
            rows.append(row)
    return rows


def check_flash_padded(torch, dev, rng, kernels):
    """The flash route at a head dim between the compiled ones (dh
    FLASH_PADDED_DH, which the wrappers zero-pad to 128): the forward
    (max abs err of o and lse, bound KERNEL_TOL) and the backward pair
    (each output relative to its largest magnitude, bound MT_REL_TOL,
    and bit for bit over two runs) against the plain versions computed
    at the true dh, causal at the MT train shape's T 256 (B 2) and
    non-causal Tq 200 / Tk 136; then dot_product_attention's flash route
    forward and backward at B 2, H 8, T 256, causal, which must launch
    the forward, dQ and dK/dV kernels once each, its gradients held
    against autograd of the plain forward at MT_REL_TOL."""
    from paddle_tpu_torch.ops import attention as attn_ops
    fk = kernels.flash_attention
    dh, b, h, t = FLASH_PADDED_DH, 2, MT_HEADS, MT_SEQ
    fwd = {}
    for causal, tq, tk in ((True, t, t), (False, 200, 136)):
        q = torch.tensor(normal(rng, (b, h, tq, dh)), device=dev)
        k, v = (torch.tensor(normal(rng, (b, h, tk, dh)), device=dev)
                for _ in range(2))
        o, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        fwd[f"causal{int(causal)}"] = max(
            float((o - o_ref).abs().max()),
            float((lse - lse_ref).abs().max()))
    bad = {key: e for key, e in fwd.items() if not e <= KERNEL_TOL}
    if bad:
        fail(f"flash_attention at dh {dh} disagrees with its plain version:"
             f" {bad} (bound {KERNEL_TOL})")
    pairs = [flash_bwd_pair(torch, dev, rng, b, h, tq, tk, dh, causal)[0]
             for causal, tq, tk in ((True, t, t), (False, 200, 136))]
    q, k, v, do = (torch.tensor(normal(rng, (b, h, t, dh)), device=dev)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kernels.reset_launches()
    out = attn_ops.dot_product_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    launched = {fk.NAME: fk.launches, fk.NAME_BWD_DQ: fk.launches_bwd_dq,
                fk.NAME_BWD_DKV: fk.launches_bwd_dkv}
    if launched != dict.fromkeys(launched, 1):
        fail(f"dot_product_attention at dh {dh}: launches {launched}, "
             "want one of each flash kernel")
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = fk.flash_attention_plain(*ref_leaves, causal=True)[0]
    ref_grads = torch.autograd.grad(ref, ref_leaves, do)
    rel = {n: float((x.grad - r).abs().max() / r.abs().max())
           for n, x, r in zip(("dq", "dk", "dv"), leaves, ref_grads)}
    rel["o"] = float((out - ref).detach().abs().max()
                     / ref.detach().abs().max())
    if not max(rel.values()) <= MT_REL_TOL:
        fail(f"dot_product_attention at dh {dh} disagrees with autograd of "
             f"the plain forward: {rel} (bound {MT_REL_TOL})")
    return {"phase": "flash_dh96", "dh": dh, "padded_to":
            fk.padded_head_dim(dh), "forward_max_abs_err": fwd,
            "backward_checks": pairs, "route": {
                "shape": {"B": b, "H": h, "T": t, "causal": True},
                "launches": launched, "rel_err_vs_autograd_of_plain": rel}}


def quantized(torch, dev, rng, shape, hkv):
    """(codes int8, scales f32) of a seeded N(0, 1) K/V on the card, as
    the int8 cache holds them."""
    from paddle_tpu_torch.quant import kv as kvq
    return kvq.quantize_heads(torch.tensor(normal(rng, shape), device=dev),
                              hkv)


I8_LIBRARY_NOTE = ("no single PyTorch call attends over int8 codes with "
                   "per-(position, head) scales")


def check_int8_decode_kernels(torch, dev, rng, hkv):
    """The four int8 instances at the main path's shapes (the slab chunk
    kernel at row 1's, the paged pair and the Tq=1 slab kernel at rows
    3-5's: chunk_qpos over [8, 256] slab rows and over the 129-block pool
    of 16-position blocks with shuffled ids, shared leading blocks and a
    free row on block 0).  Each is held bit for bit against its float32
    kernel run on dequantize_heads(cache), and within KERNEL_TOL against
    its plain version; timed beside the float32 kernel when Hkv = H."""
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    s, kk, t, d, h = 8, CHUNK, SERVE_MAX_LEN, D_MODEL, HEADS
    dh, nb_row = d // h, t // PAGE_BS
    dkv = dh * hkv
    qpos_np = chunk_qpos(t)
    last = qpos_np[:, -1].astype(np.int64)
    tables_np = paged_tables(rng, last, nb_row, PAGE_BLOCKS)
    q = torch.tensor(normal(rng, (s, kk, d)), device=dev)
    q1 = torch.tensor(normal(rng, (s, d)), device=dev)
    (sk, sks), (sv, svs) = (quantized(torch, dev, rng, (s, t, dkv), hkv)
                            for _ in range(2))
    (pk, pks), (pv, pvs) = (quantized(torch, dev, rng,
                                      (PAGE_BLOCKS, PAGE_BS, dkv), hkv)
                            for _ in range(2))
    slab = dict(kscale=sks, vscale=svs)
    pool = dict(kscale=pks, vscale=pvs)
    sk_w, sv_w = dequantize_heads(sk, sks), dequantize_heads(sv, svs)
    pk_w, pv_w = dequantize_heads(pk, pks), dequantize_heads(pv, pvs)
    qpos = torch.tensor(qpos_np, device=dev)
    pos = torch.tensor(qpos_np[:, -1].copy(), device=dev)
    tables = torch.tensor(tables_np, device=dev)
    # name -> (int8 kernel, float32 kernel on the dequantized cache, plain)
    calls = {
        dk.NAME_I8: (
            lambda: dk.decode_attention_slab_chunk(q, sk, sv, qpos, h, **slab),
            lambda: dk.decode_attention_slab_chunk(q, sk_w, sv_w, qpos, h),
            lambda: dk.decode_attention_slab_chunk_plain(q, sk, sv, qpos, h,
                                                         **slab)),
        dk.NAME_SLAB_I8: (
            lambda: dk.decode_attention_slab(q1, sk, sv, pos, h, **slab),
            lambda: dk.decode_attention_slab(q1, sk_w, sv_w, pos, h),
            lambda: dk.decode_attention_slab_plain(q1, sk, sv, pos, h,
                                                   **slab)),
        dk.NAME_PAGED_I8: (
            lambda: dk.decode_attention_paged(q1, pk, pv, pos, tables, h,
                                              **pool),
            lambda: dk.decode_attention_paged(q1, pk_w, pv_w, pos, tables,
                                              h),
            lambda: dk.decode_attention_paged_plain(q1, pk, pv, pos, tables,
                                                    h, **pool)),
        dk.NAME_PAGED_CHUNK_I8: (
            lambda: dk.decode_attention_paged_chunk(q, pk, pv, qpos, tables,
                                                    h, **pool),
            lambda: dk.decode_attention_paged_chunk(q, pk_w, pv_w, qpos,
                                                    tables, h),
            lambda: dk.decode_attention_paged_chunk_plain(
                q, pk, pv, qpos, tables, h, **pool))}
    rows = {}
    for name, (fn, f32, plain) in calls.items():
        out, twin, ref = fn(), f32(), plain()
        torch.cuda.synchronize()
        exact = float((out - twin).abs().max())
        err = float((out - ref).abs().max())
        if exact != 0.0 or not err <= KERNEL_TOL:
            fail(f"{name} (Hkv={hkv}): max abs err {exact} against the "
                 f"float32 kernel on the dequantized cache (want 0), {err} "
                 f"against its plain version (bound {KERNEL_TOL})")
        rows[name] = {"name": name, "hkv": hkv, "max_abs_err": err,
                      "err_vs_f32_kernel_on_dequantized": exact}
    if hkv != h:
        return rows
    # this run's work, as the float32 rows count it, with each K/V value
    # one byte and each (position, KV head) two f32 scales beside it
    decode_rows = qpos_np[:, -1] == qpos_np[:, 0]
    live = np.where(decode_rows[:, None], np.arange(kk)[None] == 0, True)
    need = last // PAGE_BS + 1
    reached = {int(tables_np[r, j]) for r in range(s) for j in range(need[r])}
    per_pos = 2 * dkv + 2 * 4 * hkv
    pool_bytes = per_pos * len(reached) * PAGE_BS
    tq1_flops = 4 * dh * h * int((last + 1).sum())
    chunk_flops = 4 * dh * h * int(((qpos_np + 1) * live).sum())
    span = int((last + 1).sum())
    costs = {
        dk.NAME_I8: (4 * (s * kk * d + int(live.sum()) * d + s * kk)
                     + per_pos * span, chunk_flops),
        dk.NAME_SLAB_I8: (4 * (2 * s * d + s) + per_pos * span, tq1_flops),
        dk.NAME_PAGED_I8: (4 * (2 * s * d + s + int(need.sum()))
                           + pool_bytes, tq1_flops),
        dk.NAME_PAGED_CHUNK_I8: (
            4 * (int(live.sum()) * d + s * kk * d + s * kk + int(need.sum()))
            + pool_bytes, chunk_flops)}
    for name, (fn, f32, plain) in calls.items():
        nbytes, flops = costs[name]
        rows[name].update(
            shape={"S": s, "K": kk if name in (dk.NAME_I8,
                                               dk.NAME_PAGED_CHUNK_I8) else 1,
                   "T": t, "D": d, "H": h, "Hkv": hkv,
                   "block_size": PAGE_BS, "pool_blocks": PAGE_BLOCKS,
                   "blocks_reached": len(reached)},
            ms=time_ms(torch, fn), f32_kernel_ms=time_ms(torch, f32),
            plain_ms=time_ms(torch, plain), library_ms=None,
            library_note=I8_LIBRARY_NOTE, bytes=nbytes, flops=flops)
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(nbytes, flops)
    return rows


def check_flash_quant_kernel(torch, dev, rng, b, t, hkv, timed, h=HEADS,
                             dh=D_MODEL // HEADS):
    """flash_attention_quant on q [B, T, H * dh] and an int8 cache
    [B, T, Hkv * dh]: bit for bit against the float32 flash kernel on the
    dequantized, head-repeated K/V, within KERNEL_TOL of its plain
    version."""
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    q = torch.tensor(normal(rng, (b, t, h * dh)), device=dev)
    (k, ks), (v, vs) = (quantized(torch, dev, rng, (b, t, hkv * dh), hkv)
                        for _ in range(2))

    def heads(x, n):
        return x.reshape(b, t, n, dh).transpose(1, 2)

    qh = heads(q, h).contiguous()
    kw = attn_ops.repeat_kv_heads(heads(dequantize_heads(k, ks), hkv),
                                  h).contiguous()
    vw = attn_ops.repeat_kv_heads(heads(dequantize_heads(v, vs), hkv),
                                  h).contiguous()

    def run():
        return fk.flash_attention_quant(q, k, v, ks, vs, h, causal=True)

    def f32():
        return fk.flash_attention(qh, kw, vw, causal=True)

    def plain():
        return fk.flash_attention_quant_plain(q, k, v, ks, vs, h, causal=True)

    out, twin, ref = run(), f32(), plain()
    torch.cuda.synchronize()
    exact = float((out - twin).abs().max())
    err = float((out - ref).abs().max())
    if exact != 0.0 or not err <= KERNEL_TOL:
        fail(f"flash_attention_quant (B={b}, T={t}, Hkv={hkv}): max abs err "
             f"{exact} against the float32 kernel on the dequantized K/V "
             f"(want 0), {err} against its plain version (bound "
             f"{KERNEL_TOL})")
    row = {"name": fk.NAME_QUANT, "T": t, "hkv": hkv, "dh": dh,
           "max_abs_err": err, "err_vs_f32_kernel_on_dequantized": exact}
    if not timed:
        return row
    nbytes = (4 * b * t * h * dh + b * t * (2 * hkv * dh + 2 * 4 * hkv)
              + 4 * b * h * t * dh)
    flops = 4 * dh * b * h * (t * (t + 1) // 2)
    row.update(
        shape={"B": b, "H": h, "Hkv": hkv, "T": t, "dh": dh, "causal": True},
        ms=time_ms(torch, run), f32_kernel_ms=time_ms(torch, f32),
        plain_ms=time_ms(torch, plain), library_ms=None,
        library_note=I8_LIBRARY_NOTE, bytes=nbytes, flops=flops)
    tc_bound(row, nbytes, flops)
    return row


def check_head_dims(torch, dev, rng):
    """Every kernel of the attention family at other head dims it takes,
    on small ragged shapes: the decode kernels at HEAD_DIMS_CHECKED (6, 8,
    24 and 96 padded to a compiled width inside the kernel; 6 loads its
    values, 8 and 24 their int8 codes, one at a time) -- GQA, K = 5 lanes over T = 77 for the
    slab chunk kernel, the same rows over a shuffled pool of 8-position
    blocks for the paged chunk kernel, lane 0 of each row for the Tq=1
    pair (at GQA and at H = Hkv), and the int8 instance of each of the
    four on the same rows;
    causal T = 45 and non-causal Tq = 19, Tk = 45 for the flash forward
    and its backward pair (each output relative to its largest entry,
    bound MT_REL_TOL, and bit for bit on a second run), and
    flash_attention_quant at causal T = 45, Hkv = 2 (widths between the
    compiled ones zero-padded by the wrappers; 256, 384 and 512 the wide
    instances)."""
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.quant.kv import dequantize_heads
    errs, exacts, bwd_rel = {}, {}, {}

    def err(name, dh, got, want):
        errs[f"{name}/dh{dh}"] = float((got - want).abs().max())

    def exact(name, dh, got, want):
        exacts[f"{name}/dh{dh}"] = float((got - want).abs().max())

    for dh in HEAD_DIMS_CHECKED:
        h, hkv, kk, t, bs = 4, 2, 5, 77, 8
        q = torch.tensor(normal(rng, (3, kk, h * dh)), device=dev)
        k = torch.tensor(normal(rng, (3, t, hkv * dh)), device=dev)
        v = torch.tensor(normal(rng, (3, t, hkv * dh)), device=dev)
        live = np.asarray([1, 5, 3])
        start = np.asarray([40, 0, t - 3])
        qpos = torch.tensor(start[:, None] + np.minimum(
            np.arange(kk)[None], live[:, None] - 1), dtype=torch.int32,
            device=dev)
        err(dk.NAME, dh, dk.decode_attention_slab_chunk(q, k, v, qpos, h),
            dk.decode_attention_slab_chunk_plain(q, k, v, qpos, h))
        nb_row = -(-t // bs)
        tables = torch.tensor(rng.permutation(np.arange(1, 3 * nb_row + 1))
                              .reshape(3, nb_row), dtype=torch.int32,
                              device=dev)
        tables[2, :4] = tables[1, :4]               # shared leading blocks
        pk, pv = (torch.tensor(normal(rng, (3 * nb_row + 1, bs, hkv * dh)),
                               device=dev) for _ in range(2))
        err(dk.NAME_PAGED_CHUNK, dh,
            dk.decode_attention_paged_chunk(q, pk, pv, qpos, tables, h),
            dk.decode_attention_paged_chunk_plain(q, pk, pv, qpos, tables, h))
        q1, pos = q[:, 0].contiguous(), qpos[:, 0].contiguous()
        err(dk.NAME_PAGED, dh,
            dk.decode_attention_paged(q1, pk, pv, pos, tables, h),
            dk.decode_attention_paged_plain(q1, pk, pv, pos, tables, h))
        err(dk.NAME_SLAB, dh, dk.decode_attention_slab(q1, k, v, pos, h),
            dk.decode_attention_slab_plain(q1, k, v, pos, h))
        # the int8 instances: bit for bit against the float32 kernels on
        # the dequantized cache
        (k8, k8s), (v8, v8s) = (quantized(torch, dev, rng, k.shape, hkv)
                                for _ in range(2))
        (p8, p8s), (w8, w8s) = (quantized(torch, dev, rng, pk.shape, hkv)
                                for _ in range(2))
        slab, pool = dict(kscale=k8s, vscale=v8s), dict(kscale=p8s,
                                                       vscale=w8s)
        kw, vw = dequantize_heads(k8, k8s), dequantize_heads(v8, v8s)
        pw, ww = dequantize_heads(p8, p8s), dequantize_heads(w8, w8s)
        exact(dk.NAME_I8, dh,
              dk.decode_attention_slab_chunk(q, k8, v8, qpos, h, **slab),
              dk.decode_attention_slab_chunk(q, kw, vw, qpos, h))
        exact(dk.NAME_PAGED_CHUNK_I8, dh,
              dk.decode_attention_paged_chunk(q, p8, w8, qpos, tables, h,
                                              **pool),
              dk.decode_attention_paged_chunk(q, pw, ww, qpos, tables, h))
        exact(dk.NAME_PAGED_I8, dh,
              dk.decode_attention_paged(q1, p8, w8, pos, tables, h, **pool),
              dk.decode_attention_paged(q1, pw, ww, pos, tables, h))
        exact(dk.NAME_SLAB_I8, dh,
              dk.decode_attention_slab(q1, k8, v8, pos, h, **slab),
              dk.decode_attention_slab(q1, kw, vw, pos, h))
        # the Tq=1 pair at H = Hkv = 2 (one query vector a CTA, the
        # instance the grouped heads above do not launch), float32
        # against the plain versions, int8 against the float32 kernels
        qm = torch.tensor(normal(rng, (3, 2 * dh)), device=dev)
        for paged in (False, True):
            shape = (3 * nb_row + 1, bs, 2 * dh) if paged else (3, t, 2 * dh)
            km, vm = (torch.tensor(normal(rng, shape), device=dev)
                      for _ in range(2))
            (k8, k8s), (v8, v8s) = (quantized(torch, dev, rng, shape, 2)
                                    for _ in range(2))
            kw, vw = dequantize_heads(k8, k8s), dequantize_heads(v8, v8s)
            tbl = (tables,) if paged else ()
            fn, plain, name, name8 = (
                (dk.decode_attention_paged, dk.decode_attention_paged_plain,
                 dk.NAME_PAGED, dk.NAME_PAGED_I8) if paged else
                (dk.decode_attention_slab, dk.decode_attention_slab_plain,
                 dk.NAME_SLAB, dk.NAME_SLAB_I8))
            err(f"{name}/mha", dh, fn(qm, km, vm, pos, *tbl, 2),
                plain(qm, km, vm, pos, *tbl, 2))
            exact(f"{name8}/mha", dh,
                  fn(qm, k8, v8, pos, *tbl, 2, kscale=k8s, vscale=v8s),
                  fn(qm, kw, vw, pos, *tbl, 2))
        for causal, tq in ((True, 45), (False, 19)):
            q = torch.tensor(normal(rng, (1, 2, tq, dh)), device=dev)
            k = torch.tensor(normal(rng, (1, 2, 45, dh)), device=dev)
            v = torch.tensor(normal(rng, (1, 2, 45, dh)), device=dev)
            o, lse = fk.flash_attention_fwd(q, k, v, causal=causal)
            o_ref, lse_ref = fk.flash_attention_plain(q, k, v, causal=causal)
            errs[f"flash_attention/dh{dh}/causal{int(causal)}"] = max(
                float((o - o_ref).abs().max()),
                float((lse - lse_ref).abs().max()))
            bwd_rel[f"dh{dh}/causal{int(causal)}"] = flash_bwd_pair(
                torch, dev, rng, 1, 2, tq, 45, dh, causal)[0]["rel_err"]
        # flash_attention_quant, ragged T = 45 with GQA: bit for bit
        # against the float32 kernel on the dequantized, repeated heads
        qf = torch.tensor(normal(rng, (2, 45, h * dh)), device=dev)
        (kq, kqs), (vq, vqs) = (quantized(torch, dev, rng,
                                          (2, 45, hkv * dh), hkv)
                                for _ in range(2))

        def heads(x, n):
            return x.reshape(2, 45, n, dh).transpose(1, 2)

        exact(fk.NAME_QUANT, dh,
              fk.flash_attention_quant(qf, kq, vq, kqs, vqs, h),
              fk.flash_attention(
                  heads(qf, h).contiguous(),
                  attn_ops.repeat_kv_heads(
                      heads(dequantize_heads(kq, kqs), hkv), h).contiguous(),
                  attn_ops.repeat_kv_heads(
                      heads(dequantize_heads(vq, vqs), hkv), h).contiguous(),
                  causal=True))
        err(fk.NAME_QUANT, dh,
            fk.flash_attention_quant(qf, kq, vq, kqs, vqs, h),
            fk.flash_attention_quant_plain(qf, kq, vq, kqs, vqs, h))
    torch.cuda.synchronize()
    bad = {k: e for k, e in errs.items() if not e <= KERNEL_TOL}
    bad.update({k: e for k, e in exacts.items() if e != 0.0})
    if bad:
        fail(f"kernels disagree with their plain versions (bound "
             f"{KERNEL_TOL}) or, int8, with their float32 kernels on the "
             f"dequantized cache (want 0): {bad}")
    return {"vs_plain": errs, "int8_vs_f32_kernel": exacts,
            "flash_backward_rel_err": bwd_rel}


def lstm_inputs(torch, dev, rng, t, b, d, ragged, w_scale=0.1):
    """(lengths, xs [T, B, 4D], mask [T, B], w_r, checks) at the JAX
    tests' scale (W_r at ``w_scale``).  Ragged: random lengths with one
    empty row and one full row; else every row full, as the train path's
    batch is."""
    lengths = np.full(b, t)
    if ragged:
        lengths = rng.randint(1, t + 1, b)
        lengths[0] = 0
        lengths[-1] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (lengths,
            torch.tensor(normal(rng, (t, b, 4 * d)) * 0.3, device=dev),
            torch.tensor(mask, device=dev),
            torch.tensor(normal(rng, (d, 4 * d)) * w_scale, device=dev),
            torch.tensor(normal(rng, (3, d)) * 0.1, device=dev))


def lstm_cost(lengths, t, d):
    """(bytes, flops) of the forward with residuals and of the backward
    with dW_r on these inputs.  Bytes: each input read once, each output
    written once.  Operations: the recurrent products these lengths
    need.  The forward needs h_{t-1} @ W_r at every step t >= 1 of a row
    that ever started (acts are outputs even where the mask is 0; an
    empty row's h stays 0); the backward needs dgates_t @ W_r^T and
    h_{t-1}^T dgates_t only where the mask is 1 and t >= 1 (elsewhere
    dgates_t is 0).  The cell's ~30 elementwise operations per unit and
    step are under 1 % of it."""
    b, g = len(lengths), 4 * d
    fwd_bytes = 4 * (2 * t * b * g + d * g + 3 * d + t * b + 2 * t * b * d
                     + b * d)
    bwd_bytes = 4 * (2 * t * b * g + 3 * t * b * d + 2 * d * g + 3 * d
                     + t * b + b * d + 3 * b * d)
    fwd_rows = (t - 1) * int((lengths > 0).sum())
    bwd_rows = int(np.maximum(lengths - 1, 0).sum())
    return ((fwd_bytes, 2 * fwd_rows * d * g),
            (bwd_bytes, 2 * 2 * bwd_rows * d * g))


def lstm_pair(torch, dev, rng, t, b, d, ragged):
    """Forward (both variants) and backward kernels against their plain
    versions on one set of inputs; the backward gets the plain forward's
    residuals on both sides so that its check stands alone.  Returns the
    two result rows, the four calls (kernel, plain) x (fwd, bwd) and the
    call of the dW_r product alone."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import lstm as lk
    lengths, xs, mask, w_r, checks = lstm_inputs(torch, dev, rng, t, b, d,
                                                 ragged)
    ref = lk.lstm_fwd_plain(xs, mask, w_r, checks, True)
    got = lk.lstm_fwd(xs, mask, w_r, checks, True)
    lean = lk.lstm_fwd(xs, mask, w_r, checks, False)
    dh_out = torch.tensor(normal(rng, (t, b, d)), device=dev)
    dcfin = torch.tensor(normal(rng, (b, d)), device=dev)
    _, _, cs, acts = ref
    bwd_args = (acts, cs, ref[0], w_r, checks, mask, dh_out, dcfin)
    gb = lk.lstm_bwd(*bwd_args)
    rb = lk.lstm_bwd_plain(*bwd_args)
    torch.cuda.synchronize()

    def err(x, y):
        return float((x - y).abs().max())

    fwd_err = max([err(x, y) for x, y in zip(got, ref)]
                  + [err(lean[0], ref[0]), err(lean[1], ref[1])])
    dxs_err = err(gb[0], rb[0])
    rel = {"dW_r": err(gb[1], rb[1]) / float(rb[1].abs().max()),
           "dchecks": err(gb[2], rb[2]) / float(rb[2].abs().max())}
    if not fwd_err <= LSTM_TOL or not dxs_err <= LSTM_TOL \
            or not max(rel.values()) <= LSTM_REL_TOL:
        fail(f"LSTM kernels (T={t}, B={b}, D={d}, ragged={ragged}) disagree "
             f"with their plain versions: forward max abs err {fwd_err}, "
             f"dxs {dxs_err} (bound {LSTM_TOL}); relative {rel} (bound "
             f"{LSTM_REL_TOL})")
    tc_err = max([fwd_err, dxs_err] + list(rel.values()))
    if not tc_err <= LSTM_TC_TOL:
        fail(f"LSTM kernels (T={t}, B={b}, D={d}, ragged={ragged}): error "
             f"{tc_err} exceeds the 3xTF32 gate {LSTM_TC_TOL} (one TF32 "
             f"pass lands above it)")
    if ragged and got[0][:, 0].any():
        fail("lstm_fwd: the empty row's hs is not exactly 0")
    rows = [{"name": lk.NAME_FWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": fwd_err},
            {"name": lk.NAME_BWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": max(dxs_err, err(gb[1], rb[1]),
                                err(gb[2], rb[2])),
             "dxs_max_abs_err": dxs_err, "rel_err": rel}]
    dwr = torch.empty_like(w_r)
    dwr_entry = _build.entry("lstm", "lstm_dwr_f32", 3, 3)
    stream = torch.cuda.current_stream().cuda_stream

    def dwr_only():     # dW_r alone: the backward's second launch
        _build.check(lk.NAME_BWD, dwr_entry(
            ref[0].data_ptr(), gb[0].data_ptr(), dwr.data_ptr(), t, b, d,
            stream))

    calls = ((lambda: lk.lstm_fwd(xs, mask, w_r, checks, True),
              lambda: lk.lstm_fwd_plain(xs, mask, w_r, checks, True)),
             (lambda: lk.lstm_bwd(*bwd_args),
              lambda: lk.lstm_bwd_plain(*bwd_args)),
             dwr_only)
    return rows, calls, lstm_cost(lengths, t, d)


def check_lstm_kernels(torch, dev, rng, t, b, d, timed):
    """The LSTM pair on a ragged mask (with an empty row); when timed,
    also on the train path's own data (every row full length), which is
    what the times and the bound are taken on."""
    rows, _, _ = lstm_pair(torch, dev, rng, t, b, d, ragged=True)
    if not timed:
        return rows
    full, calls, costs = lstm_pair(torch, dev, rng, t, b, d, ragged=False)
    library = ("no single PyTorch call computes this function: cuDNN's "
               "LSTM has no peepholes and no masked carry freeze")
    for row, row_full, (fn, plain), (nbytes, flops) in zip(rows, full,
                                                           calls[:2], costs):
        row.update(max_abs_err=max(row["max_abs_err"],
                                   row_full["max_abs_err"]),
                   full_rows_check=row_full,
                   shape={"T": t, "B": b, "D": d, "timed_on": "full rows"},
                   ms=time_ms(torch, fn, samples=20, reps=5),
                   plain_ms=time_ms(torch, plain, samples=5, reps=2),
                   library_ms=None, library_note=library,
                   bytes=nbytes, flops=flops)
        tc_bound(row, nbytes, flops)
    # the backward's split: dW_r alone (its second launch), BPTT the rest;
    # dW_r's bound: hs and dxs read once, dW_r written once, its product
    dwr_ms = time_ms(torch, calls[2], samples=20, reps=5)
    dwr_flops = costs[1][1] // 2
    dwr_bytes = 4 * ((t - 1) * b * (d + 4 * d) + 4 * d * d)
    rows[1]["split"] = {"dW_r_ms": dwr_ms, "bptt_ms": rows[1]["ms"] - dwr_ms,
                        "dW_r_bound_ms": bound(dwr_bytes, dwr_flops,
                                               PEAK_3XTF32_FLOPS)[0]}
    return rows


# the one-TF32-pass builds of the kernels, kept for the train phases'
# step-level controls: {"lstm": (fwd, bwd, dwr), "gru": (fwd, bwd, _)}
# C entries
TF32_1X = {}


@contextlib.contextmanager
def tf32_1x(kind):
    """Within it, the ``kind`` ("lstm" or "gru") wrappers' float32
    instances launch the one-TF32-pass build of csrc/<kind>.cu
    (``check_<kind>_tf32_control``'s control) in place of the kernels: a
    step whose LSTMs or GRUs compute in single-pass TF32 and nothing else
    differs."""
    import types
    from paddle_tpu_torch.ops.kernels import _build
    fwd, bwd = TF32_1X[kind][:2]
    lib = _build.load(kind)
    _build._libs[kind] = types.SimpleNamespace(
        **{f"{kind}_fwd_f32": fwd, f"{kind}_bwd_f32": bwd})
    try:
        yield
    finally:
        _build._libs[kind] = lib


def check_lstm_tf32_control(torch, dev):
    """The tf32_1x variant of csrc/lstm.cu (one TF32 product a k-step,
    scripts/probe_lstm.py) and the kernels as built, on one set of train
    shape inputs: the kernels pass LSTM_TC_TOL and the variant must not,
    or the gate could not tell one pass from 3xTF32."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import lstm as lk
    from paddle_tpu_torch.scripts import probe_lstm
    (control, _), = probe_lstm.build(["tf32_1x"]).values()
    TF32_1X["lstm"] = control
    case = probe_lstm.Case(dev, np.random.RandomState(1), LSTM_T, LSTM_B,
                           LSTM_D)
    kernel = (_build.entry("lstm", "lstm_fwd_f32", *lk.FWD_ARGS),
              _build.entry("lstm", "lstm_bwd_f32", *lk.BWD_ARGS),
              _build.entry("lstm", "lstm_dwr_f32", 3, 3))
    errs = {"kernel": case.errors(kernel), "tf32_1x": case.errors(control)}
    worst = {name: max(e.values()) for name, e in errs.items()}
    if not worst["kernel"] <= LSTM_TC_TOL or worst["tf32_1x"] <= LSTM_TC_TOL:
        fail(f"3xTF32 gate {LSTM_TC_TOL}: the LSTM kernels read {errs['kernel']}"
             f", the one-pass control {errs['tf32_1x']} (the control must "
             "fail the gate, the kernels pass it)")
    return {"shape": {"T": LSTM_T, "B": LSTM_B, "D": LSTM_D},
            "gate": LSTM_TC_TOL, "errors": errs}


def lstm_card_vs_cpu(torch, dev, rng, kernels, b, lengths, reverse, **kw):
    """rnn.lstm (T 30, D 128) on the card against the same call on the
    CPU: loss and every gradient, relative to each one's largest entry;
    with the LSTM launches the card's call made."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import rnn
    t, d = 30, 128
    x = normal(rng, (b, t, 4 * d)) * 0.3
    w_r = normal(rng, (d, 4 * d)) * 0.1
    rest = [normal(rng, (d,)) * 0.1 for _ in range(3)] \
        + [normal(rng, (4 * d,)) * 0.1]

    def run(device):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x, w_r, *rest)]
        out, final = rnn.lstm(
            SequenceBatch(args[0], torch.tensor(lengths, device=device)),
            args[1], bias=args[5], check_i=args[2], check_f=args[3],
            check_o=args[4], reverse=reverse, **kw)
        loss = (out.data ** 2).sum() + (final.c ** 2).sum() + final.h.sum()
        loss.backward()
        return float(loss.detach()), [a.grad.cpu() for a in args]

    kernels.reset_launches()
    loss_c, grads_c = run(dev)
    launches = {kernels.lstm.NAME_FWD: kernels.lstm.launches_fwd,
                kernels.lstm.NAME_BWD: kernels.lstm.launches_bwd,
                kernels.lstm_blocked.NAME_FWD:
                    kernels.lstm_blocked.launches_fwd}
    loss_r, grads_r = run("cpu")
    worst = max(float((g - r).abs().max() / r.abs().max())
                for g, r in zip(grads_c, grads_r))
    return abs(loss_c - loss_r) / abs(loss_r), worst, launches


def check_lstm_reverse(torch, dev, rng, kernels):
    """rnn.lstm(reverse=True) on the card (kernels, through LstmFused:
    B 8, D 128 is the resident route's) against the same call on the CPU
    (plain versions), on a ragged batch with an empty row."""
    lengths = np.asarray([0, 30, 7, 19, 1, 12, 30, 3], np.int32)
    loss_err, worst, launches = lstm_card_vs_cpu(
        torch, dev, rng, kernels, len(lengths), lengths, True)
    want = {kernels.lstm.NAME_FWD: 1, kernels.lstm.NAME_BWD: 1,
            kernels.lstm_blocked.NAME_FWD: 0}
    if launches != want or not worst <= LSTM_REL_TOL \
            or not loss_err <= LSTM_REL_TOL:
        fail(f"reverse rnn.lstm: launches {launches} (want {want}); card vs "
             f"CPU relative error loss {loss_err}, grads {worst} (bound "
             f"{LSTM_REL_TOL})")
    return {"reverse_lstm": {"B": len(lengths), "D": 128},
            "loss_rel_err": loss_err, "grad_rel_err": worst}


def check_lstm_scan(torch, dev, rng, kernels):
    """Where JAX's rules send rnn.lstm to the masked scan (B % 8 != 0, a
    non-default activation), the card runs the scan too: it matches the
    CPU's and launches no kernel."""
    rows = []
    for b, kw in ((5, {}), (8, {"act": "relu"})):
        lengths = rng.randint(1, 31, b).astype(np.int32)
        lengths[0] = 0
        loss_err, worst, launches = lstm_card_vs_cpu(
            torch, dev, rng, kernels, b, lengths, False, **kw)
        if any(launches.values()) or not worst <= LSTM_REL_TOL \
                or not loss_err <= LSTM_REL_TOL:
            fail(f"rnn.lstm scan (B {b}, {kw}): launches {launches} (want "
                 f"none); card vs CPU relative error loss {loss_err}, grads "
                 f"{worst} (bound {LSTM_REL_TOL})")
        rows.append({"B": b, "D": 128, **kw, "loss_rel_err": loss_err,
                     "grad_rel_err": worst, "launches": launches})
    return rows


def blocked_check(torch, dev, rng, t, b, d, ragged):
    """The blocked forward, both variants, against its plain version on
    one set of inputs (W_r std 1/sqrt(D)).  Returns the result row, the
    (kernel, plain) calls and the forward's (bytes, flops)."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    from paddle_tpu_torch.ops.kernels import lstm_blocked as bk
    lengths, xs, mask, w_r, checks = lstm_inputs(
        torch, dev, rng, t, b, d, ragged, w_scale=1.0 / math.sqrt(d))
    ref = lk.lstm_fwd_plain(xs, mask, w_r, checks, True)
    got = bk.lstm_blocked_fwd(xs, mask, w_r, checks, True)
    lean = bk.lstm_blocked_fwd(xs, mask, w_r, checks, False)
    torch.cuda.synchronize()
    err = max([float((x - y).abs().max()) for x, y in zip(got, ref)]
              + [float((lean[i] - ref[i]).abs().max()) for i in (0, 1)])
    if not err <= KERNEL_TOL:
        fail(f"lstm_blocked_fwd (T={t}, B={b}, D={d}, ragged={ragged}) "
             f"disagrees with its plain version: max abs err {err} (bound "
             f"{KERNEL_TOL})")
    if not err <= BLK_TC_TOL:
        fail(f"lstm_blocked_fwd (T={t}, B={b}, D={d}, ragged={ragged}): "
             f"max abs err {err} exceeds the 3xTF32 gate {BLK_TC_TOL} (one "
             f"TF32 pass lands above it)")
    if ragged and got[0][:, 0].any():
        fail("lstm_blocked_fwd: the empty row's hs is not exactly 0")
    calls = (lambda: bk.lstm_blocked_fwd(xs, mask, w_r, checks, True),
             lambda: lk.lstm_fwd_plain(xs, mask, w_r, checks, True))
    return ({"name": bk.NAME_FWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": err}, calls, lstm_cost(lengths, t, d)[0])


def check_blocked_kernel(torch, dev, rng):
    """The blocked forward at the train shape for each of BLK_TIMED on a
    ragged mask (with an empty row) and on full rows, timed on the
    latter (the train batch's rows) beside its plain version and its
    bound; then ragged at BLK_OTHER; then the gain probe."""
    from paddle_tpu_torch.ops.kernels import lstm as lk
    from paddle_tpu_torch.ops.kernels import lstm_blocked as bk
    timed = {}
    for d in BLK_TIMED:
        row, _, _ = blocked_check(torch, dev, rng, BLK_T, BLK_B, d, True)
        full, (fn, plain), (nbytes, flops) = blocked_check(
            torch, dev, rng, BLK_T, BLK_B, d, False)
        row.update(
            max_abs_err=max(row["max_abs_err"], full["max_abs_err"]),
            full_rows_max_abs_err=full["max_abs_err"],
            timed_on="full rows", ms=time_ms(torch, fn, samples=10, reps=3),
            plain_ms=time_ms(torch, plain, samples=3, reps=2),
            library_ms=None,
            library_note="no single PyTorch call computes this function: "
                         "cuDNN's LSTM has no peepholes and no masked "
                         "carry freeze", bytes=nbytes, flops=flops)
        tc_bound(row, nbytes, flops)
        # W_r read again at each of the T - 1 steps with a product, from
        # HBM: what a W_r streamed every step costs where it outgrows L2
        row["bound_w_r_streamed_ms"] = (BLK_T - 1) * 4 * d * 4 * d \
            / PEAK_BYTES_S * 1e3
        timed[d] = row
    other = [blocked_check(torch, dev, rng, t, b, d, True)[0]
             for t, b, d in BLK_OTHER]
    # W_r at the JAX tests' 0.1: the kernel's distance from its plain
    # version beside that of the plain version on the card from the same
    # plain version on the CPU (reported, not bounded: a measure of the
    # recurrence's gain, not of the kernel)
    _, xs, mask, w_r, checks = lstm_inputs(torch, dev, rng, BLK_T, BLK_B,
                                           BLK_TIMED[0], False,
                                           w_scale=BLK_GAIN_PROBE)
    ref = lk.lstm_fwd_plain(xs, mask, w_r, checks, False)[0]
    got = bk.lstm_blocked_fwd(xs, mask, w_r, checks, False)[0]
    cpu = lk.lstm_fwd_plain(*(a.cpu() for a in (xs, mask, w_r, checks)),
                            False)[0]
    probe = {"D": BLK_TIMED[0], "w_scale": BLK_GAIN_PROBE,
             "kernel_vs_plain_hs": float((got - ref).abs().max()),
             "plain_card_vs_plain_cpu_hs": float(
                 (ref.cpu() - cpu).abs().max()),
             "hs_max": float(cpu.abs().max())}
    return timed, other, probe


def gru_inputs(torch, dev, rng, t, b, d, ragged):
    """(lengths, xs [T, B, 3D], mask [T, B], w_gate, w_state) at the JAX
    tests' scale.  Ragged: random lengths with one empty row and one
    full row; else every row full, as the train path's batch is."""
    lengths = np.full(b, t)
    if ragged:
        lengths = rng.randint(1, t + 1, b)
        lengths[0] = 0
        lengths[-1] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (lengths,
            torch.tensor(normal(rng, (t, b, 3 * d)) * 0.3, device=dev),
            torch.tensor(mask, device=dev),
            torch.tensor(normal(rng, (d, 2 * d)) * 0.1, device=dev),
            torch.tensor(normal(rng, (d, d)) * 0.1, device=dev))


def gru_cost(lengths, t, d):
    """(bytes, flops) of the forward with residuals and of the backward
    with dW_gate and dW_state on these inputs.  Bytes: each input read
    once, each output written once.  Operations: the recurrent products
    these lengths need, 6 D^2 a row and step each way.  The forward
    needs h_{t-1} W_gate and (r h_{t-1}) W_state at every step t >= 1 of
    a row that ever started (acts are outputs even where the mask is 0;
    an empty row's h stays 0); the backward needs dccg W_state^T,
    dgates W_gate^T and the two dW terms only where the mask is 1 and
    t >= 1 (elsewhere dgates and dccg m are 0, and h_{-1} = 0)."""
    b = len(lengths)
    fwd_bytes = 4 * (7 * t * b * d + t * b + 3 * d * d)
    bwd_bytes = 4 * (8 * t * b * d + t * b + 6 * d * d)
    fwd_rows = (t - 1) * int((lengths > 0).sum())
    bwd_rows = int(np.maximum(lengths - 1, 0).sum())
    return ((fwd_bytes, 6 * d * d * fwd_rows),
            (bwd_bytes, 12 * d * d * bwd_rows))


def gru_pair(torch, dev, rng, t, b, d, ragged):
    """Forward (both variants) and backward kernels against their plain
    versions on one set of inputs; the backward gets the plain forward's
    residuals on both sides so that its check stands alone.  Each check
    also within GRU_TC_TOL, and a second launch of each kernel bit for
    bit the first.  Returns the two result rows, the calls (kernel,
    plain) x (fwd, bwd) and the costs."""
    from paddle_tpu_torch.ops.kernels import gru as gk
    lengths, xs, mask, w_gate, w_state = gru_inputs(torch, dev, rng, t, b,
                                                    d, ragged)
    ref = gk.gru_fwd_plain(xs, mask, w_gate, w_state, True)
    got = gk.gru_fwd(xs, mask, w_gate, w_state, True)
    lean, _ = gk.gru_fwd(xs, mask, w_gate, w_state, False)
    dh_out = torch.tensor(normal(rng, (t, b, d)), device=dev)
    bwd_args = (ref[1], ref[0], w_gate, w_state, mask, dh_out)
    gb = gk.gru_bwd(*bwd_args)
    rb = gk.gru_bwd_plain(*bwd_args)
    torch.cuda.synchronize()

    def err(x, y):
        return float((x - y).abs().max())

    fwd_err = max(err(got[0], ref[0]), err(got[1], ref[1]),
                  err(lean, ref[0]))
    dxs_err = err(gb[0], rb[0])
    rel = {"dxs": dxs_err / float(rb[0].abs().max()),
           "dW_gate": err(gb[1], rb[1]) / float(rb[1].abs().max()),
           "dW_state": err(gb[2], rb[2]) / float(rb[2].abs().max())}
    if not fwd_err <= LSTM_TOL or not dxs_err <= LSTM_TOL \
            or not max(rel["dW_gate"], rel["dW_state"]) <= LSTM_REL_TOL:
        fail(f"GRU kernels (T={t}, B={b}, D={d}, ragged={ragged}) disagree "
             f"with their plain versions: forward max abs err {fwd_err}, "
             f"dxs {dxs_err} (bound {LSTM_TOL}); relative {rel} (bound "
             f"{LSTM_REL_TOL})")
    if not max([fwd_err] + list(rel.values())) <= GRU_TC_TOL:
        fail(f"GRU kernels (T={t}, B={b}, D={d}, ragged={ragged}): hs / "
             f"acts {fwd_err}, relative {rel} exceed the 3xTF32 gate "
             f"{GRU_TC_TOL} (one TF32 pass lands above it)")
    if ragged and (got[0][:, 0].any() or gb[0][:, 0].any()):
        fail("GRU kernels: the empty row's hs or dxs is not exactly 0")
    again = gk.gru_fwd(xs, mask, w_gate, w_state, True)
    again_lean, _ = gk.gru_fwd(xs, mask, w_gate, w_state, False)
    again_b = gk.gru_bwd(*bwd_args)
    if not all(torch.equal(x, y) for x, y in zip(
            (*again, again_lean, *again_b), (*got, lean, *gb))):
        fail(f"GRU kernels (T={t}, B={b}, D={d}, ragged={ragged}): a second "
             "launch on the same inputs differs from the first")
    rows = [{"name": gk.NAME_FWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": fwd_err, "repeat": "bit for bit"},
            {"name": gk.NAME_BWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": max(dxs_err, err(gb[1], rb[1]),
                                err(gb[2], rb[2])),
             "dxs_max_abs_err": dxs_err, "rel_err": rel,
             "repeat": "bit for bit"}]
    calls = ((lambda: gk.gru_fwd(xs, mask, w_gate, w_state, True),
              lambda: gk.gru_fwd_plain(xs, mask, w_gate, w_state, True)),
             (lambda: gk.gru_bwd(*bwd_args),
              lambda: gk.gru_bwd_plain(*bwd_args)))
    return rows, calls, gru_cost(lengths, t, d)


def check_gru_kernels(torch, dev, rng, libs):
    """The GRU pair at the train shape on a ragged mask (with an empty
    row) and on the train path's own data (every row full length), which
    the times and the bound are taken on, with the backward's split (dW
    alone through ``libs["kernel"]``, scripts/probe_gru.build's entries
    on the same source, and BPTT the rest); then ragged at GRU_OTHER."""
    rows, _, _ = gru_pair(torch, dev, rng, GRU_T, GRU_B, GRU_D, ragged=True)
    full, calls, costs = gru_pair(torch, dev, rng, GRU_T, GRU_B, GRU_D,
                                  ragged=False)
    library = ("no single PyTorch call computes this function: cuDNN's GRU "
               "applies the reset gate after the recurrent product, "
               "r (h W_hn + b_hn), where Paddle's applies it before, "
               "(r h) W_state, and has no masked carry freeze")
    for row, row_full, (fn, plain), (nbytes, flops) in zip(rows, full, calls,
                                                           costs):
        row.update(max_abs_err=max(row["max_abs_err"],
                                   row_full["max_abs_err"]),
                   full_rows_check=row_full,
                   shape={"T": GRU_T, "B": GRU_B, "D": GRU_D,
                          "timed_on": "full rows"},
                   ms=time_ms(torch, fn, samples=20, reps=5),
                   plain_ms=time_ms(torch, plain, samples=5, reps=2),
                   library_ms=None, library_note=library,
                   bytes=nbytes, flops=flops)
        if "rel_err" in row:
            row["rel_err"] = {key: max(v, row_full["rel_err"][key])
                              for key, v in row["rel_err"].items()}
        tc_bound(row, nbytes, flops)
    # dW alone (the backward's second launch); its bound: hs, s_all and
    # dxs[1:] read once, dW_gate and dW_state written once, their product
    from paddle_tpu_torch.scripts import probe_gru
    case = probe_gru.Case(dev, np.random.RandomState(2), GRU_T, GRU_B, GRU_D)
    entries = libs["kernel"][0]
    case.bwd(entries)
    dw_ms = time_ms(torch, lambda: case.dw(entries), samples=20, reps=5)
    k = (GRU_T - 1) * GRU_B
    rows[1]["split"] = {
        "dW_ms": dw_ms, "bptt_ms": rows[1]["ms"] - dw_ms,
        "dW_bound_ms": bound(4 * (k * 5 * GRU_D + 3 * GRU_D * GRU_D),
                             costs[1][1] // 2, PEAK_3XTF32_FLOPS)[0]}
    other = [r for b, d in GRU_OTHER
             for r in gru_pair(torch, dev, rng, GRU_T, b, d, True)[0]]
    return rows, other


def check_gru_tf32_control(torch, dev, libs):
    """The tf32_1x variant of csrc/gru.cu (one TF32 product a k-step,
    scripts/probe_gru.py) and the kernels as built, on one set of train
    shape inputs: the kernels pass GRU_TC_TOL and the variant must not,
    or the gate could not tell one pass from 3xTF32."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import gru as gk
    from paddle_tpu_torch.scripts import probe_gru
    case = probe_gru.Case(dev, np.random.RandomState(1), GRU_T, GRU_B,
                          GRU_D)
    kernel = (_build.entry("gru", "gru_fwd_f32", *gk.FWD_ARGS),
              _build.entry("gru", "gru_bwd_f32", *gk.BWD_ARGS))
    TF32_1X["gru"] = libs["tf32_1x"][0]
    errs = {"kernel": case.errors(kernel),
            "tf32_1x": case.errors(libs["tf32_1x"][0])}
    worst = {name: max(e.values()) for name, e in errs.items()}
    if not worst["kernel"] <= GRU_TC_TOL or worst["tf32_1x"] <= GRU_TC_TOL:
        fail(f"3xTF32 gate {GRU_TC_TOL}: the GRU kernels read "
             f"{errs['kernel']}, the one-pass control {errs['tf32_1x']} (the "
             "control must fail the gate, the kernels pass it)")
    return {"shape": {"T": GRU_T, "B": GRU_B, "D": GRU_D},
            "gate": GRU_TC_TOL, "errors": errs}


def check_gru_reverse(torch, dev, rng, kernels):
    """rnn.gru(reverse=True) at the train shape on the card (kernels,
    through GruFused) against the same call on the CPU (plain versions):
    loss and every gradient, on a ragged batch with an empty row."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import rnn
    t, b, d = GRU_T, GRU_B, GRU_D
    x = normal(rng, (b, t, 3 * d)) * 0.3
    lengths = rng.randint(1, t + 1, b).astype(np.int32)
    lengths[0] = 0
    w_gate, w_state = normal(rng, (d, 2 * d)) * 0.1, normal(rng, (d, d)) * 0.1
    bias = normal(rng, (3 * d,)) * 0.1

    def run(device):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x, w_gate, w_state, bias)]
        out, final = rnn.gru(
            SequenceBatch(args[0], torch.tensor(lengths, device=device)),
            args[1], args[2], bias=args[3], reverse=True)
        loss = (out.data ** 2).sum() + (final ** 2).sum()
        loss.backward()
        return float(loss.detach()), [a.grad.cpu() for a in args]

    kernels.reset_launches()
    loss_c, grads_c = run(dev)
    launches = (kernels.gru.launches_fwd, kernels.gru.launches_bwd)
    loss_r, grads_r = run("cpu")
    worst = max(float((g - r).abs().max() / r.abs().max())
                for g, r in zip(grads_c, grads_r))
    loss_err = abs(loss_c - loss_r) / abs(loss_r)
    if launches != (1, 1) or not worst <= LSTM_REL_TOL \
            or not loss_err <= LSTM_REL_TOL:
        fail(f"reverse rnn.gru: launches {launches} (want 1, 1); card vs "
             f"CPU relative error loss {loss_err}, grads {worst} (bound "
             f"{LSTM_REL_TOL})")
    return {"reverse_gru": {"T": t, "B": b, "D": d}, "loss_rel_err": loss_err,
            "grad_rel_err": worst}


def check_gru_barrier(torch):
    """The device time of one grid-wide barrier at the grid the GRU
    forward launches at the train shape (D / 16 unit blocks times its
    b-groups, 128 CTAs of one an SM on an H100): a cooperative launch of
    2 (GRU_T - 1) barriers alone, the count one train-shape launch
    makes, less an empty one."""
    from paddle_tpu_torch.ops.kernels import _build
    probe = _build.entry("gru", "gru_barrier_probe", 0, 3)
    stream = torch.cuda.current_stream().cuda_stream
    syncs = 2 * (GRU_T - 1)

    def run(n):
        _build.check("gru_barrier_probe", probe(n, GRU_B, GRU_D, stream))

    with_syncs = time_ms(torch, lambda: run(syncs), samples=20, reps=5)
    empty = time_ms(torch, lambda: run(0), samples=20, reps=5)
    return {"barriers": syncs, "launch_ms": with_syncs, "empty_launch_ms":
            empty, "us_per_barrier": (with_syncs - empty) / syncs * 1e3}


def rnn_inputs(torch, dev, rng, t, b, d, ragged):
    """(lengths, xs [T, B, D], mask [T, B], W [D, D]).  Ragged: random
    lengths with one empty row and one full row; else every row full, as
    the train path's batch is."""
    lengths = np.full(b, t)
    if ragged:
        lengths = rng.randint(1, t + 1, b)
        lengths[0] = 0
        lengths[-1] = t
    mask = (np.arange(t)[:, None] < lengths[None, :]).astype(np.float32)
    return (lengths,
            torch.tensor(normal(rng, (t, b, d)) * 0.3, device=dev),
            torch.tensor(mask, device=dev),
            torch.tensor(normal(rng, (d, d)) / np.float32(math.sqrt(d)),
                         device=dev))


def rnn_cost(lengths, t, d):
    """(bytes, flops) of the forward and of the backward with dW on these
    inputs.  Bytes: each input read once, each output written once.
    Operations: the products these lengths need, h_{t-1} W forward and
    dg W^T and h_{t-1}^T dg backward, only where the mask is 1 and
    t >= 1 (a masked step copies the carry, and h_{-1} = 0)."""
    b = len(lengths)
    rows = int(np.maximum(lengths - 1, 0).sum())
    return ((4 * (2 * t * b * d + t * b + d * d), 2 * d * d * rows),
            (4 * (3 * t * b * d + t * b + 2 * d * d), 4 * d * d * rows))


def rnn_library(torch, dev, xs, w, dh_out):
    """torch.nn.RNN (cuDNN RNN_TANH, no bias) computing the same
    recurrence on full rows, W_ih = I and W_hh = W^T: (forward, backward
    of input and W_hh by autograd.grad over a retained graph, its max
    abs error against the plain forward).  A yardstick the port never
    calls; its time includes the input product by I."""
    d = w.shape[0]
    lib = torch.nn.RNN(d, d, nonlinearity="tanh", bias=False).to(dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(torch.eye(d, device=dev))
        lib.weight_hh_l0.copy_(w.T)
    x = xs.clone().requires_grad_(True)
    out = lib(x)[0]

    def forward():
        with torch.no_grad():
            return lib(xs)
    return (forward,
            (lambda: torch.autograd.grad(out, (x, lib.weight_hh_l0), dh_out,
                                         retain_graph=True)),
            out.detach())


def rnn_pair(torch, dev, rng, t, b, d, ragged):
    """Forward, BPTT and dW kernels against their plain versions on one
    set of inputs; the backward gets the plain forward's hs on both sides
    so that its check stands alone.  Returns the two result rows, the
    (kernel, plain) calls of each and the costs."""
    from paddle_tpu_torch.ops.kernels import simple_rnn as rk
    lengths, xs, mask, w = rnn_inputs(torch, dev, rng, t, b, d, ragged)
    ref = rk.simple_rnn_fwd_plain(xs, mask, w)
    got = rk.simple_rnn_fwd(xs, mask, w)
    dh_out = torch.tensor(normal(rng, (t, b, d)), device=dev)
    gb = rk.simple_rnn_bwd(ref, w, mask, dh_out)
    rb = rk.simple_rnn_bwd_plain(ref, w, mask, dh_out)
    torch.cuda.synchronize()

    def err(x, y):
        return float((x - y).abs().max())

    fwd_err, dxs_err = err(got, ref), err(gb[0], rb[0])
    dxs_rel = dxs_err / float(rb[0].abs().max())
    dw_rel = err(gb[1], rb[1]) / float(rb[1].abs().max())
    if not fwd_err <= KERNEL_TOL or not dxs_err <= KERNEL_TOL \
            or not dw_rel <= KERNEL_TOL:
        fail(f"simple-RNN kernels (T={t}, B={b}, D={d}, ragged={ragged}) "
             f"disagree with their plain versions: hs max abs err "
             f"{fwd_err}, dxs {dxs_err}, dW relative {dw_rel} (bound "
             f"{KERNEL_TOL})")
    if not max(fwd_err, dxs_rel, dw_rel) <= RNN_TC_TOL:
        fail(f"simple-RNN kernels (T={t}, B={b}, D={d}, ragged={ragged}): "
             f"hs {fwd_err}, dxs relative {dxs_rel}, dW relative {dw_rel} "
             f"exceed the 3xTF32 gate {RNN_TC_TOL} (one TF32 pass lands "
             "above it)")
    if ragged and (got[:, 0].any() or gb[0][:, 0].any()):
        fail("simple-RNN kernels: the empty row's hs or dxs is not "
             "exactly 0")
    again, again_b = (rk.simple_rnn_fwd(xs, mask, w),
                      rk.simple_rnn_bwd(ref, w, mask, dh_out))
    if not (torch.equal(again, got) and torch.equal(again_b[0], gb[0])
            and torch.equal(again_b[1], gb[1])):
        fail(f"simple-RNN kernels (T={t}, B={b}, D={d}, ragged={ragged}): "
             "a second launch on the same inputs differs from the first")
    rows = [{"name": rk.NAME_FWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": fwd_err, "repeat": "bit for bit"},
            {"name": rk.NAME_BWD, "T": t, "B": b, "D": d, "ragged": ragged,
             "max_abs_err": dxs_err, "dxs_rel_err": dxs_rel,
             "dW_max_abs_err": err(gb[1], rb[1]), "dW_rel_err": dw_rel,
             "repeat": "bit for bit"}]
    calls = ((lambda: rk.simple_rnn_fwd(xs, mask, w),
              lambda: rk.simple_rnn_fwd_plain(xs, mask, w)),
             (lambda: rk.simple_rnn_bwd(ref, w, mask, dh_out),
              lambda: rk.simple_rnn_bwd_plain(ref, w, mask, dh_out)))
    return rows, calls, rnn_cost(lengths, t, d), (xs, w, dh_out, ref)


def check_rnn_kernels(torch, dev, rng, libs=None):
    """The simple-RNN kernels at the train shape on a ragged mask (with
    an empty row) and on the train path's own data (every row full),
    which the times, the bound and the cuDNN yardstick are taken on;
    then ragged at RNN_OTHER.  With ``libs`` (scripts/probe_simple_rnn.
    build's, holding "kernel"), also the backward's split: dW alone and
    BPTT the rest."""
    rows, _, _, _ = rnn_pair(torch, dev, rng, RNN_T, RNN_B, RNN_D, True)
    full, calls, costs, (xs, w, dh_out, ref) = rnn_pair(
        torch, dev, rng, RNN_T, RNN_B, RNN_D, False)
    lib_fwd, lib_bwd, lib_out = rnn_library(torch, dev, xs, w, dh_out)
    lib_err = float((lib_out - ref).abs().max())
    note = ("torch.nn.RNN (cuDNN RNN_TANH, no bias) with W_ih = I and "
            "W_hh = W^T on the same full rows: its time includes one "
            "extra [T B, D] x [D, D] input product; the backward is "
            "autograd.grad of the input and W_hh over a retained graph")
    for row, row_full, (fn, plain), (nbytes, flops), lib in zip(
            rows, full, calls, costs, (lib_fwd, lib_bwd)):
        row.update(max_abs_err=max(row["max_abs_err"],
                                   row_full["max_abs_err"]),
                   full_rows_check=row_full,
                   shape={"T": RNN_T, "B": RNN_B, "D": RNN_D,
                          "timed_on": "full rows"},
                   ms=time_ms(torch, fn, samples=20, reps=5),
                   plain_ms=time_ms(torch, plain, samples=5, reps=2),
                   library_ms=time_ms(torch, lib, samples=20, reps=5),
                   library_note=note, library_fwd_max_abs_err=lib_err,
                   bytes=nbytes, flops=flops)
        for key in ("dxs_rel_err", "dW_rel_err"):
            if key in row:
                row[key] = max(row[key], row_full[key])
        tc_bound(row, nbytes, flops)
    if libs is not None:
        # dW alone (the backward's second launch, the probe's entry on the
        # same source); its bound: hs and dxs read once, dW written once
        from paddle_tpu_torch.scripts import probe_simple_rnn
        case = probe_simple_rnn.Case(dev, np.random.RandomState(2), RNN_T,
                                     RNN_B, RNN_D)
        entries = libs["kernel"][0]
        case.bwd(entries)
        dw_ms = time_ms(torch, lambda: case.dw(entries), samples=20, reps=5)
        rows[1]["split"] = {
            "dW_ms": dw_ms, "bptt_ms": rows[1]["ms"] - dw_ms,
            "dW_bound_ms": bound(4 * (2 * (RNN_T - 1) * RNN_B * RNN_D
                                      + RNN_D * RNN_D),
                                 costs[1][1] // 2, PEAK_3XTF32_FLOPS)[0]}
    other = [r for t, b, d in RNN_OTHER
             for r in rnn_pair(torch, dev, rng, t, b, d, True)[0]]
    return rows, other


def check_rnn_tf32_control(torch, dev, libs):
    """The tf32_1x variant of csrc/simple_rnn.cu (one TF32 product a
    k-step, scripts/probe_simple_rnn.py) and the kernels as built, on one
    set of train shape inputs: the kernels pass RNN_TC_TOL and the
    variant must not, or the gate could not tell one pass from 3xTF32."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import simple_rnn as rk
    from paddle_tpu_torch.scripts import probe_simple_rnn
    case = probe_simple_rnn.Case(dev, np.random.RandomState(1), RNN_T,
                                 RNN_B, RNN_D)
    kernel = (_build.entry("simple_rnn", f"{rk.NAME_FWD}_f32", *rk.FWD_ARGS),
              _build.entry("simple_rnn", f"{rk.NAME_BWD}_f32", *rk.BWD_ARGS))
    errs = {"kernel": case.errors(kernel),
            "tf32_1x": case.errors(libs["tf32_1x"][0])}
    worst = {name: max(e.values()) for name, e in errs.items()}
    if not worst["kernel"] <= RNN_TC_TOL or worst["tf32_1x"] <= RNN_TC_TOL:
        fail(f"3xTF32 gate {RNN_TC_TOL}: the simple-RNN kernels read "
             f"{errs['kernel']}, the one-pass control {errs['tf32_1x']} (the "
             "control must fail the gate, the kernels pass it)")
    return {"shape": {"T": RNN_T, "B": RNN_B, "D": RNN_D},
            "gate": RNN_TC_TOL, "errors": errs}


def rnn_card_vs_cpu(torch, dev, rng, kernels, t, b, d, lengths, reverse,
                    **kw):
    """rnn.simple_rnn on the card against the same call on the CPU: loss
    and every gradient (x, W, bias) relative to each one's largest
    entry, with the simple-RNN launches the card's call made."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import rnn
    x = normal(rng, (b, t, d)) * 0.3
    w = normal(rng, (d, d)) / np.float32(math.sqrt(d))
    bias = normal(rng, (d,)) * 0.1

    def run(device):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in (x, w, bias)]
        out, final = rnn.simple_rnn(
            SequenceBatch(args[0], torch.tensor(lengths, device=device)),
            args[1], bias=args[2], reverse=reverse, **kw)
        loss = (out.data ** 2).sum() + (final ** 2).sum()
        loss.backward()
        return float(loss.detach()), [a.grad.cpu() for a in args]

    kernels.reset_launches()
    loss_c, grads_c = run(dev)
    launches = (kernels.simple_rnn.launches_fwd,
                kernels.simple_rnn.launches_bwd)
    loss_r, grads_r = run("cpu")
    worst = max(float((g - r).abs().max() / r.abs().max())
                for g, r in zip(grads_c, grads_r))
    return abs(loss_c - loss_r) / abs(loss_r), worst, launches


def check_rnn_routes(torch, dev, rng, kernels):
    """rnn.simple_rnn(reverse=True) at the train shape through the kernels
    (SimpleRnnFused), on a ragged batch with an empty row; then where
    JAX's rule sends it to the masked scan (B 12; act="relu"), the card
    runs the scan too: each matches the CPU's and the scan launches no
    kernel."""
    out = []
    for t, b, d, reverse, kw, want in (
            (RNN_T, RNN_B, RNN_D, True, {}, (1, 1)),
            (30, 12, 128, False, {}, (0, 0)),
            (30, 8, 128, False, {"act": "relu"}, (0, 0))):
        lengths = rng.randint(1, t + 1, b).astype(np.int32)
        lengths[0] = 0
        loss_err, worst, launches = rnn_card_vs_cpu(
            torch, dev, rng, kernels, t, b, d, lengths, reverse, **kw)
        if launches != want or not worst <= LSTM_REL_TOL \
                or not loss_err <= LSTM_REL_TOL:
            fail(f"rnn.simple_rnn (T {t}, B {b}, D {d}, reverse {reverse}, "
                 f"{kw}): launches {launches} (want {want}); card vs CPU "
                 f"relative error loss {loss_err}, grads {worst} (bound "
                 f"{LSTM_REL_TOL})")
        out.append({"T": t, "B": b, "D": d, "reverse": reverse, **kw,
                    "route": "kernels" if any(want) else "scan",
                    "launches": list(launches), "loss_rel_err": loss_err,
                    "grad_rel_err": worst})
    return out


# ------------------------------------------------------------- paths

def margins(torch, transformer, params, ids, kv_dtype=None, heads=HEADS):
    """Top-1 minus top-2 logit at every position of ``ids`` [B, T]
    (teacher-forced: one prefill over the whole sequence, over an int8
    cache when ``kv_dtype="int8"``)."""
    hidden, _ = transformer.lm_prefill(params, ids, ids.shape[1],
                                       num_heads=heads, kv_dtype=kv_dtype)
    top2 = torch.topk(transformer._lm_project(params, hidden), 2, dim=-1)
    return (top2.values[..., 0] - top2.values[..., 1]).cpu().numpy()


def compare(got, ref, margin):
    """Tokens compared (up to the first position whose reference margin
    is below MARGIN_TOL) and whether they all match."""
    n = 0
    for g, r, m in zip(got, ref, margin):
        if m < MARGIN_TOL:
            break
        if g != r:
            return n, False
        n += 1
    return n, True


def run_generate(torch, dev, transformer, kernels, params, rng):
    prompt = rng.randint(3, VOCAB, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    transformer.lm_generate(params, prompt[:2], GEN_PROMPT + 4, HEADS)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ids = transformer.lm_generate(params, prompt, GEN_MAX_LEN, HEADS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"flash_attention": kernels.flash_attention.launches,
                "decode_attention_slab_chunk":
                    kernels.decode_attention.launches}
    if launches["flash_attention"] != LAYERS:
        fail(f"lm_generate launched flash_attention "
             f"{launches['flash_attention']} times, want {LAYERS} (one "
             "prefill)")
    ids_np = ids.cpu().numpy()
    if ids_np.shape != (GEN_BATCH, GEN_MAX_LEN) \
            or not (ids_np[:, :GEN_PROMPT] == prompt).all() \
            or ids_np.min() < 0 or ids_np.max() >= VOCAB:
        fail("lm_generate output is malformed")
    # two rows against the same call on the CPU, where every kernel
    # takes its plain version
    cpu_params = transformer.tree_map(lambda x: x.cpu(), params)
    ref = transformer.lm_generate(cpu_params, prompt[:2], GEN_MAX_LEN,
                                  HEADS)
    marg = margins(torch, transformer, cpu_params, ref)
    ref_np = ref.numpy()
    checked = 0
    for r in range(2):
        n, ok = compare(ids_np[r, GEN_PROMPT:], ref_np[r, GEN_PROMPT:],
                        marg[r, GEN_PROMPT - 1:])
        if not ok:
            fail(f"lm_generate row {r}: card and CPU disagree within the "
                 f"first {n + 1} tokens above margin {MARGIN_TOL}")
        checked += n
    out = {"phase": "generate", "batch": GEN_BATCH, "prompt": GEN_PROMPT,
           "max_len": GEN_MAX_LEN, "seconds": dt,
           "emitted_tokens_per_s": GEN_BATCH * (GEN_MAX_LEN - GEN_PROMPT)
           / dt,
           "launches": launches, "cpu_tokens_checked": checked,
           "cpu_tokens_total": 2 * (GEN_MAX_LEN - GEN_PROMPT)}
    emit(out)
    return launches


def launch_counts(kernels):
    dk, fk = kernels.decode_attention, kernels.flash_attention
    return {"flash_attention": fk.launches,
            fk.NAME_QUANT: fk.launches_quant,
            dk.NAME: dk.launches, dk.NAME_SLAB: dk.launches_slab,
            dk.NAME_PAGED: dk.launches_paged,
            dk.NAME_PAGED_CHUNK: dk.launches_paged_chunk,
            dk.NAME_I8: dk.launches_i8, dk.NAME_SLAB_I8: dk.launches_slab_i8,
            dk.NAME_PAGED_I8: dk.launches_paged_i8,
            dk.NAME_PAGED_CHUNK_I8: dk.launches_paged_chunk_i8}


def check_streams(torch, transformer, params, prompts, outs, what,
                  kv_dtype=None, heads=HEADS):
    """Each stream against lm_generate (over the same KV dtype) on the
    card, up to its first reference margin below MARGIN_TOL; returns the
    tokens compared."""
    checked = 0
    for i, (prompt, toks) in enumerate(zip(prompts, outs)):
        p = np.asarray([prompt], np.int32)
        ref = transformer.lm_generate(params, p, p.shape[1] + len(toks),
                                      heads, kv_dtype=kv_dtype)
        marg = margins(torch, transformer, params, ref, kv_dtype, heads)[0]
        n, ok = compare(toks, ref[0, p.shape[1]:].tolist(),
                        marg[p.shape[1] - 1:])
        if not ok:
            fail(f"{what}: request {i} (prompt {p.shape[1]}) disagrees with "
                 f"lm_generate within its first {n + 1} tokens above margin "
                 f"{MARGIN_TOL}")
        checked += n
    return checked


def serve_http(torch, kernels, engine, prompts, n_tok, starts,
               headers=None):
    """Put ``engine`` behind the HTTP server and POST each prompt to
    /v1/generate from its own thread ``starts[i]`` seconds in, every
    third streamed (``headers[i]``, if given, added to request i).
    Returns the run's record: results [(status, tokens)], inter-token
    gaps of the streamed ones (s), errors, seconds, steps, launches
    (counts set to 0 just before), the metrics snapshot, the /metrics
    text, the X-Trace-Id of each response, and the batcher (still
    open)."""
    from paddle_tpu_torch.serving import GenerationBatcher, make_server
    gen = GenerationBatcher(engine, default_max_tokens=n_tok)
    httpd = make_server(None, port=0, gen_batcher=gen)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.port}/v1/generate"
    results, gaps, errors = [None] * len(prompts), [], []
    trace_ids = [None] * len(prompts)

    def client(i):
        time.sleep(starts[i])
        body = {"prompt": prompts[i], "max_tokens": n_tok,
                "stream": i % 3 == 0}
        req = urllib.request.Request(base, data=json.dumps(body).encode(),
                                     headers={"Content-Type":
                                              "application/json",
                                              **(headers[i] if headers
                                                 else {})})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                trace_ids[i] = r.headers.get("X-Trace-Id")
                if not body["stream"]:
                    results[i] = (r.status, json.loads(r.read())["tokens"])
                    return
                toks, stamps = [], []
                for line in r:
                    rec = json.loads(line)
                    if "token" in rec:
                        toks.append(rec["token"])
                        stamps.append(time.perf_counter())
                    elif rec.get("done"):
                        results[i] = (r.status, toks)
                gaps.extend(np.diff(stamps).tolist())
        except Exception as e:    # noqa: BLE001 — reported by the caller
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    kernels.reset_launches()
    steps0 = engine.metrics.decode_steps_total
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    torch.cuda.synchronize()
    run = {"seconds": time.perf_counter() - t0,
           "launches": launch_counts(kernels),
           "steps": engine.metrics.decode_steps_total - steps0,
           "snapshot": engine.metrics.snapshot(), "results": results,
           "gaps": gaps, "errors": errors, "gen": gen,
           "trace_ids": trace_ids}
    with urllib.request.urlopen(base.replace("/v1/generate", "/metrics"),
                                timeout=60) as r:
        run["metrics_text"] = r.read().decode()
    httpd.shutdown()
    httpd.server_close()
    server.join(30)
    return run


def serve_record(run, n_tok):
    """The timing half of a serve phase's line."""
    n_req = len(run["results"])
    snap = run["snapshot"]
    return {"requests": n_req, "max_tokens": n_tok,
            "seconds": run["seconds"], "steps": run["steps"],
            "launches": run["launches"],
            "tokens_per_s": n_req * n_tok / run["seconds"],
            "stream_inter_token_ms": {
                "p50": float(np.percentile(run["gaps"], 50)) * 1e3,
                "p99": float(np.percentile(run["gaps"], 99)) * 1e3},
            "step_ms": snap["tpot_ms"], "ttft_ms": snap["ttft_ms"]}


def check_served(run, n_tok, what):
    if run["errors"] or any(r is None or r[0] != 200 or len(r[1]) != n_tok
                            for r in run["results"]):
        fail(f"{what}: not every request completed with 200 and {n_tok} "
             f"tokens: {run['errors'] or run['results']}")


def run_serve(torch, dev, transformer, kernels, params, rng,
              kv_dtype="float32"):
    """The HTTP server on the chunked slab step (phase "serve", or
    "serve_int8" over an int8 KV cache): 12 staggered requests, the chunk
    kernel of the cache's dtype once per layer per step, each stream held
    against lm_generate over the same cache dtype."""
    from paddle_tpu_torch.serving import DecodeEngine
    dk = kernels.decode_attention
    int8 = kv_dtype == "int8"
    phase, kernel = ("serve_int8", dk.NAME_I8) if int8 else ("serve",
                                                             dk.NAME)
    engine = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                          max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                          kv_dtype=kv_dtype, name="base_lm", device=dev)
    n_req, n_tok = 12, 32
    lengths = np.linspace(3, 120, n_req).astype(int)
    prompts = [rng.randint(3, VOCAB, n).tolist() for n in lengths]
    # staggered: admissions land mid-decode
    run = serve_http(torch, kernels, engine, prompts, n_tok,
                     [0.03 * i for i in range(n_req)])
    run["gen"].close()
    check_served(run, n_tok, phase)
    launches, steps = run["launches"], run["steps"]
    other = dk.NAME if int8 else dk.NAME_I8
    if launches[kernel] != LAYERS * steps or launches[other]:
        fail(f"{phase}: chunk kernels launched {kernel} "
             f"{launches[kernel]}, {other} {launches[other]} times over "
             f"{steps} steps, want {LAYERS * steps} and 0")
    int8_line = f"{engine.metrics.name}_kv_cache_int8 {int(int8)}"
    if int8_line not in run["metrics_text"].splitlines():
        fail(f"{phase}: /metrics lacks the line {int8_line!r}")
    checked = check_streams(torch, transformer, params, prompts,
                            [r[1] for r in run["results"]], phase,
                            kv_dtype)
    emit({"phase": phase, "kv_dtype": kv_dtype,
          "prompt_lengths": lengths.tolist(),
          **serve_record(run, n_tok),
          "tokens_checked_vs_lm_generate": checked,
          "tokens_total": n_req * n_tok, "metrics_line": int8_line,
          "note": "tokens compared up to each stream's first reference "
                  f"top-1/top-2 margin below {MARGIN_TOL} (random weights "
                  "give small margins)"})
    return launches


def paged_prompts(rng):
    """12 prompts: six share a 64-token preamble (request 3 is the
    preamble alone); requests 2 and 7 repeat requests 0 and 1 exactly."""
    pre = rng.randint(3, VOCAB, PREAMBLE).tolist()
    prompts = []
    for i, (shared, n) in enumerate(((1, 13), (0, 30), (1, 0), (1, 0),
                                     (0, 55), (1, 25), (0, 90), (0, 0),
                                     (1, 41), (0, 120), (1, 3), (0, 17))):
        if i == 2 or i == 7:
            prompts.append(list(prompts[i - 2 if i == 2 else 1]))
        else:
            prompts.append((pre if shared else [])
                           + rng.randint(3, VOCAB, n).tolist())
    return prompts


def run_serve_paged(torch, dev, transformer, kernels, params, rng):
    """The server on the paged layout with a pool a quarter of the slab's
    size.  Requests 0 and 1 come first, request 2 (0's duplicate: a
    prefix hit whose first write forks the shared tail block) and 3 after
    them, the other eight in one burst whose growth outruns the pool."""
    from paddle_tpu_torch.serving import DecodeEngine
    engine = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                          max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                          kv_layout="paged", kv_block_size=PAGE_BS,
                          kv_num_blocks=PAGED_POOL, name="base_lm_paged",
                          device=dev)
    n_tok = 32
    prompts = paged_prompts(rng)
    starts = [0.0, 0.0, 0.15, 0.15] + [0.3] * 8
    run = serve_http(torch, kernels, engine, prompts, n_tok, starts)
    outs = [r[1] if r else None for r in run["results"]]
    check_served(run, n_tok, "serve_paged")
    gen, burst = run["gen"], []
    if not run["snapshot"]["evictions"]["pool_exhausted"]:
        # arrival timing did not run the pool dry: eight long requests at
        # once through the same engine do (8 x 10 blocks > 32)
        burst = [rng.randint(3, VOCAB, 120).tolist() for _ in range(SLOTS)]
        steps0 = engine.metrics.decode_steps_total
        futs = [gen.submit(p, max_tokens=n_tok) for p in burst]
        outs += [f.result(timeout=300)["tokens"] for f in futs]
        torch.cuda.synchronize()
        run["steps"] += engine.metrics.decode_steps_total - steps0
        run["launches"] = launch_counts(kernels)
    gen.close()
    snap = engine.metrics.snapshot()
    engine._paged.check()
    launches, steps = run["launches"], run["steps"]
    if launches["decode_attention_paged_chunk"] != LAYERS * steps:
        fail(f"serve_paged: paged chunk kernel launched "
             f"{launches['decode_attention_paged_chunk']} times over "
             f"{steps} steps, want {LAYERS * steps}")
    counts = {"prefix_cache_hits": snap["prefix_cache_hits_total"],
              "prefix_cache_misses": snap["prefix_cache_misses_total"],
              "cow_forks": snap["cow_forks_total"],
              "preemptions": snap["evictions"]["pool_exhausted"],
              "reseats": snap["slot_reprefills_total"]}
    if not (counts["prefix_cache_hits"] > 0 and counts["cow_forks"] > 0
            and counts["preemptions"] > 0):
        fail(f"serve_paged: want prefix hits, copy-on-write forks and a "
             f"pool-exhausted preemption, got {counts}")
    checked = check_streams(torch, transformer, params, prompts + burst,
                            outs, "serve_paged")
    emit({"phase": "serve_paged", "block_size": PAGE_BS,
          "pool_blocks": PAGED_POOL, "slab_equivalent_blocks": PAGE_BLOCKS,
          "prompt_lengths": [len(p) for p in prompts],
          **serve_record(run, n_tok), "burst_requests": len(burst),
          **counts, "kv_blocks_free_after": snap["kv_blocks_free"],
          "tokens_checked_vs_lm_generate": checked,
          "tokens_total": len(outs) * n_tok})
    return launches


def run_ladder(torch, dev, transformer, kernels, params, rng,
               kv_dtype="float32", heads=HEADS, layers=LAYERS,
               layouts=("slab", "paged")):
    """The legacy prefill ladder (phase "ladder", or "ladder_int8" over
    an int8 KV cache; at another head count "ladder_dh<width>..."): 8
    staggered requests straight to the batcher on each of ``layouts``;
    the prefill's flash kernel once per layer per prefill batch, the
    Tq=1 kernel once per layer per step, both of the cache's dtype.
    Returns each layout's launches."""
    from paddle_tpu_torch.serving import DecodeEngine, GenerationBatcher
    dk, fk = kernels.decode_attention, kernels.flash_attention
    int8 = kv_dtype == "int8"
    prompts = [rng.randint(3, VOCAB, n).tolist() for n in LADDER_PROMPTS]
    phase = "ladder" if heads == HEADS else f"ladder_dh{D_MODEL // heads}"
    record = {"phase": phase + ("_int8" if int8 else ""),
              "kv_dtype": kv_dtype, "heads": heads,
              "head_dim": D_MODEL // heads, "layers": layers,
              "prompt_lengths": list(LADDER_PROMPTS)}
    launches = {}
    flash = fk.NAME_QUANT if int8 else "flash_attention"
    for layout, step_kernel in (
            (lay, {"slab": dk.NAME_SLAB_I8 if int8 else dk.NAME_SLAB,
                   "paged": dk.NAME_PAGED_I8 if int8 else dk.NAME_PAGED}[lay])
            for lay in layouts):
        engine = DecodeEngine(params, num_heads=heads, num_slots=SLOTS,
                              max_len=SERVE_MAX_LEN, prefill_chunk=0,
                              kv_layout=layout, kv_block_size=PAGE_BS,
                              kv_dtype=kv_dtype, name=f"ladder_{layout}",
                              device=dev)
        gen = GenerationBatcher(engine)
        kernels.reset_launches()
        steps0 = engine.metrics.decode_steps_total
        batches0 = engine.prefill_batches_total
        t0 = time.perf_counter()
        futs = []
        for p in prompts:
            futs.append(gen.submit(p, max_tokens=LADDER_TOKENS))
            time.sleep(0.01)
        outs = [f.result(timeout=300)["tokens"] for f in futs]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = launch_counts(kernels)
        steps = engine.metrics.decode_steps_total - steps0
        batches = engine.prefill_batches_total - batches0
        snap = engine.metrics.snapshot()
        gen.close()
        want = {flash: layers * batches, step_kernel: layers * steps}
        if any(got[k] != want.get(k, 0) for k in got) \
                or any(len(o) != LADDER_TOKENS for o in outs):
            fail(f"{record['phase']} ({layout}): launches {got} over "
                 f"{batches} prefill batches and {steps} steps, want {want} "
                 f"and no other; tokens {[len(o) for o in outs]}")
        record[layout] = {
            "seconds": dt, "steps": steps, "prefill_batches": batches,
            "launches": {k: n for k, n in got.items() if n},
            "tokens_per_s": len(prompts) * LADDER_TOKENS / dt,
            "step_ms": snap["tpot_ms"], "ttft_ms": snap["ttft_ms"],
            "tokens_checked_vs_lm_generate": check_streams(
                torch, transformer, params, prompts, outs,
                f"{record['phase']} ({layout})", kv_dtype, heads),
            "tokens_total": len(prompts) * LADDER_TOKENS}
        launches[layout] = got
    emit(record)
    return launches


def run_generate_int8(torch, dev, transformer, kernels, params, rng):
    """lm_generate over an int8 KV cache at the generate phase's shape:
    flash_attention_quant once per layer (the float32 flash kernel not
    at all); the int8 prefill's logits within LOGIT_ERR_BUDGET of its
    float32 twin's; the greedy prefix each stream shares with the float32
    stream reported; two rows held against the same call on the CPU; and
    the int8 KV quantizer on the card against the CPU's on the same
    inputs, bit for bit (check_kv_quantizer)."""
    from paddle_tpu_torch.quant import kv as kvq
    fk = kernels.flash_attention
    prompt = rng.randint(3, VOCAB, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    transformer.lm_generate(params, prompt[:2], GEN_PROMPT + 4, HEADS,
                            kv_dtype="int8")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ids = transformer.lm_generate(params, prompt, GEN_MAX_LEN, HEADS,
                                  kv_dtype="int8")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts(kernels)
    if launches[fk.NAME_QUANT] != LAYERS or launches["flash_attention"]:
        fail(f"lm_generate(kv_dtype='int8') launched flash_attention_quant "
             f"{launches[fk.NAME_QUANT]} and flash_attention "
             f"{launches['flash_attention']} times, want {LAYERS} and 0")
    ids_np = ids.cpu().numpy()
    if ids_np.shape != (GEN_BATCH, GEN_MAX_LEN) \
            or not (ids_np[:, :GEN_PROMPT] == prompt).all() \
            or ids_np.min() < 0 or ids_np.max() >= VOCAB:
        fail("lm_generate(kv_dtype='int8') output is malformed")
    # the int8 prefill against its float32 twin on the same prompts
    h8, _ = transformer.lm_prefill(params, prompt, GEN_PROMPT, HEADS,
                                   kv_dtype="int8")
    h32, _ = transformer.lm_prefill(params, prompt, GEN_PROMPT, HEADS)
    err = kvq.logit_err(transformer._lm_project(params, h32),
                        transformer._lm_project(params, h8))
    if not float(err.max()) <= kvq.LOGIT_ERR_BUDGET:
        fail(f"int8 lm_prefill logit error {float(err.max())} exceeds the "
             f"budget {kvq.LOGIT_ERR_BUDGET}")
    f32_ids = transformer.lm_generate(params, prompt, GEN_MAX_LEN,
                                      HEADS).cpu().numpy()
    prefix = [kvq.greedy_prefix_len(a[GEN_PROMPT:], b[GEN_PROMPT:])
              for a, b in zip(ids_np, f32_ids)]
    cpu_params = transformer.tree_map(lambda x: x.cpu(), params)
    ref = transformer.lm_generate(cpu_params, prompt[:2], GEN_MAX_LEN,
                                  HEADS, kv_dtype="int8")
    marg = margins(torch, transformer, cpu_params, ref, "int8")
    ref_np = ref.numpy()
    checked = 0
    for r in range(2):
        n, ok = compare(ids_np[r, GEN_PROMPT:], ref_np[r, GEN_PROMPT:],
                        marg[r, GEN_PROMPT - 1:])
        if not ok:
            fail(f"lm_generate(kv_dtype='int8') row {r}: card and CPU "
                 f"disagree within the first {n + 1} tokens above margin "
                 f"{MARGIN_TOL}")
        checked += n
    quantizer = check_kv_quantizer(torch, dev, transformer, params,
                                   prompt[:8], rng)
    emit({"phase": "generate_int8", "batch": GEN_BATCH, "prompt": GEN_PROMPT,
          "max_len": GEN_MAX_LEN, "seconds": dt,
          "emitted_tokens_per_s": GEN_BATCH * (GEN_MAX_LEN - GEN_PROMPT)
          / dt, "launches": {k: n for k, n in launches.items() if n},
          "prefill_logit_err_vs_f32": {"max": float(err.max()),
                                       "mean": float(err.mean()),
                                       "budget": kvq.LOGIT_ERR_BUDGET},
          "greedy_prefix_vs_f32": {"min": min(prefix),
                                   "median": float(np.median(prefix)),
                                   "max": max(prefix),
                                   "of": GEN_MAX_LEN - GEN_PROMPT},
          "cpu_tokens_checked": checked,
          "cpu_tokens_total": 2 * (GEN_MAX_LEN - GEN_PROMPT),
          "quantize_heads_vs_cpu": quantizer})
    return launches


def run_serve_paged_int8(torch, dev, transformer, kernels, params, rng):
    """The server on the paged layout over an int8 KV cache with the auto
    pool (twice the float32 slab's block count in fewer bytes): the 12
    paged_prompts requests with their shared 64-token preamble and two
    exact duplicates.  The int8 paged chunk kernel launches once per layer
    per step; the prefix cache hits and an int8 block is forked
    (copy-on-write, its scales with it); every stream is held against the
    int8 lm_generate; the pool's KV bytes are reported beside the float32
    slab's."""
    from paddle_tpu_torch.serving import DecodeEngine
    dk = kernels.decode_attention
    engine = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                          max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                          kv_layout="paged", kv_block_size=PAGE_BS,
                          kv_dtype="int8", name="base_lm_paged_int8",
                          device=dev)
    blocks = engine._paged.pool.num_blocks
    if blocks != 2 * (PAGE_BLOCKS - 1) + 1:
        fail(f"serve_paged_int8: auto pool of {blocks} blocks, want "
             f"{2 * (PAGE_BLOCKS - 1) + 1}")
    pool_bytes = sum(t.numel() * t.element_size() for c in engine._cache
                     for t in c.values())
    slab_bytes = LAYERS * 2 * SLOTS * SERVE_MAX_LEN * D_MODEL * 4
    n_tok = 32
    prompts = paged_prompts(rng)
    starts = [0.0, 0.0, 0.15, 0.15] + [0.3] * 8
    run = serve_http(torch, kernels, engine, prompts, n_tok, starts)
    run["gen"].close()
    check_served(run, n_tok, "serve_paged_int8")
    snap = engine.metrics.snapshot()
    engine._paged.check()
    launches, steps = run["launches"], run["steps"]
    if launches[dk.NAME_PAGED_CHUNK_I8] != LAYERS * steps \
            or launches[dk.NAME_PAGED_CHUNK]:
        fail(f"serve_paged_int8: int8 paged chunk kernel launched "
             f"{launches[dk.NAME_PAGED_CHUNK_I8]} times over {steps} steps "
             f"(want {LAYERS * steps}), float32 "
             f"{launches[dk.NAME_PAGED_CHUNK]} (want 0)")
    counts = {"prefix_cache_hits": snap["prefix_cache_hits_total"],
              "prefix_cache_misses": snap["prefix_cache_misses_total"],
              "cow_forks": snap["cow_forks_total"],
              "preemptions": snap["evictions"]["pool_exhausted"]}
    if not (counts["prefix_cache_hits"] > 0 and counts["cow_forks"] > 0):
        fail(f"serve_paged_int8: want prefix hits and copy-on-write forks "
             f"of int8 blocks, got {counts}")
    if f"{engine.metrics.name}_kv_cache_int8 1" \
            not in run["metrics_text"].splitlines():
        fail("serve_paged_int8: /metrics does not show kv_cache_int8 1")
    checked = check_streams(torch, transformer, params, prompts,
                            [r[1] for r in run["results"]],
                            "serve_paged_int8", "int8")
    emit({"phase": "serve_paged_int8", "kv_dtype": "int8",
          "block_size": PAGE_BS, "pool_blocks": blocks,
          "f32_slab_equivalent_blocks": PAGE_BLOCKS,
          "pool_kv_bytes": pool_bytes, "f32_slab_kv_bytes": slab_bytes,
          "prompt_lengths": [len(p) for p in prompts],
          **serve_record(run, n_tok), **counts,
          "kv_blocks_free_after": snap["kv_blocks_free"],
          "tokens_checked_vs_lm_generate": checked,
          "tokens_total": len(prompts) * n_tok})
    return launches


def serve_prompts(rng):
    """The serve phase's 12 prompts (3 to 120 tokens) and starts."""
    lengths = np.linspace(3, 120, 12).astype(int)
    return ([rng.randint(3, VOCAB, n).tolist() for n in lengths],
            [0.03 * i for i in range(12)])


def compare_twin(torch, transformer, params, prompts, outs, ref_outs, what,
                 kv_dtype=None):
    """Each stream against another engine's stream of the same request,
    up to the first margin below MARGIN_TOL over the reference stream;
    returns the tokens compared."""
    checked = 0
    for i, (prompt, toks, ref) in enumerate(zip(prompts, outs, ref_outs)):
        ids = np.asarray([list(prompt) + list(ref)], np.int32)
        marg = margins(torch, transformer, params, ids, kv_dtype)[0]
        n, ok = compare(toks, ref, marg[len(prompt) - 1:])
        if not ok:
            fail(f"{what}: request {i} disagrees with the non-speculating "
                 f"engine within its first {n + 1} tokens above margin "
                 f"{MARGIN_TOL}")
        checked += n
    return checked


def step_line(run, n_tok):
    """A serve run's timing line with the launches a step beside it."""
    steps = max(run["steps"], 1)
    rec = serve_record(run, n_tok)
    rec["launches"] = {k: n for k, n in rec["launches"].items() if n}
    rec["launches_per_step"] = {k: n / steps
                                for k, n in rec["launches"].items()}
    return rec


def w8_prompt(seed):
    """serve_w8's prefill prompts: 8 of GEN_PROMPT tokens from their own
    seed, so that a CPU run can read the same prefill on the same weights
    (``init_lm(torch.Generator().manual_seed(seed), ...)``: the weights
    are drawn on the CPU and moved)."""
    return np.random.RandomState(seed).randint(
        3, VOCAB, (8, GEN_PROMPT)).astype(np.int32)


def run_serve_w8(torch, dev, transformer, kernels, params, seed, rng):
    """The LM's int8 trunk (quant/weights.quantize_lm) behind the server
    in two engines: slab chunked over float32 KV, and paged chunked over
    int8 KV with the auto pool (the full-quant engine).  12 staggered
    requests each; the chunk kernel of the cache once per layer per
    step; every stream against lm_generate over the same int8 tree.

    Before serving, the card's int8 tree and its prefill are held against
    the CPU's on the same weights: quantize_lm's codes and scales bit
    for bit, and the int8 tree's prefill logits
    (w8_prompt) within W8_CPU_TOL of the port's plain CPU prefill, which
    tests/test_torch_quant_weights.py holds against the JAX package's on
    these inputs.  The logit error against the float32 tree is reported
    per stream on both devices beside quant/kv's LOGIT_ERR_BUDGET (0.06),
    the budget the JAX package's tests/test_quant.py holds its int8 trees
    to on small trunks; at this width the JAX package's own quantize_lm
    exceeds it on some streams (ROADMAP C6)."""
    from paddle_tpu_torch.quant import kv as kvq
    from paddle_tpu_torch.quant.weights import param_bytes, quantize_lm
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
    dk = kernels.decode_attention
    qparams = quantize_lm(params)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    qcpu = quantize_lm(cpu_params)
    code_diff, scale_rel, n_codes = 0, 0.0, 0
    for got, want in zip(tree_leaves(qparams), tree_leaves(qcpu),
                         strict=True):
        got = got.cpu()
        if want.dtype == torch.int8:
            code_diff = max(code_diff, int(
                (got.int() - want.int()).abs().max()))
            n_codes += int((got != want).sum())
        else:
            scale_rel = max(scale_rel, float(
                ((got - want).abs() / want.abs().clamp_min(1e-30)).max()))
    prompt = w8_prompt(seed)

    def prefill_logits(p):
        h, _ = transformer.lm_prefill(p, prompt, GEN_PROMPT, HEADS)
        return transformer._lm_project(p, h).cpu()

    l8, l32 = prefill_logits(qparams), prefill_logits(params)
    l8_cpu, l32_cpu = prefill_logits(qcpu), prefill_logits(cpu_params)
    del cpu_params, qcpu
    d8 = float((l8 - l8_cpu).abs().max())
    d32 = float((l32 - l32_cpu).abs().max())
    if n_codes or scale_rel or not d8 <= W8_CPU_TOL:
        fail(f"serve_w8: the card's int8 tree against the CPU's: codes "
             f"differ by up to {code_diff} ({n_codes} codes), scales by "
             f"{scale_rel} relative, the prefill logits by {d8} (the "
             f"float32 tree's by {d32}); want codes and scales bit for "
             f"bit, logits within {W8_CPU_TOL}")
    err = kvq.logit_err(l32, l8)
    err_cpu = kvq.logit_err(l32_cpu, l8_cpu)
    record = {"phase": "serve_w8", "param_bytes": {
                  "float32": param_bytes(params), "int8": param_bytes(qparams)},
              "vs_cpu": {"code_diff_max": code_diff,
                         "codes_differing": n_codes,
                         "scale_rel_diff_max": scale_rel,
                         "w8_prefill_logits_max_abs_diff": d8,
                         "f32_prefill_logits_max_abs_diff": d32,
                         "tolerance": W8_CPU_TOL},
              "prefill_logit_err_vs_f32": {
                  "card": err.tolist(), "cpu": err_cpu.tolist(),
                  "max": float(err.max()), "streams": len(err),
                  "within_budget": int(
                      (err <= kvq.LOGIT_ERR_BUDGET).sum()),
                  "budget": kvq.LOGIT_ERR_BUDGET}}
    n_tok = 32
    launches = {}
    for name, kw, kernel in (
            ("slab_f32kv", dict(kv_dtype="float32"), dk.NAME),
            ("paged_i8kv", dict(kv_layout="paged", kv_block_size=PAGE_BS,
                                kv_dtype="int8"), dk.NAME_PAGED_CHUNK_I8)):
        engine = DecodeEngine(qparams, num_heads=HEADS, num_slots=SLOTS,
                              max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                              name=f"w8_{name}", device=dev, **kw)
        prompts, starts = serve_prompts(rng)
        run = serve_http(torch, kernels, engine, prompts, n_tok, starts)
        run["gen"].close()
        check_served(run, n_tok, f"serve_w8 ({name})")
        got, steps = run["launches"], run["steps"]
        if got[kernel] != LAYERS * steps \
                or any(n for k, n in got.items() if k != kernel):
            fail(f"serve_w8 ({name}): launches {got} over {steps} steps, "
                 f"want {kernel} {LAYERS * steps} and no other")
        if engine._paged is not None:
            engine._paged.check()
        # the oracle: lm_generate's prefill (the flash kernel, or its
        # int8 instance) and the margins' prefill, LAYERS launches each
        kernels.reset_launches()
        checked = check_streams(torch, transformer, qparams, prompts,
                                [r[1] for r in run["results"]],
                                f"serve_w8 ({name})", kw["kv_dtype"])
        torch.cuda.synchronize()
        flash = launch_counts(kernels)[
            "flash_attention" if kw["kv_dtype"] == "float32"
            else kernels.flash_attention.NAME_QUANT]
        if flash != 2 * LAYERS * len(prompts):
            fail(f"serve_w8 ({name}): the oracle launched the prefill's "
                 f"flash kernel {flash} times, want "
                 f"{2 * LAYERS * len(prompts)}")
        record[name] = {**step_line(run, n_tok),
                        "tokens_checked_vs_lm_generate": checked,
                        "tokens_total": len(prompts) * n_tok,
                        "oracle_flash_launches": flash}
        launches[name] = dict(got, oracle_flash=flash)
    emit(record)
    return launches


def run_serve_spec(torch, dev, transformer, kernels, params, seed, rng):
    """Speculative serving (speculate_k SPEC_K, a draft of the target's
    first SPEC_DRAFT_LAYERS blocks) behind the server: slab over float32
    KV and paged over int8 KV, each beside its non-speculating twin on
    the same 12 staggered requests, then the slab twice more with other
    drafts: another seed's trunk of the same shape, and an adversarial
    one.  A random trunk at this width mostly repeats a token its tied
    embedding favours, so another seed's draft agrees with the target
    about as often as the target's own; the adversarial draft is that
    trunk with its embedding scaled by 0.01, whose blocks, not its
    embedding, then pick the token: it (almost) never agrees.  Last, the
    server's --quant-weights 1 --speculate-k engine: the slab over the
    int8 trunk (quant/weights.quantize_lm), its draft the quantized
    target's first blocks, beside a non-speculating twin over the same
    int8 trunk, streams against lm_generate over that trunk.  Every
    stream equals its twin's and lm_generate's up to its margin; every
    verify step nets at least one token; the launches are exact: the
    target's chunk kernel LAYERS a step, the draft's chunk kernel
    SPEC_DRAFT_LAYERS a rollout and its Tq=1 kernel SPEC_DRAFT_LAYERS x
    (SPEC_K - 1) a rollout."""
    from paddle_tpu_torch.quant.weights import quantize_lm
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.serving.speculative import make_draft
    dk = kernels.decode_attention
    n_tok = 32
    other = transformer.init_lm(
        torch.Generator().manual_seed(seed + 7), VOCAB, D_MODEL, HEADS,
        DFF, LAYERS, SERVE_MAX_LEN, device=dev)
    adversarial = dict(other, src_emb=other["src_emb"] * 0.01)
    qparams = quantize_lm(params)
    record = {"phase": "serve_spec", "speculate_k": SPEC_K,
              "draft_layers": SPEC_DRAFT_LAYERS}
    launches, slab_ref = {}, None
    for name, kw, target_kernel, target, draft_params in (
            ("slab_f32kv", dict(kv_dtype="float32"), dk.NAME, params,
             params),
            ("paged_i8kv", dict(kv_layout="paged", kv_block_size=PAGE_BS,
                                kv_dtype="int8"), dk.NAME_PAGED_CHUNK_I8,
             params, params),
            ("slab_f32kv_other_seed", dict(kv_dtype="float32"), dk.NAME,
             params, other),
            ("slab_f32kv_adversarial", dict(kv_dtype="float32"), dk.NAME,
             params, adversarial),
            ("w8_slab_f32kv", dict(kv_dtype="float32"), dk.NAME, qparams,
             qparams)):
        if name.startswith("slab_f32kv_"):
            # the slab run's requests, so its twin stands
            prompts, starts, twin_outs = slab_ref
            record[name] = {}
        else:
            prompts, starts = serve_prompts(rng)
            twin = DecodeEngine(target, num_heads=HEADS, num_slots=SLOTS,
                                max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                                name=f"twin_{name}", device=dev, **kw)
            twin_run = serve_http(torch, kernels, twin, prompts, n_tok,
                                  starts)
            twin_run["gen"].close()
            check_served(twin_run, n_tok, f"serve_spec twin ({name})")
            record[name] = {"twin": step_line(twin_run, n_tok)}
            twin_outs = [r[1] for r in twin_run["results"]]
            slab_ref = slab_ref or (prompts, starts, twin_outs)
        engine = DecodeEngine(
            target, num_heads=HEADS, num_slots=SLOTS,
            max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK, speculate_k=SPEC_K,
            draft=make_draft(draft_params, SPEC_DRAFT_LAYERS),
            name=f"spec_{name}", device=dev, **kw)
        if engine._kk != CHUNK:
            fail(f"serve_spec: the step's lane width {engine._kk} is not "
                 f"the checked chunk K {CHUNK}: check the split kernels at "
                 "that K")
        r0 = engine.draft.rollouts
        run = serve_http(torch, kernels, engine, prompts, n_tok, starts)
        run["gen"].close()
        rollouts = engine.draft.rollouts - r0
        check_served(run, n_tok, f"serve_spec ({name})")
        got, steps = run["launches"], run["steps"]
        want = {target_kernel: LAYERS * steps}
        want[dk.NAME] = want.get(dk.NAME, 0) + SPEC_DRAFT_LAYERS * rollouts
        want[dk.NAME_SLAB] = SPEC_DRAFT_LAYERS * (SPEC_K - 1) * rollouts
        if any(got[k] != want.get(k, 0) for k in got):
            fail(f"serve_spec ({name}): launches {got} over {steps} steps "
                 f"and {rollouts} rollouts, want {want} and no other")
        if engine._paged is not None:
            engine._paged.check()
        outs = [r[1] for r in run["results"]]
        snap = run["snapshot"]
        # tokens each verify run delivered -> runs: one run for each
        # speculating slot-step, each netting at least one token
        runs = run["gen"].verify_runs
        if not (snap["drafted_tokens_total"] > 0 and runs
                and min(runs) >= 1
                and sum(runs.values()) == snap["spec_slot_steps_total"]):
            fail(f"serve_spec ({name}): no draft lanes scored, or verify "
                 f"runs {dict(runs)} do not each net a token over "
                 f"{snap['spec_slot_steps_total']} speculating slot-steps")
        if name.endswith("_adversarial") \
                and not snap["spec_acceptance_rate"] < 0.5:
            fail(f"serve_spec ({name}): the adversarial draft accepted "
                 f"{snap['spec_acceptance_rate']} of its lanes")
        what = f"serve_spec ({name})"
        line = {**step_line(run, n_tok), "rollouts": rollouts,
                "launches_per_rollout": {
                    dk.NAME_SLAB: got[dk.NAME_SLAB] / max(rollouts, 1)},
                "spec_acceptance_rate": snap["spec_acceptance_rate"],
                "spec_tokens_per_step": snap["spec_tokens_per_step"],
                "spec_steps": snap["spec_steps_total"],
                "verify_runs_by_tokens": dict(sorted(runs.items())),
                "tokens_checked_vs_twin": compare_twin(
                    torch, transformer, target, prompts, outs, twin_outs,
                    what, kw["kv_dtype"]),
                "tokens_checked_vs_lm_generate": check_streams(
                    torch, transformer, target, prompts, outs, what,
                    kw["kv_dtype"]),
                "tokens_total": len(prompts) * n_tok}
        if "twin" in record[name]:
            line["tokens_per_s_vs_twin"] = (
                line["tokens_per_s"] / record[name]["twin"]["tokens_per_s"])
        record[name].update(spec=line)
        launches[name] = got
    emit(record)
    return launches


def run_train(torch, dev, kernels, hidden=LSTM_D, check_batch=None):
    """bench_lstm at ``hidden`` on the card: the first step against the
    CPU (at ``check_batch`` rows, the bench's 64 unless given: the route
    is the same), then warm-up and TRAIN_STEPS timed steps at batch 64
    with the launch counts read.  h=512 is the phase "train" (the
    resident kernels); larger h are "train_lstm<h>" (the blocked
    forward, the backward in plain torch)."""
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves
    phase = "train" if hidden == LSTM_D else f"train_lstm{hidden}"

    def rel(got, want):
        return [float((g.detach().cpu() - w.detach()).abs().max()
                      / w.detach().abs().max()) for g, w in zip(got, want)]

    kw = {} if check_batch is None else {"batch": check_batch}
    card_run = bench.bench_lstm(hidden=hidden, device=dev, **kw)
    cpu_run = bench.bench_lstm(hidden=hidden, device="cpu", **kw)
    before = [p.detach().clone() for p in tree_leaves(cpu_run.params)]
    first = float(card_run.train_step())
    first_cpu = float(cpu_run.train_step())
    card_leaves = tree_leaves(card_run.params)
    cpu_leaves = tree_leaves(cpu_run.params)
    card_mom = [m.cpu() for m in
                tree_leaves(card_run.opt_state["slots"]["mom"])]
    leaf_err = rel([p.grad for p in card_leaves],
                   [q.grad for q in cpu_leaves])
    param_err = rel(card_leaves, cpu_leaves)
    mom_err = rel(card_mom, tree_leaves(cpu_run.opt_state["slots"]["mom"]))
    # both sides start from the same params (made on the host from one
    # seed); the card's step must have added its slot to them.  Held as
    # p1 - (p0 + mom), both sides rounded alike, not as (p1 - p0) vs mom,
    # where p1's own rounding is already 1 % of the step.
    step_err = [float((p.detach().cpu() - (w + m)).abs().max()
                      / m.abs().max())
                for p, w, m in zip(card_leaves, before, card_mom)]
    loss_err = abs(first - first_cpu) / abs(first_cpu)
    worst = max(leaf_err + param_err + mom_err + step_err + [loss_err])
    if not worst <= TRAIN_REL_TOL:
        fail(f"{phase}: first step on the card vs the CPU: loss rel err "
             f"{loss_err}, per-leaf rel err of grads {leaf_err}, of params "
             f"{param_err}, of mom {mom_err}, of the card's step vs its "
             f"mom {step_err} (bound {TRAIN_REL_TOL})")
    del cpu_run
    if check_batch is not None:
        card_run = bench.bench_lstm(hidden=hidden, device=dev)
        first = float(card_run.train_step())
    for _ in range(TRAIN_WARMUP):
        card_run.train_step()
    torch.cuda.synchronize()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = card_run.train_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    lk, bk = kernels.lstm, kernels.lstm_blocked
    launches = {lk.NAME_FWD: lk.launches_fwd, lk.NAME_BWD: lk.launches_bwd,
                bk.NAME_FWD: bk.launches_fwd}
    want = bench.NUM_LAYERS * TRAIN_STEPS
    expect = ({lk.NAME_FWD: want, lk.NAME_BWD: want, bk.NAME_FWD: 0}
              if hidden == LSTM_D else
              {lk.NAME_FWD: 0, lk.NAME_BWD: 0, bk.NAME_FWD: want})
    if launches != expect:
        fail(f"{phase}: LSTM kernels launched {launches} over {TRAIN_STEPS} "
             f"steps, want {expect} (one per layer per step)")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < first:
        fail(f"{phase}: loss not finite or not falling: first {first}, "
             f"timed steps {losses}")
    ms = float(np.median(times))
    emit({"phase": phase, "config": {
        "vocab": 30000, "emb": bench.EMB_DIM, "hidden": card_run.hidden,
        "layers": bench.NUM_LAYERS, "batch": 64, "seq_len": 100},
        "warmup": 1 + TRAIN_WARMUP, "steps": TRAIN_STEPS,
        "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times), max(times)],
        "tflop_per_s": card_run.flops_per_step / (ms / 1e3) / 1e12,
        "launches": launches, "loss_first": first, "loss_last": losses[-1],
        "first_step_vs_cpu": {"batch": check_batch or 64,
                              "loss_rel_err": loss_err,
                              "grad_rel_err_max": max(leaf_err),
                              "param_rel_err_max": max(param_err),
                              "mom_rel_err_max": max(mom_err),
                              "step_vs_mom_rel_err_max": max(step_err),
                              "bound": TRAIN_REL_TOL}})
    return launches


def leaf_names(tree, prefix=""):
    """Each leaf's path, in ``tree_leaves``' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}.{k}" if prefix
                                    else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


@contextlib.contextmanager
def ffn_probe(torch, transformer, record, signs=None):
    """Within it, the model's FFNs append each ReLU pre-activation (on
    the CPU, in call order) to ``record``; with ``signs`` (masks in the
    same order) each FFN keeps the positions its mask gives instead of
    its own positive ones: relu's value and gradient wherever the two
    agree, the other side's decision where they do not."""
    plain = transformer._ffn
    given = None if signs is None else iter(signs)

    def ffn(blk, x):
        pre = transformer.linear.matmul(x, blk["w1"]) + blk["b1"]
        record.append(pre.detach().cpu())
        h = (torch.relu(pre) if given is None
             else pre * next(given).to(pre.device))
        return transformer.linear.matmul(h, blk["w2"]) + blk["b2"]

    transformer._ffn = ffn
    try:
        yield
    finally:
        transformer._ffn = plain


def first_step(torch, transformer, run, record, signs=None):
    """One train step of ``run`` under ``ffn_probe``: (loss, grads on
    the CPU, m slots, v slots)."""
    from paddle_tpu_torch.utils.tree import tree_leaves
    with ffn_probe(torch, transformer, record, signs):
        loss = float(run.train_step())
    slots = run.opt_state["slots"]
    return (loss, [p.grad.cpu() for p in tree_leaves(run.params)],
            [m.cpu() for m in tree_leaves(slots["m"])],
            [v.cpu() for v in tree_leaves(slots["v"])])


def run_train_transformer(torch, dev, kernels):
    """bench_transformer on the card: one step at batch 2 against the
    same step on the CPU, the CPU step that keeps the card's ReLU
    decisions, and a TF32 control; then MT_WARMUP + MT_STEPS steps at
    batch 32 with each step's flash launches read."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves
    fk = kernels.flash_attention
    card_run = bench.bench_transformer(batch=2, device=dev)
    cpu_run = bench.bench_transformer(batch=2, device="cpu")
    names = leaf_names(cpu_run.params)
    n_enc = len(cpu_run.params["enc"])
    before = [p.detach().clone() for p in tree_leaves(cpu_run.params)]
    card_pre, cpu_pre, witness_pre = [], [], []
    first, card_g, card_m, card_v = first_step(torch, transformer, card_run,
                                               card_pre)
    first_cpu, cpu_g, cpu_m, cpu_v = first_step(torch, transformer,
                                                cpu_run, cpu_pre)
    del cpu_run
    witness = first_step(torch, transformer,
                         bench.bench_transformer(batch=2, device="cpu"),
                         witness_pre, [p > 0 for p in card_pre])

    def l2(got, want):
        return [float((g - w).norm() / w.norm()) for g, w in zip(got, want)]

    def largest(got, want):
        return [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got, want)]

    def pre_err(pres):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(pres, cpu_pre)]

    grad_err = l2(card_g, cpu_g)
    slot_err = l2(card_m + card_v, cpu_m + cpu_v)
    grad_max_err = largest(card_g, cpu_g)
    witness_err = largest(card_g + card_m + card_v,
                          witness[1] + witness[2] + witness[3])
    slot_names = [f"{kind} {n}" for kind in ("grad", "m", "v")
                  for n in names]
    card_pre_err = pre_err(card_pre)
    layers = [f"enc[{i}]" if i < n_enc else f"dec[{i - n_enc}]"
              for i in range(len(cpu_pre))]
    flips, flip_dist = {}, {}
    for name, a, b in zip(layers, card_pre, cpu_pre):
        flip = (a > 0) != (b > 0)
        if flip.any():
            flips[name] = int(flip.sum())
            flip_dist[name] = float(b[flip].abs().max() / b.abs().max())
    # Adam's first step from the card's own slots, in float64: p1 - p0 =
    # -lr * m_hat / (sqrt(v_hat) + eps) with m_hat = m / (1 - 0.9) and
    # v_hat = v / (1 - 0.999).  p1 is float32: its own rounding (up to
    # one spacing of p1, 1.2e-7 for a layer-norm gain near 1 against a
    # step of ~1e-4) is taken off before the difference is held
    # relative to the leaf's largest step.
    step_err = []
    for p, p0, m, v in zip(tree_leaves(card_run.params), before, card_m,
                           card_v):
        p1 = p.detach().cpu()
        want = (-1e-4 * (m.double() / (1 - 0.9))
                / ((v.double() / (1 - 0.999)).sqrt() + 1e-8))
        spacing = (torch.nextafter(p1, torch.tensor(math.inf))
                   - p1).double()
        miss = ((p1.double() - p0.double() - want).abs()
                - spacing).clamp(min=0)
        step_err.append(float(miss.max() / want.abs().max()))
    loss_err = abs(first - first_cpu) / abs(first_cpu)
    witness_loss_err = abs(first - witness[0]) / abs(witness[0])
    if len(cpu_pre) != len(card_pre) or len(witness_pre) != len(cpu_pre) \
            or not max(card_pre_err) <= MT_PRE_TOL \
            or not max(step_err + [loss_err, witness_loss_err]
                       + witness_err) <= TRAIN_REL_TOL \
            or not max(grad_err + slot_err) <= MT_GRAD_TOL:
        fail(f"train_transformer: first step at batch 2 on the card vs the "
             f"CPU: FFN pre-activations per layer {card_pre_err} (bound "
             f"{MT_PRE_TOL}, {len(card_pre)}/{len(cpu_pre)}/"
             f"{len(witness_pre)} FFN calls), sign flips {flips}; loss rel "
             f"err {loss_err}, {witness_loss_err} vs the witness; card's "
             f"step vs its slots {step_err}; largest-entry err of grads "
             f"and m/v vs the witness "
             f"{dict(zip(slot_names, witness_err))} (bound "
             f"{TRAIN_REL_TOL}); relative L2 err vs the plain CPU step of "
             f"grads {dict(zip(names, grad_err))}, of m/v {slot_err} "
             f"(bound {MT_GRAD_TOL})")
    del card_run, witness, before
    # the control: the same step with TF32 matrix products on the card
    # (switched on after bench_transformer, whose device.resolve sets
    # them off)
    control, control_pre = bench.bench_transformer(batch=2, device=dev), []
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, tf32_g, _, _ = first_step(torch, transformer, control,
                                     control_pre)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del control
    tf32 = {"ffn_pre_rel_err_max": max(pre_err(control_pre)),
            "grad_rel_l2_err_max": max(l2(tf32_g, cpu_g)),
            "grad_largest_entry_rel_err_max": max(largest(tf32_g, cpu_g))}
    if not (tf32["ffn_pre_rel_err_max"] > MT_PRE_TOL
            or tf32["grad_rel_l2_err_max"] > MT_GRAD_TOL):
        fail(f"train_transformer: the TF32 control step passes the first "
             f"step's checks: {tf32}")
    del tf32_g, control_pre, card_pre, cpu_pre, witness_pre
    over = {n: e for n, e in zip(names, grad_max_err) if e > TRAIN_REL_TOL}
    run = bench.bench_transformer(device=dev)
    losses, times, per_step = [], [], []
    for i in range(MT_WARMUP + MT_STEPS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        loss = run.train_step()
        torch.cuda.synchronize()
        losses.append(float(loss))
        if i >= MT_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append((fk.launches, fk.launches_bwd_dkv,
                             fk.launches_bwd_dq))
    want = (MT_ATTENTIONS,) * 3
    if any(n != want for n in per_step):
        fail(f"train_transformer: per-step (forward, dK/dV, dQ) launches "
             f"{per_step}, want {want} each step")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"train_transformer: loss not finite or not falling: {losses}")
    ms = float(np.median(times))
    F32_MS["train_transformer"] = ms
    launches = dict(zip((fk.NAME, fk.NAME_BWD_DKV, fk.NAME_BWD_DQ),
                        map(sum, zip(*per_step))))
    emit({"phase": "train_transformer", "config": {
        "vocab": 32000, "d_model": 512, "heads": MT_HEADS, "dff": 2048,
        "layers": "6+6", "batch": MT_BATCH, "seq_len": MT_SEQ,
        "optimizer": "Adam lr 1e-4", "label_smoothing": 0.1,
        "full_seq": True},
        "warmup": MT_WARMUP, "steps": MT_STEPS, "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times), max(times)],
        "tokens_per_s": run.tokens_per_step / (ms / 1e3),
        "launches": launches,
        "launches_per_step": dict(zip(launches, want)),
        "loss_first": losses[0], "loss_last": losses[-1],
        "first_step_vs_cpu": {
            "batch": 2, "loss_rel_err": loss_err,
            "ffn_pre_rel_err_max": max(card_pre_err),
            "ffn_pre_bound": MT_PRE_TOL,
            "relu_sign_flips": flips,
            "flip_distance_from_0_rel_max": flip_dist,
            "vs_witness_largest_entry_rel_err_max": max(witness_err),
            "witness_loss_rel_err": witness_loss_err,
            "step_vs_slots_rel_err_max": max(step_err),
            "bound": TRAIN_REL_TOL,
            "grad_rel_l2_err_max": max(grad_err),
            "m_v_rel_l2_err_max": max(slot_err),
            "l2_bound": MT_GRAD_TOL,
            "grad_largest_entry_rel_err_max": max(grad_max_err),
            "leaves_over_bound_by_largest_entry": over,
            "tf32_control": tf32}})
    return launches


def run_train_seq2seq(torch, dev, kernels):
    """bench_seq2seq on the card: the first step against the CPU, then
    S2S_WARMUP + S2S_STEPS steps with each step's GRU launches read; then
    greedy_generate on the trained params against the CPU."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.models import seq2seq
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
    gk = kernels.gru

    def rel(got, want):
        return [float((g.detach().cpu() - w.detach()).abs().max()
                      / w.detach().abs().max()) for g, w in zip(got, want)]

    card_run = bench.bench_seq2seq(device=dev)
    cpu_run = bench.bench_seq2seq(device="cpu")
    names = leaf_names(cpu_run.params)
    losses, times, per_step = [], [], []
    for i in range(1 + S2S_WARMUP + S2S_STEPS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        loss = card_run.train_step()
        torch.cuda.synchronize()
        if i > S2S_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append((gk.launches_fwd, gk.launches_bwd))
        if i == 0:    # the first step against the CPU's
            loss_cpu = float(cpu_run.train_step())
            grad_err = rel([p.grad for p in tree_leaves(card_run.params)],
                           [p.grad for p in tree_leaves(cpu_run.params)])
            mom_err = rel(tree_leaves(card_run.opt_state["slots"]["mom"]),
                          tree_leaves(cpu_run.opt_state["slots"]["mom"]))
            loss_err = abs(losses[0] - loss_cpu) / abs(loss_cpu)
            if not max(grad_err + mom_err + [loss_err]) <= TRAIN_REL_TOL:
                fail(f"train_seq2seq: first step on the card vs the CPU: "
                     f"loss rel err {loss_err}, per-leaf rel err of grads "
                     f"{dict(zip(names, grad_err))}, of mom "
                     f"{dict(zip(names, mom_err))} (bound {TRAIN_REL_TOL})")
            del cpu_run
    want = (S2S_DIRECTIONS, S2S_DIRECTIONS)
    if any(n != want for n in per_step):
        fail(f"train_seq2seq: per-step (forward, backward) GRU launches "
             f"{per_step}, want {want} each step")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"train_seq2seq: loss not finite or not falling: {losses}")

    src = card_run.src
    kernels.reset_launches()
    t0 = time.perf_counter()
    tokens, lengths = seq2seq.greedy_generate(card_run.params, src,
                                              max_len=S2S_LEN)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    gen_launches = (gk.launches_fwd, gk.launches_bwd)
    if gen_launches != (S2S_DIRECTIONS, 0):
        fail(f"train_seq2seq: greedy_generate launched the GRU kernels "
             f"{gen_launches} (forward, backward), want ({S2S_DIRECTIONS}, "
             f"0): the lean forward once per direction")
    params_cpu = tree_map(lambda p: p.detach().cpu(), card_run.params)
    src_cpu = SequenceBatch(src.data.cpu(), src.lengths.cpu())
    ref_tokens, ref_lengths = seq2seq.greedy_generate(params_cpu, src_cpu,
                                                      max_len=S2S_LEN)
    with torch.no_grad():   # the CPU's logits at each of its steps
        prev = torch.cat([torch.zeros_like(ref_tokens[:, :1]),
                          ref_tokens[:, :-1]], dim=1)
        logits = seq2seq.forward(params_cpu, src_cpu, SequenceBatch(
            prev, torch.full_like(src_cpu.lengths, S2S_LEN)))
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    checked = [compare(g, r, m) for g, r, m in zip(
        tokens.cpu().tolist(), ref_tokens.tolist(), margin)]
    if not all(ok for _, ok in checked):
        fail(f"train_seq2seq: greedy tokens differ from the CPU's within "
             f"the margin {MARGIN_TOL}: compared/ok {checked}")
    # the margins leave most tokens unchecked, so the whole sample is also
    # held on the card's values: the encoder (lean kernels, under no_grad)
    # and every step's log-probs, teacher-forced on the CPU's tokens
    with torch.no_grad():
        enc_c = seq2seq.encode(card_run.params, src)
        enc_r = seq2seq.encode(params_cpu, src_cpu)
        logp_c = torch.log_softmax(seq2seq.forward(
            card_run.params, src, SequenceBatch(
                prev.to(dev), torch.full_like(src.lengths, S2S_LEN))), -1)
    enc_err = dict(zip(("enc", "proj", "boot"), rel(
        [enc_c[0].data, enc_c[1].data, enc_c[2]],
        [enc_r[0].data, enc_r[1].data, enc_r[2]])))
    logp_err = rel([logp_c], [torch.log_softmax(logits, -1)])[0]
    if not max(enc_err.values()) <= S2S_REL_TOL \
            or not logp_err <= S2S_REL_TOL:
        fail(f"train_seq2seq: card vs CPU on the trained params: encode "
             f"rel err {enc_err}, log-probs on the CPU's tokens {logp_err} "
             f"(bound {S2S_REL_TOL})")
    launches = {gk.NAME_FWD: sum(f for f, _ in per_step),
                gk.NAME_BWD: sum(b for _, b in per_step)}
    ms = float(np.median(times))
    emit({"phase": "train_seq2seq", "config": {
        "vocab": S2S_VOCAB, "emb": S2S_HIDDEN, "hidden": S2S_HIDDEN,
        "att": S2S_HIDDEN, "batch": S2S_BATCH, "src_len": S2S_LEN,
        "trg_len": S2S_LEN, "optimizer": "Momentum lr 0.01 m 0.9"},
        "warmup": 1 + S2S_WARMUP, "steps": S2S_STEPS, "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times), max(times)],
        "tokens_per_s": card_run.tokens_per_step / (ms / 1e3),
        "launches": launches, "launches_per_step": [
            dict(zip(launches, n)) for n in sorted(set(per_step))],
        "loss_first": losses[0], "loss_last": losses[-1],
        "first_step_vs_cpu": {"loss_rel_err": loss_err,
                              "grad_rel_err_max": max(grad_err),
                              "mom_rel_err_max": max(mom_err),
                              "bound": TRAIN_REL_TOL},
        "greedy_generate": {
            "batch": S2S_BATCH, "max_len": S2S_LEN, "ms": gen_ms,
            "launches": dict(zip(launches, gen_launches)),
            "tokens_compared": sum(n for n, _ in checked),
            "tokens": S2S_BATCH * S2S_LEN,
            "lengths_equal": bool((lengths.cpu() == ref_lengths).all()),
            "encode_rel_err": enc_err, "log_prob_rel_err": logp_err,
            "rel_bound": S2S_REL_TOL}})
    return {"train": launches, "generate": dict(zip(launches, gen_launches))}


@contextlib.contextmanager
def pool_probe(torch, record, argmax=None):
    """Swaps ``ops/sequence.seq_max_pool``: each call appends its argmax
    over time [B, D], the top-1 minus top-2 gap and the pooled values to
    ``record``.  With ``argmax`` (one [B, D] tensor per call, in call
    order) it pools at those steps instead, gradient and all: a step
    that keeps another run's decisions."""
    from paddle_tpu_torch.ops import sequence as seq_ops
    plain, given = seq_ops.seq_max_pool, iter(argmax or ())

    def probe(seq):
        valid = seq.mask(seq.data.dtype)[..., None] > 0
        top = torch.where(valid, seq.data, -1e30).detach().topk(2, dim=1)
        if argmax is None:
            out = plain(seq)
        else:
            idx = next(given).to(seq.data.device)
            out = torch.where((seq.lengths > 0)[:, None],
                              seq.data.gather(1, idx[:, None, :])[:, 0], 0.0)
        record.append({"argmax": top.indices[:, 0].cpu(),
                       "gap": (top.values[:, 0] - top.values[:, 1]).cpu(),
                       "pooled": out.detach().cpu()})
        return out

    seq_ops.seq_max_pool = probe
    try:
        yield
    finally:
        seq_ops.seq_max_pool = plain


def rnn_first_step(torch, dev, kernels, batch):
    """One SGD step of the slice's config on the card, on the CPU, and on
    a CPU witness that max-pools at the card's argmax, all from the same
    weights (SGD's seed) on ``batch``; held as RNN_TIE_TOL says.  Returns
    the card's trainer and the result record."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves
    rk = kernels.simple_rnn

    feeding = text_rnn.feeding()

    def step(device, record, argmax=None):
        tr = SGD(cost=text_rnn.build(), update_equation=text_rnn.optimizer(),
                 device=device)
        before = [p.detach().clone() for p in tr._leaves]
        with pool_probe(torch, record, argmax):
            total, _ = tr._forward(DataFeeder(feeding,
                                              device=tr.device)(batch))
        tr._backward(total)
        grads = [p.grad.detach().cpu() for p in tr._leaves]
        tr._update()
        return tr, float(total.detach()), before, grads

    def rel(got, want):
        return [float((g.detach().cpu() - w.detach()).abs().max()
                      / w.detach().abs().max()) for g, w in zip(got, want)]

    kernels.reset_launches()
    rec_c, rec_r, rec_w = [], [], []
    card, loss_c, before_c, grads_c = step(dev, rec_c)
    launches = (rk.launches_fwd, rk.launches_bwd)
    # the update descends: the batch's cost after it, in test mode
    after = card.test(lambda: iter([batch]), feeding=feeding)
    _, loss_r, _, grads_r = step("cpu", rec_r)
    witness, loss_w, _, grads_w = step("cpu", rec_w,
                                       [r["argmax"] for r in rec_c])
    names = leaf_names(witness.parameters)
    (pc,), (pr,), (pw,) = rec_c, rec_r, rec_w
    scale = float(pr["pooled"].abs().max())
    pooled_err = float((pc["pooled"] - pr["pooled"]).abs().max()) / scale
    flips = pc["argmax"] != pr["argmax"]
    flip_gap = float(pr["gap"][flips].max()) / scale if flips.any() else 0.0
    card_mom = [m.cpu() for m in tree_leaves(card.opt_state["slots"]["mom"])]
    loss_err = abs(loss_c - loss_w) / abs(loss_w)
    grad_err = rel(grads_c, grads_w)
    param_err = rel(card._leaves, witness._leaves)
    mom_err = rel(card_mom, tree_leaves(witness.opt_state["slots"]["mom"]))
    # the card's update is its own momentum added to the same start
    step_err = [float((p.detach().cpu() - (w.cpu() + m)).abs().max()
                      / m.abs().max())
                for p, w, m in zip(card._leaves, before_c, card_mom)]
    worst = max(grad_err + param_err + mom_err + step_err + [loss_err])
    if launches != (2, 2) or not pooled_err <= RNN_TIE_TOL \
            or not flip_gap <= RNN_TIE_TOL or not worst <= TRAIN_REL_TOL \
            or not after < loss_c:
        fail(f"train_rnn: first step on the card: launches {launches} (want "
             f"2, 2); the batch's cost {loss_c} before the update, {after} "
             f"after (must fall); pooled values vs the CPU rel err "
             f"{pooled_err}, "
             f"{int(flips.sum())} argmax flips with CPU gaps up to "
             f"{flip_gap} of the largest (bound {RNN_TIE_TOL}); vs the CPU "
             f"witness: loss rel err {loss_err}, per-leaf rel err of grads "
             f"{dict(zip(names, grad_err))}, of params "
             f"{dict(zip(names, param_err))}, of mom "
             f"{dict(zip(names, mom_err))}, of the card's step vs its mom "
             f"{dict(zip(names, step_err))} (bound {TRAIN_REL_TOL})")
    plain = {"loss_rel_err": abs(loss_c - loss_r) / abs(loss_r),
             "grad_largest_entry_rel_err_max": max(rel(grads_c, grads_r)),
             "grad_rel_l2_err_max": max(
                 float((g - r).norm() / r.norm())
                 for g, r in zip(grads_c, grads_r))}
    return card, launches, {
        "batch": text_rnn.BATCH, "cost_before_after_update": [loss_c, after],
        "pooled_rel_err": pooled_err,
        "argmax_flips": int(flips.sum()), "pooled_units": flips.numel(),
        "flip_gap_rel_max": flip_gap, "tie_bound": RNN_TIE_TOL,
        "vs_witness": {"loss_rel_err": loss_err,
                       "grad_rel_err_max": max(grad_err),
                       "param_rel_err_max": max(param_err),
                       "mom_rel_err_max": max(mom_err),
                       "step_vs_mom_rel_err_max": max(step_err),
                       "bound": TRAIN_REL_TOL},
        "vs_plain_cpu_step": plain}


RNN_CLI_CONFIG = """\
from paddle_tpu_torch.models import text_rnn


def get_config():
    return text_rnn.config(seed=int(CONFIG_ARGS["seed"]),
                           n_batches=int(CONFIG_ARGS["batches"]))
"""


def rnn_cli(torch, dev, seed, trainer, dtype=None, what="train_rnn",
            config=RNN_CLI_CONFIG, batches=RNN_CLI_BATCHES, fresh=None,
            config_file=None, config_args=None):
    """``python -m paddle_tpu_torch train`` as a subprocess on a config
    file written to a temp dir (``config``, the slice's by default,
    ``batches`` batches, one pass; ``--dtype dtype`` where given), or on
    the repository's ``config_file`` with ``--config_args config_args``:
    its
    pass dir must exist and ``SGD.load`` (into ``fresh()``, a new trainer
    of the same config) must restore its parameters (and model state)
    bit for bit; then ``trainer``'s own save and load round trip, bit
    for bit too."""
    import os
    import subprocess
    import tempfile
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.trainer import SGD, load_checkpoint
    from paddle_tpu_torch.utils.tree import tree_leaves
    root = os.path.dirname(os.path.abspath(__file__))

    def fresh_rnn():
        return SGD(cost=text_rnn.build(), update_equation=text_rnn.optimizer(),
                   device=dev, compute_dtype=(torch.bfloat16
                                              if dtype == "bfloat16"
                                              else None))
    fresh = fresh or fresh_rnn

    def equal(params, tree):
        return all(np.array_equal(params[k][n].detach().cpu().numpy(),
                                  np.asarray(tree[k][n]))
                   for k in tree for n in tree[k])

    with tempfile.TemporaryDirectory() as tmp:
        cfg, save = os.path.join(tmp, "rnn_config.py"), os.path.join(tmp,
                                                                    "out")
        if config_file is None:
            with open(cfg, "w") as f:
                f.write(config)
        else:
            cfg = os.path.join(root, config_file)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch", "train", "--config",
             cfg, "--config_args",
             config_args or f"seed={seed},batches={batches}",
             "--num_passes", "1", "--save_dir", save, "--log_period", "1",
             "--device", dev.type] + (["--dtype", dtype] if dtype else []),
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        pass_dir = os.path.join(save, "pass-00000")
        if run.returncode != 0 or not os.path.isdir(pass_dir):
            fail(f"{what}: the CLI exited {run.returncode} and left "
                 f"{os.listdir(save) if os.path.isdir(save) else None}: "
                 f"{run.stderr[-3000:]}")
        loaded = fresh()
        meta = loaded.load(save)
        params, opt_state, model_state, _ = load_checkpoint(save)
        state_equal = all(np.array_equal(a.cpu().numpy(), np.asarray(b))
                          for a, b in zip(tree_leaves(loaded.model_state),
                                          tree_leaves(model_state or {})))
        if not equal(loaded.parameters, params) or not state_equal \
                or loaded.opt_state["step"] != batches:
            fail(f"{what}: SGD.load of the CLI's {pass_dir} does not "
                 f"restore its parameters and model state bit for bit "
                 f"(optimizer step {loaded.opt_state['step']}, want "
                 f"{batches})")
        mine = os.path.join(tmp, "mine")
        trainer.save(mine, 0)
        again = fresh()
        again.load(mine)
        host = {k: {n: p.detach().cpu().numpy() for n, p in v.items()}
                for k, v in trainer.parameters.items()}
        if not equal(again.parameters, host) or not all(
                torch.equal(a, b) for a, b in zip(
                    tree_leaves(again.model_state),
                    tree_leaves(trainer.model_state))):
            fail(f"{what}: SGD.save then SGD.load does not restore the "
                 "trained parameters and model state bit for bit")
        cost_lines = [line for line in run.stderr.splitlines()
                      if " Cost " in line]
    return {"seconds": cli_s, "pass_dir": os.path.basename(pass_dir),
            "dtype": dtype or "auto",
            "meta_pass_id": meta["pass_id"], "batches": batches,
            "log": cost_lines[-1].split("] ", 1)[-1] if cost_lines else None,
            "load_bit_for_bit": True, "save_load_round_trip": True}


def run_train_rnn(torch, dev, kernels, seed):
    """The layer-DSL slice (models/text_rnn: 2 x recurrent_layer h=512)
    through trainer.SGD on the card: the first step against the CPU from
    the same weights, then ``SGD.train`` over RNN_BATCHES batches with
    each step's simple-RNN launches and wall time read from the events,
    ``SGD.test`` on a held-out reader, the step's split, and the CLI."""
    from paddle_tpu_torch.data import DataFeeder, reader as reader_mod
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.trainer import events
    rk = kernels.simple_rnn
    feeding = text_rnn.feeding()
    data = text_rnn.samples(seed, RNN_BATCHES * text_rnn.BATCH)

    card, first_launches, first = rnn_first_step(
        torch, dev, kernels, data[:text_rnn.BATCH])

    record = {"ms": [], "loss": [], "launches": []}

    def handler(e):
        if isinstance(e, events.BeginIteration):
            torch.cuda.synchronize()
            kernels.reset_launches()
            record["t0"] = time.perf_counter()
        elif isinstance(e, events.EndIteration):
            record["loss"].append(float(e.cost))     # a synchronize
            record["ms"].append((time.perf_counter() - record["t0"]) * 1e3)
            record["launches"].append((rk.launches_fwd, rk.launches_bwd))

    t0 = time.perf_counter()
    card.train(reader_mod.batch(lambda: iter(data), text_rnn.BATCH),
               num_passes=1, event_handler=handler, feeding=feeding,
               log_period=0)
    pass_s = time.perf_counter() - t0
    losses, per_step = record["loss"], record["launches"]
    if len(losses) != RNN_BATCHES or any(n != (2, 2) for n in per_step):
        fail(f"train_rnn: {len(losses)} steps with per-step (forward, "
             f"backward) launches {per_step}, want {RNN_BATCHES} steps of "
             f"(2, 2): one of each per recurrent layer")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_rnn: loss not finite: {losses}")
    test_cost = card.test(text_rnn.batches(seed + 1, text_rnn.TEST_BATCHES),
                          feeding=feeding)
    if not math.isfinite(test_cost):
        fail(f"train_rnn: SGD.test cost {test_cost}")
    feeder = DataFeeder(feeding, device=dev)
    split = bench.step_split(card, feeder, list(reader_mod.batch(
        lambda: iter(data), text_rnn.BATCH)()), 10)
    cli = rnn_cli(torch, dev, seed, card)
    timed = record["ms"][3:]
    ms = float(np.median(timed))
    launches = {rk.NAME_FWD: first_launches[0] + sum(f for f, _ in per_step),
                rk.NAME_BWD: first_launches[1] + sum(b for _, b in per_step)}
    emit({"phase": "train_rnn", "config": {
        "model": "models/text_rnn (layer DSL)", "vocab": text_rnn.VOCAB,
        "emb": text_rnn.EMB, "hidden": text_rnn.HIDDEN,
        "layers": text_rnn.LAYERS, "batch": text_rnn.BATCH,
        "seq_len": text_rnn.SEQ_LEN, "optimizer": "Momentum lr 0.01 m 0.9",
        "entry": "trainer.SGD.train", "batches": RNN_BATCHES},
        "steps_timed": len(timed), "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(timed), max(timed)],
        "tokens_per_s": text_rnn.BATCH * text_rnn.SEQ_LEN / (ms / 1e3),
        "tflop_per_s": bench.rnn_flops(text_rnn.BATCH, text_rnn.SEQ_LEN,
                                       text_rnn.HIDDEN) / (ms / 1e3) / 1e12,
        "pass_seconds": pass_s, "split_ms": split,
        "launches": launches, "launches_per_step": [
            dict(zip(launches, n)) for n in sorted(set(per_step))],
        "losses": losses, "test_cost": test_cost,
        "first_step_vs_cpu": first, "cli": cli})
    return launches


@contextlib.contextmanager
def moe_probe(torch, moe, record, given=None):
    """Within it, ``ops/moe.moe_ffn`` (the MoE blocks' FFN) appends per
    call, in call order, to ``record``: its own top-k mask (on the CPU),
    the router probabilities, the experts' pre-activations and the aux
    term.  With ``given`` [(mask, signs or None), ...] in the same order,
    each call routes by the given mask instead of its own and, where
    signs are given, keeps the given ReLU decisions (pre * signs: relu's
    value and gradient wherever the two agree): the CPU witness of the
    card's decisions.  The arithmetic is ``moe_ffn``'s own, which the
    phases show by comparing a run under the probe with one without it."""
    plain = moe.moe_ffn
    given = None if given is None else iter(given)

    def moe_ffn(x, params, top_k=2, act=None, return_aux=False, valid=None):
        probs = moe.router_probs(x, params["wg"])
        own = moe.top_k_mask(probs, top_k)
        mask, signs = (own, None) if given is None else next(given)
        kept = probs * mask.to(probs.device, probs.dtype)
        gates = kept / torch.clamp(kept.sum(-1, keepdim=True), min=1e-9)
        pre = torch.einsum("btd,edf->btef", x, params["w1"])
        h = act(pre) if signs is None else pre * signs.to(pre.device)
        y = torch.einsum("btef,efd->bted", h, params["w2"])
        out = torch.einsum("bted,bte->btd", y, gates)
        aux = moe.aux_load_balance_loss(probs, gates, top_k, valid)
        record.append({"mask": own.bool().cpu(),
                       "probs": probs.detach().cpu(),
                       "pre": pre.detach().cpu(), "aux": aux.detach().cpu()})
        return (out, aux) if return_aux else out

    moe.moe_ffn = moe_ffn
    try:
        yield
    finally:
        moe.moe_ffn = plain


def moe_first_step(torch, moe, run, record, given=None):
    """One train step of ``run`` under ``moe_probe``: (loss, grads on the
    CPU, m slots, v slots)."""
    from paddle_tpu_torch.utils.tree import tree_leaves
    with moe_probe(torch, moe, record, given):
        loss = float(run.train_step())
    slots = run.opt_state["slots"]
    return (loss, [p.grad.cpu() for p in tree_leaves(run.params)],
            [m.cpu() for m in tree_leaves(slots["m"])],
            [v.cpu() for v in tree_leaves(slots["v"])])


def largest_err(got, want):
    """Each pair's max abs difference over the reference's largest
    magnitude."""
    return [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for g, w in zip(got, want)]


def router_check(card_rec, cpu_rec, top_k):
    """The card's router against the CPU's on the same inputs: the
    probabilities' largest error, the rows whose top-k set differs (the
    flips) and, on the CPU, the largest gap between a flipped row's k-th
    and (k+1)-th probability (a flip within rounding is a tie)."""
    probs_err = max(largest_err([r["probs"] for r in card_rec],
                                [r["probs"] for r in cpu_rec]))
    flips, tie_gap = 0, 0.0
    for a, b in zip(card_rec, cpu_rec):
        rows = (a["mask"] != b["mask"]).any(-1)
        if rows.any():
            flips += int(rows.sum())
            top = b["probs"][rows].sort(dim=-1, descending=True).values
            tie_gap = max(tie_gap, float(
                (top[:, top_k - 1] - top[:, top_k]).max()))
    return probs_err, flips, tie_gap


def run_train_lm(torch, dev, kernels, kind):
    """bench_transformer_packed (phase "train_packed") or
    bench_transformer_moe ("train_moe") on the card.  The first step is
    held against a CPU witness on the same weights and batch that keeps
    the card's ReLU decisions (and its top-2 expert choices), the
    packed one at the bench's defaults, the MoE one at MOE_CHECK_BATCH
    rows; then LM_WARMUP + LM_STEPS steps at the defaults, each
    launching no flash kernel (the segmented / key-masked attention is
    the dense path, as JAX routes it), the loss finite and falling."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import moe
    from paddle_tpu_torch.scripts import bench
    fk = kernels.flash_attention
    phase = f"train_{kind}"
    is_moe = kind == "moe"
    make = (bench.bench_transformer_moe if is_moe
            else bench.bench_transformer_packed)
    kw = {"batch": MOE_CHECK_BATCH} if is_moe else {}
    card_run = make(device=dev, **kw)
    cpu_run = make(device="cpu", **kw)
    names = leaf_names(cpu_run.params)
    card_rec, cpu_rec = [], []
    check = {"batch": MOE_CHECK_BATCH if is_moe else card_run.tokens.data
             .shape[0]}
    if is_moe:
        # the port's moe_ffn and the probe's arithmetic: the same loss
        with torch.no_grad():
            unprobed = float(transformer.lm_loss(
                card_run.params, card_run.tokens, HEADS))
        card = moe_first_step(torch, moe, card_run, card_rec)
        witness = moe_first_step(torch, moe, cpu_run, cpu_rec,
                                 [(r["mask"], r["pre"] > 0)
                                  for r in card_rec])
        probs_err, router_flips, tie_gap = router_check(card_rec, cpu_rec,
                                                        MOE_TOP_K)
        card_pre = [r["pre"] for r in card_rec]
        cpu_pre = [r["pre"] for r in cpu_rec]
        aux = float(sum(r["aux"] for r in card_rec))
        aux_cpu = float(sum(r["aux"] for r in cpu_rec))
        aux_err = abs(aux - aux_cpu) / abs(aux_cpu)
        check.update({"probe_vs_port_loss": [card[0], unprobed],
                      "router_probs_rel_err_max": probs_err,
                      "router_flips": router_flips,
                      "router_flip_tie_gap_max": tie_gap,
                      "router_tie_bound": MOE_TIE_TOL,
                      "aux_card": aux, "aux_witness": aux_cpu,
                      "aux_rel_err": aux_err})
        if card[0] != unprobed or not probs_err <= MT_PRE_TOL \
                or not tie_gap <= MOE_TIE_TOL \
                or not aux_err <= TRAIN_REL_TOL or not math.isfinite(aux):
            fail(f"{phase}: first step's router and aux vs the CPU witness: "
                 f"{check} (bounds: probs {MT_PRE_TOL}, aux "
                 f"{TRAIN_REL_TOL})")
    else:
        card_pre, cpu_pre = [], []
        card = first_step(torch, transformer, card_run, card_pre)
        witness = first_step(torch, transformer, cpu_run, cpu_pre,
                             [p > 0 for p in card_pre])
    del cpu_run
    pre_err = largest_err(card_pre, cpu_pre)
    flips = sum(int(((a > 0) != (b > 0)).sum())
                for a, b in zip(card_pre, cpu_pre))
    del card_pre, cpu_pre, card_rec, cpu_rec
    loss_err = abs(card[0] - witness[0]) / abs(witness[0])
    leaf_err = largest_err(card[1] + card[2] + card[3],
                           witness[1] + witness[2] + witness[3])
    slot_names = [f"{k} {n}" for k in ("grad", "m", "v") for n in names]
    check.update({"loss_rel_err": loss_err, "ffn_pre_rel_err_max":
                  max(pre_err), "ffn_pre_bound": MT_PRE_TOL,
                  "relu_flips": flips,
                  "vs_witness_largest_entry_rel_err_max": max(leaf_err),
                  "bound": TRAIN_REL_TOL})
    if not max(pre_err) <= MT_PRE_TOL \
            or not max(leaf_err + [loss_err]) <= TRAIN_REL_TOL:
        fail(f"{phase}: first step on the card vs the CPU witness: "
             f"{check}; per leaf {dict(zip(slot_names, leaf_err))}")
    del witness, card
    if is_moe:
        del card_run
        card_run = make(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    for i in range(LM_WARMUP + LM_STEPS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        loss = card_run.train_step()
        torch.cuda.synchronize()
        losses.append(float(loss))
        per_step.append((fk.launches, fk.launches_bwd_dkv,
                         fk.launches_bwd_dq))
        if i >= LM_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
    if any(n != (0, 0, 0) for n in per_step):
        fail(f"{phase}: flash kernels launched {per_step} (forward, dK/dV, "
             "dQ a step), want none: the attention is the dense path")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"{phase}: loss not finite or not falling: {losses}")
    ms = float(np.median(times))
    batch = card_run.tokens.data.shape[0]
    emit({"phase": phase, "config": {
        "vocab": VOCAB, "d_model": D_MODEL, "heads": HEADS, "dff": DFF,
        "layers": LAYERS, "batch": batch,
        "slots" if not is_moe else "seq_len": card_run.tokens.data.shape[1],
        **({"experts": MOE_EXPERTS, "moe_top_k": MOE_TOP_K} if is_moe
           else {}), "optimizer": "Adam lr 1e-4", "remat": card_run.remat},
        "warmup": LM_WARMUP, "steps": LM_STEPS, "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times), max(times)],
        "real_tokens_per_s" if not is_moe else "tokens_per_s":
            card_run.tokens_per_step / (ms / 1e3),
        **({} if is_moe else {"real_tokens_per_step":
                              card_run.tokens_per_step,
                              "pack_efficiency": card_run.pack_efficiency}),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "flash_launches": 0, "loss_first": losses[0],
        "loss_last": losses[-1], "first_step_vs_cpu_witness": check})
    return {fk.NAME: 0, fk.NAME_BWD_DKV: 0, fk.NAME_BWD_DQ: 0}


def run_train_remat(torch, dev, kernels):
    """bench_transformer (the MT step at its shape) with remat=False and
    remat=True on the card: the first step's loss and every gradient
    bit for bit equal, the step's memory peak above what was allocated
    before it lower with remat; then MT_WARMUP + MT_STEPS timed steps of
    each with the flash launches read every step (the forward twice per
    attention under remat, the backward pair once)."""
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves
    fk = kernels.flash_attention
    runs = {}
    for remat in (False, True):
        run = bench.bench_transformer(remat=remat, device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        loss = run.train_step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        first = (loss.clone(), [p.grad.clone()
                                for p in tree_leaves(run.params)],
                 (fk.launches, fk.launches_bwd_dkv, fk.launches_bwd_dq))
        times, per_step, losses = [], [], [float(loss)]
        for i in range(MT_WARMUP + MT_STEPS):
            kernels.reset_launches()
            t0 = time.perf_counter()
            loss = run.train_step()
            torch.cuda.synchronize()
            losses.append(float(loss))
            per_step.append((fk.launches, fk.launches_bwd_dkv,
                             fk.launches_bwd_dq))
            if i >= MT_WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
        runs[remat] = {"first": first, "peak": peak, "times": times,
                       "per_step": [first[2]] + per_step, "losses": losses}
        del run
    off, on = runs[False], runs[True]
    loss_equal = bool(torch.equal(on["first"][0], off["first"][0]))
    grads_differing = [i for i, (a, b) in enumerate(zip(on["first"][1],
                                                        off["first"][1]))
                       if not torch.equal(a, b)]
    want = {False: (MT_ATTENTIONS,) * 3,
            True: (REMAT_FWD, MT_ATTENTIONS, MT_ATTENTIONS)}
    for remat, r in runs.items():
        if any(n != want[remat] for n in r["per_step"]):
            fail(f"train_remat: remat={remat}: per-step (forward, dK/dV, "
                 f"dQ) launches {r['per_step']}, want {want[remat]}")
        if not all(math.isfinite(x) for x in r["losses"]) \
                or not r["losses"][-1] < r["losses"][0]:
            fail(f"train_remat: remat={remat}: loss not finite or not "
                 f"falling: {r['losses']}")
    if not loss_equal or grads_differing:
        fail(f"train_remat: the first step with remat is not bit for bit "
             f"the step without: loss equal {loss_equal}, gradient leaves "
             f"differing {grads_differing}")
    if not on["peak"] < off["peak"]:
        fail(f"train_remat: the step's memory peak with remat "
             f"{on['peak']} is not below the peak without {off['peak']}")
    ms = {r: float(np.median(v["times"])) for r, v in runs.items()}
    emit({"phase": "train_remat", "config": {
        "vocab": VOCAB, "d_model": D_MODEL, "heads": MT_HEADS, "dff": DFF,
        "layers": "6+6", "batch": MT_BATCH, "seq_len": MT_SEQ,
        "optimizer": "Adam lr 1e-4", "label_smoothing": 0.1,
        "full_seq": True},
        "warmup": MT_WARMUP, "steps": MT_STEPS,
        "first_step_bit_for_bit": {"loss": loss_equal,
                                   "gradient_leaves": len(on["first"][1]),
                                   "differing": len(grads_differing)},
        "launches_per_step": {str(r): dict(zip(
            (fk.NAME, fk.NAME_BWD_DKV, fk.NAME_BWD_DQ), want[r]))
            for r in runs},
        "step_memory_peak_bytes": {"remat_false": off["peak"],
                                   "remat_true": on["peak"]},
        "ms_per_batch": {"remat_false": ms[False], "remat_true": ms[True]},
        "tokens_per_s": {str(r): MT_BATCH * MT_SEQ / (m / 1e3)
                         for r, m in ms.items()},
        "loss_first_last": {str(r): [v["losses"][0], v["losses"][-1]]
                            for r, v in runs.items()}})
    steps = 1 + MT_WARMUP + MT_STEPS
    return {fk.NAME: REMAT_FWD * steps, fk.NAME_BWD_DKV: MT_ATTENTIONS * steps,
            fk.NAME_BWD_DQ: MT_ATTENTIONS * steps}


def qtree_diff(got, want):
    """(codes differing, scales differing) between two int8 twins."""
    codes = scales = 0
    for key in want:
        codes += int((got[key]["q"].cpu() != want[key]["q"].cpu()).sum())
        scales += int((got[key]["s"].cpu() != want[key]["s"].cpu()).sum())
    if set(got) != set(want):
        codes += 1
    return codes, scales


def run_train_int8(torch, dev, kernels):
    """bench_trainer_int8 on the card: the first step against the CPU's
    (the int8 twin of the initial masters, and the card's requantization
    of its updated masters against the CPU's of the same masters, codes
    and scales bit for bit; the loss and masters within TRAIN_REL_TOL);
    then the int8 trainer beside its float32 twin over 24 batches, the
    loss gap within quant/weights.TRAIN_LOSS_BUDGET, what the trainer
    keeps between steps (bench.weights_quantized), and the step's ms."""
    from paddle_tpu_torch.quant.weights import TRAIN_LOSS_BUDGET
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
    card = bench.bench_trainer_int8(device=dev)
    cpu = bench.bench_trainer_int8(device="cpu")
    q0 = qtree_diff(card.trainer._qtree, cpu.trainer._qtree)
    first = float(card.trainer.train_one_batch(card.batches[0], card.feeder))
    first_cpu = float(cpu.trainer.train_one_batch(cpu.batches[0],
                                                  cpu.feeder))
    masters = tree_map(lambda t: t.detach().cpu(), card.trainer.parameters)
    q1 = qtree_diff(card.trainer._qtree,
                    cpu.trainer._requant(masters))
    master_err = max(largest_err(tree_leaves(masters), [
        t.detach() for t in tree_leaves(cpu.trainer.parameters)]))
    loss_err = abs(first - first_cpu) / abs(first_cpu)
    first_check = {"initial_twin_codes_scales_differing": q0,
                   "requantized_codes_scales_differing": q1,
                   "loss_rel_err": loss_err,
                   "master_largest_entry_rel_err_max": master_err,
                   "bound": TRAIN_REL_TOL}
    if q0 != (0, 0) or q1 != (0, 0) \
            or not max(loss_err, master_err) <= TRAIN_REL_TOL:
        fail(f"train_int8: the first step on the card vs the CPU: "
             f"{first_check}")
    del card, cpu, masters
    run = bench.bench_trainer_int8(device=dev)
    gap, q_losses, f_losses = bench.int8_loss_gap(run)
    if not gap <= TRAIN_LOSS_BUDGET or not all(
            math.isfinite(x) for x in q_losses) \
            or not q_losses[-1] < q_losses[0]:
        fail(f"train_int8: loss gap {gap} (budget {TRAIN_LOSS_BUDGET}); "
             f"int8 losses {q_losses}")
    shapes = bench.weights_quantized(run.trainer, others=(run.twin,))
    ms = {}
    for name, trainer in (("int8", run.trainer), ("float32", run.twin)):
        times = []
        for i in range(INT8_TRAIN_STEPS):
            t0 = time.perf_counter()
            trainer.train_one_batch(run.batches[i % len(run.batches)],
                                    run.feeder)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = float(np.median(times))
    emit({"phase": "train_int8", "config": {
        "batch": 64, "dim": 64, "hidden": 128, "batches": len(run.batches),
        "quant_min_size": 1024, "optimizer": "Momentum lr 0.01 m 0.9",
        "entry": "trainer.SGD(quant_weights=True).train_one_batch"},
        "first_step_vs_cpu": first_check,
        "loss_gap_max": gap, "loss_gap_budget": TRAIN_LOSS_BUDGET,
        "loss_int8_first_last": [q_losses[0], q_losses[-1]],
        "loss_f32_first_last": [f_losses[0], f_losses[-1]],
        "quantized_weight_shapes": [list(s) for s in shapes],
        "weights_between_steps": "int8 codes + float32 scales; no widened "
                                 "float32 copy live",
        "ms_per_batch": ms})


def run_serve_moe(torch, dev, transformer, kernels, seed, rng):
    """The LM's trunk with MOE_EXPERTS-expert top-MOE_TOP_K FFNs, random
    from ``seed``, behind the server in a slab engine over float32 KV and
    a paged engine over int8 KV: 12 staggered requests each, the chunk
    kernel of the cache once per layer per step, every stream against
    lm_generate over the same trunk.  First its prefill (w8_prompt) on
    the card against a CPU witness on the same inputs that routes by the
    card's expert choices: logits within MOE_CPU_TOL, the router's
    probabilities within MT_PRE_TOL, every flipped choice a tie; and the
    card's prefill under the probe bit for bit the one without it."""
    from paddle_tpu_torch.ops import moe
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.utils.tree import tree_map
    dk = kernels.decode_attention
    params = transformer.init_lm(
        torch.Generator().manual_seed(seed), VOCAB, D_MODEL, HEADS, DFF,
        LAYERS, SERVE_MAX_LEN, moe_experts=MOE_EXPERTS, device=dev)
    prompt = w8_prompt(seed)

    def prefill_logits(p):
        h, _ = transformer.lm_prefill(p, prompt, GEN_PROMPT, HEADS)
        return transformer._lm_project(p, h).cpu()

    card_rec, cpu_rec = [], []
    plain = prefill_logits(params)
    with moe_probe(torch, moe, card_rec):
        probed = prefill_logits(params)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    with moe_probe(torch, moe, cpu_rec, [(r["mask"], None)
                                         for r in card_rec]):
        witness = prefill_logits(cpu_params)
    del cpu_params
    probs_err, flips, tie_gap = router_check(card_rec, cpu_rec, MOE_TOP_K)
    del card_rec, cpu_rec
    diff = float((probed - witness).abs().max())
    check = {"logits_max_abs_diff": diff, "tolerance": MOE_CPU_TOL,
             "router_probs_rel_err_max": probs_err, "router_flips": flips,
             "router_flip_tie_gap_max": tie_gap,
             "probe_bit_for_bit": bool(torch.equal(plain, probed))}
    if not check["probe_bit_for_bit"] or not diff <= MOE_CPU_TOL \
            or not probs_err <= MT_PRE_TOL or not tie_gap <= MOE_TIE_TOL:
        fail(f"serve_moe: the card's prefill vs the CPU witness: {check}")
    record = {"phase": "serve_moe", "config": {
        "vocab": VOCAB, "d_model": D_MODEL, "heads": HEADS, "dff": DFF,
        "layers": LAYERS, "experts": MOE_EXPERTS, "moe_top_k": MOE_TOP_K,
        "slots": SLOTS, "max_len": SERVE_MAX_LEN, "chunk": CHUNK},
        "prefill_vs_cpu_witness": check}
    n_tok = 32
    launches = {}
    for name, kw, kernel in (
            ("slab_f32kv", dict(kv_dtype="float32"), dk.NAME),
            ("paged_i8kv", dict(kv_layout="paged", kv_block_size=PAGE_BS,
                                kv_dtype="int8"), dk.NAME_PAGED_CHUNK_I8)):
        engine = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                              max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                              name=f"moe_{name}", device=dev, **kw)
        prompts, starts = serve_prompts(rng)
        run = serve_http(torch, kernels, engine, prompts, n_tok, starts)
        run["gen"].close()
        check_served(run, n_tok, f"serve_moe ({name})")
        got, steps = run["launches"], run["steps"]
        if got[kernel] != LAYERS * steps \
                or any(n for k, n in got.items() if k != kernel):
            fail(f"serve_moe ({name}): launches {got} over {steps} steps, "
                 f"want {kernel} {LAYERS * steps} and no other")
        if engine._paged is not None:
            engine._paged.check()
        kernels.reset_launches()
        checked = check_streams(torch, transformer, params, prompts,
                                [r[1] for r in run["results"]],
                                f"serve_moe ({name})", kw["kv_dtype"])
        torch.cuda.synchronize()
        flash = launch_counts(kernels)[
            "flash_attention" if kw["kv_dtype"] == "float32"
            else kernels.flash_attention.NAME_QUANT]
        if flash != 2 * LAYERS * len(prompts):
            fail(f"serve_moe ({name}): the oracle launched the prefill's "
                 f"flash kernel {flash} times, want "
                 f"{2 * LAYERS * len(prompts)}")
        record[name] = {**step_line(run, n_tok),
                        "tokens_checked_vs_lm_generate": checked,
                        "tokens_total": len(prompts) * n_tok,
                        "oracle_flash_launches": flash}
        launches[name] = dict(got, oracle_flash=flash)
    emit(record)
    return launches


def check_kv_quantizer(torch, dev, transformer, params, prompt, rng):
    """quant/kv.quantize_heads on the card against the CPU on the same
    inputs (ROADMAP C7): the first layer's K of ``prompt`` and a wide
    spread of random magnitudes, codes and scales bit for bit.  The
    scalar division the quantizer no longer uses (PyTorch's CUDA div
    multiplies by a Python scalar's reciprocal) is counted beside it."""
    from paddle_tpu_torch.quant import kv as kvq
    blk = params["enc"][0]
    x = transformer._lm_embed(params, transformer._ids(prompt, dev))
    x = x * math.sqrt(D_MODEL) + params["pos"][:prompt.shape[1]][None]
    k = transformer.linear.matmul(transformer._ln(blk["ln1"], x),
                                  blk["attn"]["wk"])
    wide = torch.tensor(normal(rng, (64, 256, D_MODEL))
                        * np.exp(2 * normal(rng, (64, 256, 1))),
                        device=dev)
    out = {}
    for name, t in (("layer0_k", k), ("random", wide)):
        q, s = kvq.quantize_heads(t, HEADS)
        qc, sc = kvq.quantize_heads(t.cpu(), HEADS)
        scalar = t.reshape(t.shape[:-1] + (HEADS, -1)).abs().amax(-1) / 127.0
        out[name] = {"values": t.numel(), "scales": s.numel(),
                     "codes_differing": int((q.cpu() != qc).sum()),
                     "scales_differing": int((s.cpu() != sc).sum()),
                     "scalar_division_scales_differing": int(
                         (scalar.cpu() != sc).sum())}
    if any(r["codes_differing"] or r["scales_differing"]
           for r in out.values()):
        fail(f"quantize_heads on the card vs the CPU: {out}")
    return out


# ------------------------------------------------------------- bf16

def low_compare(torch, what, got, ref):
    """``got`` (a kernel's output) against ``ref`` (its plain version's)
    as BF16_F32_FLOOR says: a bf16 or float16 output within one step of
    its dtype (2^-7 or 2^-10 of its power of two) plus the floor, a
    float32 one within the floor; returns the row's error fields."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        fail(f"{what}: {got.dtype} {tuple(got.shape)}, the plain version "
             f"{ref.dtype} {tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    scale = float(r.abs().max()) or 1.0
    floor = BF16_F32_FLOOR * scale
    dtype = str(got.dtype).replace("torch.", "")
    out = {"dtype": dtype, "max_abs_err": float(diff.max()),
           "rel_err": float(diff.max()) / scale}
    bits = {torch.bfloat16: 7, torch.float16: 10}.get(got.dtype)
    if bits is not None:
        step = torch.exp2(torch.floor(torch.log2(
            r.abs().clamp(min=torch.finfo(torch.float32).tiny))) - bits)
        over = diff > step + floor
        out["differ_share"] = float((diff > 0).float().mean())
        out["max_err_in_steps"] = float((diff / step)[r != 0].max()) \
            if bool((r != 0).any()) else 0.0
        if over.any():
            fail(f"{what}: {int(over.sum())} {dtype} elements more than one "
                 f"{dtype} step (plus {BF16_F32_FLOOR} of the largest) from "
                 f"the plain version's: {out}")
    elif not out["rel_err"] <= BF16_F32_FLOOR:
        fail(f"{what}: float32 output off its plain version by {out} "
             f"(bound {BF16_F32_FLOOR} of the largest entry)")
    return out


@contextlib.contextmanager
def rounded_cotangent(torch):
    """The control of the bf16 first-step gates: within it, the card's
    products under the bf16 policy (ops/linear._MmBf16) round the float32
    cotangent to bf16 before one bf16 product each, where JAX's (and the
    sound route's) keep it float32."""
    from paddle_tpu_torch.ops import linear

    class Rounded(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return torch.mm(a, b, out_dtype=torch.float32)

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            g = g.to(a.dtype)
            return (torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype),
                    torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype))

    sound = linear._MmBf16
    linear._MmBf16 = Rounded
    try:
        yield
    finally:
        linear._MmBf16 = sound


def grad_rel_l2(got, want):
    """Each leaf's relative L2 error of ``got`` against ``want``, in
    float32 (a float16 leaf's norm may pass its range)."""
    pairs = [(g.float(), w.float()) for g, w in zip(got, want)]
    return [float((g - w).norm() / w.norm()) if float(w.norm()) else
            float(g.norm()) for g, w in pairs]


def gate_with_control(what, sound, control, limit, stat=max):
    """``stat`` (max or np.median) of ``sound`` (per-leaf errors) within
    ``limit`` and the control's above it; returns the readings."""
    out = {"grad_rel_l2_err_max": max(sound),
           "grad_rel_l2_err_median": float(np.median(sound)),
           "control_grad_rel_l2_err_max": max(control),
           "control_grad_rel_l2_err_median": float(np.median(control)),
           "gated": "max" if stat is max else "median", "limit": limit,
           "control": "the same step, its products' cotangent rounded to "
                      "bf16 (rounded_cotangent)"}
    if not stat(sound) <= limit < stat(control):
        fail(f"{what}: gradient leaves' relative L2 error vs the CPU step "
             f"{out}; the step must pass {limit} and the control fail it")
    return out


def check_matmul_grads(torch, dev, rng):
    """One product of the MT step at its shapes under the bf16 policy
    (x [MT_BATCH * MT_SEQ, 512] float32, W [512, 2048]) on the card and
    on the CPU from the same inputs: the gradients of x and W (relative
    L2) within BF16_MM_GRAD_TOL, which the rounded-cotangent control must
    fail."""
    from paddle_tpu_torch.ops import linear
    x = normal(rng, (MT_BATCH * MT_SEQ, 512))
    w = normal(rng, (512, 2048)) / math.sqrt(512)
    cot = normal(rng, (MT_BATCH * MT_SEQ, 2048))

    def grads(device):
        a = torch.tensor(x, device=device, requires_grad=True)
        b = torch.tensor(w, device=device, requires_grad=True)
        y = linear.matmul(a, b)
        (y * torch.tensor(cot, device=device)).sum().backward()
        return [a.grad.cpu(), b.grad.cpu()]

    sound = grads(dev)
    with rounded_cotangent(torch):
        control = grads(dev)
    want = grads("cpu")
    return gate_with_control("train_transformer_bf16 product (dx, dW)",
                             grad_rel_l2(sound, want),
                             grad_rel_l2(control, want), BF16_MM_GRAD_TOL)


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


RNN_LIBRARY_NOTE = ("none: no PyTorch call takes xs and W of different "
                     "dtypes, and torch.nn.RNN / LSTM / GRU in bf16 or "
                     "float16 keep their carry in that dtype (another "
                     "function)")


def low_row(torch, name, mod, replaces, kernel, plain, outs, inputs,
            flops, shape, library=None, library_note=RNN_LIBRARY_NOTE):
    """One bf16 or float16 instance against its plain version on the
    same inputs: each output compared (low_compare), a second launch bit
    for bit, times (and ``library``'s, a PyTorch call computing the same
    function, where one exists), and the bound on this run's bytes (the
    instance's dtypes: each input read once, each output written once)
    and operations (float32 products: the 3xTF32 rate, and the bf16
    tensor cores' beside it)."""
    got, ref = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    errs = {o: low_compare(torch, f"{name} {o}", g, r)
            for o, g, r in zip(outs, got, ref) if g is not None}
    again = kernel()
    again = again if isinstance(again, tuple) else (again,)
    if not all(torch.equal(a, g) for a, g in zip(again, got)
               if g is not None):
        fail(f"{name}: a second launch on the same inputs differs")
    nbytes = tensor_bytes(*inputs, *got)
    row = {"name": name, "route": "cuda", "source": mod.SOURCE,
           "replaces": replaces, "shape": shape, "outputs": errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "repeat": "bit for bit",
           "ms": time_ms(torch, kernel, samples=10, reps=5),
           "plain_ms": time_ms(torch, plain, samples=3, reps=1),
           "library_ms": (time_ms(torch, library, samples=10, reps=5)
                          if library else None),
           **({} if library else {"library_note": library_note}),
           "bytes": nbytes, "flops": flops,
           "bound_bf16_tensor_core_ms": flops / PEAK_BF16_FLOPS * 1e3}
    tc_bound(row, nbytes, flops)
    return row


def check_low_instances(torch, dev, rng, pairs):
    """Every low-precision instance of the recurrent kernels named by
    ``pairs`` ((xs, W) dtype names) at its family's float32 train shape
    (full rows, as the train batch's): B11 simple RNN T 100 B 64 D 512,
    B9 LSTM T 100 B 64 D 512, B10 GRU T 30 B 64 D 512, B12 blocked LSTM
    forward T 100 B 64 D 1280."""
    from paddle_tpu_torch.ops.kernels import _check
    from paddle_tpu_torch.ops.kernels import gru as gk
    from paddle_tpu_torch.ops.kernels import lstm as lk
    from paddle_tpu_torch.ops.kernels import lstm_blocked as bk
    from paddle_tpu_torch.ops.kernels import simple_rnn as rk
    rows = []
    for xd, wd in ((getattr(torch, x), getattr(torch, w)) for x, w in pairs):
        sfx = _check.suffix(xd, wd)
        # B11
        t, b, d = RNN_T, RNN_B, RNN_D
        lengths, xs, mask, w = rnn_inputs(torch, dev, rng, t, b, d, False)
        xs, w = xs.to(xd), w.to(wd)
        dh = torch.tensor(normal(rng, (t, b, d)), device=dev).to(xd)
        hs = rk.simple_rnn_fwd_plain(xs, mask, w)
        (_, ff), (_, bf) = rnn_cost(lengths, t, d)
        shape = {"T": t, "B": b, "D": d}
        rows.append(low_row(
            torch, f"{rk.NAME_FWD}[{sfx}]", rk, rk.REPLACES_FWD,
            lambda: rk.simple_rnn_fwd(xs, mask, w),
            lambda: rk.simple_rnn_fwd_plain(xs, mask, w), ("hs",),
            (xs, mask, w), ff, shape))
        rows.append(low_row(
            torch, f"{rk.NAME_BWD}[{sfx}]", rk, rk.REPLACES_BWD,
            lambda: rk.simple_rnn_bwd(hs, w, mask, dh),
            lambda: rk.simple_rnn_bwd_plain(hs, w, mask, dh), ("dxs", "dW"),
            (hs, w, mask, dh), bf, shape))
        # B9
        t, b, d = LSTM_T, LSTM_B, LSTM_D
        lengths, xs, mask, w_r, checks = lstm_inputs(torch, dev, rng, t, b,
                                                     d, False)
        xs, w_r = xs.to(xd), w_r.to(wd)
        hs, _, cs, acts = lk.lstm_fwd_plain(xs, mask, w_r, checks, True)
        dh = torch.tensor(normal(rng, (t, b, d)), device=dev).to(xd)
        dcfin = torch.tensor(normal(rng, (b, d)), device=dev)
        (_, ff), (_, bf) = lstm_cost(lengths, t, d)
        shape = {"T": t, "B": b, "D": d}
        rows.append(low_row(
            torch, f"{lk.NAME_FWD}[{sfx}]", lk, lk.REPLACES_FWD,
            lambda: lk.lstm_fwd(xs, mask, w_r, checks, True),
            lambda: lk.lstm_fwd_plain(xs, mask, w_r, checks, True),
            ("hs", "c_fin", "cs", "acts"), (xs, mask, w_r, checks), ff,
            shape))
        rows.append(low_row(
            torch, f"{lk.NAME_BWD}[{sfx}]", lk, lk.REPLACES_BWD,
            lambda: lk.lstm_bwd(acts, cs, hs, w_r, checks, mask, dh, dcfin),
            lambda: lk.lstm_bwd_plain(acts, cs, hs, w_r, checks, mask, dh,
                                      dcfin),
            ("dxs", "dW_r", "dchecks"),
            (acts, cs, hs, w_r, checks, mask, dh, dcfin), bf, shape))
        # B10
        t, b, d = GRU_T, GRU_B, GRU_D
        lengths, xs, mask, wg, ws = gru_inputs(torch, dev, rng, t, b, d,
                                               False)
        xs, wg, ws = xs.to(xd), wg.to(wd), ws.to(wd)
        hs, acts = gk.gru_fwd_plain(xs, mask, wg, ws, True)
        dh = torch.tensor(normal(rng, (t, b, d)), device=dev).to(xd)
        (_, ff), (_, bf) = gru_cost(lengths, t, d)
        shape = {"T": t, "B": b, "D": d}
        rows.append(low_row(
            torch, f"{gk.NAME_FWD}[{sfx}]", gk, gk.REPLACES_FWD,
            lambda: gk.gru_fwd(xs, mask, wg, ws, True),
            lambda: gk.gru_fwd_plain(xs, mask, wg, ws, True),
            ("hs", "acts"), (xs, mask, wg, ws), ff, shape))
        rows.append(low_row(
            torch, f"{gk.NAME_BWD}[{sfx}]", gk, gk.REPLACES_BWD,
            lambda: gk.gru_bwd(acts, hs, wg, ws, mask, dh),
            lambda: gk.gru_bwd_plain(acts, hs, wg, ws, mask, dh),
            ("dxs", "dW_gate", "dW_state"), (acts, hs, wg, ws, mask, dh),
            bf, shape))
        # B12 forward
        t, b, d = BLK_T, BLK_B, BLK_TIMED[0]
        lengths, xs, mask, w_r, checks = lstm_inputs(
            torch, dev, rng, t, b, d, False, w_scale=1.0 / math.sqrt(d))
        xs, w_r = xs.to(xd), w_r.to(wd)
        rows.append(low_row(
            torch, f"{bk.NAME_FWD}[{sfx}]", bk, bk.REPLACES_FWD,
            lambda: bk.lstm_blocked_fwd(xs, mask, w_r, checks, True),
            lambda: lk.lstm_fwd_plain(xs, mask, w_r, checks, True),
            ("hs", "c_fin", "cs", "acts"), (xs, mask, w_r, checks),
            lstm_cost(lengths, t, d)[0][1], {"T": t, "B": b, "D": d}))
        del xs, w_r, hs, acts, cs
    return rows


def low_launches(kernels):
    """Every bf16 and float16 instance's launches of the recurrent
    kernels since the last reset, by row name."""
    return {k: n for mod in (kernels.simple_rnn, kernels.lstm, kernels.gru,
                             kernels.lstm_blocked)
            for k, n in mod.launches_low.items()}


def recurrent_launches(kernels):
    """Launches of every recurrent kernel since the last reset, every
    instance (launches_fwd / launches_bwd count each launch)."""
    return (kernels.simple_rnn.launches_fwd + kernels.simple_rnn.launches_bwd
            + kernels.lstm.launches_fwd + kernels.lstm.launches_bwd
            + kernels.gru.launches_fwd + kernels.gru.launches_bwd
            + kernels.lstm_blocked.launches_fwd)


@contextlib.contextmanager
def bf16_policy():
    """The bf16 compute policy for the phase, restored (to auto) at its
    end, whether it passes or fails (a failure still fails the run)."""
    from paddle_tpu_torch.core import dtypes
    dtypes.set_policy("float32", "bfloat16")
    try:
        yield
    finally:
        dtypes.set_policy()


def dsl_trainer(torch, device, cell, hidden, compute_dtype, vocab=None,
                emb_fed=False):
    """SGD over text_rnn's ``cell`` config (seed 1 weights), or with
    ``emb_fed`` the same cell fed by the embedding itself (one recurrent
    layer, bf16 xs under the policy)."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.trainer import SGD
    vocab = vocab or text_rnn.VOCAB
    if emb_fed:
        L.reset_names()
        width = {"rnn": 1, "lstm": 4, "gru": 3}[cell] * hidden
        x = L.embedding_layer(L.data_layer("word", vocab, is_seq=True),
                              size=width)
        x = {"rnn": L.recurrent_layer, "lstm": L.lstmemory,
             "gru": L.grumemory}[cell](x)
        out = L.fc_layer(L.pooling_layer(x, pooling_type=L.pooling.Max),
                         size=text_rnn.CLASSES, act="softmax")
        cost = L.classification_cost(out, L.data_layer("label", 1))
    else:
        cost = text_rnn.build(vocab=vocab, hidden=hidden, cell=cell)
    return SGD(cost=cost, update_equation=text_rnn.optimizer(),
               compute_dtype=compute_dtype, device=device)


def dsl_first_step(torch, dev, kernels, cell, hidden, batch, what):
    """One SGD(compute_dtype=bf16) step of text_rnn's ``cell`` on the
    card and on a CPU witness that max-pools at the card's argmax, from
    the same weights on ``batch``: (card trainer, its bf16 launches,
    record).  Held at TRAIN_REL_TOL (loss) and BF16_GRAD_TOL (each
    gradient leaf, relative L2), which the same card step under
    rounded_cotangent must fail; the update must lower the batch's
    cost."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import text_rnn
    feeding = text_rnn.feeding()

    def step(device, record, argmax=None):
        tr = dsl_trainer(torch, device, cell, hidden, torch.bfloat16)
        with pool_probe(torch, record, argmax):
            total, _ = tr._forward(DataFeeder(feeding,
                                              device=tr.device)(batch))
        tr._backward(total)
        grads = [p.grad.detach().cpu() for p in tr._leaves]
        tr._update()
        return tr, float(total.detach()), grads

    kernels.reset_launches()
    rec_c, rec_w, rec_x = [], [], []
    card, loss_c, grads_c = step(dev, rec_c)
    launches = low_launches(kernels)
    after = card.test(lambda: iter([batch]), feeding=feeding)
    with rounded_cotangent(torch):
        _, _, grads_x = step(dev, rec_x)
    witness, loss_w, grads_w = step("cpu", rec_w,
                                    [r["argmax"] for r in rec_c])
    names = leaf_names(witness.parameters)
    loss_err = abs(loss_c - loss_w) / abs(loss_w)
    l2 = grad_rel_l2(grads_c, grads_w)
    largest = [float((g - w).abs().max() / w.abs().max())
               if float(w.abs().max()) else float(g.abs().max())
               for g, w in zip(grads_c, grads_w)]
    flips = sum(int((a["argmax"] != b["argmax"]).sum())
                for a, b in zip(rec_c, rec_w))
    if not loss_err <= TRAIN_REL_TOL or not after < loss_c:
        fail(f"{what}: first bf16 step on the card vs the CPU: loss rel err "
             f"{loss_err} (bound {TRAIN_REL_TOL}); the batch's cost {loss_c} "
             f"before the update, {after} after (must fall)")
    gates = gate_with_control(f"{what} ({dict(zip(names, l2))})", l2,
                              grad_rel_l2(grads_x, grads_w), BF16_GRAD_TOL)
    return card, launches, {
        "rows": len(batch), "cost_before_after_update": [loss_c, after],
        "loss_rel_err": loss_err, **gates,
        "grad_largest_entry_rel_err_max": max(largest),
        "bound": {"loss": TRAIN_REL_TOL, "grad_rel_l2": BF16_GRAD_TOL},
        "pool_argmax_flips_card_vs_witness": flips}


def dsl_steps(torch, kernels, trainer, batch, steps, what, want=None,
              vocab=None):
    """``steps`` steps of ``trainer.train`` on ``batch`` repeated: (step
    ms after BF16_WARMUP, losses, per-step bf16 launches); with ``want``
    each step's bf16 launches must equal it and no float32 instance may
    launch."""
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.trainer import events
    record = {"ms": [], "loss": [], "bf16": [], "all": []}

    def handler(e):
        if isinstance(e, events.BeginIteration):
            torch.cuda.synchronize()
            kernels.reset_launches()
            record["t0"] = time.perf_counter()
        elif isinstance(e, events.EndIteration):
            record["loss"].append(float(e.cost))     # a synchronize
            record["ms"].append((time.perf_counter() - record["t0"]) * 1e3)
            record["bf16"].append(low_launches(kernels))
            record["all"].append(recurrent_launches(kernels))

    trainer.train(lambda: iter([batch] * steps), num_passes=1,
                  event_handler=handler,
                  feeding=text_rnn.feeding(vocab or text_rnn.VOCAB),
                  log_period=0)
    if not all(math.isfinite(x) for x in record["loss"]):
        fail(f"{what}: loss not finite: {record['loss']}")
    if want is not None:
        bad = [(got, n) for got, n in zip(record["bf16"], record["all"])
               if got != want or n != sum(want.values())]
        if bad or len(record["loss"]) != steps:
            fail(f"{what}: per-step bf16 launches {record['bf16']} (all "
                 f"recurrent launches {record['all']}), want {want} each "
                 f"of {steps} steps and no float32 instance")
    return record["ms"][BF16_WARMUP:], record["loss"], record["bf16"]


def run_train_rnn_bf16(torch, dev, kernels, seed):
    """train_rnn under the bf16 policy: the first step against the CPU
    witness, BF16_STEPS steps on one batch (the loss falls; B11's
    (float32 xs, bf16 W) instances 2 + 2 a step) beside the same steps
    in float32, and the CLI's --dtype bfloat16 with SGD.load."""
    from paddle_tpu_torch.models import text_rnn
    rk = kernels.simple_rnn
    batch = text_rnn.samples(seed, text_rnn.BATCH)
    want = {f"{rk.NAME_FWD}[xf32_wbf16]": 2,
            f"{rk.NAME_BWD}[xf32_wbf16]": 2}
    with bf16_policy():
        card, first_launches, first = dsl_first_step(
            torch, dev, kernels, "rnn", text_rnn.HIDDEN, batch,
            "train_rnn_bf16")
        if first_launches != want:
            fail(f"train_rnn_bf16: first step's bf16 launches "
                 f"{first_launches}, want {want}")
        ms, losses, per_step = dsl_steps(torch, kernels, card, batch,
                                         BF16_STEPS, "train_rnn_bf16", want)
        if not min(losses[-5:]) < losses[0]:
            fail(f"train_rnn_bf16: the loss does not fall over {BF16_STEPS} "
                 f"steps on one batch: {losses}")
        cli = rnn_cli(torch, dev, seed, card, dtype="bfloat16")
    f32 = dsl_trainer(torch, dev, "rnn", text_rnn.HIDDEN, None)
    ms32, _, _ = dsl_steps(torch, kernels, f32, batch, BF16_STEPS,
                           "train_rnn_bf16 (float32 twin)")
    launches = {k: first_launches[k] + sum(n[k] for n in per_step)
                for k in want}
    emit({"phase": "train_rnn_bf16", "config": {
        "model": "models/text_rnn (layer DSL)", "cell": "rnn",
        "vocab": text_rnn.VOCAB, "emb": text_rnn.EMB,
        "hidden": text_rnn.HIDDEN, "layers": text_rnn.LAYERS,
        "batch": text_rnn.BATCH, "seq_len": text_rnn.SEQ_LEN,
        "optimizer": "Momentum lr 0.01 m 0.9",
        "compute_dtype": "bfloat16 (SGD(compute_dtype=) + set_policy)",
        "steps": f"{BF16_STEPS} of SGD.train on one batch"},
        "ms_per_batch": float(np.median(ms)),
        "ms_per_batch_min_max": [min(ms), max(ms)],
        "f32_ms_per_batch": float(np.median(ms32)),
        "launches": launches, "launches_per_step": want, "losses": losses,
        "first_step_vs_cpu": first, "cli": cli})
    return launches


def run_train_dsl_bf16(torch, dev, kernels, seed):
    """text_rnn's LSTM (h 512: B9, h 1280: B12's forward) and GRU (h 512:
    B10) under the bf16 policy, as run_train_rnn_bf16 without the CLI,
    the first step at BF16_CHECK_BATCH rows; then each family fed by an
    embedding (the (bf16 xs, bf16 W) instances), two steps each."""
    from paddle_tpu_torch.models import text_rnn
    batch = text_rnn.samples(seed, text_rnn.BATCH)
    names = {"lstm": [kernels.lstm.NAME_FWD, kernels.lstm.NAME_BWD],
             "lstm_blocked": [kernels.lstm_blocked.NAME_FWD],
             "gru": [kernels.gru.NAME_FWD, kernels.gru.NAME_BWD],
             "rnn": [kernels.simple_rnn.NAME_FWD,
                     kernels.simple_rnn.NAME_BWD]}

    def family(cell, hidden):
        if cell == "lstm" and not kernels.lstm.supported(
                text_rnn.BATCH, hidden, "tanh", "sigmoid", "tanh", None):
            return "lstm_blocked"
        return cell

    out, launches = {}, {}
    for cell, hidden in BF16_DSL:
        what = f"train_dsl_bf16 {cell} h{hidden}"
        want = {f"{n}[xf32_wbf16]": 2 for n in names[family(cell, hidden)]}
        with bf16_policy():
            card, first_launches, first = dsl_first_step(
                torch, dev, kernels, cell, hidden,
                batch[:BF16_CHECK_BATCH], what)
            if first_launches != want:
                fail(f"{what}: first step's bf16 launches {first_launches}, "
                     f"want {want}")
            ms, losses, per_step = dsl_steps(torch, kernels, card, batch,
                                             BF16_STEPS, what, want)
            if not min(losses[-5:]) < losses[0]:
                fail(f"{what}: the loss does not fall over {BF16_STEPS} "
                     f"steps on one batch: {losses}")
        del card
        f32 = dsl_trainer(torch, dev, cell, hidden, None)
        ms32, _, _ = dsl_steps(torch, kernels, f32, batch, BF16_STEPS,
                               f"{what} (float32 twin)")
        del f32
        got = {k: first_launches[k] + sum(n[k] for n in per_step)
               for k in want}
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        out[f"{cell}_h{hidden}"] = {
            "ms_per_batch": float(np.median(ms)),
            "f32_ms_per_batch": float(np.median(ms32)),
            "launches": got, "launches_per_step": want, "losses": losses,
            "first_step_vs_cpu": first}
    emb = {}
    for cell, hidden in BF16_EMB_FED:
        what = f"train_dsl_bf16 embedding-fed {cell} h{hidden}"
        want = {f"{n}[xbf16_wbf16]": 1 for n in names[family(cell, hidden)]}
        ids = text_rnn.samples(seed, text_rnn.BATCH,
                               vocab=BF16_EMB_VOCAB)
        with bf16_policy():
            tr = dsl_trainer(torch, dev, cell, hidden, torch.bfloat16,
                             vocab=BF16_EMB_VOCAB, emb_fed=True)
            _, losses, per_step = dsl_steps(torch, kernels, tr, ids, 2, what,
                                            want, vocab=BF16_EMB_VOCAB)
        del tr
        for k in want:
            launches[k] = launches.get(k, 0) + sum(n[k] for n in per_step)
        emb[f"{cell}_h{hidden}"] = {"launches_per_step": want,
                                    "losses": losses}
    emit({"phase": "train_dsl_bf16", "config": {
        "model": "models/text_rnn (layer DSL)", "vocab": text_rnn.VOCAB,
        "emb": text_rnn.EMB, "layers": text_rnn.LAYERS,
        "batch": text_rnn.BATCH, "seq_len": text_rnn.SEQ_LEN,
        "optimizer": "Momentum lr 0.01 m 0.9",
        "compute_dtype": "bfloat16 (SGD(compute_dtype=) + set_policy)",
        "steps": f"{BF16_STEPS} of SGD.train on one batch",
        "first_step_rows": BF16_CHECK_BATCH,
        "embedding_fed": {"vocab": BF16_EMB_VOCAB, "layers": 1,
                          "steps": 2}},
        "cells": out, "embedding_fed": emb, "launches": launches})
    return launches


def run_rnn_ops_low(torch, dev, kernels, rng, pairs, phase, steps=None):
    """The ops API's recurrent entry points called with xs and weights of
    the (xs, W) dtype ``pairs`` (a direct caller's dtypes; the policies
    cast every weight): ops/rnn.simple_rnn, lstm at h 512 (resident
    kernels) and 1280 (gate-blocked forward, plain backward) and gru, at
    the kernel table's shapes (``steps`` in place of their T where given)
    on ragged rows, forward and backward, on the card and on the CPU from
    the same inputs.  Each pair's instances launch once each way and no
    other recurrent kernel does; hs is held as an instance's output
    (low_compare), each gradient within MIXED_GRAD_TOL relative L2 of the
    CPU's."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.ops import rnn
    from paddle_tpu_torch.ops.kernels import _check
    cases = (("simple_rnn", kernels.simple_rnn, RNN_T, RNN_D, 1, (1,)),
             ("lstm", kernels.lstm, LSTM_T, LSTM_D, 4, (4,)),
             ("lstm", kernels.lstm_blocked, BLK_T, BLK_TIMED[0], 4, (4,)),
             ("gru", kernels.gru, GRU_T, GRU_D, 3, (2, 1)))
    b, out, launches = RNN_B, {}, {}
    for (xd, wd), (op, mod, t, d, gates, widths) in (
            ((getattr(torch, x), getattr(torch, w)), case)
            for x, w in pairs for case in cases):
        t = steps or t
        sfx = _check.suffix(xd, wd)
        what = f"{phase} {op} h{d} [{sfx}]"
        lengths = rng.randint(1, t + 1, b)
        lengths[0], lengths[-1] = 0, t
        x = normal(rng, (b, t, gates * d)) * 0.3
        ws = [normal(rng, (d, k * d)) / math.sqrt(d) for k in widths]
        cot = normal(rng, (b, t, d))

        def call(device):
            xs = torch.tensor(x, device=device).to(xd)
            xs.requires_grad_(True)
            w = [torch.tensor(a, device=device).to(wd).requires_grad_(True)
                 for a in ws]
            seq = SequenceBatch(xs, torch.tensor(lengths, device=device))
            hs = getattr(rnn, op)(seq, *w)[0].data
            (hs.float() * torch.tensor(cot, device=device)).sum().backward()
            return hs.detach().cpu(), [v.grad.cpu() for v in (xs, *w)]

        kernels.reset_launches()
        hs_c, grads_c = call(dev)
        torch.cuda.synchronize()
        got = low_launches(kernels)
        want = {f"{name}[{sfx}]": 1 for name in
                (mod.NAME_FWD, getattr(mod, "NAME_BWD", None)) if name}
        if got != want or recurrent_launches(kernels) != len(want):
            fail(f"{what}: low-precision launches {got} (recurrent "
                 f"{recurrent_launches(kernels)}), want {want}")
        hs_w, grads_w = call("cpu")
        hs_err = low_compare(torch, f"{what} hs", hs_c, hs_w)
        l2 = grad_rel_l2(grads_c, grads_w)
        if not max(l2) <= MIXED_GRAD_TOL:
            fail(f"{what}: gradients' relative L2 error vs the CPU "
                 f"(xs, weights) {l2} (bound {MIXED_GRAD_TOL})")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        out[f"{op}_h{d}[{sfx}]"] = {
            "T": t, "B": b, "D": d, "launches": got, "hs": hs_err,
            "grad_rel_l2_err": l2,
            "grad_dtypes": [str(g.dtype).replace("torch.", "")
                            for g in grads_c]}
    emit({"phase": phase, "pairs": [list(p) for p in pairs],
          "bound": {"hs": "one step of its dtype plus BF16_F32_FLOOR",
                    "grad_rel_l2": MIXED_GRAD_TOL}, "cases": out})
    return launches


def run_train_transformer_bf16(torch, dev, kernels, f32_ms):
    """bench_transformer under set_policy("float32", "bfloat16"): the
    first step at batch 2 against a CPU witness that keeps the card's
    ReLU decisions (each gradient leaf within BF16_MT_GRAD_TOL, which the
    same card step under rounded_cotangent must fail), then MT_WARMUP +
    MT_STEPS steps at batch 32 with the flash launches read and the loss
    falling."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import linear
    from paddle_tpu_torch.scripts import bench
    fk = kernels.flash_attention
    with bf16_policy():
        probe = linear.matmul(torch.ones(2, 4, device=dev, requires_grad=True),
                              torch.ones(4, 2, device=dev))
        fns = [probe.grad_fn] + [f for f, _ in probe.grad_fn.next_functions]
        route = {"grad_fn": [type(f).__name__ for f in fns if f is not None],
                 "out_dtype": str(probe.dtype).replace("torch.", ""),
                 "call": "torch.mm(a, b, out_dtype=torch.float32) "
                         "(aten::mm.dtype: bf16 operands on the tensor "
                         "cores, float32 accumulator), ops/linear._MmBf16"}
        if "_MmBf16Backward" not in route["grad_fn"] or probe.dtype \
                != torch.float32:
            fail(f"train_transformer_bf16: matmul under the bf16 policy on "
                 f"the card took {route}")
        card_run = bench.bench_transformer(batch=2, device=dev)
        names = leaf_names(card_run.params)
        card_pre, control_pre, witness_pre = [], [], []
        first, card_g, _, _ = first_step(torch, transformer, card_run,
                                         card_pre)
        del card_run
        with rounded_cotangent(torch):
            control_g = first_step(
                torch, transformer, bench.bench_transformer(
                    batch=2, device=dev), control_pre)[1]
        witness = first_step(torch, transformer,
                             bench.bench_transformer(batch=2, device="cpu"),
                             witness_pre, [p > 0 for p in card_pre])
        loss_err = abs(first - witness[0]) / abs(witness[0])
        l2 = grad_rel_l2(card_g, witness[1])
        flips = sum(int(((a > 0) != (b > 0)).sum())
                    for a, b in zip(card_pre, witness_pre))
        if len(witness_pre) != len(card_pre) \
                or not loss_err <= TRAIN_REL_TOL:
            fail(f"train_transformer_bf16: first step at batch 2 vs the CPU "
                 f"witness: loss rel err {loss_err} (bound {TRAIN_REL_TOL})")
        gates = gate_with_control(
            f"train_transformer_bf16 ({dict(zip(names, l2))})", l2,
            grad_rel_l2(control_g, witness[1]), BF16_MT_GRAD_TOL,
            np.median)
        if not max(l2) <= BF16_MT_GRAD_MAX:
            fail(f"train_transformer_bf16: a gradient leaf's relative L2 "
                 f"error {max(l2)} vs the CPU step (ceiling "
                 f"{BF16_MT_GRAD_MAX})")
        product = check_matmul_grads(torch, dev, np.random.RandomState(18))
        del witness, card_pre, control_pre, witness_pre, card_g, control_g
        run = bench.bench_transformer(device=dev)
        losses, times, per_step = [], [], []
        for i in range(MT_WARMUP + MT_STEPS):
            kernels.reset_launches()
            t0 = time.perf_counter()
            loss = run.train_step()
            torch.cuda.synchronize()
            losses.append(float(loss))
            if i >= MT_WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
                per_step.append((fk.launches, fk.launches_bwd_dkv,
                                 fk.launches_bwd_dq))
        del run
    want = (MT_ATTENTIONS,) * 3
    if any(n != want for n in per_step):
        fail(f"train_transformer_bf16: per-step (forward, dK/dV, dQ) "
             f"launches {per_step}, want {want} each step")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"train_transformer_bf16: loss not finite or not falling: "
             f"{losses}")
    ms = float(np.median(times))
    emit({"phase": "train_transformer_bf16", "config": {
        "vocab": 32000, "d_model": 512, "heads": MT_HEADS, "dff": 2048,
        "layers": "6+6", "batch": MT_BATCH, "seq_len": MT_SEQ,
        "optimizer": "Adam lr 1e-4", "label_smoothing": 0.1,
        "full_seq": True, "policy": 'set_policy("float32", "bfloat16")'},
        "matmul_route": route,
        "warmup": MT_WARMUP, "steps": MT_STEPS, "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times), max(times)],
        "f32_ms_per_batch": f32_ms,
        "tokens_per_s": MT_BATCH * MT_SEQ / (ms / 1e3),
        "launches_per_step": dict(zip((fk.NAME, fk.NAME_BWD_DKV,
                                       fk.NAME_BWD_DQ), want)),
        "loss_first": losses[0], "loss_last": losses[-1],
        "first_step_vs_cpu": {
            "batch": 2, "loss_rel_err": loss_err, **gates,
            "grad_rel_l2_ceiling": BF16_MT_GRAD_MAX,
            "one_product_vs_cpu": product,
            "relu_flips_vs_witness": flips,
            "bound": {"loss": TRAIN_REL_TOL,
                      "grad_rel_l2_median": BF16_MT_GRAD_TOL}}})


# ----------------------------- bf16 attention, float16 recurrences, beams

# The recurrent kernels' (xs, W) pairs with a bf16 operand and with a
# float16 one: the float16 policy's two (behind an fc, fed by an
# embedding), a direct call's, and the two mixed pairs JAX admits too.
BF16_PAIRS = (("float32", "bfloat16"), ("bfloat16", "bfloat16"),
              ("bfloat16", "float32"))
F16_PAIRS = (("float32", "float16"), ("float16", "float16"),
             ("float16", "float32"), ("bfloat16", "float16"),
             ("float16", "bfloat16"))
# text_rnn's cells under the float16 policy (cell, hidden): their first
# step on F16_CHECK_BATCH rows against the plain CPU step (the policy's
# products multiply in float32 on both devices: ops/linear.matmul), the
# card's max-pool argmax kept by the witness (pool_probe).  What is left
# between the two is float32 summation order and the float16 roundings it
# flips: of the operands at the step boundary and in the kernels' hs /
# dxs, and of every product's cotangent, which the policy rounds to
# float16 as JAX's transpose does.  Without loss scaling (neither package
# scales) most cotangents lie below float16's normal range (6.1e-5),
# where its spacing is absolute (6e-8), so a flip there moves a value by
# percents.  Predicted within 1e-3 relative L2 on every gradient leaf
# (PERF.md §6); read (NVIDIA H100 80GB HBM3, 700 W) below 7.5e-4 on the
# RNN and both LSTMs, 2.2e-3 / 2.5e-3 on the two GRU layers' W_gate.
# Held at F16_GRAD_TOL, BF16_GRAD_TOL's value; the loss at
# TRAIN_REL_TOL.
F16_DSL = (("rnn", 512), ("lstm", 512), ("lstm", 1280), ("gru", 512))
F16_CHECK_BATCH = 16
F16_GRAD_TOL = 4e-3
# the direct ops calls' steps (the ops phase at the families' widths)
F16_OPS_T = 20
# The attention kernels' operand dtypes, as JAX's functions take them: q,
# k and v each float32, bf16 or float16.  attn_combos(low) is every
# combination of float32 and ``low`` (the all-float32 combination is the
# float32 instance's own rows); the float16 rows add two that mix
# float16 with bf16 (every dtype is read through the same run-time bits).
# The wide head dims every combination runs at, and the further ones the
# all-low combination runs at.
ATTN_WIDE_DH, ATTN_WIDE_ALL_BF16 = 256, (384, 512)
ATTN_F16_MIXED = (("float16", "bfloat16", "float32"),
                  ("bfloat16", "float16", "float16"))
SHORT_LOW = {"bfloat16": "bf16", "float16": "f16"}


def attn_combos(low):
    return tuple(c for c in ((q, k, v) for q in ("float32", low)
                             for k in ("float32", low)
                             for v in ("float32", low))
                 if c != ("float32",) * 3) + (
        ATTN_F16_MIXED if low == "float16" else ())

# The MT model's KV-cached beam decode at bench_transformer_decode's
# widths (bench.py:769-812: batch 32, sources of 128 tokens, 128 steps,
# beam 4, vocab 32000, d 512, 8 heads, dff 2048, 6 + 6 layers; weights
# from seed 0), held against the full-recompute generate on the card and
# against a CPU run of its first MTD_CPU_ROWS rows.  Two runs agree on a
# row's beams step by step (each survivor's source lane and token, its
# score within BEAM_SCORE_RTOL) up to the first step where either run's
# K-th and (K+1)-th candidates lie closer than BEAM_MARGIN; a row with
# no such step must end with equal tokens, lengths and scores.  Random
# weights leave the top candidates close (gaps of 1e-4..1e-2 among 4 x
# 32000), so each run's beams are also re-scored by the full decode,
# teacher-forced on the card (beam_rescore): the card's own beams and the
# CPU run's, each score within BEAM_SCORE_RTOL.  The encoder attends
# under the source's key mask, so JAX's route (and the
# port's) is the dense path: the flash forward launches MTD_FLASH times,
# and the cached steps attend on the plain path (no kernel).
MTD_CPU_ROWS = 4
MTD_TIMED = 2
MTD_LENGTH_PENALTY = 0.6      # generate_cached's default, the bench's
MTD_FLASH = 0
BEAM_MARGIN = 2e-3
BEAM_SCORE_RTOL = 1e-4
# seq2seq's beam generate at bench_seq2seq's widths (vocab 30000, emb =
# h = att 512, batch 64, sources of 30 tokens), beam 5, 50 steps (the
# reference's demo settings, seq2seq.py:121), held against a CPU run of
# its first MTD_CPU_ROWS rows as generate_mt is; the encoder's two GRUs
# take the lean forward kernel once each.
S2G_BEAM, S2G_MAX_LEN = 5, 50


@contextlib.contextmanager
def f16_policy():
    """The float16 compute policy for the phase, restored at its end."""
    from paddle_tpu_torch.core import dtypes
    dtypes.set_policy("float32", "float16")
    try:
        yield
    finally:
        dtypes.set_policy()


def attn_dtypes(torch, combo):
    return tuple(getattr(torch, name) for name in combo)


def attn_low_launches(kernels):
    """The attention kernels' bf16 launches since the last reset, by row
    name."""
    return {**kernels.flash_attention.launches_low,
            **kernels.decode_attention.launches_low}


def check_attention_low(torch, dev, rng, low="bfloat16"):
    """Every bf16 (or, ``low="float16"``, float16) instance of B1-B8
    against its plain version, the combinations of ``attn_combos(low)``:
    the flash forward, dK/dV and dQ at the MT train shape (B 32, H 8, T
    256, dh 64, full) and at dh 256 (B 4, H 2, T 512, causal), the
    all-low combination also at dh 384 and 512; flash_attention_quant's
    low q
    at the prefill shape (B 32, T 32, H = Hkv = 8) and at dh 256; the
    four decode kernels at the serving shapes (S 8, K 8, T 256, D 512, H
    = Hkv = 8; the paged pair over 129 shuffled blocks of 16) for every
    combination, and over the int8 cache with low q.  Each row as the
    recurrent instances' (low_row: low outputs within one step plus
    BF16_F32_FLOOR of the largest, float32 ones within the floor, bit for
    bit on a repeat), timed beside its float32 instance on the same
    values widened.  Library: SDPA where every operand is low (no
    PyTorch call takes mixed operand dtypes)."""
    from paddle_tpu_torch.ops.kernels import _check
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mixed = "none: no PyTorch call takes mixed operand dtypes"
    rows = []
    low_dt = getattr(torch, low)
    combos = attn_combos(low)

    def row(name, mod, replaces, kernel, plain, outs, inputs, flops,
            shape, f32_kernel, library=None, tc=True):
        r = low_row(torch, name, mod, replaces, kernel, plain, outs,
                    inputs, flops, shape, library=library,
                    library_note=mixed)
        r["f32_instance_ms"] = time_ms(torch, f32_kernel, samples=10,
                                       reps=5)
        if not tc:    # the decode kernels: float32 SIMT arithmetic
            r.pop("bound_f32_simt_ms", None)
        return r

    def flash_rows(combo, b, h, t, dh, causal):
        dts = attn_dtypes(torch, combo)
        q, k, v, do = (torch.tensor(normal(rng, (b, h, t, dh)),
                                    device=dev).to(d)
                       for d in dts + (dts[0],))
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        sfx = _check.operand_suffix(q=q, k=k, v=v)
        scale = 1.0 / math.sqrt(dh)
        o, lse = fk.flash_attention_plain(q, k, v, scale, causal)
        of, _ = fk.flash_attention_plain(qf, kf, vf, scale, causal)
        _, delta = fk.bwd_dq_kernel(q, k, v, o, lse, do, scale, causal)
        _, delta32 = fk.bwd_dq_kernel(qf, kf, vf, of, lse, dof, scale,
                                      causal)
        cost = flash_bwd_cost(b * h, t, t, dh, causal)
        shape = {"B": b, "H": h, "T": t, "dh": dh, "causal": causal}
        all_low = all(d == low_dt for d in dts)
        lib_fwd = (lambda: sdpa(q, k, v, is_causal=causal)) \
            if all_low else None
        lib_bwd = None
        if all_low:
            qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
            lib_out = sdpa(qg, kg, vg, is_causal=causal)

            def lib_bwd():
                return torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                           retain_graph=True)
        def bwd_plain():
            return fk.flash_attention_bwd_plain(q, k, v, o, lse, do, scale,
                                                causal)
        return [
            row(f"{fk.NAME}[{sfx}]", fk, fk.REPLACES,
                lambda: fk.flash_attention_fwd(q, k, v, scale, causal),
                lambda: fk.flash_attention_plain(q, k, v, scale, causal),
                ("o", "lse"), (q, k, v), cost["fwd"][1], shape,
                lambda: fk.flash_attention_fwd(qf, kf, vf, scale, causal),
                lib_fwd),
            row(f"{fk.NAME_BWD_DKV}[{sfx}]", fk, fk.REPLACES_BWD_DKV,
                lambda: fk.bwd_dkv_kernel(q, k, v, do, lse, delta, scale,
                                          causal),
                lambda: bwd_plain()[1:], ("dk", "dv"),
                (q, k, v, do, lse, delta), cost["dkv"][1], shape,
                lambda: fk.bwd_dkv_kernel(qf, kf, vf, dof, lse, delta32,
                                          scale, causal), lib_bwd),
            row(f"{fk.NAME_BWD_DQ}[{sfx}]", fk, fk.REPLACES_BWD_DQ,
                lambda: fk.bwd_dq_kernel(q, k, v, o, lse, do, scale,
                                         causal)[0],
                lambda: bwd_plain()[0], ("dq",), (q, k, v, do, o, lse),
                cost["dq"][1], shape,
                lambda: fk.bwd_dq_kernel(qf, kf, vf, of, lse, dof, scale,
                                         causal), lib_bwd)]

    flash = {}
    for combo in combos:
        train = flash_rows(combo, MT_BATCH, MT_HEADS, MT_SEQ, MT_DH, False)
        wide = [flash_rows(combo, WIDE_B, WIDE_H, WIDE_T, dh, True)
                for dh in (ATTN_WIDE_DH,) + (
                    ATTN_WIDE_ALL_BF16 if combo == (low,) * 3
                    else ())]
        for i, r in enumerate(train):
            r["wide"] = [{key: w[i][key] for key in (
                "shape", "max_abs_err", "outputs", "ms", "f32_instance_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for w in wide]
            rows.append(r)
        torch.cuda.empty_cache()

    # flash_attention_quant: low q over the int8 cache
    from paddle_tpu_torch.quant.kv import quantize_heads
    for b, t, h, dh, key in ((GEN_BATCH, GEN_PROMPT, HEADS, D_MODEL // HEADS,
                              None), (WIDE_B, WIDE_T, WIDE_H, D_MODEL //
                                      WIDE_HEADS, "dh256")):
        d = h * dh
        q = torch.tensor(normal(rng, (b, t, d)), device=dev).to(low_dt)
        (kc, ks), (vc, vs) = (quantize_heads(torch.tensor(
            normal(rng, (b, t, d)), device=dev), h) for _ in range(2))
        flops = 4 * dh * b * h * (t * (t + 1) // 2)
        r = row(f"{fk.NAME_QUANT}[{_check.operand_suffix(q=q)}]", fk,
                fk.REPLACES_QUANT,
                lambda: fk.flash_attention_quant(q, kc, vc, ks, vs, h),
                lambda: fk.flash_attention_quant_plain(q, kc, vc, ks, vs, h),
                ("o",), (q, kc, vc, ks, vs), flops,
                {"B": b, "T": t, "H": h, "Hkv": h, "dh": dh,
                 "causal": True},
                lambda: fk.flash_attention_quant(q.float(), kc, vc, ks, vs,
                                                 h))
        r["library_note"] = ("none: no PyTorch call attends over int8 "
                             "codes with per-(position, head) scales")
        if key:
            rows[-1][key] = {k2: r[k2] for k2 in (
                "shape", "max_abs_err", "ms", "f32_instance_ms", "plain_ms",
                "bound_ms", "bound_by")}
        else:
            rows.append(r)

    # the four decode kernels at the serving shapes
    s, kk, t, d, h = 8, CHUNK, SERVE_MAX_LEN, D_MODEL, HEADS
    dh = d // h
    qpos_np = chunk_qpos(t)
    qpos = torch.tensor(qpos_np, device=dev)
    pos = qpos[:, -1].contiguous()
    nb_row = t // PAGE_BS
    tables = torch.tensor(paged_tables(rng, qpos_np[:, -1], nb_row,
                                       PAGE_BLOCKS), device=dev)
    live = np.where((qpos_np[:, -1] == qpos_np[:, 0])[:, None],
                    np.arange(kk)[None] == 0, True)
    chunk_flops = 4 * dh * h * int(((qpos_np + 1) * live).sum())
    tq1_flops = 4 * dh * h * int((qpos_np[:, -1] + 1).sum())
    # this run's bytes, as check_decode_kernel counts them: q read, the
    # live lanes' outputs written, the positions, and each row's K and V
    # (and int8 scales) up to its furthest lane
    span = int((qpos_np[:, -1] + 1).sum())

    def decode_bytes(q, k, v, lanes, live_lanes, scaled):
        return (q.element_size() * (lanes + live_lanes) * d + 4 * lanes
                + (k.element_size() + v.element_size()) * span * d
                + (8 * span * h if scaled else 0))
    base = [normal(rng, shape) for shape in (
        (s, kk, d), (s, t, d), (s, t, d), (PAGE_BLOCKS, PAGE_BS, d),
        (PAGE_BLOCKS, PAGE_BS, d))]
    mask = (torch.arange(t, device=dev)[None, None, :]
            <= qpos.long()[:, :, None])[:, None]

    def heads(x, n):
        return x.reshape(x.shape[0], n, h, dh).transpose(1, 2).contiguous()

    def decode_rows(combo, int8=False):
        dq = getattr(torch, combo[0])
        q = torch.tensor(base[0], device=dev).to(dq)
        q1 = q[:, 0].contiguous()
        if int8:
            (k, ksc), (v, vsc) = (quantize_heads(torch.tensor(
                a, device=dev), h) for a in base[1:3])
            (pk, pks), (pv, pvs) = (quantize_heads(torch.tensor(
                a, device=dev), h) for a in base[3:5])
            kw, vw = dict(kscale=ksc, vscale=vsc), dict(kscale=pks,
                                                      vscale=pvs)
            names = (dk.NAME_I8, dk.NAME_SLAB_I8, dk.NAME_PAGED_CHUNK_I8,
                     dk.NAME_PAGED_I8)
        else:
            dkd, dvd = getattr(torch, combo[1]), getattr(torch, combo[2])
            k, v, pk, pv = (torch.tensor(a, device=dev).to(dt) for a, dt in
                            zip(base[1:], (dkd, dvd, dkd, dvd)))
            kw = vw = {}
            names = (dk.NAME, dk.NAME_SLAB, dk.NAME_PAGED_CHUNK,
                     dk.NAME_PAGED)
        sfx = _check.operand_suffix(q=q, k=k, v=v)
        lib = None
        if not int8 and all(x == low for x in combo):
            qh, kh, vh = heads(q, kk), heads(k, t), heads(v, t)

            def lib():
                return sdpa(qh, kh, vh, attn_mask=mask)
        cases = (
            (names[0], dk.REPLACES, dk.decode_attention_slab_chunk,
             dk.decode_attention_slab_chunk_plain, (q, k, v, qpos), kw,
             chunk_flops, lib),
            (names[1], dk.REPLACES_SLAB, dk.decode_attention_slab,
             dk.decode_attention_slab_plain, (q1, k, v, pos), kw, tq1_flops,
             None),
            (names[2], dk.REPLACES_PAGED_CHUNK,
             dk.decode_attention_paged_chunk,
             dk.decode_attention_paged_chunk_plain,
             (q, pk, pv, qpos, tables), vw, chunk_flops, None),
            (names[3], dk.REPLACES_PAGED, dk.decode_attention_paged,
             dk.decode_attention_paged_plain, (q1, pk, pv, pos, tables), vw,
             tq1_flops, None))
        out = []
        for name, replaces, fn, plain, args, extra, flops, library in cases:
            wide = tuple(a.float() if a.is_floating_point() else a
                         for a in args)
            tq1 = args[0].dim() == 2
            nbytes = decode_bytes(q, k, v, s if tq1 else s * kk,
                                  s if tq1 else int(live.sum()), int8)
            out.append(row(
                f"{name}[{sfx}]", dk, replaces,
                lambda fn=fn, args=args, extra=extra: fn(*args, h, **extra),
                lambda plain=plain, args=args, extra=extra: plain(
                    *args, h, **extra),
                ("out",), tuple(args) + tuple(extra.values()), flops,
                {"S": s, "K": 1 if args[0].dim() == 2 else kk, "T": t,
                 "D": d, "H": h, "Hkv": h,
                 "layout": "paged" if "paged" in name else "slab"},
                lambda fn=fn, wide=wide, extra=extra: fn(*wide, h, **extra),
                library, tc=False))
            out[-1]["bytes"] = nbytes
            out[-1]["bound_ms"], out[-1]["bound_by"] = bound(nbytes, flops)
        return out

    for combo in combos:
        rows.extend(decode_rows(combo))
    rows.extend(decode_rows((low, "int8", "int8"), int8=True))
    return rows


def run_attention_ops_low(torch, dev, kernels, rng, low="bfloat16"):
    """The attention entry points called with bf16 (or float16) operands,
    in the combinations of ``attn_combos(low)``, at small
    shapes, on the card and on the CPU from the same values: ops/attention
    .dot_product_attention's flash route (FlashAttention: the forward, dQ
    and dK/dV kernels) for every combination of q, k, v,
    causal at B 2, H 2, T 128, dh 64 and at dh 256, forward and backward;
    flash_attention_quant with low q; the four decode wrappers for every
    combination and over the int8 cache with low q.  No model path of
    the port feeds these instances (JAX's has none: a trunk cast to bf16
    is refused by both); this is their path.  Each instance must
    launch exactly as counted below; each output within one step
    (plus BF16_F32_FLOOR) of the CPU's, each gradient within
    MIXED_GRAD_TOL relative L2."""
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops.kernels import _check
    from paddle_tpu_torch.ops.kernels import decode_attention as dk
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.quant.kv import quantize_heads
    kernels.reset_launches()
    want, errs = {}, {}
    low_dt = getattr(torch, low)
    phase = f"attention_ops_{SHORT_LOW[low]}"

    def expect(name, n=1):
        want[name] = want.get(name, 0) + n

    for combo in attn_combos(low):
        dts = attn_dtypes(torch, combo)
        for dh in (64, 256):
            vals = [normal(rng, (2, 2, 128, dh)) for _ in range(4)]

            def call(device):
                q, k, v = (torch.tensor(a, device=device).to(dt)
                           .requires_grad_(True)
                           for a, dt in zip(vals, dts))
                o = attn.dot_product_attention(q, k, v, causal=True)
                o.backward(torch.tensor(vals[3], device=device).to(dts[0]))
                return o.detach().cpu(), [x.grad.cpu() for x in (q, k, v)]

            o_c, g_c = call(dev)
            o_w, g_w = call("cpu")
            sfx = _check.operand_suffix(**{n: torch.empty(0, dtype=dt)
                                           for n, dt in zip("qkv", dts)})
            for name in (fk.NAME, fk.NAME_BWD_DQ, fk.NAME_BWD_DKV):
                expect(f"{name}[{sfx}]")
            what = f"{phase} flash {sfx} dh{dh}"
            l2 = grad_rel_l2(g_c, g_w)
            if not max(l2) <= MIXED_GRAD_TOL:
                fail(f"{what}: gradients' relative L2 vs the CPU {l2} "
                     f"(bound {MIXED_GRAD_TOL})")
            errs[what] = {"o": low_compare(torch, what, o_c, o_w),
                          "grad_rel_l2": l2}
    b, t, h, dh = 2, 64, 4, 64
    q = normal(rng, (b, t, h * dh))
    k, v = (torch.tensor(normal(rng, (b, t, h * dh)), device=dev)
            for _ in range(2))
    (kc, ks), (vc, vs) = quantize_heads(k, h), quantize_heads(v, h)
    outs = [fk.flash_attention_quant(torch.tensor(q, device=device).to(
        low_dt), *(x.to(device) for x in (kc, vc, ks, vs)), h).cpu()
        for device in (dev, "cpu")]
    expect(f"{fk.NAME_QUANT}[q{SHORT_LOW[low]}]")
    errs[f"{phase} flash_attention_quant"] = low_compare(
        torch, f"flash_attention_quant {low} q", *outs)
    # the decode wrappers
    s, kk, tt, hh, dhh = 4, 4, 48, 4, 32
    qpos_np = np.asarray([[9] * kk, list(range(kk)), [20, 21, 22, 23],
                          [tt - 1] * kk], np.int32)
    nb_row = tt // PAGE_BS
    tables = torch.tensor(np.arange(s * nb_row, dtype=np.int32)[::-1]
                          .reshape(s, nb_row).copy())
    base = [normal(rng, shape) for shape in (
        (s, kk, hh * dhh), (s, tt, hh * dhh), (s, tt, hh * dhh),
        (s * nb_row, PAGE_BS, hh * dhh), (s * nb_row, PAGE_BS, hh * dhh))]
    for combo in attn_combos(low) + ((low, "int8", "int8"),):
        int8 = combo[1] == "int8"
        dq = getattr(torch, combo[0])

        def calls(device):
            q = torch.tensor(base[0], device=device).to(dq)
            qpos = torch.tensor(qpos_np, device=device)
            tbl = tables.to(device)
            if int8:
                (k, ksc), (v, vsc) = (quantize_heads(torch.tensor(
                    a, device=device), hh) for a in base[1:3])
                (pk, pks), (pv, pvs) = (quantize_heads(torch.tensor(
                    a, device=device), hh) for a in base[3:5])
                kw, pw = dict(kscale=ksc, vscale=vsc), dict(kscale=pks,
                                                            vscale=pvs)
            else:
                dkd, dvd = getattr(torch, combo[1]), getattr(torch, combo[2])
                k, v, pk, pv = (torch.tensor(a, device=device).to(dt)
                                for a, dt in zip(base[1:],
                                                 (dkd, dvd, dkd, dvd)))
                kw = pw = {}
            q1, pos = q[:, 0].contiguous(), qpos[:, -1].contiguous()
            return q, k, v, [
                dk.decode_attention_slab_chunk(q, k, v, qpos, hh, **kw),
                dk.decode_attention_slab(q1, k, v, pos, hh, **kw),
                dk.decode_attention_paged_chunk(q, pk, pv, qpos, tbl, hh,
                                                **pw),
                dk.decode_attention_paged(q1, pk, pv, pos, tbl, hh, **pw)]

        q, k, v, got = calls(dev)
        _, _, _, ref = calls("cpu")
        sfx = _check.operand_suffix(q=q, k=k, v=v)
        names = ((dk.NAME_I8, dk.NAME_SLAB_I8, dk.NAME_PAGED_CHUNK_I8,
                  dk.NAME_PAGED_I8) if int8 else
                 (dk.NAME, dk.NAME_SLAB, dk.NAME_PAGED_CHUNK, dk.NAME_PAGED))
        for name, g, r in zip(names, got, ref):
            expect(f"{name}[{sfx}]")
            errs[f"{phase} {name}[{sfx}]"] = low_compare(
                torch, f"{name}[{sfx}]", g.cpu(), r)
    torch.cuda.synchronize()
    got = attn_low_launches(kernels)
    if got != want:
        fail(f"{phase}: low-precision launches {got}, want {want}")
    emit({"phase": phase,
          "bound": {"outputs": f"one {low} step plus BF16_F32_FLOOR",
                    "grad_rel_l2": MIXED_GRAD_TOL},
          "launches": got, "checks": errs})
    return got


def run_train_dsl_f16(torch, dev, kernels, seed):
    """text_rnn's cells under the float16 policy (SGD(compute_dtype=
    torch.float16)): the first step of each F16_DSL cell on the card
    against the plain CPU step from the same weights (its max-pool at the
    card's argmax), the loss at TRAIN_REL_TOL, every gradient leaf at
    F16_GRAD_TOL relative L2, the update lowering the batch's cost, the
    (float32 xs, float16 W) instances launched twice each (two layers);
    then each family fed by an embedding (the (float16 xs, float16 W)
    instances), one step each."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import text_rnn
    feeding = text_rnn.feeding()
    names = {"lstm": [kernels.lstm.NAME_FWD, kernels.lstm.NAME_BWD],
             "lstm_blocked": [kernels.lstm_blocked.NAME_FWD],
             "gru": [kernels.gru.NAME_FWD, kernels.gru.NAME_BWD],
             "rnn": [kernels.simple_rnn.NAME_FWD,
                     kernels.simple_rnn.NAME_BWD]}

    def family(cell, hidden, b=text_rnn.BATCH):
        if cell == "lstm" and not kernels.lstm.supported(
                b, hidden, "tanh", "sigmoid", "tanh", None):
            return "lstm_blocked"
        return cell

    batch = text_rnn.samples(seed, text_rnn.BATCH)[:F16_CHECK_BATCH]
    out, launches = {}, {}
    for cell, hidden in F16_DSL:
        what = f"train_dsl_f16 {cell} h{hidden}"

        def step(device, record, argmax=None):
            tr = dsl_trainer(torch, device, cell, hidden, torch.float16)
            with pool_probe(torch, record, argmax):
                total, _ = tr._forward(DataFeeder(feeding,
                                                  device=tr.device)(batch))
            tr._backward(total)
            grads = [p.grad.detach().cpu() for p in tr._leaves]
            tr._update()
            return tr, float(total.detach()), grads

        with f16_policy():
            kernels.reset_launches()
            rec_c, rec_w = [], []
            card, loss_c, grads_c = step(dev, rec_c)
            got = low_launches(kernels)
            after = card.test(lambda: iter([batch]), feeding=feeding)
            witness, loss_w, grads_w = step("cpu", rec_w,
                                            [r["argmax"] for r in rec_c])
        want = {f"{n}[xf32_wf16]": 2
                for n in names[family(cell, hidden, len(batch))]}
        if got != want:
            fail(f"{what}: float16 launches {got}, want {want}")
        loss_err = abs(loss_c - loss_w) / abs(loss_w)
        l2 = grad_rel_l2(grads_c, grads_w)
        if not loss_err <= TRAIN_REL_TOL or not max(l2) <= F16_GRAD_TOL \
                or not after < loss_c:
            fail(f"{what}: first float16 step on the card vs the CPU: loss "
                 f"rel err {loss_err} (bound {TRAIN_REL_TOL}), gradients' "
                 f"relative L2 {dict(zip(leaf_names(witness.parameters), l2))}"
                 f" (bound {F16_GRAD_TOL}); the batch's cost {loss_c} before "
                 f"the update, {after} after (must fall)")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        out[f"{cell}_h{hidden}"] = {
            "rows": len(batch), "loss_rel_err": loss_err,
            "grad_rel_l2_max": max(l2), "cost_before_after_update":
                [loss_c, after], "launches": got,
            "pool_argmax_flips_card_vs_witness": sum(
                int((a["argmax"] != b["argmax"]).sum())
                for a, b in zip(rec_c, rec_w))}
        del card, witness
    emb = {}
    for cell, hidden in BF16_EMB_FED:
        what = f"train_dsl_f16 embedding-fed {cell} h{hidden}"
        want = {f"{n}[xf16_wf16]": 1 for n in names[family(cell, hidden)]}
        ids = text_rnn.samples(seed, text_rnn.BATCH, vocab=BF16_EMB_VOCAB)
        with f16_policy():
            tr = dsl_trainer(torch, dev, cell, hidden, torch.float16,
                             vocab=BF16_EMB_VOCAB, emb_fed=True)
            _, losses, per_step = dsl_steps(torch, kernels, tr, ids, 1, what,
                                            want, vocab=BF16_EMB_VOCAB)
        del tr
        for k in want:
            launches[k] = launches.get(k, 0) + sum(n[k] for n in per_step)
        emb[f"{cell}_h{hidden}"] = {"launches_per_step": want,
                                    "losses": losses}
    emit({"phase": "train_dsl_f16", "config": {
        "model": "models/text_rnn (layer DSL)", "vocab": text_rnn.VOCAB,
        "emb": text_rnn.EMB, "layers": text_rnn.LAYERS,
        "first_step_rows": F16_CHECK_BATCH, "seq_len": text_rnn.SEQ_LEN,
        "optimizer": "Momentum lr 0.01 m 0.9",
        "compute_dtype": "float16 (SGD(compute_dtype=) + set_policy)",
        "embedding_fed": {"vocab": BF16_EMB_VOCAB, "layers": 1, "steps": 1,
                          "batch": text_rnn.BATCH}},
        "bound": {"loss": TRAIN_REL_TOL, "grad_rel_l2": F16_GRAD_TOL},
        "cells": out, "embedding_fed": emb, "launches": launches})
    return launches


def beam_agreement(what, ref, got, ref_trace, got_trace, n):
    """Two beam searches of the same first ``n`` rows (BeamResults and
    their per-step traces) held as BEAM_MARGIN says: per row, every step
    before the first near-tie (either run's K-th / (K+1)-th candidate gap
    below BEAM_MARGIN) must pick the same source lanes and tokens with
    scores within BEAM_SCORE_RTOL; a row with no near-tie must end with
    equal tokens, lengths and scores.  Returns the counts."""
    gaps = [np.stack([step["gap"].cpu().numpy()[:n] for step in trace])
            for trace in (ref_trace, got_trace)]
    steps = gaps[0].shape[0]
    near = (gaps[0] < BEAM_MARGIN) | (gaps[1] < BEAM_MARGIN)   # [T, n]
    cut = np.where(near.any(0), near.argmax(0), steps)
    worst, full = 0.0, 0

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float(((a - b).abs() / a.abs().clamp(min=1e-30)).max())

    for r in range(n):
        for t in range(int(cut[r])):
            a, b = ref_trace[t], got_trace[t]
            same = all(torch_equal(a[key][r], b[key][r])
                       for key in ("src", "tok"))
            err = rel(a["top"][r], b["top"][r])
            worst = max(worst, err)
            if not same or not err <= BEAM_SCORE_RTOL:
                fail(f"{what}: row {r} step {t} (before its first near-tie "
                     f"at step {int(cut[r])}): lanes and tokens equal "
                     f"{same}, score rel err {err} (bound "
                     f"{BEAM_SCORE_RTOL})")
        if cut[r] == steps:
            full += 1
            same = (torch_equal(ref.tokens[r], got.tokens[r])
                    and torch_equal(ref.lengths[r], got.lengths[r]))
            err = rel(ref.scores[r], got.scores[r])
            worst = max(worst, err)
            if not same or not err <= BEAM_SCORE_RTOL:
                fail(f"{what}: row {r} (no near-tie): final tokens and "
                     f"lengths equal {same}, score rel err {err}")
    return {"rows": n, "rows_without_near_tie": full,
            "steps_compared": int(cut.sum()), "steps": steps * n,
            "score_rel_err_max": worst, "margin": BEAM_MARGIN,
            "score_rtol": BEAM_SCORE_RTOL}


def beam_rescore(torch, res, logits_fn, bos_id, length_penalty):
    """Each beam of ``res`` scored again by teacher forcing: the sum of its
    tokens' log-probs (``logits_fn(prev ids [B*K, T]) -> [B*K, T, V]``)
    up to and including its eos, length-normalized as beam_search
    normalizes -> [B, K] on the logits' device."""
    b, k, t = res.tokens.shape
    toks = res.tokens.reshape(b * k, t).long()
    prev = torch.cat([torch.full_like(toks[:, :1], bos_id), toks[:, :-1]],
                     dim=1)
    with torch.no_grad():
        lp = torch.log_softmax(logits_fn(prev.int()), dim=-1)
    toks = toks.to(lp.device)
    lp = lp.gather(-1, toks[..., None])[..., 0]
    lengths = res.lengths.to(lp.device)
    keep = torch.arange(t, device=lp.device)[None] \
        <= lengths.reshape(-1, 1).long()
    score = (lp * keep).sum(1).reshape(b, k)
    if length_penalty:
        norm = ((5.0 + lengths.float()) / 6.0) ** length_penalty
        score = score / torch.clamp(norm, min=1e-6)
    return score


def rescore_check(torch, what, res, rescored):
    """``res``'s scores against their teacher-forced rescoring: relative
    error, bounded by BEAM_SCORE_RTOL."""
    a, b = res.scores.double().cpu(), rescored.double().cpu()
    err = float(((a - b).abs() / a.abs().clamp(min=1e-30)).max())
    if not err <= BEAM_SCORE_RTOL:
        fail(f"{what}: beam scores vs their teacher-forced rescoring: rel "
             f"err {err} (bound {BEAM_SCORE_RTOL})")
    return err


def torch_equal(a, b):
    return bool((a.cpu() == b.cpu()).all())


def run_generate_mt(torch, dev, kernels):
    """generate_mt: bench_transformer_decode's KV-cached beam search on
    the card (seed 0 weights), its flash launches exactly MTD_FLASH,
    held against the full-recompute generate on the card (every row) and
    against a CPU run of its first MTD_CPU_ROWS rows (beam_agreement),
    its beams and the CPU run's re-scored by the full decode on the card
    (beam_rescore); MTD_TIMED timed decodes: ms per batch, emitted
    tokens/s, bit for bit on a repeat."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_map
    mt = bench.bench_transformer_decode(device=dev)
    kw, b = mt.kw, mt.src.data.shape[0]
    vocab = mt.params["out"].shape[1]
    kernels.reset_launches()
    trace = []
    t0 = time.perf_counter()
    res = transformer.generate_cached(mt.params, mt.src, trace=trace, **kw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts(kernels)
    others = recurrent_launches(kernels)
    if launches["flash_attention"] != MTD_FLASH or others \
            or sum(launches.values()) != MTD_FLASH:
        fail(f"generate_mt: kernel launches {launches} (recurrent {others}),"
             f" want the flash forward {MTD_FLASH} times and no other")
    tokens = res.tokens
    if not bool(torch.isfinite(res.scores).all()) \
            or tuple(tokens.shape) != (b, kw["beam_size"], kw["max_len"]) \
            or not bool(((tokens >= 0) & (tokens < vocab)).all()):
        fail(f"generate_mt: tokens {tuple(tokens.shape)} out of range or "
             f"scores not finite")
    times = []
    for _ in range(MTD_TIMED):
        t0 = time.perf_counter()
        again = mt.run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(again.tokens, res.tokens) \
            or not torch.equal(again.scores, res.scores):
        fail("generate_mt: a second decode of the same batch differs")
    oracle_trace = []
    t0 = time.perf_counter()
    oracle = transformer.generate(mt.params, mt.src, trace=oracle_trace,
                                  **kw)
    torch.cuda.synchronize()
    oracle_ms = (time.perf_counter() - t0) * 1e3
    vs_oracle = beam_agreement("generate_mt vs generate", oracle, res,
                               oracle_trace, trace, b)
    params_cpu = tree_map(lambda p: p.detach().cpu(), mt.params)
    rows = list(range(MTD_CPU_ROWS))
    src_cpu = SequenceBatch(mt.src.data[rows].cpu(),
                            mt.src.lengths[rows].cpu())
    cpu_trace = []
    t0 = time.perf_counter()
    cpu = transformer.generate_cached(params_cpu, src_cpu, trace=cpu_trace,
                                      **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    vs_cpu = beam_agreement("generate_mt card vs CPU", cpu, res, cpu_trace,
                            trace, MTD_CPU_ROWS)
    # the beams re-scored on the card by the full decode, teacher-forced:
    # the card's own, and the CPU run's (the card's numerics along the
    # CPU's paths, where near-ties let the two searches part)
    k, t = kw["beam_size"], kw["max_len"]

    def mt_logits(src):
        def fn(prev):
            with torch.no_grad():
                enc = transformer.encode(mt.params, src, kw["num_heads"])
                return transformer.decode(
                    mt.params, enc.repeat_interleave(k, dim=0),
                    src.mask().repeat_interleave(k, dim=0),
                    SequenceBatch(prev.to(dev), torch.full(
                        (prev.shape[0],), t, dtype=torch.int32, device=dev)),
                    kw["num_heads"])
        return fn

    rows_src = SequenceBatch(mt.src.data[rows], mt.src.lengths[rows])
    rescored = {
        "card_beams_on_card": rescore_check(
            torch, "generate_mt", res, beam_rescore(
                torch, res, mt_logits(mt.src), 0, MTD_LENGTH_PENALTY)),
        "cpu_beams_on_card": rescore_check(
            torch, "generate_mt (the CPU's beams)", cpu, beam_rescore(
                torch, cpu, mt_logits(rows_src), 0, MTD_LENGTH_PENALTY))}
    ms = float(np.median(times))
    emit({"phase": "generate_mt", "config": {
        "model": "Transformer-base MT (bench_transformer_decode)",
        "vocab": 32000, "d_model": 512, "heads": 8, "dff": 2048,
        "layers": "6+6", "batch": 32, "src_len": 128, "max_len": 128,
        "beam": 4, "length_penalty": 0.6, "weights": "seed 0"},
        "first_ms": first_ms, "ms_per_batch": ms,
        "ms_per_batch_all": times, "ms_per_step": ms / kw["max_len"],
        "tokens_per_s": mt.tokens_per_run / (ms / 1e3),
        "tflop_per_s": mt.flops_per_run / (ms / 1e3) / 1e12,
        "launches": launches, "repeat": "bit for bit",
        "oracle_generate_ms": oracle_ms, "vs_generate": vs_oracle,
        "cpu_rows_ms": cpu_ms, "vs_cpu": vs_cpu,
        "rescored_score_rel_err": rescored, "score_rtol": BEAM_SCORE_RTOL,
        "mean_best_score": float(res.scores[:, 0].mean())})
    return {"flash_attention": launches["flash_attention"]}


def run_generate_seq2seq(torch, dev, kernels):
    """generate_seq2seq: seq2seq.generate (beam S2G_BEAM, S2G_MAX_LEN
    steps) at bench_seq2seq's widths on its seed-0 weights and sources,
    the GRU forward launched S2S_DIRECTIONS times (the lean forward, one
    a direction) and nothing else, held against a CPU run of the first
    MTD_CPU_ROWS rows (beam_agreement), its beams and the CPU run's
    re-scored by the teacher-forced forward on the card (beam_rescore)."""
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.models import seq2seq
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_map
    s2s = bench.bench_seq2seq(device=dev)
    gk = kernels.gru
    kw = dict(beam_size=S2G_BEAM, max_len=S2G_MAX_LEN)
    seq2seq.generate(s2s.params, s2s.src, **kw)     # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    trace = []
    t0 = time.perf_counter()
    res = seq2seq.generate(s2s.params, s2s.src, trace=trace, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {gk.NAME_FWD: gk.launches_fwd, gk.NAME_BWD: gk.launches_bwd}
    if launches != {gk.NAME_FWD: S2S_DIRECTIONS, gk.NAME_BWD: 0} \
            or recurrent_launches(kernels) != S2S_DIRECTIONS \
            or sum(launch_counts(kernels).values()):
        fail(f"generate_seq2seq: GRU launches {launches} (recurrent "
             f"{recurrent_launches(kernels)}, attention "
             f"{launch_counts(kernels)}), want the lean forward "
             f"{S2S_DIRECTIONS} times and nothing else")
    if tuple(res.tokens.shape) != (S2S_BATCH, S2G_BEAM, S2G_MAX_LEN) \
            or not bool(torch.isfinite(res.scores).all()):
        fail(f"generate_seq2seq: tokens {tuple(res.tokens.shape)}, scores "
             f"finite {bool(torch.isfinite(res.scores).all())}")
    rows = list(range(MTD_CPU_ROWS))
    params_cpu = tree_map(lambda p: p.detach().cpu(), s2s.params)
    src_cpu = SequenceBatch(s2s.src.data[rows].cpu(),
                            s2s.src.lengths[rows].cpu())
    cpu_trace = []
    cpu = seq2seq.generate(params_cpu, src_cpu, trace=cpu_trace, **kw)
    vs_cpu = beam_agreement("generate_seq2seq card vs CPU", cpu, res,
                            cpu_trace, trace, MTD_CPU_ROWS)

    def s2s_logits(src):
        def fn(prev):
            with torch.no_grad():
                tile = lambda x: x.repeat_interleave(S2G_BEAM, dim=0)
                return seq2seq.forward(
                    s2s.params, SequenceBatch(tile(src.data),
                                              tile(src.lengths)),
                    SequenceBatch(prev.to(dev), torch.full(
                        (prev.shape[0],), S2G_MAX_LEN, dtype=torch.int32,
                        device=dev)))
        return fn

    rows_src = SequenceBatch(s2s.src.data[rows], s2s.src.lengths[rows])
    rescored = {
        "card_beams_on_card": rescore_check(
            torch, "generate_seq2seq", res, beam_rescore(
                torch, res, s2s_logits(s2s.src), 0, 0.0)),
        "cpu_beams_on_card": rescore_check(
            torch, "generate_seq2seq (the CPU's beams)", cpu, beam_rescore(
                torch, cpu, s2s_logits(rows_src), 0, 0.0))}
    emit({"phase": "generate_seq2seq", "config": {
        "model": "attention NMT (bench_seq2seq)", "vocab": S2S_VOCAB,
        "emb": S2S_HIDDEN, "hidden": S2S_HIDDEN, "batch": S2S_BATCH,
        "src_len": S2S_LEN, "beam": S2G_BEAM, "max_len": S2G_MAX_LEN,
        "length_penalty": 0.0, "weights": "seed 0"},
        "ms_per_batch": ms, "ms_per_step": ms / S2G_MAX_LEN,
        "tokens_per_s": S2S_BATCH * S2G_MAX_LEN / (ms / 1e3),
        "launches": launches, "vs_cpu": vs_cpu,
        "rescored_score_rel_err": rescored, "score_rtol": BEAM_SCORE_RTOL,
        "mean_best_score": float(res.scores[:, 0].mean())})
    return launches


# ------------------------------------------------------------- images

# The image stack (ops/conv, ops/norm, layers/vision, models/lenet,
# smallnet, alexnet, googlenet, resnet, image_dsl): no kernel of the
# port's own on its path -- convolution, pooling and batch norm are
# PyTorch's calls (cuDNN), as they are XLA's in JAX -- so its phases
# launch none of the counted kernels; they hold each first step against
# the CPU and time the rest.  Every first step on the card is held
# against a CPU witness that keeps the card's ReLU and max-pool
# decisions (image_probe: a value within rounding of a ReLU's kink or a
# pool window's tie flips between devices, and each flip moves its
# channel's gradients by O(1) where batch norm sees few values), and
# reported beside the plain CPU step with the flips counted.  Readings
# are per leaf: the max abs difference over the leaf's largest entry.
# IMAGE_REL_TOL bounds the models without batch norm (LeNet, SmallNet,
# AlexNet, GoogLeNet: float32 sums in other orders, ~1e-6 a layer) and
# the loss of every model; RESNET_REL_TOL the models with batch norm,
# whose normalization over the batch multiplies the two sides' rounding
# differences through its depth (the CPU tests hold ResNet-50's train
# step's stats at 64x64, batch 2, within 1e-4 of the largest entry).  A
# control step with cuDNN's TF32 switched on and the card's decisions
# replayed must fail ResNet-50's gate.  Readings (NVIDIA H100 80GB HBM3,
# 700 W; the largest gradient / state leaf, sound / control): 1.35e-4 /
# 0.191 and 6.4e-6 / 1.10e-2, the limit between them.
IMAGE_REL_TOL = 1e-4
RESNET_REL_TOL = 1e-3
# A conv's bias ahead of a batch norm has no gradient in exact arithmetic
# (the mean takes it out): after a step it and its momentum are float32
# rounding, ~1e-9, on both devices.  The DSL steps' leaves are held at
# tol times their largest entry plus IMAGE_NOISE.
IMAGE_NOISE = 1e-7
RESNET_CHECK_BATCH = 4         # ResNet-50's first step on the CPU
IMAGE_CHECK_BATCH = 2          # SmallNet, AlexNet, GoogLeNet on the CPU
IMAGE_WARMUP, IMAGE_STEPS = 2, 5
LENET_BATCHES = 16             # demo/mnist batches of 128 through SGD
LENET_CLI_BATCHES = 4
DSL_RESNET_DEPTH, DSL_RESNET_BATCH = 32, 128
DSL_RESNET_CHECK, DSL_RESNET_BATCHES = 16, 8
LENET_CLI_CONFIG = """\
from paddle_tpu_torch.models import image_dsl


def get_config():
    return image_dsl.mnist_config(n_batches=int(CONFIG_ARGS["batches"]))
"""


@contextlib.contextmanager
def image_probe(torch, record, given=None):
    """Within it, every ReLU of the image stack (``torch.relu``, which
    the ResNet blocks call, and ops/activations' "relu", which the conv
    and fc layers take) and every max pool (``ops/conv.max_pool2d``)
    append their decisions to ``record`` in call order: ReLU's mask
    (x > 0), the pool's argmax in its padded input.  With ``given`` (a
    record of another run) they take those decisions instead, gradient
    and all: a step that keeps another run's decisions."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import activations, conv
    relu, act, pool = torch.relu, activations._REGISTRY["relu"], \
        conv.max_pool2d
    it = iter(given or ())

    def probe_relu(x):
        if given is None:
            record.append((x > 0).cpu())
            return relu(x)
        mask = next(it).to(x.device)
        record.append(mask.cpu())
        return torch.where(mask, x, torch.zeros_like(x))

    def probe_pool(x, window, stride=None, padding=(0, 0)):
        stride = stride or window
        pad = conv._pool_pad(padding)
        xc = x.permute(0, 3, 1, 2)
        if any(pad):
            xc = F.pad(xc, pad, value=float("-inf"))
        if given is None:
            out, idx = F.max_pool2d(xc, tuple(window), tuple(stride),
                                    return_indices=True)
        else:
            idx = next(it).to(x.device)
            out = xc.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        record.append(idx.cpu())
        return out.permute(0, 2, 3, 1)

    torch.relu = activations._REGISTRY["relu"] = probe_relu
    conv.max_pool2d = probe_pool
    try:
        yield
    finally:
        torch.relu, activations._REGISTRY["relu"] = relu, act
        conv.max_pool2d = pool


def image_first_step(torch, dev, what, loss_fn, params, state, tol,
                     control=None):
    """One step of ``loss_fn(params, state, device) -> (loss, new
    state)`` from the same CPU ``params`` / ``state`` trees on the card
    (under image_probe), on a CPU witness that keeps the card's decisions
    and on the plain CPU: the loss and every gradient and new-state leaf
    of the card within ``tol`` of the witness (largest_err; the loss
    within IMAGE_REL_TOL), the plain step's readings and the flips
    reported.  ``control``: a context under which the card's step, its
    decisions replayed from the sound card step so that only precision
    differs, must FAIL the same gate (cuDNN's TF32).  Returns the
    readings."""
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map

    def step(device, record, given=None, ctx=None):
        p = tree_map(lambda t: t.detach().to(device).clone()
                     .requires_grad_(True), params)
        st = tree_map(lambda t: t.to(device), state)
        with (ctx or contextlib.nullcontext)(), image_probe(
                torch, record, given):
            loss, new_state = loss_fn(p, st, device)
            loss.backward()
        return (float(loss.detach()), [x.grad.cpu() for x in tree_leaves(p)],
                [x.detach().cpu() for x in tree_leaves(new_state)])

    def readings(got, ref):
        return {"loss_rel_err": abs(got[0] - ref[0]) / abs(ref[0]),
                "grad_rel_err_max": max(largest_err(got[1], ref[1])),
                "state_rel_err_max": max(largest_err(got[2], ref[2]),
                                         default=0.0)}

    def passes(r):
        return r["loss_rel_err"] <= IMAGE_REL_TOL \
            and r["grad_rel_err_max"] <= tol and r["state_rel_err_max"] <= tol

    t0 = time.perf_counter()
    card_rec, wit_rec, plain_rec = [], [], []
    card = step(dev, card_rec)
    torch.cuda.synchronize()
    witness = step("cpu", wit_rec, card_rec)
    plain = step("cpu", plain_rec)
    flips = sum(int((a != b).sum()) for a, b in zip(card_rec, plain_rec))
    out = {"vs_witness": readings(card, witness),
           "vs_plain_cpu_step": readings(card, plain),
           "decision_flips_vs_plain_cpu": flips,
           "decisions": sum(a.numel() for a in card_rec), "tolerance": tol,
           "loss_tolerance": IMAGE_REL_TOL}
    if not passes(out["vs_witness"]):
        fail(f"{what}: the first step on the card against the CPU witness "
             f"{out}")
    if control is not None:
        ctl = readings(step(dev, [], card_rec, ctx=control), witness)
        out["control"] = {"what": "cuDNN TF32 on (allow_tf32=True), the "
                          "card's decisions replayed", **ctl}
        if passes(ctl):
            fail(f"{what}: the TF32 control passes the first-step gate: "
                 f"{out}")
    out["seconds"] = time.perf_counter() - t0
    return out


@contextlib.contextmanager
def cudnn_tf32(torch):
    """cuDNN's TF32 convolutions on for the block (``device.resolve``
    keeps them off)."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def timed_steps(torch, step, warmup=IMAGE_WARMUP, steps=IMAGE_STEPS):
    """``warmup`` then ``steps`` calls of ``step()`` -> loss, each ending
    in a synchronize: (ms per step, losses)."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return times, losses


def host_tree(tree):
    from paddle_tpu_torch.utils.tree import tree_map
    return tree_map(lambda t: t.detach().cpu().clone(), tree)


def run_train_resnet50(torch, dev, kernels):
    """bench.py's bench_resnet50 ported (scripts/bench.bench_resnet50:
    batch 32 of 224x224x3, 1000 classes, Momentum lr 0.1 m 0.9, remat
    off): the first step at RESNET_CHECK_BATCH rows against the CPU
    (image_first_step, with the TF32 control), then warm-up and timed
    steps at batch 32 (ms/batch, images/s), the loss finite, the moving
    stats moved, ``features`` against the forward's pooled tensor, and no
    counted kernel launched."""
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.scripts import bench as bench_mod
    from paddle_tpu_torch.utils.tree import tree_leaves
    b = bench_mod.bench_resnet50(device=dev)
    params, state = host_tree(b.params), host_tree(b.state["state"])
    images = b.images[:RESNET_CHECK_BATCH].cpu()
    labels = b.labels[:RESNET_CHECK_BATCH].cpu()

    def loss_fn(p, st, device):
        return resnet.loss(p, st, images.to(device), labels.to(device),
                           depth=50)
    first = image_first_step(torch, dev, "train_resnet50", loss_fn, params,
                             state, RESNET_REL_TOL,
                             control=lambda: cudnn_tf32(torch))
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, losses = timed_steps(torch, b.train_step)
    ms = float(np.median(times))
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_resnet50: loss not finite: {losses}")
    moved = max(float((a.cpu() - c).abs().max()) for a, c in zip(
        tree_leaves(b.state["state"]), tree_leaves(state)))
    with torch.no_grad():
        x = b.images[:8]
        feats = resnet.features(b.params, b.state["state"], x, depth=50)
        pooled, _ = resnet.forward(b.params, b.state["state"], x, depth=50,
                                   train=False, return_pool=True)
    feat_err = float((feats - pooled).abs().max())
    if not moved > 0 or feat_err > 1e-6 * float(pooled.abs().max()):
        fail(f"train_resnet50: moving stats moved by {moved}; features vs "
             f"the forward's pooled tensor {feat_err}")
    launches = {**launch_counts(kernels),
                "recurrent": recurrent_launches(kernels)}
    if any(launches.values()):
        fail(f"train_resnet50: counted kernels launched {launches}")
    emit({"phase": "train_resnet50", "config": {
        "model": "models/resnet depth 50", "batch": 32,
        "image": [224, 224, 3], "classes": 1000,
        "optimizer": "Momentum lr 0.1 m 0.9", "remat": b.remat,
        "cpu_check_batch": RESNET_CHECK_BATCH},
        "steps_timed": len(times), "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times), max(times)],
        "images_per_s": 32 / (ms / 1e3),
        "tflop_per_s": b.flops_per_step / (ms / 1e3) / 1e12,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "losses": losses, "moving_stats_moved_max": moved,
        "features_vs_pooled_max_abs": feat_err,
        "features_bit_for_bit": bool(torch.equal(feats, pooled)),
        "first_step_vs_cpu": first})
    F32_MS["train_resnet50"] = ms
    return ms


def run_train_image(torch, dev, kernels):
    """bench.py's bench_image ported: SmallNet (batch 64, 32x32, 10
    classes), AlexNet (64, 227x227, 1000) and GoogLeNet (64, 224x224,
    1000), Momentum lr 0.01 m 0.9: each first step at IMAGE_CHECK_BATCH
    rows against the CPU, then warm-up and timed steps at the bench's
    batch, beside the reference's K40m time for the config."""
    from paddle_tpu_torch.scripts import bench as bench_mod
    out = {}
    for name in ("smallnet", "alexnet", "googlenet"):
        b = bench_mod.bench_image(name, device=dev)
        mod = bench_mod._IMAGE_MODELS[name]
        params = host_tree(b.params)
        images = b.images[:IMAGE_CHECK_BATCH].cpu()
        labels = b.labels[:IMAGE_CHECK_BATCH].cpu()

        def loss_fn(p, st, device, mod=mod, images=images, labels=labels):
            return mod.loss(p, st, images.to(device), labels.to(device))
        first = image_first_step(torch, dev, f"train_image {name}", loss_fn,
                                 params, {}, IMAGE_REL_TOL)
        # the losses are reported, not gated: the bench's config (lr 0.01
        # on random images and labels) may diverge within the steps
        times, losses = timed_steps(torch, b.train_step)
        ms = float(np.median(times))
        batch, hw, classes, _ = bench_mod.IMAGE_CONFIGS[name]
        out[name] = {"batch": batch, "image": [hw, hw, 3],
                     "classes": classes, "steps_timed": len(times),
                     "ms_per_batch": ms,
                     "ms_per_batch_min_max": [min(times), max(times)],
                     "images_per_s": batch / (ms / 1e3),
                     "tflop_per_s": b.flops_per_step / (ms / 1e3) / 1e12,
                     "reference_k40m_ms_per_batch":
                         bench_mod.IMAGE_K40M_MS[name],
                     "losses": losses, "first_step_vs_cpu": first}
        F32_MS[f"train_{name}"] = ms
        del b
        torch.cuda.empty_cache()
    emit({"phase": "train_image", "optimizer": "Momentum lr 0.01 m 0.9",
          "cpu_check_batch": IMAGE_CHECK_BATCH, "models": out})


@contextlib.contextmanager
def draw_probe(record, given=None):
    """Within it, every draw of the layer DSL's ``Context.uniform`` (the
    uniforms behind nce_layer's negatives, sampling_id_layer's ids and
    dropout's masks) appends its draws to ``record`` on the host, in call
    order; with ``given`` (another run's record) it takes those draws
    instead, on the asked device."""
    from paddle_tpu_torch.layers import graph
    plain, it = graph.Context.uniform, iter(given or ())

    def probe(ctx, shape, device):
        u = plain(ctx, shape, device) if given is None \
            else next(it).to(device)
        record.append(u.cpu())
        return u

    graph.Context.uniform = probe
    try:
        yield
    finally:
        graph.Context.uniform = plain


def dsl_image_step(torch, dev, what, build, feeding, batch, optimizer,
                   tol, control=None):
    """The first ``SGD.train_one_batch`` of a DSL image config on the
    card against a CPU trainer from the same weights and moving stats
    under a witness that keeps the card's decisions (ReLU, max pool) and
    its dropout masks: the loss (at IMAGE_REL_TOL), every parameter,
    momentum and moving-stat leaf after the update within ``tol`` of its
    largest entry plus IMAGE_NOISE.  ``control``: a context under which
    the same step on the card, the sound card step's decisions and masks
    replayed so that only precision differs, must FAIL that gate
    (cuDNN's TF32).  Returns (the card's trainer, readings)."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves
    card = SGD(build(), update_equation=optimizer(), device=dev, seed=0)
    start = host_tree(card.parameters)
    rec, drops = [], []
    with image_probe(torch, rec), draw_probe(drops):
        loss_c = float(card.train_one_batch(batch, feeder=feeding))

    def replay(device, ctx=None):
        tr = SGD(build(), parameters=start, update_equation=optimizer(),
                 device=device)
        # fed before the context: the feeder's device.resolve turns TF32
        # off again
        feed = DataFeeder(feeding, device=tr.device)(batch)
        with (ctx or contextlib.nullcontext)(), image_probe(
                torch, [], given=rec), draw_probe([], given=drops):
            loss = float(tr.train_one_batch(feed))
        return tr, loss

    twin, loss_w = replay("cpu")
    want = [x.detach() for x in tree_leaves(twin.parameters) + tree_leaves(
        twin.opt_state["slots"]) + tree_leaves(twin.model_state)]

    def readings(tr, loss):
        got = [x.detach().cpu() for x in tree_leaves(tr.parameters)
               + tree_leaves(tr.opt_state["slots"])
               + tree_leaves(tr.model_state)]
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        bounds = [tol * float(w.abs().max()) + IMAGE_NOISE for w in want]
        return {"loss": [loss, loss_w],
                "loss_rel_err": abs(loss - loss_w) / abs(loss_w),
                "leaf_rel_err_max": max(largest_err(*zip(*[
                    (g, w) for g, w in zip(got, want)
                    if float(w.abs().max()) > IMAGE_NOISE]))),
                "leaf_err_over_bound_max": max(e / b for e, b in
                                               zip(errs, bounds))}

    def passes(r):
        return r["loss_rel_err"] <= IMAGE_REL_TOL \
            and r["leaf_err_over_bound_max"] <= 1.0

    out = {**readings(card, loss_c),
           "noise_leaves": sum(float(w.abs().max()) <= IMAGE_NOISE
                               for w in want),
           "leaves": len(want),
           "moving_stat_leaves": len(tree_leaves(card.model_state)),
           "dropout_masks_replayed": len(drops),
           "tolerance": tol, "noise": IMAGE_NOISE}
    if not passes(out):
        fail(f"{what}: the first SGD step on the card against the CPU "
             f"witness: {out}")
    if control is not None:
        ctl = readings(*replay(dev, control))
        out["control"] = {"what": "cuDNN TF32 on (allow_tf32=True), the "
                          "card's decisions and masks replayed", **ctl}
        if passes(ctl):
            fail(f"{what}: the TF32 control passes the first-step gate: "
                 f"{out}")
    return card, out


def run_train_lenet(torch, dev, kernels, seed):
    """demo/mnist's config (models/image_dsl.lenet, rebuilt with
    paddle_tpu_torch.layers) on the mnist loader's data (its synthetic
    fallback): the first SGD step against the CPU, then SGD.train over
    LENET_BATCHES batches of 128 (the loss falls), SGD.test, and `python
    -m paddle_tpu_torch train` on a config file, whose pass dir SGD.load
    restores bit for bit."""
    from paddle_tpu_torch.models import image_dsl
    from paddle_tpu_torch.optim import Momentum
    from paddle_tpu_torch.trainer import SGD
    cfg = image_dsl.mnist_config(n_batches=LENET_BATCHES)
    data = list(cfg["train_reader"]())
    feeding = cfg["feeding"]

    def build():
        return image_dsl.lenet()[0]

    def optimizer():
        return Momentum(learning_rate=0.01, momentum=0.9)
    card, first = dsl_image_step(torch, dev, "train_lenet", build, feeding,
                                 data[0], optimizer, IMAGE_REL_TOL)
    times, losses, _ = sgd_pass(torch, kernels, card, data, feeding,
                                "train_lenet")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"train_lenet: the loss must fall: {losses}")
    test_cost = card.test(cfg["test_reader"], feeding=feeding)
    cli = rnn_cli(torch, dev, seed, card, what="train_lenet",
                  config=LENET_CLI_CONFIG, batches=LENET_CLI_BATCHES,
                  fresh=lambda: SGD(build(), update_equation=optimizer(),
                                    device=dev))
    ms = float(np.median(times[3:]))
    emit({"phase": "train_lenet", "config": {
        "model": "demo/mnist (models/image_dsl.lenet, layer DSL)",
        "batch": image_dsl.MNIST_BATCH, "batches": LENET_BATCHES,
        "data": "data.datasets.mnist (synthetic fallback unless "
                "PADDLE_TPU_DATA_DIR holds the files)",
        "optimizer": "Momentum lr 0.01 m 0.9",
        "entry": "trainer.SGD.train"},
        "ms_per_batch": ms, "images_per_s": image_dsl.MNIST_BATCH
        / (ms / 1e3), "losses": losses, "test_cost": test_cost,
        "first_step_vs_cpu": first, "cli": cli})
    F32_MS["train_lenet"] = ms


def run_train_resnet_cifar(torch, dev, kernels):
    """demo/image_classification's DSL ResNet (models/image_dsl
    .resnet_cifar: conv, batch_norm_layer and addto_layer) at depth 32 on
    CIFAR shapes through SGD: the first step at DSL_RESNET_CHECK rows
    against the CPU (parameters, momentum and moving stats), then
    SGD.train over DSL_RESNET_BATCHES batches of 128 with the moving
    stats threading through the steps, and SGD.test reading them."""
    from paddle_tpu_torch.models import image_dsl
    from paddle_tpu_torch.optim import Momentum
    from paddle_tpu_torch.utils.tree import tree_leaves
    cfg = image_dsl.cifar_config(DSL_RESNET_DEPTH,
                                 n_batches=DSL_RESNET_BATCHES,
                                 batch=DSL_RESNET_BATCH)
    data = list(cfg["train_reader"]())
    feeding = cfg["feeding"]

    def build():
        return image_dsl.cifar_resnet(DSL_RESNET_DEPTH)[0]

    def optimizer():
        return Momentum(learning_rate=0.01, momentum=0.9, l2=1e-4)
    card, first = dsl_image_step(torch, dev, "train_resnet_cifar", build,
                                 feeding, data[0][:DSL_RESNET_CHECK],
                                 optimizer, RESNET_REL_TOL)
    before = host_tree(card.model_state)
    times, losses, _ = sgd_pass(torch, kernels, card, data, feeding,
                                "train_resnet_cifar")
    moved = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(card.model_state), tree_leaves(before)))
    test_cost = card.test(cfg["test_reader"], feeding=feeding)
    if not (math.isfinite(test_cost) and moved > 0):
        fail(f"train_resnet_cifar: losses {losses}, test {test_cost}, "
             f"moving stats moved {moved}")
    ms = float(np.median(times[2:]))
    emit({"phase": "train_resnet_cifar", "config": {
        "model": "demo/image_classification resnet_cifar "
                 "(models/image_dsl, layer DSL)",
        "depth": DSL_RESNET_DEPTH, "batch": DSL_RESNET_BATCH,
        "image": [32, 32, 3], "batches": DSL_RESNET_BATCHES,
        "optimizer": "Momentum lr 0.01 m 0.9 l2 1e-4",
        "entry": "trainer.SGD.train", "cpu_check_batch": DSL_RESNET_CHECK},
        "ms_per_batch": ms, "images_per_s": DSL_RESNET_BATCH / (ms / 1e3),
        "losses": losses, "test_cost": test_cost,
        "moving_stat_layers": len(card.model_state),
        "moving_stats_moved_max": moved, "first_step_vs_cpu": first})


# The demos of the networks / recommendation / text slice.
# train_recommendation: demo/recommendation's step at full width.  The
# first step on the card and on the CPU from the same weights and batch
# run the same float32 arithmetic (cuBLAS with TF32 off) in other
# summation orders, the embedding tables' backward accumulating with
# atomics on the card: the loss, every gradient leaf and every parameter
# after the Adam step are held within REC_TOL (the parameters
# REC_PARAM_TOL) of their largest entry, and the same step with cuBLAS's
# TF32 on must fail that gate.
REC_TOL = 1e-5
# Adam's first step moves each entry by lr g / (|g| + eps): an entry
# whose gradient lies within rounding of eps moves by a share of lr that
# differs between the devices, so the new parameters are held at
# REC_PARAM_TOL of their largest entry (on an H100: 1.8e-5 sound,
# 3.9e-2 under TF32; PERF.md §6).
REC_PARAM_TOL = 1e-3
REC_WARMUP = 3                 # steps of the pass left out of ms/batch
# train_vgg_cifar: the image_classification demo's vgg through SGD at
# batch 128 of the cifar loader, the first step at VGG_CHECK rows
# against the CPU witness (decisions and dropout masks replayed) at
# VGG_REL_TOL, which cuDNN's TF32 must fail; then VGG_PASSES passes over
# the loader's VGG_BATCHES batches.  The demo's lr 0.01 (momentum 0.9)
# on its 16384-wide fc diverges over the first ~8 steps in both
# packages (JAX's trainer on the same batches: 2.73 -> 122.95 by step
# 7) before the loss comes back down, so the loss is held to fall over
# the passes: the mean of the last VGG_TAIL steps below the first
# step's.
VGG_REL_TOL = 1e-5
VGG_CHECK, VGG_BATCHES, VGG_PASSES, VGG_TAIL = 32, 32, 2, 8
# train_sentiment: the sentiment demo's stacked LSTM through SGD at hid
# 128, batch 64 of the imdb loader's ragged reviews.  Each step launches
# B9's forward and its BPTT + dW_r once per lstmemory (3 + 3); the first
# step's loss and every gradient leaf against a CPU witness that
# max-pools at the card's argmax (the plain CPU step reported beside) at
# SENT_TOL, which the same step through the one-TF32-pass LSTM build
# must fail.  quick_start's lstm config: its first step likewise (1 + 1
# launches) and QS_STEPS more.
SENT_TOL = 2e-5
SENT_BATCHES, SENT_CLI_BATCHES, QS_STEPS = 16, 2, 4
SENTIMENT_CLI_CONFIG = "paddle_tpu_torch/models/text_dsl.py"


@contextlib.contextmanager
def cublas_tf32(torch):
    """cuBLAS's TF32 products on for the block (``device.resolve`` keeps
    them off)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def run_train_recommendation(torch, dev, kernels):
    """demo/recommendation's step (scripts/bench.bench_recommendation:
    the MovieLens towers at emb 256, hidden 256, batch 128 of the
    movielens loader, Adam lr 1e-3): the first step on the card against
    the same step on the CPU (loss and gradients within REC_TOL, new
    parameters within REC_PARAM_TOL of their largest entry), which the
    step with cuBLAS's TF32 on must fail; then one pass over the loader (the loss falls, no
    counted kernel launched), ms/batch and samples/s."""
    from paddle_tpu_torch.models import recommendation
    from paddle_tpu_torch.optim import Adam
    from paddle_tpu_torch.scripts import bench as bench_mod
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
    b = bench_mod.bench_recommendation(device=dev)
    start, batch = host_tree(b.params), b.batches[0]

    def step(device, ctx=None):
        p = tree_map(lambda t: t.to(device).clone().requires_grad_(True),
                     start)
        opt = Adam(learning_rate=1e-3)
        state = opt.init(p)
        feed = recommendation.feed_batch(batch, device=device)
        with (ctx or contextlib.nullcontext)():
            loss = recommendation.loss(p, *feed)
            loss.backward()
            grads = [x.grad.detach().cpu() for x in tree_leaves(p)]
            opt.update(tree_map(lambda x: x.grad, p), state, p)
        return (float(loss.detach()), grads,
                [x.detach().cpu() for x in tree_leaves(p)])

    def readings(got, ref):
        return {"loss_rel_err": abs(got[0] - ref[0]) / abs(ref[0]),
                "grad_rel_err_max": max(largest_err(got[1], ref[1])),
                "param_rel_err_max": max(largest_err(got[2], ref[2]))}

    t0 = time.perf_counter()
    cpu = step("cpu")
    sound = readings(step(dev), cpu)
    control = readings(step(dev, lambda: cublas_tf32(torch)), cpu)
    first = {"vs_cpu": sound, "control": {
        "what": "cuBLAS TF32 on (matmul.allow_tf32=True)", **control},
        "tolerance": REC_TOL, "seconds": time.perf_counter() - t0}
    def passes(r):
        return max(r["loss_rel_err"], r["grad_rel_err_max"]) <= REC_TOL \
            and r["param_rel_err_max"] <= REC_PARAM_TOL

    first["param_tolerance"] = REC_PARAM_TOL
    if not passes(sound) or passes(control):
        fail(f"train_recommendation: the first step must pass the gate "
             f"against the CPU and its TF32 control fail it: {first}")
    kernels.reset_launches()
    times, losses = [], []
    for _ in b.batches:
        t1 = time.perf_counter()
        loss = b.train_step()
        losses.append(float(loss))       # a synchronize
        times.append((time.perf_counter() - t1) * 1e3)
    launches = {**launch_counts(kernels),
                "recurrent": recurrent_launches(kernels)}
    if any(launches.values()):
        fail(f"train_recommendation: counted kernels launched {launches}")
    if not (all(math.isfinite(x) for x in losses)
            and np.mean(losses[-4:]) < np.mean(losses[:4])):
        fail(f"train_recommendation: the loss must be finite and fall over "
             f"the pass: {losses}")
    ms = float(np.median(times[REC_WARMUP:]))
    emit({"phase": "train_recommendation", "config": {
        "model": "models/recommendation (demo/recommendation)",
        "emb": 256, "hidden": 256, "batch": b.batch,
        "batches": len(b.batches),
        "data": "data.datasets.movielens train (synthetic fallback unless "
                "PADDLE_TPU_DATA_DIR holds ml-1m), shuffled",
        "optimizer": "Adam lr 1e-3", "entry": "the demo's step, "
        "feed_batch included (scripts/bench.bench_recommendation)"},
        "ms_per_batch": ms, "ms_per_batch_min_max": [min(times[REC_WARMUP:]),
                                                     max(times[REC_WARMUP:])],
        "samples_per_s": b.batch / (ms / 1e3), "losses": losses,
        "first_step_vs_cpu": first})
    F32_MS["train_recommendation"] = ms


def lstm_gru_launches(kernels):
    lk, gk = kernels.lstm, kernels.gru
    return {lk.NAME_FWD: lk.launches_fwd, lk.NAME_BWD: lk.launches_bwd,
            gk.NAME_FWD: gk.launches_fwd, gk.NAME_BWD: gk.launches_bwd}


def lstm_gru_counts(kernels):
    """lstm_gru_launches since the last reset, and every other counted
    kernel's launches under "other"."""
    n = lstm_gru_launches(kernels)
    n["other"] = (sum(launch_counts(kernels).values())
                  + recurrent_launches(kernels) - sum(n.values()))
    return n


def want_counts(kernels, **named):
    """lstm_gru_counts' shape with the given launches (fwd/bwd of "lstm" /
    "gru"), every other count 0."""
    lk, gk = kernels.lstm, kernels.gru
    names = {"lstm_fwd": lk.NAME_FWD, "lstm_bwd": lk.NAME_BWD,
             "gru_fwd": gk.NAME_FWD, "gru_bwd": gk.NAME_BWD}
    out = {name: 0 for name in names.values()}
    out.update({names[k]: v for k, v in named.items()})
    out["other"] = 0
    return out


def counted_pass(torch, kernels, trainer, data, feeding, what, want):
    """``trainer.train`` over ``data`` (a list of batches), one pass, the
    counters reset before each step and read after it: each step's wall
    time and loss from the events, and its launches (lstm_gru_counts) held
    to ``want`` (one want_counts a step).  Returns (ms, losses, the
    pass's launches by kernel)."""
    from paddle_tpu_torch.trainer import events
    record = {"ms": [], "loss": [], "launches": []}

    def handler(e):
        if isinstance(e, events.BeginIteration):
            torch.cuda.synchronize()
            kernels.reset_launches()
            record["t0"] = time.perf_counter()
        elif isinstance(e, events.EndIteration):
            record["loss"].append(float(e.cost))     # a synchronize
            record["ms"].append((time.perf_counter() - record["t0"]) * 1e3)
            record["launches"].append(lstm_gru_counts(kernels))

    trainer.train(lambda: iter(data), num_passes=1, event_handler=handler,
                  feeding=feeding, log_period=0)
    losses = record["loss"]
    if len(losses) != len(data) or not all(math.isfinite(x) for x in losses):
        fail(f"{what}: {len(losses)} steps of {len(data)}, losses {losses}")
    if record["launches"] != want:
        fail(f"{what}: per-step launches {record['launches']}, want {want}")
    return record["ms"], losses, {
        k: sum(n[k] for n in record["launches"])
        for k in lstm_gru_launches(kernels)}


def add_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0] if k != "other"}


def sgd_pass(torch, kernels, trainer, data, feeding, what, per_step=(0, 0)):
    """counted_pass with each step's LSTM (forward, backward) launches
    held to ``per_step`` and no other counted kernel launched.  Returns
    (ms, losses, the LSTM launches of the pass)."""
    lk = kernels.lstm
    ms, losses, n = counted_pass(
        torch, kernels, trainer, data, feeding, what,
        [want_counts(kernels, lstm_fwd=per_step[0], lstm_bwd=per_step[1])]
        * len(data))
    return ms, losses, {lk.NAME_FWD: n[lk.NAME_FWD],
                        lk.NAME_BWD: n[lk.NAME_BWD]}


def run_train_vgg_cifar(torch, dev, kernels):
    """demo/image_classification's vgg (models/image_dsl.vgg_bn_drop:
    img_conv_group of 2 convs with batch norm and a 0.3 dropout, fc 10)
    through SGD on the cifar loader's batches of 128: the first step at
    VGG_CHECK rows against the CPU witness that replays the card's ReLU,
    max-pool decisions and dropout masks (the TF32 control failing it),
    then SGD.train over VGG_PASSES passes of VGG_BATCHES batches (the
    loss falls below the first step's) and SGD.test."""
    from paddle_tpu_torch.models import image_dsl
    from paddle_tpu_torch.optim import Momentum
    cfg = image_dsl.cifar_config(model="vgg", n_batches=VGG_BATCHES)
    data = list(cfg["train_reader"]())
    feeding = cfg["feeding"]

    def build():
        return image_dsl.cifar_vgg()[0]

    def optimizer():
        return Momentum(learning_rate=0.01, momentum=0.9, l2=1e-4)
    card, first = dsl_image_step(torch, dev, "train_vgg_cifar", build,
                                 feeding, data[0][:VGG_CHECK], optimizer,
                                 VGG_REL_TOL,
                                 control=lambda: cudnn_tf32(torch))
    times, losses, _ = sgd_pass(torch, kernels, card, data * VGG_PASSES,
                                feeding, "train_vgg_cifar")
    start = first["loss"][0]
    if not np.mean(losses[-VGG_TAIL:]) < start:
        fail(f"train_vgg_cifar: the loss must fall below the first step's "
             f"{start}: {losses}")
    test_cost = card.test(cfg["test_reader"], feeding=feeding)
    ms = float(np.median(times[2:]))
    emit({"phase": "train_vgg_cifar", "config": {
        "model": "demo/image_classification vgg_bn_drop (models/image_dsl,"
                 " layer DSL: networks.img_conv_group, dropout_layer)",
        "batch": image_dsl.CIFAR_BATCH, "image": [32, 32, 3],
        "batches": VGG_BATCHES, "passes": VGG_PASSES,
        "optimizer": "Momentum lr 0.01 m 0.9 "
        "l2 1e-4", "entry": "trainer.SGD.train", "cpu_check_batch":
        VGG_CHECK}, "ms_per_batch": ms,
        "images_per_s": image_dsl.CIFAR_BATCH / (ms / 1e3),
        "losses": losses, "test_cost": test_cost,
        "first_step_vs_cpu": first})
    F32_MS["train_vgg_cifar"] = ms


def step_readings(got, ref, names=None):
    """``got`` against ``ref``, each (loss, [gradient leaves]) of one
    step: the loss's relative error and the worst leaf's error against
    its largest entry (largest_err), named where ``names`` are given."""
    errs = largest_err(got[1], ref[1])
    out = {"loss_rel_err": abs(got[0] - ref[0]) / abs(ref[0]),
           "grad_rel_err_max": max(errs)}
    if names is not None:
        out["worst_leaf"] = names[int(np.argmax(errs))]
    return out


def gate_first_step(what, card, ref, tol, control=None, names=None,
                    floors=None, **extra):
    """The train phases' first-step gate: ``card`` and ``ref``, (loss,
    [gradient leaves]) of one step from the same weights on the card and
    on the CPU, within ``tol`` (step_readings); with ``floors`` (each
    leaf's float32 noise, ``float64_floors``) each leaf within ``tol``
    of its largest entry plus FLOOR_TIMES its floor.  ``control``, (what
    it is, its (loss, leaves) on the card), must fail that gate, or the
    phase fails with both readings beside the limit.  Returns the
    readings, ``extra`` beside them."""
    def readings(got):
        r = step_readings(got, ref, names)
        if floors is not None:
            over = [float((g - w).abs().max())
                    / (tol * float(w.abs().max()) + FLOOR_TIMES * f)
                    for g, w, f in zip(got[1], ref[1], floors)]
            r["grad_err_over_bound_max"] = max(over)
            if names is not None:
                r["worst_leaf_over_bound"] = names[int(np.argmax(over))]
        return r

    def passes(r):
        return r["loss_rel_err"] <= tol and (
            r["grad_rel_err_max"] <= tol if floors is None
            else r["grad_err_over_bound_max"] <= 1.0)

    out = {"vs_cpu": readings(card), "tolerance": tol,
           "loss": [card[0], ref[0]], **extra}
    if floors is not None:
        out["float32_floor"] = {"times": FLOOR_TIMES, "largest": max(floors),
                                "of_leaf": names[int(np.argmax(floors))]
                                if names else None}
    if not passes(out["vs_cpu"]):
        fail(f"{what}: the first step on the card against the CPU: {out}")
    if control is not None:
        out["control"] = {"what": control[0], **readings(control[1])}
        if passes(out["control"]):
            fail(f"{what}: the control passes the first-step gate: {out}")
    return out


# A gradient leaf that float32 cannot resolve to ``tol`` of its largest
# entry: at init the output fc's bias gradient is the batch mean of
# p - y, and on a balanced batch it cancels to ~4e-4 while each p sits
# within 1e-4 of 0.5, where one float32 unit is 6e-8 (nested_a9f's first
# batch: card vs CPU 1.2e-8 apart, 2.8e-5 of the entry on another
# batch).  float64_floors measures each leaf's own float32 noise, the
# CPU float32 witness against the same step in float64; the gate allows
# FLOOR_TIMES of it beside ``tol`` (the card's error and the witness's
# own each add up to one noise).
FLOOR_TIMES = 4


def float64_floors(torch, build, start, feeding, batch, argmax, witness):
    """Each leaf's float32 noise: the largest difference between the CPU
    float32 witness's gradient (``witness``) and the same step's in
    float64 on the CPU (the dtype policy at float64, the weights
    widened, the card's argmax replayed; the LSTMs and GRUs through
    their masked scans, the same functions, as the kernels take no
    float64).  For a single-cost graph with no sparse table (the view's
    leaves are the parameters')."""
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.core import dtypes
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.layers.graph import value_data
    from paddle_tpu_torch.ops.kernels import gru as gk, lstm as lk, \
        lstm_blocked as bk
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
    prior = (dtypes.param_dtype(), dtypes.compute_dtype())
    routes = (lk.supported, bk.supported, gk.supported)
    dtypes.set_policy("float64", "float64")
    lk.supported = bk.supported = gk.supported = lambda *rule: False
    try:
        topo = L.Topology(build())
        params = tree_map(lambda t: t.detach().double().requires_grad_(True),
                          start)
        feed = dtypes.cast_tree(DataFeeder(feeding, device="cpu")(batch),
                                torch.float64)
        with pool_probe(torch, [], argmax):
            total = torch.mean(value_data(topo.apply(params, feed)))
        total.backward()
    finally:
        dtypes.set_policy(*prior)
        lk.supported, bk.supported, gk.supported = routes
    return [float((w.double() - p.grad).abs().max())
            for w, p in zip(witness, tree_leaves(params))]


def graph_first_step(torch, dev, kernels, build, optimizer, feeding, batch,
                     what, tol, control=None, floors=False):
    """One SGD step of the DSL cost ``build()`` on the card under
    pool_probe and on a CPU witness from the same weights (SGD's seed,
    drawn on the CPU) that max-pools at the card's argmax (for a graph
    with no max pool, the plain CPU step): the loss and every gradient
    leaf of the card within ``tol`` of the witness's largest entries;
    with ``control`` (a context), the same card step with the card's
    argmax replayed must fail that gate.  Where the card pooled, its
    readings against the plain CPU step and the argmax flips are
    reported beside.  ``floors``: each leaf's bound also takes
    FLOOR_TIMES its float32 noise (``float64_floors``).  Returns (the
    card's trainer, the start parameters, readings, the card step's LSTM
    (forward, backward) launches)."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves
    start = host_tree(SGD(cost=build(), update_equation=optimizer(),
                          device="cpu").parameters)

    def step(device, record, argmax=None, ctx=None):
        tr = SGD(cost=build(), parameters=start, update_equation=optimizer(),
                 device=device)
        feed = DataFeeder(feeding, device=tr.device)(batch)
        with (ctx or contextlib.nullcontext)(), pool_probe(torch, record,
                                                           argmax):
            total, _ = tr._forward(feed)
            view = tr._view
            tr._backward(total)
        # the leaves the step differentiates: the parameters, or with a
        # sparse table its gathered row block in the table's place
        grads = [p.grad.detach().cpu() for p in tree_leaves(view)]
        names.extend(leaf_names(view)[len(names):])
        tr._update()
        return tr, float(total.detach()), grads

    names = []      # the differentiated leaves' paths, for the readings
    t0 = time.perf_counter()
    kernels.reset_launches()
    rec_c = []
    card = step(dev, rec_c)
    launches = (kernels.lstm.launches_fwd, kernels.lstm.launches_bwd)
    argmax = [r["argmax"] for r in rec_c]
    witness = step("cpu", [], argmax)
    extra = {}
    if rec_c:
        rec_r = []
        plain = step("cpu", rec_r)
        extra = {
            "cpu": "a witness max-pooling at the card's argmax",
            "vs_plain_cpu_step": step_readings(card[1:], plain[1:]),
            "argmax_flips_vs_plain_cpu": sum(
                int((c["argmax"] != r["argmax"]).sum())
                for c, r in zip(rec_c, rec_r)),
            "pooled_units": sum(r["argmax"].numel() for r in rec_c)}
    ctl = None
    if control is not None:
        ctl = ("the LSTMs through the one-TF32-pass build of csrc/lstm.cu"
               + (", the card's argmax replayed" if argmax else ""),
               step(dev, [], argmax, ctx=control)[1:])
    out = gate_first_step(
        what, card[1:], witness[1:], tol, ctl, names=names,
        floors=float64_floors(torch, build, start, feeding, batch, argmax,
                              witness[2]) if floors else None, **extra)
    out["seconds"] = time.perf_counter() - t0
    return card[0], start, out, launches


def run_train_sentiment(torch, dev, kernels, seed):
    """demo/sentiment's stacked_lstm_net (models/text_dsl: hid 128, three
    lstmemory layers, the middle one reversed) through SGD on the imdb
    loader's batches of 64 ragged reviews: the first step against the
    CPU (graph_first_step, with the one-TF32-pass control), SGD.train over
    SENT_BATCHES batches launching B9's forward and BPTT + dW_r 3 + 3
    times a step (the loss falls), SGD.test, and `python -m
    paddle_tpu_torch train --config paddle_tpu_torch/models/text_dsl.py
    --config_args model=sentiment,...`; then quick_start's lstm config:
    its first step likewise (1 + 1 launches) and QS_STEPS steps."""
    from paddle_tpu_torch.models import text_dsl
    from paddle_tpu_torch.trainer import SGD
    lk = kernels.lstm
    cfg = text_dsl.config("sentiment", n_batches=SENT_BATCHES)
    data, feeding = list(cfg["train_reader"]()), cfg["feeding"]
    card, _, first, first_launches = graph_first_step(
        torch, dev, kernels, lambda: text_dsl.build("sentiment")[0],
        lambda: text_dsl.optimizer("sentiment"), feeding, data[0],
        "train_sentiment", SENT_TOL, control=lambda: tf32_1x("lstm"))
    if first_launches != (3, 3):
        fail(f"train_sentiment: the first step launched the LSTM kernels "
             f"{first_launches} times, want (3, 3)")
    times, losses, pass_launches = sgd_pass(
        torch, kernels, card, data[1:], feeding, "train_sentiment",
        per_step=(3, 3))
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"train_sentiment: the loss must fall: {losses}")
    test_cost = card.test(cfg["test_reader"], feeding=feeding)
    cli = rnn_cli(torch, dev, seed, card, what="train_sentiment",
                  config_file=SENTIMENT_CLI_CONFIG,
                  config_args=f"model=sentiment,batches={SENT_CLI_BATCHES}",
                  batches=SENT_CLI_BATCHES,
                  fresh=lambda: SGD(text_dsl.build()[0],
                                    update_equation=text_dsl.optimizer(),
                                    device=dev))
    launches = {lk.NAME_FWD: first_launches[0] + pass_launches[lk.NAME_FWD],
                lk.NAME_BWD: first_launches[1] + pass_launches[lk.NAME_BWD]}
    ms = float(np.median(times[2:]))
    qs_data = list(text_dsl.config("lstm", n_batches=1 + QS_STEPS)
                   ["train_reader"]())
    qs, _, qs_first, qs_launches = graph_first_step(
        torch, dev, kernels, lambda: text_dsl.build("lstm")[0],
        lambda: text_dsl.optimizer("lstm"), feeding, qs_data[0],
        "train_sentiment quick_start lstm", SENT_TOL)
    if qs_launches != (1, 1):
        fail(f"train_sentiment quick_start lstm: the first step launched the "
             f"LSTM kernels {qs_launches} times, want (1, 1)")
    qs_times, qs_losses, qs_pass = sgd_pass(
        torch, kernels, qs, qs_data[1:], feeding,
        "train_sentiment quick_start lstm", per_step=(1, 1))
    qs_launches = {lk.NAME_FWD: qs_launches[0] + qs_pass[lk.NAME_FWD],
                   lk.NAME_BWD: qs_launches[1] + qs_pass[lk.NAME_BWD]}
    emit({"phase": "train_sentiment", "config": {
        "model": "demo/sentiment stacked_lstm_net (models/text_dsl, layer "
                 "DSL)", "emb": 128, "hid": 128, "lstm_layers": 3,
        "batch": text_dsl.BATCH, "batches": SENT_BATCHES,
        "data": "data.datasets.imdb train (synthetic fallback unless "
                "PADDLE_TPU_DATA_DIR holds aclImdb), 8-119 tokens",
        "optimizer": "Adam lr 0.002 l2 1e-4 clip_norm 5",
        "entry": "trainer.SGD.train"},
        "ms_per_batch": ms, "ms_per_batch_min_max": [min(times[2:]),
                                                     max(times[2:])],
        "samples_per_s": text_dsl.BATCH / (ms / 1e3),
        "launches": launches, "launches_per_step": {lk.NAME_FWD: 3,
                                                    lk.NAME_BWD: 3},
        "losses": losses, "test_cost": test_cost,
        "first_step_vs_cpu": first, "cli": cli,
        "quick_start_lstm": {
            "model": "demo/quick_start lstm_net (models/text_dsl: "
                     "networks.simple_lstm 128, max pool)",
            "optimizer": "Adam lr 0.002", "steps": 1 + len(qs_losses),
            "launches": qs_launches,
            "ms_per_batch": float(np.median(qs_times)),
            "losses": qs_losses, "first_step_vs_cpu": qs_first}})
    F32_MS["train_sentiment"] = ms
    return {"train_sentiment": launches,
            "train_quick_start_lstm": qs_launches}


# trainer_a9c: the rest of the trainer (A9·c) on the card, at the text
# demos' published widths.  The sentiment demo (hid 128, emb 128, batch
# 64) through SGD(evaluators=[classification error, auc],
# grad_accum_steps=2): A9C_PASSES passes of A9C_BATCHES micro-batches,
# B9 3 + 3 launches a micro-batch; the first micro-batch leaves the
# parameters bit for bit, and the first applied update (micro-batch 2)
# is held against a CPU witness that replays the card's max-pool argmax:
# the applied mean gradient within SENT_TOL of each leaf's largest entry
# (the one-TF32-pass LSTM build must fail it), and the updated
# parameters within SENT_TOL of the demo's Adam applied on the host to
# the card's mean gradient (a9c_first_update).  A real SIGTERM after
# A9C_PRE_AT (pass, batch), resumed in a fresh SGD; quick_start's
# lstm_net with a 0.5 pruning hook on both weights for PRUNE_STEPS
# steps (1 + 1);
# Inferencer on the card against the CPU's at INFER_TOL; the CLI jobs as
# subprocesses.
A9C_BATCHES, A9C_PASSES = 8, 2
A9C_PRE_AT = (1, 3)
PRUNE_STEPS = 10
# largest |card - CPU| of the demo's softmax outputs on one batch of 64:
# float32 and int8 (dequantized float32 weights) as the first step's
# kernels allow; bf16 a few bf16 steps (2^-8) of a probability, the
# LSTM's outputs stored in bf16 on both devices
INFER_TOL = {"float32": 1e-4, "bfloat16": 3e-2, "int8": 1e-4}
CLI_TIME_BATCHES = 12


def a9c_first_update(torch, dev, data, start):
    """grad_accum_steps=2 on the sentiment demo, micro-batches by hand
    (``_forward`` / ``_backward`` / ``_update``) on the card, on a CPU
    witness replaying the card's argmax, and on the card through the
    one-TF32-pass LSTM build (the control).  Gates: the first
    micro-batch holds the parameters bit for bit; the applied mean
    gradient against the witness's within SENT_TOL (the control must
    fail it); the updated parameters against the demo's Adam applied on
    the host to the card's own mean gradient, within SENT_TOL.  Against
    the witness's parameters Adam's first step, lr * g / (|g| + eps),
    turns the rounding of entries with |g| near eps into up to lr: that
    reading is reported beside."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import text_dsl
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves
    first = tree_leaves(start)

    def run(device, record, argmax=None, ctx=None):
        tr = SGD(cost=text_dsl.build("sentiment")[0], parameters=start,
                 update_equation=text_dsl.optimizer("sentiment"),
                 grad_accum_steps=2, device=device)
        feeder = DataFeeder(text_dsl.feeding(), device=tr.device)
        with (ctx or contextlib.nullcontext)(), pool_probe(torch, record,
                                                           argmax):
            for i, batch in enumerate(data[:2]):
                total, _ = tr._forward(feeder(batch))
                tr._backward(total)
                if i:
                    mean = [((s + p.grad) / 2).detach().cpu() for s, p in
                            zip(tree_leaves(tr.opt_state["gsum"]),
                                tr._leaves)]
                tr._update()
                if not i:
                    held = all(torch.equal(p.detach().cpu(), w)
                               for p, w in zip(tr._leaves, first))
        return [p.detach().cpu() for p in tr._leaves], mean, held

    t0 = time.perf_counter()
    rec = []
    card = run(dev, rec)
    argmax = [r["argmax"] for r in rec]
    witness = run("cpu", [], argmax)
    control = run(dev, [], argmax, ctx=lambda: tf32_1x("lstm"))
    applied = [w.clone() for w in first]
    opt = text_dsl.optimizer("sentiment")
    opt.update(card[1], opt.init(applied), applied)
    out = {"mean_grad_vs_witness": max(largest_err(card[1], witness[1])),
           "params_vs_host_adam_on_card_grad": max(largest_err(card[0],
                                                               applied)),
           "params_vs_witness": max(largest_err(card[0], witness[0])),
           "control": {"what": "the LSTMs through the one-TF32-pass build "
                               "of csrc/lstm.cu, the card's argmax replayed",
                       "mean_grad_vs_witness":
                       max(largest_err(control[1], witness[1])),
                       "params_vs_witness":
                       max(largest_err(control[0], witness[0]))},
           "params_held_on_micro_batch_1": card[2], "tolerance": SENT_TOL,
           "seconds": time.perf_counter() - t0}
    if not card[2]:
        fail(f"trainer_a9c: the first micro-batch moved the parameters: "
             f"{out}")
    if max(out["mean_grad_vs_witness"],
           out["params_vs_host_adam_on_card_grad"]) > SENT_TOL \
            or out["control"]["mean_grad_vs_witness"] <= SENT_TOL:
        fail(f"trainer_a9c: the first applied update must pass {SENT_TOL} "
             f"against the CPU and its TF32 control fail it: {out}")
    return out


def a9c_host_recount(torch, specs, states, outs, data):
    """Each pass's classification error and AUC recounted on the host
    (the port's evaluators on CPU copies of the card's outputs and the
    batches' labels): equal to the card's state, exactly."""
    from paddle_tpu_torch import evaluators as E
    labels = [torch.tensor([s[1] for s in batch]) for batch in data]
    got = []
    for p, (pass_states, pass_outs) in enumerate(zip(states, outs)):
        ce, auc = pass_states
        ev = E.Auc()
        st = ev.init()
        for o, lab in zip(pass_outs, labels):
            st = ev.update(st, pred=o, label=lab)
        host = {"wrong": float(sum(int((o.argmax(-1) != lab).sum())
                                   for o, lab in zip(pass_outs, labels))),
                "total": float(sum(len(b) for b in data)),
                "auc": ev.result(st)}
        card = {"wrong": float(ce["wrong"]), "total": float(ce["total"]),
                "auc": specs[1].impl.result(auc)}
        if card != host:
            fail(f"trainer_a9c: pass {p}'s evaluators on the card {card} "
                 f"against the host recount {host}")
        got.append({**card,
                    "classification_error": specs[0].impl.result(ce)})
    return got


def run_trainer_a9c(torch, dev, kernels, seed):
    """The rest of the trainer on the card (A9·c; see A9C_BATCHES):
    evaluators with gradient accumulation and background pass-end saves,
    preemption by a real SIGTERM and its resume, pruning, Inferencer,
    and the CLI's time / checkgrad / merge_model / version jobs."""
    import io
    import os
    import signal
    import subprocess
    import tempfile
    from paddle_tpu_torch import evaluators as E
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import text_dsl
    from paddle_tpu_torch.trainer import (SGD, Inferencer, cli, events,
                                          load_checkpoint, load_merged)
    from paddle_tpu_torch.version import __version__
    from paddle_tpu_torch.utils.tree import tree_leaves
    lk = kernels.lstm
    root = os.path.dirname(os.path.abspath(__file__))
    feeding = text_dsl.feeding()
    data = list(text_dsl.config("sentiment", n_batches=A9C_BATCHES)
                ["train_reader"]())
    start = host_tree(SGD(cost=text_dsl.build("sentiment")[0],
                          update_equation=text_dsl.optimizer(),
                          seed=seed, device="cpu").parameters)
    first = a9c_first_update(torch, dev, data, start)

    def lstm_launches():
        return {lk.NAME_FWD: lk.launches_fwd, lk.NAME_BWD: lk.launches_bwd}

    def leaves_host(tr):
        return [p.detach().cpu().clone() for p in tree_leaves(tr.parameters)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # evaluators, accumulation and the background writer
    cost, out = text_dsl.build("sentiment")
    label = L.Topology(cost).data_layers["label"]
    tr = SGD(cost, parameters=start, update_equation=text_dsl.optimizer(),
             evaluators=[E.classification_error_evaluator(out, label),
                         E.auc_evaluator(out, label)],
             grad_accum_steps=2, device=dev)
    rec = {"ms": [], "launches": [], "outs": [], "pass_s": [], "snap": [],
           "states": []}

    def handler(e):
        if isinstance(e, events.BeginPass):
            torch.cuda.synchronize()
            rec["outs"].append([])
            rec["t_pass"] = time.perf_counter()
        elif isinstance(e, events.BeginIteration):
            torch.cuda.synchronize()
            kernels.reset_launches()
            rec["t0"] = time.perf_counter()
        elif isinstance(e, events.EndIteration):
            float(e.cost)                           # a synchronize
            rec["ms"].append((time.perf_counter() - rec["t0"]) * 1e3)
            lstm = (lk.launches_fwd, lk.launches_bwd)
            rec["launches"].append(lstm + (
                sum(launch_counts(kernels).values())
                + recurrent_launches(kernels) - sum(lstm),))
            rec["outs"][-1].append(e.evaluator_results["extra_0"].cpu())
        elif isinstance(e, events.EndPass):
            torch.cuda.synchronize()
            rec["pass_s"].append(time.perf_counter() - rec["t_pass"])
            rec["snap"].append(leaves_host(tr))
            rec["states"].append([{k: v.clone() for k, v in s.state.items()}
                                  for s in tr.evaluators])

    with tempfile.TemporaryDirectory() as tmp:
        save = os.path.join(tmp, "sentiment")
        tr.train(lambda: iter(data), num_passes=A9C_PASSES,
                 event_handler=handler, feeding=feeding, save_dir=save,
                 log_period=A9C_BATCHES // 2)
        if any(n != (3, 3, 0) for n in rec["launches"]):
            fail(f"trainer_a9c: per-micro-batch (lstm forward, lstm "
                 f"backward, other) launches {rec['launches']}, want (3, 3, "
                 "0) every micro-batch")
        if tr.opt_state["inner"]["step"] != A9C_PASSES * A9C_BATCHES // 2:
            fail(f"trainer_a9c: {tr.opt_state['inner']['step']} optimizer "
                 "steps after the passes")
        recount = a9c_host_recount(torch, tr.evaluators, rec["states"],
                                   rec["outs"], data)
        # every pass dir, written in the background, reloads equal to the
        # parameters at that pass end
        for p, snap in enumerate(rec["snap"]):
            params, _, _, meta = load_checkpoint(save, p)
            host = [torch.tensor(np.asarray(a))
                    for a in (params[k][n] for k in sorted(params)
                              for n in sorted(params[k]))]
            if not same(host, snap) or meta["grad_accum_steps"] != 2:
                fail(f"trainer_a9c: pass dir {p} (background writer) does "
                     "not reload equal to its pass end's parameters")
        # one more pass with the pass-end save forced to block
        async_save = tr.save
        tr.save = lambda *a, **kw: async_save(*a, **{**kw, "block": True})
        rec["outs"], async_pass_s = [], rec["pass_s"][-1]
        tr.train(lambda: iter(data), num_passes=1, event_handler=handler,
                 feeding=feeding, save_dir=os.path.join(tmp, "blocking"),
                 log_period=0)
        del tr.save
        if any(n != (3, 3, 0) for n in rec["launches"]):
            fail(f"trainer_a9c: the blocking pass's launches "
                 f"{rec['launches']}")
        accum_launches = {lk.NAME_FWD: sum(n[0] for n in rec["launches"]),
                          lk.NAME_BWD: sum(n[1] for n in rec["launches"])}
        ms = float(np.median(rec["ms"][2:A9C_PASSES * A9C_BATCHES]))
        writer = {"pass_s_block_false": async_pass_s,
                  "pass_s_block_true": rec["pass_s"][-1],
                  "pass_dirs_reload_equal": True}

        # the CLI jobs as subprocesses on the card
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))

        def job(*argv):
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "paddle_tpu_torch", *argv,
                 "--device", dev.type], cwd=root, env=env,
                capture_output=True, text=True, timeout=600)
            return run, time.perf_counter() - t0

        lstm_cfg = ("--config", os.path.join(root, SENTIMENT_CLI_CONFIG))
        run, t_s = job("time", *lstm_cfg, "--config_args",
                       f"model=lstm,batches={CLI_TIME_BATCHES}")
        line = run.stdout.strip().splitlines()[-1] if run.stdout else ""
        if run.returncode or not line.startswith(
                f"time: {CLI_TIME_BATCHES - 2} batches"):
            fail(f"trainer_a9c: the time job exited {run.returncode}: "
                 f"{run.stdout[-2000:]} {run.stderr[-2000:]}")
        cli_out = {"time": {"line": line, "seconds": t_s}}
        run, t_s = job("checkgrad", *lstm_cfg, "--config_args",
                       "model=lstm,batches=1")
        if run.returncode or not run.stdout.endswith("checkgrad PASSED\n"):
            fail(f"trainer_a9c: checkgrad exited {run.returncode}: "
                 f"{run.stdout[-3000:]} {run.stderr[-2000:]}")
        cli_out["checkgrad"] = {"lines": run.stdout.strip().splitlines(),
                                "seconds": t_s}
        # the same job in this process: B9 on its path, float32
        kernels.reset_launches()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main(["checkgrad", *lstm_cfg, "--config_args",
                           "model=lstm,batches=1", "--device", dev.type])
        checkgrad_launches = lstm_launches()
        if rc or not all(checkgrad_launches.values()):
            fail(f"trainer_a9c: checkgrad in process exited {rc}, LSTM "
                 f"launches {checkgrad_launches}: {text.getvalue()}")
        merged = os.path.join(tmp, "merged.npz")
        run, t_s = job("merge_model", "--model_dir", save, "--out", merged)
        params, _, meta = load_merged(merged) if not run.returncode \
            else (None, None, None)
        if run.returncode or not same(
                [torch.tensor(np.asarray(params[k][n]))
                 for k in sorted(params) for n in sorted(params[k])],
                rec["snap"][A9C_PASSES - 1]):
            fail(f"trainer_a9c: merge_model then load_merged does not give "
                 f"back the trained parameters: {run.stderr[-2000:]}")
        cli_out["merge_model"] = {"meta_pass_id": meta["pass_id"],
                                  "seconds": t_s, "bit_for_bit": True}
        run, t_s = job("version")
        want = [f"paddle_tpu_torch {__version__} (torch {torch.__version__})",
                f"devices: {torch.cuda.get_device_name(0)}"]
        if run.returncode or run.stdout.strip().splitlines() != want:
            fail(f"trainer_a9c: version printed {run.stdout!r}, want {want}")
        cli_out["version"] = {"lines": want, "seconds": t_s}

    # preemption by a real signal
    def sentiment_sgd():
        return SGD(text_dsl.build("sentiment")[0], parameters=start,
                   update_equation=text_dsl.optimizer(), device=dev)

    def train(t, **kw):
        kernels.reset_launches()
        t.train(lambda: iter(data), num_passes=A9C_PASSES, feeding=feeding,
                log_period=0, **kw)
        return lstm_launches()

    def dist(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    # three uninterrupted runs: their largest pairwise distance is the
    # card's own spread (0 where every op is deterministic)
    pre_launches = []
    whole = []
    for _ in range(3):
        t = sentiment_sgd()
        pre_launches.append(train(t))
        whole.append(leaves_host(t))
    spread = max(dist(a, b) for i, a in enumerate(whole)
                 for b in whole[i + 1:])
    prev = signal.getsignal(signal.SIGTERM)

    def sigterm(e):
        if isinstance(e, events.EndIteration) \
                and (e.pass_id, e.batch_id) == A9C_PRE_AT:
            os.kill(os.getpid(), signal.SIGTERM)

    with tempfile.TemporaryDirectory() as tmp:
        cut = sentiment_sgd()
        pre_launches.append(train(cut, save_dir=tmp, event_handler=sigterm))
        with open(os.path.join(tmp, f"pass-{A9C_PRE_AT[0]:05d}",
                               "meta.json")) as f:
            meta = json.load(f)
        want = {"preempted": True, "signal": int(signal.SIGTERM),
                "batches_done": A9C_PRE_AT[1] + 1}
        if {k: meta.get(k) for k in want} != want \
                or signal.getsignal(signal.SIGTERM) != prev:
            fail(f"trainer_a9c: the preemption checkpoint's meta {meta} "
                 f"(want {want}), or the SIGTERM handler was not put back")
        resumed = sentiment_sgd()
        began = []
        pre_launches.append(train(
            resumed, save_dir=tmp, resume=True,
            event_handler=lambda e: began.append((e.pass_id, e.batch_id))
            if isinstance(e, events.BeginIteration) else None))
    # the resume against the nearest uninterrupted run: bit for bit, or
    # within the runs' own spread
    resume_err = min(dist(leaves_host(resumed), w) for w in whole)
    if began[:1] != [(A9C_PRE_AT[0], A9C_PRE_AT[1] + 1)] \
            or resume_err > spread:
        fail(f"trainer_a9c: the resume began at {began[:1]} and ends "
             f"{resume_err} from the nearest uninterrupted run (their "
             f"spread: {spread})")
    preemption = {"meta": meta, "resumed_at": began[0],
                  "uninterrupted_spread": spread,
                  "resume_max_abs_diff": resume_err,
                  "bit_for_bit": resume_err == 0.0 and spread == 0.0,
                  "launches_per_run": pre_launches}
    if spread:
        # the leaves two first steps on the card already disagree on
        grads = []
        for _ in range(2):
            t = sentiment_sgd()
            total, _ = t._forward(DataFeeder(feeding, device=dev)(data[0]))
            t._backward(total)
            grads.append([p.grad.detach().cpu() for p in t._leaves])
        names = [f"{k}/{n}" for k in sorted(start) for n in sorted(start[k])]
        preemption["first_step_grads_differing"] = [
            name for name, a, b in zip(names, *grads)
            if not torch.equal(a, b)]

    # inference on the card against the CPU, on the start's weights (the
    # trained ones saturate the demo's softmax on these batches)
    inference = {}
    infer_launches = {lk.NAME_FWD: 0, lk.NAME_BWD: 0}
    for mode, kw in (("float32", {}),
                     ("bfloat16", {"compute_dtype": torch.bfloat16}),
                     ("int8", {"quantize": "int8"})):
        outl = text_dsl.build("sentiment")[1]
        inf = Inferencer(outl, start, device=dev, **kw)
        kernels.reset_launches()
        card = inf.infer(data[0], feeding=feeding)
        for k, n in lstm_launches().items():
            infer_launches[k] += n
        ref_inf = Inferencer(outl, start, device="cpu", **kw)
        ref = ref_inf.infer(data[0], feeding=feeding)
        err = float((card.cpu() - ref).abs().max())
        inference[mode] = {"max_abs_err": err, "tolerance": INFER_TOL[mode],
                           "dtype": str(card.dtype)}
        if mode == "int8":
            codes = all(torch.equal(a.cpu(), b) for a, b in zip(
                tree_leaves(inf._exec_params),
                tree_leaves(ref_inf._exec_params)))
            inference[mode]["codes_scales_bit_for_bit"] = codes
            if not codes:
                fail("trainer_a9c: the int8 codes or scales differ between "
                     "the card and the CPU")
        if err > INFER_TOL[mode] or card.dtype != torch.float32:
            fail(f"trainer_a9c: Inferencer {mode} on the card against the "
                 f"CPU: {inference[mode]}")

    # pruning: quick_start's lstm_net, both weights hooked
    L.reset_names()
    words = L.data_layer("words", size=text_dsl.DICT_DIM, is_seq=True)
    qlabel = L.data_layer("label", size=1)

    def hook():
        return {"update_hooks": {"type": "pruning", "sparsity_ratio": 0.5}}
    lstm = L.networks.simple_lstm(L.embedding_layer(words, size=128),
                                  size=128, mat_param_attr=hook(),
                                  inner_param_attr=hook())
    qcost = L.classification_cost(L.fc_layer(L.pooling_layer(
        lstm, pooling_type=L.pooling.Max), size=2, act="softmax"), qlabel)
    pruned = SGD(qcost, update_equation=text_dsl.optimizer("lstm"),
                 seed=seed, device=dev)
    qs_data = list(text_dsl.config("lstm", n_batches=PRUNE_STEPS)
                   ["train_reader"]())
    qs_times, qs_losses, prune_launches = sgd_pass(
        torch, kernels, pruned, qs_data, feeding, "trainer_a9c pruning",
        per_step=(1, 1))
    prune = {}
    for key, mask in pruned._prune_masks.items():
        for name, m in mask.items():
            if bool((m == 1).all()):
                continue
            w = pruned.parameters[key][name].detach()
            nonzero = int(torch.count_nonzero(w[m == 0]))
            prune[f"{key}/{name}"] = {"shape": list(w.shape),
                                      "pruned": int((m == 0).sum()),
                                      "pruned_nonzero": nonzero}
            if nonzero:
                fail(f"trainer_a9c: {nonzero} pruned entries of {key}/{name} "
                     f"are not 0.0 after {PRUNE_STEPS} steps")
    if len(prune) != 2:
        fail(f"trainer_a9c: pruning masks on {sorted(prune)}, want the "
             "input projection and the LSTM's W_r")

    launches = {
        "trainer_a9c_accum": accum_launches,
        "trainer_a9c_preemption": {k: sum(n[k] for n in pre_launches)
                                   for k in (lk.NAME_FWD, lk.NAME_BWD)},
        "trainer_a9c_pruning": prune_launches,
        "trainer_a9c_inference": infer_launches,
        "trainer_a9c_checkgrad": checkgrad_launches}
    emit({"phase": "trainer_a9c", "config": {
        "sentiment": "demo/sentiment stacked_lstm_net (models/text_dsl: hid "
                     "128, emb 128), Adam lr 0.002 l2 1e-4 clip_norm 5, "
                     f"batch {text_dsl.BATCH}",
        "evaluators": ["classification_error_evaluator", "auc_evaluator"],
        "grad_accum_steps": 2, "passes": A9C_PASSES,
        "micro_batches_a_pass": A9C_BATCHES,
        "pruning": "demo/quick_start lstm_net rebuilt with networks."
                   "simple_lstm(mat_param_attr=, inner_param_attr=) "
                   "{'type': 'pruning', 'sparsity_ratio': 0.5}, Adam lr 0.002",
        "preempt_at": list(A9C_PRE_AT)},
        "first_applied_update_vs_cpu": first,
        "ms_per_batch": ms,
        "ms_per_batch_train_sentiment": F32_MS.get("train_sentiment"),
        "evaluators": recount, "background_writer": writer,
        "preemption": preemption, "inference": inference,
        "pruning": {"steps": PRUNE_STEPS, "weights": prune,
                    "ms_per_batch": float(np.median(qs_times[2:])),
                    "losses": qs_losses},
        "cli": cli_out, "launches": launches,
        "launches_per_micro_batch": {lk.NAME_FWD: 3, lk.NAME_BWD: 3},
        "launches_per_pruned_step": {lk.NAME_FWD: 1, lk.NAME_BWD: 1}})
    return launches


# The tagging demos (A10·b): models/tagging_dsl through SGD on the
# conll05 loader.  train_srl: the SRL db-LSTM + CRF at emb 32, hid 128,
# depth 8 (the reference's) and batch 16: every lstmemory passes JAX's
# resident rule, so each step launches B9's forward and its BPTT + dW_r
# once per LSTM (8 + 8, four of them reversed over the ragged
# sentences).  Its first step's loss and every gradient leaf against a
# CPU run on the same weights and batch at SRL_TOL, which the same step
# through the one-TF32-pass LSTM build must fail; the decoded paths held
# by score: the card's path, scored under the CPU's emissions and CRF
# weight, within DECODE_SCORE_TOL of the CPU's best score (the count of
# equal tags reported); then SRL_BATCHES steps (SGD.test's cost falls
# from the start weights') and a CLI pass.  train_tagging (sequence_tagging's linear CRF,
# batch 32), train_quick_start_cnn (quick_start's cnn, batch 64: its
# witness max-pools at the card's argmax, graph_first_step) and
# fit_a_line (the introduction, batch 64): the first step against the
# CPU at TAG_TOL, then a pass; the line's 8 passes end within LINE_TOL of
# w 2, b 0.3.  ctc: a ctc_layer graph (fc softmax over 128-wide
# sequences of 20-50 steps, 32 classes, labels of 5-15) at batch 16, its
# loss and every gradient leaf against the CPU at TAG_TOL.
# SRL_TOL lies between the readings on an H100 (PERF.md §6):
# the sound step 3.2e-6 of its largest gradient entry, the
# one-TF32-pass LSTM control 2.9e-4
SRL_TOL = 2e-5
TAG_TOL = 1e-5
DECODE_SCORE_TOL = 1e-5
LINE_TOL = 0.05
# SRL_BATCHES is the train split's whole pass: on its synthetic labels
# the SRL test cost first rises under the demo's Adam and falls below
# the start weights' only after a few dozen steps
SRL_BATCHES, SRL_CLI_BATCHES, TAG_BATCHES, CNN_BATCHES = 64, 2, 16, 8
LINE_PASSES = 8
TAGGING_CLI_CONFIG = "paddle_tpu_torch/models/tagging_dsl.py"
CTC_B, CTC_T, CTC_D, CTC_C = 16, 50, 128, 32


def decode_by_score(torch, dev, build, start, batch, feeding, what):
    """The CRF decoding output of ``build()`` (cost, decoded) on the
    card and on the CPU from ``start``: the card's path, scored under
    the CPU's emissions and CRF weight in float64, within
    DECODE_SCORE_TOL of the CPU's best score."""
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.ops import crf as crf_ops
    from paddle_tpu_torch.utils.tree import tree_map

    def run(device):
        cost, decoded = build()
        topo = L.Topology([decoded, cost.inputs[0]])
        params = tree_map(lambda t: t.to(device), start)
        feed = DataFeeder(feeding, device=device)(batch)
        with torch.no_grad():
            tags, em = topo.apply(params, feed, mode="test")
        return tags.data[..., 0].cpu(), em.data.cpu(), feed["words"].lengths
    card_tags, _, _ = run(dev)
    tags, em, lengths = run("cpu")
    w = start["crf"]["w"].double()
    em, lengths = em.double(), lengths.cpu()
    best = crf_ops.crf_path_score(em, tags, lengths, w)
    got = crf_ops.crf_path_score(em, card_tags, lengths, w)
    err = float(((got - best).abs() / best.abs()).max())
    mask = torch.arange(tags.shape[1])[None, :] < lengths[:, None]
    out = {"score_rel_err_max": err, "tolerance": DECODE_SCORE_TOL,
           "tags_equal": int((card_tags == tags)[mask].sum()),
           "tags": int(mask.sum())}
    if not err <= DECODE_SCORE_TOL:
        fail(f"{what}: the card's decoded path does not reach the CPU's "
             f"best score: {out}")
    return out


def test_cost_falls(cfg, card, start, what):
    """SGD.test over the config's test reader at the start weights and
    at the card trainer's: the cost must fall (a CRF cost sums over a
    sentence's tokens, so the train batches' losses move with their
    lengths).  Returns the two costs."""
    from paddle_tpu_torch.trainer import SGD
    before = SGD(cost=cfg["cost"], parameters=start,
                 update_equation=cfg["optimizer"],
                 device=card.device).test(cfg["test_reader"],
                                          feeding=cfg["feeding"])
    after = card.test(cfg["test_reader"], feeding=cfg["feeding"])
    if not after < before:
        fail(f"{what}: the test cost must fall over the pass: {before} at "
             f"the start, {after} after")
    return {"start": before, "after_pass": after}


def run_train_srl(torch, dev, kernels, seed):
    """The SRL demo's db-LSTM + CRF (models/tagging_dsl.db_lstm_net at
    emb 32, hid 128, depth 8) through SGD on the conll05 loader's batches
    of 16: the first step against the CPU (its one-TF32-pass control
    failing), B9 8 + 8 a step, the decoded paths by score, SRL_BATCHES
    steps, SGD.test's cost falling, the CLI on tagging_dsl.py
    (model=srl)."""
    from paddle_tpu_torch.models import tagging_dsl
    from paddle_tpu_torch.trainer import SGD
    lk = kernels.lstm
    cfg = tagging_dsl.config("srl", n_batches=SRL_BATCHES)
    data, feeding = list(cfg["train_reader"]()), cfg["feeding"]
    card, start, first, first_launches = graph_first_step(
        torch, dev, kernels, lambda: tagging_dsl.build("srl")[0],
        lambda: tagging_dsl.optimizer("srl"), feeding, data[0], "train_srl",
        SRL_TOL, control=lambda: tf32_1x("lstm"))
    if first_launches != (8, 8):
        fail(f"train_srl: the first step launched the LSTM kernels "
             f"{first_launches} times, want (8, 8)")
    decode = decode_by_score(torch, dev, lambda: tagging_dsl.build("srl"),
                             start, data[0], feeding, "train_srl")
    times, losses, pass_launches = sgd_pass(
        torch, kernels, card, data[1:], feeding, "train_srl", per_step=(8, 8))
    test_cost = test_cost_falls(cfg, card, start, "train_srl")
    cli = rnn_cli(torch, dev, seed, card, what="train_srl",
                  config_file=TAGGING_CLI_CONFIG,
                  config_args=f"model=srl,batches={SRL_CLI_BATCHES}",
                  batches=SRL_CLI_BATCHES,
                  fresh=lambda: SGD(tagging_dsl.build("srl")[0],
                                    update_equation=tagging_dsl.optimizer(
                                        "srl"), device=dev))
    launches = {lk.NAME_FWD: first_launches[0] + pass_launches[lk.NAME_FWD],
                lk.NAME_BWD: first_launches[1] + pass_launches[lk.NAME_BWD]}
    ms = float(np.median(times[2:]))
    batch = tagging_dsl.BATCH["srl"]
    emit({"phase": "train_srl", "config": {
        "model": "demo/semantic_role_labeling db_lstm (models/tagging_dsl."
                 "db_lstm_net, layer DSL: mixed_layer, lstmemory, crf_layer)",
        "emb": 32, "hid": 128, "depth": 8, "mixed_width": 512,
        "batch": batch, "batches": SRL_BATCHES,
        "data": "data.datasets.conll05 train (synthetic fallback unless "
                "PADDLE_TPU_DATA_DIR holds conll05), 5-39 tokens",
        "optimizer": "Adam lr 1e-3 clip_threshold 5",
        "entry": "trainer.SGD.train"},
        "ms_per_batch": ms, "ms_per_batch_min_max": [min(times[2:]),
                                                     max(times[2:])],
        "samples_per_s": batch / (ms / 1e3),
        "launches": launches, "launches_per_step": {lk.NAME_FWD: 8,
                                                    lk.NAME_BWD: 8},
        "losses": losses, "test_cost": test_cost,
        "first_step_vs_cpu": first, "decoded_vs_cpu": decode, "cli": cli})
    F32_MS["train_srl"] = ms
    return {"train_srl": launches}


def run_train_crf_demos(torch, dev, kernels):
    """train_tagging, train_quick_start_cnn, fit_a_line and ctc: each
    first step (or the CTC graph's loss and gradients) against the CPU,
    then a pass; no counted kernel launches."""
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.data.provider import (dense_vector_sequence,
                                                integer_value_sequence)
    from paddle_tpu_torch.models import tagging_dsl, text_dsl
    from paddle_tpu_torch.optim import Momentum
    out = {}
    # sequence_tagging's linear CRF
    cfg = tagging_dsl.config("tagging", n_batches=TAG_BATCHES)
    data, feeding = list(cfg["train_reader"]()), cfg["feeding"]
    card, start, first, _ = graph_first_step(
        torch, dev, kernels, lambda: tagging_dsl.build("tagging")[0],
        lambda: tagging_dsl.optimizer("tagging"), feeding, data[0],
        "train_tagging", TAG_TOL)
    decode = decode_by_score(torch, dev, lambda: tagging_dsl.build("tagging"),
                             start, data[0], feeding, "train_tagging")
    times, losses, _ = sgd_pass(torch, kernels, card, data[1:], feeding,
                                "train_tagging")
    test_cost = test_cost_falls(cfg, card, start, "train_tagging")
    ms = float(np.median(times[2:]))
    out["train_tagging"] = {
        "config": {"model": "demo/sequence_tagging linear_crf (models/"
                            "tagging_dsl.linear_crf_net: context window 3 in "
                            "a 192-wide mixed layer, concat the predicate "
                            "embedding, fc 128 tanh, crf_layer)",
                   "batch": tagging_dsl.BATCH["tagging"],
                   "batches": TAG_BATCHES,
                   "optimizer": "Momentum lr 0.01 m 0.9 l2 1e-4"},
        "ms_per_batch": ms,
        "samples_per_s": tagging_dsl.BATCH["tagging"] / (ms / 1e3),
        "losses": losses, "test_cost": test_cost,
        "first_step_vs_cpu": first, "decoded_vs_cpu": decode}
    # quick_start's cnn
    qs = text_dsl.config("cnn", n_batches=CNN_BATCHES)
    qs_data = list(qs["train_reader"]())
    card, _, qs_first, qs_launches = graph_first_step(
        torch, dev, kernels, lambda: text_dsl.build("cnn")[0],
        lambda: text_dsl.optimizer("cnn"), qs["feeding"], qs_data[0],
        "train_quick_start_cnn", SENT_TOL)
    if qs_launches != (0, 0):
        fail(f"train_quick_start_cnn: the first step launched the LSTM "
             f"kernels {qs_launches} times")
    times, losses, _ = sgd_pass(torch, kernels, card, qs_data[1:],
                                qs["feeding"], "train_quick_start_cnn")
    ms = float(np.median(times[2:]))
    out["train_quick_start_cnn"] = {
        "config": {"model": "demo/quick_start cnn_net (models/text_dsl: "
                            "networks.sequence_conv_pool, window 3 in a "
                            "384-wide mixed layer, fc 256 relu, max pool)",
                   "batch": text_dsl.BATCH, "batches": CNN_BATCHES,
                   "optimizer": "Adam lr 0.002"},
        "ms_per_batch": ms, "samples_per_s": text_dsl.BATCH / (ms / 1e3),
        "losses": losses, "first_step_vs_cpu": qs_first}
    # the introduction's line
    line = tagging_dsl.config("fit_a_line")
    data = list(line["train_reader"]())
    card, _, first, _ = graph_first_step(
        torch, dev, kernels, lambda: tagging_dsl.build("fit_a_line")[0],
        lambda: tagging_dsl.optimizer("fit_a_line"), line["feeding"],
        data[0], "fit_a_line", TAG_TOL)
    times, losses, _ = sgd_pass(torch, kernels, card,
                                data[1:] + data * (LINE_PASSES - 1),
                                line["feeding"], "fit_a_line")
    w = float(card.parameters["fc"]["w0"].detach().reshape(-1)[0])
    b = float(card.parameters["fc"]["b"].detach().reshape(-1)[0])
    if abs(w - 2.0) > LINE_TOL or abs(b - 0.3) > LINE_TOL:
        fail(f"fit_a_line: the line after {LINE_PASSES} passes is w {w}, "
             f"b {b}; want 2, 0.3 within {LINE_TOL}")
    out["fit_a_line"] = {
        "config": {"model": "demo/introduction fit_a_line (models/"
                            "tagging_dsl: fc 1, regression_cost)",
                   "batch": tagging_dsl.BATCH["fit_a_line"],
                   "passes": LINE_PASSES,
                   "optimizer": "Momentum lr 0.1 m 0.9"},
        "ms_per_batch": float(np.median(times[2:])), "w": w, "b": b,
        "loss_first_last": [losses[0], losses[-1]],
        "first_step_vs_cpu": first}
    # a ctc_layer graph
    rng = np.random.RandomState(7)
    lengths = rng.randint(20, CTC_T + 1, CTC_B)
    label_lengths = rng.randint(5, 16, CTC_B)
    batch = [(rng.randn(n, CTC_D).astype(np.float32).tolist(),
              rng.randint(0, CTC_C - 1, m).tolist())
             for n, m in zip(lengths, label_lengths)]

    def ctc_graph():
        L.reset_names()
        xs = L.data_layer("xs", size=CTC_D, is_seq=True)
        lab = L.data_layer("lab", size=CTC_C, is_seq=True)
        probs = L.fc_layer(xs, size=CTC_C, act="softmax")
        return L.ctc_layer(probs, lab, size=CTC_C)
    _, _, first, _ = graph_first_step(
        torch, dev, kernels, ctc_graph, lambda: Momentum(learning_rate=0.01,
                                                momentum=0.9),
        {"xs": dense_vector_sequence(CTC_D),
         "lab": integer_value_sequence(CTC_C)}, batch, "ctc", TAG_TOL)
    out["ctc"] = {"config": {"graph": "fc softmax over the sequence -> "
                             "ctc_layer (blank = size - 1)", "batch": CTC_B,
                             "steps": [20, CTC_T], "dim": CTC_D,
                             "classes": CTC_C, "label_lengths": [5, 15]},
                  "loss_and_grads_vs_cpu": first}
    launches = {**launch_counts(kernels),
                "recurrent": recurrent_launches(kernels)}
    if any(launches.values()):
        fail(f"train_crf_demos: counted kernels launched {launches}")
    emit({"phase": "train_crf_demos", **out})


# ------------------------------------------------------------- A10·b

# layers_a10b: the elementwise, sequence and layer_math layers of
# tests/test_torch_{elementwise,sequence_layers}.py, with nce_layer and
# hsigmoid over A10B_V classes and sampling_id_layer, in one graph at
# batch A10B_B and width A10B_D (ragged sequences of up to A10B_T steps,
# length 1 included): every output, and the gradients of the float
# outputs summed against seeded cotangents with respect to every
# parameter and float input, on the card against the CPU on the same
# inputs and weights, each within A10B_TOL of the CPU's largest entry
# (ids and lengths equal).  nce_layer's negatives and sampling_id_layer's
# ids are drawn on the card (Context.uniform) and replayed on the CPU
# (draw_probe).  No counted kernel is on this path: the ops are PyTorch
# calls, as they are XLA's in JAX.
A10B_B, A10B_D, A10B_T, A10B_V = 64, 256, 24, 2073
A10B_TOL = 1e-5


def a10b_feed(rng):
    """The graph's numpy feed: {name: (array or (data, lengths), data
    layer size)}."""
    b, d, t, f = A10B_B, A10B_D, A10B_T, np.float32
    lengths = rng.randint(1, t + 1, b).astype(np.int32)
    lengths[:2] = (1, t)
    ties = rng.randn(b, d).astype(f)
    ties[:, 7] = ties[:, 3] = ties.max(axis=1) + 1.0    # first max at 3
    off = (rng.randint(0, t, b) % lengths).astype(np.int32)
    size = (rng.randint(0, t, b) % (lengths - off + 1)).astype(np.int32)

    def normal(*shape):
        return rng.randn(*shape).astype(f)

    return {
        "x": (normal(b, d), d), "y": (normal(b, d), d),
        "z": (normal(b, d), d),
        "pos": (rng.uniform(0.5, 2.0, (b, d)).astype(f), d),
        "w01": (rng.uniform(0, 1, (b, 1)).astype(f), 1),
        "p": (rng.uniform(0.5, 2.0, (b, 1)).astype(f), 1),
        "s1": (normal(b, 1), 1), "k3": (normal(b, 3), 3),
        "v3d": (normal(b, 3 * d), 3 * d), "a16": (normal(b, 16), 16),
        "b16": (normal(b, 16), 16), "c5": (normal(b, 5), 5),
        "img": (normal(b, d), d),
        "idx": (rng.randint(0, 3, b).astype(np.int32), 1),
        "sel": ((rng.uniform(0, 1, (b, d)) < 0.5).astype(f), d),
        "ties": (ties, d),
        "probs": (rng.dirichlet(np.ones(64), b).astype(f), 64),
        "label": (rng.randint(0, A10B_V, b).astype(np.int32), 1),
        "off": (off, 1), "size": (size, 1),
        "start": (rng.randint(0, 4, b).astype(np.int32), 1),
        "end": (rng.randint(4, t + 4, b).astype(np.int32), 1),
        "xs": ((normal(b, t, d), lengths), d),
        "ys": ((normal(b, t, d), lengths), d),
        "ws": ((rng.uniform(0, 1, (b, t, 1)).astype(f), lengths), 1),
        "bs": ((normal(b, 12, d), rng.randint(1, 13, b).astype(np.int32)),
               d),
        "ids": ((rng.randint(0, 6, (b, t)).astype(np.int32), lengths), 6)}


def a10b_graph(L, feed):
    """{name: LayerOutput} of every layer the phase holds, built with the
    port's DSL over data layers named as ``feed``'s keys."""
    d = A10B_D
    data = {k: L.data_layer(k, size=size, is_seq=isinstance(v, tuple))
            for k, (v, size) in feed.items()}

    def fc(act="tanh"):
        return L.fc_layer(data["x"], size=d, act=act)

    xs = L.fc_layer(data["xs"], size=d, act="tanh")
    out = {
        "interpolation": L.interpolation_layer([fc(), data["y"]],
                                               weight=data["w01"]),
        "interpolation_seq": L.interpolation_layer(
            [data["xs"], data["ys"]], weight=data["ws"]),
        "power": L.power_layer(data["pos"], weight=data["p"]),
        "scaling": L.scaling_layer(fc(), weight=data["s1"]),
        "slope_intercept": L.slope_intercept_layer(fc(), slope=2.0,
                                                   intercept=-0.5),
        "linear_comb": L.linear_comb_layer(data["k3"], data["v3d"], size=d),
        "sum_to_one_norm": L.sum_to_one_norm_layer(data["pos"]),
        "cos_sim": L.cos_sim(fc(), data["y"], scale=5.0),
        "cos_sim_vec_mat": L.cos_sim(data["x"], data["v3d"], size=3),
        "out_prod": L.out_prod_layer(data["a16"], data["b16"]),
        "trans": L.trans_layer(fc()),
        "rotate": L.rotate_layer(data["img"], height=8, width=8),
        "tensor": L.tensor_layer(data["a16"], data["b16"], size=d,
                                 act="tanh"),
        "multiplex": L.multiplex_layer([data["idx"], fc(), data["y"],
                                        data["z"]]),
        "conv_shift": L.conv_shift_layer(data["x"], data["c5"]),
        "featmap_expand": L.featmap_expand_layer(data["a16"], 16),
        "featmap_expand_elements": L.featmap_expand_layer(
            data["a16"], 16, as_row_vector=False),
        "resize": L.resize_layer(fc(), size=d // 2),
        "repeat": L.repeat_layer(data["a16"], 16),
        "repeat_seq": L.repeat_layer(xs, 2),
        "prelu": L.prelu_layer(fc(act=None)),
        "prelu_partial_sum": L.prelu_layer(fc(act=None), partial_sum=4),
        "selective_fc": L.selective_fc_layer(data["x"], size=d),
        "selective_fc_select": L.selective_fc_layer(
            data["x"], size=d, select=data["sel"], act="sigmoid"),
        "expand": L.expand_layer(fc(), expand_as=data["xs"]),
        "seq_concat": L.seq_concat_layer(xs, data["bs"]),
        "seq_reshape": L.seq_reshape_layer(xs, reshape_size=96),
        "sub_seq": L.sub_seq_layer(xs, offsets=data["off"],
                                   sizes=data["size"]),
        "seq_slice": L.seq_slice_layer(xs, starts=data["start"],
                                       ends=data["end"]),
        "seq_slice_starts": L.seq_slice_layer(xs, starts=data["start"]),
        "maxid": L.maxid_layer(data["ties"]),
        "maxid_seq": L.maxid_layer(xs),
        "eos": L.eos_layer(data["ids"], eos_id=3),
        "last_seq_stride": L.last_seq(xs, stride=5),
        "first_seq_stride": L.first_seq(xs, stride=5),
        "sampling_id": L.sampling_id_layer(data["probs"]),
        "nce": L.nce_layer(fc(), data["label"], num_classes=A10B_V),
        "hsigmoid": L.hsigmoid(fc(act="sigmoid"), data["label"],
                               num_classes=A10B_V),
        "add_number": fc() + 2.0, "rsub_number": 1.5 - fc(),
        "mul_number": 3.0 * fc(), "add_layer": fc() + data["y"],
        "sub_layer": fc() - data["y"], "add_size1": data["s1"] + fc(),
        "sub_size1": fc() - data["s1"], "mul_size1": data["s1"] * fc()}
    for op in ("exp", "abs", "sigmoid", "tanh", "square", "relu"):
        out[op] = getattr(L.layer_math, op)(fc(act=None))
    for op in ("log", "sqrt"):
        out[op] = getattr(L.layer_math, op)(data["pos"])
    return out


def a10b_run(torch, device, feed, start, given=None):
    """The graph on ``device`` from the parameters ``start`` (host
    tensors): ({name: (value, lengths or None)}, {parameter path or feed
    name: gradient}, forward + backward ms, the draws), each on the host;
    ``given`` replays another run's draws.  The float outputs' seeded
    cotangents follow the graph's order, the same on every device."""
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.utils.tree import tree_map

    def data_of(v):
        return v.data if isinstance(v, SequenceBatch) else v

    L.reset_names()
    graph = a10b_graph(L, feed)
    topo = L.Topology(list(graph.values()))
    params = tree_map(lambda t: t.to(device).requires_grad_(True), start)
    tensors = {k: torch.tensor(v[0] if isinstance(v, tuple) else v,
                               device=device) for k, (v, _) in feed.items()}
    for t in tensors.values():
        if t.is_floating_point():
            t.requires_grad_(True)
    tfeed = {k: SequenceBatch(tensors[k], torch.tensor(v[1], device=device))
             if isinstance(v, tuple) else tensors[k]
             for k, (v, _) in feed.items()}
    draws, cots = [], np.random.RandomState(A10B_B + A10B_D)
    gen = torch.Generator(device=device).manual_seed(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with draw_probe(draws, given):
        outs = dict(zip(graph, topo.apply(params, tfeed, mode="train",
                                          generator=gen)))
    total = sum((data_of(o) * torch.tensor(cots.randn(
        *data_of(o).shape).astype(np.float32), device=device)).sum()
        for o in outs.values() if data_of(o).requires_grad)
    total.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    values = {n: (data_of(o).detach().cpu(),
                  o.lengths.cpu() if isinstance(o, SequenceBatch) else None)
              for n, o in outs.items()}
    grads = {f"{k}.{n}": p.grad.cpu() for k, v in params.items()
             for n, p in v.items() if p.grad is not None}
    grads.update({k: t.grad.cpu() for k, t in tensors.items()
                  if t.grad is not None})
    return values, grads, ms, draws


def run_layers_a10b(torch, dev, kernels, seed):
    """layers_a10b: the elementwise, sequence, layer_math and sampled-cost
    layers on the card against the CPU (A10B_TOL), the card's draws
    replayed on the CPU; no counted kernel launched."""
    import paddle_tpu_torch.layers as L
    feed = a10b_feed(np.random.RandomState(seed + 26))
    L.reset_names()
    start = L.Topology(list(a10b_graph(L, feed).values())).init(
        torch.Generator().manual_seed(seed), device="cpu")
    a10b_run(torch, dev, feed, start)              # warm-up
    kernels.reset_launches()
    card, card_g, ms, draws = a10b_run(torch, dev, feed, start)
    launched = sum(launch_counts(kernels).values()) \
        + recurrent_launches(kernels)
    cpu, cpu_g, cpu_ms, _ = a10b_run(torch, "cpu", feed, start,
                                     given=draws)
    errs, unequal = {}, []
    for n, (got, lens) in card.items():
        want, want_lens = cpu[n]
        if got.is_floating_point():
            errs[n] = largest_err([got], [want])[0]
        elif not torch.equal(got, want):
            unequal.append(n)
        if lens is not None and not torch.equal(lens, want_lens):
            unequal.append(f"{n} lengths")
    errs.update(zip((f"d {k}" for k in card_g), largest_err(
        list(card_g.values()), [cpu_g[k] for k in card_g])))
    out = {"phase": "layers_a10b", "config": {
        "batch": A10B_B, "width": A10B_D, "seq_len_max": A10B_T,
        "classes": A10B_V, "layers": sorted(card),
        "entry": "layers.Topology.apply and autograd"},
        "tolerance": A10B_TOL,
        "rel_err_max": max(errs.values()),
        "worst": sorted(errs.items(), key=lambda kv: -kv[1])[:6],
        "outputs": len(card), "gradients": len(card_g),
        "draws_replayed": [list(u.shape) for u in draws],
        "ms_forward_backward": ms, "cpu_ms_forward_backward": cpu_ms,
        "counted_kernel_launches": launched}
    if max(errs.values()) > A10B_TOL or unequal or launched \
            or set(card_g) != set(cpu_g) or len(draws) != 2:
        fail(f"layers_a10b: card vs CPU (ids or lengths unequal at "
             f"{unequal}): {out}")
    emit(out)


# train_word2vec: demo/word2vec (models/word2vec_dsl: a 5-gram over the
# imikolov loader's 2073 words, four embeddings of 32 sharing "emb",
# fc 128 sigmoid, then hsigmoid or a softmax fc of the vocab) through
# SGD at batch 64 with AdaGrad lr 0.1, each variant: the first step's
# loss and every gradient leaf on the card against the CPU from the
# same weights within W2V_TOL of the CPU's largest entry, then
# W2V_PASSES passes of the 64 train batches: the first pass's last 8
# losses average below its first 8 (the demo's AdaGrad kicks the loss up
# from 6.4 to 24 at its second step, hsigmoid, before it falls), and
# SGD.test's cost after them below the start weights' (after one pass it
# is not yet, on the synthetic stream); then the CLI on word2vec_dsl.py.
# No counted kernel is on this path.
W2V_TOL = 1e-5
W2V_PASSES = 3
W2V_CLI_CONFIG = "paddle_tpu_torch/models/word2vec_dsl.py"


def run_train_word2vec(torch, dev, kernels, seed):
    """train_word2vec and train_word2vec_softmax (see W2V_TOL)."""
    from paddle_tpu_torch.models import word2vec_dsl
    from paddle_tpu_torch.trainer import SGD
    for use_hs in (True, False):
        what = "train_word2vec" + ("" if use_hs else "_softmax")
        cfg = word2vec_dsl.config(use_hs)
        data, feeding = list(cfg["train_reader"]()), cfg["feeding"]

        def build():
            return word2vec_dsl.build(use_hs)[0]

        card, start, first, first_launches = graph_first_step(
            torch, dev, kernels, build, word2vec_dsl.optimizer, feeding,
            data[0], what, W2V_TOL)
        if first_launches != (0, 0):
            fail(f"{what}: the first step launched the LSTM kernels "
                 f"{first_launches} times")
        times, losses = [], [first["loss"][0]]
        for i in range(W2V_PASSES):
            ms, ls, _ = sgd_pass(torch, kernels, card,
                                 data[1:] if i == 0 else data, feeding, what)
            times += ms
            losses += ls
        head, tail = np.mean(losses[:8]), np.mean(losses[len(data) - 8:
                                                         len(data)])
        if not tail < head:
            fail(f"{what}: the first pass's last 8 losses average {tail}, "
                 f"not below its first 8's {head}")
        test_cost = test_cost_falls(cfg, card, start, what)
        cli = rnn_cli(torch, dev, seed, card, what=what,
                      config_file=W2V_CLI_CONFIG,
                      config_args=("" if use_hs else "use_hsigmoid=0,")
                      + "batches=2", batches=2,
                      fresh=lambda: SGD(
                          build(), update_equation=word2vec_dsl.optimizer(),
                          device=dev))
        ms = float(np.median(times[2:]))
        emit({"phase": what, "config": {
            "model": "demo/word2vec (models/word2vec_dsl, layer DSL: "
                     "embedding_layer x 4 sharing 'emb', concat_layer, "
                     "fc_layer, " + ("hsigmoid" if use_hs else
                                     "fc_layer softmax + "
                                     "classification_cost") + ")",
            "vocab": word2vec_dsl.imikolov.WORD_DIM, "emb": word2vec_dsl.EMB,
            "hidden": word2vec_dsl.HIDDEN, "ngram": word2vec_dsl.N,
            "batch": word2vec_dsl.BATCH, "batches": len(data),
            "passes": W2V_PASSES,
            "data": "data.datasets.imikolov train (synthetic stream)",
            "optimizer": "AdaGrad lr 0.1", "entry": "trainer.SGD.train"},
            "ms_per_batch": ms,
            "ms_per_batch_min_max": [min(times[2:]), max(times[2:])],
            "samples_per_s": word2vec_dsl.BATCH / (ms / 1e3),
            "loss_first_pass_first8_last8": [head, tail],
            "loss_last": losses[-1], "test_cost": test_cost,
            "first_step_vs_cpu": first, "cli": cli,
            "counted_kernel_launches": 0})
        F32_MS[what] = ms


# train_seqtoseq_demo: demo/seqToseq's training script
# (models/seqtoseq_demo: hidden = emb 256, batch 32 of the wmt14
# loader's ragged sources of 3-29 tokens, Adam lr 5e-4 with clip_norm
# 5.0; the encoder's two GRUs pass the fused rule at B 32, D 256).
# Before any step the encoder's outputs on the first batch (the reverse
# GRU over the time-flipped ragged rows) against the CPU; the first
# step's loss and every gradient leaf against a CPU step from the same
# weights within S2D_TOL of the CPU's largest entry, which the same step
# with the GRUs through the one-TF32-pass build of csrc/gru.cu must fail
# (both readings emitted beside the limit); the GRU kernels launched 2 +
# 2 a step over the pass of 64 batches (the feed included in each step's
# time), whose last 8 losses average below its first 8; then
# seq2seq.generate (beam 5, 40 steps) on the first S2D_GEN_SRC test
# sources, the lean forward launched once a direction, held against a
# CPU run row by row up to each row's first near-tie (beam_agreement).
# S2D_TOL lies between the readings on an H100 (PERF.md §6): the sound
# step 2.7e-5 of its largest gradient entry (att_dec, the decoder's
# attention projection summed over every target step and row), the
# one-TF32-pass GRU control 3.1e-4 (enc_bwd.w_gate).
S2D_HIDDEN, S2D_BATCH = 256, 32
S2D_TOL = 1e-4
S2D_GEN_BEAM, S2D_GEN_LEN, S2D_GEN_SRC = 5, 40, 8


def run_train_seqtoseq_demo(torch, dev, kernels):
    """train_seqtoseq_demo (see S2D_TOL) over scripts/bench.
    bench_seqtoseq_demo's step and pass; returns the GRU launches of its
    train pass and of its generate."""
    import itertools
    from paddle_tpu_torch.data.datasets import wmt14
    from paddle_tpu_torch.models import seq2seq, seqtoseq_demo as sd
    from paddle_tpu_torch.scripts import bench as bench_mod
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
    gk = kernels.gru
    b = bench_mod.bench_seqtoseq_demo(device=dev)
    batches, card_p = b.batches, b.params
    start = tree_map(lambda t: t.detach().cpu().numpy().copy(), card_p)
    cpu_p, _, cpu_step = sd.setup(S2D_HIDDEN, S2D_HIDDEN, "cpu",
                                  params=start)
    feed_c, feed_r = sd.feed_batch(batches[0], dev), sd.feed_batch(
        batches[0], "cpu")
    with torch.no_grad():
        enc_c, enc_r = (seq2seq.encode(p, f[0]) for p, f in (
            (card_p, feed_c), (cpu_p, feed_r)))
    enc_err = dict(zip(("enc", "proj", "boot"), largest_err(
        [enc_c[0].data.cpu(), enc_c[1].data.cpu(), enc_c[2].cpu()],
        [enc_r[0].data, enc_r[1].data, enc_r[2]])))
    if max(enc_err.values()) > S2D_TOL:
        fail(f"train_seqtoseq_demo: the encoder on the card against the "
             f"CPU {enc_err}, limit {S2D_TOL}")

    def grads(params):
        return [p.grad.detach().cpu() for p in tree_leaves(params)]

    def launches():
        return (gk.launches_fwd, gk.launches_bwd, recurrent_launches(kernels)
                + sum(launch_counts(kernels).values()))

    # the pass's first step (bench's train_step takes batches[0] first)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    card = (float(b.train_step()), grads(card_p))
    times, losses = [(time.perf_counter() - t0) * 1e3], [card[0]]
    per_step = [launches()]
    ref = (float(cpu_step(*feed_r)), grads(cpu_p))
    ctl_p, _, ctl_step = sd.setup(S2D_HIDDEN, S2D_HIDDEN, dev, params=start)
    ctl_feed = sd.feed_batch(batches[0], dev)
    with tf32_1x("gru"):
        ctl = (float(ctl_step(*ctl_feed)), grads(ctl_p))
    first = gate_first_step(
        "train_seqtoseq_demo", card, ref, S2D_TOL,
        ("the encoder GRUs through the one-TF32-pass build of csrc/gru.cu",
         ctl), leaf_names(cpu_p), encoder_rel_err=enc_err)
    del ctl_p, cpu_p
    for _ in batches[1:]:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        losses.append(float(b.train_step()))
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(launches())
    if any(n != (2, 2, 4) for n in per_step):
        fail(f"train_seqtoseq_demo: per-step (GRU forward, GRU backward, "
             f"every counted kernel) launches {per_step}, want (2, 2, 4) "
             f"each step")
    head, tail = np.mean(losses[:8]), np.mean(losses[-8:])
    if not all(math.isfinite(x) for x in losses) or not tail < head:
        fail(f"train_seqtoseq_demo: losses not finite or the last 8 not "
             f"below the first 8: {losses}")

    batch = list(itertools.islice(wmt14.test()(), S2D_GEN_SRC))
    src = sd.feed_batch(batch, dev)[0]
    kw = dict(beam_size=S2D_GEN_BEAM, max_len=S2D_GEN_LEN,
              bos_id=wmt14.START, eos_id=wmt14.END)
    seq2seq.generate(card_p, src, **kw)               # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    trace = []
    t0 = time.perf_counter()
    res = seq2seq.generate(card_p, src, trace=trace, **kw)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    gen_launches = {gk.NAME_FWD: gk.launches_fwd, gk.NAME_BWD: gk.launches_bwd}
    if gen_launches != {gk.NAME_FWD: 2, gk.NAME_BWD: 0} \
            or recurrent_launches(kernels) != 2 \
            or sum(launch_counts(kernels).values()):
        fail(f"train_seqtoseq_demo: generate launched {gen_launches} (every "
             f"recurrent kernel {recurrent_launches(kernels)}), want the "
             f"lean forward twice and nothing else")
    params_cpu = tree_map(lambda p: p.detach().cpu(), card_p)
    cpu_trace = []
    cpu_res = seq2seq.generate(params_cpu, sd.feed_batch(batch, "cpu")[0],
                               trace=cpu_trace, **kw)
    vs_cpu = beam_agreement("train_seqtoseq_demo generate card vs CPU",
                            cpu_res, res, cpu_trace, trace, S2D_GEN_SRC)
    train = {gk.NAME_FWD: sum(n[0] for n in per_step),
             gk.NAME_BWD: sum(n[1] for n in per_step)}
    ms = float(np.median(times[3:]))
    emit({"phase": "train_seqtoseq_demo", "config": {
        "model": "demo/seqToseq (models/seqtoseq_demo over models/seq2seq: "
                 "bi-GRU encoder, additive attention, GRU decoder)",
        "vocab": [wmt14.SRC_DICT_SIZE, wmt14.TRG_DICT_SIZE],
        "emb": S2D_HIDDEN, "hidden": S2D_HIDDEN, "batch": S2D_BATCH,
        "batches": len(batches),
        "data": "data.datasets.wmt14 train, shuffled (buffer 1024, seed 0), "
                "sources of 3-29 tokens",
        "optimizer": "Adam lr 5e-4 clip_norm 5",
        "entry": "scripts/bench.bench_seqtoseq_demo's train_step "
                 "(seqtoseq_demo.setup's step, feed_batch included)"},
        "ms_per_batch": ms,
        "ms_per_batch_min_max": [min(times[3:]), max(times[3:])],
        "samples_per_s": S2D_BATCH / (ms / 1e3),
        "target_tokens_per_s": b.target_tokens_per_step / (ms / 1e3),
        "launches": train, "launches_per_step": dict(zip(train, (2, 2))),
        "loss_first8_last8": [head, tail], "loss_last": losses[-1],
        "first_step": first,
        "generate": {"sources": S2D_GEN_SRC, "beam": S2D_GEN_BEAM,
                     "max_len": S2D_GEN_LEN, "ms": gen_ms,
                     "launches": gen_launches, "vs_cpu": vs_cpu,
                     "mean_best_score": float(res.scores[:, 0].mean())}})
    F32_MS["train_seqtoseq_demo"] = ms
    return {"train": train, "generate": gen_launches}


# train_sparse: models/text_rnn's LSTM config (vocab 30000, emb 128, two
# lstmemory layers of 512, batch 64 x 100 ids, Momentum lr 0.01 m 0.9)
# with its embedding trained by its touched rows (SGD's sparse step):
# the first step's loss and every gradient (the row block's, not the
# table's) against a CPU witness within SPARSE_TOL of each one's largest
# entry, which the same step through the one-TF32-pass LSTM build must
# fail; the first step equal to the card's own dense step within
# SPARSE_DENSE_TOL of each leaf's largest entry (momentum starts at 0, so
# an untouched row moves under neither); after a second step the rows the
# first touched and the second did not bit for bit unchanged under the
# sparse path and moved under the dense one; B9 2 + 2 a step over
# SPARSE_BATCHES batches.  Then ms/batch, samples/s and the host sync's
# share (ops/sparse.unique_touched alone, bench.sparse_sync_ms), sparse
# and dense, at vocab 30000 and SPARSE_BIG_VOCAB (JAX's capability
# vocab, tests/test_sparse.py:121-145): printed, not gated.
SPARSE_TOL = 2e-5
SPARSE_DENSE_TOL = 1e-6
SPARSE_BATCHES = 8
SPARSE_BIG_VOCAB = 1_000_000
SPARSE_TIMED = 10


def sparse_rate(torch, dev, kernels, vocab, sparse):
    """ms/batch (median of SPARSE_TIMED steps after 3 of warm-up),
    samples/s, the LSTM launches a step and, sparse, the host sync alone
    and its share, of text_rnn's LSTM config at ``vocab``."""
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.scripts import bench
    b = bench.bench_rnn(cell="lstm", sparse_update=sparse, vocab=vocab,
                        n_batches=4, device=dev)
    for _ in range(3):
        b.train_step()
    torch.cuda.synchronize()
    kernels.reset_launches()
    times = []
    for _ in range(SPARSE_TIMED):
        t0 = time.perf_counter()
        b.train_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    lk = kernels.lstm
    per_step = (lk.launches_fwd / SPARSE_TIMED, lk.launches_bwd / SPARSE_TIMED)
    if per_step != (2, 2):
        fail(f"train_sparse: vocab {vocab} sparse={sparse}: LSTM launches "
             f"a step {per_step}, want (2, 2)")
    ms = float(np.median(times))
    out = {"ms_per_batch": ms, "ms_min_max": [min(times), max(times)],
           "samples_per_s": text_rnn.BATCH / (ms / 1e3)}
    if sparse:
        sync = bench.sparse_sync_ms(b, SPARSE_TIMED)
        out.update(host_sync_ms=sync, host_sync_share=sync / ms)
    del b
    torch.cuda.empty_cache()
    return out


def run_train_sparse(torch, dev, kernels, seed):
    """train_sparse (see SPARSE_TOL); returns the B9 launches of its
    steps."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves
    lk = kernels.lstm
    data = list(text_rnn.batches(seed + 27, SPARSE_BATCHES)())
    feeding = text_rnn.feeding()

    def build(sparse=True):
        return text_rnn.build(cell="lstm", sparse_update=sparse)
    card, start, first, first_launches = graph_first_step(
        torch, dev, kernels, build, text_rnn.optimizer, feeding, data[0],
        "train_sparse", SPARSE_TOL, control=lambda: tf32_1x("lstm"))
    if first_launches != (2, 2):
        fail(f"train_sparse: the first step launched the LSTM kernels "
             f"{first_launches} times, want (2, 2)")
    if not set(card.opt_state) == {"dense", "sparse"} or any(
            p.requires_grad for p in tree_leaves(card.parameters[
                next(iter(card._sparse_specs))])):
        fail("train_sparse: the trainer did not take the sparse path")
    # the card's dense step from the same weights on the same batch
    dense = SGD(cost=build(False), parameters=start,
                update_equation=text_rnn.optimizer(), device=dev)
    feeder = DataFeeder(feeding, device=dev)
    dense.train_one_batch(data[0], feeder)
    errs = largest_err([p.detach().cpu() for p in tree_leaves(
        card.parameters)], [p.detach().cpu() for p in tree_leaves(
            dense.parameters)])
    vs_dense = {"tolerance": SPARSE_DENSE_TOL, "rel_err_max": max(errs)}
    if max(errs) > SPARSE_DENSE_TOL:
        fail(f"train_sparse: the first sparse step against the card's "
             f"dense step: {vs_dense}")
    # the catch-up: rows touched at step 1 and not at step 2
    key = next(iter(card._sparse_specs))
    ids = [set(np.unique(np.concatenate([s[0] for s in batch])).tolist())
           for batch in data[:2]]
    only1 = torch.tensor(sorted(ids[0] - ids[1]), device=dev)
    w1 = card.parameters[key]["w"].detach()[only1].clone()
    kernels.reset_launches()
    card.train_one_batch(data[1], feeder)
    second = (lk.launches_fwd, lk.launches_bwd)
    dense.train_one_batch(data[1], feeder)
    sparse_same = bool(torch.equal(card.parameters[key]["w"].detach()[only1],
                                   w1))
    moved = int((dense.parameters[key]["w"].detach()[only1] != w1)
                .any(dim=1).sum())
    catch_up = {"rows_touched_at_1_not_2": int(only1.numel()),
                "unchanged_sparse": sparse_same, "moved_dense": moved}
    if not sparse_same or moved != only1.numel() or second != (2, 2):
        fail(f"train_sparse: catch-up rows {catch_up}, the second step's "
             f"LSTM launches {second}")
    del dense
    times, losses, pass_launches = sgd_pass(
        torch, kernels, card, data[2:], feeding, "train_sparse",
        per_step=(2, 2))
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_sparse: losses {losses}")
    launches = {lk.NAME_FWD: first_launches[0] + second[0]
                + pass_launches[lk.NAME_FWD],
                lk.NAME_BWD: first_launches[1] + second[1]
                + pass_launches[lk.NAME_BWD]}
    del card
    torch.cuda.empty_cache()
    rates = {str(vocab): {kind: sparse_rate(torch, dev, kernels, vocab,
                                            kind == "sparse")
                          for kind in ("sparse", "dense")}
             for vocab in (text_rnn.VOCAB, SPARSE_BIG_VOCAB)}
    emit({"phase": "train_sparse", "config": {
        "model": "models/text_rnn cell=lstm sparse_update=True (the "
                 "reference's benchmark/paddle/rnn/rnn.py)",
        "vocab": text_rnn.VOCAB, "emb": text_rnn.EMB,
        "hidden": text_rnn.HIDDEN, "layers": text_rnn.LAYERS,
        "batch": text_rnn.BATCH, "seq_len": text_rnn.SEQ_LEN,
        "batches": SPARSE_BATCHES, "optimizer": "Momentum lr 0.01 m 0.9",
        "entry": "trainer.SGD.train"},
        "first_step_vs_cpu": first, "first_step_vs_dense": vs_dense,
        "catch_up": catch_up, "launches": launches,
        "launches_per_step": {lk.NAME_FWD: 2, lk.NAME_BWD: 2},
        "pass_ms": times, "losses": losses,
        "rates_by_vocab": rates})
    return {"train_sparse": launches}


# nested_a9f: models/text_dsl's nested config (imdb reviews cut into
# sub-sequences of at most 16 tokens, 1-8 of them; embedding 128, an
# average within each sub-sequence, fc 512, lstmemory 128 over the
# sentences, max pool, fc 2 softmax, Adam lr 0.002) at batch 64: the
# first step's loss and every gradient against a CPU witness within
# NESTED_TOL of each one's largest entry plus FLOOR_TIMES the leaf's own
# float32 noise (the output bias: see FLOOR_TIMES), B9 1 + 1 a step,
# then two more Adam steps through SGD.train.
NESTED_TOL = 1e-5
NESTED_BATCHES = 3


def run_nested_a9f(torch, dev, kernels):
    from paddle_tpu_torch.models import text_dsl
    lk = kernels.lstm
    cfg = text_dsl.config("nested", n_batches=NESTED_BATCHES)
    data, feeding = list(cfg["train_reader"]()), cfg["feeding"]
    card, _, first, first_launches = graph_first_step(
        torch, dev, kernels, lambda: text_dsl.build("nested")[0],
        lambda: text_dsl.optimizer("nested"), feeding, data[0],
        "nested_a9f", NESTED_TOL, floors=True)
    if first_launches != (1, 1):
        fail(f"nested_a9f: the first step launched the LSTM kernels "
             f"{first_launches} times, want (1, 1)")
    times, losses, pass_launches = sgd_pass(
        torch, kernels, card, data[1:], feeding, "nested_a9f",
        per_step=(1, 1))
    subs = [len(s) for batch in data for s, _ in batch]
    launches = {lk.NAME_FWD: first_launches[0] + pass_launches[lk.NAME_FWD],
                lk.NAME_BWD: first_launches[1] + pass_launches[lk.NAME_BWD]}
    emit({"phase": "nested_a9f", "config": {
        "model": "models/text_dsl nested_lstm_net (pooling_layer avg "
                 "agg_level='seq', lstmemory over sub-sequences)",
        "batch": text_dsl.BATCH, "sub_len": text_dsl.SUB_LEN,
        "sub_sequences": [min(subs), max(subs)], "emb": 128, "hid": 128,
        "optimizer": "Adam lr 0.002", "entry": "trainer.SGD.train",
        "data": "data.datasets.imdb train (synthetic fallback unless "
                "PADDLE_TPU_DATA_DIR holds aclImdb)"},
        "first_step_vs_cpu": first, "launches": launches,
        "launches_per_step": {lk.NAME_FWD: 1, lk.NAME_BWD: 1},
        "ms_per_batch": times, "losses": losses})
    return {"nested_a9f": launches}


# trainer_prefetch: bench.bench_trainer_prefetch's config (bench.py's: an
# MLP at batch 64, dim 256, hidden 512, 24 batches of 4 ms host cost,
# Momentum): a pass at prefetch=2 and one at prefetch=0 from the same
# weights give parameters bit for bit equal; steps/s at both depths,
# the speedup and the prefetch-2 pass's mean h2d_wait, printed.
def run_trainer_prefetch(torch, dev, kernels):
    from paddle_tpu_torch.scripts import bench
    from paddle_tpu_torch.utils.tree import tree_leaves
    b = bench.bench_trainer_prefetch(device=dev)
    kernels.reset_launches()
    sync = b.one_pass(0, b.trainer())
    pre = b.one_pass(2, b.trainer())
    equal = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(sync.parameters), tree_leaves(pre.parameters)))
    launched = sum(launch_counts(kernels).values()) \
        + recurrent_launches(kernels)
    if not equal or launched:
        fail(f"trainer_prefetch: prefetch=2 bit for bit prefetch=0: "
             f"{equal}; counted kernel launches {launched}")
    emit({"phase": "trainer_prefetch", "config": {
        "model": "bench.py bench_trainer_prefetch: fc 512 tanh, fc 2 "
                 "softmax over dense 256", "batch": 64, "batches": 24,
        "host_ms": 4.0, "optimizer": "Momentum lr 0.01 m 0.9",
        "entry": "trainer.SGD.train(prefetch=0 | 2)"},
        "prefetch2_bit_for_bit_prefetch0": equal,
        **bench.prefetch_rates(b)})


# train_lstm_group: models/text_rnn's LSTM classifier (bench_lstm's
# config: vocab 30000, emb 128, two layers of h 512 over fc 4h
# projections, max pool, fc 2 softmax; batch 64 x 100, Momentum) with each
# lstmemory a networks.lstmemory_group, through SGD.  The group runs
# ops/rnn.lstm_cell in a Python loop over time (JAX's lax.scan of plain
# ops): no kernel of its own.
# - The first step on the card against the CPU witness at GROUP_TOL, as
#   the other DSL LSTM configs are held (SENT_TOL, SPARSE_TOL), each leaf
#   with FLOOR_TIMES its float32 noise beside (the output bias's gradient
#   cancels at init: 1.25e-5 of its entry, card vs CPU, every other leaf
#   far below); the same card step with cuBLAS's TF32 products on must
#   fail it.  Then
#   GROUP_BATCHES more steps through SGD.train, no counted kernel
#   launched.
# - Its twin, text_rnn cell="lstm" on text_rnn.twin_params of the same
#   start, through SGD over the same batches (B9 2 + 2 a step).
# - On one batch, from the group's start with its step biases drawn at
#   N(0, 0.1) (so the peepholes carry weight): the group's loss, both
#   recurrent layers' outputs and every gradient against the twin's on
#   the card, the outputs within LSTM_TOL absolute, the loss and each
#   gradient leaf within TRAIN_REL_TOL of its largest entry (the twin's
#   B9 runs 3xTF32 products, the group cuBLAS float32, 2 x 100 steps in
#   other orders); the twin with its peepholes zeroed must fail the gate.
#   Peak memory of the group's step and of the twin's beside.
# - networks.gru_group against grumemory the same way at the seq2seq
#   shape (T GRU_GROUP_T, B 64, D 512; B10 2 + 2), its biases drawn at
#   N(0, 0.1) and zeroed in the control.
# - The scan hoist (layers/recurrent.HOIST_SCAN_INVARIANTS) on and off on
#   lstm_recurrent_layer_group (its input transform is already outside
#   the group: an empty frontier) and on a group that projects its input
#   inside the step (fc 4h, then networks.lstmemory_unit: the frontier is
#   that fc), at the same width: ms of a forward and backward each way
#   after one untimed pass each, the two taken in turns (on, off, off,
#   on, ...; median of HOIST_REPS each), loss and gradients equal within
#   HOIST_TOL.  The twin checks' ms likewise: the median of TWIN_TIMED
#   passes after the checked one.
GROUP_TOL = 2e-5
GROUP_BATCHES = 8
GROUP_WARMUP = 2               # steps of the pass left out of ms/batch
GRU_GROUP_T = 30
HOIST_TOL = 1e-5
HOIST_REPS = 4
TWIN_TIMED = 3


def fwd_bwd_ms(torch, topo, params, feed):
    """ms of one forward and backward of ``topo``'s mean output on fresh
    leaves of ``params``, synchronized; and the leaves and the loss."""
    from paddle_tpu_torch.layers.graph import value_data
    from paddle_tpu_torch.utils.tree import tree_map
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = torch.mean(value_data(topo.apply(leaves, feed)))
    loss.backward()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, leaves, float(loss.detach())


def twin_pass(torch, kernels, cell, params, feed):
    """One forward and backward of text_rnn ``cell`` on ``params`` (fresh
    leaves) and ``feed``: (loss, each recurrent layer's output, the
    leaves with their grads, its (LSTM, GRU) kernel launches, peak MB),
    then the median ms of TWIN_TIMED more."""
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.layers.graph import value_data
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.utils.tree import tree_map
    cost = text_rnn.build(cell=cell)
    rnns = [n for n in L.Topology(cost).order if n.layer_type in (
        "recurrent_group", "lstmemory", "grumemory")]
    topo = L.Topology([cost] + rnns)
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    outs = topo.apply(leaves, feed, mode="train")
    loss = torch.mean(value_data(outs[0]))
    loss.backward()
    torch.cuda.synchronize()
    launches = (kernels.lstm.launches_fwd + kernels.lstm.launches_bwd,
                kernels.gru.launches_fwd + kernels.gru.launches_bwd)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = [fwd_bwd_ms(torch, L.Topology(cost), params, feed)[0]
          for _ in range(TWIN_TIMED)]
    return {"loss": float(loss.detach()),
            "outs": [value_data(o).detach() for o in outs[1:]],
            "leaves": leaves, "launches": launches,
            "ms": float(np.median(ms)), "peak_mb": peak}


def group_twin_check(torch, dev, kernels, cell, batch, seed):
    """text_rnn ``cell`` (a group cell) against its twin on the card, on
    one batch, from the group's start with its step biases drawn at
    N(0, 0.1); the control zeroes the twin's peepholes (LSTM) or its
    bias (GRU).  Returns the readings; the phase fails unless the twin
    passes and the control fails."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map
    twin_cell = text_rnn.TWINS[cell]
    start = host_tree(SGD(cost=text_rnn.build(cell=cell),
                          update_equation=text_rnn.optimizer(),
                          device="cpu").parameters)
    gen = torch.Generator().manual_seed(seed)
    for key, p in start.items():
        if key.startswith(("lstm", "gru")) and "b" in p:
            p["b"] = 0.1 * torch.randn(p["b"].shape, generator=gen)
    start = tree_map(lambda t: t.to(dev), start)
    feed = DataFeeder(text_rnn.feeding(), device=dev)(batch)
    group = twin_pass(torch, kernels, cell, start, feed)
    if group["launches"] != (0, 0):
        fail(f"train_lstm_group: the {cell} step launched the (LSTM, GRU) "
             f"kernels {group['launches']} times, want none")
    twin_params = text_rnn.twin_params(start, cell)

    def readings(params):
        twin = twin_pass(torch, kernels, twin_cell, params, feed)
        grads = text_rnn.twin_params(
            tree_map(lambda t: t.grad, group["leaves"]), cell)
        want = tree_map(lambda t: t.grad, twin["leaves"])
        return twin, {
            "loss_rel_err": abs(group["loss"] - twin["loss"])
            / abs(twin["loss"]),
            "outputs_max_abs_err": max(float((g - w).abs().max()) for g, w
                                       in zip(group["outs"], twin["outs"])),
            "grad_rel_err_max": max(largest_err(tree_leaves(grads),
                                                tree_leaves(want)))}

    def passes(r):
        return (r["loss_rel_err"] <= TRAIN_REL_TOL
                and r["outputs_max_abs_err"] <= LSTM_TOL
                and r["grad_rel_err_max"] <= TRAIN_REL_TOL)

    twin, sound = readings(twin_params)
    d = text_rnn.HIDDEN

    def zeroed(key, p):
        if not key.startswith(("__lstmemory", "__grumemory")):
            return p
        b = p["b"].clone()
        b[4 * d if cell == "lstm_group" else 0:] = 0.0
        return {**p, "b": b}
    _, control = readings({k: zeroed(k, p) for k, p in twin_params.items()})
    want = (2, 0) if cell == "lstm_group" else (0, 2)
    per_pass = tuple(2 * n for n in want)       # forward and backward
    out = {"vs_twin": sound, "control": {
        "what": "the twin with its peepholes zeroed" if cell == "lstm_group"
        else "the twin with its bias zeroed", **control},
        "limits": {"loss_rel": TRAIN_REL_TOL, "outputs_abs": LSTM_TOL,
                   "grad_rel": TRAIN_REL_TOL},
        "twin_launches": {"lstm": twin["launches"][0],
                          "gru": twin["launches"][1]},
        "group_ms": group["ms"], "twin_ms": twin["ms"],
        "group_peak_mb": group["peak_mb"], "twin_peak_mb": twin["peak_mb"]}
    if not passes(sound) or passes(control) or twin["launches"] != per_pass:
        fail(f"train_lstm_group: {cell} against its twin on the card "
             f"(the twin must pass, the control fail, the twin launch "
             f"{per_pass}): {out}")
    return out


def hoist_config(kind):
    """The hoist's two graphs over text_rnn's embedding at its width:
    lstm_recurrent_layer_group, or a group that projects its input
    inside the step."""
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.models import text_rnn
    L.reset_names()
    word = L.data_layer("word", text_rnn.VOCAB, is_seq=True)
    emb = L.embedding_layer(word, size=text_rnn.EMB)
    h = text_rnn.HIDDEN
    if kind == "lstm_recurrent_layer_group":
        out = L.lstm_recurrent_layer_group(name="g", size=h, input=[emb])
    else:
        def step(x):
            x4 = L.fc_layer(x, size=4 * h, act=None, bias_attr=False)
            return L.networks.lstmemory_unit(x4, size=h, name="u")
        out = L.recurrent_group(step, emb)
    pooled = L.pooling_layer(out, pooling_type=L.pooling.Max)
    return L.classification_cost(
        L.fc_layer(pooled, size=text_rnn.CLASSES, act="softmax"),
        L.data_layer("label", 1))


def hoist_check(torch, dev, kernels, batch):
    """HOIST_SCAN_INVARIANTS on and off on both hoist graphs: the frontier,
    ms of a forward and backward each way, their loss and gradients."""
    import paddle_tpu_torch.layers as L
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.layers import recurrent as R
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.utils.tree import tree_leaves
    feed = DataFeeder(text_rnn.feeding(), device=dev)(batch)
    prior, out = R.HOIST_SCAN_INVARIANTS, {}
    try:
        for kind in ("lstm_recurrent_layer_group", "projected_in_step"):
            topo = L.Topology(hoist_config(kind))
            group = next(n for n in topo.order
                         if n.layer_type == "recurrent_group")
            frontier = R._hoistable_frontier(group.cfg["sub_topo"],
                                             group.cfg["seq_phs"], "train")
            params = topo.init(torch.Generator().manual_seed(1), device=dev)
            kernels.reset_launches()
            runs = {}
            for on in (True, False):            # untimed: the readings
                R.HOIST_SCAN_INVARIANTS = on
                _, leaves, loss = fwd_bwd_ms(torch, topo, params, feed)
                runs[on] = {"ms": [], "loss": loss,
                            "grads": [t.grad for t in tree_leaves(leaves)]}
            for i in range(HOIST_REPS):
                for on in ((True, False) if i % 2 == 0 else (False, True)):
                    R.HOIST_SCAN_INVARIANTS = on
                    runs[on]["ms"].append(
                        fwd_bwd_ms(torch, topo, params, feed)[0])
            launched = sum(launch_counts(kernels).values()) \
                + recurrent_launches(kernels)
            if launched:
                fail(f"train_lstm_group: the hoist's {kind} graph launched "
                     f"{launched} counted kernels")
            errs = largest_err(runs[True]["grads"], runs[False]["grads"])
            loss_err = abs(runs[True]["loss"] - runs[False]["loss"]) \
                / abs(runs[False]["loss"])
            out[kind] = {
                "frontier": [n.name for n in frontier],
                "ms_hoisted": float(np.median(runs[True]["ms"])),
                "ms_in_loop": float(np.median(runs[False]["ms"])),
                "loss_rel_err": loss_err, "grad_rel_err_max": max(errs),
                "tolerance": HOIST_TOL}
            if max(errs + [loss_err]) > HOIST_TOL:
                fail(f"train_lstm_group: hoisted against in-loop: {out}")
    finally:
        R.HOIST_SCAN_INVARIANTS = prior
    if out["lstm_recurrent_layer_group"]["frontier"] or \
            len(out["projected_in_step"]["frontier"]) != 1:
        fail(f"train_lstm_group: hoist frontiers {out}")
    return out


def run_train_lstm_group(torch, dev, kernels, seed):
    """train_lstm_group (see GROUP_TOL); returns the B9 and B10 launches
    of its twins."""
    from paddle_tpu_torch.models import text_rnn
    from paddle_tpu_torch.trainer import SGD
    lk, gk = kernels.lstm, kernels.gru
    data = list(text_rnn.batches(seed + 28, GROUP_BATCHES + 1)())
    feeding = text_rnn.feeding()
    card, start, first, first_launches = graph_first_step(
        torch, dev, kernels, lambda: text_rnn.build(cell="lstm_group"),
        text_rnn.optimizer, feeding, data[0], "train_lstm_group", GROUP_TOL,
        control=lambda: cublas_tf32(torch), floors=True)
    first["control"]["what"] = ("the same card step with cuBLAS's TF32 "
                                "products on, the card's argmax replayed")
    if first_launches != (0, 0):
        fail(f"train_lstm_group: the group's first step launched the LSTM "
             f"kernels {first_launches} times, want none")
    times, losses, _ = sgd_pass(torch, kernels, card, data[1:], feeding,
                                "train_lstm_group")
    del card
    twin = SGD(cost=text_rnn.build(cell="lstm"),
               parameters=text_rnn.twin_params(start, "lstm_group"),
               update_equation=text_rnn.optimizer(), device=dev)
    twin_times, twin_losses, twin_launches = sgd_pass(
        torch, kernels, twin, data, feeding, "train_lstm_group twin",
        per_step=(2, 2))
    del twin
    torch.cuda.empty_cache()
    lstm_twin = group_twin_check(torch, dev, kernels, "lstm_group", data[0],
                                 seed + 29)
    gru_batch = next(iter(text_rnn.batches(seed + 30, 1,
                                           seq_len=GRU_GROUP_T)()))
    gru_twin = group_twin_check(torch, dev, kernels, "gru_group", gru_batch,
                                seed + 31)
    hoist = hoist_check(torch, dev, kernels, data[0])
    torch.cuda.empty_cache()
    ms = float(np.median(times[GROUP_WARMUP:]))
    twin_ms = float(np.median(twin_times[1 + GROUP_WARMUP:]))
    launches = {lk.NAME_FWD: twin_launches[lk.NAME_FWD]
                + lstm_twin["twin_launches"]["lstm"] // 2,
                lk.NAME_BWD: twin_launches[lk.NAME_BWD]
                + lstm_twin["twin_launches"]["lstm"] // 2,
                gk.NAME_FWD: gru_twin["twin_launches"]["gru"] // 2,
                gk.NAME_BWD: gru_twin["twin_launches"]["gru"] // 2}
    emit({"phase": "train_lstm_group", "config": {
        "model": "models/text_rnn cell=lstm_group (networks.lstmemory_group "
                 "over fc 4h; bench_lstm's config, the reference's "
                 "benchmark/paddle/rnn/rnn.py)",
        "vocab": text_rnn.VOCAB, "emb": text_rnn.EMB,
        "hidden": text_rnn.HIDDEN, "layers": text_rnn.LAYERS,
        "batch": text_rnn.BATCH, "seq_len": text_rnn.SEQ_LEN,
        "batches": GROUP_BATCHES + 1, "optimizer": "Momentum lr 0.01 m 0.9",
        "entry": "trainer.SGD.train", "gru_seq_len": GRU_GROUP_T},
        "first_step_vs_cpu": first,
        "ms_per_batch": ms, "ms_min_max": [min(times), max(times)],
        "twin_ms_per_batch": twin_ms,
        "launches_per_step": {"group": {lk.NAME_FWD: 0, lk.NAME_BWD: 0},
                              "twin": {lk.NAME_FWD: 2, lk.NAME_BWD: 2}},
        "losses": losses, "twin_losses": twin_losses[1:],
        "losses_vs_twin_rel_err_max": max(
            abs(a - b) / abs(b) for a, b in zip(losses, twin_losses[1:])),
        "lstm_vs_twin": lstm_twin, "gru_vs_twin": gru_twin,
        "hoist": hoist, "launches": launches})
    return {"train_lstm_group": launches}


# ---------------------------------------------------------------- item 1b
#
# The three phases of the rest of recurrence: DSL generation over a
# group, nested groups and mdlstmemory with the prev_batch_state carry.
# Each counts the LSTM (B9) and GRU (B10) kernels' launches of its gated
# runs (lstm_gru_counts), the counters reset just before each and read
# just after.

@contextlib.contextmanager
def beam_traced(trace):
    """Every ops/beam.beam_search call inside records its per-step trace
    into ``trace`` (the DSL's beam_search layer passes none)."""
    from paddle_tpu_torch.ops import beam as beam_ops
    real = beam_ops.beam_search
    beam_ops.beam_search = lambda *a, **kw: real(*a, trace=trace, **kw)
    try:
        yield trace
    finally:
        beam_ops.beam_search = real


def floor_readings(card, cpu, cpu64, tol, names):
    """Each of ``card`` (tensors) against ``cpu`` (the same on the CPU,
    float32) over a bound of ``tol`` of the CPU's largest entry plus
    FLOOR_TIMES its float32 noise (against ``cpu64``, the float64 run):
    the worst ratio to that bound, which a sound run keeps at most 1."""
    over, errs, floors = [], [], []
    for g, w, w64 in zip(card, cpu, cpu64):
        g, w = g.detach().cpu().double(), w.detach().double()
        err = float((g - w).abs().max())
        floor = float((w - w64.detach()).abs().max())
        errs.append(err / max(float(w.abs().max()), 1e-30))
        floors.append(floor)
        over.append(err / (tol * float(w.abs().max()) + FLOOR_TIMES * floor))
    worst = int(np.argmax(over))
    return {"err_over_bound_max": max(over), "of": names[worst],
            "rel_err_max": max(errs), "tolerance": tol,
            "float32_floor": {"times": FLOOR_TIMES, "largest": max(floors)}}


# seqtoseq_v1: models/seqtoseq_dsl, demo/seqToseq/v1's network in the DSL
# at train.conf's widths (dim 512 for the embedding, encoder and decoder,
# beam 3, max_length 250, error clipping 50, Adam lr 5e-4) over the wmt14
# loader's vocabularies (3000 / 3000), batch seqtoseq_dsl.BATCH = 48 (at
# train.conf's 50 the encoder GRUs take the scan in both packages; at 48
# B10 runs forward and backward every step).  Training through
# trainer.SGD: the first step against a CPU witness from the same weights
# (graph_first_step, V1_TOL with the float32 floors), V1_STEPS more steps
# with B10 2 + 2 launches each and nothing else counted, the last loss
# below the first.  Decoding: the trained parameters copied into the
# generation graph by name (the step layers' keys and
# _target_language_embedding shared by both graphs); V1_GEN_ROWS wmt14
# test sources decoded on the card (B10 forward once a direction) and on
# the CPU, held row by row up to each row's first near-tie
# (beam_agreement, BEAM_MARGIN; the CPU decodes the first V1_CPU_ROWS:
# rows are independent); every returned beam re-scored by the training
# graph's decoder_group teacher-forced on its tokens, the summed log-probs
# within BEAM_SCORE_RTOL of the beam's score.  A few steps teach the
# decoder eos's frequency and little else: its best beams end at once and
# every other candidate of its near-uniform softmax over 3000 words lies
# within BEAM_MARGIN of the next, so no step is compared.  The same decode
# therefore runs again from the start weights with the softmax's
# projection scaled by V1_SHARPEN, a confident decoder whose K-th and
# (K+1)-th candidates stand apart; greedy_generation of the same step
# there equals beam 1.
V1_TOL = 1e-4
V1_SHARPEN = 100.0
V1_STEPS = 6
V1_GEN_ROWS = 48
V1_CPU_ROWS = 8


def run_seqtoseq_v1(torch, dev, kernels):
    """seqtoseq_v1 (see V1_TOL); returns the B9 / B10 launches of its
    train and decode runs."""
    import itertools
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.core.sequence import SequenceBatch, pad_sequences
    from paddle_tpu_torch.data.datasets import wmt14
    from paddle_tpu_torch.layers.graph import value_data
    from paddle_tpu_torch.models import seqtoseq_dsl as sd
    from paddle_tpu_torch.utils.tree import tree_map
    data = list(sd.batches(V1_STEPS + 1)())
    feeding = sd.feeding()
    card, start, first, _ = graph_first_step(
        torch, dev, kernels, sd.build, sd.optimizer, feeding, data[0],
        "seqtoseq_v1", V1_TOL, floors=True)
    per_step = want_counts(kernels, gru_fwd=2, gru_bwd=2)
    first_launches = lstm_gru_counts(kernels)
    if first_launches != per_step:
        fail(f"seqtoseq_v1: the first step launched {first_launches}, "
             f"want {per_step}")
    times, losses, pass_launches = counted_pass(
        torch, kernels, card, data[1:], feeding, "seqtoseq_v1",
        [per_step] * V1_STEPS)
    losses = [first["loss"][0]] + losses
    if not losses[-1] < losses[0]:
        fail(f"seqtoseq_v1: the loss did not fall: {losses}")
    ms = float(np.median(times))
    trg_tokens = float(np.mean([sum(len(s[2]) for s in b)
                                for b in data[1:]]))

    # decoding with the trained weights, shared by name
    gen_topo = L.Topology(sd.build(True))
    gen_keys, train_keys = set(gen_topo.param_shapes()), set(card.parameters)
    decoder = next(n for n in card.topology.order
                   if n.name == "decoder_group")
    step_keys = set(decoder.cfg["sub_topo"].param_shapes())
    shared = step_keys | {"_target_language_embedding"}
    if not (gen_keys <= train_keys and shared <= gen_keys):
        fail(f"seqtoseq_v1: the generation graph's keys {sorted(gen_keys)} "
             f"do not share the training graph's step keys {sorted(shared)}")
    batch = list(itertools.islice(wmt14.test()(), V1_GEN_ROWS))

    def src(device, rows=V1_GEN_ROWS):
        return {"source_language_word": pad_sequences(
            [np.asarray(s[0], np.int32) for s in batch[:rows]],
            device=device)}

    def decode(topo, p, feed, trace=None):
        with beam_traced([] if trace is None else trace), torch.no_grad():
            return topo.apply(p, feed, mode="test")

    def rescore(p, res, rows):
        """Every beam's summed log-probs under the training graph's
        decoder_group, teacher-forced on its tokens up to its eos."""
        b, k, t = res.tokens.shape
        toks = res.tokens.reshape(b * k, t).long()
        n_tok = torch.clamp(res.lengths.reshape(-1).long() + 1, max=t)
        prev = torch.cat([torch.full_like(toks[:, :1], wmt14.START),
                          toks[:, :-1]], dim=1)
        with torch.no_grad():
            probs = value_data(L.Topology(decoder).apply(p, {
                "source_language_word": SequenceBatch(
                    rows.data.repeat_interleave(k, 0),
                    rows.lengths.repeat_interleave(k, 0)),
                "target_language_word": SequenceBatch(prev.int(),
                                                      n_tok.int())},
                mode="test"))
        lp = torch.log(torch.clamp(probs, min=1e-20)).gather(
            -1, toks[..., None])[..., 0]
        keep = torch.arange(t, device=lp.device)[None] < n_tok[:, None]
        return (lp * keep).sum(1).reshape(b, k)

    feed = src(dev)
    decodes, gen_launches = {}, None
    # the trained weights, and the start's with the softmax's projection
    # sharpened (see V1_SHARPEN)
    out_key = decoder.cfg["sub_topo"]._param_key(decoder.cfg["outs"][0])
    sharp = {**start, out_key: {n: t * V1_SHARPEN if n.startswith("w")
                                else t for n, t in start[out_key].items()}}
    for label, tree in (("trained", card.parameters), ("sharpened", sharp)):
        params = {k: {n: t.detach().to(dev) for n, t in tree[k].items()}
                  for k in gen_keys}
        decode(gen_topo, params, feed)                 # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        trace = []
        t0 = time.perf_counter()
        res = decode(gen_topo, params, feed, trace)
        torch.cuda.synchronize()
        ms_ = (time.perf_counter() - t0) * 1e3
        counts = lstm_gru_counts(kernels)
        if counts != want_counts(kernels, gru_fwd=2):
            fail(f"seqtoseq_v1: the decode launched {counts}, want B10's "
                 f"forward once a direction and nothing else")
        gen_launches = counts if gen_launches is None \
            else add_counts(gen_launches, counts)
        cpu_trace = []
        cpu_res = decode(gen_topo, tree_map(lambda t: t.cpu(), params),
                         src("cpu", V1_CPU_ROWS), cpu_trace)
        best = int(res.lengths[:, 0].sum())
        b, k, t = res.tokens.shape
        decodes[label] = {
            "ms": ms_, "best_beam_tokens": best,
            "best_beam_lengths_min_max": [int(res.lengths[:, 0].min()),
                                          int(res.lengths[:, 0].max())],
            "emitted_tokens_per_s": best / (ms_ / 1e3),
            "lane_steps_per_s": b * k * t / (ms_ / 1e3),
            "launches": counts,
            "vs_cpu": beam_agreement(
                f"seqtoseq_v1 decode ({label}) card vs CPU", cpu_res, res,
                cpu_trace, trace, V1_CPU_ROWS),
            "rescore_rel_err": rescore_check(
                torch, f"seqtoseq_v1 ({label})", res,
                rescore(params, res, feed["source_language_word"]))}

    # greedy_generation of the same step against beam 1, sharpened
    greedy_topo = L.Topology(sd.build(True, greedy=True))
    decode(greedy_topo, params, feed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = decode(greedy_topo, params, feed)
    torch.cuda.synchronize()
    greedy_ms = (time.perf_counter() - t0) * 1e3
    one = decode(L.Topology(sd.build(True, beam_size=1)), params, feed)
    if not (torch_equal(greedy.data, one.tokens[:, 0])
            and torch_equal(greedy.lengths, one.lengths[:, 0])):
        fail("seqtoseq_v1: greedy_generation differs from beam 1")
    emit({"phase": "seqtoseq_v1", "config": {
        "model": "models/seqtoseq_dsl (demo/seqToseq/v1 seqtoseq_net.py + "
                 "train.conf in the DSL: bi-GRU encoder, attention, "
                 "recurrent_group decoder / beam_search)",
        "dim": sd.DIM, "vocab": [wmt14.SRC_DICT_SIZE, wmt14.TRG_DICT_SIZE],
        "batch": sd.BATCH, "beam": sd.BEAM, "max_length": sd.MAX_LENGTH,
        "error_clipping": sd.ERROR_CLIPPING,
        "optimizer": "Adam lr 5e-4", "entry": "trainer.SGD.train; "
        "Topology.apply of the beam_search graph",
        "data": "data.datasets.wmt14 train / test (sources of 3-29 "
                "tokens)"},
        "first_step_vs_cpu": first,
        "ms_per_batch": ms, "ms_min_max": [min(times), max(times)],
        "target_tokens_per_batch": trg_tokens,
        "target_tokens_per_s": trg_tokens / (ms / 1e3),
        "losses": losses,
        "launches_per_step": per_step,
        "decode": {"rows": V1_GEN_ROWS, "cpu_rows": V1_CPU_ROWS,
                   "shared_keys": sorted(shared), **decodes,
                   "greedy_ms": greedy_ms, "greedy_equals_beam_1": True}})
    return {"train_seqtoseq_v1": add_counts(first_launches, pass_launches),
            "generate_seqtoseq_v1": gen_launches}


# nested_group: models/text_dsl's nested_group classifier on nested_a9f's
# data (imdb reviews as 1-8 sentences of <= 16 tokens, emb 128, hid 128,
# batch 64, Adam lr 0.002): an outer recurrent_group over
# SubsequenceInput(emb) whose step runs an fc of 4·128 and an lstmemory of
# 128 over the sentence (JAX's resident rule: B9 once an outer step,
# forward and backward), last_seq, an fc of 128 over [last, the outer
# memory].  The first step against the CPU (graph_first_step, NESTED_TOL
# with the float32 floors) and NG_STEPS more, each step's B9 launches
# exactly its batch's padded outer length, forward and backward; the
# mean loss of the pass's second half below its first half's.  Then the
# sequence_nest_rnn / sequence_rnn pair of tests/test_nested_rnn.py at
# width NG_PAIR_D: the nested group equals the flat one over the
# concatenated words, values within NG_VAL_TOL and gradients within
# NG_GRAD_TOL of each leaf's largest entry; the control (the inner memory
# not booted from the outer one) must fail that gate.
NG_STEPS = 9
NG_PAIR_D, NG_PAIR_B = 128, 16
NG_VAL_TOL, NG_GRAD_TOL = 1e-5, 1e-4


def nest_pair_graphs(L, d, booted):
    """(nested, flat): tests/test_nested_rnn.py's sequence_nest_rnn (the
    inner memory booted from the outer one unless not ``booted``) and
    sequence_rnn, sharing the fc "rnnfc"."""
    L.reset_names()
    x = L.data_layer("x", size=d, is_seq=True)

    def outer_step(subseq):
        outer_mem = L.memory(name="outer_state", size=d)

        def inner_step(y):
            inner_mem = L.memory(name="inner_state", size=d,
                                 boot_layer=outer_mem if booted else None)
            return L.fc_layer([y, inner_mem], size=d, act="tanh",
                              name="inner_state",
                              param_attr={"name": "rnnfc"})

        return L.last_seq(L.recurrent_group(inner_step, subseq),
                          name="outer_state")

    nested = L.Topology(L.recurrent_group(outer_step, L.SubsequenceInput(x)))
    L.reset_names()
    xf = L.data_layer("x", size=d, is_seq=True)

    def step(y):
        mem = L.memory(name="state", size=d)
        return L.fc_layer([y, mem], size=d, act="tanh", name="state",
                          param_attr={"name": "rnnfc"})

    return nested, L.Topology(L.recurrent_group(step, xf))


def nest_pair_check(torch, dev, seed, booted):
    """The nested group against the flat one on the card: (the values'
    error at every sub-sequence end, the gradients' worst error), each
    against its largest entry."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.core.sequence import (pad_nested_sequences,
                                                pad_sequences)
    from paddle_tpu_torch.layers.graph import value_data
    rng = np.random.RandomState(seed)
    subs = [[rng.randn(int(n), NG_PAIR_D).astype(np.float32)
             for n in rng.randint(1, 17, size=int(s))]
            for s in rng.randint(1, 9, size=NG_PAIR_B)]
    nested, flat = nest_pair_graphs(L, NG_PAIR_D, booted)
    params = flat.init(torch.Generator().manual_seed(seed), device=dev)
    outs, grads = [], []
    for topo, feed in (
            (nested, pad_nested_sequences(subs, device=dev)),
            (flat, pad_sequences([np.concatenate(s) for s in subs],
                                 device=dev))):
        p = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
             for k, v in params.items()}
        out = topo.apply(p, {"x": feed}, mode="test")
        d = value_data(out)
        fin = d[torch.arange(d.shape[0], device=d.device),
                out.lengths.long() - 1]
        torch.sum(fin ** 2).backward()
        outs.append(d.detach().cpu())
        grads.append([t.grad.detach().cpu()
                      for _, t in sorted(p["rnnfc"].items())])
    dn, df = outs
    ends = [np.cumsum([len(x) for x in s]) - 1 for s in subs]
    got = torch.stack([dn[b, j] for b, e in enumerate(ends)
                       for j in range(len(e))])
    want = torch.stack([df[b, int(x)] for b, e in enumerate(ends)
                        for x in e])
    return largest_err([got], [want])[0], max(largest_err(*grads))


def run_nested_group(torch, dev, kernels, seed):
    """nested_group (see NG_STEPS); returns the B9 launches of its
    train pass."""
    from paddle_tpu_torch.models import text_dsl
    cfg = text_dsl.config("nested_group", n_batches=NG_STEPS + 1)
    data, feeding = list(cfg["train_reader"]()), cfg["feeding"]

    def want(batch):
        s = max(len(subs) for subs, _ in batch)
        return want_counts(kernels, lstm_fwd=s, lstm_bwd=s)

    card, _, first, _ = graph_first_step(
        torch, dev, kernels, lambda: text_dsl.build("nested_group")[0],
        lambda: text_dsl.optimizer("nested_group"), feeding, data[0],
        "nested_group", NESTED_TOL, floors=True)
    first_launches = lstm_gru_counts(kernels)
    if first_launches != want(data[0]):
        fail(f"nested_group: the first step launched {first_launches}, want "
             f"{want(data[0])}")
    times, losses, pass_launches = counted_pass(
        torch, kernels, card, data[1:], feeding, "nested_group",
        [want(b) for b in data[1:]])
    losses = [first["loss"][0]] + losses
    half = len(losses) // 2
    if not np.mean(losses[half:]) < np.mean(losses[:half]):
        fail(f"nested_group: the loss did not fall: {losses}")
    val, grad = nest_pair_check(torch, dev, seed, booted=True)
    ctl = nest_pair_check(torch, dev, seed, booted=False)
    pair = {"values_rel_err": val, "grads_rel_err": grad,
            "limits": [NG_VAL_TOL, NG_GRAD_TOL],
            "control": {"what": "the inner memory not booted from the outer "
                                "one", "values_rel_err": ctl[0],
                        "grads_rel_err": ctl[1]},
            "width": NG_PAIR_D, "batch": NG_PAIR_B}
    if not (val <= NG_VAL_TOL and grad <= NG_GRAD_TOL):
        fail(f"nested_group: nested differs from flat: {pair}")
    if ctl[0] <= NG_VAL_TOL and ctl[1] <= NG_GRAD_TOL:
        fail(f"nested_group: the control passes the nested = flat gate: "
             f"{pair}")
    outer = [max(len(s) for s, _ in b) for b in data]
    ms = float(np.median(times))
    emit({"phase": "nested_group", "config": {
        "model": "models/text_dsl nested_group (recurrent_group over "
                 "SubsequenceInput(emb): fc 4·128, lstmemory 128, last_seq, "
                 "fc 128 over [last, outer memory])",
        "batch": text_dsl.BATCH, "sub_len": text_dsl.SUB_LEN,
        "max_subs": text_dsl.MAX_SUBS, "emb": 128, "hid": 128,
        "optimizer": "Adam lr 0.002", "entry": "trainer.SGD.train",
        "data": "data.datasets.imdb train as sentences (nested_a9f's)"},
        "first_step_vs_cpu": first, "padded_outer_lengths": outer,
        "ms_per_batch": ms, "ms_min_max": [min(times), max(times)],
        "samples_per_s": text_dsl.BATCH / (ms / 1e3),
        "losses": losses, "launches_rule": "B9 forward and backward once "
        "per padded outer step", "nest_equals_flat": pair})
    return {"nested_group": add_counts(first_launches, pass_launches)}


# recurrence_1b: mdlstmemory at B MD_B, MD_H x MD_W, D MD_D, forward and
# backward on the card against the CPU (MD_TOL of each leaf's largest
# entry plus FLOOR_TIMES its float32 noise, a float64 CPU run), timed.
# The control, the card's run with the five peepholes zeroed, must fail
# that gate.  The prev_batch_state carry: lstmemory of CARRY_D at B CARRY_B, T
# CARRY_T, split into two halves; the carried halves equal one unbroken
# run within CARRY_TOL of its largest entry (the unbroken run and the
# first half take B9, the second half, with a carried init_state, the
# masked scan: 0 launches), and the same halves without the carry must
# fail that gate; then CARRY_STEPS SGD steps of a carried classifier: the
# carried state requires no gradient, B9 1 + 1 on the first step and 0
# after, and the last step's time within CARRY_GROWTH of the second's
# (a carry chained into autograd would re-run every earlier batch's
# backward); the halves again for grumemory (B10 on the first half).
MD_B, MD_H, MD_W, MD_D = 16, 16, 16, 64
# the DSL train phases' relative gate (GROUP_TOL, SENT_TOL): at 1e-5 the
# bias gradient (a sum over B·H·W cells of a 256-cell chain) read 0.95 of
# its bound on an H100, card and CPU both float32 (PERF.md §6)
MD_TOL = 2e-5
CARRY_B, CARRY_T, CARRY_D = 64, 100, 512
CARRY_TOL = 1e-5
CARRY_STEPS = 3
CARRY_GROWTH = 1.8
CARRY_VOCAB = 1000


def md_check(torch, dev, seed):
    """mdlstmemory on the card and on the CPU from the same weights."""
    from paddle_tpu_torch import layers as L
    L.reset_names()
    node = L.mdlstmemory(L.data_layer("img", size=5 * MD_D * MD_H * MD_W,
                                      height=MD_H, width=MD_W), size=MD_D)
    topo = L.Topology(node)
    gen = torch.Generator().manual_seed(seed)
    params = topo.init(gen, device="cpu")
    # the zero bias and peepholes carry weight
    params[node.name]["b"] = 0.1 * torch.randn(10 * MD_D, generator=gen)
    x = torch.randn(MD_B, 5 * MD_D * MD_H * MD_W, generator=gen)
    cot = torch.cos(0.37 * torch.arange(node.size, dtype=torch.float64))
    names = ["out", "d_img"] + [f"d_{n}" for n in sorted(params[node.name])]

    def run(device, dtype, peepholes=True):
        p = {node.name: {n: t.detach().to(device, dtype).requires_grad_(True)
                         for n, t in params[node.name].items()}}
        if not peepholes:
            with torch.no_grad():
                p[node.name]["b"][5 * MD_D:] = 0.0
        xx = x.detach().to(device, dtype).requires_grad_(True)
        out = topo.apply(p, {"img": xx}, mode="test")
        torch.sum(out * cot.to(device, dtype)).backward()
        return [out, xx.grad] + [p[node.name][n].grad
                                 for n in sorted(p[node.name])]

    card = run(dev, torch.float32)
    reps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(dev, torch.float32)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    cpu, cpu64 = run("cpu", torch.float32), run("cpu", torch.float64)
    out = {"shape": {"B": MD_B, "H": MD_H, "W": MD_W, "D": MD_D},
           "fwd_bwd_ms": float(np.median(reps)), "fwd_bwd_ms_all": reps,
           **floor_readings(card, cpu, cpu64, MD_TOL, names),
           "control": {"what": "the card's run with the peepholes zeroed",
                       **floor_readings(run(dev, torch.float32, False), cpu,
                                        cpu64, MD_TOL, names)}}
    if not out["err_over_bound_max"] <= 1.0:
        fail(f"recurrence_1b: mdlstmemory on the card against the CPU {out}")
    if out["control"]["err_over_bound_max"] <= 1.0:
        fail(f"recurrence_1b: the mdlstmemory control passes: {out}")
    return out


def carry_halves(torch, dev, kernels, cell, seed):
    """``cell`` ("lstm" / "gru") of CARRY_D carried over two halves
    against one unbroken run, and the control without the carry."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.layers.graph import value_data
    ctor, width = ((L.lstmemory, 4 * CARRY_D) if cell == "lstm"
                   else (L.grumemory, 3 * CARRY_D))

    def graph(carry):
        L.reset_names()
        return L.Topology(ctor(L.data_layer("x", size=width, is_seq=True),
                               size=CARRY_D, prev_batch_state=carry,
                               name="carried"))

    carried, plain = graph(True), graph(False)
    params = carried.init(torch.Generator().manual_seed(seed), device=dev)
    gen = torch.Generator().manual_seed(seed + 1)
    full = torch.randn(CARRY_B, CARRY_T, width, generator=gen).to(dev)
    mid = CARRY_T // 2

    def seq(lo, hi):
        return {"x": SequenceBatch(full[:, lo:hi], torch.full(
            (CARRY_B,), hi - lo, dtype=torch.int32, device=dev))}

    def counted(topo, feed, state=None):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with torch.no_grad():
            out, st = topo.apply(params, feed, mode="test", state=state,
                                 return_state=True)
        torch.cuda.synchronize()
        return value_data(out), st, lstm_gru_counts(kernels)

    ref, _, unbroken = counted(carried, seq(0, CARRY_T))
    h0, st, first = counted(carried, seq(0, mid))
    h1, _, second = counted(carried, seq(mid, CARRY_T), st)
    c0, _, _ = counted(plain, seq(0, mid))
    c1, _, _ = counted(plain, seq(mid, CARRY_T))
    err = largest_err([torch.cat([h0, h1], 1)], [ref])[0]
    ctl = largest_err([torch.cat([c0, c1], 1)], [ref])[0]
    one = want_counts(kernels, **{f"{cell}_fwd": 1})
    out = {"cell": cell, "halves_vs_unbroken_rel_err": err,
           "control_without_carry_rel_err": ctl, "limit": CARRY_TOL,
           "launches": {"unbroken": unbroken, "first_half": first,
                        "second_half": second}}
    if not err <= CARRY_TOL:
        fail(f"recurrence_1b: carried halves differ from one run: {out}")
    if ctl <= CARRY_TOL:
        fail(f"recurrence_1b: the halves without the carry pass: {out}")
    if (unbroken, first, second) != (one, one, want_counts(kernels)):
        fail(f"recurrence_1b: {cell} launches {out['launches']}, want the "
             f"kernel forward on the unbroken run and the first half, none "
             f"on the carried second half")
    return out, add_counts(unbroken, first, second)


def carry_sgd(torch, dev, kernels, seed):
    """CARRY_STEPS SGD steps of a carried classifier (embedding 128, fc
    4·CARRY_D, lstmemory CARRY_D with prev_batch_state, last_seq, fc 2
    softmax) on seeded id batches."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch import optim
    from paddle_tpu_torch.data.provider import (integer_value,
                                                integer_value_sequence)
    from paddle_tpu_torch.trainer import SGD
    L.reset_names()
    w = L.data_layer("w", size=CARRY_VOCAB, is_seq=True)
    x4 = L.fc_layer(L.embedding_layer(w, size=128), size=4 * CARRY_D,
                    act=None, bias_attr=False)
    h = L.lstmemory(x4, size=CARRY_D, prev_batch_state=True, name="carried")
    cost = L.classification_cost(
        L.fc_layer(L.last_seq(h), size=2, act="softmax"),
        L.data_layer("lab", size=1))
    rng = np.random.RandomState(seed)
    data = [[(rng.randint(0, CARRY_VOCAB, CARRY_T).tolist(),
              int(rng.randint(2))) for _ in range(CARRY_B)]
            for _ in range(CARRY_STEPS)]
    trainer = SGD(cost, update_equation=optim.Adam(learning_rate=1e-3),
                  device=dev)
    first = want_counts(kernels, lstm_fwd=1, lstm_bwd=1)
    times, losses, launches = counted_pass(
        torch, kernels, trainer, data,
        {"w": integer_value_sequence(CARRY_VOCAB), "lab": integer_value(2)},
        "recurrence_1b carried SGD",
        [first] + [want_counts(kernels)] * (CARRY_STEPS - 1))
    carry = trainer.model_state["carried/carry"]
    out = {"ms": times, "losses": losses,
           "carry_shape": list(carry.shape),
           "carry_requires_grad": carry.requires_grad,
           "carry_has_grad_fn": carry.grad_fn is not None,
           "growth_limit": CARRY_GROWTH}
    if carry.requires_grad or carry.grad_fn is not None \
            or tuple(carry.shape) != (CARRY_B, 2 * CARRY_D):
        fail(f"recurrence_1b: the carried state {out}")
    if not times[-1] <= CARRY_GROWTH * times[1]:
        fail(f"recurrence_1b: the step time grows across carried steps: "
             f"{out}")
    return out, launches


def run_recurrence_1b(torch, dev, kernels, seed):
    """recurrence_1b (see MD_TOL); returns the B9 / B10 launches of its
    carried runs."""
    md = md_check(torch, dev, seed)
    lstm, lstm_n = carry_halves(torch, dev, kernels, "lstm", seed + 1)
    sgd, sgd_n = carry_sgd(torch, dev, kernels, seed + 2)
    gru, gru_n = carry_halves(torch, dev, kernels, "gru", seed + 3)
    emit({"phase": "recurrence_1b", "mdlstmemory": md,
          "carry": {"shape": {"B": CARRY_B, "T": CARRY_T, "D": CARRY_D,
                              "halves": [CARRY_T // 2] * 2},
                    "lstm": lstm, "sgd_steps": sgd, "gru": gru}})
    return {"recurrence_1b": add_counts(lstm_n, sgd_n, gru_n)}


# demos_a14: the four demos with no earlier port config, each at its own
# widths on the card (models/traffic_dsl, moe_dsl, gan_dsl, lm_demo):
# - the first step on the card against the same step on the CPU from the
#   same weights (loss and every gradient leaf within DEMO_TOL of its
#   largest entry), which the same card step with cuBLAS's TF32 products
#   on must fail (first_step_gate);
# - then the demo's own run through its own entry: traffic one pass of
#   SGD.train (66 batches of 128), moe its 4 passes (256 steps) then its
#   quadrant accuracy on 512 fresh points (at least MOE_ACC_MIN; the
#   untrained start must fall short), gan its 400 alternating Adam steps
#   then the mean radius of 256 generated points (within GAN_RADIUS_TOL
#   of 1; the untrained generator must miss), lm its 12 epochs of packed
#   rows then greedy lm_generate from "cat " and "bird " equal to a CPU
#   run on the card's trained weights up to the first top-1 / top-2
#   margin below MARGIN_TOL, the greedy text a sentence of the grammar,
#   and sampled continuations (temperature 0.7, top 8) in the vocab;
# - ms/step of each; no counted kernel launches in training (lm's
#   packed rows take the dense masked attention, as JAX's route does);
#   lm_generate launches the flash forward once a layer a call (the
#   prompt's prefill), counted into the kernel rows, and no decode
#   kernel: its per-token steps (lm_decode_step) attend by the masked
#   plain path, as JAX's lm_decode_step does.
DEMO_TOL = 2e-5
# the demos' own lengths: moe's passes, gan's steps, lm's epochs
MOE_PASSES, GAN_STEPS, LM_EPOCHS = 4, 400, 12
MOE_ACC_MIN = 0.9
GAN_RADIUS_TOL = 0.25
TF32_CONTROL = "the same card step with cuBLAS's TF32 products on"


def first_step_gate(torch, dev, what, step, tol=DEMO_TOL):
    """``step(device, ctx)`` -> (loss, [gradient leaves on the host]) of
    one step from fixed weights: the card's against the CPU's within
    ``tol``, the TF32 control failing it (gate_first_step)."""
    cpu = step("cpu", None)
    card = step(dev, None)
    control = step(dev, lambda: cublas_tf32(torch))
    return gate_first_step(what, card, cpu, tol,
                           control=(TF32_CONTROL, control))


def sgd_step_fn(torch, build, optimizer, feeding, batch):
    """first_step_gate's step for a DSL cost through SGD (its seed's
    weights, drawn on the CPU); the TF32 context enters after the feed
    (device.resolve turns TF32 off)."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves
    start = host_tree(SGD(cost=build(), update_equation=optimizer(),
                          device="cpu").parameters)

    def step(device, ctx):
        tr = SGD(cost=build(), parameters=start,
                 update_equation=optimizer(), device=device)
        feed = DataFeeder(feeding, device=tr.device)(batch)
        with (ctx or contextlib.nullcontext)():
            total, _ = tr._forward(feed)
            tr._backward(total)
        return float(total.detach()), [p.grad.detach().cpu()
                                       for p in tree_leaves(tr._view)]
    return step


def timed_sgd_pass(torch, trainer, reader, feeding, passes=1):
    """SGD.train over ``passes`` passes: (ms a step, feed included; the
    costs of the steps)."""
    costs = []

    def handler(e):
        from paddle_tpu_torch.trainer import events
        if isinstance(e, events.EndIteration):
            costs.append(e.cost)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(reader, num_passes=passes, feeding=feeding, log_period=0,
                  event_handler=handler)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(costs)
    return ms, [float(c) for c in costs]


def check_falls(what, losses, k=8):
    if not (all(math.isfinite(x) for x in losses)
            and np.mean(losses[-k:]) < np.mean(losses[:k])):
        fail(f"{what}: the loss must be finite and fall: {losses}")


def run_demo_traffic(torch, dev, kernels):
    from paddle_tpu_torch.models import traffic_dsl as td
    from paddle_tpu_torch.trainer import SGD
    batch = next(iter(td.train_reader()()))
    first = first_step_gate(torch, dev, "demos_a14 traffic", sgd_step_fn(
        torch, lambda: td.build()[0], td.optimizer, td.feeding(), batch))
    cfg = td.config()
    tr = SGD(cost=cfg["cost"], update_equation=cfg["optimizer"], device=dev)
    kernels.reset_launches()
    ms, losses = timed_sgd_pass(torch, tr, cfg["train_reader"],
                                cfg["feeding"])
    check_falls("demos_a14 traffic", losses)
    return {"config": {"heads": td.FORECASTING_NUM, "window": td.TERM_NUM,
                       "emb": td.EMB_SIZE, "buckets": td.LABEL_VALUE_NUM,
                       "batch": td.BATCH, "optimizer": "RMSProp lr 1e-3",
                       "entry": "SGD.train, one pass"},
            "first_step_vs_cpu": first, "steps": len(losses),
            "ms_per_step": ms, "loss_first_last": [losses[0], losses[-1]],
            "counted_launches": sum(launch_counts(kernels).values())
            + recurrent_launches(kernels)}


def run_demo_moe(torch, dev, kernels):
    from paddle_tpu_torch.models import moe_dsl as md
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_map
    batch = next(iter(md.train_reader()()))
    first = first_step_gate(torch, dev, "demos_a14 moe", sgd_step_fn(
        torch, lambda: md.build()[0], md.optimizer, md.feeding(), batch))
    cfg = md.config()
    tr = SGD(cost=cfg["cost"], update_equation=cfg["optimizer"], device=dev)
    start = tree_map(lambda t: t.detach().clone(), tr.parameters)
    kernels.reset_launches()
    ms, losses = timed_sgd_pass(torch, tr, cfg["train_reader"],
                                cfg["feeding"], passes=MOE_PASSES)
    check_falls("demos_a14 moe", losses)
    acc = md.quadrant_accuracy(cfg["output"], tr.parameters)
    control = md.quadrant_accuracy(cfg["output"], start)
    out = {"config": {"experts": 4, "top_k": 2, "expert_dim": 64,
                      "batch": md.BATCH, "optimizer": "Adam lr 0.01",
                      "entry": f"SGD.train, {MOE_PASSES} passes"},
           "first_step_vs_cpu": first, "steps": len(losses),
           "ms_per_step": ms, "loss_first_last": [losses[0], losses[-1]],
           "quadrant_accuracy": {"trained": acc, "limit": MOE_ACC_MIN,
                                 "control_untrained": control},
           "counted_launches": sum(launch_counts(kernels).values())
           + recurrent_launches(kernels)}
    if not acc >= MOE_ACC_MIN > control:
        fail(f"demos_a14 moe: the quadrant accuracy must reach "
             f"{MOE_ACC_MIN} and the untrained control fall short: {out}")
    return out


def run_demo_gan(torch, dev, kernels):
    from paddle_tpu_torch.models import gan_dsl as gd
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map, \
        value_and_grad
    g_topo, d_topo, _, _ = gd.build()
    gen = torch.Generator().manual_seed(0)
    start = (g_topo.init(gen, device="cpu"), d_topo.init(gen, device="cpu"))

    def step(device, ctx):
        gan = gd.Gan(*(tree_map(lambda t: t.clone().to(device), p)
                       for p in start))
        rng = np.random.RandomState(0)
        z = torch.as_tensor(rng.randn(gd.BATCH, gd.Z).astype(np.float32),
                            device=device)
        real = torch.as_tensor(gd.real_batch(rng), device=device)
        with (ctx or contextlib.nullcontext)():
            dl, dg = value_and_grad(
                lambda p: gan.d_loss(p, gan.g_params, z, real), gan.d_params)
            gl, gg = value_and_grad(
                lambda p: gan.g_loss(p, gan.d_params, z), gan.g_params)
        return (float(dl) + float(gl),
                [x.detach().cpu() for x in tree_leaves(dg) + tree_leaves(gg)])

    first = first_step_gate(torch, dev, "demos_a14 gan", step)
    gan = gd.Gan(*(tree_map(lambda t: t.clone().to(dev), p) for p in start))
    rng = np.random.RandomState(0)
    control = float(gan.radii(np.random.RandomState(5)).mean())
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [tuple(float(x) for x in gan.step(rng))
              for _ in range(GAN_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    radii = gan.radii(rng)
    out = {"config": {"z": gd.Z, "hidden": gd.H, "batch": gd.BATCH,
                      "optimizer": "Adam lr 2e-3 (both)",
                      "entry": f"gan_dsl.Gan.step (d then g), {GAN_STEPS} "
                               "steps"},
           "first_step_vs_cpu": first, "steps": len(losses),
           "ms_per_step": ms, "d_g_loss_last": list(losses[-1]),
           "radius_mean": {"trained": float(radii.mean()),
                           "std": float(radii.std()), "target": 1.0,
                           "limit": GAN_RADIUS_TOL,
                           "control_untrained": control},
           "counted_launches": sum(launch_counts(kernels).values())
           + recurrent_launches(kernels)}
    if not (all(math.isfinite(x) for pair in losses for x in pair)
            and abs(radii.mean() - 1) <= GAN_RADIUS_TOL
            < abs(control - 1)):
        fail(f"demos_a14 gan: the radius mean must land within "
             f"{GAN_RADIUS_TOL} of 1 and the untrained control miss: {out}")
    return out


LM_SENTENCE = r"^(cat|dog|bird) (sees|likes) (fish|seed|bone)\."


def run_demo_lm(torch, dev, kernels):
    import re
    from paddle_tpu_torch.models import lm_demo as lm
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.utils.tree import tree_leaves, tree_map, \
        value_and_grad
    start = host_tree(lm.init(seed=0, device="cpu"))
    batches = lm.packed_batches()
    first_rows = next(iter(batches()))

    def step(device, ctx):
        p = tree_map(lambda t: t.clone().to(device), start)
        data, seg, pos = (torch.as_tensor(a, device=device)
                          for a in lm.stack(first_rows))
        with (ctx or contextlib.nullcontext)():
            value, g = value_and_grad(lambda q: lm.loss(q, data, seg, pos), p)
        return float(value), [x.detach().cpu() for x in tree_leaves(g)]

    first = first_step_gate(torch, dev, "demos_a14 lm", step)
    tr = lm.Trainer(tree_map(lambda t: t.clone().to(dev), start))
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(tr.step(rows)) for _ in range(LM_EPOCHS)
              for rows in batches()]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    train_launches = sum(launch_counts(kernels).values())
    check_falls("demos_a14 lm", losses)
    trained_cpu = host_tree(tr.params)
    kernels.reset_launches()
    samples = {}
    gen = torch.Generator(device=dev).manual_seed(7)
    for prompt_txt in lm.PROMPTS:
        greedy = lm.generate(tr.params, prompt_txt)
        sampled = lm.generate(tr.params, prompt_txt, gen)
        samples[prompt_txt] = (greedy, sampled)
    torch.cuda.synchronize()
    gen_launches = launch_counts(kernels)
    compared = {}
    for prompt_txt, (greedy, sampled) in samples.items():
        tp = lm.encode_prompt(prompt_txt).shape[1]
        ref = lm.generate(trained_cpu, prompt_txt)
        marg = margins(torch, transformer, trained_cpu,
                       torch.as_tensor(ref[None]), heads=lm.HEADS)[0]
        n, ok = compare(greedy[tp:].tolist(), ref[tp:].tolist(),
                        marg[tp - 1:])
        text = lm.decode(greedy)
        compared[prompt_txt] = {"greedy": text,
                                "sampled": lm.decode(sampled),
                                "tokens_compared_vs_cpu": n}
        if not ok or n < 1:
            fail(f"demos_a14 lm: greedy {prompt_txt!r} on the card "
                 f"{greedy.tolist()} against the CPU {ref.tolist()}")
        if not re.match(LM_SENTENCE, text) or not (
                0 <= sampled.min() and sampled.max() < lm.VOCAB):
            fail(f"demos_a14 lm: {prompt_txt!r} -> {compared[prompt_txt]}")
    launches = {key: n for key, n in gen_launches.items() if n}
    out = {"config": {"d_model": lm.D_MODEL, "dff": lm.DFF,
                      "layers": lm.LAYERS, "heads": lm.HEADS,
                      "max_len": lm.MAX_LEN, "batch": lm.BATCH,
                      "vocab": lm.VOCAB, "optimizer": "Adam lr 3e-3",
                      "entry": "lm_demo.Trainer.step (lm_loss on packed "
                               f"rows), {LM_EPOCHS} epochs; lm_generate"},
           "first_step_vs_cpu": first, "steps": len(losses),
           "ms_per_step": ms, "loss_first_last": [losses[0], losses[-1]],
           "train_counted_launches": train_launches,
           "generate": compared, "margin_tolerance": MARGIN_TOL,
           "generate_launches": launches,
           "want_launches": {"flash_attention": 4 * lm.LAYERS}}
    if train_launches or launches != out["want_launches"]:
        fail(f"demos_a14 lm: kernel launches {out}")
    return out


def run_demos_a14(torch, dev, kernels):
    """demos_a14 (see DEMO_TOL); returns lm_generate's launches."""
    t0 = time.perf_counter()
    demos = {"traffic_prediction": run_demo_traffic(torch, dev, kernels),
             "moe": run_demo_moe(torch, dev, kernels),
             "gan": run_demo_gan(torch, dev, kernels)}
    for name, d in demos.items():
        if d["counted_launches"]:
            fail(f"demos_a14 {name}: counted kernel launches {d}")
    demos["lm"] = run_demo_lm(torch, dev, kernels)
    emit({"phase": "demos_a14", "tolerance": DEMO_TOL,
          "control": TF32_CONTROL, **demos,
          "seconds": time.perf_counter() - t0})
    return demos["lm"]["generate_launches"]


# host_a5: utils/flags, obs/trace and resilience/faults on the card.
# - The full-width LM served (slab, chunked K 8: the chunk kernel B1)
#   twice over HTTP, 12 staggered requests of 32 tokens, every third
#   carrying a traceparent: tracing off, then on at sample 1.0 through
#   FLAGS (trainer.api.init + FLAGS.apply()).  The tokens bit for bit
#   the same; no span recorded off; on, the span structure (each span's
#   name, its parent's name, its attribute keys) equal to the same
#   requests served on the CPU by a narrow trunk (the structure does not
#   depend on the widths); the response's X-Trace-Id continuing the
#   incoming trace; the chunk kernel LAYERS a step in both runs; the
#   step wall (TPOT) of both printed.
# - Fault plans through FLAGS (resilience_fault_spec), no supervisor, the
#   first four prompts one after another: serving.decode_step:at=
#   A5_DECODE_FAULT_AT on the chunked engine and serving.prefill:at=2 on
#   the ladder (buckets 32 / 64: the flash prefill B3 and the Tq=1 step
#   B2) end the same requests with the same error as on the CPU, and
#   every other request streams the tokens of a clean run bit for bit
#   (the chunked ones: the traced run's); fault_injections_total on
#   /metrics; no span left active.
# - trainer.step:at=5 on models/traffic_dsl (3 batches a pass, 2
#   passes, checkpoints), then train(resume=True): parameters bit for
#   bit an uninterrupted run on the card.
# - FLAGS drives `python -m paddle_tpu_torch train`'s --prefetch default
#   (cli.main in this process): prefetch_depth 3 when async_load_data,
#   0 when not, an explicit --prefetch over both.
A5_DECODE_FAULT_AT = 40
A5_CPU_TRUNK = dict(d_model=32, num_heads=2, dff=64, layers=2)


def span_structure(spans):
    """The multiset of (name, parent span's name, attribute keys)."""
    import collections
    names = {s["span_id"]: s["name"] for s in spans}
    return collections.Counter(
        (s["name"], names.get(s["parent_id"]), tuple(sorted(s["attrs"])))
        for s in spans)


def finished_spans(n_requests):
    from paddle_tpu_torch.obs import trace
    deadline = time.time() + 60
    while time.time() < deadline:
        spans = trace.snapshot(include_active=False)
        if sum(s["name"] == "server.request" for s in spans) >= n_requests:
            return spans
        time.sleep(0.01)
    fail("host_a5: the request spans did not end")


def a5_engine(params, device, heads, chunk=CHUNK, metrics=None):
    from paddle_tpu_torch.serving import DecodeEngine
    return DecodeEngine(params, num_heads=heads, num_slots=SLOTS,
                        max_len=SERVE_MAX_LEN, prefill_chunk=chunk,
                        metrics=metrics, name="base_lm", device=device)


def a5_cpu_params(torch, seed):
    from paddle_tpu_torch.models import transformer
    t = A5_CPU_TRUNK
    return transformer.init_lm(torch.Generator().manual_seed(seed), VOCAB,
                               t["d_model"], t["num_heads"], t["dff"],
                               t["layers"], SERVE_MAX_LEN, device="cpu")


def sequential_outcomes(engine, prompts, n_tok, spec):
    """The prompts one after another through a fresh batcher with the
    fault plan ``spec`` installed through FLAGS: per request ("ok",
    streamed tokens) or its error's kind; and the fires by point."""
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import BatchExecutionError, \
        GenerationBatcher
    from paddle_tpu_torch.trainer import api
    from paddle_tpu_torch.utils.flags import FLAGS
    bat = GenerationBatcher(engine)
    api.init(resilience_fault_spec=spec)
    FLAGS.apply()
    out = []
    try:
        for prompt in prompts:
            toks = []
            try:
                fut = bat.submit(prompt, max_tokens=n_tok,
                                 on_token=toks.append)
                fut.result(300)
                out.append(("ok", toks))
            except (BatchExecutionError, faults.InjectedFault) as e:
                out.append(type(e).__name__)
        fired = faults.fired_counts()
        metrics_text = engine.metrics.render_prometheus()
    finally:
        api.init(resilience_fault_spec="")
        faults.clear()
        bat.close()
    return out, fired, metrics_text


def a5_faults(torch, dev, kernels, params, cpu_params, prompts, clean):
    """The unsupervised fault runs on the card and on the CPU."""
    from paddle_tpu_torch.serving import ServingMetrics
    n_tok = 32
    out, launches = {}, {}
    for name, spec, chunk in (
            ("decode_step", f"serving.decode_step:at={A5_DECODE_FAULT_AT}",
             CHUNK),
            ("prefill", "serving.prefill:at=2", 0)):
        metrics = ServingMetrics()
        if chunk:
            ref = clean
        else:
            ref_eng = a5_engine(params, dev, HEADS, chunk)
            ref = [o[1] for o in sequential_outcomes(ref_eng, prompts,
                                                     n_tok, "")[0]]
        kernels.reset_launches()
        card, fired, text = sequential_outcomes(
            a5_engine(params, dev, HEADS, chunk, metrics), prompts, n_tok,
            spec)
        torch.cuda.synchronize()
        launches[name] = launch_counts(kernels)
        cpu, cpu_fired, _ = sequential_outcomes(
            a5_engine(cpu_params, "cpu", A5_CPU_TRUNK["num_heads"], chunk),
            prompts, n_tok, spec)
        ended = [i for i, o in enumerate(card) if isinstance(o, str)]
        row = {"spec": spec, "chunk": chunk,
               "ended": {i: card[i] for i in ended},
               "ended_on_cpu": {i: o for i, o in enumerate(cpu)
                                if isinstance(o, str)},
               "fired": fired,
               "others_bit_for_bit_clean": all(
                   card[i][1] == ref[i] for i in range(len(prompts))
                   if i not in ended)}
        point = spec.split(":")[0]
        line = f'fault_injections_total{{point="{point}"}} 1'
        row["metrics_line"] = line in text
        out[name] = row
        if not (0 < len(ended) < len(prompts)
                and row["ended"] == row["ended_on_cpu"]
                and fired == cpu_fired == {point: 1}
                and row["others_bit_for_bit_clean"] and row["metrics_line"]):
            fail(f"host_a5: fault {spec} on the card against the CPU: {row}")
    if not launches["prefill"]["flash_attention"] \
            or not launches["prefill"]["decode_attention_slab"]:
        fail(f"host_a5: the ladder's fault run launched {launches}")
    return out, launches


def a5_trainer_resume(torch, dev, tmp):
    """trainer.step:at=5 then train(resume=True), bit for bit."""
    import os
    from paddle_tpu_torch.models import traffic_dsl as td
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves

    def trainer():
        cfg = td.config(n_batches=3)
        return SGD(cost=cfg["cost"], update_equation=cfg["optimizer"],
                   seed=7, device=dev), cfg

    sd = os.path.join(tmp, "ckpt")
    kw = dict(num_passes=2, log_period=0, buffered_batches=0)
    t1, cfg = trainer()
    faults.install_spec("trainer.step:at=5")
    try:
        t1.train(cfg["train_reader"], feeding=cfg["feeding"], save_dir=sd,
                 **kw)
        raised = False
    except faults.InjectedFault:
        raised = True
    finally:
        faults.clear()
    passes = sorted(d for d in os.listdir(sd) if d.startswith("pass-"))
    t2, cfg = trainer()
    t2.train(cfg["train_reader"], feeding=cfg["feeding"], save_dir=sd,
             resume=True, **kw)
    t3, cfg = trainer()
    t3.train(cfg["train_reader"], feeding=cfg["feeding"], **kw)
    a, b = tree_leaves(t2.parameters), tree_leaves(t3.parameters)
    out = {"config": "models/traffic_dsl, 3 batches of 128 a pass, 2 passes",
           "fault": "trainer.step:at=5 (pass 1, batch 1)",
           "raised": raised, "pass_dirs_after_fault": passes,
           "resumed_bit_for_bit_uninterrupted": len(a) == len(b) and all(
               torch.equal(x, y) for x, y in zip(a, b))}
    if not (raised and passes == ["pass-00000"]
            and out["resumed_bit_for_bit_uninterrupted"]):
        fail(f"host_a5: trainer.step fault and resume {out}")
    return out


def a5_cli_prefetch(torch, dev):
    """FLAGS -> the CLI's --prefetch default, cli.main in this process."""
    import os
    from paddle_tpu_torch.data import prefetch
    from paddle_tpu_torch.trainer import api, cli
    depths = []
    real = prefetch.ShardedPrefetcher

    class Recorded(real):
        def __init__(self, source, depth=2, **kw):
            depths.append(depth)
            super().__init__(source, depth=depth, **kw)

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "paddle_tpu_torch", "models", "traffic_dsl.py")
    argv = ["train", "--config", config, "--config_args", "batches=2",
            "--device", dev.type, "--log_period", "0"]
    out = {}
    prefetch.ShardedPrefetcher = Recorded
    try:
        for what, flags_kw, extra in (
                ("async_load_data, prefetch_depth 3",
                 dict(async_load_data=True, prefetch_depth=3), []),
                ("async_load_data off", dict(async_load_data=False), []),
                ("--prefetch 1 over the flags",
                 dict(async_load_data=True, prefetch_depth=3),
                 ["--prefetch", "1"])):
            api.init(**flags_kw)
            del depths[:]
            rc = cli.main(argv + extra)
            out[what] = {"rc": rc, "prefetcher_depths": list(depths)}
    finally:
        prefetch.ShardedPrefetcher = real
        api.init(async_load_data=True, prefetch_depth=2)
    want = {"async_load_data, prefetch_depth 3": [3],
            "async_load_data off": [], "--prefetch 1 over the flags": [1]}
    if any(out[k] != {"rc": 0, "prefetcher_depths": v}
           for k, v in want.items()):
        fail(f"host_a5: FLAGS -> the CLI's prefetch default {out}")
    return out


def run_host_a5(torch, dev, kernels, seed):
    """host_a5 (see A5_DECODE_FAULT_AT); returns the launches."""
    import tempfile
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.obs import trace
    from paddle_tpu_torch.trainer import api
    from paddle_tpu_torch.utils.flags import FLAGS
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 28)
    params = transformer.init_lm(torch.Generator().manual_seed(seed), VOCAB,
                                 D_MODEL, HEADS, DFF, LAYERS, SERVE_MAX_LEN,
                                 device=dev)
    cpu_params = a5_cpu_params(torch, seed)
    n_req, n_tok = 12, 32
    lengths = np.linspace(3, 120, n_req).astype(int)
    prompts = [rng.randint(3, VOCAB, n).tolist() for n in lengths]
    parent_trace, parent_span = "5a" * 16, "a5" * 8
    headers = [{"traceparent": f"00-{parent_trace}-{parent_span}-01"}
               if i % 3 == 1 else {} for i in range(n_req)]
    starts = [0.03 * i for i in range(n_req)]
    runs, structures = {}, {}
    try:
        for on in (False, True):
            api.init(obs_trace_enable=on, obs_trace_sample=1.0)
            FLAGS.apply()
            if not on:
                trace.disable()
            run = serve_http(torch, kernels, a5_engine(params, dev, HEADS),
                             prompts, n_tok, starts, headers)
            run["gen"].close()
            check_served(run, n_tok, f"host_a5 tracing {on}")
            runs[on] = run
            if on:
                structures["card"] = span_structure(finished_spans(n_req))
                trace.enable(sample=1.0, capacity=FLAGS.obs_trace_ring)
                cpu_run = serve_http(
                    torch, kernels,
                    a5_engine(cpu_params, "cpu", A5_CPU_TRUNK["num_heads"]),
                    prompts, n_tok, starts, headers)
                cpu_run["gen"].close()
                check_served(cpu_run, n_tok, "host_a5 CPU structure run")
                structures["cpu"] = span_structure(finished_spans(n_req))
            else:
                off_spans = trace.snapshot()
        off, on = runs[False], runs[True]
        tokens_equal = [r[1] for r in off["results"]] \
            == [r[1] for r in on["results"]]
        served = {}
        for key, run in (("tracing_off", off), ("tracing_on", on)):
            served[key] = {
                "steps": run["steps"], "seconds": run["seconds"],
                "step_wall_ms_mean": run["seconds"] * 1e3 / run["steps"],
                "tpot_ms": run["snapshot"]["tpot_ms"],
                "chunk_launches": run["launches"]["decode_attention_slab_"
                                                  "chunk"]}
        traced = {
            "tokens_bit_for_bit": tokens_equal,
            "spans_recorded_off": len(off_spans),
            "structure_equals_cpu": structures["card"] == structures["cpu"],
            "structure": {f"{k[0]} <- {k[1]}": v
                          for k, v in sorted(structures["card"].items(),
                                             key=str)},
            "trace_id_continued": [on["trace_ids"][i] for i in range(n_req)
                                   if headers[i]] == [parent_trace] * sum(
                                       1 for h in headers if h),
            "trace_ids_off": [t for t in off["trace_ids"] if t]}
        if not (tokens_equal and not off_spans
                and traced["structure_equals_cpu"]
                and traced["trace_id_continued"]
                and not traced["trace_ids_off"]
                and all(r["chunk_launches"] == LAYERS * r["steps"]
                        for r in served.values())):
            fail(f"host_a5: traced serving {traced} {served}")
        clean = [r[1] for r in on["results"][:4]]
        fault_rows, fault_launches = a5_faults(
            torch, dev, kernels, params, cpu_params, prompts[:4], clean)
        if [s for s in trace.snapshot() if s["t_end"] is None]:
            fail("host_a5: spans left active after the fault runs")
        with tempfile.TemporaryDirectory() as tmp:
            resume = a5_trainer_resume(torch, dev, tmp)
        cli_prefetch = a5_cli_prefetch(torch, dev)
    finally:
        trace.disable()
        api.init(obs_trace_enable=False)
    emit({"phase": "host_a5", "served": served, "traced": traced,
          "faults": fault_rows, "trainer_fault_resume": resume,
          "flags_cli_prefetch": cli_prefetch,
          "seconds": time.perf_counter() - t0})
    return {"serve_off": off["launches"], "serve_on": on["launches"],
            **{f"fault_{k}": v for k, v in fault_launches.items()}}


# serve_a6b: the host KV tier, the router's constants, the handoff and
# continuation replay on the served LM (6 layers, 8 heads, vocab 32000,
# D 512, DFF 2048; 8 slots, max_len 256, chunk 8).
# - Host tier: a paged chunked engine (block 16) with a pool of
#   A6B_POOL blocks: a first wave of 12 chained streams over 3 shared
#   96-token prefixes (each submitted once its predecessor's first token
#   is out, so the schedule is a function of the steps alone), churn
#   that evicts the prefixes (spilling them), and a second wave over the
#   same prefixes that restores them; on a float32 and an int8 pool.
#   Every stream is the same requests on a tier-off engine bit for bit,
#   the second wave equals lm_generate on the CPU up to MARGIN_TOL,
#   spills and restores are both counted, the ledger is clean, and the
#   paged chunk kernel (B4 / 6d) launches LAYERS a step.
# - The router's constants: the pinned host-to-device copy rate
#   (A6B_H2D_MB, CUDA events) and the engine's step wall (the p50 of the
#   float32 tier run's steps) — the values the h100 row of perf/roofline
#   carries.  Then restore and recompute of a long prefix (16 blocks of
#   8) and a short one (one block of 4, below a chunk) are timed (first
#   token of the prefix + 1 token, median of A6B_TIMED, the restore from
#   a blob delivered to the tier; the short restore forced, since the
#   router sends it to recompute) and printed beside the predictions;
#   the predicted direction must be the measured one both ways.
# - Handoff: a prefill server and a decode server (host tier) on the
#   card; the decode server pulls the prompt's chain over /v1/kv/export
#   and continues the stream, bit for bit a single paged engine's run;
#   kv_handoffs_total counts "sent" and "received".
# - Replay: 4 clean streams on the slab and paged engines, each continued
#   from 4 replayed tokens: the tail of the stream bit for bit.
A6B_PREFIX, A6B_WAVE, A6B_TOKENS = 96, 12, 16
A6B_POOL = 41
A6B_TIER_BYTES = 1 << 30
A6B_H2D_MB = 256
A6B_TIMED = 3
A6B_LOAD = 4


def chained(bat, cases):
    """Submit ``cases`` ([(prompt, max_tokens)]) in a chain: request i+1
    once request i has emitted its first token or ended (both on the
    batcher's worker thread: the schedule depends on the steps alone).
    Returns per request its tokens, or its error's class name."""
    futs = [None] * len(cases)
    all_in = threading.Event()

    def submit(i):
        if i == len(cases):
            all_in.set()
            return
        fired = []

        def nxt(*_):
            if not fired:
                fired.append(1)
                submit(i + 1)

        prompt, n = cases[i]
        futs[i] = bat.submit(prompt, max_tokens=n, on_token=nxt)
        futs[i].add_done_callback(nxt)

    submit(0)
    if not all_in.wait(600):
        fail("a chained run stalled")
    out = []
    for f in futs:
        try:
            out.append(f.result(600)["tokens"])
        except Exception as e:      # noqa: BLE001 — the caller compares
            out.append(type(e).__name__)
    return out


def cpu_streams_check(torch, transformer, cpu_params, cases, outs, what,
                      kv_dtype=None):
    """Streams against lm_generate on the CPU (one ragged batch), each up
    to its first reference margin below MARGIN_TOL; returns the tokens
    compared."""
    heads = HEADS
    n_tok = max(n for _p, n in cases)
    lengths = np.asarray([len(p) for p, _n in cases], np.int32)
    prompt = np.zeros((len(cases), lengths.max()), np.int32)
    for r, (p, _n) in enumerate(cases):
        prompt[r, :len(p)] = p
    ref = transformer.lm_generate(cpu_params, prompt,
                                  int(lengths.max()) + n_tok, heads,
                                  prompt_lengths=lengths, kv_dtype=kv_dtype)
    marg = margins(torch, transformer, cpu_params, ref, kv_dtype, heads)
    ref = ref.numpy()
    checked = 0
    for r, ((p, n), got) in enumerate(zip(cases, outs)):
        ln = int(lengths[r])
        k, ok = compare(got, ref[r, ln:ln + n].tolist(),
                        marg[r, ln - 1:ln - 1 + n])
        if not ok:
            fail(f"{what}: request {r} disagrees with the CPU within its "
                 f"first {k + 1} tokens above margin {MARGIN_TOL}")
        checked += k
    return checked


def a6b_engine(params, dev, name, **kw):
    from paddle_tpu_torch.serving import DecodeEngine
    base = dict(num_heads=HEADS, num_slots=SLOTS, max_len=SERVE_MAX_LEN,
                prefill_chunk=CHUNK, kv_layout="paged", kv_block_size=PAGE_BS,
                name=name, device=dev)
    return DecodeEngine(params, **dict(base, **kw))


def a6b_tier_runs(torch, dev, transformer, kernels, params, cpu_params,
                  rng):
    """The host-tier waves on float32 and int8 pools (see serve_a6b)."""
    from paddle_tpu_torch.serving import GenerationBatcher
    dk = kernels.decode_attention
    prefixes = [rng.randint(3, VOCAB, A6B_PREFIX).tolist() for _ in range(3)]
    # the first wave's prompts are block-aligned (the shared prefix and
    # one block of their own): a spilled chain is found again by a prompt
    # that extends its key, here the same conversation's next turn
    wave1 = [(prefixes[i % 3] + rng.randint(3, VOCAB, PAGE_BS).tolist(),
              A6B_TOKENS) for i in range(A6B_WAVE)]
    churn = [(rng.randint(3, VOCAB, 200).tolist(), 8) for _ in range(6)]
    wave2 = [(p + rng.randint(3, VOCAB, 3 + i).tolist(), A6B_TOKENS)
             for i, (p, _n) in enumerate(wave1)]
    cases = wave1 + churn + wave2
    rows, launches, step_ms = {}, {}, None
    for kv_dtype, kernel in (("float32", dk.NAME_PAGED_CHUNK),
                             ("int8", dk.NAME_PAGED_CHUNK_I8)):
        outs, snaps = {}, {}
        for tier in (True, False):
            eng = a6b_engine(params, dev, f"a6b_{kv_dtype}_{int(tier)}",
                             kv_num_blocks=A6B_POOL, kv_dtype=kv_dtype,
                             kv_host_bytes=A6B_TIER_BYTES if tier else 0)
            bat = GenerationBatcher(eng)
            kernels.reset_launches()
            steps0 = eng.metrics.decode_steps_total
            t0 = time.perf_counter()
            outs[tier] = (chained(bat, wave1) + chained(bat, churn)
                          + chained(bat, wave2))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            bat.close()
            got = launch_counts(kernels)
            steps = eng.metrics.decode_steps_total - steps0
            if got[kernel] != LAYERS * steps or sum(got.values()) \
                    != got[kernel]:
                fail(f"serve_a6b {kv_dtype} tier={tier}: launches {got} "
                     f"over {steps} steps, want {kernel} {LAYERS * steps}")
            eng._paged.check()
            if eng._paged._pending or eng.free_slots != SLOTS:
                fail(f"serve_a6b {kv_dtype}: pending claims or held slots")
            snaps[tier] = dict(eng.metrics.snapshot(), seconds=dt,
                               steps=steps, launches=got[kernel])
            if tier:
                launches[kv_dtype] = got
                if kv_dtype == "float32":
                    step_ms = snaps[tier]["tpot_ms"]["p50"]
        snap = snaps[True]
        if any(isinstance(o, str) for o in outs[True]) \
                or outs[True] != outs[False]:
            fail(f"serve_a6b {kv_dtype}: the tier run's streams differ from "
                 "the tier-off engine's")
        if not (snap["kv_spill_blocks_total"] > 0
                and snap["kv_restore_hits_total"] > 0):
            fail(f"serve_a6b {kv_dtype}: spills "
                 f"{snap['kv_spill_blocks_total']}, restores "
                 f"{snap['kv_restore_hits_total']}; want both above 0")
        checked = cpu_streams_check(
            torch, transformer, cpu_params, wave2,
            outs[True][-len(wave2):], f"serve_a6b {kv_dtype}",
            None if kv_dtype == "float32" else kv_dtype)
        rows[kv_dtype] = {
            "pool_blocks": A6B_POOL, "requests": len(cases),
            "bit_for_bit_tier_off": True,
            "spilled_blocks": snap["kv_spill_blocks_total"],
            "restores": snap["kv_restore_hits_total"],
            "restored_bytes": snap["kv_restore_bytes_total"],
            "kv_restore_ms": snap["kv_restore_ms"],
            "prefix_hits": snap["prefix_cache_hits_total"],
            "preemptions": snap["evictions"]["pool_exhausted"],
            "steps": {"tier": snap["steps"], "tier_off": snaps[False]["steps"]},
            "seconds": {"tier": snap["seconds"],
                        "tier_off": snaps[False]["seconds"]},
            "step_ms": {"tier": snap["tpot_ms"],
                        "tier_off": snaps[False]["tpot_ms"]},
            "launches": snap["launches"],
            "wave2_tokens_checked_vs_cpu": checked,
            "wave2_tokens_total": len(wave2) * A6B_TOKENS}
    return rows, launches, step_ms


def h2d_gb_s(torch, dev, mb=A6B_H2D_MB, reps=10):
    """The pinned host-to-device copy rate (GB/s), CUDA events."""
    host = torch.empty(mb << 20, dtype=torch.uint8).pin_memory()
    dst = torch.empty(mb << 20, dtype=torch.uint8, device=dev)
    for _ in range(3):
        dst.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    return reps * (mb << 20) / (start.elapsed_time(end) / 1e3) / 1e9


def restore_vs_recompute(torch, dev, params, rng, block_size, blocks):
    """Time the first token of (prefix + 1 token) with the prefix
    restored from the host tier and recomputed, on an engine already
    decoding A6B_LOAD other streams (the router prices a restore in steps
    of a busy engine); median of A6B_TIMED each, the prediction beside.
    The restore path is forced (the router may prefer recompute)."""
    from paddle_tpu_torch.serving import GenerationBatcher
    prefix = rng.randint(3, VOCAB, block_size * blocks).tolist()
    prompt = prefix + [int(rng.randint(3, VOCAB))]
    load = [rng.randint(3, VOCAB, 8).tolist() for _ in range(A6B_LOAD)]
    kw = dict(kv_block_size=block_size)
    tier = a6b_engine(params, dev, f"restore_b{block_size}",
                      kv_host_bytes=A6B_TIER_BYTES, **kw)
    twin = a6b_engine(params, dev, f"recompute_b{block_size}", **kw)
    predicted = tier._restore_predicted_faster(len(prefix))
    tier._restore_predicted_faster = lambda covered: (True,) + \
        predicted[1:]
    bat = GenerationBatcher(tier)
    first = bat.submit(prompt, max_tokens=2).result(120)["tokens"]
    _key, covered, blob = bat.export_chain(prefix)
    bat.close()
    if covered != len(prefix):
        fail(f"serve_a6b: export covered {covered} of {len(prefix)}")
    times = {"restore": [], "recompute": []}
    for _ in range(A6B_TIMED):
        for what, eng in (("restore", tier), ("recompute", twin)):
            eng.reset()
            if what == "restore":
                eng.host_tier.clear()
                eng.deliver_chain_blob(blob)
            gen = GenerationBatcher(eng)
            busy = threading.Event()
            for p in load:
                gen.submit(p, max_tokens=SERVE_MAX_LEN - 16,
                           on_token=lambda _t: busy.set())
            busy.wait(60)
            out = gen.submit(prompt, max_tokens=1).result(120)
            gen.close(drain=False)
            if out["tokens"] != first[:1]:
                fail(f"serve_a6b: the {what} of a {len(prefix)}-position "
                     f"prefix changed the first token")
            times[what].append(out["ttft_ms"])
    restores = tier.metrics.snapshot()["kv_restore_hits_total"]
    if restores != A6B_TIMED:
        fail(f"serve_a6b: {restores} restores, want {A6B_TIMED}")
    measured = {k: float(np.median(v)) for k, v in times.items()}
    row = {"positions": len(prefix), "block_size": block_size,
           "blocks": blocks, "chunk": CHUNK, "load_streams": A6B_LOAD,
           "predicted_ms": {"restore": predicted[1],
                            "recompute": predicted[2]},
           "measured_ms": measured, "measured_all_ms": times,
           "predicted_restore_faster": bool(predicted[0]),
           "measured_restore_faster":
               measured["restore"] < measured["recompute"]}
    if row["predicted_restore_faster"] != row["measured_restore_faster"]:
        fail(f"serve_a6b: the router's direction is wrong: {row}")
    return row


def a6b_handoff(torch, dev, params, rng):
    """Prefill and decode servers on the card, a handoff over
    /v1/kv/export (see serve_a6b)."""
    from paddle_tpu_torch.serving import GenerationBatcher, make_server
    prompt = rng.randint(3, VOCAB, 100).tolist()
    n_tok = A6B_TOKENS
    single = GenerationBatcher(a6b_engine(params, dev, "single"))
    want = single.submit(prompt, max_tokens=n_tok).result(120)["tokens"]
    single.close()
    servers = {}
    for role, kw in (("prefill", {}),
                     ("decode", dict(kv_host_bytes=A6B_TIER_BYTES))):
        gen = GenerationBatcher(a6b_engine(params, dev, role, **kw))
        httpd = make_server(None, port=0, gen_batcher=gen)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers[role] = (gen, httpd, f"http://127.0.0.1:{httpd.port}")

    def post(role, body):
        req = urllib.request.Request(
            f"{servers[role][2]}/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        t0 = time.perf_counter()
        first = post("prefill", {"prompt": prompt, "max_tokens": 1})
        out = post("decode", {"prompt": prompt, "replay": first["tokens"],
                              "max_tokens": n_tok - 1,
                              "kv_handoff": {"source": servers["prefill"][2],
                                             "tokens": prompt
                                             + first["tokens"]}})
        wall = (time.perf_counter() - t0) * 1e3
        stream = first["tokens"] + out["tokens"]
        sent = servers["prefill"][0].metrics.snapshot()["kv_handoffs_total"]
        dsnap = servers["decode"][0].metrics.snapshot()
    finally:
        for gen, httpd, _url in servers.values():
            httpd.shutdown()
            httpd.server_close()
            gen.close()
    row = {"prompt": len(prompt), "tokens": n_tok,
           "handoff": out["kv_handoff"], "sent": sent["sent"],
           "received": dsnap["kv_handoffs_total"]["received"],
           "restores": dsnap["kv_restore_hits_total"],
           "decode_ttft_ms": out["ttft_ms"], "wall_ms": wall,
           "bit_for_bit_single_engine": stream == want}
    if not (row["bit_for_bit_single_engine"] and row["sent"] == 1
            and row["received"] == 1 and row["restores"] == 1
            and out["kv_handoff"]["outcome"] == "received"):
        fail(f"serve_a6b handoff: {row}")
    return row


def a6b_replay(torch, dev, kernels, params, rng):
    """4 clean streams on the slab and paged engines, each continued from
    4 replayed tokens (see serve_a6b)."""
    from paddle_tpu_torch.serving import DecodeEngine, GenerationBatcher
    prompts = [rng.randint(3, VOCAB, n).tolist() for n in (7, 33, 60, 101)]
    rows, launches = {}, {}
    for layout in ("slab", "paged"):
        eng = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                           max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                           kv_layout=layout, kv_block_size=PAGE_BS,
                           name=f"replay_{layout}", device=dev)
        bat = GenerationBatcher(eng)
        clean = [bat.submit(p, max_tokens=A6B_TOKENS).result(120)["tokens"]
                 for p in prompts]
        kernels.reset_launches()
        tails = []
        for p, s in zip(prompts, clean):
            seen = []
            out = bat.submit(p, max_tokens=A6B_TOKENS - 4, replay=s[:4],
                             on_token=seen.append).result(120)["tokens"]
            tails.append(out == s[4:] == seen)
        torch.cuda.synchronize()
        launches[layout] = launch_counts(kernels)
        bat.close()
        rows[layout] = {"bit_for_bit_tail": tails,
                        "launches": {k: n for k, n in
                                     launches[layout].items() if n}}
        if not all(tails):
            fail(f"serve_a6b replay ({layout}): {tails}")
    return rows, launches


def run_serve_a6b(torch, dev, transformer, kernels, seed):
    """serve_a6b (see A6B_PREFIX); returns the launches by run."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 29)
    params = transformer.init_lm(torch.Generator().manual_seed(seed), VOCAB,
                                 D_MODEL, HEADS, DFF, LAYERS, SERVE_MAX_LEN,
                                 device=dev)
    cpu_params = transformer.tree_map(lambda x: x.cpu(), params)
    tier, tier_launches, step_ms = a6b_tier_runs(
        torch, dev, transformer, kernels, params, cpu_params, rng)
    from paddle_tpu_torch.perf import roofline
    spec = roofline.SPECS["h100"]
    constants = {"h2d_pinned_gb_s": h2d_gb_s(torch, dev),
                 "h2d_pinned_mb": A6B_H2D_MB,
                 "step_wall_p50_ms": step_ms,
                 "h100_row": {"host_link_gb_s":
                              spec.host_link_bytes_per_s / 1e9,
                              "step_dispatch_ms": spec.step_dispatch_ms}}
    router = {"long": restore_vs_recompute(torch, dev, params, rng, 8, 16),
              "short": restore_vs_recompute(torch, dev, params, rng, 4, 1)}
    handoff = a6b_handoff(torch, dev, params, rng)
    replay, replay_launches = a6b_replay(torch, dev, kernels, params, rng)
    emit({"phase": "serve_a6b", "host_tier": tier,
          "router_constants": constants, "router": router,
          "handoff": handoff, "replay": replay,
          "seconds": time.perf_counter() - t0})
    return {"tier_f32": tier_launches["float32"],
            "tier_int8": tier_launches["int8"],
            **{f"replay_{k}": v for k, v in replay_launches.items()}}




# serve_a7: supervised recovery, the breaker and /v1/infer.
# - The served LM on the chunked slab engine (B1) and on the prefill
#   ladder (buckets 32 / 64: the flash prefill B3, the Tq=1 step B2): 12
#   chained streams unsupervised, supervised without faults (the same
#   tokens and launches; both step walls), and supervised (watchdog
#   A7_DEADLINE_S, tracing on for the supervisor.recover spans) under
#   serving.decode_step:every=A7_ERROR_EVERY,times=2 — two errors —
#   switched at the A7_HANG_STEP-th step to a hang of A7_HANG_S.  Every stream is the clean run bit for
#   bit; the watchdog trips once and the late step reaches the epoch
#   guard and commits nothing; evictions{recovered} and the failed
#   requests equal the same plan on the CPU (A5_CPU_TRUNK: the schedule
#   depends on lengths and steps, not widths); the step kernel launches
#   LAYERS a committed step plus LAYERS for the discarded late one, the
#   flash prefill LAYERS a prefill batch (recovery re-prefills
#   included).  The recovery stall is the supervisor.recover span.
# - The breaker: threshold 3, cooldown A7_COOLDOWN_S, recovery budget 2,
#   over HTTP: a fault on every step fails a request after three
#   consecutive failures, /readyz answers 503 breaker_open with
#   Retry-After and a generate sheds 503; after the cooldown a probe
#   closes it (/readyz 200).
# - /v1/infer: models/image_dsl.lenet (weights from the seed) behind
#   InferenceEngine (buckets A7_BUCKETS) + Batcher + the server,
#   A7_CLIENTS concurrent clients, each output bit for bit the direct
#   Inferencer forward of its row at one of the buckets; the sentiment
#   classifier (models/text_dsl: three lstmemory of 128 on B9) through
#   an in-process Batcher at padded lengths A7_SEQ_T, outputs within
#   SENT_TOL of the CPU's, B9 forward launches 3 a batch; ms a batch and
#   rows/s by bucket; a serving.engine.execute fault fails only its
#   batch.
A7_CASES, A7_TOKENS = 12, 16
A7_DEADLINE_S, A7_HANG_S = 0.5, 1.2
A7_ERROR_EVERY, A7_HANG_STEP = 9, 24
A7_COOLDOWN_S = 1.0
A7_BUCKETS, A7_CLIENTS = (4, 16, 64), 24
A7_SEQ_T, A7_SEQ_BUCKETS, A7_SEQ_ROWS = (48, 120), (8, 32), 40


def a7_run(engine, cases, supervised=False, faulted=False, traced=False):
    """One chained run on a reset engine: (outcomes, metrics snapshot,
    fires {"errors", "hang"}, late steps discarded by the epoch guard,
    supervisor.recover spans in ms, the supervisor)."""
    from paddle_tpu_torch.obs import trace
    from paddle_tpu_torch.resilience import Supervisor, faults
    from paddle_tpu_torch.serving import GenerationBatcher, ServingMetrics
    engine.reset()
    engine.metrics = ServingMetrics()
    sup = (Supervisor(step_deadline_s=A7_DEADLINE_S if faulted else None,
                      breaker_threshold=10) if supervised else None)
    bat = GenerationBatcher(engine, supervisor=sup)
    stale, fires, calls = [], {}, [0]
    real_step = engine.step

    def step():
        calls[0] += 1
        if faulted and calls[0] == A7_HANG_STEP:
            fires["errors"] = faults.fired_counts()
            faults.install_spec(f"serving.decode_step:at=1,action=hang,"
                                f"hang_s={A7_HANG_S}")
        try:
            return real_step()
        except RuntimeError as e:
            if "reset mid-step" in str(e):
                stale.append(1)
            raise

    engine.step = step
    if faulted:
        faults.install_spec(f"serving.decode_step:every={A7_ERROR_EVERY},"
                            "times=2")
    if traced:
        trace.enable(sample=1.0)
    try:
        out = chained(bat, cases)
        fires["hang"] = faults.fired_counts()
        faults.clear()
        until = time.time() + A7_HANG_S + 10
        while faulted and not stale and time.time() < until:
            time.sleep(0.05)
        spans = ([s for s in trace.snapshot(include_active=False)
                  if s["name"] == "supervisor.recover"] if traced else [])
    finally:
        faults.clear()
        trace.disable()
        del engine.step
        bat.close()
    return (out, engine.metrics.snapshot(), fires, len(stale),
            [(s["t_end"] - s["t_start"]) * 1e3 for s in spans], sup)


def a7_recovery(torch, dev, kernels, params, seed, rng):
    """The chunked and ladder recovery runs on the card and the CPU."""
    from paddle_tpu_torch.serving import DecodeEngine
    dk, fk = kernels.decode_attention, kernels.flash_attention
    cases = [(rng.randint(3, VOCAB, n).tolist(), A7_TOKENS)
             for n in rng.randint(5, 61, A7_CASES)]
    cpu_params = a5_cpu_params(torch, seed)
    rows, launches = {}, {}
    for kind, chunk, step_kernel in (("chunked", CHUNK, dk.NAME),
                                     ("ladder", 0, dk.NAME_SLAB)):
        def engine(p, device, heads, name):
            return DecodeEngine(p, num_heads=heads, num_slots=SLOTS,
                                max_len=SERVE_MAX_LEN, prefill_chunk=chunk,
                                name=name, device=device)
        eng = engine(params, dev, HEADS, f"a7_{kind}")
        runs = {}
        for name, kw in (("unsupervised", {}),
                         ("supervised", dict(supervised=True)),
                         ("faulted", dict(supervised=True, faulted=True,
                                          traced=True))):
            kernels.reset_launches()
            batches0 = eng.prefill_batches_total
            t0 = time.perf_counter()
            res = a7_run(eng, cases, **kw)
            torch.cuda.synchronize()
            runs[name] = res + (time.perf_counter() - t0,
                                launch_counts(kernels),
                                eng.prefill_batches_total - batches0)
        cpu = a7_run(engine(cpu_params, "cpu", A5_CPU_TRUNK["num_heads"],
                            f"a7_{kind}_cpu"), cases, supervised=True,
                     faulted=True)
        clean, cs = runs["unsupervised"][0], runs["unsupervised"][1]
        out, snap, fires, stale, recover_ms, sup, dt, got, batches = \
            runs["faulted"]
        sout, ssnap, _f, _s, _r, _sup, sdt, sgot, _b = runs["supervised"]
        failed = [i for i, o in enumerate(out) if isinstance(o, str)]
        cpu_failed = [i for i, o in enumerate(cpu[0]) if isinstance(o, str)]
        steps = snap["decode_steps_total"]
        want = {step_kernel: LAYERS * (steps + stale),
                "flash_attention": LAYERS * batches if not chunk else 0}
        row = {
            "requests": len(cases),
            "plan": {"errors": f"every={A7_ERROR_EVERY},times=2",
                     "hang": f"the {A7_HANG_STEP}th step, {A7_HANG_S} s "
                             f"past a {A7_DEADLINE_S} s deadline"},
            "fires": fires, "cpu_fires": cpu[2],
            "bit_for_bit_clean": [o == c for o, c in zip(out, clean)],
            "failed": failed, "cpu_failed": cpu_failed,
            "evictions": snap["evictions"],
            "cpu_evictions": cpu[1]["evictions"],
            "watchdog_trips": sup.watchdog_trips,
            "late_steps_discarded": stale,
            "recover_span_ms": recover_ms,
            "steps": steps, "prefill_batches": batches,
            "launches": {k: n for k, n in got.items() if n},
            "want_launches": want,
            "no_fault_supervised_equal": sout == clean and sgot == runs[
                "unsupervised"][7],
            "step_wall_ms": {"unsupervised": cs["tpot_ms"],
                             "supervised": ssnap["tpot_ms"],
                             "faulted": snap["tpot_ms"]},
            "seconds": {"unsupervised": runs["unsupervised"][6],
                        "supervised": sdt, "faulted": dt}}
        ok = (all(row["bit_for_bit_clean"]) and not failed
              and failed == cpu_failed
              and snap["evictions"] == cpu[1]["evictions"]
              and snap["evictions"]["recovered"] > 0
              and fires["errors"] == {"serving.decode_step": 2}
              and fires["hang"] == {"serving.decode_step": 1}
              and cpu[2] == fires and sup.watchdog_trips == 1
              and stale == 1 and len(recover_ms) == 3
              and row["no_fault_supervised_equal"]
              and all(got[k] == want.get(k, 0) for k in got))
        if not ok:
            fail(f"serve_a7 {kind}: {row}")
        rows[kind] = row
        launches[kind] = got
        launches[f"{kind}_clean"] = runs["unsupervised"][7]
    return rows, launches


def a7_breaker(torch, dev, params, rng):
    """The breaker over HTTP (see serve_a7)."""
    from paddle_tpu_torch.resilience import Supervisor, faults
    from paddle_tpu_torch.serving import (DecodeEngine, GenerationBatcher,
                                          make_server)
    eng = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                       max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                       name="a7_breaker", device=dev)
    sup = Supervisor(breaker_threshold=3, breaker_cooldown_s=A7_COOLDOWN_S,
                     max_request_recoveries=2)
    gen = GenerationBatcher(eng, supervisor=sup)
    httpd = make_server(None, port=0, gen_batcher=gen)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.port}"
    prompt = rng.randint(3, VOCAB, 20).tolist()
    body = json.dumps({"prompt": prompt, "max_tokens": 4}).encode()

    def call(path, data=None):
        req = urllib.request.Request(base + path, data=data, headers={
            "Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read()), r.headers
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), e.headers

    try:
        faults.install_spec("serving.decode_step:every=1")
        failed = call("/v1/generate", body)
        faults.clear()
        opened = call("/readyz")
        shed = call("/v1/generate", body)
        time.sleep(A7_COOLDOWN_S + 0.1)
        probe = call("/v1/generate", body)
        until = time.time() + 10
        while sup.breaker.state != "closed" and time.time() < until:
            time.sleep(0.01)
        ready = call("/readyz")
    finally:
        faults.clear()
        httpd.shutdown()
        httpd.server_close()
        gen.close()
    snap = eng.metrics.snapshot()
    row = {"failed_request": failed[0],
           "readyz_open": [opened[0], opened[1].get("reasons"),
                           opened[2].get("Retry-After")],
           "generate_shed": [shed[0], shed[2].get("Retry-After")],
           "probe": probe[0], "readyz_after": ready[0],
           "breaker_open_total": snap["breaker_open_total"],
           "rejected_breaker": snap["rejected"]["breaker"],
           "recovered": snap["evictions"]["recovered"]}
    if not (failed[0] == 500 and opened[0] == 503
            and opened[1].get("reasons") == ["breaker_open"]
            and int(opened[2].get("Retry-After", 0)) >= 1
            and shed[0] == 503 and int(shed[2].get("Retry-After", 0)) >= 1
            and probe[0] == 200 and ready[0] == 200
            and snap["breaker_open_total"] == 1
            and sup.breaker.state == "closed"):
        fail(f"serve_a7 breaker: {row}")
    return row


def infer_bucket_ms(torch, engine, feed_row, reps=10):
    """ms a batch and rows/s at each bucket (full buckets)."""
    from paddle_tpu_torch.serving.engine import stack_rows
    out = {}
    for b in engine.buckets:
        feed = stack_rows([feed_row] * b)
        engine.infer(feed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.infer(feed)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        out[b] = {"ms": ms, "rows_per_s": b / ms * 1e3}
    return out


def a7_infer(torch, dev, kernels, seed, rng):
    """/v1/infer on lenet and the sentiment Batcher (see serve_a7)."""
    from paddle_tpu_torch.layers.graph import Topology
    from paddle_tpu_torch.models import image_dsl, text_dsl
    from paddle_tpu_torch.core.sequence import SequenceBatch
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import (BatchExecutionError, Batcher,
                                          InferenceEngine, make_server)
    from paddle_tpu_torch.serving.engine import ShapeDtype
    from paddle_tpu_torch.trainer.trainer import Inferencer
    lk = kernels.lstm
    _cost, out = image_dsl.lenet()
    params = Topology([out]).init(torch.Generator().manual_seed(seed),
                                  device=dev)
    inf = Inferencer(out, params, device=dev)
    eng = InferenceEngine.from_inferencer(
        inf, {"pixel": ShapeDtype((1, 784), np.dtype(np.float32))},
        buckets=A7_BUCKETS, name="lenet")
    bat = Batcher(eng, max_delay_ms=20.0)
    httpd = make_server(bat, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    rows = rng.rand(A7_CLIENTS, 784).astype(np.float32)
    results, errors = [None] * A7_CLIENTS, []

    def client(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.port}/v1/infer",
            data=json.dumps({"feed": {"pixel": rows[i].tolist()}}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = np.asarray(json.loads(r.read())["outputs"],
                                        np.float32)
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(f"{i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(A7_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    http_s = time.perf_counter() - t0
    httpd.shutdown()
    httpd.server_close()
    lenet_batches = eng.metrics.snapshot()
    matched = []
    with torch.no_grad():
        for i in range(A7_CLIENTS):
            direct = [inf.infer({"pixel": np.repeat(rows[i:i + 1], b, 0)})
                      .cpu().numpy()[0] for b in A7_BUCKETS]
            matched.append(results[i] is not None and any(
                np.array_equal(results[i], d) for d in direct))
    faults.install_spec("serving.engine.execute:at=1")
    try:
        bat.submit({"pixel": rows[0]}).result(60)
        fault_isolated = False
    except BatchExecutionError:
        fault_isolated = True
    faults.clear()
    after = bat.submit({"pixel": rows[1]}).result(60)
    with torch.no_grad():
        fault_isolated = fault_isolated and np.array_equal(after, inf.infer(
            {"pixel": np.repeat(rows[1:2], A7_BUCKETS[0], 0)}).cpu().numpy()[0])
    bat.close()
    lenet = {"clients": A7_CLIENTS, "http_seconds": http_s,
             "errors": errors, "bit_for_bit_direct": matched,
             "batches": lenet_batches["batches_total"],
             "mean_occupancy": lenet_batches["mean_occupancy"],
             "padding_waste": lenet_batches["padding_waste"],
             "batch_time_ms": lenet_batches["batch_time_ms"],
             "by_bucket": infer_bucket_ms(torch, eng,
                                          {"pixel": rows[0]}),
             "engine_execute_fault_isolated": fault_isolated}
    if errors or not all(matched) or not fault_isolated \
            or lenet_batches["mean_occupancy"] <= 1.0:
        fail(f"serve_a7 /v1/infer lenet: {lenet}")
    # the sentiment classifier through an in-process Batcher
    _cost, sout = text_dsl.build("sentiment")
    sparams = Topology([sout]).init(torch.Generator().manual_seed(seed),
                                    device=dev)
    sinf = Inferencer(sout, sparams, device=dev)
    cpu_inf = Inferencer(sout, sparams, device="cpu")
    sentiment = {}
    for t in A7_SEQ_T:
        spec = {"words": SequenceBatch(ShapeDtype((1, t), np.dtype(np.int32)),
                                       ShapeDtype((1,), np.dtype(np.int32)))}
        seng = InferenceEngine.from_inferencer(
            sinf, spec, buckets=A7_SEQ_BUCKETS, name=f"sentiment_T{t}")
        sbat = Batcher(seng, max_delay_ms=20.0)
        data = rng.randint(0, text_dsl.DICT_DIM, (A7_SEQ_ROWS, t)) \
            .astype(np.int32)
        lengths = rng.randint(1, t + 1, A7_SEQ_ROWS).astype(np.int32)
        kernels.reset_launches()
        futs = [sbat.submit({"words": SequenceBatch(data[i], lengths[i])})
                for i in range(A7_SEQ_ROWS)]
        got = np.stack([f.result(120) for f in futs])
        torch.cuda.synchronize()
        fwd, bwd = lk.launches_fwd, lk.launches_bwd
        snap = seng.metrics.snapshot()
        sbat.close()
        with torch.no_grad():
            want = cpu_inf.infer({"words": SequenceBatch(
                torch.from_numpy(data), torch.from_numpy(lengths))}).numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        sentiment[t] = {"rows": A7_SEQ_ROWS, "batches": snap["batches_total"],
                        "lstm_fwd_launches": fwd, "lstm_bwd_launches": bwd,
                        "rel_err_vs_cpu": err, "tolerance": SENT_TOL,
                        "mean_occupancy": snap["mean_occupancy"],
                        "by_bucket": infer_bucket_ms(
                            torch, seng, {"words": SequenceBatch(
                                data[0], lengths[0])})}
        if err > SENT_TOL or bwd or fwd != 3 * snap["batches_total"]:
            fail(f"serve_a7 sentiment T {t}: {sentiment[t]}")
    return {"lenet": lenet, "sentiment": sentiment}


def run_serve_a7(torch, dev, transformer, kernels, seed):
    """serve_a7 (see A7_TOKENS); returns the launches by run."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 30)
    params = transformer.init_lm(torch.Generator().manual_seed(seed), VOCAB,
                                 D_MODEL, HEADS, DFF, LAYERS, SERVE_MAX_LEN,
                                 device=dev)
    recovery, launches = a7_recovery(torch, dev, kernels, params, seed, rng)
    breaker = a7_breaker(torch, dev, params, rng)
    del params
    kernels.reset_launches()
    infer = a7_infer(torch, dev, kernels, seed, rng)
    emit({"phase": "serve_a7", "recovery": recovery, "breaker": breaker,
          "infer": infer, "seconds": time.perf_counter() - t0})
    launches["infer_sentiment"] = {kernels.lstm.NAME_FWD: sum(
        r["lstm_fwd_launches"] for r in infer["sentiment"].values())}
    return launches


# serve_a8: the multi-process serving tier on the served LM (BASE_LM, the
# chip_smoke seed).
# (a) Two subprocess replicas (python -m paddle_tpu_torch.serving: the
#     chunked slab default, --port 0 --port-file, a decode-step hang of
#     A8_PACE_S pacing tokens so a kill lands mid-stream) under
#     ReplicaSupervisor, behind Router.  A8_CLIENTS staggered streaming
#     clients; kill -9 of r0 once every stream has 2 tokens out.  Every
#     stream is bit for bit an in-process engine on the card from the
#     same seed (its run launches B1 LAYERS a step); midstream failovers
#     >= 1; r0 restarted with the seeded backoff and ready again.  The
#     stall a client sees at the failover (the largest gap between two
#     tokens), kill -> ready, the first spawn -> ready, and the clients'
#     TTFT and TPOT p50 through the router beside the same clients sent
#     straight to the replicas (the pacing hang is inside both TPOTs).
# (b) r1 is removed (SIGTERM drain) while clients loop through the
#     router: zero failed requests, each bit for bit its stream's prefix.
# (c) A prefill and a decode server in process (paged, block A8_BS,
#     prefix cache, a host tier) behind a router: every stream handed
#     off at its first token, bit for bit a mixed engine of the same
#     configuration; the prompts the analytic model prices for a handoff
#     are received, the short one falls back to recompute; sent /
#     received / bytes / ms on both servers and the router; B4 LAYERS a
#     step on both engines; after the prefill server closes, a handoff
#     naming it falls back and stays bit for bit, and a stream through
#     the router still completes.
# (d) A router with an AIMD limit of 4 over a slab server (B1): a burst
#     past the limit sheds background first (429 + Retry-After) while
#     interactive is admitted, then standard past its slice; at brownout
#     rung 2 a stream is capped to A8_CAP tokens, a prefix of the
#     uncapped stream.
# (e) The autoscaler over the one-replica fleet left by (b), a low TTFT
#     target: a sustained breach under A8_LOAD_CLIENTS streaming clients
#     scales out to 2 (spawn to readiness), the load stops and it scales
#     back in to 1; zero failed requests; the journal is printed.
A8_CLIENTS, A8_TOKENS = 12, 48
A8_PACE_S = 0.01
A8_BS = 8
A8_TIER_BYTES = 1 << 30
A8_HANDOFF_LENGTHS, A8_HANDOFF_TOKENS = (96, 128, 16, 64), 16
A8_CAP = 8
A8_LOAD_CLIENTS, A8_LOAD_TOKENS = 16, 24
A8_TARGET_TTFT_MS = 100.0


def a8_stream(port, prompt, n_tok, on_token=None, headers=None, **extra):
    """One streaming /v1/generate: {"status", "tokens", "done", "times"
    (arrival of each token), "t0", "retry_after"}."""
    import http.client
    body = {"prompt": [int(t) for t in prompt], "max_tokens": n_tok,
            "stream": True, **extra}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/generate", json.dumps(body).encode(),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        out = {"status": resp.status, "tokens": [], "done": None,
               "times": [], "t0": t0,
               "retry_after": resp.getheader("Retry-After")}
        if resp.status != 200:
            out["error"] = resp.read().decode(errors="replace")[:300]
            return out
        while True:
            line = resp.readline()
            if not line:
                break
            rec = json.loads(line)
            if "token" in rec:
                out["tokens"].append(rec["token"])
                out["times"].append(time.perf_counter())
                if on_token is not None:
                    on_token(len(out["tokens"]))
            if rec.get("done") or "error" in rec:
                out["done"] = rec
                break
        return out
    finally:
        conn.close()


def a8_ttft_tpot(runs):
    """p50 of the clients' TTFT and of their inter-token gaps, in ms."""
    ttft = [(r["times"][0] - r["t0"]) * 1e3 for r in runs if r["times"]]
    gaps = [(b - a) * 1e3 for r in runs
            for a, b in zip(r["times"], r["times"][1:])]
    return {"ttft_p50_ms": float(np.percentile(ttft, 50)),
            "tpot_p50_ms": float(np.percentile(gaps, 50))}


def a8_concurrent(fn, n, stagger_s=0.01):
    """fn(i) on n threads started stagger_s apart; the results."""
    out = [None] * n

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as e:      # noqa: BLE001 — reported by the caller
            out[i] = {"status": None, "error": f"{type(e).__name__}: {e}",
                      "tokens": [], "times": [], "done": None}

    threads = []
    for i in range(n):
        threads.append(threading.Thread(target=run, args=(i,)))
        threads[-1].start()
        time.sleep(stagger_s)
    for t in threads:
        t.join(300)
    return out


def a8_ok(run, want):
    return (run is not None and run["status"] == 200
            and run["tokens"] == want and run["done"] is not None
            and run["done"].get("tokens") == want)


def a8_replica_logs(sup):
    import os
    tails = {}
    for rid in list(sup.replicas):
        path = os.path.join(sup.base_dir, f"{rid}.log")
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                tails[rid] = f.read()[-1500:]
    return tails


def a8_wait(pred, timeout, every=0.05):
    until = time.time() + timeout
    while time.time() < until:
        if pred():
            return True
        time.sleep(every)
    return False


def a8_fleet(torch, dev, kernels, seed, rng, sup, router, port):
    """(a): the kill -9 failover, the restart, router against direct."""
    from paddle_tpu_torch.serving import server
    prompts = [rng.randint(3, VOCAB, n).tolist()
               for n in rng.randint(5, 61, A8_CLIENTS)]
    gen = server.build_gen_batcher(seed=seed, slots=SLOTS,
                                   max_len=SERVE_MAX_LEN,
                                   max_tokens=A8_TOKENS, device=dev,
                                   name="a8_reference")
    kernels.reset_launches()
    futs = [gen.submit(p, max_tokens=A8_TOKENS) for p in prompts]
    oracle = [f.result(300)["tokens"] for f in futs]
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    steps = gen.metrics.snapshot()["decode_steps_total"]
    gen.close()
    if launches[kernels.decode_attention.NAME] != LAYERS * steps:
        fail(f"serve_a8 reference: {launches} for {steps} steps")
    barrier = threading.Barrier(A8_CLIENTS + 1, timeout=120)

    def client(i):
        armed = [True]

        def seen(n):
            if armed[0] and n >= 2:
                armed[0] = False
                barrier.wait()

        try:
            return a8_stream(port, prompts[i], A8_TOKENS, on_token=seen)
        finally:
            if armed[0]:
                try:
                    barrier.wait()
                except threading.BrokenBarrierError:
                    pass

    box = {}

    def kill():
        barrier.wait()
        box["t_kill"] = time.perf_counter()
        sup.kill("r0", signal.SIGKILL)

    killer = threading.Thread(target=kill)
    killer.start()
    runs = a8_concurrent(client, A8_CLIENTS)
    killer.join(120)
    t_kill = box.get("t_kill")
    if t_kill is None:
        fail("serve_a8: the kill never happened")
    ok = [a8_ok(r, o) for r, o in zip(runs, oracle)]
    stalls = [max((b - a) * 1e3 for a, b in zip(r["times"], r["times"][1:])
                  if b > t_kill) for r in runs if len(r["times"]) > 1
              and r["times"][-1] > t_kill]
    snap = router.metrics.snapshot()
    ready = sup.wait_ready(timeout=300, rids=("r0",))
    kill_to_ready = time.perf_counter() - t_kill
    fsnap = sup.snapshot()["r0"]
    import random
    want_delay = round(min(0.3, 10.0) * (0.5 + 0.5 * random.Random(
        seed * 7919).random()), 4)
    row = {"clients": A8_CLIENTS, "tokens": A8_TOKENS,
           "pace_hang_s": A8_PACE_S, "bit_for_bit_engine": ok,
           "errors": [r.get("error") for r in runs if r.get("error")],
           "midstream_failovers": snap["midstream_failovers_total"],
           "failovers": snap["failovers_total"],
           "failover_stall_ms": max(stalls) if stalls else None,
           "kill_to_ready_s": kill_to_ready, "victim_ready": ready,
           "victim_restarts": fsnap["restarts_total"],
           "backoff_delays_s": fsnap["backoff_delays_s"],
           "seeded_backoff_s": want_delay,
           "reference_launches": {k: n for k, n in launches.items() if n}}
    if not (all(ok) and snap["midstream_failovers_total"] >= 1 and ready
            and fsnap["restarts_total"] == 1
            and fsnap["backoff_delays_s"] == [want_delay]):
        fail(f"serve_a8 fleet: {row} {a8_replica_logs(sup)}")
    # the same clients through the router and straight to the replicas
    if not a8_wait(lambda: sum(s["ready"] for s in
                               router.replica_states().values()) == 2, 60):
        fail(f"serve_a8: the router never saw r0 again "
             f"{router.replica_states()}")
    eps = dict(sup.endpoints())
    ports = [int(eps[r].rsplit(":", 1)[1]) for r in ("r0", "r1")]
    timing = {}
    for via in ("router", "direct", "router_again", "direct_again"):
        got = a8_concurrent(
            lambda i: a8_stream(port if via.startswith("router")
                                else ports[i % 2], prompts[i], A8_TOKENS),
            A8_CLIENTS)
        if not all(a8_ok(r, o) for r, o in zip(got, oracle)):
            fail(f"serve_a8 {via}: streams differ from the engine's")
        timing[via] = a8_ttft_tpot(got)
    row["timing"] = timing
    row["router_added"] = {
        key: (timing["router"][key] + timing["router_again"][key]
              - timing["direct"][key] - timing["direct_again"][key]) / 2
        for key in ("ttft_p50_ms", "tpot_p50_ms")}
    return row, launches, prompts, oracle


def a8_drain(sup, router, port, prompts, oracle):
    """(b): r1 removed under load, zero failed requests."""
    import urllib.error
    stop = threading.Event()
    done, failed = [0], []

    def client(i):
        while not stop.is_set():
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/generate",
                data=json.dumps({"prompt": prompts[i],
                                 "max_tokens": 8}).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    out = json.loads(r.read())
                if out["tokens"] != oracle[i][:8]:
                    failed.append((i, "tokens"))
                done[0] += 1
            except (urllib.error.URLError, OSError, ValueError) as e:
                failed.append((i, f"{type(e).__name__}: {e}"))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    t0 = time.perf_counter()
    before = done[0]
    sup.remove_replica("r1", drain_timeout=60)
    drain_s = time.perf_counter() - t0
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(300)
    row = {"requests": done[0], "during_drain": done[0] - before,
           "failed": failed[:5], "n_failed": len(failed),
           "drain_s": drain_s, "fleet": sorted(sup.replicas)}
    if failed or sorted(sup.replicas) != ["r0"] or not done[0]:
        fail(f"serve_a8 drain: {row}")
    return row


def a8_autoscale(torch, sup, router, port, prompts, oracle, seed):
    """(e): scale out on a sustained breach, back in when the load
    stops, zero failed requests."""
    from paddle_tpu_torch.serving import Autoscaler
    scaler = Autoscaler(sup, router, poll_interval_s=0.25,
                        target_ttft_ms=A8_TARGET_TTFT_MS, hysteresis=0.2,
                        breach_polls=2, slack_polls=8, cooldown_out_s=2.0,
                        cooldown_in_s=4.0, min_replicas=1, max_replicas=2,
                        window_s=4.0, seed=seed, ready_timeout_s=240.0,
                        name="a8_autoscaler")
    stop = threading.Event()
    results, lock = [], threading.Lock()

    def client(i):
        p = prompts[i % len(prompts)]
        while not stop.is_set():
            r = a8_stream(port, p, A8_LOAD_TOKENS)
            with lock:
                results.append((i % len(prompts), r))

    scaler.start()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(A8_LOAD_CLIENTS)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        out_ok = a8_wait(lambda: len(sup.replicas) >= 2
                         and scaler.scales_total["out"] >= 1, 300, 0.2)
        scaled_out_s = time.perf_counter() - t0
        time.sleep(1.0)             # both replicas serve the load
        stop.set()
        for t in threads:
            t.join(300)
        in_ok = a8_wait(lambda: len(sup.replicas) <= 1
                        and scaler.scales_total["in"] >= 1, 120, 0.2)
        scaled_in_s = time.perf_counter() - t0
    finally:
        stop.set()
        scaler.close()
    failed = [(i, r["status"], r.get("error")) for i, r in results
              if not (a8_ok(r, oracle[i][:A8_LOAD_TOKENS])
                      or (r["status"] == 429 and r["retry_after"]))]
    journal = [[e["tick"], round(e["t"] - scaler.journal[0]["t"], 3),
                e["decision"], e["reason"], e["signals"]["ttft_p99_ms"],
                e["signals"]["replicas"], e.get("actuation")]
               for e in scaler.journal]
    row = {"clients": A8_LOAD_CLIENTS, "target_ttft_ms": A8_TARGET_TTFT_MS,
           "requests": len(results), "failed": failed[:5],
           "n_failed": len(failed), "scaled_out": out_ok,
           "scaled_out_after_s": scaled_out_s, "scaled_in": in_ok,
           "scaled_in_after_s": scaled_in_s,
           "scales_total": dict(scaler.scales_total),
           "scale_failures": scaler.scale_failures_total,
           "fleet": sorted(sup.replicas), "journal": journal}
    if failed or not (out_ok and in_ok):
        fail(f"serve_a8 autoscaler: {row} {a8_replica_logs(sup)}")
    return row


def a8_disagg(torch, dev, kernels, params, rng):
    """(c): the prefill/decode pair in process, both fallbacks."""
    from paddle_tpu_torch.serving import (GenerationBatcher, Router,
                                          make_server)
    dk = kernels.decode_attention
    kw = dict(kv_block_size=A8_BS, kv_host_bytes=A8_TIER_BYTES)
    prompts = [rng.randint(3, VOCAB, n).tolist()
               for n in A8_HANDOFF_LENGTHS + (96, 64)]
    n_tok = A8_HANDOFF_TOKENS
    ref_eng = a6b_engine(params, dev, "a8_mixed", **kw)
    ref = GenerationBatcher(ref_eng)
    oracle = [ref.submit(p, max_tokens=n_tok).result(300)["tokens"]
              for p in prompts]
    ref.close()
    handed = [bool(ref_eng._handoff_predicted_faster(
        n // A8_BS * A8_BS)[0]) for n in A8_HANDOFF_LENGTHS]
    if all(handed) or not any(handed):
        fail(f"serve_a8 disagg: the prompts {A8_HANDOFF_LENGTHS} do not "
             f"straddle the analytic crossover: {handed}")
    servers = {}
    for role in ("prefill", "decode"):
        gen = GenerationBatcher(a6b_engine(params, dev, f"a8_{role}", **kw))
        gen.metrics.set_serving_role(role)
        httpd = make_server(None, port=0, gen_batcher=gen)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers[role] = (gen, httpd, f"http://127.0.0.1:{httpd.port}")
    router = Router(replicas=[servers["prefill"][2], servers["decode"][2]],
                    poll_interval_s=0.05, retry_budget=3, hedge_ms=0,
                    name="a8_disagg")
    httpd = router.start(port=0)
    try:
        if not a8_wait(router.disagg_active, 30):
            fail("serve_a8 disagg: the router never saw both roles")
        steps0 = {r: s[0].metrics.snapshot()["decode_steps_total"]
                  for r, s in servers.items()}
        kernels.reset_launches()
        runs = a8_concurrent(lambda i: a8_stream(httpd.port, prompts[i],
                                                 n_tok),
                             len(A8_HANDOFF_LENGTHS))
        torch.cuda.synchronize()
        launches = launch_counts(kernels)
        steps = {r: s[0].metrics.snapshot()["decode_steps_total"] - steps0[r]
                 for r, s in servers.items()}
        outcomes = [(r["done"] or {}).get("kv_handoff", {}).get("outcome")
                    for r in runs]
        psnap = servers["prefill"][0].metrics.snapshot()
        dsnap = servers["decode"][0].metrics.snapshot()
        rsnap = router.metrics.snapshot()
        n_handed = sum(handed)
        row = {"prompts": list(A8_HANDOFF_LENGTHS), "tokens": n_tok,
               "block_size": A8_BS, "analytic_handoff": handed,
               "outcomes": outcomes,
               "bit_for_bit_mixed": [a8_ok(r, o)
                                     for r, o in zip(runs, oracle)],
               "prefill_handoffs": psnap["kv_handoffs_total"],
               "decode_handoffs": dsnap["kv_handoffs_total"],
               "decode_handoff_bytes": dsnap["kv_handoff_bytes_total"],
               "decode_handoff_ms": dsnap["kv_handoff_ms"],
               "decode_restores": dsnap["kv_restore_hits_total"],
               "router_handoffs": rsnap["kv_handoffs_total"],
               "router_handoff_bytes": rsnap["kv_handoff_bytes_total"],
               "router_handoff_ms": rsnap["kv_handoff_ms"],
               "steps": steps,
               "launches": {k: n for k, n in launches.items() if n}}
        if not (all(row["bit_for_bit_mixed"])
                and outcomes == ["received" if h else "fallback"
                                 for h in handed]
                and psnap["kv_handoffs_total"]["sent"] == n_handed
                and dsnap["kv_handoffs_total"]["received"] == n_handed
                and dsnap["kv_handoffs_total"]["fallback"]
                == len(handed) - n_handed
                and rsnap["kv_handoffs_total"]["received"] == n_handed
                and rsnap["kv_handoff_bytes_total"] > 0
                and all(steps.values())
                and launches[dk.NAME_PAGED_CHUNK]
                == LAYERS * sum(steps.values())):
            fail(f"serve_a8 disagg: {row}")
        # the prefill server goes away: a handoff naming it falls back
        gen, phttpd, purl = servers.pop("prefill")
        phttpd.shutdown()
        phttpd.server_close()
        gen.close()
        p, o = prompts[len(A8_HANDOFF_LENGTHS)], oracle[len(A8_HANDOFF_LENGTHS)]
        dead = a8_stream(servers["decode"][1].port, p, n_tok - 1,
                         replay=o[:1], kv_handoff={"source": purl,
                                                   "tokens": p})
        post_p, post_o = prompts[-1], oracle[-1]
        post = a8_stream(httpd.port, post_p, n_tok)
        row["dead_source"] = {
            "handoff": (dead["done"] or {}).get("kv_handoff"),
            "bit_for_bit_mixed": a8_ok(dead, o[1:])}
        row["after_prefill_loss_bit_for_bit"] = a8_ok(post, post_o)
        if not (row["dead_source"]["bit_for_bit_mixed"]
                and row["dead_source"]["handoff"]["outcome"] == "fallback"
                and row["after_prefill_loss_bit_for_bit"]):
            fail(f"serve_a8 disagg after the prefill loss: {row}")
    finally:
        router.close()
        for gen, shttpd, _url in servers.values():
            shttpd.shutdown()
            shttpd.server_close()
            gen.close()
    return row, launches


def a8_overload(torch, dev, kernels, params, rng):
    """(d): AIMD shedding by class and the brownout token cap."""
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import (AIMDLimiter, BrownoutLadder,
                                          DecodeEngine, GenerationBatcher,
                                          OverloadController, Router,
                                          make_server)

    class Clock:
        t = 1000.0

        def __call__(self):
            return self.t

    clk = Clock()
    eng = DecodeEngine(params, num_heads=HEADS, num_slots=SLOTS,
                       max_len=SERVE_MAX_LEN, prefill_chunk=CHUNK,
                       name="a8_overload", device=dev)
    gen = GenerationBatcher(eng)
    shttpd = make_server(None, port=0, gen_batcher=gen)
    threading.Thread(target=shttpd.serve_forever, daemon=True).start()
    ladder = BrownoutLadder(slo_ttft_s=0.05, enter_hold_s=1.0,
                            exit_hold_s=1.0, clock=clk)
    ctl = OverloadController(
        limiter=AIMDLimiter(initial=4, min_limit=1, max_limit=64, clock=clk),
        ladder=ladder, brownout_max_tokens=A8_CAP, clock=clk)
    router = Router(replicas=[f"http://127.0.0.1:{shttpd.port}"],
                    poll_interval_s=0.05, hedge_ms=0, overload=ctl,
                    name="a8_overload")
    httpd = router.start(port=0)
    prompt = rng.randint(3, VOCAB, 20).tolist()
    try:
        if not a8_wait(router.ready, 30):
            fail("serve_a8 overload: the router never saw its replica")
        uncapped = gen.submit(prompt, max_tokens=32).result(300)["tokens"]
        kernels.reset_launches()
        steps0 = eng.metrics.snapshot()["decode_steps_total"]
        faults.install_spec("serving.decode_step:every=1,action=hang,"
                            "hang_s=0.05")
        held_runs = []
        held = [threading.Thread(target=lambda: held_runs.append(a8_stream(
            httpd.port, prompt, 32, headers={"X-Priority": "standard"})))
            for _ in range(3)]
        for t in held:
            t.start()
        if not a8_wait(lambda: ctl.limiter.inflight == 3, 30):
            fail(f"serve_a8 overload: {ctl.snapshot()}")
        bg = a8_stream(httpd.port, prompt, 32,
                       headers={"X-Priority": "background"})
        inter = [None]
        ti = threading.Thread(target=lambda: inter.__setitem__(
            0, a8_stream(httpd.port, prompt, 32,
                         headers={"X-Priority": "interactive"})))
        ti.start()
        if not a8_wait(lambda: ctl.limiter.inflight == 4, 30):
            fail(f"serve_a8 overload: {ctl.snapshot()}")
        std = a8_stream(httpd.port, prompt, 32,
                        headers={"X-Priority": "standard"})
        for t in held + [ti]:
            t.join(300)
        faults.clear()
        # brownout rung 2: the token cap
        for _ in range(3):
            ladder.observe(1.0)
            clk.t += 1.0
        rung = ladder.rung
        capped = a8_stream(httpd.port, prompt, 32)
        while ladder.rung:
            ladder.observe(0.001)
            clk.t += 1.0
        full = a8_stream(httpd.port, prompt, 32)
        torch.cuda.synchronize()
        launches = launch_counts(kernels)
        steps = eng.metrics.snapshot()["decode_steps_total"] - steps0
    finally:
        faults.clear()
        router.close()
        shttpd.shutdown()
        shttpd.server_close()
        gen.close()
    osnap = ctl.snapshot()
    row = {"aimd_limit": 4,
           "background_at_3_inflight": [bg["status"], bg["retry_after"]],
           "interactive_at_3_inflight": inter[0]["status"],
           "standard_at_4_inflight": [std["status"], std["retry_after"]],
           "held_standard": [r["status"] for r in held_runs],
           "shed_total": osnap["shed_total"],
           "shed_reasons": osnap["shed_reasons"],
           "brownout_rung": rung, "capped_tokens": len(capped["tokens"]),
           "capped_is_prefix": capped["tokens"] == uncapped[:A8_CAP],
           "full_after_recovery": full["tokens"] == uncapped,
           "token_caps": osnap["token_caps_applied_total"],
           "steps": steps,
           "launches": {k: n for k, n in launches.items() if n}}
    if not (bg["status"] == 429 and int(bg["retry_after"] or 0) >= 1
            and inter[0]["status"] == 200
            and inter[0]["tokens"] == uncapped
            and std["status"] == 429 and int(std["retry_after"] or 0) >= 1
            and all(a8_ok(r, uncapped) for r in held_runs)
            and len(held_runs) == 3
            and osnap["shed_total"] == {"interactive": 0, "standard": 1,
                                        "background": 1}
            and rung == 2 and row["capped_is_prefix"]
            and capped["status"] == 200 and row["full_after_recovery"]
            and launches[kernels.decode_attention.NAME] == LAYERS * steps):
        fail(f"serve_a8 overload: {row}")
    return row, launches


def run_serve_a8(torch, dev, transformer, kernels, seed):
    """serve_a8 (see A8_CLIENTS); returns the launches by run."""
    from paddle_tpu_torch.serving import ReplicaSupervisor, Router
    from paddle_tpu_torch.utils.flags import FLAGS
    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 31)
    # the replicas' default emission cap is the router's (a continuation
    # that omits max_tokens is budgeted from the router's FLAGS)
    replica_args = ["--device", dev.type, "--seed", str(seed),
                    "--slots", str(SLOTS), "--max-len", str(SERVE_MAX_LEN),
                    "--max-tokens", str(FLAGS.serving_gen_max_tokens),
                    "--fault-spec", "serving.decode_step:every=1,"
                    f"action=hang,hang_s={A8_PACE_S}"]
    sup = ReplicaSupervisor(n_replicas=2,
                            cmd=("-m", "paddle_tpu_torch.serving"),
                            extra_args=replica_args, backoff_base_s=0.3,
                            seed=seed, name="a8_fleet")
    router = Router(supervisor=sup, poll_interval_s=0.1, eject_threshold=2,
                    eject_cooldown_s=1.0, retry_budget=3, hedge_ms=0,
                    name="a8_router")
    launches = {}
    try:
        t_spawn = time.perf_counter()
        sup.start()
        if not sup.wait_ready(timeout=300):
            fail(f"serve_a8: replicas never ready {a8_replica_logs(sup)}")
        spawn_s = time.perf_counter() - t_spawn
        httpd = router.start(port=0)
        if not a8_wait(lambda: sum(s["ready"] for s in
                                   router.replica_states().values()) == 2,
                       60):
            fail(f"serve_a8: router view {router.replica_states()}")
        fleet, launches["reference"], prompts, oracle = a8_fleet(
            torch, dev, kernels, seed, rng, sup, router, httpd.port)
        fleet["spawn_to_ready_s"] = spawn_s
        drain = a8_drain(sup, router, httpd.port, prompts, oracle)
        params = transformer.init_lm(torch.Generator().manual_seed(seed),
                                     VOCAB, D_MODEL, HEADS, DFF, LAYERS,
                                     SERVE_MAX_LEN, device=dev)
        disagg, launches["handoff_pair"] = a8_disagg(torch, dev, kernels,
                                                     params, rng)
        overload, launches["overload"] = a8_overload(torch, dev, kernels,
                                                     params, rng)
        del params
        autoscale = a8_autoscale(torch, sup, router, httpd.port, prompts,
                                 oracle, seed)
    finally:
        router.close()
        sup.stop()
    emit({"phase": "serve_a8", "fleet": fleet, "drain": drain,
          "disagg": disagg, "overload": overload, "autoscaler": autoscale,
          "seconds": time.perf_counter() - t0})
    return launches


# api_a11: the API surfaces.  (a) demo/seqToseq/v1/train.conf
# through the port's config compiler (compat.parse_config /
# config_to_runtime) at dim 512, batch 48 (A11_ARGS; at train.conf's own
# 50 the encoder GRUs take the scan in both packages), its data files
# written from the wmt14 loader's triples (words s<id> / t<id> over
# 3000-line dictionaries) into a temporary directory the phase works in:
# the parsed graph's layer names and parameter shapes are
# models/seqtoseq_dsl.build()'s; the parsed graph's first step on the
# card and the DSL graph's, from the same weights on the same batch, run
# the same kernels, so their loss and gradients are held to A11_SAME
# (expected 0) and the largest difference reported; then A11_STEPS
# steps, B10 2 + 2 a step and nothing else counted, the first batch's
# loss in test mode after them below its first step's;
# the is_generating=1 parse takes the trained weights by name and
# decodes A11_GEN_ROWS sources (B10 forward 2).  (b) ``cli.main(["train",
# --config train.conf ...])`` in process over a 2-batch list, its
# pass-end test over one batch: B10 2 + 2 a step and 2 forward for the
# test.  (c) a paddle_tpu_torch.v2 script: an lstmemory classifier at
# D 128, B 32 (JAX's resident rule: B9), its first step against a CPU
# run from the same weights within LSTM_REL_TOL, A11_V2_STEPS steps
# through v2.trainer.SGD with B9 1 + 1 a step, parameters.to_tar /
# from_tar bit for bit, v2.infer equal to the trained graph's forward.
# (d) C21: batcher_from_args(parse_args(["--prefill-chunk-budget", "4"]))
# at BASE_LM: 4 streams equal lm_generate up to their first margin below
# MARGIN_TOL, at most 4 prompt lanes a step, B1 LAYERS a step.
A11_DIM, A11_BATCH = 512, 48
A11_ARGS = f"dim={A11_DIM},batch_size={A11_BATCH}"
A11_SAME = 1e-6
A11_STEPS = 3
A11_GEN_ROWS = 8
A11_V2 = dict(vocab=1000, emb=64, d=128, batch=32)
A11_V2_STEPS = 4
A11_BUDGET = 4
A11_PROMPTS = (12, 29, 7, 41)
A11_TOKENS = 16


def a11_data(root):
    """train.conf's data under ``root``: the dictionaries, ``a/`` with
    A11_STEPS + 1 batches of wmt14 train pairs and ``b/`` with two
    (train) and one of wmt14 test pairs (test)."""
    import itertools
    import os
    from paddle_tpu_torch.data.datasets import wmt14

    def lines(reader, n):
        return ["{}\t{}".format(" ".join(f"s{i}" for i in src),
                                " ".join(f"t{i}" for i in trg[1:]))
                for src, trg, _ in itertools.islice(reader(), n)]

    head = ["<s>", "<e>", "<unk>"]
    batch = A11_BATCH
    for sub, train_rows, test_rows in (
            ("a", lines(wmt14.train(), (A11_STEPS + 1) * batch), None),
            ("b", lines(wmt14.train(), 2 * batch),
             lines(wmt14.test(), batch))):
        d = os.path.join(root, sub)
        os.makedirs(d)
        for name, pre in (("src", "s"), ("trg", "t")):
            with open(os.path.join(d, f"{name}.dict"), "w") as f:
                f.write("\n".join(head + [f"{pre}{i}" for i in range(
                    3, wmt14.SRC_DICT_SIZE)]) + "\n")
        for name, rows in (("train", train_rows),
                           ("test", test_rows or train_rows[:batch])):
            with open(os.path.join(d, f"{name}-000"), "w") as f:
                f.write("\n".join(rows) + "\n")
            with open(os.path.join(d, f"{name}.list"), "w") as f:
                f.write(f"{sub}/{name}-000\n")


def a11_grads(torch, dev, cost, optimizer, feeding, start, batch):
    """One step's (trainer, loss, {leaf: gradient}) of ``cost`` from
    ``start`` on ``dev``, the update applied."""
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.trainer import SGD
    from paddle_tpu_torch.utils.tree import tree_leaves
    tr = SGD(cost=cost, parameters=start, update_equation=optimizer,
             device=dev)
    total, _ = tr._forward(DataFeeder(feeding, device=tr.device)(batch))
    view = tr._view
    tr._backward(total)
    grads = dict(zip(leaf_names(view), (p.grad.detach().cpu()
                                        for p in tree_leaves(view))))
    tr._update()
    return tr, float(total.detach()), grads


def a11_diff(got, want):
    """(the loss's relative difference, the worst leaf's difference
    against its largest entry, that leaf)."""
    errs = {n: float((got[2][n] - w).abs().max()) / max(
        float(w.abs().max()), 1e-30) for n, w in want[2].items()}
    worst = max(errs, key=errs.get)
    return abs(got[1] - want[1]) / abs(want[1]), errs[worst], worst


def a11_train_conf(torch, dev, kernels, conf):
    """(a): see api_a11."""
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.compat import config_to_runtime, parse_config
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.models import seqtoseq_dsl as sd
    from paddle_tpu_torch.trainer import SGD
    t0 = time.perf_counter()
    parsed = parse_config(conf, f"{A11_ARGS},data_dir=a")
    cfg = config_to_runtime(parsed)
    batches = list(cfg["train_reader"]())
    topo, dsl = L.Topology(parsed.outputs), sd.build(dim=A11_DIM)
    dtopo = L.Topology(dsl)
    names = [n.name for n in topo.order]
    if names != [n.name for n in dtopo.order] \
            or topo.param_shapes() != dtopo.param_shapes():
        fail(f"api_a11: train.conf's parsed graph is not seqtoseq_dsl's: "
             f"{names} / {sorted(topo.param_shapes())}")
    if len(batches) != A11_STEPS + 1 or cfg["batch_size"] != A11_BATCH:
        fail(f"api_a11: the parsed reader gave {len(batches)} batches of "
             f"{cfg['batch_size']}")
    start = host_tree(SGD(cost=parsed.outputs[0],
                          update_equation=cfg["optimizer"],
                          device="cpu").parameters)
    kernels.reset_launches()
    card = a11_grads(torch, dev, parsed.outputs[0], cfg["optimizer"],
                     cfg["feeding"], start, batches[0])
    first_launches = lstm_gru_counts(kernels)
    per_step = want_counts(kernels, gru_fwd=2, gru_bwd=2)
    if first_launches != per_step:
        fail(f"api_a11 train.conf: the first step launched "
             f"{first_launches}, want {per_step}")
    twin = a11_grads(torch, dev, dsl, sd.optimizer(), sd.feeding(), start,
                     batches[0])
    loss_diff, grad_diff, worst = a11_diff(card, twin)
    if loss_diff > A11_SAME or grad_diff > A11_SAME:
        fail(f"api_a11: the parsed graph's first step differs from "
             f"seqtoseq_dsl's: loss {loss_diff}, {worst} {grad_diff}")
    times, losses, pass_launches = counted_pass(
        torch, kernels, card[0], batches[1:], cfg["feeding"],
        "api_a11 train.conf", [per_step] * A11_STEPS)
    losses = [card[1]] + losses
    # the first batch's loss after the steps, against its loss before
    after = card[0].test(lambda: iter(batches[:1]), feeding=cfg["feeding"])
    if not after < losses[0]:
        fail(f"api_a11 train.conf: the first batch's loss did not fall: "
             f"{losses[0]} -> {after} (steps {losses})")
    # the generation parse, the trained weights by name
    gen = parse_config(conf, f"is_generating=1,{A11_ARGS},data_dir=a")
    gtopo = L.Topology(gen.outputs)
    keys = set(gtopo.param_shapes())
    if not keys <= set(card[0].parameters):
        fail(f"api_a11: the generation parse's keys {sorted(keys)} are not "
             "the trained graph's")
    params = {k: {n: t.detach() for n, t in card[0].parameters[k].items()}
              for k in keys}
    src_type = {"source_language_word": cfg["feeding"][
        "source_language_word"]}
    feed = DataFeeder(src_type, device=dev)(
        [{"source_language_word": s["source_language_word"]}
         for s in batches[0][:A11_GEN_ROWS]])
    torch.cuda.synchronize()
    kernels.reset_launches()
    g0 = time.perf_counter()
    with torch.no_grad():
        res = gtopo.apply(params, feed, mode="test")
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - g0) * 1e3
    gen_launches = lstm_gru_counts(kernels)
    if gen_launches != want_counts(kernels, gru_fwd=2):
        fail(f"api_a11: the generation parse's decode launched "
             f"{gen_launches}, want B10's forward once a direction")
    b, k, t = res.tokens.shape
    scores = res.scores.cpu()
    if (b, k) != (A11_GEN_ROWS, 3) or t > 250 \
            or int(res.tokens.min()) < 0 or int(res.tokens.max()) >= 3000 \
            or not bool(torch.isfinite(scores).all()) \
            or not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        fail(f"api_a11: the decode is malformed: tokens "
             f"{tuple(res.tokens.shape)}, scores {scores}")
    return {
        "config": "demo/seqToseq/v1/train.conf, " + A11_ARGS,
        "layers": len(names), "parameter_keys": len(topo.param_shapes()),
        "parsed_vs_dsl_first_step": {"loss_rel_diff": loss_diff,
                                     "grad_rel_diff_max": grad_diff,
                                     "of": worst, "limit": A11_SAME},
        "losses": losses, "first_batch_loss_after": after,
        "ms_per_step": float(np.median(times)),
        "ms_min_max": [min(times), max(times)],
        "launches_per_step": per_step,
        "decode": {"rows": b, "beam": k, "steps": t, "ms": gen_ms,
                   "best_beam_lengths": res.lengths[:, 0].tolist(),
                   "launches": gen_launches},
        "seconds": time.perf_counter() - t0}, {
        "train_api_a11": add_counts(first_launches, pass_launches),
        "generate_api_a11": gen_launches}


def a11_cli(torch, kernels, conf):
    """(b): see api_a11."""
    from paddle_tpu_torch.trainer import cli
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launches()
    rc = cli.main(["train", "--config", conf, "--config_args",
                   f"{A11_ARGS},data_dir=b", "--num_passes", "1",
                   "--log_period", "1"])
    torch.cuda.synchronize()
    counts = lstm_gru_counts(kernels)
    want = want_counts(kernels, gru_fwd=2 * 2 + 2, gru_bwd=2 * 2)
    if rc != 0 or counts != want:
        fail(f"api_a11 cli: exit {rc}, launches {counts}, want {want} "
             "(2 steps of 2 + 2, the pass-end test's 2 forward)")
    return {"exit": rc, "launches": counts,
            "seconds": time.perf_counter() - t0}, counts


def a11_v2(torch, dev, kernels, seed):
    """(c): see api_a11."""
    import io
    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.layers.graph import Topology, reset_names
    from paddle_tpu_torch.utils.tree import tree_leaves
    t0 = time.perf_counter()
    v, e, d, b = (A11_V2[k] for k in ("vocab", "emb", "d", "batch"))
    rng = np.random.RandomState(seed + 43)
    samples = []
    for _ in range((A11_V2_STEPS + 1) * b):
        ids = rng.randint(0, v, rng.randint(5, 41))
        samples.append((ids.tolist(), int((ids < v // 20).any())))
    batches = [samples[i * b:(i + 1) * b] for i in range(A11_V2_STEPS + 1)]
    reset_names()
    word = paddle.layer.data("word", size=v, is_seq=True)
    emb = paddle.layer.embedding(word, size=e)
    proj = paddle.layer.fc(emb, size=4 * d, act=None)
    lstm = paddle.layer.lstmemory(proj)
    pool = paddle.layer.pooling(lstm, pooling_type=paddle.pooling.Max)
    prob = paddle.layer.fc(pool, size=2, act=paddle.activation.Softmax)
    cost = paddle.layer.classification_cost(
        prob, paddle.layer.data("label", size=2))
    feeding = {"word": paddle.data_type.integer_value_sequence(v),
               "label": paddle.data_type.integer_value(2)}
    params = paddle.parameters.create(cost, seed=seed)
    start = host_tree(params.tree)
    kernels.reset_launches()
    card = a11_grads(torch, dev, cost, paddle.optimizer.Adam(
        learning_rate=2e-3), feeding, start, batches[0])
    per_step = want_counts(kernels, lstm_fwd=1, lstm_bwd=1)
    if lstm_gru_counts(kernels) != per_step:
        fail(f"api_a11 v2: the first step launched "
             f"{lstm_gru_counts(kernels)}, want {per_step}")
    cpu = a11_grads(torch, "cpu", cost, paddle.optimizer.Adam(
        learning_rate=2e-3), feeding, start, batches[0])
    loss_diff, grad_diff, worst = a11_diff(card, cpu)
    if loss_diff > LSTM_REL_TOL or grad_diff > LSTM_REL_TOL:
        fail(f"api_a11 v2: the card's first step against the CPU: loss "
             f"{loss_diff}, {worst} {grad_diff}")
    trainer = paddle.trainer.SGD(cost, parameters=params,
                                 update_equation=paddle.optimizer.Adam(
                                     learning_rate=2e-3))
    times, losses, step_launches = counted_pass(
        torch, kernels, trainer, batches[:A11_V2_STEPS], feeding,
        "api_a11 v2", [per_step] * A11_V2_STEPS)
    buf = io.BytesIO()
    params.to_tar(buf)
    buf.seek(0)
    flat = paddle.parameters.Parameters.from_tar(buf)
    buf.seek(0)
    back = paddle.parameters.Parameters.from_tar(buf, like=params)
    if sorted(flat) != sorted(params.names()) or not all(
            np.array_equal(flat[n], params[n]) for n in params.names()) \
            or not all(torch.equal(x, y) for x, y in zip(
                tree_leaves(back.tree), tree_leaves(trainer.parameters))):
        fail("api_a11 v2: the parameters tar does not round-trip the "
             "card's parameters bit for bit")
    rows = [{"word": ids} for ids, _ in batches[-1]]
    kernels.reset_launches()
    out = paddle.infer(output_layer=prob, parameters=params, input=rows,
                       feeding={"word": feeding["word"]})
    infer_launches = lstm_gru_counts(kernels)
    with torch.no_grad():
        ref = Topology(prob).apply(params.tree, DataFeeder(
            {"word": feeding["word"]}, device=dev)(rows), mode="test")
    infer_diff = float((out - ref).abs().max())
    if out.device.type != "cuda" or tuple(out.shape) != (b, 2) \
            or infer_diff > A11_SAME \
            or infer_launches != want_counts(kernels, lstm_fwd=1):
        fail(f"api_a11 v2: infer {tuple(out.shape)} on {out.device}, "
             f"{infer_diff} from the forward, launches {infer_launches}")
    return {"shape": {"vocab": v, "emb": e, "D": d, "B": b},
            "first_step_vs_cpu": {"loss_rel_err": loss_diff,
                                  "grad_rel_err_max": grad_diff,
                                  "of": worst, "tolerance": LSTM_REL_TOL},
            "losses": losses, "ms_per_step": float(np.median(times)),
            "launches_per_step": per_step,
            "tar_round_trip_bit_for_bit": True, "tar_bytes": len(
                buf.getvalue()),
            "infer_max_abs_diff": infer_diff,
            "infer_launches": infer_launches,
            "seconds": time.perf_counter() - t0}, add_counts(
                {**per_step}, step_launches)


def a11_budget(torch, transformer, kernels, seed):
    """(d): see api_a11; returns its readings and B1's launches."""
    from paddle_tpu_torch.serving import server
    t0 = time.perf_counter()
    args = server.parse_args(["--prefill-chunk-budget", str(A11_BUDGET),
                              "--max-tokens", str(A11_TOKENS),
                              "--seed", str(seed)])
    gen = server.batcher_from_args(args)
    eng = gen.engine
    rng = np.random.RandomState(seed + 47)
    prompts = [rng.randint(3, VOCAB, n).tolist() for n in A11_PROMPTS]
    try:
        if (args.prefill_chunk_budget, eng.prefill_chunk_budget,
                eng.prefill_chunk) != (A11_BUDGET, A11_BUDGET, CHUNK):
            fail(f"api_a11: --prefill-chunk-budget did not reach the engine "
                 f"({eng.prefill_chunk_budget})")
        steps0 = eng.metrics.snapshot()["decode_steps_total"]
        lanes0 = eng.metrics.prefill_lane_steps_total
        torch.cuda.synchronize()
        kernels.reset_launches()
        futs = [gen.submit(p, max_tokens=A11_TOKENS) for p in prompts]
        outs = [f.result(timeout=300)["tokens"] for f in futs]
        torch.cuda.synchronize()
        counts = launch_counts(kernels)
        others = sum(counts.values()) + recurrent_launches(kernels) \
            - counts["decode_attention_slab_chunk"]
        steps = eng.metrics.snapshot()["decode_steps_total"] - steps0
        lanes = eng.metrics.prefill_lane_steps_total - lanes0
        b1 = counts["decode_attention_slab_chunk"]
        if b1 != LAYERS * steps or others:
            fail(f"api_a11 budget: B1 {b1} in {steps} steps, want {LAYERS} "
                 f"a step and nothing else ({others})")
        if not 0 < lanes <= A11_BUDGET * steps:
            fail(f"api_a11 budget: {lanes} prompt lanes in {steps} steps "
                 f"over a budget of {A11_BUDGET}")
        checked = check_streams(torch, transformer, eng.params, prompts,
                                outs, "api_a11 budget")
    finally:
        gen.close()
    return {"budget": A11_BUDGET, "prompts": list(A11_PROMPTS),
            "tokens": A11_TOKENS, "steps": steps, "prompt_lanes": lanes,
            "b1_launches": b1, "tokens_checked": checked,
            "tokens_total": A11_TOKENS * len(prompts),
            "seconds": time.perf_counter() - t0}, b1


def run_api_a11(torch, dev, transformer, kernels, seed):
    """api_a11 (see A11_ARGS); returns the B9 / B10 launches by run and
    B1's."""
    import os
    import tempfile
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo",
                        "seqToseq", "v1", "train.conf")
    t0 = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        a11_data(tmp)
        os.chdir(tmp)
        try:
            train, launches = a11_train_conf(torch, dev, kernels, conf)
            cli_run, launches["cli_api_a11"] = a11_cli(torch, kernels, conf)
        finally:
            os.chdir(cwd)
    v2_run, launches["v2_api_a11"] = a11_v2(torch, dev, kernels, seed)
    budget, b1 = a11_budget(torch, transformer, kernels, seed)
    emit({"phase": "api_a11", "train_conf": train, "cli": cli_run,
          "v2": v2_run, "prefill_chunk_budget": budget,
          "seconds": time.perf_counter() - t0})
    return launches, b1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from paddle_tpu_torch import device as _device
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import kernels
    dev = _device.resolve("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _device.card()
    emit({"phase": "device", "kind": kind, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # every library and the probes' 3xTF32 controls, all nvcc at once
    from paddle_tpu_torch.scripts import (probe_flash, probe_gru,
                                          probe_simple_rnn)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        jobs = (pool.submit(kernels.build),
                pool.submit(probe_simple_rnn.build, ["kernel", "tf32_1x"]),
                pool.submit(probe_gru.build, ["kernel", "tf32_1x"]),
                pool.submit(probe_flash.build, ["tf32_1x"]))
        libs, rnn_libs, gru_libs, flash_libs = (job.result() for job in jobs)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs),
          "probe_variants": {"simple_rnn": sorted(rnn_libs),
                             "gru": sorted(gru_libs),
                             "flash": sorted(flash_libs)},
          "flash_wide_ptxas": {
              name: rep for name, rep in flash_libs["tf32_1x"][1].items()
              if int(name.split("/dh")[1].split("/")[0]) > 128}})

    rng = np.random.RandomState(args.seed)
    chunk = check_decode_kernel(torch, dev, rng, hkv=HEADS)
    chunk_gqa = check_decode_kernel(torch, dev, rng, hkv=2)
    flash = check_flash_kernel(torch, dev, rng, GEN_BATCH, GEN_PROMPT,
                               timed=True)
    flash_ragged = check_flash_kernel(torch, dev, rng, 4, 200, timed=False)
    lstm_fwd, lstm_bwd = check_lstm_kernels(torch, dev, rng, LSTM_T, LSTM_B,
                                            LSTM_D, timed=True)
    lstm_other = [row for t, b, d in LSTM_OTHER
                  for row in check_lstm_kernels(torch, dev, rng, t, b, d,
                                                timed=False)]
    lstm_control = check_lstm_tf32_control(torch, dev)
    paged = check_paged_kernels(torch, dev, rng, hkv=HEADS)
    paged_gqa = check_paged_kernels(torch, dev, rng, hkv=2)
    int8 = check_int8_decode_kernels(torch, dev, rng, hkv=HEADS)
    int8_gqa = check_int8_decode_kernels(torch, dev, rng, hkv=2)
    split = check_split_kernels(torch, dev, rng)
    tq1 = check_split_kernels(torch, dev, rng, tq1=True)
    tq1_gqa = check_split_kernels(torch, dev, rng, tq1=True, hkv=2)
    # the Tq=1 instances the 2-head ladder's steps launch (dh 256)
    tq1_wide = check_split_kernels(torch, dev, rng, tq1=True, h=WIDE_HEADS,
                                   hkv=WIDE_HEADS)
    # the device time alone beside the wrapper-timed ms of each row
    dk = kernels.decode_attention
    for row, alone in (
            (chunk, split), (paged[dk.NAME_PAGED_CHUNK], split),
            (int8[dk.NAME_I8], split), (int8[dk.NAME_PAGED_CHUNK_I8], split),
            (paged[dk.NAME_SLAB], tq1), (paged[dk.NAME_PAGED], tq1),
            (int8[dk.NAME_SLAB_I8], tq1), (int8[dk.NAME_PAGED_I8], tq1)):
        row.update({key: alone[row["name"]][key]
                    for key in ("device_ms", "library_device_ms")})
    flash_q = check_flash_quant_kernel(torch, dev, rng, GEN_BATCH,
                                       GEN_PROMPT, HEADS, timed=True)
    flash_q_ragged = check_flash_quant_kernel(torch, dev, rng, 4, 200, 2,
                                              timed=False)
    flash_train, flash_bwd, flash_bwd_checks = check_flash_train(torch, dev,
                                                                 rng)
    flash_wide = check_flash_wide(torch, dev, rng, flash_libs["tf32_1x"][0])
    flash_q_wide = check_flash_quant_kernel(
        torch, dev, rng, WIDE_B, WIDE_T, WIDE_H, timed=True, h=WIDE_H,
        dh=D_MODEL // WIDE_HEADS)
    (gru_fwd, gru_bwd), gru_other = check_gru_kernels(torch, dev, rng,
                                                      gru_libs)
    blk_timed, blk_other, blk_probe = check_blocked_kernel(torch, dev, rng)
    (rnn_fwd, rnn_bwd), rnn_other = check_rnn_kernels(torch, dev, rng,
                                                      rnn_libs)
    # the bf16 and float16 instances, on their own draws (the phases
    # above and below keep theirs)
    bf16_rows = check_low_instances(torch, dev,
                                    np.random.RandomState(args.seed + 18),
                                    BF16_PAIRS)
    f16_rows = check_low_instances(torch, dev,
                                   np.random.RandomState(args.seed + 20),
                                   F16_PAIRS)
    attn_rows = check_attention_low(torch, dev,
                                    np.random.RandomState(args.seed + 21))
    attn_f16_rows = check_attention_low(
        torch, dev, np.random.RandomState(args.seed + 24), "float16")
    emit({"phase": "kernels", "tolerance": KERNEL_TOL,
          "lstm_blocked_3xtf32_tolerance": BLK_TC_TOL,
          "int8_vs_f32_kernel_on_dequantized": "bit for bit (max abs err 0)",
          "lstm_tolerance": {"abs": LSTM_TOL, "rel": LSTM_REL_TOL,
                             "3xtf32": LSTM_TC_TOL},
          "checks": [chunk, chunk_gqa, flash, flash_ragged, lstm_fwd,
                     lstm_bwd, *lstm_other, *paged.values(),
                     *paged_gqa.values(), *int8.values(),
                     *int8_gqa.values(), flash_q, flash_q_ragged],
          "flash_train_shape": {"forward": list(flash_train.values()),
                                "backward": [r for rows in flash_bwd.values()
                                             for r in rows.values()],
                                "backward_checks": flash_bwd_checks,
                                "backward_rel_tolerance": MT_REL_TOL},
          "split_kv_chunk_kernels": list(split.values()),
          "split_kv_tq1_kernels": [*tq1.values(), *tq1_gqa.values(),
                                   *tq1_wide.values()],
          "flash_wide": {"tolerance_3xtf32": WIDE_TC_TOL,
                         "rows": flash_wide,
                         "flash_attention_quant": flash_q_wide},
          "other_head_dims": check_head_dims(torch, dev, rng),
          "lstm_3xtf32_control": lstm_control,
          "lstm_reverse": check_lstm_reverse(torch, dev, rng, kernels),
          "lstm_scan": check_lstm_scan(torch, dev, rng, kernels),
          "lstm_blocked_train_shape": list(blk_timed.values()),
          "lstm_blocked_other": blk_other,
          "lstm_blocked_gain_probe": blk_probe,
          "gru_3xtf32_tolerance": GRU_TC_TOL,
          "gru_train_shape": [gru_fwd, gru_bwd], "gru_other": gru_other,
          "gru_3xtf32_control": check_gru_tf32_control(torch, dev,
                                                       gru_libs),
          "gru_reverse": check_gru_reverse(torch, dev, rng, kernels),
          "gru_barrier": check_gru_barrier(torch),
          "simple_rnn_3xtf32_tolerance": RNN_TC_TOL,
          "simple_rnn_train_shape": [rnn_fwd, rnn_bwd],
          "simple_rnn_other": rnn_other,
          "simple_rnn_3xtf32_control": check_rnn_tf32_control(
              torch, dev, rnn_libs),
          "simple_rnn_routes": check_rnn_routes(torch, dev, rng, kernels),
          "bf16_f32_floor": BF16_F32_FLOOR, "bf16_instances": bf16_rows,
          "rnn_f16": f16_rows, "attention_bf16": attn_rows,
          "attention_f16": attn_f16_rows})

    emit(check_flash_padded(torch, dev, rng, kernels))

    params = transformer.init_lm(
        torch.Generator().manual_seed(args.seed), VOCAB, D_MODEL, HEADS,
        DFF, LAYERS, SERVE_MAX_LEN, device=dev)
    gen_launches = run_generate(torch, dev, transformer, kernels, params,
                                rng)
    serve_launches = run_serve(torch, dev, transformer, kernels, params,
                               rng)
    paged_launches = run_serve_paged(torch, dev, transformer, kernels,
                                     params, rng)
    ladder_launches = run_ladder(torch, dev, transformer, kernels, params,
                                 rng)
    gen8_launches = run_generate_int8(torch, dev, transformer, kernels,
                                      params, rng)
    serve8_launches = run_serve(torch, dev, transformer, kernels, params,
                                rng, kv_dtype="int8")
    paged8_launches = run_serve_paged_int8(torch, dev, transformer, kernels,
                                           params, rng)
    ladder8_launches = run_ladder(torch, dev, transformer, kernels, params,
                                  rng, kv_dtype="int8")
    w8_launches = run_serve_w8(torch, dev, transformer, kernels, params,
                               args.seed, rng)
    spec_launches = run_serve_spec(torch, dev, transformer, kernels, params,
                                   args.seed, rng)
    del params
    moe_launches = run_serve_moe(torch, dev, transformer, kernels, args.seed,
                                 rng)
    # the same ladder at D 512 over 2 heads (dh 256: the wide flash
    # instances in the prefill, the Tq=1 kernels at that width), depth cut
    params = transformer.init_lm(
        torch.Generator().manual_seed(args.seed), VOCAB, D_MODEL,
        WIDE_HEADS, DFF, WIDE_LAYERS, SERVE_MAX_LEN, device=dev)
    wide_launches = {
        kv: run_ladder(torch, dev, transformer, kernels, params, rng,
                       kv_dtype=kv, heads=WIDE_HEADS, layers=WIDE_LAYERS,
                       layouts=("slab",))["slab"]
        for kv in ("float32", "int8")}
    del params
    train_launches = run_train(torch, dev, kernels)
    blk_launches = {h: run_train(torch, dev, kernels, hidden=h,
                                 check_batch=b)
                    for h, b in ((1280, None), (2048, 8))}
    mt_launches = run_train_transformer(torch, dev, kernels)
    lm_train_launches = {f"train_{kind}": run_train_lm(torch, dev, kernels,
                                                       kind)
                         for kind in ("packed", "moe")}
    lm_train_launches["train_remat"] = run_train_remat(torch, dev, kernels)
    s2s_launches = run_train_seq2seq(torch, dev, kernels)
    rnn_launches = run_train_rnn(torch, dev, kernels, args.seed)
    run_train_int8(torch, dev, kernels)
    bf16_runs = {
        "train_rnn_bf16": run_train_rnn_bf16(torch, dev, kernels, args.seed),
        "train_dsl_bf16": run_train_dsl_bf16(torch, dev, kernels, args.seed),
        "rnn_ops_bf16": run_rnn_ops_low(
            torch, dev, kernels, np.random.RandomState(args.seed + 19),
            (("bfloat16", "float32"),), "rnn_ops_bf16")}
    run_train_transformer_bf16(torch, dev, kernels,
                               F32_MS["train_transformer"])
    f16_runs = {
        "train_dsl_f16": run_train_dsl_f16(torch, dev, kernels, args.seed),
        # the pairs no float16 policy feeds: direct calls
        "rnn_ops_f16": run_rnn_ops_low(
            torch, dev, kernels, np.random.RandomState(args.seed + 22),
            F16_PAIRS[2:], "rnn_ops_f16", steps=F16_OPS_T)}
    attn_launches = run_attention_ops_low(
        torch, dev, kernels, np.random.RandomState(args.seed + 23))
    attn_f16_launches = run_attention_ops_low(
        torch, dev, kernels, np.random.RandomState(args.seed + 25),
        "float16")
    mt_decode_launches = run_generate_mt(torch, dev, kernels)
    s2g_launches = run_generate_seq2seq(torch, dev, kernels)
    run_train_resnet50(torch, dev, kernels)
    run_train_lenet(torch, dev, kernels, args.seed)
    run_train_image(torch, dev, kernels)
    run_train_resnet_cifar(torch, dev, kernels)
    run_train_recommendation(torch, dev, kernels)
    run_train_vgg_cifar(torch, dev, kernels)
    text_launches = run_train_sentiment(torch, dev, kernels, args.seed)
    a9c_launches = run_trainer_a9c(torch, dev, kernels, args.seed)
    srl_launches = run_train_srl(torch, dev, kernels, args.seed)
    run_train_crf_demos(torch, dev, kernels)
    run_layers_a10b(torch, dev, kernels, args.seed)
    run_train_word2vec(torch, dev, kernels, args.seed)
    s2d_launches = run_train_seqtoseq_demo(torch, dev, kernels)
    sparse_launches = run_train_sparse(torch, dev, kernels, args.seed)
    nested_launches = run_nested_a9f(torch, dev, kernels)
    run_trainer_prefetch(torch, dev, kernels)
    group_launches = run_train_lstm_group(torch, dev, kernels, args.seed)
    item1b = {**run_seqtoseq_v1(torch, dev, kernels),
              **run_nested_group(torch, dev, kernels, args.seed),
              **run_recurrence_1b(torch, dev, kernels, args.seed)}
    demo_launches = run_demos_a14(torch, dev, kernels)
    a5_launches = run_host_a5(torch, dev, kernels, args.seed)
    a6b_launches = run_serve_a6b(torch, dev, transformer, kernels, args.seed)
    a7_launches = run_serve_a7(torch, dev, transformer, kernels, args.seed)
    a8_launches = run_serve_a8(torch, dev, transformer, kernels, args.seed)
    a11_launches, a11_b1 = run_api_a11(torch, dev, transformer, kernels,
                                       args.seed)

    summary = []
    for row, mod, launches in (
            (chunk, kernels.decode_attention,
             serve_launches["decode_attention_slab_chunk"]),
            (flash, kernels.flash_attention,
             gen_launches["flash_attention"])):
        summary.append({
            "name": mod.NAME, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **{key: row[key] for key in DEVICE_KEYS if key in row}})
    summary[0]["launches_api_a11"] = a11_b1
    summary[0]["launches_host_a5"] = {
        run: n["decode_attention_slab_chunk"]
        for run, n in a5_launches.items()
        if n["decode_attention_slab_chunk"]}
    summary[-1]["launches_dh256"] = wide_launches["float32"]["flash_attention"]
    summary[-1]["launches_demos_a14"] = demo_launches["flash_attention"]
    summary[-1]["launches_host_a5"] = {
        run: n["flash_attention"] for run, n in a5_launches.items()
        if n["flash_attention"]}
    # the MT beam decode's encoder attends under its key mask: the dense
    # path, as JAX's (MTD_FLASH launches)
    summary[-1]["launches_generate_mt"] = mt_decode_launches[
        "flash_attention"]
    # the forward on the train path: its launches in train_transformer
    # and its non-causal time at the train shape beside the prefill row
    train_fwd = flash_train[False]
    summary[-1]["train"] = {
        "launches": mt_launches[kernels.flash_attention.NAME],
        "shape": {"B": MT_BATCH, "H": MT_HEADS, "T": MT_SEQ, "dh": MT_DH,
                  "causal": False},
        **{key: train_fwd[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "causal": {key: flash_train[True][key] for key in (
            "ms", "bound_ms", "bound_by", "library_ms")}}
    fk = kernels.flash_attention
    for name, replaces in ((fk.NAME_BWD_DKV, fk.REPLACES_BWD_DKV),
                           (fk.NAME_BWD_DQ, fk.REPLACES_BWD_DQ)):
        row, causal_row = flash_bwd[name][False], flash_bwd[name][True]
        summary.append({
            "name": name, "route": "cuda", "source": fk.SOURCE,
            "replaces": replaces, "launches": mt_launches[name],
            "max_abs_err": max(row["max_abs_err"],
                               causal_row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {"B": MT_BATCH, "H": MT_HEADS, "T": MT_SEQ,
                      "dh": MT_DH, "causal": False},
            "causal": {key: causal_row[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "library_note": "scaled_dot_product_attention's backward alone "
                            "(autograd.grad over a retained graph): it "
                            "computes dq, dk and dv together, so the same "
                            "time stands on both rows; plain_ms likewise "
                            "is the whole plain backward"})
    # the wide instances at WIDE_B, WIDE_H, WIDE_T: on the forward row
    # and the two backward rows
    for row, key in ((summary[1], "fwd"), (summary[2], "dkv"),
                     (summary[3], "dq")):
        row["wide"] = [{"dh": w["dh"], "causal": w["causal"],
                        "sdpa_backend": w["sdpa_backend"],
                        **{k: w[key][k] for k in (
                            "max_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}}
                       for w in flash_wide]
    for row, replaces in ((lstm_fwd, kernels.lstm.REPLACES_FWD),
                          (lstm_bwd, kernels.lstm.REPLACES_BWD)):
        name = row["name"]
        by_path = {"train": train_launches[name],
                   **{path: n[name] for path, n in text_launches.items()},
                   **{path: n[name] for path, n in a9c_launches.items()},
                   **{path: n[name] for path, n in srl_launches.items()},
                   **{path: n[name] for path, n in sparse_launches.items()},
                   **{path: n[name] for path, n in nested_launches.items()},
                   **{path: n[name] for path, n in group_launches.items()},
                   **{path: n[name] for path, n in item1b.items()
                      if n[name]},
                   **{path: n[name] for path, n in a11_launches.items()
                      if n[name]}}
        summary.append({
            "name": name, "route": "cuda",
            "source": kernels.lstm.SOURCE, "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max([row["max_abs_err"]]
                               + [r["max_abs_err"] for r in lstm_other
                                  if r["name"] == name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "library_note": row["library_note"],
            "shape": row["shape"],
            **({"dW_r_ms": row["split"]["dW_r_ms"]}
               if "split" in row else {})})
    bk = kernels.lstm_blocked
    row = blk_timed[BLK_TIMED[0]]
    summary.append({
        "name": bk.NAME_FWD, "route": "cuda", "source": bk.SOURCE,
        "replaces": bk.REPLACES_FWD,
        "launches": sum(n[bk.NAME_FWD] for n in blk_launches.values()),
        "launches_by_path": {f"train_lstm{h}": n[bk.NAME_FWD]
                             for h, n in blk_launches.items()},
        "max_abs_err": max([r["max_abs_err"] for r in blk_timed.values()]
                           + [r["max_abs_err"] for r in blk_other]),
        **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "library_note")},
        "shape": {"T": BLK_T, "B": BLK_B, "D": BLK_TIMED[0]},
        **{f"D{d}": {key: r[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
           for d, r in blk_timed.items() if d != BLK_TIMED[0]}})
    for row, replaces in ((gru_fwd, kernels.gru.REPLACES_FWD),
                          (gru_bwd, kernels.gru.REPLACES_BWD)):
        name = row["name"]
        summary.append({
            "name": name, "route": "cuda", "source": kernels.gru.SOURCE,
            "replaces": replaces,
            "launches": s2s_launches["train"][name]
            + s2s_launches["generate"][name] + s2g_launches[name]
            + s2d_launches["train"][name] + s2d_launches["generate"][name]
            + group_launches["train_lstm_group"][name]
            + sum(n[name] for n in item1b.values())
            + sum(n[name] for n in a11_launches.values()),
            "launches_by_path": {
                **{path: n[name] for path, n in s2s_launches.items()},
                "generate_seq2seq": s2g_launches[name],
                **{f"{path}_seqtoseq_demo": n[name]
                   for path, n in s2d_launches.items()},
                "train_lstm_group": group_launches["train_lstm_group"][name],
                **{path: n[name] for path, n in item1b.items() if n[name]},
                **{path: n[name] for path, n in a11_launches.items()
                   if n[name]}},
            "shape_seqtoseq_demo": {"T": "3-29, ragged", "B": S2D_BATCH,
                                    "D": S2D_HIDDEN},
            "max_abs_err": max([row["max_abs_err"]]
                               + [r["max_abs_err"] for r in gru_other
                                  if r["name"] == name]),
            **({"rel_err": {key: max([row["rel_err"][key]]
                                     + [r["rel_err"][key] for r in gru_other
                                        if r["name"] == name])
                            for key in row["rel_err"]}}
               if name == kernels.gru.NAME_BWD else {}),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "library_note")},
            **({"dW_ms": row["split"]["dW_ms"]}
               if name == kernels.gru.NAME_BWD else {}),
            "shape": row["shape"]})
    for row, replaces in ((rnn_fwd, kernels.simple_rnn.REPLACES_FWD),
                          (rnn_bwd, kernels.simple_rnn.REPLACES_BWD)):
        name = row["name"]
        summary.append({
            "name": name, "route": "cuda",
            "source": kernels.simple_rnn.SOURCE, "replaces": replaces,
            "launches": rnn_launches[name],
            "max_abs_err": max([row["max_abs_err"]]
                               + [r["max_abs_err"] for r in rnn_other
                                  if r["name"] == name]),
            **({key: max([row[key]] + [r[key] for r in rnn_other
                                       if r["name"] == name])
                for key in ("dxs_rel_err", "dW_rel_err")}
               if name == kernels.simple_rnn.NAME_BWD else {}),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "library_note")},
            **({"dW_ms": row["split"]["dW_ms"]} if "split" in row else {}),
            "shape": row["shape"]})
    for name, replaces, launches in (
            (dk.NAME_SLAB, dk.REPLACES_SLAB,
             ladder_launches["slab"][dk.NAME_SLAB]),
            (dk.NAME_PAGED, dk.REPLACES_PAGED,
             ladder_launches["paged"][dk.NAME_PAGED]),
            (dk.NAME_PAGED_CHUNK, dk.REPLACES_PAGED_CHUNK,
             paged_launches[dk.NAME_PAGED_CHUNK])):
        row = paged[name]
        summary.append({
            "name": name, "route": "cuda", "source": dk.SOURCE,
            "replaces": replaces, "launches": launches,
            **({"launches_dh256": wide_launches["float32"][name],
                "launches_host_a5": {
                    run: n[name] for run, n in a5_launches.items()
                    if n[name]},
                "dh256": {key: tq1_wide[name][key] for key in (
                    "max_abs_err", "device_ms")}}
               if name == dk.NAME_SLAB else {}),
            "max_abs_err": max(row["max_abs_err"],
                               paged_gqa[name]["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            **{key: row[key] for key in DEVICE_KEYS if key in row},
            **({"library_note": row["library_note"]}
               if "library_note" in row else {})})
    for name, replaces, launches, row, gqa in (
            (dk.NAME_I8, dk.REPLACES, serve8_launches[dk.NAME_I8],
             int8[dk.NAME_I8], int8_gqa[dk.NAME_I8]),
            (dk.NAME_SLAB_I8, dk.REPLACES_SLAB,
             ladder8_launches["slab"][dk.NAME_SLAB_I8],
             int8[dk.NAME_SLAB_I8], int8_gqa[dk.NAME_SLAB_I8]),
            (dk.NAME_PAGED_I8, dk.REPLACES_PAGED,
             ladder8_launches["paged"][dk.NAME_PAGED_I8],
             int8[dk.NAME_PAGED_I8], int8_gqa[dk.NAME_PAGED_I8]),
            (dk.NAME_PAGED_CHUNK_I8, dk.REPLACES_PAGED_CHUNK,
             paged8_launches[dk.NAME_PAGED_CHUNK_I8],
             int8[dk.NAME_PAGED_CHUNK_I8], int8_gqa[dk.NAME_PAGED_CHUNK_I8]),
            (fk.NAME_QUANT, fk.REPLACES_QUANT, gen8_launches[fk.NAME_QUANT],
             flash_q, flash_q_ragged)):
        summary.append({
            "name": name, "route": "cuda",
            "source": fk.SOURCE if name == fk.NAME_QUANT else dk.SOURCE,
            "replaces": replaces, "launches": launches,
            **({"launches_dh256": wide_launches["int8"][name]}
               if name in (dk.NAME_SLAB_I8, fk.NAME_QUANT) else {}),
            **({"dh256": {key: tq1_wide[name][key] for key in (
                "max_abs_err", "err_vs_f32_kernel_on_dequantized",
                "device_ms")}} if name == dk.NAME_SLAB_I8 else {}),
            "max_abs_err": max(row["max_abs_err"], gqa["max_abs_err"]),
            "err_vs_f32_kernel_on_dequantized": max(
                row["err_vs_f32_kernel_on_dequantized"],
                gqa["err_vs_f32_kernel_on_dequantized"]),
            "ms": row["ms"], "f32_kernel_ms": row["f32_kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            **{key: row[key] for key in DEVICE_KEYS if key in row},
            "library_note": row["library_note"]})
    summary[-1]["dh256"] = {key: flash_q_wide[key] for key in (
        "shape", "max_abs_err", "ms", "f32_kernel_ms", "plain_ms",
        "bound_ms", "bound_by")}
    # the int8-weight, speculative and MoE serving phases' launches, by
    # row, and the packed, MoE and remat train phases' flash launches
    for row in summary:
        extra = {}
        for phase, runs in (("serve_w8", w8_launches),
                            ("serve_spec", spec_launches),
                            ("serve_moe", moe_launches)):
            n = sum(got.get(row["name"], 0) for got in runs.values())
            if phase in ("serve_w8", "serve_moe") and row["name"] in (
                    fk.NAME, fk.NAME_QUANT):
                # the oracle's prefill: float32 KV (slab), int8 (paged)
                n = runs["slab_f32kv" if row["name"] == fk.NAME
                         else "paged_i8kv"]["oracle_flash"]
            if n:
                extra[phase] = n
        if extra:
            row["launches_serving_variants"] = extra
        if row["name"] in (fk.NAME, fk.NAME_BWD_DKV, fk.NAME_BWD_DQ):
            row["launches_train_variants"] = {
                phase: got[row["name"]]
                for phase, got in lm_train_launches.items()}
    # the bf16 and float16 instances of the recurrent kernels, launched
    # by the bf16 and float16 train and ops phases; the bf16 instances of
    # the attention kernels, by attention_ops_bf16
    for rows, runs in ((bf16_rows, bf16_runs), (f16_rows, f16_runs),
                       (attn_rows, {"attention_ops_bf16": attn_launches}),
                       (attn_f16_rows,
                        {"attention_ops_f16": attn_f16_launches})):
        for row in rows:
            by_path = {phase: n[row["name"]] for phase, n in runs.items()
                       if row["name"] in n}
            summary.append({
                **{key: row[key] for key in (
                    "name", "route", "source", "replaces", "max_abs_err",
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "shape") + tuple(k for k in (
                        "library_note", "f32_instance_ms", "wide", "dh256")
                        if k in row)},
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "low_outputs_differ_share": {
                    o: e["differ_share"] for o, e in row["outputs"].items()
                    if "differ_share" in e},
                "bound_bf16_tensor_core_ms": row["bound_bf16_tensor_core_ms"]})
            if not summary[-1]["launches"]:
                fail(f"{row['name']}: its phases never launched it")
    # the serving-substrate phases' launches, by run, on every row they
    # launched; B1, B2, B3, B4, 6d and B9 must show
    for row in summary:
        for phase, runs in (("serve_a6b", a6b_launches),
                            ("serve_a7", a7_launches),
                            ("serve_a8", a8_launches)):
            by_run = {run: n[row["name"]] for run, n in runs.items()
                      if n.get(row["name"])}
            if by_run:
                row[f"launches_{phase}"] = by_run
    for name in (dk.NAME, dk.NAME_SLAB, fk.NAME, dk.NAME_PAGED_CHUNK,
                 dk.NAME_PAGED_CHUNK_I8, kernels.lstm.NAME_FWD):
        row = next(r for r in summary if r["name"] == name)
        if not (row.get("launches_serve_a6b") or row.get(
                "launches_serve_a7")):
            fail(f"{name}: serve_a6b / serve_a7 never launched it")
    # serve_a8: B1 by the in-process reference and slab engines, B4 by
    # the prefill/decode pair
    for name in (dk.NAME, dk.NAME_PAGED_CHUNK):
        row = next(r for r in summary if r["name"] == name)
        if not row.get("launches_serve_a8"):
            fail(f"{name}: serve_a8 never launched it")
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
