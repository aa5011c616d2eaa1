#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,causal_bwd,train,train_parity
    python3 chip_smoke.py --phases build,paged_verify,paged_int8,\
engine_spec,spec_parity,engine_int8
    python3 chip_smoke.py --phases build,shortseq_fwd,shortseq_bwd,\
bert_train,bert_parity
    python3 chip_smoke.py --phases build,conv_fwd,resnet_infer,resnet_parity
    python3 chip_smoke.py --phases build,conv_train,resnet_train,\
resnet_train_parity
    python3 chip_smoke.py --phases build,sdpa_fwd,transformer_infer,\
transformer_parity
    python3 chip_smoke.py --phases build,sdpa_bwd,optimizer_update,\
transformer_train,transformer_train_parity
    python3 chip_smoke.py --phases build,optimizer_update,train_accum,\
train_accum_parity,bert_lamb
    python3 chip_smoke.py --phases build,sampling,int8_linear,\
engine_sampled,engine_wint8
    python3 chip_smoke.py --phases build,lora,engine,engine_bucketed,\
engine_lora
    python3 chip_smoke.py --phases build,tp_parity,engine_tp
    python3 chip_smoke.py --phases build,int8_linear,engine_wint8
    python3 chip_smoke.py --phases build,sdpa_bwd,transformer_train,\
transformer_train_parity
    python3 chip_smoke.py --phases build,paddle_api,paddle_program
    python3 chip_smoke.py --phases build,paddle_layers

Phases, each printing one JSON line:

1. build: nvcc builds every kernel of the serving and training paths from
   paddle_tpu_torch/csrc (sm_90a), all at once; prints the card's name and
   power limit as nvidia-smi reports them; counts, with cuobjdump -sass,
   the HMMA (tensor-core) instructions of each bf16 mma kernel (the causal
   pair, the shortseq forward and backward, the flash forward B6, the 3x3
   conv B8, the 1x1 conv B7, the train forwards B9a and B9b, the 1x1
   backward B10, the 3x3 dWeight B11, both bf16 kernels of the
   int8-weight linear) and the HGMMA (wgmma) instructions of the library
   route's bf16 backward (WGMMA_KERNELS), and fails if one has none, if a
   library of them holds an atomic, if ptxas reports a spill in any mma
   kernel or in any kernel of the library route's backward or of the
   int8-weight linear, or if the paged decode or
   verify library (the split walk and its combine, fp32 FMA), the
   one-pass optimizer update (with Lars' and Lamb's norm pass), gradient
   merge's library, the sampler's draws or the batched LoRA kernel hold an
   atomic or spill.
2. paged_decode: the paged decode kernel against its plain PyTorch version
   on the card (8 slots, block 16, 16 heads, D 128, 2 layers; an idle lane,
   block-boundary positions, two slots sharing blocks read-only), bf16
   (the split walk) and f32 (the first design): outputs within tolerance,
   pools bit-identical; timings, with the split walk's ranges (its grid's
   and those walked); then bf16 at a tensor-parallel shard's 8 and 4
   heads (SHARD_HEADS) against the plain version on the same inputs.
3. causal_fwd: the causal attention kernel against its plain version at
   B1 H16 S2048 D128 and at a ragged S=300, bf16 and f32, and bf16 at a
   shard's 8 and 4 heads (bucketed prefill at mp 2 and 4), a rerun giving
   the same bits; bf16 timings at B1 H16 S2048 D128, L2 flushed, with the
   achieved TFLOP/s and the share of the bound, and torch's
   scaled_dot_product_attention timed as the library yardstick;
   shapes no kernel takes (causal Sq != Skv, non-causal 64 x 80, causal
   head dim 96) take the dense route; the library shapes (non-causal S
   1024, causal head dim 192) launch the flash forward B6 when no gradient
   is needed, and its LSE variant then the library route's backward when
   one is.
4. causal_bwd: the causal attention backward kernel against its plain
   version at B2 H16 S2048 D128 (the training shape) and at S=300, bf16
   and f32, and at B1 H16 S256 f32 (train_parity's shape), for dq, dk and
   dv; bf16 timings at the training shape, L2 flushed, with the achieved
   TFLOP/s and the share of the bound, and the backward of torch's
   scaled_dot_product_attention (autograd.grad, its forward not timed,
   from a CUDA graph's replays so that no host gap enters) as the library
   yardstick.
5. engine: GPT-1.3B at full width and depth, bf16, random weights from a
   seed, served greedily by GenerationEngine (8 slots, block 16, chunked
   prefill, prefix cache) over a trace with mid-run arrivals, a shared
   512-token prefix and a repeated prompt (a copy-on-write), then one
   generate(use_cache=True) near full context. drain()'s leak check runs.
6. generate_parity: the same config in f32: engine tokens against
   GPTForCausalLM.generate(use_cache=True) for prompts of 256 and 300.
7. train: GPT-1.3B in bench.py's training configuration (vocab 32768,
   hidden 2048, 24 layers, 16 heads, 2048 positions, dropout 0), bf16
   parameters, AdamW(1e-4), batch 2 x seq 2048 with the labels the input
   ids, through TrainStep.run_scan over one random batch per step, as
   bench.py feeds them: 2 warm-up steps, then 5 timed steps; ms/step,
   tokens/s, the model-FLOP share of 989 TFLOP/s, peak memory (at most
   0.5 GB above the per-parameter loop's, LOOP_PEAK_GB) and the losses,
   which must be finite; the update is one launch of the one-pass
   kernel a step. Then three steps feed the first batch again, and its
   loss must fall.
8. train_parity: f32, hidden 2048, 16 heads, 2 layers, batch 1, seq 256,
   from the same weights on the card and on the CPU (plain versions,
   outside the counted run): the first batch's loss gradients, then three
   AdamW steps; the losses, and per parameter the gradients and the
   change of the parameters, must agree.
9. paged_verify: the speculative verify kernel against its plain version
   (8 slots, W 5, block 16, 16 heads, D 128, 2 layers; decode's position
   mix with draft lengths 0-4: an idle lane, a window in the slot's first
   block crossing into the second, windows crossing blocks, one ending at
   the table's last position, two slots sharing blocks read-only), bf16
   (the split walk) and f32 (the first design): outputs on live rows
   within tolerance, pools bit-identical outside the null block 0;
   timings, with the split walk's ranges (its grid's and those walked);
   bf16 at a shard's 8 and 4 heads.
10. paged_int8: the int8 decode and verify kernels against their plain
   versions at the same shapes over int8 pools (normal rows quantized on
   per-block grids), the quantization run once in plain torch before
   both: outputs within tolerance, codes bit-identical outside block 0,
   scales untouched; timings, with the split walk's ranges; bf16 at a
   shard's 8 and 4 heads.
11. engine_spec: phase 5's trace plus one request whose prompt tiles a
   64-token motif 8 times, served by GenerationEngine(spec_decode_k=4)
   with the n-gram drafter (bf16): tokens/s, verify steps, accepted and
   rejected drafts, spec_degrade stalls, drain()'s leak check.
12. spec_parity: f32, 2 slots, phase 6's prompts: K=0, K=4 with the n-gram
   drafter and K=4 with an oracle drafter proposing the K=0 run's tokens
   must emit the same tokens (a difference only at a near-tie, reported);
   the oracle run accepts more than half of its drafts.
13. engine_int8: phase 5's trace at kv_dtype="int8" (bf16 model), K=0 and
   K=4: tokens/s, pool bytes against the bf16 pools, and the share of
   tokens equal to the bf16 K=0 run's, held to the JAX package's int8
   budget of 0.90 (tests/test_engine_quantized.py:41) as the JAX package
   counts it (bench_ops.py `_token_match_fraction`: position by position
   over each request's prompt and generated tokens); the share of
   generated tokens alone, and for each request that diverges the first
   differing token and the bf16 run's top-2 logit gap there, are
   reported beside it.
14. shortseq_fwd: the short-sequence (encoder) attention kernel, mask-free
   and key-masked, against its plain version at S 128 and 512, D 64 and
   128, bf16 and f32 (B4 H3; the masked cases with padded tails of
   different lengths, one all-padding sequence, a [B, S] mask broadcast
   over heads), then at bench.py's BERT shape (B64 H12 S512 D64 bf16),
   timed against its bound, its plain version and torch's
   scaled_dot_product_attention (non-causal, a float [B, 1, 1, S] mask
   for the masked variant), with the achieved TFLOP/s and the share of
   the bound.
15. shortseq_bwd: its backward kernel likewise, from the kernel's forward
   O and LSE, per sequence for dq, dk and dv; the library yardstick is
   autograd.grad through scaled_dot_product_attention, from a CUDA graph's
   replays.
16. bert_train: bench.py's BERT row at full width and depth, nothing cut:
   BertConfig.bert_base() (vocab 30522, hidden 768, 12 layers, 12 heads,
   FFN 3072, 512 positions), dropouts 0, eval mode, bf16 parameters,
   AdamW(2e-5) through TrainStep, random weights from seed 0, one random
   batch of 64 x 512 ids with 2-class labels: run_repeat of 2 warm-up and
   5 timed steps; ms/step, tokens/s, the model-FLOP share of 989 TFLOP/s,
   peak memory; the losses must be finite and fall. Then the same batch
   with a padding mask whose rows keep 128-512 real tokens, 2 + 3 steps,
   and an eval forward of that padded batch twice, with other token ids at
   the padded positions: the logits must be bitwise equal.
17. bert_parity: f32, BERT-base widths at 2 layers, batch 2, seq 512, one
   row padded to 384 tokens, from the same weights on the card and on the
   CPU: the logits, the first batch's gradients, then three AdamW steps;
   the losses, and per parameter the gradients and the change of the
   parameters, must agree.

18. conv_fwd: the fused eval conv kernels (B7, B8) against their plain
   version at bench_ops.py's nine ResNet-50 sweep shapes at batch 256, bf16
   and f32, plus stride 2, int padding and ReLU off; timings against the
   bound, the plain version and F.conv2d of the folded weights; at each
   timed shape the bf16 kernel, its plain version and the library call
   against an fp64 reference.
19. resnet_infer: bench.py's resnet50_infer (resnet50, bf16, batch 256 x
   224 x 224, seeded BatchNorm statistics), 2 + 10 forwards on the kernel
   route, then the dense route from the same weights; logits within 0.03.
20. resnet_parity: f32 ResNet-50 logits on the card against the CPU.
21. conv_train: the training kernels against their plain versions at the
   nine sweep shapes at batch 256 (plus the stride-2 1x1 and a stride-2
   3x3 at int padding), bf16 and f32: the train forwards (B9a, B9b: the
   conv and its [2, Cout] sums), the 1x1 backward (B10: dx and dw from one
   bundle), the 3x3 dWeight (B11) and B8 as the 3x3 dX walk over the
   dilated dConv; bf16 timings at the sweep shapes against the bound, the
   plain version and the library call (B10: aten.convolution_backward of
   the 1x1, products only; B11: torch.nn.grad.conv2d_weight; B9: none);
   at each timed shape the bf16 B11, its plain version and the library
   call (on the bf16 inputs and on their fp32 copies) against an fp64
   reference.
22. resnet_train: bench.py's resnet50 row, nothing cut: resnet50(1000),
   bf16, seed-0 weights, Momentum(0.1, 0.9), TrainStep(cross_entropy), one
   batch of 256 x 3 x 224 x 224 from uniform(-1, 1) with random labels,
   run_repeat of 2 warm-up and 10 timed steps: ms/step, images/s, the
   model-FLOP share of 989 TFLOP/s at 3 x 4.09 GFLOP an image, peak
   memory. Then resnet50_train's check: the same weights on the dense
   route, first-step losses within 0.03 (bench.py), its ms/step beside.
23. resnet_train_parity: f32 resnet50(10), batch 2, 64 x 64, seeded
   BatchNorm, three Momentum steps on the card against the CPU: the
   losses, the first step's gradients, the change of the parameters and
   the running statistics, beside the CPU's own sensitivity to inputs
   1e-7 apart (RESNET_TRAIN_PARITY_TOL says why the bars are where they
   are).
24. sdpa_fwd: the flash forward kernel B6 against its plain version, bf16
   and f32, at the Transformer-base encoder's self-attention (B8 H8 S1024
   D64), its cross-attention (B8 H8 Sq256 Skv1024 D64), the JAX entry
   point pallas_sdpa_forward's flagship shape (B2 H16 S2048 D128, causal,
   through that entry point) and the library route's causal head dim (B1
   H8 S2048 D256); bf16 timings, L2 flushed, against the bound, the plain
   version and torch's scaled_dot_product_attention, with the achieved
   TFLOP/s and the share of the bound. Then the routes: a
   no-grad library shape launches B6, a grad-requiring one B6's LSE
   variant and the library route's backward, head dim 320 launches B6
   (the wide design), head dim 576 raises naming the limit of 512, and
   pallas_sdpa_forward with S not a multiple of its block fails its
   assert.
25. transformer_infer: nn.Transformer() at its defaults (the base model of
   Vaswani et al. 2017: d_model 512, 8 heads, 6 + 6 layers, FFN 2048,
   ReLU, post-norm), dropout 0, bf16, seed-0 weights, eval mode under
   torch.inference_mode(), batch 8, source 1024 and target 256 tokens from
   uniform(-1, 1) with the causal tgt_mask: 2 warm-up and 10 timed
   forwards; ms per forward, source and target tokens/s, the FLOP share
   of 989 TFLOP/s, peak memory; 12 B6 launches a forward (6 encoder
   self-attentions, 6 cross-attentions), no plain call, nothing dense
   through flash_attention; the output finite and within
   TRANSFORMER_BF16_REL_TOL of the same model in f32.
26. transformer_parity: f32 at width 512, 8 heads, 2 + 2 layers, batch 2,
   source 640 and target 128, from the same weights on the card and on
   the CPU: the outputs within TRANSFORMER_PARITY_TOL (relative L2).
27. sdpa_bwd: the library route's forward and backward against their
   plain versions, bf16 and f32, at the Transformer-base encoder's
   self-attention (B8 H8 S1024 D64) and cross-attention (Sq 256, Skv
   1024), head dims 128, 192 and 256, causal at 192 and 256 (B1 H8
   S2048), and head dims 320 and 512 (the wide design): B6's LSE variant
   (its LSE within LSE_TOL of the plain LSE, its O within SDPA_TOL and the
   same bits as the inference instance's), then `sdpa_backward` from that
   O and LSE, the same bits on a rerun; bf16 timings, L2 flushed, of one
   call replayed from a CUDA graph (the eager time beside it) against the
   bound, the plain version and autograd.grad through
   scaled_dot_product_attention (replayed the same way), with the achieved
   TFLOP/s and the share of the bound; B6's LSE variant timed beside its
   inference instance.
28. optimizer_update: one AdamW step over GPT-1.3B's own parameter list
   (bf16, biases and norms without decay) and one Momentum step over
   ResNet-50's, grads and accumulators drawn from the seed: the one-pass
   kernel bitwise equal to the per-parameter loop (run on the card) in
   parameters and accumulators; its device time (torch.profiler) against
   the bytes bound (22 and 14 bytes a parameter), the loop's, and
   torch.optim's (AdamW fused, SGD with momentum) as a yardstick, and the
   whole step on the host's clock. Then, over GPT-1.3B's parameters and
   likewise bitwise: SGD (6 bytes), Adagrad (14), RMSProp (22), centered
   RMSProp with momentum 0.9 (30, three accumulators), Adadelta (22) and
   AdamW with bf16 moments (14), beside torch.optim's foreach optimizers;
   Lamb (lr 0.1, so that the new weights depend on the trust ratio) over
   GPT-1.3B's parameters (22) and Lars (its velocity drawn below its step,
   so that the new velocity depends on the norms) over ResNet-50's with
   biases and BatchNorm excluded from decay (14), within NORM_RULE_TOL of
   the loop and bitwise equal across two launches from one state, the
   norm pass alone against its plain version within NORM_PASS_TOL, timed
   (12 and 4 bytes) and run twice to the same bits, torch._foreach_norm
   beside Lars'; and gradient merge's kernels over
   GPT-1.3B-sized bf16 grads, bitwise against their plain versions: the
   merge (10 bytes an element, beside torch._foreach_add_), the finish
   (6) and the unscale (4, beside torch's multiply-based
   _amp_foreach_non_finite_check_and_unscale_).
29. transformer_train: nn.Transformer() at its defaults (the base model)
   with the paper's dropout (residual 0.1, no attention or activation
   dropout), bf16, AdamW(7e-4, the paper's peak rate) through TrainStep
   over a wrapper that passes the causal tgt_mask, mse_loss in fp32
   against a target drawn from the seed, batch 8, source 1024, target
   256: 2 warm-up and 5 timed steps;
   ms/step, source and target tokens/s, the FLOP share of 989 TFLOP/s (3
   x the forward's FLOP), peak memory; a step launches B6's LSE variant
   and the library backward 12 times each (6 encoder self-attentions, 6
   cross-attentions) and the one-pass update once, and no plain version;
   the losses finite and a re-fed batch's loss falling.
30. transformer_train_parity: f32 at width 512, 8 heads, 2 + 2 layers,
   batch 2, source 640 and target 128, dropout 0, from the same weights on
   the card and on the CPU: the first batch's gradients, then three
   AdamW steps; the losses, the gradients and the change of the
   parameters within TRANSFORMER_TRAIN_PARITY_TOL, the CPU's own noise
   beside them.
31. train_accum: GPT-1.3B in bench.py's training configuration (bf16,
   AdamW(1e-4), micro-batch 2, seq 2048) through TrainStep with
   accumulate_steps=4 and GradScaler(2**15): two timed windows of four
   random micro-batches (after one untimed forward and backward); ms a
   window and a micro-step, tokens/s, the FLOP share, peak memory beside
   train's (the fp32 merge buffers add 4 bytes a parameter); the losses
   finite, no window skipped (the scale still 2**15, two steps counted),
   exactly 8 merge, 2 finish and 2 update launches, no unscale; then the
   first window's micro-batches fed again three times, whose mean loss
   must fall.
32. train_accum_parity: f32 at train_parity's depth (2 layers, batch 1,
   seq 256), the same steps on the card and on the CPU, each run from the
   same weights, with GradScaler(2**15): Momentum(0.1, 0.9), whose step
   is lr times the grad, over one window of four and then one step with
   the scaler and no merge (the unscale), the losses and the change of
   the parameters within TRAIN_PARITY_TOL; then AdamW(1e-4) over two
   windows of four and two scaler steps, within TRAIN_ACCUM_PARITY_TOL
   (TRAIN_PARITY_TOL, the change of the parameters held to ten times the
   CPU's own noise, the same steps from weights 1e-7 apart, at least). Then a window at a scale of 1e38 (the
   loss times 1e3, so that the scaled grads overflow for certain) must
   skip: the parameters and AdamW's moments bitwise kept, the scale
   halved, no finish or update launched; and a ResNet-18 (64 x 64, seeded BatchNorm,
   Momentum, far mse targets so that the scaled grads overflow for
   certain) keeps its running statistics, parameters and velocity bitwise
   through a skipped window.
33. bert_lamb: BertForPretraining at BERT-base width (bench.py's row 2
   shape: batch 64, seq 512, bf16, dropouts 0, 15 % of positions
   labelled) with Lamb(1e-3, lamb_weight_decay=0.01) through TrainStep
   without a loss_fn (the model returns the MLM + NSP loss; a trailing
   placeholder is dropped as the label, as in the JAX package): 2 warm-up
   and 5 timed steps on one batch; ms/step, tokens/s, the FLOP share, peak
   memory; the losses finite and falling; a step launches the mask-free
   shortseq kernels 12 times each, Lamb's norm pass once and the update
   once.
34. sampling: the draw kernels (csrc/sampling.cu) against their plain
   versions at the engine's rows (N 8, the decode step; N 40, the verify
   step at K=4) over V 50,304 masked logits (temperature 0.8, top_k 50,
   top_p 0.9): tokens identical with and without excluded indices, each
   row's uniform bitwise; a chi-square of 4,096 draws of one row against
   the numpy oracle `oracle_probs`; the draw's device time (calls on
   copies of the logits past the L2 captured in a CUDA graph, its replays
   timed) and one eager call's time, against its bound: the larger of the
   bytes (the logits read once) and the integer work, the integer
   instructions of a vocabulary entry counted in the SASS of the kernel's
   loop (`cuobjdump -sass`) over the SMs' 64 integer lanes at the card's
   maximum SM clock (nvidia-smi); the plain version (its kernel launches
   counted with torch.profiler) and torch.multinomial of the row softmax,
   a different function, as the yardstick.
35. int8_linear: the int8-weight linear (csrc/int8_linear.cu) against its
   plain version at GPT-1.3B's four projections (qkv, out, fc1, fc2) at M
   8, 40 and 128, bf16 and f32 (INT8_LINEAR_TOL); bf16 timings against the
   bytes bound, the plain version and torch.matmul over the dequantized
   bf16 weight as the yardstick, and the decode step's whole weight read
   (24 layers at M 8) against its int8 and bf16 bounds; every case twice,
   the same bits each time. The bf16 kernel and torch.matmul are timed
   both eagerly and by CUDA-graph replays over copies of the weights that
   exceed the L2 cache (the row's `ms` and `library_ms`), and
   torch._weight_int8pack_mm, the same function without the bias, where
   this PyTorch has it for CUDA bf16 (else the row says why). Then, bf16,
   every shard's N / mp output columns at mp 2 and 4 against the plain
   version and bitwise the whole launch's columns.
36. engine_sampled: phase 5's trace with sampling=True, five requests
   sampled (SAMPLED_LANES: temperature 0.7 or 1.0, top_k 50, top_p 0.9,
   seeds from the phase seed) and the rest greedy, at K=0 and at K=4 with
   the n-gram drafter: greedy lanes token-identical to the sampling=False
   run of the same trace, a second run with the same seeds
   token-identical, one draw launch a decode or verify step and a final
   prefill chunk and one uniform launch a verify step, tokens/s.
37. engine_wint8: phase 5's trace with weight_dtype="int8" (K=0), and
   again with kv_dtype="int8" too: tokens within TOKEN_PARITY_MIN of the
   bf16 run's, exactly four int8_linear launches a layer a step, the
   snapshot's int8 bytes (WINT8_SNAPSHOT_BYTES), tokens/s; then an f32
   model at full width and 2 layers, whose int8-weight engine's greedy
   tokens on the card must equal the CPU's from the same weights.
38. lora: the batched LoRA kernel (csrc/lora.cu) against its plain version
   at GPT-1.3B's four sites (qkv head-grouped, out, fc1, fc2) at 8 rows (8
   slots, the decode step), 40 (8 slots x 5, the verify step) and 128 (one
   slot, the prefill chunk), max_rank 4, 16 and 64, pages mixed with the
   null page 0, ranks padded with zero rows: the kernel's fp32 delta (its
   f32 instance on the bf16 values, over a zero base) within
   LORA_DELTA_TOL of the largest |delta|, the bf16 result bitwise the
   plain version's wherever the two fp32 deltas round to the same bf16,
   page-0 rows bitwise the base, a rerun the same bits; at rank 16 with 8
   distinct pages, device times (20 calls in a CUDA graph, L2 warm; and
   calls over copies of the pool past the L2, as a decode step's layers
   find their pages) against the bytes bound, the plain version and the
   gathered factors through two torch.bmm (no single PyTorch call
   computes the function), and one eager call's time with the wrapper's
   host time in it; then
   every tensor-parallel shard's B pages at the four sites, mp 2 and 4,
   rank 16, each row shape (out / mp columns; qkv the shard's heads of the
   head-grouped pages over the head-grouped base), held as the whole
   launch and bitwise the whole launch's columns.
39. engine_bucketed: phase 5's trace on GPT-1.3B bf16 with
   prefill_chunk=None (buckets 16 ... 2048, no prefix cache): the causal
   kernel exactly 24 times an admission and no plain call, no prefix hit,
   tokens within TOKEN_PARITY_MIN of the chunked run's (phase 5), and the
   same at kv_dtype="int8", tokens/s; the causal kernel against its plain
   version at the short buckets (S 16, 32, 48), bf16 and f32; then f32 at
   full width and 2 layers: the card's bucketed engine token-identical to
   the CPU's and to the card's generate(use_cache=True) (a difference only
   at a near tie, as generate_parity).
40. engine_lora: GPT-1.3B bf16, 8 slots, six adapters of ranks 4-16
   (max_rank 16; two of them one rank group) in a 1 + 4 page pool, phase
   5's trace with adapter ids mixed, 0 included: the LoRA kernel exactly
   four times a layer a step, swap-ins and evictions, drain()'s audit of
   blocks and pages; each request's tokens equal to a dedicated engine's
   that serves only its adapter; the trace with every id 0 bitwise phase
   5's tokens; tokens/s with adapters, with id 0 only and without
   adapters; then f32 at full width and 2 layers, chunked and bucketed, K=0
   and K=4: the card's mixed-tenant tokens equal to the CPU's.
41. tp_parity: tensor-parallel serving on a virtual mesh of the card
   (serving_mesh(mp, devices=["cuda"] * mp): every shard's work, kernels
   and gathers on the one card), f32 at GPT-1.3B's widths and 2 layers, 2
   slots, phase 6's prompts: mp 1, 2 and 4, chunked and bucketed, K=0 and
   K=4, and int8 pools chunked at K=0, on the card, and mp 2 on the CPU
   (plain versions, outside the counted run). Each engine's served logits
   are kept (each generated token's row as the engine scored it). Tokens
   equal mp=1's, a difference allowed only at a near tie (mp=1's served
   top-2 gap at most TP_TIE_F32), reported with the first differing
   position; each shard's paged kernel (B3, B4, B5a) once a layer a step
   and B1 once a layer an admission, exactly; the largest served logit
   difference of mp 2 and 4 (and the CPU) from mp 1 on the first step.
42. engine_tp: GPT-1.3B bf16 at full width and depth, phase 5's trace, at
   mp 1, 2 and 4 on a virtual mesh of the card: chunked K=0; bucketed K=4
   with int8 KV; and at mp 1 and 2 int8 weights with engine_lora's six
   adapters in a 1 + 4 page pool and two sampled requests. Exact launch
   counts (each shard's paged kernel 24 times a step, B1 24 times an
   admission, the int8 linear and the LoRA kernel four times a layer a
   step, the draws once a step and a final prefill chunk, on the gathered
   logits), no plain call, each pool shard mp=1's bytes / mp, drain()'s
   leak check; the served logits of mp=N within TP_BF16_REL_TOL (relative
   L2 a row) of mp=1's at every generated index where both fed the same
   prefix; tokens equal the same features' mp=1 run but at near ties,
   each differing request reported with its first differing position,
   the mp=1 served top-2 gap there and delta (the rows' largest |logit|
   difference there); a near tie: the gap at most twice the run's noise
   (the largest served |logit| difference where both runs agreed on the
   prefix and the token), over the lane's temperature; tokens/s at each
   mp, not gated, with the card's name and power limit.
43. engine_async: phase 5's trace serial and with async_core=True in
   seven configurations (tokens bitwise, launches equal, one step in
   flight, no host sync after the dispatch).
44. engine_observed: phase 5's trace at K=0 and 4 with tracing off and
   on (the metric gates, tokens bitwise, launches equal).
45. fleet: phase 5's trace through ServingFleet, every replica on this
   card: one mixed replica (tokens bitwise phase 5's), two (each request
   phase 5's, the later shared-prefix and repeat requests routed to the
   replica whose cache held them, affinity hit tokens), and a
   disaggregated pair (1 prefill + 1 decode replica) at bf16 and int8
   pools, chunked and bucketed, chunked with async_core=True, and chunked
   on a 160-block pool without the prefix cache (freed source blocks
   reused by the next prefill before placement, which that run requires),
   each
   against a colocated engine of the same configuration served in this
   phase (tokens equal, handoffs the requests with a decode leg, every
   exported block bitwise its source rows and every ingested block, int8
   scale rows included, bitwise a snapshot of those source rows taken at
   export, summed on the card, with the source blocks rewritten before
   placement counted beside it, as are the handoff stalls; the
   decode replica no prefill chunk and no causal launch, the prefill
   replica one token a request, each replica's launches counted around
   its steps; the async run's handoff stages under
   set_sync_debug_mode("error")); at drain no leak, no parked handoff,
   and the dropped fleet's memory back at once. tokens/s of each run, not
   gated, with the card's name and power limit.
46. train_telemetry: GPT-1.3B TrainStep with TrainingTelemetry bitwise
   the same steps without it.
47. paddle_api: the paddle API (`paddle_tpu_torch.Tensor` and the op
   modules) on the card, f32, TF32 off: GPT-1.3B's LayerNorm and MLP
   (hidden 2048, ffn 8192, 4 x 512 tokens) written in paddle ops against
   the port's `nn.LayerNorm` and `GPTMLP` on the same weights, forward
   and `paddle.grad` against `torch.autograd.grad` within TOL, a PyLayer's
   hand-written backward against autograd; then every op of the six
   ported modules (`tools/paddle_op_cases.py`, the cases the CPU tests
   hold to the JAX package: the six of PR 24, `linalg` and `nn_ops`) on
   the card against the same op on the CPU, gradients too: f32 within
   1e-5 of the largest magnitude, the random ops' float transforms within
   1e-6, integers, bools and the seeded bits and integer draws exactly,
   the decompositions by reconstruction, orthogonality and their values,
   every result on the card; the ms of the MLP's forward and backward
   both ways and the subclass's host microseconds an op against a plain
   tensor's.
48. paddle_program: GPT-1.3B written in the paddle API
   (`tools/paddle_gpt_program.py`: `F.embedding`, `F.layer_norm`,
   `F.linear`, the `reshape` and `transpose` methods,
   `F.scaled_dot_product_attention(is_causal=True)`, `F.gelu`,
   `paddle.matmul`, `F.cross_entropy`) on a seeded `GPTForCausalLM`'s
   weights (`paddle_tpu_state`), 4 x 1024 tokens. f32, TF32 off: the loss
   within 1e-5 of the module's, every gradient within PROGRAM_GRAD_TOL,
   `OpStats.counts` the program's pinned counts at 24 layers, B1 and B2 24
   launches each, no plain call. Under `auto_cast(dtype="bfloat16")` O1:
   the pinned counts with the casts, `linear` and `flash_attention` bf16,
   `layer_norm` and `softmax_ce` fp32, B1 and B2 24 each, finite grads,
   the loss within PROGRAM_BF16_LOSS_TOL of f32's. Not gated: fwd+bwd ms
   of the program and the module at f32 and bf16, peak memory, the host
   µs of an enqueued `paddle.add` and `F.linear`. With
   FLAGS_check_nan_inf=1 an inf in layer 5's fc1 weight raises naming op
   `linear` and counts one `nan_inf_events_total`; a layer's bf16 state
   through `paddle.save` / `paddle.load` bitwise; the share of a bf16
   `F.linear` equal to one rounding of its fp32 product and bias, and of a
   bf16 GEMM unchanged by cuBLAS' reduced-precision split-K setting.
49. paddle_layers: the `nn` layers. (a) The README's "Drive it"
   flow (`nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 1))`,
   `Adam`, ten eager steps) on the card: the loss falls and the ten
   losses equal the CPU's within 1e-5. (b) GPT-1.3B written as `nn`
   layers (`tools/paddle_gpt_layers.py`: `nn.Embedding`, an
   `nn.LayerList` of blocks of `nn.LayerNorm`, `nn.Linear` and
   `nn.Dropout(0.0)`, `F.scaled_dot_product_attention(is_causal=True)`),
   4 x 1024 tokens, loaded through `set_state_dict` from a seeded
   `GPTForCausalLM`'s `paddle_tpu_state`: f32, TF32 off, the loss within
   1e-5 of the module's, every gradient within LAYER_GRAD_TOL, B1 and B2
   24 launches each and no plain call; then `Layer.astype("bfloat16")` and
   one eager AdamW step: a finite loss, B1 and B2 24 each, the update
   kernel, its ms, and its peak memory as `paddle.device` reads it, equal
   to `torch.cuda.max_memory_allocated`. (c) Every case of
   `tools/paddle_layer_cases.py` (one a ported layer class) and the
   card-sized RNNs (LSTM and GRU, hidden 1024, batch 32, T 128, two
   bidirectional layers) built on the card, copied to the CPU with
   `Layer.to`, run on both from that state: forward, input and parameter
   gradients and the state after, within each case's tolerance. (d)
   `paddle.device`: `synchronize`, `memory_allocated` equal to torch's,
   and after `reset_peak_memory_stats` the peak following a 256 MiB
   allocation.

Phases 5 to 8, 11 to 13, 16, 17, 19, 20, 22, 23, 25, 26, 29 to 33, 36, 37,
39 to 42, 45, 48 and 49 are the main path, in sixty-five runs: the bf16
engine, the bf16 generate(), the f32 engine, the f32 generate(), the bf16
train steps,
the f32 train steps, the bf16 speculative engine, the three f32 engines of
spec_parity, the int8 engine, the int8 speculative engine, BERT's
mask-free and padded bf16 train steps, its padded eval forwards and its
f32 padded steps, the timed bf16 ResNet-50 forwards, the f32 ResNet-50
forward, the timed bf16 ResNet-50 train steps, the f32 ResNet-50 train
steps, the timed bf16 Transformer forwards, the f32 Transformer forward,
the timed bf16 Transformer train steps, the f32 Transformer train steps,
the bf16 merge windows, the f32 merge windows and scaler steps (Momentum
and AdamW), the two skipped windows (GPT and ResNet-18), the BERT Lamb
steps, the sampled engines at K=0 and K=4, the int8-weight engines with
bf16 and int8 pools, the f32 int8-weight engine, the bucketed engines with
bf16 and int8 pools, the f32 bucketed engine, the mixed-tenant and the
all-null-adapter LoRA engines, the f32 LoRA engines, the f32
tensor-parallel engines on the card, and engine_tp's eight engines (three
configurations at mp 1, 2 and 4, the adapter one at mp 1 and 2),
fleet's eleven runs (phase 45), the paddle program at f32 and bf16
(phase 48) and the GPT of `nn` layers at f32 and its bf16 AdamW step
(phase 49). Kernel
counts are set to 0 just before each run and read just after it; each run
must launch every kernel it takes (PATH_KERNEL: the engine the paged
decode kernel, generate() the causal forward, training the causal forward
and backward, 24 times a step at 1.3B, the speculative engine the verify
kernel, the int8 engines their int8 kernels, BERT's mask-free steps the
mask-free shortseq kernels 12 times a step each and its padded runs the
masked variants alone, a ResNet-50 forward the 1x1 kernel 36 times and the
3x3 kernel 16 times, a ResNet-50 train step the 1x1 and 3x3 train forwards
36 and 16 times, the 1x1 backward 36, the 3x3 dWeight 16 and the 3x3 eval
kernel 16 times as the dX walk, a Transformer forward the flash forward B6
12 times, a Transformer train step B6's LSE variant and the library
route's backward 12 times each; every train step the one-pass optimizer
update once; a merge window the merge kernel once a micro-step and the
finish and the update once; a scaler step without merge the unscale once;
a Lamb step the norm pass once; a sampled engine the draw kernel once a
decode step and a final prefill chunk, and at K=4 the fused draw and
acceptance coin once a verify step; an int8-weight engine the int8-weight linear four
times a layer a step; a bucketed engine the causal forward 24 times an
admission; a LoRA engine the batched LoRA kernel four times a layer a
step; at mp N each of these N times, once a shard, the draws once; the
paddle program and the GPT of `nn` layers B1 and B2 24 times a forward
and backward, the layers' AdamW step the update once) and call no plain
version.
`--profile` adds a device-time
breakdown of each engine run (the part after its prefixes are cached), of
one GPT train step, of one BERT train step, of one bf16 ResNet-50
forward and one bf16 ResNet-50 train step on each route, of one bf16
Transformer forward and of one bf16 Transformer train step. The line
before
the last
lists the kernels with their launches, errors, times and design (tensor
cores or fp32 FMA); the last line is
the device line. Any failed phase exits non-zero without it. With no CUDA
device, or without the repository beside it, the script fails.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 0                           # weights and traces are drawn from it
PHASES = ("build", "paged_decode", "causal_fwd", "causal_bwd", "engine",
          "generate_parity", "train", "train_parity", "paged_verify",
          "paged_int8", "engine_spec", "spec_parity", "engine_int8",
          "shortseq_fwd", "shortseq_bwd", "bert_train", "bert_parity",
          "conv_fwd", "resnet_infer", "resnet_parity", "conv_train",
          "resnet_train", "resnet_train_parity", "sdpa_fwd",
          "transformer_infer", "transformer_parity", "sdpa_bwd",
          "optimizer_update", "transformer_train",
          "transformer_train_parity", "train_accum", "train_accum_parity",
          "bert_lamb", "sampling", "int8_linear", "engine_sampled",
          "engine_wint8", "lora", "engine_bucketed", "engine_lora",
          "tp_parity", "engine_tp", "engine_async", "engine_observed",
          "fleet", "train_telemetry", "paddle_api", "paddle_program",
          "paddle_layers")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
L2_BYTES = 50 * 2 ** 20            # the H100's L2 cache
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
LSE_TOL = {"bfloat16": 1e-3, "float32": 1e-5}
# backward: max |kernel - plain| <= rel * max |plain| + abs, per gradient:
# bf16 relative (a P or dS value on a rounding boundary may round the
# other way), f32 absolute (fp32 sums in another order)
BWD_TOL = {"bfloat16": (1e-2, 1e-5), "float32": (0.0, 1e-5)}
# f32 train steps on the card against the CPU (cuBLAS and the CPU's GEMMs
# sum in other orders): the per-step loss, absolute; the first batch's
# gradients and the change of the parameters over three AdamW steps, each
# as the relative L2 error of its worst parameter. Sound runs read about
# 1e-6, 3e-6 and 2.6e-4 (PR 4). The key third of each qkv_proj.bias is
# held apart: its gradient is zero in exact arithmetic (it adds one
# constant to a row's logits), so Adam scales rounding noise to +-lr with
# either sign, and the card and the CPU need not agree on it (relative
# 3e-2 over the whole bias). It is held to what Adam can move it: at most
# 1.0036 lr a step over the first three steps (Cauchy-Schwarz over the
# bias-corrected moments), so "key_bias_step" bounds max |change| /
# (steps * lr).
TRAIN_PARITY_TOL = {"loss": 1e-5, "grad": 1e-4, "update": 1e-3,
                    "key_bias_step": 1.01}
# train_accum_parity's AdamW runs (two merge windows; two scaler steps)
# in TRAIN_PARITY_TOL's terms, the change of the parameters held, as the
# Transformer's, to "update_noise_x" times the CPU's own noise (the same
# steps from weights 1e-7 apart), with `update` as its floor: after one or
# two AdamW steps, m / sqrt(v) is about the sign of each grad, so a grad
# near zero flips its step on rounding noise. On an H100 the windows read
# 9.73e-4 and the scaler steps 9.42e-4 against CPU noise of 1.01e-4 and
# 1.22e-4 (bars 1.01e-3 and 1.22e-3); an earlier run, whose card and CPU
# models did not start from the same weights, read 2.2e-3. The phase's
# Momentum runs, whose step is lr times the grad, are held to
# TRAIN_PARITY_TOL itself.
TRAIN_ACCUM_PARITY_TOL = dict(TRAIN_PARITY_TOL, update_noise_x=10.0)
# their learning rate: a step moves a LayerNorm weight (1.0, an fp32 ulp
# of 1.2e-7) by about 1e-3, so that rounding p - lr * v to fp32 adds
# little to the change's error (the CPU's own noise read 1.9e-5 and
# 3.7e-5 at lr 0.1 against 3.7e-4 at 0.01, width 512)
MOMENTUM_PARITY_LR = 0.1
# shortseq backward, per sequence (per [S, D] slab of bh): max |kernel -
# plain| <= rel * max |plain| + abs over the slab. bf16 as BWD_TOL. f32
# relative: an all-padding sequence has p = 1 on every key, so its
# gradients sum S unit-size terms (|g| up to ~115 at S 512 against ~5
# elsewhere), and fp32 sums in another order differ by a small multiple of
# 1e-7 of that (the card read 1.9e-5 on gradients of ~104: 0.046 of this
# limit, PR 4).
SHORTSEQ_BWD_TOL = {"bfloat16": (1e-2, 1e-5), "float32": (4e-6, 1e-5)}
# shortseq forward, per sequence as SHORTSEQ_BWD_TOL, over O: bf16
# relative to the slab's max |O| (a value on a rounding boundary may round
# the other way: one bf16 ulp is at most 2^-7 = 7.8e-3 of the value), f32
# absolute. The LSE is fp32 from exact fp32 products of the inputs in
# both dtypes, so only the order of the sums differs: absolute.
SHORTSEQ_FWD_TOL = {"bfloat16": (1e-2, 1e-5), "float32": (0.0, 1e-5)}
SHORTSEQ_LSE_TOL = 1e-5
GRADS = ("dq", "dk", "dv")
# f32 BERT steps on the card against the CPU, in TRAIN_PARITY_TOL's terms
# (the key third of qkv_proj.bias held apart, for the same reason), plus
# the logits (absolute). Sound runs read logits 5.7e-7, grads 1.2e-6 and
# the change 1.3e-4 outside qkv_proj.bias (PR 4).
BERT_PARITY_TOL = {"logits": 1e-5, "loss": 1e-5, "grad": 1e-4,
                   "update": 1e-3, "key_bias_step": 1.01}
# conv kernels against their plain version, max |kernel - plain| / max
# |plain|: both sum exact fp32 products in fp32, in other orders; a bf16
# output may then round the other way, one bf16 ulp of the value, at most
# 2^-7 of max |plain|; f32 as the JAX suite's FP32_REL_TOL
# (tests/test_pallas_conv.py)
CONV_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# f32 ResNet-50 logits on the card against the CPU, max |card - cpu| / max
# |cpu|: the kernels and cuDNN (TF32 off) sum in other orders than the
# CPU's convolutions. Sound runs on an H100 read 1.27e-6, as the port
# against the JAX package, both on the CPU, read 1.6e-6 at 32 x 32.
RESNET_PARITY_TOL = 1e-5
# bench.py's resnet50_infer check: the fused route against the dense
# composition, bf16 (bench_ops.py CONV_FUSED_REL_TOL)
RESNET_DENSE_REL_TOL = 0.03
# one-term-per-pixel fp32 sums (the train forward's [2, Cout] statistics,
# both dWeights) against the plain version: the statistics relative to the
# sum of their terms' magnitudes, a dWeight relative to max |dw|. f32: sums
# in other orders over up to 802,816 pixels; bf16 statistics: a cast value
# may also round the other way, one bf16 ulp of that value (2^-7); a bf16
# dWeight sums the same exact products of the same bf16 dConv, so f32's bar
CONV_SUM_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# f32 ResNet-50 train steps on the card against the CPU (Momentum(0.1,
# 0.9), batch 2, 64 x 64): the first loss, relative; the later losses,
# relative; and, relative L2 over all parameters (or buffers) together,
# the first step's gradients, the change of the parameters over three
# steps and the running statistics after them. A ResNet-50 in train mode
# at random init amplifies fp32 rounding ~1000x by the output of layer4:
# on the CPU, inputs 1e-7 apart move the first loss 1.9e-5, the gradients
# 0.038 and the change 0.076, and the port against the JAX package read
# 5.6e-5, 0.067 and 0.10 (tests/test_torch_resnet_train.py); the bars are
# about three times those readings. The phase prints the CPU's noise
# beside the card's errors.
RESNET_TRAIN_PARITY_TOL = {"first_loss": 2e-4, "later_loss": 0.05,
                           "grad": 0.3, "update": 0.3, "buffers": 0.3}
# B6 against its plain version, max |kernel - plain|: bf16 relative to max
# |plain| (both divide the same fp32 sums up to their order; a bf16 output
# on a rounding boundary may round the other way, one bf16 ulp of the
# value, at most 2^-7 of max |plain|, as CONV_TOL); f32 absolute (fp32
# sums in another order)
SDPA_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# f32 Transformer on the card against the CPU, relative L2 over the output
# (cuBLAS and the CPU's GEMMs and B6 against its plain version sum in other
# orders), as BERT_PARITY_TOL holds the logits
TRANSFORMER_PARITY_TOL = 1e-5
# the bf16 Transformer-base forward against the same weights and inputs in
# f32 on the card, relative L2 over the output: bf16 rounds every GEMM
# input, residual and LayerNorm output (2^-9 relative each) through 12
# post-norm layers; the LayerNorms keep each layer's output at unit scale,
# so the rounding does not grow layer over layer
TRANSFORMER_BF16_REL_TOL = 0.05
# f32 Transformer train steps on the card against the CPU, in
# TRAIN_PARITY_TOL's terms, with each attention's k_proj.bias held apart:
# its gradient is zero in exact arithmetic (it adds one constant to a row's
# logits), so it is held to 1e-4 of the largest gradient, and its change
# over three AdamW steps, rounding noise that Adam scales to +-lr, as the
# GPT's key third. The phase measures the CPU's own noise (the same steps
# from inputs 1e-7 apart) and holds the change of the parameters to
# "update_noise_x" times it, with `update` as its floor: AdamW scales
# gradient noise by 1 / sqrt(v), so the change's error follows the run's
# own noise.
TRANSFORMER_TRAIN_PARITY_TOL = {"loss": 1e-5, "grad": 1e-4, "update": 1e-3,
                                "update_noise_x": 10.0, "key_bias_step": 1.01,
                                "key_bias_grad": 1e-4}
RESNET50_FWD_FLOPS = 4.09e9        # per 224 x 224 image (bench.py)
CONV_BATCH = 256
# bench_ops.py's nine ResNet-50 sweep shapes: (name, hw, cin, cout, k, s)
CONV_SWEEP_SHAPES = (
    ("conv_c2_1x1_64_256", 56, 64, 256, 1, 1),
    ("conv_c2_3x3_64", 56, 64, 64, 3, 1),
    ("conv_c3_3x3_128_s2", 56, 128, 128, 3, 2),
    ("conv_c3_3x3_128", 28, 128, 128, 3, 1),
    ("conv_c4_3x3_256_s2", 28, 256, 256, 3, 2),
    ("conv_c4_3x3_256", 14, 256, 256, 3, 1),
    ("conv_c5_3x3_512_s2", 14, 512, 512, 3, 2),
    ("conv_c5_3x3_512", 7, 512, 512, 3, 1),
    ("conv_c5_1x1_512_2048", 7, 512, 2048, 1, 1),
)
FWD, BWD = "causal_attention_fwd", "causal_attention_bwd"
DEC, VER = "paged_decode_attention", "paged_verify_attention"
DEC8, VER8 = "paged_decode_attention_int8", "paged_verify_attention_int8"
SSF, SSB = "shortseq_attention_fwd", "shortseq_attention_bwd"
C1, C3 = "conv1x1_bn_relu", "conv3x3_bn_relu"
C9A, C9B = "conv1x1_train", "conv3x3_train"
C10, C11 = "conv1x1_bwd", "conv3x3_dw"
SDPA, SBWD = "sdpa_forward", "sdpa_backward"
OPT = "optimizer_update"
NORMS = "optimizer_norms"
MERGE, FINISH, UNSCALE = "grad_merge", "grad_finish", "grad_unscale"
DRAW, UNIF, W8 = "sample_draw", "sample_uniform", "int8_linear"
# the verify step's draw and acceptance coin in one launch: the coin
# (UNIF) has no launch of its own
VDRAW = "verify_draws"
LORA = "batched_lora"
# the masked variants' launches, counted apart on the same wrappers, and
# B6's LSE variant's
SSFM, SSBM = SSF + "_masked", SSB + "_masked"
SDPA_LSE = SDPA + "_lse"
# extra counts some wrappers keep beside .launches: attribute -> suffix
EXTRA_COUNTS = (("masked_launches", "_masked"), ("lse_launches", "_lse"))
# the fleet phase's disaggregated pairs (1 prefill + 1 decode replica) and
# their colocated engines: name -> (engine options, kernels the run takes)
FLEET_DISAGG = {"chunked": (dict(), (DEC,)),
                "chunked_kv8": (dict(kv_dtype="int8"), (DEC8,)),
                "bucketed": (dict(prefill_chunk=None), (FWD, DEC)),
                "bucketed_kv8": (dict(prefill_chunk=None, kv_dtype="int8"),
                                 (FWD, DEC8)),
                "chunked_async": (dict(async_core=True), (DEC,)),
                # a tight pool without the prefix cache: a handoff's freed
                # source blocks go straight back to the prefill replica's
                # LIFO free list, a prompt waiting for blocks takes them at
                # once, and the handoff waits for the decode replica's
                # blocks: its source rows are rewritten before placement
                # (at 1024 blocks the later prompts are seated before any
                # handoff frees a block, and none is)
                "chunked_tight": (dict(enable_prefix_cache=False,
                                       num_blocks=160), (DEC,))}
FLEET_PATHS = {"mixed1": (DEC,), "mixed2": (DEC,),
               **{f"disagg_{name}": ks
                  for name, (_, ks) in FLEET_DISAGG.items()},
               **{f"colocated_{name}": ks for name, (kw, ks)
                  in FLEET_DISAGG.items() if "async_core" not in kw}}
# each run of the main path, and the kernels that run must launch
PATH_KERNEL = {"engine_bf16": (DEC,),
               "generate_bf16": (FWD,),
               "engine_f32": (DEC,),
               "generate_f32": (FWD,),
               "train_bf16": (FWD, BWD, OPT),
               "train_f32": (FWD, BWD, OPT),
               "engine_spec_bf16": (VER,),
               "spec_f32": (DEC, VER),
               "engine_int8_bf16": (DEC8,),
               "engine_int8_spec_bf16": (VER8,),
               "bert_train_bf16": (SSF, SSB, OPT),
               "bert_padded_bf16": (SSFM, SSBM, OPT),
               "bert_eval_padded_bf16": (SSFM,),
               "bert_f32": (SSFM, SSBM, OPT),
               "resnet_infer_bf16": (C1, C3),
               "resnet_f32": (C1, C3),
               "resnet_train_bf16": (C9A, C9B, C10, C11, C3, OPT),
               "resnet_train_f32": (C9A, C9B, C10, C11, C3, OPT),
               "transformer_infer_bf16": (SDPA,),
               "transformer_f32": (SDPA,),
               "transformer_train_bf16": (SDPA, SDPA_LSE, SBWD, OPT),
               "transformer_train_f32": (SDPA, SDPA_LSE, SBWD, OPT),
               "train_accum_bf16": (FWD, BWD, MERGE, FINISH, OPT),
               "train_accum_f32": (FWD, BWD, MERGE, FINISH, OPT),
               "train_scaler_f32": (FWD, BWD, UNSCALE, OPT),
               "train_accum_momentum_f32": (FWD, BWD, MERGE, FINISH, OPT),
               "train_scaler_momentum_f32": (FWD, BWD, UNSCALE, OPT),
               "train_accum_skip_f32": (FWD, BWD, MERGE),
               "resnet_accum_skip_f32": (MERGE,),
               "bert_lamb_bf16": (SSF, SSB, NORMS, OPT),
               "engine_sampled_bf16": (DEC, DRAW),
               "engine_sampled_spec_bf16": (VER, DRAW, VDRAW),
               "engine_wint8_bf16": (DEC, W8),
               "engine_wint8_kv8_bf16": (DEC8, W8),
               "wint8_f32": (DEC, W8),
               "engine_bucketed_bf16": (FWD, DEC),
               "engine_bucketed_kv8_bf16": (FWD, DEC8),
               "bucketed_f32": (FWD, DEC),
               "engine_lora_bf16": (DEC, LORA),
               "engine_lora_null_bf16": (DEC, LORA),
               "lora_f32": (FWD, DEC, VER, LORA),
               "tp_f32": (FWD, DEC, VER, DEC8),
               **{f"engine_tp_chunked_mp{mp}_bf16": (DEC,)
                  for mp in (1, 2, 4)},
               **{f"engine_tp_bucketed_kv8_k4_mp{mp}_bf16": (FWD, VER8)
                  for mp in (1, 2, 4)},
               **{f"engine_tp_lora_wint8_sampled_mp{mp}_bf16": (
                   DEC, W8, LORA, DRAW) for mp in (1, 2)},
               **{f"engine_async_{name}_{mode}_bf16": ks
                  for name, ks in (("chunked_k0", (DEC,)),
                                   ("chunked_k4", (VER,)),
                                   ("kv8_k0", (DEC8,)),
                                   ("bucketed_kv8_k4", (FWD, VER8)),
                                   ("sampled_k4", (VER, DRAW, VDRAW)),
                                   ("lora_wint8", (DEC, W8, LORA)),
                                   ("chunked_k0_mp2", (DEC,)))
                  for mode in ("serial", "async")},
               **{f"engine_observed_k{K}_{t}_bf16": (DEC,) if K == 0
                  else (VER,) for K in (0, 4)         # 4: SPEC_K
                  for t in ("off", "on")},
               **{f"fleet_{name}_bf16": ks
                  for name, ks in FLEET_PATHS.items()},
               "train_telemetry_off_bf16": (FWD, BWD, OPT, MERGE, FINISH),
               "train_telemetry_bf16": (FWD, BWD, OPT, MERGE, FINISH),
               "paddle_program_f32": (FWD, BWD),
               "paddle_program_bf16": (FWD, BWD),
               "paddle_layers_f32": (FWD, BWD),
               "paddle_layers_bf16": (FWD, BWD, OPT)}
# peak device memory (GB) of the bf16 train phases with the per-parameter
# optimizer loop, before the update became one pass (chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700 W); each phase fails more than
# PEAK_SLACK_GB above its own
LOOP_PEAK_GB = {"train": 21.633068544, "bert_train": 11.866654208,
                "resnet_train": 13.296258048}
PEAK_SLACK_GB = 0.5
# Lars and Lamb on the card against the per-parameter loop on the card, max
# |kernel - loop| / max |loop| per parameter and accumulator: the norm pass
# sums in a fixed order that is not torch.sum's, so the norms differ in
# their last fp32 bits, and a bf16 parameter on a rounding boundary may
# round the other way: at most one bf16 ulp, 2^-7 of the value
NORM_RULE_TOL = 2.0 ** -7
# the norm pass against its plain version on the same inputs, per norm
# |kernel - plain| / |plain|: both sum the same fp32 squares, in other
# orders, and take the same square root; the card test's bar
# (tests/test_torch_kernels_cuda.py), here at the main path's shapes
NORM_PASS_TOL = 1e-5
# bench.py's BERT row: batch, heads, seq, head dim
BERT_SHAPE = (64, 12, 512, 64)
SPEC_K = 4
# the JAX package's int8 KV budget: generated tokens equal to the fp
# engine's (tests/test_engine_quantized.py:41)
TOKEN_PARITY_MIN = 0.90
# the draw kernels' rows: the decode step's slots and the verify step's
# slots x (K + 1)
SAMPLING_ROWS = (8, 8 * (SPEC_K + 1))
# int8_linear's rows: the decode step, the verify step at K=4, the prefill
# chunk
W8_ROWS = (8, 8 * (SPEC_K + 1), 128)
# int8_linear against its plain version, max |kernel - plain| / max
# |plain|: both sum exact fp32 products of the same dequantized weights in
# fp32, in other orders; a bf16 output may then round the other way (one
# bf16 ulp, at most 2^-7 of max |plain|; the bias adds the same second
# rounding in both); f32 as the other kernels' f32 bars
INT8_LINEAR_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# the trace's sampled requests in phase engine_sampled
SAMPLED_LANES = (0, 2, 5, 8, 11)
# GPT-1.3B's int8 snapshot: 24 layers x (qkv 6144 + out 2048 + fc1 8192 +
# fc2 2048 rows of 2048 codes)
WINT8_SNAPSHOT_BYTES = 24 * 2048 * (6144 + 2048 + 8192 + 8192)
# the batched LoRA kernel's fp32 delta against its plain version's, max
# |kernel - plain| / max |plain|: both sum exact fp32 products of the same
# values in fp32, in other orders (the shrink over up to 8192 inputs)
LORA_DELTA_TOL = 2e-6
# the LoRA kernel's rows (the decode step, the verify step at K=4, the
# prefill chunk) as (slots, rows a slot), and its ranks
LORA_ROWS = ((8, 1), (8, SPEC_K + 1), (1, 128))
LORA_RANKS = (4, 16, 64)
# engine_lora's adapters 1-6: their ranks (max_rank 16), 5 and 6 one rank
# group; the trace's adapter ids (phase 5's first and later requests: the
# repeated prompt and the shared prefix under the base model, id 0)
ENGINE_LORA_RANKS = (4, 8, 12, 16, 16, 8)
ENGINE_LORA_IDS = (1, 2, 3, 0, 4, 0, 0, 5, 6, 0, 2, 5, 1)
# tensor-parallel serving: the mesh degrees, on a virtual mesh of the one
# card; tp_parity's f32 near-tie bound (generate_parity's and
# spec_parity's); engine_tp's sampled requests in its adapter run
TP_DEGREES = (2, 4)
# the paged kernels' and B1's heads on a shard: GPT-1.3B's 16 over mp 2, 4
SHARD_HEADS = tuple(16 // mp for mp in TP_DEGREES)
TP_TIE_F32 = 1e-3
# engine_tp (bf16) holds the mp=N engine's served logits to mp=1's at each
# generated index where both fed the same prefix: relative L2 over the row
# within TRANSFORMER_BF16_REL_TOL, a bf16 forward against the f32 one. The
# shards' GEMMs sum in other orders, so a bf16 output on a rounding
# boundary rounds the other way and the difference grows over the layers;
# two bf16 runs that differ only there differ less than bf16 does from
# f32, while a head or a column out of place moves a row by its own size.
TP_BF16_REL_TOL = TRANSFORMER_BF16_REL_TOL
TP_SAMPLED_LANES = (0, 5)


# the bf16 kernels of each library that must run on the tensor cores
# (function names as they appear in the SASS), and the opcodes counted
MMA_KERNELS = {"causal_attention": ("causal_fwd_mma_kernel",),
               "causal_attention_bwd": ("dkdv_mma_kernel", "dq_mma_kernel"),
               "shortseq_attention": ("shortseq_fwd_mma_kernel",),
               "shortseq_attention_bwd": ("shortseq_dkdv_mma_kernel",
                                          "shortseq_dq_mma_kernel"),
               "sdpa_forward": ("sdpa_fwd_mma_kernel",),
               "conv_bn_relu": ("conv3x3_bn_relu_mma_kernel",
                                "conv1x1_bn_relu_mma_kernel",
                                "conv3x3_train_mma_kernel",
                                "conv1x1_train_mma_kernel"),
               "conv_bn_relu_bwd": ("conv3x3_dw_mma_kernel",
                                    "conv1x1_bwd_dx_mma_kernel",
                                    "conv1x1_bwd_dw_mma_kernel"),
               "int8_linear": ("w8_gemv_mma_kernel",
                               "w8_linear_mma_kernel")}
# the bf16 kernels of each library that must run on wgmma (HGMMA in the
# SASS): the library route's backward up to D 256
WGMMA_KERNELS = {"sdpa_backward": ("sdpa_dkdv_wgmma_kernel",
                                   "sdpa_dq_wgmma_kernel")}
# libraries without tensor-core kernels held to no atomic (each result the
# same from run to run) and no spill in any kernel: the split walk of the
# decode and verify kernels (csrc/paged_split.cuh), the one-pass
# optimizer update (with Lars' and Lamb's norm pass, whose sums run in a
# fixed order), gradient merge's kernels and the sampler's draws (their
# argmax reduced in a fixed order)
FMA_LIBS = ("paged_verify", "paged_decode", "optimizer_update",
            "grad_merge", "sampling", "lora")
# libraries held to no spill in any kernel, not only the mma ones: those,
# the library route's backward (its wide FMA design too) and the int8
# linear (its f32 FMA kernel too)
SPILL_FREE_LIBS = FMA_LIBS + ("sdpa_backward", "int8_linear")
SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                         r"([A-Z][A-Z0-9_]*)")
SASS_ATOMICS = ("ATOM", "ATOMS", "ATOMG", "RED", "REDG", "REDUX")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
# each kernel's design: the bf16 causal pair, the bf16 shortseq forward
# and backward (both variants), the bf16 flash forward B6, the bf16 3x3
# conv B8, the bf16 1x1 conv B7, the bf16 train forwards B9a and B9b, the
# bf16 1x1 backward B10 and the bf16 3x3 dWeight B11 run on the tensor
# cores; the bf16 and int8 decode and verify walks split each slot's
# context across CTAs; every f32 instance is scalar fp32 FMA
DESIGN = {"causal_fwd": "mma.sync bf16", "causal_bwd": "mma.sync bf16",
          "shortseq_fwd": "mma.sync bf16",
          "shortseq_fwd_masked": "mma.sync bf16",
          "shortseq_bwd": "mma.sync bf16",
          "shortseq_bwd_masked": "mma.sync bf16", "sdpa_fwd": "mma.sync bf16",
          "conv3x3": "mma.sync bf16", "conv1x1": "mma.sync bf16",
          "conv1x1_train": "mma.sync bf16", "conv3x3_train": "mma.sync bf16",
          "conv1x1_bwd": "mma.sync bf16", "conv3x3_dw": "mma.sync bf16",
          "paged_decode": "split walk, fp32 FMA",
          "paged_decode_int8": "split walk, fp32 FMA",
          "paged_verify": "split walk, fp32 FMA",
          "paged_verify_int8": "split walk, fp32 FMA",
          "sdpa_bwd": "wgmma bf16 fed by TMA, producer warp and two "
                      "consumer warpgroups (D <= 256), wide fp32 FMA",
          "optimizer_update": "one pass over a device table, fp32",
          "optimizer_norms": "per-block sums, then one CTA a parameter in "
                             "a fixed order, fp32",
          "grad_merge": "one pass over a device table, fp32",
          "grad_finish": "one pass over a device table, fp32",
          "grad_unscale": "one pass over a device table, fp32",
          "sample_draw": "a thread-block cluster of up to 16 CTAs a row, "
                         "each a contiguous share of the vocabulary in "
                         "16-byte loads, four threefry hashes in flight a "
                         "thread, the CTAs' (value, index) partials joined "
                         "in rank order through distributed shared memory",
          "verify_draws": "sample_draw's cluster design, and in the same "
                          "launch the acceptance coin: the last thread of "
                          "each row's rank 0 derives the coin's key while "
                          "thread 0 derives the draw's and hashes the coin "
                          "after its shorter walk, three threefry hashes a "
                          "row",
          "sample_uniform": "no launch of its own: computed in "
                            "verify_draws' launch (sample_draw_coin_kernel)",
          "int8_linear": "mma.sync bf16, K split over a thread-block "
                         "cluster reduced through distributed shared "
                         "memory, the weight as the A operand at M <= 16, "
                         "codes dequantized in registers",
          "lora": "a thread-block cluster of up to 8 CTAs a slot's row "
                  "tile of up to 16 rows: A's and x's rows of each CTA's "
                  "share of in_dim by 1-D bulk copies, the shrink once a "
                  "row tile with its partials joined in rank order "
                  "through distributed shared memory, then each CTA's "
                  "columns of B (cp.async, issued before the shrink) "
                  "expanded and added, fp32 FMA"}
# a device-time family of the profiles, by a substring of the kernel's
# name in lower case, first match wins: the port's conv kernels before
# cuDNN's (whose names may hold "conv2d"), and the shortseq backward's
# (shortseq_delta_, shortseq_dkdv_, shortseq_dq_) before the causal
# backward's, whose names they contain
KERNEL_FAMILIES = (
    ("conv1x1_bn_relu_kernel", ("conv1x1_bn_relu",)),
    ("conv3x3_bn_relu_kernel", ("conv3x3_bn_relu",)),
    ("conv1x1_train_kernel", ("conv1x1_train",)),
    ("conv3x3_train_kernel", ("conv3x3_train",)),
    ("conv1x1_bwd_kernels", ("conv1x1_bwd",)),
    ("conv3x3_dw_kernel", ("conv3x3_dw",)),
    ("sum_rows_kernel", ("sum_rows",)),
    ("sdpa_fwd_kernel", ("sdpa_fwd",)),
    ("sdpa_bwd_kernels", ("sdpa_delta", "sdpa_dkdv", "sdpa_dq")),
    ("optimizer_update_kernel", ("optimizer_update", "optimizer_norms")),
    ("grad_merge_kernels", ("grad_merge", "grad_finish", "grad_unscale")),
    ("sampling_kernels", ("sample_draw",)),
    ("int8_linear_kernel", ("w8_linear", "w8_gemv")),
    ("lora_kernel", ("lora_shrink_expand",)),
    ("cudnn conv", ("cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm",
                    "conv2d", "convolve")),
    ("paged_verify_kernel", ("paged_verify",)),
    ("paged_decode_kernel", ("paged_decode",)),
    ("shortseq_fwd_kernel", ("shortseq_fwd",)),
    ("shortseq_bwd_kernels", ("shortseq_d",)),
    ("causal_fwd_kernel", ("causal_fwd",)),
    ("causal_bwd_kernels", ("dkdv_mma", "dq_mma", "delta_mma", "dkdv_fma",
                            "dq_fma", "delta_fma")),
    ("gemm", ("gemm", "xmma", "cutlass", "gemv", "nvjet")))


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def cuda_ms(torch, fn, iters, flush=None, warmup=2):
    """Median device time of `fn` in ms, CUDA events around each call,
    the L2 cache flushed before each call when `flush` is given."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(nbytes, flops, dtype_name):
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype_name]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def dname(torch, dt):
    return {torch.bfloat16: "bfloat16", torch.float32: "float32"}[dt]


# ---------------------------------------------------------------------------
def kernel_name(mangled):
    """`name<template args>` of a mangled kernel function in a namespace
    (the sources' anonymous one), e.g. dkdv_mma_kernel<128>,
    dkdv_fma_kernel<float,128> or sdpa_fwd_mma_kernel<64,1> (a bool as 0
    or 1)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if m is None:
        return mangled
    at = m.end() + int(m.group(1))         # past the namespace's name
    m = re.match(r"\d+", mangled[at:])
    if m is None:
        return mangled
    start, n = at + m.end(), int(m.group(0))
    name, rest = mangled[start:start + n], mangled[start + n:]
    args = (["float"] if rest.startswith("If") else
            ["bf16"] if rest.startswith("I13__nv_bfloat16") else [])
    args += re.findall(r"L[ib](\d+)E", rest.split("Ev", 1)[0])
    return f"{name}<{','.join(args)}>" if args else name


def ptxas_by_function(log):
    """{kernel: its registers and spills} from nvcc's `-Xptxas -v`
    output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = kernel_name(m.group(1))
        elif fn and ("registers" in line or "spill" in line):
            text = line.split("ptxas info    :")[-1].strip()
            out[fn] = f"{out[fn]}; {text}" if fn in out else text
    return out


def sass_counts(cuobjdump, lib):
    """{kernel function (mangled): {"HMMA": n, "HGMMA": n, "atomics": n}}
    of a built library, from `cuobjdump -sass` (HGMMA is wgmma's
    opcode)."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0, "atomics": 0}
            continue
        m = SASS_OPCODE.search(line)
        if fn is None or m is None:
            continue
        op = m.group(1)
        if op in ("HMMA", "HGMMA"):
            counts[fn][op] += 1
        elif op in SASS_ATOMICS:
            counts[fn]["atomics"] += 1
    return counts


def phase_build(torch, ctx):
    from paddle_tpu_torch.utils import cpp_extension

    t0 = time.perf_counter()
    info = cpp_extension.build()
    secs = time.perf_counter() - t0
    ptxas = {n: ptxas_by_function(i["log"]) for n, i in info.items()}
    smi = nvidia_smi_line()
    ctx["smi"] = smi
    print(smi, flush=True)
    # the tensor cores are reached: every bf16 mma kernel holds HMMA
    # instructions and every wgmma kernel HGMMA ones, no library of them an
    # atomic, and no mma kernel spills
    cuobjdump = os.path.join(os.path.dirname(cpp_extension.find_nvcc()),
                             "cuobjdump")
    sass, ok = {}, True
    for lib, fns in MMA_KERNELS.items():
        counts = sass_counts(cuobjdump, info[lib]["path"])
        sass[lib] = {
            "HMMA": {f: sum(c["HMMA"] for n, c in counts.items() if f in n)
                     for f in fns},
            "atomics": sum(c["atomics"] for c in counts.values())}
        ok &= (all(n > 0 for n in sass[lib]["HMMA"].values())
               and sass[lib]["atomics"] == 0)
    for lib, fns in WGMMA_KERNELS.items():
        counts = sass_counts(cuobjdump, info[lib]["path"])
        sass[lib] = {
            "HGMMA": {f: sum(c["HGMMA"] for n, c in counts.items() if f in n)
                      for f in fns},
            "atomics": sum(c["atomics"] for c in counts.values())}
        ok &= (all(n > 0 for n in sass[lib]["HGMMA"].values())
               and sass[lib]["atomics"] == 0)
    for lib in FMA_LIBS:
        counts = sass_counts(cuobjdump, info[lib]["path"])
        sass[lib] = {"atomics": sum(c["atomics"] for c in counts.values())}
        ok &= sass[lib]["atomics"] == 0
    spills = {f"{lib}: {fn}": text for lib, fns in ptxas.items()
              for fn, text in fns.items()
              if ("_mma_kernel" in fn or lib in SPILL_FREE_LIBS)
              and any(int(a) or int(b) for a, b in SPILL.findall(text))}
    ok &= not spills
    emit({"phase": "build", "ok": bool(ok), "seconds": secs,
          "kernels": {n: {"seconds": i["seconds"], "cached": i["cached"]}
                      for n, i in info.items()},
          "ptxas": ptxas, "sass": sass, "mma_spills": spills,
          "nvidia_smi": smi})
    if not ok:
        raise AssertionError(f"bf16 mma kernels without HMMA, wgmma kernels "
                             f"without HGMMA, with atomics or with spills, or "
                             f"the split walk with atomics or spills: {sass}, "
                             f"spills {spills}")


def _decode_case(torch, dtype, g):
    """Pools and inputs at the engine's decode shape: 8 slots, bs 16, 16
    heads, D 128, 2 layers. Slot 0 is idle (position 0, null table);
    positions sit on block boundaries; slot 6 reads slot 4's first 32
    blocks read-only and writes a private block."""
    slots, bs, heads, D, L = 8, 16, 16, 128, 2
    positions = [0, 15, 16, 511, 1023, 2047, 700, 1300]
    max_blocks = 2048 // bs
    tables = np.zeros((slots, max_blocks), np.int32)
    nxt = 1
    for s, p in enumerate(positions):
        if s == 0:
            continue
        nb = p // bs + 1
        start = 0
        if s == 6:
            tables[s, :32] = tables[4, :32]
            start = 32
        tables[s, start:nb] = np.arange(nxt, nxt + nb - start)
        nxt += nb - start
    num_blocks = nxt
    dev = "cuda"
    kpool = torch.randn((L, num_blocks, bs, heads, D), generator=g,
                        device=dev).to(dtype)
    vpool = torch.randn((L, num_blocks, bs, heads, D), generator=g,
                        device=dev).to(dtype)
    q, kn, vn = (torch.randn((slots, 1, heads, D), generator=g,
                             device=dev).to(dtype) for _ in range(3))
    return dict(q=q, kn=kn, vn=vn, kpool=kpool, vpool=vpool,
                tables_np=tables, tables=torch.from_numpy(tables).to(dev),
                positions=torch.tensor(positions, dtype=torch.int32,
                                       device=dev),
                pos_list=positions, bs=bs, heads=heads, D=D)


def _live_pool_rows(tables, positions, bs):
    """Distinct pool rows (block, row) the step must read: keys 0..pos-1 of
    every slot through its table, a block shared by several slots counted
    once. The row at pos comes from the new k/v, not from the pool."""
    rows = [tables[s, np.arange(p) // bs] * bs + np.arange(p) % bs
            for s, p in enumerate(positions)]
    return int(np.unique(np.concatenate(rows)).size)


def phase_paged_decode(torch, ctx):
    from paddle_tpu_torch.ops.paged_decode import (paged_decode_attention,
                                                   paged_decode_plain)

    g = torch.Generator("cuda").manual_seed(1)
    res = {"phase": "paged_decode", "cases": []}
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        c = _decode_case(torch, dtype, g)
        args = (c["q"], c["kn"], c["vn"])
        kp0, vp0 = c["kpool"].clone(), c["vpool"].clone()
        kp1, vp1 = c["kpool"].clone(), c["vpool"].clone()
        ref = paged_decode_plain(*args, kp0, vp0, 1, c["tables"],
                                 c["positions"])
        out = paged_decode_attention(*args, kp1, vp1, 1, c["tables"],
                                     c["positions"])
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        pools_equal = bool(torch.equal(kp0, kp1) and torch.equal(vp0, vp1))
        tol = TOL[dname(torch, dtype)]
        case = {"dtype": dname(torch, dtype), "max_abs_err": err,
                "tol": tol, "pools_bit_identical": pools_equal}
        ok &= err <= tol and pools_equal and math.isfinite(err)
        if dtype == torch.bfloat16:
            flush = torch.empty(64 * 2 ** 20, dtype=torch.int32,
                                device="cuda")       # 256 MB > L2
            kms = cuda_ms(torch, lambda: paged_decode_attention(
                *args, kp1, vp1, 1, c["tables"], c["positions"]), 50,
                flush)
            pms = cuda_ms(torch, lambda: paged_decode_plain(
                *args, kp0, vp0, 1, c["tables"], c["positions"]), 5,
                flush, warmup=1)
            del flush
            isz = kp1.element_size()
            slots, bs = len(c["pos_list"]), c["bs"]
            row = c["heads"] * c["D"]
            nbytes = (_live_pool_rows(c["tables_np"], c["pos_list"], bs)
                      * row * 2 * isz               # cached k and v, once
                      + 3 * slots * row * isz       # q, knew, vnew
                      + slots * row * isz           # out
                      + 2 * slots * row * isz       # written rows
                      + sum(p // bs + 1 for p in c["pos_list"]) * 4
                      + slots * 4)                  # tables, positions
            flops = 4 * sum(p + 1 for p in c["pos_list"]) * row
            b, by = bound_ms(nbytes, flops, "bfloat16")
            case.update(kernel_ms=kms, plain_ms=pms, bound_ms=b,
                        bound_by=by, library_ms=None, **_split_ranges(c))
            ctx["paged_decode"] = dict(case, shape="slots8 bs16 H16 D128 "
                                       "positions " + str(c["pos_list"]))
        res["cases"].append(case)
    res["shard_cases"], shard_ok = _shard_head_cases(
        torch, g, 1, paged_decode_attention, paged_decode_plain, False)
    ok &= shard_ok
    # no fallback: a CUDA tensor the kernel cannot take raises
    q96 = torch.zeros((2, 1, 2, 96), device="cuda")
    pool96 = torch.zeros((1, 4, 16, 2, 96), device="cuda")
    tb = torch.zeros((2, 4), dtype=torch.int32, device="cuda")
    ps = torch.zeros(2, dtype=torch.int32, device="cuda")
    try:
        paged_decode_attention(q96, q96, q96, pool96, pool96.clone(), 0, tb,
                               ps)
        res["unsupported_head_dim_raises"] = False
    except ValueError:
        res["unsupported_head_dim_raises"] = True
    ok &= res["unsupported_head_dim_raises"]
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("paged_decode kernel disagrees with its plain "
                             "version")


def phase_causal_fwd(torch, ctx):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.flash_attention import (causal_attention_fwd,
                                                      causal_attention_plain,
                                                      dense_attention,
                                                      flash_attention,
                                                      sdpa_backward,
                                                      sdpa_forward)

    g = torch.Generator("cuda").manual_seed(2)
    res = {"phase": "causal_fwd", "cases": []}
    ok = True
    # (dtype, S, BH): one prompt's 16 heads, then a tensor-parallel shard's
    # (bucketed prefill at mp 2 and 4), bf16
    cases = [(dt, S, 16) for dt in (torch.bfloat16, torch.float32)
             for S in (2048, 300)]
    cases += [(torch.bfloat16, S, BH) for BH in SHARD_HEADS
              for S in (2048, 300)]
    for dtype, S, BH in cases:
        D = 128
        q, k, v = (torch.randn((BH, S, D), generator=g,
                               device="cuda").to(dtype)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(D)
        o_ref, l_ref = causal_attention_plain(q, k, v, scale)
        o, lse = causal_attention_fwd(q, k, v, scale)
        o2, lse2 = causal_attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lerr = (lse - l_ref).abs().max().item()
        same = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
        name = dname(torch, dtype)
        case = {"dtype": name, "S": S, "BH": BH, "max_abs_err": err,
                "lse_max_abs_err": lerr, "tol": TOL[name],
                "lse_tol": LSE_TOL[name], "rerun_same_bits": same}
        ok &= err <= TOL[name] and lerr <= LSE_TOL[name] and same
        if dtype == torch.bfloat16 and S == 2048 and BH == 16:
            flush = torch.empty(64 * 2 ** 20, dtype=torch.int32,
                                device="cuda")
            kms = cuda_ms(torch, lambda: causal_attention_fwd(
                q, k, v, scale), 20, flush)
            pms = cuda_ms(torch, lambda: causal_attention_plain(
                q, k, v, scale), 5, flush)
            q4, k4, v4 = (x.view(1, BH, S, D) for x in (q, k, v))
            lms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, scale=scale), 20, flush)
            del flush
            isz = q.element_size()
            nbytes = 4 * BH * S * D * isz + BH * S * 4
            flops = 2 * BH * D * S * (S + 1)
            b, by = bound_ms(nbytes, flops, name)
            case.update(kernel_ms=kms, plain_ms=pms, library_ms=lms,
                        bound_ms=b, bound_by=by,
                        tflops=flops / kms / 1e9,
                        library_tflops=flops / lms / 1e9,
                        share_of_bound=b / kms)
            ctx["causal_fwd"] = dict(case, shape="B1 H16 S2048 D128")
        res["cases"].append(case)
    # the shapes a TPU hands to jax's library kernel, causal or not: B6
    # without a gradient; with one B6's LSE variant, then the library
    # route's backward (no fallback)
    trained, launched = {}, {}
    for name, shape, causal in (("non_causal_b6_shape", (1, 1024, 2, 64),
                                 False),
                                ("causal_b6_shape", (1, 128, 1, 192), True)):
        z = torch.zeros(shape, device="cuda")
        before = sdpa_forward.launches
        with torch.no_grad():
            flash_attention(z, z, z, causal=causal)
        launched[name] = sdpa_forward.launches == before + 1
        zg = z.clone().requires_grad_()
        lse, bwd = sdpa_forward.lse_launches, sdpa_backward.launches
        flash_attention(zg, zg, zg, causal=causal).sum().backward()
        trained[name] = (sdpa_forward.lse_launches == lse + 1
                         and sdpa_backward.launches == bwd + 1
                         and bool(torch.isfinite(zg.grad).all()))
    res["library_backward_with_grad"] = trained
    res["launches_b6_without_grad"] = launched
    ok &= all(trained.values()) and all(launched.values())
    # shapes no kernel takes (causal Sq != Skv, non-causal 64 x 80, causal
    # head dim 96): dense on every device, as in JAX
    z = torch.zeros((1, 64, 2, 64), device="cuda")
    zk = torch.zeros((1, 80, 2, 64), device="cuda")
    z96 = torch.randn((1, 64, 2, 96), generator=g, device="cuda")
    dense = flash_attention.dense_calls
    outs = [flash_attention(z, zk, zk, causal=c) for c in (True, False)]
    o96 = flash_attention(z96, z96, z96, causal=True)
    res["no_kernel_shapes_dense"] = bool(
        flash_attention.dense_calls == dense + 3
        and all(o.shape == z.shape and bool(torch.isfinite(o).all())
                for o in outs)
        and torch.equal(o96, dense_attention(z96, z96, z96, True)))
    ok &= res["no_kernel_shapes_dense"]
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("causal attention kernel disagrees with its "
                             "plain version")


def phase_causal_bwd(torch, ctx):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.flash_attention import (
        causal_attention_bwd, causal_attention_bwd_plain,
        causal_attention_fwd)

    g = torch.Generator("cuda").manual_seed(3)
    res = {"phase": "causal_bwd", "cases": []}
    ok = True
    H, D = 16, 128
    scale = 1.0 / math.sqrt(D)
    # (dtype, batch, S): the training shape, a ragged S, and train_parity's
    # f32 shape
    cases = [(dt, 2, S) for dt in (torch.bfloat16, torch.float32)
             for S in (2048, 300)] + [(torch.float32, 1, 256)]
    for dtype, B, S in cases:
        BH = B * H
        q, k, v, do = (torch.randn((BH, S, D), generator=g,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = causal_attention_fwd(q, k, v, scale)
        ref = causal_attention_bwd_plain(q, k, v, o, do, lse, scale)
        got = causal_attention_bwd(q, k, v, o, do, lse, scale)
        torch.cuda.synchronize()
        name = dname(torch, dtype)
        rel, floor = BWD_TOL[name]
        errs, passed = {}, True
        for gn, a, r in zip(("dq", "dk", "dv"), got, ref):
            err = (a.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            errs[gn] = {"max_abs_err": err, "max_abs_ref": top,
                        "rel_err": err / top if top else None}
            passed &= math.isfinite(err) and err <= rel * top + floor
        case = {"dtype": name, "S": S, "BH": BH, "D": D, "errors": errs,
                "tol_rel": rel, "tol_abs": floor, "ok": bool(passed),
                "max_abs_err": max(e["max_abs_err"]
                                   for e in errs.values())}
        ok &= passed
        if dtype == torch.bfloat16 and S == 2048:
            flush = torch.empty(64 * 2 ** 20, dtype=torch.int32,
                                device="cuda")
            kms = cuda_ms(torch, lambda: causal_attention_bwd(
                q, k, v, o, do, lse, scale), 10, flush)
            pms = cuda_ms(torch, lambda: causal_attention_bwd_plain(
                q, k, v, o, do, lse, scale), 5, flush)
            lms = _library_bwd_ms(
                torch, lambda a, b, c: F.scaled_dot_product_attention(
                    a, b, c, is_causal=True, scale=scale),
                [x.view(B, H, S, D) for x in (q, k, v)],
                do.view(B, H, S, D), flush)
            del flush
            isz = q.element_size()
            nbytes = 8 * BH * S * D * isz + BH * S * 4
            flops = 5 * BH * D * S * (S + 1)
            b, by = bound_ms(nbytes, flops, name)
            case.update(kernel_ms=kms, plain_ms=pms, library_ms=lms,
                        bound_ms=b, bound_by=by,
                        tflops=flops / kms / 1e9,
                        library_tflops=flops / lms / 1e9,
                        share_of_bound=b / kms)
            ctx["causal_bwd"] = dict(case, shape="B2 H16 S2048 D128")
        res["cases"].append(case)
        del q, k, v, do, o, lse, ref, got
    torch.cuda.empty_cache()
    # no fallback: a CUDA tensor the kernel cannot take raises
    z = torch.zeros((2, 8, 96), device="cuda")
    try:
        causal_attention_bwd(z, z, z, z, z, torch.zeros((2, 8),
                                                        device="cuda"))
        res["unsupported_head_dim_raises"] = False
    except ValueError:
        res["unsupported_head_dim_raises"] = True
    ok &= res["unsupported_head_dim_raises"]
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("causal attention backward kernel disagrees "
                             "with its plain version")


def _counted(torch, ctx, path, fn, exact=None):
    """One run of the main path: every kernel count is set to 0 just before
    `fn` and read just after it, into ctx["paths"][path] (the shortseq
    wrappers' masked launches under `<name>_masked`, B6's LSE variant's
    under `sdpa_forward_lse`). The run fails if a
    kernel it must take (PATH_KERNEL) never launched, if any plain version
    was called on the card, or if a count named in `exact` differs."""
    for w in ctx["wrappers"]:
        w.launches = 0
        w.plain_calls = 0
        for attr, _ in EXTRA_COUNTS:
            if hasattr(w, attr):
                setattr(w, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    counts = {}
    for w in ctx["wrappers"]:
        counts[w.__name__] = {"launches": w.launches,
                              "plain_calls": w.plain_calls}
        for attr, suffix in EXTRA_COUNTS:
            if hasattr(w, attr):
                counts[w.__name__ + suffix] = {
                    "launches": getattr(w, attr), "plain_calls": 0}
    ctx["paths"][path] = counts
    if (any(counts[k]["launches"] == 0 for k in PATH_KERNEL[path])
            or any(c["plain_calls"] for c in counts.values())
            or any(counts[k]["launches"] != n
                   for k, n in (exact or {}).items())):
        raise AssertionError(f"main path {path}: kernel counts {counts}, "
                             f"expected {exact}")
    return out


def _model(torch, dtype, seed):
    from paddle_tpu_torch import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt_1p3b()
    g = torch.Generator("cuda").manual_seed(seed)
    m = GPTForCausalLM(cfg, device="cuda", dtype=dtype, generator=g)
    m.eval().requires_grad_(False)
    return m


def kernel_family(name, cat="kernel"):
    """The device-time family of a profiled event (KERNEL_FAMILIES), or
    the event's category."""
    lower = name.lower()
    for family, tags in KERNEL_FAMILIES:
        if any(t in lower for t in tags):
            return family
    return cat if cat != "kernel" else "other kernels"


def _device_breakdown(prof, name):
    """Device time of a profiled window from its chrome trace (written to
    build/paddle_tpu_torch/<name>_trace.json): busy time (the union of
    kernel, memcpy and memset intervals) against the window (first to last
    event of any kind), and kernel time by family."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "paddle_tpu_torch", f"{name}_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, -math.inf
    for e in sorted(dev, key=lambda e: e["ts"]):
        s, f = e["ts"], e["ts"] + e["dur"]
        if f > end:
            busy += f - max(s, end)
            end = f
    fam, by_name = {}, {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        key = kernel_family(e["name"], e["cat"])
        fam[key] = fam.get(key, 0.0) + e["dur"]
    return {"window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (t1 - t0),
            "kernel_launches": sum(e.get("cat") == "kernel" for e in dev),
            "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
                fam.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": {k[:80]: v / 1e3 for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:12]}}


def _engine_trace(V, seed):
    """The serving trace (phase 5): 13 requests of 64-1536 prompt tokens,
    five arriving once the shared 512-token prefix and a 1024-token
    prompt are cached, that prompt repeated whole (a full-prefix hit whose
    first write takes a copy-on-write). Returns (rng, trace)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, V, 512)
    repeat = rng.randint(0, V, 1024)             # block-aligned: full hit
    first = [(rng.randint(0, V, n), m) for n, m in
             ((64, 48), (1536, 32), (300, 64), (777, 40), (128, 56))]
    first += [(repeat, 40), (np.concatenate([shared, rng.randint(0, V, 200)]),
                             48), (rng.randint(0, V, 900), 33)]
    later = [(np.concatenate([shared, rng.randint(0, V, 300)]), 36),
             (repeat, 32),                       # whole repeat: COW
             (rng.randint(0, V, 1200), 44), (rng.randint(0, V, 96), 64),
             (rng.randint(0, V, 450), 50)]
    return rng, dict(first=first, later=later, repeat=repeat, shared=shared)


def _serve_trace(eng, trace, finish=None, params_of=None, adapter_of=None):
    """Serve `trace` on `eng`: the first requests, steps until the repeated
    prompt and the shared prefix are cached (the prompts of `trace["wait"]`
    when given; with the prefix cache off, until the first requests are
    all seated), then the later ones; `finish` (drain() by default: the
    leak check) runs the rest; `params_of(i)` and `adapter_of(i)`, when
    given, are request i's SamplingParams (or None) and adapter id.
    Returns (request ids, results)."""
    def add(i, p, n):
        kw = {}
        if params_of is not None and params_of(i) is not None:
            kw["sampling_params"] = params_of(i)
        if adapter_of is not None:
            kw["adapter_id"] = adapter_of(i)
        return eng.add_request(p, n, **kw)

    first = len(trace["first"])
    ids = [add(i, p, n) for i, (p, n) in enumerate(trace["first"])]
    wait = trace.get("wait", (trace["repeat"], trace["shared"]))
    while (any(eng.cache.warm_prefix_tokens(w) < len(w) for w in wait)
           if eng.enable_prefix_cache else eng.num_pending):
        if eng.step() == 0:
            raise AssertionError("trace ended before its prefixes cached")
    ids += [add(first + i, p, n) for i, (p, n) in enumerate(trace["later"])]
    return ids, (finish or (lambda e: e.drain()))(eng)


def _outputs_ok(ids, out, reqs, V):
    return all(out[r] is not None and len(out[r]) == len(p) + n
               and all(0 <= t < V for t in out[r])
               for r, (p, n) in zip(ids, reqs))


def _drain_profiled(torch, ctx, name):
    """drain(), under torch.profiler with `--profile` (its device-time
    breakdown printed as phase `<name>_profile`)."""
    def drain(eng):
        if not ctx.get("profile"):
            return eng.drain()
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = eng.drain()
            torch.cuda.synchronize()
        emit(dict(phase=f"{name}_profile",
                  **_device_breakdown(prof, name)))
        return out
    return drain


def phase_engine(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine

    model = _model(torch, torch.bfloat16, seed)
    V = model.config.vocab_size
    rng, trace = _engine_trace(V, seed)
    eng = GenerationEngine(model, num_slots=8, block_size=16)
    torch.cuda.synchronize()

    def serve():
        return _serve_trace(eng, trace,
                            _drain_profiled(torch, ctx, "engine"))

    t0 = time.perf_counter()
    ids, out = _counted(torch, ctx, "engine_bf16", serve)
    wall = time.perf_counter() - t0
    reqs = trace["first"] + trace["later"]
    shapes_ok = _outputs_ok(ids, out, reqs, V)
    ctx["engine_tokens"] = [out[r] for r in ids]
    # the model's own serving entry near full context (causal kernel)
    prompt = torch.from_numpy(rng.randint(0, V, 2040).astype(np.int32))
    gen = _counted(torch, ctx, "generate_bf16", lambda: model.generate(
        prompt[None].cuda(), max_length=2048, use_cache=True))
    gen_ok = gen.shape == (1, 2048) and bool((gen >= 0).all()
                                              and (gen < V).all())
    res = {"phase": "engine", "config": "gpt_1p3b bf16 (hidden 2048, 24 "
           "layers, 16 heads, vocab 50304, max_seq_len 2048)",
           "requests": len(reqs), "wall_s": wall,
           "tokens_generated": eng.tokens_generated,
           "tokens_per_s": eng.tokens_generated / wall,
           "prefill_chunks": eng.prefill_chunks,
           "decode_steps": eng.decode_steps,
           "prefix_hit_tokens": eng.prefix_hit_tokens,
           "cow_copies": eng.cow_copies, "stalls": eng.stalls,
           "leak_check": "passed", "outputs_ok": shapes_ok,
           "generate_2040_ok": gen_ok,
           "kernel_counts": {p: ctx["paths"][p]
                             for p in ("engine_bf16", "generate_bf16")}}
    res["ok"] = bool(shapes_ok and gen_ok and eng.prefix_hit_tokens > 0
                     and eng.cow_copies >= 1)
    emit(res)
    del eng, model
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("engine phase failed its checks")


def phase_generate_parity(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine

    model = _model(torch, torch.float32, seed)
    V = model.config.vocab_size
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(0, V, 256), rng.randint(0, V, 300)]
    new = 16
    eng = GenerationEngine(model, num_slots=2, block_size=16)

    def serve():
        ids = [eng.add_request(p, new) for p in prompts]
        out = eng.drain()
        return [out[r] for r in ids]

    def generate():
        return [model.generate(torch.from_numpy(p.astype(np.int32))[None]
                               .cuda(), max_length=len(p) + new,
                               use_cache=True)[0].cpu().numpy()
                for p in prompts]

    outs = _counted(torch, ctx, "engine_f32", serve)
    refs = _counted(torch, ctx, "generate_f32", generate)
    res = {"phase": "generate_parity", "dtype": "float32", "cases": [],
           "kernel_counts": {p: ctx["paths"][p]
                             for p in ("engine_f32", "generate_f32")}}
    ok = True
    for got, ref, p in zip(outs, refs, prompts):
        got = np.asarray(got)
        case = {"prompt_len": len(p), "identical": bool(
            np.array_equal(got, ref))}
        if not case["identical"]:
            at = int(np.nonzero(got != ref)[0][0])
            with torch.no_grad():
                logits = model(torch.from_numpy(ref[:at].astype(np.int32))
                               [None].cuda())[0, -1].float()
            top2 = torch.topk(logits, 2).values
            gap = float(top2[0] - top2[1])
            case.update(first_diff=at, top2_gap=gap,
                        near_tie=gap <= 1e-3)
            ok &= gap <= 1e-3
        res["cases"].append(case)
    res["ok"] = bool(ok)
    emit(res)
    del eng, model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("engine tokens differ from generate()")


def _bench_config():
    """bench.py's GPT-1.3B training configuration."""
    from paddle_tpu_torch import GPTConfig

    return GPTConfig(vocab_size=32768, hidden_size=2048, num_layers=24,
                     num_heads=16, max_seq_len=2048, dropout=0.0)


def phase_train(torch, ctx, seed):
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep

    cfg = _bench_config()
    batch, seq, warm, timed, refeed = 2, 2048, 2, 5, 3
    g = torch.Generator("cuda").manual_seed(seed)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=g).train()
    step = TrainStep(model, AdamW(learning_rate=1e-4,
                                  parameters=model.parameters()),
                     model.loss_fn)
    # one distinct batch per step, as bench.py feeds them (run_scan)
    rng = np.random.RandomState(seed + 2)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (warm + timed, batch, seq))
                           .astype(np.int64)).cuda()
    torch.cuda.reset_peak_memory_stats()
    warm_losses = step.run_scan(ids[:warm], ids[:warm])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = _counted(torch, ctx, "train_bf16",
                      lambda: step.run_scan(ids[warm:], ids[warm:]),
                      exact={OPT: timed})
    wall = time.perf_counter() - t0
    losses = [float(x) for x in torch.cat([warm_losses, losses])]
    # fresh random batches barely lower the loss in 7 bf16 steps; that the
    # updates take hold shows on one batch fed again (outside the timing)
    refeed_losses = [float(x) for x in
                     step.run_repeat(ids[0], ids[0], refeed)]
    ms = wall / timed * 1e3
    tok_s = batch * seq * timed / wall
    counts = ctx["paths"]["train_bf16"]
    res = {"phase": "train", "config": "bench.py gpt_1p3b train (vocab "
           "32768, hidden 2048, 24 layers, 16 heads, seq 2048, dropout 0), "
           "bf16 params, AdamW(1e-4), batch 2", "params": model.num_params(),
           "warmup_steps": warm, "timed_steps": timed, "ms_per_step": ms,
           "tokens_per_s": tok_s,
           "model_flop_share_of_989tflops": model.flops_per_token(seq)
           * tok_s / PEAK_FLOPS["bfloat16"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "refeed_losses": refeed_losses,
           "kernel_counts": counts}
    ctx["train_peak_gb"] = res["peak_memory_gb"]
    per_step = {k: counts[k]["launches"] / timed for k in (FWD, BWD)}
    res["launches_per_step"] = per_step
    res["optimizer_launches_per_step"] = counts[OPT]["launches"] / timed
    res["peak_memory_gb_with_the_loop"] = LOOP_PEAK_GB["train"]
    # the optimizer's share of a step: one more forward and backward, then
    # AdamW's update alone between CUDA events
    model.zero_grad(set_to_none=True)
    model(ids[0], labels=ids[0]).backward()
    t_opt = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t_opt[0].record()
    step.optimizer.step()
    t_opt[1].record()
    torch.cuda.synchronize()
    step.optimizer.clear_grad()
    res["optimizer_step_ms"] = t_opt[0].elapsed_time(t_opt[1])
    res["ok"] = bool(all(math.isfinite(x) for x in losses + refeed_losses)
                     and refeed_losses[-1] < refeed_losses[0]
                     and all(n == cfg.num_layers for n in per_step.values())
                     and res["peak_memory_gb"]
                     <= LOOP_PEAK_GB["train"] + PEAK_SLACK_GB)
    emit(res)
    if ctx.get("profile"):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(ids[1], ids[1])
            torch.cuda.synchronize()
        emit(dict(phase="train_profile", **_device_breakdown(prof, "train")))
    del step, model
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("train phase failed its checks")


def _worst_leaf(got, want):
    """Relative L2 error ||got - want|| / ||want|| of every parameter's
    tensor (`got` on the card, `want` on the CPU): (the worst parameter,
    its error, every parameter's error)."""
    errs = {}
    for n, w in want.items():
        w = w.double()
        d = (got[n].cpu().double() - w).norm().item()
        top = w.norm().item()
        errs[n] = d / top if top else d
    worst = max(errs, key=errs.get)
    return worst, errs[worst], errs


def _qkv_key_third(torch, d):
    """`d` split into (the rest, the key third of each fused qkv bias)."""
    out, key = {}, {}
    for n, t in d.items():
        if n.endswith("qkv_proj.bias"):
            q, k, v = t.chunk(3)
            out[n + "[q,v]"] = torch.cat([q, v])
            key[n + "[k]"] = k
        else:
            out[n] = t
    return out, key


def _k_proj_bias(torch, d):
    """`d` split into (the rest, each attention's k_proj.bias)."""
    out, key = {}, {}
    for n, t in d.items():
        (key if n.endswith("k_proj.bias") else out)[n] = t
    return out, key


def _update_errs(torch, got, want, tol, lr, steps, split=_qkv_key_third):
    """The change of the parameters over `steps` AdamW steps at `lr`
    (`got` on the card, `want` on the CPU), with the key bias held apart
    by `split` (see TRAIN_PARITY_TOL): the worst parameter and its
    relative L2 error, every parameter's, the key biases' largest change
    in units of steps * lr, and whether both are within `tol`."""
    (card, key), (host, _) = split(torch, got), split(torch, want)
    leaf, err, errs = _worst_leaf(card, host)
    key_step = max(k.abs().max().item() for k in key.values()) / (steps * lr)
    return {"update_worst_leaf": leaf, "update_rel_err": err,
            "update_rel_err_by_leaf": errs, "key_bias_max_step": key_step,
            "update_ok": bool(err <= tol["update"]
                              and key_step <= tol["key_bias_step"])}


def phase_train_parity(torch, ctx, seed):
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep

    cfg = _bench_config()
    cfg.num_layers = 2
    steps, batch, seq, lr = 3, 1, 256, 1e-4
    g = torch.Generator("cuda").manual_seed(seed)
    card = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                          generator=g).train()
    host = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32).train()
    host.load_state_dict({k: v.cpu() for k, v in
                          card.state_dict().items()})
    rng = np.random.RandomState(seed + 3)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (steps, batch, seq))
                           .astype(np.int64))

    def run(model, x):
        """The first batch's gradients (one forward and backward), then
        the AdamW steps: (losses, grads, parameter changes)."""
        model.zero_grad(set_to_none=True)
        model(x[0], labels=x[0]).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = TrainStep(model, AdamW(learning_rate=lr,
                                      parameters=model.parameters()),
                         model.loss_fn)
        losses = [float(v) for v in step.run_scan(x, x)]
        return losses, grads, {n: p.detach() - before[n]
                               for n, p in model.named_parameters()}

    got, g_card, d_card = _counted(torch, ctx, "train_f32",
                                   lambda: run(card, ids.cuda()))
    want, g_host, d_host = run(host, ids)
    diffs = [abs(a - b) for a, b in zip(got, want)]
    grad_leaf, grad_err, grad_errs = _worst_leaf(g_card, g_host)
    tol = TRAIN_PARITY_TOL
    upd = _update_errs(torch, d_card, d_host, tol, lr, steps)
    res = {"phase": "train_parity", "dtype": "float32", "config": "bench "
           "widths, 2 layers, batch 1, seq 256, AdamW(1e-4), 3 steps",
           "card_losses": got, "cpu_losses": want,
           "loss_max_abs_diff": max(diffs),
           "grad_worst_leaf": grad_leaf, "grad_rel_err": grad_err,
           "grad_rel_err_by_leaf": grad_errs, **upd, "tol": tol,
           "kernel_counts": ctx["paths"]["train_f32"]}
    res["ok"] = bool(max(diffs) <= tol["loss"] and grad_err <= tol["grad"]
                     and upd["update_ok"]
                     and all(math.isfinite(x) for x in got))
    emit(res)
    del card, host
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("f32 train steps on the card differ from the "
                             "CPU")


# ---------------------------------------------------------------------------
# speculative decoding and int8 KV
#
# The null block 0 is a race, not a reference: idle lanes, dead window rows
# of every slot and (int8) candidate blocks past a table all write it, from
# concurrent CTAs on the card. So pools are compared outside block 0 and
# outputs on the live rows of live slots only.
# ---------------------------------------------------------------------------

def _window_case(torch, g, W, dtype, int8, heads=16):
    """Pools and inputs at the engine's shapes: 8 slots, bs 16, `heads`
    heads (16, or a tensor-parallel shard's), D 128, 2 layers, W rows per
    slot (W 1 is the decode step). Decode's
    position mix with draft lengths 0-4: slot 0 idle; slot 1's window
    starts in its first block and crosses into the second; windows at
    511 and 1023 cross a block; slot 5's ends at position 2047, the
    table's last; slot 6 reads slot 4's first 32 blocks read-only. int8:
    normal rows quantized on per-block grids 0.7-1.3x absmax / 127."""
    from paddle_tpu_torch.ops.paged_attention import _quant_rows

    slots, bs, D, L = 8, 16, 128, 2
    if W == 1:
        positions, dlens = [0, 15, 16, 511, 1023, 2047, 700, 1300], [0] * 8
    else:
        positions = [0, 13, 16, 511, 1023, 2043, 700, 1300]
        dlens = [0, 4, 0, 1, 2, 4, 3, 4]
        dlens = [min(d, W - 1) for d in dlens]
    max_blocks = 2048 // bs
    tables = np.zeros((slots, max_blocks), np.int32)
    nxt = 1
    for s, (p, d) in enumerate(zip(positions, dlens)):
        if s == 0:
            continue
        nb = (p + d) // bs + 1
        start = 0
        if s == 6:
            tables[s, :32] = tables[4, :32]
            start = 32
        tables[s, start:nb] = np.arange(nxt, nxt + nb - start)
        nxt += nb - start
    dev = "cuda"
    shape = (L, nxt, bs, heads, D)
    kpool, vpool = (torch.randn(shape, generator=g, device=dev)
                    for _ in range(2))
    scales = None
    if int8:
        amax = torch.stack([kpool.abs().amax((2, 3, 4)),
                            vpool.abs().amax((2, 3, 4))], -1)
        scales = amax / 127 * (0.7 + 0.6 * torch.rand(
            amax.shape, generator=g, device=dev))
        kpool, vpool = (_quant_rows(x, scales[..., i, None, None, None])
                        for i, x in enumerate((kpool, vpool)))
    else:
        kpool, vpool = kpool.to(dtype), vpool.to(dtype)
    q, kn, vn = (torch.randn((slots, W, heads, D), generator=g,
                             device=dev).to(dtype) for _ in range(3))
    live = np.arange(W)[None, :] <= np.array(dlens)[:, None]
    live[0] = False
    return dict(q=q, kn=kn, vn=vn, kpool=kpool, vpool=vpool, scales=scales,
                tables_np=tables, tables=torch.from_numpy(tables).to(dev),
                positions=torch.tensor(positions, dtype=torch.int32,
                                       device=dev),
                dlens=torch.tensor(dlens, dtype=torch.int32, device=dev),
                pos_list=positions, dlen_list=dlens,
                live=torch.from_numpy(live).to(dev), bs=bs, heads=heads,
                D=D, W=W)


def _window_bound(c, isz_q, isz_pool, dtype_name):
    """The least time for one step at case `c`: bytes (the distinct pool
    rows below each window, k and v, once; the scale rows of the blocks
    read, int8; q, the new rows, their writes, the output; tables,
    positions, draft lengths) over the memory rate, and the live rows'
    QK and PV products over the dtype's peak."""
    bs, row = c["bs"], c["heads"] * c["D"]
    slots, W = len(c["pos_list"]), c["W"]
    live = int(c["live"].sum())
    blocks = sum((p + d) // bs + 1
                 for p, d in zip(c["pos_list"], c["dlen_list"]))
    nbytes = (_live_pool_rows(c["tables_np"], c["pos_list"], bs)
              * row * 2 * isz_pool                  # cached k and v, once
              + slots * W * row * (2 * isz_q        # q, out
                                   + 2 * isz_pool)  # knew, vnew
              + 2 * live * row * isz_pool           # written rows
              + blocks * 4 + slots * 8)             # tables, pos, dlen
    if isz_pool == 1:
        nbytes += blocks * 8                        # scale rows
    flops = 4 * row * sum(p + w + 1 for s, (p, d) in enumerate(
        zip(c["pos_list"], c["dlen_list"])) for w in range(W)
        if bool(c["live"][s, w]))
    return bound_ms(nbytes, flops, dtype_name)


def _kernel_vs_plain(torch, c, kernel, plain, int8, layer=1):
    """Quantize once (int8), then the plain version and the kernel on
    clones of the same pools. Returns (output error on live rows, pools
    bit-identical outside block 0, scales untouched, args for timing)."""
    from paddle_tpu_torch.ops import paged_attention as tpa

    q, kn, vn = c["q"], c["kn"], c["vn"]
    if int8:
        if c["W"] == 1:
            kn, vn = tpa._quant_write_decode(
                c["kpool"], c["vpool"], c["scales"], kn, vn, c["tables"],
                c["positions"], layer)
            kn, vn = kn[:, None].contiguous(), vn[:, None].contiguous()
        else:
            kn, vn = tpa._quant_write_window(
                c["kpool"], c["vpool"], c["scales"], kn, vn, c["tables"],
                c["positions"], c["dlens"], layer)
    sc0 = None if c["scales"] is None else c["scales"].clone()
    pre = (c["scales"][layer],) if int8 else ()
    post = () if c["W"] == 1 else (c["dlens"],)
    kp0, vp0 = c["kpool"].clone(), c["vpool"].clone()
    kp1, vp1 = c["kpool"].clone(), c["vpool"].clone()
    tail = (layer, c["tables"], c["positions"]) + post
    ref = plain(q, kn, vn, kp0, vp0, *pre, *tail)
    out = kernel(q, kn, vn, kp1, vp1, *pre, *tail)
    torch.cuda.synchronize()
    live = c["live"]
    err = (out.float() - ref.float())[live].abs().max().item()
    pools = bool(torch.equal(kp0[:, 1:], kp1[:, 1:])
                 and torch.equal(vp0[:, 1:], vp1[:, 1:]))
    scales = sc0 is None or bool(torch.equal(sc0, c["scales"]))
    return err, pools, scales, ((q, kn, vn, kp1, vp1) + pre + tail,
                                (q, kn, vn, kp0, vp0) + pre + tail)


def _split_ranges(c):
    """The split walk's ranges at case `c` (a decode case has no draft
    lengths): those of its grid (from the table's width) and those its
    CTAs walk (every head of a slot walks ranges 0 .. (pos + dlen) //
    RANGE_KEYS)."""
    from paddle_tpu_torch.ops.paged_decode import RANGE_KEYS, split_ranges

    dlens = c.get("dlen_list") or [0] * len(c["pos_list"])
    return {"range_keys": RANGE_KEYS,
            "ranges_in_grid": split_ranges(c["tables_np"].shape[1], c["bs"]),
            "ranges_walked": c["heads"] * sum(
                (p + d) // RANGE_KEYS + 1
                for p, d in zip(c["pos_list"], dlens))}


def _time_paged(torch, kernel, plain, kargs, pargs):
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32,
                        device="cuda")               # 256 MB > L2
    kms = cuda_ms(torch, lambda: kernel(*kargs), 50, flush)
    pms = cuda_ms(torch, lambda: plain(*pargs), 5, flush, warmup=1)
    return kms, pms


def _shard_head_cases(torch, g, W, kernel, plain, int8):
    """A paged kernel at a tensor-parallel shard's heads (SHARD_HEADS, bf16,
    the engine's shapes otherwise) against its plain version on the same
    inputs, as the 16-head case is held. Returns (cases, all passed)."""
    cases, ok = [], True
    for heads in SHARD_HEADS:
        c = _window_case(torch, g, W, torch.bfloat16, int8, heads=heads)
        err, pools, scales, _ = _kernel_vs_plain(torch, c, kernel, plain,
                                                 int8)
        tol = TOL["bfloat16"]
        good = math.isfinite(err) and err <= tol and pools and scales
        cases.append({"kernel": kernel.__name__, "heads": heads,
                      "dtype": "bfloat16", "max_abs_err": err, "tol": tol,
                      "pools_bit_identical_outside_block0": pools,
                      "scales_untouched": scales, "ok": bool(good)})
        ok &= good
        del c
    return cases, ok


def phase_paged_verify(torch, ctx):
    from paddle_tpu_torch.ops.paged_verify import (paged_verify_attention,
                                                   paged_verify_plain)

    g = torch.Generator("cuda").manual_seed(4)
    res = {"phase": "paged_verify", "cases": []}
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        c = _window_case(torch, g, SPEC_K + 1, dtype, int8=False)
        err, pools, _, (kargs, pargs) = _kernel_vs_plain(
            torch, c, paged_verify_attention, paged_verify_plain, False)
        name = dname(torch, dtype)
        case = {"dtype": name, "max_abs_err": err, "tol": TOL[name],
                "pools_bit_identical_outside_block0": pools}
        ok &= err <= TOL[name] and pools and math.isfinite(err)
        if dtype == torch.bfloat16:
            kms, pms = _time_paged(torch, paged_verify_attention,
                                   paged_verify_plain, kargs, pargs)
            isz = c["q"].element_size()
            b, by = _window_bound(c, isz, isz, name)
            case.update(kernel_ms=kms, plain_ms=pms, bound_ms=b,
                        bound_by=by, library_ms=None, **_split_ranges(c))
            ctx["paged_verify"] = dict(case, shape=(
                f"slots8 W{SPEC_K + 1} bs16 H16 D128 positions "
                f"{c['pos_list']} draft_lens {c['dlen_list']}"))
        res["cases"].append(case)
    res["shard_cases"], shard_ok = _shard_head_cases(
        torch, g, SPEC_K + 1, paged_verify_attention, paged_verify_plain,
        False)
    ok &= shard_ok
    # no fallback: a window the kernel cannot take raises on the card
    q = torch.zeros((2, 10, 2, 64), device="cuda")
    pool = torch.zeros((1, 4, 16, 2, 64), device="cuda")
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    try:
        paged_verify_attention(q, q, q, pool, pool.clone(), 0,
                               torch.zeros((2, 4), dtype=torch.int32,
                                           device="cuda"), z, z)
        res["window_10_raises"] = False
    except ValueError:
        res["window_10_raises"] = True
    ok &= res["window_10_raises"]
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("paged verify kernel disagrees with its plain "
                             "version")


def phase_paged_int8(torch, ctx):
    from paddle_tpu_torch.ops.paged_decode import (
        paged_decode_attention_int8, paged_decode_int8_plain)
    from paddle_tpu_torch.ops.paged_verify import (
        paged_verify_attention_int8, paged_verify_int8_plain)

    g = torch.Generator("cuda").manual_seed(5)
    res = {"phase": "paged_int8", "cases": []}
    ok = True
    for key, W, kernel, plain in (
            ("paged_decode_int8", 1, paged_decode_attention_int8,
             paged_decode_int8_plain),
            ("paged_verify_int8", SPEC_K + 1, paged_verify_attention_int8,
             paged_verify_int8_plain)):
        for dtype in (torch.bfloat16, torch.float32):
            c = _window_case(torch, g, W, dtype, int8=True)
            err, pools, scales, (kargs, pargs) = _kernel_vs_plain(
                torch, c, kernel, plain, True)
            name = dname(torch, dtype)
            case = {"kernel": kernel.__name__, "dtype": name,
                    "max_abs_err": err, "tol": TOL[name],
                    "codes_bit_identical_outside_block0": pools,
                    "scales_untouched": scales}
            ok &= err <= TOL[name] and pools and scales \
                and math.isfinite(err)
            if dtype == torch.bfloat16:
                kms, pms = _time_paged(torch, kernel, plain, kargs, pargs)
                b, by = _window_bound(c, c["q"].element_size(), 1, name)
                case.update(kernel_ms=kms, plain_ms=pms, bound_ms=b,
                            bound_by=by, library_ms=None, **_split_ranges(c))
                ctx[key] = dict(case, shape=(
                    f"slots8 W{W} bs16 H16 D128 int8 pools, q bf16, "
                    f"positions {c['pos_list']} draft_lens "
                    f"{c['dlen_list']}"))
            res["cases"].append(case)
        shard, shard_ok = _shard_head_cases(torch, g, W, kernel, plain, True)
        res.setdefault("shard_cases", []).extend(shard)
        ok &= shard_ok
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("int8 paged kernels disagree with their plain "
                             "versions")


def _token_match_fraction(ref_outs, got_outs):
    """The JAX package's int8 budget metric (bench_ops.py, copied):
    fraction of positionally matching tokens across two runs' aligned
    output lists (prompt + generated per request)."""
    match = total = 0
    for a, b in zip(ref_outs, got_outs):
        n = max(len(a), len(b))
        total += n
        match += sum(x == y for x, y in zip(a, b))
    return match / max(total, 1)


def _token_share(outs, refs, reqs):
    """Share of generated tokens equal, position by position, to `refs`."""
    same = total = 0
    for o, r, (p, _) in zip(outs, refs, reqs):
        same += sum(a == b for a, b in zip(o[len(p):], r[len(p):]))
        total += len(r) - len(p)
    return same / total


def phase_engine_spec(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine

    model = _model(torch, torch.bfloat16, seed)
    V = model.config.vocab_size
    _, trace = _engine_trace(V, seed)
    motif = np.random.RandomState(seed + 4).randint(0, V, 64)
    trace["first"] = trace["first"] + [(np.tile(motif, 8), 64)]
    eng = GenerationEngine(model, num_slots=8, block_size=16,
                           spec_decode_k=SPEC_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, out = _counted(torch, ctx, "engine_spec_bf16",
                        lambda: _serve_trace(eng, trace, _drain_profiled(
                            torch, ctx, "engine_spec")))
    wall = time.perf_counter() - t0
    reqs = trace["first"] + trace["later"]
    proposed = eng.spec_accepted_tokens + eng.spec_rejected_tokens
    res = {"phase": "engine_spec", "config": "gpt_1p3b bf16, 8 slots, "
           f"block 16, spec_decode_k={SPEC_K}, NgramDrafter",
           "requests": len(reqs), "wall_s": wall,
           "tokens_generated": eng.tokens_generated,
           "tokens_per_s": eng.tokens_generated / wall,
           "verify_steps": eng.decode_steps,
           "accepted_per_verify_step": eng.spec_accepted_tokens
           / max(eng.decode_steps, 1),
           "accepted_draft_tokens": eng.spec_accepted_tokens,
           "rejected_draft_tokens": eng.spec_rejected_tokens,
           "acceptance": eng.spec_accepted_tokens / proposed
           if proposed else None,
           "spec_degrade_stalls": eng.stalls["spec_degrade"],
           "stalls": eng.stalls, "prefill_chunks": eng.prefill_chunks,
           "prefix_hit_tokens": eng.prefix_hit_tokens,
           "cow_copies": eng.cow_copies, "leak_check": "passed",
           "kernel_counts": ctx["paths"]["engine_spec_bf16"]}
    m = len(trace["first"]) - 1                  # the motif request
    if "engine_tokens" in ctx:                   # against phase 5's K=0
        keep = [i for i in range(len(ids)) if i != m]
        res["share_equal_to_k0_bf16"] = _token_share(
            [out[ids[i]] for i in keep], ctx["engine_tokens"],
            [reqs[i] for i in keep])
    motif_out = out[ids[m]]
    res["motif_request_ok"] = bool(len(motif_out) == 512 + 64)
    res["outputs_ok"] = _outputs_ok(ids, out, reqs, V)
    res["ok"] = bool(res["outputs_ok"] and res["motif_request_ok"]
                     and eng.spec_accepted_tokens > 0
                     and eng.prefix_hit_tokens > 0 and eng.cow_copies >= 1)
    emit(res)
    del eng, model
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("engine_spec phase failed its checks")


class _OracleDrafter:
    """Proposes a reference run's continuation of each prompt."""

    def __init__(self, prompts, outputs):
        self.ref = {bytes(np.asarray(p, np.int32)): list(o)
                    for p, o in zip(prompts, outputs)}

    def propose(self, prompt, generated, k):
        out = self.ref[bytes(np.asarray(prompt, np.int32))]
        n = len(prompt) + len(generated)
        return out[n:n + k]


def _first_diff(torch, model, got, ref):
    """(index of the first differing token, top-2 logit gap there)."""
    at = int(np.nonzero(np.asarray(got) != np.asarray(ref))[0][0])
    with torch.no_grad():
        logits = model(torch.from_numpy(np.asarray(ref[:at], np.int32))
                       [None].cuda())[0, -1].float()
    top2 = torch.topk(logits, 2).values
    return at, float(top2[0] - top2[1])


def phase_spec_parity(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine

    model = _model(torch, torch.float32, seed)
    V = model.config.vocab_size
    rng = np.random.RandomState(seed + 1)        # phase 6's prompts
    prompts = [rng.randint(0, V, 256), rng.randint(0, V, 300)]
    new = 16
    runs = {}

    def serve(**kw):
        eng = GenerationEngine(model, num_slots=2, block_size=16, **kw)
        ids = [eng.add_request(p, new) for p in prompts]
        out = eng.drain()
        return eng, [out[r] for r in ids]

    def all_runs():
        runs["k0"] = serve()
        runs["ngram"] = serve(spec_decode_k=SPEC_K)
        runs["oracle"] = serve(spec_decode_k=SPEC_K, drafter=_OracleDrafter(
            prompts, runs["k0"][1]))

    _counted(torch, ctx, "spec_f32", all_runs)
    res = {"phase": "spec_parity", "dtype": "float32", "runs": {},
           "kernel_counts": ctx["paths"]["spec_f32"]}
    ok = True
    base = runs["k0"][1]
    for name in ("ngram", "oracle"):
        eng, outs = runs[name]
        proposed = eng.spec_accepted_tokens + eng.spec_rejected_tokens
        run = {"accepted": eng.spec_accepted_tokens,
               "rejected": eng.spec_rejected_tokens,
               "verify_steps": eng.decode_steps, "cases": []}
        for got, ref, p in zip(outs, base, prompts):
            case = {"prompt_len": len(p),
                    "identical": bool(np.array_equal(got, ref))}
            if not case["identical"]:
                at, gap = _first_diff(torch, model, got, ref)
                case.update(first_diff=at, top2_gap=gap,
                            near_tie=gap <= 1e-3)
                ok &= gap <= 1e-3
            run["cases"].append(case)
        if name == "oracle":
            run["accepted_share"] = eng.spec_accepted_tokens / proposed \
                if proposed else 0.0
            ok &= run["accepted_share"] > 0.5
        res["runs"][name] = run
    res["k0_decode_steps"] = runs["k0"][0].decode_steps
    res["ok"] = bool(ok)
    emit(res)
    del runs, model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("speculative tokens differ from K=0")


def phase_engine_int8(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine

    model = _model(torch, torch.bfloat16, seed)
    V = model.config.vocab_size
    _, trace = _engine_trace(V, seed)
    reqs = trace["first"] + trace["later"]
    if "engine_tokens" not in ctx:                 # phase 5 did not run
        eng = GenerationEngine(model, num_slots=8, block_size=16)
        ids, out = _counted(torch, ctx, "engine_bf16",
                            lambda: _serve_trace(eng, trace))
        ctx["engine_tokens"] = [out[r] for r in ids]
        del eng
    res = {"phase": "engine_int8", "config": "gpt_1p3b bf16 model, int8 "
           "KV pools, 8 slots, block 16", "runs": {},
           "token_parity_min": TOKEN_PARITY_MIN}
    ok = True
    for path, K in (("engine_int8_bf16", 0),
                    ("engine_int8_spec_bf16", SPEC_K)):
        eng = GenerationEngine(model, num_slots=8, block_size=16,
                               kv_dtype="int8", spec_decode_k=K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, out = _counted(torch, ctx, path,
                            lambda: _serve_trace(eng, trace, _drain_profiled(
                                torch, ctx, path)))
        wall = time.perf_counter() - t0
        outs = [out[r] for r in ids]
        fp_bytes = 2 * eng.cache.kpool.numel() * 2       # bf16 k and v
        share = _token_match_fraction(ctx["engine_tokens"], outs)
        diverged = []
        for i, (o, r, (p, _)) in enumerate(zip(outs, ctx["engine_tokens"],
                                               reqs)):
            if o != r:
                at, gap = _first_diff(torch, model, o, r)
                diverged.append({"request": i, "prompt_len": len(p),
                                 "first_diff_generated": at - len(p),
                                 "generated": len(r) - len(p),
                                 "bf16_top2_gap": gap})
        run = {"spec_decode_k": K, "wall_s": wall,
               "tokens_generated": eng.tokens_generated,
               "tokens_per_s": eng.tokens_generated / wall,
               "decode_steps": eng.decode_steps,
               "pool_nbytes": eng.cache.pool_nbytes(),
               "bf16_pool_nbytes": fp_bytes,
               "pool_bytes_ratio": eng.cache.pool_nbytes() / fp_bytes,
               "token_match_fraction": share,
               "generated_share_equal_to_bf16_k0": _token_share(
                   outs, ctx["engine_tokens"], reqs),
               "diverged_requests": diverged,
               "outputs_ok": _outputs_ok(ids, out, reqs, V),
               "leak_check": "passed", "kernel_counts": ctx["paths"][path]}
        if K:
            run.update(accepted=eng.spec_accepted_tokens,
                       rejected=eng.spec_rejected_tokens)
        ok &= run["outputs_ok"] and share >= TOKEN_PARITY_MIN
        res["runs"][path] = run
        del eng
        torch.cuda.empty_cache()
    res["ok"] = bool(ok)
    emit(res)
    del model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("int8 engine outside its token budget")


# ---------------------------------------------------------------------------
# the encoder path: shortseq attention and BERT
# ---------------------------------------------------------------------------

def _key_mask(torch, rows, S, lens):
    """Additive fp32 key mask `[rows, S]` at -1e30, as BertModel makes it:
    row i keeps its first lens[i] keys."""
    keep = torch.arange(S, device="cuda")[None] < torch.tensor(
        lens, device="cuda")[:, None]
    return torch.where(keep, 0.0, -1e30).float().contiguous()


def _test_mask(torch, B, S):
    """Padded tails of different lengths; the last sequence all padding."""
    lens = [S - (37 * i) % S for i in range(B)]
    lens[-1] = 0
    return _key_mask(torch, B, S, lens)


def _bench_mask(torch, B, S, seed):
    """bench-shape padding: each row keeps 128..S real tokens."""
    lens = np.random.RandomState(seed).randint(128, S + 1, B).tolist()
    return _key_mask(torch, B, S, lens), lens


def _shortseq_bound(BH, S, D, isz, B, masked, fwd):
    """Bytes: q, k, v read and O, the LSE written (forward); q, k, v, O, dO,
    the LSE read and dq, dk, dv written (backward); the mask read. FLOP: 4
    (forward) or 10 (backward) * BH * S^2 * D, the TPU kernel's products."""
    slabs = 4 if fwd else 8
    nbytes = slabs * BH * S * D * isz + BH * S * 4 + (B * S * 4 if masked
                                                       else 0)
    flops = (4 if fwd else 10) * BH * S * S * D
    return bound_ms(nbytes, flops, "bfloat16")


def _shortseq_fwd_case(torch, kernel, plain, q, k, v, scale, km, name):
    """The forward kernel against its plain version on one input: O per
    sequence within SHORTSEQ_FWD_TOL, the LSE within SHORTSEQ_LSE_TOL."""
    o_ref, l_ref = plain(q, k, v, scale, km)
    o, lse = kernel(q, k, v, scale, km)
    torch.cuda.synchronize()
    passed, errs = _per_sequence_errs(("o",), (o,), (o_ref,),
                                      SHORTSEQ_FWD_TOL[name])
    lerr = (lse - l_ref).abs().max().item()
    passed &= lerr <= SHORTSEQ_LSE_TOL
    return {"max_abs_err": errs["o"]["max_abs_err"], "o_errors": errs["o"],
            "lse_max_abs_err": lerr, "tol": SHORTSEQ_FWD_TOL[name],
            "lse_tol": SHORTSEQ_LSE_TOL, "ok": bool(passed)}


def phase_shortseq_fwd(torch, ctx):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.flash_attention import (
        shortseq_attention_fwd, shortseq_attention_plain)

    g = torch.Generator("cuda").manual_seed(6)
    res = {"phase": "shortseq_fwd", "cases": []}
    ok = True
    B, H = 4, 3
    for dtype in (torch.bfloat16, torch.float32):
        for S in (128, 512):
            for D in (64, 128):
                for masked in (False, True):
                    q, k, v = (torch.randn((B * H, S, D), generator=g,
                                           device="cuda").to(dtype)
                               for _ in range(3))
                    km = _test_mask(torch, B, S) if masked else None
                    scale = 1.0 / math.sqrt(D)
                    name = dname(torch, dtype)
                    case = _shortseq_fwd_case(
                        torch, shortseq_attention_fwd,
                        shortseq_attention_plain, q, k, v, scale, km, name)
                    res["cases"].append(dict(
                        dtype=name, S=S, D=D, masked=masked, **case))
                    ok &= case["ok"]
    # bench.py's BERT shape, bf16, both variants: error and times
    Bb, Hb, S, D = BERT_SHAPE
    BH, scale = Bb * Hb, 1.0 / math.sqrt(D)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn((BH, S, D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    for masked in (False, True):
        km = _bench_mask(torch, Bb, S, 7)[0] if masked else None
        case = _shortseq_fwd_case(torch, shortseq_attention_fwd,
                                  shortseq_attention_plain, q, k, v, scale,
                                  km, "bfloat16")
        kms = cuda_ms(torch, lambda: shortseq_attention_fwd(
            q, k, v, scale, km), 20, flush)
        pms = cuda_ms(torch, lambda: shortseq_attention_plain(
            q, k, v, scale, km), 3, flush, warmup=1)
        q4, k4, v4 = (x.view(Bb, Hb, S, D) for x in (q, k, v))
        m4 = None if km is None else km[:, None, None, :].to(q.dtype)
        lms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, scale=scale), 20, flush)
        b, by = _shortseq_bound(BH, S, D, q.element_size(), Bb, masked, True)
        flops = 4 * BH * S * S * D
        case = dict(case, dtype="bfloat16", masked=masked, kernel_ms=kms,
                    plain_ms=pms, library_ms=lms, bound_ms=b, bound_by=by,
                    tflops=flops / kms / 1e9,
                    library_tflops=flops / lms / 1e9,
                    share_of_bound=b / kms,
                    shape="B64 H12 S512 D64" + (
                        ", rows keep 128-512 keys" if masked else ""))
        ok &= case["ok"]
        ctx["shortseq_fwd_masked" if masked else "shortseq_fwd"] = case
        res["cases"].append(case)
    del flush, q, k, v
    torch.cuda.empty_cache()
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("shortseq attention kernel disagrees with its "
                             "plain version")


def _per_sequence_errs(names, got, ref, tol):
    """`tol` = (rel, abs) per sequence (per [S, D] slab of bh) for each of
    the named `[BH, S, D]` outputs: (passed, errors)."""
    rel, floor = tol
    errs, passed = {}, True
    for gn, a, r in zip(names, got, ref):
        err = (a.float() - r.float()).abs().amax((1, 2))
        top = r.float().abs().amax((1, 2))
        margin = (err / (rel * top + floor)).max().item()
        errs[gn] = {"max_abs_err": err.max().item(),
                    "max_abs_ref": top.max().item(),
                    "worst_share_of_tol": margin}
        passed &= math.isfinite(margin) and margin <= 1.0
    return passed, errs


def phase_shortseq_bwd(torch, ctx):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.flash_attention import (
        shortseq_attention_bwd, shortseq_attention_bwd_plain,
        shortseq_attention_fwd)

    g = torch.Generator("cuda").manual_seed(7)
    res = {"phase": "shortseq_bwd", "cases": []}
    ok = True
    B, H = 4, 3
    for dtype in (torch.bfloat16, torch.float32):
        for S in (128, 512):
            for D in (64, 128):
                for masked in (False, True):
                    q, k, v, do = (torch.randn((B * H, S, D), generator=g,
                                               device="cuda").to(dtype)
                                   for _ in range(4))
                    km = _test_mask(torch, B, S) if masked else None
                    scale = 1.0 / math.sqrt(D)
                    o, lse = shortseq_attention_fwd(q, k, v, scale, km)
                    ref = shortseq_attention_bwd_plain(q, k, v, o, do, lse,
                                                       scale, km)
                    got = shortseq_attention_bwd(q, k, v, o, do, lse, scale,
                                                 km)
                    torch.cuda.synchronize()
                    name = dname(torch, dtype)
                    passed, errs = _per_sequence_errs(
                        GRADS, got, ref, SHORTSEQ_BWD_TOL[name])
                    res["cases"].append({
                        "dtype": name, "S": S, "D": D, "masked": masked,
                        "errors": errs, "tol": SHORTSEQ_BWD_TOL[name],
                        "ok": bool(passed)})
                    ok &= passed
    Bb, Hb, S, D = BERT_SHAPE
    BH, scale = Bb * Hb, 1.0 / math.sqrt(D)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    q, k, v, do = (torch.randn((BH, S, D), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    for masked in (False, True):
        km = _bench_mask(torch, Bb, S, 7)[0] if masked else None
        o, lse = shortseq_attention_fwd(q, k, v, scale, km)
        ref = shortseq_attention_bwd_plain(q, k, v, o, do, lse, scale, km)
        got = shortseq_attention_bwd(q, k, v, o, do, lse, scale, km)
        torch.cuda.synchronize()
        passed, errs = _per_sequence_errs(GRADS, got, ref,
                                          SHORTSEQ_BWD_TOL["bfloat16"])
        del ref, got
        kms = cuda_ms(torch, lambda: shortseq_attention_bwd(
            q, k, v, o, do, lse, scale, km), 10, flush)
        pms = cuda_ms(torch, lambda: shortseq_attention_bwd_plain(
            q, k, v, o, do, lse, scale, km), 3, flush, warmup=1)
        m4 = None if km is None else km[:, None, None, :].to(q.dtype)
        lms = _library_bwd_ms(
            torch, lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, attn_mask=m4, scale=scale),
            [x.view(Bb, Hb, S, D) for x in (q, k, v)],
            do.view(Bb, Hb, S, D), flush)
        b, by = _shortseq_bound(BH, S, D, q.element_size(), Bb, masked,
                                False)
        flops = 10 * BH * S * S * D
        case = {"dtype": "bfloat16", "masked": masked, "errors": errs,
                "tol": SHORTSEQ_BWD_TOL["bfloat16"], "ok": bool(passed),
                "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                "kernel_ms": kms, "plain_ms": pms, "library_ms": lms,
                "bound_ms": b, "bound_by": by, "tflops": flops / kms / 1e9,
                "library_tflops": flops / lms / 1e9,
                "share_of_bound": b / kms,
                "shape": "B64 H12 S512 D64" + (
                    ", rows keep 128-512 keys" if masked else "")}
        ok &= passed
        ctx["shortseq_bwd_masked" if masked else "shortseq_bwd"] = case
        res["cases"].append(case)
    del flush, q, k, v, do
    torch.cuda.empty_cache()
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("shortseq attention backward kernel disagrees "
                             "with its plain version")


def phase_bert_train(torch, ctx, seed):
    from paddle_tpu_torch import (AdamW, BertConfig,
                                  BertForSequenceClassification, TrainStep)

    cfg = BertConfig.bert_base()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    batch, heads, seq, _ = BERT_SHAPE
    warm, timed, pwarm, ptimed = 2, 5, 2, 3
    g = torch.Generator("cuda").manual_seed(seed)
    model = BertForSequenceClassification(cfg, device="cuda",
                                          dtype=torch.bfloat16, generator=g)
    model.eval()                           # as bench.py: dropout off
    step = TrainStep(model, AdamW(learning_rate=2e-5,
                                  parameters=model.parameters()),
                     model.loss_fn)
    rng = np.random.RandomState(seed + 5)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))
                           .astype(np.int64)).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.num_labels, batch)
                              .astype(np.int64)).cuda()
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    warm_losses = step.run_repeat(ids, labels, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = _counted(torch, ctx, "bert_train_bf16",
                      lambda: step.run_repeat(ids, labels, timed),
                      exact={SSF: L * timed, SSB: L * timed, SSFM: 0,
                             SSBM: 0, OPT: timed})
    wall = time.perf_counter() - t0
    losses = [float(x) for x in torch.cat([warm_losses, losses])]
    ms = wall / timed * 1e3
    tok_s = batch * seq * timed / wall
    peak = torch.cuda.max_memory_allocated() / 1e9
    fpt = model.flops_per_token(seq)
    res = {"phase": "bert_train", "config": "bench.py bert_base fine-tune "
           "(vocab 30522, hidden 768, 12 layers, 12 heads, FFN 3072, seq "
           "512, dropouts 0, eval mode), bf16 params, AdamW(2e-5), batch 64",
           "params": model.num_params(), "flops_per_token": fpt,
           "warmup_steps": warm, "timed_steps": timed, "ms_per_step": ms,
           "tokens_per_s": tok_s,
           "model_flop_share_of_989tflops": fpt * tok_s
           / PEAK_FLOPS["bfloat16"], "peak_memory_gb": peak,
           "peak_memory_gb_with_the_loop": LOOP_PEAK_GB["bert_train"],
           "losses": losses, "nvidia_smi": ctx.get("smi"),
           "kernel_counts": ctx["paths"]["bert_train_bf16"]}
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and peak <= LOOP_PEAK_GB["bert_train"] + PEAK_SLACK_GB)
    if ctx.get("profile"):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(ids, labels)
            torch.cuda.synchronize()
        emit(dict(phase="bert_train_profile",
                  **_device_breakdown(prof, "bert_train")))
    # the same batch padded: rows keep 128-512 real tokens, none all
    # padding; the masked kernels alone
    km, lens = _bench_mask(torch, batch, seq, seed + 6)
    am = (km == 0).to(torch.int64)
    padded = [float(step(ids, None, am, labels)) for _ in range(pwarm)]
    t0 = time.perf_counter()
    plosses = _counted(torch, ctx, "bert_padded_bf16", lambda: [
        step(ids, None, am, labels) for _ in range(ptimed)],
        exact={SSF: 0, SSB: 0, SSFM: L * ptimed, SSBM: L * ptimed,
               OPT: ptimed})
    pwall = time.perf_counter() - t0
    padded += [float(x) for x in plosses]
    res.update(padded_lens_min_max=[min(lens), max(lens)],
               padded_lens_mean=sum(lens) / len(lens),
               padded_losses=padded,
               padded_ms_per_step=pwall / ptimed * 1e3,
               padded_kernel_counts=ctx["paths"]["bert_padded_bf16"])
    ok &= all(math.isfinite(x) for x in padded)
    # masked keys get p = 0 exactly: other token ids at the padded
    # positions leave the logits bitwise unchanged
    other = ids.clone()
    pad = am == 0
    other[pad] = (ids[pad] + 1 + torch.randint(
        cfg.vocab_size - 1, (int(pad.sum()),), device="cuda",
        generator=g)) % cfg.vocab_size

    def eval_twice():
        with torch.no_grad():
            return model(ids, None, am), model(other, None, am)

    a, b = _counted(torch, ctx, "bert_eval_padded_bf16", eval_twice,
                    exact={SSF: 0, SSB: 0, SSFM: 2 * L, SSBM: 0})
    res["padded_logits_bitwise_equal"] = bool(torch.equal(a, b))
    res["padded_positions_changed"] = int(pad.sum())
    res["eval_kernel_counts"] = ctx["paths"]["bert_eval_padded_bf16"]
    ok &= res["padded_logits_bitwise_equal"] and bool(
        torch.isfinite(a.float()).all())
    res["ok"] = bool(ok)
    emit(res)
    del step, model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("bert_train phase failed its checks")


def phase_bert_parity(torch, ctx, seed):
    from paddle_tpu_torch import (AdamW, BertConfig,
                                  BertForSequenceClassification, TrainStep)

    cfg = BertConfig.bert_base()
    cfg.num_layers = 2
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    steps, batch, seq, lr = 3, 2, 512, 2e-5
    g = torch.Generator("cuda").manual_seed(seed)
    card = BertForSequenceClassification(cfg, device="cuda",
                                         dtype=torch.float32, generator=g)
    host = BertForSequenceClassification(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    card.eval()
    host.eval()
    rng = np.random.RandomState(seed + 7)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (steps, batch, seq)).astype(np.int64))
    labels = torch.from_numpy(rng.randint(0, cfg.num_labels, (steps, batch))
                              .astype(np.int64))
    am = torch.ones((batch, seq), dtype=torch.int64)
    am[1, 384:] = 0                         # one row keeps 384 tokens

    def run(model, x, y, m):
        """The first batch's logits and gradients, then the AdamW steps:
        (logits, losses, grads, parameter changes)."""
        with torch.no_grad():
            logits = model(x[0], None, m)
        model.zero_grad(set_to_none=True)
        model(x[0], None, m, labels=y[0]).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = TrainStep(model, AdamW(learning_rate=lr,
                                      parameters=model.parameters()),
                         model.loss_fn)
        losses = [float(step(a, None, m, b)) for a, b in zip(x, y)]
        return logits, losses, grads, {n: p.detach() - before[n]
                                       for n, p in model.named_parameters()}

    lg_card, got, g_card, d_card = _counted(
        torch, ctx, "bert_f32",
        lambda: run(card, ids.cuda(), labels.cuda(), am.cuda()),
        exact={SSF: 0, SSB: 0})
    lg_host, want, g_host, d_host = run(host, ids, labels, am)
    tol = BERT_PARITY_TOL
    logit_diff = (lg_card.cpu() - lg_host).abs().max().item()
    diffs = [abs(a - b) for a, b in zip(got, want)]
    grad_leaf, grad_err, grad_errs = _worst_leaf(g_card, g_host)
    upd = _update_errs(torch, d_card, d_host, tol, lr, steps)
    res = {"phase": "bert_parity", "dtype": "float32", "config": "bert_base "
           "widths, 2 layers, batch 2, seq 512 (one row 384 real tokens), "
           "AdamW(2e-5), 3 steps", "logits_max_abs_diff": logit_diff,
           "card_losses": got, "cpu_losses": want,
           "loss_max_abs_diff": max(diffs),
           "grad_worst_leaf": grad_leaf, "grad_rel_err": grad_err,
           "grad_rel_err_by_leaf": grad_errs, **upd, "tol": tol,
           "kernel_counts": ctx["paths"]["bert_f32"]}
    res["ok"] = bool(logit_diff <= tol["logits"] and max(diffs) <= tol["loss"]
                     and grad_err <= tol["grad"] and upd["update_ok"]
                     and all(math.isfinite(x) for x in got))
    emit(res)
    del card, host
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("f32 BERT steps on the card differ from the "
                             "CPU")


# ---------------------------------------------------------------------------
# the conv path: ResNet eval
# ---------------------------------------------------------------------------
def _conv_case(torch, g, N, hw, cin, cout, k, dtype):
    """x NHWC (the view of a channels_last NCHW tensor, as ConvBNReLU hands
    it over), w HWIO, fp32 scale and shift of a folded BatchNorm."""
    x = torch.randn((N, cin, hw, hw), generator=g, device="cuda") \
        .to(dtype).contiguous(memory_format=torch.channels_last) \
        .permute(0, 2, 3, 1)
    w = (torch.randn((k, k, cin, cout), generator=g, device="cuda")
         / math.sqrt(k * k * cin)).to(dtype)
    scale = torch.rand(cout, generator=g, device="cuda") + 0.5
    shift = torch.randn(cout, generator=g, device="cuda") * 0.5
    return x, w, scale, shift


def _conv_library(torch, x, w, scale, shift, stride, pads):
    """The yardstick: F.conv2d of the BN-folded weights (OIHW, channels
    last) with the shift as bias on the NCHW view, then relu_; F.pad first
    where the padding is asymmetric (SAME at stride 2)."""
    import torch.nn.functional as F

    xn = x.permute(0, 3, 1, 2)
    wf = (w.float() * scale).to(w.dtype).permute(3, 2, 0, 1) \
        .contiguous(memory_format=torch.channels_last)
    b = shift.to(x.dtype)
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        return lambda: F.conv2d(xn, wf, b, stride, (pt, pl)).relu_()
    return lambda: F.conv2d(F.pad(xn, (pl, pr, pt, pb)), wf, b,
                            stride).relu_()


def _conv_errors_fp64(torch, x, w, scale, shift, stride, pads, relu, got,
                      plain, library):
    """A bf16 conv+BN+ReLU against an fp64 reference (the conv of the same
    bf16 inputs in fp64, then the affine and the ReLU in fp64): the
    kernel's, the plain version's and the library call's (F.conv2d of the
    folded weights, a bf16 result) max |err| / max |ref|."""
    import torch.nn.functional as F

    (pt, pb), (pl, pr) = pads
    xd = F.pad(x.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    ref = F.conv2d(xd, w.permute(3, 2, 0, 1).double(), stride=stride)
    del xd
    ref = ref * scale.double().view(1, -1, 1, 1) \
        + shift.double().view(1, -1, 1, 1)
    if relu:
        ref = ref.relu()
    ref = ref.permute(0, 2, 3, 1)
    top = ref.abs().max().item()

    def err(t):
        return (t.double() - ref).abs().max().item() / top

    out = {"fp64_rel_err": err(got), "plain_fp64_rel_err": err(plain),
           "library_fp64_rel_err": err(library.permute(0, 2, 3, 1))}
    del ref
    return out


def phase_conv_fwd(torch, ctx):
    from paddle_tpu_torch.ops.conv import (conv_bn_relu_plain,
                                           fused_conv_bn_relu,
                                           normalize_conv_padding)

    g = torch.Generator("cuda").manual_seed(9)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    res = {"phase": "conv_fwd", "batch": CONV_BATCH, "tol": CONV_TOL,
           "cases": []}
    ok = True
    # the sweep at its own stride, SAME and ReLU, timed; then stride 2 on
    # the 1x1, ResNet's int padding on the 3x3 at both strides, ReLU off
    cases = [(n, hw, ci, co, k, s, "SAME", True, True)
             for n, hw, ci, co, k, s in CONV_SWEEP_SHAPES]
    cases += [("conv_c2_1x1_64_256", 56, 64, 256, 1, 2, 0, True, False),
              ("conv_c5_1x1_512_2048", 7, 512, 2048, 1, 1, "SAME", False,
               False),
              ("conv_c3_3x3_128_s2", 56, 128, 128, 3, 2, 1, True, False),
              ("conv_c2_3x3_64", 56, 64, 64, 3, 1, 1, False, False)]
    for name, hw, cin, cout, k, s, pad, relu, timed in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dn = dname(torch, dtype)
            x, w, scale, shift = _conv_case(torch, g, CONV_BATCH, hw, cin,
                                            cout, k, dtype)
            ref = conv_bn_relu_plain(x, w, scale, shift, s, pad, relu)
            got = fused_conv_bn_relu(x, w, scale, shift, s, pad, relu)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            case = {"name": name, "dtype": dn, "stride": s,
                    "padding": pad, "relu": relu,
                    "shape": f"N{CONV_BATCH} {hw}x{hw} {cin}->{cout} "
                             f"k{k} s{s}",
                    "max_abs_err": err, "max_abs_plain": top,
                    "rel_err": err / top, "tol": CONV_TOL[dn],
                    "ok": bool(math.isfinite(err) and
                               err <= CONV_TOL[dn] * top
                               and got.shape == ref.shape)}
            ok &= case["ok"]
            del ref
            if timed:
                M = got.shape[0] * got.shape[1] * got.shape[2]
                isz = x.element_size()
                nbytes = ((x.numel() + w.numel() + got.numel()) * isz
                          + 2 * cout * 4)
                flops = 2 * M * cin * cout * k * k
                b, by = bound_ms(nbytes, flops, dn)
                kms = cuda_ms(torch, lambda: fused_conv_bn_relu(
                    x, w, scale, shift, s, pad, relu), 10, flush)
                case.update(bound_ms=b, bound_by=by, kernel_ms=kms,
                            tflops=flops / kms / 1e9, share_of_bound=b / kms)
                if dtype == torch.bfloat16:
                    pads = normalize_conv_padding(pad, k, s,
                                                  in_hw=(hw, hw))
                    lib = _conv_library(torch, x, w, scale, shift, s, pads)
                    case.update(
                        plain_ms=cuda_ms(torch, lambda: conv_bn_relu_plain(
                            x, w, scale, shift, s, pad, relu), 3, flush,
                            warmup=1),
                        library_ms=cuda_ms(torch, lib, 10, flush))
                    case.update(_conv_errors_fp64(
                        torch, x, w, scale, shift, s, pads, relu, got,
                        conv_bn_relu_plain(x, w, scale, shift, s, pad,
                                           relu), lib()))
                    if name == "conv_c2_1x1_64_256":
                        ctx["conv1x1"] = case
                    elif name == "conv_c2_3x3_64":
                        ctx["conv3x3"] = case
            res["cases"].append(case)
            del x, w, got
    del flush
    torch.cuda.empty_cache()
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("fused conv kernels disagree with their plain "
                             "version")


def _seed_bn(torch, model, seed):
    """Draw every BatchNorm's gamma, beta, running mean and (positive)
    running variance from `seed` (numpy, so the card and the CPU agree):
    at random init they are the identity, which would hide a wrong fold."""
    from paddle_tpu_torch.nn import BatchNorm2D

    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2D):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.5, 0.5),
                                  (m._mean, -0.5, 0.5),
                                  (m._variance, 0.5, 2.0)):
                    t.copy_(torch.from_numpy(rng.uniform(
                        lo, hi, t.shape).astype(np.float32)))


def _resnet50(torch, classes, dtype, seed, backend=None):
    from paddle_tpu_torch import resnet50

    g = torch.Generator("cuda").manual_seed(seed)
    m = resnet50(num_classes=classes, conv_backend=backend, device="cuda",
                 generator=g)
    _seed_bn(torch, m, seed + 9)
    return m.to(dtype).eval()


def phase_resnet_infer(torch, ctx, seed):
    from paddle_tpu_torch.ops.conv import fused_conv_bn_relu

    batch, size, classes, warm, timed = CONV_BATCH, 224, 1000, 2, 10
    rng = np.random.RandomState(seed + 10)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, 3, size, size))
                         .astype(np.float32)).cuda().to(torch.bfloat16)

    def serve(model, path, exact):
        """2 warm-up forwards, then `timed` ones, each ending in a
        synchronize, counted as one run (`_counted`) when `path` is given;
        (logits, seconds per forward, peak GB, dense calls)."""
        with torch.no_grad():
            for _ in range(warm):
                model(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

            def run():
                secs = []
                for _ in range(timed):
                    t0 = time.perf_counter()
                    out = model(x)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                return out, secs

            fused_conv_bn_relu.dense_calls = 0
            out, secs = (_counted(torch, ctx, path, run, exact) if path
                         else run())
            dense = fused_conv_bn_relu.dense_calls
        return out, secs, torch.cuda.max_memory_allocated() / 1e9, dense

    def report(secs, peak):
        ips = batch * len(secs) / sum(secs)
        return {"images_per_s": ips,
                "ms_per_forward": sum(secs) / len(secs) * 1e3,
                "ms_per_forward_min_median_max": [
                    min(secs) * 1e3, float(np.median(secs)) * 1e3,
                    max(secs) * 1e3],
                "model_flop_share_of_989tflops": RESNET50_FWD_FLOPS * ips
                / PEAK_FLOPS["bfloat16"], "peak_memory_gb": peak}

    model = _resnet50(torch, classes, torch.bfloat16, seed)
    out_k, secs_k, peak_k, dense_k = serve(
        model, "resnet_infer_bf16", {C1: 36 * timed, C3: 16 * timed})
    res = {"phase": "resnet_infer", "config": "bench.py resnet50_infer: "
           "resnet50(num_classes=1000), bf16, eval, seed-0 weights, seeded "
           "BatchNorm statistics, batch 256 x 3 x 224 x 224 uniform(-1, 1)",
           "warmup_forwards": warm, "timed_forwards": timed,
           "nvidia_smi": ctx.get("smi"), **report(secs_k, peak_k),
           "dense_calls": dense_k,
           "kernel_counts": ctx["paths"]["resnet_infer_bf16"]}
    # the same weights through the dense composition, no kernel
    dense = _resnet50(torch, classes, torch.bfloat16, seed, "dense")
    dense.load_state_dict(model.state_dict())
    before = [(w.launches, w.plain_calls) for w in ctx["wrappers"]]
    out_d, secs_d, peak_d, dense_d = serve(dense, None, None)
    no_kernel = before == [(w.launches, w.plain_calls)
                           for w in ctx["wrappers"]]
    if ctx.get("profile"):
        from torch.profiler import ProfilerActivity, profile

        for m, name in ((model, "resnet_infer"),
                        (dense, "resnet_infer_dense")):
            with torch.no_grad(), profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                m(x)
                torch.cuda.synchronize()
            emit(dict(phase=name + "_profile",
                      **_device_breakdown(prof, name)))
    rel = ((out_k.float() - out_d.float()).abs().max()
           / out_d.float().abs().max()).item()
    res.update(dense_route=dict(report(secs_d, peak_d), dense_calls=dense_d,
                                no_kernel_or_plain_call=no_kernel),
               rel_linf_vs_dense=rel, tol=RESNET_DENSE_REL_TOL,
               max_abs_logit=out_d.float().abs().max().item())
    res["ok"] = bool(
        out_k.shape == (batch, classes) and dense_k == 0
        and dense_d == 52 * timed and no_kernel
        and bool(torch.isfinite(out_k.float()).all())
        and rel <= RESNET_DENSE_REL_TOL)
    emit(res)
    del model, dense, x
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("resnet_infer phase failed its checks")


def phase_resnet_parity(torch, ctx, seed):
    from paddle_tpu_torch import resnet50

    card = _resnet50(torch, 10, torch.float32, seed)
    host = resnet50(num_classes=10, device="cpu").eval()
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x = torch.from_numpy(np.random.RandomState(seed + 11).uniform(
        -1, 1, (2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        got = _counted(torch, ctx, "resnet_f32", lambda: card(x.cuda()),
                       exact={C1: 36, C3: 16}).cpu()
        want = host(x)
    err = ((got - want).abs().max() / want.abs().max()).item()
    res = {"phase": "resnet_parity", "dtype": "float32",
           "config": "resnet50(num_classes=10), batch 2, 64 x 64, seeded "
           "BatchNorm statistics", "rel_linf": err,
           "max_abs_logit": want.abs().max().item(),
           "tol": RESNET_PARITY_TOL,
           "kernel_counts": ctx["paths"]["resnet_f32"],
           "ok": bool(math.isfinite(err) and err <= RESNET_PARITY_TOL)}
    emit(res)
    del card, host
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("f32 ResNet-50 logits on the card differ from "
                             "the CPU")


# ---------------------------------------------------------------------------
# the conv path: ResNet training
# ---------------------------------------------------------------------------
def _sums_err(got, ref, conv):
    """max |got - ref| of each row of [2, Cout] sums relative to the sum of
    the magnitudes of its terms (per channel, over every pixel)."""
    p = conv.reshape(-1, conv.shape[-1]).float()
    mag = (p.abs().sum(0), (p * p).sum(0))
    return max(((got[i] - ref[i]).abs() / mag[i].clamp_min(1e-6)).max()
               .item() for i in range(2))


def _bwd_bundle(torch, g, cout, dtype):
    """An fp32 bundle [8, Cout] = [mean_n, inv_n, gamma, beta, mean32,
    rstd32, c1, c2] as pass 1 makes it: the *_n rows rounded through the
    compute dtype."""
    mean32 = torch.randn(cout, generator=g, device="cuda") * 0.3
    rstd32 = torch.rand(cout, generator=g, device="cuda") + 0.5
    gamma = torch.rand(cout, generator=g, device="cuda") + 0.5
    beta = torch.randn(cout, generator=g, device="cuda") * 0.5
    c1, c2 = (torch.randn(cout, generator=g, device="cuda") * 0.1
              for _ in range(2))
    return torch.stack([mean32.to(dtype).float(), rstd32.to(dtype).float(),
                        gamma, beta, mean32, rstd32, c1, c2]).contiguous()


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-6)).item()


def _dw_errors_fp64(torch, x, g, s, pads, dw, plain, xp, gn):
    """A bf16 3x3 dWeight against an fp64 reference (conv3x3_dw_plain's
    nine tap products in fp64 on the card): the kernel's, the plain
    version's (fp32 cuBLAS) and torch.nn.grad.conv2d_weight's max |err| /
    max |ref|, the library call both on the bf16 inputs (a bf16 result)
    and on their fp32 copies (TF32 off)."""
    import torch.nn.functional as F

    (pt, pb), (pl, pr) = pads
    N, Ho, Wo, cout = g.shape
    cin = x.shape[3]
    xd = F.pad(x.double(), (0, 0, pl, pr, pt, pb))
    gd = g.reshape(-1, cout).double()
    ref = torch.empty((3, 3, cin, cout), dtype=torch.float64, device="cuda")
    for dy in range(3):
        for dx in range(3):
            xs = xd[:, dy:dy + s * (Ho - 1) + 1:s, dx:dx + s * (Wo - 1) + 1:s]
            ref[dy, dx] = xs.reshape(-1, cin).t() @ gd
    del xd, gd
    top = ref.abs().max().item()

    def err(w):  # w [3, 3, Cin, Cout]
        return (w.double() - ref).abs().max().item() / top

    def lib(xl, gl):  # the library's [Cout, Cin, 3, 3] as [3, 3, Cin, Cout]
        return torch.nn.grad.conv2d_weight(xl, (cout, cin, 3, 3), gl,
                                           s).permute(2, 3, 1, 0)

    out = {"fp64_rel_err": err(dw), "plain_fp64_rel_err": err(plain),
           "library_fp64_rel_err": err(lib(xp, gn)),
           "library_f32_fp64_rel_err": err(lib(xp.float(), gn.float()))}
    del ref
    return out


def _dw1x1_errors_fp64(torch, x, dy, y, rows, wt, s, dw, plain):
    """B10's bf16 dWeight against an fp64 reference: xs^T @ dConv in fp64,
    the dConv bf16 as the kernel and its plain version round it (with the
    ReLU). The kernel's, the plain version's (fp32 cuBLAS) and
    aten.convolution_backward's (its weight gradient over the same bf16
    dConv, a bf16 result) max |err| / max |ref|."""
    N, Ho, Wo, cout = y.shape
    cin = x.shape[3]
    r = rows.float()
    yv = y.reshape(-1, cout).float()
    dz = torch.where((yv - r[0]) * r[1] * r[2] + r[3] > 0,
                     dy.reshape(-1, cout).float(), 0.0)
    xh = (yv - r[4]) * r[5]
    dcv = ((r[2] * r[5]) * (dz - r[6] - xh * r[7])).to(x.dtype)
    del yv, dz, xh
    xs = x[:, ::s, ::s]
    ref = xs.reshape(-1, cin).double().t() @ dcv.double()
    top = ref.abs().max().item()
    lib = torch.ops.aten.convolution_backward(
        dcv.view(N, Ho, Wo, cout).permute(0, 3, 1, 2),
        xs.permute(0, 3, 1, 2), wt.t().reshape(cout, cin, 1, 1)
        .contiguous(), None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
        [False, True, False])[1]

    def err(t):
        return (t.double() - ref).abs().max().item() / top

    out = {"dw_fp64_rel_err": err(dw), "dw_plain_fp64_rel_err": err(plain),
           "dw_library_fp64_rel_err": err(lib.reshape(cout, cin).t())}
    del ref, dcv, lib
    return out


def phase_conv_train(torch, ctx):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.conv import (
        conv1x1_bwd, conv1x1_bwd_plain, conv1x1_train, conv3x3_bn_relu,
        conv3x3_dw, conv3x3_dw_plain, conv3x3_train, conv_bn_relu_plain,
        conv_train_plain, normalize_conv_padding)

    g = torch.Generator("cuda").manual_seed(12)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    res = {"phase": "conv_train", "batch": CONV_BATCH,
           "tol": {"conv": CONV_TOL, "sums": CONV_SUM_TOL,
                   "dw": CONV_SUM_TOL}, "cases": []}
    ok = True
    # the sweep at its own stride and SAME padding, then the stride-2 1x1
    # (the downsample) and ResNet's int padding on a stride-2 3x3
    cases = [(n, hw, ci, co, k, s, "SAME")
             for n, hw, ci, co, k, s in CONV_SWEEP_SHAPES]
    cases += [("conv_c2_1x1_64_256", 56, 64, 256, 1, 2, 0),
              ("conv_c3_3x3_128_s2", 56, 128, 128, 3, 2, 1)]
    for idx, (name, hw, cin, cout, k, s, pad) in enumerate(cases):
        timed = idx < len(CONV_SWEEP_SHAPES)
        pads = normalize_conv_padding(pad, k, s, in_hw=(hw, hw))
        for dtype in (torch.bfloat16, torch.float32):
            dn = dname(torch, dtype)
            time_it = timed and dtype == torch.bfloat16
            x, w, _, _ = _conv_case(torch, g, CONV_BATCH, hw, cin, cout, k,
                                    dtype)
            N = CONV_BATCH
            shape = f"N{N} {hw}x{hw} {cin}->{cout} k{k} s{s}"
            isz = x.element_size()
            # B9: the train forward
            train = conv1x1_train if k == 1 else conv3x3_train
            run9 = (functools.partial(train, x, w, s) if k == 1
                    else functools.partial(train, x, w, s, pad))
            conv, sums = run9()
            ref, ref_sums = conv_train_plain(x, w, s, pad)
            torch.cuda.synchronize()
            err, serr = _rel(conv, ref), _sums_err(sums, ref_sums, ref)
            case = {"kernel": train.__name__, "name": name, "dtype": dn,
                    "stride": s, "padding": pad, "shape": shape,
                    "max_abs_err": (conv.float() - ref.float()).abs().max()
                    .item(), "rel_err": err, "sums_rel_err": serr,
                    "ok": bool(math.isfinite(err) and err <= CONV_TOL[dn]
                               and serr <= CONV_SUM_TOL[dn])}
            del ref, ref_sums
            if dtype == torch.bfloat16:
                # the epilogue apart from the conv's rounding: the sums
                # against fp64 sums of the kernel's own stored values
                own = conv.reshape(-1, cout).double()
                case["sums_own_fp64_rel_err"] = _sums_err(
                    sums.double(), torch.stack([own.sum(0),
                                                (own * own).sum(0)]), conv)
                del own
            M = conv.shape[0] * conv.shape[1] * conv.shape[2]
            if time_it:
                b, by = bound_ms((x.numel() + w.numel() + conv.numel()) * isz
                                 + 2 * cout * 4,
                                 2 * M * cin * cout * k * k, dn)
                kms = cuda_ms(torch, run9, 10, flush)
                (pt, pb), (pl, pr) = pads
                xn = x.permute(0, 3, 1, 2)
                w_cl = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                conv_only = (
                    (lambda: F.conv2d(xn, w_cl, None, s, (pt, pl)))
                    if pt == pb and pl == pr else
                    (lambda: F.conv2d(F.pad(xn, (pl, pr, pt, pb)), w_cl,
                                      None, s)))
                case.update(bound_ms=b, bound_by=by, kernel_ms=kms,
                            tflops=2 * M * cin * cout * k * k / kms / 1e9,
                            share_of_bound=b / kms,
                            plain_ms=cuda_ms(torch, lambda: conv_train_plain(
                                x, w, s, pad), 3, flush, warmup=1),
                            library_ms=None,
                            conv_only_ms=cuda_ms(torch, conv_only, 10, flush),
                            conv_only="F.conv2d of the same x and w, "
                                      "channels_last: the conv alone, no "
                                      "statistics")
                del xn, w_cl
                if name == "conv_c2_1x1_64_256":
                    ctx["conv1x1_train"] = case
                elif name == "conv_c2_3x3_64":
                    ctx["conv3x3_train"] = case
            ok &= case["ok"]
            res["cases"].append(case)
            Ho, Wo = conv.shape[1], conv.shape[2]
            dy = (torch.randn(conv.shape, generator=g, device="cuda")
                  .to(dtype))
            if k == 1:
                # B10: the whole 1x1 backward from one bundle
                rows = _bwd_bundle(torch, g, cout, dtype)
                wt = w[0, 0].t().contiguous()
                run10 = functools.partial(conv1x1_bwd, x, dy, conv, rows,
                                          wt, s)
                dx, dw = run10()
                rdx, rdw = conv1x1_bwd_plain(x, dy, conv, rows, wt, s)
                torch.cuda.synchronize()
                e_dx, e_dw = _rel(dx, rdx), _rel(dw, rdw)
                case = {"kernel": "conv1x1_bwd", "name": name, "dtype": dn,
                        "stride": s, "shape": shape,
                        "max_abs_err": max(
                            (dx.float() - rdx.float()).abs().max().item(),
                            (dw - rdw).abs().max().item()),
                        "dx_rel_err": e_dx, "dw_rel_err": e_dw,
                        "ok": bool(e_dx <= CONV_TOL[dn]
                                   and e_dw <= CONV_SUM_TOL[dn])}
                if time_it:
                    xs_n = M * cin
                    flops = 4 * M * cin * cout
                    b, by = bound_ms(
                        (xs_n + 2 * M * cout + x.numel() + wt.numel()) * isz
                        + 8 * cout * 4 + cin * cout * 4, flops, dn)
                    dcv = dy.permute(0, 3, 1, 2)
                    xs = x[:, ::s, ::s].permute(0, 3, 1, 2)
                    w_oihw = w.permute(3, 2, 0, 1).contiguous()
                    kms = cuda_ms(torch, run10, 10, flush)
                    case.update(
                        bound_ms=b, bound_by=by, kernel_ms=kms,
                        tflops=flops / kms / 1e9, share_of_bound=b / kms,
                        plain_ms=cuda_ms(torch, lambda: conv1x1_bwd_plain(
                            x, dy, conv, rows, wt, s), 3, flush, warmup=1),
                        library_ms=cuda_ms(
                            torch, lambda: torch.ops.aten.convolution_backward(
                                dcv, xs, w_oihw, None, [1, 1], [0, 0],
                                [1, 1], False, [0, 0], 1,
                                [True, True, False]), 10, flush),
                        library="aten.convolution_backward of the 1x1 over "
                                "the materialised dConv: products only")
                    case.update(_dw1x1_errors_fp64(torch, x, dy, conv, rows,
                                                   wt, s, dw, rdw))
                    if name == "conv_c2_1x1_64_256":
                        ctx["conv1x1_bwd"] = case
                del rdx, rdw
                ok &= case["ok"]
                res["cases"].append(case)
            else:
                # B11: the 3x3 dWeight over the dConv, then B8 as the dX walk
                run11 = functools.partial(conv3x3_dw, x, dy, s, pad)
                dw = run11()
                rdw = conv3x3_dw_plain(x, dy, s, pad)
                torch.cuda.synchronize()
                e_dw = _rel(dw, rdw)
                case = {"kernel": "conv3x3_dw", "name": name, "dtype": dn,
                        "stride": s, "padding": pad, "shape": shape,
                        "max_abs_err": (dw - rdw).abs().max().item(),
                        "rel_err": e_dw,
                        "ok": bool(e_dw <= CONV_SUM_TOL[dn])}
                if time_it:
                    (pt, pb), (pl, pr) = pads
                    b, by = bound_ms((x.numel() + dy.numel()) * isz
                                     + 9 * cin * cout * 4,
                                     2 * M * 9 * cin * cout, dn)
                    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
                    gn = dy.permute(0, 3, 1, 2)
                    kms = cuda_ms(torch, run11, 10, flush)
                    case.update(
                        bound_ms=b, bound_by=by, kernel_ms=kms,
                        tflops=2 * M * 9 * cin * cout / kms / 1e9,
                        share_of_bound=b / kms,
                        plain_ms=cuda_ms(torch, lambda: conv3x3_dw_plain(
                            x, dy, s, pad), 3, flush, warmup=1),
                        library_ms=cuda_ms(
                            torch, lambda: torch.nn.grad.conv2d_weight(
                                xp, (cout, cin, 3, 3), gn, s), 10, flush),
                        library="torch.nn.grad.conv2d_weight")
                    case.update(_dw_errors_fp64(torch, x, dy, s, pads, dw,
                                                rdw, xp, gn))
                    if name == "conv_c2_3x3_64":
                        ctx["conv3x3_dw"] = case
                del rdw
                ok &= case["ok"]
                res["cases"].append(case)
                if s != 1:
                    dil = dy.new_zeros((N, s * (Ho - 1) + 1, s * (Wo - 1) + 1,
                                        cout))
                    dil[:, ::s, ::s] = dy
                else:
                    dil = dy
                wflip = w.flip(0, 1).transpose(2, 3).contiguous()
                one = torch.ones(cin, device="cuda")
                zero = torch.zeros(cin, device="cuda")
                run8 = functools.partial(conv3x3_bn_relu, dil, wflip, one,
                                         zero, 1, 2, relu=False)
                dxp = run8()
                rdxp = conv_bn_relu_plain(dil, wflip, one, zero, 1, 2, False)
                torch.cuda.synchronize()
                e8 = _rel(dxp, rdxp)
                case = {"kernel": "conv3x3_bn_relu (dX walk)", "name": name,
                        "dtype": dn, "stride": s, "shape": shape,
                        "rel_err": e8, "ok": bool(e8 <= CONV_TOL[dn])}
                if time_it:
                    Md = dxp.shape[0] * dxp.shape[1] * dxp.shape[2]
                    flops = 2 * Md * 9 * cin * cout
                    b, by = bound_ms((dil.numel() + wflip.numel()
                                      + dxp.numel()) * isz, flops, dn)
                    kms = cuda_ms(torch, run8, 10, flush)
                    gn = dy.permute(0, 3, 1, 2)
                    w_oihw = w.permute(3, 2, 0, 1).contiguous()
                    (pt, pb), (pl, pr) = pads
                    hp, wp = hw + pt + pb, hw + pl + pr
                    case.update(
                        bound_ms=b, bound_by=by, kernel_ms=kms,
                        tflops=flops / kms / 1e9, share_of_bound=b / kms,
                        plain_ms=cuda_ms(torch, lambda: conv_bn_relu_plain(
                            dil, wflip, one, zero, 1, 2, False), 3, flush,
                            warmup=1),
                        library_ms=cuda_ms(
                            torch, lambda: torch.nn.grad.conv2d_input(
                                (N, cin, hp, wp), w_oihw, gn, s), 10, flush),
                        library="torch.nn.grad.conv2d_input of the padded "
                                "input from the undilated dConv")
                ok &= case["ok"]
                res["cases"].append(case)
                del dil, dxp, rdxp
            del x, w, conv, sums, dy
    del flush
    torch.cuda.empty_cache()
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("conv train kernels disagree with their plain "
                             "versions")


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_resnet_train(torch, ctx, seed):
    from paddle_tpu_torch import Momentum, TrainStep, resnet50
    from paddle_tpu_torch.ops.conv import fused_conv_bn_relu
    from paddle_tpu_torch.ops.nn_ops import cross_entropy

    batch, size, classes, warm, timed = CONV_BATCH, 224, 1000, 2, 10
    rng = np.random.RandomState(seed + 13)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, 3, size, size))
                         .astype(np.float32)).cuda().to(torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, classes, (batch,))
                         .astype(np.int64)).cuda()

    def build(backend):
        g = torch.Generator("cuda").manual_seed(seed)
        m = resnet50(num_classes=classes, conv_backend=backend,
                     device="cuda", generator=g).to(torch.bfloat16).train()
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=m.parameters())
        return m, TrainStep(m, opt, cross_entropy)

    def run(step, path, exact, n_warm):
        """`n_warm` warm-up steps, then `timed` through run_repeat, counted
        as one run when `path` is given; (warm-up losses, timed losses,
        seconds a step, peak GB, dense training calls)."""
        first = [float(v) for v in step.run_repeat(x, y, n_warm)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_conv_bn_relu.dense_train_calls = 0

        def go():
            t0 = time.perf_counter()
            out = step.run_repeat(x, y, timed)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        losses, secs = (_counted(torch, ctx, path, go, exact) if path
                        else go())
        return (first, [float(v) for v in losses], secs / timed,
                torch.cuda.max_memory_allocated() / 1e9,
                fused_conv_bn_relu.dense_train_calls)

    def report(sec, peak):
        ips = batch / sec
        return {"ms_per_step": sec * 1e3, "images_per_s": ips,
                "model_flop_share_of_989tflops": 3 * RESNET50_FWD_FLOPS * ips
                / PEAK_FLOPS["bfloat16"], "peak_memory_gb": peak}

    model, step = build(None)
    start = _snapshot(model)
    first_k, losses_k, sec_k, peak_k, dense_k = run(
        step, "resnet_train_bf16",
        {C9A: 36 * timed, C9B: 16 * timed, C10: 36 * timed, C11: 16 * timed,
         C3: 16 * timed, C1: 0, OPT: timed}, warm)
    counts = ctx["paths"]["resnet_train_bf16"]
    res = {"phase": "resnet_train", "config": "bench.py resnet50: "
           "resnet50(num_classes=1000), bf16, seed-0 weights, "
           "Momentum(0.1, 0.9), TrainStep(cross_entropy), batch 256 x 3 x "
           "224 x 224 uniform(-1, 1), random labels, run_repeat",
           "warmup_steps": warm, "timed_steps": timed,
           "nvidia_smi": ctx.get("smi"), **report(sec_k, peak_k),
           "warmup_losses": first_k, "losses": losses_k,
           "dense_train_calls": dense_k,
           "peak_memory_gb_with_the_loop": LOOP_PEAK_GB["resnet_train"],
           "launches_per_step": {k: counts[k]["launches"] / timed
                                 for k in (C9A, C9B, C10, C11, C3, OPT)},
           "kernel_counts": counts}
    if ctx.get("profile"):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(x, y)
            torch.cuda.synchronize()
        emit(dict(phase="resnet_train_profile",
                  **_device_breakdown(prof, "resnet_train")))
    del step, model
    torch.cuda.empty_cache()
    # bench.py resnet50_train's check: the same weights on the dense
    # composition, first-step losses within CONV_FUSED_REL_TOL
    dense, dstep = build("dense")
    dense.load_state_dict(start)
    del start
    # no conv kernel and no plain call (the update stays one pass)
    def kernel_counts():
        return [(w.launches if w.__name__ != OPT else 0, w.plain_calls)
                for w in ctx["wrappers"]]

    before = kernel_counts()
    first_d, losses_d, sec_d, peak_d, dense_d = run(dstep, None, None, warm)
    no_kernel = before == kernel_counts()
    if ctx.get("profile"):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dstep(x, y)
            torch.cuda.synchronize()
        emit(dict(phase="resnet_train_dense_profile",
                  **_device_breakdown(prof, "resnet_train_dense")))
    rel = abs(first_k[0] - first_d[0]) / abs(first_d[0])
    res.update(dense_route=dict(report(sec_d, peak_d),
                                warmup_losses=first_d, losses=losses_d,
                                dense_train_calls=dense_d,
                                no_kernel_or_plain_call=no_kernel),
               first_loss_rel_err_vs_dense=rel, tol=RESNET_DENSE_REL_TOL)
    res["ok"] = bool(
        all(math.isfinite(v) for v in first_k + losses_k)
        and dense_k == 0 and dense_d == 52 * timed and no_kernel
        and rel <= RESNET_DENSE_REL_TOL
        and peak_k <= LOOP_PEAK_GB["resnet_train"] + PEAK_SLACK_GB)
    emit(res)
    del dense, dstep, x
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("resnet_train phase failed its checks")


def phase_resnet_train_parity(torch, ctx, seed):
    from paddle_tpu_torch import Momentum, TrainStep, resnet50
    from paddle_tpu_torch.ops.nn_ops import cross_entropy

    steps, batch, size = 3, 2, 64
    g = torch.Generator("cuda").manual_seed(seed)
    card = resnet50(num_classes=10, device="cuda", generator=g).train()
    _seed_bn(torch, card, seed + 14)
    start = {k: v.cpu() for k, v in card.state_dict().items()}
    rng = np.random.RandomState(seed + 15)
    xs = torch.from_numpy(rng.uniform(-1, 1, (steps, batch, 3, size, size))
                          .astype(np.float32))
    ys = torch.from_numpy(rng.randint(0, 10, (steps, batch)).astype(np.int64))

    def run(model, xs, ys):
        """Three steps: (losses, the first step's gradients, which are
        Momentum's velocity after it, the end state)."""
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        step = TrainStep(model, opt, cross_entropy)
        losses = []
        for i in range(steps):
            losses.append(float(step(xs[i], ys[i])))
            if i == 0:
                grads = torch.cat([v.flatten().cpu().double()
                                   for v in opt._accumulators["velocity"]])
        return losses, grads, {k: v.cpu().double()
                               for k, v in model.state_dict().items()}

    got, g_card, end_card = _counted(
        torch, ctx, "resnet_train_f32", lambda: run(card, xs.cuda(),
                                                    ys.cuda()),
        exact={C9A: 36 * steps, C9B: 16 * steps, C10: 36 * steps,
               C11: 16 * steps, C3: 16 * steps})
    res_cpu = []
    for scale in (1.0, 1.0 + 1e-7):
        host = resnet50(num_classes=10, device="cpu").train()
        host.load_state_dict(start)
        res_cpu.append(run(host, xs * scale, ys))
    want, g_host, end_host = res_cpu[0]

    def rel_l2(a, b, keys=None):
        if isinstance(a, dict):
            num = sum(float((a[k] - b[k]).norm() ** 2) for k in keys)
            den = sum(float(b[k].norm() ** 2) for k in keys)
            return (num / den) ** 0.5
        return float((a - b).norm() / b.norm())

    params = [k for k in end_host if not k.endswith(("_mean", "_variance"))]
    buffers = [k for k in end_host if k.endswith(("_mean", "_variance"))]
    s64 = {k: v.double() for k, v in start.items()}
    d_card = {k: end_card[k] - s64[k] for k in params}
    d_host = {k: end_host[k] - s64[k] for k in params}
    tol = RESNET_TRAIN_PARITY_TOL
    errs = {"first_loss": abs(got[0] - want[0]) / abs(want[0]),
            "later_loss": max(abs(a - b) / abs(b)
                              for a, b in zip(got[1:], want[1:])),
            "grad": rel_l2(g_card, g_host),
            "update": rel_l2(d_card, d_host, params),
            "buffers": rel_l2(end_card, end_host, buffers)}
    # the same errors between two CPU runs whose inputs differ by 1e-7
    # relative: the model's own sensitivity to fp32 rounding
    p_loss, p_grad, p_end = res_cpu[1]
    d_pert = {k: p_end[k] - s64[k] for k in params}
    noise = {"first_loss": abs(p_loss[0] - want[0]) / abs(want[0]),
             "later_loss": max(abs(a - b) / abs(b)
                               for a, b in zip(p_loss[1:], want[1:])),
             "grad": rel_l2(p_grad, g_host),
             "update": rel_l2(d_pert, d_host, params),
             "buffers": rel_l2(p_end, end_host, buffers)}
    res = {"phase": "resnet_train_parity", "dtype": "float32",
           "config": "resnet50(num_classes=10), batch 2, 64 x 64, seeded "
           "BatchNorm, Momentum(0.1, 0.9), 3 TrainStep steps",
           "card_losses": got, "cpu_losses": want, "rel_err": errs,
           "cpu_noise_at_1e-7_input": noise, "tol": tol,
           "kernel_counts": ctx["paths"]["resnet_train_f32"]}
    res["ok"] = bool(all(math.isfinite(v) for v in got)
                     and all(errs[k] <= tol[k] for k in tol))
    emit(res)
    del card
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("f32 ResNet-50 train steps on the card differ "
                             "from the CPU")


# ---------------------------------------------------------------------------
# the flash forward B6 and Transformer inference
# ---------------------------------------------------------------------------
# (name, batch, heads, Sq, Skv, head dim, causal): the Transformer-base
# encoder's self-attention and cross-attention (phase 25's shapes), the JAX
# entry point's flagship shape, the library route's causal head dim
SDPA_SHAPES = (("encoder_self_attention", 8, 8, 1024, 1024, 64, False),
               ("cross_attention", 8, 8, 256, 1024, 64, False),
               ("pallas_sdpa_forward", 2, 16, 2048, 2048, 128, True),
               ("causal_head_dim_256", 1, 8, 2048, 2048, 256, True))


def _sdpa_bound(BH, Sq, Skv, D, causal, isz, dtype_name):
    """q, k, v read and O written once; 4 BH Sq Skv D FLOP (QK and PV),
    over the lower triangle with its diagonal when causal. Returns (bound
    ms, what bounds it, FLOP)."""
    nbytes = 2 * BH * (Sq + Skv) * D * isz
    flops = (2 * BH * D * Sq * (Sq + 1) if causal
             else 4 * BH * Sq * Skv * D)
    return (*bound_ms(nbytes, flops, dtype_name), flops)


def phase_sdpa_fwd(torch, ctx):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.flash_attention import (flash_attention,
                                                      pallas_sdpa_forward,
                                                      sdpa_backward,
                                                      sdpa_forward,
                                                      sdpa_forward_plain)

    g = torch.Generator("cuda").manual_seed(12)
    res = {"phase": "sdpa_fwd", "cases": []}
    ok = True
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for name, B, H, Sq, Skv, D, causal in SDPA_SHAPES:
        BH, scale = B * H, 1.0 / math.sqrt(D)
        for dtype in (torch.bfloat16, torch.float32):
            dn = dname(torch, dtype)
            q = torch.randn((B, Sq, H, D), generator=g,
                            device="cuda").to(dtype)
            k, v = (torch.randn((B, Skv, H, D), generator=g,
                                device="cuda").to(dtype) for _ in range(2))
            qh, kh, vh = (x.transpose(1, 2).reshape(BH, -1, D).contiguous()
                          for x in (q, k, v))
            ref = sdpa_forward_plain(qh, kh, vh, scale, causal)
            if name == "pallas_sdpa_forward":
                got = pallas_sdpa_forward(q, k, v, causal=True).transpose(
                    1, 2).reshape(BH, Sq, D)
            else:
                got = sdpa_forward(qh, kh, vh, scale, causal)
            again = sdpa_forward(qh, kh, vh, scale, causal)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            limit = SDPA_TOL[dn] * (top if dtype == torch.bfloat16 else 1.0)
            same = bool(torch.equal(got, again))
            case = {"shape": f"{name}: B{B} H{H} Sq{Sq} Skv{Skv} D{D}"
                    + (" causal" if causal else ""), "dtype": dn,
                    "max_abs_err": err, "max_abs_plain": top,
                    "tol": SDPA_TOL[dn],
                    "tol_kind": "relative to max |plain|"
                    if dtype == torch.bfloat16 else "absolute",
                    "same_bits_on_rerun": same}
            passed = math.isfinite(err) and err <= limit and same
            if dtype == torch.bfloat16:
                kms = cuda_ms(torch, lambda: sdpa_forward(
                    qh, kh, vh, scale, causal), 10, flush)
                pms = cuda_ms(torch, lambda: sdpa_forward_plain(
                    qh, kh, vh, scale, causal), 3, flush, warmup=1)
                q4, k4, v4 = (x.view(B, H, -1, D) for x in (qh, kh, vh))
                lms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, scale=scale), 10, flush)
                b, by, flops = _sdpa_bound(BH, Sq, Skv, D, causal,
                                           q.element_size(), dn)
                case.update(kernel_ms=kms, plain_ms=pms, library_ms=lms,
                            bound_ms=b, bound_by=by,
                            tflops=flops / kms / 1e9,
                            library_tflops=flops / lms / 1e9,
                            share_of_bound=b / kms)
                if name == "encoder_self_attention":
                    ctx["sdpa_fwd"] = dict(case)
            case["ok"] = bool(passed)
            ok &= passed
            res["cases"].append(case)
            del q, k, v, qh, kh, vh, ref, got, again
    del flush
    torch.cuda.empty_cache()
    # the routes (no fallback)
    routes = {}
    z = torch.randn((1, 1024, 2, 64), generator=g, device="cuda")
    before = sdpa_forward.launches
    with torch.no_grad():
        flash_attention(z, z, z, causal=False)
    routes["no_grad_library_shape_launches_b6"] = \
        sdpa_forward.launches == before + 1
    zg = z.clone().requires_grad_()
    lse, bwd = sdpa_forward.lse_launches, sdpa_backward.launches
    flash_attention(zg, zg, zg, causal=False).sum().backward()
    routes["grad_library_shape_launches_lse_variant_and_backward"] = (
        sdpa_forward.lse_launches == lse + 1
        and sdpa_backward.launches == bwd + 1)
    z320 = torch.randn((1, 128, 1, 320), generator=g, device="cuda")
    before = sdpa_forward.launches
    with torch.no_grad():
        o320 = flash_attention(z320, z320, z320, causal=False)
    routes["head_dim_320_launches_b6"] = (
        sdpa_forward.launches == before + 1
        and bool(torch.isfinite(o320).all()))
    z576 = torch.zeros((1, 128, 1, 576), device="cuda")
    try:
        with torch.no_grad():
            flash_attention(z576, z576, z576, causal=False)
        routes["head_dim_576_raises_naming_512"] = False
    except ValueError as e:
        routes["head_dim_576_raises_naming_512"] = "512" in str(e)
    z384 = torch.zeros((1, 384, 1, 64), device="cuda")
    try:
        pallas_sdpa_forward(z384, z384, z384)
        routes["pallas_sdpa_forward_block_assert"] = False
    except AssertionError:
        routes["pallas_sdpa_forward_block_assert"] = True
    res["routes"] = routes
    ok &= all(routes.values())
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("flash forward kernel B6 disagrees with its "
                             "plain version, or a route is wrong")


def _transformer_flops(B, S, T, d, f, L_enc, L_dec):
    """Forward FLOP of nn.Transformer (2 per multiply-add), by part: batch
    B, source S, target T, width d, FFN f."""
    return {"encoder_projections_and_ffn": L_enc * (8 * B * S * d * d
                                                    + 4 * B * S * d * f),
            "encoder_attention": L_enc * 4 * B * S * S * d,
            "decoder_projections_and_ffn": L_dec * (8 * B * T * d * d
                                                    + 4 * B * T * d * d
                                                    + 4 * B * T * d * f),
            "cross_attention_kv_over_memory": L_dec * 4 * B * S * d * d,
            "cross_attention": L_dec * 4 * B * T * S * d,
            "decoder_self_attention": L_dec * 4 * B * T * T * d}


def _transformer(torch, dtype, seed, **kw):
    from paddle_tpu_torch import Transformer

    g = torch.Generator("cuda").manual_seed(seed)
    return Transformer(dropout=0.0, device="cuda", dtype=dtype, generator=g,
                       **kw).eval()


def phase_transformer_infer(torch, ctx, seed):
    from paddle_tpu_torch import Transformer
    from paddle_tpu_torch.ops.flash_attention import flash_attention

    B, S, T, warm, timed = 8, 1024, 256, 2, 10
    model = _transformer(torch, torch.bfloat16, seed)
    d, f = model.d_model, model.encoder.layers[0].linear1.out_features
    rng = np.random.RandomState(seed + 20)
    src32, tgt32 = (torch.from_numpy(rng.uniform(-1, 1, (B, n, d)).astype(
        np.float32)).cuda() for n in (S, T))
    src, tgt = src32.to(torch.bfloat16), tgt32.to(torch.bfloat16)
    mask = Transformer.generate_square_subsequent_mask(T)
    with torch.inference_mode():
        for _ in range(warm):
            model(src, tgt, tgt_mask=mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run():
            secs = []
            for _ in range(timed):
                t0 = time.perf_counter()
                out = model(src, tgt, tgt_mask=mask)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            return out, secs

        dense = flash_attention.dense_calls
        out, secs = _counted(torch, ctx, "transformer_infer_bf16", run,
                             exact={SDPA: 12 * timed})
        dense = flash_attention.dense_calls - dense
        peak = torch.cuda.max_memory_allocated() / 1e9
        if ctx.get("profile"):
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(src, tgt, tgt_mask=mask)
                torch.cuda.synchronize()
            emit(dict(phase="transformer_infer_profile",
                      **_device_breakdown(prof, "transformer_infer")))
        # the same weights and inputs in f32, outside the counted run
        ref_model = _transformer(torch, torch.float32, seed)
        ref_model.load_state_dict(model.state_dict())
        ref = ref_model(src32, tgt32, tgt_mask=mask)
        rel = ((out.float() - ref).norm() / ref.norm()).item()
    flops = _transformer_flops(B, S, T, d, f, 6, 6)
    total = sum(flops.values())
    per = sum(secs) / len(secs)
    res = {"phase": "transformer_infer",
           "config": "nn.Transformer() defaults (d_model 512, 8 heads, 6 + 6 "
           "layers, FFN 2048, ReLU, post-norm), dropout 0, bf16, seed-0 "
           "weights, eval, inference_mode; batch 8, source 1024, target 256, "
           "uniform(-1, 1), causal tgt_mask",
           "warmup_forwards": warm, "timed_forwards": timed,
           "nvidia_smi": ctx.get("smi"),
           "ms_per_forward": per * 1e3,
           "ms_per_forward_min_median_max": [
               min(secs) * 1e3, float(np.median(secs)) * 1e3,
               max(secs) * 1e3],
           "source_tokens_per_s": B * S / per,
           "target_tokens_per_s": B * T / per,
           "gflop_per_forward": total / 1e9,
           "gflop_by_part": {k: v / 1e9 for k, v in flops.items()},
           "flop_share_of_989tflops": total / per / PEAK_FLOPS["bfloat16"],
           "peak_memory_gb": peak,
           "b6_launches_per_forward":
               ctx["paths"]["transformer_infer_bf16"][SDPA]["launches"]
               / timed,
           "flash_attention_dense_calls": dense,
           "rel_l2_vs_f32": rel, "tol": TRANSFORMER_BF16_REL_TOL,
           "kernel_counts": ctx["paths"]["transformer_infer_bf16"]}
    res["ok"] = bool(out.shape == (B, T, d) and dense == 0
                     and bool(torch.isfinite(out.float()).all())
                     and math.isfinite(rel)
                     and rel <= TRANSFORMER_BF16_REL_TOL)
    emit(res)
    del model, ref_model, src, tgt, src32, tgt32, out, ref
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("transformer_infer phase failed its checks")


def phase_transformer_parity(torch, ctx, seed):
    from paddle_tpu_torch import Transformer

    kw = dict(num_encoder_layers=2, num_decoder_layers=2)
    card = _transformer(torch, torch.float32, seed, **kw)
    host = Transformer(dropout=0.0, device="cpu", **kw).eval()
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.RandomState(seed + 21)
    src, tgt = (torch.from_numpy(rng.uniform(-1, 1, (2, n, 512)).astype(
        np.float32)) for n in (640, 128))
    mask = Transformer.generate_square_subsequent_mask(128, device="cpu")
    with torch.inference_mode():
        got = _counted(torch, ctx, "transformer_f32", lambda: card(
            src.cuda(), tgt.cuda(), tgt_mask=mask.cuda()),
            exact={SDPA: 4}).cpu()
        want = host(src, tgt, tgt_mask=mask)
    err = ((got - want).norm() / want.norm()).item()
    res = {"phase": "transformer_parity", "dtype": "float32",
           "config": "nn.Transformer(512, 8 heads, 2 + 2 layers, FFN 2048), "
           "dropout 0, batch 2, source 640, target 128, causal tgt_mask",
           "rel_l2": err, "tol": TRANSFORMER_PARITY_TOL,
           "kernel_counts": ctx["paths"]["transformer_f32"],
           "ok": bool(math.isfinite(err) and err <= TRANSFORMER_PARITY_TOL)}
    emit(res)
    del card, host
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("f32 Transformer on the card differs from the "
                             "CPU")


# ---------------------------------------------------------------------------
# the library route's backward, the one-pass update, Transformer training
# ---------------------------------------------------------------------------
# (name, batch, heads, Sq, Skv, head dim, causal): Transformer-base's encoder
# self-attention and cross-attention (phase transformer_train's shapes),
# the head dims the bf16 tensor-core design takes, causal at the head dims
# the causal kernels B1/B2 do not take, and two head dims over 256 (the
# wide design)
SDPA_BWD_SHAPES = (("encoder_self_attention", 8, 8, 1024, 1024, 64, False),
                   ("cross_attention", 8, 8, 256, 1024, 64, False),
                   ("head_dim_128", 2, 8, 1024, 1024, 128, False),
                   ("head_dim_192", 2, 8, 1024, 1024, 192, False),
                   ("head_dim_256", 2, 8, 1024, 1024, 256, False),
                   ("causal_head_dim_192", 1, 8, 2048, 2048, 192, True),
                   ("causal_head_dim_256", 1, 8, 2048, 2048, 256, True),
                   ("head_dim_320", 1, 4, 1024, 1024, 320, False),
                   ("head_dim_512", 1, 4, 1024, 1024, 512, False))


def _sdpa_bwd_bound(BH, Sq, Skv, D, causal, isz, dtype_name):
    """q, k, v, O, dO and the LSE read and dq, dk, dv written once; 10 BH
    Sq Skv D FLOP (QK, PV's dV, dP, dQ and dK), over the lower triangle
    with its diagonal when causal. Returns (bound ms, what bounds it,
    FLOP)."""
    nbytes = (4 * Sq + 4 * Skv) * BH * D * isz + 4 * BH * Sq
    flops = (5 * BH * D * Sq * (Sq + 1) if causal
             else 10 * BH * Sq * Skv * D)
    return (*bound_ms(nbytes, flops, dtype_name), flops)


def _lse_variant_case(torch, q, k, v, o, lse, scale, causal, dn):
    """B6's LSE variant (`o`, `lse`) held to the plain version on the same
    inputs: the LSE within LSE_TOL, O within SDPA_TOL and the same bits as
    the inference instance's. Returns (the record, whether it passed)."""
    from paddle_tpu_torch.ops.flash_attention import (sdpa_forward,
                                                      sdpa_forward_plain)

    o_ref, lse_ref = sdpa_forward_plain(q, k, v, scale, causal,
                                        return_lse=True)
    o_inf = sdpa_forward(q, k, v, scale, causal)
    torch.cuda.synchronize()
    o_err = (o.float() - o_ref.float()).abs().max().item()
    top = o_ref.float().abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    same = bool(torch.equal(o, o_inf))
    rec = {"lse_max_abs_err": lse_err, "lse_tol": LSE_TOL[dn],
           "o_max_abs_err": o_err, "o_max_abs_plain": top,
           "o_tol": SDPA_TOL[dn],
           "o_same_bits_as_inference_instance": same}
    passed = (math.isfinite(lse_err) and lse_err <= LSE_TOL[dn]
              and math.isfinite(o_err) and same
              and o_err <= SDPA_TOL[dn] * (top if dn == "bfloat16" else 1.0))
    rec["ok"] = bool(passed)
    return rec, passed


def _library_bwd_ms(torch, forward, inputs, do, flush):
    """Device time in ms of a library backward: `torch.autograd.grad` of
    `forward(*leaves)` with respect to leaves cloned from `inputs`, for
    the output gradient `do` (of the output's shape). The call is captured
    in a CUDA graph and its replays timed with `cuda_ms`, as the kernels
    are, so that the host's gaps between its launches do not enter. The
    forward runs on the capture stream, where autograd then runs its
    backward."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [x.clone().requires_grad_() for x in inputs]
        out = forward(*leaves)

        def grad():
            return torch.autograd.grad(out, leaves, do, retain_graph=True)

        for _ in range(2):
            grad()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        grad()
    ms = cuda_ms(torch, graph.replay, 10, flush)
    del graph, leaves, out
    return ms


def _graph_call_ms(torch, fn, flush):
    """Device time in ms of `fn`: one call captured in a CUDA graph and its
    replays timed with `cuda_ms` after a flush of the L2 cache, as
    `_library_bwd_ms` times the library's backward."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    ms = cuda_ms(torch, graph.replay, 10, flush)
    del graph
    return ms


def phase_sdpa_bwd(torch, ctx):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.flash_attention import (sdpa_backward,
                                                      sdpa_backward_plain,
                                                      sdpa_forward)

    g = torch.Generator("cuda").manual_seed(14)
    res = {"phase": "sdpa_bwd", "nvidia_smi": ctx.get("smi"),
           "design": DESIGN["sdpa_bwd"], "cases": []}
    ok = True
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for name, B, H, Sq, Skv, D, causal in SDPA_BWD_SHAPES:
        BH, scale = B * H, 1.0 / math.sqrt(D)
        for dtype in (torch.bfloat16, torch.float32):
            dn = dname(torch, dtype)
            q, do = (torch.randn((BH, Sq, D), generator=g,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((BH, Skv, D), generator=g,
                                device="cuda").to(dtype) for _ in range(2))
            o, lse = sdpa_forward(q, k, v, scale, causal, return_lse=True)
            fwd, passed = _lse_variant_case(torch, q, k, v, o, lse, scale,
                                            causal, dn)
            ref = sdpa_backward_plain(q, k, v, o, do, lse, scale, causal)
            got = sdpa_backward(q, k, v, o, do, lse, scale, causal)
            again = sdpa_backward(q, k, v, o, do, lse, scale, causal)
            torch.cuda.synchronize()
            rel, floor = BWD_TOL[dn]
            errs = {}
            for gn, a, r in zip(GRADS, got, ref):
                err = (a.float() - r.float()).abs().max().item()
                top = r.float().abs().max().item()
                errs[gn] = {"max_abs_err": err, "max_abs_ref": top}
                passed &= math.isfinite(err) and err <= rel * top + floor
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            case = {"shape": f"{name}: B{B} H{H} Sq{Sq} Skv{Skv} D{D}"
                    + (" causal" if causal else ""), "dtype": dn,
                    "design": ("wgmma bf16 fed by TMA" if dtype ==
                               torch.bfloat16 and D <= 256
                               else "wide fp32 FMA"),
                    "errors": errs, "tol_rel": rel, "tol_abs": floor,
                    "max_abs_err": max(e["max_abs_err"]
                                       for e in errs.values()),
                    "same_bits_on_rerun": same, "b6_lse_variant": fwd}
            passed &= same
            del ref, again
            if dtype == torch.bfloat16:
                # like with like against the library's graph-replayed
                # backward: one call captured in a CUDA graph, its replays
                # timed after a flush; the eager time beside it
                kms = _graph_call_ms(torch, lambda: sdpa_backward(
                    q, k, v, o, do, lse, scale, causal), flush)
                ems = cuda_ms(torch, lambda: sdpa_backward(
                    q, k, v, o, do, lse, scale, causal), 10, flush)
                pms = cuda_ms(torch, lambda: sdpa_backward_plain(
                    q, k, v, o, do, lse, scale, causal), 3, flush, warmup=1)
                lms = _library_bwd_ms(
                    torch, lambda a, b, c: F.scaled_dot_product_attention(
                        a, b, c, is_causal=causal, scale=scale),
                    [x.view(B, H, -1, D) for x in (q, k, v)],
                    do.view(B, H, Sq, D), flush)
                b, by, flops = _sdpa_bwd_bound(BH, Sq, Skv, D, causal,
                                               q.element_size(), dn)
                case.update(kernel_ms=kms, eager_ms=ems, plain_ms=pms,
                            library_ms=lms,
                            bound_ms=b, bound_by=by,
                            tflops=flops / kms / 1e9,
                            library_tflops=flops / lms / 1e9,
                            share_of_bound=b / kms)
                if name == "encoder_self_attention":
                    # B6's LSE variant beside its inference instance
                    case["b6_ms"] = cuda_ms(torch, lambda: sdpa_forward(
                        q, k, v, scale, causal), 10, flush)
                    case["b6_lse_variant_ms"] = cuda_ms(
                        torch, lambda: sdpa_forward(
                            q, k, v, scale, causal, return_lse=True),
                        10, flush)
                    ctx["sdpa_bwd"] = dict(case)
            case["ok"] = bool(passed)
            ok &= passed
            res["cases"].append(case)
            del q, k, v, do, o, lse, got
    del flush
    torch.cuda.empty_cache()
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("the library route's backward or B6's LSE "
                             "variant disagrees with its plain version")


def _bitwise_equal(torch, got, want):
    """Whether two lists of tensors hold the same bits."""
    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32)

    return all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))


def _device_ms(torch, fn, iters, name):
    """Device time of `fn` in ms: its kernels', copies' and memsets' busy
    time under torch.profiler (`_device_breakdown`) over `iters` calls
    after one warm-up, without the host's gaps between its launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _device_breakdown(prof, name)["device_busy_ms"] / iters


def _states(opt, params):
    """The parameters and every accumulator of `opt`, as one list."""
    return list(params) + [a for k in sorted(opt._accumulators)
                           for a in opt._accumulators[k]]


def _max_rel_err(got, want):
    """max over tensors of max |got - want| / max |want|; inf where either
    holds a NaN (Python's max would drop it)."""
    worst = 0.0
    for a, b in zip(got, want):
        top = b.float().abs().max().item() if b.numel() else 0.0
        d = (a.float() - b.float()).abs().max().item() if a.numel() else 0.0
        e = d / top if top else d
        if math.isnan(e) or math.isnan(top):
            return math.inf
        worst = max(worst, e)
    return worst


def _max_abs_err(torch, got, want):
    """max over tensors of max |got - want|, NaN where either holds one."""
    errs = [(a.float() - b.float()).abs().max() for a, b in zip(got, want)
            if a.numel()]
    return torch.stack(errs).max().item() if errs else 0.0


def _update_case(torch, ctx, name, params, make, moments, seed, nbytes,
                 library, tol=None):
    """One step of the optimizer `make(params)` over `params` (bf16, on the
    card) with grads and accumulators drawn from `seed`: the one-pass
    kernel against the per-parameter loop (the plain version, run on the
    card on a copy), bitwise over parameters and accumulators, or with
    `tol` (Lars and Lamb, whose norms sum in another order) within `tol`
    relative, and then bitwise equal to a second launch from the same
    state; then the kernel's device time against the bytes bound, the
    loop's and `library`'s (a `torch.optim` optimizer over the same
    tensors, as a yardstick; None: no PyTorch call computes it), each
    without the host's gaps, and the whole step() of the kernel on the
    host's clock (the table built and uploaded)."""
    from paddle_tpu_torch.ops.optimizer_update import (
        optimizer_norms, optimizer_norms_plain, optimizer_update,
        optimizer_update_plain)
    from paddle_tpu_torch.optimizer import optimizer as opt_mod

    g = torch.Generator("cuda").manual_seed(seed)
    copies = [p.detach().clone() for p in params]
    grads = [torch.randn(p.shape, generator=g, device="cuda").to(p.dtype)
             for p in params]
    opt_k, opt_p = make(params), make(copies)
    for opt in (opt_k, opt_p):
        opt._ensure_state()
    for key, (scale, positive) in moments.items():
        for a, b in zip(opt_k._accumulators[key], opt_p._accumulators[key]):
            x = torch.randn(a.shape, generator=g, device="cuda") * scale
            a.copy_(x.abs() if positive else x)
            b.copy_(a)
    for p, c, gr in zip(params, copies, grads):
        p.grad, c.grad = gr, gr
    start = ([t.clone() for t in _states(opt_k, params)]
             if tol is not None else None)
    launches = optimizer_update.launches, optimizer_norms.launches
    opt_k.step()
    saved = opt_mod.optimizer_update
    opt_mod.optimizer_update = optimizer_update_plain
    try:
        opt_p.step()
    finally:
        opt_mod.optimizer_update = saved
    torch.cuda.synchronize()
    got, want = _states(opt_k, params), _states(opt_p, copies)
    res = {"case": name, "finite": bool(all(
        torch.isfinite(t).all().item() for t in got))}
    if tol is None:
        ok = _bitwise_equal(torch, got, want)
        res["bitwise_equal_to_the_loop"] = bool(ok)
        res["max_abs_err"] = 0.0 if ok else None
    else:
        err = _max_rel_err(got, want)
        res.update(max_rel_err_to_the_loop=err, tol=tol,
                   max_abs_err=_max_abs_err(torch, got, want))
        first = [t.clone() for t in got]
        for t, s0 in zip(got, start):
            t.copy_(s0)
        opt_k._step_count -= 1
        opt_k.step()
        torch.cuda.synchronize()
        again = _bitwise_equal(torch, _states(opt_k, params), first)
        res["bitwise_equal_across_two_launches"] = bool(again)
        ok = err <= tol and again
        del first, start
    norm_launches = optimizer_norms.launches - launches[1]
    one_launch = (optimizer_update.launches
                  == launches[0] + (1 if tol is None else 2)
                  and norm_launches == (0 if tol is None else 2))
    del opt_p, copies
    torch.cuda.empty_cache()
    n = sum(p.numel() for p in params)
    kms = _device_ms(torch, opt_k.step, 5, f"{name}_kernel")
    step_ms = cuda_ms(torch, opt_k.step, 5)
    saved = opt_mod.optimizer_update
    opt_mod.optimizer_update = optimizer_update_plain
    try:
        pms = _device_ms(torch, opt_k.step, 2, f"{name}_plain")
    finally:
        opt_mod.optimizer_update = saved
    lms = None
    if library is not None:
        lib = library(params)
        lms = _device_ms(torch, lib.step, 5, f"{name}_library")
        del lib
    b, by = bound_ms(nbytes * n, 0, "bfloat16")
    res.update({"params": n, "tensors": len(params),
                "one_launch": bool(one_launch), "kernel_ms": kms,
                "step_ms": step_ms, "plain_ms": pms, "library_ms": lms,
                "bound_ms": b, "bound_by": by, "bytes_per_param": nbytes,
                "share_of_bound": b / kms,
                "ok": bool(ok and one_launch and res["finite"])})
    if tol is not None:
        group = [(i, p, p.grad) for i, p in enumerate(params)]
        lr = opt_k.get_lr()
        norms = [optimizer_norms(opt_k, group, lr, 0) for _ in range(2)]
        res["norm_pass_bitwise_across_two_launches"] = bool(
            torch.equal(norms[0], norms[1]))
        res["ok"] &= res["norm_pass_bitwise_across_two_launches"]
        plain = optimizer_norms_plain(opt_k, group, lr, 0)
        diff = (norms[0] - plain).abs()
        res["norm_pass_max_abs_err"] = diff.max().item()
        res["norm_pass_max_rel_err"] = (
            diff / plain.abs().clamp_min(1e-30)).max().item()
        res["norm_pass_tol"] = NORM_PASS_TOL
        res["ok"] &= bool(norms[0].shape == plain.shape
                          and res["norm_pass_max_rel_err"] <= NORM_PASS_TOL)
        res["norm_pass_ms"] = _device_ms(
            torch, lambda: optimizer_norms(opt_k, group, lr, 0), 5,
            f"{name}_norms")
        res["norm_pass_plain_ms"] = _device_ms(
            torch, lambda: optimizer_norms_plain(opt_k, group, lr, 0), 2,
            f"{name}_norms_plain")
        # the pass reads p and g (Lars, 4 bytes a bf16 parameter), or p, g
        # and the two fp32 moments (Lamb, 12), and writes a few floats
        res["norm_pass_bytes_per_param"] = 12 if "lamb" in name else 4
        res["norm_pass_bound_ms"] = bound_ms(
            res["norm_pass_bytes_per_param"] * n, 0, "bfloat16")[0]
        del norms, plain
    for p in params:
        p.grad = None
    del opt_k
    torch.cuda.empty_cache()
    return res


def _merge_cases(torch, ctx, params, seed):
    """Gradient merge's kernels over grads of `params`' shapes (bf16) and
    fp32 buffers, each against its plain version on the card, bitwise:
    the merge (K1, a micro-step after the first), the finish (K2, scale
    2^15, K 4) and the unscale (K2, 2^15); device times against the bytes
    bound (10, 6 and 4 bytes an element), the plain version and, where one
    PyTorch call computes the same function, the library's
    (`torch._foreach_add_` for the merge)."""
    from paddle_tpu_torch.ops.grad_merge import (
        grad_finish, grad_finish_plain, grad_merge, grad_merge_plain,
        grad_unscale, grad_unscale_plain)

    g = torch.Generator("cuda").manual_seed(seed)
    grads = [torch.randn(p.shape, generator=g, device="cuda").to(p.dtype)
             for p in params]
    bufs = [torch.randn(p.shape, generator=g, device="cuda") for p in params]
    n = sum(p.numel() for p in params)
    cases = []

    def case(name, wrapper, kernel, plain, states, nbytes, library=None,
             library_note=None):
        ref = [t.clone() for t in states]
        work = [t.clone() for t in states]
        counts = wrapper.launches, wrapper.plain_calls
        kernel(work)
        plain(ref)
        torch.cuda.synchronize()
        bitwise = _bitwise_equal(torch, work, ref)
        one = (wrapper.launches - counts[0],
               wrapper.plain_calls - counts[1]) == (1, 1)
        del ref
        kms = _device_ms(torch, lambda: kernel(work), 5, f"{name}_kernel")
        pms = _device_ms(torch, lambda: plain(work), 2, f"{name}_plain")
        lms = (_device_ms(torch, lambda: library(work), 5,
                          f"{name}_library") if library else None)
        b, by = bound_ms(nbytes * n, 0, "bfloat16")
        del work
        torch.cuda.empty_cache()
        res = {"case": name, "elements": n, "tensors": len(params),
               "bitwise_equal_to_the_plain_version": bool(bitwise),
               "one_launch": bool(one), "kernel_ms": kms, "plain_ms": pms,
               "library_ms": lms, "library_note": library_note,
               "bound_ms": b, "bound_by": by, "bytes_per_element": nbytes,
               "share_of_bound": b / kms, "max_abs_err": 0.0 if bitwise
               else None, "shape": "GPT-1.3B's grads", "dtype": "bfloat16",
               "ok": bool(bitwise and one)}
        cases.append(res)
        return res

    ctx[MERGE] = case(
        "grad_merge_gpt_1p3b_bf16", grad_merge,
        lambda b: grad_merge(grads, b, False),
        lambda b: grad_merge_plain(grads, b, False), bufs, 10,
        lambda b: torch._foreach_add_(b, grads), "torch._foreach_add_")
    ctx[FINISH] = case(
        "grad_finish_gpt_1p3b_bf16", grad_finish,
        lambda o: grad_finish(o, bufs, 2.0 ** 15, 4),
        lambda o: grad_finish_plain(o, bufs, 2.0 ** 15, 4), grads, 6)
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    # torch's own unscale (_amp_foreach_non_finite_check_and_unscale_)
    # multiplies by the reciprocal, a different function, and takes no
    # bf16 grads: none beside it
    ctx[UNSCALE] = case(
        "grad_unscale_gpt_1p3b_bf16", grad_unscale,
        lambda gs: grad_unscale(gs, 2.0 ** 15, flag),
        lambda gs: grad_unscale_plain(gs, 2.0 ** 15, flag), grads, 4)
    ctx[UNSCALE]["flag_after"] = int(flag)
    ctx[UNSCALE]["ok"] &= int(flag) == 0
    del grads, bufs
    torch.cuda.empty_cache()
    return cases


def phase_optimizer_update(torch, ctx, seed):
    from paddle_tpu_torch import (SGD, Adadelta, Adagrad, AdamW,
                                  GPTForCausalLM, Lamb, Lars, Momentum,
                                  RMSProp, resnet50)

    res = {"phase": "optimizer_update", "nvidia_smi": ctx.get("smi"),
           "cases": []}
    g = torch.Generator("cuda").manual_seed(seed)
    gpt = GPTForCausalLM(_bench_config(), device="cuda",
                         dtype=torch.bfloat16, generator=g)
    named = [(n, p.detach()) for n, p in gpt.named_parameters()]
    del gpt
    names = [n for n, _ in named]
    params = [p for _, p in named]
    # every case starts from the same weights (each runs a dozen steps)
    init = [p.clone() for p in params]

    def fresh():
        for p, p0 in zip(params, init):
            p.copy_(p0)
        return params

    def no_decay(n):
        return not (n.endswith("bias") or "norm" in n)

    def adamw(ps):
        # biases and norms do not decay: a mixed decay
        return AdamW(1e-4, parameters=list(zip(names, ps)),
                     weight_decay=0.01, apply_decay_param_fun=no_decay)

    gpt_case = _update_case(
        torch, ctx, "gpt_1p3b_adamw_bf16", fresh(), adamw,
        {"moment1": (1e-3, False), "moment2": (1e-6, True)}, seed + 30, 22,
        lambda ps: torch.optim.AdamW(ps, lr=1e-4, fused=True))
    res["cases"].append(gpt_case)
    ctx["optimizer_update"] = dict(gpt_case, shape="GPT-1.3B AdamW",
                                   dtype="bfloat16")
    torch.cuda.empty_cache()
    # the other elementwise rules over the same parameters, bitwise
    elementwise = (
        ("gpt_1p3b_sgd_bf16", lambda ps: SGD(1e-2, parameters=ps), {}, 6,
         lambda ps: torch.optim.SGD(ps, lr=1e-2, foreach=True)),
        ("gpt_1p3b_adagrad_bf16",
         lambda ps: Adagrad(1e-2, parameters=ps,
                            initial_accumulator_value=0.1),
         {"moment": (1.0, True)}, 14,
         lambda ps: torch.optim.Adagrad(ps, lr=1e-2, foreach=True)),
        ("gpt_1p3b_rmsprop_bf16", lambda ps: RMSProp(1e-3, parameters=ps),
         {"mean_square": (1.0, True), "momentum": (1e-3, False)}, 22,
         lambda ps: torch.optim.RMSprop(ps, lr=1e-3, alpha=0.95,
                                        foreach=True)),
        ("gpt_1p3b_rmsprop_centered_bf16",
         lambda ps: RMSProp(1e-3, momentum=0.9, centered=True,
                            parameters=ps),
         # mean_grad at 1e-4: mean_square - mean_grad^2 stays above
         # -eps after the step, where sqrt would give NaN
         {"mean_square": (1.0, True), "momentum": (1e-3, False),
          "mean_grad": (1e-4, False)}, 30,
         lambda ps: torch.optim.RMSprop(ps, lr=1e-3, alpha=0.95,
                                        momentum=0.9, centered=True,
                                        foreach=True)),
        ("gpt_1p3b_adadelta_bf16", lambda ps: Adadelta(1.0, parameters=ps),
         {"avg_squared_grad": (1.0, True),
          "avg_squared_update": (1e-6, True)}, 22,
         lambda ps: torch.optim.Adadelta(ps, lr=1.0, rho=0.95,
                                         foreach=True)),
        ("gpt_1p3b_adamw_bf16_moments",
         lambda ps: AdamW(1e-4, parameters=list(zip(names, ps)),
                          weight_decay=0.01, apply_decay_param_fun=no_decay,
                          multi_precision=False),
         {"moment1": (1e-3, False), "moment2": (1e-6, True)}, 14,
         lambda ps: torch.optim.AdamW(ps, lr=1e-4, fused=True)))
    for k, (name, make, moments, nbytes, library) in enumerate(elementwise):
        res["cases"].append(_update_case(torch, ctx, name, fresh(), make,
                                         moments, seed + 32 + k, nbytes,
                                         library))
        torch.cuda.empty_cache()
    # lr 0.1: a step moves each weight about a tenth of its size, some 25
    # bf16 ulps, so the new parameters depend on the trust ratio (at 1e-3
    # most steps are below half an ulp, and the moments do not depend on
    # the norms)
    lamb = _update_case(
        torch, ctx, "gpt_1p3b_lamb_bf16", fresh(),
        lambda ps: Lamb(0.1, lamb_weight_decay=0.01, parameters=ps),
        {"moment1": (1e-3, False), "moment2": (1e-6, True)}, seed + 40, 22,
        None, tol=NORM_RULE_TOL)
    res["cases"].append(lamb)
    ctx[NORMS] = {"kernel_ms": lamb["norm_pass_ms"],
                  "bound_ms": lamb["norm_pass_bound_ms"], "bound_by":
                  "bytes", "plain_ms": lamb["norm_pass_plain_ms"],
                  "library_ms": None,
                  "max_abs_err": lamb["norm_pass_max_abs_err"],
                  "shape": "GPT-1.3B Lamb", "dtype": "bfloat16"}
    torch.cuda.empty_cache()
    res["cases"] += _merge_cases(torch, ctx, params, seed + 41)
    del named, params, init
    torch.cuda.empty_cache()
    g = torch.Generator("cuda").manual_seed(seed)
    rn = resnet50(num_classes=1000, device="cuda", generator=g).to(
        torch.bfloat16)
    rnamed = [(n, p.detach().as_subclass(torch.Tensor))
              for n, p in rn.named_parameters()]
    del rn
    params = [p for _, p in rnamed]
    res["cases"].append(_update_case(
        torch, ctx, "resnet50_momentum_bf16", params,
        lambda ps: Momentum(0.1, 0.9, parameters=ps),
        {"velocity": (1e-2, False)}, seed + 31, 14,
        lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9)))
    # Lars, biases and BatchNorm excluded from decay by name; the velocity
    # drawn at 1e-6, below the step lr * local_lr * g (about 6e-6 for a
    # conv weight), so that the new velocity follows the norms
    lars = _update_case(
        torch, ctx, "resnet50_lars_bf16", params,
        lambda ps: Lars(0.1, 0.9, parameters=list(zip(
            [n for n, _ in rnamed], ps)),
            exclude_from_weight_decay=["bias", "bn"]),
        {"velocity": (1e-6, False)}, seed + 42, 14, None,
        tol=NORM_RULE_TOL)
    # torch._foreach_norm computes Lars' two norms a tensor in one call
    for p in params:
        p.grad = torch.randn_like(p)
    lars["norm_pass_library_ms"] = _device_ms(
        torch, lambda: torch._foreach_norm(params + [p.grad for p in params]),
        5, "lars_norms_library")
    lars["norm_pass_library"] = "torch._foreach_norm over p and g"
    for p in params:
        p.grad = None
    res["cases"].append(lars)
    del params, rnamed
    torch.cuda.empty_cache()
    ctx[NORMS]["library_lars_ms"] = lars["norm_pass_library_ms"]
    res["ok"] = bool(all(c["ok"] for c in res["cases"]))
    emit(res)
    if not res["ok"]:
        raise AssertionError("the one-pass optimizer update or gradient "
                             "merge's kernels differ from their plain "
                             "versions")


def _fp32_mse(out, label):
    """mse_loss taken in fp32 (a bf16 loss near 2 moves in steps of 2^-6)."""
    from paddle_tpu_torch.ops.nn_ops import mse_loss

    return mse_loss(out.float(), label.float())


def _seq2seq(torch, model, mask):
    """`model(src, tgt, tgt_mask=mask)` as a module of two positional
    inputs, which TrainStep feeds."""
    class Seq2Seq(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, src, tgt):
            return self.model(src, tgt, tgt_mask=mask)

    return Seq2Seq()


def phase_transformer_train(torch, ctx, seed):
    from paddle_tpu_torch import AdamW, Transformer, TrainStep
    from paddle_tpu_torch.ops.flash_attention import flash_attention

    B, S, T, warm, timed, refeed = 8, 1024, 256, 2, 5, 3
    g = torch.Generator("cuda").manual_seed(seed)
    model = Transformer(dropout=0.1, attn_dropout=0.0, act_dropout=0.0,
                        device="cuda", dtype=torch.bfloat16,
                        generator=g).train()
    d, f = model.d_model, model.encoder.layers[0].linear1.out_features
    net = _seq2seq(torch, model,
                   Transformer.generate_square_subsequent_mask(T))
    # the paper's peak learning rate, d_model^-0.5 * 4000^-0.5 = 7e-4 (an
    # update of 1e-4 is under half a bf16 ulp of most weights)
    step = TrainStep(net, AdamW(learning_rate=7e-4,
                                parameters=net.parameters()), _fp32_mse)
    rng = np.random.RandomState(seed + 22)
    src, tgt = (torch.from_numpy(rng.uniform(-1, 1, (warm + timed, B, n, d))
                                 .astype(np.float32)).cuda()
                .to(torch.bfloat16) for n in (S, T))
    label = torch.from_numpy(rng.randn(warm + timed, B, T, d).astype(
        np.float32)).cuda().to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    warm_losses = [float(step(src[i], tgt[i], label[i]))
                   for i in range(warm)]
    torch.cuda.synchronize()
    dense = flash_attention.dense_calls

    def run():
        secs, out = [], []
        for i in range(warm, warm + timed):
            t0 = time.perf_counter()
            out.append(step(src[i], tgt[i], label[i]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out, secs

    losses, secs = _counted(
        torch, ctx, "transformer_train_bf16", run,
        exact={SDPA: 12 * timed, SDPA_LSE: 12 * timed, SBWD: 12 * timed,
               OPT: timed})
    dense = flash_attention.dense_calls - dense
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = warm_losses + [float(x) for x in losses]
    # the updates take hold: one batch fed again, its loss falls
    refeed_losses = [float(step(src[0], tgt[0], label[0]))
                     for _ in range(refeed)]
    if ctx.get("profile"):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(src[1], tgt[1], label[1])
            torch.cuda.synchronize()
        emit(dict(phase="transformer_train_profile",
                  **_device_breakdown(prof, "transformer_train")))
    flops = _transformer_flops(B, S, T, d, f, 6, 6)
    total = 3 * sum(flops.values())
    per = sum(secs) / len(secs)
    counts = ctx["paths"]["transformer_train_bf16"]
    res = {"phase": "transformer_train",
           "config": "nn.Transformer() defaults (the base model of Vaswani "
           "et al. 2017: d_model 512, 8 heads, 6 + 6 layers, FFN 2048, "
           "ReLU, post-norm), residual dropout 0.1, no attention or "
           "activation dropout, bf16, seed-0 weights, AdamW(7e-4), "
           "TrainStep(mse_loss in fp32) against a normal target; batch 8, "
           "source "
           "1024, target 256, uniform(-1, 1), causal tgt_mask",
           "params": sum(p.numel() for p in model.parameters()),
           "warmup_steps": warm, "timed_steps": timed,
           "nvidia_smi": ctx.get("smi"), "ms_per_step": per * 1e3,
           "ms_per_step_min_median_max": [
               min(secs) * 1e3, float(np.median(secs)) * 1e3,
               max(secs) * 1e3],
           "source_tokens_per_s": B * S / per,
           "target_tokens_per_s": B * T / per,
           "gflop_per_step": total / 1e9,
           "flop_share_of_989tflops": total / per / PEAK_FLOPS["bfloat16"],
           "peak_memory_gb": peak, "losses": losses,
           "refeed_losses": refeed_losses,
           "launches_per_step": {k: counts[k]["launches"] / timed
                                 for k in (SDPA_LSE, SBWD, OPT)},
           "flash_attention_dense_calls": dense, "kernel_counts": counts}
    res["ok"] = bool(all(math.isfinite(x) for x in losses + refeed_losses)
                     and refeed_losses[-1] < refeed_losses[0]
                     and dense == 0)
    emit(res)
    del step, net, model, src, tgt, label
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("transformer_train phase failed its checks")


def _transformer_train_run(torch, net, batches, lr, steps):
    """The first batch's gradients (one forward and backward), then `steps`
    AdamW steps through TrainStep from the same start: (losses, grads,
    parameter changes)."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.ops.nn_ops import mse_loss

    net.zero_grad(set_to_none=True)
    mse_loss(net(*batches[0][:2]), batches[0][2]).backward()
    grads = {n: p.grad.clone() for n, p in net.model.named_parameters()}
    net.zero_grad(set_to_none=True)
    before = {n: p.detach().clone() for n, p in net.model.named_parameters()}
    step = TrainStep(net, AdamW(learning_rate=lr,
                                parameters=net.parameters()), mse_loss)
    losses = [float(step(*b)) for b in batches[:steps]]
    return losses, grads, {n: p.detach() - before[n]
                           for n, p in net.model.named_parameters()}


def phase_transformer_train_parity(torch, ctx, seed):
    from paddle_tpu_torch import Transformer

    kw = dict(num_encoder_layers=2, num_decoder_layers=2, dropout=0.0)
    steps, B, S, T, lr = 3, 2, 640, 128, 1e-4
    g = torch.Generator("cuda").manual_seed(seed)
    card = Transformer(device="cuda", generator=g, **kw).train()
    host = Transformer(device="cpu", **kw).train()
    start = {k: v.detach().cpu().clone() for k, v in card.state_dict().items()}
    host.load_state_dict(start)
    rng = np.random.RandomState(seed + 23)
    batches = [tuple(torch.from_numpy(rng.uniform(-1, 1, (B, n, 512)).astype(
        np.float32)) for n in (S, T, T)) for _ in range(steps)]
    mask = Transformer.generate_square_subsequent_mask(T, device="cpu")
    cnet = _seq2seq(torch, card, mask.cuda())
    hnet = _seq2seq(torch, host, mask)
    got, g_card, d_card = _counted(
        torch, ctx, "transformer_train_f32", lambda: _transformer_train_run(
            torch, cnet, [tuple(x.cuda() for x in b) for b in batches], lr,
            steps),
        exact={SDPA_LSE: 4 * (steps + 1), SBWD: 4 * (steps + 1),
               OPT: steps})
    want, g_host, d_host = _transformer_train_run(torch, hnet, batches, lr,
                                                  steps)
    # the CPU's own noise: the same weights, the inputs 1e-7 apart
    host.load_state_dict(start)
    nudged = [tuple(x * (1 + 1e-7) for x in b) for b in batches]
    n_loss, n_grads, n_upd = _transformer_train_run(torch, hnet, nudged, lr,
                                                    steps)
    tol = TRANSFORMER_TRAIN_PARITY_TOL

    def grad_errs(a, b):
        rest_a, key_a = _k_proj_bias(torch, a)
        rest_b, _ = _k_proj_bias(torch, b)
        leaf, err, _ = _worst_leaf(rest_a, rest_b)
        top = max(t.abs().max().item() for t in rest_b.values())
        key = max(t.abs().max().item() for t in key_a.values()) / top
        return leaf, err, key

    leaf, gerr, gkey = grad_errs(g_card, g_host)
    _, noise_gerr, noise_gkey = grad_errs(n_grads, g_host)
    noise_upd = _update_errs(torch, n_upd, d_host, tol, lr, steps,
                             split=_k_proj_bias)
    bar = dict(tol, update=max(tol["update"], tol["update_noise_x"]
                               * noise_upd["update_rel_err"]))
    upd = _update_errs(torch, d_card, d_host, bar, lr, steps,
                       split=_k_proj_bias)
    diffs = [abs(a - b) for a, b in zip(got, want)]
    res = {"phase": "transformer_train_parity", "dtype": "float32",
           "config": "nn.Transformer(512, 8 heads, 2 + 2 layers, FFN 2048), "
           "dropout 0, batch 2, source 640, target 128, causal tgt_mask, "
           "mse_loss, AdamW(1e-4), 3 steps",
           "card_losses": got, "cpu_losses": want,
           "loss_max_abs_diff": max(diffs),
           "grad_worst_leaf": leaf, "grad_rel_err": gerr,
           "key_bias_grad_over_max_grad": gkey,
           "update_worst_leaf": upd["update_worst_leaf"],
           "update_rel_err": upd["update_rel_err"],
           "key_bias_max_step": upd["key_bias_max_step"],
           "cpu_noise": {"loss_max_abs_diff": max(
               abs(a - b) for a, b in zip(n_loss, want)),
               "grad_rel_err": noise_gerr,
               "key_bias_grad_over_max_grad": noise_gkey,
               "update_rel_err": noise_upd["update_rel_err"]},
           "tol": tol, "update_bar": bar["update"],
           "kernel_counts": ctx["paths"]["transformer_train_f32"]}
    res["ok"] = bool(max(diffs) <= tol["loss"] and gerr <= tol["grad"]
                     and gkey <= tol["key_bias_grad"] and upd["update_ok"]
                     and all(math.isfinite(x) for x in got))
    emit(res)
    del card, host, cnet, hnet
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("f32 Transformer train steps on the card differ "
                             "from the CPU")


def phase_train_accum(torch, ctx, seed):
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep
    from paddle_tpu_torch.amp import GradScaler

    cfg = _bench_config()
    batch, seq, K, windows, refeed = 2, 2048, 4, 2, 3
    g = torch.Generator("cuda").manual_seed(seed)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=g).train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = GradScaler(init_loss_scaling=2.0 ** 15)
    step = TrainStep(model, opt, model.loss_fn, accumulate_steps=K,
                     scaler=scaler)
    rng = np.random.RandomState(seed + 50)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (windows * K, batch, seq))
                           .astype(np.int64)).cuda()
    # warm the forward and backward (no step) and make AdamW's moments,
    # then two timed windows of K micro-batches each, one random batch a
    # micro-step, each window timed on its own (the first also allocates
    # the fp32 merge buffers)
    model(ids[0], labels=ids[0]).backward()
    model.zero_grad(set_to_none=True)
    opt._ensure_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []

    def timed_windows():
        out = []
        for w in range(windows):
            t0 = time.perf_counter()
            out += [step(x, x) for x in ids[w * K:(w + 1) * K]]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return out

    losses = _counted(torch, ctx, "train_accum_bf16", timed_windows,
                      exact={MERGE: windows * K, FINISH: windows,
                             OPT: windows, UNSCALE: 0})
    wall = walls[-1]
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(x) for x in losses]
    steps_done, scale = opt._step_count, scaler.get_scale()
    # the first window's micro-batches fed again: the window's mean loss
    # must fall
    refed = [[float(step(x, x)) for x in ids[:K]] for _ in range(refeed)]
    means = [sum(w) / K for w in refed]
    n = model.num_params()
    res = {"phase": "train_accum", "config": "bench.py gpt_1p3b train "
           "(vocab 32768, hidden 2048, 24 layers, 16 heads, seq 2048, "
           "dropout 0), bf16 params, AdamW(1e-4), micro-batch 2, "
           "accumulate_steps 4, GradScaler(2**15)", "params": n,
           "windows": windows, "micro_steps": windows * K,
           "ms_by_window": [w * 1e3 for w in walls],
           "ms_per_micro_step_last_window": wall / K * 1e3,
           "tokens_per_s_last_window": batch * seq * K / wall,
           "model_flop_share_of_989tflops_last_window":
               model.flops_per_token(seq) * batch * seq * K / wall
               / PEAK_FLOPS["bfloat16"],
           "peak_memory_gb": peak,
           "peak_memory_gb_of_train": ctx.get("train_peak_gb"),
           "merge_buffers_gb": 4 * n / 1e9, "losses": losses,
           "step_count_after_the_timed_windows": steps_done,
           "scale_after_the_timed_windows": scale,
           "refeed_window_mean_losses": means,
           "kernel_counts": ctx["paths"]["train_accum_bf16"],
           "nvidia_smi": ctx.get("smi")}
    res["ok"] = bool(all(math.isfinite(x) for x in losses + sum(refed, []))
                     and steps_done == windows and scale == 2.0 ** 15
                     and means[-1] < means[0])
    emit(res)
    del step, model, opt
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("train_accum phase failed its checks")


def phase_train_accum_parity(torch, ctx, seed):
    from paddle_tpu_torch import (AdamW, GPTForCausalLM, Momentum,
                                  TrainStep, resnet18)
    from paddle_tpu_torch.amp import GradScaler

    cfg = _bench_config()
    cfg.num_layers = 2
    K, windows, batch, seq, lr = 4, 2, 1, 256, 1e-4
    g = torch.Generator("cuda").manual_seed(seed)
    card = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                          generator=g).train()
    host = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32).train()
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.RandomState(seed + 51)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (windows * K, batch, seq))
                           .astype(np.int64))

    def run(model, x, k, n, make, rate):
        """`n` calls of a TrainStep with `accumulate_steps=k`, the
        optimizer `make(parameters, rate)` and a GradScaler(2**15) over
        the batches `x`: (losses, parameter changes, the step)."""
        before = {m: p.detach().clone() for m, p in model.named_parameters()}
        step = TrainStep(model, make(model.parameters(), rate),
                         model.loss_fn, accumulate_steps=k,
                         scaler=GradScaler(init_loss_scaling=2.0 ** 15))
        losses = [float(step(b, b)) for b in x[:n]]
        return losses, {m: p.detach() - before[m]
                        for m, p in model.named_parameters()}, step

    def adamw(ps, rate):
        return AdamW(learning_rate=rate, parameters=ps)

    def momentum(ps, rate):
        return Momentum(learning_rate=rate, momentum=0.9, parameters=ps)

    res = {"phase": "train_accum_parity", "dtype": "float32", "config":
           "bench widths, 2 layers, batch 1, seq 256, GradScaler(2**15); "
           f"Momentum({MOMENTUM_PARITY_LR}, 0.9), then AdamW({lr})",
           "tol": TRAIN_PARITY_TOL, "adamw_tol": TRAIN_ACCUM_PARITY_TOL,
           "nvidia_smi": ctx.get("smi")}
    start = {k: v.detach().cpu().clone() for k, v in
             card.state_dict().items()}
    # the CPU's own noise: the same steps from weights 1e-7 apart
    nudged = {k: v * (1 + 1e-7) for k, v in start.items()}
    ok = True
    # Momentum first, held to TRAIN_PARITY_TOL: its step is lr times the
    # grad, so a grad off by K or by the scale moves the change by that
    # factor (AdamW's m / sqrt(v) would hide it): one window of four, then
    # one scaler step without merge (the unscale). Then AdamW as
    # train_accum runs it, held to TRAIN_ACCUM_PARITY_TOL: two windows of
    # four, then two scaler steps. Each run from the same weights
    for key, k, n, make, rate, tol, exact in (
            ("train_accum_momentum_f32", K, K, momentum,
             MOMENTUM_PARITY_LR, TRAIN_PARITY_TOL,
             {MERGE: K, FINISH: 1, OPT: 1}),
            ("train_scaler_momentum_f32", 1, 1, momentum,
             MOMENTUM_PARITY_LR, TRAIN_PARITY_TOL,
             {UNSCALE: 1, OPT: 1, MERGE: 0}),
            ("train_accum_f32", K, windows * K, adamw, lr,
             TRAIN_ACCUM_PARITY_TOL,
             {MERGE: windows * K, FINISH: windows, OPT: windows}),
            ("train_scaler_f32", 1, 2, adamw, lr, TRAIN_ACCUM_PARITY_TOL,
             {UNSCALE: 2, OPT: 2, MERGE: 0})):
        card.load_state_dict(start)
        host.load_state_dict(start)
        got, d_card, cstep = _counted(
            torch, ctx, key,
            lambda: run(card, ids.cuda(), k, n, make, rate), exact=exact)
        want, d_host, _ = run(host, ids, k, n, make, rate)
        bar, noise_part = tol, None
        if "update_noise_x" in tol:
            host.load_state_dict(nudged)
            n_losses, d_noise, _ = run(host, ids, k, n, make, rate)
            noise = _update_errs(torch, d_noise, d_host, tol, rate, n // k)
            bar = dict(tol, update=max(tol["update"], tol["update_noise_x"]
                                       * noise["update_rel_err"]))
            noise_part = {
                "loss_max_abs_diff": max(abs(a - b) for a, b in
                                         zip(n_losses, want)),
                "update_rel_err": noise["update_rel_err"],
                "update_worst_leaf": noise["update_worst_leaf"]}
        diffs = [abs(a - b) for a, b in zip(got, want)]
        upd = _update_errs(torch, d_card, d_host, bar, rate, n // k)
        part = {"card_losses": got, "cpu_losses": want,
                "loss_max_abs_diff": max(diffs), **upd,
                "update_bar": bar["update"], "cpu_noise": noise_part,
                "step_count": cstep.optimizer._step_count,
                "kernel_counts": ctx["paths"][key]}
        part["ok"] = bool(max(diffs) <= tol["loss"] and upd["update_ok"]
                          and all(math.isfinite(x) for x in got)
                          and cstep.optimizer._step_count == n // k)
        res[key] = part
        ok &= part["ok"]
    # a window at a scale that overflows: skipped, the parameters and the
    # accumulators (the scaler run's moments) bitwise kept, the scale
    # halved. The loss times 1e3, as the JAX package's test of the skip
    # makes its loss large, so that the scaled grads overflow for certain
    # (cross entropy's grads at 1e38 need not: the card's did not)
    opt = cstep.optimizer
    scaler = GradScaler(init_loss_scaling=1e38, decr_every_n_nan_or_inf=1)
    skip = TrainStep(card, opt, lambda out, y: card.loss_fn(out, y) * 1e3,
                     accumulate_steps=K, scaler=scaler)
    kept = [t.clone() for t in _states(opt, opt._parameter_list)]
    xs = ids.cuda()
    _counted(torch, ctx, "train_accum_skip_f32",
             lambda: [skip(b, b) for b in xs[:K]],
             exact={MERGE: K, FINISH: 0, OPT: 0})
    gpt_kept = _bitwise_equal(torch, _states(opt, opt._parameter_list), kept)
    res["skip"] = {"params_and_accumulators_bitwise_kept": bool(gpt_kept),
                   "scale_after": scaler.get_scale(),
                   "step_count": opt._step_count}
    ok &= gpt_kept and scaler.get_scale() == 0.5e38 and \
        opt._step_count == 2
    del card, host, kept, opt, cstep, skip
    torch.cuda.empty_cache()
    # and a BatchNorm model's running statistics
    g = torch.Generator("cuda").manual_seed(seed)
    net = resnet18(num_classes=10, device="cuda", generator=g).train()
    _seed_bn(torch, net, seed + 52)
    mom = Momentum(0.1, 0.9, parameters=net.parameters())
    scaler = GradScaler(init_loss_scaling=1e38, decr_every_n_nan_or_inf=1)
    # far targets, as the JAX package's test of the skip: its scaled grads
    # overflow for certain (cross entropy at 1e38 need not)
    bn_step = TrainStep(net, mom, _fp32_mse, accumulate_steps=2,
                        scaler=scaler)
    x = torch.rand((2, 2, 3, 64, 64), generator=g, device="cuda") * 2 - 1
    y = torch.full((2, 2, 10), 1e3, device="cuda")
    mom._ensure_state()
    kept = [t.clone() for t in list(net.buffers())
            + _states(mom, mom._parameter_list)]
    _counted(torch, ctx, "resnet_accum_skip_f32",
             lambda: [bn_step(a, b) for a, b in zip(x, y)],
             exact={MERGE: 2, FINISH: 0, OPT: 0})
    bn_kept = _bitwise_equal(torch, list(net.buffers())
                             + _states(mom, mom._parameter_list), kept)
    res["skip"].update(
        resnet18_running_stats_params_and_velocity_bitwise_kept=bool(
            bn_kept), resnet18_scale_after=scaler.get_scale(),
        resnet18_buffers=len(list(net.buffers())))
    ok &= bn_kept and scaler.get_scale() == 0.5e38
    res["ok"] = bool(ok)
    emit(res)
    del net, mom, bn_step, kept
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("train_accum_parity phase failed its checks")


def phase_bert_lamb(torch, ctx, seed):
    from paddle_tpu_torch import (BertConfig, BertForPretraining, Lamb,
                                  TrainStep)

    cfg = BertConfig.bert_base()
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    batch, _, seq, _ = BERT_SHAPE
    warm, timed, L = 2, 5, cfg.num_layers
    g = torch.Generator("cuda").manual_seed(seed)
    model = BertForPretraining(cfg, device="cuda", dtype=torch.bfloat16,
                               generator=g).eval()
    opt = Lamb(learning_rate=1e-3, lamb_weight_decay=0.01,
               parameters=model.parameters())
    # no loss_fn: the model returns the MLM + NSP loss
    step = TrainStep(model, opt)
    rng = np.random.RandomState(seed + 53)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, seq))
                           .astype(np.int64)).cuda()
    mlm = torch.full((batch, seq), -100, dtype=torch.int64)
    picked = torch.from_numpy(rng.rand(batch, seq) < 0.15)
    mlm[picked] = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, int(picked.sum())).astype(np.int64))
    mlm = mlm.cuda()
    nsp = torch.from_numpy(rng.randint(0, 2, batch).astype(np.int64)).cuda()

    def call():
        # the trailing positional is split off as the label and dropped,
        # as in the JAX package: the model gets (ids, token types, mask,
        # mlm labels, nsp labels) and nsp is repeated as the placeholder
        return step(ids, None, None, mlm, nsp, nsp)

    torch.cuda.reset_peak_memory_stats()
    losses = [float(call()) for _ in range(warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed_losses = _counted(torch, ctx, "bert_lamb_bf16",
                            lambda: [call() for _ in range(timed)],
                            exact={SSF: L * timed, SSB: L * timed,
                                   SSFM: 0, SSBM: 0, NORMS: timed,
                                   OPT: timed})
    wall = time.perf_counter() - t0
    losses += [float(x) for x in timed_losses]
    emb = model.bert.embeddings
    n_embed = sum(e.weight.numel() for e in (
        emb.word_embeddings, emb.position_embeddings,
        emb.token_type_embeddings))
    n = sum(p.numel() for p in model.parameters())
    # 6 N over the matmul parameters, the tied MLM decoder (vocab x
    # hidden, a matmul over the word embeddings) and the attention
    fpt = (6 * (n - n_embed) + 6 * cfg.vocab_size * cfg.hidden_size
           + 12 * L * cfg.hidden_size * seq)
    tok_s = batch * seq * timed / wall
    res = {"phase": "bert_lamb", "config": "BertForPretraining at "
           "BertConfig.bert_base() (vocab 30522, hidden 768, 12 layers, 12 "
           "heads, FFN 3072), dropouts 0, eval mode, bf16 params, "
           "Lamb(1e-3, lamb_weight_decay=0.01), TrainStep without loss_fn "
           "(the model's MLM + NSP loss), batch 64 x seq 512, 15 % of "
           "positions labelled", "params": n, "flops_per_token": fpt,
           "warmup_steps": warm, "timed_steps": timed,
           "ms_per_step": wall / timed * 1e3, "tokens_per_s": tok_s,
           "model_flop_share_of_989tflops": fpt * tok_s
           / PEAK_FLOPS["bfloat16"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "step_count": opt._step_count,
           "kernel_counts": ctx["paths"]["bert_lamb_bf16"],
           "nvidia_smi": ctx.get("smi")}
    res["ok"] = bool(all(math.isfinite(x) for x in losses)
                     and losses[-1] < losses[0]
                     and opt._step_count == warm + timed)
    emit(res)
    del step, model, opt
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("bert_lamb phase failed its checks")


# ---------------------------------------------------------------------------
# sampled serving and int8 weights
# ---------------------------------------------------------------------------

def _chi2_vs_oracle(counts, probs, n):
    """(statistic, degrees of freedom, critical value at alpha 1e-3, draws
    on zero-probability tokens) of draw counts against oracle
    probabilities, bins expecting fewer than 5 draws pooled into one."""
    from scipy import stats

    exp = probs * n
    keep = exp > 0
    big = exp >= 5
    obs = list(counts[big]) + [counts[keep & ~big].sum()]
    want = list(exp[big]) + [exp[keep & ~big].sum()]
    if want[-1] == 0:
        obs, want = obs[:-1], want[:-1]
    stat = float(sum((o - e) ** 2 / e for o, e in zip(obs, want)))
    dof = len(want) - 1
    return stat, dof, float(stats.chi2.isf(1e-3, dof)), \
        int(counts[~keep].sum())


def _plain_launches(torch, fn, name):
    """Kernels the card ran for one call of `fn` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _device_breakdown(prof, name)["kernel_launches"]


# integer instructions (SASS opcodes without their suffixes): the ALU's
# adds, logic, shifts, funnel shifts, byte permutes, compares and selects,
# and the integer multiply-add
SASS_INT_OPS = ("IADD3", "IADD", "IADD32I", "VIADD", "LOP3", "LOP", "LOP32I",
                "SHF", "SHL", "SHR", "IMAD", "IMUL", "LEA", "PRMT", "ISETP",
                "IMNMX", "VIMNMX", "IABS", "SEL", "BMSK", "BREV", "FLO",
                "POPC")
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_]*)([^;]*);")
INT_LANES_PER_SM = 64                # Hopper: 16 INT32 lanes a sub-core
SMS = 132


def sass_loop_ops(cuobjdump, lib, fn):
    """The instructions of the largest loop (a backward branch's body) of
    kernel `fn` in a built library, from `cuobjdump -sass`: {"body": n,
    "int": n of SASS_INT_OPS, "opcodes": {op: n}}."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    code, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = fn in line
            continue
        m = SASS_LINE.search(line) if inside else None
        if m:
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    best = []
    for addr, op, rest in code:
        t = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if t and int(t.group(1), 16) < addr:
            body = [c for c in code if int(t.group(1), 16) <= c[0] <= addr]
            best = max(best, body, key=len)
    ops = {}
    for _, op, _ in best:
        ops[op] = ops.get(op, 0) + 1
    return {"body": len(best),
            "int": sum(n for op, n in ops.items() if op in SASS_INT_OPS),
            "opcodes": ops}


def smi_clocks_mhz():
    """(current, maximum) SM clock in MHz as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60, check=True)
    cur, top = r.stdout.strip().splitlines()[0].split(",")
    return float(cur), float(top)


def _draw_int_ops():
    """The draw's integer work a vocabulary entry: the integer instructions
    of the kernel's loop over fours of entries (its largest loop), divided
    by 4, and the card's integer rate, 132 SMs x 64 lanes at the maximum SM
    clock that nvidia-smi reports."""
    from paddle_tpu_torch.utils import cpp_extension

    lib = cpp_extension.build(["sampling"])["sampling"]["path"]
    cuobjdump = os.path.join(os.path.dirname(cpp_extension.find_nvcc()),
                             "cuobjdump")
    loop = sass_loop_ops(cuobjdump, lib, "sample_draw_kernel")
    cur, top = smi_clocks_mhz()
    return {"loop_instructions": loop["body"], "loop_int": loop["int"],
            "loop_opcodes": loop["opcodes"], "entries_a_loop": 4,
            "per_entry": loop["int"] / 4, "sm_clock_mhz": cur,
            "max_sm_clock_mhz": top,
            "int_ops_per_s": SMS * INT_LANES_PER_SM * top * 1e6}


def phase_sampling(torch, ctx):
    from paddle_tpu_torch.inference.sampling import (SamplingParams,
                                                     key_row, oracle_probs)
    from paddle_tpu_torch.ops.sampling import (SALT_ACCEPT, SALT_SAMPLE,
                                               masked_logits, sample_draw,
                                               sample_draw_plain,
                                               sample_uniform_plain,
                                               verify_draws)

    V = 50304
    g = torch.Generator("cuda").manual_seed(2)
    ops = _draw_int_ops()
    res = {"phase": "sampling", "vocab": V, "cases": [],
           "draw_int_ops": ops}
    ok = True
    p = SamplingParams(temperature=0.8, top_k=50, top_p=0.9)
    for N in SAMPLING_ROWS:
        raw = torch.randn((N, V), generator=g, device="cuda") * 3
        lg = masked_logits(raw, torch.full((N,), p.temperature,
                                           device="cuda"),
                           torch.full((N,), p.top_k, dtype=torch.int32,
                                      device="cuda"),
                           torch.full((N,), p.top_p, device="cuda"))
        keys = torch.stack([key_row(SEED + i) for i in range(N)]).cuda()
        pos = torch.randint(0, 2048, (N,), generator=g, device="cuda",
                            dtype=torch.int32)
        ex = torch.where(torch.arange(N, device="cuda") % 2 == 0,
                         lg.argmax(-1), -1).to(torch.int32)
        got = [sample_draw(lg, keys, pos, 0), sample_draw(lg, keys, pos, 0,
                                                          ex)]
        # the verify step's fused launch, with and without exclusions
        fused = [verify_draws(lg, keys, pos), verify_draws(lg, keys, pos,
                                                           ex)]
        torch.cuda.synchronize()
        want = [sample_draw_plain(lg, keys, pos, 0),
                sample_draw_plain(lg, keys, pos, 0, ex)]
        uwant = sample_uniform_plain(keys, pos, SALT_ACCEPT)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        fsame = all(torch.equal(t, w) for (t, _), w in zip(fused, want))
        ubits = all(bool(torch.equal(u.view(torch.int32),
                                     uwant.view(torch.int32)))
                    for _, u in fused)
        case = {"rows": N, "tokens_identical": same,
                "fused_tokens_identical": fsame,
                "fused_coin_bitwise": ubits}
        ok &= same and fsame and ubits
        flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
        # device time: calls on copies of the logits past the L2 in one
        # CUDA graph, its replays timed; and one eager call, the
        # wrapper's host time in it
        copies = [lg.clone() for _ in range(_copies(lg.numel() * 4))]
        kms = _graph_ms_cold(torch, [
            (lambda c=c: sample_draw(c, keys, pos, 0)) for c in copies])
        xms = _graph_ms_cold(torch, [
            (lambda c=c: sample_draw(c, keys, pos, SALT_SAMPLE, ex))
            for c in copies])
        fms = _graph_ms_cold(torch, [
            (lambda c=c: verify_draws(c, keys, pos, ex)) for c in copies])
        del copies
        eager = cuda_ms(torch, lambda: sample_draw(lg, keys, pos, 0), 50,
                        flush)
        pms = cuda_ms(torch, lambda: sample_draw_plain(lg, keys, pos, 0), 5,
                      flush, warmup=1)
        fpms = cuda_ms(torch, lambda: (
            sample_draw_plain(lg, keys, pos, SALT_SAMPLE, ex),
            sample_uniform_plain(keys, pos, SALT_ACCEPT)), 5, flush,
            warmup=1)
        lms = cuda_ms(torch, lambda: torch.multinomial(
            torch.softmax(lg, -1), 1), 50, flush)
        upms = cuda_ms(torch, lambda: sample_uniform_plain(
            keys, pos, SALT_ACCEPT), 5, flush, warmup=1)
        del flush
        bytes_ms, _ = bound_ms(N * V * 4 + N * (16 + 4 + 4), 0, "float32")
        int_ms = N * V * ops["per_entry"] / ops["int_ops_per_s"] * 1e3
        b, by = max(bytes_ms, int_ms), ("bytes" if bytes_ms >= int_ms
                                        else "operations")
        # the coin inside the fused launch: its key row, position and coin
        # read, written once, and three hashes a row, each counted as one
        # entry of the draw's loop
        ub_bytes, _ = bound_ms(N * (16 + 4 + 4), 0, "float32")
        ub_ops = N * 3 * ops["per_entry"] / ops["int_ops_per_s"] * 1e3
        ub, uby = max(ub_bytes, ub_ops), ("bytes" if ub_bytes >= ub_ops
                                          else "operations")
        fb_bytes, _ = bound_ms(N * V * 4 + N * (16 + 4 + 4 + 4 + 4), 0,
                               "float32")
        fb_ops = int_ms + ub_ops
        fb, fby = max(fb_bytes, fb_ops), ("bytes" if fb_bytes >= fb_ops
                                          else "operations")
        case.update(
            kernel_ms=kms, eager_call_ms=eager, plain_ms=pms, bound_ms=b,
            bound_by=by, bytes_bound_ms=bytes_ms, int_ops_bound_ms=int_ms,
            share_of_bound=b / kms, library_ms=lms,
            library_call="torch.multinomial(torch.softmax(logits), 1): "
                         "a different function (torch's own random draw)",
            plain_launches=_plain_launches(
                torch, lambda: sample_draw_plain(lg, keys, pos, 0),
                f"sample_draw_plain_{N}"),
            draw_excluded_ms=xms, fused_ms=fms, fused_plain_ms=fpms,
            fused_bound_ms=fb, fused_bound_by=fby,
            fused_over_draw_excluded=fms / xms,
            coin_marginal_ms=fms - xms, coin_plain_ms=upms,
            coin_bound_ms=ub, coin_bound_by=uby,
            coin_plain_launches=_plain_launches(
                torch, lambda: sample_uniform_plain(keys, pos, SALT_ACCEPT),
                f"sample_uniform_plain_{N}"))
        res["cases"].append(case)
        shape = (f"N {N} V {V}; ms by graph replays over copies of the "
                 f"logits past the L2")
        if N == SAMPLING_ROWS[0]:
            ctx["sample_draw"] = dict(
                max_abs_err=0.0 if same else None, kernel_ms=kms,
                plain_ms=pms, bound_ms=b, bound_by=by, library_ms=lms,
                shape=f"{shape} (decode step)", dtype="float32")
        else:
            ctx["verify_draws"] = dict(
                max_abs_err=0.0 if fsame and ubits else None,
                kernel_ms=fms, plain_ms=fpms, bound_ms=fb, bound_by=fby,
                library_ms=None, shape=f"{shape} (verify step), with "
                f"exclusions", dtype="float32")
            # the coin has no launch of its own: its ms, plain_ms and
            # bound_ms are the fused launch's (the draw and the coin), its
            # marginal_ms that launch less the coin-free draw with
            # exclusions, beside the bound of its three hashes a row
            ctx["sample_uniform"] = dict(
                max_abs_err=0.0 if ubits else None, kernel_ms=fms,
                plain_ms=fpms, bound_ms=fb, bound_by=fby, library_ms=None,
                marginal_ms=fms - xms, marginal_bound_ms=ub,
                shape=f"{shape} (verify step), with exclusions: the "
                      f"fused launch (verify_draws) that computes the "
                      f"coin", dtype="float32")
    # the distribution: 4,096 draws of one row against the numpy oracle
    n = 4096
    row = (torch.randn(V, generator=g, device="cuda") * 3)
    lg = masked_logits(row.expand(n, V).contiguous(),
                       torch.full((n,), p.temperature, device="cuda"),
                       torch.full((n,), p.top_k, dtype=torch.int32,
                                  device="cuda"),
                       torch.full((n,), p.top_p, device="cuda"))
    keys = torch.stack([key_row(SEED * 7919 + i) for i in range(n)]).cuda()
    toks = sample_draw(lg, keys, torch.zeros(n, dtype=torch.int32,
                                             device="cuda"), 0)
    oracle = oracle_probs(row.cpu().numpy(), p)
    stat, dof, crit, off = _chi2_vs_oracle(
        np.bincount(toks.cpu().numpy(), minlength=V), oracle, n)
    res["chi_square"] = {"draws": n, "params": "temperature 0.8, top_k 50, "
                         "top_p 0.9", "statistic": stat, "dof": dof,
                         "critical_1e-3": crit,
                         "draws_on_zero_probability": off}
    ok &= stat < crit and off == 0
    # no fallback: what the kernel does not take raises
    try:
        sample_draw(lg.bfloat16(), keys, keys[:, 0].int(), 0)
        res["bf16_logits_raise"] = False
    except ValueError:
        res["bf16_logits_raise"] = True
    ok &= res["bf16_logits_raise"]
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("sampling kernels disagree with their plain "
                             "versions or the oracle")


# GPT-1.3B's four projections: (name, K, N)
W8_SHAPES = (("qkv", 2048, 6144), ("out", 2048, 2048), ("fc1", 2048, 8192),
             ("fc2", 8192, 2048))


def _graph_ms_cold(torch, fns, reps=None):
    """Device time in ms of one call: `fns`, each a call on its own copy of
    the operands (together over twice the L2 cache), captured round-robin
    in one CUDA graph and its replays timed with `cuda_ms` over `reps`
    calls, so that every call finds its operands out of the L2 cache, as
    each layer of a decode step finds its weights, and neither the host's
    work in a wrapper nor the gaps between launches enter."""
    reps = reps or len(fns)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in fns[:2]:
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(reps):
            fns[i % len(fns)]()
    ms = cuda_ms(torch, graph.replay, 10) / reps
    del graph
    return ms


def _copies(nbytes):
    """Copies of an operand of `nbytes` whose total is over twice the L2
    cache (50 MB on the H100)."""
    return 2 * L2_BYTES // nbytes + 1


def _int8pack_mm(torch, x, q, s):
    """torch._weight_int8pack_mm(x, q, s): the same function as the int8
    linear without its bias, where this PyTorch has it for CUDA bf16
    tensors; None and the error where it has not."""
    try:
        y = torch._weight_int8pack_mm(x, q, s.reshape(-1))
        torch.cuda.synchronize()
        return y, None
    except (AttributeError, NotImplementedError, RuntimeError,
            TypeError) as e:  # what this PyTorch build lacks
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def phase_int8_linear(torch, ctx):
    from paddle_tpu_torch.ops.int8_linear import (_plan, int8_linear,
                                                  int8_linear_plain)
    from paddle_tpu_torch.quantization import dequantize, quantize_absmax

    g = torch.Generator("cuda").manual_seed(3)
    res = {"phase": "int8_linear", "nvidia_smi": ctx.get("smi"),
           "design": DESIGN["int8_linear"], "cases": [], "shard_cases": [],
           "tol": {"bfloat16": INT8_LINEAR_TOL["bfloat16"],
                   "float32": INT8_LINEAR_TOL["float32"]}}
    ok = True
    step = {"kernel_ms": 0.0, "graph_ms": 0.0, "bound_ms": 0.0,
            "library_ms": 0.0, "library_graph_ms": 0.0, "bf16_bound_ms": 0.0}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for name, K, N in W8_SHAPES:
        w = torch.randn((N, K), generator=g, device="cuda") * 0.02
        for dtype in (torch.bfloat16, torch.float32):
            q, s = quantize_absmax(w.to(dtype), axis=0)
            b = (torch.randn(N, generator=g, device="cuda") * 0.1).to(dtype)
            wdq = dequantize(q, s, dtype)
            if dtype == torch.bfloat16:
                # copies of the codes, scales and bias, and of the bf16
                # weight, for timings that find their weights out of L2
                cq = [(q.clone(), s.clone(), b.clone())
                      for _ in range(_copies(N * K))]
                cw = [wdq.clone() for _ in range(_copies(2 * N * K))]
            for M in W8_ROWS:
                x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
                got = int8_linear(x, q, s, b)
                again = int8_linear(x, q, s, b)
                want = int8_linear_plain(x, q, s, b)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                dn = dname(torch, dtype)
                same = _bitwise_equal(torch, [got], [again])
                case = {"shape": name, "M": M, "N": N, "K": K, "dtype": dn,
                        "max_abs_err": err, "max_abs_plain": ref,
                        "same_bits_on_rerun": same}
                good = (math.isfinite(err) and same
                        and err <= INT8_LINEAR_TOL[dn] * ref)
                if dtype == torch.bfloat16:
                    split, bn, bm = _plan(M, N, K)
                    kms = cuda_ms(torch, lambda: int8_linear(x, q, s, b),
                                  50, flush)
                    gms = _graph_ms_cold(torch, [
                        (lambda c=c: int8_linear(x, *c)) for c in cq])
                    pms = cuda_ms(torch, lambda: int8_linear_plain(
                        x, q, s, b), 20, flush)
                    lms = cuda_ms(torch, lambda: torch.matmul(x, wdq.t()),
                                  50, flush)
                    lgms = _graph_ms_cold(torch, [
                        (lambda c=c: torch.matmul(x, c.t())) for c in cw])
                    packed, why = _int8pack_mm(torch, x, q, s)
                    if packed is None:
                        case["int8pack_mm"] = why
                    else:
                        nob = int8_linear_plain(x, q, s)
                        case["int8pack_mm_max_abs_err"] = (
                            packed.float() - nob.float()).abs().max().item()
                        case["int8pack_mm_ms"] = _graph_ms_cold(torch, [
                            (lambda c=c: torch._weight_int8pack_mm(
                                x, c[0], c[1].reshape(-1))) for c in cq])
                    nbytes = N * K + 2 * M * K + 2 * M * N + 4 * N
                    bnd, by = bound_ms(nbytes, 2 * M * N * K, dn)
                    bf16_bnd, _ = bound_ms(2 * N * K + 2 * M * K + 2 * M * N,
                                           2 * M * N * K, dn)
                    case.update(plan={"split": split, "bn": bn, "bm": bm},
                                kernel_ms=gms, eager_ms=kms, plain_ms=pms,
                                library_ms=lgms, library_eager_ms=lms,
                                bound_ms=bnd, bound_by=by,
                                bf16_weight_bound_ms=bf16_bnd,
                                share_of_bound=bnd / gms)
                    if M == W8_ROWS[0]:
                        step["kernel_ms"] += kms
                        step["graph_ms"] += gms
                        step["bound_ms"] += bnd
                        step["library_ms"] += lms
                        step["library_graph_ms"] += lgms
                        step["bf16_bound_ms"] += bf16_bnd
                    if name == "fc1" and M == W8_ROWS[0]:
                        ctx["int8_linear"] = dict(
                            max_abs_err=err, kernel_ms=gms, eager_ms=kms,
                            plain_ms=pms, bound_ms=bnd, bound_by=by,
                            library_ms=lgms,
                            shape=f"M {M} N {N} K {K} (fc1, decode step)",
                            dtype=dn)
                case["ok"] = bool(good)
                ok &= good
                res["cases"].append(case)
            if dtype == torch.bfloat16:
                del cq, cw
        # a tensor-parallel shard's output columns (N / mp rows of codes
        # and scales, as the engine's int8 state splits them), bf16:
        # against the plain version, and bitwise the whole launch's columns
        dtype = torch.bfloat16
        q, s = quantize_absmax(w.to(dtype), axis=0)
        b = (torch.randn(N, generator=g, device="cuda") * 0.1).to(dtype)
        for M in W8_ROWS:
            x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
            whole = int8_linear(x, q, s, b)
            for mp in TP_DEGREES:
                n = N // mp
                for r in range(mp):
                    cols = slice(r * n, (r + 1) * n)
                    qs, ss, bs = q[cols].contiguous(), s[cols].contiguous(), \
                        b[cols].contiguous()
                    got = int8_linear(x, qs, ss, bs)
                    want = int8_linear_plain(x, qs, ss, bs)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ref = want.float().abs().max().item()
                    bitwise = _bitwise_equal(torch, [got],
                                             [whole[:, cols].contiguous()])
                    good = (math.isfinite(err) and bitwise
                            and err <= INT8_LINEAR_TOL["bfloat16"] * ref)
                    res["shard_cases"].append({
                        "shape": name, "mp": mp, "shard": r, "M": M, "N": n,
                        "K": K, "dtype": "bfloat16", "max_abs_err": err,
                        "max_abs_plain": ref, "ok": bool(good),
                        "plan": dict(zip(("split", "bn", "bm"),
                                         _plan(M, n, K))),
                        "bitwise_whole_launch_columns": bitwise})
                    ok &= good
    del flush
    L = 24
    res["decode_step_weights_ms"] = {
        "rows": W8_ROWS[0], "layers": L,
        "int8_kernel_ms": L * step["graph_ms"],
        "int8_kernel_eager_ms": L * step["kernel_ms"],
        "int8_bound_ms": L * step["bound_ms"],
        "bf16_matmul_ms": L * step["library_graph_ms"],
        "bf16_matmul_eager_ms": L * step["library_ms"],
        "bf16_bound_ms": L * step["bf16_bound_ms"]}
    try:
        x = torch.zeros((8, 24), dtype=torch.bfloat16, device="cuda")
        int8_linear(x, torch.zeros((64, 24), dtype=torch.int8,
                                   device="cuda"),
                    torch.ones((64, 1), dtype=torch.bfloat16, device="cuda"))
        res["k_not_of_16_raises"] = False
    except ValueError:
        res["k_not_of_16_raises"] = True
    ok &= res["k_not_of_16_raises"]
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("int8_linear kernel disagrees with its plain "
                             "version, a rerun or a shard differs in its "
                             "bits from the first run or the whole launch")


def _sampled_params(seed):
    """The sampled lanes of the engine trace: five requests, temperature
    0.7 or 1.0, top_k 50, top_p 0.9, seeds from the phase seed."""
    from paddle_tpu_torch.inference import SamplingParams

    return {i: SamplingParams(temperature=(0.7, 1.0)[j % 2], top_k=50,
                              top_p=0.9, seed=seed * 1000 + i)
            for j, i in enumerate(SAMPLED_LANES)}


def phase_engine_sampled(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine

    model = _model(torch, torch.bfloat16, seed)
    V = model.config.vocab_size
    _, trace = _engine_trace(V, seed)
    reqs = trace["first"] + trace["later"]
    params = _sampled_params(seed)
    res = {"phase": "engine_sampled", "config": "gpt_1p3b bf16, 8 slots, "
           "block 16, sampling=True; requests "
           f"{sorted(params)} sampled (temperature 0.7 or 1.0, top_k 50, "
           "top_p 0.9), the rest greedy", "runs": {}}
    ok = True
    for path, K in (("engine_sampled_bf16", 0),
                    ("engine_sampled_spec_bf16", SPEC_K)):
        kw = dict(num_slots=8, block_size=16, spec_decode_k=K)
        if K == 0 and "engine_tokens" in ctx:
            plain = ctx["engine_tokens"]
        else:
            eng = GenerationEngine(model, **kw)
            ids, out = _serve_trace(eng, trace)
            plain = [out[r] for r in ids]
            del eng
        outs = []
        for rep in range(2):
            eng = GenerationEngine(model, sampling=True, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run = lambda: _serve_trace(
                eng, trace, _drain_profiled(torch, ctx, path)
                if rep == 0 else None, params_of=params.get)
            ids, out = (_counted(torch, ctx, path, run) if rep == 0
                        else run())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            outs.append([out[r] for r in ids])
            if rep == 0:
                draws = ctx["paths"][path][DRAW]["launches"]
                fused = ctx["paths"][path][VDRAW]["launches"]
                run_res = {
                    "spec_decode_k": K, "wall_s": wall,
                    "tokens_generated": eng.tokens_generated,
                    "tokens_per_s": eng.tokens_generated / wall,
                    "sampled_tokens": eng.sampled_tokens,
                    "decode_steps": eng.decode_steps,
                    "prefill_first_tokens": eng.prefill_first_tokens,
                    "draw_launches": draws, "verify_draws_launches": fused,
                    "outputs_ok": _outputs_ok(ids, out, reqs, V),
                    "leak_check": "passed",
                    "kernel_counts": ctx["paths"][path]}
                if K:
                    run_res.update(accepted=eng.spec_accepted_tokens,
                                   rejected=eng.spec_rejected_tokens)
                # one coin-free draw a decode step and a final prefill
                # chunk, one fused draw and coin a verify step: together
                # one draw a step and a final chunk, and no coin launch
                run_res["launches_per_step_ok"] = bool(
                    draws + fused == eng.decode_steps
                    + eng.prefill_first_tokens
                    and fused == (eng.decode_steps if K else 0))
            del eng
        greedy = [i for i in range(len(reqs)) if i not in params]
        run_res["greedy_lanes_identical_to_sampling_off"] = all(
            outs[0][i] == plain[i] for i in greedy)
        run_res["sampled_lanes_differ_from_greedy"] = sum(
            outs[0][i] != plain[i] for i in params)
        run_res["second_run_identical"] = outs[0] == outs[1]
        ok &= (run_res["outputs_ok"] and run_res["launches_per_step_ok"]
               and run_res["greedy_lanes_identical_to_sampling_off"]
               and run_res["second_run_identical"]
               and run_res["sampled_lanes_differ_from_greedy"] > 0
               and run_res["sampled_tokens"] > 0)
        res["runs"][path] = run_res
        torch.cuda.empty_cache()
    res["ok"] = bool(ok)
    emit(res)
    del model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("engine_sampled phase failed its checks")


def phase_engine_wint8(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine, GPTConfig, GPTForCausalLM

    model = _model(torch, torch.bfloat16, seed)
    V, L = model.config.vocab_size, model.config.num_layers
    _, trace = _engine_trace(V, seed)
    reqs = trace["first"] + trace["later"]
    _engine_tokens(torch, ctx, model, trace)
    res = {"phase": "engine_wint8", "config": "gpt_1p3b bf16 model, int8 "
           "weights (qkv, out, fc1, fc2), 8 slots, block 16", "runs": {},
           "token_parity_min": TOKEN_PARITY_MIN}
    ok = True
    for path, kv in (("engine_wint8_bf16", None),
                     ("engine_wint8_kv8_bf16", "int8")):
        eng = GenerationEngine(model, num_slots=8, block_size=16,
                               weight_dtype="int8", kv_dtype=kv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, out = _counted(torch, ctx, path,
                            lambda: _serve_trace(eng, trace, _drain_profiled(
                                torch, ctx, path)))
        wall = time.perf_counter() - t0
        outs = [out[r] for r in ids]
        steps = eng.prefill_chunks + eng.decode_steps
        launches = ctx["paths"][path][W8]["launches"]
        share = _token_match_fraction(ctx["engine_tokens"], outs)
        run = {"kv_dtype": kv, "wall_s": wall,
               "tokens_generated": eng.tokens_generated,
               "tokens_per_s": eng.tokens_generated / wall,
               "weight_snapshot_int8_bytes": eng.weight_snapshot_nbytes(),
               "steps": steps, "int8_linear_launches": launches,
               "four_a_layer_a_step": launches == 4 * L * steps,
               "token_match_fraction": share,
               "generated_share_equal_to_bf16_k0": _token_share(
                   outs, ctx["engine_tokens"], reqs),
               "outputs_ok": _outputs_ok(ids, out, reqs, V),
               "leak_check": "passed", "kernel_counts": ctx["paths"][path]}
        ok &= (run["outputs_ok"] and share >= TOKEN_PARITY_MIN
               and run["four_a_layer_a_step"]
               and run["weight_snapshot_int8_bytes"] == WINT8_SNAPSHOT_BYTES)
        res["runs"][path] = run
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    # f32 at full width, 2 layers: the card's int8-weight engine against
    # the CPU's, from the same weights
    cfg = GPTConfig.gpt_1p3b()
    cfg.num_layers = 2
    g = torch.Generator("cuda").manual_seed(seed)
    card = GPTForCausalLM(cfg, device="cuda", generator=g).eval()
    host = GPTForCausalLM(cfg, device="cpu").eval()
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(0, V, 256), rng.randint(0, V, 300)]

    def serve(m, dev):
        eng = GenerationEngine(m, device=dev, num_slots=2, block_size=16,
                               weight_dtype="int8")
        ids = [eng.add_request(p, 16) for p in prompts]
        out = eng.drain()
        return [out[r] for r in ids]

    with torch.no_grad():
        got = _counted(torch, ctx, "wint8_f32", lambda: serve(card, "cuda"))
        want = serve(host, "cpu")
    res["f32_2_layers"] = {"identical_to_cpu": got == want,
                           "kernel_counts": ctx["paths"]["wint8_f32"]}
    ok &= got == want
    res["ok"] = bool(ok)
    emit(res)
    del card, host
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("engine_wint8 phase failed its checks")


# GPT-1.3B's LoRA sites: (name, in, out, heads of the head-grouped B or 0)
LORA_SITES_1P3B = (("qkv", 2048, 6144, 16), ("out", 2048, 2048, 0),
                   ("fc1", 2048, 8192, 0), ("fc2", 8192, 2048, 0))


def _lora_pool(torch, g, site, R, dtype, pages=9, layers=2):
    """One site's A and B pools `[pages, layers, R, ...]` (page p's rank
    rows past 1 + p % R zero, page 0 all zero) and scalings (page 0 at
    0)."""
    _, n_in, n_out, heads = site
    a = torch.randn((pages, layers, R, n_in), generator=g, device="cuda") \
        / math.sqrt(n_in)
    b = torch.randn((pages, layers, R, n_out), generator=g,
                    device="cuda") * 0.1
    for p in range(pages):
        r = 0 if p == 0 else 1 + (p * 5) % R
        a[p, :, r:] = 0
        b[p, :, r:] = 0
    if heads:
        b = b.view(pages, layers, R, heads, 3, n_out // (3 * heads))
    sc = torch.rand((pages,), generator=g, device="cuda") + 0.5
    sc[0] = 0
    return a.to(dtype).contiguous(), b.to(dtype).contiguous(), sc


def _graph_ms(torch, fn, reps=20):
    """Device time in ms of one call of `fn`: `reps` calls captured in one
    CUDA graph, its replays timed with CUDA events (`cuda_ms`) over
    `reps`, so that neither the host's time in a wrapper nor the gaps
    between launches enter. The L2 cache stays warm across the calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    ms = cuda_ms(torch, graph.replay, 10) / reps
    del graph
    return ms


def _lora_bound(B, S, R, n_in, n_out, pages, isz, dname_):
    """x and the base read once, the base written once, each distinct
    page's A and B rows of the layer read once."""
    M = B * S
    nbytes = (M * n_in + 2 * M * n_out + pages * R * (n_in + n_out)) * isz \
        + 4 * B + 4 * pages
    return bound_ms(nbytes, 2 * M * R * (n_in + n_out), dname_)


def _lora_shard(b, base, heads, mp, r):
    """Shard r of mp's B pages and base columns, as the engine hands them
    to the kernel: `out / mp` columns, or at the qkv site the shard's heads
    of the head-grouped pages, flattened, over the head-grouped base."""
    n = base.shape[-1] // mp
    if not heads:
        return b[..., r * n:(r + 1) * n].contiguous(), \
            base[..., r * n:(r + 1) * n]
    lh = heads // mp
    B, S = base.shape[:2]
    grouped = base.view(B, S, 3, heads, -1).permute(0, 1, 3, 2, 4)
    return b[:, :, :, r * lh:(r + 1) * lh].contiguous().flatten(3), \
        grouped[:, :, r * lh:(r + 1) * lh].reshape(B, S, n)


def _lora_shard_cases(torch, g, batched_lora, batched_lora_plain, layer):
    """The kernel on a tensor-parallel shard's B pages at GPT-1.3B's four
    sites, mp 2 and 4, rank 16, each LORA_ROWS shape, held as the whole
    launch is (the fp32 delta within LORA_DELTA_TOL of the plain version's,
    bf16 bitwise where the deltas round alike, null rows the base), and
    bitwise the whole launch's columns. Returns (cases, all passed)."""
    cases, ok, R = [], True, 16
    for site in LORA_SITES_1P3B:
        name, n_in, n_out, heads = site
        a16, b16, sc = _lora_pool(torch, g, site, R, torch.bfloat16)
        a32, b32 = a16.float(), b16.float()
        for B, S in LORA_ROWS:
            rows = torch.tensor(([3, 0, 1, 5, 0, 7, 2, 8] if B == 8
                                 else [4]), dtype=torch.int32, device="cuda")
            x = torch.randn((B, S, n_in), generator=g,
                            device="cuda").to(torch.bfloat16)
            base = torch.randn((B, S, n_out), generator=g,
                               device="cuda").to(torch.bfloat16)
            whole = batched_lora(base.clone(), x, a16, b16, rows, sc, layer)
            for mp in TP_DEGREES:
                for r in range(mp):
                    bs, part = _lora_shard(b16, base, heads, mp, r)
                    bs32, _ = _lora_shard(b32, base, heads, mp, r)
                    _, want = _lora_shard(b16, whole, heads, mp, r)
                    zero = torch.zeros(part.shape, device="cuda")
                    dk = batched_lora(zero, x.float(), a32, bs32, rows, sc,
                                      layer)
                    dp = batched_lora_plain(torch.zeros_like(zero),
                                            x.float(), a32, bs32, rows, sc,
                                            layer)
                    got = batched_lora(part.clone(), x, a16, bs, rows, sc,
                                       layer)
                    plain = batched_lora_plain(part.clone(), x, a16, bs,
                                               rows, sc, layer)
                    torch.cuda.synchronize()
                    ref = dp.abs().max().item()
                    err = (dk - dp).abs().max().item()
                    alike = dk.to(torch.bfloat16) == dp.to(torch.bfloat16)
                    null = (rows == 0)[:, None, None].expand_as(part)
                    case = {
                        "site": name, "mp": mp, "shard": r, "rank": R,
                        "slots": B, "rows_a_slot": S,
                        "columns": part.shape[-1],
                        "delta_max_abs_err": err, "delta_max_abs": ref,
                        "bf16_bitwise_where_alike": bool(torch.equal(
                            got[alike], plain[alike])),
                        "null_rows_bitwise_base": bool(torch.equal(
                            got[null], part[null])),
                        "bitwise_whole_launch_columns": bool(torch.equal(
                            got, want))}
                    case["ok"] = bool(
                        math.isfinite(err) and err <= LORA_DELTA_TOL * ref
                        and ref > 0 and case["bf16_bitwise_where_alike"]
                        and case["null_rows_bitwise_base"]
                        and case["bitwise_whole_launch_columns"])
                    ok &= case["ok"]
                    cases.append(case)
    return cases, ok


def phase_lora(torch, ctx):
    from paddle_tpu_torch.ops.lora import (LORA_MAX_RANK, batched_lora,
                                           batched_lora_plain)

    g = torch.Generator("cuda").manual_seed(5)
    res = {"phase": "lora", "delta_tol": LORA_DELTA_TOL, "cases": []}
    ok = True
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    layer = 1
    for site in LORA_SITES_1P3B:
        name, n_in, n_out, _ = site
        for R in LORA_RANKS:
            a16, b16, sc = _lora_pool(torch, g, site, R, torch.bfloat16)
            a32, b32 = a16.float(), b16.float()
            for B, S in LORA_ROWS:
                rows = torch.tensor(([3, 0, 1, 5, 0, 7, 2, 8] if B == 8
                                     else [4]), dtype=torch.int32,
                                    device="cuda")
                x = torch.randn((B, S, n_in), generator=g,
                                device="cuda").to(torch.bfloat16)
                base = torch.randn((B, S, n_out), generator=g,
                                   device="cuda").to(torch.bfloat16)
                # the fp32 deltas: the kernel's f32 instance on the bf16
                # values over a zero base, and the plain version's
                zero = torch.zeros((B, S, n_out), device="cuda")
                dk = batched_lora(zero, x.float(), a32, b32, rows, sc, layer)
                dp = batched_lora_plain(torch.zeros_like(zero), x.float(),
                                        a32, b32, rows, sc, layer)
                got = batched_lora(base.clone(), x, a16, b16, rows, sc,
                                   layer)
                again = batched_lora(base.clone(), x, a16, b16, rows, sc,
                                     layer)
                want = batched_lora_plain(base.clone(), x, a16, b16, rows,
                                          sc, layer)
                torch.cuda.synchronize()
                ref = dp.abs().max().item()
                err = (dk - dp).abs().max().item()
                alike = dk.to(torch.bfloat16) == dp.to(torch.bfloat16)
                null = (rows == 0)[:, None, None].expand_as(base)
                case = {"site": name, "rank": R, "slots": B, "rows_a_slot": S,
                        "delta_max_abs_err": err, "delta_max_abs": ref,
                        "bf16_bitwise_where_alike": bool(torch.equal(
                            got[alike], want[alike])),
                        "share_rounding_alike": alike.float().mean().item(),
                        "null_rows_bitwise_base": bool(torch.equal(
                            got[null], base[null])),
                        "rerun_same_bits": bool(torch.equal(got, again))}
                ok &= (math.isfinite(err) and err <= LORA_DELTA_TOL * ref
                       and ref > 0 and case["bf16_bitwise_where_alike"]
                       and case["null_rows_bitwise_base"]
                       and case["rerun_same_bits"])
                if R == 16:
                    rows8 = torch.arange(1, B + 1, dtype=torch.int32,
                                         device="cuda") if B == 8 else rows
                    pages = int(rows8.unique().numel())
                    kms = _graph_ms(torch, lambda: batched_lora(
                        base, x, a16, b16, rows8, sc, layer))
                    pms = _graph_ms(torch, lambda: batched_lora_plain(
                        base, x, a16, b16, rows8, sc, layer))
                    # one eager call, the wrapper's host time included
                    call = cuda_ms(torch, lambda: batched_lora(
                        base, x, a16, b16, rows8, sc, layer), 50, flush)

                    def bmm_route():
                        r = rows8.long()
                        al = a16[r, layer]
                        bl = b16[r, layer].reshape(B, R, n_out)
                        xr = torch.bmm(x, al.transpose(1, 2))
                        return base + torch.bmm(xr, bl) * \
                            sc[r].to(torch.bfloat16)[:, None, None]

                    lms = _graph_ms(torch, bmm_route)
                    # over copies of the pool past the L2, as each layer
                    # of a decode step finds its pages
                    pool = [(a16.clone(), b16.clone()) for _ in range(
                        _copies(a16.numel() * 2 + b16.numel() * 2))]
                    cold = _graph_ms_cold(torch, [
                        (lambda c=c: batched_lora(base, x, c[0], c[1],
                                                  rows8, sc, layer))
                        for c in pool])
                    del pool
                    bnd, by = _lora_bound(B, S, R, n_in, n_out, pages, 2,
                                          "bfloat16")
                    case.update(distinct_pages=pages, kernel_ms=kms,
                                cold_l2_ms=cold, plain_ms=pms,
                                library_ms=lms, bound_ms=bnd, bound_by=by,
                                share_of_bound=bnd / kms,
                                eager_call_ms=call)
                    if name == "fc1" and B * S == 8:
                        ctx["lora"] = dict(
                            max_abs_err=err, kernel_ms=kms, plain_ms=pms,
                            bound_ms=bnd, bound_by=by, library_ms=lms,
                            shape="fc1 (2048 -> 8192), 8 slots x 1 row, "
                                  "rank 16, 8 pages (decode step)",
                            dtype="bfloat16")
                res["cases"].append(case)
    del flush
    steps = {}
    for (B, S) in LORA_ROWS:
        cs = [c for c in res["cases"] if c["rank"] == 16 and c["slots"] == B
              and c["rows_a_slot"] == S]
        steps[f"{B}x{S}"] = {
            k: 24 * sum(c[k] for c in cs)
            for k in ("kernel_ms", "cold_l2_ms", "plain_ms", "library_ms",
                      "bound_ms", "eager_call_ms")}
    res["four_sites_24_layers_ms"] = steps
    res["shard_cases"], shard_ok = _lora_shard_cases(
        torch, g, batched_lora, batched_lora_plain, layer)
    ok &= shard_ok
    x = torch.zeros((1, 1, 16), device="cuda")
    try:
        R = LORA_MAX_RANK + 1
        batched_lora(torch.zeros((1, 1, 16), device="cuda"), x,
                     torch.zeros((2, 1, R, 16), device="cuda"),
                     torch.zeros((2, 1, R, 16), device="cuda"),
                     torch.ones(1, dtype=torch.int32, device="cuda"),
                     torch.ones(2, device="cuda"), 0)
        res["rank_above_64_raises"] = False
    except ValueError:
        res["rank_above_64_raises"] = True
    ok &= res["rank_above_64_raises"]
    res["ok"] = bool(ok)
    emit(res)
    if not ok:
        raise AssertionError("batched LoRA kernel disagrees with its plain "
                             "version")


def _engine_tokens(torch, ctx, model, trace):
    """Phase 5's bf16 tokens (served here when phase 5 did not run)."""
    from paddle_tpu_torch import GenerationEngine

    if "engine_tokens" not in ctx:
        eng = GenerationEngine(model, num_slots=8, block_size=16)
        ids, out = _serve_trace(eng, trace)
        ctx["engine_tokens"] = [out[r] for r in ids]
        del eng
        torch.cuda.empty_cache()
    return ctx["engine_tokens"]


def _f32_2_layers(torch, seed):
    """GPT-1.3B's widths at 2 layers in f32, on the card and on the CPU
    from the same weights, and generate_parity's prompts."""
    from paddle_tpu_torch import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt_1p3b()
    cfg.num_layers = 2
    g = torch.Generator("cuda").manual_seed(seed)
    card = GPTForCausalLM(cfg, device="cuda", generator=g).eval()
    host = GPTForCausalLM(cfg, device="cpu").eval()
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, 256),
               rng.randint(0, cfg.vocab_size, 300)]
    return card, host, prompts


def phase_engine_bucketed(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine
    from paddle_tpu_torch.ops.flash_attention import (causal_attention_fwd,
                                                      causal_attention_plain)

    res = {"phase": "engine_bucketed", "config": "gpt_1p3b bf16, 8 slots, "
           "block 16, prefill_chunk=None (buckets 16 ... 2048)", "runs": {},
           "token_parity_min": TOKEN_PARITY_MIN, "short_buckets": []}
    ok = True
    # the causal kernel at the ladder's short buckets
    g = torch.Generator("cuda").manual_seed(6)
    for dtype in (torch.bfloat16, torch.float32):
        for S in (16, 32, 48):
            q, k, v = (torch.randn((16, S, 128), generator=g,
                                   device="cuda").to(dtype) for _ in range(3))
            o_ref, l_ref = causal_attention_plain(q, k, v, 128 ** -0.5)
            o, lse = causal_attention_fwd(q, k, v, 128 ** -0.5)
            o2, _ = causal_attention_fwd(q, k, v, 128 ** -0.5)
            torch.cuda.synchronize()
            dn = dname(torch, dtype)
            case = {"dtype": dn, "S": S,
                    "max_abs_err": (o.float() - o_ref.float()).abs().max()
                    .item(), "lse_max_abs_err": (lse - l_ref).abs().max()
                    .item(), "rerun_same_bits": bool(torch.equal(o, o2))}
            ok &= (case["max_abs_err"] <= TOL[dn]
                   and case["lse_max_abs_err"] <= LSE_TOL[dn]
                   and case["rerun_same_bits"])
            res["short_buckets"].append(case)
    model = _model(torch, torch.bfloat16, seed)
    V, L = model.config.vocab_size, model.config.num_layers
    _, trace = _engine_trace(V, seed)
    reqs = trace["first"] + trace["later"]
    chunked = _engine_tokens(torch, ctx, model, trace)
    for path, kv in (("engine_bucketed_bf16", None),
                     ("engine_bucketed_kv8_bf16", "int8")):
        eng = GenerationEngine(model, num_slots=8, block_size=16,
                               prefill_chunk=None, kv_dtype=kv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, out = _counted(torch, ctx, path, lambda: _serve_trace(
            eng, trace, _drain_profiled(torch, ctx, path)))
        wall = time.perf_counter() - t0
        outs = [out[r] for r in ids]
        fwd = ctx["paths"][path][FWD]["launches"]
        share = _token_match_fraction(chunked, outs)
        run = {"kv_dtype": kv, "wall_s": wall,
               "buckets": list(eng.prefill_buckets),
               "tokens_generated": eng.tokens_generated,
               "tokens_per_s": eng.tokens_generated / wall,
               "admissions": eng.admissions,
               "decode_steps": eng.decode_steps,
               "causal_fwd_launches": fwd,
               "causal_fwd_24_an_admission": fwd == L * eng.admissions,
               "prefix_hit_tokens": eng.prefix_hit_tokens,
               "stalls": eng.stalls,
               "token_match_fraction_vs_chunked": share,
               "generated_share_equal_to_chunked": _token_share(
                   outs, chunked, reqs),
               "outputs_ok": _outputs_ok(ids, out, reqs, V),
               "leak_check": "passed", "kernel_counts": ctx["paths"][path]}
        ok &= (run["outputs_ok"] and run["causal_fwd_24_an_admission"]
               and eng.admissions == len(reqs)
               and eng.prefix_hit_tokens == 0 and share >= TOKEN_PARITY_MIN)
        res["runs"][path] = run
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    # f32 at full width, 2 layers: card against CPU and against generate()
    card, host, prompts = _f32_2_layers(torch, seed)
    new = 16

    def serve(m, dev):
        eng = GenerationEngine(m, device=dev, num_slots=2, block_size=16,
                               prefill_chunk=None)
        ids = [eng.add_request(p, new) for p in prompts]
        out = eng.drain()
        return [out[r] for r in ids]

    with torch.no_grad():
        got = _counted(torch, ctx, "bucketed_f32",
                       lambda: serve(card, "cuda"))
        want = serve(host, "cpu")
        gens = [card.generate(torch.from_numpy(p.astype(np.int32))[None]
                              .cuda(), max_length=len(p) + new,
                              use_cache=True)[0].cpu().numpy()
                for p in prompts]
    f32 = {"identical_to_cpu": got == want, "cases": [],
           "kernel_counts": ctx["paths"]["bucketed_f32"]}
    ok &= got == want
    for tok, ref in zip(got, gens):
        tok = np.asarray(tok)
        case = {"identical_to_generate": bool(np.array_equal(tok, ref))}
        if not case["identical_to_generate"]:
            at = int(np.nonzero(tok != ref)[0][0])
            with torch.no_grad():
                logits = card(torch.from_numpy(ref[:at].astype(np.int32))
                              [None].cuda())[0, -1]
            top2 = torch.topk(logits, 2).values
            case.update(first_diff=at, top2_gap=float(top2[0] - top2[1]))
            ok &= case["top2_gap"] <= 1e-3
        f32["cases"].append(case)
    res["f32_2_layers"] = f32
    res["ok"] = bool(ok)
    emit(res)
    del card, host
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("engine_bucketed phase failed its checks")


def _lora_registry(cfg, seed):
    """engine_lora's adapters 1-6 (ENGINE_LORA_RANKS, max_rank 16, 5 and 6
    one rank group): A rows of unit norm in expectation, B at 0.1, scaling
    1, so that each adapter's delta is a few tenths of its projection's
    output, which moves greedy tokens."""
    from paddle_tpu_torch.adapters import AdapterRegistry

    reg = AdapterRegistry(cfg, max_rank=16)
    rng = np.random.default_rng(seed + 7)
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    for aid, r in enumerate(ENGINE_LORA_RANKS, start=1):
        w = {}
        for site, (i_d, o_d) in (("qkv", (H, 3 * H)), ("out", (H, H)),
                                 ("fc1", (H, I)), ("fc2", (I, H))):
            w[site] = [(rng.standard_normal((r, i_d), dtype=np.float32)
                        / np.float32(math.sqrt(i_d)),
                        rng.standard_normal((o_d, r), dtype=np.float32)
                        * np.float32(0.1)) for _ in range(L)]
        reg.register(aid, w, scaling=1.0,
                     group="tenant5" if aid in (5, 6) else None)
    return reg


def _trace_subset(trace, keep):
    """The trace's requests whose index is in `keep`, first and later kept
    apart, waiting for the cached prompts that remain."""
    n = len(trace["first"])
    first = [r for i, r in enumerate(trace["first"]) if i in keep]
    later = [r for i, r in enumerate(trace["later"]) if n + i in keep]
    prompts = [p for p, _ in first]
    wait = [w for w in (trace["repeat"], trace["shared"])
            if any(len(p) >= len(w) and np.array_equal(p[:len(w)], w)
                   for p in prompts)]
    return dict(trace, first=first, later=later, wait=wait)


def phase_engine_lora(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine

    model = _model(torch, torch.bfloat16, seed)
    cfg = model.config
    V, L = cfg.vocab_size, cfg.num_layers
    _, trace = _engine_trace(V, seed)
    reqs = trace["first"] + trace["later"]
    ids_of = ENGINE_LORA_IDS
    t0 = time.perf_counter()
    reg = _lora_registry(cfg, seed)
    res = {"phase": "engine_lora", "config": "gpt_1p3b bf16, 8 slots, "
           "block 16, max_rank 16, adapters 1-6 of ranks "
           f"{list(ENGINE_LORA_RANKS)} (5 and 6 one rank group), a 1 + 4 "
           "page pool", "adapter_ids": list(ids_of),
           "registry_build_s": time.perf_counter() - t0, "runs": {}}
    ok = True
    plain = _engine_tokens(torch, ctx, model, trace)

    def engine(**kw):
        return GenerationEngine(model, num_slots=8, block_size=16,
                                adapters=reg, adapter_pool_pages=5, **kw)

    def run(path, eng, tr, adapter_of):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn = lambda: _serve_trace(eng, tr, path and _drain_profiled(
            torch, ctx, path), adapter_of=adapter_of)
        ids, out = _counted(torch, ctx, path, fn) if path else fn()
        wall = time.perf_counter() - t0
        return [out[r] for r in ids], wall

    # without adapters, in this call, for the tokens/s beside
    eng = GenerationEngine(model, num_slots=8, block_size=16)
    _, wall = run(None, eng, trace, None)
    res["runs"]["no_adapters"] = {"tokens_per_s": eng.tokens_generated / wall,
                                  "wall_s": wall}
    del eng
    # every request on the null adapter: phase 5's tokens, bitwise
    eng = engine()
    outs, wall = run("engine_lora_null_bf16", eng, trace, lambda i: 0)
    steps = eng.prefill_chunks + eng.decode_steps
    launches = ctx["paths"]["engine_lora_null_bf16"][LORA]["launches"]
    null = {"tokens_per_s": eng.tokens_generated / wall, "wall_s": wall,
            "identical_to_no_adapter_tokens": outs == plain,
            "lora_launches": launches, "steps": steps,
            "four_a_layer_a_step": launches == 4 * L * steps,
            "swapins": eng.adapter_swapins}
    ok &= (null["identical_to_no_adapter_tokens"]
           and null["four_a_layer_a_step"] and null["swapins"] == 0)
    res["runs"]["engine_lora_null_bf16"] = null
    del eng
    # the mixed-tenant trace
    eng = engine()
    outs, wall = run("engine_lora_bf16", eng, trace, lambda i: ids_of[i])
    steps = eng.prefill_chunks + eng.decode_steps
    launches = ctx["paths"]["engine_lora_bf16"][LORA]["launches"]
    mixed = {"tokens_per_s": eng.tokens_generated / wall, "wall_s": wall,
             "tokens_generated": eng.tokens_generated,
             "lora_launches": launches, "steps": steps,
             "four_a_layer_a_step": launches == 4 * L * steps,
             "swapins": eng.adapter_swapins,
             "evictions": eng.adapter_evictions, "stalls": eng.stalls,
             "prefix_hit_tokens": eng.prefix_hit_tokens,
             "cow_copies": eng.cow_copies,
             "pool_bytes": eng.adapter_pool.pool_nbytes(),
             "leak_check": "passed (blocks and adapter pages)",
             "outputs_ok": _outputs_ok(range(len(outs)), dict(
                 enumerate(outs)), reqs, V),
             "requests_differing_from_base": sum(
                 o != p for o, p, a in zip(outs, plain, ids_of) if a),
             "kernel_counts": ctx["paths"]["engine_lora_bf16"]}
    ok &= (mixed["outputs_ok"] and mixed["four_a_layer_a_step"]
           and mixed["swapins"] > 0 and mixed["evictions"] > 0
           and mixed["requests_differing_from_base"] > 0)
    del eng
    # each adapter's requests alone on a dedicated engine
    dedicated = {}
    for aid in sorted(set(ids_of)):
        keep = {i for i, a in enumerate(ids_of) if a == aid}
        sub = _trace_subset(trace, keep)
        eng = engine()
        got, _ = run(None, eng, sub, lambda i, a=aid: a)
        want = [outs[i] for i in sorted(keep)]
        dedicated[str(aid)] = got == want
        del eng
    mixed["identical_to_dedicated_engines"] = dedicated
    ok &= all(dedicated.values())
    res["runs"]["engine_lora_bf16"] = mixed
    res["tokens_per_s_ratio_mixed_to_no_adapters"] = \
        mixed["tokens_per_s"] / res["runs"]["no_adapters"]["tokens_per_s"]
    del model, reg
    torch.cuda.empty_cache()
    # f32 at full width, 2 layers: the card's mixed tenants against the CPU
    card, host, prompts = _f32_2_layers(torch, seed)
    reg2 = _lora_registry(card.config, seed)
    aids = (1, 5, 0)
    prompts = prompts + [prompts[0][:100]]
    f32 = {}

    def serve(m, dev, **kw):
        eng = GenerationEngine(m, device=dev, num_slots=2, block_size=16,
                               adapters=reg2, adapter_pool_pages=2, **kw)
        ids = [eng.add_request(p, 16, adapter_id=a)
               for p, a in zip(prompts, aids)]
        out = eng.drain()
        return [out[r] for r in ids]

    cells = [(pm, K) for pm in ("chunked", "bucketed") for K in (0, SPEC_K)]

    def card_cells():
        return [serve(card, "cuda", spec_decode_k=K, prefill_chunk=(
            "auto" if pm == "chunked" else None)) for pm, K in cells]

    with torch.no_grad():
        got = _counted(torch, ctx, "lora_f32", card_cells)
        for (pm, K), g in zip(cells, got):
            want = serve(host, "cpu", spec_decode_k=K, prefill_chunk=(
                "auto" if pm == "chunked" else None))
            f32[f"{pm}_K{K}"] = g == want
    ok &= all(f32.values())
    res["f32_2_layers_identical_to_cpu"] = f32
    res["f32_kernel_counts"] = ctx["paths"]["lora_f32"]
    res["ok"] = bool(ok)
    emit(res)
    del card, host
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("engine_lora phase failed its checks")


# ---------------------------------------------------------------------------
# tensor-parallel serving on a virtual mesh of the one card
# ---------------------------------------------------------------------------

def _tp_mesh(mp, device="cuda"):
    """A virtual mesh: `device` named mp times (None at mp 1)."""
    from paddle_tpu_torch.distributed import serving_mesh

    return None if mp == 1 else serving_mesh(mp, devices=[device] * mp)


class _ServedLogits:
    """The logits `eng` served, keyed by (request id, index): the row at
    index i scores the token at index i of the request's prompt +
    generated tokens, as the argmax, the acceptance walk or the draw read
    it (the first token's row from the prefill, the others from decode or
    verify steps). A row computed under a prefix the engine did not keep
    (a verify row past the accepted drafts, a stalled lane's) is
    overwritten by the step that emits the token. The rows stay on their
    device, views of each step's logits; the hooks add no launch.
    `close()` gives `eng` and its model their own methods back."""

    def __init__(self, eng):
        self.rows, self._first, self._eng = {}, None, eng
        logits_of, first_of = eng.model._logits_of, eng._first_of

        def first(h_last, slot, plen):
            self._first = (slot.req.req_id, plen)
            try:
                return first_of(h_last, slot, plen)
            finally:
                self._first = None

        def served(hidden, tp=None):
            out = logits_of(hidden, tp)
            self._keep(out)
            return out

        eng._first_of, eng.model._logits_of = first, served

    def _keep(self, out):
        if out.dim() == 1:
            self.rows[self._first] = out
            return
        for i, s in enumerate(self._eng._slots):
            if s is None or s.prefilling:
                continue
            for w in range(out.shape[1]):
                self.rows[(s.req.req_id, s.feed_pos + 1 + w)] = out[i, w]

    def close(self):
        del self._eng.model._logits_of, self._eng._first_of
        self._eng = None

    def stack(self, torch, rid, start, end):
        """Request `rid`'s rows at indices start .. end - 1, fp32, as one
        `[end - start, V]` tensor on the card."""
        return torch.stack([self.rows[(rid, i)].float().to("cuda")
                            for i in range(start, end)])


def _draw_scores(torch, logits, params, pos):
    """What a lane picks the argmax of at position `pos`: the logits, or
    for a sampled lane the Gumbel-perturbed masked logits of its draw."""
    if params is None or params.greedy:
        return logits
    from paddle_tpu_torch.inference.sampling import key_row
    from paddle_tpu_torch.ops.sampling import (SALT_SAMPLE, _row_keys,
                                               masked_logits)
    from paddle_tpu_torch.ops.threefry import gumbel

    dev = logits.device
    lg = masked_logits(
        logits[None], torch.tensor([params.temperature], device=dev),
        torch.tensor([params.top_k], dtype=torch.int32, device=dev),
        torch.tensor([params.top_p], device=dev))
    key = _row_keys(key_row(params.seed)[None].to(dev),
                    torch.tensor([pos], device=dev), SALT_SAMPLE)
    return (gumbel(key, lg.shape[1]) + lg)[0]


def _first_mismatch(got, ref):
    """The first index where two token lists differ (None if equal)."""
    n = min(len(got), len(ref))
    at = np.nonzero(np.asarray(got[:n]) != np.asarray(ref[:n]))[0]
    if at.size:
        return int(at[0])
    return None if len(got) == len(ref) else n


def _tp_served(torch, run1, run, got, ref, plen, params=None):
    """One request's served rows in the mp=1 run and a sharded run (each
    (`_ServedLogits`, the request's id there)), at the generated indices
    where both fed the same prefix
    (up to the first differing token, that one included): `rel_l2`, the
    largest ||l_N - l_1|| / ||l_1|| of a row; `noise`, the largest |logit|
    difference where they also emitted the same token; `first_step`, the
    largest at the first generated token. Where the tokens differ, the
    first differing index, `delta` (the rows' largest difference there),
    and mp=1's top-2 gap of what it picks from there (`_draw_scores`),
    with `scale` the lane's 1 / temperature (1 for a greedy lane): what
    its choice moves by a logit's difference."""
    at = _first_mismatch(got, ref)
    end = len(ref) if at is None else at + 1
    l1 = run1[0].stack(torch, run1[1], plen, end)
    ln = run[0].stack(torch, run[1], plen, end)
    d = (ln - l1).abs()
    same = d[:-1] if at is not None else d
    out = {"rel_l2": float(((ln - l1).norm(dim=1) / l1.norm(dim=1)).max()),
           "noise": float(same.max()) if same.numel() else 0.0,
           "first_step": float(d[0].max())}
    if at is not None:
        top2 = torch.topk(_draw_scores(torch, l1[-1], params, at - 1),
                          2).values
        out.update(first_diff=at, first_diff_generated=at - plen,
                   top2_gap=float(top2[0] - top2[1]), delta=float(d[-1].max()),
                   scale=1.0 if params is None or params.greedy
                   else 1.0 / params.temperature)
    return out


def _tp_verdict(served, bound=None, rel_tol=None):
    """A sharded run's requests (`_tp_served`) against mp=1's: `noise` and
    `rel_l2` over the run; each request that differs, a near tie when
    mp=1's top-2 gap there is at most `bound`, or without one at most
    twice the run's noise (times the lane's scale); with `rel_tol`, every
    agreed row's relative difference within it. Returns the report."""
    noise = max(r["noise"] for r in served.values())
    rel = max(r["rel_l2"] for r in served.values())
    rep = {"noise": noise, "rel_l2": rel, "rel_l2_tol": rel_tol,
           "first_step_max_abs_logit_diff": max(
               r["first_step"] for r in served.values()),
           "identical_to_mp1": all("first_diff" not in r
                                   for r in served.values()),
           "diverged": []}
    ok = rel_tol is None or rel <= rel_tol
    for i, r in served.items():
        if "first_diff" in r:
            lim = bound if bound is not None else 2.0 * noise * r["scale"]
            tie = dict(request=i, near_tie_bound=lim,
                       near_tie=r["top2_gap"] <= lim,
                       **{k: r[k] for k in ("first_diff",
                                            "first_diff_generated",
                                            "top2_gap", "delta")})
            rep["diverged"].append(tie)
            ok &= tie["near_tie"]
    rep["ok"] = bool(ok)
    return rep


def phase_tp_parity(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine

    card, host, prompts = _f32_2_layers(torch, seed)
    L = card.config.num_layers
    new = 16
    # (prefill, K, pools): fp pools chunked and bucketed at K 0 and 4, and
    # int8 pools chunked at K 0 (B5a on each shard's heads)
    cells = [(pm, K, "fp") for pm in ("chunked", "bucketed")
             for K in (0, SPEC_K)] + [("chunked", 0, "int8")]

    def engine(m, dev, mp, pm, K, kv):
        return GenerationEngine(
            m, device=dev, mesh=_tp_mesh(mp, dev), num_slots=2,
            block_size=16, spec_decode_k=K,
            kv_dtype="int8" if kv == "int8" else None,
            prefill_chunk="auto" if pm == "chunked" else None)

    def serve(eng):
        """The prompts' (ids, tokens), and the logits `eng` served."""
        rec = _ServedLogits(eng)
        try:
            ids = [eng.add_request(p, new) for p in prompts]
            out = eng.drain()
        finally:
            rec.close()
        return ids, [out[r] for r in ids], rec

    engines, runs = {}, {}

    def card_runs():
        for mp in (1,) + TP_DEGREES:
            for cell in cells:
                eng = engine(card, "cuda", mp, *cell)
                runs[(mp,) + cell] = serve(eng)
                engines[(mp,) + cell] = eng

    with torch.no_grad():
        _counted(torch, ctx, "tp_f32", card_runs)
        for cell in cells:
            eng = engine(host, "cpu", 2, *cell)
            runs[("cpu",) + cell] = serve(eng)
    counts = ctx["paths"]["tp_f32"]
    # each shard's kernels once a layer a step: decode (K 0; int8 pools
    # B5a), verify (K 4), B1 once a layer an admission (bucketed)
    want = {DEC: 0, VER: 0, FWD: 0, DEC8: 0}
    for (mp, pm, K, kv), eng in engines.items():
        paged = (DEC8 if kv == "int8" else DEC) if K == 0 else VER
        want[paged] += L * mp * eng.decode_steps
        if pm == "bucketed":
            want[FWD] += L * mp * eng.admissions
    launches = {k: counts[k]["launches"] for k in want}
    res = {"phase": "tp_parity", "dtype": "float32",
           "config": "gpt_1p3b widths (hidden 2048, 16 heads, vocab 50304), "
           "2 layers, 2 slots, block 16, phase 6's prompts, 16 new tokens; "
           "mp 1, 2, 4 on a virtual mesh of the card, chunked and bucketed, "
           f"K 0 and {SPEC_K}, and int8 pools chunked at K 0; mp 2 on the "
           "CPU (plain versions)",
           "near_tie_bound": TP_TIE_F32,
           "served_logits": "each generated token's row as the engine "
           "scored it, against the mp=1 card run's at the same index",
           "launches": launches, "launches_expected": want, "cells": {},
           "kernel_counts": counts}
    ok = launches == want
    first = {}
    for (mp, pm, K, kv), (ids, got, rec) in runs.items():
        if mp == 1:
            continue
        ids1, ref, rec1 = runs[(1, pm, K, kv)]
        served = {i: _tp_served(torch, (rec1, ids1[i]), (rec, ids[i]), g, r,
                                len(p))
                  for i, (g, r, p) in enumerate(zip(got, ref, prompts))}
        cell = _tp_verdict(served, bound=TP_TIE_F32)
        ok &= cell["ok"]
        name = (f"{'cpu_mp2' if mp == 'cpu' else f'mp{mp}'}_{pm}_K{K}"
                + ("_kv8" if kv == "int8" else ""))
        res["cells"][name] = cell
        first[name] = cell["first_step_max_abs_logit_diff"]
    # the largest logit difference from mp=1 on the first step (each
    # prompt's first generated token, as served)
    res["first_step_max_abs_logit_diff"] = first
    res["ok"] = bool(ok)
    emit(res)
    del engines, runs, card, host
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("tp_parity: tokens differ from mp=1 beyond a "
                             "near tie, or launch counts are off")


def phase_engine_tp(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine
    from paddle_tpu_torch.inference import SamplingParams

    model = _model(torch, torch.bfloat16, seed)
    cfg = model.config
    V, L = cfg.vocab_size, cfg.num_layers
    _, trace = _engine_trace(V, seed)
    reqs = trace["first"] + trace["later"]
    reg = _lora_registry(cfg, seed)
    sampled = {i: SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                                 seed=seed * 1000 + i)
               for i in TP_SAMPLED_LANES}
    configs = (
        ("chunked", dict(), None, None, (1,) + TP_DEGREES),
        ("bucketed_kv8_k4", dict(prefill_chunk=None, kv_dtype="int8",
                                 spec_decode_k=SPEC_K), None, None,
         (1,) + TP_DEGREES),
        ("lora_wint8_sampled", dict(weight_dtype="int8", sampling=True,
                                    adapters=reg, adapter_pool_pages=5),
         lambda i: ENGINE_LORA_IDS[i], sampled.get, (1, 2)))
    res = {"phase": "engine_tp", "card": nvidia_smi_line(),
           "config": "gpt_1p3b bf16, 8 slots, block 16, phase 5's trace, "
           "on a virtual mesh of the one card (mp 1, 2, 4): chunked K=0; "
           f"bucketed K={SPEC_K} with int8 KV; int8 weights with six "
           f"adapters (1 + 4 pages) and sampled requests "
           f"{list(TP_SAMPLED_LANES)} (mp 1, 2)", "runs": {},
           "rel_l2_tol": TP_BF16_REL_TOL,
           "near_tie": "mp=1's top-2 gap at the first differing token at "
           "most 2 * noise (/ temperature): noise the largest |logit| "
           "difference of the mp=1 and mp=N served rows where both fed the "
           "same prefix and emitted the same token"}
    ok = True
    for name, kw, adapter_of, params_of, mps in configs:
        ref = rec1 = ids1 = None
        for mp in mps:
            path = f"engine_tp_{name}_mp{mp}_bf16"
            eng = GenerationEngine(model, num_slots=8, block_size=16,
                                   mesh=_tp_mesh(mp), **kw)
            rec = _ServedLogits(eng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                ids, out = _counted(torch, ctx, path, lambda: _serve_trace(
                    eng, trace, _drain_profiled(torch, ctx, path),
                    params_of=params_of, adapter_of=adapter_of))
            finally:
                rec.close()
            wall = time.perf_counter() - t0
            outs = [out[r] for r in ids]
            counts = ctx["paths"][path]
            steps = eng.decode_steps
            want = {VER8: L * mp * steps, FWD: L * mp * eng.admissions} \
                if name.startswith("bucketed") else {DEC: L * mp * steps}
            if name.startswith("lora"):
                fwd = eng.prefill_chunks + steps
                want.update({W8: 4 * L * mp * fwd, LORA: 4 * L * mp * fwd,
                             DRAW: steps + eng.prefill_first_tokens})
            launches = {k: counts[k]["launches"] for k in want}
            c = eng.cache
            plane = c.kpools[0].numel() * c.kpools[0].element_size()
            run = {"mp": mp, "wall_s": wall,
                   "tokens_generated": eng.tokens_generated,
                   "tokens_per_s": eng.tokens_generated / wall,
                   "decode_steps": steps, "prefill_chunks": eng.prefill_chunks,
                   "admissions": eng.admissions,
                   "launches": launches, "launches_expected": want,
                   "pool_shard_bytes": plane, "pool_nbytes": c.pool_nbytes(),
                   "weight_snapshot_nbytes": eng.weight_snapshot_nbytes(),
                   "outputs_ok": _outputs_ok(ids, out, reqs, V),
                   "leak_check": "passed", "kernel_counts": counts}
            ok &= run["outputs_ok"] and launches == want
            if mp == 1:
                ref, rec1, ids1, plane1 = outs, rec, ids, plane
            else:
                run["pool_shard_is_mp1_over_mp"] = plane * mp == plane1
                served = {i: _tp_served(
                    torch, (rec1, ids1[i]), (rec, ids[i]), o, r, len(p),
                    params=params_of(i) if params_of else None)
                    for i, (o, r, (p, _)) in enumerate(zip(outs, ref, reqs))}
                run.update(_tp_verdict(served, rel_tol=TP_BF16_REL_TOL))
                ok &= run["ok"] and run["pool_shard_is_mp1_over_mp"]
            del eng, rec
            torch.cuda.empty_cache()
            res["runs"][path] = run
        del rec1
        torch.cuda.empty_cache()
    res["tokens_per_s"] = {p: r["tokens_per_s"]
                           for p, r in res["runs"].items()}
    res["ok"] = bool(ok)
    emit(res)
    del model, reg
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("engine_tp phase failed its checks")


# ---------------------------------------------------------------------------
# engine observability and the async core
# ---------------------------------------------------------------------------

# the async core's stages after its dispatch: each must make no host sync
ASYNC_POST_DISPATCH = ("_dispatch_ahead", "_prefetch_ahead",
                       "_end_of_step_gauges", "_flush_step_phases")
# engine_async's tenants: the first eight requests (the lanes' first
# occupants) on adapters 1 and 2 and the base, the later arrivals on 3-6
# (the repeated prompt, 5 and 9, and the shared prefix, 6, on the base, as
# the trace's waits and its COW need), so that a later arrival waits at
# the queue head while pages are free (the async core prefetches its
# page) and the pool then evicts
ASYNC_LORA_IDS = (1, 2, 1, 2, 0, 0, 0, 1, 3, 0, 4, 5, 6)


def _no_sync_after_dispatch(torch, eng):
    """Run the async core's post-dispatch stages of `eng` under
    `torch.cuda.set_sync_debug_mode("error")`: a host sync in any of them
    raises. The engine itself never sets the mode. The wrappers go with
    `_unwrap` (they hold the engine: a cycle keeps its pools alive)."""
    for name in ASYNC_POST_DISPATCH:
        def wrapped(*a, _fn=getattr(eng, name), **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        setattr(eng, name, wrapped)


def _unwrap(eng):
    """Drop the instance wrappers of `_no_sync_after_dispatch` and
    `_pending_at_return`."""
    for name in ASYNC_POST_DISPATCH + ("step",):
        eng.__dict__.pop(name, None)


def _pipeline_check(flight, steps):
    """The flight recorder's async events: every `async_dispatch(s)`
    before its `async_complete(s)`, never two steps in flight, every
    dispatch completed, one a step."""
    inflight, dispatched, completed, ok = None, 0, 0, True
    for e in flight:
        if e["event"] == "async_dispatch":
            ok &= inflight is None
            inflight = e["seq"]
            dispatched += 1
        elif e["event"] == "async_complete":
            ok &= inflight == e["seq"]
            inflight = None
            completed += 1
    return {"dispatched": dispatched, "completed": completed,
            "ok": bool(ok and inflight is None
                       and dispatched == completed == steps)}


def _pending_at_return(eng):
    """Count, after each `step()` of an async engine, whether the step it
    left in flight was still running on the card: the host got ahead."""
    seen = {"steps": 0, "pending": 0}
    step = eng.step

    def counted():
        out = step()
        if eng._inflight is not None:
            seen["steps"] += 1
            seen["pending"] += not eng._inflight.event.query()
        return out
    eng.step = counted
    return seen


def phase_engine_async(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine
    from paddle_tpu_torch.utils import cpp_extension

    cpp_extension.build()          # no build inside a timed serial run
    model = _model(torch, torch.bfloat16, seed)
    cfg = model.config
    V = cfg.vocab_size
    _, trace = _engine_trace(V, seed)
    reqs = trace["first"] + trace["later"]
    reg = _lora_registry(cfg, seed)
    configs = (
        ("chunked_k0", dict(), None, None),
        ("chunked_k4", dict(spec_decode_k=SPEC_K), None, None),
        ("kv8_k0", dict(kv_dtype="int8"), None, None),
        ("bucketed_kv8_k4", dict(prefill_chunk=None, kv_dtype="int8",
                                 spec_decode_k=SPEC_K), None, None),
        ("sampled_k4", dict(sampling=True, spec_decode_k=SPEC_K), None,
         _sampled_params(seed).get),
        ("lora_wint8", dict(weight_dtype="int8", adapters=reg,
                            adapter_pool_pages=5),
         lambda i: ASYNC_LORA_IDS[i], None),
        ("chunked_k0_mp2", dict(mesh=_tp_mesh(2)), None, None))
    res = {"phase": "engine_async", "card": nvidia_smi_line(),
           "config": "gpt_1p3b bf16, 8 slots, block 16, phase 5's trace, "
           "serial then async_core=True per configuration: chunked K=0; "
           f"chunked K={SPEC_K} (n-gram drafter on the helper thread); "
           f"int8 KV K=0; bucketed int8 KV K={SPEC_K}; sampled requests "
           f"{list(SAMPLED_LANES)} at K={SPEC_K}; six adapters with int8 "
           f"weights in a 1 + 4 page pool (ids {list(ASYNC_LORA_IDS)}); "
           "chunked K=0 at mp 2 on a virtual "
           "mesh. The async runs' post-dispatch stages "
           f"{list(ASYNC_POST_DISPATCH)} under "
           "set_sync_debug_mode('error')", "runs": {}}
    ok = True
    for name, kw, adapter_of, params_of in configs:
        run = {}
        for mode in ("serial", "async"):
            path = f"engine_async_{name}_{mode}_bf16"
            eng = GenerationEngine(model, num_slots=8, block_size=16,
                                   async_core=mode == "async",
                                   flight_capacity=1 << 16, **kw)
            if mode == "async":
                _no_sync_after_dispatch(torch, eng)
                pending = _pending_at_return(eng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, out = _counted(torch, ctx, path, lambda: _serve_trace(
                eng, trace, params_of=params_of, adapter_of=adapter_of))
            wall = time.perf_counter() - t0
            r = {"wall_s": wall, "tokens_generated": eng.tokens_generated,
                 "tokens_per_s": eng.tokens_generated / wall,
                 "decode_steps": eng.decode_steps,
                 "outputs_ok": _outputs_ok(ids, out, reqs, V),
                 "tokens": [out[i] for i in ids],
                 "kernel_counts": ctx["paths"][path]}
            if eng.spec_decode_k:
                r.update(accepted=eng.spec_accepted_tokens,
                         rejected=eng.spec_rejected_tokens)
            if eng.adapter_pool is not None:
                r.update(swapins=eng.adapter_swapins,
                         evictions=eng.adapter_evictions)
            if mode == "async":
                flight = eng.dump_flight_recorder()
                r["pipeline"] = _pipeline_check(flight, eng.decode_steps)
                r["in_flight_step_still_running_at_return"] = pending
                r["prefetches"] = sum(e["event"] == "adapter_prefetch"
                                      for e in flight)
            run[mode] = r
            _unwrap(eng)
            del eng
            torch.cuda.empty_cache()
        s, a = run["serial"], run["async"]
        got = {"tokens_bitwise_serial": a.pop("tokens") == s.pop("tokens"),
               "launches_equal": a["kernel_counts"] == s["kernel_counts"],
               "async_over_serial_tokens_per_s":
                   a["tokens_per_s"] / s["tokens_per_s"]}
        if "accepted" in s:
            got["drafts_equal"] = (a["accepted"], a["rejected"]) == (
                s["accepted"], s["rejected"])
        if "swapins" in s:
            got["prefetched"] = a["prefetches"] > 0 and a["evictions"] > 0
        run["gates"] = got
        ok &= bool(s["outputs_ok"] and a["outputs_ok"]
                   and a["pipeline"]["ok"]
                   and all(v for k, v in got.items()
                           if not k.endswith("tokens_per_s")))
        res["runs"][name] = run
    res["tokens_per_s"] = {n: {m: r[m]["tokens_per_s"]
                               for m in ("serial", "async")}
                           for n, r in res["runs"].items()}
    res["ok"] = bool(ok)
    emit(res)
    del model, reg
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("engine_async phase failed its checks")


def _series(snap, name):
    fam = snap.get(name)
    return [] if fam is None else fam["series"]


def _one(snap, name, **labels):
    """The value (or histogram count) of the series of `name` carrying
    `labels` (0 when absent)."""
    for s in _series(snap, name):
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return 0


def _observed_gates(eng, snap, text, trace_path, reqs):
    """engine_observed's checks of one traced or untraced run."""
    from paddle_tpu_torch.observability import STEP_PHASES, parse_prometheus

    n = len(reqs)
    ttft = sum(s["count"] for s in _series(snap, "engine_ttft_seconds"))
    tpot = sum(s["count"] for s in _series(snap, "engine_tpot_seconds"))
    stalls = {s["labels"]["path"]: s["value"]
              for s in _series(snap, "engine_block_stalls_total")}
    g = {"tokens": _one(snap, "engine_tokens_generated_total")
         == eng.tokens_generated,
         "admissions": _one(snap, "engine_admissions_total")
         == eng.admissions == n,
         "stalls_by_path": all(stalls.get(p, 0) == v
                               for p, v in eng.stalls.items()),
         "prefix_hit_tokens": _one(
             snap, "engine_prefix_cache_hit_tokens_total")
         == eng.prefix_hit_tokens > 0,
         "cow_copies": _one(snap, "engine_cow_copies_total")
         == eng.cow_copies >= 1,
         "spec_accepted": _one(snap, "engine_spec_draft_tokens_total",
                               result="accepted")
         == eng.spec_accepted_tokens,
         "spec_rejected": _one(snap, "engine_spec_draft_tokens_total",
                               result="rejected")
         == eng.spec_rejected_tokens,
         "ttft_count_is_requests": ttft == n,
         # every token but each request's first (no request of the trace
         # finishes on its first token)
         "tpot_count_is_decode_emissions": tpot
         == eng.tokens_generated - n}
    parsed = parse_prometheus(text)
    g["prometheus_round_trip"] = set(parsed["types"]) == set(snap) and (
        "engine_tokens_generated_total", {}, float(eng.tokens_generated)) \
        in parsed["samples"]
    phases = {s["labels"]["phase"]
              for s in _series(snap, "engine_step_host_gap_seconds")}
    g["phases_in_step_phases"] = bool(phases) \
        and phases <= set(STEP_PHASES)
    frac = _one(snap, "engine_step_device_fraction")
    g["device_fraction_in_0_1"] = 0.0 <= frac <= 1.0
    if trace_path is not None:
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        by_req = {}
        for e in events:
            a = e.get("args", {})
            if "req_id" in a:
                by_req.setdefault(a["req_id"], set()).add(a.get("trace_id"))
        g["trace_ids_one_a_request"] = len(by_req) == n and all(
            len(t) == 1 and None not in t for t in by_req.values())
    return g, sorted(phases), frac


def phase_engine_observed(torch, ctx, seed):
    from paddle_tpu_torch import GenerationEngine

    model = _model(torch, torch.bfloat16, seed)
    V = model.config.vocab_size
    _, trace = _engine_trace(V, seed)
    reqs = trace["first"] + trace["later"]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "paddle_tpu_torch")
    os.makedirs(out_dir, exist_ok=True)
    res = {"phase": "engine_observed", "card": nvidia_smi_line(),
           "config": "gpt_1p3b bf16, 8 slots, block 16, phase 5's trace, "
           f"K=0 and K={SPEC_K}, tracing off then on", "runs": {}}
    ok = True
    for K in (0, SPEC_K):
        toks = {}
        for tracing in (False, True):
            tag = f"k{K}_{'on' if tracing else 'off'}"
            path = f"engine_observed_{tag}_bf16"
            eng = GenerationEngine(model, num_slots=8, block_size=16,
                                   spec_decode_k=K, tracing=tracing,
                                   trace_capacity=1 << 16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, out = _counted(torch, ctx, path,
                                lambda: _serve_trace(eng, trace))
            wall = time.perf_counter() - t0
            toks[tracing] = [out[i] for i in ids]
            trace_path = None
            if tracing:
                trace_path = os.path.join(out_dir, f"engine_{tag}.json")
                n_events = eng.export_trace(trace_path)
            gates, phases, frac = _observed_gates(
                eng, eng.metrics_snapshot(), eng.render_prometheus(),
                trace_path, reqs)
            r = {"wall_s": wall, "tokens_generated": eng.tokens_generated,
                 "tokens_per_s": eng.tokens_generated / wall,
                 "host_gap_phases": phases, "device_fraction_last": frac,
                 "gates": gates, "outputs_ok": _outputs_ok(ids, out, reqs, V),
                 "kernel_counts": ctx["paths"][path]}
            if tracing:
                r["trace_events"] = n_events
            ok &= r["outputs_ok"] and all(gates.values())
            res["runs"][path] = r
            del eng
            torch.cuda.empty_cache()
        off, on = (res["runs"][f"engine_observed_k{K}_{t}_bf16"]
                   for t in ("off", "on"))
        same = {"tokens_bitwise": toks[True] == toks[False],
                "launches_equal": on["kernel_counts"] == off["kernel_counts"]}
        on["tracing_on_vs_off"] = same
        ok &= all(same.values())
    res["tokens_per_s"] = {p: r["tokens_per_s"]
                           for p, r in res["runs"].items()}
    res["ok"] = bool(ok)
    emit(res)
    del model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("engine_observed phase failed its checks")


def _serve_fleet(fleet, trace):
    """Serve `trace` through a fleet as `_serve_trace` serves it on one
    engine: the first requests, fleet steps until the repeated prompt and
    the shared prefix are cached on an intake replica (with the prefix
    cache off, until no intake replica queues), then the later ones, then
    `run()`. Returns (request ids, results, {prompt name: the replicas
    whose cache held it before the later requests}, the replica each later
    request was routed to)."""
    intake = [r.engine for r in fleet._routable(
        "prefill" if fleet.disaggregated else "mixed")]
    wait = {"repeat": trace["repeat"], "shared": trace["shared"]}
    ids = [fleet.add_request(p, n) for p, n in trace["first"]]

    def waiting():
        if not intake[0].enable_prefix_cache:
            return any(e.num_pending for e in intake)
        return any(all(e.cache.warm_prefix_tokens(w) < len(w)
                       for e in intake) for w in wait.values())
    while waiting():
        if fleet.step() == 0:
            raise AssertionError("trace ended before its prefixes cached")
    owners = {k: [r.rid for r in fleet._replicas.values()
                  if r.engine.enable_prefix_cache
                  and r.engine.cache.warm_prefix_tokens(w) == len(w)]
              for k, w in wait.items()}
    later = [fleet.add_request(p, n) for p, n in trace["later"]]
    routes = [fleet._requests[i]["replica"] for i in later]
    return ids + later, fleet.run(), owners, routes


def _per_replica_launches(ctx, fleet):
    """Count each replica's kernel launches: every replica engine's
    `step()` wrapped to read the wrappers' counts around it (the handoff's
    copies launch no kernel of ours). The wrappers go with `_unwrap`."""
    counts = {}
    for rep in fleet._replicas.values():
        eng = rep.engine
        got = counts.setdefault(f"{rep.role}_{rep.rid}", {})

        def counted(_step=eng.step, _got=got):
            before = [w.launches for w in ctx["wrappers"]]
            out = _step()
            for w, b in zip(ctx["wrappers"], before):
                if w.launches > b:
                    _got[w.__name__] = _got.get(w.__name__, 0) \
                        + w.launches - b
            return out
        eng.step = counted
    return counts


def _checked_transfer(torch, fleet_mod, device="cuda"):
    """Wrap the fleet's block export and ingest. At export each payload is
    held bitwise against its source rows, and a snapshot of those rows is
    kept apart from the payload, keyed by the payload's identity. At ingest
    the destination rows (and int8 scale rows, every replica) are held
    bitwise against that snapshot, not against the payload as it is then:
    a payload that shares storage with its source block (a view) and sees
    the block reused before placement differs there. Each ingest also
    counts the source blocks whose rows changed between export and
    placement (the reuse the copy guards against; a count, not a gate).
    Both sums stay on the device (no host wait); `restore()` puts the
    originals back. Returns (counts, the differing elements, the source
    blocks rewritten before placement, restore)."""
    exp0 = fleet_mod.export_pool_block_shards
    ing0 = fleet_mod.ingest_pool_block_shards
    bad = torch.zeros((), dtype=torch.int64, device=device)
    reused = torch.zeros((), dtype=torch.int64, device=device)
    n = {"exported": 0, "ingested": 0}
    held = {}

    def bits(t):
        return t.view({torch.bfloat16: torch.int16,
                       torch.float32: torch.int32}.get(t.dtype, t.dtype))

    def differ(a, b):
        bad.add_((bits(a) != bits(b)).sum().to(bad.device))

    def export(kps, vps, src, scs=None):
        out = exp0(kps, vps, src, scs)
        srcs = [p for pools in (kps, vps) for p in pools]
        snap = [p[:, src].clone() for p in srcs]
        for p, r, c in zip(srcs, [r for rows in out[:2] for r in rows],
                           snap):
            differ(c, r)
        if scs is not None:
            snap.append(scs[0][:, src].clone())
            srcs.append(scs[0])
            differ(snap[-1], out[2])
        held[id(out[0])] = (out[0], srcs, src, snap)
        n["exported"] += 1
        return out

    def ingest(kps, vps, kbs, vbs, dst, scs=None, srow=None):
        ing0(kps, vps, kbs, vbs, dst, scs, srow)
        _, srcs, src, snap = held.pop(id(kbs))
        dsts = [p for pools in (kps, vps) for p in pools]
        for p, c in zip(dsts, snap):
            differ(p[:, dst], c)
        for sc in scs or ():
            differ(sc[:, dst], snap[-1])
        moved = torch.stack([(bits(p[:, src]) != bits(c)).any()
                             for p, c in zip(srcs, snap)]).any()
        reused.add_(moved.to(reused.device, torch.int64))
        n["ingested"] += 1

    def restore():
        fleet_mod.export_pool_block_shards = exp0
        fleet_mod.ingest_pool_block_shards = ing0
    fleet_mod.export_pool_block_shards = export
    fleet_mod.ingest_pool_block_shards = ingest
    return n, bad, reused, restore


FLEET_HANDOFF_STAGES = ("_export_handoff", "_flush_handoffs",
                        "_prestage_handoffs")


def _no_sync_in_handoff(torch, fleet):
    """Run the fleet's handoff stages (export, placement, prefetch) under
    `torch.cuda.set_sync_debug_mode("error")`: with async-core replicas
    they run while a dispatched step is in flight, and a host sync in any
    of them raises. Returns the count of wrapped calls; the wrappers go
    with `fleet.__dict__.pop` (they hold the fleet)."""
    calls = {"n": 0}
    for name in FLEET_HANDOFF_STAGES:
        def wrapped(*a, _fn=getattr(fleet, name), **kw):
            calls["n"] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        setattr(fleet, name, wrapped)
    return calls


def phase_fleet(torch, ctx, seed):
    """The serving fleet over GPT-1.3B bf16, every replica on this card:
    one and two mixed replicas against phase 5's tokens, and a
    disaggregated pair (1 prefill + 1 decode) against a colocated engine of
    the same configuration, at bf16 and int8 pools, chunked and bucketed,
    chunked with the async core, and chunked on a tight pool without the
    prefix cache (source blocks reused before their handoff is placed)."""
    import gc

    import paddle_tpu_torch.inference.fleet as fleet_mod
    from paddle_tpu_torch import GenerationEngine
    from paddle_tpu_torch.inference import ServingFleet
    from paddle_tpu_torch.observability import series_total

    model = _model(torch, torch.bfloat16, seed)
    V = model.config.vocab_size
    _, trace = _engine_trace(V, seed)
    reqs = trace["first"] + trace["later"]
    plain = _engine_tokens(torch, ctx, model, trace)
    bs = 16
    res = {"phase": "fleet", "card": nvidia_smi_line(),
           "config": "gpt_1p3b bf16, phase 5's trace, every replica 8 "
           "slots, block 16, on this card: 1 and 2 mixed replicas; a "
           "disaggregated pair (1 prefill + 1 decode) beside a colocated "
           "engine of the same configuration: bf16 and int8 pools, chunked "
           "and bucketed prefill, chunked with async_core=True (its "
           f"handoff stages {list(FLEET_HANDOFF_STAGES)} under "
           "set_sync_debug_mode('error')), chunked on 160 blocks "
           "without the prefix cache (source blocks reused before "
           "placement)",
           "runs": {}}
    ok = True

    def fleet_run(name, **kw):
        """One fleet over the trace: tokens, counts, gates at drain, and
        the fleet's memory back at once after `del`."""
        path = f"fleet_{name}_bf16"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        fleet = ServingFleet(model, num_slots=8, block_size=bs, **kw)
        engines = {f"{r.role}_{r.rid}": r.engine
                   for r in fleet._replicas.values()}
        per_rep = _per_replica_launches(ctx, fleet)
        unsynced = _no_sync_in_handoff(torch, fleet) \
            if kw.get("async_core") else None
        n, bad, reused, restore = _checked_transfer(torch, fleet_mod)
        try:
            t0 = time.perf_counter()
            ids, out, owners, routes = _counted(
                torch, ctx, path, lambda: _serve_fleet(fleet, trace))
            wall = time.perf_counter() - t0
        finally:
            restore()
        snap = fleet.metrics_snapshot()
        new = sum(len(out[i]) - len(p) for i, (p, _) in zip(ids, reqs))
        r = {"wall_s": wall, "tokens_generated": new,
             "tokens_per_s": new / wall,
             "outputs_ok": _outputs_ok(ids, out, reqs, V),
             "tokens": [out[i] for i in ids],
             "handoffs": series_total(snap, "fleet_handoffs_total"),
             "handoff_blocks": series_total(snap,
                                            "fleet_handoff_blocks_total"),
             "handoff_stalls": series_total(snap,
                                            "fleet_handoff_stalls_total"),
             "affinity_hit_tokens": series_total(
                 snap, "fleet_affinity_hit_tokens_total"),
             "routed": {f"{s['labels']['replica']}:{s['labels']['reason']}":
                        s["value"]
                        for s in snap["fleet_routed_total"]["series"]},
             "owners_before_later": owners, "later_routes": routes,
             "blocks_exported": n["exported"],
             "blocks_ingested": n["ingested"],
             "replicas": {k: {"tokens_generated": e.tokens_generated,
                              "prefill_chunks": e.prefill_chunks,
                              "decode_steps": e.decode_steps,
                              "admissions": e.admissions,
                              "launches": per_rep[k]}
                          for k, e in engines.items()},
             "kernel_counts": ctx["paths"][path]}
        fleet.drain()
        r["differing_transfer_elements"] = int(bad)
        r["source_blocks_rewritten_before_placement"] = int(reused)
        del bad, reused
        r["leak_check"] = {k: e.cache.leak_check() for k, e in
                           engines.items()}
        r["parked_handoffs"] = sum(len(e._handoffs)
                                   for e in engines.values()) \
            + len(fleet._pending_handoffs)
        for e in engines.values():
            _unwrap(e)
        for stage in FLEET_HANDOFF_STAGES:
            fleet.__dict__.pop(stage, None)
        gc.disable()
        try:
            del fleet, engines, e
            after = torch.cuda.memory_allocated()
            r["memory_bytes_before_after"] = [base, after]
            r["memory_back_at_once"] = after <= base
        finally:
            gc.enable()
        torch.cuda.empty_cache()
        if unsynced is not None:
            r["handoff_stage_calls_without_sync"] = unsynced["n"]
        r["gates"] = g = {"outputs_ok": r["outputs_ok"],
                          "no_leak": not any(r["leak_check"].values()),
                          "no_parked_handoff": r["parked_handoffs"] == 0,
                          "memory_back_at_once": r["memory_back_at_once"],
                          "transfer_bitwise":
                              r["differing_transfer_elements"] == 0}
        res["runs"][name] = r
        return r, g

    # one mixed replica: bitwise phase 5; two: each request phase 5's, the
    # later shared-prefix and repeat requests on the replica owning them
    r1, g1 = fleet_run("mixed1", num_replicas=1)
    g1["tokens_bitwise_phase5"] = r1.pop("tokens") == plain
    r2, g2 = fleet_run("mixed2", num_replicas=2)
    g2["tokens_equal_phase5"] = r2.pop("tokens") == plain
    g2["shared_to_warm"] = (r2["later_routes"][0] in
                            r2["owners_before_later"]["shared"])
    g2["repeat_to_warm"] = (r2["later_routes"][1] in
                            r2["owners_before_later"]["repeat"])
    g2["affinity_hit_tokens"] = r2["affinity_hit_tokens"] > 0
    g2["both_replicas_served"] = all(
        v["tokens_generated"] > 0 for v in r2["replicas"].values())
    for g in (g1, g2):
        ok &= all(g.values())

    coloc = {}
    legs = sum(n > 1 for _, n in reqs)          # no eos: every max_new > 1
    blocks = sum(-(-len(p) // bs) for p, _ in reqs)
    for name, (kw, ks) in FLEET_DISAGG.items():
        base_kw = {k: v for k, v in kw.items() if k != "async_core"}
        key = tuple(sorted(base_kw.items()))
        if key not in coloc:
            cpath = f"fleet_colocated_{name}_bf16"
            eng = GenerationEngine(model, num_slots=8, block_size=bs,
                                   **base_kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, out = _counted(torch, ctx, cpath,
                                lambda: _serve_trace(eng, trace))
            wall = time.perf_counter() - t0
            coloc[key] = [out[i] for i in ids]
            res["runs"][f"colocated_{name}"] = {
                "wall_s": wall, "tokens_generated": eng.tokens_generated,
                "tokens_per_s": eng.tokens_generated / wall,
                "outputs_ok": _outputs_ok(ids, out, reqs, V),
                "kernel_counts": ctx["paths"][cpath]}
            ok &= res["runs"][f"colocated_{name}"]["outputs_ok"]
            del eng
            torch.cuda.empty_cache()
        r, g = fleet_run(f"disagg_{name}", num_replicas=1,
                         num_prefill_replicas=1, **kw)
        g["tokens_equal_colocated"] = r.pop("tokens") == coloc[key]
        g["handoffs_are_decode_legs"] = r["handoffs"] == legs
        g["handoff_blocks"] = r["handoff_blocks"] == blocks \
            == r["blocks_exported"] == r["blocks_ingested"]
        pre = r["replicas"]["prefill_1"]
        dec = r["replicas"]["decode_0"]
        g["prefill_one_token_a_request"] = pre["tokens_generated"] \
            == len(reqs)
        g["decode_no_prefill_chunk"] = dec["prefill_chunks"] == 0
        g["decode_no_prefill_kernel"] = FWD not in dec["launches"]
        g["replica_kernels_launched"] = all(
            k == FWD and pre["launches"].get(FWD, 0) > 0
            or k != FWD and dec["launches"].get(k, 0) > 0 for k in ks)
        if not kw.get("enable_prefix_cache", True):
            g["source_reused_before_placement"] = \
                r["source_blocks_rewritten_before_placement"] > 0
        if "handoff_stage_calls_without_sync" in r:
            g["handoff_without_host_sync"] = \
                r["handoff_stage_calls_without_sync"] > 0
        ok &= all(g.values())
    res["tokens_per_s"] = {n: r["tokens_per_s"]
                           for n, r in res["runs"].items()}
    res["ok"] = bool(ok)
    emit(res)
    del model
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("fleet phase failed its checks")


def phase_train_telemetry(torch, ctx, seed):
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.observability import (MetricsRegistry,
                                                TrainingTelemetry)

    cfg = _bench_config()
    batch, seq, steps, K = 2, 2048, 3, 4
    rng = np.random.RandomState(seed + 70)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (steps + K, batch, seq))
                           .astype(np.int64)).cuda()

    def train(tel):
        g = torch.Generator("cuda").manual_seed(seed)
        model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                               generator=g).train()
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        plain = TrainStep(model, opt, model.loss_fn, telemetry=tel)
        merged = TrainStep(model, opt, model.loss_fn, accumulate_steps=K,
                           scaler=GradScaler(init_loss_scaling=2.0 ** 15),
                           telemetry=tel)
        losses = [plain(x, x) for x in ids[:steps]]
        losses += [merged(x, x) for x in ids[steps:]]
        peak = torch.cuda.max_memory_allocated()
        params = [p.detach().clone() for p in model.parameters()]
        del plain, merged, opt, model
        return torch.stack(losses), params, peak

    off_losses, off_params, _ = _counted(
        torch, ctx, "train_telemetry_off_bf16", lambda: train(None))
    torch.cuda.empty_cache()
    reg = MetricsRegistry()
    tel = TrainingTelemetry(registry=reg, tokens_per_step=batch * seq,
                            memory_every=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, params, peak = _counted(torch, ctx, "train_telemetry_bf16",
                                    lambda: train(tel))
    wall = time.perf_counter() - t0
    snap = reg.snapshot()
    gauge_peak = _one(snap, "train_device_memory_bytes", kind="peak")
    res = {"phase": "train_telemetry", "card": nvidia_smi_line(),
           "config": "bench.py gpt_1p3b train (bf16, AdamW(1e-4), batch 2, "
           f"seq 2048): {steps} steps, then one accumulate_steps={K} window "
           "with GradScaler(2**15), TrainingTelemetry(tokens_per_step=B*S, "
           "memory_every=1); the same steps without telemetry first",
           "wall_s": wall,
           "losses": [float(x) for x in losses],
           "losses_bitwise": bool(torch.equal(losses, off_losses)),
           "params_bitwise": all(torch.equal(p, q)
                                 for p, q in zip(params, off_params)),
           "train_steps_total": _one(snap, "train_steps_total"),
           "step_seconds": {"count": _one(snap, "train_step_seconds"),
                            "sum": _series(snap, "train_step_seconds")[0][
                                "sum"]},
           "tokens_per_second_last": _one(snap, "train_tokens_per_second"),
           "loss_gauge": _one(snap, "train_loss"),
           "peak_gauge_bytes": gauge_peak,
           "max_memory_allocated_bytes": peak,
           "kernel_counts": ctx["paths"]["train_telemetry_bf16"]}
    res["ok"] = bool(res["losses_bitwise"] and res["params_bitwise"]
                     and res["train_steps_total"] == steps + 1
                     and res["step_seconds"]["count"] == steps + 1
                     and gauge_peak == peak
                     and all(math.isfinite(x) for x in res["losses"]))
    emit(res)
    del params, off_params
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError("train_telemetry phase failed its checks")


def _paddle_op_run(paddle, fn, case, args, place):
    """The op on `place` (also the selected place, for the ops that make
    tensors from shapes): its outputs and, for a differentiable case, the
    gradient of its outputs weighted by seeded cotangents."""
    paddle.set_device(place)
    leaves = []

    def build(a):
        kind, v = a
        if kind == "py":
            return v
        if kind == "L":
            return [build(x) for x in v]
        diff = case.grad and v.dtype == np.float32
        t = paddle.to_tensor(np.array(v), stop_gradient=not diff,
                             place=place)
        if diff:
            leaves.append(t)
        return t

    built = [build(a) for a in args]
    if case.rand:
        paddle.seed(7)
    out = fn(*built, **case.kw)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    grads = []
    if case.grad:
        rng = np.random.RandomState(11)
        loss = None
        for o in outs:
            if o.stop_gradient:
                continue
            cot = paddle.to_tensor(np.asarray(rng.randn(*o.shape),
                                              np.float32), place=place)
            term = paddle.sum(paddle.multiply(o, cot))
            loss = term if loss is None else paddle.add(loss, term)
        loss.backward()
        grads = [t.grad for t in leaves]
    return outs, grads


def phase_paddle_api(torch, ctx, seed):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    from paddle_op_cases import (PADDLE_OP_CASES, PADDLE_OP_MODULES,
                                 decomposition_error, paddle_op_args)

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import GPTConfig
    from paddle_tpu_torch.models.gpt import GPTMLP
    from paddle_tpu_torch.ops import threefry

    cfg = GPTConfig.gpt_1p3b()
    H, I, B, S = cfg.hidden_size, cfg.intermediate_size, 4, 512
    eps = cfg.layer_norm_epsilon
    res = {"phase": "paddle_api", "card": nvidia_smi_line(),
           "shape": f"LayerNorm and MLP of GPT-1.3B, hidden {H}, ffn {I}, "
                    f"{B} x {S} tokens, f32, TF32 off"}
    ok = True
    paddle.set_device("gpu")
    g = torch.Generator("cuda").manual_seed(seed + 81)
    mlp = GPTMLP(cfg, device="cuda", dtype=torch.float32)
    ln = torch.nn.LayerNorm(H, eps=eps, device="cuda")
    with torch.no_grad():
        for p in (*mlp.parameters(), *ln.parameters()):
            p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                    * (0.02 if p.dim() == 2 else 0.5))
    x_np = torch.randn((B, S, H), generator=g, device="cuda")
    cot = torch.randn((B, S, H), generator=g, device="cuda")

    # the paddle API: Parameters from the same weights, paddle ops only
    w1 = paddle.Parameter(mlp.fc1.weight.detach().t().contiguous())
    b1 = paddle.Parameter(mlp.fc1.bias.detach().clone())
    w2 = paddle.Parameter(mlp.fc2.weight.detach().t().contiguous())
    b2 = paddle.Parameter(mlp.fc2.bias.detach().clone())
    gam = paddle.Parameter(ln.weight.detach().clone())
    bet = paddle.Parameter(ln.bias.detach().clone())
    params = [w1, b1, w2, b2, gam, bet]

    def paddle_block(x):
        mu = paddle.mean(x, axis=-1, keepdim=True)
        var = paddle.var(x, axis=-1, unbiased=False, keepdim=True)
        xn = paddle.multiply(paddle.subtract(x, mu),
                             paddle.rsqrt(paddle.add(var, eps)))
        h = paddle.add(paddle.multiply(xn, gam), bet)
        a = paddle.gelu(paddle.add(h @ w1, b1), approximate=True)
        return paddle.add(a @ w2, b2)

    xp = paddle.to_tensor(x_np, stop_gradient=False)
    yp = paddle_block(xp)
    xr = x_np.clone().requires_grad_(True)
    yr = mlp(ln(xr))
    res["forward_rel_err"] = _rel(yp.detach(), yr.detach())
    res["on_card"] = yp.device.type == "cuda" and all(
        p.device.type == "cuda" for p in params)
    gp = paddle.grad(paddle.sum(paddle.multiply(yp, cot)), [xp, *params])
    gr = torch.autograd.grad((yr * cot).sum(),
                             [xr, mlp.fc1.weight, mlp.fc1.bias,
                              mlp.fc2.weight, mlp.fc2.bias, ln.weight,
                              ln.bias])
    gr = [gr[0], gr[1].t(), gr[2], gr[3].t(), gr[4], gr[5], gr[6]]
    res["grad_rel_err"] = max(_rel(a.detach(), b) for a, b in zip(gp, gr))
    ok &= (res["forward_rel_err"] <= TOL["float32"]
           and res["grad_rel_err"] <= TOL["float32"] and res["on_card"])

    # one PyLayer: tanh GELU with its derivative written out
    class GeluTanh(paddle.PyLayer):
        @staticmethod
        def forward(pctx, z):
            pctx.save_for_backward(z)
            return paddle.gelu(z, approximate=True)

        @staticmethod
        def backward(pctx, dy):
            (z,) = pctx.saved_tensor()
            c = math.sqrt(2.0 / math.pi)
            u = paddle.multiply(c, paddle.add(z, paddle.multiply(
                0.044715, paddle.pow(z, 3.0))))
            t = paddle.tanh(u)
            du = paddle.multiply(c, paddle.add(1.0, paddle.multiply(
                3 * 0.044715, paddle.square(z))))
            d = paddle.add(paddle.multiply(0.5, paddle.add(1.0, t)),
                           paddle.multiply(paddle.multiply(0.5, z),
                                           paddle.multiply(
                                               paddle.subtract(
                                                   1.0, paddle.square(t)),
                                               du)))
            return paddle.multiply(dy, d)

    z = paddle.to_tensor(x_np[0, :64] * 2, stop_gradient=False)
    (gl,) = paddle.grad(paddle.sum(paddle.multiply(GeluTanh.apply(z),
                                                   cot[0, :64])), [z])
    zr = (x_np[0, :64] * 2).requires_grad_(True)
    (gref,) = torch.autograd.grad(
        (torch.nn.functional.gelu(zr, approximate="tanh")
         * cot[0, :64]).sum(), [zr])
    res["pylayer_grad_rel_err"] = _rel(gl.detach(), gref)
    ok &= res["pylayer_grad_rel_err"] <= TOL["float32"]

    # time: the MLP block's forward and backward, paddle ops and modules
    def step_paddle():
        y = paddle_block(xp)
        paddle.grad(paddle.sum(paddle.multiply(y, cot)), [xp, *params])

    def step_modules():
        y = mlp(ln(xr))
        torch.autograd.grad((y * cot).sum(), [xr, *mlp.parameters(),
                                              *ln.parameters()])

    res["block_fwd_bwd_ms"] = cuda_ms(torch, step_paddle, 10)
    res["block_fwd_bwd_modules_ms"] = cuda_ms(torch, step_modules, 10)

    # the subclass's host time an op: 2,000 adds enqueued, no sync
    a_p, b_p = paddle.to_tensor(x_np[0, 0]), paddle.to_tensor(x_np[0, 1])
    a_t, b_t = x_np[0, 0].clone(), x_np[0, 1].clone()

    def host_us(fn, n=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    res["host_us_per_op"] = {
        "Tensor + Tensor": host_us(lambda: a_p + b_p),
        "torch.Tensor + torch.Tensor": host_us(lambda: a_t + b_t),
        "paddle.add (Tensor)": host_us(lambda: paddle.add(a_p, b_p)),
        "torch.add (plain)": host_us(lambda: torch.add(a_t, b_t))}
    res["subclass_host_us_over_plain"] = (
        res["host_us_per_op"]["Tensor + Tensor"]
        - res["host_us_per_op"]["torch.Tensor + torch.Tensor"])

    # every op of the six modules on the card against the CPU
    mods = {m: getattr(paddle.ops, m) for m in PADDLE_OP_MODULES}
    names = sorted({n for m in mods.values() for n in m.__all__})
    failed, off_card, errors, t0 = [], [], {}, time.perf_counter()
    for name in names:
        mod = next(m for m in mods.values() if name in m.__all__)
        fn, case = getattr(mod, name), PADDLE_OP_CASES[name]
        args = paddle_op_args(name)
        try:
            couts, cgrads = _paddle_op_run(paddle, fn, case, args, "gpu")
            houts, hgrads = _paddle_op_run(paddle, fn, case, args, "cpu")
        except Exception as e:       # recorded as a failure of the op
            errors[name] = f"{type(e).__name__}: {e}"[:300]
            failed.append(name)
            continue
        if case.check == "decomp":
            # vectors' signs are the solver's choice: reconstruction,
            # orthogonality and the unique values
            cnp = [c.detach().cpu().numpy() for c in couts]
            hnp = [h.detach().numpy() for h in houts]
            uniq = {"svd": 1, "eigh": 0}.get(name)
            if (decomposition_error(name, cnp, args[0][1]) >= 1e-5
                    or any(c.device.type != "cuda" for c in couts)
                    or (uniq is not None and not np.allclose(
                        cnp[uniq], hnp[uniq], rtol=1e-5, atol=1e-5))):
                failed.append(name)
            continue
        pairs = list(zip(couts, houts)) + list(zip(cgrads, hgrads))
        if len(couts) != len(houts) or len(cgrads) != len(hgrads):
            failed.append(name)
            continue
        for k, (c, h) in enumerate(pairs):
            if not isinstance(c, torch.Tensor):
                if bool(c) != bool(h):
                    failed.append(name)
                continue
            if c.device.type != "cuda":
                off_card.append(name)
            c = c.detach().cpu()
            h = h.detach()
            if c.dtype != h.dtype or c.shape != h.shape:
                failed.append(name)
            elif case.check == "shape":
                continue
            elif not (c.dtype.is_floating_point or c.dtype.is_complex):
                if not torch.equal(c, h):
                    failed.append(name)
            else:
                scale = h[torch.isfinite(h)].abs().max().item() if \
                    torch.isfinite(h).any() else 1.0
                tol = 1e-6 if case.rand and k < len(couts) else max(
                    case.tol, 1e-5) * max(scale, 1e-30)
                if not torch.allclose(c, h, rtol=0, atol=tol,
                                      equal_nan=True):
                    failed.append(name)
    # the seeded bits on the card: jax's partitionable layout
    key = (12345, 678)
    res["bits_bitwise_cpu"] = torch.equal(
        threefry.bits(key, (1 << 20,), 32, "cuda").cpu(),
        threefry.bits(key, (1 << 20,), 32, "cpu"))
    paddle.set_device("gpu")
    res.update(ops_run=len(names), ops_failed=sorted(set(failed)),
               ops_errors=errors, ops_off_card=sorted(set(off_card)),
               ops_seconds=time.perf_counter() - t0)
    ok &= not failed and not off_card and res["bits_bitwise_cpu"]
    res["ok"] = bool(ok)
    emit(res)
    paddle.set_device("cpu")
    del mlp, ln, params, gp, gr
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("paddle_api phase failed its checks")


# the paddle program on the card (phase paddle_program), each bar stated
# before its first run: every f32 gradient within 1e-4 of the largest
# magnitude of GPTForCausalLM's (the program's GEMMs take the [in, out]
# weights, the module's [out, in]: cuBLAS may pick other kernels, so the
# sums round in other orders); the O1 bf16 loss within 2e-2 of the f32
# loss (about 0.2 % of ln 50304)
PROGRAM_GRAD_TOL = 1e-4
PROGRAM_BF16_LOSS_TOL = 2e-2


def _host_us(torch, fn, n=2000, reps=3):
    """Host microseconds a call of `fn` enqueued with no sync: the median
    and the spread (min, max) of `reps` runs of `n` calls."""
    runs = []
    for _ in range(reps):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return {"us": float(np.median(runs)), "min": min(runs), "max": max(runs)}


def phase_paddle_program(torch, ctx, seed):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import tempfile

    import paddle_gpt_program as prog

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import GPTConfig, GPTForCausalLM, paddle_tpu_state
    from paddle_tpu_torch.core import dtype as pdtypes
    from paddle_tpu_torch.models.convert import _linear_weights
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops import dispatch

    F = paddle.nn.functional
    cfg = GPTConfig.gpt_1p3b()
    L, heads, B, S = cfg.num_layers, cfg.num_heads, 4, 1024
    res = {"phase": "paddle_program", "card": nvidia_smi_line(),
           "shape": f"GPT-1.3B in the paddle API: {L} layers, hidden "
                    f"{cfg.hidden_size}, {heads} heads, ffn "
                    f"{cfg.intermediate_size}, vocab {cfg.vocab_size}, "
                    f"{B} x {S} tokens; f32 TF32 off, and auto_cast O1 "
                    "bf16"}
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    ok = True
    paddle.set_device("gpu")
    g = torch.Generator("cuda").manual_seed(seed + 91)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           generator=g)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device="cuda")
    state = paddle_tpu_state(model)
    params = {k: paddle.to_tensor(v, stop_gradient=False)
              for k, v in state.items()}
    del state
    pids, plabels = paddle.to_tensor(ids), paddle.to_tensor(labels)

    def program():
        return prog.gpt_loss(paddle, params, pids, plabels, heads)

    def clear():
        for p in params.values():
            p.clear_grad()

    # (a) f32: the module's loss and grads, then the program's
    model.zero_grad(set_to_none=True)
    ref_loss = model(ids, labels=labels)
    ref_loss.backward()
    linear = _linear_weights(model)
    named = dict(model.named_parameters())
    dispatch.OpStats.enabled, dispatch.OpStats.counts = True, {}
    torch.cuda.reset_peak_memory_stats()

    def run_f32():
        loss = program()
        loss.backward()
        return loss

    loss32 = _counted(torch, ctx, "paddle_program_f32", run_f32,
                      exact={FWD: L, BWD: L})
    dispatch.OpStats.enabled = False
    res["f32_counts_ok"] = dispatch.OpStats.counts == prog.expected_counts(L)
    res["f32_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["f32_loss"] = loss32.item()
    res["f32_module_loss"] = ref_loss.item()
    res["f32_loss_rel_err"] = abs(res["f32_loss"] - res["f32_module_loss"]) \
        / abs(res["f32_module_loss"])
    worst, worst_name = 0.0, None
    for k, p in params.items():
        gref = named[k].grad
        gref = gref.t() if k in linear else gref
        e = _rel(p.grad.detach(), gref)
        if e > worst:
            worst, worst_name = e, k
    res.update(f32_grad_rel_err=worst, f32_grad_worst=worst_name,
               f32_grad_tol=PROGRAM_GRAD_TOL)
    ok &= (res["f32_counts_ok"] and res["f32_loss_rel_err"] <= 1e-5
           and worst <= PROGRAM_GRAD_TOL)
    model.zero_grad(set_to_none=True)
    clear()

    # (b) auto_cast O1 bf16: counts, dtypes, finite grads, the loss
    seen = {}
    finish = dispatch._finish

    def logged(name, out, inputs, paddle_out):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        seen.setdefault(name, set()).update(
            pdtypes.canonical_name(o.dtype) for o in outs)
        return finish(name, out, inputs, paddle_out)

    def run_bf16():
        with paddle.amp.auto_cast(dtype="bfloat16"):
            loss = program()
        loss.backward()
        return loss

    dispatch._finish = logged
    dispatch.OpStats.enabled, dispatch.OpStats.counts = True, {}
    torch.cuda.reset_peak_memory_stats()
    try:
        loss16 = _counted(torch, ctx, "paddle_program_bf16", run_bf16,
                          exact={FWD: L, BWD: L})
    finally:
        dispatch._finish = finish
        dispatch.OpStats.enabled = False
    res["bf16_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["bf16_counts_ok"] = dispatch.OpStats.counts == prog.expected_counts(
        L, o1=True)
    res["bf16_dtypes"] = {k: sorted(v) for k, v in seen.items()}
    res["bf16_loss"] = loss16.item()
    res["bf16_loss_minus_f32"] = res["bf16_loss"] - res["f32_loss"]
    res["bf16_grads_finite"] = all(
        bool(torch.isfinite(p.grad).all()) for p in params.values())
    ok &= (res["bf16_counts_ok"] and seen.get("linear") == {"bfloat16"}
           and seen.get("flash_attention") == {"bfloat16"}
           and seen.get("layer_norm") == {"float32"}
           and seen.get("softmax_ce") == {"float32"}
           and str(loss16.dtype) == "torch.float32"
           and res["bf16_grads_finite"]
           and abs(res["bf16_loss_minus_f32"]) <= PROGRAM_BF16_LOSS_TOL)
    clear()

    # (c) times, peak memory and host costs, not gated
    def step_module():
        model.zero_grad(set_to_none=True)
        model(ids, labels=labels).backward()

    def step_program():
        clear()
        program().backward()

    def step_program_bf16():
        clear()
        with paddle.amp.auto_cast(dtype="bfloat16"):
            loss = program()
        loss.backward()

    res["fwd_bwd_ms"] = {
        "program_f32": cuda_ms(torch, step_program, 3, warmup=1),
        "module_f32": cuda_ms(torch, step_module, 3, warmup=1),
        "program_bf16_o1": cuda_ms(torch, step_program_bf16, 3, warmup=1)}
    model.zero_grad(set_to_none=True)
    model.to(torch.bfloat16)
    res["fwd_bwd_ms"]["module_bf16"] = cuda_ms(torch, step_module, 3,
                                               warmup=1)
    del model, named
    clear()
    torch.cuda.empty_cache()
    xa = paddle.to_tensor(torch.randn(2048, device="cuda", generator=g))
    xb = paddle.to_tensor(torch.randn(2048, device="cuda", generator=g))
    xl = paddle.to_tensor(torch.randn(4, 2048, device="cuda", generator=g))
    wl = paddle.to_tensor(torch.randn(2048, 2048, device="cuda",
                                      generator=g) * 0.02)
    bl = paddle.to_tensor(torch.randn(2048, device="cuda", generator=g))
    pa, pb = xa.as_subclass(torch.Tensor), xb.as_subclass(torch.Tensor)
    host = {"paddle.add": lambda: paddle.add(xa, xb),
            "Tensor + Tensor": lambda: xa + xb,
            "F.linear": lambda: F.linear(xl, wl, bl),
            "torch.add (plain)": lambda: torch.add(pa, pb)}
    res["host_us"] = {k: _host_us(torch, fn) for k, fn in host.items()}

    # (d) FLAGS_check_nan_inf: an inf in layer 5's fc1 weight
    counter = get_registry().counter(
        "nan_inf_events_total",
        "NaN/Inf detections (FLAGS_check_nan_inf); each event may cover "
        "several tensors of one op/step.")
    before = counter.value
    w = params["gpt.blocks.5.mlp.fc1.weight"]
    with torch.no_grad():
        keep = w[0, 0].item()
        w.as_subclass(torch.Tensor)[0, 0] = float("inf")
    paddle.set_flags({"FLAGS_check_nan_inf": 1})
    try:
        with paddle.no_grad():
            program()
        res["nan_inf_error"] = None
    except FloatingPointError as e:
        res["nan_inf_error"] = str(e)
    finally:
        paddle.set_flags({"FLAGS_check_nan_inf": 0})
        with torch.no_grad():
            w.as_subclass(torch.Tensor)[0, 0] = keep
    res["nan_inf_events_total"] = counter.value
    ok &= (res["nan_inf_error"] is not None
           and "op 'linear'" in res["nan_inf_error"]
           and counter.value - before == 1)
    res["host_us_flag_off"] = {k: _host_us(torch, host[k])
                               for k in ("paddle.add", "F.linear")}

    # (e) one layer's bf16 state through paddle.save / paddle.load
    layer0 = {k: paddle.cast(p.detach(), "bfloat16")
              for k, p in params.items() if k.startswith("gpt.blocks.0.")}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "layer0.pdparams")
        paddle.save(layer0, path)
        back = paddle.load(path)
    res["save_load_bf16_bitwise"] = set(back) == set(layer0) and all(
        back[k].dtype == torch.bfloat16 and torch.equal(
            back[k].cpu().view(torch.int16),
            layer0[k].cpu().view(torch.int16)) for k in layer0)
    ok &= res["save_load_bf16_bitwise"]

    # linear's rounding in bf16 on the card: addmm against fp32 products
    # plus the bias rounded once; and the split-K reduction setting
    xb16 = paddle.cast(paddle.to_tensor(torch.randn(
        4096, 2048, device="cuda", generator=g)), "bfloat16")
    wb16 = paddle.cast(params["gpt.blocks.0.mlp.fc1.weight"].detach(),
                       "bfloat16")
    bb16 = paddle.cast(params["gpt.blocks.0.mlp.fc1.bias"].detach(),
                       "bfloat16")
    got = F.linear(xb16, wb16, bb16).as_subclass(torch.Tensor)
    once = (xb16.as_subclass(torch.Tensor).float()
            @ wb16.as_subclass(torch.Tensor).float()
            + bb16.as_subclass(torch.Tensor).float()).to(torch.bfloat16)
    res["linear_bf16_equal_share"] = (got == once).float().mean().item()
    a16, w16 = xb16.as_subclass(torch.Tensor), wb16.as_subclass(torch.Tensor)
    off = a16 @ w16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    on = a16 @ w16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced
    res["bf16_reduced_reduction_equal_share"] = (off == on).float().mean() \
        .item()
    res["ok"] = bool(ok)
    emit(res)
    del params, layer0, back
    paddle.set_device("cpu")
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("paddle_program phase failed its checks")


LAYER_GRAD_TOL = PROGRAM_GRAD_TOL   # the bar phase paddle_program holds


def _layer_table(torch, paddle, plc, seed):
    """Each case of tools/paddle_layer_cases.py built on the card, copied
    to the CPU (`Layer.to`), run on both from that one state: the worst
    error of each case against its tolerance, and the card's ms of the
    card-sized RNNs' forward and backward."""
    import copy

    table, worst_ok, rnn_ms = {}, True, {}
    cases = dict(plc.LAYER_CASES, **plc.CARD_CASES)
    for name, case in cases.items():
        paddle.set_device("gpu")
        gl = plc.build_case(paddle, case, seed)
        cl = copy.deepcopy(gl).to(device="cpu")
        got = plc.numpy_result(plc.run_case(paddle, name, case, gl, seed))
        if name in plc.CARD_CASES:
            def run(gl=gl, name=name, case=case):
                gl.clear_gradients()
                plc.run_case(paddle, name, case, gl, seed)
            rnn_ms[name] = cuda_ms(torch, run, 2, warmup=0)
        paddle.set_device("cpu")
        want = plc.numpy_result(plc.run_case(paddle, name, case, cl, seed))
        err = plc.max_err(got, want)
        table[name] = err
        worst_ok &= err <= case.tol
        del gl, cl
    paddle.set_device("gpu")
    torch.cuda.empty_cache()
    return table, bool(worst_ok), rnn_ms


def phase_paddle_layers(torch, ctx, seed):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import paddle_gpt_layers as pgl
    import paddle_layer_cases as plc

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import GPTConfig, GPTForCausalLM, paddle_tpu_state
    from paddle_tpu_torch.models.convert import _linear_weights

    cfg = GPTConfig.gpt_1p3b()
    L, heads, B, S = cfg.num_layers, cfg.num_heads, 4, 1024
    res = {"phase": "paddle_layers", "card": nvidia_smi_line(),
           "shape": f"GPT-1.3B as nn layers: {L} layers, hidden "
                    f"{cfg.hidden_size}, {heads} heads, ffn "
                    f"{cfg.intermediate_size}, vocab {cfg.vocab_size}, "
                    f"{B} x {S} tokens; f32 TF32 off, then one bf16 AdamW "
                    "step"}
    ok = True

    # (a) the README's flow: a Sequential MLP with Adam, ten eager steps
    paddle.set_device("gpu")
    card = pgl.user_flow(paddle)
    paddle.set_device("cpu")
    host = pgl.user_flow(paddle)
    res["flow_losses"] = card
    res["flow_max_abs_err"] = float(np.abs(np.subtract(card, host)).max())
    ok &= card[-1] < card[0] and res["flow_max_abs_err"] <= 1e-5

    # (b) GPT-1.3B from nn layers on the seeded module's weights
    paddle.set_device("gpu")
    g = torch.Generator("cuda").manual_seed(seed + 91)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           generator=g)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device="cuda")
    paddle.seed(seed)
    t0 = time.perf_counter()
    net = pgl.gpt_layers(paddle, cfg.vocab_size, cfg.hidden_size, L, heads,
                         cfg.max_seq_len, cfg.intermediate_size,
                         cfg.layer_norm_epsilon)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    state = paddle_tpu_state(model)
    missing, unexpected = net.set_state_dict(state)
    del state
    res["state_missing_unexpected"] = [missing, unexpected]
    ok &= not missing and not unexpected
    pids, plabels = paddle.to_tensor(ids), paddle.to_tensor(labels)
    model.zero_grad(set_to_none=True)
    ref_loss = model(ids, labels=labels)
    ref_loss.backward()
    linear = _linear_weights(model)
    named = dict(model.named_parameters())

    def run_f32():
        loss = net(pids, plabels)
        loss.backward()
        return loss

    loss32 = _counted(torch, ctx, "paddle_layers_f32", run_f32,
                      exact={FWD: L, BWD: L})
    res["f32_loss"] = loss32.item()
    res["f32_module_loss"] = ref_loss.item()
    res["f32_loss_rel_err"] = abs(res["f32_loss"] - res["f32_module_loss"]) \
        / abs(res["f32_module_loss"])
    worst, worst_name = 0.0, None
    for k, p in net.named_parameters():
        gref = named[k].grad
        gref = gref.t() if k in linear else gref
        e = _rel(p.grad.detach(), gref)
        if e > worst:
            worst, worst_name = e, k
    res.update(f32_grad_rel_err=worst, f32_grad_worst=worst_name,
               f32_grad_tol=LAYER_GRAD_TOL)
    ok &= res["f32_loss_rel_err"] <= 1e-5 and worst <= LAYER_GRAD_TOL

    def step_module():
        model.zero_grad(set_to_none=True)
        model(ids, labels=labels).backward()

    def step_layers():
        net.clear_gradients()
        net(pids, plabels).backward()

    res["fwd_bwd_ms"] = {
        "layers_f32": cuda_ms(torch, step_layers, 2, warmup=0),
        "module_f32": cuda_ms(torch, step_module, 2, warmup=0)}
    del model, named, ref_loss, loss32
    net.clear_gradients()
    torch.cuda.empty_cache()

    # one eager AdamW step over the Layer at bf16
    net.astype("bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=net.parameters())

    def step_bf16():
        loss = net(pids, plabels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    paddle.device.reset_peak_memory_stats()
    loss16 = _counted(torch, ctx, "paddle_layers_bf16", step_bf16,
                      exact={FWD: L, BWD: L})
    res["bf16_loss"] = loss16.item()
    res["bf16_peak_gb"] = paddle.device.max_memory_allocated() / 1e9
    res["bf16_peak_torch_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["bf16_step_ms"] = cuda_ms(torch, step_bf16, 2, warmup=0)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_bf16()
        torch.cuda.synchronize()
    res["bf16_step_profile"] = _device_breakdown(prof, "paddle_layers_bf16")
    ok &= (math.isfinite(res["bf16_loss"])
           and res["bf16_peak_gb"] == res["bf16_peak_torch_gb"])
    del net, opt, loss16
    torch.cuda.empty_cache()

    # (c) the layer table, card against CPU from one state
    t0 = time.perf_counter()
    table, table_ok, rnn_ms = _layer_table(torch, paddle, plc, seed)
    res.update(layer_max_err=table, layer_table_ok=table_ok,
               layer_table_s=time.perf_counter() - t0,
               rnn_card_fwd_bwd_ms=rnn_ms)
    ok &= table_ok

    # (d) the device package: the caching allocator's counters
    paddle.set_device("gpu")
    paddle.device.synchronize()
    stats = paddle.device.memory_stats()
    res["memory_source"] = stats["source"]
    res["memory_allocated_equal"] = \
        paddle.device.memory_allocated() == torch.cuda.memory_allocated()
    paddle.device.reset_peak_memory_stats()
    before = paddle.device.memory_allocated()
    block = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    paddle.device.synchronize()
    res["peak_after_256mib"] = paddle.device.max_memory_allocated() - before
    res["peak_equal"] = (paddle.device.max_memory_allocated()
                         == torch.cuda.max_memory_allocated())
    del block
    ok &= (stats["source"] == "cuda_caching_allocator"
           and res["memory_allocated_equal"] and res["peak_equal"]
           and res["peak_after_256mib"] >= 256 << 20)
    res["ok"] = bool(ok)
    emit(res)
    paddle.set_device("cpu")
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("paddle_layers phase failed its checks")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="profile the engine runs (phases engine, "
                    "engine_spec, engine_int8, engine_sampled, "
                    "engine_wint8, engine_bucketed, engine_lora, "
                    "engine_tp) after "
                    "their prefixes are "
                    "cached, one GPT train step, one BERT train step, one "
                    "ResNet-50 forward and one ResNet-50 train step on "
                    "each route, one Transformer forward and one "
                    "Transformer train step (phases train, bert_train, "
                    "resnet_infer, resnet_train, transformer_infer, "
                    "transformer_train), with torch.profiler and "
                    "print their device-time breakdowns (slows those "
                    "runs; their tokens/s is then not comparable)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in PHASES]
    if bad:
        ap.error(f"unknown phases {bad}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside the repository)
    from paddle_tpu_torch.ops.conv import (conv1x1_bn_relu, conv1x1_bwd,
                                           conv1x1_train, conv3x3_bn_relu,
                                           conv3x3_dw, conv3x3_train)
    from paddle_tpu_torch.ops.flash_attention import (
        causal_attention_bwd, causal_attention_fwd, sdpa_backward,
        sdpa_forward, shortseq_attention_bwd, shortseq_attention_fwd)
    from paddle_tpu_torch.ops.grad_merge import (grad_finish, grad_merge,
                                                 grad_unscale)
    from paddle_tpu_torch.ops.int8_linear import int8_linear
    from paddle_tpu_torch.ops.lora import batched_lora
    from paddle_tpu_torch.ops.sampling import sample_draw, verify_draws
    from paddle_tpu_torch.ops.optimizer_update import (optimizer_norms,
                                                       optimizer_update)
    from paddle_tpu_torch.ops.paged_decode import (
        paged_decode_attention, paged_decode_attention_int8)
    from paddle_tpu_torch.ops.paged_verify import (
        paged_verify_attention, paged_verify_attention_int8)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = {"profile": args.profile, "paths": {},
           "wrappers": (paged_decode_attention, causal_attention_fwd,
                        causal_attention_bwd, paged_verify_attention,
                        paged_decode_attention_int8,
                        paged_verify_attention_int8, shortseq_attention_fwd,
                        shortseq_attention_bwd, conv1x1_bn_relu,
                        conv3x3_bn_relu, conv1x1_train, conv3x3_train,
                        conv1x1_bwd, conv3x3_dw, sdpa_forward,
                        sdpa_backward, optimizer_update, optimizer_norms,
                        grad_merge, grad_finish, grad_unscale, sample_draw,
                        verify_draws, int8_linear, batched_lora)}
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        try:
            if name == "build":
                phase_build(torch, ctx)
            elif name == "paged_decode":
                phase_paged_decode(torch, ctx)
            elif name == "causal_fwd":
                phase_causal_fwd(torch, ctx)
            elif name == "causal_bwd":
                phase_causal_bwd(torch, ctx)
            elif name == "engine":
                phase_engine(torch, ctx, SEED)
            elif name == "generate_parity":
                phase_generate_parity(torch, ctx, SEED)
            elif name == "train":
                phase_train(torch, ctx, SEED)
            elif name == "train_parity":
                phase_train_parity(torch, ctx, SEED)
            elif name == "paged_verify":
                phase_paged_verify(torch, ctx)
            elif name == "paged_int8":
                phase_paged_int8(torch, ctx)
            elif name == "engine_spec":
                phase_engine_spec(torch, ctx, SEED)
            elif name == "spec_parity":
                phase_spec_parity(torch, ctx, SEED)
            elif name == "engine_int8":
                phase_engine_int8(torch, ctx, SEED)
            elif name == "shortseq_fwd":
                phase_shortseq_fwd(torch, ctx)
            elif name == "shortseq_bwd":
                phase_shortseq_bwd(torch, ctx)
            elif name == "bert_train":
                phase_bert_train(torch, ctx, SEED)
            elif name == "bert_parity":
                phase_bert_parity(torch, ctx, SEED)
            elif name == "conv_fwd":
                phase_conv_fwd(torch, ctx)
            elif name == "resnet_infer":
                phase_resnet_infer(torch, ctx, SEED)
            elif name == "resnet_parity":
                phase_resnet_parity(torch, ctx, SEED)
            elif name == "conv_train":
                phase_conv_train(torch, ctx)
            elif name == "resnet_train":
                phase_resnet_train(torch, ctx, SEED)
            elif name == "resnet_train_parity":
                phase_resnet_train_parity(torch, ctx, SEED)
            elif name == "sdpa_fwd":
                phase_sdpa_fwd(torch, ctx)
            elif name == "transformer_infer":
                phase_transformer_infer(torch, ctx, SEED)
            elif name == "transformer_parity":
                phase_transformer_parity(torch, ctx, SEED)
            elif name == "sdpa_bwd":
                phase_sdpa_bwd(torch, ctx)
            elif name == "optimizer_update":
                phase_optimizer_update(torch, ctx, SEED)
            elif name == "transformer_train":
                phase_transformer_train(torch, ctx, SEED)
            elif name == "transformer_train_parity":
                phase_transformer_train_parity(torch, ctx, SEED)
            elif name == "train_accum":
                phase_train_accum(torch, ctx, SEED)
            elif name == "train_accum_parity":
                phase_train_accum_parity(torch, ctx, SEED)
            elif name == "bert_lamb":
                phase_bert_lamb(torch, ctx, SEED)
            elif name == "sampling":
                phase_sampling(torch, ctx)
            elif name == "int8_linear":
                phase_int8_linear(torch, ctx)
            elif name == "engine_sampled":
                phase_engine_sampled(torch, ctx, SEED)
            elif name == "engine_wint8":
                phase_engine_wint8(torch, ctx, SEED)
            elif name == "lora":
                phase_lora(torch, ctx)
            elif name == "engine_bucketed":
                phase_engine_bucketed(torch, ctx, SEED)
            elif name == "engine_lora":
                phase_engine_lora(torch, ctx, SEED)
            elif name == "tp_parity":
                phase_tp_parity(torch, ctx, SEED)
            elif name == "engine_tp":
                phase_engine_tp(torch, ctx, SEED)
            elif name == "engine_async":
                phase_engine_async(torch, ctx, SEED)
            elif name == "engine_observed":
                phase_engine_observed(torch, ctx, SEED)
            elif name == "fleet":
                phase_fleet(torch, ctx, SEED)
            elif name == "train_telemetry":
                phase_train_telemetry(torch, ctx, SEED)
            elif name == "paddle_api":
                phase_paddle_api(torch, ctx, SEED)
            elif name == "paddle_program":
                phase_paddle_program(torch, ctx, SEED)
            else:
                phase_paddle_layers(torch, ctx, SEED)
        except Exception as e:  # noqa: BLE001 — report, go on, exit 1
            traceback.print_exc()
            emit({"phase": name, "ok": False,
                  "error": f"{type(e).__name__}: {e}"})
            failed.append(name)
            if name == "build":
                break
        print(f"# phase {name}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    kernels = []
    for key, name, src, replaces in (
            ("paged_decode", "paged_decode_attention",
             "paddle_tpu_torch/csrc/paged_decode.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:64"),
            ("causal_fwd", FWD,
             "paddle_tpu_torch/csrc/causal_attention.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:428"),
            ("causal_bwd", BWD,
             "paddle_tpu_torch/csrc/causal_attention_bwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:452"),
            ("paged_verify", VER, "paddle_tpu_torch/csrc/paged_verify.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:350"),
            ("paged_decode_int8", DEC8,
             "paddle_tpu_torch/csrc/paged_decode.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:163"),
            ("paged_verify_int8", VER8,
             "paddle_tpu_torch/csrc/paged_verify.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:464"),
            ("shortseq_fwd", SSF,
             "paddle_tpu_torch/csrc/shortseq_attention.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:243"),
            ("shortseq_fwd_masked", SSFM,
             "paddle_tpu_torch/csrc/shortseq_attention.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:249"),
            ("shortseq_bwd", SSB,
             "paddle_tpu_torch/csrc/shortseq_attention_bwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:255"),
            ("shortseq_bwd_masked", SSBM,
             "paddle_tpu_torch/csrc/shortseq_attention_bwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:262"),
            ("conv1x1", C1, "paddle_tpu_torch/csrc/conv_bn_relu.cu",
             "paddle_tpu/ops/pallas/conv.py:317"),
            ("conv3x3", C3, "paddle_tpu_torch/csrc/conv_bn_relu.cu",
             "paddle_tpu/ops/pallas/conv.py:395"),
            ("conv1x1_train", C9A, "paddle_tpu_torch/csrc/conv_bn_relu.cu",
             "paddle_tpu/ops/pallas/conv.py:536"),
            ("conv3x3_train", C9B, "paddle_tpu_torch/csrc/conv_bn_relu.cu",
             "paddle_tpu/ops/pallas/conv.py:592"),
            ("conv1x1_bwd", C10, "paddle_tpu_torch/csrc/conv_bn_relu_bwd.cu",
             "paddle_tpu/ops/pallas/conv.py:691"),
            ("conv3x3_dw", C11, "paddle_tpu_torch/csrc/conv_bn_relu_bwd.cu",
             "paddle_tpu/ops/pallas/conv.py:767"),
            ("sdpa_fwd", SDPA, "paddle_tpu_torch/csrc/sdpa_forward.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:64"),
            # no Pallas counterpart: jax's library flash backward, called
            # at this line on a TPU, and XLA's fused update_all
            ("sdpa_bwd", SBWD, "paddle_tpu_torch/csrc/sdpa_backward.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:712"),
            ("optimizer_update", OPT,
             "paddle_tpu_torch/csrc/optimizer_update.cu",
             "paddle_tpu/optimizer/optimizer.py:71"),
            # no Pallas counterpart either: Lars' and Lamb's norms
            # (optimizers.py:258 and :298, the pass on the main path is
            # Lamb's), and gradient merge's elementwise work, which XLA
            # fuses into the compiled steps
            (NORMS, NORMS, "paddle_tpu_torch/csrc/optimizer_update.cu",
             "paddle_tpu/optimizer/optimizers.py:298"),
            (MERGE, MERGE, "paddle_tpu_torch/csrc/grad_merge.cu",
             "paddle_tpu/jit/api.py:634"),
            (FINISH, FINISH, "paddle_tpu_torch/csrc/grad_merge.cu",
             "paddle_tpu/jit/api.py:625"),
            (UNSCALE, UNSCALE, "paddle_tpu_torch/csrc/grad_merge.cu",
             "paddle_tpu/jit/api.py:528"),
            # no Pallas counterpart: the draws and the int8 weights'
            # dequantize that XLA fuses into the JAX engine's steps
            (DRAW, DRAW, "paddle_tpu_torch/csrc/sampling.cu",
             "paddle_tpu/ops/sampling.py:107"),
            (VDRAW, VDRAW, "paddle_tpu_torch/csrc/sampling.cu",
             "paddle_tpu/ops/sampling.py:143"),
            (UNIF, UNIF, "paddle_tpu_torch/csrc/sampling.cu",
             "paddle_tpu/ops/sampling.py:119"),
            (W8, W8, "paddle_tpu_torch/csrc/int8_linear.cu",
             "paddle_tpu/inference/engine.py:1296"),
            # no Pallas counterpart: the per-slot LoRA delta XLA fuses
            # into the JAX engine's steps
            ("lora", LORA, "paddle_tpu_torch/csrc/lora.cu",
             "paddle_tpu/ops/lora.py:54")):
        m = ctx.get(key, {})
        # launches: the first run of the main path that must take this
        # kernel (serving before training, bf16 before f32); every run's
        # count beside it
        # the coin has no launch of its own: it counts the fused launch
        # that computes it
        counted = VDRAW if name == UNIF else name
        own = [p for p, ks in PATH_KERNEL.items()
               if counted in ks and p in ctx["paths"]]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": (ctx["paths"][own[0]][counted]["launches"] if own
                         else None),
            "launched_as": counted,
            "launches_in": own[0] if own else None,
            "launches_by_run": {p: c[counted]["launches"]
                                for p, c in ctx["paths"].items()},
            "max_abs_err": m.get("max_abs_err"), "ms": m.get("kernel_ms"),
            "plain_ms": m.get("plain_ms"), "bound_ms": m.get("bound_ms"),
            "bound_by": m.get("bound_by"),
            "library_ms": m.get("library_ms"), "shape": m.get("shape"),
            "dtype": m.get("dtype"),
            "design": DESIGN.get(key, "fp32 FMA"),
            **{k: m[k] for k in ("marginal_ms", "marginal_bound_ms")
               if k in m}})
    if failed:
        print(f"chip_smoke: failed: {failed}", file=sys.stderr)
        return 1
    print(ctx.get("smi") or nvidia_smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
