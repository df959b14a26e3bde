"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line; each
phase's seconds are printed after it):
  1. the card's name and power limit (nvidia-smi);
  2. build the kernels from src/repro_torch/kernels/csrc (ptxas's
     registers, static shared memory and spills for each kernel) and hold
     each attention kernel against its plain PyTorch version on the same
     CUDA tensors, in bf16 and f32, at the main path's shapes and flash at
     hymba-1.5b's prefill shape (25 q / 5 kv heads, 1280 tokens, window
     1024); the decode kernels (1 and 2) at DECODE_SHAPES (llama3.2-1b at
     tp=1 and its tp=8 fold, hymba-1.5b past its window, qwen3-moe-30b-a3b
     at hd 128), the paged kernel on the dense cache scattered over a
     shuffled block pool bitwise equal to the dense one, second calls
     bitwise equal; time kernel, plain version and the library yardstick
     (scaled_dot_product_attention, with the rows' windowed mask, timed
     here only); then the same check over the CPU tests' shape sweep, with
     the paged kernel's trash isolation, the decode kernel's blindness past
     pos and the split plan's edges (split boundaries, pos = -1 -> zeros,
     windows starting mid-split, blocks that do not divide the split);
     then 200 back-to-back calls of each decode kernel on fresh inputs,
     each checked;
  3. the recursive-doubling all-reduce kernel against its plain version,
     bitwise, under each of its two protocols forced in turn (LL packets;
     pieces and flags), in bf16 and f32, over pods {2, 4, 8} x fast
     {1, 2}, per-rank messages of 16 KB to 8 MB and 1 or 4 chunks, and on
     unaligned rows (the scalar paths); then 1000 back-to-back calls on
     fresh inputs whose size crosses the protocols' threshold, each
     checked; one call captured in a CUDA graph and replayed 200 times on
     fresh inputs copied into its operand, each replay checked (the epoch
     lives in device memory); kernel (the size's protocol, and both
     forced), plain version and the library yardstick (a sum over the
     stacked ranks) timed per size, beside the times of the kernel
     before its LL redesign (RD_PARENT_MS);
  4. llama3.2-1b at full width and depth, bf16, seeded weights: batched
     generation (batch 8, prompt 512, 64 new tokens, s_max 1024) dense and
     paged (block 16) through the kernels, with launch counts checked and
     paged tokens equal to dense tokens, and one profiled dense run of
     each form (eager, and the decode steps replayed from a CUDA graph).
     On every path a phase drives through ``run_path`` (phases 4, 6, 9,
     12, 13, 16, 17, 20, 21, 24, 25) the exact launch counts are the eager
     form's (``cuda_graph=False``); then the graph form (one eager step,
     one captured, replays after) must give the eager tokens bitwise, its
     launches counted at the capture times the steps they stand for plus
     the prefill's must equal the eager counts, and both forms' decode
     tok/s are printed (the eager form's counted run, the graph form's
     median of 3);
  5. the same seeded weights at full width, 2 layers, float32: the card
     (kernels) against the CPU (plain versions): prefill logits allclose,
     greedy tokens equal wherever the CPU's top-1/top-2 gap is clear;
  6. phase 4 tensor-parallel on a virtual mesh of 4 pods x 2 ranks (tp=8)
     on the one card, under hier_rd and under flat: exact launch counts,
     tokens equal to flat's and to phase 4's tp=1 tokens wherever the
     reference's top-1/top-2 gap is clear, teacher-forced logits within
     (TF_MAX, TF_MEAN) of both, which two planted faults in the
     all-reduce must break, one profiled hier_rd run of each form with the
     RD kernel's share of device time;
  7. phase 5 at tp=8 (hier_rd): card against CPU;
  8. the fused GEMM + recursive-doubling kernel against its plain version
     in bf16 and f32 on 4 x 2 and 2 x 1 meshes at the path's decode
     shapes (attention wo, MLP down), its prefill shape and two ragged
     row counts (12: the bf16 decode form's two n8 blocks; 100): within TOL,
     bitwise equal across n_chunks 1/2/4/8, every rank of a fast column
     bitwise equal, every output element written (the allocator's free
     block poisoned first); 1000 back-to-back calls on fresh inputs with
     alternating chunk counts, each checked; one call captured in a CUDA
     graph and replayed 200 times on fresh inputs, each replay bitwise a
     direct call and within TOL of the plain version (the flag value lives
     in device memory); kernel, plain version and the
     library yardstick (one bmm over the fast columns with the pods folded
     into K) timed at all three path shapes, with the kernel's time
     without the exchange (pods = 1) beside it;
  9. phase 6 under the paper's deployment, ``auto`` + overlapped
     projections: exact launch counts derived from the autotuner's picks,
     tokens margin-gated against phase 6's flat and phase 4's tp=1, the
     decode path's teacher-forced logits within (TF_MAX, TF_MEAN) of flat's
     and tp=1's, which two planted faults in the fused path (the slow
     exchange dropped; the fast sum dropped) must break, one profiled run
     with the fused kernel's share of device time, the host cost of the
     per-call ``auto`` resolution; then ``hier_rd`` + overlap once, so the
     fused kernel runs at the prefill size too, gated the same way; then a
     graph captured at prompt 512 and a generate at prompt 768, whose
     prefill grows kernel 5's buffers the graph holds: the step captured
     anew exactly once, its tokens bitwise the eager form's;
 10. phase 5 at tp=8 under ``auto`` + overlap: card against CPU;
 11. the group-quantized pack and unpack kernels (kernel 6) against their
     plain versions, bitwise (payload, scales, dequant), for bits 8/4 x
     group 1/2/64/128 x f32/bf16 inputs at the quantized path's shapes
     (decode RS 128 x 1024, RD 8 x 8192, AG 64 x 1024, prefill RS
     65536 x 1024); NaN/+-Inf poisoning group by group, unaligned row
     counts and starts, 1000 back-to-back calls on fresh inputs, each
     checked; kernel and plain version timed per shape (no single
     PyTorch call computes the function: no library yardstick); then the
     quantized recursive doubling in one launch (quant_rd_allreduce.cu)
     bitwise against the plain loop on the card (NaN where it has NaN)
     over pods 2/4 x fast 1/2, int8 and int4, the decode and prefill
     messages, ragged and bf16 rows, the fast axis, an unaligned start
     and NaN/+-Inf poisoning; 1000 back-to-back calls whose size and bits
     change and 200 replays of a captured call, each checked; the pack
     with its EF residue, the unpack-sum over the all-to-all's transpose
     and the unpack of the all-gather's broadcast into the gathered
     layout bitwise against their plain versions at the decode and
     prefill shapes; the quantized overlapped projection's y and EF
     bitwise across 1, 2 and 4 chunks (integer operands, whose GEMM is
     exact in any order; cuBLAS's random-normal gap printed); each timed
     beside the parent
     tree's composition (quant_rd_loop: per step a pack, two unpacks, two
     index_selects and an add), its plain version and its bound;
 12. phase 6 on the quantized wire, hier_rd + int8 and hier_rd + int4,
     error feedback on: exact launch counts derived from the dispatch (2
     packs, 2 unpacks and 1 quantized RD launch an all-reduce, no payload
     copy), one profiled int8 run with the quantized wire's share of
     device time, the decode path's teacher-forced logits within
     (QUANT_TF[bits]) of flat's and tp=1's decode paths, which two
     planted faults (unpack ignoring the scale; the quantized slow
     exchange skipped) must break, and the same gate without error
     feedback, printed only;
 13. the paper's deployment on the quantized wire, ``auto`` + ``auto``
     quantization + overlap: launch counts derived from the tuner's
     picks (kernel 6 in prefill at int4, kernel 5 in decode), tokens
     margin-gated against flat's and tp=1's;
 14. phase 5 at tp=8 under hier_rd + int8: card against CPU;
 15. the grouped expert FFN kernel (kernel 7; bf16 on the tensor cores
     with F split across CTAs, f32 on the CUDA cores) against its plain
     version within TOL, and bitwise equal to itself on a second call, in
     bf16 and f32, on the CPU tests' cases, a shape off its 16-byte path
     and the MoE path's three shapes (prefill dispatch, tp=1 and tp=8
     dense decode), the bf16 form also beside its plain split form; one
     shared token block bitwise equal to E copies of it at the decode
     shape; the f32 D-tiled two-launch form bitwise equal to its
     one-launch form at D 3072; dbrx-132b's expert widths (D 6144, F
     10752, 4 experts, C 8 and C 80, bf16 and f32) within TOL and bitwise
     equal to a second call; 1000 back-to-back calls on fresh inputs,
     each checked; kernel, plain version and a three-bmm chain
     (informative: no single PyTorch call computes the function) timed
     against the bound;
 16. qwen3-moe-30b-a3b at full width and 6 of its 48 layers
     (PATH_LAYERS, seeded bf16 weights): batch 8, prompt 128, 16 new tokens, dense and paged
     (block 16), exact launch counts (kernel 7 once a layer in prefill
     and once a layer a step), paged tokens == dense tokens, one profiled
     run with kernel 7's share of device time;
 17. the same model at 4 layers in float32 with capacity_factor E/K (no
     overflow at any tp): tp=8 (4 pods x 2, experts parallel over all 8
     ranks) under hier_rd and flat against tp=1: exact launch counts,
     tokens by provable_gate, the decode path's teacher-forced logits
     within (TF_MAX, TF_MEAN), which two planted faults in the MoE layer
     (every rank on rank 0's experts; the dispatch's all-to-all dropped)
     must break;
 18. phase 5 for qwen3-moe-30b-a3b (2 layers, f32) at tp=1 and at tp=8
     under hier_rd: card against CPU;
 19. the RWKV6 time-mix scan kernel (kernel 8) against its plain version
     (the step-exact recurrence) on the same CUDA tensors, f32, within
     RWKV_TOL: the CPU tests' shapes, constant log decays -1, -2, -5 (past
     the reference's chunk clamp), the path's prefill (B 8, T 512, H 64,
     hd 64), decode (T 1) and tp=8 fold (64 sequences, 8 bonus groups)
     shapes; two chained calls bitwise equal to one, the in-place
     (aliased) state update bitwise equal to a separate one; kernel,
     plain version (fewer calls: a T-step loop) and bound timed;
 20. rwkv6-7b at full width and 8 of its 32 layers (PATH_LAYERS;
     7.53 B parameters at full depth, seeded bf16): batch 8, prompt 512, 64 new tokens, exact launch counts
     (kernel 8 once a layer in prefill and once a layer a decode step),
     the decode path's teacher-forced logits against the full-sequence
     forward over the same tokens within RWKV_STEP_BF16 (the recurrence is
     step-exact in both; the GEMMs round at other places), which a planted
     fault (the decode state never advancing) must break, one profiled
     run (16 new tokens) with kernel 8's share of device time;
 21. the same model at 4 layers in float32: the tp=1 decode path against
     the full forward within RWKV_STEP_F32; tp=8 (4 pods x 2, 8 heads a
     rank) under hier_rd and flat against tp=1: exact launch counts of
     kernels 4 and 8, tokens by provable_gate, the decode path's
     teacher-forced logits within (TF_MAX, TF_MEAN), which two planted
     faults (every rank on rank 0's slice of the channel-mix receptance;
     the receptance half of the stacked partial left unreduced) must
     break;
 22. phase 5 for rwkv6-7b (2 layers, f32) at tp=1 and at tp=8 under
     hier_rd: card against CPU;
 23. the Mamba selective-scan kernel (kernel 9) against its plain version
     (the step-exact recurrence) on the same CUDA tensors, f32, within
     SSM_TOL: the JAX kernel test's shapes, the path's prefill (B 8,
     T 1280, Ci 3200, S 16), decode (T 1) and tp=8 fold (64 sequences,
     Ci 400, 8 A groups) shapes, decays that underflow (dt up to 5); two
     chained calls bitwise equal to one, the in-place (aliased) state
     update bitwise equal to a separate one; kernel, plain version (fewer
     calls: a T-step loop) and bound (the special-function units'
     exponentials or the bytes) timed;
 24. hymba-1.5b at full width and 8 of its 32 layers (PATH_LAYERS;
     1.80 B parameters at full depth, seeded bf16): batch 8, prompt 1280
     (past the 1024 window), 64 new tokens, dense and paged (block 16),
     exact launch counts (kernel 9 once a layer in prefill and once a
     layer a decode step; flash once a layer; decode and paged decode
     once a layer a step), paged tokens == dense tokens,
     one profiled run (16 new tokens) with kernel 9's share of device
     time, the decode path's teacher-forced logits against the full
     forward within HYB_STEP_BF16, which a planted fault (the mamba state
     never advancing past the prompt) must break;
 25. the same model at 4 layers in float32 with per-channel A_log
     planted: the tp=1 decode path against the full forward within
     HYB_STEP_F32; tp=8 (4 pods x 2; GQA slots with 7 dead q and 1 dead
     kv, d_inner 400 a rank) under hier_rd and flat against tp=1: exact
     launch counts of kernels 4 and 9, tokens by provable_gate, the decode
     path's teacher-forced logits within (TF_MAX, TF_MEAN), which two
     planted faults (every rank on rank 0's A group; the mamba partial
     left out of the mixed reduction) must break;
 26. phase 5 for hymba-1.5b (2 layers, f32) at tp=1 and at tp=8 under
     hier_rd: card against CPU (phases 20 and 24 also profile one
     generate of the graph form);
 27. the continuous batcher (ContinuousBatcher, full-prefill admission)
     serving llama3.2-1b at full width, 8 of its 16 layers (SERVE_LAYERS,
     as in phases 28-30), bf16, seeded: 8 slots of
     1024 positions, a make_trace trace of 32 requests (prompts ~256,
     outputs ~64 tokens, 0.5 arrivals a step); tp=1 dense and paged (block
     16) and tp=8 (4 x 2, hier_rd) paged, each a warm-up replay and one
     timed one (throughput, TTFT, TPOT); paged == dense and
     graph == eager (the serve step run eagerly) bitwise; each request
     against its own batch-1 generate and tp=8 against tp=1 by
     provable_gate over teacher-forced decode paths of the same row count;
     a pool of half the blocks the undisturbed run peaked at preempts and
     returns the undisturbed tokens; sampled serving (temperature 1, top
     50) equal under its seed, at tp=1 and tp=8 (three runs), and
     different under another; tp=8 dense == tp=8 paged bitwise; tp=8
     hier_rd + overlap paged, where admissions longer than any before grow
     kernel 5's buffers after the capture: captured anew at least once,
     tokens bitwise its eager steps'; and in f32 at 2 layers, tp=8 paged
     against tp=1 dense by provable_gate, which must check at least three
     quarters of the steps;
 28. kernel 3's chunk form (per-sequence query offsets over the decode
     cache) against its plain version within TOL and bitwise against the
     full form on the rows they share, C 5 / 64 / 128 x offsets 0 / 1 /
     63 / 448, dense rows and the paged table, bf16 and f32, two windowed
     cases, NaN past the chunk's last query never read; 200 replays of a
     captured call with fresh offsets, each bitwise a direct call; kernel,
     plain version and SDPA (over the keys that exist, the same boolean
     mask) timed at C 128, offset 384; then phase 27's trace admitted by
     chunks of 128 (ContinuousBatcher(admit_mode="chunked")): exact
     launches of the eager form (the chunk form once a layer a chunk, the
     full form never), tp=1 dense and paged (one timed replay), chunked dense
     == paged == eager bitwise, chunked against full admission by
     provable_gate (both teacher-forced, the chunked one through
     prefill_chunk) with the teacher-forced logits within (TF_MAX,
     TF_MEAN); speculative decoding (k = 4, greedy) with the replay drafter
     (phase 27's streams), the ngram drafter, the replay of the ngram
     run's streams and the draft model on the paged cache (graph and eager
     steps bitwise), each against plain decode by the same gate (the
     verify path teacher-forced k + 1 tokens at a time), all of them the
     same tokens, acceptance and steps; make_prefix_trace (256 shared
     tokens in 3/4 of 32 requests): the prefix cache on == off bitwise,
     both chunked, hits and tokens saved; tp=8 hier_rd paged chunked
     against tp=8 full admission by the same gate, the prefix trace at
     tp=8 with the cache on == off bitwise, and spec ngram with the cache
     on (graph == eager bitwise on the first 8 requests) against plain by
     the gate; TTFT and
     throughput beside phase 27's; in f32 at 2 layers, chunked and spec
     (replay) against plain at tp=1 (paged) and tp=8 (dense), each by
     provable_gate checking at least three quarters of the steps;
 29. (a) kernels 1, 2 and 3's chunk form with NaN planted in every K and V
     row past the visible range, bitwise the same call with zeros there
     (bf16 and f32, dense and paged, at phase 27's serve shapes); then on
     phase 27's trace, llama3.2-1b full width, SERVE_LAYERS, bf16, graphs
     on:
     (b) the batcher under injected faults (NaN poked into live K, OOM
     bursts, stragglers) and a TTFT deadline at tp=1 paged, and NaN at
     tp=8 paged: every survivor bitwise phase 27's tokens, one quarantine
     a poke, no NaN left in the cache, shed requests reported; (c)
     disaggregated serving through the checksummed KV handoff, both pools
     tp=1 (full admission) bitwise colocated paged, under dropped and
     corrupted handoffs every survivor bitwise with retries and
     re-prefills counted, and a tp=1 prefill pool in front of a tp=8
     (4x2 hier_rd) decode pool against colocated tp=8 by provable_gate
     with the teacher-forced logits within (TF_MAX, TF_MEAN), in bf16 and
     in f32 at 2 layers (floor three quarters); (d) two tp=1 replicas
     behind the router under round_robin bitwise two single replicas,
     least_queue and ttft_aware through the trace at 8x the rate, all
     bitwise phase 27's; each run's tokens/s, TTFT and TPOT p50, fault
     counters, handoff bytes and graph captures printed;
 30. (a) kernel 1's int8 form (int8 K/V and bf16 scales, the reference's
     attn_core dequantization) within TOL of its plain version at
     KV8_SHAPES (DECODE_SHAPES, g 1 at hd 128 and g 16 at hd 64; window
     0 and 1024; positions on the 128-key split edges), bf16 and f32, a
     second call bitwise; kernel, plain version, kernel 1's bf16 form on
     the dequantized cache and SDPA timed beside the bound; the W8 GEMM
     (w8_matmul: int8 weights dequantized in registers) within W8_TOL of
     its plain version at llama3.2-1b's decode leaves (wq / wk / wv / wo,
     wg / wu / wd) at tp=1 and the tp=8 fold, M 8 and 64, timed beside
     one bmm on the bf16 weight and the bound; (b) phase 27's trace
     through the batcher on the int8 cache, llama3.2-1b full width,
     SERVE_LAYERS, bf16, at tp=1 and tp=8 (4x2 hier_rd): graph == eager
     bitwise on its first 8 requests (eager launches counted), the int8
     path's teacher-forced logits on the bf16 cache's tokens with top-1
     agreement of at least TOP1_FLOOR (the reference's bar), the cache's
     bytes against the bf16 cache's; (c) llama3.2-1b full width,
     SERVE_LAYERS, with int8 block weights through
     build_decode_step(weight_quant=True) captured, tp=1 and tp=8: graph
     == eager tokens (w8_matmul 7 a layer a step), teacher-forced top-1
     agreement with the bf16 weights' run at least TOP1_FLOOR, decode
     tok/s beside the bf16 weights' (bf16, int8, int8, bf16), and at tp=1
     the first step's logits against the dequant_layer model's; (d)
     hymba-1.5b at full width, 8 layers (PATH_LAYERS), with the
     ring-buffer window cache, a 64-token prompt decoded 1100 steps past
     its 1024 window, against the full cache by provable_gate over
     teacher-forced logits, then in f32 at 2 layers where the gate must
     check three quarters of the steps.
 31. sequence-parallel prefill: llama3.2-1b at full width and depth,
     tp=8 (4x2), batch 8, prompt 512: the prefill forward under hier_rd
     with seq_parallel off / on / auto, hier_rd + int8 off / on and auto
     + overlap off / on (the collective matmul reduce-scatter), each's
     launches (kernels 4 and 6 a prefill) and median time, its logits
     against the same configuration with SP off within (TF_MAX, TF_MEAN)
     (QUANT_TF[8] on the int8 wire), bitwise equality printed; the
     engine's generate (run_path) and a batcher trace (phase 27's first 8
     requests, full admission, paged) under SP on against SP off (tokens
     bitwise where the prefill's logits are); qwen3-moe-30b-a3b at 4
     layers, f32, SP on against off within (TF_MAX, TF_MEAN) (the pod
     cut of the MoE dispatch);
 32. the other dense archs: kernels 1 / 2 (g 16 and g 12 at hd 128, the
     tp=8 fold and tp=1), 3 (the tp=8 fold's prefill), 4 (the 405B's
     decode message, 128 KB a rank = LL_MAX_BYTES) and 5 (the 405B's and
     qwen1.5-32b's MLP down at decode) against their plain versions,
     timed beside their library yardsticks and bounds; then Llama 3.1
     405B and 70B, mistral-large-123b and qwen1.5-32b at 2 layers and
     codeqwen1.5-7b whole, full width, bf16, seeded weights with nonzero
     QKV biases planted, batch 8, prompt 128, 16 new: run_path at tp=1
     and at tp=8 (4x2 hier_rd; exact launches, graph == eager), tp=8's
     tokens margin-gated against tp=1's and its teacher-forced logits
     within (TF_MAX, TF_MEAN); codeqwen1.5-7b card against CPU at 2
     layers in f32 with the biases planted;
 33. the encoder-decoder and VLM families: kernel 3 non-causal at
     whisper-medium's encoder (1500 frames over themselves) and its
     cross-attention prefill (64 queries over 1500 keys) and their tp=8
     folds, causal at pixtral-12b's prefill (32 / 8 heads of 128, 1088
     tokens); kernel 1 at whisper's cross-attention decode (g 1, 1500
     keys, every row at 1499) and its fold, kernels 1 / 2 at pixtral's
     decode; each against its plain version in bf16 and f32, a second
     call bitwise, timed beside SDPA and the bound; whisper-medium (24 +
     24 layers, batch 8, 1500 frames, prompt 64, 16 new) and pixtral-12b
     (1024 patches + 64 tokens; 16 of its 40 layers, MM_PATH_LAYERS) at
     full width, bf16, seeded:
     run_path at tp=1 dense and paged and at tp=8 (4x2 hier_rd), exact
     launches (kernel 3 E + 2L a prefill for whisper, L for pixtral;
     kernel 1 2L a step for whisper, the cross-attention's L when paged;
     kernel 4 once an all-reduce), graph == eager, paged == dense, a
     second batch of frames through the captured step with no capture
     anew; tp=8's tokens margin-gated against tp=1's and its
     teacher-forced logits within (TF_MAX, TF_MEAN); pixtral at 40 layers
     in f32 (tp=8 prefill logits within MM_F32_TOL of tp=1's); card
     against CPU at 2 layers in f32
     (whisper's encoder at 2 layers over all 1500 frames; pixtral with 32
     patches in a 64-token prompt).
 34. the paper's HP scheme (``parallel/pp.py``, GPipe PP x TP): kernel
     3 against its plain version at a block call's shape (8 ranks x 2
     sequences, 16 / 4 heads, 512 tokens), timed beside SDPA and the
     bound; llama3.2-1b at full width and depth, bf16, batch 8, prompt
     512, 4 stages of 4 layers with TP 2 in each (the 4 x 2 virtual mesh,
     the stage axis the slow one), M = 4 and M = 1 microbatches: exact
     kernel-3 launches, (L/P) x (M+P-1); every stage's logits bitwise
     equal; logits within (TF_MAX, TF_MEAN) of the tp=1 forward_lm's,
     which two planted faults (the shift sent to stage s - 1, the last
     stage collected one tick early) must break; the forward's time
     beside tp=1's and tp=8 hier_rd's (median of 3, synchronised); in f32
     at 4 layers (one a stage) within PP_F32_REL of tp=1, and the card
     against the CPU at batch 2, prompt 64, M = 2 within 1e-3; then the
     sustained bf16 rate of one (8, 4096, 4096)^2 bmm (the simulator's
     H100.efficiency), and the simulator's llama3.2-1b tp=1 decode step
     and prefill (batch 8, context 512) beside phase 4's graph-replayed
     decode step (device busy, torch.profiler) and its prefill, with the
     ratios (no gate: a model; every number finite and positive).
 35. training (ROADMAP item 11, part one; ``parallel/steps.py::
     build_train_step``): (a) llama3.2-1b at full width and depth, bf16,
     tp=1 under the reference's training ctx, 8 steps of 8 x 1024 tokens
     in 2 microbatches with remat, AdamW at 3e-4 after 2 warmup steps:
     exact kernel-3 launches (2 L a microbatch: forward and recompute),
     every loss finite, the last below the first, nothing skipped; step
     ms, tokens/s, the model-FLOP share of the bf16 peak (6 N tokens/s),
     peak memory, one profiled step's idle share; kernel 3 under autograd
     at the microbatch's shape: dq / dk / dv through its Function against
     autograd through the plain version in f32 (TRAIN_GRAD_TOL), the
     forward kernel and the plain backward timed in bf16 beside SDPA's
     backward and the bound; (b) card against CPU, f32, 2 layers, 3 steps:
     loss, grad norm, lr within TRAIN_CPU_TOL; (c) 4 layers on
     VirtualMesh(4, 1), data parallel: kernel 4 and the int8 pack / unpack
     at one gradient piece (GRAD_PIECE f32 a rank) bitwise their plain
     versions and timed beside their bounds; one batch's gradients reduced
     under rd (one kernel-4 launch a piece) within f32 rounding of flat's
     and under rd_int8 (a pack and an unpack a step a piece) within the
     reference's int8 bound, the pods' drift printed; 2 steps under each
     strategy with exact launches; (d) at 2 layers, 4 steps straight
     against 2 + checkpoint + restore (into other weights) + 2, losses
     within TRAIN_RESUME_TOL.
Then both forms' decode tok/s of every path, side by side.  The last two
lines are the kernels' JSON record and the result line.

    python3 chip_smoke.py --phases 1-3,34

runs the phases named and every phase whose results they read
(``PHASE_DEPS``: phase 34 reads phase 4's, so ``--phases 34`` runs 1, 2's
build, 4 and 34); the result line is the same, and the kernels' record
lists the kernels whose path and checks ran.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from typing import Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.llama3_paper import (  # noqa: E402
    LLAMA31_405B, LLAMA31_70B)
from repro_torch.core import (autotune, comm_model,  # noqa: E402
                              hierarchical, overlap)
from repro_torch.core.mesh import VirtualMesh, mesh_and_ctx  # noqa: E402
from repro_torch.core.pcontext import ParallelCtx  # noqa: E402
from repro_torch.inference import simulator as sim  # noqa: E402
from repro_torch.parallel import pp  # noqa: E402
from repro_torch.inference.engine import InferenceEngine  # noqa: E402
from repro_torch.inference.kv_cache import (  # noqa: E402
    bundle_states, states_bundle)
from repro_torch.inference.router import (  # noqa: E402
    Router, prefill_cost_model)
from repro_torch.inference.scheduler import (  # noqa: E402
    ContinuousBatcher, Request, make_prefix_trace, make_trace)
from repro_torch.inference.spec import ReplicaSpec, build_replica  # noqa
from repro_torch.inference.speculative import ReplayDrafter  # noqa: E402
from repro_torch.kernels import (_build, collective_matmul_rd,  # noqa: E402
                                 decode_attention, flash_attention,
                                 kernel_wrappers, moe_expert_ffn,
                                 paged_decode_attention, quant_pack,
                                 quant_rd_all_reduce, quantize_pack,
                                 rd_all_reduce, rwkv6_scan, ssm_scan,
                                 unpack_dequant)
from repro_torch.kernels.fused_matmul_rd import \
    collective_matmul_rd_ref  # noqa: E402
from repro_torch.kernels.rd_allreduce import (  # noqa: E402
    RDWorkspace, rd_all_reduce_ref)
from repro_torch.kernels.rd_allreduce import ops as rd_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ops import \
    SPLIT_KEYS  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref, visible_keys)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_chunk, flash_attention_chunk_ref)
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import (  # noqa: E402
    moe_expert_ffn_ref, moe_expert_ffn_split_ref)
from repro_torch.kernels.moe_gemm import ops as moe_gemm_ops  # noqa: E402
from repro_torch.kernels.quant_rd_allreduce.ref import (  # noqa: E402
    quant_rd_all_reduce_ref, xor_exchange)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_ref  # noqa: E402
from repro_torch.models import rwkv, ssm, transformer  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step, ef_sites_for, forward_lm, init_cache, init_params,
    make_plan, seed_cache)
from repro_torch.core.pcontext import LOCAL  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_int8_ref, dequant_kv)
from repro_torch.kernels.w8_matmul import (  # noqa: E402
    dequant_weight, w8_matmul, w8_matmul_ref)
from repro_torch.parallel.quant import (  # noqa: E402
    LayerMap, dequant_layer, quantize_model)
from repro_torch.parallel.sharding import shard_params  # noqa: E402
from repro_torch.models.common import place_heads  # noqa: E402
from repro_torch.parallel.steps import (  # noqa: E402
    CapturedStep, build_decode_step, build_prefill, build_train_step,
    load_train_state, train_state)
from repro_torch.core.pcontext import single_pod_ctx  # noqa: E402
from repro_torch.kernels.flash_attention.autograd import (  # noqa: E402
    FlashAttention, flash_attention_grad)
from repro_torch.models.transformer import (  # noqa: E402
    data_parallel, params_tree)
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.training.data import SyntheticLMData  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,    # tensor cores
              torch.float32: 67e12}      # CUDA cores, no TF32
TOL = {torch.bfloat16: 3e-2, torch.float32: 3e-5}   # as tests/test_kernels.py
SEED = 0
# Main path: llama3.2-1b, batch 8, prompt 512, 64 new tokens, s_max 1024.
B, HQ, HKV, HD = 8, 32, 8, 64
PROMPT, NEW, S_MAX, BLOCK = 512, 64, 1024, 16
# TP path: tp = 8 = 4 pods x 2 fast ranks.  The RD kernel's per-rank
# message after the fast reduce-scatter: B * d_model / 2 bf16 = 16 KB in
# decode, 8 MB in prefill; 128 KB - 2 MB is the paper's range.
PODS, FAST = 4, 2
D_MODEL, D_FF = 2048, 8192
# The fused kernel's (M, K) per rank on the path, N = d_model: attention
# wo and MLP down in decode (M = B), and MLP down in prefill (M = B * S).
FUSED_SHAPES = {"decode_wo": (B, HQ * HD // (PODS * FAST)),
                "decode_mlp": (B, D_FF // (PODS * FAST)),
                "prefill_mlp": (B * PROMPT, D_FF // (PODS * FAST))}
# Checked only: the bf16 decode form with two n8 blocks (M 9-16) and
# ragged row tiles of both forms.
FUSED_EXTRA = {"rows12": (12, 1024), "rows100": (100, 264)}
# Kernel 3's prefill shapes (B, Hq, Hkv, S, hd, window): llama3.2-1b's, and
# hymba-1.5b's (25 q / 5 kv heads, 1280 tokens past its 1024 window).
FLASH_SHAPES = {"llama_prefill": (B, HQ, HKV, PROMPT, HD, 0),
                "hymba_prefill": (B, 25, 5, 1280, 64, 1024)}
# Kernels 1 and 2 at the paths' decode shapes (B, Hq, Hkv, hd, S, window,
# positions lo..hi): llama3.2-1b at tp=1 (ragged rows); its tp=8 fold (8
# ranks x 8 sequences, 4 q / 1 kv head a rank); hymba-1.5b (25 / 5 heads,
# prompt 1280 + 64 past its 1024 window); qwen3-moe-30b-a3b (32 / 4 heads
# of 128, prompt 128 + 16).
DECODE_SHAPES = {
    "llama_tp1": (B, HQ, HKV, HD, S_MAX, 0, (0, S_MAX - 1)),
    "llama_tp8_fold": (B * PODS * FAST, HQ // (PODS * FAST),
                       HKV // (PODS * FAST), HD, S_MAX, 0, (0, S_MAX - 1)),
    "hymba": (B, 25, 5, 64, 1344, 1024, (1280, 1343)),
    "qwen3_moe": (B, 32, 4, 128, 144, 0, (128, 143))}
RD_SIZES = (16 * 2**10, 128 * 2**10, 512 * 2**10, 2 * 2**20, 8 * 2**20)
# The times at RD_SIZES (bf16, 4 x 2 ranks, time_ms) of the kernel before
# its LL redesign (pieces and flags alone, a host sequence number): the
# mean of its two runs in a chip_compare.py parent / change / change /
# parent call on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), printed
# beside this run's.
RD_PARENT_MS = (0.0124, 0.0134, 0.0204, 0.0596, 0.2478)
# bf16 greedy tokens of two reduction orders may differ where the top-1/
# top-2 logit gap is within a few bf16 roundings of O(1) logits.
BF16_GAP = 0.1
# The depth of the tp=1 paths of the families this script's later phases
# do not extend (phases 16, 20, 24), cut from full depth (48, 32, 32
# layers) so the whole script stays inside its time limit (to 12 / 8 / 16,
# then, for phase 33's time, qwen3-moe and hymba by half again); widths
# are full, and each phase's gates and planted faults are unchanged.
PATH_LAYERS = {"qwen3-moe-30b-a3b": 6, "rwkv6-7b": 8, "hymba-1.5b": 8}
# Teacher-forced bf16 logits of tp=8 hier_rd against flat and tp=1 over
# the same sequence: bf16 roundings of O(1) logits in another reduction
# order (max |diff|, mean |diff|).
TF_MAX, TF_MEAN = 0.5, 0.02

REPLACES = {
    "flash_attention":
        "src/repro/kernels/flash_attention/kernel.py:26",
    "flash_attention_chunk":
        "src/repro/kernels/flash_attention/kernel.py:26",
    "decode_attention":
        "src/repro/kernels/decode_attention/kernel.py:27",
    "paged_decode_attention":
        "src/repro/kernels/decode_attention/kernel.py:73",
    "rd_all_reduce": "src/repro/kernels/rd_allreduce/kernel.py:34",
    "collective_matmul_rd":
        "src/repro/kernels/rd_allreduce/fused_matmul.py:43",
    "quantize_pack": "src/repro/kernels/rd_allreduce/quant_kernel.py:29",
    "unpack_dequant": "src/repro/kernels/rd_allreduce/quant_kernel.py:45",
    "quant_rd_all_reduce":
        "src/repro/kernels/rd_allreduce/quant_kernel.py:29",
    "moe_expert_ffn": "src/repro/kernels/moe_gemm/kernel.py:25",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan/kernel.py:26",
    "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:26",
    # no Pallas kernel: the reference's jnp code they carry to the card
    "decode_attention_int8": "src/repro/models/layers.py:176",
    "w8_matmul": "src/repro/parallel/quant.py:51",
}
MAIN_PATH = {"flash_attention": "tp8_hier_rd",
             "flash_attention_chunk": "serve_chunked_tp1_paged",
             "decode_attention": "tp8_hier_rd",
             "paged_decode_attention": "tp1_paged",
             "rd_all_reduce": "tp8_hier_rd",
             "collective_matmul_rd": "tp8_auto_overlap",
             "quantize_pack": "tp8_hier_rd_int8",
             "unpack_dequant": "tp8_hier_rd_int8",
             "quant_rd_all_reduce": "tp8_hier_rd_int8",
             "moe_expert_ffn": "moe_tp1_dense",
             "rwkv6_scan": "rwkv_tp1",
             "ssm_scan": "hymba_tp1",
             "decode_attention_int8": f"serve_kv8_tp{PODS * FAST}",
             "w8_matmul": "w8_tp1"}
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_chunk":
        "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "paged_decode_attention":
        "src/repro_torch/kernels/csrc/decode_attention.cu",
    "rd_all_reduce": "src/repro_torch/kernels/csrc/rd_allreduce.cu",
    "collective_matmul_rd": "src/repro_torch/kernels/csrc/fused_matmul_rd.cu",
    "quantize_pack": "src/repro_torch/kernels/csrc/quant_pack.cu",
    "unpack_dequant": "src/repro_torch/kernels/csrc/quant_pack.cu",
    "quant_rd_all_reduce":
        "src/repro_torch/kernels/csrc/quant_rd_allreduce.cu",
    "moe_expert_ffn": "src/repro_torch/kernels/csrc/moe_gemm.cu",
    "rwkv6_scan": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
    "ssm_scan": "src/repro_torch/kernels/csrc/ssm_scan.cu",
    "decode_attention_int8":
        "src/repro_torch/kernels/csrc/decode_attention.cu",
    "w8_matmul": "src/repro_torch/kernels/csrc/w8_matmul.cu",
}
# Kernel 6 at the quantized path's shapes (rows, D) at tp=8 = 4 x 2,
# batch 8, prompt 512: the decode reduce-scatter packs B x d_model / 2
# pieces of every rank (R B 2 rows), the all-gather each rank's shard rows
# (R B rows); prefill packs R B S 2 rows.  The recursive doubling's
# message, each rank's whole shard (R rows of B d_model / 2), is packed
# inside quant_rd_allreduce.cu and stays here as a shape.
QP_SHAPES = {"decode_rs": (PODS * FAST * B * 2, D_MODEL // 2),
             "decode_rd": (PODS * FAST, B * D_MODEL // 2),
             "decode_ag": (PODS * FAST * B, D_MODEL // 2),
             "prefill_rs": (PODS * FAST * B * PROMPT * 2, D_MODEL // 2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, CUDA events around each call, the
    50 MB L2 flushed between calls (the model's layers find it cold).  A
    spin of about 0.1 ms after the flush keeps the device busy while the
    host enqueues the start event and the call, so the host's enqueue time
    does not show up as idle time between the events; the median drops
    the occasional 0.1-0.3 ms stall of one call (often the first)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)      # clock cycles, ~0.1 ms
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, out, ref, dtype) -> float:
    err = max_err(out, ref)
    tol = TOL[dtype]
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    log(f"  {name} [{str(dtype)[6:]}]: max|kernel-plain| = {err:.3e} "
        f"(atol=rtol={tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# Phase 2: attention kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_case(gen, dtype, shape) -> tuple:
    """Kernel 3 at one prefill shape (b, hq, hkv, s, hd, window), causal,
    q/k/v as the model holds them, (B, S, H, hd), passed as (B, H, S, hd)
    views: (max |kernel - plain|, (kernel, plain, SDPA) ms, bound)."""
    b, hq, hkv, s, hd, win = shape

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q = rnd(b, s, hq, hd).transpose(1, 2)
    k = rnd(b, s, hkv, hd).transpose(1, 2)
    v = rnd(b, s, hkv, hd).transpose(1, 2)
    out = flash_attention(q, k, v, causal=True, window=win)
    ref = flash_attention_ref(q, k, v, causal=True, window=win)
    torch.cuda.synchronize()
    err = check_close(f"flash_attention {shape}", out, ref, dtype)
    del out, ref
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    pos = torch.arange(s, device="cuda")
    mask = None if not win else ((pos[None, :] <= pos[:, None])
                                 & (pos[None, :] > pos[:, None] - win))
    t = (time_ms(lambda: flash_attention(q, k, v, causal=True, window=win)),
         time_ms(lambda: flash_attention_ref(q, k, v, causal=True,
                                             window=win)),
         time_ms(lambda: F.scaled_dot_product_attention(
             qc, kc, vc, is_causal=mask is None, attn_mask=mask,
             enable_gqa=True)))
    # (query, key) pairs the causal, windowed mask keeps
    pairs = sum(min(i + 1, win) if win else i + 1 for i in range(s))
    bnd = bound_ms(q.element_size() * b * hd * s * (2 * hq + 2 * hkv),
                   4.0 * b * hq * hd * pairs, dtype)
    return err, t, bnd


def scatter_blocks(gen, k: torch.Tensor, v: torch.Tensor, bs: int) -> tuple:
    """The dense cache k/v (B, S, Hkv, hd) scattered over a shuffled pool
    of B S / bs + 1 blocks: (block table, k pool, v pool).  Block 0, which
    no row maps, holds 999 / -999."""
    b, s = k.shape[:2]
    mb = s // bs
    if mb * bs != s:
        raise ValueError(f"cache length {s} is not whole blocks of {bs}")
    nb = b * mb + 1
    tbl = (1 + torch.randperm(nb - 1, generator=gen, device="cuda")
           ).to(torch.int32).reshape(b, mb)
    rows = tbl.long().flatten()
    pools = []
    for x, fill in ((k, 999.0), (v, -999.0)):
        pool = torch.full((nb, bs) + tuple(x.shape[2:]), fill,
                          dtype=x.dtype, device="cuda")
        pool[rows] = x.reshape(b * mb, bs, *x.shape[2:])
        pools.append(pool)
    return tbl, pools[0], pools[1]


def decode_case(gen, dtype, name: str, shapes: Optional[dict] = None,
                paged: bool = True) -> tuple:
    """Kernels 1 and 2 at one of DECODE_SHAPES: each within TOL of its
    plain version, the paged kernel on the dense cache scattered over a
    shuffled block pool bitwise equal to the dense one, a second call of
    each bitwise equal to the first; kernel, plain version and SDPA (with
    the row's mask, the window included) timed beside the bound.  Returns
    the dense and the paged kernel's records.  ``shapes``: where ``name``
    is looked up (default DECODE_SHAPES).  ``paged=False``: kernel 1 alone
    (a cache that is never paged, whose length need not be whole blocks);
    the paged record is None."""
    b, hq, hkv, hd, s, win, (lo, hi) = (shapes or DECODE_SHAPES)[name]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q = rnd(b, hq, hd)
    k, v = rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)
    pos = torch.randint(lo, hi + 1, (b,), generator=gen, device="cuda",
                        dtype=torch.int32)

    def dense():
        return decode_attention(q, k, v, pos, window=win)

    tag = f"{name} {tuple(q.shape)} S={s} window={win}"
    out = dense()
    torch.cuda.synchronize()
    err_d = check_close(f"decode_attention {tag}", out,
                        decode_attention_ref(q, k, v, pos, window=win), dtype)
    if paged:
        tbl, kp, vp = scatter_blocks(gen, k, v, BLOCK)

        def paged_call():
            return paged_decode_attention(q, kp, vp, tbl, pos, window=win)

        outp = paged_call()
        torch.cuda.synchronize()
        err_p = check_close(f"paged_decode_attention {tag}", outp,
                            paged_decode_attention_ref(q, kp, vp, tbl, pos,
                                                       window=win), dtype)
        if not torch.equal(outp, out):
            raise AssertionError(f"{tag}: paged kernel != dense kernel")
        if not torch.equal(paged_call(), outp):
            raise AssertionError(f"{tag}: a second call differs from the "
                                 "first")
    if not torch.equal(dense(), out):
        raise AssertionError(f"{tag}: a second call differs from the first")
    kpos, last = torch.arange(s, device="cuda")[None, :], pos.long()[:, None]
    mask = (kpos <= last) & (kpos > last - win) if win else kpos <= last
    amask = mask[:, None, None, :]
    qs, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    t_sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kt, vt, attn_mask=amask, enable_gqa=True))
    t_d = (time_ms(dense),
           time_ms(lambda: decode_attention_ref(q, k, v, pos, window=win)))
    n_keys = int(mask.sum())          # keys the rows see, all rows
    isz = q.element_size()
    io = isz * (2 * b * hq * hd + 2 * n_keys * hkv * hd) + 4 * b
    ops = 4.0 * hq * hd * n_keys
    bd = bound_ms(io, ops, dtype)
    dt = str(dtype)[6:]
    log(f"  decode_attention {name} [{dt}]: kernel_ms={t_d[0]:.4f} "
        f"plain_ms={t_d[1]:.4f} library_ms={t_sdpa:.4f} (SDPA; kernel / "
        f"SDPA {t_d[0] / t_sdpa:.2f}) bound_ms={bd[0]:.4f} ({bd[1]})")
    rec_d = {"max_abs_err": err_d, "ms": t_d[0], "plain_ms": t_d[1],
             "library_ms": t_sdpa, "bound_ms": bd[0], "bound_by": bd[1]}
    if not paged:
        return rec_d, None
    t_p = (time_ms(paged_call),
           time_ms(lambda: paged_decode_attention_ref(q, kp, vp, tbl, pos,
                                                      window=win)))
    blocks = sum(last // BLOCK - first // BLOCK + 1
                 for first, last in (visible_keys(p, s, win)
                                     for p in pos.tolist()))
    bp = bound_ms(io + 4 * blocks, ops, dtype)
    log(f"  paged_decode_attention {name} [{dt}]: kernel_ms={t_p[0]:.4f} "
        f"plain_ms={t_p[1]:.4f} library_ms=null sdpa_ms={t_sdpa:.4f} "
        f"(dense SDPA; kernel / SDPA {t_p[0] / t_sdpa:.2f}) "
        f"bound_ms={bp[0]:.4f} ({bp[1]})")
    return rec_d, {"max_abs_err": err_p, "ms": t_p[0], "plain_ms": t_p[1],
                   "library_ms": None, "sdpa_ms": t_sdpa, "bound_ms": bp[0],
                   "bound_by": bp[1]}


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    hyb_gen = torch.Generator(device="cuda")
    hyb_gen.manual_seed(SEED + 1)
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        err_f, t_f, bf = flash_case(gen, dtype, FLASH_SHAPES["llama_prefill"])
        log(f"  flash_attention [{str(dtype)[6:]}]: kernel_ms={t_f[0]:.4f} "
            f"plain_ms={t_f[1]:.4f} library_ms={t_f[2]:.4f} "
            f"bound_ms={bf[0]:.4f} ({bf[1]})")
        if dtype == torch.bfloat16:   # the main path's type
            rec["flash_attention"] = {
                "max_abs_err": err_f, "ms": t_f[0], "plain_ms": t_f[1],
                "library_ms": t_f[2], "bound_ms": bf[0], "bound_by": bf[1]}
        # kernels 1 and 2: the llama tp=1 shape first (its draws as in
        # earlier runs), then the other paths' shapes; the records carry
        # every shape, their top level the llama tp=1 one
        for shape in DECODE_SHAPES:
            res = decode_case(gen, dtype, shape)
            if dtype != torch.bfloat16:
                continue
            for name, r in zip(("decode_attention", "paged_decode_attention"),
                               res):
                rec.setdefault(name, {**r, "shapes": {}})["shapes"][shape] = r
        # hymba-1.5b's prefill: 25 q / 5 kv heads (g = 5), 1280 tokens past
        # its 1024 window; SDPA given the windowed causal mask (its own
        # generator: the other cases keep their inputs)
        err, t, bnd = flash_case(hyb_gen, dtype,
                                 FLASH_SHAPES["hymba_prefill"])
        log(f"  flash_attention hymba_prefill [{str(dtype)[6:]}]: "
            f"kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} library_ms="
            f"{t[2]:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})")
        if dtype == torch.bfloat16:
            rec["flash_attention"]["hymba_prefill"] = {
                "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "library_ms": t[2], "bound_ms": bnd[0], "bound_by": bnd[1]}
        free_device()
    return rec


def phase_sweep() -> None:
    """The kernels against their plain versions over the shape sweep of
    the CPU tests (GQA, ragged length, window, non-causal, hd 16 to 128),
    plus the paged kernel's trash isolation and the decode kernel's
    indifference to keys past pos, both bitwise; then the decode kernels
    at the edges of their split plan (rows on split boundaries and with
    no key, windows that start mid-split, g 5, blocks that do not divide
    the split, bf16 off the tensor cores)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    f32, bf16 = torch.float32, torch.bfloat16
    for b, hq, hkv, sq, skv, hd, causal, win, dt in (
            (2, 4, 2, 128, 128, 64, True, 0, f32),
            (1, 4, 1, 200, 200, 64, True, 0, f32),
            (2, 2, 2, 256, 256, 128, True, 64, bf16),
            (1, 8, 2, 128, 384, 64, False, 0, f32),
            (2, 4, 2, 12, 12, 16, True, 0, bf16)):
        q = rnd((b, hq, sq, hd), dt)
        k, v = rnd((b, hkv, skv, hd), dt), rnd((b, hkv, skv, hd), dt)
        check_close(f"flash_attention {b},{hq},{hkv},{sq},{skv},{hd},"
                    f"causal={causal},window={win}",
                    flash_attention(q, k, v, causal=causal, window=win),
                    flash_attention_ref(q, k, v, causal=causal,
                                        window=win), dt)
    for b, hq, hkv, s, hd, win, dt in ((4, 4, 2, 512, 64, 0, f32),
                                       (3, 8, 1, 300, 128, 0, f32),
                                       (8, 2, 2, 1024, 64, 128, bf16),
                                       (2, 4, 2, 32, 16, 0, bf16)):
        q = rnd((b, hq, hd), dt)
        k, v = rnd((b, s, hkv, hd), dt), rnd((b, s, hkv, hd), dt)
        pos = torch.randint(0, s, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
        check_close(f"decode_attention {b},{hq},{hkv},{s},{hd},window={win}",
                    decode_attention(q, k, v, pos, window=win),
                    decode_attention_ref(q, k, v, pos, window=win), dt)
        keep = (torch.arange(s, device="cuda")[None, :]
                <= pos[:, None])[:, :, None, None]
        scrubbed = decode_attention(q, torch.where(keep, k, 999.0).to(dt),
                                    torch.where(keep, v, -999.0).to(dt), pos,
                                    window=win)
        if not torch.equal(scrubbed, decode_attention(q, k, v, pos,
                                                      window=win)):
            raise AssertionError("decode_attention read a key past pos")
    for b, hq, hkv, bs, mb, nb, hd, win, dt in (
            (4, 4, 2, 16, 8, 40, 64, 0, f32),
            (3, 8, 1, 32, 4, 16, 128, 0, f32),
            (2, 2, 2, 64, 4, 12, 64, 128, bf16)):
        q = rnd((b, hq, hd), dt)
        k, v = rnd((nb, bs, hkv, hd), dt), rnd((nb, bs, hkv, hd), dt)
        tbl = (1 + torch.randperm(nb - 1, generator=gen, device="cuda")
               [:b * mb]).to(torch.int32).reshape(b, mb)
        pos = torch.randint(0, mb * bs, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
        out = paged_decode_attention(q, k, v, tbl, pos, window=win)
        check_close(f"paged_decode_attention {b},{hq},{hkv},bs={bs},"
                    f"blocks={mb},{hd},window={win}", out,
                    paged_decode_attention_ref(q, k, v, tbl, pos,
                                               window=win), dt)
        # Every block no row maps at or before its pos, the trash block 0
        # included, may hold anything.
        live = torch.zeros(nb, dtype=torch.bool, device="cuda")
        for r in range(b):
            live[tbl[r, :int(pos[r]) // bs + 1].long()] = True
        k2, v2 = k.clone(), v.clone()
        k2[~live], v2[~live] = 999.0, -999.0
        if not torch.equal(out, paged_decode_attention(q, k2, v2, tbl, pos,
                                                       window=win)):
            raise AssertionError("paged_decode_attention read a dead block")
    # the split plan's edges: rows on split boundaries, at the cache's last
    # key and with no key (pos = -1: zeros); windows that start mid-split
    # (383 - 100 + 1 = 284, 255 - 100 + 1 = 156; 383 - 200 + 1 = 184); g 5;
    # the paged kernel with blocks that do not divide the split, bitwise
    # equal to the dense one; the last two rows take bf16 off the tensor
    # cores (g 32 > 16; hd 40)
    split = SPLIT_KEYS
    s = 3 * split
    for hq, hkv, hd, win, bs, dt in ((5, 1, 64, 0, 48, f32),
                                     (10, 2, 64, 100, 48, bf16),
                                     (8, 1, 128, 200, 16, bf16),
                                     (2, 2, 16, 0, 16, f32),
                                     (32, 1, 32, 100, 48, bf16),
                                     (8, 2, 40, 0, 16, bf16)):
        pos = torch.tensor([0, split - 1, split, 2 * split - 1, s - 1, -1],
                           dtype=torch.int32, device="cuda")
        b = pos.shape[0]
        q = rnd((b, hq, hd), dt)
        k, v = rnd((b, s, hkv, hd), dt), rnd((b, s, hkv, hd), dt)
        out = decode_attention(q, k, v, pos, window=win)
        tag = (f"{b},{hq},{hkv},{s},{hd},window={win},bs={bs},"
               f"pos={pos.tolist()}")
        seen = pos >= 0
        check_close(f"decode_attention split edges {tag}", out[seen],
                    decode_attention_ref(q, k, v, pos, window=win)[seen], dt)
        if torch.count_nonzero(out[~seen]):
            raise AssertionError(f"{tag}: a row with pos = -1 is not zeros")
        tbl, kp, vp = scatter_blocks(gen, k, v, bs)
        if not torch.equal(paged_decode_attention(q, kp, vp, tbl, pos,
                                                  window=win), out):
            raise AssertionError(f"{tag}: paged kernel != dense kernel")
    torch.cuda.synchronize()


def phase_decode_repeat(n: int = 200) -> None:
    """n back-to-back calls of kernels 1 and 2 on fresh inputs, turn by
    turn over DECODE_SHAPES, bf16 and f32, dense or paged first: each
    within TOL of its plain version, paged == dense bitwise and a second
    call on the same inputs bitwise equal to the first, so the workspace
    carries nothing from one call to the next."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    names = list(DECODE_SHAPES)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for i in range(n):
        name = names[(i // 2) % len(names)]
        dtype = torch.bfloat16 if (i // 8) % 2 == 0 else torch.float32
        b, hq, hkv, hd, s, win, (lo, hi) = DECODE_SHAPES[name]
        q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda"
                        ).to(dtype)
        v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda"
                        ).to(dtype)
        pos = torch.randint(lo, hi + 1, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
        tbl, kp, vp = scatter_blocks(gen, k, v, BLOCK)
        calls = [lambda: decode_attention(q, k, v, pos, window=win),
                 lambda: paged_decode_attention(q, kp, vp, tbl, pos,
                                                window=win)]
        if i % 2:
            calls.reverse()
        outs = [c() for c in calls] + [c() for c in calls]
        ref = decode_attention_ref(q, k, v, pos, window=win)
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            raise AssertionError(f"call {i} ({name}, {dtype}): the four "
                                 "kernel outputs are not bitwise equal")
        tol = TOL[dtype]
        if not torch.allclose(outs[0].float(), ref.float(), atol=tol,
                              rtol=tol):
            raise AssertionError(f"call {i} ({name}, {dtype}) disagrees "
                                 "with the plain version")
        worst[dtype] = max(worst[dtype], max_err(outs[0], ref))
    torch.cuda.synchronize()
    log(f"  {n} back-to-back calls of each (fresh inputs, shapes "
        f"{', '.join(names)} in turn): within TOL of the plain version "
        f"(max |kernel-plain| bf16 {worst[torch.bfloat16]:.3e}, f32 "
        f"{worst[torch.float32]:.3e}), paged == dense and second calls "
        "bitwise")


# ---------------------------------------------------------------------------
# Phase 4: the whole path at full width and depth
# ---------------------------------------------------------------------------


def reset_counts() -> None:
    for w in kernel_wrappers():
        w.launches = 0


def counts() -> dict:
    return {w.__name__: w.launches for w in kernel_wrappers()}


def profile_generate(eng: InferenceEngine, prompts: np.ndarray,
                     share_of=(), new: int = NEW, graph: bool = False
                     ) -> None:
    """Where one generate's time goes: device busy share of the wall time,
    the kernels that take the most device time (torch.profiler) and, with
    ``share_of`` (a name or several), the share of device time of kernels
    whose names hold each.  ``graph``: the decode steps replayed from the
    engine's CUDA graph (captured by a generate before the profiled one);
    the engine is left in the form it had.  Returns the device-busy ms of
    one decode step in the graph form (the profiled generate's busy time
    less a profiled prefill-only generate's, over its decode steps), else
    None."""
    from torch.profiler import ProfilerActivity, profile
    form = eng.cuda_graph
    if graph:
        eng.cuda_graph = True
        eng.generate(prompts, 3)
        log(f"    profile of the graph form ({new - 1} replayed steps):")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def profiled(n):
        with profile(activities=acts) as prof:
            res = eng.generate(prompts, n)
        # kernel (and memcpy/memset) events only: device time counted once
        rows = [(e.device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
        return res, sorted((r for r in rows if r[0] > 0), reverse=True)

    res, rows = profiled(new)
    step_ms = None
    if graph and rows:
        prefill_busy = sum(r[0] for r in profiled(1)[1])
        step_ms = (sum(r[0] for r in rows) - prefill_busy) / (new - 1)
    eng.cuda_graph = form
    wall_ms = (res.prefill_s + res.decode_s) * 1e3
    busy = sum(r[0] for r in rows)
    if not rows:
        log("    profile: no device time recorded (not measured)")
        return None
    log(f"    profile: device busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
        f"({100 * busy / wall_ms:.1f}%; idle {100 - 100 * busy / wall_ms:.1f}"
        f"%) under the profiler")
    for name in (share_of,) if isinstance(share_of, str) else share_of:
        mine = [r for r in rows if name in r[2]]
        ms = sum(r[0] for r in mine)
        log(f"    profile: {name} kernels {ms:.3f} ms over "
            f"{sum(r[1] for r in mine)} launches, {100 * ms / busy:.2f}% of "
            "device time")
    for ms, n, key in rows[:8]:
        log(f"      {ms:9.3f} ms {n:6d}x  {key[:90]}")
    if step_ms is not None:
        log(f"    profile: one replayed decode step {step_ms:.4f} ms device "
            f"busy (the generate's less a prefill-only one's, over "
            f"{new - 1} steps)")
    return step_ms


def top2_gap(logits: torch.Tensor) -> np.ndarray:
    """Top-1 minus top-2 logit, (B, S) from (B, S, V), on the CPU."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu().numpy()


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Vocab-sharded logits (R, B, S, V_local) -> (B, S, R * V_local)."""
    R = logits.shape[0]
    return logits.movedim(0, -2).reshape(*logits.shape[1:-1],
                                         R * logits.shape[-1])


def teacher_forced(model, tokens: np.ndarray, ap, *ctx_mesh,
                   extra: Optional[dict] = None) -> torch.Tensor:
    """Logits (B, S-1, V) of ``model`` over a generated sequence, the
    vocab shards gathered when ``ctx_mesh`` = (ctx, mesh) is given;
    ``extra``: the frames or patches (``forward_lm``'s keywords)."""
    with torch.inference_mode():
        lg, _ = forward_lm(model, torch.as_tensor(
            tokens[:, :-1], device="cuda").long(), ap, *ctx_mesh,
            **(extra or {}))
    return gather_vocab(lg) if ctx_mesh else lg


def margin_gate(tokens_a, tokens_b, gap, prompt_len, tol) -> int:
    """Tokens must agree at every step until the first one whose reference
    top-1/top-2 logit gap is within ``tol`` (there the two may legitimately
    pick different tokens).  ``gap`` (B, S+new-1) comes from the
    reference's teacher-forced logits over its own sequence.  Returns the
    steps checked."""
    checked = 0
    for b in range(tokens_a.shape[0]):
        for t in range(tokens_a.shape[1] - prompt_len):
            if gap[b, prompt_len - 1 + t] <= tol:
                break
            if tokens_a[b, prompt_len + t] != tokens_b[b, prompt_len + t]:
                raise AssertionError(f"row {b} step {t}: tokens differ with "
                                     f"gap {gap[b, prompt_len - 1 + t]:.4g}")
            checked += 1
    return checked


# decode tok/s of every path run_path drives, eager and graph (medians of
# 3 generates each, in this run), printed together before the result
GRAPH_TPS: dict = {}


def run_path(eng: InferenceEngine, prompts: np.ndarray, label: str,
             expect: dict, new: int = NEW, extra: Optional[dict] = None):
    """The eager form (``eng.cuda_graph`` False): warm up, then one
    counted generate of ``new`` tokens; raise unless the launches are
    exactly ``expect``.  Then the graph form on a fresh decode loop (one
    eager step, one captured, replays after): its tokens bitwise the eager
    form's, and for every kernel the launches counted at the capture
    times the steps it stands for (the replays and the eager warm-up step,
    which counts the same) plus the prefill's (a ``generate`` of one
    token) equal to the eager count.  Decode tok/s of the eager form's
    counted run and the graph form's median of 3 (one eager run keeps the
    script inside the call's limit).  ``extra``: every generate's frames or
    patches (``generate(extra=)``).  Returns (eager result, eager
    launches); the engine is left eager."""
    def generate(n):
        return eng.generate(prompts, n, extra=extra)

    eng.cuda_graph = False
    generate(2)                       # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expect = {**dict.fromkeys(counts(), 0), **expect}
    reset_counts()
    res = generate(new)
    got = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {label}: prefill {res.prefill_s * 1e3:.2f} ms, decode "
        f"{res.decode_s * 1e3:.2f} ms for {new - 1} steps "
        f"({res.decode_tokens_per_s:.1f} tok/s), peak memory "
        f"{peak:.3f} GiB, launches {got}")
    if got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    eager_tps = [res.decode_tokens_per_s]
    eng.cuda_graph = True
    reset_counts()
    g = generate(new)
    captured = counts()
    reset_counts()
    generate(1)
    pre = counts()
    if not np.array_equal(g.tokens, res.tokens):
        raise AssertionError(f"{label}: graph tokens differ from eager")
    if g.graph_replays != new - 2:
        raise AssertionError(f"{label}: {g.graph_replays} replays, "
                             f"expected {new - 2}")
    for k in got:
        step, odd = divmod(captured[k] - pre[k], 2)
        if odd or pre[k] + step * (1 + g.graph_replays) != got[k]:
            raise AssertionError(
                f"{label}: {k} counted {captured[k]} with the capture, "
                f"{pre[k]} in prefill, eager {got[k]}")
    graph_tps = [generate(new).decode_tokens_per_s for _ in range(3)]
    eng.cuda_graph = False
    GRAPH_TPS[label] = (float(np.median(eager_tps)),
                        float(np.median(graph_tps)))
    replay_ms = g.new_tokens.size / GRAPH_TPS[label][1] * 1e3
    log(f"    graph form: tokens == eager bitwise; launches at the capture "
        f"x {1 + g.graph_replays} steps + prefill's == eager; decode tok/s "
        f"eager {GRAPH_TPS[label][0]:.1f} graph {GRAPH_TPS[label][1]:.1f} "
        f"(eager one run, graph median of 3: {graph_tps[0]:.1f}/"
        f"{graph_tps[1]:.1f}/{graph_tps[2]:.1f}); decode of the capturing "
        f"generate "
        f"{g.decode_s * 1e3:.2f} ms, of a replaying one {replay_ms:.2f} ms "
        "(median)")
    return res, got


# What phase 34 reads of phase 4: the dense eager run's prefill ms and the
# device-busy ms of one graph-replayed decode step; and of phase 6, when it
# ran, the hier_rd eager run's prefill ms (printed beside phase 34's).
P4: dict = {}
P6: dict = {}


def phase_path() -> tuple:
    """Returns (launches by path, tp=1 dense tokens, their teacher-forced
    logits)."""
    cfg = get_config("llama3.2-1b")
    ap = make_plan(cfg, 1)
    model = init_params(ap, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters in {cfg.dtype}")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT))
    L = cfg.n_layers
    expect = {"dense": {"flash_attention": L,
                        "decode_attention": L * (NEW - 1),
                        "paged_decode_attention": 0, "rd_all_reduce": 0,
                        "collective_matmul_rd": 0},
              "paged": {"flash_attention": L, "decode_attention": 0,
                        "paged_decode_attention": L * (NEW - 1),
                        "rd_all_reduce": 0, "collective_matmul_rd": 0}}
    launches = {}
    tokens = {}
    for layout, bsz in (("dense", 0), ("paged", BLOCK)):
        eng = InferenceEngine(ap, model, s_max=S_MAX, block_size=bsz,
                              device="cuda")
        res, launches[f"tp1_{layout}"] = run_path(eng, prompts, layout,
                                                  expect[layout])
        tokens[layout] = res.tokens
        if layout == "dense":
            P4["prefill_ms"] = res.prefill_s * 1e3
            profile_generate(eng, prompts, share_of="decode_attention")
            P4["decode_step_busy_ms"] = profile_generate(
                eng, prompts, share_of="decode_attention", graph=True)
    if not np.array_equal(tokens["dense"], tokens["paged"]):
        raise AssertionError("paged tokens differ from dense tokens")
    log("  paged tokens == dense tokens")
    # kept on the host until phase 6 compares, out of phase 6's peak memory
    return launches, tokens["dense"], teacher_forced(model, tokens["dense"],
                                                     ap).cpu()


# ---------------------------------------------------------------------------
# Phases 5 and 7: card against CPU at full width, 2 layers, float32
# ---------------------------------------------------------------------------


def card_vs_cpu(tp: int, pods: int, strategy: str,
                overlap_matmul: bool = False, ar_quant: str = "none",
                tol: float = 1e-3, arch: str = "llama3.2-1b",
                cut: Optional[dict] = None) -> None:
    """The same seeded weights of ``arch`` (2 layers, full width, f32) on
    the card (kernels) and on the CPU (plain versions), at ``tp`` over a
    virtual mesh of ``pods`` x tp/pods ranks when tp > 1 (a QKV-bias
    arch with nonzero biases planted); logits within ``tol``, greedy
    tokens checked by ``provable_gate``.  f32 sums over
    2048- and 8192-long reductions are taken in another order on the card
    than on the CPU: ~1e-5 on O(1) logits, hence the default ``tol``.
    ``cut``: further config fields (an encoder's depth, the patch count);
    an encoder-decoder or a VLM gets seeded frames or patches, the same
    on both devices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              dtype=torch.float32, **(cut or {}))
    ap = make_plan(cfg, tp)
    mesh_g, ctx = mesh_and_ctx(tp, pods, ar_strategy=strategy,
                               device="cuda")
    mesh_c, _ = mesh_and_ctx(tp, pods, ar_strategy=strategy, device="cpu")
    ctx = ctx.replace(overlap_matmul=overlap_matmul, ar_quant=ar_quant)
    gpu = init_params(ap, seed=SEED, device="cuda", mesh=mesh_g)
    if cfg.qkv_bias:
        plant_qkv_bias(gpu, ap, mesh_g, SEED + 7)
    cpu = copy.deepcopy(gpu).to("cpu")
    b, s, new = 2, 64, 8
    prompts = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size,
                                                       (b, s))
    ex_c = multimodal_extra(cfg, b, SEED + 2, "cpu")
    ex_g = {k: t.to("cuda") for k, t in ex_c.items()}

    def full(logits):
        return logits if mesh_g is None else gather_vocab(logits)

    with torch.inference_mode():
        lg, _ = forward_lm(gpu, torch.as_tensor(prompts, device="cuda"), ap,
                           ctx, mesh_g, **ex_g)
        lc, _ = forward_lm(cpu, torch.as_tensor(prompts), ap, ctx, mesh_c,
                           **ex_c)
    lg, lc = full(lg).cpu(), full(lc)
    err = max_err(lg, lc)
    log(f"  prefill logits card vs CPU: max abs err {err:.3e} "
        f"(atol=rtol={tol:g})")
    if not torch.allclose(lg, lc, atol=tol, rtol=tol):
        raise AssertionError("prefill logits differ between card and CPU")
    res_g = InferenceEngine(ap, gpu, ctx=ctx, mesh=mesh_g, s_max=s + new,
                            device="cuda").generate(prompts, new,
                                                    extra=ex_g)
    res_c = InferenceEngine(ap, cpu, ctx=ctx, mesh=mesh_c, s_max=s + new,
                            device="cpu").generate(prompts, new, extra=ex_c)
    # both devices' decode paths teacher-forced on the CPU's sequence, over
    # the real vocab (a padded vocab's zero columns would enter the gaps)
    tf = {dev: teacher_forced_decode(m, res_c.tokens, ap, ctx, mesh,
                                     prompt=s, s_max=s + new, device=dev,
                                     extra=ex)[..., :cfg.vocab_size]
          for dev, m, mesh, ex in (("cuda", gpu, mesh_g, ex_g),
                                   ("cpu", cpu, mesh_c, ex_c))}
    n = provable_gate(res_g.tokens, res_c.tokens, tf["cuda"], tf["cpu"], s)
    log(f"  greedy tokens card == CPU on {n}/{b * new} steps whose CPU "
        f"top-1/top-2 gap is above twice the card-CPU logit difference "
        f"(fully equal: {np.array_equal(res_g.tokens, res_c.tokens)})")


# ---------------------------------------------------------------------------
# Phase 3: the recursive-doubling all-reduce kernel
# ---------------------------------------------------------------------------


def rd_bound(R: int, pods: int, m: int, esz: int) -> tuple:
    """x read once and out written once (2 R m elements), and each step's
    R m adds in f32 (CUDA cores)."""
    steps = pods.bit_length() - 1
    return bound_ms(2.0 * R * m * esz, 1.0 * steps * R * m, torch.float32)


def rd_exchange_ms(R: int, pods: int, m: int, esz: int) -> float:
    """Time at the HBM rate of the exchange's own traffic, which the bound
    leaves out: each step every rank puts its partial to its peer, reads
    its own and the peer's copy and writes the new partial (4 m elements)."""
    steps = pods.bit_length() - 1
    return 4.0 * steps * R * m * esz / HBM_BYTES_PER_S * 1e3


def rd_sweep(ws: RDWorkspace, gen: torch.Generator, label: str) -> None:
    """Kernel 4 bitwise against its plain version over the whole sweep:
    bf16, f32 x pods 2/4/8 x fast 1/2 x RD_SIZES x chunks 1/4, then rows
    that take the scalar paths (an odd length; a start one element past a
    16-byte boundary)."""
    n_checked = 0
    for dtype in (torch.bfloat16, torch.float32):
        esz = torch.empty((), dtype=dtype).element_size()
        for pods in (2, 4, 8):
            for fast in (1, 2):
                for nbytes in RD_SIZES:
                    x = torch.randn((pods * fast, nbytes // esz),
                                    generator=gen, device="cuda").to(dtype)
                    ref = rd_all_reduce_ref(x, pods)
                    for chunks in (1, 4):
                        out = rd_all_reduce(x, pods, n_chunks=chunks,
                                            workspace=ws)
                        if not torch.equal(out, ref):
                            torch.cuda.synchronize()
                            raise AssertionError(
                                f"rd_all_reduce ({label}) {dtype} pods="
                                f"{pods} fast={fast} {nbytes} B chunks="
                                f"{chunks}: max|kernel-plain| = "
                                f"{max_err(out, ref)}")
                        n_checked += 1
    torch.cuda.synchronize()
    log(f"  rd_all_reduce ({label}) == plain version bitwise on {n_checked} "
        "cases (bf16, f32 x pods 2/4/8 x fast 1/2 x 16 KB-8 MB x chunks "
        "1/4)")
    n_checked = 0
    for dtype in (torch.bfloat16, torch.float32):
        esz = torch.empty((), dtype=dtype).element_size()
        for pods in (2, 4, 8):
            for fast in (1, 2):
                R = pods * fast
                odd = torch.randn((R, 4097), generator=gen,
                                  device="cuda").to(dtype)
                shifted = torch.empty(R * 8192 + 1, dtype=dtype,
                                      device="cuda")[1:].view(R, 8192)
                shifted.copy_(torch.randn((R, 8192), generator=gen,
                                          device="cuda"))
                for x in (odd, shifted):
                    if (x.shape[1] * esz) % 16 == 0 and x.data_ptr() % 16 == 0:
                        raise AssertionError("operand is 16-byte aligned")
                    ref = rd_all_reduce_ref(x, pods)
                    for chunks in (1, 4):
                        out = rd_all_reduce(x, pods, n_chunks=chunks,
                                            workspace=ws)
                        if not torch.equal(out, ref):
                            raise AssertionError(
                                f"rd_all_reduce ({label}, scalar) {dtype} "
                                f"pods={pods} fast={fast} m={x.shape[1]} "
                                f"off={x.data_ptr() % 16} chunks={chunks}: "
                                f"max|kernel-plain| = {max_err(out, ref)}")
                        n_checked += 1
    torch.cuda.synchronize()
    log(f"  rd_all_reduce ({label}, scalar paths, unaligned rows) == plain "
        f"version bitwise on {n_checked} cases (bf16, f32 x pods 2/4/8 x "
        "fast 1/2 x odd length / shifted start x chunks 1/4)")


def rd_graph_replays(ws: RDWorkspace, gen: torch.Generator,
                     n: int = 200) -> None:
    """One call at the decode message captured in a CUDA graph and
    replayed ``n`` times on fresh inputs copied into its operand, every
    replay checked on the device: the kernel takes its epoch from device
    memory, so a replay waits for the current one, not a frozen number."""
    R, m = PODS * FAST, RD_SIZES[0] // 2
    x = torch.randn((R, m), generator=gen, device="cuda").to(torch.bfloat16)
    rd_all_reduce(x, PODS, workspace=ws)        # workspace and caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rd_all_reduce(x, PODS, workspace=ws)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(n):
        x.copy_(torch.randn((R, m), generator=gen, device="cuda"))
        graph.replay()
        bad += (out != rd_all_reduce_ref(x, PODS)).any()
    torch.cuda.synchronize()
    log(f"  {n} CUDA-graph replays of one captured call ({R} x {m} bf16): "
        f"{int(bad)} wrong")
    if int(bad):
        raise AssertionError("rd_all_reduce: graph replays disagree")
    del graph


def phase_rd() -> dict:
    ws = RDWorkspace()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    log(f"  protocol by message size: LL up to {rd_ops.LL_MAX_BYTES} B a "
        "rank, pieces and flags above")
    for proto in ("ll", "simple"):
        with mock.patch.object(rd_ops, "PROTOCOL", proto):
            rd_sweep(ws, gen, f"{proto} forced")
    # back-to-back calls on fresh inputs whose size crosses the threshold
    # (the decode message by LL, twice the threshold by pieces and flags),
    # alternating chunk counts, every result checked on the device (one
    # sync at the end)
    R = PODS * FAST
    sizes = (RD_SIZES[0] // 2, 2 * rd_ops.LL_MAX_BYTES // 2)
    xs = [torch.empty((R, m), dtype=torch.bfloat16, device="cuda")
          for m in sizes]
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for i in range(1000):
        x = xs[i % 2]
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        out = rd_all_reduce(x, PODS, n_chunks=1 + 3 * (i // 2 % 2),
                            workspace=ws)
        bad += (out != rd_all_reduce_ref(x, PODS)).any()
    torch.cuda.synchronize()
    log(f"  1000 back-to-back calls, {sizes[0] * 2} and {sizes[1] * 2} B a "
        f"rank in turn ({[rd_ops.rd_protocol(2 * m) for m in sizes]}): "
        f"{int(bad)} wrong ({time.perf_counter() - t0:.2f} s)")
    if int(bad):
        raise AssertionError("rd_all_reduce: back-to-back calls disagree")
    rd_graph_replays(ws, gen)
    rec = {}
    for nbytes, parent_ms in zip(RD_SIZES, RD_PARENT_MS):
        xs = torch.randn((R, nbytes // 2), generator=gen,
                         device="cuda").to(torch.bfloat16)
        out = rd_all_reduce(xs, PODS, workspace=ws)
        err = max_err(out, rd_all_reduce_ref(xs, PODS))
        t = (time_ms(lambda: rd_all_reduce(xs, PODS, workspace=ws)),
             time_ms(lambda: rd_all_reduce_ref(xs, PODS)),
             time_ms(lambda: xs.view(PODS, FAST, -1).sum(0)))
        forced = {}
        for proto in ("ll", "simple"):
            with mock.patch.object(rd_ops, "PROTOCOL", proto):
                forced[proto] = time_ms(
                    lambda: rd_all_reduce(xs, PODS, workspace=ws))
        bnd = rd_bound(R, PODS, nbytes // 2, 2)
        log(f"  rd_all_reduce [bfloat16] {PODS}x{FAST} ranks, "
            f"{nbytes // 1024} KB a rank ({rd_ops.rd_protocol(nbytes)}): "
            f"kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
            f"bound_ms={bnd[0]:.6f} ({bnd[1]}); ll_ms={forced['ll']:.4f} "
            f"simple_ms={forced['simple']:.4f}; before the LL redesign "
            f"{parent_ms:.4f} "
            f"ms (x{t[0] / parent_ms:.3f}); exchange traffic at the HBM "
            f"rate {rd_exchange_ms(R, PODS, nbytes // 2, 2):.6f} ms")
        if nbytes == RD_SIZES[0]:       # the path's decode message
            rec = {"max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                   "library_ms": t[2], "bound_ms": bnd[0],
                   "bound_by": bnd[1]}
    log(f"  workspace {ws.nbytes / 2**20:.1f} MiB")
    return rec


# ---------------------------------------------------------------------------
# Phase 6: the tensor-parallel path at full width and depth
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def planted_fault(kind: str):
    """A deliberate fault in the TP all-reduce, for the negative control of
    the logits gate: ``skip_slow`` leaves out the slow phase (each rank
    keeps its pod's partial), ``swap_fast`` gathers the fast pieces in the
    wrong order."""
    if kind == "skip_slow":
        patch = mock.patch.object(hierarchical, "_slow_phase",
                                  lambda x, ctx, mesh: x)
    else:
        gather = hierarchical._fast_all_gather

        def swapped(y, pods, fast, dim):
            y = y.reshape(pods, fast, *y.shape[1:]).flip(1).reshape(y.shape)
            return gather(y, pods, fast, dim)
        patch = mock.patch.object(hierarchical, "_fast_all_gather", swapped)
    with patch:
        yield


def logits_gap(model, tokens, ap, ctx, mesh, ref_logits) -> tuple:
    """(max, mean) |diff| of ``model``'s teacher-forced logits over
    ``tokens`` against ``ref_logits``."""
    diff = (teacher_forced(model, tokens, ap, ctx, mesh).float()
            - ref_logits.float()).abs()
    return float(diff.max()), float(diff.mean())


def phase_tp(tp1_tokens: np.ndarray, tp1_logits: torch.Tensor) -> tuple:
    """Returns (launches by path, flat's tokens, their teacher-forced
    logits on the host)."""
    cfg = get_config("llama3.2-1b")
    ap = make_plan(cfg, PODS * FAST)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
    log(f"  {cfg.name} tp={ap.tp} on {mesh}: GQA g={ap.gqa.g} u={ap.gqa.u}"
        f", dead q slots: {ap.q_mask_tbl is not None}")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT))
    L = cfg.n_layers
    launches = {}
    tokens = {}
    for strategy in ("hier_rd", "flat"):
        sctx = ctx.replace(ar_strategy=strategy)
        expect = {"flash_attention": L, "decode_attention": L * (NEW - 1),
                  "paged_decode_attention": 0,
                  "rd_all_reduce": (2 * L + 1) * NEW
                  if strategy == "hier_rd" else 0,
                  "collective_matmul_rd": 0}
        eng = InferenceEngine(ap, model, ctx=sctx, mesh=mesh, s_max=S_MAX,
                              device="cuda")
        res, launches[f"tp8_{strategy}"] = run_path(
            eng, prompts, f"tp=8 {strategy}", expect)
        tokens[strategy] = res.tokens
        if strategy == "hier_rd":
            P6["prefill_ms"] = res.prefill_s * 1e3
            profile_generate(eng, prompts, share_of="rd_allreduce")
            profile_generate(eng, prompts, share_of="rd_allreduce",
                             graph=True)
        else:
            flat_logits = teacher_forced(model, res.tokens, ap, sctx, mesh)
    # hier_rd against each reference: tokens margin-gated on the
    # reference's gap, and the logits of both over the reference's sequence
    # within (TF_MAX, TF_MEAN), which each planted fault must break
    for ref_name, ref, ref_logits in (("flat", tokens["flat"], flat_logits),
                                      ("tp=1", tp1_tokens, tp1_logits)):
        ref_logits = ref_logits.to("cuda")
        n = margin_gate(tokens["hier_rd"], ref, top2_gap(ref_logits),
                        PROMPT, BF16_GAP)
        mx, mean = logits_gap(model, ref, ap, ctx, mesh, ref_logits)
        log(f"  tp=8 hier_rd tokens == {ref_name} tokens on {n}/"
            f"{B * NEW} steps gated at gap {BF16_GAP:g} (fully equal: "
            f"{np.array_equal(tokens['hier_rd'], ref)}); teacher-forced "
            f"logits max|diff| {mx:.4f}, mean {mean:.3e} (limits "
            f"{TF_MAX:g}, {TF_MEAN:g})")
        if mx > TF_MAX or mean > TF_MEAN:
            raise AssertionError(f"tp=8 hier_rd logits differ from "
                                 f"{ref_name}'s")
        for kind in ("skip_slow", "swap_fast"):
            with planted_fault(kind):
                fmx, fmean = logits_gap(model, ref, ap, ctx, mesh,
                                        ref_logits)
            log(f"    planted fault {kind}: max|diff| {fmx:.4f}, mean "
                f"{fmean:.3e}")
            if fmx <= TF_MAX and fmean <= TF_MEAN:
                raise AssertionError(f"the logits gate passed the planted "
                                     f"fault {kind}")
    return launches, tokens["flat"], flat_logits.cpu()


# ---------------------------------------------------------------------------
# Phase 8: the fused GEMM + recursive-doubling kernel
# ---------------------------------------------------------------------------


def fused_bound(R: int, M: int, K: int, N: int, dtype) -> tuple:
    """x and w read once, out written once; 2 R M K N operations."""
    esz = torch.empty((), dtype=dtype).element_size()
    return bound_ms((R * M * K + R * K * N + R * M * N) * esz,
                    2.0 * R * M * K * N, dtype)


def fold_pods(x: torch.Tensor, w: torch.Tensor, pods: int, fast: int):
    """The library yardstick's operands: (fast, M, pods K) and
    (fast, pods K, N), one bmm computing every fast column's sum over the
    pods (the same function, without the per-rank copies)."""
    R, M, K = x.shape
    xl = x.view(pods, fast, M, K).permute(1, 2, 0, 3).reshape(fast, M,
                                                              pods * K)
    wl = w.view(pods, fast, K, -1).transpose(0, 1).reshape(fast, pods * K, -1)
    return xl.contiguous(), wl.contiguous()


def fused_graph_replays(ws: RDWorkspace, gen: torch.Generator,
                        x: torch.Tensor, w: torch.Tensor,
                        n: int = 200) -> None:
    """One call at the decode MLP shape (4 chunks) captured in a CUDA
    graph and replayed ``n`` times on fresh inputs copied into its
    operand, every replay checked on the device: bitwise a direct call on
    the same inputs and within TOL of the plain version.  The kernel takes
    its flag value from its own epoch words in device memory, so a replay
    waits for the current one, not a number frozen at the capture."""
    R, M, K = x.shape
    tol = TOL[x.dtype]
    collective_matmul_rd(x, w, PODS, n_chunks=4, workspace=ws)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = collective_matmul_rd(x, w, PODS, n_chunks=4, workspace=ws)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(n):
        x.copy_(torch.randn((R, M, K), generator=gen, device="cuda"))
        graph.replay()
        direct = collective_matmul_rd(x, w, PODS, n_chunks=4, workspace=ws)
        ref = collective_matmul_rd_ref(x, w, PODS)
        bad += (out != direct).any() | ((out.float() - ref.float()).abs()
                                        > tol + tol * ref.float().abs()).any()
    torch.cuda.synchronize()
    log(f"  {n} CUDA-graph replays of one captured call ({R} x {M} x {K} "
        f"bf16, 4 chunks): {int(bad)} wrong (bitwise a direct call, within "
        "TOL of the plain version)")
    if int(bad):
        raise AssertionError("collective_matmul_rd: graph replays disagree")
    del graph


def phase_fused() -> dict:
    ws = RDWorkspace()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    torch.backends.cuda.matmul.allow_tf32 = False

    def operands(R, M, K, dtype):
        x = torch.randn((R, M, K), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((R, K, D_MODEL), generator=gen, device="cuda")
             / K ** 0.5).to(dtype)
        return x, w

    n_checked = 0
    for dtype in (torch.bfloat16, torch.float32):
        for pods, fast in ((PODS, FAST), (2, 1)):
            R = pods * fast
            for label, (M, K) in {**FUSED_SHAPES, **FUSED_EXTRA}.items():
                x, w = operands(R, M, K, dtype)
                ref = collective_matmul_rd_ref(x, w, pods)
                outs = []
                for chunks in (1, 2, 4, 8):
                    # a NaN block of the output's size freed just before:
                    # the allocator hands it to the kernel's output, so an
                    # element the kernel does not write shows as NaN
                    del_me = torch.full((R, M, D_MODEL), float("nan"),
                                        dtype=dtype, device="cuda")
                    del del_me
                    outs.append(collective_matmul_rd(x, w, pods,
                                                     n_chunks=chunks,
                                                     workspace=ws))
                torch.cuda.synchronize()
                check_close(f"collective_matmul_rd {pods}x{fast} {label} "
                            f"M={M} K={K}", outs[0], ref, dtype)
                if not all(torch.equal(outs[0], o) for o in outs[1:]):
                    raise AssertionError("collective_matmul_rd: the output "
                                         "depends on n_chunks")
                o = outs[0].view(pods, fast, M, D_MODEL)
                if not all(torch.equal(o[0], o[p]) for p in range(1, pods)):
                    raise AssertionError("collective_matmul_rd: the ranks of "
                                         "a fast column differ")
                n_checked += 4
    log(f"  collective_matmul_rd: {n_checked} calls within TOL of the plain "
        "version, bitwise equal across n_chunks 1/2/4/8 and across the "
        "pods of each fast column, every element written")
    # back-to-back calls on fresh inputs at the decode MLP shape, chunk
    # counts cycling, every result checked on the device (one sync)
    M, K = FUSED_SHAPES["decode_mlp"]
    R = PODS * FAST
    x, w = operands(R, M, K, torch.bfloat16)
    tol = TOL[torch.bfloat16]
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for i in range(1000):
        x.copy_(torch.randn((R, M, K), generator=gen, device="cuda"))
        out = collective_matmul_rd(x, w, PODS, n_chunks=(1, 2, 4, 8)[i % 4],
                                   workspace=ws)
        ref = collective_matmul_rd_ref(x, w, PODS)
        bad += ((out.float() - ref.float()).abs()
                > tol + tol * ref.float().abs()).any()
    torch.cuda.synchronize()
    log(f"  1000 back-to-back calls: {int(bad)} wrong "
        f"({time.perf_counter() - t0:.2f} s)")
    if int(bad):
        raise AssertionError("collective_matmul_rd: back-to-back calls "
                             "disagree")
    fused_graph_replays(ws, gen, x, w)
    rec = {"shapes": {}}
    for label, (M, K) in FUSED_SHAPES.items():
        x, w = operands(R, M, K, torch.bfloat16)
        out = collective_matmul_rd(x, w, PODS, n_chunks=4, workspace=ws)
        err = max_err(out, collective_matmul_rd_ref(x, w, PODS))
        xl, wl = fold_pods(x, w, PODS, FAST)
        t = (time_ms(lambda: collective_matmul_rd(x, w, PODS, n_chunks=4,
                                                  workspace=ws)),
             time_ms(lambda: collective_matmul_rd_ref(x, w, PODS)),
             time_ms(lambda: torch.bmm(xl, wl)))
        bnd = fused_bound(R, M, K, D_MODEL, torch.bfloat16)
        # the same launch with pods = 1: the GEMMs alone, no exchange
        gemm = time_ms(lambda: collective_matmul_rd(x, w, 1, n_chunks=4,
                                                    workspace=ws))
        log(f"  collective_matmul_rd [bfloat16] {PODS}x{FAST} ranks, "
            f"{label} M={M} K={K} N={D_MODEL}: kernel_ms={t[0]:.4f} "
            f"plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
            f"bound_ms={bnd[0]:.6f} ({bnd[1]}); without the exchange "
            f"(pods=1) {gemm:.4f}")
        one = {"M": M, "K": K, "N": D_MODEL, "max_abs_err": err, "ms": t[0],
               "plain_ms": t[1], "library_ms": t[2], "bound_ms": bnd[0],
               "bound_by": bnd[1], "gemm_only_ms": gemm}
        rec["shapes"][label] = one
        if label == "decode_mlp":  # the larger of the decode path's shapes
            rec.update({k: v for k, v in one.items()
                        if k not in ("M", "K", "N", "gemm_only_ms")})
    log(f"  workspace {ws.nbytes / 2**20:.1f} MiB")
    return rec


# ---------------------------------------------------------------------------
# Phase 9: the paper's deployment, auto + overlapped projections
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def planted_fused_fault(kind: str):
    """A deliberate fault in the fused path, for the negative control of
    the logits gate: ``skip_slow`` runs the kernel with no exchange (each
    rank keeps its own GEMM), ``skip_fast`` drops the fast sum after it."""
    if kind == "skip_slow":
        patch = mock.patch.object(
            overlap, "_fused_rd", lambda xm, wm, pods, k, mesh:
            collective_matmul_rd(xm, wm, 1, n_chunks=k,
                                 workspace=mesh.workspace))
    else:
        patch = mock.patch.object(overlap, "_fast_sum",
                                  lambda y, pods, fast: y)
    with patch:
        yield


def teacher_forced_decode(model, tokens: np.ndarray, ap, ctx=None,
                          mesh=None, ef: bool = True, *, prompt: int = PROMPT,
                          s_max: int = S_MAX, device: str = "cuda",
                          kv: Optional[dict] = None, layer_map=None,
                          prefill_model=None,
                          extra: Optional[dict] = None) -> torch.Tensor:
    """Logits (b, new, V) of the decode path over a generated sequence
    (b, prompt + new): the prompt prefilled, then the sequence's own tokens
    fed one decode step at a time (vocab shards gathered on a mesh), the
    computation ``generate`` makes on that prefix; under a quantized wire
    the cache carries the error-feedback leaf unless ``ef`` is False.  On
    the card the steps are one CUDA graph (``CapturedStep``: the first
    step eager, the second captured, the rest replayed), whose logits are
    the eager steps' bit for bit (every ``run_path`` checks graph ==
    eager); a planted fault's patch is in force at the capture.  ``kv`` /
    ``layer_map``: ``init_cache`` and ``decode_step`` options (the int8 or
    ring cache, int8 weights); ``prefill_model`` prefills the prompt when
    ``model`` is the int8-weight one (the reference's weight_quant is
    decode-only); ``extra``: the prompt's frames or patches (an
    encoder-decoder's cross K/V are seeded with the prompt's states)."""
    kw = {} if ctx is None else {"ctx": ctx, "mesh": mesh}
    ef_sites = ef_sites_for(ctx, ap.cfg) if ctx is not None and ef else 0
    b, new = tokens.shape[0], tokens.shape[1] - prompt
    kv = kv or {}

    def full(lg):
        return lg if mesh is None else gather_vocab(lg)

    with torch.inference_mode():
        toks = torch.as_tensor(tokens, device=device).long()
        lg, states = forward_lm(model if prefill_model is None
                                else prefill_model, toks[:, :prompt], ap,
                                collect_state=True, **kw, **(extra or {}))
        cache = seed_cache(init_cache(ap, b, s_max, device=device, mesh=mesh,
                                      ef_sites=ef_sites, **kv), states)
        out = [full(lg)[:, -1]]
        tok = torch.zeros(b, dtype=torch.long, device=device)
        pos = torch.zeros(b, dtype=torch.int32, device=device)
        held = {}

        def body():
            lg_t, _ = decode_step(model, cache, tok, pos, ap, **kw,
                                  layer_map=layer_map,
                                  kv_ring=kv.get("window_cache", False))
            held["lg"] = full(lg_t)

        step = CapturedStep(body, device != "cpu",
                            workspace=getattr(mesh, "workspace", None))
        for t in range(new - 1):
            tok.copy_(toks[:, prompt + t])
            pos.fill_(prompt + t)
            step()
            out.append(held["lg"].clone())
    return torch.stack(out, dim=1)


def provable_gate(tokens: np.ndarray, ref_tokens: np.ndarray,
                  logits: torch.Tensor, ref_logits: torch.Tensor,
                  prompt_len: int) -> int:
    """Greedy tokens against a reference's: equal at every step until the
    first at which the reference's top-1/top-2 gap is not above twice the
    largest difference of the two paths' logits there (only then can the
    two argmaxes differ).  ``logits`` and ``ref_logits`` (b, new, V) are
    the two paths' decode-path logits teacher-forced on the reference's
    sequence.  Returns the steps checked."""
    gap = top2_gap(ref_logits)
    diff = (logits.float().cpu() - ref_logits.float().cpu()).abs() \
        .amax(-1).numpy()
    checked = 0
    for b in range(tokens.shape[0]):
        for t in range(gap.shape[1]):
            if gap[b, t] <= 2 * diff[b, t]:
                break
            if tokens[b, prompt_len + t] != ref_tokens[b, prompt_len + t]:
                raise AssertionError(f"row {b} step {t}: tokens differ with "
                                     f"gap {gap[b, t]:.4g} above twice the "
                                     f"logit difference {diff[b, t]:.4g}")
            checked += 1
    return checked


def gate(label: str, got: torch.Tensor, ref: torch.Tensor,
         limits: tuple = (TF_MAX, TF_MEAN)) -> tuple:
    """(max, mean) |diff| of two teacher-forced logits, logged beside the
    limits they are held to."""
    diff = (got.float() - ref.float()).abs()
    mx, mean = float(diff.max()), float(diff.mean())
    log(f"    {label}: teacher-forced logits max|diff| {mx:.4f}, mean "
        f"{mean:.3e} (limits {limits[0]:g}, {limits[1]:g})")
    return mx, mean


def resolve_cost_us(ctx, mesh) -> float:
    """Host time (µs) of the ``auto`` resolutions of one decode step: the
    embedding's all-reduce and the 2 L overlapped projections each resolve
    once per call against the active tuner."""
    L = get_config("llama3.2-1b").n_layers
    x = torch.empty((PODS * FAST, B, 1, D_MODEL), dtype=torch.bfloat16,
                    device="cuda")
    h = torch.empty((PODS * FAST, B, 1, D_FF // (PODS * FAST)),
                    dtype=torch.bfloat16, device="cuda")
    wd = torch.empty((PODS * FAST, D_FF // (PODS * FAST), D_MODEL),
                     dtype=torch.bfloat16, device="cuda")
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        hierarchical._resolve_auto(x, ctx, mesh)
    t_ar = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        overlap._resolve_auto_for_matmul(h, wd, ctx, mesh)
    t_mm = (time.perf_counter() - t0) / n * 1e6
    per_step = t_ar + 2 * L * t_mm
    log(f"  auto resolution (host clock): {t_ar:.2f} us a tp_all_reduce, "
        f"{t_mm:.2f} us a projection; {per_step:.1f} us a decode step "
        f"(1 + {2 * L} calls)")
    return per_step


def expected_launches(ctx_strategy: str, tuner, L: int) -> dict:
    """Launches of one generate under ``ctx_strategy`` with overlapped
    projections: each call site's strategy is the tuner's pick for its
    message (decode: B x d_model, prefill: B x S x d_model, bf16); under
    hier_rd the projections run the fused kernel and the embedding's
    all-reduce the RD kernel, one of each site per layer and step."""
    def strat(msg):
        if ctx_strategy != "auto":
            return ctx_strategy
        return tuner.choose(msg, FAST, PODS, "bfloat16").strategy
    dec = strat(B * D_MODEL * 2) == "hier_rd"
    pre = strat(B * PROMPT * D_MODEL * 2) == "hier_rd"
    return {"flash_attention": L, "decode_attention": L * (NEW - 1),
            "paged_decode_attention": 0,
            "rd_all_reduce": (NEW - 1) * dec + pre,
            "collective_matmul_rd": 2 * L * ((NEW - 1) * dec + pre)}


def phase_overlap(tp1_tokens, tp1_logits, flat_tokens, flat_logits
                  ) -> tuple:
    """Returns (launches by path, the decode-path references: name ->
    (that reference's tokens, its decode path's teacher-forced logits on
    the host), for flat at tp=8 and for tp=1)."""
    cfg = get_config("llama3.2-1b")
    L = cfg.n_layers
    ap = make_plan(cfg, PODS * FAST)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="auto",
                             device="cuda")
    ctx = ctx.replace(overlap_matmul=True, overlap_chunks=4)
    model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT))
    tuner = autotune.AutoTuner()        # the analytic table (PERLMUTTER)
    for what, msg in (("decode", B * D_MODEL * 2),
                      ("prefill", B * PROMPT * D_MODEL * 2)):
        log(f"  auto picks for the {what} message ({msg} B a rank): "
            f"{tuner.choose(msg, FAST, PODS, 'bfloat16')}")
    launches = {}
    expect = expected_launches("auto", tuner, L)
    eng = InferenceEngine(ap, model, ctx=ctx, mesh=mesh, s_max=S_MAX,
                          ar_table=tuner, device="cuda")
    res, launches["tp8_auto_overlap"] = run_path(
        eng, prompts, "tp=8 auto+overlap", expect)
    profile_generate(eng, prompts, share_of="fused_matmul_rd")
    with autotune.using(tuner):
        resolve_cost_us(ctx, mesh)
    refs = {"flat": (flat_tokens, flat_logits), "tp=1": (tp1_tokens,
                                                        tp1_logits)}
    for name, (ref, ref_logits) in refs.items():
        n = margin_gate(res.tokens, ref, top2_gap(ref_logits.to("cuda")),
                        PROMPT, BF16_GAP)
        log(f"  tp=8 auto+overlap tokens == {name} tokens on {n}/{B * NEW} "
            f"steps gated at gap {BF16_GAP:g} (fully equal: "
            f"{np.array_equal(res.tokens, ref)})")
    # the decode path's logits over each reference's sequence, against the
    # same decode path of the reference (flat at tp=8; tp=1)
    model1 = init_params(make_plan(cfg, 1), seed=SEED, device="cuda")
    ref_runs = {"flat": lambda t: teacher_forced_decode(
                    model, t, ap, ctx.replace(ar_strategy="flat",
                                              overlap_matmul=False), mesh),
                "tp=1": lambda t: teacher_forced_decode(
                    model1, t, make_plan(cfg, 1))}
    decode_refs = {}
    for name, (ref, _) in refs.items():
        with autotune.using(tuner):
            mine = teacher_forced_decode(model, ref, ap, ctx, mesh)
        want = ref_runs[name](ref)
        decode_refs[name] = (ref, want.cpu())
        mx, mean = gate(f"auto+overlap vs {name}, decode path", mine, want)
        if mx > TF_MAX or mean > TF_MEAN:
            raise AssertionError(f"tp=8 auto+overlap logits differ from "
                                 f"{name}'s")
        for kind in ("skip_slow", "skip_fast"):
            with planted_fused_fault(kind), autotune.using(tuner):
                bad = teacher_forced_decode(model, ref, ap, ctx, mesh)
            fmx, fmean = gate(f"  planted fault {kind}", bad, want)
            if fmx <= TF_MAX and fmean <= TF_MEAN:
                raise AssertionError(f"the logits gate passed the planted "
                                     f"fault {kind}")
    del model1
    # hier_rd + overlap: the fused kernel at the prefill size as well
    hctx = ctx.replace(ar_strategy="hier_rd")
    eng = InferenceEngine(ap, model, ctx=hctx, mesh=mesh, s_max=S_MAX,
                          device="cuda")
    res, launches["tp8_hier_rd_overlap"] = run_path(
        eng, prompts, "tp=8 hier_rd+overlap", expected_launches(
            "hier_rd", tuner, L))
    for name, (ref, ref_logits) in refs.items():
        ref_logits = ref_logits.to("cuda")
        n = margin_gate(res.tokens, ref, top2_gap(ref_logits), PROMPT,
                        BF16_GAP)
        mx, mean = logits_gap(model, ref, ap, hctx, mesh, ref_logits)
        log(f"  tp=8 hier_rd+overlap tokens == {name} tokens on {n}/"
            f"{B * NEW} gated steps; teacher-forced logits (prefill path, "
            f"fused kernel at M={B * (PROMPT + NEW - 1)}) max|diff| "
            f"{mx:.4f}, mean {mean:.3e}")
        if mx > TF_MAX or mean > TF_MEAN:
            raise AssertionError(f"tp=8 hier_rd+overlap logits differ from "
                                 f"{name}'s")
    longer_prompt_recaptures(eng, prompts)
    return launches, decode_refs


def longer_prompt_recaptures(eng: InferenceEngine, prompts: np.ndarray,
                             longer: int = 768, new: int = 32) -> None:
    """A graph captured at one prompt length, then a generate whose prompt
    is longer than any the mesh has prefilled: under overlap its prefill
    grows kernel 5's buffers, which the graph holds, so the decode step
    must be captured anew (once) before it replays; the tokens bitwise the
    eager form's on the same prompts."""
    eng.cuda_graph = True
    eng.generate(prompts, 4)
    long_prompts = np.random.default_rng(SEED + 1).integers(
        0, eng.cfg.vocab_size, (prompts.shape[0], longer))
    g = eng.generate(long_prompts, new)
    eng.cuda_graph = False
    e = eng.generate(long_prompts, new)
    log(f"  prompt {prompts.shape[1]} -> {longer} after the capture: "
        f"{g.graph_recaptures} capture(s) anew, {g.graph_replays} replays; "
        f"tokens == eager: {np.array_equal(g.tokens, e.tokens)}")
    if g.graph_recaptures != 1 or not np.array_equal(g.tokens, e.tokens):
        raise AssertionError("a longer prompt after the capture: the step "
                             "was not captured anew once, or its tokens "
                             "differ from the eager form's")



# ---------------------------------------------------------------------------
# Phase 11: the group-quantized pack and unpack kernels (kernel 6)
# ---------------------------------------------------------------------------

QP_GROUPS = (1, 2, 64, 128)
# per element: pack |x|, the group max, the division, the rounding and the
# clip; unpack one multiply (f32, CUDA cores)
QP_OPS = {"quantize_pack": 5.0, "unpack_dequant": 1.0}


def qp_check(x: torch.Tensor, bits: int, group: int, label: str) -> None:
    """Kernel 6 against its plain version on x: payload, scales and
    dequant bitwise.  Where the plain scale is non-finite (a poisoned
    group) the kernel's scale and every dequantized element of the group
    must be non-finite too, and payload bytes of the group, which the
    contract leaves unspecified, are not compared."""
    q, s = quantize_pack(x, bits, group)
    qr, sr = quant_pack.quantize_pack_ref(x, bits, group)
    d = unpack_dequant(q, s, bits, group)
    dr = quant_pack.unpack_dequant_ref(qr, sr, bits, group)
    fin_s = torch.isfinite(sr)
    fin = fin_s.repeat_interleave(group, -1)
    byte_ok = fin if bits == 8 else fin.reshape(*fin.shape[:-1], -1,
                                                2).all(-1)
    ok = (torch.equal(torch.isfinite(s), fin_s)
          and torch.equal(s[fin_s], sr[fin_s])
          and torch.equal(d[fin], dr[fin])
          and not bool(torch.isfinite(d[~fin]).any())
          and torch.equal(q[byte_ok], qr[byte_ok]))
    if not ok:
        raise AssertionError(f"kernel 6 {label} bits={bits} group={group}: "
                             "kernel differs from its plain version")


def qp_bound(name: str, n: int, bits: int, group: int) -> tuple:
    """Each input read once and each output written once: f32 in, the
    payload and the bf16 scales out (pack), or the reverse (unpack)."""
    moved = 4.0 * n + n * bits / 8 + 2.0 * n / group
    return bound_ms(moved, QP_OPS[name] * n, torch.float32)


def phase_quant_kernels() -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    n_checked = 0
    for label, (rows, D) in QP_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((rows, D), generator=gen, device="cuda")
                 * 3).to(dtype)
            for bits in (8, 4):
                for group in QP_GROUPS:
                    qp_check(x, bits, group, f"{label} {rows}x{D} {dtype}")
                    n_checked += 1
    torch.cuda.synchronize()
    shapes = ", ".join(f"{k} {r}x{d}" for k, (r, d) in QP_SHAPES.items())
    log(f"  kernel 6 == plain version bitwise (payload, scales, dequant) on "
        f"{n_checked} cases: {shapes} x f32/bf16 x bits 8/4 x group "
        f"{'/'.join(map(str, QP_GROUPS))}")
    # exact ties: a group whose absmax is qmax has scale 1, so every
    # half-integer in it rounds half to even
    n_checked = 0
    for bits, qmax in ((8, 127), (4, 7)):
        for group in (2, 64, 128):
            half = (torch.randint(-2 * qmax, 2 * qmax + 1, (16, 1024),
                                  generator=gen, device="cuda") / 2.0)
            half.view(16, -1, group)[..., 0] = qmax
            qp_check(half, bits, group, "ties")
            n_checked += 1
    # non-finite values poison exactly their own group
    for bits in (8, 4):
        for group in QP_GROUPS:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((8, 1024), generator=gen,
                                device="cuda").to(dtype)
                for r, bad in enumerate((float("nan"), float("inf"),
                                         -float("inf"))):
                    x[r, 5 + 300 * r] = bad
                    x[r + 4, 1023 - 7 * r] = bad
                qp_check(x, bits, group, f"poisoned {dtype}")
                n_checked += 1
    # rows that end mid-tile, an odd row length (int8, group 1) and a
    # start one element past a 16-byte boundary
    for rows, D, bits, group in ((1, 1024, 8, 128), (7, 1024, 4, 64),
                                 (129, 256, 8, 2), (3, 4097, 8, 1),
                                 (5, 4098, 4, 2), (9, 64, 4, 64)):
        x = torch.empty(rows * D + 1, device="cuda")[1:].view(rows, D)
        x.copy_(torch.randn((rows, D), generator=gen, device="cuda"))
        qp_check(x, bits, group, f"unaligned {rows}x{D}")
        n_checked += 1
    torch.cuda.synchronize()
    log(f"  kernel 6 == plain version on {n_checked} more cases: exact ties "
        "(round half to even), NaN/+Inf/-Inf poisoning only their group, "
        "rows ending mid-tile, an odd row, an unaligned start")
    # back-to-back calls on fresh inputs at the decode RS shape, cycling
    # bits and groups, every result checked on the device (one sync)
    rows, D = QP_SHAPES["decode_rs"]
    x = torch.empty((rows, D), device="cuda")
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    cycle = ((8, 128), (4, 64), (8, 1), (4, 2))
    t0 = time.perf_counter()
    for i in range(1000):
        bits, group = cycle[i % 4]
        x.copy_(torch.randn((rows, D), generator=gen, device="cuda"))
        q, s = quantize_pack(x, bits, group)
        qr, sr = quant_pack.quantize_pack_ref(x, bits, group)
        d = unpack_dequant(q, s, bits, group)
        bad += ((q != qr).any() | (s != sr).any()
                | (d != quant_pack.unpack_dequant_ref(qr, sr, bits,
                                                      group)).any())
    torch.cuda.synchronize()
    log(f"  1000 back-to-back pack + unpack calls: {int(bad)} wrong "
        f"({time.perf_counter() - t0:.2f} s)")
    if int(bad):
        raise AssertionError("kernel 6: back-to-back calls disagree")
    rec = {}
    for label, (rows, D) in QP_SHAPES.items():
        x = torch.randn((rows, D), generator=gen, device="cuda")
        n = rows * D
        for bits, group in ((8, 128), (4, 64)):
            q, s = quantize_pack(x, bits, group)
            d = unpack_dequant(q, s, bits, group)
            # each wrapper's result against its plain version's (the
            # dequantized values of the two packs; the two unpacks)
            plain_q = quant_pack.quantize_pack_ref(x, bits, group)
            errs = {"quantize_pack": max_err(
                        d, quant_pack.unpack_dequant_ref(*plain_q, bits,
                                                         group)),
                    "unpack_dequant": max_err(
                        d, quant_pack.unpack_dequant_ref(q, s, bits, group))}
            t = {"quantize_pack": (
                time_ms(lambda: quantize_pack(x, bits, group)),
                time_ms(lambda: quant_pack.quantize_pack_ref(x, bits,
                                                              group))),
                 "unpack_dequant": (
                time_ms(lambda: unpack_dequant(q, s, bits, group)),
                time_ms(lambda: quant_pack.unpack_dequant_ref(q, s, bits,
                                                              group)))}
            for name, (ms, plain_ms) in t.items():
                bnd = qp_bound(name, n, bits, group)
                log(f"  {name} [f32 in/out] {label} {rows}x{D} bits={bits} "
                    f"group={group}: kernel_ms={ms:.4f} plain_ms="
                    f"{plain_ms:.4f} library_ms=null bound_ms={bnd[0]:.6f} "
                    f"({bnd[1]})")
                if label == "decode_rs" and bits == 8:   # the int8 path's
                    rec[name] = {"max_abs_err": errs[name], "ms": ms,
                                 "plain_ms": plain_ms, "library_ms": None,
                                 "bound_ms": bnd[0], "bound_by": bnd[1]}
    return rec


# ---------------------------------------------------------------------------
# Phase 11 (continued): the reduce-scatter's fused pack and unpack, and the
# quantized recursive doubling in one launch (quant_rd_allreduce.cu)
# ---------------------------------------------------------------------------

# The quantized wire's messages at tp=8 = 4 x 2, batch 8, prompt 512, f32:
# the reduce-scatter's input v (one rank's (B, S, d_model)), which it packs
# as 2 pieces of d_model / 2 (with the EF residue) and sums back from the
# all-to-all's transpose; the all-gather's shard (B, S, d_model / 2),
# packed and unpacked from the broadcast into the gathered layout; the slow
# phase's message, one rank's shard (B S d_model / 2 elements).
QF_MSG = {"decode": (B, 1, D_MODEL), "prefill": (B, PROMPT, D_MODEL)}
# Slow-phase cases beyond the path's: (pods, fast, m) with ragged m (a
# partial tile, an odd length that takes the scalar loads, fewer elements
# than a group) and both axes.
QRD_RAGGED = ((4, 2, B * D_MODEL // 2 + 37), (2, 1, 1000), (4, 1, 3),
              (2, 2, 4097), (4, 2, 256 * 129))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, and NaN exactly where the other has NaN (a poisoned
    group dequantizes to NaN on both sides)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(a[~na], b[~nb]))


def quant_rd_loop(t: torch.Tensor, axis: int, bits: int) -> torch.Tensor:
    """The slow phase as the parent tree composed it on the card: per step
    one pack, two unpacks, two index_selects of the payload and scales and
    an add, on the message padded to 256 in f32, through kernel 6's
    standalone wrappers (timed beside the kernel that replaced it)."""
    n = t.shape[axis]
    P, Fn = t.shape[:2]
    acc = t.reshape(P, Fn, -1).float()
    m = acc.shape[-1]
    pad = (-m) % 256
    if pad:
        acc = F.pad(acc, (0, pad))
    group = quant_pack.GROUP_CAP[bits]
    step = 1
    while step < n:
        q, s = quantize_pack(acc, bits, group)
        acc = (unpack_dequant(q, s, bits, group)
               + unpack_dequant(xor_exchange(q, axis, step),
                                xor_exchange(s, axis, step), bits, group))
        step <<= 1
    return acc[..., :m].reshape(t.shape).to(t.dtype)


def qrd_bound(R: int, m: int, esz: int) -> tuple:
    """x read once and out written once; per step and element the
    quantization (|x|, max, division, rounding, clip), two products and a
    sum in f32 (CUDA cores)."""
    steps = PODS.bit_length() - 1
    return bound_ms(2.0 * R * m * esz, 8.0 * steps * R * m, torch.float32)


def qrd_case(ws, t: torch.Tensor, axis: int, bits: int, label: str) -> None:
    out = quant_rd_all_reduce(t, axis, bits, workspace=ws)
    ref = quant_rd_all_reduce_ref(t, axis, bits)
    if not same_bits(out, ref):
        torch.cuda.synchronize()
        raise AssertionError(f"quant_rd_all_reduce {label} bits={bits}: "
                             f"differs from the plain loop (max|diff| "
                             f"{max_err(out.nan_to_num(), ref.nan_to_num())})")


def qrd_sweep(ws, gen) -> None:
    """The slow-phase kernel bitwise against the plain loop on the card:
    every layout with pods 2 / 4 and fast 1 / 2, int8 and int4, the decode
    and prefill messages, ragged lengths, bf16 operands, the fast axis,
    and NaN / +-Inf poisoning (NaN where the plain loop has NaN)."""
    n_checked = 0
    for pods in (2, 4):
        for fast in (1, 2):
            for stage, msg in QF_MSG.items():
                m = msg[0] * msg[1] * msg[2] // FAST
                t = torch.randn((pods, fast, m), generator=gen,
                                device="cuda")
                for bits in (8, 4):
                    qrd_case(ws, t, 0, bits, f"{pods}x{fast} {stage} m={m}")
                    n_checked += 1
    for pods, fast, m in QRD_RAGGED:
        t = torch.randn((pods, fast, m), generator=gen, device="cuda") * 3
        for bits in (8, 4):
            qrd_case(ws, t, 0, bits, f"{pods}x{fast} ragged m={m}")
            qrd_case(ws, t.to(torch.bfloat16), 0, bits,
                     f"{pods}x{fast} bf16 m={m}")
            n_checked += 2
    t = torch.randn((2, 4, 8192), generator=gen, device="cuda")
    for bits in (8, 4):
        qrd_case(ws, t, 1, bits, "2x4 over the fast axis")
        n_checked += 1
    shifted = torch.empty(PODS * FAST * 8192 + 1, device="cuda")[1:]
    shifted.copy_(torch.randn(shifted.shape, generator=gen, device="cuda"))
    for bits in (8, 4):
        qrd_case(ws, shifted.view(PODS, FAST, 8192), 0, bits,
                 "unaligned start")
        n_checked += 1
    for bits in (8, 4):
        t = torch.randn((PODS, FAST, 8192), generator=gen, device="cuda")
        for i, bad in enumerate((float("nan"), float("inf"),
                                 -float("inf"))):
            t[i, i % FAST, 300 * i + 5] = bad
        qrd_case(ws, t, 0, bits, "poisoned")
        n_checked += 1
    torch.cuda.synchronize()
    log(f"  quant_rd_all_reduce == plain loop bitwise on {n_checked} cases "
        "(pods 2/4 x fast 1/2 x decode/prefill x int8/int4; ragged and "
        "bf16; the fast axis; an unaligned start; NaN/+-Inf poisoning)")


def qrd_repeat(ws, gen, n: int = 1000) -> None:
    """Back-to-back calls on fresh inputs whose size and bits change, each
    checked on the device (one sync at the end)."""
    cycle = ((B * D_MODEL // 2, 8), (B * D_MODEL // 2 + 37, 4),
             (65536, 8), (1000, 4), (B * D_MODEL // 2, 4))
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for i in range(n):
        m, bits = cycle[i % len(cycle)]
        t = torch.randn((PODS, FAST, m), generator=gen, device="cuda")
        out = quant_rd_all_reduce(t, 0, bits, workspace=ws)
        bad += (out != quant_rd_all_reduce_ref(t, 0, bits)).any()
    torch.cuda.synchronize()
    log(f"  {n} back-to-back quant_rd_all_reduce calls (sizes "
        f"{sorted({c[0] for c in cycle})}, int8/int4 in turn): {int(bad)} "
        f"wrong ({time.perf_counter() - t0:.2f} s)")
    if int(bad):
        raise AssertionError("quant_rd_all_reduce: back-to-back calls "
                             "disagree")


def qrd_graph_replays(ws, gen, n: int = 200) -> None:
    """One call at the decode message captured in a CUDA graph and
    replayed ``n`` times on fresh inputs copied into its operand, each
    replay checked on the device (the epoch lives in device memory)."""
    m = B * D_MODEL // 2
    t = torch.randn((PODS, FAST, m), generator=gen, device="cuda")
    quant_rd_all_reduce(t, 0, 8, workspace=ws)     # workspace and caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant_rd_all_reduce(t, 0, 8, workspace=ws)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(n):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
        graph.replay()
        bad += (out != quant_rd_all_reduce_ref(t, 0, 8)).any()
    torch.cuda.synchronize()
    log(f"  {n} CUDA-graph replays of one captured quant_rd_all_reduce "
        f"({PODS}x{FAST} x {m} f32, int8): {int(bad)} wrong")
    if int(bad):
        raise AssertionError("quant_rd_all_reduce: graph replays disagree")
    del graph


def rs_views(v: torch.Tensor, bits: int, err: bool):
    """The trailing-dim reduce-scatter's operands of v (P, F, *lead, D):
    its pack of 2 pieces (with the EF residue) and the all-to-all's
    transposed views of the payload and scales."""
    n = v.shape[1]
    shard = v.shape[-1] // n
    group = quant_pack.group_for(shard, bits)
    packed = quantize_pack(v.reshape(*v.shape[:-1], n, shard), bits, group,
                           err=err)
    piece = packed[0].dim() - 2
    return packed, packed[0].transpose(1, piece), \
        packed[1].transpose(1, piece), group, piece


def quant_fused_checks(gen) -> None:
    """Pack-with-error and the strided unpack (the reduce-scatter's
    transposed pieces summed; the all-gather's broadcast written into the
    gathered layout) bitwise against their plain versions at the path's
    shapes, f32 and bf16 inputs, with NaN / Inf poisoning."""
    n_checked = 0
    for stage, msg in QF_MSG.items():
        for dtype in (torch.float32, torch.bfloat16):
            v = (torch.randn((PODS, FAST, *msg), generator=gen,
                             device="cuda") * 3).to(dtype)
            if stage == "decode":
                v[0, 1, 3, 0, 77] = float("nan")
                v[3, 0, 5, 0, 1500] = float("inf")
            for bits in (8, 4):
                (q, s, e), qv, sv, group, piece = rs_views(v, bits, True)
                qr, sr, er = quant_pack.quantize_pack_err_ref(
                    v.reshape(q.shape[:-1] + (-1,)), bits, group)
                fin = torch.isfinite(sr)
                if not (torch.equal(s[fin], sr[fin]) and same_bits(e, er)
                        and torch.equal(q[fin.repeat_interleave(
                            group * bits // 8, -1)],
                            qr[fin.repeat_interleave(group * bits // 8,
                                                     -1)])):
                    raise AssertionError(f"quantize_pack(err) {stage} "
                                         f"{dtype} bits={bits} differs")
                red = unpack_dequant(qv, sv, bits, group, piece_dim=piece)
                if not same_bits(red, quant_pack.unpack_dequant_sum_ref(
                        qv, sv, bits, group, piece)):
                    raise AssertionError(f"unpack_dequant(piece_dim) {stage}"
                                         f" {dtype} bits={bits} differs")
                # the all-gather of the reduced shard red (P, F, *lead, D/2)
                y = red.contiguous()
                g2 = quant_pack.group_for(y.shape[-1], bits)
                q2, s2 = quantize_pack(y, bits, g2)
                qg = q2.unsqueeze(1).expand(PODS, FAST, *q2.shape[1:])
                sg = s2.unsqueeze(1).expand(PODS, FAST, *s2.shape[1:])
                full = torch.empty((*y.shape[:-1], FAST, y.shape[-1]),
                                   device="cuda")
                unpack_dequant(qg, sg, bits, g2, out=full.movedim(-2, 2))
                if not same_bits(full.movedim(-2, 2),
                                 quant_pack.unpack_dequant_ref(qg, sg, bits,
                                                               g2)):
                    raise AssertionError(f"unpack_dequant(out) {stage} "
                                         f"{dtype} bits={bits} differs")
                n_checked += 3
    torch.cuda.synchronize()
    log(f"  pack with error, unpack-sum over the all-to-all's transpose and "
        f"unpack of the all-gather's broadcast into the gathered layout == "
        f"plain versions bitwise on {n_checked} cases (decode / prefill x "
        "f32 / bf16 x int8 / int4, decode with NaN and Inf)")


def quant_overlap_chunks(gen) -> None:
    """The quantized overlapped projection (core/overlap.py) on the card:
    y and EF bitwise equal across chunk counts 1, 2 and 4 (each a real
    split: _quant_chunk_ok holds), int8 and int4, 4 x 2 hier_rd.  cuBLAS
    takes another kernel for a column block than for the whole product,
    so a block of a random-normal GEMM is not bitwise the same columns of
    the whole one (printed); x and w are small integers (w scaled by
    2^-5), whose products' sums are exact in any order, so the check
    holds the quantized wire, not the GEMM, to chunk invariance."""
    R = PODS * FAST
    mesh, ctx = mesh_and_ctx(R, PODS, ar_strategy="hier_rd", device="cuda")
    xr = torch.randn((R, B, 1, 256), generator=gen, device="cuda")
    wr = torch.randn((R, 256, 4096), generator=gen, device="cuda")
    gemm = max_err(overlap.project(xr, wr)[..., :2048],
                   overlap.project(xr, wr[..., :2048]))
    log(f"  random-normal f32 GEMM, a 2048-column block against the same "
        f"columns of the 4096-column product: max|diff| {gemm:.3e}")
    x = torch.randint(-3, 4, (R, B, 1, 256), generator=gen,
                      device="cuda").float()
    w = torch.randint(-3, 4, (R, 256, 4096), generator=gen,
                      device="cuda").float() / 32
    ef0 = 0.01 * torch.randn((R, B, 1, 4096), generator=gen, device="cuda")
    for quant in ("int8", "int4"):
        c = ctx.replace(ar_quant=quant, overlap_matmul=True)
        bits = hierarchical.QUANT_BITS[quant]
        res = {}
        for k in (1, 2, 4):
            if k > 1 and not overlap._quant_chunk_ok(4096, k, R, bits):
                raise AssertionError(f"{k} chunks would not split")
            res[k] = overlap.collective_matmul(x, w, c, mesh, chunks=k,
                                               ef=ef0)
        for k in (2, 4):
            if not (torch.equal(res[k][0], res[1][0])
                    and torch.equal(res[k][1], res[1][1])):
                raise AssertionError(f"quantized overlap {quant}: {k} chunks"
                                     " differ from one")
    log("  quantized overlapped projection (4x2 hier_rd, int8 / int4, EF "
        "on): y and EF bitwise equal across 1, 2 and 4 chunks")


def phase_quant_fused() -> dict:
    """The slow-phase kernel, pack-with-error and the strided unpack:
    checks, then each timed beside the parent tree's composition, its
    plain version and its bound."""
    ws = RDWorkspace()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    qrd_sweep(ws, gen)
    qrd_repeat(ws, gen)
    qrd_graph_replays(ws, gen)
    quant_fused_checks(gen)
    quant_overlap_chunks(gen)
    rec = {}
    R = PODS * FAST
    for stage, msg in QF_MSG.items():
        m = msg[0] * msg[1] * msg[2] // FAST
        t = torch.randn((PODS, FAST, m), generator=gen, device="cuda")
        for bits in (8, 4):
            out = quant_rd_all_reduce(t, 0, bits, workspace=ws)
            err = max_err(out, quant_rd_all_reduce_ref(t, 0, bits))
            ms = (time_ms(lambda: quant_rd_all_reduce(t, 0, bits,
                                                      workspace=ws)),
                  time_ms(lambda: quant_rd_loop(t, 0, bits)),
                  time_ms(lambda: quant_rd_all_reduce_ref(t, 0, bits)))
            bnd = qrd_bound(R, m, 4)
            log(f"  quant_rd_all_reduce [f32] {stage} {PODS}x{FAST} x {m} "
                f"bits={bits}: kernel_ms={ms[0]:.4f} parent_loop_ms="
                f"{ms[1]:.4f} plain_ms={ms[2]:.4f} library_ms=null "
                f"bound_ms={bnd[0]:.6f} ({bnd[1]}); workspace "
                f"{ws.nbytes / 2**20:.1f} MiB")
            if stage == "decode" and bits == 8:
                rec = {"max_abs_err": err, "ms": ms[0], "plain_ms": ms[2],
                       "library_ms": None, "bound_ms": bnd[0],
                       "bound_by": bnd[1], "parent_loop_ms": ms[1]}
        # the reduce-scatter's pack with its EF residue, and its unpack-sum
        v = torch.randn((PODS, FAST, *msg), generator=gen, device="cuda")
        for bits in (8, 4):
            (q, s, e), qv, sv, group, piece = rs_views(v, bits, True)
            x2 = v.reshape(q.shape[:-1] + (-1,))
            n = x2.numel()
            pb = n * bits / 8 + 2.0 * n / group
            t_pack = (time_ms(lambda: quantize_pack(x2, bits, group,
                                                    err=True)),
                      time_ms(lambda: x2 - unpack_dequant(
                          *quantize_pack(x2, bits, group), bits, group)),
                      time_ms(lambda: quant_pack.quantize_pack_err_ref(
                          x2, bits, group)))
            b_pack = bound_ms(4.0 * n + pb + 4.0 * n, 6.0 * n, torch.float32)
            t_unp = (time_ms(lambda: unpack_dequant(qv, sv, bits, group,
                                                    piece_dim=piece)),
                     time_ms(lambda: unpack_dequant(
                         qv.contiguous(), sv.contiguous(), bits,
                         group).sum(-2)),
                     time_ms(lambda: quant_pack.unpack_dequant_sum_ref(
                         qv, sv, bits, group, piece)))
            b_unp = bound_ms(pb + 4.0 * n / FAST, 2.0 * n, torch.float32)
            for name, t3, bnd in (("pack+err", t_pack, b_pack),
                                  ("unpack-sum", t_unp, b_unp)):
                log(f"  {name} [f32] {stage}_rs {tuple(v.shape)} bits="
                    f"{bits} group={group}: kernel_ms={t3[0]:.4f} "
                    f"parent_ms={t3[1]:.4f} plain_ms={t3[2]:.4f} "
                    f"bound_ms={bnd[0]:.6f} ({bnd[1]})")
    return rec


# ---------------------------------------------------------------------------
# Phases 12-13: the quantized wire at full size
# ---------------------------------------------------------------------------

# Teacher-forced bf16 logits of the decode path on the quantized wire
# (error feedback on) against flat's and tp=1's decode paths: (max |diff|,
# mean |diff|) per wire width, about 1.5x the first measurement on the
# H100 (int8 0.283 / 0.0377, int4 3.48 / 0.479; PERF.md), below the
# planted faults (max 7.7-9.4, mean 1.10-1.12).
QUANT_TF = {8: (0.6, 0.06), 4: (5.0, 0.7)}
# Card against CPU at tp=8 under int8 (f32, 2 layers): a sum taken in
# another order flips roundings of the int8 wire at near-ties; on the CPU
# alone a 1e-7 relative perturbation of the weights moves these logits by
# 0.096 (0.113 card against CPU in the first run).
QUANT_CPU_TOL = 0.25


@contextlib.contextmanager
def planted_quant_fault(kind: str):
    """A deliberate fault in the quantized wire, for the negative control
    of the logits gate: ``no_scale`` unpacks the payload with every scale
    taken as 1, ``skip_slow`` leaves out the quantized slow exchange
    (each rank keeps its pod's partial)."""
    if kind == "no_scale":
        real = quant_pack.unpack_dequant
        patch = mock.patch.object(
            hierarchical.qp, "unpack_dequant",
            lambda q, s, bits, group, **kw: real(q, torch.ones_like(s), bits,
                                                 group, **kw))
    else:
        patch = mock.patch.object(hierarchical, "quant_rd_all_reduce",
                                  lambda t, axis, bits, workspace=None: t)
    with patch:
        yield


# kernel launches of the quantized wire, in quant_ar_launches' order
QUANT_KERNELS = ("quantize_pack", "unpack_dequant", "quant_rd_all_reduce")


def quant_ar_launches(strategy: str) -> tuple:
    """(packs, unpacks, quantized RD launches) of one quantized
    tp_all_reduce on the PODS x FAST mesh, with or without error feedback,
    as core/hierarchical.py dispatches it: per reduce-scatter stage (both
    axes under flat, the fast axis otherwise) one pack, which also writes
    the EF residue at the first, and one unpack that reads the received
    pieces through the all-to-all's transpose and sums them; under
    hier_rd and hier_rd_halving one launch of the quantized recursive
    doubling over the pods; per all-gather stage one pack and one unpack.
    No payload is copied."""
    stages = sum(n > 1 for n in ((PODS, FAST) if strategy == "flat"
                                 else (FAST,)))
    rd = int(strategy in ("hier_rd", "hier_rd_halving") and PODS > 1)
    return 2 * stages, 2 * stages, rd


def quant_path_launches(choices: dict, L: int, overlap_chunks: int = 0
                        ) -> dict:
    """Launches of one generate whose prefill and decode call sites
    resolve to ``choices`` ("prefill"/"decode" -> (strategy, quant)):
    2 L projections (in overlap column blocks where the quantized wire
    keeps them, see overlap._quant_chunk_ok) and the embedding's
    all-reduce per step (error feedback on the decode projections changes
    no count)."""
    n = {"flash_attention": L, "decode_attention": L * (NEW - 1)}
    for stage, steps in (("prefill", 1), ("decode", NEW - 1)):
        strategy, quant = choices[stage]
        if quant == "none":
            if strategy == "hier_rd":
                fused = overlap_chunks > 0
                n["collective_matmul_rd"] = n.get("collective_matmul_rd",
                                                  0) + fused * 2 * L * steps
                n["rd_all_reduce"] = n.get("rd_all_reduce", 0) + steps * (
                    1 + (not fused) * 2 * L)
            continue
        bits = hierarchical.QUANT_BITS[quant]
        k = 1
        if overlap_chunks:
            k = overlap._resolve_chunks(D_MODEL, FAST, overlap_chunks)
            if not overlap._quant_chunk_ok(D_MODEL, k, PODS * FAST, bits):
                k = 1
        per_ar = quant_ar_launches(strategy)
        for name, c in zip(QUANT_KERNELS, per_ar):
            n[name] = n.get(name, 0) + steps * (2 * L * k + 1) * c
    return n


def phase_quant(decode_refs: dict) -> dict:
    """hier_rd on the int8 and int4 wire, error feedback on."""
    cfg = get_config("llama3.2-1b")
    L = cfg.n_layers
    ap = make_plan(cfg, PODS * FAST)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT))
    launches = {}
    for quant in ("int8", "int4"):
        limits = QUANT_TF[hierarchical.QUANT_BITS[quant]]
        qctx = ctx.replace(ar_quant=quant)
        expect = quant_path_launches({"prefill": ("hier_rd", quant),
                                      "decode": ("hier_rd", quant)}, L)
        eng = InferenceEngine(ap, model, ctx=qctx, mesh=mesh, s_max=S_MAX,
                              device="cuda")
        key = f"tp8_hier_rd_{quant}"
        res, launches[key] = run_path(eng, prompts, f"tp=8 hier_rd {quant}",
                                      expect)
        if quant == "int8":
            profile_generate(eng, prompts, share_of="quant")
        for name, (ref, want) in decode_refs.items():
            want = want.to("cuda")
            mine = teacher_forced_decode(model, ref, ap, qctx, mesh)
            mx, mean = gate(f"{quant} vs {name}, decode path, EF on", mine,
                            want, limits)
            if mx > limits[0] or mean > limits[1]:
                raise AssertionError(f"tp=8 hier_rd {quant} logits differ "
                                     f"from {name}'s")
            n = provable_gate(res.tokens, ref, mine, want, PROMPT)
            log(f"    tp=8 hier_rd {quant} tokens == {name} tokens on {n}/"
                f"{B * NEW} steps whose gap allows no flip (fully equal on "
                f"{int((res.tokens == ref).all(1).sum())}/{B} rows)")
            for kind in ("no_scale", "skip_slow"):
                with planted_quant_fault(kind):
                    bad = teacher_forced_decode(model, ref, ap, qctx, mesh)
                fmx, fmean = gate(f"  planted fault {kind}", bad, want,
                                  limits)
                if fmx <= limits[0] and fmean <= limits[1]:
                    raise AssertionError(f"the {quant} logits gate passed "
                                         f"the planted fault {kind}")
            no_ef = teacher_forced_decode(model, ref, ap, qctx, mesh,
                                          ef=False)
            gate(f"  {quant} vs {name}, EF off (printed only)", no_ef,
                 want, limits)
    return launches


def phase_auto_quant(decode_refs: dict) -> dict:
    """The paper's deployment on the quantized wire: auto strategy, auto
    quantization, overlapped projections."""
    cfg = get_config("llama3.2-1b")
    L = cfg.n_layers
    ap = make_plan(cfg, PODS * FAST)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="auto",
                             device="cuda")
    ctx = ctx.replace(ar_quant="auto", overlap_matmul=True, overlap_chunks=4)
    model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT))
    tuner = autotune.AutoTuner()
    choices = {}
    for stage, msg in (("decode", B * D_MODEL * 2),
                       ("prefill", B * PROMPT * D_MODEL * 2)):
        c = tuner.choose(msg, FAST, PODS, "bfloat16", quant="auto")
        choices[stage] = (c.strategy, c.quant)
        log(f"  auto/auto picks for the {stage} message ({msg} B a rank): "
            f"{c}")
    expect = quant_path_launches(choices, L, overlap_chunks=4)
    eng = InferenceEngine(ap, model, ctx=ctx, mesh=mesh, s_max=S_MAX,
                          ar_table=tuner, device="cuda")
    res, got = run_path(eng, prompts, "tp=8 auto/auto+overlap", expect)
    bits = min(hierarchical.QUANT_BITS.get(q, 16) for _, q in
               choices.values())
    limits = QUANT_TF.get(bits, (TF_MAX, TF_MEAN))
    for name, (ref, want) in decode_refs.items():
        want = want.to("cuda")
        with autotune.using(tuner):
            mine = teacher_forced_decode(model, ref, ap, ctx, mesh)
        mx, mean = gate(f"auto/auto+overlap vs {name}, decode path", mine,
                        want, limits)
        if mx > limits[0] or mean > limits[1]:
            raise AssertionError(f"tp=8 auto/auto+overlap logits differ from "
                                 f"{name}'s")
        n = provable_gate(res.tokens, ref, mine, want, PROMPT)
        log(f"  tp=8 auto/auto+overlap tokens == {name} tokens on {n}/"
            f"{B * NEW} steps whose gap allows no flip (fully equal: "
            f"{np.array_equal(res.tokens, ref)})")
    return {"tp8_auto_quant_overlap": got}


# ---------------------------------------------------------------------------
# Phase 15: the grouped expert FFN kernel (kernel 7)
# ---------------------------------------------------------------------------

# The MoE path: qwen3-moe-30b-a3b (128 experts, top 8, d_ff 768 an
# expert), batch 8, prompt 128, 16 new tokens.
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PROMPT, MOE_NEW = 128, 16
MOE_E, MOE_K, MOE_F = 128, 8, 768
# Kernel 7's operands on the path, (E, C, D, F, G) with x (G, C, D): the
# prefill dispatch at tp=1 (capacity ceil(1024 * 8 / 128 * 1.25) = 80 rows
# an expert) and at tp=8 (16 experts a rank, 8 ranks x capacity 10 rows
# each: the same operand); the dense decode path at tp=1 (every expert on
# the batch's 8 tokens, one shared token block) and at tp=8 (each rank's
# 16 experts on its copy of the tokens: 8 blocks).
MOE_SHAPES = {"prefill": (MOE_E, 80, D_MODEL, MOE_F, MOE_E),
              "decode": (MOE_E, B, D_MODEL, MOE_F, 1),
              "decode_tp8": (MOE_E, B, D_MODEL, MOE_F, PODS * FAST)}
# tests/test_kernels.py's MOE_CASES, and one shape off the 16-byte path
# dbrx-132b's expert widths (d_model 6144, d_ff 10752 an expert) at 4
# experts: a decode block shared by every expert (C 8) and a dispatch
# block each (C 80); 1.59 GB of weights in bf16.  Past one CTA's shared
# memory, so kernel 7 tiles D.
MOE_WIDE = {"C8": (4, 8, 6144, 10752, 1), "C80": (4, 80, 6144, 10752, 4)}
MOE_SMALL = ((4, 128, 64, 128, 4), (2, 100, 128, 200, 2),
             (8, 256, 64, 96, 8), (3, 13, 72, 50, 3), (8, 5, 40, 24, 2))


def moe_operands(gen, E, C, D, Fh, G, dtype):
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    return (rnd(G, C, D), rnd(E, D, Fh, scale=D ** -0.5),
            rnd(E, D, Fh, scale=D ** -0.5), rnd(E, Fh, D, scale=Fh ** -0.5))


def bmm_chain(x, wg, wu, wd):
    """The informative yardstick: three cuBLAS bmm's and the gating in
    the operands' type (no single PyTorch call computes this function)."""
    E, G = wg.shape[0], x.shape[0]
    xe = x if G == E else x.expand(E, *x.shape[1:]) if G == 1 \
        else x.repeat_interleave(E // G, dim=0)
    return torch.bmm(F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu), wd)


def moe_bound(E, C, D, Fh, G, dtype) -> tuple:
    """Each weight read once, x (G blocks) read once, out written once;
    6 E C D F operations at the peak of the operands' type."""
    esz = torch.empty((), dtype=dtype).element_size()
    return bound_ms((3 * E * D * Fh + G * C * D + E * C * D) * esz,
                    6.0 * E * C * D * Fh, dtype)


def phase_moe_wide(gen) -> dict:
    """Kernel 7 at wide d_model: the f32 two-launch form (D tiled, h
    staged) bitwise equal to its one-launch form at a D both take, then
    dbrx-132b's expert widths (``MOE_WIDE``: bf16 tiles D inside the CTA,
    f32 takes two launches) in bf16 and f32 within TOL of the plain
    version and bitwise equal to a second call; kernel, plain version and
    bmm chain timed against the bound.  Returns the bf16 record by
    shape."""
    smem = _build.c_function("moe_gemm", "moe_ffn_smem_bytes",
                             (ctypes.c_int, ctypes.c_int))
    for D in (D_MODEL, 4096, MOE_WIDE["C8"][2]):
        for is_bf16, esz in ((1, 2), (0, 4)):
            if smem(D, is_bf16) != moe_gemm_ops.smem_bytes(D, esz):
                raise AssertionError("moe_gemm: the wrapper's shared-memory "
                                     "size differs from the kernel's")
        log(f"  d_model {D}: a CTA needs bf16 {smem(D, 1)} B (tensor cores, "
            f"any D), f32 {smem(D, 0)} B (one launch); D columns a CTA: "
            f"bf16 {moe_gemm_ops.d_tile(D, 2)}, f32 "
            f"{moe_gemm_ops.d_tile(D, 4)}")
    ops = moe_operands(gen, 4, 24, 3072, 1000, 4, torch.float32)
    one = moe_expert_ffn(*ops)                      # fits: one launch
    with mock.patch.object(moe_gemm_ops, "d_tile", lambda D, esz: 2048):
        two = moe_expert_ffn(*ops)
    torch.cuda.synchronize()
    if not torch.equal(one, two):
        raise AssertionError("moe_expert_ffn: the f32 D-tiled form differs "
                             "from the one-launch form")
    log("  (4, 24, 3072, 1000, 4) f32: D tiled by 2048 == one launch, "
        "bitwise")
    del ops, one, two
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape in MOE_WIDE.items():
            ops = moe_operands(gen, *shape, dtype)
            out = moe_expert_ffn(*ops)
            again = moe_expert_ffn(*ops)
            ref = moe_expert_ffn_ref(*ops)
            torch.cuda.synchronize()
            err = check_close(f"moe_expert_ffn dbrx {name} {shape}", out, ref,
                              dtype)
            if not torch.equal(out, again):
                raise AssertionError(f"moe_expert_ffn {shape}: two calls "
                                     "differ")
            t = (time_ms(lambda: moe_expert_ffn(*ops), reps=5),
                 time_ms(lambda: moe_expert_ffn_ref(*ops), reps=5),
                 time_ms(lambda: bmm_chain(*ops), reps=5))
            bnd = moe_bound(*shape, dtype)
            log(f"  moe_expert_ffn dbrx {name} {shape} [{str(dtype)[6:]}]: "
                f"kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} "
                f"bmm_chain_ms={t[2]:.4f} (library_ms=null) "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            if dtype == torch.bfloat16:
                rec[name] = {"max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                             "bmm_chain_ms": t[2], "bound_ms": bnd[0],
                             "bound_by": bnd[1]}
            del ops, out, again, ref
            free_device()
    return rec


def phase_moe_kernel() -> dict:
    """Kernel 7 within TOL of its plain version, and bitwise equal to
    itself on a second call, on the CPU tests' cases, a shape off the
    16-byte path and the three path shapes, in bf16 and f32; 1000
    back-to-back calls on fresh inputs, each checked; kernel, plain
    version and bmm chain timed at the path shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    smem = _build.c_function("moe_gemm", "moe_ffn_smem_bytes",
                             (ctypes.c_int, ctypes.c_int))
    log(f"  shared memory a CTA at d_model {D_MODEL}: bf16 "
        f"{smem(D_MODEL, 1)} B, f32 {smem(D_MODEL, 0)} B")
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in MOE_SMALL + tuple(MOE_SHAPES.values()):
            ops = moe_operands(gen, *shape, dtype)
            out = moe_expert_ffn(*ops)
            again = moe_expert_ffn(*ops)
            ref = moe_expert_ffn_ref(*ops)
            torch.cuda.synchronize()
            err = check_close(f"moe_expert_ffn {shape}", out, ref, dtype)
            if not torch.equal(out, again):
                raise AssertionError(f"moe_expert_ffn {shape}: two calls "
                                     "differ")
            if dtype == torch.bfloat16:
                log(f"    max|kernel-split form| = "
                    f"{max_err(out, moe_expert_ffn_split_ref(*ops)):.3e}")
            name = next((k for k, v in MOE_SHAPES.items() if v == shape),
                        None)
            if name is None:
                continue
            t = (time_ms(lambda: moe_expert_ffn(*ops)),
                 time_ms(lambda: moe_expert_ffn_ref(*ops)),
                 time_ms(lambda: bmm_chain(*ops)))
            bnd = moe_bound(*shape, dtype)
            log(f"  moe_expert_ffn {name} {shape} [{str(dtype)[6:]}]: "
                f"kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} "
                f"bmm_chain_ms={t[2]:.4f} (library_ms=null) "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            if dtype == torch.bfloat16 and name == "decode":
                rec = {"max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                       "library_ms": None, "bmm_chain_ms": t[2],
                       "bound_ms": bnd[0], "bound_by": bnd[1]}
            del ops, out, again, ref
    # the plan never looks at G: one shared block == E copies, bitwise
    E, C, D, Fh, _ = MOE_SHAPES["decode"]
    x, wg, wu, wd = moe_operands(gen, E, C, D, Fh, 1, torch.bfloat16)
    one = moe_expert_ffn(x, wg, wu, wd)
    copies = moe_expert_ffn(x.expand(E, C, D).contiguous(), wg, wu, wd)
    torch.cuda.synchronize()
    if not torch.equal(one, copies):
        raise AssertionError("moe_expert_ffn: one shared token block "
                             "differs from E copies of it")
    log(f"  ({E}, {C}, {D}, {Fh}) bf16: G = 1 == G = {E}, bitwise")
    del x, wg, wu, wd, one, copies
    rec["dbrx"] = phase_moe_wide(gen)
    E, C, D, Fh, G = 16, 24, D_MODEL, MOE_F, 16
    x, wg, wu, wd = moe_operands(gen, E, C, D, Fh, G, torch.bfloat16)
    bad = 0
    for i in range(1000):
        x.normal_(generator=gen)
        out = moe_expert_ffn(x, wg, wu, wd)
        ref = moe_expert_ffn_ref(x, wg, wu, wd)
        tol = TOL[torch.bfloat16]
        bad += int(not torch.allclose(out.float(), ref.float(), atol=tol,
                                      rtol=tol))
    torch.cuda.synchronize()
    log(f"  1000 back-to-back calls ({E}, {C}, {D}, {Fh}) bf16: {bad} wrong")
    if bad:
        raise AssertionError("moe_expert_ffn: back-to-back calls disagree")
    return rec


# ---------------------------------------------------------------------------
# Phases 16-18: qwen3-moe-30b-a3b
# ---------------------------------------------------------------------------


def free_device() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def moe_launches(L: int, new: int, strategy: str = "") -> dict:
    """Launches of one MoE generate: flash once a layer; the decode kernel
    once a layer a step; kernel 7 once a layer in prefill (the dispatch)
    and once a layer a step (the dense path); under hier_rd the RD kernel
    on the embedding's and each attention wo's all-reduce in prefill (the
    dispatch has none) and on the embedding's, wo's and the MoE combine's
    in decode."""
    n = {"flash_attention": L, "decode_attention": L * (new - 1),
         "moe_expert_ffn": L * new}
    if strategy == "hier_rd":
        n["rd_all_reduce"] = (L + 1) + (2 * L + 1) * (new - 1)
    return n


def phase_moe_path() -> dict:
    """qwen3-moe-30b-a3b at tp=1, full width, PATH_LAYERS deep, bf16:
    dense and paged, exact launches, paged tokens == dense tokens, one
    profile."""
    free_device()
    full_depth = get_config(MOE_ARCH).n_layers
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=PATH_LAYERS[MOE_ARCH])
    ap = make_plan(cfg, 1)
    t0 = time.perf_counter()
    model = init_params(ap, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} of {full_depth} layers, d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, "
        f"{n_params / 1e9:.3f} B parameters in {cfg.dtype} (router f32), "
        f"drawn in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, MOE_PROMPT))
    L, s_max = cfg.n_layers, MOE_PROMPT + MOE_NEW
    launches, tokens = {}, {}
    for layout, bsz in (("dense", 0), ("paged", BLOCK)):
        expect = moe_launches(L, MOE_NEW)
        if bsz:
            expect["paged_decode_attention"] = expect.pop("decode_attention")
        eng = InferenceEngine(ap, model, s_max=s_max, block_size=bsz,
                              device="cuda")
        res, launches[f"moe_tp1_{layout}"] = run_path(
            eng, prompts, f"qwen3-moe tp=1 {layout}", expect, new=MOE_NEW)
        tokens[layout] = res.tokens
        if layout == "dense":
            profile_generate(eng, prompts, share_of="moe_ffn", new=MOE_NEW)
    if not np.array_equal(tokens["dense"], tokens["paged"]):
        raise AssertionError("qwen3-moe: paged tokens differ from dense")
    log("  paged tokens == dense tokens")
    del model, eng
    free_device()
    return launches


@contextlib.contextmanager
def planted_moe_fault(kind: str):
    """A deliberate fault in the MoE layer, for the negative control of
    the logits gate: ``rank0_experts`` gives every rank the expert offset
    of rank 0 in the dense decode path, ``no_all_to_all`` leaves out the
    dispatch's EP exchange (each rank runs its own tokens through the
    experts of the ranks they were meant for)."""
    if kind == "rank0_experts":
        patch = mock.patch.object(
            hierarchical, "ep_rank", lambda ctx, mesh, device=None:
            torch.zeros(mesh.size, dtype=torch.long, device=device))
    else:
        patch = mock.patch.object(hierarchical, "ep_all_to_all",
                                  lambda t, ctx, mesh: t)
    with patch:
        yield


def phase_moe_tp() -> dict:
    """qwen3-moe-30b-a3b at full width, 4 layers, capacity_factor E/K (no
    pair overflows at any tp), float32: tp=8 (4 x 2) under hier_rd and
    flat against tp=1, exact launches, tokens by provable_gate, decode-path
    teacher-forced logits within (TF_MAX, TF_MEAN), which two planted
    faults in the MoE layer must break.  float32, not bf16: in bf16 the
    router's top-k flips where two experts' scores are within the
    roundings that another reduction order moves the residual by, and a
    flipped expert moves that token's logits by O(1) (on the CPU, smoke
    widths, 3 layers: tp=8 against tp=1 max 1.14, mean 0.030 in bf16,
    4.5e-7 mean in f32), so bf16 would test the router's margins, not the
    wiring."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=4,
                              capacity_factor=MOE_E / MOE_K,
                              dtype=torch.float32)
    L, s_max = cfg.n_layers, MOE_PROMPT + MOE_NEW
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, MOE_PROMPT))
    tf = dict(prompt=MOE_PROMPT, s_max=s_max)
    ap1 = make_plan(cfg, 1)
    model1 = init_params(ap1, seed=SEED, device="cuda")
    launches = {}
    res1, launches["moe_tp1_4l"] = run_path(
        InferenceEngine(ap1, model1, s_max=s_max, device="cuda"), prompts,
        "qwen3-moe 4 layers tp=1", moe_launches(L, MOE_NEW), new=MOE_NEW)
    ref = res1.tokens
    want = teacher_forced_decode(model1, ref, ap1, **tf)
    del model1
    free_device()
    ap = make_plan(cfg, PODS * FAST)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
    log(f"  tp={ap.tp} on {mesh}: ep={ctx.ep}, "
        f"{cfg.n_experts // ap.tp} experts a rank, GQA g={ap.gqa.g} "
        f"u={ap.gqa.u}, capacity_factor {cfg.capacity_factor:g}")
    for strategy in ("hier_rd", "flat"):
        sctx = ctx.replace(ar_strategy=strategy)
        eng = InferenceEngine(ap, model, ctx=sctx, mesh=mesh, s_max=s_max,
                              device="cuda")
        res, launches[f"moe_tp8_{strategy}"] = run_path(
            eng, prompts, f"qwen3-moe 4 layers tp=8 {strategy}",
            moe_launches(L, MOE_NEW, strategy), new=MOE_NEW)
        mine = teacher_forced_decode(model, ref, ap, sctx, mesh, **tf)
        mx, mean = gate(f"tp=8 {strategy} vs tp=1, decode path", mine, want)
        if mx > TF_MAX or mean > TF_MEAN:
            raise AssertionError(f"qwen3-moe tp=8 {strategy} logits differ "
                                 "from tp=1's")
        n = provable_gate(res.tokens, ref, mine, want, MOE_PROMPT)
        log(f"    tp=8 {strategy} tokens == tp=1 tokens on {n}/"
            f"{B * MOE_NEW} steps whose gap allows no flip (fully equal: "
            f"{np.array_equal(res.tokens, ref)})")
        if strategy != "hier_rd":
            continue
        for kind in ("rank0_experts", "no_all_to_all"):
            with planted_moe_fault(kind):
                bad = teacher_forced_decode(model, ref, ap, sctx, mesh, **tf)
            fmx, fmean = gate(f"  planted fault {kind}", bad, want)
            if fmx <= TF_MAX and fmean <= TF_MEAN:
                raise AssertionError(f"the MoE logits gate passed the "
                                     f"planted fault {kind}")
    del model, mesh
    free_device()
    return launches


# ---------------------------------------------------------------------------
# Phase 19: the RWKV6 time-mix scan kernel (kernel 8)
# ---------------------------------------------------------------------------

# The RWKV path: rwkv6-7b (64 heads of 64 channels), batch 8, prompt 512,
# 64 new tokens (tp=1); 4 layers f32, 16 new tokens at tp=8.
RWKV_ARCH = "rwkv6-7b"
RWKV_H, RWKV_HD = 64, 64
RWKV_TP_LAYERS, RWKV_TP_NEW = 4, 16
# Kernel 8's operands on the path, (N, T, H, hd, G): prefill and decode at
# tp=1, and the tp=8 prefill with the 8 ranks folded into the sequences
# (8 heads a rank, one bonus group a rank).
RWKV_SHAPES = {"prefill": (B, PROMPT, RWKV_H, RWKV_HD, 1),
               "decode": (B, 1, RWKV_H, RWKV_HD, 1),
               "prefill_tp8": (PODS * FAST * B, PROMPT,
                               RWKV_H // (PODS * FAST), RWKV_HD, PODS * FAST)}
# tests/test_kernels.py's RWKV_CASES (G = 1)
RWKV_SMALL = ((2, 128, 2, 64, 1), (1, 100, 3, 64, 1), (2, 64, 1, 32, 1))
# Ragged at the kernel's tile split: 3 heads of 32 (one warp a head, four
# key groups), T not a multiple of the chunk.
RWKV_RAGGED = ((2, 77, 3, 32, 1),)
# tests/test_kernels.py's tolerance.  The kernel's fused multiply-adds and
# sum order against the plain version's: on the CPU the plain version at
# T 512 is within 3.3e-5 of a float64 run (|y| up to 114).
RWKV_TOL = dict(atol=2e-4, rtol=1e-3)
# The decode path's teacher-forced logits against the full-sequence forward
# over the same tokens (max |diff|, mean |diff|).  In bf16 (phase 20) the
# two round at other places (cuBLAS takes other GEMM kernels for 8 rows
# than for 4600), which 32 layers compound: about 2x the first measurement
# on the H100 (max 0.2969, mean 3.581e-02; PERF.md).  In f32 (phase 21, 4
# layers) the same comparison is a sum-order difference.
RWKV_STEP_BF16 = (0.6, 0.07)
RWKV_STEP_F32 = (1e-3, 1e-4)


def rwkv_operands(gen, N, T, H, hd, G, logw=None):
    """The CPU tests' draws: r/k/v normal, log decay -exp(U(-6, -0.5)) (or
    the constant ``logw``), u and s0 0.1 x normal; all f32 on the card."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    lw = -torch.exp(torch.rand((N, T, H, hd), generator=gen, device="cuda")
                    * 5.5 - 6.0) if logw is None \
        else torch.full((N, T, H, hd), logw, device="cuda")
    return (rnd(N, T, H, hd), rnd(N, T, H, hd), rnd(N, T, H, hd), lw,
            rnd(G, H, hd, scale=0.1), rnd(N, H, hd, hd, scale=0.1))


def rwkv_check(label: str, ops) -> float:
    y, s = rwkv6_scan(*ops)
    ry, rs = rwkv6_scan_ref(*ops)
    torch.cuda.synchronize()
    err = max(max_err(y, ry), max_err(s, rs))
    ok = torch.allclose(y, ry, **RWKV_TOL) and torch.allclose(s, rs,
                                                              **RWKV_TOL)
    log(f"  {label}: max|kernel-plain| = {err:.3e} (atol "
        f"{RWKV_TOL['atol']:g}, rtol {RWKV_TOL['rtol']:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def decode_steps_equal_one_call(scan, ops, out_kw: str,
                                prompt: int = 100) -> bool:
    """A ``prompt``-step call, then one single-step call a remaining step,
    each updating the state in place as the decode path does (the kernels'
    T = 1 form), bitwise equal to one call over all the steps."""
    *seq, p, st0 = ops
    y, s = scan(*seq, p, st0)
    ys, st = scan(*(t[:, :prompt].contiguous() for t in seq), p, st0)
    ys = [ys]
    for i in range(prompt, seq[0].shape[1]):
        ys.append(scan(*(t[:, i:i + 1].contiguous() for t in seq), p, st,
                       **{out_kw: st})[0])
    torch.cuda.synchronize()
    return torch.equal(torch.cat(ys, 1), y) and torch.equal(st, s)


def rwkv_bound(N, T, H, hd, G) -> tuple:
    """r/k/v/logw read and y written once, s0 read and the final state
    written once, u read once (f32); per step and head the kv outer
    product, the decayed state and its sum (3 hd^2), y's dot (2 hd^2) and
    the bonus (4 hd), on the CUDA cores."""
    return bound_ms((5 * N * T * H * hd + 2 * N * H * hd * hd + G * H * hd)
                    * 4, N * T * H * (5.0 * hd * hd + 4 * hd), torch.float32)


def phase_rwkv_kernel() -> dict:
    """Kernel 8 within RWKV_TOL of its plain version on the CPU tests'
    shapes, constant decays past the reference's clamp and the path's
    shapes; chained and in-place calls bitwise equal to one call; kernel,
    plain version and bound timed at the path's shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    times = {}
    for shape in RWKV_SMALL + RWKV_RAGGED + tuple(RWKV_SHAPES.values()):
        ops = rwkv_operands(gen, *shape)
        err = rwkv_check(f"rwkv6_scan {shape}", ops)
        name = next((k for k, v in RWKV_SHAPES.items() if v == shape), None)
        if name is None:
            continue
        t = (time_ms(lambda: rwkv6_scan(*ops)),
             time_ms(lambda: rwkv6_scan_ref(*ops), reps=3))
        bnd = rwkv_bound(*shape)
        log(f"  rwkv6_scan {name} {shape}: kernel_ms={t[0]:.4f} "
            f"plain_ms={t[1]:.4f} (library_ms=null) bound_ms={bnd[0]:.4f} "
            f"({bnd[1]})")
        times[name] = (err, t, bnd)
        del ops
    for c in (-1.0, -2.0, -5.0):
        rwkv_check(f"rwkv6_scan constant logw {c:g}, T 100 (64-step decay "
                   f"sum {64 * c:g})",
                   rwkv_operands(gen, 2, 100, 4, 64, 2, logw=c))
    # two chained calls (the second stepping its state in place, as decode
    # does) and an aliased s0 / s_out: bitwise equal to one plain call of
    # the kernel, whose arithmetic does not depend on where T is cut
    r, k, v, lw, u, s0 = rwkv_operands(gen, 16, 300, 8, 64, 4)
    y, s = rwkv6_scan(r, k, v, lw, u, s0)
    y1, st = rwkv6_scan(*(t[:, :123].contiguous() for t in (r, k, v, lw)), u,
                        s0)
    y2, _ = rwkv6_scan(*(t[:, 123:].contiguous() for t in (r, k, v, lw)), u,
                       st, s_out=st)
    s_alias = s0.clone()
    y3, _ = rwkv6_scan(r, k, v, lw, u, s_alias, s_out=s_alias)
    torch.cuda.synchronize()
    chained = torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(st, s)
    aliased = torch.equal(y3, y) and torch.equal(s_alias, s)
    log(f"  two chained calls (T 123 + 177, the second in place) == one "
        f"call: {chained}; aliased s0/s_out == separate: {aliased}")
    if not (chained and aliased):
        raise AssertionError("rwkv6_scan: chained or in-place calls differ")
    stepped = decode_steps_equal_one_call(
        rwkv6_scan, rwkv_operands(gen, 16, 108, 8, 64, 4), "s_out")
    log(f"  a 100-step call, then 8 single-step calls each updating the "
        f"state in place (the decode form) == one 108-step call: {stepped}")
    if not stepped:
        raise AssertionError("rwkv6_scan: decode steps differ from one call")
    err, t, bnd = times["prefill"]
    derr, dt, dbnd = times["decode"]
    return {"max_abs_err": max(err, derr), "ms": t[0], "plain_ms": t[1],
            "library_ms": None, "bound_ms": bnd[0], "bound_by": bnd[1],
            "decode_ms": dt[0], "decode_plain_ms": dt[1],
            "decode_bound_ms": dbnd[0], "tp8_prefill_ms":
                times["prefill_tp8"][1][0]}


# ---------------------------------------------------------------------------
# Phases 20-22: rwkv6-7b
# ---------------------------------------------------------------------------


def rwkv_launches(L: int, new: int, strategy: str = "") -> dict:
    """Launches of one RWKV generate: kernel 8 once a layer in prefill and
    once a layer a decode step; under hier_rd the RD kernel on every
    all-reduce (the embedding's, then each layer's time-mix output and
    stacked channel-mix partial) in prefill and in each step."""
    n = {"rwkv6_scan": L * new}
    if strategy == "hier_rd":
        n["rd_all_reduce"] = (2 * L + 1) * new
    return n


def phase_rwkv_path() -> dict:
    """rwkv6-7b at tp=1, full width, PATH_LAYERS deep, bf16: exact
    launches, one profile, the decode path's logits against the full
    forward's, and a planted fault that gate must catch."""
    free_device()
    full_depth = get_config(RWKV_ARCH).n_layers
    cfg = dataclasses.replace(get_config(RWKV_ARCH),
                              n_layers=PATH_LAYERS[RWKV_ARCH])
    ap = make_plan(cfg, 1)
    t0 = time.perf_counter()
    model = init_params(ap, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} of {full_depth} layers, d_model "
        f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads of "
        f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B parameters in {cfg.dtype} (w0, u f32), "
        f"drawn in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, param_count() "
                             f"{cfg.param_count()}")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT))
    s_max = PROMPT + NEW
    eng = InferenceEngine(ap, model, s_max=s_max, device="cuda")
    res, launches = run_path(eng, prompts, "rwkv6-7b tp=1",
                             rwkv_launches(cfg.n_layers, NEW))
    # a shorter profiled run: the profiler's processing of a 64-token
    # generate's ~3e5 events costs about a minute of host time
    profile_generate(eng, prompts, share_of="rwkv6_scan", new=RWKV_TP_NEW)
    profile_generate(eng, prompts, share_of="rwkv6_scan", new=RWKV_TP_NEW,
                     graph=True)
    dec = teacher_forced_decode(model, res.tokens, ap, prompt=PROMPT,
                                s_max=s_max)
    full = teacher_forced(model, res.tokens, ap)[:, PROMPT - 1:]
    if not torch.isfinite(full).all():
        raise AssertionError("rwkv6-7b: non-finite logits")
    mx, mean = gate("decode path vs full-sequence forward over the "
                    "generated tokens", dec, full, RWKV_STEP_BF16)
    if mx > RWKV_STEP_BF16[0] or mean > RWKV_STEP_BF16[1]:
        raise AssertionError("rwkv6-7b: decode-path logits differ from the "
                             "full forward's")
    with stale_state():
        bad = teacher_forced_decode(model, res.tokens, ap, prompt=PROMPT,
                                    s_max=s_max)
    fmx, fmean = gate("  planted fault stale_state", bad, full,
                      RWKV_STEP_BF16)
    if fmx <= RWKV_STEP_BF16[0] and fmean <= RWKV_STEP_BF16[1]:
        raise AssertionError("the step-exact gate passed the planted fault "
                             "stale_state")
    del model, eng, dec, full, bad
    free_device()
    return {"rwkv_tp1": launches}


@contextlib.contextmanager
def stale_state():
    """A deliberate fault in the decode path, for the negative control of
    the step-exact gate: the time-mix step writes its new state to a fresh
    buffer, so the cache's state never advances past the prompt."""
    with mock.patch.object(rwkv, "rwkv_time_mix_step",
                           lambda p, x, state, cfg: rwkv._time_mix(
                               p, x, cfg, state["shift_tm"], state["wkv"],
                               None)):
        yield


@contextlib.contextmanager
def planted_rwkv_fault(kind: str):
    """A deliberate fault in the RWKV block, for the negative control of
    the logits gate: ``rank0_slice`` has every rank contract rank 0's
    slice of the channel-mix receptance input with its own rows of ``wr``;
    ``unreduced_receptance`` reduces only the value half of the stacked
    channel-mix partial, each rank gating with its own partial logit."""
    if kind == "rank0_slice":
        patch = mock.patch.object(
            rwkv, "_own_cols",
            lambda xr, dloc: xr[..., :dloc].contiguous())
    else:
        real = hierarchical.tp_all_reduce

        def value_half_only(x, ctx, mesh, scatter_dim=-1, ef=None):
            if x.dim() == 5 and x.shape[1] == 2:      # the stacked partial
                return torch.stack([real(x[:, 0], ctx, mesh, scatter_dim),
                                    x[:, 1]], dim=1)
            return real(x, ctx, mesh, scatter_dim, ef)
        patch = mock.patch.object(hierarchical, "tp_all_reduce",
                                  value_half_only)
    with patch:
        yield


def phase_rwkv_tp() -> dict:
    """rwkv6-7b at full width, 4 layers, float32: the tp=1 decode path
    against the full forward; tp=8 (4 x 2) under hier_rd and flat against
    tp=1, exact launches, tokens by
    provable_gate, decode-path teacher-forced logits within (TF_MAX,
    TF_MEAN), which two planted faults in the block's wiring must break.
    The seeded weights are the same numbers at both tps (no head slots,
    the vocab divides by 8)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(RWKV_ARCH), n_layers=RWKV_TP_LAYERS,
                              dtype=torch.float32)
    L, new, s_max = cfg.n_layers, RWKV_TP_NEW, PROMPT + RWKV_TP_NEW
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT))
    tf = dict(prompt=PROMPT, s_max=s_max)
    ap1 = make_plan(cfg, 1)
    model1 = init_params(ap1, seed=SEED, device="cuda")
    launches = {}
    res1, launches["rwkv_tp1_4l"] = run_path(
        InferenceEngine(ap1, model1, s_max=s_max, device="cuda"), prompts,
        "rwkv6-7b 4 layers tp=1", rwkv_launches(L, new), new=new)
    ref = res1.tokens
    want = teacher_forced_decode(model1, ref, ap1, **tf)
    mx, mean = gate("tp=1 decode path vs full-sequence forward", want,
                    teacher_forced(model1, ref, ap1)[:, PROMPT - 1:],
                    RWKV_STEP_F32)
    if mx > RWKV_STEP_F32[0] or mean > RWKV_STEP_F32[1]:
        raise AssertionError("rwkv6-7b f32: decode-path logits differ from "
                             "the full forward's")
    del model1
    free_device()
    ap = make_plan(cfg, PODS * FAST)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
    log(f"  tp={ap.tp} on {mesh}: {ap.rwkv_heads_local} heads a rank, "
        f"{model.blocks[0].cm['wr'].shape[1]} rows of the channel-mix wr a "
        "rank")
    for strategy in ("hier_rd", "flat"):
        sctx = ctx.replace(ar_strategy=strategy)
        eng = InferenceEngine(ap, model, ctx=sctx, mesh=mesh, s_max=s_max,
                              device="cuda")
        res, launches[f"rwkv_tp8_{strategy}"] = run_path(
            eng, prompts, f"rwkv6-7b 4 layers tp=8 {strategy}",
            rwkv_launches(L, new, strategy), new=new)
        mine = teacher_forced_decode(model, ref, ap, sctx, mesh, **tf)
        mx, mean = gate(f"tp=8 {strategy} vs tp=1, decode path", mine, want)
        if mx > TF_MAX or mean > TF_MEAN:
            raise AssertionError(f"rwkv6-7b tp=8 {strategy} logits differ "
                                 "from tp=1's")
        n = provable_gate(res.tokens, ref, mine, want, PROMPT)
        log(f"    tp=8 {strategy} tokens == tp=1 tokens on {n}/{B * new} "
            f"steps whose gap allows no flip (fully equal: "
            f"{np.array_equal(res.tokens, ref)})")
        if strategy != "hier_rd":
            continue
        for kind in ("rank0_slice", "unreduced_receptance"):
            with planted_rwkv_fault(kind):
                bad = teacher_forced_decode(model, ref, ap, sctx, mesh, **tf)
            fmx, fmean = gate(f"  planted fault {kind}", bad, want)
            if fmx <= TF_MAX and fmean <= TF_MEAN:
                raise AssertionError(f"the RWKV logits gate passed the "
                                     f"planted fault {kind}")
    del model, mesh
    free_device()
    return launches


# ---------------------------------------------------------------------------
# Phase 23: the Mamba selective-scan kernel (kernel 9)
# ---------------------------------------------------------------------------

# The hybrid path: hymba-1.5b (d_inner 3200, 16 states), batch 8, prompt
# 1280 (past the 1024 window), 64 new tokens (tp=1); 4 layers f32, 16 new
# tokens at tp=8.
HYB_ARCH = "hymba-1.5b"
HYB_CI, HYB_S, HYB_PROMPT = 3200, 16, 1280
HYB_TP_LAYERS, HYB_NEW_SHORT = 4, 16
# Kernel 9's operands on the path, (N, T, Ci, S, G): prefill and decode at
# tp=1, and the tp=8 prefill with the 8 ranks folded into the sequences
# (400 channels a rank, one A group a rank).
SSM_SHAPES = {"prefill": (B, HYB_PROMPT, HYB_CI, HYB_S, 1),
              "decode": (B, 1, HYB_CI, HYB_S, 1),
              "prefill_tp8": (PODS * FAST * B, HYB_PROMPT,
                              HYB_CI // (PODS * FAST), HYB_S, PODS * FAST)}
# tests/test_kernels.py's SSM_CASES (B, T, Ci, S; G = 1) and tolerance
SSM_SMALL = ((2, 128, 128, 16, 1), (1, 100, 64, 8, 1), (2, 64, 200, 16, 1))
# Ragged at the kernel's lane split: the last CTA of a sequence holds 12 of
# its 16 channels; Ci 301 takes the 4-byte copies of x and dt.  T is not a
# multiple of the chunk.
SSM_RAGGED = ((2, 77, 300, 8, 1), (2, 77, 300, 16, 1), (2, 77, 301, 16, 1))
SSM_TOL = dict(atol=1e-4, rtol=1e-4)
# The special-function units' exponentials: 16 a clock on each SM
# (CUDA programming guide, throughput table, compute capability 9.0) of
# the 132 at the 1.98 GHz boost clock of the published peaks.
SFU_PER_S = 16 * 132 * 1.98e9


def ssm_operands(gen, N, T, Ci, S, G, dt_max=0.1, a_max=4.0):
    """The JAX kernel test's draws: x, b, c normal, dt U(0.001, dt_max),
    a -U(0.5, a_max), h0 0.1 x normal; all f32 on the card."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")
    return (rnd(N, T, Ci), uni(0.001, dt_max, N, T, Ci), rnd(N, T, S),
            rnd(N, T, S), -uni(0.5, a_max, G, Ci, S), 0.1 * rnd(N, Ci, S))


def ssm_check(label: str, ops) -> float:
    y, h = ssm_scan(*ops)
    ry, rh = ssm_scan_ref(*ops)
    torch.cuda.synchronize()
    err = max(max_err(y, ry), max_err(h, rh))
    ok = torch.allclose(y, ry, **SSM_TOL) and torch.allclose(h, rh, **SSM_TOL)
    log(f"  {label}: max|kernel-plain| = {err:.3e} (atol "
        f"{SSM_TOL['atol']:g}, rtol {SSM_TOL['rtol']:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def ssm_bound(N, T, Ci, S, G, h0: bool) -> tuple:
    """x and dt read and y written once, b and c read once, a read once,
    h0 read (when given) and the final state written once (f32); N T Ci S
    exponentials on the special-function units, and per element dt a, the
    decayed state's FMA, the drive and y's FMA (6 operations) on the CUDA
    cores.  The larger of the three times bounds the call."""
    n_bytes = (3 * N * T * Ci + 2 * N * T * S + G * Ci * S
               + (2 if h0 else 1) * N * Ci * S) * 4
    elems = N * T * Ci * S
    t_bytes, t_exp = n_bytes / HBM_BYTES_PER_S * 1e3, elems / SFU_PER_S * 1e3
    t_ops = 6.0 * elems / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= max(t_exp, t_ops) \
        else (max(t_exp, t_ops), "operations")


def phase_ssm_kernel() -> dict:
    """Kernel 9 within SSM_TOL of its plain version on the JAX test's
    shapes, the path's shapes and decays that underflow; chained and
    in-place calls bitwise equal to one call; kernel, plain version and
    bound timed at the path's shapes (the prefill without h0, as the path
    calls it; decode updating h0 in place)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 23)
    times = {}
    for shape in SSM_SMALL + SSM_RAGGED + tuple(SSM_SHAPES.values()):
        ops = ssm_operands(gen, *shape)
        err = ssm_check(f"ssm_scan {shape}", ops)
        name = next((k for k, v in SSM_SHAPES.items() if v == shape), None)
        if name is None:
            continue
        if name == "decode":
            call = (*ops[:5], ops[5])
            kw = {"h_out": ops[5]}
        else:
            call, kw = ops[:5], {}
        t = (time_ms(lambda: ssm_scan(*call, **kw)),
             time_ms(lambda: ssm_scan_ref(*call), reps=3))
        bnd = ssm_bound(*shape, h0=name == "decode")
        log(f"  ssm_scan {name} {shape}: kernel_ms={t[0]:.4f} "
            f"plain_ms={t[1]:.4f} (library_ms=null) bound_ms={bnd[0]:.4f} "
            f"({bnd[1]})")
        times[name] = (err, t, bnd)
        del ops, call
    # dt up to 5 against A down to -24: decays down to exp(-120), past
    # f32's smallest normal (exp(-87.3)) and its smallest subnormal
    ops = ssm_operands(gen, 2, 200, 300, 16, 2, dt_max=5.0, a_max=24.0)
    low = float((ops[4].amin() * ops[1].amax()).item())
    ssm_check(f"ssm_scan dt up to 5, a down to -24 (log decay down to "
              f"{low:.1f})", ops)
    # two chained calls (the second stepping its state in place, as decode
    # does) and an aliased h0 / h_out: bitwise equal to one call of the
    # kernel, whose arithmetic does not depend on where T is cut
    x, dt, b, c, a, h0 = ssm_operands(gen, 16, 300, 500, 16, 4)
    y, h = ssm_scan(x, dt, b, c, a, h0)
    y1, st = ssm_scan(*(t[:, :123].contiguous() for t in (x, dt, b, c)), a,
                      h0)
    y2, _ = ssm_scan(*(t[:, 123:].contiguous() for t in (x, dt, b, c)), a,
                     st, h_out=st)
    h_alias = h0.clone()
    y3, _ = ssm_scan(x, dt, b, c, a, h_alias, h_out=h_alias)
    torch.cuda.synchronize()
    chained = torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(st, h)
    aliased = torch.equal(y3, y) and torch.equal(h_alias, h)
    log(f"  two chained calls (T 123 + 177, the second in place) == one "
        f"call: {chained}; aliased h0/h_out == separate: {aliased}")
    if not (chained and aliased):
        raise AssertionError("ssm_scan: chained or in-place calls differ")
    stepped = decode_steps_equal_one_call(
        ssm_scan, ssm_operands(gen, 16, 108, 500, 16, 4), "h_out")
    log(f"  a 100-step call, then 8 single-step calls each updating the "
        f"state in place (the decode form) == one 108-step call: {stepped}")
    if not stepped:
        raise AssertionError("ssm_scan: decode steps differ from one call")
    # b and c as the two halves of one (N, T, 2S) tensor, as the mixer
    # passes them: bitwise the contiguous copies' result
    for name in ("prefill", "decode"):
        N, T, Ci, S, G = SSM_SHAPES[name]
        x, dt, _, _, a, h0 = ssm_operands(gen, N, T, Ci, S, G)
        bc = torch.randn((N, T, 2 * S), generator=gen, device="cuda")
        got = ssm_scan(x, dt, bc[..., :S], bc[..., S:], a, h0)
        want = ssm_scan(x, dt, bc[..., :S].contiguous(),
                        bc[..., S:].contiguous(), a, h0)
        torch.cuda.synchronize()
        same = all(map(torch.equal, got, want))
        log(f"  {name}: b, c as views of one bc tensor == contiguous "
            f"copies: {same}")
        if not same:
            raise AssertionError("ssm_scan: strided b/c differ")
        del x, dt, bc, a, h0, got, want
    err, t, bnd = times["prefill"]
    derr, dt_, dbnd = times["decode"]
    return {"max_abs_err": max(err, derr), "ms": t[0], "plain_ms": t[1],
            "library_ms": None, "bound_ms": bnd[0], "bound_by": bnd[1],
            "decode_ms": dt_[0], "decode_plain_ms": dt_[1],
            "decode_bound_ms": dbnd[0], "tp8_prefill_ms":
                times["prefill_tp8"][1][0]}


# ---------------------------------------------------------------------------
# Phases 24-26: hymba-1.5b
# ---------------------------------------------------------------------------

# The decode path's teacher-forced logits against the full-sequence forward
# over the same tokens (max |diff|, mean |diff|).  In bf16 (phase 24) the
# two round at other places: cuBLAS takes other GEMM kernels for 8 rows
# than for 10240, and the reference's conv is rounded tap by tap in
# prefill and once in decode, which the port copies; 32 layers of this
# random-weight model amplify that to a plateau of about 0.4 mean after
# four decode steps.  About 1.5x the first measurement on the H100 (max
# 6.2344, mean 0.4128; PERF.md), below the planted fault's mean (1.046).
# In f32 (phase 25, 4 layers) the same comparison is a sum-order
# difference.
HYB_STEP_BF16 = (9.4, 0.62)
HYB_STEP_F32 = (1e-3, 1e-4)


def hybrid_launches(L: int, new: int, strategy: str = "",
                    paged: bool = False) -> dict:
    """Launches of one hybrid generate: flash once a layer; the (paged)
    decode kernel once a layer a step; kernel 9 once a layer in prefill and
    once a layer a decode step; under hier_rd the RD kernel on every
    all-reduce (the embedding's, then each layer's mixed attention + mamba
    partial and its MLP down projection) in prefill and in each step."""
    n = {"flash_attention": L,
         "paged_decode_attention" if paged else "decode_attention":
             L * (new - 1),
         "ssm_scan": L * new}
    if strategy == "hier_rd":
        n["rd_all_reduce"] = (2 * L + 1) * new
    return n


@contextlib.contextmanager
def frozen_ssm_state():
    """A deliberate fault in the decode path, for the negative control of
    the decode-path gate: kernel 9 writes each step's new state to a fresh
    buffer, so the cache's mamba state never advances past the prompt."""
    real = ssm.ssm_scan

    def no_update(x, dt, b, c, a, h0=None, h_out=None):
        return real(x, dt, b, c, a, h0)
    with mock.patch.object(ssm, "ssm_scan", no_update):
        yield


@contextlib.contextmanager
def planted_hybrid_fault(kind: str):
    """A deliberate fault in the hybrid block, for the negative control of
    the tp=8 logits gate: ``rank0_channels`` has every rank's sequences
    read rank 0's A group in kernel 9 (the A group index wrong);
    ``unreduced_ssm`` leaves the mamba partial out of the mixed reduction,
    each rank adding its own partial."""
    if kind == "rank0_channels":
        real = ssm.ssm_scan

        def group0(x, dt, b, c, a, h0=None, h_out=None):
            return real(x, dt, b, c, a[:1].contiguous(), h0, h_out=h_out)
        patch = mock.patch.object(ssm, "ssm_scan", group0)
    else:
        def unreduced(x, beta, attn, ssm_out, ctx, mesh, sp=False):
            b = beta.to(attn.dtype)
            return x + hierarchical.tp_all_reduce(
                b[:, :1, None, None] * attn, ctx, mesh, scatter_dim=-1) \
                + b[:, 1:, None, None] * ssm_out
        patch = mock.patch.object(transformer, "_mixed_residual", unreduced)
    with patch:
        yield


def plant_a_log(model, mesh, seed: int) -> None:
    """Seeded per-channel A_log (log U(1, 16)) in every layer, cut over the
    mesh as the sharding rules cut it: the reference's init puts A = -[1..s]
    on every channel, which would make the ranks' A groups equal and an A
    group fault invisible.  The same numbers at every tp."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for bp in model.blocks:
        R, ci, s = bp.ssm["A_log"].shape
        g = torch.log(1 + 15 * torch.rand((R * ci, s), generator=gen,
                                          device="cuda"))
        bp.ssm["A_log"].copy_(shard_params({"ssm": {"A_log": g}},
                                           mesh)["ssm"]["A_log"])


def step_gate(label: str, dec: torch.Tensor, full: torch.Tensor,
              limits: tuple) -> None:
    mx, mean = gate(label, dec, full, limits)
    if not torch.isfinite(full).all():
        raise AssertionError(f"{label}: non-finite logits")
    if mx > limits[0] or mean > limits[1]:
        raise AssertionError(f"{label}: decode-path logits differ from the "
                             "full forward's")


def phase_hybrid_path() -> dict:
    """hymba-1.5b at tp=1, full width, PATH_LAYERS deep, bf16: dense and
    paged with exact launches, paged tokens == dense tokens, one profile
    (16 new tokens), the decode path's logits against the full forward's
    within HYB_STEP_BF16, and a planted fault that gate must catch."""
    free_device()
    full_depth = get_config(HYB_ARCH).n_layers
    cfg = dataclasses.replace(get_config(HYB_ARCH),
                              n_layers=PATH_LAYERS[HYB_ARCH])
    ap = make_plan(cfg, 1)
    t0 = time.perf_counter()
    model = init_params(ap, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} of {full_depth} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
        f"{cfg.head_dim}, window {cfg.sliding_window}, d_inner "
        f"{cfg.d_inner}, {cfg.ssm_state} states, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.3f} B parameters in "
        f"{cfg.dtype} (A_log, D_skip, dt_bias, beta f32), drawn in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, param_count() "
                             f"{cfg.param_count()}")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, HYB_PROMPT))
    L, s_max = cfg.n_layers, HYB_PROMPT + NEW
    launches, tokens = {}, {}
    for layout, bsz in (("dense", 0), ("paged", BLOCK)):
        eng = InferenceEngine(ap, model, s_max=s_max, block_size=bsz,
                              device="cuda")
        key = "hymba_tp1" if not bsz else "hymba_tp1_paged"
        res, launches[key] = run_path(
            eng, prompts, f"hymba-1.5b tp=1 {layout}",
            hybrid_launches(L, NEW, paged=bool(bsz)))
        tokens[layout] = res.tokens
        if not bsz:
            # a shorter profiled run: the profiler's processing of a
            # 64-token generate's events costs about a minute of host time
            for graph in (False, True):
                profile_generate(eng, prompts,
                                 share_of=("ssm_scan", "decode_attention"),
                                 new=HYB_NEW_SHORT, graph=graph)
    if not np.array_equal(tokens["dense"], tokens["paged"]):
        raise AssertionError("hymba-1.5b: paged tokens differ from dense")
    log("  paged tokens == dense tokens")
    tf = dict(prompt=HYB_PROMPT, s_max=s_max)
    dec = teacher_forced_decode(model, tokens["dense"], ap, **tf)
    full = teacher_forced(model, tokens["dense"], ap)[:, HYB_PROMPT - 1:]
    step_gate("decode path vs full-sequence forward over the generated "
              "tokens", dec, full, HYB_STEP_BF16)
    by_step = (dec.float() - full.float()).abs().mean(dim=(0, 2)).tolist()
    log(f"    mean |diff| by step: {' '.join(f'{v:.4f}' for v in by_step[:6])}"
        f" ... {by_step[-1]:.4f}")
    # informative: the decode conv rounded tap by tap, as prefill rounds it
    with mock.patch.object(ssm, "_conv_step", lambda hist, w, b:
                           ssm._causal_conv(hist, w, b)[:, :, -1]):
        tap = teacher_forced_decode(model, tokens["dense"], ap, **tf)
    gate("  (printed only) the decode conv rounded tap by tap", tap, full,
         HYB_STEP_BF16)
    with frozen_ssm_state():
        bad = teacher_forced_decode(model, tokens["dense"], ap, **tf)
    fmx, fmean = gate("  planted fault frozen_ssm_state", bad, full,
                      HYB_STEP_BF16)
    if fmx <= HYB_STEP_BF16[0] and fmean <= HYB_STEP_BF16[1]:
        raise AssertionError("the decode-path gate passed the planted fault "
                             "frozen_ssm_state")
    del model, eng, dec, full, bad, tap
    free_device()
    return launches


def phase_hybrid_tp() -> dict:
    """hymba-1.5b at full width, 4 layers, float32, with per-channel A_log
    planted (``plant_a_log``): the tp=1 decode path against the full
    forward within HYB_STEP_F32; tp=8 (4 x 2: 25 q / 5 kv heads in 32 / 16
    slots, 7 and 1 dead; d_inner 400 a rank) under hier_rd and flat
    against tp=1, exact launches of kernels 4 and 9, tokens by
    provable_gate, the decode path's teacher-forced logits within (TF_MAX,
    TF_MEAN), which two planted faults in the block's wiring must break.
    The seeded weights are one function at both tps (the vocab, 32001, is
    drawn unpadded and zero-padded to 32008 at tp=8)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(HYB_ARCH), n_layers=HYB_TP_LAYERS,
                              dtype=torch.float32)
    L, new = cfg.n_layers, HYB_NEW_SHORT
    s_max = HYB_PROMPT + new
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, HYB_PROMPT))
    tf = dict(prompt=HYB_PROMPT, s_max=s_max)
    ap1 = make_plan(cfg, 1)
    model1 = init_params(ap1, seed=SEED, device="cuda")
    plant_a_log(model1, None, SEED + 25)
    launches = {}
    res1, launches["hymba_tp1_4l"] = run_path(
        InferenceEngine(ap1, model1, s_max=s_max, device="cuda"), prompts,
        "hymba-1.5b 4 layers tp=1", hybrid_launches(L, new), new=new)
    ref = res1.tokens
    # the logits over the real vocab: tp=8 pads it to 32008 with zero
    # columns, which greedy sampling masks
    V = cfg.vocab_size
    want = teacher_forced_decode(model1, ref, ap1, **tf)[..., :V]
    step_gate("tp=1 decode path vs full-sequence forward", want,
              teacher_forced(model1, ref, ap1)[:, HYB_PROMPT - 1:, :V],
              HYB_STEP_F32)
    del model1
    free_device()
    ap = make_plan(cfg, PODS * FAST)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
    plant_a_log(model, mesh, SEED + 25)
    log(f"  tp={ap.tp} on {mesh}: GQA g={ap.gqa.g} u={ap.gqa.u} "
        f"({list(ap.gqa.q_map).count(-1)} dead q slots, "
        f"{list(ap.gqa.kv_map).count(-1)} dead kv slot), d_inner "
        f"{ap.d_inner_local} a rank, vocab padded to {ap.vocab_pad}")
    for strategy in ("hier_rd", "flat"):
        sctx = ctx.replace(ar_strategy=strategy)
        eng = InferenceEngine(ap, model, ctx=sctx, mesh=mesh, s_max=s_max,
                              device="cuda")
        res, launches[f"hymba_tp8_{strategy}"] = run_path(
            eng, prompts, f"hymba-1.5b 4 layers tp=8 {strategy}",
            hybrid_launches(L, new, strategy), new=new)
        mine = teacher_forced_decode(model, ref, ap, sctx, mesh,
                                     **tf)[..., :V]
        mx, mean = gate(f"tp=8 {strategy} vs tp=1, decode path", mine, want)
        if mx > TF_MAX or mean > TF_MEAN:
            raise AssertionError(f"hymba-1.5b tp=8 {strategy} logits differ "
                                 "from tp=1's")
        n = provable_gate(res.tokens, ref, mine, want, HYB_PROMPT)
        log(f"    tp=8 {strategy} tokens == tp=1 tokens on {n}/{B * new} "
            f"steps whose gap allows no flip (fully equal: "
            f"{np.array_equal(res.tokens, ref)})")
        if strategy != "hier_rd":
            continue
        for kind in ("rank0_channels", "unreduced_ssm"):
            with planted_hybrid_fault(kind):
                bad = teacher_forced_decode(model, ref, ap, sctx, mesh,
                                            **tf)[..., :V]
            fmx, fmean = gate(f"  planted fault {kind}", bad, want)
            if fmx <= TF_MAX and fmean <= TF_MEAN:
                raise AssertionError(f"the hybrid logits gate passed the "
                                     f"planted fault {kind}")
    del model, mesh
    free_device()
    return launches


# ---------------------------------------------------------------------------
# Phase 27: the continuous batcher
# ---------------------------------------------------------------------------

# llama3.2-1b served from a make_trace trace: 32 requests, prompts and
# outputs lognormal around 256 and 64 tokens, arrivals at 0.5 a step (a
# request holds a slot about 64 steps, so 8 slots free one every ~8 steps
# and a queue forms: the slots stay full).
SERVE_SLOTS, SERVE_REQS, SERVE_RATE = 8, 32, 0.5
# The depth of llama3.2-1b in phases 27-30 (the batcher's trace and every
# path that reads its tokens: chunked admission, spec, the prefix cache,
# faults, disagg, the router, the int8 KV cache and int8 weights), cut
# from 16 layers to keep the whole script inside its time limit; full
# width, every gate and reference at this same depth.
SERVE_LAYERS = 12


def serve_config():
    return dataclasses.replace(get_config("llama3.2-1b"),
                               n_layers=SERVE_LAYERS)
SERVE_MEAN_IN, SERVE_MEAN_OUT = 256, 64
SERVE_STATS: dict = {}
SERVE_OUTS: dict = {}     # phase 27's tokens, the references of phase 28


def fresh(reqs):
    return [Request(r.rid, r.prompt, r.max_new, r.arrival_s) for r in reqs]


def serve_run(b: ContinuousBatcher, reqs) -> tuple:
    """One replay of the trace: ({rid: tokens}, metrics)."""
    done = b.run(fresh(reqs))
    return {r.rid: r.output for r in done}, b.metrics(done)


def same_outputs(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def serve_timed(label: str, b: ContinuousBatcher, reqs,
                reps: int = 1) -> tuple:
    """A warm-up replay (it captures the step and meets every prompt
    length once), then ``reps`` timed ones, each with the same tokens;
    throughput, TTFT and TPOT as medians of them.  One timed replay by
    default, which keeps the script inside the call's limit."""
    first, _ = serve_run(b, reqs)
    ms = []
    for _ in range(reps):
        outs, m = serve_run(b, reqs)
        if not same_outputs(outs, first):
            raise AssertionError(f"{label}: a replay changed the tokens")
        ms.append(m)

    def med(f):
        return float(np.median([getattr(m, f) for m in ms]))

    st = {f: med(f) for f in ("throughput_tok_s", "ttft_s_p50", "ttft_s_p99",
                              "tpot_s_p50", "tpot_s_p99", "wall_s", "steps")}
    SERVE_STATS[label] = st
    m = ms[-1]
    log(f"  {label}: {m.completed}/{m.requests} requests, "
        f"{m.total_new_tokens} tokens in {m.steps} steps "
        f"({b.graph_replays} replayed so far), {m.preemptions} preemptions; "
        f"throughput {st['throughput_tok_s']:.1f} tok/s, TTFT p50/p99 "
        f"{st['ttft_s_p50'] * 1e3:.2f}/{st['ttft_s_p99'] * 1e3:.2f} ms, TPOT "
        f"p50/p99 {st['tpot_s_p50'] * 1e3:.3f}/{st['tpot_s_p99'] * 1e3:.3f} "
        f"ms ({reps} timed replay(s); throughput "
        + "/".join(f"{x.throughput_tok_s:.1f}" for x in ms) + ")")
    if m.completed != m.requests:
        raise AssertionError(f"{label}: requests left unserved")
    return first, m


class ForcedDecode:
    """Decode-path logits teacher-forced on given sequences, ``rows`` of
    them at a time through one dense cache and one captured step: each
    prompt prefilled alone (batch 1, as the batcher admits it) into its
    row, then its own tokens fed one step at a time.  A GEMM's rounding
    depends on its row count, not on the other rows, so with the row count
    of the path being checked (the batcher's slots, or 1 for a batch-1
    generate) each row's logits are that path's, row for row."""

    def __init__(self, model, ap, rows: int, ctx=None, mesh=None, *,
                 chunk: int = 0, verify_k: int = 0, prefill_with=None,
                 kv_quant: bool = False):
        """``chunk`` > 0: each prompt admitted through chunks of that many
        tokens (``prefill_chunk`` into its row, the batcher's chunked
        admission) instead of one full prefill.  ``verify_k`` > 0: the
        tokens fed as the verify step feeds them, k + 1 at a time through
        ``prefill_chunk`` over all rows (the drafts all accepted), instead
        of one decode step a token.  ``prefill_with`` = (model, ap) at
        tp=1: each prompt prefilled there and its K/V handed over as a
        disaggregated prefill pool hands it (a bundle spliced into the
        row), the first token's logits that pool's.  ``kv_quant``: the
        rows live in the int8 cache."""
        self.model, self.ap, self.rows, self.mesh = model, ap, rows, mesh
        self.chunk, self.verify_k = chunk, verify_k
        self.prefill_with = prefill_with
        self.kw = {} if mesh is None else {"ctx": ctx, "mesh": mesh}
        self.cache = init_cache(ap, rows, S_MAX, device="cuda", mesh=mesh,
                                kv_quant=kv_quant)
        self.tok = torch.zeros(rows, dtype=torch.int32, device="cuda")
        self.pos = torch.zeros(rows, dtype=torch.int32, device="cuda")
        self.out = torch.zeros((rows, ap.cfg.vocab_size), device="cuda")

        def body():
            with torch.inference_mode():
                lg, _ = decode_step(model, self.cache, self.tok, self.pos,
                                    ap, **self.kw)
                self.out.copy_(self.full(lg))

        self.step = CapturedStep(body, graph=True,
                                 workspace=getattr(mesh, "workspace", None))

    def full(self, lg: torch.Tensor) -> torch.Tensor:
        lg = lg if self.mesh is None else gather_vocab(lg)
        return lg[..., :self.ap.cfg.vocab_size].float()

    def logits(self, seqs) -> list:
        """seqs: [(prompt, output)] -> [(len(output), V) f32]: row t holds
        the logits that chose output token t."""
        res = []
        for g0 in range(0, len(seqs), self.rows):
            group = seqs[g0:g0 + self.rows]
            per = []
            with torch.inference_mode():
                for i, (p, _) in enumerate(group):
                    per.append([self.admit(p, i)])
            if self.verify_k:
                res += self.verify_logits(group, per)
                continue
            tok = np.zeros(self.rows, np.int32)
            pos = np.zeros(self.rows, np.int32)
            for t in range(1, max(len(o) for _, o in group)):
                for i, (p, o) in enumerate(group):
                    tok[i] = o[min(t, len(o)) - 1]
                    pos[i] = min(len(p) + t - 1, S_MAX - 1)
                self.tok.copy_(torch.from_numpy(tok))
                self.pos.copy_(torch.from_numpy(pos))
                self.step()
                for i, (_, o) in enumerate(group):
                    if t < len(o):
                        per[i].append(self.out[i].clone())
            res += [torch.stack(x) for x in per]
        return res

    def admit(self, p: np.ndarray, i: int) -> torch.Tensor:
        """Prefill prompt ``p`` into row i (one full prefill, or chunk by
        chunk); the logits of its last position, (V,)."""
        if self.prefill_with is not None:
            pm, pap = self.prefill_with
            lg, st = forward_lm(pm, torch.as_tensor(p[None], device="cuda")
                                .long(), pap, collect_state=True)
            bundle = states_bundle(st["k"], st["v"], pap.gqa.kv_map)
            k, v = bundle_states(bundle, self.ap.gqa.kv_map, self.ap.gqa.u,
                                 "cuda")
            seed_cache(self.cache, {"k": k, "v": v}, slot=i)
            return lg[0, -1, :self.ap.cfg.vocab_size].float()
        if not self.chunk:
            lg, st = forward_lm(self.model, torch.as_tensor(
                p[None], device="cuda").long(), self.ap,
                collect_state=True, **self.kw)
            seed_cache(self.cache, st, slot=i)
            return self.full(lg[..., -1, :])[0]
        C, S = self.chunk, len(p)
        padded = np.zeros(-(-S // C) * C, np.int64)
        padded[:S] = p
        slot = torch.tensor([i], device="cuda")
        for c0 in range(0, len(padded), C):
            lg, _ = transformer.prefill_chunk(
                self.model, self.cache, torch.as_tensor(
                    padded[None, c0:c0 + C], device="cuda"),
                torch.arange(c0, c0 + C, dtype=torch.int32,
                             device="cuda")[None], self.ap, slot=slot,
                return_logits=c0 + C >= S, **self.kw)
        return self.full(lg[..., (S - 1) % C, :])[0]

    def verify_logits(self, group, per) -> list:
        """Each row's own tokens fed k + 1 at a time over all rows (rows
        past their sequence repeat their last token, past the cache at its
        last position): row i's logits at output positions 1, 2, ..."""
        C = self.verify_k + 1
        T = max(len(o) for _, o in group)
        tok = np.zeros((self.rows, C), np.int64)
        pos = np.zeros((self.rows, C), np.int32)
        for t in range(1, T, C):
            for i, (p, o) in enumerate(group):
                for j in range(C):
                    tok[i, j] = o[min(t - 1 + j, len(o) - 1)]
                    pos[i, j] = min(len(p) + t - 1 + j, S_MAX - 1)
            with torch.inference_mode():
                lg, _ = transformer.prefill_chunk(
                    self.model, self.cache, torch.as_tensor(tok,
                                                            device="cuda"),
                    torch.as_tensor(pos, device="cuda"), self.ap, **self.kw)
            full = self.full(lg)
            for i, (_, o) in enumerate(group):
                for j in range(C):
                    if t + j < len(o):
                        per[i].append(full[i, j].clone())
        return [torch.stack(x) for x in per]


def serve_gate(label: str, reqs, outs: dict, ref: dict, lg: list,
               ref_lg: list, *, limits: tuple = (), floor: float = 0.0
               ) -> int:
    """provable_gate over a served trace: each request's tokens equal the
    reference's at every step until the first at which the reference
    path's top-1/top-2 gap is not above twice the two paths' largest logit
    difference (both teacher-forced on the reference's tokens).  The two
    paths' teacher-forced logits' max and mean |diff| are printed and,
    with ``limits`` (max, mean), held to them: a path that computes
    another function (a position or a key offset wrong) breaks those where
    rounding does not.  With ``floor`` the gate must check at least that
    share of the steps."""
    checked, mx, tot, cnt = 0, 0.0, 0.0, 0
    for r, a, b in zip(reqs, lg, ref_lg):
        gap = top2_gap(b)
        d = (a - b).abs()
        diff = d.amax(-1).cpu().numpy()
        mx, tot, cnt = max(mx, float(diff.max())), tot + float(d.sum()), \
            cnt + d.numel()
        want, got = ref[r.rid], outs[r.rid]
        for t in range(len(want)):
            if gap[t] <= 2 * diff[t]:
                break
            if t >= len(got) or got[t] != want[t]:
                raise AssertionError(f"{label}: request {r.rid} step {t}: "
                                     f"tokens differ with gap {gap[t]:.4g} "
                                     f"above twice {diff[t]:.4g}")
            checked += 1
    n = sum(len(ref[r.rid]) for r in reqs)
    mean = tot / cnt
    log(f"  {label}: tokens equal on {checked}/{n} steps that provable_gate "
        "checks (gap above twice the paths' logit difference); "
        f"teacher-forced logits max|diff| {mx:.4f}, mean {mean:.3e}"
        + (f" (limits {limits[0]:g}, {limits[1]:g})" if limits else "")
        + (f", at least {floor:g} of the steps checked" if floor else ""))
    if limits and (mx > limits[0] or mean > limits[1]):
        raise AssertionError(f"{label}: teacher-forced logits differ by "
                             f"{mx:.4g} (max) / {mean:.4g} (mean), limits "
                             f"{limits}")
    if checked < floor * n:
        raise AssertionError(f"{label}: provable_gate checked only "
                             f"{checked}/{n} steps")
    return checked


def phase_serve() -> None:
    cfg = serve_config()
    reqs = make_trace(SERVE_REQS, mean_in=SERVE_MEAN_IN,
                      mean_out=SERVE_MEAN_OUT, rate=SERVE_RATE,
                      vocab=cfg.vocab_size, seed=SEED)
    lens = [len(r.prompt) for r in reqs]
    log(f"  trace: {len(reqs)} requests, prompts {min(lens)}-{max(lens)} "
        f"(mean {np.mean(lens):.1f}), {sum(r.max_new for r in reqs)} new "
        f"tokens, arrivals over {reqs[-1].arrival_s:.1f} steps; "
        f"{SERVE_SLOTS} slots of {S_MAX} positions, bf16, seeded weights")
    ap = make_plan(cfg, 1)
    model = init_params(ap, seed=SEED, device="cuda")

    def batcher(**kw):
        return ContinuousBatcher(ap, model, slots=SERVE_SLOTS, s_max=S_MAX,
                                 device="cuda", **kw)

    dense, _ = serve_timed("tp=1 dense", batcher(), reqs)
    SERVE_OUTS["tp=1 dense"] = dense
    paged, m_paged = serve_timed(f"tp=1 paged (block {BLOCK})",
                                 batcher(block_size=BLOCK), reqs)
    if not same_outputs(paged, dense):
        raise AssertionError("serve: paged tokens differ from dense")
    log("  paged tokens == dense tokens")
    t0 = time.perf_counter()
    eager, m_eager = serve_run(batcher(block_size=BLOCK, cuda_graph=False),
                               reqs)
    log(f"  tp=1 paged, eager steps: throughput "
        f"{m_eager.throughput_tok_s:.1f} tok/s, TPOT p50 "
        f"{m_eager.tpot_s_p50 * 1e3:.3f} ms (one run, "
        f"{time.perf_counter() - t0:.1f} s)")
    if not same_outputs(eager, paged):
        raise AssertionError("serve: graph tokens differ from eager")
    log("  graph tokens == eager tokens")
    n_blocks = max(S_MAX // BLOCK + 1,
                   m_paged.cache_stats["peak_used_blocks"] // 2 + 1)
    small, m_small = serve_run(batcher(block_size=BLOCK, n_blocks=n_blocks),
                               reqs)
    log(f"  pool of {n_blocks} blocks (half the undisturbed run's peak "
        f"{m_paged.cache_stats['peak_used_blocks']}): "
        f"{m_small.preemptions} preemptions, {m_small.wasted_tokens} tokens "
        f"recomputed, {m_small.steps} steps")
    if m_small.preemptions == 0 or not same_outputs(small, dense):
        raise AssertionError("serve: the small pool did not preempt, or "
                             "changed a token")
    log("  preempted run's tokens == the undisturbed run's")
    samp = dict(block_size=BLOCK, temperature=1.0, top_k=50)
    s1, _ = serve_run(batcher(seed=SEED, **samp), reqs)
    s2, _ = serve_run(batcher(seed=SEED, **samp), reqs)
    s3, _ = serve_run(batcher(seed=SEED + 1, **samp), reqs)
    differ = sum(not np.array_equal(s1[k], s3[k]) for k in s1)
    if not same_outputs(s1, s2) or not differ:
        raise AssertionError("serve: sampling is not a function of its seed")
    log(f"  sampled (temperature 1, top-50): two runs under one seed equal, "
        f"{differ}/{len(s1)} requests differ under another seed")
    eng = InferenceEngine(ap, model, s_max=S_MAX, device="cuda")
    gen1 = {r.rid: eng.generate(r.prompt[None], r.max_new).new_tokens[0]
            for r in reqs}
    del eng
    fd_slots = ForcedDecode(model, ap, SERVE_SLOTS)
    seqs = [(r.prompt, gen1[r.rid]) for r in reqs]
    serve_gate("tp=1 batcher against each request's batch-1 generate",
               reqs, dense, gen1, fd_slots.logits(seqs),
               ForcedDecode(model, ap, 1).logits(seqs))
    free_device()
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    ap8 = make_plan(cfg, PODS * FAST)
    model8 = init_params(ap8, seed=SEED, device="cuda", mesh=mesh)

    def batcher8(block_size=BLOCK, c=ctx, **kw):
        return ContinuousBatcher(ap8, model8, slots=SERVE_SLOTS, s_max=S_MAX,
                                 ctx=c, mesh=mesh, device="cuda",
                                 block_size=block_size, **kw)

    tp8, _ = serve_timed(f"tp=8 ({PODS}x{FAST}) hier_rd paged", batcher8(),
                         reqs)
    SERVE_OUTS["tp=8 paged"] = tp8
    tp8_dense, _ = serve_run(batcher8(block_size=0), reqs)
    if not same_outputs(tp8, tp8_dense):
        raise AssertionError("serve: tp=8 paged tokens differ from tp=8 "
                             "dense")
    log("  tp=8 paged tokens == tp=8 dense tokens (the folded table, the "
        "slot splice and kernel 2 over the ranks' pools)")
    seqs = [(r.prompt, dense[r.rid]) for r in reqs]
    serve_gate("tp=8 against tp=1", reqs, tp8, dense,
               ForcedDecode(model8, ap8, SERVE_SLOTS, ctx, mesh).logits(seqs),
               fd_slots.logits(seqs))
    samp8 = dict(temperature=1.0, top_k=50)
    t = [serve_run(batcher8(seed=SEED, **samp8), reqs)[0] for _ in range(3)]
    if not (same_outputs(t[0], t[1]) and same_outputs(t[0], t[2])):
        raise AssertionError("serve: sampling on the mesh is not a "
                             "function of its seed")
    log("  tp=8 sampled (temperature 1, top-50): three runs under one seed "
        "equal")
    # under overlap an admission longer than any before grows kernel 5's
    # buffers, which the captured step holds: the step is captured anew
    octx = ctx.replace(overlap_matmul=True, overlap_chunks=4)
    b = batcher8(c=octx)
    t0 = time.perf_counter()
    ov, _ = serve_run(b, reqs)
    ov_s = time.perf_counter() - t0
    ov_eager, _ = serve_run(batcher8(c=octx, cuda_graph=False), reqs)
    log(f"  tp=8 hier_rd+overlap paged: {b.graph_recaptures} captures anew "
        f"after an admission grew kernel 5's buffers, {b.graph_replays} "
        f"replays ({ov_s:.1f} s)")
    if b.graph_recaptures < 1 or not same_outputs(ov, ov_eager):
        raise AssertionError("serve: under overlap the graph was not "
                             "captured anew, or its tokens differ from the "
                             "eager steps'")
    log("  tp=8 hier_rd+overlap graph tokens == eager tokens")
    del model, model8, fd_slots, b
    free_device()
    serve_f32(reqs)


def serve_f32(reqs) -> None:
    """The batcher in f32 at full width and 2 layers, tp=8 (4x2 hier_rd)
    paged against tp=1 dense by provable_gate: f32 keeps the two paths'
    logit difference near 1e-5, so the gate checks most steps, and it
    fails below three quarters of them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                              dtype=torch.float32)
    ap = make_plan(cfg, 1)
    model = init_params(ap, seed=SEED, device="cuda")
    one, _ = serve_run(ContinuousBatcher(ap, model, slots=SERVE_SLOTS,
                                         s_max=S_MAX, device="cuda"), reqs)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    ap8 = make_plan(cfg, PODS * FAST)
    model8 = init_params(ap8, seed=SEED, device="cuda", mesh=mesh)
    eight, _ = serve_run(ContinuousBatcher(
        ap8, model8, slots=SERVE_SLOTS, s_max=S_MAX, ctx=ctx, mesh=mesh,
        block_size=BLOCK, device="cuda"), reqs)
    seqs = [(r.prompt, one[r.rid]) for r in reqs]
    serve_gate(
        "f32, 2 layers: tp=8 paged against tp=1 dense", reqs, eight, one,
        ForcedDecode(model8, ap8, SERVE_SLOTS, ctx, mesh).logits(seqs),
        ForcedDecode(model, ap, SERVE_SLOTS).logits(seqs), floor=0.75)
    del model, model8
    free_device()


# ---------------------------------------------------------------------------
# Phase 28: the chunk form of kernel 3 and the serving features riding it
# ---------------------------------------------------------------------------

# The sweep of kernel 3's chunk form: chunk lengths (5: a speculative
# verify chunk of k = 4; 64; 128: the chunked admission's), query offsets
# (0, off a tile edge by 1 and 63, and 448), llama3.2-1b's heads at batch 8.
CHUNK_LENS = (5, 64, 128)
CHUNK_OFFSETS = (0, 1, 63, 448)
CHUNK_TIMED = (128, 384)          # (C, offset) timed
CHUNK_REPLAYS = 200


def chunk_operands(gen, dtype, C: int, off: int, window: int = 0):
    """A batch-8 prompt of off + C tokens at llama3.2-1b's heads, its full
    form's output, and the same keys in the decode cache: a dense cache of
    B + 3 rows (the sequences on shuffled rows) and a shuffled paged pool
    (BLOCK positions a block), every key position past the prompt and
    every unmapped block holding 999 / -999.  Returns (q of the chunk,
    full-form rows of the chunk, q_offset, dense (k, v, rows), paged (k, v,
    table))."""
    S = off + C

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(B, S, HQ, HD), rnd(B, S, HKV, HD), rnd(B, S, HKV, HD)
    full = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=True, window=window)
    rows = (torch.randperm(B + 3, generator=gen, device="cuda")[:B]
            ).to(torch.int32)
    dense = []
    for x, fill in ((k, 999.0), (v, -999.0)):
        c = torch.full((B + 3, S_MAX, HKV, HD), fill, dtype=dtype,
                       device="cuda")
        c[rows.long(), :S] = x
        dense.append(c)
    padded = [torch.cat([x, torch.full((B, S_MAX - S, HKV, HD), 999.0,
                                       dtype=dtype, device="cuda")], 1)
              for x in (k, v)]
    tbl, kp, vp = scatter_blocks(gen, *padded, BLOCK)
    offs = torch.full((B,), off, dtype=torch.int32, device="cuda")
    return (q[:, off:].transpose(1, 2), full[:, :, off:], offs,
            (dense[0], dense[1], rows), (kp, vp, tbl))


def chunk_call(q, offs, form, layout, window=0):
    k, v, idx = form
    kw = {"rows": idx} if layout == "dense" else {"block_tbl": idx}
    return (flash_attention_chunk(q, k, v, offs, window=window, **kw),
            flash_attention_chunk_ref(q, k, v, offs, window=window, **kw))


def chunk_bound(C: int, off: int, dtype) -> tuple:
    """Bytes: q and o of the chunk, each visible key's k and v once;
    operations: QK^T and PV over the (query, key) pairs the causal mask
    keeps."""
    keys = off + C
    pairs = sum(off + i + 1 for i in range(C))
    esz = torch.finfo(dtype).bits // 8
    return bound_ms(esz * B * HD * (2 * HQ * C + 2 * HKV * keys),
                    4.0 * B * HQ * HD * pairs, dtype)


def phase_chunk_kernel() -> dict:
    """Kernel 3's chunk form against its plain version (within TOL) and
    bitwise against the full form on the rows they share, over CHUNK_LENS
    x CHUNK_OFFSETS, dense rows and the paged table, bf16 and f32, plus a
    windowed case; the keys past the chunk's last query poisoned with NaN
    change no bit; CHUNK_REPLAYS replays of one captured call with fresh
    offsets and queries each bitwise a direct call; kernel, plain version
    and SDPA with the same boolean mask timed at CHUNK_TIMED."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 28)
    worst = {}
    cases = [(dt, C, off, 0) for dt in (torch.bfloat16, torch.float32)
             for C in CHUNK_LENS for off in CHUNK_OFFSETS]
    cases += [(torch.bfloat16, 128, 448, 300), (torch.float32, 64, 63, 100)]
    for dtype, C, off, win in cases:
        q, full, offs, dense, paged = chunk_operands(gen, dtype, C, off, win)
        outs = {}
        for layout, form in (("dense", dense), ("paged", paged)):
            out, ref = chunk_call(q, offs, form, layout, win)
            err = max_err(out, ref)
            tol = TOL[dtype]
            if not torch.allclose(out.float(), ref.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(f"chunk C={C} off={off} {layout} "
                                     f"{dtype}: kernel != plain ({err:.3e})")
            if not torch.equal(out, full):
                raise AssertionError(f"chunk C={C} off={off} {layout} "
                                     f"{dtype}: not bitwise the full form")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            outs[layout] = out
        # NaN past the chunk's last query (the dense rows) changes nothing
        k, v, rows = dense
        k2, v2 = k.clone(), v.clone()
        k2[:, off + C:], v2[:, off + C:] = float("nan"), float("nan")
        if not torch.equal(flash_attention_chunk(q, k2, v2, offs, rows=rows,
                                                 window=win), outs["dense"]):
            raise AssertionError(f"chunk C={C} off={off}: a key past the "
                                 "chunk's last query reached the output")
        del q, full, dense, paged, k2, v2
    log(f"  chunk form: {len(cases)} cases x dense rows and paged table "
        f"(C {CHUNK_LENS}, offsets {CHUNK_OFFSETS}, two windowed): within "
        f"TOL of the plain version (max |kernel-plain| bf16 "
        f"{worst[torch.bfloat16]:.3e}, f32 {worst[torch.float32]:.3e}), "
        "bitwise the full form's rows, NaN past the last query unread")
    # replays of a captured call, fresh offsets and queries each
    C, off = CHUNK_TIMED
    q, full, offs, dense, paged = chunk_operands(gen, torch.bfloat16, C, off)
    kp, vp, tbl = paged
    qs = q.clone()
    out = flash_attention_chunk(qs, kp, vp, offs, block_tbl=tbl)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = flash_attention_chunk(qs, kp, vp, offs, block_tbl=tbl)
    for i in range(CHUNK_REPLAYS):
        offs.copy_(torch.randint(0, S_MAX - C + 1, (B,), generator=gen,
                                 device="cuda", dtype=torch.int32))
        qs.copy_(torch.randn(qs.shape, generator=gen, device="cuda"))
        g.replay()
        if not torch.equal(out, flash_attention_chunk(qs, kp, vp, offs,
                                                      block_tbl=tbl)):
            raise AssertionError(f"chunk replay {i}: differs from a direct "
                                 "call")
    log(f"  {CHUNK_REPLAYS} replays of one captured paged call (C {C}), "
        "fresh offsets and queries each: bitwise a direct call")
    offs.fill_(off)
    # SDPA over the off + C keys that exist (the gathered rows cut there),
    # under the same causal boolean mask: the same function as the kernel's
    k, v, rows = dense
    kd = k[rows.long(), :off + C].transpose(1, 2).contiguous()
    vd = v[rows.long(), :off + C].transpose(1, 2).contiguous()
    qpos = off + torch.arange(C, device="cuda")
    mask = (torch.arange(off + C, device="cuda")[None, :]
            <= qpos[:, None])[None, None]
    qc = q.contiguous()
    t = {}
    for layout, form in (("dense", dense), ("paged", paged)):
        kw = {"rows": form[2]} if layout == "dense" \
            else {"block_tbl": form[2]}
        t[layout] = (time_ms(lambda: flash_attention_chunk(
                         q, form[0], form[1], offs, **kw)),
                     time_ms(lambda: flash_attention_chunk_ref(
                         q, form[0], form[1], offs, **kw)))
    t_sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        qc, kd, vd, attn_mask=mask, enable_gqa=True))
    bnd = chunk_bound(C, off, torch.bfloat16)
    for layout in t:
        log(f"  flash_attention_chunk {layout} C={C} offset={off} (B {B}, "
            f"{HQ}/{HKV} heads, hd {HD}) [bfloat16]: kernel_ms="
            f"{t[layout][0]:.4f} plain_ms={t[layout][1]:.4f} library_ms="
            f"{t_sdpa:.4f} (SDPA over the {off + C} keys, boolean mask) "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
    del q, full, dense, paged, kd, vd
    free_device()
    return {"max_abs_err": worst[torch.bfloat16], "ms": t["dense"][0],
            "plain_ms": t["dense"][1], "library_ms": t_sdpa,
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "paged_ms": t["paged"][0], "paged_plain_ms": t["paged"][1],
            "shape": {"B": B, "Hq": HQ, "Hkv": HKV, "hd": HD, "C": C,
                      "offset": off}}


ADMIT_CHUNK, SPEC_K = 128, 4
PREFIX_LEN, PREFIX_FRAC = 256, 0.75


def chunk_launches(reqs, L: int) -> int:
    """Kernel 3's chunk-form launches of a chunked admission of ``reqs``:
    one a layer a chunk."""
    return L * sum(-(-len(r.prompt) // ADMIT_CHUNK) for r in reqs)


def spec_log(name: str, b: ContinuousBatcher, m) -> None:
    log(f"    spec {name}: {m.accepted_tokens}/{m.drafted_tokens} drafts "
        f"accepted ({m.acceptance_rate:.3f}, {m.accepted_tokens_per_step:.2f}"
        f" a step), {m.steps} steps, {m.throughput_tok_s:.1f} tok/s, "
        f"{b.graph_replays} replays")


def streams_of(reqs, outs: dict) -> dict:
    """A ReplayDrafter's streams: each request's tokens in ``outs``."""
    return {tuple(int(t) for t in r.prompt): list(outs[r.rid]) for r in reqs}


def phase_serve_chunked() -> dict:
    """Phase 27's trace admitted by chunks of ADMIT_CHUNK (tp=1 dense and
    paged, tp=8 hier_rd paged): exact launches of the eager form (kernel
    3's chunk form once a layer a chunk, its full form never), chunked
    dense == chunked paged == eager bitwise, chunked against full
    admission by provable_gate with the teacher-forced logits within
    (TF_MAX, TF_MEAN); speculative decoding (k = SPEC_K, greedy) with the
    replay drafter (phase 27's streams), the ngram drafter, the replay of
    the ngram run's streams and, on the paged cache, the draft model
    (graph and eager steps), each against plain decode by the same gate,
    and all of them the same tokens (a verify row's value depends only on
    its position and the tokens before it, not on the drafts); the prefix
    trace with the cache on == off bitwise at tp=1; at tp=8 the prefix
    trace plain with the cache on == off bitwise and spec ngram with the
    cache on (graph == eager bitwise) against plain by the gate; then the
    f32 runs of serve_chunked_f32.  Returns the launch counts of the eager
    chunked run."""
    cfg = serve_config()
    L = cfg.n_layers
    tf = (TF_MAX, TF_MEAN)
    reqs = make_trace(SERVE_REQS, mean_in=SERVE_MEAN_IN,
                      mean_out=SERVE_MEAN_OUT, rate=SERVE_RATE,
                      vocab=cfg.vocab_size, seed=SEED)
    preqs = make_prefix_trace(SERVE_REQS, prefix_len=PREFIX_LEN,
                              shared_frac=PREFIX_FRAC,
                              mean_in=SERVE_MEAN_IN,
                              mean_out=SERVE_MEAN_OUT, rate=SERVE_RATE,
                              vocab=cfg.vocab_size, seed=SEED,
                              clip_len=S_MAX - 1)
    ap = make_plan(cfg, 1)
    model = init_params(ap, seed=SEED, device="cuda")
    chunked = dict(admit_mode="chunked", admit_chunk=ADMIT_CHUNK)
    spec = dict(spec_k=SPEC_K)

    def batcher(**kw):
        return ContinuousBatcher(ap, model, slots=SERVE_SLOTS, s_max=S_MAX,
                                 device="cuda", **kw)

    # (b) chunked admission
    reset_counts()
    few = reqs[:SERVE_SLOTS]
    eager, _ = serve_run(batcher(block_size=BLOCK, cuda_graph=False,
                                 **chunked), few)
    launches = counts()
    want = chunk_launches(few, L)
    log(f"  chunked eager run ({len(few)} requests): flash_attention_chunk "
        f"{launches['flash_attention_chunk']} (expected {want}: {L} layers "
        f"x {want // L} chunks), flash_attention "
        f"{launches['flash_attention']}, paged_decode_attention "
        f"{launches['paged_decode_attention']}")
    if launches["flash_attention_chunk"] != want \
            or launches["flash_attention"]:
        raise AssertionError("chunked admission: launch counts differ")
    c_dense, _ = serve_timed(f"tp=1 dense, chunked({ADMIT_CHUNK})",
                             batcher(**chunked), reqs)
    c_paged, _ = serve_timed(f"tp=1 paged, chunked({ADMIT_CHUNK})",
                             batcher(block_size=BLOCK, **chunked), reqs)
    if not (same_outputs(c_dense, c_paged) and same_outputs(
            eager, {r.rid: c_paged[r.rid] for r in few})):
        raise AssertionError("chunked: dense, paged and eager tokens differ")
    log("  chunked dense == chunked paged == its eager steps, bitwise")
    full = SERVE_OUTS["tp=1 dense"]
    seqs = [(r.prompt, full[r.rid]) for r in reqs]
    fd_full = ForcedDecode(model, ap, SERVE_SLOTS).logits(seqs)
    serve_gate("tp=1 chunked against full admission", reqs, c_dense, full,
               ForcedDecode(model, ap, SERVE_SLOTS,
                            chunk=ADMIT_CHUNK).logits(seqs), fd_full,
               limits=tf)
    # (d) speculative decoding against plain decode (full admission)
    fd_verify = ForcedDecode(model, ap, SERVE_SLOTS,
                             verify_k=SPEC_K).logits(seqs)
    runs = (("replay", "replay", streams_of(reqs, full)),
            ("ngram", "ngram", None),
            ("replay of the ngram run's streams", "replay", "ngram"))
    spec_outs = {}
    for name, mode, src in runs:
        kw = {}
        if mode == "replay":
            if isinstance(src, str):        # the streams of an earlier run
                src = streams_of(reqs, spec_outs[src])
            kw["drafter"] = ReplayDrafter(src)
        b = batcher(spec_mode=mode, **spec, **kw)
        outs, m = serve_timed(f"tp=1 dense, spec {name} k={SPEC_K}", b,
                              reqs, reps=1)
        spec_outs[name] = outs
        spec_log(f"{name} (plain decode "
                 f"{SERVE_STATS['tp=1 dense']['steps']:.0f} steps)", b, m)
        serve_gate(f"tp=1 spec {name} against plain decode", reqs, outs,
                   full, fd_verify, fd_full, limits=tf)
    # the draft model on the paged cache, the trace's first SERVE_SLOTS
    # requests (it runs a forward a drafted token), graph and eager steps
    drafted = {}
    for graph in (True, False):
        b = batcher(block_size=BLOCK, spec_mode="draft", cuda_graph=graph,
                    **spec)
        drafted[graph], m = serve_run(b, few)
        spec_log(f"draft, paged, {len(few)} requests, "
                 f"{'graph' if graph else 'eager'} steps", b, m)
    if not same_outputs(drafted[True], drafted[False]):
        raise AssertionError("spec draft paged: graph tokens differ from "
                             "eager")
    log("  spec draft paged: graph tokens == eager tokens, bitwise")
    serve_gate("tp=1 paged spec draft against plain decode", few,
               drafted[True], full, fd_verify[:len(few)],
               fd_full[:len(few)], limits=tf)
    ref = spec_outs["ngram"]
    if not (all(same_outputs(o, ref) for o in spec_outs.values())
            and same_outputs(drafted[True], {r.rid: ref[r.rid]
                                             for r in few})):
        raise AssertionError("spec: the tokens depend on the drafter or on "
                             "the cache layout")
    log("  spec tokens do not depend on the drafter or the layout: replay, "
        "ngram, the replay of the ngram run's streams and the paged draft "
        "model's run equal, bitwise")
    del fd_full, fd_verify
    # (c) the prefix cache, on against off, both chunked and paged
    lens = [len(r.prompt) for r in preqs]
    heads = [tuple(r.prompt[:PREFIX_LEN]) for r in preqs]
    n_shared = max(heads.count(h) for h in heads)
    log(f"  prefix trace: {len(preqs)} requests, prompts {min(lens)}-"
        f"{max(lens)}, {n_shared} open with the same {PREFIX_LEN} tokens")
    off, _ = serve_timed("tp=1 paged chunked, prefix cache off",
                         batcher(block_size=BLOCK, **chunked), preqs, reps=1)
    b = batcher(block_size=BLOCK, prefix_cache="on", **chunked)
    on, m = serve_timed("tp=1 paged chunked, prefix cache on", b, preqs,
                        reps=1)
    if not same_outputs(on, off):
        raise AssertionError("prefix cache on != off")
    log(f"  prefix on == off bitwise; the timed run: {m.prefix_hits}/"
        f"{m.prefix_lookups} admissions hit, {m.prefix_tokens_saved} "
        f"prompt tokens not prefilled (of {sum(lens)})")
    if not m.prefix_hits:
        raise AssertionError("prefix cache: no hit")
    del model, b
    free_device()
    # tp=8 hier_rd paged: chunked against its full admission; the prefix
    # trace with the cache on, plain and speculative
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    ap8 = make_plan(cfg, PODS * FAST)
    model8 = init_params(ap8, seed=SEED, device="cuda", mesh=mesh)

    def batcher8(**kw):
        return ContinuousBatcher(ap8, model8, slots=SERVE_SLOTS, s_max=S_MAX,
                                 ctx=ctx, mesh=mesh, block_size=BLOCK,
                                 device="cuda", **kw)

    c8, _ = serve_timed(f"tp=8 ({PODS}x{FAST}) hier_rd paged, chunked("
                        f"{ADMIT_CHUNK})", batcher8(**chunked), reqs, reps=1)
    full8 = SERVE_OUTS["tp=8 paged"]
    seqs = [(r.prompt, full8[r.rid]) for r in reqs]
    serve_gate("tp=8 chunked against tp=8 full admission", reqs, c8, full8,
               ForcedDecode(model8, ap8, SERVE_SLOTS, ctx, mesh,
                            chunk=ADMIT_CHUNK).logits(seqs),
               ForcedDecode(model8, ap8, SERVE_SLOTS, ctx, mesh)
               .logits(seqs), limits=tf)
    p_off, _ = serve_run(batcher8(**chunked), preqs)
    b = batcher8(prefix_cache="on", **chunked)
    p_on, m = serve_run(b, preqs)
    log(f"  tp=8 prefix trace, chunked: cache on {m.prefix_hits}/"
        f"{m.prefix_lookups} admissions hit, {m.prefix_tokens_saved} prompt "
        "tokens not prefilled")
    if not m.prefix_hits or not same_outputs(p_on, p_off):
        raise AssertionError("tp=8 prefix cache: no hit, or on != off")
    log("  tp=8 prefix on == off bitwise")
    # the eager steps serve the trace's first SERVE_SLOTS requests (an
    # eager tp=8 verify step takes about 65 ms): a request's tokens do not
    # depend on the others in the batch, nor on the prefix hits
    p_spec = {}
    for graph, rs in ((True, preqs), (False, preqs[:SERVE_SLOTS])):
        b = batcher8(prefix_cache="on", spec_mode="ngram", cuda_graph=graph,
                     **chunked, **spec)
        p_spec[graph], m = serve_run(b, rs)
        spec_log(f"ngram, tp=8 paged, prefix cache on, {len(rs)} requests "
                 f"({m.prefix_hits} hits), {'graph' if graph else 'eager'} "
                 "steps", b, m)
    if not same_outputs(p_spec[False], {r.rid: p_spec[True][r.rid]
                                        for r in preqs[:SERVE_SLOTS]}):
        raise AssertionError("tp=8 spec: graph tokens differ from eager")
    log("  tp=8 spec + prefix cache: graph tokens == eager tokens, bitwise")
    pseqs = [(r.prompt, p_off[r.rid]) for r in preqs]
    serve_gate("tp=8 spec ngram + prefix cache against plain (chunked, "
               "cache off)", preqs, p_spec[True], p_off,
               ForcedDecode(model8, ap8, SERVE_SLOTS, ctx, mesh,
                            chunk=ADMIT_CHUNK, verify_k=SPEC_K).logits(pseqs),
               ForcedDecode(model8, ap8, SERVE_SLOTS, ctx, mesh,
                            chunk=ADMIT_CHUNK).logits(pseqs), limits=tf)
    del model8, b
    free_device()
    log("    TTFT p50 and throughput, full admission (phase 27) against "
        "chunked (this phase):")
    for a, c in (("tp=1 dense", f"tp=1 dense, chunked({ADMIT_CHUNK})"),
                 (f"tp=1 paged (block {BLOCK})",
                  f"tp=1 paged, chunked({ADMIT_CHUNK})"),
                 (f"tp=8 ({PODS}x{FAST}) hier_rd paged",
                  f"tp=8 ({PODS}x{FAST}) hier_rd paged, chunked("
                  f"{ADMIT_CHUNK})")):
        fa, ch = SERVE_STATS[a], SERVE_STATS[c]
        log(f"      {a}: TTFT p50 {fa['ttft_s_p50'] * 1e3:.2f} -> "
            f"{ch['ttft_s_p50'] * 1e3:.2f} ms, throughput "
            f"{fa['throughput_tok_s']:.1f} -> {ch['throughput_tok_s']:.1f} "
            "tok/s")
    serve_chunked_f32(reqs)
    return {"serve_chunked_tp1_paged": launches}


def serve_chunked_f32(reqs) -> None:
    """In f32 at full width and 2 layers, where two paths' logits differ
    by about 1e-5 and provable_gate checks most steps: chunked admission
    and speculative decoding (k = SPEC_K, the replay drafter over the plain
    run's streams) against plain full admission on the dense cache, at
    tp=1 (chunked and spec on the paged cache) and tp=8 (4x2 hier_rd,
    dense), each by provable_gate with a floor of three quarters of the
    steps and the logits within (TF_MAX, TF_MEAN).  The replay's
    acceptance is printed: near 1 unless the verify pass picks other
    tokens than plain decode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                              dtype=torch.float32)
    chunked = dict(admit_mode="chunked", admit_chunk=ADMIT_CHUNK)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    for name, R, bs in (("tp=1, paged", 1, BLOCK),
                        (f"tp=8 ({PODS}x{FAST}) hier_rd, dense", PODS * FAST,
                         0)):
        ap = make_plan(cfg, R)
        kw = {} if R == 1 else {"ctx": ctx, "mesh": mesh}
        model = init_params(ap, seed=SEED, device="cuda",
                            mesh=kw.get("mesh"))

        def run(**extra):
            b = ContinuousBatcher(ap, model, slots=SERVE_SLOTS, s_max=S_MAX,
                                  device="cuda", **kw, **extra)
            return (*serve_run(b, reqs), b)

        def fd(**f):
            return ForcedDecode(model, ap, SERVE_SLOTS, kw.get("ctx"),
                                kw.get("mesh"), **f).logits(seqs)

        plain = run()[0]
        seqs = [(r.prompt, plain[r.rid]) for r in reqs]
        ref = fd()
        serve_gate(f"f32, 2 layers, {name}: chunked against full admission",
                   reqs, run(block_size=bs, **chunked)[0], plain,
                   fd(chunk=ADMIT_CHUNK), ref, limits=(TF_MAX, TF_MEAN),
                   floor=0.75)
        outs, m, b = run(block_size=bs, spec_mode="replay", spec_k=SPEC_K,
                         drafter=ReplayDrafter(streams_of(reqs, plain)))
        spec_log(f"replay of plain's streams, f32, 2 layers, {name}", b, m)
        serve_gate(f"f32, 2 layers, {name}: spec replay k={SPEC_K} against "
                   "plain decode", reqs, outs, plain, fd(verify_k=SPEC_K),
                   ref, limits=(TF_MAX, TF_MEAN), floor=0.75)
        del model, ref, b
        free_device()


# ---------------------------------------------------------------------------
# Phase 29: faults and quarantine, disaggregated pools, the router
# ---------------------------------------------------------------------------

# (b) phase 27's trace under injected faults: a NaN poked into a request's
# live K at about one (request, tokens emitted) key in 250 (some 8 of the
# trace's 2108), an OOM burst on one step in 20, a 2 ms straggler on one
# step in 10, and a TTFT deadline of 100 steps (8 slots free a request
# about every 8 steps while one arrives every 2, so the queue's tail waits
# past it); at tp=8 NaN alone.
FAULT_PLAN = ("seed=29,nan_logits=0.004,oom=0.05,straggler=0.1,"
              "straggler_s=0.002")
FAULT_DEADLINE = 100.0
FAULT_PLAN8 = "seed=29,nan_logits=0.004"
# (c) the handoff's faults: one transfer attempt in 5 lost (retried with
# backoff), one prefill's bundle in 5 damaged (re-prefilled; shed after
# two re-prefills)
HANDOFF_PLAN = "seed=29,handoff_drop=0.2,handoff_corrupt=0.2"
# (d) the placement policies' bursty trace: phase 27's requests (the same
# draws; only the gaps scale with the rate) arriving 8 times as fast
BURST_RATE = 4.0
P29 = dict(arch="llama3.2-1b", smoke=False, layers=SERVE_LAYERS,
           slots=SERVE_SLOTS, s_max=S_MAX, block_size=BLOCK)


def nan_masking_check() -> None:
    """(a) Kernels 1, 2 and 3's chunk form never read a K or V row past
    the visible range: with NaN planted in every such row, each call is
    bitwise the same call with zeros there (bf16 and f32, phase 27's serve
    shapes: 8 rows of 1024 positions, 32 / 8 heads of 64; the chunk form
    at C 128 over offsets 0-700, dense rows and the paged table).  The
    batcher's scrub is needed only by the plain versions, which sum p @ v
    over every row (tests/test_torch_faults.py)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 29)
    b, s, C = SERVE_SLOTS, S_MAX, ADMIT_CHUNK
    kpos = torch.arange(s, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        k, v = rnd(b, s, HKV, HD), rnd(b, s, HKV, HD)

        def planted(last):
            """(zeros, NaN) copies of k and v past each row's ``last``."""
            past = (kpos[None] > last.long()[:, None])[:, :, None, None]
            return [[torch.where(past, torch.full((), f, dtype=dtype,
                                                  device="cuda"), x)
                     for x in (k, v)] for f in (0.0, float("nan"))]

        def pages(kv):
            g = torch.Generator(device="cuda")
            g.manual_seed(SEED)
            return scatter_blocks(g, *kv, BLOCK)

        pos = torch.tensor([0, 1, 127, 128, 300, 511, 777, s - 1],
                           dtype=torch.int32, device="cuda")
        q = rnd(b, HQ, HD)
        zero, nan = planted(pos)
        (tz, kz, vz), (tn, kn, vn) = pages(zero), pages(nan)
        outs = [decode_attention(q, *zero, pos),
                decode_attention(q, *nan, pos),
                paged_decode_attention(q, kz, vz, tz, pos),
                paged_decode_attention(q, kn, vn, tn, pos)]
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            raise AssertionError(f"decode attention [{dtype}]: NaN past "
                                 "the visible keys reached the output")
        offs = torch.tensor([0, 1, 63, 128, 200, 384, 500, 700],
                            dtype=torch.int32, device="cuda")
        rows = torch.arange(b, dtype=torch.int32, device="cuda")
        qc = rnd(b, HQ, C, HD)
        zero, nan = planted(offs + C - 1)
        (tz, kz, vz), (tn, kn, vn) = pages(zero), pages(nan)
        outs = [flash_attention_chunk(qc, *zero, offs, rows=rows),
                flash_attention_chunk(qc, *nan, offs, rows=rows),
                flash_attention_chunk(qc, kz, vz, offs, block_tbl=tz),
                flash_attention_chunk(qc, kn, vn, offs, block_tbl=tn)]
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            raise AssertionError(f"flash_attention_chunk [{dtype}]: NaN "
                                 "past the chunk's last query reached the "
                                 "output")
        log(f"  [{str(dtype)[6:]}] decode_attention, paged_decode_attention "
            "(8 rows, positions 0-1023) and flash_attention_chunk (C "
            f"{C}, offsets 0-700, dense rows and the paged table): NaN in "
            "every K/V row past the visible range == zeros there, bitwise "
            "(and dense == paged)")
        del k, v, q, qc, zero, nan, kz, vz, kn, vn


def p29_line(label: str, m, extra: str = "") -> None:
    """A run's throughput, and TTFT / TPOT p50 in steps and in ms at the
    run's mean step time."""
    step_ms = m.wall_s / m.steps * 1e3 if m.steps else 0.0
    log(f"  {label}: {m.completed}/{m.requests} requests, "
        f"{m.total_new_tokens} tokens in {m.steps} steps, {m.wall_s:.2f} s: "
        f"{m.throughput_tok_s:.1f} tok/s, TTFT p50 {m.ttft_steps_p50:.1f} "
        f"steps = {m.ttft_steps_p50 * step_ms:.2f} ms, TPOT p50 "
        f"{m.tpot_steps_p50:.2f} steps = {m.tpot_steps_p50 * step_ms:.3f} "
        f"ms{extra}")


def survivors(label: str, done, ref: dict, reasons=()) -> int:
    """Every request completed with the reference's tokens, bitwise, or was
    shed with one of ``reasons``; returns the shed count."""
    shed = 0
    for r in done:
        if r.output is None:
            if r.shed_reason not in reasons or r.shed_step < 0:
                raise AssertionError(f"{label}: request {r.rid} left "
                                     f"unserved (reason {r.shed_reason})")
            shed += 1
        elif not np.array_equal(r.output, ref[r.rid]):
            raise AssertionError(f"{label}: request {r.rid}'s tokens differ "
                                 "from the fault-free run's")
    return shed


def launched(label: str, c: dict, names) -> None:
    idle = [n for n in names if not c[n]]
    if idle:
        raise AssertionError(f"{label}: {idle} never launched")


def batcher_faults(label: str, b, m, shed: int) -> None:
    log(f"    faults fired {b.injector.stats()}; quarantines "
        f"{m.quarantines}, injected OOM {m.injected_oom}, straggler steps "
        f"{m.straggler_steps}, shed {shed} (deadline), preemptions "
        f"{m.preemptions}, {m.wasted_tokens} tokens recomputed; graphs "
        f"captured {b.graph_captures} ({b.graph_recaptures} anew), "
        f"{b.graph_replays} replays")
    if m.quarantines < 1 or m.quarantines != b.injector.counts["nan_logits"]:
        raise AssertionError(f"{label}: {m.quarantines} quarantines for "
                             f"{b.injector.counts['nan_logits']} NaN pokes")
    if not (torch.isfinite(b.cache["k"]).all()
            and torch.isfinite(b.cache["v"]).all()):
        raise AssertionError(f"{label}: NaN left in the cache")


def disagg_line(label: str, m) -> None:
    p29_line(label, m)
    log(f"    handoff: {m.handoffs} bundles, {m.transfer_bytes} bytes "
        f"({m.transfer_bytes / max(m.handoffs, 1) / 2**20:.2f} MiB a "
        f"bundle), ready / pending peaks {m.peak_ready_depth} / "
        f"{m.peak_pending_depth}; prefill wall {m.prefill_pool['wall_s']:.2f}"
        f" s over {m.prefill_pool['prefills']} prefills; AR buckets prefill "
        f"2^{m.prefill_ar_bucket}, decode 2^{m.decode_ar_bucket}; graphs "
        f"captured prefill {m.prefill_pool['graph_captures']} / decode "
        f"{m.decode_pool['graph_captures']} ("
        f"{m.prefill_pool['graph_recaptures']} / "
        f"{m.decode_pool['graph_recaptures']} anew); drops "
        f"{m.handoff_drops}, retries {m.handoff_retries}, corrupt "
        f"{m.handoff_corrupt}, re-prefills {m.handoff_reprefills}, shed "
        f"{m.shed_requests}")


def phase_p29() -> dict:
    """(b)-(d) on phase 27's trace at full width and depth, bf16, graphs
    on; the references are phase 27's fault-free tokens (tp=1 dense ==
    paged, tp=8 paged).  Returns the launch counts of each new path (the
    graph form: a captured step counts at its capture)."""
    cfg = serve_config()
    reqs = make_trace(SERVE_REQS, mean_in=SERVE_MEAN_IN,
                      mean_out=SERVE_MEAN_OUT, rate=SERVE_RATE,
                      vocab=cfg.vocab_size, seed=SEED)
    ref1, ref8 = SERVE_OUTS["tp=1 dense"], SERVE_OUTS["tp=8 paged"]
    spec = ReplicaSpec(**P29)
    ap = make_plan(cfg, 1)
    model = init_params(ap, seed=SEED, device="cuda")
    mesh8, ctx8 = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                               device="cuda")
    ap8 = make_plan(cfg, PODS * FAST)
    model8 = init_params(ap8, seed=SEED, device="cuda", mesh=mesh8)
    tp8 = dict(tp=PODS * FAST, pods=PODS, ar_strategy="hier_rd")
    launches = {}

    def run(rep, trace, path):
        reset_counts()
        done = rep.run(fresh(trace))
        launches[path] = counts()
        return done, rep.metrics(done)

    # (b) the batcher under faults and a deadline, tp=1 paged
    b = build_replica(spec.replace(fault_plan=FAULT_PLAN,
                                   deadline_ms=FAULT_DEADLINE),
                      ap=ap, model=model, device="cuda")
    done, m = run(b, reqs, "fault_tp1_paged")
    shed = survivors("faults tp=1", done, ref1, reasons=("deadline",))
    p29_line(f"tp=1 paged, plan {FAULT_PLAN}, deadline "
             f"{FAULT_DEADLINE:g} steps", m,
             f"; every survivor bitwise phase 27's")
    batcher_faults("faults tp=1", b, m, shed)
    if m.injected_oom < 1 or shed != m.shed_requests:
        raise AssertionError("faults tp=1: no injected OOM, or the shed "
                             "count is not the metrics'")
    launched("faults tp=1", launches["fault_tp1_paged"],
             ("flash_attention", "paged_decode_attention"))
    del b
    b = build_replica(spec.replace(fault_plan=FAULT_PLAN8, **tp8), ap=ap8,
                      model=model8, device="cuda")
    done, m = run(b, reqs, "fault_tp8_paged")
    survivors("faults tp=8", done, ref8)
    p29_line(f"tp=8 ({PODS}x{FAST}) hier_rd paged, plan {FAULT_PLAN8}", m,
             "; every request bitwise phase 27's tp=8 run")
    batcher_faults("faults tp=8", b, m, 0)
    launched("faults tp=8", launches["fault_tp8_paged"],
             ("flash_attention", "paged_decode_attention", "rd_all_reduce"))
    del b
    free_device()
    # (c) disaggregated: both pools tp=1, the prefill pool full admission
    dspec = spec.replace(disagg=True, prefill_block_size=0)
    d = build_replica(dspec, ap=ap, model=model, device="cuda")
    done, m = run(d, reqs, "disagg_tp1")
    survivors("disagg tp=1", done, ref1)
    disagg_line("disagg, prefill tp=1 (full) -> decode tp=1 paged", m)
    log("    every request bitwise colocated paged serving (phase 27)")
    launched("disagg tp=1", launches["disagg_tp1"],
             ("flash_attention", "paged_decode_attention"))
    d = build_replica(dspec.replace(fault_plan=HANDOFF_PLAN), ap=ap,
                      model=model, device="cuda")
    done, m = run(d, reqs, "disagg_tp1_handoff_faults")
    shed = survivors("disagg handoff faults", done, ref1,
                     reasons=("handoff_corrupt", "handoff_failed"))
    disagg_line(f"disagg tp=1, plan {HANDOFF_PLAN}", m)
    log(f"    faults fired {d.injector.stats()}; every survivor bitwise the "
        f"fault-free run, {shed} shed with their reasons")
    if min(m.handoff_drops, m.handoff_retries, m.handoff_corrupt,
           m.handoff_reprefills) < 1 or shed != m.shed_requests:
        raise AssertionError("disagg handoff faults: a counter did not "
                             "move, or the shed count is not the metrics'")
    d8 = build_replica(dspec.replace(decode_tp=PODS * FAST,
                                     decode_pods=PODS,
                                     ar_strategy="hier_rd"),
                       prefill_ap=ap, prefill_model=model, decode_ap=ap8,
                       decode_model=model8, device="cuda")
    done, m = run(d8, reqs, "disagg_tp1_tp8")
    outs = {r.rid: r.output for r in done}
    if any(v is None for v in outs.values()):
        raise AssertionError("disagg tp=1 -> tp=8: requests unserved")
    disagg_line(f"disagg, prefill tp=1 (full) -> decode tp=8 ({PODS}x{FAST})"
                " hier_rd paged", m)
    log(f"    {sum(np.array_equal(outs[k], ref8[k]) for k in ref8)}/"
        f"{len(ref8)} requests bitwise colocated tp=8")
    launched("disagg tp=1 -> tp=8", launches["disagg_tp1_tp8"],
             ("flash_attention", "paged_decode_attention", "rd_all_reduce"))
    seqs = [(r.prompt, ref8[r.rid]) for r in reqs]
    serve_gate("disagg prefill tp=1 -> decode tp=8 against colocated tp=8",
               reqs, outs, ref8,
               ForcedDecode(model8, ap8, SERVE_SLOTS, ctx8, mesh8,
                            prefill_with=(model, ap)).logits(seqs),
               ForcedDecode(model8, ap8, SERVE_SLOTS, ctx8,
                            mesh8).logits(seqs), limits=(TF_MAX, TF_MEAN))
    del d, d8
    free_device()
    disagg_f32(reqs, spec)
    # (d) the router: two tp=1 replicas under round_robin == two singles
    reps = [build_replica(spec, ap=ap, model=model, replica_id=i,
                          device="cuda") for i in range(2)]
    fleet = Router(reps, policy="round_robin")
    done, rm = run(fleet, reqs, "router_rr")
    launched("router", launches["router_rr"],
             ("flash_attention", "paged_decode_attention"))
    by_arrival = sorted(reqs, key=lambda r: r.arrival_s)
    for i in range(2):
        solo = build_replica(spec, ap=ap, model=model, replica_id=i,
                             device="cuda")
        sd = {r.rid: r.output for r in solo.run(fresh(
            [r for k, r in enumerate(by_arrival) if k % 2 == i]))}
        survivors(f"router replica {i}", [r for r in done if r.rid in sd],
                  sd)
        del solo
    survivors("router", done, ref1)
    p29_line("router, 2 replicas tp=1 paged, round_robin", rm.fleet,
             f"; placements {rm.placements}; each replica bitwise its "
             "single run, and both phase 27's")
    burst = make_trace(SERVE_REQS, mean_in=SERVE_MEAN_IN,
                       mean_out=SERVE_MEAN_OUT, rate=BURST_RATE,
                       vocab=cfg.vocab_size, seed=SEED)
    for policy in ("least_queue", "ttft_aware"):
        fleet = Router(reps, policy=policy,
                       cost_fn=prefill_cost_model(spec))
        done = fleet.run(fresh(burst))
        rm = fleet.metrics(done)
        survivors(f"router {policy}", done, ref1)
        if min(rm.placements) < 1:
            raise AssertionError(f"router {policy}: a replica got nothing")
        p29_line(f"router, 2 replicas, {policy}, the trace at "
                 f"{BURST_RATE:g} arrivals a step", rm.fleet,
                 f"; placements {rm.placements}, all bitwise phase 27's")
    log(f"    router replicas' graphs captured "
        f"{[r.graph_captures for r in reps]} "
        f"({[r.graph_recaptures for r in reps]} anew)")
    del model, model8, reps, fleet
    free_device()
    return launches


def disagg_f32(reqs, spec) -> None:
    """In f32 at full width and 2 layers: disaggregated prefill tp=1 ->
    decode tp=8 against colocated tp=8 by provable_gate, which must check
    at least three quarters of the steps, with the teacher-forced logits
    within (TF_MAX, TF_MEAN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                              dtype=torch.float32)
    ap = make_plan(cfg, 1)
    model = init_params(ap, seed=SEED, device="cuda")
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    ap8 = make_plan(cfg, PODS * FAST)
    model8 = init_params(ap8, seed=SEED, device="cuda", mesh=mesh)
    tp8 = dict(tp=PODS * FAST, pods=PODS, ar_strategy="hier_rd")
    col = build_replica(spec.replace(**tp8), ap=ap8, model=model8,
                        device="cuda")
    ref = {r.rid: r.output for r in col.run(fresh(reqs))}
    d8 = build_replica(spec.replace(disagg=True, prefill_block_size=0,
                                    decode_tp=PODS * FAST, decode_pods=PODS,
                                    ar_strategy="hier_rd"),
                       prefill_ap=ap, prefill_model=model, decode_ap=ap8,
                       decode_model=model8, device="cuda")
    outs = {r.rid: r.output for r in d8.run(fresh(reqs))}
    log(f"  f32, 2 layers: {sum(np.array_equal(outs[k], ref[k]) for k in ref)}"
        f"/{len(ref)} requests of disagg tp=1 -> tp=8 bitwise colocated "
        "tp=8")
    seqs = [(r.prompt, ref[r.rid]) for r in reqs]
    serve_gate("f32, 2 layers: disagg prefill tp=1 -> decode tp=8 against "
               "colocated tp=8", reqs, outs, ref,
               ForcedDecode(model8, ap8, SERVE_SLOTS, ctx, mesh,
                            prefill_with=(model, ap)).logits(seqs),
               ForcedDecode(model8, ap8, SERVE_SLOTS, ctx, mesh).logits(seqs),
               limits=(TF_MAX, TF_MEAN), floor=0.75)
    del model, model8, col, d8
    free_device()


# ---------------------------------------------------------------------------
# Phase 30: the int8 KV cache, int8 block weights and the ring window cache
# ---------------------------------------------------------------------------

# Kernel 1's int8 form at (B, Hq, Hkv, hd, S, window, positions lo..hi):
# the decode paths' shapes (DECODE_SHAPES), and g = 1 at hd 128 and g = 16
# at hd 64; rows whose range starts at 0 take the split edges first.
KV8_SHAPES = {**DECODE_SHAPES,
              "g1_hd128": (B, 8, 8, 128, 640, 0, (0, 639)),
              "g16_hd64": (B, 16, 1, 64, S_MAX, 0, (0, S_MAX - 1))}
KV8_EDGES = (0, 127, 128, 255, 256, 511, 512, 1023)
# The W8 GEMM at llama3.2-1b's decode leaves, (K, N, P) with the column's
# scale s[n % P] (P = hd for wq / wk / wv): tp=1, and the tp=8 fold (the
# column-parallel leaves' N and the row-parallel leaves' K cut by 8).
_TP8 = PODS * FAST
W8_LEAVES = {
    1: {"wq": (D_MODEL, HQ * HD, HD), "wk": (D_MODEL, HKV * HD, HD),
        "wv": (D_MODEL, HKV * HD, HD), "wo": (HQ * HD, D_MODEL, D_MODEL),
        "wg": (D_MODEL, D_FF, D_FF), "wu": (D_MODEL, D_FF, D_FF),
        "wd": (D_FF, D_MODEL, D_MODEL)},
    _TP8: {"wq": (D_MODEL, HQ * HD // _TP8, HD),
           "wk": (D_MODEL, HKV * HD // _TP8, HD),
           "wv": (D_MODEL, HKV * HD // _TP8, HD),
           "wo": (HQ * HD // _TP8, D_MODEL, D_MODEL),
           "wg": (D_MODEL, D_FF // _TP8, D_FF // _TP8),
           "wu": (D_MODEL, D_FF // _TP8, D_FF // _TP8),
           "wd": (D_FF // _TP8, D_MODEL, D_MODEL)}}
# |kernel - plain| <= W8_TOL * max|plain|: both round one f32 sum of the
# same bf16 products to bf16 (2^-8 relative), in another order.
W8_TOL = 1e-2
# The reference's bar for int8 KV and int8 weights: teacher-forced top-1
# agreement with the bf16 run (tests/dist_cases/case_pp_and_perf.py:80,
# :98).
TOP1_FLOOR = 0.8
# hymba-1.5b's ring: a 64-token prompt decoded 1100 steps, past its 1024
# window.
RING_PROMPT, RING_NEW = 64, 1100


def kv8_case(gen, dtype, name: str) -> dict:
    """Kernel 1's int8 form at one of KV8_SHAPES within TOL of its plain
    version (the cache dequantized as the reference's attn_core, then the
    plain version), a second call bitwise the first; kernel, plain
    version, kernel 1's bf16 form and SDPA on the dequantized cache
    timed beside the bound (the visible rows' int8 K/V and scales)."""
    b, hq, hkv, hd, s, win, (lo, hi) = KV8_SHAPES[name]
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(dtype)
    k8, v8 = (torch.randint(-127, 128, (b, s, hkv, hd), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    ks, vs = ((torch.rand((b, s, hkv), generator=gen, device="cuda") * 0.05
               + 1e-3).to(torch.bfloat16) for _ in range(2))
    pos = torch.randint(lo, hi + 1, (b,), generator=gen, device="cuda",
                        dtype=torch.int32)
    edges = [p for p in KV8_EDGES if lo <= p <= hi][:b]
    pos[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device="cuda")

    def kern():
        return decode_attention(q, k8, v8, pos, window=win, k_scale=ks,
                                v_scale=vs)

    def plain():
        return decode_attention_int8_ref(q, k8, v8, ks, vs, pos, window=win)

    out = kern()
    tag = f"decode_attention_int8 {name} {tuple(q.shape)} S={s} window={win}"
    err = check_close(tag, out, plain(), dtype)
    if not torch.equal(kern(), out):
        raise AssertionError(f"{tag}: a second call differs from the first")
    kd, vd = dequant_kv(k8, ks, dtype), dequant_kv(v8, vs, dtype)
    kpos, last = torch.arange(s, device="cuda")[None, :], pos.long()[:, None]
    mask = (kpos <= last) & (kpos > last - win) if win else kpos <= last
    t_sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
        attn_mask=mask[:, None, None, :], enable_gqa=True))
    t_bf = time_ms(lambda: decode_attention(q, kd, vd, pos, window=win))
    t = (time_ms(kern), time_ms(plain))
    n_keys = int(mask.sum())
    io = q.element_size() * 2 * b * hq * hd + 2 * n_keys * hkv * (hd + 2) \
        + 4 * b
    bd = bound_ms(io, 4.0 * hq * hd * n_keys, dtype)
    log(f"  decode_attention_int8 {name} [{str(dtype)[6:]}]: kernel_ms="
        f"{t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t_sdpa:.4f} (SDPA on "
        f"the dequantized cache) bf16_form_ms={t_bf:.4f} (kernel 1 on the "
        f"dequantized cache) bound_ms={bd[0]:.4f} ({bd[1]})")
    return {"max_abs_err": err, "ms": t[0], "plain_ms": t[1],
            "library_ms": t_sdpa, "bf16_form_ms": t_bf, "bound_ms": bd[0],
            "bound_by": bd[1]}


def w8_case(gen, R: int, M: int, leaf: str) -> dict:
    """The W8 GEMM at one decode leaf: within W8_TOL of its plain version,
    a second call bitwise the first; kernel, plain version (dequantize,
    then bmm) and one torch.bmm on the bf16 weight timed beside the bound
    (the int8 weight, its scales, x and the output once)."""
    K, N, P = W8_LEAVES[R][leaf]
    x = torch.randn((R, M, K), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    q = torch.randint(-127, 128, (R, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = (torch.rand((R, P), generator=gen, device="cuda") / (127 * K ** 0.5)
         + 1e-5).to(torch.bfloat16)
    out, ref = w8_matmul(x, q, s), w8_matmul_ref(x, q, s)
    err, top = max_err(out, ref), float(ref.float().abs().max())
    tag = f"w8_matmul {leaf} R={R} M={M} K={K} N={N} P={P}"
    if err > W8_TOL * top or not torch.isfinite(out).all():
        raise AssertionError(f"{tag}: max|kernel-plain| {err:.4g} above "
                             f"{W8_TOL:g} x max|plain| {top:.4g}")
    if not torch.equal(w8_matmul(x, q, s), out):
        raise AssertionError(f"{tag}: a second call differs from the first")
    wb = dequant_weight(q, s)
    t = (time_ms(lambda: w8_matmul(x, q, s)),
         time_ms(lambda: w8_matmul_ref(x, q, s)),
         time_ms(lambda: torch.bmm(x, wb)))
    bd = bound_ms(R * (K * N + 2 * P + 2 * M * K + 2 * M * N),
                  2.0 * R * M * N * K, torch.bfloat16)
    log(f"  {tag}: max|kernel-plain| {err:.3e} (max|plain| {top:.3g}); "
        f"kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
        f"(one bmm on the bf16 weight; kernel / bmm {t[0] / t[2]:.2f}) "
        f"bound_ms={bd[0]:.4f} ({bd[1]})")
    return {"max_abs_err": err, "ms": t[0], "plain_ms": t[1],
            "library_ms": t[2], "bound_ms": bd[0], "bound_by": bd[1]}


def phase_q8_kernels() -> dict:
    """(a) Kernel 1's int8 form and the W8 GEMM against their plain
    versions at the paths' shapes; the records' top level is llama3.2-1b's
    tp=1 decode shape (bf16) and its MLP up-projection at M = 8."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 30)
    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name in KV8_SHAPES:
            r = kv8_case(gen, dtype, name)
            if dtype == torch.bfloat16:
                rec.setdefault("decode_attention_int8", {**r, "shapes": {}})[
                    "shapes"][name] = r
    shapes = {f"{leaf}_R{R}_M{M}": w8_case(gen, R, M, leaf)
              for R in W8_LEAVES for M in (B, 64) for leaf in W8_LEAVES[R]}
    rec["w8_matmul"] = {**shapes[f"wg_R1_M{B}"], "shapes": shapes}
    free_device()
    return rec


def greedy_graph(model, ap, ctx, mesh, prompts: np.ndarray, new: int, *,
                 s_max: int, decode_model=None, kv: Optional[dict] = None,
                 graph: bool = True, **step_kw) -> tuple:
    """Greedy decode through ``build_prefill`` (into a cache made with
    ``kv``) and ``build_decode_step(**step_kw)``, the steps one captured
    graph (or eager).  Returns (tokens (b, prompt + new), decode tok/s
    over the replayed steps)."""
    b, S = prompts.shape
    kv = kv or {}
    with torch.inference_mode():
        cache = init_cache(ap, b, s_max, device="cuda", mesh=mesh,
                           ef_sites=ef_sites_for(ctx, ap.cfg), **kv)
        nxt, cache = build_prefill(ap, ctx, mesh, s_max=s_max)(
            model, torch.as_tensor(prompts, device="cuda").long(),
            cache=cache)
        step = build_decode_step(ap, ctx, mesh, **step_kw)
        dm = model if decode_model is None else decode_model
        tok, pos = nxt.clone(), torch.full((b,), S, dtype=torch.int32,
                                           device="cuda")
        out = torch.zeros((new, b), dtype=torch.int32, device="cuda")
        out[0] = tok

        def body():
            n, _ = step(dm, cache, tok, pos)
            tok.copy_(n)
            pos.add_(1)

        cs = CapturedStep(body, graph,
                          workspace=getattr(mesh, "workspace", None))
        for i in range(1, new):
            if i == 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            cs()
            out[i] = tok
        torch.cuda.synchronize()
        tps = b * (new - 3) / (time.perf_counter() - t0)
    return np.concatenate([prompts, out.T.cpu().numpy()], 1), tps


def top1_agreement(logits: torch.Tensor, tokens: np.ndarray,
                   prompt: int) -> float:
    """Share of teacher-forced steps whose argmax is the reference's next
    token (logits (b, new, V) over tokens (b, prompt + new))."""
    want = torch.as_tensor(tokens[:, prompt:], device=logits.device)
    return float((logits.argmax(-1) == want).float().mean())


def phase_kv8_serve() -> dict:
    """(b) Phase 27's trace through the batcher on the int8 cache (full
    admission, dense), llama3.2-1b full width and depth, bf16, at tp=1 and
    tp=8 (hier_rd): the trace timed as phase 27 times it (a warm-up
    replay, then a timed one), graph == eager bitwise
    on its first SERVE_SLOTS requests (the eager run's launches counted),
    top-1 agreement of the int8 cache's teacher-forced logits with the
    bf16 run's tokens at least TOP1_FLOOR, and the cache's bytes against
    the bf16 cache's."""
    cfg = serve_config()
    reqs = make_trace(SERVE_REQS, mean_in=SERVE_MEAN_IN,
                      mean_out=SERVE_MEAN_OUT, rate=SERVE_RATE,
                      vocab=cfg.vocab_size, seed=SEED)
    launches = {}
    for tp, ref_key in ((1, "tp=1 dense"), (PODS * FAST, "tp=8 paged")):
        mesh, ctx = (None, LOCAL) if tp == 1 else mesh_and_ctx(
            tp, PODS, ar_strategy="hier_rd", device="cuda")
        ap = make_plan(cfg, tp)
        model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
        label = f"tp={tp}" + (f" ({PODS}x{FAST} hier_rd)" if mesh else "")

        def batcher(**kw):
            return ContinuousBatcher(ap, model, slots=SERVE_SLOTS,
                                     s_max=S_MAX, ctx=ctx, mesh=mesh,
                                     kv_quant=True, device="cuda", **kw)

        fp_tps = SERVE_STATS.get("tp=1 dense" if tp == 1 else
                                 f"tp=8 ({PODS}x{FAST}) hier_rd paged",
                                 {}).get("throughput_tok_s", float("nan"))
        b = batcher()
        outs, m = serve_timed(f"{label} int8 KV", b, reqs)
        kv8 = sum(b.cache[n].numel() * b.cache[n].element_size()
                  for n in transformer.KV_LEAVES if n in b.cache)
        fp = init_cache(ap, SERVE_SLOTS, S_MAX, device="cuda", mesh=mesh)
        fp_bytes = sum(fp[n].numel() * fp[n].element_size()
                       for n in ("k", "v"))
        del fp
        log(f"  {label} int8 KV: throughput {m.throughput_tok_s:.1f} tok/s "
            f"(the bf16 cache's in phase 27: {fp_tps:.1f}); cache "
            f"{kv8 / 2**20:.1f} MiB "
            f"(int8 K/V + bf16 scales) against the bf16 cache's "
            f"{fp_bytes / 2**20:.1f} MiB: {kv8 / fp_bytes:.4f}x")
        sub = reqs[:SERVE_SLOTS]
        g_sub, _ = serve_run(batcher(), sub)
        reset_counts()
        e_sub, _ = serve_run(batcher(cuda_graph=False), sub)
        key = f"serve_kv8_tp{tp}"
        launches[key] = counts()
        if not same_outputs(g_sub, e_sub) or any(
                not np.array_equal(g_sub[r.rid], outs[r.rid]) for r in sub):
            raise AssertionError(f"{label} int8 KV: graph tokens differ "
                                 "from eager tokens")
        if launches[key]["decode_attention_int8"] == 0 \
                or launches[key]["decode_attention"]:
            raise AssertionError(f"{label} int8 KV: launches "
                                 f"{launches[key]}")
        log(f"  {label} int8 KV, first {len(sub)} requests: graph tokens == "
            f"eager tokens, bitwise; eager launches {launches[key]}")
        ref = SERVE_OUTS[ref_key]
        seqs = [(r.prompt, ref[r.rid]) for r in reqs]
        lg8 = ForcedDecode(model, ap, SERVE_SLOTS, ctx, mesh,
                           kv_quant=True).logits(seqs)
        lgb = ForcedDecode(model, ap, SERVE_SLOTS, ctx, mesh).logits(seqs)
        d = torch.cat([(a - c).abs().reshape(-1) for a, c in zip(lg8, lgb)])
        agree = np.mean(np.concatenate([
            (a.argmax(-1).cpu().numpy() == ref[r.rid])
            for a, r in zip(lg8, reqs)]))
        log(f"  {label} int8 KV teacher-forced on the bf16 cache's tokens: "
            f"top-1 agreement {agree:.4f} (floor {TOP1_FLOOR:g}); logits "
            f"against the bf16 cache's max|diff| {float(d.max()):.4f}, "
            f"mean {float(d.mean()):.3e}")
        if agree < TOP1_FLOOR:
            raise AssertionError(f"{label} int8 KV: top-1 agreement "
                                 f"{agree:.4f}")
        del model, b, lg8, lgb, d
        free_device()
    return launches


def dequantized_model(qmodel):
    """The int8-weight model with every {q, s} leaf replaced by its
    dequant_layer value, bf16: the reference's weight_quant decode."""
    blocks = []
    for bp in qmodel.blocks:
        groups = {g: dequant_layer(dict(grp.items()))
                  for g, grp in bp.named_children()}
        groups.update(dict(bp.named_parameters(recurse=False)))
        blocks.append(groups)
    out = transformer.DenseLM({}, [], {})
    out.embed, out.final_norm = qmodel.embed, qmodel.final_norm
    out.blocks = torch.nn.ModuleList(transformer.Block(b) for b in blocks)
    return out


def phase_w8_decode() -> dict:
    """(c) llama3.2-1b full width, SERVE_LAYERS deep, with int8 block weights
    (``build_decode_step(weight_quant=True)``; prefill on the bf16
    weights, as the reference's weight_quant is decode-only), the steps
    one captured graph, at tp=1 and tp=8 (hier_rd), NEW steps: graph ==
    eager tokens (the eager run's launches counted), teacher-forced top-1
    agreement with the bf16 run's tokens at least TOP1_FLOOR, decode tok/s
    beside the bf16 weights' (bf16, int8, int8, bf16), and at tp=1 the
    first step's logits against the dequant_layer model's."""
    cfg = serve_config()
    prompts = np.random.default_rng(SEED + 30).integers(
        0, cfg.vocab_size, (B, PROMPT))
    launches = {}
    for tp in (1, PODS * FAST):
        mesh, ctx = (None, LOCAL) if tp == 1 else mesh_and_ctx(
            tp, PODS, ar_strategy="hier_rd", device="cuda")
        ap = make_plan(cfg, tp)
        model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
        qmodel = quantize_model(model)
        label = f"tp={tp}" + (f" ({PODS}x{FAST} hier_rd)" if mesh else "")
        kw = dict(s_max=S_MAX)
        q8 = dict(decode_model=qmodel, weight_quant=True, **kw)
        tps = {"bf16": [], "int8": []}
        ref, t = greedy_graph(model, ap, ctx, mesh, prompts, NEW, **kw)
        tps["bf16"].append(t)
        toks, t = greedy_graph(model, ap, ctx, mesh, prompts, NEW, **q8)
        tps["int8"].append(t)
        tps["int8"].append(greedy_graph(model, ap, ctx, mesh, prompts, NEW,
                                        **q8)[1])
        tps["bf16"].append(greedy_graph(model, ap, ctx, mesh, prompts, NEW,
                                        **kw)[1])
        reset_counts()
        eager, _ = greedy_graph(model, ap, ctx, mesh, prompts, NEW,
                                graph=False, **q8)
        key = f"w8_tp{tp}"
        launches[key] = counts()
        want = 7 * cfg.n_layers * (NEW - 1)
        if not np.array_equal(eager, toks) \
                or launches[key]["w8_matmul"] != want:
            raise AssertionError(f"{label} int8 weights: graph tokens == "
                                 f"eager {np.array_equal(eager, toks)}, "
                                 f"launches {launches[key]} (w8_matmul "
                                 f"{want} expected)")
        lm = LayerMap(transformer.w8_keep(ctx), cfg.dtype)
        tf8 = teacher_forced_decode(qmodel, ref, ap, ctx, mesh,
                                    layer_map=lm, prefill_model=model)
        tfb = teacher_forced_decode(model, ref, ap, ctx, mesh)
        agree = top1_agreement(tf8[..., :cfg.vocab_size], ref, PROMPT)
        d = (tf8.float() - tfb.float()).abs()
        log(f"  {label} int8 weights: graph tokens == eager tokens "
            f"(eager launches {launches[key]}); decode tok/s bf16 "
            f"{' / '.join(f'{v:.1f}' for v in tps['bf16'])}, int8 "
            f"{' / '.join(f'{v:.1f}' for v in tps['int8'])} (int8 / bf16 "
            f"{np.mean(tps['int8']) / np.mean(tps['bf16']):.3f}); "
            f"teacher-forced on the bf16 weights' tokens: top-1 agreement "
            f"{agree:.4f} (floor {TOP1_FLOOR:g}), logits max|diff| "
            f"{float(d.max()):.4f}, mean {float(d.mean()):.3e}")
        if agree < TOP1_FLOOR:
            raise AssertionError(f"{label} int8 weights: top-1 agreement "
                                 f"{agree:.4f}")
        if tp == 1:
            dq = teacher_forced_decode(dequantized_model(qmodel),
                                       ref[:, :PROMPT + 2], ap,
                                       prefill_model=model)
            e = (tf8[:, 1].float() - dq[:, 1].float()).abs()
            log(f"  tp=1 first decode step, w8_matmul against the "
                f"dequant_layer model in bf16: logits max|diff| "
                f"{float(e.max()):.4f}, mean {float(e.mean()):.3e} (the "
                f"kernel's rounding against bmm's)")
        del model, qmodel, tf8, tfb, d, lm
        free_device()
    return launches


def ring_pair(model, ap, prompts: np.ndarray, new: int, label: str,
              floor: float = 0.0) -> None:
    """Greedy decode on the ring and on the full cache, then both
    teacher-forced on the full cache's tokens: provable_gate of the ring's
    tokens against the full cache's (with ``floor``, on at least that
    share of the steps)."""
    S = prompts.shape[1]
    full_s = S + new + 1
    ring, _ = greedy_graph(model, ap, LOCAL, None, prompts, new, s_max=full_s,
                           kv={"window_cache": True}, window_cache=True)
    full, _ = greedy_graph(model, ap, LOCAL, None, prompts, new, s_max=full_s)
    lr = teacher_forced_decode(model, full, ap, prompt=S, s_max=full_s,
                               kv={"window_cache": True})
    lf = teacher_forced_decode(model, full, ap, prompt=S, s_max=full_s)
    n = provable_gate(ring, full, lr, lf, S)
    d = (lr.float() - lf.float()).abs()
    log(f"  {label}: ring ({ap.cfg.sliding_window} slots) tokens == full "
        f"cache tokens on {n}/{lr.shape[0] * lr.shape[1]} steps that "
        f"provable_gate checks (fully equal on "
        f"{int((ring == full).all(1).sum())}/{ring.shape[0]} rows); "
        f"teacher-forced logits max|diff| {float(d.max()):.4g}, mean "
        f"{float(d.mean()):.3e}"
        + (f", at least {floor:g} of the steps checked" if floor else ""))
    if n < floor * lr.shape[0] * lr.shape[1]:
        raise AssertionError(f"{label}: provable_gate checked only {n} "
                             "steps")


def phase_ring() -> None:
    """(d) hymba-1.5b with the ring-buffer window cache, full width, bf16
    at its path's depth (PATH_LAYERS), a RING_PROMPT-token prompt decoded
    RING_NEW steps past its window, against the full cache by
    provable_gate; then f32 at 2 layers, where the gate must check at
    least three quarters of the steps."""
    free_device()
    cfg = dataclasses.replace(get_config(HYB_ARCH),
                              n_layers=PATH_LAYERS[HYB_ARCH])
    prompts = np.random.default_rng(SEED + 31).integers(
        0, cfg.vocab_size, (B, RING_PROMPT))
    ap = make_plan(cfg, 1)
    model = init_params(ap, seed=SEED, device="cuda")
    ring_pair(model, ap, prompts, RING_NEW,
              f"{HYB_ARCH} {cfg.n_layers} layers, bf16, {RING_PROMPT} + "
              f"{RING_NEW}")
    del model
    free_device()
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    ap2 = make_plan(cfg2, 1)
    ring_pair(init_params(ap2, seed=SEED, device="cuda"), ap2, prompts,
              RING_NEW, f"{HYB_ARCH} 2 layers, f32, {RING_PROMPT} + "
              f"{RING_NEW}", floor=0.75)
    free_device()


# ---------------------------------------------------------------------------
# Phase 31: sequence-parallel prefill
# ---------------------------------------------------------------------------

# New tokens of the SP phase's generate and of its batcher's requests, and
# the timed prefills of each configuration (after one counted call).
SP_NEW, SP_REPS, SP_REQS = 16, 3, 8
# (label, ctx overrides, the label of the SP-off reference, its bars)
SP_RUNS = (
    ("hier_rd, SP off", {}, None, None),
    ("hier_rd, SP on", dict(seq_parallel="on"), "hier_rd, SP off",
     (TF_MAX, TF_MEAN)),
    ("hier_rd, SP auto", dict(seq_parallel="auto"), "hier_rd, SP off",
     (TF_MAX, TF_MEAN)),
    ("hier_rd + int8, SP off", dict(ar_quant="int8"), None, None),
    ("hier_rd + int8, SP on", dict(ar_quant="int8", seq_parallel="on"),
     "hier_rd + int8, SP off", None),        # QUANT_TF[8], set below
    ("auto + overlap, SP off", dict(ar_strategy="auto", overlap_matmul=True),
     None, None),
    ("auto + overlap, SP on", dict(ar_strategy="auto", overlap_matmul=True,
                                   seq_parallel="on"),
     "auto + overlap, SP off", (TF_MAX, TF_MEAN)),
)
SP_KERNELS = ("flash_attention", "rd_all_reduce", "collective_matmul_rd",
              "quantize_pack", "unpack_dequant", "quant_rd_all_reduce")


def sp_prefill(model, ap, ctx, mesh, toks: torch.Tensor) -> tuple:
    """One prefill forward (``forward_lm`` with the K/V seeds) under
    ``ctx``: (vocab-gathered logits (B, S, V), the forward's launches, the
    median ms of SP_REPS more, host clock around a synchronized call)."""
    with torch.inference_mode():
        reset_counts()
        lg, _ = forward_lm(model, toks, ap, ctx, mesh, collect_state=True)
        lg = gather_vocab(lg)
        torch.cuda.synchronize()
        c = counts()
        ts = []
        for _ in range(SP_REPS):
            t0 = time.perf_counter()
            forward_lm(model, toks, ap, ctx, mesh, collect_state=True)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
    return lg, c, float(np.median(ts))


def phase_sp() -> dict:
    """llama3.2-1b at full width and depth, tp=8 (4 x 2), batch 8, prompt
    512: the prefill forward under each of SP_RUNS (launches, the median
    prefill time), its logits against the same configuration with SP off
    within the fp-wire bars (the int8 bars on the int8 wire), and whether
    they are bitwise equal; the engine's generate and a batcher trace
    (full admission, paged) under SP on against SP off; qwen3-moe-30b-a3b
    at 4 layers, f32, SP on against off (the MoE pod cut)."""
    cfg = get_config("llama3.2-1b")
    ap = make_plan(cfg, PODS * FAST)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, PROMPT))
    toks = torch.as_tensor(prompts, device="cuda")
    msg = B * PROMPT * D_MODEL * 2
    log(f"  tuner (analytic, {autotune.active().net.name}) at the "
        f"prefill's residual ({msg} B a rank, fast {FAST}, slow {PODS}): "
        f"SP {autotune.analytic_sp_choice(msg, FAST, PODS, autotune.active().net)}"
        f", fused all-reduce "
        f"{autotune.analytic_choice(msg, FAST, PODS, autotune.active().net).strategy}")
    refs, launches = {}, {}
    for label, kw, ref, bars in SP_RUNS:
        sctx = ctx.replace(**kw)
        lg, c, ms = sp_prefill(model, ap, sctx, mesh, toks)
        launches[f"sp_prefill {label}"] = c
        log(f"  {label}: prefill forward {ms:.2f} ms (median of "
            f"{SP_REPS}); launches {({k: c[k] for k in SP_KERNELS})}")
        if ref is None:
            refs[label] = lg
            continue
        limits = bars or QUANT_TF[8]
        mx, mean = gate(f"{label} vs {ref}", lg, refs[ref], limits)
        log(f"      bitwise equal: {torch.equal(lg, refs[ref])}")
        if mx > limits[0] or mean > limits[1]:
            raise AssertionError(f"SP prefill logits ({label}) differ from "
                                 f"{ref}'s")
        del lg
    del refs
    free_device()
    # the engine's generate: SP on against SP off, tokens and launches
    L = cfg.n_layers
    expect = {"flash_attention": L, "decode_attention": L * (SP_NEW - 1),
              "rd_all_reduce": (2 * L + 1) * SP_NEW}
    res = {}
    for sp in ("off", "on"):
        eng = InferenceEngine(ap, model, ctx=ctx.replace(seq_parallel=sp),
                              mesh=mesh, s_max=S_MAX, device="cuda")
        res[sp], launches[f"sp_{sp}_tp8_hier_rd"] = run_path(
            eng, prompts, f"tp=8 hier_rd generate, SP {sp}", expect,
            new=SP_NEW)
        del eng
    same = np.array_equal(res["on"].tokens, res["off"].tokens)
    log(f"  generate SP on: prefill {res['on'].prefill_s * 1e3:.2f} ms "
        f"against SP off {res['off'].prefill_s * 1e3:.2f} ms (one run "
        f"each); tokens bitwise SP off's: {same}")
    if not same:
        tf = teacher_forced(model, res["off"].tokens, ap, ctx, mesh)
        n = margin_gate(res["on"].tokens, res["off"].tokens, top2_gap(tf),
                        PROMPT, BF16_GAP)
        log(f"    tokens == SP off's on {n}/{B * SP_NEW} steps gated at gap "
            f"{BF16_GAP:g}")
        del tf
    # the batcher's full admission, paged, on phase 27's first requests
    reqs = make_trace(SERVE_REQS, mean_in=SERVE_MEAN_IN,
                      mean_out=SERVE_MEAN_OUT, rate=SERVE_RATE,
                      vocab=cfg.vocab_size, seed=SEED)[:SP_REQS]
    outs = {}
    for sp in ("off", "on"):
        b = ContinuousBatcher(ap, model, slots=SERVE_SLOTS, s_max=S_MAX,
                              ctx=ctx.replace(seq_parallel=sp), mesh=mesh,
                              block_size=BLOCK, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        outs[sp], m = serve_run(b, reqs)
        log(f"  batcher tp=8 paged, SP {sp}: {m.completed}/{m.requests} "
            f"requests, {m.total_new_tokens} tokens, throughput "
            f"{m.throughput_tok_s:.1f} tok/s, TTFT p50 "
            f"{m.ttft_s_p50 * 1e3:.2f} ms ({time.perf_counter() - t0:.1f} "
            f"s, one run); rd_all_reduce launches {counts()['rd_all_reduce']}")
    differ = sum(not np.array_equal(outs["on"][k], outs["off"][k])
                 for k in outs["off"])
    log(f"  batcher SP on: {len(outs['off']) - differ}/{len(outs['off'])} "
        "requests bitwise SP off's")
    if same and differ:
        raise AssertionError("SP batcher tokens differ where the SP "
                             "generate's were bitwise")
    del model
    free_device()
    launches.update(phase_sp_moe())
    return launches


def phase_sp_moe() -> dict:
    """qwen3-moe-30b-a3b at full width, 4 layers, f32, its default
    capacity factor (pairs may overflow), tp=8 (4 x 2, hier_rd): the
    prefill forward with SP on against SP off within the f32 MoE bars
    (TF_MAX, TF_MEAN), bitwise reported.  Under SP rank (p, f) dispatches
    chunk p of its sequence piece f, the chunk SP off gives some rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=4,
                              dtype=torch.float32)
    ap = make_plan(cfg, PODS * FAST)
    mesh, ctx = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                             device="cuda")
    model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, MOE_PROMPT)), device="cuda")
    lg, launches = {}, {}
    for sp in ("off", "on"):
        lg[sp], launches[f"sp_moe_{sp}"], ms = sp_prefill(
            model, ap, ctx.replace(seq_parallel=sp), mesh, toks)
        c = launches[f"sp_moe_{sp}"]
        log(f"  {MOE_ARCH} 4 layers f32 tp=8 SP {sp}: prefill forward "
            f"{ms:.2f} ms; launches rd_all_reduce {c['rd_all_reduce']}, "
            f"moe_expert_ffn {c['moe_expert_ffn']}")
    mx, mean = gate("MoE SP on vs off", lg["on"], lg["off"])
    log(f"      bitwise equal: {torch.equal(lg['on'], lg['off'])}")
    if mx > TF_MAX or mean > TF_MEAN:
        raise AssertionError("MoE SP prefill logits differ from SP off's")
    del model, lg
    free_device()
    return launches


# ---------------------------------------------------------------------------
# Phase 32: the other dense archs and the paper's Llama 3.1 shapes
# ---------------------------------------------------------------------------

DENSE_PROMPT, DENSE_NEW = 128, 16
DENSE_S_MAX = DENSE_PROMPT + DENSE_NEW       # 144: 9 blocks of BLOCK
# (name, config, depth: 0 keeps the config's)
DENSE_ARCHS = (("llama3.1-405b", LLAMA31_405B, 2),
               ("llama3.1-70b", LLAMA31_70B, 2),
               ("mistral-large-123b", get_config("mistral-large-123b"), 2),
               ("qwen1.5-32b", get_config("qwen1.5-32b"), 2),
               ("codeqwen1.5-7b", get_config("codeqwen1.5-7b"), 0))
# Kernels 1 / 2 at these paths' decode shapes, bf16 (B, Hq, Hkv, hd, S,
# window, positions): the 405B's g 16 and mistral's g 12 at tp=8 (the
# fold: 8 ranks x 8 sequences, one kv head a rank) and at tp=1.
DENSE_DECODE_SHAPES = {
    "405b_tp8_fold": (B * PODS * FAST, 16, 1, 128, DENSE_S_MAX, 0,
                      (DENSE_PROMPT, DENSE_S_MAX - 1)),
    "mistral_tp8_fold": (B * PODS * FAST, 12, 1, 128, DENSE_S_MAX, 0,
                         (DENSE_PROMPT, DENSE_S_MAX - 1)),
    "405b_tp1": (B, 128, 8, 128, DENSE_S_MAX, 0,
                 (DENSE_PROMPT, DENSE_S_MAX - 1)),
    "mistral_tp1": (B, 96, 8, 128, DENSE_S_MAX, 0,
                    (DENSE_PROMPT, DENSE_S_MAX - 1))}
# Kernel 3 at the prefill's (B, Hq, Hkv, S, hd, window), tp=8 fold.
DENSE_FLASH_SHAPES = {"405b_tp8_fold": (B * PODS * FAST, 16, 1,
                                        DENSE_PROMPT, 128, 0),
                      "mistral_tp8_fold": (B * PODS * FAST, 12, 1,
                                           DENSE_PROMPT, 128, 0)}
# Kernel 5 at (M, K a rank, N): the 405B's MLP down in decode (d_ff
# 53248 / 8, d_model 16384) and qwen1.5-32b's (27392 / 8, 5120).
DENSE_FUSED_SHAPES = {"405b_wd": (B, 53248 // (PODS * FAST), 16384),
                      "qwen1_5_32b_wd": (B, 27392 // (PODS * FAST), 5120)}


def plant_qkv_bias(model, ap, mesh, seed: int) -> None:
    """Seeded nonzero QKV biases in place of the init's zeros (the
    reference draws zeros, under which a missing or misplaced add computes
    the same numbers): drawn per original head, placed into the plan's
    slots (dead slots zero) and cut over the ranks as the sharding cuts
    them, so one seed is one function at every tp."""
    cfg = ap.cfg
    gen = torch.Generator(device=model.embed["tok"].device)
    gen.manual_seed(seed)
    for bp in model.blocks:
        for name, n, m in (("bq", cfg.n_heads, ap.gqa.q_map),
                           ("bk", cfg.n_kv_heads, ap.gqa.kv_map),
                           ("bv", cfg.n_kv_heads, ap.gqa.kv_map)):
            b = 0.5 * torch.randn((n, cfg.head_dim), generator=gen,
                                  device=gen.device)
            b = place_heads(b, m).to(cfg.dtype)
            bp.attn[name].copy_(shard_params({"attn": {name: b}},
                                             mesh)["attn"][name])


def dense_arch(name: str, cfg, launches: dict) -> None:
    """One arch at tp=1 and at tp=8 (4 x 2, hier_rd), batch 8, prompt
    128, 16 new, bf16, seeded weights (nonzero QKV biases planted): each
    through ``run_path`` (exact launches, graph == eager, tok/s), then
    tp=8's tokens margin-gated against tp=1's and its teacher-forced
    logits within (TF_MAX, TF_MEAN) of tp=1's.  Each model is freed
    before the next is built."""
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, DENSE_PROMPT))
    L = cfg.n_layers
    ref = ref_logits = None
    for tp, pods in ((1, 1), (PODS * FAST, PODS)):
        ap = make_plan(cfg, tp)
        mesh, ctx = mesh_and_ctx(tp, pods, ar_strategy="hier_rd",
                                 device="cuda")
        t0 = time.perf_counter()
        model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
        if cfg.qkv_bias:
            plant_qkv_bias(model, ap, mesh, SEED + 7)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  {name} tp={tp}: {L} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads (GQA g={ap.gqa.g} "
            f"u={ap.gqa.u}), {n_params / 1e9:.3f} B parameters "
            f"(param_count {cfg.param_count() / 1e9:.3f} B), built in "
            f"{time.perf_counter() - t0:.1f} s")
        expect = {"flash_attention": L,
                  "decode_attention": L * (DENSE_NEW - 1),
                  "rd_all_reduce": (2 * L + 1) * DENSE_NEW if tp > 1 else 0}
        key = f"dense_{name}_tp{tp}"
        eng = InferenceEngine(ap, model, ctx=ctx, mesh=mesh,
                              s_max=DENSE_S_MAX, device="cuda")
        res, launches[key] = run_path(eng, prompts, f"{name} tp={tp}",
                                      expect, new=DENSE_NEW)
        del eng
        if tp == 1:
            ref = res.tokens
            ref_logits = teacher_forced(model, ref, ap).cpu()
        else:
            want = ref_logits.to("cuda")
            n = margin_gate(res.tokens, ref, top2_gap(want), DENSE_PROMPT,
                            BF16_GAP)
            mx, mean = logits_gap(model, ref, ap, ctx, mesh, want)
            log(f"    tp=8 hier_rd tokens == tp=1 tokens on {n}/"
                f"{B * DENSE_NEW} steps gated at gap {BF16_GAP:g} (fully "
                f"equal: {np.array_equal(res.tokens, ref)}); teacher-forced "
                f"logits max|diff| {mx:.4f}, mean {mean:.3e} (limits "
                f"{TF_MAX:g}, {TF_MEAN:g})")
            if mx > TF_MAX or mean > TF_MEAN:
                raise AssertionError(f"{name} tp=8 logits differ from tp=1's")
            del want
        del model
        free_device()


def phase_dense_kernels(rec: dict) -> None:
    """Kernels 1 / 2, 3, 4 and 5 against their plain versions at the
    dense archs' shapes no earlier path runs, timed beside their library
    yardsticks and bounds; the records go into ``rec``'s shape tables."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 32)
    for name in DENSE_DECODE_SHAPES:
        d, p = decode_case(gen, torch.bfloat16, name, DENSE_DECODE_SHAPES)
        rec["decode_attention"]["shapes"][name] = d
        rec["paged_decode_attention"]["shapes"][name] = p
    for name, shape in DENSE_FLASH_SHAPES.items():
        err, t, bnd = flash_case(gen, torch.bfloat16, shape)
        log(f"  flash_attention {name} {shape} [bfloat16]: kernel_ms="
            f"{t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        rec["flash_attention"][name] = {
            "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
            "library_ms": t[2], "bound_ms": bnd[0], "bound_by": bnd[1]}
    free_device()
    # kernel 4 at the 405B decode all-reduce's slow phase: B x d_model / 2
    # bf16 a rank after the fast reduce-scatter, 128 KB = LL_MAX_BYTES
    ws = RDWorkspace()
    R, m = PODS * FAST, B * 16384 // FAST
    x = torch.randn((R, m), generator=gen, device="cuda").to(torch.bfloat16)
    out = rd_all_reduce(x, PODS, workspace=ws)
    if not torch.equal(out, rd_all_reduce_ref(x, PODS)):
        raise AssertionError("rd_all_reduce at the 405B decode message "
                             "differs from its plain version")
    t = (time_ms(lambda: rd_all_reduce(x, PODS, workspace=ws)),
         time_ms(lambda: rd_all_reduce_ref(x, PODS)),
         time_ms(lambda: x.view(PODS, FAST, m).sum(0)))
    bnd = rd_bound(R, PODS, m, 2)
    proto = "ll" if m * 2 <= rd_ops.LL_MAX_BYTES else "simple"
    log(f"  rd_all_reduce 405b decode [bfloat16] {PODS}x{FAST} ranks, "
        f"{m * 2 // 1024} KB a rank ({proto}; LL_MAX_BYTES "
        f"{rd_ops.LL_MAX_BYTES}): bitwise the plain version; kernel_ms="
        f"{t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
        f"bound_ms={bnd[0]:.6f} ({bnd[1]})")
    rec["rd_all_reduce"]["405b_decode_128KB"] = {
        "max_abs_err": 0.0, "ms": t[0], "plain_ms": t[1], "library_ms": t[2],
        "bound_ms": bnd[0], "bound_by": bnd[1], "protocol": proto}
    for name, (M, K, N) in DENSE_FUSED_SHAPES.items():
        x = torch.randn((R, M, K), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        w = (torch.randn((R, K, N), generator=gen, device="cuda")
             / K ** 0.5).to(torch.bfloat16)
        out = collective_matmul_rd(x, w, PODS, n_chunks=4, workspace=ws)
        torch.cuda.synchronize()
        err = check_close(f"collective_matmul_rd {name} M={M} K={K} N={N}",
                          out, collective_matmul_rd_ref(x, w, PODS),
                          torch.bfloat16)
        xl, wl = fold_pods(x, w, PODS, FAST)
        t = (time_ms(lambda: collective_matmul_rd(x, w, PODS, n_chunks=4,
                                                  workspace=ws)),
             time_ms(lambda: collective_matmul_rd_ref(x, w, PODS)),
             time_ms(lambda: torch.bmm(xl, wl)))
        bnd = fused_bound(R, M, K, N, torch.bfloat16)
        log(f"  collective_matmul_rd {name} [bfloat16] {PODS}x{FAST} ranks, "
            f"M={M} K={K} N={N}: kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} "
            f"library_ms={t[2]:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})")
        rec["collective_matmul_rd"]["shapes"][name] = {
            "M": M, "K": K, "N": N, "max_abs_err": err, "ms": t[0],
            "plain_ms": t[1], "library_ms": t[2], "bound_ms": bnd[0],
            "bound_by": bnd[1]}
        del x, w, xl, wl, out
    del ws
    free_device()


def phase_dense(rec: dict) -> dict:
    """Phase 32: the kernels at the new shapes, each dense arch at tp=1
    and tp=8, and codeqwen1.5-7b card against CPU at 2 layers in f32 with
    planted biases."""
    phase_dense_kernels(rec)
    launches = {}
    for name, cfg, depth in DENSE_ARCHS:
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        dense_arch(name, cfg, launches)
    card_vs_cpu(1, 1, "flat", arch="codeqwen1.5-7b")
    return launches


# ---------------------------------------------------------------------------
# Phase 33: the encoder-decoder (whisper-medium) and the VLM (pixtral-12b)
# ---------------------------------------------------------------------------

WHISPER, PIXTRAL = "whisper-medium", "pixtral-12b"
MM_PROMPT, MM_NEW = 64, 16      # whisper's prompt; pixtral's text after
                                # its 1024 patches
# Kernel 3 at (B, Hq, Hkv, Sq, Skv, hd, causal): whisper-medium's encoder
# self-attention (1500 frames over themselves) and its decoder's
# cross-attention in prefill (the 64-token prompt over the 1500 encoder
# keys), both non-causal, at tp=1 and their tp=8 folds (8 ranks x 8
# sequences, 2 heads a rank); pixtral-12b's causal prefill (1024 patches
# + 64 tokens, 32 / 8 heads of 128).
MM_FLASH_SHAPES = {
    "whisper_enc": (B, 16, 16, 1500, 1500, 64, False),
    "whisper_xattn": (B, 16, 16, MM_PROMPT, 1500, 64, False),
    "whisper_enc_tp8_fold": (B * PODS * FAST, 2, 2, 1500, 1500, 64, False),
    "whisper_xattn_tp8_fold": (B * PODS * FAST, 2, 2, MM_PROMPT, 1500, 64,
                               False),
    "pixtral_prefill": (B, 32, 8, 1024 + MM_PROMPT, 1024 + MM_PROMPT, 128,
                        True)}
# Kernel 1 at (B, Hq, Hkv, hd, S, window, positions): whisper's decoder
# cross-attention in decode, one query over the 1500 encoder keys with
# every row at position 1499 (g 1: 11 splits of 128 and one of 92), at
# tp=1 and its tp=8 fold; pixtral's decode self-attention (g 4 at hd 128,
# prompt 1088 + 16; kernel 2 beside it).
MM_DECODE_SHAPES = {
    "whisper_xattn": (B, 16, 16, 64, 1500, 0, (1499, 1499)),
    "whisper_xattn_tp8_fold": (B * PODS * FAST, 2, 2, 64, 1500, 0,
                               (1499, 1499)),
    "pixtral": (B, 32, 8, 128, 1024 + MM_PROMPT + MM_NEW, 0,
                (1024 + MM_PROMPT, 1024 + MM_PROMPT + MM_NEW - 1))}


def multimodal_extra(cfg, b: int, seed: int, device: str) -> dict:
    """An encoder-decoder's frames (b, enc_seq, D) or a VLM's patches (b,
    n_patches, D), seeded normal in the model's dtype on ``device``; {}
    for a text-only family."""
    if cfg.family not in ("encdec", "vlm"):
        return {}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if cfg.family == "encdec":
        return {"frame_embeds": torch.randn(
            (b, cfg.enc_seq, cfg.d_model), generator=gen, device=device
        ).to(cfg.dtype)}
    return {"patch_embeds": torch.randn(
        (b, cfg.n_patches, cfg.d_model), generator=gen, device=device
    ).to(cfg.dtype)}


def xflash_case(gen, dtype, shape) -> tuple:
    """Kernel 3 at (b, hq, hkv, sq, skv, hd, causal), q / k / v as the
    model holds them ((B, S, H, hd) passed as (B, H, S, hd) views): within
    TOL of its plain version, a second call bitwise the first; kernel,
    plain version and SDPA timed beside the bound (non-causal: every
    query over every key)."""
    b, hq, hkv, sq, skv, hd, causal = shape

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q = rnd(b, sq, hq, hd).transpose(1, 2)
    k = rnd(b, skv, hkv, hd).transpose(1, 2)
    v = rnd(b, skv, hkv, hd).transpose(1, 2)

    def kernel():
        return flash_attention(q, k, v, causal=causal)

    out = kernel()
    torch.cuda.synchronize()
    err = check_close(f"flash_attention {shape}", out,
                      flash_attention_ref(q, k, v, causal=causal), dtype)
    if not torch.equal(kernel(), out):
        raise AssertionError(f"flash_attention {shape}: a second call "
                             "differs from the first")
    del out
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    t = (time_ms(kernel),
         time_ms(lambda: flash_attention_ref(q, k, v, causal=causal)),
         time_ms(lambda: F.scaled_dot_product_attention(
             qc, kc, vc, is_causal=causal, enable_gqa=True)))
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    bnd = bound_ms(q.element_size() * b * hd * (2 * sq * hq + 2 * skv * hkv),
                   4.0 * b * hq * hd * pairs, dtype)
    return err, t, bnd


def phase_mm_kernels(rec: dict) -> None:
    """Kernels 3 (non-causal and pixtral's causal prefill) and 1 (and 2 at
    pixtral's decode) at phase 33's shapes, bf16 and f32, against their
    plain versions; the bf16 records go into ``rec``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 33)
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for name, shape in MM_FLASH_SHAPES.items():
            err, t, bnd = xflash_case(gen, dtype, shape)
            log(f"  flash_attention {name} [{dt}]: kernel_ms={t[0]:.4f} "
                f"plain_ms={t[1]:.4f} library_ms={t[2]:.4f} (SDPA) "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            if dtype == torch.bfloat16:
                rec["flash_attention"][name] = {
                    "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                    "library_ms": t[2], "bound_ms": bnd[0],
                    "bound_by": bnd[1]}
            free_device()
        for name in MM_DECODE_SHAPES:
            d, p = decode_case(gen, dtype, name, MM_DECODE_SHAPES,
                               paged=name == "pixtral")
            if dtype == torch.bfloat16:
                rec["decode_attention"]["shapes"][name] = d
                if p is not None:
                    rec["paged_decode_attention"]["shapes"][name] = p
        free_device()


def mm_launches(cfg, tp: int, paged: bool, new: int) -> dict:
    """One generate's launches (eager): kernel 3 once a prefill for each
    encoder layer's self-attention and each decoder layer's self- and
    cross-attention; a decode step's self-attention through kernel 1 (2
    when paged) and cross-attention through kernel 1 (its cache is never
    paged); on the mesh one RD launch for each all-reduce: the embedding,
    two a block (attention, MLP) and the cross-attention's in the
    decoder, two an encoder block."""
    L, E = cfg.n_layers, cfg.enc_layers
    x = 1 if E else 0                   # cross-attention a decoder block
    steps = new - 1
    out = {"flash_attention": E + (1 + x) * L,
           "decode_attention": (x + (0 if paged else 1)) * L * steps,
           "paged_decode_attention": L * steps if paged else 0}
    if tp > 1:
        out["rd_all_reduce"] = (1 + 2 * E + (2 + x) * L) \
            + (1 + (2 + x) * L) * steps
    return out


# The depth of pixtral-12b's bf16 paths (cut from 40 layers to keep the
# script inside its time limit) and of its tp=8-against-tp=1 logits gate:
# that of the deepest fp-wire gate before it (llama3.2-1b, 16 layers,
# phase 6).  At 40 layers the bf16 sums of another reduction order drift
# past TF_MEAN (a mean of 0.0213, PERF.md); 40 layers are held in f32
# instead (``mm_f32_tp``), where a wrong rank or a dropped partial would
# show.
MM_PATH_LAYERS = {PIXTRAL: 16}
# f32 tp=8 against tp=1 at full depth on one card: f32 sums in another
# order (the card-vs-CPU bar of phase 5)
MM_F32_TOL = 1e-3


def mm_gate(name: str, tokens, ref, ref_logits, model, ap, ctx, mesh,
            extra, prompt_len: int) -> None:
    """tp=8's tokens margin-gated against tp=1's and its teacher-forced
    logits (real vocab) within (TF_MAX, TF_MEAN) of tp=1's."""
    V = ap.cfg.vocab_size
    want = ref_logits.to("cuda")
    got = teacher_forced(model, ref, ap, ctx, mesh, extra=extra)[..., :V]
    mx, mean = gate(f"{name} {ap.cfg.n_layers}L tp=8 hier_rd vs tp=1", got,
                    want)
    n = margin_gate(tokens, ref, top2_gap(want), prompt_len, BF16_GAP)
    log(f"    tp=8 hier_rd tokens == tp=1 tokens on {n}/{B * MM_NEW} steps "
        f"gated at gap {BF16_GAP:g} (fully equal: "
        f"{np.array_equal(tokens, ref)})")
    if mx > TF_MAX or mean > TF_MEAN:
        raise AssertionError(f"{name} tp=8 logits differ from tp=1's")


def mm_arch(name: str, cfg, prompt_len: int, launches: dict) -> None:
    """One arch at full width, bf16, seeded weights and frames / patches,
    at full depth or, for an arch in MM_PATH_LAYERS, at that depth: batch
    8, ``prompt_len`` tokens, MM_NEW new; tp=1 dense and paged and tp=8 (4
    x 2, hier_rd) each through ``run_path`` (exact launches of
    ``mm_launches``, graph == eager); paged tokens == dense; an
    encoder-decoder's graph then serves a second batch of frames with no
    capture anew (the prefill re-seeds the cross K/V in place), its tokens
    the eager form's; tp=8 against tp=1 by ``mm_gate``; a cut arch's full
    depth held in f32 (``mm_f32_tp``).  Each model is freed before the
    next is built."""
    full_cfg = cfg
    cfg = dataclasses.replace(cfg, n_layers=MM_PATH_LAYERS.get(
        name, cfg.n_layers))
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, prompt_len))
    extra = multimodal_extra(cfg, B, SEED + 3, "cuda")
    s_max = prompt_len + MM_NEW
    V = cfg.vocab_size
    ref = ref_logits = None
    for tp, pods, layouts in ((1, 1, (0, BLOCK)), (PODS * FAST, PODS, (0,))):
        ap = make_plan(cfg, tp)
        mesh, ctx = mesh_and_ctx(tp, pods, ar_strategy="hier_rd",
                                 device="cuda")
        t0 = time.perf_counter()
        model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  {name} tp={tp}: {cfg.n_layers} layers"
            + (f" + {cfg.enc_layers} encoder layers" if cfg.enc_layers
               else "")
            + f", d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
            f"heads (g={ap.gqa.g} u={ap.gqa.u}), {n_params / 1e9:.3f} B "
            f"parameters (param_count {cfg.param_count() / 1e9:.3f} B), "
            f"built in {time.perf_counter() - t0:.1f} s")
        tokens = {}
        for bs in layouts:
            layout = "paged" if bs else "dense"
            label = f"{name} tp={tp} {layout}"
            eng = InferenceEngine(ap, model, ctx=ctx, mesh=mesh, s_max=s_max,
                                  block_size=bs, device="cuda")
            res, launches[f"mm_{name}_tp{tp}_{layout}"] = run_path(
                eng, prompts, label, mm_launches(cfg, tp, bs > 0, MM_NEW),
                new=MM_NEW, extra=extra)
            tokens[layout] = res.tokens
            if cfg.enc_layers and tp == 1 and not bs:
                other = multimodal_extra(cfg, B, SEED + 4, "cuda")
                eng.cuda_graph = True
                g = eng.generate(prompts, MM_NEW, extra=other)
                eng.cuda_graph = False
                e = eng.generate(prompts, MM_NEW, extra=other)
                if not (np.array_equal(g.tokens, e.tokens)
                        and g.graph_recaptures == 0
                        and g.graph_replays == MM_NEW - 1):
                    raise AssertionError(
                        f"{label}: a second batch of frames through the "
                        f"captured step: {g.graph_replays} replays, "
                        f"{g.graph_recaptures} captured anew, tokens == "
                        f"eager: {np.array_equal(g.tokens, e.tokens)}")
                log(f"    a second batch of frames: graph tokens == eager "
                    f"bitwise, {g.graph_replays} replays, none captured "
                    f"anew; new tokens differ from the first batch's on "
                    f"{int((e.new_tokens != res.new_tokens).sum())}/"
                    f"{e.new_tokens.size}")
            del eng
        if "paged" in tokens:
            if not np.array_equal(tokens["paged"], tokens["dense"]):
                raise AssertionError(f"{name}: paged tokens differ from "
                                     "dense")
            log("    paged tokens == dense tokens")
        if tp == 1:
            ref = tokens["dense"]
            ref_logits = teacher_forced(model, ref, ap,
                                        extra=extra)[..., :V].cpu()
        else:
            mm_gate(name, tokens["dense"], ref, ref_logits, model, ap, ctx,
                    mesh, extra, prompt_len)
        del model
        free_device()
    del ref_logits
    if cfg.n_layers < full_cfg.n_layers:
        mm_f32_tp(name, full_cfg, prompts[:2], extra)


def mm_f32_tp(name: str, cfg, prompts: np.ndarray, extra: dict) -> None:
    """The arch at full depth in f32 (two of the prompts): tp=8 (4 x 2,
    hier_rd) prefill logits against tp=1's within MM_F32_TOL, one model on
    the card at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = dataclasses.replace(cfg, dtype=torch.float32)
    ex = {k: t[:prompts.shape[0]].float() for k, t in extra.items()}
    out = {}
    for tp, pods in ((1, 1), (PODS * FAST, PODS)):
        ap = make_plan(c, tp)
        mesh, ctx = mesh_and_ctx(tp, pods, ar_strategy="hier_rd",
                                 device="cuda")
        model = init_params(ap, seed=SEED, device="cuda", mesh=mesh)
        with torch.inference_mode():
            lg, _ = forward_lm(model, torch.as_tensor(prompts, device="cuda")
                               .long(), ap, ctx, mesh, **ex)
        out[tp] = (lg if mesh is None else gather_vocab(lg))[
            ..., :c.vocab_size].cpu()
        del model, lg
        free_device()
    err = max_err(out[PODS * FAST], out[1])
    log(f"    {name} {c.n_layers}L float32 tp=8 hier_rd vs tp=1 prefill "
        f"logits ({prompts.shape[0]} x {prompts.shape[1]}): max abs err "
        f"{err:.3e} (tol {MM_F32_TOL:g})")
    if not torch.allclose(out[PODS * FAST], out[1], atol=MM_F32_TOL,
                          rtol=MM_F32_TOL):
        raise AssertionError(f"{name}: f32 tp=8 logits differ from tp=1's")


def phase_multimodal(rec: dict) -> dict:
    """Phase 33: the kernels at the new shapes; whisper-medium (24 + 24
    layers) and pixtral-12b (16 of 40 layers; 40 in f32) at full width,
    tp=1 and tp=8;
    card against CPU at 2 layers in f32 (whisper's encoder at 2 layers
    over all 1500 frames; pixtral with 32 patches in a 64-token
    prompt)."""
    t0 = time.perf_counter()
    phase_mm_kernels(rec)
    log(f"    kernels {time.perf_counter() - t0:.1f} s")
    launches = {}
    t0 = time.perf_counter()
    mm_arch(WHISPER, get_config(WHISPER), MM_PROMPT, launches)
    log(f"    {WHISPER} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mm_arch(PIXTRAL, get_config(PIXTRAL), 1024 + MM_PROMPT, launches)
    log(f"    {PIXTRAL} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    card_vs_cpu(1, 1, "flat", arch=WHISPER, cut={"enc_layers": 2})
    card_vs_cpu(1, 1, "flat", arch=PIXTRAL, cut={"n_patches": 32})
    log(f"    card vs CPU {time.perf_counter() - t0:.1f} s")
    return launches


def ptxas_report() -> None:
    """ptxas's -v report of this build's libraries, a line a kernel: its
    registers, static shared memory and spills (the bf16 tensor-core
    kernels' shared memory is dynamic: their configs' sizes are in the
    sources)."""
    import re
    for src in sorted(_build.CSRC.glob("*.cu")):
        f = _build._target(src).with_suffix(".log")
        if not f.exists():      # built by an earlier run: no report kept
            continue
        text = f.read_text()
        names = re.findall(r"Compiling entry function '(\w+)'", text)
        try:
            shown = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True,
                                   check=True).stdout.split("\n")
        except (OSError, subprocess.CalledProcessError):
            shown = names
        # each entry: "Compiling entry function", then its spill line and
        # its "Used N registers" line
        blocks = re.split(r"Compiling entry function '\w+'", text)[1:]
        for name, block in zip(shown, blocks):
            used = re.search(r"Used (\d+) registers[^\n]*", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            log(f"    {src.stem}: {name[:100]}: "
                f"{used.group(0) if used else '?'}; "
                f"{spill.group(0) if spill else '?'}")


# ---------------------------------------------------------------------------
# Phase 34: the paper's HP scheme (GPipe PP x TP) and the simulator's H100
# ---------------------------------------------------------------------------

# The HP forward's mesh: 4 stages of 4 layers, TP 2 inside each (8 ranks).
PP_STAGES, PP_FAST = 4, 2
PP_CTX = ParallelCtx(tp_fast=("model",), ep=("model",))
# f32 at 4 layers (one a stage) against tp=1: the reference case's bar
# (tests/dist_cases/case_pp_and_perf.py), relative to the largest logit.
PP_F32_REL = 2e-3
# The sustained bf16 rate: one (8, 4096, 4096) x (8, 4096, 4096) bmm.
BMM_SHAPE = (8, 4096, 4096, 4096)


def pp_faults():
    """The two planted faults of the HP gate: the shift sent to stage s - 1
    instead of s + 1, and the last stage's output collected one tick
    early."""
    def back(buf, stages):
        return buf.reshape(stages, -1, *buf.shape[1:]).roll(-1, 0).reshape(
            buf.shape)

    def early(t, stages, microbatches):
        i = t - (stages - 2)
        return i if 0 <= i < microbatches else None
    return {"shift_back": mock.patch.object(pp, "_shift", back),
            "collect_early": mock.patch.object(pp, "_finished", early)}


def stage0_logits(logits: torch.Tensor, fast: int) -> torch.Tensor:
    """The first stage's vocab shards gathered: (B, S, V_pad) from the
    PP forward's (R, B, S, V_local)."""
    return gather_vocab(logits[:fast])


def timed_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` synchronised calls, host wall ms (a warm call
    first)."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def phase_pp(rec: dict) -> dict:
    """Phase 34 (a): the HP forward at full width against tp=1, its
    launches, the planted faults, f32 at 4 layers, card against CPU, its
    time beside tp=1's and tp=8's; kernel 3 at the stage's shape."""
    cfg = get_config("llama3.2-1b")
    L, P, F_ = cfg.n_layers, PP_STAGES, PP_FAST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 34)
    mb_shape = (P * F_ * B // 4, HQ // F_, HKV // F_, PROMPT, HD, 0)
    err, t, bnd = flash_case(gen, torch.bfloat16, mb_shape)
    log(f"  flash_attention pp_stage {mb_shape} [bfloat16] (a block call "
        f"of the HP forward at M = 4: {P * F_} ranks x {B // 4} sequences): "
        f"kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
        f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
    rec["flash_attention"]["pp_stage"] = {
        "max_abs_err": err, "ms": t[0], "plain_ms": t[1], "library_ms": t[2],
        "bound_ms": bnd[0], "bound_by": bnd[1]}
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                   (B, PROMPT))
    tokens = torch.as_tensor(prompts, device="cuda").long()
    ap1 = make_plan(cfg, 1)
    m1 = init_params(ap1, seed=SEED, device="cuda")
    with torch.inference_mode():
        ref = forward_lm(m1, tokens, ap1)[0]
        tp1_ms = timed_ms(lambda: forward_lm(m1, tokens, ap1))
    del m1
    free_device()
    ap = make_plan(cfg, F_)
    mesh = VirtualMesh(P, F_, device="cuda")
    cut = init_params(ap, seed=SEED, device="cuda",
                      mesh=VirtualMesh(1, F_, device="cuda"))
    staged = pp.to_stages(cut, mesh)
    del cut
    log(f"  {cfg.name} HP: {P} stages x {L // P} layers, TP {F_} in each "
        f"({mesh}), ctx tp_fast={PP_CTX.tp_fast}; stage layout "
        f"{sum(x.numel() for x in staged.parameters()) / 1e9:.3f} B "
        "elements (embedding on every stage)")
    launches, pp_ms = {}, {}
    for M in (4, 1):
        fn = pp.build_pp_forward(ap, PP_CTX, mesh, stage_axis="pod",
                                 microbatches=M)
        with torch.inference_mode():
            fn(staged, tokens)
            torch.cuda.synchronize()
            reset_counts()
            lg = fn(staged, tokens)
            got = counts()
            expect = {**dict.fromkeys(got, 0),
                      "flash_attention": (L // P) * (M + P - 1)}
            if got != expect:
                raise AssertionError(f"HP M={M}: launches {got}, expected "
                                     f"{expect}")
            if not all(torch.equal(lg[:F_], lg[s * F_:(s + 1) * F_])
                       for s in range(1, P)):
                raise AssertionError(f"HP M={M}: the stages' logits differ")
            mx, mean = gate(f"HP M={M} vs tp=1 prefill logits",
                            stage0_logits(lg, F_), ref)
            if mx > TF_MAX or mean > TF_MEAN:
                raise AssertionError(f"HP M={M} logits differ from tp=1's")
            del lg
            pp_ms[M] = timed_ms(lambda: fn(staged, tokens))
            if M == 4:
                for kind, patch in pp_faults().items():
                    with patch:
                        fmx, fmean = gate(f"planted fault {kind}",
                                          stage0_logits(fn(staged, tokens),
                                                        F_), ref)
                    if fmx <= TF_MAX and fmean <= TF_MEAN:
                        raise AssertionError(f"the HP gate passed the "
                                             f"planted fault {kind}")
        launches[f"pp_m{M}"] = got
        log(f"  HP M={M}: launches {got} == (L/P) x (M+P-1); the stages' "
            "logits bitwise equal")
        free_device()
    del staged, ref
    free_device()
    # tp=8 (4 pods x 2) hier_rd, the same forward_lm timing
    ap8 = make_plan(cfg, PODS * FAST)
    mesh8, ctx8 = mesh_and_ctx(PODS * FAST, PODS, ar_strategy="hier_rd",
                               device="cuda")
    m8 = init_params(ap8, seed=SEED, device="cuda", mesh=mesh8)
    with torch.inference_mode():
        tp8_ms = timed_ms(lambda: forward_lm(m8, tokens, ap8, ctx8, mesh8))
    del m8
    free_device()
    log(f"  prefill forward, batch {B} x {PROMPT}, median of 3 synchronised "
        f"calls: tp=1 {tp1_ms:.2f} ms; tp=8 ({PODS}x{FAST}) hier_rd "
        f"{tp8_ms:.2f} ms; HP {P}x{F_} M=4 {pp_ms[4]:.2f} ms, M=1 "
        f"{pp_ms[1]:.2f} ms (engine prefills of this run: phase 4 tp=1 "
        f"{P4.get('prefill_ms', float('nan')):.2f} ms, phase 6 tp=8 hier_rd "
        f"{P6.get('prefill_ms', float('nan')):.2f} ms)")
    pp_f32(cfg)
    return launches


def pp_f32(cfg) -> None:
    """The HP forward at full width, 4 layers (one a stage), f32: against
    tp=1 within PP_F32_REL at batch 8 x 512, then the card against the CPU
    at batch 2 x 64, M = 2, within 1e-3."""
    cfg = dataclasses.replace(cfg, n_layers=PP_STAGES, dtype=torch.float32)
    ap1, ap = make_plan(cfg, 1), make_plan(cfg, PP_FAST)
    mesh = VirtualMesh(PP_STAGES, PP_FAST, device="cuda")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                   (B, PROMPT))
    tokens = torch.as_tensor(prompts, device="cuda").long()
    with torch.inference_mode():
        m1 = init_params(ap1, seed=SEED, device="cuda")
        ref = forward_lm(m1, tokens, ap1)[0]
        del m1
        staged = pp.to_stages(init_params(
            ap, seed=SEED, device="cuda",
            mesh=VirtualMesh(1, PP_FAST, device="cuda")), mesh)
        fn = pp.build_pp_forward(ap, PP_CTX, mesh, stage_axis="pod",
                                 microbatches=4)
        got = stage0_logits(fn(staged, tokens), PP_FAST)
        rel = float((got - ref).abs().max() / ref.abs().max())
        del got, ref
        log(f"  HP f32, {cfg.n_layers} layers, M=4 vs tp=1: max|diff| / "
            f"max|tp=1| = {rel:.3e} (limit {PP_F32_REL:g})")
        if not rel < PP_F32_REL:
            raise AssertionError("HP f32 logits differ from tp=1's")
        free_device()
        b, s = 2, 64
        small = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
            0, cfg.vocab_size, (b, s)))
        fn2 = pp.build_pp_forward(ap, PP_CTX, mesh, stage_axis="pod",
                                  microbatches=2)
        lg = stage0_logits(fn2(staged, small.to("cuda")), PP_FAST).cpu()
        cpu = copy.deepcopy(staged).to("cpu")
        del staged
        free_device()
        mesh_c = VirtualMesh(PP_STAGES, PP_FAST, device="cpu")
        fn_c = pp.build_pp_forward(ap, PP_CTX, mesh_c, stage_axis="pod",
                                   microbatches=2)
        lc = stage0_logits(fn_c(cpu, small), PP_FAST)
    err = max_err(lg, lc)
    log(f"  HP f32 card vs CPU, batch {b} x {s}, M=2: max abs err "
        f"{err:.3e} (atol=rtol=1e-3)")
    if not torch.allclose(lg, lc, atol=1e-3, rtol=1e-3):
        raise AssertionError("HP logits differ between card and CPU")


def phase_sim() -> None:
    """Phase 34 (b): the sustained bf16 rate of one large bmm, the H100
    spec's efficiency from it, and the simulator's llama3.2-1b tp=1 decode
    step and prefill beside phase 4's measured ones.  A model, so no gate:
    every number finite and positive."""
    bb, m, k, n = BMM_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 35)
    a = torch.randn((bb, m, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn((bb, k, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    ms = time_ms(lambda: torch.bmm(a, w))
    del a, w
    flops = 2.0 * bb * m * k * n
    eff = flops / (ms * 1e-3) / PEAK_FLOPS[torch.bfloat16]
    cap = torch.cuda.get_device_properties(0).total_memory
    log(f"  bmm {BMM_SHAPE} bf16: {ms:.4f} ms, {flops / ms / 1e9:.1f} "
        f"TFLOP/s = {eff:.4f} of the {PEAK_FLOPS[torch.bfloat16] / 1e12:g} "
        f"TFLOP/s peak; total_memory {cap} bytes; simulator.H100: "
        f"efficiency {sim.H100.efficiency:g}, hbm_cap {sim.H100.hbm_cap:.0f}")
    cfg = get_config("llama3.2-1b")
    measured = {"decode": P4.get("decode_step_busy_ms"),
                "prefill": P4.get("prefill_ms")}
    source = {"decode": "decode step; card: a graph-replayed step, device "
                        "busy", "prefill": "prefill; card: phase 4's"}
    nums = [ms, eff]
    # one GPU: no all-reduce, so the network is never read
    for label, chip in (("H100", sim.H100),
                        ("H100 at this run's efficiency",
                         dataclasses.replace(sim.H100, efficiency=eff))):
        cs = sim.ClusterSim(cfg, chip, comm_model.VISTA, 1)
        pred = {"decode": cs.decode_step_time(B, PROMPT).total * 1e3,
                "prefill": cs.prefill_time(B, PROMPT).total * 1e3}
        for what in ("decode", "prefill"):
            got = measured[what] or float("nan")
            nums += [pred[what], got / pred[what]]
            log(f"  simulator ({label}) {cfg.name} tp=1 ({B}, {PROMPT}) "
                f"{source[what]}: simulator {pred[what]:.4f} ms, card "
                f"{got:.4f} ms, card / simulator {got / pred[what]:.3f}")
    if not all(np.isfinite(x) and x > 0 for x in nums):
        raise AssertionError(f"phase 34 (b): a number is not finite and "
                             f"positive: {nums}")


# ---------------------------------------------------------------------------
# Phase 35: training (ROADMAP item 11, part one)
# ---------------------------------------------------------------------------

# (a) llama3.2-1b full width and depth, bf16, tp=1: sequences of 1024,
# global batch 8 in 2 microbatches, remat on, AdamW at 3e-4 after 2
# warmup steps, 8 steps.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB, TRAIN_STEPS = 1024, 8, 2, 8
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
# (b) card (kernels) against CPU (plain versions), f32, 2 layers, batch 2
# x 128 in 2 microbatches, 3 steps: loss, grad norm and lr within 1e-4
# relative (the two devices sum in other orders, ~1e-6 a step).
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 2, 128
TRAIN_CPU_TOL = 1e-4
# Kernel 3's dq / dk / dv through its autograd Function against autograd
# through its plain version, f32, relative to the largest |gradient|: the
# same f32 math, the Function's tiles of queries summed in another order.
TRAIN_GRAD_TOL = 1e-5
# (c) data parallel over the pods of VirtualMesh(4, 1): 4 layers at full
# width, bf16, global batch 4 (one sequence of 1024 a pod), 2 steps a
# strategy.  rd sums each element in another order than flat: within
# RD_F32_ULPS f32 roundings of the sum of the pods' |g| (two levels of
# pairwise sums, both orders).  rd_int8 against the reference's int8 bound
# (tests/dist_cases/case_collectives.py: max |int8 - exact| / max |exact|
# < 0.05), leaf by leaf.
TRAIN_DP_PODS, TRAIN_DP_LAYERS, TRAIN_DP_BATCH, TRAIN_DP_STEPS = 4, 4, 4, 2
RD_F32_ULPS = 4
INT8_REL = 0.05
# (d) resume at 2 layers, bf16, phase (a)'s batch: 4 steps straight
# against 2 + checkpoint + restore + 2.  The restore is held bitwise: the
# restored parameters, moments and step equal the saved ones, and before
# the restore the model (drawn from another seed, trained 2 steps from
# zero moments) differed from them.  The losses within 1e-6 relative: the
# embedding's backward (an index_put with accumulation) is among
# PyTorch's nondeterministic CUDA operations, yet the card has repeated
# the straight losses bitwise in every run so far; the model that was not
# restored has to miss this bar.
TRAIN_RESUME_TOL = 1e-6


def fmt(xs, spec: str) -> str:
    return " ".join(format(x, spec) for x in xs)


def train_batches(cfg, seq: int, batch: int, n: int) -> list:
    data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=SEED)
    return [data.batch(i) for i in range(n)]


def train_run(step, model, opt, batches) -> list:
    """One dict a step: the metrics as floats (their read waits for the
    device) and the step's host wall ms."""
    hist = []
    for b in batches:
        if model.embed["tok"].is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, b)
        vals = {k: float(v) for k, v in m.items()}
        hist.append({**vals, "ms": (time.perf_counter() - t0) * 1e3})
    return hist


def train_step_for(ap, ctx, mesh, steps: int, mb: int):
    return build_train_step(ap, ctx, mesh, microbatches=mb, remat=True,
                            base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                            total_steps=steps)


def profile_train_step(step, model, opt, batch, step_ms: float) -> None:
    """Device busy and idle share of one train step (torch.profiler): of
    the profiled step's wall time, and of ``step_ms`` (the unprofiled
    steps' median, which the profiler's own host cost does not inflate);
    the kernels that take the most device time, and kernel 3's share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(model, opt, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and e.device_time_total > 0), reverse=True)
    if not rows:
        log("    profile: no device time recorded (not measured)")
        return
    busy = sum(r[0] for r in rows)
    fl = [r for r in rows if "flash_attention" in r[2]]
    log(f"    profile of one step: device busy {busy:.2f} ms of {wall:.2f} "
        f"ms wall ({100 * busy / wall:.1f}%; idle "
        f"{100 - 100 * busy / wall:.1f}%) under the profiler, of the "
        f"unprofiled median step's {step_ms:.2f} ms "
        f"{100 * busy / step_ms:.1f}% (idle "
        f"{max(0.0, 100 - 100 * busy / step_ms):.1f}%); kernel 3 "
        f"{sum(r[0] for r in fl):.3f} ms over {sum(r[1] for r in fl)} "
        f"launches ({100 * sum(r[0] for r in fl) / busy:.2f}%)")
    for ms, n, key in rows[:8]:
        log(f"      {ms:9.3f} ms {n:6d}x  {key[:90]}")


def train_full(rec: dict) -> dict:
    """(a): llama3.2-1b at full width and depth trains: exact kernel-3
    launches (2 L a microbatch: the forward and remat's recompute), every
    loss finite, the last below the first, nothing skipped; step time,
    tokens/s, the model-FLOP share of the bf16 peak, peak memory, and one
    profiled step."""
    cfg = get_config("llama3.2-1b")
    ap = make_plan(cfg, 1)
    model = init_params(ap, seed=SEED, device="cuda")
    opt = adamw_init(params_tree(model))
    step = train_step_for(ap, single_pod_ctx(), None, TRAIN_STEPS, TRAIN_MB)
    batches = train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS + 1)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = train_run(step, model, opt, batches[:TRAIN_STEPS])
    got = counts()
    per_step = 2 * cfg.n_layers * TRAIN_MB
    expect = {**dict.fromkeys(got, 0),
              "flash_attention": per_step * TRAIN_STEPS}
    if got != expect:
        raise AssertionError(f"train tp=1: launches {got}, expected "
                             f"{expect}")
    losses = [h["loss"] for h in hist]
    log(f"  train tp=1: {TRAIN_STEPS} steps, losses {fmt(losses, '.4f')}; "
        f"grad norms {fmt([h['grad_norm'] for h in hist], '.3f')}; lr "
        f"{fmt([h['lr'] for h in hist], '.2e')}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and not any(h["skipped"] for h in hist)):
        raise AssertionError(f"train tp=1: losses {losses}, skipped "
                             f"{[h['skipped'] for h in hist]}")
    ms = float(np.median([h["ms"] for h in hist[1:]]))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3)
    n = cfg.param_count()
    log(f"  train tp=1: step {ms:.2f} ms (median of steps 1-"
        f"{TRAIN_STEPS - 1}; step 0 {hist[0]['ms']:.2f} ms), {tok_s:.1f} "
        f"tokens/s, model FLOPs 6 N tokens/s = "
        f"{6 * n * tok_s / 1e12:.1f} TFLOP/s = "
        f"{6 * n * tok_s / PEAK_FLOPS[torch.bfloat16]:.4f} of the bf16 peak "
        f"(N = {n}); kernel 3 {per_step} launches a step ({cfg.n_layers} "
        f"layers x {TRAIN_MB} microbatches x forward + recompute); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_train_step(step, model, opt, batches[TRAIN_STEPS], ms)
    P35["step_ms"], P35["tok_s"] = ms, tok_s
    del model, opt
    free_device()
    return {"train_tp1": got}


def train_flash_grad(rec: dict) -> None:
    """Kernel 3 under autograd at the training microbatch's shape (4
    sequences, 32 / 8 heads, 1024 tokens, hd 64): dq / dk / dv through
    the Function (kernel forward, plain tiled backward) against autograd
    through the plain version, f32; then, in bf16, the forward kernel and
    the backward timed beside SDPA's forward and backward and their
    bounds."""
    shape = (TRAIN_BATCH // TRAIN_MB, HQ, HKV, TRAIN_SEQ, HD, 0)
    b, hq, hkv, s, hd, _ = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 350)

    def operands(dtype):
        def rnd(*sh):
            return torch.randn(sh, generator=gen, device="cuda").to(dtype)
        q, k, v = (rnd(b, s, h, hd).requires_grad_() for h in (hq, hkv, hkv))
        return q, k, v, rnd(b, s, hq, hd).transpose(1, 2)

    q, k, v, do = operands(torch.float32)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = torch.autograd.grad(FlashAttention.apply(*views, True, 0),
                              (q, k, v), do)
    want = torch.autograd.grad(flash_attention_ref(*views, causal=True),
                               (q, k, v), do)
    errs = [max_err(a, w) / float(w.abs().max()) for a, w in zip(got, want)]
    log(f"  kernel 3 under autograd {shape} [float32]: dq / dk / dv through "
        f"the Function against autograd through the plain version, max "
        f"|diff| / max |grad| = {errs[0]:.3e} / {errs[1]:.3e} / "
        f"{errs[2]:.3e} (tolerance {TRAIN_GRAD_TOL:g})")
    if max(errs) > TRAIN_GRAD_TOL:
        raise AssertionError("kernel 3's gradient through the Function "
                             "differs from the plain version's")
    del q, k, v, do, views, got, want
    ferr, ft, fbnd = flash_case(gen, torch.bfloat16, shape)
    fwd = ft[0]
    log(f"  flash_attention train {shape} [bfloat16] (a training "
        f"microbatch's forward): kernel_ms={ft[0]:.4f} plain_ms={ft[1]:.4f} "
        f"library_ms={ft[2]:.4f} bound_ms={fbnd[0]:.4f} ({fbnd[1]})")
    q, k, v, do = operands(torch.bfloat16)
    qv, kv, vv = (t.detach().transpose(1, 2) for t in (q, k, v))
    pairs = s * (s + 1) // 2
    bwd = time_ms(lambda: flash_attention_grad(qv, kv, vv, do, causal=True))
    sq, sk, sv = (t.contiguous().requires_grad_() for t in (qv, kv, vv))
    so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True,
                                        enable_gqa=True)
    lib_bwd = time_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), do,
                                                  retain_graph=True))
    # backward: q, k, v, do read, dq, dk, dv written; five products a
    # visible (query, key) pair (s, dp, dq, dk, dv)
    bnd = bound_ms(2.0 * b * hd * s * (3 * hq + 3 * hkv + hkv),
                   10.0 * b * hq * hd * pairs, torch.bfloat16)
    log(f"  kernel 3 {shape} [bfloat16]: forward kernel {fwd:.4f} ms; "
        f"backward (plain, f32 tiles) {bwd:.4f} ms, {bwd / fwd:.1f}x the "
        f"forward; SDPA's backward {lib_bwd:.4f} ms; the backward's bound "
        f"{bnd[0]:.4f} ms ({bnd[1]})")
    rec["flash_attention"]["train"] = {
        "max_abs_err": ferr, "ms": ft[0], "plain_ms": ft[1],
        "library_ms": ft[2], "bound_ms": fbnd[0], "bound_by": fbnd[1],
        "bwd_ms": bwd, "library_bwd_ms": lib_bwd, "bwd_bound_ms": bnd[0],
        "bwd_bound_by": bnd[1], "grad_rel_err": max(errs)}


def train_card_vs_cpu() -> None:
    """(b): the same weights (drawn on the card, copied to the CPU) and
    batches, f32, 2 layers at full width, 3 steps on each device: loss,
    grad norm and lr within TRAIN_CPU_TOL relative."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"),
                              n_layers=TRAIN_CPU_LAYERS, dtype=torch.float32)
    ap = make_plan(cfg, 1)
    card = init_params(ap, seed=SEED, device="cuda")
    cpu = copy.deepcopy(card).to("cpu")
    batches = train_batches(cfg, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH, 3)
    hist = {}
    for name, model in (("card", card), ("cpu", cpu)):
        step = train_step_for(ap, single_pod_ctx(), None, 3, 2)
        hist[name] = train_run(step, model, adamw_init(params_tree(model)),
                               batches)
    worst = 0.0
    for i, (a, c) in enumerate(zip(hist["card"], hist["cpu"])):
        rel = {k: abs(a[k] - c[k]) / max(abs(c[k]), 1e-30)
               for k in ("loss", "grad_norm", "lr")}
        worst = max(worst, *rel.values())
        log(f"  card vs CPU step {i}: loss {a['loss']:.6f} / "
            f"{c['loss']:.6f}, grad norm {a['grad_norm']:.6f} / "
            f"{c['grad_norm']:.6f}, lr {a['lr']:.4e} / {c['lr']:.4e}; "
            f"relative {rel['loss']:.2e} / {rel['grad_norm']:.2e} / "
            f"{rel['lr']:.2e}")
    if worst > TRAIN_CPU_TOL:
        raise AssertionError(f"train card vs CPU: {worst:.3e} relative > "
                             f"{TRAIN_CPU_TOL}")
    del cpu, card
    free_device()


def clone_tree(tree):
    return tree_map(lambda t: t.clone(), tree)


def train_dp_kernels(rec: dict, mesh) -> None:
    """Kernel 4 and the pack / unpack at one gradient piece (GRAD_PIECE f32
    elements a rank, 4 pods): against their plain versions (bitwise) and
    timed beside the plain versions, the library sum and the bounds."""
    m, R = hierarchical.GRAD_PIECE, TRAIN_DP_PODS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 351)
    x = torch.randn((R, m), generator=gen, device="cuda")
    out = rd_all_reduce(x, R, workspace=mesh.workspace)
    if not torch.equal(out, rd_all_reduce_ref(x, R)):
        raise AssertionError("kernel 4 at the gradient piece differs from "
                             "its plain version")
    t = (time_ms(lambda: rd_all_reduce(x, R, workspace=mesh.workspace)),
         time_ms(lambda: rd_all_reduce_ref(x, R)),
         time_ms(lambda: x.view(R, 1, m).sum(0)))
    bnd = rd_bound(R, R, m, 4)
    log(f"  rd_all_reduce train piece ({R} pods x {m} f32, "
        f"{m * 4 / 2**20:.0f} MiB a rank, {rd_ops.rd_protocol(m * 4)}): "
        f"kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
        f"bound_ms={bnd[0]:.4f} ({bnd[1]}; 2 R m esz bytes)")
    rec.setdefault("rd_all_reduce", {})["train_piece"] = {
        "ms": t[0], "plain_ms": t[1], "library_ms": t[2], "bound_ms": bnd[0],
        "bound_by": bnd[1], "max_abs_err": 0.0}
    xq = x.view(R, 1, m)
    qp_check(xq, 8, 128, "train piece")
    q, sc = quantize_pack(xq, 8, 128)
    for name, fn, ref in (
            ("quantize_pack", lambda: quantize_pack(xq, 8, 128),
             lambda: quant_pack.quantize_pack_ref(xq, 8, 128)),
            ("unpack_dequant", lambda: unpack_dequant(q, sc, 8, 128),
             lambda: quant_pack.unpack_dequant_ref(q, sc, 8, 128))):
        tk, tp = time_ms(fn), time_ms(ref)
        bnd = qp_bound(name, R * m, 8, 128)
        log(f"  {name} train piece ({R} x {m} f32, int8, groups of 128): "
            f"kernel_ms={tk:.4f} plain_ms={tp:.4f} bound_ms={bnd[0]:.4f} "
            f"({bnd[1]})")
        rec.setdefault(name, {})["train_piece"] = {
            "ms": tk, "plain_ms": tp, "library_ms": None,
            "bound_ms": bnd[0], "bound_by": bnd[1], "max_abs_err": 0.0}
    del x, xq, q, sc, out
    free_device()


def train_dp(rec: dict) -> dict:
    """(c): llama3.2-1b at full width, 4 layers, bf16, data-parallel over
    the 4 pods of VirtualMesh(4, 1): one batch's per-pod gradients reduced
    under flat, rd (kernel 4, exact launches: one a piece) and rd_int8
    (kernels 6 / 7: a pack and an unpack a step a piece), rd within f32
    rounding of flat, rd_int8 within the int8 bound with the pods' drift;
    then 2 steps a strategy (exact launches, losses finite)."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"),
                              n_layers=TRAIN_DP_LAYERS)
    ap = make_plan(cfg, 1)
    pods = TRAIN_DP_PODS
    mesh = VirtualMesh(pods, 1, device="cuda")
    train_dp_kernels(rec, mesh)
    base = init_params(ap, seed=SEED, device="cuda")
    batches = train_batches(cfg, TRAIN_SEQ, TRAIN_DP_BATCH, TRAIN_DP_STEPS)
    ctxs = {s: ParallelCtx(dp=("pod",), grad_reduce_strategy=s)
            for s in ("flat", "rd", "rd_int8")}
    model = data_parallel(base, pods)
    _, g = train_step_for(ap, ctxs["flat"], mesh, TRAIN_DP_STEPS,
                          1).grads(model, batches[0])
    leaves = tree_leaves(g)
    pieces = sum(-(-t[0].numel() // hierarchical.GRAD_PIECE) for t in leaves)
    steps = pods.bit_length() - 1
    per_step = {"flat": {}, "rd": {"rd_all_reduce": pieces},
                "rd_int8": {"quantize_pack": steps * pieces,
                            "unpack_dequant": steps * pieces}}
    ref = clone_tree(g)
    hierarchical.grad_cross_pod_reduce(ref, ctxs["flat"], mesh)
    eps = float(torch.finfo(torch.float32).eps)
    for strat in ("rd", "rd_int8"):
        x = clone_tree(g)
        reset_counts()
        hierarchical.grad_cross_pod_reduce(x, ctxs[strat], mesh)
        torch.cuda.synchronize()
        got = counts()
        if got != {**dict.fromkeys(got, 0), **per_step[strat]}:
            raise AssertionError(f"grad reduce {strat}: launches {got}, "
                                 f"expected {per_step[strat]}")
        worst, drift = 0.0, 0.0
        for a, r, g0 in zip(tree_leaves(x),
                            tree_leaves(ref), leaves):
            if strat == "rd":
                lim = RD_F32_ULPS * eps * g0.abs().sum(0)
                worst = max(worst, float(((a - r).abs() / lim.clamp(
                    min=1e-38)).max()))
            else:
                worst = max(worst, max_err(a, r) / float(r.abs().max()))
                drift = max(drift, float((a - a[:1]).abs().max())
                            / float(a.abs().max()))
        if strat == "rd":
            log(f"  grad reduce rd ({pieces} kernel-4 launches, pieces of "
                f"{hierarchical.GRAD_PIECE} f32 a rank): max |rd - flat| = "
                f"{worst:.3f} x the f32 rounding bound ({RD_F32_ULPS} eps "
                "x the sum of the pods' |g|)")
            if worst > 1.0:
                raise AssertionError("rd's reduced gradients are not within "
                                     "f32 rounding of flat's")
        else:
            log(f"  grad reduce rd_int8 ({steps * pieces} packs and "
                f"unpacks): max |int8 - flat| / max |flat| = {worst:.4f} "
                f"(bound {INT8_REL}); the pods' copies drift apart by up to "
                f"{drift:.3e} of the largest |g|")
            if worst >= INT8_REL or drift == 0.0:
                raise AssertionError(f"rd_int8: {worst} >= {INT8_REL} or no "
                                     "drift between the pods")
        del x
    del g, ref, leaves, model
    free_device()
    launches = {}
    for strat in ("flat", "rd", "rd_int8"):
        model = data_parallel(base, pods)
        opt = adamw_init(params_tree(model))
        step = train_step_for(ap, ctxs[strat], mesh, TRAIN_DP_STEPS, 1)
        reset_counts()
        hist = train_run(step, model, opt, batches)
        got = counts()
        want = {**dict.fromkeys(got, 0),
                "flash_attention": 2 * cfg.n_layers * TRAIN_DP_STEPS,
                **{k: v * TRAIN_DP_STEPS for k, v in per_step[strat].items()}}
        if got != want:
            raise AssertionError(f"train dp {strat}: launches {got}, "
                                 f"expected {want}")
        losses = [h["loss"] for h in hist]
        if not (all(np.isfinite(losses)) and not any(h["skipped"]
                                                      for h in hist)):
            raise AssertionError(f"train dp {strat}: {hist}")
        spread = max(float((t - t[:1]).abs().max()) for t in
                     (p.detach() for p in model.parameters()))
        log(f"  train dp {strat} ({pods} pods x {TRAIN_DP_BATCH // pods} x "
            f"{TRAIN_SEQ}): losses {fmt(losses, '.4f')}, grad norms "
            f"{fmt([h['grad_norm'] for h in hist], '.3f')}, step "
            f"{np.median([h['ms'] for h in hist]):.2f} ms; launches a "
            f"step {({k: v // TRAIN_DP_STEPS for k, v in got.items() if v})}"
            f"; max |p_pod - p_0| after {TRAIN_DP_STEPS} steps {spread:.3e}")
        if (spread == 0.0) != (strat != "rd_int8"):
            raise AssertionError(f"train dp {strat}: pods' parameters "
                                 f"spread {spread}")
        launches[f"train_dp_{strat}"] = got
        del model, opt, step
        free_device()
    del base
    free_device()
    return launches


def state_diff(a, b) -> float:
    """Max |a - b| over the leaves of two train states (inf where a
    leaf's dtype or shape differs)."""
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.dtype != y.dtype or x.shape != y.shape:
            return float("inf")
        worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def train_resume() -> None:
    """(d): at 2 layers, bf16, phase (a)'s batch and schedule: 4 steps
    straight against 2 steps, a checkpoint, a restore and 2 more.  The
    restore goes into a model drawn from another seed and trained 2 steps
    (its losses are the control a broken restore would give); the
    restored state must equal the saved one bitwise, and the losses
    the straight run's within TRAIN_RESUME_TOL, which the control's must
    miss."""
    import shutil
    import tempfile
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    ap = make_plan(cfg, 1)
    batches = train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, 4)

    def fresh(seed):
        model = init_params(ap, seed=seed, device="cuda")
        return (model, adamw_init(params_tree(model)),
                train_step_for(ap, single_pod_ctx(), None, 4, TRAIN_MB))

    def losses(step, model, opt, bs):
        return [h["loss"] for h in train_run(step, model, opt, bs)]

    model, opt, step = fresh(SEED)
    straight = losses(step, model, opt, batches)
    del model, opt
    model, opt, step = fresh(SEED)
    part = losses(step, model, opt, batches[:2])
    saved = clone_tree(train_state(model, opt))
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        ckpt.save(d, 2, train_state(model, opt))
        t_save = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(d, "step_00000002",
                                            "arrays.npz"))
        del model, opt
        free_device()
        model, opt, step = fresh(SEED + 1)
        control = losses(step, model, opt, batches[2:])
        before = state_diff(train_state(model, opt), saved)
        t0 = time.perf_counter()
        at, state = ckpt.restore(d, train_state(model, opt))
        load_train_state(model, opt, state)
        t_restore = time.perf_counter() - t0
        del state
    finally:
        shutil.rmtree(d, ignore_errors=True)
    after = state_diff(train_state(model, opt), saved)
    n_leaves = len(tree_leaves(saved))
    del saved
    part += losses(step, model, opt, batches[2:])
    rel = [abs(a - b) / abs(a) for a, b in zip(straight, part)]
    gap = [abs(a - b) / abs(a) for a, b in zip(straight[2:], control)]
    log(f"  resume: straight {fmt(straight, '.7f')}; 2 + checkpoint (step "
        f"{at}, {size / 2**30:.2f} GiB, saved in {t_save:.1f} s, restored "
        f"in {t_restore:.1f} s) + 2 {fmt(part, '.7f')}; relative "
        f"{fmt(rel, '.1e')} (tolerance {TRAIN_RESUME_TOL:g})")
    log(f"  resume: restored state - saved state, max |diff| over "
        f"{n_leaves} leaves (parameters, moments, step): {after:g} (before "
        f"the restore {before:.3e}); a model of seed {SEED + 1} not "
        f"restored: losses {fmt(control, '.7f')}, relative "
        f"{fmt(gap, '.1e')}")
    if at != 2 or after != 0.0 or not before > 0.0:
        raise AssertionError(f"restore: step {at}, restored - saved "
                             f"{after}, before {before}")
    if max(rel) > TRAIN_RESUME_TOL or max(gap) <= TRAIN_RESUME_TOL:
        raise AssertionError("resume on the card differs from the straight "
                             "run, or the bar does not tell the model that "
                             "was not restored from it")
    del model, opt
    free_device()


P35: dict = {}


def phase_train(rec: dict) -> dict:
    """Phase 35: (a) full-depth training, kernel 3 under autograd, (b)
    card vs CPU, (c) data parallelism over 4 pods, (d) resume."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec.setdefault("flash_attention", {})
    launches = {}
    for part, fn in (("(a)", lambda: launches.update(train_full(rec))),
                     ("kernel 3's gradient", lambda: train_flash_grad(rec)),
                     ("(b)", train_card_vs_cpu),
                     ("(c)", lambda: launches.update(train_dp(rec))),
                     ("(d)", train_resume)):
        t0 = time.perf_counter()
        fn()
        free_device()
        log(f"    {part} took {time.perf_counter() - t0:.1f} s")
    return launches


_PHASE = {"title": "", "t": 0.0}


def phase(title: str) -> None:
    """Log the running phase's seconds, then start the next (an empty
    title ends the last)."""
    now = time.perf_counter()
    if _PHASE["title"]:
        log(f"    {_PHASE['title'].split(']')[0]}] took "
            f"{now - _PHASE['t']:.1f} s")
    if title:
        log(title)
    _PHASE.update(title=title, t=now)


# Phases whose results a phase reads: with --phases they run first.
PHASE_DEPS = {6: (4,), 9: (4, 6), 12: (9,), 13: (9,), 28: (27,),
              29: (27,), 30: (27,), 34: (4,)}
N_PHASES = 35


def selected_phases(arg: Optional[str]) -> list:
    """The phases of ``--phases`` (e.g. "1-3,34") and, transitively, every
    phase whose results they read; all phases without the argument.  Phase
    1 (the card) and the kernels' build always run."""
    if arg is None:
        return list(range(1, N_PHASES + 1))
    want = {1}
    for part in arg.split(","):
        lo, _, hi = part.partition("-")
        want.update(range(int(lo), int(hi or lo) + 1))
    todo = list(want)
    while todo:
        for d in PHASE_DEPS.get(todo.pop(), ()):
            if d not in want:
                want.add(d)
                todo.append(d)
    if not want <= set(range(1, N_PHASES + 1)):
        raise SystemExit(f"--phases {arg}: phases are 1-{N_PHASES}")
    return sorted(want)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="run these phases (e.g. 1-3,34) and the phases "
                    "whose results they read; default: all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    run = selected_phases(args.phases)
    on = set(run)
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    phase("[1] card (nvidia-smi name, power.limit):")
    log(smi)
    log(f"    torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    log(f"    phases: {'all' if args.phases is None else run}")
    t0 = time.perf_counter()
    _build.build()
    phase(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR})")
    ptxas_report()
    # the records the later phases add shapes to, when phase 2 does not run
    rec = {"flash_attention": {}, "decode_attention": {"shapes": {}},
           "paged_decode_attention": {"shapes": {}}}
    launches = {}
    if 2 in on:
        rec = phase_kernels()
        phase_sweep()
        phase_decode_repeat()
    if 3 in on:
        phase("[3] recursive-doubling all-reduce kernel")
        rec["rd_all_reduce"] = phase_rd()
    if 4 in on:
        phase("[4] llama3.2-1b full width and depth, bf16")
        launches, tp1_tokens, tp1_logits = phase_path()
    if 5 in on:
        phase("[5] card vs CPU, full width, 2 layers, float32")
        card_vs_cpu(1, 1, "flat")
    if 6 in on:
        phase(f"[6] llama3.2-1b tp=8 ({PODS} pods x {FAST}) full width and "
              "depth, bf16")
        tp_launches, flat_tokens, flat_logits = phase_tp(tp1_tokens,
                                                         tp1_logits)
        launches.update(tp_launches)
    if 7 in on:
        phase(f"[7] card vs CPU at tp=8 ({PODS}x{FAST}, hier_rd), full "
              "width, 2 layers, float32")
        card_vs_cpu(PODS * FAST, PODS, "hier_rd")
    if 8 in on:
        phase("[8] fused GEMM + recursive-doubling kernel")
        rec["collective_matmul_rd"] = phase_fused()
    if 9 in on:
        phase(f"[9] llama3.2-1b tp=8 ({PODS}x{FAST}) auto + overlapped "
              "projections, full width and depth, bf16")
        ov_launches, decode_refs = phase_overlap(tp1_tokens, tp1_logits,
                                                 flat_tokens, flat_logits)
        launches.update(ov_launches)
    if 10 in on:
        phase(f"[10] card vs CPU at tp=8 ({PODS}x{FAST}, auto + overlap), "
              "full width, 2 layers, float32")
        card_vs_cpu(PODS * FAST, PODS, "auto", overlap_matmul=True)
    if 11 in on:
        phase("[11] group-quantized pack and unpack kernels (kernel 6), and "
              "the quantized recursive doubling in one launch")
        rec.update(phase_quant_kernels())
        rec["quant_rd_all_reduce"] = phase_quant_fused()
    if 12 in on:
        phase(f"[12] llama3.2-1b tp=8 ({PODS}x{FAST}) hier_rd on the int8 "
              "and int4 wire, error feedback on, full width and depth, bf16")
        launches.update(phase_quant(decode_refs))
    if 13 in on:
        phase(f"[13] llama3.2-1b tp=8 ({PODS}x{FAST}) auto + auto "
              "quantization + overlapped projections, full width and depth, "
              "bf16")
        launches.update(phase_auto_quant(decode_refs))
    if 14 in on:
        phase(f"[14] card vs CPU at tp=8 ({PODS}x{FAST}, hier_rd + int8), "
              "full width, 2 layers, float32")
        card_vs_cpu(PODS * FAST, PODS, "hier_rd", ar_quant="int8",
                    tol=QUANT_CPU_TOL)
    if 15 in on:
        phase("[15] grouped expert FFN kernel (kernel 7)")
        rec["moe_expert_ffn"] = phase_moe_kernel()
    if 16 in on:
        phase(f"[16] {MOE_ARCH} tp=1, full width, {PATH_LAYERS[MOE_ARCH]} "
              "layers, bf16")
        launches.update(phase_moe_path())
    if 17 in on:
        phase(f"[17] {MOE_ARCH} tp=8 ({PODS}x{FAST}) against tp=1, full "
              "width, 4 layers, float32")
        launches.update(phase_moe_tp())
    if 18 in on:
        phase(f"[18] card vs CPU, {MOE_ARCH}, full width, 2 layers, "
              f"float32: tp=1, then tp=8 ({PODS}x{FAST}, hier_rd)")
        free_device()
        card_vs_cpu(1, 1, "flat", arch=MOE_ARCH)
        card_vs_cpu(PODS * FAST, PODS, "hier_rd", arch=MOE_ARCH)
        free_device()
    if 19 in on:
        phase("[19] RWKV6 time-mix scan kernel (kernel 8)")
        rec["rwkv6_scan"] = phase_rwkv_kernel()
    if 20 in on:
        phase(f"[20] {RWKV_ARCH} tp=1, full width, {PATH_LAYERS[RWKV_ARCH]} "
              "layers, bf16")
        launches.update(phase_rwkv_path())
    if 21 in on:
        phase(f"[21] {RWKV_ARCH} tp=8 ({PODS}x{FAST}) against tp=1, full "
              f"width, {RWKV_TP_LAYERS} layers, float32")
        launches.update(phase_rwkv_tp())
    if 22 in on:
        phase(f"[22] card vs CPU, {RWKV_ARCH}, full width, 2 layers, "
              f"float32: tp=1, then tp=8 ({PODS}x{FAST}, hier_rd)")
        free_device()
        card_vs_cpu(1, 1, "flat", arch=RWKV_ARCH)
        card_vs_cpu(PODS * FAST, PODS, "hier_rd", arch=RWKV_ARCH)
        free_device()
    if 23 in on:
        phase("[23] Mamba selective-scan kernel (kernel 9)")
        rec["ssm_scan"] = phase_ssm_kernel()
    if 24 in on:
        phase(f"[24] {HYB_ARCH} tp=1, full width, {PATH_LAYERS[HYB_ARCH]} "
              "layers, bf16")
        launches.update(phase_hybrid_path())
    if 25 in on:
        phase(f"[25] {HYB_ARCH} tp=8 ({PODS}x{FAST}) against tp=1, full "
              f"width, {HYB_TP_LAYERS} layers, float32")
        launches.update(phase_hybrid_tp())
    if 26 in on:
        phase(f"[26] card vs CPU, {HYB_ARCH}, full width, 2 layers, "
              f"float32: tp=1, then tp=8 ({PODS}x{FAST}, hier_rd)")
        free_device()
        card_vs_cpu(1, 1, "flat", arch=HYB_ARCH)
        card_vs_cpu(PODS * FAST, PODS, "hier_rd", arch=HYB_ARCH)
        free_device()
    if 27 in on:
        phase(f"[27] continuous batcher, llama3.2-1b full width, "
              f"{SERVE_LAYERS} of 16 layers, "
              f"bf16: tp=1 dense and paged, tp=8 ({PODS}x{FAST}, hier_rd) "
              "paged")
        phase_serve()
    if 28 in on:
        phase("[28] kernel 3's chunk form; phase 27's trace admitted by "
              f"chunks of {ADMIT_CHUNK}, the prefix cache, speculative "
              f"decoding (k = {SPEC_K})")
        rec["flash_attention_chunk"] = phase_chunk_kernel()
        launches.update(phase_serve_chunked())
    if 29 in on:
        phase("[29] faults, quarantine and deadlines in the batcher; "
              "disaggregated prefill / decode with the checksummed KV "
              f"handoff; the router: llama3.2-1b full width, {SERVE_LAYERS} "
              "of 16 layers, bf16")
        nan_masking_check()
        launches.update(phase_p29())
    if 30 in on:
        phase("[30] the int8 KV cache (kernel 1's int8 form), int8 block "
              "weights (the W8 GEMM) and the ring-buffer window cache")
        rec.update(phase_q8_kernels())
        launches.update(phase_kv8_serve())
        launches.update(phase_w8_decode())
        phase_ring()
    if 31 in on:
        phase(f"[31] sequence-parallel prefill: llama3.2-1b tp=8 "
              f"({PODS}x{FAST}) full width and depth, bf16; "
              "qwen3-moe-30b-a3b 4 layers, f32")
        launches.update(phase_sp())
    if 32 in on:
        phase("[32] the other dense archs at full width (Llama 3.1 405B / "
              "70B, mistral-large-123b, qwen1.5-32b at 2 layers; "
              f"codeqwen1.5-7b whole), tp=1 and tp=8 ({PODS}x{FAST}) "
              "hier_rd")
        launches.update(phase_dense(rec))
    if 33 in on:
        phase(f"[33] the encoder-decoder {WHISPER} (24 + 24 layers) and the "
              f"VLM {PIXTRAL} ({MM_PATH_LAYERS[PIXTRAL]} of 40 layers, 1024 "
              f"patches; 40 in f32) at full width, bf16: tp=1 dense and "
              f"paged, tp=8 ({PODS}x{FAST}) hier_rd; card vs CPU at 2 "
              "layers, f32 (pixtral with 32 patches in a 64-token prompt)")
        launches.update(phase_multimodal(rec))
    if 34 in on:
        phase(f"[34] the paper's HP scheme: llama3.2-1b full width and "
              f"depth, bf16, {PP_STAGES} stages x TP {PP_FAST} (GPipe PP x "
              "TP) against tp=1; f32 at 4 layers; card vs CPU; the "
              "simulator's H100 against the card")
        launches.update(phase_pp(rec))
        phase_sim()
    if 35 in on:
        phase(f"[35] training (ROADMAP item 11, part one): llama3.2-1b full "
              f"width and depth, bf16, tp=1, {TRAIN_STEPS} steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB} microbatches, "
              f"remat; kernel 3 under autograd; card vs CPU at "
              f"{TRAIN_CPU_LAYERS} layers, f32; data parallel over "
              f"VirtualMesh({TRAIN_DP_PODS}, 1) at {TRAIN_DP_LAYERS} layers "
              "under flat / rd / rd_int8; resume at 2 layers")
        launches.update(phase_train(rec))
    phase("")
    log("    decode tok/s, eager (one run) / graph (median of 3), this "
        "run:")
    for label, (e, g) in GRAPH_TPS.items():
        log(f"      {label}: {e:.1f} / {g:.1f} ({g / e:.2f}x)")
    # launches: the count of the run of the path each kernel serves (the
    # tp=8 hier_rd path, the paged kernel's tp=1 paged path, the fused
    # kernel's tp=8 auto + overlap path, kernel 6's tp=8 hier_rd int8
    # path, kernel 7's qwen3-moe tp=1 dense path, kernel 8's rwkv6-7b
    # tp=1 path, kernel 9's hymba-1.5b tp=1 dense path), and every counted
    # run's beside it; a --phases run lists the kernels whose path and
    # kernel checks ran
    kernels = [{"name": n, "route": "cuda", "source": SOURCES[n],
                "replaces": REPLACES[n],
                "launches": launches[MAIN_PATH[n]][n], "path": MAIN_PATH[n],
                "launches_by_path": {p: c[n] for p, c in launches.items()},
                **rec[n]} for n in MAIN_PATH
               if args.phases is None
               or (MAIN_PATH[n] in launches and "ms" in rec.get(n, {}))]
    log(f"    phases run: {run}")
    log(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
