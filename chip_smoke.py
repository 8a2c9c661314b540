#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package ``repro``.  Phases, each
of which ends the run with a non-zero exit code and no result line when
it fails:

1. build   — compile every ``src/repro_torch/csrc/*.cu`` with nvcc for
             sm_90a, one nvcc per source, all started together.
2. kernels — call each kernel's wrapper on card tensors at the shapes the
             main path gives it, plus the CPU test sweep's odd shapes,
             windows and kv offsets, and hold the result against the
             kernel's plain PyTorch version on the same inputs (bf16:
             rtol = atol = 2e-2, the reference's bf16 tolerance, as both
             sum in f32 and differ by the summation order and bf16
             roundings: the output's, and in the wgmma flash P's; f32:
             1e-4).  Times the kernel, the plain version
             and one PyTorch library call of the same function (a
             yardstick only; the port never calls it).
2a. dryrun — ``launch.dryrun`` on the ``meta`` device, host only, no
             world: every cell of ``configs.shapes`` on both production
             meshes ((data=16, model=16), (pod=2, data=16, model=16)),
             each applicable cell ``ok``, the rest ``skipped`` with
             ``configs.applicable``'s reason, as on the CPU; prints the
             cell count, the largest per-device bytes and the seconds.
3. prefill — ``make_prefill_fn`` on phi3.5-moe-42b at full width cut to 4
             layers, bf16, B=2, S=2048, random weights from a seed.  The
             last-position logits must match the same model run on the
             plain versions (``ops.plain_versions()``) with the expert
             matmul on the tensor cores (``torch.bmm``; see
             ``_tensor_core_gmm``) within 2e-2 of the largest logit, and
             at a fan-in init the plain versions as they stand within the
             same limit; both kernels must have been launched.
4. serve   — the launcher's colocated body (``build_model`` ->
             ``make_serve_step`` -> ``ContinuousBatcher``) answers 4
             requests (prompts of 8-16 tokens, 16 new tokens each); the
             grouped-matmul count must grow by 3 * 4 layers * ticks.
5. profile — where the time goes: a warm prefill call and 4 warm decode
             ticks under torch.profiler (device time by op, busy share).
5a. archs  — the attention-only archs at full width, random weights from
             a seed, each model freed before the next: deepseek-7b (MHA
             32/32), internlm2-20b (GQA 48/8), qwen2.5-3b (GQA 16/2,
             qkv_bias), h2o-danube-1.8b (GQA 32/8, head dim 80, window
             4096) and grok-1-314b (8 experts top-2, d_ff 32768).  (a)
             Depth cut to 4 layers (grok 2): ``make_prefill_fn`` at B=2,
             S=2048 (danube B=1, S=8192, so its window masks the second
             half) must launch one flash ``wgmma`` a layer (never
             ``simt``) and, for grok, 3 gmm ``wgmma`` a layer, and its
             last-position logits must match the plain versions (grok's
             expert matmul on the tensor cores) within 2e-2 of the largest
             logit at the reference init and, drawn anew, at the fan-in
             init of phase 13 (d); ``ContinuousBatcher`` answers 4
             requests (prompts of 8-16 tokens, 16 new tokens each), grok's
             ticks launching 3 gmm ``decode`` a layer, the dense archs'
             none.  (b) deepseek-7b, qwen2.5-3b and h2o-danube-1.8b also
             at full depth: a timed warm prefill, its logits' gap to the
             plain versions logged (not gated), the 4 requests, peak
             memory.
6. collective — a 4-rank gloo world on the one card (every rank on
             cuda:0; NCCL refuses two ranks on one device).  The port's
             ``TorusComm`` on dims (2,2) and (4,): direct, factorized
             (natural and paper, every round order), reverse, tiled,
             all-gather and reduce-scatter must equal the definition of
             each collective bit for bit on CUDA tensors, and each
             factorized call must launch the block-reorder passes that
             ``core.factorized.round_schedule`` lists for its round order
             (pack, fused repack, unpack; identity passes skipped: 2 a
             call on (2,2), none on (4,)).  The overlap engine
             (``backend="pipelined"`` and ``"overlap"``, both variants,
             n_chunks 2 and 3, where 3 shrinks to 2 chunks of the
             1000-element block) through forward, reverse, tiled and
             ``overlap(compute_fn=2x+1)`` must equal the factorized plan
             and the definition bit for bit, each call launching n_chunks
             times round_schedule's passes.  The ragged and the sparse
             Alltoallv (bucketed forward and reverse; ragged over the
             factorized, overlap and direct data plans) on seeded send
             counts with zeros and whole empty lanes: every counted row
             must carry the simulator oracle's tag, ``recv_counts`` must
             be the count matrix's column, and the launches must be the
             counts phase's and the data rounds' passes.  FSDP on the
             (2,2) torus: ``parallel.sharding.fsdp_gather`` of each
             rank's shard of phi3.5-moe's embedding (32064 x 1024 of
             32064 x 4096, bf16, integer values) must be the whole
             embedding bit for bit, and its backward (the reduce-scatter
             in f32 of integer-valued bf16 cotangents) every rank's
             cotangents' sum over its block, bit for bit.  The chunked
             gathers on (2,2) (``n_chunks`` 2 and 3, async chunk
             collectives through the overlap engine's pipeline): the
             all-gather in bf16, f32 and int64 bit for bit against
             ``n_chunks=1``, the definition and the ported simulator
             oracle's placement; the int64 reduce-scatter bit for bit,
             the f32 one within p * 2**-23 of its terms' magnitudes; one
             backward of each bit for bit the unchunked plan's; the host
             ms of a 4 MiB bf16 block at each ``n_chunks`` printed.
7. autotune — in the same world, the tuning DB a file in a temporary
             directory: ``core.autotune.autotune`` on phi3.5-moe's EP
             block (4, 512, 4096) bf16 over (data, pod), 16 MiB a block,
             with ``max_chunks=4`` and a 60 s budget, then on the
             dropless layer's padded data block (2048, 4096), then
             ``autotune_ragged`` at the dropless row (4096,), window
             2048.  Every rank must return the same plans and winner,
             ``tuned_from == "measured"``; the table must be the
             reference's candidate list for dims (2,2) (direct,
             factorized (0,1) and (1,0), overlap at the
             ``_chunk_candidates`` counts) with nothing skipped; a second
             ``backend="autotune"`` build must time nothing; the plan's
             forward and reverse must equal the definition bit for bit
             with n_chunks x round_schedule's reorder passes.  Prints the
             per-candidate medians, the fitted per-axis links beside
             ``default_links``, the winners and the search seconds, and
             the guideline report (``core.guidelines``) of the two dense
             searches' measured direct and factorized rows (not a gate:
             gloo's host staging on one card says nothing of NCCL).
8. moe_ep  — in the same world, phi3.5-moe's MoE layer at full width with
             expert parallelism over (data=2, pod=2): each rank holds 4 of
             the 16 experts and 512 tokens (B=1, S=512).  Cuts: one layer,
             capacity_factor 8 (no token drops, so that the one-process
             layer is a reference).  The configuration's own a2a_backend
             "tuned" must resolve to the overlap engine (its describe()
             is printed), which pipelines dispatch, expert FFN and
             combine per capacity chunk.  The gathered output must match
             the same layer with mesh=None on all 2048 tokens in one
             process within 2e-2 of the largest |y|, the aux loss within
             1e-3; the largest |y| difference to the same call with
             a2a_backend "factorized" is printed; per rank per call the
             gmm must launch 3 times per chunk (in the variant
             ``moe_gmm.variant`` gives the chunk's rows) and the block
             reorder n_chunks times round_schedule's passes each way;
             the factorized call 3 times and one set of passes each way.
             A third call under a2a_backend "autotune" must replay
             phase 7's winner on every rank (``tuned_from ==
             "measured"``), equal the factorized call's output bit for
             bit and launch the winner's gmm and reorder passes.
             Then grok-1-314b's MoE layer at full width (d 6144, d_ff
             32768), 2 of its 8 experts and 512 tokens a rank, capacity
             factor 8, its own tuned plan (must resolve to overlap): the
             gathered output within 2e-2 of the largest |y| of the
             mesh=None layer, equal to the factorized call bit for bit on
             every rank, each call's launches the prediction (3 gmm a
             chunk, round_schedule's reorder passes a chunk each way).
             The overlap call, the factorized call, the autotune call and
             the dropless calls of phase 9 are profiled on rank 0 (device
             and wall time, the port's profiler spans such as each
             Alltoallv counts exchange, the overlap engine's chunk copies
             and joins); ``core.profile_inspect.interleave_report`` on the
             overlap call's profile must find exchanges between its
             expert-FFN stages, on the factorized call's none.
9. moe_dropless — in the same world, the same layer with
             capacity_factor=None (dropless) and a2a_backend "tuned",
             512 tokens per rank: ``moe_dropless_a2a_plan`` picks the
             ragged or the sparse Alltoallv (printed, with the plan's
             expected and the call's measured occupancy).  The gathered
             output must match the mesh=None dropless layer on all 2048
             tokens within 2e-2 of the largest |y|, the aux loss within
             1e-3; the launches must be 3 gmm and the counts phase's and
             data rounds' block-reorder passes each way.  A second call
             under a2a_backend "autotune" must replay phase 7's
             ragged-vs-sparse winner (a ragged plan's data plan the
             padded block's measured winner), launch its passes and lie
             within the same 2e-2 of the one-process layer.
10. tracing — in the same world, with ``core.telemetry`` tracing on:
             the factorized, overlap and dropless layer calls, 3 times
             each, must equal the untraced calls bit for bit with the
             same launches; the span tree must be the plans' (a
             ``plan.execute`` with a ``plan.round`` per factorized
             round, one fused round for the overlap engine, the counts
             phase inside each ragged call); the drift keys the
             reference's ``_drift_key()`` format; ``StragglerWatchdog
             .check_drift`` one "retune" per drifted key, then none; the
             exported Chrome trace reloads with the schema.  Prints the
             drift ratios under ``default_links`` and under phase 7's
             fitted links (the card's gloo world is no TPU: expect
             ratios far above 1.5), and a 512 KiB decode-size call's
             host µs with tracing off and on.
11. train_ep — in the same world, after [tracing]: expert- and
             data-parallel training on the (data=2, pod=2) mesh through
             ``build_training(cfg, mesh)``: phi3.5-moe at full width (its
             own a2a_backend "tuned", which must resolve to the overlap
             engine; its describe() is printed), 4 of 16 experts per
             rank.  Cuts: depth 1 layer; capacity_factor 8 (no token
             drops, so the one-process step is a reference); the copy
             task at B=1, S=1024 per rank (4096 tokens, as many as
             [train]), each row block's first 768 tokens set to one
             token whose top-1 expert lies on that block's EP rank
             (picked by routing one-token sequences), so that every
             capacity chunk of the overlap engine carries routed rows
             on every rank (random tokens fill about 128 of C = 1024
             slots, all in the first chunk): the recorded routing must
             show it and no drop.  (a) One loss + backward under "tuned" and one
             under "factorized" from the same parameters and batch: every
             reduced leaf (``model_api.reduce_grads``) finite and
             non-zero, within 2e-2 relative norm of the other plan's and,
             gathered over the EP group on rank 0, of the one-process
             kernel step's on the global batch; the losses within 1e-2.
             (c) 3 timed full-width steps (loss, backward, gradient
             reduction, AdamW) with their launches per step predicted
             from the plan (gmm all ``wgmma``: 15 per chunk under the
             overlap engine, whose backward recomputes the expert FFN;
             flash forward-with-lse 2, backward 1; the block reorder
             round_schedule's passes x chunks x (forward, recompute,
             backward) each way), peak memory per rank, one step
             profiled on rank 0.  (d) One loss + backward under each
             ``remat_policy`` (``nothing``, ``collectives``, ``dots``)
             from the same parameters and batch: every reduced leaf bit
             for bit the ``nothing`` one's; launches as predicted (flash
             2 + 1 under each; under ``collectives`` the recompute
             exchanges nothing: the reorder passes x 2 instead of x 3,
             and the gmm 12 a chunk, the skipped ``OverlapFn`` taking its
             expert FFN with it); each policy's peak memory and host ms
             per rank printed beside the card.  (b) ``Trainer.run`` for 4 steps at a
             cut width (d 512, 4/2 heads, d_ff 1024: a checkpoint under
             1 GiB, inside ``DISK_WRITE_BUDGET`` beside [train]'s) with
             an async checkpoint of global arrays at step 2, restored
             into a fresh ``Trainer`` bit for bit on every rank.  The
             parameters are laid out as the reference's rules say: the
             experts over the EP group, the embedding's and attention's
             ``d_model`` dim over (pod, data) by FSDP (gathered before
             each use, the gradient reduce-scattered); every rank's
             parameter count must be the layout's, and each prints the
             parameters and state bytes it holds, its peak memory and
             the FSDP span's host ms in one step, beside the card's
             name and power limit.
11a. ring, pipeline — in the same world, between [train_ep] and
             [elastic]: ``parallel.ring_attention`` on a (model=4) mesh
             at phi3.5's attention shapes (q (1, 32, 2048 / 4, 128), 8 kv
             heads, bf16, causal, and once with a 512-token window; k and
             v rotating by ``ppermute``) must match the flash kernel on
             the whole sequence within rtol = atol = 2e-2 on every rank;
             ``parallel.pipeline``'s GPipe schedule on a (pod=4) mesh, 4
             stages x 2 residual MLP layers (D 4096, H 6400, bf16), 256
             rows in 4 microbatches: the forward within 2e-2 of the
             largest |y| of the sequential run of all stages and each
             stage's gradients within 2e-2 relative norm of its.
11b. fft   — in the same world, between [pipeline] and [elastic], on
             (data, pod) = (2, 2): ``workloads.pencil_fft`` at a 512³
             grid (1 GiB of complex64, 256 MiB a rank), every global
             array drawn from the seed on the card by every rank.  (a)
             The 3-D complex64 pencil, grid ((data,), (pod,)), under
             ``tuned`` and ``factorized``; (b) the same array as a slab
             over both axes (two factorized rounds, so the block reorder
             runs on complex64 rows): ``direct``, ``factorized``
             natural and paper, the factorized forwards equal to the
             direct one bit for bit and their reorder launches not zero;
             (c) the real (512, 512, 510) float32 pencil (256 rfft bins
             split over pod); (d) the 2-D complex64 slab (8192, 8192).
             Each rank's forward pencil must lie within 1e-5 of the
             largest |coefficient| of the one-process ``torch.fft.fftn``
             (``rfftn``) in complex128 on the card, the round trip
             within 1e-5 of the largest |input|, and each call's
             pack / repack / unpack launches must be those
             ``round_schedule`` lists for its stage plans.  (e)
             ``models.spectral.distributed_fft_causal_conv`` at jamba's
             mixer width (E = ssm_expand x d_model = 8192, B 1, S 4096;
             the kernel ``ssm_kernel`` of a spectral layer's parameters
             from the seed): each rank's rows within 1e-4 of the largest
             |output| of the one-process ``fft_causal_conv`` (the gap
             printed).  Prints the median host ms of 3 forwards, inverses
             and stage transposes after a warm-up, the bytes each
             transpose moves a rank and the resolved backend of every
             stage.  [tracing] gains one traced (b) factorized forward a
             rank: bit for bit the untraced one, its span tree the CPU
             test's (``tests/torch_fft.py``), its rounds' host µs and
             measured / predicted ratio printed.
11b'. serve_disagg — in the same world, between [fft] and [elastic]:
             disaggregated serving (``runtime.serving
             .DisaggregatedServer`` through ``launch.serve
             .serve_disaggregated``) on a torus comm over (data, pod) =
             (2, 2), every rank calling the same ticks.  (a) phi3.5-moe
             at full width, depth 2 (2.86 B parameters a rank, the same
             seed on every rank), 2 prefill ranks of 4 slots, 2 decode
             ranks of 4 slots (decode_batch 8), chunk 4: 8 requests in 2
             tenants (quota 2), seeded prompts of 17-96 tokens, 16 new
             tokens each, max_seq 112, under the KV plan backends
             ``tuned``, ``factorized`` and ``sparse``, traced (the
             ``serve.*`` spans).  Every ``decode_step`` runs at batch 4
             with a colocated ``ContinuousBatcher(max_batch=4,
             max_seq=112)``'s cache shapes, so every request's tokens on
             every rank must equal that colocated run's on rank 0 bit
             for bit; migrations must happen, the plan's kind be
             ``kv_migrate``, the reorder launches be the handoffs times
             ``round_schedule``'s passes of the plan's counts and data
             phases, and the gmm launches 6 ``decode`` per
             ``decode_step`` (``simt`` none).  (b) the tuned run again,
             rank 3 lost at tick 8: ranks [0, 1, 2] rebuild with one
             prefill rank and must still give the colocated tokens
             (rank 3 waits at a barrier).  (c) one full-depth handoff at
             phi's real row (32 layers x (2 x 8 x 128 + 1) = 65 568 f32
             features): ranks 0 and 1 send 1024 and 700 seeded rows to
             ranks 2 and 3 through each backend (bucket 1024: a (4, 1024,
             65568) f32 send block, 1.07 GB a rank); the received rows
             must equal the rows sent bit for bit.
11c. elastic — last in the same world, as the reference's
             ``check_rebuild.py``: (a) [moe_ep]'s layer loses ranks 2, 3
             on its plan's 3rd call (a ``FaultInjector``); the watchdog
             must say recover; the survivors ``TorusComm.rebuild`` the EP
             comm by themselves onto ``dims_create``'s torus (printed),
             which must free the dead comm's plans and keep another
             comm's, and migrate the tuning records whose extents
             survive (an extra one-axis search over ``pod`` gives one);
             the layer on it, 8 experts a rank, must match the
             one-process layer on the survivors' tokens within 2e-2 of
             the largest |y|, launch what ``round_schedule`` predicts and
             exchange as the definition says, bit for bit.  A barrier
             then starts (b) on all four ranks: ``Trainer(elastic=True)``
             at [train_ep]'s cut width, 6 steps, a synchronous checkpoint
             every 3, ranks 2, 3 lost at step 5 (they leave); the
             survivors recover once onto ``launch.mesh.survivor_mesh``,
             finish at step 6 and must equal a direct restore of the
             step-3 checkpoint plus the same 3 steps, bit for bit.
12. train_tp — after that world has ended, a second gloo world of 8
             ranks on the one card, the mesh (pod=2, data=2, model=2):
             tensor parallelism over model (query / kv heads 16/4 a rank,
             the experts' F cut to 3200, the vocab-parallel embedding,
             head and cross-entropy) with EP over (data, pod), 4 of 16
             experts a rank, every kernel on the path.  Cuts as
             [train_ep]'s: depth 1, capacity factor 8, B=1 S=1024 per
             row block, the filled batch, ``tuned`` (must resolve to the
             overlap engine).  Rank 0 first computes the one-process
             prefill and decode logits and the one-process kernel step
             on the global batch at the reference init and at the
             fan-in init of phase 13 (d), with its routing recorded,
             keeps them on the host and frees the card before any mesh
             state exists.  Then ``build_training(cfg, mesh)``: at each
             init one loss + backward that replays the one-process
             routing of its row block (TP sums partial products in
             another order, and a near tie in the router may then
             choose another expert: the count is logged), whose reduced
             gradients, gathered to rank 0's host, must lie within 2e-2
             relative norm of the one-process step's per leaf at the
             fan-in init (logged at the reference init, whose near
             one-hot softmaxes turn the bf16 partial sums TP rounds
             apart into gaps of percents: ``tools/tp_numerics.py``
             measures one such rounding alone), the losses within 1e-2
             at both, the routed rows as for [train_ep];
             the model ranks of each row block must agree bit for bit
             (the router's probabilities and top-k in every call, the
             whole leaves' reduced gradients, their parameters after
             the timed steps, the serving logits); 3 timed steps with
             the launches per step predicted as [train_ep]'s (the TP
             cut changes shapes, not counts), peak memory per rank, one
             step profiled on rank 0 (busy share, the host ms of the
             TP all-reduces' span); ``make_prefill_fn`` (B=1, S=1024 a
             row block) and 8 decode ticks of ``make_serve_step`` on
             the mesh, full-vocab logits within 2e-2 of the largest
             one-process logit; ``Trainer.run`` for 4 steps at
             [train_ep]'s cut width with an async checkpoint at step 2
             restored bit for bit.  FSDP splits the embedding's and
             attention's ``d_model`` dim over (pod, data) as in
             [train_ep] (the vocab and heads over model as well); the
             bit-identity of the model ranks covers every leaf whole
             over model, FSDP shards included, and the per-rank
             parameters, state, peak and FSDP span are checked and
             printed as [train_ep]'s.
12b. ulysses — in the same 8-rank world after [train_tp]: phi3.5-moe
             at [train_tp]'s width, depth and tokens with ``use_ulysses``:
             each rank projects 512 of its row block's 1024 tokens with
             the attention weights whole over model (FSDP over (pod,
             data), gradients partial over model), the tiled all-to-all
             re-shards q (1, 32, 512, 128) to (1, 16, 1024, 128) and k /
             v likewise around the flash kernel, and the rows are
             gathered back over model before the MoE under TP.  Rank 0
             first runs the one-process reference at the fan-in init of
             phase 13 (d) (prefill and 8 decode ticks, a loss + backward
             with its routing recorded) and frees it.  Then on the mesh:
             prefill and decode logits within 2e-2 of the largest
             one-process logit (one flash ``wgmma`` launch per layer in
             the prefill); a loss + backward replaying the routing,
             every reduced leaf finite, non-zero and, gathered to rank
             0, within 2e-2 relative norm of the one-process step's, the
             loss within 1e-2; its launches and those of one
             ``make_train_step`` step [train_tp]'s prediction; the model
             ranks of each row block bit-identical (router calls, whole
             leaves' reduced gradients and parameters, serving logits);
             the re-shard of the path's q shard equal to the definition
             of the tiled all-to-all bit for bit both ways; the GQA
             all-gather path (4 / 1 heads, Hkv < sp) within 2e-2 of the
             flash kernel on the whole sequence.  The seconds of
             [ulysses], [ring] and [pipeline] are printed with their sum.
12c. recurrent_mesh — in the same 8-rank world after [ulysses], the
             recurrent mixers under tensor parallelism over model (each
             mixer's channels or heads split, its [xs | z] projection
             pairwise) and FSDP over (pod, data), at the fan-in init;
             every rank draws each global leaf in turn from the seed and
             keeps its slice, no rank the whole tree.  (b) xlstm-1.3b at
             full width, one superblock (7 mLSTM, 1 sLSTM; 2 of 4 heads
             a rank): rank 0 first runs the one-process reference and
             frees it; one ``make_train_step`` step at B=1 S=1024 a row
             block (chunkwise mLSTM), all in f32 (in bf16 the
             roundings alone move xlstm's gradients by 50-100%): every
             gathered gradient leaf and parameter after the step within
             2e-2 relative norm of the one-process step's, the loss
             within 1e-2, the grad norm within 2e-2, the model ranks'
             whole leaves bit-identical, no kernel launched; prefill and
             8 ticks within 1e-3 of the largest one-process logit; 25 TP
             collectives a prefill.  (a) jamba-v0.1-52b at full width,
             one superblock (EP of the 16 experts over (data, pod), mamba
             on 4096 of 8192 channels a rank, attention on 16/4 heads,
             the expert FFN on 7168 of F; capacity factor 2, no row block
             routing over C): a mesh prefill at B=4 (a sequence a row block)
             S=2048 and 4 ticks; after the world, the main process runs
             the one-process port on the same parameters, prompts and
             ticks replaying the mesh's routing, with the kernels in
             bf16 and on the plain versions in f32: the mesh's logits no
             farther from the f32 run than twice the bf16 one-process
             run's (plus 1e-3 of the largest), as [recurrent]'s decode
             gate; per rank the launches predicted (gmm
             ``wgmma`` in the prefill, ``decode`` in the ticks, never
             ``simt``; flash once; the EP exchanges' reorder passes),
             the TP collectives a prefill and a tick predicted (2 a
             mamba call), the mamba state this rank's channels.  (c) the
             same jamba under ``use_ulysses``: its attention layer
             sequence-parallel over model (every attention leaf whole
             over model and partial), the mixers, the MoE and the head
             split as in (a); each rank draws its shard anew and runs its
             row block's prefill and ticks, replaying (a)'s routing; gated as (a) against (a)'s
             one-process runs, the model ranks bit-identical, one flash
             ``wgmma`` a prefill on the rank's 16 heads over all 2048
             positions (never ``simt``), the gmm and reorder launches
             (a)'s prediction.
12d. encdec_mesh — in the same 8-rank world after [recurrent_mesh],
             bf16 at the fan-in init, every rank drawing its shard from
             the seed: (a) whisper-tiny at its full config (4 + 4 layers,
             d 384, 3 of 6 heads a rank, 768 of F, the 51865 vocab whole
             over model, FSDP over (pod, data)); rank 0 first runs the
             one-process reference on the global batch of 8 (S=448, 1500
             frames) and frees it; on the mesh a prefill, the encoder's
             memory of the rank's 2 rows, 8 ticks reading it and one
             ``make_train_step`` AdamW step; (a') the same whisper under
             use_ulysses (750 frames and 224 tokens a rank in each
             attention call): a prefill and one loss + backward against
             (a)'s reference; (b) internvl2-2b at full width cut to 4
             layers (8/4 heads a rank, the 92553 vocab whole,
             frontend_proj FSDP-split), B=4 (one a row block) with 256
             patch embeddings before 2048 tokens: a prefill and one loss
             + backward.  Gates: each rank holds its layout's
             parameters; every gathered reduced gradient leaf within
             2e-2 relative norm of the one-process one, the loss within
             1e-2; prefill and tick logits within 2e-2 of the largest
             one-process logit; the model ranks of each row block
             bit-identical (loss, whole leaves' gradients and
             parameters, logits); the flash launches per rank (12
             ``wgmma`` a whisper prefill, 4 an encode, 4 a tick, 24 / 12
             a step; internvl2 4, 8 / 4), never ``simt``; the TP
             collectives and FSDP gathers of a prefill, an encode and a
             tick as predicted; whisper's KV cache on 3 kv heads.  Logs
             host seconds, peak memory and collectives per call.
12e. rules_mesh — last in the same 8-rank world, the sharding rules the
             port once refused.  (a) [train_tp]'s model, cuts, seed,
             fan-in init, global batch and replayed one-process routing
             under batch=("data",) (EP over (data, pod) and FSDP over
             (pod, data) outside the batch rule: each row block held by
             2 pod ranks), embed_fsdp=("model",) (wq / wk / wv FSDP over
             model and gathered whole, wo's heads and the experts' F
             split over model) and vocab=("data",) (the embedding FSDP
             over pod alone, the other leaves over (pod, data)): one
             loss + backward each; every gathered reduced gradient leaf
             within 2e-2 relative norm of [train_tp]'s default-rules
             step, the loss within 1e-2, the model ranks of a (pod,
             data) coordinate bit-identical on every leaf none of them
             splits, the launches as predicted (SIMT 0).  (b) after it,
             [elastic] (b)'s Trainer at its cut width on (pod 2, data 2,
             model 2): ranks 5 and 6 lost at step 5, their partners 4
             and 7 leave too, ranks 0-3 recover onto (data 2, model 2)
             and equal the direct restore plus the same steps bit for
             bit.  (c) runs in the 4-rank world after [moe_ep]:
             ``overlap(x, 2 sin(x), reverse=False)`` under autograd on
             [moe_ep]'s plan and block, output and input gradient bit
             for bit those of ``2 sin(forward(x))``, each direction's
             reorder launches n_chunks x round_schedule's passes.
13. train  — after the worlds have ended: ``launch/train.py``'s
             ``build_training`` on phi3.5-moe-42b at full width cut to 2
             layers (bf16 parameters, f32 AdamW moments: 2.73 B
             parameters, 32.8 GB of state before activations), remat on,
             the copy task at B=2, S=2048.  (a) One loss + backward with
             the kernels and one under ``ops.plain_versions()`` (the
             expert matmul on the tensor cores, as in phase 3; the plain
             versions as they stand are logged beside) from the
             same parameters and batch: every leaf's gradient must exist,
             be finite and non-zero, and lie within 2e-2 relative norm of
             the plain one (bf16; a near-tie in routing may move one
             token between experts, so no elementwise bound), the losses
             within 1e-2 relative.  A third, witness run takes the plain
             versions but attention's FA2 formulas (p from lse, delta
             from the bf16 O) in place of autograd; each leaf's gap to
             both paths is logged, which tells the formulas' share of the
             gap from the kernels'.  (b) ``Trainer.run`` for 4 steps with
             an async checkpoint at step 2, restored into a fresh
             ``Trainer`` and compared bit for bit with the live state
             (that one 27.3 GB checkpoint is the run's only large disk
             write; it must stay within ``DISK_WRITE_BUDGET``), under the
             tracer: 4 ``train.step`` spans, one ``checkpoint.save``,
             one ``checkpoint.restore``.
             (c) Per-step ms, peak memory and launches per step, which
             must be the predicted 4 flash forward-with-lse, 2 flash
             backward and 24 gmm per step (remat runs each forward kernel
             twice); then one profiled step.  (d) (a) again, against the
             plain versions as they stand, on parameters
             drawn at std 1/sqrt(fan-in) of each matmul: the reference's
             init makes every softmax near one-hot at this width (loss
             ≈ 270), where the FA2 backward's ds is near 0; there the
             kernel path's gradients must lie no more than 1.25 times as
             far from an f32 plain run (same weights and routing) as the
             plain path's do, leaf by leaf.  The plain, witness and f32
             runs replay the kernel run's top-2 routing (the remat
             recompute must route as the forward did); the number of
             choices they would have made otherwise is logged.
13b. train_danube — h2o-danube-1.8b at full width (head dim 80, window
             4096) cut to 2 layers, the copy task at B=1, S=6144: one loss
             + backward with the kernels against the plain versions at the
             fan-in init, as (d) but without the f32 run: every leaf
             within 2e-2 relative norm, the loss within 1e-2, 4 flash
             forward-with-lse ``wgmma`` and 2 backward launches at head
             dim 80.  The seconds of [archs], grok's [moe_ep] layer and
             [train_danube] are printed with their sum.
14. recurrent — jamba-v0.1-52b at full width, one superblock (8 layers:
             7 mamba, 1 attention, 4 MoE): the prefill (B=2, S=2048) gate
             at both inits, the plain runs replaying the kernel runs'
             routing (1 flash and 12 gmm ``wgmma`` a prefill); 5 requests
             on 4 slots, a finished request's slot reused (12 gmm
             ``decode`` a tick); forward vs 32 decode ticks, dropless:
             in f32 on the plain versions within 1e-3 of the largest
             logit (the state hand-off), in bf16 with the kernels no
             farther from the f32 forward than twice the bf16 forward.
             The spectral substitute at jamba's width: the FFT
             convolution against the recurrence.  xlstm-1.3b at full
             width and depth (48 layers, fan-in init): prefill (chunkwise
             mLSTM, per-step sLSTM; no kernel), 5 requests on 4 slots,
             forward vs decode one superblock deep, one mLSTM layer
             chunked against per-step at S=512.
15. train_recurrent — jamba (8 layers, B=1, S=1024, fan-in init): one
             loss + backward against the plain versions with the expert
             matmul on the tensor cores, every leaf within 2e-2 relative
             norm, the loss within 1e-2 (2 forward-with-lse, 1 backward,
             48 gmm ``wgmma``); xlstm-1.3b at 8 layers: one
             ``make_train_step`` AdamW step, every leaf's gradient finite
             and non-zero; one mLSTM layer's gradients chunked vs
             per-step at S=256 within 2e-2.  Their seconds are printed.
16. encdec — whisper-tiny at its full config (4 encoder + 4 decoder
             layers, d 384, 6 heads of 64, 1500 frames, vocab 51865;
             frames and weights from seeds): ``make_prefill_fn`` at B=4
             over 448 decoder tokens (12 flash ``wgmma``: 4 encoder, 4
             decoder self, 4 cross) against the plain versions within
             2e-2 of the largest logit at the fan-in init, and at the
             reference init (near one-hot softmaxes, where both bf16
             paths lie ~80% from f32) no farther from an f32 run than
             1.25 times the plain path; ``encode`` (4); the forward
             against 32 decode ticks in f32 on the plain versions at the
             fan-in init within 1e-3 of the largest logit; the
             launcher's body with the memory answers 4
             requests (one cross-attention ``wgmma`` a decoder layer a
             tick); the card ms of a tick and of its cross K / V
             recompute.
17. train_encdec — whisper-tiny at its full config (B=4, S=448, 1500
             frames, fan-in init) and internvl2-2b cut to 4 layers (B=1,
             S=2048 after 256 patch tokens): one loss + backward each
             against the plain versions as 13b; then 3 whisper
             ``make_train_step`` AdamW steps, finite, each with 24 flash
             forward-with-lse and 12 backward launches.  Phase 5a also
             runs internvl2-2b (its prefill with 256 seeded patch
             embeddings; 4 layers and full depth).

The grouped matmul has three variants (``moe_gmm.variant``): wgmma (TMA
and tensor cores) for bf16 at aligned shapes, decode (mma.sync, a
bandwidth path) for C <= 16, SIMT for f32 and unaligned shapes.  Phase 2
prints the variant each row takes, runs the odd-shape sweep in both dtypes
and all four operand layouts through the variant it takes and through
SIMT, and the JSON line lists each variant as a kernel.  Every phase's
launch counts fix the variant: a main-path gmm that took SIMT fails.

The flash forward (serving, and the forward-with-lse of training) has two
variants (``flash_attention.variant``): wgmma (TMA and tensor cores) for
bf16 at head dims 64, 80 and 128, SIMT (f32 FMA) for the rest.  Phase 2 times
both at the prefill / training shape, at h2o-danube-1.8b's prefill
(q (1, 32, 8192, 80), window 4096), at whisper-tiny's encoder (q (4, 6,
1500, 64), non-causal), its cross-attention (q (4, 6, 448, 64) against
1500 rows) and a decode tick's (one query row against them), and at
internvl2-2b's prefill (q (2, 16, 2304, 128), causal GQA 16/8; the
training rows add whisper's encoder and cross shapes), and the wgmma one
again with q x 100
(logits in the hundreds, where it re-sums the logits near each row's max
in f32 FMA order), checks that two wgmma runs agree bit for bit, and runs
both sweeps through the variant each case takes and, for wgmma, through
SIMT, large logits included; the JSON line lists each variant.  The
prefill and training launch counts must show every flash launch in wgmma.
(``tools/flash_numerics.py``, run by hand, measures where the wgmma
variant's re-summation fires and what the tensor cores' summation order
alone does to the training gates.)

Phase 2 also holds the training kernels against their plain versions at
the training shapes of phases 11, 12, 13 and 13b (derived from the same
constants, config and resolved plans) and at GQA / window / ragged
shapes, head dim 80 among them: the flash
forward that keeps lse, the FA2 backward (run twice, equal bit for bit),
and the grouped matmul's backward (``GroupedMatmulFn``, whose products
read ``rhs^T`` and ``lhs^T`` as views) against autograd of the plain gmm;
and the gmm at the F that tensor parallelism cuts (3200 and 1600 at
model 2 and 4: multiples of 8, not of 128) in all four operand layouts,
and at grok-1's shapes (E = 8, D 6144, F 32768: prefill C = 1280, decode
C = 4, and its [moe_ep] layer's chunk and factorized rows).

Phase 2 also holds the gmm at jamba-v0.1-52b's shapes (E = 16, D 4096,
F 14336: prefill C = 640, decode C = 4, training's backward at C = 160)
and at a 65 536-token prefill's C = 10240, whose w1 output, w2 lhs and
drhs operand hold 2.35e9 elements, past 2^31 (fault F3).

Phase 2 also holds the block-reorder kernel (the round-k datatype pack,
unpack and the fused unpack-then-pack between rounds) against its plain
versions, bit for bit, at every buffer phases 6, 8, 9 and 11 reorder (their
shapes derived from the same constants and config), at the EP buffers of
phi3.5-moe serving, the paper's tori and odd sizes, every round and every
ordered pair of rounds; it times the passes of a (2,2) call at the
[moe_ep] overlap chunk (also the dropless data chunk), the whole [moe_ep]
buffer, [train_ep]'s chunks and whole buffer, EP prefill and EP decode
buffers and [fft] (b)'s complex64 slab pencil (4 rows of 64 MiB) against
the bound, the plain
version and ``index_select`` with the same row map, with each decode-size
call's host µs beside its kernel µs.

Then it prints one JSON line of per-kernel numbers (``bound_ms`` is the
larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s, the H100 SXM's
published peaks), the card's name and power limit from nvidia-smi, and as
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))       # torch_dist: the spawn helper

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16, published
DEVICE = "cuda"
ARCH = "phi3.5-moe-42b"
SPAN_PREFIX = "repro_torch."       # the port's torch.profiler spans
N_LAYERS = 4
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
WORLD = 4                          # ranks of the collective phases
EP_TOKENS = 512                    # tokens per rank in [moe_ep]
EP_PAIRS = 6                       # [moe_ep]'s warm rounds of its 3 plans
COLL_TORI = (((2, 2), ("data", "pod")), ((4,), ("x",)))   # [collective]
COLL_B = 1000                      # [collective]'s f32 block per rank pair
COLL_TILED = (2, 2 * WORLD, 2)     # [collective]'s tiled input, split dim 1
COLL_CHUNKS = (2, 3)               # [collective]'s n_chunks (3 shrinks)
COLL_GATHER_TIMED = 1 << 21        # [collective]: the timed chunked gathers'
#                                    bf16 block a rank (4 MiB)
COLL_ROW = (16,)                   # [collective]'s Alltoallv row, f32
COLL_MAX_COUNT = 5                 # [collective]'s Alltoallv bound: bucket 8
COLL_COUNTS = (8, 0.25)            # seed, density of its send counts
TUNE_BUDGET_S = 60                 # [autotune]: each search's budget
TUNE_MAX_CHUNKS = 4                # [autotune]: the overlap engine's bound
TRACE_CALLS = 3                    # [tracing]: traced calls per layer kind
DECODE_C = 4                       # [tracing]: the decode-size call's C
TRAIN_LAYERS = 2                   # [train]: AdamW state must fit one card
TRAIN_B, TRAIN_S = 2, 2048         # [train]'s batch (the copy task)
TRAIN_STEPS = 4                    # [train]'s Trainer.run, checkpoint at 2
TRAIN_GRAD_TOL = 2e-2              # [train]: relative norm per gradient leaf
F32_GAP_RATIO = 1.25               # [train]: kernels~f32 vs plain~f32
DISK_WRITE_BUDGET = 40 * 2**30     # bytes the run may write to disk; the
                                   # [train] checkpoint is all but the builds
WRITTEN: dict = {}                 # checkpoint bytes written, by phase
TRAIN_EP_S = 1024                  # [train_ep]: tokens per rank (B=1)
TRAIN_EP_TIMED = 3                 # [train_ep]: timed full-width steps
TRAIN_EP_STEPS = 4                 # [train_ep]: Trainer.run, checkpoint at 2
TRAIN_EP_CUT = {"d_model": 512, "n_heads": 4, "n_kv_heads": 2,
                "d_ff": 1024}      # [train_ep]'s Trainer width (< 1 GiB)
TRAIN_EP_FILL = 3 * TRAIN_EP_S // 4  # [train_ep]: leading tokens of a row
                                   # set to one token (fills every chunk)
TRAIN_EP_CANDIDATES = 256          # [train_ep]: tokens routed to pick them
TRAIN_EP_REMAT = ("nothing", "collectives", "dots")   # [train_ep]'s policies
ELASTIC_LOST = (2, 3)              # [elastic]: the ranks a device loss takes
ELASTIC_STEPS = 6                  # [elastic]'s Trainer: steps,
ELASTIC_EVERY = 3                  # a synchronous checkpoint every 3,
ELASTIC_LOSS_AT = 5                # the device loss at step 5
ELASTIC_TUNE_BLOCK = (8, 4096)     # [elastic]: a one-axis (pod) search's block
TP_WORLD = 8                       # [train_tp]: ranks of its gloo world
TP_MESH = ((2, 2, 2), ("model", "data", "pod"))   # fastest digit first
TP_BLOCKS = 4                      # [train_tp]: row blocks (pod x data)
TP_TICKS = 8                       # [train_tp]: decode ticks on the mesh
TP_SWEEP_F = (3200, 1600)          # [kernels]: F / |model| at model 2, 4
TP_INITS = ("reference", "fan-in")  # [train_tp]: the gradient runs' inits
TP_GATED = ("fan-in",)             # [train_tp]: inits gated at TRAIN_GRAD_TOL
# [rules_mesh] (a): the rule sets run at [train_tp]'s width, cuts, weights
# and batch; (b): the ranks a device loss takes on TP_MESH and the ranks
# that leave with them (their (pod, data) partners)
RULES_MESH = {"batch=data": {"batch": ("data",)},
              "embed_fsdp=model": {"embed_fsdp": ("model",)},
              "vocab=data": {"vocab": ("data",)}}
RULES_LOST, RULES_PARTNERS = (5, 6), (4, 7)
ULYSSES_GQA = (4, 1)               # [ulysses]: query / kv heads, Hkv < sp
RING_MESH = ((4,), ("model",))     # [ring]: the SP axis over the 4 ranks
RING_SHAPE = (1, 32, 8, 2048, 128)  # [ring]: B, Hq, Hkv, S, hd (phi3.5's)
RING_WINDOW = 512                  # [ring]: the windowed case's window
PIPE_MESH = ((4,), ("pod",))       # [pipeline]: 4 stages over pod
PIPE_SHAPE = (2, 4096, 6400, 256, 4)   # [pipeline]: layers a stage, D, H,
#                                    batch rows, microbatches
# [archs]: arch -> (the gate's depth, prefill B, S text tokens, whether it
# also runs at full depth); danube's S = 2 windows, so its window masks
# half; internvl2's prefill puts 256 stub patch tokens before its S
ARCHS = {"deepseek-7b": (4, 2, 2048, True),
         "internlm2-20b": (4, 2, 2048, False),
         "qwen2.5-3b": (4, 2, 2048, True),
         "h2o-danube-1.8b": (4, 1, 8192, True),
         "grok-1-314b": (2, 2, 2048, False),
         "internvl2-2b": (4, 2, 2048, True)}
DANUBE = "h2o-danube-1.8b"         # head dim 80, window 4096
GROK = "grok-1-314b"               # 8 experts: 2 a rank in [moe_ep]
TRAIN_DANUBE = (2, 1, 6144)        # [train_danube]: layers, B, S
JAMBA = "jamba-v0.1-52b"           # mamba + attention 7:1, MoE every 2nd
XLSTM = "xlstm-1.3b"               # mLSTM + sLSTM 7:1
RECURRENT_B, RECURRENT_S = 2, 2048  # [recurrent]: prefill batch, length
JAMBA_LAYERS = 8                   # [recurrent], [train_recurrent]: one
                                   # superblock (the full 32 do not fit)
DECODE_CHECK = 32                  # [recurrent]: forward vs decode positions
FVD_TOL = 1e-3                     # [recurrent]: its f32 limit, of the
                                   # largest logit
FVD_RATIO = 2.0                    # [recurrent]: bf16 ticks vs bf16 forward,
                                   # each from the f32 forward
MLSTM_CHECK_S = (512, 256)         # [recurrent] / [train_recurrent]: one
                                   # full-width mLSTM, chunked vs per-step
TRAIN_RECURRENT = (1, 1024)        # [train_recurrent]: B, S
XLSTM_CUT_LAYERS = 8               # xlstm's depth in [recurrent]'s forward
                                   # vs decode, [train_recurrent] and
                                   # [recurrent_mesh]
RM_JAMBA = (4, 2048, 4)            # [recurrent_mesh] (a), (c): jamba's global B
                                   # (a sequence a row block), S, ticks
RM_JAMBA_CF = 2.0                  # (a): capacity factor (no row block may
                                   # route over C: gated)
RM_XLSTM_S = 1024                  # (b): xlstm's tokens a row block (B=1)
F3_TOKENS = 65536                  # [kernels]: jamba's gmm at this prefill
                                   # (C = 10240): E*C*N past 2^31 (fault F3)
WHISPER = "whisper-tiny"           # encoder-decoder, 1500 frames, hd 64
INTERNVL = "internvl2-2b"          # 256 stub patch tokens before the text
ENCDEC_B, ENCDEC_S = 4, 448        # [encdec] / [train_encdec]: batch,
                                   # decoder tokens (whisper's text context)
INTERNVL_TRAIN = (4, 1, 2048)      # [train_encdec]: layers, B, text tokens
EM_WHISPER = (8, 448, 8)           # [encdec_mesh] (a): whisper's global B
                                   # (2 a row block), decoder tokens, ticks
EM_INTERNVL = (4, 4, 2048)         # [encdec_mesh] (b): internvl2's layers,
                                   # global B (1 a row block), text tokens
FFT_N = 512                        # [fft] (a), (b): the 512³ complex64 grid
FFT_REAL = (512, 512, 510)         # [fft] (c): float32, 256 rfft bins
FFT_2D = 8192                      # [fft] (d): the 2-D complex64 slab's edge
FFT_CONV = (1, 4096)               # [fft] (e): B, S at jamba's mixer width
FFT_TIMED = 3                      # [fft]: timed calls (median), after one
FFT_TOL = 1e-5                     # [fft]: of the largest |coefficient|
FFT_CONV_TOL = 1e-4                # [fft] (e): of the largest |output|
DISAGG_LAYERS = 2                  # [serve_disagg] (a), (b): phi's depth
DISAGG_BATCH = (4, 8)              # prefill slots a worker, decode slots
DISAGG_REQS = (8, 2, 2)            # requests, tenants, per-tenant quota
DISAGG_PROMPT = (17, 96)           # seeded prompt lengths, inclusive
DISAGG_GEN = 16                    # new tokens a request
DISAGG_LOST = (8, [0, 1, 2], 1)    # (b): tick, survivors, their n_prefill
DISAGG_BACKENDS = ("tuned", "factorized", "sparse")
KV_HANDOFF = (1024, 700)           # (c): rows 0 -> 2 and 1 -> 3 (max_count
                                   # the first: bucket 1024)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` runs after one warm-up,
    from CUDA events."""
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


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) of bf16 work on an H100, and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def compare(what: str, got, want, tol: float, of_max: bool = False) -> float:
    """max |got - want|; fails beyond rtol = atol = ``tol`` per element,
    or, with ``of_max``, beyond ``tol`` times the largest |want| (for sums
    of separately rounded terms, whose error scales with the terms)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
             f"version {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite kernel output")
    err = (g - w).abs()
    worst = float(err.max()) if err.numel() else 0.0
    limit = tol * float(w.abs().max()) if of_max and w.numel() else None
    if (worst > limit) if of_max else bool((err > tol + tol * w.abs()).any()):
        fail(f"{what}: max |kernel - plain| = {worst:.3g} exceeds "
             + (f"{tol} of max |plain| ({limit:.3g})" if of_max
                else f"rtol = atol = {tol}"))
    return worst


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] {len(build.SOURCES)} sources in {secs:.1f} s "
        f"({', '.join(build.SOURCES)}; rebuilt: {sorted(logs) or 'none'})")
    for name, text in logs.items():
        used = sorted({line.split("info    :")[-1].strip()
                       for line in text.splitlines() if "registers" in line})
        log(f"[build] {name} (ptxas, per instantiation): {'; '.join(used)}")
    for name in build.SOURCES:
        build.load(name)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_dryrun() -> None:
    """[dryrun]: ``launch.dryrun``'s record of every cell of
    ``configs.shapes`` on both production meshes, host only, on the
    ``meta`` device with no world: every applicable cell ``ok``, the
    rest ``skipped`` with ``configs.applicable``'s reason, as on the CPU,
    one JSON a cell.  Prints the cell count, the largest per-device bytes
    and the seconds."""
    from repro_torch.configs import ARCH_NAMES, SHAPES, applicable, get_config
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                records = dryrun.main(["--all", "--out", tmp])
        except SystemExit:
            bad = [f.name for f in Path(tmp).iterdir()
                   if '"failed"' in f.read_text()]
            fail(f"[dryrun] cells failed: {bad}")
        written = len(list(Path(tmp).iterdir()))
    secs = time.perf_counter() - t0
    if len(records) != 2 * len(ARCH_NAMES) * len(SHAPES) \
            or written != len(records):
        fail(f"[dryrun] {len(records)} records, {written} files")
    for rec in records:
        ok, reason = applicable(get_config(rec["arch"]), SHAPES[rec["shape"]])
        if rec["status"] != ("ok" if ok else "skipped") or \
                rec.get("reason", "") != reason:
            fail(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
                 f"{rec['status']} {rec.get('reason')}, expected "
                 f"{'ok' if ok else 'skipped: ' + reason}")
    done = [r for r in records if r["status"] == "ok"]
    big = max(done, key=lambda r: r["bytes_per_device"]["total"])
    log(f"[dryrun] {len(records)} cells ({len(done)} ok, "
        f"{len(records) - len(done)} skipped as on the CPU) on meta with no "
        f"world, torch {torch.__version__}, in {secs:.2f} s; the largest "
        f"per device: {big['arch']} x {big['shape']} x {big['mesh']}, "
        f"{big['bytes_per_device']['total'] / 2**30:.2f} GiB "
        f"({ {k: round(v / 2**30, 3) for k, v in big['bytes_per_device'].items()} } GiB)")


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def phase_kernels(gen):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.moe_gmm import VARIANTS
    F = torch.nn.functional
    results = {}

    # ---- grouped matmul: the main path's shapes (phi3.5-moe: E=16,
    # D=4096, F=6400; C=4 at decode on 4 slots, C=640 at prefill B*S=4096)
    cases = []
    for phase, C in (("prefill", 640), ("decode", 4)):
        for K, N in ((4096, 6400), (6400, 4096)):
            a, b = _randn(gen, 16, C, K), _randn(gen, 16, K, N)
            cases.append(_gmm_case(f"gmm {phase}", a, b))
            if K == 4096:    # the SIMT variant at the same shape, timed
                cases.append(_gmm_case(f"gmm {phase}", a, b, force="simt"))
            del a, b
    cases += _grok_gmm_cases(gen)
    cases += _jamba_gmm_cases(gen)
    cases += _path_gmm_cases(gen)
    _gmm_sweep(gen)
    cases += _gmm_tp_cases(gen)
    cases += _gmm_backward_cases(gen)
    for v in VARIANTS:       # each variant's first row: prefill, decode
        main = next(c for c in cases if c["variant"] == v)
        results[f"grouped_matmul_{v}"] = dict(
            name=f"grouped_matmul_{v}", route="cuda",
            source="src/repro_torch/csrc/grouped_matmul.cu",
            replaces="src/repro/kernels/moe_gmm.py:48",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            shape=main["shape"],
            cases=[c for c in cases if c["variant"] == v])

    # ---- flash attention: the prefill's shape (B=2, S=2048, 32 q heads,
    # 8 kv heads, hd=128, causal), each variant
    B, Hq, Hkv, S, Dh = 2, 32, 8, 2048, 128
    q = _randn(gen, B, Hq, S, Dh)
    k, v = _randn(gen, B, Hkv, S, Dh), _randn(gen, B, Hkv, S, Dh)
    shape = f"q({B},{Hq},{S},{Dh}) kv({B},{Hkv},{S},{Dh}) causal bf16"
    rows = _flash_rows(
        "flash", shape, flash_attention, flash_attention_plain,
        lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), "sdpa", q, k, v)
    del q, k, v
    danube = _danube_flash_rows(gen)
    encdec = _encdec_flash_rows(gen)
    _flash_sweep(gen)
    for which, row in rows.items():
        results[f"flash_attention_{which}"] = dict(
            name=f"flash_attention_{which}", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:86", **row,
            cases=[row, danube[which], *encdec[which]])
    results.update(_flash_train_kernels(gen))
    results.update(_reorder_kernels(gen))
    torch.cuda.synchronize()
    return results


def _gmm_case(label, lhs, rhs, force=None, got=None, want=None,
              against="the plain gmm", iters: int = 5):
    """One gmm row: the variant the call takes (or ``force``), the kernel
    against its plain version (or ``got`` against ``want``), and the
    kernel, the plain version, ``torch.bmm`` and the bound timed on these
    operands."""
    from repro_torch.kernels.moe_gmm import (_check, grouped_matmul,
                                             grouped_matmul_plain, variant)
    E, C, K = lhs.shape
    N = rhs.shape[2]
    layouts = _check(lhs, rhs)
    which = force or variant(E, C, K, N, lhs.dtype, layouts)
    what = (f"{label} ({E},{C},{K})x({E},{K},{N}) {layouts} bf16 "
            f"[{which}]")
    if got is None:
        got, want = grouped_matmul(lhs, rhs, force=force), \
            grouped_matmul_plain(lhs, rhs)
    err = compare(what, got, want, TOL[torch.bfloat16])
    differ = float((got != want).float().mean())
    b_ms, b_by = bound(2 * (lhs.numel() + rhs.numel() + E * C * N),
                       2 * E * C * K * N)
    row = {"shape": what, "variant": which, "max_abs_err": err,
           "share_differing": differ,
           "ms": cuda_ms(lambda: grouped_matmul(lhs, rhs, force=force),
                         iters),
           "plain_ms": cuda_ms(lambda: grouped_matmul_plain(lhs, rhs),
                               iters),
           "library_ms": cuda_ms(lambda: torch.bmm(lhs, rhs), iters),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"[kernels] {what}: max_abs_err {err:.3g} (against {against}; "
        f"{100 * differ:.3f}% of outputs differ), "
        f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
        f"torch.bmm {row['library_ms']:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by})")
    return row


def _grok_gmm_cases(gen) -> list:
    """grok-1's expert FFN products (E = 8, D 6144, F 32768) at the
    capacities of [archs]: its prefill (B=2, S=2048: C = 1280) and its
    decode ticks (4 slots: C = 4); w1/w3 and w2, as _gmm_case times them.
    One layer's rhs has 1.61e9 of the 2^31 elements the kernel indexes."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import _capacity
    cfg = get_config(GROK)
    _, B, S, _ = ARCHS[GROK]
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    cases = []
    for label, C in (("grok prefill", _capacity(cfg, B * S, E)),
                     ("grok decode", _capacity(cfg, 4, E))):
        for K, N in ((D, F_), (F_, D)):
            a, b = _randn(gen, E, C, K), _randn(gen, E, K, N)
            cases.append(_gmm_case(f"gmm {label}", a, b))
            del a, b
    return cases


def _jamba_geometry() -> dict:
    """jamba-v0.1-52b's expert FFN: its config and the capacities of
    [recurrent]'s prefill (B*S tokens) and decode ticks (4 slots),
    [train_recurrent]'s step, and fault F3's 65 536-token prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import _capacity
    cfg = get_config(JAMBA)
    E = cfg.n_experts
    B, S = TRAIN_RECURRENT
    return dict(cfg=cfg, prefill=_capacity(cfg, RECURRENT_B * RECURRENT_S, E),
                decode=_capacity(cfg, 4, E), train=_capacity(cfg, B * S, E),
                f3=_capacity(cfg, F3_TOKENS, E))


def _jamba_gmm_cases(gen) -> list:
    """jamba's expert FFN products (E = 16, D 4096, F 14336): w1/w3 and
    w2 at [recurrent]'s prefill (C = 640) and decode (C = 4), and fault
    F3's rows, whose outputs or operands pass 2^31 elements: w1, w2 and
    the backward's drhs of w1 at C = 10240 (a 65 536-token prefill), each
    against its plain version (f32 sums: up to 16 GB of temporaries),
    timed over 2 calls."""
    g = _jamba_geometry()
    cfg = g["cfg"]
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    cases = []
    for label, C in (("jamba prefill", g["prefill"]),
                     ("jamba decode", g["decode"])):
        for K, N in ((D, F_), (F_, D)):
            a, b = _randn(gen, E, C, K), _randn(gen, E, K, N)
            cases.append(_gmm_case(f"gmm {label}", a, b))
            del a, b
    C = g["f3"]
    for K, N in ((D, F_), (F_, D)):
        a, b = _randn(gen, E, C, K), _randn(gen, E, K, N)
        cases.append(_gmm_case(f"gmm F3 past 2^31 ({E * C * F_:.3g} "
                               f"elements)", a, b, iters=2))
        if K == D:        # drhs of w1 = gmm(lhs^T, dout): dout (E, C, F)
            del b
            d = _randn(gen, E, C, F_)
            cases.append(_gmm_case(
                f"gmm F3 backward drhs of w1 ({E * C * F_:.3g} elements)",
                a.transpose(1, 2), d, iters=2))
            del d
        del a
        torch.cuda.empty_cache()
    return cases


def _gmm_sweep(gen):
    """The CPU sweep's shapes (incl. the non-divisible (16,4,12,20)),
    ragged edges of every tile shape and aligned shapes that reach each
    variant's edges, in both dtypes and all four operand layouts: the
    variant each takes, and for bf16 the SIMT variant as well, against
    the plain version."""
    from repro_torch.kernels.moe_gmm import (VARIANTS, _check,
                                             grouped_matmul,
                                             grouped_matmul_plain, variant)
    taken = dict.fromkeys(VARIANTS, 0)
    for dtype in (torch.float32, torch.bfloat16):
        for E, C, K, N in ((4, 16, 32, 24), (2, 128, 64, 128), (8, 8, 8, 8),
                           (1, 256, 128, 64), (16, 4, 12, 20),
                           (3, 9, 33, 130), (2, 130, 17, 129), (5, 7, 300, 3),
                           (3, 200, 136, 264), (2, 640, 512, 520),
                           (3, 4, 136, 264), (2, 1, 8, 8), (16, 13, 512, 640),
                           (2, 24, 72, 8)):
            for lm, rm in (("k", "mn"), ("k", "k"), ("mn", "mn"),
                           ("mn", "k")):
                a = _randn(gen, E, C, K, dtype=dtype) if lm == "k" else \
                    _randn(gen, E, K, C, dtype=dtype).transpose(1, 2)
                b = _randn(gen, E, K, N, dtype=dtype) if rm == "mn" else \
                    _randn(gen, E, N, K, dtype=dtype).transpose(1, 2)
                which = variant(E, C, K, N, dtype, _check(a, b))
                want = grouped_matmul_plain(a, b)
                what = f"gmm ({E},{C},{K})x({E},{K},{N}) {(lm, rm)} {dtype}"
                compare(f"{what} [{which}]", grouped_matmul(a, b), want,
                        TOL[dtype])
                taken[which] += 1
                if which != "simt":
                    compare(f"{what} [simt]",
                            grouped_matmul(a, b, force="simt"), want,
                            TOL[dtype])
    log(f"[kernels] gmm sweep: 14 shapes x 4 layouts in f32 and bf16 agree "
        f"(variants taken {taken}; each bf16 call through SIMT too)")


def _gmm_tp_cases(gen) -> list:
    """The expert FFN's products at the F that tensor parallelism cuts
    (TP_SWEEP_F: F / |model| at model 2 and 4, multiples of 8 but not of
    128), at [train_tp]'s chunk rows, w1 / w3 (N = F / |model|) and w2 (K
    = F / |model|), in all four operand layouts: each through the
    variant it takes, against the plain version, timed."""
    t = _train_tp_geometry()[0]
    E, rows, D = t["E_loc"], TP_BLOCKS * t["C"] // t["n"], t["cfg"].d_model
    cases = []
    for F_ in TP_SWEEP_F:
        for K, N in ((D, F_), (F_, D)):
            for lm, rm in (("k", "mn"), ("k", "k"), ("mn", "mn"),
                           ("mn", "k")):
                a = _randn(gen, E, rows, K) if lm == "k" else \
                    _randn(gen, E, K, rows).transpose(1, 2)
                b = _randn(gen, E, K, N) if rm == "mn" else \
                    _randn(gen, E, N, K).transpose(1, 2)
                cases.append(_gmm_case(f"gmm TP F/|model|={F_}", a, b))
                del a, b
    return cases


def _gmm_backward_cases(gen):
    """``GroupedMatmulFn``'s backward at the shapes training runs it: [train]'s
    (16, 640) and [train_ep]'s and [train_tp]'s (E_loc, rows, F) from
    :func:`_path_gmm_shapes` (the tuned chunk, the factorized call, the
    Trainer's cut-width chunk; [train_tp]'s at F / |model|).  Its gradients against autograd of the
    plain gmm, and each of its two products (``dlhs = gmm(dout, rhs^T)``,
    ``drhs = gmm(lhs^T, dout)``) timed alone as the Function calls it, on
    the transposed views."""
    from repro_torch.kernels.moe_gmm import (GroupedMatmulFn,
                                             grouped_matmul_plain)
    jamba = _jamba_geometry()
    shapes = {(16, 640, 4096, 6400): ["train"],
              (16, jamba["train"], jamba["cfg"].d_model, jamba["cfg"].d_ff):
              ["train_recurrent"]}
    shapes.update({s: [lb for lb in labels if lb.startswith("train_")]
                   for s, labels in _path_gmm_shapes().items()
                   if any(lb.startswith("train_") for lb in labels)})
    rows = []
    for (E, M, D, F_), labels in shapes.items():
        for K, N in ((D, F_), (F_, D)):
            a = _randn(gen, E, M, K).requires_grad_()
            b = _randn(gen, E, K, N).requires_grad_()
            d = _randn(gen, E, M, N)
            got = torch.autograd.grad(GroupedMatmulFn.apply(a, b), (a, b),
                                      d)
            want = torch.autograd.grad(grouped_matmul_plain(a, b), (a, b),
                                       d)
            a, b = a.detach(), b.detach()
            for name, g, w, lhs, rhs in (
                    ("dlhs", got[0], want[0], d, b.transpose(1, 2)),
                    ("drhs", got[1], want[1], a.transpose(1, 2), d)):
                rows.append(_gmm_case(
                    f"gmm backward {name} ({', '.join(labels)}) of "
                    f"({E},{M},{K})x({E},{K},{N})", lhs, rhs, got=g,
                    want=w, against="autograd of the plain gmm"))
            del a, b, d, got, want
    return rows


def _pairs(S: int, causal: bool = True, window: int | None = None,
           Skv: int | None = None) -> int:
    """Unmasked (row, col) pairs of S x S self-attention (kv offset 0), or
    of S queries against all ``Skv`` rows (non-causal cross-attention)."""
    if Skv is not None and Skv != S:
        if causal or window:
            raise ValueError("pairs of Sq != Skv count non-causal calls")
        return S * Skv
    i = np.arange(S)
    hi = i + 1 if causal else np.full(S, S)
    lo = np.maximum(0, i - window + 1) if window else 0
    return int((hi - lo).sum())


def _window_sdpa(Hq: int, k, v, window: int):
    """``(mask, k, v)`` for SDPA on a causal sliding window, the library
    yardstick of a windowed flash call: a boolean (S, S) mask, and k and v
    expanded to the ``Hq`` query heads once here, outside the timed call
    (SDPA's masked kernels take no GQA)."""
    i = torch.arange(k.shape[2], device=k.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    group = Hq // k.shape[1]
    return (mask, *(t.repeat_interleave(group, 1) for t in (k, v)))


def _flash_rows(label, shape, run, plain, library, lib_name, q, k, v,
                **kw):
    """The flash rows at one shape (``kw``: the mask's options, causal or
    not, a window; Sq != Skv non-causal): the variant the call takes, then SIMT (forced), each against the plain version (out at the bf16
    tolerance, lse at f32's), timed beside the plain version, the library
    call (a yardstick only) and the bound; the taken variant run twice on
    the same inputs must agree bit for bit, and its row carries the SIMT
    ms of the same run and, with q x 100 (logits in the hundreds, softmax
    near one-hot: the regime where the wgmma variant re-sums the logits
    near each row's max), its agreement and ms.  ``run(q, k, v,
    force=...)`` and ``plain(q, k, v)`` return the output or ``(out,
    lse)``.  The bound is the function's (4 operations per unmasked (row,
    col) pair and head dim); the wgmma log line also gives the bound of
    its own work, whose P V runs once per P term (``numerics()``) over
    the head dim padded to whole 64-column boxes."""
    from repro_torch.kernels.flash_attention import choose, numerics

    def agree(what, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return max(compare(f"{what} {n}", g, w, TOL[w.dtype])
                   for n, g, w in zip(("out", "lse"), got, want))

    want = plain(q, k, v, **kw)
    B, Hq, S, Dh = q.shape
    n_bytes = 2 * (2 * q.numel() + 2 * k.numel()) \
        + 4 * (B * Hq * S if isinstance(want, tuple) else 0)
    pairs = _pairs(S, Skv=k.shape[2], **kw)
    flops = 4 * B * Hq * Dh * pairs
    b_ms, b_by = bound(n_bytes, flops)
    plain_ms = cuda_ms(lambda: plain(q, k, v, **kw))
    lib_ms = cuda_ms(lambda: library(q, k, v))
    taken = choose(q, k, v)
    rows = {}
    for which in dict.fromkeys((taken, "simt")):
        what = f"{label} {shape} [{which}]"
        got = run(q, k, v, force=which, **kw)
        err = agree(what, got, want)
        if which == taken:
            again = run(q, k, v, force=which, **kw)
            got, again = ((x if isinstance(x, tuple) else (x,))
                          for x in (got, again))
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"{what}: two runs on the same inputs differ")
        del got
        rows[which] = {"shape": what, "variant": which, "max_abs_err": err,
                       "ms": cuda_ms(lambda: run(q, k, v, force=which,
                                                 **kw)),
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
    row = rows[taken]
    row["simt_ms"] = rows["simt"]["ms"]
    q100 = q * 100
    row["q_x100_max_abs_err"] = agree(f"{label} {shape} q x100 [{taken}]",
                                      run(q100, k, v, **kw),
                                      plain(q100, k, v, **kw))
    row["q_x100_ms"] = cuda_ms(lambda: run(q100, k, v, **kw))
    del q100
    for which, r in rows.items():
        own = ""
        if which == "wgmma":
            parts, tile = numerics()["p_parts"], -(-Dh // 64) * 64
            own_flops = 2 * B * Hq * pairs * (Dh + tile * parts)
            own = (f"; its own work with P in {parts} bf16 terms "
                   f"{bound(n_bytes, own_flops)[0]:.4f} ms")
        extra = (f"; two runs equal bit for bit; q x100 (near one-hot): "
                 f"max_abs_err {r['q_x100_max_abs_err']:.3g}, kernel "
                 f"{r['q_x100_ms']:.3f} ms" if which == taken else "")
        log(f"[kernels] {r['shape']}: max_abs_err {r['max_abs_err']:.3g}, "
            f"kernel {r['ms']:.3f} ms, plain {plain_ms:.3f} ms, {lib_name} "
            f"{lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}{own}){extra}")
    return rows


def _danube_flash_rows(gen) -> dict:
    """The serving flash rows at h2o-danube-1.8b's prefill in [archs]
    (B=1, S=8192, 32 / 8 heads, head dim 80, causal, window 4096: the
    wgmma variant's 128-column tile with columns 80..127 zero-filled),
    SDPA with the window as a mask the yardstick."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    F = torch.nn.functional
    cfg = get_config(DANUBE)
    _, B, S, _ = ARCHS[DANUBE]
    Hq, Hkv, Dh, W = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window
    q = _randn(gen, B, Hq, S, Dh)
    k, v = _randn(gen, B, Hkv, S, Dh), _randn(gen, B, Hkv, S, Dh)
    mask, ke, ve = _window_sdpa(Hq, k, v, W)
    shape = (f"q({B},{Hq},{S},{Dh}) kv({B},{Hkv},{S},{Dh}) causal window "
             f"{W} bf16 ({DANUBE})")
    rows = _flash_rows(
        "flash", shape, flash_attention, flash_attention_plain,
        lambda q, k, v: F.scaled_dot_product_attention(q, ke, ve,
                                                       attn_mask=mask),
        "sdpa (window mask, kv expanded)", q, k, v, causal=True, window=W)
    del q, k, v, ke, ve, mask
    torch.cuda.empty_cache()
    return rows


def _encdec_flash_rows(gen) -> dict:
    """The serving flash rows at this slice's shapes: whisper-tiny's
    encoder (q (4, 6, 1500, 64), non-causal: 1500 is no multiple of the kv
    tile), its prefill's cross-attention (448 decoder rows against the
    1500 memory rows) and a decode tick's (one query row against them),
    and internvl2-2b's prefill (GQA 16 / 8, head dim 128, 256 patch + 2048
    text positions, causal); SDPA the yardstick.  Returns variant -> rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    F = torch.nn.functional
    w, vl = get_config(WHISPER), get_config(INTERNVL)
    frames = w.n_frontend_tokens
    cases = [((ENCDEC_B, w.n_heads, w.n_kv_heads, frames, frames, w.hd),
              False, f"{WHISPER} encoder"),
             ((ENCDEC_B, w.n_heads, w.n_kv_heads, ENCDEC_S, frames, w.hd),
              False, f"{WHISPER} cross-attention"),
             ((ENCDEC_B, w.n_heads, w.n_kv_heads, 1, frames, w.hd), False,
              f"{WHISPER} decode tick's cross-attention"),
             ((ARCHS[INTERNVL][1], vl.n_heads, vl.n_kv_heads,
               ARCHS[INTERNVL][2] + vl.n_frontend_tokens,
               ARCHS[INTERNVL][2] + vl.n_frontend_tokens, vl.hd), True,
              f"{INTERNVL} prefill")]
    out = {}
    for (B, Hq, Hkv, Sq, Skv, Dh), causal, label in cases:
        q = _randn(gen, B, Hq, Sq, Dh)
        k, v = _randn(gen, B, Hkv, Skv, Dh), _randn(gen, B, Hkv, Skv, Dh)
        shape = (f"q({B},{Hq},{Sq},{Dh}) kv({B},{Hkv},{Skv},{Dh}) "
                 f"{'causal' if causal else 'non-causal'} bf16 ({label})")
        rows = _flash_rows(
            "flash", shape, flash_attention, flash_attention_plain,
            lambda q, k, v, c=causal: F.scaled_dot_product_attention(
                q, k, v, is_causal=c, enable_gqa=True), "sdpa", q, k, v,
            causal=causal)
        for which, row in rows.items():
            out.setdefault(which, []).append(row)
        del q, k, v
    torch.cuda.empty_cache()
    return out


_FLASH_SWEEP = tuple(
    [((Bb, Hq_, Hk_, Ss, Ss, D), dict(causal=c))
     for Bb, Hq_, Hk_, Ss, D in ((1, 2, 2, 64, 32), (2, 4, 2, 32, 16),
                                 (1, 4, 1, 64, 32), (1, 8, 8, 128, 64),
                                 (2, 6, 3, 48, 64), (1, 4, 2, 100, 128))
     for c in (True, False)]
    + [((1, 2, 2, 64, 64, 32), dict(causal=True, window=w))
       for w in (1, 8, 16, 64)]
    + [((1, 2, 2, 8, 64, 32), dict(causal=True, kv_offset=56)),
       ((1, 4, 2, 37, 77, 64), dict(causal=False)),
       ((1, 4, 2, 37, 77, 64), dict(causal=True, kv_offset=40)),
       ((2, 4, 4, 150, 150, 16), dict(causal=False, window=20)),
       ((1, 2, 1, 16, 16, 16), dict(causal=True, kv_offset=-4)),
       ((1, 2, 1, 40, 40, 64), dict(causal=True, kv_offset=-4)),
       ((1, 4, 2, 300, 300, 128), dict(causal=True, window=100)),
       # head dim 80 (h2o-danube): GQA, a window, ragged S, a kv offset
       ((1, 4, 2, 160, 160, 80), dict(causal=True, window=40)),
       ((1, 4, 2, 37, 77, 80), dict(causal=True, kv_offset=40)),
       ((2, 6, 3, 48, 48, 80), dict(causal=False)),
       # logits |x| of hundreds, softmax near one-hot: the wgmma variant
       # re-sums the logits near each row's max in FMA order
       ((1, 4, 2, 256, 256, 128), dict(causal=True, q_scale=100.0)),
       ((1, 4, 2, 200, 200, 64), dict(causal=False, q_scale=100.0))])


def _flash_sweep(gen):
    """The CPU sweep's shapes (GQA, causal, windows, kv offsets, ragged S,
    Dh 16-128 (80 too), fully masked rows) in f32 and bf16: the serving forward
    through the variant each takes and, where that is not SIMT, through
    SIMT too, against the plain version."""
    from repro_torch.kernels.flash_attention import (VARIANTS, choose,
                                                     flash_attention,
                                                     flash_attention_plain)
    taken = dict.fromkeys(VARIANTS, 0)
    for dtype in (torch.float32, torch.bfloat16):
        for (Bb, Hq_, Hk_, Sq, Sk, D), kw in _FLASH_SWEEP:
            kw = dict(kw)
            q_scale = kw.pop("q_scale", 1.0)
            q = _randn(gen, Bb, Hq_, Sq, D, dtype=dtype) * q_scale
            k = _randn(gen, Bb, Hk_, Sk, D, dtype=dtype)
            v = _randn(gen, Bb, Hk_, Sk, D, dtype=dtype)
            which = choose(q, k, v)
            taken[which] += 1
            want = flash_attention_plain(q, k, v, **kw)
            for force in dict.fromkeys((which, "simt")):
                compare(f"flash q{(Bb, Hq_, Sq, D)} kv{(Bb, Hk_, Sk, D)} "
                        f"{kw} q x{q_scale:g} {dtype} [{force}]",
                        flash_attention(q, k, v, force=force, **kw), want,
                        TOL[dtype])
    log(f"[kernels] flash sweep: {len(_FLASH_SWEEP)} cases in f32 and bf16 "
        f"(GQA, causal, windows, kv offsets, ragged S, Dh 16-128 and 80, "
        f"fully "
        f"masked rows, near one-hot softmaxes) agree (variants taken "
        f"{taken}; each wgmma case through SIMT too)")


# the backward's sweep: GQA, causal, windows, kv offsets (+ and -),
# ragged S, Dh 16-128 and 80, fully masked rows, a near one-hot softmax
_FLASH_BWD_SWEEP = (
    ((1, 2, 2, 64, 64, 32), dict(causal=True)),
    ((2, 4, 2, 32, 32, 16), dict(causal=True)),
    ((1, 4, 1, 64, 64, 32), dict(causal=False)),
    ((2, 6, 3, 48, 48, 64), dict(causal=False)),
    ((1, 4, 2, 100, 100, 128), dict(causal=True)),
    ((1, 2, 2, 64, 64, 32), dict(causal=True, window=8)),
    ((1, 2, 2, 8, 64, 32), dict(causal=True, kv_offset=56)),
    ((1, 4, 2, 37, 77, 64), dict(causal=True, kv_offset=40)),
    ((2, 4, 4, 150, 150, 16), dict(causal=False, window=20)),
    ((1, 2, 1, 16, 16, 16), dict(causal=True, kv_offset=-4)),
    ((1, 2, 1, 40, 40, 128), dict(causal=True, kv_offset=-4)),
    ((1, 4, 2, 130, 200, 128), dict(causal=True, window=50, kv_offset=70)),
    ((1, 4, 2, 160, 160, 80), dict(causal=True, window=40)),
    ((1, 4, 2, 37, 77, 80), dict(causal=True, kv_offset=40)),
    ((1, 4, 2, 256, 256, 128), dict(causal=True, q_scale=100.0)))


def _flash_train_shapes() -> list:
    """The training paths' attention shapes, ``(B, Hq, Hkv, S, Dh, label,
    window, causal, Skv)``: [train]'s first (the JSON line's main rows),
    [train_ep]'s per rank at full and at the Trainer's cut width,
    [train_tp]'s per rank (this rank's heads), [train_danube]'s (head dim
    80, its window) and [train_encdec]'s whisper encoder and
    cross-attention (non-causal, 448 queries against 1500 frames)."""
    from repro_torch.configs import get_config
    shapes = [(TRAIN_B, 32, 8, TRAIN_S, 128, "train", None, True, None)]
    for t in _train_ep_geometry():
        c = t["cfg"]
        shapes.append((1, c.n_heads, c.n_kv_heads, TRAIN_EP_S,
                       c.d_model // c.n_heads, t["label"], None, True, None))
    for t in _train_tp_geometry():
        shapes.append((1, t["Hq"], t["Hkv"], TRAIN_EP_S, t["cfg"].hd,
                       t["label"], None, True, None))
    dcfg = get_config(DANUBE)
    shapes.append((TRAIN_DANUBE[1], dcfg.n_heads, dcfg.n_kv_heads,
                   TRAIN_DANUBE[2], dcfg.hd, "train_danube", dcfg.window,
                   True, None))
    wcfg = get_config(WHISPER)
    frames = wcfg.n_frontend_tokens
    shapes.append((ENCDEC_B, wcfg.n_heads, wcfg.n_kv_heads, frames, wcfg.hd,
                   f"train_encdec {WHISPER} encoder", None, False, None))
    shapes.append((ENCDEC_B, wcfg.n_heads, wcfg.n_kv_heads, ENCDEC_S,
                   wcfg.hd, f"train_encdec {WHISPER} cross-attention", None,
                   False, frames))
    return shapes


def _bwd_variants(q, k, v, do) -> tuple:
    """The backward variants a call is checked through: the one it takes
    and, where that is wgmma, mma (forced) too."""
    from repro_torch.kernels.flash_attention_bwd import choose
    return tuple(dict.fromkeys((choose(q, k, v, others=(do,)), "mma"))) \
        if q.dtype == torch.bfloat16 else ("simt",)


def _flash_train_kernels(gen):
    """The flash forward that keeps lse and the FA2 backward against their
    plain versions: at every training shape (:func:`_flash_train_shapes`;
    each forward variant as :func:`_flash_rows` times it, and the
    backward's wgmma and mma variants, each held within ``tol`` of the
    largest |value| of each output, run twice bit for bit and timed, with
    SDPA's forward and backward as the library yardstick) and at the
    sweep's GQA / window / kv-offset / ragged shapes in f32 and bf16
    (:data:`_FLASH_BWD_SWEEP`), the forward through the variant it takes
    and, for wgmma, SIMT too, the backward through the variant it takes
    and, for wgmma, mma too.  lse is f32 (tolerance 1e-4); the bf16
    backward rounds p and ds to bf16 as they enter the tensor cores and
    dk / dv sum the group's query heads, hence the tolerance of the
    largest |value|."""
    from repro_torch.kernels.flash_attention import VARIANTS, choose
    from repro_torch.kernels.flash_attention_bwd import (
        VARIANTS_BWD, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd, flash_attention_fwd_plain)
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    taken = dict.fromkeys(VARIANTS, 0)
    taken_bwd = dict.fromkeys(VARIANTS_BWD, 0)

    def check(label, q, k, v, do, **kw):
        """Forward variants and backward variants against the plain
        versions; returns ``{variant: (max_abs_err, rel_norm_errs)}`` of
        the backward."""
        out_p, lse_p = flash_attention_fwd_plain(q, k, v, **kw)
        which = choose(q, k, v)
        taken[which] += 1
        for force in dict.fromkeys((which, "simt")):
            out, lse = flash_attention_fwd(q, k, v, force=force, **kw)
            compare(f"{label} [{force}] out", out, out_p, TOL[q.dtype])
            compare(f"{label} [{force}] lse", lse, lse_p, TOL[f32])
        want = flash_attention_bwd_plain(q, k, v, out_p, lse_p, do, **kw)
        errs = {}
        for i, force in enumerate(_bwd_variants(q, k, v, do)):
            taken_bwd[force] += i == 0
            got = flash_attention_bwd(q, k, v, out_p, lse_p, do,
                                      force=force, **kw)
            err = max(compare(f"{label} [{force}] d{n}", g, w, TOL[q.dtype],
                              of_max=True)
                      for n, g, w in zip("qkv", got, want))
            rel = [float((g.float() - w.float()).norm() / w.float().norm())
                   for g, w in zip(got, want)]
            errs[force] = (err, rel)
        return errs

    def shape_rows(B, Hq, Hkv, S, Dh, label, window=None, causal=True,
                   Skv=None):
        """The forward's rows (:func:`_flash_rows`) and the backward's
        (wgmma and mma) at one training shape (with ``window``: the
        library yardstick SDPA with the window as a mask, k and v
        expanded; ``Skv``: kv rows of a non-causal cross-attention, else
        S)."""
        Skv = Skv or S
        q, do = _randn(gen, B, Hq, S, Dh), _randn(gen, B, Hq, S, Dh)
        k, v = _randn(gen, B, Hkv, Skv, Dh), _randn(gen, B, Hkv, Skv, Dh)
        kw = dict(causal=causal, window=window)
        shape = (f"q({B},{Hq},{S},{Dh}) kv({B},{Hkv},{Skv},{Dh}) "
                 f"{'causal' if causal else 'non-causal'}"
                 f"{f' window {window}' if window else ''} bf16 ({label})")
        if window is None:
            lib_k, lib_v, lib_kw = k, v, dict(is_causal=causal,
                                              enable_gqa=True)
        else:
            mask, lib_k, lib_v = _window_sdpa(Hq, k, v, window)
            lib_kw = dict(attn_mask=mask)
        fwd = _flash_rows(
            "flash fwd+lse", shape, flash_attention_fwd,
            flash_attention_fwd_plain,
            lambda q, k, v: F.scaled_dot_product_attention(
                q, lib_k, lib_v, **lib_kw), "sdpa forward", q, k, v, **kw)
        errs = check(f"flash train {shape}", q, k, v, do, **kw)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        pairs = _pairs(S, Skv=Skv, **kw)
        bb_ms, bb_by = bound(2 * (4 * q.numel() + 4 * k.numel())
                             + 4 * lse.numel(), 10 * B * Hq * Dh * pairs)
        plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do, **kw))
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, lib_k, lib_v))
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, **lib_kw)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            o_lib, (qs, ks, vs), do, retain_graph=True))
        del qs, ks, vs, o_lib
        bwd = {}
        for which in errs:
            runs = [flash_attention_bwd(q, k, v, out, lse, do, force=which,
                                        **kw) for _ in range(2)]
            if not all(torch.equal(x, y) for x, y in zip(*runs)):
                fail(f"flash bwd {shape} [{which}]: two runs on the same "
                     f"inputs differ")
            del runs
            bwd[which] = {"shape": f"flash bwd {shape}", "variant": which,
                          "max_abs_err": errs[which][0],
                          "rel_norm_err": errs[which][1],
                          "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": bb_ms, "bound_by": bb_by}
        # alternate the variants' timings (w, m, m, w) on the one card
        order = list(bwd) + list(bwd)[::-1]
        times = {which: [] for which in bwd}
        for which in order:
            times[which].append(cuda_ms(lambda: flash_attention_bwd(
                q, k, v, out, lse, do, force=which, **kw)))
        for which, row in bwd.items():
            row["ms"] = sum(times[which]) / len(times[which])
            row["ms_runs"] = times[which]
            log(f"[kernels] flash bwd {shape} [{which}]: max_abs_err "
                f"{row['max_abs_err']:.3g}, relative norm error dq/dk/dv "
                f"{', '.join(f'{r:.2e}' for r in row['rel_norm_err'])}, two "
                f"runs equal bit for bit, kernel {row['ms']:.3f} ms ("
                f"{', '.join(f'{t:.3f}' for t in times[which])}), plain "
                f"{plain_ms:.3f} ms, sdpa backward {lib_ms:.3f} ms, bound "
                f"{bb_ms:.3f} ms ({bb_by})")
        del q, k, v, do, out, lse
        return fwd, bwd

    by_shape = [shape_rows(*sh) for sh in _flash_train_shapes()]
    torch.cuda.empty_cache()
    fwd, bwd = by_shape[0]
    n = 0
    for dtype in (f32, bf16):
        for (Bb, Hq_, Hk_, Sq, Sk, D), kw in _FLASH_BWD_SWEEP:
            kw = dict(kw)
            q_scale = kw.pop("q_scale", 1.0)
            check(f"flash train q{(Bb, Hq_, Sq, D)} kv{(Bb, Hk_, Sk, D)} "
                  f"{kw} q x{q_scale:g} {dtype}",
                  _randn(gen, Bb, Hq_, Sq, D, dtype=dtype) * q_scale,
                  _randn(gen, Bb, Hk_, Sk, D, dtype=dtype),
                  _randn(gen, Bb, Hk_, Sk, D, dtype=dtype),
                  _randn(gen, Bb, Hq_, Sq, D, dtype=dtype), **kw)
            n += 1
    log(f"[kernels] flash fwd+lse / bwd sweep: {n} cases (GQA, causal, "
        f"windows, kv offsets, ragged S, Dh 16-128 and 80, fully masked "
        f"rows, a near one-hot softmax) agree (forward variants taken "
        f"{taken}, backward variants taken {taken_bwd}, the training "
        f"shapes included; each wgmma case through SIMT (forward) and mma "
        f"(backward) too)")
    out = {f"flash_attention_fwd_{which}": dict(
        name=f"flash_attention_fwd_{which}", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention_bwd.py:83", **row,
        cases=[f[which] for f, _ in by_shape])
        for which, row in fwd.items()}
    for which, row in bwd.items():
        out[f"flash_attention_bwd_{which}"] = dict(
            name=f"flash_attention_bwd_{which}", route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/flash_attention_bwd.py:205", **row,
            cases=[b[which] for _, b in by_shape if which in b])
    return out


def _abs_err(got, want) -> float:
    """max |got - want| (in f64, exact for int32 and every float dtype;
    complex in complex128)."""
    if not got.numel():
        return 0.0
    wide = torch.complex128 if got.is_complex() else torch.float64
    return float((got.to(wide) - want.to(wide)).abs().max())


def _reorder_input(gen, dims, B, dtype):
    p = math.prod(dims)
    if dtype.is_complex:
        return torch.randn((p, B), generator=gen, device=DEVICE,
                           dtype=dtype)
    if dtype.is_floating_point:
        return _randn(gen, p, B, dtype=dtype)
    return torch.randint(-2**31, 2**31 - 1, (p, B), generator=gen,
                         device=DEVICE, dtype=torch.int64).to(dtype)


def _reorder_case(gen, dims, B, dtype, label=""):
    """Pack, unpack and the fused pass of a (p, B) buffer on the torus
    ``dims``: every round, every ordered pair of rounds and both variants
    must equal the plain versions bit for bit (pure data movement:
    tolerance 0; the error is computed only to report a failure)."""
    from repro_torch.kernels.block_reorder import (
        VARIANTS, datatype_pack, datatype_pack_plain, datatype_repack,
        datatype_repack_plain, datatype_unpack, datatype_unpack_plain)
    x = _reorder_input(gen, dims, B, dtype)
    what = f"reorder dims {dims} B={B} {dtype}{label}"

    def same(op, got, want):
        if not torch.equal(got, want):
            fail(f"{what}: {op} differs from its plain version by up to "
                 f"{_abs_err(got, want):.3g}")

    for v in VARIANTS:
        for k in range(len(dims)):
            y = datatype_pack(x, dims=dims, k=k, variant=v)
            same(f"pack round {k} ({v})", y,
                 datatype_pack_plain(x, dims=dims, k=k, variant=v))
            u = datatype_unpack(y, dims=dims, k=k, variant=v)
            same(f"unpack round {k} ({v})", u,
                 datatype_unpack_plain(y, dims=dims, k=k, variant=v))
            same(f"unpack(pack) round {k} ({v})", u, x)
        for ku in range(len(dims)):
            for kp in range(len(dims)):
                kw = dict(dims=dims, k_unpack=ku, k_pack=kp, variant=v)
                same(f"repack ({ku} -> {kp}, {v})", datatype_repack(x, **kw),
                     datatype_repack_plain(x, **kw))


def _host_us(fn, iters: int = 200) -> float:
    """Host µs per call of ``fn`` enqueued back to back (no synchronise
    inside: the wrapper's own work plus the launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / iters / 1e3


def _kernel_us(fn, iters: int = 20) -> float:
    """Device µs per call of the block-reorder kernel alone, from the
    profiler's kernel time (no launch gaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and "row_map" in ev.key)
    return us / iters


def _reorder_timed(gen, dims, B, dtype, label):
    """Time every pass a (2,2) forward (rounds 0, 1) and reverse (1, 0)
    call makes (``round_schedule``), natural variant, against the bound,
    the plain version and ``index_select`` with the same row map; the
    rows and the reorder device time of one call each way."""
    from repro_torch.core.factorized import round_schedule
    from repro_torch.kernels.block_reorder import row_map
    from repro_torch.kernels import ops
    x = _reorder_input(gen, dims, B, dtype)
    what = f"reorder dims {dims} B={B} {dtype}{label}"
    b_ms, b_by = bound(2 * x.numel() * x.element_size(), 0)
    small = x.numel() * x.element_size() <= 2**20
    rows, per_call = {}, {}
    for order in ((0, 1), (1, 0)):
        per_call[order] = 0.0
        for ku, kp in round_schedule(dims, order, "natural"):
            if (ku, kp) not in rows:
                op = ("pack" if ku is None else "unpack" if kp is None
                      else "repack")
                idx = torch.tensor(row_map(dims, ku, kp, "natural"),
                                   device=DEVICE)
                if op == "pack":
                    run = functools.partial(ops.pack_round, x, dims, kp,
                                            variant="natural")
                elif op == "unpack":
                    run = functools.partial(ops.unpack_round, x, dims, ku,
                                            variant="natural")
                else:
                    run = functools.partial(ops.repack_round, x, dims, ku,
                                            kp, variant="natural")
                with ops.plain_versions():
                    want = run()
                    plain_ms = cuda_ms(run)
                got = run()
                if not torch.equal(got, want):
                    fail(f"{what}: {op} {(ku, kp)} differs from its plain "
                         f"version")
                row = {"shape": f"{what} {op} {(ku, kp)}", "op": op,
                       "pass": [ku, kp], "max_abs_err": _abs_err(got, want),
                       "ms": cuda_ms(run), "plain_ms": plain_ms,
                       "library_ms": cuda_ms(
                           lambda: torch.index_select(x, 0, idx)),
                       "bound_ms": b_ms, "bound_by": b_by}
                if small:
                    row["host_us"] = _host_us(run)
                    row["kernel_us"] = _kernel_us(run)
                rows[(ku, kp)] = row
                log(f"[kernels] {row['shape']}: {row['ms']:.4f} ms (plain "
                    f"{plain_ms:.4f}, index_select {row['library_ms']:.4f}"
                    f"); bound {b_ms:.4f} ms ({100 * b_ms / row['ms']:.0f}%)"
                    + (f"; host {row['host_us']:.1f} us a call, kernel "
                       f"{row['kernel_us']:.2f} us (profiler), events "
                       f"{1e3 * row['ms']:.1f} us" if small else ""))
            per_call[order] += rows[(ku, kp)]["ms"]
    log(f"[kernels] {what}: reorder device time of one all-to-all, "
        f"forward (0,1) {per_call[(0, 1)]:.4f} ms, reverse (1,0) "
        f"{per_call[(1, 0)]:.4f} ms ({len(round_schedule(dims))} passes "
        f"each)")
    return list(rows.values())


def _ep_geometry() -> dict:
    """What phases 8 and 9 run per rank, from the same constants and
    config and from the plans they resolve (from the dims alone: the same
    resolution): experts per rank, [moe_ep]'s capacity, tuned plan and
    chunk count, and [moe_dropless]'s capacity and plan."""
    from repro_torch.models.moe import (_capacity, moe_a2a_plan,
                                        moe_dropless_a2a_plan)
    cfg, axes = _ep_config(), ("data", "pod")
    E_loc = cfg.n_experts // WORLD
    C = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, WORLD))
    plan = moe_a2a_plan(cfg, (2, 2), axes, E_loc, C)
    dcfg = _ep_config(capacity_factor=None)
    Cd = _capacity(dcfg, EP_TOKENS, max(dcfg.n_experts, WORLD))
    return dict(cfg=cfg, E_loc=E_loc, C=C, plan=plan,
                n=_n_chunks(C, plan.n_chunks), Cd=Cd,
                dplan=moe_dropless_a2a_plan(dcfg, (2, 2), axes, E_loc, Cd,
                                            EP_TOKENS))


def _grok_ep_geometry() -> dict:
    """What grok-1's layer in [moe_ep] runs per rank (from the dims
    alone, as :func:`_ep_geometry`): experts per rank, the capacity, the
    tuned plan and its chunk count."""
    from repro_torch.models.moe import _capacity, moe_a2a_plan
    cfg = _ep_config(GROK)
    E_loc = cfg.n_experts // WORLD
    C = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, WORLD))
    plan = moe_a2a_plan(cfg, (2, 2), ("data", "pod"), E_loc, C)
    return dict(cfg=cfg, E_loc=E_loc, C=C, plan=plan,
                n=_n_chunks(C, plan.n_chunks))


def _train_ep_geometry() -> list:
    """What [train_ep] runs per rank, from the same constants and config
    and the plans they resolve (from the dims alone): for the full width
    and for the Trainer's cut width, the config, experts per rank, the
    capacity, the tuned plan and its chunk count."""
    from repro_torch.models.moe import _capacity, moe_a2a_plan
    out = []
    for label, cfg in (("train_ep", _train_ep_config()),
                       ("train_ep cut", _train_ep_config(**TRAIN_EP_CUT))):
        E_loc = cfg.n_experts // WORLD
        C = _capacity(cfg, TRAIN_EP_S, max(cfg.n_experts, WORLD))
        plan = moe_a2a_plan(cfg, (2, 2), ("data", "pod"), E_loc, C)
        n = _n_chunks(C, plan.n_chunks) if plan.backend == "overlap" else 1
        out.append(dict(label=label, cfg=cfg, E_loc=E_loc, C=C, plan=plan,
                        n=n))
    return out


def _train_tp_geometry() -> list:
    """What [train_tp] runs per rank on TP_MESH (EP over (data=2, pod=2),
    F and the heads over model=2), from the same constants and config and
    the plans they resolve: for the full width and the Trainer's cut
    width, the config, experts and F per rank, query / kv heads per rank,
    the capacity, the tuned plan and its chunk count."""
    from repro_torch.models.moe import _capacity, moe_a2a_plan
    M = dict(zip(TP_MESH[1], TP_MESH[0]))["model"]
    out = []
    for label, cfg in (("train_tp", _train_ep_config()),
                       ("train_tp cut", _train_ep_config(**TRAIN_EP_CUT))):
        E_loc = cfg.n_experts // TP_BLOCKS
        C = _capacity(cfg, TRAIN_EP_S, max(cfg.n_experts, TP_BLOCKS))
        plan = moe_a2a_plan(cfg, (2, 2), ("data", "pod"), E_loc, C)
        n = _n_chunks(C, plan.n_chunks) if plan.backend == "overlap" else 1
        out.append(dict(label=label, cfg=cfg, E_loc=E_loc, C=C, plan=plan,
                        n=n, F=cfg.d_ff // M, Hq=cfg.n_heads // M,
                        Hkv=cfg.n_kv_heads // M))
    return out


def _path_gmm_shapes() -> dict:
    """{(E_loc, rows, D, F): labels} of the expert FFN's products in phases
    8, 9, 11 and 12: [moe_ep]'s overlap chunk (WORLD*C/n rows), its
    factorized call and the dropless window (WORLD*C rows each);
    [train_ep]'s tuned chunk and factorized call at full width, and its
    Trainer's chunk at the cut width; [train_tp]'s tuned chunk at its
    F / |model|, at full and cut width; grok-1's layer in [moe_ep]: its
    tuned chunk and its factorized call."""
    g = _ep_geometry()
    cfg, E_loc, C, n = g["cfg"], g["E_loc"], g["C"], g["n"]
    F_ = cfg.d_ff
    rows = [(E_loc, WORLD * C // n, F_, cfg, f"moe_ep {g['plan'].backend} "
             f"chunk"), (E_loc, WORLD * C, F_, cfg, "moe_ep factorized"),
            (E_loc, WORLD * g["Cd"], F_, cfg, "moe_dropless")]
    for t in _train_ep_geometry():
        rows.append((t["E_loc"], WORLD * t["C"] // t["n"], t["cfg"].d_ff,
                     t["cfg"], f"{t['label']} {t['plan'].backend} chunk"))
        if t["label"] == "train_ep":
            rows.append((t["E_loc"], WORLD * t["C"], t["cfg"].d_ff,
                         t["cfg"], "train_ep factorized"))
    for t in _train_tp_geometry():
        rows.append((t["E_loc"], TP_BLOCKS * t["C"] // t["n"], t["F"],
                     t["cfg"], f"{t['label']} {t['plan'].backend} chunk"))
    g = _grok_ep_geometry()
    rows += [(g["E_loc"], WORLD * g["C"] // g["n"], g["cfg"].d_ff, g["cfg"],
              f"grok moe_ep {g['plan'].backend} chunk"),
             (g["E_loc"], WORLD * g["C"], g["cfg"].d_ff, g["cfg"],
              "grok moe_ep factorized")]
    shapes = {}
    for E_loc_, r, f, c, label in rows:
        shapes.setdefault((E_loc_, r, c.d_model, f), []).append(label)
    return shapes


def _path_gmm_cases(gen) -> list:
    """The expert FFN's gmm rows at every :func:`_path_gmm_shapes` shape,
    w1/w3 and w2."""
    cases = []
    for (E_loc, rows, D, F_), labels in _path_gmm_shapes().items():
        for K, N in ((D, F_), (F_, D)):
            a, b = _randn(gen, E_loc, rows, K), _randn(gen, E_loc, K, N)
            cases.append(_gmm_case(f"gmm {', '.join(labels)}", a, b))
            del a, b
    return cases


def _path_reorder_cases():
    """(dims, B, dtype, label, timed) of every (p, B) buffer that phases
    6, 8, 9 and 11 pack and unpack (``_ep_geometry`` and
    ``_train_ep_geometry`` for phases 8, 9 and 11), each buffer once with
    the labels of every phase that reorders it.  The first is [moe_ep]'s
    overlap chunk, the main timed case; the EP buffers are timed."""
    g = _ep_geometry()
    cfg, E_loc, C, n, plan = g["cfg"], g["E_loc"], g["C"], g["n"], g["plan"]
    D, cd = cfg.d_model, cfg.cdtype
    cases = [((2, 2), E_loc * C // n * D, cd,
              f"moe_ep {plan.backend} chunk, C={C // n}", True),
             ((2, 2), E_loc * C * D, cd, f"moe_ep factorized, C={C}", True)]
    for t in _train_ep_geometry():
        tc = t["cfg"]
        cases.append(((2, 2), t["E_loc"] * t["C"] // t["n"] * tc.d_model,
                      tc.cdtype, f"{t['label']} {t['plan'].backend} chunk, "
                      f"C={t['C'] // t['n']}", True))
        if t["label"] == "train_ep":
            cases.append(((2, 2), t["E_loc"] * t["C"] * tc.d_model,
                          tc.cdtype, f"train_ep factorized, C={t['C']}",
                          True))
    dplan = g["dplan"]
    width = dplan.bucket * D
    if dplan.backend in ("overlap", "pipelined"):
        width //= _n_chunks(width, dplan.n_chunks)
    cases += [((2, 2), width, cd, f"moe_dropless {dplan.backend}", False),
              ((2, 2), WORLD, torch.int32, "Alltoallv counts", False)]
    bucket_row = 8 * math.prod(COLL_ROW)      # bucket of COLL_MAX_COUNT
    for dims, _ in COLL_TORI:
        cases += [(dims, COLL_B, torch.float32, "collective", False),
                  (dims, math.prod(COLL_TILED) // WORLD, torch.float32,
                   "collective, tiled", False),
                  (dims, bucket_row, torch.float32, "collective ragged",
                   False)]
        for nc in COLL_CHUNKS:
            for B in (COLL_B, math.prod(COLL_TILED) // WORLD, bucket_row):
                cases.append((dims, B // _n_chunks(B, nc), torch.float32,
                              f"collective overlap chunk, n={nc}", False))
    merged = {}
    for dims, B, dtype, label, timed in cases:
        labels, was_timed = merged.get((dims, B, dtype), ([], False))
        if label not in labels:
            labels.append(label)
        merged[(dims, B, dtype)] = (labels, was_timed or timed)
    return [(dims, B, dtype, f" ({'; '.join(labels)})", timed)
            for (dims, B, dtype), (labels, timed) in merged.items()]


def _reorder_kernels(gen):
    """Phase 2's block-reorder part: the buffers of phases 6, 8, 9 and 11
    (the main rows are [moe_ep]'s overlap chunk), the EP buffers of
    phi3.5-moe serving on a
    (2,2) torus (E_loc=4, D=4096, bf16; C=4 at decode on 4 slots, C=640
    at prefill B*S=4096), the paper's tori at the sweep of
    benchmarks/zero_copy_cost.py, (36,32), and the CPU sweep's odd
    sizes, dtypes and a misaligned base."""
    t0 = time.perf_counter()
    main, cases = None, []
    for dims_, B_, dtype_, label_, timed in _path_reorder_cases():
        _reorder_case(gen, dims_, B_, dtype_, label_)
        if timed:
            rows = _reorder_timed(gen, dims_, B_, dtype_, label_)
            main = main or rows
            cases += rows
    for B_, dtype_, label_ in (
            (4 * 640 * 4096, torch.bfloat16, " (MoE EP prefill, C=640)"),
            (4 * 4 * 4096, torch.bfloat16, " (MoE EP decode, C=4)"),
            (FFT_N ** 3 // WORLD ** 2, torch.complex64,
             " (fft (b): a rank's 512³ slab pencil, 4 x 64 MiB)")):
        _reorder_case(gen, (2, 2), B_, dtype_, label_)
        cases += _reorder_timed(gen, (2, 2), B_, dtype_, label_)
    for dims_ in ((5, 4), (2, 3, 4), (4, 3, 3, 4), (4, 4, 4)):
        for B_ in (16, 256, 4096, 65536):
            _reorder_case(gen, dims_, B_, torch.float32)
    _reorder_case(gen, (36, 32), 256, torch.float32)
    n = 0
    for dims_ in ((5, 4), (2, 3, 4), (4, 3, 3, 4), (2, 2, 2, 2), (6,),
                  (3, 2)):
        for B_ in (1, 5, 7, 9, 33):
            for dtype_ in (torch.bfloat16, torch.int32):
                _reorder_case(gen, dims_, B_, dtype_)
                n += 1
    # a base that is 2-byte aligned only (rows of 13 bf16, offset one row)
    from repro_torch.kernels.block_reorder import (
        datatype_pack, datatype_pack_plain, datatype_repack,
        datatype_repack_plain)
    buf = _randn(gen, 7, 13)
    if not torch.equal(datatype_pack(buf[1:], dims=(3, 2), k=0),
                       datatype_pack_plain(buf[1:], dims=(3, 2), k=0)):
        fail("reorder: pack of a misaligned view differs")
    kw = dict(dims=(3, 2), k_unpack=0, k_pack=1)
    if not torch.equal(datatype_repack(buf[1:], **kw),
                       datatype_repack_plain(buf[1:], **kw)):
        fail("reorder: repack of a misaligned view differs")
    log(f"[kernels] reorder sweep: {n} odd cases (bf16, int32) and a "
        f"misaligned base agree bit for bit, both variants, every round "
        f"and every ordered pair of rounds ({time.perf_counter() - t0:.1f} "
        f"s with the timings)")
    out = {}
    for name, op, line in (("datatype_pack", "pack", 56),
                           ("datatype_unpack", "unpack", 101),
                           ("datatype_repack", "repack", 56)):
        m = next(c for c in main if c["op"] == op)
        out[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/block_reorder.cu",
            replaces=f"src/repro/kernels/block_reorder.py:{line}",
            max_abs_err=m["max_abs_err"], ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m["library_ms"],
            shape=m["shape"],
            cases=[{k: c[k] for k in ("shape", "ms", "plain_ms",
                                      "library_ms", "bound_ms", "host_us",
                                      "kernel_us") if k in c}
                   for c in cases if c["op"] == op])
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------


def _counters():
    from repro_torch.kernels.block_reorder import (datatype_pack,
                                                   datatype_repack,
                                                   datatype_unpack)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd,
                                                         flash_attention_fwd)
    from repro_torch.kernels.moe_gmm import grouped_matmul
    return (grouped_matmul, flash_attention, flash_attention_fwd,
            flash_attention_bwd, datatype_pack, datatype_unpack,
            datatype_repack)


def _variant_counters():
    """The wrappers whose kernel has variants (each counted in
    ``variant_launches``)."""
    return tuple(fn for fn in _counters() if hasattr(fn, "variant_launches"))


def _reset_counts():
    for fn in _counters():
        fn.launches = 0
    for fn in _variant_counters():
        fn.variant_launches = dict.fromkeys(fn.variant_launches, 0)


def _read_counts() -> dict:
    """Launches of every kernel wrapper and of each variant
    (``grouped_matmul_<variant>``, ``flash_attention_<variant>``,
    ``flash_attention_fwd_<variant>``)."""
    return {**{fn.__name__: fn.launches for fn in _counters()},
            **{f"{fn.__name__}_{v}": n for fn in _variant_counters()
               for v, n in fn.variant_launches.items()}}


def _expected(**counts) -> dict:
    """Launch counts of every kernel: those given, 0 for the rest."""
    return {name: counts.get(name, 0) for name in _read_counts()}


@functools.cache
def _card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def _span_host_ms(fn, key: str) -> tuple[int, float]:
    """(calls, host ms) of the profiler span ``key`` in one call of
    ``fn`` under the CPU profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU and ev.key == key:
            return ev.count, ev.cpu_time_total / 1e3
    return 0, 0.0


def _layout_params(model, sharding) -> int:
    """The parameters a rank holds under ``sharding``, from the specs:
    each leaf's global size over its splits (EP, ``model``, FSDP)."""
    from repro_torch.models.common import tree_leaves
    total = 0
    for path, spec in tree_leaves(model.specs()):
        n = math.prod(spec.shape)
        if path in sharding.axes:
            n = n * sharding.E_loc // sharding.n_experts
        if path in sharding.model_axes:
            n //= sharding.tp.size
        if path in sharding.fsdp_axes:
            n //= sharding.fsdp_comm(path).p
        total += n
    return total


def _held(params, opt_state, model, sharding) -> dict:
    """What this rank holds: its parameters, the layout's count, and the
    bytes of its parameters and AdamW state."""
    from repro_torch.models.common import tree_leaves
    return {"n_params": sum(t.numel() for _, t in tree_leaves(params)),
            "layout_params": _layout_params(model, sharding),
            "state_gb": sum(t.numel() * t.element_size() for _, t in
                            tree_leaves({"p": params, "o": opt_state}))
            / 1e9}


def _check_held(phase: str, results, key: str) -> None:
    """Every rank holds the parameters its layout says."""
    for rank, r in enumerate(results):
        t = r[key]
        if t["n_params"] != t["layout_params"]:
            fail(f"[{phase}] rank {rank} holds {t['n_params']} parameters, "
                 f"its layout {t['layout_params']}")


def _host_ms(fn):
    """Host-clock ms of one call of ``fn`` that ends in a synchronise."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def prefill_tokens(cfg, B: int = 2, S: int = 2048):
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S))).to(DEVICE)


def frontend_embeds(cfg, B: int, seed: int = 4):
    """Stub frontend inputs (B, n_frontend_tokens, d_model) f32 from a
    seed (internvl2's patches, whisper's frames), as the shape cells'
    ``input_specs`` give them; None for a model without a frontend."""
    if cfg.frontend is None:
        return None
    return torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                       generator=torch.Generator(device=DEVICE)
                       .manual_seed(seed), device=DEVICE)


@contextlib.contextmanager
def _tensor_core_gmm():
    """The reference run's expert matmul on the tensor cores: inside, the
    plain version of ``ops.expert_matmul`` is ``torch.bmm`` (bf16 in, f32
    sums, bf16 out; autograd through bmm), the library's counterpart of
    the wgmma kernel.  The gmm's own plain version (``ref_gmm``) sums in
    cuBLAS's f32 FMA order, which no tensor-core product reproduces; at
    the reference init (activations O(100), every softmax near one-hot)
    that rounding difference alone moves the logits by ≈ 5% of the
    largest and every gradient leaf by 100-300%, torch.bmm's as much as
    the kernel's, so the end-to-end gates there compare with this run.
    The kernel itself is held against ``ref_gmm`` in [kernels]."""
    from repro_torch.kernels import ops
    saved = ops.grouped_matmul_plain
    ops.grouped_matmul_plain = torch.bmm
    try:
        yield
    finally:
        ops.grouped_matmul_plain = saved


def _logit_gate(what: str, out, ref, ref_name: str) -> float:
    """max |out - ref|; fails beyond 2e-2 of the largest |ref| logit."""
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    if err > 2e-2 * scale:
        fail(f"{what}: prefill logits differ from the {ref_name} run by "
             f"{err:.4g} (largest logit {scale:.4g}; limit 2e-2 of it)")
    return err


def phase_prefill(model, params, cfg, tokens):
    """The kernel path's last-position logits against (a) the plain
    versions with the expert matmul on the tensor cores
    (:func:`_tensor_core_gmm`) at the reference init, and (b) the plain
    versions as they stand at a fan-in init (:func:`_fan_in_init`: soft
    attention and routing), each within 2e-2 of the largest logit; the
    reference init's distance to the plain versions as they stand is
    logged, all before the gates."""
    from repro_torch.kernels import ops
    from repro_torch.models import make_prefill_fn
    B, S = tokens.shape
    prefill = make_prefill_fn(model)
    _reset_counts()
    out, cold_ms = _host_ms(lambda: prefill(params, tokens))
    counts = _read_counts()
    want = _expected(grouped_matmul=3 * cfg.n_layers,
                     grouped_matmul_wgmma=3 * cfg.n_layers,
                     flash_attention=cfg.n_layers,
                     flash_attention_wgmma=cfg.n_layers)
    if counts != want:
        fail(f"prefill launched {counts}, expected {want}")
    _, warm_ms = _host_ms(lambda: prefill(params, tokens))
    if out.shape != (B, cfg.vocab) or not torch.isfinite(out).all():
        fail(f"prefill logits {tuple(out.shape)} not finite (B, V)")
    with ops.plain_versions(), _tensor_core_gmm():
        ref = prefill(params, tokens)
    with ops.plain_versions():
        ref32, plain_ms = _host_ms(lambda: prefill(params, tokens))
    err = float((out - ref).abs().max())
    err32 = float((out - ref32).abs().max())
    ref_gap = float((ref - ref32).abs().max())
    same_top = bool((out.argmax(-1) == ref.argmax(-1)).all())
    soft = _fan_in_init(model, cfg, seed=1)
    with torch.no_grad():
        out_f = prefill(soft, tokens)
        with ops.plain_versions():
            ref_f = prefill(soft, tokens)
    del soft
    err_f = float((out_f - ref_f).abs().max())
    log(f"[prefill] {ARCH} x{cfg.n_layers} layers B={B} S={S}: first call "
        f"{cold_ms:.1f} ms, second {warm_ms:.1f} ms, plain versions "
        f"{plain_ms:.1f} ms (host clock); launches {counts}; reference "
        f"init: max |logit - plain with tensor-core gmm| {err:.4g} of max "
        f"|logit| {float(ref.abs().max()):.4g}, same argmax: {same_top}; "
        f"to the plain versions as they stand {err32:.4g}, where torch.bmm "
        f"in the gmm's place lies {ref_gap:.4g}; fan-in init: max |logit - "
        f"plain| {err_f:.4g} of max |logit| "
        f"{float(ref_f.abs().max()):.4g}")
    _logit_gate("reference init", out, ref, "plain (tensor-core gmm)")
    _logit_gate("fan-in init", out_f, ref_f, "plain")
    return counts


def _moe_layers(cfg) -> int:
    """The layers of ``cfg`` whose FFN is the MoE (3 gmm each a call)."""
    return cfg.n_superblocks * sum(ffn == "moe" for _, ffn in cfg.superblock)


def _attn_layers(cfg) -> int:
    """The attention calls of one full-sequence forward (one flash forward
    each): the layers of ``cfg`` whose mixer is attention, or, for the
    encoder-decoder, each encoder layer's and each decoder layer's two
    (self and cross)."""
    if cfg.encoder_layers:
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_superblocks * sum(m == "attn" for m, _ in cfg.superblock)


def phase_serve(model, params, cfg, tag: str = "serve",
                lengths: tuple = (8, 11, 13, 16), max_batch: int = 4,
                memory=None):
    """The launcher's colocated body answers a request per prompt length
    on ``max_batch`` slots (where there are more requests, a finished
    request's slot is reset and reused); every tick launches 3 gmm
    (``decode``) per MoE layer and nothing else (decode attention is
    plain torch); with an encoder-decoder's ``memory`` (one row per
    request, so ``max_batch`` requests) also one flash ``wgmma`` per
    decoder layer, the cross-attention.  Returns the launches."""
    from repro_torch.launch.serve import batcher_step, serve_colocated
    from repro_torch.models import make_serve_step
    from repro_torch.runtime.serving import Request
    rng = np.random.default_rng(2)
    gen_len = 16
    reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab, L)],
                    gen_len) for i, L in enumerate(lengths)]
    step = batcher_step(make_serve_step(model), memory)
    finite, stamps = [], []

    def checked_step(params, toks, caches):
        stamps.append(time.perf_counter())
        logits, caches = step(params, toks, caches)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    _reset_counts()
    batcher, secs = serve_colocated(
        model, params, reqs, max_batch=max_batch,
        max_seq=max(lengths) + gen_len, device=DEVICE,
        serve_step=checked_step)
    counts = _read_counts()
    ticks = batcher.ticks
    gmm = 3 * _moe_layers(cfg) * ticks
    cross = 0 if memory is None else cfg.n_layers * ticks
    want = _expected(grouped_matmul=gmm, grouped_matmul_decode=gmm,
                     flash_attention=cross, flash_attention_wgmma=cross)
    if counts != want:
        fail(f"[{tag}] serve launched {counts} in {ticks} ticks, expected "
             f"{want}")
    if sorted(batcher.done) != list(range(len(reqs))):
        fail(f"[{tag}] answered {sorted(batcher.done)} of {len(reqs)} "
             f"requests")
    for rid, toks in batcher.done.items():
        if len(toks) != gen_len or not all(0 <= t < cfg.vocab for t in toks):
            fail(f"[{tag}] request {rid}: tokens {toks} out of range or "
                 f"short")
    if not bool(torch.stack(finite).all()):
        fail(f"[{tag}] non-finite decode logits")
    tick_ms = np.diff(stamps) * 1e3
    log(f"[{tag}] {cfg.name} x{cfg.n_layers} layers: {len(reqs)} "
        f"requests on {max_batch} slots (prompts {lengths}, "
        f"{gen_len} new tokens each) in "
        f"{ticks} ticks, {secs * 1e3 / ticks:.2f} ms/tick "
        f"overall, median tick {float(np.median(tick_ms)):.2f} ms; launches "
        f"{counts}; request 0 tokens {batcher.done[0]}")
    return counts


def _profile(fn, label: str, per: int = 1, top: int = 8):
    """Run ``fn`` under torch.profiler and print the device time by
    kernel: total kernel time against the host-clock wall time (the
    device's busy share; one stream, so kernels do not overlap) and the
    largest kernels.  Returns the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = _host_ms(fn)
    # kernels only: a CPU op's entry repeats the device time of its kernels
    rows = [(ev.self_device_time_total / 1e3, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0
            and not ev.key.startswith(SPAN_PREFIX)]
    # the port's own spans (record_function), on the host's clock
    spans = [(ev.key, ev.count, ev.cpu_time_total / 1e3)
             for ev in prof.key_averages()
             if ev.device_type == DeviceType.CPU
             and ev.key.startswith(SPAN_PREFIX)]
    busy = sum(r[0] for r in rows)
    # what a caller reads back: wall and device ms, each span's count and
    # host ms, per call
    prof.summary = {"wall_ms": wall_ms / per, "busy_ms": busy / per,
                    "spans": {key: (count // per, ms / per)
                              for key, count, ms in spans}}
    if not rows:
        log(f"[profile] {label}: the profiler recorded no device time")
        return prof
    log(f"[profile] {label}: wall {wall_ms / per:.2f} ms, device busy "
        f"{busy / per:.2f} ms ({100 * busy / wall_ms:.0f}%) per call; top:")
    for ms, key, count in sorted(rows, reverse=True)[:top]:
        log(f"[profile]   {ms / per:8.3f} ms {100 * ms / busy:5.1f}% "
            f"x{count // per} {key[:90]}")
    for key, count, ms in spans:
        log(f"[profile]   span {key}: x{count // per}, {ms / per:.3f} ms "
            f"of host time per call ({100 * ms / wall_ms:.1f}% of wall)")
    return prof


def phase_profile(model, params, cfg, tokens):
    """Where the time goes: one warm prefill call and 4 warm decode
    ticks (4 slots) under the profiler."""
    from repro_torch.models import make_prefill_fn, make_serve_step
    prefill = make_prefill_fn(model)
    _profile(lambda: prefill(params, tokens), f"prefill B,S="
             f"{tuple(tokens.shape)}")
    serve = make_serve_step(model)
    caches = model.init_caches(4, 32, DEVICE)
    toks = tokens[:, :1].repeat(2, 1)[:4]
    nxt, _, caches = serve(params, caches, toks)      # warm-up tick

    def ticks():
        nonlocal nxt, caches
        for _ in range(4):
            nxt, _, caches = serve(params, caches, nxt[:, None])
    _profile(ticks, "decode tick (4 slots)", per=4)


# ---------------------------------------------------------------------------
# phase 5a: the attention-only archs at full width
# ---------------------------------------------------------------------------


def _sum_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _arch_prefill(model, params, cfg, tokens, init: str,
                  tensor_core_ref: bool = False, gate: bool = True,
                  warm: int = 1, tag: str = "archs",
                  replay: bool = False, frontend=None) -> tuple[dict, dict]:
    """One prefill of [archs] or [recurrent] (with ``frontend``: its
    ``frontend_embeds``): the kernel path's
    last-position logits (launches counted: one flash ``wgmma`` an
    attention layer, 3 gmm ``wgmma`` a MoE layer, nothing else),
    ``warm`` more calls timed, and the plain versions' logits, with the
    expert matmul on the tensor cores if ``tensor_core_ref``
    (:func:`_tensor_core_gmm`); with ``gate`` the two
    must lie within 2e-2 of the largest logit.  With ``replay`` the plain
    run takes the kernel run's expert choices (:func:`_routing`), so a
    near-tie in the router does not move a token between experts (nor,
    past a full expert, which tokens drop).  Returns the launches and
    what the log lines read."""
    from repro_torch.kernels import ops
    from repro_torch.models import make_prefill_fn
    prefill = functools.partial(make_prefill_fn(model),
                                frontend_embeds=frontend)
    L, gmm = _attn_layers(cfg), 3 * _moe_layers(cfg)
    _reset_counts()
    routes = []
    with _routing(record=routes) if replay else contextlib.nullcontext():
        out, cold_ms = _host_ms(lambda: prefill(params, tokens))
    counts = _read_counts()
    want = _expected(flash_attention=L, flash_attention_wgmma=L,
                     grouped_matmul=gmm, grouped_matmul_wgmma=gmm)
    if counts != want:
        fail(f"[{tag}] {cfg.name} prefill launched {counts}, expected "
             f"{want}")
    if out.shape != (tokens.shape[0], cfg.vocab) \
            or not torch.isfinite(out).all():
        fail(f"[{tag}] {cfg.name} prefill logits {tuple(out.shape)} not "
             f"finite (B, V)")
    warm_ms = [_host_ms(lambda: prefill(params, tokens))[1]
               for _ in range(warm)]
    ref_gmm = _tensor_core_gmm if tensor_core_ref else contextlib.nullcontext
    with ops.plain_versions(), ref_gmm(), \
            _routing(replay=routes) if replay else \
            contextlib.nullcontext({}) as switched:
        ref, plain_ms = _host_ms(lambda: prefill(params, tokens))
    err = float((out - ref).abs().max())
    if gate:
        _logit_gate(f"[{tag}] {cfg.name} {init} init", out, ref,
                    "plain (tensor-core gmm)" if tensor_core_ref
                    else "plain")
    return counts, dict(err=err, scale=float(ref.abs().max()),
                        same_top=bool((out.argmax(-1) == ref.argmax(-1))
                                      .all()),
                        cold_ms=cold_ms, warm_ms=warm_ms, plain_ms=plain_ms,
                        switched=switched)


def _arch_model(arch: str, layers: int | None = None):
    """(config, model, parameters at the reference init from seed 0,
    their count) of ``arch`` at full width, depth cut to ``layers``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=layers or cfg.n_layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                        DEVICE)
    return cfg, model, params, sum(t.numel() for _, t in tree_leaves(params))


def _frontend_note(cfg) -> str:
    return "" if cfg.frontend is None else (
        f" + {cfg.n_frontend_tokens} {cfg.frontend} tokens")


def _arch_gate(arch: str, layers: int, B: int, S: int) -> dict:
    """(a) of [archs]: ``arch`` at full width cut to ``layers`` layers,
    the prefill gate at the reference init and at the fan-in init, and 4
    requests through the batcher.  Returns the kernel path's launches."""
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, n_params = _arch_model(arch, layers)
    tokens, fe = prefill_tokens(cfg, B, S), frontend_embeds(cfg, B)
    c_ref, ref = _arch_prefill(model, params, cfg, tokens, "reference",
                               tensor_core_ref=bool(_moe_layers(cfg)),
                               frontend=fe)
    c_serve = phase_serve(model, params, cfg, tag="archs")
    del params
    torch.cuda.empty_cache()
    soft = _fan_in_init(model, cfg, seed=1)
    c_fan, fan = _arch_prefill(model, soft, cfg, tokens, "fan-in",
                               frontend=fe)
    del soft, model
    torch.cuda.empty_cache()
    log(f"[archs] {cfg.name} d={cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.hd} F={cfg.d_ff} E={cfg.n_experts} "
        f"window={cfg.window} qkv_bias={cfg.qkv_bias} vocab={cfg.vocab} "
        f"x{layers} layers: {n_params / 1e9:.3f} B params; prefill B={B} "
        f"S={S}{_frontend_note(cfg)}: first {ref['cold_ms']:.1f} ms, second "
        f"{ref['warm_ms'][0]:.1f} ms, plain {ref['plain_ms']:.1f} ms (host "
        f"clock); launches {c_ref}; reference init: max |logit - plain| "
        f"{ref['err']:.4g} of max |logit| {ref['scale']:.4g}, same argmax: "
        f"{ref['same_top']}; fan-in init: {fan['err']:.4g} of "
        f"{fan['scale']:.4g}, same argmax: {fan['same_top']}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return _sum_counts(c_ref, c_serve, c_fan)


def _arch_full(arch: str, B: int, S: int) -> dict:
    """(b) of [archs]: ``arch`` at full width and full depth: 3 timed warm
    prefills, the logits' gap to the plain versions (logged, not gated:
    the reference init's near one-hot softmaxes over the whole depth), 4
    requests through the batcher, peak memory.  Returns the launches."""
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, n_params = _arch_model(arch)
    tokens = prefill_tokens(cfg, B, S)
    counts, r = _arch_prefill(model, params, cfg, tokens, "reference",
                              gate=False, warm=3,
                              frontend=frontend_embeds(cfg, B))
    c_serve = phase_serve(model, params, cfg, tag="archs")
    log(f"[archs] {cfg.name} at full depth ({cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B params, {n_params * 2 / 1e9:.2f} GB bf16): "
        f"prefill B={B} S={S}{_frontend_note(cfg)} first {r['cold_ms']:.1f} ms, warm "
        f"{[round(t, 1) for t in r['warm_ms']]} ms, plain versions "
        f"{r['plain_ms']:.1f} ms (host clock); max |logit - plain| "
        f"{r['err']:.4g} of max |logit| {r['scale']:.4g} (logged), same "
        f"argmax: {r['same_top']}; launches {counts}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {_card()}")
    del params, model
    torch.cuda.empty_cache()
    return _sum_counts(counts, c_serve)


def phase_archs() -> tuple[dict, float]:
    """[archs]: every attention-only arch at full width (:func:`_arch_gate`)
    and, where ``ARCHS`` says so, at full depth (:func:`_arch_full`), each
    model freed before the next.  Returns the launches and the seconds."""
    t0 = time.perf_counter()
    total = None
    for arch, (layers, B, S, full) in ARCHS.items():
        counts = _arch_gate(arch, layers, B, S)
        if full:
            counts = _sum_counts(counts, _arch_full(arch, B, S))
        total = counts if total is None else _sum_counts(total, counts)
    secs = time.perf_counter() - t0
    log(f"[archs] {len(ARCHS)} archs in {secs:.1f} s; launches {total}")
    return total, secs


# ---------------------------------------------------------------------------
# phases 6-10: the collective, autotune, expert-parallel MoE and tracing,
# 4 ranks on one card
# ---------------------------------------------------------------------------


def _expert_weights(cfg, e: int, seed: int):
    """Expert ``e``'s (w1, w3, w2), drawn from a generator seeded by
    (seed, e), so a rank can make its own experts alone."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed * 1000 + e)
    D, F_ = cfg.d_model, cfg.d_ff
    w = [torch.randn(shape, generator=gen, device=DEVICE) / math.sqrt(fan)
         for shape, fan in (((D, F_), D), ((D, F_), D), ((F_, D), F_))]
    return [t.to(cfg.pdtype) for t in w]


def _ep_inputs(cfg, rank: int, seed: int):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=gen,
                         device=DEVICE) / math.sqrt(cfg.d_model)
    gen.manual_seed(seed + 1 + rank)
    x = torch.randn((1, EP_TOKENS, cfg.d_model), generator=gen,
                    device=DEVICE).to(cfg.cdtype)
    return router, x


def _ep_config(arch: str = ARCH, **changes):
    """[moe_ep]'s configuration: phi3.5-moe's own, or ``arch``'s
    (a2a_backend "tuned"), capacity factor 8 so that no token drops;
    ``changes`` on top."""
    from repro_torch.configs import get_config
    return get_config(arch).replace(**{"capacity_factor": 8.0, **changes})


def _ep_weights(cfg, v: int, E_loc: int, seed: int) -> dict:
    """EP rank ``v``'s router and experts (all ranks draw the router)."""
    router, _ = _ep_inputs(cfg, 0, seed)
    w = [_expert_weights(cfg, e, seed) for e in
         range(v * E_loc, (v + 1) * E_loc)]
    return {"router": router,
            **{name: torch.stack([we[i] for we in w])
               for i, name in enumerate(("w1", "w3", "w2"))}}


def _gmm_launches(cfg, E_loc: int, rows: int, n: int) -> dict:
    """``n`` expert FFNs of ``rows`` rows per expert: 3 gmm each, in the
    variants ``moe_gmm.variant`` gives them."""
    from repro_torch.kernels.moe_gmm import variant
    out = {"grouped_matmul": 3 * n}
    for K, N in ((cfg.d_model, cfg.d_ff),) * 2 + ((cfg.d_ff, cfg.d_model),):
        key = f"grouped_matmul_{variant(E_loc, rows, K, N, cfg.cdtype)}"
        out[key] = out.get(key, 0) + n
    return out


REORDER_OPS = ("datatype_pack", "datatype_unpack", "datatype_repack")


def _schedule_launches(dims, variant, orders) -> dict:
    """Block-reorder launches that calls with the given round orders
    make: the passes ``round_schedule`` lists, by entry point."""
    from repro_torch.core.factorized import round_schedule
    counts = dict.fromkeys(REORDER_OPS, 0)
    for order in orders:
        for ku, kp in round_schedule(dims, order, variant):
            counts["datatype_pack" if ku is None else "datatype_unpack"
                   if kp is None else "datatype_repack"] += 1
    return counts


def _n_chunks(size: int, n_chunks: int) -> int:
    """Chunks the overlap engine cuts an extent of ``size`` into."""
    from repro_torch.core.overlap import _split_chunks
    return len(_split_chunks(torch.empty(1, size, device="meta"), 1,
                             n_chunks))


def _sum_launches(*counts) -> dict:
    return {op: sum(c.get(op, 0) for c in counts) for op in REORDER_OPS}


def _dense_launches(plan, reverse: bool, n_chunks: int = 1) -> dict:
    """Block-reorder launches of one dense plan call: none for direct,
    else ``n_chunks`` times round_schedule's passes."""
    if plan.backend == "direct":
        return dict.fromkeys(REORDER_OPS, 0)
    active = tuple(s for s in plan.dims if s > 1)
    order = plan.rev_order if reverse else plan.order
    return _schedule_launches(active, plan.variant, (order,) * n_chunks)


def _alltoallv_launches(plan, reverse: bool) -> dict:
    """Block-reorder launches of one bucketed Alltoallv call: its counts
    phase, then the data rounds — the data plan's (chunked under the
    overlap engine) or the sparse plan's own, which reorder like one
    factorized call."""
    counts = _dense_launches(plan.counts_plan, False)   # forward both ways
    if plan.backend == "sparse":
        active = tuple(s for s in plan.dims if s > 1)
        order = plan.rev_order if reverse else plan.order
        return _sum_launches(counts, _schedule_launches(
            active, plan.variant, (order,)))
    n = 1
    if plan.backend in ("overlap", "pipelined"):
        n = _n_chunks(plan.bucket * math.prod(plan.row_shape), plan.n_chunks)
    return _sum_launches(counts, _dense_launches(plan.data, reverse, n))


def _reorder_launches() -> dict:
    from repro_torch.kernels import block_reorder
    return {op: getattr(block_reorder, op).launches for op in REORDER_OPS}


def _zero_reorder_launches() -> None:
    from repro_torch.kernels import block_reorder
    for op in REORDER_OPS:
        getattr(block_reorder, op).launches = 0


def _coll_counts() -> np.ndarray:
    """[collective]'s (4, 4) Alltoallv send counts: zeros, a rank that
    sends nothing, and on both tori some lanes empty and some not."""
    seed, density = COLL_COUNTS
    rng = np.random.default_rng(seed)
    c = rng.integers(1, COLL_MAX_COUNT + 1, (WORLD, WORLD)) \
        * (rng.random((WORLD, WORLD)) < density)
    c[1] = 0
    return c.astype(np.int32)


def _coll_payload(counts) -> torch.Tensor:
    """Every rank's (p, max_count, *row) windows: the counted rows of
    (s, t) carry the tag (s p + t) 64 + j + 1, the rest 0."""
    p = counts.shape[0]
    x = np.zeros((p, p, COLL_MAX_COUNT) + COLL_ROW, np.float32)
    for s in range(p):
        for t in range(p):
            for j in range(int(counts[s, t])):
                x[s, t, j] = (s * p + t) * 64 + j + 1
    return torch.from_numpy(x)


def _counted_rows_ok(recv, recv_counts, counts, rank: int) -> bool:
    """Every counted row carries the simulator oracle's tag, and
    ``recv_counts`` is the count matrix's column."""
    from repro_torch.core.simulator import simulate_direct_alltoallv
    p = counts.shape[0]
    recv, recv_counts = recv.cpu(), recv_counts.cpu()
    ok = torch.equal(recv_counts, torch.from_numpy(counts[:, rank].copy()))
    for s, slot in enumerate(simulate_direct_alltoallv(counts.tolist())
                             [rank]):
        for j, (es, er, ej) in enumerate(slot):
            ok &= bool((recv[s, j] == (es * p + er) * 64 + ej + 1).all())
    return bool(ok)


def _twice_plus_one(chunk, _c=0):
    return 2 * chunk + 1


def _overlap_checks(tag, mesh, names, x, want, t, want_t, ok, launches):
    """[collective]'s overlap-engine part on one torus: every plan of
    the engine against the factorized plan and the definition, and its
    launches against n_chunks times round_schedule's passes."""
    from repro_torch.core.comm import torus_comm
    B = x.shape[1]
    for variant in ("natural", "paper"):
        comm = torus_comm(mesh, names, variant=variant)
        fact = comm.all_to_all((B,), torch.float32, backend="factorized")
        want_ov = fact.reverse(_twice_plus_one(fact.forward(x)))
        for backend in ("pipelined", "overlap"):
            for nc in COLL_CHUNKS:
                plan = comm.all_to_all((B,), torch.float32, backend=backend,
                                       n_chunks=nc)
                n = _n_chunks(B, nc)
                nt = _n_chunks(math.prod(t.shape) // WORLD, nc)
                key = f"{tag} {backend} {variant} n_chunks={nc}"
                calls = (
                    ("forward", lambda: plan.forward(x), want,
                     _dense_launches(plan, False, n)),
                    ("reverse", lambda: plan.reverse(x), want,
                     _dense_launches(plan, True, n)),
                    ("tiled", lambda: plan.tiled(t, 1, 0), want_t,
                     _dense_launches(plan, False, nt)),
                    ("overlap", lambda: plan.overlap(x, _twice_plus_one),
                     want_ov, _sum_launches(_dense_launches(plan, False, n),
                                            _dense_launches(plan, True, n))))
                for what, run, expect, predicted in calls:
                    _zero_reorder_launches()
                    got = run()
                    counts = _reorder_launches()
                    ok[f"{key} {what}"] = plan.backend == backend and \
                        torch.equal(got, expect)
                    ok[f"{key} {what} launches {counts} == {predicted}"] = \
                        counts == predicted
                    launches.update(_sum_launches(launches, counts))
        ok[f"{tag} factorized {variant} overlap()"] = torch.equal(
            fact.overlap(x, _twice_plus_one), want_ov)


def _alltoallv_checks(tag, mesh, names, rank, ok, launches):
    """[collective]'s Alltoallv part on one torus: ragged (three data
    backends) and sparse, forward and reverse, on the seeded counts."""
    from repro_torch.core.comm import torus_comm
    counts = _coll_counts()
    X = _coll_payload(counts).to(DEVICE)
    x = X[rank].contiguous()
    c = torch.from_numpy(counts[rank].copy()).to(DEVICE)
    for variant in ("natural", "paper"):
        comm = torus_comm(mesh, names, variant=variant)
        plans = [comm.ragged_all_to_all(COLL_ROW, torch.float32,
                                        max_count=COLL_MAX_COUNT,
                                        backend=b, n_chunks=2)
                 for b in ("factorized", "overlap", "direct")]
        plans.append(comm.sparse_all_to_all(
            COLL_ROW, torch.float32, max_count=COLL_MAX_COUNT,
            density=COLL_COUNTS[1]))
        sparse = plans[-1]
        for reverse in (False, True):
            masks = sparse.lane_masks(reverse, torch.device(DEVICE))
            lanes = ((torch.from_numpy(counts).to(DEVICE) > 0) & masks) \
                .flatten(1).any(1)
            ok[f"{tag} {variant} counts leave some lanes empty"] = \
                0 < int(lanes.sum()) < lanes.numel()
        for plan in plans:
            for reverse in (False, True):
                key = (f"{tag} {plan.backend} {type(plan).__name__} "
                       f"{variant} {'reverse' if reverse else 'forward'}")
                _zero_reorder_launches()
                run = plan.reverse if reverse else plan.forward
                recv, rc = run(x, c)
                got = _reorder_launches()
                predicted = _alltoallv_launches(plan, reverse)
                ok[key] = recv.device.type == DEVICE and _counted_rows_ok(
                    recv, rc, counts, rank)
                ok[f"{key} launches {got} == {predicted}"] = \
                    got == predicted
                launches.update(_sum_launches(launches, got))


def _rank_collective(rank: int, n: int) -> dict:
    """[collective] on one rank: every check against the definition,
    and the block-reorder launches of each factorized call against
    ``round_schedule``'s passes."""
    import itertools
    import torch.distributed as dist
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.kernels import block_reorder
    ok, launches, chunked_ms = {}, dict.fromkeys(REORDER_OPS, 0), {}
    B = COLL_B
    gen = torch.Generator(device="cpu").manual_seed(5)
    X = torch.randn((n, n, B), generator=gen).to(DEVICE)
    Xi = torch.randint(-2**20, 2**20, (n, n, B), generator=gen,
                       dtype=torch.int32).to(DEVICE)
    x, want = X[rank].contiguous(), X[:, rank]
    for dims, names in COLL_TORI:
        mesh = cart_create(n, dims, names, device_type=DEVICE)
        comm = torus_comm(mesh, names)
        tag = "x".join(map(str, dims))
        ok[f"{tag} rank order"] = comm.rank == dist.get_rank() == rank
        ok[f"{tag} direct"] = torch.equal(comm.all_to_all(
            (B,), torch.float32, backend="direct").forward(x), want)
        for variant in ("natural", "paper"):
            vcomm = torus_comm(mesh, names, variant=variant)
            for order in itertools.permutations(range(len(dims))):
                plan = vcomm.all_to_all((B,), torch.float32,
                                        backend="factorized",
                                        round_order=order)
                for op in REORDER_OPS:
                    getattr(block_reorder, op).launches = 0
                y, back = plan.forward(x), plan.reverse(x)
                counts = {op: getattr(block_reorder, op).launches
                          for op in REORDER_OPS}
                expect = _schedule_launches(dims, variant,
                                            (plan.order, plan.rev_order))
                key = f"{tag} factorized {variant} {order}"
                ok[key] = torch.equal(y, want) and torch.equal(back, want)
                ok[f"{key} launches {counts} == {expect}"] = counts == expect
                for op in REORDER_OPS:
                    launches[op] += counts[op]
        w = math.prod(COLL_TILED) // n          # elements per rank pair
        t = X[rank, :, :w].reshape(COLL_TILED).contiguous()
        c = COLL_TILED[1] // n
        want_t = torch.cat([X[s, :, :w].reshape(COLL_TILED)
                            [:, rank * c:(rank + 1) * c] for s in range(n)])
        for backend in ("direct", "factorized"):
            plan = comm.all_to_all(backend=backend)
            ok[f"{tag} tiled {backend}"] = torch.equal(
                plan.tiled(t, 1, 0), want_t)
            ok[f"{tag} all_gather {backend}"] = torch.equal(
                comm.all_gather((B,), torch.int32, backend=backend)
                .forward(Xi[rank, 0]), Xi[:, 0])
            ok[f"{tag} reduce_scatter {backend}"] = torch.equal(
                comm.reduce_scatter((B,), torch.int32, backend=backend)
                .forward(Xi[rank]), Xi[:, rank].sum(0, dtype=torch.int32))
        if dims == (2, 2):
            ok.update(_fsdp_checks(mesh, names))
            chunked_ms = _chunked_gather_checks(comm, ok)
        _overlap_checks(tag, mesh, names, x, want, t, want_t, ok, launches)
        _alltoallv_checks(tag, mesh, names, rank, ok, launches)
    return {"ok": {k: bool(v) for k, v in ok.items()},
            "launches": launches, "chunked_ms": chunked_ms}


def _chunked_gather_checks(comm, ok: dict) -> dict:
    """The chunked all-gather and reduce-scatter (``n_chunks`` in
    COLL_CHUNKS; 3 shrinks to 2 chunks of the COLL_B block, as
    ``core.overlap._split_chunks`` makes them) on the (2,2) torus: the
    all-gather in bf16, f32 and int64 bit for bit against the unchunked
    plan, the definition and the ported simulator oracle's placement;
    the int64 reduce-scatter bit for bit against the definition and the
    unchunked plan, the f32 one within p * 2**-23 of the sum of its
    terms' magnitudes of the definition's f64 sum (a p-term f32 sum in
    any order); one backward of each (integer-valued f32, exact) bit for
    bit the unchunked plan's.  Returns the median host ms of
    COLL_GATHER_TIMED-element bf16 calls at each n_chunks."""
    from repro_torch.core.simulator import simulate_factorized_allgather
    n, r, B = comm.p, comm.rank, COLL_B
    gen = torch.Generator(device="cpu").manual_seed(9)
    ints = torch.randint(-1000, 1000, (n, n, B), generator=gen).to(DEVICE)
    F = torch.randn((n, n, B), generator=gen).to(DEVICE)
    W = torch.randint(-9, 10, (n, n, B), generator=gen).float().to(DEVICE)
    sim = simulate_factorized_allgather(comm.dims)[0][r]
    tag = torch.full((B,), r, dtype=torch.int64, device=DEVICE)

    def plan(kind, dtype, k):
        return getattr(comm, kind)((B,), dtype, backend="factorized",
                                   n_chunks=k)

    def grad(kind, k, x, w):
        x = x.clone().requires_grad_(True)
        plan(kind, torch.float32, k).forward(x).backward(w)
        return x.grad

    for dtype, X in ((torch.int64, ints), (torch.float32, F),
                     (torch.bfloat16, F.to(torch.bfloat16))):
        G = X[:, 0]
        y1 = plan("all_gather", dtype, 1).forward(G[r])
        for k in COLL_CHUNKS:
            y = plan("all_gather", dtype, k).forward(G[r])
            ok[f"2x2 chunked all_gather {dtype} n_chunks={k}"] = \
                torch.equal(y, G) and torch.equal(y, y1)
    want_f = F[:, r].double().sum(0)
    bound = n * 2.0 ** -23 * F[:, r].double().abs().sum(0)
    z1 = plan("reduce_scatter", torch.int64, 1).forward(ints[r])
    g1 = (grad("all_gather", 1, ints[r, 0].float(), W[r]),
          grad("reduce_scatter", 1, ints[r].float(), W[r, 0]))
    for k in COLL_CHUNKS:
        ok[f"2x2 chunked all_gather n_chunks={k}: the oracle's placement"] \
            = plan("all_gather", torch.int64, k).forward(tag)[:, 0] \
            .tolist() == sim
        z = plan("reduce_scatter", torch.int64, k).forward(ints[r])
        ok[f"2x2 chunked reduce_scatter int64 n_chunks={k}"] = \
            torch.equal(z, ints[:, r].sum(0)) and torch.equal(z, z1)
        zf = plan("reduce_scatter", torch.float32, k).forward(F[r])
        ok[f"2x2 chunked reduce_scatter float32 n_chunks={k} within "
           f"p * 2**-23 of the terms' magnitudes"] = bool(
               ((zf.double() - want_f).abs() <= bound).all())
        g = (grad("all_gather", k, ints[r, 0].float(), W[r]),
             grad("reduce_scatter", k, ints[r].float(), W[r, 0]))
        ok[f"2x2 chunked backward n_chunks={k}: the unchunked plan's"] = \
            all(torch.equal(a, b) for a, b in zip(g, g1))
    x = torch.randn(COLL_GATHER_TIMED, generator=gen).to(
        DEVICE, torch.bfloat16)
    xs = torch.randn((n, COLL_GATHER_TIMED), generator=gen).to(
        DEVICE, torch.bfloat16)
    out = {}
    for k in (1,) + COLL_CHUNKS:
        for kind, arg in (("all_gather", x), ("reduce_scatter", xs)):
            p = getattr(comm, kind)(arg.shape[int(kind != "all_gather"):],
                                    torch.bfloat16, backend="factorized",
                                    n_chunks=k)
            p.forward(arg)
            ms = [_host_ms(lambda: p.forward(arg))[1] for _ in range(5)]
            out[f"{kind} n_chunks={k}"] = float(np.median(ms))
    return out


def _fsdp_checks(mesh, names) -> dict:
    """FSDP's gather of phi3.5-moe's embedding over the torus ``names``:
    each rank's shard (a block of the d_model columns, bf16, integer
    values) gathered must be the whole embedding, and the gradient of
    its shard (the reduce-scatter of every rank's integer-valued
    cotangent, summed in f32) the sum of the cotangents' blocks, both bit
    for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm import torus_comm
    from repro_torch.parallel.sharding import fsdp_gather
    cfg = get_config(ARCH)
    comm = torus_comm(mesh, names)
    n, f = comm.p, comm.rank
    k = cfg.d_model // n

    def integers(seed, lo, hi):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        return torch.randint(lo, hi, (cfg.vocab, cfg.d_model), generator=gen,
                             device=DEVICE).to(torch.bfloat16)
    W = integers(11, -100, 101)
    x = W[:, f * k:(f + 1) * k].clone().requires_grad_(True)
    y = fsdp_gather(x, comm, 1)
    gathered = torch.equal(y.detach(), W)
    del W
    want = torch.zeros_like(x)
    for r in range(n):
        cot = integers(12 + r, -8, 9)
        want += cot[:, f * k:(f + 1) * k]
        if r == f:
            mine = cot
    y.backward(mine)
    torch.cuda.synchronize()
    return {"2x2 fsdp all_gather (embedding shard)": gathered,
            "2x2 fsdp reduce_scatter (its gradient)": torch.equal(x.grad,
                                                                  want)}


def _definition(n: int, block, dtype, rank: int):
    """What torus rank ``rank`` receives from every rank in an all-to-all
    of the search's global operand: ``global[i, rank]`` for each ``i``
    (``core.autotune._operand``'s ``arange % 251``)."""
    B = math.prod(block)
    return torch.stack([
        (torch.arange((i * n + rank) * B, (i * n + rank + 1) * B,
                      device=DEVICE) % 251).reshape(block).to(dtype)
        for i in range(n)])


def _search_checks(tag, mesh, axes, block, dtype, rank, ok) -> dict:
    """One dense search (``autotune``) and its gates on one rank: the
    record's table is the reference's candidate list for dims (2,2),
    nothing skipped, the plan measured; a second ``backend="autotune"``
    build is the same plan and times nothing; forward and reverse equal
    the definition, with n_chunks x round_schedule's reorder passes."""
    from repro_torch.core.autotune import (TuningDB, _chunk_candidates,
                                           _operand, autotune,
                                           autotune_stats, db_fingerprint,
                                           measured_links, plan_db_key)
    from repro_torch.core.plan import itemsize, plan_all_to_all
    from repro_torch.core.tuning import default_links
    t0 = time.perf_counter()
    plan = autotune(mesh, axes, block, dtype, max_chunks=TUNE_MAX_CHUNKS,
                    budget_seconds=TUNE_BUDGET_S)
    search_s = time.perf_counter() - t0
    dims = plan.dims
    rec = TuningDB().get(plan_db_key(db_fingerprint(mesh), dims, axes,
                                     block, dtype, "natural"))
    links = measured_links(rec) or default_links(axes)
    chunks = _chunk_candidates(dims, links,
                               float(math.prod(block) * itemsize(dtype)),
                               TUNE_MAX_CHUNKS)
    want = [("direct", [0, 1], 1), ("factorized", [0, 1], 1),
            ("factorized", [1, 0], 1)] \
        + [("overlap", [0, 1], c) for c in chunks]
    got = [(r["backend"], r["round_order"], r["n_chunks"])
           for r in rec["table"]]
    ok[f"{tag}: the table {got} is the candidate list {want}"] = \
        got == want and all(r["eligible"] for r in rec["table"])
    ok[f"{tag}: nothing skipped {rec['skipped']}"] = rec["skipped"] == []
    ok[f"{tag}: tuned_from measured"] = plan.tuned_from == "measured"
    timed = autotune_stats()["timing_executions"]
    ok[f"{tag}: a second build is the plan and times nothing"] = \
        plan_all_to_all(mesh, axes, block, dtype, backend="autotune") \
        is plan and autotune_stats()["timing_executions"] == timed
    x = _operand(WORLD, block, dtype, rank, torch.device(DEVICE))
    n = _n_chunks(math.prod(block), plan.n_chunks) \
        if plan.backend in ("overlap", "pipelined") else 1
    before = _reorder_launches()
    y, back = plan.forward(x), plan.reverse(x)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in _reorder_launches().items()}
    predicted = _sum_launches(_dense_launches(plan, False, n),
                              _dense_launches(plan, True, n))
    want_y = _definition(WORLD, block, dtype, rank)
    ok[f"{tag}: forward and reverse equal the definition"] = \
        torch.equal(y, want_y) and torch.equal(back, want_y)
    ok[f"{tag}: reorder launches {counts} == {predicted}"] = \
        counts == predicted
    return {"describe": plan.describe(), "table": rec["table"],
            "links": rec["measured_links"],
            "default_links": [{"alpha": l.alpha, "bandwidth": l.bandwidth}
                              for l in default_links(axes)],
            "search_s": search_s}


def _rank_autotune(rank: int, n: int) -> dict:
    """[autotune] on one rank: the measured search at [moe_ep]'s EP block
    and at the dropless layer's padded data block, the ragged-vs-sparse
    search at its row and window; the tuning DB is the world's
    temporary file (``run_world``)."""
    from repro_torch.core.autotune import (TuningDB, autotune_ragged,
                                           autotune_stats, db_fingerprint,
                                           ragged_db_key)
    from repro_torch.core.cache import cart_create
    from repro_torch.models.moe import _capacity, _group_geometry
    cfg = _ep_config()
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type=DEVICE)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    C = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, G))
    dcfg = _ep_config(capacity_factor=None)
    window = E_loc * _capacity(dcfg, EP_TOKENS, max(dcfg.n_experts, G))
    density = min(1.0, max(1e-6, 1.0 - math.exp(
        -dcfg.top_k * EP_TOKENS / G)))
    ok = {}
    _reset_counts()
    out = {"ep": _search_checks("EP block", mesh, axes,
                                (E_loc, C, cfg.d_model), cfg.cdtype, rank,
                                ok),
           "data": _search_checks("dropless data block", mesh, axes,
                                  (window, dcfg.d_model), dcfg.cdtype,
                                  rank, ok)}
    t0 = time.perf_counter()
    rplan = autotune_ragged(mesh, axes, (dcfg.d_model,), dcfg.cdtype,
                            max_count=window, density=density)
    ragged_s = time.perf_counter() - t0
    rec = TuningDB().get(ragged_db_key(db_fingerprint(mesh), (2, 2), axes,
                                       (dcfg.d_model,), dcfg.cdtype, window,
                                       "natural", density))
    ok["ragged: the winner is the plan returned"] = \
        (rec["winner"]["backend"] == "sparse") \
        == (type(rplan).__name__ == "SparseA2APlan")
    out.update(ok=ok, counts=_read_counts(), stats=autotune_stats(),
               ragged={"kind": type(rplan).__name__, "table": rec["table"],
                       "winner": rec["winner"], "search_s": ragged_s,
                       "row": f"({dcfg.d_model},) {rec['dtype']}",
                       "window": window})
    return out


def _timed_calls(call, rank: int, label: str, warm: int = 3) -> dict:
    """One counted cold call of ``call``, ``warm`` warm ones, and a
    profiled one on rank 0 (the other ranks run it unprofiled)."""
    from repro_torch.core import telemetry
    copies = {k: telemetry.metrics().counter(f"overlap.{k}")
              for k in ("chunk_copies", "concat_copies")}
    torch.cuda.synchronize()
    _reset_counts()
    before = {k: c.value for k, c in copies.items()}
    (y, aux), cold_ms = _host_ms(call)
    out = {"counts": _read_counts(), "cold_ms": cold_ms,
           **{k: c.value - before[k] for k, c in copies.items()},
           "y": y, "aux": float(aux)}
    out["warm_ms"] = [_host_ms(call)[1] for _ in range(warm)]
    out["interleave"] = None
    if rank == 0:
        from repro_torch.core.profile_inspect import interleave_report
        rep = interleave_report(_profile(
            call, f"{label}, rank 0 of 4 (overlap.chunk_copies "
            f"{out['chunk_copies']}, overlap.concat_copies "
            f"{out['concat_copies']} a call)"))
        out["interleave"] = {
            "interleaved": rep.interleaved_collectives,
            "collective_runs": rep.collective_runs,
            "events": [c[0] for c in rep.events]}
    else:
        call()
    return out


def _rank_moe_ep(rank: int, n: int, seed: int) -> dict:
    """[moe_ep] on one rank: its 4 experts and 512 tokens through
    ``moe_block`` with the (data=2, pod=2) mesh, under the config's
    tuned plan and, for comparison, the factorized one."""
    from repro_torch.core.cache import cart_create
    from repro_torch.models.moe import _capacity, _group_geometry, \
        moe_a2a_plan, moe_block, moe_ep_comm
    cfg = _ep_config()
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type=DEVICE)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    C = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, G))
    plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
    p = _ep_weights(cfg, moe_ep_comm(cfg, mesh, axes).rank, E_loc, seed)
    _, x = _ep_inputs(cfg, rank, seed)
    tuned = lambda: moe_block(p, x, cfg, mesh=mesh)
    out = _timed_calls(tuned, rank, "moe_ep layer call (tuned: overlap)",
                       warm=0)
    fcfg = _ep_config(a2a_backend="factorized")
    fplan = moe_a2a_plan(fcfg, mesh, axes, E_loc, C)
    factorized = lambda: moe_block(p, x, fcfg, mesh=mesh)
    fact = _timed_calls(factorized, rank, "moe_ep layer call (factorized)",
                        warm=0)
    # the measured winner of [autotune] at this very block, replayed
    acfg = _ep_config(a2a_backend="autotune")
    aplan = moe_a2a_plan(acfg, mesh, axes, E_loc, C)
    autotuned = lambda: moe_block(p, x, acfg, mesh=mesh)
    auto = _timed_calls(autotuned, rank,
                        f"moe_ep layer call (autotune: {aplan.backend})",
                        warm=0)
    an = _n_chunks(C, aplan.n_chunks) if aplan.backend == "overlap" else 1
    # warm host ms of the three plans in turns, each first in a third of
    # the rounds
    runs = ((tuned, out), (factorized, fact), (autotuned, auto))
    for i in range(EP_PAIRS):
        for run, res in runs[i % 3:] + runs[:i % 3]:
            res["warm_ms"].append(_host_ms(run)[1])
    n_chunks = _n_chunks(C, plan.n_chunks)
    out.update(describe=plan.describe(), n_chunks=n_chunks, C=C,
               predicted=_sum_launches(_dense_launches(plan, False, n_chunks),
                                       _dense_launches(plan, True, n_chunks)),
               dy_factorized=float((out["y"].float() - fact["y"]
                                         .float()).abs().max()),
               fact_warm_ms=fact["warm_ms"], fact_counts=fact["counts"],
               fact_predicted=_sum_launches(_dense_launches(fplan, False),
                                            _dense_launches(fplan, True)),
               fact_interleave=fact["interleave"],
               auto_describe=aplan.describe(), auto_n=an,
               auto_warm_ms=auto["warm_ms"],
               auto_counts=auto["counts"],
               auto_predicted=_sum_launches(
                   _dense_launches(aplan, False, an),
                   _dense_launches(aplan, True, an)),
               auto_equal=torch.equal(auto["y"], fact["y"]),
               weight_gb=sum(t.numel() * t.element_size()
                             for t in p.values()) / 1e9,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["y"] = out["y"].float().cpu().numpy()
    return out


def _rank_moe_ep_grok(rank: int, n: int, seed: int) -> dict:
    """grok-1's MoE layer at full width in [moe_ep]'s world: this rank's 2
    of the 8 experts and [moe_ep]'s 512 tokens through ``moe_block`` under
    the config's tuned plan (a counted cold call, 2 warm ones), then the
    same call under the factorized plan (counted), whose output the tuned
    call's must equal bit for bit."""
    from repro_torch.core.cache import cart_create
    from repro_torch.models.moe import _capacity, _group_geometry, \
        moe_a2a_plan, moe_block, moe_ep_comm
    t0 = time.perf_counter()
    cfg = _ep_config(GROK)
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type=DEVICE)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    C = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, G))
    plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
    p = _ep_weights(cfg, moe_ep_comm(cfg, mesh, axes).rank, E_loc, seed)
    _, x = _ep_inputs(cfg, rank, seed)
    torch.cuda.synchronize()
    _reset_counts()
    (y, aux), cold_ms = _host_ms(lambda: moe_block(p, x, cfg, mesh=mesh))
    counts = _read_counts()
    warm = [_host_ms(lambda: moe_block(p, x, cfg, mesh=mesh))[1]
            for _ in range(2)]
    fcfg = _ep_config(GROK, a2a_backend="factorized")
    fplan = moe_a2a_plan(fcfg, mesh, axes, E_loc, C)
    _reset_counts()
    (yf, _), fact_ms = _host_ms(lambda: moe_block(p, x, fcfg, mesh=mesh))
    fact_counts = _read_counts()
    n_chunks = _n_chunks(C, plan.n_chunks)
    out = dict(describe=plan.describe(), n_chunks=n_chunks, C=C,
               counts=counts, fact_counts=fact_counts,
               predicted=_sum_launches(
                   _dense_launches(plan, False, n_chunks),
                   _dense_launches(plan, True, n_chunks)),
               fact_predicted=_sum_launches(_dense_launches(fplan, False),
                                            _dense_launches(fplan, True)),
               equal=torch.equal(y, yf),
               dy_factorized=float((y.float() - yf.float()).abs().max()),
               y=y.float().cpu().numpy(), aux=float(aux), cold_ms=cold_ms,
               warm_ms=warm, fact_ms=fact_ms,
               weight_gb=sum(t.numel() * t.element_size()
                             for t in p.values()) / 1e9,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del p, x, y, yf
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _rank_moe_dropless(rank: int, n: int, seed: int) -> dict:
    """[moe_dropless] on one rank: [moe_ep]'s experts and tokens through
    the dropless layer (capacity_factor=None) under the tuned plan."""
    from repro_torch.core.cache import cart_create
    from repro_torch.models.moe import _capacity, _group_geometry, \
        moe_block, moe_dropless_a2a_plan, moe_ep_comm
    cfg = _ep_config(capacity_factor=None)
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type=DEVICE)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    C = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, G))
    plan = moe_dropless_a2a_plan(cfg, mesh, axes, E_loc, C, EP_TOKENS)
    p = _ep_weights(cfg, moe_ep_comm(cfg, mesh, axes).rank, E_loc, seed)
    _, x = _ep_inputs(cfg, rank, seed)
    # this rank's send counts, as the layer's router makes them
    top = torch.topk(torch.softmax(x[0].float() @ p["router"].float(), -1),
                     cfg.top_k).indices
    send = torch.bincount((top // E_loc).reshape(-1), minlength=G)
    out = _timed_calls(lambda: moe_block(p, x, cfg, mesh=mesh), rank,
                       f"moe_dropless layer call ({plan.backend})")
    # the measured ragged-vs-sparse winner of [autotune], replayed (a
    # ragged plan's data plan replays the padded block's record)
    acfg = _ep_config(capacity_factor=None, a2a_backend="autotune")
    aplan = moe_dropless_a2a_plan(acfg, mesh, axes, E_loc, C, EP_TOKENS)
    auto = _timed_calls(lambda: moe_block(p, x, acfg, mesh=mesh), rank,
                        f"moe_dropless layer call (autotune: "
                        f"{type(aplan).__name__} {aplan.backend})", warm=0)
    out.update(kind=type(plan).__name__, describe=plan.describe(), C=C,
               occupancy=float(plan.occupancy(send.to(torch.int32))),
               predicted=_sum_launches(_alltoallv_launches(plan, False),
                                       _alltoallv_launches(plan, True)),
               auto_kind=type(aplan).__name__, auto_describe=aplan.describe(),
               auto_counts=auto["counts"],
               auto_predicted=_sum_launches(_alltoallv_launches(aplan, False),
                                            _alltoallv_launches(aplan, True)),
               auto_equal=torch.equal(auto["y"], out["y"]),
               auto_y=auto["y"].float().cpu().numpy())
    out["y"] = out["y"].float().cpu().numpy()
    return out


def _span_shape(spans) -> list:
    """The span forest as nested ``(name, kind, backend, axis, children)``
    tuples, each level in start order."""
    kids: dict = {}
    for sp in sorted(spans, key=lambda sp: sp.start):
        kids.setdefault(sp.parent_id, []).append(sp)

    def shape(sp):
        return (sp.name, sp.attrs.get("kind"), sp.attrs.get("backend"),
                sp.attrs.get("axis"),
                tuple(shape(c) for c in kids.get(sp.span_id, ())))
    return [shape(sp) for sp in kids.get(None, ())]


def _dense_shape(plan, reverse: bool) -> tuple:
    """The spans one traced ``forward`` / ``reverse`` of a dense plan
    makes: a round span per active round (factorized), else one fused."""
    if plan.backend == "factorized":
        order = plan.rev_order if reverse else plan.order
        names = [a for a, d in zip(plan.axis_names, plan.dims) if d > 1]
        rounds = tuple(("plan.round", None, None, names[k], ())
                       for k in order)
    else:
        rounds = (("plan.round", None, plan.backend, "*", ()),)
    return ("plan.execute", "dense", plan.backend, None, rounds)


def _rank_tracing(rank: int, n: int, seed: int) -> dict:
    """[tracing] on one rank: the factorized, overlap and dropless layer
    calls untraced, then ``TRACE_CALLS`` times each traced; the span
    tree, the drift keys, ``check_drift``, a Chrome trace; the drift
    ratios under the default and the measured links; a decode-size
    call's host µs with tracing off and on."""
    from repro_torch.core import telemetry
    from repro_torch.core.autotune import (TuningDB, db_fingerprint,
                                           measured_links, plan_db_key)
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.models.moe import (_capacity, _group_geometry,
                                        moe_a2a_plan, moe_block,
                                        moe_dropless_a2a_plan, moe_ep_comm)
    from repro_torch.runtime.watchdog import StragglerWatchdog
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type=DEVICE)
    cfgs = {"factorized": _ep_config(a2a_backend="factorized"),
            "overlap": _ep_config(),
            "dropless": _ep_config(capacity_factor=None)}
    axes, G, E_loc, _ = _group_geometry(cfgs["overlap"], mesh)
    E = cfgs["overlap"].n_experts
    C = _capacity(cfgs["overlap"], EP_TOKENS, max(E, G))
    Cd = _capacity(cfgs["dropless"], EP_TOKENS, max(E, G))
    p = _ep_weights(cfgs["overlap"], moe_ep_comm(cfgs["overlap"], mesh,
                                                 axes).rank, E_loc, seed)
    _, x = _ep_inputs(cfgs["overlap"], rank, seed)
    plans = {k: moe_a2a_plan(cfgs[k], mesh, axes, E_loc, C)
             for k in ("factorized", "overlap")}
    dplan = moe_dropless_a2a_plan(cfgs["dropless"], mesh, axes, E_loc, Cd,
                                  EP_TOKENS)
    ok = {"the overlap call runs the overlap engine":
          plans["overlap"].backend == "overlap",
          "the dropless call runs the ragged plan":
          type(dplan).__name__ == "RaggedA2APlan"}

    def calls():
        for name, cfg in cfgs.items():
            _reset_counts()
            y, _ = moe_block(p, x, cfg, mesh=mesh)
            torch.cuda.synchronize()
            yield name, y, _read_counts()

    untraced = {name: (y, c) for name, y, c in calls()}
    telemetry.reset_telemetry()
    tr = telemetry.enable_tracing()
    try:
        for i in range(TRACE_CALLS):
            for name, y, c in calls():
                uy, uc = untraced[name]
                ok[f"traced {name} call {i}: output equal to untraced"] = \
                    torch.equal(y, uy)
                ok[f"traced {name} call {i}: launches {c} == {uc}"] = \
                    c == uc
    finally:
        telemetry.disable_tracing()
    spans = tr.spans()

    # the span tree: the plans' own shapes, call after call
    f, o = plans["factorized"], plans["overlap"]
    rag = ("plan.execute", "ragged", dplan.backend, None,
           (("ragged.counts", None, "", None, ()),))
    want_call = {
        "factorized": [_dense_shape(f, False), _dense_shape(f, True)],
        "overlap": [("plan.execute", "dense", "overlap", None,
                     (("plan.round", None, "overlap", "*", ()),))],
        "dropless": [(*rag[:4], rag[4] + (_dense_shape(dplan.data, r),))
                     for r in (False, True)]}
    want = [s for _ in range(TRACE_CALLS) for k in cfgs
            for s in want_call[k]]
    got = _span_shape(spans)
    # the counts span's backend is the counts plan's: normalise it
    got = [(*g[:4], tuple((c[0], c[1], "" if c[0] == "ragged.counts"
                                  else c[2], c[3], c[4]) for c in g[4]))
           for g in got]
    ok[f"span tree: {len(got)} top-level spans as the plans predict"] = \
        got == want

    # drift keys in the reference's format
    summary = telemetry.drift_detector().summary()
    names = [a for a, d in zip(f.axis_names, f.dims) if d > 1]
    keys = {f._drift_key(), o._drift_key() + ":overlap",
            dplan._drift_key(), dplan.data._drift_key()}
    keys |= {f"{f._drift_key()}:axis={a}" for a in names}
    if dplan.data.backend == "factorized":
        keys |= {f"{dplan.data._drift_key()}:axis={a}" for a in names}
    ok[f"drift keys {sorted(summary)} == {sorted(keys)}"] = \
        set(summary) == keys
    wd = StragglerWatchdog()
    first, second = wd.check_drift(step=1), wd.check_drift(step=2)
    drifted = sorted(k for k, v in summary.items() if v["drifted"])
    ok["check_drift: one retune per drifted key"] = \
        sorted(k for k, _ in first) == drifted \
        and all(a.kind == "retune" for _, a in first)
    ok["check_drift: nothing on a second call"] = second == []

    # the Chrome trace, exported, reloaded and checked
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"trace{rank}.json"
        tr.export_chrome_trace(path)
        doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    ids = {ev["args"]["span_id"] for ev in events}
    ok["chrome trace: schema"] = len(events) == len(spans) and all(
        set(ev) == {"name", "ph", "ts", "dur", "pid", "tid", "cat", "args"}
        and ev["ph"] == "X" and ev["dur"] >= 0.0
        and ev["args"].get("parent_id", next(iter(ids))) in ids
        for ev in events) and doc["otherData"]["dropped_spans"] == 0

    # drift ratios under the default links and under [autotune]'s fit:
    # the EP block's, or where that fit gave up the dropless data
    # block's (the fit times the same single-axis exchanges)
    block = (E_loc, C, cfgs["overlap"].d_model)
    links = next(filter(None, (measured_links(TuningDB().get(plan_db_key(
        db_fingerprint(mesh), f.dims, axes, b, cfgs["overlap"].cdtype,
        "natural"))) for b in (block, (E_loc * Cd,
                                       cfgs["overlap"].d_model)))), None)
    ratios = {}
    if links is not None:
        comm = torus_comm(mesh, axes)
        remeasured = {
            f._drift_key(): comm.all_to_all(block, f.dtype,
                                            backend="factorized",
                                            links=links),
            o._drift_key() + ":overlap": comm.all_to_all(
                block, o.dtype, backend="overlap", n_chunks=o.n_chunks,
                links=links)}
        for key, mp in remeasured.items():
            info = summary[key]
            scale = 2 if key.endswith(":overlap") else 1
            ratios[key] = (info["ratio"], info["ratio"]
                           * info["predicted_seconds"]
                           / (scale * mp.schedule.predicted_seconds))
        mp = remeasured[f._drift_key()]
        for a, pred in mp._per_axis_predictions().items():
            info = summary[f"{f._drift_key()}:axis={a}"]
            ratios[f"{f._drift_key()}:axis={a}"] = (
                info["ratio"], info["ratio"] * info["predicted_seconds"]
                / pred)

    # a decode-size call's host µs, tracing off and on
    dblock = (E_loc, DECODE_C, cfgs["overlap"].d_model)
    dec = torus_comm(mesh, axes).all_to_all(dblock, cfgs["overlap"].cdtype,
                                           backend="factorized")
    xd = torch.randn((G,) + dblock, device=DEVICE).to(
        cfgs["overlap"].cdtype)
    off = _host_us(lambda: dec.forward(xd), iters=50)
    telemetry.enable_tracing()
    try:
        on = _host_us(lambda: dec.forward(xd), iters=50)
    finally:
        telemetry.disable_tracing()
    telemetry.reset_telemetry()
    return {"ok": {k: bool(v) for k, v in ok.items()}, "summary": summary,
            "drifted": drifted, "retunes": [k for k, _ in first],
            "ratios": ratios, "spans": len(spans),
            "decode_us": (off, on), "decode_bytes": xd.numel() * 2}


# ---------------------------------------------------------------------------
# phase 11: expert- and data-parallel training on the mesh
# ---------------------------------------------------------------------------


def _train_ep_config(**changes):
    """[train_ep]'s configuration: phi3.5-moe at full width (its own
    a2a_backend "tuned"), cut to 1 layer, capacity factor 8 so that no
    token drops (the one-process step is then a reference).  The batch's
    cut (TRAIN_EP_FILL) is :func:`_filling_tokens`'s."""
    from repro_torch.configs import get_config
    return get_config(ARCH).replace(**{"n_layers": 1, "capacity_factor": 8.0,
                                       **changes})


def _train_ep_launches(cfg, plan, C: int) -> dict:
    """Predicted launches of one training step on one rank: per layer the
    flash forward-with-lse twice (forward, remat recompute) and its
    backward once; the MoE's exchange forward, in the recompute and in
    the backward, each ``n_chunks`` x round_schedule's passes both ways;
    the gmm 3 per chunk forward and in the recompute, and under the
    overlap engine 3 + 6 per chunk in the backward (its vjp recomputes
    the expert FFN), else 6.  Under ``remat_policy="collectives"`` the
    recompute exchanges nothing (the forward's ``moe_recv`` / ``moe_back``
    are kept): its passes are gone, and under the overlap engine its 3
    gmm a chunk too (the whole ``OverlapFn`` is skipped; its backward
    recomputes the expert FFN anyway).  ``dots`` keeps products that are
    not kernels: the same launches as ``nothing``."""
    L = cfg.n_layers
    overlap = plan.backend == "overlap"
    kept = cfg.remat_policy == "collectives"
    n = _n_chunks(C, plan.n_chunks) if overlap else 1
    gmm = L * ((15 - 3 * kept) * n if overlap else 12)
    passes = _sum_launches(_dense_launches(plan, False, n),
                           _dense_launches(plan, True, n))
    return _expected(flash_attention_fwd=2 * L,
                     flash_attention_fwd_wgmma=2 * L,
                     flash_attention_bwd=L, flash_attention_bwd_wgmma=L,
                     grouped_matmul=gmm,
                     grouped_matmul_wgmma=gmm,
                     **{op: (3 - kept) * L * v for op, v in passes.items()})


def _ep_loss_grads(model, params, batch, mesh, sharding, rules=None):
    """One loss + backward on the mesh under ``rules``: (this rank's
    reduced gradients as a tree, the total loss averaged over the ranks,
    its launches)."""
    import torch.distributed as dist
    from repro_torch.models import make_loss_fn, reduce_grads
    from repro_torch.models.common import tree_leaves, tree_with_leaves
    from repro_torch.parallel.sharding import batch_group
    leaves = tree_leaves(params)
    _reset_counts()
    total, _ = make_loss_fn(model, mesh, rules)(params, batch)
    got = torch.autograd.grad(total, [t for _, t in leaves])
    counts = _read_counts()
    grads = reduce_grads(tree_with_leaves(
        params, {p: g for (p, _), g in zip(leaves, got)}), sharding,
        batch_group(mesh, rules))
    loss = total.detach().float().reshape(1).clone()
    dist.all_reduce(loss)
    return grads, float(loss[0]) / dist.get_world_size(), counts


def _filling_tokens(model, params, mesh, E_loc: int) -> list:
    """For each EP rank v, the first token (of TRAIN_EP_CANDIDATES) whose
    top-1 expert lies on v, routed as a one-token sequence through the
    model on the mesh: the router's input is then what it is at every
    position of a run of that token, since causal attention over equal
    tokens returns their value.  A row block's leading TRAIN_EP_FILL
    tokens set to its token send more than C / n_chunks tokens to one
    expert of every EP rank, so every capacity chunk of the overlap
    engine carries routed rows on every rank (``phase_train_ep`` checks
    it from the gated call's routing).  Rank 0's choice, broadcast."""
    import torch.distributed as dist
    picked = torch.tensor(_pick_fill(model, params, E_loc, WORLD, mesh),
                          device=DEVICE)
    dist.broadcast(picked, src=0)
    if bool((picked < 0).any()):
        fail(f"[train_ep] no one of the first {TRAIN_EP_CANDIDATES} tokens "
             f"routes first to every EP rank: {picked.tolist()}")
    return picked.tolist()


def _pick_fill(model, params, E_loc: int, G: int, mesh=None) -> list:
    """For each of the G EP ranks, the first of TRAIN_EP_CANDIDATES tokens
    whose top-1 expert (of ``E_loc`` a rank) lies on it, routed as
    one-token sequences through ``model`` (on ``mesh``, or in one
    process); -1 where none does."""
    rec = []
    cand = torch.arange(min(TRAIN_EP_CANDIDATES, model.cfg.vocab),
                        dtype=torch.int32, device=DEVICE)[:, None]
    with torch.no_grad(), _routing(record=rec):
        model.forward(params, cand, mesh=mesh)
    owner = (rec[0][:, 0] // E_loc).tolist()
    return [owner.index(v) if v in owner else -1 for v in range(G)]


def _sharded_gaps(got, want, sharding) -> dict:
    """``||got - want|| / ||want||`` per leaf of two reduced trees on the
    mesh (split leaves summed over their groups: collective)."""
    from repro_torch.models.common import tree_leaves
    out = {}
    for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        sq = torch.stack([torch.sum((g.float() - w.float()) ** 2),
                          torch.sum(w.float() ** 2)])
        if sharding.split(path):
            sq = sharding.leaf_sq_sum(path, sq)
        out[path] = float(torch.sqrt(sq[0] / sq[1]))
    return out


def _rank_train_ep(rank: int, n: int, seed: int, tmp: str) -> dict:
    """[train_ep] on one rank: ``build_training`` on the (data=2, pod=2)
    mesh at full width (1 layer), the gradients under the tuned plan and
    the factorized one against the one-process kernel step on the global
    batch (rank 0), timed and profiled steps, then ``Trainer.run`` at a
    cut width with a checkpoint restored bit for bit."""
    import torch.distributed as dist
    from repro_torch.core.cache import cart_create
    from repro_torch.data import (CopyTaskConfig, SyntheticLM,
                                  make_copy_task_batch)
    from repro_torch.launch.train import build_training
    from repro_torch.models import build_model
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map)
    from repro_torch.models.moe import _capacity, _group_geometry, \
        moe_a2a_plan
    from repro_torch.parallel.sharding import FSDP_SPAN, batch_split
    from repro_torch.runtime import Trainer, TrainerConfig
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type=DEVICE)
    cfg = _train_ep_config()
    t0 = time.perf_counter()
    model, _, params, opt_state, step_fn = build_training(
        cfg, mesh, lr=1e-4, warmup=2, total=TRAIN_EP_STEPS, seed=seed,
        device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    sharding = param_shardings(model.specs(), mesh)
    dcfg = CopyTaskConfig(vocab=cfg.vocab, seq_len=TRAIN_EP_S,
                          global_batch=WORLD)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    C = _capacity(cfg, TRAIN_EP_S, max(cfg.n_experts, G))
    plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
    per_step = _train_ep_launches(cfg, plan, C)
    fill = _filling_tokens(model, params, mesh, E_loc)
    _, block = batch_split(mesh)
    batch = SyntheticLM(dcfg, mesh=mesh, task="copy", device=DEVICE).next()
    batch["tokens"][:, :TRAIN_EP_FILL] = fill[block]
    out = {"describe": plan.describe(), "C": C, "per_step": per_step,
           "n_chunks": _n_chunks(C, plan.n_chunks)
           if plan.backend == "overlap" else 1,
           "fill": fill, "build_s": build_s,
           **_held(params, opt_state, model, sharding)}

    # (a) the tuned plan's gradients (with the routing it sent: the
    # tokens per expert from this rank), the factorized plan's, and the
    # one-process kernel step on the global batch
    routed = []
    with _routing(record=routed):
        grads, loss, out["counts"] = _ep_loss_grads(model, params, batch,
                                                    mesh, sharding)
    out["routed"] = torch.bincount(routed[0].reshape(-1),
                                   minlength=cfg.n_experts).tolist()
    del routed
    fcfg = cfg.replace(a2a_backend="factorized")
    fplan = moe_a2a_plan(fcfg, mesh, axes, E_loc, C)
    out["fact_per_step"] = _train_ep_launches(fcfg, fplan, C)
    fgrads, floss, out["fact_counts"] = _ep_loss_grads(
        build_model(fcfg), params, batch, mesh, sharding)
    out["tuned_vs_fact"] = _sharded_gaps(grads, fgrads, sharding)
    out["loss"], out["fact_loss"] = loss, floss
    out["finite_nonzero"] = all(
        bool(torch.isfinite(g).all()) and float(g.float().abs().sum()) > 0
        for _, g in tree_leaves(grads))
    del fgrads
    full = sharding.gather_tree(grads)
    del grads
    if rank == 0:
        gparams = model.init(torch.Generator(device=DEVICE)
                             .manual_seed(seed), DEVICE)
        tree_map(lambda t: t.requires_grad_(True), gparams)
        gbatch = make_copy_task_batch(dcfg, 0, DEVICE)
        for v, t in enumerate(fill):       # row block v, as on the mesh
            gbatch["tokens"][v, :TRAIN_EP_FILL] = t
        leaves = tree_leaves(gparams)
        total, _ = model.loss(gparams, gbatch)
        ref = torch.autograd.grad(total, [t for _, t in leaves])
        out["one_loss"] = float(total.detach())
        out["vs_one"] = {path: float((full_g.float() - r.float()).norm()
                                     / r.float().norm())
                         for (path, full_g), r in
                         zip(tree_leaves(full), ref)}
        del gparams, gbatch, ref, total, leaves
    del full
    torch.cuda.empty_cache()
    dist.barrier()           # the other ranks waited for rank 0's reference

    # (d) one loss + backward under each remat policy, from the same
    # parameters and batch: launches, peak memory and host ms each (each
    # resets the peak: the phase's peak so far is kept for (c))
    phase_peak = torch.cuda.max_memory_allocated()
    out["remat"] = _remat_steps(cfg, params, batch, mesh, sharding,
                                (axes, E_loc, C))

    # (c) timed steps at full width, then one profiled on rank 0
    _reset_counts()
    out["step_ms"] = [_host_ms(lambda: step_fn(params, opt_state,
                                               batch))[1]
                      for _ in range(TRAIN_EP_TIMED)]
    out["step_counts"] = _read_counts()
    out["peak_gib"] = max(phase_peak,
                          torch.cuda.max_memory_allocated()) / 2**30
    if rank == 0:
        prof = _profile(lambda: step_fn(params, opt_state, batch),
                        f"train_ep step (1 layer, B=1, S={TRAIN_EP_S} per "
                        f"rank), rank 0 of {WORLD}", top=20)
        out["fsdp_span"] = prof.summary["spans"].get(FSDP_SPAN, (0, 0.0))
    else:
        out["fsdp_span"] = _span_host_ms(
            lambda: step_fn(params, opt_state, batch), FSDP_SPAN)
    torch.cuda.synchronize()
    del model, params, opt_state, step_fn, batch
    torch.cuda.empty_cache()

    # (b) Trainer.run at a cut width, checkpoint at step 2 restored
    scfg = cfg.replace(**TRAIN_EP_CUT)
    smodel, _, sp, so, sstep = build_training(
        scfg, mesh, lr=1e-4, warmup=2, total=TRAIN_EP_STEPS, seed=seed,
        device=DEVICE)
    splan = moe_a2a_plan(scfg, mesh, axes, E_loc, C)
    out["cut_per_step"] = _train_ep_launches(scfg, splan, C)
    out["cut_describe"] = splan.describe()
    ssh = param_shardings(smodel.specs(), mesh)
    sdcfg = CopyTaskConfig(vocab=scfg.vocab, seq_len=TRAIN_EP_S,
                           global_batch=WORLD)
    deltas = []

    def counted_step(p, o, b):
        before = _read_counts()
        res = sstep(p, o, b)
        deltas.append({k: v - before[k] for k, v in _read_counts().items()})
        return res
    ckdir = Path(tmp) / "train_ep_ckpt"
    tcfg = TrainerConfig(total_steps=TRAIN_EP_STEPS,
                         checkpoint_dir=str(ckdir), checkpoint_every=2,
                         keep_checkpoints=1, log_every=1)
    tr = Trainer(tcfg, counted_step,
                 SyntheticLM(sdcfg, mesh=mesh, task="copy", device=DEVICE),
                 sp, so, sharding=ssh)
    _reset_counts()
    tr.run(max_steps=2)        # ends in ckpt.wait(): durable on every rank
    out["written"] = _dir_bytes(ckdir) if rank == 0 else 0
    fresh = Trainer(tcfg, sstep,
                    SyntheticLM(sdcfg, mesh=mesh, task="copy", device=DEVICE),
                    sp, so, sharding=ssh)
    restored = fresh.try_restore()
    same = restored and (fresh.step, fresh.data.step) == (tr.step,
                                                          tr.data.step) == (
        2, 2) and all(a.dtype == b.dtype and a.device == b.device
                      and torch.equal(a, b)
                      for (_, a), (_, b) in zip(
                          tree_leaves(tr._state_tree()),
                          tree_leaves(fresh._state_tree())))
    del fresh
    tr.config.checkpoint_every = TRAIN_EP_STEPS + 1
    status = tr.run()
    out["trainer"] = {
        "restored_equal": bool(same), "status": status, "step": tr.step,
        "deltas": deltas, "losses": [r["total_loss"] for r in
                                     tr.metrics_log],
        "grad_norms": [r["grad_norm"] for r in tr.metrics_log],
        "seconds": [r["seconds"] for r in tr.metrics_log],
        "n_params": sum(t.numel() for _, t in tree_leaves(sp))}
    del smodel, sp, so, tr
    torch.cuda.empty_cache()
    return out


def _remat_steps(cfg, params, batch, mesh, sharding, geometry) -> dict:
    """[train_ep] (d): per policy of TRAIN_EP_REMAT, one loss + backward +
    reduce_grads at full width: its launches and their prediction,
    whether every reduced leaf is the first policy's (``nothing``) bit
    for bit (else the largest relative gap), the peak memory above what
    the rank held before it, and its host ms."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.moe import moe_a2a_plan
    axes, E_loc, C = geometry
    out, base = {}, None
    for policy in TRAIN_EP_REMAT:
        pcfg = cfg.replace(remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        grads, _, counts = _ep_loss_grads(build_model(pcfg), params, batch,
                                          mesh, sharding)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        leaves = [g for _, g in tree_leaves(grads)]
        del grads
        if base is None:
            base, gap = leaves, 0.0
        else:
            gap = max(float((a.float() - b.float()).norm()
                            / b.float().norm().clamp_min(1e-30))
                      for a, b in zip(leaves, base))
        out[policy] = {
            "counts": counts, "ms": ms, "peak_gib": peak,
            "per_step": _train_ep_launches(
                pcfg, moe_a2a_plan(pcfg, mesh, axes, E_loc, C), C),
            "equal": all(torch.equal(a, b) for a, b in zip(leaves, base)),
            "gap": gap}
        del leaves
    del base
    torch.cuda.empty_cache()
    return out


def _digest(t) -> str:
    """sha256 of a tensor's bytes (bit-identity across ranks)."""
    import hashlib
    t = t.detach().contiguous().to("cpu")
    return hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy()
                          ).hexdigest()


@contextlib.contextmanager
def _routing_digests(record: list):
    """``torch.topk`` (the MoE router's) appending the digests of its
    input probabilities and of its indices to ``record``."""
    real = torch.topk

    def topk(x, k, *args, **kwargs):
        out = real(x, k, *args, **kwargs)
        record.append((_digest(x), _digest(out[1])))
        return out
    torch.topk = topk
    try:
        yield
    finally:
        torch.topk = real


def _tp_serve_tokens(vocab: int):
    """[train_tp]'s serving prompts: (TP_BLOCKS, TRAIN_EP_S) prefill
    tokens and (TP_BLOCKS, TP_TICKS) decode tokens, from a seed."""
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.integers(0, vocab, (TP_BLOCKS, TRAIN_EP_S))
                             ).to(DEVICE),
            torch.from_numpy(rng.integers(0, vocab, (TP_BLOCKS, TP_TICKS))
                             ).to(DEVICE))


def _tp_serve(model, params, prefill_toks, decode_toks, mesh=None):
    """Last-position prefill logits (``make_prefill_fn``) and each of
    TP_TICKS greedy-step logits (``make_serve_step``, teacher-forced from
    an empty cache), full-vocab, on the host."""
    from repro_torch.models import make_prefill_fn, make_serve_step
    pre = make_prefill_fn(model, mesh)(params, prefill_toks)
    caches = model.init_caches(decode_toks.shape[0], TP_TICKS, DEVICE,
                               mesh=mesh)
    serve = make_serve_step(model, mesh)
    ticks = []
    for t in range(TP_TICKS):
        _, logits, caches = serve(params, caches, decode_toks[:, t:t + 1])
        ticks.append(logits[:, 0].float().cpu())
    return pre.float().cpu(), torch.stack(ticks, 1)


def _rank_train_tp(rank: int, n: int, seed: int, tmp: str) -> dict:
    """[train_tp] on one rank of the 8-rank world on TP_MESH: the
    one-process reference on rank 0 first (freed before the mesh state
    exists), then ``build_training`` at full width (1 layer), the gated
    loss + backward against it, the bit-identity digests of the model
    ranks, timed and profiled steps, prefill and decode on the mesh, and
    ``Trainer.run`` at a cut width with a checkpoint restored bit for
    bit."""
    import torch.distributed as dist
    from repro_torch.core.cache import cart_create
    from repro_torch.data import (CopyTaskConfig, SyntheticLM,
                                  make_copy_task_batch)
    from repro_torch.launch.train import build_training
    from repro_torch.models import build_model
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map)
    from repro_torch.models.moe import (_capacity, _group_geometry,
                                        moe_a2a_plan)
    from repro_torch.parallel.sharding import (FSDP_SPAN, TP_SPAN,
                                               batch_split, tp_group, tp_rank)
    from repro_torch.runtime import Trainer, TrainerConfig
    torch.cuda.set_device(0)
    mesh = cart_create(n, *TP_MESH, device_type=DEVICE)
    cfg = _train_ep_config()
    model = build_model(cfg)
    dcfg = CopyTaskConfig(vocab=cfg.vocab, seq_len=TRAIN_EP_S,
                          global_batch=TP_BLOCKS)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    C = _capacity(cfg, TRAIN_EP_S, max(cfg.n_experts, G))
    plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
    _, block = batch_split(mesh)
    m = tp_rank(tp_group(mesh))
    prefill_toks, decode_toks = _tp_serve_tokens(cfg.vocab)
    out = {"block": block, "model": m, "describe": plan.describe(), "C": C,
           "n_chunks": _n_chunks(C, plan.n_chunks)
           if plan.backend == "overlap" else 1,
           "per_step": _train_ep_launches(cfg, plan, C)}

    # (0) the one-process reference on rank 0, before any mesh state: the
    # fill tokens, the kernel step's loss and gradients, prefill and
    # decode logits; only what the gates compare stays, on the host
    fill = torch.zeros(G, dtype=torch.int64, device=DEVICE)
    # the router's top-k in each of its calls (forward and remat
    # recompute) of the one-process step, token-major over the global
    # batch: the mesh step replays its row block's rows
    n_router = 2 * cfg.n_layers
    routes = {init: torch.zeros((n_router, TP_BLOCKS * TRAIN_EP_S,
                                 cfg.top_k), dtype=torch.int64,
                                device=DEVICE) for init in TP_INITS}
    torch.cuda.reset_peak_memory_stats()
    if rank == 0:
        gparams = model.init(torch.Generator(device=DEVICE)
                             .manual_seed(seed), DEVICE)
        fill = torch.tensor(_pick_fill(model, gparams, E_loc, G),
                            device=DEVICE)
        gbatch = make_copy_task_batch(dcfg, 0, DEVICE)
        for v, t in enumerate(fill.tolist()):   # row block v's first tokens
            gbatch["tokens"][v, :TRAIN_EP_FILL] = t
        with torch.no_grad():
            out["one_serve"] = _tp_serve(model, gparams, prefill_toks,
                                         decode_toks)
        one_grads, out["one_loss"] = {}, {}
        for init in TP_INITS:
            if init == "fan-in":
                _fan_in_scale(gparams, model.specs(), cfg)
            tree_map(lambda t: t.requires_grad_(True), gparams)
            leaves = tree_leaves(gparams)
            rec = []
            with _routing(record=rec):
                total, _ = model.loss(gparams, gbatch)
                ref = torch.autograd.grad(total, [t for _, t in leaves])
            if len(rec) != n_router:
                fail(f"[train_tp] the one-process step called the router "
                     f"{len(rec)} times, expected {n_router}")
            routes[init] = torch.stack(rec)
            out["one_loss"][init] = float(total.detach())
            one_grads[init] = {path: g.to("cpu")
                               for (path, _), g in zip(leaves, ref)}
            del total, ref, leaves
            tree_map(lambda t: t.requires_grad_(False), gparams)
        out["one_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del gparams, gbatch
        torch.cuda.empty_cache()
    dist.broadcast(fill, src=0)
    # what [rules_mesh] (a) reads in this rank's process: the one-process
    # routing and the fill tokens at the gated init, and on rank 0 the
    # gathered reduced gradients of this step (popped by _tp_world_rank)
    kept = out["kept"] = {}
    for init in TP_INITS:
        dist.broadcast(routes[init], src=0)
        if init == TP_GATED[0]:
            kept["routes"] = routes[init]
        routes[init] = list(routes[init][:, block * TRAIN_EP_S:
                                         (block + 1) * TRAIN_EP_S].unbind(0))
    out["fill"] = fill = kept["fill"] = fill.tolist()
    if min(fill) < 0:
        fail(f"[train_tp] no one of the first {TRAIN_EP_CANDIDATES} tokens "
             f"routes first to every EP rank: {fill}")
    dist.barrier()           # the reference is freed before the mesh state
    torch.cuda.reset_peak_memory_stats()

    # (a) build_training on the mesh; the gated loss + backward, its
    # routing and the bit-identity digests
    t0 = time.perf_counter()
    model, _, params, opt_state, step_fn = build_training(
        cfg, mesh, lr=1e-4, warmup=2, total=TRAIN_EP_STEPS, seed=seed,
        device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["build_s"] = time.perf_counter() - t0
    sharding = param_shardings(model.specs(), mesh)
    batch = SyntheticLM(dcfg, mesh=mesh, task="copy", device=DEVICE).next()
    batch["tokens"][:, :TRAIN_EP_FILL] = fill[block]
    out.update(_held(params, opt_state, model, sharding))
    # whole over model (FSDP shards included): the same bits on the model
    # ranks of a row block
    whole = [p for p, _ in tree_leaves(params)
             if p not in sharding.model_axes]
    out["digests"], out["loss"], out["vs_one"] = {"routing": []}, {}, {}
    for init in TP_INITS:
        if init == "fan-in":
            # (d) serving on the same world at the reference init, before
            # the parameters move: prefill and decode on the mesh, this
            # rank's row block, full-vocab logits
            _reset_counts()
            with torch.no_grad():
                out["serve"] = _tp_serve(model, params,
                                         prefill_toks[block:block + 1],
                                         decode_toks[block:block + 1], mesh)
            out["serve_counts"] = _read_counts()
            _fan_in_scale(params, model.specs(), cfg)
        with _routing(replay=routes[init]) as switched, \
                _routing_digests(out["digests"]["routing"]):
            grads, out["loss"][init], counts = _ep_loss_grads(
                model, params, batch, mesh, sharding)
        out.setdefault("switched", {})[init] = dict(switched)
        if init == TP_INITS[0]:
            out["counts"] = counts
            out["routed"] = torch.bincount(routes[init][0].reshape(-1),
                                           minlength=cfg.n_experts).tolist()
        out["finite_nonzero"] = out.get("finite_nonzero", True) and all(
            bool(torch.isfinite(g).all()) and float(g.float().abs().sum()) > 0
            for _, g in tree_leaves(grads))
        out["digests"][f"grads {init}"] = {
            p: _digest(g) for p, g in tree_leaves(grads) if p in whole}
        full = sharding.gather_tree_to_writer(grads)
        del grads
        if rank == 0 and init == TP_GATED[0]:
            kept["grads"] = full
        if rank == 0:
            out["vs_one"][init] = {
                path: (float((g.float() - one_grads[init][path].float())
                             .norm() / one_grads[init][path].float().norm()),
                       float(g.float().norm()),
                       float(one_grads[init][path].float().norm()))
                for path, g in tree_leaves(full)}
        del full
        torch.cuda.empty_cache()
    if rank == 0:
        del one_grads
    dist.barrier()           # the others waited for rank 0's comparison

    # (c) timed steps at full width, then one profiled on rank 0
    _reset_counts()
    out["step_ms"] = [_host_ms(lambda: step_fn(params, opt_state,
                                               batch))[1]
                      for _ in range(TRAIN_EP_TIMED)]
    out["step_counts"] = _read_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if rank == 0:
        prof = _profile(lambda: step_fn(params, opt_state, batch),
                        f"train_tp step (1 layer, B=1, S={TRAIN_EP_S} per "
                        f"row block), rank 0 of {TP_WORLD}", top=20)
        out["profile"] = prof.summary
        out["tp_span"] = prof.summary["spans"].get(TP_SPAN, (0, 0.0))
        out["fsdp_span"] = prof.summary["spans"].get(FSDP_SPAN, (0, 0.0))
    else:
        out["fsdp_span"] = _span_host_ms(
            lambda: step_fn(params, opt_state, batch), FSDP_SPAN)
    torch.cuda.synchronize()
    out["digests"]["params"] = {p: _digest(t) for p, t
                                in tree_leaves(params) if p in whole}
    del model, params, opt_state, step_fn, batch
    torch.cuda.empty_cache()

    # (b) Trainer.run at a cut width, checkpoint at step 2 restored
    scfg = cfg.replace(**TRAIN_EP_CUT)
    smodel, _, sp, so, sstep = build_training(
        scfg, mesh, lr=1e-4, warmup=2, total=TRAIN_EP_STEPS, seed=seed,
        device=DEVICE)
    splan = moe_a2a_plan(scfg, mesh, axes, E_loc, C)
    out["cut_per_step"] = _train_ep_launches(scfg, splan, C)
    ssh = param_shardings(smodel.specs(), mesh)
    deltas = []

    def counted_step(p, o, b):
        before = _read_counts()
        res = sstep(p, o, b)
        deltas.append({k: v - before[k] for k, v in _read_counts().items()})
        return res
    ckdir = Path(tmp) / "train_tp_ckpt"
    tcfg = TrainerConfig(total_steps=TRAIN_EP_STEPS,
                         checkpoint_dir=str(ckdir), checkpoint_every=2,
                         keep_checkpoints=1, log_every=1)
    tr = Trainer(tcfg, counted_step,
                 SyntheticLM(dcfg, mesh=mesh, task="copy", device=DEVICE),
                 sp, so, sharding=ssh)
    _reset_counts()
    tr.run(max_steps=2)        # ends in ckpt.wait(): durable on every rank
    out["written"] = _dir_bytes(ckdir) if rank == 0 else 0
    fresh = Trainer(tcfg, sstep,
                    SyntheticLM(dcfg, mesh=mesh, task="copy", device=DEVICE),
                    sp, so, sharding=ssh)
    restored = fresh.try_restore()
    same = restored and (fresh.step, fresh.data.step) == (tr.step,
                                                          tr.data.step) == (
        2, 2) and all(a.dtype == b.dtype and a.device == b.device
                      and torch.equal(a, b)
                      for (_, a), (_, b) in zip(
                          tree_leaves(tr._state_tree()),
                          tree_leaves(fresh._state_tree())))
    del fresh
    tr.config.checkpoint_every = TRAIN_EP_STEPS + 1
    status = tr.run()
    out["trainer"] = {
        "restored_equal": bool(same), "status": status, "step": tr.step,
        "deltas": deltas, "losses": [r["total_loss"] for r in
                                     tr.metrics_log],
        "seconds": [r["seconds"] for r in tr.metrics_log],
        "n_params": sum(t.numel() for _, t in tree_leaves(sp))}
    del smodel, sp, so, tr
    torch.cuda.empty_cache()
    return out


def _ulysses_config():
    """[ulysses]'s configuration: [train_tp]'s (phi3.5-moe at full width,
    1 layer, capacity factor 8) with ``use_ulysses``."""
    return _train_ep_config(use_ulysses=True)


def _shard_input(gen_seed: int, shape, scale: float = 1.0):
    """A bf16 tensor on the card drawn from ``gen_seed``: any rank can
    draw any other rank's shard."""
    g = torch.Generator(device=DEVICE).manual_seed(gen_seed)
    return (torch.randn(shape, generator=g, device=DEVICE) * scale
            ).to(torch.bfloat16)


def _ulysses_exchanges(mesh, cfg, block: int) -> dict:
    """[ulysses]'s exchange checks on one rank: the tiled re-shard of the
    path's q shard (1, 32, 512, 128) bf16 against the definition, bit for
    bit, both ways; and the GQA all-gather path (4 / 1 heads, hd 128,
    S 1024: Hkv < sp) against the flash kernel on the whole sequence."""
    from repro_torch.kernels import ops
    from repro_torch.parallel.ulysses import sp_comm, ulysses_attention
    comm = sp_comm(mesh, cfg)
    sp, me = comm.p, comm.rank
    S_loc, hd = TRAIN_EP_S // sp, cfg.hd
    x = [_shard_input(9000 + 16 * block + j, (1, cfg.n_heads, S_loc, hd))
         for j in range(sp)]
    hq = cfg.n_heads // sp
    plan = comm.all_to_all((1, hq, S_loc, hd), torch.bfloat16,
                           backend="factorized")
    got = plan.tiled(x[me], 1, 2)
    want = torch.cat([t[:, me * hq:(me + 1) * hq] for t in x], dim=2)
    back = plan.tiled(got, 2, 1, reverse=True)
    ok = {"reshard": torch.equal(got, want),
          "reshard back": torch.equal(back, x[me])}
    Hq, Hkv = ULYSSES_GQA
    qkv = [[_shard_input(9500 + 16 * block + 4 * j + i,
                         (1, h, S_loc, hd)) for j in range(sp)]
           for i, h in enumerate((Hq, Hkv, Hkv))]
    _reset_counts()
    out = ulysses_attention(*(t[me] for t in qkv), cfg, causal=True,
                            mesh=mesh)
    launches = _read_counts()["flash_attention"]
    whole = ops.attention(*(torch.cat(t, dim=2) for t in qkv), causal=True)
    err = compare(f"[ulysses] GQA all-gather path (heads {Hq}/{Hkv}, sp "
                  f"{sp}) vs the flash kernel on the whole sequence", out,
                  whole[:, :, me * S_loc:(me + 1) * S_loc].contiguous(),
                  TOL[torch.bfloat16])
    return {"ok": ok, "gqa_err": err, "gqa_launches": launches}


def _rank_ulysses(rank: int, n: int, seed: int) -> dict:
    """[ulysses] on one rank of [train_tp]'s world, after it: the
    one-process reference on rank 0 first (prefill and decode logits,
    the loss + backward with its routing, at the fan-in init; freed
    before the mesh state exists), then ``build_training`` under
    ``use_ulysses`` on TP_MESH, serving and the gated loss + backward on
    the mesh, one timed step, and the exchange checks."""
    import torch.distributed as dist
    from repro_torch.core.cache import cart_create
    from repro_torch.data import (CopyTaskConfig, SyntheticLM,
                                  make_copy_task_batch)
    from repro_torch.launch.train import build_training
    from repro_torch.models import build_model
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map)
    from repro_torch.models.moe import (_capacity, _group_geometry,
                                        moe_a2a_plan)
    from repro_torch.parallel.sharding import batch_split, tp_group, tp_rank
    torch.cuda.set_device(0)
    mesh = cart_create(n, *TP_MESH, device_type=DEVICE)
    cfg = _ulysses_config()
    model = build_model(cfg)
    dcfg = CopyTaskConfig(vocab=cfg.vocab, seq_len=TRAIN_EP_S,
                          global_batch=TP_BLOCKS)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    C = _capacity(cfg, TRAIN_EP_S, max(cfg.n_experts, G))
    plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
    _, block = batch_split(mesh)
    prefill_toks, decode_toks = _tp_serve_tokens(cfg.vocab)
    out = {"block": block, "model": tp_rank(tp_group(mesh)),
           "per_step": _train_ep_launches(cfg, plan, C)}
    n_router = 2 * cfg.n_layers
    routes = torch.zeros((n_router, TP_BLOCKS * TRAIN_EP_S, cfg.top_k),
                         dtype=torch.int64, device=DEVICE)
    t0 = time.perf_counter()
    if rank == 0:
        gparams = _fan_in_init(model, cfg, seed)
        gbatch = make_copy_task_batch(dcfg, 0, DEVICE)
        with torch.no_grad():
            out["one_serve"] = _tp_serve(model, gparams, prefill_toks,
                                         decode_toks)
        tree_map(lambda t: t.requires_grad_(True), gparams)
        leaves = tree_leaves(gparams)
        rec = []
        with _routing(record=rec):
            total, _ = model.loss(gparams, gbatch)
            ref = torch.autograd.grad(total, [t for _, t in leaves])
        if len(rec) != n_router:
            fail(f"[ulysses] the one-process step called the router "
                 f"{len(rec)} times, expected {n_router}")
        routes = torch.stack(rec)
        out["one_loss"] = float(total.detach())
        one_grads = {path: g.to("cpu") for (path, _), g in zip(leaves, ref)}
        del gparams, gbatch, total, ref, leaves
        torch.cuda.empty_cache()
    dist.broadcast(routes, src=0)
    routes = list(routes[:, block * TRAIN_EP_S:
                         (block + 1) * TRAIN_EP_S].unbind(0))
    dist.barrier()           # the reference is freed before the mesh state
    out["one_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    model, _, params, opt_state, step_fn = build_training(
        cfg, mesh, lr=1e-4, warmup=2, total=TRAIN_EP_STEPS, seed=seed,
        device=DEVICE)
    _fan_in_scale(params, model.specs(), cfg)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    sharding = param_shardings(model.specs(), mesh)
    out["partial"] = sorted(sharding.partial)
    out["model_axes"] = sorted(sharding.model_axes)
    out.update(_held(params, opt_state, model, sharding))
    batch = SyntheticLM(dcfg, mesh=mesh, task="copy", device=DEVICE).next()
    whole = [p for p, _ in tree_leaves(params)
             if p not in sharding.model_axes]
    _reset_counts()
    with torch.no_grad():
        out["serve"], out["serve_ms"] = _host_ms(lambda: _tp_serve(
            model, params, prefill_toks[block:block + 1],
            decode_toks[block:block + 1], mesh))
    out["serve_counts"] = _read_counts()
    out["digests"] = {"routing": []}
    t0 = time.perf_counter()
    with _routing(replay=routes) as switched, \
            _routing_digests(out["digests"]["routing"]):
        grads, out["loss"], out["counts"] = _ep_loss_grads(
            model, params, batch, mesh, sharding)
    out["grad_s"] = time.perf_counter() - t0
    out["switched"] = dict(switched)
    out["finite_nonzero"] = all(
        bool(torch.isfinite(g).all()) and float(g.float().abs().sum()) > 0
        for _, g in tree_leaves(grads))
    out["digests"]["grads"] = {p: _digest(g) for p, g in tree_leaves(grads)
                               if p in whole}
    full = sharding.gather_tree_to_writer(grads)
    del grads
    if rank == 0:
        out["vs_one"] = {
            path: (float((g.float() - one_grads[path].float()).norm()
                         / one_grads[path].float().norm()),
                   float(g.float().norm()),
                   float(one_grads[path].float().norm()))
            for path, g in tree_leaves(full)}
        del one_grads
    del full
    dist.barrier()           # the others waited for rank 0's comparison
    _reset_counts()
    _, out["step_ms"] = _host_ms(lambda: step_fn(params, opt_state, batch))
    out["step_counts"] = _read_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["digests"]["params"] = {p: _digest(t) for p, t
                                in tree_leaves(params) if p in whole}
    out["exchanges"] = _ulysses_exchanges(mesh, cfg, block)
    del model, params, opt_state, step_fn, batch
    torch.cuda.empty_cache()
    return out


def _drawn_shard(model, sharding, seed: int, rank: int, n: int):
    """This rank's shard of ``_fan_in_init(model, model.cfg, seed)``
    without the whole tree on the card: each global leaf drawn from the
    seeded generator in the order ``model.init`` draws them, rescaled
    (:func:`_fan_in_leaf`), cut to this rank's slice
    (``ExpertSharding.local``) and the rest freed.  The ``n`` ranks of
    the world draw one after another, a barrier between turns, so the
    card holds one rank's transient leaf at a time.  Collective."""
    import torch.distributed as dist
    cfg = model.cfg

    def walk(specs, prefix, gen):
        tree = {}
        for key, spec in specs.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(spec, dict):
                tree[key] = walk(spec, path, gen)
                continue
            t = spec.initializer(gen, DEVICE, cfg.pdtype)
            _fan_in_leaf(path, t, spec.shape, cfg)
            tree[key] = sharding.local(path, t)
            del t
        return tree

    out = None
    for turn in range(n):
        if turn == rank:
            out = walk(model.specs(), "",
                       torch.Generator(device=DEVICE).manual_seed(seed))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


@contextlib.contextmanager
def _tp_calls(mesh):
    """Counts the tensor-parallel collectives (the all-reduces and
    all-gathers over ``mesh``'s ``model`` group: what the span
    repro_torch.tp.all_reduce wraps) run inside, with their host ms, in
    the yielded ``[calls, ms]``; without the profiler's cost."""
    import torch.distributed as dist
    from repro_torch.parallel.sharding import tp_group
    pg, seen = tp_group(mesh).pg, [0, 0.0]
    real = {name: getattr(dist, name)
            for name in ("all_reduce", "all_gather_into_tensor")}

    def counted(fn):
        def call(*args, group=None, **kwargs):
            if group is not pg:
                return fn(*args, group=group, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, group=group, **kwargs)
            seen[0] += 1
            seen[1] += (time.perf_counter() - t0) * 1e3
            return out
        return call
    for name, fn in real.items():
        setattr(dist, name, counted(fn))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _rm_serve(model, params, prefill_toks, decode_toks, mesh=None,
              record=None, replay=None) -> dict:
    """Last-position prefill logits (``make_prefill_fn``) and each greedy
    tick's (``make_serve_step``, teacher-forced from an empty cache of
    ``decode_toks``' length), full-vocab, on the host, with the host ms
    of the prefill and of each tick; the router's choices recorded into
    ``record`` or replayed from ``replay`` (:func:`_routing`).  On a mesh
    the TP collectives (calls, host ms: :func:`_tp_calls`) of the prefill
    and of the ticks too.  Returns those and the decode state's
    shapes."""
    from repro_torch.models import make_prefill_fn, make_serve_step
    from repro_torch.models.common import tree_leaves
    T = decode_toks.shape[1]
    prefill = make_prefill_fn(model, mesh)
    serve = make_serve_step(model, mesh)

    def run(fn):
        if mesh is None:
            return fn(), (0, 0.0)
        with _tp_calls(mesh) as seen:
            out = fn()
        return out, tuple(seen)

    def ticks_from(caches):
        ticks, tick_ms = [], []
        for t in range(T):
            (_, logits, caches), ms = _host_ms(lambda: serve(
                params, caches, decode_toks[:, t:t + 1]))
            ticks.append(logits[:, 0].float().cpu())
            tick_ms.append(ms)
        return torch.stack(ticks, 1), tick_ms

    with torch.no_grad(), _routing(record=record, replay=replay) if (
            record is not None or replay is not None) \
            else contextlib.nullcontext() as switched:
        (pre, pre_ms), tp_pre = run(lambda: _host_ms(
            lambda: prefill(params, prefill_toks)))
        caches = model.init_caches(decode_toks.shape[0], T, DEVICE,
                                   mesh=mesh)
        shapes = {p: tuple(t.shape) for p, t in tree_leaves(
            caches["states"])}
        (ticks, tick_ms), tp_ticks = run(lambda: ticks_from(caches))
    return {"pre": pre.float().cpu(), "ticks": ticks, "pre_ms": pre_ms,
            "tick_ms": tick_ms, "shapes": shapes, "tp_prefill": tp_pre,
            "tp_ticks": tp_ticks, "switched": dict(switched or {})}


def _rm_jamba_config():
    """[recurrent_mesh] (a)'s configuration: jamba at full width, one
    superblock, capacity factor RM_JAMBA_CF."""
    from repro_torch.configs import get_config
    return get_config(JAMBA).replace(n_layers=JAMBA_LAYERS,
                                     capacity_factor=RM_JAMBA_CF)


def _rm_jamba_geometry(cfg, mesh) -> dict:
    """Per rank in (a): each MoE call's capacity C, plan and chunks for
    the prefill (S tokens) and a tick (1 token); the launches of the
    prefill and of the ticks (one flash ``wgmma`` a prefill; 3 gmm a
    chunk a MoE layer, ``wgmma`` in the prefill and ``decode`` in the
    ticks, on the rank's slice of F; the reorder passes of each exchange
    both ways); and the TP collectives (span repro_torch.tp.all_reduce)
    a prefill and a tick: the embedding's sum, 2 a mamba layer (``x_proj``
    and ``out_proj``), 1 an attention and a dense FFN layer, 1 a chunk a
    MoE layer, and the logits' gather."""
    from repro_torch.models.moe import (_capacity, _group_geometry,
                                        moe_a2a_plan, moe_tp_group)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    fcfg = cfg.replace(d_ff=cfg.d_ff // moe_tp_group(cfg, mesh).size)
    moe, attn = _moe_layers(cfg), _attn_layers(cfg)
    mamba = sum(m == "mamba" for m, _ in cfg.superblock) * cfg.n_superblocks
    dense = cfg.n_layers - moe
    out = {}
    for what, T, calls in (("prefill", RM_JAMBA[1], 1),
                           ("ticks", 1, RM_JAMBA[2])):
        C = _capacity(cfg, T, max(cfg.n_experts, G))
        plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
        n = _n_chunks(C, plan.n_chunks) if plan.backend == "overlap" else 1
        gmm = _gmm_launches(fcfg, E_loc, G * C // n, n)
        passes = _sum_launches(_dense_launches(plan, False, n),
                               _dense_launches(plan, True, n))
        flash = attn if what == "prefill" else 0
        out[what] = {
            "C": C, "backend": plan.backend, "n_chunks": n,
            "launches": _expected(
                flash_attention=flash, flash_attention_wgmma=flash,
                **{k: calls * moe * v for k, v in gmm.items()},
                **{k: calls * moe * v for k, v in passes.items()}),
            "tp_calls": 1 + 2 * mamba + attn + dense + moe * n + 1}
    return out


def _rank_rm_jamba(rank: int, n: int, seed: int, mesh) -> dict:
    """[recurrent_mesh] (a) on one rank: jamba's shard drawn leaf by leaf
    (:func:`_drawn_shard`), a mesh prefill of its row block's sequence
    and RM_JAMBA ticks, the router's choices recorded, the launches
    counted, and the TP collectives of the prefill and the ticks.  The
    one-process runs are the main process's, after the world."""
    from repro_torch.models import build_model
    from repro_torch.models.common import param_shardings, tree_leaves
    from repro_torch.parallel.sharding import batch_split, tp_group, tp_rank
    cfg = _rm_jamba_config()
    B, S, T = RM_JAMBA
    model = build_model(cfg)
    sh = param_shardings(model.specs(), mesh)
    _, block = batch_split(mesh)
    torch.cuda.reset_peak_memory_stats()
    clock = _Clock()
    params, draw_ms = _host_ms(lambda: _drawn_shard(model, sh, seed, rank,
                                                    n))
    clock("draw")
    tokens = prefill_tokens(cfg, B, S)[block:block + 1]
    ticks = _tp_serve_tokens(cfg.vocab)[1][block:block + 1, :T]
    geometry = _rm_jamba_geometry(cfg, mesh)
    routes = []
    _reset_counts()
    served = _rm_serve(model, params, tokens, ticks, mesh, record=routes)
    counts = _read_counts()
    clock("prefill and ticks")
    out = {"times": clock.laps, "block": block,
           "model": tp_rank(tp_group(mesh)),
           "n_params": sum(t.numel() for _, t in tree_leaves(params)),
           "layout_params": _layout_params(model, sh),
           "paired": sorted(sh.model_groups), "draw_ms": draw_ms,
           "geometry": geometry, "counts": counts,
           "routes": [r.cpu() for r in routes],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           **served}
    del params, model
    torch.cuda.empty_cache()
    return out


def _rank_rm_xlstm(rank: int, n: int, seed: int, mesh) -> dict:
    """[recurrent_mesh] (b) on one rank, in f32 (in bf16 the roundings
    alone move xlstm's gradients by 50-100% of their norm: PERF.md §6):
    rank 0 first runs the one-process reference (prefill and ticks, then
    one ``make_train_step`` step on the global batch) and frees it; then
    the mesh's shard drawn leaf by leaf, prefill and ticks on the mesh
    (their TP collectives counted), and one step on the rank's row
    block, whose gradients and parameters, gathered to rank 0, are held
    against the reference's there."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import CopyTaskConfig, make_copy_task_batch
    from repro_torch.models import build_model, make_train_step
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map)
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.parallel.sharding import batch_split, tp_group, tp_rank
    cfg = get_config(XLSTM).replace(n_layers=XLSTM_CUT_LAYERS,
                                    param_dtype="float32",
                                    compute_dtype="float32")
    model = build_model(cfg)
    sh = param_shardings(model.specs(), mesh)
    _, block = batch_split(mesh)
    gbatch = make_copy_task_batch(CopyTaskConfig(
        vocab=cfg.vocab, seq_len=RM_XLSTM_S, global_batch=TP_BLOCKS), 0,
        DEVICE)
    pre_toks, dec_toks = _tp_serve_tokens(cfg.vocab)
    pre_toks = pre_toks[:, :RM_XLSTM_S]
    out = {"block": block, "model": tp_rank(tp_group(mesh)),
           "paired": sorted(sh.model_groups)}
    clock = _Clock()

    def step_of(params, batch, mesh=None):
        tree_map(lambda t: t.requires_grad_(True), params)
        opt = _Recorded(AdamW(AdamWConfig(lr=1e-3)))
        state = opt.init(params)
        params, state, m = make_train_step(model, opt, mesh)(params, state,
                                                             batch)
        return params, state, opt.grads, {k: float(v) for k, v in m.items()}

    if rank == 0:
        gp = _fan_in_init(model, cfg, seed)
        one = {"serve": _rm_serve(model, gp, pre_toks, dec_toks)}
        gp, state, grads, one["metrics"] = step_of(gp, gbatch)
        one.update(grads={p: g.cpu() for p, g in tree_leaves(grads)},
                   params={p: t.detach().cpu() for p, t in tree_leaves(gp)})
        del gp, state, grads
        torch.cuda.empty_cache()
    dist.barrier()           # the reference is freed before the mesh state
    clock("one-process reference")
    torch.cuda.reset_peak_memory_stats()
    params = _drawn_shard(model, sh, seed, rank, n)
    out["n_params"] = sum(t.numel() for _, t in tree_leaves(params))
    out["layout_params"] = _layout_params(model, sh)
    clock("draw")
    _reset_counts()
    out["serve"] = _rm_serve(model, params, pre_toks[block:block + 1],
                             dec_toks[block:block + 1], mesh)
    clock("prefill and ticks")
    batch = {k: v[block:block + 1] for k, v in gbatch.items()}
    (params, state, grads, out["metrics"]), out["step_ms"] = _host_ms(
        lambda: step_of(params, batch, mesh))
    out["counts"] = _read_counts()
    clock("step")
    out["finite_nonzero"] = all(
        bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
        for _, g in tree_leaves(grads))
    whole = [p for p, _ in tree_leaves(params) if p not in sh.model_axes]
    out["digests"] = {what: {p: _digest(t) for p, t in tree_leaves(tree)
                             if p in whole}
                      for what, tree in (("grads", grads),
                                         ("params", params))}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["state_gb"] = sum(t.numel() * t.element_size() for _, t in
                          tree_leaves({"p": params, "o": state})) / 1e9
    gap = lambda a, b: float((a - b).norm() / b.norm())
    for what, tree in (("grads", grads), ("params", params)):
        full = sh.gather_tree_to_writer(tree)
        if rank == 0:
            out[f"vs_one_{what}"] = {p: gap(t, one[what][p])
                                     for p, t in tree_leaves(full)}
        del full
    clock("gathers")
    if rank == 0:
        out["one"] = {"metrics": one["metrics"], "serve": one["serve"]}
    out["times"] = clock.laps
    del params, state, grads
    torch.cuda.empty_cache()
    return out


class _Clock:
    """Host seconds between calls, by label (``laps``)."""

    def __init__(self):
        self.t, self.laps = time.perf_counter(), {}

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.laps[label] = now - self.t
        self.t = now


def _rank_rm_jamba_u(rank: int, n: int, seed: int, mesh, routes) -> dict:
    """[recurrent_mesh] (c) on one rank: (a)'s jamba under use_ulysses
    (its attention layer sequence-parallel over model, every attention
    leaf whole over model; the mixers, the MoE and the head split as in
    (a)), its shard drawn anew, the same row block's prefill and ticks
    replaying (a)'s routing on this rank (the residual stream is whole between blocks, so the MoE sees
    (a)'s rows), the launches counted and every ``kernels.ops.attention``
    call's q shape recorded."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import param_shardings, tree_leaves
    from repro_torch.parallel.sharding import batch_split, tp_group, tp_rank
    cfg = _rm_jamba_config().replace(use_ulysses=True)
    B, S, T = RM_JAMBA
    model = build_model(cfg)
    sh = param_shardings(model.specs(), mesh)
    _, block = batch_split(mesh)
    torch.cuda.reset_peak_memory_stats()
    clock = _Clock()
    params, draw_ms = _host_ms(lambda: _drawn_shard(model, sh, seed, rank,
                                                    n))
    clock("draw")
    tokens = prefill_tokens(cfg, B, S)[block:block + 1]
    ticks = _tp_serve_tokens(cfg.vocab)[1][block:block + 1, :T]
    q_shapes, real = [], ops.attention

    def attention(q, *args, **kwargs):
        q_shapes.append(tuple(q.shape))
        return real(q, *args, **kwargs)
    _reset_counts()
    ops.attention = attention
    try:
        served = _rm_serve(model, params, tokens, ticks, mesh,
                           replay=[r.to(DEVICE) for r in routes])
    finally:
        ops.attention = real
    counts = _read_counts()
    clock("prefill and ticks")
    out = {"times": clock.laps, "block": block,
           "model": tp_rank(tp_group(mesh)),
           "n_params": sum(t.numel() for _, t in tree_leaves(params)),
           "layout_params": _layout_params(model, sh),
           "partial": sorted(sh.partial), "draw_ms": draw_ms,
           "geometry": _rm_jamba_geometry(cfg, mesh), "counts": counts,
           "q_shapes": q_shapes,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **served}
    del params, model
    torch.cuda.empty_cache()
    return out


def _rank_recurrent_mesh(rank: int, n: int, seed: int) -> dict:
    """[recurrent_mesh] on one rank of [train_tp]'s world, after
    [ulysses]: (b) xlstm's step and serving, (a) jamba's serving, then
    (c) jamba's serving under use_ulysses."""
    from repro_torch.core.cache import cart_create
    torch.cuda.set_device(0)
    mesh = cart_create(n, *TP_MESH, device_type=DEVICE)
    t0 = time.perf_counter()
    out = {"xlstm": _rank_rm_xlstm(rank, n, seed, mesh),
           "jamba": _rank_rm_jamba(rank, n, seed, mesh)}
    t1 = time.perf_counter()
    out["jamba_u"] = _rank_rm_jamba_u(rank, n, seed, mesh,
                                      out["jamba"]["routes"])
    out["jamba_u"]["seconds"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


@contextlib.contextmanager
def _em_calls(mesh):
    """The TP collectives (:func:`_tp_calls`) and FSDP's gathers and
    gradient reduce-scatters (``parallel.sharding._FSDPGather``'s forward
    and backward) run inside, each with its host ms, in the yielded
    ``{"tp": [calls, ms], "fsdp_gather": [...], "fsdp_reduce": [...]}``;
    zeros without a mesh."""
    from repro_torch.parallel import sharding
    seen = {"tp": [0, 0.0], "fsdp_gather": [0, 0.0],
            "fsdp_reduce": [0, 0.0]}
    if mesh is None:
        yield seen
        return
    cls = sharding._FSDPGather
    real = {"forward": cls.forward, "backward": cls.backward}

    def counted(fn, key):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            seen[key][0] += 1
            seen[key][1] += (time.perf_counter() - t0) * 1e3
            return out
        return staticmethod(call)
    cls.forward = counted(real["forward"], "fsdp_gather")
    cls.backward = counted(real["backward"], "fsdp_reduce")
    try:
        with _tp_calls(mesh) as tp:
            yield seen
            seen["tp"] = list(tp)
    finally:
        cls.forward, cls.backward = (staticmethod(real["forward"]),
                                     staticmethod(real["backward"]))


def _em_counted(fn, mesh):
    """``fn()`` with its launches, collectives (:func:`_em_calls`) and
    host ms: ``(out, {"counts", "calls", "ms"})``."""
    _reset_counts()
    with _em_calls(mesh) as calls:
        out, ms = _host_ms(fn)
    return out, {"counts": _read_counts(), "calls": calls, "ms": ms}


def _em_batch(cfg, B: int, S: int, seed: int = 4) -> dict:
    """[encdec_mesh]'s global training batch: the copy task at (B, S) and
    ``frontend_embeds`` from a seed."""
    from repro_torch.data import CopyTaskConfig, make_copy_task_batch
    batch = make_copy_task_batch(CopyTaskConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B), 0, DEVICE)
    batch["frontend_embeds"] = frontend_embeds(cfg, B, seed)
    return batch


def _em_serve(model, params, tokens, frames, ticks=None, mesh=None) -> dict:
    """``make_prefill_fn``'s full-vocab last-position logits over
    ``tokens`` after ``frames``, and, for the encoder-decoder, the
    encoder's memory of ``frames`` and a greedy tick a column of
    ``ticks`` (``make_serve_step``, teacher-forced from an empty cache)
    reading it: logits on the host, launches, collectives and host ms of
    the prefill, the encode and the ticks."""
    from repro_torch.models import make_prefill_fn, make_serve_step
    prefill = make_prefill_fn(model, mesh)
    out = {}
    with torch.no_grad():
        pre, out["prefill"] = _em_counted(
            lambda: prefill(params, tokens, frames), mesh)
        out["pre"] = pre.float().cpu()
        if ticks is None:
            return out
        memory, out["encode"] = _em_counted(
            lambda: model.encode(params, frames, mesh=mesh), mesh)
        B, T = ticks.shape
        caches = model.init_caches(B, T, DEVICE, mesh=mesh)
        out["cache_k"] = tuple(caches["states"]["k"].shape)
        serve = make_serve_step(model, mesh)

        def run():
            nonlocal caches
            got, ms = [], []
            for t in range(T):
                (_, logits, caches), dt = _host_ms(lambda: serve(
                    params, caches, ticks[:, t:t + 1], memory))
                got.append(logits[:, 0].float().cpu())
                ms.append(dt)
            return torch.stack(got, 1), ms
        (out["ticks"], out["tick_ms"]), out["tick_calls"] = _em_counted(
            run, mesh)
    return out


def _em_grads(model, params, batch, opt=None, mesh=None, sh=None) -> dict:
    """One ``make_train_step`` AdamW step (``opt`` given) or one loss +
    backward, its gradients reduced over the mesh (``reduce_grads``):
    the gradients and parameters, the loss, launches, collectives and
    host ms."""
    from repro_torch.models import make_loss_fn, make_train_step, reduce_grads
    from repro_torch.models.common import tree_leaves, tree_with_leaves
    from repro_torch.parallel.sharding import batch_group

    def step():
        if opt is not None:
            rec = _Recorded(opt)
            new, _, m = make_train_step(model, rec, mesh)(
                params, rec.init(params), batch)
            return rec.grads, new, float(m["total_loss"])
        leaves = tree_leaves(params)
        total, _ = make_loss_fn(model, mesh)(params, batch)
        got = torch.autograd.grad(total, [t for _, t in leaves])
        grads = tree_with_leaves(params, {p: g for (p, _), g in
                                          zip(leaves, got)})
        if mesh is not None:
            grads = reduce_grads(grads, sh, batch_group(mesh))
        return grads, params, float(total.detach())
    (grads, new, loss), info = _em_counted(step, mesh)
    return {"grads": grads, "params": new, "loss": loss, **info}


def _em_case(rank: int, n: int, seed: int, mesh, cfg, B: int, S: int,
             T: int | None, opt_lr: float | None, one: dict | None,
             keep: dict | None = None) -> dict:
    """One [encdec_mesh] case on one rank of TP_MESH at bf16, the fan-in
    init from ``seed``: unless ``one`` (an earlier case's one-process
    results for the same parameters and inputs, kept by that case in
    ``keep["one"]``) is given, rank 0 first
    runs the one-process reference on the global batch (prefill, the
    ticks where ``T``, the gradients) and frees it; then every rank
    draws its shard, serves its row block and takes one training step
    (AdamW at ``opt_lr``, else a loss + backward) on it; rank 0 holds
    the gathered reduced gradients against the reference's (relative
    norm per leaf).  Returns what the gates read, the one-process
    results on rank 0."""
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map)
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.parallel.sharding import batch_split, tp_group, tp_rank
    model = build_model(cfg)
    sh = param_shardings(model.specs(), mesh)
    _, block = batch_split(mesh)
    rows = slice(block * (B // TP_BLOCKS), (block + 1) * (B // TP_BLOCKS))
    gbatch = _em_batch(cfg, B, S)
    tokens = prefill_tokens(cfg, B, S)
    ticks = None if T is None else torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab, (B, T))).to(DEVICE)
    opt = lambda: None if opt_lr is None else AdamW(AdamWConfig(lr=opt_lr))
    clock = _Clock()
    if rank == 0 and one is None:
        gp = _fan_in_init(model, cfg, seed)
        one = {"serve": _em_serve(model, gp, tokens,
                                  gbatch["frontend_embeds"], ticks)}
        tree_map(lambda t: t.requires_grad_(True), gp)
        g = _em_grads(model, gp, gbatch, opt())
        one.update(grads={p: t.float().cpu() for p, t in
                          tree_leaves(g["grads"])},
                   loss=g["loss"], step_counts=g["counts"],
                   step_ms=g["ms"])
        del gp, g
        torch.cuda.empty_cache()
        if keep is not None:
            keep["one"] = one
    dist.barrier()           # the reference is freed before the mesh state
    clock("one-process reference")
    torch.cuda.reset_peak_memory_stats()
    params = _drawn_shard(model, sh, seed, rank, n)
    tree_map(lambda t: t.requires_grad_(True), params)
    clock("draw")
    out = {"block": block, "model": tp_rank(tp_group(mesh)),
           "want": _em_expected(cfg, sh),
           "n_params": sum(t.numel() for _, t in tree_leaves(params)),
           "layout_params": _layout_params(model, sh),
           "fsdp_leaves": len(sh.fsdp_axes),
           "serve": _em_serve(model, params, tokens[rows],
                              gbatch["frontend_embeds"][rows],
                              None if ticks is None else ticks[rows], mesh)}
    clock("serve")
    g = _em_grads(model, params, {k: v[rows] for k, v in gbatch.items()},
                  opt(), mesh, sh)
    clock("step")
    whole = [p for p, _ in tree_leaves(params) if p not in sh.model_axes]
    out.update(loss=g["loss"], step={k: g[k] for k in ("counts", "calls",
                                                       "ms")},
               finite_nonzero=all(
                   bool(torch.isfinite(t).all()) and float(t.abs().sum()) > 0
                   for _, t in tree_leaves(g["grads"])),
               digests={what: {p: _digest(t) for p, t in tree_leaves(tree)
                               if p in whole}
                        for what, tree in (("grads", g["grads"]),
                                           ("params", g["params"]))})
    full = sh.gather_tree_to_writer(g["grads"])
    if rank == 0:
        out["vs_one"] = {p: float((t.float().cpu() - one["grads"][p]).norm()
                                  / one["grads"][p].norm())
                         for p, t in tree_leaves(full)}
        out["one"] = {k: v for k, v in one.items() if k != "grads"}
    del full, g, params
    clock("gathers")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["times"] = clock.laps
    torch.cuda.empty_cache()
    return out


def _rank_encdec_mesh(rank: int, n: int, seed: int) -> dict:
    """[encdec_mesh] on one rank of the 8-rank world, after
    [recurrent_mesh]: (a) whisper-tiny trained (one AdamW step) and
    served; (a') the same under Ulysses, held against (a)'s one-process
    run; (b) internvl2-2b cut to EM_INTERNVL[0] layers, one loss +
    backward and a prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.cache import cart_create
    torch.cuda.set_device(0)
    mesh = cart_create(n, *TP_MESH, device_type=DEVICE)
    t0 = time.perf_counter()
    B, S, T = EM_WHISPER
    cfg = get_config(WHISPER)
    keep = {}
    out = {"whisper": _em_case(rank, n, seed, mesh, cfg, B, S, T, 1e-3,
                               None, keep)}
    one = keep.get("one", {})
    out["ulysses"] = _em_case(rank, n, seed, mesh,
                              cfg.replace(use_ulysses=True), B, S, None,
                              None, one)
    layers, B, S = EM_INTERNVL
    out["internvl"] = _em_case(rank, n, seed, mesh, get_config(
        INTERNVL).replace(n_layers=layers), B, S, None, None, None)
    out["seconds"] = time.perf_counter() - t0
    return out


def _rank_ring(rank: int, n: int) -> dict:
    """[ring] on one rank of the 4-rank world: ring attention on a
    (model=4) mesh at phi3.5's attention shapes, bf16, causal and with a
    window, against the flash kernel on the whole sequence (every rank
    draws every shard)."""
    from repro_torch.core.cache import cart_create
    from repro_torch.kernels import ops
    from repro_torch.parallel.ring_attention import ring_attention
    mesh = cart_create(n, *RING_MESH, device_type=DEVICE)
    m = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["model"]
    B, Hq, Hkv, S, hd = RING_SHAPE
    Sl = S // n
    qkv = [[_shard_input(7000 + 4 * j + i, (B, h, Sl, hd))
            for j in range(n)] for i, h in enumerate((Hq, Hkv, Hkv))]
    out = {"errs": {}, "ms": {}}
    for window in (None, RING_WINDOW):
        got, out["ms"][window] = _host_ms(lambda: ring_attention(
            *(t[m] for t in qkv), causal=True, window=window, mesh=mesh))
        whole = ops.attention(*(torch.cat(t, dim=2) for t in qkv),
                              causal=True, window=window)
        out["errs"][window] = compare(
            f"[ring] rank {rank} window {window} vs the flash kernel on the "
            f"whole sequence", got,
            whole[:, :, m * Sl:(m + 1) * Sl].contiguous(),
            TOL[torch.bfloat16])
    return out


def _pipe_stage_fn(p, x):
    """One pipeline stage: residual MLP layers ``x + tanh(x w1) w2``."""
    for w1, w2 in zip(p["w1"], p["w2"]):
        x = x + torch.tanh(x @ w1) @ w2
    return x


def _rank_pipeline(rank: int, n: int) -> dict:
    """[pipeline] on one rank of the 4-rank world: the GPipe schedule over
    a (pod=4) mesh, each stage 2 residual MLP layers at D 4096, H 6400,
    bf16, 4 microbatches; the forward and this stage's gradients against
    the sequential run of all stages on this rank."""
    from repro_torch.core.cache import cart_create
    from repro_torch.parallel.pipeline import (bubble_fraction,
                                               make_pipelined_forward)
    mesh = cart_create(n, *PIPE_MESH, device_type=DEVICE)
    stage = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["pod"]
    L, D, H, rows, M = PIPE_SHAPE
    ws = [{"w1": _shard_input(8000 + 2 * s, (L, D, H), D ** -0.5),
           "w2": _shard_input(8001 + 2 * s, (L, H, D), H ** -0.5)}
          for s in range(n)]
    x = _shard_input(8100, (rows, D))
    g = _shard_input(8101, (rows, D)).float()
    for w in ws:
        for t in w.values():
            t.requires_grad_(True)
    run = make_pipelined_forward(_pipe_stage_fn, mesh, axis="pod",
                                 n_microbatches=M)
    y, ms = _host_ms(lambda: run(ws[stage], x))
    got = torch.autograd.grad((y.float() * g).sum(),
                              (ws[stage]["w1"], ws[stage]["w2"]))
    seq = x
    for w in ws:
        seq = _pipe_stage_fn(w, seq)
    want = torch.autograd.grad((seq.float() * g).sum(),
                               (ws[stage]["w1"], ws[stage]["w2"]))
    err = compare(f"[pipeline] stage {stage} forward vs the sequential run",
                  y.detach(), seq.detach(), TOL[torch.bfloat16], of_max=True)
    gaps = [float((a.float() - b.float()).norm() / b.float().norm())
            for a, b in zip(got, want)]
    return {"stage": stage, "err": err, "max": float(seq.detach().abs().max()),
            "gaps": gaps, "ms": ms, "bubble": bubble_fraction(n, M)}


# ---------------------------------------------------------------------------
# phase 11b: the pencil FFT
# ---------------------------------------------------------------------------


def _median_ms(fn, x) -> float:
    """Median host ms of ``FFT_TIMED`` calls of ``fn(x)`` after one
    warm-up, each ending in a synchronise."""
    fn(x)
    torch.cuda.synchronize()
    return float(np.median([_host_ms(lambda: fn(x))[1]
                            for _ in range(FFT_TIMED)]))


def _fft_launches(fft, inverse: bool) -> dict:
    """Block-reorder launches of one forward or inverse call: each stage
    transpose's dense plan once (chunked under the overlap engine)."""
    out = []
    for plan in fft.plans:
        n = 1
        if plan.backend in ("overlap", "pipelined"):
            n = _n_chunks(math.prod(plan.block_shape), plan.inner.n_chunks)
        out.append(_dense_launches(plan.inner, inverse, n))
    return _sum_launches(*out)


def _moved_bytes(plan) -> float:
    """Bytes a rank sends to other ranks in one transpose: (p-1)/p of its
    pencil in the direct exchange, (D_k-1)/D_k of it in each round of
    the dimension-wise ones."""
    active = [d for d in plan.dims if d > 1]
    share = 1 - 1 / plan.p if plan.backend == "direct" \
        else sum((d - 1) / d for d in active)
    return plan.pencil_bytes * share


def _launch_diff(after: dict, before: dict) -> dict:
    return {op: after[op] - before[op] for op in REORDER_OPS}


def _fft_case(tag: str, fft, xg, ref, scale: float, ok: dict):
    """One FFT on this rank's pencil of ``xg``: the forward pencil within
    ``FFT_TOL`` of the largest |coefficient| ``scale`` of ``ref`` (the
    one-process transform in complex128), the round trip within
    ``FFT_TOL`` of the largest |input|, each call's reorder launches
    those of its plans' ``round_schedule``; then the median host ms of a
    forward, an inverse and each stage transpose.  Returns the numbers
    and the forward pencil."""
    fwd, inv = fft.forward_fn(), fft.inverse_fn()
    x = xg[fft.in_index()].contiguous()
    before = _reorder_launches()
    y = fwd(x)
    torch.cuda.synchronize()
    mid = _reorder_launches()
    back = inv(y)
    torch.cuda.synchronize()
    counts = [_launch_diff(mid, before),
              _launch_diff(_reorder_launches(), mid)]
    err = float((y.to(torch.complex128) - ref[fft.out_index()]).abs()
                .max()) / scale
    rt = float((back - x).abs().max()) / float(x.abs().max())
    ok[f"{tag}: forward within {FFT_TOL} of the largest coefficient"] = \
        err <= FFT_TOL
    ok[f"{tag}: round trip within {FFT_TOL}"] = rt <= FFT_TOL \
        and back.dtype == x.dtype
    want = [_fft_launches(fft, False), _fft_launches(fft, True)]
    ok[f"{tag}: reorder launches {counts} == round_schedule's {want}"] = \
        counts == want
    del back
    res = {"err": err, "rt": rt, "launches": counts,
           "backends": [p.backend for p in fft.plans],
           "fwd_ms": _median_ms(fwd, x), "inv_ms": _median_ms(inv, y),
           "transposes": []}
    for k in range(fft.g - 1, -1, -1):
        plan = fft.plans[k]
        z = torch.zeros(plan.in_shape, dtype=y.dtype, device=DEVICE)
        res["transposes"].append(
            (k, plan.backend, plan.pencil_bytes, _moved_bytes(plan),
             _median_ms(plan.apply, z)))
        del z
    return res, y


def _fft_traced(fft, x, y, ok: dict) -> dict:
    """[tracing] (fft): one traced forward of (b)'s factorized slab on
    this rank's pencil ``x``, bit for bit its untraced forward ``y``, with
    the CPU test's span tree; the per-round host µs and the call's
    measured / predicted ratio."""
    import torch_fft
    from repro_torch.core import telemetry
    telemetry.reset_telemetry()
    tr = telemetry.enable_tracing()
    try:
        yt = fft.forward_fn()(x)
        torch.cuda.synchronize()
    finally:
        telemetry.disable_tracing()
    spans = tr.spans()
    telemetry.reset_telemetry()
    ok["(b) traced forward equal to the untraced one"] = torch.equal(yt, y)
    ok["(b) traced span tree as the CPU test's"] = \
        torch_fft._span_shape(spans) == torch_fft.expected_span_tree(fft)
    ex = next(sp for sp in spans if sp.name == "plan.execute")
    return {"rounds": [(sp.attrs["axis"], sp.duration * 1e6)
                       for sp in spans if sp.name == "plan.round"],
            "ratio": ex.attrs["measured_seconds"]
            / ex.attrs["predicted_seconds"]}


def _rank_fft(rank: int, n: int, seed: int) -> dict:
    """[fft] on one rank of the 4-rank world, (data, pod) = (2, 2): (a)
    the 512³ complex64 pencil under tuned and factorized, (b) the same
    array as a slab over both axes (direct, factorized natural and
    paper, bit for bit; a traced forward), (c) the real (512, 512, 510)
    pencil, (d) the 8192² slab, (e) the distributed convolution at
    jamba's mixer width.  Every rank draws every global array from the
    seed on the card and holds its pencils against the one-process
    transform."""
    from repro_torch.configs import get_config
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.models import spectral
    from repro_torch.models.common import init_params
    from repro_torch.workloads import pencil_fft
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    names = ("data", "pod")
    mesh = cart_create(n, (2, 2), names, device_type=DEVICE)
    comm = torus_comm(mesh, names)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ok, out = {}, {"cases": {}}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()

    # (a), (b): the 512³ complex64 array
    shape = (FFT_N,) * 3
    xg = torch.randn(shape, generator=gen, device=DEVICE,
                     dtype=torch.complex64)
    ref = torch.fft.fftn(xg.to(torch.complex128))
    scale = float(ref.abs().max())
    for backend in ("tuned", "factorized"):
        out["cases"][f"(a) pencil {backend}"], _ = _fft_case(
            f"(a) {backend}", pencil_fft(comm, shape, backend=backend), xg,
            ref, scale, ok)
    ys = {}
    for variant, backend in (("natural", "direct"),
                             ("natural", "factorized"),
                             ("paper", "factorized")):
        fft = pencil_fft(torus_comm(mesh, names, variant=variant), shape,
                         grid=(names,), backend=backend)
        tag = f"(b) slab {backend} {variant}"
        out["cases"][tag], ys[tag] = _fft_case(tag, fft, xg, ref, scale, ok)
        if backend == "factorized":
            ok[f"{tag}: reorder launches not zero"] = \
                sum(out["cases"][tag]["launches"][0].values()) > 0
        if variant == "natural" and backend == "factorized":
            out["tracing"] = _fft_traced(
                fft, xg[fft.in_index()].contiguous(), ys[tag], ok)
    direct = ys.pop("(b) slab direct natural")
    for tag, y in ys.items():
        ok[f"{tag}: equal to direct bit for bit"] = torch.equal(y, direct)
    del xg, ref, ys, direct
    torch.cuda.empty_cache()

    # (c): the real pencil, the rfft axis's bins split over pod
    xr = torch.randn(FFT_REAL, generator=gen, device=DEVICE)
    ref = torch.fft.rfftn(xr.double())
    out["cases"]["(c) real pencil"], _ = _fft_case(
        "(c) real", pencil_fft(comm, FFT_REAL, real=True), xr, ref,
        float(ref.abs().max()), ok)
    del xr, ref
    torch.cuda.empty_cache()

    # (d): the 2-D complex64 slab
    x2 = torch.randn((FFT_2D, FFT_2D), generator=gen, device=DEVICE,
                     dtype=torch.complex64)
    ref = torch.fft.fftn(x2.to(torch.complex128))
    out["cases"]["(d) 2-D slab"], _ = _fft_case(
        "(d) 2-D slab", pencil_fft(comm, (FFT_2D, FFT_2D)), x2, ref,
        float(ref.abs().max()), ok)
    del x2, ref
    torch.cuda.empty_cache()

    # (e): the sequence-sharded convolution at jamba's mixer width
    cfg = get_config(JAMBA)
    B, S = FFT_CONV
    E = cfg.ssm_expand * cfg.d_model
    p = init_params(spectral.spectral_specs(cfg), gen, DEVICE, torch.float32)
    kernel = spectral.ssm_kernel(p, S)
    del p
    x = torch.randn((B, S, E), generator=gen, device=DEVICE)
    got, first_ms = _host_ms(
        lambda: spectral.distributed_fft_causal_conv(comm, x, kernel))
    want = spectral.fft_causal_conv(x, kernel)
    rows = 2 * S // n
    lo = comm.rank * rows
    part = want[:, lo:lo + got.shape[1]]
    gap = float((got - part).abs().max()) if got.numel() else 0.0
    top = float(want.abs().max())
    ok[f"(e) rows {tuple(got.shape)} of the one-process conv within "
       f"{FFT_CONV_TOL} of the largest |output|"] = \
        got.shape == part.shape and gap <= FFT_CONV_TOL * top
    out["conv"] = {"E": E, "gap": gap, "max": top, "rows": got.shape[1],
                   "ms": _median_ms(lambda a: spectral
                                    .distributed_fft_causal_conv(comm, a,
                                                                 kernel), x),
                   "one_ms": _median_ms(lambda a: spectral.fft_causal_conv(
                       a, kernel), x)}
    del x, kernel, got, want, part
    torch.cuda.empty_cache()
    out["counts"] = _read_counts()
    out["ok"] = {k: bool(v) for k, v in ok.items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t0
    return out


def _disagg_requests(vocab: int) -> list:
    """[serve_disagg]'s requests, made anew for each run (a run appends
    to them): seeded prompts in two tenants."""
    from repro_torch.runtime.serving import Request
    n, tenants, _ = DISAGG_REQS
    rng = np.random.default_rng(5)
    lo, hi = DISAGG_PROMPT
    return [Request(i, [int(t) for t in rng.integers(
        0, vocab, int(rng.integers(lo, hi + 1)))], DISAGG_GEN,
        tenant=f"t{i % tenants}") for i in range(n)]


def _disagg_run(model, params, cfg, comm, backend: str, rebuild_at=None):
    """One traced [serve_disagg] (a) / (b) run on this rank: the server,
    its ``done``, host ms, ``decode_step`` calls, launches, the
    ``serve.kv_migrate`` spans that moved rows, and the predicted
    reorder launches of one handoff."""
    from repro_torch.core import telemetry
    from repro_torch.launch.serve import batcher_step, serve_disaggregated
    from repro_torch.models import make_serve_step
    step = batcher_step(make_serve_step(model))
    calls = [0]

    def counted(params, toks, caches):
        calls[0] += 1
        return step(params, toks, caches)

    telemetry.reset_telemetry()
    telemetry.enable_tracing()
    _reset_counts()
    n_pre, n_dec = DISAGG_BATCH
    srv, secs = serve_disaggregated(
        model, params, _disagg_requests(cfg.vocab), comm,
        max_seq=DISAGG_PROMPT[1] + DISAGG_GEN, decode_batch=n_dec,
        device=DEVICE, serve_step=counted, rebuild_at=rebuild_at,
        n_prefill=2, prefill_batch=n_pre, chunk=4,
        default_quota=DISAGG_REQS[2], backend=backend)
    torch.cuda.synchronize()
    counts = _read_counts()
    spans = [s for s in telemetry.get_tracer().spans()
             if s.name == "serve.kv_migrate" and s.attrs.get("migrated")]
    throttled = telemetry.metrics().counter(
        "serving.admission_throttled").value
    telemetry.reset_telemetry()
    plan = srv.topology.plan
    return {"srv": srv, "done": dict(srv.done), "ticks": srv.ticks,
            "ms": secs * 1e3, "steps": calls[0], "counts": counts,
            "handoff_ms": [s.duration * 1e3 for s in spans],
            "throttled": throttled, "lost": srv.lost,
            "per_handoff": _alltoallv_launches(plan.inner, False),
            "describe": plan.describe(),
            "migrations": srv.topology.migrations,
            "migrated_rows": srv.topology.migrated_rows}


def _rank_serve_disagg(rank: int, n: int, seed: int) -> dict:
    """[serve_disagg] on one rank of the 4-rank world: (a) three traced
    runs (one a backend), (b) the tuned run with rank 3 lost at tick 8,
    (c) one full-depth handoff at phi's real row through each backend.
    Rank 0 also serves the requests colocated, the reference of (a) and
    (b)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.launch.serve import serve_colocated
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    names = ("data", "pod")
    mesh = cart_create(n, (2, 2), names, device_type=DEVICE)
    comm = torus_comm(mesh, names)
    full = get_config(ARCH)
    cfg = full.replace(n_layers=DISAGG_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE)
    out, ok = {"runs": {}}, {}
    max_seq = DISAGG_PROMPT[1] + DISAGG_GEN
    if rank == 0:
        batcher, secs = serve_colocated(
            model, params, _disagg_requests(cfg.vocab),
            max_batch=DISAGG_BATCH[0], max_seq=max_seq, device=DEVICE)
        out["colocated"] = {"done": dict(batcher.done),
                            "ticks": batcher.ticks, "ms": secs * 1e3}
    for backend in DISAGG_BACKENDS:
        r = _disagg_run(model, params, cfg, comm, backend)
        srv = r.pop("srv")
        ok[f"(a) {backend}: migrations > 0"] = r["migrations"] > 0
        ok[f"(a) {backend}: plan kind kv_migrate"] = \
            r["describe"]["kind"] == "kv_migrate"
        row_bytes = srv.topology.plan.row_bytes
        r["block_bytes"] = srv.topology.plan.p * srv.topology.plan.bucket \
            * row_bytes
        r["row_bytes"] = row_bytes
        r["rank_role"] = "prefill" if rank < srv.topology.n_prefill \
            else "decode"
        del srv
        out["runs"][backend] = r
    # (b): rank 3 leaves at tick 8; the survivors rebuild and finish
    r = _disagg_run(model, params, cfg, comm, "tuned",
                    rebuild_at=DISAGG_LOST)
    r.pop("srv")
    out["rebuild"] = r
    dist.barrier()              # rank 3 waits here for the survivors
    del model, params
    torch.cuda.empty_cache()

    # (c): one handoff at phi's full-depth row
    comm = torus_comm(mesh, names)
    F = full.n_layers * (2 * full.n_kv_heads * full.hd + 1)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    sent = {(0, 2): torch.randn((KV_HANDOFF[0], F), generator=gen,
                                device=DEVICE),
            (1, 3): torch.randn((KV_HANDOFF[1], F), generator=gen,
                                device=DEVICE)}
    out["handoff"] = {"F": F, "ms": {}, "kinds": {}}
    x = None
    for backend in DISAGG_BACKENDS:
        plan = comm.kv_migration((F,), max_count=max(KV_HANDOFF),
                                 n_prefill=2, backend=backend)
        counts = plan.pair_counts({k: v.shape[0] for k, v in sent.items()})
        if x is None:
            x = torch.zeros((plan.p, plan.bucket, F), device=DEVICE)
            for (s, d), rows in sent.items():
                if s == rank:
                    x[d, :rows.shape[0]] = rows
        _zero_reorder_launches()
        torch.cuda.synchronize()
        dist.barrier()
        t1 = time.perf_counter()
        recv, rc = plan.forward(
            x, torch.as_tensor(counts[rank], device=DEVICE))
        torch.cuda.synchronize()
        out["handoff"]["ms"][backend] = (time.perf_counter() - t1) * 1e3
        out["handoff"]["kinds"][backend] = (plan.inner_kind, plan.backend)
        ok[f"(c) {backend}: recv_counts the count matrix's column"] = \
            rc.cpu().tolist() == counts[:, rank].tolist()
        ok[f"(c) {backend}: reorder launches as round_schedule"] = \
            _reorder_launches() == _alltoallv_launches(plan.inner, False)
        for (s, d), rows in sent.items():
            if d == rank:
                ok[f"(c) {backend}: rows {s} -> {d} bit for bit"] = \
                    torch.equal(recv[s, :rows.shape[0]], rows)
        del recv
    out["handoff"]["block_gb"] = x.numel() * 4 / 1e9
    del x, sent
    torch.cuda.empty_cache()
    out["ok"] = {k: bool(v) for k, v in ok.items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t0
    return out


def _timed(fn, *args) -> dict:
    """``fn(*args)``'s result with its host seconds under ``"seconds"``."""
    t0 = time.perf_counter()
    out = fn(*args)
    out["seconds"] = time.perf_counter() - t0
    return out


def _tp_world_rank(rank: int, n: int, seed: int, tmp: str) -> dict:
    """One rank of the 8-rank world on TP_MESH: [train_tp], [ulysses],
    [recurrent_mesh], [encdec_mesh], then [rules_mesh] (a) and (b), in
    which ranks 4-7 leave."""
    train_tp = _rank_train_tp(rank, n, seed, tmp)
    kept = train_tp.pop("kept")
    return {"train_tp": train_tp,
            "ulysses": _timed(_rank_ulysses, rank, n, seed),
            "recurrent_mesh": _rank_recurrent_mesh(rank, n, seed),
            "encdec_mesh": _rank_encdec_mesh(rank, n, seed),
            "rules_mesh": _timed(_rank_rules_mesh, rank, n, seed, tmp,
                                 kept)}


def run_tp_world(seed: int, timeout: float = 1000.0) -> list:
    """Spawn the 8-rank world of [train_tp], [ulysses], [recurrent_mesh],
    [encdec_mesh] and [rules_mesh] (as :func:`run_world`) and return each
    rank's result."""
    import os
    import torch_dist
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_TUNING_DB"] = str(Path(tmp) / "tuning.json")
        try:
            return torch_dist.run_world(_tp_world_rank, TP_WORLD, tmp, seed,
                                        tmp, timeout=timeout)
        except (AssertionError, TimeoutError) as exc:
            fail(f"the {TP_WORLD}-rank world: {exc}")


def _world_rank(rank: int, n: int, seed: int, tmp: str) -> dict:
    """One rank of the 4-rank gloo world: phases 6 to 11c (``tmp`` is the
    world's shared directory, [train_ep]'s and [elastic]'s checkpoints go
    there).  [elastic] comes last: ranks 2 and 3 leave in it."""
    torch.cuda.set_device(0)
    return {"collective": _rank_collective(rank, n),
            "autotune": _rank_autotune(rank, n),
            "moe_ep": _rank_moe_ep(rank, n, seed),
            "overlap_grad": _rank_overlap_grad(rank, n),
            "moe_ep_grok": _rank_moe_ep_grok(rank, n, seed),
            "moe_dropless": _rank_moe_dropless(rank, n, seed),
            "tracing": _rank_tracing(rank, n, seed),
            "train_ep": _rank_train_ep(rank, n, seed, tmp),
            "ring": _timed(_rank_ring, rank, n),
            "pipeline": _timed(_rank_pipeline, rank, n),
            "fft": _rank_fft(rank, n, seed),
            "serve_disagg": _rank_serve_disagg(rank, n, seed),
            "elastic": _rank_elastic(rank, n, seed, tmp)}


def _rank_elastic(rank: int, n: int, seed: int, tmp: str) -> dict:
    """[elastic] on one rank: (a) the communicator leg at full width, (b)
    the elastic Trainer leg at the cut width.  In each a device loss
    takes out ranks 2 and 3, which then make no call while the survivors
    rebuild and go on; the legs are independent (as the reference's
    ``check_rebuild.py`` parts are), so a barrier of the whole world,
    after (a), starts (b) on all four ranks."""
    import torch.distributed as dist
    out = {"comm": _elastic_comm(rank, n, seed)}
    dist.barrier()
    out["trainer"] = _elastic_trainer(rank, n, seed, tmp)
    return out


def _elastic_comm(rank: int, n: int, seed: int) -> dict:
    """[elastic] (a): [moe_ep]'s layer on the (data=2, pod=2) mesh loses
    ranks 2, 3 on its plan's 3rd call; the watchdog says recover; the
    survivors rebuild the EP comm (``TorusComm.rebuild``, timed and
    traced) and run the layer on the survivors' torus, 8 experts a rank,
    on their [moe_ep] tokens: its output, launches, the all-to-all
    against the definition, the plan slice freed, the tuning records
    migrated against the count the surviving extents predict."""
    from repro_torch.core import plan as planmod
    from repro_torch.core import telemetry
    from repro_torch.core.autotune import (TuningDB, _operand, autotune,
                                           db_fingerprint,
                                           fingerprint_digest)
    from repro_torch.core.cache import cart_create
    from repro_torch.core.comm import torus_comm
    from repro_torch.core.dims import dims_create
    from repro_torch.core.faults import (DeviceLossError, FaultInjector,
                                         FaultSpec)
    from repro_torch.models.moe import (_capacity, _group_geometry,
                                        moe_a2a_plan, moe_block, moe_ep_comm)
    from repro_torch.runtime.watchdog import StragglerWatchdog
    cfg = _ep_config()
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type=DEVICE)
    # a winner over one axis whose extent survives (pod: 2), beside
    # [autotune]'s over both axes (whose data extent does not)
    autotune(mesh, ("pod",), ELASTIC_TUNE_BLOCK, cfg.cdtype,
             include_factorizations=False, budget_seconds=TUNE_BUDGET_S)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    C = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, G))
    comm = moe_ep_comm(cfg, mesh, axes)
    plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
    p = _ep_weights(cfg, comm.rank, E_loc, seed)
    _, x = _ep_inputs(cfg, rank, seed)
    other = torus_comm((5,), ("k",))
    kept = other.all_to_all((4,), torch.float32, backend="direct")
    inj = FaultInjector((FaultSpec("device_loss", at_call=3,
                                   devices=ELASTIC_LOST),))
    inj.install(plan)
    err = None
    for _ in range(3):
        try:
            moe_block(p, x, cfg, mesh=mesh)
        except DeviceLossError as e:
            err = e
            break
    inj.uninstall(plan)
    del p
    torch.cuda.synchronize()
    out = {"fired": inj.fired, "devices": None if err is None
           else list(err.devices)}
    if rank in ELASTIC_LOST:
        return {**out, "left": True}
    out["left"] = False
    out["action"] = StragglerWatchdog().policy(
        3, 0.0, verdict="device_loss").kind
    survivors = [r for r in mesh.mesh.flatten().tolist()
                 if r not in err.devices]
    want_dims = tuple(reversed(dims_create(len(survivors), comm.d)))
    extent = dict(zip(comm.axis_names, want_dims))
    prefix = f"fp:{fingerprint_digest(db_fingerprint(mesh))}|"
    out["migrate_predicted"] = sum(
        1 for key, rec in TuningDB().load().items()
        if key.startswith(prefix) and rec.get("axis_names")
        and all(extent.get(a) == int(d)
                for a, d in zip(rec["axis_names"], rec["dims"])))
    dead_keys = set(comm._plan_keys)
    telemetry.reset_telemetry()
    tracer = telemetry.enable_tracing()
    t0 = time.perf_counter()
    fresh = comm.rebuild(survivors)
    out["rebuild_s"] = time.perf_counter() - t0
    telemetry.disable_tracing()
    span = [sp for sp in tracer.spans() if sp.name == "comm.rebuild"]
    out["span_ms"] = [sp.duration * 1e3 for sp in span]
    out["rebuilds"] = telemetry.metrics().counter("comm.rebuilds").value
    telemetry.reset_telemetry()
    out.update(dims=fresh.dims, want_dims=want_dims,
               describe=fresh.describe(), migrated=fresh.tuning_migrated,
               slice_gone=not any(k in planmod._PLANS for k in dead_keys),
               dead_plans=len(dead_keys),
               kept_same=other.all_to_all((4,), torch.float32,
                                          backend="direct") is kept)
    # the layer on the survivors' torus
    mesh_b = fresh.mesh
    axes_b, G_b, E_loc_b, _ = _group_geometry(cfg, mesh_b)
    C_b = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, G_b))
    plan_b = moe_a2a_plan(cfg, mesh_b, axes_b, E_loc_b, C_b)
    n_b = _n_chunks(C_b, plan_b.n_chunks) if plan_b.backend == "overlap" \
        else 1
    p = _ep_weights(cfg, fresh.rank, E_loc_b, seed)
    torch.cuda.synchronize()
    _reset_counts()
    (y, aux), out["layer_ms"] = _host_ms(lambda: moe_block(p, x, cfg,
                                                           mesh=mesh_b))
    out["counts"] = _read_counts()
    out["predicted"] = _expected(
        **_gmm_launches(cfg, E_loc_b, G_b * C_b // n_b, n_b),
        **_sum_launches(_dense_launches(plan_b, False, n_b),
                        _dense_launches(plan_b, True, n_b)))
    out.update(y=y.float().cpu().numpy(), aux=float(aux), E_loc=E_loc_b,
               C=C_b, plan=plan_b.describe(), n_chunks=n_b)
    del p, y
    # its all-to-all against the definition, both directions
    block = (E_loc_b, C_b, cfg.d_model)
    xb = _operand(G_b, block, cfg.cdtype, fresh.rank, torch.device(DEVICE))
    want = _definition(G_b, block, cfg.cdtype, fresh.rank)
    out["a2a_equal"] = torch.equal(plan_b.forward(xb), want) \
        and torch.equal(plan_b.reverse(xb), want)
    del xb, want
    torch.cuda.empty_cache()
    return out


def _elastic_trainer(rank: int, n: int, seed: int, tmp: str,
                     dims=((2, 2), ("data", "pod")), lost=ELASTIC_LOST,
                     name: str = "elastic") -> dict:
    """[elastic] (b): ``Trainer(elastic=True)`` on the (data=2, pod=2) mesh
    at [train_ep]'s Trainer cut width, ELASTIC_STEPS steps, a synchronous
    checkpoint every ELASTIC_EVERY, ranks 2, 3 lost at ELASTIC_LOSS_AT;
    the survivors recover onto ``launch.mesh.survivor_mesh`` and finish.
    Then their state against a direct restore of the step-3 checkpoint
    onto the survivor mesh followed by the same steps.  [rules_mesh] (b)
    runs the same on TP_MESH (``dims``) with ranks 5, 6 lost
    (``lost``), a row block of the copy task per ``(pod, data)``
    coordinate."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import telemetry
    from repro_torch.core.cache import cart_create
    from repro_torch.core.faults import FaultInjector, FaultSpec
    from repro_torch.data import CopyTaskConfig, SyntheticLM
    from repro_torch.launch.mesh import survivor_mesh
    from repro_torch.launch.train import build_training
    from repro_torch.models import make_train_step
    from repro_torch.models.common import (param_shardings, tree_leaves,
                                           tree_map)
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.watchdog import StragglerWatchdog
    from repro_torch.parallel.sharding import batch_split
    mesh = cart_create(n, *dims, device_type=DEVICE)
    scfg = _train_ep_config(**TRAIN_EP_CUT)
    model, opt, sp, so, sstep = build_training(
        scfg, mesh, lr=1e-4, warmup=2, total=ELASTIC_STEPS, seed=seed,
        device=DEVICE)
    sdcfg = CopyTaskConfig(vocab=scfg.vocab, seq_len=TRAIN_EP_S,
                           global_batch=batch_split(mesh)[0])
    inj = FaultInjector((FaultSpec("device_loss", at_call=ELASTIC_LOSS_AT,
                                   devices=lost),))
    built = {}

    def rebuild_fn(trainer, err):
        t0 = time.perf_counter()
        mesh_b = survivor_mesh(mesh, err.devices, scfg.n_experts)
        trainer.train_step = make_train_step(model, opt, mesh_b)
        trainer.data = SyntheticLM(sdcfg, mesh=mesh_b, task="copy",
                                   device=DEVICE)
        built.update(mesh=mesh_b, step=trainer.train_step)
        sharding = param_shardings(model.specs(), mesh_b)
        built["rebuild_s"] = time.perf_counter() - t0
        return sharding

    ckdir = Path(tmp) / f"{name}_ckpt"
    # the reference's check_rebuild.py watchdog: no timing verdict fires
    tr = Trainer(TrainerConfig(total_steps=ELASTIC_STEPS,
                               checkpoint_dir=str(ckdir),
                               checkpoint_every=ELASTIC_EVERY,
                               keep_checkpoints=2, log_every=1,
                               async_checkpoint=False, elastic=True),
                 inj.wrap(sstep, "train_step"),
                 SyntheticLM(sdcfg, mesh=mesh, task="copy", device=DEVICE),
                 sp, so, sharding=param_shardings(model.specs(), mesh),
                 watchdog=StragglerWatchdog(slow_factor=50.0,
                                            hang_factor=1e4,
                                            hang_floor_seconds=120.0),
                 rebuild_fn=rebuild_fn)
    telemetry.reset_telemetry()
    _reset_counts()
    t0 = time.perf_counter()
    status = tr.run()
    run_s = time.perf_counter() - t0
    out = {"status": status, "step": tr.step, "counts": _read_counts(),
           "fired": inj.fired}
    if status == "lost":
        return out
    del sp, so
    out.update(
        recoveries=tr.recoveries_done, run_s=run_s,
        rebuild_s=built["rebuild_s"],
        rebuilds=telemetry.metrics().counter("comm.rebuilds").value,
        events=[e[0] for e in tr.watchdog.events],
        logged=[r["step"] for r in tr.metrics_log],
        losses=[r["total_loss"] for r in tr.metrics_log],
        seconds=[r["seconds"] for r in tr.metrics_log],
        mesh=[int(r) for r in built["mesh"].mesh.flatten().tolist()],
        dims=dict(zip(built["mesh"].mesh_dim_names,
                      built["mesh"].mesh.shape)),
        writer=tr.sharding.writer,
        written=_dir_bytes(ckdir) if tr.sharding.writer else 0)
    telemetry.reset_telemetry()
    # the direct restore of the step-3 checkpoint onto the survivor mesh,
    # then the same steps
    mgr = CheckpointManager(ckdir, sharding=tr._state_sharding())
    tree, extra, _ = mgr.restore(tr._state_tree(), step=ELASTIC_EVERY)
    params, opt_state = tree["params"], tree["opt_state"]
    tree_map(lambda t: t.requires_grad_(True), params)
    data = SyntheticLM(sdcfg, mesh=built["mesh"], task="copy",
                       device=DEVICE)
    data.load_state_dict(extra["data"])
    for _ in range(ELASTIC_STEPS - ELASTIC_EVERY):
        params, opt_state, _ = built["step"](params, opt_state, data.next())
    out["direct_equal"] = all(
        a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves(tr._state_tree()),
            tree_leaves({"params": params, "opt_state": opt_state})))
    del tr, params, opt_state, tree, model
    torch.cuda.empty_cache()
    return out


def _rank_rules_mesh(rank: int, n: int, seed: int, tmp: str,
                     kept: dict) -> dict:
    """[rules_mesh] (a) and (b) on one rank of the 8-rank world on
    TP_MESH, after every other phase of it.  (a): for each rule set of
    RULES_MESH, ``build_training`` at [train_tp]'s width and cuts from
    the same seed, rescaled to the fan-in init, one loss + backward on
    [train_tp]'s global batch (this rank's row block under the rules)
    replaying [train_tp]'s one-process routing (``kept``: what
    :func:`_rank_train_tp` kept); the launches, the digests of the
    leaves no ``model`` rank splits, and on rank 0 each gathered reduced
    gradient against [train_tp]'s default-rules step.
    (b): the elastic Trainer of [elastic] (b) on TP_MESH, ranks 5 and 6
    lost; ranks 4 and 7 leave with them."""
    import torch.distributed as dist
    from repro_torch.core.cache import cart_create
    from repro_torch.data import CopyTaskConfig, make_copy_task_batch
    from repro_torch.launch.train import build_training
    from repro_torch.models.common import param_shardings, tree_leaves
    from repro_torch.models.moe import (_capacity, _group_geometry,
                                        moe_a2a_plan)
    from repro_torch.parallel.sharding import ShardingRules, batch_split
    torch.cuda.set_device(0)
    mesh = cart_create(n, *TP_MESH, device_type=DEVICE)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    cfg = _train_ep_config()
    dcfg = CopyTaskConfig(vocab=cfg.vocab, seq_len=TRAIN_EP_S,
                          global_batch=TP_BLOCKS)
    gbatch = make_copy_task_batch(dcfg, 0, DEVICE)
    for v, t in enumerate(kept["fill"]):        # [train_tp]'s batch
        gbatch["tokens"][v, :TRAIN_EP_FILL] = t
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    out = {"coord": (coord["pod"], coord["data"]), "model": coord["model"],
           "cases": {}}
    for tag, kw in RULES_MESH.items():
        rules = ShardingRules().override(**kw)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, _, params, opt_state, _ = build_training(
            cfg, mesh, rules, lr=1e-4, warmup=2, total=TRAIN_EP_STEPS,
            seed=seed, device=DEVICE)
        del opt_state
        _fan_in_scale(params, model.specs(), cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sharding = param_shardings(model.specs(), mesh, rules)
        blocks, block = batch_split(mesh, rules)
        rows = TP_BLOCKS // blocks
        tokens = slice(block * rows * TRAIN_EP_S,
                       (block + 1) * rows * TRAIN_EP_S)
        batch = {k: v[block * rows:(block + 1) * rows]
                 for k, v in gbatch.items()}
        C = _capacity(cfg, rows * TRAIN_EP_S, max(cfg.n_experts, G))
        plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
        dist.barrier()          # rank 0 compared the last case's gradients
        with _routing(replay=list(kept["routes"][:, tokens]
                                  .unbind(0))) as switched:
            (grads, loss, counts), ms = _host_ms(lambda: _ep_loss_grads(
                model, params, batch, mesh, sharding, rules))
        same = [p for p, _ in tree_leaves(grads)
                if p not in sharding.model_axes
                and "model" not in sharding.fsdp_kept.get(p, ())]
        res = {"block": block, "rows": rows, "loss": loss, "ms": ms,
               "build_s": build_s, "counts": counts, "C": C,
               "backend": plan.backend,
               "per_step": _train_ep_launches(cfg, plan, C),
               "switched": dict(switched),
               "kept": sorted(set(sharding.fsdp_kept.values())),
               "repeats": sorted({sharding.repeats(p)
                                  for p, _ in tree_leaves(grads)}),
               "n_params": sum(t.numel() for _, t in tree_leaves(params)),
               "layout_params": _layout_params(model, sharding),
               "digests": {p: _digest(g) for p, g in tree_leaves(grads)
                           if p in same},
               "finite_nonzero": all(
                   bool(torch.isfinite(g).all())
                   and float(g.float().abs().sum()) > 0
                   for _, g in tree_leaves(grads))}
        full = sharding.gather_tree_to_writer(grads)
        del grads
        if rank == 0:           # leaf by leaf on the card
            want = dict(tree_leaves(kept["grads"]))
            res["vs_tp"] = {}
            for path, g in tree_leaves(full):
                g, w = g.to(DEVICE).float(), want[path].to(DEVICE).float()
                res["vs_tp"][path] = float((g - w).norm() / w.norm())
                del g, w
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del full, params, model
        torch.cuda.empty_cache()
        out["cases"][tag] = res
    kept.clear()
    dist.barrier()
    # (b) last: ranks 4-7 leave here
    out["elastic"] = _elastic_trainer(rank, n, seed, tmp, dims=TP_MESH,
                                      lost=RULES_LOST, name="rules_mesh")
    return out


def _rank_overlap_grad(rank: int, n: int) -> dict:
    """[rules_mesh] (c) on one rank of the 4-rank world: [moe_ep]'s plan
    (the tuned overlap engine on the (data=2, pod=2) torus, at its
    dispatch block) with a compute stage and no reverse rounds under
    autograd, ``plan.overlap(x, 2 sin(x), reverse=False, params=())``,
    against the autograd of ``2 sin(plan.forward(x))``: output and input
    gradient bit for bit; each direction's reorder launches, and the
    host ms of both (the second of two calls)."""
    from repro_torch.core.cache import cart_create
    from repro_torch.models.moe import (_capacity, _group_geometry,
                                        moe_a2a_plan)
    cfg = _ep_config()
    mesh = cart_create(n, (2, 2), ("data", "pod"), device_type=DEVICE)
    axes, G, E_loc, _ = _group_geometry(cfg, mesh)
    C = _capacity(cfg, EP_TOKENS, max(cfg.n_experts, G))
    plan = moe_a2a_plan(cfg, mesh, axes, E_loc, C)
    shape = (G, E_loc, C, cfg.d_model)
    x = _shard_input(7000 + rank, shape)
    ct = _shard_input(7100 + rank, shape)
    stage = lambda c, _i=0: (torch.sin(c.float()) * 2.0).to(c.dtype)
    for _ in range(2):                 # the second call warm, and counted
        xg = x.clone().requires_grad_(True)
        torch.cuda.synchronize()
        _reset_counts()
        y, fwd_ms = _host_ms(lambda: plan.overlap(
            xg, stage, reverse=False, chunk_axis=2, params=()))
        fwd = _read_counts()
        _reset_counts()
        (g,), bwd_ms = _host_ms(lambda: torch.autograd.grad(y, xg, ct))
        bwd = _read_counts()
    xr = x.clone().requires_grad_(True)
    y_ref = stage(plan.forward(xr))
    (g_ref,) = torch.autograd.grad(y_ref, xr, ct)
    n_chunks = _n_chunks(C, plan.n_chunks)
    out = {"backend": plan.backend, "n_chunks": n_chunks, "C": C,
           "mib": x.numel() * x.element_size() / 2**20,
           "y_equal": torch.equal(y, y_ref), "g_equal": torch.equal(g, g_ref),
           "forward": fwd, "backward": bwd,
           "predicted_forward": _expected(**_dense_launches(plan, False,
                                                            n_chunks)),
           "predicted_backward": _expected(**_dense_launches(plan, True,
                                                             n_chunks)),
           "forward_ms": fwd_ms, "backward_ms": bwd_ms}
    del x, ct, xg, y, g, xr, y_ref, g_ref
    torch.cuda.empty_cache()
    return out


def run_world(seed: int, timeout: float = 900.0) -> list:
    """Spawn the 4-rank world with ``tests/torch_dist.py`` (FileStore
    init, killed at ``timeout``) and return each rank's result.  The
    ranks' tuning DB is a file in a temporary directory, so that no DB
    left on the machine decides the run."""
    import os
    import torch_dist
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_TUNING_DB"] = str(Path(tmp) / "tuning.json")
        try:
            return torch_dist.run_world(_world_rank, WORLD, tmp, seed, tmp,
                                        timeout=timeout)
        except (AssertionError, TimeoutError) as exc:
            fail(f"the {WORLD}-rank world: {exc}")


def phase_collective(results) -> dict:
    bad = sorted({k for r in results for k, v in r["collective"]["ok"]
                  .items() if not v})
    if bad:
        fail(f"[collective] wrong on CUDA tensors: {bad}")
    n_checks = len(results[0]["collective"]["ok"])
    launches = {k: sum(r["collective"]["launches"][k] for r in results)
                for k in REORDER_OPS}
    log(f"[collective] gloo took CUDA tensors; {n_checks} checks per rank "
        f"x {WORLD} ranks agree bit for bit (direct, factorized natural/"
        f"paper in every round order, reverse, tiled, all_gather, "
        f"reduce_scatter; pipelined and overlap at n_chunks "
        f"{COLL_CHUNKS} through forward, reverse, tiled and overlap(2x+1); "
        f"ragged (factorized, overlap, direct data plans) and sparse "
        f"Alltoallv forward and reverse, counted rows against the oracle; "
        f"on (2,2) and (4,)); each call launched the passes round_schedule "
        f"lists (2 a round set on (2,2), 0 on (4,)) once per chunk and "
        f"per counts phase; launches over all ranks {launches}")
    timed = {k: round(max(r["collective"]["chunked_ms"][k] for r in results),
                      3) for k in results[0]["collective"]["chunked_ms"]}
    log(f"[collective] chunked gathers on (2,2) (n_chunks {COLL_CHUNKS}, "
        f"bf16 / f32 / int64 all-gather and int64 reduce-scatter bit for "
        f"bit, f32 within p * 2**-23 of its terms, backward bit for bit "
        f"the unchunked plan's): median host ms of a "
        f"{COLL_GATHER_TIMED * 2 / 2**20:g} MiB bf16 block a rank over "
        f"gloo, the slowest rank's, {timed} on {_card()}")
    return launches


def _bad(results, phase: str) -> list:
    return sorted({k for r in results for k, v in r[phase]["ok"].items()
                   if not v})


def phase_autotune(results) -> dict:
    """Every check passed on every rank, and the ranks agree: the same
    measured plans (tables included) and the same ragged-vs-sparse
    winner.  Prints the medians, the fitted links, the winners and the
    search seconds."""
    bad = _bad(results, "autotune")
    if bad:
        fail(f"[autotune] failed: {bad}")
    for what in ("ep", "data"):
        descs = [r["autotune"][what]["describe"] for r in results]
        if any(d != descs[0] for d in descs):
            fail(f"[autotune] the ranks' {what} plans differ: {descs}")
    rag = [(r["autotune"]["ragged"]["kind"], r["autotune"]["ragged"]
            ["winner"]) for r in results]
    if any(x != rag[0] for x in rag):
        fail(f"[autotune] the ranks' ragged winners differ: {rag}")
    r0 = results[0]["autotune"]
    for what, label in (("ep", "EP block"), ("data", "dropless data block")):
        a = r0[what]
        d = a["describe"]
        label += (f" {tuple(d['block_shape'])} {d['dtype']}, "
                  f"{d['block_bytes'] / 2**20:g} MiB")
        rows = "; ".join(f"{t['backend']} {t['round_order']} n={t['n_chunks']}"
                         f" {t['median_us']:.1f}" for t in a["table"])
        log(f"[autotune] {label}: medians (µs, the slowest rank's): "
            f"{rows}; winner {d['backend']} order {d['round_order']} "
            f"n_chunks {d['n_chunks']}; fitted links (alpha s, bytes/s) "
            f"per axis {a['links']} against default_links "
            f"{a['default_links']}; search "
            f"{max(r['autotune'][what]['search_s'] for r in results):.2f} s")
    rk = r0["ragged"]
    rows = "; ".join(f"{t['backend']} {t['median_us']:.1f}"
                     for t in rk["table"])
    log(f"[autotune] dropless row {rk['row']}, window {rk['window']}: "
        f"{rows} µs; "
        f"winner {rk['kind']}; search "
        f"{max(r['autotune']['ragged']['search_s'] for r in results):.2f} s;"
        f" autotune_stats rank 0 {r0['stats']}")
    _guideline_report(r0)
    return {k: sum(r["autotune"]["counts"][k] for r in results)
            for k in r0["counts"]}


def _guideline_report(r0) -> None:
    """The paper's self-consistent guideline (``core.guidelines``) on the
    measured ``direct`` and ``factorized`` rows of the two dense
    searches' tables: is the direct all-to-all ever slower than its
    factorized composition by more than 10%?  Logged, not gated: the
    four ranks share one card over gloo, whose host staging says nothing
    of NCCL."""
    from repro_torch.core.guidelines import (Measurement, check_guidelines,
                                             format_report)
    for what in ("ep", "data"):
        a = r0[what]
        elems = math.prod(a["describe"]["block_shape"])
        ms = [Measurement(t["backend"] if t["backend"] == "direct" else
                          f"factorized[dims={t['dims']},order="
                          f"{t['round_order']}]", elems,
                          t["median_us"] * 1e-6)
              for t in a["table"] if t["backend"] in ("direct",
                                                      "factorized")]
        log(f"[autotune] guideline check, {what} block of {elems} elements "
            f"(tolerance 1.10; not a gate): "
            + format_report(check_guidelines(ms)).replace("\n", " |"))


def phase_tracing(results) -> None:
    """Every tracing check passed on every rank; prints the drift ratios
    under both link sets and the decode-size host µs."""
    bad = _bad(results, "tracing")
    if bad:
        fail(f"[tracing] failed: {bad}")
    t0 = results[0]["tracing"]
    if not t0["ratios"]:
        log("[tracing] [autotune]'s link fit gave up (the two payload "
            "sizes' times did not grow): drift under default_links only, "
            f"{ {k: v['ratio'] for k, v in t0['summary'].items()} }")
    for key, (default, measured) in sorted(t0["ratios"].items()):
        log(f"[tracing] drift {key}: measured / model {default:.4g} under "
            f"default_links, {measured:.4g} under [autotune]'s links")
    log(f"[tracing] {TRACE_CALLS} traced calls each of the factorized, "
        f"overlap and dropless layer: {t0['spans']} spans on rank 0, "
        f"outputs and launches equal to the untraced calls on every rank; "
        f"drifted keys {t0['drifted']}; check_drift retunes "
        f"{t0['retunes']}, then none")
    offs = [r["tracing"]["decode_us"][0] for r in results]
    ons = [r["tracing"]["decode_us"][1] for r in results]
    log(f"[tracing] decode-size factorized call "
        f"({t0['decode_bytes'] // 1024} KiB a rank) host µs per call over "
        f"50 calls, ranks 0-3: tracing off "
        f"{[round(v, 1) for v in offs]}, on {[round(v, 1) for v in ons]}")


def _one_process_gate(phase: str, cfg, results, seed: int,
                      keys=("y",), ranks=range(WORLD)):
    """Hold the gathered EP outputs (``keys`` of each rank's result)
    against the same layer with mesh=None on the tokens of ``ranks`` (the
    ranks of ``results``, in order) in this process; returns ({key: max
    |dy|}, max |y|, aux, reference aux)."""
    from repro_torch.models.moe import moe_block
    router, _ = _ep_inputs(cfg, 0, seed)
    x = torch.cat([_ep_inputs(cfg, rank, seed)[1] for rank in ranks])
    w = [_expert_weights(cfg, e, seed) for e in range(cfg.n_experts)]
    p = {"router": router,
         **{name: torch.stack([we[i] for we in w])
            for i, name in enumerate(("w1", "w3", "w2"))}}
    del w
    y_ref, aux_ref = moe_block(p, x, cfg)
    del p
    y_ref = y_ref.float().cpu().numpy()
    scale = float(np.abs(y_ref).max())
    errs = {}
    for key in keys:
        y = np.concatenate([r[phase][key] for r in results])
        if y.shape != y_ref.shape or not np.isfinite(y).all():
            fail(f"[{phase}] output {key} {y.shape} not finite "
                 f"{y_ref.shape}")
        errs[key] = float(np.abs(y - y_ref).max())
        if errs[key] > 2e-2 * scale:
            fail(f"[{phase}] EP output {key} differs from the one-process "
                 f"layer by {errs[key]:.4g} (largest |y| {scale:.4g}; "
                 f"limit 2e-2 of it)")
    aux = [r[phase]["aux"] for r in results]
    if any(abs(a - float(aux_ref)) > 1e-3 * abs(float(aux_ref))
           for a in aux):
        fail(f"[{phase}] aux {aux} vs {float(aux_ref):.6g}")
    return errs, scale, aux[0], float(aux_ref)


def _check_counts(phase: str, results, per_rank: dict,
                  key: str = "counts") -> dict:
    for rank, r in enumerate(results):
        if r[phase][key] != per_rank:
            fail(f"[{phase}] rank {rank} launched {r[phase][key]} "
                 f"({key}), expected {per_rank}")
    return {k: sum(r[phase][key][k] for r in results) for k in per_rank}


def phase_moe_ep(results, seed: int) -> dict:
    """The plan must be the overlap engine; the gathered output must match
    the one-process layer; the launch counts must be the prediction."""
    cfg = _ep_config()
    r0 = results[0]["moe_ep"]
    desc, n = r0["describe"], r0["n_chunks"]
    if desc["requested_backend"] != "tuned" or desc["backend"] != "overlap":
        fail(f"[moe_ep] the config's a2a_backend "
             f"{desc['requested_backend']!r} resolved to "
             f"{desc['backend']!r}, expected the overlap engine")
    log(f"[moe_ep] plan: {json.dumps(desc)}")
    E_loc = cfg.n_experts // WORLD
    per_rank = _expected(**_gmm_launches(cfg, E_loc, WORLD * r0["C"] // n,
                                         n), **r0["predicted"])
    total = _check_counts("moe_ep", results, per_rank)
    # the factorized comparison call: one FFN on all rows, one set of passes
    _check_counts("moe_ep", results, _expected(
        **_gmm_launches(cfg, E_loc, WORLD * r0["C"], 1),
        **r0["fact_predicted"]), key="fact_counts")
    # the autotune call: every rank replays [autotune]'s winner, with its
    # launches, bit for bit the factorized call's output
    win = results[0]["autotune"]["ep"]["describe"]
    for rank, r in enumerate(results):
        d = r["moe_ep"]["auto_describe"]
        if d["tuned_from"] != "measured" or (
                d["backend"], d["round_order"], d["n_chunks"]) != (
                win["backend"], win["round_order"], win["n_chunks"]):
            fail(f"[moe_ep] rank {rank}'s autotune plan {d} is not "
                 f"[autotune]'s measured winner {win}")
        if not r["moe_ep"]["auto_equal"]:
            fail(f"[moe_ep] rank {rank}: the autotune call's output is not "
                 f"the factorized call's bit for bit")
    an = r0["auto_n"]
    _check_counts("moe_ep", results, _expected(
        **_gmm_launches(cfg, E_loc, WORLD * r0["C"] // an, an),
        **r0["auto_predicted"]), key="auto_counts")
    # the overlap call interleaves exchanges with the expert FFN stages
    # in host order; the factorized call does not
    ov, fa = r0["interleave"], r0["fact_interleave"]
    if not ov["interleaved"] > fa["interleaved"] == 0:
        fail(f"[moe_ep] interleave_report: overlap {ov}, factorized {fa}")
    log(f"[moe_ep] interleave_report on rank 0's profiles: overlap call "
        f"{ov['interleaved']} exchanges between compute stages "
        f"({ov['collective_runs']} collective runs: {ov['events']}); "
        f"factorized call {fa['interleaved']} ({fa['collective_runs']} "
        f"runs)")
    log(f"[moe_ep] a2a_backend autotune replays {win['backend']} "
        f"order {win['round_order']} n_chunks {win['n_chunks']} on every "
        f"rank (tuned_from measured); output equal to the factorized "
        f"call's bit for bit; launches per rank {r0['auto_counts']}")
    errs, scale, aux, aux_ref = _one_process_gate("moe_ep", cfg, results,
                                                  seed)
    err = errs["y"]
    warm = [t for r in results for t in r["moe_ep"]["warm_ms"]]
    fwarm = [t for r in results for t in r["moe_ep"]["fact_warm_ms"]]
    awarm = [t for r in results for t in r["moe_ep"]["auto_warm_ms"]]
    won = sum(a < b for a, b in zip(warm, fwarm))
    awon = sum(a < b for a, b in zip(awarm, warm))
    q = lambda v: "/".join(f"{t:.1f}" for t in np.percentile(v, (25, 50,
                                                                 75)))
    log(f"[moe_ep] warm host ms per call over {EP_PAIRS} rounds in turns x "
        f"{WORLD} ranks, quartiles 25/50/75: overlap {q(warm)}, factorized "
        f"{q(fwarm)}, autotune ({win['backend']}) {q(awarm)}; overlap "
        f"faster than factorized in {won} of {len(warm)} rounds, autotune "
        f"faster than overlap in {awon} (one card, gloo staging through "
        f"the host: not an overlap measurement)")
    log(f"[moe_ep] {ARCH} MoE layer, EP over (data=2, pod=2), "
        f"{EP_TOKENS} tokens x {WORLD} ranks, E_loc={E_loc} "
        f"({r0['weight_gb']:.3f} GB of expert weights per rank), "
        f"a2a_backend tuned -> overlap, {n} chunks of C={r0['C'] // n}: "
        f"max |y - one-process y| {err:.4g} of max |y| {scale:.4g}; "
        f"max |y - factorized y| "
        f"{max(r['moe_ep']['dy_factorized'] for r in results):.4g}; aux "
        f"{aux:.6f} vs {aux_ref:.6f}; host ms per call: first "
        f"{max(r['moe_ep']['cold_ms'] for r in results):.1f}, then median "
        f"{float(np.median(warm)):.1f} (factorized "
        f"{float(np.median(fwarm)):.1f}; 4 ranks share the card); "
        f"launches per rank per call {r0['counts']} (factorized "
        f"{r0['fact_counts']}); per call "
        f"{r0['chunk_copies']} chunk copies and {r0['concat_copies']} "
        f"concatenations; peak memory per rank "
        f"{r0['peak_gib']:.2f} GiB")
    return total


def phase_moe_ep_grok(results, seed: int) -> dict:
    """grok-1's layer in [moe_ep]: its tuned plan must be the overlap
    engine, each call's launches the prediction (3 gmm a chunk, the
    reorder passes ``round_schedule`` lists a chunk each way), the tuned
    call's output the factorized call's bit for bit and, gathered, the
    one-process layer's within 2e-2 of the largest |y|.  Returns the
    tuned call's launches over all ranks."""
    cfg = _ep_config(GROK)
    r0 = results[0]["moe_ep_grok"]
    desc, n, C = r0["describe"], r0["n_chunks"], r0["C"]
    if desc["requested_backend"] != "tuned" or desc["backend"] != "overlap":
        fail(f"[moe_ep] {GROK}: the config's a2a_backend "
             f"{desc['requested_backend']!r} resolved to "
             f"{desc['backend']!r}, expected the overlap engine")
    E_loc = cfg.n_experts // WORLD
    total = _check_counts("moe_ep_grok", results, _expected(
        **_gmm_launches(cfg, E_loc, WORLD * C // n, n), **r0["predicted"]))
    _check_counts("moe_ep_grok", results, _expected(
        **_gmm_launches(cfg, E_loc, WORLD * C, 1), **r0["fact_predicted"]),
        key="fact_counts")
    for rank, r in enumerate(results):
        if not r["moe_ep_grok"]["equal"]:
            fail(f"[moe_ep] {GROK} rank {rank}: the tuned call's output "
                 f"differs from the factorized call's by up to "
                 f"{r['moe_ep_grok']['dy_factorized']:.4g}")
    errs, scale, aux, aux_ref = _one_process_gate("moe_ep_grok", cfg,
                                                  results, seed)
    warm = [t for r in results for t in r["moe_ep_grok"]["warm_ms"]]
    secs = max(r["moe_ep_grok"]["seconds"] for r in results)
    log(f"[moe_ep] {GROK} MoE layer (d {cfg.d_model}, F {cfg.d_ff}, "
        f"{cfg.n_experts} experts top{cfg.top_k}), EP over (data=2, pod=2), "
        f"{EP_TOKENS} tokens x {WORLD} ranks, E_loc={E_loc} "
        f"({r0['weight_gb']:.3f} GB of expert weights per rank), "
        f"a2a_backend tuned -> overlap, {n} chunks of C={C // n}: max |y - "
        f"one-process y| {errs['y']:.4g} of max |y| {scale:.4g}; equal to "
        f"the factorized call bit for bit on every rank; aux {aux:.6f} vs "
        f"{aux_ref:.6f}; host ms per call: first "
        f"{max(r['moe_ep_grok']['cold_ms'] for r in results):.1f}, warm "
        f"median {float(np.median(warm)):.1f}, factorized "
        f"{float(np.median([r['moe_ep_grok']['fact_ms'] for r in results])):.1f}"
        f"; launches per rank per call {r0['counts']} (factorized "
        f"{r0['fact_counts']}); peak memory per rank "
        f"{r0['peak_gib']:.2f} GiB; {secs:.1f} s in the world")
    return total


def phase_moe_dropless(results, seed: int) -> dict:
    """The dropless layer: the gate against the one-process dropless
    layer and the launch counts."""
    cfg = _ep_config(capacity_factor=None)
    r0 = results[0]["moe_dropless"]
    E_loc = cfg.n_experts // WORLD
    per_rank = _expected(**_gmm_launches(cfg, E_loc, WORLD * r0["C"], 1),
                         **r0["predicted"])
    total = _check_counts("moe_dropless", results, per_rank)
    # the autotune call: [autotune]'s ragged-vs-sparse winner, and for a
    # ragged plan the padded data block's measured winner
    rk = results[0]["autotune"]["ragged"]
    kind = "SparseA2APlan" if rk["winner"]["backend"] == "sparse" \
        else "RaggedA2APlan"
    win = results[0]["autotune"]["data"]["describe"]
    for rank, r in enumerate(results):
        d = r["moe_dropless"]["auto_describe"]
        if r["moe_dropless"]["auto_kind"] != kind or (
                kind == "RaggedA2APlan" and (
                    d["tuned_from"] != "measured"
                    or (d["backend"], d["round_order"], d["n_chunks"])
                    != (win["backend"], win["round_order"],
                        win["n_chunks"]))):
            fail(f"[moe_dropless] rank {rank}'s autotune plan "
                 f"{r['moe_dropless']['auto_kind']} {d} is not the "
                 f"measured {kind} / {win}")
    _check_counts("moe_dropless", results, _expected(
        **_gmm_launches(cfg, E_loc, WORLD * r0["C"], 1),
        **r0["auto_predicted"]), key="auto_counts")
    errs, scale, aux, aux_ref = _one_process_gate(
        "moe_dropless", cfg, results, seed, keys=("y", "auto_y"))
    err = errs["y"]
    log(f"[moe_dropless] a2a_backend autotune replays {kind} (data "
        f"backend {r0['auto_describe']['backend']}, n_chunks "
        f"{r0['auto_describe']['n_chunks']}, tuned_from "
        f"{r0['auto_describe']['tuned_from']}) on every rank: max |y - "
        f"one-process y| {errs['auto_y']:.4g}; equal to the tuned call's "
        f"output bit for bit: "
        f"{all(r['moe_dropless']['auto_equal'] for r in results)}; "
        f"launches per rank {r0['auto_counts']}")
    warm = [t for r in results for t in r["moe_dropless"]["warm_ms"]]
    desc = r0["describe"]
    log(f"[moe_dropless] plan: {json.dumps(desc)}")
    log(f"[moe_dropless] {ARCH} MoE layer, capacity_factor=None, "
        f"{EP_TOKENS} tokens x {WORLD} ranks: moe_dropless_a2a_plan chose "
        f"{r0['kind']} (data backend {desc['backend']}, bucket "
        f"{desc['bucket']}), expected occupancy "
        f"{desc['expected_occupancy']:.4f}, measured "
        f"{min(r['moe_dropless']['occupancy'] for r in results):.4f}-"
        f"{max(r['moe_dropless']['occupancy'] for r in results):.4f}; "
        f"max |y - one-process y| {err:.4g} of max |y| {scale:.4g}; aux "
        f"{aux:.6f} vs {aux_ref:.6f}; host ms per call: first "
        f"{max(r['moe_dropless']['cold_ms'] for r in results):.1f}, then "
        f"median {float(np.median(warm)):.1f}; launches per rank per call "
        f"{r0['counts']}")
    return total


# ---------------------------------------------------------------------------
# phase 12: training at full width
# ---------------------------------------------------------------------------


def phase_train_ep(results) -> dict:
    """[train_ep]'s gates: the tuned plan is the overlap engine; no token
    of the gated call dropped and every capacity chunk carried routed
    rows on every EP rank (from the recorded routing); every
    rank's reduced gradient is finite and non-zero, within
    TRAIN_GRAD_TOL of the factorized plan's and (gathered, rank 0) of the
    one-process kernel step's on the global batch; the launches of the
    loss + backward and of each step are the prediction; the Trainer's
    restore is bit for bit.  Returns the timed steps' launches over the
    ranks (the main path of this phase)."""
    r0 = results[0]["train_ep"]
    desc = r0["describe"]
    if desc["requested_backend"] != "tuned" or desc["backend"] != "overlap":
        fail(f"[train_ep] the config's a2a_backend "
             f"{desc['requested_backend']!r} resolved to "
             f"{desc['backend']!r}, expected the overlap engine")
    log(f"[train_ep] plan: {json.dumps(desc)}")
    # what each EP rank received in each capacity chunk of the tuned
    # call: expert e's slots 0 .. routed - 1 are filled, from every rank
    C, n_chunks = r0["C"], r0["n_chunks"]
    Cc = C // n_chunks
    routed = np.array([r["train_ep"]["routed"] for r in results])
    if routed.max() > C:
        fail(f"[train_ep] a rank routed {routed.max()} tokens to one expert, "
             f"over C={C}: tokens dropped, the one-process step is no "
             f"reference")
    per_rank = routed.reshape(WORLD, WORLD, -1)       # (source, dest, e)
    recv = np.stack([np.clip(per_rank - c * Cc, 0, Cc).sum(axis=(0, 2))
                     for c in range(n_chunks)], axis=1)   # (dest, chunk)
    log(f"[train_ep] each row block's first {TRAIN_EP_FILL} tokens set to "
        f"token {r0['fill']}; routed rows each EP rank received per "
        f"capacity chunk of {Cc} slots: {recv.tolist()}")
    if not (recv > 0).all():
        fail(f"[train_ep] a capacity chunk carried no routed row on some "
             f"EP rank: {recv.tolist()} (rank x chunk)")
    for rank, r in enumerate(results):
        t = r["train_ep"]
        if not t["finite_nonzero"]:
            fail(f"[train_ep] rank {rank}: a reduced gradient leaf is not "
                 f"finite or is zero")
        for key, want in (("counts", "per_step"),
                          ("fact_counts", "fact_per_step")):
            if t[key] != t[want]:
                fail(f"[train_ep] rank {rank}'s loss + backward launched "
                     f"{t[key]} ({key}), expected {t[want]}")
        want = {k: TRAIN_EP_TIMED * v for k, v in t["per_step"].items()}
        if t["step_counts"] != want:
            fail(f"[train_ep] rank {rank}'s {TRAIN_EP_TIMED} steps launched "
                 f"{t['step_counts']}, expected {want}")
        tr = t["trainer"]
        if not tr["restored_equal"] or tr["status"] != "done" \
                or tr["step"] != TRAIN_EP_STEPS:
            fail(f"[train_ep] rank {rank}: Trainer restore equal "
                 f"{tr['restored_equal']}, ended {tr['status']} at step "
                 f"{tr['step']}")
        if any(d != t["cut_per_step"] for d in tr["deltas"]) or not all(
                math.isfinite(v) for v in tr["losses"]):
            fail(f"[train_ep] rank {rank}: Trainer steps launched "
                 f"{tr['deltas']}, expected {t['cut_per_step']} each; "
                 f"losses {tr['losses']}")
        for policy, rm in t["remat"].items():
            if rm["counts"] != rm["per_step"]:
                fail(f"[train_ep] rank {rank}'s loss + backward under "
                     f"remat_policy={policy!r} launched {rm['counts']}, "
                     f"expected {rm['per_step']}")
            if not rm["equal"]:
                fail(f"[train_ep] rank {rank}: the reduced gradients under "
                     f"remat_policy={policy!r} are not those under "
                     f"'nothing' bit for bit (largest relative gap "
                     f"{rm['gap']:.3g})")
        worst = max(t["tuned_vs_fact"].items(), key=lambda kv: kv[1])
        if not worst[1] <= TRAIN_GRAD_TOL:
            fail(f"[train_ep] rank {rank}: the tuned plan's gradient of "
                 f"{worst[0]} lies {worst[1]:.3g} from the factorized "
                 f"plan's (limit {TRAIN_GRAD_TOL})")
    worst = max(r0["vs_one"].items(), key=lambda kv: kv[1])
    if not worst[1] <= TRAIN_GRAD_TOL:
        fail(f"[train_ep] the gathered EP gradient of {worst[0]} lies "
             f"{worst[1]:.3g} from the one-process step's (limit "
             f"{TRAIN_GRAD_TOL})")
    for name, loss in (("tuned", r0["loss"]), ("factorized",
                                               r0["fact_loss"])):
        if not abs(loss - r0["one_loss"]) <= 1e-2 * abs(r0["one_loss"]):
            fail(f"[train_ep] the {name} loss {loss} vs the one-process "
                 f"{r0['one_loss']} (limit 1e-2 relative)")
    WRITTEN["train_ep"] = r0["written"]
    if r0["written"] > DISK_WRITE_BUDGET:
        fail(f"[train_ep] the checkpoint wrote {r0['written'] / 2**30:.2f} "
             f"GiB, over the run's disk budget")
    _check_held("train_ep", results, "train_ep")
    cfg = _train_ep_config()
    log(f"[train_ep] {cfg.name} d={cfg.d_model} F={cfg.d_ff} "
        f"E={cfg.n_experts} vocab={cfg.vocab} layers={cfg.n_layers} "
        f"remat={cfg.remat_policy}, EP over (data=2, pod=2), FSDP of the "
        f"embedding and attention over (pod, data), B=1 S={TRAIN_EP_S} per "
        f"rank (C={r0['C']}), built in {r0['build_s']:.1f} s; loss tuned "
        f"{r0['loss']:.6g}, factorized {r0['fact_loss']:.6g}, one process "
        f"{r0['one_loss']:.6g}")
    _log_held("train_ep", [r["train_ep"] for r in results])
    log(f"[train_ep] relative norm gaps per leaf (limit {TRAIN_GRAD_TOL}): "
        f"gathered EP (tuned) ~ one-process step, tuned ~ factorized "
        f"(largest over the ranks):")
    for path, gap in r0["vs_one"].items():
        tf = max(r["train_ep"]["tuned_vs_fact"][path] for r in results)
        log(f"[train_ep]   {path:32s} {gap:.3e} {tf:.3e}")
    q = lambda v: "/".join(f"{t:.1f}" for t in np.percentile(v, (25, 50,
                                                                 75)))
    ms = [t for r in results for t in r["train_ep"]["step_ms"][1:]]
    log(f"[train_ep] full-width step (loss, backward, reduce_grads, AdamW) "
        f"host ms per rank: "
        f"{[[round(t, 1) for t in r['train_ep']['step_ms']] for r in results]}"
        f"; warm quartiles 25/50/75 {q(ms)} (4 ranks share the card, gloo "
        f"stages every exchange through the host); peak memory per rank "
        f"{[round(r['train_ep']['peak_gib'], 2) for r in results]} GiB; "
        f"launches per step per rank {r0['per_step']}")
    for policy in TRAIN_EP_REMAT:
        rm = [r["train_ep"]["remat"][policy] for r in results]
        log(f"[train_ep] remat_policy={policy!r} on {_card()}: one loss + "
            f"backward + reduce_grads at full width, reduced gradients "
            f"equal to 'nothing' bit for bit on every rank; host ms per "
            f"rank {[round(m['ms'], 1) for m in rm]}; peak memory above "
            f"the held state per rank (GiB) "
            f"{[round(m['peak_gib'], 3) for m in rm]}; launches per rank "
            f"{ {k: v for k, v in rm[0]['counts'].items() if v} }")
    tr = r0["trainer"]
    log(f"[train_ep] Trainer.run at the cut width {TRAIN_EP_CUT} "
        f"({tr['n_params'] / 1e6:.1f} M params per rank, plan "
        f"{r0['cut_describe']['backend']} n_chunks "
        f"{r0['cut_describe']['n_chunks']}): total_loss "
        f"{[round(v, 4) for v in tr['losses']]}, grad_norm "
        f"{[round(v, 4) for v in tr['grad_norms']]}, step ms (slowest "
        f"rank) {[round(v * 1e3, 1) for v in tr['seconds']]}; the async "
        f"checkpoint at step 2 ({r0['written'] / 2**30:.3f} GiB of global "
        f"arrays, written by rank 0) restored into a fresh Trainer bit for "
        f"bit on every rank; launches per step {r0['cut_per_step']}")
    return {k: sum(r["train_ep"]["step_counts"][k] for r in results)
            for k in r0["step_counts"]}


def phase_elastic(results, seed: int) -> dict:
    """[elastic]'s gates.  (a): ranks 2, 3 took the device loss on the
    plan's 3rd call and left; on the survivors the watchdog said recover,
    the rebuilt torus has ``dims_create``'s dims, the dead comm's plan
    slice is gone while another comm's plan is the same object, the
    tuning records migrated are the ones the surviving extents predict;
    the layer on the survivors' torus matches the one-process layer on
    their tokens, launches what ``round_schedule`` predicts for the new
    dims, and its all-to-all is the definition bit for bit.  (b): ranks
    2, 3 leave at step 5; the survivors recover once, finish at step 6
    and equal a direct restore of the step-3 checkpoint followed by the
    same steps bit for bit.  Returns the launches of both legs' main
    paths over the ranks."""
    cfg = _ep_config()
    survivors = [r for r in range(WORLD) if r not in ELASTIC_LOST]
    for rank, r in enumerate(results):
        a, b = r["elastic"]["comm"], r["elastic"]["trainer"]
        if a["fired"] != [("device_loss", "a2a", 3)] \
                or a["devices"] != list(ELASTIC_LOST):
            fail(f"[elastic] rank {rank}: the injected loss fired "
                 f"{a['fired']} naming {a['devices']}")
        if b["fired"] != [("device_loss", "train_step", ELASTIC_LOSS_AT)]:
            fail(f"[elastic] rank {rank}: the Trainer's loss fired "
                 f"{b['fired']}")
        if rank in ELASTIC_LOST:
            if not a["left"] or b["status"] != "lost" \
                    or b["step"] != ELASTIC_LOSS_AT - 1:
                fail(f"[elastic] lost rank {rank} did not leave: {a['left']},"
                     f" Trainer {b['status']} at step {b['step']}")
            continue
        checks = {
            "recover": a["action"] == "recover",
            "dims": tuple(a["dims"]) == tuple(a["want_dims"]),
            "lineage": a["describe"]["rebuilt_from"] == {
                "dims": [2, 2], "axes": ["data", "pod"], "p": WORLD},
            "plan slice freed": a["slice_gone"] and a["dead_plans"] > 0,
            "other comm's plan kept": a["kept_same"],
            "migrated": a["migrated"] == a["migrate_predicted"] >= 1,
            "one rebuild traced": a["rebuilds"] == 1
            and len(a["span_ms"]) == 1,
            "launches": a["counts"] == a["predicted"],
            "all-to-all": a["a2a_equal"],
            "trainer done": b["status"] == "done"
            and b["step"] == ELASTIC_STEPS,
            "one recovery": b["recoveries"] == 1 and b["rebuilds"] == 1,
            "events": "device_loss" in b["events"]
            and "action:recover" in b["events"],
            "survivor mesh": b["mesh"] == survivors,
            "direct restore": b["direct_equal"]}
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"[elastic] survivor {rank}: {bad} wrong; comm leg "
                 f"{ {k: v for k, v in a.items() if k != 'y'} }, Trainer "
                 f"{b}")
    if [results[r]["elastic"]["trainer"]["writer"] for r in survivors] \
            != [True, False]:
        fail("[elastic] the checkpoint writer is not the survivor at mesh "
             "coordinate 0")
    sub = [{"elastic": results[r]["elastic"]["comm"]} for r in survivors]
    errs, scale, aux, aux_ref = _one_process_gate("elastic", cfg, sub, seed,
                                                  ranks=survivors)
    a0, b0 = results[0]["elastic"]["comm"], results[0]["elastic"]["trainer"]
    WRITTEN["elastic"] = b0["written"]
    if sum(WRITTEN.values()) > DISK_WRITE_BUDGET:
        fail(f"[elastic] the checkpoints wrote {b0['written'] / 2**30:.2f} "
             f"GiB, over the run's disk budget")
    log(f"[elastic] (a) on {_card()}: {cfg.name}'s MoE layer on the "
        f"(data=2, pod=2) torus, device loss of ranks {list(ELASTIC_LOST)} "
        f"on the plan's 3rd call, the watchdog's action {a0['action']}; "
        f"TorusComm.rebuild onto ranks {survivors}: dims {a0['dims']} "
        f"(dims_create), {a0['rebuild_s'] * 1e3:.1f} ms host (span "
        f"comm.rebuild {[round(t, 1) for t in a0['span_ms']]} ms), "
        f"{a0['dead_plans']} plans of the dead comm freed, another comm's "
        f"plan kept, {a0['migrated']} tuning record(s) migrated "
        f"(predicted {a0['migrate_predicted']}); plan on the survivors "
        f"{a0['plan']['backend']} n_chunks {a0['n_chunks']} (C={a0['C']}, "
        f"E_loc={a0['E_loc']}); layer host ms per survivor "
        f"{[round(results[r]['elastic']['comm']['layer_ms'], 1) for r in survivors]}"
        f"; max |y - one-process y| {errs['y']:.4g} of max |y| "
        f"{scale:.4g}; aux {aux:.6f} vs {aux_ref:.6f}; launches per "
        f"survivor {a0['counts']}; the all-to-all equal to the definition "
        f"bit for bit")
    log(f"[elastic] (b) on {_card()}: Trainer(elastic=True) at the cut "
        f"width {TRAIN_EP_CUT}, {ELASTIC_STEPS} steps, checkpoint every "
        f"{ELASTIC_EVERY}, device loss of ranks {list(ELASTIC_LOST)} at "
        f"step {ELASTIC_LOSS_AT}: ranks {list(ELASTIC_LOST)} left at step "
        f"{ELASTIC_LOSS_AT - 1}; survivors {survivors} recovered "
        f"{b0['recoveries']} time(s) (rebuild_fn {b0['rebuild_s']:.2f} s), "
        f"done at step {b0['step']} in {b0['run_s']:.1f} s; logged steps "
        f"{b0['logged']}, total_loss {[round(v, 4) for v in b0['losses']]}, "
        f"step s {[round(v, 3) for v in b0['seconds']]}; watchdog events "
        f"{b0['events']}; final state equal to the direct restore of step "
        f"{ELASTIC_EVERY} plus the same steps bit for bit; "
        f"{b0['written'] / 2**30:.3f} GiB of checkpoints written by rank 0")
    out = {}
    for r in results:
        for leg in ("comm", "trainer"):
            for k, v in r["elastic"][leg].get("counts", {}).items():
                out[k] = out.get(k, 0) + v
    return out


def _log_held(phase: str, ranks: list) -> None:
    """Per rank: the parameters and state bytes it holds, its peak memory
    and the FSDP span's host ms in one step, beside the card."""
    log(f"[{phase}] per rank on {_card()}: params (B) "
        f"{[round(t['n_params'] / 1e9, 4) for t in ranks]}, params and "
        f"AdamW state (GB) {[round(t['state_gb'], 3) for t in ranks]}, peak "
        f"memory (GiB) {[round(t['peak_gib'], 2) for t in ranks]}, FSDP "
        f"span (repro_torch.fsdp: gathers and gradient reduce-scatters) "
        f"calls / host ms in one step "
        f"{[(t['fsdp_span'][0], round(t['fsdp_span'][1], 1)) for t in ranks]}")


def phase_train_tp(results) -> dict:
    """[train_tp]'s gates: the tuned plan is the overlap engine; no token
    of the gated call dropped and every capacity chunk carried routed
    rows on every EP rank; every rank's reduced gradient finite and
    non-zero and, gathered to rank 0, within TRAIN_GRAD_TOL of the
    one-process kernel step's, whose routing the mesh replays, at the
    fan-in init (at the reference init, where any change of rounding
    moves the gradients by percents, the gaps are logged); the losses
    at both inits within 1e-2; the ``model`` ranks
    of each row block bit-identical (router probabilities and top-k in
    every call, whole leaves' reduced gradients and parameters); the
    launches of the loss + backward and of each step the prediction;
    prefill and decode logits on the mesh within 2e-2 of the largest
    one-process logit; the Trainer's restore bit for bit.  Returns the
    launches of the timed steps and of serving over the ranks."""
    r0 = results[0]["train_tp"]
    desc = r0["describe"]
    if desc["requested_backend"] != "tuned" or desc["backend"] != "overlap":
        fail(f"[train_tp] the config's a2a_backend "
             f"{desc['requested_backend']!r} resolved to "
             f"{desc['backend']!r}, expected the overlap engine")
    by_block = {}
    for r in results:
        by_block.setdefault(r["train_tp"]["block"], []).append(r["train_tp"])
    if sorted(by_block) != list(range(TP_BLOCKS)) or any(
            len(v) != TP_WORLD // TP_BLOCKS for v in by_block.values()):
        fail(f"[train_tp] row blocks per rank "
             f"{[r['train_tp']['block'] for r in results]}")
    C, n_chunks = r0["C"], r0["n_chunks"]
    Cc = C // n_chunks
    routed = np.array([by_block[b][0]["routed"] for b in range(TP_BLOCKS)])
    if routed.max() > C:
        fail(f"[train_tp] a row block routed {routed.max()} tokens to one "
             f"expert, over C={C}: tokens dropped, the one-process step is "
             f"no reference")
    per_rank = routed.reshape(TP_BLOCKS, TP_BLOCKS, -1)   # (source, dest, e)
    recv = np.stack([np.clip(per_rank - c * Cc, 0, Cc).sum(axis=(0, 2))
                     for c in range(n_chunks)], axis=1)
    log(f"[train_tp] each row block's first {TRAIN_EP_FILL} tokens set to "
        f"token {r0['fill']}; routed rows each EP rank received per "
        f"capacity chunk of {Cc} slots: {recv.tolist()}")
    if not (recv > 0).all():
        fail(f"[train_tp] a capacity chunk carried no routed row on some "
             f"EP rank: {recv.tolist()} (rank x chunk)")
    for b, ranks in by_block.items():
        for t in ranks[1:]:
            for what in ranks[0]["digests"]:
                if t["digests"][what] != ranks[0]["digests"][what]:
                    fail(f"[train_tp] row block {b}: model rank "
                         f"{t['model']}'s {what} differ from model rank "
                         f"{ranks[0]['model']}'s bits")
            for a, w in zip(t["serve"], ranks[0]["serve"]):
                if not torch.equal(a, w):
                    fail(f"[train_tp] row block {b}: the model ranks' "
                         f"serving logits differ")
    n_calls = len(r0["digests"]["routing"])
    for rank, r in enumerate(results):
        t = r["train_tp"]
        if not t["finite_nonzero"]:
            fail(f"[train_tp] rank {rank}: a reduced gradient leaf is not "
                 f"finite or is zero")
        if t["counts"] != t["per_step"]:
            fail(f"[train_tp] rank {rank}'s loss + backward launched "
                 f"{t['counts']}, expected {t['per_step']}")
        want = {k: TRAIN_EP_TIMED * v for k, v in t["per_step"].items()}
        if t["step_counts"] != want:
            fail(f"[train_tp] rank {rank}'s {TRAIN_EP_TIMED} steps launched "
                 f"{t['step_counts']}, expected {want}")
        tr = t["trainer"]
        if not tr["restored_equal"] or tr["status"] != "done" \
                or tr["step"] != TRAIN_EP_STEPS:
            fail(f"[train_tp] rank {rank}: Trainer restore equal "
                 f"{tr['restored_equal']}, ended {tr['status']} at step "
                 f"{tr['step']}")
        if any(d != t["cut_per_step"] for d in tr["deltas"]) or not all(
                math.isfinite(v) for v in tr["losses"]):
            fail(f"[train_tp] rank {rank}: Trainer steps launched "
                 f"{tr['deltas']}, expected {t['cut_per_step']} each; "
                 f"losses {tr['losses']}")
    log(f"[train_tp] relative norm gaps per leaf, gathered TP ~ one-process "
        f"step (limit {TRAIN_GRAD_TOL} at {TP_GATED}), with ||TP|| / ||one "
        f"process||, at the inits {TP_INITS}:")
    for path in r0["vs_one"][TP_INITS[0]]:
        log(f"[train_tp]   {path:32s} " + "  ".join(
            f"{r0['vs_one'][i][path][0]:.3e} ({r0['vs_one'][i][path][1]:.4g}"
            f" / {r0['vs_one'][i][path][2]:.4g})" for i in TP_INITS))
    for init in TP_INITS:
        loss, one = r0["loss"][init], r0["one_loss"][init]
        sw = [r["train_tp"]["switched"][init] for r in results]
        log(f"[train_tp] loss at the {init} init {loss:.6g}, one process "
            f"{one:.6g}; the mesh replayed the one-process routing, and "
            f"would have routed otherwise "
            f"{sum(x['switched'] for x in sw) // (TP_WORLD // TP_BLOCKS)} of "
            f"{sum(x['tokens'] for x in sw) // (TP_WORLD // TP_BLOCKS)} "
            f"(token, router call) pairs")
        worst = max(r0["vs_one"][init].items(), key=lambda kv: kv[1][0])
        if init in TP_GATED and not worst[1][0] <= TRAIN_GRAD_TOL:
            fail(f"[train_tp] at the {init} init the gathered TP gradient "
                 f"of {worst[0]} lies {worst[1][0]:.3g} from the "
                 f"one-process step's (limit {TRAIN_GRAD_TOL})")
        if not abs(loss - one) <= 1e-2 * abs(one):
            fail(f"[train_tp] at the {init} init the loss {loss} vs the "
                 f"one-process {one} (limit 1e-2 relative)")
    pre = torch.cat([by_block[b][0]["serve"][0] for b in range(TP_BLOCKS)])
    ticks = torch.cat([by_block[b][0]["serve"][1] for b in range(TP_BLOCKS)])
    one_pre, one_ticks = r0["one_serve"]
    err_pre = _logit_gate("[train_tp] mesh prefill", pre, one_pre,
                          "one-process")
    err_ticks = _logit_gate(f"[train_tp] mesh decode ({TP_TICKS} ticks)",
                            ticks, one_ticks, "one-process")
    WRITTEN["train_tp"] = r0["written"]
    if sum(WRITTEN.values()) > DISK_WRITE_BUDGET:
        fail(f"[train_tp] the checkpoints wrote "
             f"{sum(WRITTEN.values()) / 2**30:.2f} GiB, over the run's "
             f"disk budget")
    _check_held("train_tp", results, "train_tp")
    cfg = _train_ep_config()
    log(f"[train_tp] {cfg.name} d={cfg.d_model} F={cfg.d_ff} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} E={cfg.n_experts} vocab="
        f"{cfg.vocab} layers={cfg.n_layers}, mesh (pod=2, data=2, model=2) "
        f"on {TP_WORLD} gloo ranks of one card: EP over (data, pod), heads, "
        f"F and the vocab over model, the embedding's and attention's "
        f"d_model over (pod, data) by FSDP; B=1 S={TRAIN_EP_S} per row block "
        f"(C={C}, plan {desc['backend']} n_chunks {desc['n_chunks']}), "
        f"built in {r0['build_s']:.1f} s; the one-process reference's peak "
        f"{r0['one_peak_gib']:.2f} GiB, freed before the mesh; router calls "
        f"bit-identical across the model ranks of every row block: "
        f"{n_calls} per rank")
    _log_held("train_tp", [r["train_tp"] for r in results])
    q = lambda v: "/".join(f"{t:.1f}" for t in np.percentile(v, (25, 50,
                                                                 75)))
    log(f"[train_tp] full-width step (loss, backward, reduce_grads, AdamW) "
        f"host ms per rank: "
        f"{[[round(t, 1) for t in r['train_tp']['step_ms']] for r in results]}"
        f"; quartiles 25/50/75 per rank (warm steps) "
        f"{[q(r['train_tp']['step_ms'][1:]) for r in results]} ({TP_WORLD} "
        f"ranks share the card and its host; gloo stages every exchange "
        f"and all-reduce through host memory); peak memory per rank "
        f"{[round(r['train_tp']['peak_gib'], 2) for r in results]} GiB; "
        f"launches per step per rank {r0['per_step']}")
    prof = r0["profile"]
    calls, span_ms = r0["tp_span"]
    log(f"[train_tp] rank 0's profiled step: wall {prof['wall_ms']:.1f} ms, "
        f"device busy {prof['busy_ms']:.1f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.0f}%); the TP "
        f"all-reduces (span repro_torch.tp.all_reduce) x{calls}, "
        f"{span_ms:.1f} ms of host time "
        f"({100 * span_ms / prof['wall_ms']:.1f}% of the wall)")
    log(f"[train_tp] mesh prefill (B=1 S={TRAIN_EP_S} per row block) and "
        f"{TP_TICKS} decode ticks, full-vocab logits against one process: "
        f"max |diff| {err_pre:.4g} / {err_ticks:.4g} (largest logit "
        f"{float(one_pre.abs().max()):.4g} / "
        f"{float(one_ticks.abs().max()):.4g}; limit 2e-2 of it); launches "
        f"per rank {r0['serve_counts']}")
    tr = r0["trainer"]
    log(f"[train_tp] Trainer.run at the cut width {TRAIN_EP_CUT} "
        f"({tr['n_params'] / 1e6:.1f} M params per rank): total_loss "
        f"{[round(v, 4) for v in tr['losses']]}, step ms (slowest rank) "
        f"{[round(v * 1e3, 1) for v in tr['seconds']]}; the async "
        f"checkpoint at step 2 ({r0['written'] / 2**30:.3f} GiB of global "
        f"arrays, written by rank 0) restored into a fresh Trainer bit for "
        f"bit on every rank")
    keys = r0["step_counts"]
    return {k: sum(r["train_tp"]["step_counts"][k]
                   + r["train_tp"]["serve_counts"][k] for r in results)
            for k in keys}


def phase_ulysses(results) -> dict:
    """[ulysses]'s gates: every attention leaf whole over ``model`` and
    partial; the ``model`` ranks of each row block bit-identical (router
    probabilities and top-k, whole leaves' reduced gradients and
    parameters after the step, the serving logits); every reduced
    gradient finite and non-zero and, gathered to rank 0, within
    TRAIN_GRAD_TOL of the one-process kernel step's at the fan-in init,
    the loss within 1e-2; prefill and decode logits within 2e-2 of the
    largest one-process logit; the launches of the loss + backward and
    of the step [train_tp]'s prediction, one flash ``wgmma`` launch per
    layer in the mesh prefill; the re-shard the definition bit for bit
    both ways, and the GQA all-gather path within 2e-2 of the flash
    kernel on the whole sequence.  Returns the mesh's launches (serving,
    loss + backward, step) over the ranks."""
    r0 = results[0]["ulysses"]
    cfg = _ulysses_config()
    mixer = {f"blocks/pos0/mixer/{w}" for w in ("wq", "wk", "wv", "wo")}
    by_block = {}
    for rank, r in enumerate(results):
        u = r["ulysses"]
        by_block.setdefault(u["block"], []).append(u)
        if not mixer <= set(u["partial"]) or mixer & set(u["model_axes"]):
            fail(f"[ulysses] rank {rank}: attention leaves not whole over "
                 f"model and partial: partial {u['partial']}")
        if not u["finite_nonzero"]:
            fail(f"[ulysses] rank {rank}: a reduced gradient leaf is not "
                 f"finite or is zero")
        for what, got in (("loss + backward", u["counts"]),
                          ("step", u["step_counts"])):
            if got != u["per_step"]:
                fail(f"[ulysses] rank {rank}'s {what} launched {got}, "
                     f"expected {u['per_step']}")
        sc = u["serve_counts"]
        if (sc["flash_attention"], sc["flash_attention_wgmma"]) != (
                cfg.n_layers, cfg.n_layers):
            fail(f"[ulysses] rank {rank}'s mesh prefill launched the flash "
                 f"kernel {sc['flash_attention']} times "
                 f"({sc['flash_attention_wgmma']} wgmma), expected "
                 f"{cfg.n_layers}")
        ex = u["exchanges"]
        bad = [k for k, v in ex["ok"].items() if not v]
        if bad or ex["gqa_launches"] != 1:
            fail(f"[ulysses] rank {rank}: {bad} not the definition bit for "
                 f"bit; the GQA path launched the flash kernel "
                 f"{ex['gqa_launches']} times, expected 1")
    for b, ranks in by_block.items():
        for t in ranks[1:]:
            for what in ranks[0]["digests"]:
                if t["digests"][what] != ranks[0]["digests"][what]:
                    fail(f"[ulysses] row block {b}: model rank "
                         f"{t['model']}'s {what} differ from model rank "
                         f"{ranks[0]['model']}'s bits")
            for a, w in zip(t["serve"], ranks[0]["serve"]):
                if not torch.equal(a, w):
                    fail(f"[ulysses] row block {b}: the model ranks' "
                         f"serving logits differ")
    worst = max(r0["vs_one"].items(), key=lambda kv: kv[1][0])
    if not worst[1][0] <= TRAIN_GRAD_TOL:
        fail(f"[ulysses] at the fan-in init the gathered gradient of "
             f"{worst[0]} lies {worst[1][0]:.3g} from the one-process "
             f"step's (limit {TRAIN_GRAD_TOL})")
    loss, one = r0["loss"], r0["one_loss"]
    if not abs(loss - one) <= 1e-2 * abs(one):
        fail(f"[ulysses] the loss {loss} vs the one-process {one} (limit "
             f"1e-2 relative)")
    pre = torch.cat([by_block[b][0]["serve"][0] for b in range(TP_BLOCKS)])
    ticks = torch.cat([by_block[b][0]["serve"][1] for b in range(TP_BLOCKS)])
    one_pre, one_ticks = r0["one_serve"]
    err_pre = _logit_gate("[ulysses] mesh prefill", pre, one_pre,
                          "one-process")
    err_ticks = _logit_gate(f"[ulysses] mesh decode ({TP_TICKS} ticks)",
                            ticks, one_ticks, "one-process")
    _check_held("ulysses", results, "ulysses")
    sp = dict(zip(TP_MESH[1], TP_MESH[0]))["model"]
    log(f"[ulysses] {cfg.name} d={cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} layers={cfg.n_layers} use_ulysses on (pod=2, "
        f"data=2, model=2), {TP_WORLD} gloo ranks of one card: each rank "
        f"projects {TRAIN_EP_S // sp} of its row block's {TRAIN_EP_S} "
        f"tokens with the whole attention weights (FSDP over (pod, data); "
        f"partial over model), the tiled all-to-all re-shards q (1, "
        f"{cfg.n_heads}, {TRAIN_EP_S // sp}, {cfg.hd}) to (1, "
        f"{cfg.n_heads // sp}, {TRAIN_EP_S}, {cfg.hd}) and k / v likewise "
        f"(Hkv {cfg.n_kv_heads} divides sp {sp}), the flash kernel runs on "
        f"q (1, {cfg.n_heads // sp}, {TRAIN_EP_S}, {cfg.hd}); the MoE under "
        f"TP as [train_tp]; the re-shard equal to the definition bit for "
        f"bit both ways on every rank")
    log(f"[ulysses] relative norm gaps per leaf, gathered ~ one-process "
        f"step at the fan-in init (limit {TRAIN_GRAD_TOL}), with ||mesh|| "
        f"/ ||one process||:")
    for path, (gap, a, b) in r0["vs_one"].items():
        log(f"[ulysses]   {path:32s} {gap:.3e} ({a:.4g} / {b:.4g})")
    sw = [r["ulysses"]["switched"] for r in results]
    log(f"[ulysses] loss {loss:.6g}, one process {one:.6g}; the mesh "
        f"replayed the one-process routing and would have routed otherwise "
        f"{sum(x['switched'] for x in sw) // sp} of "
        f"{sum(x['tokens'] for x in sw) // sp} (token, router call) pairs; "
        f"mesh prefill and {TP_TICKS} decode ticks vs one process: max "
        f"|diff| {err_pre:.4g} / {err_ticks:.4g} (largest logit "
        f"{float(one_pre.abs().max()):.4g} / "
        f"{float(one_ticks.abs().max()):.4g}; limit 2e-2 of it)")
    Hq, Hkv = ULYSSES_GQA
    log(f"[ulysses] the GQA all-gather path (heads {Hq}/{Hkv}, Hkv < sp): "
        f"max |diff| to the flash kernel on the whole sequence per rank "
        f"{[round(r['ulysses']['exchanges']['gqa_err'], 5) for r in results]}"
        f"; launches per rank: serving {r0['serve_counts']}, loss + "
        f"backward and step {r0['per_step']}")
    log(f"[ulysses] per rank on {_card()}: params (B) "
        f"{[round(r['ulysses']['n_params'] / 1e9, 4) for r in results]}, "
        f"state (GB) {[round(r['ulysses']['state_gb'], 3) for r in results]}"
        f", peak (GiB) "
        f"{[round(r['ulysses']['peak_gib'], 2) for r in results]}; host ms: "
        f"serving {[round(r['ulysses']['serve_ms'], 1) for r in results]}, "
        f"step {[round(r['ulysses']['step_ms'], 1) for r in results]}; "
        f"one-process reference {r0['one_s']:.1f} s, build "
        f"{r0['build_s']:.1f} s, gated loss + backward {r0['grad_s']:.1f} s;"
        f" [ulysses] {max(r['ulysses']['seconds'] for r in results):.1f} s")
    keys = r0["step_counts"]
    return {k: sum(r["ulysses"][w][k] for r in results
                   for w in ("serve_counts", "counts", "step_counts"))
            for k in keys}


def _rm_by_block(results, key: str, phase: str = "recurrent_mesh") -> dict:
    """Each row block's ranks' results of ``key``, every block present
    with |model| ranks; the model ranks of a block must agree bit for bit
    on their serving logits."""
    by_block = {}
    for r in results:
        t = r["recurrent_mesh"][key]
        by_block.setdefault(t["block"], []).append(t)
    if sorted(by_block) != list(range(TP_BLOCKS)) or any(
            len(v) != TP_WORLD // TP_BLOCKS for v in by_block.values()):
        fail(f"[{phase}] {key}: row blocks per rank "
             f"{[r['recurrent_mesh'][key]['block'] for r in results]}")
    for b, ranks in by_block.items():
        serve = lambda t: t["serve"] if "serve" in t else t
        for t in ranks[1:]:
            for k in ("pre", "ticks"):
                if not torch.equal(serve(t)[k], serve(ranks[0])[k]):
                    fail(f"[{phase}] {key} row block {b}: model rank "
                         f"{t['model']}'s {k} logits differ from model "
                         f"rank {ranks[0]['model']}'s bits")
    return by_block


def _rm_gate_xlstm(results) -> dict:
    """(b)'s gates: see :func:`phase_recurrent_mesh`.  Returns the
    mesh's launches (none)."""
    by_block = _rm_by_block(results, "xlstm")
    r0 = results[0]["recurrent_mesh"]["xlstm"]
    one = r0["one"]
    for rank, r in enumerate(results):
        t = r["recurrent_mesh"]["xlstm"]
        if not t["paired"]:
            fail(f"[recurrent_mesh] xlstm rank {rank}: no paired leaf")
        if t["n_params"] != t["layout_params"]:
            fail(f"[recurrent_mesh] xlstm rank {rank} holds {t['n_params']} "
                 f"parameters, its layout {t['layout_params']}")
        if not t["finite_nonzero"]:
            fail(f"[recurrent_mesh] xlstm rank {rank}: a reduced gradient "
                 f"leaf is not finite or is zero")
        if t["counts"] != _expected():
            fail(f"[recurrent_mesh] xlstm rank {rank} launched "
                 f"{t['counts']}, expected no kernel")
        for k, v in t["metrics"].items():
            if v != r0["metrics"][k]:
                fail(f"[recurrent_mesh] xlstm rank {rank}'s {k} {v} differs "
                     f"from rank 0's {r0['metrics'][k]}")
    for b, ranks in by_block.items():
        for t in ranks[1:]:
            if t["digests"] != ranks[0]["digests"]:
                fail(f"[recurrent_mesh] xlstm row block {b}: model rank "
                     f"{t['model']}'s whole leaves differ from model rank "
                     f"{ranks[0]['model']}'s bits")
    for what in ("grads", "params"):
        worst = max(r0[f"vs_one_{what}"].items(), key=lambda kv: kv[1])
        if not worst[1] <= TRAIN_GRAD_TOL:
            fail(f"[recurrent_mesh] xlstm: the gathered mesh {what} of "
                 f"{worst[0]} lie {worst[1]:.3g} from the one-process "
                 f"step's (relative norm; limit {TRAIN_GRAD_TOL})")
    m, w = r0["metrics"], one["metrics"]
    if not abs(m["total_loss"] - w["total_loss"]) <= 1e-2 * abs(
            w["total_loss"]) or not abs(m["grad_norm"] - w["grad_norm"]) \
            <= TRAIN_GRAD_TOL * w["grad_norm"]:
        fail(f"[recurrent_mesh] xlstm: mesh loss {m['total_loss']} / grad "
             f"norm {m['grad_norm']} vs one process {w['total_loss']} / "
             f"{w['grad_norm']} (limits 1e-2 / {TRAIN_GRAD_TOL} relative)")
    pre = torch.cat([by_block[b][0]["serve"]["pre"]
                     for b in range(TP_BLOCKS)])
    ticks = torch.cat([by_block[b][0]["serve"]["ticks"]
                       for b in range(TP_BLOCKS)])
    scale = float(one["serve"]["pre"].abs().max())
    gaps = (float((pre - one["serve"]["pre"]).abs().max()),
            float((ticks - one["serve"]["ticks"]).abs().max()))
    if not max(gaps) <= FVD_TOL * scale:
        fail(f"[recurrent_mesh] xlstm mesh prefill / ticks differ from "
             f"one process by {gaps} (largest logit {scale:.4g}; limit "
             f"{FVD_TOL} of it)")
    calls, tp_ms = r0["serve"]["tp_prefill"]
    from repro_torch.configs import get_config
    cfg = get_config(XLSTM).replace(n_layers=XLSTM_CUT_LAYERS)
    mixers = [m for m, _ in cfg.superblock] * cfg.n_superblocks
    want = 1 + 3 * mixers.count("mlstm") + 2 * mixers.count("slstm") + 1
    if calls != want:
        fail(f"[recurrent_mesh] xlstm's mesh prefill ran {calls} TP "
             f"collectives, expected {want}")
    cfg_s = (f"{cfg.name} x{cfg.n_layers} layers "
             f"({mixers.count('mlstm')} mLSTM, {mixers.count('slstm')} sLSTM)")
    worst_g = max(r0["vs_one_grads"].items(), key=lambda kv: kv[1])
    worst_p = max(r0["vs_one_params"].items(), key=lambda kv: kv[1])
    ranks = [r["recurrent_mesh"]["xlstm"] for r in results]
    log(f"[recurrent_mesh] (b) {cfg_s} at full width, fan-in init, on "
        f"(pod=2, data=2, model=2), {TP_WORLD} gloo ranks of one card: 2 of "
        f"4 mLSTM heads a rank (its [xi | z] columns of up paired), the "
        f"sLSTM cell whole on every rank, FSDP over (pod, data), all in "
        f"f32; one make_train_step step at B=1 S={RM_XLSTM_S} a row block "
        f"(chunkwise mLSTM): loss {m['total_loss']:.6g} (one process "
        f"{w['total_loss']:.6g}), grad norm {m['grad_norm']:.6g} "
        f"({w['grad_norm']:.6g}); every gathered gradient leaf within "
        f"{worst_g[1]:.3g} relative norm of the one-process step's (worst "
        f"{worst_g[0]}; limit {TRAIN_GRAD_TOL}), the parameters after it "
        f"within {worst_p[1]:.3g} ({worst_p[0]}); the model ranks' whole "
        f"leaves bit-identical; prefill (S={RM_XLSTM_S}) and "
        f"{TP_TICKS} ticks against one process: max |diff| {gaps[0]:.4g} / "
        f"{gaps[1]:.4g} (largest logit {scale:.4g}; limit {FVD_TOL} of it); "
        f"TP collectives a prefill {calls} (1 a vocab sum, 3 a mLSTM call, "
        f"2 an sLSTM call, 1 a logits gather), {tp_ms:.1f} ms of host time; "
        f"no kernel launched")
    log(f"[recurrent_mesh] (b) per rank on {_card()}: params (B) "
        f"{[round(t['n_params'] / 1e9, 4) for t in ranks]}, params and "
        f"AdamW state (GB) {[round(t['state_gb'], 3) for t in ranks]}, peak "
        f"(GiB) {[round(t['peak_gib'], 2) for t in ranks]}; host ms: step "
        f"{[round(t['step_ms'], 1) for t in ranks]}, prefill "
        f"{[round(t['serve']['pre_ms'], 1) for t in ranks]}, median tick "
        f"{[round(float(np.median(t['serve']['tick_ms'])), 1) for t in ranks]}"
        )
    return _expected()


def _rm_jamba_one_process(results, seed: int) -> tuple[dict, dict, dict]:
    """(a)'s one-process runs in the main process, after the world: the
    same parameters (``_fan_in_init``, the leaves the ranks drew), the
    global prompts and ticks, each router call replaying the mesh's
    choices (its row blocks' in block order): with the kernels in bf16,
    then in f32 on the plain versions (the parameters cast in place).
    Returns both serving results and the mesh's row blocks."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    by_block = _rm_by_block(results, "jamba")
    calls = len(by_block[0][0]["routes"])
    replay = [torch.cat([by_block[b][0]["routes"][i]
                         for b in range(TP_BLOCKS)]).to(DEVICE)
              for i in range(calls)]
    cfg = _rm_jamba_config()
    B, S, T = RM_JAMBA
    tokens = prefill_tokens(cfg, B, S)
    ticks = _tp_serve_tokens(cfg.vocab)[1][:, :T]
    model = build_model(cfg)
    params = _fan_in_init(model, cfg, seed)
    one = _rm_serve(model, params, tokens, ticks, replay=replay)
    _cast_in_place(params, torch.float32)
    torch.cuda.empty_cache()
    with ops.plain_versions():
        f32 = _rm_serve(build_model(cfg.replace(param_dtype="float32",
                                                compute_dtype="float32")),
                        params, tokens, ticks, replay=replay)
    del params, model
    torch.cuda.empty_cache()
    return one, f32, by_block


def phase_recurrent_mesh(results, seed: int) -> dict:
    """[recurrent_mesh]'s gates.  (b) xlstm, in f32: every rank holds the
    parameters its layout says, a paired leaf among them; its reduced
    gradients finite and non-zero; no kernel launched; the metrics the
    same on every rank; the model ranks of each row block bit-identical
    (whole leaves' reduced gradients and parameters, serving logits);
    every gathered gradient leaf and parameter after the step within
    TRAIN_GRAD_TOL relative norm of the one-process step's, the loss
    within 1e-2 and the grad norm within TRAIN_GRAD_TOL; the f32 prefill
    and ticks within FVD_TOL of the largest one-process logit; the
    prefill's TP collectives the prediction.  (a) jamba: each rank's
    parameters its layout's; no row block routes more than C tokens to
    an expert (no token dropped, so the one-process run, which replays
    the routing, is a reference); the launches of the prefill and of the
    ticks the prediction (:func:`_rm_jamba_geometry`; never ``simt``);
    the TP collectives of a prefill and of a tick the prediction; the
    decode state this rank's slice (mamba's ``ssm`` and ``conv`` over
    ``mlp``); the model ranks' logits bit-identical; the prefill and tick
    logits no farther from an f32 one-process run on the plain versions
    than FVD_RATIO times the bf16 one-process run (plus FVD_TOL of the
    largest logit), [recurrent]'s decode gate: in bf16 the roundings
    alone move jamba's logits by percents, the TP sums' other order
    among them.  Returns the launches over the ranks."""
    for key in ("xlstm", "jamba"):
        laps = [r["recurrent_mesh"][key]["times"] for r in results]
        slowest = {k: round(max(t[k] for t in laps), 1) for k in laps[0]}
        log(f"[recurrent_mesh] {key}: host seconds of each part, rank 0 "
            f"{ {k: round(v, 1) for k, v in laps[0].items()} }, the slowest "
            f"rank {slowest}")
    counts = _rm_gate_xlstm(results)
    t0 = time.perf_counter()
    one, f32, by_block = _rm_jamba_one_process(results, seed)
    one_s = time.perf_counter() - t0
    cfg = _rm_jamba_config()
    B, S, T = RM_JAMBA
    r0 = results[0]["recurrent_mesh"]["jamba"]
    geo = r0["geometry"]
    for rank, r in enumerate(results):
        t = r["recurrent_mesh"]["jamba"]
        if t["n_params"] != t["layout_params"] or not t["paired"]:
            fail(f"[recurrent_mesh] jamba rank {rank} holds {t['n_params']} "
                 f"parameters, its layout {t['layout_params']}; paired "
                 f"leaves {t['paired']}")
        want = _sum_counts(geo["prefill"]["launches"],
                           geo["ticks"]["launches"])
        if t["counts"] != want or t["counts"]["grouped_matmul_simt"]:
            fail(f"[recurrent_mesh] jamba rank {rank}'s prefill and "
                 f"{T} ticks launched {t['counts']}, expected {want}")
        for what, key, k in (("prefill", "tp_prefill", 1),
                             ("ticks", "tp_ticks", T)):
            if t[key][0] != k * geo[what]["tp_calls"]:
                fail(f"[recurrent_mesh] jamba rank {rank}: {t[key][0]} TP "
                     f"collectives in the {what}, expected "
                     f"{k} x {geo[what]['tp_calls']}")
        ssm = t["shapes"]["pos0/ssm"]
        Ein = cfg.ssm_expand * cfg.d_model
        if ssm != (cfg.n_superblocks, 1, Ein // 2, cfg.ssm_state) or \
                t["shapes"]["pos0/conv"] != (cfg.n_superblocks, 1,
                                             cfg.ssm_conv - 1, Ein // 2):
            fail(f"[recurrent_mesh] jamba rank {rank}'s mamba state "
                 f"{ssm} / {t['shapes']['pos0/conv']}: not this rank's "
                 f"{Ein // 2} of {Ein} channels")
    C = geo["prefill"]["C"]
    for b, ranks in by_block.items():
        for i, idx in enumerate(ranks[0]["routes"][:_moe_layers(cfg)]):
            most = int(torch.bincount(idx.reshape(-1),
                                      minlength=cfg.n_experts).max())
            if most > C:
                fail(f"[recurrent_mesh] jamba row block {b} routed {most} "
                     f"tokens to one expert in MoE layer {i}, over C={C}: "
                     f"tokens dropped, the one-process run is no reference")
    gaps = {}
    for k in ("pre", "ticks"):
        mesh = torch.cat([by_block[b][0][k] for b in range(TP_BLOCKS)])
        gap = lambda a, b: float((a - b).abs().max())
        gaps[k] = dict(one=gap(mesh, one[k]), mesh_f32=gap(mesh, f32[k]),
                       one_f32=gap(one[k], f32[k]),
                       scale=float(f32[k].abs().max()))
        g = gaps[k]
        if not g["mesh_f32"] <= FVD_RATIO * g["one_f32"] \
                + FVD_TOL * g["scale"]:
            fail(f"[recurrent_mesh] jamba mesh {k} logits lie "
                 f"{g['mesh_f32']:.4g} from the f32 one-process run, the "
                 f"bf16 one-process run {g['one_f32']:.4g} (limit "
                 f"{FVD_RATIO}x that, plus {FVD_TOL} of the largest logit "
                 f"{g['scale']:.4g})")
    ranks = [r["recurrent_mesh"]["jamba"] for r in results]
    Ein = cfg.ssm_expand * cfg.d_model
    log(f"[recurrent_mesh] (a) {cfg.name} d={cfg.d_model} "
        f"Ein={Ein} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} F={cfg.d_ff} E={cfg.n_experts} vocab={cfg.vocab} "
        f"x{cfg.n_layers} layers at full width, fan-in init, capacity "
        f"factor {cfg.capacity_factor}, on (pod=2, data=2, model=2): EP of "
        f"the {cfg.n_experts} experts over (data, pod), "
        f"{cfg.n_experts // TP_BLOCKS} a rank; mamba on {Ein // 2} of {Ein} "
        f"channels a rank (in_proj's [xs | z] paired), attention on "
        f"{cfg.n_heads // 2}/{cfg.n_kv_heads // 2} heads, the expert FFN on "
        f"{cfg.d_ff // 2} of F; FSDP over (pod, data).  "
        f"Prefill B={B} (one sequence a row block) S={S}: C={C}, plan "
        f"{geo['prefill']['backend']} x{geo['prefill']['n_chunks']} chunks; "
        f"{T} ticks: C={geo['ticks']['C']}, plan {geo['ticks']['backend']}. "
        f"Full-vocab logits, prefill / ticks, against the one-process runs "
        f"replaying the mesh's routing (the bf16 run's own would differ "
        f"for {one['switched'].get('switched', 0)} of "
        f"{one['switched'].get('tokens', 0)} (token, router call) pairs): "
        f"from the f32 plain run (largest logit "
        f"{gaps['pre']['scale']:.4g} / {gaps['ticks']['scale']:.4g}) the "
        f"mesh lies {gaps['pre']['mesh_f32']:.4g} / "
        f"{gaps['ticks']['mesh_f32']:.4g}, the bf16 one-process run "
        f"{gaps['pre']['one_f32']:.4g} / {gaps['ticks']['one_f32']:.4g} "
        f"(limit {FVD_RATIO}x that plus {FVD_TOL} of the largest); mesh vs "
        f"the bf16 one-process run {gaps['pre']['one']:.4g} / "
        f"{gaps['ticks']['one']:.4g}; "
        f"launches per rank {r0['counts']}; TP collectives a prefill "
        f"{r0['tp_prefill'][0]} ({r0['tp_prefill'][1]:.1f} host ms), a tick "
        f"{r0['tp_ticks'][0] // T} ({r0['tp_ticks'][1] / T:.1f} host ms): 2 "
        f"a mamba call, 1 an attention, dense FFN and MoE chunk call, 1 "
        f"vocab sum, 1 logits gather")
    log(f"[recurrent_mesh] (a) per rank on {_card()}: params (B) "
        f"{[round(t['n_params'] / 1e9, 4) for t in ranks]}, peak (GiB) "
        f"{[round(t['peak_gib'], 2) for t in ranks]}; host ms: draw "
        f"{[round(t['draw_ms'], 1) for t in ranks]}, prefill "
        f"{[round(t['pre_ms'], 1) for t in ranks]}, median tick "
        f"{[round(float(np.median(t['tick_ms'])), 1) for t in ranks]}; "
        f"one process (in {one_s:.1f} s, init and the f32 run "
        f"included): prefill {one['pre_ms']:.1f} ms, median tick "
        f"{float(np.median(one['tick_ms'])):.1f} ms")
    u_counts = _rm_gate_jamba_u(results, one, f32)
    world_s = max(r["recurrent_mesh"]["seconds"] for r in results)
    log(f"[recurrent_mesh] {world_s:.1f} s in the world")
    return {k: counts[k] + u_counts[k] + sum(
        r["recurrent_mesh"]["jamba"]["counts"][k] for r in results)
        for k in counts}


def _rm_gate_jamba_u(results, one, f32) -> dict:
    """(c)'s gates: each rank holds its layout's parameters, every
    attention leaf partial over model; the launches the prediction
    (:func:`_rm_jamba_geometry`: one flash
    ``wgmma`` a prefill, never ``simt``, the gmm and reorder passes as
    (a)'s), the one flash call on the rank's 16 of 32 query heads over
    the whole sequence; the model ranks' logits bit-identical; the
    prefill and tick logits no farther from (a)'s f32 one-process run
    (whose routing both replay) than FVD_RATIO times (a)'s bf16
    one-process run, plus FVD_TOL of the largest logit.  Returns the
    launches over the ranks."""
    cfg = _rm_jamba_config().replace(use_ulysses=True)
    _, S, T = RM_JAMBA
    by_block = _rm_by_block(results, "jamba_u")
    q_want = [(1, cfg.n_heads // 2, S, cfg.hd)]
    for rank, r in enumerate(results):
        t = r["recurrent_mesh"]["jamba_u"]
        attn = [p for p in t["partial"] if p.split("/")[-1] in
                ("wq", "wk", "wv", "wo")]
        if t["n_params"] != t["layout_params"] or len(attn) != 4:
            fail(f"[recurrent_mesh] (c) rank {rank} holds {t['n_params']} "
                 f"parameters, its layout {t['layout_params']}; partial "
                 f"attention leaves {attn}")
        geo = t["geometry"]
        want = _sum_counts(geo["prefill"]["launches"],
                           geo["ticks"]["launches"])
        if t["counts"] != want or t["counts"]["grouped_matmul_simt"] \
                or t["counts"]["flash_attention_simt"]:
            fail(f"[recurrent_mesh] (c) rank {rank}'s prefill and {T} "
                 f"ticks launched {t['counts']}, expected {want}")
        if t["q_shapes"] != q_want:
            fail(f"[recurrent_mesh] (c) rank {rank}'s attention calls took "
                 f"q {t['q_shapes']}, expected {q_want}: the rank's "
                 f"{cfg.n_heads // 2} heads over all {S} positions")
    gaps = {}
    for k in ("pre", "ticks"):
        mesh = torch.cat([by_block[b][0][k] for b in range(TP_BLOCKS)])
        gap = lambda a, b: float((a - b).abs().max())
        gaps[k] = dict(mesh_f32=gap(mesh, f32[k]), one_f32=gap(one[k], f32[k]),
                       one=gap(mesh, one[k]), scale=float(f32[k].abs().max()))
        g = gaps[k]
        if not g["mesh_f32"] <= FVD_RATIO * g["one_f32"] \
                + FVD_TOL * g["scale"]:
            fail(f"[recurrent_mesh] (c) jamba under use_ulysses: mesh {k} "
                 f"logits lie {g['mesh_f32']:.4g} from the f32 one-process "
                 f"run, the bf16 one-process run {g['one_f32']:.4g} (limit "
                 f"{FVD_RATIO}x that, plus {FVD_TOL} of the largest logit "
                 f"{g['scale']:.4g})")
    ranks = [r["recurrent_mesh"]["jamba_u"] for r in results]
    t0 = ranks[0]
    log(f"[recurrent_mesh] (c) {cfg.name} x{cfg.n_layers} layers at full "
        f"width under use_ulysses on (pod=2, data=2, model=2): the "
        f"attention layer sequence-parallel (q {t0['q_shapes']} a rank, "
        f"every attention leaf whole over model and partial), the mamba "
        f"mixers, the MoE and the head split as (a); prefill B={RM_JAMBA[0]}"
        f" S={S} and {T} ticks replaying (a)'s routing ((c)'s own would "
        f"differ for {t0['switched'].get('switched', 0)} of "
        f"{t0['switched'].get('tokens', 0)} pairs on rank 0): from the f32 "
        f"one-process run the mesh lies {gaps['pre']['mesh_f32']:.4g} / "
        f"{gaps['ticks']['mesh_f32']:.4g} (prefill / ticks), the bf16 one-"
        f"process run {gaps['pre']['one_f32']:.4g} / "
        f"{gaps['ticks']['one_f32']:.4g} (limit {FVD_RATIO}x plus {FVD_TOL} "
        f"of the largest, {gaps['pre']['scale']:.4g} / "
        f"{gaps['ticks']['scale']:.4g}); mesh vs the bf16 one-process run "
        f"{gaps['pre']['one']:.4g} / {gaps['ticks']['one']:.4g}; launches "
        f"per rank {_nonzero(t0['counts'])}; TP collectives a prefill "
        f"{t0['tp_prefill'][0]} ({t0['tp_prefill'][1]:.1f} host ms), a tick "
        f"{t0['tp_ticks'][0] // T} ({t0['tp_ticks'][1] / T:.1f} host ms)")
    log(f"[recurrent_mesh] (c) per rank on {_card()}: params (B) "
        f"{[round(t['n_params'] / 1e9, 4) for t in ranks]}, peak (GiB) "
        f"{[round(t['peak_gib'], 2) for t in ranks]}; host ms: draw "
        f"{[round(t['draw_ms'], 1) for t in ranks]}, prefill "
        f"{[round(t['pre_ms'], 1) for t in ranks]}, median tick "
        f"{[round(float(np.median(t['tick_ms'])), 1) for t in ranks]}; "
        f"(c) took {max(t['seconds'] for t in ranks):.1f} s of the world")
    return {k: sum(t["counts"][k] for t in ranks) for k in t0["counts"]}


def _em_expected(cfg, sh) -> dict:
    """[encdec_mesh]'s predicted launches and collectives per rank: the
    flash forward once an attention call in a prefill (``wgmma``), the
    encoder's calls in an encode, one cross call a decoder layer in a
    tick, and a training step's as :func:`_train_launches_per_step`; TP
    collectives one a row-parallel product or a Ulysses row gather (each
    attention call and each FFN), and where the vocab is split over
    ``model`` (not at whisper's 51865 or internvl2's 92553, both odd) the
    embedding's sum and the logits' gather; FSDP gathers one an FSDP
    leaf a use (the top-level leaves once a call, each layer's in it)."""
    A = _attn_layers(cfg)
    v = 2 if "embed" in sh.model_axes else 0
    per = lambda prefix: sum(p.startswith(prefix) for p in sh.fsdp_axes)
    flash = lambda k: _expected(flash_attention=k, flash_attention_wgmma=k)
    if cfg.encoder_layers:
        E, L = cfg.encoder_layers, cfg.n_layers
        enc = dict(counts=flash(E), tp=2 * E, fsdp=1 + E * per("encoder/"))
        tick = dict(counts=flash(L), tp=3 * L + v,
                    fsdp=1 + L * per("decoder/"))
        prefill = dict(counts=flash(A), tp=enc["tp"] + tick["tp"],
                       fsdp=enc["fsdp"] + tick["fsdp"])
        return {"prefill": prefill, "encode": enc, "tick": tick,
                "step": _train_launches_per_step(cfg)}
    top = sum("/" not in p for p in sh.fsdp_axes)
    return {"prefill": dict(counts=flash(A), tp=2 * cfg.n_layers + v,
                            fsdp=top + cfg.n_superblocks * per("blocks/")),
            "step": _train_launches_per_step(cfg)}


def phase_encdec_mesh(results) -> dict:
    """[encdec_mesh]'s gates, for (a) whisper-tiny, (a') the same under
    Ulysses and (b) internvl2-2b, all bf16 at the fan-in init on
    (pod=2, data=2, model=2): every rank holds the parameters its layout
    says (FSDP leaves among them), its reduced gradients finite and
    non-zero; the model ranks of each row block bit-identical (loss,
    whole leaves' reduced gradients and parameters after the step,
    prefill and tick logits); every gathered gradient leaf within
    TRAIN_GRAD_TOL relative norm of the one-process gradients of the
    global batch; the prefill's (and whisper's ticks') full-vocab logits
    within 2e-2 of the largest one-process logit; the flash launches of
    the prefill, the encode, the ticks and the step as
    :func:`_em_expected` predicts, never ``simt``; the TP collectives
    and FSDP gathers of the prefill, the encode and a tick as predicted;
    whisper's KV cache on the rank's kv heads.  Returns the launches
    over the ranks and the phase's seconds in the world."""
    from repro_torch.configs import get_config
    total = None
    B_w, S_w, T = EM_WHISPER
    layers, B_v, S_v = EM_INTERNVL
    cfgs = {"whisper": get_config(WHISPER),
            "ulysses": get_config(WHISPER).replace(use_ulysses=True),
            "internvl": get_config(INTERNVL).replace(n_layers=layers)}
    for key, cfg in cfgs.items():
        tag = f"[encdec_mesh] {key}"
        ranks = [r["encdec_mesh"][key] for r in results]
        r0 = ranks[0]
        one = r0["one"]
        want = r0["want"]
        by_block = {}
        for rank, t in enumerate(ranks):
            by_block.setdefault(t["block"], []).append(t)
            if t["n_params"] != t["layout_params"] or not t["fsdp_leaves"]:
                fail(f"{tag} rank {rank} holds {t['n_params']} parameters, "
                     f"its layout {t['layout_params']}; FSDP leaves "
                     f"{t['fsdp_leaves']}")
            if not t["finite_nonzero"]:
                fail(f"{tag} rank {rank}: a reduced gradient leaf is not "
                     f"finite or is zero")
            got = {"prefill": t["serve"]["prefill"], "step": t["step"]}
            if "encode" in t["serve"]:
                got.update(encode=t["serve"]["encode"],
                           tick=t["serve"]["tick_calls"])
            for what, info in got.items():
                w = want[what]
                counts = w["counts"] if isinstance(w, dict) and \
                    "counts" in w else w
                if what == "tick":
                    counts = {k: T * v for k, v in counts.items()}
                if info["counts"] != counts:
                    fail(f"{tag} rank {rank}'s {what} launched "
                         f"{info['counts']}, expected {counts}")
                if what == "step":
                    continue
                k = T if what == "tick" else 1
                calls = (info["calls"]["tp"][0],
                         info["calls"]["fsdp_gather"][0])
                if calls != (k * w["tp"], k * w["fsdp"]):
                    fail(f"{tag} rank {rank}'s {what}: {calls} TP "
                         f"collectives / FSDP gathers, expected "
                         f"{(k * w['tp'], k * w['fsdp'])}")
            if "cache_k" in t["serve"]:
                lay = (cfg.n_layers, B_w // TP_BLOCKS,
                       cfg.n_kv_heads // TP_MESH[0][0], T, cfg.hd)
                if t["serve"]["cache_k"] != lay:
                    fail(f"{tag} rank {rank}'s KV cache "
                         f"{t['serve']['cache_k']}, expected {lay}")
        if sorted(by_block) != list(range(TP_BLOCKS)) or any(
                len(v) != TP_WORLD // TP_BLOCKS for v in by_block.values()):
            fail(f"{tag}: row blocks per rank {[t['block'] for t in ranks]}")
        for b, rs in by_block.items():
            for t in rs[1:]:
                same = t["loss"] == rs[0]["loss"] and \
                    t["digests"] == rs[0]["digests"] and all(
                        torch.equal(t["serve"][k], rs[0]["serve"][k])
                        for k in ("pre", "ticks") if k in t["serve"])
                if not same:
                    fail(f"{tag} row block {b}: model rank {t['model']}'s "
                         f"loss, whole leaves or logits differ from model "
                         f"rank {rs[0]['model']}'s bits")
        worst = max(r0["vs_one"].items(), key=lambda kv: kv[1])
        if not worst[1] <= TRAIN_GRAD_TOL:
            fail(f"{tag}: the gathered mesh gradient of {worst[0]} lies "
                 f"{worst[1]:.3g} from the one-process one (relative norm; "
                 f"limit {TRAIN_GRAD_TOL})")
        gaps = {}
        for k in ("pre", "ticks"):
            if k not in r0["serve"]:
                continue
            mesh = torch.cat([by_block[b][0]["serve"][k]
                              for b in range(TP_BLOCKS)])
            ref = one["serve"][k]
            gaps[k] = (float((mesh - ref).abs().max()),
                       float(ref.abs().max()))
            if not gaps[k][0] <= 2e-2 * gaps[k][1]:
                fail(f"{tag}: the mesh's {k} logits lie {gaps[k][0]:.4g} "
                     f"from the one-process run's (largest logit "
                     f"{gaps[k][1]:.4g}; limit 2e-2 of it)")
        # each rank's loss is its row block's share times the blocks (a
        # make_train_step metric: already their mean)
        loss = float(np.mean([by_block[b][0]["loss"]
                              for b in range(TP_BLOCKS)]))
        if not abs(loss - one["loss"]) <= 1e-2 * abs(one["loss"]):
            fail(f"{tag}: the mesh's loss {loss:.6g} against the one "
                 f"process's {one['loss']:.6g} (limit 1e-2 relative)")
        log(f"{tag}: {cfg.name} x{cfg.n_layers} layers"
            f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
            f" d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
            f"(a rank {cfg.n_heads // 2}"
            f"{' over the whole sequence, Ulysses' if cfg.use_ulysses else ''}"
            f") F={cfg.d_ff} vocab={cfg.vocab}"
            f"{' (odd: whole over model)' if cfg.vocab % 2 else ''}, "
            f"{cfg.n_frontend_tokens} frontend tokens; bf16, fan-in init, "
            f"(pod=2, data=2, model=2), {TP_WORLD} gloo ranks of one card; "
            f"{'one AdamW step' if key == 'whisper' else 'one loss + backward'}"
            f": loss {loss:.6g} over the row blocks (one process "
            f"{one['loss']:.6g}; limit 1e-2 relative); every gathered "
            f"gradient leaf within "
            f"{worst[1]:.3g} relative norm of the one-process gradients "
            f"(worst {worst[0]}; limit {TRAIN_GRAD_TOL}); logits vs one "
            f"process (max |diff|, largest logit; limit 2e-2 of it) "
            f"{ {k: tuple(round(x, 5) for x in v) for k, v in gaps.items()} }"
            f"; model ranks bit-identical; launches a rank: prefill "
            f"{_nonzero(r0['serve']['prefill']['counts'])}, step "
            f"{_nonzero(r0['step']['counts'])}"
            + (f", encode {_nonzero(r0['serve']['encode']['counts'])}, "
               f"{T} ticks {_nonzero(r0['serve']['tick_calls']['counts'])}"
               if "encode" in r0["serve"] else ""))
        calls = lambda info: {k: (v[0], round(v[1], 1))
                              for k, v in info["calls"].items()}
        log(f"{tag} per rank on {_card()}: params (M) "
            f"{[round(t['n_params'] / 1e6, 2) for t in ranks]}, peak (GiB) "
            f"{[round(t['peak_gib'], 2) for t in ranks]}; host ms: prefill "
            f"{[round(t['serve']['prefill']['ms'], 1) for t in ranks]}, "
            f"step {[round(t['step']['ms'], 1) for t in ranks]}"
            + (f", median tick "
               f"{[round(float(np.median(t['serve']['tick_ms'])), 1) for t in ranks]}"
               if "tick_ms" in r0["serve"] else "")
            + f"; rank 0's collectives (calls, host ms): prefill "
            f"{calls(r0['serve']['prefill'])}, step {calls(r0['step'])}"
            + (f", {T} ticks {calls(r0['serve']['tick_calls'])}"
               if "tick_calls" in r0["serve"] else "")
            + f"; one process: prefill {one['serve']['prefill']['ms']:.1f} "
            f"ms, step {one['step_ms']:.1f} ms; host seconds of each part, "
            f"rank 0 { {k: round(v, 1) for k, v in r0['times'].items()} }")
        for t in ranks:
            parts = [t["serve"]["prefill"]["counts"], t["step"]["counts"]]
            if "encode" in t["serve"]:
                parts += [t["serve"]["encode"]["counts"],
                          t["serve"]["tick_calls"]["counts"]]
            for c in parts:
                total = c if total is None else _sum_counts(total, c)
    world_s = max(r["encdec_mesh"]["seconds"] for r in results)
    log(f"[encdec_mesh] {world_s:.1f} s in the world")
    return total, world_s


def _nonzero(counts: dict) -> dict:
    """The non-zero entries of a launch count."""
    return {k: v for k, v in counts.items() if v}


def phase_overlap_grad(results) -> dict:
    """[rules_mesh] (c)'s gates: the plan is the overlap engine over more
    than one chunk; on every rank the output and the input gradient of
    ``overlap(x, f, reverse=False)`` under autograd are those of
    ``f(forward(x))`` bit for bit, and its forward and backward each
    launched n_chunks x ``round_schedule``'s passes (the backward in the
    reverse round order).  Returns the launches over the ranks."""
    r0 = results[0]["overlap_grad"]
    if r0["backend"] != "overlap" or r0["n_chunks"] < 2:
        fail(f"[rules_mesh] (c) the plan is {r0['backend']} over "
             f"{r0['n_chunks']} chunk(s), expected the overlap engine over "
             f"more than one")
    for rank, r in enumerate(results):
        t = r["overlap_grad"]
        if not (t["y_equal"] and t["g_equal"]):
            fail(f"[rules_mesh] (c) rank {rank}: overlap(reverse=False) "
                 f"under autograd differs from f(forward(x)): output equal "
                 f"{t['y_equal']}, gradient equal {t['g_equal']}")
        for d in ("forward", "backward"):
            if t[d] != t[f"predicted_{d}"]:
                fail(f"[rules_mesh] (c) rank {rank}'s {d} launched {t[d]}, "
                     f"expected {t[f'predicted_{d}']}")
    log(f"[rules_mesh] (c) on {_card()}: overlap(x, 2 sin(x), "
        f"reverse=False) under autograd on the (data=2, pod=2) torus, "
        f"[moe_ep]'s block ({r0['mib']:.1f} MiB bf16 a rank, C={r0['C']}, "
        f"{r0['n_chunks']} chunks): output and input gradient equal to "
        f"2 sin(forward(x))'s bit for bit on {WORLD} ranks; reorder "
        f"launches per rank forward "
        f"{ {k: v for k, v in r0['forward'].items() if v} }, backward "
        f"{ {k: v for k, v in r0['backward'].items() if v} } (as "
        f"predicted); host ms per rank forward "
        f"{[round(r['overlap_grad']['forward_ms'], 1) for r in results]}, "
        f"backward "
        f"{[round(r['overlap_grad']['backward_ms'], 1) for r in results]}")
    keys = r0["forward"]
    return {k: sum(r["overlap_grad"]["forward"][k]
                   + r["overlap_grad"]["backward"][k] for r in results)
            for k in keys}


def phase_rules_mesh(results) -> dict:
    """[rules_mesh] (a) and (b)'s gates.  (a), per rule set: every rank
    holds what its layout says, its reduced gradient is finite and
    non-zero, its loss + backward launched the prediction (SIMT 0), and
    the ``model`` ranks of each ``(pod, data)`` coordinate end with the
    same bits of every leaf none of them splits; gathered to rank 0,
    every leaf within TRAIN_GRAD_TOL of [train_tp]'s default-rules step
    on the same weights, batch and routing, and the loss within 1e-2.
    (b): ranks 5, 6 lost at step 5 and their partners 4, 7 leave at step
    4; ranks 0-3 recover once onto (data 2, model 2), finish at step 6
    and equal the direct restore of the step-3 checkpoint plus the same
    steps bit for bit.  Returns the launches of both legs over the
    ranks."""
    ranks = [r["rules_mesh"] for r in results]
    r0 = ranks[0]
    tp_loss = results[0]["train_tp"]["loss"][TP_GATED[0]]
    out = {}
    for tag in RULES_MESH:
        by_coord = {}
        for rank, r in enumerate(ranks):
            t = r["cases"][tag]
            by_coord.setdefault(r["coord"], []).append(t)
            if t["n_params"] != t["layout_params"]:
                fail(f"[rules_mesh] {tag} rank {rank} holds {t['n_params']} "
                     f"parameters, its layout {t['layout_params']}")
            if not t["finite_nonzero"]:
                fail(f"[rules_mesh] {tag} rank {rank}: a reduced gradient "
                     f"leaf is not finite or is zero")
            if t["counts"] != t["per_step"]:
                fail(f"[rules_mesh] {tag} rank {rank}'s loss + backward "
                     f"launched {t['counts']}, expected {t['per_step']}")
            for k, v in t["counts"].items():
                out[k] = out.get(k, 0) + v
        for coord, ts in by_coord.items():
            if any(t["digests"] != ts[0]["digests"] for t in ts[1:]):
                fail(f"[rules_mesh] {tag}: the model ranks of (pod, data) "
                     f"{coord} differ in the bits of a leaf none splits")
        t0 = r0["cases"][tag]
        worst = max(t0["vs_tp"].items(), key=lambda kv: kv[1])
        if not worst[1] <= TRAIN_GRAD_TOL:
            fail(f"[rules_mesh] {tag}: the gathered gradient of {worst[0]} "
                 f"lies {worst[1]:.3g} from [train_tp]'s default-rules "
                 f"step (limit {TRAIN_GRAD_TOL})")
        if not abs(t0["loss"] - tp_loss) <= 1e-2 * abs(tp_loss):
            fail(f"[rules_mesh] {tag}: loss {t0['loss']} vs [train_tp]'s "
                 f"{tp_loss} (limit 1e-2 relative)")
        log(f"[rules_mesh] (a) {tag} on {_card()}: FSDP axes {t0['kept']}, "
            f"row blocks of {t0['rows']} row(s) (C={t0['C']}, plan "
            f"{t0['backend']}), copies per row block divided out "
            f"{t0['repeats']}; loss {t0['loss']:.6g} ([train_tp] "
            f"{tp_loss:.6g}); worst leaf gap to [train_tp]'s step "
            f"{worst[1]:.3e} ({worst[0]}, limit {TRAIN_GRAD_TOL}); the "
            f"router would have switched "
            f"{sum(r['cases'][tag]['switched']['switched'] for r in ranks)} "
            f"of {sum(r['cases'][tag]['switched']['tokens'] for r in ranks)}"
            f" (token, call) pairs without the replay; loss + backward host "
            f"ms per rank {[round(r['cases'][tag]['ms'], 1) for r in ranks]}"
            f", build s {t0['build_s']:.1f}, peak GiB per rank "
            f"{[round(r['cases'][tag]['peak_gib'], 2) for r in ranks]}; "
            f"launches per rank {t0['counts']} (as predicted)")
        log(f"[rules_mesh] (a) {tag}: leaf gaps " + ", ".join(
            f"{p} {v:.2e}" for p, v in t0["vs_tp"].items()))
    survivors = [r for r in range(TP_WORLD)
                 if r not in RULES_LOST + RULES_PARTNERS]
    for rank, r in enumerate(ranks):
        b = r["elastic"]
        if b["fired"] != [("device_loss", "train_step", ELASTIC_LOSS_AT)]:
            fail(f"[rules_mesh] (b) rank {rank}: the loss fired {b['fired']}")
        if rank not in survivors:
            if b["status"] != "lost" or b["step"] != ELASTIC_LOSS_AT - 1:
                fail(f"[rules_mesh] (b) rank {rank} did not leave: "
                     f"{b['status']} at step {b['step']}")
            continue
        checks = {
            "done": b["status"] == "done" and b["step"] == ELASTIC_STEPS,
            "one recovery": b["recoveries"] == 1 and b["rebuilds"] == 1,
            "survivor mesh": b["mesh"] == survivors
            and b["dims"] == {"pod": 1, "data": 2, "model": 2},
            "direct restore": b["direct_equal"]}
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"[rules_mesh] (b) survivor {rank}: {bad} wrong: {b}")
        for k, v in b["counts"].items():
            out[k] = out.get(k, 0) + v
    if [ranks[r]["elastic"]["writer"] for r in survivors] \
            != [True] + [False] * (len(survivors) - 1):
        fail("[rules_mesh] (b) the checkpoint writer is not the survivor at "
             "mesh coordinate 0")
    b0 = r0["elastic"]
    WRITTEN["rules_mesh"] = b0["written"]
    if sum(WRITTEN.values()) > DISK_WRITE_BUDGET:
        fail(f"[rules_mesh] the checkpoints wrote {b0['written'] / 2**30:.2f}"
             f" GiB, over the run's disk budget")
    log(f"[rules_mesh] (b) on {_card()}: Trainer(elastic=True) at the cut "
        f"width {TRAIN_EP_CUT} on (pod=2, data=2, model=2), device loss of "
        f"ranks {list(RULES_LOST)} at step {ELASTIC_LOSS_AT}: ranks "
        f"{sorted(RULES_LOST + RULES_PARTNERS)} left at step "
        f"{ELASTIC_LOSS_AT - 1}; survivors {survivors} recovered onto "
        f"{b0['dims']} (rebuild_fn {b0['rebuild_s']:.2f} s), done at step "
        f"{b0['step']} in {b0['run_s']:.1f} s; total_loss "
        f"{[round(v, 4) for v in b0['losses']]}, step s "
        f"{[round(v, 3) for v in b0['seconds']]}; final state equal to the "
        f"direct restore of step {ELASTIC_EVERY} plus the same steps bit "
        f"for bit; {b0['written'] / 2**30:.3f} GiB of checkpoints")
    log(f"[rules_mesh] (a) + (b): "
        f"{max(r['rules_mesh']['seconds'] for r in results):.1f} s of the "
        f"run (the slowest rank)")
    return out


def phase_ring(results) -> float:
    """[ring]'s log (each rank compared its shard with the flash kernel
    within 2e-2 as it ran); returns its seconds."""
    B, Hq, Hkv, S, hd = RING_SHAPE
    ring = [r["ring"] for r in results]
    log(f"[ring] ring attention over (model={WORLD}) on {WORLD} gloo ranks "
        f"of one card: q ({B}, {Hq}, {S} / {WORLD}, {hd}), kv heads {Hkv}, "
        f"bf16, causal, f32 partial sums, k and v rotating by ppermute "
        f"({WORLD - 1} steps); max |diff| to the flash kernel on the whole "
        f"sequence per rank {[round(t['errs'][None], 5) for t in ring]}, "
        f"window {RING_WINDOW} "
        f"{[round(t['errs'][RING_WINDOW], 5) for t in ring]}"
        f" (limit rtol = atol = 2e-2); host ms per call "
        f"{[round(t['ms'][None], 1) for t in ring]} / "
        f"{[round(t['ms'][RING_WINDOW], 1) for t in ring]}; "
        f"{max(t['seconds'] for t in ring):.1f} s")
    return max(t["seconds"] for t in ring)


def phase_pipeline(results) -> float:
    """[pipeline]'s gates: each stage's gradients within TRAIN_GRAD_TOL
    relative norm of the sequential run's (the forward was held within
    2e-2 of its largest |y| on each rank); returns its seconds."""
    L, D, H, rows, M = PIPE_SHAPE
    pipe = [r["pipeline"] for r in results]
    if sorted(t["stage"] for t in pipe) != list(range(WORLD)):
        fail(f"[pipeline] stages {[t['stage'] for t in pipe]}")
    for t in pipe:
        if not max(t["gaps"]) <= TRAIN_GRAD_TOL:
            fail(f"[pipeline] stage {t['stage']}'s gradients lie "
                 f"{t['gaps']} from the sequential run's (limit "
                 f"{TRAIN_GRAD_TOL} relative norm)")
    log(f"[pipeline] GPipe over (pod={WORLD}) on {WORLD} gloo ranks of one "
        f"card: {WORLD} stages x {L} residual MLP layers (D {D}, H {H}, "
        f"bf16), {rows} rows in {M} microbatches (bubble "
        f"{pipe[0]['bubble']:.2f}): forward max |diff| to the sequential "
        f"run per stage {[round(t['err'], 5) for t in pipe]} (largest |y| "
        f"{pipe[0]['max']:.4g}, limit 2e-2 of it); w1 / w2 gradient gaps "
        f"{[[round(g, 5) for g in t['gaps']] for t in pipe]} (limit "
        f"{TRAIN_GRAD_TOL}); forward host ms "
        f"{[round(t['ms'], 1) for t in pipe]}; "
        f"{max(t['seconds'] for t in pipe):.1f} s")
    return max(t["seconds"] for t in pipe)


def phase_fft(results) -> dict:
    """[fft]'s gates (each rank checked its pencils as it ran: ``ok``) and
    its log: per case the stage backends, the errors on every rank, the
    median host ms of a forward, an inverse and each transpose with the
    bytes it moves, the reorder launches; (e)'s gap; the traced
    forward's rounds.  Returns the launches over all ranks."""
    bad = _bad(results, "fft")
    if bad:
        fail(f"[fft] failed: {bad}")
    fr = [r["fft"] for r in results]
    for tag, c in fr[0]["cases"].items():
        per = [f["cases"][tag] for f in fr]
        errs = [f"{p['err']:.3g}" for p in per]
        rts = [f"{p['rt']:.3g}" for p in per]
        steps = "; ".join(
            f"transpose[{k}] {b} {pb / 2**20:g} MiB a rank, "
            f"{mv / 2**20:g} MiB of it off-rank, {ms:.1f} ms"
            for k, b, pb, mv, ms in c["transposes"])
        log(f"[fft] {tag}: stage backends {c['backends']}; forward max "
            f"|err| / max |coefficient| per rank {errs}, round trip {rts} "
            f"(limits {FFT_TOL}); host ms "
            f"(median of {FFT_TIMED} after a warm-up) per rank: forward "
            f"{[round(p['fwd_ms'], 1) for p in per]}, inverse "
            f"{[round(p['inv_ms'], 1) for p in per]}; rank 0 {steps}; "
            f"reorder launches per rank forward / inverse "
            f"{c['launches'][0]} / {c['launches'][1]}")
    cv = [f["conv"] for f in fr]
    gaps = [f"{c['gap']:.3g}" for c in cv]
    B, S = FFT_CONV
    log(f"[fft] (e) distributed_fft_causal_conv at jamba's mixer width "
        f"(B {B}, S {S}, E {cv[0]['E']}; L {2 * S}, a rank's slab "
        f"({2 * S // WORLD}, {B * cv[0]['E']}) complex64): rows per rank "
        f"{[c['rows'] for c in cv]}, max |rows - one-process conv| "
        f"{gaps} of {cv[0]['max']:.4g} (limit "
        f"{FFT_CONV_TOL} of it); host ms per call (median of {FFT_TIMED}) "
        f"{[round(c['ms'], 1) for c in cv]}, one process "
        f"{[round(c['one_ms'], 1) for c in cv]}")
    tr = [f["tracing"] for f in fr]
    log(f"[tracing] (fft) one traced (b) factorized slab forward per rank, "
        f"equal to the untraced one bit for bit, span tree as the CPU "
        f"test's; plan.round host µs per rank "
        f"{[[(a, round(us, 1)) for a, us in t['rounds']] for t in tr]}; "
        f"measured / predicted {[round(t['ratio'], 4) for t in tr]} (one "
        f"card, gloo: not the model's links)")
    secs = max(f["seconds"] for f in fr)
    log(f"[fft] peak memory per rank (GiB) "
        f"{[round(f['peak_gib'], 2) for f in fr]}; {secs:.1f} s in the "
        f"world; {_card()}")
    return {k: sum(f["counts"][k] for f in fr) for k in fr[0]["counts"]}


def phase_serve_disagg(results) -> dict:
    """[serve_disagg]'s gates: every rank's tokens equal the colocated
    run's bit for bit in (a) and, on the survivors, (b); the launches of
    each run (gmm: 6 ``decode`` a ``decode_step``; reorder in (a): the
    handoffs times the plan's passes; (b)'s rebuild changes the plan, so
    only its gmm launches are predicted); (c)'s rows (checked by the
    ranks).  Prints the times and bytes.  Returns the launches of (a) and
    (b) over all ranks."""
    bad = _bad(results, "serve_disagg")
    if bad:
        fail(f"[serve_disagg] failed: {bad}")
    sd = [r["serve_disagg"] for r in results]
    ref = sd[0]["colocated"]
    total = dict.fromkeys(sd[0]["runs"]["tuned"]["counts"], 0)
    gmm = 3 * DISAGG_LAYERS
    runs = {f"(a) {b}": [s["runs"][b] for s in sd] for b in DISAGG_BACKENDS}
    runs["(b)"] = [s["rebuild"] for s in sd]
    for tag, per_rank in runs.items():
        for rank, r in enumerate(per_rank):
            for k, v in r["counts"].items():
                total[k] += v
            want = _expected(grouped_matmul=gmm * r["steps"],
                             grouped_matmul_decode=gmm * r["steps"],
                             **{k: r["migrations"] * v
                                for k, v in r["per_handoff"].items()})
            got = dict(r["counts"])
            if tag == "(b)":
                for k in REORDER_OPS:
                    got[k] = want[k] = 0
            if got != want:
                fail(f"[serve_disagg] {tag}: rank {rank} launched "
                     f"{r['counts']} in {r['steps']} decode_steps and "
                     f"{r['migrations']} handoffs, expected {want}")
            if r["lost"]:
                continue
            if r["done"] != ref["done"]:
                diff = sorted(k for k in ref["done"]
                              if r["done"].get(k) != ref["done"][k])
                fail(f"[serve_disagg] {tag}: rank {rank}'s tokens differ "
                     f"from the colocated run's for requests {diff}")
        r0 = per_rank[0]
        d = r0["describe"]
        log(f"[serve_disagg] {tag}: every rank's tokens equal the colocated "
            f"run's ({len(ref['done'])} requests); {r0['ticks']} ticks, "
            f"host {r0['ms'] / r0['ticks']:.2f} ms a tick (colocated "
            f"{ref['ms'] / ref['ticks']:.2f} over {ref['ticks']} ticks); "
            f"{r0['migrations']} handoffs, {r0['migrated_rows']} rows; plan "
            f"{d['inner_kind']} / {d['backend']} (bucket {d['bucket']}, "
            f"row {d['row_bytes']} B); serve.kv_migrate ms (rank 0..3) "
            f"{[[round(t, 2) for t in r['handoff_ms']] for r in per_rank]}; "
            f"decode_steps per rank {[r['steps'] for r in per_rank]}; "
            f"throttled admissions {r0['throttled']}; lost ranks "
            f"{[k for k, r in enumerate(per_rank) if r['lost']]}")
    r = sd[0]["runs"]["tuned"]
    useful = r["migrated_rows"] * r["row_bytes"] / max(1, r["migrations"])
    log(f"[serve_disagg] bytes per handoff a rank: the (p, bucket, row) "
        f"send block {r['block_bytes'] / 2**20:.2f} MiB; the useful rows "
        f"{useful / 2**20:.2f} MiB a handoff over all pairs")
    h = [s["handoff"] for s in sd]
    log(f"[serve_disagg] (c) one handoff at phi's full-depth row ({h[0]['F']}"
        f" f32 features, {h[0]['F'] * 4 / 1024:.1f} KiB), rows "
        f"{KV_HANDOFF} from ranks 0, 1 to 2, 3, send block "
        f"{h[0]['block_gb']:.2f} GB a rank: rows bit for bit through "
        f"{list(h[0]['kinds'].items())}; host ms a call per rank "
        + "; ".join(f"{b} {[round(x['ms'][b], 1) for x in h]}"
                    for b in DISAGG_BACKENDS))
    log(f"[serve_disagg] peak memory per rank (GiB) "
        f"{[round(s['peak_gib'], 2) for s in sd]}; "
        f"{max(s['seconds'] for s in sd):.1f} s in the world; {_card()}")
    return total


def _train_launches_per_step(cfg) -> dict:
    """Predicted launches of one training step with remat: per attention
    layer the flash forward twice (forward and remat recompute) and its
    backward once; per MoE layer the 3 gmm twice and two gmm per forward
    gmm."""
    A, M = _attn_layers(cfg), _moe_layers(cfg)
    return _expected(flash_attention_fwd=2 * A,
                     flash_attention_fwd_wgmma=2 * A, flash_attention_bwd=A,
                     flash_attention_bwd_wgmma=A,
                     grouped_matmul=(3 + 3 + 6) * M,
                     grouped_matmul_wgmma=(3 + 3 + 6) * M)


def _check_grads(leaves, got, want, tag: str = "train"):
    """Every leaf's kernel-path gradient exists, is finite and non-zero
    and lies within TRAIN_GRAD_TOL relative norm of the plain path's."""
    worst = (0.0, "")
    for (path, _), g, w in zip(leaves, got, want):
        if g is None or w is None:
            fail(f"[{tag}] no gradient for {path}")
        g, w = g.to(DEVICE).float(), w.to(DEVICE).float()
        norm = float(g.norm())
        if not torch.isfinite(g).all() or norm == 0.0:
            fail(f"[{tag}] gradient of {path} is not finite or is zero "
                 f"(norm {norm})")
        rel = float((g - w).norm() / w.norm())
        if not rel <= TRAIN_GRAD_TOL:
            fail(f"[{tag}] gradient of {path} differs from the plain path's "
                 f"by {rel:.3g} relative norm (limit {TRAIN_GRAD_TOL})")
        worst = max(worst, (rel, path))
    return worst


def _rel_gaps(got, want) -> list:
    """``||got - want|| / ||want||`` per leaf."""
    return [float((g.to(DEVICE).float() - w.to(DEVICE).float()).norm()
                  / w.to(DEVICE).float().norm()) for g, w in zip(got, want)]


@contextlib.contextmanager
def _fa2_in_plain_torch():
    """The witness run: every op takes its plain version, except that
    ``ops.attention`` applies ``FlashAttentionFn`` over
    ``flash_attention_fwd_plain`` / ``flash_attention_bwd_plain`` (the
    kernels' own FA2 formulas: p from lse, delta from the bf16-rounded O)
    instead of autograd of the plain forward.  Its gap to the plain path
    is the formulas'; its gap to the kernel path is the kernels'."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops
    saved = ops.attention, fab.flash_attention_fwd, fab.flash_attention_bwd

    def attention(q, k, v, *, causal=True, window=None, kv_offset=0,
                  impl=None):
        return fab.FlashAttentionFn.apply(q, k, v, causal, window, None,
                                          kv_offset)
    ops.attention = attention
    fab.flash_attention_fwd = fab.flash_attention_fwd_plain
    fab.flash_attention_bwd = fab.flash_attention_bwd_plain
    try:
        with ops.plain_versions():
            yield
    finally:
        ops.attention, fab.flash_attention_fwd, fab.flash_attention_bwd = \
            saved


@contextlib.contextmanager
def _routing(record: list | None = None, replay: list | None = None):
    """``torch.topk`` (on the training path only the MoE router calls it)
    appending its indices to ``record``, or, given ``replay``, returning
    the recorded indices in call order with the gates gathered from this
    run's own probabilities.  Yields the number of (token, top-k set)
    choices this run would have made otherwise, and of all tokens."""
    real = torch.topk
    stats = {"switched": 0, "tokens": 0}
    calls = iter(replay or ())

    def topk(x, k, dim=-1, *args, **kwargs):
        out = real(x, k, dim, *args, **kwargs)
        if replay is None:
            record.append(out.indices.detach().clone())
            return out
        idx = next(calls)
        stats["switched"] += int((out.indices.sort(-1).values
                                  != idx.sort(-1).values).any(-1).sum())
        stats["tokens"] += idx.shape[0]
        return x.gather(dim, idx), idx
    torch.topk = topk
    try:
        yield stats
    finally:
        torch.topk = real


def _grad_gate(model, params, batch, per_step, label: str,
               f32: bool = False, tensor_core_ref: bool = False,
               tag: str = "train", witness: bool = True,
               offload: bool = False):
    """One loss + backward with the kernels, one on the plain versions and
    one FA2 witness (:func:`_fa2_in_plain_torch`) from the same params and
    batch.  With ``tensor_core_ref`` the plain and witness runs take the
    expert matmul on the tensor cores (:func:`_tensor_core_gmm`), and one
    more run on the plain versions as they stand is logged against both
    paths.  The plain and witness runs replay the kernel run's routing, so
    a near-tie in the router (a token whose top-2 differs in the last bf16
    bit) does not move tokens between experts; the number of such tokens
    is logged.  Gates the kernel path against the plain one (every leaf,
    and the loss at 1e-2 relative), checks that the remat recompute
    routes as the forward did, and logs each leaf's three gaps.  With
    ``f32`` it also runs the plain path in f32 (parameters and compute,
    same routing) and fails unless every leaf of the kernel path lies
    within F32_GAP_RATIO times the plain path's distance from it: bf16
    rounding sets the floor both paths sit on.  ``witness=False`` skips
    the FA2 witness; ``offload`` keeps each path's gradients in host
    memory once computed (a model whose gradient trees do not fit the
    card beside its parameters), and the comparisons move one leaf at a
    time back to the card."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    leaves = tree_leaves(params)

    def loss_and_grads():
        total, _ = model.loss(params, batch)
        return float(total.detach()), torch.autograd.grad(
            total, [t for _, t in leaves])
    routes = []
    _reset_counts()
    with _routing(record=routes):
        (loss, got), ms = _host_ms(loss_and_grads)
    if _read_counts() != per_step:
        fail(f"[{tag}] loss + backward launched {_read_counts()}, expected "
             f"{per_step}")
    # forward, then the recompute: superblocks in reverse, the positions
    # of each in order
    m = max(1, _moe_layers(model.cfg) // model.cfg.n_superblocks)
    fwd = [routes[i:i + m] for i in range(0, len(routes) // 2, m)]
    rec = [routes[i:i + m] for i in range(len(routes) // 2, len(routes), m)]
    if len(routes) != 2 * _moe_layers(model.cfg) or not all(
            torch.equal(a, b) for f, r in zip(fwd, reversed(rec))
            for a, b in zip(f, r)):
        fail(f"[{tag}] the remat recompute routed otherwise than the "
             f"forward ({len(routes)} router calls)")
    if offload:
        got = [g.to("cpu") for g in got]
    ref_gmm = _tensor_core_gmm if tensor_core_ref else contextlib.nullcontext
    with ops.plain_versions(), ref_gmm(), \
            _routing(replay=routes) as switched:
        (loss_p, want), ms_p = _host_ms(loss_and_grads)
    if offload:
        want = [w.to("cpu") for w in want]
    if not math.isfinite(loss) or abs(loss - loss_p) > 1e-2 * abs(loss_p):
        fail(f"[{tag}] loss {loss} vs plain {loss_p} (limit 1e-2 relative)")
    worst, worst_path = _check_grads(leaves, got, want, tag)
    gaps, cols, loss_w = [_rel_gaps(got, want)], "kernels~plain", None
    if witness:
        with ref_gmm(), _fa2_in_plain_torch(), _routing(replay=routes):
            loss_w, wit = loss_and_grads()
        gaps += [_rel_gaps(wit, want), _rel_gaps(got, wit)]
        del wit
        cols += ", FA2 witness~plain, kernels~FA2 witness"
    if tensor_core_ref:
        with ops.plain_versions(), _routing(replay=routes):
            loss_s, stand = loss_and_grads()
        gaps += [_rel_gaps(got, stand), _rel_gaps(want, stand)]
        del stand
        cols = (f"{cols} (plain: with the gmm on the tensor cores), "
                f"kernels~plain as it stands, plain~plain as it stands "
                f"(loss {loss_s:.6g})")
    if f32:
        model32 = build_model(model.cfg.replace(param_dtype="float32",
                                                compute_dtype="float32"))
        params32 = tree_map(lambda t: t.detach().float().requires_grad_(True),
                            params)
        with ops.plain_versions(), _routing(replay=routes):
            total, _ = model32.loss(params32, batch)
            ref = torch.autograd.grad(
                total, [t for _, t in tree_leaves(params32)])
        loss_32 = float(total.detach())
        del params32, total
        gaps += [_rel_gaps(got, ref), _rel_gaps(want, ref)]
        del ref
        for (path, _), kf, pf in zip(leaves, gaps[-2], gaps[-1]):
            if not kf <= F32_GAP_RATIO * pf:
                fail(f"[{tag}] {label}: the kernel path's gradient of {path} "
                     f"lies {kf:.3g} from the f32 one, the plain path's "
                     f"{pf:.3g} (limit {F32_GAP_RATIO}x)")
        cols += f", kernels~f32, plain~f32 (f32 loss {loss_32:.6g})"
    del got, want
    B, S = batch["tokens"].shape
    log(f"[{tag}] {label}: loss + backward (B={B}, S={S}): "
        f"loss {loss:.6g}, plain {loss_p:.6g}"
        + (f", FA2 witness {loss_w:.6g}" if witness else "") + "; "
        f"the plain path's own top-{model.cfg.top_k} differs from the "
        f"kernel path's for {switched['switched']} of "
        f"{switched['tokens']} (token, router call) pairs, recompute "
        f"included (replayed); the "
        f"recompute routed as the forward; all {len(leaves)} leaves' "
        f"gradients finite, non-zero, within {worst:.3g} relative norm of "
        f"the plain path's (worst {worst_path}; limit {TRAIN_GRAD_TOL}); "
        f"host ms {ms:.1f}, plain {ms_p:.1f}; launches {per_step}.  "
        f"Relative norm gaps per leaf: {cols}:")
    for (path, _), row in zip(leaves, zip(*gaps)):
        log(f"[{tag}]   {path:32s} " + " ".join(f"{g:.3e}" for g in row))


def _fan_in_init(model, cfg, seed: int):
    """Parameters drawn anew with every matmul weight at std
    1/sqrt(its contraction size) and the tied embedding at
    1/sqrt(d_model), so attention is soft and the logits O(1).  The
    reference's init takes a stacked weight's fan-in from its leading
    (layer) dim and the embedding at std 1, which makes every softmax
    near one-hot at this width and the FA2 backward's ds near 0."""
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                        DEVICE)
    _fan_in_scale(params, model.specs(), cfg)
    return params


# the weights whose contraction size is their second-to-last dim: the
# FFNs' and the recurrent mixers' projections (the depthwise conv's taps)
_FAN_IN_PENULTIMATE = ("w1", "w2", "w3", "in_proj", "x_proj", "dt_proj",
                       "out_proj", "conv_w", "up", "down", "wif", "w_gates",
                       "r_gates", "up1", "up2")


def _fan_in_scale(params, specs, cfg) -> None:
    """Rescale a tree drawn at the reference's init in place to the
    fan-in init of :func:`_fan_in_init`; each factor comes from the
    leaf's global spec, so a rank's shard scales as its global leaf."""
    from repro_torch.models.common import tree_leaves
    shapes = {path: spec.shape for path, spec in tree_leaves(specs)}
    for path, t in tree_leaves(params):
        _fan_in_leaf(path, t, shapes[path], cfg)


def _fan_in_leaf(path: str, t, shape, cfg) -> None:
    """One leaf of :func:`_fan_in_scale` (global shape ``shape``)."""
    name = path.rsplit("/", 1)[-1]
    if name in ("wq", "wk", "wv", "router"):
        fan_in = shape[1]
    elif name == "wo":                     # attention's (L, H, hd, D)
        fan_in = math.prod(shape[1:-1])
    elif name in _FAN_IN_PENULTIMATE:
        fan_in = shape[-2]
    elif name == "embed":
        with torch.no_grad():
            t.mul_(1.0 / math.sqrt(cfg.d_model))
        return
    else:
        return
    with torch.no_grad():
        t.mul_(math.sqrt(shape[0] / fan_in))


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def phase_train() -> dict:
    """[train]: build_training at full width (2 layers), the gradients
    with the kernels against the plain path, Trainer.run with a
    checkpoint restored bit for bit, and one profiled step.  Returns the
    Trainer run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.data import (CopyTaskConfig, SyntheticLM,
                                  make_copy_task_batch)
    from repro_torch.launch.train import build_training
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = get_config(ARCH).replace(n_layers=TRAIN_LAYERS)
    if not cfg.remat:
        fail(f"[train] {cfg.name} should train with remat")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _, params, opt_state, step_fn = build_training(
        cfg, lr=1e-4, warmup=2, total=TRAIN_STEPS, device=DEVICE)
    torch.cuda.synchronize()
    state = tree_leaves({"params": params, "opt_state": opt_state})
    state_bytes = sum(t.numel() * t.element_size() for _, t in state)
    log(f"[train] {cfg.name} d={cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} F={cfg.d_ff} E={cfg.n_experts} top{cfg.top_k} "
        f"vocab={cfg.vocab} layers={cfg.n_layers} remat={cfg.remat_policy}"
        f": {sum(t.numel() for _, t in tree_leaves(params)) / 1e9:.3f} B "
        f"params, {state_bytes / 1e9:.2f} GB of params and AdamW state, "
        f"built in {time.perf_counter() - t0:.2f} s")
    if state_bytes > DISK_WRITE_BUDGET:
        fail(f"[train] one checkpoint ({state_bytes / 2**30:.1f} GiB) would "
             f"exceed the run's disk budget "
             f"({DISK_WRITE_BUDGET / 2**30:.0f} GiB)")
    dcfg = CopyTaskConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                          global_batch=TRAIN_B)
    batch = make_copy_task_batch(dcfg, 0, DEVICE)
    per_step = _train_launches_per_step(cfg)

    # (a) gradients with the kernels against the plain path
    _grad_gate(model, params, batch, per_step, "reference init",
               tensor_core_ref=True)

    # (b) Trainer.run, checkpoint at step 2 restored bit for bit
    torch.cuda.empty_cache()
    deltas = []

    def counted_step(p, o, b):
        before = _read_counts()
        out = step_fn(p, o, b)
        deltas.append({k: v - before[k] for k, v in _read_counts().items()})
        return out

    # the trainer and the checkpoint under the tracer: a train.step span
    # per step, one checkpoint.save and one checkpoint.restore
    from repro_torch.core import telemetry
    telemetry.reset_telemetry()
    tracer = telemetry.enable_tracing()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, checkpoint_dir=ckdir,
                             checkpoint_every=2, keep_checkpoints=1,
                             log_every=1)
        tr = Trainer(tcfg, counted_step,
                     SyntheticLM(dcfg, task="copy", device=DEVICE), params,
                     opt_state)
        _reset_counts()
        t0 = time.perf_counter()
        tr.run(max_steps=2)       # ends in ckpt.wait(): the save is durable
        save_s = time.perf_counter() - t0 - sum(
            r["seconds"] for r in tr.metrics_log)
        written = _dir_bytes(ckdir)
        if written + sum(WRITTEN.values()) > DISK_WRITE_BUDGET:
            fail(f"[train] the checkpoint wrote {written / 2**30:.1f} GiB, "
                 f"{sum(WRITTEN.values()) / 2**30:.2f} GiB before it, over "
                 f"the run's disk budget "
                 f"({DISK_WRITE_BUDGET / 2**30:.0f} GiB)")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fresh = Trainer(tcfg, step_fn,
                        SyntheticLM(dcfg, task="copy", device=DEVICE),
                        params, opt_state)
        if not fresh.try_restore():
            fail("[train] no checkpoint to restore at step 2")
        restore_s = time.perf_counter() - t0
        live, back = tr._state_tree(), fresh._state_tree()
        if (fresh.step, fresh.data.step) != (tr.step, tr.data.step) \
                or tr.step != 2:
            fail(f"[train] restored step {fresh.step} / cursor "
                 f"{fresh.data.step}, live {tr.step} / {tr.data.step}")
        for (path, a), (_, b) in zip(tree_leaves(live), tree_leaves(back)):
            if a.dtype != b.dtype or a.device != b.device \
                    or not torch.equal(a, b):
                fail(f"[train] restored {path} differs from the live state")
        n_leaves = len(tree_leaves(live))
        del fresh, live, back
        torch.cuda.empty_cache()
        # no step-4 save: a second checkpoint would exceed DISK_WRITE_BUDGET
        tr.config.checkpoint_every = TRAIN_STEPS + 1
        t0 = time.perf_counter()
        status = tr.run()
        rest_s = time.perf_counter() - t0
        counts = _read_counts()
    telemetry.disable_tracing()
    spans = [sp.name for sp in tracer.spans()]
    want_spans = {"train.step": TRAIN_STEPS, "checkpoint.save": 1,
                  "checkpoint.restore": 1}
    got_spans = {k: spans.count(k) for k in want_spans}
    if got_spans != want_spans or len(spans) != sum(want_spans.values()):
        fail(f"[train] spans {spans}, expected {want_spans}")
    steps_ms = [round(sp.duration * 1e3, 1) for sp in tracer.spans()
                if sp.name == "train.step"]
    telemetry.reset_telemetry()
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if status != "done" or tr.step != TRAIN_STEPS:
        fail(f"[train] Trainer.run ended {status} at step {tr.step}")
    if counts != want or any(d != per_step for d in deltas):
        fail(f"[train] {TRAIN_STEPS} steps launched {counts} (per step "
             f"{deltas}), expected {per_step} per step")
    rows = tr.metrics_log
    if len(rows) != TRAIN_STEPS or not all(
            math.isfinite(r["total_loss"]) for r in rows):
        fail(f"[train] metrics {rows}")
    secs = [r["seconds"] * 1e3 for r in rows]
    log(f"[train] Trainer.run, {TRAIN_STEPS} steps: total_loss "
        f"{[round(r['total_loss'], 4) for r in rows]}, grad_norm "
        f"{[round(r['grad_norm'], 4) for r in rows]}; step ms (host clock, "
        f"each step ends in a host read of the loss) {[round(t, 1) for t in secs]}"
        f": first {secs[0]:.1f}, warm median "
        f"{float(np.median(secs[1:])):.1f}; launches per step {per_step}")
    log(f"[train] traced: {got_spans} spans; train.step span ms "
        f"{steps_ms}")
    log(f"[train] checkpoint: the async save at step 2 took {save_s:.1f} "
        f"s outside the steps (host snapshot, sha256, write), restored "
        f"into a fresh Trainer in "
        f"{restore_s:.1f} s, {n_leaves} leaves equal bit for bit (step, "
        f"data cursor too), {written / 2**30:.2f} GiB written (budget "
        f"{DISK_WRITE_BUDGET / 2**30:.0f}); steps 3-4 took {rest_s:.1f} s")
    log(f"[train] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}")

    # (c) where a step's time goes
    _profile(lambda: step_fn(params, opt_state, batch),
             f"train step ({TRAIN_LAYERS} layers, B={TRAIN_B}, S={TRAIN_S})",
             top=20)
    del params, opt_state, tr
    torch.cuda.empty_cache()

    # (d) the gradients again where attention is soft and the logits O(1)
    params = _fan_in_init(model, cfg, seed=1)
    tree_map(lambda t: t.requires_grad_(True), params)
    _grad_gate(model, params, batch, per_step, "fan-in init", f32=True)
    del model, params, batch
    torch.cuda.empty_cache()
    return counts


def phase_train_danube() -> tuple[dict, float]:
    """[train_danube]: h2o-danube-1.8b at full width (head dim 80, window
    4096) cut to 2 layers, the copy task at B=1, S=6144 (past the
    window), one loss + backward with the kernels against the plain
    versions at the fan-in init (:func:`_grad_gate`: every leaf within
    2e-2 relative norm, the loss within 1e-2; remat on, so per step 2
    forward-with-lse ``wgmma`` and 1 backward a layer).  Returns the
    launches and the seconds."""
    from repro_torch.configs import get_config
    from repro_torch.data import CopyTaskConfig, make_copy_task_batch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    t0 = time.perf_counter()
    layers, B, S = TRAIN_DANUBE
    cfg = get_config(DANUBE).replace(n_layers=layers)
    if not cfg.remat:
        fail(f"[train_danube] {cfg.name} should train with remat")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = _fan_in_init(model, cfg, seed=1)
    tree_map(lambda t: t.requires_grad_(True), params)
    batch = make_copy_task_batch(CopyTaskConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B), 0, DEVICE)
    L = cfg.n_layers
    per_step = _expected(flash_attention_fwd=2 * L,
                         flash_attention_fwd_wgmma=2 * L,
                         flash_attention_bwd=L, flash_attention_bwd_wgmma=L)
    log(f"[train_danube] {cfg.name} d={cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.hd} window={cfg.window} F={cfg.d_ff} "
        f"vocab={cfg.vocab} layers={L} remat={cfg.remat_policy}: "
        f"{sum(t.numel() for _, t in tree_leaves(params)) / 1e9:.3f} B "
        f"params")
    _grad_gate(model, params, batch, per_step, "fan-in init",
               tag="train_danube")
    del model, params, batch
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[train_danube] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {secs:.1f} s")
    return per_step, secs


# ---------------------------------------------------------------------------
# the recurrent archs: jamba-v0.1-52b and xlstm-1.3b at full width
# ---------------------------------------------------------------------------


def _cast_in_place(tree, dtype) -> None:
    """Every leaf of ``tree`` cast to ``dtype`` in place, one at a time
    (the old leaf is freed as the next is made)."""
    for key, value in tree.items():
        if isinstance(value, dict):
            _cast_in_place(value, dtype)
        else:
            tree[key] = value.to(dtype)


def _forward_vs_decode(model, params, tokens, tag: str) -> dict:
    """The full-sequence forward's logits at the first DECODE_CHECK
    positions against as many ``decode_step`` ticks on the same tokens,
    every recurrent state handed from tick to tick: (a) in bf16 with the
    kernels, (b) in f32 on the plain versions (``params`` cast in place:
    the caller's tree is f32 afterwards).  The state hand-off is gated in
    f32, where the forward and the ticks differ only by f32 sums: within
    FVD_TOL of the largest logit.  In bf16 the roundings alone move these
    models' logits by percents (PERF.md), so the bf16 ticks are gated
    against the f32 forward: no farther from it than FVD_RATIO times the
    bf16 forward (plus the f32 limit).  Returns the gaps, the scale and
    the median bf16 tick's host ms."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    B = tokens.shape[0]

    def run(m, p):
        full = m.forward(p, tokens)[0][:, :DECODE_CHECK]
        caches = m.init_caches(B, DECODE_CHECK, DEVICE)
        outs, ms = [], []
        for t in range(DECODE_CHECK):
            (lg, caches), tick = _host_ms(lambda: m.decode_step(
                p, tokens[:, t:t + 1], caches))
            outs.append(lg)
            ms.append(tick)
        return full, torch.cat(outs, 1), float(np.median(ms))

    with torch.no_grad():
        full_b, dec_b, tick_ms = run(model, params)
        _cast_in_place(params, torch.float32)
        torch.cuda.empty_cache()
        m32 = build_model(model.cfg.replace(param_dtype="float32",
                                            compute_dtype="float32"))
        with ops.plain_versions():
            full_f, dec_f, _ = run(m32, params)
    gap = lambda a, b: float((a - b).abs().max())
    r = dict(f32=gap(dec_f, full_f), scale=float(full_f.abs().max()),
             bf16=gap(dec_b, full_b), dec_b=gap(dec_b, full_f),
             full_b=gap(full_b, full_f), tick_ms=tick_ms)
    name = model.cfg.name
    if not torch.isfinite(dec_b).all() or not r["f32"] <= FVD_TOL * r["scale"]:
        fail(f"[{tag}] {name}: f32 decode ticks differ from the forward's "
             f"first {DECODE_CHECK} positions by {r['f32']:.4g} (largest "
             f"logit {r['scale']:.4g}; limit {FVD_TOL} of it)")
    if not r["dec_b"] <= FVD_RATIO * r["full_b"] + FVD_TOL * r["scale"]:
        fail(f"[{tag}] {name}: bf16 decode ticks lie {r['dec_b']:.4g} from "
             f"the f32 forward, the bf16 forward {r['full_b']:.4g} (limit "
             f"{FVD_RATIO}x that, plus the f32 limit)")
    return r


def _fvd_log(r) -> str:
    return (f"forward vs {DECODE_CHECK} decode ticks: f32 (plain) "
            f"{r['f32']:.4g} of max |logit| {r['scale']:.4g} (limit "
            f"{FVD_TOL} of it); bf16 (kernels) {r['bf16']:.4g}, the bf16 "
            f"ticks {r['dec_b']:.4g} and the bf16 forward {r['full_b']:.4g} "
            f"from the f32 forward (limit {FVD_RATIO}x); median bf16 tick "
            f"{r['tick_ms']:.2f} ms at B={RECURRENT_B}")


def _recurrent_jamba() -> dict:
    """[recurrent] (a): jamba at full width, one superblock (8 layers):
    the prefill gate at the reference and the fan-in inits (1 flash and
    12 gmm ``wgmma`` a prefill), 5 requests on 4 slots (12 gmm
    ``decode`` a tick), and forward against decode without a capacity
    limit (no token dropped on either path).  Returns the launches."""
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params, n_params = _arch_model(JAMBA, JAMBA_LAYERS)
    tokens = prefill_tokens(cfg, RECURRENT_B, RECURRENT_S)
    c_ref, ref = _arch_prefill(model, params, cfg, tokens, "reference",
                               tensor_core_ref=True, tag="recurrent",
                               replay=True)
    del params
    torch.cuda.empty_cache()
    soft = _fan_in_init(model, cfg, seed=1)
    c_fan, fan = _arch_prefill(model, soft, cfg, tokens, "fan-in",
                               warm=2, tag="recurrent", replay=True)
    c_serve = phase_serve(model, soft, cfg, tag="recurrent",
                          lengths=(8, 11, 13, 16, 10))
    _reset_counts()
    fvd = _forward_vs_decode(build_model(cfg.replace(capacity_factor=None)),
                             soft, tokens, "recurrent")
    c_fvd = _read_counts()
    del soft, model
    torch.cuda.empty_cache()
    log(f"[recurrent] {cfg.name} d={cfg.d_model} "
        f"Ein={cfg.ssm_expand * cfg.d_model} "
        f"n={cfg.ssm_state} heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"F={cfg.d_ff} E={cfg.n_experts} vocab={cfg.vocab} x{cfg.n_layers} "
        f"layers ({_attn_layers(cfg)} attention, {_moe_layers(cfg)} MoE): "
        f"{n_params / 1e9:.3f} B params; prefill B={RECURRENT_B} "
        f"S={RECURRENT_S}: first {ref['cold_ms']:.1f} ms, warm "
        f"{[round(t, 1) for t in ref['warm_ms'] + fan['warm_ms']]} ms, "
        f"plain {fan['plain_ms']:.1f} ms (host clock); launches {c_ref}; "
        f"reference init: max |logit - plain| {ref['err']:.4g} of max "
        f"|logit| {ref['scale']:.4g}, same argmax: {ref['same_top']}; "
        f"fan-in init: {fan['err']:.4g} of {fan['scale']:.4g}, same "
        f"argmax: {fan['same_top']} (the plain runs replay the kernel "
        f"runs' routing; their own top-{cfg.top_k} differs for "
        f"{ref['switched']['switched']} / {fan['switched']['switched']} of "
        f"{fan['switched']['tokens']} (token, router call) pairs); dropless "
        f"{_fvd_log(fvd)}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s; {_card()}")
    return _sum_counts(c_ref, c_fan, c_serve, c_fvd)


def _recurrent_spectral(gen) -> None:
    """[recurrent] (b): one jamba position with ``spectral_long_conv`` at
    full width, the FFT convolution against the step recurrence (the same
    linear system): outputs within 2e-2 of the largest, the final state
    within 1e-3 of its largest (f32 on both paths)."""
    from repro_torch.configs import get_config
    from repro_torch.models import spectral
    from repro_torch.models.common import init_params
    cfg = get_config(JAMBA).replace(spectral_long_conv=True)
    params = init_params(spectral.spectral_specs(cfg), gen, DEVICE,
                         cfg.pdtype)
    x = _randn(gen, RECURRENT_B, RECURRENT_S, cfg.d_model)
    with torch.no_grad():
        (y_c, s_c), conv_ms = _host_ms(
            lambda: spectral.spectral_block(params, x, cfg))
        zero = {"ssm": torch.zeros_like(s_c["ssm"])}
        (y_r, s_r), rec_ms = _host_ms(
            lambda: spectral.spectral_block(params, x, cfg, state=zero))
    err = float((y_c.float() - y_r.float()).abs().max())
    scale = float(y_r.float().abs().max())
    s_err = float((s_c["ssm"] - s_r["ssm"]).abs().max())
    s_scale = float(s_r["ssm"].abs().max())
    log(f"[recurrent] spectral position (jamba, Ein="
        f"{cfg.ssm_expand * cfg.d_model}, n={cfg.ssm_state}) B={RECURRENT_B} "
        f"S={RECURRENT_S}: FFT conv {conv_ms:.1f} ms, recurrence "
        f"{rec_ms:.1f} ms (host clock); max |conv - recurrence| {err:.4g} "
        f"of {scale:.4g} (limit 2e-2 of it), final state {s_err:.4g} of "
        f"{s_scale:.4g} (limit 1e-3 of it)")
    if not (torch.isfinite(y_c).all() and err <= 2e-2 * scale
            and s_err <= 1e-3 * s_scale):
        fail("[recurrent] the spectral block's FFT convolution and its "
             "recurrence disagree")


def _mlstm_forms(gen, S: int, grads: bool) -> dict:
    """One xlstm-1.3b mLSTM layer at full width (Din 4096, 4 heads of
    1024) on one sequence of S tokens: the chunkwise form (L = 128)
    against the per-step one, outputs and states, or with ``grads`` every
    leaf's gradient (and the input's) of a fixed random projection of the
    output.  Returns the gaps (relative to the per-step form's largest,
    or relative norms) and host ms of each form."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    from repro_torch.models.common import init_params, tree_leaves
    cfg = get_config(XLSTM)
    params = init_params(xlstm.mlstm_specs(cfg), gen, DEVICE, cfg.pdtype)
    x = _randn(gen, 1, S, cfg.d_model)
    proj = torch.randn(1, S, cfg.d_model, generator=gen, device=DEVICE)
    leaves = [t.requires_grad_(grads) for _, t in tree_leaves(params)]
    x.requires_grad_(grads)
    out = {}
    for form, L in (("chunked", cfg.xlstm_chunk), ("per-step", 0)):
        c = cfg.replace(xlstm_chunk=L)

        def run():
            with torch.set_grad_enabled(grads):
                y, state = xlstm.mlstm_block(params, x, c)
            if grads:
                return torch.autograd.grad((y.float() * proj).sum(),
                                           leaves + [x])
            return (y,) + tuple(state[k] for k in ("C", "n", "m"))
        out[form], out[f"{form}_ms"] = _host_ms(run)
    if grads:
        return dict(gaps=_rel_gaps(out["chunked"], out["per-step"]),
                    ms=(out["chunked_ms"], out["per-step_ms"]))
    return dict(gaps=[float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
                      for a, b in zip(out["chunked"], out["per-step"])],
                ms=(out["chunked_ms"], out["per-step_ms"]))


def _recurrent_xlstm(gen) -> dict:
    """[recurrent] (c): xlstm-1.3b at full width and depth (48 layers) at
    the fan-in init: prefill B=2, S=2048 (chunkwise mLSTM, per-step
    sLSTM), no kernel launched; 5 requests on 4 slots; forward against
    decode one superblock deep; one mLSTM layer chunked against
    per-step.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, make_prefill_fn
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(XLSTM)
    model = build_model(cfg)
    params = _fan_in_init(model, cfg, seed=1)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    tokens = prefill_tokens(cfg, RECURRENT_B, RECURRENT_S)
    prefill = make_prefill_fn(model)
    _reset_counts()
    out, cold_ms = _host_ms(lambda: prefill(params, tokens))
    counts = _read_counts()
    if counts != _expected():
        fail(f"[recurrent] {cfg.name} prefill launched {counts}, expected "
             f"no kernel")
    if out.shape != (RECURRENT_B, cfg.vocab) or not torch.isfinite(out).all():
        fail(f"[recurrent] {cfg.name} prefill logits {tuple(out.shape)} not "
             f"finite (B, V)")
    warm_ms = [_host_ms(lambda: prefill(params, tokens))[1] for _ in range(2)]
    c_serve = phase_serve(model, params, cfg, tag="recurrent",
                          lengths=(8, 11, 13, 16, 10))
    del params, model
    torch.cuda.empty_cache()
    # forward vs decode one superblock deep: at 48 layers the f32 sums'
    # own order differences grow to percents of the largest logit (PERF.md)
    cut = build_model(cfg.replace(n_layers=XLSTM_CUT_LAYERS))
    _reset_counts()
    fvd = _forward_vs_decode(cut, _fan_in_init(cut, cut.cfg, seed=1),
                             tokens, "recurrent")
    c_fvd = _read_counts()
    del cut
    torch.cuda.empty_cache()
    S = MLSTM_CHECK_S[0]
    forms = _mlstm_forms(gen, S, grads=False)
    if not forms["gaps"][0] <= 2e-2 or not max(forms["gaps"][1:]) <= 1e-3:
        fail(f"[recurrent] one mLSTM layer: chunked vs per-step gaps "
             f"{forms['gaps']} (y, C, n, m relative to the largest; limits "
             f"2e-2 for y, 1e-3 for the f32 states)")
    log(f"[recurrent] {cfg.name} d={cfg.d_model} heads {cfg.n_heads} "
        f"(hd {2 * cfg.d_model // cfg.n_heads}) chunk {cfg.xlstm_chunk} "
        f"vocab={cfg.vocab} x{cfg.n_layers} layers: {n_params / 1e9:.3f} B "
        f"params, fan-in init; prefill B={RECURRENT_B} S={RECURRENT_S}: "
        f"first {cold_ms:.1f} ms, warm {[round(t, 1) for t in warm_ms]} ms "
        f"(host clock), launches none; at {XLSTM_CUT_LAYERS} layers "
        f"{_fvd_log(fvd)}; "
        f"one mLSTM layer at S={S}: chunked vs per-step gaps (y, C, n, m; "
        f"of the largest) {[f'{g:.3g}' for g in forms['gaps']]} (limits "
        f"2e-2, 1e-3), {forms['ms'][0]:.1f} ms vs {forms['ms'][1]:.1f} ms; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    return _sum_counts(c_serve, c_fvd, counts)


def phase_recurrent() -> tuple[dict, float]:
    """[recurrent]: jamba-v0.1-52b (:func:`_recurrent_jamba`), the spectral
    substitute (:func:`_recurrent_spectral`) and xlstm-1.3b
    (:func:`_recurrent_xlstm`), each model freed before the next.
    Returns the launches and the seconds."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    counts = _recurrent_jamba()
    _recurrent_spectral(gen)
    torch.cuda.empty_cache()
    counts = _sum_counts(counts, _recurrent_xlstm(gen))
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[recurrent] {secs:.1f} s; launches {counts}")
    return counts, secs


class _Recorded:
    """An optimizer that records the gradients it is handed."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, params, grads, state, sharding=None):
        self.grads = grads
        return self.opt.update(params, grads, state, sharding=sharding)


def phase_train_recurrent() -> tuple[dict, float]:
    """[train_recurrent]: (a) jamba at full width, one superblock, the
    copy task at B=1, S=1024, fan-in init: one loss + backward with the
    kernels against the plain versions with the expert matmul on the
    tensor cores (:func:`_grad_gate`, :func:`_tensor_core_gmm`: on an
    H100 the order of ``ref_gmm``'s f32 sums alone moves every leaf of
    this model by 1.6-3.5e-2, as the logged plain path as it stands
    shows; each
    path's gradients held in host memory once computed; launches per step
    from :func:`_train_launches_per_step`); (b) xlstm-1.3b cut to 8
    layers: one ``make_train_step`` step (AdamW), every leaf's gradient
    finite and non-zero, no kernel launched; (c) one full-width mLSTM
    layer's gradients, chunked against per-step at S=256, within 2e-2
    relative norm.  Returns the launches and the seconds."""
    from repro_torch.configs import get_config
    from repro_torch.data import CopyTaskConfig, make_copy_task_batch
    from repro_torch.models import build_model, make_train_step
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamW, AdamWConfig
    t0 = time.perf_counter()
    B, S = TRAIN_RECURRENT
    # (a) jamba
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(JAMBA).replace(n_layers=JAMBA_LAYERS)
    if not (cfg.remat and cfg.recurrent_step_remat):
        fail(f"[train_recurrent] {cfg.name} should train with remat")
    model = build_model(cfg)
    params = _fan_in_init(model, cfg, seed=1)
    tree_map(lambda t: t.requires_grad_(True), params)
    batch = make_copy_task_batch(CopyTaskConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B), 0, DEVICE)
    per_step = _train_launches_per_step(cfg)
    _grad_gate(model, params, batch, per_step, "fan-in init",
               tensor_core_ref=True, tag="train_recurrent", witness=False,
               offload=True)
    log(f"[train_recurrent] {cfg.name} x{cfg.n_layers} layers, B={B} "
        f"S={S}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, params, batch
    torch.cuda.empty_cache()

    # (b) xlstm, 8 layers, one AdamW step
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(XLSTM).replace(n_layers=XLSTM_CUT_LAYERS)
    model = build_model(cfg)
    params = _fan_in_init(model, cfg, seed=1)
    tree_map(lambda t: t.requires_grad_(True), params)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    batch = make_copy_task_batch(CopyTaskConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B), 0, DEVICE)
    opt = _Recorded(AdamW(AdamWConfig(lr=1e-3)))
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    _reset_counts()
    (params, opt_state, metrics), ms = _host_ms(
        lambda: step(params, opt_state, batch))
    if _read_counts() != _expected():
        fail(f"[train_recurrent] {cfg.name} step launched {_read_counts()}, "
             f"expected no kernel")
    bad = [path for path, g in tree_leaves(opt.grads)
           if not torch.isfinite(g).all() or not g.abs().max() > 0]
    if bad or not all(math.isfinite(float(v)) for v in metrics.values()):
        fail(f"[train_recurrent] {cfg.name}: gradients not finite or zero "
             f"for {bad[:5]}, metrics "
             f"{ {k: float(v) for k, v in metrics.items()} }")
    if not all(torch.isfinite(t).all() for _, t in tree_leaves(params)):
        fail(f"[train_recurrent] {cfg.name}: parameters not finite after "
             f"the AdamW step")
    log(f"[train_recurrent] {cfg.name} x{cfg.n_layers} layers ("
        f"{n_params / 1e9:.3f} B params, chunk {cfg.xlstm_chunk}), B={B} "
        f"S={S}, fan-in init: one make_train_step step (AdamW) in "
        f"{ms:.1f} ms (host clock), loss {float(metrics['total_loss']):.6g}, "
        f"grad norm {float(metrics['grad_norm']):.6g}; all "
        f"{len(tree_leaves(opt.grads))} leaves' gradients finite and "
        f"non-zero; launches none; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, params, opt_state, opt, batch
    torch.cuda.empty_cache()

    # (c) one mLSTM layer's gradients, chunked vs per-step
    S_c = MLSTM_CHECK_S[1]
    forms = _mlstm_forms(torch.Generator(device=DEVICE).manual_seed(6), S_c,
                         grads=True)
    worst = max(forms["gaps"])
    log(f"[train_recurrent] one mLSTM layer at S={S_c}: gradients chunked "
        f"vs per-step within {worst:.3g} relative norm (every leaf and the "
        f"input; limit {TRAIN_GRAD_TOL}), {forms['ms'][0]:.1f} ms vs "
        f"{forms['ms'][1]:.1f} ms")
    if not worst <= TRAIN_GRAD_TOL:
        fail(f"[train_recurrent] one mLSTM layer: chunked gradients differ "
             f"from the per-step ones by {forms['gaps']}")
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[train_recurrent] {secs:.1f} s")
    return per_step, secs


# ---------------------------------------------------------------------------
# the encoder-decoder (whisper-tiny) and the stub frontend (internvl2-2b)
# ---------------------------------------------------------------------------


def _encdec_forward_vs_decode(model, params, tokens, frames) -> dict:
    """The full-sequence forward's logits at the first DECODE_CHECK
    positions against as many ``decode_step`` ticks over the same tokens
    and memory, both in f32 on the plain versions (a copy of ``params``
    cast to f32): the KV cache's hand-off from tick to tick, within
    FVD_TOL of the largest logit."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    m32 = build_model(model.cfg.replace(param_dtype="float32",
                                        compute_dtype="float32"))
    p32 = tree_map(lambda t: t.detach().float(), params)
    tokens, B = tokens[:, :DECODE_CHECK], tokens.shape[0]
    with torch.no_grad(), ops.plain_versions():
        full = m32.forward(p32, tokens, frontend_embeds=frames)[0]
        memory = m32.encode(p32, frames)
        caches = m32.init_caches(B, DECODE_CHECK, DEVICE)
        outs = []
        for t in range(DECODE_CHECK):
            logits, caches = m32.decode_step(p32, tokens[:, t:t + 1], caches,
                                             memory)
            outs.append(logits)
    gap = float((torch.cat(outs, 1) - full).abs().max())
    scale = float(full.abs().max())
    if not gap <= FVD_TOL * scale:
        fail(f"[encdec] {model.cfg.name}: f32 decode ticks differ from the "
             f"forward's first {DECODE_CHECK} positions by {gap:.4g} "
             f"(largest logit {scale:.4g}; limit {FVD_TOL} of it)")
    return {"gap": gap, "scale": scale}


def _encdec_reference_gate(model, params, tokens, frames) -> dict:
    """The reference-init prefill held against an f32 run: the kernel
    path's and the plain path's last-position logits (bf16), each against
    the plain versions in f32 (a copy of ``params`` cast to f32); fails
    unless the kernel path lies within F32_GAP_RATIO times the plain
    path's distance from it.  At whisper's reference init every softmax
    is near one-hot over 1500 frames and the two bf16 paths lie as far
    from f32 as from each other (PERF.md), so the 2e-2 gate against the
    plain path is the fan-in init's."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, make_prefill_fn
    from repro_torch.models.common import tree_map
    m32 = build_model(model.cfg.replace(param_dtype="float32",
                                        compute_dtype="float32"))
    prefill = make_prefill_fn(model)
    out = prefill(params, tokens, frames)
    with ops.plain_versions():
        ref = prefill(params, tokens, frames)
        want = make_prefill_fn(m32)(tree_map(lambda t: t.float(), params),
                                    tokens, frames)
    gap = lambda a: float((a - want).abs().max())
    r = dict(k32=gap(out), p32=gap(ref), scale=float(want.abs().max()),
             top=[float((a.argmax(-1) == want.argmax(-1)).float().mean())
                  for a in (out, ref)])
    if not r["k32"] <= F32_GAP_RATIO * r["p32"]:
        fail(f"[encdec] {model.cfg.name} reference init: the kernel path's "
             f"logits lie {r['k32']:.4g} from the f32 run, the plain "
             f"path's {r['p32']:.4g} (limit {F32_GAP_RATIO}x)")
    return r


def _cross_kv_ms(model, params, memory) -> tuple[float, float, float]:
    """Card ms of one decode tick on the batcher's slots, of what it
    spends recomputing every decoder layer's cross-attention K and V
    from the memory (the two projections a cross-attention cache would
    keep), and of its flash calls on them: CUDA events, warm."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import _heads
    cfg, cd = model.cfg, model.cfg.cdtype
    B = memory.shape[0]
    dec = params["decoder"]["cross_attn"]
    q = _randn(torch.Generator(device=DEVICE).manual_seed(7), B,
               cfg.n_heads, 1, cfg.hd)

    def kv():
        return [_heads(memory @ dec[w][i].to(cd).flatten(1), cfg.n_kv_heads)
                .contiguous() for i in range(cfg.n_layers)
                for w in ("wk", "wv")]
    kvs = kv()

    def flash():
        for i in range(cfg.n_layers):
            ops.attention(q, kvs[2 * i], kvs[2 * i + 1], causal=False)
    caches = model.init_caches(B, ENCDEC_S, DEVICE)
    toks = torch.zeros((B, 1), dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        tick = cuda_ms(lambda: model.decode_step(params, toks, caches,
                                                 memory))
        return tick, cuda_ms(kv), cuda_ms(flash)


def phase_encdec() -> tuple[dict, float]:
    """[encdec]: whisper-tiny at its full config (4 encoder + 4 decoder
    layers, d 384, 6 heads of 64, 1500 frames, vocab 51865; random
    weights from a seed, frames from a seed).  (a) ``make_prefill_fn``
    with the frames at B=4 over 448 decoder tokens: 4 encoder, 4 decoder
    self- and 4 cross-attention flash ``wgmma`` launches, never ``simt``;
    its last-position logits within 2e-2 of the largest from the plain
    versions' at the fan-in init, and at the reference init no farther
    from an f32 run than F32_GAP_RATIO times the plain path
    (:func:`_encdec_reference_gate`).  (b) ``model.encode`` launches 4.
    (c) The forward against as many decode ticks, in f32 on the plain
    versions at the fan-in init (:func:`_encdec_forward_vs_decode`; at
    the reference init the reference's own f32 ticks lie 4.8e-3 of the
    largest logit from its forward, past the limit:
    ``tools/encdec_numerics.py``).
    (d) The launcher's body (``serve_colocated`` with the memory) answers
    4 requests of 8-16 prompt tokens, 16 new tokens each, every tick
    launching one cross-attention flash ``wgmma`` a decoder layer.  Logs
    the card ms of a tick and of its cross K / V recompute.  Returns the
    launches and the seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(WHISPER)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                        DEVICE)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    tokens = prefill_tokens(cfg, ENCDEC_B, ENCDEC_S)
    frames = frontend_embeds(cfg, ENCDEC_B)
    c_ref, ref = _arch_prefill(model, params, cfg, tokens, "reference",
                               tag="encdec", frontend=frames, gate=False)
    ref.update(_encdec_reference_gate(model, params, tokens, frames))
    _reset_counts()
    with torch.no_grad():
        memory, enc_ms = _host_ms(lambda: model.encode(params, frames))
    c_enc = _read_counts()
    want = _expected(flash_attention=cfg.encoder_layers,
                     flash_attention_wgmma=cfg.encoder_layers)
    if c_enc != want:
        fail(f"[encdec] encode launched {c_enc}, expected {want}")
    if memory.shape != frames.shape or not torch.isfinite(memory).all():
        fail(f"[encdec] memory {tuple(memory.shape)} not finite "
             f"{tuple(frames.shape)}")
    c_serve = phase_serve(model, params, cfg, tag="encdec", memory=memory)
    tick, kv, flash = _cross_kv_ms(model, params, memory)
    del params
    torch.cuda.empty_cache()
    soft = _fan_in_init(model, cfg, seed=1)
    c_fan, fan = _arch_prefill(model, soft, cfg, tokens, "fan-in",
                               tag="encdec", frontend=frames)
    fvd = _encdec_forward_vs_decode(model, soft, tokens, frames)
    del soft, model, memory
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[encdec] {cfg.name} d={cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.hd} F={cfg.d_ff} vocab={cfg.vocab} "
        f"{cfg.encoder_layers}+{cfg.n_layers} layers, "
        f"{cfg.n_frontend_tokens} frames: {n_params / 1e6:.2f} M params; "
        f"prefill B={ENCDEC_B} S={ENCDEC_S}: first {ref['cold_ms']:.1f} ms, "
        f"second {ref['warm_ms'][0]:.1f} ms, plain {ref['plain_ms']:.1f} ms "
        f"(host clock); launches {c_ref}; reference init: max |logit - "
        f"plain| {ref['err']:.4g}, from the f32 run: kernels "
        f"{ref['k32']:.4g}, plain {ref['p32']:.4g} (limit "
        f"{F32_GAP_RATIO}x) of max |logit| {ref['scale']:.4g}, argmax as "
        f"f32's for {ref['top'][0]:.3f} / {ref['top'][1]:.3f} of the rows; "
        f"fan-in init: {fan['err']:.4g} of {fan['scale']:.4g} (limit 2e-2 "
        f"of it), same argmax: {fan['same_top']}; encode "
        f"{enc_ms:.1f} ms (host), launches {c_enc}; forward vs "
        f"{DECODE_CHECK} decode ticks (f32, plain, fan-in init) "
        f"{fvd['gap']:.4g} of max |logit| {fvd['scale']:.4g} (limit "
        f"{FVD_TOL} of it); a tick on "
        f"{ENCDEC_B} slots {tick:.3f} ms on the card, of which the cross "
        f"K / V recompute of {cfg.n_frontend_tokens} frames x "
        f"{cfg.n_layers} layers {kv:.3f} ms and its flash calls "
        f"{flash:.3f} ms; peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; {secs:.1f} s; {_card()}")
    return _sum_counts(c_ref, c_enc, c_serve, c_fan), secs


def phase_train_encdec() -> tuple[dict, float]:
    """[train_encdec]: (a) whisper-tiny at its full config, the copy task
    at B=4, S=448 over 1500 frames from a seed, fan-in init (as
    [train_danube]): one loss + backward with the kernels against the
    plain versions (:func:`_grad_gate`: every leaf within 2e-2 relative
    norm, the loss within 1e-2; remat on, so per step 2 forward-with-lse
    ``wgmma`` and 1 backward per attention call: 4 encoder, 4 decoder
    self, 4 cross), then 3 ``make_train_step`` AdamW steps with those
    launches each and a finite loss and gradient norm; (b) internvl2-2b
    cut to 4 layers, B=1, S=2048 text tokens after its 256 patch tokens,
    one loss + backward, the same gate.  Returns the launches and the
    seconds."""
    from repro_torch.configs import get_config
    from repro_torch.data import CopyTaskConfig, make_copy_task_batch
    from repro_torch.models import build_model, make_train_step
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamW, AdamWConfig
    t0 = time.perf_counter()
    layers, B_vl, S_vl = INTERNVL_TRAIN
    total = None
    for arch, B, S, cut in ((WHISPER, ENCDEC_B, ENCDEC_S, None),
                            (INTERNVL, B_vl, S_vl, layers)):
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        cfg = cfg.replace(n_layers=cut or cfg.n_layers)
        if not cfg.remat:
            fail(f"[train_encdec] {cfg.name} should train with remat")
        model = build_model(cfg)
        params = _fan_in_init(model, cfg, seed=1)
        tree_map(lambda t: t.requires_grad_(True), params)
        batch = make_copy_task_batch(CopyTaskConfig(
            vocab=cfg.vocab, seq_len=S, global_batch=B), 0, DEVICE)
        batch["frontend_embeds"] = frontend_embeds(cfg, B)
        per_step = _train_launches_per_step(cfg)
        log(f"[train_encdec] {cfg.name} x{cfg.n_layers} layers"
            f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
            f", B={B} S={S}{_frontend_note(cfg)}, remat "
            f"{cfg.remat_policy}: "
            f"{sum(t.numel() for _, t in tree_leaves(params)) / 1e9:.3f} B "
            f"params")
        _grad_gate(model, params, batch, per_step, "fan-in init",
                   tag="train_encdec")
        total = per_step if total is None else _sum_counts(total, per_step)
        if arch == WHISPER:
            opt = AdamW(AdamWConfig(lr=1e-3))
            opt_state = opt.init(params)
            step = make_train_step(model, opt)
            losses, norms, times = [], [], []
            for _ in range(3):
                _reset_counts()
                (params, opt_state, metrics), ms = _host_ms(
                    lambda: step(params, opt_state, batch))
                if _read_counts() != per_step:
                    fail(f"[train_encdec] AdamW step launched "
                         f"{_read_counts()}, expected {per_step}")
                losses.append(float(metrics["total_loss"]))
                norms.append(float(metrics["grad_norm"]))
                times.append(round(ms, 1))
                total = _sum_counts(total, per_step)
            if not all(map(math.isfinite, losses + norms)):
                fail(f"[train_encdec] AdamW steps: losses {losses}, grad "
                     f"norms {norms}")
            log(f"[train_encdec] {cfg.name}: 3 make_train_step steps "
                f"(AdamW): loss {losses}, grad norm {norms}, host ms "
                f"{times}; launches {per_step} each")
            del opt, opt_state
        log(f"[train_encdec] {cfg.name}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, params, batch
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f"[train_encdec] {secs:.1f} s; {_card()}")
    return total, secs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torch.bmm, the reference runs' tensor-core gmm, sums in f32 throughout
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}; tf32 off")
    phase_build()
    kernels = phase_kernels(torch.Generator(device=DEVICE).manual_seed(0))
    phase_dryrun()

    cfg = get_config(ARCH).replace(n_layers=N_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                        DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    log(f"[model] {cfg.name} d={cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} hd={cfg.hd} F={cfg.d_ff} E={cfg.n_experts} "
        f"top{cfg.top_k} vocab={cfg.vocab} layers={cfg.n_layers} "
        f"{cfg.param_dtype}: {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    tokens = prefill_tokens(cfg)
    prefill_counts = phase_prefill(model, params, cfg, tokens)
    serve_counts = phase_serve(model, params, cfg)
    log(f"[model] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase_profile(model, params, cfg, tokens)
    del model, params
    torch.cuda.empty_cache()
    archs_counts, new_secs = phase_archs()

    seed = 3
    world = run_world(seed)
    paths = {"prefill": prefill_counts, "serve": serve_counts,
             "archs": archs_counts,
             "collective": phase_collective(world),
             "autotune": phase_autotune(world),
             "moe_ep": phase_moe_ep(world, seed),
             "moe_ep_grok": phase_moe_ep_grok(world, seed),
             "moe_dropless": phase_moe_dropless(world, seed)}
    new_secs += max(r["moe_ep_grok"]["seconds"] for r in world)
    rules_c = phase_overlap_grad(world)
    phase_tracing(world)
    paths["train_ep"] = phase_train_ep(world)
    added = phase_ring(world) + phase_pipeline(world)
    paths["fft"] = phase_fft(world)
    paths["serve_disagg"] = phase_serve_disagg(world)
    paths["elastic"] = phase_elastic(world, seed)
    del world
    # the one-process gates above (grok's 8 experts) leave this process's
    # allocator holding blocks the 8 ranks of the next world need
    torch.cuda.empty_cache()
    tp_world = run_tp_world(seed)
    paths["train_tp"] = phase_train_tp(tp_world)
    paths["ulysses"] = phase_ulysses(tp_world)
    added += max(r["ulysses"]["seconds"] for r in tp_world)
    t0 = time.perf_counter()
    paths["recurrent_mesh"] = phase_recurrent_mesh(tp_world, seed)
    secs = max(r["recurrent_mesh"]["seconds"] for r in tp_world) \
        + time.perf_counter() - t0
    log(f"[recurrent_mesh]: {secs:.1f} s of the run (the world's ranks and "
        f"the main process's one-process runs)")
    paths["encdec_mesh"], secs = phase_encdec_mesh(tp_world)
    log(f"[encdec_mesh]: {secs:.1f} s of the run")
    rules_ab = phase_rules_mesh(tp_world)
    paths["rules_mesh"] = {k: rules_ab.get(k, 0) + rules_c.get(k, 0)
                           for k in rules_ab.keys() | rules_c.keys()}
    del tp_world
    torch.cuda.empty_cache()
    log(f"[ulysses] + [ring] + [pipeline]: {added:.1f} s of the run")
    paths["train"] = phase_train()
    paths["train_danube"], secs = phase_train_danube()
    new_secs += secs
    log(f"[archs] + grok's [moe_ep] + [train_danube]: {new_secs:.1f} s of "
        f"the run")
    paths["recurrent"], secs = phase_recurrent()
    paths["train_recurrent"], more = phase_train_recurrent()
    log(f"[recurrent] + [train_recurrent]: {secs + more:.1f} s of the run")
    paths["encdec"], secs = phase_encdec()
    paths["train_encdec"], more = phase_train_encdec()
    log(f"[encdec] + [train_encdec]: {secs + more:.1f} s of the run")
    for name, entry in kernels.items():
        entry["launches_by_path"] = {path: counts.get(name, 0)
                                     for path, counts in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        # the SIMT gmm and flash serve f32, unaligned calls and (flash)
        # head dims 16 and 32 only, the backward's mma bf16 head dims 16
        # and 32: every main-path call takes wgmma or decode, which the
        # phases' counts check
        entry["on_main_path"] = not (name.endswith("_simt")
                                     or name == "flash_attention_bwd_mma")
        if entry["on_main_path"] and entry["launches"] == 0:
            fail(f"{name} was not launched on the main path")
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(_card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
