#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: build, kernels, paths

Phases, in order (any failure exits non-zero; no phase catches its own):

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from `src/repro_torch/csrc/*.cu` with nvcc
   (sm_90a) into `build/repro_torch/`, one nvcc per source, all at once;
3. kernel phase: each of the four `rss_scan_agg` kernels on numpy-seeded
   inputs at the main path's shapes (P = 400,000 pages, K = 8 slots,
   E = 32 elements; M in {0, 64, 4096} members; G in {1, 16, 40, 256}
   groups), `rss_scan_agg` and `rss_scan_agg_chunked` on the route `plan`
   chose and on the other route forced (each call's route and launch
   shape printed, both routes timed, the chosen one also after a
   clean-L2 flush); `rss_scan_agg_grouped` (BP 8) at the same G and M
   and at the driver phase's largest shapes (P 920,008 at G 43, P
   120,016 at G 2, M 0) and `rss_delta_fold` at the flush buffer's 256
   rows into 64 lanes and at the driver's 1,048,576 rows into 8, each on
   every route, timed beside `fill_only_ms` or `sector_only_ms`, and
   counted as one device operation a call in a profiler trace; the chunked call
   at a G over the cluster route's shared-memory cap (global route; group
   ids over 48 groups and spread over all G, both timed), and
   K in {9, 33} with BP 3 and 8, and the two gather
   kernels (`version_gather`, `rss_gather`) at the mirror's shape (int32,
   P = 400,000, K = 8, E = 32, M in {0, 64, 4096}), at an embedding-row
   param store (bf16, P = 151,936, K = 2, E = 1,024: Qwen1.5-0.5B's
   vocabulary and width) and at edge shapes (K in {1, 3, 33}, E in
   {1, 3, 32, 640}, unaligned rows; E = 32 at a P that gives each warp of
   the tile route several tiles) and with member sets that drive each
   staging of the members in shared memory (bitmap, array, global) must
   be `torch.equal` to their plain PyTorch versions on the card, on the
   route each wrapper chose and on each route forced where more than one
   takes the store; prints each gather call's route and launch shape (as
   the wrappers report them), kernel, plain and bound times (CUDA events,
   median, L2 flushed before each launch), the gathers' time on each
   route and `copy_only_ms` (the chosen rows copied by indexing, slots
   precomputed);
4. small-driver phase: a small `run_single_node` on "cuda" and on "cpu"
   with one seed must give equal metrics and OLAP outputs;
5. driver phase: `run_single_node` at TPC-C's cardinalities (4
   warehouses, 10 districts, 3,000 customers per district, 100,000 items,
   3,000 orders per district), `ROUNDS` rounds, with `check_scans`
   (every plan result asserted equal to the per-key engine oracle),
   batched plans and
   materialized views; every `rss_scan_agg` kernel must have launched;
   prints how many launches each made at which (P, G, M, BP) and route;
6. snapshot-read path phase: a `SingleNodeHTAP` paged mirror at the same
   cardinalities (640,044 pages) after OLTP traffic that leaves writers
   in flight; the whole mirror read through `torch_store()` +
   `snapshot_read_members` (rss_gather) must decode to
   `mirror.scan_members` and to the engine's per-key protected reads,
   with at least one page read at a previous version; `snapshot_read`
   (version_gather) at the floor and at the newest commit must equal
   `mirror.scan_at`, and a `gather_pages` sub-store its rows;
7. param-store phase: the bf16 embedding store on the card, a few hundred
   `publish_page`s at rising ts under a rising `gc_floor`, read by
   `snapshot_read` / `snapshot_read_members` at several watermarks
   against a dict-of-versions oracle; both gather kernels must have
   launched in phases 6 and 7;
8. attention kernel phase: `flash_attention` at the serve path's prefill
   shape (bf16, B = 8, S = T = 1,024, H = K = 16, hd = 64, causal), at a
   GQA + window shape (H = 32, K = 8, hd = 128, window 256), at Jamba's
   prefill shape (H = 64, K = 8, hd = 128), at ragged S = T = 1,000
   (bf16, and f32 with TF32 off), at Whisper-tiny's encoder (bf16,
   B = 32, S = T = 1,500, H = K = 6, hd = 64, non-causal) and its
   cross-attention prefill (S = 4 over T = 1,500), and `decode_attention`
   at B = 8, T = 1,088, valid_len in {1, 600, 1,088}, G = 1 (hd 64),
   G = 4 and G = 8 (hd 128, Jamba's), at the long-context run's B = 1,
   T = 8,256 (G = 1) and at Whisper's cross decode (B = 32 over
   T = 1,500, G = 1, hd 64), each against its plain PyTorch version on
   the card
   (bf16 rtol = atol = 3e-2, f32 2e-5, and every element within that
   tol of the output's max-abs); prints the kernel each flash
   call ran and the split each decode call took (as the wrappers report
   them), kernel, plain, bound and `scaled_dot_product_attention`
   (library) times (also at one rank's shapes of the sharded serve
   phase: flash 8 x 1,024 at 16 query and 2 KV heads, hd 128, causal,
   and decode B 8 over 1,040 slots at G 8, hd 128, the ranks' cache of
   `TP_S` + `TP_STEPS`: `TP_ROWS`; at one rank's shapes of the gathered
   serving: Qwen1.5-0.5B's flash 2 x 1,024 at 16/16 heads, hd 64, and
   decode B 2 over 1,032 slots, `FSDP_SERVE_ROWS`; Mixtral-8x22B's flash
   1 x 1,024 at 48/8 heads, hd 128, window 4,096, and decode B 1 over
   1,028 slots at G 6, `FALLBACK_ROWS`),
   decode's kernel and library times again after a
   flush that leaves L2 clean, and decode at every split of the bf16
   route at each timed shape (each held against plain); the flash times
   at Qwen's and Jamba's prefill beside PR 16's (`FLASH_PR16_MS`); then
   the flash backward, `flash_attention_bwd` (`fa_flash_bwd`), on
   numpy-seeded inputs at `BWD_CASES` (Qwen's train shape bf16 B = 8,
   S = T = 1,024, H = K = 16, hd = 64, causal; GQA + window 256 at H 32,
   K 8, hd 128; MQA at H 48, K 1, hd 128; ragged S = T = 1,000 in bf16
   and f32; Whisper-tiny's encoder, B = 32, S = T = 1,500, H = K = 6,
   hd 64, non-causal, and its cross-attention, S = 448 over T = 1,500,
   each a row of its own: `BWD_ROWS`; one rank's share of the sharded
   train phase, B = 2 at Qwen's train shape, a row of its own:
   `FSDP_ROWS`), from the forward kernel's o and
   lse, against
   `attention_bwd_ref` on the same inputs (bf16 within 3e-2 of each
   gradient's max-abs, f32 2e-5), two launches bitwise equal, timed
   beside plain, the bound and SDPA's backward on its flash route
   (null where that route does not take the mask), printing the launch
   `plan_bwd` chose (the head ranges of a KV head's dK/dV, `hsplit`);
   the bound counts 10·hd operations a visible pair, not the 14·hd the
   kernels issue (the dQ kernel computes S and dP again);
9. WKV kernel phase: `wkv_scan` in the model's [B,T,H,N] layout at the
   RWKV serve path's prefill shape (f32, B = 8, T = 1,024, H = 40,
   N = 64) and decode shape (T = 1, the state as s0 and output, in
   place), and at edge shapes (ragged T = 37, N = 32, bf16 and f16
   inputs, s0 given at T > 1), against its plain version on the card at
   rtol = atol = 1e-4 (the reference's tolerance for its kernel); at
   RWKV6-3B's own decay scale (w_base = -6, unit r/k/v) f32 sums of
   64 terms of size ~|o| cancel, so there the check holds |d| to 1e-4
   of the output's max-abs; prints each call's route (chunked for T > 1,
   step for T = 1) and launch shape as the wrapper reports it, and
   kernel, plain and bound times of the prefill and of the decode, the
   decode also on the chunked route (forced), beside the step route;
   and at one rank's shape of the sharded serve phase's RWKV6-3B (f32,
   B = 4 of 8 prompts at data 2, T = 1,024 and T = 1 from its state,
   every head: `tp_wkv_shape`, rows `TP_WKV_ROWS`);
10. SSM kernel phase: `ssm_scan` at Jamba's prefill shape (f32, Bb = 8,
   T = 1,024, Di = 16,384, N = 16, Jamba's own scales) and decode shape
   (T = 1, the state as h0 and output, in place), and at edge shapes
   (ragged T = 37, Di = 1,000, N = 8, bf16 u, h0 given at T > 1, the
   reference test's shapes and scales), against its plain version on the
   card at rtol = atol = 2e-4 (the reference's tolerance for its kernel);
   prints each call's route and launch shape, and kernel, plain and
   bound times of the
   prefill at Jamba's scales and at the reference test's (A = -exp(z)),
   and of the decode with f32 u and with bf16 u (the served case), the
   served decode also on the chunked route (forced); and at one rank's
   shape of the sharded serve phase's Jamba (bf16 u, Bb = 8, T = 1,024
   and T = 1 from its state, Di = 4,096 of 16,384 at model 4, N = 16:
   `tp_ssm_shape`, rows `TP_SSM_ROWS`);
   then the scans' backward kernels (`scan_bwd_phase`): `wkv_scan_bwd`
   at RWKV6-3B's train shape (f32, B = TRAIN_BATCH 4, T = 1,024, H = 40,
   N = 64, from the forward kernel's chunk states; the reference test's
   decays and RWKV6-3B's own) and `ssm_scan_bwd` at Jamba's train
   microbatch (bf16 u, Bb = 1, T = 1,024, Di = 16,384, N = 16, Jamba's
   scales), each gradient within 1e-4 of its max-abs of the plain
   backward (bf16 du: + 2^-7), two launches bitwise equal, timed beside
   plain and the bound (bytes, f32 operations, exponentials on the SFU:
   the least work, not what the kernels recompute; WKV's recomputes S
   from the saved states with each segment's state from zero beside it,
   and runs the adjoint twice, see `_wkv_bwd_cost`);
11. serve phase, once per architecture: Qwen1.5-0.5B, RWKV6-3B, then
   Jamba-1.5-Large, then Whisper-tiny (full size: 4 encoder and 4
   decoder layers; 32 clips of 1,500 frames from seeded `enc_embeds` as
   `data.pipeline` makes them, the 4-token start-of-transcript prompt,
   124 decode steps: `SERVE_SHAPE`, `SERVE_PROMPT`), then Qwen2-VL-72B
   (the first 4 of 80 layers at the published widths, ~12 GB:
   `SERVE_DEPTH`; 8 prompts of 1,024 tokens whose first 256 are the
   vision stub, on a 16 x 16 grid in `mrope_positions`), then
   Qwen1.5-0.5B again at one long conversation
   (1 prompt of 8,192 tokens, 64 decode steps; every decode_attention
   launch splits the cache, which (c) checks) (`repro_torch.configs`, bf16, random weights from
   torch.Generator seed 0; Qwen at full width, 6 of 24 layers
   (`SERVE_DEPTH`: the script's time; the sharded train phase serves it
   whole), RWKV at full
   width, 4 of 32 layers (`SERVE_DEPTH`: the script's time), Jamba
   at full width, one period deep (8 of 72 layers), each MoE layer
   holding experts 0-7 of 16: one card's share of an expert-parallel
   deployment, ~54 GB) published into a `VersionedParamStore` and served
   by `ServingEngine`: request 1 (8 prompts of 1,024 tokens, 64 decode
   steps, refresh between steps) while a writer publishes v2 (embedding
   rows and lm_head columns perturbed) under request 1's pin, then
   request 2 on v2.  Checks: (a) request 1's prefill and decode logits
   against the plain path on the card (the layers' attention, WKV and
   selective scan on their plain versions; Jamba's MoE routing recorded
   in request 1 and replayed, so a near tie that rounds the other way
   does not move the comparison by a whole expert); (b) prefill + decode
   against `forward` over the whole 1,088 tokens (Jamba's at capacity
   factor 8.0, drop-free, with routing replayed: at 1.25 the capacity
   depends on the length, so prefill + decode drops choices the forward
   keeps, in the reference too); both within 3e-2 of the logits'
   max-abs for Qwen and Jamba.  RWKV6-3B's bf16 layers amplify a
   1e-6 relative change of the WKV output to ~8% of the logits at 32
   layers (the phase prints this noise floor), so there (a) holds every
   `wkv_scan`
   launch of request 1's replay against the plain version on the same
   inputs (1e-4), and (a) and (b) run end to end on the same weights in
   f32 (1e-3); the bf16 ratios are printed.  Jamba adds the same
   per-launch check of `ssm_scan` (1e-4), its noise floor, and one
   full-width Mamba block in f32 (1e-3); (c) each kernel's launches per
   request: Qwen 6 flash in prefill and 6 x 64 decode attention, RWKV
   4 `wkv_scan` in prefill and 4 x 64 in decode, Jamba 7 `ssm_scan` in
   prefill and 7 x 64 in decode, 1 flash and 64 decode attention,
   Whisper 12 flash in prefill (4 encoder, 4 self, 4 cross) and 8 x 124
   decode attention (4 self, 4 cross), Qwen2-VL 4 flash and 4 x 64
   decode attention, and the launches at the kernel rows' own shapes
   (`ATTN_ROWS`: the Whisper encoder, cross prefill and cross decode);
   the
   decode attention launches that split: all 6 x 64 in the long run,
   none in the others; the scans' launches by route: every prefill
   launch chunked, every decode launch a step; (d)
   request 2's snapshot LSN above request 1's, and request 1 served from
   v1 alone; the phase's peak memory; for Qwen2-VL-72B
   (`SERVE_NOISE_FLOOR`) the bf16 model's noise floor (its plain prefill
   against itself with every attention output, computed in f32, times
   (1 + 1e-6 z) before its rounding), printed; then one more request under
   torch.profiler for the device's busy time, idle share, peak memory
   and time by kernel kind;
11b. sharded serve phase (`tp_serve_phase`), once per architecture of
   `TP_ARCHS` (each on its mesh, `TP_MESHES`): Qwen2-VL-72B at the
   published widths cut to 8 of 80 layers (`TP_DEPTH`, ~19 GB
   unsharded), then Jamba-1.5-Large at the published widths, one period
   (8 of 72 layers), experts 0-7 of each MoE layer as the serve phase
   holds them (`SERVE_EXPERT_CARDS`; 25.9 B parameters, ~52 GB
   unsharded), each over a mesh of (data 1, model 4) (`TP_MESH`): the
   unsharded kernel path's prefill and 16 teacher-forced decode logits
   first, here, freed before the ranks start; then four ranks
   (`parallel.spawn`), all on the one card over gloo (collectives pass
   through the host), each drawing its pieces of v1 from seed 0
   (`init_local_params`: a quarter of every layer's heads and d_ff, of
   each held expert's d_ff, of Mamba's d_inner and of the vocabulary)
   into its own `VersionedParamStore(slots=2)` and
   serving two requests of 8 x 1,024 tokens (the vision stub on a
   16 x 16 grid, as `serve_batch` makes it) and 16 decode steps through
   `ServingEngine(group=)`, v2 (the embedding negated) published
   on every rank under request 1's pin.  Checks: (s1) each rank's
   prefill and decode logits, gathered over "model", within 3e-2 of
   max-abs of the unsharded ones, printed beside the bf16 noise floor
   (Qwen2-VL's `TP_NOISE_FLOOR`; Jamba's measured here as the serve
   phase measures it, `_ssm_noise_floor`); for Jamba, the unsharded
   path's MoE routing recorded and replayed into every rank's (s1) run
   (through a file under `TP_DIR`; the choices a rank would have
   flipped printed), and every `ssm_scan` launch of that run held
   against the plain version (1e-4); (s2) each request's snapshot LSN
   equal on every rank, request 1 served from v1 alone, request 2 from
   v2, every rank's tokens equal; each rank's launches (Qwen2-VL 16
   flash and 256 decode; Jamba 14 `ssm_scan` chunked and 224 step, 2
   flash, 32 decode), summed into rows `flash_attention tp4`,
   `decode_attention tp4`, `ssm_scan tp4` and `ssm_scan step tp4`;
   every rank's Mamba cache of Di / 4 channels; per rank the prefill and
   decode times, peak memory and backend.  Then RWKV6-3B at the
   published widths cut to the serve phase's 4 of 32 layers over (data
   2, model 2): each rank holds the whole time mix and channel mix and
   half the vocabulary (`embed` rows, `lm_head` columns), serves 4 of the
   8 prompts, and nothing is summed after its mixes; its (s1) runs the
   unsharded kernel path on each data rank's rows (the ranks' product
   shapes; RWKV's bf16 logits amplify f32-level differences, see 11) at
   3e-2 (`TP_TOL`), every `wkv_scan` launch of it held against plain
   (1e-4); each rank's 8 chunked and 128 step `wkv_scan` launches (rows
   `wkv_scan tp4`, `wkv_scan step tp4`), whole-headed states, no plain
   version called in the two requests.  With two cards or more
   Qwen2-VL's runs again over NCCL, one rank a card; else it prints that
   this route was not run;
11c. fallback serve step (`fallback_serve_phase`): Mixtral-8x22B, whose
   model shard on a mesh of (data 1, model 4) passes the resident limit
   (`launch.specs.serving_fallback`, asserted), at the published widths
   cut to 1 of 56 layers (`FALLBACK_DEPTH`; ~2.5 B parameters, all eight
   experts whole), under the placement `params_specs(serving=True)`
   falls back on (fsdp2d, asserted equal leaf for leaf to the training
   placement of the cut): four ranks on the one card over gloo, each
   drawing its pieces (`init_local_params(specs=)`) and serving two
   requests of 4 x 1,024 tokens and 2 decode steps through
   `ServingEngine(group=, specs=)` (one prompt a rank, each layer's
   whole weights gathered just before it runs), v2 published under
   request 1's pin (`tp_rank`,
   `serve_two`), request 1 keeping its logits and MoE routing.  Checks
   (s1) here after the ranks (`gathered_s1`): the unsharded kernel path
   on the same draws, teacher-forced with request 1's tokens and the
   ranks' routing replayed (the decisions it would have made otherwise
   printed), within 3e-2 of max-abs of each rank's request 1 logits;
   (s2); each rank's 2 flash and 4 decode launches (rows `flash_attention
   fallback`, `decode_attention fallback`), 6 gathers a request; per
   rank the prefill and decode times and peak memory;
12. train phase, once per architecture of TRAIN_ARCH: Qwen1.5-0.5B at
   full width and depth, RWKV6-3B at full width, 4 of 32 layers
   (`TRAIN_CUT`: the script's time; d 2,560, f32 moments, batch 4:
   `TRAIN_BATCH`), Jamba-1.5-Large's
   Mamba layers (`TRAIN_CUT`: the period's first position, Mamba with a
   dense MLP, 2 layers at the published widths, bf16 moments, 8
   microbatches), Whisper-tiny whole (32 clips of 1,500 seeded frames,
   f32 from the pipeline and rounded to bf16 by the train step, and a
   448-token decoder window: `TRAIN_BATCH`, `TRAIN_SEQ`; 12 flash
   forward and 12 backward launches a step: encoder, self and cross)
   and Qwen2-VL-72B at the published widths cut to one layer
   (`TRAIN_CUT`; 8 x 1,024 tokens in 4 microbatches, bf16 moments, the
   pipeline's vision stub and M-RoPE positions), each bf16 from
   torch.Generator seed 0 with remat as its config says (the request
   served between steps carries the architecture's frontend inputs,
   `serve_batch`).  RWKV6 and Jamba run checks (a)-(c) as
   below (check (a) at 2 layers, the plain path the plain forwards and
   the plain backwards' explicit reverse scans), and (a) also holds every
   scan backward launch of one full-depth bf16 step against the plain
   backward on the same inputs (`checked_scan_bwd`); (c) counts each
   scan's forward and backward launches.  Qwen1.5-0.5B (8 x 1,024 tokens
   a step):  (a) one step's loss and gradients on the
   kernels against the plain path (`plain_attention`) on the card at
   batch 2 (`TRAIN_CHECK_B`): in f32 with TF32 off the loss within 1e-5
   relative and every leaf within 1e-3 of its max-abs; in bf16 on the
   same weights the loss within 3e-2, each leaf's ratio printed beside
   the bf16 model's own distance from the f32 one; (b) a `Trainer`
   publishing every step into a `VersionedParamStore(slots=2)` for 8
   steps, a reader pinned at v1 before step 1 reading v1 bitwise after
   step 8, a `ServingEngine` request answered from a pinned snapshot
   between steps with rising snapshot LSNs, no abort in the WAL; (c)
   each step launches the flash forward and backward as the remat
   setting implies (24 each under "dots") and calls no plain attention
   version; one more step profiled (step ms, tokens/s, device busy time
   and idle share, peak memory, time by kind and the top kernels); (d)
   `run(6, inject_failure_at=4)` with a save every 2 steps lands on an
   uninterrupted `run(6)`'s parameters (rtol 1e-5, atol 1e-6) at 2 of
   the 24 layers (`TRAIN_CRASH_LAYERS`), full width.  Whisper-tiny and
   Qwen2-VL run (a) to (c) as Qwen1.5-0.5B does, with the flash
   backward's launches at Whisper's encoder and cross shapes counted for
   the rows of `BWD_ROWS`;
12b. sharded train phase (`fsdp_train_phase`): Qwen1.5-0.5B whole (24
   layers at the published widths, bf16) under its fsdp2d placement
   over a mesh of (data 2, model 2) (`FSDP_MESH`): the unsharded step's
   loss, gradients and grad norm on the same weights (torch.Generator
   seed 0) and batch (the pipeline's 8 x 1,024 of seed 0) first, here,
   freed before the ranks start; then four ranks (`parallel.spawn`), all
   on the one card over gloo, each a `Trainer(group=)` drawing its
   pieces (`parallel.fsdp.init_local_state`: a quarter of every layer's
   weights and moments, the embedding and lm_head whole), training on
   its 2 rows of each batch and publishing into its own
   `VersionedParamStore(slots=2)`: FSDP_STEPS steps with a reader
   pinned at v1, a save after them.  Checks, on every rank: (f1) step
   1's loss within 3e-2 of the unsharded one (relative); (f2) every
   gradient leaf of step 1, gathered, within 3e-2 of its max-abs, and
   grad_norm within 3e-2 (the worst leaf printed beside both steps'
   distances from the same weights' f32 gradients, TF32 off); (f3)
   the rank's resident parameter and optimizer bytes equal to
   `launch.dryrun.residency` of this mesh and
   config, to the byte; (f4) the pinned v1 read bitwise after the
   publishes; (f5) the saved state restored onto the mesh (each rank's
   pieces) and onto one device (rank 0, against every gathered leaf),
   bitwise; each rank's 24 flash forward and 24 backward launches a
   step under remat "dots" and 2 x 24 + 1 gathers a step; per rank the
   step times, peak memory, gathers and reduce-scatters a step, the
   launches (summed into rows `flash_attention`,
   `flash_attention_bwd` and `flash_attention_bwd fsdp4`), each line
   beside the card's name and power limit.  Then (h): each rank serves
   what it trained from its own store through `ServingEngine(group=,
   specs=<the trainer's placement>)`, two requests of 8 x 1,024 tokens
   (2 a rank) and 2 decode steps, a version published on every rank
   under request 1's pin (`FSDP_SERVE`, `FSDP_PUBLISH_AT`): (h1) each
   rank's request 1 logits within 3e-2 of max-abs of the unsharded
   kernel path's, teacher-forced with request 1's tokens on the state
   the ranks saved, restored onto one device here (`gathered_s1`); (h2)
   one snapshot LSN a request on
   every rank, request 1 served from its pinned version alone; (h3) the
   gathers a request (the top-level leaves and each layer once a call),
   whole-headed caches, the peak memory; 48 flash and 96 decode
   launches a rank (rows `flash_attention fsdp serve`,
   `decode_attention fsdp serve`) and no plain attention call.  Then
   (i), once those ranks have exited, the same model on the reference's
   pod mesh cut to (pod 2, data 1, model 2) (`POD_MESH`): four ranks,
   each a `Trainer(group=)` on its 4 of the 8 rows (the batch over
   ("pod", "data"), the two ranks along "model" on the same rows) in
   `POD_MICROBATCHES` microbatches, every layer's weights and moments
   cut over ("data", "model"), FSDP_STEPS steps; checks (f1)-(f4)
   against the same unsharded step, and after every step each rank's
   pieces equal, bit for bit, to its pod replica's (`bits_digest`
   gathered over "pod"); their flash launches into rows
   `flash_attention` and `flash_attention_bwd`.  With four cards or
   more it runs again over NCCL, one rank a card; else it prints that
   this route was not run;
13. launch phase: `repro_torch.launch.train` (3 steps of 4 x 64
   tokens, a save every 2 steps under build/launch_ckpt, removed after,
   publishing) and `repro_torch.launch.serve` (2 trainer steps, then 2
   prompts and 8 decode steps) on Whisper-tiny at full size, each
   `main` called in the process (`launch_phase`: output lines checked,
   the attention kernels launched).

It prints one `{"kernels": [...]}` JSON line (a row per kernel: the
scans' two routes are two kernels each, `wkv_scan` / `ssm_scan` for the
chunked prefill and `wkv_scan step` / `ssm_scan step` for the decode,
each with its route's launches; the attention kernels have a row more
for each shape of `ATTN_ROWS`, with the serve phases' launches at that
shape, for each of `TP_ROWS`, with the sharded serve phase's
launches summed over its ranks, `ssm_scan` and `wkv_scan` two more each
for `TP_SSM_ROWS` and `TP_WKV_ROWS` likewise, for `FSDP_SERVE_ROWS` and
`FALLBACK_ROWS` with the gathered
serving's launches summed over its ranks, and for `FSDP_ROWS`, with the
sharded train phase's backward launches summed over its ranks), the card
line,
and last
`{"ok": true, "device": {...}}`; the flash backward's row counts its
launches in the train and launch phases' steps (`flash_attention_bwd
encoder` and `... cross` those at Whisper's two shapes), the scans'
backwards theirs (`wkv_scan bwd`, `ssm_scan bwd`).  It imports neither jax nor the JAX
package `repro`.  Without a card, or outside a checkout (no
`src/repro_torch` beside it), it exits 2 and prints nothing on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = "src/repro_torch/csrc/rss_scan_agg.cu"
TPU_SRC = "src/repro/kernels/rss_scan_agg/kernel.py"
GATHER_SRC = "src/repro_torch/csrc/gather.cu"
GATHER_TPU = {
    "version_gather": "src/repro/kernels/version_gather/kernel.py:48",
    "rss_gather": "src/repro/kernels/rss_gather/kernel.py:66"}
ATTN_SRC = "src/repro_torch/csrc/attention.cu"
ATTN_TPU = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:75",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:62"}
# the backward of that TPU kernel (the JAX package has no backward kernel:
# its gradients are autodiff of flash_attention_xla, models/layers.py:149)
ATTN_BWD_TPU = {
    "flash_attention_bwd": "src/repro/kernels/flash_attention/kernel.py:75"}
# the forward's times at Qwen's and Jamba's prefill shapes when PR 16
# redesigned it (CHANGES.md, PR 16 and its follow-up; H100 80GB HBM3,
# 700 W): the lse output must not slow serving
FLASH_PR16_MS = {"prefill": 0.0641, "jamba prefill": 0.4108}
# kernel-phase shapes with a row of their own in the JSON line: label ->
# (row name, shape).  A row's launches are those the serve phases make at
# its shape (`record_attention_shapes`'s key)
ATTN_ROWS = {
    "whisper encoder": ("flash_attention encoder",
                        ("flash_attention", 1500, 1500, False)),
    "cross prefill": ("flash_attention cross",
                      ("flash_attention", 4, 1500, False)),
    "cross": ("decode_attention cross", ("decode_attention", 1500))}
WKV_SRC = "src/repro_torch/csrc/wkv.cu"
WKV_TPU = {"wkv_scan": "src/repro/kernels/wkv_scan/kernel.py:64"}
SSM_SRC = "src/repro_torch/csrc/ssm.cu"
SSM_TPU = {"ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:63"}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
# H100 SXM dense peaks: bf16/f16 on the tensor cores, f32 outside them
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# H100 SXM special-function units: 16 exp2 results per clock per SM, 132
# SMs, 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
SLEEP_CYCLES = 20_000_000          # lets the host enqueue ahead of a timing
ROUNDS = 100                       # driver rounds at TPC-C scale
PATH_TXNS = 3000                   # OLTP transactions before the read
# TPC-C cardinalities (TPC-C spec 1.4 / 4.3.3.1; CH-benCHmark): 4
# warehouses, 10 districts each, 3,000 customers per district, 100,000
# stock items per warehouse, 3,000 orders per district
TPCC = dict(warehouses=4, districts=10, customers=3000, items=100_000,
            order_capacity=3000)
# Qwen1.5-0.5B's embedding table (src/repro/configs/qwen1_5_0_5b.py):
# vocabulary 151,936 rows of d_model 1,024, here with K = 2 versions
EMBED_P, EMBED_K, EMBED_E = 151_936, 2, 1024
# serve phase, per architecture: the kernels its path launches, each with
# its launches per layer of the kernel's mixer (KERNEL_MIXER) in a prefill
# and per such layer in a decode step
# (a cross-attention layer counts as an attention layer; the encoder's
# layers add a flash launch each to the prefill)
SERVE_KERNELS = {
    "qwen1.5-0.5b": {"flash_attention": (1, 0), "decode_attention": (0, 1)},
    "rwkv6-3b": {"wkv_scan": (1, 1)},
    "jamba-1.5-large-398b": {"ssm_scan": (1, 1), "flash_attention": (1, 0),
                             "decode_attention": (0, 1)},
    "whisper-tiny": {"flash_attention": (1, 0), "decode_attention": (0, 1)},
    "qwen2-vl-72b": {"flash_attention": (1, 0), "decode_attention": (0, 1)}}
KERNEL_MIXER = {"flash_attention": "attn", "decode_attention": "attn",
                "wkv_scan": "rwkv", "ssm_scan": "mamba"}
# checks (a) and (b) on the served bf16 logits: max |d| within this share
# of the logits' max-abs (the CPU tests' bf16 tolerance).  None for
# RWKV6-3B: its bf16 layers move the logits by ~8% of their max-abs
# for a 1e-6 relative change of the WKV output at 32 layers (PERF.md),
# at any depth the phase runs, so there the
# kernel is held per launch and in f32 instead (`_wkv_checks`)
SERVE_BF16_TOL = {"qwen1.5-0.5b": 3e-2, "rwkv6-3b": None,
                  "jamba-1.5-large-398b": 3e-2, "whisper-tiny": 3e-2,
                  "qwen2-vl-72b": 3e-2}
# Jamba-1.5-Large does not fit one card (one period at full width is
# 45.2 B parameters, 90.5 GB in bf16).  The card holds its share of a
# deployment that places each MoE layer's 16 experts on 2 cards by expert
# and the other 8 periods on further pipeline stages: one period (8 of
# 72 layers) at the published widths, experts 0-7 of each MoE layer (the
# router keeps all 16 outputs and top-2).  The CPU rehearsal cuts the
# smoke variant the same way.
# Qwen2-VL-72B (80 layers, 145 GB in bf16) does not fit one card either:
# a layer is 877.8 M parameters (1.756 GB), the embedding and lm_head
# 4.98 GB, so 32 layers (61.2 GB, 66.2 GB with the writer's v2 embedding
# and lm_head) at the published widths would be one pipeline stage of a
# deployment over 3 cards.  With the gathered serving's two sharded
# steps (`fsdp_train_phase`'s (h), `fallback_serve_phase`) this script
# took 1,040.4 s and 1,144.6 s with Qwen2-VL-72B at 32 and 16 layers
# and Qwen1.5-0.5B whole (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6),
# so both are served cut, at the published widths: Qwen2-VL-72B at 8
# layers (19.0 GB; the sharded serve phase's depth) and Qwen1.5-0.5B at
# 12 of its 24 (the sharded train phase serves it whole), each check
# and noise floor at that depth; since the pod step, at 4 and 6 (below).
# RWKV6-3B fits the card whole, and served whole (32 layers) in
# 111.5-167.2 s; cut to 4 of its 32 identical layers at the published
# widths so that `chip_smoke.py` with the sharded train phase stays
# inside its time limit (it took 1,185.0 s with RWKV whole on an NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md §6): every `wkv_scan` launch is
# still held against the plain version, and (a), (b) run end to end in
# f32 at that depth.
# With the pod step and RWKV6-3B's sharded serve added, this script ran
# ~1,185 s on one host (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6), so
# the serve phases run Qwen2-VL-72B at 4 of 80 layers and Qwen1.5-0.5B at
# 6 of 24 (8 and 12 before), the gathered serving steps two decode steps
# a request (FSDP_SERVE, FALLBACK_SERVE) and the driver 100 rounds
# (ROUNDS, 150 before; at 100 every `rss_scan_agg` kernel still
# dispatches, the grouped scan once, on the CPU at the same seed)
SERVE_DEPTH = {"rwkv6-3b": 4, "jamba-1.5-large-398b": 8,
               "qwen2-vl-72b": 4, "qwen1.5-0.5b": 6}
# the architectures whose serve phase measures the bf16 model's own noise
# floor under attention (`_attn_noise_floor`): Qwen2-VL-72B's checks read, at 32 layers,
# 0.0218 and 0.0203 of their 3e-2 bound (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md §6)
SERVE_NOISE_FLOOR = ("qwen2-vl-72b",)
SERVE_EXPERT_CARDS = {"jamba-1.5-large-398b": 2}
SERVE_SMOKE = False
# sharded serve phase: Qwen2-VL-72B at the published widths over a mesh
# of (data 1, model 4), each rank holding a quarter of every layer's
# heads and d_ff and of the vocabulary: TP_DEPTH of its 80 layers (8:
# ~19 GB unsharded, ~4.8 GB a rank), cut only because the four ranks
# share the one card after the parent's unsharded reference of that
# depth; 2 requests of 8 prompts x 1,024 tokens (Qwen2-VL's vision stub
# as `serve_batch` makes it), 16 decode steps, v2 published after step 8
TP_ARCH, TP_MESH = "qwen2-vl-72b", (1, 4)
TP_B, TP_S, TP_STEPS, TP_PUBLISH_AT = 8, 1024, 16, 8
# ... then Jamba-1.5-Large as the serve phase cuts it (one period, 8 of
# 72 layers, at the published widths; experts 0-7 of each MoE layer,
# SERVE_EXPERT_CARDS; 25.9 B parameters, ~52 GB unsharded, ~13 GB a
# rank): a rank holds 4,096 of 16,384 Mamba channels, 16 of 64 query
# and 2 of 8 KV heads, 6,144 of 24,576 d_ff and 16,384 of 65,536
# vocabulary rows
# ... then RWKV6-3B at the published widths cut to the serve phase's 4
# of 32 layers (SERVE_DEPTH), over a mesh of (data 2, model 2): a rank
# holds the whole time mix and channel mix (the layout cuts only the
# vocabulary: 32,768 of 65,536 rows of `embed` and columns of `lm_head`)
# and serves 4 of the 8 prompts, so its `wkv_scan` runs at B 4
TP_ARCHS = ("qwen2-vl-72b", "jamba-1.5-large-398b", "rwkv6-3b")
TP_DEPTH = {"qwen2-vl-72b": 8, "jamba-1.5-large-398b": 8, "rwkv6-3b": 4}
TP_MESHES = {"qwen2-vl-72b": TP_MESH, "jamba-1.5-large-398b": TP_MESH,
             "rwkv6-3b": (2, 2)}
# RWKV6-3B's bf16 logits move by ~8% of their max-abs for a 1e-6
# relative change of a WKV output (SERVE_BF16_TOL has no bound for it),
# so its (s1) runs the unsharded kernel path on each data rank's rows:
# the ranks' own product shapes, whose arithmetic the replicated mixes
# repeat; there (s1) takes the bf16 bound, TP_TOL (the other
# architectures take SERVE_BF16_TOL's)
TP_TOL = 3e-2
# Qwen2-VL-72B's bf16 noise floor under attention at the phase's own
# depth, TP_DEPTH layers (`scripts/tp_witness.py`, which runs
# `_attn_noise_floor` on the phase's config, batch and weights, on an
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6), printed beside check (s1)
TP_NOISE_FLOOR = 0.0126
TP_NOISE_FLOOR_FROM = ("scripts/tp_witness.py at 8 layers, NVIDIA H100 "
                       "80GB HBM3, 700.00 W")
TP_DIR = ROOT / "build" / "tp_serve"
# the kernel phase's shapes of one rank of that mesh (16 query and 2 KV
# heads, hd 128), rows of their own in the JSON line, their launches
# those of the sharded serve phase's ranks
TP_ROWS = {"tp prefill": "flash_attention tp4",
           "tp decode": "decode_attention tp4"}
# ... and `ssm_scan` at one rank's shape of Jamba's (`tp_ssm_shape`):
# the prefill's chunked route and the decode's step route, rows of their
# own, their launches the ranks' "ssm_scan chunked" and "ssm_scan step"
TP_SSM_ROWS = {"chunked": ("times_tp", "ssm_scan tp4"),
               "step": ("times_tp_step", "ssm_scan step tp4")}
# ... and `wkv_scan` at one rank's shape of RWKV6-3B's (`tp_wkv_shape`)
TP_WKV_ROWS = {"chunked": ("times_tp", "wkv_scan tp4"),
               "step": ("times_tp_step", "wkv_scan step tp4")}
# the CUDA library of each serve kernel that is not in attention.cu's
TP_LIBRARY = {"ssm_scan": "ssm", "wkv_scan": "wkv"}
# sharded train phase: Qwen1.5-0.5B whole (24 layers at the published
# widths, bf16) under its own placement, fsdp2d, over a mesh of (data 2,
# model 2): every layer's weights and their moments cut four ways, the
# embedding and lm_head replicated, the batch over both axes (TRAIN_B x
# TRAIN_S tokens a step, 2 rows a rank), four ranks on the one card over
# gloo; FSDP_STEPS steps published into each rank's store with a reader
# pinned at v1, the state saved after them under FSDP_DIR (removed
# after).  Qwen1.5-0.5B is the one published config whose sharded
# training fits the card with four ranks on it: fsdp2d keeps a whole
# embedding and lm_head, their f32 gradients and moments on every rank
# (~3.7 GB a rank), where Qwen2-VL-72B's would take ~20 GB a rank
FSDP_ARCH, FSDP_MESH, FSDP_STEPS = "qwen1.5-0.5b", (2, 2), 2
FSDP_DIR = ROOT / "build" / "fsdp_train"
# checks (f1) and (f2): the bf16 loss bound of the train phase (PERF.md
# §2), also for each gathered gradient leaf against its max-abs
FSDP_TOL = 3e-2
# the backward kernel phase's shape of one rank of that mesh (2 x 1,024,
# Qwen's heads), a row of its own in the JSON line, its launches those of
# the sharded train phase's ranks
FSDP_ROWS = {"fsdp rank": "flash_attention_bwd fsdp4"}
# ... after its steps each rank serves what it trained from its own
# store (`ServingEngine(group=, specs=<the trainer's placement>)`, a layer
# gathered at a time, the batch over both axes): two requests of
# FSDP_SERVE (batch, prompt, decode steps), a version published on every
# rank under request 1's pin after decode step FSDP_PUBLISH_AT; check
# (h1) holds each rank's logits against the unsharded kernel path on the
# state the ranks saved, restored onto one device
FSDP_SERVE, FSDP_PUBLISH_AT = (8, 1024, 2), 1
# the kernel phase's shapes of one rank of that serving (2 of the 8
# prompts, Qwen's 16/16 heads, hd 64), rows of their own in the JSON
# line, their launches those of the ranks' requests
FSDP_SERVE_ROWS = {"fsdp serve prefill": "flash_attention fsdp serve",
                   "fsdp serve decode": "decode_attention fsdp serve"}
# (a rank's prompts, its cache's slots)
FSDP_SERVE_RANK = (FSDP_SERVE[0] // math.prod(FSDP_MESH),
                   FSDP_SERVE[1] + FSDP_SERVE[2])
# ... then, once those ranks have exited, the same steps on the
# reference's pod mesh ("pod", "data", "model"), cut to (pod 2, data 1,
# model 2): the batch over ("pod", "data") (4 of the 8 rows a rank, the
# ranks along "model" computing the same rows), every layer's weights
# and moments cut over ("data", "model") (two ways), held against the
# same unsharded step; the pod replicas' pieces compared after every
# step (`pod_replicas_equal`).  A rank's 4 rows run as POD_MICROBATCHES
# microbatches of 2 (the config's own knob, the reference's split of the
# same batch): at 4 rows at once a rank's backward ran out of the card's
# memory beside the other three (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md §6)
POD_MESH, POD_MICROBATCHES = (2, 1, 2), 2
# fallback serve step: Mixtral-8x22B, whose model shard on a mesh of
# (data 1, model 4) (70.3 GB in bf16) passes the resident limit, served
# gathered under the placement `launch.specs.params_specs(serving=True)`
# falls back on (fsdp2d: every weight cut four ways on its largest dim,
# the embedding and lm_head whole), at the published widths cut to
# FALLBACK_DEPTH of its 56 layers (~2.5 B parameters, 5.0 GB in bf16, all
# eight experts whole; four ranks share the card, each gathering a whole
# layer); two requests of FALLBACK_SERVE, v2 under request 1's pin after
# decode step FALLBACK_PUBLISH_AT; (s1) at the bf16 bound
FALLBACK_ARCH, FALLBACK_MESH, FALLBACK_DEPTH = "mixtral-8x22b", (1, 4), 1
FALLBACK_SERVE, FALLBACK_PUBLISH_AT, FALLBACK_TOL = (4, 1024, 2), 1, 3e-2
FALLBACK_DIR = ROOT / "build" / "fallback_serve"
# the kernel phase's shapes of one rank of it (1 of the 4 prompts, 48/8
# heads, hd 128, window 4,096), rows of their own
FALLBACK_ROWS = {"fallback prefill": "flash_attention fallback",
                 "fallback decode": "decode_attention fallback"}
FALLBACK_RANK = (FALLBACK_SERVE[0] // math.prod(FALLBACK_MESH),
                 FALLBACK_SERVE[1] + FALLBACK_SERVE[2])
# the plain path's keys a chunk: its f32 scores are [B, S, H, PLAIN_CHUNK]
# (Qwen2-VL's prefill at 256: 0.54 GB a copy, beside 66 GB of weights)
PLAIN_CHUNK = 256
# 8 prompts of 1,024 tokens, 64 decode steps (cache of 1,088); the writer
# publishes v2 after this decode step
SERVE_B, SERVE_S, SERVE_STEPS, SERVE_PUBLISH_AT = 8, 1024, 64, 8
# a second Qwen run: one long conversation (B = 1, a prompt of 8,192 of
# the model's 32,768 positions, 64 decode steps), served as the others.
# Its decode grid is 16 blocks, so every decode_attention launch splits
# the cache over a cluster; the batch-8 runs never split
SERVE_LONG = {"qwen1.5-0.5b": (1, 8192, 64)}
# Whisper-tiny's traffic (batch, prompt, decode steps): 32 clips of 30 s
# (1,500 encoder frames each), the start-of-transcript prompt
# (<|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>) and 124
# decode steps: a 128-token transcript window of its 448-token context
SERVE_SHAPE = {"whisper-tiny": (32, 4, 124)}
SERVE_PROMPT = {"whisper-tiny": (50258, 50259, 50359, 50363)}
# train phase, once per architecture: bf16, TRAIN_B x TRAIN_S tokens a
# step, TRAIN_STEPS steps published while a request of TRAIN_SERVE
# (batch, prompt, decode steps) is served between steps
TRAIN_ARCH = ("qwen1.5-0.5b", "rwkv6-3b", "jamba-1.5-large-398b",
              "whisper-tiny", "qwen2-vl-72b")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 8
TRAIN_SERVE = (1, 64, 8)
# RWKV6-3B at batch 8: parameters, AdamW's f32 moments, the pinned v1
# and the gradients take ~50 GB before activations, and remat "dots"
# keeps ~1.4 GB of f32 product outputs a layer at batch 8 (45 GB over
# 32 layers): the card forces a cut of the batch to 4 (widths and depth
# as published; the depth is cut for time since, TRAIN_CUT, and the
# batch stays 4).  Whisper-tiny trains on 32 clips of 30 s (1,500 frames
# each) with a 448-token decoder window, its published text context
# (arXiv:2212.04356): TRAIN_S's 1,024 tokens are longer than the model's
# context
TRAIN_BATCH = {"rwkv6-3b": 4, "whisper-tiny": 32}
TRAIN_SEQ = {"whisper-tiny": 448}
# Jamba-1.5-Large cannot train a period on one card (one MoE layer is
# 9.7 B parameters, ~78 GB at 8 bytes a parameter): its cut is the
# period's first position alone (Mamba with a dense MLP, as positions 0
# and 2 are), this many layers deep, at the published widths.
# Qwen2-VL-72B at the published widths: the embedding and lm_head are
# 2.49 B parameters, a layer 0.878 B; at the ~21 bytes a parameter
# Jamba's cut peaked at (65.27 GB over 3.122 B parameters on an NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md §5: bf16 weights, moments and
# gradient sums, f32 gradients, the pinned v1 and the update's new
# version) one layer is ~70 GB, two ~89 GB: one layer, 4 microbatches of
# 2 x 1,024 (the config's).
# RWKV6-3B trains whole on the card (32 layers, 95.0 s for the phase);
# cut to 4 layers at the published widths for the script's time, as its
# serve phase is (SERVE_DEPTH)
TRAIN_CUT = {"rwkv6-3b": 4, "jamba-1.5-large-398b": 2, "qwen2-vl-72b": 1}
# check (a)'s depth where it is not the whole model: 2 layers at full
# width (the plain backwards' explicit reverse scans at full length)
TRAIN_CHECK_LAYERS = {"rwkv6-3b": 2}
# check (d) runs on this architecture only
TRAIN_CRASH_ARCH = "qwen1.5-0.5b"
# check (a)'s batch: the plain path's attention keeps [B, H, S, T] f32
# scores a layer for its backward (B 2: 128 MB a layer)
TRAIN_CHECK_B = 2
# check (d)'s depth cut: 2 of 24 layers at full width (336 M parameters,
# a 3.4 GB state a save, three saves)
TRAIN_CRASH_LAYERS = 2
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
TRAIN_SMOKE = False
# launch phase: the two launchers' command lines, run once each in this
# process at full size on Whisper-tiny (its train steps run the flash
# backward non-causal and at S != T, its serving the cross cache), the
# train launcher's checkpoints under LAUNCH_CKPT (removed after)
LAUNCH_CKPT = ROOT / "build" / "launch_ckpt"
LAUNCH_TRAIN = ["--arch", "whisper-tiny", "--steps", "3", "--batch", "4",
                "--seq", "64", "--ckpt-dir", str(LAUNCH_CKPT),
                "--ckpt-every", "2", "--publish"]
LAUNCH_SERVE = ["--arch", "whisper-tiny", "--train-steps", "2"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return out.splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, flush, reps: int = 15, clean=None) -> float:
    """Median device time of one `fn()` call in ms: each rep flushes L2
    (writes a buffer larger than it), parks the stream in a sleep so the
    host enqueues the call behind it, and brackets the call with CUDA
    events — so host launch overhead stays out of the reading.  The write
    leaves L2 full of dirty lines that the call's own reads must write
    back; with `clean` (a second buffer larger than L2) the flush then
    reads it, so the call starts on clean lines."""
    pairs = []
    for _ in range(reps + 2):
        flush.zero_()
        if clean is not None:
            clean.sum()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    vals = sorted(s.elapsed_time(e) for s, e in pairs[2:])
    return vals[len(vals) // 2]


# ------------------------------------------------------------ kernel phase
def make_store(np, P, K, E, rng):
    """A mirror-shaped store: tags drawn from the codec's (init, int,
    order, pad), fields from a stock-quantity-like range with negatives,
    timestamps with floor-visible and above-floor slots."""
    data = np.zeros((P, K, E), np.int32)
    data[:, :, 0] = rng.choice(np.array([0, 1, 1, 1, 3, -1], np.int32),
                               (P, K))
    data[:, :, 1] = rng.integers(-1000, 1001, (P, K), dtype=np.int32)
    data[:, :, 2:] = rng.integers(0, 100, (P, K, E - 2), dtype=np.int32)
    ts = rng.integers(0, 12_000, (P, K), dtype=np.int32)
    return data, ts


def scan_store(torch, np, P=400_000, K=8, E=32):
    """The kernel phase's store on the card (`make_store`, seed 0), its
    floor (6,000) and member sets of M 0, 64 and 4,096 above it; and the
    generator, for the draws after them."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    data_np, ts_np = make_store(np, P, K, E, rng)
    data = torch.from_numpy(data_np).to(dev)
    ts = torch.from_numpy(ts_np).to(dev)
    floor = 6_000
    members = {m: torch.from_numpy(np.sort(rng.choice(
        np.arange(floor + 1, 12_000, dtype=np.int32), m, replace=False)))
        .to(dev) for m in (0, 64, 4096)}
    return data, ts, members, floor, rng


def kernel_phase(torch, np, K_mod, flush, P=400_000, K=8, E=32):
    from repro_torch.kernels.rss_gather import ref as RGR
    from repro_torch.kernels.rss_scan_agg import ref as R

    dev = torch.device("cuda")
    data, ts, members, floor, rng = scan_store(torch, np, P, K, E)
    results = {}

    def check(name, got, want):
        """kernel == plain: `torch.equal`, and for the gathers (which copy
        bits) the same bit patterns too."""
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            diff = (got.double() - want.double()).abs().max().item()
            raise AssertionError(f"{name}: kernel != plain (max |d| {diff})")
        bits = {2: torch.int16, 4: torch.int32}.get(got.element_size())
        if bits is not None and not torch.equal(got.view(bits),
                                                want.view(bits)):
            raise AssertionError(f"{name}: kernel != plain bit patterns")
        err = (got.double() - want.double()).abs().max().item() \
            if got.numel() else 0
        res = results.setdefault(name, {"max_abs_err": 0})
        res["max_abs_err"] = max(res["max_abs_err"], err)

    def report(name, shape, fn, plain, nbytes):
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"kernel {name} {shape}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({nbytes / 1e6:.1f} MB)", flush=True)
        return ms, plain_ms, bound_ms

    # per page: K*4 bytes of ts + one 32-byte sector of the chosen slot
    page_bytes = K * 4 + 32

    def other_route(fn, args, kw, plain, timed):
        """`fn` on each route that takes the call beside the one `plan`
        chose, forced, == plain; printed, and timed when `timed`."""
        name, chosen = fn.__name__, fn.last_route
        members = args[2 if fn is K_mod.rss_scan_agg else 3].numel()
        label = (f"P={args[0].shape[0]} K={args[0].shape[1]} M={members} "
                 + (f"BP={kw['block_pages']}" if "block_pages" in kw
                    else f"G={kw['n_groups']}"))
        for route in K_mod.routes_for(name, members=members,
                                      block_pages=kw.get("block_pages", 8),
                                      n_groups=kw.get("n_groups", 1)):
            if route == chosen.route:
                continue
            check(name, fn(*args, route=route, **kw), plain)
            txt = _scan_launch_txt(fn.last_route)
            if timed:
                ms = time_ms(torch, lambda: fn(*args, route=route, **kw),
                             flush)
                print(f"kernel {name} {label} [{txt}, forced]: "
                      f"kernel_ms={ms:.4f}", flush=True)
            else:
                print(f"kernel {name} {label} [{txt}, forced] == plain",
                      flush=True)

    # rss_scan_agg: every M, timed at the main path's block size (BP=8)
    for m, mem in members.items():
        args = (data, ts, mem, floor, 1, 0, 50)
        got = K_mod.rss_scan_agg(*args, block_pages=8)
        want = R.rss_scan_agg_ref(*args, block_pages=8)
        check("rss_scan_agg", got, want)
        nbytes = P * page_bytes + m * 4 + got.numel() * 4
        t = report("rss_scan_agg", f"P={P} M={m} BP=8 "
                   f"[{_scan_launch_txt(K_mod.rss_scan_agg.last_route)}]",
                   lambda: K_mod.rss_scan_agg(*args, block_pages=8),
                   lambda: R.rss_scan_agg_ref(*args, block_pages=8), nbytes)
        other_route(K_mod.rss_scan_agg, args,
                    dict(block_pages=8), want, timed=True)
        # a yardstick of the scattered half: PyTorch's generic indexing
        # reading the chosen slots' tag and field alone (slots and row
        # index built first); no lower bound on those reads
        slot64 = RGR.rss_visible_slots_ref(ts, mem, floor).long()
        rows, tag_x = torch.arange(P, device=dev), data[:, :, :2]
        print(f"kernel rss_scan_agg P={P} M={m}: sector_only_ms="
              f"{time_ms(torch, lambda: tag_x[rows, slot64], flush):.4f} "
              "(tag and field of the chosen slots by indexing)", flush=True)
        if m == 64:
            results["rss_scan_agg"]["times"] = t
            _clean_l2_time(torch, f"rss_scan_agg P={P} M={m} BP=8",
                           lambda: K_mod.rss_scan_agg(*args, block_pages=8),
                           flush)
    for bp in (1, 2, 4):          # the shrink ladder's block sizes
        args = (data, ts, members[64], floor, 1, 0, 50)
        want = R.rss_scan_agg_ref(*args, block_pages=bp)
        check("rss_scan_agg", K_mod.rss_scan_agg(*args, block_pages=bp),
              want)
        print(f"kernel rss_scan_agg P={P} M=64 BP={bp} [" +
              _scan_launch_txt(K_mod.rss_scan_agg.last_route) + "] == plain",
              flush=True)
        other_route(K_mod.rss_scan_agg, args,
                    dict(block_pages=bp), want, timed=False)

    # chunked: every G with M = 64, plus every M at G=40
    gid_full = rng.integers(-1, 48, (P, 1), dtype=np.int32)

    def group_inputs(g, r=rng):
        gid_np = np.where(gid_full >= 0, gid_full % g, -1).astype(np.int32)
        prm = torch.from_numpy(np.stack([
            r.choice(np.array([1, 3], np.int32), g),
            r.choice(np.array([0, -2], np.int32), g),
            r.integers(-500, 500, g, dtype=np.int32)], 1)).to(dev)
        return torch.from_numpy(gid_np).to(dev), prm, int((gid_np >= 0).sum())

    for g in (1, 16, 40, 256):
        gid, prm, n_active = group_inputs(g)
        for m in ((0, 64, 4096) if g == 40 else (64,)):
            mem = members[m]
            kw = dict(n_groups=g, group_params=prm)
            gargs = (data, ts, gid, mem, floor)
            got_c = K_mod.rss_scan_agg_chunked(*gargs, **kw)
            want_c = R.rss_scan_agg_chunked_ref(*gargs, **kw)
            check("rss_scan_agg_chunked", got_c, want_c)
            chosen = _scan_launch_txt(K_mod.rss_scan_agg_chunked.last_route)
            base = P * 4 + n_active * page_bytes + m * 4 + g * 12
            tc = report("rss_scan_agg_chunked", f"P={P} G={g} M={m} "
                        f"[{chosen}]",
                        lambda: K_mod.rss_scan_agg_chunked(*gargs, **kw),
                        lambda: R.rss_scan_agg_chunked_ref(*gargs, **kw),
                        base + got_c.numel() * 4)
            other_route(K_mod.rss_scan_agg_chunked,
                        gargs, kw, want_c, timed=True)
            if g == 40 and m == 64:
                results["rss_scan_agg_chunked"]["times"] = tc
                _clean_l2_time(torch, f"rss_scan_agg_chunked P={P} G={g} "
                               f"M={m}", lambda: K_mod.rss_scan_agg_chunked(
                                   *gargs, **kw), flush)

    # grouped and the delta fold: every route at every timed shape
    for name, t in grouped_and_fold(torch, np, K_mod, flush, check, data,
                                    ts, members, floor).items():
        results[name]["times"] = t

    # the chunked call over the cluster route's shared-memory cap: the
    # global-atomic route, as `plan` chooses it
    chunked_groups(torch, np, K_mod, flush, data, ts, members[64], floor,
                   (K_mod.MAX_SMEM - K_mod.STAGE_BYTES) //
                   (K_mod.LANES * 4) + 1, check)

    # its own seed
    erng = np.random.default_rng(4)
    # K over the 8 timestamps a lane holds (walked 8 at a time), an odd E
    # (tag and field loaded one by one) and BP 3 (segment route only), at
    # a P over two rounds of the persistent grids
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_round = K_mod.WARP_BLOCKS_PER_SM * sms * K_mod.WARP_THREADS
    p_edge = -(-(2 * per_round + 17) // 24) * 24
    for k, e in ((9, 3), (33, 2)):
        d_np, t_np = make_store(np, p_edge, k, e, erng)
        d, t = torch.from_numpy(d_np).to(dev), torch.from_numpy(t_np).to(dev)
        gid, prm, _ = group_inputs(40, erng)
        gid = gid[:p_edge].contiguous()
        for bp in (3, 8):
            args = (d, t, members[64], floor, 1, 0, 50)
            want = R.rss_scan_agg_ref(*args, block_pages=bp)
            check("rss_scan_agg", K_mod.rss_scan_agg(*args, block_pages=bp),
                  want)
            other_route(K_mod.rss_scan_agg, args,
                        dict(block_pages=bp), want, timed=False)
        gargs = (d, t, gid, members[64], floor)
        kw = dict(n_groups=40, group_params=prm)
        want = R.rss_scan_agg_chunked_ref(*gargs, **kw)
        check("rss_scan_agg_chunked", K_mod.rss_scan_agg_chunked(*gargs,
                                                                 **kw), want)
        other_route(K_mod.rss_scan_agg_chunked,
                    gargs, kw, want, timed=False)
        print(f"kernel rss_scan_agg family P={p_edge} K={k} E={e}: BP 3 and "
              "8, and G 40 chunked, == plain on every route", flush=True)

    gather_kernels(torch, np, check, results, data, ts, members, floor,
                   flush)
    return results


def chunked_groups(torch, np, K_mod, flush, data, ts, mem, floor, g,
                   check) -> None:
    """`rss_scan_agg_chunked` at `g` groups, its group ids over 48 groups,
    as the smaller-G calls draw them, and spread over all `g`: each ==
    plain, its route printed where the wrapper reports one, timed beside
    its bound.  Only the wrappers' common contract is used, so
    `scripts/kernel_phase.py --groups G` runs it on an earlier tree's
    wrapper too."""
    from repro_torch.kernels.rss_scan_agg import ref as R

    rng = np.random.default_rng(5)
    P, K = ts.shape
    prm = torch.from_numpy(np.stack([
        rng.choice(np.array([1, 3], np.int32), g),
        rng.choice(np.array([0, -2], np.int32), g),
        rng.integers(-500, 500, g, dtype=np.int32)], 1)).to(data.device)
    fn = K_mod.rss_scan_agg_chunked
    for spread, hi in (("48 groups", 48), ("spread", g)):
        gid_np = rng.integers(-1, hi, (P, 1), dtype=np.int32)
        gid = torch.from_numpy(gid_np).to(data.device)
        gargs, kw = (data, ts, gid, mem, floor), dict(n_groups=g,
                                                      group_params=prm)
        got = fn(*gargs, **kw)
        check("rss_scan_agg_chunked", got,
              R.rss_scan_agg_chunked_ref(*gargs, **kw))
        launch = getattr(fn, "last_route", None)
        nbytes = (P * 4 + int((gid_np >= 0).sum()) * (K * 4 + 32)
                  + mem.numel() * 4 + g * 12 + got.numel() * 4)
        ms = time_ms(torch, lambda: fn(*gargs, **kw), flush)
        print(f"kernel rss_scan_agg_chunked P={P} G={g} M={mem.numel()} "
              f"gid {spread} ["
              f"{_scan_launch_txt(launch) if launch else 'one route'}]: "
              f"kernel_ms={ms:.4f} "
              f"bound_ms={nbytes / HBM_BYTES_PER_S * 1e3:.4f}", flush=True)


# rss_scan_agg_grouped (P, G, M, BP): the kernel phase's store at every G
# (M 64) and every M (G 40) at BP 8, at BP 3 (P cut to a multiple of 3;
# a warp tile of 10 segments) and at BP 64 (the segment route's), then
# every shape of the driver phase (a store of their own, made at the
# first and largest; M 0); rss_delta_fold (Lp, Dp): the flush buffer's
# shapes, Lp 8 on both sides of the sliced and grid routes' switch and at
# every larger Dp of the driver phase, Lp 64 and 2,048 at 131,072 rows
# (the grid route's cap on partials), and Lp over a block's shared memory
GROUPED_SHAPES = ((400_000, 1, 64, 8), (400_000, 16, 64, 8),
                  (400_000, 40, 64, 8), (400_000, 256, 64, 8),
                  (400_000, 40, 0, 8), (400_000, 40, 4096, 8),
                  (399_999, 40, 64, 3), (400_000, 40, 64, 64),
                  (920_008, 43, 0, 8), (800_016, 3, 0, 8),
                  (400_016, 2, 0, 8), (120_016, 2, 0, 8))
FOLD_SHAPES = ((64, 256), (8, 256), (8, 1024), (8, 2048), (8, 4096),
               (8, 8192), (8, 32_768), (8, 131_072), (8, 262_144),
               (8, 524_288), (8, 1_048_576), (64, 131_072), (2048, 131_072),
               (16_384, 256))


def _device_ops(torch, fn, traces: int = 3, tries: int = 12) -> int:
    """Device operations (kernels, copies, fills) of one `fn()` call in a
    torch.profiler trace: the most of `traces` traces, since a trace may
    drop an event (a two-operation call once showed one) but never adds
    one.  Each trace ends with a marker, `torch.cuda._sleep`'s spin
    kernel, launched on the call's stream after it and not counted: a
    trace without its marker lost its events (a run once gave three empty
    traces in a row of a one-kernel call) and is taken again, up to
    `tries` traces in all.  Raises if none kept its marker."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen, lost = [], 0
    while len(seen) < traces and lost + len(seen) < tries:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        marks = sum("spin_kernel" in n for n in names)
        if marks:
            seen.append(len(names) - marks)
        else:
            lost += 1
            time.sleep(0.05 * lost)
    if lost:
        print(f"profiler: {lost} of {lost + len(seen)} traces lost their "
              "marker and were taken again", flush=True)
    if not seen:
        raise RuntimeError(f"torch.profiler recorded no marker in {tries} "
                           "traces: device operations not counted")
    return max(seen)


def grouped_and_fold(torch, np, K_mod, flush, check, data, ts, members,
                     floor) -> dict:
    """`rss_scan_agg_grouped` at GROUPED_SHAPES and `rss_delta_fold` at
    FOLD_SHAPES, each on every route that takes the call where the
    wrapper plans routes (else the one it has): == plain, timed beside
    its byte bound and a yardstick (`fill_only_ms`: PyTorch's `fill_` of
    a tensor the size of the grouped output, the floor for writing it
    once; `sector_only_ms`: `delta[:, :8].sum()`, PyTorch reading the
    first sector of every delta row), and its device operations a call
    counted in a profiler trace (one, where it plans routes).  Only the
    wrappers' common contract is used, so `scripts/kernel_phase.py TREE
    --shapes` runs it on an earlier tree's wrappers.  Returns {name: (ms,
    plain_ms, bound_ms)} at P 400,000 G 40 M 64 and at Lp 64 Dp 256, on
    the route `plan` gives."""
    from repro_torch.kernels.rss_scan_agg import ref as R

    dev = data.device
    rng = np.random.default_rng(6)
    planned = getattr(K_mod, "ROUTES", {})
    times = {}

    def routes(name, **kw):
        return K_mod.routes_for(name, **kw) if name in planned else (None,)

    def timed(name, label, fn, plain, nbytes, want, kw, extra):
        """fn on each route == plain, each timed (the route `plan` takes
        last); plain timed once.  Returns the times on `plan`'s route."""
        plain_ms = time_ms(torch, plain, flush, reps=5)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        note = extra()
        for route in routes(name, **kw):
            call = (fn if route is None else
                    lambda route=route: fn(route=route))
            check(name, call(), want)
            launch = getattr(getattr(K_mod, name), "last_route", None)
            ops = _device_ops(torch, call)
            if route is not None and ops != 1:
                raise AssertionError(f"{name} {label} route {route}: "
                                     f"{ops} device operations a call")
            ms = time_ms(torch, call, flush)
            txt = _scan_launch_txt(launch) if launch else "one route"
            print(f"kernel {name} {label} [{txt}]: kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} {note} bound_ms="
                  f"{bound_ms:.4f} ({nbytes / 1e6:.1f} MB), {ops} device "
                  "operation(s) a call", flush=True)
        return ms, plain_ms, bound_ms

    big = None
    for P, g, m, bp in GROUPED_SHAPES:
        if P > data.shape[0] and big is None:
            d_np, t_np = make_store(np, P, 8, 32, np.random.default_rng(7))
            big = torch.from_numpy(d_np).to(dev), torch.from_numpy(t_np).to(
                dev)
            del d_np, t_np
        d, t = ((data[:P], ts[:P]) if P <= data.shape[0]
                else (big[0][:P], big[1][:P]))
        k = t.shape[1]
        gid_np = rng.integers(-1, g, (P, 1), dtype=np.int32)
        gid = torch.from_numpy(gid_np).to(dev)
        prm = torch.from_numpy(np.stack([
            rng.choice(np.array([1, 3], np.int32), g),
            rng.choice(np.array([0, -2], np.int32), g),
            rng.integers(-500, 500, g, dtype=np.int32)], 1)).to(dev)
        a = (d, t, gid, members[m], floor)
        kw = dict(n_groups=g, group_params=prm, block_pages=bp)
        want = R.rss_scan_agg_grouped_ref(*a, **kw)
        shell = torch.empty_like(want)
        nbytes = (P * 4 + int((gid_np >= 0).sum()) * (k * 4 + 32) + m * 4
                  + g * 12 + want.numel() * 4)
        t_ = timed("rss_scan_agg_grouped", f"P={P} G={g} M={m} BP={bp}",
                   lambda route=None, a=a, kw=kw:
                   K_mod.rss_scan_agg_grouped(
                       *a, **kw, **({} if route is None else
                                    {"route": route})),
                   lambda a=a, kw=kw: R.rss_scan_agg_grouped_ref(*a, **kw),
                   nbytes, want, dict(block_pages=bp, n_groups=g, members=m),
                   lambda: "fill_only_ms="
                   f"{time_ms(torch, lambda: shell.fill_(0), flush)}")
        if (P, g, m, bp) == (400_000, 40, 64, 8):
            times["rss_scan_agg_grouped"] = t_
    del big
    for lp, dp in FOLD_SHAPES:
        acc = torch.from_numpy(np.concatenate([
            rng.integers(-2**20, 2**20, (lp, 3), dtype=np.int32),
            rng.integers(-100, 100, (lp, 2), dtype=np.int32),
            rng.integers(-2**20, 2**20, (lp, 123), dtype=np.int32)],
            1)).to(dev)
        cols = np.stack([rng.integers(-1, lp, dp),
                         rng.integers(-2**20, 2**20, dp),
                         rng.integers(0, 2, dp),
                         rng.integers(-2**20, 2**20, dp),
                         rng.integers(0, 2, dp),
                         rng.integers(-1000, 1000, dp)], 1).astype(np.int32)
        delta = torch.zeros((dp, 128), dtype=torch.int32, device=dev)
        delta[:, :6] = torch.from_numpy(cols).to(dev)
        want = R.rss_delta_fold_ref(acc, delta)
        t_ = timed("rss_delta_fold", f"Lp={lp} Dp={dp}",
                   lambda route=None, acc=acc, delta=delta:
                   K_mod.rss_delta_fold(acc, delta, **(
                       {} if route is None else {"route": route})),
                   lambda acc=acc, delta=delta:
                   R.rss_delta_fold_ref(acc, delta),
                   dp * 32 + 2 * lp * 128 * 4, want,
                   dict(lanes=lp, rows=dp),
                   lambda delta=delta: "sector_only_ms=" + (
                       f"{time_ms(torch, lambda: delta[:, :8].sum(), flush)}"
                       if dp > 4096 else "-"))
        if (lp, dp) == (64, 256):
            times["rss_delta_fold"] = t_
    return times


def _scan_launch_txt(launch) -> str:
    """A scan+aggregate wrapper's `last_route` as printed: route, grid x
    block, cluster and dynamic shared memory."""
    grid = " x ".join(str(g) for g in launch.grid)
    return (f"route {launch.route}, grid {grid} of {launch.block} threads, "
            f"cluster {launch.cluster}, {launch.smem} B shared")


def _gather_launch_txt(launch) -> str:
    """A gather wrapper's `last_route` as printed: route, grid x block,
    and the pages a warp takes at a time."""
    return (f"route {launch.route}, grid {launch.grid[0]} of {launch.block} "
            f"threads, {launch.pages_per_warp} pages a warp")


def gather_kernels(torch, np, check, results, data, ts, members, floor,
                   flush):
    """version_gather and rss_gather against their plain versions on the
    wrappers' own route and, where more than one takes the store
    (`routes_for`), on each forced: at the mirror's shape (the scan phase's store)
    with M in {0, 64, 4096} and with member sets that drive each staging
    of the members (`member_staging`), at the bf16 embedding store, and
    at edge shapes.  Timed at the mirror and embedding shapes, every
    route, beside the plain version, the bound and `copy_only_ms`: the
    chosen rows copied by `data[rows, slot]` with the row index and the
    int64 slots built before the timed call, a yardstick of the copy half
    (the port never calls it).
    `library_ms` is None: no PyTorch call computes the visibility
    resolve.  Bound: per page K*4 bytes of ts, one row read and one row
    written, plus M*4 bytes of members."""
    from repro_torch.kernels.rss_gather import kernel as RG
    from repro_torch.kernels.rss_gather import ref as RGR
    from repro_torch.kernels.version_gather import kernel as VG
    from repro_torch.kernels.version_gather import ref as VGR

    def routes(d):
        """The routes that take `d` (outputs from torch.empty start on 16
        bytes, so the data's start decides)."""
        return RG.routes_for(d.shape[1], d.shape[2] * d.element_size(),
                             d.data_ptr() % 16 == 0)

    def both(shape, d, t, mem, fl, wm, timed, say=True):
        """Each kernel on its own route choice and on every route forced,
        each == plain; when `timed`, each route timed.  Returns the times
        (ms, plain, bound) of the routes `plan` chose.  `say`: print the
        untimed checks too."""
        nbytes = d.shape[0] * (d.shape[1] * 4 + 2 * d.shape[2]
                               * d.element_size())
        no_mem = mem[:0]
        cases = (("rss_gather", RG.rss_gather, (d, t, mem, fl),
                  lambda: RGR.rss_gather_ref(d, t, mem, fl),
                  RGR.rss_visible_slots_ref(t, mem, fl),
                  f"{shape} M={mem.numel()}", nbytes + mem.numel() * 4),
                 ("version_gather", VG.version_gather, (d, t, wm),
                  lambda: VGR.version_gather_ref(d, t, wm),
                  RGR.rss_visible_slots_ref(t, no_mem, wm), shape, nbytes))
        times = {}
        forced = routes(d) if len(routes(d)) > 1 else ()
        for name, fn, args, plain, slot, label, nb in cases:
            want = plain()
            for route in (None, *forced):
                check(name, fn(*args, route=route), want)
                launch = fn.last_route
                if route is None:
                    chosen = launch
                if not timed:
                    continue
                ms = time_ms(torch, lambda: fn(*args, route=route), flush)
                if route is not None:
                    print(f"kernel {name} {label} [{_gather_launch_txt(launch)}"
                          f", forced]: kernel_ms={ms:.4f}", flush=True)
                    continue
                plain_ms = time_ms(torch, plain, flush, reps=5)
                rows = torch.arange(d.shape[0], device=d.device)
                slot64 = slot.long()
                copy_ms = time_ms(torch, lambda: d[rows, slot64], flush)
                bound_ms = nb / HBM_BYTES_PER_S * 1e3
                print(f"kernel {name} {label} [{_gather_launch_txt(launch)}]:"
                      f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"copy_only_ms={copy_ms:.4f} bound_ms={bound_ms:.4f} "
                      f"library_ms=null (no PyTorch call computes the "
                      f"visibility resolve) ({nb / 1e6:.1f} MB)", flush=True)
                times[name] = (ms, plain_ms, bound_ms)
            if say and not timed:
                print(f"kernel {name} {label}: routes {routes(d)} == plain; "
                      f"chosen [{_gather_launch_txt(chosen)}]", flush=True)
        return times

    P, K, E = data.shape
    mirror = f"mirror int32 P={P} K={K} E={E}"
    for m, mem in members.items():
        t = both(mirror, data, ts, mem, floor, floor, timed=True)
        if m == 64:               # the mirror's concurrent window
            results["rss_gather"]["times"] = t["rss_gather"]
            results["version_gather"]["times"] = t["version_gather"]
            _clean_l2_time(torch, f"rss_gather {mirror} M=64",
                           lambda: RG.rss_gather(data, ts, mem, floor), flush)
            _clean_l2_time(torch, f"version_gather {mirror}",
                           lambda: VG.version_gather(data, ts, floor), flush)

    # member sets for each staging of the members in shared memory on the
    # tile route: the bitmap with duplicates and members at or below the
    # floor; a span over the bitmap's cap (the shared array); a span that
    # overflows int32; an M over the array's cap (binary search in device
    # memory, as the warp route does for every set).  The staging is what
    # gather.cu's rule reports (`member_staging`).
    _, array_cap = RG.staging_caps()
    rng = np.random.default_rng(3)
    above = np.arange(floor + 1, 12_000, dtype=np.int64)
    sets = {
        "dups+below": np.concatenate([[0, 5, floor], rng.choice(above, 300),
                                      rng.choice(above, 300)]),
        "span>cap": np.concatenate([rng.choice(above, 4096, replace=False),
                                    [10**7]]),
        "int32 span": np.concatenate([[-2**31, -5, 0, floor],
                                      rng.choice(above, 2000),
                                      [2**31 - 1, 2**31 - 1]]),
        "M>cap": np.concatenate([rng.choice(above, 5000, replace=False),
                                 rng.choice(np.arange(10**6, 2 * 10**6),
                                            array_cap, replace=False)]),
    }
    seen = set()
    for label, arr in sets.items():
        arr = np.sort(arr).astype(np.int32)
        how = RG.member_staging(arr.size, int(arr[0]), int(arr[-1]))
        seen.add(how)
        mem = torch.from_numpy(arr).to(data.device)
        print(f"kernel rss_gather members {label}: M={arr.size} span "
              f"{int(arr[-1]) - int(arr[0]) + 1} staged as {how} on the "
              f"tile route", flush=True)
        both(f"{mirror} {label}", data, ts, mem, floor, floor, timed=False)
    if seen != {"bitmap", "array", "global"}:
        raise AssertionError(f"member sets staged as {seen}: not every "
                             "staging driven")

    dev = data.device
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    emb = torch.randn((EMBED_P, EMBED_K, EMBED_E), generator=g, device=dev,
                      dtype=torch.bfloat16)
    emb_ts = torch.randint(0, 1000, (EMBED_P, EMBED_K), generator=g,
                           device=dev, dtype=torch.int32)
    rng = np.random.default_rng(1)
    mem = torch.from_numpy(np.sort(rng.choice(np.arange(251, 1000), 64,
                                              replace=False)).astype(
        np.int32)).to(dev)
    t = both(f"embedding bf16 P={EMBED_P} K={EMBED_K} E={EMBED_E}", emb,
             emb_ts, mem, 250, 500, timed=True)
    results["rss_gather"]["times_embedding"] = t["rss_gather"]
    results["version_gather"]["times_embedding"] = t["version_gather"]
    del emb, emb_ts

    # E 32 (64- and 128-byte rows) takes the tile route where the rows are
    # aligned and K <= 8, at a P over two rounds of its persistent grid
    # (several tiles a warp, the last one part way)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p_tiles = 2 * RG.TILE_BLOCKS_PER_SM * sms * (RG.THREADS // 32) * 32 + 17
    n_edge = 0
    for dtype in (torch.bfloat16, torch.int32):
        for k in (1, 3, 33):
            for e in (1, 3, 32, 640):
                for offset in (0, 1):           # 1: rows not 16-B aligned
                    p = p_tiles if e == 32 else 10_007
                    flat = torch.randint(-2**31, 2**31 - 1,
                                         (p * k * e + offset,), generator=g,
                                         device=dev, dtype=torch.int32)
                    d = (flat.to(torch.bfloat16) if dtype == torch.bfloat16
                         else flat)[offset:].view(p, k, e)
                    t = torch.randint(0, 60, (p, k), generator=g,
                                      device=dev, dtype=torch.int32)
                    mem = torch.arange(31, 60, 3, dtype=torch.int32,
                                       device=dev)
                    both(f"edge {dtype} K={k} E={e} offset={offset}", d, t,
                         mem, 20, 40, timed=False, say=False)
                    n_edge += 1
    print(f"kernel gathers: {n_edge} edge shapes (K 1/3/33, E 1/3/32/640, "
          f"bf16/int32, aligned/unaligned rows; P {p_tiles} at E 32) equal "
          "to plain on each route that takes them", flush=True)


# ------------------------------------------------------------ driver phases
def _metrics_equal(a, b) -> None:
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    for k in da:
        va, vb = da[k], db[k]
        if k in ("serve_latency", "oltp_commit_latency"):
            va, vb = va.get("count"), vb.get("count")
        elif k in ("serve_latency_by_plan", "serve_stage_latency"):
            va = {x: y["count"] for x, y in va.items()}
            vb = {x: y["count"] for x, y in vb.items()}
        if va != vb:
            raise AssertionError(f"cuda vs cpu metric {k}: {va} != {vb}")


def small_driver_phase() -> None:
    """The whole port on "cuda" against the same run on "cpu" (plain
    versions): equal metrics, OLAP outputs included."""
    from repro_torch.mvcc import Scale, run_single_node

    kw = dict(olap_mode="ssi+rss", oltp_clients=4, olap_clients=3,
              rounds=150, seed=3, olap_scan=True, paged_olap=True,
              check_scans=True, batch_plans=True, materialize=True,
              scale=Scale(warehouses=2, districts=20, customers=10,
                          items=200, order_capacity=10))
    t0 = time.perf_counter()
    a = run_single_node(device="cuda", **kw)
    b = run_single_node(device="cpu", **kw)
    _metrics_equal(a, b)
    print(f"small driver: cuda == cpu over {a.olap_commits} OLAP commits, "
          f"{len(a.olap_outputs)} outputs, modes flat/chunked/host "
          f"{a.olap_mode_flat}/{a.olap_mode_chunked}/{a.olap_mode_host} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def _profiled(torch, fn, out_dir: Path):
    """Run `fn` under cProfile (host) and torch.profiler (device), write
    both reports under `out_dir`, print the device-time totals; returns
    fn's result.  Host times under cProfile run slower than unprofiled."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    host = cProfile.Profile()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        host.enable()
        result = fn()
        host.disable()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    buf = io.StringIO()
    stats = pstats.Stats(host, stream=buf)
    stats.sort_stats("cumulative").print_stats(60)
    stats.sort_stats("tottime").print_stats(40)
    (out_dir / "driver_cprofile.txt").write_text(buf.getvalue())
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    (out_dir / "driver_device_time.txt").write_text("\n".join(
        f"{us:14.1f} us  x{n:6d}  {k}" for k, us, n in rows))
    busy = sum(us for _k, us, _n in rows) / 1e6
    print(f"profile: wall {wall:.1f} s (under cProfile), device busy "
          f"{busy:.3f} s, idle share {1 - busy / wall:.4f}", flush=True)
    for k, us, n in rows[:12]:
        print(f"profile device: {us / 1e3:10.3f} ms x{n:5d} {k[:70]}",
              flush=True)
    top = pstats.Stats(host).sort_stats("cumulative")
    for (fname, line, func), (_cc, nc, tt, ct, _c) in sorted(
            top.stats.items(), key=lambda kv: -kv[1][3])[:25]:
        if "repro_torch" in fname:
            short = fname.split("repro_torch/")[-1]
            print(f"profile host: {ct:8.2f} s cum {tt:7.2f} s self "
                  f"x{nc:8d} {short}:{line}({func})", flush=True)
    return result


@contextlib.contextmanager
def record_scan_shapes(K_mod):
    """Count the calls of each `rss_scan_agg` kernel that the ops layer
    makes, by shape: (P, M, BP) for `rss_scan_agg`, (P, G, M, BP) for
    `rss_scan_agg_grouped`, (P, G, M) for `rss_scan_agg_chunked`, (Lp,
    Dp) for `rss_delta_fold`, each with the route it took.  Wraps the
    names `kernels.rss_scan_agg.ops` calls; yields the Counter."""
    from collections import Counter

    from repro_torch.kernels.rss_scan_agg import ops

    shapes = Counter()

    def route_of(fn):
        return f" route={fn.last_route.route}" if fn.last_route else ""

    def scan(fn):
        def call(data, ts, member_ts, *a, block_pages=8, **kw):
            out = fn(data, ts, member_ts, *a, block_pages=block_pages, **kw)
            P = data.shape[0]
            shapes[(fn.__name__, f"P={P} M={member_ts.numel()} "
                    f"BP={min(block_pages, P)}{route_of(fn)}")] += 1
            return out
        return call

    def grouped(fn):
        def call(data, ts, gid, member_ts, *a, n_groups=1, **kw):
            out = fn(data, ts, gid, member_ts, *a, n_groups=n_groups, **kw)
            bp = min(kw.get("block_pages", 8), data.shape[0])
            tail = (f" BP={bp}" if fn is K_mod.rss_scan_agg_grouped
                    else "") + route_of(fn)
            shapes[(fn.__name__, f"P={data.shape[0]} G={n_groups} "
                    f"M={member_ts.numel()}{tail}")] += 1
            return out
        return call

    def fold(fn):
        def call(acc, delta):
            out = fn(acc, delta)
            shapes[(fn.__name__, f"Lp={acc.shape[0]} Dp={delta.shape[0]}"
                    f"{route_of(fn)}")] += 1
            return out
        return call

    wraps = {"rss_scan_agg": scan, "rss_scan_agg_grouped": grouped,
             "rss_scan_agg_chunked": grouped, "rss_delta_fold": fold}
    saved = {name: getattr(ops, name) for name in wraps}
    for name, wrap in wraps.items():
        setattr(ops, name, wrap(getattr(K_mod, name)))
    try:
        yield shapes
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def record_attention_shapes():
    """Count the launches of the attention kernels by shape:
    ("flash_attention", S, T, causal), ("flash_attention_bwd", S, T,
    causal) and ("decode_attention", T) (the cache's slots).  Wraps the
    names the attention ops call; a call counts only where its kernel
    launched (not for CPU tensors).  Yields the Counter."""
    from collections import Counter

    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.flash_attention import ops as FO

    shapes = Counter()
    flash, decode = FO.flash_attention, DO.decode_attention
    flash_bwd = FO.flash_attention_bwd

    def flash_call(q, k, v, *, causal=True, window=0, return_lse=False):
        n = flash.launches
        out = flash(q, k, v, causal=causal, window=window,
                    return_lse=return_lse)
        if flash.launches > n:
            shapes[("flash_attention", q.shape[2], k.shape[2],
                    bool(causal))] += flash.launches - n
        return out

    def bwd_call(q, k, v, o, lse, do, *, causal=True, window=0):
        n = flash_bwd.launches
        out = flash_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        if flash_bwd.launches > n:
            shapes[("flash_attention_bwd", q.shape[2], k.shape[2],
                    bool(causal))] += flash_bwd.launches - n
        return out

    def decode_call(q, k, v, valid_len):
        n = decode.launches
        out = decode(q, k, v, valid_len)
        if decode.launches > n:
            shapes[("decode_attention", k.shape[2])] += decode.launches - n
        return out

    FO.flash_attention, DO.decode_attention = flash_call, decode_call
    FO.flash_attention_bwd = bwd_call
    try:
        yield shapes
    finally:
        FO.flash_attention, DO.decode_attention = flash, decode
        FO.flash_attention_bwd = flash_bwd


def driver_phase(torch, K_mod, rounds: int,
                 profile_dir: Path | None = None) -> dict:
    from repro_torch.kernels.cuda_build import launch_count
    from repro_torch.mvcc import Scale, run_single_node

    scale = Scale(**TPCC)
    run = lambda: run_single_node(
        olap_mode="ssi+rss", oltp_clients=8, olap_clients=4, rounds=rounds,
        seed=0, scale=scale, olap_scan=True, paged_olap=True,
        batch_plans=True, materialize=True, check_scans=True, device="cuda")
    K_mod.reset_launches()
    t0 = time.perf_counter()
    with record_scan_shapes(K_mod) as shapes:
        m = run() if profile_dir is None else _profiled(torch, run,
                                                         profile_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: launch_count(fn) for fn in K_mod.KERNELS}
    print(f"driver: {rounds} rounds in {wall:.1f} s: oltp commits "
          f"{m.oltp_commits} aborts {m.oltp_aborts}, olap commits "
          f"{m.olap_commits} aborts {m.olap_aborts}; modes flat "
          f"{m.olap_mode_flat} chunked {m.olap_mode_chunked} host "
          f"{m.olap_mode_host}; view hits {m.olap_view_hits} fallbacks "
          f"{m.olap_view_fallbacks} demotions {m.olap_view_demotions}; "
          f"device calls {m.olap_kernel_device_calls}", flush=True)
    for stage, s in sorted(m.serve_stage_latency.items()):
        print(f"driver stage {stage}: n={s['count']} p50_us={s['p50_us']} "
              f"p99_us={s['p99_us']}", flush=True)
    print(f"driver launches: {json.dumps(launches)}", flush=True)
    for (name, shape), n in sorted(shapes.items()):
        print(f"driver launch shape: {name} {shape}: {n}", flush=True)
    for name in ("rss_scan_agg", "rss_scan_agg_grouped",
                 "rss_scan_agg_chunked", "rss_delta_fold"):
        print(f"driver launches by route: {name} "
              f"{getattr(K_mod, name).route_launches}", flush=True)
    if sum(shapes.values()) != sum(launches.values()):
        raise AssertionError(f"shapes {sum(shapes.values())} != launches "
                             f"{sum(launches.values())}")
    if m.olap_aborts or m.olap_commits == 0:
        raise AssertionError("RSS readers must commit and never abort")
    if min(launches.values()) == 0:
        raise AssertionError(f"kernels never launched: {launches}")
    return launches


# ------------------------------------------------------ snapshot-read path
def oltp_traffic(engine, scale, n_txns: int, refresh, *, clients: int = 8,
                 seed: int = 0, refresh_every: int = 64):
    """Interleave `clients` OLTP writers of the `mvcc.workload` mix one
    step each per round until `n_txns` have finished, calling `refresh()`
    every `refresh_every` rounds (as the driver refreshes its RSS); the
    writers open at the end stay in flight.  Returns (commits, aborts,
    keys written by committed transactions)."""
    from repro_torch.mvcc import SerializationFailure, Status, \
        oltp_transaction

    rng = random.Random(seed)
    live = [None] * clients          # [txn, step generator, pending, keys]
    done = commits = aborts = rounds = 0
    written = set()
    while done < n_txns:
        rounds += 1
        if rounds % refresh_every == 0:
            refresh()
        for i in range(clients):
            c = live[i]
            if c is None:
                gen, name = oltp_transaction(rng, scale)
                live[i] = [engine.begin(read_only=name == "order_status"),
                           gen, None, []]
                continue
            txn, gen, pending, keys = c
            try:
                if txn.status == Status.ABORTED:
                    raise SerializationFailure(txn.abort_reason)
                try:
                    step = gen.send(pending)
                except StopIteration:
                    engine.commit(txn)
                    commits += 1
                    written.update(keys)
                    done += 1
                    live[i] = None
                    continue
                c[2] = None
                if step[0] == "r":
                    c[2] = engine.read(txn, step[1])
                elif step[0] == "w":
                    engine.write(txn, step[1], step[2])
                    keys.append(step[1])
            except SerializationFailure:
                aborts += 1
                done += 1
                live[i] = None
    in_flight = sum(1 for c in live if c is not None and c[3])
    return commits, aborts, written, in_flight


def path_phase(torch, n_txns: int, device: str = "cuda") -> dict:
    """The whole TPC-C-scale mirror read at a pinned RSS snapshot through
    the gather kernels, held against the mirror's host scans and the
    engine's per-key protected reads.  Returns phase timings (s).
    (`device="cpu"` runs the plain versions: a rehearsal off the card.)"""
    from repro_torch.kernels.rss_gather.ops import (member_tensor,
                                                    snapshot_read_members)
    from repro_torch.kernels.rss_gather.ref import rss_gather_ref
    from repro_torch.kernels.version_gather.ops import snapshot_read
    from repro_torch.mvcc import Scale, SingleNodeHTAP, load_initial
    from repro_torch.tensorstore import decode_value, gather_pages

    times = {}
    clock = [time.perf_counter()]

    def lap(name):
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        times[name] = now - clock[0]
        clock[0] = now

    scale = Scale(**TPCC)
    htap = SingleNodeHTAP("ssi+rss", paged=True, device=device,
                          reserve_keys=scale.key_families())
    load_initial(htap.engine, scale)
    htap.refresh_rss()
    lap("setup_load_s")
    commits, aborts, written, in_flight = oltp_traffic(
        htap.engine, scale, n_txns, htap.refresh_rss)
    htap.refresh_rss()
    rid, snap = htap.prot.acquire()
    lap("oltp_s")
    mirror = htap.mirror
    members = mirror.member_seqs_for(snap)
    store = mirror.torch_store()
    lap("export_s")
    out = snapshot_read_members(store, members, snap.floor_seq)
    lap("rss_read_s")
    if not torch.equal(out, rss_gather_ref(
            store["data"], store["ts"],
            member_tensor(members, store["ts"].device), snap.floor_seq)):
        raise AssertionError("rss_gather != plain on the mirror")
    lap("plain_check_s")
    keys, page_of = mirror.keys, mirror.page_of      # page i holds keys[i]
    dev_vals = [decode_value(r) for r in out[:len(keys)].cpu().numpy()]
    lap("decode_s")
    host_vals = mirror.scan_members(keys, snap)
    lap("scan_members_s")
    if dev_vals != host_vals:
        bad = next(i for i, (a, b) in enumerate(zip(dev_vals, host_vals))
                   if a != b)
        raise AssertionError(f"rss_gather != scan_members at {keys[bad]}: "
                             f"{dev_vals[bad]} != {host_vals[bad]}")
    read = dict(zip(keys, dev_vals))
    rng = random.Random(1)
    check_keys = sorted(written) + rng.sample(keys, min(10_000, len(keys)))
    reader = htap.engine.begin(read_only=True, rss=snap)
    for k in check_keys:
        want = htap.engine.read(reader, k)
        want = 0 if want is None else want    # never written: the codec's 0
        if read[k] != want:
            raise AssertionError(f"rss_gather != engine read at {k}: "
                                 f"{read[k]} != {want}")
    lap("engine_reads_s")
    for wm in (snap.floor_seq, mirror.watermark):
        at = snapshot_read(store, wm)
        if [decode_value(r) for r in at[:len(keys)].cpu().numpy()] != \
                mirror.scan_at(keys, wm):
            raise AssertionError(f"version_gather != scan_at at {wm}")
    older = int((out != at).any(dim=1).sum())     # at: the newest commit
    if older == 0:
        raise AssertionError("no page read a previous version: the RSS "
                             "read never skipped a committed writer")
    sub_keys = check_keys[:5000]
    sub = gather_pages(store, [page_of[k] for k in sub_keys])
    got = snapshot_read_members(sub, members, snap.floor_seq).cpu().numpy()
    if [decode_value(r) for r in got[:len(sub_keys)]] != \
            [read[k] for k in sub_keys]:
        raise AssertionError("gather_pages sub-store read != whole read")
    lap("scan_at_and_sub_s")
    htap.prot.release(rid)
    gb = store["data"].numel() * 4 / 1e9
    print(f"path: {mirror.n_pages} pages ({gb:.3f} GB of pages on the "
          f"card), {commits} commits {aborts} aborts, "
          f"{in_flight} writers in flight, RSS floor {snap.floor_seq} with "
          f"{len(members)} members above it, newest commit "
          f"{mirror.watermark}; {len(check_keys)} keys held against the "
          f"engine; {older} pages read a previous version", flush=True)
    print("path times: " + " ".join(f"{k}={v:.3f}"
                                    for k, v in times.items()), flush=True)
    return times


# ------------------------------------------------------------- param store
def param_store_phase(torch, device: str = "cuda") -> None:
    """The bf16 embedding store on the card: publishes in three waves at
    rising ts, each under the gc_floor of the wave's start (the pinned
    readers' horizon), then reads at several watermarks at or above the
    last floor and one RSS member read, each held against a
    dict-of-versions oracle over every row."""
    from repro_torch.kernels.rss_gather.ops import snapshot_read_members
    from repro_torch.kernels.version_gather.ops import snapshot_read
    from repro_torch.tensorstore import init_store, publish_page

    t0 = time.perf_counter()
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    initial = torch.randn((EMBED_P, EMBED_E), generator=g, device=dev)
    store = init_store(EMBED_P, EMBED_K, EMBED_E, torch.bfloat16,
                       initial=initial, device=dev)
    rng = random.Random(2)
    versions = {}                       # row -> [(ts, bf16 payload)]
    ts = floor = 0
    for _wave in range(3):
        floor = ts                      # readers pinned at the wave's start
        for row in rng.sample(range(EMBED_P), 120):
            ts += rng.randint(1, 3)
            payload = torch.randn(EMBED_E, generator=g, device=dev)
            publish_page(store, row, payload, ts, gc_floor=floor)
            versions.setdefault(row, []).append(
                (ts, payload.to(torch.bfloat16)))
    members = sorted(rng.sample(range(floor + 1, ts + 1), (ts - floor) // 2))
    base = initial.to(torch.bfloat16)

    def expect(visible):
        want = base.clone()
        for row, vs in versions.items():
            seen = [p for t, p in vs if visible(t)]
            if seen:
                want[row] = seen[-1]
        return want

    n = 0
    for wm in (floor, (floor + ts) // 2, ts):
        got = snapshot_read(store, wm)
        if not torch.equal(got, expect(lambda t: t <= wm)):
            raise AssertionError(f"param store: snapshot_read at {wm}")
        n += 1
    mem = set(members)
    got = snapshot_read_members(store, members, floor)
    if not torch.equal(got, expect(lambda t: t <= floor or t in mem)):
        raise AssertionError("param store: snapshot_read_members")
    print(f"param store: {EMBED_P}x{EMBED_K}x{EMBED_E} bf16 "
          f"({store['data'].numel() * 2 / 1e9:.3f} GB), "
          f"{sum(len(v) for v in versions.values())} publishes over "
          f"{len(versions)} rows, gc_floor {floor}; {n} watermark reads + "
          f"1 member read ({len(members)} members) == oracle in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# -------------------------------------------------------- attention kernels
def _visible_pairs(np, S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask admits: the work this run's shapes
    need (the causal triangle, the window band)."""
    i = np.arange(S)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(S, int)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over the peak for the dtype, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_kernel_phase(torch, np, flush) -> dict:
    """flash_attention and decode_attention against their plain versions
    on the card, in the model's layout as the serve path hands it (q
    [B,S,H,hd], k/v or the cache [B,T,K,hd]), timed beside their bound
    and `scaled_dot_product_attention` on the same work (GQA heads
    expanded and masks built outside the timed region).  Returns
    {name: {"max_abs_err", "times": (ms, plain, bound, library, by)}}, and
    for each shape of `ATTN_ROWS` and `TP_ROWS` a row of its own under
    its key: its "times" and its shape's "max_abs_err"."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention.ops import decode_gqa
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import attention_bshd
    from repro_torch.kernels.flash_attention.ref import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    tol = {"bfloat16": 3e-2, "float32": 2e-5}
    results = {"flash_attention": {"max_abs_err": 0.0},
               "decode_attention": {"max_abs_err": 0.0}}

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dtype))

    def check(name, label, got, want, dtype):
        """Each element within tol of 1 + |want|, and every one within
        tol of the output's max-abs: outputs averaged over many keys
        (Whisper's 1,500 frames) lie well under 1, where the first bound
        alone would be as large as a value."""
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        bad = ~(err <= tol[dtype] * torch.clamp(
            1 + want.abs(), max=want.abs().max().item()))
        if not torch.isfinite(got).all() or bad.any():
            raise AssertionError(f"{name} {label}: kernel != plain "
                                 f"(max |d| {err.max().item()})")
        res = results[name]
        res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
        return err.max().item()

    # the labels with a row of their own
    own = {**{label: r for label, (r, _) in ATTN_ROWS.items()}, **TP_ROWS,
           **FSDP_SERVE_ROWS, **FALLBACK_ROWS}

    def row(key, err, times):
        """A row of its own for a shape of ATTN_ROWS, TP_ROWS,
        FSDP_SERVE_ROWS or FALLBACK_ROWS."""
        res = results.setdefault(key, {"max_abs_err": 0.0})
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if times is not None:
            res["times"] = times

    def report(name, label, fn, plain, library, nbytes, flops, dtype):
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        library_ms = time_ms(torch, library, flush)
        bound_ms, by = _bound(nbytes, flops, dtype)
        print(f"kernel {name} {label}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
              f"library_ms={library_ms:.4f} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)", flush=True)
        return ms, plain_ms, bound_ms, library_ms, by

    def sdpa(q, k, v, causal, window):
        """SDPA in its own [B,H,S,hd] layout with K/V heads expanded."""
        G = q.shape[2] // k.shape[2]
        qh = q.transpose(1, 2).contiguous()
        kh, vh = (x.transpose(1, 2).repeat_interleave(G, 1).contiguous()
                  for x in (k, v))
        mask = None
        if window:
            i = torch.arange(q.shape[1], device=dev)[:, None]
            j = torch.arange(k.shape[1], device=dev)[None, :]
            mask = i - j < window
            if causal:
                mask &= i >= j
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=causal and not window)

    # (label, dtype, B, S, T, H, K, hd, causal, window, timed)
    flash_cases = [
        ("prefill", "bfloat16", 8, 1024, 1024, 16, 16, 64, True, 0, True),
        ("gqa+window", "bfloat16", 2, 2048, 2048, 32, 8, 128, True, 256,
         True),
        ("jamba prefill", "bfloat16", 8, 1024, 1024, 64, 8, 128, True, 0,
         True),
        ("ragged", "bfloat16", 2, 1000, 1000, 16, 16, 64, True, 0, False),
        ("ragged", "float32", 2, 1000, 1000, 8, 2, 32, False, 0, False),
        # Whisper-tiny's encoder (32 clips of 1,500 frames) and its
        # cross-attention prefill (the 4-token prompt over the frames)
        ("whisper encoder", "bfloat16", 32, 1500, 1500, 6, 6, 64, False, 0,
         True),
        ("cross prefill", "bfloat16", 32, 4, 1500, 6, 6, 64, False, 0,
         True),
        # one rank's prefill of Qwen2-VL-72B at model 4 (TP_ROWS)
        ("tp prefill", "bfloat16", TP_B, TP_S, TP_S, 16, 2, 128, True, 0,
         True),
        # one rank's gathered prefill: Qwen1.5-0.5B's rows of the sharded
        # train phase's serving (FSDP_SERVE_ROWS) and Mixtral-8x22B's of
        # the fallback serve step (FALLBACK_ROWS), whole heads
        ("fsdp serve prefill", "bfloat16", FSDP_SERVE_RANK[0], FSDP_SERVE[1],
         FSDP_SERVE[1], 16, 16, 64, True, 0, True),
        ("fallback prefill", "bfloat16", FALLBACK_RANK[0], FALLBACK_SERVE[1],
         FALLBACK_SERVE[1], 48, 8, 128, True, 4096, True)]
    for (label, dt, B, S, T, H, K, hd, causal, window, timed) in flash_cases:
        q = randn((B, S, H, hd), dt)
        k, v = randn((B, T, K, hd), dt), randn((B, T, K, hd), dt)
        fn = lambda: attention_bshd(q, k, v, causal=causal, window=window)
        plain = lambda: attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
        got = fn()
        shape = (f"{dt} B={B} S={S} T={T} H={H} K={K} hd={hd} "
                 f"causal={causal} window={window} "
                 f"route={FK.flash_attention.last_route}")
        err = check("flash_attention", shape, got, plain(), dt)
        t = None
        if timed:
            esz = q.element_size()
            nbytes = esz * (2 * B * S * H * hd + 2 * B * T * K * hd)
            flops = 4 * B * H * hd * _visible_pairs(np, S, T, causal,
                                                    window)
            t = report("flash_attention", f"{label} {shape}", fn, plain,
                       sdpa(q, k, v, causal, window), nbytes, flops, dt)
            if label in FLASH_PR16_MS:
                print(f"kernel flash_attention {label}: {t[0]:.4f} ms "
                      f"(PR 16: {FLASH_PR16_MS[label]} ms)", flush=True)
            if label == "prefill":
                results["flash_attention"]["times"] = t
        if label in own:
            row(own[label], err, t)
        del q, k, v

    # (label, B, T, H, K, hd): the cache [B,T,K,hd] read as it lies;
    # "G=1 long" is the long-context serve run's (one sequence, 8,256
    # slots), "tp decode" a rank's cache in the sharded serve phase
    clean = torch.empty_like(flush)
    for label, B, T, H, K, hd in (("G=1", 8, 1088, 16, 16, 64),
                                  ("G=4", 8, 1088, 32, 8, 128),
                                  ("G=8 jamba", 8, 1088, 64, 8, 128),
                                  ("G=1 long", 1, 8256, 16, 16, 64),
                                  ("cross", 32, 1500, 6, 6, 64),
                                  ("tp decode", TP_B, TP_S + TP_STEPS,
                                   16, 2, 128),
                                  ("fsdp serve decode", *FSDP_SERVE_RANK,
                                   16, 16, 64),
                                  ("fallback decode", *FALLBACK_RANK, 48, 8,
                                   128)):
        q = randn((B, H, hd), "bfloat16")
        kc, vc = (randn((B, T, K, hd), "bfloat16") for _ in range(2))
        k, v = kc.transpose(1, 2), vc.transpose(1, 2)
        for vl in (1, 600, T):
            fn = lambda: decode_gqa(q, k, v, vl)
            plain = lambda: decode_attention_ref(q, k, v, vl)
            got = fn()
            chosen = DK.decode_attention.last_split
            shape = (f"bf16 B={B} T={T} H={H} K={K} hd={hd} valid_len={vl} "
                     f"n_split={chosen}")
            err = check("decode_attention", shape, got, plain(), "bfloat16")
            if label in own:
                row(own[label], err, None)
            if vl != T:
                continue
            kx, vx = (x[:, :, :vl].repeat_interleave(H // K, 1).contiguous()
                      for x in (k, v))
            q4 = q[:, :, None].contiguous()
            library = lambda: F.scaled_dot_product_attention(q4, kx, vx)
            nbytes = 2 * (2 * B * H * hd + 2 * B * vl * K * hd)
            t = report("decode_attention", f"{label} {shape}", fn, plain,
                       library, nbytes, 4 * B * H * hd * vl, "bfloat16")
            print(f"kernel decode_attention {label} after a clean-L2 flush: "
                  f"kernel_ms={time_ms(torch, fn, flush, clean=clean):.4f} "
                  f"library_ms="
                  f"{time_ms(torch, library, flush, clean=clean):.4f}",
                  flush=True)
            if label == "G=1":
                results["decode_attention"]["times"] = t
            if label in own:
                row(own[label], 0.0, t)
            # every split of the bf16 route on this shape, each held
            # against plain (launches outside the main path)
            want, ms = plain(), {}
            for n in DK.SPLITS:
                check("decode_attention", f"{shape} forced n_split={n}",
                      DK.run_decode(q, k, v, vl, n), want, "bfloat16")
                ms[n] = time_ms(torch, lambda: DK.run_decode(q, k, v, vl, n),
                                flush)
            print(f"decode split sweep {label} B={B} valid_len={vl}: "
                  + " ".join(f"n_split={n} {t:.4f} ms" for n, t in
                             ms.items())
                  + f"; chosen {chosen}", flush=True)
        del q, kc, vc, k, v
    del clean
    return results


# flash backward phase: (label, dtype, B, S, T, H, K, hd, causal, window,
# timed): Qwen1.5-0.5B's train shape, GQA + window, MQA (granite-34b's
# 48 heads on one KV head), ragged S = T = 1,000 in bf16 and f32, and
# Whisper-tiny's train shapes: its encoder (32 clips of 1,500 frames,
# non-causal: 23 full 64-key tiles and a ragged one of 28) and its
# cross-attention (448 decoder queries over the 1,500 frames: dQ, dK and
# dV all ragged against their 64-row tiles)
BWD_CASES = [
    ("train", "bfloat16", 8, 1024, 1024, 16, 16, 64, True, 0, True),
    ("gqa+window", "bfloat16", 2, 2048, 2048, 32, 8, 128, True, 256, True),
    ("mqa", "bfloat16", 2, 1024, 1024, 48, 1, 128, True, 0, True),
    ("ragged", "bfloat16", 2, 1000, 1000, 16, 16, 64, True, 0, False),
    ("ragged", "float32", 2, 1000, 1000, 8, 2, 32, False, 0, False),
    ("whisper encoder", "bfloat16", 32, 1500, 1500, 6, 6, 64, False, 0,
     True),
    ("whisper cross", "bfloat16", 32, 448, 1500, 6, 6, 64, False, 0, True),
    ("fsdp rank", "bfloat16", 2, 1024, 1024, 16, 16, 64, True, 0, True)]
# backward shapes with a row of their own in the JSON line: label -> (row
# name, the key of `record_attention_shapes` whose launches the train
# phases make at that shape)
BWD_ROWS = {
    "whisper encoder": ("flash_attention_bwd encoder",
                        ("flash_attention_bwd", 1500, 1500, False)),
    "whisper cross": ("flash_attention_bwd cross",
                      ("flash_attention_bwd", 448, 1500, False))}


def _sdpa_bwd(torch, q, k, v, do, causal: bool, window: int):
    """The backward alone of `scaled_dot_product_attention` on its flash
    route (is_causal, enable_gqa) over the same inputs, or None where
    that route does not take the call (a window needs a mask; f32)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if window or q.dtype == torch.float32:
        return None
    qh, kh, vh = (x.detach().contiguous().requires_grad_() for x in (q, k, v))
    dh = do.contiguous()
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                                 enable_gqa=True)
    except RuntimeError:
        return None
    return lambda: torch.autograd.grad(out, (qh, kh, vh), dh,
                                       retain_graph=True)


def attention_bwd_phase(torch, np, flush, device: str = "cuda") -> dict:
    """`fa_flash_bwd` (`flash_attention_bwd`) on numpy-seeded inputs at
    `BWD_CASES`, in the model's layout, from the forward kernel's o and
    lse: held against `attention_bwd_ref` on the same inputs (bf16 within
    3e-2 of each gradient's max-abs, f32 within 2e-5), two launches
    bitwise equal, and the timed shapes timed beside the plain version,
    the bound (10·pairs·hd·B·H operations against the bytes of q, k, v,
    o, dO, dq, dk, dv) and SDPA's backward on its flash route.  Returns
    {"flash_attention_bwd": {"max_abs_err" (over every case), "times"
    (the train shape's)}} and, for each shape of BWD_ROWS and FSDP_ROWS,
    its row name with that case's {"max_abs_err", "times"}.  Off the card the
    wrapper is the plain version and nothing is timed."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks in f32
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    rng = np.random.default_rng(21)
    tol = {"bfloat16": 3e-2, "float32": 2e-5}
    res = {"max_abs_err": 0.0}
    out = {"flash_attention_bwd": res}
    for (label, dt, B, S, T, H, K, hd, causal, window, timed) in BWD_CASES:
        def arr(*shape):
            x = rng.standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(x).to(device, getattr(torch, dt))
        q, do = (arr(B, S, H, hd).transpose(1, 2) for _ in range(2))
        k, v = (arr(B, T, K, hd).transpose(1, 2) for _ in range(2))
        o, lse = FK.flash_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
        fn = lambda: FK.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, window=window)
        plain = lambda: attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                          window=window)
        got, again = fn(), fn()
        if on_card:
            torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {label} {dt}: two "
                                 "launches differ")
        ratios, case_err = [], 0.0
        for name, a, b in zip("qkv", got, plain()):
            a, b = a.float(), b.float()
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            if not torch.isfinite(a).all() or not err <= tol[dt] * scale:
                raise AssertionError(
                    f"flash_attention_bwd {label} {dt} d{name}: kernel != "
                    f"plain (max |d| {err:.4g}, max-abs {scale:.4g})")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            case_err = max(case_err, err)
            ratios.append(f"d{name} {err / scale:.3g}")
        shape = (f"{dt} B={B} S={S} T={T} H={H} K={K} hd={hd} causal={causal}"
                 f" window={window} route={FK.flash_attention_bwd.last_route}")
        print(f"kernel flash_attention_bwd {label} {shape}: within "
              f"{tol[dt]} of plain (max |d| / max-abs {', '.join(ratios)}), "
              "two launches bitwise equal", flush=True)
        row = BWD_ROWS[label][0] if label in BWD_ROWS else \
            FSDP_ROWS.get(label)
        if row:
            out[row] = {"max_abs_err": case_err}
        if timed and on_card:
            ms = time_ms(torch, fn, flush)
            plain_ms = time_ms(torch, plain, flush, reps=5)
            lib = _sdpa_bwd(torch, q, k, v, do, causal, window)
            library_ms = None if lib is None else time_ms(torch, lib, flush)
            nbytes = q.element_size() * 4 * (B * S * H * hd + B * T * K * hd)
            flops = 10 * B * H * hd * _visible_pairs(np, S, T, causal, window)
            bound_ms, by = _bound(nbytes, flops, dt)
            lib_txt = "null (no flash route)" if library_ms is None \
                else f"{library_ms:.4f}"
            print(f"kernel flash_attention_bwd {label}: kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
                  f"library_ms={lib_txt} ({nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP)", flush=True)
            if label == "train":
                res["times"] = (ms, plain_ms, bound_ms, library_ms, by)
            if row:
                out[row]["times"] = (ms, plain_ms, bound_ms, library_ms, by)
        del q, k, v, o, lse, do, got, again
    return out


# -------------------------------------------------------------- WKV kernel
def _clean_l2_time(torch, label, fn, flush) -> None:
    """Print `fn`'s time after a flush that leaves L2 clean (a decode
    step's state is cold but L2 holds few dirty lines in the serve path;
    the usual flush leaves it full of them, which the step's reads must
    write back first)."""
    clean = torch.empty_like(flush)
    print(f"kernel {label} after a clean-L2 flush: kernel_ms="
          f"{time_ms(torch, fn, flush, clean=clean):.4f}", flush=True)
    del clean


def _launch_txt(launch) -> str:
    """A scan wrapper's `last_route` as printed: route, grid x block, and
    how its operands move."""
    grid = " x ".join(str(g) for g in launch.grid)
    if launch.route == "reverse":
        return f"route reverse, grid {grid} of {launch.block} threads"
    return (f"route {launch.route}, grid {grid} of {launch.block} threads, "
            f"{'16-byte' if launch.vector else 'element'} "
            f"{'staging' if launch.route == 'chunked' else 'state access'}")


def _wkv_plain(r, k, v, w_log, u, s0=None, *, state_out=None):
    """`ops.wkv` on the plain version, on the tensors' own device: the
    model's [B,T,H,N] layout in and out, as the kernel path."""
    from repro_torch.kernels.wkv_scan.ref import wkv_scan_plain

    B, T, H, N = r.shape
    o, S = wkv_scan_plain(*(x.transpose(1, 2) for x in (r, k, v, w_log)),
                          u[None].expand(B, H, N), s0, state_out=state_out)
    return o.transpose(1, 2), S


def _wkv_cost(B: int, T: int, H: int, N: int, itemsize: int, s0: bool):
    """Bytes the scan must move (r, k, v, w_log read once, u, s0 when
    given, o and the final state written once) and its f32 operations:
    per step and head N^2 FMAs for o and N^2 mul+FMA for the state."""
    nbytes = (4 * B * T * H * N * itemsize + H * N * 4 + B * T * H * N * 4
              + (2 if s0 else 1) * B * H * N * N * 4)
    return nbytes, 5 * B * H * T * N * N


def wkv_kernel_phase(torch, np, flush) -> dict:
    """wkv_scan against its plain version on the card, in the model's
    layout as the RWKV serve path hands it (r/k/v/w_log [B,T,H,N], u
    [H,N]), timed beside its bound; `library_ms` is None: no one PyTorch
    call computes the WKV6 recurrence.  Prints the route and launch shape
    of every call (`wkv_scan.last_route`).  Returns {"max_abs_err",
    "times": (ms, plain, bound, None, by)} of the prefill shape (the
    chunked route) and "times_step", the same of the decode shape (the
    step route); the decode is also timed on the chunked route, forced,
    and printed beside it; "times_tp" and "times_tp_step" the same at one
    rank's shapes of the sharded serve phase's RWKV6-3B (`tp_wkv_shape`,
    rows `TP_WKV_ROWS`)."""
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ops import wkv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    res = {"max_abs_err": 0.0}
    tol = 1e-4

    def inputs(B, T, H, N, dtype, decay_scale):
        """Model layout.  "reference": the reference kernel test's scales
        (r, k 0.5 N(0,1), v N(0,1), decay exp(-exp(z - 2)), u 0.1 N(0,1));
        "rwkv6": RWKV6-3B's own (unit r/k/v, decay exp(-exp(-6 + z)) of
        w_base = -6, u 0.5 N(0,1))."""
        n = lambda: torch.randn((B, T, H, N), generator=g, device=dev)
        ref = decay_scale == "reference"
        s = 0.5 if ref else 1.0
        r, k, v = s * n(), s * n(), n()
        w_log = -torch.exp(n() - 2 if ref else n() - 6)
        u = (0.1 if ref else 0.5) * torch.randn((H, N), generator=g,
                                                device=dev)
        cast = getattr(torch, dtype)
        return [x.to(cast) for x in (r, k, v, w_log)] + [u]

    def check(label, got, want, normwise):
        torch.cuda.synchronize()
        seen = []
        for what, a, b in zip(("o", "S"), got, want):
            err = (a - b).abs()
            bound = tol * (1 + (b.abs().max() if normwise else b.abs()))
            if not torch.isfinite(a).all() or (err > bound).any():
                raise AssertionError(f"wkv_scan {label} {what}: kernel != "
                                     f"plain (max |d| {err.max().item()})")
            res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
            seen.append(f"{what} max |d| {err.max().item():.4g} (max "
                        f"|{what}| {b.abs().max().item():.4g})")
        print(f"kernel wkv_scan {label}: {', '.join(seen)}, held "
              f"{'norm-wise' if normwise else 'element-wise'}", flush=True)

    def report(label, fn, plain, cost):
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        nbytes, flops = cost
        bound_ms, by = _bound(nbytes, flops, "float32")
        print(f"kernel wkv_scan {label}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by}; "
              f"ops at the f32 peak outside the tensor cores "
              f"{flops / PEAK_FLOPS['float32'] * 1e3:.4f} ms) "
              f"library_ms=null (no PyTorch call computes the WKV6 "
              f"recurrence) ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
              f"GFLOP)", flush=True)
        return ms, plain_ms, bound_ms, None, by

    # (label, dtype, B, T, H, N, s0 given, decay scale, timed)
    cases = [("prefill", "float32", 8, 1024, 40, 64, False, "reference",
              True),
             ("prefill", "float32", 8, 1024, 40, 64, False, "rwkv6", False),
             ("ragged T", "float32", 2, 37, 8, 64, False, "rwkv6", False),
             ("N=32", "float32", 2, 300, 4, 32, False, "reference", False),
             ("bf16", "bfloat16", 2, 256, 8, 64, False, "reference", False),
             ("f16", "float16", 2, 100, 8, 64, True, "reference", False),
             ("s0", "float32", 2, 50, 8, 64, True, "reference", False)]
    for label, dt, B, T, H, N, with_s0, scale, timed in cases:
        r, k, v, w_log, u = inputs(B, T, H, N, dt, scale)
        s0 = torch.randn((B, H, N, N), generator=g, device=dev) \
            if with_s0 else None
        shape = (f"{dt} B={B} T={T} H={H} N={N} s0={with_s0} "
                 f"decay={scale}")
        got = wkv(r, k, v, w_log, u, s0)
        shape += f" [{_launch_txt(WK.wkv_scan.last_route)}]"
        check(f"{label} {shape}", got, _wkv_plain(r, k, v, w_log, u, s0),
              normwise=scale == "rwkv6")
        if timed:
            res["times"] = report(
                f"{label} {shape}", lambda: wkv(r, k, v, w_log, u),
                lambda: _wkv_plain(r, k, v, w_log, u),
                _wkv_cost(B, T, H, N, r.element_size(), False))
        elif label == "prefill":
            state = got[1]            # decode from the prompt's state
    # decode: one token from that state, read and written in place
    r, k, v, w_log, u = inputs(8, 1, 40, 64, "float32", "rwkv6")
    want = _wkv_plain(r, k, v, w_log, u, state)
    got = wkv(r, k, v, w_log, u, state, state_out=state)
    if got[1] is not state:
        raise AssertionError("wkv_scan decode: the state was not written "
                             "in place")
    route = _launch_txt(WK.wkv_scan.last_route)
    check(f"decode [{route}]", got, want, normwise=True)
    step = lambda: wkv(r, k, v, w_log, u, state, state_out=state)
    res["times_step"] = report(
        f"decode f32 B=8 T=1 H=40 N=64 s0=state_out (in place) [{route}]",
        step, lambda: _wkv_plain(r, k, v, w_log, u, state, state_out=state),
        _wkv_cost(8, 1, 40, 64, 4, True))
    _clean_l2_time(torch, "wkv_scan decode", step, flush)
    # the same step on the chunked route (forced), which takes any T >= 1:
    # the step route must be the faster to be worth its kernel
    bhtn = [x.transpose(1, 2) for x in (r, k, v, w_log)] + \
        [u[None].expand(8, 40, 64)]
    chunked = lambda: WK.wkv_scan(*bhtn, state, state_out=state,
                                  route="chunked")
    want = _wkv_plain(r, k, v, w_log, u, state)
    o, S = chunked()
    route = _launch_txt(WK.wkv_scan.last_route)
    check(f"decode [{route}]", (o.transpose(1, 2), S), want, normwise=True)
    ms = report(f"decode f32 B=8 T=1 H=40 N=64 s0=state_out (in place) "
                f"[{route}]", chunked,
                lambda: _wkv_plain(r, k, v, w_log, u, state,
                                   state_out=state),
                _wkv_cost(8, 1, 40, 64, 4, True))[0]
    print(f"kernel wkv_scan decode: step route {res['times_step'][0]:.4f} "
          f"ms, chunked route {ms:.4f} ms", flush=True)
    # one rank's share of the sharded serve phase's RWKV6-3B: the prefill
    # of its rows, then a step from its state, read and written in place
    s0 = None
    for key, T in (("times_tp", TP_S), ("times_tp_step", 1)):
        B, T, H, N = tp_wkv_shape(T)
        r, k, v, w_log, u = inputs(B, T, H, N, "float32", "rwkv6")
        want = _wkv_plain(r, k, v, w_log, u, s0)
        got = wkv(r, k, v, w_log, u, s0, state_out=s0)
        label = (f"tp rank f32 B={B} T={T} H={H} N={N} s0="
                 f"{'state_out (in place)' if s0 is not None else False} "
                 f"[{_launch_txt(WK.wkv_scan.last_route)}]")
        check(label, got, want, normwise=True)
        res[key] = report(
            label, lambda: wkv(r, k, v, w_log, u, s0, state_out=s0),
            lambda: _wkv_plain(r, k, v, w_log, u, s0, state_out=s0),
            _wkv_cost(B, T, H, N, 4, s0 is not None))
        s0 = got[1]
    print(f"kernel wkv_scan: {len(cases) + 4} shapes within {tol} of "
          f"plain, max |d| {res['max_abs_err']:.4g}", flush=True)
    return res


def tp_wkv_shape(T: int) -> tuple:
    """(B, T, H, N) of one rank's `wkv_scan` in the sharded serve phase
    of RWKV6-3B: its rows of the batch over "data" (TP_MESHES), every
    head (the layout keeps the time mix whole)."""
    from repro_torch.configs import get_config

    cfg = get_config("rwkv6-3b")
    return (TP_B // TP_MESHES[cfg.name][0], T,
            cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim)


# -------------------------------------------------------------- SSM kernel
def _ssm_cost(Bb: int, T: int, Di: int, N: int, u_size: int, h0: bool):
    """Bytes the scan must move (u and dt read once, y written once, B
    and C read once, A and D, h0 when given, the final state written) and
    its f32 operations: 8 per (b, t, d, n) (dt·A, the exponential, the
    decay's product and the input's product and sum, C's product and
    sum) and 3 per (b, t, d) (dt·u, D·u and its sum)."""
    nbytes = (Bb * T * Di * (u_size + 4 + 4) + 2 * Bb * T * N * 4
              + Di * N * 4 + Di * 4 + (2 if h0 else 1) * Bb * Di * N * 4)
    return nbytes, 8 * Bb * T * Di * N + 3 * Bb * T * Di


def tp_ssm_shape(T: int) -> tuple:
    """(Bb, T, Di, N) of one rank's `ssm_scan` in the sharded serve phase
    of Jamba-1.5-Large: its rows of the batch over "data", its share of
    `d_inner` over "model" (TP_MESH), the state size."""
    from repro_torch.configs import get_config

    cfg = get_config(TP_ARCHS[1])
    return (TP_B // TP_MESH[0], T, cfg.mamba_d_inner // TP_MESH[1],
            cfg.mamba_d_state)


def ssm_kernel_phase(torch, np, flush) -> dict:
    """ssm_scan against its plain version on the card, in the model's
    layout as the Mamba layers hand it (u, dt [Bb,T,Di]; B, C [Bb,T,N]),
    timed beside its bound; `library_ms` is None: no one PyTorch call
    computes the selective scan.  Element-wise rtol = atol = 2e-4, the
    reference's tolerance for its kernel.  Prints the route and launch
    shape of every call (`ssm_scan.last_route`).  Times the prefill at
    Jamba's scales and at the reference test's (A = -exp(z): the time
    must not rest on A's initial values) and the decode with f32 and
    bf16 u (bf16 is what Jamba's serve path passes).  Returns
    {"max_abs_err", "times": (ms, plain, bound, None, by)} of the prefill
    at Jamba's scales (the chunked route) and "times_step", the same of
    the bf16-u decode (the step route); that decode is also timed on the
    chunked route, forced, and printed beside it.  Then one rank's
    shape of the sharded serve phase's Jamba (`tp_ssm_shape`, bf16 u as
    its layers pass it): "times_tp" the prefill, "times_tp_step" a
    decode step from its state (rows TP_SSM_ROWS)."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    res = {"max_abs_err": 0.0}
    tol = 2e-4
    F = torch.nn.functional

    def inputs(Bb, T, Di, N, u_dtype, scale):
        """"jamba": Jamba's own scales (dt = softplus(z) of its zero
        dt_bias, A = -(1..N) as A_log is initialised, D = 1, unit u, B,
        C); "reference": the reference kernel test's (dt = softplus(z -
        1), A = -exp(z), D = z)."""
        z = lambda *shape: torch.randn(shape, generator=g, device=dev)
        u, B, C = z(Bb, T, Di), z(Bb, T, N), z(Bb, T, N)
        if scale == "jamba":
            dt = F.softplus(z(Bb, T, Di))
            A = -torch.arange(1, N + 1, device=dev,
                              dtype=torch.float32).expand(Di, N).contiguous()
            D = torch.ones(Di, device=dev)
        else:
            dt = F.softplus(z(Bb, T, Di) - 1)
            A, D = -torch.exp(z(Di, N)), z(Di)
        return u.to(getattr(torch, u_dtype)), dt, B, C, A, D

    def check(label, got, want):
        torch.cuda.synchronize()
        seen = []
        for what, a, b in zip(("y", "h"), got, want):
            err = (a - b).abs()
            if not torch.isfinite(a).all() or \
                    (err > tol * (1 + b.abs())).any():
                raise AssertionError(f"ssm_scan {label} {what}: kernel != "
                                     f"plain (max |d| {err.max().item()})")
            res["max_abs_err"] = max(res["max_abs_err"], err.max().item())
            seen.append(f"{what} max |d| {err.max().item():.4g} (max "
                        f"|{what}| {b.abs().max().item():.4g})")
        print(f"kernel ssm_scan {label}: {', '.join(seen)}", flush=True)

    def report(label, fn, plain, cost, n_exp):
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, reps=5)
        nbytes, flops = cost
        bound_ms, by = _bound(nbytes, flops, "float32")
        print(f"kernel ssm_scan {label}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by}; "
              f"ops at the f32 peak {flops / PEAK_FLOPS['float32'] * 1e3:.4f}"
              f" ms; {n_exp / 1e9:.3f} G exponentials on the SFU "
              f"{n_exp / SFU_PER_S * 1e3:.4f} ms) library_ms=null (no "
              f"PyTorch call computes the selective scan) ({nbytes / 1e6:.1f}"
              f" MB, {flops / 1e9:.2f} GFLOP)", flush=True)
        return ms, plain_ms, bound_ms, None, by

    # (label, u dtype, Bb, T, Di, N, h0 given, scale, timed)
    cases = [("prefill", "float32", 8, 1024, 16384, 16, False, "jamba", True),
             ("prefill", "float32", 8, 1024, 16384, 16, False, "reference",
              True),
             ("ragged T", "float32", 2, 37, 4096, 16, False, "jamba", False),
             ("ragged Di", "float32", 2, 100, 1000, 16, False, "reference",
              False),
             ("N=8", "float32", 2, 200, 2048, 8, False, "reference", False),
             ("bf16 u", "bfloat16", 2, 256, 4096, 16, False, "jamba", False),
             ("h0", "float32", 2, 50, 4096, 16, True, "reference", False),
             ("reference test", "float32", 2, 64, 128, 8, False, "reference",
              False),
             ("reference test", "float32", 1, 128, 256, 16, False,
              "reference", False)]
    for label, dt_, Bb, T, Di, N, with_h0, scale, timed in cases:
        u, dt, B, C, A, D = inputs(Bb, T, Di, N, dt_, scale)
        h0 = torch.randn((Bb, Di, N), generator=g, device=dev) \
            if with_h0 else None
        shape = (f"{dt_} u, Bb={Bb} T={T} Di={Di} N={N} h0={with_h0} "
                 f"scale={scale}")
        got = selective_scan(u, dt, B, C, A, D, h0)
        shape += f" [{_launch_txt(SK.ssm_scan.last_route)}]"
        check(f"{label} {shape}", got, ssm_scan_ref(u, dt, B, C, A, D, h0))
        if timed:
            times = report(
                f"{label} {shape}",
                lambda: selective_scan(u, dt, B, C, A, D),
                lambda: ssm_scan_ref(u, dt, B, C, A, D),
                _ssm_cost(Bb, T, Di, N, u.element_size(), False),
                Bb * T * Di * N)
            if scale == "jamba":
                res["times"] = times
                state = got[1]        # decode from the prompt's state
    # decode: one token from that state, read and written in place, with
    # f32 u and then bf16 u (the served case)
    for u_dtype in ("float32", "bfloat16"):
        u, dt, B, C, A, D = inputs(8, 1, 16384, 16, u_dtype, "jamba")
        want = ssm_scan_ref(u, dt, B, C, A, D, state)
        got = selective_scan(u, dt, B, C, A, D, state, state_out=state)
        if got[1] is not state:
            raise AssertionError("ssm_scan decode: the state was not "
                                 "written in place")
        label = (f"decode {u_dtype} u, Bb=8 T=1 Di=16384 N=16 h0=state_out "
                 f"(in place) [{_launch_txt(SK.ssm_scan.last_route)}]")
        check(label, got, want)
        step = lambda: selective_scan(u, dt, B, C, A, D, state,
                                      state_out=state)
        res["times_step"] = report(
            label, step,
            lambda: ssm_scan_ref(u, dt, B, C, A, D, state, state_out=state),
            _ssm_cost(8, 1, 16384, 16, u.element_size(), True),
            8 * 16384 * 16)
        _clean_l2_time(torch, f"ssm_scan decode {u_dtype} u", step, flush)
    # the served step on the chunked route (forced), which takes any
    # T >= 1: the step route must be the faster to be worth its kernel
    chunked = lambda: SK.ssm_scan(u, dt, B, C, A, D, state, state_out=state,
                                  route="chunked")
    want = ssm_scan_ref(u, dt, B, C, A, D, state)
    got = chunked()
    label = (f"decode {u_dtype} u, Bb=8 T=1 Di=16384 N=16 h0=state_out "
             f"(in place) [{_launch_txt(SK.ssm_scan.last_route)}]")
    check(label, got, want)
    ms = report(label, chunked,
                lambda: ssm_scan_ref(u, dt, B, C, A, D, state,
                                     state_out=state),
                _ssm_cost(8, 1, 16384, 16, u.element_size(), True),
                8 * 16384 * 16)[0]
    print(f"kernel ssm_scan decode {u_dtype} u: step route "
          f"{res['times_step'][0]:.4f} ms, chunked route {ms:.4f} ms",
          flush=True)
    # one rank's share of the sharded serve phase's Jamba: the prefill,
    # then a step from its state, read and written in place
    h = None
    for key, T in (("times_tp", TP_S), ("times_tp_step", 1)):
        Bb, T, Di, N = tp_ssm_shape(T)
        args = inputs(Bb, T, Di, N, "bfloat16", "jamba")
        want = ssm_scan_ref(*args, h)
        got = selective_scan(*args, h, state_out=h)
        label = (f"tp rank bfloat16 u, Bb={Bb} T={T} Di={Di} N={N} "
                 f"h0={'state_out (in place)' if h is not None else False} "
                 f"[{_launch_txt(SK.ssm_scan.last_route)}]")
        check(label, got, want)
        res[key] = report(
            label, lambda: selective_scan(*args, h, state_out=h),
            lambda: ssm_scan_ref(*args, h, state_out=h),
            _ssm_cost(Bb, T, Di, N, 2, h is not None), Bb * T * Di * N)
        h = got[1]
    print(f"kernel ssm_scan: {len(cases) + 5} shapes within {tol} of "
          f"plain, max |d| {res['max_abs_err']:.4g}", flush=True)
    return res


# --------------------------------------------------------- scan backwards
def _wkv_bwd_cost(B: int, T: int, H: int, N: int, itemsize: int):
    """Bytes the WKV backward must move (r, k, v, w_log and dO read once,
    the forward's chunk states and u, the four gradients written once,
    du) and its f32 operations: per step and head S^T dO, G v and G^T k
    (N^2 FMAs each) and G advanced (N^2 mul + FMA), 9 N^2 flops.  Not
    counted, so that the bound stays the least work and does not move
    with the kernel's design: what the kernel does beyond it (the state
    recomputed from the saved states with the segment's state from zero
    beside it, 6 N^2 flops a step, and the adjoint run twice, from zero
    and then from its true value, in f64), its further reads of the
    inputs and its ~300 MB of scratch (a, the jumps, e, gin)."""
    elems = B * T * H * N
    nbytes = (elems * (4 * itemsize + 4 + 4 * itemsize)
              + B * H * -(-T // 64) * N * N * 4 + 2 * H * N * 4)
    return nbytes, 9 * B * H * T * N * N


def _ssm_bwd_cost(Bb: int, T: int, Di: int, N: int, u_size: int):
    """Bytes the selective scan's backward must move (u, dt, dy read once,
    B, C, A, D, the forward's chunk states; du, ddt, dB, dC, dA, dD
    written once), its f32 operations, 17 per (b, t, d, n) (the adjoint's
    FMA, the dB and dC products, ddt's two products and two FMAs, du's
    FMA, dA's product and FMA, the carry's product, the decay's argument
    and its product with h_{t-1}; the state's recompute not counted), and
    its exponentials, one per (b, t, d, n)."""
    elems = Bb * T * Di
    nbytes = (elems * (2 * u_size + 4 + 4 + 4) + 4 * Bb * T * N * 4
              + 2 * Di * N * 4 + 2 * Di * 4
              + Bb * -(-T // 8) * Di * N * 4)
    return nbytes, 17 * elems * N, elems * N


def _kernel_split(torch, fn, calls: int = 5) -> dict:
    """Device time in us of one `fn()` call by kernel name (all launches
    of a name summed), from a torch.profiler trace of `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.sub(r"^void |\(anonymous namespace\)::|[<(].*$", "", e.key):
            e.self_device_time_total / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


def _grads_close(torch, label, got, want, names, tol, tol16=None):
    """Each gradient within `tol` of its max-abs (a 16-bit one within
    `tol16`: both sides round it to its type); returns the largest
    |d| over them."""
    worst, seen = 0.0, []
    for name, a, b in zip(names, got, want):
        if b is None:
            continue
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        ratio = err / max(b.abs().max().item(), 1e-30)
        t = tol16 if tol16 is not None and got[names.index(name)].dtype \
            != torch.float32 else tol
        if not (torch.isfinite(a).all() and ratio <= t):
            raise AssertionError(f"{label} {name}: kernel != plain (max |d| "
                                 f"/ max = {ratio:.3g} > {t})")
        worst = max(worst, err)
        seen.append(f"{name} {ratio:.3g}")
    print(f"{label}: max |d| / max per gradient {', '.join(seen)}",
          flush=True)
    return worst


def scan_bwd_phase(torch, np, flush) -> dict:
    """The two scan backward kernels, `wkv_scan_bwd` and `ssm_scan_bwd`,
    on numpy-seeded inputs at the train phase's shapes (RWKV6-3B: f32
    r/k/v/w_log B = TRAIN_BATCH x 1,024 x 40 x 64 from the forward
    kernel's chunk states, at the reference test's decays and at
    RWKV6-3B's own; Jamba's Mamba layer: one microbatch, bf16 u, 1 x
    1,024 x 16,384 x 16 at Jamba's scales), against the plain backwards
    on the same inputs (each gradient within 1e-4 of its max-abs; bf16
    du within that plus one bf16 step, 2^-7), two launches bitwise equal,
    timed beside plain and the bound (bytes at 3.35 TB/s; f32 operations
    at 67 TFLOP/s and exponentials on the SFU); `library_ms` None: no
    PyTorch call computes either.  The SSM backward's device time is also
    split by kernel (the reverse scan, the sums of its partials) from a
    profiler trace.  Returns {"wkv_scan bwd": {...}, "ssm_scan bwd":
    {...}}, each {"max_abs_err", "times"}."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan.ref import wkv_scan_bwd_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    put = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to(dev)
    res = {}
    B, T, H, N = TRAIN_BATCH.get("rwkv6-3b", TRAIN_B), TRAIN_S, 40, 64
    names = ("dr", "dk", "dv", "dw_log", "du")
    res["wkv_scan bwd"] = {"max_abs_err": 0.0}
    for scale in ("reference", "rwkv6"):
        ref = scale == "reference"
        s = 0.5 if ref else 1.0
        x = [(s * put(B, T, H, N)).transpose(1, 2) for _ in range(2)]
        x.append(put(B, T, H, N).transpose(1, 2))
        x.append((-torch.exp(put(B, T, H, N) - (2 if ref else 6)))
                 .transpose(1, 2))
        u = ((0.1 if ref else 0.5) * put(H, N))[None].expand(B, H, N)
        _, _, states = WK.wkv_scan(*x, u, return_states=True)
        do = put(B, T, H, N).transpose(1, 2)
        call = lambda: WK.wkv_scan_bwd(*x, u, do, None, None, states)
        got, again = call(), call()
        label = (f"kernel wkv_scan bwd f32 B={B} T={T} H={H} N={N} "
                 f"decay={scale} [{_launch_txt(WK.wkv_scan_bwd.last_route)}"
                 "]")
        if not all(torch.equal(a, b) for a, b in zip(got[:5], again[:5])):
            raise AssertionError("wkv_scan bwd: two launches differ")
        want = wkv_scan_bwd_ref(*x, u, do, None, None, states)
        err = _grads_close(torch, label + ", two launches bitwise equal",
                           got, want, names, 1e-4)
        res["wkv_scan bwd"]["max_abs_err"] = max(
            res["wkv_scan bwd"]["max_abs_err"], err)
        if ref:
            ms = time_ms(torch, call, flush)
            plain_ms = time_ms(torch, lambda: wkv_scan_bwd_ref(
                *x, u, do, None, None, states), flush, reps=3)
            nbytes, flops = _wkv_bwd_cost(B, T, H, N, 4)
            bound_ms, by = _bound(nbytes, flops, "float32")
            print(f"{label}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({by}; {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP) library_ms=null (no PyTorch "
                  "call computes the WKV6 backward)", flush=True)
            res["wkv_scan bwd"]["times"] = (ms, plain_ms, bound_ms, None, by)
        del x, u, states, do, got, again, want
    Bb, Di, Ns = 1, 16384, 16
    F = torch.nn.functional
    u = put(Bb, T, Di).to(torch.bfloat16)
    dt = F.softplus(put(Bb, T, Di))
    Bm, C = put(Bb, T, Ns), put(Bb, T, Ns)
    A = -torch.arange(1, Ns + 1, device=dev,
                      dtype=torch.float32).expand(Di, Ns).contiguous()
    D = torch.ones(Di, device=dev)
    _, _, states = SK.ssm_scan(u, dt, Bm, C, A, D, return_states=True)
    dy = put(Bb, T, Di)
    call = lambda: SK.ssm_scan_bwd(u, dt, Bm, C, A, D, dy, None, None,
                                   states)
    got, again = call(), call()
    if not all(torch.equal(a, b) for a, b in zip(got[:6], again[:6])):
        raise AssertionError("ssm_scan bwd: two launches differ")
    label = (f"kernel ssm_scan bwd bf16 u Bb={Bb} T={T} Di={Di} N={Ns} "
             f"scale=jamba [{_launch_txt(SK.ssm_scan_bwd.last_route)}]")
    want = ssm_scan_bwd_ref(u, dt, Bm, C, A, D, dy, None, None, states)
    err = _grads_close(torch, label + ", two launches bitwise equal", got,
                       want, ("du", "ddt", "dB", "dC", "dA", "dD"), 1e-4,
                       1e-4 + 2 ** -7)
    ms = time_ms(torch, call, flush)
    plain_ms = time_ms(torch, lambda: ssm_scan_bwd_ref(
        u, dt, Bm, C, A, D, dy, None, None, states), flush, reps=3)
    nbytes, flops, n_exp = _ssm_bwd_cost(Bb, T, Di, Ns, 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_FLOPS["float32"], n_exp / SFU_PER_S) * 1e3
    bound_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops \
        else (t_ops, "operations")
    print(f"{label}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({by}; {nbytes / 1e6:.1f} MB "
          f"{t_bytes:.4f} ms, {flops / 1e9:.2f} GFLOP "
          f"{flops / PEAK_FLOPS['float32'] * 1e3:.4f} ms, {n_exp / 1e9:.3f} "
          f"G exponentials {n_exp / SFU_PER_S * 1e3:.4f} ms) "
          "library_ms=null (no PyTorch call computes the selective scan's "
          "backward)", flush=True)
    print(f"{label}: device time by kernel "
          + ", ".join(f"{name} {us / 1e3:.4f} ms" for name, us in
                      _kernel_split(torch, call).items()), flush=True)
    res["ssm_scan bwd"] = {"max_abs_err": err,
                           "times": (ms, plain_ms, bound_ms, None, by)}
    return res


# ------------------------------------------------------------------ serving
@contextlib.contextmanager
def plain_attention():
    """Inside the block, the layers' attention runs on the plain PyTorch
    versions (the chunked online softmax over PLAIN_CHUNK keys at a time,
    and `decode_attention_ref`) on the tensors' own device: the plain
    path that check (a) holds the kernels against."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models import layers

    saved = layers.attention_bshd, layers.decode_gqa
    layers.attention_bshd = lambda q, k, v, *, causal, window: \
        layers.flash_attention_chunked(q, k, v, causal=causal, window=window,
                                       chunk=PLAIN_CHUNK)
    layers.decode_gqa = decode_attention_ref
    try:
        yield
    finally:
        layers.attention_bshd, layers.decode_gqa = saved


@contextlib.contextmanager
def plain_wkv():
    """Inside the block, the layers' WKV runs on the plain version
    (`wkv_scan_ref`) on the tensors' own device: with `plain_attention`,
    the plain path that check (a) holds the kernels against."""
    from repro_torch.models import layers

    saved = layers.wkv
    layers.wkv = _wkv_plain
    try:
        yield
    finally:
        layers.wkv = saved


@contextlib.contextmanager
def plain_ssm():
    """Inside the block, the layers' selective scan runs on the plain
    version (`ssm_scan_ref`) on the tensors' own device: with
    `plain_attention` and `plain_wkv`, the plain path of check (a)."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import layers

    saved = layers.selective_scan
    layers.selective_scan = ssm_scan_ref
    try:
        yield
    finally:
        layers.selective_scan = saved


@contextlib.contextmanager
def record_routing():
    """Inside the block, the experts every `layers.moe_route` call
    chooses (gate_idx [B,S,K]) are appended, in call order, to the
    yielded list."""
    from repro_torch.models import layers

    route, calls = layers.moe_route, []

    def recorded(p, x, cfg, **kw):
        out = route(p, x, cfg, **kw)
        calls.append(out[1])
        return out

    layers.moe_route = recorded
    try:
        yield calls
    finally:
        layers.moe_route = route


@contextlib.contextmanager
def replay_routing(torch, calls):
    """Inside the block, the i-th `layers.moe_route` call takes the
    experts calls[i] instead of its own top-k: its own router's softmax
    at those experts, renormalised, and its own slots for them.  A
    routing decision on a near tie can flip between two paths that round
    differently, and then moves the rest of the model by a whole expert;
    the replay keeps the comparison on the kernels.  Yields a dict whose
    "differ" (read after the block) counts the choices where a call's own
    top-k differed from the replayed one.  `calls` None: no replay."""
    from repro_torch.models import layers

    stats = {"calls": 0, "differ": 0}
    if calls is None:
        yield stats
        return
    route = layers.moe_route

    def replayed(p, x, cfg, *, capacity_factor=0.0):
        _, own, _ = route(p, x, cfg, capacity_factor=capacity_factor)
        idx = calls[stats["calls"]]
        stats["calls"] += 1
        stats["differ"] = stats["differ"] + (own != idx).sum()
        vals = torch.softmax(x.float() @ p["router"], -1).gather(-1, idx)
        vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
        C = layers.moe_capacity(cfg, x.shape[1], capacity_factor)
        return vals, idx, layers.moe_slots(idx, cfg.n_experts, C)

    layers.moe_route = replayed
    try:
        yield stats
    finally:
        layers.moe_route = route
    if stats["calls"] != len(calls):
        raise AssertionError(f"replayed {stats['calls']} of {len(calls)} "
                             "MoE calls")
    stats["differ"] = int(stats["differ"])


def _logits_close(torch, what: str, got, want, rel) -> float:
    """max |got - want| <= rel * max |want| (no bound when `rel` is None);
    raises on non-finite logits.  Returns the ratio."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits")
    ratio = ((got - want).abs().max() / want.abs().max()).item()
    if rel is not None and not ratio <= rel:
        raise AssertionError(f"{what}: max |d| / max |logit| = {ratio:.4g}"
                             f" > {rel}")
    return ratio


def _teacher_forced(cfg, params, batch, toks, S: int, N: int) -> list:
    """Logits of a prefill of `batch` (its tokens, the prompts, and any
    frontend inputs) and N decode steps fed `toks` (a request replayed
    with its own tokens)."""
    from repro_torch.models import decode_step, prefill

    logits, cache = prefill(params, cfg, batch, cache_len=S + N)
    out = [logits]
    for k in range(N):
        logits, cache = decode_step(params, cfg, toks[:, k:k + 1], cache,
                                    S + k)
        out.append(logits)
    return out


def _whole(torch, batch, toks, b: int) -> dict:
    """Prompt b's batch over the whole sequence (`forward`'s input): its
    tokens followed by `toks`, its frontend inputs, and for M-RoPE its
    positions followed by the decode steps' (pos, pos, pos) (the decode
    rotates the token at position pos on all three streams)."""
    S, N = batch["tokens"].shape[1], toks.shape[1]
    out = {"tokens": torch.cat([batch["tokens"][b:b + 1], toks[b:b + 1]],
                               dim=1)}
    for k in ("enc_embeds", "vision_embeds"):
        if k in batch:
            out[k] = batch[k][b:b + 1]
    if "mrope_positions" in batch:
        pos = batch["mrope_positions"]
        dec = torch.arange(S, S + N, device=pos.device, dtype=pos.dtype)
        out["mrope_positions"] = torch.cat(
            [pos[:, b:b + 1], dec.expand(3, 1, N)], dim=2)
    return out


def _check_a(torch, cfg, params, batch, toks, logits, S, N, rel,
             routing=None) -> tuple[float, int]:
    """(a): a request's logits against the plain path's on the same
    params, teacher-forced with the request's tokens (and, for a MoE
    model, the request's recorded `routing` replayed).  Returns the worst
    ratio and the routing decisions the plain path would have flipped."""
    with plain_attention(), plain_wkv(), plain_ssm(), \
            replay_routing(torch, routing) as st:
        want = _teacher_forced(cfg, params, batch, toks, S, N)
    return max(_logits_close(torch, f"(a) step {k}", got, w, rel)
               for k, (got, w) in enumerate(zip(logits, want))), \
        st["differ"]


def _check_b(torch, cfg, params, batch, toks, logits, S, N, rel,
             routing=None) -> tuple[float, int]:
    """(b): prefill + decode logits against `forward` over the whole
    sequence, one prompt at a time, so [B, S + N, V] logits are never
    held at once (each prompt's [S + N, V] slice compared alone).  For a
    MoE model, `routing` holds each MoE layer's
    recorded choices over the whole sequence ([B, S + N, K]), replayed
    into the forward.  Returns the worst ratio and the routing decisions
    the forward would have flipped."""
    from repro_torch.models import forward

    got = torch.stack(logits, dim=1)                   # [B, N + 1, V]
    worst, differ = 0.0, 0
    for b in range(got.shape[0]):
        calls = None if routing is None else [c[b:b + 1] for c in routing]
        with replay_routing(torch, calls) as st:
            fwd = forward(params, cfg, _whole(torch, batch, toks, b))[
                0, S - 1:S + N]
        differ += st["differ"]
        worst = max(worst, _logits_close(torch, f"(b) prompt {b}", got[b],
                                         fwd, rel))
    return worst, differ


def _n_layers(cfg, **spec) -> int:
    """Layers whose LayerSpec has the given fields (e.g. mixer="attn")."""
    return cfg.n_periods * sum(all(getattr(s, k) == v
                                   for k, v in spec.items())
                               for s in cfg.pattern)


def _check_b_dropfree(torch, cfg, params, batch, toks, S, N, rel):
    """(b) for a MoE model.  Its capacity depends on the sequence length
    (at 1.25: 160 slots per expert for the 1,024-token prefill, 170 for
    the 1,088-token forward, 1 in a decode step), so at the configured
    factor prefill + decode drops choices the forward keeps, in the
    reference as here.  So (b) runs both at capacity factor 8.0, where
    nothing is dropped (the reference's smoke configs' "decode/prefill ==
    forward" setting): a teacher-forced replay of the request on the
    kernel path records its routing, and the forward replays it."""
    cfg8 = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    with record_routing() as calls:
        logits = _teacher_forced(cfg8, params, batch, toks, S, N)
    n_moe = _n_layers(cfg, mlp="moe")
    if len(calls) != n_moe * (N + 1):
        raise AssertionError(f"{len(calls)} MoE calls, expected "
                             f"{n_moe * (N + 1)}")
    per_layer = [torch.cat([calls[layer]] + [calls[n_moe * (1 + k) + layer]
                                             for k in range(N)], dim=1)
                 for layer in range(n_moe)]
    del calls
    return _check_b(torch, cfg8, params, batch, toks, logits, S, N, rel,
                    per_layer)


def _wkv_checks(torch, cfg, params, batch, toks, S: int, N: int) -> str:
    """RWKV6's checks of the kernel in its path, where the bf16 logits
    cannot hold it at 3e-2 (the model's 32 bf16 layers turn f32-level
    differences of the WKV output into ~8% of the logits' max-abs):
    (a) per launch: every `wkv_scan` launch of a teacher-forced replay
    of request 1 against the plain version on the same inputs, o and S
    within 1e-4 of their max-abs; (a) and (b) end to end on the same
    weights widened to f32, within 1e-3 of the logits' max-abs; and the
    bf16 model's own noise floor: its plain prefill against itself with
    every layer's WKV output times (1 + 1e-6 z).  Returns the report."""
    from repro_torch.models import layers
    from repro_torch.tree import tree_map

    with checked_wkv(torch) as scans:
        _teacher_forced(cfg, params, batch, toks, S, N)
    worst = scans["worst"]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda x: x.float(), params)
    got = _teacher_forced(cfg32, p32, batch, toks, S, N)
    a32 = _check_a(torch, cfg32, p32, batch, toks, got, S, N, 1e-3)[0]
    b32 = _check_b(torch, cfg32, p32, batch, toks, got, S, N, 1e-3)[0]
    del p32, got
    g = torch.Generator(device=batch["tokens"].device)
    g.manual_seed(5)

    def noisy(r, k, v, w_log, u, s0=None, *, state_out=None):
        o, S_ = _wkv_plain(r, k, v, w_log, u, s0, state_out=state_out)
        z = torch.randn(o.shape, generator=g, device=o.device)
        return o * (1 + 1e-6 * z), S_

    with plain_wkv():
        plain = _teacher_forced(cfg, params, batch, toks, S, 0)[0]
        layers.wkv = noisy
        perturbed = _teacher_forced(cfg, params, batch, toks, S, 0)[0]
    floor = _logits_close(torch, "noise floor", perturbed, plain, None)
    return (f"bf16 noise floor (plain prefill vs itself with its WKV output "
            f"x (1 + 1e-6 z)) {floor:.3g}; (a) per wkv_scan launch max |d| "
            f"/ max {worst:.3g} (<= 1e-4); f32 end to end (a) {a32:.3g}, "
            f"(b) {b32:.3g} (<= 1e-3)")


@contextlib.contextmanager
def checked_wkv(torch):
    """Inside the block, every `layers.wkv` launch is held against the
    plain version (`_wkv_plain`) on the same inputs, taken before s0 is
    written: o and S within 1e-4 of their max-abs.  Yields a dict whose
    "n" and "worst" (read after the block) are the launches checked and
    the worst ratio."""
    from repro_torch.models import layers

    kernel_wkv, stats = layers.wkv, {"n": 0, "worst": 0.0}

    def checked(r, k, v, w_log, u, s0=None, *, state_out=None):
        want = _wkv_plain(r, k, v, w_log, u, s0)  # before s0 is written
        got = kernel_wkv(r, k, v, w_log, u, s0, state_out=state_out)
        for what, a, b in zip(("o", "S"), got, want):
            ratio = ((a - b).abs().max() / b.abs().max()).item()
            if not ratio <= 1e-4:
                raise AssertionError(f"wkv_scan launch {stats['n']}, {what}"
                                     f": max |d| / max = {ratio:.4g} > 1e-4")
            stats["worst"] = max(stats["worst"], ratio)
        stats["n"] += 1
        return got

    layers.wkv = checked
    try:
        yield stats
    finally:
        layers.wkv = kernel_wkv


@contextlib.contextmanager
def checked_ssm(torch):
    """Inside the block, every `layers.selective_scan` launch is held
    against the plain version (`ssm_scan_ref`) on the same inputs, taken
    before h0 is written: y and h within 1e-4 of their max-abs.  Yields
    a dict whose "n" and "worst" (read after the block) are the launches
    checked and the worst ratio."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import layers

    kernel_scan, stats = layers.selective_scan, {"n": 0, "worst": 0.0}

    def checked(u, dt, B, C, A, D, h0=None, *, state_out=None):
        want = ssm_scan_ref(u, dt, B, C, A, D, h0)   # before h0 is written
        got = kernel_scan(u, dt, B, C, A, D, h0, state_out=state_out)
        for what, a, b in zip(("y", "h"), got, want):
            ratio = ((a - b).abs().max() / b.abs().max()).item()
            if not ratio <= 1e-4:
                raise AssertionError(f"ssm_scan launch {stats['n']}, {what}"
                                     f": max |d| / max = {ratio:.4g} > 1e-4")
            stats["worst"] = max(stats["worst"], ratio)
        stats["n"] += 1
        return got

    layers.selective_scan = checked
    try:
        yield stats
    finally:
        layers.selective_scan = kernel_scan


def _ssm_noise_floor(torch, cfg, params, batch, S: int, routing) -> float:
    """The bf16 Mamba model's own noise floor: its plain prefill (plain
    attention and selective scan, the prefill's recorded MoE `routing`
    replayed) against itself with every SSM output times (1 + 1e-6 z),
    z standard normal from a seeded generator: what f32-level
    differences of the scan's output do to the logits."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models import layers

    g = torch.Generator(device=batch["tokens"].device)
    g.manual_seed(5)

    def noisy(u, dt, B, C, A, D, h0=None, *, state_out=None):
        y, h = ssm_scan_ref(u, dt, B, C, A, D, h0, state_out=state_out)
        z = torch.randn(y.shape, generator=g, device=y.device)
        return y * (1 + 1e-6 * z), h

    n_pre = _n_layers(cfg, mlp="moe")            # the prefill's MoE calls
    with plain_attention(), plain_ssm():
        with replay_routing(torch, routing[:n_pre]):
            plain = _teacher_forced(cfg, params, batch, None, S, 0)[0]
        layers.selective_scan = noisy
        with replay_routing(torch, routing[:n_pre]):
            perturbed = _teacher_forced(cfg, params, batch, None, S, 0)[0]
    return _logits_close(torch, "noise floor", perturbed, plain, None)


def _ssm_checks(torch, cfg, params, batch, toks, S: int, N: int,
                routing) -> str:
    """Jamba's further checks of the kernel in its path: (a) per launch:
    every `ssm_scan` launch of a teacher-forced replay of request 1 (its
    routing replayed) against the plain version on the same inputs, y
    and h within 1e-4 of their max-abs (`checked_ssm`); the bf16 model's
    own noise floor (`_ssm_noise_floor`); and one full-width Mamba block
    in f32 (the layer of period 0, position 0, on the prompts'
    embeddings: a prefill and 4 decode steps) through the kernel and the
    plain path, within 1e-3 of the output's max-abs.  A whole f32 copy
    of the period (104 GB) does not fit the card.  Returns the report."""
    with checked_ssm(torch) as st, replay_routing(torch, routing):
        _teacher_forced(cfg, params, batch, toks, S, N)
    floor = _ssm_noise_floor(torch, cfg, params, batch, S, routing)
    block = _mamba_block_f32(torch, cfg, params, batch["tokens"], toks)
    return (f"bf16 noise floor (plain prefill vs itself with its SSM output "
            f"x (1 + 1e-6 z)) {floor:.3g}; (a) {st['n']} ssm_scan launches, "
            f"max |d| / max {st['worst']:.3g} (<= 1e-4); f32 Mamba block "
            f"kernel vs plain {block:.3g} (<= 1e-3)")


def _attn_noise_floor(torch, cfg, params, batch, S: int) -> str:
    """The bf16 model's own noise floor, measured as `_ssm_checks` and
    `_wkv_checks` measure it: the plain prefill against itself with every
    attention output times (1 + 1e-6 z), z standard normal from a
    seeded generator.  Both prefills compute each attention output in
    f32 (the plain version on the inputs widened; exact) and round it to
    the model's dtype, so the perturbation moves the output only where
    it turns a rounding: the floor is what f32-level differences of the
    kernel's output do to the logits.  Returns the report."""
    from repro_torch.models import layers

    g = torch.Generator(device=batch["tokens"].device)
    g.manual_seed(5)

    def widened(scale):
        def attn(q, k, v, *, causal, window):
            o = layers.flash_attention_chunked(
                q.float(), k.float(), v.float(), causal=causal,
                window=window, chunk=PLAIN_CHUNK)
            if scale:
                o = o * (1 + scale * torch.randn(o.shape, generator=g,
                                                 device=o.device))
            return o.to(q.dtype)
        return attn

    saved = layers.attention_bshd
    try:
        layers.attention_bshd = widened(0.0)
        plain = _teacher_forced(cfg, params, batch, None, S, 0)[0]
        layers.attention_bshd = widened(1e-6)
        perturbed = _teacher_forced(cfg, params, batch, None, S, 0)[0]
    finally:
        layers.attention_bshd = saved
    floor = _logits_close(torch, "noise floor", perturbed, plain, None)
    return (f"bf16 noise floor (plain prefill vs itself with its attention "
            f"output x (1 + 1e-6 z), each in f32 and rounded) {floor:.3g}")


def _mamba_block_f32(torch, cfg, params, prompts, toks) -> float:
    """One full-width Mamba block in f32 (norm1 and the mixer of period 0,
    position 0, weights widened): prefill on the prompts' embeddings and
    4 decode steps, kernel against plain.  Returns the worst ratio."""
    from repro_torch.models import layers

    pos = next(j for j, s in enumerate(cfg.pattern) if s.mixer == "mamba")
    blk = {k: {n: t[0].float() for n, t in v.items()}
           for k, v in params["blocks"][pos].items() if k != "mlp"}
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")

    def run():
        h = layers.norm_apply(blk["norm1"], params["embed"][prompts].float(),
                              cfg.norm)
        y, st = layers.mamba_apply(blk["mixer"], h, cfg32)
        out = [y]
        for k in range(4):
            h = layers.norm_apply(blk["norm1"],
                                  params["embed"][toks[:, k:k + 1]].float(),
                                  cfg.norm)
            out.append(layers.mamba_decode(blk["mixer"], h, cfg32, st)[0])
        return out

    got = run()
    with plain_ssm():
        want = run()
    return max(_logits_close(torch, f"f32 Mamba block, call {k}", a, b, 1e-3)
               for k, (a, b) in enumerate(zip(got, want)))


def _kernel_wrappers() -> dict:
    """name -> the kernel wrapper whose count (`launches`, or
    `route_launches` for the scans) counts its launches."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.wkv_scan import kernel as WK

    return {"flash_attention": FK.flash_attention,
            "decode_attention": DK.decode_attention,
            "wkv_scan": WK.wkv_scan, "ssm_scan": SK.ssm_scan}


def mrope_grid(torch, B: int, S: int, n_vision: int, device):
    """[3, B, S] M-RoPE positions of prompts that open with `n_vision`
    vision rows: those on a square grid (t = 0, h = i // w, w = i % w,
    w = isqrt(n_vision)), every later row its index on all three
    streams."""
    pos = torch.arange(S, device=device).expand(3, B, S).clone()
    i = torch.arange(n_vision, device=device)
    width = math.isqrt(n_vision)
    for stream, val in enumerate((0 * i, i // width, i % width)):
        pos[stream, :, :n_vision] = val
    return pos


def serve_batch(torch, np, cfg, arch: str, B: int, S: int, dev) -> dict:
    """A request's batch: B prompts of S tokens (SERVE_PROMPT's sequence
    where the architecture has one, else uniform draws of numpy seed 0)
    and the frontend inputs its config takes, as `data.pipeline` makes
    them (seed 0, step 0): an encoder-decoder's `enc_embeds`
    [B, encoder_len, D], rounded to the parameter dtype (the encoder's
    input dtype, as the reference's serve launcher hands it); an M-RoPE
    config's `vision_embeds` [B, S//4, D] and `mrope_positions` with
    those rows on a grid (`mrope_grid`)."""
    from repro_torch.data import SyntheticPipeline

    if arch in SERVE_PROMPT:
        tokens = torch.tensor(SERVE_PROMPT[arch], device=dev).repeat(B, 1)
    else:
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S))).to(dev)
    batch = {"tokens": tokens}
    if cfg.is_encoder_decoder or cfg.mrope_sections:
        stub = SyntheticPipeline(cfg, batch=B, seq_len=S, seed=0,
                                 device=dev).batch_at(0)
        batch.update({k: stub[k] for k in ("enc_embeds", "vision_embeds")
                      if k in stub})
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = batch["enc_embeds"].to(
            getattr(torch, cfg.param_dtype))
    if cfg.mrope_sections:
        batch["mrope_positions"] = mrope_grid(
            torch, B, S, batch["vision_embeds"].shape[1], dev)
    return batch


def _serve_launches(cfg, arch: str, N: int) -> dict:
    """(c)'s launches per request of each kernel of the architecture's
    path: (prefill, decode) for a request of N decode steps."""
    want = {}
    for name, (pre, dec) in SERVE_KERNELS[arch].items():
        n_layers = _n_layers(cfg, mixer=KERNEL_MIXER[name])
        enc = 0
        if KERNEL_MIXER[name] == "attn":
            n_layers += _n_layers(cfg, cross_attn=True)
            enc = cfg.n_encoder_layers if pre else 0
        want[name] = (pre * (n_layers + enc), dec * n_layers * N)
    return want


def serve_phase(torch, np, device: str = "cuda",
                arch: str = "qwen1.5-0.5b", long: bool = False) -> dict:
    """`arch` served from RSS-pinned parameter snapshots, with checks
    (a)-(d) (see the module docstring), at the batch shape (SERVE_B x
    SERVE_S, SERVE_STEPS steps) or, with `long`, at its SERVE_LONG
    shape, or SERVE_SHAPE's where the architecture has one; the batch
    from `serve_batch`.  Returns the launches of the architecture's
    kernels over both requests, counted from 0 just before request 1, and
    under a row name of ATTN_ROWS those at its shape, where any.
    (`device="cpu"` runs the plain versions, where no kernel launches: a
    rehearsal off the card.)"""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.cuda_build import launch_count, reset_counts
    from repro_torch.models import init_params
    from repro_torch.serve import ServingEngine
    from repro_torch.tensorstore import VersionedParamStore
    from repro_torch.tree import leaves

    cfg = get_config(arch)
    cfg = smoke_variant(cfg) if SERVE_SMOKE else cfg
    if arch in SERVE_DEPTH:
        cfg = cfg.with_overrides(n_layers=min(SERVE_DEPTH[arch],
                                              cfg.n_layers))
    experts = None
    cut = f"{cfg.n_layers} of {get_config(arch).n_layers} layers"
    if arch in SERVE_EXPERT_CARDS:
        cards = SERVE_EXPERT_CARDS[arch]
        experts = range(cfg.n_experts // cards)
        cut += (f", experts 0-{len(experts) - 1} of {cfg.n_experts} in "
                f"each MoE layer (the experts on {cards} cards by expert, "
                f"the other periods on further pipeline stages)")
    moe = any(s.mlp == "moe" for s in cfg.pattern)
    wrappers = {name: _kernel_wrappers()[name] for name in SERVE_KERNELS[arch]}
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    B, S, N = SERVE_LONG[arch] if long else SERVE_SHAPE.get(
        arch, (SERVE_B, SERVE_S, SERVE_STEPS))
    run = cfg.name + (" long context" if long else "")
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    v1 = init_params(cfg, g, dev, experts=experts)
    # the writer's v2: the embedding tuner of examples/htap_train_serve.py
    rows, d = cfg.vocab_size // 4, cfg.d_model
    g.manual_seed(1)
    v2 = dict(v1, embed=v1["embed"].clone(), lm_head=v1["lm_head"].clone())
    v2["embed"][:rows] += 0.02 * torch.randn(
        (rows, d), generator=g, device=dev).to(v1["embed"].dtype)
    v2["lm_head"][:, :rows] += d ** -0.5 * torch.randn(
        (d, rows), generator=g, device=dev).to(v1["lm_head"].dtype)
    store = VersionedParamStore(slots=2)
    store.publish(v1)
    eng = ServingEngine(cfg, store, max_seq=S + N, device=dev)
    eng.refresh()
    batch = serve_batch(torch, np, cfg, arch, B, S, dev)
    sync()
    mem = (f", {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated"
           if on_card else "")
    n_params = sum(x.numel() for x in leaves(v1))
    print(f"serve: {run} {n_params / 1e9:.3f} B params "
          f"({cfg.param_dtype}, {cut}), init + publish in "
          f"{time.perf_counter() - t0:.1f} s{mem}", flush=True)

    # observe the engine's calls (the pinned params, logits, the prefill's
    # end) and let the writer publish v2 during request 1
    log: dict = {}
    prefill_fn, decode_fn = eng._prefill, eng._decode
    counts = lambda: {name: launch_count(fn)
                      for name, fn in wrappers.items()}
    dattn = wrappers.get("decode_attention")
    splits = lambda: dattn.split_launches if dattn else 0

    def rec_prefill(p, b):
        out = prefill_fn(p, b)
        sync()
        log["t_prefill"] = time.perf_counter()
        log["c_prefill"] = counts()
        log["params"].append(p)
        log["logits"].append(out[0])
        return out

    def rec_decode(p, t, c, n):
        out = decode_fn(p, t, c, n)
        log["params"].append(p)
        log["logits"].append(out[0])
        if log["writer"] and len(log["logits"]) == 1 + SERVE_PUBLISH_AT:
            tw = time.perf_counter()
            log["v2_txn"] = store.publish(v2)      # commit, never waits
            log["publish_us"] = (time.perf_counter() - tw) * 1e6
            held = [s for s in store.slots if s.params is v1]
            if not (held and held[0].valid and held[0].pins == 1) \
                    or store.stats["gc_blocked"]:
                raise AssertionError("the publish disturbed the pinned v1")
        return out

    eng._prefill, eng._decode = rec_prefill, rec_decode

    def request(writer: bool):
        """One request; its launches per kernel as (prefill, decode).
        The writer's request records its MoE routing (check (a) replays
        it)."""
        log.update(params=[], logits=[], writer=writer)
        sync()
        c0, s0 = counts(), splits()
        t = time.perf_counter()
        with record_routing() if writer and moe else \
                contextlib.nullcontext() as calls:
            res = eng.generate(batch, N, refresh_between_steps=True)
        log["routing"] = calls
        sync()
        t_end = time.perf_counter()
        prefill_s, decode_s = log["t_prefill"] - t, t_end - log["t_prefill"]
        c1, c2 = log["c_prefill"], counts()
        per = {name: (c1[name] - c0[name], c2[name] - c1[name])
               for name in wrappers}
        log["split"] = splits() - s0
        return res, per, list(log["logits"]), list(log["params"]), \
            (prefill_s, decode_s)

    reset_counts(wrappers.values())
    if dattn:
        dattn.split_launches = 0
    with record_attention_shapes() as shapes:
        res1, per1, logits1, pinned1, t1 = request(writer=True)
        routing1, split1 = log["routing"], log["split"]
        visible_after_1 = store.visible_lsn()
        eng.refresh()
        res2, per2, _, pinned2, t2 = request(writer=False)
    split2 = log["split"]
    launches = counts()
    launches.update({row: shapes[key] for row, key in ATTN_ROWS.values()
                     if shapes[key]})
    routes = {name: dict(fn.route_launches) for name, fn in wrappers.items()
              if hasattr(fn, "route_launches")}
    for name, by_route in routes.items():
        launches.update({f"{name} {r}": n for r, n in by_route.items()})
    for i, (res, (pre_s, dec_s)) in enumerate(((res1, t1), (res2, t2)), 1):
        print(f"serve request {i} ({run}): snapshot lsn "
              f"{res.snapshot_lsn} lag {res.freshness_lag}; prefill "
              f"{pre_s * 1e3:.1f} ms ({B}x{S} tokens), decode "
              f"{dec_s / N * 1e3:.2f} ms per step, {B * N / dec_s:.1f} "
              f"tokens/s ({B}x{N})", flush=True)

    # (c) launches: each kernel's launches per layer of its mixer in the
    # prefill and in every decode step, in each request
    want = _serve_launches(cfg, arch, N)
    if on_card and not per1 == per2 == want:
        raise AssertionError(f"launches per request {per1}, {per2} != "
                             f"{want}")
    # ... the scans by route: every prefill launch chunked, every decode
    # launch one step
    for name, by_route in routes.items():
        pre, dec = (per1[name][i] + per2[name][i] for i in (0, 1))
        if on_card and by_route != {"chunked": pre, "step": dec}:
            raise AssertionError(f"{name} launches by route {by_route} != "
                                 f"chunked {pre}, step {dec}")
    # ... and the decode launches that split the cache: all of them in the
    # long run, none at the batch shape
    want_split = want["decode_attention"][1] if long and dattn else 0
    if on_card and not split1 == split2 == want_split:
        raise AssertionError(f"split decode launches {split1}, {split2} "
                             f"!= {want_split}")
    # (d) snapshots: request 1 served from v1 alone while v2 was published
    # and became visible; request 2 pinned v2
    if "v2_txn" not in log or not all(p is v1 for p in pinned1) \
            or not all(p is v2 for p in pinned2):
        raise AssertionError("a request was not served from one version")
    if not (visible_after_1 > res1.snapshot_lsn and
            res2.snapshot_lsn > res1.snapshot_lsn and
            res2.freshness_lag == 0):
        raise AssertionError(f"snapshot lsns {res1.snapshot_lsn} -> "
                             f"{res2.snapshot_lsn} (visible "
                             f"{visible_after_1})")
    for res in (res1, res2):
        if tuple(res.tokens.shape) != (B, N):
            raise AssertionError(f"tokens {tuple(res.tokens.shape)}")

    # (a) request 1's logits against the plain path on v1, teacher-forced
    # with request 1's tokens (and its MoE routing); (b) prefill + decode
    # against forward (for MoE drop-free, `_check_b_dropfree`).  On the
    # served bf16 model, bounded where its rounding noise allows
    # (SERVE_BF16_TOL); for RWKV6 the kernel is held by `_wkv_checks`
    tok1, rel = res1.tokens, SERVE_BF16_TOL[arch]
    worst_a, flips_a = _check_a(torch, cfg, v1, batch, tok1, logits1, S,
                                N, rel, routing1)
    if moe:
        worst_b, flips_b = _check_b_dropfree(torch, cfg, v1, batch, tok1,
                                             S, N, rel)
    else:
        worst_b, flips_b = _check_b(torch, cfg, v1, batch, tok1, logits1,
                                    S, N, rel)
    bound = f"<= {rel}" if rel is not None else "not bounded"
    extra = f"; {_wkv_checks(torch, cfg, v1, batch, tok1, S, N)}" \
        if "wkv_scan" in wrappers else ""
    if "ssm_scan" in wrappers:
        extra += "; " + _ssm_checks(torch, cfg, v1, batch, tok1, S, N,
                                    routing1)
    if arch in SERVE_NOISE_FLOOR and not long:
        extra += "; " + _attn_noise_floor(torch, cfg, v1, batch, S)
    if moe:
        n_dec = B * (S + N) * cfg.top_k * _n_layers(cfg, mlp="moe")
        extra += (f"; MoE routing replayed: of {n_dec} routing decisions "
                  f"per path, the plain path would have flipped {flips_a}, "
                  f"the drop-free forward {flips_b} (capacity factor 8.0 in "
                  f"(b), {cfg.moe_capacity_factor} served)")
    differ = int((res1.tokens != res2.tokens).sum())
    per_txt = ", ".join(f"{name} {pre} in prefill + {dec} in decode"
                        for name, (pre, dec) in per1.items())
    if dattn:
        per_txt += f" ({split1} of them split)"
    if shapes:
        per_txt += "; by shape over both requests: " + ", ".join(
            f"{k[0]} {k[1:]} {n}" for k, n in sorted(shapes.items()))
    peak = (f"; phase peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if on_card else "")
    print(f"serve checks: (a) {run} kernel vs plain path max |d| / "
          f"max |logit| {worst_a:.3g}; (b) prefill + decode vs forward "
          f"{worst_b:.3g} (bf16, {bound}){extra}; (c) launches per "
          f"request {per_txt}; (d) v2 "
          f"(txn {log['v2_txn']}) published at step {SERVE_PUBLISH_AT} in "
          f"{log['publish_us']:.1f} us under request 1's pin, request 2 "
          f"lsn {res2.snapshot_lsn} > {res1.snapshot_lsn}, {differ} of "
          f"{B * N} tokens differ{peak}", flush=True)
    eng._prefill, eng._decode = prefill_fn, decode_fn
    if on_card:
        serve_profile(torch, lambda: eng.generate(batch, N), sum(t2), run)
    return launches


def serve_profile(torch, run, wall_unprofiled: float, model: str) -> None:
    """One more request (as request 2) under torch.profiler (CUDA
    activity): device busy time, and device time by kind — the two
    attention kernels, the WKV and SSM kernels, matrix products (cuBLAS), the
    rest (PyTorch's elementwise, copy and reduction kernels).  The
    profiler's callbacks slow the host several times over, so the idle
    share is taken against request 2's unprofiled wall (the device work
    is the same)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kinds: dict = {}
    top = []
    for e in prof.key_averages():
        us, name = e.self_device_time_total, e.key
        if us <= 0:
            continue
        low = name.lower()
        kind = ("flash_attention" if "flash_kernel" in name else
                "decode_attention" if "decode_kernel" in name else
                "wkv_scan" if "wkv_kernel" in name else
                "ssm_scan" if "ssm_kernel" in name else
                "matmul" if any(w in low for w in ("gemm", "gemv", "xmma",
                                                   "cutlass", "splitk",
                                                   "nvjet"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + us
        top.append((us, e.count, name))
    busy = sum(kinds.values()) / 1e6
    print(f"serve {model} profile: device busy {busy:.4f} s; idle share "
          f"{1 - busy / wall_unprofiled:.4f} of request 2's "
          f"{wall_unprofiled:.3f} s (profiled wall {wall:.3f} s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; by kind: "
          + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1])),
          flush=True)
    for us, n, name in sorted(top, reverse=True)[:10]:
        print(f"serve {model} profile device: {us / 1e3:9.3f} ms x{n:6d} "
              f"{name[:80]}", flush=True)


# ----------------------------------------------------------- sharded serving
def serve_two(torch, eng, store, versions, batch: dict, N: int,
              publish_at: int, sync, keep: bool = False) -> tuple[list, int]:
    """Two requests of `batch` and N decode steps through `eng` over
    `store`: request 1 while versions[1] is published (a commit, never
    waiting) under its pin after decode step `publish_at`, then request 2,
    refreshing between steps.  Returns (a dict a request: its snapshot
    "lsn", "tokens", the version each prefill and decode call "read"
    ("v1" for versions[0], "v2" for versions[1], else "?"),
    "prefill_ms" and "decode_ms" a step; the visible lsn when versions[1]
    was published).  `keep`: request 1's dict also holds the "logits" of
    each of its calls (f32, on the CPU), the experts its MoE layers chose
    in call order ("routing") and the shapes of its cache entries by
    pattern position ("cache"), for a check by the caller (`gathered_s1`)."""
    v1, v2 = versions
    log: dict = {}
    prefill_fn, decode_fn = eng._prefill, eng._decode

    def rec_prefill(p, b):
        out = prefill_fn(p, b)
        sync()
        log["t_prefill"] = time.perf_counter()
        log["read"].append(p)
        if log["keep"]:
            log["logits"].append(out[0].float().cpu())
            log["cache"] = [{k: tuple(x.shape) for k, x in entry.items()}
                            for entry in out[1]["blocks"]]
        return out

    def rec_decode(p, t, c, n):
        out = decode_fn(p, t, c, n)
        log["read"].append(p)
        if log["keep"]:
            log["logits"].append(out[0].float().cpu())
        if log["writer"] and len(log["read"]) == 1 + publish_at:
            log["v2_lsn_before"] = store.visible_lsn()
            store.publish(v2)                 # commit, never waits
        return out

    eng._prefill, eng._decode = rec_prefill, rec_decode
    requests = []
    try:
        for writer in (True, False):
            log.update(read=[], writer=writer, keep=keep and writer,
                       logits=[])
            with record_routing() if log["keep"] else \
                    contextlib.nullcontext() as routing:
                sync()
                t = time.perf_counter()
                res = eng.generate(batch, N, refresh_between_steps=True)
                sync()
            requests.append({
                "lsn": res.snapshot_lsn, "tokens": res.tokens.cpu(),
                "read": ["v1" if p is v1 else "v2" if p is v2 else "?"
                         for p in log["read"]],
                "prefill_ms": (log["t_prefill"] - t) * 1e3,
                "decode_ms": (time.perf_counter() - log["t_prefill"]) / N
                * 1e3})
            if log["keep"]:
                requests[-1].update(logits=log["logits"],
                                    routing=[c.cpu() for c in routing],
                                    cache=log["cache"])
            eng.refresh()
    finally:
        eng._prefill, eng._decode = prefill_fn, decode_fn
    return requests, log["v2_lsn_before"]


def gathered_s1(torch, cfg, params, batch: dict, out: list) -> tuple:
    """(s1) of a gathered serving run, here after its ranks: the unsharded
    kernel path on `params` (the served version) teacher-forced with
    request 1's tokens (every rank's, equal: `check_s2`), its MoE layers
    replaying the ranks' own choices (each rank's rows of each call, in
    batch-rank order), against each rank's request 1 logits of its rows
    (`serve_two(keep=True)`; rows "rows" of the whole batch).  Returns
    (the worst ratio of each rank, the routing decisions the unsharded
    path would have made otherwise)."""
    first = [r["requests"][0] for r in out]
    toks = first[0]["tokens"].to(batch["tokens"].device)
    S, N = batch["tokens"].shape[1], toks.shape[1]
    order = sorted(range(len(out)), key=lambda i: out[i]["rows"][0])
    routing = [torch.cat([first[i]["routing"][c] for i in order]).to(
        toks.device) for c in range(len(first[0]["routing"]))] or None
    with torch.no_grad(), replay_routing(torch, routing) as flips:
        want = [x.float().cpu() for x in _teacher_forced(
            cfg, params, batch, toks, S, N)]
    ratios = []
    for r, q in zip(out, first):
        rows = slice(*r["rows"])
        ratios.append(max(
            _logits_close(torch, f"(s1) rank {r['rank']} call {k}", got,
                          w[rows], None)
            for k, (got, w) in enumerate(zip(q["logits"], want))))
    return ratios, flips["differ"]


def tp_rank(group, cfg, batch: dict, toks, ref_path: str,
            publish_at: int, arch: str = TP_ARCH, experts=None,
            routes_path: str = None, specs: dict = None) -> dict:
    """One rank of a sharded serve phase (`parallel.spawn` runs it in a
    process of its own): its pieces of v1 drawn by
    `init_local_params` (torch.Generator seed 0 on its device, the
    parent's draws; `experts` the MoE layers' share; `specs` the
    placement, None for the tensor-parallel serving layout), published
    into its own `VersionedParamStore(slots=2)` and served by a
    `ServingEngine` over the mesh (with `specs`, gathered a layer at a
    time): request 1 with v2 (v1 with its embedding negated) published
    under its pin after decode step `publish_at`, then request 2
    (`serve_two`); the launches of `arch`'s kernels (SERVE_KERNELS, the
    attention kernels for another arch; the scans' by route too) counted
    from 0 just before request 1 and read after request 2.  Tensor
    parallel, then check (s1): the rank's prefill and teacher-forced
    decode logits (`toks`), gathered over "model", against the parent's
    unsharded ones at `ref_path`, with the parent's MoE routing at
    `routes_path` (None: no MoE) replayed, cut to the rank's rows, and
    every `ssm_scan` and `wkv_scan` launch held against the plain version
    (`checked_ssm`, `checked_wkv`).  The plain versions' calls over the
    two requests are counted (`count_plain`).  Gathered, request 1 keeps
    its logits and routing for the parent's (s1) (`gathered_s1`; of
    `toks` only the number of decode steps is read, `ref_path` and
    `routes_path` are unused).
    Returns what the parent checks and prints."""
    import torch

    from repro_torch.kernels import cuda_build
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.sharding import with_mesh
    from repro_torch.parallel import init_local_params
    from repro_torch.parallel.tensor import gather_vocab, split_batch
    from repro_torch.serve import ServingEngine
    from repro_torch.tensorstore import VersionedParamStore

    dev = group.device
    on_card = dev.type == "cuda"
    names = tuple(SERVE_KERNELS.get(arch, ATTN_TPU))
    libs = {TP_LIBRARY.get(n, "attention") for n in names}
    if on_card and not all(cuda_build.library_path(lib).exists()
                           for lib in libs):
        raise RuntimeError("the parent builds the kernels before the ranks "
                           "start; a rank never runs nvcc")
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else \
        (lambda: None)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    t0 = time.perf_counter()
    v1 = init_local_params(cfg, g, group.mesh, group.coords, dev,
                           specs=specs, experts=experts)
    v2 = dict(v1, embed=-v1["embed"])
    if on_card:
        torch.cuda.empty_cache()            # the draws' transient memory
        torch.cuda.reset_peak_memory_stats(dev)
    store = VersionedParamStore(slots=2)
    store.publish(v1)
    batch = {k: x.to(dev) for k, x in batch.items()}
    S, N = batch["tokens"].shape[1], toks.shape[1]
    eng = ServingEngine(cfg, store, max_seq=S + N, device=dev, group=group,
                        specs=specs)
    eng.refresh()
    init_s = time.perf_counter() - t0

    wrappers = {n: _kernel_wrappers()[n] for n in names}
    cuda_build.reset_counts(wrappers.values())
    dattn = wrappers.get("decode_attention")
    if dattn:
        dattn.split_launches = 0
    view = eng.view
    gathers = view.gathers if view is not None else 0
    with count_plain() as plain:
        requests, v2_before = serve_two(torch, eng, store, (v1, v2), batch,
                                        N, publish_at, sync,
                                        keep=view is not None)
    launches = {n: cuda_build.launch_count(fn)
                for n, fn in wrappers.items()}
    launches.update({f"{n} {route}": k for n, fn in wrappers.items()
                     for route, k in getattr(fn, "route_launches",
                                             {}).items()})
    split = dattn.split_launches if dattn else 0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    result = {"rank": group.rank, "coords": group.coords, "init_s": init_s,
              "requests": requests, "v2_lsn_before": v2_before,
              "launches": launches, "split": split, "peak_gb": peak,
              "plain": plain["calls"]}
    if view is not None:
        n = requests[0]["tokens"].shape[0] // view.batch_size
        result.update(gathers=(view.gathers - gathers) / 2,
                      rows=(view.batch_rank * n, (view.batch_rank + 1) * n),
                      cache=requests[0]["cache"])
        return result

    # (s1) against the parent's unsharded kernel path, its routing
    # replayed, each scan launch held against plain
    want = torch.load(ref_path)
    b = split_batch(batch, group)
    t = split_batch({"tokens": toks.to(dev)}, group)["tokens"]
    rows = slice(group.data_rank * t.shape[0], (group.data_rank + 1)
                 * t.shape[0])
    routing = None if routes_path is None else [
        c[rows].to(dev) for c in torch.load(routes_path)]
    ratios = []
    with torch.no_grad(), with_mesh(group), checked_ssm(torch) as ssm, \
            checked_wkv(torch) as wkvs, \
            replay_routing(torch, routing) as flips:
        lg, cache = prefill(v1, cfg, b, cache_len=S + N)
        for k in range(N + 1):
            got = gather_vocab(lg, group).float().cpu()
            w = want[k][rows].float()
            ratios.append(((got - w).abs().max() / w.abs().max()).item())
            if not torch.isfinite(got).all():
                raise AssertionError(f"rank {group.rank}: non-finite logits")
            if k < N:
                lg, cache = decode_step(v1, cfg, t[:, k:k + 1], cache, S + k)
    result.update(s1=max(ratios), flips=flips["differ"],
                  scans={"ssm_scan": ssm, "wkv_scan": wkvs},
                  cache=[{k: tuple(x.shape) for k, x in entry.items()}
                         for entry in cache["blocks"]])
    return result


def check_s2(torch, out: list, B: int, N: int) -> tuple[int, int]:
    """(s2) over the ranks' `serve_two` results (each rank's "requests"
    and "v2_lsn_before"): one snapshot LSN a request on every rank,
    request 1 read v1 in every call with v2 published under its pin at
    that LSN's visibility, request 2 read v2 at a later LSN, and every
    rank's [B, N] tokens equal.  Returns the two LSNs."""
    lsn1 = {r["requests"][0]["lsn"] for r in out}
    lsn2 = {r["requests"][1]["lsn"] for r in out}
    if not (len(lsn1) == len(lsn2) == 1 and min(lsn2) > min(lsn1)):
        raise AssertionError(f"(s2) snapshot lsns by rank: request 1 "
                             f"{lsn1}, request 2 {lsn2}")
    for r in out:
        reads = [q["read"] for q in r["requests"]]
        if reads != [["v1"] * (N + 1), ["v2"] * (N + 1)] \
                or r["v2_lsn_before"] != min(lsn1):
            raise AssertionError(f"(s2) rank {r['rank']} read {reads}")
    for i in (0, 1):
        first = out[0]["requests"][i]["tokens"]
        if tuple(first.shape) != (B, N) or not all(
                torch.equal(r["requests"][i]["tokens"], first) for r in out):
            raise AssertionError(f"request {i + 1}: ranks differ in tokens")
    return min(lsn1), min(lsn2)


def _rank_devices(dev, backend: str, n: int) -> list:
    """The ranks' devices: one card a rank over nccl, else all on `dev`
    (gloo: ranks that share a card, or the CPU)."""
    if backend == "nccl":
        return [f"cuda:{r}" for r in range(n)]
    return [f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu"] * n


def _how(backend: str, n: int, on_card: bool) -> str:
    return (f"{n} ranks on one card over gloo: collectives pass through "
            f"the host" if backend == "gloo" and on_card else
            f"{n} ranks, one card each, over nccl" if on_card else
            f"{n} ranks on the CPU over gloo")


def tp_serve_phase(torch, np, device: str = "cuda", backend: str = "gloo",
                   mesh_shape: tuple = None,
                   arch: str = TP_ARCH) -> dict:
    """The sharded serve phase (see the module docstring): `arch` cut to
    TP_DEPTH layers at the published widths (a MoE model holding
    SERVE_EXPERT_CARDS' share of the experts) on a mesh of `mesh_shape`
    (None: the architecture's, TP_MESHES), its ranks spawned on
    `backend`, all on the one `device` (gloo: the ranks share the card)
    or one card a rank (nccl); the unsharded kernel path's teacher-forced
    logits (and a MoE model's routing) computed here first, on the same
    weights and tokens (for RWKV, on each data rank's rows in turn), and
    freed before the ranks start.  Checks (s1) and (s2),
    the launches in every rank and no plain version called, a scan
    model's caches and scan launches; returns the launches of the
    per-rank shape rows (TP_ROWS for an attention model, TP_SSM_ROWS for
    a Mamba model, TP_WKV_ROWS for RWKV), summed over the ranks."""
    import tempfile

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_params
    from repro_torch.parallel import check_tp, spawn

    cfg = get_config(arch)
    cfg = smoke_variant(cfg) if SERVE_SMOKE else cfg
    cfg = cfg.with_overrides(n_layers=min(TP_DEPTH[arch], cfg.n_layers))
    experts = range(cfg.n_experts // SERVE_EXPERT_CARDS[arch]) \
        if arch in SERVE_EXPERT_CARDS else None
    moe = any(s.mlp == "moe" for s in cfg.pattern)
    mamba = "ssm_scan" in SERVE_KERNELS[arch]
    rwkv = "wkv_scan" in SERVE_KERNELS[arch]
    mesh = Mesh(mesh_shape or TP_MESHES[arch], ("data", "model"))
    check_tp(cfg, mesh)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    devices = _rank_devices(dev, backend, mesh.size)
    B, S, N = TP_B, TP_S, TP_STEPS
    batch = serve_batch(torch, np, cfg, arch, B, S, dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, N))).to(dev)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, dev, experts=experts)
    with record_routing() if moe else contextlib.nullcontext() as calls:
        if rwkv:                            # (its batch is tokens alone)
            n = B // mesh.shape["data"]
            want = [torch.cat(parts) for parts in zip(*(_teacher_forced(
                cfg, params, {k: x[i:i + n] for k, x in batch.items()},
                toks[i:i + n], S, N) for i in range(0, B, n)))]
        else:
            want = _teacher_forced(cfg, params, batch, toks, S, N)
    if mamba:
        floor = (f"Jamba's bf16 noise floor at {cfg.n_layers} layers "
                 f"{_ssm_noise_floor(torch, cfg, params, batch, S, calls):.4g}"
                 f" (measured here, as the serve phase measures it)")
    elif rwkv:
        floor = (f"the unsharded kernel path run on each data rank's "
                 f"{B // mesh.shape['data']} rows (RWKV6-3B's bf16 logits "
                 f"move ~8% of max-abs for a 1e-6 change of a WKV output)")
    else:
        floor = (f"Qwen2-VL's bf16 noise floor under attention at "
                 f"{TP_DEPTH[arch]} layers {TP_NOISE_FLOOR} "
                 f"({TP_NOISE_FLOOR_FROM})")
    del params
    TP_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=TP_DIR) as tmp:
        ref_path = os.path.join(tmp, "reference.pt")
        torch.save([x.cpu() for x in want], ref_path)
        routes_path = None
        if moe:
            routes_path = os.path.join(tmp, "routing.pt")
            torch.save([c.cpu() for c in calls], routes_path)
        del want, calls
        if on_card:
            torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = spawn(tp_rank, mesh, backend=backend, devices=devices,
                    tmpdir=tmp, args=(cfg, {k: x.cpu() for k, x in
                                            batch.items()},
                                      toks.cpu(), ref_path, TP_PUBLISH_AT,
                                      arch, experts, routes_path))
        ranks_s = time.perf_counter() - t0
    how = _how(backend, mesh.size, on_card)
    cut = "" if experts is None else \
        f", experts 0-{len(experts) - 1} of {cfg.n_experts}"
    run = f"{cfg.name} {cfg.n_layers} of {get_config(arch).n_layers} " \
          f"layers{cut}, mesh {mesh.shape}, {backend}"
    print(f"tp serve: {run}: unsharded reference {ref_s:.1f} s, ranks "
          f"{ranks_s:.1f} s ({how})", flush=True)
    for r in out:
        req = r["requests"]
        peak = (f"{r['peak_gb']:.2f} GB peak" if r["peak_gb"] is not None
                else "peak not measured (CPU)")
        print(f"tp serve rank {r['rank']} {r['coords']}: init "
              f"{r['init_s']:.1f} s; request 1 prefill "
              f"{req[0]['prefill_ms']:.1f} ms ({B}x{S}), decode "
              f"{req[0]['decode_ms']:.2f} ms a step; request 2 prefill "
              f"{req[1]['prefill_ms']:.1f} ms, decode "
              f"{req[1]['decode_ms']:.2f} ms a step; {peak}; cache "
              f"{ {k: v for e in r['cache'] for k, v in e.items()} }; "
              f"launches {r['launches']} ({r['split']} decode "
              f"launches split); backend {backend} "
              f"({how}); {card_line() if on_card else 'the CPU'}",
              flush=True)
    # (s1) each rank's logits against the unsharded kernel path
    worst = max(r["s1"] for r in out)
    tol = TP_TOL if rwkv else SERVE_BF16_TOL[arch]
    if tol is not None and not worst <= tol:
        raise AssertionError(f"(s1) sharded vs unsharded max |d| / max "
                             f"|logit| {[r['s1'] for r in out]} > {tol}")
    lsn1, lsn2 = check_s2(torch, out, B, N)
    # launches in every rank, over both requests: each kernel's per layer
    # of its mixer, the scans' prefill launches chunked and decode
    # launches a step
    per = {}
    for name, (pre, dec) in _serve_launches(cfg, arch, N).items():
        per[name] = 2 * (pre + dec)
        if name in (*SSM_TPU, *WKV_TPU):
            per.update({f"{name} chunked": 2 * pre, f"{name} step": 2 * dec})
    for r in out:
        if on_card and (r["launches"] != per or r["plain"]):
            raise AssertionError(f"rank {r['rank']} launches "
                                 f"{r['launches']} != {per}, "
                                 f"{r['plain']} plain version calls")
    extra = ""
    if rwkv:
        # every rank's recurrent state whole-headed over its rows; every
        # scan launch of its (s1) run held against plain
        rows = B // mesh.shape["data"]
        H, Nh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        want_cache = {"shift": (cfg.n_periods, rows, cfg.d_model),
                      "wkv": (cfg.n_periods, rows, H, Nh, Nh),
                      "cmix_shift": (cfg.n_periods, rows, cfg.d_model)}
        n_scan = _n_layers(cfg, mixer="rwkv") * (N + 1)
        for r in out:
            if any(c != want_cache for c in r["cache"]):
                raise AssertionError(f"rank {r['rank']} RWKV cache "
                                     f"{r['cache']} != {want_cache}")
            if r["scans"]["wkv_scan"]["n"] != n_scan:
                raise AssertionError(
                    f"rank {r['rank']} checked "
                    f"{r['scans']['wkv_scan']['n']} wkv_scan launches, "
                    f"not {n_scan}")
        extra += (f"; every rank's RWKV state {want_cache} (all {H} "
                  f"heads); (s1)'s {n_scan} wkv_scan launches a rank held "
                  f"against plain, max |d| / max "
                  f"{max(r['scans']['wkv_scan']['worst'] for r in out):.3g}"
                  f" (<= 1e-4)")
    if mamba:
        # every rank's Mamba cache holds its share of d_inner; every
        # scan launch of its (s1) run held against plain
        di = cfg.mamba_d_inner // mesh.shape["model"]
        rows = B // mesh.shape["data"]
        want_cache = {"ssm": (cfg.n_periods, rows, di, cfg.mamba_d_state),
                      "conv": (cfg.n_periods, rows, cfg.mamba_d_conv - 1,
                               di)}
        n_scan = _n_layers(cfg, mixer="mamba") * (N + 1)
        for r in out:
            caches = [c for c, s in zip(r["cache"], cfg.pattern)
                      if s.mixer == "mamba"]
            if any(c != want_cache for c in caches):
                raise AssertionError(f"rank {r['rank']} Mamba cache "
                                     f"{caches} != {want_cache}")
            if r["scans"]["ssm_scan"]["n"] != n_scan:
                raise AssertionError(
                    f"rank {r['rank']} checked "
                    f"{r['scans']['ssm_scan']['n']} ssm_scan launches, not "
                    f"{n_scan}")
        extra += (f"; every rank's Mamba cache {want_cache} (Di {di} of "
                  f"{cfg.mamba_d_inner}); (s1)'s {n_scan} ssm_scan launches "
                  f"a rank held against plain, max |d| / max "
                  f"{max(r['scans']['ssm_scan']['worst'] for r in out):.3g}"
                  f" (<= 1e-4)")
    if moe:
        n_dec = (B // mesh.shape["data"]) * (S + N) * cfg.top_k \
            * _n_layers(cfg, mlp="moe")
        extra += (f"; MoE routing replayed in (s1): of {n_dec} routing "
                  f"decisions a rank, the ranks would have flipped "
                  f"{[r['flips'] for r in out]}")
    print(f"tp serve checks ({run}): (s1) sharded vs unsharded kernel path "
          f"max |d| / max |logit| {worst:.4g} (<= {tol}; by rank "
          f"{[round(r['s1'], 5) for r in out]}), beside {floor}; (s2) one "
          f"snapshot a request on all {mesh.size} ranks: lsn {lsn1} "
          f"then {lsn2}, request 1 read v1 in all {N + 1} calls with "
          f"v2 published after step {TP_PUBLISH_AT}; every rank's tokens "
          f"equal; launches a rank over both requests {per}, "
          f"{sum(r['plain'] for r in out)} plain version calls{extra}; "
          f"{card_line() if on_card else 'the CPU'}", flush=True)
    rows = {}
    if "flash_attention" in per:
        rows = {TP_ROWS["tp prefill"]: "flash_attention",
                TP_ROWS["tp decode"]: "decode_attention"}
    for scan, scan_rows in (("ssm_scan", TP_SSM_ROWS),
                            ("wkv_scan", TP_WKV_ROWS)):
        if scan in per:
            rows.update({row: f"{scan} {route}"
                         for route, (_, row) in scan_rows.items()})
    return {row: sum(r["launches"][name] for r in out)
            for row, name in rows.items()}


def fallback_serve_phase(torch, np, device: str = "cuda",
                         backend: str = "gloo",
                         mesh_shape: tuple = FALLBACK_MESH) -> dict:
    """The fallback serve step (see the module docstring): FALLBACK_ARCH,
    whose model shard passes the resident limit on a mesh of
    `mesh_shape` (`launch.specs.serving_fallback`, asserted), cut to
    FALLBACK_DEPTH layers at the published widths and served gathered
    under the placement `params_specs(serving=True)` falls back on
    (asserted equal, leaf for leaf, to the training placement of the
    cut), its ranks spawned on `backend` as `tp_serve_phase`'s are, each
    drawing its pieces (`init_local_params(specs=)`) and running
    `tp_rank`.  Then (s1) here (`gathered_s1`): the unsharded kernel path
    on the same weights, drawn again after the ranks exit, teacher-forced
    with request 1's tokens and the ranks' MoE routing, against each
    rank's request 1 logits; (s2), the launches in every rank; prints
    the routing decisions the unsharded path would have made otherwise,
    each rank's gathers a request and peak memory.  Returns the
    launches of FALLBACK_ROWS, summed over the ranks."""
    import tempfile

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import params_specs, serving_fallback
    from repro_torch.models import init_params
    from repro_torch.parallel import check_train, spawn
    from repro_torch.tree import leaves

    model = get_config(FALLBACK_ARCH)
    mesh = Mesh(mesh_shape, ("data", "model"))
    if not serving_fallback(mesh, model):
        raise AssertionError(f"{model.name} keeps a resident model shard on "
                             f"{mesh.shape}: no fallback to serve")
    cfg = smoke_variant(model) if SERVE_SMOKE else model
    cfg = cfg.with_overrides(n_layers=FALLBACK_DEPTH)
    check_train(cfg, mesh)
    specs = params_specs(mesh, cfg).specs
    if not SERVE_SMOKE and specs != params_specs(mesh, model,
                                                 serving=True).specs:
        raise AssertionError("the fallback placement of the whole model is "
                             "not the training placement of its cut")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    devices = _rank_devices(dev, backend, mesh.size)
    B, S, N = FALLBACK_SERVE
    batch = serve_batch(torch, np, cfg, FALLBACK_ARCH, B, S, dev)
    FALLBACK_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=FALLBACK_DIR) as tmp:
        t0 = time.perf_counter()
        out = spawn(tp_rank, mesh, backend=backend, devices=devices,
                    tmpdir=tmp, args=(cfg, {k: x.cpu() for k, x in
                                            batch.items()},
                                      torch.zeros((B, N), dtype=torch.int64),
                                      None, FALLBACK_PUBLISH_AT,
                                      FALLBACK_ARCH, None, None, specs))
        ranks_s = time.perf_counter() - t0
    lsn1, lsn2 = check_s2(torch, out, B, N)
    # (s1): the unsharded kernel path on the same draws
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, dev)
    n_params = sum(x.numel() for x in leaves(params))
    s1, flips = gathered_s1(torch, cfg, params, batch, out)
    del params
    if on_card:
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    how = _how(backend, mesh.size, on_card)
    card = card_line() if on_card else "the CPU"
    run = (f"{cfg.name} {cfg.n_layers} of {model.n_layers} layers "
           f"({n_params / 1e9:.3f} B parameters), all {cfg.n_experts} "
           f"experts, the fallback placement on mesh {mesh.shape}, "
           f"{backend}")
    print(f"fallback serve: {run}: ranks {ranks_s:.1f} s ({how}), "
          f"unsharded reference {ref_s:.1f} s; {card}", flush=True)
    for r in out:
        req = r["requests"]
        peak = (f"{r['peak_gb']:.2f} GB peak" if r["peak_gb"] is not None
                else "peak not measured (CPU)")
        print(f"fallback serve rank {r['rank']} {r['coords']}: init "
              f"{r['init_s']:.1f} s; request 1 prefill "
              f"{req[0]['prefill_ms']:.1f} ms ({B}x{S}), decode "
              f"{req[0]['decode_ms']:.2f} ms a step; request 2 prefill "
              f"{req[1]['prefill_ms']:.1f} ms, decode "
              f"{req[1]['decode_ms']:.2f} ms a step; {r['gathers']:g} "
              f"gathers a request; {peak}; launches {r['launches']}; "
              f"{card}", flush=True)
    worst, tol = max(s1), FALLBACK_TOL
    if not worst <= tol:
        raise AssertionError(f"(s1) gathered vs unsharded max |d| / max "
                             f"|logit| {s1} > {tol}")
    n_attn = _n_layers(cfg, mixer="attn")
    per = {"flash_attention": 2 * n_attn, "decode_attention": 2 * N * n_attn}
    for r in out:
        if on_card and r["launches"] != per:
            raise AssertionError(f"rank {r['rank']} launches "
                                 f"{r['launches']} != {per}")
        if r["gathers"] != (N + 1) * (1 + cfg.n_layers):
            raise AssertionError(f"rank {r['rank']}: {r['gathers']} gathers "
                                 "a request")
    n_dec = B * (S + N) * cfg.top_k * _n_layers(cfg, mlp="moe")
    print(f"fallback serve checks ({run}): (s1) every rank's request 1 "
          f"logits vs the unsharded kernel path teacher-forced with its "
          f"tokens, max |d| / max |logit| {worst:.4g} (<= {tol}; by rank "
          f"{[round(x, 6) for x in s1]}); the ranks' MoE routing replayed "
          f"there: of {n_dec} routing decisions, the unsharded path would "
          f"have made {flips} otherwise; (s2) one snapshot a request "
          f"on all {mesh.size} ranks: lsn {lsn1} then {lsn2}, request 1 "
          f"read v1 in all {N + 1} calls with v2 published after step "
          f"{FALLBACK_PUBLISH_AT}; every rank's tokens equal; launches a "
          f"rank over both requests {per}; {card}", flush=True)
    return {FALLBACK_ROWS["fallback prefill"]:
            sum(r["launches"]["flash_attention"] for r in out),
            FALLBACK_ROWS["fallback decode"]:
            sum(r["launches"]["decode_attention"] for r in out)}


def fsdp_rank(group, cfg, B: int, S: int, ref_path: str, ckpt_dir: str,
              n_steps: int, serve: dict, serve_steps: int) -> dict:
    """One rank of the sharded train phase (`parallel.spawn` runs it in a
    process of its own): a `Trainer(group=)` drawing the rank's pieces of
    the state from seed 0 (the parent's draws) and publishing into its
    own `VersionedParamStore(slots=2)`, B x S tokens a step; (f3) its
    resident parameter and
    optimizer bytes against `launch.dryrun.residency`; (f2) step 1's
    gradients (`value_and_grad` on the rank's rows of the same batch),
    each leaf gathered against the parent's unsharded ones at `ref_path`;
    a reader pinned at v1, then `n_steps` steps (the kernels' launches
    and the layout's gathers counted from 0 just before them and read
    after); (f4) the pinned read against v1; (f5) the state saved under
    the group into `ckpt_dir`, restored as the rank's pieces (bitwise)
    and, on rank 0, onto its one device whole (bitwise against every
    gathered leaf); (h) the newest version served from the rank's store by
    `ServingEngine(group=, specs=<the trainer's placement>)`: two
    requests of `serve`'s prompts and `serve_steps` decode steps
    (`serve_two`, a version with the embedding negated published under
    request 1's pin after decode step FSDP_PUBLISH_AT, request 1 keeping
    its logits for the parent's (h1), `gathered_s1`; the attention
    kernels' launches, the plain versions' calls, the gathers and the
    peak memory counted over both).  On a mesh with a "pod" axis, after
    each step (outside its time), whether the rank's pieces equal its pod
    replicas' (`pod_replicas_equal`).  `ckpt_dir` None skips (f5),
    `serve` None skips (h).  Returns what the parent checks and
    prints."""
    import torch

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.dryrun import residency
    from repro_torch.launch.specs import batch_specs, state_specs
    from repro_torch.parallel.tensor import gather_piece
    from repro_torch.serve import ServingEngine
    from repro_torch.tensorstore import VersionedParamStore
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves, leaves_with_path, path_key

    dev = group.device
    on_card = dev.type == "cuda"
    if on_card and not cuda_build.library_path("attention").exists():
        raise RuntimeError("the parent builds the kernels before the ranks "
                           "start; a rank never runs nvcc")
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else \
        (lambda: None)
    t0 = time.perf_counter()
    store = VersionedParamStore(slots=2)
    tr = Trainer(cfg, batch=B, seq_len=S, seed=0, store=store, device=dev,
                 group=group)
    layout = tr.layout
    sync()
    init_s = time.perf_counter() - t0

    # (f3) resident bytes against the dry-run's plan of this mesh
    nbytes = lambda tree: sum(x.numel() * x.element_size()
                              for x in leaves(tree))
    have = {"params": nbytes(tr.state["params"]),
            "opt": nbytes(tr.state["opt"]) + nbytes(tr.state["step"])}
    placed, _ = state_specs(group.mesh, cfg, tr.opt_cfg)
    plan = residency(group.mesh, "train", {
        "state": placed, "batch": batch_specs(group.mesh, cfg, B, S,
                                              train=True)})

    # (f2) step 1's gradients, gathered leaf by leaf
    want = torch.load(ref_path, mmap=True)
    grads = _step_grads(tr, 0)
    f2, f32 = {}, {}
    ratio = lambda a, b: ((a - b).abs().max() / b.abs().max()
                          .clamp_min(1e-30)).item()
    for path, g in leaves_with_path(grads):
        key = path_key(path)
        whole = gather_piece(g, layout.spec(f"opt/m/{key}"), group)
        if not torch.isfinite(whole).all():
            raise AssertionError(f"rank {group.rank}: non-finite {key}")
        f2[key] = ratio(whole, want["grads"][key].to(dev).float())
        f32[key] = ratio(whole, want["grads32"][key].to(dev))
    del grads, whole

    # the main path: n_steps published steps, a reader pinned at v1
    v1 = [x.clone() for x in leaves(tr.state["params"])]
    pin, pinned = store.pin_snapshot()
    wrappers = {"flash_attention": FK.flash_attention,
                "flash_attention_bwd": FK.flash_attention_bwd}
    cuda_build.reset_counts(wrappers.values())
    gathers, scatters = layout.gathers, layout.reduce_scatters
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    starts, ends, replicas = [], [], []
    pod = "pod" in group.mesh.axis_names

    def after(i, metrics):
        sync()
        ends.append(time.perf_counter())
        if pod:
            replicas.append(pod_replicas_equal(torch, group, tr.state))
        starts.append(time.perf_counter())

    sync()
    starts.append(time.perf_counter())
    log = tr.run(n_steps, after_step=after)
    launches = {n: cuda_build.launch_count(fn) for n, fn in wrappers.items()}
    gathers = (layout.gathers - gathers) / n_steps
    scatters = (layout.reduce_scatters - scatters) / n_steps
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    step_ms = [(b - a) * 1e3 for a, b in zip(starts, ends)]
    store.refresh()
    f4 = len(v1) == len(leaves(pinned)) and all(
        torch.equal(a, b) for a, b in zip(leaves(pinned), v1))
    lsns = (store.pinned_lsn(pin), store.visible_lsn())
    store.release(pin)
    del v1, pinned

    result = {"rank": group.rank, "coords": group.coords, "init_s": init_s,
              "losses": [m["loss"] for m in log],
              "grad_norm": log[0]["grad_norm"], "step_ms": step_ms,
              "peak_gb": peak, "gathers": gathers,
              "reduce_scatters": scatters, "launches": launches, "f2": f2,
              "f32": f32, "have": have,
              "plan": {k: plan[k] for k in have}, "f4": f4, "lsns": lsns,
              "replicas": replicas, "f5": None, "serve": None}
    if ckpt_dir is not None:
        result.update(_fsdp_save_restore(torch, group, tr, ckpt_dir,
                                         n_steps))
    if serve is None:
        return result

    # (h) serve what the ranks trained: the newest version (the state
    # just saved), a layer gathered at a time under the trainer's
    # placement, a version published on every rank under request 1's pin
    serve = {k: x.to(dev) for k, x in serve.items()}
    N = serve_steps
    eng = ServingEngine(cfg, store, max_seq=serve["tokens"].shape[1] + N,
                        device=dev, group=group, specs=layout.param_specs)
    eng.refresh()
    served = tr.state["params"]
    wrappers = {n: _kernel_wrappers()[n] for n in ATTN_TPU}
    cuda_build.reset_counts(wrappers.values())
    served_gathers = eng.view.gathers
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    with count_plain() as plain:
        requests, v2_before = serve_two(
            torch, eng, store, (served, dict(served, embed=-served["embed"])),
            serve, N, FSDP_PUBLISH_AT, sync, keep=True)
    n = serve["tokens"].shape[0] // eng.view.batch_size
    result["serve"] = {
        "requests": requests, "v2_lsn_before": v2_before,
        "launches": {n: cuda_build.launch_count(fn)
                     for n, fn in wrappers.items()},
        "plain": plain["calls"],
        "gathers": (eng.view.gathers - served_gathers) / 2,
        "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9 if on_card
                    else None),
        "rows": (eng.view.batch_rank * n, (eng.view.batch_rank + 1) * n),
        "cache": requests[0]["cache"]}
    return result


def _step_grads(tr, step: int):
    """The rank's f32 gradient pieces of `tr`'s batch of `step` as its
    train step takes them: the mean of its microbatches' (`train.step`)."""
    from repro_torch.train.step import _split_microbatches
    from repro_torch.tree import tree_map

    A = max(tr.cfg.microbatches, 1)
    batch = tr.batch_at(step)
    if A == 1:
        return tr.step_fn.value_and_grad(tr.state["params"], batch)[1]
    blocks = _split_microbatches(batch, A)
    total = None
    for i in range(A):
        g = tr.step_fn.value_and_grad(tr.state["params"],
                                      {k: x[i] for k, x in blocks.items()})[1]
        total = g if total is None else tree_map(lambda a, b: a + b, total, g)
        del g
    return tree_map(lambda x: x / A, total)


def _fsdp_save_restore(torch, group, tr, ckpt_dir: str, step: int) -> dict:
    """(f5) of `fsdp_rank`: the trainer's state saved under the group as
    `step` into `ckpt_dir`, restored onto the mesh (the rank's pieces,
    bitwise) and, on rank 0, onto its one device (bitwise against every
    gathered leaf): {"f5": (pieces, whole or None off rank 0), "save_s"}."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.parallel.tensor import gather_piece
    from repro_torch.tree import leaves, leaves_with_path, path_key

    dev, specs = group.device, tr.layout.specs.state
    t0 = time.perf_counter()
    ckpt.save(tr.state, step, ckpt_dir, group=group, specs=specs)
    save_s = time.perf_counter() - t0
    mine = ckpt.restore(ckpt_dir, tr.state, device=dev, group=group,
                        specs=specs)
    f5_pieces = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                    zip(leaves(mine), leaves(tr.state)))
    del mine
    one = None
    if group.rank == 0:
        template = dict(tr.layout.meta, step=torch.zeros(
            (), dtype=torch.int32, device="meta"))
        one = dict(leaves_with_path(ckpt.restore(ckpt_dir, template,
                                                 device=dev)))
    f5_whole = True
    for path, x in leaves_with_path(tr.state):
        whole = gather_piece(x, specs[path_key(path)], group)
        if one is not None:
            got = one.pop(path)
            f5_whole &= got.dtype == whole.dtype and torch.equal(got,
                                                                 whole)
    return {"f5": (f5_pieces, f5_whole if group.rank == 0 else None),
            "save_s": save_s}


def bits_digest(torch, x, block: int = 1 << 16, rows: int = 256):
    """A digest of `x`'s bits: its words as integers (int8/16/32, by its
    element size; 8-byte elements as two int32 words), zero-padded to
    blocks of `block`, and per block their sum and the sum of each times
    its place in the block (1 to `block`), as int64 [blocks, 2].  Leaves
    equal bit for bit give equal digests; one element that differs
    changes its block's first sum.  No sum overflows: a word is below
    2^31 in magnitude, a block's weighted sum of 2^16 terms below 2^63."""
    words = {1: torch.int8, 2: torch.int16}.get(x.element_size(),
                                                 torch.int32)
    w = x.detach().contiguous().reshape(-1).view(words)
    padded = w.new_zeros(-(-w.numel() // block) * block)
    padded[:w.numel()] = w
    w = padded.view(-1, block)
    place = torch.arange(1, block + 1, dtype=torch.int64, device=x.device)
    out = []
    for i in range(0, w.shape[0], rows):
        c = w[i:i + rows].to(torch.int64)
        out.append(torch.stack([c.sum(1), (c * place).sum(1)], 1))
    return torch.cat(out)


def pod_replicas_equal(torch, group, state) -> bool:
    """Whether every leaf of the rank's `state` equals, bit for bit, the
    same leaf on each rank that differs from it on "pod" alone: their
    digests (`bits_digest`) gathered over "pod" equal."""
    from repro_torch.tree import leaves

    mine = torch.cat([bits_digest(torch, x) for x in leaves(state)])
    every = group.all_gather(mine[None], ("pod",))
    return all(torch.equal(row, mine) for row in every)


def fsdp_train_phase(torch, np, device: str = "cuda", backend: str = "gloo",
                     mesh_shape: tuple = FSDP_MESH) -> dict:
    """The sharded train phase (see the module docstring): FSDP_ARCH
    whole at the published widths under its fsdp2d placement on a mesh of
    `mesh_shape`, its ranks spawned on `backend`, all on the one
    `device` (gloo: the ranks share the card) or one card a rank
    (nccl); the unsharded step's loss, gradients and grad norm computed
    here first, on the same weights and batch (and the gradients of the
    same weights in f32, TF32 off: the bf16 noise floor printed beside
    (f2)), and freed before the ranks start.  Checks (f1)-(f5) on every
    rank; then (h): each rank serves FSDP_SERVE's requests from its store
    (`fsdp_rank`), (h1) its logits against the unsharded kernel path's on
    the state the ranks saved, restored here onto one device, (h2) one
    snapshot a request on every rank, (h3) its gathers a request and peak
    memory printed; no plain attention called.  Then (i), once those
    ranks have exited: FSDP_STEPS steps on the reference's pod mesh
    POD_MESH (`fsdp_rank` without (f5) and (h)), checks (f1)-(f4)
    against the same unsharded step and the pod replicas' pieces equal
    after every step.  Returns the ranks' flash forward and backward
    launches, summed over both meshes, under the kernels line's keys, the
    (data, model) mesh's backward launches under FSDP_ROWS' row, and
    their serving launches under FSDP_SERVE_ROWS'."""
    import tempfile

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import global_norm
    from repro_torch.parallel import check_train, spawn
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves_with_path, path_key, tree_map

    cfg = train_config(FSDP_ARCH)
    mesh = Mesh(mesh_shape, ("data", "model"))
    check_train(cfg, mesh)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    card = card_line() if on_card else "the CPU"
    devices = _rank_devices(dev, backend, mesh.size)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(cfg, g, dev)
    batch = SyntheticPipeline(cfg, batch=TRAIN_B, seq_len=TRAIN_S, seed=0,
                              device=dev).batch_at(0)
    opt = AdamWConfig(moment_dtype=cfg.moment_dtype)
    loss, grads = make_train_step(cfg, opt).value_and_grad(params, batch)
    # the same weights in f32 (TF32 off): each leaf's gradient, and the
    # bf16 step's own distance from it (the noise floor of (f2))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = cfg.with_overrides(param_dtype="float32", compute_dtype="float32")
    _, g32 = make_train_step(f32, opt).value_and_grad(
        tree_map(lambda x: x.float(), params), batch)
    ref = {"loss": float(loss), "grad_norm": float(global_norm(grads)),
           "grads": {}, "grads32": {}, "floor": {}}
    for (p, g), (_, w) in zip(leaves_with_path(grads),
                              leaves_with_path(g32)):
        key = path_key(p)
        ref["grads"][key], ref["grads32"][key] = g.cpu(), w.cpu()
        ref["floor"][key] = ((g.float() - w).abs().max()
                             / w.abs().max().clamp_min(1e-30)).item()
    del params, batch, loss, grads, g32
    if on_card:
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    FSDP_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=FSDP_DIR) as tmp:
        ref_path = os.path.join(tmp, "reference.pt")
        torch.save(ref, ref_path)
        t0 = time.perf_counter()
        sB, sS, sN = FSDP_SERVE
        serve = serve_batch(torch, np, cfg, FSDP_ARCH, sB, sS, dev)
        ckpt_dir = os.path.join(tmp, "ckpt")
        out = spawn(fsdp_rank, mesh, backend=backend, devices=devices,
                    tmpdir=tmp, args=(cfg, TRAIN_B, TRAIN_S, ref_path,
                                      ckpt_dir, FSDP_STEPS,
                                      {k: x.cpu() for k, x in serve.items()},
                                      sN))
        ranks_s = time.perf_counter() - t0
        how = _how(backend, mesh.size, on_card)
        run = (f"{cfg.name} {cfg.n_layers} layers, {cfg.train_sharding}, "
               f"mesh {mesh.shape}, {backend}, {TRAIN_B}x{TRAIN_S} tokens a "
               f"step")
        print(f"fsdp train: {run}: unsharded reference {ref_s:.1f} s, ranks "
              f"{ranks_s:.1f} s ({how}); {card}", flush=True)
        _train_rank_checks(out, ref, cfg, "fsdp train", run, card, on_card)
        # (h1)'s unsharded kernel path: the saved state on one device
        t0 = time.perf_counter()
        hs = [dict(r["serve"], rank=r["rank"]) for r in out]
        lsn1, lsn2 = check_s2(torch, hs, sB, sN)
        state = ckpt.restore(ckpt_dir, {
            "params": init_params(cfg, None, "meta")}, device=dev)
        h1, _ = gathered_s1(torch, cfg, state["params"], serve, hs)
        del state, serve
        if on_card:
            torch.cuda.empty_cache()
        h1_s = time.perf_counter() - t0
        _serve_rank_checks(hs, out, h1, h1_s, (lsn1, lsn2), cfg, mesh, run,
                           backend, card, on_card)
        # (i) the same steps on the pod mesh, against the same reference
        pod = Mesh(POD_MESH, ("pod", "data", "model"))
        pod_cfg = cfg.with_overrides(microbatches=POD_MICROBATCHES)
        check_train(pod_cfg, pod)
        t0 = time.perf_counter()
        pod_out = spawn(fsdp_rank, pod, backend=backend,
                        devices=_rank_devices(dev, backend, pod.size),
                        tmpdir=tmp, args=(pod_cfg, TRAIN_B, TRAIN_S,
                                          ref_path, None, FSDP_STEPS, None,
                                          0))
        pod_s = time.perf_counter() - t0
    # (i) the pod mesh: (f1)-(f4) against the same unsharded step, the pod
    # replicas' pieces equal after every step
    rows = TRAIN_B // math.prod(pod.shape[a] for a in ("pod", "data"))
    pod_run = (f"{cfg.name} {cfg.n_layers} layers, {cfg.train_sharding}, "
               f"pod mesh {pod.shape}, {backend}, {TRAIN_B}x{TRAIN_S} "
               f"tokens a step, {rows} rows a rank in {POD_MICROBATCHES} "
               f"microbatches")
    print(f"pod train: {pod_run}: ranks {pod_s:.1f} s "
          f"({_how(backend, pod.size, on_card)}); {card}", flush=True)
    _train_rank_checks(pod_out, ref, pod_cfg, "pod train", pod_run, card,
                       on_card)
    for r in pod_out:
        if r["replicas"] != [True] * FSDP_STEPS:
            raise AssertionError(f"(i) rank {r['rank']}: pod replicas "
                                 f"equal after each step {r['replicas']}")
    print(f"pod train checks ({pod_run}): every rank's pieces equal, bit "
          f"for bit, to its pod replica's after each of {FSDP_STEPS} "
          f"steps (`pod_replicas_equal`); {card}", flush=True)
    fwd = sum(r["launches"]["flash_attention"] for r in out + pod_out)
    bwd = sum(r["launches"]["flash_attention_bwd"] for r in out)
    pod_bwd = sum(r["launches"]["flash_attention_bwd"] for r in pod_out)
    return {"flash_attention": fwd, "flash_attention_bwd": bwd + pod_bwd,
            FSDP_ROWS["fsdp rank"]: bwd,
            FSDP_SERVE_ROWS["fsdp serve prefill"]:
            sum(h["launches"]["flash_attention"] for h in hs),
            FSDP_SERVE_ROWS["fsdp serve decode"]:
            sum(h["launches"]["decode_attention"] for h in hs)}


def _serve_rank_checks(hs, out, h1, h1_s, lsns, cfg, mesh, run: str,
                       backend: str, card: str, on_card: bool) -> None:
    """The sharded train phase's checks of (h), each rank's line printed
    first: (h1) every rank's request 1 logits against the unsharded
    kernel path (`h1`, their ratios), (h2) one snapshot a request (its
    LSNs `lsns`, `check_s2`), (h3) whole-headed caches, a gather of each
    layer a call, the launches and no plain attention call."""
    sB, sS, sN = FSDP_SERVE
    layers = cfg.n_layers
    for h in hs:
        req = h["requests"]
        peak = (f"{h['peak_gb']:.2f} GB peak" if h["peak_gb"] is not None
                else "peak not measured (CPU)")
        print(f"fsdp serve rank {h['rank']} {out[h['rank']]['coords']}: "
              f"request 1 prefill {req[0]['prefill_ms']:.1f} ms "
              f"({sB}x{sS}, rows {h['rows'][0]}-{h['rows'][1] - 1}), decode "
              f"{req[0]['decode_ms']:.2f} ms a step; request 2 prefill "
              f"{req[1]['prefill_ms']:.1f} ms, decode "
              f"{req[1]['decode_ms']:.2f} ms a step; {h['gathers']:g} "
              f"gathers a request; {peak}; launches {h['launches']}; "
              f"backend {backend}; {card}", flush=True)
    tol = SERVE_BF16_TOL[FSDP_ARCH]
    if not max(h1) <= tol:
        raise AssertionError(f"(h1) gathered vs unsharded max |d| / max "
                             f"|logit| {h1} > {tol}")
    per = {"flash_attention": 2 * layers, "decode_attention": 2 * layers * sN}
    kv = (cfg.n_periods, sB // mesh.size, sS + sN, cfg.n_kv_heads,
          cfg.head_dim)
    for h in hs:
        if on_card and (h["launches"] != per or h["plain"]):
            raise AssertionError(f"(h) rank {h['rank']} launches "
                                 f"{h['launches']} != {per}, "
                                 f"{h['plain']} plain attention calls")
        if h["gathers"] != (sN + 1) * (1 + layers):
            raise AssertionError(f"(h) rank {h['rank']}: {h['gathers']} "
                                 "gathers a request")
        if any(e != {"k": kv, "v": kv} for e in h["cache"]):
            raise AssertionError(f"(h) rank {h['rank']} cache {h['cache']}")
    print(f"fsdp serve checks ({run}; each rank serving its own store "
          f"gathered under the trainer's placement, {sB}x{sS} prompts, "
          f"{sN} steps): (h1) every rank's request 1 logits vs the "
          f"unsharded kernel path teacher-forced with its tokens on the "
          f"saved state restored onto one device ({h1_s:.1f} s) "
          f"max |d| / max |logit| {max(h1):.4g} (<= {tol}; by rank "
          f"{[round(x, 6) for x in h1]}; no partial sums); (h2) one "
          f"snapshot a request on all {mesh.size} ranks: "
          f"lsn {lsns[0]} then {lsns[1]}, request 1 read the served version "
          f"in all {sN + 1} calls with another published after step "
          f"{FSDP_PUBLISH_AT}, every rank's tokens equal; (h3) "
          f"{hs[0]['gathers']:g} gathers a request (the top-level leaves and "
          f"each of {layers} layers once a call), every rank's KV cache "
          f"{kv}; launches a rank over both requests {per}, "
          f"{sum(h['plain'] for h in hs)} plain attention calls; {card}",
          flush=True)


def _train_rank_checks(out, ref, cfg, label: str, run: str, card: str,
                       on_card: bool) -> None:
    """The sharded train phase's checks of its ranks' `fsdp_rank`
    results against the unsharded step `ref`, each rank's line printed
    first: (f1) step 1's loss, (f2) its gathered gradients and grad norm,
    all within FSDP_TOL; (f3) the resident bytes to the byte; (f4) the
    pinned v1 bitwise; (f5), where the ranks saved, bitwise; one store
    LSN pair on every rank; each rank's flash launches and gathers a
    step (a microbatch of `cfg.microbatches` each: its forward and
    backward launches, its gathers)."""
    for r in out:
        peak = (f"{r['peak_gb']:.2f} GB peak" if r["peak_gb"] is not None
                else "peak not measured (CPU)")
        save = "" if r["f5"] is None else f"save {r['save_s']:.1f} s; "
        print(f"{label} rank {r['rank']} {r['coords']}: init "
              f"{r['init_s']:.1f} s; steps "
              f"{', '.join(f'{t:.1f}' for t in r['step_ms'])} ms; {peak}; "
              f"{r['gathers']:g} gathers and {r['reduce_scatters']:g} "
              f"reduce-scatters a step; launches {r['launches']} over "
              f"{FSDP_STEPS} steps; resident params {r['have']['params']} "
              f"B, opt {r['have']['opt']} B; {save}{card}", flush=True)
    # (f1) step 1's loss, (f2) its gradients and grad norm
    for r in out:
        d = abs(r["losses"][0] - ref["loss"]) / abs(ref["loss"])
        if not d <= FSDP_TOL:
            raise AssertionError(f"(f1) rank {r['rank']} loss "
                                 f"{r['losses'][0]} vs {ref['loss']}")
        d = abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        worst = max(r["f2"].values())
        if not (d <= FSDP_TOL and worst <= FSDP_TOL):
            raise AssertionError(f"(f2) rank {r['rank']} grad_norm "
                                 f"{r['grad_norm']} vs {ref['grad_norm']}, "
                                 f"worst leaf {worst:.4g}")
    # (f3) to the byte, (f4) bitwise, (f5) bitwise
    for r in out:
        if r["have"] != r["plan"]:
            raise AssertionError(f"(f3) rank {r['rank']} holds {r['have']},"
                                 f" the dry-run plans {r['plan']}")
        if not r["f4"]:
            raise AssertionError(f"(f4) rank {r['rank']}: the pinned v1 "
                                 "read changed")
        if r["f5"] is not None and (not r["f5"][0]
                                    or r["f5"][1] is False):
            raise AssertionError(f"(f5) rank {r['rank']}: restored "
                                 f"{r['f5']}")
    if len({r["lsns"] for r in out}) != 1:
        raise AssertionError(f"store lsns by rank {[r['lsns'] for r in out]}")
    A = max(cfg.microbatches, 1)
    per = cfg.n_layers * FSDP_STEPS * A
    for r in out:
        if on_card and r["launches"] != {"flash_attention": per,
                                         "flash_attention_bwd": per}:
            raise AssertionError(f"rank {r['rank']} launches "
                                 f"{r['launches']}")
        if cfg.remat != "none" and \
                r["gathers"] != A * (2 * cfg.n_periods + 1):
            raise AssertionError(f"rank {r['rank']}: {r['gathers']} gathers"
                                 " a step")
    worst = max(max(r["f2"].values()) for r in out)
    leaf = max(out[0]["f2"], key=out[0]["f2"].get)
    pinned, visible = out[0]["lsns"]
    saved = "" if out[0]["f5"] is None else (
        f"(f5) the state saved after step {FSDP_STEPS} restored bitwise "
        f"onto the mesh and onto one device; ")
    print(f"{label} checks ({run}): (f1) step 1's loss on every rank "
          f"{[round(r['losses'][0], 5) for r in out]} vs unsharded "
          f"{ref['loss']:.5f} (<= {FSDP_TOL} relative); (f2) every gathered "
          f"gradient leaf within {worst:.4g} of its max-abs (the worst, "
          f"{leaf}: against the same weights' f32 gradient the unsharded "
          f"bf16 step reads {ref['floor'][leaf]:.4g}, the sharded "
          f"{out[0]['f32'][leaf]:.4g}; worst over the leaves "
          f"{max(ref['floor'].values()):.4g} and "
          f"{max(out[0]['f32'].values()):.4g}), grad_norm "
          f"{[round(r['grad_norm'], 5) for r in out]} vs "
          f"{ref['grad_norm']:.5f} (<= {FSDP_TOL}); (f3) resident params "
          f"{out[0]['plan']['params']} B and opt {out[0]['plan']['opt']} B "
          f"a rank == launch.dryrun.residency; (f4) the reader pinned at "
          f"lsn {pinned} read v1 bitwise after {FSDP_STEPS} publishes "
          f"(visible lsn {visible}) on every rank; {saved}losses "
          f"{[round(x, 5) for x in out[0]['losses']]}; {card}", flush=True)


# ------------------------------------------------------------------ training
@contextlib.contextmanager
def count_plain():
    """Inside the block, calls of the plain versions the train path could
    fall back on (the layers' chunked softmax, `attention_ref`,
    `attention_bwd_ref`, the scans' plain forwards and backwards) are
    counted in the yielded dict; on the card the train path makes
    none."""
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.ssm_scan import ref as SR
    from repro_torch.kernels.wkv_scan import ref as WR
    from repro_torch.models import layers

    calls = {"calls": 0}
    sites = [(layers, "flash_attention_chunked"), (FR, "attention_ref"),
             (FO, "attention_bwd_ref"), (WR, "wkv_scan_plain"),
             (WR, "wkv_scan_bwd_ref"), (SR, "ssm_scan_ref"),
             (SR, "ssm_scan_bwd_ref")]
    saved = [getattr(m, n) for m, n in sites]

    def counted(fn):
        def wrapper(*a, **kw):
            calls["calls"] += 1
            return fn(*a, **kw)
        return wrapper

    for (m, n), fn in zip(sites, saved):
        setattr(m, n, counted(fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(sites, saved):
            setattr(m, n, fn)


@contextlib.contextmanager
def plain_train_scans():
    """Inside the block, the scan ops (`WKVScan`, `SSMScan` and the serve
    path) call the plain forwards and the plain backwards (the explicit
    reverse scans) on the tensors' own device: with `plain_attention`,
    the plain path of the train phase's check (a)."""
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ref as SR
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    sites = [(WK, "wkv_scan", WR.wkv_scan_plain),
             (WK, "wkv_scan_bwd", WR.wkv_scan_bwd_ref),
             (SK, "ssm_scan", SR.ssm_scan_ref),
             (SK, "ssm_scan_bwd", SR.ssm_scan_bwd_ref)]
    saved = [getattr(m, n) for m, n, _ in sites]
    for m, n, fn in sites:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for (m, n, _), fn in zip(sites, saved):
            setattr(m, n, fn)


@contextlib.contextmanager
def checked_scan_bwd():
    """Inside the block, every scan backward launch (`wkv_scan_bwd`,
    `ssm_scan_bwd`) is held against the plain backward on the same
    inputs, run in f64 (so the comparison measures the kernel's f32
    rounding, not the plain version's: at RWKV6-3B's slow decays both
    carry recurrences over 1,024 steps): each gradient within 1e-4 of
    its max-abs (a bf16 du within that plus one bf16 step, 2^-7).  The
    yielded dict counts the launches and keeps the worst ratio."""
    import torch

    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ref as SR
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    seen = {"launches": 0, "worst": 0.0}

    def checked(kernel, plain, names):
        wide = lambda x: x.double() if isinstance(x, torch.Tensor) \
            and x.is_floating_point() else x

        def call(*a, **kw):
            got = kernel(*a, **kw)
            want = plain(*map(wide, a), **{k: wide(x) for k, x in kw.items()})
            for name, x, y in zip(names, got, want):
                if y is None:
                    continue
                ratio = ((x.float() - y.float()).abs().max()
                         / y.float().abs().max().clamp_min(1e-30)).item()
                tol = 1e-4 if x.dtype == torch.float32 else 1e-4 + 2 ** -7
                if not ratio <= tol:
                    raise AssertionError(
                        f"train (a) {kernel.__name__} launch "
                        f"{seen['launches']}, {name}: max |d| / max = "
                        f"{ratio:.4g} > {tol}")
                seen["worst"] = max(seen["worst"], ratio)
            seen["launches"] += 1
            return got
        # the kernel wrapper counts through its module-level name, which
        # is this function while the block runs: share its dict
        call.route_launches = kernel.route_launches
        return call

    saved = WK.wkv_scan_bwd, SK.ssm_scan_bwd
    WK.wkv_scan_bwd = checked(WK.wkv_scan_bwd, WR.wkv_scan_bwd_ref,
                              ("dr", "dk", "dv", "dw_log", "du", "ds0"))
    SK.ssm_scan_bwd = checked(SK.ssm_scan_bwd, SR.ssm_scan_bwd_ref,
                              ("du", "ddt", "dB", "dC", "dA", "dD", "dh0"))
    try:
        yield seen
    finally:
        WK.wkv_scan_bwd, SK.ssm_scan_bwd = saved


@contextlib.contextmanager
def timed_saves():
    """Inside the block, each checkpoint save's wall seconds are appended
    to the yielded list."""
    from repro_torch.checkpoint import manager

    save, times = manager.save, []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = save(*a, **kw)
        times.append(time.perf_counter() - t0)
        return out

    manager.save = timed
    try:
        yield times
    finally:
        manager.save = save


def _leaf_ratios(torch, got, want) -> dict:
    """path -> max |got - want| / max |want| over the float leaves."""
    from repro_torch.tree import leaves_with_path

    out = {}
    for (path, a), b in zip(leaves_with_path(got), [
            x for _, x in leaves_with_path(want)]):
        if a.is_floating_point():
            a, b = a.float(), b.float()
            out["/".join(map(str, path))] = (
                (a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
    return out


def train_config(arch: str):
    """The train phase's config of `arch`: published (or its smoke variant
    with TRAIN_SMOKE), cut as TRAIN_CUT says."""
    from repro_torch.configs import get_config, smoke_variant

    cfg = get_config(arch)
    cfg = smoke_variant(cfg) if TRAIN_SMOKE else cfg
    if arch in TRAIN_CUT:
        cfg = cfg.with_overrides(pattern=cfg.pattern[:1],
                                 n_layers=min(TRAIN_CUT[arch],
                                              cfg.n_layers))
    return cfg


def _train_check_a(torch, cfg, device, S: int) -> str:
    """Check (a): one step's loss and gradients on the kernels against
    the plain path (`plain_attention`, `plain_train_scans`: the plain
    forwards and the plain backwards) on the card, at TRAIN_CHECK_B x
    TRAIN_S: in f32 with TF32 off (loss 1e-5 relative, each leaf within
    1e-3 of its max-abs), and in bf16 on the same weights rounded to the
    bf16 model's dtypes (loss
    3e-2 relative; each leaf's ratio printed beside the bf16 model's own
    distance from the f32 one, the noise floor).  An encoder-decoder's
    frames go in as the train step hands them: in each model's parameter
    dtype."""
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import init_params
    from repro_torch.train.step import _value_and_grad, frames_in_param_dtype
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.with_overrides(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    p32 = init_params(cfg32, gen, device)
    # the same weights in the bf16 model's own dtypes (its f32 leaves,
    # Mamba's A_log, D and dt_bias among them, stay f32)
    p16 = tree_map(lambda x, like: x.to(like.dtype), p32,
                   init_params(cfg, None, "meta"))
    batch = SyntheticPipeline(cfg, batch=TRAIN_CHECK_B, seq_len=S,
                              device=device).batch_at(0)

    def run(c, p, plain):
        with plain_attention() if plain else contextlib.nullcontext(), \
                plain_train_scans() if plain else contextlib.nullcontext():
            loss, grads = _value_and_grad(p, c,
                                          frames_in_param_dtype(c, batch))
        return loss.item(), grads

    out = []
    for label, c, p, tol_loss, tol_leaf in (
            ("f32", cfg32, p32, 1e-5, 1e-3), ("bf16", cfg, p16, 3e-2, None)):
        lk, gk = run(c, p, False)
        lp, gp = run(c, p, True)
        rel = abs(lk - lp) / abs(lp)
        if not (math.isfinite(lk) and rel <= tol_loss):
            raise AssertionError(f"train (a) {label}: loss {lk} != plain "
                                 f"{lp} ({rel:.3g} > {tol_loss})")
        ratios = _leaf_ratios(torch, gk, gp)
        bad = {k: r for k, r in ratios.items()
               if not (tol_leaf is None or r <= tol_leaf)}
        if bad or not all(math.isfinite(r) for r in ratios.values()):
            raise AssertionError(f"train (a) {label}: gradients off plain "
                                 f"beyond {tol_leaf}: {bad}")
        if label == "f32":
            g32 = gp
        else:
            floor = _leaf_ratios(torch, gp, g32)
            for k in ratios:
                print(f"train (a) bf16 leaf {k}: kernel vs plain "
                      f"{ratios[k]:.4g}, bf16 vs f32 noise floor "
                      f"{floor[k]:.4g}", flush=True)
        worst = max(ratios, key=ratios.get)
        out.append(f"{label} loss {lk:.6f} vs plain {lp:.6f} ({rel:.3g} <= "
                   f"{tol_loss}), worst leaf {worst} {ratios[worst]:.3g}"
                   + (f" (<= {tol_leaf})" if tol_leaf else " (printed)"))
        del gk, gp
    del p32, p16, g32
    return "; ".join(out)


def _train_profile(torch, tr, B: int, S: int, at: int) -> None:
    """One more step (of the trainer's state, on batch `at`) timed on the
    host clock, then again under torch.profiler: step ms, tokens/s,
    device busy time and idle share (against the unprofiled step), peak
    memory, device time by kind."""
    from torch.profiler import ProfilerActivity, profile

    batch = tr.pipeline.batch_at(at)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = tr.step_fn(tr.state, batch)[1]     # the new state dropped at once
    float(m["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m = tr.step_fn(tr.state, batch)[1]     # the new state dropped at once
        float(m["loss"])
        torch.cuda.synchronize()
    kinds: dict = {}
    top = []
    for e in prof.key_averages():
        us, name = e.self_device_time_total, e.key
        if us <= 0:
            continue
        top.append((us, e.count, name))
        low = name.lower()
        kind = ("flash backward" if "flash_bwd" in name else
                "flash forward" if "flash_kernel" in name else
                "scan backward" if any(w in name for w in (
                    "wkv_bwd", "ssm_bwd", "sum_leading")) else
                "scan forward" if any(w in name for w in (
                    "wkv_kernel", "ssm_kernel")) else
                "matmul" if any(w in low for w in ("gemm", "gemv", "xmma",
                                                   "cutlass", "splitk",
                                                   "nvjet"))
                else "other")
        kinds[kind] = kinds.get(kind, 0.0) + us
    busy = sum(kinds.values()) / 1e6
    print(f"train profile {tr.cfg.name}: step {step_s * 1e3:.1f} ms, "
          f"{B * S / step_s:.1f} tokens/s ({B}x{S}); device busy "
          f"{busy * 1e3:.1f} ms, idle share {1 - busy / step_s:.4f}; peak "
          f"memory {peak:.2f} GB; by kind: "
          + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                      sorted(kinds.items(), key=lambda kv: -kv[1])),
          flush=True)
    ours = {re.search(r"(flash|wkv|ssm)_\w+", n).group(0): c
            for _, c, n in top if re.search(r"(flash|wkv|ssm)_\w+", n)}
    print("train profile: hand-written kernels in the step (launches): "
          + ", ".join(f"{k} x{c}" for k, c in sorted(ours.items())),
          flush=True)
    for us, n, name in sorted(top, reverse=True)[:12]:
        print(f"train profile device: {us / 1e3:9.3f} ms x{n:6d} "
              f"{name[:90]}", flush=True)


def _train_wrappers(cfg):
    """(forward wrapper, backward wrapper, the key of each in the kernels
    line, the layers that launch them) of the architecture's kernel."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.wkv_scan import kernel as WK

    mixers = {s.mixer for s in cfg.pattern}
    if "rwkv" in mixers:
        return (WK.wkv_scan, WK.wkv_scan_bwd, "wkv_scan chunked",
                "wkv_scan bwd", _n_layers(cfg, mixer="rwkv"))
    if "mamba" in mixers:
        return (SK.ssm_scan, SK.ssm_scan_bwd, "ssm_scan chunked",
                "ssm_scan bwd", _n_layers(cfg, mixer="mamba"))
    # an encoder-decoder adds its cross-attention and encoder layers
    return (FK.flash_attention, FK.flash_attention_bwd, "flash_attention",
            "flash_attention_bwd", _n_layers(cfg, mixer="attn")
            + _n_layers(cfg, cross_attn=True) + cfg.n_encoder_layers)


def train_phase(torch, np, device: str = "cuda",
                arch: str = "qwen1.5-0.5b") -> dict:
    """`arch` trained at full width (`train_config`: Jamba cut to its
    Mamba layers, Qwen2-VL to one layer; bf16, random weights from
    torch.Generator seed 0, TRAIN_B (or TRAIN_BATCH) x TRAIN_S (or
    TRAIN_SEQ) tokens a step; remat and microbatches as its config
    says), with checks (a)-(c), (d) for TRAIN_CRASH_ARCH, and a profiled
    step (see the module docstring).  Returns the launches of its
    kernel's forward and backward over the TRAIN_STEPS steps of (b),
    counted from 0 before each step and read after it, under the kernels
    line's keys, and under a row name of ATTN_ROWS or BWD_ROWS those at
    its shape over (b) (the requests served between steps included),
    where any.  (`device="cpu"` is a rehearsal: the plain versions run,
    nothing launches, nothing is profiled.)"""
    from repro_torch.kernels.cuda_build import launch_count, reset_counts
    from repro_torch.serve import ServingEngine
    from repro_torch.tensorstore import VersionedParamStore
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves

    on_card = device == "cuda"
    cfg = train_config(arch)
    B, S = TRAIN_BATCH.get(arch, TRAIN_B), TRAIN_SEQ.get(arch, TRAIN_S)
    t0 = time.perf_counter()
    cfg_a = cfg.with_overrides(n_layers=TRAIN_CHECK_LAYERS[arch]) \
        if arch in TRAIN_CHECK_LAYERS else cfg
    print(f"train (a) {arch}: {_train_check_a(torch, cfg_a, device, S)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if on_card:
        torch.cuda.empty_cache()

    # (b) train while serving, (c) launches per step
    fwd, bwd, fwd_key, bwd_key, n = _train_wrappers(cfg)
    wrappers = (fwd, bwd)
    A = max(cfg.microbatches, 1)
    want = {fwd_key: n * A * (2 if cfg.remat == "full" else 1),
            bwd_key: n * A}
    store = VersionedParamStore(slots=2)
    tr = Trainer(cfg, batch=B, seq_len=S, seed=0, store=store,
                 publish_every=1, device=device)
    pin_us, pin_fn = [], store.pin_snapshot

    def timed_pin():                               # every reader's pin
        t = time.perf_counter()
        out = pin_fn()
        pin_us.append((time.perf_counter() - t) * 1e6)
        return out

    store.pin_snapshot = timed_pin
    pin, v1 = store.pin_snapshot()                 # a reader pins v1
    # its copy on the host: RWKV6-3B's 6.2 GB would not fit the card
    # beside the trainer's two versions of the moments
    v1_copy = [x.to("cpu", copy=True) for x in leaves(v1)]
    Bq, Sq, Nq = TRAIN_SERVE
    eng = ServingEngine(cfg, store, max_seq=Sq + Nq, device=device)
    # the request's prompts and any frontend inputs (Whisper's frames,
    # Qwen2-VL's vision stub on its M-RoPE grid)
    request = serve_batch(torch, np, cfg, arch, Bq, Sq, device)
    per_step, lsns = [], []

    def after_step(i, metrics):
        per_step.append({fwd_key: launch_count(fwd),
                         bwd_key: launch_count(bwd)})
        eng.refresh()
        lsns.append(eng.generate(request, Nq).snapshot_lsn)
        reset_counts(wrappers)                     # serving is not the step

    reset_counts(wrappers)
    t0 = time.perf_counter()
    with count_plain() as plain, record_attention_shapes() as shapes:
        log = tr.run(TRAIN_STEPS, after_step=after_step)
    wall = time.perf_counter() - t0
    losses = [m["loss"] for m in log]
    same_v1 = all(torch.equal(a.cpu(), b)
                  for a, b in zip(leaves(v1), v1_copy))
    store.release(pin)
    aborts = sum(r.type == "abort" for r in store.wal.records)
    if not (same_v1 and all(math.isfinite(x) for x in losses)
            and all(b > a for a, b in zip(lsns, lsns[1:])) and aborts == 0
            and store.stats["publishes"] == TRAIN_STEPS + 1):
        raise AssertionError(
            f"train (b) {arch}: v1 unchanged {same_v1}, losses {losses}, "
            f"snapshot lsns {lsns}, aborts {aborts}, publishes "
            f"{store.stats['publishes']}")
    if on_card and (any(c != want for c in per_step) or plain["calls"]):
        raise AssertionError(f"train (c) {arch}: launches per step "
                             f"{per_step} != {want}, plain calls "
                             f"{plain['calls']}")
    n_params = sum(x.numel() for x in leaves(tr.state["params"]))
    print(f"train (b) {arch}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters, {A} microbatch(es); {TRAIN_STEPS} steps of "
          f"{B}x{S} in {wall:.1f} s with a {Bq}x"
          f"{request['tokens'].shape[1]} + {Nq}-step "
          f"request served between steps; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; reader "
          f"pinned at v1 reads v1 bitwise after step {TRAIN_STEPS}; snapshot "
          f"lsns {lsns}; store {store.stats['publishes']} publishes, "
          f"{store.stats['gc_blocked']} of them grew the ring instead of "
          f"waiting; {len(pin_us)} reader pins, the longest "
          f"{max(pin_us):.1f} us (a pin selects a slot: no wait path); "
          f"{aborts} aborts in the WAL", flush=True)
    by_shape = ", ".join(f"{k[0]} {k[1:]} {n}"
                         for k, n in sorted(shapes.items()))
    print(f"train (c) {arch}: launches per step {per_step[0]} (remat "
          f"{cfg.remat!r}, {A} microbatch(es): {want}), plain calls "
          f"{plain['calls']}; by shape over the steps and requests: "
          f"{by_shape or 'none'}", flush=True)
    del store.pin_snapshot         # the timed pin holds the store: a cycle
    launches = {k: sum(c[k] for c in per_step) for k in want}
    launches.update({row: shapes[key] for row, key in
                     (*ATTN_ROWS.values(), *BWD_ROWS.values())
                     if shapes[key]})
    del eng, v1, v1_copy
    if on_card:
        torch.cuda.empty_cache()
    if fwd_key != "flash_attention":
        # (a) per launch: every scan backward of one full-depth bf16 step
        with checked_scan_bwd() as seen:
            # the new state is dropped at once: a second one would not fit
            m = tr.step_fn(tr.state, tr.pipeline.batch_at(TRAIN_STEPS))[1]
            float(m["loss"])
        if seen["launches"] != want[bwd_key]:
            raise AssertionError(f"train (a) {arch}: {seen['launches']} "
                                 f"backward launches held, {want[bwd_key]} "
                                 "expected")
        print(f"train (a) {arch}: {seen['launches']} {bwd.__name__} "
              f"launches of a full-depth bf16 step, each gradient within "
              f"1e-4 of its max-abs of the plain backward (bf16 du: + "
              f"2^-7), worst {seen['worst']:.3g}", flush=True)
    if on_card:
        _train_profile(torch, tr, B, S, TRAIN_STEPS)
    del tr, store
    gc.collect()                   # the trainer's closures hold cycles
    if on_card:
        torch.cuda.empty_cache()
    if arch != TRAIN_CRASH_ARCH:
        return launches

    # (d) crash and restore at a depth cut, full width
    cfg_d = cfg.with_overrides(n_layers=TRAIN_CRASH_LAYERS)
    ckdir = TRAIN_CKPT
    shutil.rmtree(ckdir, ignore_errors=True)
    t1 = Trainer(cfg_d, batch=TRAIN_B, seq_len=TRAIN_S, seed=0,
                 device=device)
    t1.run(6)
    t2 = Trainer(cfg_d, batch=TRAIN_B, seq_len=TRAIN_S, seed=0,
                 ckpt_dir=str(ckdir), ckpt_every=2, device=device)
    t0 = time.perf_counter()
    with timed_saves() as saves:
        t2.run(6, inject_failure_at=4)
    wall = time.perf_counter() - t0
    shutil.rmtree(ckdir, ignore_errors=True)
    for a, b in zip(leaves(t1.state["params"]), leaves(t2.state["params"])):
        if not torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-6):
            raise AssertionError("train (d): the restored run's parameters "
                                 "differ from the uninterrupted run's")
    n_params = sum(x.numel() for x in leaves(t2.state["params"]))
    del t1, t2
    gc.collect()
    print(f"train (d): {TRAIN_CRASH_LAYERS} of {cfg.n_layers} layers at "
          f"full width ({n_params / 1e6:.1f} M parameters): run(6, "
          f"inject_failure_at=4) with a save every 2 steps ({len(saves)} "
          f"saves, {', '.join(f'{s:.1f}' for s in saves)} s) == run(6) "
          f"(rtol 1e-5, atol 1e-6); {wall:.1f} s", flush=True)
    return launches


def launch_phase(torch, device: str = "cuda") -> dict:
    """`python -m repro_torch.launch.train` and `... .serve` with
    LAUNCH_TRAIN / LAUNCH_SERVE (plus `--device`), each `main` called
    in this process with its output
    captured: train's metrics lines finite, its last step 2, 4
    published versions and a checkpoint at step 2 under LAUNCH_CKPT
    (removed after); serve's line with (2, 8) tokens at lag 0.  Returns
    the attention kernels' launches over both, counted from 0 before and
    read after, and under a row name of ATTN_ROWS or BWD_ROWS those at
    its shape, where any."""
    from repro_torch.checkpoint import manager
    from repro_torch.kernels.cuda_build import launch_count, reset_counts
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch import serve, train

    wrappers = {name: _kernel_wrappers()[name] for name in
                ("flash_attention", "decode_attention")}
    wrappers["flash_attention_bwd"] = FK.flash_attention_bwd
    extra = ["--device", device]
    shutil.rmtree(LAUNCH_CKPT, ignore_errors=True)
    reset_counts(wrappers.values())
    out = {}
    t0 = time.perf_counter()
    with record_attention_shapes() as shapes:
        for name, mod, argv in (("train", train, LAUNCH_TRAIN),
                                ("serve", serve, LAUNCH_SERVE)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(argv + extra)
            out[name] = buf.getvalue().splitlines()
            if rc != 0:
                raise AssertionError(f"launch {name}: exit {rc}")
            for line in out[name]:
                print(f"launch {name}: {line}", flush=True)
    saved = manager.latest_step(str(LAUNCH_CKPT))
    shutil.rmtree(LAUNCH_CKPT, ignore_errors=True)
    steps = [json.loads(x) for x in out["train"] if x.startswith("{")]
    if not (steps and all(math.isfinite(m["loss"]) for m in steps)
            and steps[-1]["step"] == 2 and saved == 2
            and "published versions: 4" in out["train"]):
        raise AssertionError(f"launch train: {out['train']}, checkpoint "
                             f"at step {saved}")
    if not re.fullmatch(r"arch=\S+ generated \(2, 8\) tokens @snapshot "
                        r"lsn \d+ \(lag 0\)", out["serve"][-1]):
        raise AssertionError(f"launch serve: {out['serve']}")
    launches = {name: launch_count(fn) for name, fn in wrappers.items()}
    if device == "cuda" and not all(launches.values()):
        raise AssertionError(f"launch: a kernel never launched {launches}")
    launches.update({row: shapes[key] for row, key in
                     (*ATTN_ROWS.values(), *BWD_ROWS.values())
                     if shapes[key]})
    print(f"launch phase: train and serve launchers on {device}, checkpoint "
          f"at step {saved}, launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def _ptxas_report(log: str) -> list:
    """nvcc's `-Xptxas -v` output as one line per kernel: its name
    (demangled by c++filt where the machine has it), registers, shared
    memory and spills; and any line that reports an error."""
    out, kernel, spill = [], "", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel, spill = entry.group(1), ""
            if shutil.which("c++filt"):
                kernel = subprocess.run(
                    ["c++filt", kernel], capture_output=True,
                    text=True).stdout.strip() or kernel
                kernel = re.sub(r"^void |\([^()]*\)$", "", kernel.replace(
                    "(anonymous namespace)::", ""))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split(":", 1)[1].strip()
            out.append(f"{kernel}: {used}; {spill}")
        elif "error" in line:
            out.append(line.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="profile the driver phase (cProfile + "
                    "torch.profiler) and write the reports into DIR")
    args = ap.parse_args()

    # RWKV6-3B's train phase holds three published versions, two versions
    # of the f32 moments in AdamW's update and the gradients (~69 GiB):
    # segments that grow in place keep the freed activations' memory from
    # staying split around live tensors
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT / 'chip_smoke.py'}"
              ": run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.rss_gather import kernel as RG
    from repro_torch.kernels.rss_scan_agg import kernel as K_mod
    from repro_torch.kernels.version_gather import kernel as VG

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    libs = cuda_build.build()
    names = ", ".join(str(p.relative_to(ROOT)) for p in libs.values())
    print(f"build: {names} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in cuda_build.BUILD_LOGS.items():
        for line in _ptxas_report(log):
            print(f"ptxas {name}: {line}", flush=True)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    results = kernel_phase(torch, np, K_mod, flush)
    results.update(attention_kernel_phase(torch, np, flush))
    results.update(attention_bwd_phase(torch, np, flush))
    results["wkv_scan"] = wkv_kernel_phase(torch, np, flush)
    results["ssm_scan"] = ssm_kernel_phase(torch, np, flush)
    results.update(scan_bwd_phase(torch, np, flush))
    del flush
    torch.cuda.empty_cache()
    small_driver_phase()
    launches = driver_phase(torch, K_mod, ROUNDS, args.profile)
    torch.cuda.empty_cache()

    # the snapshot-read paths: gather launches counted from 0 in each
    for label, phase in (("path", lambda: path_phase(torch, PATH_TXNS)),
                         ("param store",
                          lambda: param_store_phase(torch))):
        RG.reset_launches()
        VG.reset_launches()
        phase()
        for fn in (VG.version_gather, RG.rss_gather):
            n = cuda_build.launch_count(fn)
            if n == 0:
                raise AssertionError(f"{fn.__name__} never launched")
            launches[fn.__name__] = launches.get(fn.__name__, 0) + n
            print(f"{label} phase launches: {fn.__name__} {n} by route "
                  f"{fn.route_launches} (last: "
                  f"{_gather_launch_txt(fn.last_route)})", flush=True)
    print(f"path launches: version_gather {launches['version_gather']} "
          f"rss_gather {launches['rss_gather']}", flush=True)
    torch.cuda.empty_cache()
    # the serve paths, one per architecture and one per long-context
    # shape: each counts its kernels' launches from 0 over its two
    # requests (summed over the paths that share a kernel); each frees its
    # model before the next
    for arch, long in [*((a, False) for a in SERVE_KERNELS),
                       *((a, True) for a in SERVE_LONG)]:
        t0 = time.perf_counter()
        for name, n in serve_phase(torch, np, arch=arch, long=long).items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()
        print(f"serve phase {arch}{' long context' if long else ''}: "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still "
              "allocated", flush=True)
    # the sharded serve paths, one per architecture: their ranks'
    # launches at the per-rank shapes; Qwen2-VL's on the nccl route too
    # where the machine has a card a rank
    for arch in TP_ARCHS:
        t0 = time.perf_counter()
        for row, n in tp_serve_phase(torch, np, arch=arch).items():
            launches[row] = launches.get(row, 0) + n
        torch.cuda.empty_cache()
        print(f"tp serve phase {arch}: {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still "
              "allocated", flush=True)
    # the fallback serve step: a model whose shard passes the resident
    # limit, served gathered under the placement the rule falls back on
    t0 = time.perf_counter()
    for row, n in fallback_serve_phase(torch, np).items():
        launches[row] = launches.get(row, 0) + n
    torch.cuda.empty_cache()
    print(f"fallback serve phase: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated",
          flush=True)
    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh = (1, 4 if cards >= 4 else 2)
        nccl = tp_serve_phase(torch, np, backend="nccl", mesh_shape=mesh)
        if mesh == TP_MESH:             # launches at the rows' shapes
            for row, n in nccl.items():
                launches[row] += n
    else:
        print(f"tp serve: the nccl route (one card a rank) was not run: "
              f"{cards} card on this machine", flush=True)
    torch.cuda.empty_cache()
    # the train paths: launches of each one's kernels over its steps
    for arch in TRAIN_ARCH:
        t0 = time.perf_counter()
        for name, n in train_phase(torch, np, arch=arch).items():
            launches[name] = launches.get(name, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
        print(f"train phase {arch}: {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still "
              "allocated", flush=True)
    # the sharded train path: its ranks' flash launches, the backward's
    # also in the per-rank row; the nccl route where the machine has a
    # card a rank
    t0 = time.perf_counter()
    runs = [fsdp_train_phase(torch, np)]
    if cards >= FSDP_MESH[0] * FSDP_MESH[1]:
        runs.append(fsdp_train_phase(torch, np, backend="nccl"))
    else:
        print(f"fsdp train: the nccl route (one card a rank) was not run: "
              f"{cards} card on this machine", flush=True)
    for got in runs:
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    print(f"fsdp train phase: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated",
          flush=True)
    # the launchers, as a user starts them
    for name, n in launch_phase(torch).items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    scan_rows = [(f"{name}{suffix}", name, key, launches[f"{name} {route}"])
                 for name in (*WKV_TPU, *SSM_TPU)
                 for suffix, key, route in (("", "times", "chunked"),
                                            (" step", "times_step", "step"))]
    # ... and the scans' at one rank's shape of the sharded serve phase
    scan_rows += [(row, name, key, launches.get(row, 0))
                  for name, tp_rows in (("ssm_scan", TP_SSM_ROWS),
                                        ("wkv_scan", TP_WKV_ROWS))
                  for key, row in tp_rows.values()]
    for name in (*ATTN_TPU, *ATTN_BWD_TPU, *WKV_TPU, *SSM_TPU):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched")
    bwd_rows = [(name, name, "times", launches[name])
                for name in ("wkv_scan bwd", "ssm_scan bwd")]
    # the attention kernels' rows at single shapes, launched at them in
    # the serve phases
    shape_rows = [(row, row, "times", launches.get(row, 0))
                  for row in (*(r for r, _ in ATTN_ROWS.values()),
                              *TP_ROWS.values(),
                              *FSDP_SERVE_ROWS.values(),
                              *FALLBACK_ROWS.values(),
                              *(r for r, _ in BWD_ROWS.values()),
                              *FSDP_ROWS.values())]
    for row, _, _, n in scan_rows + bwd_rows + shape_rows:
        if n == 0:
            raise AssertionError(f"{row} never launched")

    replaces = {"rss_scan_agg": f"{TPU_SRC}:189",
                "rss_scan_agg_grouped": f"{TPU_SRC}:260",
                "rss_scan_agg_chunked": f"{TPU_SRC}:405",
                "rss_delta_fold": f"{TPU_SRC}:524", **GATHER_TPU}
    rows = []
    for name, where in replaces.items():
        ms, plain_ms, bound_ms = results[name]["times"]
        rows.append({"name": name, "route": "cuda",
                     "source": GATHER_SRC if name in GATHER_TPU else SRC,
                     "replaces": where, "launches": launches[name],
                     "max_abs_err": results[name]["max_abs_err"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "library_ms": None})
    sources = {**{n: ATTN_SRC for n in (*ATTN_TPU, *ATTN_BWD_TPU)},
               **{row: ATTN_SRC for row, _ in (*ATTN_ROWS.values(),
                                                *BWD_ROWS.values())},
               **{row: ATTN_SRC for row in (*TP_ROWS.values(),
                                            *FSDP_SERVE_ROWS.values(),
                                            *FALLBACK_ROWS.values(),
                                            *FSDP_ROWS.values())},
               **{n: WKV_SRC for n in (*WKV_TPU, "wkv_scan bwd")},
               **{n: SSM_SRC for n in (*SSM_TPU, "ssm_scan bwd")}}
    tpu = {**ATTN_TPU, **ATTN_BWD_TPU, **WKV_TPU, **SSM_TPU,
           **{row: ATTN_TPU[shape[0]] for row, shape in ATTN_ROWS.values()},
           **{row: ATTN_TPU[row.split()[0]]
              for row in (*TP_ROWS.values(), *FSDP_SERVE_ROWS.values(),
                          *FALLBACK_ROWS.values())},
           **{row: ATTN_BWD_TPU[shape[0]] for row, shape in BWD_ROWS.values()},
           **{row: ATTN_BWD_TPU["flash_attention_bwd"]
              for row in FSDP_ROWS.values()},
           "wkv_scan bwd": WKV_TPU["wkv_scan"],
           "ssm_scan bwd": SSM_TPU["ssm_scan"]}
    # the scans have two kernels each: a row per kernel, with the
    # launches of its route
    rows_of = [(name, name, "times", launches[name])
               for name in (*ATTN_TPU, *ATTN_BWD_TPU)]
    for row, name, key, n in rows_of + shape_rows + scan_rows + bwd_rows:
        ms, plain_ms, bound_ms, library_ms, by = results[name][key]
        rows.append({"name": row, "route": "cuda",
                     "source": sources[name],
                     "replaces": tpu[name],
                     "launches": n,
                     "max_abs_err": results[name]["max_abs_err"],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": by, "library_ms": library_ms})
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
