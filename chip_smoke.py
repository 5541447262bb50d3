"""Drive the port on one NVIDIA H100 and hold every kernel against its plain
PyTorch version.

    python3 chip_smoke.py [--parent DIR]

(--parent DIR: DIR holds a checkout of an earlier commit; phase 2 also
builds its csrc/verify.cu, verify_cached.cu, comb_fill.cu, verify_split.cu,
sha256_iter32.cu, sha256_msg.cu, keccak256_msg.cu, sha512_batch.cu,
blake3_msg.cu, lthash_combine.cu, fe_mul_chain.cu, probe.cu and
gf256_apply.cu (PARENT_KERNELS lists each library's C entry points and
their arguments), and phases 2b, 3, 4, 6, 8, 9, 12, 14, 16, 18 and 19 time
those probe_conv, K2, K1, K3, K4, K5, K6, K7, K9, K10, K11, K12, K13, K14,
K15, K16 and K17 beside this tree's, each after its outputs are checked
equal: [probe_conv-ab], [K2-ab], [K1-ab], [K3-ab], [K4-ab], [K5-ab],
[K6-ab], [K7-ab], [K9-ab], [K10-ab], [K11-ab], [K12-ab], [K13-ab],
[K14-ab], [K15-ab], [K16-ab], [K17-ab]; [K5-launches] (phases 17-17b) adds the parent's time
at each launch shape.  It also
builds this tree's fe_mul_chain.cu, lthash_combine.cu and sha256_msg.cu
again with one knob set at compile time (KNOB_BUILDS), and phases 3, 16
and 18 time each knob's values in turns after checking their outputs
equal: [K2-knobs] (K2_KNOBS: every product IMAD.WIDE against this tree's
DFMA split, all else equal), [K13-knobs]
(clusters of 4, 8 and 16 blocks; at its own size, the chunk rules of
K13_CHUNK_RULES) and [K15-knobs] (one warp pair a block against four, at
K15_KNOB_BATCHES).  Phase 3 also prints the chain loop by opcode of the
parent's K2 and of the knob builds.)

Phases, in order; any failure ends the script with a nonzero exit and no
result line (2 without a CUDA device, 1 without the package beside the
script or when a phase fails):

  1. device   name, count, capability, nvidia-smi name and power limit;
              TF32 off for matmuls (the K5 plain version's float32 product
              is exact either way for 0/1 inputs; the script says so)
  2. build    nvcc builds csrc/*.cu (one process per source, in parallel)
  2b. probes  probe_add over (8, 128) int32 and probe_conv over (20, 512)
              int32 x2 -> (39, 512): equal to the plain versions and Python
              ints; probe_conv also at B = 16,384 and 65,536 on full int32
              rows with the extremes (wraparound), equal to plain;
              probe_add and torch.add timed per call and device only,
              probe_conv device only at the three batches in turns with
              them (past 512 on rotating copies of its inputs and
              outputs, twice the L2 a turn, so HBM serves them), and
              probe_add's host cost split into its pieces (checks,
              allocation, pointers, stream lookup, the ctypes call, the
              launch, the binder), 10,000 calls a piece; with
              --parent, the parent's probe_conv at the three batches
              (outputs equal, then times in turns, timed as above): one
              [probe_conv-ab] line
  3. K2       fe_mul_chain at B = 16,384, k = 64, its first 64 lanes at the
              carried extremes: raw limbs equal to the plain version, equal
              to Python ints on sampled lanes, and at B = 1,024 (the verify
              batch) and 65,536 (four warps a scheduler), and at k = 65
              (the odd split step); timed device only at each, beside a
              bound taken pipe by pipe (DFMA, IMAD.WIDE, issue); its chain
              loop by opcode from the SASS ([K2-sass]); with --parent, the
              parent's K2 ([K2-ab]) and this tree's built with each of
              K2_KNOBS ([K2-knobs]), limbs equal, then times in turns
  4. K3       sha512_batch at B = 4,096, max_len 1,296, lengths across the
              padding boundaries: equal to hashlib and the plain version;
              the same rows from an offset buffer (the narrow path), 4,091
              lanes (a ragged last block) and 64 lengths out of range (zero
              digests): each equal to hashlib on every lane and to plain on
              the first and last 1,024; timed device only (wide, narrow,
              4,091 lanes) and per call beside its bound; with --parent,
              the parent's K3 on the same four batches (bytes equal, then
              times in turns): one [K3-ab] line
  5. K1       verify_batch at B = 1,024, max_msg_len 1,232 on a seeded mixed
              batch: mask equal to the plain version and to ed25519_ref
              labels, ok-count equal to the mask's sum
  6. K1 time  B = 16,384 and 1,024, max_msg_len 1,232, CUDA events, per call
              and device only; plain version too; with --parent, the
              parent's K1 on the same inputs (mask on phase 5's batch, then
              times in turns): one [K1-ab] line
  7. pipeline build_verify_pipeline (benchg -> verify -> dedup -> sink) at
              batch 1,024, max_msg_len 1,232, the verify stage on its sweep
              client: exact counters, K1 launched once per sealed C slot;
              then once on the drain-table intake (native_client=False),
              checked the same: both lanes' batches and txn/s
  8. K4       sha256_iter32 at n = 12,500 (hashes_per_tick) and B = 4 (the
              sharded leader block's chains), 64 (the plane's: one slot's
              tick spans) and 4,096: 32 lanes equal to hashlib, B = 4 and 64
              equal to the same chains at 4,096, all lanes equal to the plain
              version at n = 64; each B timed beside its operations bound,
              the round warp's issue time (its SASS instructions a hash,
              cuobjdump, at 2 clocks each) and the chain floor estimate;
              with --parent, the parent's K4 at each B (bytes equal, then
              times in turns): one [K4-ab] line
  9. K5       gf256_apply at the shapes its paths launch (K5_SHAPES: the
              leader block's (1, 27 x 19, 1,019) and (1, 22 x 8, 1,039)
              encodes, the lossy store's (1, 46 x 19, 1,019) rebuild, 64
              per-set recover matrices (64 x 32) x 1,024 from
              recover_batch's erasure patterns, the plane's batch encode of
              1,024 sets of (32 + 32) x 1,024): equal to the plain version
              (GF(2) bit matmul in float32) and gf256_ref; recover_batch over
              those 64 sets: statuses and rebuilt bytes; at T = 2 and S in
              K5_EDGE_S, k in K5_EDGE_K, from aligned and offset buffers,
              shared matrices and per-set ones of m = 2k rows (recover's n
              = d + p up to 134), and 512 sets of (27 x 19) x 1,019 and
              x 1,024 (a warp looping over 16 column groups on either
              load path): equal to plain; all-zero data and an
              all-zero matrix give zeros; each timed shape device only
              beside its bounds (bytes, the table form's instructions, the
              tensor-core form's int8 operations, and the least of them)
              and probe_add's device-only time; the kernel's loops by
              opcode from `python -m firedancer_tpu_torch.utils.sass`
              ([K5-sass]: fails without IMMA/HMMA in a loop, or with
              single-byte shared loads in one); with --parent, the
              parent's K5 at each timed shape (bytes equal, then times in
              turns): one [K5-ab] line
  10. plane   build_sharded_verify_pipeline (benchg -> router -> plane step
              -> dedup -> sink), one shard at batch 1,024, PoH spans of
              12,500 hashes, FEC (32, 32, 1,024), over phase 7's stream, with
              one slot's 64 tick spans (3 corrupted) parked mid-run, then
              the plane's encode_parity and verify_poh_segments: phase 7's
              counters and frames, 61/3 spans, exact K1/K4/K5 launch counts
  10b. repeat phases 7 and 10 again, four rounds in alternating order, each
              run checked as before: median, min and max txn/s of both and
              of their ratio within a round
  11. entry   entry.leader_step() once (dryrun_multichip's assertions)
  12. comb    the comb lane's kernels alone, over 1,536 voter keys from a
              seed: K7 comb_fill at M = 32 and at M = 1,544 (the voters plus
              8 edge keys: torsion, non-square y, a non-canonical y), tables
              and ok equal to comb_fill_plain on the card (every column) and
              ok to ed25519_ref, 4 entries of 64 sampled columns to Python
              ints; K8 bank_install of the 1,536 tables into a 2,048-slot
              bank equal to index_copy_, untouched slots zero, a reinstall;
              K6 verify_cached at B = 16,384 of the voters' votes with
              corrupted lanes: mask equal to K1's and to the labels, and at
              B = 1,024 to verify_cached_plain; all timed, K6 beside its
              bound at B = 16,384 and 1,024; with --parent, the parent's
              K6 at B = 1,024 and 16,384 (masks and counts equal) and K7
              at M = 32 and 1,544 (ok equal, tables equal on canonical
              limbs), each timed in turns: one [K6-ab] and one [K7-ab] line
  13. comb pipeline  build_verify_pipeline(comb_slots=2,048,
              promote_threshold=2) over a vote-heavy stream (1,536 voters x
              4 slots, 2,048 transfers) in two waves, beside the same stream
              through comb_slots=0: exact counters, comb_filled and
              comb_elems, equal sorted frames, K1/K6/K7/K8 launches equal the
              stage's batches, cached batches, fills and installs; then 2
              more alternating rounds of both: medians and spread of txn/s
  14. split   the split rung's kernels alone: K9 phase_validate, K10
              phase_hash, K11 phase_dsm and K12 phase_compare at B = 16,384
              and max_msg_len 1,232 on phase 5's mixed batch (tiled 16
              times): mask equal to K1's and to the ed25519_ref labels, K9's
              limbs and ok and K10's k on its last 1,024 lanes equal to
              their plain versions; at B = 1,024 each phase's output
              (limbs, k, ok, mask) equal to its plain version; K12 at B =
              1, 31, 33, 1,023, 1,024 and 16,384 (K12_BATCHES) with ok
              cleared on a seeded quarter more of the lanes and random bits
              in r_pt wherever ok is false: mask equal to its plain version
              and to the labels; K12's SASS as one block ([K12-sass]:
              `utils.sass` `whole`; fails unless a thread waits for one
              global round trip); each timed
              alone on phase 6's batch at B = 16,384 and 1,024 beside K1,
              per call and device only, with its own bounds; with
              --parent, the parent's K11 on the mixed batch at B = 1,024
              and 16,384 (masks through K12 equal, points equal where A
              decodes, then times in turns), K9 (ok equal, limbs equal
              where the point decodes) and K10 (k equal) on the mixed
              batch, each then timed in turns on phase 6's batch at B =
              1,024 and 16,384, and K12 (masks equal at every K12_BATCHES
              batch, then times in turns on phase 6's batch through K9-K11
              at B = 1,024 and 16,384, and the parent's SASS beside this
              tree's in [K12-sass]): [K11-ab], [K9-ab], [K10-ab] and
              [K12-ab] lines
  15. split pipeline  build_verify_pipeline(kernel="split") over phase 7's
              stream at batch 1,024: phase 7's counters and frames, each of
              K9-K12 launched once per batch and K1 never; beside the fused
              pipeline, then 2 more alternating rounds of both: medians and
              spread of txn/s and of their ratio
  15b. plane hook  the same stream through VerifyStage(plane=ServePlane(...))
              (one shard, batch 1,024): phase 7's counters and frames, K1
              once per batch, K4 never (the hook parks no PoH span)
  15c. autotune  phase 13's vote stream at batch 2,048 and max_msg_len 1,232
              through comb_slots=0, once with autotune_after=2 and once
              without: retunes >= 1, a smaller geometry, phase 13's counters
              and equal sorted frames, K1 once per batch
  16. K13     lthash_combine at N = 1, 17, 1,040 (phase 17's seal), 2,048
              and 65,536 seeded rows with signs in {-1, 0, 1}: equal to its
              plain version, signed and unsigned, and to the JAX seal's
              power-of-two padded rows; the last three timed beside their
              bound and one torch.sum over the pre-signed int32 rows (the
              sign multiply left out of that call); one call's device
              kernels from a torch.profiler trace (K13 alone; an empty
              trace fails too); with --parent, [K13-ab] and [K13-knobs] at
              N = 1,040, 2,048 and 65,536
  17. leader  build_leader_pipeline (benchg -> verify -> pack, dedup
              fused into pack's native lane -> bank x2 -> poh -> shred ->
              store, over shared-memory links with the native ring
              endpoints; every leader phase takes that default lane, the
              banks the native executor lane inside the bank sweep lane and
              verify its sweep client; here the shred stage keeps the
              Python shredder (native_shred=False), whose K5 calls the
              [K5-launches] recording takes; the
              host libraries built with g++ in phase 2 beside the kernels'
              nvcc) over 8,192 transfers (8
              payers, 1,024 destinations) at batch 1,024 and max_msg_len
              1,232, pack's pool 8,192 deep, then seal: every txn landed, the deshredded store bytes
              equal PoH's entries, replay_block reproduces the seal, K13
              once per seal, K5 once or twice per shredded entry batch, K1
              once per verify batch, native_exec > 0; txn/s to the store
              and the host seconds per stage and seal phase; then
              [leader-rings]: the same pool four times more, warm, on the
              native and Python rings in turns (no seal): txn/s, sweeps and
              host seconds per stage.  Phases 17,
              17d, 17f, 17g and 17h each print a [native-exec] line: the
              banks' native_exec and native_punt counts
  17b. lossy  phase 17's FEC sets with 1 to p shreds of each dropped,
              through a full-verification StoreStage (merkle proof per
              shred, the leader's signature by ed25519_ref): the same entry
              bytes, K5 once per set that lost a data shred; then
              [K5-launches]: every K5 launch of phases 17 and 17b by its
              (T, m x k, S), each shape timed alone on its first launch's
              inputs beside its least bound (with --parent, the parent's
              time too), and each phase's sum of (time - bound)
  17c. sharded  build_sharded_leader_pipeline over the same pool on a
              one-shard plane with PoH spans of 12,500 hashes (the PoH
              stage's hashes_per_tick): the clock runs on until one pure
              tick is parked; spans verified by K4 (>= 1 launch), K13
              once, K5 through encode_parity, K1 once per step; the same
              landed txns and sealed state as phase 17, and replay
              reproduces this pipeline's seal
  17d. vote leader  build_leader_pipeline over phase 13's vote stream
              (1,536 voters x 4 slots, 2,048 transfers) with the comb lane
              on (verify_comb_slots = 2,048) at batch 1,024, max_msg_len
              1,232, 2 banks, pack's pool the stream's length, over
              vote_bank_ctx (payers and voters funded, each voter's vote
              account, SlotHashes for the voted slots): every distinct
              verified txn landed (txns and signatures), the block's txns
              are the verified ones, replay_block (with the slot hashes)
              reproduces the seal and its statuses, K6, K7 and K8 launched
              (K1/K6/K7/K8 launches equal the stage's batches and fills),
              K13 once, K5 once or twice per entry batch, every vote
              account decodes and the towers hold every vote that landed
              ok (at least one); txn/s to the store, votes landed, host
              seconds per stage beside phase 17's, the seal's seconds
  17e. clocked leader  build_leader_pipeline over phase 17's pool with 256
              durable-nonce transfers mixed in (one every 32 txns), batch
              1,024, 2 banks, pack's pool the stream's length, over
              nonce_bank_ctx, against a slot clock of 16 slots of 400 ms
              and 64 ticks (mainnet's cadence; hashes_per_tick stays the
              pipeline's default 64, where mainnet's 12,500 would cost the host PoH
              chain ~800 k hashlib calls a slot), grace 100 ms: the window
              is driven until PoH closes it and the stream is sent (a 60 s
              wall cap fails the phase), then finish, seal and replay, five
              times: (a) unfused, (b) fuse_poh_shred=True, (c)
              shed_keep=256, (d) as (a) on the Python pack lane
              (native_pack=False: the dedup stage and PackStage), (e) as
              (a) on the Python executor lane (native_exec=False), (f) as
              (a) on the Python shm rings (native_ring=False: no drain
              plan and no bank sweep lane), each with keep_sets=False: on
              the native rings the shred stage runs the native shredder's
              sweep client and verify its sweep client, on (f) the
              shredder's batch mode and the Python verify intake.
              Each: sealed + missed = 16 with one sealed at least, ticks +
              skipped ticks = 64 x 16, 1 <= blocks_closed <= 16, landed +
              shed = the verified txns and none dropped, the deshredded
              store bytes equal PoH's entries, replay_block reproduces the
              seal and its statuses, every landed durable txn ok and every
              nonce advanced against the parent bank hash if its txn landed
              or kept if it was shed, K1 once per verify batch, K5 once or
              twice per entry batch, K13 once; [<tag>-lanes] (here and in
              17f-17h): K5 once a FEC set from C (folded into the count), on
              the native rings the shred client's frags_out = the store's
              shreds_in and every K1 launch a sealed C slot; [<tag>-gc] (here and in
              17f-17h): the cyclic GC's collections inside the window by
              generation, the longest and their sum in ms, and the objects
              the clocked build froze (models/leader.HeapHold) and left
              frozen after close(), and the ms of the build's full pass
              before the clock's anchor (what one inside the window would
              cost); (a), (b) and (d) shed nothing
              and land all 256 durable txns, (b), (d) and (e) land (a)'s
              signatures, (c) sheds; (a) and (e) seal all 16 slots, (a)'s
              native_exec > 0 and (e)'s 0. A missed slot is a measured value, not
              a failure. [clock-leader], [clock-leader-fused],
              [clock-leader-shed], [clock-leader-python-pack]: slots sealed
              and missed, skipped ticks, the seal lag's p50 and p99,
              blocks_closed, txns landed in the window and in the drain,
              txn/s to the store, the seal's and the replay's seconds, and
              (-split) the host seconds per stage; [pack-lanes]: pack's host
              seconds (with dedup's on the Python lane) and txn/s to the
              store of (a) and (d) side by side; [exec-lanes]: (a) and (e),
              each with bank0's, bank1's and verify's host seconds, txn/s to
              the store, slots sealed, txns in the window, signatures and
              native_exec / native_punt; [ring-lanes]: (a) and (f), each
              with bank0's, bank1's, verify's, pack's and PoH's host
              seconds, txn/s to the store, slots sealed and missed, txns in
              the window, the bank sweep's counters (txns committed inside
              the fdr_sweep crossing, microblocks all native, stashed,
              credit waits, resumed on the Python lane; (a) commits some
              inside the crossing and resumes every stash, (f) has no
              sweep) and its bank hash, equal to its replay's; [rings]:
              17e's 8,448 packets through one link on each lane, us a frag
              for the Python publish against fdr_publish_burst and the
              Python poll against fdr_drain, payloads equal; [parser]: the native parser
              (protocol/txn_native.py, the verify stage's) against the
              Python parse and pack over 17e's 8,448 packets, every
              descriptor equal, in us a packet on the host clock;
              [funk-lanes]: 17e (a) on the shm record map (every leader
              phase's store; each -split line checks bank_funk_falls 0 and
              bank_funk_writes > 0 where the bank sweep runs) beside (g) on
              the dict store (BankCtx(funk=Funk())): 16 of 16 sealed on
              both, and when both land all 8,448 txns equal txn_exec and
              committed state over the pool's payers and destinations and
              the nonce accounts; each lane's bank, drain and seal seconds,
              the seal's read-out (txn_diff / the _before walk) and
              arena_used; [sweep-phases]: 17e (a)'s verify0, bank0, bank1
              and shred metrics planes: crossings, frags (equal to the
              frags their sweeps returned), p50 and p99 of the drain /
              callback / apply / publish phases and of the in-crossing
              latency, and flush leaving every native word as C wrote it;
              [shred-lanes]: 17e (a)'s entries in its entry batches through
              the Python Shredder, NativeShredder and a ShredStage's sweep
              client over the rings, every shred byte equal to the plain
              version's (NativeShredder on the CPU: parity through the
              plain gf_apply_batch), us a FEC set and K5 launches each; [verify-lanes]: 17e's packets through
              one verify stage on the sweep client, the drain-table intake
              and the per-frag intake (Python rings), the frames equal,
              batches, K1 launches and us a txn each
  17f. program leader  17e (a)'s clocked leader over program_stream
              (PROGRAM_MIX: 4,096 v0 transfers whose destinations, phase
              17's 1,024, load through 16 lookup tables of 64 addresses,
              half with a readonly address too; 3,500 of phase 17's
              transfers; 256 stake txns over 128 accounts; 128 config
              stores over 64 accounts; 256 ed25519 and 64 secp256k1
              precompile txns, 1 in 16 bad; 64 lookups that fail; 8 lookup
              table program txns; 8,372 txns, shuffled from a seed) over
              program_bank_ctx at slot 1,000: the stream's pack cost fits
              one block (the drain's), sealed + missed = 16, landed + the
              failed lookups (no fee, never recorded) = the verified txns
              and none dropped or shed, the deshredded store bytes equal
              PoH's entries, replay_block reproduces the seal and its
              statuses, each kind's ok and failed counts as built (every
              status class occurs), every loaded destination's lamports
              equal the transfers to it that landed ok, each lookup table
              instruction's table state, K1 once per verify batch, K5 once
              or twice per entry batch, K13 once. [program-leader]: slots
              sealed and missed, the seal lag's p50 and p99, txns landed in
              the window and in the drain, ok and failed by kind, txn/s to
              the store beside 17e (a)'s, the seal's seconds and rows, the
              replay's seconds, the launches of K1, K5 and K13;
              [program-leader-split]: the host seconds per stage beside 17e
              (a)'s in the same call
  17g. sbpf leader  17e (a)'s clocked leader over sbpf_stream (SBPF_MIX:
              5,040 of phase 17's transfers; 2,048 counter invocations over
              64 counters and 512 hasher invocations over 16 accounts
              (sha256, keccak256 and blake3 of 64-256 bytes, sol_log_data,
              sol_set_return_data); 512 vault transfers out of 16 PDA vaults
              by CPI into the system program, 64 through the Rust ABI; 64
              each of a custom error, CU exhaustion, a write to a read-only
              account's image, a CPI signer escalation and a load outside
              every region; 16 upgradeable-loader txns on accounts of their
              own; counter and fail under loader v2, hasher and vault
              upgradeable; 8,448 txns, every sBPF txn behind a
              SetComputeUnitLimit, 64 payers of their own) over sbpf_bank_ctx
              at slot 1,000: the stream's pack cost fits one block, sealed +
              missed = 16, landed = verified = the stream and none dropped,
              shed or rejected, the deshredded store bytes equal PoH's
              entries, replay_block reproduces the seal and every status,
              fee and CU, each kind's ok and failed counts as built (every
              class occurs), each counter holds its operands that landed ok,
              each hasher the digests of its last ok invocation in PoH
              order, the vaults and destinations the transfers that landed
              ok, the loader's accounts their expected bytes, K1 once per
              verify batch, K5 once or twice per entry batch, K13 once.
              [sbpf-leader]: slots sealed and missed, the seal lag's p50 and
              p99, txns landed in the window and in the drain, ok and failed
              by kind, the CU the sBPF txns consumed, txn/s to the store
              beside 17e (a)'s, the seal's seconds and rows, the replay's
              seconds, the launches of K1, K5 and K13; [sbpf-leader-split]:
              the host seconds per stage beside 17e (a)'s in the same call
  17h. zk leader  17e (a)'s clocked leader, on the native pack lane, over
              zk_stream (ZK_MIX: 6,000 of phase 17's transfers; 512
              pubkey-validity and 512 zero-ciphertext verifies inline; 64
              verifies from account data; 64 context-state creations, then
              their 64 CloseContextStates; 8 u64, 4 u128 and 2 u256 range
              verifies; 64 each of a tampered proof, a wrong-size
              instruction, a close by the wrong authority and a u256 with no
              CU request; 7,486 txns, one proof of each kind made by the
              port's provers and reused, every zk txn but the last kind
              behind a SetComputeUnitLimit, 64 payers of their own) over
              zk_bank_ctx at slot 1: the stream's pack cost fits one block,
              sealed + missed = 16, landed = verified = the stream and none
              dropped, shed or rejected, the deshredded store bytes equal
              PoH's entries, replay_block reproduces the seal and every
              status, fee and CU, each kind's ok and failed counts as built,
              every context state and close destination as built, K1 once
              per verify batch, K5 once or twice per entry batch, K13 once.
              [zk-leader]: the proofs' and the stream's seconds, slots
              sealed and missed, the seal lag's p50 and p99, txns landed in
              the window and in the drain, ok and failed by kind, txn/s to
              the store beside 17e (a)'s, the banks' host seconds, the
              seal's seconds and rows, the replay's seconds, the launches of
              K1, K5 and K13; [zk-leader-split]: the host seconds per stage
              beside 17e (a)'s in the same call
  17i. ingress leader  17e (a)'s clocked leader with udp_ingress=True: a
              UdpIngressStage (the native recvmmsg sweep) where benchg was,
              17e's 8,448 txns sent over loopback from one socket, at most
              INGRESS_AHEAD datagrams past the stage's pkt_rx (SO_RCVBUF
              INGRESS_RCVBUF asked: loopback drops silently past it, so the
              sender is paced, never resending): pkt_rx = the datagrams
              sent, oversize_drop 0, the socket closed and the links
              unlinked by close(), and every check of 17e (a) (slots,
              landed + shed, the store's bytes, replay, the durable nonces,
              K1, K5, K13, [<tag>-lanes], [<tag>-gc]); when it and 17e (a)
              both land all 8,448, equal signatures. [ingress-leader] and
              -split (the net stage's host seconds under "net"),
              [ingress-leader-vs]: beside 17e (a) in the same call
  17j. net lanes  [net-lanes] on the card's host clock: 17e's packets over
              loopback (paced as 17i) through one UdpIngressStage on the
              native sweep, the explicit scalar recv (native_sweep(scalar=
              True)) and native_net=False: payloads, order and sigs equal,
              us a datagram each; then NET_QUIC_CLIENTS QuicTxnClients on
              loopback sockets send NET_QUIC_TXNS of 17e's packets, one
              stream a txn, to a QuicIngressStage on each lane (native
              fast path, native_net=False): every txn whole and each
              client's in order, the handshakes' ms, us a datagram, the
              counters consumed, punt, aesni and pclmul; each lane's txns
              through one VerifyStage on the card: K1 once a batch, the
              mask equal to verify_batch_plain's; every stage, client
              socket and link closed, no /dev/shm entry of the phase left
  18. sha256  K14 sha256_msg at B = 4,096, max_len 1,232, lengths across
              every padding boundary: equal to hashlib on every lane and to
              the plain version on 1,024; the same rows from an offset
              buffer (the narrow path: one byte a thread) and on 4,091
              lanes (not a multiple of 16) equal to it; K15 sha256_mix32 at
              B = 4,096: equal to hashlib and the plain version, and from
              offset rows (the narrow path), at 4,091 lanes, at B =
              65,536 (four warp pairs a block; wide and offset rows) and
              at B = 8,464 (a last block of four pairs holding one in the
              batch) equal to hashlib on every lane; timed at 4,096 (and
              offset) and 65,536 beside its bound and a chain floor
              estimate (in the log line only); with --parent, [K15-ab] at
              B = 4,096 and 65,536 and [K15-knobs]; then the
              bmtree root build over phase 17's FEC sets, grouped by shape:
              one hash_leaves_batch per leaf size and one layers_batch per
              group on the card, every layer equal to the host tree, every
              root the first 20 bytes of the root the shredder signed, K14
              launched exactly once per leaf size and layer; each timed,
              the root build beside the host tree's time, and each of its
              K14 launches alone at its own shape ([K14-launches]: lanes,
              blocks, path, time, bound, the sum of time - bound); the
              timed batches' last 1,024 lanes equal to plain on both paths
  19. hashes  K16 blake3_msg at B = 16,384, max_len 1,024; K17
              keccak256_msg at B = 4,096, max_len 1,232 (and from an offset
              buffer, the narrow path: equal on every lane); K18
              chacha20_keystream at B = 65,536 (half zero nonces, half
              seeded): each equal to its host oracle on sampled lanes and
              to its plain version on the first and the last 1,024 lanes;
              each timed; with --parent, the parent's K16 and K17 on the
              aligned and the offset rows (bytes equal, then times in
              turns): one [K16-ab] and one [K17-ab] line

Then [shm] (no /dev/shm entry this run made is left: every pipeline and
every bank ctx the script built was closed), a [time] line with each
phase's seconds on the host clock, one JSON
line of per-kernel numbers ({"kernels": [...]}), the
nvidia-smi line, and as the last line {"ok": true, "device": {...}}.
The script imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import gc
import hashlib
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

PROBE_REPS = 200  # phase 2b: probe_add and torch.add calls per timing
HOST_CALLS = 10_000  # phase 2b: calls per piece of the host breakdown
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_CLK_PER_SM = 64  # 32-bit IMAD / IADD3 / LOP3 / SHF, sm_90
# K2's bound, pipe by pipe: DFMA on the FP64 pipe (64 a clock an SM on the
# H100 SXM, 33.5 TFLOP/s at 1,980 MHz); IMAD.WIDE taken at the 32-bit IMAD
# rate above (not measured alone on the card; ptxas spaces them ~4 clocks
# apart, which would be half that rate, so the bound is a floor either
# way); and issue, four schedulers of one 32-lane instruction a clock
FP64_FMA_PER_CLK_PER_SM = 64
DISPATCH_PER_CLK_PER_SM = 128
# 32-bit instructions per SHA-512 block, a hand tally with a 64-bit
# rotate as 2 SHF, a 64-bit 3-input LOP3 as 2 and a 64-bit 3-input add as
# 2 (IADD3 and IADD3.X): 80 rounds x 28 (Sigma0 and Sigma1 3 rotates and a
# LOP3 each: 12 SHF, 4 LOP3; ch 2, maj 2; T1 = h + Sigma1 + ch + K + W in
# 2 adds, e = d + T1 and a = T1 + Sigma0 + maj 1 each: 8) + 64 schedule
# steps x 20 (sigma0 and sigma1 2 rotates, a shift and a LOP3 each: 16;
# 4 terms in 2 adds: 4) + 8 final adds x 2 = 3,536.  K10's SASS issues
# more a block on its two warps (the row loads, the words, the pad and the
# barriers), which the hash itself does not need
SHA512_OPS_PER_BLOCK = 3536
# 32-bit instructions per SHA-256 compression, a hand tally before constant
# folding: 48 schedule steps x 10 (sigma0 and sigma1 4 each: 3 shifts and a
# 3-input LOP3; 2 three-input adds for 4 terms) + 64 rounds x 13 (Sigma0
# and Sigma1 4 each, ch 1, maj 1, 3 adds) + 8 final adds
SHA256_OPS_PER_COMPRESSION = 1320
# K4's block is a 32-byte message's only one: words 8-15 are the pad
# (0x80000000, six zeros, 256) and round 0 runs on the IV, so
#   - sigma0 of W8..W15 (steps 23-30) and sigma1 of W14, W15 (steps 16,
#     17) are constants: 10 x 4 = 40;
#   - a step's four terms take two adds; with its constant terms summed
#     into one and its zero terms gone, steps 16-21 and 24-30 have two or
#     three terms left and take one: 13 (steps 22 and 23 keep three
#     variable terms and a constant);
#   - round 0's Sigma0, Sigma1, ch and maj are constants (10), and its
#     three adds become two (e and a are constants plus W0): 11;
# 1,320 - 40 - 13 - 11 = 1,256.  The final adds stay (IV + state, an
# immediate operand each).
SHA256_OPS_PER_ITER32_COMPRESSION = 1256
# K15's second block is the constant pad of a 64-byte message: its 48
# schedule steps fold at compile time, leaving 64 rounds x 13 + 8 final adds
SHA256_OPS_PER_PAD_COMPRESSION = 840
# K5 instructions per GF(2^8) multiply-add: per output row and 4 columns,
# 1 shared coefficient-log load, 4 adds, 4 exp-table loads, 3 shifts and
# 3 LOP3 = 14 / 4 bytes
GF_OPS_PER_MULADD = 3.5
# K5's tensor-core form: 8m x 8k x S x T int8 multiply-adds, two operations
# each, at the H100 SXM's dense int8 rate (NVIDIA data sheet, 700 W)
INT8_TC_OPS_PER_S = 1.979e15
# phase 9: K5's timed shapes, {label: (T, m, k, S, kind)}: the leader
# block's two set shapes (phase 17's [bmtree]: d = 19 and 8 data shreds of
# 1,019 and 1,039 bytes, p = 27 and 22), one lossy-store rebuild of n = d
# + p rows (phase 17b), the per-set recover of 64 sets and the plane's
# batch encode (phase 10's FEC (32, 32, 1,024) over 1,024 sets)
K5_SHAPES = {
    "(1, 27x19, 1019) encode": (1, 27, 19, 1019, "encode"),
    "(1, 22x8, 1039) encode": (1, 22, 8, 1039, "encode"),
    "(1, 46x19, 1019) recover": (1, 46, 19, 1019, "recover"),
    "(64, 64x32, 1024) recover": (64, 64, 32, 1024, "batch-recover"),
    "(1024, 32x32, 1024) encode": (1024, 32, 32, 1024, "batch-encode"),
}
K5_EDGE_S = (1, 3, 63, 65, 999, 1059, 4097)  # phase 9: K5 checked at T = 2
K5_EDGE_K = (1, 32, 33, 67)
# 32-bit instructions per BLAKE3 compression in K16, a hand tally: 7 rounds x
# 8 mixes x 12 (2 three-input adds, 2 adds, 4 XOR, 4 rotates) + 8 output XORs
BLAKE3_OPS_PER_COMPRESSION = 680
# per keccak-f[1600] permutation in K17, a hand tally of 32-bit instructions,
# two per 64-bit operation, with LOP3 taking three inputs as IADD3 does in
# BLAKE3's tally: 24 rounds x (theta: 5 five-way parities x 2 LOP3, 5
# rotates by 1, 25 LOP3 for A ^= C[x-1] ^ rot(C[x+1]); rho 24 rotates; chi 25
# LOP3 for a ^ (~b & c); iota 1 = 90) + 17 absorbing XORs
KECCAK_OPS_PER_PERMUTATION = 2 * (24 * 90 + 17)
# per ChaCha20 block in K18: 10 double rounds x 8 quarter rounds x 12 (4 adds,
# 4 XOR, 4 rotates) + 16 final adds
CHACHA20_OPS_PER_BLOCK = 976
HASHES_PER_TICK = 12_500  # the repo's genesis default (flamenco/genesis.py)
# phase 8: K4's chain counts on its paths (the sharded leader block's 4, the
# plane's 64 = one slot's tick spans) and a wide 4,096
K4_CHAINS = (4, 64, 4096)
# clocks a warp instruction of one scheduler on the INT32 pipe (16 lanes a
# sub-partition, sm_90), for the time K4's round warp takes to issue a hash
ISSUE_CLOCKS = 2
# clocks from one dependent ALU instruction to the next, for K4's chain
# floor: an estimate, measured on a Volta card (Jia et al., "Dissecting the
# NVIDIA Volta GPU Architecture via Microbenchmarking", 2018) and not on an
# H100, and taken for every instruction of the chain (loads and barriers too)
DEP_CLOCKS = 4
REPEAT_ROUNDS = 4  # phase 10b: extra (verify pipeline, plane pipeline) rounds
# phases 12-13: the voting set and the comb bank (2,048 slots hold the
# mainnet-beta voting set, ~1,000-2,000 validators on public explorers)
VOTERS, BANK_SLOTS, VOTE_ROUNDS, VOTE_TRANSFERS = 1536, 2048, 4, 2048
COMB_REPEAT_ROUNDS = 2  # phase 13: extra (comb, generic) pipeline rounds
K6_BATCH, K6_SMALL = 16384, 1024  # phase 12: K6's batches (the small one = the stage's)
SPLIT = ("phase_validate", "phase_hash", "phase_dsm", "phase_compare")  # K9-K12
SPLIT_LINES = (216, 229, 239, 245)  # their JAX phases in firedancer_tpu/ops/sigverify.py
TUNE_BATCH, TUNE_AFTER = 2048, 2  # phase 15c: the untuned geometry and the evidence bar
SPLIT_REPEAT_ROUNDS = 2  # phase 15: extra (split, fused) pipeline rounds
# phase 14: K12's checked batches (inside a 16-lane block, on both sides of
# one, the split pipeline's 1,024 and one less, and 16,384), the share of
# lanes whose ok is cleared besides those K9 refused, and K12's timing reps
K12_BATCHES = (1, 31, 33, 1023, 1024, 16384)
K12_DROP = 0.25
K12_REPS = 200
K13_ROWS = (1040, 2048, 65536)  # phase 16: K13 timed (phase 17's seal; a slot's few thousand; a large N)
K13_CHECK_ROWS = (1, 17)  # phase 16: K13 checked only (one row; a ragged chunk)
PARENT_K13_CHUNKS = (528, 8)  # the parent wrapper's K13 chunks: at most 528, 8 rows or more each
K15_BATCHES = (4096, 65536)  # phase 18: K15 timed
# phase 18: K15 checked only: on 132 SMs, 265 warp pairs in blocks of four,
# the last block's pairs 1-3 past the batch
K15_CHECK_BATCHES = (8464,)
K15_CHAIN_DEPTH = 3  # dependent instructions a round on the chain: Sigma1 -> t1 -> e
# phase 17: the leader pipeline's ingress, the lane-independent key set of
# the JAX package's cross-lane drives (8 payers, 1,024 destinations); pack's
# pool holds the whole stream (at the default 4,096, equal-priority
# transfers past a full pool are dropped, and a quarter of them were)
LEADER_TXNS, LEADER_DESTS = 8192, 1024
# phase 17e: the clocked leader over phase 17's pool with durable-nonce
# transfers mixed in (one every CLOCK_EVERY txns), a 16-slot leader window at
# mainnet's cadence (400 ms, 64 ticks a slot) with PoH's hashes_per_tick left
# at build_leader_pipeline's 64 (mainnet's 12,500 would cost the host chain ~800 k
# hashlib calls a slot), pack's load shedding down to CLOCK_SHED_KEEP in run
# (c), and a wall cap on driving the window
CLOCK_DURABLE, CLOCK_EVERY, CLOCK_SHED_KEEP, CLOCK_WALL_S = 256, 32, 256, 60.0
CLOCK_SLOTS, CLOCK_TICKS, CLOCK_SLOT_MS, CLOCK_GRACE = 16, 64, 400.0, 0.25
# phase 17f: the program leader's stream (models/workload.program_stream):
# v0 transfers through 16 lookup tables of 64 addresses (phase 17's 1,024
# destinations), phase 17's legacy transfers, stake txns over 128 accounts,
# config stores over 64 accounts, the two precompiles' txns, lookups that fail
# and a few lookup table program txns; the clock and depth are 17e's
PROGRAM_MIX = dict(n_v0=4096, n_legacy=3500, n_tables=16, table_len=64, n_stake_accts=128,
                   n_config_accts=64, n_ed25519=256, n_secp256k1=64, n_lookup_fail=64, n_alt=2)
# phase 17g: the sBPF leader's stream (models/workload.sbpf_stream): phase 17's
# transfers beside counter, hasher and vault (CPI) invocations under both BPF
# loaders, the five typed failures and the upgradeable loader's six
# instructions; 8,448 txns like 17e's, every sBPF txn behind a
# SetComputeUnitLimit near its use, the clock and depth 17e's
SBPF_MIX = dict(n_legacy=5040, n_counter=2048, n_hasher=512, n_vault=512, n_vault_rust=64,
                n_fail=64, n_loader=16, n_counters=64, n_hashers=16, n_vaults=16, n_dests=1024,
                n_sbpf_payers=64)
# phase 17h: the zk leader's stream (models/workload.zk_stream): ~6,000 of
# phase 17's transfers beside zk-elgamal proof verifies (both sigma kinds
# inline and from accounts, context states created and closed, u64, u128 and
# u256 range proofs) and the four typed failures; the clock and depth 17e's
ZK_MIX = dict(n_legacy=6000, n_pubkey_validity=512, n_zero_ciphertext=512, n_from_account=64,
              n_context=64, n_range_u64=8, n_range_u128=4, n_range_u256=2, n_fail=64,
              n_dests=1024, n_zk_payers=64)
HOST_LIBS = ("fd_tcache", "fd_pack", "fd_exec_native", "fd_txn_parse", "fd_ring",
             "fd_bank", "fd_shred", "fd_verify", "fd_funk", "fd_net")  # utils/hostbuild.py's libraries, built in phase 2
# phase 17e: the banks' sweep-lane counters summed over the banks, and the
# [rings] link's depth (the 8,448 packets fit) and burst (a stage sweep's)
BANK_SWEEP_KEYS = ("bank_txn_native", "bank_mb_native", "bank_mb_stashed", "bank_credit_waits",
                   "bank_mb_resumed", "bank_mb_dropped", "bank_funk_writes", "bank_funk_falls")
# [sweep-phases]: the native-swept stages of 17e (a) the plane is read on
SWEPT_STAGES = ("verify0", "bank0", "bank1", "shred")
RINGS_DEPTH, RINGS_BURST = 16384, 16
# phase 17e: [shred-lanes]' entry-batch target (the leader's shred stage's),
# the depth of the [verify-lanes] links (17e's 8,448 packets fit) and the
# frags a publish or drain call of the lanes' harness moves
SHRED_TARGET, LANES_DEPTH, LANES_BURST = 16384, 16384, 64
HOST_ENTRY_CALLS = 200  # [shred-lanes]: K5's host entry timed over this many calls
# phases 17i and 17j: the sender keeps at most INGRESS_AHEAD datagrams past
# the net stage's pkt_rx and the stage's socket asks for an INGRESS_RCVBUF
# receive buffer (loopback UDP drops silently past it, so the sender is
# paced, never resending); [net-lanes]' QUIC lanes: NET_QUIC_CLIENTS clients
# send NET_QUIC_TXNS of 17e's packets between them, one stream a txn
INGRESS_AHEAD, INGRESS_RCVBUF = 128, 1 << 22
NET_QUIC_CLIENTS, NET_QUIC_TXNS = 4, 2048
NET_IDLE_CALLS = 2000  # [net-lanes]: receive calls timed on a dry socket after each lane
PLAIN_LANES = 1024  # phases 4, 18-19: the lanes each kernel is held to its plain version on
PARENT = None  # set from --parent
OPS_API = "ops API (tests-only in the JAX package)"  # phases 4, 18-19: K3, K15-K18's path


def native_counts(rep: dict, banks) -> tuple[int, int]:
    """(native_exec, native_punt) over the banks' counters: the txns the
    native executor lane committed, and its punts resumed in Python."""
    return (sum(rep[b.name].get("native_exec", 0) for b in banks),
            sum(rep[b.name].get("native_punt", 0) for b in banks))


class SmokeFailure(RuntimeError):
    pass


def funk_plane(tag: str, rep: dict, banks, armed: bool = True) -> str:
    """The banks' native funk plane after a leader run: no group fell back
    to full-record logging, and with `armed` (the shm store under the bank
    sweep lane) the crossing wrote txns into the map.  Returns the text the
    -split line carries."""
    w = sum(rep[b.name].get("bank_funk_writes", 0) for b in banks)
    f = sum(rep[b.name].get("bank_funk_falls", 0) for b in banks)
    check(f == 0, f"{tag}: {f} bank groups fell back from the native funk plane")
    check((w > 0) == armed, f"{tag}: bank_funk_writes {w} with the plane {'armed' if armed else 'off'}")
    return f"bank_funk_writes {w}, bank_funk_falls {f}"


def sweep_phases(tag: str, pipe, hist_quantile) -> dict:
    """Each native-swept stage's metrics plane after a run: crossings,
    frags, p50 and p99 (upper bucket edges, ns) and the exact sum (ns) of
    the four phase histograms and of the in-crossing latency.  Checks that the plane's
    frag count equals the frags the stage's sweeps returned, and that a
    housekeeping flush leaves every native word as C wrote it."""
    out = {}
    for st in pipe.stages:
        if st.name not in SWEPT_STAGES:
            continue
        reg = st.metrics.registry
        check(reg is not None, f"{tag}: {st.name} has no metrics plane")
        frags, swept = reg.get("nsweep_frags"), st.metrics.get("sweep_frags")
        check(frags == swept, f"{tag}: {st.name} plane nsweep_frags {frags}, sweeps {swept}")
        native = [d.name for d in reg.schema.defs if d.native]
        words = reg.words.copy()
        st.metrics.flush()
        for nm in native:
            d_, off_ = reg._off[nm]
            n_ = d_.words()
            check(np.array_equal(reg.words[off_:off_ + n_], words[off_:off_ + n_]),
                  f"{tag}: {st.name} flush wrote the native word(s) of {nm}")
        row = {"crossings": reg.get("nsweep_crossings"), "frags": frags}
        for nm in ("drain", "callback", "apply", "publish", "lat"):
            h = reg.hist(f"nsweep_{nm}_ns")
            row[nm] = (h["count"], hist_quantile(h, 0.5), hist_quantile(h, 0.99), h["sum"])
        out[st.name] = row
    check(sorted(out) == sorted(SWEPT_STAGES), f"{tag}: swept stages {sorted(out)}")
    check(out["verify0"]["frags"] > 0 and out["shred"]["frags"] > 0
          and out["bank0"]["frags"] + out["bank1"]["frags"] > 0,
          f"{tag}: a native-swept stage took no frag in a crossing {out}")
    return out


def native_lanes(pipe) -> dict:
    """A leader pipeline's shred and verify lanes, read before its run (its
    close() drops the sweep clients)."""
    return {"shred_native": pipe.shred.native_shred,
            "shred_sweep": pipe.shred._sweep_client is not None,
            "verify_client": [v._sweep_client is not None for v in pipe.verifies]}


def check_native_lanes(tag: str, pipe, lanes: dict, launches: dict, sweep: bool) -> str:
    """The native shredder's and the verify client's checks after a leader
    run: K5 once a FEC set, launched from C and folded into the count; with
    `sweep` (native rings) the shred stage inside fdr_sweep (its C-side
    frags_out = the shreds the store took) and every verify batch a sealed
    C slot on K1; else batch mode and the Python verify intake.  Returns
    the [<tag>-lanes] line's text."""
    sm = pipe.shred.metrics
    stored = pipe.store.metrics.get("shreds_in")
    sets, k5 = sm.get("fec_sets"), launches.get("gf256_apply", 0)
    sealed = sum(v.metrics.get("sealed_batches") for v in pipe.verifies)
    batches = sum(v.metrics.get("batches") for v in pipe.verifies)
    k1 = launches.get("verify_batch", 0)
    check(lanes["shred_native"] and lanes["shred_sweep"] == sweep
          and lanes["verify_client"] == [sweep] * len(pipe.verifies),
          f"{tag}: lanes {lanes}, sweep expected {sweep}")
    check(k5 == sets > 0, f"{tag}: K5 launches {k5} != the native shredder's {sets} FEC sets")
    check(sm.get("batches_dropped") == 0, f"{tag}: shred batches dropped")
    if sweep:
        check(sm.get("frags_out") == stored > 0,
              f"{tag}: the shred client published {sm.get('frags_out')}, the store took {stored}")
        check(sealed == k1 == batches > 0,
              f"{tag}: verify sealed {sealed} C slots, K1 launched {k1}, {batches} batches")
    else:
        check(sealed == 0 and k1 == batches > 0, f"{tag}: verify sealed {sealed}, K1 {k1}")
    return (f"shred {'inside fdr_sweep' if sweep else 'batch mode'}: {sm.get('entry_batches')}"
            f" entry batches, {sets} FEC sets, {sm.get('frags_out')} shreds published"
            f" ({stored} stored), K5 {k5} launches from C; verify"
            f" {'sweep client' if sweep else 'Python intake'}: {batches} batches"
            f" ({sealed} sealed C slots), K1 {k1}")


def drain_all(drainer, meta: bool = False) -> list:
    """Every frag ready on a BurstDrainer's one consumer: payloads, or with
    `meta` (payload, sig, tsorig) tuples."""
    out = []
    while True:
        n, _, _ = drainer.drain(0, drainer.max_frags)
        if not n:
            return out
        rows = drainer.meta[:n].tolist()
        buf = drainer.arena[: rows[-1][2] + rows[-1][3]].tobytes()
        out += [(buf[r[2]:r[2] + r[3]], r[1], r[5]) if meta else buf[r[2]:r[2] + r[3]]
                for r in rows]


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1, hide_host: bool = False) -> float:
    """Mean device time per call, CUDA events around `reps` calls.  With
    hide_host, the calls are queued behind a ~0.1 s busy-wait on the card, so
    a kernel shorter than its launch's host cost is timed back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probe_host_breakdown(fprobe, kbuild, x, y, dev) -> dict:
    """probe_add's host cost per call, piece by piece: mean nanoseconds of
    each piece alone over HOST_CALLS calls (perf_counter_ns), beside the
    whole wrapper and torch.add.  "launch" is the C call with n elements
    less the same call with n = 0 (which sets the device and returns)."""
    kernel = fprobe._ADD
    kernel(dev, x.data_ptr(), y.data_ptr(), torch.empty_like(x).data_ptr(), x.numel())
    fn, idx, n, shape = kernel._fn, dev.index or 0, x.numel(), tuple(x.shape)
    out = torch.empty_like(x)
    px, py, po = x.data_ptr(), y.data_ptr(), out.data_ptr()
    stream = kbuild.current_raw_stream(idx)
    pieces = {
        "checks": lambda: fprobe._check("probe_add", x, y),
        "alloc": lambda: torch.empty_like(x),
        "alloc by torch.empty": lambda: torch.empty(shape, dtype=torch.int32, device=dev),
        "data_ptr x3": lambda: (x.data_ptr(), y.data_ptr(), out.data_ptr()),
        "stream": lambda: kbuild.current_raw_stream(idx),
        "ctypes call, n = 0": lambda: fn(px, py, po, 0, idx, stream),
        "ctypes call": lambda: fn(px, py, po, n, idx, stream),
        "bound call": lambda: kernel(dev, px, py, po, n),
        "probe_add": lambda: fprobe.probe_add(x, y),
        "torch.add": lambda: torch.add(x, y),
    }
    ns = {}
    for name, f in pieces.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(HOST_CALLS):
            f()
        ns[name] = (time.perf_counter_ns() - t0) / HOST_CALLS
        torch.cuda.synchronize()
    ns["launch"] = ns["ctypes call"] - ns["ctypes call, n = 0"]
    ns["binder"] = ns["bound call"] - ns["ctypes call"] - ns["stream"]
    return ns


# --parent DIR: the earlier checkout's kernels built beside this one's, with
# their C entry points' argument types before the device and the stream
def _ptrs_then(n_ptrs: int, *ints: str) -> tuple:
    return ("ptr",) * n_ptrs + ints


PARENT_KERNELS = {
    "verify": (("fd_verify_batch", _ptrs_then(7, "i64", "i32", "i64")),),
    "verify_cached": (("fd_verify_cached", _ptrs_then(9, "i64", "i32", "i64")),),
    "comb_fill": (("fd_comb_fill", _ptrs_then(3, "i64")),),
    "verify_split": (("fd_phase_validate", _ptrs_then(6, "i64", "i32")),
                     ("fd_phase_hash", _ptrs_then(5, "i64", "i32")),
                     ("fd_phase_dsm", _ptrs_then(5, "i64")),
                     ("fd_phase_compare", _ptrs_then(4, "i64"))),
    "sha256_iter32": (("fd_sha256_iter32", _ptrs_then(2, "i64", "i64")),),
    "sha256_msg": (("fd_sha256_msg", _ptrs_then(3, "i64")),
                   ("fd_sha256_mix32", _ptrs_then(3, "i64"))),
    "keccak256_msg": (("fd_keccak256_msg", _ptrs_then(3, "i64")),),
    "sha512_batch": (("fd_sha512_batch", _ptrs_then(3, "i64", "i32")),),
    "blake3_msg": (("fd_blake3_msg", _ptrs_then(3, "i64")),),
    # (values, signs, scratch, out, n, chunks)
    "lthash_combine": (("fd_lthash_combine", _ptrs_then(4, "i64", "i64")),),
    "fe_mul_chain": (("fd_fe_mul_chain", _ptrs_then(4, "i32", "i32")),),
    "probe": (("fd_probe_conv", _ptrs_then(3, "i64")),),
    # (mat, mat_stride, data, out, T, m, k, S, vec): the tensor-core form
    "gf256_apply": (("fd_gf256_apply", ("ptr", "i64", "ptr", "ptr", "i64", "i32", "i32",
                                        "i64", "i32")),),
}


# --parent also builds this tree's K13 and K15 again, each with one knob set
# at compile time, and phases 16 and 18 time every value of the knob in
# turns ([K13-knobs], [K15-knobs]): {build: (source, define, C entry point)}
KNOB_BUILDS = {
    "lthash_cluster4": ("lthash_combine", "-DLT_CLUSTER=4",
                        ("fd_lthash_combine", _ptrs_then(4, "i64", "i64"))),
    "lthash_cluster8": ("lthash_combine", "-DLT_CLUSTER=8",
                        ("fd_lthash_combine", _ptrs_then(4, "i64", "i64"))),
    "lthash_cluster16": ("lthash_combine", "-DLT_CLUSTER=16",
                         ("fd_lthash_combine", _ptrs_then(4, "i64", "i64"))),
    "mix32_pairs1": ("sha256_msg", "-DMIX32_GROUPS=1", ("fd_sha256_mix32", _ptrs_then(3, "i64"))),
    "mix32_pairs4": ("sha256_msg", "-DMIX32_GROUPS=4", ("fd_sha256_mix32", _ptrs_then(3, "i64"))),
    "fe_product_imad": ("fe_mul_chain", "-DK2_DFMA=0",
                        ("fd_fe_mul_chain", _ptrs_then(4, "i32", "i32"))),
    "fe_product_dfma": ("fe_mul_chain", "-DK2_DFMA=1",
                        ("fd_fe_mul_chain", _ptrs_then(4, "i32", "i32"))),
}
# [K2-knobs]: K2's product forms, all else this tree's: {label: knob build}
K2_KNOBS = {"every product IMAD.WIDE (the parent's form)": "fe_product_imad",
            "DFMA below 2^255, IMAD.WIDE past it (this tree's)": "fe_product_dfma"}
# [K13-knobs]: K13's chunk rule (rows a chunk at least, chunks at most)
K13_CHUNK_RULES = ((8, 528), (16, 528), (8, 264))
# [K15-knobs]: one warp pair's 32 lanes, the switch from one warp pair a block to four
# (B > 8,448 on 132 SMs) on either side, and a large batch
K15_KNOB_BATCHES = (32, 4096, 8192, 16384, 65536)
# phase 3: K2's batches (a microbenchmark's 16,384, the verify batch, and
# four warps a scheduler), and its extreme inputs: the carried bound
# 1.1 * 2^(w - 1) of each limb width, floored
K2_BATCHES = (16384, 1024, 65536)
K2_CARRIED_MAX = tuple(int(1.1 * 2 ** (w - 1)) for w in (26, 25) * 5)
# phase 3: of K2's 100 products a multiply, those csrc/fe_mul_chain.cu runs
# as DFMA from the chain's third step on (all 100 are IMAD.WIDE before it)
K2_DFMA_PER_MUL = 54
# phase 2b: probe_conv's batches (the probe's own, K2's, one whose bytes
# bound passes the launch floor); past the first, timed with a cold L2
# (l2_cold_call)
CONV_BATCHES = (512, 16384, 65536)


def parent_lib(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "parent_kernels", f"lib{name}.so")


def start_parent_build(kbuild, parent: str):
    """Start nvcc on another checkout's csrc/<name>.cu for each of
    PARENT_KERNELS (older kernels, with the C entry points listed there), one
    process a source, with the flags kbuild uses, into build/parent_kernels/."""
    csrc = os.path.join(os.path.abspath(parent), "firedancer_tpu_torch", "csrc")
    os.makedirs(os.path.dirname(parent_lib("x")), exist_ok=True)
    jobs = {name: (csrc, name, (), PARENT_KERNELS[name]) for name in PARENT_KERNELS}
    jobs.update({knob: (kbuild.CSRC_DIR, src, (define,), (entry,))
                 for knob, (src, define, entry) in KNOB_BUILDS.items()})
    procs = {}
    for name, (src_dir, src_name, defines, entries) in jobs.items():
        src = os.path.join(src_dir, f"{src_name}.cu")
        check(os.path.exists(src), f"--parent: no {src}")
        so = parent_lib(name)
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, *defines, "-I", src_dir, "-o", so, src]
        procs[name] = (so, entries, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))
    return procs


def finish_parent_build(procs) -> dict:
    """{C symbol: the parent's entry point as a ctypes function}, and for
    each knob build {build name: its entry point}."""
    import ctypes

    types = {"ptr": ctypes.c_void_p, "i32": ctypes.c_int, "i64": ctypes.c_int64}
    fns = {}
    for name, (so, entries, proc) in procs.items():
        out, _ = proc.communicate()
        sys.stderr.write(f"[parent] nvcc {name} rc={proc.returncode}\n{out}")
        check(proc.returncode == 0, f"--parent: nvcc failed on {name}")
        lib = ctypes.CDLL(so)
        for symbol, args in entries:
            fn = getattr(lib, symbol)
            fn.argtypes = [types[t] for t in args] + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name if name in KNOB_BUILDS else symbol] = fn
    return fns


def parent_call(fn, dev, *args) -> None:
    """One launch of a parent kernel on the current stream: args are its
    pointers and ints in PARENT_KERNELS' order, before the device index and
    the stream."""
    rc = fn(*args, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    check(rc == 0, f"parent kernel launch: CUDA error {rc}")


def ab_times(tag: str, shapes, parent_fns, change_fns, digits: int = 4) -> None:
    """Device-only times of the parent's and this tree's kernel at each
    shape, in turns (parent, change, change, parent); one [tag] line, ms to
    `digits` places.  shapes: (label, reps); parent_fns / change_fns:
    {label: a call}."""
    times = {}
    for who, fns in (("parent", parent_fns), ("change", change_fns),
                     ("change", change_fns), ("parent", parent_fns)):
        for label, reps in shapes:
            times.setdefault((who, label), []).append(
                time_ms(fns[label], reps=reps, hide_host=True))
    log(f"[{tag}] device-only ms (parent, change; two turns each, in the order parent,"
        " change, change, parent): " + "; ".join(
            f"{label}: parent {' / '.join(f'{t:.{digits}f}' for t in times[('parent', label)])},"
            f" change {' / '.join(f'{t:.{digits}f}' for t in times[('change', label)])}"
            for label, _ in shapes))


def k1_ab(parent_fn, sv, dev, args_mixed, mb, args16k, args1k, max_len) -> None:
    """The parent checkout's K1 beside this one on the same inputs: the
    mixed batch's mask, then device-only times at B = 1,024 and 16,384 in
    turns (parent, change, change, parent); one [K1-ab] line."""
    comb = sv.fc.comb_table(dev)

    def parent(args, n_real):
        bsz = args[1].shape[0]
        mask = torch.empty((bsz,), dtype=torch.bool, device=dev)
        cnt = torch.zeros((), dtype=torch.int32, device=dev)
        parent_call(parent_fn, dev, *(a.data_ptr() for a in args), comb.data_ptr(),
                    mask.data_ptr(), cnt.data_ptr(), bsz, max_len, n_real)
        return mask, cnt

    pm, pc = parent(args_mixed, mb.n_real)
    cm, cc = sv.verify_batch(*args_mixed, mb.n_real, max_msg_len=max_len)
    check(torch.equal(pm, cm) and int(pc) == int(cc), "parent K1 and K1 differ on the mixed batch")
    shapes = (("B=1024", 50), ("B=16384", 10))
    ab_times("K1-ab", shapes,
             {"B=1024": lambda: parent(args1k, 1024), "B=16384": lambda: parent(args16k, 16384)},
             {"B=1024": lambda: sv.verify_batch(*args1k, 1024, max_msg_len=max_len),
              "B=16384": lambda: sv.verify_batch(*args16k, 16384, max_msg_len=max_len)})


def k6_ab(parent_fn, sv, dev, runs, bank, max_len) -> None:
    """The parent checkout's K6 beside this one on phase 12's lanes: masks
    and counts equal at each batch, then device-only times in turns; one
    [K6-ab] line.  runs: {label: (args, slots on the card, n_real)}."""
    comb = sv.fc.comb_table(dev)

    def parent(args, slots_d, n_real):
        bsz = args[1].shape[0]
        mask = torch.empty((bsz,), dtype=torch.bool, device=dev)
        cnt = torch.zeros((), dtype=torch.int32, device=dev)
        parent_call(parent_fn, dev, *(a.data_ptr() for a in args), bank.data_ptr(),
                    slots_d.data_ptr(), comb.data_ptr(), mask.data_ptr(), cnt.data_ptr(),
                    bsz, max_len, n_real)
        return mask, cnt

    def change(args, slots_d, n_real):
        return sv.verify_cached_launch(*args, bank, slots_d, n_real, max_len)

    for label, run in runs.items():
        (pm, pc), (cm, cc) = parent(*run), change(*run)
        check(torch.equal(pm, cm) and int(pc) == int(cc), f"parent K6 and K6 differ at {label}")
    ab_times("K6-ab", [(label, 10) for label in runs],
             {label: (lambda r=run: parent(*r)) for label, run in runs.items()},
             {label: (lambda r=run: change(*r)) for label, run in runs.items()})


def k7_ab(parent_fn, sv, fl, dev, runs) -> None:
    """The parent checkout's K7 beside this one on phase 12's keys: ok equal
    and the tables equal as field elements (canonical limbs; the parent
    built them on one thread, so its limbs differ), then device-only times
    in turns; one [K7-ab] line.  runs: {label: (32, M) uint8 keys}."""

    def parent(pk):
        m = pk.shape[1]
        tables = torch.empty((m,) + sv.fc.COMB_SLOT_SHAPE, dtype=torch.int32, device=dev)
        ok = torch.empty((m,), dtype=torch.bool, device=dev)
        parent_call(parent_fn, dev, pk.data_ptr(), tables.data_ptr(), ok.data_ptr(), m)
        return tables, ok

    def canon(t):
        return fl.fe_freeze(t.reshape(-1, 10).T.to(torch.int64))

    for label, pk in runs.items():
        pt, pok = parent(pk)
        ct, cok = sv.comb_fill(pk)
        check(torch.equal(pok, cok), f"parent K7 and K7 ok differ at {label}")
        for i in range(0, pk.shape[1], 256):
            check(torch.equal(canon(pt[i:i + 256]), canon(ct[i:i + 256])),
                  f"parent K7 and K7 tables differ as field elements at {label}")
        del pt, ct
    ab_times("K7-ab", [(label, 10 if pk.shape[1] <= 32 else 3) for label, pk in runs.items()],
             {label: (lambda pk=pk: parent(pk)) for label, pk in runs.items()},
             {label: (lambda pk=pk: sv.comb_fill(pk)) for label, pk in runs.items()})


def k11_ab(parent_fn, sv, fc, dev, runs) -> None:
    """The parent checkout's K11 beside this one on phase 14's lanes: at
    each batch, both r_cmp through this tree's K12 against the same R and
    ok give equal masks, and the compressed points are equal on every lane
    whose A decodes (the ladders differ in their steps, so their limbs, and
    their values on points off the curve, may differ); then device-only
    times in turns; one [K11-ab] line.  runs: {label: (k, a_pt, sig, r_pt,
    ok, A decodes)}."""
    comb = fc.comb_table(dev)

    def parent(k, a_pt, sig):
        r_cmp = torch.empty_like(a_pt)
        parent_call(parent_fn, dev, k.data_ptr(), a_pt.data_ptr(), sig.data_ptr(),
                    comb.data_ptr(), r_cmp.data_ptr(), k.shape[1])
        return r_cmp

    def compressed(r_cmp):
        return fc.point_compress(tuple(r_cmp[c].to(torch.int64) for c in range(4)))

    for label, (k, a_pt, sig, r_pt, ok, a_dec) in runs.items():
        pr, cr = parent(k, a_pt, sig), sv._phase_dsm(k, a_pt, sig)
        check(torch.equal(sv._phase_compare(pr, r_pt, ok), sv._phase_compare(cr, r_pt, ok)),
              f"parent K11 and K11 give other masks at {label}")
        check(torch.equal(compressed(pr)[:, a_dec], compressed(cr)[:, a_dec]),
              f"parent K11 and K11 give other points at {label}")
    ab_times("K11-ab", [(label, 20 if run[0].shape[1] <= 1024 else 5)
                        for label, run in runs.items()],
             {label: (lambda r=run: parent(*r[:3])) for label, run in runs.items()},
             {label: (lambda r=run: sv._phase_dsm(*r[:3])) for label, run in runs.items()})


def k12_ab(parent_fn, sv, dev, checks, timed) -> None:
    """The parent checkout's K12 beside this one: masks equal at each batch
    of `checks` (mixed ok, random bits in r_pt where ok is false), then
    device-only times at each batch of `timed`, in turns; one [K12-ab]
    line.  checks, timed: {label: (r_cmp, r_pt, ok)}."""

    def parent(r_cmp, r_pt, ok):
        mask = torch.empty_like(ok)
        parent_call(parent_fn, dev, r_cmp.data_ptr(), r_pt.data_ptr(), ok.data_ptr(),
                    mask.data_ptr(), ok.shape[0])
        return mask

    for label, run in checks.items():
        check(torch.equal(parent(*run), sv._phase_compare(*run)),
              f"parent K12 and K12 masks differ at {label}")
    ab_times("K12-ab", [(label, K12_REPS) for label in timed],
             {label: (lambda r=run: parent(*r)) for label, run in timed.items()},
             {label: (lambda r=run: sv._phase_compare(*r)) for label, run in timed.items()},
             digits=6)


def k9_ab(parent_fn, sv, dev, checks, timed, max_len) -> None:
    """The parent checkout's K9 beside this one: at each batch of `checks`
    ok equal, and A's and R's limbs equal on every lane where the point
    decodes (and whether they are equal on every lane); then device-only
    times at each batch of `timed`, in turns; one [K9-ab] line.  checks:
    {label: (sig, pubkey, msg_len, A decodes, R decodes)}; timed: {label:
    (sig, pubkey, msg_len)}."""

    def parent(sig, pk, ln):
        a_pt = torch.empty((4, 10, sig.shape[1]), dtype=torch.int32, device=dev)
        r_pt = torch.empty_like(a_pt)
        ok = torch.empty((sig.shape[1],), dtype=torch.bool, device=dev)
        parent_call(parent_fn, dev, sig.data_ptr(), pk.data_ptr(), ln.data_ptr(),
                    a_pt.data_ptr(), r_pt.data_ptr(), ok.data_ptr(), sig.shape[1], max_len)
        return a_pt, r_pt, ok

    def change(sig, pk, ln):
        return sv._phase_validate(sig, pk, ln, max_msg_len=max_len)

    everywhere = []
    for label, (sig, pk, ln, a_dec, r_dec) in checks.items():
        (pa, pr, pok), (ca, cr, cok) = parent(sig, pk, ln), change(sig, pk, ln)
        check(torch.equal(pok, cok), f"parent K9 and K9 ok differ at {label}")
        check(torch.equal(pa[:, :, a_dec], ca[:, :, a_dec])
              and torch.equal(pr[:, :, r_dec], cr[:, :, r_dec]),
              f"parent K9 and K9 limbs differ where the point decodes at {label}")
        everywhere.append(f"{label} {torch.equal(pa, ca) and torch.equal(pr, cr)}")
    log(f"[K9-ab] ok equal, limbs equal where the point decodes; limbs equal on every"
        f" lane: {', '.join(everywhere)}")
    ab_times("K9-ab", [(label, 20 if run[0].shape[1] <= 1024 else 5)
                       for label, run in timed.items()],
             {label: (lambda r=run: parent(*r)) for label, run in timed.items()},
             {label: (lambda r=run: change(*r)) for label, run in timed.items()})


def k10_ab(parent_fn, sv, dev, checks, timed, max_len) -> None:
    """The parent checkout's K10 beside this one: k's bytes equal at each
    batch of `checks`, then device-only times at each batch of `timed`, in
    turns; one [K10-ab] line.  checks, timed: {label: (msg, msg_len, sig,
    pubkey)}."""

    def parent(msg, ln, sig, pk):
        k = torch.empty((32, sig.shape[1]), dtype=torch.uint8, device=dev)
        parent_call(parent_fn, dev, msg.data_ptr(), ln.data_ptr(), sig.data_ptr(),
                    pk.data_ptr(), k.data_ptr(), sig.shape[1], max_len)
        return k

    def change(msg, ln, sig, pk):
        return sv._phase_hash(msg, ln, sig, pk, max_msg_len=max_len)

    for label, run in checks.items():
        check(torch.equal(parent(*run), change(*run)), f"parent K10 and K10 differ at {label}")
    ab_times("K10-ab", [(label, 50 if run[0].shape[1] <= 1024 else 10)
                        for label, run in timed.items()],
             {label: (lambda r=run: parent(*r)) for label, run in timed.items()},
             {label: (lambda r=run: change(*r)) for label, run in timed.items()})


def k4_ab(parent_fn, fsha256, dev, states, n) -> None:
    """The parent checkout's K4 beside this one: equal bytes at each chain
    count, then device-only times in turns; one [K4-ab] line.  states:
    {B: (32, B) uint8}."""

    def parent(x):
        out = torch.empty_like(x)
        parent_call(parent_fn, dev, x.data_ptr(), out.data_ptr(), x.shape[1], n)
        return out

    for b, x in states.items():
        check(torch.equal(parent(x), fsha256.sha256_iter32(x, n)),
              f"parent K4 and K4 differ at B = {b}")
    ab_times("K4-ab", [(f"B={b}", 3) for b in states],
             {f"B={b}": (lambda x=x: parent(x)) for b, x in states.items()},
             {f"B={b}": (lambda x=x: fsha256.sha256_iter32(x, n)) for b, x in states.items()})


def offset_rows(m: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """A copy of m on its device starting `offset` bytes into its buffer, so
    its rows are not 16-byte aligned (the hash kernels' narrow path)."""
    flat = torch.empty(m.numel() + offset, dtype=m.dtype, device=m.device)
    t = flat[offset:].view(m.shape)
    t.copy_(m)
    return t


def msg_ab(tag: str, parent_fn, change, batches, digest: int = 32,
           with_max_len: bool = False) -> None:
    """The parent checkout's message-hash kernel (K3, K14, K16 or K17:
    (msg, len, out, B[, max_len])) beside this one: bytes equal at each
    batch, then device-only times in turns; one [tag] line.  digest: the
    output's rows (K3's 64); with_max_len: the entry point takes max_len
    (K3's, msg.shape[0]).  change launches without the wrappers' length
    check, whose host sync the timing's busy-wait cannot hide.  batches:
    {label: (msg, msg_len)}."""

    def parent(m, ln):
        out = torch.empty((digest, m.shape[1]), dtype=torch.uint8, device=m.device)
        parent_call(parent_fn, m.device, m.data_ptr(), ln.data_ptr(), out.data_ptr(),
                    m.shape[1], *((m.shape[0],) if with_max_len else ()))
        return out

    for label, run in batches.items():
        check(torch.equal(parent(*run), change(*run)), f"parent {tag[:3]} and {tag[:3]} differ"
              f" at {label}")
    ab_times(tag, [(label, 20) for label in batches],
             {label: (lambda r=run: parent(*r)) for label, run in batches.items()},
             {label: (lambda r=run: change(*r)) for label, run in batches.items()})


def k13_ab(parent_fn, flt, dev, runs) -> None:
    """The parent checkout's K13 beside this one: its one launch with a
    zeroed scratch of its own (which it leaves zero); sums equal, signed
    and unsigned, at each N, then device-only times in turns; one [K13-ab]
    line.  runs: {label: (rows, signs)}."""
    scratch = torch.zeros((flt.LEN_ELEMS // 2,), dtype=torch.int64, device=dev)

    def parent(v, s):
        n = v.shape[0]
        out = torch.empty((flt.LEN_ELEMS,), dtype=torch.int32, device=dev)
        parent_call(parent_fn, dev, v.data_ptr(), None if s is None else s.data_ptr(),
                    scratch.data_ptr(), out.data_ptr(), n,
                    max(1, min(PARENT_K13_CHUNKS[0], n // PARENT_K13_CHUNKS[1])))
        return out

    for label, (v, s) in runs.items():
        check(torch.equal(parent(v, s), flt.combine_device(v, s))
              and torch.equal(parent(v, None), flt.combine_device(v)),
              f"parent K13 and K13 differ at {label}")
    ab_times("K13-ab", [(label, 50) for label in runs],
             {label: (lambda r=run: parent(*r)) for label, run in runs.items()},
             {label: (lambda r=run: flt.combine_device(*r)) for label, run in runs.items()})


def k15_ab(parent_fn, fsha256, dev, runs) -> None:
    """The parent checkout's K15 beside this one: digests equal at each
    batch, then device-only times in turns; one [K15-ab] line.  runs:
    {label: (state, mixin)}."""

    def parent(st, mx):
        out = torch.empty_like(st)
        parent_call(parent_fn, dev, st.data_ptr(), mx.data_ptr(), out.data_ptr(), st.shape[1])
        return out

    for label, run in runs.items():
        check(torch.equal(parent(*run), fsha256.sha256_mix32(*run)),
              f"parent K15 and K15 differ at {label}")
    ab_times("K15-ab", [(label, 50) for label in runs],
             {label: (lambda r=run: parent(*r)) for label, run in runs.items()},
             {label: (lambda r=run: fsha256.sha256_mix32(*r)) for label, run in runs.items()})


def knob_times(tag: str, variants: dict, labels) -> None:
    """Device-only times of each variant at each label, in turns (every
    variant in order, then in reverse); one [tag] line.  variants: {name:
    {label: a call}}."""
    names = list(variants)
    times = {}
    for name in names + names[::-1]:
        for label in labels:
            times.setdefault((name, label), []).append(
                time_ms(variants[name][label], reps=50, hide_host=True))
    log(f"[{tag}] device-only us, two turns each (every variant in order, then in reverse): "
        + "; ".join(f"{label}: " + ", ".join(
            f"{name} {' / '.join(f'{t * 1e3:.2f}' for t in times[(name, label)])}"
            for name in names) for label in labels))


def k13_knobs(kbuild, fns, flt, dev, runs) -> None:
    """This tree's K13 built with clusters of 4, 8 and 16 blocks, and at
    its own cluster size with each chunk rule of K13_CHUNK_RULES: each
    equal to the wrapper's sum at each N, twice (the scratch is left zero),
    then device-only times in turns; one [K13-knobs] line.  runs: {label:
    (rows, signs)}."""
    check(K13_CHUNK_RULES[0] == (flt._MIN_ROWS_PER_CHUNK, flt._MAX_CHUNKS),
          "K13_CHUNK_RULES[0] is not the wrapper's chunk rule")
    with open(os.path.join(kbuild.CSRC_DIR, "lthash_combine.cu")) as f:
        own = int(re.search(r"#define LT_CLUSTER (\d+)", f.read()).group(1))

    def variant(fn, min_rows, max_chunks):
        scratch = torch.zeros((flt.LEN_ELEMS // 2,), dtype=torch.int64, device=dev)

        def call(v, s):
            n = v.shape[0]
            out = torch.empty((flt.LEN_ELEMS,), dtype=torch.int32, device=dev)
            parent_call(fn, dev, v.data_ptr(), s.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                        n, max(1, min(max_chunks, n // min_rows)))
            return out
        return call

    calls = {}
    for cl in sorted((4, 8, 16), key=lambda c: c != own):
        for mr, mc in K13_CHUNK_RULES if cl == own else K13_CHUNK_RULES[:1]:
            calls[f"cluster {cl} >={mr} rows <={mc} chunks"] = variant(
                fns[f"lthash_cluster{cl}"], mr, mc)
    for name, call in calls.items():
        for label, (v, s) in runs.items():
            want = flt.combine_device(v, s)
            check(torch.equal(call(v, s), want) and torch.equal(call(v, s), want),
                  f"K13 with {name} differs from the wrapper's sum at {label}")
    knob_times("K13-knobs", {name: {label: (lambda c=call, r=run: c(*r))
                                    for label, run in runs.items()}
                             for name, call in calls.items()}, list(runs))


def k15_knobs(fns, fsha256, dev) -> None:
    """This tree's K15 built with one warp pair a block and with four, at
    each of K15_KNOB_BATCHES (seeded rows on the card): digests equal to
    sha256_mix32's, then device-only times in turns; one [K15-knobs] line."""
    gen = torch.Generator(device=dev).manual_seed(15)
    runs = {f"B={b}": tuple(torch.randint(0, 256, (32, b), dtype=torch.uint8, device=dev,
                                          generator=gen) for _ in range(2))
            for b in K15_KNOB_BATCHES}

    def variant(fn):
        def call(st, mx):
            out = torch.empty_like(st)
            parent_call(fn, dev, st.data_ptr(), mx.data_ptr(), out.data_ptr(), st.shape[1])
            return out
        return call

    calls = {"one pair a block": variant(fns["mix32_pairs1"]),
             "four pairs a block": variant(fns["mix32_pairs4"])}
    for name, call in calls.items():
        for label, run in runs.items():
            check(torch.equal(call(*run), fsha256.sha256_mix32(*run)),
                  f"K15 with {name} differs from sha256_mix32 at {label}")
    knob_times("K15-knobs", {name: {label: (lambda c=call, r=run: c(*r))
                                    for label, run in runs.items()}
                             for name, call in calls.items()}, list(runs))


def l2_cold_call(fn, run, nbytes: int):
    """A call of fn on the next of enough copies of run's tensors that the
    bytes the calls move (nbytes each) between two uses of one copy are at
    least twice the L2; the last outputs are kept alive, so their buffers
    rotate too.  Each call then reads its inputs from HBM and writes lines
    that are not in the L2."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    sets = [run] + [tuple(t.clone() for t in run) for _ in range(-(-2 * l2 // nbytes) - 1)]
    outs = [None] * len(sets)
    turn = [0]

    def call():
        i = turn[0] = (turn[0] + 1) % len(sets)
        outs[i] = fn(*sets[i])

    return call


def conv_ab(parent_fn, fprobe, dev, runs, timed) -> None:
    """The parent checkout's probe_conv beside this one: outputs equal at
    each batch, then device-only times in turns, each call made by
    timed(fn, batch) as phase 2b times it; one [probe_conv-ab] line, ms to
    5 places.  runs: {batch: (a, b)}."""

    def parent(a, b):
        out = torch.empty((2 * fprobe.NLIMB - 1, a.shape[1]), dtype=torch.int32, device=dev)
        parent_call(parent_fn, dev, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1])
        return out

    for bsz, run in runs.items():
        check(torch.equal(parent(*run), fprobe.probe_conv(*run)),
              f"parent probe_conv and probe_conv differ at B={bsz}")
    ab_times("probe_conv-ab", [(f"B={bsz}", PROBE_REPS) for bsz in runs],
             {f"B={bsz}": timed(parent, bsz) for bsz in runs},
             {f"B={bsz}": timed(fprobe.probe_conv, bsz) for bsz in runs}, digits=5)


def k2_call(fn, dev, x, y, k):
    """One launch of a built fd_fe_mul_chain (the parent's or a knob build's)."""
    xo, yo = torch.empty_like(x), torch.empty_like(y)
    parent_call(fn, dev, x.data_ptr(), y.data_ptr(), xo.data_ptr(), yo.data_ptr(),
                x.shape[1], k)
    return xo, yo


def k2_ab(parent_fn, fl, dev, runs, k) -> None:
    """The parent checkout's K2 beside this one: raw limbs equal at each
    batch, then device-only times in turns; one [K2-ab] line.  runs:
    {batch: (x, y)}."""
    for bsz, run in runs.items():
        check(all(map(torch.equal, k2_call(parent_fn, dev, *run, k), fl.fe_mul_chain(*run, k))),
              f"parent K2 and K2 differ at B={bsz}")
    ab_times("K2-ab", [(f"B={bsz}", 50) for bsz in runs],
             {f"B={bsz}": (lambda r=run: k2_call(parent_fn, dev, *r, k)) for bsz, run in runs.items()},
             {f"B={bsz}": (lambda r=run: fl.fe_mul_chain(*r, k)) for bsz, run in runs.items()})


def k2_knobs(fns, fl, dev, runs, k) -> None:
    """This tree's K2 built with each product form of K2_KNOBS, all else
    equal: raw limbs equal to fe_mul_chain's at each batch, then
    device-only times in turns; one [K2-knobs] line."""
    calls = {label: fns[build] for label, build in K2_KNOBS.items()}
    for name, fn in calls.items():
        for bsz, run in runs.items():
            check(all(map(torch.equal, k2_call(fn, dev, *run, k), fl.fe_mul_chain(*run, k))),
                  f"K2 with the {name} differs from fe_mul_chain at B={bsz}")
    knob_times("K2-knobs", {name: {f"B={bsz}": (lambda f=fn, r=run: k2_call(f, dev, *r, k))
                                   for bsz, run in runs.items()}
                            for name, fn in calls.items()}, [f"B={bsz}" for bsz in runs])


def k2_sass(fsass, kbuild, with_parent: bool) -> dict:
    """K2's chain loops by opcode, with the stall clocks ptxas set
    (utils/sass.py over cuobjdump -sass): this tree's build and, with
    --parent, the parent's and the knob builds'.
    One [K2-sass] line each; {build: loops}.  This tree's and the knob
    builds' first loop is the chain's first two steps, one multiply an
    iteration (every product IMAD.WIDE), their second the rest, two
    multiplies an iteration; the parent's first loop runs four multiplies
    an iteration (each fe_mul a CALL, counted into the loop)."""
    libs = {"this tree": os.path.join(kbuild.build_dir(), "libfe_mul_chain.so")}
    if with_parent:
        libs["parent"] = parent_lib("fe_mul_chain")
        libs.update({label: parent_lib(build) for label, build in K2_KNOBS.items()
                     if build != "fe_product_dfma"})
    out = {}
    for who, so in libs.items():
        out[who] = fsass.loops(fsass.dump(so), "fe_mul_chain_kernel")
        log(f"[K2-sass] {who}: " + "; ".join(
            f"loop {i}: {lp['n']} instructions ({lp['called']} called), chain {lp['depth']},"
            f" {lp['clocks']} stall clocks: "
            + ", ".join(f"{op} {c}" for op, c in lp["forms"].items())
            for i, lp in enumerate(out[who])))
    return out


def k5_bounds(t: int, m: int, k: int, s: int, n_mats: int, int_ops_per_s: float) -> dict:
    """K5's bounds at T sets of (m x k) x S bytes, in ms: the bytes (each
    input byte read once, each output byte written once), the table form's
    instructions (GF_OPS_PER_MULADD a GF(2^8) multiply-add at the integer
    rate) and the tensor-core form's operations (8m x 8k x S x T int8
    multiply-adds at INT8_TC_OPS_PER_S); the least time the card could take
    is the smaller operations bound, or the bytes bound where that is
    larger (bound_form names which)."""
    muladds = t * m * k * s
    out = dict(bytes_ms=(t * (k + m) * s + n_mats * m * k) / HBM_BYTES_PER_S * 1e3,
               table_ms=muladds * GF_OPS_PER_MULADD / int_ops_per_s * 1e3,
               tc_ms=2 * 64 * muladds / INT8_TC_OPS_PER_S * 1e3)
    ops_ms, form = min((out["tc_ms"], "tensor cores"), (out["table_ms"], "table"))
    if out["bytes_ms"] > ops_ms:
        return dict(out, bound_ms=out["bytes_ms"], bound_by="bytes", bound_form="bytes")
    return dict(out, bound_ms=ops_ms, bound_by="operations", bound_form=form)


def k5_parent(parent_fn, dev):
    """The parent checkout's K5 (the tensor-core form, no tables) as a call
    (mat, data) -> out, with its wrapper's matrix stride and load path."""

    def call(mat, data):
        t, k, s = data.shape
        m = mat.shape[1]
        out = torch.empty((t, m, s), dtype=torch.uint8, device=dev)
        parent_call(parent_fn, dev, mat.data_ptr(), 0 if mat.shape[0] == 1 else m * k,
                    data.data_ptr(), out.data_ptr(), t, m, k, s,
                    int(s % 16 == 0 and data.data_ptr() % 16 == 0))
        return out
    return call


def k5_ab(parent, g2, runs) -> None:
    """The parent checkout's K5 beside this one: bytes equal at every timed
    shape, then device-only times in turns; one [K5-ab] line.  runs:
    {label: (mat, data)}."""
    for label, run in runs.items():
        check(torch.equal(parent(*run), g2.gf_apply_batch(*run)),
              f"parent K5 and K5 differ at {label}")
    ab_times("K5-ab", [(label, 50) for label in runs],
             {label: (lambda r=run: parent(*r)) for label, run in runs.items()},
             {label: (lambda r=run: g2.gf_apply_batch(*r)) for label, run in runs.items()},
             digits=5)


def k5_sass(kbuild) -> None:
    """K5's loops by opcode form, from `python -m firedancer_tpu_torch.utils.sass
    --forms` on this tree's build; one [K5-sass] line a loop.  Fails unless
    a loop issues tensor-core MMAs (IMMA or HMMA) and no such loop reads
    single bytes from shared memory (the table form's LDS.U8)."""
    so = os.path.join(kbuild.build_dir(), "libgf256_apply.so")
    r = subprocess.run([sys.executable, "-m", "firedancer_tpu_torch.utils.sass", "--forms", so,
                        "gf256_apply_kernel"], capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0, f"utils.sass on K5 failed: {r.stderr.strip()[-500:]}")
    lines = [ln.split(" ", 1)[1] for ln in r.stdout.splitlines() if ln.strip()]
    for ln in lines:
        log(f"[K5-sass] {ln}")
    mma = [ln for ln in lines if re.search(r"\b[IH]MMA", ln)]
    check(mma, "K5's loops issue no tensor-core MMA (IMMA/HMMA)")
    check(not any("LDS.U8" in ln for ln in mma), "a K5 MMA loop reads single shared bytes")


def k5_launch_times(recs, launch, int_ops_per_s, parent=None) -> list[dict]:
    """K5's launches recorded on a path, each shape (T, m, k, S) timed alone
    on its first launch's inputs, device only, beside its least bound (and
    the parent's K5 on the same inputs right after): one dict a launch.
    launch: the wrapper (gf_apply_batch)."""
    shapes = {}
    for mat, data in recs:
        t, k, s = data.shape
        key = (t, mat.shape[1], k, s)
        if key not in shapes:
            x = k5_bounds(*key, mat.shape[0], int_ops_per_s)
            x["ms"] = time_ms(lambda r=(mat, data): launch(*r), reps=50, hide_host=True)
            if parent is not None:
                x["parent_ms"] = time_ms(lambda r=(mat, data): parent(*r), reps=50,
                                         hide_host=True)
            shapes[key] = x
    return [dict(shape=key, **shapes[key]) for key in
            ((d.shape[0], m.shape[1], d.shape[1], d.shape[2]) for m, d in recs)]


def k5_launch_summary(phase: str, per: list[dict]) -> str:
    """Phase `phase`'s K5 launches by shape: count, time, least bound (and
    the parent's time); the sums of (time - bound)."""
    by = {}
    for x in per:
        by.setdefault(x["shape"], [0, x])[0] += 1
    with_parent = bool(per) and "parent_ms" in per[0]
    loss = sum(x["ms"] - x["bound_ms"] for x in per)
    text = f"phase {phase}: {len(per)} launches, " + "; ".join(
        f"({t}, {m}x{k}, {s}) x{n}: {x['ms'] * 1e3:.2f} us, bound {x['bound_ms'] * 1e3:.3f} us"
        f" ({x['bound_form']})" + (f", parent {x['parent_ms'] * 1e3:.2f} us" if with_parent else "")
        for (t, m, k, s), (n, x) in by.items()) + f"; sum of (time - bound) {loss * 1e3:.2f} us"
    if with_parent:
        text += f", the parent's {sum(x['parent_ms'] - x['bound_ms'] for x in per) * 1e3:.2f} us"
    return text


def device_kernels(fn) -> list[str] | None:
    """The device kernels one call of fn launches, by name, from a
    torch.profiler trace of that call; None if the trace holds no device
    activity (the profiler does not reach the card)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def time_host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an H100",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import firedancer_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"chip_smoke: the package firedancer_tpu_torch is not beside this script ({e})",
              file=sys.stderr)
        return 1
    from firedancer_tpu_torch import entry as tentry
    from firedancer_tpu_torch.flamenco.runtime import replay_block
    from firedancer_tpu_torch.models.leader import (
        build_leader_pipeline,
        build_sharded_leader_pipeline,
        build_sharded_verify_pipeline,
        build_verify_pipeline,
    )
    from firedancer_tpu_torch.flamenco.agave_state import vote_state_decode
    from firedancer_tpu_torch.flamenco.executor import acct_decode
    from firedancer_tpu_torch.flamenco import alt as falt
    from firedancer_tpu_torch.flamenco import nonce as fnonce
    from firedancer_tpu_torch.models.workload import (
        mixed_batch,
        noncanonical_encodings,
        nonce_bank_ctx,
        program_bank_ctx,
        program_stream,
        sbpf_bank_ctx,
        sbpf_stream,
        zk_bank_ctx,
        zk_proofs,
        zk_stream,
        nonce_keys,
        nonce_transfers,
        nonsquare_encodings,
        torsion_encodings,
        verify_stream,
        vote_bank_ctx,
        vote_stream,
    )
    from firedancer_tpu_torch.ops import blake3 as fb3
    from firedancer_tpu_torch.ops import bmtree as fbm
    from firedancer_tpu_torch.ops import chacha20 as fcc
    from firedancer_tpu_torch.ops import gf256 as g2
    from firedancer_tpu_torch.ops import keccak256 as fkk
    from firedancer_tpu_torch.ops import limbs as fl
    from firedancer_tpu_torch.ops import lthash as flt
    from firedancer_tpu_torch.ops import probe as fprobe
    from firedancer_tpu_torch.ops import reedsol as rs
    from firedancer_tpu_torch.ops import sha256 as fsha256
    from firedancer_tpu_torch.ops import sha512 as fsha
    from firedancer_tpu_torch.ops import sigverify as sv
    from firedancer_tpu_torch.ops.ref import ed25519_ref as ref
    from firedancer_tpu_torch.ops.ref import gf256_ref as gr
    from firedancer_tpu_torch.pack.cost import MAX_COST_PER_BLOCK, compute_cost
    from firedancer_tpu_torch.parallel.serve import ServeConfig, ServePlane
    from firedancer_tpu_torch.protocol import shred as fs
    from firedancer_tpu_torch.protocol import txn as ft
    from firedancer_tpu_torch.protocol import txn_native as ftn
    from firedancer_tpu_torch.runtime import poh as rpoh
    from firedancer_tpu_torch.runtime.bank import default_bank_ctx
    from firedancer_tpu_torch.funk import Funk
    from firedancer_tpu_torch.runtime.benchg import gen_transfer_pool, pool_payers
    from firedancer_tpu_torch.runtime.net import (QuicIngressStage, QuicTxnClient,
                                                  UdpIngressStage, send_paced)
    from firedancer_tpu_torch.runtime.poh_stage import parse_entry
    from firedancer_tpu_torch.runtime.shred_native import ENCODE_FN, NativeShredder
    from firedancer_tpu_torch.runtime.shred_stage import ShredStage, deshred_entry_batch
    from firedancer_tpu_torch.runtime.shredder import EntryBatchMeta, Shredder
    from firedancer_tpu_torch.runtime.slot_clock import SlotClockCfg
    from firedancer_tpu_torch.runtime.store import StoreStage
    from firedancer_tpu_torch.runtime.verify import VerifyStage, decode_verified, encode_verified
    from firedancer_tpu_torch.tango import native as tnat
    from firedancer_tpu_torch.tango import shm as tshm
    from firedancer_tpu_torch.utils.metrics import hist_quantile as tune_quantile
    from firedancer_tpu_torch.utils import hostbuild, kbuild
    from firedancer_tpu_torch.utils import sass as fsass
    from firedancer_tpu_torch.utils.platform import resolve_device

    t_start = time.perf_counter()
    marks = [("1", t_start)]

    def mark(phase: str) -> None:
        """Note the host time at which a phase starts, for the [time] line."""
        marks.append((phase, time.perf_counter()))

    # -- 1. device ------------------------------------------------------------
    dev = resolve_device()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    props = torch.cuda.get_device_properties(0)
    smi = nvidia_smi("name,power.limit")
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_ops_per_s = props.multi_processor_count * INT_OPS_PER_CLK_PER_SM * clk_mhz * 1e6
    log(f"[device] {name} count={count} capability={torch.cuda.get_device_capability(0)}"
        f" sms={props.multi_processor_count} max_sm_clock={clk_mhz} MHz"
        f" torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    shm_st = os.statvfs("/dev/shm")
    log(f"[device] /dev/shm: {shm_st.f_blocks * shm_st.f_frsize / 2**20:.0f} MiB, "
        f"{shm_st.f_bavail * shm_st.f_frsize / 2**20:.0f} MiB free (the pipelines' shm links)")
    # the K5 plain version's float32 matmul is exact in full float32; TF32
    # would also be exact for 0/1 inputs, but the reference says what it runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] torch.backends.cuda.matmul.allow_tf32 = False,"
        " torch.backends.cudnn.allow_tf32 = False")

    def bound(ops: float, nbytes: float) -> tuple[float, str]:
        """(least ms for the work, what sets it): the larger of operations
        over the integer rate and bytes over the memory rate."""
        t_ops, t_bytes = ops / int_ops_per_s, nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    # -- 2. build ---------------------------------------------------------------
    mark("2")
    t0 = time.perf_counter()
    parent_build = start_parent_build(kbuild, PARENT) if PARENT else None
    # the host libraries (pack's native lane and its tcache, the native
    # executor lane and the txn parser) build with g++ beside the kernels'
    # nvcc processes
    with concurrent.futures.ThreadPoolExecutor(len(HOST_LIBS)) as pool_:
        host_builds = [pool_.submit(hostbuild.build, n_) for n_ in HOST_LIBS]
        kbuild.build_all()
        host_paths = [f_.result() for f_ in host_builds]
    parent_fns = finish_parent_build(parent_build) if parent_build else None
    log(f"[build] {kbuild.kernel_names()} in {time.perf_counter() - t0:.1f} s"
        f" ({kbuild.build_dir()}); host libraries {host_paths}")
    kernels = []

    # -- 2b. the toolchain probes ------------------------------------------------
    mark("2b")
    rng = np.random.default_rng(1)
    xa, ya = (torch.from_numpy(rng.integers(-2**31, 2**31, (8, 128), dtype=np.int64)
                               .astype(np.int32)).to(dev) for _ in range(2))
    got = fprobe.probe_add(xa, ya)
    torch.cuda.synchronize()
    erra = int((got.to(torch.int64) - fprobe.probe_add_plain(xa, ya).to(torch.int64))
               .abs().max())
    check(erra == 0, "probe_add differs from its plain version")
    ints = (xa.cpu().numpy().astype(np.int64) + ya.cpu().numpy().astype(np.int64))
    check(((ints + 2**31) % 2**32 - 2**31 == got.cpu().numpy()).all(),
          "probe_add differs from Python ints")
    ca, cb = (torch.from_numpy(rng.integers(-2**12, 2**12, (fprobe.NLIMB, 512),
                                            dtype=np.int64).astype(np.int32)).to(dev)
              for _ in range(2))
    conv = fprobe.probe_conv(ca, cb)
    torch.cuda.synchronize()
    errc = int((conv.to(torch.int64) - fprobe.probe_conv_plain(ca, cb).to(torch.int64))
               .abs().max())
    check(errc == 0, "probe_conv differs from its plain version")
    cah, cbh, convh = ca.cpu().numpy(), cb.cpu().numpy(), conv.cpu().numpy()
    for lane in (0, 511):
        want = [sum(int(cah[i, lane]) * int(cbh[k - i, lane])
                    for i in range(max(0, k - 19), min(k, 19) + 1)) for k in range(39)]
        check(convh[:, lane].tolist() == want, f"probe_conv lane {lane} != Python ints")
    check(torch.equal(xa + ya, got), "probe_add differs from torch.add")
    # probe_conv at the probe's shape and at CONV_BATCHES: full int32 rows with
    # the extremes on the first lanes (wrapping mod 2^32), equal to plain
    conv_runs = {512: (ca, cb)}
    for bsz in CONV_BATCHES[1:]:
        ab = rng.integers(-2**31, 2**31, (2, fprobe.NLIMB, bsz), dtype=np.int64)
        ab[:, :, :3] = np.array([2**31 - 1, -2**31, -2**31 + 1])
        conv_runs[bsz] = tuple(torch.from_numpy(v.astype(np.int32)).to(dev) for v in ab)
        check(torch.equal(fprobe.probe_conv(*conv_runs[bsz]),
                          fprobe.probe_conv_plain(*conv_runs[bsz])),
              f"probe_conv differs from its plain version at B={bsz}")

    def conv_bytes(bsz):
        return bsz * (2 * fprobe.NLIMB + 2 * fprobe.NLIMB - 1) * 4

    def conv_bound(bsz):
        return bound(bsz * 400, conv_bytes(bsz))

    def conv_timed(fn, bsz):
        """A call of fn to time at batch bsz: at the probe's own 512 on the
        same inputs (in the L2, as probe_add's), past it with a cold L2."""
        if bsz == CONV_BATCHES[0]:
            return lambda: fn(*conv_runs[bsz])
        return l2_cold_call(fn, conv_runs[bsz], conv_bytes(bsz))

    if parent_fns:
        conv_ab(parent_fns["fd_probe_conv"], fprobe, dev, conv_runs, conv_timed)
    # per call as a caller sees it (the launch's host cost included), then
    # the card's time alone (hide_host): probe_add and torch.add, and beside
    # them probe_conv at each batch, in turns
    msa, liba, msa_dev, liba_dev = [], [], [], []
    msc_dev = {bsz: [] for bsz in conv_runs}
    conv_calls = {bsz: conv_timed(fprobe.probe_conv, bsz) for bsz in conv_runs}
    for _ in range(2):
        msa.append(time_ms(lambda: fprobe.probe_add(xa, ya), reps=PROBE_REPS))
        liba.append(time_ms(lambda: torch.add(xa, ya), reps=PROBE_REPS))  # wraps mod 2^32 too
        msa_dev.append(time_ms(lambda: fprobe.probe_add(xa, ya), reps=PROBE_REPS, hide_host=True))
        liba_dev.append(time_ms(lambda: torch.add(xa, ya), reps=PROBE_REPS, hide_host=True))
        for bsz, call in conv_calls.items():
            msc_dev[bsz].append(time_ms(call, reps=PROBE_REPS, hide_host=True))
    del conv_calls
    msa, liba, msa_dev, liba_dev = (float(np.median(v)) for v in (msa, liba, msa_dev, liba_dev))
    msc_dev = {bsz: float(np.median(v)) for bsz, v in msc_dev.items()}
    host_ns = probe_host_breakdown(fprobe, kbuild, xa, ya, dev)
    msc = time_ms(lambda: fprobe.probe_conv(ca, cb), reps=50)
    plaina = time_host_ms(lambda: fprobe.probe_add_plain(xa, ya))
    plainc = time_host_ms(lambda: fprobe.probe_conv_plain(ca, cb))

    # no single PyTorch call computes probe_conv (CUDA has no integer conv)
    for nm, line, err, ms_, plain_, lib_, (bms, bby), shp in (
            ("probe_add", 18, erra, msa, plaina, liba, bound(1024, 3 * 4 * 1024),
             "(8, 128) int32"),
            ("probe_conv", 34, errc, msc_dev[512], plainc, None, conv_bound(512),
             "(20, 512) int32 x2 -> (39, 512)")):
        kernels.append(dict(
            name=nm, route="cuda", source="firedancer_tpu_torch/csrc/probe.cu",
            replaces=f"scripts/probe_pallas.py:{line}", launches=None,
            max_abs_err=err, ms=ms_, plain_ms=plain_, bound_ms=bms, bound_by=bby,
            library_ms=lib_, matched=True, shape=shp,
            phase_launches=kbuild.LAUNCHES[nm]))
    kernels[0].update(device_ms=msa_dev, library_device_ms=liba_dev, host_ns=host_ns)
    kernels[1].update(ms_per_call=msc, at_batch={str(bsz): dict(
        ms=msc_dev[bsz], bound_ms=conv_bound(bsz)[0], bound_by=conv_bound(bsz)[1],
        l2="warm" if bsz == CONV_BATCHES[0] else "cold") for bsz in conv_runs})
    log(f"[probes] probe_add (8, 128): exact, {msa:.4f} ms a call (torch.add {liba:.4f} ms),"
        f" device only {msa_dev:.4f} ms (torch.add {liba_dev:.4f} ms), medians of 2 x"
        f" {PROBE_REPS} calls each; probe_conv: exact (and with int32 extremes at"
        f" {', '.join(str(b) for b in CONV_BATCHES[1:])}), {msc:.4f} ms a call at 512,"
        " device only (median of 2, in turns with probe_add; past 512 with a cold L2): "
        + ", ".join(f"B={bsz} {t * 1e3:.2f} us (bound {conv_bound(bsz)[0] * 1e3:.3f} us,"
                    f" {conv_bound(bsz)[1]})" for bsz, t in msc_dev.items()))
    log(f"[probes-host] ns a call, mean of {HOST_CALLS} calls each: "
        + ", ".join(f"{k} {v:.0f}" for k, v in host_ns.items()))

    # -- 3. K2 fe_mul_chain -------------------------------------------------------
    mark("3")
    B2, K2 = K2_BATCHES[0], 64
    rng = np.random.default_rng(2)
    xs = [int.from_bytes(rng.bytes(32), "little") % fl.P for _ in range(B2)]
    ys = [int.from_bytes(rng.bytes(32), "little") % fl.P for _ in range(B2)]
    xl, yl = (np.stack([fl.int_to_limbs(v) for v in vs], -1) for vs in (xs, ys))
    # the first 64 lanes at the carried extremes, signs seeded: the lanes where
    # a lost sign or carry in the product's lowering would show
    ext = np.array(K2_CARRIED_MAX, dtype=np.int64)[:, None]
    xl[:, :64], yl[:, :64] = (rng.choice((-1, 1), (fl.NLIMB, 64)) * ext for _ in range(2))
    xs[:64], ys[:64] = ([fl.limbs_to_int(v[:, i]) for i in range(64)] for v in (xl, yl))
    x, y = (torch.from_numpy(v).to(torch.int32).to(dev).contiguous() for v in (xl, yl))
    kx, ky = fl.fe_mul_chain(x, y, K2)
    torch.cuda.synchronize()
    px, py = fl.fe_mul_chain_plain(x, y, K2)
    canon = lambda t: fl.fe_freeze(t.to(torch.int64))
    err2 = max(int((canon(kx) - canon(px)).abs().max()),
               int((canon(ky) - canon(py)).abs().max()))
    check(err2 == 0, f"K2 differs from its plain version (max abs err {err2})")
    check(torch.equal(kx, px) and torch.equal(ky, py), "K2 raw limbs differ")
    kxh = kx.cpu().numpy()
    for i in [*range(4), *rng.choice(B2, 32, replace=False)]:
        a, b = xs[i], ys[i]
        for _ in range(K2):
            a, b = a * b % fl.P, a
        check(fl.limbs_to_int(kxh[:, i]) == a, f"K2 lane {i} != Python ints")
    runs2 = {bsz: tuple(v.repeat(1, -(-bsz // B2))[:, :bsz].contiguous() for v in (x, y))
             for bsz in K2_BATCHES}
    for bsz, run in runs2.items():
        check(all(map(torch.equal, fl.fe_mul_chain(*run, K2), fl.fe_mul_chain_plain(*run, K2))),
              f"K2 raw limbs differ at B={bsz}")
    # an odd count past the first two steps runs one split step before the loop
    check(all(map(torch.equal, fl.fe_mul_chain(x, y, K2 + 1),
                  fl.fe_mul_chain_plain(x, y, K2 + 1))), f"K2 raw limbs differ at k={K2 + 1}")
    if parent_fns:
        k2_ab(parent_fns["fd_fe_mul_chain"], fl, dev, runs2, K2)
        k2_knobs(parent_fns, fl, dev, runs2, K2)
    sass2 = k2_sass(fsass, kbuild, bool(parent_fns))
    ms2 = {bsz: time_ms(lambda r=run: fl.fe_mul_chain(*r, K2), reps=50, hide_host=True)
           for bsz, run in runs2.items()}
    ms2call = time_ms(lambda: fl.fe_mul_chain(x, y, K2), reps=20)
    plain2 = time_host_ms(lambda: fl.fe_mul_chain_plain(x, y, K2))

    def k2_bound(bsz):
        """K2's least time on its lowering: the DFMA on the FP64 pipe, the
        IMAD.WIDE on the integer pipe, all products through issue; the
        busiest of the three, or the bytes."""
        dfma = bsz * max(0, K2 - 2) * K2_DFMA_PER_MUL
        imad = bsz * K2 * sv.PRODUCTS_PER_MUL - dfma
        per_clk = props.multi_processor_count * clk_mhz * 1e6
        t_ops = max(dfma / FP64_FMA_PER_CLK_PER_SM, imad / INT_OPS_PER_CLK_PER_SM,
                    (dfma + imad) / DISPATCH_PER_CLK_PER_SM) / per_clk
        t_bytes = 4 * bsz * fl.NLIMB * 4 / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")

    kernels.append(dict(
        name="fe_mul_chain", route="cuda",
        source="firedancer_tpu_torch/csrc/fe_mul_chain.cu",
        replaces="scripts/perf_fe.py:114", launches=None, max_abs_err=err2,
        ms=ms2[B2], plain_ms=plain2, bound_ms=k2_bound(B2)[0], bound_by=k2_bound(B2)[1],
        library_ms=None, matched=True, shape=f"B={B2} k={K2}", ms_per_call=ms2call,
        at_batch={str(bsz): dict(ms=ms2[bsz], bound_ms=k2_bound(bsz)[0]) for bsz in ms2},
        sass_loops=sass2, phase_launches=kbuild.LAUNCHES["fe_mul_chain"]))
    log(f"[K2] fe_mul_chain k={K2}: raw limbs equal to plain (64 lanes at the carried"
        f" extremes), Python ints on 36 lanes; device only "
        + ", ".join(f"B={bsz} {ms2[bsz]:.4f} ms ({bsz * K2 / ms2[bsz] / 1e3:.1f} M fe_mul/s,"
                    f" bound {k2_bound(bsz)[0]:.5f} ms, {k2_bound(bsz)[1]})" for bsz in ms2)
        + f"; a call at B={B2} {ms2call:.4f} ms; plain {plain2:.1f} ms")

    # -- 4. K3 sha512_batch ----------------------------------------------------------
    mark("4")
    B3, ML3 = 4096, 1232 + 64
    P3 = PLAIN_LANES
    lens = [0, 1, 111, 112, 239, 240, ML3, ML3 - 1, 127, 128, 129]
    lens += [int(v) for v in rng.integers(0, ML3 + 1, size=B3 - len(lens))]
    msgs = [rng.bytes(n) for n in lens]
    m3 = np.zeros((B3, ML3), dtype=np.uint8)
    for i, m in enumerate(msgs):
        m3[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
    m3 = torch.from_numpy(np.ascontiguousarray(m3.T)).to(dev)
    l3 = torch.tensor(lens, dtype=torch.int32, device=dev)
    kbuild.reset_launches()
    d3 = fsha.sha512_batch(m3, l3)
    torch.cuda.synchronize()
    api3 = kbuild.LAUNCHES["sha512_batch"]
    p3 = fsha.sha512_batch_plain(m3, l3)
    d3h = d3.cpu().numpy()
    want = np.stack([np.frombuffer(hashlib.sha512(m).digest(), np.uint8) for m in msgs], -1)
    err3 = int(np.abs(d3h.astype(np.int64) - want).max())
    check(err3 == 0, "K3 differs from hashlib")
    check(torch.equal(d3, p3), "K3 differs from its plain version")

    def k3_variant(label, m, ln, want_h):
        """K3 on (m, ln): equal to want_h (hashlib's digests, zeros out of
        range) on every lane and to plain on the first and last P3 lanes."""
        got = fsha.sha512_batch(m, ln)
        torch.cuda.synchronize()
        err = int(np.abs(got.cpu().numpy().astype(np.int64) - want_h).max())
        check(err == 0, f"K3 ({label}) differs from hashlib (max abs err {err})")
        for sl in (slice(0, P3), slice(m.shape[1] - P3, m.shape[1])):
            check(torch.equal(got[:, sl], fsha.sha512_batch_plain(m[:, sl].contiguous(),
                                                                  ln[sl].contiguous())),
                  f"K3 ({label}) differs from its plain version on lanes {sl.start}-{sl.stop}")
        return err

    # the narrow path: the same rows not 16-byte aligned, and 4,091 lanes
    # (a multiple of neither 16 nor 32: a ragged last block)
    m3o = offset_rows(m3)
    n3r = B3 - 5
    m3r, l3r = m3[:, :n3r].contiguous(), l3[:n3r].contiguous()
    # lengths out of range give zero digests
    bad3 = np.array([-1, ML3 + 1, -(1 << 31), (1 << 31) - 1], np.int32)
    l3bh = np.array(lens, np.int32)
    idx3 = rng.choice(B3, 64, replace=False)
    l3bh[idx3] = bad3[np.arange(64) % 4]
    l3b = torch.from_numpy(l3bh).to(dev)
    want_b = want.copy()
    want_b[:, idx3] = 0
    err3 = max(err3, k3_variant("offset rows", m3o, l3, want),
               k3_variant(f"{n3r} lanes", m3r, l3r, want[:, :n3r]),
               k3_variant("64 lengths out of range", m3, l3b, want_b))
    if PARENT:
        msg_ab("K3-ab", parent_fns["fd_sha512_batch"],
               lambda m, ln: fsha.sha512_batch(m, ln),
               {f"B={B3} max_len={ML3}": (m3, l3), "offset rows": (m3o, l3),
                f"B={n3r}": (m3r, l3r), "64 out of range": (m3, l3b)},
               digest=64, with_max_len=True)
    ms3_call = time_ms(lambda: fsha.sha512_batch(m3, l3), reps=20)
    ms3 = time_ms(lambda: fsha.sha512_batch(m3, l3), reps=50, hide_host=True)
    ms3n = time_ms(lambda: fsha.sha512_batch(m3o, l3), reps=50, hide_host=True)
    ms3r = time_ms(lambda: fsha.sha512_batch(m3r, l3r), reps=50, hide_host=True)
    plain3 = time_host_ms(lambda: fsha.sha512_batch_plain(m3, l3))
    blocks3 = sum((n + 17 + 127) // 128 for n in lens)
    ops3 = blocks3 * SHA512_OPS_PER_BLOCK
    bytes3 = B3 * ML3 + 4 * B3 + 64 * B3
    b3, bby3 = bound(ops3, bytes3)
    kernels.append(dict(
        name="sha512_batch", route="cuda",
        source="firedancer_tpu_torch/csrc/sha512_batch.cu",
        replaces="firedancer_tpu/ops/sha512.py:179", launches=None,
        max_abs_err=err3, ms=ms3, plain_ms=plain3, bound_ms=b3, bound_by=bby3,
        library_ms=None, matched=True, shape=f"B={B3} max_len={ML3}",
        phase_launches=api3, main_path=OPS_API, path_launches=api3,
        ms_per_call=ms3_call, ms_narrow=ms3n, ms_ragged=ms3r))
    log(f"[K3] sha512_batch B={B3} max_len={ML3} ({blocks3} blocks): equal to hashlib on every"
        f" lane and to plain; the narrow path (offset rows), {n3r} lanes and 64 lengths out of"
        f" range (zero digests) equal to hashlib on every lane and to plain on the first and"
        f" last {P3}; device only {ms3 * 1e3:.2f} us (narrow path {ms3n * 1e3:.2f} us,"
        f" {n3r} lanes {ms3r * 1e3:.2f} us), a call {ms3_call * 1e3:.2f} us; bound"
        f" {b3 * 1e3:.2f} us, {bby3}; plain {plain3:.1f} ms")

    # -- 5. K1 on the mixed batch ------------------------------------------------------
    mark("5")
    B1, ML1 = 1024, 1232
    mb = mixed_batch(B1, ML1, n_real=B1 - 24, seed=5)
    args1 = [torch.from_numpy(a).to(dev) for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)]
    mask, cnt = sv.verify_batch(*args1, mb.n_real, max_msg_len=ML1)
    torch.cuda.synchronize()
    pmask, pcnt = sv.verify_batch_plain(*args1, mb.n_real, ML1)
    mask_h = mask.cpu().numpy()
    err1 = int(np.abs(mask_h.astype(np.int64) - pmask.cpu().numpy().astype(np.int64)).max())
    check(err1 == 0, "K1 mask differs from its plain version")
    check((mask_h == mb.labels).all(), "K1 mask differs from ed25519_ref labels: lanes "
          + str(np.nonzero(mask_h != mb.labels)[0][:16].tolist()))
    check(int(cnt) == int(mask_h.sum()) == int(pcnt), "K1 ok-count != sum of mask")
    by_cat = {}
    for c, ok in zip(mb.categories, mask_h):
        by_cat.setdefault(c, [0, 0])[int(ok)] += 1
    log(f"[K1] mixed batch B={B1} max_msg_len={ML1} n_real={mb.n_real}: mask equal to"
        f" plain and labels, ok-count {int(cnt)}; (rejected, accepted) by category {by_cat}")

    # -- 6. K1 timing ---------------------------------------------------------------------
    mark("6")
    BT = 16384
    pool = gen_transfer_pool(256, seed=b"smoke")
    mt = np.zeros((BT, ML1), dtype=np.uint8)
    lt = np.zeros((BT,), dtype=np.int32)
    st = np.zeros((BT, 64), dtype=np.uint8)
    pt = np.zeros((BT, 32), dtype=np.uint8)
    trip = []
    for p in pool:
        t = ft.txn_parse(p)
        trip.append((t.message(p), t.signatures(p)[0], t.signers(p)[0]))
    for i in range(BT):
        m, s, k = trip[i % len(trip)]
        mt[i, : len(m)] = np.frombuffer(m, np.uint8)
        lt[i] = len(m)
        st[i] = np.frombuffer(s, np.uint8)
        pt[i] = np.frombuffer(k, np.uint8)
    argst = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (mt.T, lt, st.T, pt.T)]
    tmask, tcnt = sv.verify_batch(*argst, BT, max_msg_len=ML1)
    check(int(tcnt) == BT, f"K1 timing batch: {int(tcnt)} of {BT} honest lanes passed")
    # per call (the launch's host cost included) and device only (hide_host)
    ms1 = time_ms(lambda: sv.verify_batch(*argst, BT, max_msg_len=ML1), reps=10)
    ms1_dev = time_ms(lambda: sv.verify_batch(*argst, BT, max_msg_len=ML1), reps=10,
                      hide_host=True)
    # the pipeline's batch shape, for the device-busy estimate of phase 7
    args1k = [a[..., :B1].contiguous() for a in argst]
    ms1k = time_ms(lambda: sv.verify_batch(*args1k, B1, max_msg_len=ML1), reps=50)
    ms1k_dev = time_ms(lambda: sv.verify_batch(*args1k, B1, max_msg_len=ML1), reps=50,
                       hide_host=True)
    if parent_fns is not None:
        k1_ab(parent_fns["fd_verify_batch"], sv, dev, args1, mb, argst, args1k, ML1)
    plain1 = time_host_ms(lambda: sv.verify_batch_plain(*argst, BT, ML1))
    ops1 = BT * sv.K1_PRODUCTS_PER_VALID_LANE
    bytes1 = BT * (ML1 + 4 + 64 + 32) + 64 * 16 * 4 * fl.NLIMB * 4 + BT + 4
    kernels.append(dict(
        name="verify_batch", route="cuda", source="firedancer_tpu_torch/csrc/verify.cu",
        replaces="firedancer_tpu/ops/sigverify.py:97", launches=None, max_abs_err=err1,
        ms=ms1, plain_ms=plain1,
        bound_ms=max(ops1 / int_ops_per_s, bytes1 / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if ops1 / int_ops_per_s > bytes1 / HBM_BYTES_PER_S else "bytes",
        library_ms=None, matched=True, shape=f"B={BT} max_msg_len={ML1}",
        sigverify_per_s=BT / ms1 * 1e3, ms_batch1024=ms1k, device_ms=ms1_dev,
        device_ms_batch1024=ms1k_dev, bound_ms_batch1024=bound(
            B1 * sv.K1_PRODUCTS_PER_VALID_LANE,
            B1 * (ML1 + 4 + 64 + 32) + 64 * 16 * 4 * fl.NLIMB * 4 + B1 + 4)[0],
        phase_launches=kbuild.LAUNCHES["verify_batch"]))
    log(f"[K1] verify_batch B={BT} max_msg_len={ML1}: {ms1:.3f} ms a call"
        f" ({ms1_dev:.4f} ms device only), {BT / ms1 * 1e3:.0f} sigverify/s; plain"
        f" {plain1:.1f} ms; B={B1}: {ms1k:.4f} ms a call ({ms1k_dev:.4f} ms device only);"
        f" bounds {kernels[-1]['bound_ms']:.4f} / {kernels[-1]['bound_ms_batch1024']:.4f} ms")

    # -- 7. the pipeline (main path) ---------------------------------------------------------
    mark("7")
    vs = verify_stream(2100, seed=b"smoke-pipe", n_multisig=8, n_corrupt=6, n_resend=24)
    e = vs.expect

    def check_run(rep, sink, where: str, extra=(), launches=None) -> None:
        """Phase 7's expected counters and sunk frames, for one pipeline run;
        `launches` maps kernels to their expected launch counts (default: K1
        once per batch)."""
        for stage, key, want in (("verify", "txn_verified", e["txn_verified"]),
                                 ("verify", "verify_fail", e["verify_fail"]),
                                 ("verify", "parse_fail", e["parse_fail"]),
                                 ("verify", "dedup_dup", e["tile_dedup_dup"]),
                                 ("dedup", "dedup_dup", e["dedup_dup"]),
                                 ("sink", "txn_sunk", e["sunk"]), *extra):
            check(rep[stage].get(key, 0) == want,
                  f"{where} {stage}.{key} {rep[stage].get(key, 0)} != {want}")
        check([p for p, _ in sink.frames] == vs.expect_sunk, f"{where} sink frames")
        want = launches or {"verify_batch": rep["verify"]["batches"]}
        got = {k: kbuild.LAUNCHES.get(k, 0) for k in want}
        check(got == want and rep["verify"]["batches"] > 0,
              f"{where}: launches {got} != {want}")

    def drive_verify(native_client=None) -> tuple[float, dict]:
        """One run of a fresh verify pipeline over the stream: (seconds,
        report), checked; kbuild.LAUNCHES holds the run's launches.  The
        verify stage takes its sweep client unless native_client=False."""
        pipe = build_verify_pipeline(vs.stream, device=dev, batch=B1, max_msg_len=ML1,
                                     native_client=native_client)
        check((pipe.verify._sweep_client is not None) == (native_client is not False),
              f"verify pipeline: sweep client {pipe.verify._sweep_client}")
        kbuild.reset_launches()
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        pipe.close()
        rep = pipe.report()
        check_run(rep, pipe.sink, "verify pipeline")
        return run_s, rep

    run_s, rep = drive_verify()
    launches7 = dict(kbuild.LAUNCHES)
    txn_s = rep["sink"]["txn_sunk"] / run_s
    # upper estimate: every batch costs a full batch's kernel time
    busy = launches7["verify_batch"] * ms1k / (run_s * 1e3)
    check(rep["verify"]["sealed_batches"] == rep["verify"]["batches"],
          f"verify pipeline: {rep['verify']['sealed_batches']} sealed C slots !="
          f" {rep['verify']['batches']} batches")
    drain_s, drain_rep = drive_verify(native_client=False)
    log(f"[pipeline] {len(vs.stream)} frames in {run_s:.3f} s: {txn_s:.0f} txn/s sunk;"
        f" {rep['verify']['batches']} batches from the verify sweep client's sealed slots"
        f" (the drain-table intake in this call: {drain_rep['verify']['batches']} batches,"
        f" {drain_rep['sink']['txn_sunk'] / drain_s:.0f} txn/s); launches {launches7};"
        f" device busy <= {busy:.3f} of the run (K1 event time x launches); counters"
        f" {json.dumps(rep)}")

    # -- 8. K4 sha256_iter32 -------------------------------------------------------------
    mark("8")
    B4, N4 = 4096, HASHES_PER_TICK
    rng = np.random.default_rng(8)
    st4 = rng.integers(0, 256, (32, B4), dtype=np.uint8)
    x4 = torch.from_numpy(st4).to(dev)
    # the sharded leader block's 4 chains, the plane's 64 (one slot's
    # spans), and 4,096: the first B chains of one seeded set
    x4b = {b: x4[:, :b].contiguous() for b in K4_CHAINS}
    y4 = fsha256.sha256_iter32(x4, N4)
    y4h = y4.cpu().numpy()
    err4 = 0
    for i in [0, 3, 4, 63, 64] + [int(v) for v in rng.choice(B4, 27, replace=False)]:
        want = np.frombuffer(rpoh.poh_append(bytes(st4[:, i]), N4), np.uint8)
        err4 = max(err4, int(np.abs(y4h[:, i].astype(np.int64) - want).max()))
    check(err4 == 0, f"K4 differs from hashlib at n = {N4} (max abs err {err4})")
    for b in K4_CHAINS[:-1]:
        check(torch.equal(fsha256.sha256_iter32(x4b[b], N4), y4[:, :b]),
              f"K4 at B = {b} differs from the same chains at B = {B4}")
    k64 = fsha256.sha256_iter32(x4, 64)
    torch.cuda.synchronize()
    p64 = fsha256.sha256_iter32_plain(x4, 64)
    err4p = int((k64.to(torch.int64) - p64.to(torch.int64)).abs().max())
    check(err4p == 0, "K4 differs from its plain version at n = 64")
    ms4b = {b: time_ms(lambda x=x4b[b]: fsha256.sha256_iter32(x, N4), reps=5)
            for b in K4_CHAINS}
    ms4_n64 = time_ms(lambda: fsha256.sha256_iter32(x4, 64), reps=20)
    plain4 = time_host_ms(lambda: fsha256.sha256_iter32_plain(x4, 64))
    bound4 = {b: bound(b * N4 * SHA256_OPS_PER_ITER32_COMPRESSION, 64 * b) for b in K4_CHAINS}
    # what the round warp issues a hash, from this build's SASS (its longer
    # loop; the schedule warp's is the other): its instructions at
    # ISSUE_CLOCKS each, and its longest dependent chain at DEP_CLOCKS each
    # (the chain floor, an estimate), n hashes at the card's top clock
    loops4 = fsass.loops(fsass.dump(os.path.join(kbuild.build_dir(), "libsha256_iter32.so")),
                         "sha256_iter32_kernel")
    round4 = max(loops4, key=lambda lp: lp["n"])
    issue4 = N4 * round4["n"] * ISSUE_CLOCKS / (clk_mhz * 1e3)
    floor4 = N4 * round4["depth"] * DEP_CLOCKS / (clk_mhz * 1e3)
    kernels.append(dict(
        name="sha256_iter32", route="cuda",
        source="firedancer_tpu_torch/csrc/sha256_iter32.cu",
        replaces="firedancer_tpu/ops/sha256.py:171", launches=None,
        max_abs_err=max(err4, err4p), ms=ms4b[64], plain_ms=plain4, bound_ms=bound4[64][0],
        bound_by=bound4[64][1], library_ms=None, matched=True, shape=f"B=64 n={N4}",
        plain_shape=f"B={B4} n=64", ms_at_plain_shape=ms4_n64,
        ms_by_chains={str(b): ms4b[b] for b in K4_CHAINS},
        bound_ms_by_chains={str(b): bound4[b][0] for b in K4_CHAINS},
        round_warp_insns=round4["n"], round_warp_issue_ms=issue4,
        chain_floor_est_ms=floor4, hashes_per_s=B4 * N4 / ms4b[B4] * 1e3,
        phase_launches=kbuild.LAUNCHES["sha256_iter32"]))
    log(f"[K4] sha256_iter32 n={N4}: 32 lanes of B={B4} equal to hashlib, B=4 and 64 equal to"
        f" the same chains of B={B4}, all equal to plain at n=64; "
        + "; ".join(f"B={b}: {ms4b[b]:.4f} ms (operations bound {bound4[b][0]:.4f} ms)"
                    for b in K4_CHAINS)
        + f"; the round warp's issue {issue4:.4f} ms ({round4['n']} instructions a hash x"
        f" {ISSUE_CLOCKS} clocks at {clk_mhz:.0f} MHz; {ms4b[64] * clk_mhz * 1e3 / (N4 * round4['n']):.3f}"
        f" clocks an instruction measured at B=64); chain floor estimate {floor4:.4f} ms"
        f" ({round4['depth']} dependent instructions a hash x {DEP_CLOCKS} clocks);"
        f" {B4 * N4 / ms4b[B4] / 1e6:.3f} G hash/s at B={B4}; n=64: {ms4_n64:.4f} ms,"
        f" plain {plain4:.1f} ms")
    if parent_fns is not None:
        k4_ab(parent_fns["fd_sha256_iter32"], fsha256, dev, x4b, N4)

    # -- 9. K5 gf256_apply: the main paths' shapes, the plane's batch encode, the edges -----
    mark("9")
    T9, D9, P9, S9 = 1024, 32, 32, 1024
    rng = np.random.default_rng(9)
    data9 = rng.integers(0, 256, (T9, D9, S9), dtype=np.uint8)
    dt9 = torch.from_numpy(data9).to(dev)
    gen9 = torch.from_numpy(rs.parity_matrix(D9, P9)).to(dev)
    par9 = rs.encode_core(gen9, dt9)
    torch.cuda.synchronize()
    par9h = par9.cpu().numpy()
    for t in rng.choice(T9, 16, replace=False):
        check((par9h[t] == gr.encode(data9[t], P9)).all(), f"K5 set {t} != gf256_ref")
    # recover_batch over 64 sets: one rebuild matrix per erasure pattern
    TR, N9 = 64, D9 + P9
    full = np.concatenate([data9[:TR], par9h[:TR]], axis=1)  # (64, 64, 1024)
    present = np.ones((TR, N9), dtype=bool)
    want_st = np.full((TR,), rs.SUCCESS, dtype=np.int32)
    for t in range(TR):
        if t < 20:  # exactly d survivors
            present[t, rng.choice(N9, N9 - D9, replace=False)] = False
        elif t < 60:  # extras
            present[t, rng.choice(N9, int(rng.integers(0, N9 - D9)), replace=False)] = False
    shreds = full.copy()
    shreds[60, N9 - 1, 5] ^= 0x80  # a corrupted extra (all present)
    want_st[60] = rs.ERR_CORRUPT
    present[61, rng.choice(N9, N9 - D9 + 1, replace=False)] = False  # d - 1 survive
    want_st[61] = rs.ERR_PARTIAL
    present[62:, :D9] = False  # every data shred lost: rebuilt from parity
    shreds[~present] = rng.integers(0, 256, (int((~present).sum()), S9), dtype=np.uint8)
    sh9 = torch.from_numpy(shreds).to(dev)
    st9, out9 = rs.recover_batch(sh9, present, D9)
    out9h = out9.cpu().numpy()
    check(st9.tolist() == want_st.tolist(),
          f"recover_batch statuses {st9.tolist()} != {want_st.tolist()}")
    for t in np.flatnonzero(want_st == rs.SUCCESS):
        check((out9h[t] == full[t]).all(), f"recover_batch set {t}: rebuilt bytes differ")
    mats9 = torch.from_numpy(np.stack([
        rs._recover_matrix(D9, N9, tuple(bool(x) for x in present[t]))[0]
        if want_st[t] != rs.ERR_PARTIAL else np.zeros((N9, D9), np.uint8)
        for t in range(TR)])).to(dev)
    # the timed shapes (K5_SHAPES): the leader's two encodes and the lossy
    # store's rebuild (one set each, S ragged), the 64 per-set matrices
    # above and the plane's batch encode
    runs9 = {}
    for label, (t_, m_, k_, s_, kind) in K5_SHAPES.items():
        if kind == "batch-recover":
            runs9[label] = (mats9, sh9[:, :D9].contiguous())
            continue
        if kind == "batch-encode":
            runs9[label] = (gen9.reshape(1, P9, D9), dt9)
            continue
        if kind == "encode":
            mat_ = rs.parity_matrix(k_, m_)
        else:  # one rebuild: n = d + p rows from the d survivors of a loss pattern
            n_ = m_
            gone = rng.choice(n_, n_ - k_, replace=False)
            mat_ = rs._recover_matrix(k_, n_, tuple(i not in gone for i in range(n_)))[0]
        runs9[label] = (torch.from_numpy(np.ascontiguousarray(mat_)[None]).to(dev),
                        torch.from_numpy(rng.integers(0, 256, (t_, k_, s_), dtype=np.uint8)).to(dev))
    k5, err9 = {}, 0
    for label, (mat_, dat_) in runs9.items():
        got = g2.gf_apply_batch(mat_, dat_)
        torch.cuda.synchronize()
        plain_ = g2.gf_apply_batch_plain(mat_, dat_)
        err = int((got.to(torch.int16) - plain_.to(torch.int16)).abs().max())
        check(err == 0, f"K5 differs from its plain version at {label} (max abs err {err})")
        err9 = max(err9, err)
        gh, mh, dh = got.cpu().numpy(), mat_.cpu().numpy(), dat_.cpu().numpy()
        for j in sorted({0, dat_.shape[0] - 1}):
            check((gh[j] == gr.gf_matmul(mh[j if mh.shape[0] > 1 else 0], dh[j])).all(),
                  f"K5 set {j} != gf256_ref at {label}")
        t_, m_, k_, s_, _ = K5_SHAPES[label]
        k5[label] = dict(
            ms=time_ms(lambda r=(mat_, dat_): g2.gf_apply_batch(*r), reps=50, hide_host=True),
            plain_ms=time_host_ms(lambda r=(mat_, dat_): g2.gf_apply_batch_plain(*r)),
            **k5_bounds(t_, m_, k_, s_, mh.shape[0], int_ops_per_s))
        del plain_
    # the edges, checked only: T = 2, ragged S, k padded to 4 bytes, aligned
    # and offset data, shared and per-set matrices (recover's m = n = 2k),
    # zero coefficients and all-zero columns; then all-zero data and matrices
    edges9 = 0
    for s_ in K5_EDGE_S:
        for k_ in K5_EDGE_K:
            for per_set, m_ in ((False, max(1, k_ // 2) + 7), (True, 2 * k_)):
                mh = rng.integers(0, 256, (2 if per_set else 1, m_, k_), dtype=np.uint8)
                mh[0, :, 0] = 0
                dh = rng.integers(0, 256, (2, k_, s_), dtype=np.uint8)
                dh[1, :, s_ // 2:] = 0
                mt_, dt_ = torch.from_numpy(mh).to(dev), torch.from_numpy(dh).to(dev)
                want = g2.gf_apply_batch_plain(mt_, dt_)
                for off in (0, 1):
                    check(torch.equal(g2.gf_apply_batch(mt_, offset_rows(dt_, off) if off else dt_),
                                      want), f"K5 differs from plain at T=2 m={m_} k={k_} S={s_}"
                          f" offset {off} per_set {per_set}")
                    edges9 += 1
    # 512 of the leader's sets at once fill the grid: a warp loops over 16
    # column groups, on the byte loads (1,019) and the cp.async tiles (1,024)
    for s_ in (1019, 1024):
        mt_ = runs9[next(iter(K5_SHAPES))][0]
        dt_ = torch.from_numpy(rng.integers(0, 256, (512, 19, s_), dtype=np.uint8)).to(dev)
        check(torch.equal(g2.gf_apply_batch(mt_, dt_), g2.gf_apply_batch_plain(mt_, dt_)),
              f"K5 differs from plain at T=512 (27 x 19) x {s_}")
        edges9 += 1
    label9 = next(iter(K5_SHAPES))  # the leader block's common set: the kernel's row
    mat_, dat_ = runs9[label9]
    check(not g2.gf_apply_batch(mat_, torch.zeros_like(dat_)).any()
          and not g2.gf_apply_batch(torch.zeros_like(mat_), dat_).any(),
          f"K5 at {label9}: zero data or a zero matrix gives nonzero bytes")
    main9 = k5[label9]
    kernels.append(dict(
        name="gf256_apply", route="cuda",
        source="firedancer_tpu_torch/csrc/gf256_apply.cu",
        replaces="firedancer_tpu/ops/gf256.py:64 (and :82)", launches=None,
        max_abs_err=err9, ms=main9["ms"], plain_ms=main9["plain_ms"],
        bound_ms=main9["bound_ms"], bound_by=main9["bound_by"], library_ms=None, matched=True,
        shape=label9, at_shape=k5, probe_add_device_ms=msa_dev,
        phase_launches=kbuild.LAUNCHES["gf256_apply"]))
    log(f"[K5] gf256_apply equal to plain and gf256_ref at {len(runs9)} shapes and to plain at"
        f" {edges9} edge launches (S {K5_EDGE_S}, k {K5_EDGE_K}, offset 0/1, shared and"
        f" per-set matrices; 512 sets of (27 x 19) x 1,019 and 1,024); zero data and zero"
        f" matrices give zeros; recover_batch 64 sets:"
        f" statuses {dict((int(a), int(b)) for a, b in zip(*np.unique(st9, return_counts=True)))}"
        f" as expected, bytes equal; device only (T, m x k, S): " + "; ".join(
            f"{label}: {x['ms'] * 1e3:.2f} us (bounds: bytes {x['bytes_ms'] * 1e3:.3f}, table"
            f" {x['table_ms'] * 1e3:.3f}, tensor cores {x['tc_ms'] * 1e3:.3f} us; least"
            f" {x['bound_ms'] * 1e3:.3f} us, {x['bound_form']}), plain {x['plain_ms']:.1f} ms"
            for label, x in k5.items())
        + f"; probe_add device only {msa_dev * 1e3:.2f} us")
    k5_sass(kbuild)
    if parent_fns is not None:
        k5_ab(k5_parent(parent_fns["fd_gf256_apply"], dev), g2, runs9)

    # -- 10. the serving plane's pipeline (main path) --------------------------------------
    mark("10")
    plane = ServePlane(ServeConfig(
        n_devices=1, batch_per_shard=B1, max_msg_len=ML1, fec_sets_per_shard=1,
        fec_data_shreds=D9, fec_parity_shreds=P9, fec_shred_sz=S9,
        poh_chains_per_shard=64, poh_iters=HASHES_PER_TICK))
    warm_s = plane.warmup()
    h = hashlib.sha256(b"smoke-slot").digest()
    spans = []
    for _ in range(64):  # one slot's tick spans, each hashes_per_tick long
        e_ = rpoh.poh_append(h, HASHES_PER_TICK)
        spans.append((h, e_))
        h = e_
    bad = {5, 30, 61}
    parked = [(s_, bytes([e_[0] ^ 1]) + e_[1:] if i in bad else e_)
              for i, (s_, e_) in enumerate(spans)]
    starts10 = rpoh.hashes_to_rows([s_ for s_, _ in parked])
    ends10 = rpoh.hashes_to_rows([e_ for _, e_ in parked])
    span_steps = -(-64 // plane.cfg.poh_chains)

    def drive_plane() -> tuple[float, dict]:
        """One run of a fresh sharded verify pipeline on the plane, with the
        slot's spans parked mid-run: (seconds, report), checked."""
        pipe10 = build_sharded_verify_pipeline(vs.stream, n_shards=1, plane=plane)
        kbuild.reset_launches()
        t0 = time.perf_counter()
        for _ in range(8):  # the run starts; the PoH stage parks a slot's spans
            for stage in pipe10.stages:
                stage.run_once()
        for s_, e_ in parked:
            check(plane.queue_poh_span(s_, e_), "queue_poh_span refused a span")
        pipe10.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        pipe10.close()
        rep = pipe10.report()
        check_run(rep, pipe10.sink, "plane pipeline",
                  (("router", "routed_total", len(vs.stream)),
                   ("verify", "poh_spans_ok", 64 - len(bad)),
                   ("verify", "poh_spans_fail", len(bad))))
        check(kbuild.LAUNCHES.get("sha256_iter32", 0) == span_steps,
              f"plane pipeline: K4 launches {kbuild.LAUNCHES.get('sha256_iter32', 0)}"
              f" != {span_steps} span step(s)")
        check(kbuild.LAUNCHES.get("gf256_apply", 0) == 0,
              "plane pipeline: K5 launched on a placeholder step")
        return run_s, rep

    run10_s, rep10 = drive_plane()
    par10 = plane.encode_parity(data9, P9)  # the shredder's call
    seg10 = plane.verify_poh_segments(starts10, ends10, HASHES_PER_TICK)  # replay's
    torch.cuda.synchronize()
    launches10 = dict(kbuild.LAUNCHES)
    v10 = rep10["verify"]
    check((par10 == par9h).all(), "encode_parity != phase 9's K5 output")
    check(seg10.tolist() == [i not in bad for i in range(64)], "verify_poh_segments mask")
    check(launches10.get("sha256_iter32", 0) == span_steps + 1,
          f"K4 launches {launches10.get('sha256_iter32', 0)} != {span_steps} span"
          " step(s) + 1 direct call")
    check(launches10.get("gf256_apply", 0) == 1,
          f"K5 launches {launches10.get('gf256_apply', 0)} != 1 encode_parity call")
    txn10_s = rep10["sink"]["txn_sunk"] / run10_s
    busy10 = (v10["batches"] * ms1k + span_steps * ms4b[64]) / (run10_s * 1e3)
    log(f"[plane] warmup {warm_s:.3f} s; {len(vs.stream)} frames in {run10_s:.3f} s:"
        f" {txn10_s:.0f} txn/s sunk (phase 7: {txn_s:.0f}); {v10['batches']} steps,"
        f" spans ok/fail {v10['poh_spans_ok']}/{v10['poh_spans_fail']}; launches"
        f" {launches10}; device busy <= {busy10:.3f} of the run (K1 x steps + K4 x span"
        f" steps); counters {json.dumps(rep10)}")

    # -- 10b. phases 7 and 10 again, in alternating order ----------------------------------
    mark("10b")
    # one run of either is ~0.1-0.2 s, so one sample says little; each round
    # runs both, plane first in even rounds, and every run is checked as above
    rounds = [(txn_s, txn10_s)]
    for r in range(REPEAT_ROUNDS):
        got = {}
        for fn in ((drive_plane, drive_verify) if r % 2 == 0 else (drive_verify, drive_plane)):
            run_s_, rep_ = fn()
            got[fn] = rep_["sink"]["txn_sunk"] / run_s_
        rounds.append((got[drive_verify], got[drive_plane]))
    t7s, t10s = sorted(a for a, _ in rounds), sorted(b for _, b in rounds)
    ratios = sorted(b / a for a, b in rounds)
    mid = len(rounds) // 2
    log(f"[repeat] {len(rounds)} rounds (the first is phases 7 and 10 above):"
        f" verify pipeline txn/s median {t7s[mid]:.0f} (min {t7s[0]:.0f}, max {t7s[-1]:.0f});"
        f" plane pipeline median {t10s[mid]:.0f} (min {t10s[0]:.0f}, max {t10s[-1]:.0f});"
        f" plane/verify ratio per round median {ratios[mid]:.3f} (min {ratios[0]:.3f},"
        f" max {ratios[-1]:.3f}); rounds (verify, plane) {[(round(a), round(b)) for a, b in rounds]}")

    # -- 11. entry.leader_step -----------------------------------------------------------
    mark("11")
    kbuild.reset_launches()
    out11 = tentry.leader_step()
    launches11 = dict(kbuild.LAUNCHES)
    for k in ("verify_batch", "sha256_iter32", "gf256_apply"):
        check(launches11.get(k, 0) == count, f"leader_step launched {k} "
              f"{launches11.get(k, 0)} times on {count} device(s)")
    log(f"[entry] leader_step {out11}; launches {launches11}")

    # -- 12. the comb lane's kernels alone: K7, K8, K6 ------------------------------------
    mark("12")
    t0 = time.perf_counter()
    vs13 = vote_stream(VOTERS, VOTE_ROUNDS, seed=b"smoke-comb", n_transfers=VOTE_TRANSFERS)
    sign_s = time.perf_counter() - t0
    voter_pubs = [p for _, p in vs13.voters]
    edge = torsion_encodings() + nonsquare_encodings(2) + noncanonical_encodings()[-1:]
    check(len(edge) == 8, f"{len(edge)} edge keys, expected 8")
    keys12 = voter_pubs + edge
    pk12 = torch.from_numpy(np.stack([np.frombuffer(k, np.uint8) for k in keys12], 1)).to(dev)
    pk32 = pk12[:, :32].contiguous()
    M12 = pk12.shape[1]
    # K7 at the stage's fill width and at the whole voting set
    t32, ok32 = sv.comb_fill(pk32)
    tall, okall = sv.comb_fill(pk12)
    torch.cuda.synchronize()
    pt32, pok32 = sv.comb_fill_plain(pk32)
    check(torch.equal(ok32, pok32) and bool(ok32.all()), "K7 ok at M = 32")
    check(torch.equal(t32, pt32), "K7 tables differ from comb_fill_plain at M = 32")
    ptall, pokall = sv.comb_fill_plain(pk12)
    check(torch.equal(okall, pokall), f"K7 ok differs from comb_fill_plain at M = {M12}")
    check(torch.equal(tall, ptall), f"K7 tables differ from comb_fill_plain at M = {M12}")
    del ptall, pt32
    okh = okall.cpu().numpy()
    want_ok = []
    for k in keys12:
        pt = ref.point_decompress(k)
        want_ok.append(pt is not None and not ref.is_small_order(pt))
    check(okh.tolist() == want_ok, "K7 ok differs from ed25519_ref's decoding and small order")
    check(bool(okh[:VOTERS].all()) and int(okh[VOTERS:].sum()) <= 1,
          f"K7 ok over the edge keys {okh[VOTERS:].tolist()}")
    rng = np.random.default_rng(12)
    sample = rng.choice(VOTERS, min(64, VOTERS), replace=False)
    tallh = tall[torch.from_numpy(sample).to(dev)].cpu().numpy()
    for n_, col in enumerate(sample):
        na = ref.point_neg(ref.point_decompress(keys12[col]))
        for j, m in ((0, 1), (int(rng.integers(64)), int(rng.integers(16))),
                     (int(rng.integers(64)), int(rng.integers(16))), (63, 15)):
            X, Y, Z, T = ref.point_mul(m * 16**j, na)
            ypx, ymx, zz, t2d = (fl.limbs_to_int(tallh[n_, j, m, c]) for c in range(4))
            check(ypx * Z % fl.P == (Y + X) * zz % fl.P and ymx * Z % fl.P == (Y - X) * zz % fl.P
                  and t2d * Z % fl.P == 2 * ref.D * T * zz % fl.P and zz % fl.P,
                  f"K7 entry (col {col}, j {j}, m {m}) != Python ints")
    # K8: the voters' tables into a 2,048-slot bank at seeded slots
    slots12 = rng.permutation(BANK_SLOTS)[:VOTERS]
    tv12 = tall[:VOTERS]
    bank12 = sv.bank_alloc(BANK_SLOTS, device=dev)
    sv.bank_install(bank12, tv12, slots12.tolist())
    lib12 = sv.bank_install_plain(sv.bank_alloc(BANK_SLOTS, device=dev), tv12,
                                  torch.from_numpy(slots12).to(dev))
    torch.cuda.synchronize()
    check(torch.equal(bank12, lib12), "K8 differs from index_copy_")
    s12 = torch.from_numpy(slots12).to(dev)
    check(torch.equal(bank12[s12], tv12), "K8: installed slots differ from the tables")
    untouched = torch.ones(BANK_SLOTS, dtype=torch.bool, device=dev)
    untouched[s12] = False
    check(not bool(bank12[untouched].any()), "K8 wrote an untouched slot")
    sv.bank_install(bank12, tv12[5:6], [int(slots12[0])])  # a reinstall overwrites
    check(torch.equal(bank12[int(slots12[0])], tv12[5]), "K8 reinstall did not overwrite")
    sv.bank_install(bank12, tv12[0:1], [int(slots12[0])])
    check(torch.equal(bank12, lib12), "K8 after reinstalling the slot's own table")
    del lib12
    # K6: the voters' votes, banked, with corrupted lanes
    slot_of = {voter_pubs[i]: int(slots12[i]) for i in range(VOTERS)}
    sunk_set = set(vs13.expect_sunk)
    trip = []
    for p in vs13.stream:
        t = ft.txn_parse(p)
        sg = t.signatures(p)
        if len(sg) == 1 and t.signers(p)[0] in slot_of and encode_verified(p, t) in sunk_set:
            trip.append((t.message(p), sg[0], t.signers(p)[0]))
    B6 = K6_BATCH
    cats6 = ("bad_msg", "bad_r", "high_s", "small_r", "noncanon_r")
    tors, nonc = torsion_encodings(), noncanonical_encodings()
    bad6 = {int(i): cats6[n_ % len(cats6)]
            for n_, i in enumerate(rng.choice(B6, min(100, B6 // 8), replace=False))}
    m6 = np.zeros((B6, ML1), np.uint8)
    l6 = np.zeros((B6,), np.int32)
    sg6 = np.zeros((B6, 64), np.uint8)
    pk6 = np.zeros((B6, 32), np.uint8)
    lab6 = np.ones((B6,), bool)
    kw6 = []
    for i in range(B6):
        m, sgn, k = trip[i % len(trip)]
        cat = bad6.get(i)
        if cat == "bad_msg":
            m = bytes([m[0] ^ 1]) + m[1:]
        elif cat == "bad_r":
            sgn = bytes([sgn[0] ^ 0x04]) + sgn[1:]
        elif cat == "high_s":
            sgn = sgn[:32] + (int.from_bytes(sgn[32:], "little") + ref.L).to_bytes(32, "little")
        elif cat == "small_r":
            sgn = tors[i % len(tors)] + sgn[32:]
        elif cat == "noncanon_r":
            sgn = nonc[i % len(nonc)] + sgn[32:]
        if cat:
            lab6[i] = ref.verify(m, sgn, k)
        m6[i, : len(m)] = np.frombuffer(m, np.uint8)
        l6[i] = len(m)
        sg6[i] = np.frombuffer(sgn, np.uint8)
        pk6[i] = np.frombuffer(k, np.uint8)
        h = int.from_bytes(hashlib.sha512(sgn[:32] + k + m).digest(), "little") % ref.L
        kw6.append(h)
    check(not lab6[list(bad6)].any(), "a corrupted K6 lane verifies under ed25519_ref")
    args6 = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (m6.T, l6, sg6.T, pk6.T)]
    sl6 = [slot_of[bytes(pk6[i])] for i in range(B6)]
    mask6, cnt6 = sv.verify_cached(*args6, bank12, sl6, B6, max_msg_len=ML1)
    gmask6, _ = sv.verify_batch(*args6, B6, max_msg_len=ML1)
    torch.cuda.synchronize()
    mask6h = mask6.cpu().numpy()
    check((mask6h == gmask6.cpu().numpy()).all(), "K6 mask differs from K1's on the same lanes")
    check((mask6h == lab6).all(), "K6 mask differs from the labels: lanes "
          + str(np.nonzero(mask6h != lab6)[0][:16].tolist()))
    check(int(cnt6) == int(lab6.sum()), "K6 ok-count != labels")
    B6k = K6_SMALL
    args6k = [a[..., :B6k].contiguous() for a in args6]
    mk6, ck6 = sv.verify_cached(*args6k, bank12, sl6[:B6k], B6k - 8, max_msg_len=ML1)
    torch.cuda.synchronize()
    pmk6, pck6 = sv.verify_cached_plain(*args6k, bank12, sl6[:B6k], B6k - 8, ML1)
    check(torch.equal(mk6, pmk6) and int(ck6) == int(pck6),
          "K6 differs from verify_cached_plain at B = 1,024")
    check(mk6.cpu().numpy().tolist() == lab6[:B6k - 8].tolist() + [False] * 8,
          "K6 at B = 1,024 differs from the labels")
    err6 = int((mk6.to(torch.int64) - pmk6.to(torch.int64)).abs().max())
    # times, CUDA events, of the launches alone (the slot columns already on
    # the card; the wrappers' host checks and uploads are not kernel time)
    sl6d = torch.tensor(sl6, dtype=torch.int32, device=dev)
    sl6kd = sl6d[:B6k].contiguous()
    ms6 = time_ms(lambda: sv.verify_cached_launch(*args6, bank12, sl6d, B6, ML1), reps=5)
    ms6k = time_ms(lambda: sv.verify_cached_launch(*args6k, bank12, sl6kd, B6k, ML1),
                   reps=10)
    ms1_6 = time_ms(lambda: sv.verify_batch(*args6, B6, max_msg_len=ML1), reps=3)
    plain6 = time_host_ms(lambda: sv.verify_cached_plain(*args6k, bank12, sl6[:B6k], B6k, ML1))
    ms7 = time_ms(lambda: sv.comb_fill(pk32), reps=10)
    ms7all = time_ms(lambda: sv.comb_fill(pk12), reps=3)
    plain7 = time_host_ms(lambda: sv.comb_fill_plain(pk32))
    # K8 and index_copy_ take microseconds, less than a launch costs the
    # host: hide_host queues them behind a busy-wait so the events time the
    # card's work back to back
    b8 = sv.bank_alloc(BANK_SLOTS, device=dev)
    s32 = torch.from_numpy(slots12[:32]).to(dev)
    ms8 = time_ms(lambda: sv.bank_install_launch(b8, t32, s32), reps=20, hide_host=True)
    ms8all = time_ms(lambda: sv.bank_install_launch(b8, tv12, s12), reps=10, hide_host=True)
    lib8 = time_ms(lambda: b8.index_copy_(0, s32, t32), reps=20, hide_host=True)
    lib8all = time_ms(lambda: b8.index_copy_(0, s12, tv12), reps=10, hide_host=True)
    # bounds from this run's inputs: K6 counts the full work of the lanes
    # that do it all (honest and corrupted-message lanes) and the distinct
    # bank and base-comb entries the batch reads, over its first n lanes
    def bound6(n):
        full = [i for i in range(n) if bad6.get(i) in (None, "bad_msg")]
        sha = sum((int(l6[i]) + 64 + 17 + 127) // 128 for i in full) * SHA512_OPS_PER_BLOCK
        ops = len(full) * sv.PRODUCTS_PER_CACHED_LANE + sha
        ent_a = {(sl6[i], j, (kw6[i] >> (4 * j)) & 15) for i in full for j in range(64)}
        ent_b = {(j, (int.from_bytes(bytes(sg6[i, 32:]), "little") >> (4 * j)) & 15)
                 for i in full for j in range(64)}
        nbytes = n * (ML1 + 4 + 64 + 32 + 4) + 160 * (len(ent_a) + len(ent_b)) + n + 4
        return bound(ops, nbytes) + (ops, nbytes, len(ent_a))

    bms6, bby6, ops6, bytes6, n_ent6 = bound6(B6)
    bms6k, bby6k, _, _, _ = bound6(B6k)
    bms7, bby7 = bound(32 * sv.PRODUCTS_PER_COMB_FILL, 32 * (32 + sv.BANK_SLOT_BYTES + 1))
    bms7all, bby7all = bound(M12 * sv.PRODUCTS_PER_COMB_FILL,
                             M12 * (32 + sv.BANK_SLOT_BYTES + 1))
    bms8, bby8 = bound(0, 32 * (2 * sv.BANK_SLOT_BYTES + 8))
    bms8all, bby8all = bound(0, VOTERS * (2 * sv.BANK_SLOT_BYTES + 8))
    kernels.append(dict(
        name="verify_cached", route="cuda", source="firedancer_tpu_torch/csrc/verify_cached.cu",
        replaces="firedancer_tpu/ops/sigverify.py:138", launches=None, max_abs_err=err6,
        ms=ms6, plain_ms=plain6, bound_ms=bms6, bound_by=bby6, library_ms=None,
        matched=True, shape=f"B={B6} max_msg_len={ML1} bank={BANK_SLOTS}",
        plain_shape=f"B={B6k}", ms_batch1024=ms6k, ms_k1_same_lanes=ms1_6,
        bound_ms_batch1024=bms6k, bound_by_batch1024=bby6k,
        sigverify_per_s=B6 / ms6 * 1e3, phase_launches=kbuild.LAUNCHES["verify_cached"]))
    kernels.append(dict(
        name="comb_fill", route="cuda", source="firedancer_tpu_torch/csrc/comb_fill.cu",
        replaces="firedancer_tpu/ops/sigverify.py:175", launches=None, max_abs_err=0,
        ms=ms7, plain_ms=plain7, bound_ms=bms7, bound_by=bby7, library_ms=None,
        matched=True, shape="M=32", ms_all=ms7all, shape_all=f"M={M12}",
        bound_ms_all=bms7all, bound_by_all=bby7all,
        phase_launches=kbuild.LAUNCHES["comb_fill"]))
    kernels.append(dict(
        name="bank_install", route="cuda", source="firedancer_tpu_torch/csrc/bank_install.cu",
        replaces="firedancer_tpu/ops/sigverify.py:188", launches=None, max_abs_err=0,
        ms=ms8, plain_ms=lib8, bound_ms=bms8, bound_by=bby8, library_ms=lib8,
        matched=True, shape=f"M=32 bank={BANK_SLOTS}", ms_all=ms8all,
        library_ms_all=lib8all, shape_all=f"M={VOTERS}", bound_ms_all=bms8all,
        phase_launches=kbuild.LAUNCHES["bank_install"]))
    if parent_fns is not None:
        k6_ab(parent_fns["fd_verify_cached"], sv, dev,
              {f"B={B6k}": (args6k, sl6kd, B6k), f"B={B6}": (args6, sl6d, B6)}, bank12, ML1)
        k7_ab(parent_fns["fd_comb_fill"], sv, fl, dev, {"M=32": pk32, f"M={M12}": pk12})
    del b8, tall, tv12
    log(f"[comb] {len(vs13.stream)} frames signed in {sign_s:.1f} s; K7 comb_fill M=32:"
        f" {ms7:.4f} ms (bound {bms7:.4f} ms, {bby7}), M={M12}: {ms7all:.4f} ms (bound"
        f" {bms7all:.4f} ms, {bby7all}); tables and ok equal to plain on every column,"
        f" ok to ed25519_ref ({int(okh.sum())} of {M12}), 256 entries to Python ints;"
        f" plain at M=32 {plain7:.1f} ms")
    log(f"[comb] K8 bank_install M=32: {ms8:.4f} ms (index_copy_ {lib8:.4f} ms, bound"
        f" {bms8:.4f} ms), M={VOTERS}: {ms8all:.4f} ms (index_copy_ {lib8all:.4f} ms, bound"
        f" {bms8all:.4f} ms); equal to index_copy_, untouched slots zero, reinstall ok")
    log(f"[comb] K6 verify_cached B={B6}: {ms6:.4f} ms = {B6 / ms6 / 1e3:.0f} k sigverify/s"
        f" (bound {bms6:.4f} ms, {bby6}: {ops6:.4g} ops; bytes {bytes6:.4g} ="
        f" {bytes6 / HBM_BYTES_PER_S * 1e3:.4f} ms with {n_ent6} bank entries read; K1 on the same lanes"
        f" {ms1_6:.4f} ms); B={B6k}: {ms6k:.4f} ms (bound {bms6k:.4f} ms, {bby6k}), plain"
        f" {plain6:.1f} ms; mask equal to K1's,"
        f" the labels ({int(lab6.sum())} of {B6} pass) and plain")

    # -- 13. the comb pipeline (the repeated-signer lane's main path) ------------------------
    mark("13")
    # who sends this traffic: a Solana leader's ingress during its slots,
    # mostly votes from the voting validator set (one key each, one vote per
    # slot) mixed with fee-paying transfers
    e13 = vs13.expect
    ends13 = [vs13.wave1, len(vs13.stream)]

    def drive_comb(comb_slots: int) -> tuple[float, dict, dict]:
        """One run of a fresh verify pipeline over the vote stream in its two
        waves: (seconds, report, launches), checked."""
        pipe = build_verify_pipeline(vs13.stream, device=dev, batch=B1, max_msg_len=ML1,
                                     comb_slots=comb_slots, promote_threshold=2)
        kbuild.reset_launches()
        t0 = time.perf_counter()
        pipe.run_waves(ends13)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        pipe.close()
        rep = pipe.report()
        la = dict(kbuild.LAUNCHES)
        v = rep["verify"]
        where = f"comb_slots={comb_slots} pipeline"
        for stage, key, want in (("verify", "txn_verified", e13["txn_verified"]),
                                 ("verify", "verify_fail", e13["verify_fail"]),
                                 ("verify", "parse_fail", e13["parse_fail"]),
                                 ("verify", "dedup_dup", e13["tile_dedup_dup"]),
                                 ("dedup", "dedup_dup", e13["dedup_dup"]),
                                 ("sink", "txn_sunk", e13["sunk"])):
            check(rep[stage].get(key, 0) == want,
                  f"{where} {stage}.{key} {rep[stage].get(key, 0)} != {want}")
        check(sorted(p for p, _ in pipe.sink.frames) == sorted_sunk13, f"{where} sink frames")
        want_la = {"verify_batch": v["batches"] - v.get("comb_batches", 0),
                   "verify_cached": v.get("comb_batches", 0),
                   "comb_fill": v.get("comb_fills", 0),
                   "bank_install": v.get("comb_installs", 0)}
        check({k: la.get(k, 0) for k in want_la} == want_la,
              f"{where}: launches {la} != the stage's batches and fills {want_la}")
        if comb_slots:
            check(v.get("comb_filled", 0) == e13["comb_filled"],
                  f"{where}: comb_filled {v.get('comb_filled', 0)} != {e13['comb_filled']}")
            check(v.get("comb_elems", 0) == e13["comb_elems"],
                  f"{where}: comb_elems {v.get('comb_elems', 0)} != {e13['comb_elems']}")
            check(min(want_la.values()) > 0, f"{where}: a comb-lane kernel never launched")
        return run_s, rep, la

    sorted_sunk13 = sorted(vs13.expect_sunk)
    run13_s, rep13, launches13 = drive_comb(BANK_SLOTS)
    run13g_s, rep13g, launches13g = drive_comb(0)
    txn13 = rep13["sink"]["txn_sunk"] / run13_s
    txn13g = rep13g["sink"]["txn_sunk"] / run13g_s
    v13 = rep13["verify"]
    busy13 = (launches13.get("verify_batch", 0) * ms1k + launches13["verify_cached"] * ms6k
              + launches13["comb_fill"] * ms7 + launches13["bank_install"] * ms8) / (run13_s * 1e3)
    log(f"[comb-pipeline] {len(vs13.stream)} frames ({VOTERS} voters x {VOTE_ROUNDS} slots,"
        f" {VOTE_TRANSFERS} transfers), bank {BANK_SLOTS} slots: {run13_s:.3f} s ="
        f" {txn13:.0f} txn/s sunk; comb_slots=0 on the same stream {run13g_s:.3f} s ="
        f" {txn13g:.0f} txn/s; comb_filled {v13['comb_filled']}, comb_elems"
        f" {v13['comb_elems']} of {v13['batch_elems']}; launches {launches13} (generic:"
        f" {launches13g}); device busy <= {busy13:.3f} of the run; counters {json.dumps(rep13)}")
    rounds13 = [(txn13, txn13g)]
    for r in range(COMB_REPEAT_ROUNDS):
        got = {}
        for cs in ((0, BANK_SLOTS) if r % 2 == 0 else (BANK_SLOTS, 0)):
            run_s_, rep_, _ = drive_comb(cs)
            got[cs] = rep_["sink"]["txn_sunk"] / run_s_
        rounds13.append((got[BANK_SLOTS], got[0]))
    c13s, g13s = sorted(a for a, _ in rounds13), sorted(b for _, b in rounds13)
    ratios13 = sorted(a / b for a, b in rounds13)
    mid = len(rounds13) // 2
    log(f"[comb-repeat] {len(rounds13)} rounds (the first is above): comb pipeline txn/s"
        f" median {c13s[mid]:.0f} (min {c13s[0]:.0f}, max {c13s[-1]:.0f}); comb_slots=0"
        f" median {g13s[mid]:.0f} (min {g13s[0]:.0f}, max {g13s[-1]:.0f}); comb/generic per"
        f" round median {ratios13[mid]:.3f} (min {ratios13[0]:.3f}, max {ratios13[-1]:.3f});"
        f" rounds (comb, generic) {[(round(a), round(b)) for a, b in rounds13]}")

    # -- 14. the split rung's kernels alone: K9-K12 ------------------------------------------
    mark("14")
    B14 = 16384
    lab5 = mb.labels.copy()  # phase 5's pad lanes hold honest triples; the split has no n_real
    for i in range(mb.n_real, B1):
        lab5[i] = ref.verify(bytes(mb.msg[: mb.msg_len[i], i]), bytes(mb.sig[:, i]),
                             bytes(mb.pubkey[:, i]))
    rep14 = B14 // B1
    args14 = [torch.from_numpy(np.ascontiguousarray(np.tile(a, (1,) * (a.ndim - 1) + (rep14,))))
              .to(dev) for a in (mb.msg, mb.msg_len, mb.sig, mb.pubkey)]
    lab14 = np.tile(lab5, rep14)
    kbuild.reset_launches()
    smask14, n_ok14 = sv.verify_dispatch("split", *args14, B14, max_msg_len=ML1)
    k1mask14, _ = sv.verify_batch(*args14, B14, max_msg_len=ML1)
    torch.cuda.synchronize()
    check(n_ok14 is None, "split lane returned a count")
    smask14h = smask14.cpu().numpy()
    check((smask14h == k1mask14.cpu().numpy()).all(), "split mask differs from K1's at B = 16,384")
    check((smask14h == lab14).all(), "split mask differs from the labels: lanes "
          + str(np.nonzero(smask14h != lab14)[0][:16].tolist()))
    check(sv.kernel_compiled_entries("split") == sv.kernel_dispatch_count("split") == 4,
          "split lane: loaded entry points != 4")
    # each phase against its plain version at the stage's batch
    m5, l5, s5, p5 = (a[..., :B1].contiguous() for a in args14)
    a14, r14, ok14 = sv._phase_validate(s5, p5, l5, max_msg_len=ML1)
    k14 = sv._phase_hash(m5, l5, s5, p5, max_msg_len=ML1)
    rc14 = sv._phase_dsm(k14, a14, s5)
    mk14 = sv._phase_compare(rc14, r14, ok14)
    torch.cuda.synchronize()
    plain14, errs14 = {}, {}
    for nm, got_, plain_fn in (
            ("phase_validate", (a14, r14, ok14), lambda: sv._phase_validate_plain(s5, p5, l5, ML1)),
            ("phase_hash", (k14,), lambda: (sv._phase_hash_plain(m5, l5, s5, p5, ML1),)),
            ("phase_dsm", (rc14,), lambda: (sv._phase_dsm_plain(k14, a14, s5),)),
            ("phase_compare", (mk14,), lambda: (sv._phase_compare_plain(rc14, r14, ok14),))):
        out_ = []
        plain14[nm] = time_host_ms(lambda: out_.extend(plain_fn()))
        errs14[nm] = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                         for g, w in zip(got_, out_))
        check(errs14[nm] == 0, f"{nm} differs from its plain version at B = {B1}"
              f" (max abs err {errs14[nm]})")
    check(mk14.cpu().numpy().tolist() == lab5.tolist(), "split mask at B = 1,024 != labels")
    # K9 and K10 on the full grid at B = 16,384: its last 1,024 lanes against
    # their plain versions on the same lanes
    m16, l16, s16, p16 = args14
    a16, r16, ok16 = sv._phase_validate(s16, p16, l16, max_msg_len=ML1)
    k16 = sv._phase_hash(m16, l16, s16, p16, max_msg_len=ML1)
    torch.cuda.synchronize()
    mt16, lt16, st16, pt16 = (a[..., B14 - B1:].contiguous() for a in args14)
    for nm, got_, want_ in (
            ("phase_validate", (a16[..., B14 - B1:], r16[..., B14 - B1:], ok16[B14 - B1:]),
             sv._phase_validate_plain(st16, pt16, lt16, ML1)),
            ("phase_hash", (k16[:, B14 - B1:],),
             (sv._phase_hash_plain(mt16, lt16, st16, pt16, ML1),))):
        err16 = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                    for g, w in zip(got_, want_))
        check(err16 == 0, f"{nm} at B = {B14} differs from its plain version on lanes"
              f" {B14 - B1}-{B14 - 1} (max abs err {err16})")
        errs14[nm] = max(errs14[nm], err16)
    # K12 at ragged batches: ok cleared on a seeded quarter of the lanes
    # besides those K9 refused, random bits in r_pt wherever ok is false;
    # the mask equal to its plain version, and on the lanes left ok to the
    # labels
    rc16 = sv._phase_dsm(k16, a16, s16)
    rng12 = np.random.default_rng(12)
    drop12 = rng12.random(B14) < K12_DROP
    ok12 = ok16 & ~torch.from_numpy(drop12).to(dev)
    junk12 = torch.from_numpy(rng12.integers(-2**31, 2**31, (4, 10, B14))
                              .astype(np.int32)).to(dev)
    r12 = torch.where(ok12, r16, junk12)
    runs12 = {f"mixed B={b}": tuple(x[..., :b].contiguous() for x in (rc16, r12, ok12))
              for b in K12_BATCHES}
    for label, run in runs12.items():
        b = run[2].shape[0]
        got12 = sv._phase_compare(*run)
        err12 = int((got12.to(torch.int64) - sv._phase_compare_plain(*run).to(torch.int64))
                    .abs().max())
        check(err12 == 0, f"phase_compare differs from its plain version at {label}")
        check(got12.cpu().numpy().tolist() == (lab14[:b] & ~drop12[:b]).tolist(),
              f"phase_compare differs from the labels at {label}")
    log(f"[split] K12 at B = {', '.join(map(str, K12_BATCHES))} (ok cleared on"
        f" {int(drop12.sum())} more lanes of {B14}, random bits in r_pt there): mask equal"
        " to plain and to the labels")
    # K12's SASS as one block (it has no loop): every load of a lane is
    # issued at once, so a thread waits for one global round trip
    sass12 = {"change": fsass.whole(fsass.dump(os.path.join(kbuild.build_dir(),
                                                            "libverify_split.so")),
                                    "phase_compare_kernel")}
    if parent_fns is not None:
        sass12["parent"] = fsass.whole(fsass.dump(parent_lib("verify_split")),
                                       "phase_compare_kernel")
    log("[K12-sass] " + "; ".join(
        f"{who}: {w['n']} instructions ({w['called']} in called functions), longest dependent"
        f" chain {w['depth']}, {w['clocks']} stall clocks, global loads in series"
        f" {w['load_rounds']}; " + ", ".join(f"{op} {c}" for op, c in list(w["ops"].items())[:8])
        for who, w in sass12.items()))
    check(sass12["change"]["load_rounds"] == 1,
          f"K12 waits for {sass12['change']['load_rounds']} global round trips in series")
    if parent_fns is not None:
        dec16 = sv.fc.point_decompress(p16.to(torch.int64))[1]
        k11_ab(parent_fns["fd_phase_dsm"], sv, sv.fc, dev, {
            f"B={B1}": (k14, a14, s5, r14, ok14, dec16[:B1]),
            f"B={B14}": (k16, a16, s16, r16, ok16, dec16)})
        # K9 and K10: equal on the mixed batch, timed on phase 6's transfers
        # (the split pipeline's shape at B = 1,024)
        rdec16 = sv.fc.point_decompress(s16[:32].to(torch.int64))[1]
        k9_ab(parent_fns["fd_phase_validate"], sv, dev,
              {f"mixed B={B1}": (s5, p5, l5, dec16[:B1], rdec16[:B1]),
               f"mixed B={B14}": (s16, p16, l16, dec16, rdec16)},
              {f"B={B1}": (args1k[2], args1k[3], args1k[1]),
               f"B={BT}": (argst[2], argst[3], argst[1])}, ML1)
        # K12: equal on the ragged mixed batches, timed on phase 6's
        # transfers through K9-K11 (every lane ok)
        timed12 = {}
        for bsz, (mt_, lt_, st_, pt_) in ((B1, args1k), (BT, argst)):
            a_, r_, ok_ = sv._phase_validate(st_, pt_, lt_, max_msg_len=ML1)
            k_ = sv._phase_hash(mt_, lt_, st_, pt_, max_msg_len=ML1)
            timed12[f"B={bsz}"] = (sv._phase_dsm(k_, a_, st_), r_, ok_)
        k12_ab(parent_fns["fd_phase_compare"], sv, dev, runs12, timed12)
        k10_ab(parent_fns["fd_phase_hash"], sv, dev,
               {f"mixed B={B1}": (m5, l5, s5, p5), f"mixed B={B14}": tuple(args14),
                f"B={BT}": tuple(argst)},
               {f"B={B1}": tuple(args1k), f"B={BT}": tuple(argst)}, ML1)
    phase14_launches = dict(kbuild.LAUNCHES)
    # times, CUDA events, each phase alone on phase 6's honest batch (K1's
    # timing batch) at B = 16,384 and at the stage's 1,024
    times14 = {}
    for bsz, targs in ((BT, argst), (B1, args1k)):
        mt_, lt_, st_, pt_ = targs
        a_, r_, ok_ = sv._phase_validate(st_, pt_, lt_, max_msg_len=ML1)
        k_ = sv._phase_hash(mt_, lt_, st_, pt_, max_msg_len=ML1)
        rc_ = sv._phase_dsm(k_, a_, st_)
        reps = 3 if bsz == BT else 10
        calls = {
            "phase_validate": lambda: sv._phase_validate(st_, pt_, lt_, max_msg_len=ML1),
            "phase_hash": lambda: sv._phase_hash(mt_, lt_, st_, pt_, max_msg_len=ML1),
            "phase_dsm": lambda: sv._phase_dsm(k_, a_, st_),
        }
        # per call (the wrapper's host cost included) and device only
        times14[bsz] = {nm: time_ms(fn, reps=reps) for nm, fn in calls.items()}
        times14[bsz].update({f"{nm}_dev": time_ms(fn, reps=2 * reps, hide_host=True)
                             for nm, fn in calls.items()})
        times14[bsz].update({
            "phase_compare": time_ms(lambda: sv._phase_compare(rc_, r_, ok_), reps=K12_REPS,
                                     hide_host=True),
            "split": time_ms(lambda: sv.ed25519_verify_batch_split(mt_, lt_, st_, pt_,
                                                                   max_msg_len=ML1), reps=reps),
            "k1": time_ms(lambda: sv.verify_batch(mt_, lt_, st_, pt_, bsz, max_msg_len=ML1),
                          reps=reps),
        })
    # bounds from phase 6's inputs at B = 16,384 (every lane honest: every
    # lane runs every check and the whole ladder).  Bytes are what each
    # kernel reads and writes: K9 all of sig and pubkey, msg_len, two points
    # and ok; K10 R (sig rows 0-31), A, each lane's msg_len bytes of msg,
    # msg_len and k; K11 k, s (sig rows 32-63), A and the comb, writing
    # r_cmp; K12 X, Y, Z of r_cmp, X, Y of R and ok, writing the mask
    fe_bytes = 10 * 4  # one coordinate, 10 int32 limbs
    pt_bytes = 4 * fe_bytes  # one point, (4, 10) int32
    comb_bytes = 64 * 16 * 4 * fl.NLIMB * 4

    def bounds_at(bsz: int) -> dict:
        lt6 = lt[:bsz].astype(np.int64)
        return {
            "phase_validate": bound(bsz * sv.PRODUCTS_PER_VALIDATE_LANE,
                                    bsz * (64 + 32 + 4 + 2 * pt_bytes + 1)),
            "phase_hash": bound(int(((lt6 + 64 + 17 + 127) // 128).sum()) * SHA512_OPS_PER_BLOCK,
                                int(lt6.sum()) + bsz * (32 + 32 + 4 + 32)),
            "phase_dsm": bound(bsz * sv.PRODUCTS_PER_DSM_LANE,
                               bsz * (32 + 32 + 2 * pt_bytes) + comb_bytes),
            "phase_compare": bound(bsz * sv.MULS_EQ_Z1 * sv.PRODUCTS_PER_MUL,
                                   bsz * (5 * fe_bytes + 1 + 1)),
        }

    bounds14, bounds14_1k = bounds_at(BT), bounds_at(B1)
    t16, t1k = times14[BT], times14[B1]
    for nm, line in zip(SPLIT, SPLIT_LINES):
        bms, bby = bounds14[nm]
        kernels.append(dict(
            name=nm, route="cuda", source="firedancer_tpu_torch/csrc/verify_split.cu",
            replaces=f"firedancer_tpu/ops/sigverify.py:{line}", launches=None,
            max_abs_err=errs14[nm], ms=t16[nm], plain_ms=plain14[nm], bound_ms=bms,
            bound_by=bby, library_ms=None, matched=True, shape=f"B={BT} max_msg_len={ML1}",
            plain_shape=f"B={B1}", ms_batch1024=t1k[nm], bound_ms_batch1024=bounds14_1k[nm][0],
            device_ms=t16.get(f"{nm}_dev", t16[nm]),
            device_ms_batch1024=t1k.get(f"{nm}_dev", t1k[nm]),
            phase_launches=phase14_launches.get(nm, 0)))
    log(f"[split] B={B14} (phase 5's batch x {rep14}): mask equal to K1's and the labels"
        f" ({int(lab14.sum())} of {B14} pass), K9's limbs and ok and K10's k on lanes"
        f" {B14 - B1}-{B14 - 1} equal to plain; B={B1}: limbs, k, ok and mask equal to plain;"
        f" loaded entry points {sv.kernel_compiled_entries('split')}")
    log("[split] " + "; ".join(
        f"{nm} {t16[nm]:.4f} ms at B={BT} ({t1k[nm]:.4f} ms at B={B1}; device only"
        f" {t16.get(f'{nm}_dev', t16[nm]):.4f} / {t1k.get(f'{nm}_dev', t1k[nm]):.4f} ms; bounds"
        f" {bounds14[nm][0]:.4f} / {bounds14_1k[nm][0]:.4f} ms, {bounds14[nm][1]}; plain"
        f" {plain14[nm]:.1f} ms at B={B1})"
        for nm in SPLIT)
        + f"; sum of the four {sum(t16[n] for n in SPLIT):.4f} ms, four launches back to back"
        f" {t16['split']:.4f} ms, K1 on the same lanes {t16['k1']:.4f} ms (ratio"
        f" {t16['split'] / t16['k1']:.3f}); at B={B1}: sum {sum(t1k[n] for n in SPLIT):.4f} ms,"
        f" back to back {t1k['split']:.4f} ms, K1 {t1k['k1']:.4f} ms")

    # -- 15. the split pipeline (the split rung's main path) --------------------------------
    mark("15")
    def drive_split() -> tuple[float, dict]:
        """One run of a fresh split-lane verify pipeline over phase 7's stream."""
        pipe = build_verify_pipeline(vs.stream, device=dev, batch=B1, max_msg_len=ML1,
                                     kernel="split")
        kbuild.reset_launches()
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        pipe.close()
        rep = pipe.report()
        nb = rep["verify"]["batches"]
        check_run(rep, pipe.sink, "split pipeline",
                  launches={**dict.fromkeys(SPLIT, nb), "verify_batch": 0})
        return run_s, rep

    run15_s, rep15 = drive_split()
    launches15 = dict(kbuild.LAUNCHES)
    run7b_s, rep7b = drive_verify()  # the fused lane again, beside it in time
    txn15, txn7b = rep15["sink"]["txn_sunk"] / run15_s, rep7b["sink"]["txn_sunk"] / run7b_s
    busy15 = rep15["verify"]["batches"] * t1k["split"] / (run15_s * 1e3)
    log(f"[split-pipeline] {len(vs.stream)} frames in {run15_s:.3f} s: {txn15:.0f} txn/s sunk"
        f" (the fused pipeline right after it: {txn7b:.0f}); launches {launches15}; device busy"
        f" <= {busy15:.3f} of the run (the four phases' event time x batches); counters"
        f" {json.dumps(rep15)}")
    rounds15 = [(txn15, txn7b)]
    for r in range(SPLIT_REPEAT_ROUNDS):
        got = {}
        for fn in ((drive_verify, drive_split) if r % 2 == 0 else (drive_split, drive_verify)):
            run_s_, rep_ = fn()
            got[fn] = rep_["sink"]["txn_sunk"] / run_s_
        rounds15.append((got[drive_split], got[drive_verify]))
    s15s, f15s = sorted(a for a, _ in rounds15), sorted(b for _, b in rounds15)
    ratios15 = sorted(a / b for a, b in rounds15)
    mid = len(rounds15) // 2
    log(f"[split-repeat] {len(rounds15)} rounds (the first is above): split pipeline txn/s"
        f" median {s15s[mid]:.0f} (min {s15s[0]:.0f}, max {s15s[-1]:.0f}); fused median"
        f" {f15s[mid]:.0f} (min {f15s[0]:.0f}, max {f15s[-1]:.0f}); split/fused per round median"
        f" {ratios15[mid]:.3f} (min {ratios15[0]:.3f}, max {ratios15[-1]:.3f}); rounds (split,"
        f" fused) {[(round(a), round(b)) for a, b in rounds15]}")

    # -- 15b. the verify stage's serving-plane hook -----------------------------------------
    mark("15b")
    plane15 = ServePlane(ServeConfig(n_devices=1, batch_per_shard=B1, max_msg_len=ML1))
    pipe15b = build_verify_pipeline(vs.stream, batch=B1, max_msg_len=ML1, plane=plane15)
    check(pipe15b.verify.device == dev, "plane hook: the stage is not on the plane's device")
    kbuild.reset_launches()
    t0 = time.perf_counter()
    pipe15b.run()
    torch.cuda.synchronize()
    run15b_s = time.perf_counter() - t0
    pipe15b.close()
    rep15b = pipe15b.report()
    check_run(rep15b, pipe15b.sink, "plane-hook pipeline",
              launches={"verify_batch": rep15b["verify"]["batches"], "sha256_iter32": 0})
    launches15b = dict(kbuild.LAUNCHES)
    log(f"[plane-hook] {len(vs.stream)} frames in {run15b_s:.3f} s:"
        f" {rep15b['sink']['txn_sunk'] / run15b_s:.0f} txn/s sunk; launches {launches15b};"
        f" counters {json.dumps(rep15b)}")

    # -- 15c. the autotuner on the vote stream ------------------------------------------------
    mark("15c")
    def drive_tune(autotune_after: int) -> tuple[float, dict, object]:
        pipe = build_verify_pipeline(vs13.stream, device=dev, batch=TUNE_BATCH,
                                     max_msg_len=ML1, autotune_after=autotune_after)
        kbuild.reset_launches()
        t0 = time.perf_counter()
        pipe.run_waves(ends13)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        pipe.close()
        rep = pipe.report()
        where = f"autotune_after={autotune_after} pipeline"
        for stage, key, want in (("verify", "txn_verified", e13["txn_verified"]),
                                 ("verify", "verify_fail", e13["verify_fail"]),
                                 ("verify", "parse_fail", e13["parse_fail"]),
                                 ("verify", "dedup_dup", e13["tile_dedup_dup"]),
                                 ("dedup", "dedup_dup", e13["dedup_dup"]),
                                 ("sink", "txn_sunk", e13["sunk"])):
            check(rep[stage].get(key, 0) == want,
                  f"{where} {stage}.{key} {rep[stage].get(key, 0)} != {want}")
        check(sorted(p for p, _ in pipe.sink.frames) == sorted_sunk13, f"{where} sink frames")
        check(kbuild.LAUNCHES.get("verify_batch", 0) == rep["verify"]["batches"],
              f"{where}: K1 launches {kbuild.LAUNCHES.get('verify_batch', 0)}"
              f" != batches {rep['verify']['batches']}")
        return run_s, rep, pipe.verify

    run15u_s, rep15u, v15u = drive_tune(0)
    run15c_s, rep15c, v15c = drive_tune(TUNE_AFTER)
    launches15c = dict(kbuild.LAUNCHES)
    check(v15u.metrics.get("retunes") == 0 and (v15u.batch, v15u.max_msg_len) == (TUNE_BATCH, ML1),
          "the untuned run retuned")
    check(v15c.metrics.get("retunes") >= 1, "autotune: no retune on the vote stream")
    check(v15c.batch < TUNE_BATCH and v15c.max_msg_len < ML1,
          f"autotune: geometry ({v15c.batch}, {v15c.max_msg_len}) did not shrink")
    fill15 = v15c.metrics.hist("batch_fill")
    log(f"[autotune] vote stream at batch {TUNE_BATCH}, max_msg_len {ML1}: untuned"
        f" {rep15u['sink']['txn_sunk'] / run15u_s:.0f} txn/s ({rep15u['verify']['batches']}"
        f" batches); autotune_after={TUNE_AFTER}: {rep15c['sink']['txn_sunk'] / run15c_s:.0f}"
        f" txn/s ({rep15c['verify']['batches']} batches), retunes"
        f" {v15c.metrics.get('retunes')}, geometry now batch {v15c.batch} max_msg_len"
        f" {v15c.max_msg_len} comb split {v15c._comb_lane_on}; batch fill p95"
        f" {tune_quantile(fill15, 0.95):.0f}, msg_len p99"
        f" {tune_quantile(v15c.metrics.hist('msg_len'), 0.99):.0f}; sorted frames equal; launches"
        f" {launches15c}")

    # -- 16. K13 lthash_combine alone ----------------------------------------------------------
    mark("16")
    k13, runs16 = {}, {}
    for n16 in K13_CHECK_ROWS + K13_ROWS:
        rng = np.random.default_rng(16 + n16)
        v16 = torch.from_numpy(rng.integers(0, 1 << 16, (n16, flt.LEN_ELEMS), dtype=np.uint16)
                               .view(np.int16)).to(dev)
        s16 = torch.from_numpy(rng.integers(-1, 2, n16).astype(np.int8)).to(dev)
        kbuild.reset_launches()
        got16 = flt.combine_device(v16, s16)
        torch.cuda.synchronize()
        err16 = int((got16.to(torch.int64) - flt.combine_plain(v16, s16).to(torch.int64)).abs().max())
        check(err16 == 0, f"K13 differs from its plain version at N = {n16} (max abs err {err16})")
        # the JAX seal's power-of-two padding: zero rows of sign 0 change nothing
        cap = 1 << (n16 - 1).bit_length() if n16 & (n16 - 1) else 2 * n16
        vp = torch.cat([v16, torch.zeros((cap - n16, flt.LEN_ELEMS), dtype=torch.int16, device=dev)])
        sp = torch.cat([s16, torch.zeros((cap - n16,), dtype=torch.int8, device=dev)])
        check(torch.equal(flt.combine_device(vp, sp), got16), f"K13 padded != unpadded at N = {n16}")
        check(torch.equal(flt.combine_device(v16), flt.combine_plain(v16, None)),
              f"K13 unsigned differs from its plain version at N = {n16}")
        check(kbuild.LAUNCHES["lthash_combine"] == 3, f"K13 launches {kbuild.LAUNCHES} != 3")
        if n16 not in K13_ROWS:
            log(f"[K13] lthash_combine N={n16}: equal to plain (signed, unsigned) and to the"
                f" padded N={cap}")
            continue
        runs16[f"N={n16}"] = (v16, s16)
        signed16 = (v16.to(torch.int32) & 0xFFFF) * s16.to(torch.int32)[:, None]
        ms16 = time_ms(lambda: flt.combine_device(v16, s16), reps=50, hide_host=True)
        lib16 = time_ms(lambda: torch.sum(signed16, dim=0), reps=50, hide_host=True)
        plain16 = time_ms(lambda: flt.combine_plain(v16, s16), reps=10)
        b16, bby16 = bound(2 * n16 * flt.LEN_ELEMS, n16 * (2 * flt.LEN_ELEMS + 1) + 4 * flt.LEN_ELEMS)
        k13[n16] = dict(ms=ms16, plain_ms=plain16, library_ms=lib16, bound_ms=b16,
                        bound_by=bby16, max_abs_err=err16, padded_rows=cap)
        log(f"[K13] lthash_combine N={n16}: equal to plain (signed, unsigned) and to the"
            f" padded N={cap}; {ms16 * 1e3:.2f} us (bound {b16 * 1e3:.2f} us, {bby16});"
            f" torch.sum over pre-signed int32 {lib16 * 1e3:.2f} us (sign multiply not"
            f" included); plain {plain16 * 1e3:.2f} us")
    phase16_launches = kbuild.LAUNCHES["lthash_combine"]
    # one call's device kernels, from a profiler trace: K13 alone, no fill or mask pass
    names16 = device_kernels(lambda: flt.combine_device(*runs16[f"N={K13_ROWS[0]}"]))
    check(names16 is not None, "the profiler's trace of a K13 call holds no device activity")
    check(len(names16) == 1 and "lthash_combine" in names16[0],
          f"a K13 call launched {names16}, not K13 alone")
    log(f"[K13] one call at N={K13_ROWS[0]} launches on the card (torch.profiler): "
        + ", ".join(names16))
    if PARENT:
        k13_ab(parent_fns["fd_lthash_combine"], flt, dev, runs16)
        k13_knobs(kbuild, parent_fns, flt, dev, runs16)

    # -- 17. the leader pipeline at full width (main path) ------------------------------------
    mark("17")
    t0 = time.perf_counter()
    pool17 = gen_transfer_pool(LEADER_TXNS, n_payers=8, n_dests=LEADER_DESTS)
    gen17_s = time.perf_counter() - t0
    # the Python shredder: its K5 calls go through gf_apply_batch, where the
    # recording below takes them (the native shredder launches K5 from C)
    pipe17 = build_leader_pipeline(pool17, device=dev, batch=B1, max_msg_len=ML1,
                                   n_bank=2, keep_entries=True, pack_depth=LEADER_TXNS,
                                   native_shred=False)
    # every K5 launch of phases 17 and 17b, recorded with its inputs
    k5_rec = {"17": [], "17b": []}
    k5_launch = g2.gf_apply_batch

    def k5_recording(phase):
        def rec(mat, data):
            if data.device.type == "cuda":
                k5_rec[phase].append((mat.clone(), data.clone()))
            return k5_launch(mat, data)
        return rec

    k5_parent_call = k5_parent(parent_fns["fd_gf256_apply"], dev) if parent_fns else None
    kbuild.reset_launches()
    g2.gf_apply_batch = k5_recording("17")
    try:
        t0 = time.perf_counter()
        pipe17.run()
        torch.cuda.synchronize()
        run17_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        seal17 = pipe17.seal()
        seal17_s = time.perf_counter() - t0
        pipe17.close()  # the builder's ctx: its store closes here
    finally:
        g2.gf_apply_batch = k5_launch
    launches17 = dict(kbuild.LAUNCHES)
    check(len(k5_rec["17"]) == launches17.get("gf256_apply", 0),
          f"leader pipeline: {len(k5_rec['17'])} K5 calls recorded, {launches17} launched")
    k5_17 = k5_launch_times(k5_rec["17"], k5_launch, int_ops_per_s, k5_parent_call)
    rep17 = pipe17.report()
    landed17 = sum(rep17[b.name].get("txn_exec", 0) for b in pipe17.banks)
    check(landed17 == LEADER_TXNS == seal17.signature_cnt,
          f"leader pipeline landed {landed17}, sealed {seal17.signature_cnt} of {LEADER_TXNS}")
    batch17 = pipe17.store.entry_batch_bytes(1)
    ents17 = [parse_entry(x) for x in deshred_entry_batch(batch17)]
    check(ents17 == [(n_, bytes(h_), list(t_)) for n_, h_, t_ in pipe17.poh.entries],
          "leader pipeline: deshredded store bytes != PoH's entries")
    nb17 = rep17["shred"]["entry_batches"]
    check(launches17.get("lthash_combine", 0) == 1, f"K13 launches {launches17} != 1 per seal")
    check(nb17 <= launches17.get("gf256_apply", 0) <= 2 * nb17,
          f"K5 launches {launches17.get('gf256_apply', 0)} not 1-2 per shredded entry batch ({nb17})")
    check(launches17.get("verify_batch", 0) == rep17["verify0"]["batches"],
          f"K1 launches {launches17.get('verify_batch', 0)} != batches {rep17['verify0']['batches']}")
    fund17 = default_bank_ctx(slot=1, device=dev)
    t0 = time.perf_counter()
    rp17 = replay_block(fund17.funk, slot=1, entries=ents17, poh_seed=b"\x00" * 32,
                        status_cache=fund17.status_cache, device=dev)
    replay17_s = time.perf_counter() - t0
    check(rp17 is not None and rp17.bank_hash == seal17.bank_hash
          and np.array_equal(rp17.accounts_delta, seal17.accounts_delta)
          and rp17.signature_cnt == seal17.signature_cnt,
          "leader pipeline: replay_block does not reproduce the seal")
    fund17.close()
    split17 = dict(pipe17.stage_s)
    txn17_s = landed17 / run17_s
    # upper estimate: each K1 launch a full batch's time, each K5 launch its
    # shape's time alone ([K5-launches]), K13 phase 16's N = 1,040 (the seal's)
    busy17 = (launches17.get("verify_batch", 0) * ms1k + sum(x["ms"] for x in k5_17)
              + k13[K13_ROWS[0]]["ms"]) / ((run17_s + seal17_s) * 1e3)
    log(f"[leader] {LEADER_TXNS} transfers (8 payers, {LEADER_DESTS} dests; pool signed in"
        f" {gen17_s:.1f} s) at batch {B1}, 2 banks: run {run17_s:.3f} s = {txn17_s:.0f} txn/s"
        f" to the store; seal {seal17_s:.3f} s (bank hash {seal17.bank_hash.hex()});"
        f" {rep17['store']['sets_stored']} FEC sets in {nb17} entry batches, entry bytes"
        f" sha256 {hashlib.sha256(batch17).hexdigest()}; replay reproduces the seal in"
        f" {replay17_s:.3f} s; launches {launches17}; device busy <= {busy17:.3f} of the"
        f" slot (run + seal; K1, K5 and K13 event times x launches)")
    log(f"[leader-split] host seconds {json.dumps({k: round(v, 4) for k, v in sorted(split17.items())})}"
        f" (run {run17_s:.3f} s + seal {seal17_s:.3f} s); {funk_plane('leader', rep17, pipe17.banks)};"
        f" counters {json.dumps(rep17)}")
    ne17 = native_counts(rep17, pipe17.banks)
    check(ne17[0] > 0, f"leader pipeline: the native executor lane ran no txn {ne17}")
    log(f"[native-exec] 17: native_exec {ne17[0]}, native_punt {ne17[1]} ({landed17} landed)")
    # phase 17's pool again on each ring lane, warm, in turns (no seal): the
    # rings' end-to-end effect outside the slot clock
    rings17: dict[str, list] = {"native": [], "python": []}
    for lane_ in ("native", "python", "python", "native"):
        p_ = build_leader_pipeline(pool17, device=dev, batch=B1, max_msg_len=ML1, n_bank=2,
                                   pack_depth=LEADER_TXNS, native_ring=lane_ == "native")
        t0 = time.perf_counter()
        p_.run()
        torch.cuda.synchronize()
        dt_ = time.perf_counter() - t0
        p_.close()
        landed_ = sum(b.metrics.get("txn_exec") for b in p_.banks)
        check(landed_ == LEADER_TXNS, f"leader-rings: {lane_} rings landed {landed_}")
        rings17[lane_].append((landed_ / dt_, p_.sweeps, {k: round(v, 4) for k, v
                                                          in sorted(p_.stage_s.items())}))
    log(f"[leader-rings] phase 17's pool again, warm, in turns native / python / python /"
        f" native rings: txn/s to the store {[round(r_[0]) for r_ in rings17['native']]} native,"
        f" {[round(r_[0]) for r_ in rings17['python']]} python; sweeps"
        f" {[r_[1] for r_ in rings17['native']]} / {[r_[1] for r_ in rings17['python']]};"
        f" host seconds native {json.dumps(rings17['native'][0][2])}, python"
        f" {json.dumps(rings17['python'][0][2])}")

    # -- 17b. lossy receive: up to p shreds of each set dropped, full verification -------------
    mark("17b")
    rng = np.random.default_rng(17)
    wire17, need17 = [], 0
    for st in pipe17.shred.sets:
        shreds = list(st.data_shreds) + list(st.parity_shreds)
        gone = set(rng.choice(len(shreds), int(rng.integers(1, len(st.parity_shreds) + 1)),
                              replace=False).tolist())
        need17 += any(i < len(st.data_shreds) for i in gone)
        wire17 += [x for i, x in enumerate(shreds) if i not in gone]
    link17 = tshm.ShmLink.create(f"fdtpu_torch_lossy_{tshm.fresh_uid()}",
                                 depth=1 << len(wire17).bit_length(), mtu=1232)
    feed17 = tshm.make_producer(link17)
    for x in wire17:
        check(feed17.try_publish(x), "lossy store: the shred link refused a shred")
    pub17 = pipe17.leader_pub
    store17b = StoreStage("store_lossy", [tshm.make_consumer(link17)], trust_membership=False,
                          verify_sig=lambda root, sig: ref.verify(root, sig, pub17), device=dev)
    kbuild.reset_launches()
    g2.gf_apply_batch = k5_recording("17b")
    try:
        t0 = time.perf_counter()
        while store17b.ins[0].has_pending():
            store17b.run_once()
        torch.cuda.synchronize()
        lossy17_s = time.perf_counter() - t0
    finally:
        g2.gf_apply_batch = k5_launch
        store17b.drop_native_views()
        link17.close()
        link17.unlink()
    launches17b = dict(kbuild.LAUNCHES)
    check(store17b.entry_batch_bytes(1) == batch17, "lossy store: entry bytes differ")
    check(launches17b.get("gf256_apply", 0) == need17 > 0,
          f"lossy store: K5 recover launches {launches17b.get('gf256_apply', 0)} != {need17}"
          " sets missing data shreds")
    log(f"[leader-lossy] {len(wire17)} of {sum(len(st.data_shreds) + len(st.parity_shreds) for st in pipe17.shred.sets)}"
        f" shreds through a full-verification store in {lossy17_s:.3f} s: same entry bytes;"
        f" {need17} sets rebuilt; resolver {store17b.resolver.metrics}; launches {launches17b}")
    check(len(k5_rec["17b"]) == need17, f"lossy store: {len(k5_rec['17b'])} K5 calls recorded")
    k5_17b = k5_launch_times(k5_rec["17b"], k5_launch, int_ops_per_s, k5_parent_call)
    log("[K5-launches] each K5 launch's (T, m x k, S), each shape timed alone on its first"
        " launch's inputs, device only, beside its least bound: "
        + k5_launch_summary("17", k5_17) + "; " + k5_launch_summary("17b", k5_17b))
    del k5_rec

    # -- 17c. the sharded leader pipeline on the serving plane ---------------------------------
    mark("17c")
    plane17 = ServePlane(ServeConfig(n_devices=1, batch_per_shard=B1, max_msg_len=ML1,
                                     poh_chains_per_shard=4, poh_iters=HASHES_PER_TICK))
    warm17 = plane17.warmup()
    pipe17c = build_sharded_leader_pipeline(pool17, plane=plane17, n_shards=1,
                                            hashes_per_tick=HASHES_PER_TICK, keep_entries=True,
                                            pack_depth=LEADER_TXNS)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    pipe17c.run(finish=False)
    # the clock runs on past the stream until one pure tick is parked
    for _ in range(2_000_000):
        if pipe17c.poh.metrics.get("poh_spans_queued"):
            break
        pipe17c._step(pipe17c.stages)
    pipe17c.finish()
    torch.cuda.synchronize()
    run17c_s = time.perf_counter() - t0
    seal17c = pipe17c.seal()
    pipe17c.close()  # the builder's ctx: its store closes here
    launches17c = dict(kbuild.LAUNCHES)
    rep17c = pipe17c.report()
    landed17c = sum(rep17c[b.name].get("txn_exec", 0) for b in pipe17c.banks)
    q17c = rep17c["poh"].get("poh_spans_queued", 0)
    check(q17c >= 1 and rep17c["verify"].get("poh_spans_ok", 0) == q17c
          and rep17c["verify"].get("poh_spans_fail", 0) == 0,
          f"sharded leader: spans queued {q17c}, verify counters {rep17c['verify']}")
    check(launches17c.get("sha256_iter32", 0) >= 1, "sharded leader: K4 never launched")
    check(launches17c.get("lthash_combine", 0) == 1, "sharded leader: K13 launches != 1")
    nb17c = rep17c["shred"]["entry_batches"]
    check(nb17c <= launches17c.get("gf256_apply", 0) <= 2 * nb17c,
          f"sharded leader: K5 launches {launches17c.get('gf256_apply', 0)} for {nb17c} batches")
    check(launches17c.get("verify_batch", 0) == rep17c["verify"]["batches"],
          "sharded leader: K1 launches != plane steps")
    check(landed17c == LEADER_TXNS and seal17c.signature_cnt == seal17.signature_cnt
          and np.array_equal(seal17c.accounts_delta, seal17.accounts_delta),
          "sharded leader: landed txns or sealed state differ from phase 17")
    ents17c = [parse_entry(x) for x in deshred_entry_batch(pipe17c.store.entry_batch_bytes(1))]
    check(ents17c == [(n_, bytes(h_), list(t_)) for n_, h_, t_ in pipe17c.poh.entries],
          "sharded leader: deshredded store bytes != PoH's entries")
    fund17c = default_bank_ctx(slot=1, device=dev)
    rp17c = replay_block(fund17c.funk, slot=1, entries=ents17c, poh_seed=b"\x00" * 32,
                         status_cache=fund17c.status_cache, device=dev)
    check(rp17c is not None and rp17c.bank_hash == seal17c.bank_hash,
          "sharded leader: replay_block does not reproduce the seal")
    fund17c.close()
    log(f"[leader-sharded] warmup {warm17:.3f} s; run {run17c_s:.3f} s (with the tail to one"
        f" pure tick of {HASHES_PER_TICK} hashes) = {landed17c / run17c_s:.0f} txn/s to the store;"
        f" spans queued/ok {q17c}/{rep17c['verify'].get('poh_spans_ok', 0)}; replay reproduces"
        f" the seal {seal17c.bank_hash.hex()}; launches {launches17c};"
        f" {funk_plane('leader-sharded', rep17c, pipe17c.banks)}")
    seal_rows17 = pipe17.bank_ctx.sx.seal_rows
    kernels.append(dict(
        name="lthash_combine", route="cuda", source="firedancer_tpu_torch/csrc/lthash_combine.cu",
        replaces="firedancer_tpu/ops/lthash.py:43", launches=None,
        max_abs_err=max(k["max_abs_err"] for k in k13.values()),
        ms=k13[K13_ROWS[0]]["ms"], plain_ms=k13[K13_ROWS[0]]["plain_ms"],
        bound_ms=k13[K13_ROWS[0]]["bound_ms"], bound_by=k13[K13_ROWS[0]]["bound_by"],
        library_ms=k13[K13_ROWS[0]]["library_ms"], matched=True,
        shape=f"N={K13_ROWS[0]} rows x 1024 lanes (the seal's N here: {seal_rows17})",
        library="torch.sum(pre-signed int32, dim=0), sign multiply not included",
        at_rows={str(n): k13[n] for n in K13_ROWS}, phase_launches=phase16_launches))

    # -- 17d. the leader pipeline over the vote stream, comb lane on ---------------------------
    mark("17d")
    # who sends it: the voting set, one vote per validator per slot, inside
    # a leader's slot, beside fee-paying transfers: phase 13's stream, whose
    # genesis (payers, voters, each voter's vote account) and SlotHashes
    # come from vote_bank_ctx; the banks run the vote program
    ctx17d = vote_bank_ctx(vs13, device=dev)
    pipe17d = build_leader_pipeline(vs13.stream, device=dev, batch=B1, max_msg_len=ML1,
                                    n_bank=2, verify_comb_slots=BANK_SLOTS, bank_ctx=ctx17d,
                                    slot=ctx17d.slot, keep_entries=True,
                                    pack_depth=len(vs13.stream))
    kbuild.reset_launches()
    t0 = time.perf_counter()
    pipe17d.run()
    torch.cuda.synchronize()
    run17d_s = time.perf_counter() - t0
    pipe17d.close()
    t0 = time.perf_counter()
    seal17d = pipe17d.seal()
    seal17d_s = time.perf_counter() - t0
    launches17d = dict(kbuild.LAUNCHES)
    rep17d = pipe17d.report()
    v17d = rep17d["verify0"]
    landed17d = sum(rep17d[b.name].get("txn_exec", 0) for b in pipe17d.banks)
    # a verified frame is payload || packed descriptor || u16 payload size
    sunk17d = [f[:int.from_bytes(f[-2:], "little")] for f in vs13.expect_sunk]
    sigs17d = sum(ft.txn_parse(p_).signature_cnt for p_ in sunk17d)
    check(landed17d == len(sunk17d) == e13["sunk"] and seal17d.signature_cnt == sigs17d,
          f"vote leader landed {landed17d} txns ({seal17d.signature_cnt} signatures) of"
          f" {len(sunk17d)} distinct verified ({sigs17d} signatures)")
    ents17d = [parse_entry(x) for x in
               deshred_entry_batch(pipe17d.store.entry_batch_bytes(ctx17d.slot))]
    check(ents17d == [(n_, bytes(h_), list(t_)) for n_, h_, t_ in pipe17d.poh.entries],
          "vote leader: deshredded store bytes != PoH's entries")
    block17d = [p_ for _, _, txs in ents17d for p_ in txs]
    check(sorted(block17d) == sorted(sunk17d), "vote leader: the block's txns != the verified")
    fund17d = vote_bank_ctx(vs13, device=dev)
    t0 = time.perf_counter()
    rp17d = replay_block(fund17d.funk, slot=ctx17d.slot, entries=ents17d,
                         poh_seed=b"\x00" * 32, status_cache=fund17d.status_cache,
                         slot_hashes=vs13.slot_hashes, device=dev)
    replay17d_s = time.perf_counter() - t0
    check(rp17d is not None and rp17d.bank_hash == seal17d.bank_hash
          and np.array_equal(rp17d.accounts_delta, seal17d.accounts_delta)
          and rp17d.signature_cnt == seal17d.signature_cnt
          and sorted(r.status for r in rp17d.results) == sorted(r.status for r in seal17d.results),
          "vote leader: replay_block does not reproduce the seal")
    for nm in ("verify_cached", "comb_fill", "bank_install"):
        check(launches17d.get(nm, 0) > 0, f"vote leader: {nm} never launched ({launches17d})")
    check(launches17d.get("verify_batch", 0) == v17d["batches"] - v17d.get("comb_batches", 0)
          and launches17d.get("verify_cached", 0) == v17d.get("comb_batches", 0)
          and launches17d.get("comb_fill", 0) == v17d.get("comb_fills", 0)
          and launches17d.get("bank_install", 0) == v17d.get("comb_installs", 0),
          f"vote leader: launches {launches17d} != the verify stage's batches and fills {v17d}")
    check(launches17d.get("lthash_combine", 0) == 1, f"vote leader: K13 launches {launches17d}")
    nb17d = rep17d["shred"]["entry_batches"]
    check(nb17d <= launches17d.get("gf256_apply", 0) <= 2 * nb17d,
          f"vote leader: K5 launches {launches17d.get('gf256_apply', 0)} for {nb17d} batches")
    # every vote account decodes; votes that landed (block order, the
    # replay's statuses) and towers that moved
    sx17d = pipe17d.bank_ctx.sx
    towers17d = [len(vote_state_decode(acct_decode(sx17d.funk.rec_query(sx17d.xid, a_))[3]).votes)
                 for a_ in vs13.accts]
    is_vote17d = [ft.VOTE_PROGRAM in ft.txn_parse(p_).acct_addrs(p_) for p_ in block17d]
    votes_ok17d = sum(v_ and r_.status == 0 for v_, r_ in zip(is_vote17d, rp17d.results))
    check(max(towers17d) > 0, "vote leader: no tower moved")
    check(sum(towers17d) == votes_ok17d,
          f"vote leader: {sum(towers17d)} lockouts on the towers, {votes_ok17d} votes landed ok")
    split17d = dict(pipe17d.stage_s)
    txn17d_s = landed17d / run17d_s
    k5_ms17 = sum(x["ms"] for x in k5_17) / max(1, len(k5_17))
    busy17d = (launches17d.get("verify_batch", 0) * ms1k + launches17d.get("verify_cached", 0) * ms6k
               + launches17d.get("comb_fill", 0) * ms7 + launches17d.get("bank_install", 0) * ms8
               + launches17d.get("gf256_apply", 0) * k5_ms17
               + k13[K13_ROWS[0]]["ms"]) / ((run17d_s + seal17d_s) * 1e3)
    log(f"[vote-leader] {len(vs13.stream)} frames ({VOTERS} voters x {VOTE_ROUNDS} slots,"
        f" {VOTE_TRANSFERS} transfers) at batch {B1}, bank {BANK_SLOTS} slots, 2 banks, slot"
        f" {ctx17d.slot}: run {run17d_s:.3f} s = {txn17d_s:.0f} txn/s to the store ({landed17d}"
        f" txns, {seal17d.signature_cnt} signatures); votes landed ok {votes_ok17d} of"
        f" {sum(is_vote17d)}; towers moved {sum(t_ > 0 for t_ in towers17d)} of"
        f" {len(towers17d)}; seal {seal17d_s:.3f} s ({sx17d.seal_rows} rows, bank hash"
        f" {seal17d.bank_hash.hex()}); replay reproduces the seal in {replay17d_s:.3f} s;"
        f" comb_filled {v17d.get('comb_filled', 0)}, comb_elems {v17d.get('comb_elems', 0)} of"
        f" {v17d['batch_elems']}; launches {launches17d}; device busy <= {busy17d:.3f} of the"
        f" slot (run + seal; event times x launches, K5 at phase 17's mean)")
    log(f"[vote-leader-split] host seconds {json.dumps({k: round(v, 4) for k, v in sorted(split17d.items())})}"
        f" (run {run17d_s:.3f} s + seal {seal17d_s:.3f} s); phase 17 on the same card:"
        f" {txn17_s:.0f} txn/s, host seconds {json.dumps({k: round(v, 4) for k, v in sorted(split17.items())})};"
        f" {funk_plane('vote-leader', rep17d, pipe17d.banks)}; counters {json.dumps(rep17d)}")
    ne17d = native_counts(rep17d, pipe17d.banks)
    log(f"[native-exec] 17d: native_exec {ne17d[0]}, native_punt {ne17d[1]} ({landed17d} landed)")
    ctx17d.close()
    fund17d.close()

    # -- 17e. the clocked leader: a 16-slot window at 400 ms a slot -----------------------------
    mark("17e")
    # who sends it: benchg's transfers beside offline and custodial signers'
    # durable-nonce transfers, through a leader judged by the slot cadence
    durable17e = nonce_transfers(CLOCK_DURABLE)
    stream17e = []
    for i, p_ in enumerate(pool17):
        stream17e.append(p_)
        if i % CLOCK_EVERY == CLOCK_EVERY - 1 and i // CLOCK_EVERY < CLOCK_DURABLE:
            stream17e.append(durable17e[i // CLOCK_EVERY])
    check(len(stream17e) == LEADER_TXNS + CLOCK_DURABLE, f"clocked stream of {len(stream17e)}")
    durable_set17e = set(durable17e)
    nkeys17e = nonce_keys(CLOCK_DURABLE)
    clock17e = SlotClockCfg(slot_ms=CLOCK_SLOT_MS, slot0=1, ticks_per_slot=CLOCK_TICKS,
                            n_slots=CLOCK_SLOTS, miss_grace_frac=CLOCK_GRACE)
    grace17e_ms = CLOCK_SLOT_MS * CLOCK_GRACE

    def drive_window(pipe, tag: str) -> tuple:
        """Drive a clocked pipeline until PoH closes its window and the
        stream is sent (under the wall cap), then finish: (run seconds,
        seconds to the window's close, txns landed in the window).  A socket
        front (udp_ingress) is fed stream17e over loopback from one socket,
        at most INGRESS_AHEAD datagrams past its pkt_rx, and the stream is
        sent once the stage has taken every datagram."""
        tx_ = None
        if pipe.ingress:
            pipe.benchg.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, INGRESS_RCVBUF)
            tx_ = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        until_ = len(stream17e) if pipe.ingress else None
        sent_ = 0
        kbuild.reset_launches()
        # the cyclic GC's passes inside the window, (generation, seconds)
        # each: the clocked build froze the heap, so none should scan it
        gc_pauses, gc_t0 = [], [0.0]

        def on_gc(phase_, info_):
            if phase_ == "start":
                gc_t0[0] = time.perf_counter()
            elif in_window is None:
                gc_pauses.append((info_["generation"], time.perf_counter() - gc_t0[0]))

        t0 = time.perf_counter()
        b_ = pipe.benchg
        in_window = None
        window_s = None
        gc.callbacks.append(on_gc)
        try:
            while not (pipe.poh.window_closed and pipe.front_done(until_)):
                if tx_ is not None:
                    sent_ = send_paced(tx_, b_, stream17e, sent_, INGRESS_AHEAD)
                pipe._step(pipe.stages)
                if in_window is None and pipe.poh.window_closed:
                    window_s = time.perf_counter() - t0
                    in_window = sum(b.metrics.get("txn_exec") for b in pipe.banks)
                if time.perf_counter() - t0 >= CLOCK_WALL_S:
                    fed_ = (f"{b_.metrics.get('pkt_rx')} of {sent_} sent datagrams taken"
                            if tx_ is not None else f"{b_._i} of {b_.limit} sent")
                    check(False, f"{tag}: window closed {pipe.poh.window_closed}, {fed_}"
                          f" after {CLOCK_WALL_S} s")
        finally:
            gc.callbacks.remove(on_gc)
            if tx_ is not None:
                tx_.close()
        frozen = gc.get_freeze_count()
        pipe.finish()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        pipe.close()
        if tx_ is not None:
            check(pipe.benchg.sock.fileno() == -1, f"{tag}: close() left the socket open")
        gone = [l_.name for l_ in pipe.links if os.path.exists(f"/dev/shm/{l_.name}")]
        check(not gone, f"{tag}: close() left /dev/shm entries {gone}")
        log(f"[{tag}-gc] collections in the window by generation"
            f" {[sum(g_ == k_ for g_, _ in gc_pauses) for k_ in range(3)]}, longest"
            f" {1e3 * max([d_ for _, d_ in gc_pauses] or [0.0]):.3f} ms, all"
            f" {1e3 * sum(d_ for _, d_ in gc_pauses):.3f} ms; {frozen} objects frozen by the"
            f" clocked build, {gc.get_freeze_count()} after close(); the build's full pass"
            f" before the anchor {1e3 * pipe.heap_hold.collect_s:.3f} ms")
        if tx_ is not None:
            check(sent_ == len(stream17e), f"{tag}: {sent_} of {len(stream17e)} datagrams sent")
        return run_s, window_s, in_window

    # [funk-lanes]' committed-state key set, the same on every lane: the
    # pool's payers and destinations, the nonce accounts and their authorities
    keys17e = sorted({pub for _, pub in pool_payers(b"benchg", 8)}
                     | {hashlib.sha256(b"benchg" + b"to%d" % i).digest() for i in range(LEADER_DESTS)}
                     | {a_ for _, _, a_, _ in nkeys17e} | {pub for _, pub, _, _ in nkeys17e})

    def clock_leader(tag: str, native_exec: bool = True, funk=None, phases: bool = False,
                     **kw) -> dict:
        """One clocked leader run over stream17e: drive the window (and the
        rest of the stream) under the wall cap, drain, seal, replay; check
        the slot accounting, the launches, the replay and the banks' native
        funk plane; log [tag].  native_exec picks the bank's executor lane,
        funk the store (default the shm map; Funk() for the dict store);
        with phases, the swept stages' metrics planes are read too.
        udp_ingress=True puts the socket front there: stream17e goes over
        loopback (drive_window), and every datagram must be taken whole."""
        ctx = nonce_bank_ctx(CLOCK_DURABLE, device=dev, native_exec=native_exec, funk=funk)
        ingress = kw.get("udp_ingress", False)
        pipe = build_leader_pipeline([] if ingress else stream17e, device=dev, batch=B1,
                                     max_msg_len=ML1, n_bank=2, bank_ctx=ctx, keep_entries=True,
                                     pack_depth=len(stream17e), slot_clock=clock17e,
                                     keep_sets=False, **kw)
        lanes = native_lanes(pipe)
        run_s, window_s, in_window = drive_window(pipe, tag)
        t0 = time.perf_counter()
        seal = pipe.seal()
        seal_s = time.perf_counter() - t0
        launches = dict(kbuild.LAUNCHES)
        rep = pipe.report()
        if ingress:
            net_m = rep["net"]
            check(net_m.get("pkt_rx") == len(stream17e) and net_m.get("oversize_drop", 0) == 0,
                  f"{tag}: the net stage took {net_m} of the {len(stream17e)} datagrams sent")
        poh_m, pack_m = pipe.poh.metrics, pipe.pack.metrics
        sealed_, missed_ = poh_m.get("slots_sealed"), poh_m.get("slot_missed")
        check(sealed_ + missed_ == CLOCK_SLOTS and sealed_ >= 1,
              f"{tag}: {sealed_} slots sealed + {missed_} missed != {CLOCK_SLOTS}")
        check(poh_m.get("ticks") + poh_m.get("slot_skipped_ticks") == CLOCK_TICKS * CLOCK_SLOTS,
              f"{tag}: ticks {poh_m.get('ticks')} + skipped {poh_m.get('slot_skipped_ticks')}")
        closed = pack_m.get("blocks_closed")
        check(1 <= closed <= CLOCK_SLOTS, f"{tag}: blocks_closed {closed}")
        landed = sum(b.metrics.get("txn_exec") for b in pipe.banks)
        verified = pipe.dedup_counts()[0]
        shed = pack_m.get("txn_shed")
        check(pack_m.get("txn_dropped") == 0 and landed + shed == verified == len(stream17e),
              f"{tag}: landed {landed} + shed {shed} != verified {verified} of {len(stream17e)},"
              f" dropped {pack_m.get('txn_dropped')}")
        ents = [parse_entry(x) for x in deshred_entry_batch(pipe.store.entry_batch_bytes(1))]
        check(ents == [(n_, bytes(h_), list(t_)) for n_, h_, t_ in pipe.poh.entries],
              f"{tag}: deshredded store bytes != PoH's entries")
        block = [p_ for _, _, txs in ents for p_ in txs]
        fund = nonce_bank_ctx(CLOCK_DURABLE, device=dev)
        t0 = time.perf_counter()
        rp = replay_block(fund.funk, slot=1, entries=ents, poh_seed=b"\x00" * 32,
                          status_cache=fund.status_cache, device=dev)
        replay_s = time.perf_counter() - t0
        check(rp is not None and rp.bank_hash == seal.bank_hash
              and np.array_equal(rp.accounts_delta, seal.accounts_delta)
              and rp.signature_cnt == seal.signature_cnt
              and sorted(r.status for r in rp.results)
              == sorted(r.status for r in seal.results if r.fee > 0),
              f"{tag}: replay_block does not reproduce the seal")
        durable_ok = sum(p_ in durable_set17e and r_.status == 0
                         for p_, r_ in zip(block, rp.results))
        landed_durable = {p_ for p_ in block if p_ in durable_set17e}
        sx = pipe.bank_ctx.sx
        nonces = [fnonce.decode_state(acct_decode(sx.funk.rec_query(sx.xid, a_))[3])[2]
                  for _, _, a_, _ in nkeys17e]
        advanced = [p_ in landed_durable for p_ in durable17e]
        check(all(n_ == (fnonce.next_nonce(bytes(32), a_) if adv else st_)
                  for n_, adv, (_, _, a_, st_) in zip(nonces, advanced, nkeys17e)),
              f"{tag}: a nonce account neither advanced with its landed txn nor kept its nonce")
        check(durable_ok == len(landed_durable), f"{tag}: {durable_ok} durable txns ok of"
              f" {len(landed_durable)} landed")
        nb = pipe.shred.metrics.get("entry_batches")
        check(launches.get("verify_batch", 0) == rep["verify0"]["batches"] > 0,
              f"{tag}: K1 launches {launches} != batches {rep['verify0']['batches']}")
        check(nb <= launches.get("gf256_apply", 0) <= 2 * nb,
              f"{tag}: K5 launches {launches.get('gf256_apply', 0)} for {nb} entry batches")
        check(launches.get("lthash_combine", 0) == 1, f"{tag}: K13 launches {launches}")
        log(f"[{tag}-lanes] " + check_native_lanes(tag, pipe, lanes, launches,
                                                   sweep=kw.get("native_ring", True)))
        shm_store = hasattr(ctx.funk, "txn_diff")
        funk_text = funk_plane(tag, rep, pipe.banks, armed=shm_store and native_exec
                               and kw.get("native_ring", True))
        state = hashlib.sha256(b"".join(k_ + (sx.funk.rec_query(sx.xid, k_) or b"\xff")
                                        for k_ in keys17e)).hexdigest()
        arena = ctx.funk.arena_used() if shm_store else None
        phase_rows = sweep_phases(tag, pipe, tune_quantile) if phases else None
        ctx.close()
        fund.close()
        lag = poh_m.hist("slot_seal_lag_ns")
        lag50, lag99 = (tune_quantile(lag, q) / 1e6 for q in (0.5, 0.99))
        split = dict(pipe.stage_s)
        log(f"[{tag}] {len(stream17e)} txns ({LEADER_TXNS} transfers, {CLOCK_DURABLE} durable)"
            f" at batch {B1}, 2 banks, {CLOCK_SLOTS} slots of {CLOCK_SLOT_MS:.0f} ms,"
            f" {CLOCK_TICKS} ticks a slot, {pipe.poh.hashes_per_tick} hashes a tick"
            f"{', ' + json.dumps(kw) if kw else ''}: slots sealed {sealed_}, missed {missed_},"
            f" skipped ticks {poh_m.get('slot_skipped_ticks')}; seal lag p50 {lag50:.3f} ms,"
            f" p99 {lag99:.3f} ms (upper bucket edges; grace {grace17e_ms:.0f} ms), counts"
            f" {lag['counts']}; blocks_closed {closed}; txn_shed {shed}; landed {landed}"
            f" ({in_window} in the window, {landed - in_window} in the drain; window closed at"
            f" {window_s:.3f} s); durable ok {durable_ok} of {CLOCK_DURABLE}; run {run_s:.3f} s ="
            f" {landed / run_s:.0f} txn/s to the store; seal {seal_s:.3f} s ({sx.seal_rows} rows,"
            f" bank hash {seal.bank_hash.hex()}); replay reproduces the seal in {replay_s:.3f} s;"
            f" launches {launches}")
        log(f"[{tag}-split] host seconds"
            f" {json.dumps({k: round(v, 4) for k, v in sorted(split.items())})}; {funk_text};"
            f" counters {json.dumps(rep)}")
        return dict(launches=launches, landed=landed, shed=shed, sigs=sorted(
            ft.txn_parse(p_).signatures(p_)[0] for p_ in block), advanced=sum(advanced),
            durable_ok=durable_ok, split=split, txn_s=landed / run_s, lag=(lag50, lag99),
            sealed=sealed_, missed=missed_, in_window=in_window,
            signature_cnt=seal.signature_cnt, native=native_counts(rep, pipe.banks),
            sweep={k: sum(rep[b.name].get(k, 0) for b in pipe.banks) for k in BANK_SWEEP_KEYS},
            bank_hash=seal.bank_hash, sweeps=pipe.sweeps,
            entries=deshred_entry_batch(pipe.store.entry_batch_bytes(1)),
            txn_exec={b.name: b.metrics.get("txn_exec") for b in pipe.banks}, state=state,
            seal_s=seal_s, seal_split=dict(sx.seal_s), arena=arena, phases=phase_rows,
            drain_s=sum(b.drain_s for b in pipe.banks), shm_store=shm_store)

    r17e = clock_leader("clock-leader", phases=True)
    check(r17e["shed"] == 0 and r17e["durable_ok"] == r17e["advanced"] == CLOCK_DURABLE,
          f"clock-leader: shed {r17e['shed']}, durable ok {r17e['durable_ok']} of {CLOCK_DURABLE}")
    launches17e = r17e["launches"]
    r17e_f = clock_leader("clock-leader-fused", fuse_poh_shred=True)
    check(r17e_f["shed"] == 0 and r17e_f["durable_ok"] == CLOCK_DURABLE
          and r17e_f["sigs"] == r17e["sigs"],
          "clock-leader-fused: landed signatures differ from the unfused run's")
    r17e_s = clock_leader("clock-leader-shed", shed_keep=CLOCK_SHED_KEEP)
    check(r17e_s["shed"] > 0, "clock-leader-shed: nothing shed")
    # (d) 17e (a) on the Python pack lane (dedup + PackStage), beside the
    # fused native lane every other leader phase takes
    r17e_py = clock_leader("clock-leader-python-pack", native_pack=False)
    check(r17e_py["shed"] == 0 and r17e_py["durable_ok"] == CLOCK_DURABLE
          and r17e_py["sigs"] == r17e["sigs"],
          "clock-leader-python-pack: landed signatures differ from the native lane's")
    pack_lanes = {lane: (r_["split"].get("dedup", 0.0) + r_["split"]["pack"], r_["txn_s"])
                  for lane, r_ in (("native", r17e), ("python", r17e_py))}
    log(f"[pack-lanes] 17e (a) in one call: native lane (pack with dedup fused in) pack"
        f" {pack_lanes['native'][0]:.4f} s host, {pack_lanes['native'][1]:.0f} txn/s to the"
        f" store; python lane dedup {r17e_py['split'].get('dedup', 0.0):.4f} s + pack"
        f" {r17e_py['split']['pack']:.4f} s = {pack_lanes['python'][0]:.4f} s host,"
        f" {pack_lanes['python'][1]:.0f} txn/s to the store")
    # (e) 17e (a) with the banks on the Python executor lane (native_exec=False)
    r17e_px = clock_leader("clock-leader-python-exec", native_exec=False)
    check(r17e_px["shed"] == 0 and r17e_px["durable_ok"] == CLOCK_DURABLE
          and r17e_px["sigs"] == r17e["sigs"]
          and r17e_px["signature_cnt"] == r17e["signature_cnt"],
          "clock-leader-python-exec: landed signatures differ from the native exec lane's")
    for tag_, r_ in (("clock-leader", r17e), ("clock-leader-python-exec", r17e_px)):
        check(r_["sealed"] == CLOCK_SLOTS, f"{tag_}: {r_['sealed']} of {CLOCK_SLOTS} slots sealed")
    check(r17e["native"][0] > 0, f"clock-leader: native_exec {r17e['native']}")
    check(r17e_px["native"] == (0, 0), f"clock-leader-python-exec: native {r17e_px['native']}")
    for lane_, r_ in (("native", r17e), ("python", r17e_px)):
        sp_ = r_["split"]
        log(f"[exec-lanes] 17e {'(a)' if lane_ == 'native' else '(e)'} {lane_} exec lane:"
            f" bank0 {sp_.get('bank0', 0.0):.4f} s, bank1 {sp_.get('bank1', 0.0):.4f} s,"
            f" verify {sp_.get('verify0', 0.0):.4f} s host; {r_['txn_s']:.0f} txn/s to the store;"
            f" slots sealed {r_['sealed']} of {CLOCK_SLOTS}; {r_['in_window']} txns in the window"
            f" of {r_['landed']} landed; {r_['signature_cnt']} signatures; native_exec"
            f" {r_['native'][0]}, native_punt {r_['native'][1]}")
    # (f) 17e (a) on the Python shm rings: no drain plan, no bank sweep lane
    r17e_pr = clock_leader("clock-leader-python-rings", native_ring=False)
    check(r17e_pr["shed"] == 0 and r17e_pr["durable_ok"] == CLOCK_DURABLE
          and r17e_pr["sigs"] == r17e["sigs"]
          and r17e_pr["signature_cnt"] == r17e["signature_cnt"],
          "clock-leader-python-rings: landed signatures differ from the native rings'")
    check(r17e["sweep"]["bank_txn_native"] > 0 and r17e["sweep"]["bank_mb_dropped"] == 0,
          f"clock-leader: the banks' sweep lane committed nothing in the crossing {r17e['sweep']}")
    check(r17e["sweep"]["bank_mb_resumed"] == r17e["sweep"]["bank_mb_stashed"],
          f"clock-leader: stashed microblocks not all resumed {r17e['sweep']}")
    check(not any(r17e_pr["sweep"].values()), f"clock-leader-python-rings: {r17e_pr['sweep']}")
    for lane_, r_ in (("native", r17e), ("python", r17e_pr)):
        sp_ = r_["split"]
        log(f"[ring-lanes] 17e {'(a)' if lane_ == 'native' else '(f)'} {lane_} rings:"
            f" bank0 {sp_.get('bank0', 0.0):.4f} s, bank1 {sp_.get('bank1', 0.0):.4f} s,"
            f" verify {sp_.get('verify0', 0.0):.4f} s, pack {sp_.get('pack', 0.0):.4f} s,"
            f" poh {sp_.get('poh', 0.0):.4f} s host; {r_['txn_s']:.0f} txn/s to the store;"
            f" slots sealed {r_['sealed']}, missed {r_['missed']}; {r_['in_window']} txns in"
            f" the window of {r_['landed']} landed; bank sweep: txns committed in the crossing"
            f" {r_['sweep']['bank_txn_native']}, microblocks all native"
            f" {r_['sweep']['bank_mb_native']}, stashed {r_['sweep']['bank_mb_stashed']}"
            f" (credit waits {r_['sweep']['bank_credit_waits']}), resumed"
            f" {r_['sweep']['bank_mb_resumed']}; {r_['sweeps']} sweeps; bank hash"
            f" {r_['bank_hash'].hex()[:16]} equals its replay's")
    # (g) 17e (a) on the dict store (BankCtx(funk=Funk())): every record
    # through the banks' result log, the seal's rows by the _before walk
    r17e_df = clock_leader("clock-leader-dict-funk", funk=Funk())
    for lane_, r_ in (("shm", r17e), ("dict", r17e_df)):
        check(r_["sealed"] == CLOCK_SLOTS,
              f"funk-lanes: the {lane_} store sealed {r_['sealed']} of {CLOCK_SLOTS} slots")
    check(r17e["shm_store"] and not r17e_df["shm_store"], "funk-lanes: the stores are not the lanes'")
    # both lanes landed the whole stream: then their results must agree;
    # a lane that landed fewer is held to its own replay only (clock_leader)
    all17e = all(r_["landed"] == len(stream17e) for r_ in (r17e, r17e_df))
    if all17e:
        check(sum(r17e["txn_exec"].values()) == sum(r17e_df["txn_exec"].values()),
              f"funk-lanes: txn_exec {r17e['txn_exec']} != {r17e_df['txn_exec']}")
        check(r17e["state"] == r17e_df["state"],
              "funk-lanes: the committed state over the payers, destinations and nonce accounts"
              " differs")
    for lane_, r_ in (("shm", r17e), ("dict", r17e_df)):
        sp_ = r_["split"]
        log(f"[funk-lanes] 17e {'(a)' if lane_ == 'shm' else '(g)'} {lane_} store: bank0"
            f" {sp_.get('bank0', 0.0):.4f} s, bank1 {sp_.get('bank1', 0.0):.4f} s host, of which"
            f" the result log's drain {r_['drain_s']:.4f} s; seal {r_['seal_s']:.4f} s, its"
            f" read-out ({'one txn_diff crossing' if lane_ == 'shm' else 'the _before walk'})"
            f" {1e3 * r_['seal_split']['read']:.3f} ms, XOFs {r_['seal_split']['xof']:.4f} s, K13"
            f" and hash {1e3 * r_['seal_split']['combine']:.3f} ms; {r_['txn_s']:.0f} txn/s to"
            f" the store; slots sealed {r_['sealed']} of {CLOCK_SLOTS}; landed {r_['landed']};"
            f" txn_exec {sum(r_['txn_exec'].values())}; bank_funk_writes"
            f" {r_['sweep']['bank_funk_writes']}, falls {r_['sweep']['bank_funk_falls']};"
            f" arena_used {r_['arena'] if r_['arena'] is not None else '-'} bytes; committed"
            f" state sha256 {r_['state'][:16]} over {len(keys17e)} keys"
            f" ({'equal on both lanes' if all17e else 'not compared: a lane landed fewer than'}"
            f"{'' if all17e else f' {len(stream17e)}'}); bank hash"
            f" {r_['bank_hash'].hex()[:16]} equals its replay's")
    for st_, row_ in r17e["phases"].items():
        cells_ = ", ".join(f"{nm} n {row_[nm][0]} p50 {row_[nm][1]:.0f} p99 {row_[nm][2]:.0f}"
                           f" sum {row_[nm][3] / 1e6:.3f} ms"
                           f" ({row_[nm][3] / max(row_[nm][0], 1):.0f} ns an observation)"
                           for nm in ("drain", "callback", "apply", "publish", "lat"))
        log(f"[sweep-phases] 17e (a) {st_}: crossings {row_['crossings']}, frags {row_['frags']}"
            f" (= the frags its sweeps returned; flush left the native words as C wrote them);"
            f" ns, p50/p99 at upper bucket edges, sums exact: {cells_}")
    # the ring lanes alone over 17e's packets: a frag's publish and poll
    # on the Python lane against fdr_publish_burst and fdr_drain in bursts
    # of a stage sweep's 16 frags
    rings_us = {}
    for lane_ in ("python", "native"):
        rl_ = tshm.ShmLink.create(f"fdtpu_torch_rings_{tshm.fresh_uid()}",
                                  depth=RINGS_DEPTH, mtu=1232)
        try:
            prod_ = tshm.make_producer(rl_, native=lane_ == "native")
            cons_ = tshm.make_consumer(rl_, native=lane_ == "native")
            items_ = [(p_, i_, 1 + i_) for i_, p_ in enumerate(stream17e)]
            got_ = []
            t0 = time.perf_counter()
            if lane_ == "native":
                for o_ in range(0, len(items_), RINGS_BURST):
                    check(prod_.publish_burst(items_[o_:o_ + RINGS_BURST])
                          == len(items_[o_:o_ + RINGS_BURST]), "rings: publish_burst short")
            else:
                for p_, sig_, ts_ in items_:
                    check(prod_.try_publish(p_, sig=sig_, tsorig=ts_), "rings: publish refused")
            pub_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            if lane_ == "native":
                dr_ = tnat.BurstDrainer([cons_], RINGS_BURST)
                rr_ = 0
                while True:
                    n_, rr_, _ = dr_.drain(rr_, RINGS_BURST)
                    if not n_:
                        break
                    rows_ = dr_.meta[:n_].tolist()
                    buf_ = dr_.arena[: rows_[-1][2] + rows_[-1][3]].tobytes()
                    got_ += [buf_[r_[2]:r_[2] + r_[3]] for r_ in rows_]
                del dr_
            else:
                while isinstance(res_ := cons_.poll(), tuple):
                    got_.append(res_[1])
            poll_s = time.perf_counter() - t0
            check(got_ == stream17e, f"rings: the {lane_} lane's payloads differ from the stream")
            rings_us[lane_] = (pub_s * 1e6 / len(items_), poll_s * 1e6 / len(items_))
            del prod_, cons_
        finally:
            rl_.close()
            rl_.unlink()
    log(f"[rings] {len(stream17e)} packets of 17e through one link (depth {RINGS_DEPTH}, mtu"
        f" 1,232), payloads equal on both lanes: python publish {rings_us['python'][0]:.3f} us"
        f" a frag, fdr_publish_burst {rings_us['native'][0]:.3f} us a frag (bursts of"
        f" {RINGS_BURST}); python poll {rings_us['python'][1]:.3f} us a frag, fdr_drain"
        f" {rings_us['native'][1]:.3f} us a frag (bursts of {RINGS_BURST}, the payload copy"
        f" out of the arena included); host clock, one pass each")
    # the verify stage's per-packet parse over 17e's packets: the native
    # parser it runs against the Python parse and pack it replaced
    t0 = time.perf_counter()
    nat_desc = [ftn.txn_parse_packed(p_) for p_ in stream17e]
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_txns = [ft.txn_parse(p_) for p_ in stream17e]
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py_desc = [ft.txn_pack(t_) for t_ in py_txns]
    pack_s = time.perf_counter() - t0
    check(nat_desc == py_desc and all(d_ is not None for d_ in nat_desc),
          f"parser: {sum(a_ != b_ for a_, b_ in zip(nat_desc, py_desc))} native descriptors"
          f" differ from txn_pack(txn_parse(p)) over {len(stream17e)} packets")
    per_ = 1e6 / len(stream17e)
    log(f"[parser] {len(stream17e)} packets of 17e, every descriptor equal: native"
        f" txn_parse_packed {nat_s * per_:.3f} us a packet; python txn_parse"
        f" {parse_s * per_:.3f} us + txn_pack {pack_s * per_:.3f} us ="
        f" {(parse_s + pack_s) * per_:.3f} us a packet (host clock, one pass each)")

    # the shred stage's lanes over 17e (a)'s entries: the Python Shredder and
    # NativeShredder over the entry batches the stage closed (16,384 bytes,
    # the last at the slot-end flush), and a ShredStage's sweep client over
    # the rings; every shred byte equal to the plain version's, NativeShredder
    # on the CPU (its parity pointer a trampoline into the plain gf_apply_batch)
    secret_ = hashlib.sha256(b"leader").digest()
    ents_ = r17e["entries"]
    batches_, buf_ = [], bytearray()
    for e_ in ents_:
        buf_ += len(e_).to_bytes(4, "little") + e_
        if len(buf_) >= SHRED_TARGET:
            batches_.append(bytes(buf_))
            buf_ = bytearray()
    if buf_:
        batches_.append(bytes(buf_))
    def fec_shreds(sh_) -> tuple[list[bytes], int]:
        sets_ = [st_ for i_, b_ in enumerate(batches_) for st_ in sh_.entry_batch_to_fec_sets(
            b_, slot=1, meta=EntryBatchMeta(block_complete=i_ == len(batches_) - 1))]
        return [x_ for st_ in sets_ for x_ in st_.data_shreds + st_.parity_shreds], len(sets_)

    plain_shreds, plain_sets = fec_shreds(NativeShredder(secret=secret_, shred_version=1,
                                                         device="cpu"))
    shred_lanes = {}
    for lane_, sh_ in (("python", Shredder(signer=lambda r_: ref.sign(secret_, r_),
                                           shred_version=1, device=dev)),
                       ("native", NativeShredder(secret=secret_, shred_version=1, device=dev))):
        kbuild.reset_launches()
        t0 = time.perf_counter()
        shreds_, n_sets_ = fec_shreds(sh_)
        torch.cuda.synchronize()
        dt_ = time.perf_counter() - t0
        shred_lanes[lane_] = (shreds_, n_sets_, dt_, kbuild.LAUNCHES["gf256_apply"])
    # the native lane's parity call alone at the leader's (27 x 19, 1,019)
    # set: K5's host entry (copy in, one launch, copy out, stream sync)
    # against the plain version's bytes (ops/reedsol.encode on the CPU),
    # timed a call on the host clock
    par_ = sh_._ctx.parity
    enc_ = ENCODE_FN(par_.fn.value)
    rows_ = np.random.default_rng(23).integers(0, 256, (19, 1019), dtype=np.uint8)
    gen_ = rs.parity_matrix(19, 27).tobytes()
    out_ = (ctypes.c_uint8 * (27 * 1019))()
    check(enc_(par_.user, gen_, rows_.tobytes(), 19, 27, 1019, out_) == 0,
          "shred-lanes: K5's host entry failed")
    check(np.array_equal(np.frombuffer(out_, np.uint8).reshape(27, 1019),
                         rs.encode(rows_[None], 27, device="cpu")[0].numpy()),
          "shred-lanes: K5's host entry differs from the plain reedsol.encode")
    t0 = time.perf_counter()
    for _ in range(HOST_ENTRY_CALLS):
        enc_(par_.user, gen_, rows_.tobytes(), 19, 27, 1019, out_)
    host_entry_us = (time.perf_counter() - t0) * 1e6 / HOST_ENTRY_CALLS
    uid_ = tshm.fresh_uid()
    sl_in = tshm.ShmLink.create(f"fdtpu_torch_shl_i_{uid_}", depth=1024,
                                mtu=max(len(e_) for e_ in ents_))
    sl_out = tshm.ShmLink.create(f"fdtpu_torch_shl_o_{uid_}", depth=4096, mtu=1232)
    try:
        prod_ = tshm.make_producer(sl_in)
        cons_ = tshm.make_consumer(sl_out, lazy=0)
        st_ = ShredStage("shred", [tshm.make_consumer(sl_in, lazy=8)], [tshm.make_producer(sl_out)],
                         signer=None, secret=secret_, slot=1, batch_target_sz=SHRED_TARGET,
                         device=dev)
        check(st_._sweep_client is not None, "shred-lanes: the stage did not arm its client")
        items_ = [(e_, i_, 1) for i_, e_ in enumerate(ents_)]
        dr_ = tnat.BurstDrainer([cons_], LANES_BURST)
        got_, fed_ = [], 0
        kbuild.reset_launches()
        t0 = time.perf_counter()
        while fed_ < len(items_) or st_.ins[0].has_pending():
            fed_ += prod_.publish_burst(items_[fed_:fed_ + LANES_BURST])
            st_.run_once()
            got_ += drain_all(dr_)
        st_.flush(block_complete=True)
        got_ += drain_all(dr_)
        torch.cuda.synchronize()
        dt_ = time.perf_counter() - t0
        shred_lanes["client"] = (got_, st_.metrics.get("fec_sets"), dt_,
                                 kbuild.LAUNCHES["gf256_apply"])
        st_.ins, st_.outs = [], []
        st_.drop_native_views()
        del prod_, cons_, st_, dr_
        gc.collect()
    finally:
        for l_ in (sl_in, sl_out):
            l_.close()
            l_.unlink()
    for lane_, (sh_, n_, _, _) in shred_lanes.items():
        check(sh_ == plain_shreds and n_ == plain_sets,
              f"shred-lanes: the {lane_} lane's {len(sh_)} shreds differ from the plain"
              f" version's {len(plain_shreds)} (NativeShredder on the CPU)")
    log(f"[shred-lanes] 17e (a)'s {len(ents_)} entries in {len(batches_)} entry batches,"
        f" {plain_sets} FEC sets, {len(plain_shreds)} shreds, every byte of the three lanes"
        f" equal to the plain version's (NativeShredder on the CPU, parity through the plain"
        f" gf_apply_batch): " + "; ".join(
            f"{lane_} {1e6 * dt_ / n_:.1f} us a set, K5 {k5_} launches"
            for lane_, (_, n_, dt_, k5_) in shred_lanes.items())
        + " (host clock, one pass each; python: the Python Shredder, K5 through"
        " gf_apply_batch a same-shape group; native: NativeShredder, K5 from C a set; client:"
        " a ShredStage's sweep client inside fdr_sweep over the rings, fed by"
        " fdr_publish_burst and drained by fdr_drain); K5's host entry alone at (27 x 19,"
        f" 1,019), its bytes the plain reedsol.encode's: {host_entry_us:.1f} us a call (copy in, launch,"
        f" copy out, sync; {HOST_ENTRY_CALLS} calls)")
    # the verify stage's intake lanes over 17e's packets: the sweep client,
    # the drain-table intake (native rings) and the per-frag intake (Python
    # rings); the frames equal
    verify_lanes = {}
    for lane_ in ("client", "drain", "python"):
        uid_ = tshm.fresh_uid()
        nat_ = lane_ != "python"
        vl_in = tshm.ShmLink.create(f"fdtpu_torch_vl_i_{uid_}", depth=LANES_DEPTH, mtu=1232)
        vl_out = tshm.ShmLink.create(f"fdtpu_torch_vl_o_{uid_}", depth=LANES_DEPTH, mtu=4096)
        try:
            prod_ = tshm.make_producer(vl_in, native=nat_)
            cons_ = tshm.make_consumer(vl_out, lazy=0)
            dr_ = tnat.BurstDrainer([cons_], LANES_BURST)
            st_ = VerifyStage("verify", [tshm.make_consumer(vl_in, lazy=32, native=nat_)],
                              [tshm.make_producer(vl_out, native=nat_)], device=dev,
                              batch=B1, max_msg_len=ML1,
                              native_client=None if lane_ == "client" else False)
            check((st_._sweep_client is not None) == (lane_ == "client"),
                  f"verify-lanes: {lane_} lane's client")
            for i_, p_ in enumerate(stream17e):
                check(prod_.try_publish(p_, sig=i_, tsorig=1 + i_), "verify-lanes: publish")
            got_ = []
            kbuild.reset_launches()
            t0 = time.perf_counter()
            while len(got_) < len(stream17e):
                st_.run_once()
                got_ += drain_all(dr_, meta=True)
                if not st_.busy() and not st_.ins[0].has_pending() and len(got_) < len(stream17e):
                    st_.flush()
                check(time.perf_counter() - t0 < 60, f"verify-lanes: {lane_} lane stalled")
            torch.cuda.synchronize()
            dt_ = time.perf_counter() - t0
            verify_lanes[lane_] = (got_, st_.metrics.get("batches"), kbuild.LAUNCHES["verify_batch"],
                                   dt_)
            st_.ins, st_.outs = [], []
            st_.drop_native_views()
            del prod_, cons_, st_, dr_
            gc.collect()
        finally:
            for l_ in (vl_in, vl_out):
                l_.close()
                l_.unlink()
    for lane_, (got_, nb_, k1_, _) in verify_lanes.items():
        check(got_ == verify_lanes["client"][0] and nb_ == k1_ > 0,
              f"verify-lanes: the {lane_} lane's frames differ, or K1 {k1_} != batches {nb_}")
    check([t_ for _, _, t_ in verify_lanes["client"][0]] == list(range(1, len(stream17e) + 1)),
          "verify-lanes: frames missing or out of order")
    log(f"[verify-lanes] 17e's {len(stream17e)} packets through one verify stage at batch {B1},"
        f" every verified frame equal on the three lanes: " + "; ".join(
            f"{lane_} {nb_} batches, K1 {k1_} launches, {1e6 * dt_ / len(stream17e):.3f} us a txn"
            for lane_, (_, nb_, k1_, dt_) in verify_lanes.items())
        + " (host clock from the first sweep to the last frame out, drained by fdr_drain;"
        " client: the sweep client over native rings; drain: the drain-table intake over"
        " native rings; python: the per-frag intake over Python rings)")

    # -- 17f. the program leader: v0 lookups, stake, config and the precompiles ----------------
    mark("17f")
    # who sends it: wallets and routers whose v0 txns load their accounts
    # through lookup tables, beside plain transfers, stake managers
    # (delegations, withdrawals, splits), config writers, and bridges and
    # relayers whose txns carry ed25519 and secp256k1 precompile entries
    t0 = time.perf_counter()
    ps17f = program_stream(**PROGRAM_MIX)
    gen17f_s = time.perf_counter() - t0
    kinds17f = {k: ok + bad for k, (ok, bad) in ps17f.expect.items()}
    # the drain lands in the window's last block: the whole stream must fit
    # one block's cost, or pack holds the rest and the drain never ends
    cost17f = sum(compute_cost(p_, ft.txn_parse(p_)).total for p_ in ps17f.stream)
    check(cost17f <= MAX_COST_PER_BLOCK, f"program leader: the stream costs {cost17f} CU")
    clock17f = SlotClockCfg(slot_ms=CLOCK_SLOT_MS, slot0=ps17f.slot, ticks_per_slot=CLOCK_TICKS,
                            n_slots=CLOCK_SLOTS, miss_grace_frac=CLOCK_GRACE)
    pipe17f = build_leader_pipeline(ps17f.stream, device=dev, batch=B1, max_msg_len=ML1, n_bank=2,
                                    bank_ctx=program_bank_ctx(ps17f, device=dev), slot=ps17f.slot,
                                    keep_entries=True, pack_depth=len(ps17f.stream),
                                    slot_clock=clock17f, keep_sets=False)
    lanes17f = native_lanes(pipe17f)
    run17f_s, window17f_s, in_window17f = drive_window(pipe17f, "program-leader")
    t0 = time.perf_counter()
    seal17f = pipe17f.seal()
    seal17f_s = time.perf_counter() - t0
    launches17f = dict(kbuild.LAUNCHES)
    log(f"[program-leader-lanes] " + check_native_lanes("program-leader", pipe17f, lanes17f, launches17f,
                                                sweep=True))
    rep17f = pipe17f.report()
    poh17f, pack17f = pipe17f.poh.metrics, pipe17f.pack.metrics
    sealed17f, missed17f = poh17f.get("slots_sealed"), poh17f.get("slot_missed")
    check(sealed17f + missed17f == CLOCK_SLOTS and sealed17f >= 1,
          f"program leader: {sealed17f} slots sealed + {missed17f} missed != {CLOCK_SLOTS}")
    landed17f = sum(b.metrics.get("txn_exec") for b in pipe17f.banks)
    rejected17f = sum(b.metrics.get("txn_rejected") for b in pipe17f.banks)
    verified17f = pipe17f.dedup_counts()[0]
    # every verified txn executed: landed, or a lookup that failed typed (no
    # fee, so never recorded)
    check(pack17f.get("txn_dropped") == pack17f.get("txn_shed") == 0
          and landed17f + rejected17f == verified17f == len(ps17f.stream)
          and rejected17f == ps17f.expect["lookup"][1],
          f"program leader: landed {landed17f} + rejected {rejected17f} != verified"
          f" {verified17f} of {len(ps17f.stream)}, dropped {pack17f.get('txn_dropped')}, shed"
          f" {pack17f.get('txn_shed')}")
    ents17f = [parse_entry(x) for x in
               deshred_entry_batch(pipe17f.store.entry_batch_bytes(ps17f.slot))]
    check(ents17f == [(n_, bytes(h_), list(t_)) for n_, h_, t_ in pipe17f.poh.entries],
          "program leader: deshredded store bytes != PoH's entries")
    block17f = [p_ for _, _, txs in ents17f for p_ in txs]
    fund17f = program_bank_ctx(ps17f, device=dev)
    t0 = time.perf_counter()
    rp17f = replay_block(fund17f.funk, slot=ps17f.slot, entries=ents17f, poh_seed=b"\x00" * 32,
                         status_cache=fund17f.status_cache, device=dev)
    replay17f_s = time.perf_counter() - t0
    check(rp17f is not None and rp17f.bank_hash == seal17f.bank_hash
          and np.array_equal(rp17f.accounts_delta, seal17f.accounts_delta)
          and rp17f.signature_cnt == seal17f.signature_cnt
          and sorted(r.status for r in rp17f.results)
          == sorted(r.status for r in seal17f.results if r.fee > 0),
          "program leader: replay_block does not reproduce the seal and its statuses")
    # every status class: each kind's ok and failed counts as built; the
    # lookups that fail are TXN_ERR_ACCT with no fee
    got17f = {}
    for p_, r_ in zip(block17f, rp17f.results):
        check(p_ in ps17f.race or (r_.status == 0) == (p_ not in ps17f.bad),
              f"program leader: a {ps17f.kind[p_]} txn got status {r_.status}")
        ok_, bad_ = got17f.get(ps17f.kind[p_], (0, 0))
        got17f[ps17f.kind[p_]] = (ok_ + (r_.status == 0), bad_ + (r_.status != 0))
    got17f["lookup"] = (0, sum(r_.fee == 0 and r_.status == -3 for r_ in seal17f.results))
    check(got17f == ps17f.expect, f"program leader: ok/failed by kind {got17f} != {ps17f.expect}")
    check(all(ok_ and bad_ for k_, (ok_, bad_) in got17f.items()
              if k_ in ("stake", "config", "ed25519", "secp256k1"))
          and all(got17f[k_][0] for k_ in ("v0", "legacy", "alt")) and got17f["lookup"][1],
          f"program leader: a status class never occurred: {got17f}")
    # each loaded destination holds the transfers to it that landed ok
    sx17f = pipe17f.bank_ctx.sx
    want17f = {}
    for p_, r_ in zip(block17f, rp17f.results):
        if p_ in ps17f.credit and r_.status == 0:
            d_, lam_ = ps17f.credit[p_]
            want17f[d_] = want17f.get(d_, 0) + lam_
    check(len(want17f) == PROGRAM_MIX["n_tables"] * PROGRAM_MIX["table_len"]
          and all(acct_decode(sx17f.funk.rec_query(sx17f.xid, d_))[0] == v_
                  for d_, v_ in want17f.items()),
          "program leader: a destination's lamports != the transfers to it that landed ok")
    # the lookup table program's txns, by the state they left
    for p_ in block17f:
        if ps17f.kind[p_] != "alt":
            continue
        d_ = ft.txn_parse(p_)
        ins_ = d_.instrs[0]
        tag_ = int.from_bytes(p_[ins_.data_off : ins_.data_off + 4], "little")
        table_ = d_.acct_addrs(p_)[1]
        lam_, owner_, _, data_ = acct_decode(sx17f.funk.rec_query(sx17f.xid, table_))
        st_ = falt.TableState.decode(data_)
        check(owner_ == falt.ALT_PROGRAM and {
            0: st_.authority == d_.acct_addrs(p_)[0] and not st_.addresses,
            1: st_.authority is None and len(st_.addresses) == 2,
            2: len(st_.addresses) == 4 and st_.last_extended_slot == ps17f.slot,
            3: st_.deactivation_slot == ps17f.slot}[tag_],
            f"program leader: lookup table instruction {tag_} left {st_}")
    nb17f = pipe17f.shred.metrics.get("entry_batches")
    check(launches17f.get("verify_batch", 0) == rep17f["verify0"]["batches"] > 0,
          f"program leader: K1 launches {launches17f} != batches {rep17f['verify0']['batches']}")
    check(nb17f <= launches17f.get("gf256_apply", 0) <= 2 * nb17f,
          f"program leader: K5 launches {launches17f.get('gf256_apply', 0)} for {nb17f} batches")
    check(launches17f.get("lthash_combine", 0) == 1, f"program leader: K13 launches {launches17f}")
    lag17f = poh17f.hist("slot_seal_lag_ns")
    lag17f50, lag17f99 = (tune_quantile(lag17f, q) / 1e6 for q in (0.5, 0.99))
    split17f = dict(pipe17f.stage_s)
    log(f"[program-leader] {len(ps17f.stream)} txns {json.dumps(kinds17f)} (made in"
        f" {gen17f_s:.3f} s) at batch {B1}, 2 banks, {CLOCK_SLOTS} slots of {CLOCK_SLOT_MS:.0f} ms,"
        f" {CLOCK_TICKS} ticks a slot, slot {ps17f.slot}: slots sealed {sealed17f}, missed"
        f" {missed17f}; seal lag p50 {lag17f50:.3f} ms, p99 {lag17f99:.3f} ms (upper bucket"
        f" edges); landed {landed17f} ({in_window17f} in the window, {landed17f - in_window17f}"
        f" in the drain; window closed at {window17f_s:.3f} s), lookups failed {rejected17f};"
        f" ok/failed by kind {json.dumps(got17f)}; run {run17f_s:.3f} s ="
        f" {landed17f / run17f_s:.0f} txn/s to the store (17e (a): {r17e['txn_s']:.0f}); seal"
        f" {seal17f_s:.3f} s ({sx17f.seal_rows} rows, bank hash {seal17f.bank_hash.hex()});"
        f" replay reproduces the seal in {replay17f_s:.3f} s; launches K1"
        f" {launches17f.get('verify_batch', 0)}, K5 {launches17f.get('gf256_apply', 0)}, K13"
        f" {launches17f.get('lthash_combine', 0)} ({launches17f})")
    log(f"[program-leader-split] host seconds"
        f" {json.dumps({k: round(v, 4) for k, v in sorted(split17f.items())})}; 17e (a) in this"
        f" call: {json.dumps({k: round(v, 4) for k, v in sorted(r17e['split'].items())})};"
        f" {funk_plane('program-leader', rep17f, pipe17f.banks)}; counters {json.dumps(rep17f)}")
    ne17f = native_counts(rep17f, pipe17f.banks)
    log(f"[native-exec] 17f: native_exec {ne17f[0]}, native_punt {ne17f[1]} ({landed17f} landed)")
    pipe17f.bank_ctx.close()  # the ctx this phase built and passed in
    fund17f.close()

    # -- 17g. the sBPF leader: on-chain programs under both BPF loaders, with CPI --------------
    mark("17g")
    # who sends it: Solana's non-vote traffic is mostly sBPF program calls
    # (token transfers, DEX swaps) that CPI into the system program: here
    # counters, hashers and PDA vaults paying out through the system program,
    # beside plain transfers, failing programs and a few program deployments
    t0 = time.perf_counter()
    ss17g = sbpf_stream(**SBPF_MIX)
    gen17g_s = time.perf_counter() - t0
    kinds17g = {k: ok + bad for k, (ok, bad) in ss17g.expect.items()}
    cost17g = sum(compute_cost(p_, ft.txn_parse(p_)).total for p_ in ss17g.stream)
    check(cost17g <= MAX_COST_PER_BLOCK, f"sbpf leader: the stream costs {cost17g} CU")
    clock17g = SlotClockCfg(slot_ms=CLOCK_SLOT_MS, slot0=ss17g.slot, ticks_per_slot=CLOCK_TICKS,
                            n_slots=CLOCK_SLOTS, miss_grace_frac=CLOCK_GRACE)
    pipe17g = build_leader_pipeline(ss17g.stream, device=dev, batch=B1, max_msg_len=ML1, n_bank=2,
                                    bank_ctx=sbpf_bank_ctx(ss17g, device=dev), slot=ss17g.slot,
                                    keep_entries=True, pack_depth=len(ss17g.stream),
                                    slot_clock=clock17g, keep_sets=False)
    lanes17g = native_lanes(pipe17g)
    run17g_s, window17g_s, in_window17g = drive_window(pipe17g, "sbpf-leader")
    t0 = time.perf_counter()
    seal17g = pipe17g.seal()
    seal17g_s = time.perf_counter() - t0
    launches17g = dict(kbuild.LAUNCHES)
    log(f"[sbpf-leader-lanes] " + check_native_lanes("sbpf-leader", pipe17g, lanes17g, launches17g,
                                                sweep=True))
    rep17g = pipe17g.report()
    poh17g, pack17g = pipe17g.poh.metrics, pipe17g.pack.metrics
    sealed17g, missed17g = poh17g.get("slots_sealed"), poh17g.get("slot_missed")
    check(sealed17g + missed17g == CLOCK_SLOTS and sealed17g >= 1,
          f"sbpf leader: {sealed17g} slots sealed + {missed17g} missed != {CLOCK_SLOTS}")
    landed17g = sum(b.metrics.get("txn_exec") for b in pipe17g.banks)
    rejected17g = sum(b.metrics.get("txn_rejected") for b in pipe17g.banks)
    verified17g = pipe17g.dedup_counts()[0]
    check(pack17g.get("txn_dropped") == pack17g.get("txn_shed") == rejected17g == 0
          and landed17g == verified17g == len(ss17g.stream),
          f"sbpf leader: landed {landed17g} + rejected {rejected17g} != verified {verified17g}"
          f" of {len(ss17g.stream)}, dropped {pack17g.get('txn_dropped')}, shed"
          f" {pack17g.get('txn_shed')}")
    ents17g = [parse_entry(x) for x in
               deshred_entry_batch(pipe17g.store.entry_batch_bytes(ss17g.slot))]
    check(ents17g == [(n_, bytes(h_), list(t_)) for n_, h_, t_ in pipe17g.poh.entries],
          "sbpf leader: deshredded store bytes != PoH's entries")
    block17g = [p_ for _, _, txs in ents17g for p_ in txs]
    fund17g = sbpf_bank_ctx(ss17g, device=dev)
    t0 = time.perf_counter()
    rp17g = replay_block(fund17g.funk, slot=ss17g.slot, entries=ents17g, poh_seed=b"\x00" * 32,
                         status_cache=fund17g.status_cache, device=dev)
    replay17g_s = time.perf_counter() - t0
    check(rp17g is not None and rp17g.bank_hash == seal17g.bank_hash
          and np.array_equal(rp17g.accounts_delta, seal17g.accounts_delta)
          and rp17g.signature_cnt == seal17g.signature_cnt
          and sorted((r.status, r.fee, r.cu) for r in rp17g.results)
          == sorted((r.status, r.fee, r.cu) for r in seal17g.results),
          "sbpf leader: replay_block does not reproduce the seal")
    # every txn's status as built, each class at least once
    got17g, sums17g, last17g, want17g, cu17g = {}, {}, {}, {}, 0
    for p_, r_ in zip(block17g, rp17g.results):
        k_ = ss17g.kind[p_]
        check((r_.status == 0) == (p_ not in ss17g.bad) and r_.fee > 0,
              f"sbpf leader: a {k_} txn got status {r_.status}, fee {r_.fee}")
        ok_, bad_ = got17g.get(k_, (0, 0))
        got17g[k_] = (ok_ + (r_.status == 0), bad_ + (r_.status != 0))
        cu17g += r_.cu if k_ not in ("legacy", "loader") else 0
        if r_.status != 0:
            continue
        if p_ in ss17g.counter_ops:
            c_, x_ = ss17g.counter_ops[p_]
            sums17g[c_] = sums17g.get(c_, 0) + x_
        if p_ in ss17g.hasher_ops:
            last17g[ss17g.hasher_ops[p_][0]] = ss17g.hasher_ops[p_][1]
        for a_, d_ in ss17g.credit.get(p_, ()):
            want17g[a_] = want17g.get(a_, 0) + d_
    check(got17g == ss17g.expect, f"sbpf leader: ok/failed by kind {got17g} != {ss17g.expect}")
    rust17g = sum(p_ in ss17g.rust for p_ in block17g)
    check(all(sum(v_) for v_ in got17g.values()) and len(got17g) == 10 and rust17g > 0,
          f"sbpf leader: a status class never occurred: {got17g}, rust ABI {rust17g}")
    sx17g = pipe17g.bank_ctx.sx

    def state17g(key):
        return acct_decode(sx17g.funk.rec_query(sx17g.xid, key))

    check(all(int.from_bytes(state17g(c_)[3], "little") == first_ + sums17g.get(c_, 0)
              for c_, first_ in ss17g.accounts["counters"].items()),
          "sbpf leader: a counter != its first value + the operands that landed ok")
    check(len(last17g) == SBPF_MIX["n_hashers"] and all(
        state17g(h_)[3] == hashlib.sha256(d_).digest() + fkk.keccak256_host(d_)
        + fb3.blake3_host(d_) for h_, d_ in last17g.items()),
        "sbpf leader: a hasher's bytes != the digests of its last ok invocation")
    vault0 = {v_: 10**12 for v_, _ in ss17g.accounts["vaults"]}
    check(all(state17g(a_)[0] == vault0.get(a_, 0) + d_ for a_, d_ in want17g.items()),
          "sbpf leader: a vault's or destination's lamports != the transfers that landed ok")
    check(all(state17g(k_) == v_ for k_, v_ in ss17g.loader_expect.items()),
          "sbpf leader: an upgradeable-loader account's bytes differ from the expected")
    nb17g = pipe17g.shred.metrics.get("entry_batches")
    check(launches17g.get("verify_batch", 0) == rep17g["verify0"]["batches"] > 0,
          f"sbpf leader: K1 launches {launches17g} != batches {rep17g['verify0']['batches']}")
    check(nb17g <= launches17g.get("gf256_apply", 0) <= 2 * nb17g,
          f"sbpf leader: K5 launches {launches17g.get('gf256_apply', 0)} for {nb17g} batches")
    check(launches17g.get("lthash_combine", 0) == 1, f"sbpf leader: K13 launches {launches17g}")
    lag17g = poh17g.hist("slot_seal_lag_ns")
    lag17g50, lag17g99 = (tune_quantile(lag17g, q) / 1e6 for q in (0.5, 0.99))
    split17g = dict(pipe17g.stage_s)
    log(f"[sbpf-leader] {len(ss17g.stream)} txns {json.dumps(kinds17g)} ({rust17g} vault txns"
        f" through the Rust ABI; made in {gen17g_s:.3f} s; pack cost {cost17g} CU) at batch {B1},"
        f" 2 banks, {CLOCK_SLOTS} slots of {CLOCK_SLOT_MS:.0f} ms, {CLOCK_TICKS} ticks a slot,"
        f" slot {ss17g.slot}: slots sealed {sealed17g}, missed {missed17g}; seal lag p50"
        f" {lag17g50:.3f} ms, p99 {lag17g99:.3f} ms (upper bucket edges); landed {landed17g}"
        f" ({in_window17g} in the window, {landed17g - in_window17g} in the drain; window closed"
        f" at {window17g_s:.3f} s); ok/failed by kind {json.dumps(got17g)}; sBPF txns consumed"
        f" {cu17g} CU; run {run17g_s:.3f} s = {landed17g / run17g_s:.0f} txn/s to the store"
        f" (17e (a): {r17e['txn_s']:.0f}); seal {seal17g_s:.3f} s ({sx17g.seal_rows} rows, bank"
        f" hash {seal17g.bank_hash.hex()}); replay reproduces the seal in {replay17g_s:.3f} s;"
        f" launches K1 {launches17g.get('verify_batch', 0)}, K5"
        f" {launches17g.get('gf256_apply', 0)}, K13 {launches17g.get('lthash_combine', 0)}"
        f" ({launches17g})")
    log(f"[sbpf-leader-split] host seconds"
        f" {json.dumps({k: round(v, 4) for k, v in sorted(split17g.items())})}; 17e (a) in this"
        f" call: {json.dumps({k: round(v, 4) for k, v in sorted(r17e['split'].items())})};"
        f" {funk_plane('sbpf-leader', rep17g, pipe17g.banks)}; counters {json.dumps(rep17g)}")
    ne17g = native_counts(rep17g, pipe17g.banks)
    log(f"[native-exec] 17g: native_exec {ne17g[0]}, native_punt {ne17g[1]} ({landed17g} landed)")
    pipe17g.bank_ctx.close()  # the ctx this phase built and passed in
    fund17g.close()

    # -- 17h. the zk leader: zk-elgamal proof traffic on the native pack lane -----------------
    mark("17h")
    # who sends it: wallets and token programs using Token-2022's confidential
    # transfers, which post these proofs, beside phase 17's transfers
    t0 = time.perf_counter()
    proofs17h = zk_proofs()
    prove17h_s = time.perf_counter() - t0
    zs17h = zk_stream(proofs=proofs17h, **ZK_MIX)
    gen17h_s = time.perf_counter() - t0 - prove17h_s
    kinds17h = {k: ok + bad for k, (ok, bad) in zs17h.expect.items()}
    cost17h = sum(compute_cost(p_, ft.txn_parse(p_)).total for p_ in zs17h.stream)
    check(cost17h <= MAX_COST_PER_BLOCK, f"zk leader: the stream costs {cost17h} CU")
    clock17h = SlotClockCfg(slot_ms=CLOCK_SLOT_MS, slot0=zs17h.slot, ticks_per_slot=CLOCK_TICKS,
                            n_slots=CLOCK_SLOTS, miss_grace_frac=CLOCK_GRACE)
    pipe17h = build_leader_pipeline(zs17h.stream, device=dev, batch=B1, max_msg_len=ML1, n_bank=2,
                                    bank_ctx=zk_bank_ctx(zs17h, device=dev), slot=zs17h.slot,
                                    keep_entries=True, pack_depth=len(zs17h.stream),
                                    slot_clock=clock17h, keep_sets=False)
    lanes17h = native_lanes(pipe17h)
    check(pipe17h.dedup is None, "zk leader: not on the fused native pack lane")
    run17h_s, window17h_s, in_window17h = drive_window(pipe17h, "zk-leader")
    t0 = time.perf_counter()
    seal17h = pipe17h.seal()
    seal17h_s = time.perf_counter() - t0
    launches17h = dict(kbuild.LAUNCHES)
    log(f"[zk-leader-lanes] " + check_native_lanes("zk-leader", pipe17h, lanes17h, launches17h,
                                                sweep=True))
    rep17h = pipe17h.report()
    poh17h, pack17h = pipe17h.poh.metrics, pipe17h.pack.metrics
    sealed17h, missed17h = poh17h.get("slots_sealed"), poh17h.get("slot_missed")
    check(sealed17h + missed17h == CLOCK_SLOTS and sealed17h >= 1,
          f"zk leader: {sealed17h} slots sealed + {missed17h} missed != {CLOCK_SLOTS}")
    landed17h = sum(b.metrics.get("txn_exec") for b in pipe17h.banks)
    rejected17h = sum(b.metrics.get("txn_rejected") for b in pipe17h.banks)
    verified17h = pipe17h.dedup_counts()[0]
    check(pack17h.get("txn_dropped") == pack17h.get("txn_shed") == rejected17h == 0
          and landed17h == verified17h == len(zs17h.stream),
          f"zk leader: landed {landed17h} + rejected {rejected17h} != verified {verified17h}"
          f" of {len(zs17h.stream)}, dropped {pack17h.get('txn_dropped')}, shed"
          f" {pack17h.get('txn_shed')}")
    ents17h = [parse_entry(x) for x in
               deshred_entry_batch(pipe17h.store.entry_batch_bytes(zs17h.slot))]
    check(ents17h == [(n_, bytes(h_), list(t_)) for n_, h_, t_ in pipe17h.poh.entries],
          "zk leader: deshredded store bytes != PoH's entries")
    block17h = [p_ for _, _, txs in ents17h for p_ in txs]
    fund17h = zk_bank_ctx(zs17h, device=dev)
    t0 = time.perf_counter()
    rp17h = replay_block(fund17h.funk, slot=zs17h.slot, entries=ents17h, poh_seed=b"\x00" * 32,
                         status_cache=fund17h.status_cache, device=dev)
    replay17h_s = time.perf_counter() - t0
    check(rp17h is not None and rp17h.bank_hash == seal17h.bank_hash
          and np.array_equal(rp17h.accounts_delta, seal17h.accounts_delta)
          and rp17h.signature_cnt == seal17h.signature_cnt
          and sorted((r.status, r.fee, r.cu) for r in rp17h.results)
          == sorted((r.status, r.fee, r.cu) for r in seal17h.results),
          "zk leader: replay_block does not reproduce the seal and every status, fee and CU")
    got17h = {}
    for p_, r_ in zip(block17h, rp17h.results):
        k_ = zs17h.kind[p_]
        check((r_.status == 0) == (p_ not in zs17h.bad) and r_.fee > 0,
              f"zk leader: a {k_} txn got status {r_.status}, fee {r_.fee}")
        ok_, bad_ = got17h.get(k_, (0, 0))
        got17h[k_] = (ok_ + (r_.status == 0), bad_ + (r_.status != 0))
    check(got17h == zs17h.expect, f"zk leader: ok/failed by kind {got17h} != {zs17h.expect}")
    sx17h = pipe17h.bank_ctx.sx
    check(all(acct_decode(sx17h.funk.rec_query(sx17h.xid, a_)) == v_
              for a_, v_ in zs17h.accounts_expect.items()),
          "zk leader: a context state or a close's destination is not as built")
    nb17h = pipe17h.shred.metrics.get("entry_batches")
    check(launches17h.get("verify_batch", 0) == rep17h["verify0"]["batches"] > 0,
          f"zk leader: K1 launches {launches17h} != batches {rep17h['verify0']['batches']}")
    check(nb17h <= launches17h.get("gf256_apply", 0) <= 2 * nb17h,
          f"zk leader: K5 launches {launches17h.get('gf256_apply', 0)} for {nb17h} batches")
    check(launches17h.get("lthash_combine", 0) == 1, f"zk leader: K13 launches {launches17h}")
    lag17h = poh17h.hist("slot_seal_lag_ns")
    lag17h50, lag17h99 = (tune_quantile(lag17h, q) / 1e6 for q in (0.5, 0.99))
    split17h = dict(pipe17h.stage_s)
    banks17h_s = sum(split17h.get(b.name, 0.0) for b in pipe17h.banks)
    log(f"[zk-leader] {len(zs17h.stream)} txns {json.dumps(kinds17h)} (proofs made in"
        f" {prove17h_s:.3f} s, the stream in {gen17h_s:.3f} s; pack cost {cost17h} CU) at batch"
        f" {B1}, 2 banks, {CLOCK_SLOTS} slots of {CLOCK_SLOT_MS:.0f} ms, {CLOCK_TICKS} ticks a"
        f" slot, slot {zs17h.slot}, the native pack lane: slots sealed {sealed17h}, missed"
        f" {missed17h}; seal lag p50 {lag17h50:.3f} ms, p99 {lag17h99:.3f} ms (upper bucket"
        f" edges); landed {landed17h} ({in_window17h} in the window, {landed17h - in_window17h}"
        f" in the drain; window closed at {window17h_s:.3f} s); ok/failed by kind"
        f" {json.dumps(got17h)}; run {run17h_s:.3f} s = {landed17h / run17h_s:.0f} txn/s to the"
        f" store (17e (a): {r17e['txn_s']:.0f}); banks {banks17h_s:.3f} s host; seal"
        f" {seal17h_s:.3f} s ({sx17h.seal_rows} rows, bank hash {seal17h.bank_hash.hex()});"
        f" replay reproduces the seal in {replay17h_s:.3f} s; launches K1"
        f" {launches17h.get('verify_batch', 0)}, K5 {launches17h.get('gf256_apply', 0)}, K13"
        f" {launches17h.get('lthash_combine', 0)} ({launches17h})")
    log(f"[zk-leader-split] host seconds"
        f" {json.dumps({k: round(v, 4) for k, v in sorted(split17h.items())})}; 17e (a) in this"
        f" call: {json.dumps({k: round(v, 4) for k, v in sorted(r17e['split'].items())})};"
        f" {funk_plane('zk-leader', rep17h, pipe17h.banks)}; counters {json.dumps(rep17h)}")
    ne17h = native_counts(rep17h, pipe17h.banks)
    log(f"[native-exec] 17h: native_exec {ne17h[0]}, native_punt {ne17h[1]} ({landed17h} landed)")
    pipe17h.bank_ctx.close()  # the ctx this phase built and passed in
    fund17h.close()

    # -- 17i. the ingress leader: 17e (a) behind a UDP socket ---------------------------------
    mark("17i")
    # who sends it: wallets and RPC nodes forwarding txns to the leader's TPU
    # port; here one loopback socket, paced INGRESS_AHEAD past the stage
    r17i = clock_leader("ingress-leader", udp_ingress=True)
    check(r17i["sealed"] >= 1, "ingress-leader: no slot sealed")
    both17i = r17i["landed"] == r17e["landed"] == len(stream17e)
    if both17i:
        check(r17i["sigs"] == r17e["sigs"],
              "ingress-leader: landed signatures differ from 17e (a)'s")
    sp17i = r17i["split"]
    sigs17i = ("equal to 17e (a)'s" if both17i else
               f"not compared: a run landed fewer than {len(stream17e)}")
    log(f"[ingress-leader-vs] 17e (a) in this call: {r17e['txn_s']:.0f} txn/s to the store,"
        f" slots sealed {r17e['sealed']}, {r17e['in_window']} txns in the window; the ingress"
        f" leader {r17i['txn_s']:.0f} txn/s, slots sealed {r17i['sealed']}, missed"
        f" {r17i['missed']}, {r17i['in_window']} txns in the window; the net stage"
        f" {sp17i.get('net', 0.0):.4f} s host over {r17i['sweeps']} sweeps"
        f" ({1e6 * sp17i.get('net', 0.0) / r17i['sweeps']:.3f} us a sweep,"
        f" {1e6 * sp17i.get('net', 0.0) / len(stream17e):.3f} us a datagram), 17e (a)'s benchg"
        f" {r17e['split'].get('benchg', 0.0):.4f} s over {r17e['sweeps']} sweeps; verify0"
        f" {sp17i.get('verify0', 0.0):.4f} s against {r17e['split'].get('verify0', 0.0):.4f} s;"
        f" landed signatures {sigs17i}")

    # -- 17j. [net-lanes]: the ingress stages alone on the card's host -------------------------
    mark("17j")
    made17j = []  # the name of every link this phase makes, for its leftover check

    def lane_link(tag_: str, depth_: int, mtu_: int = 1232):
        l_ = tshm.ShmLink.create(f"fdtpu_torch_{tag_}_{tshm.fresh_uid()}", depth=depth_,
                                 mtu=mtu_)
        made17j.append(l_.name)
        return l_

    # UDP: 17e's packets through one UdpIngressStage on each lane
    udp_lanes = {}
    for lane_ in ("native", "scalar", "python"):
        link_ = lane_link("nl", LANES_DEPTH)
        st_ = None
        try:
            st_ = UdpIngressStage("net", outs=[tshm.make_producer(link_)], rx_burst=64,
                                  native_net=lane_ != "python")
            st_.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, INGRESS_RCVBUF)
            cons_ = tshm.make_consumer(link_, lazy=0)
            dr_ = tnat.BurstDrainer([cons_], LANES_BURST)
            tx_ = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            got_, sent_ = [], 0
            calls_ = [0, 0.0, 0, 0.0]  # idle calls and their s, busy calls and their s
            t0 = time.perf_counter()
            try:
                while st_.metrics.get("pkt_rx") < len(stream17e):
                    sent_ = send_paced(tx_, st_, stream17e, sent_, INGRESS_AHEAD)
                    rx0_ = st_.metrics.get("pkt_rx")
                    t1 = time.perf_counter()
                    if lane_ == "scalar":
                        if st_.outs[0].cr_avail <= 0:
                            st_.outs[0].refresh_credits()
                        st_.native_sweep(scalar=True)
                    else:
                        st_.run_once()
                    k_ = 2 if st_.metrics.get("pkt_rx") > rx0_ else 0
                    calls_[k_] += 1
                    calls_[k_ + 1] += time.perf_counter() - t1
                    got_ += drain_all(dr_, meta=True)
                    check(time.perf_counter() - t0 < 60, f"net-lanes: the {lane_} UDP lane stalled"
                          f" at {st_.metrics.get('pkt_rx')} of {sent_}")
            finally:
                tx_.close()
            got_ += drain_all(dr_, meta=True)
            # the same receive call on the dry socket: what a sweep costs
            # when no datagram is waiting
            rx0_ = st_.metrics.get("pkt_rx")
            t1 = time.perf_counter()
            for _ in range(NET_IDLE_CALLS):
                if lane_ == "scalar":
                    st_.native_sweep(scalar=True)
                else:
                    st_.run_once()
            calls_[0] += NET_IDLE_CALLS
            calls_[1] += time.perf_counter() - t1
            check(st_.metrics.get("pkt_rx") == rx0_, f"net-lanes: the {lane_} idle calls took data")
            udp_lanes[lane_] = (got_, calls_, dict(st_.metrics.counters))
            del cons_, dr_
        finally:
            if st_ is not None:
                st_.close()
                st_.outs = []
            gc.collect()
            link_.close()
            link_.unlink()
        check(st_.sock.fileno() == -1, f"net-lanes: the {lane_} stage's socket is open")
    for lane_, (got_, _, cnt_) in udp_lanes.items():
        check([p_ for p_, _, _ in got_] == stream17e
              and [s_ for _, s_, _ in got_] == list(range(1, len(stream17e) + 1))
              and cnt_.get("oversize_drop", 0) == 0,
              f"net-lanes: the {lane_} UDP lane's payloads, order or sigs differ ({cnt_})")
    log(f"[net-lanes] UDP: 17e's {len(stream17e)} packets over loopback from one socket (at most"
        f" {INGRESS_AHEAD} ahead of pkt_rx, SO_RCVBUF asked {INGRESS_RCVBUF}) through one"
        f" UdpIngressStage (rx_burst 64), payloads, order and sigs equal on the three lanes: "
        + "; ".join(f"{lane_} {1e6 * c_[3] / len(stream17e):.3f} us a datagram over the"
                    f" {c_[2]} calls that took datagrams, {1e6 * c_[1] / max(c_[0], 1):.3f} us an"
                    f" idle call ({c_[0]}, the dry socket's {NET_IDLE_CALLS} included)"
                    for lane_, (_, c_, _) in udp_lanes.items())
        + " (host clock around the stage's receive calls; native:"
        " fdn_udp_sweep's recvmmsg then one publish_burst_out; scalar:"
        " NetClient.udp_sweep_scalar, one recv a datagram, by the explicit native_sweep(scalar="
        "True); python: native_net=False, one recvfrom and one publish a datagram)")

    # QUIC: NET_QUIC_CLIENTS clients on loopback sockets, one stream a txn, to a
    # QuicIngressStage on each lane; then the txns through one VerifyStage (K1)
    identity_ = hashlib.sha256(b"net-lanes-identity").digest()
    quic_txns = stream17e[:NET_QUIC_TXNS]
    per_ = NET_QUIC_TXNS // NET_QUIC_CLIENTS
    by_client = [quic_txns[c_ * per_:(c_ + 1) * per_] for c_ in range(NET_QUIC_CLIENTS)]
    quic_lanes = {}
    for lane_ in ("native", "python"):
        link_ = lane_link("nq", 2 * NET_QUIC_TXNS)
        st_, clients_ = None, []
        try:
            st_ = QuicIngressStage("quic", outs=[tshm.make_producer(link_)], rx_burst=64,
                                   identity_secret=identity_, native_net=lane_ == "native")
            st_.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, INGRESS_RCVBUF)
            cons_ = tshm.make_consumer(link_, lazy=0)
            dr_ = tnat.BurstDrainer([cons_], LANES_BURST)
            hs_ms = []
            for _ in range(NET_QUIC_CLIENTS):
                box_ = {}

                def connect(box=box_):
                    t1_ = time.perf_counter()
                    box["c"] = QuicTxnClient(st_.addr, expected_peer=ref.public_key(identity_),
                                             timeout_s=30.0)
                    box["ms"] = 1e3 * (time.perf_counter() - t1_)

                th_ = threading.Thread(target=connect)
                th_.start()
                t0 = time.perf_counter()
                while th_.is_alive():
                    st_.run_once()
                    check(time.perf_counter() - t0 < 60, f"net-lanes: {lane_} handshake stalled")
                th_.join()
                check("c" in box_, f"net-lanes: a {lane_} client failed its handshake")
                clients_.append(box_["c"])
                hs_ms.append(box_["ms"])
            got_, sent_ = [], 0
            calls_ = [0, 0.0, 0, 0.0]  # idle calls and their s, busy calls and their s
            pkt0 = st_.metrics.get("pkt_rx")
            t0 = time.perf_counter()
            while len(got_) < NET_QUIC_TXNS:
                # round-robin over the clients, paced by the stage's txn_rx
                while sent_ < NET_QUIC_TXNS and sent_ - st_.metrics.get("txn_rx") < INGRESS_AHEAD:
                    c_ = sent_ % NET_QUIC_CLIENTS
                    clients_[c_].send_txn(by_client[c_][sent_ // NET_QUIC_CLIENTS])
                    sent_ += 1
                rx0_ = st_.metrics.get("pkt_rx")
                t1 = time.perf_counter()
                st_.run_once()
                k_ = 2 if st_.metrics.get("pkt_rx") > rx0_ else 0
                calls_[k_] += 1
                calls_[k_ + 1] += time.perf_counter() - t1
                for c_ in clients_:
                    c_.pump()
                got_ += drain_all(dr_)
                check(time.perf_counter() - t0 < 120, f"net-lanes: the {lane_} QUIC lane stalled"
                      f" at {len(got_)} of {sent_} txns")
            n_dg = st_.metrics.get("pkt_rx") - pkt0
            t1 = time.perf_counter()
            for _ in range(NET_IDLE_CALLS):
                st_.run_once()
            calls_[0] += NET_IDLE_CALLS
            calls_[1] += time.perf_counter() - t1
            quic_lanes[lane_] = dict(got=got_, calls=calls_, dgrams=n_dg, hs_ms=hs_ms,
                                     net=st_.net_counters(), txn_rx=st_.metrics.get("txn_rx"))
            del cons_, dr_
        finally:
            for c_ in clients_:
                c_.close()
            if st_ is not None:
                st_.close()
                st_.outs = []
            gc.collect()
            link_.close()
            link_.unlink()
        for c_ in clients_:
            check(c_.sock.fileno() == -1, "net-lanes: a client's socket is open")
    # every client's txns whole and in its own order, on each lane
    for lane_, q_ in quic_lanes.items():
        check(sorted(q_["got"]) == sorted(quic_txns) and q_["txn_rx"] == NET_QUIC_TXNS,
              f"net-lanes: the {lane_} QUIC lane delivered {len(q_['got'])} txns,"
              f" {len(set(q_['got']) & set(quic_txns))} of them sent")
        pos_ = {p_: i_ for i_, p_ in enumerate(q_["got"])}
        for c_, txns_ in enumerate(by_client):
            check(sorted(txns_, key=pos_.get) == txns_,
                  f"net-lanes: the {lane_} lane reordered client {c_}'s txns")
    check(quic_lanes["native"]["net"]["consumed"] > 0 and not quic_lanes["python"]["net"],
          f"net-lanes: native counters {quic_lanes['native']['net']}, python"
          f" {quic_lanes['python']['net']}")
    # the lane's txns through one VerifyStage on the card: K1 once a batch,
    # and the mask (forwarded or not, in arrival order) equal to the plain
    # version's over the same txns
    for lane_, q_ in quic_lanes.items():
        vl_in = lane_link("nv_i", LANES_DEPTH)
        vl_out = lane_link("nv_o", LANES_DEPTH, 4096)
        try:
            prod_ = tshm.make_producer(vl_in)
            cons_ = tshm.make_consumer(vl_out, lazy=0)
            dr_ = tnat.BurstDrainer([cons_], LANES_BURST)
            st_ = VerifyStage("verify", [tshm.make_consumer(vl_in, lazy=32)],
                              [tshm.make_producer(vl_out)], device=dev, batch=B1,
                              max_msg_len=ML1)
            for i_, p_ in enumerate(q_["got"]):
                check(prod_.try_publish(p_, sig=i_, tsorig=1 + i_), "net-lanes: verify publish")
            out_ = []
            kbuild.reset_launches()
            t0 = time.perf_counter()
            while st_.ins[0].has_pending() or st_.busy():
                st_.run_once()
                out_ += drain_all(dr_)
                if not st_.ins[0].has_pending():
                    st_.flush()
                check(time.perf_counter() - t0 < 60, f"net-lanes: {lane_} verify stalled")
            st_.flush()
            out_ += drain_all(dr_)
            torch.cuda.synchronize()
            q_["batches"], q_["k1"] = st_.metrics.get("batches"), kbuild.LAUNCHES["verify_batch"]
            passed_ = {decode_verified(f_)[0] for f_ in out_}
            q_["mask"] = [p_ in passed_ for p_ in q_["got"]]
            st_.ins, st_.outs = [], []
            st_.drop_native_views()
            del prod_, cons_, st_, dr_
            gc.collect()
        finally:
            for l_ in (vl_in, vl_out):
                l_.close()
                l_.unlink()
        n_ = len(q_["got"])
        mq_ = np.zeros((ML1, n_), np.uint8)
        lq_ = np.zeros((n_,), np.int32)
        sq_ = np.zeros((64, n_), np.uint8)
        kq_ = np.zeros((32, n_), np.uint8)
        for i_, p_ in enumerate(q_["got"]):
            t_ = ft.txn_parse(p_)
            m_ = t_.message(p_)
            mq_[:len(m_), i_] = np.frombuffer(m_, np.uint8)
            lq_[i_] = len(m_)
            sq_[:, i_] = np.frombuffer(t_.signatures(p_)[0], np.uint8)
            kq_[:, i_] = np.frombuffer(t_.signers(p_)[0], np.uint8)
        pm_, _ = sv.verify_batch_plain(*[torch.from_numpy(a_).to(dev) for a_ in (mq_, lq_, sq_, kq_)],
                                       n_, ML1)
        check(q_["mask"] == pm_.cpu().tolist() and all(q_["mask"]),
              f"net-lanes: the {lane_} lane's verify mask differs from the plain version's"
              f" ({sum(q_['mask'])} passed)")
        check(q_["k1"] == q_["batches"] > 0,
              f"net-lanes: K1 launched {q_['k1']} for {q_['batches']} verify batches")
    for lane_, q_ in quic_lanes.items():
        nc_, cq_ = q_["net"], q_["calls"]
        log(f"[net-lanes] QUIC {lane_} lane: {NET_QUIC_CLIENTS} QuicTxnClients on loopback sockets,"
            f" {NET_QUIC_TXNS} of 17e's packets ({per_} a client, one unidirectional stream a txn)"
            f" to one QuicIngressStage (native_net={lane_ == 'native'}): every txn whole, each"
            f" client's in order; handshake ms {[round(h_, 3) for h_ in q_['hs_ms']]};"
            f" {q_['dgrams']} datagrams after the handshakes,"
            f" {1e6 * cq_[3] / max(q_['dgrams'], 1):.3f} us a datagram over the {cq_[2]}"
            f" run_once calls that took datagrams, {1e6 * cq_[1] / max(cq_[0], 1):.3f} us an idle"
            f" one ({cq_[0]}, the dry socket's {NET_IDLE_CALLS} included; each sweeps every"
            f" connection's timers) (host clock around the stage's run_once); counters consumed"
            f" {nc_.get('consumed', '-')}, punt {nc_.get('punt', '-')}, aesni"
            f" {nc_.get('aesni', '-')}, pclmul {nc_.get('pclmul', '-')}; then one VerifyStage on"
            f" the card (batch {B1}): {q_['batches']} batches, K1 {q_['k1']} launches, mask equal"
            f" to the plain verify_batch_plain's ({sum(q_['mask'])} of {len(q_['mask'])} pass)")
    leftover = [n_ for n_ in made17j if os.path.exists(f"/dev/shm/{n_}")]
    check(len(made17j) == 9 and not leftover,
          f"net-lanes: of its {len(made17j)} links, /dev/shm entries left {leftover}")

    # -- 18. K14 sha256_msg, K15 sha256_mix32 and the bmtree root build ------------------------
    mark("18")

    def plain_run(fn):
        """(result, host ms) of one run of a plain version on the card."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    P = PLAIN_LANES
    B14, ML14 = 4096, 1232
    rng = np.random.default_rng(18)
    edge14 = [0, 1, 55, 56, 63, 64, 119, 120, ML14 - 1, ML14]
    l14h = np.array(edge14 + [int(v) for v in rng.integers(0, ML14 + 1, B14 - len(edge14))],
                    dtype=np.int32)
    m14h = rng.integers(0, 256, (ML14, B14), dtype=np.uint8)  # bytes past a length are ignored
    m14, l14 = torch.from_numpy(m14h).to(dev), torch.from_numpy(l14h).to(dev)
    kbuild.reset_launches()
    d14 = fsha256.sha256_msg(m14, l14)
    torch.cuda.synchronize()
    api14 = kbuild.LAUNCHES["sha256_msg"]
    want14 = np.stack([np.frombuffer(hashlib.sha256(m14h[:n, i].tobytes()).digest(), np.uint8)
                       for i, n in enumerate(l14h)], -1)
    err14 = int(np.abs(d14.cpu().numpy().astype(np.int64) - want14).max())
    check(err14 == 0, f"K14 differs from hashlib (max abs err {err14})")
    p14, plain14 = plain_run(lambda: fsha256.sha256_msg_plain(
        m14[:, :P].contiguous(), l14[:P].contiguous(), ML14))
    check(torch.equal(p14, d14[:, :P]), "K14 differs from its plain version")
    # the narrow path: the same rows not 16-byte aligned, and 4,091 lanes
    m14o = offset_rows(m14)
    check(torch.equal(fsha256._sha256_msg(m14o, l14, ML14), d14),
          "K14's narrow path (rows not 16-byte aligned) differs from its wide path")
    n14r = B14 - 5
    check(torch.equal(fsha256.sha256_msg(m14[:, :n14r].contiguous(), l14[:n14r].contiguous()),
                      d14[:, :n14r]), f"K14 on {n14r} lanes differs from the full batch")
    ms14 = time_ms(lambda: fsha256._sha256_msg(m14, l14, ML14), reps=50, hide_host=True)
    ms14n = time_ms(lambda: fsha256._sha256_msg(m14o, l14, ML14), reps=50, hide_host=True)
    blocks14 = int(((l14h.astype(np.int64) + 9 + 63) // 64).sum())
    b14, bby14 = bound(blocks14 * SHA256_OPS_PER_COMPRESSION, int(l14h.sum()) + 36 * B14)
    log(f"[K14] sha256_msg B={B14} max_len={ML14} ({blocks14} blocks, lengths {edge14} and"
        f" random): equal to hashlib on every lane and to plain on {P}; the narrow path (offset"
        f" rows) and {n14r} lanes equal; {ms14 * 1e3:.2f} us (narrow path {ms14n * 1e3:.2f} us;"
        f" bound {b14 * 1e3:.2f} us, {bby14}); plain {plain14:.1f} ms")

    def mix32_hashlib(sth, mxh):
        return np.stack([np.frombuffer(hashlib.sha256(sth[:, i].tobytes() + mxh[:, i].tobytes())
                                       .digest(), np.uint8) for i in range(sth.shape[1])], -1)

    runs15, want15 = {}, {}
    for bsz in K15_BATCHES + K15_CHECK_BATCHES:
        sth, mxh = (rng.integers(0, 256, (32, bsz), dtype=np.uint8) for _ in range(2))
        runs15[bsz] = (torch.from_numpy(sth).to(dev), torch.from_numpy(mxh).to(dev))
        want15[bsz] = mix32_hashlib(sth, mxh)
    st15, mx15 = runs15[B14]
    kbuild.reset_launches()
    d15 = fsha256.sha256_mix32(st15, mx15)
    torch.cuda.synchronize()
    api15 = kbuild.LAUNCHES["sha256_mix32"]
    err15 = int(np.abs(d15.cpu().numpy().astype(np.int64) - want15[B14]).max())
    check(err15 == 0, f"K15 differs from hashlib (max abs err {err15})")
    p15, plain15 = plain_run(lambda: fsha256.sha256_mix32_plain(st15, mx15))
    check(torch.equal(p15, d15), "K15 differs from its plain version")
    # the narrow path (state and mixin not 16-byte aligned), a ragged last
    # block (4,091 lanes), the large batch on both paths (four warp pairs a
    # block) and a four-pair grid whose last block holds one pair in the
    # batch, each equal to hashlib on every lane
    st15o, mx15o = offset_rows(st15), offset_rows(mx15)
    big15 = K15_BATCHES[-1]
    n15r = B14 - 5
    for label, (st_, mx_), want in (
            ("offset rows", (st15o, mx15o), want15[B14]),
            (f"{n15r} lanes", (st15[:, :n15r].contiguous(), mx15[:, :n15r].contiguous()),
             want15[B14][:, :n15r]),
            (f"offset rows at B={big15}", tuple(map(offset_rows, runs15[big15])), want15[big15]),
            *((f"B={b}", runs15[b], want15[b]) for b in K15_BATCHES[1:] + K15_CHECK_BATCHES)):
        check(np.array_equal(fsha256.sha256_mix32(st_, mx_).cpu().numpy(), want),
              f"K15 differs from hashlib at {label}")
    ms15 = {b: time_ms(lambda r=runs15[b]: fsha256.sha256_mix32(*r), reps=50, hide_host=True)
            for b in K15_BATCHES}
    ms15n = time_ms(lambda: fsha256.sha256_mix32(st15o, mx15o), reps=50, hide_host=True)
    b15 = {b: bound(b * (SHA256_OPS_PER_COMPRESSION + SHA256_OPS_PER_PAD_COMPRESSION), 96 * b)
           for b in K15_BATCHES}
    # the chain floor: 128 rounds (two compressions) of K15_CHAIN_DEPTH
    # dependent instructions at DEP_CLOCKS each, an estimate
    floor15 = 128 * K15_CHAIN_DEPTH * DEP_CLOCKS / (clk_mhz * 1e3)
    log(f"[K15] sha256_mix32: equal to hashlib on every lane at B={B14} (and to plain), from"
        f" offset rows (the narrow path), at {n15r} lanes, at B={big15} (wide and offset"
        f" rows) and at B={', '.join(map(str, K15_CHECK_BATCHES))};"
        f" device only " + ", ".join(f"B={b} {ms15[b] * 1e3:.2f} us (bound {b15[b][0] * 1e3:.2f}"
                                     f" us, {b15[b][1]})" for b in K15_BATCHES)
        + f", offset rows at B={B14} {ms15n * 1e3:.2f} us; chain floor estimate"
        f" {floor15 * 1e3:.2f} us (128 rounds x {K15_CHAIN_DEPTH} dependent instructions x"
        f" {DEP_CLOCKS} clocks); plain {plain15:.1f} ms")
    if PARENT:
        k15_ab(parent_fns["fd_sha256_mix32"], fsha256, dev,
               {f"B={b}": runs15[b] for b in K15_BATCHES})
        k15_knobs(parent_fns, fsha256, dev)

    # the root build: phase 17's FEC sets grouped by shape; leaf i of tree j in
    # column i * T + j of each leaf size's byte rows (made on the host: set-up)
    def leaf_region(buf: bytes) -> bytes:
        return buf[fs.SIGNATURE_SZ:fs.merkle_off(buf[fs.SIGNATURE_SZ])]

    groups18: dict[tuple, list] = {}
    for st in pipe17.shred.sets:
        dl = [leaf_region(x) for x in st.data_shreds]
        pl = [leaf_region(x) for x in st.parity_shreds]
        key = (len(dl), len(pl), len(dl[0]), len(pl[0]) if pl else 0)
        groups18.setdefault(key, []).append((st, dl, pl))
    rows18 = []
    for (nd, npar, _, _), grp in groups18.items():
        nt = len(grp)
        drows = np.stack([np.frombuffer(grp[j][1][i], np.uint8)
                          for i in range(nd) for j in range(nt)], -1)
        prows = (np.stack([np.frombuffer(grp[j][2][i], np.uint8)
                           for i in range(npar) for j in range(nt)], -1) if npar else None)
        rows18.append((nd, npar, nt, drows, prows))

    def root_build():
        out = []
        for nd, npar, nt, drows, prows in rows18:
            lv = [fbm.hash_leaves_batch(drows, device=dev)]
            if npar:
                lv.append(fbm.hash_leaves_batch(prows, device=dev))
            leaves = torch.cat([x.reshape(fbm.NODE_SZ, -1, nt) for x in lv], 1)
            out.append(fbm.layers_batch(leaves.permute(1, 0, 2).contiguous()))
        return out

    def host_build():
        return [[fbm.tree_layers([fbm.hash_leaf(x) for x in dl + pl]) for _, dl, pl in grp]
                for grp in groups18.values()]

    # every K14 launch of the root build, recorded at its own shape
    rec18 = []
    k14_launch = fsha256._sha256_msg

    def recording(msg, msg_len, max_len):
        rec18.append((msg.clone(), msg_len.clone(), max_len))
        return k14_launch(msg, msg_len, max_len)

    kbuild.reset_launches()
    fsha256._sha256_msg = recording
    try:
        layers18, build18 = plain_run(root_build)
    finally:
        fsha256._sha256_msg = k14_launch
    launches18 = dict(kbuild.LAUNCHES)
    want_l18 = sum(1 + (npar > 0) + fbm.depth(nd + npar) - 1 for nd, npar, _, _, _ in rows18)
    check(launches18 == {"sha256_msg": want_l18},
          f"root build launches {launches18} != {want_l18} K14 (one per leaf size and layer)")
    host18 = host_build()
    for layers, hosts, grp in zip(layers18, host18, groups18.values()):
        lh = [x.cpu().numpy() for x in layers]
        for j, (st, _, _) in enumerate(grp):
            check(len(lh) == len(hosts[j]), "root build: layer count differs from the host tree")
            for lay, hl in zip(lh, hosts[j]):
                check([bytes(lay[i, :, j]) for i in range(len(hl))] == hl,
                      "root build: a layer differs from the host tree (leaves: hash_leaf)")
            check(bytes(lh[-1][0, :, j]) == st.merkle_root[:fbm.NODE_SZ],
                  "root build: a root is not the signed root's first 20 bytes")
    check(len(rec18) == want_l18,
          f"root build: {len(rec18)} K14 calls recorded, {want_l18} launched")
    # each launch alone at its own shape, device only: lanes, the longest
    # lane's blocks, the path (wide: B % 16 == 0 and 16-byte aligned rows),
    # time and bound; then the timed batches' last 1,024 lanes on both paths
    per18 = []
    for m, ln, ml in rec18:
        lh18 = ln.cpu().numpy().astype(np.int64)
        nblk = (lh18 + 9 + 63) // 64
        t_ = time_ms(lambda m=m, ln=ln, ml=ml: fsha256._sha256_msg(m, ln, ml), reps=20,
                     hide_host=True)
        bms_, _ = bound(int(nblk.sum()) * SHA256_OPS_PER_COMPRESSION,
                        int(lh18.sum()) + 36 * len(lh18))
        per18.append(dict(lanes=len(lh18), blocks=int(nblk.max()), max_len=ml,
                          path="wide" if len(lh18) % 16 == 0 and m.data_ptr() % 16 == 0
                          else "narrow", ms=t_, bound_ms=bms_))
        if PARENT:  # the parent's K14 at the same shape, right after
            out_ = torch.empty((32, len(lh18)), dtype=torch.uint8, device=dev)
            per18[-1]["parent_ms"] = time_ms(
                lambda m=m, ln=ln, o=out_: parent_call(parent_fns["fd_sha256_msg"], dev,
                                                       m.data_ptr(), ln.data_ptr(), o.data_ptr(),
                                                       m.shape[1]), reps=20, hide_host=True)
    loss18 = sum(x["ms"] - x["bound_ms"] for x in per18)
    ploss18 = (f"; the parent's sum {sum(x['parent_ms'] - x['bound_ms'] for x in per18) * 1e3:.2f}"
               " us" if PARENT else "")
    log(f"[K14-launches] the root build's {len(per18)} K14 launches alone, device only (lanes x"
        " longest lane's blocks, path: us, bound us[, parent us]): " + "; ".join(
            f"{x['lanes']}x{x['blocks']} {x['path']}: {x['ms'] * 1e3:.2f},"
            f" {x['bound_ms'] * 1e3:.2f}" + (f", {x['parent_ms'] * 1e3:.2f}" if PARENT else "")
            for x in per18)
        + f"; sum of (time - bound) {loss18 * 1e3:.2f} us{ploss18}")
    leaf18 = max(range(len(rec18)), key=lambda i: per18[i]["lanes"] * per18[i]["blocks"])
    timed14 = {f"B={B14} max_len={ML14}": (m14, l14, ML14),
               f"leaf {per18[leaf18]['lanes']} lanes x {per18[leaf18]['max_len']} B": rec18[leaf18]}
    for label, (m, ln, ml) in timed14.items():
        tail = slice(m.shape[1] - min(P, m.shape[1]), m.shape[1])
        pl = fsha256.sha256_msg_plain(m[:, tail].contiguous(), ln[tail].contiguous(), ml)
        for path, mm in (("wide", m), ("narrow", offset_rows(m))):
            check(torch.equal(fsha256._sha256_msg(mm, ln, ml)[:, tail], pl),
                  f"K14 ({path} path) differs from plain on the last lanes at {label}")
    log(f"[K14] the last {P} lanes of each timed batch ({', '.join(timed14)}) equal to plain on"
        " the wide and the narrow path")
    if PARENT:
        msg_ab("K14-ab", parent_fns["fd_sha256_msg"],
               lambda m, ln: fsha256._sha256_msg(m, ln, m.shape[0]),
               {label: (m, ln) for label, (m, ln, _) in timed14.items()})
    dev18 = sorted(plain_run(root_build)[1] for _ in range(3))
    host18_ms = sorted(plain_run(host_build)[1] for _ in range(3))
    nsets18 = sum(len(g) for g in groups18.values())
    log(f"[bmtree] {nsets18} FEC sets of phase 17 in {len(groups18)} groups (d, p, data leaf,"
        f" parity leaf bytes: {sorted(groups18)[:4]}...): every layer equal to the host tree,"
        f" every root the signed root's first 20 bytes; {want_l18} K14 launches; whole-slot"
        f" root build {build18:.2f} ms first, then {', '.join(f'{t:.2f}' for t in dev18)} ms;"
        f" host tree (hashlib) {', '.join(f'{t:.2f}' for t in host18_ms)} ms")

    # -- 19. K16 blake3_msg, K17 keccak256_msg and K18 chacha20_keystream alone -----------------
    mark("19")
    rng = np.random.default_rng(19)

    def msg_batch(bsz, max_len, edges):
        lens = np.array(edges + [int(v) for v in rng.integers(0, max_len + 1, bsz - len(edges))],
                        dtype=np.int32)
        mh = rng.integers(0, 256, (max_len, bsz), dtype=np.uint8)
        sample = list(range(len(edges))) + [int(i) for i in rng.choice(
            np.arange(len(edges), bsz), 64, replace=False)]
        return mh, lens, torch.from_numpy(mh).to(dev), torch.from_numpy(lens).to(dev), sample

    hashes19 = {}
    for nm, bsz, max_len, edges, api, launch, plain, host, ops in (
            ("blake3_msg", 16384, 1024, [0, 1, 63, 64, 65, 127, 128, 129, 1023, 1024],
             fb3.blake3_msg, fb3._blake3_msg_launch, fb3.blake3_msg_plain, fb3.blake3_host,
             lambda ln: int(np.maximum(1, (ln.astype(np.int64) + 63) // 64).sum())
             * BLAKE3_OPS_PER_COMPRESSION),
            ("keccak256_msg", 4096, 1232, [0, 1, 135, 136, 137, 271, 272, 1231, 1232],
             fkk.keccak256_msg, fkk._keccak256_msg_launch, fkk.keccak256_msg_plain,
             fkk.keccak256_host,
             lambda ln: int((ln.astype(np.int64) // 136 + 1).sum()) * KECCAK_OPS_PER_PERMUTATION)):
        mh, lh, m19, l19, sample = msg_batch(bsz, max_len, edges)
        kbuild.reset_launches()
        d19 = api(m19, l19)
        torch.cuda.synchronize()
        n_api = kbuild.LAUNCHES[nm]
        dh = d19.cpu().numpy()
        err = max(int(np.abs(dh[:, i].astype(np.int64) - np.frombuffer(
            host(mh[:lh[i], i].tobytes()), np.uint8)).max()) for i in sample)
        check(err == 0, f"{nm} differs from its host oracle (max abs err {err})")
        p19, plain_ms = plain_run(lambda: plain(m19[:, :P].contiguous(), l19[:P].contiguous(),
                                                max_len))
        check(torch.equal(p19, d19[:, :P]), f"{nm} differs from its plain version")
        tail = slice(bsz - P, bsz)
        check(torch.equal(plain(m19[:, tail].contiguous(), l19[tail].contiguous(), max_len),
                          d19[:, tail]), f"{nm} differs from its plain version on the last lanes")
        m19o = offset_rows(m19)
        check(torch.equal(launch(m19o, l19), d19), f"{nm} from rows not 16-byte aligned differs")
        ms_n = time_ms(lambda: launch(m19o, l19), reps=50, hide_host=True)
        if PARENT:
            msg_ab("K16-ab" if nm == "blake3_msg" else "K17-ab", parent_fns[f"fd_{nm}"], launch,
                   {f"B={bsz} max_len={max_len}": (m19, l19), "offset rows": (m19o, l19)})
        ms_ = time_ms(lambda: launch(m19, l19), reps=50, hide_host=True)
        ms_call = time_ms(lambda: api(m19, l19), reps=50)  # the length check's host sync included
        bms, bby = bound(ops(lh), int(lh.sum()) + 36 * bsz)
        hashes19[nm] = dict(api=n_api, err=err, ms=ms_, plain=plain_ms, bound=(bms, bby),
                            shape=f"B={bsz} max_len={max_len}", ms_narrow=ms_n,
                            ms_per_call=ms_call)
        log(f"[{'K16' if nm == 'blake3_msg' else 'K17'}] {nm} B={bsz} max_len={max_len}"
            f" (lengths {edges} and random): equal to {host.__name__} on {len(sample)} lanes, to"
            f" plain on the first and last {P}, and from offset rows on every lane;"
            f" {ms_ * 1e3:.2f} us device only (offset rows {ms_n * 1e3:.2f} us), a call through"
            f" {api.__name__} {ms_call * 1e3:.2f} us; bound {bms * 1e3:.2f} us, {bby};"
            f" plain {plain_ms:.1f} ms")

    B18 = 65536
    H18 = B18 // 2
    k18h = rng.integers(0, 256, (32, B18), dtype=np.uint8)
    n18h = rng.integers(0, 256, (12, B18), dtype=np.uint8)
    i18h = rng.integers(0, 1 << 32, B18, dtype=np.int64)
    i18h[[0, 1, H18, H18 + 1]] = (0, (1 << 32) - 1, 0, (1 << 32) - 1)
    k18 = torch.from_numpy(k18h).to(dev)
    i18 = torch.from_numpy(i18h.astype(np.uint32).view(np.int32)).to(dev)
    n18 = torch.from_numpy(n18h).to(dev)
    halves = ((slice(0, H18), None), (slice(H18, B18), n18[:, H18:].contiguous()))
    kbuild.reset_launches()
    out18 = [fcc.chacha20_keystream(k18[:, sl].contiguous(), i18[sl].contiguous(), nc)
             for sl, nc in halves]
    torch.cuda.synchronize()
    api18 = kbuild.LAUNCHES["chacha20_keystream"]
    err18, plain18 = 0, 0.0
    for (sl, nc), o in zip(halves, out18):
        oh = o.cpu().numpy()
        for j in [0, 1] + [int(v) for v in rng.choice(H18, 126, replace=False)]:
            i = sl.start + j
            nonce = n18h[:, i].tobytes() if nc is not None else bytes(12)
            want = np.frombuffer(fcc.chacha20_block_host(k18h[:, i].tobytes(), int(i18h[i]), nonce),
                                 np.uint8)
            err18 = max(err18, int(np.abs(oh[:, j].astype(np.int64) - want).max()))
        p18, pms = plain_run(lambda: fcc.chacha20_keystream_plain(
            k18[:, sl][:, :P].contiguous(), i18[sl][:P].contiguous(),
            None if nc is None else nc[:, :P].contiguous()))
        plain18 += pms / 2
        check(torch.equal(p18, o[:, :P]), "K18 differs from its plain version")
    check(err18 == 0, f"K18 differs from chacha20_block_host (max abs err {err18})")
    ms18 = time_ms(lambda: fcc.chacha20_keystream(k18, i18, n18), reps=50, hide_host=True)
    ms18z = time_ms(lambda: fcc.chacha20_keystream(k18, i18), reps=50, hide_host=True)
    b18, bby18 = bound(B18 * CHACHA20_OPS_PER_BLOCK, B18 * (32 + 4 + 12 + 64))
    log(f"[K18] chacha20_keystream B={B18} (half zero nonces, half seeded; indices 0 and"
        f" 2^32 - 1 in each half): equal to chacha20_block_host on 256 lanes and to plain on"
        f" {P} of each half; {ms18 * 1e3:.2f} us with nonces, {ms18z * 1e3:.2f} us with zero"
        f" nonces (bound {b18 * 1e3:.2f} us, {bby18}); plain {plain18:.1f} ms")

    ops_api = {"sha512_batch": api3, "sha256_msg": api14, "sha256_mix32": api15,
               "chacha20_keystream": api18,
               **{nm: h["api"] for nm, h in hashes19.items()}}
    for nm, src, line, err, ms_, plain_, (bms, bby), shp, path, path_n in (
            ("sha256_msg", "sha256_msg.cu", "sha256.py:122", err14, ms14, plain14, (b14, bby14),
             f"B={B14} max_len={ML14}", "bmtree root build (phase 18)", launches18["sha256_msg"]),
            ("sha256_mix32", "sha256_msg.cu", "sha256.py:182", err15, ms15[B14], plain15,
             b15[B14], f"B={B14}", OPS_API, api15),
            *((nm, f"{nm}.cu", line, h["err"], h["ms"], h["plain"], h["bound"], h["shape"],
               OPS_API, h["api"])
              for (nm, h), line in zip(hashes19.items(), ("blake3.py:150", "keccak256.py:148"))),
            ("chacha20_keystream", "chacha20_keystream.cu", "chacha20.py:65", err18, ms18,
             plain18, (b18, bby18), f"B={B18}", OPS_API, api18)):
        kernels.append(dict(
            name=nm, route="cuda", source=f"firedancer_tpu_torch/csrc/{src}",
            replaces=f"firedancer_tpu/ops/{line}", launches=None, max_abs_err=err, ms=ms_,
            plain_ms=plain_, bound_ms=bms, bound_by=bby, library_ms=None, matched=True,
            shape=shp, plain_shape=f"{P} lanes", phase_launches=ops_api[nm], main_path=path,
            path_launches=path_n))
    by_name = {k["name"]: k for k in kernels}
    by_name["chacha20_keystream"]["ms_zero_nonces"] = ms18z
    for nm, h in hashes19.items():
        by_name[nm].update(ms_narrow=h["ms_narrow"], ms_per_call=h["ms_per_call"])
    by_name["sha256_mix32"].update(ms_narrow=ms15n,
                                   at_batch={str(b): dict(ms=ms15[b], bound_ms=b15[b][0])
                                             for b in K15_BATCHES})
    by_name["sha256_msg"].update(root_build_ms=dev18, host_tree_ms=host18_ms, ms_narrow=ms14n,
                                 root_build_launches=per18, root_build_loss_ms=loss18)
    by_name["gf256_apply"].update(path_loss_ms={
        ph: sum(x["ms"] - x["bound_ms"] for x in per) for ph, per in (("17", k5_17), ("17b", k5_17b))},
        path_shapes={ph: sorted({str(x["shape"]): x["ms"] for x in per}.items())
                     for ph, per in (("17", k5_17), ("17b", k5_17b))})

    for k in kernels:
        check(k["phase_launches"] > 0, f"{k['name']} never launched in its phase")
        # each kernel's main path: the comb pipeline for the comb lane's
        # kernels, the split pipeline for K9-K12, the leader pipeline for
        # K13 and K5 (the shredder's parity), the plane pipeline for the rest;
        # K3 and K14-K18 carry their own path from phases 4 and 18-19
        comb_lane = k["name"] in ("verify_cached", "comb_fill", "bank_install")
        main = (launches13 if comb_lane else launches15 if k["name"] in SPLIT
                else launches17 if k["name"] in ("lthash_combine", "gf256_apply")
                else launches10)
        k["launches"] = k.pop("path_launches") if "path_launches" in k else main.get(k["name"], 0)
        k["launches_by_path"] = {"verify_pipeline": launches7.get(k["name"], 0),
                                 "plane_pipeline": launches10.get(k["name"], 0),
                                 "leader_step": launches11.get(k["name"], 0),
                                 "comb_pipeline": launches13.get(k["name"], 0),
                                 "split_pipeline": launches15.get(k["name"], 0),
                                 "plane_hook_pipeline": launches15b.get(k["name"], 0),
                                 "autotune_pipeline": launches15c.get(k["name"], 0),
                                 "leader_pipeline": launches17.get(k["name"], 0),
                                 "leader_lossy_store": launches17b.get(k["name"], 0),
                                 "sharded_leader_pipeline": launches17c.get(k["name"], 0),
                                 "vote_leader_pipeline": launches17d.get(k["name"], 0),
                                 "clock_leader_pipeline": launches17e.get(k["name"], 0),
                                 "program_leader_pipeline": launches17f.get(k["name"], 0),
                                 "sbpf_leader_pipeline": launches17g.get(k["name"], 0),
                                 "zk_leader_pipeline": launches17h.get(k["name"], 0),
                                 "bmtree_root_build": launches18.get(k["name"], 0),
                                 OPS_API: ops_api.get(k["name"], 0)}
    for nm in SPLIT:
        check(launches15.get(nm, 0) > 0, f"{nm} never launched on the split pipeline")
    check(ref.verify(b"", ref.sign(b"\x01" * 32, b""), ref.public_key(b"\x01" * 32)),
          "ed25519_ref self-check")
    # every shm segment this run made (the links' fdtpu_torch_<link>_<pid>_<n>
    # and the funk maps' fdtpu_torch_funk_<pid>_<n>) was closed where it was
    # made: none is left for a collection or the exit to find
    mine = sorted(n_ for n_ in os.listdir("/dev/shm")
                  if n_.startswith("fdtpu_torch_") and f"_{os.getpid()}_" in n_)
    check(not mine, f"/dev/shm entries of this run left: {mine[:8]} ({len(mine)})")
    log("[shm] no /dev/shm entry of this run left before exit")
    mark("end")
    log("[time] seconds per phase (host clock, each from its start to the next's): "
        + ", ".join(f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:])))
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    # --parent DIR: also build DIR's probe_conv, K1-K7, K9-K17
    # (a checkout of an earlier commit) and time them beside this tree's in
    # phases 2b, 3, 4, 6, 8, 9, 12, 14, 16, 17b, 18 and 19
    PARENT = sys.argv[sys.argv.index("--parent") + 1] if "--parent" in sys.argv else None
    sys.exit(main())
