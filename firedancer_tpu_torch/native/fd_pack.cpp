// Native pack scheduler + fused dedup lane (the port's copy of the repo's
// native/fd_pack.cpp).
//
// Counterpart of the reference's ballet/pack library (fd_pack.c): a
// priority-ordered pending pool (treap role: ordered iteration +
// O(log n) insert/delete) with EXACT reward/cost comparison
// (r1*c2 > r2*c1, no floating point), a separate simple-vote pool,
// per-account reader/writer conflict masks over an interned account
// table (fd_pack_bitset.h semantics), and the consensus-critical block
// limits (total/vote/per-writer cost, data bytes incl. the 48-byte
// microblock overhead).
//
// Parity contract (differentially tested against pack/scheduler.py +
// pack/cost.py by tests/test_torch_pack_native.py): byte-identical microblock
// frames, identical eviction decisions, identical end_block accounting,
// and identical dedup drops.  The behavioral spec is the Python module;
// every rule here cites it.
//
// Fused dedup: fd_pack_insert_burst probes the EXISTING fd_tcache.so
// table through a function pointer the facade passes in (one shared
// tcache structure across both lanes), so a duplicate txn never
// surfaces into Python at all — the dedup stage's per-frag Python
// overhead (22 us/txn at round 6) folds into the same single FFI
// crossing the pack intake already pays (FD207 discipline).
//
// Input frags are the verify stage's zero-copy layout unchanged:
// payload || packed-descriptor || u16 payload_sz (fd_txn_parse's
// descriptor — no Txn unpack, no re-serialize; the emitted microblock
// frame carries the received frag bytes verbatim, which is what
// encode_verified(payload, desc) would rebuild).
//
// Build: utils/hostbuild.py (g++ -O2 -shared -fPIC into
// build/torch_native/); pack/scheduler_native.py binds it.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;
typedef int64_t i64;
typedef unsigned __int128 u128;

// -- protocol + cost-model constants (pack/cost.py) --------------------------

constexpr u64 TXN_MTU = 1232;
constexpr u32 SIG_MAX = 127;
constexpr u32 ACCT_ADDR_MAX = 128;
constexpr u32 INSTR_MAX = 64;
constexpr u32 LUT_MAX = 127;

constexpr u64 COST_PER_SIGNATURE = 720;
constexpr u64 COST_PER_WRITABLE_ACCT = 300;
constexpr u64 INV_COST_PER_INSTR_DATA_BYTE = 4;
constexpr u64 DEFAULT_INSTR_CU_LIMIT = 200000;
constexpr u64 MAX_CU_LIMIT = 1400000;
constexpr u64 HEAP_FRAME_GRANULARITY = 1024;
constexpr u64 MICRO_LAMPORTS_PER_LAMPORT = 1000000;
constexpr u64 FEE_PER_SIGNATURE = 5000;
constexpr u64 DEFAULT_HEAP_SIZE = 32 * 1024;
constexpr u64 MAX_HEAP_SIZE = 256 * 1024;
constexpr u64 MICROBLOCK_DATA_OVERHEAD = 48;

// insert result codes (pack/scheduler_native.py maps them to metrics)
constexpr u8 INS_OK = 0;         // accepted into the pool
constexpr u8 INS_DUP = 1;        // fused-dedup tcache hit (dedup_dup)
constexpr u8 INS_REJECT = 2;     // malformed compute-budget cost (dropped)
constexpr u8 INS_SIG_DUP = 3;    // first signature already pooled (dropped)
constexpr u8 INS_BAD_FRAG = 4;   // frag/descriptor fails validation
constexpr u8 INS_FULL = 5;       // pool full, newcomer loses (dropped)

// builtin execution costs (pack/cost.py BUILTIN_COST; keys are the
// decoded base58 program addresses)
struct Builtin { u8 key[32]; u64 cost; };
#define HX(a,b,c,d,e,f,g,h) 0x##a,0x##b,0x##c,0x##d,0x##e,0x##f,0x##g,0x##h
static const Builtin BUILTINS[] = {
  // Stake11111111111111111111111111111111111111 : 750
  {{HX(06,a1,d8,17,91,37,54,2a), HX(98,34,37,bd,fe,2a,7a,b2),
    HX(55,7f,53,5c,8a,78,72,2b), HX(68,a4,9d,c0,00,00,00,00)}, 750},
  // Config1111111111111111111111111111111111111 : 450
  {{HX(03,06,4a,a3,00,2f,74,dc), HX(c8,6e,43,31,0f,0c,05,2a),
    HX(f8,c5,da,27,f6,10,40,19), HX(a3,23,ef,a0,00,00,00,00)}, 450},
  // Vote111111111111111111111111111111111111111 : 2100
  {{HX(07,61,48,1d,35,74,74,bb), HX(7c,4d,76,24,eb,d3,bd,b3),
    HX(d8,35,5e,73,d1,10,43,fc), HX(0d,a3,53,80,00,00,00,00)}, 2100},
  // system program (32 zero bytes) : 150
  {{0}, 150},
  // ComputeBudget111111111111111111111111111111 : 150
  {{HX(03,06,46,6f,e5,21,17,32), HX(ff,ec,ad,ba,72,c3,9b,e7),
    HX(bc,8c,e5,bb,c5,f7,12,6b), HX(2c,43,9b,3a,40,00,00,00)}, 150},
  // AddressLookupTab1e1111111111111111111111111 : 750
  {{HX(02,77,a6,af,97,33,9b,7a), HX(c8,8d,18,92,c9,04,46,f5),
    HX(00,02,30,92,66,f6,2e,53), HX(c1,18,24,49,82,00,00,00)}, 750},
  // BPFLoaderUpgradeab1e11111111111111111111111 : 2370
  {{HX(02,a8,f6,91,4e,88,a1,b0), HX(e2,10,15,3e,f7,63,ae,2b),
    HX(00,c2,b9,3d,16,c1,24,d2), HX(c0,53,7a,10,04,80,00,00)}, 2370},
  // BPFLoader1111111111111111111111111111111111 : 1140
  {{HX(02,a8,f6,91,4e,88,a1,6b), HX(bd,23,95,85,5f,64,04,d9),
    HX(b4,f4,56,b7,82,1b,b0,14), HX(57,49,42,8c,00,00,00,00)}, 1140},
  // BPFLoader2111111111111111111111111111111111 : 570
  {{HX(02,a8,f6,91,4e,88,a1,6e), HX(39,5a,e1,28,94,8f,fa,69),
    HX(56,93,37,68,18,dd,47,43), HX(52,21,f3,c6,00,00,00,00)}, 570},
  // LoaderV411111111111111111111111111111111111 : 2000
  {{HX(05,12,b4,11,51,51,e3,7a), HX(ad,0a,8b,c5,d3,88,2e,7b),
    HX(7f,da,4c,f3,d2,c0,28,c8), HX(cf,83,36,18,00,00,00,00)}, 2000},
  // KeccakSecp256k11111111111111111111111111111 : 720
  {{HX(04,c6,fc,20,f0,50,cc,f0), HX(55,84,d7,21,1c,9f,8c,f5),
    HX(9e,c1,47,85,bb,16,6a,1e), HX(28,30,e8,12,20,00,00,00)}, 720},
  // Ed25519SigVerify111111111111111111111111111 : 720
  {{HX(03,7d,46,d6,7c,93,fb,be), HX(12,f9,42,8f,83,8d,40,ff),
    HX(05,70,74,49,27,f4,8a,64), HX(fc,ca,70,44,80,00,00,00)}, 720},
};
#undef HX
constexpr int N_BUILTINS = sizeof(BUILTINS) / sizeof(BUILTINS[0]);
constexpr int BI_VOTE = 2;     // index of the vote program row
constexpr int BI_CB = 4;       // index of the compute-budget row
constexpr int BI_KECCAK = 10;
constexpr int BI_ED25519 = 11;

static inline u16 rd16(const u8* p) { return (u16)p[0] | ((u16)p[1] << 8); }
static inline u32 rd32(const u8* p) {
  return (u32)p[0] | ((u32)p[1] << 8) | ((u32)p[2] << 16) | ((u32)p[3] << 24);
}
static inline u64 rd64(const u8* p) {
  u64 v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  return v;
}
static inline void wr16(u8* p, u32 v) { p[0] = (u8)v; p[1] = (u8)(v >> 8); }
static inline void wr32(u8* p, u32 v) {
  p[0] = (u8)v; p[1] = (u8)(v >> 8); p[2] = (u8)(v >> 16); p[3] = (u8)(v >> 24);
}

static inline u64 splitmix64(u64 x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// -- packed descriptor (protocol/txn.py txn_pack layout) ---------------------

struct Instr { u8 prog; u16 acct_cnt, data_sz, acct_off, data_off; };
struct Lut { u16 addr_off, wcnt, rcnt, woff, roff; };

struct Desc {
  u8 version, sig_cnt;
  u16 sig_off, msg_off;
  u8 ro_signed, ro_unsigned, acct_cnt;
  u16 acct_off, bh_off;
  u8 lut_cnt, adtl_w, adtl, instr_cnt;
  Instr instrs[INSTR_MAX];
  Lut luts[LUT_MAX];
};

// parse + the txn_desc_valid structural checks against payload_sz
// (protocol/txn.py: an untrusted trailer must pass this before use)
static bool desc_parse_valid(const u8* b, u64 n, u64 psz, Desc& d) {
  if (n < 17) return false;
  d.version = b[0]; d.sig_cnt = b[1];
  d.sig_off = rd16(b + 2); d.msg_off = rd16(b + 4);
  d.ro_signed = b[6]; d.ro_unsigned = b[7]; d.acct_cnt = b[8];
  d.acct_off = rd16(b + 9); d.bh_off = rd16(b + 11);
  d.lut_cnt = b[13]; d.adtl_w = b[14]; d.adtl = b[15]; d.instr_cnt = b[16];
  if (d.instr_cnt > INSTR_MAX || d.lut_cnt > LUT_MAX) return false;
  if (n != 17ull + 9ull * d.instr_cnt + 10ull * d.lut_cnt) return false;
  const u8* p = b + 17;
  for (u32 k = 0; k < d.instr_cnt; k++, p += 9) {
    d.instrs[k].prog = p[0];
    d.instrs[k].acct_cnt = rd16(p + 1);
    d.instrs[k].data_sz = rd16(p + 3);
    d.instrs[k].acct_off = rd16(p + 5);
    d.instrs[k].data_off = rd16(p + 7);
  }
  for (u32 k = 0; k < d.lut_cnt; k++, p += 10) {
    d.luts[k].addr_off = rd16(p);
    d.luts[k].wcnt = rd16(p + 2);
    d.luts[k].rcnt = rd16(p + 4);
    d.luts[k].woff = rd16(p + 6);
    d.luts[k].roff = rd16(p + 8);
  }
  // txn_desc_valid
  if (d.sig_cnt < 1 || d.sig_cnt > SIG_MAX) return false;
  if (d.acct_cnt < d.sig_cnt || d.acct_cnt > ACCT_ADDR_MAX) return false;
  if (d.ro_signed >= d.sig_cnt) return false;
  if ((u32)d.sig_cnt + d.ro_unsigned > d.acct_cnt) return false;
  if ((u32)d.acct_cnt + d.adtl > ACCT_ADDR_MAX) return false;
  if (d.adtl_w > d.adtl) return false;
  if ((u64)d.sig_off + 64ull * d.sig_cnt > psz) return false;
  if ((u64)d.msg_off + 1 > psz) return false;
  if ((u64)d.acct_off + 32ull * d.acct_cnt > psz) return false;
  if ((u64)d.bh_off + 32 > psz) return false;
  for (u32 k = 0; k < d.instr_cnt; k++) {
    const Instr& in = d.instrs[k];
    if (!(in.prog > 0 && in.prog < d.acct_cnt)) return false;
    if ((u64)in.acct_off + in.acct_cnt > psz) return false;
    if ((u64)in.data_off + in.data_sz > psz) return false;
  }
  for (u32 k = 0; k < d.lut_cnt; k++) {
    const Lut& l = d.luts[k];
    if ((u64)l.addr_off + 32 > psz) return false;
    if ((u64)l.woff + l.wcnt > psz) return false;
    if ((u64)l.roff + l.rcnt > psz) return false;
  }
  return true;
}

// Txn.is_writable over STATIC indices (protocol/txn.py)
static inline bool is_writable_static(const Desc& d, u32 idx) {
  if (idx < d.sig_cnt) return idx < (u32)(d.sig_cnt - d.ro_signed);
  return idx < (u32)(d.acct_cnt - d.ro_unsigned);
}
// ...and over the full loaded range (statics + ALT-loaded), for the
// cost model's writable_cnt (pack/cost.py compute_cost)
static inline bool is_writable_total(const Desc& d, u32 idx) {
  if (idx < d.acct_cnt) return is_writable_static(d, idx);
  return idx < (u32)(d.acct_cnt + d.adtl_w);
}

// -- cost model (pack/cost.py compute_cost, exact port) ----------------------

constexpr u32 CBP_SET_CU = 1;
constexpr u32 CBP_SET_FEE = 2;
constexpr u32 CBP_SET_HEAP = 4;
constexpr u32 CBP_SET_TOTAL_FEE = 8;

struct Cost {
  u64 total;
  u128 rewards;       // FEE_PER_SIGNATURE*sig_cnt + priority fee
  bool is_simple_vote;
};

// false = malformed compute-budget instruction -> txn must be dropped
static bool compute_cost(const u8* payload, u64 psz, const Desc& d, Cost& out) {
  u64 writable_cnt = 0;
  u32 total_accts = (u32)d.acct_cnt + d.adtl;
  for (u32 i = 0; i < total_accts; i++)
    writable_cnt += is_writable_total(d, i) ? 1 : 0;

  u64 instr_data_sz = 0;
  u64 builtin_cost = 0;
  u64 non_builtin_cnt = 0;
  u64 vote_instr_cnt = 0;
  u32 cbp_flags = 0;
  u64 cbp_instr_cnt = 0;
  u64 cbp_cu = 0, cbp_total_fee = 0, cbp_heap = 0;
  u64 cbp_price = 0;

  for (u32 k = 0; k < d.instr_cnt; k++) {
    const Instr& in = d.instrs[k];
    instr_data_sz += in.data_sz;
    // python: addrs[program_id] if in range else None -> cost 0
    int bi = -1;
    if (in.prog < d.acct_cnt) {
      const u8* pk = payload + d.acct_off + 32ull * in.prog;
      for (int j = 0; j < N_BUILTINS; j++)
        if (std::memcmp(pk, BUILTINS[j].key, 32) == 0) { bi = j; break; }
    }
    u64 per_instr = bi >= 0 ? BUILTINS[bi].cost : 0;
    builtin_cost += per_instr;
    non_builtin_cnt += per_instr == 0 ? 1 : 0;
    // python slices payload[data_off:data_off+data_sz], which CLAMPS
    u64 doff = in.data_off, dlen = in.data_sz;
    if (doff > psz) { doff = psz; }
    if (doff + dlen > psz) dlen = psz - doff;
    const u8* data = payload + doff;
    if (bi == BI_CB) {
      // _cbp_parse (pack/cost.py): duplicate/size/range rejection
      if (dlen < 5) return false;
      u8 tag = data[0];
      if (tag == 0) {  // RequestUnitsDeprecated
        if (dlen != 9 || (cbp_flags & (CBP_SET_CU | CBP_SET_FEE))) return false;
        cbp_cu = rd32(data + 1);
        cbp_total_fee = rd32(data + 5);
        if (cbp_cu > MAX_CU_LIMIT) return false;
        cbp_flags |= CBP_SET_CU | CBP_SET_FEE | CBP_SET_TOTAL_FEE;
      } else if (tag == 1) {  // RequestHeapFrame
        if (dlen != 5 || (cbp_flags & CBP_SET_HEAP)) return false;
        cbp_heap = rd32(data + 1);
        if (cbp_heap % HEAP_FRAME_GRANULARITY) return false;
        if (cbp_heap < DEFAULT_HEAP_SIZE || cbp_heap > MAX_HEAP_SIZE)
          return false;
        cbp_flags |= CBP_SET_HEAP;
      } else if (tag == 2) {  // SetComputeUnitLimit
        if (dlen != 5 || (cbp_flags & CBP_SET_CU)) return false;
        cbp_cu = rd32(data + 1);
        if (cbp_cu > MAX_CU_LIMIT) return false;
        cbp_flags |= CBP_SET_CU;
      } else if (tag == 3) {  // SetComputeUnitPrice
        if (dlen != 9 || (cbp_flags & CBP_SET_FEE)) return false;
        cbp_price = rd64(data + 1);
        cbp_flags |= CBP_SET_FEE;
      } else {
        return false;
      }
      cbp_instr_cnt++;
    } else if (bi == BI_ED25519 || bi == BI_KECCAK) {
      // precompile sig counting feeds nothing the scheduler uses; the
      // byte read is kept clamped (python would raise on a descriptor
      // whose data_off is out of range — verify-built descs never are)
      (void)0;
    }
    if (bi == BI_VOTE) vote_instr_cnt++;
  }

  u64 instr_data_cost = instr_data_sz / INV_COST_PER_INSTR_DATA_BYTE;
  // _cbp_finalize
  u64 cu_limit;
  if (!(cbp_flags & CBP_SET_CU)) {
    cu_limit = ((u64)d.instr_cnt - cbp_instr_cnt) * DEFAULT_INSTR_CU_LIMIT;
  } else {
    cu_limit = cbp_cu;
  }
  if (cu_limit > MAX_CU_LIMIT) cu_limit = MAX_CU_LIMIT;
  u128 fee;
  if (cbp_flags & CBP_SET_TOTAL_FEE) {
    fee = cbp_total_fee;
  } else {
    // ceil(cu_limit * price / 1e6): cu<=2^21, price<=2^64 -> fits u128
    u128 num = (u128)cu_limit * (u128)cbp_price;
    fee = (num + MICRO_LAMPORTS_PER_LAMPORT - 1) / MICRO_LAMPORTS_PER_LAMPORT;
  }
  u64 nb_cap = MAX_CU_LIMIT / DEFAULT_INSTR_CU_LIMIT;
  if (non_builtin_cnt > nb_cap) non_builtin_cnt = nb_cap;
  u64 non_builtin_cost;
  if ((cbp_flags & CBP_SET_CU) && non_builtin_cnt > 0) {
    non_builtin_cost = cu_limit;
  } else {
    non_builtin_cost = non_builtin_cnt * DEFAULT_INSTR_CU_LIMIT;
  }

  out.total = COST_PER_SIGNATURE * d.sig_cnt
            + COST_PER_WRITABLE_ACCT * writable_cnt
            + builtin_cost + instr_data_cost + non_builtin_cost;
  out.rewards = (u128)FEE_PER_SIGNATURE * d.sig_cnt + fee;
  out.is_simple_vote = vote_instr_cnt == 1 && d.instr_cnt == 1;
  return true;
}

// -- interned account table --------------------------------------------------
//
// Every 32-byte address the pool has ever seen gets a stable id; the
// per-account state (reader/writer bank masks, per-block write cost,
// per-schedule transient marks) lives in flat arrays indexed by id, so
// conflict checks are integer ops (the bitset role of fd_pack_bitset.h).

struct AcctTable {
  std::vector<u8> keys;          // 32 bytes per id
  std::vector<u64> writer_mask;  // bank bits holding a write lock
  std::vector<u64> reader_mask;  // bank bits holding a read lock
  std::vector<u64> write_cost;   // per-block cumulative write cost
  std::vector<u64> taken_gen;    // == cur gen: touched by current microblock
  std::vector<u8> taken_flags;   // bit0 taken_w, bit1 taken_r (valid @ gen)
  std::vector<u64> mb_cost_gen;
  std::vector<u64> mb_write_cost;  // within-microblock write cost (valid @ gen)
  std::vector<u32> slots;        // open-addressed id+1 table, 0 = empty
  u64 mask = 0;

  void init(u64 cap_pow2) {
    slots.assign(cap_pow2, 0);
    mask = cap_pow2 - 1;
  }
  u64 hash(const u8* k) const {
    u64 h;
    std::memcpy(&h, k, 8);       // addresses are uniformly distributed
    return splitmix64(h ^ rd64(k + 8));
  }
  u32 intern(const u8* k) {
    u64 i = hash(k) & mask;
    while (slots[i]) {
      u32 id = slots[i] - 1;
      if (std::memcmp(&keys[32ull * id], k, 32) == 0) return id;
      i = (i + 1) & mask;
    }
    u32 id = (u32)(keys.size() / 32);
    keys.insert(keys.end(), k, k + 32);
    writer_mask.push_back(0);
    reader_mask.push_back(0);
    write_cost.push_back(0);
    taken_gen.push_back(0);
    taken_flags.push_back(0);
    mb_cost_gen.push_back(0);
    mb_write_cost.push_back(0);
    slots[i] = id + 1;
    if (keys.size() / 32 * 2 > slots.size()) grow();
    return id;
  }
  void grow() {
    std::vector<u32> old;
    old.swap(slots);
    slots.assign(old.size() * 2, 0);
    mask = slots.size() - 1;
    for (u32 s : old) {
      if (!s) continue;
      u64 i = hash(&keys[32ull * (s - 1)]) & mask;
      while (slots[i]) i = (i + 1) & mask;
      slots[i] = s;
    }
  }
};

// -- pool txn + treap --------------------------------------------------------

constexpr u64 FRAG_MAX = 4096;  // vd link mtu; payload<=1232 + desc + 2

struct ARef { u32 id; u8 flags; };  // flags: 1=sw (static writable),
                                    //        2=lr (readonly), 4=lw (lock)
constexpr u8 AF_SW = 1, AF_LR = 2, AF_LW = 4;

struct Node {
  int l = -1, r = -1;
  u64 prio = 0;        // deterministic heap priority (splitmix of seq)
  u64 seq = 0;         // insertion order: the insort_right tiebreak
  u128 rewards = 0;
  u64 cost = 1;
  bool is_vote = false;
  u64 tsorig = 0;
  u32 frag_len = 0;
  u16 payload_sz = 0;
  u8 sig[64];
  u16 n_accts = 0;
  ARef accts[2 * ACCT_ADDR_MAX];
  u8 frag[FRAG_MAX];
};

// priority order: rewards/cost DESC, then seq ASC (bisect.insort_right
// over _RatioKey -- pack/scheduler.py sort_key); "less" = schedules first
static inline bool node_lt(const Node& a, const Node& b) {
  u128 x = a.rewards * b.cost;
  u128 y = b.rewards * a.cost;
  if (x != y) return x > y;
  return a.seq < b.seq;
}
// ratio-only strict compare (Python's _RatioKey.__lt__, used by the
// eviction decisions where seq does NOT tie-break)
static inline bool ratio_lt(const Node& a, const Node& b) {
  return a.rewards * b.cost > b.rewards * a.cost;
}

struct Treap {
  int root = -1;
  u64 size = 0;

  // all operations work over a shared slab (Pack::nodes)
  void insert(std::vector<Node>& ns, int id) {
    root = ins(ns, root, id);
    size++;
  }
  int ins(std::vector<Node>& ns, int t, int id) {
    if (t < 0) return id;
    if (node_lt(ns[id], ns[t])) {
      int nl = ins(ns, ns[t].l, id);
      ns[t].l = nl;
      if (ns[nl].prio > ns[t].prio) return rot_r(ns, t);
    } else {
      int nr = ins(ns, ns[t].r, id);
      ns[t].r = nr;
      if (ns[nr].prio > ns[t].prio) return rot_l(ns, t);
    }
    return t;
  }
  int rot_r(std::vector<Node>& ns, int t) {
    int l = ns[t].l;
    ns[t].l = ns[l].r;
    ns[l].r = t;
    return l;
  }
  int rot_l(std::vector<Node>& ns, int t) {
    int r = ns[t].r;
    ns[t].r = ns[r].l;
    ns[r].l = t;
    return r;
  }
  void erase(std::vector<Node>& ns, int id) {
    root = del(ns, root, id);
    size--;
  }
  int del(std::vector<Node>& ns, int t, int id) {
    if (t < 0) return -1;  // not found (never happens: keys are unique)
    if (t == id) return merge(ns, ns[t].l, ns[t].r);
    if (node_lt(ns[id], ns[t]))
      ns[t].l = del(ns, ns[t].l, id);
    else
      ns[t].r = del(ns, ns[t].r, id);
    return t;
  }
  int merge(std::vector<Node>& ns, int a, int b) {
    if (a < 0) return b;
    if (b < 0) return a;
    if (ns[a].prio > ns[b].prio) {
      ns[a].r = merge(ns, ns[a].r, b);
      return a;
    }
    ns[b].l = merge(ns, a, ns[b].l);
    return b;
  }
  int worst(const std::vector<Node>& ns) const {  // lowest priority = rightmost
    int t = root;
    if (t < 0) return -1;
    while (ns[t].r >= 0) t = ns[t].r;
    return t;
  }
};

// -- signature map (64-byte first sig -> node id) ----------------------------

struct SigMap {
  std::vector<u8> keys;    // 64 bytes per slot
  std::vector<int> vals;   // node id, -2 = empty, -3 = tombstone
  u64 mask;

  void init(u64 cap_pow2) {
    keys.assign(64 * cap_pow2, 0);
    vals.assign(cap_pow2, -2);
    mask = cap_pow2 - 1;
    live = 0;
    used = 0;
  }
  u64 live = 0, used = 0;
  u64 hash(const u8* s) const { return splitmix64(rd64(s) ^ rd64(s + 32)); }
  int find(const u8* s) const {
    u64 i = hash(s) & mask;
    while (vals[i] != -2) {
      if (vals[i] != -3 && std::memcmp(&keys[64 * i], s, 64) == 0)
        return vals[i];
      i = (i + 1) & mask;
    }
    return -1;
  }
  void put(const u8* s, int id) {
    u64 i = hash(s) & mask;
    while (vals[i] != -2 && vals[i] != -3) i = (i + 1) & mask;
    if (vals[i] == -2) used++;
    std::memcpy(&keys[64 * i], s, 64);
    vals[i] = id;
    live++;
    if (used * 2 > mask + 1) rehash();
  }
  void del(const u8* s) {
    u64 i = hash(s) & mask;
    while (vals[i] != -2) {
      if (vals[i] != -3 && std::memcmp(&keys[64 * i], s, 64) == 0) {
        vals[i] = -3;
        live--;
        return;
      }
      i = (i + 1) & mask;
    }
  }
  void rehash() {
    std::vector<u8> ok;
    std::vector<int> ov;
    ok.swap(keys);
    ov.swap(vals);
    u64 cap = (mask + 1) * (live * 4 > mask + 1 ? 2 : 1);
    init(cap);
    for (u64 i = 0; i < ov.size(); i++)
      if (ov[i] >= 0) put(&ok[64 * i], ov[i]);
  }
};

// -- the pack object ---------------------------------------------------------

typedef int (*tcache_insert_fn)(void*, u64);

struct Pack {
  u64 bank_cnt, depth, max_txn_per_mb, max_search;
  u64 lim_cost, lim_vote_cost, lim_write_cost, lim_data;
  std::vector<Node> nodes;
  std::vector<int> free_ids;
  Treap pending, pending_votes;
  SigMap sigs;
  AcctTable accts;
  std::vector<std::vector<std::pair<u32, u8>>> bank_accts;  // (id, was_write)
  u64 cost_used = 0, vote_cost_used = 0, data_bytes_used = 0;
  u64 seq_next = 0;
  u64 mb_gen = 0;
  // fused dedup: the facade wires the EXISTING fd_tcache.so table in
  void* tcache = nullptr;
  tcache_insert_fn tcache_insert = nullptr;
};

static int alloc_node(Pack& P) {
  if (!P.free_ids.empty()) {
    int id = P.free_ids.back();
    P.free_ids.pop_back();
    return id;
  }
  P.nodes.emplace_back();
  return (int)P.nodes.size() - 1;
}

// pool membership sets of one txn (pack/scheduler.py OrdTxn.acct_sets):
// unique (id, flags) refs where sw = static writable, lr = static
// readonly, lw = sw + every referenced lookup-table ADDRESS (ALT-loaded
// accounts cannot resolve pre-execution, so the table address itself
// write-locks -- two txns loading from one table serialize)
static void build_acct_refs(Pack& P, Node& n, const u8* payload,
                            const Desc& d) {
  n.n_accts = 0;
  auto add = [&](const u8* key, u8 flag) {
    u32 id = P.accts.intern(key);
    for (u32 i = 0; i < n.n_accts; i++) {
      if (n.accts[i].id == id) {
        n.accts[i].flags |= flag;
        return;
      }
    }
    n.accts[n.n_accts++] = ARef{id, flag};
  };
  for (u32 i = 0; i < d.acct_cnt; i++) {
    const u8* a = payload + d.acct_off + 32ull * i;
    if (is_writable_static(d, i))
      add(a, AF_SW | AF_LW);
    else
      add(a, AF_LR);
  }
  for (u32 k = 0; k < d.lut_cnt; k++)
    add(payload + d.luts[k].addr_off, AF_LW);
}

static void pool_remove(Pack& P, int id) {
  Node& n = P.nodes[id];
  (n.is_vote ? P.pending_votes : P.pending).erase(P.nodes, id);
  P.sigs.del(n.sig);
  P.free_ids.push_back(id);
}

static u8 insert_one(Pack& P, const u8* frag, u32 frag_len, u64 tag,
                     u64 tsorig) {
  // fused dedup FIRST: the python lane's dedup stage consumes the tag
  // before pack ever validates the frag (runtime/dedup.py order)
  if (P.tcache_insert && P.tcache && tag) {
    if (P.tcache_insert(P.tcache, tag)) return INS_DUP;
  }
  if (frag_len < 2 + 17 + 1 || frag_len > FRAG_MAX) return INS_BAD_FRAG;
  u32 psz = rd16(frag + frag_len - 2);
  if (psz > TXN_MTU || (u64)psz + 17 + 2 > frag_len) return INS_BAD_FRAG;
  const u8* payload = frag;
  const u8* desc_b = frag + psz;
  u64 desc_sz = frag_len - 2 - psz;
  Desc d;
  if (!desc_parse_valid(desc_b, desc_sz, psz, d)) return INS_BAD_FRAG;
  Cost c;
  if (!compute_cost(payload, psz, d, c)) return INS_REJECT;
  const u8* sig = payload + d.sig_off;
  if (P.sigs.find(sig) >= 0) return INS_SIG_DUP;

  int id = alloc_node(P);
  Node& n = P.nodes[id];
  n.l = n.r = -1;
  n.seq = P.seq_next++;
  n.prio = splitmix64(n.seq ^ 0x5ca1ab1eull);
  n.rewards = c.rewards;
  n.cost = c.total < 1 ? 1 : c.total;  // _RatioKey clamps c to >= 1
  n.is_vote = c.is_simple_vote;
  n.tsorig = tsorig;
  n.frag_len = frag_len;
  n.payload_sz = (u16)psz;
  std::memcpy(n.sig, sig, 64);
  std::memcpy(n.frag, frag, frag_len);
  build_acct_refs(P, n, payload, d);

  if (P.pending.size + P.pending_votes.size >= P.depth) {
    // full: evict the GLOBALLY lowest-priority txn iff the newcomer
    // strictly beats it (both pools' tails; ratio-only compare, the
    // pending pool's tail wins ties -- pack/scheduler.py insert)
    int wp = P.pending.worst(P.nodes);
    int wv = P.pending_votes.worst(P.nodes);
    int worst = wp;
    if (worst < 0) worst = wv;
    else if (wv >= 0 && ratio_lt(P.nodes[wp], P.nodes[wv])) worst = wv;
    if (worst < 0 || !ratio_lt(n, P.nodes[worst])) {
      P.free_ids.push_back(id);
      return INS_FULL;
    }
    pool_remove(P, worst);
  }
  (n.is_vote ? P.pending_votes : P.pending).insert(P.nodes, id);
  P.sigs.put(n.sig, id);
  return INS_OK;
}

}  // namespace

extern "C" {

void* fd_pack_new(u64 bank_cnt, u64 depth, u64 max_txn_per_mb, u64 max_search,
                  u64 max_cost, u64 max_vote_cost, u64 max_write_cost,
                  u64 max_data) {
  if (bank_cnt == 0 || bank_cnt > 62 || depth == 0) return nullptr;
  Pack* P = new (std::nothrow) Pack();
  if (!P) return nullptr;
  P->bank_cnt = bank_cnt;
  P->depth = depth;
  P->max_txn_per_mb = max_txn_per_mb;
  P->max_search = max_search;
  P->lim_cost = max_cost;
  P->lim_vote_cost = max_vote_cost;
  P->lim_write_cost = max_write_cost;
  P->lim_data = max_data;
  P->nodes.reserve(depth + 1);
  u64 cap = 16;
  while (cap < depth * 4) cap <<= 1;
  P->sigs.init(cap);
  P->accts.init(cap);
  P->bank_accts.resize(bank_cnt);
  return P;
}

void fd_pack_delete(void* h) { delete static_cast<Pack*>(h); }

// Wire the fused-dedup probe: `tcache` is an fd_tcache.so handle and
// `insert_fn` the address of its tcache_insert (the facade resolves
// both via ctypes, so ONE tcache structure serves both lanes).
void fd_pack_set_tcache(void* h, void* tcache, void* insert_fn) {
  Pack* P = static_cast<Pack*>(h);
  P->tcache = tcache;
  P->tcache_insert = reinterpret_cast<tcache_insert_fn>(insert_fn);
}

// One crossing per burst: `buf` holds n entries of
//   u16 frag_len | u64 tag | u64 tsorig | frag bytes
// out_codes[i] gets the per-frag INS_* result.  Returns entries
// consumed, or -1 on a malformed buffer.  out_pending (optional) gets
// the post-burst pool size, so the facade never pays a separate
// crossing just to know whether scheduling is worth attempting.
i64 fd_pack_insert_burst(void* h, const u8* buf, u64 buf_sz, u64 n,
                         u8* out_codes, u64* out_pending) {
  Pack* P = static_cast<Pack*>(h);
  u64 o = 0;
  for (u64 i = 0; i < n; i++) {
    if (o + 18 > buf_sz) return -1;
    u32 frag_len = rd16(buf + o);
    u64 tag = rd64(buf + o + 2);
    u64 tsorig = rd64(buf + o + 10);
    o += 18;
    if (o + frag_len > buf_sz) return -1;
    out_codes[i] = insert_one(*P, buf + o, frag_len, tag, tsorig);
    o += frag_len;
  }
  if (out_pending) *out_pending = P->pending.size + P->pending_votes.size;
  return (i64)n;
}

u64 fd_pack_pending_cnt(void* h) {
  Pack* P = static_cast<Pack*>(h);
  return P->pending.size + P->pending_votes.size;
}

// Deadline load-shedding (slot-clock degraded mode): drop up to n of the
// lowest-priority pending REGULAR txns (the treap tail, same end the
// delete-worst eviction trims; votes are consensus traffic and are never
// shed).  Returns how many were shed; *out_pending reports the post-op
// pool size so the stage's policy checks stay zero-FFI, matching the
// insert/schedule crossings.
u64 fd_pack_shed(void* h, u64 n, u64* out_pending) {
  Pack* P = static_cast<Pack*>(h);
  u64 shed = 0;
  while (shed < n) {
    int w = P->pending.worst(P->nodes);
    if (w < 0) break;
    pool_remove(*P, w);
    shed++;
  }
  if (out_pending) *out_pending = P->pending.size + P->pending_votes.size;
  return shed;
}

// Block accounting peek (tests): cost_used, vote_cost_used, data_bytes_used.
void fd_pack_block_state(void* h, u64* out3) {
  Pack* P = static_cast<Pack*>(h);
  out3[0] = P->cost_used;
  out3[1] = P->vote_cost_used;
  out3[2] = P->data_bytes_used;
}

static i64 schedule_impl(Pack* P, u64 bank, int votes, u32 mb_seq, u8* out,
                         u64 out_cap, u64* meta3) {
  if (bank >= P->bank_cnt) return -1;
  Treap& pool = votes ? P->pending_votes : P->pending;
  P->mb_gen++;
  u64 gen = P->mb_gen;
  u64 other = ~(1ull << bank);

  std::vector<int> chosen;
  chosen.reserve(P->max_txn_per_mb < 256 ? P->max_txn_per_mb : 256);
  u64 n_chosen = 0;
  u64 mb_cost = 0, mb_vote_cost = 0, mb_data = 0;

  // in-order scan with bounded lookahead (pack/scheduler.py
  // schedule_next_microblock): skipped entries keep their order for
  // free; `limit` binds the scan only once something was chosen, so an
  // all-unschedulable WINDOW cannot starve schedulable txns past it
  u64 limit = pool.size < P->max_search ? pool.size : P->max_search;
  std::vector<int> stack_v;
  stack_v.reserve(64);
  int sp = 0;
  int t = pool.root;
  u64 i = 0;
  while ((t >= 0 || sp > 0) && n_chosen < P->max_txn_per_mb) {
    while (t >= 0) {
      if (sp == (int)stack_v.size()) stack_v.push_back(t);
      else stack_v[sp] = t;
      sp++;
      t = P->nodes[t].l;
    }
    int cur = stack_v[--sp];
    t = P->nodes[cur].r;
    if (i >= limit && n_chosen) break;
    i++;
    Node& n = P->nodes[cur];
    // conflicts with in-flight banks + within this microblock, then the
    // block limits including cost already chosen within the microblock
    bool bad = false;
    for (u32 a = 0; a < n.n_accts && !bad; a++) {
      const ARef& r = n.accts[a];
      u64 wm = P->accts.writer_mask[r.id];
      u64 rm = P->accts.reader_mask[r.id];
      u8 taken = P->accts.taken_gen[r.id] == gen ? P->accts.taken_flags[r.id]
                                                 : 0;
      if (r.flags & AF_LW) {
        if (((wm | rm) & other) || taken) bad = true;
      } else if (r.flags & AF_LR) {
        if ((wm & other) || (taken & 1)) bad = true;
      }
    }
    if (!bad) {
      // _fits_block
      if (P->cost_used + mb_cost + n.cost > P->lim_cost) bad = true;
      if (!bad && votes &&
          P->vote_cost_used + mb_vote_cost + n.cost > P->lim_vote_cost)
        bad = true;
      if (!bad && P->data_bytes_used + mb_data + n.payload_sz +
                      MICROBLOCK_DATA_OVERHEAD > P->lim_data)
        bad = true;
      if (!bad) {
        for (u32 a = 0; a < n.n_accts && !bad; a++) {
          const ARef& r = n.accts[a];
          if (!(r.flags & AF_SW)) continue;
          u64 mbwc = P->accts.mb_cost_gen[r.id] == gen
                         ? P->accts.mb_write_cost[r.id]
                         : 0;
          if (P->accts.write_cost[r.id] + mbwc + n.cost > P->lim_write_cost)
            bad = true;
        }
      }
    }
    if (bad) continue;
    // chosen: mark within-microblock taken/cost state
    chosen.push_back(cur);
    n_chosen++;
    mb_cost += n.cost;
    if (votes) mb_vote_cost += n.cost;
    mb_data += n.payload_sz;
    for (u32 a = 0; a < n.n_accts; a++) {
      const ARef& r = n.accts[a];
      u8 tf = P->accts.taken_gen[r.id] == gen ? P->accts.taken_flags[r.id] : 0;
      if (r.flags & AF_LW) tf |= 1;
      if (r.flags & AF_LR) tf |= 2;
      P->accts.taken_gen[r.id] = gen;
      P->accts.taken_flags[r.id] = tf;
      if (r.flags & AF_SW) {
        u64 mbwc =
            P->accts.mb_cost_gen[r.id] == gen ? P->accts.mb_write_cost[r.id] : 0;
        P->accts.mb_cost_gen[r.id] = gen;
        P->accts.mb_write_cost[r.id] = mbwc + n.cost;
      }
    }
  }
  if (!n_chosen) {
    meta3[0] = meta3[1] = meta3[2] = 0;
    return 0;
  }

  // commit: remove from pool, take locks, update block accounting, and
  // write the frame (pack/scheduler.py commit + runtime/pack_stage._emit)
  u64 need = 6;
  for (u64 k = 0; k < n_chosen; k++) need += 2 + P->nodes[chosen[k]].frag_len;
  if (need > out_cap) return -2;
  wr32(out, mb_seq);
  wr16(out + 4, (u32)n_chosen);
  u64 o = 6;
  u64 cu = 0;
  u64 tsorig = 0;
  for (u64 k = 0; k < n_chosen; k++) {
    Node& n = P->nodes[chosen[k]];
    wr16(out + o, n.frag_len);
    o += 2;
    std::memcpy(out + o, n.frag, n.frag_len);
    o += n.frag_len;
    cu += n.cost;
    // the microblock inherits its OLDEST txn's origin stamp
    u64 ts = n.tsorig;
    if (tsorig && ts) tsorig = ts < tsorig ? ts : tsorig;
    else if (!tsorig) tsorig = ts;
    for (u32 a = 0; a < n.n_accts; a++) {
      const ARef& r = n.accts[a];
      if (r.flags & AF_LW) {
        P->accts.writer_mask[r.id] |= 1ull << bank;
        P->bank_accts[bank].emplace_back(r.id, 1);
      }
      if (r.flags & AF_LR) {
        P->accts.reader_mask[r.id] |= 1ull << bank;
        P->bank_accts[bank].emplace_back(r.id, 0);
      }
      if (r.flags & AF_SW) P->accts.write_cost[r.id] += n.cost;
    }
    P->cost_used += n.cost;
    if (votes) P->vote_cost_used += n.cost;
    P->data_bytes_used += n.payload_sz;
    pool_remove(*P, chosen[k]);
  }
  P->data_bytes_used += MICROBLOCK_DATA_OVERHEAD;
  meta3[0] = n_chosen;
  meta3[1] = cu;
  meta3[2] = tsorig;
  return (i64)o;
}

// Schedule one conflict-free microblock for `bank` and write the
// complete microblock FRAME (u32 mb_seq | u16 cnt | (u16 len||frag)*)
// into out.  votes: 0 = regular pool, 1 = vote pool, 2 = regular THEN
// votes in one crossing (the pack stage's fallback order).
// meta4 = [txn_cnt, cu_consumed, inherited tsorig, pending after].
// Returns frame length, 0 = nothing schedulable, -1 bad args, -2 cap.
i64 fd_pack_schedule(void* h, u64 bank, int votes, u32 mb_seq, u8* out,
                     u64 out_cap, u64* meta4) {
  Pack* P = static_cast<Pack*>(h);
  i64 rc;
  if (votes == 2) {
    rc = schedule_impl(P, bank, 0, mb_seq, out, out_cap, meta4);
    if (rc == 0) rc = schedule_impl(P, bank, 1, mb_seq, out, out_cap, meta4);
  } else {
    rc = schedule_impl(P, bank, votes, mb_seq, out, out_cap, meta4);
  }
  meta4[3] = P->pending.size + P->pending_votes.size;
  return rc;
}

void fd_pack_microblock_done(void* h, u64 bank) {
  Pack* P = static_cast<Pack*>(h);
  if (bank >= P->bank_cnt) return;
  for (auto& aw : P->bank_accts[bank]) {
    if (aw.second)
      P->accts.writer_mask[aw.first] &= ~(1ull << bank);
    else
      P->accts.reader_mask[aw.first] &= ~(1ull << bank);
  }
  P->bank_accts[bank].clear();
}

void fd_pack_end_block(void* h) {
  Pack* P = static_cast<Pack*>(h);
  P->cost_used = 0;
  P->vote_cost_used = 0;
  P->data_bytes_used = 0;
  std::memset(P->accts.write_cost.data(), 0,
              P->accts.write_cost.size() * sizeof(u64));
  for (u64 b = 0; b < P->bank_cnt; b++) fd_pack_microblock_done(h, b);
}

// Differential probe for the cost model (tests/test_torch_pack_native.py
// fuzzes this against pack/cost.py compute_cost): out4 = [total cost,
// rewards lo64, rewards hi64, is_simple_vote].  Returns 0 ok, -1 the
// descriptor fails validation, -2 malformed compute budget.
i64 fd_pack_cost_probe(const u8* payload, u64 psz, const u8* desc_b,
                       u64 desc_sz, u64* out4) {
  Desc d;
  if (!desc_parse_valid(desc_b, desc_sz, psz, d)) return -1;
  Cost c;
  if (!compute_cost(payload, psz, d, c)) return -2;
  out4[0] = c.total;
  out4[1] = (u64)c.rewards;
  out4[2] = (u64)(c.rewards >> 64);
  out4[3] = c.is_simple_vote ? 1 : 0;
  return 0;
}

}  // extern "C"
