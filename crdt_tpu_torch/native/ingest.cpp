// The port's native host runtime (own copy of the JAX package's
// native/ingest.cpp): string interning, op-batch packing and the gossip
// wire store, all host-side string work in front of every device merge.
//
// The ingestion path (reference: AddCommand JSON handling + the gossip
// unmarshal loop, main.go:178-187, 241-256) is host-side string work that
// sits in front of every device op; Python dict/regex costs dominate at
// high offered load, so the hot pieces live here:
//
//   * Interner  — open-addressing FNV-1a hash table, string <-> dense id,
//                 arena-backed storage (ids are stable, lookups O(1));
//   * GoInt     — exact strconv.Atoi semantics (sign + decimal digits,
//                 int32-bounded to match the device dtype policy);
//   * OpBatch   — SoA int32 columns (ts, rid, seq, key, val, payload,
//                 is_num) ready to wrap as numpy arrays;
//   * WireStore — the op->command map with a direct-to-JSON gossip
//                 payload emitter.
//
// Exposed as a C ABI for ctypes (no pybind11).  Built by g++ at first use
// (crdt_tpu_torch/native/__init__.py) into a library whose file name
// carries a hash of this source and the flags, so a changed source is
// rebuilt and a stale binary is never loaded.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

struct Arena {
  std::vector<char> data;
  std::vector<uint32_t> offsets;  // id -> offset; length from next offset
  std::vector<uint32_t> lengths;

  uint32_t add(const char* s, uint32_t len) {
    offsets.push_back(static_cast<uint32_t>(data.size()));
    lengths.push_back(len);
    data.insert(data.end(), s, s + len);
    return static_cast<uint32_t>(offsets.size() - 1);
  }
};

uint64_t fnv1a(const char* s, uint32_t len) {
  uint64_t h = 1469598103934665603ull;
  for (uint32_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ull;
  }
  return h;
}

struct Interner {
  // open addressing, power-of-two capacity; slot stores id+1 (0 = empty)
  std::vector<uint32_t> slots;
  Arena arena;
  size_t n = 0;

  Interner() : slots(1024, 0) {}

  void grow() {
    std::vector<uint32_t> old;
    old.swap(slots);
    slots.assign(old.size() * 2, 0);
    for (uint32_t s1 : old) {
      if (!s1) continue;
      uint32_t id = s1 - 1;
      place(arena.data.data() + arena.offsets[id], arena.lengths[id], id);
    }
  }

  void place(const char* s, uint32_t len, uint32_t id) {
    size_t mask = slots.size() - 1;
    size_t i = fnv1a(s, len) & mask;
    while (slots[i]) i = (i + 1) & mask;
    slots[i] = id + 1;
  }

  // read-only probe: id or -1, never inserts
  int32_t find(const char* s, uint32_t len) const {
    size_t mask = slots.size() - 1;
    size_t i = fnv1a(s, len) & mask;
    while (slots[i]) {
      uint32_t id = slots[i] - 1;
      if (arena.lengths[id] == len &&
          std::memcmp(arena.data.data() + arena.offsets[id], s, len) == 0) {
        return static_cast<int32_t>(id);
      }
      i = (i + 1) & mask;
    }
    return -1;
  }

  int32_t intern(const char* s, uint32_t len) {
    if (n * 2 >= slots.size()) grow();
    size_t mask = slots.size() - 1;
    size_t i = fnv1a(s, len) & mask;
    while (slots[i]) {
      uint32_t id = slots[i] - 1;
      if (arena.lengths[id] == len &&
          std::memcmp(arena.data.data() + arena.offsets[id], s, len) == 0) {
        return static_cast<int32_t>(id);
      }
      i = (i + 1) & mask;
    }
    uint32_t id = arena.add(s, len);
    slots[i] = id + 1;
    ++n;
    return static_cast<int32_t>(id);
  }
};

// Go strconv.Atoi, bounded to int32 (utils/intern.py parse_go_int).
bool parse_go_int(const char* s, uint32_t len, int32_t* out) {
  if (len == 0) return false;
  uint32_t i = 0;
  bool neg = false;
  if (s[0] == '+' || s[0] == '-') {
    neg = s[0] == '-';
    if (len == 1) return false;
    i = 1;
  }
  int64_t v = 0;
  for (; i < len; ++i) {
    if (s[i] < '0' || s[i] > '9') return false;
    v = v * 10 + (s[i] - '0');
    if (v > (1ll << 40)) return false;  // early overflow cut, exact below
  }
  if (neg) v = -v;
  if (v < INT32_MIN || v > INT32_MAX) return false;
  *out = static_cast<int32_t>(v);
  return true;
}

struct OpBatch {
  std::vector<int32_t> ts, rid, seq, key, val, payload;
  std::vector<uint8_t> is_num;
};

// Gossip wire store: the op->command map mirrored in native memory, with a
// direct-to-JSON payload emitter (the gossip SERVING hot path — the
// reference marshals its whole treemap per request, main.go:159).  Keys
// are (absolute-ms ts, rid, seq); values are interner-id pairs so the
// emitter pulls raw strings straight from the interner arenas.
struct WireStore {
  using Ident = std::tuple<int64_t, int32_t, int32_t>;
  std::map<Ident, std::vector<std::pair<int32_t, int32_t>>> ops;  // sorted
  std::string buf;  // last emitted payload (stable until the next emit)
};

void json_escape_append(std::string& out, const char* s, int32_t len) {
  for (int32_t i = 0; i < len; ++i) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char tmp[8];
          std::snprintf(tmp, sizeof tmp, "\\u%04x", c);
          out += tmp;
        } else {
          out += static_cast<char>(c);  // UTF-8 passes through byte-wise
        }
    }
  }
}

}  // namespace

extern "C" {

void* crdt_interner_new() { return new Interner(); }
void crdt_interner_free(void* p) { delete static_cast<Interner*>(p); }
int32_t crdt_intern(void* p, const char* s, int32_t len) {
  return static_cast<Interner*>(p)->intern(s, static_cast<uint32_t>(len));
}
int32_t crdt_interner_size(void* p) {
  return static_cast<int32_t>(static_cast<Interner*>(p)->n);
}
int32_t crdt_interner_find(void* p, const char* s, int32_t len) {
  return static_cast<Interner*>(p)->find(s, static_cast<uint32_t>(len));
}
// Returns pointer into the arena (valid until the next grow-free op: the
// arena never relocates per-string data, only appends).
const char* crdt_lookup(void* p, int32_t id, int32_t* len_out) {
  Interner* t = static_cast<Interner*>(p);
  if (id < 0 || static_cast<size_t>(id) >= t->arena.offsets.size()) {
    *len_out = -1;
    return nullptr;
  }
  *len_out = static_cast<int32_t>(t->arena.lengths[id]);
  return t->arena.data.data() + t->arena.offsets[id];
}

int32_t crdt_parse_go_int(const char* s, int32_t len, int32_t* out) {
  return parse_go_int(s, static_cast<uint32_t>(len), out) ? 1 : 0;
}

void* crdt_batch_new() { return new OpBatch(); }
void crdt_batch_free(void* p) { delete static_cast<OpBatch*>(p); }
void crdt_batch_clear(void* p) {
  OpBatch* b = static_cast<OpBatch*>(p);
  b->ts.clear(); b->rid.clear(); b->seq.clear(); b->key.clear();
  b->val.clear(); b->payload.clear(); b->is_num.clear();
}

// Append one (key, value) op row: interns both strings, parses the value.
void crdt_batch_add(void* batch, void* keys_interner, void* vals_interner,
                    int32_t ts, int32_t rid, int32_t seq,
                    const char* k, int32_t klen,
                    const char* v, int32_t vlen) {
  OpBatch* b = static_cast<OpBatch*>(batch);
  b->ts.push_back(ts);
  b->rid.push_back(rid);
  b->seq.push_back(seq);
  b->key.push_back(crdt_intern(keys_interner, k, klen));
  b->payload.push_back(crdt_intern(vals_interner, v, vlen));
  int32_t num = 0;
  bool ok = parse_go_int(v, static_cast<uint32_t>(vlen), &num);
  b->val.push_back(ok ? num : 0);
  b->is_num.push_back(ok ? 1 : 0);
}

int32_t crdt_batch_size(void* p) {
  return static_cast<int32_t>(static_cast<OpBatch*>(p)->ts.size());
}
// Column accessors (zero-copy views; valid until the next add/clear/free).
int32_t* crdt_batch_ts(void* p) { return static_cast<OpBatch*>(p)->ts.data(); }
int32_t* crdt_batch_rid(void* p) { return static_cast<OpBatch*>(p)->rid.data(); }
int32_t* crdt_batch_seq(void* p) { return static_cast<OpBatch*>(p)->seq.data(); }
int32_t* crdt_batch_key(void* p) { return static_cast<OpBatch*>(p)->key.data(); }
int32_t* crdt_batch_val(void* p) { return static_cast<OpBatch*>(p)->val.data(); }
int32_t* crdt_batch_payload(void* p) { return static_cast<OpBatch*>(p)->payload.data(); }
uint8_t* crdt_batch_is_num(void* p) { return static_cast<OpBatch*>(p)->is_num.data(); }

// ---- wire store ----

void* crdt_wire_new() { return new WireStore(); }
void crdt_wire_free(void* p) { delete static_cast<WireStore*>(p); }

// Add one command's (key_id, val_id) pairs under identity (ts, rid, seq).
// Returns 1 if the identity was fresh, 0 for a duplicate (union no-op).
int32_t crdt_wire_add(void* p, int64_t ts_abs, int32_t rid, int32_t seq,
                      int32_t n, const int32_t* key_ids,
                      const int32_t* val_ids) {
  WireStore* w = static_cast<WireStore*>(p);
  auto [it, fresh] = w->ops.try_emplace({ts_abs, rid, seq});
  if (!fresh) return 0;
  it->second.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    it->second.emplace_back(key_ids[i], val_ids[i]);
  }
  return 1;
}

// Add n commands in one call: command i is identity (ts_abs[i], rid[i],
// seq[i]) with counts[i] (key_id, val_id) pairs, taken in order from
// key_ids/val_ids.  Returns how many identities were fresh.
int32_t crdt_wire_add_many(void* p, int32_t n, const int64_t* ts_abs,
                           const int32_t* rid, const int32_t* seq,
                           const int32_t* counts, const int32_t* key_ids,
                           const int32_t* val_ids) {
  int32_t fresh = 0;
  int64_t off = 0;
  for (int32_t i = 0; i < n; ++i) {
    fresh += crdt_wire_add(p, ts_abs[i], rid[i], seq[i], counts[i],
                           key_ids + off, val_ids + off);
    off += counts[i];
  }
  return fresh;
}

int32_t crdt_wire_remove(void* p, int64_t ts_abs, int32_t rid, int32_t seq) {
  return static_cast<WireStore*>(p)->ops.erase({ts_abs, rid, seq}) ? 1 : 0;
}

int32_t crdt_wire_size(void* p) {
  return static_cast<int32_t>(static_cast<WireStore*>(p)->ops.size());
}

// Emit the gossip payload JSON: {"ts:rid:seq": {"key": "value", ...}, ...}
// in identity order.  With have_vv, ops covered by the requester's version
// vector (rid >= 0 and seq <= vv[rid]) are skipped — delta gossip; rid < 0
// (foreign/Go-format) ops are always shipped, like the Python path.
// The returned pointer is owned by the store, valid until the next emit.
const char* crdt_wire_payload(void* p, void* keys_interner,
                              void* vals_interner, int32_t have_vv,
                              const int32_t* vv_rids, const int32_t* vv_seqs,
                              int32_t n_vv, int32_t* len_out) {
  WireStore* w = static_cast<WireStore*>(p);
  Interner* ki = static_cast<Interner*>(keys_interner);
  Interner* vi = static_cast<Interner*>(vals_interner);
  std::unordered_map<int32_t, int32_t> vv;
  for (int32_t i = 0; i < n_vv; ++i) vv[vv_rids[i]] = vv_seqs[i];

  std::string& out = w->buf;
  out.clear();
  out += '{';
  bool first = true;
  char ident[64];
  for (const auto& [id, kvs] : w->ops) {
    const auto& [ts, rid, seq] = id;
    if (have_vv && rid >= 0) {
      auto it = vv.find(rid);
      if (it != vv.end() && seq <= it->second) continue;  // covered
    }
    if (!first) out += ',';
    first = false;
    std::snprintf(ident, sizeof ident, "\"%lld:%d:%d\":{",
                  static_cast<long long>(ts), rid, seq);
    out += ident;
    bool kfirst = true;
    for (const auto& [kid, vid] : kvs) {
      if (!kfirst) out += ',';
      kfirst = false;
      out += '"';
      json_escape_append(out, ki->arena.data.data() + ki->arena.offsets[kid],
                         static_cast<int32_t>(ki->arena.lengths[kid]));
      out += "\":\"";
      json_escape_append(out, vi->arena.data.data() + vi->arena.offsets[vid],
                         static_cast<int32_t>(vi->arena.lengths[vid]));
      out += '"';
    }
    out += '}';
  }
  out += '}';
  *len_out = static_cast<int32_t>(out.size());
  return out.data();
}

}  // extern "C"
