// MultiSlot data-feed parser: the reference's high-throughput ingestion
// format (paddle/fluid/framework/data_feed.cc MultiSlotDataFeed).
//
// Line format (reference data_feed.proto / MultiSlotDataFeed::ParseOneInstance):
//   <num><sp><v1>..<vnum>  repeated per slot, e.g.
//   "2 0.5 0.6 3 1 2 3"  = slot0: two floats, slot1: three ints
//
// C API parses a whole text buffer into flat per-slot value/offset arrays
// (CSR layout), which python wraps as ragged batches. This is the hot loop
// of PS-style training ingestion; the channel/queueing stays in python.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct SlotBuf {
  std::vector<float> fvals;
  std::vector<int64_t> ivals;
  std::vector<int64_t> offsets;  // per-instance offsets (CSR), starts with 0
  int is_float = 1;
};

struct ParseResult {
  std::vector<SlotBuf> slots;
  int64_t instances = 0;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

}  // namespace

extern "C" {

// slot_types: 0=float, 1=int64 per slot.
void* df_parse(const char* buf, int64_t len, int num_slots,
               const int* slot_types) {
  auto* res = new ParseResult();
  res->slots.resize(num_slots);
  for (int s = 0; s < num_slots; s++) {
    res->slots[s].is_float = slot_types[s] == 0;
    res->slots[s].offsets.push_back(0);
  }
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* q = p;
    bool ok = true;
    // parse one instance: num_slots groups of "<n> v..."
    std::vector<std::pair<int64_t, const char*>> starts;
    for (int s = 0; s < num_slots && ok; s++) {
      q = skip_ws(q, line_end);
      // strto* skip '\n' themselves, so an exhausted line would silently
      // consume tokens from the NEXT line; bound every parse by line_end.
      if (q >= line_end) { ok = false; break; }
      char* next = nullptr;
      long n = strtol(q, &next, 10);
      if (next == q || n < 0) { ok = false; break; }
      q = next;
      SlotBuf& sb = res->slots[s];
      for (long i = 0; i < n; i++) {
        q = skip_ws(q, line_end);
        if (q >= line_end) { ok = false; break; }
        if (sb.is_float) {
          float v = strtof(q, &next);
          if (next == q) { ok = false; break; }
          sb.fvals.push_back(v);
        } else {
          long long v = strtoll(q, &next, 10);
          if (next == q) { ok = false; break; }
          sb.ivals.push_back((int64_t)v);
        }
        q = next;
      }
    }
    if (ok) {
      for (int s = 0; s < num_slots; s++) {
        SlotBuf& sb = res->slots[s];
        sb.offsets.push_back(sb.is_float ? (int64_t)sb.fvals.size()
                                         : (int64_t)sb.ivals.size());
      }
      res->instances++;
    } else {
      // roll back partial pushes for this line
      for (int s = 0; s < num_slots; s++) {
        SlotBuf& sb = res->slots[s];
        int64_t keep = sb.offsets.back();
        if (sb.is_float) sb.fvals.resize(keep);
        else sb.ivals.resize(keep);
      }
    }
    p = line_end < end ? line_end + 1 : end;
  }
  return res;
}

int64_t df_num_instances(void* h) {
  return static_cast<ParseResult*>(h)->instances;
}

int64_t df_slot_size(void* h, int slot) {
  auto& sb = static_cast<ParseResult*>(h)->slots[slot];
  return sb.is_float ? (int64_t)sb.fvals.size() : (int64_t)sb.ivals.size();
}

void df_copy_slot_fvals(void* h, int slot, float* out) {
  auto& sb = static_cast<ParseResult*>(h)->slots[slot];
  memcpy(out, sb.fvals.data(), sb.fvals.size() * sizeof(float));
}

void df_copy_slot_ivals(void* h, int slot, int64_t* out) {
  auto& sb = static_cast<ParseResult*>(h)->slots[slot];
  memcpy(out, sb.ivals.data(), sb.ivals.size() * sizeof(int64_t));
}

void df_copy_slot_offsets(void* h, int slot, int64_t* out) {
  auto& sb = static_cast<ParseResult*>(h)->slots[slot];
  memcpy(out, sb.offsets.data(), sb.offsets.size() * sizeof(int64_t));
}

void df_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
