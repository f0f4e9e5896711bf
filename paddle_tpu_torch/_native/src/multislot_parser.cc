// MultiSlot text parser: the native data-feed hot path of the port
// (paddle_tpu_torch/_native; the same parser and the same C interface as
// the JAX package's paddle_tpu/_native/src/multislot_parser.cc).
//
// Reference: paddle/fluid/framework/data_feed.cc
// MultiSlotDataFeed::ParseOneInstance (data_feed.h:663). Each line of a
// training text file holds, per declared slot, a count followed by that
// many values (uint64 ids for sparse slots, floats for dense slots):
//
//   <n0> v v v <n1> v v <n2> v ...
//
// Python-side parsing cannot feed the card, so the parse happens here, in
// C++ called through ctypes: the call releases the GIL, so a Python thread
// pool parses files in parallel. The output is the packed ragged form
// (values + row_splits per slot) that io/fleet_dataset.py batches from.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (paddle_tpu_torch/_native/
// __init__.py, at first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct SlotBuf {
  bool is_float = false;
  std::vector<int64_t> ids;
  std::vector<float> floats;
  std::vector<int64_t> splits;  // rows + 1 offsets
};

struct ParseResult {
  std::vector<SlotBuf> slots;
  int64_t rows = 0;
  std::string error;
};

// strtod/strtoull-based scanner; one pass, no allocations per token.
bool parse_buffer(const char* data, size_t len,
                  const std::vector<bool>& slot_is_float, ParseResult* out) {
  const int n_slots = static_cast<int>(slot_is_float.size());
  out->slots.resize(n_slots);
  for (int s = 0; s < n_slots; ++s) {
    out->slots[s].is_float = slot_is_float[s];
    out->slots[s].splits.push_back(0);
  }
  const char* p = data;
  const char* end = data + len;
  while (p < end) {
    // skip blank lines
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    for (int s = 0; s < n_slots; ++s) {
      char* next = nullptr;
      long long n = strtoll(p, &next, 10);
      if (next == p || n < 0) {
        out->error = "bad slot count at row " + std::to_string(out->rows) +
                     " slot " + std::to_string(s);
        return false;
      }
      p = next;
      SlotBuf& sb = out->slots[s];
      for (long long i = 0; i < n; ++i) {
        if (sb.is_float) {
          float v = strtof(p, &next);
          if (next == p) {
            out->error = "bad float at row " + std::to_string(out->rows);
            return false;
          }
          sb.floats.push_back(v);
        } else {
          long long v = strtoll(p, &next, 10);
          if (next == p) {
            out->error = "bad id at row " + std::to_string(out->rows);
            return false;
          }
          sb.ids.push_back(static_cast<int64_t>(v));
        }
        p = next;
      }
      sb.splits.push_back(sb.is_float
                              ? static_cast<int64_t>(sb.floats.size())
                              : static_cast<int64_t>(sb.ids.size()));
    }
    out->rows += 1;
    while (p < end && *p != '\n') ++p;  // to end of line
  }
  return true;
}

}  // namespace

extern "C" {

// slot_types: comma-separated "uint64"/"float". Returns handle or null.
void* pt_parse_multislot_file(const char* path, const char* slot_types) {
  std::vector<bool> is_float;
  {
    std::string t(slot_types);
    size_t start = 0;
    while (start <= t.size()) {
      size_t comma = t.find(',', start);
      std::string tok = t.substr(
          start, comma == std::string::npos ? std::string::npos
                                            : comma - start);
      if (!tok.empty()) is_float.push_back(tok == "float");
      if (comma == std::string::npos) break;
      start = comma + 1;
    }
  }
  if (is_float.empty()) return nullptr;

  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  size_t got = fread(&buf[0], 1, static_cast<size_t>(size), f);
  fclose(f);

  auto* res = new ParseResult();
  if (!parse_buffer(buf.data(), got, is_float, res)) {
    // keep handle so the error is readable; rows stays partial
  }
  return res;
}

long long pt_ms_rows(void* h) {
  return static_cast<ParseResult*>(h)->rows;
}

const char* pt_ms_error(void* h) {
  return static_cast<ParseResult*>(h)->error.c_str();
}

long long pt_ms_slot_total(void* h, int slot) {
  SlotBuf& sb = static_cast<ParseResult*>(h)->slots[slot];
  return sb.is_float ? static_cast<long long>(sb.floats.size())
                     : static_cast<long long>(sb.ids.size());
}

void pt_ms_copy_splits(void* h, int slot, int64_t* out) {
  SlotBuf& sb = static_cast<ParseResult*>(h)->slots[slot];
  memcpy(out, sb.splits.data(), sb.splits.size() * sizeof(int64_t));
}

void pt_ms_copy_f32(void* h, int slot, float* out) {
  SlotBuf& sb = static_cast<ParseResult*>(h)->slots[slot];
  memcpy(out, sb.floats.data(), sb.floats.size() * sizeof(float));
}

void pt_ms_copy_i64(void* h, int slot, int64_t* out) {
  SlotBuf& sb = static_cast<ParseResult*>(h)->slots[slot];
  memcpy(out, sb.ids.data(), sb.ids.size() * sizeof(int64_t));
}

void pt_ms_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
