// Native WordPiece tokenizer: the port's copy of
// openvision_tpu/native/wordpiece.cpp, built by native/build.py.
//
// The hot path of data/tokenizer.py's WordPieceTokenizer.encode (BERT
// BasicTokenizer, then greedy longest-match WordPiece) for the defaults:
// lower case, [UNK], "##". Semantics are those of the Python path: the
// Unicode category and case tables in unicode_tables.h are generated from
// the running interpreter's own unicodedata (gen_tables.py), so the two
// agree on that interpreter; texts with a capital sigma (str.lower's
// context-dependent final-sigma rule) go to the Python path.
//
// C API (ctypes-friendly, no pybind11 dependency):
//   void* wp_load(const char* vocab_path);       // NULL on failure
//   void  wp_free(void* handle);
//   int   wp_encode(void* h, const char* utf8, int32_t* out, int max_out);
//   int   wp_encode_batch(void* h, const char** texts, int n, int max_out,
//                         int32_t* out /* n*max_out */, int32_t* lens);
//
// Build: g++ -O2 -std=c++17 -fPIC -shared, at first use (native/build.py).

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

bool in_ranges(uint32_t cp, const CpRange* r, int n) {
  int lo = 0, hi = n - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < r[mid].lo) {
      hi = mid - 1;
    } else if (cp > r[mid].hi) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}

bool is_whitespace(uint32_t cp) {
  if (cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r') return true;
  return in_ranges(cp, WS_RANGES, WS_RANGES_N);
}

bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  return in_ranges(cp, CTRL_RANGES, CTRL_RANGES_N);
}

bool is_punct(uint32_t cp) {
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126))
    return true;
  return in_ranges(cp, PUNCT_RANGES, PUNCT_RANGES_N);
}

// Where str.split() ends a word (str.isspace), once the cleanup has turned
// \t, \n, \r and Zs into ' ' and dropped the controls: ' ', and U+2028 and
// U+2029 (Zl, Zp), which are neither.
bool is_split(uint32_t cp) { return cp == ' ' || in_ranges(cp, SPLIT_RANGES, SPLIT_RANGES_N); }

bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

// lower+NFD-strip mapping, generated from Python unicodedata. Identity for
// unmapped codepoints; an entry with out[0]==0 deletes the character
// (pure combining marks).
struct LowerLookup {
  std::unordered_map<uint32_t, const LowerEntry*> map;
  LowerLookup() {
    map.reserve(LOWER_MAP_N * 2);
    for (int i = 0; i < LOWER_MAP_N; ++i) map[LOWER_MAP[i].cp] = &LOWER_MAP[i];
  }
};
const LowerLookup& lower_lookup() {
  static LowerLookup lk;
  return lk;
}

void utf8_decode(const char* s, std::vector<uint32_t>* out) {
  const unsigned char* p = (const unsigned char*)s;
  while (*p) {
    uint32_t cp = 0;
    int extra = 0;
    if (*p < 0x80) {
      cp = *p;
    } else if ((*p >> 5) == 0x6) {
      cp = *p & 0x1F;
      extra = 1;
    } else if ((*p >> 4) == 0xE) {
      cp = *p & 0x0F;
      extra = 2;
    } else if ((*p >> 3) == 0x1E) {
      cp = *p & 0x07;
      extra = 3;
    } else {  // invalid byte → U+FFFD (dropped later, like Python's �)
      cp = 0xFFFD;
    }
    ++p;
    for (int i = 0; i < extra; ++i) {
      if ((*p & 0xC0) != 0x80) {
        cp = 0xFFFD;
        break;
      }
      cp = (cp << 6) | (*p & 0x3F);
      ++p;
    }
    out->push_back(cp);
  }
}

void utf8_encode(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back((char)cp);
  } else if (cp < 0x800) {
    out->push_back((char)(0xC0 | (cp >> 6)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back((char)(0xE0 | (cp >> 12)));
    out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    out->push_back((char)(0xF0 | (cp >> 18)));
    out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  }
}

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id = 100;
  int max_chars_per_word = 100;
};

// basic_tokenize (data/tokenizer.py:53-89): cleanup, CJK isolation,
// whitespace split, per-token lower+strip, punctuation split. Emits words
// as codepoint vectors.
void basic_tokenize(const std::vector<uint32_t>& cps,
                    std::vector<std::vector<uint32_t>>* words) {
  std::vector<uint32_t> cleaned;
  cleaned.reserve(cps.size() + 8);
  for (uint32_t cp : cps) {
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_cjk(cp)) {
      cleaned.push_back(' ');
      cleaned.push_back(cp);
      cleaned.push_back(' ');
    } else if (is_whitespace(cp)) {
      cleaned.push_back(' ');
    } else {
      cleaned.push_back(cp);
    }
  }

  const auto& lmap = lower_lookup().map;
  std::vector<uint32_t> cur;
  auto flush_word = [&](std::vector<uint32_t>& tok) {
    if (tok.empty()) return;
    // lower + NFD-strip via the generated mapping
    std::vector<uint32_t> low;
    low.reserve(tok.size());
    for (uint32_t cp : tok) {
      auto it = lmap.find(cp);
      if (it == lmap.end()) {
        low.push_back(cp);
      } else {
        for (int i = 0; i < 3; ++i) {
          if (it->second->out[i]) low.push_back(it->second->out[i]);
        }
      }
    }
    // punctuation split
    std::vector<uint32_t> piece;
    for (uint32_t cp : low) {
      if (is_punct(cp)) {
        if (!piece.empty()) {
          words->push_back(piece);
          piece.clear();
        }
        words->push_back({cp});
      } else {
        piece.push_back(cp);
      }
    }
    if (!piece.empty()) words->push_back(piece);
    tok.clear();
  };

  for (uint32_t cp : cleaned) {
    if (is_split(cp)) {
      flush_word(cur);
    } else {
      cur.push_back(cp);
    }
  }
  flush_word(cur);
}

// Greedy longest-match-first WordPiece (data/tokenizer.py:118-138).
void wordpiece(const Tokenizer& tk, const std::vector<uint32_t>& word,
               std::vector<int32_t>* out) {
  if ((int)word.size() > tk.max_chars_per_word) {
    out->push_back(tk.unk_id);
    return;
  }
  // byte offsets of each codepoint within the utf8 form
  std::string u8;
  std::vector<size_t> offs;
  for (uint32_t cp : word) {
    offs.push_back(u8.size());
    utf8_encode(cp, &u8);
  }
  offs.push_back(u8.size());

  size_t n = word.size(), start = 0;
  std::vector<int32_t> ids;
  while (start < n) {
    size_t end = n;
    int32_t cur = -1;
    std::string piece;
    while (start < end) {
      piece.assign(start > 0 ? "##" : "");
      piece.append(u8, offs[start], offs[end] - offs[start]);
      auto it = tk.vocab.find(piece);
      if (it != tk.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out->push_back(tk.unk_id);
      return;
    }
    ids.push_back(cur);
    start = end;
  }
  out->insert(out->end(), ids.begin(), ids.end());
}

}  // namespace

extern "C" {

void* wp_load(const char* vocab_path) {
  std::ifstream f(vocab_path);
  if (!f.good()) return nullptr;
  auto* tk = new Tokenizer();
  std::string line;
  int32_t idx = 0;
  // mirror Python's read().split("\n"): keep empty lines as (unusable)
  // vocab slots so ids line up exactly.
  std::string content((std::istreambuf_iterator<char>(f)),
                      std::istreambuf_iterator<char>());
  size_t pos = 0;
  while (pos <= content.size()) {
    size_t nl = content.find('\n', pos);
    if (nl == std::string::npos) nl = content.size();
    std::string tok = content.substr(pos, nl - pos);
    // last-wins on duplicated vocab lines, matching Python dict assignment
    tk->vocab[std::move(tok)] = idx++;
    if (nl == content.size()) break;
    pos = nl + 1;
  }
  auto it = tk->vocab.find("[UNK]");
  if (it == tk->vocab.end()) {
    delete tk;
    return nullptr;
  }
  tk->unk_id = it->second;
  return tk;
}

void wp_free(void* handle) { delete (Tokenizer*)handle; }

int wp_encode(void* handle, const char* utf8, int32_t* out, int max_out) {
  auto* tk = (Tokenizer*)handle;
  std::vector<uint32_t> cps;
  utf8_decode(utf8, &cps);
  std::vector<std::vector<uint32_t>> words;
  basic_tokenize(cps, &words);
  std::vector<int32_t> ids;
  for (const auto& w : words) wordpiece(*tk, w, &ids);
  int n = (int)ids.size();
  int copy = n < max_out ? n : max_out;
  std::memcpy(out, ids.data(), copy * sizeof(int32_t));
  return n;
}

int wp_encode_batch(void* handle, const char** texts, int n, int max_out,
                    int32_t* out, int32_t* lens) {
  for (int i = 0; i < n; ++i) {
    lens[i] = wp_encode(handle, texts[i], out + (size_t)i * max_out, max_out);
  }
  return 0;
}

}  // extern "C"
