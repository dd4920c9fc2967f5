// retr_tpu_torch native WordPiece tokenizer core: a copy of retr_tpu's native/tokenizer.cc
// (the same code; built and loaded by retr_tpu_torch/native/__init__.py).
//
// The reference tokenizes every caption through HuggingFace's (Rust-backed)
// BertTokenizer (data_utils/refcoco.py:93-124). This is the equivalent native
// component for retr_tpu's host pipeline: BERT basic tokenization + greedy
// longest-match WordPiece for ASCII text (RefCOCO captions are ASCII; the Python
// tokenizer remains the general-Unicode fallback and the executable spec —
// tests/test_torch_native.py enforces identical ids on ASCII inputs).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libretr_tokenizer.so tokenizer.cc -lpthread

#include <cctype>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t cls_id = 101, sep_id = 102, pad_id = 0, unk_id = 100;
  int max_chars_per_word = 100;
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
         (c >= 123 && c <= 126);
}

// basic tokenize (ASCII): lowercase, whitespace split, punctuation isolation.
std::vector<std::string> basic_tokenize(const std::string& text) {
  std::vector<std::string> out;
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) {
      out.push_back(cur);
      cur.clear();
    }
  };
  for (unsigned char c : text) {
    if (c == 0 || c >= 128) continue;  // non-ASCII guarded by the Python caller
    // whitespace set matches the Python spec's _is_whitespace exactly:
    // ' ', \t, \n, \r split; other control chars (\v, \f, ...) are dropped.
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      flush();
    } else if (is_ascii_punct(c)) {
      flush();
      out.emplace_back(1, static_cast<char>(c));
    } else if (!std::iscntrl(c)) {
      cur.push_back(static_cast<char>(std::tolower(c)));
    }
  }
  flush();
  return out;
}

void wordpiece(const Tokenizer& tok, const std::string& word,
               std::vector<int32_t>* ids) {
  if (static_cast<int>(word.size()) > tok.max_chars_per_word) {
    ids->push_back(tok.unk_id);
    return;
  }
  std::vector<int32_t> pieces;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = tok.vocab.find(sub);
      if (it != tok.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      ids->push_back(tok.unk_id);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  ids->insert(ids->end(), pieces.begin(), pieces.end());
}

// encode_plus semantics (refcoco.py:114-124): [CLS] pieces [SEP], truncate keeping
// the final [SEP], pad with [PAD] to max_length. Returns true token count.
int encode(const Tokenizer& tok, const char* text, int max_length, int32_t* out) {
  std::vector<int32_t> ids;
  ids.push_back(tok.cls_id);
  for (const auto& w : basic_tokenize(text)) wordpiece(tok, w, &ids);
  ids.push_back(tok.sep_id);
  if (max_length > 0 && static_cast<int>(ids.size()) > max_length) {
    ids.resize(max_length - 1);
    ids.push_back(tok.sep_id);
  }
  int n = static_cast<int>(ids.size());
  for (int i = 0; i < max_length; ++i)
    out[i] = i < n ? ids[i] : tok.pad_id;
  return n;
}

}  // namespace

extern "C" {

void* retr_tok_create(const char* vocab_path) {
  std::ifstream f(vocab_path);
  if (!f.good()) return nullptr;
  auto* tok = new Tokenizer();
  std::string line;
  int32_t idx = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (!line.empty()) tok->vocab.emplace(line, idx);
    ++idx;
  }
  auto find = [&](const char* t, int32_t dflt) {
    auto it = tok->vocab.find(t);
    return it == tok->vocab.end() ? dflt : it->second;
  };
  tok->cls_id = find("[CLS]", 101);
  tok->sep_id = find("[SEP]", 102);
  tok->pad_id = find("[PAD]", 0);
  tok->unk_id = find("[UNK]", 100);
  return tok;
}

void retr_tok_destroy(void* handle) { delete static_cast<Tokenizer*>(handle); }

int retr_tok_encode(void* handle, const char* text, int max_length, int32_t* out) {
  if (!handle) return -1;
  return encode(*static_cast<Tokenizer*>(handle), text, max_length, out);
}

// Batched + threaded: texts are \0-separated in one buffer with offsets.
int retr_tok_encode_batch(void* handle, const char* buf, const int64_t* offsets,
                          int n, int max_length, int32_t* out, int32_t* lengths,
                          int n_threads) {
  if (!handle) return -1;
  auto* tok = static_cast<Tokenizer*>(handle);
  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    for (int i = t; i < n; i += n_threads) {
      lengths[i] = encode(*tok, buf + offsets[i], max_length,
                          out + static_cast<int64_t>(i) * max_length);
    }
  };
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
