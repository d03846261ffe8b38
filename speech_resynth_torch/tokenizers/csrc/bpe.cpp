// C++ BPE trainer + encoder for speech-unit unicode corpora.
//
// The port's copy of speech_resynth_tpu/tokenizers/csrc/bpe.cpp. Capability
// parity with the HF `tokenizers` (Rust) BPE the reference uses
// (speechlm/tokenize.py:16-35 there): Tokenizer(BPE()) with no
// pre-tokenizer/normalizer (each input line is one "word"), BpeTrainer with a
// fixed initial_alphabet and target vocab_size.
//
// Training algorithm (mirrors the Rust trainer's semantics so merge order —
// and therefore token ids — are reproducible):
//   1. count identical lines as weighted words
//   2. alphabet = chars seen + initial_alphabet, sorted by code point,
//      assigned ids in sorted order
//   3. repeatedly merge the most frequent adjacent pair; ties broken by the
//      smaller (left_id, right_id) pair; pair counts updated incrementally
//      with a lazy max-heap
// Encoding: lowest-merge-rank-first pair contraction within each word.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <queue>
#include <set>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// UTF-8 <-> code points
// ---------------------------------------------------------------------------

std::vector<uint32_t> decode_utf8(const std::string& s) {
  std::vector<uint32_t> out;
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    uint32_t cp = 0;
    int extra = 0;
    if (c < 0x80) {
      cp = c;
    } else if ((c >> 5) == 0x6) {
      cp = c & 0x1F;
      extra = 1;
    } else if ((c >> 4) == 0xE) {
      cp = c & 0x0F;
      extra = 2;
    } else if ((c >> 3) == 0x1E) {
      cp = c & 0x07;
      extra = 3;
    } else {
      ++i;  // invalid byte; skip
      continue;
    }
    if (i + extra >= s.size()) break;
    for (int j = 1; j <= extra; ++j) cp = (cp << 6) | (s[i + j] & 0x3F);
    out.push_back(cp);
    i += extra + 1;
  }
  return out;
}

std::string encode_utf8(uint32_t cp) {
  std::string out;
  if (cp < 0x80) {
    out += static_cast<char>(cp);
  } else if (cp < 0x800) {
    out += static_cast<char>(0xC0 | (cp >> 6));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += static_cast<char>(0xE0 | (cp >> 12));
    out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  } else {
    out += static_cast<char>(0xF0 | (cp >> 18));
    out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
    out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  }
  return out;
}

// ---------------------------------------------------------------------------
// model
// ---------------------------------------------------------------------------

struct Model {
  std::vector<std::string> vocab;                         // id -> token string
  std::unordered_map<std::string, uint32_t> token_to_id;  // token -> id
  // merge (a, b) -> (rank, new_id)
  std::map<std::pair<uint32_t, uint32_t>, std::pair<uint32_t, uint32_t>> merges;
  std::vector<std::pair<uint32_t, uint32_t>> merge_list;  // rank order
};

using Pair = std::pair<uint32_t, uint32_t>;

struct HeapEntry {
  uint64_t count;
  Pair pair;
  // max-heap: higher count first; tie -> smaller pair
  bool operator<(const HeapEntry& o) const {
    if (count != o.count) return count < o.count;
    return pair > o.pair;  // smaller pair should come out first
  }
};

struct Word {
  std::vector<uint32_t> syms;
  uint64_t count;
};

void count_pairs_in_word(const Word& w, size_t word_idx,
                         std::map<Pair, int64_t>& pair_counts,
                         std::map<Pair, std::set<size_t>>& where) {
  for (size_t i = 0; i + 1 < w.syms.size(); ++i) {
    Pair p{w.syms[i], w.syms[i + 1]};
    pair_counts[p] += w.count;
    where[p].insert(word_idx);
  }
}

Model train_bpe(const std::vector<std::string>& lines,
                const std::vector<uint32_t>& initial_alphabet,
                uint32_t vocab_size) {
  Model model;

  // 1. word counts (whole lines; no pre-tokenizer)
  std::unordered_map<std::string, uint64_t> word_counts;
  for (const auto& l : lines) word_counts[l] += 1;

  // 2. alphabet: chars in corpus + initial alphabet, sorted by code point
  std::set<uint32_t> alphabet(initial_alphabet.begin(), initial_alphabet.end());
  for (const auto& [w, c] : word_counts)
    for (uint32_t cp : decode_utf8(w)) alphabet.insert(cp);

  std::unordered_map<uint32_t, uint32_t> cp_to_id;
  for (uint32_t cp : alphabet) {
    cp_to_id[cp] = model.vocab.size();
    std::string tok = encode_utf8(cp);
    model.token_to_id[tok] = model.vocab.size();
    model.vocab.push_back(tok);
  }

  // 3. words as symbol sequences
  std::vector<Word> words;
  words.reserve(word_counts.size());
  for (const auto& [w, c] : word_counts) {
    Word word;
    word.count = c;
    for (uint32_t cp : decode_utf8(w)) word.syms.push_back(cp_to_id[cp]);
    words.push_back(std::move(word));
  }

  // 4. initial pair statistics
  std::map<Pair, int64_t> pair_counts;
  std::map<Pair, std::set<size_t>> where;
  for (size_t i = 0; i < words.size(); ++i)
    count_pairs_in_word(words[i], i, pair_counts, where);

  std::priority_queue<HeapEntry> heap;
  for (const auto& [p, c] : pair_counts)
    if (c > 0) heap.push({static_cast<uint64_t>(c), p});

  // 5. merge loop with lazy heap invalidation
  while (model.vocab.size() < vocab_size && !heap.empty()) {
    HeapEntry top = heap.top();
    heap.pop();
    auto it = pair_counts.find(top.pair);
    int64_t current = (it == pair_counts.end()) ? 0 : it->second;
    if (current <= 0) continue;
    if (static_cast<uint64_t>(current) != top.count) {
      // stale entry: reinsert with the fresh count
      heap.push({static_cast<uint64_t>(current), top.pair});
      continue;
    }

    Pair best = top.pair;
    uint32_t new_id = model.vocab.size();
    std::string new_tok = model.vocab[best.first] + model.vocab[best.second];
    model.token_to_id[new_tok] = new_id;
    model.vocab.push_back(new_tok);
    model.merges[best] = {static_cast<uint32_t>(model.merge_list.size()), new_id};
    model.merge_list.push_back(best);

    // apply merge in every word containing the pair; update counts
    std::set<size_t> touched = where[best];
    std::set<Pair> changed;
    for (size_t wi : touched) {
      Word& w = words[wi];
      std::vector<uint32_t> out;
      out.reserve(w.syms.size());
      size_t i = 0;
      bool merged_any = false;
      while (i < w.syms.size()) {
        if (i + 1 < w.syms.size() && w.syms[i] == best.first &&
            w.syms[i + 1] == best.second) {
          out.push_back(new_id);
          i += 2;
          merged_any = true;
        } else {
          out.push_back(w.syms[i]);
          ++i;
        }
      }
      if (!merged_any) continue;
      // remove old pair contributions, add new
      for (size_t j = 0; j + 1 < w.syms.size(); ++j) {
        Pair p{w.syms[j], w.syms[j + 1]};
        pair_counts[p] -= w.count;
        changed.insert(p);
      }
      w.syms = std::move(out);
      for (size_t j = 0; j + 1 < w.syms.size(); ++j) {
        Pair p{w.syms[j], w.syms[j + 1]};
        pair_counts[p] += w.count;
        where[p].insert(wi);
        changed.insert(p);
      }
    }
    pair_counts[best] = 0;
    for (const Pair& p : changed) {
      int64_t c = pair_counts[p];
      if (c > 0) heap.push({static_cast<uint64_t>(c), p});
    }
  }

  return model;
}

std::vector<uint32_t> encode_word(const Model& model, const std::string& text) {
  std::vector<uint32_t> syms;
  for (uint32_t cp : decode_utf8(text)) {
    auto it = model.token_to_id.find(encode_utf8(cp));
    if (it != model.token_to_id.end()) syms.push_back(it->second);
    // unknown chars are dropped (BPE() has no unk token in the reference)
  }
  if (syms.size() < 2) return syms;

  // repeatedly apply the lowest-rank merge present
  while (true) {
    uint32_t best_rank = UINT32_MAX;
    size_t best_pos = 0;
    for (size_t i = 0; i + 1 < syms.size(); ++i) {
      auto it = model.merges.find({syms[i], syms[i + 1]});
      if (it != model.merges.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_pos = i;
      }
    }
    if (best_rank == UINT32_MAX) break;
    Pair p{syms[best_pos], syms[best_pos + 1]};
    uint32_t new_id = model.merges.at(p).second;
    std::vector<uint32_t> out;
    out.reserve(syms.size() - 1);
    size_t i = 0;
    while (i < syms.size()) {
      if (i + 1 < syms.size() && syms[i] == p.first && syms[i + 1] == p.second) {
        out.push_back(new_id);
        i += 2;
      } else {
        out.push_back(syms[i]);
        ++i;
      }
    }
    syms = std::move(out);
  }
  return syms;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* bpe_train_from_lines(const char** lines, uint64_t n_lines,
                           const uint32_t* initial_alphabet, uint64_t n_alpha,
                           uint32_t vocab_size) {
  std::vector<std::string> corpus;
  corpus.reserve(n_lines);
  for (uint64_t i = 0; i < n_lines; ++i) corpus.emplace_back(lines[i]);
  std::vector<uint32_t> alpha(initial_alphabet, initial_alphabet + n_alpha);
  Model* m = new Model(train_bpe(corpus, alpha, vocab_size));
  return m;
}

void bpe_free(void* handle) { delete static_cast<Model*>(handle); }

uint32_t bpe_vocab_size(void* handle) {
  return static_cast<Model*>(handle)->vocab.size();
}

// token string for id; returns length, copies up to buf_len bytes
uint32_t bpe_token(void* handle, uint32_t id, char* buf, uint32_t buf_len) {
  Model* m = static_cast<Model*>(handle);
  if (id >= m->vocab.size()) return 0;
  const std::string& t = m->vocab[id];
  uint32_t n = std::min<uint32_t>(t.size(), buf_len);
  std::memcpy(buf, t.data(), n);
  return static_cast<uint32_t>(t.size());
}

uint64_t bpe_num_merges(void* handle) {
  return static_cast<Model*>(handle)->merge_list.size();
}

void bpe_merge(void* handle, uint64_t rank, uint32_t* left, uint32_t* right) {
  Model* m = static_cast<Model*>(handle);
  *left = m->merge_list[rank].first;
  *right = m->merge_list[rank].second;
}

// encode text; writes up to out_cap ids, returns true length
uint64_t bpe_encode(void* handle, const char* text, uint32_t* out,
                    uint64_t out_cap) {
  Model* m = static_cast<Model*>(handle);
  std::vector<uint32_t> ids = encode_word(*m, text);
  uint64_t n = std::min<uint64_t>(ids.size(), out_cap);
  for (uint64_t i = 0; i < n; ++i) out[i] = ids[i];
  return ids.size();
}

// rebuild a model from (vocab strings, merges) — for loading saved tokenizers
void* bpe_from_vocab(const char** tokens, uint64_t n_tokens,
                     const uint32_t* merge_pairs, uint64_t n_merges) {
  Model* m = new Model();
  for (uint64_t i = 0; i < n_tokens; ++i) {
    m->vocab.emplace_back(tokens[i]);
    m->token_to_id[tokens[i]] = static_cast<uint32_t>(i);
  }
  for (uint64_t r = 0; r < n_merges; ++r) {
    uint32_t a = merge_pairs[2 * r], b = merge_pairs[2 * r + 1];
    const std::string merged = m->vocab[a] + m->vocab[b];
    auto it = m->token_to_id.find(merged);
    if (it == m->token_to_id.end()) {
      delete m;
      return nullptr;
    }
    m->merges[{a, b}] = {static_cast<uint32_t>(r), it->second};
    m->merge_list.push_back({a, b});
  }
  return m;
}

}  // extern "C"
