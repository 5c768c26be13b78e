// Native CTC prefix beam search with optional ARPA n-gram LM scoring.
//
// TPU-native replacement for the reference's external C++/SWIG
// `paddlespeech_ctcdecoders` (masr/decoders/swig_wrapper.py:1-122):
// offline decode, stateful streaming chunk decode, and a KenLM-style
// shallow-fusion scorer (alpha * log10 P_lm + beta per word) reading
// standard ARPA text files. Exposed through a C ABI for ctypes.
//
// Semantics mirror masr_tpu/decoders/beam_search.py's Python engine
// exactly (shared tests assert agreement).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();
constexpr double kLog10NegInf = -99.0;

inline double log_sum_exp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = std::max(a, b);
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

// ---------------------------------------------------------------------- //
// ARPA backoff n-gram LM over whitespace-free "words" (characters for
// Mandarin LMs, space-delimited words otherwise).
// ---------------------------------------------------------------------- //
struct ArpaLM {
  // key: words joined by '\x01'
  std::unordered_map<std::string, std::pair<float, float>> ngrams;
  int order = 0;

  static std::string join(const std::vector<std::string>& words, size_t start,
                          size_t end) {
    std::string key;
    for (size_t i = start; i < end; ++i) {
      if (i > start) key.push_back('\x01');
      key += words[i];
    }
    return key;
  }

  bool load(const std::string& path) {
    std::ifstream f(path);
    if (!f.is_open()) return false;
    std::string line;
    int section = 0;
    while (std::getline(f, line)) {
      while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
        line.pop_back();
      if (line.empty()) continue;
      if (line[0] == '\\') {
        if (line == "\\end\\") break;
        auto pos = line.find("-grams:");
        if (pos != std::string::npos) {
          section = std::atoi(line.c_str() + 1);
          order = std::max(order, section);
        }
        continue;
      }
      if (section == 0) continue;
      // logp \t w1 w2 ... \t backoff?
      std::istringstream iss(line);
      std::string logp_s;
      if (!std::getline(iss, logp_s, '\t')) continue;
      std::string words_s, backoff_s;
      std::getline(iss, words_s, '\t');
      std::getline(iss, backoff_s, '\t');
      if (words_s.empty()) continue;
      float logp = std::strtof(logp_s.c_str(), nullptr);
      float backoff = backoff_s.empty()
                          ? 0.0f
                          : std::strtof(backoff_s.c_str(), nullptr);
      std::string key;
      key.reserve(words_s.size());
      for (char c : words_s) key.push_back(c == ' ' ? '\x01' : c);
      ngrams.emplace(std::move(key), std::make_pair(logp, backoff));
    }
    return true;
  }

  double log10_cond(const std::vector<std::string>& context,
                    const std::string& word) const {
    size_t max_ctx = order > 1 ? static_cast<size_t>(order - 1) : 0;
    size_t start = context.size() > max_ctx ? context.size() - max_ctx : 0;
    return log10_cond_from(context, start, word);
  }

  double log10_cond_from(const std::vector<std::string>& context, size_t start,
                         const std::string& word) const {
    // full (ctx + word) lookup
    std::string key = join(context, start, context.size());
    std::string full = key.empty() ? word : key + '\x01' + word;
    auto it = ngrams.find(full);
    if (it != ngrams.end()) return it->second.first;
    if (start >= context.size()) {  // unigram fallthrough
      auto unk = ngrams.find("<unk>");
      return unk != ngrams.end() ? unk->second.first : kLog10NegInf;
    }
    // back off: weight of the context, then shorter context
    double backoff = 0.0;
    auto bo = ngrams.find(key);
    if (bo != ngrams.end()) backoff = bo->second.second;
    return backoff + log10_cond_from(context, start + 1, word);
  }
};

struct Scorer {
  ArpaLM lm;
  double alpha = 0.0;
  double beta = 0.0;
  bool character_based = true;

  void detect_character_based() {
    int n = 0, single = 0;
    for (const auto& kv : lm.ngrams) {
      const std::string& k = kv.first;
      if (k.find('\x01') != std::string::npos) continue;
      if (k == "<s>" || k == "</s>" || k == "<unk>") continue;
      ++n;
      // one UTF-8 code point?
      size_t cp = 0;
      for (size_t i = 0; i < k.size();) {
        unsigned char c = k[i];
        i += c < 0x80 ? 1 : (c >> 5) == 0x6 ? 2 : (c >> 4) == 0xE ? 3 : 4;
        ++cp;
      }
      if (cp == 1) ++single;
      if (n >= 200) break;
    }
    character_based = n > 0 && single * 10 > n * 9;
  }

  double score_word(const std::vector<std::string>& context,
                    const std::string& word) const {
    return alpha * lm.log10_cond(context, word) + beta;
  }
};

// ---------------------------------------------------------------------- //
// Prefix beam search
// ---------------------------------------------------------------------- //
struct VecHash {
  size_t operator()(const std::vector<int>& v) const {
    size_t h = 1469598103934665603ull;
    for (int x : v) {
      h ^= static_cast<size_t>(x);
      h *= 1099511628211ull;
    }
    return h;
  }
};

struct BeamEntry {
  double p_b = kNegInf;   // log prob ending in blank
  double p_nb = kNegInf;  // log prob ending in non-blank
  double lm = 0.0;        // accumulated LM score
};

struct Decoder {
  int vocab_size = 0;
  int blank_id = 0;
  int beam_size = 300;
  double cutoff_prob = 0.99;
  int cutoff_top_n = 40;
  const Scorer* scorer = nullptr;
  const std::vector<std::string>* vocab = nullptr;  // UTF-8 tokens
  int space_id = -1;

  std::unordered_map<std::vector<int>, BeamEntry, VecHash> beams;

  void reset() {
    beams.clear();
    BeamEntry root;
    root.p_b = 0.0;
    beams.emplace(std::vector<int>(), root);
  }

  const std::string& tok(int id) const { return (*vocab)[id]; }

  bool is_space(int id) const { return id == space_id; }

  // LM delta for appending token `tid` to `prefix`
  double lm_delta(const std::vector<int>& prefix, int tid) const {
    if (!scorer) return 0.0;
    if (scorer->character_based) {
      if (is_space(tid)) return 0.0;
      std::vector<std::string> ctx;
      ctx.reserve(prefix.size());
      for (int t : prefix)
        if (!is_space(t)) ctx.push_back(tok(t));
      return scorer->score_word(ctx, tok(tid));
    }
    // word-based: score completed word when a space arrives
    if (!is_space(tid)) return 0.0;
    std::vector<std::string> words;
    std::string cur;
    for (int t : prefix) {
      if (is_space(t)) {
        if (!cur.empty()) words.push_back(std::move(cur));
        cur.clear();
      } else {
        cur += tok(t);
      }
    }
    if (!cur.empty()) words.push_back(std::move(cur));
    if (words.empty()) return 0.0;
    std::string last = words.back();
    words.pop_back();
    return scorer->score_word(words, last);
  }

  void step(const float* probs, int T, int V) {
    std::vector<std::pair<float, int>> order(V);
    for (int t = 0; t < T; ++t) {
      const float* frame = probs + static_cast<size_t>(t) * V;
      // top-k pruning within cutoff_prob mass
      for (int v = 0; v < V; ++v) order[v] = {frame[v], v};
      int top_n = std::min(cutoff_top_n, V);
      std::partial_sort(order.begin(), order.begin() + top_n, order.end(),
                        [](auto& a, auto& b) { return a.first > b.first; });
      double csum = 0.0;
      int n_cand = 0;
      for (; n_cand < top_n; ++n_cand) {
        csum += order[n_cand].first;
        if (csum >= cutoff_prob) {
          ++n_cand;
          break;
        }
      }
      n_cand = std::max(n_cand, 1);

      std::unordered_map<std::vector<int>, BeamEntry, VecHash> next;
      next.reserve(beams.size() * 2);
      for (const auto& kv : beams) {
        const std::vector<int>& prefix = kv.first;
        const BeamEntry& e = kv.second;
        double p_tot = log_sum_exp(e.p_b, e.p_nb);
        int last = prefix.empty() ? -1 : prefix.back();
        for (int c = 0; c < n_cand; ++c) {
          int tid = order[c].second;
          double lp = std::log(std::max(
              static_cast<double>(order[c].first), 1e-20));
          if (tid == blank_id) {
            BeamEntry& ne = next[prefix];
            ne.p_b = log_sum_exp(ne.p_b, p_tot + lp);
            ne.lm = e.lm;
            continue;
          }
          if (tid == last) {
            BeamEntry& ne = next[prefix];
            ne.p_nb = log_sum_exp(ne.p_nb, e.p_nb + lp);
            ne.lm = e.lm;
            std::vector<int> np = prefix;
            np.push_back(tid);
            double d = lm_delta(prefix, tid);
            BeamEntry& ne2 = next[np];
            ne2.p_nb = log_sum_exp(ne2.p_nb, e.p_b + lp);
            ne2.lm = e.lm + d;
          } else {
            std::vector<int> np = prefix;
            np.push_back(tid);
            double d = lm_delta(prefix, tid);
            BeamEntry& ne2 = next[np];
            ne2.p_nb = log_sum_exp(ne2.p_nb, p_tot + lp);
            ne2.lm = e.lm + d;
          }
        }
      }
      // prune to beam_size on combined score — select by sorted rank (a
      // threshold test in hash order can drop the best beam on ties)
      if (static_cast<int>(next.size()) > beam_size) {
        std::vector<std::pair<double, const std::vector<int>*>> scored;
        scored.reserve(next.size());
        for (const auto& kv : next)
          scored.emplace_back(
              log_sum_exp(kv.second.p_b, kv.second.p_nb) + kv.second.lm,
              &kv.first);
        std::partial_sort(
            scored.begin(), scored.begin() + beam_size, scored.end(),
            [](auto& a, auto& b) { return a.first > b.first; });
        std::unordered_map<std::vector<int>, BeamEntry, VecHash> pruned;
        pruned.reserve(beam_size * 2);
        for (int i = 0; i < beam_size; ++i)
          pruned.emplace(*scored[i].second, next[*scored[i].second]);
        beams.swap(pruned);
      } else {
        beams.swap(next);
      }
    }
  }

  // best prefix -> (score, token ids)
  std::pair<double, std::vector<int>> result() const {
    double best = kNegInf;
    const std::vector<int>* best_prefix = nullptr;
    for (const auto& kv : beams) {
      double s = log_sum_exp(kv.second.p_b, kv.second.p_nb) + kv.second.lm;
      if (s > best || best_prefix == nullptr) {
        best = s;
        best_prefix = &kv.first;
      }
    }
    return {best, best_prefix ? *best_prefix : std::vector<int>()};
  }
};

std::mutex g_mutex;

}  // namespace

extern "C" {

void* masr_scorer_create(const char* arpa_path, double alpha, double beta) {
  auto* s = new Scorer();
  s->alpha = alpha;
  s->beta = beta;
  if (!s->lm.load(arpa_path)) {
    delete s;
    return nullptr;
  }
  s->detect_character_based();
  return s;
}

int masr_scorer_is_character_based(void* scorer) {
  return static_cast<Scorer*>(scorer)->character_based ? 1 : 0;
}

void masr_scorer_destroy(void* scorer) { delete static_cast<Scorer*>(scorer); }

// vocab: UTF-8 tokens joined by '\n'
void* masr_decoder_create(const char* vocab_joined, int vocab_size,
                          int blank_id, int space_id, int beam_size,
                          double cutoff_prob, int cutoff_top_n,
                          void* scorer) {
  auto* d = new Decoder();
  auto* vocab = new std::vector<std::string>();
  vocab->reserve(vocab_size);
  std::istringstream iss(vocab_joined);
  std::string tokline;
  while (std::getline(iss, tokline)) vocab->push_back(tokline);
  d->vocab = vocab;
  d->vocab_size = vocab_size;
  d->blank_id = blank_id;
  d->space_id = space_id;
  d->beam_size = beam_size;
  d->cutoff_prob = cutoff_prob;
  d->cutoff_top_n = cutoff_top_n;
  d->scorer = static_cast<Scorer*>(scorer);
  d->reset();
  return d;
}

void masr_decoder_reset(void* dec) { static_cast<Decoder*>(dec)->reset(); }

void masr_decoder_step(void* dec, const float* probs, int T, int V) {
  static_cast<Decoder*>(dec)->step(probs, T, V);
}

// fills out_tokens (caller-allocated, max_out) and *score; returns count
int masr_decoder_result(void* dec, int* out_tokens, int max_out,
                        double* score) {
  auto res = static_cast<Decoder*>(dec)->result();
  *score = res.first;
  int n = std::min<int>(res.second.size(), max_out);
  std::memcpy(out_tokens, res.second.data(), n * sizeof(int));
  return n;
}

// top-n prefixes: fills out_tokens (n * max_len, row-major, -1 padded),
// out_lens (n), out_scores (n); returns the number of beams written
int masr_decoder_nbest(void* dec, int n, int* out_tokens, int* out_lens,
                       double* out_scores, int max_len) {
  auto* d = static_cast<Decoder*>(dec);
  std::vector<std::pair<double, const std::vector<int>*>> scored;
  scored.reserve(d->beams.size());
  for (const auto& kv : d->beams)
    scored.emplace_back(
        log_sum_exp(kv.second.p_b, kv.second.p_nb) + kv.second.lm, &kv.first);
  std::sort(scored.begin(), scored.end(),
            [](auto& a, auto& b) { return a.first > b.first; });
  int count = std::min<int>(n, scored.size());
  for (int i = 0; i < count; ++i) {
    const auto& pfx = *scored[i].second;
    int len = std::min<int>(pfx.size(), max_len);
    for (int t = 0; t < max_len; ++t)
      out_tokens[i * max_len + t] = t < len ? pfx[t] : -1;
    out_lens[i] = len;
    out_scores[i] = scored[i].first;
  }
  return count;
}

void masr_decoder_destroy(void* dec) {
  auto* d = static_cast<Decoder*>(dec);
  delete d->vocab;
  delete d;
}

}  // extern "C"
