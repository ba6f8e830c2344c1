/* fastmetrics — C++ acceleration for the caption-metric hot paths.
 *
 * The port's own copy of recnet_tpu/native/fastmetrics.cpp. The reference
 * outsources its metric hot paths to Java jars via subprocess
 * (coco_caption/.../ptbtokenizer.py, meteor.py); the metrics here are pure
 * Python with this optional CPython extension for the O(n*m) inner loops:
 *   - lcs(a, b)              longest-common-subsequence length (ROUGE_L)
 *   - bleu_stats(hyp, refs)  per-image BLEU sufficient statistics
 *                            (testlen, closest reflen, guess[4], correct[4])
 *   - cider_stats(tests, refss)  per-image CIDEr score sums
 * Token sequences are passed as lists of ints (the Python layer interns
 * tokens to ids once per corpus). Every id must lie in [0, 2^31 - 2]: the
 * n-gram keys pack id + 1 into 31 bits a position, so a larger (or
 * negative) id would alias another n-gram; such an id raises ValueError.
 *
 * recnet_tpu_torch/native/__init__.py builds it with g++ at first use;
 * recnet_tpu_torch.metrics falls back to pure Python when it cannot.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <unordered_map>
#include <vector>

namespace {

// the largest token id whose id + 1 fits the 31 bits a position of NgramKey
constexpr int64_t kMaxId = (int64_t{1} << 31) - 2;

bool to_ids(PyObject* list, std::vector<int64_t>* out) {
    if (!PyList_Check(list)) {
        PyErr_SetString(PyExc_TypeError, "expected a list of ints");
        return false;
    }
    Py_ssize_t n = PyList_GET_SIZE(list);
    out->resize(static_cast<size_t>(n));
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject* item = PyList_GET_ITEM(list, i);
        int64_t v = PyLong_AsLongLong(item);
        if (v == -1 && PyErr_Occurred()) return false;
        if (v < 0 || v > kMaxId) {
            PyErr_Format(PyExc_ValueError,
                         "token id %lld is outside [0, %lld]: the n-gram "
                         "keys pack id + 1 into 31 bits",
                         static_cast<long long>(v),
                         static_cast<long long>(kMaxId));
            return false;
        }
        (*out)[static_cast<size_t>(i)] = v;
    }
    return true;
}

int64_t lcs_len(const std::vector<int64_t>& a, const std::vector<int64_t>& b) {
    const std::vector<int64_t>& s = (a.size() >= b.size()) ? a : b;
    const std::vector<int64_t>& t = (a.size() >= b.size()) ? b : a;
    if (t.empty()) return 0;
    std::vector<int64_t> prev(t.size() + 1, 0), cur(t.size() + 1, 0);
    for (size_t i = 1; i <= s.size(); ++i) {
        const int64_t si = s[i - 1];
        for (size_t j = 1; j <= t.size(); ++j) {
            cur[j] = (si == t[j - 1]) ? prev[j - 1] + 1
                                      : std::max(prev[j], cur[j - 1]);
        }
        std::swap(prev, cur);
    }
    return prev[t.size()];
}

PyObject* py_lcs(PyObject*, PyObject* args) {
    PyObject *la, *lb;
    if (!PyArg_ParseTuple(args, "OO", &la, &lb)) return nullptr;
    std::vector<int64_t> a, b;
    if (!to_ids(la, &a) || !to_ids(lb, &b)) return nullptr;
    return PyLong_FromLongLong(lcs_len(a, b));
}

// 4-gram key packed into 128 bits via two 64-bit halves (ids <= kMaxId).
struct NgramKey {
    uint64_t lo, hi;
    bool operator==(const NgramKey& o) const { return lo == o.lo && hi == o.hi; }
};
struct NgramHash {
    size_t operator()(const NgramKey& k) const {
        uint64_t h = k.lo * 0x9E3779B97F4A7C15ull ^ (k.hi + 0x9E3779B97F4A7C15ull + (k.lo << 6));
        return static_cast<size_t>(h ^ (h >> 29));
    }
};

using NgramMap = std::unordered_map<NgramKey, int64_t, NgramHash>;

// Exact packing: to_ids holds every token id to [0, kMaxId]; each half
// holds two (id+1) values of 31 bits, so distinct n-grams never collide.
void count_ngrams(const std::vector<int64_t>& w, int n, NgramMap maps[]) {
    for (int k = 1; k <= n; ++k) {
        NgramMap& m = maps[k - 1];
        if (static_cast<int>(w.size()) < k) continue;
        for (size_t i = 0; i + k <= w.size(); ++i) {
            NgramKey key{0, 0};
            for (int j = 0; j < k; ++j) {
                uint64_t v = static_cast<uint64_t>(w[i + j]) + 1;  // != 0
                if (j < 2) key.lo |= v << (31 * j);
                else       key.hi |= v << (31 * (j - 2));
            }
            m[key] += 1;
        }
    }
}

/* bleu_stats(hyp: List[int], refs: List[List[int]], n=4)
 *   -> (testlen, closest_reflen, guess: List[4], correct: List[4])
 * Matches reference bleu_scorer.py cook_refs/cook_test with the 'closest'
 * effective reference length (ties to the smaller length). */
PyObject* py_bleu_stats(PyObject*, PyObject* args) {
    PyObject *lhyp, *lrefs;
    int n = 4;
    if (!PyArg_ParseTuple(args, "OO|i", &lhyp, &lrefs, &n)) return nullptr;
    if (n < 1 || n > 4) {
        PyErr_SetString(PyExc_ValueError, "n must be in [1,4]");
        return nullptr;
    }
    std::vector<int64_t> hyp;
    if (!to_ids(lhyp, &hyp)) return nullptr;
    if (!PyList_Check(lrefs)) {
        PyErr_SetString(PyExc_TypeError, "refs must be a list of lists");
        return nullptr;
    }

    NgramMap maxcounts[4];
    int64_t testlen = static_cast<int64_t>(hyp.size());
    int64_t best_diff = INT64_MAX, closest = 0;
    Py_ssize_t n_refs = PyList_GET_SIZE(lrefs);
    for (Py_ssize_t r = 0; r < n_refs; ++r) {
        std::vector<int64_t> ref;
        if (!to_ids(PyList_GET_ITEM(lrefs, r), &ref)) return nullptr;
        int64_t rl = static_cast<int64_t>(ref.size());
        int64_t diff = std::llabs(rl - testlen);
        // min over (|l-t|, l) tuples: tie -> smaller l (bleu_scorer.py:71)
        if (diff < best_diff || (diff == best_diff && rl < closest)) {
            best_diff = diff;
            closest = rl;
        }
        NgramMap counts[4];
        count_ngrams(ref, n, counts);
        for (int k = 0; k < n; ++k)
            for (const auto& kv : counts[k]) {
                int64_t& mc = maxcounts[k][kv.first];
                mc = std::max(mc, kv.second);
            }
    }

    NgramMap hyp_counts[4];
    count_ngrams(hyp, n, hyp_counts);
    int64_t guess[4] = {0, 0, 0, 0}, correct[4] = {0, 0, 0, 0};
    for (int k = 0; k < n; ++k) {
        guess[k] = std::max<int64_t>(0, testlen - k);
        for (const auto& kv : hyp_counts[k]) {
            auto it = maxcounts[k].find(kv.first);
            int64_t mc = (it == maxcounts[k].end()) ? 0 : it->second;
            correct[k] += std::min(mc, kv.second);
        }
    }

    PyObject* pguess = PyList_New(n);
    PyObject* pcorrect = PyList_New(n);
    if (!pguess || !pcorrect) return nullptr;
    for (int k = 0; k < n; ++k) {
        PyList_SET_ITEM(pguess, k, PyLong_FromLongLong(guess[k]));
        PyList_SET_ITEM(pcorrect, k, PyLong_FromLongLong(correct[k]));
    }
    return Py_BuildValue("(LLNN)", testlen, closest, pguess, pcorrect);
}

/* ---- CIDEr (matches recnet_tpu_torch/metrics/cider.py, which matches the
 * reference cider_scorer.py:93-181). The Python scorer's float results
 * depend on its summation ORDER (dict insertion order = first-occurrence
 * order of each n-gram within its k level), so the structures here keep
 * per-k first-occurrence vectors and accumulate in exactly that order —
 * the C++ path is bit-identical to the pure-Python path, not just close.
 */

// Per-k n-gram counts in first-occurrence order. Distinct-key lookup is a
// LINEAR scan: captions are <= ~30 tokens, so each k level holds ~a dozen
// keys and a scan beats hash-map construction by a wide margin (measured
// 2.15 s -> sub-second at MSR-VTT test scale).
struct OrderedCounts {
    std::vector<NgramKey> keys[4];
    std::vector<int64_t> tf[4];

    // first-occurrence insert (mirrors the Python dict's order)
    void add(int k, const NgramKey& key) {
        auto& ks = keys[k];
        for (size_t i = 0; i < ks.size(); ++i)
            if (ks[i] == key) { tf[k][i] += 1; return; }
        ks.push_back(key);
        tf[k].push_back(1);
    }

    // position of key at level k, or npos
    size_t find(int k, const NgramKey& key) const {
        const auto& ks = keys[k];
        for (size_t i = 0; i < ks.size(); ++i)
            if (ks[i] == key) return i;
        return static_cast<size_t>(-1);
    }
};

void count_ngrams_ordered(const std::vector<int64_t>& w, int n,
                          OrderedCounts* out) {
    for (int k = 1; k <= n; ++k) {
        if (static_cast<int>(w.size()) < k) continue;
        for (size_t i = 0; i + k <= w.size(); ++i) {
            NgramKey key{0, 0};
            for (int j = 0; j < k; ++j) {
                uint64_t v = static_cast<uint64_t>(w[i + j]) + 1;  // != 0
                if (j < 2) key.lo |= v << (31 * j);
                else       key.hi |= v << (31 * (j - 2));
            }
            out->add(k - 1, key);
        }
    }
}

// tf-idf vector for one sentence (cider.py counts2vec): v = tf *
// (ref_len - log_df), norm[k] = sqrt(sum v^2 in first-occurrence order),
// length = total BIGRAM tf (the reference's bigram-length quirk,
// cider_scorer.py:124).
struct Vec {
    std::vector<double> v[4];
    double norm[4] = {0, 0, 0, 0};
    int64_t length = 0;
};

// Open-addressing document-frequency table. std::unordered_map's chained
// nodes dominated the profile at corpus scale (millions of distinct
// n-grams); linear probing over a flat slot array is ~3x faster and the
// capacity is known up front (<= total stored keys). Empty sentinel is
// key {0,0}, unreachable because every packed token id is >= 1.
class DfMap {
 public:
    struct Slot { NgramKey key{0, 0}; double value = 0.0;
                  int64_t last_image = -1; };

    explicit DfMap(size_t max_entries) {
        size_t cap = 16;
        while (cap < max_entries * 2) cap <<= 1;   // load factor <= 0.5
        slots_.resize(cap);
        mask_ = cap - 1;
    }

    Slot& get_or_insert(const NgramKey& k) {
        size_t i = NgramHash{}(k) & mask_;
        while (true) {
            Slot& s = slots_[i];
            if (s.key == k) return s;
            if (s.key.lo == 0 && s.key.hi == 0) { s.key = k; return s; }
            i = (i + 1) & mask_;
        }
    }

    const Slot* find(const NgramKey& k) const {
        size_t i = NgramHash{}(k) & mask_;
        while (true) {
            const Slot& s = slots_[i];
            if (s.key == k) return &s;
            if (s.key.lo == 0 && s.key.hi == 0) return nullptr;
            i = (i + 1) & mask_;
        }
    }

    std::vector<Slot>& slots() { return slots_; }

 private:
    std::vector<Slot> slots_;
    size_t mask_;
};

void make_vec(const OrderedCounts& counts, int n, double ref_len,
              const DfMap& df_log, Vec* out) {
    out->length = 0;
    for (int k = 0; k < n; ++k) {
        const auto& keys = counts.keys[k];
        const auto& tf = counts.tf[k];
        auto& v = out->v[k];
        v.resize(keys.size());
        double norm = 0.0;
        for (size_t i = 0; i < keys.size(); ++i) {
            const DfMap::Slot* it = df_log.find(keys[i]);
            double dl = (it == nullptr) ? 0.0 : it->value;
            double val = static_cast<double>(tf[i]) * (ref_len - dl);
            v[i] = val;
            norm += val * val;
            if (k == 1) out->length += tf[i];
        }
        out->norm[k] = std::sqrt(norm);
    }
}

/* cider_stats(tests: List[List[int]], refss: List[List[List[int]]],
 *             n=4, sigma=6.0) -> List[List[float] * n]
 * Per-image score[k] summed over that image's refs (cider.py's inner
 * loop); the Python layer finishes with mean(score)/n_refs*10. */
PyObject* py_cider_stats(PyObject*, PyObject* args) {
    PyObject *ltests, *lrefss;
    int n = 4;
    double sigma = 6.0;
    if (!PyArg_ParseTuple(args, "OO|id", &ltests, &lrefss, &n, &sigma))
        return nullptr;
    if (n < 1 || n > 4) {
        PyErr_SetString(PyExc_ValueError, "n must be in [1,4]");
        return nullptr;
    }
    if (!PyList_Check(ltests) || !PyList_Check(lrefss) ||
        PyList_GET_SIZE(ltests) != PyList_GET_SIZE(lrefss)) {
        PyErr_SetString(PyExc_TypeError,
                        "tests and refss must be lists of equal length");
        return nullptr;
    }
    const Py_ssize_t n_images = PyList_GET_SIZE(ltests);
    if (n_images == 0) return PyList_New(0);

    // parse all token-id sequences up front
    std::vector<std::vector<int64_t>> tests(
        static_cast<size_t>(n_images));
    std::vector<std::vector<std::vector<int64_t>>> refss(
        static_cast<size_t>(n_images));
    for (Py_ssize_t i = 0; i < n_images; ++i) {
        if (!to_ids(PyList_GET_ITEM(ltests, i), &tests[i])) return nullptr;
        PyObject* lrefs = PyList_GET_ITEM(lrefss, i);
        if (!PyList_Check(lrefs)) {
            PyErr_SetString(PyExc_TypeError, "refss[i] must be a list");
            return nullptr;
        }
        Py_ssize_t n_refs = PyList_GET_SIZE(lrefs);
        refss[i].resize(static_cast<size_t>(n_refs));
        for (Py_ssize_t r = 0; r < n_refs; ++r)
            if (!to_ids(PyList_GET_ITEM(lrefs, r), &refss[i][r]))
                return nullptr;
    }

    // count every sentence ONCE (the counts are reused for df and for
    // every per-image similarity)
    std::vector<OrderedCounts> test_counts(tests.size());
    std::vector<std::vector<OrderedCounts>> ref_counts(refss.size());
    for (size_t i = 0; i < tests.size(); ++i)
        count_ngrams_ordered(tests[i], n, &test_counts[i]);
    for (size_t i = 0; i < refss.size(); ++i) {
        ref_counts[i].resize(refss[i].size());
        for (size_t r = 0; r < refss[i].size(); ++r)
            count_ngrams_ordered(refss[i][r], n, &ref_counts[i][r]);
    }

    // document frequency: +1 per IMAGE whose ref set contains the ngram
    // (cider_scorer.py:93-104); values are integer counts, so
    // accumulation order is irrelevant here
    size_t max_distinct = 0;
    for (const auto& image_refs : ref_counts)
        for (const auto& c : image_refs)
            for (int k = 0; k < n; ++k) max_distinct += c.keys[k].size();
    DfMap df(max_distinct);
    for (size_t i = 0; i < ref_counts.size(); ++i) {
        for (const auto& c : ref_counts[i]) {
            for (int k = 0; k < n; ++k)
                for (const NgramKey& key : c.keys[k]) {
                    DfMap::Slot& e = df.get_or_insert(key);
                    if (e.last_image != static_cast<int64_t>(i)) {
                        e.last_image = static_cast<int64_t>(i);
                        e.value += 1.0;
                    }
                }
        }
    }
    // df -> log(max(1, df)) in place (cider.py df_log)
    for (auto& s : df.slots())
        if (!(s.key.lo == 0 && s.key.hi == 0))
            s.value = std::log(std::max(1.0, s.value));

    const double ref_len = std::log(static_cast<double>(n_images));
    // mirror Python's `math.e ** (-(delta**2) / (2*sigma**2))` libm calls
    // so the penalty bits match exactly
    const double two_sigma_sq = 2.0 * std::pow(sigma, 2.0);

    PyObject* out = PyList_New(n_images);
    if (!out) return nullptr;
    Vec hyp, ref;                       // buffers reused across images
    for (Py_ssize_t ii = 0; ii < n_images; ++ii) {
        const size_t i = static_cast<size_t>(ii);
        const OrderedCounts& hc = test_counts[i];
        make_vec(hc, n, ref_len, df, &hyp);
        double score[4] = {0, 0, 0, 0};
        for (const OrderedCounts& rc : ref_counts[i]) {
            make_vec(rc, n, ref_len, df, &ref);
            const double delta =
                static_cast<double>(hyp.length - ref.length);
            const double penalty =
                std::pow(M_E, -std::pow(delta, 2.0) / two_sigma_sq);
            for (int k = 0; k < n; ++k) {
                double s = 0.0;
                for (size_t j = 0; j < hc.keys[k].size(); ++j) {
                    const size_t pos = rc.find(k, hc.keys[k][j]);
                    if (pos != static_cast<size_t>(-1)) {
                        const double vrv = ref.v[k][pos];
                        s += std::min(hyp.v[k][j], vrv) * vrv;
                    }
                }
                if (hyp.norm[k] != 0.0 && ref.norm[k] != 0.0)
                    s /= hyp.norm[k] * ref.norm[k];
                score[k] += s * penalty;
            }
        }
        PyObject* row = PyList_New(n);
        if (!row) { Py_DECREF(out); return nullptr; }
        for (int k = 0; k < n; ++k)
            PyList_SET_ITEM(row, k, PyFloat_FromDouble(score[k]));
        PyList_SET_ITEM(out, ii, row);
    }
    return out;
}

PyMethodDef methods[] = {
    {"lcs", py_lcs, METH_VARARGS,
     "lcs(a: List[int], b: List[int]) -> int — LCS length"},
    {"bleu_stats", py_bleu_stats, METH_VARARGS,
     "bleu_stats(hyp, refs, n=4) -> (testlen, reflen, guess, correct)"},
    {"cider_stats", py_cider_stats, METH_VARARGS,
     "cider_stats(tests, refss, n=4, sigma=6.0) -> per-image score sums"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_fastmetrics",
    "C++ hot paths for caption metrics", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastmetrics(void) {
    return PyModule_Create(&module);
}
