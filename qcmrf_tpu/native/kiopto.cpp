// qcmrf_native ("kiopto" replacement) — exact MRF inference engine in C++.
//
// Native-code counterpart of the external `kiopto_native` library the
// reference imports as `px` (/root/reference/eval.py:15, API surface
// documented in SURVEY.md §1 L0): exact partition function, log-potentials,
// Gibbs-chain sampling and perturb-and-MAP sampling over binary MRFs.
//
// Unlike the 2^n enumeration the evaluation path needs, lnZ and MAP here
// run **bucket (variable) elimination** in the log domain, so the host-side
// oracle scales with treewidth rather than variable count — it cross-checks
// the device exact-inference sweeps far beyond enumeration range on chains /
// grids.
//
// Conventions match the verified reference layout (SURVEY.md Appendix A):
// weights are clique-major, within a clique the state y is binary-counting
// with y[0] (the first clique variable) slowest; state ids put variable 0
// in the most significant bit.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <random>
#include <set>
#include <vector>

namespace {

struct Factor {
  std::vector<int> vars;          // ascending variable ids
  std::vector<double> logt;       // size 2^vars.size(), first var slowest

  int arity() const { return static_cast<int>(vars.size()); }
  size_t size() const { return logt.size(); }

  // index of assignment restricted to this factor's vars;
  // bits[v] is the current value of global variable v
  size_t index_of(const std::vector<int>& bits) const {
    size_t idx = 0;
    for (int i = 0; i < arity(); ++i)
      idx = (idx << 1) | static_cast<size_t>(bits[vars[i]]);
    return idx;
  }
};

double logsumexp2(double a, double b) {
  if (a == -std::numeric_limits<double>::infinity()) return b;
  if (b == -std::numeric_limits<double>::infinity()) return a;
  double m = std::max(a, b);
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

struct Model {
  int n = 0;
  std::vector<std::vector<int>> cliques;
  std::vector<size_t> offsets;    // weight offset per clique
  std::vector<double> weights;    // dimension sum(2^|C|)
  std::vector<std::vector<int>> var_cliques;  // clique ids touching v

  void init(const std::vector<std::vector<int>>& cl, int n_vars) {
    cliques = cl;
    n = n_vars;  // may exceed the clique maximum: isolated trailing vars
    size_t off = 0;
    offsets.clear();
    for (auto& C : cliques) {
      for (int v : C) n = std::max(n, v + 1);
      offsets.push_back(off);
      off += (size_t{1} << C.size());
    }
    weights.assign(off, 0.0);
    var_cliques.assign(n, {});
    for (size_t k = 0; k < cliques.size(); ++k)
      for (int v : cliques[k]) var_cliques[v].push_back((int)k);
  }

  // theta^T phi(x) with variable 0 as MSB of x
  double logpot(uint64_t x) const {
    double total = 0.0;
    for (size_t k = 0; k < cliques.size(); ++k) {
      const auto& C = cliques[k];
      size_t y = 0;
      for (size_t i = 0; i < C.size(); ++i) {
        int bit = (x >> (n - 1 - C[i])) & 1u;
        y = (y << 1) | static_cast<size_t>(bit);
      }
      total += weights[offsets[k] + y];
    }
    return total;
  }

  std::vector<Factor> build_factors() const {
    std::vector<Factor> fs;
    for (size_t k = 0; k < cliques.size(); ++k) {
      Factor f;
      // sort vars ascending but keep table consistent: rebuild the table
      // in sorted-var order from the clique-order weights
      std::vector<int> order(cliques[k].size());
      for (size_t i = 0; i < order.size(); ++i) order[i] = static_cast<int>(i);
      std::vector<int> sorted_vars = cliques[k];
      std::sort(sorted_vars.begin(), sorted_vars.end());
      f.vars = sorted_vars;
      int m = f.arity();
      f.logt.assign(size_t{1} << m, 0.0);
      for (size_t y = 0; y < (size_t{1} << m); ++y) {
        // y is indexed over sorted vars (first slowest); recover each
        // sorted var's bit, then build the clique-order index
        size_t cidx = 0;
        for (size_t i = 0; i < cliques[k].size(); ++i) {
          int v = cliques[k][i];
          int pos = static_cast<int>(
              std::lower_bound(sorted_vars.begin(), sorted_vars.end(), v) -
              sorted_vars.begin());
          int bit = (y >> (m - 1 - pos)) & 1u;
          cidx = (cidx << 1) | static_cast<size_t>(bit);
        }
        f.logt[y] = weights[offsets[k] + cidx];
      }
      fs.push_back(std::move(f));
    }
    return fs;
  }
};

// combine two log-factors (addition in log domain) over the union scope
Factor combine(const Factor& a, const Factor& b) {
  Factor out;
  std::set<int> scope(a.vars.begin(), a.vars.end());
  scope.insert(b.vars.begin(), b.vars.end());
  out.vars.assign(scope.begin(), scope.end());
  int m = out.arity();
  out.logt.assign(size_t{1} << m, 0.0);
  std::vector<int> bits(out.vars.empty() ? 0 : out.vars.back() + 1, 0);
  for (size_t idx = 0; idx < out.size(); ++idx) {
    for (int i = 0; i < m; ++i)
      bits[out.vars[i]] = (idx >> (m - 1 - i)) & 1u;
    out.logt[idx] = a.logt[a.index_of(bits)] + b.logt[b.index_of(bits)];
  }
  return out;
}

// eliminate one variable by logsumexp (sum=true) or max (sum=false);
// when tracing MAP, argmax per reduced assignment is stored in *argmax
Factor eliminate(const Factor& f, int v, bool sum,
                 std::vector<uint8_t>* argmax = nullptr) {
  Factor out;
  int m = f.arity();
  int pos = static_cast<int>(
      std::lower_bound(f.vars.begin(), f.vars.end(), v) - f.vars.begin());
  for (int i = 0; i < m; ++i)
    if (i != pos) out.vars.push_back(f.vars[i]);
  out.logt.assign(size_t{1} << (m - 1), 0.0);
  if (argmax) argmax->assign(out.logt.size(), 0);
  for (size_t ridx = 0; ridx < out.logt.size(); ++ridx) {
    // expand ridx into the full index with v at `pos`
    size_t hi = ridx >> (m - 1 - pos);
    size_t lo = ridx & ((size_t{1} << (m - 1 - pos)) - 1);
    size_t i0 = (hi << (m - pos)) | lo;                       // v = 0
    size_t i1 = i0 | (size_t{1} << (m - 1 - pos));            // v = 1
    if (sum) {
      out.logt[ridx] = logsumexp2(f.logt[i0], f.logt[i1]);
    } else {
      if (f.logt[i1] > f.logt[i0]) {
        out.logt[ridx] = f.logt[i1];
        if (argmax) (*argmax)[ridx] = 1;
      } else {
        out.logt[ridx] = f.logt[i0];
      }
    }
  }
  return out;
}

// min-degree elimination order
std::vector<int> elimination_order(const Model& m) {
  std::vector<std::set<int>> adj(m.n);
  for (auto& C : m.cliques)
    for (int a : C)
      for (int b : C)
        if (a != b) adj[a].insert(b);
  std::vector<bool> done(m.n, false);
  std::vector<int> order;
  for (int step = 0; step < m.n; ++step) {
    int best = -1;
    size_t best_deg = SIZE_MAX;
    for (int v = 0; v < m.n; ++v) {
      if (done[v]) continue;
      size_t deg = 0;
      for (int u : adj[v])
        if (!done[u]) ++deg;
      if (deg < best_deg) { best_deg = deg; best = v; }
    }
    order.push_back(best);
    done[best] = true;
    // connect the (as yet uneliminated) neighbors of `best`
    std::vector<int> nb;
    for (int u : adj[best])
      if (!done[u]) nb.push_back(u);
    for (int a : nb)
      for (int b : nb)
        if (a != b) adj[a].insert(b);
  }
  return order;
}

struct Trace {
  int var;
  Factor before;                  // factor immediately before eliminating var
  std::vector<uint8_t> argmax;    // choice of var per reduced assignment
};

// generic bucket elimination; returns total log value; for MAP, fills
// traces (in elimination order) and `assignment` via back-substitution
double run_elimination(const Model& m, bool sum,
                       std::vector<int>* assignment = nullptr) {
  std::vector<Factor> pool = m.build_factors();
  std::vector<int> order = elimination_order(m);
  std::vector<Trace> traces;
  double constant = 0.0;

  for (int v : order) {
    // gather factors touching v
    Factor acc;
    bool found = false;
    std::vector<Factor> rest;
    for (auto& f : pool) {
      if (std::find(f.vars.begin(), f.vars.end(), v) != f.vars.end()) {
        acc = found ? combine(acc, f) : f;
        found = true;
      } else {
        rest.push_back(std::move(f));
      }
    }
    if (!found) {  // isolated variable: contributes a factor of 2 (sum)
      if (sum) constant += std::log(2.0);
      else if (assignment) {
        traces.push_back({v, Factor{{v}, {0.0, 0.0}},
                          std::vector<uint8_t>{0}});
      }
      pool = std::move(rest);
      continue;
    }
    Trace t;
    t.var = v;
    // the pre-elimination factor is only needed for MAP back-substitution;
    // copying it on the sum path is dead work per eliminated variable
    if (!sum && assignment) t.before = acc;
    Factor reduced = eliminate(acc, v, sum, sum ? nullptr : &t.argmax);
    if (!sum && assignment) traces.push_back(std::move(t));
    if (reduced.arity() == 0) {
      constant += reduced.logt[0];
    } else {
      rest.push_back(std::move(reduced));
    }
    pool = std::move(rest);
  }

  if (!sum && assignment) {
    assignment->assign(m.n, 0);
    std::vector<int> bits(m.n, 0);
    // back-substitute in reverse elimination order
    for (auto it = traces.rbegin(); it != traces.rend(); ++it) {
      const Factor& f = it->before;
      // index over f.vars excluding var, using already-decided bits
      int pos = static_cast<int>(
          std::lower_bound(f.vars.begin(), f.vars.end(), it->var) -
          f.vars.begin());
      size_t ridx = 0;
      for (int i = 0; i < f.arity(); ++i) {
        if (i == pos) continue;
        ridx = (ridx << 1) | static_cast<size_t>(bits[f.vars[i]]);
      }
      bits[it->var] = it->argmax.empty() ? 0 : it->argmax[ridx];
    }
    *assignment = bits;
  }
  return constant;
}

}  // namespace

extern "C" {

void* qk_create(const int* flat, const int* sizes, int K, int n_vars) {
  std::vector<std::vector<int>> cl;
  int p = 0;
  for (int k = 0; k < K; ++k) {
    cl.emplace_back(flat + p, flat + p + sizes[k]);
    p += sizes[k];
  }
  auto* m = new Model();
  m->init(cl, n_vars);
  return m;
}

void qk_destroy(void* h) { delete static_cast<Model*>(h); }

long long qk_dim(void* h) {
  return static_cast<long long>(static_cast<Model*>(h)->weights.size());
}

int qk_num_vars(void* h) { return static_cast<Model*>(h)->n; }

double* qk_weights(void* h) {
  return static_cast<Model*>(h)->weights.data();
}

double qk_logpot(void* h, unsigned long long x) {
  return static_cast<Model*>(h)->logpot(x);
}

double qk_partition(void* h) {
  return run_elimination(*static_cast<Model*>(h), /*sum=*/true);
}

void qk_map(void* h, int* out_bits) {
  std::vector<int> bits;
  run_elimination(*static_cast<Model*>(h), /*sum=*/false, &bits);
  const Model& m = *static_cast<Model*>(h);
  for (int v = 0; v < m.n; ++v) out_bits[v] = bits[v];
}

// Gibbs chain: systematic sweeps; writes `num` samples of n bits each
// (variable order), after `burn` burn-in sweeps, one sample per sweep.
void qk_sample_gibbs(void* h, int num, int burn, int* out,
                     unsigned long long seed) {
  Model& m = *static_cast<Model*>(h);
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::vector<int> bits(m.n, 0);
  for (int v = 0; v < m.n; ++v) bits[v] = (rng() >> 33) & 1u;

  // per-variable conditional from only the cliques touching v (no
  // packed state id: works for any n, and O(sum_v K_v) per sweep
  // instead of O(n * K * |C|))
  auto sweep = [&]() {
    for (int v = 0; v < m.n; ++v) {
      double diff = 0.0;  // logpot(bits with v=1) - logpot(v=0)
      for (int k : m.var_cliques[v]) {
        const auto& C = m.cliques[k];
        size_t y1 = 0, y0 = 0;
        for (size_t i = 0; i < C.size(); ++i) {
          int b = bits[C[i]];
          y1 = (y1 << 1) | (size_t)(C[i] == v ? 1 : b);
          y0 = (y0 << 1) | (size_t)(C[i] == v ? 0 : b);
        }
        diff += m.weights[m.offsets[k] + y1]
              - m.weights[m.offsets[k] + y0];
      }
      double p1 = 1.0 / (1.0 + std::exp(-diff));
      bits[v] = unif(rng) < p1 ? 1 : 0;
    }
  };
  for (int s = 0; s < burn; ++s) sweep();
  for (int s = 0; s < num; ++s) {
    sweep();
    for (int v = 0; v < m.n; ++v) out[s * m.n + v] = bits[v];
  }
}

// Perturb-and-MAP: Gumbel noise on every weight, exact MAP of the
// perturbed model by max-product elimination (low-order perturbation).
void qk_sample_pam(void* h, int num, int* out, unsigned long long seed) {
  Model& m = *static_cast<Model*>(h);
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(1e-12, 1.0);
  std::vector<double> saved = m.weights;
  for (int s = 0; s < num; ++s) {
    for (size_t i = 0; i < m.weights.size(); ++i)
      m.weights[i] = saved[i] - std::log(-std::log(unif(rng)));
    std::vector<int> bits;
    run_elimination(m, /*sum=*/false, &bits);
    for (int v = 0; v < m.n; ++v) out[s * m.n + v] = bits[v];
  }
  m.weights = saved;
}

}  // extern "C"
