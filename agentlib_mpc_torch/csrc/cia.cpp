// Combinatorial Integer Approximation (CIA) branch-and-bound solver.
//
// Native replacement for the reference's pycombina dependency (C++
// branch-and-bound driven from agentlib_mpc/optimization_backends/casadi_/
// minlp_cia.py:124-150): given a relaxed binary trajectory b_rel in [0,1]
// of shape (N, nb), find a binary schedule B in {0,1} minimizing the CIA
// objective
//
//     eta = max_{t,i} | sum_{tau<=t} (b_rel[tau,i] - B[tau,i]) * dt[tau] |
//
// subject to per-control maximum switch counts and (optionally) a SOS1
// one-hot constraint per time step. Depth-first search over time steps
// with greedy child ordering (first leaf = sum-up-rounding-like incumbent)
// and partial-objective pruning. A node budget bounds worst-case time; the
// incumbent at budget exhaustion is returned (status 1).
//
// Exported C API (ctypes-friendly):
//   int cia_solve(const double* b_rel, int N, int nb, const double* dt,
//                 const int* max_switches, int sos1,
//                 double* b_out, double* obj_out, long long max_nodes);
// Returns 0 = proven optimal, 1 = node budget hit (incumbent returned),
//         -1 = invalid arguments.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Problem {
    const double* b_rel;
    int N;
    int nb;
    const double* dt;
    const int* max_switches;
    bool sos1;
    long long max_nodes;

    long long nodes = 0;
    double incumbent = 1e300;
    std::vector<signed char> best;      // N * nb
    std::vector<signed char> current;   // N * nb
    std::vector<double> dev;            // nb running deviations
    std::vector<int> switches;          // nb switch counts
    std::vector<signed char> last;      // nb last values (-1 = none yet)
    // enumerated per-step choices: sos1 -> one-hot rows, else all 2^nb rows
    std::vector<std::vector<signed char>> choices;
};

// objective contribution if at step t we pick `choice`; returns the new
// max |dev| over controls after the step (the quantity that must stay
// below the incumbent for the subtree to survive)
double step_dev(Problem& P, int t, const signed char* choice,
                std::vector<double>& new_dev) {
    double m = 0.0;
    for (int i = 0; i < P.nb; ++i) {
        new_dev[i] = P.dev[i] + (P.b_rel[t * P.nb + i] - choice[i]) * P.dt[t];
        m = std::max(m, std::fabs(new_dev[i]));
    }
    return m;
}

void dfs(Problem& P, int t, double partial_max) {
    if (partial_max >= P.incumbent) return;
    if (t == P.N) {
        P.incumbent = partial_max;
        P.best = P.current;
        return;
    }
    if (P.nodes++ > P.max_nodes) return;

    // order children by the max-deviation they produce (greedy best-first:
    // makes the first leaf a high-quality incumbent, so pruning bites early)
    int nc = (int)P.choices.size();
    std::vector<std::pair<double, int>> order(nc);
    std::vector<double> nd(P.nb);
    for (int c = 0; c < nc; ++c) {
        order[c] = {step_dev(P, t, P.choices[c].data(), nd), c};
    }
    std::sort(order.begin(), order.end());

    std::vector<double> saved_dev = P.dev;
    std::vector<int> saved_sw = P.switches;
    std::vector<signed char> saved_last = P.last;

    for (auto& [d, c] : order) {
        double child_max = std::max(partial_max, d);
        if (child_max >= P.incumbent) break;  // sorted: the rest are worse
        const signed char* choice = P.choices[c].data();
        // switch feasibility
        bool ok = true;
        for (int i = 0; i < P.nb; ++i) {
            int sw = saved_sw[i];
            if (saved_last[i] >= 0 && choice[i] != saved_last[i]) sw++;
            if (P.max_switches && sw > P.max_switches[i]) { ok = false; break; }
            P.switches[i] = sw;
        }
        if (!ok) {
            P.switches = saved_sw;
            continue;
        }
        for (int i = 0; i < P.nb; ++i) {
            P.dev[i] = saved_dev[i] + (P.b_rel[t * P.nb + i] - choice[i]) * P.dt[t];
            P.last[i] = choice[i];
            P.current[t * P.nb + i] = choice[i];
        }
        dfs(P, t + 1, child_max);
        P.dev = saved_dev;
        P.switches = saved_sw;
        P.last = saved_last;
        if (P.nodes > P.max_nodes) return;
    }
}

}  // namespace

extern "C" int cia_solve(const double* b_rel, int N, int nb, const double* dt,
                         const int* max_switches, int sos1,
                         double* b_out, double* obj_out, long long max_nodes) {
    if (N <= 0 || nb <= 0 || nb > 16) return -1;
    Problem P;
    P.b_rel = b_rel;
    P.N = N;
    P.nb = nb;
    P.dt = dt;
    P.max_switches = max_switches;
    P.sos1 = sos1 != 0 && nb > 1;
    P.max_nodes = max_nodes > 0 ? max_nodes : (1LL << 40);
    P.best.assign((size_t)N * nb, 0);
    P.current.assign((size_t)N * nb, 0);
    P.dev.assign(nb, 0.0);
    P.switches.assign(nb, 0);
    P.last.assign(nb, -1);

    if (P.sos1) {
        for (int i = 0; i < nb; ++i) {
            std::vector<signed char> row(nb, 0);
            row[i] = 1;
            P.choices.push_back(row);
        }
    } else {
        for (int m = 0; m < (1 << nb); ++m) {
            std::vector<signed char> row(nb);
            for (int i = 0; i < nb; ++i) row[i] = (m >> i) & 1;
            P.choices.push_back(row);
        }
    }

    dfs(P, 0, 0.0);

    for (int k = 0; k < N * nb; ++k) b_out[k] = (double)P.best[k];
    *obj_out = P.incumbent;
    return P.nodes > P.max_nodes ? 1 : 0;
}
