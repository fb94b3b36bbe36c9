// The exact discrete-event fidelity oracle.
//
// The analytic TPU engine (isotope_tpu/sim/engine.py) samples queueing
// waits from stationary M/M/k closed forms under independence assumptions.
// This file is the ground truth it is validated against: a heap-based
// event simulator of the *physical* system both model —
//
//   - one FIFO station per service with k = NumReplicas servers, each
//     holding a request for one sampled CPU time (the reference's mock
//     service saturates at ~13k QPS/vCPU, isotope/service/README.md:28-34;
//     goroutines yield while sleeping or waiting downstream, so only CPU
//     time occupies a server);
//   - per-request script execution with the reference executor's
//     semantics (isotope/service/pkg/srv/handler.go:66-76 +
//     executable.go:43-179): sequential steps, concurrent groups joined
//     by WaitGroup (= max over members, with a group's sleeps running in
//     parallel), call probability coins, errorRate 500s that skip the
//     script, downstream 500s that do NOT fail the caller
//     (executable.go:132-143) vs transport errors (down callee, timeout)
//     that DO (handler.go:66-76), serial retry attempts each capped by
//     the call timeout with the timed-out child left running
//     (no cancellation in net/http without context deadlines);
//   - Fortio's load loop (perf/benchmark/runner/runner.py:255-268):
//     open-loop Poisson arrivals or closed-loop connections pacing to
//     max(latency, connections/qps);
//   - chaos phases scaling a station's effective server count, with a
//     fully-down callee producing a transport error and a down entry
//     refusing the client's connection.
//
// No independence or stationarity assumptions anywhere: waits emerge from
// actual contention, fork-join correlations and retry storms included.
// Single-threaded, deterministic for a given seed.  Built as a shared
// library; driven from Python via ctypes (isotope_tpu/sim/oracle.py).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <deque>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Call {
  int target;
  double prob, size, timeout;
  int attempts;
  // cross-cluster edge class: extra one-way latency (gateway traversal)
  // and an edge-specific bandwidth (<= 0 means the default net_bps)
  double extra, bps;
};

struct Step {
  double base;  // sleep seconds (max over a concurrent group's sleeps)
  int c0, c1;   // [c0, c1) into the call table
};

struct Svc {
  int k;  // configured replicas
  double err, resp;
  int s0, s1;  // [s0, s1) into the step table
};

struct Attempt;

struct Job {  // one hop execution (one service invocation)
  int svc;
  double t_step_start;
  double step_call_max;  // max call duration (relative) in current step
  int step;              // absolute index into the step table
  int outstanding;       // unresolved calls in the current step
  bool transport;        // a call in the current step finally failed
  Attempt* parent;       // attempt that spawned us (null = root)
  int parent_gen;        // parent attempt generation at spawn
  // root-only:
  int64_t req;
  double t_send;
  int conn;
  // lifecycle (ungraceful-kill support): gen invalidates pending
  // CPU_DONE/STEP_DONE events after an abort; refs counts pending job
  // events + live child attempts so the struct outlives stale
  // references; res_idx is the slot in the station's resident list
  int gen = 0;
  int refs = 0;
  int res_idx = -1;
  double t_cpu_end = 0.0;  // scheduled CPU completion (abort accounting)
  bool in_cpu = false;
  bool finished = false;
  bool aborted = false;
};

struct Attempt {  // one call site's serial retry chain
  Job* caller;
  int call;          // index into the call table
  int remaining;     // attempts left including the current one
  double dur_acc;    // sum of completed attempt durations
  double t_att;      // current attempt start time
  int gen;           // increments per attempt (stale-event filter)
  int resolved_gen;  // last generation already resolved
  int pending;       // in-flight events referencing this attempt
  bool reported;     // final outcome delivered to the caller
};

enum EvKind : int {
  EV_SEND,
  EV_ARRIVE,
  EV_CPU_DONE,
  EV_STEP_DONE,
  EV_ATT_TIMEOUT,
  EV_ATT_RESP,
  EV_PHASE,
};

struct Ev {
  double t;
  uint64_t seq;
  int kind;
  void* p;
  double aux;
  int iaux;
  bool operator<(const Ev& o) const {  // min-heap via std::greater-ish
    if (t != o.t) return t > o.t;
    return seq > o.seq;
  }
};

struct Station {
  int k;  // effective servers (chaos-adjusted)
  int busy = 0;
  std::deque<Job*> q;
  double busy_time = 0.0;
  int64_t arrivals = 0;
  // every job currently resident at this service (queued, in CPU, or
  // awaiting downstream) — the set an ungraceful replica kill samples
  std::vector<Job*> residents;
};

struct Sim {
  // topology
  std::vector<Svc> svcs;
  std::vector<Step> steps;
  std::vector<Call> calls;
  int entry;
  // network
  double net_base, net_bps;
  // service-time model: 0 exponential, 1 deterministic, 2 lognormal,
  // 3 pareto (mean-preserving, mirroring engine._sample_service_time)
  int st_kind;
  double cpu_mean, st_param;
  // chaos phases
  std::vector<double> phase_starts;       // ascending, [0] == 0
  std::vector<std::vector<int>> phase_k;  // per phase, per service
  // per phase: (service, kill fraction) for drain=false events starting
  // at that cut — each resident dies with probability down / k_before
  std::vector<std::vector<std::pair<int, double>>> phase_aborts;
  // load
  int load_kind;  // 0 open, 1 closed
  double qps;     // <= 0 => closed-loop "max"
  int connections;
  double pace_jitter;  // fortio's -jitter: +/- fraction of the pace gap
  int64_t n_requests;

  std::mt19937_64 rng;
  std::priority_queue<Ev> heap;
  uint64_t seq = 0;
  std::vector<Station> stations;
  int64_t sent = 0, completed = 0, hops = 0;

  double* out_start;
  double* out_latency;
  uint8_t* out_error;

  double one_way(double bytes) const { return net_base + bytes / net_bps; }

  // per-edge wire time: cross-cluster calls pay the gateway extra and
  // ride their own bandwidth (both legs of the call's edge)
  double one_way_call(const Call& c, double bytes) const {
    double bps = c.bps > 0.0 ? c.bps : net_bps;
    return net_base + c.extra + bytes / bps;
  }

  double uni() {
    return std::uniform_real_distribution<double>(0.0, 1.0)(rng);
  }

  double cpu_draw() {
    switch (st_kind) {
      case 1:
        return cpu_mean;
      case 2: {  // E[exp(sZ - s^2/2)] == 1
        double z = std::normal_distribution<double>(0.0, 1.0)(rng);
        return std::exp(st_param * z - 0.5 * st_param * st_param) * cpu_mean;
      }
      case 3: {  // standard Pareto rescaled to the configured mean
        double e = std::exponential_distribution<double>(1.0)(rng);
        return std::exp(e / st_param) *
               (cpu_mean * (st_param - 1.0) / st_param);
      }
      default:
        return std::exponential_distribution<double>(1.0)(rng) * cpu_mean;
    }
  }

  void schedule(double t, int kind, void* p, double aux = 0.0,
                int iaux = 0) {
    heap.push(Ev{t, seq++, kind, p, aux, iaux});
  }

  // ---- stations --------------------------------------------------------

  void maybe_free_job(Job* j) {
    if (j->finished && j->refs == 0) delete j;
  }

  void residents_add(Job* j) {
    Station& s = stations[j->svc];
    j->res_idx = static_cast<int>(s.residents.size());
    s.residents.push_back(j);
  }

  void residents_remove(Job* j) {
    if (j->res_idx < 0) return;
    Station& s = stations[j->svc];
    Job* last = s.residents.back();
    s.residents[j->res_idx] = last;
    last->res_idx = j->res_idx;
    s.residents.pop_back();
    j->res_idx = -1;
  }

  void dispatch(Job* j, double t) {
    Station& s = stations[j->svc];
    s.busy++;
    j->in_cpu = true;
    j->refs++;
    double d = cpu_draw();
    s.busy_time += d;
    j->t_cpu_end = t + d;
    schedule(t + d, EV_CPU_DONE, j, 0.0, j->gen);
  }

  void on_arrive(Job* j, double t) {
    Station& s = stations[j->svc];
    s.arrivals++;
    residents_add(j);
    if (s.busy < s.k) {
      dispatch(j, t);
    } else {
      s.q.push_back(j);
    }
  }

  void on_cpu_done(Job* j, double t, int gen) {
    j->refs--;
    if (gen != j->gen) {  // aborted mid-CPU: busy already released
      maybe_free_job(j);
      return;
    }
    j->in_cpu = false;
    Station& s = stations[j->svc];
    s.busy--;
    if (!s.q.empty() && s.busy < s.k) {
      Job* nx = s.q.front();
      s.q.pop_front();
      dispatch(nx, t);
    }
    const Svc& sv = svcs[j->svc];
    // errorRate: fast 500, script skipped (engine err_coin semantics)
    if (sv.err > 0.0 && uni() < sv.err) {
      complete_job(j, t, true);
      return;
    }
    j->step = sv.s0;
    if (sv.s0 == sv.s1) {
      complete_job(j, t, false);
      return;
    }
    start_step(j, t);
  }

  // ---- script interpreter ----------------------------------------------

  void start_step(Job* j, double t) {
    j->t_step_start = t;
    j->step_call_max = 0.0;
    j->transport = false;
    const Step& st = steps[j->step];
    // coins first so `outstanding` is final before any synchronous
    // resolution (an all-attempts-down chain resolves inline)
    std::vector<int> sent_calls;
    for (int c = st.c0; c < st.c1; ++c) {
      if (calls[c].prob >= 1.0 || uni() < calls[c].prob) {
        sent_calls.push_back(c);
      }
    }
    if (sent_calls.empty()) {
      j->refs++;
      schedule(t + st.base, EV_STEP_DONE, j, 0.0, j->gen);
      return;
    }
    j->outstanding = static_cast<int>(sent_calls.size());
    for (int c : sent_calls) {
      Attempt* a = new Attempt{j,   c, calls[c].attempts, 0.0,
                               t,   0, -1,
                               0,   false};
      j->refs++;  // the attempt holds a reference to its caller
      start_attempt(a);
      // an all-attempts-down chain resolves synchronously with no events
      // ever scheduled; this is its only chance to be freed
      maybe_free(a);
    }
  }

  bool svc_down(int s) const { return stations[s].k == 0; }

  void start_attempt(Attempt* a) {
    const Call& c = calls[a->call];
    a->gen++;
    if (svc_down(c.target)) {
      // a down callee refuses instantly: transport error, ~zero duration
      a->resolved_gen = a->gen;
      resolve_attempt(a, 0.0, true, false, a->t_att);
      return;
    }
    if (std::isfinite(c.timeout)) {
      a->pending++;
      schedule(a->t_att + c.timeout, EV_ATT_TIMEOUT, a, 0.0, a->gen);
    }
    a->pending++;  // the response below always eventually arrives
    Job* ch = new Job{};
    ch->svc = c.target;
    ch->parent = a;
    ch->parent_gen = a->gen;
    ch->req = -1;
    schedule(a->t_att + one_way_call(c, c.size), EV_ARRIVE, ch);
  }

  void resolve_attempt(Attempt* a, double dur, bool transport, bool err500,
                       double t_now) {
    a->dur_acc += dur;
    a->remaining--;
    bool failed = transport || err500;
    // a caller killed ungracefully can't issue new retries — only its
    // already-running children continue
    if (failed && a->remaining > 0 && !a->caller->aborted) {
      a->t_att = t_now;  // serial retry: next attempt starts immediately
      start_attempt(a);
      return;
    }
    a->reported = true;
    finish_call(a->caller, a->dur_acc, transport);
    // freeing happens in exactly one place per code path: the event
    // handlers (on_att_timeout / on_att_resp) or the spawn site in
    // start_step — never here, so callers can't double-free
  }

  void maybe_free(Attempt* a) {
    if (a->reported && a->pending == 0) {
      Job* caller = a->caller;
      delete a;
      caller->refs--;
      maybe_free_job(caller);
    }
  }

  void on_att_timeout(Attempt* a, double t, int gen) {
    a->pending--;
    if (gen == a->gen && a->resolved_gen != a->gen) {
      a->resolved_gen = a->gen;
      // the caller stops waiting; the child keeps running uncancelled
      resolve_attempt(a, calls[a->call].timeout, true, false, t);
    }
    maybe_free(a);
  }

  void on_att_resp(Attempt* a, double t, int gen, int code) {
    // code: 0 = ok, 1 = http 500 (retries, not transport), 2 = reset
    // from an ungraceful kill (transport: truncates + retries)
    a->pending--;
    if (gen == a->gen && a->resolved_gen != a->gen) {
      a->resolved_gen = a->gen;
      // duration includes both wire legs + the child's sojourn; a 500
      // triggers a retry but is not a transport failure
      resolve_attempt(a, t - a->t_att, code == 2, code == 1, t);
    }
    maybe_free(a);
  }

  void finish_call(Job* j, double dur, bool transport) {
    if (j->aborted) return;  // the killed job reported its reset already
    if (dur > j->step_call_max) j->step_call_max = dur;
    j->transport |= transport;
    if (--j->outstanding == 0) {
      const Step& st = steps[j->step];
      double base = st.base > j->step_call_max ? st.base : j->step_call_max;
      j->refs++;
      schedule(j->t_step_start + base, EV_STEP_DONE, j, 0.0, j->gen);
    }
  }

  void on_step_done(Job* j, double t, int gen) {
    j->refs--;
    if (gen != j->gen) {
      maybe_free_job(j);
      return;
    }
    if (j->transport) {
      // transport failure truncates the script after the failing step
      // and the hop itself returns 500 upward (handler.go:66-76)
      complete_job(j, t, true);
      return;
    }
    const Svc& sv = svcs[j->svc];
    j->step++;
    if (j->step >= sv.s1) {
      complete_job(j, t, false);
      return;
    }
    start_step(j, t);
  }

  void complete_job(Job* j, double t, bool err) {
    hops++;
    residents_remove(j);
    j->finished = true;
    if (j->parent != nullptr) {
      schedule(t + one_way_call(calls[j->parent->call], svcs[j->svc].resp),
               EV_ATT_RESP, j->parent, err ? 1.0 : 0.0, j->parent_gen);
      maybe_free_job(j);
      return;
    }
    // root: client receives at t + one_way(entry response size)
    double lat = (t - j->t_send) + one_way(svcs[j->svc].resp);
    finish_request(j->req, j->t_send, lat, err, j->conn);
    maybe_free_job(j);
  }

  // ungraceful replica kill: the request dies where it stands with a
  // connection reset — a TRANSPORT error at its caller (which truncates
  // the caller's script and retries if attempts remain); its own
  // outstanding downstream children keep running, uncancelled
  void abort_job(Job* j, double t) {
    hops++;  // the hop executed (partially) — it was really resident
    residents_remove(j);
    j->aborted = true;
    j->gen++;  // invalidate pending CPU_DONE / STEP_DONE events
    Station& s = stations[j->svc];
    if (j->in_cpu) {
      j->in_cpu = false;
      s.busy--;
      // un-credit the CPU time the kill prevented from being served
      if (j->t_cpu_end > t) s.busy_time -= j->t_cpu_end - t;
    } else {
      // may be waiting in the dispatch queue: drop it there
      for (auto it = s.q.begin(); it != s.q.end(); ++it) {
        if (*it == j) {
          s.q.erase(it);
          break;
        }
      }
    }
    j->finished = true;
    if (j->parent != nullptr) {
      // the reset travels back one payload-free wire leg
      schedule(t + one_way_call(calls[j->parent->call], 0.0), EV_ATT_RESP,
               j->parent, 2.0, j->parent_gen);
      maybe_free_job(j);
      return;
    }
    finish_request(j->req, j->t_send, (t - j->t_send) + one_way(0.0), true,
                   j->conn);
    maybe_free_job(j);
  }

  // ---- client ----------------------------------------------------------

  double pace_gap() const {
    return (load_kind == 1 && qps > 0.0) ? connections / qps : 0.0;
  }

  void finish_request(int64_t req, double t_send, double lat, bool err,
                      int conn) {
    out_start[req] = t_send;
    out_latency[req] = lat;
    out_error[req] = err ? 1 : 0;
    completed++;
    if (load_kind == 1 && sent < n_requests) {
      // closed loop: this connection issues its next request after
      // max(latency, pacing gap); the gap carries fortio's -jitter
      // (runner.py:255-268 always passes -jitter: +/-10% uniform)
      double gap = pace_gap();
      if (gap > 0.0 && pace_jitter > 0.0) {
        gap *= 1.0 + pace_jitter * (2.0 * uni() - 1.0);
      }
      schedule(t_send + (lat > gap ? lat : gap), EV_SEND, nullptr, 0.0,
               conn);
    }
  }

  void on_send(double t, int conn) {
    if (sent >= n_requests) return;
    int64_t req = sent++;
    if (svc_down(entry)) {
      // down entry: the TCP connect itself is refused after one wire
      // round trip (engine root_down semantics)
      finish_request(req, t, 2.0 * one_way(0.0), true, conn);
    } else {
      Job* root = new Job{};
      root->svc = entry;
      root->parent = nullptr;
      root->req = req;
      root->t_send = t;
      root->conn = conn;
      schedule(t + one_way(0.0), EV_ARRIVE, root);
    }
    if (load_kind == 0 && sent < n_requests) {
      double gap =
          std::exponential_distribution<double>(1.0)(rng) / qps;
      schedule(t + gap, EV_SEND, nullptr, 0.0, 0);
    }
  }

  void on_phase(double /*t*/, int phase, double t_now) {
    // ungraceful kills first: each resident of the killed service dies
    // with probability down / k_before (it sat on one of the killed
    // replicas) — queued, in CPU, or awaiting downstream alike
    for (const auto& ab : phase_aborts[phase]) {
      Station& st = stations[ab.first];
      std::vector<Job*> snap = st.residents;
      for (Job* j : snap) {
        if (uni() < ab.second) abort_job(j, t_now);
      }
    }
    for (size_t s = 0; s < stations.size(); ++s) {
      stations[s].k = phase_k[phase][s];
      Station& st = stations[s];
      while (st.busy < st.k && !st.q.empty()) {
        Job* nx = st.q.front();
        st.q.pop_front();
        dispatch(nx, t_now);
      }
    }
  }

  // ---- main loop -------------------------------------------------------

  void run() {
    for (size_t p = 1; p < phase_starts.size(); ++p) {
      schedule(phase_starts[p], EV_PHASE, nullptr, 0.0,
               static_cast<int>(p));
    }
    if (load_kind == 0) {
      double gap = std::exponential_distribution<double>(1.0)(rng) / qps;
      schedule(gap, EV_SEND, nullptr, 0.0, 0);
    } else {
      // paced connections start phase-staggered over one gap — the
      // steady state of fortio's jittered periodic workers (threads
      // de-synchronize within a few hundred sends); unpaced (-qps max)
      // workers have no phase to stagger
      double gap = pace_gap();
      for (int c = 0; c < connections; ++c) {
        if (static_cast<int64_t>(c) < n_requests) {
          schedule(gap > 0.0 ? uni() * gap : 0.0, EV_SEND, nullptr, 0.0,
                   c);
        }
      }
    }
    while (!heap.empty()) {
      Ev ev = heap.top();
      heap.pop();
      switch (ev.kind) {
        case EV_SEND:
          on_send(ev.t, ev.iaux);
          break;
        case EV_ARRIVE:
          on_arrive(static_cast<Job*>(ev.p), ev.t);
          break;
        case EV_CPU_DONE:
          on_cpu_done(static_cast<Job*>(ev.p), ev.t, ev.iaux);
          break;
        case EV_STEP_DONE:
          on_step_done(static_cast<Job*>(ev.p), ev.t, ev.iaux);
          break;
        case EV_ATT_TIMEOUT:
          on_att_timeout(static_cast<Attempt*>(ev.p), ev.t, ev.iaux);
          break;
        case EV_ATT_RESP:
          on_att_resp(static_cast<Attempt*>(ev.p), ev.t, ev.iaux,
                      static_cast<int>(ev.aux + 0.5));
          break;
        case EV_PHASE:
          on_phase(ev.t, ev.iaux, ev.t);
          break;
      }
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success, a negative code on invalid input.  All arrays are
// caller-owned; outputs must have room for n_requests entries (out_busy /
// out_arrivals: one entry per service).
int des_run(
    // services
    int32_t S, const int32_t* replicas, const double* error_rate,
    const double* response_size,
    // scripts, flattened: service s owns steps [svc_step_off[s],
    // svc_step_off[s+1]); step t owns calls [step_call_off[t],
    // step_call_off[t+1])
    const int32_t* svc_step_off, const double* step_base,
    const int32_t* step_call_off, int32_t total_steps, int32_t total_calls,
    const int32_t* call_target, const double* call_prob,
    const double* call_size, const double* call_timeout,
    const int32_t* call_attempts, const double* call_extra,
    const double* call_bps, int32_t entry,
    // network + service-time model
    double net_base, double net_bps, int32_t st_kind, double cpu_mean,
    double st_param,
    // chaos events (replicas_down < 0 means all; chaos_drain[i] == 0
    // aborts the killed replicas' resident requests at the window start)
    int32_t n_chaos, const int32_t* chaos_svc, const double* chaos_start,
    const double* chaos_end, const int32_t* chaos_down,
    const uint8_t* chaos_drain,
    // load
    int32_t load_kind, double qps, int32_t connections,
    double pace_jitter, int64_t n_requests, uint64_t seed,
    // outputs
    double* out_start, double* out_latency, uint8_t* out_error,
    double* out_busy, double* out_arrivals, int64_t* out_hops) {
  if (S <= 0 || n_requests <= 0 || entry < 0 || entry >= S) return -1;
  if (load_kind == 0 && qps <= 0.0) return -2;
  if (load_kind == 1 && connections <= 0) return -3;

  Sim sim;
  sim.entry = entry;
  sim.net_base = net_base;
  sim.net_bps = net_bps;
  sim.st_kind = st_kind;
  sim.cpu_mean = cpu_mean;
  sim.st_param = st_param;
  sim.load_kind = load_kind;
  sim.qps = qps;
  sim.connections = connections;
  sim.pace_jitter = pace_jitter;
  sim.n_requests = n_requests;
  sim.rng.seed(seed);
  sim.out_start = out_start;
  sim.out_latency = out_latency;
  sim.out_error = out_error;

  sim.svcs.resize(S);
  for (int s = 0; s < S; ++s) {
    sim.svcs[s] = Svc{replicas[s], error_rate[s], response_size[s],
                      svc_step_off[s], svc_step_off[s + 1]};
  }
  sim.steps.resize(total_steps);
  for (int t = 0; t < total_steps; ++t) {
    sim.steps[t] = Step{step_base[t], step_call_off[t], step_call_off[t + 1]};
  }
  sim.calls.resize(total_calls);
  for (int c = 0; c < total_calls; ++c) {
    if (call_target[c] < 0 || call_target[c] >= S) return -4;
    sim.calls[c] = Call{call_target[c],  call_prob[c], call_size[c],
                        call_timeout[c], call_attempts[c],
                        call_extra ? call_extra[c] : 0.0,
                        call_bps ? call_bps[c] : 0.0};
  }

  // chaos -> piecewise-constant effective replica counts (mirrors
  // Simulator.__init__'s phase construction)
  std::vector<double> cuts{0.0};
  for (int i = 0; i < n_chaos; ++i) {
    cuts.push_back(chaos_start[i]);
    cuts.push_back(chaos_end[i]);
  }
  std::sort(cuts.begin(), cuts.end());
  cuts.erase(std::unique(cuts.begin(), cuts.end()), cuts.end());
  sim.phase_starts = cuts;
  sim.phase_k.assign(cuts.size(), std::vector<int>(S));
  sim.phase_aborts.assign(cuts.size(), {});
  for (size_t p = 0; p < cuts.size(); ++p) {
    for (int s = 0; s < S; ++s) sim.phase_k[p][s] = replicas[s];
    for (int i = 0; i < n_chaos; ++i) {
      if (chaos_start[i] <= cuts[p] && cuts[p] < chaos_end[i]) {
        int s = chaos_svc[i];
        int down = chaos_down[i] < 0 ? replicas[s] : chaos_down[i];
        sim.phase_k[p][s] -= down;
        if (sim.phase_k[p][s] < 0) sim.phase_k[p][s] = 0;
      }
      // an ungraceful event whose window STARTS at this cut kills its
      // share of the service's residents (down / k in the prior phase)
      if (chaos_drain && !chaos_drain[i] && chaos_start[i] == cuts[p] &&
          p > 0) {
        int s = chaos_svc[i];
        int down = chaos_down[i] < 0 ? replicas[s] : chaos_down[i];
        int k_before = sim.phase_k[p - 1][s];
        if (k_before > 0) {
          double frac = static_cast<double>(down) / k_before;
          sim.phase_aborts[p].emplace_back(s, frac > 1.0 ? 1.0 : frac);
        }
      }
    }
  }

  sim.stations.resize(S);
  for (int s = 0; s < S; ++s) sim.stations[s].k = sim.phase_k[0][s];

  sim.run();

  for (int s = 0; s < S; ++s) {
    out_busy[s] = sim.stations[s].busy_time;
    out_arrivals[s] = static_cast<double>(sim.stations[s].arrivals);
  }
  *out_hops = sim.hops;
  return 0;
}

}  // extern "C"
