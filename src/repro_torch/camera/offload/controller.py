"""Measurement-driven cut controller (closes the §III-D loop) — the port
of the JAX package's ``camera/offload/controller.py``.

  1. **Calibrate** — run every legal cut's split executor
     (``camera/offload/executors``) on live data, measuring node/cloud wall
     clock (waiting for the card, ``core.timing``) and the wire payload
     bytes the node half actually charges.
  2. **Fit** — convert the measurements into ``core.pipeline.Block``
     descriptors: per-stage time deltas become flops under the node
     profile's rate, measured per-unit wire bytes become ``bytes_out``
     (inverted through the selectivity chain so
     ``Pipeline.cut_payload_bytes`` reproduces the measurement exactly).
  3. **Solve** — feed the measured pipeline to ``solve_cut`` in the
     workload's regime and execute the chosen cut.
  4. **Audit** — compare the analytic template's predicted ranking with
     the measured ranking (pairwise concordance) and verify the chosen
     cut matches the exhaustive measured optimum.

The fitted pipeline marks every block CORE: the split executors always
run the full funnel prefix on the node side, so the controller optimizes
*where to cut*, the axis the runtime actually has.  The windowed re-solve
(with its telemetry hook) and the degradation ladder serve the resilience
layer (``camera/offload/resilience.py``).  The reference's ``byte_scale`` / ``time_scale`` scale
a toy-resolution §IV rig up to 16 x 4K; the port measures the rig at 16 x
4K itself, so it has no use for them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

from repro_torch.camera.offload.link import LinkProfile, link_energy_w
from repro_torch.core.costmodel import (
    HardwareProfile,
    energy_cost,
    throughput_cost,
)
from repro_torch.core.pipeline import Block, BlockKind, Pipeline
from repro_torch.core.placement import CutSolution, solve_cut
from repro_torch.core.timing import timed as _timed


@dataclasses.dataclass(frozen=True)
class CutMeasurement:
    """Live measurements for one cut point."""

    cut: str
    node_s: float                 # node-half seconds per batch (warm)
    cloud_s: float                # cloud-half seconds per batch (warm)
    wire_bytes: float             # measured valid-element bytes per batch
    capacity_bytes: float         # static padded wire size per batch
    units: int                    # source units (frames) in the batch

    @property
    def bytes_per_unit(self) -> float:
        return self.wire_bytes / max(self.units, 1)

    @property
    def node_s_per_unit(self) -> float:
        return self.node_s / max(self.units, 1)


@dataclasses.dataclass(frozen=True)
class ControllerReport:
    """Outcome of one calibrate -> solve -> audit pass."""

    regime: str
    measurements: tuple           # (CutMeasurement, ...) in pipeline order
    measured_pipeline: Pipeline
    solution: CutSolution         # solve_cut on the measured pipeline
    chosen_cut: str
    measured_objectives: dict     # cut -> objective (watts | -fps), measured
    predicted_objectives: dict    # cut -> objective from the analytic template
    measured_best_cut: str

    @property
    def agrees(self) -> bool:
        """Does the solver's pick match the exhaustive measured optimum?"""
        return self.chosen_cut == self.measured_best_cut

    @property
    def rank_agreement(self) -> float:
        """Pairwise concordance of predicted vs measured cut orderings."""
        cuts = [c for c in self.measured_objectives
                if c in self.predicted_objectives]
        pairs = [(a, b) for i, a in enumerate(cuts) for b in cuts[i + 1:]]
        if not pairs:
            return 1.0
        ok = sum(
            1 for a, b in pairs
            if ((self.measured_objectives[a] - self.measured_objectives[b])
                * (self.predicted_objectives[a]
                   - self.predicted_objectives[b])) >= 0)
        return ok / len(pairs)


class CutController:
    """Calibrates, fits, solves and executes the offload cut decision."""

    def __init__(self, make_executor: Callable, cuts: Sequence[str],
                 template: Pipeline, profiles: Mapping[str, HardwareProfile],
                 link: LinkProfile, regime: str = "energy",
                 unit_rate_hz: float = 1.0,
                 duties: Mapping[str, float] | None = None,
                 target_fps: float = 30.0):
        """``make_executor(cut)`` builds a split executor whose ``encode``
        consumes the calibration inputs and whose ``decode_run`` consumes
        the payload.  ``template`` is the analytic pipeline (its blocks
        must include every name in ``cuts``, in order); ``profiles`` maps
        block name -> node HardwareProfile; ``link`` is an offload
        LinkProfile (converted to the cost model's vocabulary)."""
        self.make_executor = make_executor
        self.cuts = tuple(cuts)
        self.template = template
        self.profiles = dict(profiles)
        self.link = link
        self.link_hw = HardwareProfile(
            name=link.name, link_bw=link.bytes_per_s,
            joules_per_byte=link.joules_per_byte)
        if regime not in ("energy", "throughput"):
            raise ValueError(regime)
        self.regime = regime
        self.unit_rate_hz = float(unit_rate_hz)
        self.duties = dict(duties) if duties else None
        self.target_fps = float(target_fps)
        self.executors: dict = {}
        self.measurements: list = []
        # sliding-window live telemetry (serving runtime): cut -> deque of
        # (units, wire_bytes, node_s, cloud_s) samples; resolves counts
        # windowed re-solves actually fired (the DESIGN.md §13 cadence pin)
        self.window = 32
        self._window_obs: dict = {}
        self.resolves = 0
        # optional §15 telemetry sink (set attribute-style by the owner:
        # ``controller.telemetry = ...``, any object with ``enabled``,
        # ``counters.bump`` and ``emit``); observed after each windowed
        # re-solve, never consulted by the solver
        self.telemetry = None

    # -- 1. calibrate --------------------------------------------------------

    def calibrate(self, *inputs, units: int | None = None,
                  reps: int = 1) -> list:
        """Run every cut's split executor on ``inputs``; returns the
        measurement list (also kept on ``self``)."""
        if units is None:
            units = int(inputs[0].shape[0])
        self.measurements = []
        for cut in self.cuts:
            ex = self.executors.get(cut) or self.make_executor(cut)
            self.executors[cut] = ex
            node_s, payload = _timed(lambda: ex.encode(*inputs), reps=reps)
            cloud_s, _res = _timed(lambda: ex.decode_run(payload), reps=reps)
            m = CutMeasurement(
                cut=cut, node_s=node_s, cloud_s=cloud_s,
                wire_bytes=payload.nbytes(),
                capacity_bytes=payload.capacity_bytes(), units=units)
            self._check_finite(m)
            self.measurements.append(m)
        return self.measurements

    @staticmethod
    def _check_finite(m: CutMeasurement):
        import math

        for field in ("node_s", "cloud_s", "wire_bytes", "capacity_bytes"):
            v = getattr(m, field)
            if not (isinstance(v, (int, float)) and math.isfinite(v)
                    and v >= 0):
                raise ValueError(
                    f"calibration for cut {m.cut!r} produced non-finite "
                    f"{field}={v!r} — the executor's encode/decode_run is "
                    "emitting NaN/inf (check codec bits and input ranges) "
                    "and solve_cut would silently rank garbage")

    def _validated_measurements(self) -> list:
        """Calibration table checked before anything reaches solve_cut.

        Raises a ``ValueError`` NAMING the offending cut for every hole a
        bare ``KeyError`` (or a NaN objective) used to fall through:
        missing measurement, missing hardware profile, a cut absent from
        the analytic template, or a non-finite measured value."""
        if not self.measurements:
            raise RuntimeError("calibrate() first")
        measured = {m.cut for m in self.measurements}
        for cut in self.cuts:
            if cut not in measured:
                raise ValueError(
                    f"no calibration entry for cut {cut!r} — "
                    f"calibrate() measured only {sorted(measured)}; "
                    "re-run calibrate() after changing self.cuts")
        tmpl_names = {b.name for b in self.template.blocks}
        for m in self.measurements:
            self._check_finite(m)
            if m.cut not in self.profiles:
                raise ValueError(
                    f"cut {m.cut!r} has a calibration entry but no "
                    "HardwareProfile in controller.profiles — add one or "
                    "drop the cut")
            if m.cut not in tmpl_names:
                raise ValueError(
                    f"cut {m.cut!r} is not a block of the analytic "
                    f"template {self.template.name!r} "
                    f"(blocks: {sorted(tmpl_names)})")
        return self.measurements

    # -- 2. fit --------------------------------------------------------------

    def measured_pipeline(self) -> Pipeline:
        """Measured Block descriptors: the loop-closing artifact.

        One block per cut point.  ``bytes_out`` is inverted through the
        template's selectivity chain so ``cut_payload_bytes`` returns the
        measured per-unit wire bytes exactly; flops come from measured
        node-time *deltas* under the block profile's rate (so
        ``HardwareProfile.time_for`` reproduces the measured stage time).
        """
        self._validated_measurements()
        blocks = []
        frac = 1.0                       # upstream selectivity product
        prev_node = 0.0
        prev_bytes_in = 0.0
        for m in self.measurements:
            tmpl = self.template.block(m.cut)
            sel = tmpl.selectivity
            bytes_out = m.bytes_per_unit / max(frac * sel, 1e-12)
            stage_s = max(m.node_s_per_unit - prev_node, 0.0)
            prof = self.profiles[m.cut]
            if prof.flops_per_s and frac > 0:
                flops = stage_s * prof.flops_per_s / frac
            else:
                flops = tmpl.flops
            kind = (BlockKind.SOURCE if tmpl.kind is BlockKind.SOURCE
                    else BlockKind.CORE)
            blocks.append(Block(
                name=m.cut, flops=flops, bytes_in=prev_bytes_in,
                bytes_out=bytes_out, kind=kind, selectivity=sel,
                meta=(("measured_stage_s", stage_s),
                      ("measured_wire_bytes", m.bytes_per_unit))))
            frac *= sel
            prev_node = m.node_s_per_unit
            prev_bytes_in = bytes_out
        return Pipeline(f"{self.template.name}|measured", tuple(blocks))

    # -- 3. solve + execute --------------------------------------------------

    def choose(self) -> CutSolution:
        return solve_cut(
            self.measured_pipeline(), self.profiles, self.link_hw,
            regime=self.regime, unit_rate_hz=self.unit_rate_hz,
            duties=self.duties, target_fps=self.target_fps)

    def execute(self, *inputs):
        """Run the solver-chosen cut's split executor end to end."""
        sol = self.choose()
        ex = self.executors[sol.cut_after]
        payload = ex.encode(*inputs)
        return ex.decode_run(payload), payload, sol

    # -- 3b. windowed re-solve (serving runtime, DESIGN.md §13) ---------------

    def observe(self, cut: str, *, units: int, wire_bytes: float,
                node_s: float | None = None, cloud_s: float | None = None):
        """Push one live sample into the sliding window for ``cut``.

        The serving runtime measures real per-micro-batch wire bytes (and,
        when it has them, split wall clocks); anything not measured falls
        back to the calibration table in :meth:`window_measurements`.
        """
        import collections

        if cut not in self.cuts:
            raise ValueError(f"cut {cut!r} not in {self.cuts}")
        dq = self._window_obs.get(cut)
        if dq is None or dq.maxlen != self.window:
            dq = collections.deque(dq or (), maxlen=self.window)
            self._window_obs[cut] = dq
        dq.append((int(units), float(wire_bytes),
                   None if node_s is None else float(node_s),
                   None if cloud_s is None else float(cloud_s)))

    def window_measurements(self,
                            predicted_bytes: Mapping[str, float] | None = None
                            ) -> list:
        """Calibration table with sliding-window live telemetry folded in.

        Windowed samples override the calibrated per-unit wire bytes (and
        node/cloud seconds where the runtime measured them); cuts with no
        live samples keep their calibration row.  ``predicted_bytes`` maps
        cut -> predicted per-unit wire bytes and takes precedence over both
        — the runtime uses it to ask "what would cut c cost for *this*
        stream's measured funnel stats" without executing cut c.
        """
        out = []
        for m in self._validated_measurements():
            dq = self._window_obs.get(m.cut)
            if dq:
                units = max(sum(s[0] for s in dq), 1)
                wire = sum(s[1] for s in dq)

                def _win_s(col, fallback_per_unit):
                    timed = [(s[col], s[0]) for s in dq if s[col] is not None]
                    if not timed:
                        return fallback_per_unit * units
                    return (sum(t for t, _ in timed)
                            / max(sum(u for _, u in timed), 1) * units)

                m = dataclasses.replace(
                    m, units=units, wire_bytes=wire,
                    node_s=_win_s(2, m.node_s_per_unit),
                    cloud_s=_win_s(3, m.cloud_s / max(m.units, 1)))
            if predicted_bytes and m.cut in predicted_bytes:
                m = dataclasses.replace(
                    m, wire_bytes=float(predicted_bytes[m.cut]) * m.units)
            self._check_finite(m)
            out.append(m)
        return out

    def resolve_window(self, *, deadline_s: float | None = None,
                       cut_latency_s: Mapping[str, float] | None = None,
                       predicted_bytes: Mapping[str, float] | None = None
                       ) -> CutSolution:
        """One sliding-window re-solve: :meth:`choose` on the windowed
        table, then a congestion deadline filter.

        ``solve_cut`` has no constraint axis, so the deadline lives here:
        ``cut_latency_s`` maps cut -> predicted shared-link p99 completion
        latency (the runtime anchors it at ``simulate_shared_link``'s
        ``LinkReport.p99_latency_s`` and first-order-adjusts for each
        candidate cut's bytes).  Cuts over ``deadline_s`` are infeasible;
        if the unconstrained optimum is infeasible the cheapest *feasible*
        cut (by the regime objective) wins, and when nothing is feasible
        the minimum-latency cut is the graceful floor — congestion must
        never pick a cut that makes congestion worse.
        """
        saved = self.measurements
        self.measurements = self.window_measurements(predicted_bytes)
        try:
            sol = self.choose()
            self.resolves += 1
            if deadline_s is not None and cut_latency_s:
                lat = {c: float(cut_latency_s.get(c, 0.0)) for c in self.cuts}
                feasible = [c for c in self.cuts if lat[c] <= deadline_s]
                if sol.cut_after not in feasible:
                    pipe = self.measured_pipeline()
                    if feasible:
                        best = min(feasible,
                                   key=lambda c: self._objective(pipe, c))
                    else:
                        best = min(self.cuts, key=lambda c: lat[c])
                    sol = dataclasses.replace(
                        sol, cut_after=best,
                        report=self._report_for(pipe, best),
                        objective=self._objective(pipe, best))
            tel = self.telemetry
            if tel is not None and getattr(tel, "enabled", False):
                tel.counters.bump("controller.resolves")
                tel.emit("dispatch", "resolve_window", cut=sol.cut_after,
                         objective=float(sol.objective),
                         resolves=self.resolves)
            return sol
        finally:
            self.measurements = saved

    def degradation_rungs(self, cut: str | None = None,
                          *, bits_ladder=(16, 8, 4)) -> list:
        """Ordered ``(cut, bits)`` rung list for one granted placement.

        Rung 0 is ``cut`` (the solver's choice when None) at the widest
        codec; faults walk it down through narrower codecs, then retreat
        to the measured-cheapest-bytes cut (the calibration table's own
        answer to "which cut survives a starved link"), and finally to
        the all-on-node terminal rung.  The serving runtime calls this
        per stream with the placement *admission granted* (DESIGN.md
        §14), which may differ from the fleet-global solver choice —
        the ladder degrades the stream it protects, not a hypothetical
        one.
        """
        from repro_torch.camera.offload.resilience import ON_NODE

        self._validated_measurements()
        if cut is None:
            cut = self.choose().cut_after
        elif cut not in self.cuts:
            raise ValueError(f"cut {cut!r} not in {tuple(self.cuts)}")
        rungs = [(cut, b) for b in bits_ladder]
        cheapest = min(self.measurements,
                       key=lambda m: m.bytes_per_unit).cut
        if cheapest != cut:
            rungs.append((cheapest, bits_ladder[-1]))
        rungs.append(ON_NODE)
        return rungs

    def degradation_ladder(self, *, bits_ladder=(16, 8, 4), **ladder_kw):
        """Build the resilience ladder from this controller's calibration
        (:meth:`degradation_rungs` at the solver-chosen cut)."""
        from repro_torch.camera.offload.resilience import DegradationLadder

        return DegradationLadder(
            self.degradation_rungs(bits_ladder=bits_ladder), **ladder_kw)

    # -- 4. audit ------------------------------------------------------------

    def _objective(self, pipeline: Pipeline, cut: str) -> float:
        """Regime objective of one cut on ``pipeline`` (watts | -fps).

        One formula for both the measured and the predicted score — the
        solver's own cost functions — so the audit compares *descriptors*
        (measured vs hand-entered), never two different models.
        """
        rep = self._report_for(pipeline, cut)
        return rep.total_w if self.regime == "energy" else -rep.fps

    def _report_for(self, pipeline: Pipeline, cut: str):
        """Regime cost report of one cut on ``pipeline``."""
        if self.regime == "energy":
            return energy_cost(pipeline, self.profiles, self.link_hw, cut,
                               unit_rate_hz=self.unit_rate_hz,
                               duties=self.duties)
        return throughput_cost(pipeline, self.profiles, self.link_hw, cut)

    def report(self) -> ControllerReport:
        measured_pipe = self.measured_pipeline()
        sol = self.choose()
        measured = {m.cut: self._objective(measured_pipe, m.cut)
                    for m in self.measurements}
        tmpl_full = self.template.configure(self.template.optional_names)
        predicted = {}
        for cut in self.cuts:
            predicted[cut] = self._objective(tmpl_full, cut)
        best = min(measured, key=measured.get)
        return ControllerReport(
            regime=self.regime,
            measurements=tuple(self.measurements),
            measured_pipeline=measured_pipe,
            solution=sol,
            chosen_cut=sol.cut_after,
            measured_objectives=measured,
            predicted_objectives=predicted,
            measured_best_cut=best,
        )

    def comm_watts(self, cut: str) -> float:
        """Measured transmit power at ``cut`` (closed-form link energy)."""
        m = {m.cut: m for m in self.measurements}[cut]
        return link_energy_w(m.bytes_per_unit, self.unit_rate_hz, self.link)
