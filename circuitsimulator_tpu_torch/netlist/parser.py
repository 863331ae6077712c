"""SPICE netlist parser.

Reproduces the reference frontend's accepted grammar and quirks
(src/parser.cpp; feature matrix in SURVEY.md §2):

- Two-pass parse: all ``.MODEL`` cards first (parser.cpp:141-148) so devices
  may reference models defined later in the file; then dot-cards and devices.
- Devices dispatch on the first character R/C/L/V/I/M (case-insensitive);
  anything else prints a diagnostic and is ignored (parser.cpp:204-215) —
  this is also how title lines are effectively handled.
- V sources accept ``V n+ n- [DC v | v] [SIN v0 va freq [td [phi]]]``; note
  the 5th SIN argument is a *delay in seconds*, not a phase (parser.cpp:330).
- I sources accept only a DC value (parser.cpp:358-379).
- MOSFETs accept the 7-token ``M name d g s model W L`` and 8-token
  ``M name d g s p|n W L modelId`` forms; in the 8-token form the p/n token
  is ignored and the trailing model id wins (parser.cpp:398-405).
- Dot cards: .op/.dc/.tran/.ac/.hb/.print/.plotnv/.plotnc/.model; unknown
  cards print a warning.  If no analysis was requested, .OP is implied.

Extension beyond the reference grammar: ``D name n+ n- [IS=x] [N=x]`` diodes
(the reference has no diode model; BASELINE.json's synthetic stress config
asks for one).
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, List, Optional

from ..utils.numbers import parse_spice_number
from .circuit import (
    Circuit, MosModel, BjtModel, SourceSpec, Waveform,
    WAVE_PULSE, WAVE_SIN, WAVE_PWL, WAVE_EXP, WAVE_SFFM,
)
from .lexer import Statement, lex_file, lex_text

# Analysis types (sim.hpp:10-17)
AN_NONE = "none"
AN_OP = "op"
AN_DC = "dc"
AN_AC = "ac"
AN_TRAN = "tran"
AN_HB = "hb"


@dataclasses.dataclass
class DCSweepConfig:
    source_name: str = ""
    start: float = 0.0
    stop: float = 0.0
    step: float = 0.0
    # optional nested OUTER sweep (standard SPICE `.DC s1 ... s2 ...` form;
    # extension — the reference parses only the single-source card)
    source2: str = ""
    start2: float = 0.0
    stop2: float = 0.0
    step2: float = 0.0


@dataclasses.dataclass
class TranConfig:
    enabled: bool = False
    tstep: float = 0.0
    tstop: float = 0.0
    tstart: float = 0.0
    # `.TRAN ... UIC` (extension): skip the DC operating point and start
    # from the .IC values (unset nodes start at 0)
    uic: bool = False


@dataclasses.dataclass
class AcConfig:
    enabled: bool = False
    sweep_type: str = "dec"  # lin | dec | oct
    n_points: int = 0
    fstart: float = 0.0
    fstop: float = 0.0


@dataclasses.dataclass
class HbConfig:
    enabled: bool = False
    f0: float = 0.0
    n_harm: int = 0
    # extra tones for multi-tone HB: [(freq, n_harm), ...] beyond (f0,
    # n_harm).  `.hb f0 n0 f1 n1 ...` (extension; the reference card is
    # strictly `.hb f0 nHarm`, parser.cpp:551)
    extra_tones: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def tones(self):
        return [(self.f0, self.n_harm)] + list(self.extra_tones)


@dataclasses.dataclass
class FourConfig:
    """.FOUR f0 V(a)|V(a,b)|I(el) ... — Fourier analysis of the transient
    output over its last fundamental period (extension)."""
    enabled: bool = False
    f0: float = 0.0
    probes: List["ProbeSpec"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PzConfig:
    """.PZ V(out[,ref]) [input_src] — pole-zero analysis (extension)."""
    enabled: bool = False
    out_node: str = ""
    ref_node: str = ""
    input_source: str = ""


@dataclasses.dataclass
class SensConfig:
    """.SENS V(out[,ref]) — DC sensitivity output (extension)."""
    enabled: bool = False
    out_node: str = ""
    ref_node: str = ""


@dataclasses.dataclass
class TfConfig:
    """.TF V(out[,ref])|I(Velem) input_src — DC transfer function
    (extension; standard SPICE card, absent from the reference)."""
    enabled: bool = False
    out_kind: str = "v"      # "v" (node pair) | "i" (branch current)
    out_node: str = ""
    ref_node: str = ""
    out_element: str = ""    # for I(<element>) outputs
    input_source: str = ""


@dataclasses.dataclass
class NoiseConfig:
    """.NOISE V(out[,ref]) [input_src] [lin|dec|oct n fstart fstop]
    (extension; sweep args default to the .AC card's sweep)."""
    enabled: bool = False
    out_node: str = ""
    ref_node: str = ""
    input_source: str = ""
    sweep_type: str = ""     # empty -> use the .AC card
    n_points: int = 0
    fstart: float = 0.0
    fstop: float = 0.0


@dataclasses.dataclass
class ProbeSpec:
    kind: str = "nv"           # nv | dv | br
    expr: str = ""
    node1: str = ""
    node2: str = ""
    ele_name: str = ""
    ele_port: str = ""
    # AC modifier (extension, used by .MEASURE AC): "" = value (magnitude
    # for complex data), db | ph | re | im from VDB()/VP()/VR()/VI()
    mod: str = ""


@dataclasses.dataclass
class StepConfig:
    """.STEP card (extension): re-run analyses over a swept parameter.

      .STEP PARAM name start stop incr
      .STEP PARAM name LIST v1 v2 ...
      .STEP <srcname> start stop incr

    TPU-native execution: the engine compiles once and the step values run
    as one vmapped batch (api.Simulator.step)."""
    kind: str = "param"        # param | source
    name: str = ""
    values: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EventSpec:
    """One crossing event of a .MEASURE card: <probe> reaching VAL on the
    n-th RISE/FALL/CROSS occurrence after TD."""
    probe: ProbeSpec = dataclasses.field(default_factory=ProbeSpec)
    val: float = 0.0
    edge: str = "cross"        # cross | rise | fall
    n: int = 1                 # 1-based occurrence; -1 = LAST
    td: float = 0.0


@dataclasses.dataclass
class MeasureSpec:
    """.MEASURE card (extension; standard SPICE post-processing —
    the reference has no such card).  Forms:

      .MEASURE TRAN name AVG|RMS|MIN|MAX|PP|INTEG|MIN_AT|MAX_AT <probe>
                         [FROM=t1] [TO=t2]
      .MEASURE TRAN name TRIG <probe> VAL=v [RISE|FALL|CROSS=n] [TD=t]
                         TARG <probe> VAL=v [RISE|FALL|CROSS=n] [TD=t]
      .MEASURE TRAN name WHEN <probe>=v [RISE|FALL|CROSS=n] [TD=t]
      .MEASURE TRAN name FIND <probe> WHEN <probe2>=v [RISE|FALL|CROSS=n]
      .MEASURE TRAN name FIND <probe> AT=t
    """
    analysis: str = "tran"
    name: str = ""
    kind: str = "stat"         # stat | trig_targ | when | find_when | find_at
    stat: str = ""             # avg|rms|min|max|pp|integ|min_at|max_at
    probe: ProbeSpec = dataclasses.field(default_factory=ProbeSpec)
    ev1: EventSpec = dataclasses.field(default_factory=EventSpec)
    ev2: EventSpec = dataclasses.field(default_factory=EventSpec)
    t_from: float = 0.0
    t_to: float = float("inf")
    at: float = 0.0
    # kind == "param": derived measurement — an expression over previously
    # defined measure names (and .PARAM values), evaluated after them
    expr: str = ""


@dataclasses.dataclass
class PrintCommand:
    analysis: str = AN_NONE
    probes: List[ProbeSpec] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SimulationConfig:
    do_op: bool = False
    dc_sweeps: List[DCSweepConfig] = dataclasses.field(default_factory=list)
    tran: TranConfig = dataclasses.field(default_factory=TranConfig)
    ac: AcConfig = dataclasses.field(default_factory=AcConfig)
    hb: HbConfig = dataclasses.field(default_factory=HbConfig)
    print_commands: List[PrintCommand] = dataclasses.field(default_factory=list)
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)
    four: FourConfig = dataclasses.field(default_factory=FourConfig)
    # `.IC V(node)=value ...` pairs (extension)
    ics: List[tuple] = dataclasses.field(default_factory=list)
    # `.NODESET V(node)=value ...` pairs (extension)
    nodesets: List[tuple] = dataclasses.field(default_factory=list)
    # `.OPTIONS key[=value] ...` raw pairs (extension; values may be
    # numbers or words like METHOD=TRAP) — applied by the Simulator
    options: dict = dataclasses.field(default_factory=dict)
    # `.TEMP celsius` (extension); None = default (kT/q = VT_THERMAL)
    temp_c: Any = None
    sens: SensConfig = dataclasses.field(default_factory=SensConfig)
    pz: PzConfig = dataclasses.field(default_factory=PzConfig)
    tf: TfConfig = dataclasses.field(default_factory=TfConfig)
    measures: List[MeasureSpec] = dataclasses.field(default_factory=list)
    # `.PARAM` table (extension): resolved numeric values by (lowercased)
    # name, for .STEP re-binding and run metadata
    param_values: dict = dataclasses.field(default_factory=dict)
    steps: List[StepConfig] = dataclasses.field(default_factory=list)

    def has_any_analysis(self) -> bool:
        return (self.do_op or bool(self.dc_sweeps) or self.tran.enabled
                or self.ac.enabled or self.hb.enabled)

    def ensure_default_op(self) -> None:
        self.do_op = not self.has_any_analysis()


def _warn(line_no: int, msg: str) -> None:
    print(f"Line {line_no}: {msg}", file=sys.stderr)


def _tolval(s: str) -> float:
    """DEV=/LOT= tolerance value; `5%` means 0.05."""
    return parse_spice_number(s[:-1]) / 100.0 if s.endswith("%") \
        else parse_spice_number(s)


class NetlistParser:
    def __init__(self, circuit: Circuit, sim: SimulationConfig,
                 param_overrides: Optional[dict] = None):
        self.ckt = circuit
        self.sim = sim
        # .STEP re-binding: {name: value} wins over the .PARAM definition
        self.param_overrides = {k.lower(): float(v)
                                for k, v in (param_overrides or {}).items()}
        self.param_values: dict = {}

    # ---- entry points ----
    def parse_file(self, path: str) -> bool:
        try:
            stmts = lex_file(path)
        except OSError:
            print(f"cannot open netlist file {path}", file=sys.stderr)
            return False
        self._parse_statements(stmts)
        return True

    def parse_text(self, text: str) -> bool:
        self._parse_statements(lex_text(text))
        return True

    # ---- driver ----
    def _parse_statements(self, stmts: List[Statement]) -> None:
        from .subckt import flatten_subcircuits
        stmts = flatten_subcircuits(stmts, self.param_overrides)
        # .PARAM pre-pass (extension): collect definitions, resolve (with
        # forward references), then substitute {expr} groups everywhere
        # so the rest of the grammar only ever sees literal numbers
        defs = []
        for st in stmts:
            if st.tokens and st.tokens[0].lower() == ".param":
                self._collect_param_card(st, defs)
        self._resolve_params(defs)
        for st in stmts:
            if (st.tokens and st.tokens[0].lower() != ".param"
                    and any("{" in tok for tok in st.tokens)):
                st.tokens = self._substitute_params(st.tokens, st.line_no)
        self.sim.param_values = dict(self.param_values)
        self.ckt.param_values = dict(self.param_values)
        for st in stmts:
            if st.tokens and st.tokens[0].lower() == ".model":
                self._parse_model_card(st)
        for st in stmts:
            if not st.tokens:
                continue
            head = st.tokens[0]
            if head.startswith("."):
                if head.lower() == ".model":
                    continue
                self._parse_dot_card(st)
                continue
            self._parse_device(st)
        self.sim.ensure_default_op()

    # ---- devices ----
    def _parse_device(self, st: Statement) -> None:
        c0 = st.tokens[0][0].upper()
        if c0 == "R":
            self._parse_rcl(st, "R")
        elif c0 == "C":
            self._parse_rcl(st, "C")
        elif c0 == "L":
            self._parse_rcl(st, "L")
        elif c0 == "V":
            self._parse_vsource(st)
        elif c0 == "I":
            self._parse_isource(st)
        elif c0 == "M":
            self._parse_mosfet(st)
        elif c0 == "D":
            self._parse_diode(st)
        elif c0 == "Q":
            self._parse_bjt(st)
        elif c0 in ("E", "G", "F", "H"):
            self._parse_controlled(st, c0)
        elif c0 == "K":
            self._parse_mutual(st)
        elif c0 in ("S", "W"):
            self._parse_switch(st, c0)
        elif c0 == "J":
            if len(st.tokens) < 5:
                _warn(st.line_no, f"invalid JFET: {st.raw}")
            else:
                dev, lot, mult = self._tail_tols(st, st.tokens[5:], "JFET")
                self.ckt.add_jfet(st.tokens[0], st.tokens[1], st.tokens[2],
                                  st.tokens[3], st.tokens[4],
                                  dev_tol=dev, lot_tol=lot, m_mult=mult)
        elif c0 == "T":
            self._parse_tline(st)
        elif c0 == "B":
            self._parse_bsource(st)
        else:
            _warn(st.line_no, f"unsupported element or syntax: {st.raw}")

    def _parse_rcl(self, st: Statement, kind: str) -> None:
        t = st.tokens
        label = {"R": "resistor", "C": "capacitor", "L": "inductor"}[kind]
        if len(t) < 4:
            _warn(st.line_no, f"invalid {label}: {st.raw}")
            return
        try:
            val = parse_spice_number(t[3])
        except (ValueError, Exception) as e:
            _warn(st.line_no, f"cannot parse {kind} value: {e} in '{st.raw}'")
            return
        # optional trailing key=value specs (extensions): TC (R only),
        # DEV/LOT Monte-Carlo tolerances (all of R/C/L, `5%` or `0.05`)
        tc1 = tc2 = dev = lot = 0.0
        ic = None
        mult = 1.0
        tolval = _tolval
        try:
            for tok in t[4:]:
                low = tok.lower()
                if kind == "R" and low.startswith("tc="):
                    parts = low[3:].split(",")
                    tc1 = parse_spice_number(parts[0])
                    if len(parts) > 1 and parts[1]:
                        tc2 = parse_spice_number(parts[1])
                elif kind == "R" and low.startswith("tc1="):
                    tc1 = parse_spice_number(low[4:])
                elif kind == "R" and low.startswith("tc2="):
                    tc2 = parse_spice_number(low[4:])
                elif low.startswith("dev="):
                    dev = tolval(low[4:])
                elif low.startswith("lot="):
                    lot = tolval(low[4:])
                elif kind in ("C", "L") and low.startswith("ic="):
                    # initial cap voltage / inductor current (UIC only)
                    ic = parse_spice_number(low[3:])
                elif low.startswith("m="):
                    # parallel-multiplicity factor (extension)
                    mult = parse_spice_number(low[2:])
        except ValueError as e:
            _warn(st.line_no,
                  f"cannot parse {kind} key=value spec: {e} in '{st.raw}'")
            tc1 = tc2 = dev = lot = 0.0
            ic = None
            mult = 1.0
        if mult <= 0:
            _warn(st.line_no, f"M= multiplier must be > 0: {st.raw}")
            mult = 1.0
        if kind == "R":
            self.ckt.add_resistor(t[0], t[1], t[2], val / mult,
                                  tc1=tc1, tc2=tc2,
                                  dev_tol=dev, lot_tol=lot)
        elif kind == "C":
            self.ckt.add_capacitor(t[0], t[1], t[2], val * mult,
                                   dev_tol=dev, lot_tol=lot, ic=ic)
        else:
            self.ckt.add_inductor(t[0], t[1], t[2], val / mult,
                                  dev_tol=dev, lot_tol=lot, ic=ic)

    def _parse_sin(self, st: Statement, spec: SourceSpec, sin_idx: int) -> None:
        t = st.tokens
        if t[sin_idx].lower() != "sin":
            return
        if len(t) < sin_idx + 4:
            _warn(st.line_no,
                  f"SIN needs at least 3 parameters (v0 va freq): {st.raw}")
            return
        w = Waveform(kind=WAVE_SIN)
        # optional args stop at a trailing spec keyword (TRNOISE(...),
        # AC mag, DEV=/LOT=) — 'SIN 1 0.6 900e6 0 TRNOISE(1m 0)' must
        # keep the SIN and hand TRNOISE to its own parser, not die
        # trying to read 'TRNOISE(1m' as the phase
        stop = ("trnoise", "ac", "dc", "dev", "lot")
        args = []
        for tok in t[sin_idx + 1: sin_idx + 6]:
            if tok.lower().startswith(stop):
                break
            args.append(tok)
        if len(args) < 3:
            _warn(st.line_no,
                  f"SIN needs at least 3 parameters (v0 va freq): {st.raw}")
            return
        try:
            w.v0 = parse_spice_number(args[0])
            w.va = parse_spice_number(args[1])
            w.freq = parse_spice_number(args[2])
            if len(args) > 3:
                w.std = parse_spice_number(args[3])
            if len(args) > 4:
                w.phi = parse_spice_number(args[4])
        except ValueError as e:
            _warn(st.line_no, f"cannot parse SIN parameters: {e} in '{st.raw}'")
            return
        spec.wave = w

    def _parse_pulse(self, st: Statement, spec: SourceSpec, idx: int) -> None:
        # PULSE(v1 v2 td tr tf ton per) — extension: reference parses only
        # SIN on V sources; PULSE/PWL evaluators exist (sim.hpp:80-115) but
        # are unreachable from its parser.  We accept them.
        t = st.tokens
        args = [tok.strip("()") for tok in t[idx + 1:]]
        if t[idx].lower().startswith("pulse(") :
            args = [t[idx][6:].strip("()")] + args if len(t[idx]) > 6 else args
        vals = []
        for a in args:
            if not a:
                continue
            try:
                vals.append(parse_spice_number(a))
            except ValueError:
                break
        if len(vals) < 2:
            _warn(st.line_no, f"PULSE needs at least v1 v2: {st.raw}")
            return
        w = Waveform(kind=WAVE_PULSE)
        fields = ["v1", "v2", "ptd", "tr", "tf", "ton", "per"]
        for f, v in zip(fields, vals):
            setattr(w, f, v)
        spec.wave = w

    def _wave_args(self, t, idx: int, kw: str):
        """Collect the numeric arguments of `KW(a b c)` / `KW a b c` forms
        starting at token idx (same tolerant style as _parse_pulse)."""
        args = [tok.strip("()") for tok in t[idx + 1:]]
        head = t[idx]
        if head.lower().startswith(kw + "(") and len(head) > len(kw) + 1:
            args = [head[len(kw) + 1:].strip("()")] + args
        vals = []
        for a in args:
            if not a:
                continue
            try:
                vals.append(parse_spice_number(a))
            except ValueError:
                break
        return vals

    def _parse_exp(self, st: Statement, spec: SourceSpec, idx: int) -> None:
        # EXP(v1 v2 [td1 tau1 td2 tau2]) — extension (standard SPICE
        # waveform; the reference parses only SIN).  Omitted taus default to
        # 0, which the evaluators treat as an instantaneous step.
        vals = self._wave_args(st.tokens, idx, "exp")
        if len(vals) < 2:
            _warn(st.line_no, f"EXP needs at least v1 v2: {st.raw}")
            return
        w = Waveform(kind=WAVE_EXP)
        # packed into the PULSE field block: [v1 v2 td1 tau1 td2 tau2];
        # with no td2 given there is no decay segment (td2 = +inf)
        w.tf = math.inf
        for f, v in zip(["v1", "v2", "ptd", "tr", "tf", "ton"], vals):
            setattr(w, f, v)
        spec.wave = w

    def _parse_sffm(self, st: Statement, spec: SourceSpec, idx: int) -> None:
        # SFFM(vo va fc [mdi fs]) — extension (standard SPICE single-
        # frequency FM waveform).
        vals = self._wave_args(st.tokens, idx, "sffm")
        if len(vals) < 3:
            _warn(st.line_no, f"SFFM needs at least vo va fc: {st.raw}")
            return
        w = Waveform(kind=WAVE_SFFM)
        # packed into the SIN field block: [vo va fc mdi fs]
        for f, v in zip(["v0", "va", "freq", "std", "phi"], vals):
            setattr(w, f, v)
        spec.wave = w

    def _parse_pwl(self, st: Statement, spec: SourceSpec, idx: int) -> None:
        # PWL(t1 v1 t2 v2 ...) — same extension note as PULSE.
        t = st.tokens
        args = []
        for tok in t[idx:]:
            low = tok.lower()
            if low.startswith("pwl"):
                low = low[3:]
            args.extend(a for a in low.replace("(", " ").replace(")", " ").split())
        vals = []
        for a in args:
            try:
                vals.append(parse_spice_number(a))
            except ValueError:
                _warn(st.line_no, f"cannot parse PWL point: {st.raw}")
                return
        if len(vals) < 2 or len(vals) % 2 != 0:
            _warn(st.line_no, f"PWL needs (t, v) pairs: {st.raw}")
            return
        w = Waveform(kind=WAVE_PWL)
        w.pwl_t = vals[0::2]
        w.pwl_v = vals[1::2]
        spec.wave = w

    def _parse_ac_spec(self, st: Statement, spec: SourceSpec) -> None:
        """Extension: `AC mag [phase_deg]` anywhere after the node tokens.
        The reference's SourceSpec carries acMag/acPhaseDeg (sim.hpp:148-149)
        and its AC stamps use them (element.cpp:68-81, 125-151), but its
        parser never fills them; we accept the standard SPICE syntax."""
        t = st.tokens
        for i in range(3, len(t)):
            if t[i].lower() == "ac" and i + 1 < len(t):
                try:
                    spec.ac_mag = parse_spice_number(t[i + 1])
                    if i + 2 < len(t):
                        try:
                            spec.ac_phase_deg = parse_spice_number(t[i + 2])
                        except ValueError:
                            pass
                except ValueError as e:
                    _warn(st.line_no,
                          f"cannot parse AC spec: {e} in '{st.raw}'")
                return

    def _parse_trnoise(self, st: Statement, spec: SourceSpec,
                       start: int) -> None:
        """TRNOISE(na [nt [alpha namp]]) anywhere after the source value
        (extension): white Gaussian transient noise, RMS na, sample-hold
        interval nt (0 = redraw every solver step), plus an optional
        1/f^alpha flicker component of total RMS namp — all added to
        the deterministic waveform."""
        for j in range(start, len(st.tokens)):
            if st.tokens[j].lower().startswith("trnoise"):
                vals = self._wave_args(st.tokens, j, "trnoise")
                if not vals:
                    _warn(st.line_no,
                          f"TRNOISE needs an amplitude: {st.raw}")
                    return
                spec.tn_na = vals[0]
                if len(vals) > 1:
                    spec.tn_nt = vals[1]
                if len(vals) > 2 and vals[2] > 0:
                    spec.tn_alpha = vals[2]
                if len(vals) > 3:
                    spec.tn_namp = vals[3]
                return

    def _parse_vsource(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 4:
            _warn(st.line_no, f"invalid voltage source: {st.raw}")
            return
        spec = SourceSpec()
        idx = 3
        try:
            low3 = t[3].lower()
            if len(t) >= 5 and low3 == "dc":
                spec.dc = parse_spice_number(t[4])
                idx = 5
            elif (low3 == "sin" or low3 == "ac"
                  or low3.startswith("pulse") or low3.startswith("pwl")
                  or low3.startswith("exp") or low3.startswith("sffm")
                  or low3.startswith("trnoise")):
                spec.dc = 0.0
                idx = 3
            else:
                spec.dc = parse_spice_number(t[3])
                idx = 4
        except ValueError as e:
            _warn(st.line_no, f"cannot parse V DC value: {e} in '{st.raw}'")
            return
        # the reference looks for SIN only at the token right after the DC
        # part (parser.cpp:347-351); with the AC extension the waveform
        # keyword may sit later, so scan from idx onward
        for j in range(idx, len(t)):
            head = t[j].lower()
            if head == "sin":
                self._parse_sin(st, spec, j)
                break
            if head.startswith("pulse"):
                self._parse_pulse(st, spec, j)
                break
            if head.startswith("pwl"):
                self._parse_pwl(st, spec, j)
                break
            if head.startswith("exp"):
                self._parse_exp(st, spec, j)
                break
            if head.startswith("sffm"):
                self._parse_sffm(st, spec, j)
                break
        self._parse_ac_spec(st, spec)
        self._parse_trnoise(st, spec, idx)
        self.ckt.add_voltage_source(t[0], t[1], t[2], spec)

    def _parse_isource(self, st: Statement) -> None:
        # reference grammar: `I name np nm [DC] v` with NO waveforms
        # (parser.cpp:358-379); SIN/PULSE/PWL accepted as an extension,
        # mirroring the V-source forms (the engine evaluates I-source
        # waveforms through the same machinery as V sources)
        t = st.tokens
        if len(t) < 4:
            _warn(st.line_no, f"invalid current source: {st.raw}")
            return
        spec = SourceSpec()
        idx = 3
        try:
            low3 = t[3].lower()
            if len(t) >= 5 and low3 == "dc":
                spec.dc = parse_spice_number(t[4])
                idx = 5
            elif (low3 == "sin" or low3 == "ac"
                  or low3.startswith("pulse") or low3.startswith("pwl")
                  or low3.startswith("exp") or low3.startswith("sffm")
                  or low3.startswith("trnoise")):
                spec.dc = 0.0
                idx = 3
            else:
                spec.dc = parse_spice_number(t[3])
                idx = 4
        except ValueError as e:
            _warn(st.line_no, f"cannot parse I value: {e} in '{st.raw}'")
            return
        for j in range(idx, len(t)):
            head = t[j].lower()
            if head == "sin":
                self._parse_sin(st, spec, j)
                break
            if head.startswith("pulse"):
                self._parse_pulse(st, spec, j)
                break
            if head.startswith("pwl"):
                self._parse_pwl(st, spec, j)
                break
            if head.startswith("exp"):
                self._parse_exp(st, spec, j)
                break
            if head.startswith("sffm"):
                self._parse_sffm(st, spec, j)
                break
        self._parse_ac_spec(st, spec)
        self._parse_trnoise(st, spec, idx)
        self.ckt.add_current_source(t[0], t[1], t[2], spec)

    def _parse_mosfet(self, st: Statement) -> None:
        t = st.tokens
        # standard-SPICE form (extension): `M d g s b model W=.. L=..` —
        # detected by any KEY=VALUE token.  The bulk node is accepted but
        # (like the reference, circuit.cpp:142) conduction ignores it; the
        # junction caps still tie to node "0".
        if any("=" in tok for tok in t[4:]):
            if len(t) < 6:
                _warn(st.line_no, f"invalid MOSFET: {st.raw}")
                return
            name, nd, ng, ns = t[0], t[1], t[2], t[3]
            model_id = t[5]           # after the bulk node
            w = l = None
            dev = lot = 0.0
            mult = 1.0
            for tok in t[6:]:
                key, _, val = tok.partition("=")
                try:
                    if key.lower() == "w" and val:
                        w = parse_spice_number(val)
                    elif key.lower() == "l" and val:
                        l = parse_spice_number(val)
                    elif key.lower() == "dev" and val:
                        dev = _tolval(val)     # VT mismatch (Monte-Carlo)
                    elif key.lower() == "lot" and val:
                        lot = _tolval(val)
                    elif key.lower() == "m" and val:
                        mult = parse_spice_number(val)  # parallel devices
                    else:
                        _warn(st.line_no,
                              f"unknown MOS param {tok!r} (W=/L= supported)")
                except ValueError as e:
                    _warn(st.line_no,
                          f"cannot parse MOS param {tok}: {e}")
                    return
            if w is None or l is None:
                _warn(st.line_no,
                      f"MOS W=/L= missing: {st.raw}")
                return
            if mult <= 0:
                _warn(st.line_no, f"M= multiplier must be > 0: {st.raw}")
                mult = 1.0
            self.ckt.add_mosfet(name, nd, ng, ns, model_id, w, l,
                                dev_tol=dev, lot_tol=lot, m_mult=mult)
            return
        if len(t) not in (7, 8):
            _warn(st.line_no, f"invalid MOSFET: {st.raw}")
            return
        name, nd, ng, ns = t[0], t[1], t[2], t[3]
        # 7-token: model is t[4]; 8-token: the p/n token t[4] is ignored and
        # the trailing token is the model id (parser.cpp:398-405).
        model_id = t[4] if len(t) == 7 else t[-1]
        try:
            w = parse_spice_number(t[5])
            l = parse_spice_number(t[6])
        except ValueError as e:
            _warn(st.line_no, f"cannot parse MOS W/L: {e} in '{st.raw}'")
            return
        self.ckt.add_mosfet(name, nd, ng, ns, model_id, w, l)

    def _parse_bjt(self, st: Statement) -> None:
        # Q name nc nb ne model [DEV=|LOT=]  (extension; no BJT in the
        # reference; DEV/LOT = BF mismatch for Monte-Carlo)
        t = st.tokens
        if len(t) < 5:
            _warn(st.line_no, f"invalid BJT: {st.raw}")
            return
        dev, lot, mult = self._tail_tols(st, t[5:], "BJT")
        self.ckt.add_bjt(t[0], t[1], t[2], t[3], t[4],
                         dev_tol=dev, lot_tol=lot, m_mult=mult)

    def _tail_tols(self, st: Statement, toks, label: str):
        """Optional trailing DEV=/LOT= Monte-Carlo tolerances and M=
        parallel-multiplicity factor."""
        dev = lot = 0.0
        mult = 1.0
        for tok in toks:
            key, _, val = tok.partition("=")
            try:
                if key.lower() == "dev" and val:
                    dev = _tolval(val)
                elif key.lower() == "lot" and val:
                    lot = _tolval(val)
                elif key.lower() == "m" and val:
                    mult = parse_spice_number(val)
                else:
                    _warn(st.line_no,
                          f"unknown {label} param {tok!r}")
            except ValueError as e:
                _warn(st.line_no, f"cannot parse {label} param {tok}: {e}")
        if mult <= 0:
            _warn(st.line_no, f"M= multiplier must be > 0: {st.raw}")
            mult = 1.0
        return dev, lot, mult

    @staticmethod
    def _poly_expr(variables: List[str], coeffs: List[str]) -> str:
        """SPICE2 POLY expression text from raw coefficient tokens (kept
        verbatim so both frontends build the identical string):
        c0 + c1*x1 + ... + cn*xn, then for one variable the full power
        series, for several the graded-lex second-order products
        (x1^2, x1*x2, ..., x2^2, ...).  A single coefficient is the
        LINEAR term (classic SPICE2 shorthand), for one variable."""
        n = len(variables)
        if n == 1 and len(coeffs) == 1:
            return f"{coeffs[0]}*{variables[0]}"
        terms: List[str] = []
        idx = 0
        if coeffs:
            terms.append(coeffs[0])
            idx = 1
        for v in variables:
            if idx >= len(coeffs):
                break
            terms.append(f"{coeffs[idx]}*{v}")
            idx += 1
        if n == 1:
            k = 2
            while idx < len(coeffs):
                terms.append(f"{coeffs[idx]}*{variables[0]}**{k}")
                idx += 1
                k += 1
        else:
            for i in range(n):
                for j in range(i, n):
                    if idx >= len(coeffs):
                        break
                    prod = (f"{variables[i]}**2" if i == j
                            else f"{variables[i]}*{variables[j]}")
                    terms.append(f"{coeffs[idx]}*{prod}")
                    idx += 1
        return " + ".join(terms) if terms else "0"

    def _parse_poly(self, st: Statement, c0: str, n_poly: int) -> None:
        """POLY(n) form of E/G/F/H (extension): lowered onto the
        behavioral-source machinery — the polynomial becomes a B
        expression, so the Newton stamp comes from autodiff like any
        other behavioral device."""
        t = st.tokens
        v_controlled = c0 in ("E", "G")       # controls are node pairs
        n_ctl_toks = 2 * n_poly if v_controlled else n_poly
        first_coeff = 4 + n_ctl_toks
        if n_poly < 1 or len(t) < first_coeff + 1:
            _warn(st.line_no, f"invalid POLY source: {st.raw}")
            return
        variables = []
        for i in range(n_poly):
            if v_controlled:
                cp = t[4 + 2 * i]
                cm = t[4 + 2 * i + 1]
                variables.append(f"v({cp},{cm})")
            else:
                variables.append(f"i({t[4 + i]})")
        coeffs = t[first_coeff:]
        for c in coeffs:
            try:
                parse_spice_number(c)
            except ValueError as e:
                _warn(st.line_no,
                      f"cannot parse POLY coefficient {c!r}: {e}")
                return
        expr = self._poly_expr(variables, coeffs)
        self.ckt.add_bsource(t[0], t[1], t[2], c0 in ("E", "H"), expr)

    def _parse_controlled(self, st: Statement, c0: str) -> None:
        """Linear controlled sources (extension):
        E/G np nm ncp ncm gain|gm;  F/H np nm Vctrl gain|r.
        The SPICE2 `POLY(n)` form routes to _parse_poly."""
        t = st.tokens
        if len(t) > 3:
            import re as _re
            mpoly = _re.fullmatch(r"poly\((\d+)\)", t[3].lower())
            if mpoly:
                self._parse_poly(st, c0, int(mpoly.group(1)))
                return
        need = 6 if c0 in ("E", "G") else 5
        if len(t) < need:
            _warn(st.line_no, f"invalid {c0}-source: {st.raw}")
            return
        try:
            val = parse_spice_number(t[need - 1])
        except ValueError as e:
            _warn(st.line_no, f"cannot parse {c0}-source value: {e}")
            return
        if c0 == "E":
            self.ckt.add_vcvs(t[0], t[1], t[2], t[3], t[4], val)
        elif c0 == "G":
            self.ckt.add_vccs(t[0], t[1], t[2], t[3], t[4], val)
        elif c0 == "F":
            self.ckt.add_cccs(t[0], t[1], t[2], t[3], val)
        else:
            self.ckt.add_ccvs(t[0], t[1], t[2], t[3], val)

    def _parse_switch(self, st: Statement, c0: str) -> None:
        """S np nm ncp ncm model [ON|OFF] / W np nm Vctrl model [ON|OFF]
        (extension).  A trailing ON/OFF token is accepted and ignored —
        this engine's switch is the smooth non-hysteretic variant, whose
        DC state follows from the controlling quantity alone."""
        t = st.tokens
        need = 6 if c0 == "S" else 5
        if len(t) < need:
            _warn(st.line_no, f"invalid {c0}-switch: {st.raw}")
            return
        if len(t) > need and t[need].lower() not in ("on", "off"):
            _warn(st.line_no,
                  f"unexpected trailing token {t[need]!r} on {c0}-switch")
        if c0 == "S":
            self.ckt.add_switch(t[0], t[1], t[2], t[3], t[4], t[5])
        else:
            self.ckt.add_wswitch(t[0], t[1], t[2], t[3], t[4])

    def _parse_bsource(self, st: Statement) -> None:
        """B np nm V=expr | I=expr (extension): behavioral source.  The
        expression runs to the end of the statement (spaces allowed, no
        braces needed); it may reference v(node), v(a,b), i(Velem), time,
        .PARAM names, and the usual functions.  Validated at parse time;
        compiled to a JAX function at lowering."""
        import re as _re
        from ..utils.expr import parse_expr, ExprError
        t = st.tokens
        if len(t) < 4:
            _warn(st.line_no, f"invalid behavioral source: {st.raw}")
            return
        text = _re.sub(r"\s*=\s*", "=", " ".join(t[3:]))
        low = text.lower()
        if low.startswith("v="):
            is_v, expr = True, text[2:]
        elif low.startswith("i="):
            is_v, expr = False, text[2:]
        else:
            _warn(st.line_no,
                  f"behavioral source needs V=expr or I=expr: {st.raw}")
            return
        if not expr.strip():
            _warn(st.line_no, f"empty behavioral expression: {st.raw}")
            return
        try:
            parse_expr(expr, probes=True)
        except ExprError as e:
            _warn(st.line_no, f"cannot parse behavioral expression: {e}")
            return
        self.ckt.add_bsource(t[0], t[1], t[2], is_v, expr.strip())

    def _parse_tline(self, st: Statement) -> None:
        """T p1 n1 p2 n2 Z0=z TD=t | Z0=z F=f [NL=frac]  (extension:
        ideal lossless transmission line; TD = NL/F, NL defaults 0.25)."""
        import re as _re
        t = st.tokens
        if len(t) < 6:
            _warn(st.line_no, f"invalid transmission line: {st.raw}")
            return
        text = _re.sub(r"\s*=\s*", "=", " ".join(t[5:]))
        z0, td, freq, nl = 50.0, None, None, 0.25
        for tok in text.split():
            if "=" not in tok:
                _warn(st.line_no, f"invalid T-line param: {tok!r}")
                continue
            k, v = tok.lower().split("=", 1)
            try:
                val = parse_spice_number(v)
            except ValueError as e:
                _warn(st.line_no, f"cannot parse T-line param {tok}: {e}")
                return
            if k == "z0":
                z0 = val
            elif k == "td":
                td = val
            elif k == "f":
                freq = val
            elif k == "nl":
                nl = val
            else:
                _warn(st.line_no, f"unknown T-line param {k!r}")
        if td is None:
            if not freq:
                _warn(st.line_no, f"T-line needs TD= or F=: {st.raw}")
                return
            td = nl / freq
        if td <= 0 or z0 <= 0:
            _warn(st.line_no, f"T-line needs positive Z0/TD: {st.raw}")
            return
        self.ckt.add_tline(t[0], t[1], t[2], t[3], t[4], z0, td)

    def _parse_mutual(self, st: Statement) -> None:
        """K name L1 L2 k (extension): mutual inductance, 0 <= k <= 1."""
        t = st.tokens
        if len(t) < 4:
            _warn(st.line_no, f"invalid mutual inductance: {st.raw}")
            return
        try:
            k = parse_spice_number(t[3])
        except ValueError as e:
            _warn(st.line_no, f"cannot parse coupling coefficient: {e} "
                              f"in '{st.raw}'")
            return
        if abs(k) > 1.0:
            _warn(st.line_no, f"coupling |k| > 1 in '{st.raw}'; clamping")
            k = 1.0 if k > 0 else -1.0
        self.ckt.add_mutual(t[0], t[1], t[2], k)

    def _parse_diode(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 3:
            _warn(st.line_no, f"invalid diode: {st.raw}")
            return
        i_sat, n_ideal, cj0 = 1e-14, 1.0, 0.0
        bv, ibv, eg, xti = 0.0, 1e-3, 0.0, 0.0
        dev = lot = 0.0
        mult = 1.0
        for tok in t[3:]:
            key, _, val = tok.partition("=")
            try:
                if key.lower() == "m" and val:
                    mult = parse_spice_number(val)  # parallel diodes
                elif key.lower() == "is" and val:
                    i_sat = parse_spice_number(val)
                elif key.lower() == "n" and val:
                    n_ideal = parse_spice_number(val)
                elif key.lower() in ("cjo", "cj0") and val:
                    cj0 = parse_spice_number(val)
                elif key.lower() == "bv" and val:
                    bv = parse_spice_number(val)
                elif key.lower() == "ibv" and val:
                    ibv = parse_spice_number(val)
                elif key.lower() == "eg" and val:
                    eg = parse_spice_number(val)
                elif key.lower() == "xti" and val:
                    xti = parse_spice_number(val)
                elif key.lower() == "dev" and val:
                    dev = _tolval(val)      # IS mismatch (Monte-Carlo)
                elif key.lower() == "lot" and val:
                    lot = _tolval(val)
            except ValueError as e:
                _warn(st.line_no, f"cannot parse diode param: {e} in '{st.raw}'")
                return
        if mult <= 0:
            _warn(st.line_no, f"M= multiplier must be > 0: {st.raw}")
            mult = 1.0
        # M parallel diodes: current-carrying params scale (ngspice area
        # semantics applied to the multiplier)
        self.ckt.add_diode(t[0], t[1], t[2], i_sat * mult, n_ideal,
                           cj0 * mult, bv=bv, ibv=ibv * mult,
                           eg=eg, xti=xti, dev_tol=dev, lot_tol=lot)

    # ---- dot cards ----
    def _parse_dot_card(self, st: Statement) -> None:
        head = st.tokens[0].lower()
        if head == ".op":
            self.sim.do_op = True
        elif head == ".dc":
            self._parse_dc_card(st)
        elif head == ".tran":
            self._parse_tran_card(st)
        elif head == ".ac":
            self._parse_ac_card(st)
        elif head == ".print":
            self._parse_print_card(st)
        elif head == ".hb":
            self._parse_hb_card(st)
        elif head == ".noise":
            self._parse_noise_card(st)
        elif head == ".four":
            self._parse_four_card(st)
        elif head == ".ic":
            self._parse_ic_card(st)
        elif head == ".nodeset":
            self._parse_ic_card(st, target="nodesets")
        elif head in (".options", ".option"):
            import re as _re
            text = _re.sub(r"\s*=\s*", "=", " ".join(st.tokens[1:]))
            for tok in text.split():
                if "=" in tok:
                    k, v = tok.split("=", 1)
                else:
                    k, v = tok, "1"
                self.sim.options[k.lower()] = v
        elif head == ".pz":
            if len(st.tokens) < 2:
                _warn(st.line_no, f"invalid .PZ syntax: {st.raw}")
            else:
                probe = self._parse_probe_token(st.tokens[1])
                if probe.kind not in ("nv", "dv") or not probe.node1:
                    _warn(st.line_no,
                          f".PZ output must be V(node[,ref]): {st.raw}")
                else:
                    self.sim.pz = PzConfig(
                        enabled=True, out_node=probe.node1,
                        ref_node=probe.node2,
                        input_source=(st.tokens[2]
                                      if len(st.tokens) > 2 else ""))
        elif head == ".sens":
            if len(st.tokens) < 2:
                _warn(st.line_no, f"invalid .SENS syntax: {st.raw}")
            else:
                probe = self._parse_probe_token(st.tokens[1])
                if probe.kind not in ("nv", "dv") or not probe.node1:
                    _warn(st.line_no,
                          f".SENS output must be V(node[,ref]): {st.raw}")
                else:
                    self.sim.sens = SensConfig(enabled=True,
                                               out_node=probe.node1,
                                               ref_node=probe.node2)
        elif head in (".measure", ".meas"):
            self._parse_measure_card(st)
        elif head == ".param":
            pass                      # handled in the pre-pass
        elif head == ".step":
            self._parse_step_card(st)
        elif head == ".tf":
            if len(st.tokens) < 3:
                _warn(st.line_no, f"invalid .TF syntax: {st.raw}")
            else:
                probe = self._parse_probe_token(st.tokens[1])
                if probe.kind in ("nv", "dv") and probe.node1:
                    self.sim.tf = TfConfig(
                        enabled=True, out_kind="v", out_node=probe.node1,
                        ref_node=probe.node2, input_source=st.tokens[2])
                elif probe.kind == "br" and probe.ele_name:
                    self.sim.tf = TfConfig(
                        enabled=True, out_kind="i",
                        out_element=probe.ele_name,
                        input_source=st.tokens[2])
                else:
                    _warn(st.line_no,
                          f".TF output must be V(out[,ref]) or I(elem): "
                          f"{st.raw}")
        elif head == ".temp":
            if len(st.tokens) < 2:
                _warn(st.line_no, f"invalid .TEMP syntax: {st.raw}")
            else:
                try:
                    self.sim.temp_c = parse_spice_number(st.tokens[1])
                except ValueError as e:
                    _warn(st.line_no, f"cannot parse .TEMP value: {e}")
        elif head == ".plotnv":
            self._parse_plotnv_card(st)
        elif head == ".plotnc":
            self._parse_plotnc_card(st)
        elif head in (".save", ".probe"):
            # ngspice/PSpice-style output selection (extension): same probe
            # grammar as .PRINT, analysis keyword optional
            self._parse_print_card(st, allow_bare=True)
        elif head == ".end":
            pass                      # deck terminator (standard SPICE)
        else:
            _warn(st.line_no, f"unsupported control card: {st.raw}")

    # ---- .PARAM machinery (extension) ----
    @staticmethod
    def _merge_brace_groups(tokens: List[str]) -> List[str]:
        """Re-join tokens so each {...} group (which may contain spaces)
        becomes part of a single token."""
        out: List[str] = []
        buf = None
        depth = 0
        for tok in tokens:
            if buf is None:
                if "{" not in tok or tok.count("{") == tok.count("}"):
                    out.append(tok)
                    continue
                buf = tok
                depth = tok.count("{") - tok.count("}")
            else:
                buf += " " + tok
                depth += tok.count("{") - tok.count("}")
            if depth <= 0:
                out.append(buf)
                buf = None
        if buf is not None:
            out.append(buf)          # unbalanced; surfaces as a parse error
        return out

    def _collect_param_card(self, st: Statement, defs: List[tuple]) -> None:
        """.PARAM name=expr [name=expr ...]; exprs may be {braced} (allows
        spaces) or plain (no spaces)."""
        import re as _re
        text = _re.sub(r"\s*=\s*", "=", " ".join(st.tokens[1:]))
        for tok in self._merge_brace_groups(text.split()):
            if "=" not in tok:
                _warn(st.line_no, f"invalid .PARAM assignment: {tok!r}")
                continue
            name, expr = tok.split("=", 1)
            expr = expr.strip()
            if expr.startswith("{") and expr.endswith("}"):
                expr = expr[1:-1]
            if not name or not expr:
                _warn(st.line_no, f"invalid .PARAM assignment: {tok!r}")
                continue
            defs.append((name.lower(), expr, st.line_no))

    def _resolve_params(self, defs: List[tuple]) -> None:
        """Evaluate .PARAM definitions (last definition of a name wins;
        forward references allowed via iteration); .STEP overrides win."""
        from ..utils.expr import eval_expr, ExprError
        table = {}
        lines = {}
        for name, expr, line_no in defs:
            table[name] = expr
            lines[name] = line_no
        values = dict(self.param_overrides)
        for _ in range(len(table) + 1):
            missing = [n for n in table if n not in values]
            if not missing:
                break
            progress = False
            for n in missing:
                try:
                    values[n] = eval_expr(table[n], values)
                    progress = True
                except ExprError:
                    pass
            if not progress:
                break
        for n in table:
            if n not in values:
                _warn(lines[n], f".PARAM {n}: cannot resolve "
                                f"expression {table[n]!r}")
        self.param_values = values

    def _substitute_params(self, tokens: List[str],
                           line_no: int) -> List[str]:
        """Replace every {expr} group in the statement's tokens with its
        evaluated value."""
        from ..utils.expr import eval_expr, ExprError
        out = []
        for tok in self._merge_brace_groups(tokens):
            if "{" not in tok:
                out.append(tok)
                continue
            res = []
            i = 0
            while i < len(tok):
                if tok[i] == "{":
                    j = tok.find("}", i)
                    if j < 0:
                        _warn(line_no, f"unbalanced braces in {tok!r}")
                        res.append(tok[i:])
                        break
                    expr = tok[i + 1:j]
                    try:
                        res.append(repr(eval_expr(expr, self.param_values)))
                    except ExprError as e:
                        _warn(line_no, f"cannot evaluate {{{expr}}}: {e}")
                        res.append("0")
                    i = j + 1
                else:
                    res.append(tok[i])
                    i += 1
            out.append("".join(res))
        return out

    def _parse_step_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 4:
            _warn(st.line_no, f"invalid .STEP syntax: {st.raw}")
            return
        cfg = StepConfig()
        idx = 1
        if t[1].lower() == "param":
            cfg.kind = "param"
            cfg.name = t[2].lower()
            idx = 3
        elif t[1].lower() == "temp":
            cfg.kind = "temp"        # sweeps the thermal voltage kT/q
            cfg.name = "temp"
            idx = 2
        else:
            cfg.kind = "source"
            cfg.name = t[1]
            idx = 2
        try:
            if idx < len(t) and t[idx].lower() == "list":
                cfg.values = [parse_spice_number(v) for v in t[idx + 1:]]
            else:
                if len(t) < idx + 3:
                    raise ValueError("need start stop incr")
                start = parse_spice_number(t[idx])
                stop = parse_spice_number(t[idx + 1])
                incr = parse_spice_number(t[idx + 2])
                if incr == 0.0 or (stop - start) * incr < 0:
                    raise ValueError("bad increment")
                n = int(abs((stop - start) / incr) + 1e-9) + 1
                cfg.values = [start + i * incr for i in range(n)]
        except ValueError as e:
            _warn(st.line_no, f"cannot parse .STEP values: {e} in '{st.raw}'")
            return
        if not cfg.values:
            _warn(st.line_no, f".STEP with no values: {st.raw}")
            return
        self.sim.steps.append(cfg)

    _MEASURE_STATS = ("avg", "rms", "min", "max", "pp", "integ",
                      "min_at", "max_at")

    def _parse_measure_card(self, st: Statement) -> None:
        import re as _re
        # normalize '=' spacing, then re-split: 'VAL = 1.5' -> 'VAL=1.5'
        text = _re.sub(r"\s*=\s*", "=", " ".join(st.tokens[1:]))
        toks = text.split()
        if len(toks) < 3:
            _warn(st.line_no, f"invalid .MEASURE syntax: {st.raw}")
            return
        analysis = toks[0].lower()
        if analysis not in ("tran", "dc", "ac"):
            _warn(st.line_no,
                  f"unsupported .MEASURE analysis {toks[0]!r}: {st.raw}")
            return
        m = MeasureSpec(analysis=analysis, name=toks[1])
        rest = toks[2:]
        head = rest[0].lower()

        def parse_kv(tokens, ev_or_none):
            """Apply KEY=VALUE tokens to an EventSpec (or window keys to
            the MeasureSpec); returns unconsumed tokens."""
            i = 0
            while i < len(tokens):
                tok = tokens[i]
                if "=" not in tok:
                    return tokens[i:]
                k, v = tok.split("=", 1)
                k = k.lower()
                try:
                    if k in ("rise", "fall", "cross") and ev_or_none is not None:
                        ev_or_none.edge = k
                        ev_or_none.n = (-1 if v.lower() == "last"
                                        else int(float(v)))
                    elif k == "val" and ev_or_none is not None:
                        ev_or_none.val = parse_spice_number(v)
                    elif k == "td" and ev_or_none is not None:
                        ev_or_none.td = parse_spice_number(v)
                    elif k == "from":
                        m.t_from = parse_spice_number(v)
                    elif k == "to":
                        m.t_to = parse_spice_number(v)
                    elif k == "at":
                        m.at = parse_spice_number(v)
                    else:
                        _warn(st.line_no,
                              f"unknown .MEASURE key {k!r}: {st.raw}")
                except ValueError as e:
                    _warn(st.line_no, f"cannot parse .MEASURE {k}: {e}")
                i += 1
            return []

        def parse_event(tokens):
            """<probe> [VAL=v] [RISE|FALL|CROSS=n] [TD=t]; the probe token
            may carry '=val' directly (WHEN V(a)=1.5)."""
            ev = EventSpec()
            if not tokens:
                return ev, []
            ptok = tokens[0]
            if "=" in ptok and ")" in ptok and ptok.rfind("=") > ptok.rfind(")"):
                ptok, sval = ptok.rsplit("=", 1)
                try:
                    ev.val = parse_spice_number(sval)
                except ValueError as e:
                    _warn(st.line_no, f"cannot parse .MEASURE WHEN value: {e}")
            ev.probe = self._parse_probe_token(ptok)
            rest2 = parse_kv(tokens[1:], ev)
            return ev, rest2

        try:
            if head in self._MEASURE_STATS:
                m.kind = "stat"
                m.stat = head
                if len(rest) < 2:
                    raise ValueError("missing probe")
                m.probe = self._parse_probe_token(rest[1])
                parse_kv(rest[2:], None)
            elif head == "trig":
                m.kind = "trig_targ"
                try:
                    tidx = next(i for i, t in enumerate(rest)
                                if t.lower() == "targ")
                except StopIteration:
                    raise ValueError("TRIG without TARG")
                m.ev1, extra = parse_event(rest[1:tidx])
                if extra:
                    raise ValueError(f"unparsed TRIG tokens {extra}")
                m.ev2, extra = parse_event(rest[tidx + 1:])
                if extra:
                    raise ValueError(f"unparsed TARG tokens {extra}")
            elif head == "when":
                m.kind = "when"
                m.ev1, extra = parse_event(rest[1:])
                if extra:
                    raise ValueError(f"unparsed WHEN tokens {extra}")
            elif head.startswith("param="):
                m.kind = "param"
                text2 = " ".join(rest)[len("param="):].strip()
                if (len(text2) >= 2 and text2[0] == text2[-1]
                        and text2[0] in "'\""):
                    text2 = text2[1:-1]
                elif text2.startswith("{") and text2.endswith("}"):
                    text2 = text2[1:-1]
                if not text2:
                    raise ValueError("empty PARAM expression")
                from ..utils.expr import parse_expr, ExprError
                try:
                    parse_expr(text2)
                except ExprError as e2:
                    raise ValueError(f"bad PARAM expression: {e2}")
                m.expr = text2
            elif head == "find":
                if len(rest) < 3:
                    raise ValueError("FIND needs a probe and AT=/WHEN")
                m.probe = self._parse_probe_token(rest[1])
                nxt = rest[2].lower()
                if nxt.startswith("at="):
                    m.kind = "find_at"
                    parse_kv(rest[2:], None)
                elif nxt == "when":
                    m.kind = "find_when"
                    m.ev1, extra = parse_event(rest[3:])
                    if extra:
                        raise ValueError(f"unparsed WHEN tokens {extra}")
                else:
                    raise ValueError(f"FIND expects AT=/WHEN, got {rest[2]!r}")
            else:
                raise ValueError(f"unknown .MEASURE form {rest[0]!r}")
        except ValueError as e:
            _warn(st.line_no, f"invalid .MEASURE: {e} in '{st.raw}'")
            return
        self.sim.measures.append(m)

    def _parse_dc_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 5:
            _warn(st.line_no, f"invalid .DC syntax: {st.raw}")
            return
        dc = DCSweepConfig(source_name=t[1])
        try:
            dc.start = parse_spice_number(t[2])
            dc.stop = parse_spice_number(t[3])
            dc.step = parse_spice_number(t[4])
        except ValueError as e:
            _warn(st.line_no, f"cannot parse .DC numbers: {e} in '{st.raw}'")
            return
        if len(t) >= 9:
            # nested outer sweep: `.DC s1 a1 b1 d1 s2 a2 b2 d2`
            try:
                dc.source2 = t[5]
                dc.start2 = parse_spice_number(t[6])
                dc.stop2 = parse_spice_number(t[7])
                dc.step2 = parse_spice_number(t[8])
            except ValueError as e:
                _warn(st.line_no,
                      f"cannot parse .DC second-sweep numbers: {e} "
                      f"in '{st.raw}'")
                dc.source2 = ""
        self.sim.dc_sweeps.append(dc)

    def _parse_tran_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 3:
            _warn(st.line_no, f"invalid .TRAN syntax: {st.raw}")
            return
        cfg = TranConfig()
        rest = list(t[1:])
        if rest and rest[-1].lower() == "uic":
            cfg.uic = True
            rest = rest[:-1]
        if len(rest) < 2:
            _warn(st.line_no, f"invalid .TRAN syntax: {st.raw}")
            return
        try:
            cfg.tstep = parse_spice_number(rest[0])
            cfg.tstop = parse_spice_number(rest[1])
            cfg.tstart = parse_spice_number(rest[2]) if len(rest) >= 3 else 0.0
        except ValueError as e:
            _warn(st.line_no, f"cannot parse .TRAN numbers: {e} in '{st.raw}'")
            return
        cfg.enabled = True
        self.sim.tran = cfg

    def _parse_ac_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 5:
            _warn(st.line_no, f"invalid .AC syntax: {st.raw}")
            return
        cfg = AcConfig()
        low = t[1].lower()
        cfg.sweep_type = low if low in ("lin", "oct") else "dec"
        try:
            cfg.n_points = int(t[2])
            cfg.fstart = parse_spice_number(t[3])
            cfg.fstop = parse_spice_number(t[4])
        except ValueError as e:
            _warn(st.line_no, f"cannot parse .AC arguments: {e} in '{st.raw}'")
            return
        cfg.enabled = True
        self.sim.ac = cfg

    def _parse_hb_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 3:
            _warn(st.line_no, f"invalid .hb syntax: {st.raw}")
            return
        cfg = HbConfig()
        try:
            cfg.f0 = parse_spice_number(t[1])
            cfg.n_harm = int(t[2])
            for i in range(3, len(t) - 1, 2):
                cfg.extra_tones.append(
                    (parse_spice_number(t[i]), int(t[i + 1])))
        except ValueError as e:
            _warn(st.line_no, f"cannot parse .hb arguments: {e} in '{st.raw}'")
            return
        cfg.enabled = True
        self.sim.hb = cfg

    def _parse_ic_card(self, st: Statement, target: str = "ics") -> None:
        """.IC / .NODESET V(node)=value ... (extensions); also accepts the
        split form `V(node) = value`."""
        import re
        text = " ".join(st.tokens[1:])
        text = re.sub(r"\s*=\s*", "=", text)
        found = re.findall(r"[Vv]\(([^)]+)\)=(\S+)", text)
        card = ".IC" if target == "ics" else ".NODESET"
        if not found:
            _warn(st.line_no, f"invalid {card} syntax: {st.raw}")
            return
        for node, sval in found:
            try:
                getattr(self.sim, target).append(
                    (node.strip(), parse_spice_number(sval)))
            except ValueError as e:
                _warn(st.line_no, f"cannot parse {card} value: {e}")

    def _parse_four_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 3:
            _warn(st.line_no, f"invalid .FOUR syntax: {st.raw}")
            return
        cfg = FourConfig()
        try:
            cfg.f0 = parse_spice_number(t[1])
        except ValueError as e:
            _warn(st.line_no, f"cannot parse .FOUR frequency: {e}")
            return
        for tok in t[2:]:
            cfg.probes.append(self._parse_probe_token(tok))
        cfg.enabled = cfg.f0 > 0 and bool(cfg.probes)
        self.sim.four = cfg

    def _parse_noise_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 2:
            _warn(st.line_no, f"invalid .NOISE syntax: {st.raw}")
            return
        cfg = NoiseConfig()
        probe = self._parse_probe_token(t[1])
        if probe.kind not in ("nv", "dv") or not probe.node1:
            _warn(st.line_no, f".NOISE output must be V(node[,ref]): {st.raw}")
            return
        cfg.out_node = probe.node1
        cfg.ref_node = probe.node2
        i = 2
        if i < len(t) and t[i].lower() not in ("lin", "dec", "oct"):
            cfg.input_source = t[i]
            i += 1
        if i + 3 < len(t):
            cfg.sweep_type = t[i].lower()
            try:
                cfg.n_points = int(t[i + 1])
                cfg.fstart = parse_spice_number(t[i + 2])
                cfg.fstop = parse_spice_number(t[i + 3])
            except ValueError as e:
                _warn(st.line_no,
                      f"cannot parse .NOISE sweep: {e} in '{st.raw}'")
                return
        cfg.enabled = True
        self.sim.noise = cfg

    # ---- probes ----
    @staticmethod
    def _find_paren(s: str):
        l = r = -1
        for i, c in enumerate(s):
            if c == "(" and l == -1:
                l = i
            if c == ")":
                r = i
        return l, r

    _PROBE_MODS = {"v": "", "vm": "", "vdb": "db", "vp": "ph",
                   "vr": "re", "vi": "im"}

    def _parse_probe_token(self, token: str) -> ProbeSpec:
        p = ProbeSpec(expr=token)
        if not token:
            return p
        c0 = token[0].upper()
        l, r = self._find_paren(token)
        head = token[:l].lower() if l > 0 else ""
        if c0 == "V":
            p.kind = "nv"
            p.mod = self._PROBE_MODS.get(head, "")
            if l >= 0 and r > l + 1:
                inside = token[l + 1:r]
                if "," in inside:
                    a, b = inside.split(",", 1)
                    p.node1, p.node2, p.kind = a.strip(), b.strip(), "dv"
                else:
                    p.node1 = inside.strip()
        elif c0 == "I":
            p.kind = "br"
            if l >= 0 and r > l + 1:
                p.ele_name = token[l + 1:r].strip()
        return p

    def _parse_print_card(self, st: Statement, allow_bare=False) -> None:
        t = st.tokens
        if len(t) < (2 if allow_bare else 3):
            _warn(st.line_no, f"invalid {t[0].upper()}: {st.raw}")
            return
        pc = PrintCommand()
        low = t[1].lower()
        probe_start = 2
        if low not in (AN_OP, AN_DC, AN_AC, AN_TRAN, AN_HB):
            if allow_bare:
                # `.SAVE V(out) ...` — analysis-less probes (apply to every
                # analysis under --probes-only, like .PLOTNV)
                pc.analysis = AN_NONE
                probe_start = 1
            else:
                _warn(st.line_no,
                      f"unknown analysis type in .PRINT: {t[1]} "
                      f"in '{st.raw}'")
                return
        else:
            pc.analysis = low
        for tok in t[probe_start:]:
            pc.probes.append(self._parse_probe_token(tok))
        self.sim.print_commands.append(pc)

    def _parse_plotnv_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 2:
            _warn(st.line_no, f"invalid .PLOTNV: {st.raw}")
            return
        pc = PrintCommand(analysis=AN_NONE)
        for name in t[1:]:
            if name:
                pc.probes.append(self._parse_probe_token(f"V({name})"))
        if pc.probes:
            self.sim.print_commands.append(pc)

    def _parse_plotnc_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) < 2:
            _warn(st.line_no, f"invalid .PLOTNC: {st.raw}")
            return
        pc = PrintCommand(analysis=AN_NONE)
        for tok in t[1:]:
            if not tok:
                continue
            p = ProbeSpec(kind="br", expr=tok)
            l, r = self._find_paren(tok)
            if l < 0:
                p.ele_name = tok
            else:
                p.ele_name = tok[:l].strip()
                p.ele_port = tok[l + 1:r].strip()
            pc.probes.append(p)
        if pc.probes:
            self.sim.print_commands.append(pc)

    # ---- .MODEL ----
    def _parse_bjt_model_card(self, st: Statement) -> None:
        """`.MODEL id NPN|PNP [IS=x] [BF=x] [BR=x]` (also `KEY value`
        pairs); extension — the reference has MOS model cards only."""
        t = st.tokens
        m = BjtModel(name=t[1], is_pnp=t[2].lower() == "pnp")
        args = []
        for tok in t[3:]:
            key, eq, val = tok.partition("=")
            args += [key, val] if eq else [tok]
        i = 0
        while i < len(args):
            key = args[i].lower()
            if i + 1 >= len(args):
                break
            try:
                val = parse_spice_number(args[i + 1])
            except ValueError as e:
                _warn(st.line_no, f"cannot parse .MODEL param {key}: {e}")
                return
            if key == "is":
                m.i_sat = val
            elif key == "bf":
                m.bf = val
            elif key == "br":
                m.br = val
            elif key == "vaf":
                m.vaf = val
            elif key == "cje":
                m.cje = val
            elif key == "cjc":
                m.cjc = val
            elif key == "eg":
                m.eg = val
            elif key == "xti":
                m.xti = val
            i += 2
        self.ckt.add_bjt_model(m)

    def _parse_model_card(self, st: Statement) -> None:
        t = st.tokens
        if len(t) >= 3 and t[2].lower() in ("npn", "pnp"):
            self._parse_bjt_model_card(st)
            return
        if len(t) >= 3 and t[2].lower().split("(")[0] in ("sw", "csw"):
            self._parse_sw_model_card(st)
            return
        if len(t) >= 3 and t[2].lower().split("(")[0] in ("njf", "pjf"):
            self._parse_jfet_model_card(st)
            return
        if len(t) < 4:
            _warn(st.line_no, f"invalid .MODEL: {st.raw}")
            return
        m = MosModel(name=t[1])
        i = 2
        while i + 1 < len(t):
            key = t[i].lower()
            try:
                val = parse_spice_number(t[i + 1])
            except ValueError as e:
                _warn(st.line_no,
                      f"cannot parse .MODEL param {t[i]} = {t[i+1]} : {e}")
                return
            if key == "vt":
                m.vt = val
            elif key == "mu":
                m.mu = val
            elif key == "cox":
                m.cox = val
            elif key == "lambda":
                m.lam = val
            elif key in ("cj0", "cjo"):
                m.cj0 = val
            elif key == "kf":
                m.kf = val
            elif key == "af":
                m.af = val
            elif key == "gamma":
                m.gamma = val
            elif key == "phi":
                m.phi = val
            i += 2
        if m.vt < 0.0:
            m.is_p = True
            m.vt = -m.vt
        else:
            m.is_p = False
        self.ckt.add_mos_model(m)

    def _parse_jfet_model_card(self, st: Statement) -> None:
        """.MODEL id NJF|PJF [VTO=] [BETA=] [LAMBDA=] (extension)."""
        import re as _re
        from .circuit import JfetModel
        m = JfetModel(name=st.tokens[1],
                      is_p=st.tokens[2].lower().split("(")[0] == "pjf")
        text = " ".join(st.tokens[2:]).replace("(", " ").replace(")", " ")
        text = _re.sub(r"\s*=\s*", "=", text)
        for tok in text.split():
            if tok.lower() in ("njf", "pjf"):
                continue
            if "=" not in tok:
                _warn(st.line_no, f"invalid JFET model param: {tok!r}")
                continue
            k, v = tok.lower().split("=", 1)
            try:
                val = parse_spice_number(v)
            except ValueError as e:
                _warn(st.line_no, f"cannot parse .MODEL param {tok}: {e}")
                return
            if k == "vto":
                m.vto = val
            elif k == "beta":
                m.beta = val
            elif k == "lambda":
                m.lam = val
            else:
                _warn(st.line_no, f"unknown JFET model param {k!r}")
        self.ckt.add_jfet_model(m)

    def _parse_sw_model_card(self, st: Statement) -> None:
        """.MODEL id SW|CSW [RON=] [ROFF=] [VT=|IT=] [VH=|IH=]; the
        parenthesized SW(...) form is accepted too."""
        import re as _re
        from .circuit import SwModel
        m = SwModel(name=st.tokens[1])
        text = " ".join(st.tokens[2:])
        text = text.replace("(", " ").replace(")", " ")
        text = _re.sub(r"\s*=\s*", "=", text)
        for tok in text.split():
            low = tok.lower()
            if low in ("sw", "csw"):
                continue
            if "=" not in tok:
                _warn(st.line_no, f"invalid switch model param: {tok!r}")
                continue
            k, v = low.split("=", 1)
            try:
                val = parse_spice_number(v)
            except ValueError as e:
                _warn(st.line_no,
                      f"cannot parse .MODEL param {tok}: {e}")
                return
            if k == "ron":
                m.ron = val
            elif k == "roff":
                m.roff = val
            elif k in ("vt", "it"):
                m.vt = val
            elif k in ("vh", "ih"):
                m.vh = abs(val)
            else:
                _warn(st.line_no, f"unknown switch model param {k!r}")
        self.ckt.add_sw_model(m)


def parse_netlist(path: str, param_overrides: Optional[dict] = None):
    """Parse a netlist file -> (Circuit, SimulationConfig); equation indices
    are NOT yet assigned (mirror of parser.hpp:67-75)."""
    ckt = Circuit()
    sim = SimulationConfig()
    ok = NetlistParser(ckt, sim, param_overrides).parse_file(path)
    if not ok:
        raise FileNotFoundError(path)
    return ckt, sim


def parse_netlist_text(text: str, param_overrides: Optional[dict] = None):
    ckt = Circuit()
    sim = SimulationConfig()
    NetlistParser(ckt, sim, param_overrides).parse_text(text)
    return ckt, sim
