"""Regex -> byte-DFA compiler for the device regex engine.

The port's own copy of ``cudf_tpu/ops/regex_dfa.py`` (pure numpy host
code; the port imports nothing of the reference package). The device
regex of cuDF (cpp/src/strings/regex/) is an NFA-program interpreter, one
warp per string; this engine instead compiles the pattern ON HOST to a
dense byte-level DFA table, and the device evaluates ALL strings in
lockstep: one step per character position, each step a vectorized gather
into the (states x 256) transition table (ops/strings.py:_device_regex).

Pipeline: ``re._parser`` parse tree -> Thompson NFA over byte sets ->
subset construction -> dense u8 table. Supported: literals (ASCII +
UTF-8 multibyte expansion), ``.``, character classes (ranges, negation,
\\d \\w \\s families), alternation, groups, bounded + unbounded repeats,
anchors ``^`` ``$``. Unsupported constructs (backrefs, lookaround,
case-insensitive flags, >250 DFA states) return None and the caller falls
back to the host re2/sre path.

Semantics notes:
  * matching is over UTF-8 bytes; callers must ensure the haystack is
    ASCII for \\d/\\w/. to agree with Python's unicode semantics
    (ops/strings.py checks and falls back otherwise);
  * byte 0 is reserved as the end-of-string sentinel: ``$`` compiles to a
    transition on it, every other state treats it as a dead input, and the
    ACCEPT state is sticky — so right-padded string matrices evaluate
    correctly in fixed-length lockstep.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

SENTINEL = 0          # end-of-string byte
DEAD = 0              # DFA dead state id (fixed)
ACCEPT = 1            # DFA sticky-accept state id (fixed)
MAX_STATES = 250
MAX_EXPAND = 32       # bounded-repeat expansion cap

_ANY = frozenset(range(1, 256)) - {10}      # '.' default: not \n, not sentinel
_ANY_DOTALL = frozenset(range(1, 256))
_D = frozenset(range(ord("0"), ord("9") + 1))
_W = _D | frozenset(range(ord("a"), ord("z") + 1)) \
        | frozenset(range(ord("A"), ord("Z") + 1)) | {ord("_")}
_S = frozenset(map(ord, " \t\n\r\f\v"))
_CATEGORIES = {
    "CATEGORY_DIGIT": _D,
    "CATEGORY_NOT_DIGIT": frozenset(range(1, 256)) - _D,
    "CATEGORY_WORD": _W,
    "CATEGORY_NOT_WORD": frozenset(range(1, 256)) - _W,
    "CATEGORY_SPACE": _S,
    "CATEGORY_NOT_SPACE": frozenset(range(1, 256)) - _S,
}


class _Unsupported(Exception):
    pass


class _NFA:
    """Thompson NFA: states are ints; eps and byte-set edges."""

    def __init__(self):
        self.eps: List[Set[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def new(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1

    def link(self, a: int, b: int):
        self.eps[a].add(b)

    def edge(self, a: int, bytes_: FrozenSet[int], b: int):
        if bytes_:
            self.edges[a].append((bytes_, b))


def _class_bytes(av) -> FrozenSet[int]:
    """Byte set for an IN node's item list."""
    out: Set[int] = set()
    negate = False
    for op, val in av:
        op = str(op)
        if op == "NEGATE":
            negate = True
        elif op == "LITERAL":
            if val > 127:
                raise _Unsupported("non-ascii class literal")
            out.add(val)
        elif op == "RANGE":
            lo, hi = val
            if hi > 127:
                raise _Unsupported("non-ascii class range")
            out.update(range(lo, hi + 1))
        elif op == "CATEGORY":
            cat = str(val)
            if cat not in _CATEGORIES:
                raise _Unsupported(cat)
            out.update(_CATEGORIES[cat])
        else:
            raise _Unsupported(op)
    if negate:
        # negated classes exclude the sentinel: [^x] must not match padding
        return frozenset(range(1, 256)) - frozenset(out)
    return frozenset(out)


def _build(nfa: _NFA, tree, start: int, dotall: bool) -> int:
    """Wire the parse-tree sequence from ``start``; return its exit state."""
    cur = start
    for op, av in tree:
        op = str(op)
        if op == "LITERAL" or op == "NOT_LITERAL":
            neg = op == "NOT_LITERAL"
            ch = av
            if ch <= 127:
                bs = frozenset({ch})
            else:
                if neg:
                    raise _Unsupported("non-ascii not-literal")
                # multibyte UTF-8 literal: chain its bytes
                bs = None
                for b in chr(ch).encode("utf-8"):
                    nxt = nfa.new()
                    nfa.edge(cur, frozenset({b}), nxt)
                    cur = nxt
                continue
            if neg:
                bs = frozenset(range(1, 256)) - bs
            nxt = nfa.new()
            nfa.edge(cur, bs, nxt)
            cur = nxt
        elif op == "ANY":
            nxt = nfa.new()
            nfa.edge(cur, _ANY_DOTALL if dotall else _ANY, nxt)
            cur = nxt
        elif op == "IN":
            nxt = nfa.new()
            nfa.edge(cur, _class_bytes(av), nxt)
            cur = nxt
        elif op == "BRANCH":
            _, branches = av
            exit_ = nfa.new()
            for br in branches:
                b_start = nfa.new()
                nfa.link(cur, b_start)
                b_end = _build(nfa, br, b_start, dotall)
                nfa.link(b_end, exit_)
            cur = exit_
        elif op == "SUBPATTERN":
            group, add_flags, del_flags, sub = av
            if add_flags or del_flags:
                raise _Unsupported("inline flags")
            cur = _build(nfa, sub, cur, dotall)
        elif op in ("MAX_REPEAT", "MIN_REPEAT"):
            lo, hi, sub = av
            import re
            unbounded = hi == getattr(re._parser, "MAXREPEAT", 2 ** 32 - 1) \
                if hasattr(re, "_parser") else hi >= 2 ** 31
            if not unbounded and hi > MAX_EXPAND:
                raise _Unsupported("huge bounded repeat")
            for _ in range(lo):
                cur = _build(nfa, sub, cur, dotall)
            if unbounded:
                # star: loop sub on cur
                loop_in = nfa.new()
                nfa.link(cur, loop_in)
                loop_out = _build(nfa, sub, loop_in, dotall)
                nfa.link(loop_out, loop_in)
                exit_ = nfa.new()
                nfa.link(cur, exit_)
                nfa.link(loop_out, exit_)
                cur = exit_
            else:
                exits = [cur]
                for _ in range(hi - lo):
                    cur = _build(nfa, sub, cur, dotall)
                    exits.append(cur)
                exit_ = nfa.new()
                for e in exits:
                    nfa.link(e, exit_)
                cur = exit_
        elif op == "AT":
            at = str(av)
            if at in ("AT_BEGINNING", "AT_BEGINNING_STRING"):
                if cur != 0:
                    # '^' mid-pattern: only matches at string start; the
                    # lockstep runner has no notion of restart — unsupported
                    raise _Unsupported("mid-pattern ^")
            elif at in ("AT_END", "AT_END_STRING"):
                nxt = nfa.new()
                nfa.edge(cur, frozenset({SENTINEL}), nxt)
                cur = nxt
            else:
                raise _Unsupported(at)
        else:
            raise _Unsupported(op)
    return cur


def compile_dfa(pattern: str, anchored: bool,
                dotall: bool = False) -> Optional[np.ndarray]:
    """Compile ``pattern`` to a (n_states, 256) u8 DFA table, or None.

    State 0 is DEAD, state 1 is sticky ACCEPT; the start state is 2.
    ``anchored=False`` wraps the pattern in an implicit leading ``.*``
    (re.search semantics); True gives re.match semantics. A string matches
    iff, after stepping every byte (right-padded with the \\0 sentinel),
    the state is ACCEPT.
    """
    try:
        import re
        parser = getattr(re, "_parser", None)
        if parser is None:  # pragma: no cover - older python
            import sre_parse as parser
        tree = parser.parse(pattern)
    except _Unsupported:
        return None
    except Exception:
        return None

    # Global inline flags ((?i)/(?m)/(?s)/(?x)…) live on tree.state.flags,
    # NOT in the node list — a DFA compiled from the nodes alone would
    # silently ignore them (ADVICE r4 high). IGNORECASE/MULTILINE change
    # match semantics we don't model: fall back to the host path. DOTALL
    # only widens '.', which we DO model: thread it through.
    import re as _re
    flags = getattr(getattr(tree, "state", None), "flags", 0)
    if flags & (_re.IGNORECASE | _re.MULTILINE | _re.LOCALE | _re.VERBOSE):
        return None
    if flags & _re.DOTALL:
        dotall = True

    # a leading '^' anchors the search: compile without the restart loop
    if len(tree) and str(tree[0][0]) == "AT" and \
            str(tree[0][1]) in ("AT_BEGINNING", "AT_BEGINNING_STRING"):
        anchored = True

    nfa = _NFA()
    start = nfa.new()  # state index 0 == `cur == 0` check for '^'
    try:
        end = _build(nfa, tree, start, dotall)
    except _Unsupported:
        return None
    accept_nfa = end

    # epsilon closures
    n = len(nfa.eps)
    closure: List[FrozenSet[int]] = []
    for i in range(n):
        seen = {i}
        stack = [i]
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        closure.append(frozenset(seen))

    start_set = set(closure[start])
    self_loop = (not anchored)
    # subset construction
    states: Dict[FrozenSet[int], int] = {}
    table: List[np.ndarray] = []

    def accepting(sset) -> bool:
        return accept_nfa in sset

    start_fs = frozenset(start_set)
    if accepting(start_fs):
        # empty pattern matches everything
        tab = np.full((3, 256), ACCEPT, np.uint8)
        tab[DEAD, :] = DEAD
        return tab

    order: List[FrozenSet[int]] = [start_fs]
    states[start_fs] = 2
    rows: List[np.ndarray] = []
    while order:
        sset = order.pop()
        sid = states[sset]
        row = np.full((256,), DEAD, np.uint8)
        # group target NFA-state sets per byte
        per_byte: Dict[int, Set[int]] = {}
        for s in sset:
            for bs, t in nfa.edges[s]:
                for b in bs:
                    per_byte.setdefault(b, set()).update(closure[t])
        if self_loop:
            # implicit .* prefix: restart candidates on every non-sentinel byte
            for b in range(1, 256):
                per_byte.setdefault(b, set()).update(start_set)
        for b, tset in per_byte.items():
            if self_loop and b != SENTINEL:
                tset = set(tset) | start_set
            tfs = frozenset(tset)
            if accepting(tfs):
                row[b] = ACCEPT
                continue
            tid = states.get(tfs)
            if tid is None:
                tid = 2 + len(states)
                if tid >= MAX_STATES:
                    return None
                states[tfs] = tid
                order.append(tfs)
            row[b] = tid
        rows.append((sid, row))

    n_states = 2 + len(states)
    tab = np.full((n_states, 256), DEAD, np.uint8)
    tab[ACCEPT, :] = ACCEPT  # sticky
    for sid, row in rows:
        tab[sid] = row
    return tab


def byte_classes(tab: np.ndarray):
    """(classmap u8[256], n_classes): bytes whose transition COLUMNS are
    identical across all states are equivalent inputs — the standard DFA
    alphabet compression (RE2 does the same, bytemap in re2/prog.h)."""
    cols = tab.T  # (256, S)
    seen: dict = {}
    cmap = np.zeros(256, np.uint8)
    for b in range(256):
        key = cols[b].tobytes()
        cid = seen.get(key)
        if cid is None:
            cid = len(seen)
            seen[key] = cid
        cmap[b] = cid
    return cmap, len(seen)


def pair_table(tab: np.ndarray, cmap: np.ndarray, n_classes: int):
    """One-hot next-state rows indexed by (state, class-pair), the
    reference's two-characters-a-step table for an accelerator where row
    gathers are cheap. Kept for parity with the reference; the port's
    device engine steps with ``pair_steps``' int32 table instead.

    Returns (P, width): P is (n_states * n_classes^2, width) f32 with
    P[s*C*C + c1*C + c2] = onehot(tab2[s, c1, c2]), width = next pow2 >=
    n_states."""
    S = tab.shape[0]
    C = n_classes
    # class-indexed single-step table
    rep = np.zeros(C, np.int64)  # representative byte per class
    for b in range(255, -1, -1):
        rep[cmap[b]] = b
    t1 = tab[:, rep]  # (S, C)
    # two-step composition: next2[s, c1, c2] = t1[t1[s, c1], c2]
    next2 = t1[t1, :]  # (S, C, C)
    width = 8
    while width < S:
        width *= 2
    P = np.zeros((S * C * C, width), np.float32)
    flat = next2.reshape(-1)
    P[np.arange(S * C * C), flat] = 1.0
    return P, width


def pair_steps(tab: np.ndarray, cmap: np.ndarray, n_classes: int) -> np.ndarray:
    """int32 (n_states * n_classes^2,) two-step table over byte classes:
    ``next2[s * C * C + c1 * C + c2] = tab[tab[s, rep(c1)], rep(c2)]``, the
    state after the class pair (c1, c2) from state s. ``pair_table``'s
    rows, one-hot decoded: a scalar gather per two characters."""
    C = n_classes
    rep = np.zeros(C, np.int64)  # representative byte per class
    for b in range(255, -1, -1):
        rep[cmap[b]] = b
    t1 = tab[:, rep].astype(np.int64)  # (S, C)
    return np.ascontiguousarray(t1[t1, :].reshape(-1).astype(np.int32))


def dfa_match_host(tab: np.ndarray, strings, max_len: Optional[int] = None):
    """Host-side reference evaluation (tests): match flags per string."""
    out = np.zeros(len(strings), bool)
    for i, s in enumerate(strings):
        state = 2
        for b in s.encode("utf-8") + b"\x00":
            state = tab[state, b]
            if state == ACCEPT:
                break
            if state == DEAD:
                break
        out[i] = state == ACCEPT
    return out
