"""polyA-tail trimming (input prep).

Behavioral equivalent of `utils/removePolyA.py:22-49` (probed semantics,
SURVEY §2.1 C16): scanning the read 3'->5', arm after 6 consecutive A;
then track the last position of any >=3-A run while counting non-A bases;
3 non-A bases end the tail — trim keeps everything from the last such A
(exactly one tail A survives). A read that never arms, or stays armed to
the end, is returned untouched.

Fast path: a vectorized scan finds the arming point (first 6-A run of the
reversed read); the exact state machine then runs only over the short tail
region instead of the whole read.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mandalorion_tpu_torch.io.fastx import read_fastx, revcomp


def remove_polya(seq: str) -> Tuple[str, bool]:
    """Trim the 3' polyA tail; returns (trimmed_seq, had_tail)."""
    reverse = seq[::-1]
    # vectorized arming scan: position of the FIRST 6-A run (the state
    # machine up to that point only counts the run, so it can be skipped)
    arr = np.frombuffer(reverse.encode(), np.uint8) == ord("A")
    if len(arr) >= 6:
        run = np.convolve(arr.astype(np.int8), np.ones(6, np.int8), "valid")
        armed_at = np.flatnonzero(run == 6)
    else:
        armed_at = np.zeros(0, np.int64)
    if len(armed_at) == 0:
        return seq, False
    # arming position = 6th A of the first run; replicate the reference's
    # same-iteration fallthrough (Astretch becomes 7, last_a = arm_pos)
    arm_pos = int(armed_at[0]) + 5
    trim_pos = _armed_scan(reverse, arm_pos)
    return reverse[trim_pos:][::-1], True


def _armed_scan(reverse: str, arm_pos: int) -> int:
    """The armed phase of the reference state machine, starting just after
    the arming position. Returns trim position (0 = no trim)."""
    astretch = 7
    vstretch = 0
    last_a = arm_pos
    for pos in range(arm_pos + 1, len(reverse)):
        if reverse[pos] != "A":
            vstretch += 1
            astretch = 0
        else:
            astretch += 1
            if astretch >= 3:
                vstretch = 0
                last_a = pos
        if vstretch >= 3:
            return last_a
    return 0


def remove_polya_detailed(seq: str) -> Tuple[str, bool, int, int]:
    """Non-directional variant internals: also returns the arming position
    and trim position (`removePolyA_nonDirectionalInput.py:4-31`)."""
    reverse = seq[::-1]
    astate = False
    astretch = vstretch = trim_pos = astart = 0
    last_a = 0
    for pos, base in enumerate(reverse):
        if not astate:
            if base == "A":
                astretch += 1
                if astretch == 6:
                    astate = True
                    last_a = pos
                    astart = pos
            else:
                astretch = 0
        if astate:
            if base != "A":
                vstretch += 1
                astretch = 0
            else:
                astretch += 1
                if astretch >= 3:
                    vstretch = 0
                    last_a = pos
            if vstretch >= 3:
                trim_pos = last_a
                break
    return reverse[trim_pos:][::-1], astate, astart, trim_pos


def orient_and_trim(seq: str) -> Optional[str]:
    """Non-directional input: try both orientations, keep the one whose
    polyA starts earlier (ties broken by larger trim), None when neither
    orientation shows a tail (`removePolyA_nonDirectionalInput.py:55-78`)."""
    f_seq, f_state, f_start, f_trim = remove_polya_detailed(seq)
    r_seq, r_state, r_start, r_trim = remove_polya_detailed(revcomp(seq))
    if f_state and not r_state:
        return f_seq
    if r_state and not f_state:
        return r_seq
    if f_state and r_state:
        if f_start < r_start:
            return f_seq
        if r_start < f_start:
            return r_seq
        if f_trim > r_trim:
            return f_seq
        if r_trim > f_trim:
            return r_seq
    return None


def trim_fastx(in_path: str, out_path: str,
               trimmed_bases: Optional[Tuple[int, int]] = None,
               directional: bool = True) -> int:
    """File-level polyA trimmer (the removePolyA CLI). trimmed_bases
    (n5, n3) are cut before tail detection. Returns reads written."""
    n = 0
    with open(out_path, "w") as out:
        for name, seq, _q in read_fastx(in_path):
            if trimmed_bases:
                n5, n3 = trimmed_bases
                seq = seq[n5:-n3] if n3 else seq[n5:]
            if directional:
                trimmed, _ = remove_polya(seq)
                out.write(f">{name}\n{trimmed}\n")
                n += 1
            else:
                oriented = orient_and_trim(seq)
                if oriented is not None:
                    out.write(f">{name}\n{oriented}\n")
                    n += 1
    return n
