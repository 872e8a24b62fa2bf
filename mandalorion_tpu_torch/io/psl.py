"""PSL and extended ("mando") PSL records.

The 24-column extended PSL is the reference pipeline's interchange format
(SURVEY §2.4): standard PSL cols 0-20 plus col 21 accuracy, col 22 long-form
cs string, col 23 read sequence in original orientation (`emtrey.py:146-148`).
Comma lists (cols 18-20) carry a trailing comma.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional


@dataclass
class PslRecord:
    matches: int = 0
    mismatches: int = 0
    rep_matches: int = 0
    n_count: int = 0           # col 3: intron ('N') bases in the reference's emtrey
    q_num_insert: int = 0
    q_base_insert: int = 0
    t_num_insert: int = 0
    t_base_insert: int = 0
    strand: str = "+"
    q_name: str = ""
    q_size: int = 0
    q_start: int = 0
    q_end: int = 0
    t_name: str = ""
    t_size: int = 0
    t_start: int = 0
    t_end: int = 0
    block_count: int = 0
    block_sizes: List[int] = field(default_factory=list)
    q_starts: List[int] = field(default_factory=list)
    t_starts: List[int] = field(default_factory=list)
    # extended (mando) columns
    accuracy: Optional[float] = None
    cs: Optional[str] = None
    sequence: Optional[str] = None

    @property
    def extended(self) -> bool:
        return self.accuracy is not None


def _int_list(csv: str) -> List[int]:
    return [int(x) for x in csv.split(",")[:-1]]


def parse_psl_line(line: str) -> PslRecord:
    a = line.rstrip("\n").split("\t")
    rec = PslRecord(
        matches=int(a[0]), mismatches=int(a[1]), rep_matches=int(a[2]),
        n_count=int(a[3]), q_num_insert=int(a[4]), q_base_insert=int(a[5]),
        t_num_insert=int(a[6]), t_base_insert=int(a[7]), strand=a[8],
        q_name=a[9], q_size=int(a[10]), q_start=int(a[11]), q_end=int(a[12]),
        t_name=a[13], t_size=int(a[14]), t_start=int(a[15]), t_end=int(a[16]),
        block_count=int(a[17]), block_sizes=_int_list(a[18]),
        q_starts=_int_list(a[19]), t_starts=_int_list(a[20]),
    )
    if len(a) >= 24:
        rec.accuracy = float(a[21])
        rec.cs = a[22]
        rec.sequence = a[23]
    return rec


def _fmt_list(xs: List[int]) -> str:
    return ",".join(str(x) for x in xs) + ","


def format_psl(rec: PslRecord) -> str:
    cols = [
        rec.matches, rec.mismatches, rec.rep_matches, rec.n_count,
        rec.q_num_insert, rec.q_base_insert, rec.t_num_insert,
        rec.t_base_insert, rec.strand, rec.q_name, rec.q_size, rec.q_start,
        rec.q_end, rec.t_name, rec.t_size, rec.t_start, rec.t_end,
        rec.block_count, _fmt_list(rec.block_sizes),
        _fmt_list(rec.q_starts), _fmt_list(rec.t_starts),
    ]
    line = "\t".join(str(c) for c in cols)
    if rec.extended:
        line += f"\t{rec.accuracy}\t{rec.cs}\t{rec.sequence}"
    return line


def read_psl(path: str) -> Iterator[PslRecord]:
    with open(path) as fh:
        for line in fh:
            if line.strip():
                yield parse_psl_line(line)


def write_psl(path: str, records, append: bool = False) -> None:
    with open(path, "a" if append else "w") as fh:
        for rec in records:
            fh.write(format_psl(rec) + "\n")


def psl_sort_key(line: str):
    """Sort key matching GNU `sort -k 14,14 -k 16,17n` under C collation
    (`Mando.py:346-349`): chromosome bytewise, then tStart numerically
    (GNU's numeric parse of the field-16..17 span stops at the tab, so
    tEnd only matters via the last-resort comparison), then GNU's
    last-resort whole-line bytewise tie-break."""
    # maxsplit stops before the long tail columns (comma lists, cs,
    # sequence) — the key only needs fields 14 and 16
    a = line.split("\t", 16)
    return (a[13].encode(), int(a[15]), line.encode())


def sort_psl_file(in_path: str, out_path: str) -> None:
    """External-sort replacement: in-memory sort by (tName, tStart, tEnd)."""
    with open(in_path) as fh:
        lines = [ln for ln in fh if ln.strip()]
    lines.sort(key=psl_sort_key)
    with open(out_path, "w") as out:
        out.writelines(lines)
