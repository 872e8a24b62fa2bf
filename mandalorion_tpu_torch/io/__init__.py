"""File-format layer: fastx / PSL / GTF / SAM / BED readers and writers.

Replaces the reference's scattered parsers (`emtrey.py`,
`SpliceDefineConsensus.py:14-93,334-389`, `filterIsoforms.py:74-79`) and the
mappy C extension's `fastx_read` / `revcomp`.
"""

from mandalorion_tpu_torch.io.fastx import (  # noqa: F401
    read_fastx, write_fasta, revcomp, expand_fofn, fastx_to_dict)
from mandalorion_tpu_torch.io.psl import (  # noqa: F401
    PslRecord, parse_psl_line, format_psl, read_psl, write_psl)
from mandalorion_tpu_torch.io.gtf import (  # noqa: F401
    parse_annotation, parse_gene_exons, write_gtf_from_psl)
from mandalorion_tpu_torch.io.sam import (  # noqa: F401
    sam_to_psl_line, sam_to_psl, filter_sam)
