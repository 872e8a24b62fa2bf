"""Satellite tools (SURVEY §2.1 C16-C20): polyA trimming, TPM conversion
(core/quant.convert_quant_to_tpm), LRGASP export, PSLX conversion, HLA
typing, SNP phasing."""

from mandalorion_tpu_torch.utils.polya import (  # noqa: F401
    orient_and_trim, remove_polya, trim_fastx)
from mandalorion_tpu_torch.utils.lrgasp import export_lrgasp  # noqa: F401
from mandalorion_tpu_torch.utils.pslx import psl_to_pslx  # noqa: F401
