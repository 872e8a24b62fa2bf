"""Small samples of the benchmark's data generators for the CPU tests:
the genome, annotation and reads of a few planted genes, and what each
generator's judge needs to judge a run's answer.

The generators (benchmark/generators/<name>.py) import only numpy and
the benchmark's own `bm_data` and `bm_reference`; they are loaded by
path, with benchmark/ on the import path, as the benchmark loads them.

`EVENTS` is `isoform_events` cut to 6 genes on 1.5 Mbp with short exons
and introns (so that the plain POA forward of `--consensus_backend
device` stays within seconds on the CPU) and tandem sites 300-319 bp
apart; its isoform seed gives the 3 genes of mix seed 4 every event
kind, and the deepest of them a tandem pair of 10 reads or more. `SKIPS`
is `planted_isoforms` (exon skipping alone) on the same genes.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

import bm_data  # noqa: E402
import bm_reference  # noqa: E402

LAYOUT = dict(genome_bp=1_500_000, n_genes=6, exon_len=[150, 250],
              intron_len=[200, 1200], exons_per_gene=[2, 5])
EVENTS = ("isoform_events", "chr21_r2c2_isoforms",
          dict(LAYOUT, isoform_seed=48), {"tandem_ext": [300, 320]})
SKIPS = ("planted_isoforms", "chr21_r2c2_cardpoa", dict(LAYOUT), {})
SEED = 2**31 + 5


def generator(name: str):
    key = f"bm_generators_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(BENCH, "generators", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


@dataclasses.dataclass
class Sample:
    args: list          # the CLI's -G, -g and -f
    gen: object
    config: dict
    layout: object
    sample: object

    def judge(self, out_dir: str) -> dict:
        return self.gen.judge(self.layout, self.config, self.sample,
                              bm_reference.parse_answer(out_dir))


def make(out_dir: str, which=EVENTS, top: int = 80) -> Sample:
    """A sample of 3 genes at Zipf depths top / (1 + r) (mix seed 4) of a
    generator cut as `which` says, written under out_dir."""
    name, config_name, layout, events = which
    with open(os.path.join(BENCH, "configs", f"{config_name}.json")) as fh:
        config = json.load(fh)
    config = copy.deepcopy(config)
    config["layout"].update(layout)
    config.get("events", {}).update(events)
    gen = generator(name)
    lay = gen.make_layout(config, bm_data.sub_seed(SEED, 1))
    genome, ann = gen.write_layout(lay, out_dir)
    mix = {"expression": {"genes": 3, "zipf_top": top, "first_rank": 1,
                          "profile_seed": 4}}
    profile = gen.expression(mix, lay)
    sample = gen.make_sample(lay, config, profile,
                             bm_data.sub_seed(SEED, 2, 0),
                             os.path.join(out_dir, "reads.fasta"))
    return Sample(["-G", genome, "-g", ann, "-f", sample.path], gen, config,
                  lay, sample)
