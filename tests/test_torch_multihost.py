"""The port's cross-process mesh on gloo, modelled on
tests/test_multihost.py: processes bootstrap through
parallel.mesh.multihost_init (device="cpu": gloo, virtual CPU shards),
form one mesh over all of them, and run the real collectives and
dispatches: module Q's merge, module A's chain dispatch, and the whole
pipeline. Each worker leaves its process group through `leave_group`
(rank 0, which hosts the group's store, last) before it exits; a failed
worker's siblings are killed."""

import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LEAVE = r"""
import datetime
import sys
import torch.distributed as dist
_LEAVE_PORT = int(sys.argv.pop())  # the last argument, from _run_ranks


def leave_group(pid, world):
    # Leave the group with rank 0 last. Supposed cause of a rare abort in
    # gloo's teardown under load ("terminate called without an active
    # exception", not reproduced): rank 0's process hosts the group's
    # TCPStore, and a rank whose teardown outlives it aborts. Every rank
    # passes a barrier after its last collective; ranks > 0 destroy their
    # group and then say so through a store of this handshake's own (rank
    # 0 its host), which rank 0 waits for before it destroys its group.
    store = dist.TCPStore("127.0.0.1", _LEAVE_PORT, world, pid == 0,
                          timeout=datetime.timedelta(seconds=60))
    dist.barrier()
    if pid:
        dist.destroy_process_group()
        store.set(f"left/{pid}", "1")
    else:
        store.wait([f"left/{r}" for r in range(1, world)])
        dist.destroy_process_group()
"""

_MERGE = r"""
import sys
import numpy as np
import torch.distributed as dist
from mandalorion_tpu_torch.parallel.dist import (mesh_count_matrix,
                                                 sharded_quant_merge)
from mandalorion_tpu_torch.parallel.mesh import (COLLECTIVES, make_mesh,
                                                 multihost_init)
pid, port = int(sys.argv[1]), sys.argv[2]
multihost_init(f"127.0.0.1:{port}", 2, pid, timeout_s=60, device="cpu")
try:
    mesh = make_mesh(4, device="cpu")  # 2 processes x 2 CPU shards
    assert (mesh.world, mesh.rank, len(mesh.devices)) == (2, pid, 2)
    # each process fills only its own shards' partials: the other rows
    # must not be read
    parts = np.full((4, 4, 3), -100, np.int32)
    parts[2 * pid:2 * pid + 2] = pid + 1
    total = sharded_quant_merge(mesh, parts)
    assert (total == 6).all(), total  # 1 + 1 + 2 + 2
    ids = np.repeat(np.arange(12), 3)
    assert (mesh_count_matrix(mesh, ids, 12) == 3).all()
    assert COLLECTIVES.count == 2, COLLECTIVES.count
    print(f"proc {pid} merge OK", flush=True)
    leave_group(pid, 2)
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""

_CHAIN = r"""
import hashlib, sys
import numpy as np
import torch
import torch.distributed as dist
from mandalorion_tpu_torch.align.chain import Segment, chain_segments
from mandalorion_tpu_torch.align.chain_kernel import chain_batch_rows
from mandalorion_tpu_torch.parallel.dist import mesh_count_matrix
from mandalorion_tpu_torch.parallel.mesh import (make_mesh, multihost_init,
                                                 use_mesh)
pid, port = int(sys.argv[1]), sys.argv[2]
multihost_init(f"127.0.0.1:{port}", 4, pid, timeout_s=120, device="cpu")
try:
    mesh = make_mesh(8, device="cpu")  # 4 processes x 2 CPU shards
    assert mesh.size == 8 and mesh.shape == (4, 2)
    # every process holds the same candidates (seeded): module A's chain
    # dispatch shards them over all eight shards and gathers the rows
    rng = np.random.default_rng(7)
    cap, n = 30, 21
    planes = [np.zeros((cap, 512), np.int32) for _ in range(5)]
    n_seg = np.zeros(cap, np.int32)
    seg_lists = []
    for b in range(n):
        segs, q, t = [], 0, 0
        for _ in range(int(rng.integers(3, 12))):
            ln = int(rng.integers(15, 60))
            segs.append(Segment(q, q + ln, t, t + ln, n_anchors=3))
            q += ln + int(rng.integers(0, 30))
            t += ln + int(rng.choice([0, 5, 40, 500, 3000]))
        seg_lists.append(segs)
        n_seg[b] = len(segs)
        for i, s in enumerate(segs):
            for a, v in zip(planes, (s.q_start, s.q_end, s.t_start,
                                     s.t_end, s.score_len)):
                a[b, i] = v
    kw = dict(min_intron=30, max_intron=400_000)
    cpu = torch.device("cpu")
    with use_mesh(mesh):
        rows = chain_batch_rows(*planes, n_seg, n, device=cpu, **kw)
    assert (rows == chain_batch_rows(*planes, n_seg, n, device=cpu,
                                     **kw)).all()
    msb = rows.shape[1] - 3
    for b, segs in enumerate(seg_lists):
        _chain, score = chain_segments(segs, **kw)
        best = rows[b, msb + 1:msb + 3].copy().view(np.float32)[0]
        assert best == np.float32(score), (b, best, score)
    ids = np.repeat(np.arange(12), 3)
    assert (mesh_count_matrix(mesh, ids, 12) == 3).all()
    print(f"proc {pid} digest {hashlib.sha256(rows.tobytes()).hexdigest()}",
          flush=True)
    leave_group(pid, 4)
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""

_PIPELINE = r"""
import hashlib, os, sys
import torch.distributed as dist
from mandalorion_tpu_torch.config import PipelineConfig, PoaConfig
from mandalorion_tpu_torch.parallel.mesh import (COLLECTIVES, make_mesh,
                                                 multihost_init, use_mesh)
from mandalorion_tpu_torch.pipeline.stages import run_pipeline
pid, port, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost_init(f"127.0.0.1:{port}", 2, pid, timeout_s=120, device="cpu")
try:
    cfg = PipelineConfig(threads=1, poa=PoaConfig(backend="device",
                                                  max_reads=6))
    args = [os.path.join(data, f) for f in ("genome.fasta", "ann.gtf",
                                            "reads.fasta")]
    # the meshless run first, in both processes: no collective in it
    run_pipeline(os.path.join(data, f"ref{pid}"), *args, cfg, device="cpu")
    assert COLLECTIVES.count == 0
    # the whole pipeline over a 4-shard mesh spanning both processes
    with use_mesh(make_mesh(4, device="cpu")):
        run_pipeline(os.path.join(data, f"out{pid}"), *args, cfg,
                     device="cpu")
    assert COLLECTIVES.count > 0
    h = hashlib.sha256()
    for name in ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
                 "Isoforms.filtered.clean.gtf",
                 "Isoforms.filtered.clean.quant",
                 "Isoforms.filtered.clean.tpm",
                 os.path.join("tmp", "reads2isoforms.txt")):
        a = open(os.path.join(data, f"ref{pid}", name), "rb").read()
        b = open(os.path.join(data, f"out{pid}", name), "rb").read()
        assert a and a == b, f"{name} differs from the meshless run"
        h.update(b)
    print(f"proc {pid} pipeline {h.hexdigest()} collectives "
          f"{COLLECTIVES.count}", flush=True)
    leave_group(pid, 2)
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = ROOT
    return env


def _run_ranks(code, n, *args, timeout=240):
    """Start n rank processes of `code` (after `_LEAVE`, which defines
    leave_group and takes the last argument, its store's port); returns
    their outputs. Every child is killed if one fails or the time runs
    out."""
    port = leave_port = str(_free_port())
    while leave_port == port:
        leave_port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LEAVE + code, str(pid), port,
         *map(str, args), leave_port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=_env()) for pid in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-3000:]}"
    return outs


def _tagged(outs, tag):
    found = set()
    for pid, out in enumerate(outs):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(f"proc {pid} {tag} ")]
        assert lines, out[-2000:]
        found.add(lines[0].split()[3])
    return found


def test_two_process_quant_merge():
    outs = _run_ranks(_MERGE, 2)
    for pid, out in enumerate(outs):
        assert f"proc {pid} merge OK" in out


def test_four_process_chain_dispatch():
    """Four processes x two CPU shards run module A's chain dispatch over
    one eight-shard mesh: every process gets the same rows, equal to the
    meshless rows and to the host chain's scores."""
    digests = _tagged(_run_ranks(_CHAIN, 4, timeout=300), "digest")
    assert len(digests) == 1, digests


def test_two_process_full_pipeline(tmp_path):
    """The whole pipeline (device route, device POA) over a four-shard
    mesh spanning two processes: byte-identical to the meshless run in
    each, and identical across them."""
    from mandalorion_tpu_torch.utils.simulate import make_dataset
    make_dataset(str(tmp_path), n_genes=2, n_reads_per_gene=10,
                 genome_len=40_000, exons_per_gene=(2, 3))
    digests = _tagged(_run_ranks(_PIPELINE, 2, tmp_path, timeout=600),
                      "pipeline")
    assert len(digests) == 1, digests


def test_multihost_init_fails_loudly_on_misconfiguration():
    """An explicit topology that cannot be formed raises RuntimeError
    naming it; it never goes on as one process."""
    code = (
        "from mandalorion_tpu_torch.parallel.mesh import multihost_init\n"
        "try:\n"
        "    multihost_init('127.0.0.1:1', 2, 1, timeout_s=3, "
        "device='cpu')\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', 'coordinator=127.0.0.1:1' in str(e))\n"
        "else:\n"
        "    print('SILENT')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "RAISED True", out.stdout + out.stderr


def test_multihost_init_without_topology_does_nothing():
    code = (
        "import torch.distributed as dist\n"
        "from mandalorion_tpu_torch.parallel.mesh import multihost_init\n"
        "multihost_init(device='cpu')\n"
        "print('INIT', dist.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=_env())
    assert out.stdout.strip() == "INIT False", out.stdout + out.stderr


@pytest.mark.parametrize("how", ["env", "explicit"])
def test_multihost_init_one_process_group(how):
    """A one-process gloo group from the environment (a second no-argument
    call keeps it), or from explicit arguments (a second explicit call
    raises)."""
    port = _free_port()
    if how == "env":
        call = "multihost_init(device='cpu')"
        env = dict(_env(), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="1", RANK="0")
    else:
        call = f"multihost_init('127.0.0.1:{port}', 1, 0, device='cpu')"
        env = _env()
    code = (
        "import torch.distributed as dist\n"
        "from mandalorion_tpu_torch.parallel.mesh import (make_mesh, "
        "multihost_init)\n"
        f"{call}\n"
        "try:\n"
        f"    {call}\n"
        "    again = 'kept'\n"
        "except RuntimeError as e:\n"
        "    again = 'raised' if 'already' in str(e) else str(e)\n"
        "mesh = make_mesh(2, device='cpu')\n"
        "print('MESH', mesh.world, len(mesh.devices), again)\n"
        "dist.destroy_process_group()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    want = "kept" if how == "env" else "raised"
    assert out.stdout.strip() == f"MESH 1 2 {want}", out.stdout + out.stderr
