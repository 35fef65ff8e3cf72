"""Multi-HOST validation: the sharded uniform codec over jax.distributed
with 2 local processes x 4 CPU devices = one 8-device global mesh
(SURVEY.md §4: local processes suffice — no pod needed for correctness).

Each process stages its own blocks, contributes them to the global batch via
make_array_from_process_local_data, runs the sharded compress step (the size
cumsum is a real cross-process collective), serializes its addressable block
shards, and round-trips them back to byte equality.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

WORKER = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=n, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.environ["DSRC_REPO"])
    from dsrc_tpu.parallel import uniform_pipeline as UP
    from dsrc_tpu.parallel.mesh import BLOCK_AXIS, MeshUniformCodec
    from dsrc_tpu.models.block import (
        BLOCK_UNIFORM, read_uniform_block, serialize_uniform_block,
        _rpad_bucket)
    from dsrc_tpu.utils.bitio import BitReader
    from dsrc_tpu.utils.synth import make_fastq_fast

    REC, RL = 48, 36
    devs = np.array(jax.devices())        # 8 global devices, 4 local
    assert len(devs) == 8, devs
    mesh = Mesh(devs, (BLOCK_AXIS,))
    probe = make_fastq_fast(1, RL, fixed_width=True)
    spec = UP.detect_spec(probe)
    rpad = _rpad_bucket(REC)
    codec = MeshUniformCodec(mesh, spec, rpad)

    # each process stages 4 process-local blocks
    local_blocks = []
    for i in range(4):
        seed = pid * 4 + i
        data = make_fastq_fast(REC, RL, seed=seed, fixed_width=True)
        local_blocks.append(data)
    local = np.zeros((4, rpad, spec.rec_bytes), np.uint8)
    for i, d in enumerate(local_blocks):
        local[i, :REC] = np.frombuffer(d, np.uint8).reshape(
            REC, spec.rec_bytes)

    bsh = NamedSharding(mesh, P(BLOCK_AXIS, None, None))
    vsh = NamedSharding(mesh, P(BLOCK_AXIS))
    gmats = jax.make_array_from_process_local_data(bsh, local)
    gnr = jax.make_array_from_process_local_data(
        vsh, np.full(4, REC, np.int32))
    oks, out, sizes, offsets = codec._comp(gmats, gnr)
    # replicated outputs: every process reads the same full value from its
    # local shard — the ordered-merge offsets collective crossed processes
    sizes = np.asarray(sizes.addressable_data(0))
    offsets = np.asarray(offsets.addressable_data(0))
    assert sizes.shape == (8,) and (sizes > 0).all()
    assert (offsets == np.cumsum(sizes) - sizes).all()
    oks_np = np.concatenate(
        [np.atleast_1d(np.asarray(s.data)) for s in oks.addressable_shards])
    assert bool(oks_np.all())

    # serialize + round-trip THIS process's addressable block shards
    leaves, treedef = jax.tree_util.tree_flatten(out)
    my_ids = sorted(s.index[0].start or 0
                    for s in leaves[0].addressable_shards)
    for bi, gi in enumerate(my_ids):
        shard_leaves = []
        for leaf in leaves:
            sh = [s for s in leaf.addressable_shards
                  if (s.index[0].start or 0) == gi]
            assert len(sh) == 1
            shard_leaves.append(np.asarray(sh[0].data)[0])
        comp_i = jax.tree_util.tree_unflatten(treedef, shard_leaves)
        blob, info = serialize_uniform_block(comp_i, spec, REC, rpad)
        r = BitReader(blob)
        assert r.get_byte() == BLOCK_UNIFORM
        comp_np, spec2, nrec, rpad2, wire2 = read_uniform_block(r)
        comp_j = jax.tree_util.tree_map(jnp.asarray, comp_np)
        mat = UP.decompress_uniform(comp_j, spec2, rpad2, left=True,
                                    wire=wire2)
        text = np.asarray(mat)[:nrec].reshape(-1).tobytes()
        assert text == local_blocks[bi], f"mismatch block {gi} on pid {pid}"
    print(f"pid {pid}: {len(my_ids)} blocks round-tripped OK", flush=True)
""")


def test_two_process_sharded_roundtrip(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, DSRC_REPO=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert "round-tripped OK" in out


DRIVER_WORKER = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]
    in_path, out_path = sys.argv[4], sys.argv[5]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=n, process_id=pid)
    sys.path.insert(0, os.environ["DSRC_REPO"])
    from dsrc_tpu.api import DsrcModule
    from dsrc_tpu.config import InputParameters
    mod = DsrcModule(InputParameters(fastq_block_size_bytes=1 << 17))
    mod.compress(in_path, out_path, distributed=True)
    print(f"pid {pid}: distributed compress DONE", flush=True)
""")


def test_multihost_driver_archive_byte_identical(tmp_path):
    """The user-facing multi-host driver (DsrcModule.compress(...,
    distributed=True)): 2 processes x 4 CPU devices write ONE archive
    that is byte-identical to the single-process archive, and it
    decompresses back to the input (VERDICT r4 #4; reference complete MT
    operator, DsrcOperator.cpp:230-340)."""
    import io

    from dsrc_tpu.api import DsrcModule
    from dsrc_tpu.config import InputParameters
    from dsrc_tpu.utils.synth import make_fastq_fast

    # semi-layout data (variable-digit titles) exercises the hint seeding
    data = make_fastq_fast(4000, 60, seed=21, fixed_width=False)
    fin = tmp_path / "in.fastq"
    fin.write_bytes(data)
    # single-process baseline
    base = DsrcModule(InputParameters(fastq_block_size_bytes=1 << 17))
    barch = io.BytesIO()
    base.compress(str(fin), barch)

    worker = tmp_path / "driver_worker.py"
    worker.write_text(DRIVER_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_path = tmp_path / "dist.xfqz"
    env = dict(os.environ, DSRC_REPO=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", str(port),
         str(fin), str(out_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"driver worker {i} failed:\n{out[-3000:]}"
        assert "distributed compress DONE" in out
    dist = out_path.read_bytes()
    assert dist == barch.getvalue(), (
        f"distributed archive differs: {len(dist)} vs "
        f"{barch.getbuffer().nbytes} bytes")
    # and the archive decompresses to the original input
    rt = io.BytesIO()
    DsrcModule().decompress(str(out_path), rt)
    assert rt.getvalue() == data
