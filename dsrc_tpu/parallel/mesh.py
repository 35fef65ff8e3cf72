"""Multi-chip block-parallel compression over a jax.sharding.Mesh.

The reference's parallelism is block data-parallelism with ordered merge
(DataQueue.h / DsrcWorker.cpp, SURVEY.md §2.5).  The device equivalent
(SURVEY.md §5.8): a batch of D blocks is sharded one-per-device along a
'blocks' mesh axis, each device runs the full uniform block codec on its
block, and only the tiny per-block *size* vector crosses devices (a cumsum
collective) so every host can compute archive offsets — payload bytes never
move between chips; the ordered merge of the reference's writer thread
(DsrcIo.cpp:19-89) becomes offset arithmetic.

Both directions are real: `MeshUniformCodec.compress_blocks` produces the
same serialized archive blobs as the single-chip BlockCodec (byte-identical
container), and `decompress_blocks` is its sharded decode twin.  The codec is
wired into DsrcModule behind a device-count check (api.py) and validated by
__graft_entry__.dryrun_multichip with a full byte-compare round-trip.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.block import (BLOCK_SEMI, BLOCK_UNIFORM, StreamsInfo,
                            _rpad_bucket, read_uniform_block,
                            semi_tok_comp_device, serialize_semi_tok_block,
                            serialize_uniform_block)
from ..parallel import uniform_pipeline as UP
from ..utils.bitio import BitReader

BLOCK_AXIS = "blocks"


def local_device_mesh(max_devices: int = 0) -> Optional[Mesh]:
    """1-D 'blocks' mesh over the available devices (None when single)."""
    devs = jax.devices()
    if max_devices:
        devs = devs[:max_devices]
    if len(devs) < 2:
        return None
    return Mesh(np.array(devs), (BLOCK_AXIS,))


class MeshUniformCodec:
    """Sharded batch codec for uniform fixed-layout FASTQ blocks.

    One batch = D blocks (one per device).  Block text/payloads stay on
    their device; sizes/offsets are the only cross-device values.
    """

    def __init__(self, mesh: Mesh, spec: UP.UniformSpec, rpad: int,
                 wire: UP.Wire = UP.WIRE_DEFAULT):
        self.mesh = mesh
        self.spec = spec
        self.rpad = rpad
        self.wire = wire
        self.n_devices = int(np.prod(mesh.devices.shape))
        self._bsh = NamedSharding(mesh, P(BLOCK_AXIS, None, None))
        self._vsh = NamedSharding(mesh, P(BLOCK_AXIS))
        rep = NamedSharding(mesh, P())

        @functools.partial(jax.jit, out_shardings=(None, None, rep, rep))
        def _comp(mats, nrecs):
            def one(m, n):
                ok = UP.check_uniform(m, spec, n)
                return ok, UP.compress_uniform(m, n, spec, rpad, wire=wire)
            oks, out = jax.vmap(one)(mats, nrecs)
            # int32 deliberately: comp_bytes is bounded by the block
            # capacity (< 2^31 B) — jnp int64 would silently truncate to
            # int32 anyway without jax_enable_x64
            sizes = out["comp_bytes"].astype(jnp.int32)
            # the 'ordered merge' collective: global offsets from the
            # all-gathered size vector (reference: DsrcWriter's partId map)
            offsets = jnp.cumsum(sizes) - sizes
            return oks, out, sizes, offsets

        self._comp = _comp

        @jax.jit
        def _dec(comp):
            return jax.vmap(
                lambda c: UP.decompress_uniform(c, spec, rpad, left=True,
                                                wire=wire)
            )(comp)

        self._dec = _dec

    # ---------------------------------------------------------- compress
    def compress_blocks(self, mats: np.ndarray, num_recs: Sequence[int]
                        ) -> Tuple[List[Optional[Tuple[bytes, StreamsInfo]]],
                                   np.ndarray]:
        """mats: [D, rpad, rec_bytes] uint8 (one block per device).

        Returns ([D] of (blob, info) — None where the block failed the
        uniformity check and must go through the generic codec — and the
        device-computed archive offsets)."""
        d = mats.shape[0]
        assert d == self.n_devices, "one block per device"
        mats_s = jax.device_put(mats, self._bsh)
        nr = jax.device_put(np.asarray(num_recs, np.int32), self._vsh)
        oks, out, sizes, offsets = self._comp(mats_s, nr)
        oks = np.asarray(oks)
        results: List[Optional[Tuple[bytes, StreamsInfo]]] = []
        for i in range(d):
            if not oks[i]:
                results.append(None)
                continue
            comp_i = jax.tree_util.tree_map(lambda x: x[i], out)
            results.append(serialize_uniform_block(
                comp_i, self.spec, int(num_recs[i]), self.rpad,
                wire=self.wire))
        return results, np.asarray(offsets)

    # ---------------------------------------------------------- decompress
    def matches(self, comp_np, spec, rpad, wire=None) -> bool:
        return (spec == self.spec and rpad == self.rpad
                and (wire is None or wire == self.wire))

    def decompress_blocks(self, comps: Sequence[dict],
                          num_recs: Sequence[int]) -> List[np.ndarray]:
        """comps: [D] canonical numpy pytrees from read_uniform_block.
        Returns [D] decoded FASTQ text arrays."""
        d = len(comps)
        assert d == self.n_devices
        batched = jax.tree_util.tree_map(
            lambda *xs: np.stack(xs), *comps)
        shardings = jax.tree_util.tree_map(
            lambda x: NamedSharding(
                self.mesh, P(BLOCK_AXIS, *([None] * (x.ndim - 1)))),
            batched)
        staged = jax.tree_util.tree_map(jax.device_put, batched, shardings)
        mats = self._dec(staged)
        texts = []
        for i in range(d):
            nrec = int(num_recs[i])
            texts.append(np.asarray(mats[i])[:nrec].reshape(-1))
        return texts


class MeshSemiCodec:
    """Sharded batch codec for semi-uniform (fixed read length, variable
    title) FASTQ blocks with tokenized titles (mode 2) — the block class
    real Illumina runs hit.  One batch = D blocks, one per device; the
    fused per-device program codes title values + quality + DNA; only the
    size vector crosses devices (reference: every block class flows
    through the same worker pool, DsrcWorker.cpp:30-73)."""

    def __init__(self, mesh: Mesh, read_len: int, rpad: int, pcs: tuple,
                 wire: UP.Wire = UP.WIRE_DEFAULT):
        self.mesh = mesh
        self.read_len = read_len
        self.rpad = rpad
        self.pcs = tuple(pcs)
        self.wire = wire
        self.n_devices = int(np.prod(mesh.devices.shape))
        rep = NamedSharding(mesh, P())
        bsh = NamedSharding(mesh, P(BLOCK_AXIS, None, None))
        vsh = NamedSharding(mesh, P(BLOCK_AXIS))
        self._bsh, self._vsh = bsh, vsh
        self._msh = NamedSharding(mesh, P(BLOCK_AXIS, None))

        @functools.partial(jax.jit, out_shardings=(None, rep, rep))
        def _comp(vmats, v0s, quals, seqs, nrecs):
            def one(v, b, qm, sm, n):
                return UP.compress_semi_tok(v, b, qm, sm, n, self.pcs,
                                            read_len, rpad, wire=wire)
            out = jax.vmap(one)(vmats, v0s, quals, seqs, nrecs)
            sizes = out["comp_bytes"].astype(jnp.int32)
            offsets = jnp.cumsum(sizes) - sizes
            return out, sizes, offsets

        self._comp = _comp

        @jax.jit
        def _dec(comp, v0s):
            return jax.vmap(lambda c, b: UP.decompress_semi_tok(
                c, b, self.pcs, read_len, rpad, left=True, wire=wire)
            )(comp, v0s)

        self._dec = _dec

    def matches(self, read_len: int, rpad: int, pcs, wire) -> bool:
        return (read_len == self.read_len and rpad == self.rpad
                and tuple(pcs) == self.pcs and wire == self.wire)

    def compress_blocks(self, staged: Sequence[dict]
                        ) -> Tuple[List[Tuple[bytes, StreamsInfo]],
                                   np.ndarray]:
        """staged: [D] dicts with vmat [rpad, F], v0 [F], qm/sm
        [rpad, read_len], num_rec, tok_meta, tag_len."""
        d = len(staged)
        assert d == self.n_devices, "one block per device"
        vm = jax.device_put(np.stack([s["vmat"] for s in staged]),
                            self._bsh)
        v0 = jax.device_put(np.stack([s["v0"] for s in staged]), self._msh)
        qm = jax.device_put(np.stack([s["qm"] for s in staged]), self._bsh)
        sm = jax.device_put(np.stack([s["sm"] for s in staged]), self._bsh)
        nr = jax.device_put(
            np.asarray([s["num_rec"] for s in staged], np.int32),
            self._vsh)
        out, sizes, offsets = self._comp(vm, v0, qm, sm, nr)
        results = []
        for i in range(d):
            comp_i = jax.tree_util.tree_map(lambda x: x[i], out)
            results.append(serialize_semi_tok_block(
                comp_i, staged[i]["num_rec"], self.rpad, self.read_len,
                self.pcs, staged[i]["v0"], staged[i]["tok_meta"],
                staged[i]["tag_len"], wire=self.wire))
        return results, np.asarray(offsets)

    def decompress_blocks(self, parsed: Sequence[dict]) -> List[np.ndarray]:
        """parsed: [D] mode-2 dicts from models.block.parse_semi_block.
        Returns [D] decoded FASTQ text arrays."""
        from ..models import tag as TAG
        from ..utils import native
        d = len(parsed)
        assert d == self.n_devices
        comps = [semi_tok_comp_device(p) for p in parsed]
        batched = jax.tree_util.tree_map(lambda *xs: np.stack(
            [np.asarray(x) for x in xs]), *comps)
        shardings = jax.tree_util.tree_map(
            lambda x: NamedSharding(
                self.mesh, P(BLOCK_AXIS, *([None] * (x.ndim - 1)))),
            batched)
        staged = jax.tree_util.tree_map(jax.device_put, batched, shardings)
        v0 = jax.device_put(np.stack([p["v0"] for p in parsed]), self._msh)
        vmats, quals, seqs = self._dec(staged, v0)
        texts = []
        for i in range(d):
            p = parsed[i]
            nrec = p["num_rec"]
            titles_np, tl = TAG.render_value_titles(
                np.asarray(vmats[i]), p["tok_meta"], nrec)
            texts.append(native.layout_records(
                nrec, titles_np, tl,
                np.asarray(seqs[i])[:nrec].reshape(-1),
                np.asarray(quals[i])[:nrec].reshape(-1),
                np.full(nrec, self.read_len, np.int64),
                None, False, False))
        return texts


def dryrun(n_devices: int, records_per_block: int = 64,
           read_len: int = 40) -> None:
    """Full multi-chip round-trip on an n_devices mesh: shard 2 batches of
    uniform blocks, compress on-device, serialize to archive blobs, decode
    through the sharded twin, and byte-compare (driver validation hook; also
    run by tests on the virtual CPU mesh)."""
    from ..utils.synth import make_fastq_fast

    devs = np.array(jax.devices()[:n_devices])
    mesh = Mesh(devs, (BLOCK_AXIS,))
    probe = make_fastq_fast(1, read_len, fixed_width=True)
    spec = UP.detect_spec(probe)
    assert spec is not None
    rpad = _rpad_bucket(records_per_block)
    codec = MeshUniformCodec(mesh, spec, rpad)

    blobs: List[bytes] = []
    originals: List[bytes] = []
    for batch in range(2):
        mats = np.zeros((n_devices, rpad, spec.rec_bytes), np.uint8)
        for i in range(n_devices):
            data = make_fastq_fast(records_per_block, read_len,
                                   seed=batch * n_devices + i,
                                   fixed_width=True)
            originals.append(data)
            mats[i, :records_per_block] = np.frombuffer(
                data, np.uint8).reshape(records_per_block, spec.rec_bytes)
        results, offsets = codec.compress_blocks(
            mats, [records_per_block] * n_devices)
        assert all(r is not None for r in results), "uniformity check failed"
        sizes = np.array([len(r[0]) for r in results], np.int64)
        # offset arithmetic must describe a valid ordered concat
        assert (np.diff(offsets) >= 0).all()
        blobs.extend(r[0] for r in results)

    # decode twin: read blobs back and shard the decode
    for batch in range(2):
        comps, nrecs = [], []
        for blob in blobs[batch * n_devices:(batch + 1) * n_devices]:
            r = BitReader(blob)
            assert r.get_byte() == BLOCK_UNIFORM
            comp_np, spec2, nrec, rpad2, wire2 = read_uniform_block(r)
            assert codec.matches(comp_np, spec2, rpad2, wire2)
            comps.append(comp_np)
            nrecs.append(nrec)
        texts = codec.decompress_blocks(comps, nrecs)
        for i, text in enumerate(texts):
            expect = originals[batch * n_devices + i]
            assert text.tobytes() == expect, \
                f"multi-chip round-trip mismatch on block {i}"

    # ---- semi (variable-digit titles, tokenized mode 2) sharded batch ----
    from ..models import tag as TAG
    from ..models.block import (parse_semi_block, semi_tok_planes,
                                stage_semi_raw)

    rpad_s = _rpad_bucket(records_per_block)
    semi_data: List[bytes] = []
    staged: List[dict] = []
    pcs_hint: dict = {}
    for i in range(n_devices):
        data = make_fastq_fast(records_per_block, read_len, seed=100 + i,
                               fixed_width=False)
        semi_data.append(data)
        st = stage_semi_raw(np.frombuffer(data, np.uint8))
        assert st is not None
        rl2, num_rec, qm, sm, tstream, tl = st
        tok = TAG.analyze_value_fields(np.asarray(tstream, np.uint8),
                                       np.asarray(tl))
        assert tok is not None
        vmat, meta = tok
        v0, _ = semi_tok_planes(vmat, num_rec, pcs_hint)
        vpad = np.zeros((rpad_s, vmat.shape[1]), np.int32)
        vpad[:num_rec] = vmat
        staged.append(dict(vmat=vpad, v0=v0, qm=qm[:rpad_s],
                           sm=sm[:rpad_s], num_rec=num_rec, tok_meta=meta,
                           tag_len=len(tstream)))
    pcs = tuple(pcs_hint[f] for f in range(len(pcs_hint)))
    scodec = MeshSemiCodec(mesh, rl2, rpad_s, pcs)
    sresults, soffsets = scodec.compress_blocks(staged)
    assert (np.diff(soffsets) >= 0).all()
    parsed = []
    for blob, _info in sresults:
        r = BitReader(blob)
        assert r.get_byte() == BLOCK_SEMI
        p = parse_semi_block(r, 1 << 22)
        assert p["mode"] == 2
        assert scodec.matches(p["read_len"], p["rpad"], p["pcs"],
                              p["wire"])
        parsed.append(p)
    stexts = scodec.decompress_blocks(parsed)
    for i, text in enumerate(stexts):
        assert text.tobytes() == semi_data[i], \
            f"multi-chip SEMI round-trip mismatch on block {i}"
