"""Frontend embedding-operation specifications.

These are the operations the Ember paper characterizes (Table 1) and
compiles: the PyTorch ``nn.EmbeddingBag`` / Caffe2 SLS family, knowledge-graph
semiring lookups, block-sparse-attention gathers, GNN SpMM aggregation, and
message-passing FusedMM (SDDMM+SpMM).  An :class:`EmbeddingOp` is what a
framework frontend (torch-mlir / MPACT in the paper; our model zoo here)
hands to the compiler pipeline in :mod:`repro.core.pipeline`.

Every op kind carries a pure-numpy reference semantics
(:func:`reference`) that all IR interpreters and backends are tested
against.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np

OpKind = Literal["sls", "kg", "gather", "spmm", "fusedmm"]

# Semiring (⊕, ⊗) pairs used by KG models (paper §4): ⊕ reduces embedding
# vectors, ⊗ combines a vector element with the edge/relation value.
ADD_OPS = {"add", "max", "min"}
MUL_OPS = {"mul", "add"}

ADD_IDENTITY = {"add": 0.0, "max": -np.inf, "min": np.inf}


@dataclasses.dataclass(frozen=True)
class Semiring:
    add: str = "add"
    mul: str = "mul"

    def __post_init__(self):
        assert self.add in ADD_OPS, self.add
        assert self.mul in MUL_OPS, self.mul

    @property
    def identity(self) -> float:
        return ADD_IDENTITY[self.add]

    def np_add(self, a, b):
        return {"add": np.add, "max": np.maximum, "min": np.minimum}[self.add](a, b)

    def np_mul(self, a, b):
        return {"mul": np.multiply, "add": np.add}[self.mul](a, b)


@dataclasses.dataclass(frozen=True)
class EmbeddingOp:
    """A characterized embedding operation (paper Table 1).

    kind == 'sls':     out[b, e] ⊕= vals[p] ⊗ table[idxs[p], e]
                       for p in ptrs[b] .. ptrs[b+1]          (CSR segments)
    kind == 'kg':      out[b, e] ⊕= vals[b] ⊗ table[idxs[b], e]
                       (one nonzero per row: no ptrs)
    kind == 'gather':  out[g, r, e] = table[idxs[g] * block_rows + r, e]
                       (block-sparse attention gather: replication, no compute)
    kind == 'spmm':    identical loop nest to 'sls' (A in CSR, B dense row-major)
    kind == 'fusedmm': SDDMM fused with SpMM (message passing):
                       s = f(Σ_e x[i,e] * x[idxs[p],e]);  out[i,e] += s * x[idxs[p],e]
    """

    kind: OpKind
    num_segments: int          # batch rows (b) / output rows (i) / query slots (g)
    num_embeddings: int        # embedding-table rows (before blocking for 'gather')
    emb_len: int               # elements per embedding vector
    avg_lookups: int = 8       # average nnz per segment (CSR kinds)
    block_rows: int = 1        # rows per block ('gather' only)
    weighted: bool = False     # per-lookup scaling values (GNN edge weights)
    semiring: Semiring = Semiring()
    dtype: str = "float32"
    # CSR variants: "offsets" (ptrs array) or "lengths" (per-segment counts;
    # lowered with an access-unit accumulation stream, paper §7.4)
    index_format: str = "offsets"
    # >1 marks a *fused* multi-table op (produced by the program-level fusion
    # pass): the table memref is the row-stacked concatenation of the member
    # tables and an extra read-only per-segment base array ``roff`` carries
    # the table-offset stream (row units; block units for 'gather').
    num_tables: int = 1

    # ---- structural properties used by characterization + cost model ----
    @property
    def has_compute(self) -> bool:
        return self.kind != "gather"

    @property
    def compute_per_lookup(self) -> float:
        """FLOPs of execute-unit work per looked-up element (Table 1 col 3)."""
        if self.kind == "gather":
            return 0.0
        if self.kind == "fusedmm":
            return 4.0  # sddmm mul+add then spmm mul+add
        if self.weighted:
            return 2.0
        return 1.0

    @property
    def uses_csr(self) -> bool:
        return self.kind in ("sls", "spmm", "fusedmm")

    def footprint_bytes(self) -> int:
        itemsize = np.dtype(self.dtype).itemsize
        rows = self.num_embeddings * (self.block_rows if self.kind == "gather" else 1)
        return rows * self.emb_len * itemsize


# ---------------------------------------------------------------------------
# Random instance generation (inputs for interpreters/tests/benchmarks)
# ---------------------------------------------------------------------------

def make_inputs(op: EmbeddingOp, seed: int = 0, alpha: Optional[float] = None) -> dict:
    """Generate a concrete input set for ``op``.

    ``alpha`` controls temporal locality: indices are drawn from a Zipf-like
    power-law over table rows (alpha=None → uniform).  This mirrors the
    paper's L0/L1/L2 locality sweeps (§8.1) and the Criteo CDFs (Table 1).
    """
    rng = np.random.default_rng(seed)
    dt = np.dtype(op.dtype)

    def draw(n):
        if not n:
            return np.zeros((0,), np.int32)
        if alpha is None:
            return rng.integers(0, op.num_embeddings, size=n).astype(np.int32)
        # power-law rank distribution over a random permutation of rows
        ranks = np.arange(1, op.num_embeddings + 1, dtype=np.float64)
        p = ranks ** (-alpha)
        p /= p.sum()
        perm = rng.permutation(op.num_embeddings)
        return perm[rng.choice(op.num_embeddings, size=n, p=p)].astype(np.int32)

    inputs: dict = {}
    if op.kind == "gather":
        table = rng.standard_normal(
            (op.num_embeddings * op.block_rows, op.emb_len)).astype(dt)
        inputs["table"] = table
        inputs["idxs"] = draw(op.num_segments)
        return inputs

    table_name = "x" if op.kind == "fusedmm" else "table"
    n_rows = op.num_segments if op.kind == "fusedmm" else op.num_embeddings
    if op.kind == "fusedmm":
        # x is both the dense operand and the output's source: square-ish graph
        n_rows = max(op.num_embeddings, op.num_segments)
    inputs[table_name] = rng.standard_normal((n_rows, op.emb_len)).astype(dt)

    if op.uses_csr:
        lens = rng.poisson(op.avg_lookups, size=op.num_segments).clip(0, None)
        ptrs = np.zeros(op.num_segments + 1, np.int32)
        np.cumsum(lens, out=ptrs[1:])
        nnz = int(ptrs[-1])
        if op.index_format == "lengths":
            inputs["lens"] = lens.astype(np.int32)
        else:
            inputs["ptrs"] = ptrs
        inputs["idxs"] = np.minimum(draw(nnz), n_rows - 1)
        if op.weighted or op.kind == "spmm":
            inputs["vals"] = rng.standard_normal((nnz,)).astype(dt)
    else:  # kg
        inputs["idxs"] = draw(op.num_segments)
        inputs["vals"] = rng.standard_normal((op.num_segments,)).astype(dt)
    return inputs


def out_shape(op: EmbeddingOp) -> tuple:
    if op.kind == "gather":
        return (op.num_segments, op.block_rows, op.emb_len)
    return (op.num_segments, op.emb_len)


# ---------------------------------------------------------------------------
# Pure numpy reference semantics (the ground-truth oracle)
# ---------------------------------------------------------------------------

def reference(op: EmbeddingOp, inputs: dict) -> np.ndarray:
    sr = op.semiring
    dt = np.dtype(op.dtype)

    if op.kind == "gather":
        idxs = inputs["idxs"]
        if "roff" in inputs:          # fused multi-table: per-segment base
            idxs = idxs + inputs["roff"]
        table = inputs["table"]
        rows = (idxs[:, None] * op.block_rows + np.arange(op.block_rows)[None, :])
        return table[rows]  # (g, r, e)

    if op.kind == "kg":
        table, idxs, vals = inputs["table"], inputs["idxs"], inputs["vals"]
        out = np.full((op.num_segments, op.emb_len), sr.identity, dt)
        contrib = sr.np_mul(table[idxs], vals[:, None])
        return sr.np_add(out, contrib).astype(dt)

    if op.index_format == "lengths" and "ptrs" not in inputs:
        ptrs = np.zeros(op.num_segments + 1, np.int64)
        np.cumsum(inputs["lens"], out=ptrs[1:])
    else:
        ptrs = inputs["ptrs"]
    idxs = inputs["idxs"]
    if op.kind == "fusedmm":
        x = inputs["x"]
        out = np.zeros((op.num_segments, op.emb_len), dt)
        for i in range(op.num_segments):
            for p in range(ptrs[i], ptrs[i + 1]):
                j = idxs[p]
                s = np.dot(x[i], x[j])          # SDDMM (execute-unit workspace)
                out[i] += s * x[j]              # SpMM accumulate
        return out

    table = inputs["table"]
    vals = inputs.get("vals")
    roff = inputs.get("roff")
    out = np.full((op.num_segments, op.emb_len), sr.identity, dt)
    for b in range(op.num_segments):
        base = int(roff[b]) if roff is not None else 0
        for p in range(ptrs[b], ptrs[b + 1]):
            v = table[idxs[p] + base]
            if vals is not None:
                v = sr.np_mul(v, vals[p])
            out[b] = sr.np_add(out[b], v)
    # empty segments produce the additive identity; SLS convention is 0
    if sr.add != "add":
        seg_lens = np.diff(ptrs)
        out[seg_lens == 0] = 0.0
    return out.astype(dt)


# ---------------------------------------------------------------------------
# Program-level frontend: an ordered set of named embedding operations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EmbeddingProgram:
    """All irregular lookups of one model step, compiled as a unit.

    A model step is never a single :class:`EmbeddingOp` — a DLRM step does
    one SLS per embedding table, an LM step does token embedding + the label
    gather of the vocab-parallel cross entropy + (for MoE) expert dispatch.
    Compiling them together lets the pass manager fuse compatible lookups
    into one DAE schedule (one access stream over stacked tables) and lets
    the runtime reuse the compiled artifact across steps via the compile
    cache (keyed on :meth:`signature`).

    ``ops``            ordered tuple of ``(name, EmbeddingOp)``;
    ``shared_tables``  tuples of op names whose table memref is the *same*
                       array (e.g. token embedding and the unembedding label
                       gather both read the embed table) — the fusion pass
                       stacks a shared table once.
    """

    name: str
    ops: tuple                       # of (name, EmbeddingOp)
    shared_tables: tuple = ()        # of tuple[str, ...]

    def __post_init__(self):
        names = [n for n, _ in self.ops]
        assert len(names) == len(set(names)), f"duplicate op names: {names}"
        known = set(names)
        for group in self.shared_tables:
            for n in group:
                assert n in known, f"shared_tables references unknown op {n!r}"

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def names(self) -> tuple:
        return tuple(n for n, _ in self.ops)

    def op(self, name: str) -> EmbeddingOp:
        return dict(self.ops)[name]

    def signature(self) -> tuple:
        """Hashable structural identity — the compile-cache key component.

        Deliberately excludes ``name``: two programs with identical op
        structure compile to identical artifacts and must share a cache
        entry (e.g. every decode step of every server replica).
        """
        return (tuple(self.ops),
                tuple(tuple(g) for g in self.shared_tables))

    def table_slot(self, name: str):
        """Canonical table identity for ``name`` (shared group or self)."""
        for group in self.shared_tables:
            if name in group:
                return ("shared",) + tuple(group)
        return ("own", name)


def single_op_program(op: EmbeddingOp, name: str = "op") -> EmbeddingProgram:
    return EmbeddingProgram(name, ((name, op),))


def make_program_inputs(prog: EmbeddingProgram, seed: int = 0,
                        alpha: Optional[float] = None) -> dict:
    """Per-op concrete inputs; ops in a shared-table group get the *same*
    table array (shape-checked), mirroring a real model's aliased tables."""
    inputs: dict = {}
    shared_cache: dict = {}
    for i, (name, op) in enumerate(prog.ops):
        ins = make_inputs(op, seed=seed + i, alpha=alpha)
        slot = prog.table_slot(name)
        tbl_key = "x" if op.kind == "fusedmm" else "table"
        if slot[0] == "shared":
            if slot in shared_cache:
                prev = shared_cache[slot]
                assert prev.shape == ins[tbl_key].shape, \
                    f"shared tables of {slot} disagree in shape"
                ins[tbl_key] = prev
            else:
                shared_cache[slot] = ins[tbl_key]
        inputs[name] = ins
    return inputs


def program_reference(prog: EmbeddingProgram, inputs: dict) -> dict:
    """Composed numpy oracle: per-op reference outputs, keyed by op name."""
    return {name: reference(op, inputs[name]) for name, op in prog.ops}
