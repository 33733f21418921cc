"""Carry the reference's state across to the port.

The reference hands program inputs around as ``{op name: {stream: array}}``
dicts whose tables are numpy (or JAX) arrays.  The port's input contract is
the same dict with tables as tensors on the executor's device and the
per-step index streams left as numpy arrays.

An LM's parameters are a pytree in the reference (per-layer leaves stacked
over the scanned super-blocks under ``scan``, the remainder layers under
``rest``) and a flat ``state_dict`` of :class:`repro_torch.models.lm.LM`
here: :func:`lm_params_from_reference` maps one onto the other, nested
names included (MLA's ``attn.{wq,w_dkv,w_uk,w_uv,w_kr,wo}``, the MoE
layers' ``moe.{router,wi_gate,wi_up,wo,shared.{wi_gate,wi_up,wo}}``, each
leaf in its own dtype: the router stays fp32, and so do a mamba layer's
``A_log``, ``D`` and ``dt_bias``, an mlstm layer's ``w_if``, ``b_i`` and
``b_f`` and an slstm layer's ``b``; whisper's encoder, stacked over its
layers under ``enc_scan`` there, is ``enc_blocks.<layer>.*`` here, beside
``enc_norm``; zamba2's shared attention set ``shared.{attn,mlp}.*`` is one
subtree in both).  Its decode caches are the
same kind of tree there and a list of per-layer dicts here:
:func:`caches_from_reference` and :func:`caches_to_reference` map both ways
(MLA's latent ``{c, kr, len}``, a mamba layer's ``{state, conv}``, an
mlstm layer's ``{C, n}`` and an slstm layer's ``{h, c, n, m}``, fp32 ``c``,
``n``, ``m``, keep the reference's layout and dtypes; an ``xdec`` layer's
``{"self": {k, v, len},
"enc_out": None}`` there is its self-attention cache ``{k, v, len}``
here).

Back the other way, :func:`lm_params_to_reference` stacks the layers into
``scan`` / ``rest`` again, and :func:`train_state_to_reference` /
:func:`train_state_from_reference` carry the trainer's whole state
(parameters, AdamW's step and moments, the error-feedback residuals) both
ways, so a checkpoint of either package restores in the other.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .checkpoint.ckpt import ShardedLeaf
from .core.executor import resolve_device
from .launch.sharding import cache_blocks

TABLE_KEYS = ("table", "x")


def program_inputs_to_torch(inputs: dict, device=None) -> dict:
    """Move every table (``table`` / ``x``) of a reference program-inputs
    dict to ``device`` (the CUDA card unless ``device="cpu"``) once; leave
    the index streams as numpy.

    Aliasing is kept: a table object shared by several ops (a program's
    ``shared_tables`` slot) becomes ONE tensor, so the executor stacks it
    once and its identity check sees one source."""
    dev = resolve_device(device)
    moved: dict = {}          # id(source) -> (source, tensor)
    out: dict = {}
    for name, ins in inputs.items():
        new = {}
        for k, v in ins.items():
            if k in TABLE_KEYS:
                hit = moved.get(id(v))
                if hit is None:
                    hit = moved[id(v)] = (v, _to_tensor(v, dev))
                new[k] = hit[1]
            else:
                new[k] = np.asarray(v)
        out[name] = new
    return out


def _to_tensor(table, dev: torch.device) -> torch.Tensor:
    if isinstance(table, torch.Tensor):
        return table.to(dev).contiguous()
    arr = np.ascontiguousarray(np.asarray(table))
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.tensor(arr, device=dev)


def lm_params_from_reference(params: dict, cfg, device=None,
                             mesh=None) -> dict:
    """The reference's LM parameter pytree (numpy arrays, or anything
    ``np.asarray`` takes) as a ``state_dict`` for
    :class:`repro_torch.models.lm.LM` on ``device`` (the CUDA card unless
    ``device="cpu"``), in the reference's dtype.

    Layer ``n * len(pattern) + i`` is slot ``i`` of super-block ``n`` in
    ``params["scan"]`` (leaves stacked over ``cfg.n_super``); the
    remainder layers follow from ``params["rest"]`` (gemma3-4b: five
    super-blocks of five ``dense_local`` layers and a ``dense`` one, then
    four ``dense_local``); a front end's ``frontend_proj`` is carried as
    it is; an encoder's layer ``n`` is slot ``n`` of ``params["enc_scan"]``
    (``enc_blocks.<n>``); the shared attention set ``params["shared"]``
    is ``shared.*``.

    With a ``mesh`` (a ``DeviceMesh`` whose model axis is wider than 1)
    each leaf is this rank's slice by
    :func:`repro_torch.launch.sharding.local_leaf` (the head plan for the
    attention heads): the ``state_dict`` of ``LM(cfg,
    shard=ShardCtx(mesh))`` on this rank."""
    dev = resolve_device(device)
    if mesh is not None:
        from .launch.sharding import axis_sizes, local_leaf
        n, rank = axis_sizes(mesh)["model"], mesh.get_local_rank("model")
        full = lm_params_from_reference(params, cfg, "cpu")
        return {k: local_leaf(v, k, cfg, n, rank).to(dev).contiguous()
                for k, v in full.items()}
    state = {"embed": _to_tensor(params["embed"], dev),
             "final_norm": _to_tensor(params["final_norm"], dev)}
    if "frontend_proj" in params:      # a front end (cfg.modality != "text")
        state["frontend_proj"] = _to_tensor(params["frontend_proj"], dev)
    if "shared" in params:             # shared_attn layers (zamba2)
        for key, val in _flatten(params["shared"]):
            state[f"shared.{key}"] = _to_tensor(val, dev)
    for li, layer in enumerate(_layers_of(params, cfg)):
        for key, val in _flatten(layer):
            state[f"blocks.{li}.{key}"] = _to_tensor(val, dev)
    if "enc_scan" in params:           # an encoder (cfg.enc_layers)
        for li in range(cfg.enc_layers):
            for key, val in _flatten(_tree_index(params["enc_scan"], li)):
                state[f"enc_blocks.{li}.{key}"] = _to_tensor(val, dev)
        state["enc_norm"] = _to_tensor(params["enc_norm"], dev)
    return state


def lm_params_gathered(states: list, cfg) -> dict:
    """The full ``state_dict`` of ``cfg``'s LM from the model-axis ranks'
    ones (in rank order): each leaf's blocks put back where
    :func:`repro_torch.launch.sharding.leaf_blocks` places them, a KV
    copy taken once (:func:`~repro_torch.launch.sharding.join_leaf`), a
    replicated leaf taken from the first rank.  The inverse of
    :func:`lm_params_from_reference`'s ``mesh=``."""
    from .launch.sharding import join_leaf
    blocks = _model_blocks(cfg, len(states))
    return {k: join_leaf([st[k] for st in states], blocks.get(k))
            for k in states[0]}


def _tree_index(tree, n: int):
    if tree is None:                   # an empty subtree, as in JAX
        return None
    if isinstance(tree, dict):
        return {k: _tree_index(v, n) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[n]
    return np.asarray(tree)[n]


def _flatten(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_params_to_reference(state, cfg) -> dict:
    """The inverse of :func:`lm_params_from_reference`: a ``state_dict``
    (or any name -> tensor mapping with its keys, such as AdamW's moments)
    as the reference's parameter tree -- ``embed``, ``final_norm``,
    ``frontend_proj`` where present, ``scan`` (a tuple over the block
    pattern of layer dicts stacked over ``cfg.n_super`` with
    ``torch.stack``), ``rest`` (the remainder layers), an encoder's
    ``enc_scan`` (its layers stacked) and ``enc_norm``, and the shared
    attention set's ``shared`` subtree -- its leaves tensors where the
    state's lie."""
    layers: list = [{} for _ in range(cfg.num_layers)]
    enc_layers: list = [{} for _ in range(cfg.enc_layers)]
    tree = {}
    for name, t in state.items():
        stack, _, rest = name.partition(".")
        if stack not in ("blocks", "enc_blocks"):
            *parents, leaf = name.split(".")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t
            continue
        li, rest = rest.split(".", 1)
        node = (layers if stack == "blocks" else enc_layers)[int(li)]
        *parents, leaf = rest.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    if cfg.enc_layers:
        tree["enc_scan"] = _stack(enc_layers)
    pattern = len(cfg.block_pattern)
    n_scan = cfg.n_super * pattern
    tree["scan"] = tuple(
        _stack([layers[n * pattern + i] for n in range(cfg.n_super)])
        for i in range(pattern)) if cfg.n_super else ()
    tree["rest"] = tuple(layers[n_scan:])
    return tree


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    if isinstance(layers[0], ShardedLeaf):
        return ShardedLeaf.stack(layers)
    return torch.stack(layers)


@functools.lru_cache(maxsize=8)
def _model_blocks(cfg, n: int) -> dict:
    """``{name: LeafBlocks}`` of every parameter of ``cfg``'s LM that a
    model axis of ``n`` ranks splits (:func:`~repro_torch.launch.sharding
    .leaf_blocks`; a leaf it keeps whole is absent)."""
    from .launch.sharding import leaf_blocks
    from .models.lm import LM
    full = LM(cfg, device="meta").state_dict()
    out = {k: leaf_blocks(k, tuple(t.shape), cfg, n) for k, t in full.items()}
    return {k: b for k, b in out.items() if b is not None}


def train_state_to_reference(state: dict, cfg, shards=None) -> dict:
    """The trainer's state -- ``{"params": name -> tensor, "opt":
    AdamWState(step, mu, nu) with name -> tensor moments, "ef": name ->
    tensor residuals, or None without gradient compression}`` -- as the
    reference's ``{"params", "opt", "ef"}`` tree.  Without compression the
    reference keeps a () fp32 zero in place of every parameter leaf, and so
    does this.

    ``shards`` -- ``(param specs, moment specs, {axis: size}, {axis:
    coordinate})``, the specs by parameter name -- makes this one rank's
    part of a sharded checkpoint: every leaf is a
    :class:`~repro_torch.checkpoint.ckpt.ShardedLeaf`, the rank's block
    placed in the global leaf (a stacked leaf whole on its layer dim), the
    step and the () residuals replicated.  A parameter and a moment that
    keeps its spec are placed over the ``model`` axis by
    :func:`repro_torch.launch.sharding.leaf_blocks` alone (the LM's own
    slices: the head plan's, a KV copy written once), whole on every rank
    where it gives no blocks, whatever the spec says; a moment whose spec
    differs (ZeRO-1's rows over the data axes) is placed by its spec."""
    from .optim.adamw import AdamWState
    opt = state["opt"]
    params, mu, nu, step = state["params"], opt.mu, opt.nu, opt.step
    if shards is not None:
        p_specs, m_specs, sizes, index = shards
        blocks = _model_blocks(cfg, sizes.get("model", 1))

        def placed(k, t):
            b = blocks.get(k)
            return ShardedLeaf(t, (), sizes, index,
                               None if b is None else ("model", b))

        def wrap(tree, specs):
            return {k: placed(k, t) if specs[k] == p_specs[k]
                    else ShardedLeaf(t, specs[k], sizes, index)
                    for k, t in tree.items()}
        ef_zero = (lambda p: ShardedLeaf(
            torch.zeros((), dtype=torch.float32), (), sizes, index))
        params_r = wrap(params, p_specs)
        mu, nu = wrap(mu, m_specs), wrap(nu, m_specs)
        step = ShardedLeaf(step, (), sizes, index)
        if state["ef"] is not None:
            raise NotImplementedError(
                "sharded checkpoints of compressed training (ROADMAP.md, "
                "Queue 1 item 6f)")
    else:
        params_r = params

        def ef_zero(p):
            return torch.zeros((), dtype=torch.float32, device=p.device)
    tree = lm_params_to_reference(params_r, cfg)
    if state["ef"] is None:
        from .checkpoint.ckpt import tree_map
        ef = tree_map(ef_zero, tree)
    else:
        ef = lm_params_to_reference(state["ef"], cfg)
    return {"params": tree,
            "opt": AdamWState(step, lm_params_to_reference(mu, cfg),
                              lm_params_to_reference(nu, cfg)),
            "ef": ef}


def train_state_from_reference(tree: dict, cfg, device=None) -> dict:
    """The inverse of :func:`train_state_to_reference`, on ``device`` (the
    CUDA card unless ``device="cpu"``): ``ef`` is None where the reference
    keeps () zeros (no compression).  A tree restored with ``shardings=``
    (each leaf a rank's block, a stacked leaf whole on its layer dim)
    gives that rank's slices."""
    from .checkpoint.ckpt import tree_flatten_with_path
    from .optim.adamw import AdamWState
    dev = resolve_device(device)
    opt = tree["opt"]
    ef_leaves = [x for _, x in tree_flatten_with_path(tree["ef"])]
    compressed = any(len(x.shape) for x in ef_leaves)
    return {"params": lm_params_from_reference(tree["params"], cfg, dev),
            "opt": AdamWState(
                _to_tensor(opt.step, dev).to(torch.int32).reshape(()),
                lm_params_from_reference(opt.mu, cfg, dev),
                lm_params_from_reference(opt.nu, cfg, dev)),
            "ef": (lm_params_from_reference(tree["ef"], cfg, dev)
                   if compressed else None)}


def embed_tables_from_params(params: dict) -> dict:
    """The param-backed tables of the LM embedding program (counterpart of
    ``LM.embedding_table_inputs``), keyed the way
    :meth:`~repro_torch.core.executor.ProgramExecutor.update_tables` wants
    them.  Deliberately partial: the MoE capacity buffer is step data."""
    return {"tok_embed": {"table": params["embed"]},
            "label_gather": {"table": params["embed"]}}


#: cache leaves stored head-major here, (B, Smax, Hkv, ...) in the reference
#: (the KV caches' only: MLA's ``c``, the slstm's ``c`` and ``n`` and the
#: mlstm's ``n`` are not among them and keep their layout)
_SEQ_MAJOR_LEAVES = ("k", "v", "k_scale", "v_scale")


def _layers_of(tree: dict, cfg) -> list:
    """The reference's ``{"scan": stacked over n_super, "rest": (...)}``
    tree as one entry per layer, in layer order."""
    layers = []
    pattern = tuple(cfg.block_pattern)
    for n in range(cfg.n_super):
        for i in range(len(pattern)):
            layers.append(_tree_index(tree["scan"][i], n))
    layers.extend(tree.get("rest", ()))
    return layers


def caches_from_reference(tree: dict, cfg, device=None, mesh=None) -> list:
    """The reference's decode caches (``LM.init_caches`` /
    ``decode_step`` output, leaves as numpy arrays or anything
    ``np.asarray`` takes) as the port's list of per-layer cache dicts on
    ``device``: ``k``/``v`` (B, Smax, Hkv, hd) -> (B, Hkv, Smax, hd),
    ``k_scale``/``v_scale`` (B, Smax, Hkv) -> (B, Hkv, Smax); ``len`` and
    an MLA layer's ``c`` (B, Smax, r) and ``kr`` (B, Smax, rd) as they
    are, and so are a mamba layer's ``state`` (B, H, P, N) and ``conv`` (B,
    3, d_inner), an mlstm layer's ``C`` (B, H, hd, hd) and ``n`` (B, H, 1,
    hd), and an slstm layer's ``h``, ``c``, ``n``, ``m`` (B, d), each in its
    own dtype (no recurrent leaf is sequence-major); an ``xdec`` layer's
    ``self`` cache becomes the layer's (its
    ``enc_out`` is None there: the encoder's output is a decode context,
    not cache state).

    With a ``mesh`` (a ``DeviceMesh`` whose model axis is wider than 1)
    each leaf is this rank's slice by :func:`repro_torch.launch.sharding
    .cache_blocks` -- the caches ``LM(cfg, shard=ShardCtx(mesh))
    .init_caches`` gives this rank, filled."""
    from .models.lm import layer_kinds
    dev = resolve_device(device)
    blocks = _cache_blocks_of(cfg, mesh)
    out = []
    for kind, layer in zip(layer_kinds(cfg), _layers_of(tree, cfg)):
        layer = layer.get("self", layer)
        cache = {}
        for key, val in layer.items():
            t = _to_tensor(np.asarray(val), torch.device("cpu"))
            if key in _SEQ_MAJOR_LEAVES:
                t = t.transpose(1, 2)
            if blocks is not None:
                blk = cache_blocks(kind, key, cfg, blocks[0])
                t = t if blk is None else blk.take(t, blocks[1])
            cache[key] = t.to(dev).contiguous()
        out.append(cache)
    return out


def _cache_blocks_of(cfg, mesh):
    """(model-axis size, rank) of ``mesh`` where it splits a model, else
    None."""
    if mesh is None:
        return None
    from .launch.sharding import axis_sizes
    n = axis_sizes(mesh).get("model", 1)
    return None if n == 1 else (n, mesh.get_local_rank("model"))


def caches_to_reference(caches: list, cfg) -> dict:
    """The port's per-layer caches as the reference's tree of numpy arrays
    (``{"scan": tuple over the pattern of dicts stacked over n_super,
    "rest": tuple}``; an ``xdec`` layer's as ``{"self": ..., "enc_out":
    None}``), to compare leaf by leaf.  ``caches`` may be the model-axis
    ranks' caches instead (a list of them, rank order): each leaf is then
    joined by :func:`repro_torch.launch.sharding.cache_blocks` first, a
    copy taken once."""
    from .models.lm import layer_kinds
    if caches and isinstance(caches[0], list):
        caches = _caches_gathered(caches, cfg)

    def host(key, t):
        if key in _SEQ_MAJOR_LEAVES:
            t = t.transpose(1, 2)
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy()

    layers = [{k: host(k, t) for k, t in c.items()} for c in caches]
    layers = [{"self": lay, "enc_out": None} if kind == "xdec" else lay
              for kind, lay in zip(layer_kinds(cfg), layers)]
    pattern = tuple(cfg.block_pattern)
    n_scan = cfg.n_super * len(pattern)
    scan = ()
    if cfg.n_super:
        scan = tuple(_stack_host([layers[n * len(pattern) + i]
                                  for n in range(cfg.n_super)])
                     for i in range(len(pattern)))
    return {"scan": scan, "rest": tuple(layers[n_scan:])}


def _caches_gathered(ranks: list, cfg) -> list:
    """The full caches of ``cfg``'s LM from the model-axis ranks' ones (a
    list of per-layer cache lists, rank order), each leaf joined by
    :func:`repro_torch.launch.sharding.cache_blocks`."""
    from .launch.sharding import join_leaf
    from .models.lm import layer_kinds
    n = len(ranks)
    return [{key: join_leaf([r[li][key] for r in ranks],
                            cache_blocks(kind, key, cfg, n))
             for key in ranks[0][li]}
            for li, kind in enumerate(layer_kinds(cfg))]


def _stack_host(layers: list):
    """Stack per-layer trees of numpy leaves (None: an empty subtree)."""
    if layers[0] is None:
        return None
    if isinstance(layers[0], dict):
        return {k: _stack_host([lay[k] for lay in layers]) for k in layers[0]}
    return np.stack(layers)
