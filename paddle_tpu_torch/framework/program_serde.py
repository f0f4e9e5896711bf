"""Versioned, schema-based Program serialization
(paddle_tpu/framework/program_serde.py): the JAX package's JSON + ``.npz``
schema, letter for letter, so an artifact crosses packages. Reference
analogs: framework/framework.proto (ProgramDesc + the op-version map at
framework.proto:186) and framework/save_load_util.cc (versioned tensor
headers). Design delta: instead of protobuf, the graph is a JSON document
(ops referenced BY REGISTRY NAME + version, attrs as JSON values, variable
metadata inline) plus one .npz holding every baked array constant — so a
saved model survives internal module renames (nothing resolves by
qualname), loads across framework versions with an explicit op-version
check, and stays hand-inspectable.

Layout for save_program(path):
  {path}.pdmodel      JSON document (format_version, op version map, ops,
                      vars, feeds/fetches)
  {path}.pdmodel.npz  array constants, keyed c0, c1, ...

Control-flow ops (cond/while) serialize structurally: their SubBlocks are
nested op lists in the same schema.

In the port: a torch dtype is written under its numpy name
(``{"__dtype__": "bfloat16"}`` included) and read back as the torch dtype;
array constants are torch tensors, saved as numpy (a bf16 constant as f32,
with ``"dtype": "bfloat16"`` beside its ``__npz__`` key, which the JAX
decoder ignores) and loaded onto the current device, where the program
will run. Two tags extend the schema for getitem's index: ``__slice__``
and ``__ellipsis__`` (the JAX package pickles such programs instead).
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["save_program", "load_program", "FORMAT_VERSION",
           "OpVersionError"]

FORMAT_VERSION = 1


class OpVersionError(RuntimeError):
    pass


def _op_version(name):
    from ..ops import OP_REGISTRY
    fn = OP_REGISTRY.get(name)
    return int(getattr(fn, "op_version", 1)) if fn is not None else None


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

class _Encoder:
    def __init__(self):
        self.consts = {}
        self._n = 0

    def const(self, arr):
        import torch
        key = f"c{self._n}"
        self._n += 1
        doc = {"__npz__": key}
        if isinstance(arr, torch.Tensor):
            t = torch.Tensor.detach(arr).cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
                doc["dtype"] = "bfloat16"
            arr = t.numpy()
        self.consts[key] = np.asarray(arr)
        return doc

    def value(self, v):
        """JSON-encode one attr/arg value."""
        import torch
        from ..core.dtype import convert_dtype
        from ..static.program import _Ref
        if isinstance(v, _Ref):
            return {"__ref__": v.var_id, "name": v.name}
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, (np.bool_, np.integer)):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, torch.dtype):
            return {"__dtype__": convert_dtype(v)}
        if isinstance(v, np.dtype):
            return {"__dtype__": str(v)}
        if isinstance(v, type) and issubclass(v, np.generic):
            return {"__dtype__": str(np.dtype(v))}
        if isinstance(v, (np.ndarray, torch.Tensor)):
            return self.const(v)
        if isinstance(v, slice):
            return {"__slice__": [self.value(v.start), self.value(v.stop),
                                  self.value(v.step)]}
        if v is Ellipsis:
            return {"__ellipsis__": True}
        if isinstance(v, tuple):
            return {"__tuple__": [self.value(x) for x in v]}
        if isinstance(v, list):
            return [self.value(x) for x in v]
        if isinstance(v, dict):
            return {"__dict__": [[self.value(k), self.value(x)]
                                 for k, x in v.items()]}
        raise TypeError(
            f"Program attr of type {type(v).__name__} is not serializable "
            "in the versioned format (op attrs must be JSON-able values, "
            "arrays, or Variable refs)")

    def var(self, v):
        from ..core.dtype import convert_dtype
        return {"id": v.var_id, "name": v.name,
                "shape": [int(s) for s in v.aval.shape],
                "dtype": convert_dtype(v.aval.dtype),
                "is_data": bool(getattr(v, "is_data", False)),
                "scope_name": getattr(v, "scope_name", None)}

    def op(self, op):
        import torch.utils._pytree as pytree
        from ..static.control_flow import _CondFn, _WhileFn
        kwargs = pytree.tree_unflatten(op.flat[op.n_args:], op.kw_tree)
        fn = op.fn
        if isinstance(fn, _CondFn):
            fn_doc = {"__cond__": {
                "true": self.subblock(fn.true_block),
                "false": self.subblock(fn.false_block)}}
        elif isinstance(fn, _WhileFn):
            fn_doc = {"__while__": {
                "cond": self.subblock(fn.cond_block),
                "body": self.subblock(fn.body_block),
                "n_loop": fn.n_loop, "max_trip": fn.max_trip}}
        elif hasattr(fn, "op_name"):
            name = fn.op_name
            ver = _op_version(name)
            fn_doc = {"__opreg__": name, "version": ver or 1}
        else:
            raise TypeError(
                f"op '{op.name}' has a kernel that is neither a registry "
                f"op nor a control-flow block ({type(fn).__name__}); it "
                "cannot be saved in the versioned format")
        return {"fn": fn_doc, "name": op.name,
                "args": [self.value(a) for a in op.flat[:op.n_args]],
                "kwargs": self.value(kwargs),
                "out_ids": list(op.out_ids),
                "out_vars": [self.var(v) for v in op.out_vars]}

    def subblock(self, blk):
        return {"ops": [self.op(o) for o in blk.ops],
                "in_ids": list(blk.in_ids),
                "free_ids": list(blk.free_ids),
                "out_ids": list(blk.out_ids)}


def save_program(program, path, feed_names=(), extra=None):
    enc = _Encoder()
    ops_doc = [enc.op(op) for op in program.ops]
    op_versions = {}
    for doc in _walk_op_docs(ops_doc):
        fnd = doc["fn"]
        if "__opreg__" in fnd:
            op_versions[fnd["__opreg__"]] = fnd["version"]
    doc = {
        "format_version": FORMAT_VERSION,
        "name": program.name,
        "op_versions": op_versions,
        "ops": ops_doc,
        "data_vars": [enc.var(v) for v in program.data_vars.values()],
        "persistable_vars": [enc.var(v)
                             for v in program.persistable_vars.values()],
        "persist_ids": dict(program.persist_ids),
        "state_writes": dict(program.state_writes),
        "feed_names": list(feed_names),
        "fetch_ids": [v.var_id for v in
                      getattr(program, "_jit_fetch_vars", [])],
        "extra": extra or {},
    }
    with open(path + ".pdmodel", "w") as f:
        json.dump(doc, f)
    np.savez(path + ".pdmodel.npz", **enc.consts)


def _walk_op_docs(ops_doc):
    for doc in ops_doc:
        yield doc
        fnd = doc["fn"]
        if "__cond__" in fnd:
            yield from _walk_op_docs(fnd["__cond__"]["true"]["ops"])
            yield from _walk_op_docs(fnd["__cond__"]["false"]["ops"])
        if "__while__" in fnd:
            yield from _walk_op_docs(fnd["__while__"]["cond"]["ops"])
            yield from _walk_op_docs(fnd["__while__"]["body"]["ops"])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class _Decoder:
    def __init__(self, consts, device):
        self.consts = consts
        self.device = device

    def value(self, v):
        from ..static.program import _Ref
        if isinstance(v, dict):
            if "__ref__" in v:
                r = _Ref.__new__(_Ref)
                r.var_id = v["__ref__"]
                r.name = v.get("name", f"_var_{v['__ref__']}")
                return r
            if "__npz__" in v:
                import torch
                arr = self.consts[v["__npz__"]]
                if arr.dtype.kind not in "biufc":   # ml_dtypes' bfloat16
                    t = torch.from_numpy(arr.astype(np.float32)).to(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(arr))
                if v.get("dtype") == "bfloat16":
                    t = t.to(torch.bfloat16)
                return t.to(self.device)
            if "__dtype__" in v:
                from ..core.dtype import to_torch_dtype
                return to_torch_dtype(v["__dtype__"])
            if "__slice__" in v:
                return slice(*[self.value(x) for x in v["__slice__"]])
            if "__ellipsis__" in v:
                return Ellipsis
            if "__tuple__" in v:
                return tuple(self.value(x) for x in v["__tuple__"])
            if "__dict__" in v:
                return {self.value(k): self.value(x)
                        for k, x in v["__dict__"]}
        if isinstance(v, list):
            return [self.value(x) for x in v]
        return v

    def var(self, doc, program=None):
        from ..static.program import Variable
        v = Variable(doc["shape"], doc["dtype"], program=program,
                     device=self.device)
        v.var_id = doc["id"]
        v.name = doc["name"]
        v.is_data = doc.get("is_data", False)
        v.scope_name = doc.get("scope_name")
        v.program = program
        return v

    def fn(self, fnd):
        from ..static.control_flow import SubBlock, _CondFn, _WhileFn
        if "__opreg__" in fnd:
            from ..ops import OP_REGISTRY
            name = fnd["__opreg__"]
            if name not in OP_REGISTRY:
                raise OpVersionError(
                    f"saved model uses op '{name}' which this build does "
                    "not register — the model needs a newer framework or "
                    "a compat shim")
            saved_v = int(fnd.get("version", 1))
            cur_v = _op_version(name) or 1
            if saved_v > cur_v:
                raise OpVersionError(
                    f"saved model op '{name}' is version {saved_v} but "
                    f"this build implements version {cur_v}; upgrade the "
                    "framework to load this model")
            return OP_REGISTRY[name].raw
        if "__cond__" in fnd:
            return _CondFn(self.subblock(fnd["__cond__"]["true"]),
                           self.subblock(fnd["__cond__"]["false"]))
        if "__while__" in fnd:
            d = fnd["__while__"]
            return _WhileFn(self.subblock(d["cond"]),
                            self.subblock(d["body"]),
                            d["n_loop"], d["max_trip"])
        raise OpVersionError(f"unknown op kind in saved model: {fnd}")

    def op(self, doc, program):
        import torch.utils._pytree as pytree
        from ..static.program import OpNode
        op = OpNode.__new__(OpNode)
        op.fn = self.fn(doc["fn"])
        op.name = doc["name"]
        args = [self.value(a) for a in doc["args"]]
        kwargs = self.value(doc["kwargs"]) or {}
        kw_leaves, kw_tree = pytree.tree_flatten(kwargs)
        op.flat = args + kw_leaves
        op.n_args = len(args)
        op.kw_tree = kw_tree
        op.out_vars = [self.var(v, program) for v in doc["out_vars"]]
        op.out_ids = list(doc["out_ids"])
        return op

    def subblock(self, doc):
        from ..static.control_flow import SubBlock
        blk = SubBlock([], doc["in_ids"], doc["free_ids"], doc["out_ids"])
        blk.ops = [self.op(o, None) for o in doc["ops"]]
        return blk


def load_program(path, device=None):
    """Load a versioned .pdmodel onto ``device`` (default: the current
    device); returns (program, feed_names)."""
    from ..device import resolve_device
    from ..static.program import Program
    with open(path + ".pdmodel") as f:
        doc = json.load(f)
    fmt = doc.get("format_version")
    if fmt is None or fmt > FORMAT_VERSION:
        raise OpVersionError(
            f"model format_version {fmt} is newer than this build's "
            f"{FORMAT_VERSION}")
    try:
        consts = dict(np.load(path + ".pdmodel.npz").items())
    except FileNotFoundError:
        raise OpVersionError(
            f"'{path}.pdmodel.npz' is missing — the .pdmodel JSON and its "
            ".npz constant sidecar form one artifact; copy both") from None
    device = resolve_device(device)
    dec = _Decoder(consts, device)
    program = Program(doc.get("name", "loaded"))
    program._device = device
    program.ops = [dec.op(o, program) for o in doc["ops"]]
    for vd in doc["data_vars"]:
        v = dec.var(vd, program)
        program.data_vars[v.name] = v
    for vd in doc["persistable_vars"]:
        v = dec.var(vd, program)
        program.persistable_vars[v.scope_name] = v
    program.persist_ids = {k: int(x)
                           for k, x in doc.get("persist_ids", {}).items()}
    program.state_writes = {k: int(x)
                            for k, x in doc.get("state_writes", {}).items()}
    by_id = {}
    for op in program.ops:
        for v in op.out_vars:
            by_id[v.var_id] = v
    for v in list(program.data_vars.values()) \
            + list(program.persistable_vars.values()):
        by_id[v.var_id] = v
    program._jit_fetch_vars = [by_id[i] for i in doc.get("fetch_ids", [])]
    # keep the process-wide Variable id counter ahead of every loaded id,
    # so ops appended to this program later cannot alias loaded SSA ids
    from ..static.program import Variable
    if by_id:
        with Variable._lock:
            Variable._counter[0] = max(Variable._counter[0],
                                       max(by_id) + 1)
    return program, list(doc.get("feed_names", []))
