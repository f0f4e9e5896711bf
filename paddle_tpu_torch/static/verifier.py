"""Program structural verifier (paddle_tpu/static/verifier.py), a copy of
the JAX package's pure-Python checks over the port's Program.

Analog of the reference's graph sanity layer (reference framework/ir/
graph.cc IsTopologySortOperationsUnique + node sanity checks inside
Pass::Apply, and framework/program_desc.cc block validation): every
Program rewrite (transpiler, DCE, CSE, constant folding) must leave the
op list well-formed, and a buggy pass should fail LOUDLY at rewrite time
with the op/var it corrupted — not as a wrong number three subsystems
later.

Checks (each raises `ProgramVerifyError` naming the op, the var, and —
when run under the pass-safety harness in passes.py — the pass that
broke it):

  use-before-def    every `_Ref` input of every op resolves to a data
                    var, a persistable seed id, or the output of an
                    EARLIER op (SSA order).
  dangling-ref      no `_Ref` points at a var id nothing in the program
                    defines at all (classic symptom of a pass dropping a
                    producer op but not its consumers).
  single-assignment no two ops produce the same output var id, and op
                    outputs never shadow data/persistable ids.
  out-ids-sync      `op.out_ids` mirrors `op.out_vars` (rewrites that
                    copy OpNodes must keep both in sync — the executor
                    keys its env on out_ids but serde walks out_vars).
  root-liveness     persistable seeds, state-write targets, backward
                    loss/grad vars and jit fetches all remain defined —
                    i.e. DCE may never eliminate a scope-backed or
                    fetched value.
  sub-blocks        control-flow ops (`cond`/`while_loop`) carry
                    well-formed SubBlocks: inner refs resolve against
                    placeholders/free ids/earlier inner ops, outputs are
                    defined, and the free-id list matches the op's
                    promoted inputs.
"""
from __future__ import annotations

from typing import Optional, Set

from .program import Program, _Ref

__all__ = ["ProgramVerifyError", "verify_program"]


class ProgramVerifyError(RuntimeError):
    """A structural invariant of a Program does not hold.

    Attributes pinpoint the failure: `rule` (which invariant), `op_name`
    and `op_index` (the offending op, when any), `var` (the offending
    variable name or id), `pass_name` (the pass that produced the broken
    program, when verification runs under the pass harness).
    """

    def __init__(self, message, *, rule, op_name=None, op_index=None,
                 var=None, pass_name=None):
        self.raw_message = message
        self.rule = rule
        self.op_name = op_name
        self.op_index = op_index
        self.var = var
        self.pass_name = pass_name
        where = ""
        if op_name is not None:
            where = f" [op #{op_index} '{op_name}']" \
                if op_index is not None else f" [op '{op_name}']"
        blame = f" (after pass '{pass_name}')" if pass_name else ""
        super().__init__(f"{rule}{where}: {message}{blame}")

    def with_pass(self, pass_name):
        return ProgramVerifyError(
            self.raw_message, rule=self.rule, op_name=self.op_name,
            op_index=self.op_index, var=self.var, pass_name=pass_name)


def _ref_name(ref):
    return getattr(ref, "name", None) or f"v{ref.var_id}"


def _seed_ids(program: Program) -> Set[int]:
    # environment inputs the executor seeds: fed data + persistable SEED
    # ids (persist_ids). A rebinded persistable's CURRENT var_id is an op
    # output (program.py Variable._rebind), so it is deliberately absent —
    # it must be defined by the op that produced it.
    ids = {v.var_id for v in program.data_vars.values()}
    ids |= set(program.persist_ids.values())
    return ids


def verify_program(program: Program, pass_name: Optional[str] = None):
    """Check every structural invariant; returns the program on success.

    `pass_name` tags raised diagnostics with the rewrite that produced
    this program (the pass-safety harness in passes.py supplies it).
    """
    try:
        _verify(program)
    except ProgramVerifyError as e:
        if pass_name and e.pass_name is None:
            raise e.with_pass(pass_name) from None
        raise
    return program


def _verify(program: Program):
    seeds = _seed_ids(program)
    defined = set(seeds)
    all_defined = set(defined)
    for op in program.ops:
        for oid in op.out_ids:
            all_defined.add(oid)

    produced = {}
    for i, op in enumerate(program.ops):
        # out_ids must mirror out_vars
        if len(op.out_ids) != len(op.out_vars) or any(
                oid != v.var_id for oid, v in zip(op.out_ids, op.out_vars)):
            raise ProgramVerifyError(
                f"out_ids {list(op.out_ids)} do not mirror out_vars "
                f"{[v.var_id for v in op.out_vars]}",
                rule="out-ids-sync", op_name=op.name, op_index=i)
        for x in op.flat:
            if not isinstance(x, _Ref):
                continue
            if x.var_id in defined:
                continue
            if x.var_id in all_defined:
                prod_i, prod_name = next(
                    (j, o.name) for j, o in enumerate(program.ops)
                    if x.var_id in o.out_ids)
                raise ProgramVerifyError(
                    f"input '{_ref_name(x)}' (id {x.var_id}) is used "
                    f"before its producer op #{prod_i} '{prod_name}' runs",
                    rule="use-before-def", op_name=op.name, op_index=i,
                    var=_ref_name(x))
            raise ProgramVerifyError(
                f"input '{_ref_name(x)}' (id {x.var_id}) is defined "
                "nowhere in the program — its producer was likely removed "
                "by a rewrite that kept this consumer",
                rule="dangling-ref", op_name=op.name, op_index=i,
                var=_ref_name(x))
        for oid, v in zip(op.out_ids, op.out_vars):
            if oid in produced:
                j, jname = produced[oid]
                raise ProgramVerifyError(
                    f"output '{v.name}' (id {oid}) is already produced by "
                    f"op #{j} '{jname}' — SSA requires single assignment",
                    rule="single-assignment", op_name=op.name, op_index=i,
                    var=v.name)
            if oid in seeds:
                raise ProgramVerifyError(
                    f"output '{v.name}' (id {oid}) shadows a "
                    "data/persistable variable",
                    rule="single-assignment", op_name=op.name, op_index=i,
                    var=v.name)
            produced[oid] = (i, op.name)
            defined.add(oid)
        _verify_subblocks(op, i)

    _verify_roots(program, defined)


def _verify_roots(program: Program, defined: Set[int]):
    """Fetch/persist/backward roots must survive every rewrite."""
    def need(vid, what, var=None):
        if vid not in defined:
            raise ProgramVerifyError(
                f"{what} (id {vid}) is not defined by the program — a "
                "rewrite (dead-code elimination?) removed a live value",
                rule="root-liveness", var=var or f"v{vid}")

    for scope_name, vid in program.state_writes.items():
        need(vid, f"state write target '{scope_name}'", var=scope_name)
    if program.backward_section is not None:
        loss, pairs = program.backward_section
        need(loss.var_id, f"backward loss '{loss.name}'", var=loss.name)
        for p, g in pairs:
            # grad vars are synthesized by the executor, but their params
            # must still be environment inputs
            if p.scope_name not in program.persist_ids \
                    and p.scope_name not in program.persistable_vars:
                raise ProgramVerifyError(
                    f"backward param '{p.name}' is no longer a persistable "
                    "of the program", rule="root-liveness", var=p.name)
    for v in getattr(program, "_jit_fetch_vars", []) or []:
        need(v.var_id, f"fetch '{v.name}'", var=v.name)


def _verify_subblocks(op, op_index):
    """Validate control-flow SubBlocks owned by this op's kernel."""
    from .control_flow import _CondFn, _WhileFn

    fn = op.fn
    blocks = ()
    if isinstance(fn, _WhileFn):
        blocks = (("while_cond", fn.cond_block), ("while_body", fn.body_block))
        for label, blk in blocks:
            if len(blk.in_ids) != fn.n_loop:
                raise ProgramVerifyError(
                    f"{label} sub-block declares {len(blk.in_ids)} "
                    f"placeholders for {fn.n_loop} loop vars",
                    rule="sub-blocks", op_name=op.name, op_index=op_index)
    elif isinstance(fn, _CondFn):
        blocks = (("cond_true", fn.true_block), ("cond_false", fn.false_block))
    if not blocks:
        return

    # the op's recorded inputs are (loop_vars | pred) + promoted free
    # vars, in that order — each block's free_ids must match that arity
    carried = fn.n_loop if isinstance(fn, _WhileFn) else 1
    for label, blk in blocks:
        if len(blk.free_ids) != op.n_args - carried:
            raise ProgramVerifyError(
                f"{label} sub-block wants {len(blk.free_ids)} free vars "
                f"but the op records {op.n_args - carried} promoted "
                "inputs", rule="sub-blocks", op_name=op.name,
                op_index=op_index)
        _verify_block_body(label, blk, op, op_index)


def _verify_block_body(label, blk, op, op_index):
    defined = set(blk.in_ids) | set(blk.free_ids)
    all_defined = set(defined)
    for sub in blk.ops:
        all_defined.update(sub.out_ids)
    for j, sub in enumerate(blk.ops):
        for x in sub.flat:
            if isinstance(x, _Ref) and x.var_id not in defined:
                word = ("used before definition" if x.var_id in all_defined
                        else "defined nowhere in the sub-block")
                raise ProgramVerifyError(
                    f"{label} sub-block op #{j} '{sub.name}' input "
                    f"'{_ref_name(x)}' (id {x.var_id}) is {word}",
                    rule="sub-blocks", op_name=op.name, op_index=op_index,
                    var=_ref_name(x))
        defined.update(sub.out_ids)
        _verify_subblocks(sub, op_index)  # nested control flow
    for oid in blk.out_ids:
        if oid not in defined:
            raise ProgramVerifyError(
                f"{label} sub-block output id {oid} is not defined by the "
                "sub-block", rule="sub-blocks", op_name=op.name,
                op_index=op_index, var=f"v{oid}")
