"""Forward may-dataflow over the tpu-lint CFG.

One engine, three rules: the analysis walks a function's CFG to a fixpoint,
carrying a frozenset of facts (held resources, for R008) through each
block's statements and across labeled edges. Union at merges — a fact holds
at a point when it holds on ANY path there, which is exactly the shape of
"some path escapes without releasing".

The rule supplies two callbacks:

- ``transfer(state, item, block) -> state`` applied to each block item in
  order (simple statements and the Cond/LoopIter/Handler/WithEnter/WithExit
  markers from cfg.py);
- ``edge_transfer(state, src_block, label) -> state`` (optional) applied
  when following an edge — the hook branch-sensitive kills use (``if buf
  is None: return`` holds no buffer on the true edge).

Termination: states only grow per fact-universe and the universe is finite
(facts are generated from statements, a finite set), so the worklist
converges; a bail-out cap guards pathological functions anyway.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, FrozenSet, Optional

from spark_rapids_tpu_torch.analysis.cfg import CFG, Block

State = FrozenSet

#: safety valve: no real function needs this many worklist visits
_MAX_VISITS = 20000


def run_forward(cfg: CFG,
                transfer: Callable[[State, object, Block], State],
                edge_transfer: Optional[
                    Callable[[State, Block, Optional[str]], State]] = None,
                init: State = frozenset()) -> Dict[int, State]:
    """Fixpoint block-IN states. ``result[cfg.exit]`` is the union of every
    path's facts at function exit."""
    in_states: Dict[int, State] = {cfg.entry: init}
    work = deque([cfg.entry])
    visits = 0
    while work:
        visits += 1
        if visits > _MAX_VISITS:
            break
        bid = work.popleft()
        block = cfg.blocks[bid]
        state = in_states.get(bid, frozenset())
        for item in block.items:
            state = transfer(state, item, block)
        for (succ, label) in block.succs:
            out = state
            if edge_transfer is not None:
                out = edge_transfer(out, block, label)
            prev = in_states.get(succ)
            merged = out if prev is None else (prev | out)
            if prev is None or merged != prev:
                in_states[succ] = merged
                work.append(succ)
    return in_states


def block_out_state(cfg: CFG, bid: int, in_states: Dict[int, State],
                    transfer: Callable[[State, object, Block], State]
                    ) -> State:
    """Re-run one block's transfer to get its OUT state (the engine stores
    IN states only)."""
    block = cfg.blocks[bid]
    state = in_states.get(bid, frozenset())
    for item in block.items:
        state = transfer(state, item, block)
    return state
