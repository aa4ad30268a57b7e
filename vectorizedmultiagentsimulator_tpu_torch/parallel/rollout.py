"""Fixed-length rollouts: the port's counterpart of the JAX package's
``lax.scan`` rollout (``vectorizedmultiagentsimulator_tpu/parallel/
rollout.py``).

On CUDA tensors ``rollout`` captures ``chunk`` steps (policy and
``env.step``) once as a ``torch.cuda.CUDAGraph`` and replays it, so that
the host enqueues one graph where eager PyTorch enqueues every small
kernel of every step.  On CPU tensors it runs the same steps as a Python
loop: the graph's plain version, which the CPU tests hold to the JAX
package.

What a replay must not miss, and how the graph keeps it:

* **State.**  A replay reads and writes fixed addresses.  The world's
  state is copied into static buffers before the first replay of a call;
  the captured body starts from them and ends by copying its final state
  back into them, and ``env.world.state`` is a state over those buffers
  after the call (the final state; the next rollout of the same graph
  writes over it).  Every tensor a step carries to the next lives in the
  state (``state.extras`` for scenario buffers): the scenarios' other
  tensors are remade within the step that reads them.
* **Random numbers.**  The world's ``torch.Generator`` is registered with
  the graph (``CUDAGraph.register_generator_state``), and so is one the
  graph owns for the policy (unless the policy draws from the world's): a
  replay starts it from the state of the caller's generator and hands its
  final state back.  So each replay
  draws fresh numbers, the ones the eager loop would draw from the same
  generator states.
* **Host-side caches.**  The LIDAR groups decide on the host whether their
  last cast is current (``World.measure_lidar``).  The capture starts with
  their caches dropped, so a captured step casts each group once, and a
  call ends by dropping them again, since a replay rewrites the state's
  tensors without moving their versions.
* **Launch counts.**  The wrappers' ``LAUNCHES`` count on the host where
  a wrapper launches, so a capture counts the launches it records and a
  replay counts nothing: what a replay ran shows in a ``torch.profiler``
  trace.
* **Host reads.**  A step reads nothing from the device (the host-sync
  check of ``chip_smoke.py`` phase 3); a read inside a capture raises,
  and then ``rollout`` raises: there is no eager fallback on the card.

An env keeps one graph for each ``chunk`` and ``collect``, captured at
first use after one eager warm-up step on a side stream from a copy of
the state (lazy kernel builds and caches are made there, outside the
capture; the state and the world's generator are put back).  It is
captured again, in the same place, when the state's fields change shape
or its extras their keys, or when another policy or ``collect`` function
comes, or the policy's generator becomes the world's or stops being it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from vectorizedmultiagentsimulator_tpu_torch.core.state import WorldState
from vectorizedmultiagentsimulator_tpu_torch.utils import STATE_FIELDS

Tensor = torch.Tensor


def rollout(
    env,
    policy: Optional[Callable] = None,
    n_steps: int = 100,
    generator: Optional[torch.Generator] = None,
    collect: Union[Sequence[str], Callable] = ("obs", "rews", "dones"),
    chunk: Optional[int] = None,
    graph: Optional[bool] = None,
):
    """Roll ``env`` forward ``n_steps`` steps.

    ``policy(obs, generator) -> actions`` maps the observations (as
    ``env.step`` returns them; those of the current state before the first
    step) to the agents' actions; by default uniform random actions in each
    agent's range (``env.get_random_action``), drawn from ``generator``
    (default: a generator seeded 0 at every call, as the JAX package's
    default key).  A policy given here is run before the first step on the
    current state's observations; the default policy reads none.

    Returns ``(final_state, traj)``: ``traj`` maps each name of ``collect``
    (``obs``, ``rews`` and ``dones``, or ``terminated`` and ``truncated``
    with ``env.terminated_truncated``) to the step outputs stacked on a
    leading time axis, in the structure ``env.step`` returns them.
    ``collect`` may instead be a function ``collect(env, step_outputs)``
    returning tensors (a tensor, or dicts, lists and tuples of them): then
    ``traj`` is its result of every step, stacked alike.
    ``env.world.state`` is the final state; ``generator`` ends in the
    state the eager loop leaves it in.

    On the card the steps run as a CUDA graph of ``chunk`` steps (default
    ``n_steps``), replayed ``n_steps / chunk`` times; on the CPU, or with
    ``graph=False``, as a Python loop (the graph's plain version)."""
    chunk = n_steps if chunk is None else chunk
    if n_steps < 1 or chunk < 1 or n_steps % chunk:
        raise ValueError(f"n_steps={n_steps} must be a positive multiple of"
                         f" chunk={chunk}")
    on_card = env.device.type == "cuda"
    if graph is None:
        graph = on_card
    if graph and not on_card:
        raise ValueError(f"rollout: a CUDA graph needs a CUDA env, got"
                         f" {env.device}")
    record = (collect if callable(collect)
              else _Collect(tuple(collect), env.terminated_truncated))
    if not graph:
        return _eager(env, policy, n_steps, generator, record)
    captured = _graph(env, policy, chunk, generator, record)
    traj = None
    for i in range(n_steps // chunk):
        outs = captured.replay(env, generator, first=i == 0)
        if traj is None:
            traj = [torch.empty((n_steps,) + o.shape[1:], dtype=o.dtype,
                                device=o.device) for o in outs]
        for t, o in zip(traj, outs):
            t[i * chunk:(i + 1) * chunk].copy_(o)
    return env.world.state, _unflatten(captured.structure, traj)


# --------------------------------------------------------------------- #
# What a step records
# --------------------------------------------------------------------- #
class _Collect:
    """The ``collect`` entries of a step's outputs, as a dict."""

    def __init__(self, names, terminated_truncated):
        self.names = names
        self.keys = (("obs", "rews", "terminated", "truncated")
                     if terminated_truncated else ("obs", "rews", "dones"))

    def __call__(self, env, outs):
        out = dict(zip(self.keys, outs))
        return {k: v for k, v in out.items() if k in self.names}

    def __hash__(self):
        return hash(("collect", self.names, self.keys))

    def __eq__(self, other):
        return (isinstance(other, _Collect) and self.names == other.names
                and self.keys == other.keys)


def _flatten(tree):
    """``(leaves, structure)`` of nested dicts, lists and tuples of
    tensors."""
    if isinstance(tree, Tensor):
        return [tree], None
    if isinstance(tree, dict):
        leaves, subs = [], {}
        for k, v in tree.items():
            sub_leaves, subs[k] = _flatten(v)
            leaves += sub_leaves
        return leaves, (dict, subs)
    leaves, subs = [], []
    for v in tree:
        sub_leaves, sub = _flatten(v)
        leaves += sub_leaves
        subs.append(sub)
    return leaves, (type(tree), subs)


def _unflatten(structure, leaves):
    """The tree of ``structure`` (``_flatten``'s) over ``leaves``."""
    leaves = list(leaves)

    def build(st):
        if st is None:
            return leaves.pop(0)
        kind, subs = st
        if kind is dict:
            return {k: build(sub) for k, sub in subs.items()}
        return kind(build(sub) for sub in subs)

    return build(structure)


# --------------------------------------------------------------------- #
# The eager loop (CPU tensors; the warm-up on the card)
# --------------------------------------------------------------------- #
def _default_policy(env):
    return lambda obs, generator: env.get_random_actions(generator)


def _steps(env, policy, n_steps, generator, record, each=None):
    """``n_steps`` steps: the policy on the last observations (a given
    policy first on the current state's), ``env.step``, ``record``; calls
    ``each(t, recorded)`` or returns the records."""
    obs = None
    if policy is None:
        policy = _default_policy(env)
    else:
        obs = env.get_from_scenario(get_observations=True, get_rewards=False,
                                    get_infos=False, get_dones=False)[0]
    records = []
    for t in range(n_steps):
        outs = env.step(policy(obs, generator))
        obs = outs[0]
        rec = record(env, outs)
        if each is None:
            records.append(rec)
        else:
            each(t, rec)
    return records


def _eager(env, policy, n_steps, generator, record):
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(0)
    records = _steps(env, policy, n_steps, generator, record)
    flat = [_flatten(r)[0] for r in records]
    stacked = [torch.stack(leaves) for leaves in zip(*flat)]
    return env.world.state, _unflatten(_flatten(records[0])[1], stacked)


# --------------------------------------------------------------------- #
# The graph
# --------------------------------------------------------------------- #
def register_generators(graph, generators) -> None:
    """Register each of ``generators`` with the CUDA graph ``graph``
    (``CUDAGraph.register_generator_state``), before its capture: each
    replay then draws on from the generator's state at the replay and
    advances it as the eager calls would.  A graph of
    ``Environment.step_fn`` calls registers the generator they are given
    (or the world's)."""
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise RuntimeError(
            "this PyTorch cannot register a torch.Generator with a CUDA"
            " graph (CUDAGraph.register_generator_state)")
    for g in generators:
        graph.register_generator_state(g)


def _tensors(state: WorldState) -> Dict[str, Tensor]:
    out = {f: getattr(state, f) for f in STATE_FIELDS}
    out.update({f"extras.{k}": v for k, v in state.extras.items()})
    return out


def _signature(state: WorldState):
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in sorted(_tensors(state).items()))


class _Graph:
    """One captured rollout of ``n_steps`` steps and its static buffers.
    ``shared``: the policy draws from the world's generator, else from one
    the graph owns."""

    def __init__(self, env, policy, n_steps, shared, record):
        world = env.world
        dev = env.device
        self.policy, self.record = policy, record
        self.world_generator = world.generator
        self.generator = (world.generator if shared
                          else torch.Generator(device=dev))
        gens = [world.generator] + ([] if shared else [self.generator])
        self.static = world.state.clone()
        self.signature = _signature(self.static)

        # One eager step on a side stream from a copy of the state: lazy
        # builds, loads and caches happen here, not in the capture.
        world_rng = world.generator.get_state()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.no_grad():
            world.bind(self.static.clone())
            warm = _steps(env, policy, 1, self.generator, record)[0]
        torch.cuda.current_stream(dev).wait_stream(side)
        world.generator.set_state(world_rng)
        leaves, self.structure = _flatten(warm)
        self.outputs = [torch.empty((n_steps,) + x.shape, dtype=x.dtype,
                                    device=dev) for x in leaves]
        del warm, leaves

        world.bind(self.static.replace())
        world.drop_cast_caches()
        self.graph = torch.cuda.CUDAGraph()
        register_generators(self.graph, gens)

        def each(t, rec):
            for buf, x in zip(self.outputs, _flatten(rec)[0]):
                buf[t].copy_(x)

        try:
            with torch.no_grad(), torch.cuda.graph(self.graph):
                _steps(env, policy, n_steps, self.generator, record, each)
                _copy_state(self.static, world.state)
        finally:
            # a capture runs nothing: the world goes back to the static
            # buffers, also if it raised
            world.bind(self.static.replace())
            world.drop_cast_caches()

    def fits(self, env, policy, generator, record) -> bool:
        """Whether this graph runs ``policy`` and ``record`` on ``env``'s
        state as it stands, drawing from ``generator`` as captured."""
        world = env.world
        shared = self.generator is self.world_generator
        return (self.signature == _signature(world.state)
                and policy is self.policy and record == self.record
                and world.generator is self.world_generator
                and (generator is world.generator) == shared)

    def replay(self, env, generator: Optional[torch.Generator], first: bool):
        """Load the world's state into the static buffers (where it is not
        already there) and the policy's generator state into the graph's,
        replay, hand the generator state back; returns the output buffers.
        Without a ``generator`` the graph's own restarts at seed 0 on the
        ``first`` replay of a call."""
        world = env.world
        static = _tensors(self.static)
        for k, v in _tensors(world.state).items():
            if v is not static[k]:
                static[k].copy_(v)
        own = self.generator is not self.world_generator
        if own and generator is not None:
            self.generator.set_state(generator.get_state())
        elif own and first:
            self.generator.manual_seed(0)
        self.graph.replay()
        if own and generator is not None:
            generator.set_state(self.generator.get_state())
        world.bind(self.static.replace())
        world.drop_cast_caches()
        return self.outputs


def _copy_state(static: WorldState, final: WorldState):
    """Copy ``final``'s tensors into ``static``'s.  A final tensor that is
    a view of a static buffer other than its own (a scenario may keep a
    slice of last step's state) is cloned first, so that no copy reads a
    buffer already written."""
    dst, src = _tensors(static), _tensors(final)
    if dst.keys() != src.keys():
        raise RuntimeError(
            "rollout: a step changed the state's extras: "
            f"{sorted(set(dst) ^ set(src))}; scenario buffers are made at"
            " reset")
    storages = {v.untyped_storage().data_ptr() for v in dst.values()}
    src = {k: (v.clone() if v is not dst[k]
               and v.untyped_storage().data_ptr() in storages else v)
           for k, v in src.items()}
    for k, v in src.items():
        if v is not dst[k]:
            dst[k].copy_(v)


def _graph(env, policy, n_steps, generator, record) -> _Graph:
    """The env's graph of ``n_steps`` steps recording ``record``, captured
    at first use and again where it does not fit (``_Graph.fits``): one a
    (``n_steps``, ``collect``), a ``collect`` function counting as one."""
    cache = env.__dict__.setdefault("_rollout_graphs", {})
    key = (n_steps, record if isinstance(record, _Collect) else None)
    graph = cache.get(key)
    if graph is None or not graph.fits(env, policy, generator, record):
        # drop the old graph (its memory pool and buffers) first
        graph = cache.pop(key, None)
        del graph
        cache[key] = _Graph(env, policy, n_steps,
                            generator is env.world.generator, record)
    return cache[key]
