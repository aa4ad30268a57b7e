"""The world state: one object of stacked tensors, env batch leading.

Same layout as the JAX package's ``WorldState`` (entities ordered
landmarks-then-agents, as ``World.entities``), so a JAX state carries
across field by field (``utils.state_from_numpy``):

  pos      [B, N, 2]   vel     [B, N, 2]
  rot      [B, N, 1]   ang_vel [B, N, 1]
  force    [B, A, 2]   torque  [B, A, 1]   (agent action force/torque)
  c        [B, A, C]   comm state          (C = dim_c, 0-width allowed)
  u        [B, A, U]   physical actions, U = max agent action width
  action_c [B, A, C]   comm actions
  extras   dict[str, Tensor]  scenario/dynamics buffers, keyed
           "<entity name>.<attr>" or "scenario.<attr>"
  steps    [B] int32

All float fields are float32.  The world replaces a field with a new
tensor on every write (no in-place updates), so tensors that autograd
saved for a backward pass are never modified under it.  Randomness is not
part of the state: it comes from the world's ``torch.Generator`` (or the
one a functional call is given, ``Environment.step_fn``).

``replace`` is the JAX pytree's ``.replace``: a new object and a new
``extras`` dict over the same tensors.  ``clone`` copies every tensor.

The one exception to "no in-place updates": road_traffic on map '2'
writes its history ring ``scenario.state_hist`` and its initial-state
buffer ``scenario.isb_buf`` in place (indexed writes into the same
storage, so a captured step neither reallocates nor rereads them), through
``World.own_extra``.  A state the world holds as borrowed (given to a
functional call, set through ``Environment.state``, or read from it) has
such a buffer copied at its first write, so the caller's tensors never
change under it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict

import torch

from vectorizedmultiagentsimulator_tpu_torch.utils import STATE_FIELDS


@dataclass
class WorldState:
    pos: torch.Tensor
    vel: torch.Tensor
    rot: torch.Tensor
    ang_vel: torch.Tensor
    force: torch.Tensor
    torque: torch.Tensor
    c: torch.Tensor
    u: torch.Tensor
    action_c: torch.Tensor
    steps: torch.Tensor
    extras: Dict[str, torch.Tensor] = field(default_factory=dict)

    def replace(self, **fields) -> "WorldState":
        """A new state with ``fields`` set and every other field's tensor
        shared; ``extras`` is a new dict (of the same tensors unless given)."""
        fields.setdefault("extras", dict(self.extras))
        return dataclasses.replace(self, **fields)

    def clone(self) -> "WorldState":
        """A state of copies of every tensor (autograd records the copies)."""
        return WorldState(
            **{f: getattr(self, f).clone() for f in STATE_FIELDS},
            extras={k: v.clone() for k, v in self.extras.items()},
        )

    @staticmethod
    def zeros(
        batch_dim: int,
        n_entities: int,
        n_agents: int,
        action_sizes,
        dim_c: int,
        device=None,
        dtype=torch.float32,
    ) -> "WorldState":
        B, N, A = batch_dim, n_entities, n_agents
        U = max(action_sizes) if action_sizes else 0

        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return WorldState(
            pos=z(B, N, 2),
            vel=z(B, N, 2),
            rot=z(B, N, 1),
            ang_vel=z(B, N, 1),
            force=z(B, A, 2),
            torque=z(B, A, 1),
            c=z(B, A, dim_c),
            u=z(B, A, U),
            action_c=z(B, A, dim_c),
            steps=torch.zeros((B,), dtype=torch.int32, device=device),
        )
