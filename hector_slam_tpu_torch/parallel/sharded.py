"""Multi-rank execution over ``torch.distributed``: the counterpart of
``hector_slam_tpu/parallel/sharded.py``.

JAX runs one SPMD program over a ``jax.sharding.Mesh``. Here every rank is
a process that holds the block its ``PartitionSpec`` gives it, and the
sharded steps are the port's own steps given process groups
(core/collectives.py):

  - robot axis ("robot"): data parallelism over trajectories; per-robot
    pyramids are split on their leading axis, so each rank holds only its
    robots' maps. No communication on this axis.
  - beam axis ("beam"): one scan's beams split over the ranks of a robot
    row; their partial JtJ/JtR are all-reduced every GN step and their
    painted cell sets OR-combined (``beam_axis`` of core/matcher.py,
    core/mapping.py and core/slam.py).
  - hypothesis axis: split over every rank, no collectives
    (``shard_hypotheses``).

The mesh spans ranks 0..n-1 of the default process group, row-major:
rank = row * beam + column. The caller initializes the default group and
picks its backend: NCCL for CUDA tensors, one card per rank; gloo for CPU
tensors, or for CUDA tensors of ranks that share a card. Nothing here
picks a backend or switches from one to another; ``run_ranks`` starts
ranks on the backend it is given and raises when that one is not
available.

The steps are compiled where the group allows it, as JAX compiles its
``jax.jit(shard_map(...), donate_argnums=(0,))``: on an NCCL group with
the blocks on the card, ``make_fleet_step`` and
``make_shared_fleet_step`` replay a CUDA graph of the steps' one body
(``fleet_step``, ``shared_fleet_step``; the update on every step, the
gates selected on the card), the group's all-reduces captured inside it,
one graph per (``cfg``, the mesh's shape, the group, shapes, the held
maps), the blocks donated. A gloo group reduces a CUDA tensor through
host memory, which a CUDA graph cannot capture, so gloo groups and CPU
blocks run the same body eagerly. Either way every rank issues the same
collectives on every step, gated or not. The group's backend decides
(``captures_collectives``); a failed capture raises, nothing falls back
to the eager step. Drop the graphs (``core.graphs.clear()``) before
``destroy_process_group``: a kept graph holds NCCL's resources for the
collectives it captured, and with more than one rank the teardown waits
for them (``run_ranks`` does so).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing.connection
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..config import SlamConfig
from ..core import graphs
from ..core.collectives import captures_collectives
from ..core.slam import compiled_step
from ..types import Scan, SlamState
from .batch import fleet_step, match_hypotheses_jit
from .shared_map import shared_fleet_step_jit

PG_TIMEOUT_S = 120   # a rank's collectives give up after this long


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("robot", "beam") grid of ranks, as seen from one rank."""

    robot: int          # rows: robots are split over them
    beam: int           # columns: a scan's beams are split over them
    rank: int           # this rank (row * beam + column)
    group: object       # every rank of the mesh (the flattened mesh)
    beam_group: object  # the ranks of this rank's row (its "beam" axis)

    @property
    def size(self) -> int:
        return self.robot * self.beam

    @property
    def row(self) -> int:
        return self.rank // self.beam

    @property
    def column(self) -> int:
        return self.rank % self.beam


def mesh_shape(n: int, robot_axis: Optional[int] = None):
    """(robot, beam) of a mesh of n ranks: the beam axis gets the factor of
    n the robot axis leaves (by default robot = n/2 for even n > 1, so
    beam = 2; beam = 1 for odd or single n), as the JAX ``make_mesh``."""
    if robot_axis is None:
        robot_axis = n // 2 if n % 2 == 0 and n > 1 else n
    beam_axis = n // robot_axis
    if robot_axis * beam_axis != n:
        raise ValueError(f"make_mesh: robot axis {robot_axis} does not "
                         f"divide {n} ranks")
    return robot_axis, beam_axis


def make_mesh(n_devices: Optional[int] = None,
              robot_axis: Optional[int] = None) -> Optional[Mesh]:
    """A ("robot", "beam") mesh (``mesh_shape``) over the first
    ``n_devices`` ranks (default: all) of the initialized default process
    group. Every rank of the default group must call it (the groups are
    made collectively); a rank outside the mesh gets None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the default process group "
                           "first (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 0 < n <= world:
        raise ValueError(f"make_mesh: {n} ranks asked of {world}")
    robot_axis, beam_axis = mesh_shape(n, robot_axis)
    rank = dist.get_rank()
    group = dist.new_group(list(range(n)))
    beam_group = None
    for row in range(robot_axis):
        g = dist.new_group([row * beam_axis + c for c in range(beam_axis)])
        if rank // beam_axis == row:
            beam_group = g
    if rank >= n:
        return None
    return Mesh(robot_axis, beam_axis, rank, group, beam_group)


def _block(x: torch.Tensor, index: int, parts: int, dim: int = 0
           ) -> torch.Tensor:
    """Block ``index`` of ``parts`` equal blocks of ``x`` along ``dim``, as
    a tensor of its own (the full tensor can then be freed)."""
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"an axis of {n} does not split into {parts} "
                         f"blocks")
    k = n // parts
    return x.narrow(dim, index * k, k).clone()


def _pad_beams(scan: Scan, parts: int) -> Scan:
    """The scan with masked beams appended up to a multiple of ``parts``
    (1081 -> 1152 for the UTM-30LX, as the JAX production test pads)."""
    n = scan.mask.shape[-1]
    pad = -n % parts
    if pad == 0:
        return scan
    lead = scan.mask.shape[:-1]
    return Scan(
        points=torch.cat([scan.points, scan.points.new_zeros(
            lead + (pad, 2))], -2),
        origo=scan.origo,
        mask=torch.cat([scan.mask, scan.mask.new_zeros(lead + (pad,))], -1))


def shard_fleet_state(state: SlamState, mesh: Mesh,
                      cfg: SlamConfig) -> SlamState:
    """This rank's block of a per-robot fleet state (``init_fleet``; R a
    multiple of the robot axis): robots split over the rows, replicated
    over the beam axis (P("robot", ...) on every leaf)."""
    if len(state.log_odds) != cfg.map.levels:
        raise ValueError(f"{len(state.log_odds)} levels, config has "
                         f"{cfg.map.levels}")

    def rows(t):
        return _block(t, mesh.row, mesh.robot)

    return SlamState(*(tuple(rows(t) for t in leaf) if isinstance(leaf, tuple)
                       else rows(leaf) for leaf in state))


def shard_scan(scan: Scan, mesh: Mesh) -> Scan:
    """This rank's block of a fleet's scans (leading robot axis): robots
    over the rows, beams over the columns (P("robot", "beam")), the beams
    padded with masked ones to a multiple of the beam axis."""
    scan = _pad_beams(scan, mesh.beam)
    return Scan(points=_block(_block(scan.points, mesh.row, mesh.robot),
                              mesh.column, mesh.beam, dim=1),
                origo=_block(scan.origo, mesh.row, mesh.robot),
                mask=_block(_block(scan.mask, mesh.row, mesh.robot),
                            mesh.column, mesh.beam, dim=1))


def make_fleet_step(mesh: Mesh, cfg: SlamConfig):
    """The sharded per-robot fleet step: ``step(states, scans)`` on this
    rank's blocks (``shard_fleet_state``, ``shard_scan``) runs
    ``fleet_step`` over its robots, the normal equations and cell sets
    combined over its row's beam shards. Returns this rank's blocks of
    the new states and metrics.

    On an NCCL group with the blocks on the card the step is compiled
    (the module docstring): ``fleet_step`` replayed as a CUDA graph with
    the beam group's all-reduces inside, the states DONATED as in
    ``fleet_step_jit``. Otherwise ``fleet_step`` runs eagerly."""
    group = mesh.beam_group

    def step(states: SlamState, scans: Scan):
        if not (graphs.on_card(states.pose) and captures_collectives(group)):
            return fleet_step(states, scans, cfg, beam_axis=group)
        return compiled_step(
            "sharded_fleet_step", (cfg, mesh.robot, mesh.beam, group),
            states, scans,
            lambda st, points, origo, mask, in_place: fleet_step(
                st, Scan(points, origo, mask), cfg, beam_axis=group,
                in_place=in_place))
    return step


def shard_shared_fleet_state(state: SlamState, mesh: Mesh,
                             cfg: SlamConfig) -> SlamState:
    """This rank's block of a shared-map fleet state
    (``init_shared_fleet``; R a multiple of the mesh size): the robots'
    leaves split over the whole mesh, the pyramid, its quads and the
    shared counters replicated (the tensors of ``state`` itself)."""
    if len(state.log_odds) != cfg.map.levels:
        raise ValueError(f"{len(state.log_odds)} levels, config has "
                         f"{cfg.map.levels}")
    return state._replace(
        pose=_block(state.pose, mesh.rank, mesh.size),
        last_map_update_pose=_block(state.last_map_update_pose, mesh.rank,
                                    mesh.size),
        covariance=_block(state.covariance, mesh.rank, mesh.size))


def shard_shared_fleet_scan(scan: Scan, mesh: Mesh) -> Scan:
    """This rank's block of the shared fleet's scans: robots over the
    whole mesh, beams whole."""
    return Scan(*(_block(t, mesh.rank, mesh.size) for t in scan))


def make_shared_fleet_step(mesh: Mesh, cfg: SlamConfig):
    """The sharded shared-map fleet step: ``step(state, scans)`` on this
    rank's blocks runs the shared-map fleet step over its robots against
    the replicated pyramid, the cell sets OR-combined over the whole mesh,
    so every rank's pyramid stays the same. Returns this rank's blocks of
    the new state and metrics (the truncated count is the fleet's).

    ``shared_fleet_step_jit`` with the mesh's group as its robot axis: on
    an NCCL group with the blocks on the card a CUDA graph with the
    group's all-reduces inside, the state DONATED; otherwise
    ``shared_fleet_step`` eagerly."""
    def step(state: SlamState, scans: Scan):
        return shared_fleet_step_jit(state, scans, cfg, robot_axis=mesh.group)
    return step


def shard_hypotheses(mesh: Mesh, cfg: SlamConfig):
    """Hypothesis-parallel matching: ``fn(pyramid, begin_poses[H, 3],
    scan)`` matches this rank's block of the H axis (split over the whole
    mesh; H a multiple of its size) with the torch-op batched matcher
    compiled (``batch.match_hypotheses_jit``: a CUDA graph on the card,
    on any backend, since nothing is communicated); map and scan are
    replicated. Returns this rank's block of the MatchResult
    (``gather_rows(..., "mesh")`` collects them)."""
    def fn(pyramid, begin_poses: torch.Tensor, scan: Scan):
        return match_hypotheses_jit(pyramid,
                                    _block(begin_poses, mesh.rank, mesh.size),
                                    scan, cfg)
    return fn


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str
                ) -> Optional[torch.Tensor]:
    """Rank 0 gets the blocks of a tensor split on its leading axis,
    concatenated in order; other ranks get None. ``axis`` "robot": a
    block per row (the column-0 rank's; the row's ranks hold equal
    copies); "mesh": a block per rank. Every rank of the mesh must call
    it: each block is broadcast from its owner (the collective both
    backends take on CUDA tensors)."""
    owners = ([row * mesh.beam for row in range(mesh.robot)]
              if axis == "robot" else list(range(mesh.size)))
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    k = x.shape[0]
    full = torch.empty((k * len(owners),) + tuple(x.shape[1:]),
                       dtype=wire.dtype, device=x.device)
    for i, src in enumerate(owners):
        part = full[i * k:(i + 1) * k]
        if mesh.rank == src:
            part.copy_(wire)
        dist.broadcast(part, src=src, group=mesh.group)
    if mesh.rank != 0:
        return None
    return full.to(torch.bool) if x.dtype == torch.bool else full


def gather_fleet_state(state: SlamState, mesh: Mesh
                       ) -> Optional[SlamState]:
    """A sharded per-robot fleet state whole on rank 0 (None elsewhere),
    without quads (``core.slam.quads_of`` derives them)."""
    levels = tuple(gather_rows(t, mesh, "robot") for t in state.log_odds)
    pose, last, cov, step, count = (
        gather_rows(t, mesh, "robot") for t in (
            state.pose, state.last_map_update_pose, state.covariance,
            state.step, state.map_update_count))
    if mesh.rank != 0:
        return None
    return SlamState(levels, pose, last, cov, step, count, quads=())


def gather_shared_fleet_state(state: SlamState, mesh: Mesh
                              ) -> Optional[SlamState]:
    """A sharded shared-map fleet state whole on rank 0 (None elsewhere):
    the robots' leaves gathered, the replicated pyramid and counters
    rank 0's own, without quads."""
    pose, last, cov = (gather_rows(t, mesh, "mesh") for t in
                       (state.pose, state.last_map_update_pose,
                        state.covariance))
    if mesh.rank != 0:
        return None
    return state._replace(pose=pose, last_map_update_pose=last,
                          covariance=cov, quads=())


def _rank_main(fn, rank, world_size, backend, port, args):
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)
    store = dist.TCPStore("localhost", port, world_size, is_master=False,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    try:
        fn(rank, world_size, *args)
    finally:
        # a kept graph holds NCCL's resources for the collectives it
        # captured, and the communicators' teardown waits for them
        graphs.clear()
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str, args=(),
              deadline_s: float = 300.0) -> None:
    """Runs ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, each a rank of a default process group on ``backend``,
    with one torch thread each. The ranks meet at a TCP store that this
    process holds for the call, on a localhost port the system gives it
    (bound once, so no other process can take it in between). ``fn`` and
    ``args`` must pickle (a module-level function). Returns when every
    rank has exited 0. Raises if the backend is not available, if a rank
    fails (the others are killed at once) or if they outlive
    ``deadline_s`` (all are killed): no process outlives the call."""
    if not dist.is_backend_available(backend):
        raise RuntimeError(f"run_ranks: the {backend!r} backend is not "
                           f"available in this torch build")
    ctx = torch.multiprocessing.get_context("spawn")
    store = dist.TCPStore("localhost", 0, world_size, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, store.port, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        pending = list(procs)
        while pending:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: ranks still running after "
                                   f"{deadline_s} s")
            multiprocessing.connection.wait([p.sentinel for p in pending],
                                            timeout=left)
            for p in [p for p in pending if not p.is_alive()]:
                pending.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(f"run_ranks: rank {procs.index(p)} "
                                       f"exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
