"""The mesh's ``data`` and ``model`` axes over ``torch.distributed``.

Port of ``dmfusion/parallel/mesh.py``.  dmfusion lays a ``('data',
'model')`` mesh over every device of every process and lets XLA insert
the collectives.  Here each rank is one process started by ``torchrun``,
and the ranks form the same grid, ``(world // model, model)`` in rank
order (``devices.reshape(n // model, model)``): rank ``r`` has data index
``r // model`` and model index ``r % model``.  The model peers of a data
index hold the same batch rows and split the sharded parameters between
them (``parallel/partition.py``, ``parallel/tensor.py``); the data axis
below runs between the ranks of one model index.  With ``model`` 1 the
data axis is every rank:
every rank holds the scene, the weights and the same seeded ``(steps, B)``
id, label and mask arrays, gathers and runs its contiguous shard of each
batch, and the collectives are explicit (:class:`Mesh`'s methods: over the
rank's data group, the ranks of its model index).  A step
sums the ranks' gradients, so it equals one step on the whole batch, as
dmfusion's does: a row-wise loss divides by the whole batch's count, and a
batch-level loss (dqtl's ``qua_loss``) runs on the whole batch's rows
rebuilt on every rank (:meth:`Mesh.batch_rows`).  The GAN's equal shards
average their gradients instead (:meth:`Mesh.mean_all_`).

What has no counterpart: ``batch_sharding``, ``replicate`` and
``shard_batch`` place arrays and constrain shardings inside jitted
code, and eager torch has no sharding constraint; a rank simply holds its
rows (:meth:`Mesh.shard`).  ``make_global_batches`` assembles one global
array from every process's copy; here every rank keeps the global arrays
and takes its rows.

The dense family splits the scene's rows instead of the batch: every rank
holds the whole batch and computes one halo'd row band
(``train/steps.py::DensePrograms``); the window sums of the anchors a rank
owns are summed over the ranks with only its own live
(:meth:`Mesh.sum_live`).

Shards: a batch of ``b`` rows gives every rank ``ceil(b / world)`` rows,
contiguous and in rank order; the rows past ``b`` (on the last ranks)
repeat the batch's first row and are masked out.  dmfusion pads its
shards to a multiple of 64 anchors for its DMA groups, after flooring
``b / data`` (``pallas_gather.py:254-256``), which fails at b = 1025 on
8 devices; the card's window kernel takes any batch, so the port does
not pad to 64 (ROADMAP §C records the deviation).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping

import torch
import torch.distributed as dist

#: The variables ``torchrun`` sets for every rank.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")

#: What still waits under a mesh, by the ROADMAP A14 item that ports it.
A14_ITEMS = {
    "batchnorm": "ROADMAP A14 item 5: SyncBatchNorm",
}



def unported(what: str, item: str) -> NotImplementedError:
    """The error of a path that is not ported under a mesh yet."""
    return NotImplementedError(
        f"{what} under a mesh is not ported to dmfusion_torch yet "
        f"({A14_ITEMS[item]}); run it on one rank")


def wants_distributed(cfg: Mapping[str, Any] | None) -> bool:
    """``mesh.distributed`` is set, or ``DMFUSION_DISTRIBUTED=1``."""
    return bool(cfg and cfg.get("mesh", {}).get("distributed")) or \
        os.environ.get("DMFUSION_DISTRIBUTED") == "1"


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def choose_backend(on_cpu: bool, world: int) -> tuple[str, str]:
    """-> (backend, why).  NCCL when every rank has a card of its own;
    gloo when ranks share a card (NCCL refuses two ranks on one device),
    and always on the CPU."""
    if on_cpu:
        return "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"{world} ranks on {cards} cards, one each"
    return "gloo", f"{world} ranks share {cards} card(s)"


def maybe_initialize_distributed(cfg: Mapping[str, Any] | None = None
                                 ) -> bool:
    """Join the ranks' process group when the run asks for it.

    Engages on ``mesh.distributed`` or ``DMFUSION_DISTRIBUTED=1``, reading
    ``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``.  Returns True when running
    distributed; a group already up is left as it is; without the request
    it does nothing.  The backend follows :func:`choose_backend`; each
    rank then makes ``cuda:(LOCAL_RANK % device_count())`` its current
    card, which :func:`get_mesh` hands to the run as ``Mesh.device``
    (ranks beyond the cards share them), and prints its rank, backend and
    device (the CPU under ``device: cpu``).

    Failing, when asked, is fatal, as in dmfusion: N processes that each
    carried on alone would train unsynchronized on 1/N of the work and
    report success.  A rank that finds no card raises too.
    """
    if not wants_distributed(cfg):
        return False
    if is_distributed():
        return True
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    on_cpu = str((cfg or {}).get("device", "")).lower() == "cpu"
    try:
        if missing:
            raise RuntimeError(f"{', '.join(missing)} not set")
        if not on_cpu and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device on this rank")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        backend, why = choose_backend(on_cpu, world)
        dist.init_process_group(
            backend, rank=rank, world_size=world,
            init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                         f"{os.environ['MASTER_PORT']}"))
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            "distributed initialization was explicitly requested "
            "(mesh.distributed / DMFUSION_DISTRIBUTED) but "
            f"torch.distributed.init_process_group failed: {e}.  Refusing "
            "to continue single-process: each process would otherwise "
            "train unsynchronized and report success.  Start the ranks "
            "with torchrun (RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR/"
            "MASTER_PORT), or unset the flag for a single-process run."
        ) from e
    device = torch.device("cpu")
    if not on_cpu:
        device = torch.device(
            "cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    print(f"[dmfusion] rank {rank}/{world}: backend {backend} ({why}), "
          f"device {device}", flush=True)
    return True


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    if is_distributed():
        dist.destroy_process_group()


def _axis_groups(world: int, model: int) -> tuple[list, list]:
    """``(data groups by model index, model groups by data index)`` of the
    ``(world // model, model)`` grid.  Every rank makes every group, in the
    same order (``dist.new_group``'s rule)."""
    data = world // model
    return ([dist.new_group([d * model + m for d in range(data)])
             for m in range(model)],
            [dist.new_group([d * model + m for m in range(model)])
             for d in range(data)])


@dataclass(frozen=True)
class Mesh:
    """The ``(data, model)`` grid of the ranks: this process's (world)
    rank, its device and the group's backend, the size of the ``model``
    axis, and the groups of this rank's data axis (the ranks of its model
    index; None: every rank, when ``model`` is 1) and of its model peers
    (the ranks of its data index).  Every method that communicates is a
    collective: every rank of its group calls it, in the same order.  The
    data axis's methods (shards, sums, rows) run over the data group and
    the data index; :meth:`broadcast`, :meth:`from_rank0` and
    :meth:`barrier` over every rank."""

    data: int
    rank: int
    device: torch.device
    backend: str
    model: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_index(self) -> int:
        """This rank's place on the data axis: ``rank // model``."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's place among its model peers: ``rank % model``."""
        return self.rank % self.model

    # -- shards --------------------------------------------------------------
    def per_rank(self, b: int) -> int:
        """Rows a rank holds of a batch of ``b``: ``ceil(b / data)``."""
        return -(-b // self.data)

    def bounds(self, b: int) -> tuple[int, int]:
        """This rank's real rows ``[lo, hi)`` of a batch of ``b``."""
        per = self.per_rank(b)
        lo = min(self.data_index * per, b)
        return lo, min(lo + per, b)

    def shard_rows(self, b: int) -> tuple[int, int, int]:
        """``(lo, hi, per)`` of this rank's shard of a batch of ``b``, as the
        window gathers take it (``ops/gather.py``: rows past ``hi`` gather
        the batch's first anchor, as :meth:`shard` pads ids)."""
        return (*self.bounds(b), self.per_rank(b))

    def shard(self, x: torch.Tensor, fill: float | None = None
              ) -> torch.Tensor:
        """This rank's ``per_rank(b)`` entries of ``x`` along its last axis
        (``b`` long), the counterpart of ``make_global_batches``: entries
        past ``b`` are ``fill``, or the first entry when ``fill`` is None
        (a valid anchor id, as dmfusion pads its shards)."""
        b = x.shape[-1]
        per = self.per_rank(b)
        lo, hi = self.bounds(b)
        rows = x[..., lo:hi]
        if hi - lo == per:
            return rows
        pad = (x[..., :1] if fill is None
               else torch.full_like(x[..., :1], fill))
        return torch.cat([rows, pad.expand(*x.shape[:-1], per - (hi - lo))],
                         dim=-1)

    # -- collectives ---------------------------------------------------------
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axis, in place; returns it."""
        dist.all_reduce(t, group=self.data_group)
        return t

    def sum_all_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Sum same-dtype tensors over the data axis in place, as one flat
        collective (a step's gradients)."""
        self._flat(list(tensors), self.sum_)

    def mean_all_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Average same-dtype tensors over the data axis in place, as one
        flat collective (the GAN's gradients and losses: the mean of the
        ranks' equal shards' means is the whole batch's mean)."""
        def mean(flat):
            dist.all_reduce(flat, group=self.data_group)
            flat /= self.data
        self._flat(list(tensors), mean)

    def broadcast_all_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite same-dtype tensors with rank 0's, as one collective
        over every rank."""
        self._flat(list(tensors), lambda flat: dist.broadcast(flat, 0))

    def sync_peers_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite same-dtype tensors with the first model peer's (model
        index 0 of this data index), as one collective over the model
        group; a no-op without a model axis.  The peers compute the same
        replicated values, but a nondeterministic kernel (cuDNN's weight
        gradients use atomics) can part them by a rounding: after this
        they hold the same bits."""
        if self.model > 1:
            src = self.rank - self.model_index
            self._flat(list(tensors), lambda flat: dist.broadcast(
                flat, src, group=self.model_group))

    @staticmethod
    def _flat(tensors: list[torch.Tensor], op) -> None:
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        op(flat)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` (the same shape on each) stacked along
        axis 0 in data order: ``(data * n, ...)``
        (:func:`all_gather_rows`)."""
        return all_gather_rows(t, self.data, self.data_group)

    def batch_rows(self, t: torch.Tensor, b: int) -> torch.Tensor:
        """A batch of ``b`` rows rebuilt on every rank, in batch order, from
        the ranks' shards ``t`` (``per_rank(b)`` rows each): this rank's
        rows are ``t`` itself, with its graph, every other rank's are
        detached copies, and the padding past ``b`` is trimmed.  A loss of
        the whole batch then sends a gradient into this rank's rows alone,
        so the ranks' summed parameter gradients are the whole batch's
        (``torch.distributed.nn``'s ``all_gather`` would reduce every
        rank's gradient into each rank's rows: ``data`` times too much)."""
        per = t.shape[0]
        every = self.rows(t.detach())
        lo = self.data_index * per
        return torch.cat([every[:lo], t, every[lo + per:]])[:b]

    def sum_live(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data axis, with this rank's ``t`` live and the
        others' detached: the gradient of the sum reaches this rank's
        ``t`` alone, so the ranks' summed parameter gradients are those of
        the sum (``torch.distributed.nn``'s ``all_reduce`` would reduce
        every rank's gradient into each rank's ``t``: ``data`` times too
        much).  Exact where at most one rank's entry is not zero (the dense
        bands' owned anchors)."""
        mine = t.detach()
        return t + (self.sum_(mine.clone()) - mine)

    def broadcast(self, obj: Any) -> Any:
        """Rank 0's ``obj`` (any picklable value) on every rank."""
        box = [obj if self.is_main else None]
        dist.broadcast_object_list(box, 0)
        return box[0]

    def from_rank0(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` run on rank 0, and its result, or its error, on every
        rank: one rank touches the file system (the run slot, a checkpoint
        read back), and no rank reads what rank 0 has not finished."""
        out = None
        if self.is_main:
            try:
                out = (True, fn())
            except Exception as e:  # raised on every rank below
                out = (False, e)
        ok, value = self.broadcast(out)
        if not ok:
            raise value
        return value

    def barrier(self) -> None:
        dist.barrier()


def all_gather_rows(t: torch.Tensor, size: int, group: Any = None
                    ) -> torch.Tensor:
    """Every member's ``t`` (the same shape on each) of ``group`` (``size``
    ranks; None: every rank) stacked along axis 0 in group order:
    ``(size * n, ...)``.  ``all_gather_single`` where torch has it (torch
    2.13 deprecates ``all_gather_into_tensor`` for it), else
    ``all_gather_into_tensor``; gloo takes CUDA tensors for either."""
    out = t.new_empty((size * t.shape[0], *t.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, t.contiguous(), group=group)
    return out


def get_mesh(cfg: Mapping[str, Any] | None = None) -> Mesh | None:
    """The run's ``(data, model)`` mesh over the process group's ranks, or
    None on one rank (as ``dmfusion/solvers/base.py:81-82`` drops a
    one-device mesh).

    A world that ``mesh.model`` does not divide raises dmfusion's
    ``ValueError``.  ``mesh.data: -1`` means ``world // model``; an
    explicit ``mesh.data`` must equal it (dmfusion's ``devices[:n]`` would
    leave ranks idle, which no run here wants).  A run that asked for
    ``mesh.distributed`` without a process group raises:
    :func:`maybe_initialize_distributed` comes first (the CLI calls it).
    Under ``mesh.model > 1`` every rank makes the grid's data and model
    groups.  The mesh's device is the CPU under ``device: cpu``, else the
    current card, which :func:`maybe_initialize_distributed` chose for the
    rank.
    """
    m = (cfg or {}).get("mesh", {})
    if wants_distributed(cfg) and not is_distributed():
        raise RuntimeError(
            "mesh.distributed is set but no process group is up: call "
            "dmfusion_torch.parallel.maybe_initialize_distributed(cfg) "
            "first (python -m dmfusion_torch.cli does), under torchrun")
    world = dist.get_world_size() if is_distributed() else 1
    model = int(m.get("model", 1))
    if model < 1 or world % model:
        raise ValueError(f"{world} devices not divisible by model axis "
                         f"{model}")
    data = int(m.get("data", -1))
    if data not in (-1, world // model):
        raise NotImplementedError(
            f"mesh.data {data} with {world} rank(s) and mesh.model {model}: "
            "the port's data axis is every rank not on the model axis "
            "(mesh.data: -1, or the world size over mesh.model); start as "
            "many ranks as the mesh needs with torchrun --nproc-per-node")
    if world == 1:
        return None
    on_cpu = str((cfg or {}).get("device", "")).lower() == "cpu"
    rank = dist.get_rank()
    groups = {}
    if model > 1:
        data_groups, model_groups = _axis_groups(world, model)
        groups = {"data_group": data_groups[rank % model],
                  "model_group": model_groups[rank // model]}
    return Mesh(data=world // model, rank=rank,
                device=torch.device("cpu") if on_cpu
                else torch.device("cuda", torch.cuda.current_device()),
                backend=str(dist.get_backend()), model=model, **groups)


def check_model(model: torch.nn.Module) -> None:
    """Refuse a model whose layers couple the rows of a batch: a BatchNorm
    layer on a rank would normalise over its shard, where dmfusion's mesh
    normalises over the whole batch.  No model of the zoo has one (every
    model, resnet18 included, normalises per sample: GroupNorm or
    LayerNorm, as in dmfusion)."""
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            raise unported(f"a model with BatchNorm ({name or 'root'}: "
                           f"{type(m).__name__})", "batchnorm")
