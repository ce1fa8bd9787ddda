"""K training steps per dispatch: ``run.scan_steps`` (counterpart of
``make_multi_step``, ``slcl_tpu/train/steps.py:704-730``).

JAX scans K steps inside one jitted dispatch. Here one step is captured
once as a CUDA graph and replayed: a replay is one launch of every kernel
of the step, with no Python, autograd or allocator work on the host. The
Trainer groups an epoch's batches by K as JAX does
(``slcl_tpu/train/trainer.py:622-650``); a group's steps are enqueued back
to back, the batches already on the device.

A graph replays the device addresses it was captured with, so everything a
step reads or writes lives at a fixed address:
  - the batch: each tensor is copied into a static slot before the step;
  - the state: parameters, BatchNorm buffers and optimizer moments are
    updated in place by the step, and so are the class centres and RAIN's
    sampling (``copy_``); ``state.step`` stays a host integer, advanced by
    the runner around a replay;
  - the schedule: ``warm``, ``fresh`` and ``eps_on`` reach the step as 0-d
    tensors filled before each step, which it reads through
    ``steps.select`` and products; the LRs are 0-d device tensors in the
    optimizer groups (``state.capturable``), filled by ``set_lr`` before
    each step, and the step gets ``lr``/``lr_dis`` as None (set already);
  - the random draws (MCCL's rMC ids, RAIN's noise, DDFSeg's and
    AdaptEvery's dropout masks): the step is built with :class:`StagedDraws`'
    hooks, which hand it static buffers that the runner fills before each
    step with the very calls the eager step makes for that (seed, step), so
    a replayed step draws what the eager one would, bit for bit.

Capture follows real steps, never throwaway ones: step 0 always runs
eagerly (its centre bootstrap is a Python branch on ``state.step``), and so
do the first ``WARMUP`` (2) steps after it that the runner takes, on a side
stream; they build the kernel libraries, fill the kernels' launch-grid
caches and create the optimizer state. The next step is captured (which
runs nothing) and replayed once, which takes it: from step 0, steps 0-2
run eagerly and step 3 is the first replayed.

On the CPU (and with ``capture=False``) the runner calls the step where it
would replay the graph, with the same static slots, in-place state, device
scalars and staged draws: the CPU tests hold it to the plain epoch bit for
bit. On the card every step, plain or replayed, runs the optimizers'
capturable forms (``state.make_optimizer``: Adam's step counters on the
device, SGD's fused update, which reads a device LR), so a replayed step is
the eager step's arithmetic there too.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .state import TrainState, capturable, optimizers, set_lr
from .steps import Generators, Metrics, rmc_draw
from .steps_extra import dropout_draw
from .steps_rain import noise_draw

# the schedule keys that reach a runner's step as device scalars; the LRs
# are set in the optimizer groups before the step instead
FLAGS = ("warm", "fresh", "eps_on")
LR_KEYS = ("lr", "lr_dis")
# eager steps after step 0 before the capture
WARMUP = 2


class StagedDraws:
    """A step's random draws as static buffers. ``hooks()`` are
    ``build_step``'s ``draw_assign``/``draw_noise``/``draw_dropout``: the
    i-th draw of a step returns the i-th buffer. The first step records the
    draws (their arguments, and the draw itself as the buffer);
    :meth:`prepare` refills every buffer for the next step's (seed, step)
    with the eager step's own draws (``steps.rmc_draw``,
    ``steps_rain.noise_draw``, ``steps_extra.dropout_draw``). While
    ``frozen`` (a capture), a draw that was not recorded raises."""

    def __init__(self):
        self.gens = Generators()
        self.slots: List[Tuple[str, tuple, torch.Tensor]] = []
        self.seed = self.step = self.next = 0
        self.frozen = False

    def hooks(self) -> Dict[str, Callable]:
        return {"draw_assign": self._assign, "draw_noise": self._noise,
                "draw_dropout": self._dropout}

    def prepare(self, seed: int, step: int) -> None:
        self.seed, self.step, self.next = seed, step, 0
        for kind, args, buf in self.slots:
            buf.copy_(self._draw(kind, args))

    def _draw(self, kind: str, args: tuple) -> torch.Tensor:
        fn = {"assign": rmc_draw, "noise": noise_draw, "dropout": dropout_draw}[kind]
        return fn(self.gens, self.seed, self.step, *args)

    def _slot(self, kind: str, args: tuple) -> torch.Tensor:
        i, self.next = self.next, self.next + 1
        if i < len(self.slots):
            k, a, buf = self.slots[i]
            if (k, a) != (kind, args):
                raise RuntimeError(f"draw {i} of the step is {kind}{args}, staged as {k}{a}")
            return buf
        if self.frozen:
            raise RuntimeError(f"draw {i} ({kind}{args}) was not made by the eager steps "
                               "before the capture")
        buf = self._draw(kind, args)
        self.slots.append((kind, args, buf))
        return buf

    def _assign(self, m: int, P: int, device: torch.device) -> torch.Tensor:
        return self._slot("assign", (m, P, device))

    def _noise(self, shape, device: torch.device) -> torch.Tensor:
        return self._slot("noise", (tuple(shape), device))

    def _dropout(self, step: int, path: str, call: int, shape, keep: float,
                 device: torch.device) -> torch.Tensor:
        # the step argument is the state's, which prepare() has set already
        return self._slot("dropout", (path, call, tuple(shape), keep, device))


class MultiStep:
    """The runner: ``multi(state, batches, sched, acc)`` takes one step per
    batch (``state.step`` advancing), adding each step's metrics into
    ``acc`` as the plain epoch does (``acc[k] + v``, in step order). See the
    module docstring. ``capture`` replays a CUDA graph of ``step_fn`` (on a
    CUDA device only); the numbers it keeps: ``capture_s`` (capture and its
    first replay), ``captured_step``, ``replays``, ``eager_steps``."""

    def __init__(self, step_fn: Callable, draws: StagedDraws, state: TrainState,
                 device: torch.device, capture: bool = True):
        self.step_fn, self.draws, self.device = step_fn, draws, device
        self.capture = capture and device.type == "cuda"
        if device.type == "cuda":
            # as make_optimizer builds them; an optimizer made otherwise would
            # have its float LR baked into the graph
            for opt in optimizers(state).values():
                capturable(opt)
        self.inputs: Optional[Dict[str, torch.Tensor]] = None
        self.flags = {k: torch.zeros((), dtype=torch.float32, device=device) for k in FLAGS}
        self.sched_in = {**dict.fromkeys(LR_KEYS), **self.flags}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Metrics] = None
        self.side = torch.cuda.Stream(device) if self.capture else None
        self.capture_s: Optional[float] = None
        self.captured_step: Optional[int] = None
        self.replays = self.eager_steps = self.warmed = 0

    def fits(self, batch: Dict[str, torch.Tensor]) -> bool:
        """Whether ``batch`` has the static slots' keys, shapes and dtypes
        (any batch does before the first)."""
        if self.inputs is None:
            return True
        return (batch.keys() == self.inputs.keys()
                and all(v.shape == self.inputs[k].shape and v.dtype == self.inputs[k].dtype
                        for k, v in batch.items()))

    def __call__(self, state: TrainState, batches: Sequence[Dict[str, torch.Tensor]],
                 sched: Dict[str, float], acc: Dict[str, torch.Tensor]) -> None:
        for batch in batches:
            out = self._step(state, batch, sched)
            for k, v in out.items():
                # the graph's outputs are overwritten by the next replay
                acc[k] = acc[k] + v if k in acc else v.clone()

    def _step(self, state: TrainState, batch, sched) -> Metrics:
        for name, opt in optimizers(state).items():
            set_lr(opt, sched["lr"] if name == "opt_seg" else sched["lr_dis"])
        for k in FLAGS:
            self.flags[k].fill_(float(sched.get(k, 1.0 if k == "fresh" else 0.0)))
        self.draws.prepare(state.seed, state.step)
        if self.inputs is None:
            self.inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            state.step += 1
            return self.outputs
        if self.capture and state.step > 0 and self.warmed >= WARMUP:
            return self._capture(state)
        self.eager_steps += 1
        self.warmed += state.step > 0
        if self.side is None:
            return self.step_fn(state, self.inputs, self.sched_in)
        # warm-up off the default stream, as capture requires
        self.side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.side):
            out = self.step_fn(state, self.inputs, self.sched_in)
        torch.cuda.current_stream(self.device).wait_stream(self.side)
        return out

    def _capture(self, state: TrainState) -> Metrics:
        """Capture the step (the host runs it once, ``state.step`` advancing;
        the device nothing), then replay it to take the step."""
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self.captured_step = state.step
        graph = torch.cuda.CUDAGraph()
        self.draws.frozen = True
        try:
            with torch.cuda.graph(graph):
                self.outputs = self.step_fn(state, self.inputs, self.sched_in)
        finally:
            self.draws.frozen = False
        self.graph = graph
        graph.replay()
        self.replays += 1
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        return self.outputs


def make_multi_step(step_fn: Callable, draws: StagedDraws, state: TrainState,
                    device: torch.device, capture: bool = True) -> MultiStep:
    """The runner of ``step_fn``, a step built with ``draws.hooks()``; see
    :class:`MultiStep`."""
    return MultiStep(step_fn, draws, state, device, capture=capture)
