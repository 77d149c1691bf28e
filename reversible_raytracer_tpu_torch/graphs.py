"""CUDA graphs of the training step: the port's counterpart of ``jax.jit``.

A step of the training loop is a hundred or so small launches (the step
kernel, the packing of the scene into the kernel's rows, the flat optimizer
update). Launched one by one from Python, they leave the card idle most of
the step. `GraphStep` runs a step function once eagerly, captures the same
function into one ``torch.cuda.CUDAGraph``, and from then on replays the
graph: one host call a step, and the card runs the recorded launches back to
back.

The captured function reads and writes only static buffers: the scene, the
optimizer state and the target live in tensors that `GraphStep` owns, and
each replay writes the step's results back into them in place. A caller who
passes the tensors that the last call returned pays nothing to bring them
in; other tensors are copied into the static buffers first.

A replay makes the launches its capture recorded, so each replay adds to
every kernel's ``launches`` (`graph_kernels`) its count of them, and the
capture's own calls (which launched nothing) are taken back out.

A function that cannot be captured (it copies between host and device,
synchronizes, or launches something a graph cannot hold) raises
`CaptureError` with the reason: nothing runs it eagerly instead.
"""

from __future__ import annotations

import torch


class CaptureError(RuntimeError):
    """A step that a CUDA graph could not capture."""


def graph_kernels():
    """Every CUDA kernel of the port (each with its ``launches`` count)."""
    from .ops.kernels import fused, fused_vec, fused_vec_soft

    return fused.KERNELS + fused_vec.KERNELS + fused_vec_soft.KERNELS


class GraphStep:
    """``step(scene, state, target) -> (scene, state, loss, grad_norm)`` on
    CUDA as one graph replay a call.

    ``fn(scene, state, target)`` is the eager step: a pure function of a
    Scene, a dict of state tensors and an (H, W, 3) target that returns the
    next scene and state, the loss and the gradient norm. ``static_scene``
    builds the static scene from the first scene passed (the trainable leaves
    as views of one flat vector, for example), and ``put_scene(static,
    scene)`` copies a scene into it, leaving alone what already is static.

    The first call runs ``fn`` eagerly (on a side stream, as torch requires
    before a capture) and writes its results into the static buffers: that
    call is the step. It then captures ``fn`` on the static buffers, on the
    same stream. Every later call is one replay on the current stream. The scene, state, loss and grad norm returned
    are the static buffers: the next call overwrites them.
    """

    def __init__(self, fn, static_scene, put_scene):
        self.fn = fn
        self.static_scene = static_scene
        self.put_scene = put_scene
        self.graph = None
        self.replay_launches = {}  # kernel name -> launches a replay makes
        self.scene = self.state = self.target = None

    def _setup(self, scene, state, target):
        self.scene = self.static_scene(scene)
        self.state = {k: v.detach().clone() for k, v in state.items()}
        self.target = target.detach().clone()
        self._target_src = target
        self.loss = torch.zeros((), dtype=torch.float32, device=target.device)
        self.grad_norm = torch.zeros((), dtype=torch.float32, device=target.device)

    def _body(self):
        scene, state, loss, gnorm = self.fn(self.scene, self.state, self.target)
        self.put_scene(self.scene, scene)
        for k in self.state:
            self.state[k].copy_(state[k])
        self.loss.copy_(loss)
        self.grad_norm.copy_(gnorm)

    def _capture(self, side):
        """Capture the step on the side stream. ``torch.cuda.graph`` would
        also synchronize, collect Python's garbage and empty the allocator's
        cache first, which took tens of milliseconds a capture; the capture
        needs none of it."""
        kernels = graph_kernels()
        before = {k.name: k.launches for k in kernels}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()
                try:
                    self._body()
                finally:
                    graph.capture_end()
        except Exception as exc:  # the reason goes up; nothing runs eagerly instead
            first = exc  # the end of a spoilt capture raises too: name the first fault
            while first.__context__ is not None:
                first = first.__context__
            raise CaptureError(f"the step could not be captured into a CUDA graph: "
                               f"{type(first).__name__}: {first}") from exc
        finally:
            recorded = {k.name: k.launches - before[k.name] for k in kernels}
            for k in kernels:
                k.launches = before[k.name]
        self.graph = graph
        self.replay_launches = {name: n for name, n in recorded.items() if n}
        self._counted = [(k, recorded[k.name]) for k in kernels if recorded[k.name]]

    def replay(self) -> None:
        """One replay of the captured step on the static buffers."""
        self.graph.replay()
        for k, n in self._counted:
            k.launches += n

    def __call__(self, scene, state, target):
        if self.graph is None:
            self._setup(scene, state, target)
            side = torch.cuda.Stream(device=target.device)
            side.wait_stream(torch.cuda.current_stream(target.device))
            with torch.cuda.stream(side):
                self._body()
            side.synchronize()  # the capture starts on an idle stream
            self._capture(side)
            torch.cuda.current_stream(target.device).wait_stream(side)
        else:
            if scene is not self.scene:
                self.put_scene(self.scene, scene)
            if state is not self.state:
                for k in self.state:
                    self.state[k].copy_(state[k])
            if target is not self.target and target is not self._target_src:
                self.target.copy_(target)
                self._target_src = target
            self.replay()
        return self.scene, self.state, self.loss, self.grad_norm
