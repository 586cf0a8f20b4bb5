"""Gradient-descent fitting of scene parameters to a target.

Counterpart of the reference package's `fit.py` (BASELINE config 4):
differentiate the renderer end to end and fit camera pose / fractal /
SSAO parameters by gradient descent against a target G-buffer
(`gbuffer_loss`) or a target composite image (`image_loss`, through the
whole post chain). The gradients flow through ray generation, the
traversal (on the binned path through `ops.binned.BinnedGBuffer`, the
recompute from the kernel's path codes) and the analytic intersection.

optax's Adam becomes `torch.optim.Adam` over the scene's 15 leaves
(both put eps outside the square root and correct both moments' bias);
the reference CLI's `optax.cosine_decay_schedule(lr, steps)` becomes
`adam(lr, steps)`, a `LambdaLR` with the same factor. The optimizer
state travels as `AdamState`, optax's leaf layout, so a checkpoint
passes between the two packages (`runtime/checkpoint.py`). With a
device mesh (`parallel.make_mesh`) the G-buffer loss goes through
`parallel.fit_step_sharded` and the image loss differentiates
`parallel.render_frame_sharded`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from sphereflake_tpu_torch import spans
from sphereflake_tpu_torch.config import (
    RenderConfig,
    SceneParams,
    resolve_device,
)
from sphereflake_tpu_torch.render import render_frame, render_gbuffer


def gbuffer_loss(scene: SceneParams, target_pos, target_nrm,
                 cfg: RenderConfig, device="cuda"):
    """Mean-squared G-buffer error (sum over both planes / (W·H))."""
    gb = render_gbuffer(scene, cfg, device=device)
    n_pix = cfg.width * cfg.height
    err = torch.sum((gb.position - target_pos) ** 2) + torch.sum(
        (gb.normal - target_nrm) ** 2
    )
    return err / n_pix


def image_loss(scene: SceneParams, target_image, cfg: RenderConfig,
               device="cuda"):
    """Mean-squared composite-image error: differentiates through the
    whole pipeline — trace, SSAO (with the radius law fed by the
    closest-distance metric, `main.cpp:316`), both blur passes and the
    composite (`main.cpp:301-335`). The loss that puts gradient on the
    SSAO uniforms (`SSAO.cpp:49-55`); the G-buffer loss never touches
    them."""
    image, _gb = render_frame(scene, cfg, device=device)
    n_pix = cfg.width * cfg.height
    return torch.sum((image - target_image) ** 2) / n_pix


def _value_and_grad(loss_fn, scene: SceneParams):
    """(loss, grads) of `loss_fn(scene)` in every leaf; a leaf the loss
    does not reach gets a zero gradient (never None)."""
    leaves = [leaf.detach().requires_grad_(True) for leaf in scene.leaves()]
    with torch.enable_grad():
        with spans.span("fit.forward"):
            loss = loss_fn(SceneParams.from_leaves(leaves))
        with spans.span("fit.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [
        torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)
    ]
    return loss.detach(), SceneParams.from_leaves(grads)


def fit_step(scene: SceneParams, target_pos, target_nrm, cfg: RenderConfig,
             device="cuda"):
    """(loss, grads) for one single-device G-buffer step."""
    dev = resolve_device(device)
    return _value_and_grad(
        lambda s: gbuffer_loss(s, target_pos, target_nrm, cfg, device=dev),
        scene.to(dev),
    )


def fit_step_image(scene: SceneParams, target_image, cfg: RenderConfig,
                   device="cuda"):
    """(loss, grads) for one image-loss step (post chain included)."""
    dev = resolve_device(device)
    return _value_and_grad(
        lambda s: image_loss(s, target_image, cfg, device=dev), scene.to(dev)
    )


@dataclasses.dataclass
class AdamState:
    """An Adam run's state in optax's leaf layout:
    `(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))` with
    a schedule, `(ScaleByAdamState(...), EmptyState())` without one —
    32 and 31 leaves for a scene. `mu`/`nu` hold one tensor per scene
    leaf in `SceneParams.leaves()` order; the counts are 0-d int32."""

    count: torch.Tensor
    mu: list
    nu: list
    schedule_count: torch.Tensor | None = None


def adam_init(scene: SceneParams, schedule: bool = False) -> AdamState:
    """A fresh `AdamState` for `scene` (the template a checkpoint loads
    into: `optax.adam(...).init(scene)`)."""
    leaves = scene.leaves()
    dev = leaves[0].device
    count = lambda: torch.zeros((), dtype=torch.int32, device=dev)
    return AdamState(
        count=count(),
        mu=[torch.zeros_like(x) for x in leaves],
        nu=[torch.zeros_like(x) for x in leaves],
        schedule_count=count() if schedule else None,
    )


def cosine_decay(steps: int) -> Callable[[int], float]:
    """`optax.cosine_decay_schedule`'s factor at step t (alpha 0)."""
    def factor(t: int) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))
    return factor


def adam(learning_rate: float, steps: int | None = None):
    """The optimizer argument of `fit`: a callable
    `build(params, state=None)` that returns `(torch.optim.Adam, None)`
    over the leaves — with `steps`, the scheduler is the cosine decay of
    `optax.adam(optax.cosine_decay_schedule(lr, steps))` as a `LambdaLR`
    (stepped after each update, so the first update uses lr · 1.0 like
    optax's). With `state` (an `AdamState`) the run resumes: Adam's
    moments and count through `load_adam_state`, the schedule at
    `state.schedule_count` (a `LambdaLR` built with `last_epoch` one
    short of it over groups whose `initial_lr` is the base rate: its
    construction steps onto the count)."""
    def build(params, state: AdamState | None = None):
        opt = torch.optim.Adam(params, lr=learning_rate)
        if state is not None:
            load_adam_state(opt, params, state)
        if steps is None:
            return opt, None
        t = 0
        if state is not None and state.schedule_count is not None:
            t = int(state.schedule_count)
        for group in opt.param_groups:
            group["initial_lr"] = learning_rate
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, cosine_decay(steps), last_epoch=t - 1
        )
    return build


def load_adam_state(opt, leaves, state: AdamState):
    """Put `state`'s moments and count into a fresh `torch.optim.Adam`
    over `leaves` (the schedule's count is `adam`'s to place)."""
    sd = opt.state_dict()
    sd["state"] = {
        i: {
            "step": torch.tensor(float(int(state.count))),
            "exp_avg": m.detach().to(x.device, x.dtype).clone(),
            "exp_avg_sq": v.detach().to(x.device, x.dtype).clone(),
        }
        for i, (x, m, v) in enumerate(zip(leaves, state.mu, state.nu))
    }
    opt.load_state_dict(sd)


def adam_state(opt, sched, leaves) -> AdamState:
    """The `AdamState` of a `torch.optim.Adam` over `leaves` (and of its
    `LambdaLR`, or None)."""
    st = [opt.state.get(x, {}) for x in leaves]
    dev = leaves[0].device
    steps = {int(s["step"]) if s else 0 for s in st}
    if len(steps) > 1:
        raise ValueError(
            f"the leaves' Adam step counts differ ({sorted(steps)}): optax "
            "keeps one count, so every leaf must get a gradient each step "
            "(a zero one where it is masked)"
        )
    step = steps.pop()
    i32 = lambda n: torch.tensor(n, dtype=torch.int32, device=dev)
    return AdamState(
        count=i32(step),
        mu=[s["exp_avg"].detach().clone() if s else torch.zeros_like(x)
            for s, x in zip(st, leaves)],
        nu=[s["exp_avg_sq"].detach().clone() if s else torch.zeros_like(x)
            for s, x in zip(st, leaves)],
        schedule_count=None if sched is None else i32(sched.last_epoch),
    )


@dataclasses.dataclass
class FitResult:
    scene: SceneParams  # best-loss parameters seen (keep_best) or final
    opt_state: AdamState
    losses: list


def fit(scene: SceneParams, target_pos, target_nrm, cfg: RenderConfig,
        steps: int = 100, **kw) -> FitResult:
    """Run a fitting loop; returns the fitted scene + loss history.

    `optimizer` builds `(torch.optim.Adam, scheduler or None)` over a
    list of leaf tensors, resuming from an `AdamState` or None
    (`adam(...)`; default `adam(learning_rate)`).
    `mesh` switches to the sharded step (the leaves then live on the
    mesh's home device, not `device`).
    `param_filter` masks the gradient tree (e.g. fit only the camera); a
    masked leaf gets a zero gradient, so every leaf's Adam step count
    stays optax's one `count`. Passing `opt_state` (an `AdamState`)
    resumes a checkpointed run. With `keep_best` (default) the returned
    scene is the best-loss iterate — the iterate *before* the update of
    the step that scored it (the G-buffer loss is only piecewise smooth,
    so the last Adam iterate can sit above the best one). `loss="image"`
    fits against `target_image` through the full post chain
    (`image_loss`), which SSAO-parameter fitting needs.

    The keywords are `_fit`'s. A call is one `fit` unit of the stage
    spans (`spans.py`), its `steps` the unit's counter `fit.steps`."""
    with spans.unit("fit"):
        spans.count("fit.steps", steps)
        return _fit(scene, target_pos, target_nrm, cfg, steps, **kw)


def _fit(
    scene: SceneParams,
    target_pos,
    target_nrm,
    cfg: RenderConfig,
    steps: int = 100,
    learning_rate: float = 2e-3,
    optimizer: Callable | None = None,
    opt_state: AdamState | None = None,
    mesh=None,
    param_filter: Callable[[SceneParams], SceneParams] | None = None,
    log_every: int = 0,
    keep_best: bool = True,
    loss: str = "gbuffer",
    target_image=None,
    device="cuda",
) -> FitResult:
    """`fit`'s body."""
    dev = mesh.home if mesh is not None else resolve_device(device)
    if loss == "image":
        assert target_image is not None, "loss='image' needs target_image"
        target_image = target_image.to(dev)
        if mesh is not None:
            from sphereflake_tpu_torch.parallel import render_frame_sharded

            def loss_fn(s):
                image, _gb = render_frame_sharded(s, cfg, mesh)
                return (torch.sum((image - target_image) ** 2)
                        / (cfg.width * cfg.height))
        else:
            def loss_fn(s):
                return image_loss(s, target_image, cfg, device=dev)

        def step_fn(s):
            return _value_and_grad(loss_fn, s)
    elif mesh is not None:
        from sphereflake_tpu_torch.parallel import fit_step_sharded

        def step_fn(s):
            return fit_step_sharded(s, target_pos, target_nrm, cfg, mesh)
    else:
        target_pos, target_nrm = target_pos.to(dev), target_nrm.to(dev)

        def step_fn(s):
            return _value_and_grad(
                lambda x: gbuffer_loss(x, target_pos, target_nrm, cfg,
                                       device=dev),
                s,
            )

    leaves = [
        x.detach().to(dev).clone().requires_grad_(True)
        for x in scene.leaves()
    ]
    opt, sched = (optimizer or adam(learning_rate))(leaves, opt_state)

    def snapshot():
        return SceneParams.from_leaves([x.detach().clone() for x in leaves])

    losses: list[float] = []
    best_scene, best_loss = None, float("inf")
    for i in range(steps):
        value, grads = step_fn(SceneParams.from_leaves(leaves))
        if param_filter is not None:
            grads = param_filter(grads)
        losses.append(float(value))
        if losses[-1] < best_loss:
            best_loss, best_scene = losses[-1], snapshot()
        for x, g in zip(leaves, grads.leaves()):
            x.grad = g
        opt.step()
        if sched is not None:
            sched.step()
        if log_every and i % log_every == 0:
            print(f"fit step {i}: loss {losses[-1]:.6f}", flush=True)
    final = snapshot()
    return FitResult(
        scene=(best_scene or final) if keep_best else final,
        opt_state=adam_state(opt, sched, leaves),
        losses=losses,
    )


def _masked(grads: SceneParams, keep: str) -> SceneParams:
    zero = lambda group: dataclasses.replace(group, **{
        f.name: torch.zeros_like(getattr(group, f.name))
        for f in dataclasses.fields(group)
    })
    return SceneParams(**{
        f.name: (
            getattr(grads, f.name) if f.name == keep
            else zero(getattr(grads, f.name))
        )
        for f in dataclasses.fields(grads)
    })


def camera_only(grads: SceneParams) -> SceneParams:
    """Gradient mask: optimize the camera pose only."""
    return _masked(grads, "camera")


def ssao_only(grads: SceneParams) -> SceneParams:
    """Gradient mask: optimize the SSAO parameters only (the C++ app's
    tuned uniforms, `SSAO.cpp:49-55`); pair with `loss="image"` — the
    G-buffer loss carries no SSAO signal."""
    return _masked(grads, "ssao")
