"""Progressive accumulation + checkpointing (PyTorch port of
`halogen_tpu/render/accumulate.py`).

Each step renders one frame and folds it into the running mean with
weight 1/FrameCount (`AccumulationShader.shader:27-34`), stopping after
`max_accumulated_frames` unless `unlimited_sampling`. Camera moves reset
accumulation (`HalogenRenderPass.cs:254-257,279-291`). The accumulator
and frame counter are saved to and restored from npz checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.core.types import SceneData
from halogen_tpu_torch.integrator.camera import Camera
from halogen_tpu_torch.integrator.trace import render_frame


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Checkpointable progressive-render state."""

    accum: torch.Tensor  # [H, W, 3] running mean, on the scene's device
    frame_count: torch.Tensor  # 0-dim int32 on the CPU, starts at 1

    @staticmethod
    def create(settings: RenderSettings, device="cpu") -> "RenderState":
        return RenderState(
            accum=torch.zeros((settings.height, settings.width, 3),
                              device=device),
            frame_count=torch.tensor(1, dtype=torch.int32),
        )


def _blend(accum: torch.Tensor, frame: torch.Tensor,
           frame_count: torch.Tensor) -> torch.Tensor:
    """out = accum*(1-w) + frame*w, w = 1/FrameCount
    (AccumulationShader.shader:33, weight at HalogenRenderPass.cs:330)."""
    w = 1.0 / frame_count.to(torch.float32)
    return accum * (1.0 - w) + frame * w


def accumulate_step(state: RenderState, scene: SceneData, camera: Camera,
                    settings: RenderSettings) -> RenderState:
    """One progressive frame (Execute, HalogenRenderPass.cs:270-357)."""
    frame_idx = int(state.frame_count) if settings.accumulate else 1
    frame = render_frame(scene, camera, settings, frame_idx)
    if not settings.accumulate:
        return RenderState(accum=frame,
                           frame_count=torch.tensor(1, dtype=torch.int32))
    return RenderState(
        accum=_blend(state.accum, frame, state.frame_count),
        frame_count=state.frame_count + 1,
    )


class Renderer:
    """Progressive renderer with the reference's reset semantics."""

    def __init__(self, scene: SceneData, camera: Camera,
                 settings: RenderSettings):
        self.scene = scene
        self.camera = camera.to(scene.device)
        self.settings = settings
        self.state = RenderState.create(settings, scene.device)
        self._cam_fingerprint = self._fingerprint(camera)

    @staticmethod
    def _fingerprint(camera: Camera):
        return camera.cam_to_world.cpu().numpy().tobytes()

    def set_camera(self, camera: Camera):
        fp = self._fingerprint(camera)
        if fp != self._cam_fingerprint:  # camera moved -> clear accumulation
            self.reset()
        self.camera = camera.to(self.scene.device)
        self._cam_fingerprint = fp

    def reset(self):
        self.state = RenderState.create(self.settings, self.scene.device)

    @property
    def done(self) -> bool:
        """Accumulation-complete latch (HalogenRenderPass.cs:307)."""
        return (not self.settings.unlimited_sampling) and (
            int(self.state.frame_count) > self.settings.max_accumulated_frames
        )

    def step(self) -> np.ndarray:
        """Render/accumulate one frame (no-op once done); returns the
        current image."""
        if not self.done:
            self.state = accumulate_step(self.state, self.scene, self.camera,
                                         self.settings)
        return self.image

    def render(self, frames: Optional[int] = None) -> np.ndarray:
        """Accumulate `frames` frames (default: max_accumulated_frames)."""
        n = frames if frames is not None else self.settings.max_accumulated_frames
        for _ in range(n):
            if self.done:
                break
            self.step()
        return self.image

    @property
    def image(self) -> np.ndarray:
        return self.state.accum.cpu().numpy()

    def save_checkpoint(self, path: str):
        np.savez(path, accum=self.image,
                 frame_count=self.state.frame_count.numpy())

    def load_checkpoint(self, path: str):
        data = np.load(path)
        self.state = RenderState(
            accum=torch.from_numpy(data["accum"]).to(self.scene.device),
            frame_count=torch.tensor(int(data["frame_count"]),
                                     dtype=torch.int32),
        )
