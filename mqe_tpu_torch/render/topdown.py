"""Offline top-down renderer: headless replacement for the reference's camera
sensors + GIF recording (ref mqe/utils/helpers.py:276-374, root test.py:12-29).

Counterpart of `mqe_tpu/render/topdown.py`. It runs on the host: one env's
tensors are moved there (`.cpu()`) and drawn with matplotlib Agg — the
terrain (heightfield shading + wall boxes), robots (oriented triangles with
per-agent colors), NPC geoms and static fixtures; frames assemble into a GIF
via PIL. matplotlib and PIL are imported when used, not with this module.
"""
from __future__ import annotations

import numpy as np

AGENT_COLORS = ["tab:blue", "tab:green", "tab:red", "tab:orange"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class TopDownRenderer:
    def __init__(self, env, margin: float = 1.0, px: int = 480):
        import matplotlib

        matplotlib.use("Agg")
        self.env = env
        self.margin = margin
        self.px = px

    def render(self, env_state, env_idx: int = 0) -> np.ndarray:
        """Returns an (H, W, 3) uint8 frame of one env."""
        import matplotlib.patches as mpatches
        import matplotlib.pyplot as plt

        env = self.env
        origin = _host(env.env_origins[env_idx])
        tl = max(env.build.track_length, 4.0)
        tw = max(env.build.track_width, 4.0)
        x0, x1 = origin[0] - self.margin, origin[0] + tl + self.margin
        y0 = origin[1] - tw / 2 - self.margin
        y1 = origin[1] + tw / 2 + self.margin

        fig, ax = plt.subplots(figsize=(self.px / 96, self.px / 96 * (y1 - y0) / (x1 - x0)), dpi=96)
        # heightfield shading
        hf = np.asarray(env.build.height)
        sc = float(env.build.scale)
        ho = np.asarray(env.build.origin)
        ix0 = int(max((x0 - ho[0]) / sc, 0))
        ix1 = int(min((x1 - ho[0]) / sc, hf.shape[0]))
        iy0 = int(max((y0 - ho[1]) / sc, 0))
        iy1 = int(min((y1 - ho[1]) / sc, hf.shape[1]))
        if ix1 > ix0 and iy1 > iy0:
            patch = hf[ix0:ix1, iy0:iy1]
            ax.imshow(
                patch.T, origin="lower", cmap="Greys",
                extent=(ho[0] + ix0 * sc, ho[0] + ix1 * sc, ho[1] + iy0 * sc, ho[1] + iy1 * sc),
                vmin=-0.1, vmax=0.5, alpha=0.6,
            )
        # wall boxes
        for b in _host(env.env_boxes[env_idx]):
            if b[6] > 0:
                ax.add_patch(mpatches.Rectangle(
                    (b[0] - b[3], b[1] - b[4]), 2 * b[3], 2 * b[4], color="dimgray", alpha=0.8))
        # static geoms: (G, 8) rows of kind, center, sizes, valid
        for row in _host(env.static_geoms[env_idx]):
            if row[7] > 0:
                if row[0] == 0:  # box
                    ax.add_patch(mpatches.Rectangle(
                        (row[1] - row[4], row[2] - row[5]), 2 * row[4], 2 * row[5],
                        color="saddlebrown", alpha=0.5))
                else:  # cylinder
                    ax.add_patch(mpatches.Circle((row[1], row[2]), row[4], color="saddlebrown",
                                                 alpha=0.5))
        # NPCs
        npc_pos = _host(env_state.phys.npcs.pos)
        for j in range(npc_pos.shape[1] if npc_pos.ndim == 3 else 0):
            p = npc_pos[env_idx, j]
            ax.add_patch(mpatches.Circle((p[0], p[1]), 0.25, color="purple", alpha=0.7))
        # agents as oriented triangles
        pos = _host(env_state.phys.agents.pos[env_idx])
        quat = _host(env_state.phys.agents.quat[env_idx])
        for a in range(pos.shape[0]):
            x, y = pos[a, 0], pos[a, 1]
            qx, qy, qz, qw = quat[a]
            yaw = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
            c, s = np.cos(yaw), np.sin(yaw)
            tri = np.array([[0.3, 0.0], [-0.15, 0.12], [-0.15, -0.12]]) @ np.array([[c, s], [-s, c]])
            tri += [x, y]
            ax.add_patch(mpatches.Polygon(tri, color=AGENT_COLORS[a % len(AGENT_COLORS)]))
        ax.set_xlim(x0, x1)
        ax.set_ylim(y0, y1)
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])
        fig.tight_layout(pad=0.1)
        fig.canvas.draw()
        frame = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        plt.close(fig)
        return frame

    @staticmethod
    def save_gif(frames, path, fps: int = 20):
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(
            path, save_all=True, append_images=imgs[1:],
            duration=int(1000 / fps), loop=0,
        )
