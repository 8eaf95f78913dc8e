"""Plain reference of the ``celeba`` configuration: EAD-GAN's CelebA
generator and shared-head discriminator, and the three-phase train step
with its three Adams.

Models as ``celebA/EAD-GAN_celebA.py`` builds them (state-dict keys
``conv_blocks.*`` and ``main.*``); layers, warp, algebra and losses from
``plain.py``.  The step, in the published order: the G phase against the
pre-update D (D takes no gradient); the D phase on the warped reals and
the detached fakes; the info phase, which generates again, reads D three
times and steps the info Adam over G and D.  D runs six times a step and
G twice, each forward moving the spectral-norm and BatchNorm state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reference import plain


class Generator(nn.Module):
    def __init__(self, latent_dim=200, n_classes=10, code_dim=8, channels=3):
        super().__init__()
        layers = [plain.ConvT(latent_dim + n_classes + code_dim, 1024, 4, 1, 0)]
        for cin, cout in ((1024, 512), (512, 256), (256, 128)):
            layers += [plain.ConvT(cin, cout, 4, 2, 1), plain.BatchNorm(cout), nn.ReLU()]
        layers += [plain.ConvT(128, channels, 4, 2, 1), nn.Tanh()]
        self.conv_blocks = nn.Sequential(*layers)

    def forward(self, z, labels, code):
        return self.conv_blocks(torch.cat([z, labels, code], dim=-1)[:, :, None, None])


class Discriminator(nn.Module):
    def __init__(self, n_classes=10, code_dim=8, channels=3):
        super().__init__()
        self.n_classes, self.code_dim = n_classes, code_dim
        layers = []
        for cin, cout in ((channels, 128), (128, 256), (256, 512), (512, 1024)):
            layers += [plain.SNConv(cin, cout, 4, 2, 1), nn.LeakyReLU(0.1)]
        layers += [plain.Conv(1024, 1 + n_classes + code_dim, 4, 1, 0)]
        self.main = nn.Sequential(*layers)

    def forward(self, img):
        out = self.main(img).flatten(1)
        validity = torch.sigmoid(out[:, 0])
        cont = out[:, 1:self.code_dim + 1]
        cat = torch.softmax(out[:, self.code_dim + 1:self.code_dim + 1 + self.n_classes], dim=-1)
        return cat, cont, validity


def build(cfg: dict, device="cpu"):
    """``{"g": G, "d": D}`` at the configuration's widths, in training mode."""
    m = cfg["model"]
    g = Generator(m["latent_dim"], m["n_classes"], m["code_dim"], m["channels"])
    d = Discriminator(m["n_classes"], m["code_dim"], m["channels"])
    return {"g": g.to(device).train(), "d": d.to(device).train()}


def init_spec(cfg: dict):
    models = build(cfg, "meta")
    return [(f"{k}.{n}", s, kind, b) for k, mod in models.items()
            for n, s, kind, b in plain.init_spec(mod)]


def rpqxy_matrix(code):
    """The RPQXY family's code -> matrix: theta = c0 pi / 9, p = 1 + 0.2 c1,
    q = 1 + 0.2 c2, x = 0.1 c3, y = 0.1 c4."""
    return plain.rotation_zoom_shift(code[:, 0] * (math.pi / 9.0), 1.0 + 0.2 * code[:, 1],
                                     1.0 + 0.2 * code[:, 2], 0.1 * code[:, 3], 0.1 * code[:, 4])


def regularize_rpqxy(real_code, trans_code):
    """The relative code between two RPQXY codes by the published closed
    form: trans @ real^-1, then theta, p, q, x, y, then code units."""
    rel = rpqxy_matrix(trans_code) @ plain.inverse(rpqxy_matrix(real_code))
    m00, m01, m10, m11 = rel[:, 0, 0], rel[:, 0, 1], rel[:, 1, 0], rel[:, 1, 1]
    m02, m12 = rel[:, 0, 2], rel[:, 1, 2]
    theta = 0.5 * torch.atan(plain.safe_div(2.0 * (m00 * m10 - m01 * m11),
                                            m00 ** 2 + m11 ** 2 - m01 ** 2 - m10 ** 2))
    ct, st = torch.cos(theta), torch.sin(theta)
    p = m00 * ct + m10 * st
    q = -m01 * st + m11 * ct
    x = plain.safe_div(m02 * ct + m12 * st, p)
    y = plain.safe_div(m12 * ct - m02 * st, q)
    return torch.stack([theta * (9.0 / math.pi), (p - 1.0) / 0.2, (q - 1.0) / 0.2, x / 0.1, y / 0.1],
                       dim=-1)


def optimizers(models, cfg: dict):
    o = cfg["optimizer"]
    g, d = models["g"], models["d"]
    return {
        "opt_g": plain.adam(g.parameters(), o["g_lr"], o["b1"], o["b2"]),
        "opt_d": plain.adam(d.parameters(), o["d_lr"], o["b1"], o["b2"]),
        "opt_info": plain.adam([*g.parameters(), *d.parameters()], o["info_lr"], o["b1"], o["b2"]),
    }


def draw(gen: torch.Generator, batch: int, cfg: dict, device):
    """A step's draws in the step's order: z, code, labels."""
    m = cfg["model"]
    if gen is None:  # shapes only (the operation count, on the meta device)
        return (torch.empty(batch, m["latent_dim"], device=device),
                torch.empty(batch, m["code_dim"], device=device),
                torch.zeros(batch, dtype=torch.long, device=device))
    z = torch.randn(batch, m["latent_dim"], generator=gen, device=device)
    code = torch.rand(batch, m["code_dim"], generator=gen, device=device) * 2.0 - 1.0
    labels = torch.randint(0, m["n_classes"], (batch,), generator=gen, device=device)
    return z, code, labels


def step(models, opts, real, draws, cfg: dict, on_grads=None):
    """One train step on ``real``, a (B, 64, 64, 3) NHWC float32 batch in
    [-1, 1].  ``on_grads(opt_name, opt)`` sees each optimizer's gradients
    just before it steps (None: ``opts`` None runs forward and backward
    without stepping).  Returns the losses as floats' tensors."""
    g, d = models["g"], models["d"]
    m, lam = cfg["model"], cfg["loss"]
    z, code, labels = draws
    onehot = F.one_hot(labels, m["n_classes"]).to(torch.float32)
    scaled = plain.warp(real, rpqxy_matrix(code[:, :5]), "border")
    real_nchw, scaled_nchw = real.permute(0, 3, 1, 2), scaled.permute(0, 3, 1, 2)

    def apply(name, loss):
        if opts is None:
            loss.backward()
            return
        opt = opts[name]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if on_grads is not None:
            on_grads(name, opt)
        opt.step()

    d.requires_grad_(False)
    gen = g(z, onehot, code)
    _, _, validity = d(gen)
    g_loss = plain.bce(validity, torch.ones_like(validity))
    if opts is not None:
        opts["opt_g"].zero_grad(set_to_none=True)
    g_loss.backward()
    d.requires_grad_(True)
    if opts is not None:
        if on_grads is not None:
            on_grads("opt_g", opts["opt_g"])
        opts["opt_g"].step()

    _, _, real_pred = d(scaled_nchw)
    _, _, fake_pred = d(gen.detach())
    d_loss = (plain.bce(real_pred, torch.ones_like(real_pred))
              + plain.bce(fake_pred, torch.zeros_like(fake_pred))) / 2.0
    apply("opt_d", d_loss)

    gen = g(z, onehot, code)
    pred_label, pred_code, _ = d(gen)
    info = lam["lambda_cat"] * plain.cross_entropy(pred_label, labels) + lam["lambda_con"] * plain.mse(
        pred_code, code)
    _, transform_code, _ = d(scaled_nchw)
    _, real_code, _ = d(real_nchw)
    affine = lam["lambda_affine"] * plain.mse(regularize_rpqxy(real_code[:, :5], transform_code[:, :5]),
                                              code[:, :5])
    info_loss = info + affine
    apply("opt_info", info_loss)
    return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "info_loss": info_loss.detach()}


def batch_shape(cfg: dict, batch: int) -> tuple:
    """The shape of a batch of raw rows."""
    m = cfg["model"]
    return (batch, m["img_size"], m["img_size"], m["channels"])


def prepare(rows_u8: torch.Tensor, mask, data_cfg: dict) -> torch.Tensor:
    """A batch from its uint8 rows: mirrored along the width where
    ``mask``, then ``x * scale + shift`` in float32."""
    x = rows_u8
    if mask is not None:
        x = torch.where(mask[:, None, None, None], x.flip(2), x)
    return x.to(torch.float32) * data_cfg["scale"] + data_cfg["shift"]

