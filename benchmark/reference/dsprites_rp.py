"""Plain reference of the ``dsprites_rp`` configuration: EAD-GAN's gray
dSprites stage 2 (``dSprites/rp.py``): generator G, spectral-norm
discriminator D and encoder E, and the frozen stage-1 aligner pxy; the
rp train step with its two Adams (D alone, and G with E).

Models with ``rp.py``'s layers and state-dict keys (``conv_block.*``,
``fc1``/``fc1.0``, ``fc2``/``fc2.0``, ``cat_layer.0``, ``cont_layer.0``);
layers, warp, algebra and losses from ``plain.py``.  The step, in the
published order: A. the reals aligned by the aligner's translation-only
inverse warp (no graph); B. the D phase on the aligned reals distorted
by a drawn rp code (one warp) against G's fakes made without a graph;
C. the info phase, one backward through G and E with D frozen: G's
adversarial term, the categorical and code terms on new fakes, the
closed-form rp consistency of E on the aligned and re-distorted reals
(a second distort warp) and the relative-category term.  Three warps a
step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reference import plain

_TRUNK = (32, 32, 64, 64)
_FLAT = 64 * 4 * 4


def _trunk(conv, channels: int, slope: float) -> nn.Sequential:
    layers = []
    for cin, cout in zip((channels,) + _TRUNK[:-1], _TRUNK):
        layers += [conv(cin, cout, 4, 2, 1), nn.LeakyReLU(slope)]
    return nn.Sequential(*layers)


class Aligner(nn.Module):
    def __init__(self, out_dim=3, channels=1):
        super().__init__()
        self.conv_block = _trunk(plain.Conv, channels, 0.1)
        self.fc1 = plain.Dense(_FLAT, out_dim)

    def forward(self, img):
        return self.fc1(self.conv_block(img).flatten(1))


class Generator(nn.Module):
    def __init__(self, in_dim=7, channels=1):
        super().__init__()
        self.fc1 = nn.Sequential(plain.Dense(in_dim, 128), nn.ReLU())
        self.fc2 = nn.Sequential(plain.Dense(128, _FLAT), nn.ReLU())
        layers = []
        for _ in range(3):
            layers += [plain.ConvT(64, 64, 4, 2, 1), plain.BatchNorm(64), nn.ReLU()]
        layers += [plain.ConvT(64, channels, 4, 2, 1)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, z_c):
        return torch.sigmoid(self.conv_block(self.fc2(self.fc1(z_c)).view(-1, 64, 4, 4)))


class Discriminator(nn.Module):
    def __init__(self, channels=1):
        super().__init__()
        self.conv_block = _trunk(plain.SNConv, channels, 0.2)
        self.fc1 = nn.Sequential(plain.SNDense(_FLAT, 128), nn.LeakyReLU(0.2))
        self.fc2 = plain.Dense(128, 1)

    def forward(self, img):
        return torch.sigmoid(self.fc2(self.fc1(self.conv_block(img).flatten(1))))


class Encoder(nn.Module):
    def __init__(self, n_classes=3, code_dim=4, channels=1):
        super().__init__()
        self.conv_block = _trunk(plain.SNConv, channels, 0.2)
        self.fc1 = nn.Sequential(plain.SNDense(_FLAT, 128), nn.LeakyReLU(0.2))
        self.fc2 = nn.Sequential(plain.SNDense(128, 128), nn.LeakyReLU(0.2))
        self.cat_layer = nn.Sequential(plain.SNDense(128, n_classes), nn.Softmax(dim=-1))
        self.cont_layer = nn.Sequential(plain.SNDense(128, code_dim))

    def forward(self, img):
        h = self.fc2(self.fc1(self.conv_block(img).flatten(1)))
        return self.cat_layer(h), self.cont_layer(h)


def build(cfg: dict, device="cpu"):
    """``{"g", "d", "e", "pxy"}`` at the configuration's widths: G, D and E
    in training mode, the aligner in eval mode and frozen."""
    m = cfg["model"]
    models = {
        "g": Generator(m["n_classes"] + m["code_dim"], m["channels"]),
        "d": Discriminator(m["channels"]),
        "e": Encoder(m["n_classes"], m["code_dim"], m["channels"]),
        "pxy": Aligner(m["pxy_code_dim"], m["channels"]),
    }
    for name, mod in models.items():
        mod.to(device).train()
    models["pxy"].eval().requires_grad_(False)
    return models


def init_spec(cfg: dict):
    models = build(cfg, "meta")
    return [(f"{k}.{n}", s, kind, b) for k, mod in models.items()
            for n, s, kind, b in plain.init_spec(mod)]


def rp_matrix(code):
    """The RP family's code -> matrix: theta = c0 pi / 9, p = q = 1 + 0.2 c1,
    x = 0.1 c2, y = 0.1 c3."""
    p = 1.0 + 0.2 * code[:, 1]
    return plain.rotation_zoom_shift(code[:, 0] * (math.pi / 9.0), p, p, 0.1 * code[:, 2],
                                     0.1 * code[:, 3])


def align_matrix(code):
    """The aligner's translation T(0.1 c1, 0.1 c2) (its zoom c0 unused)."""
    zero = torch.zeros_like(code[:, 0])
    one = torch.ones_like(zero)
    return plain._mat([(one, zero, 0.1 * code[:, 1]), (zero, one, 0.1 * code[:, 2]),
                       (zero, zero, one)])


def regularize_rp(real_code, trans_code):
    """The relative rp code by the published closed form (least squares
    over the similarity): trans @ real^-1, then theta, p, x, y."""
    rel = rp_matrix(trans_code) @ plain.inverse(rp_matrix(real_code))
    m00, m01, m10, m11 = rel[:, 0, 0], rel[:, 0, 1], rel[:, 1, 0], rel[:, 1, 1]
    m02, m12 = rel[:, 0, 2], rel[:, 1, 2]
    theta = torch.atan(plain.safe_div(m10 - m01, m00 + m11))
    ct, st = torch.cos(theta), torch.sin(theta)
    p = 0.5 * (ct * (m00 + m11) + st * (m10 - m01))
    x = plain.safe_div(m02 * ct + m12 * st, p)
    y = plain.safe_div(m12 * ct - m02 * st, p)
    return torch.stack([theta * (9.0 / math.pi), (p - 1.0) / 0.2, x / 0.1, y / 0.1], dim=-1)


def optimizers(models, cfg: dict):
    o = cfg["optimizer"]
    return {
        "opt_d": plain.adam(models["d"].parameters(), o["d_lr"], o["b1"], o["b2"]),
        "opt_info": plain.adam([*models["g"].parameters(), *models["e"].parameters()], o["lr"],
                               o["b1"], o["b2"]),
    }


def draw(gen: torch.Generator, batch: int, cfg: dict, device):
    """A step's draws in the step's order: the D phase's code and labels,
    then the info phase's."""
    m = cfg["model"]
    out = []
    for _ in range(2):
        if gen is None:
            out += [torch.empty(batch, m["code_dim"], device=device),
                    torch.zeros(batch, dtype=torch.long, device=device)]
            continue
        out.append(torch.rand(batch, m["code_dim"], generator=gen, device=device) * 2.0 - 1.0)
        out.append(torch.randint(0, m["n_classes"], (batch,), generator=gen, device=device))
    return tuple(out)


def step(models, opts, real, draws, cfg: dict, on_grads=None):
    """One rp step on ``real``, a (B, 64, 64, 1) NHWC float32 batch in
    {0, 1}.  ``on_grads(opt_name, opt)`` sees each optimizer's gradients
    just before it steps (``opts`` None: forward and backward only)."""
    g, d, e, pxy = models["g"], models["d"], models["e"], models["pxy"]
    n_classes = cfg["model"]["n_classes"]
    code_d, labels_d, code_i, labels_i = draws
    onehot_d = F.one_hot(labels_d, n_classes).to(torch.float32)
    onehot_i = F.one_hot(labels_i, n_classes).to(torch.float32)

    def apply(name, loss):
        if opts is not None:
            opts[name].zero_grad(set_to_none=True)
        loss.backward()
        if opts is not None:
            if on_grads is not None:
                on_grads(name, opts[name])
            opts[name].step()

    with torch.no_grad():
        align_code = pxy(real.permute(0, 3, 1, 2))
        align = plain.warp(real, plain.inverse(align_matrix(align_code[:, :3])), "border")
    align_nchw = align.permute(0, 3, 1, 2)

    trans = plain.warp(align, rp_matrix(code_d[:, :4]), "border")
    with torch.no_grad():
        fakes = g(torch.cat([onehot_d, code_d], dim=-1))
    d_real = d(trans.permute(0, 3, 1, 2))
    d_fake = d(fakes)
    d_loss = (plain.bce(d_real, torch.ones_like(d_real)) + plain.bce(d_fake, torch.zeros_like(d_fake))) / 2.0
    apply("opt_d", d_loss)

    trans_i = plain.warp(align, rp_matrix(code_i[:, :4]), "border")
    d.requires_grad_(False)
    gen = g(torch.cat([onehot_i, code_i], dim=-1))
    rec_cat, rec_cont = e(gen)
    g_fake = d(gen)
    g_loss = plain.bce(g_fake, torch.ones_like(g_fake))
    cat_loss = plain.mutual_info(rec_cat, onehot_i)
    cont_loss = plain.mse(rec_cont, code_i)
    align_cat, align_cont = e(align_nchw)
    trans_cat, trans_cont = e(trans_i.permute(0, 3, 1, 2))
    affine_loss = plain.mse(regularize_rp(align_cont[:, :4], trans_cont[:, :4]), code_i)
    relative_cat_loss = plain.mutual_info(trans_cat, align_cat.detach())
    total = cat_loss + cont_loss + affine_loss + g_loss + relative_cat_loss
    if opts is not None:
        opts["opt_info"].zero_grad(set_to_none=True)
    total.backward()
    d.requires_grad_(True)
    if opts is not None:
        if on_grads is not None:
            on_grads("opt_info", opts["opt_info"])
        opts["opt_info"].step()
    return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "cat_loss": cat_loss.detach(),
            "cont_loss": cont_loss.detach(), "affine_loss": affine_loss.detach(),
            "relative_cat_loss": relative_cat_loss.detach()}


def batch_shape(cfg: dict, batch: int) -> tuple:
    m = cfg["model"]
    return (batch, m["img_size"], m["img_size"])


def prepare(rows_u8: torch.Tensor, mask, data_cfg: dict) -> torch.Tensor:
    """A batch from its uint8 rows: ``x * scale + shift`` in float32 with a
    channel axis (dSprites is never flipped)."""
    return (rows_u8.to(torch.float32) * data_cfg["scale"] + data_cfg["shift"])[..., None]
