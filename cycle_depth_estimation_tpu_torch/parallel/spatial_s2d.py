"""The row forwards of the S2D family's nets under ``--parallel sp``
(``parallel/spatial.py`` walks them): ``S2D`` (``G1``, ``GeneralNet``,
``RDep``, ``SDiscriminator``), ``S2D_base`` (``G1`` with ResnetBlocks,
``GeneralNet2``, ``SEG2``/``DEP2``, ``DropDiscriminator``) and ``S2D_alt``
(``GBase``, ``FeatureNet``, ``SEGAlt``/``DEPAlt``, ``DropDiscriminator``).

Each mirrors the net's ``forward`` in ``models/s2d_networks.py`` on this
rank's rows, with each plane's global height beside them:

- the dense layers concatenate their growth onto their input's rows, and
  the PSP transitions and head concatenate their branches' rows (the
  head's dilated 2×2 and 3×3 convs fetch d·(k − 1) rows around each
  output row, ``conv2d_rows``);
- the attention gates' ``nn.AdaptiveAvgPool2d(1)`` is ``global_mean_rows``:
  every rank holds the (N, C, 1, 1) map whole and scales its rows by it;
- the bilinear ×2 of ``GSide`` and ``SegBlock`` (corners aligned) is
  ``bilinear2_rows``, and ``DropDiscriminator``'s half-size label map
  ``nearest_rows``;
- ``DropDiscriminator``'s Dropout2d takes the (N, C) keep-masks it is given
  (drawn for the global batch, this rank's rows of the batch kept, the
  same on every ``model`` rank; the models always pass them): nothing is
  exchanged;
- a net's input that another net made (G_2's features, R_D's, G_1's)
  need not split evenly: its heights come from ``plane_heights``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .spatial import (_cat, _input_rows, _layer, _run, _sequential_net,
                      bilinear2_rows, global_mean_rows, nearest_rows,
                      plane_heights, pool2d_rows)


# ---- blocks ------------------------------------------------------------------
def _dense_layer(mod, x, h, group):
    return _cat((x, h), _run(mod, x, h, group))


def _dual_block(mod, x, h, group):
    return (x + _run(mod.conv0_block, x, h, group)[0]
            + _run(mod.conv1_block, x, h, group)[0]), h


def _psp_trans(mod, x, h, group):
    y, _ = _run(mod.trans[:2], x, h, group)
    y, _ = _cat(_layer(mod.trans[2], y, h, group),
                _layer(mod.trans[3], y, h, group))
    return pool2d_rows(y, h, group)


def _psp_head(mod, x, h, group):
    y, _ = _run(list(mod)[:2], x, h, group)
    y, _ = _cat(*(_layer(mod[k], y, h, group) for k in range(2, 6)))
    return _layer(mod[6], y, h, group)


def _deconv_block(mod, x, h, group):
    y, h = _layer(mod.deconv, F.leaky_relu(x, mod.negative_slope), h, group)
    return (y, h) if mod.bn is None else _layer(mod.bn, y, h, group)


def block_forwards():
    from ..models import s2d_networks as sn

    return {sn.DenseLayer: _dense_layer, sn.DualResnetBlock: _dual_block,
            sn.PspTrans: _psp_trans, sn.PspHead: _psp_head,
            sn.DeconvBlock: _deconv_block}


def _gate(seq, x, h, group) -> torch.Tensor:
    """An attention gate (its layers, ``nn.AdaptiveAvgPool2d(1)``, the
    sigmoid): the (N, C, 1, 1) map, whole on every rank."""
    y, h = _run(seq[:-2], x, h, group)
    return seq[-1](global_mean_rows(y, h, group))


# ---- the S2D nets ------------------------------------------------------------
def _g1(net, group, x):
    y, h = _run(net.features, x, _input_rows(x, group), group)
    return _run(net.model, y, h, group)[0]


def _general_net(net, group, x, mode: str = "R"):
    f = net.features
    if mode == "R":
        x, h = _run([f.conv0, f.norm0, f.relu0], x, _input_rows(x, group),
                    group)
    else:
        h = plane_heights([x], group)[0]
    feats = []
    for i in range(len(net.feature_channels)):
        x, h = _layer(getattr(f, f"denseblock{i + 1}"), x, h, group)
        feats.append(x.detach())
        if i < len(net.PSP):
            x, h = _psp_trans(net.PSP[i], x, h, group)
    return _psp_head(net.psp, x, h, group)[0], feats


def _gside(mod, side, deep, group):
    (s, h_s), (d, h_d) = side, deep
    gate = _gate(mod.attention_bs, d, h_d, group)
    y, h = _run(mod.side_conv, s, h_s, group)
    y, h = _run(mod.conv, d + gate * y, h, group)
    return bilinear2_rows(y, h, group)


def _seg_block(mod, x, h, group):
    y, h = bilinear2_rows(*_run(mod.deconv, x, h, group), group)
    return F.leaky_relu(_layer(mod.bn, y, h, group)[0], 0.02)


def _depth_block(mod, x, h, group):
    dep_o, out_f = [], []
    for up, head, att in zip(mod.upconv, mod.depth_out, mod.attention_bs):
        f, h_f = _run(up, x, h, group)
        dep_o.append(_run(head, f, h_f, group)[0])
        out_f.append(_gate(att, x, h, group) * f + f)
    y, h_y = _run(mod.conv, torch.cat(out_f, 1), h_f, group)
    return dep_o, _run(mod.depconv, y, h_y, group)[0]


def _rdep(net, group, s_features, d_feature):
    hs = plane_heights([*s_features[1:], d_feature], group)
    skip = list(zip(s_features[1:], hs))
    out0 = _gside(net.AT[0], skip[2], (d_feature, hs[3]), group)
    out1 = _gside(net.AT[1], skip[1], out0, group)
    out2 = _gside(net.AT[2], skip[0], out1, group)
    return ((out0[0], out1[0], out2[0]), _seg_block(net.seg_d, *out2, group),
            _depth_block(net.dep, *out2, group))


def _feature_net(attr: str):
    """A net that is one ``Sequential`` over another net's output."""
    def forward(net, group, x):
        return _run(getattr(net, attr), x, plane_heights([x], group)[0],
                    group)[0]
    return forward


# ---- the base generation ---------------------------------------------------
def _dense_trunk(net, x, h, group):
    feats = []
    for i in range(net.n_blocks):
        x, h = _layer(getattr(net.features, f"denseblock{i + 1}"), x, h,
                      group)
        feats.append(x)
        if i < net.n_blocks - 1:
            x, h = _layer(getattr(net.features, f"transition{i + 1}"), x, h,
                          group)
    return feats, _psp_head(net.psp, x, h, group)[0]


def _general_net2(net, group, x, mode: str = "R"):
    f = net.features
    if mode == "R":
        x, h = _layer(f.conv0, x, _input_rows(x, group), group)
    else:
        h = plane_heights([x], group)[0]
    x, h = _run([f.norm0, f.relu0], x, h, group)
    feats, out = _dense_trunk(net, x, h, group)
    return [x, *feats], out


def _feature_trunk(net, group, x):
    return _dense_trunk(net, x, plane_heights([x], group)[0], group)


def _skip_decode(net, group, features, x):
    hs = plane_heights([*features, x], group)
    f = [_layer(getattr(net, f"trans_{i}"), features[i], hs[i], group)
         for i in range(5)]
    y = (x, hs[5])
    for i in range(4):
        y = _layer(net.Up[i], *_cat(y, f[4 - i]), group)
    return _layer(net.Up[4], *_cat(y, f[0]), group)


def _seg2(net, group, features, x):
    return _run(net.activation_seg, *_skip_decode(net, group, features, x),
                group)[0]


def _dep2(net, group, features, x):
    return torch.tanh(_skip_decode(net, group, features, x)[0])


def _skip_decode_alt(net, group, features, x):
    hs = plane_heights([*features, x], group)
    y = (x, hs[3])
    for i in range(3):
        t = _layer(net.trans[i], features[2 - i], hs[2 - i], group)
        y = _layer(net.Up[i], *_cat(y, t), group)
    return _layer(net.Up[3], *y, group)[0]


def _seg_alt(net, group, features, x):
    return torch.tanh(_skip_decode_alt(net, group, features, x))


def _dep_alt(net, group, features, x):
    return F.leaky_relu(_skip_decode_alt(net, group, features, x), 0.01)


def _drop_discriminator(net, group, x, sege=None, masks=None):
    if net.training and masks is None:
        raise ValueError("--parallel sp: DropDiscriminator's Dropout2d "
                         "takes the keep-masks it is given (masks=...)")
    h = plane_heights([x], group)[0]
    if sege is not None:
        h_e = _input_rows(sege, group)
        half = nearest_rows(sege, h_e, (h_e // 2, sege.shape[3] // 2), group)
        x, h = _cat(half, (x, h))
    for i in range(len(net.widths)):
        conv, act = net.main[3 * i:3 * i + 2]
        x, h = _layer(conv, x, h, group)
        x = act(x)
        if net.training:
            keep = masks[i].to(x.device)[:, :, None, None]
            x = torch.where(keep, x / net.KEEP, torch.zeros_like(x))
    return _layer(net.conv1, x, h, group)[0][:, 0]


def net_forwards():
    from ..models import s2d_networks as sn

    return {sn.G1: _g1, sn.GeneralNet: _general_net, sn.RDep: _rdep,
            sn.SDiscriminator: _feature_net("model"),
            sn.GeneralNet2: _general_net2, sn.SEG2: _seg2, sn.DEP2: _dep2,
            sn.DropDiscriminator: _drop_discriminator,
            sn.GBase: _sequential_net("model"),
            sn.FeatureNet: _feature_trunk, sn.SEGAlt: _seg_alt,
            sn.DEPAlt: _dep_alt}
