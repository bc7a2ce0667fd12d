"""Checkpointing: one structured npz per checkpoint, and mid-run resume.

The port of ``point_slam_tpu.utils.logger``. A checkpoint holds the trimmed
point buffers, the decoder parameters, both pose lists, the keyframe
bookkeeping, the exposure latents, the per-frame colour-decoder snapshots
and the random streams. Shared state goes under the JAX package's keys
(``cloud_pos``, ``geo_feats``, ``col_feats``, ``input_*``, ``pts_num``,
``*_c2w_list``, ``keyframe_*``, ``exposure_*``, ``param/<path>``,
``colsnap/<path>``, ``idx``; parameter paths are the JAX tree's, with
weights as (in, out) matrices), so either package's checkpoint restores
into the port: ``param/...`` goes through ``interop.decoders_from_numpy``.
The port's own random streams go under their own keys
(``torch_mapper_generator``, ``torch_tracker_generator``: the generators'
``get_state()``) beside the numpy ``mapper_rng``; a JAX checkpoint's
``mapper_key``/``tracker_key`` are ignored.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

GEN_KEYS = {"mapper": "torch_mapper_generator",
            "tracker": "torch_tracker_generator"}


def _jax_path(name: str) -> str:
    """A state_dict name as the JAX tree path: 'pts_linears.0.weight' ->
    'pts_linears/0/w'."""
    *head, leaf = name.split(".")
    return "/".join(head + [{"weight": "w", "bias": "b"}.get(leaf, leaf)])


def _to_jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    # nn.Linear holds W (out, in); the JAX tree holds W (in, out)
    arr = t.detach().cpu().numpy()
    return arr.T.copy() if name.endswith(".weight") else arr


def _flatten_state(state: Mapping[str, torch.Tensor], prefix: str
                   ) -> Dict[str, np.ndarray]:
    return {f"{prefix}/{_jax_path(k)}": _to_jax_layout(k, v)
            for k, v in state.items()}


def _unflatten_tree(data: Mapping[str, np.ndarray], prefix: str):
    """The nested {"geo": ..., "col": ...} tree of the ``prefix/...`` keys,
    lists where the path has indices, as the JAX package's tree."""
    tree: Dict[str, Any] = {}
    for key, arr in data.items():
        if not key.startswith(prefix + "/"):
            continue
        *head, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def save_checkpoint(path: str, slam, idx: int | None = None) -> None:
    from point_slam_tpu_torch import pointcloud as pc
    m = slam.mapper
    n = m.n_points_host
    ni = int(m.cloud.n_inputs)
    store = m.store
    dim = store.exposure_dim
    payload = {
        "cloud_pos": m.cloud.pos[:n].cpu().numpy(),
        "geo_feats": m.cloud.packed[:n, pc.GEO_SL].cpu().numpy(),
        "col_feats": m.cloud.packed[:n, pc.COL_SL].cpu().numpy(),
        "input_pos": m.cloud.input_pos[:ni].cpu().numpy(),
        "input_rgb": m.cloud.input_rgb[:ni].cpu().numpy(),
        "pts_num": np.asarray(n),
        "estimate_c2w_list": slam.estimate_c2w_list,
        "gt_c2w_list": slam.gt_c2w_list,
        "keyframe_list": np.asarray(m.keyframe_list, np.int64),
        # the store's keyframe poses: BA refinements live only there
        "keyframe_est_c2w": (np.stack(store.est_c2w) if store.est_c2w
                             else np.zeros((0, 4, 4), np.float32)),
        "keyframe_exposure": (np.stack(store.exposure) if store.exposure
                              else np.zeros((0, dim), np.float32)),
        "exposure_feat_all": (np.stack(m.exposure_feat_all)
                              if m.exposure_feat_all else np.zeros((0,))),
        "exposure_feat": np.asarray(m.exposure_feat),
        # the random streams, so a resumed run continues them
        GEN_KEYS["mapper"]: m.generator.get_state().numpy(),
        GEN_KEYS["tracker"]: slam.tracker.generator.get_state().numpy(),
        "mapper_rng": np.frombuffer(
            json.dumps(m.rng.bit_generator.state).encode(), dtype=np.uint8),
        "idx": np.asarray(len(slam.estimate_c2w_list) - 1
                          if idx is None else idx),
    }
    payload.update(_flatten_state(m.decoders.state_dict(), "param"))
    # exposure runs: the colour decoder each mapped frame was trained
    # against, stacked per leaf
    snaps = m.color_decoder_snapshots
    if snaps:
        flat = [_flatten_state(s, "colsnap") for s in snaps]
        payload.update({k: np.stack([f[k] for f in flat]) for k in flat[0]})
        payload["colsnap_n"] = np.asarray(len(snaps))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def restore_cloud_and_params(ckpt: Mapping[str, np.ndarray], mapper) -> None:
    """Repopulate a Mapper's cloud, cell table and decoders from a
    checkpoint (the mesh-from-checkpoint path). The table is rebuilt in the
    mapper's own layout (f32 planes, packed or fused), as a continuous run
    holds it."""
    from point_slam_tpu_torch import interop
    from point_slam_tpu_torch import pointcloud as pc
    dev = mapper.device
    n = int(ckpt["pts_num"])
    cap = mapper.cloud.packed.shape[0]
    while cap < n:
        cap *= 2
    if cap != mapper.cloud.packed.shape[0]:
        mapper.cloud = pc.grow_cloud(mapper.cloud, cap, mapper.ms.n_add)
    c = mapper.cloud
    ni = len(ckpt["input_pos"])
    packed = c.packed.clone()
    packed[:n, pc.GEO_SL] = torch.as_tensor(ckpt["geo_feats"], device=dev)
    packed[:n, pc.COL_SL] = torch.as_tensor(ckpt["col_feats"], device=dev)
    packed[:n, pc.POS_SL] = torch.as_tensor(ckpt["cloud_pos"], device=dev)
    input_pos, input_rgb = c.input_pos.clone(), c.input_rgb.clone()
    input_pos[:ni] = torch.as_tensor(ckpt["input_pos"], device=dev)
    input_rgb[:ni] = torch.as_tensor(ckpt["input_rgb"], device=dev)
    mapper.cloud = pc.CloudState(
        packed, torch.tensor(n, dtype=torch.long, device=dev), input_pos,
        input_rgb, torch.tensor(ni, dtype=torch.long, device=dev))
    mapper.n_points_host = n
    # the mapper's bucket-occupancy rule (Mapper._ensure_capacity)
    while mapper.table_size < cap // 8:
        mapper.table_size *= 2
    mapper.index = pc.build_index(mapper.cloud, mapper.cell_size,
                                  mapper.table_size, mapper.max_per_cell,
                                  mapper.packed_coords)
    dec = interop.decoders_from_numpy(_unflatten_tree(ckpt, "param"),
                                      mapper.cfg, dev)
    mapper.decoders.load_state_dict(dec.state_dict())
    mapper.keyframe_list = [int(i) for i in ckpt["keyframe_list"]]


def restore_color_decoder_snapshots(ckpt: Mapping[str, np.ndarray],
                                    mapper) -> None:
    """Rebuild the per-frame colour-decoder snapshot list (exposure runs)."""
    n = int(ckpt.get("colsnap_n", 0))
    if not n:
        return
    template = {k: v.detach().cpu()
                for k, v in mapper.decoders.col.state_dict().items()}
    snaps = []
    for i in range(n):
        snap = {}
        for k, t in template.items():
            arr = ckpt.get(f"colsnap/{_jax_path(k)}")
            if arr is None:
                snap[k] = t.clone()
                continue
            a = arr[i].T if k.endswith(".weight") else arr[i]
            snap[k] = torch.as_tensor(np.ascontiguousarray(a),
                                      dtype=t.dtype)
        snaps.append(snap)
    mapper.color_decoder_snapshots = snaps


def restore_slam(slam, ckpt: Mapping[str, np.ndarray]) -> int:
    """Mid-run resume: restore the cloud, decoders, pose lists, exposure
    latents, snapshots and random streams, and rebuild the keyframe store
    from the dataset. Returns the next frame index to process."""
    m = slam.mapper
    dev = m.device
    restore_cloud_and_params(ckpt, m)
    idx = int(ckpt["idx"])
    n = min(len(ckpt["estimate_c2w_list"]), slam.n_img)
    slam.estimate_c2w_list[:n] = ckpt["estimate_c2w_list"][:n]
    slam.gt_c2w_list[:n] = ckpt["gt_c2w_list"][:n]
    if ckpt["exposure_feat"].size:
        m.exposure_feat = ckpt["exposure_feat"].astype(np.float32)
    if ckpt["exposure_feat_all"].size:
        m.exposure_feat_all = list(ckpt["exposure_feat_all"].astype(
            np.float32))
    restore_color_decoder_snapshots(ckpt, m)

    # keyframe poses and exposure latents from the checkpoint's store
    # (BA refinements and per-keyframe latents live there)
    kf_poses = ckpt.get("keyframe_est_c2w")
    kf_expos = ckpt.get("keyframe_exposure")
    for slot, kf_idx in enumerate(m.keyframe_list):
        _, color, depth, _ = slam.dataset[kf_idx]
        pose = (kf_poses[slot] if kf_poses is not None
                and slot < len(kf_poses) else slam.estimate_c2w_list[kf_idx])
        expo = (kf_expos[slot] if kf_expos is not None
                and slot < len(kf_expos) else m.exposure_feat)
        m.store.append(torch.as_tensor(color, device=dev),
                       torch.as_tensor(depth, device=dev), pose, expo)

    for owner, gen in (("mapper", m.generator),
                       ("tracker", slam.tracker.generator)):
        if GEN_KEYS[owner] in ckpt:
            gen.set_state(torch.as_tensor(ckpt[GEN_KEYS[owner]]))
    if "mapper_rng" in ckpt:
        m.rng.bit_generator.state = json.loads(
            bytes(ckpt["mapper_rng"]).decode())
    return idx + 1
