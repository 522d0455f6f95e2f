#!/usr/bin/env bash
# The published model variants' eval matrix through the port's eval CLI:
# the five checkpoints the reference's tools/run_eval_model.sh pins, as the
# JAX package's tools/run_eval_model.sh runs them. Run from the repo root;
# DATA_ROOT and CKPT_DIR locate the KITTI tree and the checkpoints, and any
# further arguments (for example --device cpu) go to every run.
set -e
DATA_ROOT=${DATA_ROOT:-data}
CKPT_DIR=${CKPT_DIR:-output}
EVAL="python -m epnet_tpu_torch.tools.eval"

# PointRCNN-style baseline (no LI-Fusion, no CE loss)
$EVAL --cfg_file cfgs/default.yaml --eval_mode rcnn_online \
    --data_root "$DATA_ROOT" --ckpt "$CKPT_DIR/baseline/ckpt/checkpoint_epoch_49.pth" "$@" \
    --set TRAIN.CE_WEIGHT 0.0 || true

# LI-Fusion, no CE
$EVAL --cfg_file cfgs/LI_Fusion_with_attention_use_ce_loss.yaml \
    --eval_mode rcnn_online --data_root "$DATA_ROOT" \
    --ckpt "$CKPT_DIR/li_fusion/ckpt/checkpoint_epoch_49.pth" "$@" \
    --set TRAIN.CE_WEIGHT 0.0 || true

# CE loss, no LI-Fusion
$EVAL --cfg_file cfgs/default.yaml --eval_mode rcnn_online \
    --data_root "$DATA_ROOT" --ckpt "$CKPT_DIR/ce_loss/ckpt/checkpoint_epoch_49.pth" "$@" || true

# Full EPNet (LI-Fusion + CE)
$EVAL --cfg_file cfgs/LI_Fusion_with_attention_use_ce_loss.yaml \
    --eval_mode rcnn_online --data_root "$DATA_ROOT" \
    --ckpt "$CKPT_DIR/epnet/ckpt/checkpoint_epoch_49.pth" "$@" || true

# EPNet + IoU branch
$EVAL --cfg_file cfgs/LI_Fusion_with_attention_use_ce_loss_iou_branch.yaml \
    --eval_mode rcnn_online --data_root "$DATA_ROOT" \
    --ckpt "$CKPT_DIR/epnet_iou/ckpt/checkpoint_epoch_49.pth" "$@" || true
