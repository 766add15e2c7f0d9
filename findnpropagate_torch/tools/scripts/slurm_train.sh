#!/usr/bin/env bash
# SLURM launcher of the port's data-parallel training: one task per GPU,
# each task one process (tools/train.py --dist reads SLURM_NTASKS,
# SLURM_PROCID, SLURM_LOCALID and the first host of SLURM_NODELIST, port
# MASTER_PORT or 29500; parallel/mesh.py::init_distributed).
#
#   srun --ntasks-per-node=8 --gres=gpu:8 \
#     bash findnpropagate_torch/tools/scripts/slurm_train.sh \
#     --cfg_file tools/cfgs/nuscenes_models/transfusion_lidar.yaml [args]
set -e
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"
PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" \
    python -m findnpropagate_torch.tools.train --dist "$@"
