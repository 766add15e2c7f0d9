#!/usr/bin/env bash
# Data-parallel training of the port with torchrun: one process per GPU,
# NCCL, the global batch NUM_GPUS x BATCH_SIZE_PER_GPU (tools/train.py
# --dist; parallel/mesh.py::init_distributed reads torchrun's environment).
#
# One host:
#   NUM_GPUS=8 bash findnpropagate_torch/tools/scripts/dist_train.sh \
#     --cfg_file tools/cfgs/nuscenes_models/transfusion_lidar.yaml [args]
# Several hosts (run on each; NODE_RANK 0 is the rendezvous host):
#   NUM_NODES=2 NODE_RANK=0 MASTER_ADDR=10.0.0.1 [MASTER_PORT=29500] \
#     NUM_GPUS=8 bash findnpropagate_torch/tools/scripts/dist_train.sh ...
set -e
NUM_GPUS=${NUM_GPUS:-$(nvidia-smi -L | wc -l)}
NUM_NODES=${NUM_NODES:-1}
NODE_RANK=${NODE_RANK:-0}
MASTER_ADDR=${MASTER_ADDR:-localhost}
MASTER_PORT=${MASTER_PORT:-29500}
REPO="$(cd "$(dirname "$0")/../../.." && pwd)"

PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" torchrun \
    --nnodes "$NUM_NODES" --node_rank "$NODE_RANK" \
    --nproc_per_node "$NUM_GPUS" \
    --master_addr "$MASTER_ADDR" --master_port "$MASTER_PORT" \
    -m findnpropagate_torch.tools.train --dist "$@"
