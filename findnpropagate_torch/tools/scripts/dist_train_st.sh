#!/usr/bin/env bash
# Data-parallel self-training of the port with torchrun: one process per
# GPU, NCCL. --batch_size (BATCH_SIZE_PER_GPU) is the global batch, as in
# the reference's train_st: each process loads its 1/NUM_GPUS of it, and
# extracts its shard of the pseudo labels (tools/train_st.py --dist;
# parallel/mesh.py::init_distributed reads torchrun's environment).
#
# One host:
#   NUM_GPUS=8 bash findnpropagate_torch/tools/scripts/dist_train_st.sh \
#     --cfg_file tools/cfgs/nuscenes_models/transfusion_lidar_st.yaml \
#     --batch_size 32 --pseudo_path <frustum labels> [args]
# Several hosts (run on each; NODE_RANK 0 is the rendezvous host):
#   NUM_NODES=2 NODE_RANK=0 MASTER_ADDR=10.0.0.1 [MASTER_PORT=29500] \
#     NUM_GPUS=8 bash findnpropagate_torch/tools/scripts/dist_train_st.sh ...
# Under SLURM (one task per GPU) run the module itself in each task:
#   srun --ntasks-per-node=8 --gres=gpu:8 python -m \
#     findnpropagate_torch.tools.train_st --dist --cfg_file <yaml> [args]
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
    -m findnpropagate_torch.tools.train_st --dist "$@"
