#!/bin/bash
# Slurm launcher for GPU clusters: the reference's imagenet.sh
# (imagenet.sh:1-27) for the PyTorch port, one task per GPU.
#
#  * One process per card: --ntasks-per-node equals --gres=gpu:N. Rank r
#    takes cuda:$SLURM_LOCALID; a task without a card of its own is
#    refused (exit 78), never given a shared card or the CPU.
#  * Rendezvous: imagent_tpu_torch.cluster parses the same SLURM_* vars
#    the reference did (imagenet.py:225-238) and forms the NCCL group at
#    tcp://<first host of SLURM_JOB_NODELIST>:<port>; export
#    IMAGENT_COORDINATOR_PORT to move it off the default 29500 (two jobs
#    sharing a node).
#  * No NCCL transport variables are set here (the reference's
#    NCCL_P2P_DISABLE/NCCL_IB_* block, imagenet.sh:19-23): export the ones
#    your fabric needs before sbatch; srun passes the environment on.
#  * No requeue wrapper yet: a failed task ends the job.
#
# Usage: sbatch imagent_tpu_torch/launch/slurm_gpu.sh [flags...]; the
# flags are appended to the ones below, and the last occurrence wins.
# The port reads synthetic data only so far: pass --dataset synthetic.
#
#SBATCH --job-name=imagent_tpu_torch
#SBATCH --nodes=2
#SBATCH --ntasks-per-node=8
#SBATCH --gres=gpu:8
#SBATCH --cpus-per-task=10
#SBATCH --hint=nomultithread
#SBATCH --time=24:00:00
#SBATCH --output=imagent_tpu_torch_%j.out
#SBATCH --error=imagent_tpu_torch_%j.err

cd "${SLURM_SUBMIT_DIR}"

srun python -m imagent_tpu_torch \
  --backend=gpu \
  --arch=resnet50 \
  --batch-size=128 \
  --epochs=90 \
  --lr=0.1 \
  --save-model "$@"
