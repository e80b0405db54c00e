"""The model layer on PyTorch: the GPT-class LM's serving and training
paths (forward, loss, gradients, remat, bf16 compute, SGD and AdamW steps,
KV-cached generation), the MoE layer and MoE-LM, with attention through the
hand-written flash kernel, on one device or over meshes of ranks (gloo
groups under ``DeviceMesh``/DTensor: dp x tp, sp (ring, Ulysses), pp, ep,
and the SPMD GEMM/POTRF)."""
