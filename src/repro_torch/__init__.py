"""PyTorch/CUDA port of the reference JAX package ``repro``.

It mirrors ``repro``'s layout and names and is held against it on the
same inputs. It imports neither JAX nor ``repro``. Ported so far: the
paged-KV serving path of the decoder LM (llama3-8b, and the attention
variants of qwen2.5-32b, qwen3-32b and chatglm3-6b), over an unquantized
or a quantized KV pool (``repro_torch.core.quant``), with the two paged
decode attention kernels written in CUDA for Hopper; and the mapper for
the paper's LeNet-5 (``repro_torch.mapper``) — its forward pass and its
training step, with ``repro_torch.train.Trainer(backend="pim")`` — on the
PIM matmul and MAC kernels written in CUDA, forward and backward
(``repro_torch.kernels``). Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
