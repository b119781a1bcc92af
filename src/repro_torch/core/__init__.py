"""Quantization core: QTensor, quantizers, RTN, block walk and packing."""
