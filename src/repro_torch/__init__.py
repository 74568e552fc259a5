"""PyTorch and CUDA port of the ``repro`` package (H100 target).

Same subpackage layout and names as ``repro``; imports ``torch``, numpy
and the standard library only.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
