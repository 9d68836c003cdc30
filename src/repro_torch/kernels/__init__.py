"""Hand-written CUDA kernels, their plain PyTorch versions, and the tier glue.

  * ``seg_agg``            -- blocked segmented row sum (K1)
  * ``fused_agg_combine``  -- blocked segmented sum fused with ``@ W`` (K2)
  * ``flash_attention``    -- online-softmax attention for the LM (K5),
                              its backward and its autograd Function
  * ``ref``                -- the unblocked plain-torch definitions
  * ``ops``                -- blocked-layout glue and the tier switch
  * ``_build``             -- builds ``csrc/*.cu`` with nvcc at first use
"""
