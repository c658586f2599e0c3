"""Serving on the card: the decoder LMs' prefill and greedy decode
(``serve_step``), and the stencil service (``stencil_service``), which
coalesces requests into one ``StencilProgram.run_batched`` launch a
sweep."""
