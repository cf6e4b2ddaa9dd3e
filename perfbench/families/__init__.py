"""One module a model family: its weight leaves, its plain float32 layers
for the reference, and what the yardstick counts of it.  A
configuration's ``family`` names the module; a family is added as a new
file here, and no other file of the benchmark changes for it.

The contract, each item beside what ``dense`` gives for it:

- ``leaf_specs(model)``: ``(name, shape, std)`` or ``(name, shape, std,
  dtype)`` of each weight, in the program's tree order; per-layer leaves
  are stacked on a leading axis and named ``layers.<name>``; a std of 0
  marks a norm scale, which starts at ones.  ``dtype`` names the leaf's
  storage type (``"float32"``) where it is not the configuration's
  ``param_dtype``; it is drawn, updated and kept in that type.  ``dense``:
  three-field specs, every leaf in ``param_dtype``.
- ``AUX_WEIGHT``: the weight the program's loss gives the auxiliary terms
  that ``block`` returns, summed over the layers.  ``dense``: 0.0.
- ``embed(top, tokens)``: the float32 residual stream (B, S, d_model) of
  a batch of token ids.  ``dense``: rows of ``embed``.
- ``block(model, x, lp, cast, layer)``: layer number ``layer`` (from 0)
  on the float32 stream, with ``lp`` the layer's float32 weights by their
  names under ``layers.``; returns ``(x, aux)``, ``aux`` a float32 scalar
  that carries its gradient, or None.  ``dense``: ``(x, None)``.
- ``loss(model, x, top, labels)``: the mean cross entropy of the last
  stream.  ``dense``: over the float32 head after the final norm.
- ``token_weights(model)``: the weight elements one token's products pass
  through on this chip, counted from the configuration alone (routed
  experts at ``top_k`` of all the experts: ``workcount.token_weights``).
  ``dense``: every leaf but ``embed``.
- ``attention_windows(model)``: the window of each attention layer in
  forward order, 0 for none; its length is the number of attention
  layers.  ``dense``: ``[model.get("window", 0)] * n_layers``.
"""
