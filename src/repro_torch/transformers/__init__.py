"""Code generation for the IR: the torch emitter table
(:mod:`.torch_emit`) and the numpy interpreter that constant folding
evaluates through (:mod:`.interpreter`)."""
