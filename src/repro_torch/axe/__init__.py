# The kernel DSL of the port (axe.stages, axe.program), the layout
# algebra's specs (axe.spec), graphs, propagation, solver and compiler
# (axe.graphs, axe.propagate, axe.rules, axe.solve, axe.compile), the
# fusion passes (axe.passes), the on-device tile lowering (axe.lower) and
# the solve <-> tune loop (axe.cotune).
