# The kernel DSL of the port: scope-tagged stages (axe.stages) composed
# into programs (axe.program). The layout algebra, graphs and compiler
# come with later slices (ROADMAP.md, queue A6-A8).
