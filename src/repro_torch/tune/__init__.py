# Schedule objects and the stage registry (tune.schedule). The planner,
# cache and autotuner come with the tune slice (ROADMAP.md, queue A11).
