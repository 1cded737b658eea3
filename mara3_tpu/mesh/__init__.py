"""Block-structured AMR (maps reference layer 4: core_tree.hpp,
mesh_prolong_restrict.hpp, mesh_tree_operators.hpp).

Design (SURVEY.md §7.7): the reference's immutable pointer
quadtree of per-block arrays becomes

- a host-side static quadtree builder (tree.py): refinement predicate,
  2:1 balance, Hilbert ordering — runs once at setup (and in native C++ for
  large meshes);
- a dense device layout (block_layout.py): all leaf blocks stacked into one
  [num_blocks, bs, bs, ncomp] array plus static neighbor tables; guard-zone
  filling, prolong/restrict at level jumps, and coarse-fine flux correction
  are jit-compiled gathers with mask selection — no recursion, no pointers,
  no recompilation while the mesh is static (the reference's meshes never
  adapt during a run either).
"""
