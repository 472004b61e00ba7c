// What the two interpreters of a composed scene's postfix program share:
// the node program of K1, K2, K3, K6 and K7 (composed.cuh), whose constants
// are baked, and the parameter program of K4 and K5 (param_program.cuh),
// whose instructions name parameter slots. Both come from ops/cuda/csdf.py
// (node_program, param_program) in the same order.

#pragma once

#define BSDMG_PROGRAM 64  // csdf.py PROGRAM_CAP
#define BSDMG_STACK 16    // csdf.py STACK_CAP
#define BSDMG_FRAMES 8    // csdf.py FRAME_CAP

// csdf.py OP_*
enum Op {
  OP_SPHERE,
  OP_BOX,
  OP_CAPSULE,
  OP_SKELETON,
  OP_TORUS,
  OP_CYLINDER,
  OP_PLANE,
  OP_MIN,
  OP_MAX,
  OP_SUB,
  OP_SMOOTH,
  OP_SHELL,
  OP_PUSH_TRANSFORM,
  OP_PUSH_WRAP,
  OP_POP
};
