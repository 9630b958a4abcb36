#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (maniskill_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (the first failure exits non-zero; nothing is caught and ignored):
  1. card name and power limit (nvidia-smi), torch version; CUDA required.
  2. build the tiled rasterizer's two CUDA kernels from csrc/ for sm_90a
     (raster_setup.cu and raster_tiles.cu, one nvcc each, side by side).
  3. each kernel vs its plain torch version on random face sets made with
     numpy (raster_setup: table bits, validity, whole lists and counts equal;
     raster_tiles: 1/z bit-equal, seg and rgb equal on every pixel), and the
     frame end to end, dropped equal (0); one set packs a band's list past
     1,024 entries, which is walked whole; one is ragged at one env. Every
     rgb path below checks both kernels so on its last frame, times them
     against their plain versions (raster_setup against face_records +
     bin_faces, in turns) and prints their bounds from raster_work.
  4. CartpoleBalanceBenchmark-v1 (1024 envs, one 128x128 RGB camera,
     pd_joint_delta_pos), reset, 50 zero-action steps; rgb shape and content,
     finite state, kernel launches == resets + steps, dropped == 0, and the
     last state re-rendered through the plain version for 32 envs.
  5. Cartpole timings: env steps/s, kernel vs plain ms per frame.
  6. PickCube-v1 state, 4096 envs: 10 timed zero-action steps; finite state,
     contact.overflow == 0, cube z within 1 mm of 0.02 and the table's force
     on it within 2% of its weight (0.064 kg x 9.81).
  7. PickCube-v1 grasp, 4096 envs: the cube between the open fingers, the
     gripper closes; is_grasped in every env within 5 steps.
  8. PickCube-v1 rgb, 2048 envs: 10 timed steps; kernel launches == resets +
     steps, dropped == 0, the last frame of 16 envs re-rendered through the
     plain version (seg agreement >= 0.999, rgb equal), faces per band.
  9. FrankaMoveBenchmark-v1 (4096 envs) and FrankaPickCubeBenchmark-v1 (8192
     envs), state: 20 timed steps each; finite, overflow 0.
 10. PPO, PickCube-v1 state, 4096 envs, README's recipe (rollout 4, 8
     epochs, 32 minibatches), 3 iterations: loss finite, no non-finite
     params, obs or rewards; env-steps/s and rollout/update ms per
     iteration; 2 steps of one more rollout under the profiler: 0
     stream/event syncs and 0 host-to-device copies per rollout step.
 11. The repo's JAX-trained ppo_pickcube_state.pkl carried into the port and
     evaluated greedily at 4096 envs over 50 steps: success_once >= 0.85.
 12. PPO, PushCube-v1 rgb, 512 envs, README's recipe (rollout 8), 2
     iterations: the same finiteness; the raster kernel launches twice per
     rollout step (the step's frame and the masked reset's); the last frame
     of 16 envs re-rendered through the plain version (seg agreement >=
     0.999, rgb equal); 2 profiled rollout steps, as in phase 10.
 13. ppo_pushcube_rgb.pkl evaluated greedily at 512 envs over 50 steps:
     success_once >= 0.80.
 14. End-effector and joint-velocity control, PickCube-v1 state, 4096 envs:
     for each of the four pd_ee_* modes and pd_joint_vel, 10 timed
     zero-action steps, the IK's ms, launches and syncs per control step,
     and one profiled step with 0 stream/event syncs and 0 host-to-device
     copies; a constant +x command in pd_ee_delta_pos moves the TCP along +x
     (cosine >= 0.99); zero actions in pd_ee_target_delta_pose drift the TCP
     as the CPU does from the same state (16 envs, within 0.1 mm).
 15. PickCube-v1 rgb+depth+segmentation and state, 2048 envs: 16 timed steps
     each, the two envs alternating step by step, and their rate ratio (the
     median of the step pairs'); kernel launches == resets + steps, dropped
     == 0, the last frame of 16 envs re-rendered through the plain version
     (int16 depth equal, seg agreement >= 0.999, rgb equal), the cube's and
     the robot's segmentation ids present.
 16. The batched motion planner, state: StackCube-v1 at 4096 envs and the
     seven other solved tasks at 1024, in 4 processes that share the card;
     success >= the JAX package's recorded demo rate less 0.15 (LiftPegUpright:
     its own measured rate less 0.15), one host sync per move, overflow 0;
     then the planner CLI (examples/motionplanning/run.py) on StackCube-v1 at
     4096 envs alone on the card: its success line, over the same limit.
 17. The planner on StackCube-v1 rgb+depth+segmentation at 2048 envs: success
     within 0.02 of phase 16's, kernel launches == resets + steps, the last
     frame of 16 envs re-rendered as in phase 15, both cubes' ids present.
 18. PickSingleYCB-v1 state, 4096 envs (convex hull contacts, a different
     object in each env): make time and set_per_env_hulls's share, all 13
     model ids present, 20 timed zero-action steps; one profiled step with 0
     stream/event syncs and 0 host-to-device copies; contact.overflow max.
     Statics after the 20 steps: for the 11 models the JAX package holds at
     rest, the table's vertical force on the object within 2% of its weight
     and the object moved under 2 mm in every env; the two cylinder stand-ins
     rock in the JAX package too, so their envs among the first 64 (the
     states of scripts/ycb_statics.py) are held to the JAX package's CPU
     figures from those states (within 1.25x).
 19. PickSingleYCB-v1 rgb, 2048 envs (base and hand cameras over per-env
     hull meshes): 20 timed steps; kernel launches == cameras x (resets +
     steps), the last frame of 16 envs of each camera re-rendered through the
     plain version (seg agreement >= 0.999, rgb equal); kernel ms per frame
     and its bound; two envs holding different models, set to one pose, show
     different object masks.
 20. PickClutterYCB-v1 state, 1024 envs (hull-hull pairs): 20 timed steps,
     a profiled step (0 syncs, 0 host-to-device copies), the share of envs
     with contact.overflow > 0 and its max (reported; overflow is allowed);
     8 envs from the states of scripts/clutter_overflow.py: with each env's
     second object set down on its first, the narrowphase's live hull-hull
     contact rows per env equal to the JAX package's on the CPU and the
     deepest of them within 1e-5 m; after 3 steps, overflow per env equal.
 21. The seven single-robot tasks of the family's last slice (PokeCube,
     RollBall, PushT, TurnFaucet, PlugCharger, PegInsertionSide with each
     env's own peg and hole, AssemblingKits), state, 4096 envs each: make
     time, 5 timed zero-action steps, one profiled step (launches, 0
     stream/event syncs, 0 host-to-device copies), contact.overflow 0 in
     every env; the table holds PokeCube's cube, RollBall's ball and PushT's
     tee with their weight within 2%; the faucet's handle inside its limits.
 22. PegInsertionSide-v1: 8 envs from the states of
     scripts/peg_hole_contacts.py, each peg halfway into its own hole: the
     live peg-plate contact rows per env equal to the JAX package's on the
     CPU and the deepest within 1e-6 m; then rgb at 2048 envs: kernel
     launches == resets + steps, the last frame of 16 envs re-rendered
     through the plain version (seg agreement >= 0.999, rgb equal), peg and
     block in view, the kernel's ms per frame against its bound.
 23. TwoRobotPickCube-v1 and TwoRobotStackCube-v1, state, 4096 envs, dict
     zero actions: as phase 21 (5 timed steps, launches, 0 syncs, 0
     copies, overflow 0).
 24. The locomotion family (MS-Hopper*, MS-Ant*, MS-Humanoid* and their Hard
     variants; AnymalC-Reach/Spin, UnitreeGo2-Reach, UnitreeH1Stand and
     UnitreeG1Stand, loaded from URDF), state, 4096 envs each, zero actions
     in pd_joint_delta_pos: make time, 10 timed steps (5 for the Run and
     Hard variants, which share a robot with a sibling timed over 10), one
     profiled step (launches, 0 stream/event syncs, 0 host-to-device
     copies), the contact candidates and K; in every step every obs and
     reward finite and contact.overflow 0; the first 16 envs' root-link
     heights within 1e-3 m of the JAX package's CPU figures from the same
     states (scripts/locomotion_figures.json); the vertical contact force
     on the near-static robots (Ant, the humanoid, Go2, H1, G1) in a band
     of their weight in every env.
 25. AnymalC-Reach-v1 rgb, 2048 envs, its base camera mounted on the
     floating base: kernel launches == resets + steps, the last frame of
     16 envs re-rendered through the plain version (seg agreement >=
     0.999, rgb equal), the goal in view, the camera's pose equal to the
     base's pose (its FREE root's qpos) times the mount offset in every env
     after the base has moved and with every base set to a random pose, the
     kernel's ms per frame against its bound.
 26. The mobile-manipulation family, state, 4096 envs, the Fetch, zero
     actions: OpenCabinetDrawer-v1 and OpenCabinetDoor-v1 on procedural
     cabinets, then OpenCabinetDrawer-v1 on the PartNet-Mobility models of
     tests/fixtures/partnet_mobility (MS_ASSET_DIR): make time with
     _after_reconfigure's share (and set_per_env_hulls's on the PartNet
     path), 10 timed steps, one profiled step (launches, 0 stream/event
     syncs, 0 host-to-device copies), the contact candidates and K,
     overflow 0 in every env, every obs and reward finite in every step,
     every variant (model) the task allows drawn; the locked-slot
     experiment in every env (each slot set to 0.9 of its range, a locked
     one 0.05 past [0, 0]; after 20 zero-action steps locked slots within
     5e-3 of shut and active ones over 0.8 of their opening) and the
     Fetch's base joints within 1e-3 of their reset values in every env
     where the robot stays 5 mm clear of the cabinet (the reset puts it just
     behind the cabinet, a fault of the JAX package's task; the rest are
     reported).
 27. OpenCabinetDrawer-v1 rgb, 2048 envs, three cameras (base_camera and
     the Fetch's fetch_head and fetch_hand): 10 timed steps and env-steps/s
     beside ManiSkill's RTX 4090 figure (8,932 fps, a record); kernel
     launches == cameras x (resets + steps); the last frame of 16 envs of
     each camera re-rendered through the plain version (seg agreement >=
     0.999, rgb equal); the cabinet and the robot in base_camera's view in
     every env; two envs of different variants at one pose show different
     cabinet masks; after the base drives, each mounted camera on its
     link's pose times the mount (fetch_head within 1e-6); the kernel's ms
     per frame against its bound.
 28. PPO on OpenCabinetDrawer-v1 state, 1024 envs, the recipe of
     maniskill_tpu_torch/examples/baselines/ppo.py (rollout 16, 4 epochs x
     8 minibatches), 2 iterations: as phase 10, the profiled rollout cut
     to 2 of its 16 steps (the profiler takes ~5 s to read each).
 29. PPO on PushCube-v1 rgbd, 512 envs, phase 12's recipe (rollout 8, 4
     epochs x 8 minibatches), 2 iterations: as phase 12 (the profiled
     rollout cut to 2 of its 8 steps), and the policy's depth tower: the
     depth obs int16 mm, nonzero in the lower half of every frame (table and
     robot), the features finite and moved by the depth, the last frame's
     int16 depth equal to the plain re-render; the kernel's ms per frame
     against its bound.
 30. SAC on PushCube-v1 state, 128 envs, the CLI's defaults (rollout 4, ring
     512, batch 4096, utd 4): 4 warm-up and 6 learning train steps; losses,
     alpha and params finite, the actor changed; collect and update_once
     ms, env-steps/s; one profiled learning train step with 0 stream/event
     syncs and 0 host-to-device copies; the 60-step greedy evaluation's
     success; one update_once at 8 envs on the card and on the CPU from one
     host state and host draws (losses and gradients within 1e-4 relative,
     params within 2 x lr and within 1e-5 on >= 0.999 of the entries, as
     tests/test_torch_sac.py holds the JAX package).
 31. TD-MPC2 on PushCube-v1 state, 32 envs, the CLI's defaults (horizon 3,
     512 samples, 24 policy trajectories, 64 elites, 6 iterations, latent
     and mlp 512, 5 Q heads, batch 256, 2 updates, ring 1000, rollout 4):
     13 warm-up train steps (a whole episode in the ring) and 3 learning
     ones; losses and params finite, the policy changed, every planned
     action in [-1, 1]; the planner's ms per control step against its
     float32 bound (planner_flops over 67 TFLOP/s), its launches, update_once
     ms, env-steps/s; one profiled learning train step with 0 syncs and 0
     copies; one plan at 4 envs on the card and on the CPU from host
     latents and draws, action and mean within 1e-5.
 32. Recording: the planner CLI (examples/motionplanning/run.py) on
     PickCube-v1 at 1024 envs, one batch, without and with --save-traj:
     both wall times, the flush's device-to-host MB and seconds, the write
     seconds and the file's size; the port's h5 reader finds 1024 traj_
     groups, every env_states leaf of T+1 rows with row 0 equal to the
     env's reset state, the JSON's success flags equal to the planner's;
     one profiled recorded step with 0 stream/event syncs and 0
     host-to-device copies (and its launches beside the bare step's).
 33. Replay (trajectory/replay_trajectory.py) of phase 32's file to rgb at
     1024 envs with --save-traj: kernel launches == resets (make's and the
     replay's) + steps, every
     replayed episode's camera rgb uint8 (T+1, 128, 128, 3), the file's last
     frame equal to the env's, the last frame of 16 envs re-rendered through
     the plain version (seg agreement >= 0.999, rgb equal), replayed success
     agreeing with the recording in >= 0.90 of the episodes, rgb env-steps/s
     and the kernel's ms per frame against its bound; then 4 episodes by env
     states (every restored state within 1e-5 of the recording) and 4
     converted to pd_joint_delta_pos with --save-traj, their success: these
     two run in spawned processes from the moment phase 32's file exists,
     beside the rest of phases 32-34 until RLPD; the kernel's times are
     taken after they end.
 34. Learning from the files: bc.py on phase 32's file at its defaults
     (batch 1024, hidden 256, lr 3e-4), 5 epochs, the MSE falling, epochs/s
     and the eval success on 16 envs; rlpd.py (256 envs, batch 512, utd 4)
     on phase 33's converted file, 1 warm-up and 3 learning train steps,
     env-steps/s, and one profiled learning train step with 0 stream/event
     syncs and 0 host-to-device copies. The files live in a temporary
     directory that is removed at the end.
 35. Diffusion Policy (examples/baselines/diffusion_policy.py) on phase 32's
     recording at the CLI's defaults (unet 64 128 256, batch 512, 50
     diffusion steps), 3 epochs: the eps-MSE falling, epochs/s, the CLI's
     eval on 16 PickCube-v1 envs (success_once, ms per sample_chunk), and
     one more epoch profiled: 0 stream/event syncs, 0 host-to-device copies.
 36. Diffusion Policy on phase 33's frames (the kernel's re-render), 1
     epoch, then the eval with --obs-mode rgb on 16 envs through the kernel:
     kernel launches == resets (make's and the eval's) + steps, the last
     frame of the 16 envs re-rendered through the plain version (seg
     agreement >= 0.999, rgb equal), the kernel's ms per frame against its
     bound (a path of the kernels line).
 37. ACT (examples/baselines/act.py) on phase 32's recording at the CLI's
     defaults, 3 epochs, the eval with whole chunks and with
     --temporal-agg on 16 envs, one more epoch profiled (0 syncs, 0 copies).
 38. RFCL (examples/baselines/rfcl.py) at its defaults on PickCube-v1 x256
     with the repo's 24 demos: 1 warm-up and 3 learning train steps,
     env-steps/s, one learning train step profiled (0 stream/event syncs, 0
     host-to-device copies), a curriculum reset on the card restoring its
     demo's state within 1e-5; then 5 steps of the SB3 adapter
     (vector/sb3.py) at 256 envs, then 3 profiled: one device-to-host copy
     per step, the most any of them reads (the profiler loses device
     records now and then, and never adds one).
 39. The dexterity family and the taskless robots, state, zero actions, in
     a process of its own (phase 30 runs in it after them) beside phases
     14, 18, 20, 21 and the process of 23, 24 and 26:
     TriFingerRotateCubeLevel4, RotateValveLevel2,
     RotateSingleObjectInHandLevel3 and InsertFlower at 4096 envs (make
     time, 5 timed steps, one profiled step with its launches, 0
     stream/event syncs and 0 host-to-device copies, overflow 0, every
     step's obs and reward finite, success false in every env); their
     first 16 envs from one state on the card and in the port on the CPU,
     2 zero-action steps, qpos within 1e-4 and obs within 1e-3 (the
     in-hand task's cumulative angle); the Allegro touch
     forces (B, 4, 3) finite; the other 11 levels at 1024 envs, reset and
     2 steps (finite, overflow 0, success false but where TriFinger's
     levels 0, 1 and 3 drew a goal within 2 cm of the arena's centre, which
     the resting cube meets); Empty-v1 at 256 envs with
     each of the 9 robots no task uses, 3 random steps: the state finite
     and every keyframe of the robot's dof. The arm slice, in the same
     process: PickCubeSO100, PickCubeWidowXAI and SO100GraspCube (domain
     randomization on, pd_joint_target_delta_pos) at 4096 envs (make time,
     5 timed steps, one profiled step: launches, 0 syncs, 0 copies;
     overflow 0 and obs and reward finite in every step), their first 16
     envs from one state on the card and on the CPU (2 zero-action steps,
     qpos within 1e-4, obs within 1e-3, SO100GraspCube's camera mount
     handed over with the state and its pose within 1e-4 after the steps);
     SO100GraspCube's cube half sizes and frictions equal to its host
     tables in every env, and after each step every camera mount inside
     its prism with poses distinct across envs; Empty-v1 at 256 envs with
     each of the 13 arm robots in every control mode it offers, 3 random
     steps: the state finite and every keyframe of the robot's dof.
 40. RotateValveLevel2-v1 rgb, 2048 envs (per-env spoke sizes in the model,
     nominal visuals): 10 timed steps; kernel launches == resets + steps,
     dropped == 0, the last frame of 16 envs re-rendered through the plain
     version (seg agreement >= 0.999, rgb equal), the valve in view, faces
     per band and the kernel's ms per frame against its bound.
 41. SO100GraspCube-v1 rgb+segmentation, 2048 envs, the camera jittered
     every step, the greenscreen over the procedural overlay (its path does
     not exist): 10 timed steps; kernel launches == resets + steps, dropped
     == 0; the last raw frame (before the composite) of 16 envs re-rendered
     through the plain version (seg agreement >= 0.999, rgb equal); the
     composite equal to where(keep[seg], raw rgb, overlay) in every env,
     and in the first 16 from the plain version's seg; the cube and the
     robot in view in every env; the camera on its mount in every env;
     faces per band and the kernel's ms per frame against its bound.
 42. Slice 14 in state mode, in a process of its own (phase 44 runs in it
     after) beside phases 32-34 and their processes: TableTopFreeDraw,
     DrawTriangle and DrawSVG with all their 256, 300 and 500 ink dots,
     FMBAssembly1Easy, UnitreeG1PlaceAppleInBowl and UnitreeG1TransportBox
     at 4096 envs (make time, 10 timed zero-action steps, one profiled step
     with its launches, 0 stream/event syncs and 0 host-to-device copies,
     overflow 0, obs and reward finite in every step); DrawTriangle then
     takes 10 steps of an action that lays the tip on the canvas: draw_step
     advances by one per step, every written dot row is the tip's xy where
     it touches and the parked pose elsewhere, every env draws; the dots
     drawn and the reference points hit are printed. The first 16 envs of
     each task from one state on the card and in the port on the CPU, 2
     zero-action steps: qpos within 1e-5.
 43. DrawTriangle-v1 rgb, 512 envs, its own 320x240 camera and all 300 ink
     dots (the undrawn ones piled at one pose, thousands of faces in one
     band): reset + 10 steps; kernel launches == resets + steps, 0 host
     syncs in the steps, dropped == 0; the fullest band's count; the last
     frame of 16 envs re-rendered through the plain version (1/z bit-equal,
     seg and rgb equal) and of 4 envs through an unbinned per-face walk over
     the whole frame (seg equal on every pixel); the kernel's ms per frame
     against its bound with every live list entry counted.
 44. The planner's DrawTriangle solution at 256 envs from one reset, after
     phase 42 in its process: the solved share (the JAX package has no rate
     for it, so none is required), control steps, moves, one host sync per
     move, wall time.
 45. The scenes in state mode, the Fetch, zero actions, in a process of its
     own (phase 46's first and third twins run in it after) beside phases
     14, 18, 20 and 21 and their processes: SceneManipulation-v1 (ReplicaCAD) and
     ProcTHOR_SceneManipulation-v1 with build_config_idxs=[15] at 1024 envs
     (make time, 5 timed steps, one profiled step with its launches, 0
     stream/event syncs and 0 host-to-device copies, overflow 0, obs and
     reward finite in every step; their first 16 envs from one state on the
     card and in the port on the CPU, 2 zero-action steps, qpos within
     1e-5); iTHOR_, ArchitecTHOR_ and RoboTHOR_SceneManipulation-v1 at 256
     envs and PickClutterYCB-v1 with robot_uids="fetch" at 1024 (reset, 2
     steps, the same checks).
 46. The four BridgeData v2 twins (PutCarrotOnPlateInScene,
     PutEggplantInBasketScene, PutSpoonOnTableClothInScene,
     StackGreenCubeOnYellowCubeBakedTexInScene) in state mode at 1024 envs,
     500/5 Hz (100 substeps a control step), two in phase 45's process and
     two in a process of their own beside phases 32-34: make time; the
     masked reset of every env on device tensors (its 50-substep settle
     inside) under torch's sync check (0 host syncs; a blocking
     host-to-device copy trips it too; the profiler would take ~50 s to
     read the reset's ~190,000 records); every env's settled objects
     within 1 cm of a spawn config's cells and on the arena (the plate stand-in, a cylinder, falls through
     the box table, as in the JAX package: printed); a partial reset of half
     the envs: the settle leaves the other half's Data bit-equal in every
     field, the reset their state (its closing forward pass recomputes every
     env's contacts, as in the JAX package); 2 timed control steps of a
     small end-effector move with the gripper closing, under the sync check;
     5 physics substeps profiled on the step's data (a whole control step's
     ~395,000 records take the profiler ~90 s to read); overflow 0, obs
     finite, success and the statistics bool; the first 16 envs from one
     state on the card and on the CPU, 1 control step, qpos within 1e-4.
 47. SceneManipulation-v1 rgb, 1024 envs, three cameras (base_camera and the
     Fetch's fetch_head and fetch_hand): reset + 5 steps; kernel launches ==
     cameras x (resets + steps), dropped == 0; the last frame of 16 envs of
     each camera re-rendered through the plain version (seg agreement >=
     0.999, rgb equal); faces per band and the kernel's ms per frame against
     its bound per camera.
 48. PutCarrotOnPlateInScene-v1 rgb+segmentation, 512 envs, its 640x480
     camera (the calibrated intrinsic, 30 bands of 16 rows), the greenscreen
     over the procedural overlay: reset + 3 control steps; kernel launches ==
     resets + steps, 0 host syncs in the steps, dropped == 0; the last raw
     frame (before the composite) of 4 envs re-rendered through the plain
     version (1/z bit-equal, seg and rgb equal); the segmentation obs the
     kernel's and the rgb obs where(keep[seg], raw rgb, overlay) in every
     env; the carrot and the robot in view in every env; faces per env and
     per band; then the other three twins (PutEggplantInBasketScene's sink
     camera among them) at 64 envs, reset + 1 step, with the same checks.
     Its control steps are host-bound (100 substeps each), so it runs in
     phase 46's second process after that phase's twins; the kernel's ms
     per frame against its bound is taken on each cell's last frame in the
     main process after that process ends, with the card to itself.
 49. The RoboCasa kitchens in state mode, the Fetch, zero actions, in a
     process of its own (phase 51 runs in it after) beside phases 14, 18,
     20 and 21: RoboCasaKitchen-v1 (layout 0) at 1024 envs (make time, 5
     timed steps, one profiled step with its launches, 0 stream/event syncs
     and 0 host-to-device copies, overflow 0, obs and reward finite in every
     step), then RoboCasa_SceneManipulation-v1, RoboCasaOpenDrawer-v1 and
     RoboCasaPnPCounterToSink-v1 at 1024 (2 steps, the same checks); the
     first 16 envs of each from one state on the card and in the port on the
     CPU, 2 zero-action steps, qpos within 1e-5; OpenDrawer's success false
     in every env with the target drawer at half OPEN_MIN and true past it,
     PnPCounterToSink's in_basin false with the object above the basin and
     in_basin and success true with it set into the basin (the teleport
     oracles of tests/test_robocasa.py); layouts 1-4 at 64 envs, make, reset
     and 1 step each.
 50. RoboCasaKitchen-v1 rgb, 1024 envs, three cameras (base_camera, which
     sees the whole kitchen, and the Fetch's fetch_head and fetch_hand):
     reset + 5 steps; kernel launches == cameras x (resets + steps), dropped
     == 0; the last frame of 16 envs of each camera re-rendered through the
     plain version (seg agreement >= 0.999, rgb equal); faces per band and
     the kernel's ms per frame against its bound per camera.
 51. Body-body drives, after phase 49 in its process: PushCube-v1 at 4096
     envs with a world-anchored 6-dof drive on the cube (as the drag CLI
     builds it) and the arm raised out of its way, the target lifted 0.1 m,
     then moved 0.1 m in x, 5 control steps after each: the cube within 1
     cm of the target in every env; one
     profiled step (launches, 0 syncs, 0 copies); the first 16 envs from one
     state and target on the card and on the CPU, 2 steps, qpos within 1e-5;
     then both teleoperation CLIs (examples/teleoperation/drag_object.py and
     interactive_panda.py) at one env on the card, their key reader fed a
     script ending in q: the dragged object follows the keys, the Panda's
     TCP moves along x on w and up on r.
 52. A StereoDepthCamera (55 mm baseline, 8-bit disparity) on PickCube-v1 at
     2048 envs, 128x128: reset + 5 steps with an observation after each, two
     kernel launches per observation (the left eye, which also gives rgb and
     segmentation, and the right eye); the last observation's int16 depth of
     16 envs equal to the plain version's through the same stereo code, the
     occlusion shadows (foreground pixels invalidated) counted; each eye's
     kernel ms per frame against its bound.
 53. The ray-traced packs on PickCube-v1 (render/pathtracer.py, plain
     torch): rt-fast at 4 envs and 32x32 held to the CPU port from one
     state and the same draws (seg/valid agreeing on >= 0.999 of the
     pixels, the rest within 1e-4 where the 3x3 neighbourhood agrees), a
     profiled render with 0 syncs and 0 host-to-device copies; then one
     frame each of rt-fast @16, rt-med @4 and rt @1 in the 512x512 human
     camera and rt-fast @256 in the 128x128 sensor, timed with CUDA events,
     with its ray-triangle tests, bound, share and peak memory.
 54. The render modes, PickCube-v1 at 1024 envs, both cameras at 128x128:
     "rgb_array", "sensors" and "all" make 1, 1 and 2 kernel launches, "all"
     is the other two side by side, 16 envs of each camera equal to the
     plain version; in a process of its own beside phases 32-38, a
     BrowserViewer on localhost (a 512x512 JPEG part read from /stream,
     an event and the status round-tripped) and interactive_panda
     --browser at one env driven by posted events (the TCP along +x).
 55. The benchmarking CLIs: gpu_sim PickCube-v1 at 4096 envs, 20 steps,
     its CSV row printed (beside phases 32-38); bench_render at its
     defaults (its JSON line printed, on an earlier line than the last).
 56. The seven demos at one env, beside phases 32-38:
     demo_reset_distribution under rt-fast, demo_manual_control fed a key
     script, the rest at their defaults.
 57. Sim2RealEnv on the card: SO100GraspCube-v1 rgb at one env under
     FlattenRGBDObservationWrapper (rgb and state), LeRobotRealAgent over a
     stub SO100 follower (its bus tracks the commanded degrees, its camera
     serves 480x640 uint8 frames), a non-prompting reset with the data check
     on, 2 resets and 20 zero-action steps at the env's 20 Hz: one kernel
     launch per sim reset (4), none in a step; the sim qpos equal to the
     stub's within 1e-5 after every step; the real frame the stub's
     cropped and resized, on the card; _sync_sim_from_real under torch's
     sync check and profiled (0 syncs, 1 host-to-device copy); the last
     state's frame through the kernel bit-equal to the plain version, its
     ms against the bound; seconds per real step against control_dt.
 58. make_sharded_ppo_step([cuda:0], num_envs=4096) at the reference's
     PPOConfig(rollout_steps=2, update_epochs=1, num_minibatches=1): its
     "dryrun_multichip ok:" line, a train step's ms, the loss finite; the
     same trajectory through PPOTrainer's update from the same parameters,
     optimizer state and generator: the parameters equal (gap 0).
 59. The assets, beside phases 32-38 in phase 54-56's process: the
     registry's sources and groups against the port's tables (195, 10),
     download_asset of a file:// zip written here (checksum accepted) and
     of a corrupted copy (refused, nothing written), and the five URDF
     generators rewriting the port's URDFs byte for byte in a copy of
     assets/robots.
 Phase 16 also runs the planner on PickSingleYCB-v1, PegInsertionSide-v1
 and PlugCharger-v1 at 1024 envs; their limits are the JAX package's own
 rates less 0.15 (PlugCharger's is under 0, so only its syncs are checked),
 and the YCB solution syncs twice once (the grasp PCA's read and write),
 besides one sync per move.
Phases 6 and 8 time 10 steps, phase 10 runs 2 PPO iterations, phase 14
times 10 steps per mode, phase 15 16 step pairs, phases 21 and 23 5 steps
per task and phases 30-31 10 and 16 train steps, so that the whole run
stays well inside its time limit. The host-bound state paths overlap,
each launching from a process of its own while the card stays mostly idle:
after phase 15, phase 16's planner batches (4 processes), phases 23, 24
and 26 (one process), phases 39 and 30 (one process), phase 45 with
two of phase 46's twins (one process) and phases 49 and 51 (one process)
run beside phases 14, 18, 20 and 21;
then TD-MPC2
(phase 31, whose planner is device-bound), the rest of 16-17 (the planner
CLI alone on the card) and the rgb phases 19, 22, 25, 27, 40, 41, 43, 47,
50, 52, 53 and 54's render modes, whose kernel times are taken, with the
card to this process alone; in phases 32-34 the two per-episode replays,
phases 35-38, phases 42 and 44, two of phase 46's twins with phase 48,
phases 28 and 29, and phases 54-56's host-bound parts run in processes of
their own (the kernel times of phases 29, 48 and 54-56 are taken after
them). A
rate or a device time taken beside other processes says so
where it is printed: the card time-slices between the processes' contexts,
so device times read there run long.
The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches on each path, errors, times and bounds.
"""
from __future__ import annotations

import collections
import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# envs and timed steps of each path (the bench.py configurations)
CARTPOLE = ("CartpoleBalanceBenchmark-v1", 1024, 50)
PICKCUBE_STATE = ("PickCube-v1", 4096, 10)
PICKCUBE_RGB = ("PickCube-v1", 2048, 10)
PD_EE = ("PickCube-v1", 4096, 10)
EE_MODES = ("pd_ee_delta_pos", "pd_ee_delta_pose", "pd_ee_target_delta_pos", "pd_ee_target_delta_pose",
            "pd_joint_vel")
PICKCUBE_RGBD = ("PickCube-v1", 2048, 16)
RGBD_RATIO_4090 = 0.909  # rgb+depth+segmentation / state fps of ManiSkill on an RTX 4090 (BASELINE.md)
# motion planner cells: (env, envs); the limit is the JAX package's recorded
# demo success (demos/<env>/mp_<env>.json) less 0.15
# the longest first: phase 16 runs them in PLANNER_WORKERS processes that
# share the card, since each is bound by its own host's kernel launches
PLANNER = (("PlugCharger-v1", 1024), ("StackPyramid-v1", 1024), ("PickSingleYCB-v1", 1024),
           ("PegInsertionSide-v1", 1024), ("LiftPegUpright-v1", 1024),
           ("PullCubeTool-v1", 1024), ("PlaceSphere-v1", 1024), ("StackCube-v1", 4096), ("PickCube-v1", 1024),
           ("PullCube-v1", 1024), ("PushCube-v1", 1024))
PLANNER_WORKERS = 4
PLANNER_CLI = ("StackCube-v1", 4096)  # run through the CLI, alone, after the shared phase
PLANNER_RGBD = ("StackCube-v1", 2048)
# LiftPegUpright's demo json records 24/24, but the JAX package's own planner
# solves 104/128 = 0.8125 of a batch on the CPU with the f32 solver (and
# 0.7421875 with its bf16 one; scripts/planner_rates.py jax [--f32-solver]);
# its limit is that rate less 0.15
# PickSingleYCB has no recorded demos: the JAX package's planner solves 63/128
# = 0.492188 of a batch on the CPU with the f32 solver
# (scripts/planner_rates.py jax --f32-solver)
# PegInsertionSide and PlugCharger have no recorded demos: the JAX package's
# planner solves 127/128 = 0.992188 and 0/128 of a batch on the CPU with the
# f32 solver (scripts/planner_rates.py jax --f32-solver); a limit at or under
# 0 checks no rate (the phase prints it and checks the syncs)
PLANNER_REFERENCE_RATE = {"LiftPegUpright-v1": 0.8125, "PickSingleYCB-v1": 0.492188,
                          "PegInsertionSide-v1": 0.992188, "PlugCharger-v1": 0.0}
# host syncs a solution makes once, besides the one read of each move: the
# YCB grasp reads the object's pose once and copies its grasp numbers back once
PLANNER_SETUP_SYNCS = {"PickSingleYCB-v1": 2}
FRANKA = (("FrankaMoveBenchmark-v1", 4096, 20), ("FrankaPickCubeBenchmark-v1", 8192, 20))
YCB_STATE = ("PickSingleYCB-v1", 4096, 20)
YCB_RGB = ("PickSingleYCB-v1", 2048, 20)
CLUTTER = ("PickClutterYCB-v1", 1024, 20)
YCB_MODEL_COUNT = 13
# the cylinder stand-ins rock on their 16-vertex hull proxies in the JAX
# package as well: its largest relative table-force error and displacement
# (m) over their envs among 64 (scripts/ycb_statics.py jax, seed 0, 20 steps)
YCB_ROCKING = {"002_master_chef_can": (0.095749, 2.226294e-3), "005_tomato_soup_can": (0.018669, 0.627881e-3)}
YCB_ROCKING_ENVS = 64
YCB_ROCKING_SLACK = 1.25
# the JAX package's PickClutterYCB contacts from the port's seed-0 states at
# 8 envs (scripts/clutter_overflow.py jax): contact.overflow per env after 3
# zero-action steps; with each env's second object set down on its first
# (+CLUTTER_STACK_OFFSET m), the narrowphase's live hull-hull contact rows per
# env and the deepest of them (m), held within CLUTTER_DEPTH_TOL
CLUTTER_JAX_OVERFLOW = [0, 0, 0, 0, 0, 0, 0, 0]
CLUTTER_STACK_OFFSET = (0.02, 0.01, 0.06)
CLUTTER_JAX_HULL_ROWS = [48, 64, 144, 64, 64, 64, 48, 64]
CLUTTER_JAX_DEEPEST = [-0.009, 0.07601956, 0.05153158, 0.05490051, 0.05453789, 0.02, 0.06321333, 0.03838773]
CLUTTER_DEPTH_TOL = 1e-5
# phases 21-23: the rest of the tabletop family, state, zero actions
FAMILY_STATE = ("PokeCube-v1", "RollBall-v1", "PushT-v1", "TurnFaucet-v1", "PlugCharger-v1",
                "PegInsertionSide-v1", "AssemblingKits-v1")
FAMILY_ENVS, FAMILY_STEPS = 4096, 5
# the dynamic object that rests on the table from the reset on
FAMILY_RESTING = {"PokeCube-v1": "cube", "RollBall-v1": "ball", "PushT-v1": "tee"}
TWO_ROBOT = ("TwoRobotPickCube-v1", "TwoRobotStackCube-v1")
# PegInsertionSide draws each env's peg and hole from this numpy seed (the
# default draws every env's from its episode seed, all 0 when it is built)
PEG_GEOMETRY_SEED = 0
PEG_RGB = ("PegInsertionSide-v1", 2048, 10)
# the JAX package's peg-in-hole contacts from the port's seed-0 states at 8
# envs, each peg halfway into its own hole, its axis PEG_HOLE_OFFSET off the
# hole's (scripts/peg_hole_contacts.py jax): live peg-plate contact rows per
# env and the deepest of them (m), held within PEG_DEPTH_TOL
PEG_HOLE_OFFSET = (0.001, -0.002)
PEG_JAX_ROWS = [16, 16, 16, 16, 16, 16, 16, 16]
PEG_JAX_DEEPEST = [-0.001000002, -0.0010000095, -0.0010000095, -0.001000002, -0.001000002, -0.001000002,
                   -0.001000002, -0.001000002]
PEG_DEPTH_TOL = 1e-6
# phase 24: the locomotion family, state, zero actions: (env, timed steps,
# action width); the Run and Hard variants share a robot with a sibling
# timed over 10
LOCOMOTION = (("MS-HopperStand-v1", 10, 4), ("MS-HopperHop-v1", 10, 4), ("MS-AntWalk-v1", 10, 8),
              ("MS-AntRun-v1", 5, 8), ("MS-HumanoidStand-v1", 10, 21), ("MS-HumanoidWalk-v1", 10, 21),
              ("MS-HumanoidRun-v1", 5, 21), ("MS-HumanoidStandHard-v1", 5, 21), ("MS-HumanoidWalkHard-v1", 5, 21),
              ("MS-HumanoidRunHard-v1", 5, 21), ("AnymalC-Reach-v1", 10, 12), ("AnymalC-Spin-v1", 10, 12),
              ("UnitreeGo2-Reach-v1", 10, 12), ("UnitreeH1Stand-v1", 10, 19), ("UnitreeG1Stand-v1", 10, 13))
LOCOMOTION_ENVS = 4096
# the JAX package's figures on the CPU from the port's seed-0 states of the
# first 16 envs (scripts/locomotion_figures.py jax): the root link's height
# (the hopper's torso) after each zero-action step, held within
# LOCOMOTION_Z_TOL; the port's reset draws per env from a counter-based
# hash, so the first 16 of 4096 envs start from those states
LOCOMOTION_FIGURES = "scripts/locomotion_figures.json"
LOCOMOTION_FIGURE_ENVS = 16
LOCOMOTION_Z_TOL = 1e-3
# the near-static robots: the vertical contact force on the robot's links
# over its weight in every env, at each step of [first, last] (1-based), or
# its mean over them, inside [low, high] (set from their spread at 1024 envs
# on the CPU with the same seed, PERF.md section 6). HumanoidStand's random
# yaw leaves some envs still landing at step 10, so the humanoid's band is
# held in HumanoidWalk, which shares its robot and physics
LOCOMOTION_BANDS = {
    "MS-AntWalk-v1": (10, 10, False, 0.95, 1.05),
    "MS-HumanoidWalk-v1": (10, 10, False, 0.95, 1.05),
    "UnitreeGo2-Reach-v1": (3, 10, False, 0.98, 1.02),
    "UnitreeH1Stand-v1": (3, 10, True, 0.90, 1.25),
    "UnitreeG1Stand-v1": (3, 10, True, 0.90, 1.20),
}
# phase 25: AnymalC-Reach rgb, its base camera mounted on the floating base
ANYMAL_RGB = ("AnymalC-Reach-v1", 2048, 10)
# phases 26-27: the mobile-manipulation family (the Fetch, per-env articulated
# cabinets). Phase 26: (env, PartNet-Mobility cabinets or procedural), state,
# zero actions; the PartNet cells read the committed fixture's three models
CABINET_STATE = (("OpenCabinetDrawer-v1", False), ("OpenCabinetDoor-v1", False), ("OpenCabinetDrawer-v1", True))
CABINET_ENVS, CABINET_STEPS = 4096, 10
CABINET_ACTION = 13  # arm 7, gripper 1 (mimic), body 3, base 2
PARTNET_ASSET_DIR = "tests/fixtures"  # its partnet_mobility/ holds models 90001-90003
# the locked-slot experiment (tests/test_heterogeneous.py): every slot set to
# 0.9 of its own range, a locked one 0.05 past its [0, 0]; after the steps
# locked slots within LOCK_TOL of 0, active ones over HOLD_FRAC of their
# opening, and the Fetch's base joints within BASE_TOL of their reset values
CABINET_LOCK_STEPS, CABINET_LOCK_TOL, CABINET_HOLD_FRAC, CABINET_BASE_TOL = 20, 5e-3, 0.8, 1e-3
CABINET_CLEARANCE = 5e-3  # m: the robot clear of the cabinet at every step's end
CABINET_RGB = ("OpenCabinetDrawer-v1", 2048, 10)
CABINET_RGB_4090_FPS = 8932  # ManiSkill 3 on an RTX 4090 (BASELINE.md), a record and not a limit
CAMERA_MOUNT_TOL = 1e-6
# phase 28: PPO on OpenCabinetDrawer state at the recipe of
# maniskill_tpu_torch/examples/baselines/ppo.py, cut to 2 iterations
PPO_CABINET = ("OpenCabinetDrawer-v1", 1024, 16, 4, 8, 2, 2_000_000)
# the profiled rollout: the profiler takes ~5 s to read each step of ~29,000
# launches, so 2 of the 16 steps are profiled
PPO_CABINET_PROFILE_STEPS = 2
# PPO cells: README.md's recipes (env, envs, rollout steps, epochs, minibatches,
# iterations run here, total steps of the recipe for the learning-rate decay)
PPO_STATE = ("PickCube-v1", 4096, 4, 8, 32, 2, 100_000_000)
PPO_RGB = ("PushCube-v1", 512, 8, 4, 8, 2, 12_000_000)
# the profiled rollouts of phases 10 and 12: 2 of their 4 and 8 steps (the
# profiler takes ~5 s to read a step of ~25,000 launches)
PPO_STATE_PROFILE_STEPS = PPO_RGB_PROFILE_STEPS = 2
# phase 29: visual PPO on PushCube rgbd at PPO_RGB's recipe; 2 of the 8
# rollout steps profiled
PPO_RGBD = ("PushCube-v1", 512, 8, 4, 8, 2, 12_000_000)
PPO_RGBD_PROFILE_STEPS = 2
# phase 30: SAC on PushCube state at the CLI's defaults
# (maniskill_tpu_torch/examples/baselines/sac.py): (env, envs, warm-up train
# steps, learning train steps)
SAC_CELL = ("PushCube-v1", 128, 4, 6)
# phase 31: TD-MPC2 on PushCube state at the CLI's defaults
# (examples/baselines/tdmpc2.py): 13 warm-up train steps of rollout 4 put a
# whole 50-step episode in the ring, then learning steps
TDMPC2_CELL = ("PushCube-v1", 32, 13, 3)
# one update (SAC) and one plan (TD-MPC2) on the card against the CPU port
# from one host state and host draws, at these envs, held to the CPU parity
# tests' tolerances: tests/test_torch_sac.py (losses and gradients 1e-4
# relative; params within 2 x lr of each other, within 1e-5 on >= 0.999 of
# the entries) and tests/test_torch_tdmpc2.py (the plan at 1e-5)
SAC_PARITY_ENVS, TDMPC2_PARITY_ENVS = 8, 4
UPDATE_LOSS_TOL, UPDATE_PARAM_TOL, UPDATE_PARAM_SHARE = 1e-4, 1e-5, 0.999
PLAN_TOL = 1e-5
# phases 32-34: the planner CLI records PickCube @1024 (one batch); the file
# replayed to rgb at 1024 envs, success agreeing with the recording in at
# least this share of episodes (open loop: the scatter-adds need not be
# bitwise deterministic); 4 episodes replayed by env states (each restored
# state within 1e-5) and converted to pd_joint_delta_pos; BC on the recorded
# file; RLPD on the converted one: (env, warm-up, learning train steps)
RECORD_CELL = ("PickCube-v1", 1024)
RECORD_ROW0_ENVS = 1024
REPLAY_AGREE_MIN = 0.90
REPLAY_EPISODES = 4
STATE_RESTORE_TOL = 1e-5
BC_EPOCHS = 5
RLPD_CELL = ("PickCube-v1", 1, 3)
SHARED = (" (sharing the card with phase 33's two per-episode replays, phases 35-38's processes and the processes of "
          "phases 42 and 44 and of phases 46 and 48)")
# phases 14, 16, 18, 20, 21, 23, 24, 26, 30 and 39 overlap in processes of
# their own: each of these host-bound paths launches its kernels from its own
# process while the card stays mostly idle
PLANNER_SHARED = (" (beside phase 16's planner processes, the process of phases 23, 24 and 26, that of phases 39 "
                  "and 30, that of phases 45 and 46's first two twins and that of phases 49 and 51)")
SIDE_SHARED = (" (in a process of its own beside phase 16's planner processes, phases 14, 18, 20 and 21 and "
               "the processes of phases 39 and 30, of phases 45 and 46 and of phases 49 and 51)")
PLANNER_BESIDE = " (beside phases 14, 18, 20, 21, 23, 24, 26, 30, 39, 45, 46, 49 and 51)"
# phases 35-38: the last trainers, in processes of their own beside phases
# 32-34. DP and ACT train on phase 32's recording (DP's rgb leg on phase 33's
# re-rendered frames) at their CLIs' defaults for a few epochs and evaluate
# IL_EVAL_ENVS envs over the CLIs' 50 steps; RFCL runs its CLI at its
# defaults on the repo's demos: (env, envs, warm-up, learning train steps);
# then SB3_STEPS steps of the SB3 adapter at RFCL's width
DP_EPOCHS, DP_RGB_EPOCHS, ACT_EPOCHS, IL_EVAL_ENVS = 3, 1, 3, 16
IL_ENV = "PickCube-v1"
RFCL_CELL = ("PickCube-v1", 256, 1, 3)
RFCL_DEMOS = "demos/PickCube-v1/mp_PickCube-v1.h5"
SB3_STEPS = 5
SB3_PROFILES = 3
TRAINER_SHARED = (" (in a process of its own beside phases 32-34 and the processes of phases 42 and 44 and of "
                  "phases 46 and 48)")
# phase 39: the dexterity family, state, zero actions: the four timed tasks
# (env, action width) at DEX_ENVS, the other levels at DEX_LEVEL_ENVS, and
# Empty-v1 with each robot no task uses (random actions)
DEX_TIMED = (("TriFingerRotateCubeLevel4-v1", 9), ("RotateValveLevel2-v1", 9),
             ("RotateSingleObjectInHandLevel3-v1", 16), ("InsertFlower-v1", 7))
DEX_ENVS, DEX_STEPS = 4096, 5
DEX_LEVELS = (tuple((f"TriFingerRotateCubeLevel{i}-v1", 9) for i in range(4))
              + tuple((f"RotateValveLevel{i}-v1", 9) for i in (0, 1, 3, 4))
              + tuple((f"RotateSingleObjectInHandLevel{i}-v1", 16) for i in range(3)))
DEX_LEVEL_ENVS, DEX_LEVEL_STEPS = 1024, 2
# the card's first DEX_CPU_ENVS envs against the port on the CPU from one
# state, DEX_CPU_STEPS zero-action steps: qpos within DEX_CPU_QPOS_TOL, obs
# within DEX_CPU_OBS_TOL. The in-hand task's obs hold its cumulative angle, an
# arccos of a dot product near 1, where one f32 ulp below 1 is 3.45e-4 rad,
# so round-off in the dot moves it by up to that (1.1e-4 apart in the obs
# with qpos within 1e-7 on an H100 80GB HBM3 at 700 W)
DEX_CPU_ENVS, DEX_CPU_STEPS, DEX_CPU_QPOS_TOL, DEX_CPU_OBS_TOL = 16, 2, 1e-4, 1e-3
EMPTY_ROBOTS = ("floating_ability_hand_right", "floating_inspire_hand_right", "floating_inspire_hand_left",
                "fixed_inspire_hand_right", "fixed_inspire_hand_left", "xarm7", "xarm7_ability",
                "allegro_hand_right", "allegro_hand_left")
EMPTY_ENVS, EMPTY_STEPS = 256, 3
DEX_SHARED = (" (in a process of its own beside phase 16's planner processes, phases 14, 18, 20 and 21 and "
              "the processes of phases 23, 24 and 26, of phases 45 and 46 and of phases 49 and 51)")
# phase 39, the arm slice: (env, action width, control mode) at ARM_ENVS,
# SO100GraspCube with its domain randomization on, and Empty-v1 with each
# arm robot in every control mode it offers
ARM_TIMED = (("PickCubeSO100-v1", 6, "pd_joint_delta_pos"), ("PickCubeWidowXAI-v1", 7, "pd_joint_delta_pos"),
             ("SO100GraspCube-v1", 6, "pd_joint_target_delta_pos"))
ARM_ENVS, ARM_STEPS = 4096, 5
ARM_ROBOTS = ("so100", "widowxai", "widowxai_wristcam", "xarm6_nogripper", "xarm6_robotiq", "xarm6_robotiq_wristcam",
              "xarm6_nogripper_wristcam", "ur_10e", "koch-v1.1", "googlerobot", "stompy",
              "floating_robotiq_2f_85_gripper", "xlerobot")
# phase 40: RotateValveLevel2 rgb, the per-env valves through the kernel
VALVE_RGB = ("RotateValveLevel2-v1", 2048, 10)
# phase 41: SO100GraspCube rgb+segmentation through the kernel and the
# greenscreen; the overlay's path does not exist, so the task composites its
# procedural overlay
GRASP_RGB = ("SO100GraspCube-v1", 2048, 10)
GRASP_OVERLAY = "no_such_dir/so100_greenscreen.png"
PEAK_FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores (an FMA counts two)
STATE_CKPT, STATE_SUCCESS_MIN = "examples_checkpoints/ppo_pickcube_state.pkl", 0.85
RGB_CKPT, RGB_SUCCESS_MIN = "examples_checkpoints/ppo_pushcube_rgb.pkl", 0.80
# phase 42, slice 14 in state mode: (env, action width) at SLICE14_ENVS,
# SLICE14_STEPS timed zero-action steps each; the card's first DEX_CPU_ENVS
# envs against the port on the CPU from one state, DEX_CPU_STEPS steps, qpos
# within SLICE14_QPOS_TOL
SLICE14_STATE = (("TableTopFreeDraw-v1", 7), ("DrawTriangle-v1", 7), ("DrawSVG-v1", 7), ("FMBAssembly1Easy-v1", 8),
                 ("UnitreeG1PlaceAppleInBowl-v1", 25), ("UnitreeG1TransportBox-v1", 25))
SLICE14_ENVS, SLICE14_STEPS, SLICE14_QPOS_TOL = 4096, 10, 1e-5
# DrawTriangle's pd_joint_delta_pos action that pitches the shoulder forward
# and lays the stick's tip on the canvas within ~7 steps, DRAW_STEPS steps
DRAW_ACTION, DRAW_STEPS = (0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0), 10
SLICE14_SHARED = (" (in a process of its own beside phases 32-34, their processes and the process of phases 46 "
                  "and 48)")
# phase 43: DrawTriangle rgb through the kernel, its own 320x240 camera and
# every ink dot (the undrawn ones piled in one or two bands); the last frame
# of DRAW_DENSE_ENVS envs through an unbinned per-face walk
DRAW_RGB = ("DrawTriangle-v1", 512, 10)
DRAW_DENSE_ENVS = 4
# phase 44: the planner's DrawTriangle solution from one reset
DRAW_PLANNER = ("DrawTriangle-v1", 256)
# phase 45: the scenes in state mode, the Fetch (13 actions: arm 7, gripper
# 1, body 3, base 2), zero actions: (env, make kwargs) timed at SCENE_ENVS,
# the other builders at SCENE_OTHER_ENVS, PickClutterYCB with the Fetch; the
# first DEX_CPU_ENVS envs of the timed two against the CPU port
SCENE_TIMED = (("SceneManipulation-v1", {}), ("ProcTHOR_SceneManipulation-v1", {"build_config_idxs": [15]}))
SCENE_ENVS, SCENE_STEPS = 1024, 5
SCENE_OTHERS = ("iTHOR_SceneManipulation-v1", "ArchitecTHOR_SceneManipulation-v1", "RoboTHOR_SceneManipulation-v1")
SCENE_OTHER_ENVS, SCENE_OTHER_STEPS = 256, 2
CLUTTER_FETCH = ("PickClutterYCB-v1", 1024, 2)
SCENE_CPU_QPOS_TOL = 1e-5
FETCH_ACTION = 13
# phase 46: the BridgeData v2 twins in state mode on the WidowX-250S (500/5
# Hz: 100 substeps a control step, 50 more to settle in every reset); a small
# end-effector move (m, rad; the arm's action is unnormalized) with the
# gripper closing; the first DEX_CPU_ENVS envs against the CPU port over one
# control step; the plate stand-in is a cylinder, which collides with planes
# and hulls only (in both packages), so it falls through the box table
BRIDGE_TWINS = ("PutCarrotOnPlateInScene-v1", "PutEggplantInBasketScene-v1", "PutSpoonOnTableClothInScene-v1",
                "StackGreenCubeOnYellowCubeBakedTexInScene-v1")
BRIDGE_ENVS, BRIDGE_STEPS = 1024, 2
BRIDGE_ACTION = (0.005, 0.0, -0.005, 0.0, 0.0, 0.02, -1.0)
BRIDGE_CPU_STEPS, BRIDGE_CPU_QPOS_TOL = 1, 1e-4
BRIDGE_FALLS_THROUGH = ("bridge_plate_objaverse_larger",)
BRIDGE_CELL_TOL = 0.01  # m: a settled object's distance from its grid cell
# the profiler takes ~50 s to read a reset's ~190,000 records and ~90 s for a
# control step's ~395,000 (H100 80GB HBM3, 700 W), more
# than the script has room for: resets and control steps run under torch's
# sync check, and BRIDGE_PROFILE_SUBSTEPS substeps of the control step are
# profiled on its data
BRIDGE_PROFILE_SUBSTEPS = 5
# phases 45 and 46 are split over two processes: phase 45 and two twins
# beside phases 14, 18, 20 and 21, the other two twins beside phases 32-34
BRIDGE_EARLY, BRIDGE_LATE = BRIDGE_TWINS[0::2], BRIDGE_TWINS[1::2]
SCENE_SHARED = (" (in a process of its own beside phase 16's planner processes, phases 14, 18, 20 and 21 and the "
                "processes of phases 23, 24 and 26, of phases 39 and 30 and of phases 49 and 51)")
BRIDGE_SHARED = (" (in a process of its own beside phases 32-34, their processes and the process of phases 42 "
                 "and 44)")
# phase 47: SceneManipulation rgb, the base camera and the Fetch's two
SCENE_RGB = ("SceneManipulation-v1", 1024, 5)
# phase 48: the bridge twins rgb+segmentation at their 640x480 camera, in
# phase 46's second process (host-bound: ~100 substeps a control step), the
# kernel's times taken in this process after it: (env, envs, control steps);
# BRIDGE_PLAIN_ENVS envs of each through the plain version
BRIDGE_RGB_CELLS = (("PutCarrotOnPlateInScene-v1", 512, 3), ("PutEggplantInBasketScene-v1", 64, 1),
                    ("PutSpoonOnTableClothInScene-v1", 64, 1),
                    ("StackGreenCubeOnYellowCubeBakedTexInScene-v1", 64, 1))
BRIDGE_PLAIN_ENVS = 4
BRIDGE_FRAME = (480, 640)
# phase 49: the RoboCasa kitchens in state mode, the Fetch, zero actions:
# RoboCasaKitchen-v1 (layout 0) timed over ROBOCASA_TIMED's steps, the other
# three ids at its width over ROBOCASA_OTHER_STEPS, each with a profiled
# step and its first DEX_CPU_ENVS envs against the CPU port (qpos within
# ROBOCASA_CPU_QPOS_TOL); layouts 1-4 at ROBOCASA_LAYOUT_ENVS
ROBOCASA_TIMED = ("RoboCasaKitchen-v1", 1024, 5)
ROBOCASA_OTHERS = ("RoboCasa_SceneManipulation-v1", "RoboCasaOpenDrawer-v1", "RoboCasaPnPCounterToSink-v1")
ROBOCASA_OTHER_STEPS = 2
ROBOCASA_LAYOUT_ENVS = 64
ROBOCASA_CPU_QPOS_TOL = 1e-5
# phase 50: RoboCasaKitchen-v1 rgb, every camera of the env: (env, envs, steps)
KITCHEN_RGB = ("RoboCasaKitchen-v1", 1024, 5)
# phase 51: PushCube-v1 with a world-anchored drive on the cube (the drag
# CLI's gains); the target moved by each of DRAG_MOVES (m) in turn, DRAG_STEPS
# control steps after each; the cube within DRAG_TOL of the target after
# them in every env; the two teleoperation CLIs at one env fed key scripts
DRAG = ("PushCube-v1", 4096)
DRAG_MOVES = ((0.0, 0.0, 0.1), (0.1, 0.0, 0.0))
DRAG_STEPS, DRAG_TOL, DRAG_CPU_QPOS_TOL = 5, 0.01, 1e-5
DRAG_SHOULDER = -0.6  # rad: the Panda's shoulder pitched back, its TCP ~0.72 m up
DRAG_KEYS, PANDA_KEYS = "rrrrrwwwwwq", "wwwrrrq"
# phases 49 and 51 run in a process of their own beside phases 14, 18, 20
# and 21
SLICE16_SHARED = (" (in a process of its own beside phase 16's planner processes, phases 14, 18, 20 and 21 and the "
                  "processes of phases 23, 24 and 26, of phases 39 and 30 and of phases 45 and 46)")
# phase 52: a StereoDepthCamera (its 55 mm baseline, 8-bit disparity) on
# PickCube-v1 in state mode: (env, envs, steps), the image size, and the envs
# of the last observation held to the plain version through the same stereo code
STEREO = ("PickCube-v1", 2048, 5)
STEREO_SIZE = (128, 128)
STEREO_PLAIN_ENVS = 16
# phase 53: the ray-traced packs on PickCube-v1, plain torch on the card:
# (pack, envs, camera, height, width) of each timed frame, and the rt-fast
# frame (envs, height, width) held to the CPU port from one state and draws
RT_FRAMES = (("rt-fast", 16, "human", 512, 512), ("rt-med", 4, "human", 512, 512), ("rt", 1, "human", 512, 512),
             ("rt-fast", 256, "sensor", 128, 128))
RT_PLAIN = (4, 32, 32)
RT_CPU_TOL = 1e-4
# Möller-Trumbore per ray-triangle test with FMAs, what depends on the ray
# alone or the face alone hoisted: d x e2 (6), e1.h (3), 1/a (1), s.h, d.q,
# e2.q with their 1/a (12), the four range tests and the select (5)
RT_INSTR_PER_TEST = 27
# phase 54: render modes through the kernel (envs, height, width of both cameras)
RENDER_MODES = (1024, 128, 128)
# phase 55: the benchmark CLIs: gpu_sim (env, envs, steps); bench_render at
# its defaults (Cartpole rgb @1024, 60 steps)
GPU_SIM = ("PickCube-v1", 4096, 20)
BENCH_RENDER_STEPS = 60
# phase 57: Sim2RealEnv over SO100GraspCube-v1 rgb at one env (under
# FlattenRGBDObservationWrapper, rgb and state) and LeRobotRealAgent driving a
# stub SO100 follower whose bus tracks the commanded degrees and whose camera
# serves SIM2REAL_FRAME uint8 frames: (env, resets, steps) after the
# construction's data check, zero actions at the env's 20 Hz
SIM2REAL = ("SO100GraspCube-v1", 2, 20)
SIM2REAL_FRAME = (480, 640)
SIM2REAL_QPOS_TOL = 1e-5
SO100_MOTORS = ("shoulder_pan", "shoulder_lift", "elbow_flex", "wrist_flex", "wrist_roll", "gripper")
# phase 58: make_sharded_ppo_step on the one card at the reference's config
# (PPOConfig(rollout_steps=2, update_epochs=1, num_minibatches=1))
SHARDED_PPO_ENVS = 4096
# phase 59: the asset registry's sizes from the port's tables (the fixed
# sources and one per PartNet-Mobility model of the five meta files), and
# the five URDF generators, in phase 54-56's process
ASSET_SOURCES, ASSET_GROUPS = 195, 10
GENERATORS = ("ability_hand/generate.py", "inspire_hand/generate.py", "stompy/generate.py",
              "unitree_g1/generate_g1.py", "unitree_h1/generate_h1_hands.py")
# phases 54-56's host-bound parts (the viewer, gpu_sim, the demos) run in a
# process of their own beside phases 32-38
SLICE17_SHARED = (" (in a process of its own beside phases 32-34, their processes and those of phases 42 and 44, "
                  "of phases 46 and 48 and of phases 28 and 29)")
# phases 28 and 29 (PPO on OpenCabinetDrawer state and PushCube rgbd,
# host-bound) run in a process of their own beside phases 32-38; phase 29's
# kernel times are taken after them, with the card to the main process alone
PPO_LATE_SHARED = (" (in a process of its own beside phases 32-34, their processes and those of phases 42 and 44, "
                   "of phases 46 and 48 and of phases 54-56)")
SEG_AGREE_MIN = 0.999  # re-render seg agreement bound (the kernel is bit-exact: expect 1.0)
CUBE_WEIGHT = 0.064 * 9.81  # PickCube's 4 cm cube of density 1000, in N
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and FP32 instructions/s
# outside the tensor cores (the 67 TFLOP/s FP32 peak counts an FMA as two)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_INSTR_PER_S = 67e12 / 2
RASTER_INSTR_PER_TEST = 21  # per pixel-face test: 4 planes x (fmul + 2 fadd), 4 compares, 5 selects


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def random_faces(rng, B, F, H, W, band_rows=None):
    """Well-shaped random triangles (rotated, jittered equilateral) in screen
    space; ``band_rows`` packs them all into those rows to overflow a band."""
    ylo, yhi = (0, H) if band_rows is None else band_rows
    rmax = 30.0 if band_rows is None else 4.0
    cx = rng.uniform(-5, W + 5, (B, F, 1))
    cy = rng.uniform(ylo, yhi, (B, F, 1))
    r = rng.uniform(2.0, rmax, (B, F, 1))
    ang = rng.uniform(0, 2 * np.pi, (B, F, 1)) + np.array([0, 2.1, 4.2]) + rng.uniform(-0.3, 0.3, (B, F, 3))
    fx = (cx + r * np.cos(ang)).astype(np.float32)
    fy = (cy + r * np.sin(ang)).astype(np.float32)
    inv_z = rng.uniform(0.2, 2.0, (B, F, 3)).astype(np.float32)
    ok = (rng.uniform(size=(B, F)) < 0.9).astype(np.int32)
    rgb = rng.uniform(size=(B, F, 3)).astype(np.float32)
    seg = rng.integers(0, 50, F).astype(np.int32)
    return fx, fy, inv_z, ok, rgb, seg


class RasterLaunches:
    """Both raster kernels' launch counts as one. On CUDA ``rasterize_tiles``
    launches raster_setup, then raster_tiles, once per frame, so a path's two
    counts are equal: setting ``launches`` sets both (to 0 before a path, back
    after launches made to compare or to time), and reading it fails unless
    they are equal."""

    def __init__(self, tr):
        self.tr = tr

    @property
    def launches(self) -> int:
        s, k = self.tr.SETUP.launches, self.tr.KERNEL.launches
        check(s == k, f"raster_setup launched {s} times, raster_tiles {k}: not every frame went through both kernels")
        return k

    @launches.setter
    def launches(self, n: int):
        self.tr.SETUP.launches = self.tr.KERNEL.launches = n


def raster_bounds(tr, fx, idx, counts, height: int, width: int):
    """The two kernels' bounds on these inputs from ``tr.raster_work``:
    raster_setup's bytes over the card's memory rate; raster_tiles' pixel-face
    tests x RASTER_INSTR_PER_TEST over its FP32 instruction rate, or its bytes
    if longer; and the full-width count of the TPU kernel's layout (every live
    entry against every column of its band)."""
    work = tr.raster_work(fx, idx, counts, height, width)
    t_ops = work["tests"] * RASTER_INSTR_PER_TEST / PEAK_FP32_INSTR_PER_S * 1e3
    t_bytes = work["tiles_bytes"] / PEAK_BYTES_PER_S * 1e3
    t_old = work["full_width_tests"] * RASTER_INSTR_PER_TEST / PEAK_FP32_INSTR_PER_S * 1e3
    return dict(
        setup=(work["setup_bytes"] / PEAK_BYTES_PER_S * 1e3, "bytes"),
        tiles=(t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"),
        full_width_ms=max(t_old, t_bytes),
        work=work,
    )


def _bit_diff(torch, a, b) -> float:
    """Max |a - b|, and inf unless a and b are bit-equal."""
    same = torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.dtype == torch.float32 else torch.equal(a, b)
    return float((a.double() - b.double()).abs().max()) if same else float("inf")


def raster_times(tr, inputs, height: int, width: int, reps: int = 20, plain_envs=None):
    """Both kernels on one frame's ``inputs``: each checked bit-equal to its
    plain version (raster_setup to ``face_records`` + ``bin_faces`` on every
    env: table bits, validity, whole lists, counts; raster_tiles to
    ``raster_bands_ref`` on the first ``plain_envs`` envs, all by default:
    1/z bits, seg, rgb), timed with CUDA events (raster_setup and its plain
    version in turns: kernel, plain, plain, kernel; raster_bands_ref once),
    with their bounds from ``raster_bounds``. The launches made here are not main-path launches.
    Returns {"raster_setup": {...}, "raster_tiles": {...}}."""
    import torch

    from maniskill_tpu_torch.utils.timing import cuda_ms

    launches = RasterLaunches(tr)
    before = launches.launches
    B = inputs[0].shape[0]
    m = plain_envs or B

    def plain_setup():
        table, valid = tr.face_records(*inputs)
        idx, counts, _ = tr.bin_faces(inputs[0], inputs[1], valid, height, width)
        return table, valid, idx, counts

    out = tr.SETUP(*inputs, height, width)
    ref = plain_setup()
    torch.cuda.synchronize()
    for name, a, b in zip(("table", "valid", "idx", "counts"), out, ref):
        check(bool(torch.equal(a.view(torch.int32), b.view(torch.int32)) if name == "table" else torch.equal(a, b)),
              f"raster_setup {name} differs from face_records/bin_faces at {B}x{height}x{width}")
    table, _, idx, counts = out
    plain = {}

    def plain_tiles():
        plain["out"] = tr.raster_bands_ref(table[:m], idx[:m], counts[:m], height, width)

    k_out = tr.KERNEL(table, idx, counts, height, width)
    # one call of the plain version, timed cold: it takes up to seconds, and
    # a warm-up call before it would double that on every path
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain_tiles()
    end.record()
    torch.cuda.synchronize()
    p_ms = start.elapsed_time(end)
    errs = [_bit_diff(torch, a[:m], b) for a, b in zip(k_out, plain["out"])]
    check(max(errs) == 0.0, f"raster_tiles differs from raster_bands_ref at {B}x{height}x{width} "
                            f"(max |d| of 1/z, seg, rgb: {errs})")
    s_ms = cuda_ms(lambda: tr.SETUP(*inputs, height, width), reps)
    sp_ms = cuda_ms(plain_setup, max(1, reps // 2))
    sp_ms = (sp_ms + cuda_ms(plain_setup, max(1, reps // 2))) / 2
    s_ms = (s_ms + cuda_ms(lambda: tr.SETUP(*inputs, height, width), reps)) / 2
    k_ms = cuda_ms(lambda: tr.KERNEL(table, idx, counts, height, width), reps)
    km_ms = cuda_ms(lambda: tr.KERNEL(table[:m], idx[:m], counts[:m], height, width), reps) if m < B else k_ms
    launches.launches = before
    bounds = raster_bounds(tr, inputs[0], idx, counts, height, width)
    work = bounds["work"]
    (sb_ms, sb_by), (tb_ms, tb_by) = bounds["setup"], bounds["tiles"]
    return {
        "raster_setup": dict(ms=s_ms, plain_ms=sp_ms, bound_ms=sb_ms, bound_by=sb_by, bound_share=sb_ms / s_ms,
                             max_abs_err=_bit_diff(torch, out[0], ref[0])),
        "raster_tiles": dict(ms=k_ms, plain_ms=p_ms, plain_envs=m, ms_plain_envs=km_ms, bound_ms=tb_ms,
                             bound_by=tb_by, bound_share=tb_ms / k_ms, max_abs_err=max(errs),
                             tests=work["tests"], full_width_tests=work["full_width_tests"],
                             full_width_bound_ms=bounds["full_width_ms"], live_per_band=work["live"] / counts.numel(),
                             fullest_band=int(counts.max())),
    }


def print_raster_times(name: str, shape: str, times, card: str):
    """The lines ``raster_times`` gives for one path: each kernel's ms against
    its plain version's and its bound, and the full-width count of the TPU
    kernel's layout."""
    s, t = times["raster_setup"], times["raster_tiles"]
    plain = f"plain {t['plain_ms']:.3f} ms" + (f" on {t['plain_envs']} envs, where the kernel takes "
                                               f"{t['ms_plain_envs']:.4f}" if t["ms_plain_envs"] != t["ms"] else "")
    print(f"raster_tiles ({name}, {shape}): {t['ms']:.4f} ms/frame vs {plain}, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}, raster_work): {t['bound_share']:.3f} of it; bit-equal {card}")
    print(f"raster_setup ({name}, {shape}): {s['ms']:.4f} ms/frame vs plain face_records + bin_faces "
          f"{s['plain_ms']:.4f} ms (in turns), bound {s['bound_ms']:.4f} ms (bytes): {s['bound_share']:.3f} of it; "
          f"bit-equal {card}")
    print(f"raster work ({name}): {t['tests']} pixel-face tests needed, {t['full_width_tests']} at full band width "
          f"(the TPU layout's count: bound {t['full_width_bound_ms']:.4f} ms, {t['full_width_bound_ms'] / t['ms']:.3f} "
          f"of this run's kernel); {t['live_per_band']:.1f} live entries per band, fullest {t['fullest_band']}")


def rerender_check(base, cam_name, n, tr, tiled_inputs, geom_poses, rgb, name, depth=None, seg=None):
    """Re-render the current state of the first ``n`` envs through the plain
    version: rgb equal, the kernel's segmentation agreeing on at least
    SEG_AGREE_MIN of the pixels, and, where the obs holds them, the int16
    depth equal and the segmentation obs agreeing as well. Returns (inputs,
    max |depth| error of the kernel, seg agreement)."""
    import torch

    cam = base._sensors[cam_name]
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    H, W = cam.config.height, cam.config.width
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(),
                          cam.proj, H, W, lights=base.scene.lights)
    before = RasterLaunches(tr).launches
    zk, sk, rk, dk = tr.rasterize_tiles(*inputs, H, W)
    RasterLaunches(tr).launches = before  # comparison launches are not main-path launches
    zp, sp, rp, dp = tr.rasterize_tiles_ref(*[a[:n] for a in inputs[:5]], inputs[5], H, W)
    torch.cuda.synchronize()
    check(int(dk) == 0, f"{name}: dropped {int(dk)} faces")
    agree = (sk[:n] == sp).float().mean().item()
    check(agree >= SEG_AGREE_MIN, f"{name}: seg agreement {agree} < {SEG_AGREE_MIN}")
    rgb_plain = (torch.clamp(rp, 0, 1) * 255).to(torch.uint8)
    check(bool(torch.equal(rgb_plain, rgb[:n])), f"{name}: rgb obs differs from the plain re-render")
    valid = sp >= 0
    if depth is not None:  # the camera's int16 millimetres, background 0
        want = torch.clamp(torch.where(valid, zp, 0.0) * 1000.0, 0, 32767).to(torch.int16)
        differ = int((want != depth[:n, ..., 0]).sum())
        check(differ == 0, f"{name}: int16 depth differs from the plain re-render on {differ} px")
    if seg is not None:
        seg_agree = (torch.where(valid, sp, 0).to(torch.int16) == seg[:n, ..., 0]).float().mean().item()
        check(seg_agree >= SEG_AGREE_MIN, f"{name}: segmentation obs agreement {seg_agree} < {SEG_AGREE_MIN}")
        agree = min(agree, seg_agree)
    return inputs, (zk[:n] - zp).abs().max().item(), agree


def ppo_phase(torch, dev, make, card, obs_mode, cell, kernel, profile_steps=None):
    """PPO iterations on one cell through ``PPOTrainer``: checks finiteness,
    times rollout and update (CUDA-synchronized), profiles one more rollout
    (of ``profile_steps`` control steps, the whole rollout by default) for
    host syncs and copies, and counts the raster kernel's launches in the
    timed iterations when given the kernel. Returns (env, trainer, last obs,
    kernel launches or None)."""

    from maniskill_tpu_torch.parallel.train import PPOConfig, PPOTrainer
    from maniskill_tpu_torch.utils.timing import profile_calls

    uid, n_envs, rollout, epochs, minibatches, iters, total_steps = cell
    name = f"ppo {obs_mode} {uid} x{n_envs}"
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode=obs_mode, device=dev)
    obs, _ = env.reset(seed=1)
    config = PPOConfig(rollout_steps=rollout, update_epochs=epochs, num_minibatches=minibatches)
    trainer = PPOTrainer(env, config, obs, seed=1, total_updates=total_steps // (n_envs * rollout))
    obs = trainer.obs_tf(obs)
    elapsed = torch.zeros(n_envs, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    print(f"{name}: env and trainer built in {time.perf_counter() - t0:.2f} s {card}")
    if kernel is not None:
        kernel.launches = 0
    roll_ms, upd_ms = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        obs, elapsed, traj = trainer.rollout(obs, elapsed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = trainer.update(obs, traj)
        torch.cuda.synchronize()
        roll_ms.append((t1 - t0) * 1e3)
        upd_ms.append((time.perf_counter() - t1) * 1e3)
        m = {k: float(v) for k, v in metrics.items()}
        check(np.isfinite(m["loss"]), f"{name}: loss {m['loss']}")
        for k in ("bad_params", "bad_obs", "bad_rewards"):
            check(m[k] == 0, f"{name}: {k} = {m[k]}")
        print(f"{name}: loss {m['loss']:.4f} mean_reward {m['mean_reward']:.4f} "
              f"ep_success {m['ep_success']:.3f} max_adv {m['max_adv']:.3g} {card}")
    launches = None
    if kernel is not None:
        launches, want = kernel.launches, 2 * rollout * iters
        check(launches == want, f"{name}: raster kernel launches {launches} != {want} "
                                "(a frame per step and per masked reset)")
    total_s = (sum(roll_ms) + sum(upd_ms)) / 1e3
    print(f"{name} rate: {n_envs * rollout * iters / total_s:.1f} env-steps/s end to end "
          f"({iters} iterations: rollout {', '.join(f'{t:.1f}' for t in roll_ms)} ms, "
          f"update {', '.join(f'{t:.1f}' for t in upd_ms)} ms; {epochs} epochs x {minibatches} "
          f"minibatches) {card}")
    out = []
    n_prof, config = profile_steps or rollout, trainer.config
    trainer.config = config._replace(rollout_steps=n_prof)
    try:
        _, prof = profile_calls(lambda: out.append(trainer.rollout(obs, elapsed)), 1)
    finally:
        trainer.config = config
    obs = out[0][0]
    per_step = {k: prof[k] / n_prof for k in ("launches", "syncs", "h2d_copies", "device_kernel_ms", "wall_ms")}
    print(f"{name} rollout profile per control step ({n_prof} steps): {per_step['launches']:.0f} launches, "
          f"{per_step['syncs']:.2f} stream/event syncs, {per_step['h2d_copies']:.2f} host-to-device copies, "
          f"device kernels {per_step['device_kernel_ms']:.3f} ms of {per_step['wall_ms']:.3f} ms "
          f"(idle {prof['device_idle_share']:.3f}) {card}")
    check(per_step["syncs"] == 0, f"{name}: the rollout syncs with the device")
    check(per_step["h2d_copies"] == 0, f"{name}: the rollout copies host to device")
    return env, trainer, obs, launches


def evaluate_checkpoint(torch, env, trainer, path, success_min, card):
    """The JAX package's pickled checkpoint carried into the trainer's model
    and evaluated greedily (50 steps, success once)."""
    from maniskill_tpu_torch.parallel.train import evaluate, load_jax_checkpoint, params_from_flax

    base = env.unwrapped
    trainer.model.load_state_dict(params_from_flax(load_jax_checkpoint(path)))
    t0 = time.perf_counter()
    success = evaluate(env, trainer.model, stochastic=False, seed=123)
    rate = float(success.float().mean())
    torch.cuda.synchronize()
    print(f"{path} on {base.uid} x{base.num_envs}: greedy success_once {rate:.6f} "
          f"({int(success.sum())}/{base.num_envs}) over 50 steps in {time.perf_counter() - t0:.2f} s {card}")
    check(rate >= success_min, f"{path}: greedy success_once {rate:.4f} < {success_min}")


def _first_envs(x, n, device):
    """The first ``n`` envs of a state tree, on ``device``."""
    if isinstance(x, dict):
        return {k: _first_envs(v, n, device) for k, v in x.items()}
    return x[:n].to(device)


def ee_control_phase(torch, dev, make, card):
    """Phase 14: the end-effector and joint-velocity modes at 4096 envs."""
    from maniskill_tpu_torch.utils.timing import cuda_ms, profile_calls, timed_steps

    uid, n_envs, n_steps = PD_EE
    rates = {}
    for mode in EE_MODES:
        t0 = time.perf_counter()
        env = make(uid, num_envs=n_envs, obs_mode="state", control_mode=mode, device=dev)
        base = env.unwrapped
        zero = torch.zeros((n_envs,) + tuple(env.single_action_space.shape), device=dev)
        env.reset(seed=0)
        env.step(zero)  # builds the lazy tables (the arm's kinematics, contact signs)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        tcp0 = base.agent.tcp.pose.p.clone()
        state0 = base.get_state_dict()
        step_s = timed_steps(env, zero, n_steps)
        drift = (base.agent.tcp.pose.p - tcp0).norm(dim=-1)
        data = base.scene.data
        check(bool(torch.isfinite(data.qpos).all() & torch.isfinite(data.qvel).all()), f"{mode}: state not finite")
        check(int(data.contact.overflow.max()) == 0, f"{mode}: contact overflow")
        arm = base.agent.controller.controllers["arm"]
        arm_zero = zero[:, :-1]
        ctrl_ms = cuda_ms(lambda: arm.set_action(arm_zero), 5)
        _, ctrl = profile_calls(lambda: arm.set_action(arm_zero), 1)
        _, prof = profile_calls(lambda: env.step(zero), 1)
        check(prof["syncs"] == 0, f"{mode}: {prof['syncs']} stream/event syncs in a control step")
        check(prof["h2d_copies"] == 0, f"{mode}: {prof['h2d_copies']} host-to-device copies in a control step")
        rates[mode] = n_envs * n_steps / step_s
        print(f"{mode} {uid} x{n_envs}: built and warmed up in {built_s:.2f} s; {rates[mode]:.1f} env-steps/s "
              f"({step_s / n_steps * 1e3:.2f} ms/step, eager); arm controller (IK for pd_ee_*) "
              f"{ctrl_ms:.3f} ms, {ctrl['launches']:.0f} launches, {ctrl['syncs']:.0f} syncs per control step; "
              f"step profile {prof['launches']:.0f} launches, {prof['syncs']:.0f} stream/event syncs, "
              f"{prof['h2d_copies']:.0f} host-to-device copies, device kernels {prof['device_kernel_ms']:.3f} ms "
              f"of {prof['wall_ms']:.3f} ms (idle {prof['device_idle_share']:.3f}); TCP drift over "
              f"{n_steps} zero-action steps: max {float(drift.max()) * 1e3:.3f} mm, mean "
              f"{float(drift.mean()) * 1e3:.3f} mm {card}")
        if mode == "pd_ee_delta_pos":
            cmd = zero.clone()
            cmd[:, 0] = 0.3  # 3 cm per step along the root's +x
            p0 = base.agent.tcp.pose.p.clone()
            for _ in range(5):
                env.step(cmd)
            d = base.agent.tcp.pose.p - p0
            cos = d[:, 0] / d.norm(dim=-1).clamp(min=1e-9)
            check(float(cos.min()) >= 0.99, f"{mode}: +x command moved the TCP off +x (cosine {float(cos.min()):.4f})")
            print(f"{mode}: 5 steps of +3 cm x moved the TCP {float(d[:, 0].mean()) * 1e3:.2f} mm along x "
                  f"(mean), cosine to the command min {float(cos.min()):.6f} {card}")
        if mode == "pd_ee_target_delta_pose":
            # the same 16 envs from the same state on the CPU: the card drifts
            # as the CPU does (the zero-action drift is the reference's own)
            n = 16
            cpu = make(uid, num_envs=n, obs_mode="state", control_mode=mode, device="cpu")
            sub = _first_envs(state0, n, "cpu")
            cpu.reset(seed=0)
            cpu.unwrapped.set_state_dict(sub)  # after the reset, which sets the targets to qpos
            for _ in range(n_steps):
                cpu.step(torch.zeros(n, zero.shape[1]))
            cpu_drift = (cpu.unwrapped.agent.tcp.pose.p - tcp0[:n].cpu()).norm(dim=-1)
            gap = float((drift[:n].cpu() - cpu_drift).abs().max())
            check(gap <= 1e-4, f"{mode}: zero-action TCP drift differs from the CPU's by {gap:.2e} m")
            print(f"{mode}: zero-action TCP drift of 16 envs matches the CPU's within {gap:.2e} m "
                  f"(max {float(cpu_drift.max()) * 1e3:.3f} mm on the CPU) {card}")
        del env, base, data
    return rates


def rgbd_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 15: PickCube rgb+depth+segmentation against state at 2048 envs.
    The two envs take turns step by step (in the order AB BA AB ...), each
    step timed alone, so that the host's drift within the call falls on both
    alike; the ratio is the median of the pairs' (10-step blocks read
    0.91-1.11 within one call on an H100). Returns the kernel's max depth
    error against the plain version."""
    import statistics

    from maniskill_tpu_torch.utils.timing import timed_steps

    uid, n_envs, n_steps = PICKCUBE_RGBD
    kernel = RasterLaunches(tr)
    modes = ("state", "rgb+depth+segmentation")
    envs = {}
    action = torch.zeros(n_envs, 8, device=dev)
    for obs_mode in modes:
        env = make(uid, num_envs=n_envs, obs_mode=obs_mode, control_mode="pd_joint_delta_pos", device=dev)
        env.reset(seed=0)
        for _ in range(3):
            env.step(action)
        envs[obs_mode] = env
    kernel.launches = 0
    for env in envs.values():
        env.reset(seed=0)
    step_s = {m: [] for m in modes}
    for i in range(n_steps):
        for obs_mode in modes if i % 2 == 0 else modes[::-1]:
            step_s[obs_mode].append(timed_steps(envs[obs_mode], action, 1))
    launches = kernel.launches
    pair_ratios = [state / rgbd for state, rgbd in zip(step_s["state"], step_s["rgb+depth+segmentation"])]
    ratio = statistics.median(pair_ratios)
    for obs_mode in modes:
        base = envs[obs_mode].unwrapped
        q1, med, q3 = statistics.quantiles(step_s[obs_mode], n=4)
        print(f"pickcube {obs_mode} x{n_envs}: {n_envs * n_steps / sum(step_s[obs_mode]):.1f} env-steps/s "
              f"({sum(step_s[obs_mode]) / n_steps * 1e3:.2f} ms/step, eager; median step {med * 1e3:.2f} ms, "
              f"quartiles {q1 * 1e3:.2f}-{q3 * 1e3:.2f} ms) {card}")
        check(int(base.scene.data.contact.overflow.max()) == 0, f"pickcube {obs_mode}: contact overflow")
    base = envs.pop("rgb+depth+segmentation").unwrapped
    del envs
    check(launches == 1 + n_steps, f"pickcube rgbd kernel launches {launches} != resets + steps {1 + n_steps}")
    obs = base.get_obs()
    cam = obs["sensor_data"]["base_camera"]
    seg = cam["segmentation"]
    robot_ids = torch.tensor([link.per_scene_id for link in base.agent.robot.links], device=dev)
    check(bool((seg == base.cube.per_scene_id).any()), "pickcube rgbd: the cube's segmentation id is in no frame")
    check(bool(torch.isin(seg, robot_ids).any()), "pickcube rgbd: no robot link's segmentation id is in any frame")
    inputs, err, agree = rerender_check(base, "base_camera", 16, tr, tiled_inputs, geom_poses, cam["rgb"],
                                        "pickcube rgbd", depth=cam["depth"], seg=seg)
    times = raster_times(tr, inputs, 128, 128, 20)
    paths[f"pickcube_rgbd_seg_{n_envs}"] = dict(launches=launches, **times)
    print(f"pickcube rgbd: {n_steps} steps x {n_envs} envs, kernel launches {launches}, dropped 0, last frame "
          f"of 16 envs re-rendered: int16 depth equal, seg agreement {agree:.6f} (bound {SEG_AGREE_MIN}), "
          f"rgb equal; the cube's and the robot's ids present {card}")
    q1, _, q3 = statistics.quantiles(pair_ratios, n=4)
    print(f"pickcube rgb+depth+segmentation / state rate ratio @{n_envs}: {ratio:.4f}, the median of "
          f"{len(pair_ratios)} alternating step pairs (quartiles {q1:.4f}-{q3:.4f}, ratio of the sums "
          f"{sum(step_s['state']) / sum(step_s['rgb+depth+segmentation']):.4f}; ManiSkill on an RTX 4090: "
          f"{RGBD_RATIO_4090}, for comparison) {card}")
    print_raster_times("pickcube rgbd", f"{n_envs}x128x128", times, card)
    return err


def recorded_rate(uid: str) -> float:
    """The demo success recorded for ``uid``."""
    with open(f"demos/{uid}/mp_{uid}.json") as f:
        episodes = json.load(f)["episodes"]
    return sum(e["success"] for e in episodes) / len(episodes)


def planner_state_worker(uid: str, n_envs: int, card: str) -> float:
    """Phase 16's batch of one task in a process of its own: its success
    rate (the checks of ``planner_run`` end the process on a failure)."""
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    note = f"{card} (one of {PLANNER_WORKERS} planner processes sharing the card){PLANNER_BESIDE}"
    return planner_run(torch, torch.device("cuda"), make, note, uid, n_envs, "state", seed=0)[1]


def planner_run(torch, dev, make, card, uid, n_envs, obs_mode, seed, kernel=None):
    """One batch of the scripted solution: (env, success rate). Host syncs
    are counted with torch's sync debug mode, and the kernel's launches
    from the batch's reset on, when given the kernel."""
    from maniskill_tpu_torch.examples.motionplanning.panda_solver import PandaMotionPlanningSolver
    from maniskill_tpu_torch.examples.motionplanning.solutions import SOLUTIONS

    env = make(uid, num_envs=n_envs, obs_mode=obs_mode, control_mode="pd_joint_pos", device=dev)
    base = env.unwrapped
    # one-time tables (the arm's kinematics, the contact queries' signs) are
    # copied to the device before the count: a solver, one step, a reset
    PandaMotionPlanningSolver(env)
    env.reset(seed=seed)
    env.step(torch.zeros((n_envs,) + tuple(env.single_action_space.shape), device=dev))
    if kernel is not None:
        kernel.launches = 0
    env.reset(seed=seed)
    torch.cuda.synchronize()
    PandaMotionPlanningSolver.moves = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            info = SOLUTIONS[uid](env)[-1]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sites = collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                if "called a synchronizing CUDA operation" in str(w.message))
    syncs = sum(sites.values())
    moves = PandaMotionPlanningSolver.moves
    steps = int(base.elapsed_steps[0])
    rate = float(info["success"].float().mean())
    check(int(base.scene.data.contact.overflow.max()) == 0, f"planner {uid}: contact overflow")
    print(f"planner {uid} {obs_mode} x{n_envs}: success {rate:.6f} ({int(info['success'].sum())}/{n_envs}), "
          f"{steps} control steps, {moves} moves, {syncs} host syncs, {wall:.2f} s, "
          f"{n_envs * steps / wall:.1f} env-steps/s {card}")
    want = moves + PLANNER_SETUP_SYNCS.get(uid, 0)
    check(syncs == want, f"planner {uid}: {syncs} host syncs in {moves} moves ({want} expected: one per move "
                         f"and the solution's {PLANNER_SETUP_SYNCS.get(uid, 0)} once), at {dict(sites)}")
    return env, rate


def _line_buffered():
    """A worker process's stdout written line by line, so that lines from
    several processes do not interleave."""
    sys.stdout.reconfigure(line_buffering=True)


def spawn_pool(workers: int):
    """A pool of ``workers`` spawned processes, each writing line by line."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"), initializer=_line_buffered)


def planner_pool_start(card):
    """Phase 16's batches, started in PLANNER_WORKERS processes. Returns
    (the pool, the futures by task, the start time, the list their end
    times go to)."""
    pool, ends = spawn_pool(PLANNER_WORKERS), []
    futures = {uid: pool.submit(planner_state_worker, uid, n_envs, card) for uid, n_envs in PLANNER}
    for f in futures.values():
        f.add_done_callback(lambda _: ends.append(time.perf_counter()))
    return pool, futures, time.perf_counter(), ends


def planner_phases(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths, started):
    """Phases 16-17 once ``planner_pool_start``'s batches end. Returns the
    kernel's max depth error on the planner's rgb path."""
    pool, futures, t0, ends = started
    try:
        rates = {uid: f.result() for uid, f in futures.items()}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(f"planner state: {len(PLANNER)} tasks in {PLANNER_WORKERS} processes in {max(ends) - t0:.2f} s "
          f"{card}{PLANNER_BESIDE}")
    limits = {uid: (PLANNER_REFERENCE_RATE[uid] if uid in PLANNER_REFERENCE_RATE else recorded_rate(uid)) - 0.15
              for uid, _ in PLANNER}
    for uid, _ in PLANNER:
        if limits[uid] <= 0:
            print(f"planner {uid}: success {rates[uid]:.6f}; its limit {limits[uid]:.6f} is at or under 0, so only "
                  f"its syncs are checked {card}")
            continue
        check(rates[uid] >= limits[uid], f"planner {uid}: success {rates[uid]:.4f} < {limits[uid]:.4f}")
    # the CLI a user runs, alone on the card: one batch of StackCube @4096
    uid, n_envs = PLANNER_CLI
    cmd = [sys.executable, "-m", "maniskill_tpu_torch.examples.motionplanning.run", "--env-id", uid,
           "--num-envs", str(n_envs)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"planner CLI exited {out.returncode}: {out.stderr[-2000:]}")
    m = re.search(rf"{uid} batch 0: success ([0-9.]+) \((\d+)/{n_envs} cumulative\) in ([0-9.]+) s, "
                  r"(\d+) control steps, ([0-9.]+) env-steps/s", out.stdout)
    check(m is not None, f"planner CLI printed no success line: {out.stdout[-2000:]}")
    cli_rate = int(m.group(2)) / n_envs
    check(cli_rate >= limits[uid], f"planner CLI {uid}: success {cli_rate:.4f} < {limits[uid]:.4f}")
    print(f"planner CLI ({' '.join(cmd[1:])}), alone on the card: {m.group(0)}; phase 16's batch of the same "
          f"seed {rates[uid]:.6f} {card}")
    uid, n_envs = PLANNER_RGBD
    kernel = RasterLaunches(tr)
    env, rate = planner_run(torch, dev, make, card, uid, n_envs, "rgb+depth+segmentation", seed=1, kernel=kernel)
    base = env.unwrapped
    launches = kernel.launches
    steps = int(base.elapsed_steps[0])
    check(launches == 1 + steps, f"planner rgbd kernel launches {launches} != resets + steps {1 + steps}")
    check(rate >= rates[uid] - 0.02, f"planner rgbd {uid}: success {rate:.4f} < state's {rates[uid]:.4f} - 0.02")
    cam = base.get_obs()["sensor_data"]["base_camera"]
    for name in ("cubeA", "cubeB"):
        sid = base.scene.actors[name].per_scene_id
        check(bool((cam["segmentation"] == sid).any()), f"planner rgbd: {name}'s segmentation id is in no frame")
    inputs, err, agree = rerender_check(base, "base_camera", 16, tr, tiled_inputs, geom_poses, cam["rgb"],
                                        "planner rgbd", depth=cam["depth"], seg=cam["segmentation"])
    times = raster_times(tr, inputs, 128, 128, 20)
    paths[f"planner_stackcube_rgbd_seg_{n_envs}"] = dict(launches=launches, **times)
    print(f"planner rgbd {uid} x{n_envs}: kernel launches {launches} == resets + steps, last frame of 16 envs "
          f"re-rendered: int16 depth equal, seg agreement {agree:.6f}, rgb equal; both cubes' ids present; "
          f"success {rate:.6f} vs state {rates[uid]:.6f} {card}")
    print_raster_times("planner stackcube rgbd", f"{n_envs}x128x128", times, card)
    return err


def ycb_state_phase(torch, dev, make, card):
    """Phase 18: PickSingleYCB-v1 state at 4096 envs."""
    from maniskill_tpu_torch.envs.scene import ManiSkillScene
    from maniskill_tpu_torch.utils.timing import profile_calls, timed_steps

    uid, n_envs, n_steps = YCB_STATE
    hull_s = []
    set_hulls = ManiSkillScene.set_per_env_hulls

    def timed_set_hulls(self, *args, **kwargs):
        t0 = time.perf_counter()
        set_hulls(self, *args, **kwargs)
        torch.cuda.synchronize()
        hull_s.append(time.perf_counter() - t0)

    ManiSkillScene.set_per_env_hulls = timed_set_hulls
    try:
        t0 = time.perf_counter()
        env = make(uid, num_envs=n_envs, obs_mode="state", control_mode="pd_joint_delta_pos", device=dev)
        torch.cuda.synchronize()
        make_s = time.perf_counter() - t0
    finally:
        ManiSkillScene.set_per_env_hulls = set_hulls
    base = env.unwrapped
    model_ids = np.asarray(base.model_ids)
    n_models = len(np.unique(model_ids))
    print(f"{uid} x{n_envs}: make {make_s:.2f} s, of which set_per_env_hulls {sum(hull_s):.3f} s; "
          f"{n_models} distinct model ids {card}")
    check(n_models == YCB_MODEL_COUNT, f"{uid}: {n_models} model ids of {YCB_MODEL_COUNT} present")
    zero = torch.zeros(n_envs, 8, device=dev)
    env.reset(seed=0)
    env.step(zero)  # builds the lazy tables (contact signs)
    env.reset(seed=0)
    p0 = base.obj.pose.p.clone()
    step_s = timed_steps(env, zero, n_steps)
    data = base.scene.data
    check(bool(torch.isfinite(data.qpos).all() & torch.isfinite(data.qvel).all()), f"{uid}: state not finite")
    overflow = int(data.contact.overflow.max())
    force = base.scene.get_pairwise_contact_forces(base.table_scene.table, base.obj)[:, 2]
    weight = base.scene.model.body_mass[:, base.obj.body_id] * 9.81
    rel = ((force - weight).abs() / weight).cpu().numpy()
    moved = (base.obj.pose.p - p0).norm(dim=-1).cpu().numpy()
    for mid in np.unique(model_ids):
        sel = model_ids == mid
        print(f"  {mid} in {int(sel.sum())} envs: table force vs weight rel err max {rel[sel].max():.6f}, "
              f"displacement max {moved[sel].max() * 1e3:.4f} mm")
        if mid in YCB_ROCKING:
            ref_rel, ref_moved = YCB_ROCKING[mid]
            first = sel & (np.arange(n_envs) < YCB_ROCKING_ENVS)
            check(rel[first].max() <= YCB_ROCKING_SLACK * ref_rel and
                  moved[first].max() <= YCB_ROCKING_SLACK * ref_moved,
                  f"{uid} statics: {mid} in the first {YCB_ROCKING_ENVS} envs: rel err {rel[first].max():.6f}, "
                  f"displacement {moved[first].max() * 1e3:.4f} mm against the JAX package's {ref_rel:.6f}, "
                  f"{ref_moved * 1e3:.4f} mm (x{YCB_ROCKING_SLACK})")
        else:
            check(rel[sel].max() <= 0.02, f"{uid} statics: {mid}: table force off its weight by {rel[sel].max():.4f}")
            check(moved[sel].max() <= 2e-3, f"{uid} statics: {mid} moved {moved[sel].max() * 1e3:.3f} mm")
    n_cand, k = len(data.contact.geom1), base.scene.model.max_active_contacts
    k_rows = k if 0 < k < n_cand else f"{n_cand} (every candidate)"
    _, prof = profile_calls(lambda: env.step(zero), 1)
    check(prof["syncs"] == 0, f"{uid}: {prof['syncs']} stream/event syncs in a step")
    check(prof["h2d_copies"] == 0, f"{uid}: {prof['h2d_copies']} host-to-device copies in a step")
    print(f"{uid} state x{n_envs}: {n_envs * n_steps / step_s:.1f} env-steps/s ({step_s / n_steps * 1e3:.2f} "
          f"ms/step, eager); step profile {prof['launches']:.0f} launches, {prof['syncs']:.0f} stream/event "
          f"syncs, {prof['h2d_copies']:.0f} host-to-device copies, device kernels {prof['device_kernel_ms']:.3f} "
          f"ms of {prof['wall_ms']:.3f} ms (idle {prof['device_idle_share']:.3f}); contact.overflow max "
          f"{overflow}; statics held {card}")
    top = ", ".join(f"{k} {v:.3f}" for k, v in list(prof["top_kernels_ms"].items())[:5])
    print(f"  top device kernels (ms per step): {top}")


def ycb_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 19: PickSingleYCB-v1 rgb at 2048 envs. Returns the kernel's max
    depth error against the plain version."""
    from maniskill_tpu_torch.utils.timing import cuda_ms, timed_steps

    uid, n_envs, n_steps = YCB_RGB
    kernel = RasterLaunches(tr)
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb", control_mode="pd_joint_delta_pos", device=dev)
    base = env.unwrapped
    zero = torch.zeros(n_envs, 8, device=dev)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    print(f"{uid} rgb x{n_envs}: built and warmed up in {time.perf_counter() - t0:.2f} s")
    cams = list(base._sensors)
    kernel.launches = 0
    obs, _ = env.reset(seed=0)
    step_s = timed_steps(env, zero, n_steps - 1)
    obs, *_ = env.step(zero)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == len(cams) * (1 + n_steps),
          f"{uid} rgb: kernel launches {launches} != cameras x (resets + steps) {len(cams) * (1 + n_steps)}")
    check(int(base.scene.data.contact.overflow.max()) == 0, f"{uid} rgb: contact overflow")
    err = 0.0
    for cam_name in cams:
        rgb = obs["sensor_data"][cam_name]["rgb"]
        check(tuple(rgb.shape) == (n_envs, 128, 128, 3) and rgb.dtype == torch.uint8,
              f"{uid} {cam_name} rgb is {tuple(rgb.shape)} {rgb.dtype}")
        inputs, e, agree = rerender_check(base, cam_name, 16, tr, tiled_inputs, geom_poses, rgb,
                                          f"{uid} {cam_name}")
        err = max(err, e)
        print(f"{uid} rgb {cam_name}: last frame of 16 envs re-rendered through the plain version: seg "
              f"agreement {agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal; faces in the scene {inputs[0].shape[1]}")
        if cam_name == "base_camera":
            times = raster_times(tr, inputs, 128, 128, 20)
            before = kernel.launches
            frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, 128, 128), 10)
            kernel.launches = before
            paths[f"pickycb_rgb_{n_envs}"] = dict(launches=launches, **times)
            print_raster_times("pick single ycb base camera", f"{n_envs}x128x128", times, card)
            print(f"pick single ycb tiled render (raster_setup + raster_tiles): {frame_ms:.4f} ms/frame "
                  f"{card}")
            del times
        del inputs
    print(f"{uid} rgb x{n_envs}: {n_envs * n_steps / (step_s * n_steps / (n_steps - 1)):.1f} env-steps/s "
          f"({step_s / (n_steps - 1) * 1e3:.2f} ms/step, eager), kernel launches {launches} "
          f"({len(cams)} cameras) {card}")

    # two envs with different models, set to one pose: their masks differ
    ids = np.asarray(base.model_ids)
    i, j = 0, int(np.nonzero(ids != ids[0])[0][0])
    state = base.get_state_dict()
    obj = state["actors"][base.obj.name].clone()
    obj[j] = obj[i]
    state["actors"][base.obj.name] = obj
    base.set_state_dict(state)
    seg = base._sensors["base_camera"].get_obs(rgb=False, segmentation=True,
                                               hidden_actors=base._hidden_objects)["segmentation"][..., 0]
    mask_i, mask_j = seg[i] == base.obj.per_scene_id, seg[j] == base.obj.per_scene_id
    n_i, n_j, n_diff = int(mask_i.sum()), int(mask_j.sum()), int((mask_i != mask_j).sum())
    check(n_i > 0 and n_j > 0 and n_diff > 0,
          f"{uid}: envs {i} ({ids[i]}) and {j} ({ids[j]}) at one pose: masks of {n_i} and {n_j} px differ on "
          f"{n_diff}")
    print(f"{uid}: envs {i} ({ids[i]}) and {j} ({ids[j]}) at one object pose: masks of {n_i} and {n_j} px, "
          f"differing on {n_diff} px")
    return err


def clutter_phase(torch, dev, make, card):
    """Phase 20: PickClutterYCB-v1 state at 1024 envs, then 8 envs against
    the JAX package's hull-hull contacts and overflow."""
    from maniskill_tpu_torch import physics
    from maniskill_tpu_torch.physics.types import HULL
    from maniskill_tpu_torch.utils.timing import profile_calls, timed_steps

    uid, n_envs, n_steps = CLUTTER
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="state", control_mode="pd_joint_delta_pos", device=dev)
    base = env.unwrapped
    zero = torch.zeros(n_envs, 8, device=dev)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    print(f"{uid} x{n_envs}: built and warmed up in {time.perf_counter() - t0:.2f} s")
    env.reset(seed=0)
    step_s = timed_steps(env, zero, n_steps)
    data = base.scene.data
    check(bool(torch.isfinite(data.qpos).all() & torch.isfinite(data.qvel).all()), f"{uid}: state not finite")
    overflow = data.contact.overflow
    share, worst = float((overflow > 0).float().mean()), int(overflow.max())
    n_cand, k = len(data.contact.geom1), base.scene.model.max_active_contacts
    k_rows = k if 0 < k < n_cand else f"{n_cand} (every candidate)"
    _, prof = profile_calls(lambda: env.step(zero), 1)
    check(prof["syncs"] == 0, f"{uid}: {prof['syncs']} stream/event syncs in a step")
    check(prof["h2d_copies"] == 0, f"{uid}: {prof['h2d_copies']} host-to-device copies in a step")
    print(f"{uid} state x{n_envs}: {n_envs * n_steps / step_s:.1f} env-steps/s ({step_s / n_steps * 1e3:.2f} "
          f"ms/step, eager); step profile {prof['launches']:.0f} launches, {prof['syncs']:.0f} stream/event "
          f"syncs, {prof['h2d_copies']:.0f} host-to-device copies, device kernels {prof['device_kernel_ms']:.3f} "
          f"ms of {prof['wall_ms']:.3f} ms (idle {prof['device_idle_share']:.3f}); contact.overflow > 0 in "
          f"{share:.6f} of the envs, max {worst} {card}")
    del env, base, data
    n = len(CLUTTER_JAX_OVERFLOW)
    small = make(uid, num_envs=n, obs_mode="state", control_mode="pd_joint_delta_pos", device=dev)
    small.reset(seed=0)
    # the hull-hull narrowphase on stacked objects, from the reset's state
    sb = small.unwrapped
    model, data = sb.scene.model, sb.scene.data
    a0, a1 = (int(model.body_q_adr[o.body_id]) for o in sb.objs[:2])
    qpos = data.qpos.clone()
    qpos[:, a1:a1 + 3] = qpos[:, a0:a0 + 3] + torch.tensor(CLUTTER_STACK_OFFSET, device=dev)
    contact = physics.forward(model, data.replace(qpos=qpos)).contact
    gtype = np.asarray(model.geom_type.tolist())
    hh = torch.as_tensor((gtype[contact.geom1] == HULL) & (gtype[contact.geom2] == HULL), device=dev)
    depth = contact.depth[:, hh]
    live = depth > -1e5  # dead rows hold BAD_DEPTH, -1e6
    rows = live.sum(1).tolist()
    deepest = torch.where(live, depth, -torch.inf).amax(1).cpu().numpy()
    depth_err = float(np.abs(deepest - np.float32(CLUTTER_JAX_DEEPEST)).max())
    check(rows == CLUTTER_JAX_HULL_ROWS, f"{uid} x{n}: live hull-hull contact rows per env {rows} != the JAX "
                                         f"package's {CLUTTER_JAX_HULL_ROWS}")
    check(depth_err <= CLUTTER_DEPTH_TOL, f"{uid} x{n}: deepest hull-hull contact per env {deepest.tolist()} "
                                          f"off the JAX package's {CLUTTER_JAX_DEEPEST} by {depth_err:.3g} m")
    print(f"{uid} x{n}, seed 0, second object at the first's +{list(CLUTTER_STACK_OFFSET)}: live hull-hull "
          f"contact rows per env {rows}, equal to the JAX package's on the CPU; deepest per env within "
          f"{depth_err:.3g} m of its (tolerance {CLUTTER_DEPTH_TOL}) {card}")
    for _ in range(3):
        small.step(torch.zeros(n, 8, device=dev))
    got = small.unwrapped.scene.data.contact.overflow.tolist()
    check(got == CLUTTER_JAX_OVERFLOW, f"{uid} x{n}: overflow per env {got} != the JAX package's "
                                       f"{CLUTTER_JAX_OVERFLOW}")
    print(f"{uid} x{n}, seed 0, 3 steps: overflow per env {got}, equal to the JAX package's on the CPU {card}")


def state_cell(torch, dev, make, card, uid, n_envs, n_steps, zero, after=None, control_mode="pd_joint_delta_pos",
               **kw):
    """Make ``uid`` at ``n_envs`` in state mode, time ``n_steps`` steps of
    ``zero`` after a warm-up, check the state and overflow, and profile one
    more step (0 syncs, 0 host-to-device copies). ``after(base, i, step
    outputs)``, if given, runs after each timed step i (queuing device work
    only) and once after the warm-up step with i = -1. Returns the env."""
    from maniskill_tpu_torch.utils.timing import profile_calls, timed_steps

    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="state", control_mode=control_mode, device=dev, **kw)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    base = env.unwrapped
    env.reset(seed=0)
    out = env.step(zero)  # builds the lazy tables (contact signs)
    if after is not None:
        after(base, -1, out)  # and the hook's
    env.reset(seed=0)
    if after is None:
        step_s = timed_steps(env, zero, n_steps)
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_steps):
            after(base, i, env.step(zero))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    data = base.scene.data
    check(bool(torch.isfinite(data.qpos).all() & torch.isfinite(data.qvel).all()), f"{uid}: state not finite")
    overflow = int(data.contact.overflow.max())
    check(overflow == 0, f"{uid} x{n_envs}: contact overflow in {int((data.contact.overflow > 0).sum())} envs")
    n_cand, k = len(data.contact.geom1), base.scene.model.max_active_contacts
    k_rows = k if 0 < k < n_cand else f"{n_cand} (every candidate)"
    _, prof = profile_calls(lambda: env.step(zero), 1)
    check(prof["syncs"] == 0, f"{uid}: {prof['syncs']} stream/event syncs in a step")
    check(prof["h2d_copies"] == 0, f"{uid}: {prof['h2d_copies']} host-to-device copies in a step")
    print(f"{uid} state x{n_envs}: make {make_s:.2f} s; {n_steps} steps {step_s / n_steps * 1e3:.2f} ms/step "
          f"({n_envs * n_steps / step_s:.1f} env-steps/s, eager); step profile {prof['launches']:.0f} launches, "
          f"{prof['syncs']:.0f} stream/event syncs, {prof['h2d_copies']:.0f} host-to-device copies, device "
          f"kernels {prof['device_kernel_ms']:.3f} ms of {prof['wall_ms']:.3f} ms (idle "
          f"{prof['device_idle_share']:.3f}); {n_cand} contact candidates, K={k_rows}; contact.overflow 0 in "
          f"every env {card}")
    return env


def family_state_phase(torch, dev, make, card):
    """Phase 21: the seven single-robot tasks of the family at 4096 envs."""
    n = FAMILY_ENVS
    zero = torch.zeros(n, 8, device=dev)
    for uid in FAMILY_STATE:
        kw = dict(geometry_seed=PEG_GEOMETRY_SEED) if uid == "PegInsertionSide-v1" else {}
        env = state_cell(torch, dev, make, card, uid, n, FAMILY_STEPS, zero, **kw)
        base = env.unwrapped
        if uid in FAMILY_RESTING:
            # the table holds the resting object with its weight (the steps
            # after the timed ones included)
            obj = getattr(base, FAMILY_RESTING[uid])
            force = base.scene.get_pairwise_contact_forces(base.table_scene.table, obj)[:, 2]
            weight = float(base.scene.model.body_mass[obj.body_id]) * 9.81
            rel = float(((force - weight).abs() / weight).max())
            check(rel <= 0.02, f"{uid} statics: the table's force on the {obj.name} off its weight by {rel:.4f}")
            print(f"  {uid} statics: the table's force on the {obj.name} within {rel:.3e} of its weight "
                  f"{weight:.5f} N in every env")
        if uid == "TurnFaucet-v1":
            q = base.handle_joint.qpos[:, 0]
            lo, hi = float(q.min()), float(q.max())
            check(lo >= -1e-3 and hi <= np.pi / 2 + 1e-3, f"{uid}: handle at [{lo}, {hi}] outside its limits")
            print(f"  {uid}: handle angle in [{lo:.5f}, {hi:.5f}] rad, inside its limits [0, pi/2]")
        if uid == "PegInsertionSide-v1":
            n_sizes = len(torch.unique(base.peg_half_sizes[:, 0]))
            check(n_sizes > n // 2, f"{uid}: only {n_sizes} distinct peg lengths in {n} envs")
            print(f"  {uid}: {n_sizes} distinct peg lengths in {n} envs (per-env geom sizes and offsets)")
        del env, base


def peg_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 22: PegInsertionSide's peg-in-hole contacts on the card against
    the JAX package's, then rgb at 2048 envs through the kernel. Returns the
    kernel's max depth error against the plain version."""
    from maniskill_tpu_torch import physics
    from maniskill_tpu_torch.utils.timing import cuda_ms, timed_steps

    uid = "PegInsertionSide-v1"
    n = len(PEG_JAX_ROWS)
    env = make(uid, num_envs=n, obs_mode="state", control_mode="pd_joint_delta_pos",
               geometry_seed=PEG_GEOMETRY_SEED, device=dev)
    env.reset(seed=0)
    base = env.unwrapped
    off = torch.zeros(n, 7, device=dev)
    off[:, 0] = -base.peg_half_sizes[:, 0]
    off[:, 1:2].fill_(PEG_HOLE_OFFSET[0])
    off[:, 2:3].fill_(PEG_HOLE_OFFSET[1])
    off[:, 3:4].fill_(1.0)
    qpos = base.scene.data.qpos.clone()
    qa = base.peg._q_adr
    qpos[:, qa:qa + 7] = (base.box.pose * off).raw_pose
    contact = physics.forward(base.scene.model, base.scene.data.replace(qpos=qpos)).contact
    gb = np.asarray(base.scene.model.geom_body)
    b1, b2 = gb[contact.geom1], gb[contact.geom2]
    peg, box = base.peg.body_id, base.box.body_id
    pair = torch.as_tensor(((b1 == peg) & (b2 == box)) | ((b1 == box) & (b2 == peg)), device=dev)
    depth = contact.depth[:, pair]
    live = depth > -1e5  # dead rows hold BAD_DEPTH, -1e6
    rows = live.sum(1).tolist()
    deepest = torch.where(live, depth, -torch.inf).amax(1).cpu().numpy()
    depth_err = float(np.abs(deepest - np.float32(PEG_JAX_DEEPEST)).max())
    check(rows == PEG_JAX_ROWS, f"{uid} x{n}: live peg-plate contact rows per env {rows} != the JAX package's "
                                f"{PEG_JAX_ROWS}")
    check(depth_err <= PEG_DEPTH_TOL, f"{uid} x{n}: deepest peg-plate contact per env {deepest.tolist()} off the "
                                      f"JAX package's {PEG_JAX_DEEPEST} by {depth_err:.3g} m")
    print(f"{uid} x{n}, seed 0, geometry seed {PEG_GEOMETRY_SEED}, pegs halfway into their holes: live peg-plate "
          f"contact rows per env {rows}, equal to the JAX package's on the CPU; deepest per env within "
          f"{depth_err:.3g} m of its (tolerance {PEG_DEPTH_TOL}) {card}")
    del env, base, contact

    uid, n_envs, n_steps = PEG_RGB
    kernel = RasterLaunches(tr)
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb", control_mode="pd_joint_delta_pos",
               geometry_seed=PEG_GEOMETRY_SEED, device=dev)
    base = env.unwrapped
    zero = torch.zeros(n_envs, 8, device=dev)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    print(f"{uid} rgb x{n_envs}: built and warmed up in {time.perf_counter() - t0:.2f} s")
    kernel.launches = 0
    env.reset(seed=0)
    step_s = timed_steps(env, zero, n_steps - 1)
    obs, *_ = env.step(zero)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == 1 + n_steps, f"{uid} rgb: kernel launches {launches} != resets + steps {1 + n_steps}")
    check(int(base.scene.data.contact.overflow.max()) == 0, f"{uid} rgb: contact overflow")
    rgb = obs["sensor_data"]["base_camera"]["rgb"]
    check(tuple(rgb.shape) == (n_envs, 128, 128, 3) and rgb.dtype == torch.uint8,
          f"{uid} rgb is {tuple(rgb.shape)} {rgb.dtype}")
    inputs, err, agree = rerender_check(base, "base_camera", 16, tr, tiled_inputs, geom_poses, rgb, f"{uid} rgb")
    seg = base._sensors["base_camera"].get_obs(rgb=False, segmentation=True,
                                               hidden_actors=base._hidden_objects)["segmentation"][..., 0]
    for actor in (base.peg, base.box):
        seen = (seg == actor.per_scene_id).flatten(1).any(1).float().mean().item()
        check(seen >= 0.9, f"{uid} rgb: the {actor.name} is in view in only {seen:.3f} of the envs")
    times = raster_times(tr, inputs, 128, 128, 20)
    before = kernel.launches
    frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, 128, 128), 10)
    kernel.launches = before
    paths[f"peginsertionside_rgb_{n_envs}"] = dict(launches=launches, **times)
    print(f"{uid} rgb x{n_envs}: {n_envs * (n_steps - 1) / step_s:.1f} env-steps/s ({step_s / (n_steps - 1) * 1e3:.2f} "
          f"ms/step, eager), kernel launches {launches}, last frame of 16 envs re-rendered through the plain "
          f"version: seg agreement {agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal; peg and block in view {card}")
    print_raster_times("peg insertion side", f"{n_envs}x128x128", times, card)
    print(f"peg insertion side tiled render (raster_setup + raster_tiles): {frame_ms:.4f} ms/frame; faces in "
          f"the scene {inputs[0].shape[1]} {card}")
    return err


def two_robot_phase(torch, dev, make, card):
    """Phase 23: the two two-robot tasks at 4096 envs with dict actions."""
    n = FAMILY_ENVS
    for uid in TWO_ROBOT:
        zero = {f"panda-{i}": torch.zeros(n, 8, device=dev) for i in range(2)}
        env = state_cell(torch, dev, make, card, uid, n, FAMILY_STEPS, zero)
        space = env.unwrapped.single_action_space
        check(sorted(space.spaces) == ["panda-0", "panda-1"], f"{uid}: action space {space}")
        del env


def locomotion_phase(torch, dev, make, card):
    """Phase 24: the 15 locomotion envs at 4096 envs, zero actions. Every
    step's obs and reward finite and overflow 0; the first 16 envs' root
    heights held to the JAX package's figures from the same states; the
    near-static robots' contact force held to a band of their weight."""
    with open(LOCOMOTION_FIGURES) as f:
        figures = json.load(f)
    n, m = LOCOMOTION_ENVS, LOCOMOTION_FIGURE_ENVS
    for uid, n_steps, n_act in LOCOMOTION:
        rec = dict(z=[], force=[], finite=[], overflow=[])

        def after(base, i, out):
            robot = base.agent.robot
            root = robot.links_map["torso"] if robot.fixed_root else robot.links[0]
            z = root.pose.p[:m, 2]
            force = robot.get_net_contact_forces()[..., 2].sum(1)
            finite = torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all()
            overflow = base.scene.data.contact.overflow.max()
            if i >= 0:
                for k, v in zip(("z", "force", "finite", "overflow"), (z, force, finite, overflow)):
                    rec[k].append(v)

        env = state_cell(torch, dev, make, card, uid, n, n_steps, torch.zeros(n, n_act, device=dev), after=after)
        base = env.unwrapped
        robot = base.agent.robot
        weight = float(np.asarray(base.scene.model.host_body_mass, np.float64)[
            [link.body_id for link in robot.links]].sum()) * 9.81
        finite = torch.stack(rec["finite"]).all().item()
        check(finite, f"{uid}: obs or reward not finite in a step")
        overflow = int(torch.stack(rec["overflow"]).max())
        check(overflow == 0, f"{uid}: contact overflow {overflow} in a step")
        z = torch.stack(rec["z"]).cpu().numpy()
        want = np.array([row["root_z"] for row in figures[uid][:n_steps]], np.float64)
        z_err = float(np.abs(z - want).max())
        check(z_err <= LOCOMOTION_Z_TOL, f"{uid}: root heights of the first {m} envs off the JAX package's "
                                         f"figures by {z_err:.3g} m (tolerance {LOCOMOTION_Z_TOL})")
        share = (torch.stack(rec["force"]) / weight).cpu().numpy()  # (steps, envs)
        line = (f"  {uid}: {n_steps} steps, obs and rewards finite and overflow 0 in every step; root heights of "
                f"the first {m} envs within {z_err:.3g} m of the JAX package's (tolerance {LOCOMOTION_Z_TOL}); "
                f"vertical contact force / weight {weight:.3f} N after step {n_steps}: "
                f"{share[-1].min():.4f}-{share[-1].max():.4f}")
        if uid in LOCOMOTION_BANDS:
            first, last, mean, lo, hi = LOCOMOTION_BANDS[uid]
            held = share[first - 1:last]
            held = held.mean(0, keepdims=True) if mean else held
            low, high = float(held.min()), float(held.max())
            what = f"{'the mean over' if mean else 'each of'} steps {first}-{last}"
            check(lo <= low and high <= hi, f"{uid}: vertical contact force / weight in {what} spans "
                                             f"[{low:.4f}, {high:.4f}], outside [{lo}, {hi}]")
            line += f"; in {what} {low:.4f}-{high:.4f} in every env (band [{lo}, {hi}])"
        print(line)
        del env, base, robot


def anymal_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 25: AnymalC-Reach rgb at 2048 envs through the kernel, its base
    camera mounted on the floating base. Returns the kernel's max depth
    error against the plain version."""
    from maniskill_tpu_torch import physics
    from maniskill_tpu_torch.structs.pose import Pose
    from maniskill_tpu_torch.utils.geometry import rotation_conversions as rc
    from maniskill_tpu_torch.utils.timing import cuda_ms, timed_steps

    uid, n_envs, n_steps = ANYMAL_RGB
    kernel = RasterLaunches(tr)
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb", control_mode="pd_joint_delta_pos", device=dev)
    base = env.unwrapped
    robot = base.agent.robot
    zero = torch.zeros(n_envs, 12, device=dev)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    print(f"{uid} rgb x{n_envs}: built and warmed up in {time.perf_counter() - t0:.2f} s")
    kernel.launches = 0
    env.reset(seed=0)
    qa = robot.root_q_adr
    start = base.scene.data.qpos[:, qa:qa + 7].clone()
    step_s = timed_steps(env, zero, n_steps - 1)
    obs, *_ = env.step(zero)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == 1 + n_steps, f"{uid} rgb: kernel launches {launches} != resets + steps {1 + n_steps}")
    check(int(base.scene.data.contact.overflow.max()) == 0, f"{uid} rgb: contact overflow")
    check(bool(torch.isfinite(obs["agent"]["qpos"]).all() & torch.isfinite(obs["agent"]["qvel"]).all()),
          f"{uid} rgb: agent obs not finite")
    rgb = obs["sensor_data"]["base_camera"]["rgb"]
    check(tuple(rgb.shape) == (n_envs, 128, 128, 3) and rgb.dtype == torch.uint8,
          f"{uid} rgb is {tuple(rgb.shape)} {rgb.dtype}")
    inputs, err, agree = rerender_check(base, "base_camera", 16, tr, tiled_inputs, geom_poses, rgb, f"{uid} rgb")
    # the camera follows the base: its pose is the base's (the FREE root's
    # qpos) times the mount offset, composed here from rotation matrices;
    # after the steps (the base sags level) and with every base set to a
    # random pose of its own
    cam = base._sensors["base_camera"]
    seg = cam.get_obs(rgb=False, segmentation=True, hidden_actors=base._hidden_objects)["segmentation"][..., 0]
    seen = (seg == base.goal.per_scene_id).flatten(1).any(1).float().mean().item()
    check(seen >= 0.9, f"{uid} rgb: the goal is in view in only {seen:.3f} of the envs")
    off = torch.as_tensor(np.asarray(cam.config.pose, np.float32), device=dev)

    def camera_error():
        root = base.scene.data.qpos[:, qa:qa + 7]
        r_base = rc.quaternion_to_matrix(root[:, 3:])
        want_p = root[:, :3] + torch.einsum("bij,j->bi", r_base, off[:3])
        want_r = r_base @ rc.quaternion_to_matrix(off[3:])
        pose = cam.world_pose()
        return max((pose.p - want_p).abs().max().item(),
                   (rc.quaternion_to_matrix(pose.q) - want_r).abs().max().item(),
                   (cam.get_params()["cam2world_gl"][:, :3, 3] - want_p).abs().max().item())

    moved = (base.scene.data.qpos[:, qa:qa + 7] - start).abs().max().item()
    cam_err = camera_error()
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(n_envs, 4))
    raw = np.concatenate([rng.uniform(-1, 1, (n_envs, 3)), quat / np.linalg.norm(quat, axis=1, keepdims=True)], 1)
    robot.set_root_pose(Pose(torch.as_tensor(raw, dtype=torch.float32, device=dev)))
    base.scene.data = physics.forward_kinematics(base.scene.model, base.scene.data)
    cam_err = max(cam_err, camera_error())
    check(cam_err <= 1e-5, f"{uid} rgb: the camera is off the base pose times its mount by {cam_err:.3g}")
    check(moved > 1e-3, f"{uid} rgb: the base moved only {moved:.3g} between the reset and the last step")
    times = raster_times(tr, inputs, 128, 128, 20)
    before = kernel.launches
    frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, 128, 128), 10)
    kernel.launches = before
    paths[f"anymalc_reach_rgb_{n_envs}"] = dict(launches=launches, **times)
    print(f"{uid} rgb x{n_envs}: {n_envs * (n_steps - 1) / step_s:.1f} env-steps/s ({step_s / (n_steps - 1) * 1e3:.2f} "
          f"ms/step, eager), kernel launches {launches}, last frame of 16 envs re-rendered through the plain "
          f"version: seg agreement {agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal; the camera on the base pose "
          f"times its mount within {cam_err:.3g} in every env, after the steps (the base moved up to "
          f"{moved:.4f}) and at random base poses; the goal in view in {seen:.3f} of the envs {card}")
    print_raster_times("anymal c reach", f"{n_envs}x128x128", times, card)
    print(f"anymal c reach tiled render (raster_setup + raster_tiles): {frame_ms:.4f} ms/frame; faces in "
          f"the scene {inputs[0].shape[1]} {card}")
    return err


def dexterity_cpu_parity(torch, dev, make, uid, state, card, control_mode="pd_joint_delta_pos", mount=False,
                         qpos_tol=DEX_CPU_QPOS_TOL, steps=DEX_CPU_STEPS, **make_kw):
    """The first DEX_CPU_ENVS envs of ``state`` on the card and in the port
    on the CPU: fresh envs of that width (``make_kw`` passed to ``make``;
    the task's own control mode if ``control_mode`` is None) reset to it
    (both solvers start cold) take ``steps`` zero-action steps; qpos within
    ``qpos_tol`` and obs within DEX_CPU_OBS_TOL, and with ``mount`` the
    camera mount's pose (handed over with the state) within ``qpos_tol``.
    Returns (qpos gap, obs gap)."""
    m = DEX_CPU_ENVS
    if control_mode is not None:
        make_kw["control_mode"] = control_mode
    out = []
    for d in (dev, torch.device("cpu")):
        env = make(uid, num_envs=m, obs_mode="state", device=d, **make_kw)
        base = env.unwrapped
        zero = torch.zeros((m,) + tuple(base.single_action_space.shape), device=d)
        env.reset(seed=0, options=dict(reset_to_env_states=_first_envs(state, m, d)))
        for _ in range(steps):
            obs, *_ = env.step(zero)
        out.append([base.scene.data.qpos.cpu(), obs.cpu()] + ([base.camera_mount.pose.raw_pose.cpu()] if mount else []))
        del env, base
    gaps = [float((a - b).abs().max()) for a, b in zip(*out)] + [0.0]
    q_gap, o_gap, m_gap = gaps[:3]
    check(q_gap <= qpos_tol and o_gap <= DEX_CPU_OBS_TOL and m_gap <= qpos_tol,
          f"{uid}: the card's first {m} envs part from the CPU's after {steps} steps by {q_gap:.3g} "
          f"(qpos, tolerance {qpos_tol}), {o_gap:.3g} (obs, tolerance {DEX_CPU_OBS_TOL}), {m_gap:.3g} "
          f"(camera mount)")
    mounted = f", the camera mount's pose within {m_gap:.3g}" if mount else ""
    print(f"  {uid}: the card's first {m} envs and the CPU port from one state, {steps} zero-action "
          f"steps: qpos within {q_gap:.3g} (tolerance {qpos_tol}), obs within {o_gap:.3g} (tolerance "
          f"{DEX_CPU_OBS_TOL}){mounted} {card}")
    return q_gap, o_gap


def dexterity_state_phase(torch, dev, make, card):
    """Phase 39: the dexterity family at 4096 (timed) and 1024 envs, and
    Empty-v1 with each robot no task uses."""
    n = DEX_ENVS
    for uid, n_act in DEX_TIMED:
        rec = dict(success=[], finite=[])

        def after(base, i, out):
            if i >= 0:
                rec["success"].append(out[4]["success"].any())
                rec["finite"].append(torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all())

        env = state_cell(torch, dev, make, card, uid, n, DEX_STEPS, torch.zeros(n, n_act, device=dev), after=after)
        base = env.unwrapped
        check(bool(torch.stack(rec["finite"]).all()), f"{uid}: obs or reward not finite in a step")
        check(not bool(torch.stack(rec["success"]).any()), f"{uid}: success after zero actions")
        line = f"  {uid}: obs and rewards finite and success false in every env and step"
        if uid.startswith("RotateSingleObjectInHand"):
            forces = base.agent.tip_contact_forces
            check(tuple(forces.shape) == (n, 4, 3) and bool(torch.isfinite(forces).all()),
                  f"{uid}: touch forces {tuple(forces.shape)} or not finite")
            line += (f"; touch forces (B, 4, 3) finite, max {float(forces.norm(dim=-1).max()):.3f} N; "
                     f"{len(set(base.model_ids))} YCB models")
        if uid.startswith("RotateValve"):
            spokes = base.scene.model.geom_size[:, base.spoke_geom_ids(), 1]
            n_len = len(torch.unique(spokes[:, 0]))
            check(tuple(spokes.shape) == (n, 3) and n_len > n // 2, f"{uid}: {n_len} distinct spoke lengths")
            line += f"; {n_len} distinct spoke lengths in {n} envs (per-env geom sizes)"
        print(line)
        dexterity_cpu_parity(torch, dev, make, uid, base.get_state_dict(), card)
        del env, base

    m = DEX_LEVEL_ENVS
    for uid, n_act in DEX_LEVELS:
        t0 = time.perf_counter()
        env = make(uid, num_envs=m, obs_mode="state", control_mode="pd_joint_delta_pos", device=dev)
        base = env.unwrapped
        zero = torch.zeros(m, n_act, device=dev)
        env.reset(seed=0)
        for _ in range(DEX_LEVEL_STEPS):
            obs, rew, _, _, info = env.step(zero)
        data = base.scene.data
        check(bool(torch.isfinite(obs).all() & torch.isfinite(rew).all() & torch.isfinite(data.qpos).all()
                   & torch.isfinite(data.qvel).all()), f"{uid}: state not finite")
        check(int(data.contact.overflow.max()) == 0, f"{uid} x{m}: contact overflow")
        # TriFinger's levels 0, 1 and 3 draw some goals that the cube resting
        # at the arena's centre meets (within 2 cm and 0.1 rad): success only
        # there
        allowed = torch.zeros_like(info["success"])
        if uid.startswith("TriFinger"):
            allowed = base.obj_goal.pose.p[:, :2].norm(dim=-1) < base.goal_radius + 1e-3
        met = int(info["success"].sum())
        check(not bool((info["success"] & ~allowed).any()), f"{uid}: success after zero actions away from the "
                                                            f"cube's resting place")
        torch.cuda.synchronize()
        where = f" but the {met} whose goal lies where the cube rests" if uid.startswith("TriFinger") else ""
        print(f"{uid} state x{m}: make, reset and {DEX_LEVEL_STEPS} steps in {time.perf_counter() - t0:.2f} s; "
              f"finite, overflow 0; success false in every env{where} {card}")
        del env, base, data

    gen = torch.Generator(device=dev).manual_seed(0)
    for robot in EMPTY_ROBOTS:
        empty_robot_cell(torch, dev, make, card, robot, gen)


def empty_robot_cell(torch, dev, make, card, robot, gen, control_mode=None):
    """Empty-v1 with ``robot`` at EMPTY_ENVS (in its default control mode
    unless given one), EMPTY_STEPS random steps from ``gen``: the state
    finite and every keyframe of the robot's dof."""
    k = EMPTY_ENVS
    t0 = time.perf_counter()
    env = make("Empty-v1", num_envs=k, obs_mode="state", robot_uids=robot, control_mode=control_mode, device=dev)
    base = env.unwrapped
    shape = (k,) + tuple(base.single_action_space.shape)
    env.reset(seed=0)
    for _ in range(EMPTY_STEPS):
        obs, *_ = env.step(torch.rand(shape, generator=gen, device=dev) * 2 - 1)
    data = base.scene.data
    check(bool(torch.isfinite(obs).all() & torch.isfinite(data.qpos).all() & torch.isfinite(data.qvel).all()),
          f"Empty-v1 {robot} {base.control_mode}: state not finite")
    dof = base.agent.robot.dof
    for name, kf in base.agent.keyframes.items():
        check(np.asarray(kf.qpos).reshape(-1).shape[0] == dof, f"{robot} keyframe {name} is not of dof {dof}")
    torch.cuda.synchronize()
    print(f"Empty-v1 {robot} {base.control_mode} x{k}: dof {dof}, {shape[1]} actions, {EMPTY_STEPS} random steps "
          f"in {time.perf_counter() - t0:.2f} s with the make; finite; keyframes {sorted(base.agent.keyframes)} "
          f"of the dof; contact.overflow max {int(data.contact.overflow.max())} {card}")
    modes = base.agent.supported_control_modes
    del env, base, data
    return modes


def arm_state_phase(torch, dev, make, card):
    """Phase 39, the arm slice: PickCubeSO100, PickCubeWidowXAI and
    SO100GraspCube (domain randomization on) at ARM_ENVS, and Empty-v1 with
    each arm robot in every control mode it offers."""
    n = ARM_ENVS
    for uid, n_act, mode in ARM_TIMED:
        rec = dict(ok=[], mounts=[])

        def after(base, i, out):
            if i >= 0:
                rec["ok"].append(torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all()
                                 & (base.scene.data.contact.overflow == 0).all())
                if hasattr(base, "camera_mount"):
                    rec["mounts"].append(base.camera_mount.pose.raw_pose.clone())

        env = state_cell(torch, dev, make, card, uid, n, ARM_STEPS, torch.zeros(n, n_act, device=dev), after=after,
                         control_mode=mode)
        base = env.unwrapped
        check(bool(torch.stack(rec["ok"]).all()), f"{uid}: obs or reward not finite, or a contact overflow, in a step")
        line = f"  {uid}: obs and rewards finite and contact.overflow 0 in every env and step"
        if rec["mounts"]:
            line += "; " + grasp_tables_and_mounts(torch, dev, base, rec["mounts"])
        print(line)
        dexterity_cpu_parity(torch, dev, make, uid, base.get_state_dict(), card, control_mode=mode,
                             mount=bool(rec["mounts"]))
        del env, base
    gen = torch.Generator(device=dev).manual_seed(0)
    for robot in ARM_ROBOTS:
        for mode in empty_robot_cell(torch, dev, make, card, robot, gen)[1:]:
            empty_robot_cell(torch, dev, make, card, robot, gen, control_mode=mode)


def grasp_tables_and_mounts(torch, dev, base, mounts):
    """SO100GraspCube's per-env cube half sizes and frictions in the model
    equal to its host tables in every env, and the camera mount's pose after
    each step (``mounts``) inside its prism, moved, and distinct across envs.
    Returns the summary."""
    n = base.num_envs
    gids = base.cube.geom_ids
    sizes = base.scene.model.geom_size[:, gids].cpu().numpy()
    fric = base.scene.model.geom_friction[:, gids].cpu().numpy()
    halfs, frictions = base.host_cube_half_sizes, base.host_cube_frictions
    check(np.array_equal(sizes, np.broadcast_to(halfs[:, None, None], sizes.shape)),
          "SO100GraspCube: the model's cube sizes differ from the host table")
    check(np.array_equal(fric, np.broadcast_to(frictions[:, None], fric.shape)),
          "SO100GraspCube: the model's cube frictions differ from the host table")
    center = torch.tensor(base.base_camera_settings["pos"], device=dev)
    max_off = base.domain_randomization_config.max_camera_offset
    bound = torch.tensor(max_off, device=dev)
    worst = 0.0
    for i, p in enumerate(mounts):
        off = (p[:, :3] - center).abs()
        worst = max(worst, float(off.max()))
        check(bool((off <= bound + 1e-6).all()), f"SO100GraspCube: a camera mount {worst:.4g} m off its base")
        distinct = torch.unique(p, dim=0).shape[0]
        check(distinct == n, f"SO100GraspCube: {distinct} distinct mount poses in {n} envs after step {i + 1}")
        if i:
            check(bool((p != mounts[i - 1]).any(1).all()), f"SO100GraspCube: a mount kept its pose in step {i + 1}")
    return (f"cube half sizes {halfs.min():.5f}-{halfs.max():.5f} m and frictions {frictions.min():.4f}-"
            f"{frictions.max():.4f} in the model equal to the host tables in all {n} envs; after each of "
            f"{len(mounts)} steps every camera mount re-posed inside its prism (offset <= {max_off[0]} m per axis, "
            f"max {worst:.5f}), {n} distinct poses")


def dexterity_worker(card: str):
    """Phase 39, then phase 30 (SAC), in a process of their own. Returns
    their seconds by part."""
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    torch.set_num_threads(2)  # the CPU port's parity steps, beside the other processes
    seconds = {}
    for part, fn in (("39 dexterity", dexterity_state_phase), ("39 arms", arm_state_phase), ("30", sac_phase)):
        t0 = time.perf_counter()
        fn(torch, torch.device("cuda"), make, card)
        seconds[part] = time.perf_counter() - t0
    return seconds


def valve_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 40: RotateValveLevel2 rgb at 2048 envs through the kernel, the
    valves' spoke sizes per env in the model. Returns the kernel's max depth
    error against the plain version."""
    from maniskill_tpu_torch.utils.timing import cuda_ms, timed_steps

    uid, n_envs, n_steps = VALVE_RGB
    kernel = RasterLaunches(tr)
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb", control_mode="pd_joint_delta_pos", device=dev)
    base = env.unwrapped
    zero = torch.zeros(n_envs, 9, device=dev)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    print(f"{uid} rgb x{n_envs}: built and warmed up in {time.perf_counter() - t0:.2f} s")
    check(tuple(base.scene.model.geom_size.shape[:1]) == (n_envs,), f"{uid} rgb: geom_size is not per env")
    kernel.launches = 0
    env.reset(seed=0)
    step_s = timed_steps(env, zero, n_steps - 1)
    obs, *_ = env.step(zero)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == 1 + n_steps, f"{uid} rgb: kernel launches {launches} != resets + steps {1 + n_steps}")
    check(int(base.scene.data.contact.overflow.max()) == 0, f"{uid} rgb: contact overflow")
    check(bool(torch.isfinite(obs["agent"]["qpos"]).all() & torch.isfinite(obs["agent"]["qvel"]).all()),
          f"{uid} rgb: agent obs not finite")
    rgb = obs["sensor_data"]["base_camera"]["rgb"]
    check(tuple(rgb.shape) == (n_envs, 128, 128, 3) and rgb.dtype == torch.uint8,
          f"{uid} rgb is {tuple(rgb.shape)} {rgb.dtype}")
    inputs, err, agree = rerender_check(base, "base_camera", 16, tr, tiled_inputs, geom_poses, rgb, f"{uid} rgb")
    cam = base._sensors["base_camera"]
    seg = cam.get_obs(rgb=False, segmentation=True, hidden_actors=base._hidden_objects)["segmentation"][..., 0]
    ids = torch.tensor([link.per_scene_id for link in base.valve.links], device=dev)
    valve_px = torch.isin(seg, ids).flatten(1).sum(1)
    check(bool((valve_px > 0).all()), f"{uid} rgb: the valve is out of view in {int((valve_px == 0).sum())} envs")
    times = raster_times(tr, inputs, 128, 128, 20)
    before = kernel.launches
    frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, 128, 128), 10)
    kernel.launches = before
    paths[f"rotatevalve_rgb_{n_envs}"] = dict(launches=launches, **times)
    print(f"{uid} rgb x{n_envs}: {n_envs * (n_steps - 1) / step_s:.1f} env-steps/s ({step_s / (n_steps - 1) * 1e3:.2f} "
          f"ms/step, eager), kernel launches {launches}, last frame of 16 envs re-rendered through the plain "
          f"version: seg agreement {agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal; the valve in view in every "
          f"env ({int(valve_px.min())}-{int(valve_px.max())} px) {card}")
    print_raster_times("rotate valve", f"{n_envs}x128x128", times, card)
    print(f"rotate valve tiled render (raster_setup + raster_tiles): {frame_ms:.4f} ms/frame; faces in "
          f"the scene {inputs[0].shape[1]} {card}")
    return err


def grasp_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 41: SO100GraspCube-v1 rgb+segmentation at 2048 envs through the
    kernel, the camera re-posed in every env and step, the greenscreen
    composited over the procedural overlay. Returns the kernel's max depth
    error against the plain version."""
    import os

    from maniskill_tpu_torch.utils.timing import cuda_ms, timed_steps

    uid, n_envs, n_steps = GRASP_RGB
    name = f"{uid} rgb+segmentation x{n_envs}"
    kernel = RasterLaunches(tr)
    check(not os.path.exists(GRASP_OVERLAY), f"{GRASP_OVERLAY} exists; phase 41 composites the procedural overlay")
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb+segmentation", greenscreen_overlay_path=GRASP_OVERLAY, device=dev)
    base = env.unwrapped
    check(base.overlay_sources == {"base_camera": "procedural"}, f"{name}: overlays {base.overlay_sources}")
    zero = torch.zeros(n_envs, 6, device=dev)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    print(f"{name}: built and warmed up in {time.perf_counter() - t0:.2f} s; the greenscreen path {GRASP_OVERLAY!r} "
          f"does not exist, so the procedural overlay is composited (overlay_sources {base.overlay_sources})")
    kernel.launches = 0
    env.reset(seed=0)
    step_s = timed_steps(env, zero, n_steps - 1)
    obs, *_ = env.step(zero)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == 1 + n_steps, f"{name}: kernel launches {launches} != resets + steps {1 + n_steps}")
    check(int(base.scene.data.contact.overflow.max()) == 0, f"{name}: contact overflow")
    check(bool(torch.isfinite(obs["agent"]["qpos"]).all() & torch.isfinite(obs["extra"]["dist_to_rest_qpos"]).all()),
          f"{name}: agent obs not finite")
    cam_obs = obs["sensor_data"]["base_camera"]
    rgb, seg = cam_obs["rgb"], cam_obs["segmentation"]
    check(tuple(rgb.shape) == (n_envs, 128, 128, 3) and rgb.dtype == torch.uint8, f"{name}: rgb {tuple(rgb.shape)}")
    check(tuple(seg.shape) == (n_envs, 128, 128, 1) and seg.dtype == torch.int16, f"{name}: seg {tuple(seg.shape)}")
    cam = base._sensors["base_camera"]
    pose_gap = float((cam.world_pose().raw_pose - base.camera_mount.pose.raw_pose).abs().max())
    check(pose_gap <= 1e-6, f"{name}: the camera is {pose_gap} off its mount")
    # the raw frame of the last state (a comparison launch, not the path's)
    before = kernel.launches
    raw = cam.get_obs(rgb=True, segmentation=True, hidden_actors=base._hidden_objects)
    kernel.launches = before
    check(torch.equal(raw["segmentation"], seg), f"{name}: the segmentation obs differs from the raw frame's")
    inputs, err, agree = rerender_check(base, "base_camera", 16, tr, tiled_inputs, geom_poses, raw["rgb"], name,
                                        seg=raw["segmentation"])
    lut, overlay = base._keep_lut, base._rgb_overlay_images["base_camera"][None]

    def composite(frame, ids):
        return torch.where(lut[torch.clamp(ids.long(), 0, lut.shape[0] - 1)][..., None], frame, overlay)

    check(torch.equal(composite(raw["rgb"], seg[..., 0]), rgb), f"{name}: the composite differs from "
                                                               f"where(keep[seg], raw rgb, overlay)")
    _, sp, _, _ = tr.rasterize_tiles_ref(*[a[:16] for a in inputs[:5]], inputs[5], 128, 128)
    check(torch.equal(composite(raw["rgb"][:16], torch.where(sp >= 0, sp, 0)), rgb[:16]),
          f"{name}: the composite differs from where(keep[seg], raw rgb, overlay) on the plain version's seg")
    kept = float(lut[torch.clamp(seg[..., 0].long(), 0, lut.shape[0] - 1)].float().mean())
    cube_px = (seg[..., 0] == base.cube.per_scene_id).flatten(1).sum(1)
    robot_ids = torch.tensor([link.per_scene_id for link in base.agent.robot.links], device=dev)
    robot_px = torch.isin(seg[..., 0], robot_ids).flatten(1).sum(1)
    check(bool((cube_px > 0).all()), f"{name}: the cube is out of view in {int((cube_px == 0).sum())} envs")
    check(bool((robot_px > 0).all()), f"{name}: the robot is out of view in {int((robot_px == 0).sum())} envs")
    times = raster_times(tr, inputs, 128, 128, 20)
    before = kernel.launches
    frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, 128, 128), 10)
    kernel.launches = before
    paths[f"so100_graspcube_rgbseg_{n_envs}"] = dict(launches=launches, **times)
    print(f"{name}: {n_envs * (n_steps - 1) / step_s:.1f} env-steps/s ({step_s / (n_steps - 1) * 1e3:.2f} ms/step, "
          f"eager, camera jitter on), kernel launches {launches}, the last raw frame of 16 envs re-rendered through "
          f"the plain version: seg agreement {agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal; the composite equal to "
          f"where(keep[seg], raw rgb, overlay) in every env and on the plain seg ({kept:.4f} of the pixels kept); "
          f"cube {int(cube_px.min())}-{int(cube_px.max())} px and robot {int(robot_px.min())}-{int(robot_px.max())} "
          f"px in view in every env; the camera on its mount within {pose_gap:.2g} {card}")
    print_raster_times("so100 grasp cube", f"{n_envs}x128x128", times, card)
    print(f"so100 grasp cube tiled render (raster_setup + raster_tiles): {frame_ms:.4f} ms/frame; faces in "
          f"the scene {inputs[0].shape[1]} {card}")
    return err


def draw_check(torch, dev, env, n_act):
    """DrawTriangle: DRAW_STEPS steps of DRAW_ACTION from a reset. Each step
    advances ``draw_step`` by one and writes the env's dot row min(step,
    MAX_DOTS - 1): the tip's xy on the canvas where it touches, the parked
    pose elsewhere; every env draws. Returns the summary."""
    base = env.unwrapped
    n = base.num_envs
    action = torch.tensor(DRAW_ACTION, device=dev).expand(n, n_act)
    env.reset(seed=1)
    rows = torch.arange(n, device=dev)
    ok, touched = [], []
    for _ in range(DRAW_STEPS):
        step0 = base.scene.data.extras["draw_step"].clone()
        env.step(action)
        d = base.scene.data
        tcp = base.agent.tcp_pose.p
        touching = base._touching(tcp)
        row = d.mocap_pose[rows, base._dot_m0 + torch.clamp(step0, max=base.MAX_DOTS - 1).long()]
        drawn = torch.cat([tcp[:, :2], torch.full_like(tcp[:, :1], base.DOT_THICKNESS / 2 + base.CANVAS_THICKNESS),
                           base._dot_hidden[3:].expand(n, 4)], -1)
        want = torch.where(touching[:, None], drawn, base._dot_hidden)
        ok.append((d.extras["draw_step"] == step0 + 1).all() & (row == want).all())
        touched.append(touching)
    check(bool(torch.stack(ok).all()), "DrawTriangle: draw_step did not advance by one, or a dot row is not the "
                                       "tip's xy (touching) or the parked pose")
    dots = (base.scene.data.mocap_pose[:, base._dot_m0:base._dot_m0 + base.MAX_DOTS, 2] > 0).sum(1)
    hits = base.scene.data.extras["ref_hit"].sum(1)
    check(bool((dots > 0).all()), f"DrawTriangle: the tip drew no dot in {int((dots == 0).sum())} envs")
    touching_steps = torch.stack(touched).float().mean(1)
    return (f"{DRAW_STEPS} steps of the drawing action {DRAW_ACTION}: draw_step advanced by one per step and every "
            f"written dot row is the tip's xy where it touches the canvas (share of envs touching per step: "
            f"{', '.join(f'{float(x):.3f}' for x in touching_steps)}), the parked pose elsewhere; dots drawn per env "
            f"{int(dots.min())}-{int(dots.max())}, reference points hit per env {int(hits.min())}-{int(hits.max())} "
            f"(mean {float(hits.float().mean()):.2f}) of {base.scene.data.extras['ref_hit'].shape[1]}")


def slice14_state_phase(torch, dev, make, card):
    """Phase 42: the drawing, FMB and G1 tasks at SLICE14_ENVS in state mode
    (the drawing tasks with all their ink dots), each with its step profile
    and its first envs against the CPU port; DrawTriangle also draws."""
    n = SLICE14_ENVS
    for uid, n_act in SLICE14_STATE:
        rec = []

        def after(base, i, out):
            if i >= 0:
                rec.append(torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all()
                           & (base.scene.data.contact.overflow == 0).all())

        env = state_cell(torch, dev, make, card, uid, n, SLICE14_STEPS, torch.zeros(n, n_act, device=dev),
                         after=after)
        base = env.unwrapped
        check(bool(torch.stack(rec).all()), f"{uid}: obs or reward not finite, or a contact overflow, in a step")
        line = f"  {uid}: obs and rewards finite and contact.overflow 0 in every env and step"
        if hasattr(base, "MAX_DOTS"):
            line += f"; {base.MAX_DOTS} ink dots per env (mocap rows)"
        if uid == "DrawTriangle-v1":
            line += "; " + draw_check(torch, dev, env, n_act)
        print(line)
        dexterity_cpu_parity(torch, dev, make, uid, base.get_state_dict(), card, qpos_tol=SLICE14_QPOS_TOL)
        del env, base


def slice14_worker(card: str):
    """Phases 42 and 44 in a process of their own. Returns their seconds."""
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    torch.set_num_threads(2)  # the CPU port's parity steps, beside the other processes
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    slice14_state_phase(torch, dev, make, card)
    seconds = {"42": time.perf_counter() - t0}
    t0 = time.perf_counter()
    uid, n_envs = DRAW_PLANNER
    # the JAX package never ran this solution to a rate, so no share is required
    planner_run(torch, dev, make, card, uid, n_envs, "state", seed=0)
    seconds["44"] = time.perf_counter() - t0
    return seconds


def dense_walk(torch, table, height: int, width: int, chunk: int = 64):
    """The kernel's semantics without bands: per pixel of the whole frame,
    every face in id order, a face winning where it covers the pixel with a
    1/z strictly greater than the best so far (from 0). Returns (iz, seg)."""
    B, F, _ = table.shape
    dev = table.device
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, None, None, :]
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[None, None, :, None]
    iz = torch.zeros(B, height, width, device=dev)
    seg = torch.full((B, height, width), -1, dtype=torch.int32, device=dev)
    for j0 in range(0, F, chunk):
        rec = table[:, j0:j0 + chunk]
        c = [rec[..., k][..., None, None] for k in range(13)]
        cover = ((c[0] * px + c[1] * py + c[2] >= 0) & (c[3] * px + c[4] * py + c[5] >= 0)
                 & (c[6] * px + c[7] * py + c[8] >= 0))
        z = c[9] * px + c[10] * py + c[11]
        cand = cover & (z > 0)
        v = torch.where(cand, z, float("-inf"))
        vmax = v.amax(1)
        first = torch.argmax((cand & (v == vmax[:, None])).to(torch.int32), 1)
        better = vmax > iz
        iz = torch.where(better, vmax, iz)
        seg = torch.where(better, torch.gather(rec[..., 12], 1, first.flatten(1)).view_as(seg).to(torch.int32), seg)
    return iz, seg


def draw_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 43: DrawTriangle rgb at its own 320x240 camera through the
    kernel, every ink dot in the scene. Returns the kernel's max depth error
    against the plain version."""
    from maniskill_tpu_torch.utils.timing import cuda_ms

    uid, n_envs, n_steps = DRAW_RGB
    name = f"{uid} rgb x{n_envs}"
    kernel = RasterLaunches(tr)
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb", device=dev)
    base = env.unwrapped
    zero = torch.zeros(n_envs, 7, device=dev)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    cam = base._sensors["base_camera"]
    H, W = cam.config.height, cam.config.width
    print(f"{name}: built and warmed up in {time.perf_counter() - t0:.2f} s; camera {W}x{H}, {base.MAX_DOTS} ink dots "
          f"per env")
    kernel.launches = 0
    env.reset(seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sync_guard(torch, f"{name}, {n_steps} steps"):
        for _ in range(n_steps):
            obs, *_ = env.step(zero)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = kernel.launches
    check(launches == 1 + n_steps, f"{name}: kernel launches {launches} != resets + steps {1 + n_steps}")
    rgb = obs["sensor_data"]["base_camera"]["rgb"]
    check(tuple(rgb.shape) == (n_envs, H, W, 3) and rgb.dtype == torch.uint8, f"{name}: rgb {tuple(rgb.shape)}")
    check(bool(torch.isfinite(obs["agent"]["qpos"]).all()), f"{name}: agent obs not finite")

    # the last frame again, outside the path's count: the whole batch through
    # the kernel, 16 envs through the plain version, DRAW_DENSE_ENVS envs
    # through the unbinned per-face walk
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj, H, W,
                          lights=base.scene.lights)
    before = kernel.launches
    zk, sk, rk, dk = tr.rasterize_tiles(*inputs, H, W)
    kernel.launches = before
    m = 16
    zp, sp, rp, dp = tr.rasterize_tiles_ref(*[a[:m] for a in inputs[:5]], inputs[5], H, W)
    check(int(dk) == 0 and int(dp) == 0, f"{name}: dropped {int(dk)} (kernel), {int(dp)} (plain)")
    check(bool(torch.equal(zk[:m].view(torch.int32), zp.view(torch.int32))), f"{name}: 1/z depth not bit-equal to "
          f"the plain version's, max |d| {float((zk[:m] - zp).abs().max())}")
    check(bool(torch.equal(sk[:m], sp)),
          f"{name}: seg differs from the plain version's on {int((sk[:m] != sp).sum())} px")
    check(bool(torch.equal(rk[:m], rp)), f"{name}: rgb differs from the plain version's")
    check(bool(torch.equal((torch.clamp(rp, 0, 1) * 255).to(torch.uint8), rgb[:m])),
          f"{name}: the rgb obs differs from the plain re-render")
    table, valid = tr.face_records(*inputs)
    _, counts, _ = tr.bin_faces(inputs[0], inputs[1], valid, H, W)
    q = DRAW_DENSE_ENVS
    _, dense_seg = dense_walk(torch, table[:q], H, W)
    differ = int((dense_seg != sk[:q]).sum())
    check(differ == 0, f"{name}: seg differs from the unbinned per-face walk on {differ} px of {q} envs")
    full = int(counts.max())
    print(f"{name}: {n_envs * n_steps / step_s:.1f} env-steps/s ({step_s / n_steps * 1e3:.2f} ms/step, eager), "
          f"kernel launches {launches}, 0 host syncs in {n_steps} steps, dropped 0; the last frame of {m} envs "
          f"re-rendered through the plain version: 1/z bit-equal, seg and rgb equal; of {q} envs through an "
          f"unbinned per-face walk over the whole frame: seg equal on every pixel; the fullest band's list "
          f"{full} entries (after the timed loop; {1024} was the reference's cap) {card}")
    times = raster_times(tr, inputs, H, W, 20, plain_envs=m)
    before = kernel.launches
    frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, H, W), 5)
    kernel.launches = before
    paths[f"drawtriangle_rgb_{n_envs}"] = dict(launches=launches, **times)
    print_raster_times("draw triangle", f"{n_envs}x{H}x{W}", times, card)
    print(f"draw triangle tiled render (raster_setup + raster_tiles): {frame_ms:.4f} ms/frame; faces per band: "
          f"mean {counts.float().mean().item():.1f}, max {full}, faces in the scene {inputs[0].shape[1]} {card}")
    return float((zk[:m] - zp).abs().max())


def _set_cabinet_assets(partnet: bool):
    """Point the cabinet envs at the PartNet-Mobility fixture, or at the
    procedural cabinets."""
    import os

    from maniskill_tpu_torch.building.articulations import partnet_mobility

    if partnet:
        os.environ["MS_ASSET_DIR"] = os.path.abspath(PARTNET_ASSET_DIR)
        os.environ.pop("MS_PARTNET_CABINETS", None)
    else:
        os.environ["MS_PARTNET_CABINETS"] = "0"
    partnet_mobility.load_partnet_mobility_dataset(refresh=True)


def _timed_method(torch, owner, name, spent):
    """``owner.name`` wrapped to add its synchronized seconds to
    ``spent[name]`` (for ``unittest.mock.patch.object``)."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spent[name] += time.perf_counter() - t0
        return out

    return wrapper


def locked_slot_experiment(torch, env, limits, active, zero, n_steps):
    """Every slot set to 0.9 of its range from shut (its far limit), a locked
    one 0.05 past its [0, 0], then ``n_steps`` zero-action steps. Returns
    (locked slots' largest |q|, active slots' smallest opening over their
    target, each env's largest drift of the Fetch's base joints from the
    reset, each env's largest robot-cabinet contact force and the nearest
    the robot came to the cabinet (the largest depth of their contact rows,
    negative apart) at the end of a step), the last three as numpy."""
    from maniskill_tpu_torch.agents.robots.fetch.fetch import BASE_JOINT_NAMES

    base = env.unwrapped
    dev = base.device
    env.reset(seed=0)
    far = np.where(np.abs(limits[..., 0]) > np.abs(limits[..., 1]), limits[..., 0], limits[..., 1])
    target = np.where(active, 0.9 * far, 0.05).astype(np.float32)
    slots = torch.as_tensor(base.cab_meta.slot_qadrs.astype(np.int64), device=dev)
    cols = [base.agent.robot.joints_map[n].q_adr for n in BASE_JOINT_NAMES]
    data = base.scene.data
    start = data.qpos[:, cols].clone()
    qpos = data.qpos.clone()
    qpos[:, slots] = torch.as_tensor(target, device=dev)
    base.scene.data = data.replace(qpos=qpos)
    touch = torch.zeros(base.num_envs, device=dev)
    near = torch.full((base.num_envs,), -np.inf, device=dev)
    gb = np.asarray(base.scene.model.geom_body)
    robot = [link.body_id for link in base.agent.robot.links]
    cabinet = [link.body_id for link in base.cabinet.links]
    for _ in range(n_steps):
        env.step(zero)
        force = base.scene.get_pairwise_contact_forces(base.agent.robot, base.cabinet)
        touch = torch.maximum(touch, torch.linalg.vector_norm(force, dim=-1))
        c = base.scene.data.contact
        b1, b2 = gb[np.asarray(c.geom1)], gb[np.asarray(c.geom2)]
        rows = np.nonzero((np.isin(b1, robot) & np.isin(b2, cabinet)) | (np.isin(b1, cabinet) & np.isin(b2, robot)))[0]
        if len(rows):
            near = torch.maximum(near, c.depth[:, torch.as_tensor(rows, device=dev)].amax(1))
    qpos = base.scene.data.qpos
    qs = qpos[:, slots].cpu().numpy()
    drift = (qpos[:, cols] - start).abs().amax(1).cpu().numpy()
    locked = float(np.abs(qs[~active]).max()) if (~active).any() else 0.0
    held = float((qs[active] / target[active]).min())
    return locked, held, drift, touch.cpu().numpy(), near.cpu().numpy()


def cabinet_state_phase(torch, dev, make, card):
    """Phase 26: OpenCabinetDrawer/Door state at 4096 envs with the Fetch,
    procedural cabinets, then the drawer task on the PartNet-Mobility
    fixture's models."""
    from unittest import mock

    from maniskill_tpu_torch.building.articulations.cabinet import CABINET_VARIANTS
    from maniskill_tpu_torch.envs.scene import ManiSkillScene
    from maniskill_tpu_torch.envs.tasks.mobile_manipulation.open_cabinet_drawer import OpenCabinetBase

    n = CABINET_ENVS
    zero = torch.zeros(n, CABINET_ACTION, device=dev)
    for uid, partnet in CABINET_STATE:
        name = f"{uid} {'PartNet-Mobility' if partnet else 'procedural'}"
        _set_cabinet_assets(partnet)
        rec = []

        def after(base, i, out):
            if i >= 0:
                rec.append(torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all())

        spent = collections.defaultdict(float)
        with mock.patch.object(OpenCabinetBase, "_after_reconfigure",
                               _timed_method(torch, OpenCabinetBase, "_after_reconfigure", spent)), \
                mock.patch.object(ManiSkillScene, "set_per_env_hulls",
                                  _timed_method(torch, ManiSkillScene, "set_per_env_hulls", spent)):
            env = state_cell(torch, dev, make, card, uid, n, CABINET_STEPS, zero, after=after)
        base = env.unwrapped
        check(base._use_partnet == partnet, f"{name}: built the other cabinet path")
        check(bool(torch.stack(rec).all()), f"{name}: obs or reward not finite in a step")
        if partnet:
            drawn, allowed = set(base._pn_model_ids), set(base._pn_ids)
            limits, active = base._pn_assign.limits, base._pn_assign.active
        else:
            drawn = {CABINET_VARIANTS[v]["name"] for v in base.cab_inst.variant_ids}
            allowed = {v["name"] for v in CABINET_VARIANTS if base._variant_ok(v)}
            limits, active = base.cab_inst.limits, base.cab_inst.active
        check(drawn == allowed, f"{name}: {sorted(drawn)} drawn of the allowed {sorted(allowed)}")
        locked, held, drift, touch, near = locked_slot_experiment(torch, env, limits, active, zero,
                                                                  CABINET_LOCK_STEPS)
        check(locked < CABINET_LOCK_TOL, f"{name}: a locked slot at {locked:.3g} after {CABINET_LOCK_STEPS} steps")
        check(held > CABINET_HOLD_FRAC, f"{name}: an active slot kept only {held:.4f} of its opening")
        # the reset puts the Fetch just behind the cabinet (a fault of the
        # JAX package's task, ROADMAP section 3): where the robot touches the
        # cabinet the contact pushes the base; where it stays CABINET_CLEARANCE
        # away at every step's end the base holds
        free = near < -CABINET_CLEARANCE
        check(free.any(), f"{name}: the robot comes within {CABINET_CLEARANCE} m of the cabinet in every env")
        free_drift = float(drift[free].max())
        check(free_drift < CABINET_BASE_TOL,
              f"{name}: the Fetch's base drifted {free_drift:.3g} under zero base action, clear of the cabinet")
        touching = (f"; in the {int((~free).sum())} envs where the robot comes nearer the cabinet (pressing up "
                    f"to {float(touch.max()):.1f} N) the base drifted up to {float(drift[~free].max()):.4g}"
                    if (~free).any() else ", the robot nearer the cabinet in no env")
        hulls = f", set_per_env_hulls {spent['set_per_env_hulls']:.2f} s of it" if partnet else ""
        print(f"  {name}: _after_reconfigure {spent['_after_reconfigure']:.2f} s of the make{hulls}; obs and "
              f"rewards finite in every step; all {len(allowed)} allowed {'models' if partnet else 'variants'} "
              f"drawn; locked-slot experiment in all {n} envs: locked slots within {locked:.3g} of shut "
              f"(tolerance {CABINET_LOCK_TOL}), active slots kept {held:.4f} of their opening (bound "
              f"{CABINET_HOLD_FRAC}) after {CABINET_LOCK_STEPS} steps; the Fetch's base joints within "
              f"{free_drift:.3g} of their reset values in the {int(free.sum())} envs where the robot stays "
              f"{CABINET_CLEARANCE} m from the cabinet (tolerance {CABINET_BASE_TOL}){touching} {card}")
        del env, base
    _set_cabinet_assets(False)


def cabinet_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 27: OpenCabinetDrawer-v1 rgb at 2048 envs, three cameras (the
    fixed base camera and the Fetch's head and hand cameras). Returns the
    kernel's max depth error against the plain version."""
    from maniskill_tpu_torch.utils.geometry import rotation_conversions as rc
    from maniskill_tpu_torch.utils.timing import cuda_ms, timed_steps

    uid, n_envs, n_steps = CABINET_RGB
    _set_cabinet_assets(False)
    kernel = RasterLaunches(tr)
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb", device=dev)
    base = env.unwrapped
    zero = torch.zeros(n_envs, CABINET_ACTION, device=dev)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    print(f"{uid} rgb x{n_envs}: built and warmed up in {time.perf_counter() - t0:.2f} s")
    cams = list(base._sensors)
    check(cams == ["base_camera", "fetch_head", "fetch_hand"], f"{uid} rgb: cameras {cams}")
    kernel.launches = 0
    env.reset(seed=0)
    step_s = timed_steps(env, zero, n_steps - 1)
    obs, *_ = env.step(zero)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == len(cams) * (1 + n_steps),
          f"{uid} rgb: kernel launches {launches} != cameras x (resets + steps) {len(cams) * (1 + n_steps)}")
    check(int(base.scene.data.contact.overflow.max()) == 0, f"{uid} rgb: contact overflow")
    err = 0.0
    for cam_name in cams:
        rgb = obs["sensor_data"][cam_name]["rgb"]
        check(tuple(rgb.shape) == (n_envs, 128, 128, 3) and rgb.dtype == torch.uint8,
              f"{uid} {cam_name} rgb is {tuple(rgb.shape)} {rgb.dtype}")
        inputs, e, agree = rerender_check(base, cam_name, 16, tr, tiled_inputs, geom_poses, rgb,
                                          f"{uid} {cam_name}")
        err = max(err, e)
        print(f"{uid} rgb {cam_name}: last frame of 16 envs re-rendered through the plain version: seg "
              f"agreement {agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal; faces in the scene {inputs[0].shape[1]}")
        if cam_name == "base_camera":
            times = raster_times(tr, inputs, 128, 128, 20)
            before = kernel.launches
            frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, 128, 128), 10)
            kernel.launches = before
            paths[f"opencabinetdrawer_rgb_{n_envs}"] = dict(launches=launches, **times)
            print_raster_times("open cabinet drawer base camera", f"{n_envs}x128x128", times, card)
            print(f"open cabinet drawer tiled render (raster_setup + raster_tiles): {frame_ms:.4f} ms/frame "
                  f"{card}")
            del times
        del inputs
    rate = n_envs * (n_steps - 1) / step_s
    print(f"{uid} rgb x{n_envs}: {rate:.1f} env-steps/s ({step_s / (n_steps - 1) * 1e3:.2f} ms/step, eager, three "
          f"128x128 cameras), kernel launches {launches}; ManiSkill 3 on an RTX 4090: {CABINET_RGB_4090_FPS} fps "
          f"(BASELINE.md, a record and not a limit) {card}")

    # the cabinet and the robot in the base camera's view
    cam = base._sensors["base_camera"]
    before = kernel.launches
    seg = cam.get_obs(rgb=False, segmentation=True, hidden_actors=base._hidden_objects)["segmentation"][..., 0]
    cab_ids = torch.tensor([link.per_scene_id for link in base.cabinet.links], device=dev)
    robot_ids = torch.tensor([link.per_scene_id for link in base.agent.robot.links], device=dev)
    cab_seen = torch.isin(seg, cab_ids).flatten(1).any(1).float().mean().item()
    robot_seen = torch.isin(seg, robot_ids).flatten(1).any(1).float().mean().item()
    check(cab_seen == 1.0, f"{uid} rgb: the cabinet in view in only {cab_seen:.4f} of the envs")
    check(robot_seen == 1.0, f"{uid} rgb: the robot in view in only {robot_seen:.4f} of the envs")

    # two envs holding different variants, robot and cabinet set to one pose:
    # their cabinet masks differ
    vids = np.asarray(base.cab_inst.variant_ids)
    i, j = 0, int(np.nonzero(vids != vids[0])[0][0])
    state = base.get_state_dict()
    for art in (base.cabinet.name, base.agent.robot.name):
        s = state["articulations"][art].clone()
        s[j] = s[i]
        state["articulations"][art] = s
    base.set_state_dict(state)
    seg = cam.get_obs(rgb=False, segmentation=True, hidden_actors=base._hidden_objects)["segmentation"][..., 0]
    mask_i, mask_j = torch.isin(seg[i], cab_ids), torch.isin(seg[j], cab_ids)
    n_i, n_j, n_diff = int(mask_i.sum()), int(mask_j.sum()), int((mask_i != mask_j).sum())
    check(n_i > 0 and n_j > 0 and n_diff > 0, f"{uid}: envs {i} and {j} (variants {vids[i]}, {vids[j]}) at one "
                                              f"pose: cabinet masks of {n_i} and {n_j} px differ on {n_diff}")

    # the mounted cameras ride the moving base: each camera's pose is its
    # link's pose times the mount offset, composed here from rotation matrices
    drive = zero.clone()
    drive[:, 11] = 1.0  # forward
    drive[:, 12] = 0.5  # and turning
    q0 = base.agent.robot.qpos[:, :3].clone()
    for _ in range(3):
        env.step(drive)
    moved = (base.agent.robot.qpos[:, :3] - q0).abs().max().item()
    check(moved > 1e-2, f"{uid} rgb: the base moved only {moved:.3g} under a forward base action")
    kernel.launches = before  # the view checks and the drive are not main-path launches
    mount_err = {}
    for cam_name in ("fetch_head", "fetch_hand"):
        c = base._sensors[cam_name]
        off = torch.as_tensor(np.asarray(c.config.pose, np.float32), device=dev)
        link = c.config.mount.pose
        r_link = rc.quaternion_to_matrix(link.q)
        want_p = link.p + torch.einsum("bij,j->bi", r_link, off[:3])
        want_r = r_link @ rc.quaternion_to_matrix(off[3:])
        pose = c.world_pose()
        mount_err[cam_name] = max((pose.p - want_p).abs().max().item(),
                                  (rc.quaternion_to_matrix(pose.q) - want_r).abs().max().item())
    check(mount_err["fetch_head"] <= CAMERA_MOUNT_TOL,
          f"{uid} rgb: fetch_head off its link's pose times the mount by {mount_err['fetch_head']:.3g}")
    check(mount_err["fetch_hand"] <= 10 * CAMERA_MOUNT_TOL,
          f"{uid} rgb: fetch_hand off its link's pose times the mount by {mount_err['fetch_hand']:.3g}")
    print(f"{uid} rgb: the cabinet and the robot in view of base_camera in every env; envs {i} and {j} (variants "
          f"{vids[i]}, {vids[j]}) at one pose: cabinet masks of {n_i} and {n_j} px, differing on {n_diff} px; "
          f"after the base moved up to {moved:.4f}, fetch_head on its link's pose times the mount within "
          f"{mount_err['fetch_head']:.3g} (tolerance {CAMERA_MOUNT_TOL}), fetch_hand within "
          f"{mount_err['fetch_hand']:.3g} (tolerance {10 * CAMERA_MOUNT_TOL:g})")
    return err


def ppo_rgbd_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses):
    """Phase 29: visual PPO on PushCube rgbd (a depth tower beside the rgb
    one). Returns the kernel's launches in the timed iterations, the last
    frame's inputs (on the host, for the kernel's times taken alone) and its
    max depth error against the plain version."""
    kernel = RasterLaunches(tr)
    env, trainer, obs, launches = ppo_phase(torch, dev, make, card, "rgbd", PPO_RGBD, kernel,
                                            profile_steps=PPO_RGBD_PROFILE_STEPS)
    base, n_envs, name = env.unwrapped, PPO_RGBD[1], "pushcube ppo rgbd"
    depth = obs["depth"]
    check(tuple(depth.shape) == (n_envs, 128, 128, 1) and depth.dtype == torch.int16,
          f"{name}: depth obs is {tuple(depth.shape)} {depth.dtype}")
    # the table and the robot fill the lower half of the base camera's view
    check(bool((depth[:, 64:] > 0).all()), f"{name}: depth 0 where the table is in view")
    net = trainer.model.feature_net
    check(net.image_keys == ("rgb", "depth"), f"{name}: the policy's towers are {net.image_keys}")
    with torch.no_grad():
        feats = net(obs)
        blind = net(dict(obs, depth=torch.zeros_like(depth)))
    depth_feats = slice(256, 512)  # rgb, depth, state features of 256 each
    check(bool(torch.isfinite(feats).all()), f"{name}: the features are not finite")
    check(not bool(torch.equal(feats[:, depth_feats], blind[:, depth_feats])), f"{name}: the depth tower ignores depth")
    inputs, err, agree = rerender_check(base, "base_camera", 16, tr, tiled_inputs, geom_poses, obs["rgb"], name,
                                        depth=depth)
    print(f"{name}: the depth obs int16 mm, nonzero below the horizon in every env (max {int(depth.max())} mm); "
          f"depth features finite and moved by the depth; the last frame of 16 envs re-rendered through the plain "
          f"version: int16 depth equal, seg agreement {agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal {card}")
    return launches, [x.cpu() if isinstance(x, torch.Tensor) else x for x in inputs], err


def ppo_late_worker(card: str):
    """Phases 28 and 29 (PPO, host-bound) in a process of their own beside
    phases 32-38. Returns their seconds and phase 29's kernel launches, last
    frame's inputs and max error."""
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ppo_phase(torch, dev, make, card, "state", PPO_CABINET, None, profile_steps=PPO_CABINET_PROFILE_STEPS)
    t1 = time.perf_counter()
    rgbd = ppo_rgbd_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses)
    return {"28": t1 - t0, "29": time.perf_counter() - t1}, rgbd


def _rel_err(a, b):
    """max |a - b| over max(1, max |a|)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(1.0, float(a.abs().max()))


def _check_params(torch, name, cpu_module, dev_module, bound):
    """The card's params within ``bound`` of the CPU's everywhere and within
    UPDATE_PARAM_TOL on UPDATE_PARAM_SHARE of the entries."""
    diffs = torch.cat([(a.detach().double() - b.detach().double().cpu()).abs().ravel()
                       for a, b in zip(cpu_module.parameters(), dev_module.parameters())])
    share = float((diffs <= UPDATE_PARAM_TOL).double().mean())
    check(float(diffs.max()) <= bound and share >= UPDATE_PARAM_SHARE,
          f"{name}: the card's params part from the CPU's by up to {float(diffs.max()):.3g} "
          f"({share:.5f} within {UPDATE_PARAM_TOL})")
    return float(diffs.max()), share


def sac_update_parity(torch, dev, make, card):
    """One SAC update on the card and on the CPU from one host state (the
    trainers' seeded init, a ring of numpy draws) and host draws."""
    from maniskill_tpu_torch.parallel.sac import SACConfig, SACTrainer

    rng = np.random.default_rng(0)
    config, uid = SACConfig(), SAC_CELL[0]
    trainers = []  # the CPU's, the card's
    for d in ("cpu", dev):
        env = make(uid, num_envs=SAC_PARITY_ENVS, obs_mode="state", device=d)
        obs, _ = env.reset(seed=0)
        trainers.append(SACTrainer(env, config, obs.shape[-1], seed=2))
    tr = trainers[0]
    S, B, D, A, bs = config.buffer_steps, SAC_PARITY_ENVS, tr.buf_obs.shape[-1], tr.act_dim, config.batch_size
    state = dict(buf_obs=rng.normal(size=(S, B, D)), buf_act=rng.uniform(-1, 1, (S, B, A)),
                 buf_rew=rng.uniform(0, 1, (S, B)), buf_next_obs=rng.normal(size=(S, B, D)),
                 buf_term=rng.uniform(size=(S, B)) < 0.1)
    draws = dict(idx=rng.integers(0, S * B, bs), eps_q=rng.normal(size=(bs, A)), eps_pi=rng.normal(size=(bs, A)))
    losses = []
    for t in trainers:
        for k, v in state.items():
            setattr(t, k, torch.as_tensor(v, dtype=torch.bool if v.dtype == bool else torch.float32, device=t.device))
        t.filled = S
        losses.append(t.update_once({k: torch.as_tensor(v, dtype=torch.int64 if k == "idx" else torch.float32,
                                                      device=t.device) for k, v in draws.items()}))
    torch.cuda.synchronize()
    cpu, card_tr = trainers
    errs = {"q loss": _rel_err(losses[0][0], losses[1][0]), "actor loss": _rel_err(losses[0][1], losses[1][1]),
            "log_alpha grad": _rel_err(cpu.log_alpha.grad, card_tr.log_alpha.grad)}
    for what in ("actor", "qnet"):
        for (k, a), b in zip(getattr(cpu, what).named_parameters(), getattr(card_tr, what).parameters()):
            errs[f"{what}.{k} grad"] = _rel_err(a.grad, b.grad)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= UPDATE_LOSS_TOL, f"sac update, card vs CPU: {worst} parts by {errs[worst]:.3g} relative")
    check(abs(float(cpu.log_alpha.detach()) - float(card_tr.log_alpha.detach())) <= 1e-6, "sac update, card vs CPU: log_alpha parts")
    bound = 2 * config.lr
    dmax = max(_check_params(torch, f"sac update {what}", getattr(cpu, what), getattr(card_tr, what), bound)[0]
               for what in ("actor", "qnet", "q_target"))
    print(f"sac update_once on the card == the CPU port's from one host state and draws ({SAC_PARITY_ENVS} envs, "
          f"batch {bs}): losses and gradients within {errs[worst]:.3g} relative (bound {UPDATE_LOSS_TOL}, "
          f"worst {worst}); params within {dmax:.3g} (bound {bound:.1e}) {card}")


def sac_phase(torch, dev, make, card):
    """Phase 30: SAC on PushCube state through ``SACTrainer.train_step`` at
    the CLI's defaults: collect and update ms, env-steps/s, one profiled
    learning step (0 syncs, 0 host-to-device copies), the greedy
    evaluation, and one update held to the CPU port's."""
    from maniskill_tpu_torch.parallel.sac import SACConfig, SACTrainer, evaluate
    from maniskill_tpu_torch.utils.timing import cuda_ms, profile_calls

    uid, n_envs, warmup, learn_steps = SAC_CELL
    name = f"sac state {uid} x{n_envs}"
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="state", device=dev)
    obs, _ = env.reset(seed=1)
    config = SACConfig()
    trainer = SACTrainer(env, config, obs.shape[-1], seed=1)
    elapsed = torch.zeros(n_envs, dtype=torch.int32, device=dev)
    before = [p.detach().clone() for p in trainer.actor.parameters()]
    torch.cuda.synchronize()
    print(f"{name}: env and trainer built in {time.perf_counter() - t0:.2f} s {card}")
    step_s = []
    for it in range(warmup + learn_steps):
        t0 = time.perf_counter()
        obs, elapsed, metrics = trainer.train_step(obs, elapsed, learn=it >= warmup)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    m = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in m.values()), f"{name}: metrics {m}")
    params = list(trainer.actor.parameters()) + list(trainer.qnet.parameters())
    check(all(bool(torch.isfinite(p).all()) for p in params), f"{name}: non-finite params")
    check(any(not bool(torch.equal(a, b)) for a, b in zip(before, trainer.actor.parameters())),
          f"{name}: the actor did not change")
    check(trainer.filled == (warmup + learn_steps) * config.rollout_steps, f"{name}: ring filled {trainer.filled}")
    collect_ms = float(np.median(step_s[1:warmup])) * 1e3  # the first step initializes the libraries
    update_ms = cuda_ms(lambda: trainer.update_once(), config.utd)
    learn_s = sum(step_s[warmup:])
    print(f"{name}: q_loss {m['q_loss']:.4f} actor_loss {m['actor_loss']:.4f} alpha {m['alpha']:.4f} {card}")
    print(f"{name} rate: {n_envs * config.rollout_steps * learn_steps / learn_s:.1f} env-steps/s over "
          f"{learn_steps} learning train steps ({learn_s / learn_steps * 1e3:.1f} ms each); collect "
          f"{collect_ms:.1f} ms per train step ({config.rollout_steps} control steps), update_once "
          f"{update_ms:.2f} ms (x{config.utd} per train step, batch {config.batch_size}) {card}")
    out = []
    _, prof = profile_calls(lambda: out.append(trainer.train_step(obs, elapsed, learn=True)), 1)
    obs, elapsed, _ = out[0]
    print(f"{name} profile of one learning train step: {prof['launches']:.0f} launches, {prof['syncs']:.0f} "
          f"stream/event syncs, {prof['h2d_copies']:.0f} host-to-device copies, device kernels "
          f"{prof['device_kernel_ms']:.3f} ms of {prof['wall_ms']:.3f} ms (idle {prof['device_idle_share']:.3f}) {card}")
    check(prof["syncs"] == 0, f"{name}: the train step syncs with the device")
    check(prof["h2d_copies"] == 0, f"{name}: the train step copies host to device")
    t0 = time.perf_counter()
    success, mean_reward = evaluate(env, trainer.actor, seed=1001)
    rate = float(success.float().mean())
    check(np.isfinite(float(mean_reward)), f"{name}: eval reward {float(mean_reward)}")
    print(f"{name}: greedy eval over 60 steps: success(any) {rate:.6f} mean_reward {float(mean_reward):.4f} "
          f"in {time.perf_counter() - t0:.2f} s {card}")
    del env, trainer
    sac_update_parity(torch, dev, make, card)


def planner_flops(cfg, n_envs: int, act_dim: int, iterations: int) -> float:
    """Float32 operations (2 per multiply-add) of one plan's matrix
    products: per sample and iteration the value estimate (H x (dynamics +
    reward head), the policy's mean, the Q heads), plus the policy-prior
    trajectories (H x (policy + dynamics))."""
    L, M, A, nb, H = cfg.latent_dim, cfg.mlp_dim, act_dim, cfg.num_bins, cfg.horizon
    dyn = (L + A) * M + M * M + M * L
    rew = q_head = (L + A) * M + M * M + M * nb
    pi_mean, pi = L * M + M * M + M * A, L * M + M * M + 2 * M * A
    value = H * (dyn + rew) + pi_mean + cfg.num_q * q_head
    return 2.0 * n_envs * (cfg.num_samples * iterations * value + cfg.num_pi_trajs * H * (pi + dyn))


def tdmpc2_plan_parity(torch, dev, make, card, trainer):
    """One plan on the card and on the CPU port from the card trainer's
    weights, host latents, a host warm start and host draws."""
    from maniskill_tpu_torch.parallel.tdmpc2 import TDMPC2Trainer

    rng = np.random.default_rng(0)
    env = make(TDMPC2_CELL[0], num_envs=TDMPC2_PARITY_ENVS, obs_mode="state", device="cpu")
    obs, _ = env.reset(seed=0)
    cpu = TDMPC2Trainer(env, trainer.config, obs.shape[-1])
    cpu.model.load_state_dict(trainer.model.state_dict())
    cpu.pi.load_state_dict(trainer.pi.state_dict())
    cfg, B, A = trainer.config, TDMPC2_PARITY_ENVS, trainer.act_dim
    H, N, P, E = cfg.horizon, cfg.num_samples, cfg.num_pi_trajs, cfg.num_elites
    with torch.no_grad():
        z = cpu.model.enc(torch.as_tensor(rng.normal(size=(B, obs.shape[-1])), dtype=torch.float32))
    host = dict(z=z, t0=torch.tensor([True, False] * (B // 2)),
                prev_mean=torch.as_tensor(rng.uniform(-1, 1, (B, H, A)), dtype=torch.float32))
    draws = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in dict(
        pi_eps=rng.normal(size=(H, B, P, A)), noise=rng.normal(size=(trainer.iterations, B, H, N - P, A)),
        gumbel=-np.log(-np.log(rng.uniform(1e-30, 1, (B, E)))), explore=rng.normal(size=(B, A))).items()}
    outs = []  # the CPU's, the card's
    for t in (cpu, trainer):
        args = {k: v.to(t.device) for k, v in host.items()}
        outs.append(t.plan(args["z"], args["t0"], args["prev_mean"], eval_mode=False,
                           draws={k: v.to(t.device) for k, v in draws.items()}))
    errs = [float((a - b.cpu()).abs().max()) for a, b in zip(*outs)]
    check(max(errs) <= PLAN_TOL, f"tdmpc2 plan, card vs CPU: action and mean part by {errs}")
    print(f"tdmpc2 plan on the card == the CPU port's from host latents and draws ({B} envs, {N} samples, "
          f"{trainer.iterations} iterations): action within {errs[0]:.3g}, mean within {errs[1]:.3g} "
          f"(bound {PLAN_TOL}) {card}")


def tdmpc2_phase(torch, dev, make, card):
    """Phase 31: TD-MPC2 on PushCube state through
    ``TDMPC2Trainer.train_step`` at the CLI's defaults: the planner's ms
    per control step against its float32 bound, update ms, env-steps/s, one
    profiled learning step (0 syncs, 0 host-to-device copies), actions in
    [-1, 1], and one plan held to the CPU port's."""
    from maniskill_tpu_torch.parallel.tdmpc2 import TDMPC2Config, TDMPC2Trainer
    from maniskill_tpu_torch.utils.gym_utils import find_max_episode_steps_value
    from maniskill_tpu_torch.utils.timing import cuda_ms, profile_calls

    uid, n_envs, warmup, learn_steps = TDMPC2_CELL
    name = f"tdmpc2 state {uid} x{n_envs}"
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="state", device=dev)
    obs, _ = env.reset(seed=1)
    ep_len = find_max_episode_steps_value(env)
    config = TDMPC2Config(buffer_steps=(max(1000, ep_len) // ep_len) * ep_len)  # the CLI's ring
    trainer = TDMPC2Trainer(env, config, obs.shape[-1], seed=1)
    check(warmup * config.rollout_steps >= ep_len, f"{name}: the warm-up does not fill an episode")
    elapsed = torch.zeros(n_envs, dtype=torch.int32, device=dev)
    before = [p.detach().clone() for p in trainer.pi.parameters()]
    torch.cuda.synchronize()
    print(f"{name}: env and trainer built in {time.perf_counter() - t0:.2f} s {card}")
    step_s = []
    for it in range(warmup + learn_steps):
        t0 = time.perf_counter()
        obs, elapsed, metrics = trainer.train_step(obs, elapsed, learn=it >= warmup)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    m = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in m.values()), f"{name}: metrics {m}")
    check(all(bool(torch.isfinite(p).all()) for p in trainer.model.parameters()), f"{name}: non-finite params")
    check(any(not bool(torch.equal(a, b)) for a, b in zip(before, trainer.pi.parameters())),
          f"{name}: the policy did not change")
    filled = trainer.filled
    check(float(trainer.buf_act[:filled].abs().max()) <= 1.0, f"{name}: a planned action outside [-1, 1]")
    z, t0_mask = trainer.model.enc(obs).detach(), elapsed == 0
    plan_ms = cuda_ms(lambda: trainer.plan(z, t0_mask, trainer.prev_mean), 5)
    bound_ms = planner_flops(config, n_envs, trainer.act_dim, trainer.iterations) / PEAK_FP32_FLOPS * 1e3
    _, plan_prof = profile_calls(lambda: trainer.plan(z, t0_mask, trainer.prev_mean), 1)
    update_ms = cuda_ms(lambda: trainer.update_once(), config.num_updates)
    learn_s = sum(step_s[warmup:])
    print(f"{name}: consistency {m['consistency_loss']:.4f} reward {m['reward_loss']:.4f} value "
          f"{m['value_loss']:.4f} pi {m['pi_loss']:.4f} q_scale {m['q_scale']:.4f} {card}")
    print(f"{name} rate: {n_envs * config.rollout_steps * learn_steps / learn_s:.1f} env-steps/s over "
          f"{learn_steps} learning train steps ({learn_s / learn_steps * 1e3:.1f} ms each; warm-up steps "
          f"{float(np.median(step_s[1:warmup])) * 1e3:.1f} ms); planner {plan_ms:.2f} ms per control step "
          f"({n_envs} envs x {config.num_samples} samples x {trainer.iterations} iterations, horizon "
          f"{config.horizon}) against a float32 bound of {bound_ms:.2f} ms (operations, "
          f"{bound_ms / plan_ms:.3f} of it), {plan_prof['launches']:.0f} launches, device kernels "
          f"{plan_prof['device_kernel_ms']:.3f} ms of {plan_prof['wall_ms']:.3f} ms (idle "
          f"{plan_prof['device_idle_share']:.3f}); update_once {update_ms:.2f} ms (batch {config.batch_size}) {card}")
    out = []
    _, prof = profile_calls(lambda: out.append(trainer.train_step(obs, elapsed, learn=True)), 1)
    print(f"{name} profile of one learning train step ({config.rollout_steps} planned control steps, "
          f"{config.num_updates} updates): {prof['launches']:.0f} launches, {prof['syncs']:.0f} stream/event "
          f"syncs, {prof['h2d_copies']:.0f} host-to-device copies, device kernels {prof['device_kernel_ms']:.3f} ms "
          f"of {prof['wall_ms']:.3f} ms (idle {prof['device_idle_share']:.3f}) {card}")
    top = ", ".join(f"{k} {v:.2f}" for k, v in list(prof["top_kernels_ms"].items())[:5])
    print(f"{name} top kernels (ms per train step): {top} {card}")
    check(prof["syncs"] == 0, f"{name}: the train step syncs with the device")
    check(prof["h2d_copies"] == 0, f"{name}: the train step copies host to device")
    tdmpc2_plan_parity(torch, dev, make, card, trainer)


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _h5_leaves(group, prefix=""):
    from maniskill_tpu_torch.utils import h5

    for k, v in group.items():
        if isinstance(v, h5.Group):
            yield from _h5_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def record_phase(torch, dev, make, card, tmp, pool):
    """Phase 32: the planner CLI records PickCube @1024 (``run.py
    --save-traj``); once the file exists phase 33's per-episode replays
    start in ``pool``, and the file is read back through the port's h5
    reader. Returns (the .h5 path, the replays' futures, the converted
    file's path)."""
    import os

    from maniskill_tpu_torch.examples.motionplanning import run
    from maniskill_tpu_torch.utils import h5
    from maniskill_tpu_torch.utils.timing import profile_calls
    from maniskill_tpu_torch.wrappers.record import RecordEpisode

    uid, n_envs = RECORD_CELL
    name = f"record {uid} x{n_envs}"
    argv = ["--env-id", uid, "--num-envs", str(n_envs), "--seed", "0"]
    plain, _ = _quiet(run.main, argv)
    rec, _ = _quiet(run.main, argv + ["--save-traj", "--output-dir", tmp])
    path = os.path.join(tmp, f"mp_{uid}.h5")
    size_mb = os.path.getsize(path) / 1e6
    flush = rec["flush"]
    success = rec["success"][0].cpu().numpy()
    print(f"{name}: planner CLI {plain['wall_s'][0]:.2f} s without recording, {rec['wall_s'][0]:.2f} s with "
          f"(success {success.mean():.6f} and {plain['success'][0].float().mean().item():.6f}); the flush: "
          f"{flush['d2h_bytes'] / 1e6:.2f} MB device to host in {flush['d2h_seconds']:.3f} s, written in "
          f"{flush['write_seconds']:.2f} s, {flush['flushes']} flush(es); the file {size_mb:.2f} MB {card}")
    futures, converted = episode_replays_start(pool, path, tmp)
    with open(path.replace(".h5", ".json")) as f:
        meta = json.load(f)
    episodes = meta["episodes"]
    check(len(episodes) == n_envs, f"{name}: {len(episodes)} episodes in the JSON")
    check([e["success"] for e in episodes] == success.tolist(), f"{name}: the JSON's success flags differ from "
                                                                "the planner's")
    env = make(uid, num_envs=n_envs, obs_mode="state", control_mode="pd_joint_pos", device=dev)
    env.reset(seed=0)
    reset_state = {k: v.cpu().numpy() for k, v in _flat_state(env.unwrapped.get_state_dict())}
    t0 = time.perf_counter()
    with h5.File(path) as f:
        keys = [k for k in f.keys() if k.startswith("traj_")]
        check(len(keys) == n_envs, f"{name}: the port's reader finds {len(keys)} traj_ groups")
        for i, e in enumerate(episodes):
            traj = f[f"traj_{e['episode_id']}"]
            T = e["elapsed_steps"]
            check(traj["actions"].shape[0] == T, f"{name}: traj_{i} holds {traj['actions'].shape[0]} actions")
            for key, ds in _h5_leaves(traj["env_states"]):
                check(ds.shape[0] == T + 1, f"{name}: traj_{i} env_states/{key} has {ds.shape[0]} rows, not {T + 1}")
                if i < RECORD_ROW0_ENVS:
                    check(np.array_equal(ds[0], reset_state[key][i]),
                          f"{name}: traj_{i} env_states/{key} row 0 is not the env's reset state")
    print(f"{name}: the port's reader finds {len(keys)} traj_ groups, each env_states of T+1 rows, row 0 equal to "
          f"the env's reset state (first {RECORD_ROW0_ENVS} envs), the JSON's success flags equal the planner's; "
          f"read in {time.perf_counter() - t0:.2f} s {card}")
    rec_env = RecordEpisode(env, os.path.join(tmp, "profile"), save_video=False, trajectory_name="p")
    rec_env.reset(seed=0)
    action = torch.zeros(n_envs, 8, device=dev)
    rec_env.step(action)
    _, prof = profile_calls(lambda: rec_env.step(action), 1)
    _, bare = profile_calls(lambda: env.step(action), 1)
    print(f"{name}: one recorded step {prof['launches']:.0f} launches ({bare['launches']:.0f} without the "
          f"wrapper), {prof['syncs']:.0f} stream/event syncs, {prof['h2d_copies']:.0f} host-to-device copies, "
          f"{prof['wall_ms']:.1f} ms ({bare['wall_ms']:.1f} ms without) {card}{SHARED}")
    check(prof["syncs"] == 0, f"{name}: a recorded step syncs with the device")
    check(prof["h2d_copies"] == 0, f"{name}: a recorded step copies host to device")
    return path, futures, converted


def _flat_state(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_state(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def replay_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths, path, tmp):
    """Phase 33: the recorded file replayed to rgb through the kernel at
    1024 envs (beside the two per-episode replays). Returns (the kernel's max
    error, the last frame's kernel inputs, the launches, the replayed
    file's path)."""
    import os

    from maniskill_tpu_torch.trajectory import replay_trajectory as replay
    from maniskill_tpu_torch.utils import h5

    kernel = RasterLaunches(tr)
    uid, n_envs = RECORD_CELL
    name = f"replay {uid} rgb x{n_envs}"
    with open(path.replace(".h5", ".json")) as f:
        recorded = [e["success"] for e in json.load(f)["episodes"]]
    rgb_dir = os.path.join(tmp, "rgb")
    kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = _quiet(replay.main, ["--traj-path", path, "--obs-mode", "rgb", "--num-envs", str(n_envs),
                                  "--save-traj", "--output-dir", rgb_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    env = out["env"]
    base = env.unwrapped
    T = int(base.elapsed_steps.max())
    flush = env.flush_stats
    # make's first reset, the replay's reset, then the steps
    check(launches == 2 + T, f"{name}: kernel launches {launches} != resets + steps {2 + T}")
    agree = float(np.mean(np.asarray(out["success"]) == np.asarray(recorded)))
    check(agree >= REPLAY_AGREE_MIN, f"{name}: replayed success agrees with the recording in {agree:.4f} "
                                     f"of episodes (< {REPLAY_AGREE_MIN})")
    rgb_path = os.path.join(rgb_dir, os.path.basename(path).replace(".h5", ".replay.h5"))
    cams = list(base._sensors)
    with h5.File(rgb_path) as f:
        keys = [k for k in f.keys() if k.startswith("traj_")]
        check(len(keys) == n_envs, f"{name}: {len(keys)} replayed episodes in the file")
        for k in keys:
            for cam in cams:
                ds = f[f"{k}/obs/sensor_data/{cam}/rgb"]
                n = f[f"{k}/actions"].shape[0]
                check(ds.shape == (n + 1, 128, 128, 3) and ds.dtype == np.uint8,
                      f"{name}: {k} {cam} rgb is {ds.shape} {ds.dtype}")
        frame = f[f"{keys[0]}/obs/sensor_data/{cams[0]}/rgb"][()][-1]
    size_gb = os.path.getsize(rgb_path) / 1e9
    obs = base.get_obs()
    rgb = obs["sensor_data"][cams[0]]["rgb"]
    check(np.array_equal(rgb[0].cpu().numpy(), frame), f"{name}: the file's last frame of env 0 is not the env's")
    inputs, err, seg_agree = rerender_check(base, cams[0], 16, tr, tiled_inputs, geom_poses, rgb, name)
    print(f"{name}: {n_envs} episodes of {T} steps replayed open loop in {wall:.2f} s "
          f"({n_envs * T / wall:.1f} rgb env-steps/s, recording and the flush included: "
          f"{flush['d2h_bytes'] / 1e9:.3f} GB device to host in {flush['d2h_seconds']:.2f} s, written in "
          f"{flush['write_seconds']:.2f} s, the file {size_gb:.3f} GB); success {sum(out['success'])}/{n_envs}, "
          f"agreeing with the recording in {agree:.6f} of episodes (bound {REPLAY_AGREE_MIN}); kernel launches "
          f"{launches}; every episode's {', '.join(cams)} rgb uint8 (T+1, 128, 128, 3); the last frame of 16 envs "
          f"re-rendered through the plain version: seg agreement {seg_agree:.6f}, rgb equal {card}{SHARED}")
    return err, inputs, launches, rgb_path


def replay_kernel_times(tr, paths, inputs, launches, card):
    """The kernel's numbers on phase 33's last frame, taken alone on the
    card after the per-episode replays end."""
    n_envs = RECORD_CELL[1]
    times = raster_times(tr, inputs, 128, 128)
    paths[f"replay_pickcube_rgb_{n_envs}"] = dict(launches=launches, **times)
    print_raster_times("replay pickcube rgb", f"{n_envs}x128x128", times, card)


def episode_replay_worker(argv):
    """One per-episode replay (``replay_trajectory.main(argv)``) in a process
    of its own: its result without the env, and its seconds."""
    from maniskill_tpu_torch.trajectory import replay_trajectory as replay

    t0 = time.perf_counter()
    out, _ = _quiet(replay.main, argv)
    out.pop("env")
    out["seconds"] = time.perf_counter() - t0
    return out


def episode_replays_start(pool, path, tmp):
    """Phase 33's per-episode paths, started in two processes: 4 episodes
    by env states, and 4 converted to pd_joint_delta_pos and recorded.
    Returns (futures, the converted file's path)."""
    import os

    n_ep, conv_dir = str(REPLAY_EPISODES), os.path.join(tmp, "delta")
    futures = dict(
        states=pool.submit(episode_replay_worker, ["--traj-path", path, "--use-env-states", "--num-episodes", n_ep]),
        converted=pool.submit(episode_replay_worker, ["--traj-path", path, "--control-mode", "pd_joint_delta_pos",
                                                      "--save-traj", "--num-episodes", n_ep, "--output-dir",
                                                      conv_dir]))
    return futures, os.path.join(conv_dir, os.path.basename(path).replace(".h5", ".replay.h5"))


def episode_replays_finish(futures, path, card):
    """Phase 33's per-episode results: every restored state within
    STATE_RESTORE_TOL of the recording; each path's success."""
    with open(path.replace(".h5", ".json")) as f:
        recorded = [e["success"] for e in json.load(f)["episodes"]][:REPLAY_EPISODES]
    states, conv = futures["states"].result(), futures["converted"].result()
    worst = max(states["state_err"])
    check(worst <= STATE_RESTORE_TOL, f"replay by env states: a restored state parts from the recording by {worst}")
    note = f"{card} (one of 2 replay processes sharing the card with phases 32-34)"
    print(f"replay by env states, {REPLAY_EPISODES} episodes: every restored state within {worst:.3g} of the "
          f"recording (bound {STATE_RESTORE_TOL}); success {states['success']} (recorded {recorded}) in "
          f"{states['seconds']:.2f} s {note}")
    print(f"replay converted to pd_joint_delta_pos, {REPLAY_EPISODES} episodes: success {conv['success']} "
          f"(recorded {recorded}) in {conv['seconds']:.2f} s {note}")


def bc_phase(torch, dev, make, card, path):
    """Phase 34, BC: the CLI at its defaults on phase 32's file."""
    from maniskill_tpu_torch.examples.baselines import bc

    out, printed = _quiet(bc.main, ["--traj-path", path, "--epochs", str(BC_EPOCHS), "--save-path",
                                    path.replace(".h5", ".bc.pt")])
    mse = out["mse"]
    check(all(np.isfinite(mse)) and mse[-1] < mse[0], f"bc: the MSE did not fall over {BC_EPOCHS} epochs: {mse}")
    print(f"bc on the recorded file ({printed.splitlines()[0]}; batch 1024, hidden 256, lr 3e-4): MSE "
          f"{', '.join(f'{m:.5f}' for m in mse)} over {BC_EPOCHS} epochs, {out['epochs_per_s']:.2f} epochs/s; "
          f"eval success(any) {out['eval_success']:.4f} on 16 envs {card}{SHARED}")


def rlpd_phase(torch, dev, make, card, converted):
    """Phase 34, RLPD: the CLI at its defaults on phase 33's converted file,
    then one profiled learning train step."""
    from maniskill_tpu_torch.examples.baselines import rlpd
    from maniskill_tpu_torch.utils.timing import profile_calls

    uid, warmup, learn = RLPD_CELL
    envs = 256
    steps = (warmup + learn) * envs * 4
    t0 = time.perf_counter()
    out, printed = _quiet(rlpd.main, ["--env-id", uid, "--traj-path", converted, "--total-steps", str(steps),
                                      "--warmup-steps", str(warmup), "--save-path",
                                      converted.replace(".h5", ".rlpd.pkl")])
    trainer = out["trainer"]
    check(all(np.isfinite(v) for v in out["metrics"].values()), f"rlpd: metrics {out['metrics']}")
    check(all(bool(torch.isfinite(p).all()) for p in trainer.actor.parameters()), "rlpd: non-finite params")
    mode_line = next(line for line in printed.splitlines() if line.startswith("control mode"))
    print(f"rlpd {uid} x{envs} on the converted file ({printed.splitlines()[0]}; {mode_line}): "
          f"{warmup} warm-up and {learn} learning train steps at the CLI's defaults (batch 512, utd 4), "
          f"{out['env_steps_per_s']:.1f} env-steps/s, q_loss {out['metrics']['q_loss']:.4f}, eval success(any) "
          f"{out['eval_success']:.4f}, {time.perf_counter() - t0:.2f} s in all {card}")
    obs, elapsed = out["obs"], out["elapsed"]
    _, prof = profile_calls(lambda: trainer.train_step(obs, elapsed, learn=True), 1)
    print(f"rlpd profile of one learning train step: {prof['launches']:.0f} launches, {prof['syncs']:.0f} "
          f"stream/event syncs, {prof['h2d_copies']:.0f} host-to-device copies, device kernels "
          f"{prof['device_kernel_ms']:.3f} ms of {prof['wall_ms']:.3f} ms {card}")
    check(prof["syncs"] == 0, "rlpd: the train step syncs with the device")
    check(prof["h2d_copies"] == 0, "rlpd: the train step copies host to device")


def side_worker(card: str):
    """Phases 23, 24 and 26 (state, host-bound) in a process of their
    own. Returns their seconds by phase."""
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    dev = torch.device("cuda")
    seconds = {}
    for phase, fn in (("23", two_robot_phase), ("24", locomotion_phase), ("26", cabinet_state_phase)):
        t0 = time.perf_counter()
        fn(torch, dev, make, card)
        seconds[phase] = time.perf_counter() - t0
    return seconds


def _epoch_profile(name, out):
    """One more epoch of a CLI's trainer under the profiler: 0 syncs, 0
    host-to-device copies. Returns the printed summary."""
    from maniskill_tpu_torch.utils.timing import profile_calls

    _, prof = profile_calls(out["epoch"], 1)
    check(prof["syncs"] == 0, f"{name}: an epoch syncs with the device {prof['syncs']:.0f} times")
    check(prof["h2d_copies"] == 0, f"{name}: an epoch copies host to device")
    return (f"one epoch profiled: {prof['launches']:.0f} launches, {prof['syncs']:.0f} stream/event syncs, "
            f"{prof['h2d_copies']:.0f} host-to-device copies, device kernels {prof['device_kernel_ms']:.1f} ms of "
            f"{prof['wall_ms']:.1f} ms")


def dp_state_worker(path: str, card: str):
    """Phase 35: Diffusion Policy on phase 32's recording (state) at the
    CLI's defaults for DP_EPOCHS epochs (the eps-MSE falling), the CLI's
    eval in IL_EVAL_ENVS envs, and one more epoch under the profiler.
    Returns its seconds."""
    from maniskill_tpu_torch.examples.baselines import diffusion_policy as dp

    t0 = time.perf_counter()
    name = f"dp state {IL_ENV} x{IL_EVAL_ENVS}"
    out, printed = _quiet(dp.main, ["--traj-path", path, "--env-id", IL_ENV, "--epochs", str(DP_EPOCHS),
                                    "--eval-episodes", str(IL_EVAL_ENVS)])
    loss = out["loss"]
    check(all(np.isfinite(loss)) and loss[-1] < loss[0], f"{name}: the eps-MSE did not fall: {loss}")
    check(0.0 <= out["eval_success"] <= 1.0, f"{name}: eval success {out['eval_success']}")
    prof = _epoch_profile(name, out)
    print(f"{name} on the recorded file ({printed.splitlines()[0]}; unet 64 128 256, batch 512, 50 diffusion "
          f"steps): eps-MSE {', '.join(f'{x:.5f}' for x in loss)} over {DP_EPOCHS} epochs, "
          f"{out['epochs_per_s']:.3f} epochs/s; sample_chunk {out['sample_ms']:.1f} ms ({IL_EVAL_ENVS} envs, 50 "
          f"denoiser passes); eval success_once {out['eval_success']:.4f}; {prof} {card}")
    return time.perf_counter() - t0


def dp_rgb_worker(rgb_path: str, card: str):
    """Phase 36: Diffusion Policy on phase 33's frames (re-rendered by the
    kernel) for DP_RGB_EPOCHS epochs, then the CLI's eval in an rgb env
    through the kernel: launches == resets + steps, the last frame of the
    IL_EVAL_ENVS envs held to the plain version. Returns (the launches, that
    frame's kernel inputs on the host for timing alone, the kernel's max
    error, seconds)."""
    import torch

    from maniskill_tpu_torch.examples.baselines import diffusion_policy as dp
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    t0 = time.perf_counter()
    tr.build_kernels()
    kernel = RasterLaunches(tr)
    name = f"dp rgb {IL_ENV} x{IL_EVAL_ENVS}"
    kernel.launches = 0
    out, printed = _quiet(dp.main, ["--traj-path", rgb_path, "--env-id", IL_ENV, "--obs-mode", "rgb", "--epochs",
                                    str(DP_RGB_EPOCHS), "--eval-episodes", str(IL_EVAL_ENVS)])
    launches = kernel.launches
    base = out["env"].unwrapped
    steps = int(base.elapsed_steps.max())
    # make's first reset, the eval's reset, then the steps
    check(launches == 2 + steps, f"{name}: kernel launches {launches} != resets + steps {2 + steps}")
    check(all(np.isfinite(out["loss"])), f"{name}: eps-MSE {out['loss']}")
    rgb = out["obs"]["sensor_data"]["base_camera"]["rgb"]
    inputs, err, agree = rerender_check(base, "base_camera", IL_EVAL_ENVS, tr, tiled_inputs, geom_poses, rgb, name)
    lines = printed.splitlines()
    print(f"{name} on the replayed frames ({lines[0]}; {lines[1]}): eps-MSE {out['loss'][0]:.5f} after "
          f"{DP_RGB_EPOCHS} epoch(s), {out['epochs_per_s']:.3f} epochs/s; sample_chunk {out['sample_ms']:.1f} ms; "
          f"eval success_once {out['eval_success']:.4f}; kernel launches {launches} == resets + steps, the last "
          f"frame of {IL_EVAL_ENVS} envs re-rendered through the plain version: seg agreement {agree:.6f}, rgb "
          f"equal {card}")
    return launches, [x.cpu() if isinstance(x, torch.Tensor) else x for x in inputs], err, time.perf_counter() - t0


def act_worker(path: str, card: str):
    """Phase 37: ACT on phase 32's recording at the CLI's defaults for
    ACT_EPOCHS epochs, the CLI's eval with whole chunks and with
    ``--temporal-agg`` in IL_EVAL_ENVS envs, one more epoch under the
    profiler. Returns its seconds."""
    from maniskill_tpu_torch.examples.baselines import act

    t0 = time.perf_counter()
    name = f"act {IL_ENV} x{IL_EVAL_ENVS}"
    out, printed = _quiet(act.main, ["--traj-path", path, "--env-id", IL_ENV, "--epochs", str(ACT_EPOCHS),
                                     "--eval-episodes", str(IL_EVAL_ENVS)])
    check(all(np.isfinite(out["loss"])), f"{name}: loss {out['loss']}")
    t1 = time.perf_counter()
    agg = float(act.evaluate(out["env"], out["model"], temporal_agg=True).float().mean())
    agg_s = time.perf_counter() - t1
    prof = _epoch_profile(name, out)
    print(f"{name} on the recorded file ({printed.splitlines()[0]}; dim 256, 4 heads, 3 layers, batch 256): loss "
          f"{', '.join(f'{x:.5f}' for x in out['loss'])} over {ACT_EPOCHS} epochs, {out['epochs_per_s']:.3f} "
          f"epochs/s; eval success_once {out['eval_success']:.4f} with whole chunks, {agg:.4f} with "
          f"--temporal-agg ({agg_s:.2f} s); {prof} {card}")
    return time.perf_counter() - t0


def rfcl_sb3_worker(tmp: str, card: str):
    """Phase 38: RFCL's CLI at its defaults on the repo's PickCube demos
    (warm-up, then learning train steps), one more learning train step under
    the profiler (0 syncs, 0 host-to-device copies), a curriculum reset on
    the card restoring a demo state within STATE_RESTORE_TOL; then
    SB3_STEPS steps of the SB3 adapter and SB3_PROFILES profiled (one
    device-to-host copy a step, the most any profile reads). Returns its
    seconds."""
    import os

    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.examples.baselines import rfcl as rfcl_cli
    from maniskill_tpu_torch.parallel.rfcl import gather_start_states
    from maniskill_tpu_torch.utils.timing import profile_calls
    from maniskill_tpu_torch.vector.sb3 import ManiSkillSB3VectorEnv

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    uid, n_envs, warmup, learn = RFCL_CELL
    name = f"rfcl {uid} x{n_envs}"
    out, printed = _quiet(rfcl_cli.main, ["--env-id", uid, "--demos", RFCL_DEMOS, "--num-envs", str(n_envs),
                                          "--total-steps", str((warmup + learn) * n_envs * 4), "--warmup-steps",
                                          str(warmup), "--save-path", os.path.join(tmp, "rfcl.pkl")])
    trainer = out["trainer"]
    check(all(np.isfinite(v) for v in out["metrics"].values()), f"{name}: metrics {out['metrics']}")
    check(all(bool(torch.isfinite(p).all()) for p in trainer.actor.parameters()), f"{name}: non-finite params")
    obs, elapsed = out["obs"], out["elapsed"]
    _, prof = profile_calls(lambda: trainer.train_step(obs, elapsed, learn=True), 1)
    check(prof["syncs"] == 0, f"{name}: the train step syncs with the device")
    check(prof["h2d_copies"] == 0, f"{name}: the train step copies host to device")
    m = out["metrics"]
    print(f"{name} on the repo's demos ({printed.splitlines()[0]}): {warmup} warm-up and {learn} learning train "
          f"steps at the CLI's defaults (batch 1024, utd 4), {out['env_steps_per_s']:.1f} env-steps/s, q_loss "
          f"{m['q_loss']:.4f}, mean_k {m['mean_k']:.2f}, eval success(any) {out['eval_success']:.4f}; one learning "
          f"train step profiled: {prof['launches']:.0f} launches, {prof['syncs']:.0f} stream/event syncs, "
          f"{prof['h2d_copies']:.0f} host-to-device copies, device kernels {prof['device_kernel_ms']:.1f} ms of "
          f"{prof['wall_ms']:.1f} ms {card}")
    # the collect's curriculum reset: env 0 to its demo's state one from the end
    base = trainer.base
    mask = torch.zeros(n_envs, dtype=torch.bool, device=dev)
    mask[0] = True
    ones = torch.ones_like(trainer.k)
    start = gather_start_states(trainer.demo_states, trainer.demo_lens, trainer.env_demo, ones)
    base._reset_impl(mask, torch.zeros(n_envs, dtype=torch.int64, device=dev), start)
    state = base.get_state_dict()
    d = int(trainer.env_demo[0])
    idx = int(trainer.demo_lens[d]) - 2
    err = max(float((state[g][k][0] - trainer.demo_states[g][k][d, idx]).abs().max())
              for g, k in (("actors", "cube"), ("actors", "goal_site"), ("articulations", "panda")))
    check(err <= STATE_RESTORE_TOL, f"{name}: a curriculum reset parts from the demo state by {err}")
    print(f"{name}: a curriculum reset on the card restores demo {d}'s state {idx} within {err:.3g} "
          f"(bound {STATE_RESTORE_TOL}) {card}")
    vec = ManiSkillSB3VectorEnv(make(uid, num_envs=n_envs, obs_mode="state", device=dev))
    vec.reset()
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (n_envs,) + vec.action_space.shape).astype(np.float32)
    t1 = time.perf_counter()
    for _ in range(SB3_STEPS):
        v_obs, rew, dones, infos = vec.step(actions)
    sb3_s = time.perf_counter() - t1
    check(isinstance(v_obs, np.ndarray) and v_obs.shape[0] == n_envs and len(infos) == n_envs,
          f"sb3: obs {type(v_obs)}, {len(infos)} infos")
    check(np.isfinite(v_obs).all() and np.isfinite(rew).all(), "sb3: non-finite obs or rewards")
    # the profiler now and then loses device records, a copy's among them, and
    # never adds one (scripts/profiler_record_loss.py): a step's copies are the
    # most that any of SB3_PROFILES profiled steps reads
    reads = []
    for _ in range(SB3_PROFILES):
        events, step = profile_calls(lambda: vec.step(actions), 1)
        reads.append(sum(e.count for e in events.key_averages() if e.key.startswith("Memcpy DtoH")))
    d2h = max(reads)
    check(d2h == 1, f"sb3: a step makes {d2h} device-to-host copies (the profiled steps read {reads})")
    print(f"sb3 adapter {uid} x{n_envs}: {SB3_STEPS} steps of numpy actions in {sb3_s:.2f} s "
          f"({n_envs * SB3_STEPS / sb3_s:.1f} env-steps/s), obs {v_obs.shape} {v_obs.dtype}, {len(infos)} info "
          f"dicts; {SB3_PROFILES} steps profiled: {d2h} device-to-host copy a step (the most of {reads}); the last "
          f"step {step['h2d_copies']:.0f} host-to-device, {step['syncs']:.0f} stream/event syncs, "
          f"{step['kernel_records']:.0f} kernel records of {step['launches']:.0f} launches {card}")
    return time.perf_counter() - t0


@contextlib.contextmanager
def sync_guard(torch, what: str):
    """Fail if the block makes a synchronizing CUDA call: a stream or event
    sync, or a blocking copy between host and device (torch's sync debug
    mode flags both; a host-to-device copy of pageable memory synchronizes)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    check(not syncs, f"{what}: {len(syncs)} host syncs, at {collections.Counter(syncs)}")


def finite_steps_hook(torch, rec):
    """A ``state_cell`` hook: each timed step's obs and reward finite and
    contact.overflow 0 in every env, queued on the device into ``rec``."""
    def after(base, i, out):
        if i >= 0:
            rec.append(torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all()
                       & (base.scene.data.contact.overflow == 0).all())
    return after


def scene_state_phase(torch, dev, make, card):
    """Phase 45: SceneManipulation-v1 (ReplicaCAD) and ProcTHOR's last layout
    at SCENE_ENVS, the other AI2THOR builders at SCENE_OTHER_ENVS, and
    PickClutterYCB with the Fetch, state mode, zero actions."""
    cells = ([(uid, SCENE_ENVS, SCENE_STEPS, kw) for uid, kw in SCENE_TIMED]
             + [(uid, SCENE_OTHER_ENVS, SCENE_OTHER_STEPS, {}) for uid in SCENE_OTHERS]
             + [(CLUTTER_FETCH[0], CLUTTER_FETCH[1], CLUTTER_FETCH[2], {"robot_uids": "fetch"})])
    for uid, n, n_steps, kw in cells:
        rec = []
        env = state_cell(torch, dev, make, card, uid, n, n_steps, torch.zeros(n, FETCH_ACTION, device=dev),
                         after=finite_steps_hook(torch, rec), **kw)
        base = env.unwrapped
        check(base.agent.uid == "fetch", f"{uid}: robot {base.agent.uid}")
        check(bool(torch.stack(rec).all()), f"{uid}: obs or reward not finite, or a contact overflow, in a step")
        builder = type(getattr(base, "scene_builder", None)).__name__
        print(f"  {uid} x{n} ({builder}{', ' + str(kw) if kw else ''}): obs and rewards finite and "
              f"contact.overflow 0 in every env and step; {len(base.scene.actors)} actors")
        if (uid, kw) in SCENE_TIMED:
            dexterity_cpu_parity(torch, dev, make, uid, base.get_state_dict(), card, qpos_tol=SCENE_CPU_QPOS_TOL,
                                 **kw)
        del env, base


def bridge_state_phase(torch, dev, make, card, twins):
    """Phase 46: the BridgeData v2 ``twins`` at BRIDGE_ENVS in state mode:
    make, a masked reset of every env (the 50-substep settle inside) and
    timed control steps under the sync check, the settled objects in their
    grid cells, a partial reset, 5 profiled substeps, and the first envs
    against the CPU port."""
    from maniskill_tpu_torch import physics as phys
    from maniskill_tpu_torch.envs.tasks.digital_twins.bridge_dataset_eval.base_env import (SETTLE_SUBSTEPS,
                                                                                           TABLE_TOP_Z)
    from maniskill_tpu_torch.utils.timing import profile_calls

    n = BRIDGE_ENVS
    action = torch.tensor(BRIDGE_ACTION, device=dev).expand(n, 7).contiguous()
    for uid in twins:
        t0 = time.perf_counter()
        env = make(uid, num_envs=n, obs_mode="state", device=dev)
        base = env.unwrapped
        base.agent.controller.controllers["arm"].kinematics  # the IK's tables, built at their first use
        torch.cuda.synchronize()
        make_s = time.perf_counter() - t0
        substeps = base.sim_config.sim_steps_per_control
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        seeds = torch.arange(n, dtype=torch.int64, device=dev) + 1000 * (BRIDGE_TWINS.index(uid) + 1)
        # the masked reset a rollout runs, on device tensors
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sync_guard(torch, f"{uid} reset"):
            base._reset_impl(mask, seeds)
        torch.cuda.synchronize()
        reset_ms = (time.perf_counter() - t0) * 1e3

        # the settle: each object in its grid cell and on the arena (the plate
        # stand-in falls through, as in the JAX package); their speeds printed
        grid = base._xyz_grid  # (G, n_obj, 3)
        settled = [base.scene.get_extra("src_xyz_settle"), base.scene.get_extra("tgt_xyz_settle")]
        cell_gap = torch.stack([torch.cdist(p[:, :2], grid[:, i, :2]) for i, p in enumerate(settled)]).amax(0)
        cell_gap = cell_gap.amin(1)  # (B,): the nearest spawn config over both objects
        check(float(cell_gap.max()) <= BRIDGE_CELL_TOL,
              f"{uid}: a settled object {float(cell_gap.max()):.4f} m from its spawn config's cells")
        rest = []
        for name, actor in base.objs.items():
            z, speed = actor.pose.p[:, 2], actor.linear_velocity.norm(dim=-1)
            if name in BRIDGE_FALLS_THROUGH:
                rest.append(f"{name} below the table top in {int((z < TABLE_TOP_Z).sum())} of {n} envs (no "
                            f"cylinder-box narrowphase in either package)")
                continue
            check(bool((z >= TABLE_TOP_Z - 1e-3).all()), f"{uid}: {name} below the arena's top (z min "
                  f"{float(z.min()):.4f})")
            rest.append(f"{name} on the arena (z {float(z.min()):.4f}-{float(z.max()):.4f}, speed <= "
                        f"{float(speed.max()):.2e} m/s)")

        # a partial reset of the even envs: the settle's merge leaves every
        # field of the odd envs' Data bit-equal; the reset's closing forward
        # pass then recomputes every env's contacts (as in the JAX package),
        # so through the whole reset their state is held, the contacts aside
        half = torch.arange(n, device=dev) % 2 == 0
        scene = base.scene
        before = scene.data
        scene._reset_mask = half
        base.agent.reset(base._rest_qpos.expand(n, -1))
        base._settle(SETTLE_SUBSTEPS)
        scene._reset_mask = None
        settle_diff = [k for k, a, b in data_leaves(torch, before, scene.data) if not torch.equal(a[~half], b[~half])]
        check(not settle_diff, f"{uid}: the settle changed the envs it does not reset in {settle_diff}")
        scene.bind(before)
        base._reset_impl(half, seeds + 7)
        reset_diff = [k for k, a, b in data_leaves(torch, before, scene.data)
                      if not k.startswith("contact.") and not torch.equal(a[~half], b[~half])]
        check(not reset_diff, f"{uid}: a partial reset changed the other envs' {reset_diff}")

        # control steps of a small end-effector move with the gripper closing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sync_guard(torch, f"{uid} control steps"):
            for _ in range(BRIDGE_STEPS):
                out = env.step(action)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / BRIDGE_STEPS
        obs, reward, _, _, info = out
        check(bool(torch.isfinite(obs).all()) and int(base.scene.data.contact.overflow.max()) == 0,
              f"{uid}: obs not finite or a contact overflow")
        stats = ("success", "src_on_target", "is_src_obj_grasped", "consecutive_grasp")
        check(all(k in info and info[k].dtype == torch.bool and info[k].shape == (n,) for k in stats),
              f"{uid}: info {sorted(info)} lacks a bool statistic of {stats}")
        d = base.scene.data
        _, sprof = profile_calls(lambda: phys.step(base.scene.model, d), BRIDGE_PROFILE_SUBSTEPS)
        check(sprof["syncs"] == 0 and sprof["h2d_copies"] == 0,
              f"{uid}: a physics substep makes {sprof['syncs']} syncs, {sprof['h2d_copies']} copies")
        print(f"{uid} state x{n} ({substeps} substeps a control step): make {make_s:.2f} s; reset (the "
              f"{SETTLE_SUBSTEPS}-substep settle inside) {reset_ms:.1f} ms, 0 host syncs; "
              f"{BRIDGE_STEPS} control steps {step_s * 1e3:.1f} ms each ({n / step_s:.1f} env-steps/s, eager), 0 host "
              f"syncs; {BRIDGE_PROFILE_SUBSTEPS} physics substeps profiled on the step's data: "
              f"{sprof['launches']:.0f} launches, 0 stream/event syncs, 0 host-to-device copies per substep, device "
              f"kernels {sprof['device_kernel_ms']:.2f} ms of {sprof['wall_ms']:.2f} ms; overflow 0, obs finite, "
              f"{', '.join(stats)} bool {card}")
        print(f"  {uid}: every env's settled objects within {float(cell_gap.max()):.2e} m of a spawn config's cells; "
              + "; ".join(rest) + f"; a partial reset of {int(half.sum())} envs: the settle left the others' Data "
              f"bit-equal in every field, the reset their state (contacts recomputed by its forward pass)")
        dexterity_cpu_parity(torch, dev, make, uid, base.get_state_dict(), card, control_mode=None,
                             qpos_tol=BRIDGE_CPU_QPOS_TOL, steps=BRIDGE_CPU_STEPS)
        del env, base, before, d


def data_leaves(torch, a, b, prefix=""):
    """(name, a's tensor, b's tensor) over two ``Data`` (or ``Contact``)
    trees, their extras included."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            yield prefix + f.name, x, y
        elif isinstance(x, dict):
            for k in x:
                yield f"{prefix}{f.name}.{k}", x[k], y[k]
        elif x is not None and dataclasses.is_dataclass(x):
            yield from data_leaves(torch, x, y, prefix + f.name + ".")


def scene_bridge_worker(card: str, scenes: bool, twins, rgb_cells=()):
    """Phase 45 (if ``scenes``), phase 46 on ``twins`` and phase 48's
    ``rgb_cells`` in a process of their own. Returns their seconds, and per
    rgb cell (launches, its last frame's kernel inputs on the host, the max
    1/z error)."""
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    torch.set_num_threads(2)  # the CPU port's parity steps, beside the other processes
    dev = torch.device("cuda")
    seconds, rgb = {}, {}
    t0 = time.perf_counter()
    if scenes:
        scene_state_phase(torch, dev, make, card)
        seconds["45"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    bridge_state_phase(torch, dev, make, card, twins)
    seconds["46 " + ", ".join(u.split("-")[0] for u in twins)] = time.perf_counter() - t0
    if rgb_cells:
        t0 = time.perf_counter()
        tr.build_kernels()
        for uid, n_envs, n_steps in rgb_cells:
            launches, inputs, err = bridge_rgb_cell(torch, dev, make, card, tr, tiled_inputs, geom_poses, uid,
                                                    n_envs, n_steps)
            rgb[uid] = (launches, [x.cpu() if isinstance(x, torch.Tensor) else x for x in inputs], err)
        seconds["48"] = time.perf_counter() - t0
    return seconds, rgb


def scene_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths, cell=SCENE_RGB, key="scene_rgb"):
    """Phase 47 (SceneManipulation-v1) and phase 50 (RoboCasaKitchen-v1):
    ``cell``'s env rgb at its width, the base camera and the Fetch's head
    and hand cameras. Returns the kernel's max depth error against the plain
    version."""
    from maniskill_tpu_torch.utils.timing import cuda_ms, timed_steps

    uid, n_envs, n_steps = cell
    name = f"{uid} rgb x{n_envs}"
    kernel = RasterLaunches(tr)
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb", control_mode="pd_joint_delta_pos", device=dev)
    base = env.unwrapped
    zero = torch.zeros(n_envs, FETCH_ACTION, device=dev)
    env.reset(seed=0)
    env.step(zero)
    torch.cuda.synchronize()
    cams = list(base._sensors)
    check(cams == ["base_camera", "fetch_head", "fetch_hand"], f"{name}: cameras {cams}")
    print(f"{name}: built and warmed up in {time.perf_counter() - t0:.2f} s")
    kernel.launches = 0
    env.reset(seed=0)
    step_s = timed_steps(env, zero, n_steps - 1)
    obs, *_ = env.step(zero)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == len(cams) * (1 + n_steps),
          f"{name}: kernel launches {launches} != cameras x (resets + steps) {len(cams) * (1 + n_steps)}")
    check(int(base.scene.data.contact.overflow.max()) == 0, f"{name}: contact overflow")
    err = 0.0
    for cam_name in cams:
        rgb = obs["sensor_data"][cam_name]["rgb"]
        check(tuple(rgb.shape) == (n_envs, 128, 128, 3) and rgb.dtype == torch.uint8,
              f"{name} {cam_name}: rgb is {tuple(rgb.shape)} {rgb.dtype}")
        inputs, e, agree = rerender_check(base, cam_name, 16, tr, tiled_inputs, geom_poses, rgb, f"{name} {cam_name}")
        err = max(err, e)
        times = raster_times(tr, inputs, 128, 128)
        paths[f"{key}_{n_envs}_{cam_name}"] = dict(launches=launches // len(cams), **times)
        print(f"{name} {cam_name}: the last frame of 16 envs re-rendered through the plain version: seg "
              f"agreement {agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal; faces in the scene {inputs[0].shape[1]}")
        print_raster_times(f"{name} {cam_name}", f"{n_envs}x128x128", times, card)
        del inputs
    frame_ms = cuda_ms(lambda: base._sensors["base_camera"].get_obs(rgb=True), 5)
    kernel.launches = launches
    print(f"{name}: {n_envs * (n_steps - 1) / step_s:.1f} env-steps/s ({step_s / (n_steps - 1) * 1e3:.2f} ms/step, "
          f"eager, three 128x128 cameras), kernel launches {launches} (cameras x (resets + steps)), dropped 0; "
          f"base_camera's whole render {frame_ms:.4f} ms/frame {card}")
    return err


def bridge_frame_check(torch, base, tr, tiled_inputs, geom_poses, obs, name, plain_envs):
    """The last frame of a bridge twin's camera: the whole batch again
    through the kernel, ``plain_envs`` envs through the plain version (1/z
    bit-equal, seg and rgb equal: the raw frame, before the composite); the
    segmentation obs the kernel's, and the rgb obs the composite
    where(keep[seg], raw rgb, overlay) in every env. Returns (inputs, max
    |1/z| error, (B,) carrot/robot/plate pixel counts)."""
    cam_name = "3rd_view_camera"
    cam = base._sensors[cam_name]
    H, W = cam.config.height, cam.config.width
    mesh = cam._get_mesh(tuple(base._hidden_objects))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    inputs = tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj, H, W,
                          lights=base.scene.lights)
    before = RasterLaunches(tr).launches
    zk, sk, rk, dk = tr.rasterize_tiles(*inputs, H, W)
    RasterLaunches(tr).launches = before  # comparison launches are not main-path launches
    m = plain_envs
    zp, sp, rp, dp = tr.rasterize_tiles_ref(*[a[:m] for a in inputs[:5]], inputs[5], H, W)
    check(int(dk) == 0 and int(dp) == 0, f"{name}: dropped {int(dk)} (kernel), {int(dp)} (plain)")
    check(bool(torch.equal(zk[:m].view(torch.int32), zp.view(torch.int32))),
          f"{name}: 1/z not bit-equal to the plain version's, max |d| {float((zk[:m] - zp).abs().max())}")
    check(bool(torch.equal(sk[:m], sp)) and bool(torch.equal(rk[:m], rp)),
          f"{name}: seg or rgb differs from the plain version's")
    seg_obs = obs["sensor_data"][cam_name]["segmentation"][..., 0]
    rgb_obs = obs["sensor_data"][cam_name]["rgb"]
    check(tuple(rgb_obs.shape) == (base.num_envs, H, W, 3) and rgb_obs.dtype == torch.uint8,
          f"{name}: rgb {tuple(rgb_obs.shape)} {rgb_obs.dtype}")
    seg = torch.where(sk >= 0, sk, 0)
    check(bool(torch.equal(seg.to(torch.int16), seg_obs)), f"{name}: the segmentation obs is not the kernel's")
    raw = (torch.clamp(rk, 0, 1) * 255).to(torch.uint8)
    keep = base._keep_lut[seg.long()][..., None]
    composite = torch.where(keep, raw, base._rgb_overlay_images[cam_name][None])
    differ = int((composite != rgb_obs).any(-1).sum())
    check(differ == 0, f"{name}: the rgb obs differs from where(keep[seg], raw rgb, overlay) on {differ} px")
    ids = {"robot": [link.per_scene_id for link in base.agent.robot.links]}
    ids.update({obj: [actor.per_scene_id] for obj, actor in base.objs.items()})
    seen = {k: torch.isin(sk, torch.tensor(v, device=sk.device)).sum((1, 2)) for k, v in ids.items()}
    return inputs, float((zk[:m] - zp).abs().max()), seen, float(keep.float().mean())


def bridge_rgb_cell(torch, dev, make, card, tr, tiled_inputs, geom_poses, uid, n_envs, n_steps):
    """A bridge twin in rgb+segmentation at ``n_envs`` and 640x480 through
    the kernel and the greenscreen: reset and ``n_steps`` control steps, the
    kernel's launches, 0 host syncs in the steps, the last frame's checks
    (``bridge_frame_check``), the source object and the robot in view in
    every env. Returns (launches, the last frame's kernel inputs, the max
    1/z error against the plain version)."""
    kernel = RasterLaunches(tr)
    name = f"{uid} rgb+segmentation x{n_envs}"
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb+segmentation", device=dev)
    base = env.unwrapped
    torch.cuda.synchronize()
    cam = base._sensors["3rd_view_camera"]
    H, W = cam.config.height, cam.config.width
    check((W, H) == (640, 480) and base.overlay_sources == {"3rd_view_camera": "procedural"},
          f"{name}: camera {W}x{H}, overlays {base.overlay_sources}")
    make_s = time.perf_counter() - t0
    action = torch.tensor(BRIDGE_ACTION, device=dev).expand(n_envs, 7).contiguous()
    base.agent.controller.controllers["arm"].kinematics  # the IK's tables, built at their first use
    kernel.launches = 0
    env.reset(seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sync_guard(torch, f"{name}, {n_steps} control steps"):
        for _ in range(n_steps):
            obs, *_ = env.step(action)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_steps
    launches = kernel.launches
    check(launches == 1 + n_steps, f"{name}: kernel launches {launches} != resets + steps {1 + n_steps}")
    check(int(base.scene.data.contact.overflow.max()) == 0, f"{name}: contact overflow")
    inputs, err, seen, kept = bridge_frame_check(torch, base, tr, tiled_inputs, geom_poses, obs, name,
                                                 BRIDGE_PLAIN_ENVS)
    views = []
    for k, px in seen.items():
        if k == "robot" or k == base.source_obj_name:
            check(bool((px > 0).all()), f"{name}: the {k} out of view in {int((px == 0).sum())} envs")
        views.append(f"{k} in view in {int((px > 0).sum())} of {n_envs} envs")
    _, counts, _ = tr.bin_faces(inputs[0], inputs[1], tr.face_records(*inputs)[1], H, W)
    print(f"{name}: make {make_s:.2f} s (its reset's settle inside); {n_steps} control steps {step_s * 1e3:.1f} ms "
          f"each ({n_envs / step_s:.1f} env-steps/s, eager); kernel launches {launches} (resets + steps), 0 host "
          f"syncs in the steps, dropped 0; the last raw frame of {BRIDGE_PLAIN_ENVS} envs re-rendered through the "
          f"plain version: 1/z bit-equal, seg and rgb equal; the composite where(keep[seg], raw rgb, overlay) in "
          f"every env ({kept:.3f} of the pixels kept); " + ", ".join(views) + f"; faces per env "
          f"{inputs[0].shape[1]}, per band mean {counts.float().mean().item():.1f}, max {int(counts.max())} {card}")
    return launches, inputs, err


def bridge_rgb_times(torch, dev, tr, paths, rgb, card):
    """Phase 48's kernel times, on each bridge cell's last frame from phase
    46's second process, with the card to this process alone. Returns the
    cells' max 1/z error against the plain version."""
    from maniskill_tpu_torch.utils.timing import cuda_ms

    H, W = BRIDGE_FRAME
    m = BRIDGE_PLAIN_ENVS
    kernel = RasterLaunches(tr)
    err = 0.0
    for uid, (launches, host_inputs, e) in rgb.items():
        inputs = [x.to(dev) if isinstance(x, torch.Tensor) else x for x in host_inputs]
        n_envs = inputs[0].shape[0]
        times = raster_times(tr, inputs, H, W, 20, plain_envs=m)
        before = kernel.launches
        frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, H, W), 5)
        kernel.launches = before  # timing launches are not main-path launches
        paths[f"bridge_rgbseg_{uid.split('-')[0]}_{n_envs}"] = dict(launches=launches, **times)
        print_raster_times(uid, f"{n_envs}x{H}x{W}, its last frame from phase 48's process; tiled render "
                                f"{frame_ms:.4f} ms/frame", times, card)
        err = max(err, e)
    return err


def robocasa_oracles(torch, base, card):
    """The teleport oracles of tests/test_robocasa.py on every env:
    OpenDrawer's success flips as the target drawer is set past OPEN_MIN,
    PnPCounterToSink's in_basin (and success, at rest) as the target object
    is set into the basin."""
    from maniskill_tpu_torch import physics as phys

    scene = base.scene
    uid = type(base).uid

    def teleport(fn):
        q = scene.data.qpos.clone()
        fn(q)
        scene.data = phys.forward(scene.model, scene.data.replace(qpos=q, qvel=torch.zeros_like(scene.data.qvel)))
        return base.evaluate()

    if uid == "RoboCasaOpenDrawer-v1":
        adr, open_min = base.target_joint.q_adr, base.OPEN_MIN
        shut = teleport(lambda q: q.__setitem__((slice(None), adr), 0.5 * open_min))["success"]
        opened = teleport(lambda q: q.__setitem__((slice(None), adr), 1.2 * open_min))["success"]
        check(not bool(shut.any()) and bool(opened.all()),
              f"{uid}: success in {int(shut.sum())} envs at half OPEN_MIN, {int(opened.sum())} at 1.2 x")
        print(f"  {uid}: success false in every env with the drawer at {0.5 * open_min:.3f} m, true in every env "
              f"at {1.2 * open_min:.3f} m (OPEN_MIN {open_min} m) {card}")
    else:
        adr = int(scene.model.body_q_adr[base.target_object.body_id])

        def basin(lift):
            def put(q):
                q[:, adr:adr + 3] = base._sink_target
                q[:, adr + 2] += lift
            return put

        above = teleport(basin(0.3))
        inside = teleport(basin(0.0))
        check(not bool(above["in_basin"].any()) and bool(inside["in_basin"].all() & inside["success"].all()),
              f"{uid}: in_basin in {int(above['in_basin'].sum())} envs above the basin, {int(inside['in_basin'].sum())} "
              f"(success {int(inside['success'].sum())}) with the object in the basin")
        print(f"  {uid}: in_basin false in every env with the object 0.3 m above the basin, in_basin and success "
              f"true in every env with it set into the basin at rest {card}")


def robocasa_state_phase(torch, dev, make, card):
    """Phase 49: the four RoboCasa ids in state mode with the Fetch, zero
    actions, and RoboCasaKitchen-v1's other four layouts."""
    uid0, n, n_steps = ROBOCASA_TIMED
    zero = torch.zeros(n, FETCH_ACTION, device=dev)
    for uid, steps in ((uid0, n_steps),) + tuple((u, ROBOCASA_OTHER_STEPS) for u in ROBOCASA_OTHERS):
        rec = []
        env = state_cell(torch, dev, make, card, uid, n, steps, zero, after=finite_steps_hook(torch, rec))
        base = env.unwrapped
        check(base.agent.uid == "fetch", f"{uid}: robot {base.agent.uid}")
        check(bool(torch.stack(rec).all()), f"{uid}: obs or reward not finite, or a contact overflow, in a step")
        m = base.scene.model
        print(f"  {uid} x{n}: obs and rewards finite and contact.overflow 0 in every env and step; nbody {m.nbody}, "
              f"ngeom {m.ngeom}, nv {m.nv}, {len(base.scene.articulations) - 1} articulated fixtures")
        dexterity_cpu_parity(torch, dev, make, uid, base.get_state_dict(), card, qpos_tol=ROBOCASA_CPU_QPOS_TOL)
        if uid in ("RoboCasaOpenDrawer-v1", "RoboCasaPnPCounterToSink-v1"):
            robocasa_oracles(torch, base, card)
        del env, base
    m = ROBOCASA_LAYOUT_ENVS
    zero = torch.zeros(m, FETCH_ACTION, device=dev)
    for idx in range(1, 5):
        t0 = time.perf_counter()
        env = make(uid0, num_envs=m, obs_mode="state", device=dev, layout_ids=idx)
        env.reset(seed=0)
        obs, reward, *_ = env.step(zero)
        torch.cuda.synchronize()
        base = env.unwrapped
        data = base.scene.data
        check(bool(torch.isfinite(obs).all() & torch.isfinite(data.qpos).all()), f"{uid0} layout {idx}: not finite")
        check(int(data.contact.overflow.max()) == 0, f"{uid0} layout {idx}: contact overflow")
        print(f"  {uid0} layout {idx} ({base.scene_builder.build_configs[idx]}) x{m}: make, reset and 1 step in "
              f"{time.perf_counter() - t0:.2f} s; finite, overflow 0; nbody {base.scene.model.nbody}, ngeom "
              f"{base.scene.model.ngeom} {card}")
        del env, base, data


def drive_cpu_parity(torch, dev, drag_object, state, target, card):
    """The first DEX_CPU_ENVS envs of the drag env's ``state`` and drive
    ``target`` on the card and in the port on the CPU, DEX_CPU_STEPS
    zero-action steps: qpos within DRAG_CPU_QPOS_TOL."""
    m = DEX_CPU_ENVS
    out = []
    for d in (dev, torch.device("cpu")):
        factory = drag_object._DragEnvFactory(DRAG[0], "cube")
        env = factory.make(num_envs=m, obs_mode="state", device=d)
        zero = torch.zeros((m,) + tuple(env.single_action_space.shape), device=d)
        env.reset(seed=0, options=dict(reset_to_env_states=_first_envs(state, m, d)))
        factory.drive.set_drive_target(target[:m].to(d))
        for _ in range(DEX_CPU_STEPS):
            env.step(zero)
        out.append(env.scene.data.qpos.cpu())
        del env
    gap = float((out[0] - out[1]).abs().max())
    check(gap <= DRAG_CPU_QPOS_TOL, f"{DRAG[0]} with a drive: the card's first {m} envs part from the CPU's by "
                                    f"{gap:.3g} (qpos, tolerance {DRAG_CPU_QPOS_TOL})")
    print(f"  {DRAG[0]} with a drive: the card's first {m} envs and the CPU port from one state and target, "
          f"{DEX_CPU_STEPS} zero-action steps: qpos within {gap:.3g} (tolerance {DRAG_CPU_QPOS_TOL}) {card}")


def drive_phase(torch, dev, make, card):
    """Phase 51: a world-anchored drive drags PushCube's cube at DRAG's
    width, then the two teleoperation CLIs on the card with key scripts."""
    from maniskill_tpu_torch.examples.teleoperation import drag_object, interactive_panda
    from maniskill_tpu_torch.utils.timing import profile_calls

    uid, n = DRAG
    t0 = time.perf_counter()
    factory = drag_object._DragEnvFactory(uid, "cube")
    env = factory.make(num_envs=n, obs_mode="state", device=dev)
    drive = factory.drive
    zero = torch.zeros((n,) + tuple(env.single_action_space.shape), device=dev)
    env.reset(seed=0)
    env.step(zero)  # builds the lazy tables
    env.reset(seed=0)
    # the arm out of the drag's way: the resting gripper hangs where a cube
    # lifted 0.1 m would meet it in some envs
    qpos = env.agent.robot.qpos.clone()
    qpos[:, 1] = DRAG_SHOULDER
    env.agent.reset(qpos)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    state = env.get_state_dict()
    target = env.obj.pose.raw_pose.clone()
    target[:, 3:] = 0.0
    target[:, 3] = 1.0
    start = target.clone()
    errs = []
    t0 = time.perf_counter()
    for move in DRAG_MOVES:
        for i, dx in enumerate(move):
            target[:, i] += dx
        drive.set_drive_target(target)
        for _ in range(DRAG_STEPS):
            env.step(zero)
        errs.append(torch.linalg.vector_norm(env.obj.pose.p - target[:, :3], dim=-1).max())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (len(DRAG_MOVES) * DRAG_STEPS)
    errs = [float(e) for e in errs]
    data = env.scene.data
    check(bool(torch.isfinite(data.qpos).all()) and int(data.contact.overflow.max()) == 0,
          f"{uid} with a drive: state not finite or a contact overflow")
    check(max(errs) <= DRAG_TOL, f"{uid} with a drive: the cube {max(errs):.4f} m from its target after "
                                 f"{DRAG_STEPS} control steps (tolerance {DRAG_TOL})")
    _, prof = profile_calls(lambda: env.step(zero), 1)
    check(prof["syncs"] == 0, f"{uid} with a drive: {prof['syncs']} stream/event syncs in a step")
    check(prof["h2d_copies"] == 0, f"{uid} with a drive: {prof['h2d_copies']} host-to-device copies in a step")
    moved = (target[:, :3] - start[:, :3])[0].tolist()
    print(f"{uid} x{n} with a world-anchored drive on the cube, the arm raised (shoulder {DRAG_SHOULDER} rad): "
          f"make {make_s:.2f} s; the target moved by "
          f"{DRAG_MOVES[0]} then {DRAG_MOVES[1]} m ({moved} in all), {DRAG_STEPS} control steps after each: the "
          f"cube within {errs[0]:.4f} and {errs[1]:.4f} m of the target in every env (tolerance {DRAG_TOL}); "
          f"{step_s * 1e3:.2f} ms/step; step profile {prof['launches']:.0f} launches, {prof['syncs']:.0f} "
          f"stream/event syncs, {prof['h2d_copies']:.0f} host-to-device copies, device kernels "
          f"{prof['device_kernel_ms']:.3f} ms of {prof['wall_ms']:.3f} ms (idle {prof['device_idle_share']:.3f}) "
          f"{card}")
    drive_cpu_parity(torch, dev, drag_object, state, target, card)
    del env, data

    # the CLIs at one env on the card, each fed a key script ending in q
    for module, keys in ((drag_object, DRAG_KEYS), (interactive_panda, PANDA_KEYS)):
        script = iter(keys)
        read_key = module._read_key
        module._read_key = lambda: next(script)
        try:
            t0 = time.perf_counter()
            out, _ = _quiet(module.main, [])
        finally:
            module._read_key = read_key
        cli_s = time.perf_counter() - t0
        if module is drag_object:
            tg, pos = out["targets"], out["positions"]
            rise, push = pos[4, 2] - pos[0, 2], pos[-1, 0] - pos[4, 0]
            gap = float(np.abs(pos[-1] - tg[-1]).max())
            check(len(tg) == len(keys) - 1 and rise > 0.05 and push > 0.07 and gap < DRAG_TOL,
                  f"drag_object CLI: {len(tg)} steps, the object rose {rise:.4f} m on r, moved {push:.4f} m on w, "
                  f"ends {gap:.4f} m from its target")
            print(f"  drag_object CLI ({keys!r}, one env): the object rose {rise:.4f} m on r x4 after the first, "
                  f"moved {push:.4f} m along x on w x5, ends {gap:.4f} m from its target; {cli_s:.2f} s {card}")
        else:
            tcp = out["tcp"]
            dx, dz = tcp[2, 0] - tcp[0, 0], tcp[-1, 2] - tcp[2, 2]
            check(len(tcp) == len(keys) - 1 and dx > 0.02 and dz > 0.02 and np.isfinite(out["reward"]).all(),
                  f"interactive_panda CLI: {len(tcp)} steps, the TCP moved {dx:.4f} m on w, {dz:.4f} m on r")
            print(f"  interactive_panda CLI ({keys!r}, one env, pd_ee_target_delta_pos): the TCP moved {dx:.4f} m "
                  f"along x on w x2 after the first, {dz:.4f} m up on r x3; {cli_s:.2f} s {card}")


def slice16_worker(card: str):
    """Phases 49 and 51 in a process of their own. Returns their seconds."""
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make

    torch.set_num_threads(2)  # the CPU port's parity steps, beside the other processes
    dev = torch.device("cuda")
    seconds = {}
    for phase, fn in (("49", robocasa_state_phase), ("51", drive_phase)):
        t0 = time.perf_counter()
        fn(torch, dev, make, card)
        seconds[phase] = time.perf_counter() - t0
    return seconds


def stereo_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 52: a StereoDepthCamera on PickCube-v1 through the kernel, two
    launches per observation (left eye, right eye); the int16 depth of the
    last observation's first STEREO_PLAIN_ENVS envs equal to the plain
    version's through the same stereo code. Returns the kernel's max 1/z
    error against the plain version."""
    from maniskill_tpu_torch.sensors.depth_camera import StereoDepthCamera, StereoDepthCameraConfig, stereo_depth
    from maniskill_tpu_torch.utils.scene_utils import look_at
    from maniskill_tpu_torch.utils.timing import cuda_ms

    uid, n_envs, n_steps = STEREO
    H, W = STEREO_SIZE
    name = f"{uid} StereoDepthCamera x{n_envs} {H}x{W}"
    kernel = RasterLaunches(tr)
    env = make(uid, num_envs=n_envs, obs_mode="state", control_mode="pd_joint_delta_pos", device=dev)
    scene = env.unwrapped.scene
    zero = torch.zeros(n_envs, 8, device=dev)
    pose = look_at([0.3, 0.3, 0.4], [0.0, 0.0, 0.05])
    cam = StereoDepthCamera(StereoDepthCameraConfig("stereo", pose, W, H, np.pi / 2, 0.01, 10.0), scene)
    env.reset(seed=0)
    cam.get_obs(rgb=True, depth=True, segmentation=True)  # builds the mesh
    torch.cuda.synchronize()
    kernel.launches = 0
    env.reset(seed=0)
    obs = cam.get_obs(rgb=True, depth=True, segmentation=True)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        env.step(zero)
        obs = cam.get_obs(rgb=True, depth=True, segmentation=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel.launches
    check(launches == 2 * (1 + n_steps), f"{name}: kernel launches {launches} != 2 x observations {2 * (1 + n_steps)}")
    depth, seg = obs["depth"], obs["segmentation"]
    check(tuple(depth.shape) == (n_envs, H, W, 1) and depth.dtype == torch.int16, f"{name}: depth {depth.shape}")
    m = STEREO_PLAIN_ENVS
    mesh = cam._get_mesh()
    wv = mesh.world_vertices(*geom_poses(scene.model, scene.data))
    z_plain, err, eyes = [], 0.0, []
    for eye, view in (("left", cam._view_matrix()), ("right", cam.right_view_matrix())):
        inputs = tiled_inputs(mesh, wv, view, cam.proj, H, W, lights=scene.lights)
        zk, sk, _, dk = tr.rasterize_tiles(*inputs, H, W)
        zp, sp, _, _ = tr.rasterize_tiles_ref(*[a[:m] for a in inputs[:5]], inputs[5], H, W)
        check(int(dk) == 0 and bool(torch.equal(sk[:m], sp)), f"{name} {eye}: seg differs from the plain version")
        err = max(err, (zk[:m] - zp).abs().max().item())
        z_plain.append(torch.where(sp >= 0, zp, 0.0))
        eyes.append((eye, inputs))
    kernel.launches = launches  # comparison launches are not main-path launches
    plain = stereo_depth(z_plain[0], z_plain[1], cam.fx, cam.baseline, cam.disparity_levels)
    differ = int((plain != depth[:m]).sum())
    check(differ == 0, f"{name}: int16 depth differs from the plain stereo depth on {differ} px")
    fg = seg > 0
    shadow = int((fg & (depth == 0)).sum())
    check(shadow > 0 and bool((depth[fg] > 0).float().mean() > 0.5),
          f"{name}: {shadow} occlusion-shadow px, valid share of the foreground "
          f"{float((depth[fg] > 0).float().mean()):.3f}")
    obs_ms = cuda_ms(lambda: cam.get_obs(rgb=True, depth=True, segmentation=True), 5)
    kernel.launches = launches
    for eye, inputs in eyes:
        times = raster_times(tr, inputs, H, W)
        paths[f"stereo_depth_{n_envs}_{eye}"] = dict(launches=launches // 2, **times)
        print_raster_times(f"{name} {eye} eye", f"{n_envs}x{H}x{W}, {inputs[0].shape[1]} faces", times, card)
    print(f"{name}: reset + {n_steps} steps with an observation after each: kernel launches {launches} (2 per "
          f"observation), dropped 0; the last observation's int16 depth of {m} envs equal to the plain version's "
          f"through the same stereo code; {shadow} of {int(fg.sum())} foreground px invalidated as occlusion "
          f"shadows ({shadow / max(int(fg.sum()), 1):.4f}); {wall_s / n_steps * 1e3:.2f} ms per step + observation, "
          f"the observation alone {obs_ms:.4f} ms {card}")
    return err


def camera_inputs(base, cam, hidden, tiled_inputs, geom_poses):
    """The tiled rasterizer's inputs for ``cam``'s frame of the current state."""
    mesh = cam._get_mesh(tuple(hidden))
    gpos, gquat = geom_poses(base.scene.model, base.scene.data)
    return tiled_inputs(mesh, mesh.world_vertices(gpos, gquat), cam._view_matrix(), cam.proj,
                        cam.config.height, cam.config.width, lights=base.scene.lights)


def rt_tests(cam, n_envs: int) -> int:
    """Ray-triangle tests of one path-traced frame: envs x pixels x rays per
    pixel x faces, rays per pixel = spp x (1 primary + a shadow ray per
    directional light + 1 indirect where bounces > 0)."""
    from maniskill_tpu_torch.render.pathtracer import RT_PACKS

    cfg = RT_PACKS[cam.config.shader_pack]
    lights = sum(1 for l in cam.scene.lights if l["kind"] == "directional") or 1
    rays = cfg["spp"] * (1 + lights + (1 if cfg["bounces"] > 0 else 0))
    return n_envs * cam.config.height * cam.config.width * rays * cam._get_mesh(()).num_faces


def rt_bound_ms(cam, n_envs: int, buf):
    """(bound ms, "bytes" or "operations") of a path-traced frame: its
    ray-triangle tests at RT_INSTR_PER_TEST FP32 instructions each, or the
    world vertices and face table read once and the buffers written once."""
    mesh = cam._get_mesh(())
    nbytes = n_envs * mesh.verts.shape[-2] * 12 + mesh.num_faces * (24 + 12 + 4) + sum(
        v.numel() * v.element_size() for v in buf.values())
    t_ops = rt_tests(cam, n_envs) * RT_INSTR_PER_TEST / PEAK_FP32_INSTR_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rt_phase(torch, dev, make, card):
    """Phase 53: the ray-traced packs on PickCube-v1's cameras through
    ``Camera.capture`` (plain torch on the card). First RT_PLAIN's rt-fast
    frame held to the CPU port from the same state and draws, and a profiled
    render of it (0 syncs, 0 host-to-device copies); then each of RT_FRAMES
    timed once with CUDA events, with its ray-triangle tests, bound, share and
    peak memory."""
    from maniskill_tpu_torch.render import pathtracer as tpt
    from maniskill_tpu_torch.utils.timing import profile_calls

    n, H, W = RT_PLAIN
    cams = dict(human_render_camera_configs=dict(width=W, height=H, shader_pack="rt-fast"))
    envs = [make("PickCube-v1", num_envs=n, obs_mode="state", device=d, **cams).unwrapped
            for d in (dev, torch.device("cpu"))]
    gpu, cpu = envs
    gpu.reset(seed=0)
    cpu.reset(options=dict(reset_to_env_states=tree_to(gpu.get_state_dict(), "cpu")))
    seed = gpu.scene.render_seed()
    jitter = torch.stack([tpt.render_draws(seed, s, n, H * W, False)[0] for s in range(2)])
    bufs = []
    for env in envs:
        _, buf = env._human_render_cameras["render_camera"].capture(draws=dict(jitter=jitter.to(env.device)))
        bufs.append({k: v.cpu() for k, v in buf.items()})
    k, c = bufs
    agree = (k["seg"] == c["seg"]) & (k["valid"] == c["valid"])
    near = torch.nn.functional.max_pool2d((~agree).float()[:, None], 3, 1, 1)[:, 0] == 0
    err = max(float((k[key][near] - c[key][near]).abs().max()) for key in ("color", "depth", "normal", "albedo"))
    check(float(agree.float().mean()) >= SEG_AGREE_MIN and err <= RT_CPU_TOL,
          f"rt-fast {n}x{H}x{W}: seg/valid agree on {float(agree.float().mean()):.5f}, max error {err:.2e} "
          f"against the CPU port")
    cam = gpu._human_render_cameras["render_camera"]
    _, prof = profile_calls(lambda: cam.capture(), 1)
    check(prof["syncs"] == 0 and prof["h2d_copies"] == 0,
          f"rt-fast render: {prof['syncs']} syncs, {prof['h2d_copies']} host-to-device copies")
    print(f"rt-fast {n}x{H}x{W}: the card's frame and the CPU port's from one state and the same draws: "
          f"seg/valid agree on {float(agree.float().mean()):.6f}, color/depth/normal/albedo within {err:.2e} where "
          f"the 3x3 neighbourhood agrees; a profiled render: {prof['launches']:.0f} launches, {prof['syncs']:.0f} "
          f"syncs, {prof['h2d_copies']:.0f} host-to-device copies, device kernels {prof['device_kernel_ms']:.3f} of "
          f"{prof['wall_ms']:.3f} ms (idle {prof['device_idle_share']:.3f}) {card}")
    for name, ms in list(prof["top_kernels_ms"].items())[:5]:
        print(f"  {ms:9.3f} ms  {name}")
    del envs, gpu, cpu, bufs, cam

    for pack, n, which, H, W in RT_FRAMES:
        if which == "human":
            cfg = dict(human_render_camera_configs=dict(width=W, height=H, shader_pack=pack))
        else:
            cfg = dict(sensor_configs=dict(width=W, height=H, shader_pack=pack))
        env = make("PickCube-v1", num_envs=n, obs_mode="state", device=dev, **cfg)
        base = env.unwrapped
        env.reset(seed=0)
        cam = base._human_render_cameras["render_camera"] if which == "human" else base._sensors["base_camera"]
        hidden = () if which == "human" else tuple(base._hidden_objects)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, buf = cam.capture(hidden)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        valid = float(buf["valid"].float().mean())
        check(bool(torch.isfinite(buf["color"]).all()) and 0.2 < valid <= 1.0,
              f"rt {pack} {n}x{H}x{W}: color not finite or valid share {valid:.3f}")
        tests = rt_tests(cam, n)
        bound, by = rt_bound_ms(cam, n, buf)
        print(f"rt {pack} {which} camera {n}x{H}x{W}: {ms:.1f} ms/frame (one frame, CUDA events), {tests:.4e} "
              f"ray-triangle tests ({cam._get_mesh(()).num_faces} faces), bound {bound:.2f} ms ({by}), "
              f"{bound / ms:.5f} of it; peak memory {peak / 1e9:.3f} GB ({(peak - held) / 1e9:.3f} GB above the "
              f"env's {held / 1e9:.3f} GB), foreground {valid:.3f} {card}")
        del env, base, cam, buf


def tree_to(x, device):
    return {k: tree_to(v, device) for k, v in x.items()} if isinstance(x, dict) else x.to(device)


def render_modes_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 54's first half: PickCube-v1 at RENDER_MODES's envs, the human
    and the sensor camera at 128x128, ``render()`` in "rgb_array",
    "sensors" and "all": 1, 1 and 2 kernel launches, "all" the two side by
    side, the first 16 envs of each camera re-rendered through the plain
    version. Returns the kernel's max 1/z error."""
    from maniskill_tpu_torch.utils.timing import cuda_ms

    n, H, W = RENDER_MODES
    kernel = RasterLaunches(tr)
    env = make("PickCube-v1", num_envs=n, obs_mode="state", render_mode="rgb_array", device=dev,
               human_render_camera_configs=dict(width=W, height=H), sensor_configs=dict(width=W, height=H))
    base = env.unwrapped
    zero = torch.zeros(n, 8, device=dev)
    env.reset(seed=0)
    for _ in range(2):
        env.step(zero)
    cams = dict(rgb_array=(base._human_render_cameras["render_camera"], ()),
                sensors=(base._sensors["base_camera"], tuple(base._hidden_objects)))
    frames = {}
    for mode, expect in (("rgb_array", 1), ("sensors", 1), ("all", 2)):
        base.render_mode = mode
        kernel.launches = 0
        frames[mode] = env.render()
        torch.cuda.synchronize()
        launches = kernel.launches
        check(launches == expect and tuple(frames[mode].shape) == (n, H, W * expect, 3),
              f"render {mode}: {launches} launches, frame {tuple(frames[mode].shape)}")
        ms = cuda_ms(env.render, 5)
        kernel.launches = launches
        print(f"pickcube render {mode} @{n}: {launches} kernel launches, frame {tuple(frames[mode].shape)}, "
              f"{ms:.3f} ms per render {card}")
    check(bool(torch.equal(frames["all"], torch.cat([frames["rgb_array"], frames["sensors"]], 2))),
          "render all: not the rgb_array and sensors frames side by side")
    err = 0.0
    for mode, (cam, hidden) in cams.items():
        inputs = camera_inputs(base, cam, hidden, tiled_inputs, geom_poses)
        before = kernel.launches
        zk, _, _, _ = tr.rasterize_tiles(*inputs, H, W)
        zp, _, rp, _ = tr.rasterize_tiles_ref(*[a[:16] for a in inputs[:5]], inputs[5], H, W)
        kernel.launches = before  # comparison launches are not main-path launches
        plain = (torch.clamp(rp, 0, 1) * 255).to(torch.uint8)
        check(bool(torch.equal(plain, frames[mode][:16])), f"render {mode}: differs from the plain re-render")
        err = max(err, float((zk[:16] - zp).abs().max()))
        times = raster_times(tr, inputs, H, W)
        paths[f"pickcube_render_{mode}_{n}"] = dict(launches=1, **times)
        paths[f"pickcube_render_all_{n}_{mode}"] = dict(launches=1, **times)  # "all" draws both cameras
        print_raster_times(f"pickcube render {mode}", f"{n}x{H}x{W}; 16 envs equal to the plain re-render", times,
                           card)
    return err


def bench_render_phase(torch, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 55's second half: ``bench_render`` at its defaults (its JSON
    line printed by the CLI), its launches on the kernel's paths."""
    from maniskill_tpu_torch.examples.benchmarking import bench_render

    kernel = RasterLaunches(tr)
    kernel.launches = 0
    out = bench_render.main([])
    launches = kernel.launches
    base = out["env"].unwrapped
    cam = base._sensors["base_camera_0"]
    check(launches == 3 + BENCH_RENDER_STEPS and out["value"] > 0,
          f"bench_render: {launches} launches (two resets, a warm-up step and {BENCH_RENDER_STEPS} steps), "
          f"{out['value']} fps")
    inputs = camera_inputs(base, cam, (), tiled_inputs, geom_poses)
    times = raster_times(tr, inputs, 128, 128)
    paths["bench_render_cartpole_1024"] = dict(launches=launches, **times)
    print(f"bench_render: {out['value']} env*frames/s, vs_baseline {out['vs_baseline']} (RTX 4090: 32,138), "
          f"{launches} kernel launches {card}")
    print_raster_times("bench_render cartpole", "1024x128x128", times, card)


def read_jpeg_part(port):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stream", timeout=60) as r:
        check(r.readline() == b"--f\r\n" and r.readline() == b"Content-Type: image/jpeg\r\n", "stream part header")
        size = int(r.readline().split(b":")[1])
        r.readline()
        return r.read(size)


def jpeg_size(jpeg: bytes):
    """(height, width) from a baseline JPEG's SOF0 segment."""
    pos = jpeg.index(b"\xff\xc0")
    return int.from_bytes(jpeg[pos + 5:pos + 7], "big"), int.from_bytes(jpeg[pos + 7:pos + 9], "big")


def viewer_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses):
    """Phase 54's second half: a BrowserViewer on localhost serving
    PickCube-v1's human camera (JPEG parts read from /stream, an event and
    the status round-tripped), then ``interactive_panda --browser`` at one
    env driven by posted 'w' events. Returns its kernel launches and the
    last frame's inputs (on the host)."""
    import json as _json
    import threading
    import urllib.request

    from maniskill_tpu_torch.examples.teleoperation import interactive_panda
    from maniskill_tpu_torch.viewer import BrowserViewer

    def post(port, ev):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/event", data=_json.dumps(ev).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status

    env = make("PickCube-v1", num_envs=1, obs_mode="state", render_mode="rgb_array", device=dev)
    env.reset(seed=0)
    frame = env.render()[0]
    viewer = BrowserViewer(port=0, host="127.0.0.1")
    try:
        t0 = time.perf_counter()
        viewer.push_frame(frame)
        push_ms = (time.perf_counter() - t0) * 1e3
        jpeg = read_jpeg_part(viewer.port)
        check(jpeg[:2] == b"\xff\xd8" and jpeg[-2:] == b"\xff\xd9" and jpeg_size(jpeg) == tuple(frame.shape[:2]),
              f"viewer: a {len(jpeg)}-byte part of size {jpeg_size(jpeg)}")
        check(post(viewer.port, {"type": "key", "key": "w"}) == 204
              and viewer.poll_events() == [{"type": "key", "key": "w"}], "viewer: the event did not come back")
        viewer.set_status({"step": 1})
        with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/api/status", timeout=60) as r:
            check(_json.loads(r.read()) == {"step": 1}, "viewer: status")
    finally:
        viewer.close()
    print(f"viewer: a 512x512 frame encoded and published in {push_ms:.1f} ms ({len(jpeg)} bytes), read back from "
          f"/stream; an event and the status round-tripped {card}")

    def drive(v):
        def run():
            read_jpeg_part(v.port)
            for _ in range(3):
                post(v.port, {"type": "key", "key": "w"})
                time.sleep(0.5)
            post(v.port, {"type": "key", "key": "q"})

        threading.Thread(target=run, daemon=True).start()

    RasterLaunches(tr).launches = 0
    t0 = time.perf_counter()
    out = interactive_panda.main(["--env-id", "PickCube-v1", "--browser", "0", "--max-steps", "3"], on_start=drive)
    wall = time.perf_counter() - t0
    launches = RasterLaunches(tr).launches
    steps = len(out["tcp"])
    moved = float(out["tcp"][-1][0] - out["tcp0"][0]) if steps else 0.0
    check(1 <= steps <= 3 and moved > 0.005 and launches == 1 + steps,
          f"interactive_panda --browser: {steps} steps, TCP +x {moved:.4f} m, {launches} kernel launches")
    print(f"interactive_panda --browser: {steps} steps from posted events, the TCP {moved * 1e3:.1f} mm along +x, "
          f"{launches} kernel launches, {wall:.2f} s {card}")
    base = out["env"].unwrapped
    inputs = camera_inputs(base, base._human_render_cameras["render_camera"], (), tiled_inputs, geom_poses)
    return launches, [x.cpu() if isinstance(x, torch.Tensor) else x for x in inputs]


def gpu_sim_phase(card, tmp):
    """Phase 55's first half: ``gpu_sim`` PickCube-v1 at GPU_SIM's envs and
    steps, its CSV row printed."""
    import csv as _csv

    from maniskill_tpu_torch.examples.benchmarking import gpu_sim

    uid, n, steps = GPU_SIM
    path = f"{tmp}/gpu_sim.csv"
    out = gpu_sim.main(["-e", uid, "-n", str(n), "--num-steps", str(steps), "--save-results", path])
    with open(path) as f:
        (row,) = list(_csv.DictReader(f))
    check(float(row["env.step/fps"]) > 0 and float(row["gpu_mem_mb"]) > 0, f"gpu_sim: {row}")
    print(f"gpu_sim CSV row: {json.dumps(row)} {card}")
    return out


def demos_phase(torch, card, tr, tiled_inputs, geom_poses, tmp):
    """Phase 56: the seven demo scripts at one env on the card
    (demo_reset_distribution under rt-fast, demo_manual_control fed a key
    script). Returns their kernel launches and the last sensor frame's
    inputs (on the host)."""
    from maniskill_tpu_torch.examples import (demo_manual_control, demo_random_action, demo_reset_distribution,
                                              demo_robot, demo_vis_pcd, demo_vis_segmentation, demo_vis_textures)

    RasterLaunches(tr).launches = 0
    seconds = {}

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    out = run("random_action", lambda: demo_random_action.main(["-e", "PushCube-v1", "-n", "1", "--steps", "10"]))
    check(np.isfinite(out["reward"]).all(), "demo_random_action: reward not finite")
    out = run("reset_distribution", lambda: demo_reset_distribution.main(
        ["-e", "PickCube-v1", "-n", "2", "--shader", "rt-fast", "--record-dir", f"{tmp}/resets"]))
    frames = np.load(out["path"])["frames"]
    check(frames.shape == (2, 512, 512, 3) and frames.std() > 5 and not np.array_equal(frames[0], frames[1]),
          f"demo_reset_distribution rt-fast: frames {frames.shape}, std {frames.std():.1f}")
    out = run("robot", lambda: demo_robot.main(["-r", "panda", "--keyframes", "--steps", "5",
                                                 "--save-frames", f"{tmp}/kf"]))
    check(out["dof"] == 9 and np.abs(out["settled"]["rest"][:7] - [0, np.pi / 8, 0, -5 * np.pi / 8, 0,
                                                                  3 * np.pi / 4, np.pi / 4]).max() < 0.05,
          f"demo_robot: {out['settled']}")
    keys = iter("wwgq")
    demo_manual_control._read_key = lambda: next(keys)
    out = run("manual_control", lambda: demo_manual_control.main(["-e", "PickCube-v1", "-c", "pd_ee_delta_pos",
                                                                  "--save-frames", f"{tmp}/manual"]))
    check(out["action"].shape == (3, 4), f"demo_manual_control: actions {out['action'].shape}")
    out = run("vis_pcd", lambda: demo_vis_pcd.main(["-e", "PushCube-v1", "-o", f"{tmp}/pcd.ply"]))
    check(len(out["xyz"]) > 1000 and np.isfinite(out["xyz"]).all(), f"demo_vis_pcd: {len(out['xyz'])} points")
    out = run("vis_segmentation", lambda: demo_vis_segmentation.main(["-o", f"{tmp}/seg.png"]))
    ids = set(np.unique(out["seg"]).tolist()) - {0}
    check(ids and ids <= set(out["legend"]), f"demo_vis_segmentation: ids {ids} outside the legend")
    out = run("vis_textures", lambda: demo_vis_textures.main(["-o", "rgb+depth+normal+segmentation",
                                                              "--out", f"{tmp}/tex.png"]))
    check(len(out["names"]) == 4 and out["tiled"].shape == (256, 256, 3), f"demo_vis_textures: {out['names']}")
    launches = RasterLaunches(tr).launches
    check(launches > 0, "the demos made no kernel launch")
    print("demos at one env: " + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
          + f"; {launches} kernel launches (the rasterized frames) {card}")
    base = out["env"].unwrapped
    inputs = camera_inputs(base, base._sensors["base_camera"], tuple(base._hidden_objects), tiled_inputs, geom_poses)
    return launches, [x.cpu() if isinstance(x, torch.Tensor) else x for x in inputs]


class StubFollower:
    """A LeRobot SO100 follower arm with no hardware: its bus reads back the
    commanded degrees, its camera serves one fixed uint8 frame."""

    name = "so100_follower"

    def __init__(self, deg):
        self.bus = self
        self.pos = dict(zip(SO100_MOTORS, (float(d) for d in deg)))
        self.cameras = {"base_camera": self}
        h, w = SIM2REAL_FRAME
        self.frame = (np.arange(h * w * 3) % 251).astype(np.uint8).reshape(h, w, 3)
        self.sent = 0

    def sync_read(self, what):
        return dict(self.pos)

    def send_action(self, action):
        self.sent += 1
        self.pos = {k: float(action[f"{k}.pos"]) for k in SO100_MOTORS}

    def async_read(self):
        return self.frame

    def connect(self):
        pass

    def disconnect(self):
        pass


def sim2real_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths):
    """Phase 57: Sim2RealEnv on the card over LeRobotRealAgent and a stub
    SO100 follower. Returns the kernel's max error on its frames."""
    from maniskill_tpu_torch.agents.robots.lerobot import LeRobotRealAgent
    from maniskill_tpu_torch.envs.sim2real_env import Sim2RealEnv, _center_crop_resize
    from maniskill_tpu_torch.utils.timing import profile_calls
    from maniskill_tpu_torch.wrappers.flatten import FlattenRGBDObservationWrapper

    uid, n_resets, n_steps = SIM2REAL
    t0 = time.perf_counter()
    sim = FlattenRGBDObservationWrapper(make(uid, num_envs=1, obs_mode="rgb", device=dev), rgb=True, depth=False,
                                        state=True)
    base = sim.unwrapped
    offsets = np.array([LeRobotRealAgent.CALIBRATION_OFFSETS_DEG["so100_follower"].get(k, 0.0)
                        for k in SO100_MOTORS])
    stub = StubFollower(np.rad2deg(base.agent.robot.qpos[0].cpu().numpy()) + offsets)
    frames, max_err = [], 0.0

    def reset_fn(env, seed=None, options=None):  # the default's sim reset and soft move, with no prompt
        frames.append(env.sim_env.reset(seed=seed, options=options)[0])
        env.agent.reset(env.base_sim_env.agent.robot.qpos.cpu().numpy().reshape(-1))

    RasterLaunches(tr).launches = 0
    env = Sim2RealEnv(sim, LeRobotRealAgent(stub), real_reset_function=reset_fn)
    obs = None
    for i in range(n_resets):
        obs, _ = env.reset(seed=i)
    zero = np.zeros(base.single_action_space.shape, np.float32)
    stub_qpos = lambda: np.deg2rad(np.array([stub.pos[k] for k in SO100_MOTORS]) - offsets)  # noqa: E731
    gaps = []
    t1 = time.perf_counter()
    for _ in range(n_steps):
        obs, rew, term, trunc, info = env.step(zero)
        gaps.append(float(np.abs(base.agent.robot.qpos[0].cpu().numpy() - stub_qpos()).max()))
    step_s = (time.perf_counter() - t1) / n_steps
    launches = RasterLaunches(tr).launches
    total_s = time.perf_counter() - t0
    check(launches == 2 + n_resets, f"sim2real: {launches} kernel launches, not one per sim reset ({2 + n_resets})")
    check(max(gaps) <= SIM2REAL_QPOS_TOL, f"sim2real: sim qpos off the stub's by {max(gaps):.2e}")
    want = torch.as_tensor(_center_crop_resize(stub.frame, 128, 128), device=dev)[None]
    check(tuple(obs["rgb"].shape) == (1, 128, 128, 3) and obs["rgb"].device.type == "cuda"
          and bool(torch.equal(obs["rgb"], want)), f"sim2real: real frame {tuple(obs['rgb'].shape)} on "
          f"{obs['rgb'].device}, not the stub's cropped and resized")
    sim_state = frames[-1]["state"]
    check(obs["state"].shape == sim_state.shape and obs["state"].dtype == sim_state.dtype
          and bool(torch.isfinite(obs["state"]).all()),
          f"sim2real: state {tuple(obs['state'].shape)} against the sim's {tuple(sim_state.shape)}")
    check(stub.sent >= n_steps, f"sim2real: {stub.sent} commands sent to the robot in {n_steps} steps")
    with sync_guard(torch, "sim2real _sync_sim_from_real"):
        env._sync_sim_from_real()
    # the profiler now and then loses a device record, a copy's too, and never
    # adds one (scripts/profiler_record_loss.py): at most one copy may show
    for _ in range(3):
        _, prof = profile_calls(env._sync_sim_from_real, 1)
        if prof["h2d_copies"] == 1:
            break
    check(prof["syncs"] == 0 and prof["h2d_copies"] <= 1,
          f"sim2real sync: {prof['syncs']} syncs, {prof['h2d_copies']} host-to-device copies (the real qpos "
          f"only expected)")
    # the last sim frame (the last reset's, before its sync) is held to the
    # plain version by rerendering its state: take the frame's inputs now
    inputs = camera_inputs(base, base._sensors["base_camera"], tuple(base._hidden_objects), tiled_inputs, geom_poses)
    before = RasterLaunches(tr).launches
    zk, sk, rk, dk = tr.rasterize_tiles(*inputs, 128, 128)
    zp, sp, rp, dp = tr.rasterize_tiles_ref(*inputs, 128, 128)
    RasterLaunches(tr).launches = before
    torch.cuda.synchronize()
    check(bool(torch.equal(zk.view(torch.int32), zp.view(torch.int32)) & torch.equal(sk, sp) & torch.equal(rk, rp))
          and int(dk) == 0, "sim2real: the kernel's frame differs from the plain version's")
    max_err = max(max_err, (zk - zp).abs().max().item())
    times = raster_times(tr, inputs, 128, 128)
    paths["sim2real_so100_1"] = dict(launches=launches, **times)
    env.close()
    print(f"sim2real {uid} x1 (rgb + state, LeRobotRealAgent over a stub follower): construction with the data "
          f"check, {n_resets} resets and {n_steps} steps in {total_s:.2f} s; {step_s:.4f} s per real step against "
          f"control_dt {env.control_dt:.4f} s; sim qpos within {max(gaps):.2e} of the robot's after every step; "
          f"_sync_sim_from_real: {prof['syncs']:.0f} syncs, {prof['h2d_copies']:.0f} host-to-device copies read "
          f"by the profiler (at most the real qpos's), {prof['launches']:.0f} launches, {prof['wall_ms']:.2f} ms; {launches} kernel launches (one per sim reset) {card}")
    print_raster_times("sim2real so100", "1x128x128", times, card)
    return max_err


def sharded_ppo_phase(torch, dev, card):
    """Phase 58: make_sharded_ppo_step on the one card; the same trajectory
    through PPOTrainer's update from the same parameters, optimizer state
    and generator."""
    import copy

    from maniskill_tpu_torch.parallel import PPOTrainer, make_sharded_ppo_step

    t0 = time.perf_counter()
    run_once, env = make_sharded_ppo_step([dev], num_envs=SHARDED_PPO_ENVS, smoke=True)
    built_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = run_once()
    step_ms = (time.perf_counter() - t0) * 1e3
    check(np.isfinite(float(metrics["loss"])) and int(metrics["bad_params"]) == 0,
          f"sharded ppo: loss {float(metrics['loss'])}, {int(metrics['bad_params'])} bad params")
    sharded = run_once.trainer
    raw, _ = env.reset(seed=0)
    obs = [sharded.trainers[0].obs_tf(raw)]
    obs, _, trajs = sharded.rollout(obs, [torch.zeros(SHARDED_PPO_ENVS, dtype=torch.int32, device=dev)])
    one = PPOTrainer(env, sharded.config, raw, seed=0)
    one.model.load_state_dict(copy.deepcopy(sharded.model.state_dict()))
    one.optimizer.load_state_dict(copy.deepcopy(sharded.optimizer.state_dict()))
    one.generator.set_state(sharded.generator.get_state())
    got, want = sharded.update(obs, trajs), one.update(obs[0], trajs[0])
    gap = max((p - q).abs().max().item() for p, q in zip(sharded.model.parameters(), one.model.parameters()))
    check(gap == 0.0 and float(got["loss"]) == float(want["loss"]),
          f"sharded ppo on one device: parameters off PPOTrainer's by {gap}")
    print(f"sharded ppo PushCube-v1 x{SHARDED_PPO_ENVS} on [{dev}]: built with its first step in {built_s:.2f} s; "
          f"a train step (rollout 2, 1 epoch, 1 minibatch) {step_ms:.1f} ms, loss {float(metrics['loss']):.5f}; "
          f"the same trajectory through PPOTrainer: parameters within {gap} {card}")
    env.close()


def assets_phase(card):
    """Phase 59: the asset registry's sizes, download_asset of a file:// zip
    (its checksum accepted, a corrupted copy refused) and the five URDF
    generators rewriting the port's URDFs byte for byte."""
    import filecmp
    import hashlib
    import os
    import shutil
    import zipfile
    from pathlib import Path

    from maniskill_tpu_torch import PACKAGE_ASSET_DIR
    from maniskill_tpu_torch.utils import download_asset
    from maniskill_tpu_torch.utils.assets import data

    n_src, n_groups = len(data.DATA_SOURCES), len(data.DATA_GROUPS)
    n_pm = len(data.DATA_GROUPS["partnet_mobility"])
    check((n_src, n_groups) == (ASSET_SOURCES, ASSET_GROUPS),
          f"asset registry: {n_src} sources, {n_groups} groups (expected {ASSET_SOURCES}, {ASSET_GROUPS})")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with zipfile.ZipFile(tmp / "pack.zip", "w") as z:
            z.writestr("pack/robot.urdf", "<robot name='stub'/>")
        sha = hashlib.sha256((tmp / "pack.zip").read_bytes()).hexdigest()
        corrupt = bytearray((tmp / "pack.zip").read_bytes())
        corrupt[len(corrupt) // 2] ^= 0xFF
        (tmp / "bad.zip").write_bytes(bytes(corrupt))
        for uid, name in (("chip_smoke_good", "pack.zip"), ("chip_smoke_bad", "bad.zip")):
            data.register_data_source(uid, source_type="robot", url=f"file://{tmp / name}",
                                      target_path=f"robots/{uid}", checksum=sha, output_dir=tmp / "out")
        try:
            good = download_asset.main(["chip_smoke_good", "-y", "--quiet"])
            bad = download_asset.main(["chip_smoke_bad", "-y", "--quiet"])
        finally:
            for uid in ("chip_smoke_good", "chip_smoke_bad"):
                data.DATA_SOURCES.pop(uid)
        check(good == 0 and (tmp / "out/robots/chip_smoke_good/robot.urdf").exists(),
              f"download_asset of a good zip: rc {good}")
        check(bad == 1 and not (tmp / "out/robots/chip_smoke_bad").exists(),
              f"download_asset of a corrupted zip: rc {bad}")
        src = Path(PACKAGE_ASSET_DIR) / "robots"
        work = tmp / "robots"
        shutil.copytree(src, work)
        for urdf in work.rglob("*.urdf"):
            os.utime(urdf, (0, 0))
        for gen in GENERATORS:
            subprocess.run([sys.executable, Path(gen).name], cwd=work / Path(gen).parent, check=True,
                           capture_output=True, timeout=120)
        rewritten = sorted(str(p.relative_to(work)) for p in work.rglob("*.urdf") if p.stat().st_mtime > 0)
        same = [r for r in rewritten if filecmp.cmp(work / r, src / r, shallow=False)]
        check(len(rewritten) >= 9 and same == rewritten,
              f"URDF generators: {len(same)} of {len(rewritten)} rewritten URDFs equal the port's")
    print(f"assets: {n_src} sources ({n_pm} PartNet-Mobility models), {n_groups} groups; download_asset of a "
          f"file:// zip: checksum accepted (rc {good}), a corrupted copy refused (rc {bad}); the five generators "
          f"rewrote {len(rewritten)} URDFs, byte for byte {card}")


def slice17_worker(card: str):
    """Phases 54 (the viewer, interactive_panda --browser), 55 (gpu_sim), 56
    (the demos) and 59 (the assets) in a process of their own. Returns their seconds and, per
    kernel path, (launches, the last frame's inputs on the host, H, W)."""
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs

    dev = torch.device("cuda")
    seconds, kernel_paths = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launches, inputs = viewer_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses)
        kernel_paths["interactive_panda_browser_1"] = (launches, inputs, 512, 512)
        seconds["54"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gpu_sim_phase(card, tmp)
        seconds["55"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches, inputs = demos_phase(torch, card, tr, tiled_inputs, geom_poses, tmp)
        kernel_paths["demos_1"] = (launches, inputs, 128, 128)
        seconds["56"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        assets_phase(card)
        seconds["59"] = time.perf_counter() - t0
    return seconds, kernel_paths


def data_and_trainer_phases(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths, stamp):
    """Phases 32-38. The two per-episode replays (one env, ~0.3 s a step) and
    the last trainers (phases 35-38) run in processes of their own: RFCL and
    SB3 from the start, DP state and ACT once phase 32's recording exists,
    DP rgb once phase 33's frames do; the planner CLI's wall times, the
    replay kernel's and RLPD's are taken with the card to this process
    alone. Returns the kernel's max error on the rgb paths."""
    with tempfile.TemporaryDirectory() as tmp:
        pool = spawn_pool(6)
        try:
            rfcl = pool.submit(rfcl_sb3_worker, tmp, card + TRAINER_SHARED)
            path, futures, converted = record_phase(torch, dev, make, card, tmp, pool)
            trainers = dict(dp_state=pool.submit(dp_state_worker, path, card + TRAINER_SHARED),
                            act=pool.submit(act_worker, path, card + TRAINER_SHARED))
            max_err, inputs, launches, rgb_path = replay_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses,
                                                               paths, path, tmp)
            trainers["dp_rgb"] = pool.submit(dp_rgb_worker, rgb_path, card + TRAINER_SHARED)
            bc_phase(torch, dev, make, card, path)
            episode_replays_finish(futures, path, card)
            dp_rgb_launches, dp_rgb_inputs, err, dp_rgb_s = trainers["dp_rgb"].result()
            max_err = max(max_err, err)
            seconds = dict(dp_state=trainers["dp_state"].result(), dp_rgb=dp_rgb_s, act=trainers["act"].result(),
                           rfcl_sb3=rfcl.result())
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        stamp("phases 32-33 and 35-38 (" + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
              + " in their processes)")
        replay_kernel_times(tr, paths, inputs, launches, card)
        times = raster_times(tr, [x.to(dev) if isinstance(x, torch.Tensor) else x for x in dp_rgb_inputs], 128, 128)
        paths[f"dp_rgb_eval_pickcube_{IL_EVAL_ENVS}"] = dict(launches=dp_rgb_launches, **times)
        print_raster_times("dp rgb eval pickcube, phase 36's last frame", f"{IL_EVAL_ENVS}x128x128", times, card)
        rlpd_phase(torch, dev, make, card, converted)
    stamp("phase 34")
    return max_err


def main(device: str = "cuda"):
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    try:
        import maniskill_tpu_torch.envs  # noqa: F401
        from maniskill_tpu_torch import make
        from maniskill_tpu_torch.physics.kinematics import geom_poses
        from maniskill_tpu_torch.render import tiled_rasterizer as tr
        from maniskill_tpu_torch.render.rasterizer import tiled_inputs
        from maniskill_tpu_torch.utils.geometry import rotation_conversions as rc
        from maniskill_tpu_torch.utils.timing import cuda_ms, timed_steps
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")

    t_start = time.perf_counter()

    def stamp(done: str):
        print(f"[{time.perf_counter() - t_start:.1f} s] {done} done", flush=True)

    # ---- phase 1: the card --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    dev = torch.device(device)

    # ---- phase 2: build -----------------------------------------------------
    kernel = RasterLaunches(tr)
    tr.build_kernels()  # one nvcc per source, side by side
    for k in (tr.SETUP, tr.KERNEL):
        print(f"build: {k.name}.cu -> sm_90a in {k.build_seconds:.2f} s {card}")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # ---- phase 3: kernel vs plain version -----------------------------------
    rng = np.random.default_rng(0)
    max_err = 0.0
    cases = [
        ("B64 F288 128x128", (64, 288, 128, 128, None)),
        ("B8 F5000 96x160", (8, 5000, 96, 160, None)),
        ("B4 F1500 32x128 overflow", (4, 1500, 32, 128, (2.0, 12.0))),
        ("B1 F333 50x70 ragged", (1, 333, 50, 70, None)),
    ]
    for name, (B, F, H, W, rows) in cases:
        args = [torch.as_tensor(a, device=dev) for a in random_faces(rng, B, F, H, W, rows)]
        raster_times(tr, args, H, W, reps=1)  # each kernel bit-equal to its plain version
        zk, sk, rk, dk = tr.rasterize_tiles(*args, H, W)
        zp, sp, rp, dp = tr.rasterize_tiles_ref(*args, H, W)
        torch.cuda.synchronize()
        check(int(dk) == int(dp), f"{name}: dropped {int(dk)} vs {int(dp)}")
        check(bool(torch.equal(sk, sp)), f"{name}: seg differs on {(sk != sp).sum().item()} px")
        check(bool(torch.equal(rk, rp)), f"{name}: rgb differs on {(rk != rp).any(-1).sum().item()} px")
        check(bool(torch.equal(zk.view(torch.int32), zp.view(torch.int32))),
              f"{name}: depth not bit-equal, max |d| {(zk - zp).abs().max().item()}")
        if rows is not None:
            _, counts, _ = tr.bin_faces(args[0], args[1], tr.face_records(*args)[1], H, W)
            check(int(counts.max()) > 1024 and int(dk) == 0,
                  f"{name}: the fullest band holds {int(counts.max())} faces, dropped {int(dk)}")
        max_err = max(max_err, (zk - zp).abs().max().item(), (rk - rp).abs().max().item())
        print(f"kernels == plain on {name}: raster_setup's table, lists and counts equal, raster_tiles' 1/z "
              f"bit-equal; the frame's seg/rgb equal, depth bit-equal, dropped {int(dk)}, "
              f"fg {(sk >= 0).float().mean().item():.3f}"
              + (f", the fullest band's list {int(counts.max())} entries (walked whole)" if rows else ""))

    stamp("phases 1-3")

    paths = {}  # per rgb path: launches and the kernel's numbers at its shapes

    # ---- phase 4: Cartpole RGB ------------------------------------------------
    uid, n_envs, n_steps = CARTPOLE
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb",
               control_mode="pd_joint_delta_pos", device=dev)
    base = env.unwrapped
    action = torch.zeros(n_envs, 1, device=dev)
    for _ in range(3):  # warm-up outside the counted run
        env.step(action)
    torch.cuda.synchronize()
    print(f"cartpole env built and warmed up in {time.perf_counter() - t0:.2f} s")

    kernel.launches = 0
    obs, _ = env.reset(seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        obs, *_ = env.step(action)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = kernel.launches

    rgb = obs["sensor_data"]["base_camera_0"]["rgb"]
    check(tuple(rgb.shape) == (n_envs, 128, 128, 3) and rgb.dtype == torch.uint8,
          f"rgb is {tuple(rgb.shape)} {rgb.dtype}")
    # every env shows the red cart and the blue pole in front of the grey wall
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    cart_px = (r > g + 50).sum((1, 2))
    pole_px = (b > r + 50).sum((1, 2))
    check(bool((cart_px > 0).all() & (pole_px > 0).all()),
          f"rgb misses the cart or pole in {int(((cart_px == 0) | (pole_px == 0)).sum())} envs")
    data = base.scene.data
    check(bool(torch.isfinite(data.qpos).all() & torch.isfinite(data.qvel).all()), "cartpole state not finite")
    check(launches == 1 + n_steps, f"cartpole kernel launches {launches} != resets + steps {1 + n_steps}")
    inputs, err, agree = rerender_check(base, "base_camera_0", 32, tr, tiled_inputs, geom_poses, rgb, "cartpole")
    max_err = max(max_err, err)
    print(f"cartpole: {n_steps} steps x {n_envs} envs, kernel launches {launches}, dropped 0, "
          f"seg agreement with plain (32 envs) {agree:.6f} (bound {SEG_AGREE_MIN})")

    stamp("phase 4")

    # ---- phase 5: Cartpole timings ------------------------------------------
    times = raster_times(tr, inputs, 128, 128, 50)
    before = kernel.launches
    frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, 128, 128), 20)
    kernel.launches = before
    paths[f"cartpole_rgb_{n_envs}"] = dict(launches=launches, **times)
    print(f"cartpole rate: {n_envs * n_steps / step_s:.1f} env-steps/s "
          f"({step_s / n_steps * 1e3:.2f} ms/step, eager) {card}")
    print_raster_times("cartpole", f"{n_envs}x128x128", times, card)
    print(f"cartpole tiled render (raster_setup + raster_tiles): {frame_ms:.4f} ms/frame {card}")
    del env, base, inputs

    stamp("phase 5")

    # ---- phase 6: PickCube-v1 state, 4096 envs ------------------------------
    uid, n_envs, n_steps = PICKCUBE_STATE
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="state",
               control_mode="pd_joint_delta_pos", device=dev)
    base = env.unwrapped
    action = torch.zeros(n_envs, 8, device=dev)
    env.reset(seed=0)
    for _ in range(3):
        env.step(action)
    torch.cuda.synchronize()
    print(f"pickcube state env built and warmed up in {time.perf_counter() - t0:.2f} s")
    env.reset(seed=0)
    step_s = timed_steps(env, action, n_steps)
    data = base.scene.data
    check(bool(torch.isfinite(data.qpos).all() & torch.isfinite(data.qvel).all()), "pickcube state not finite")
    check(int(data.contact.overflow.max()) == 0,
          f"pickcube contact overflow in {int((data.contact.overflow > 0).sum())} envs")
    cube_z = base.cube.pose.p[:, 2]
    check(float((cube_z - 0.02).abs().max()) <= 1e-3, f"cube z off 0.02 by {float((cube_z - 0.02).abs().max())}")
    force = base.scene.get_pairwise_contact_forces(base.table_scene.table, base.cube)
    rel = float(((force[:, 2] - CUBE_WEIGHT).abs() / CUBE_WEIGHT).max())
    check(rel <= 0.02, f"table force on the cube off its weight by {rel:.4f} (relative)")
    print(f"pickcube state: {n_steps} steps x {n_envs} envs, finite, overflow 0, cube z within "
          f"{float((cube_z - 0.02).abs().max()):.2e} m of 0.02, table force {float(force[:, 2].mean()):.5f} N "
          f"(weight {CUBE_WEIGHT:.5f} N, max rel err {rel:.2e})")
    print(f"pickcube state rate: {n_envs * n_steps / step_s:.1f} env-steps/s "
          f"({step_s / n_steps * 1e3:.2f} ms/step, eager) {card}")

    # ---- phase 7: PickCube-v1 grasp, 4096 envs ------------------------------
    env.reset(seed=1)
    state = base.get_state_dict()
    tcp = base.agent.tcp_pose.raw_pose
    hand_z = rc.quaternion_apply(tcp[:, 3:], torch.tensor([0.0, 0.0, 1.0], device=dev))
    yaw = torch.tensor([np.cos(0.075), 0.0, 0.0, np.sin(0.075)], dtype=torch.float32, device=dev)
    quat = rc.quaternion_multiply(tcp[:, 3:], yaw.expand(n_envs, 4))
    state["actors"]["cube"] = torch.cat(
        [tcp[:, :3] - 0.015 * hand_z, quat, torch.zeros(n_envs, 6, device=dev)], -1)
    env.reset(options=dict(reset_to_env_states=state))
    close = torch.zeros(n_envs, 8, device=dev)
    close[:, 7] = -1.0
    for n in range(1, 6):
        _, _, _, _, info = env.step(close)
        if bool(info["is_grasped"].all()):
            break
    grasped = int(info["is_grasped"].sum())
    check(grasped == n_envs, f"pickcube grasp: {grasped} of {n_envs} envs grasp after {n} steps")
    check(int(base.scene.data.contact.overflow.max()) == 0, "pickcube grasp: contact overflow")
    finger = base.scene.get_pairwise_contact_forces(base.agent.finger1_link, base.cube)
    print(f"pickcube grasp: all {n_envs} envs grasp after {n} steps, finger force "
          f"{float(finger.norm(dim=-1).mean()):.3f} N mean")
    del env, base, state, data

    stamp("phases 6-7")

    # ---- phase 8: PickCube-v1 rgb, 2048 envs --------------------------------
    uid, n_envs, n_steps = PICKCUBE_RGB
    t0 = time.perf_counter()
    env = make(uid, num_envs=n_envs, obs_mode="rgb",
               control_mode="pd_joint_delta_pos", device=dev)
    base = env.unwrapped
    action = torch.zeros(n_envs, 8, device=dev)
    env.reset(seed=0)
    for _ in range(3):
        env.step(action)
    torch.cuda.synchronize()
    print(f"pickcube rgb env built and warmed up in {time.perf_counter() - t0:.2f} s")
    kernel.launches = 0
    env.reset(seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        obs, *_ = env.step(action)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = kernel.launches
    rgb = obs["sensor_data"]["base_camera"]["rgb"]
    check(tuple(rgb.shape) == (n_envs, 128, 128, 3) and rgb.dtype == torch.uint8,
          f"pickcube rgb is {tuple(rgb.shape)} {rgb.dtype}")
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    cube_px = ((r > g + 80) & (r > b + 80)).sum((1, 2))
    check(bool((cube_px > 0).all()), f"the red cube is missing in {int((cube_px == 0).sum())} envs")
    check(launches == 1 + n_steps, f"pickcube rgb kernel launches {launches} != resets + steps {1 + n_steps}")
    check(int(base.scene.data.contact.overflow.max()) == 0, "pickcube rgb: contact overflow")
    inputs, err, agree = rerender_check(base, "base_camera", 16, tr, tiled_inputs, geom_poses, rgb, "pickcube rgb")
    max_err = max(max_err, err)
    times = raster_times(tr, inputs, 128, 128, 20)
    before = kernel.launches
    frame_ms = cuda_ms(lambda: tr.rasterize_tiles(*inputs, 128, 128), 10)
    kernel.launches = before
    paths[f"pickcube_rgb_{n_envs}"] = dict(launches=launches, **times)
    print(f"pickcube rgb: {n_steps} steps x {n_envs} envs, kernel launches {launches}, dropped 0, "
          f"seg agreement with plain (16 envs) {agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal")
    print(f"pickcube rgb rate: {n_envs * n_steps / step_s:.1f} env-steps/s "
          f"({step_s / n_steps * 1e3:.2f} ms/step, eager) {card}")
    print_raster_times("pickcube", f"{n_envs}x128x128", times, card)
    print(f"pickcube tiled render (raster_setup + raster_tiles): {frame_ms:.4f} ms/frame {card}")
    print(f"pickcube faces in the scene {inputs[0].shape[1]}")
    del env, base, inputs, obs, rgb

    stamp("phase 8")

    # ---- phase 9: Franka benchmarks, state ----------------------------------
    for uid, n_envs, n_steps in FRANKA:
        env = make(uid, num_envs=n_envs, obs_mode="state", control_mode="pd_joint_delta_pos", device=dev)
        base = env.unwrapped
        action = torch.zeros(n_envs, 8, device=dev)
        env.reset(seed=0)
        for _ in range(3):
            env.step(action)
        env.reset(seed=0)
        step_s = timed_steps(env, action, n_steps)
        data = base.scene.data
        check(bool(torch.isfinite(data.qpos).all() & torch.isfinite(data.qvel).all()), f"{uid}: state not finite")
        check(int(data.contact.overflow.max()) == 0, f"{uid}: contact overflow")
        print(f"{uid}: {n_steps} steps x {n_envs} envs, finite, overflow 0, "
              f"{n_envs * n_steps / step_s:.1f} env-steps/s ({step_s / n_steps * 1e3:.2f} ms/step, eager) {card}")
        del env, base, data

    stamp("phase 9")

    # ---- phases 10-11: PPO state, PickCube-v1 --------------------------------
    env, trainer, _, _ = ppo_phase(torch, dev, make, card, "state", PPO_STATE, None,
                                   profile_steps=PPO_STATE_PROFILE_STEPS)
    stamp("phase 10")
    evaluate_checkpoint(torch, env, trainer, STATE_CKPT, STATE_SUCCESS_MIN, card)
    del env, trainer

    stamp("phase 11")

    # ---- phases 12-13: PPO rgb, PushCube-v1 ---------------------------------
    env, trainer, obs, launches = ppo_phase(torch, dev, make, card, "rgb", PPO_RGB, kernel,
                                            profile_steps=PPO_RGB_PROFILE_STEPS)
    base = env.unwrapped
    inputs, err, agree = rerender_check(base, "base_camera", 16, tr, tiled_inputs, geom_poses, obs["rgb"],
                                        "pushcube ppo rgb")
    max_err = max(max_err, err)
    times = raster_times(tr, inputs, 128, 128, 20)
    n_envs = PPO_RGB[1]
    paths[f"pushcube_ppo_rgb_{n_envs}"] = dict(launches=launches, **times)
    print(f"pushcube ppo rgb: last frame of 16 envs re-rendered through the plain version: seg agreement "
          f"{agree:.6f} (bound {SEG_AGREE_MIN}), rgb equal")
    print_raster_times("pushcube", f"{n_envs}x128x128", times, card)
    print(f"pushcube faces in the scene {inputs[0].shape[1]}")
    evaluate_checkpoint(torch, env, trainer, RGB_CKPT, RGB_SUCCESS_MIN, card)
    del env, trainer, inputs, obs

    stamp("phases 12-13")

    # ---- phase 15: PickCube rgb+depth+segmentation vs state ----------------
    max_err = max(max_err, rgbd_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))

    stamp("phase 15")

    # ---- phases 14, 16-31 -------------------------------------------------------
    # host-bound state paths overlap, each launching from a process of its
    # own while the card stays mostly idle: phase 16's planner batches (4
    # processes), phases 23, 24 and 26 (one process), phases 39 and 30 (one
    # process, the two balancing each other's seconds), phase 45 and two of
    # phase 46's twins (one process) and phases 14, 18, 20 and 21 here; then
    # TD-MPC2 (its planner is device-bound), the rest of
    # phases 16-17 (the planner CLI alone) and the rgb phases, whose kernel
    # times are taken, with the card to this process alone
    planner = planner_pool_start(card)
    side_pool = spawn_pool(4)
    side = side_pool.submit(side_worker, card + SIDE_SHARED)
    dex = side_pool.submit(dexterity_worker, card + DEX_SHARED)
    early = side_pool.submit(scene_bridge_worker, card + SCENE_SHARED, True, BRIDGE_EARLY)
    slice16 = side_pool.submit(slice16_worker, card + SLICE16_SHARED)
    try:
        shared = card + PLANNER_SHARED
        ee_control_phase(torch, dev, make, shared)
        stamp("phase 14")
        ycb_state_phase(torch, dev, make, shared)
        stamp("phase 18")
        clutter_phase(torch, dev, make, shared)
        stamp("phase 20")
        family_state_phase(torch, dev, make, shared)
        stamp("phase 21")
        side_s = side.result()
        dex_s = dex.result()
        early_s, _ = early.result()
        slice16_s = slice16.result()
    finally:
        side_pool.shutdown(wait=True, cancel_futures=True)
        planner[0].shutdown(wait=True, cancel_futures=True)  # its results stay with its futures
    stamp("phases 23, 24, 26 (" + ", ".join(f"{k}: {v:.1f} s" for k, v in side_s.items())
          + " in their process), 39, 30 (" + ", ".join(f"{k}: {v:.1f} s" for k, v in dex_s.items())
          + " in theirs), 45, 46 (" + ", ".join(f"{k}: {v:.1f} s" for k, v in early_s.items()) + " in theirs)"
          + " and 49, 51 (" + ", ".join(f"{k}: {v:.1f} s" for k, v in slice16_s.items()) + " in theirs)")
    tdmpc2_phase(torch, dev, make, card)
    stamp("phase 31")
    max_err = max(max_err, planner_phases(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths, planner))
    stamp("phases 16-17")

    max_err = max(max_err, ycb_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 19")
    max_err = max(max_err, peg_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 22")
    max_err = max(max_err, anymal_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 25")
    max_err = max(max_err, cabinet_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 27")
    max_err = max(max_err, valve_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 40")
    max_err = max(max_err, grasp_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 41")
    max_err = max(max_err, draw_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 43")
    max_err = max(max_err, scene_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 47")
    max_err = max(max_err, scene_rgb_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths, KITCHEN_RGB,
                                           "robocasa_rgb"))
    stamp("phase 50")
    max_err = max(max_err, stereo_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 52")
    rt_phase(torch, dev, make, card)
    stamp("phase 53")
    max_err = max(max_err, render_modes_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 54's render modes")
    bench_render_phase(torch, card, tr, tiled_inputs, geom_poses, paths)
    stamp("phase 55's bench_render")
    max_err = max(max_err, sim2real_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths))
    stamp("phase 57")
    sharded_ppo_phase(torch, dev, card)
    stamp("phase 58")

    # ---- phases 32-38: record, replay, learn from the files -------------------
    # beside them, phases 42 and 44 (slice 14's state paths and planner) and
    # phase 46's last two twins with phase 48 (host-bound bridge control
    # steps; the kernel's times taken here after), each in a process of its own
    slice_pool = spawn_pool(4)
    try:
        slice14 = slice_pool.submit(slice14_worker, card + SLICE14_SHARED)
        slice17 = slice_pool.submit(slice17_worker, card + SLICE17_SHARED)
        ppo_late = slice_pool.submit(ppo_late_worker, card + PPO_LATE_SHARED)
        late = slice_pool.submit(scene_bridge_worker, card + BRIDGE_SHARED, False, BRIDGE_LATE, BRIDGE_RGB_CELLS)
        max_err = max(max_err, data_and_trainer_phases(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths,
                                                       stamp))
        slice_s = slice14.result()
        stamp("phases 42 and 44 (" + ", ".join(f"{k}: {v:.1f} s" for k, v in slice_s.items()) + " in their process)")
        late_s, late_rgb = late.result()
        slice17_s, slice17_paths = slice17.result()
        ppo_late_s, (rgbd_launches, rgbd_inputs, err) = ppo_late.result()
        max_err = max(max_err, err)
    finally:
        slice_pool.shutdown(wait=True, cancel_futures=True)
    stamp("phases 28 and 29 (" + ", ".join(f"{k}: {v:.1f} s" for k, v in ppo_late_s.items()) + " in their process)")
    times = raster_times(tr, [x.to(dev) if isinstance(x, torch.Tensor) else x for x in rgbd_inputs], 128, 128)
    paths[f"pushcube_ppo_rgbd_{PPO_RGBD[1]}"] = dict(launches=rgbd_launches, **times)
    print_raster_times("pushcube rgbd, phase 29's last frame", f"{PPO_RGBD[1]}x128x128", times, card)
    stamp("phases 54's viewer, 55's gpu_sim, 56 and 59 (" + ", ".join(f"{k}: {v:.1f} s" for k, v in slice17_s.items())
          + " in their process)")
    for name, (launches, inputs, H, W) in slice17_paths.items():
        times = raster_times(tr, [x.to(dev) if isinstance(x, torch.Tensor) else x for x in inputs], H, W)
        paths[name] = dict(launches=launches, **times)
        print_raster_times(f"{name}, the last frame", f"{H}x{W}", times, card)
    stamp("phases 46 and 48 (" + ", ".join(f"{k}: {v:.1f} s" for k, v in late_s.items()) + " in their process)")
    max_err = max(max_err, bridge_rgb_times(torch, dev, tr, paths, late_rgb, card))
    stamp("phase 48's kernel times")

    main_path = paths[f"pickcube_rgb_{PICKCUBE_RGB[1]}"]
    kernels = []
    for name, source, replaces, err in (
        ("raster_setup", "maniskill_tpu_torch/csrc/raster_setup.cu", "maniskill_tpu/render/pallas_rasterizer.py:113",
         max(p["raster_setup"]["max_abs_err"] for p in paths.values())),
        ("raster_tiles", "maniskill_tpu_torch/csrc/raster_tiles.cu", "maniskill_tpu/render/pallas_rasterizer.py:45",
         max_err),
    ):
        main = main_path[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(p["launches"] for p in paths.values()),
            "max_abs_err": err,
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "paths": {k: dict(launches=p["launches"], **p[name]) for k, p in paths.items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
